"""Command-line interface of the port.

    python -m plagnn_tpu_torch.cli preprocess     (raw BioGRID/UniProt/GEO -> artifacts)
    python -m plagnn_tpu_torch.cli geo            (series matrix -> exprSet CSV)
    python -m plagnn_tpu_torch.cli synth          (synthetic dataset bundle)
    python -m plagnn_tpu_torch.cli train-normal   (the reference's main_normal.py)
    python -m plagnn_tpu_torch.cli train-inter    (the reference's main_inter.py)
    python -m plagnn_tpu_torch.cli score          (mis-localization ranking)
    python -m plagnn_tpu_torch.cli performance    (CV metrics, random baselines)
    python -m plagnn_tpu_torch.cli statistics     (topology-change statistics)
    python -m plagnn_tpu_torch.cli figures        (the figures' data, as JSON)
    python -m plagnn_tpu_torch.cli plan-mesh      (the mesh planner's table)

Flag names, defaults and artifact paths match ``plagnn_tpu.cli`` (-data,
-lr 5e-5, -f 10, -e 200, -a [0.1], --no-dense-gcn).  ``-d`` is the torch
device (default ``cuda``) of training, ``preprocess`` (ECC counts,
topology, PCA), ``statistics`` and ``figures --diff-hist``, and the device
label written to txt_log.txt; without a card, a run needs an explicit
``-d cpu``.  There is
one path: the CUDA kernels on a card, their plain PyTorch versions on the
CPU.  ``score``, ``performance`` and ``geo`` are host work and take no
``-d``.  ``figures`` draws no PNG (no matplotlib on the port's machines):
it writes the JSON each plot is drawn from, under the plot's stem.

``--mesh fold=F,graph=P`` trains over F*P ranks (parallel/sharded.py): P
ranks split the graph, F groups of them split the fold batch.  Under
``torchrun`` each process is one rank (``WORLD_SIZE`` must be F*P; a rank
takes ``cuda:LOCAL_RANK``, NCCL, or the CPU under ``-d cpu``, gloo).  Run
plainly, the CLI spawns F*P local ranks: one per visible card (NCCL; fewer
cards than ranks raises), or gloo CPU ranks under ``-d cpu``.  ``--mesh
auto`` (or ``auto:D``) first plans D = F*P from the condition's graph
(parallel/planner.py, on measured H100 anchors) and takes the plan's mesh
and fold batch; D is the suffix, else torchrun's world size, else the
visible cards, else 1 under ``-d cpu``.  ``plan-mesh`` prints the planner's
table for ``--devices``.  ``--hub-cache auto|off|k``
(the JAX CLI's flag) sets the aggregation kernels' hub cache
(``TrainConfig.hub_cache``, ``ops/hub.py``): on one device over the whole
graph, on a mesh (fold-only included, and ``--mesh auto``) over each rank's
interior pass, sized at the rank's fold batch; the boundary pass takes none.
The planner models the aggregation without the hub (``auto`` resolves to 0).
"""
from __future__ import annotations

import argparse
import os
import sys

SINGLE_DEVICE_MESH = "fold=1,graph=1"
DEFAULT_FOLD_BATCH = 10


def _add_train_flags(p: argparse.ArgumentParser):
    p.add_argument("-data", required=True,
                   choices=["GSE30931", "GSE74572", "GSE27182"],
                   help="dataset (GSE30931=Bortezomib, GSE74572=Trichostatin A,"
                        " GSE27182=Tacrolimus)")
    p.add_argument("-lr", type=float, default=0.00005)
    p.add_argument("-f", type=int, default=10, help="fold num")
    p.add_argument("-e", type=int, default=200, help="epoch num")
    p.add_argument("-a", nargs="*", default=[0.1], help="alpha list")
    p.add_argument("-d", type=str, default="cuda",
                   help="torch device (cuda, cuda:N or cpu)")
    p.add_argument("--data-root", default="data")
    # None: not given, so --mesh auto can tell a request from the default
    p.add_argument("--fold-batch", type=int, default=None,
                   help="folds trained together (batch axis width; default "
                        f"{DEFAULT_FOLD_BATCH}).  Under --mesh auto the planner "
                        "picks it; a value given constrains its candidates")
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--seed", type=int, default=70)
    p.add_argument("--no-auc", action="store_true")
    p.add_argument("--auc-every", type=int, default=5,
                   help="AUC sampling cadence in epochs (the value carries "
                        "between samples)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save each fold batch's model, Adam state and metric "
                        "history every N epochs (ckpt_a{alpha}_j{chunk}.npz "
                        "in the log directory, removed when the batch ends); "
                        "a rerun with the same flags resumes from it. 0 "
                        "disables (finished rounds are skipped either way)")
    p.add_argument("--precision", default="highest",
                   choices=["default", "high", "highest"],
                   help="float32 matmul precision (highest = TF32 off)")
    p.add_argument("--agg-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="aggregation message dtype (bfloat16 halves the "
                        "gathered bytes; float32 = reference parity)")
    p.add_argument("--mesh", default=SINGLE_DEVICE_MESH,
                   help="'fold=F,graph=P': P ranks split the graph by "
                        "destination blocks (a halo exchange per layer), F "
                        "groups of them split the fold batch (fold-batch %% F "
                        "== 0); F*P ranks: torchrun's, or spawned here, one "
                        "per card (or CPU ranks under -d cpu).  'auto' or "
                        "'auto:D': the mesh planner picks F, P and the fold "
                        "batch for D ranks (parallel/planner.py)")
    p.add_argument("--no-mesh-balance", action="store_true",
                   help="contiguous node-id blocks instead of the balanced "
                        "(in-degree snake) partition")
    p.add_argument("--hub-cache", default="auto",
                   help="hub cache of the aggregation kernels: 'auto' (the "
                        "measured policy, ops/hub.py), 'off', or an integer k "
                        "(the k most-fetched rows of each direction read from "
                        "a shared-memory arena)")


def parse_mesh(spec: str):
    """'fold=F,graph=P' (either key optional) -> (mesh_fold, mesh_graph);
    'auto' / 'auto:D' -> ('auto', D or None), the JAX CLI's cases."""
    s = str(spec).strip()
    if s == "auto" or s.startswith("auto:"):
        n = None
        if ":" in s:
            try:
                n = int(s.split(":", 1)[1])
            except ValueError:
                raise SystemExit(f"invalid --mesh {spec!r}: expected 'auto' or 'auto:D'")
            if n < 1:
                raise SystemExit(f"invalid --mesh {spec!r}: device count must be >= 1")
        return ("auto", n)
    vals = {"fold": 1, "graph": 1}
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            k, v = part.split("=")
            vals[k.strip()] = int(v)
        except ValueError:
            raise SystemExit(f"invalid --mesh {spec!r}: expected 'fold=F,graph=P'")
        if k.strip() not in ("fold", "graph"):
            raise SystemExit(f"invalid --mesh {spec!r}: unknown axis {k.strip()!r}")
    if vals["fold"] < 1 or vals["graph"] < 1:
        raise SystemExit(f"invalid --mesh {spec!r}: sizes must be >= 1")
    return vals["fold"], vals["graph"]


def _plan_auto(args, condition: str, n_dev):
    """--mesh auto / auto:D: plan D ranks from the condition's graph (its
    edges with the self-loops, as training builds it) before any rank
    starts; sets ``args.mesh`` to the plan's 'fold=F,graph=P' and
    ``args.fold_batch`` to its fold batch.  An explicit --fold-batch
    constrains the local fold batches to those that give it."""
    import torch

    from .data.artifacts import condition_ppi
    from .parallel.multihost import launcher_environment
    from .parallel.planner import plan_mesh
    from .train.engine import resolve_device

    if n_dev is None:
        if launcher_environment():
            n_dev = int(os.environ["WORLD_SIZE"])
        elif resolve_device(args.d).type == "cuda":
            n_dev = torch.cuda.device_count()
        else:
            n_dev = 1
    src, dst, n = _edges_with_self_loops(condition_ppi(args.data_root, args.data,
                                                       condition))
    kw = {}
    if args.fold_batch is not None:
        kw["b_candidates"] = sorted({
            args.fold_batch // f for f in range(1, n_dev + 1)
            if n_dev % f == 0 and args.fold_batch % f == 0})
    plan = plan_mesh(n_dev, src, dst, n, total_jobs=args.rounds * args.f, **kw)
    chosen = plan.chosen
    if int(os.environ.get("RANK", 0)) == 0:    # every rank plans the same
        print(plan.summary())
        if args.fold_batch is not None and chosen.fold_batch != args.fold_batch:
            print(f"warning: --mesh auto chose fold_batch={chosen.fold_batch} (mesh "
                  f"fold={chosen.mesh_fold} x graph={chosen.mesh_graph}); the "
                  f"requested --fold-batch {args.fold_batch} is not achievable at "
                  "the best factorization")
    args.mesh = f"fold={chosen.mesh_fold},graph={chosen.mesh_graph}"
    args.fold_batch = chosen.fold_batch


def _train(args, condition: str):
    """A training subcommand: one device, or the mesh's ranks."""
    from .parallel.multihost import launcher_environment

    spec = parse_mesh(args.mesh)
    if spec[0] == "auto":
        _plan_auto(args, condition, spec[1])
        if (args.hub_cache.isdigit() and int(args.hub_cache)
                and int(os.environ.get("RANK", 0)) == 0):
            print(f"note: the plan models the aggregation without the hub cache; "
                  f"--hub-cache {args.hub_cache} runs it on each rank's interior pass")
    elif args.fold_batch is None:
        args.fold_batch = DEFAULT_FOLD_BATCH
    mesh_fold, mesh_graph = parse_mesh(args.mesh)
    if args.hub_cache not in ("auto", "off") and not args.hub_cache.isdigit():
        raise SystemExit(
            f"invalid --hub-cache {args.hub_cache!r}: expected 'auto', "
            "'off', or an integer k")
    n = mesh_fold * mesh_graph
    if n == 1 and not launcher_environment():
        return _train_rank(0, args.d, args, condition)
    import torch

    from .train.engine import resolve_device

    cpu = torch.device(args.d).type == "cpu"
    backend = "gloo" if cpu else "nccl"
    if not cpu:
        resolve_device(args.d)
    if launcher_environment():
        import torch.distributed as dist

        from .parallel.multihost import initialize_distributed

        world = initialize_distributed(backend=backend)
        if world != n:
            raise SystemExit(f"--mesh {args.mesh!r} needs {n} ranks; the launcher "
                             f"started {world}")
        device = "cpu" if cpu else f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        if not cpu:
            torch.cuda.set_device(device)
        try:
            return _train_rank(dist.get_rank(), device, args, condition)
        finally:
            dist.destroy_process_group()
    if cpu:
        devices = ["cpu"] * n
    elif torch.cuda.device_count() < n:
        raise RuntimeError(
            f"--mesh {args.mesh!r} needs {n} cards (one rank per card, NCCL); "
            f"{torch.cuda.device_count()} visible")
    else:
        devices = [f"cuda:{i}" for i in range(n)]
    import tempfile

    from . import cli as this   # the entry pickles by module name, also under -m
    from .parallel.launch import spawn_local

    with tempfile.TemporaryDirectory(prefix="plagnn_rdzv_") as rdzv:
        spawn_local(this._train_rank, n, backend=backend, devices=devices,
                    rdzv_dir=rdzv, args=(args, condition))
    return None


def _train_rank(rank: int, device, args, condition: str):
    """One rank's training run (the only one on a single device) on
    ``device`` (a name or a torch.device); rank 0 prints and writes the log
    header."""
    from .data.artifacts import load_condition, load_label_names
    from .train.engine import TrainConfig, resolve_device, train
    from .train.kfold import FOLD_SEEDS
    from .utils.precision import set_aggregation_dtype, set_matmul_precision

    mesh_fold, mesh_graph = parse_mesh(args.mesh)
    device = str(device)
    resolve_device(device)
    set_matmul_precision(args.precision)
    set_aggregation_dtype(args.agg_dtype)
    bundle = load_condition(args.data_root, args.data, condition)
    subdir = "normal" if condition == "normal" else "perturbation"
    log_path = os.path.join(args.data_root, "log", args.data, subdir) + os.sep
    if rank == 0:
        os.makedirs(log_path, exist_ok=True)
        print(
            "learning rate:{:.8f}, fold num:{:}, epoch num:{:}, alpha list:{},device:{}".format(
                args.lr, args.f, args.e, list(map(float, args.a)), args.d
            )
        )
        with open(os.path.join(log_path, "txt_log.txt"), "w") as f:
            f.write(
                "learning rate:{:.8f}, fold num:{:}, epoch num:{:}, alpha list:{}, device:{}\n".format(
                    args.lr, args.f, args.e, list(map(float, args.a)), args.d
                )
            )
    cfg = TrainConfig(
        lr=args.lr,
        fold_num=args.f,
        epoch_num=args.e,
        alpha_list=tuple(map(float, args.a)),
        fold_seeds=tuple(FOLD_SEEDS[: args.rounds]),
        seed=args.seed,
        fold_batch=args.fold_batch,
        compute_auc=not args.no_auc,
        auc_every=args.auc_every,
        checkpoint_every=args.checkpoint_every,
        mesh_fold=mesh_fold,
        mesh_graph=mesh_graph,
        mesh_balance=not args.no_mesh_balance,
        hub_cache=args.hub_cache,
    )
    return train(
        bundle.graph,
        bundle.feats,
        bundle.labels,
        bundle.label_with_loc,
        bundle.loc_mat,
        cfg,
        log_path,
        label_names=load_label_names(args.data_root) or bundle.uniprot,
        device_name=device,
    )


def _performance(args):
    """Per-round merge of the fold logits, then the CV metrics."""
    import json

    from .analysis.performance import mat_merge, performance

    gm = os.path.join(args.data_root, "generate_materials")
    with open(os.path.join(gm, "protein_ppi.json")) as f:
        n_nodes = len(json.load(f))
    mat_merge(os.path.join(args.data_root, "log"), n_nodes,
              rounds=args.rounds, fold_num=args.folds)
    return performance(args.data_root, rounds=args.rounds)


def main(argv=None):
    """Run one subcommand.  Training returns its per-chunk epoch timings,
    ``preprocess`` its (step, wall seconds) list, ``performance`` and
    ``statistics`` their results dicts, ``plan-mesh`` its MeshPlan."""
    parser = argparse.ArgumentParser(prog="plagnn_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("preprocess", help="materialize graph/feature artifacts")
    p.add_argument("--data-root", default="data")
    p.add_argument("--no-dense-gcn", action="store_true",
                   help="skip the dense PCC .npz artifacts (lean mode)")
    p.add_argument("-d", type=str, default="cuda",
                   help="torch device of the ECC counts, the topology step and "
                        "the PCAs (cuda, cuda:N or cpu)")
    what = "series-matrix → exprSet CSV (data_reader.R port); host only, no -d"
    p = sub.add_parser("geo", help=what, description=what)
    p.add_argument("series_matrix")
    p.add_argument("probe_map", help="probe_id,uniprot_id CSV")
    p.add_argument("out_csv")
    for name in ("train-normal", "train-inter"):
        _add_train_flags(sub.add_parser(name))
    for name, what in (("score", "mis-localization ranking (main.py)"),
                       ("performance", "CV metrics + random baselines")):
        what += "; host numpy, no device work (no -d)"
        p = sub.add_parser(name, help=what, description=what)
        p.add_argument("--data-root", default="data")
    p.add_argument("--rounds", type=int, default=10)  # performance's own flags
    p.add_argument("--folds", type=int, default=10)
    p = sub.add_parser("statistics", help="topology-change statistics; the "
                       "dense ΔPCC count runs on -d")
    p.add_argument("--data-root", default="data")
    p.add_argument("-d", type=str, default="cuda",
                   help="torch device of the ΔPCC count (cuda, cuda:N or cpu)")
    p = sub.add_parser("figures", help="the figures' data: JSON in place of the "
                       "PNGs (no matplotlib); the ΔPCC histogram runs on -d")
    p.add_argument("--data-root", default="data")
    p.add_argument("--diff-hist", action="store_true",
                   help="ΔPCC linked/unlinked histograms (figure.py save_diff/fig) "
                        "as diff_hist.json in each GSE*_data")
    p.add_argument("--save-diff", action="store_true",
                   help="persist the ΔPCC artifact triple diff.npy/diff_link.npy/"
                        "diff_unlink.npy + hist_data.json (figure.py:10-76 "
                        "contract; O(N²) on disk)")
    p.add_argument("--alpha-dist", action="store_true",
                   help="per-organelle distributions + JS distance (figure.py "
                        "fig_alpha) as alpha_dist.json in each log directory")
    p.add_argument("-d", type=str, default="cuda",
                   help="torch device of the --diff-hist scan (cuda, cuda:N or cpu)")
    what = ("score the (fold, graph) meshes for D cards with the halo-bytes "
            "model on measured H100 anchors and print the pick")
    p = sub.add_parser("plan-mesh", help=what, description=what)
    p.add_argument("--devices", type=int, required=True,
                   help="number of cards to plan for")
    p.add_argument("--data-root", default=None,
                   help="plan over this dataset's PPI_normal.npz; default: the "
                        "synthetic PPI-scale graph (--nodes, --edges)")
    p.add_argument("--jobs", type=int, default=100,
                   help="fold jobs in the run (rounds x folds; the reference's "
                        "10 x 10)")
    p.add_argument("--nodes", type=int, default=24041)
    p.add_argument("--edges", type=int, default=700000)
    p.add_argument("--include-2d", action="store_true",
                   help="also model 2-D source x destination grid partitions "
                        "(candidates only; no runner implements them)")
    p.add_argument("--part", default="h100-sxm", choices=["h100-sxm", "h100-pcie"],
                   help="the cards' link: NVLink 4 (SXM) or PCIe Gen5 x16")
    p = sub.add_parser("synth", help="write a synthetic dataset bundle")
    p.add_argument("--data-root", default="data")
    p.add_argument("--nodes", type=int, default=24041)
    p.add_argument("--edges", type=int, default=700000)
    p.add_argument("--seed", type=int, default=70)

    args = parser.parse_args(argv)
    if args.cmd == "preprocess":
        from .data.preprocess import preprocess
        from .train.engine import resolve_device

        return preprocess(args.data_root, dense_gcn_artifacts=not args.no_dense_gcn,
                          device=resolve_device(args.d))
    if args.cmd == "geo":
        from .data.geo import write_expr_set

        write_expr_set(args.series_matrix, args.probe_map, args.out_csv)
        return None
    if args.cmd == "train-normal":
        return _train(args, "normal")
    if args.cmd == "train-inter":
        return _train(args, "inter")
    if args.cmd == "score":
        from .analysis.score import score_all

        score_all(args.data_root)
        return None
    if args.cmd == "performance":
        return _performance(args)
    if args.cmd == "statistics":
        from .analysis.statistics import topology_statistics
        from .train.engine import resolve_device

        return topology_statistics(args.data_root, device=resolve_device(args.d))
    if args.cmd == "figures":
        return _figures(args)
    if args.cmd == "plan-mesh":
        return _plan_mesh(args)
    _write_synth(args)
    return None


def _edges_with_self_loops(mat):
    """(src, dst, n) of a sparse PPI matrix with a self-loop a node: the
    edges training aggregates over, which the planner counts."""
    import numpy as np

    coo = mat.tocoo()
    n = coo.shape[0]
    loops = np.arange(n, dtype=np.int64)
    return (np.concatenate([np.asarray(coo.row, np.int64), loops]),
            np.concatenate([np.asarray(coo.col, np.int64), loops]), n)


def _plan_mesh(args):
    """``plan-mesh``: print and return the MeshPlan for ``--devices`` cards
    over the dataset's PPI_normal.npz, or the synthetic PPI-scale graph,
    with the self-loops."""
    import scipy.sparse as sp

    from .data.synthetic import powerlaw_ppi
    from .parallel.planner import plan_mesh

    if args.data_root:
        ppi = sp.load_npz(os.path.join(args.data_root, "generate_materials",
                                       "PPI_normal.npz"))
    else:
        ppi = powerlaw_ppi(args.nodes, args.edges, seed=70)
    src, dst, n = _edges_with_self_loops(ppi)
    plan = plan_mesh(args.devices, src, dst, n, total_jobs=args.jobs,
                     include_2d=args.include_2d, part=args.part)
    print(plan.summary())
    return plan


def _figures(args):
    """``plagnn_tpu.cli figures`` with JSON in place of its PNGs; returns the
    paths of the JSON files written.  The ΔPCC scan's device is resolved,
    and required, only for ``--diff-hist``."""
    import glob

    import numpy as np
    import scipy.sparse as sp

    from .analysis.figures import (
        diff_hist_json, diff_histogram, fig_alpha, fig_and_perf, hist_data_from_diff,
        save_diff,
    )
    from .data.expression import pcc_factors
    from .train.engine import resolve_device

    device = resolve_device(args.d) if args.diff_hist else None
    written = []
    for fd in sorted(glob.glob(os.path.join(args.data_root, "log", "GSE*", "*",
                                            "fig_data_*.json"))):
        out_dir = os.path.dirname(fd)
        fig_and_perf(fd, out_dir=out_dir)
        written += [os.path.join(out_dir, f"{m}.json") for m in ("AIM", "COV", "mlACC")]
    gm = os.path.join(args.data_root, "generate_materials")

    def datasets():
        """(dataset dir, z_normal, z_inter) of each GSE*_data with both
        expression files."""
        for dsd in sorted(glob.glob(os.path.join(gm, "GSE*_data"))):
            en = os.path.join(dsd, "expr_normal.npy")
            ei = os.path.join(dsd, "expr_inter.npy")
            if os.path.exists(en) and os.path.exists(ei):
                yield dsd, pcc_factors(np.load(en)), pcc_factors(np.load(ei))

    if args.save_diff:
        ppi = sp.load_npz(os.path.join(gm, "PPI_normal.npz"))
        for dsd, z_n, z_i in datasets():
            save_diff(z_i, z_n, ppi, dsd)
            hist_data_from_diff(dsd)
    if args.diff_hist:
        ppi = sp.load_npz(os.path.join(gm, "PPI_normal.npz"))
        for dsd, z_n, z_i in datasets():
            bins, linked, unlinked = diff_histogram(z_i, z_n, ppi, device=device)
            written.append(diff_hist_json(os.path.join(dsd, "diff_hist.json"),
                                          bins, linked, unlinked))
    if args.alpha_dist:
        loc = sp.load_npz(os.path.join(gm, "loc_matrix.npz")).toarray()
        label_dist = loc.sum(0) / max(loc.sum(), 1)
        for ld in sorted(glob.glob(os.path.join(args.data_root, "log", "GSE*", "*"))):
            if os.path.isdir(ld):
                out = os.path.join(ld, "alpha_dist.json")
                fig_alpha(ld, out, label_dist)
                written.append(out)
    print(f"figures: no PNG is drawn (no matplotlib); wrote {len(written)} JSON "
          f"files in their place: {', '.join(written) or 'none'}")
    return written


def _write_synth(args):
    """Materialize a synthetic dataset under the reference artifact contract
    (the same files, bit for bit, as ``plagnn_tpu.cli synth``)."""
    import json
    import shutil

    import numpy as np
    import scipy.sparse as sp

    from .data.synthetic import powerlaw_ppi, synthetic_features, synthetic_loc_matrix

    gm = os.path.join(args.data_root, "generate_materials")
    os.makedirs(gm, exist_ok=True)
    sm = os.path.join(args.data_root, "support_materials")
    os.makedirs(sm, exist_ok=True)
    # the 12 GO CC terms (data/support_materials/cellular_component.txt)
    cc_terms = [
        "GO:0005938", "GO:0005829", "GO:0015629", "GO:0005794",
        "GO:0005783", "GO:0005730", "GO:0005777", "GO:0005739",
        "GO:0005764", "GO:0005813", "GO:0005634", "GO:0005886",
    ]
    with open(os.path.join(sm, "cellular_component.txt"), "w") as f:
        f.write("\n".join(cc_terms) + "\n")
    ppi = powerlaw_ppi(args.nodes, args.edges, args.seed)
    ppi_file = os.path.join(gm, "PPI_normal.npz")
    sp.save_npz(ppi_file, ppi)
    protein_list = [f"SYN{i:06d}" for i in range(args.nodes)]
    with open(os.path.join(gm, "protein_ppi.json"), "w") as f:
        json.dump(protein_list, f)
    feats = synthetic_features(args.nodes, args.seed)
    np.save(os.path.join(gm, "ECC_normal_pca"), feats[:, 253:])
    loc, label_list = synthetic_loc_matrix(args.nodes, args.seed)
    sp.save_npz(os.path.join(gm, "loc_matrix"), loc)
    with open(os.path.join(gm, "label_with_loc_list.json"), "w") as f:
        json.dump(label_list, f)
    with open(os.path.join(gm, "label_list.json"), "w") as f:
        json.dump([(u, []) for u in protein_list], f)
    for gse in ("GSE30931", "GSE74572", "GSE27182"):
        d = os.path.join(gm, f"{gse}_data")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "GCN_normal_pca"), feats[:, 3:253])
        np.save(os.path.join(d, "expr_normal"), feats[:, :3].astype(np.float64))
        # PPI_inter = PPI_normal: the file copied, not compressed again
        shutil.copyfile(ppi_file, os.path.join(d, "PPI_inter.npz"))
        np.save(os.path.join(d, "GCN_inter_pca"), feats[:, 3:253])
        np.save(os.path.join(d, "ECC_inter_pca"), feats[:, 253:])
        np.save(os.path.join(d, "expr_inter"), feats[:, :3].astype(np.float64))
    print(f"synthetic dataset at {gm}")


if __name__ == "__main__":
    main()
    sys.exit(0)
