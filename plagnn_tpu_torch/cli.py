"""Command-line interface of the port.

    python -m plagnn_tpu_torch.cli preprocess     (raw BioGRID/UniProt/GEO -> artifacts)
    python -m plagnn_tpu_torch.cli geo            (series matrix -> exprSet CSV)
    python -m plagnn_tpu_torch.cli synth          (synthetic dataset bundle)
    python -m plagnn_tpu_torch.cli train-normal   (the reference's main_normal.py)
    python -m plagnn_tpu_torch.cli train-inter    (the reference's main_inter.py)
    python -m plagnn_tpu_torch.cli score          (mis-localization ranking)
    python -m plagnn_tpu_torch.cli performance    (CV metrics, random baselines)
    python -m plagnn_tpu_torch.cli statistics     (topology-change statistics)

Flag names, defaults and artifact paths match ``plagnn_tpu.cli`` (-data,
-lr 5e-5, -f 10, -e 200, -a [0.1], --no-dense-gcn).  ``-d`` is the torch
device (default ``cuda``) of training, ``preprocess`` (ECC counts,
topology, PCA) and ``statistics``, and the device label written to
txt_log.txt; without a card, a run needs an explicit ``-d cpu``.  There is
one path: the CUDA kernels on a card, their plain PyTorch versions on the
CPU.  ``score``, ``performance`` and ``geo`` are host work and take no
``-d``.
Only the single-device mesh ``fold=1,graph=1`` is accepted.
"""
from __future__ import annotations

import argparse
import os
import sys

SINGLE_DEVICE_MESH = "fold=1,graph=1"


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
    p.add_argument("--fold-batch", type=int, default=10,
                   help="folds trained together (batch axis width)")
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
                   help="only the single-device mesh 'fold=1,graph=1' is "
                        "ported")


def _train(args, condition: str):
    from .data.artifacts import load_condition, load_label_names
    from .train.engine import TrainConfig, resolve_device, train
    from .train.kfold import FOLD_SEEDS
    from .utils.precision import set_aggregation_dtype, set_matmul_precision

    if args.mesh != SINGLE_DEVICE_MESH:
        raise SystemExit(f"--mesh {args.mesh!r}: only {SINGLE_DEVICE_MESH!r} is "
                         "ported (multi-device training is not ported yet)")
    resolve_device(args.d)
    set_matmul_precision(args.precision)
    set_aggregation_dtype(args.agg_dtype)
    bundle = load_condition(args.data_root, args.data, condition)
    subdir = "normal" if condition == "normal" else "perturbation"
    log_path = os.path.join(args.data_root, "log", args.data, subdir) + os.sep
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
        device_name=args.d,
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
    ``statistics`` their results dicts."""
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
    _write_synth(args)
    return None


def _write_synth(args):
    """Materialize a synthetic dataset under the reference artifact contract
    (the same files, bit for bit, as ``plagnn_tpu.cli synth``)."""
    import json

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
    sp.save_npz(os.path.join(gm, "PPI_normal"), ppi)
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
        sp.save_npz(os.path.join(d, "PPI_inter"), ppi)
        np.save(os.path.join(d, "GCN_inter_pca"), feats[:, 3:253])
        np.save(os.path.join(d, "ECC_inter_pca"), feats[:, 253:])
        np.save(os.path.join(d, "expr_inter"), feats[:, :3].astype(np.float64))
    print(f"synthetic dataset at {gm}")


if __name__ == "__main__":
    main()
    sys.exit(0)
