#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (plagnn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc.  Phases, in order; any failure exits nonzero:

1. Device: the card's name and power limit (nvidia-smi).
2. Build: the kernels in plagnn_tpu_torch/csrc, from source, one nvcc
   each, with each kernel's registers and spills as ptxas reports them.
3. Kernels against their plain PyTorch versions on the card, on a small
   tie-heavy graph, on a cross-chunk tie graph (a hub row of 3 x ROW_CHUNK
   + 5 edges in 4 chunks; columns all equal, all -inf, and maxima first
   reached at a chunk's first edge and tied across chunks) and on the full
   synthetic PPI graph at each width its path aggregates.  Segment max
   (GNN32: B=10 folds x F=503, 400, 300): forward out and argmax bit-exact
   in float32 and bfloat16, with and without the argmax, and bit-identical
   run to run; float32 dx within 1e-5 of the summed hit magnitudes (the two
   sum the same hits in float32 in different orders) and bit-identical run
   to run; bfloat16 dx within 1 bf16 ulp.  Segment sum (GCN2: B=10 x 400
   and 10 x 12), forward and transpose: float32 within 1e-5 of the summed
   magnitudes and bit-identical run to run; bfloat16 on small integers
   exact.  Prints the row-chunk tables' sizes (chunks, split rows) that
   all three kernels walk.  Times each kernel (CUDA events, median), its
   plain version and a PyTorch library call at the first layer's shape of
   each path, and the sum also at GCN2 conv2's K = 120.
4. GNN32 at full width through the CLI: synth (24,041 nodes, 700k edges),
   train-normal (float32, 3 epochs, 10 folds in one batch), then
   train-inter with --agg-dtype bfloat16 (2 epochs).  Each run must launch
   each of its kernels 3 times per epoch (3 SAGE-pool layers), no other
   kernel, and write the artifact contract with finite logits.
   4a. The analysis at full width, on the log phase 4 wrote (GSE30931's
   normal f32 and perturbation bf16 logits, 1 round x 10 folds).  For each
   GSE*_data: a seeded perturbed expr_inter.npy, and PPI_inter built on the
   card by the port's modify_network_topology (dataset thresholds 2.75 /
   2.91 / 2.99) through the ΔPCC hit kernel.  Then the CLI's score,
   performance --rounds 1 --folds 10 and statistics (the ΔPCC count kernel
   on the card), each with its wall time.  Only the two ΔPCC kernels may
   launch, 3 times each.  Checks: the CSV is non-empty, res_alldata.json
   parses, the metrics are finite, statistics.txt has 3 sections; per
   dataset the hit list equals the plain version's on the card (the same
   pairs in the same order, and the tail of PPI_inter) and the counts equal
   the plain scan's and the statistics'.  Times both kernels at full width
   (CUDA events, median) beside their plain versions, the blocked
   torch.matmul (cuBLAS DGEMM) yardstick and the float64 bound.
   4b. The float32 train-normal run once more under torch.profiler:
   device time per epoch by kernel group and the device's idle share, and
   the layer-1 max forward's profiled time per launch beside phase 3's
   CUDA-event median at the same shape.
   4c. GCN2 at full width through ``train()`` (503 -> 400 -> 12, 10 folds,
   float32, 3 epochs, a checkpoint every 2 epochs): 2 sum-forward and 2
   sum-transpose launches per epoch, no max launch, the artifact contract,
   and the mid-round checkpoint seen after epoch 2 and removed at the end;
   then the same run once more under torch.profiler.
   4p. The preprocess stage at full width from synthetic raw files: a
   BioGRID mitab of powerlaw_ppi(24,041, 700k, seed 70)'s pairs (each of
   its 3 isolated nodes joined to one more node, so all 24,041 proteins
   interact), one GSE*_exprSet.csv per dataset (~5% of proteins without a
   probe, some with 2-3; intervention = normal x exp(0.1 N(0, 1)), seed 70),
   a UniProt dat with 0-3 GO CC terms per protein.  ``preprocess
   --no-dense-gcn`` through the CLI on the card, each step's wall time
   (PPI, ECC x 4, expression x 3, topology x 3, labels, PCA x 10): 4 ECC
   count launches and 3 ΔPCC hit launches, no other kernel.  Checks: the
   artifact contract (lean: no GCN_*.npz); each graph's counts equal the
   plain version's on the card pair for pair and give the saved ECC values;
   the card's pca equals the CPU's at N = 4,096, 250 components (the
   randomized solver) within 1e-9 of the largest singular value; every
   condition loads with 503 features; one train-normal epoch (1 round, 10
   folds in one batch) on the bundle through the max kernels.  Times the
   ECC kernel on the normal graph and on GSE30931's PPI_inter (CUDA
   events, median) beside its plain version, the bound and cuSPARSE's A·A
   (``torch.sparse.mm``, normal graph only), and one full-width PCA split
   into the dense input, the range finder and the SVD.
5. A ``{"kernels": [...]}`` line, the nvidia-smi line, and last the
   ``{"ok": true, "device": {...}}`` line.
"""
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# H100 SXM float64 outside the tensor cores: 34 TFLOP/s counting an FMA as
# two operations, i.e. 17e12 instructions a second; the ΔPCC scans contract
# nothing, so each multiply, add, subtract and compare is one instruction
FP64_OPS_PER_S = 17e12
# H100 SXM int32 outside the tensor cores (Hopper architecture white paper)
INT32_OPS_PER_S = 33.5e12
KERNEL_SOURCE = {
    "spmm_max_fwd": "plagnn_tpu_torch/csrc/spmm_max_fwd.cu",
    "spmm_max_bwd": "plagnn_tpu_torch/csrc/spmm_max_bwd.cu",
    "spmm_sum": "plagnn_tpu_torch/csrc/spmm_sum.cu",
    "pcc_diff_scan": "plagnn_tpu_torch/csrc/pcc_diff_scan.cu",
    "common_neighbors": "plagnn_tpu_torch/csrc/common_neighbors.cu",
}
_FWD_BODY = "plagnn_tpu/ops/pallas/spmm_kernels.py:513"  # _spmm_fwd_kernel
CONV2 = "_k120"  # name suffix of the sum's entries at GCN2 conv2's width
REPLACES = {
    "spmm_max_fwd_f32": _FWD_BODY,
    "spmm_max_fwd_bf16": _FWD_BODY,
    "spmm_max_fwd_noarg_f32": _FWD_BODY,
    "spmm_max_bwd_f32": "plagnn_tpu/ops/pallas/spmm_kernels.py:982",
    "spmm_max_bwd_bf16": "plagnn_tpu/ops/pallas/spmm_kernels.py:1270",
    # reduce="sum": pallas_spmm_sum's forward, and its VJP over the transpose
    "spmm_sum_fwd_f32": _FWD_BODY,
    "spmm_sum_fwd_bf16": _FWD_BODY,
    "spmm_sum_bwd_f32": _FWD_BODY,
    "spmm_sum_bwd_bf16": _FWD_BODY,
    # no Pallas kernel: the JAX package's host scans (numpy GEMM blocks;
    # the topology step also native/plagnn_native.cpp:46)
    "pcc_diff_count_f64": "plagnn_tpu/analysis/statistics.py:23",
    "pcc_diff_hits_f64": "plagnn_tpu/data/topology.py:96",
    # no Pallas kernel: the host merge (scipy fallback plagnn_tpu/data/ecc.py:36)
    "ecc_common_neighbors_i32": "native/plagnn_native.cpp:20",
}
NODES, EDGES, SEED = 24041, 700000, 70
FOLDS, F_IN = 10, 503
EPOCHS_F32, EPOCHS_BF16, EPOCHS_GCN2 = 3, 2, 3
LAYERS = 3
AGG_WIDTHS = (F_IN, 400, 300)  # per-fold width of each SAGE-pool aggregation
GCN2_HIDDEN, CLASSES = 400, 12
# per-fold width of each GCN2 aggregation: W first (503 > 400, 400 > 12)
SUM_WIDTHS = (GCN2_HIDDEN, CLASSES)
SETUP_COPIES = "host<->device copies (data in, history out; not per epoch)"
# the datasets' topology thresholds (plagnn_tpu/analysis/statistics.py:65-67)
ANALYSIS_DATASETS = (("GSE30931", 2.75), ("GSE74572", 2.91), ("GSE27182", 2.99))
PERTURB_SIGMA = 0.1   # expr_inter = expr_normal x exp(0.1 N(0, 1)), seeded
LIB_BLOCK_ROWS = 2048  # row block of the blocked-DGEMM yardstick
DEVICE = "cuda"        # phase 4a's device ("cpu" runs its logic on the plain versions)
CC_TERMS = ("GO:0005938", "GO:0005829", "GO:0015629", "GO:0005794", "GO:0005783",
            "GO:0005730", "GO:0005777", "GO:0005739", "GO:0005764", "GO:0005813",
            "GO:0005634", "GO:0005886")
PCA_COMPONENTS = 250
PCA_MID = 4096         # size of the card-vs-CPU PCA check (the randomized solver)
PCA_RTOL = 1e-9        # tests/test_torch_preprocess.py's, relative to sigma_0


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name):
    print(f"== {name}", flush=True)


def median_ms(fn, reps):
    """Median over reps of one call, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits); the smallest normal's ulp
    at 0."""
    import torch

    a = v.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def ptxas_report(log):
    """(kernel, "N registers, ... spill ...") for each kernel in ptxas' -v
    output, the kernel's name demangled where c++filt is found."""
    rows, fn, spill = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and fn is not None:
            regs = line.split(":", 1)[1].strip()
            rows.append([fn, f"{regs}; {spill}"])
            fn, spill = None, ""
    filt = shutil.which("c++filt")
    if filt and rows:
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60).stdout.split("\n")
        for r, name in zip(rows, out):
            r[0] = name.replace("(anonymous namespace)::", "").split("(")[0]
    return rows


def kernel_entry(name, source, err, ms, plain, lib, nbytes, ops, shape,
                 ops_per_s=FP32_OPS_PER_S):
    """One entry of the ``kernels`` line; ``bound_ms`` from the compulsory
    bytes (each input read once, each output written once) at the HBM rate
    and the operations at their type's rate (float32 unless given),
    whichever is larger.  Launches are filled in from the main path's
    runs."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": KERNEL_SOURCE[source],
        "replaces": REPLACES[name.removesuffix(CONV2)],
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib,
        "shape": list(shape),
    }


def check_max_fwd(graph, x, label):
    """The max forward with and without the argmax against the plain
    version: out and arg bit-exact, and each bit-identical over two
    launches.  Returns (out, arg, plain out)."""
    import torch

    from plagnn_tpu_torch.ops import spmm_kernels as sk

    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    out_p, arg_p = sk.spmm_max_fwd_plain(graph, x)
    got = {}
    for with_arg in (True, False):
        form = "" if with_arg else " without the argmax"
        runs = [sk.spmm_max_fwd(graph, x, with_argmax=with_arg) for _ in range(2)]
        torch.cuda.synchronize()
        out_k, arg_k = runs[0]
        if not torch.equal(out_k, out_p):
            fail(f"{label}{form}: out differs from plain "
                 f"(max abs {(out_k.float() - out_p.float()).abs().max().item()})")
        if with_arg and not torch.equal(arg_k, arg_p):
            fail(f"{label}: argmax differs from plain "
                 f"({(arg_k != arg_p).sum().item()} elements)")
        out_2, arg_2 = runs[1]
        if not (torch.equal(bits(out_k), bits(out_2))
                and (arg_k is None or torch.equal(arg_k, arg_2))):
            fail(f"{label}{form}: not bit-identical run to run")
        got[with_arg] = runs[0]
    return (*got[True], out_p)


def check_kernels(graph, x32, label, results=None):
    """Kernel vs plain version on one graph and input; with ``results``,
    also time both and the library yardsticks at this shape."""
    import torch

    from plagnn_tpu_torch.ops import spmm_kernels as sk

    n, k = x32.shape
    e = graph.n_edges
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = x32.to(dt)
        esize = x.element_size()
        out_k, arg_k, out_p = check_max_fwd(graph, x, f"{label}: fwd {tag}")
        fwd_err = (out_k.float() - out_p.float()).abs().max().item()

        if dt == torch.float32:
            # float32 dx: the same hits summed in float32 in two orders;
            # each order is within ~sqrt(m) eps of the sum of |hits|.
            g = torch.randn((n, k), generator=gen, device="cuda")
            dx_k = sk.spmm_max_bwd(graph, g, arg_k)
            torch.cuda.synchronize()
            if not torch.equal(dx_k, sk.spmm_max_bwd(graph, g, arg_k)):
                fail(f"{label}: bwd f32 is not deterministic run to run")
            dx_p = sk.spmm_max_bwd_plain(graph, g, arg_k)
            mag = sk.spmm_max_bwd_plain(graph, g.abs(), arg_k)
            err = (dx_k - dx_p).abs()
            if bool((err > 1e-5 * mag + 1e-7).any()):
                fail(f"{label}: bwd f32 differs from plain beyond 1e-5 of the "
                     f"hit magnitudes (max abs {err.max().item()})")
        else:
            # bf16 dx: small-integer gradients keep every float32 partial
            # sum exact; the one rounding, to bf16 at the store, may differ
            # by at most 1 ulp.
            g = torch.randint(-8, 9, (n, k), generator=gen, device="cuda").to(dt)
            dx_k = sk.spmm_max_bwd(graph, g, arg_k)
            torch.cuda.synchronize()
            dx_p = sk.spmm_max_bwd_plain(graph, g, arg_k)
            err = (dx_k.float() - dx_p.float()).abs()
            ulp = bf16_ulp(torch.maximum(dx_k.float().abs(), dx_p.float().abs()))
            if bool((err > ulp).any()):
                fail(f"{label}: bwd bf16 differs from plain by more than 1 ulp")
        bwd_err = (dx_k.float() - dx_p.float()).abs().max().item()
        print(f"{label}: {tag} fwd out/arg bit-exact with and without the argmax, "
              f"bwd max abs err {bwd_err:.3e}", flush=True)
        if results is None:
            continue

        # -- timings at this shape ------------------------------------------
        asize = arg_k.element_size()
        src_l = graph.src.long()
        dst_l = graph.dst.long()
        fwd_ms = median_ms(lambda: sk.spmm_max_fwd(graph, x), 10)
        fwd_plain_ms = median_ms(lambda: sk.spmm_max_fwd_plain(graph, x), 3)
        gathered = x[src_l]
        idx = dst_l[:, None].expand(-1, k)
        lib_out = torch.zeros_like(x)
        fwd_lib_ms = median_ms(
            lambda: lib_out.scatter_reduce_(0, idx, gathered, "amax",
                                            include_self=False), 3)
        del gathered, lib_out
        bwd_ms = median_ms(lambda: sk.spmm_max_bwd(graph, g, arg_k), 10)
        bwd_plain_ms = median_ms(lambda: sk.spmm_max_bwd_plain(graph, g, arg_k), 3)
        masked = torch.empty((e, k), device="cuda")
        step = max((1 << 26) // k, 1)
        for e0 in range(0, e, step):
            s_c, d_c = src_l[e0:e0 + step], dst_l[e0:e0 + step]
            masked[e0:e0 + step] = torch.where(
                arg_k[d_c].long() == s_c[:, None], g[d_c].float(), 0.0)
        lib_dx = torch.zeros((n, k), device="cuda")
        bwd_lib_ms = median_ms(lambda: lib_dx.index_add_(0, src_l, masked), 3)
        del masked, lib_dx
        torch.cuda.empty_cache()

        nonempty = int((graph.in_degree > 0).sum().item())
        idx_bytes = 4 * (n + 1 + e)
        # compulsory bytes: each input read once, each output written once
        fwd_bytes = n * k * esize + idx_bytes + n * k * (esize + asize)
        bwd_bytes = n * k * (esize + asize) + idx_bytes + n * k * esize
        fwd_ops = e * k                      # one compare per edge element
        bwd_ops = e * k + nonempty * k       # compares + one add per hit
        timed = [
            (f"spmm_max_fwd_{tag}", "spmm_max_fwd", fwd_err, fwd_ms, fwd_plain_ms,
             fwd_lib_ms, fwd_bytes, fwd_ops, e * k * esize + n * k * (esize + asize)),
            (f"spmm_max_bwd_{tag}", "spmm_max_bwd", bwd_err, bwd_ms, bwd_plain_ms,
             bwd_lib_ms, bwd_bytes, bwd_ops, e * k * (esize + asize) + n * k * esize),
        ]
        if dt == torch.float32:
            # the forward without the argmax (the VJP primal, checked
            # above): the library yardstick is the same amax call, which
            # records no argmax
            noarg_err = fwd_err
            noarg_ms = median_ms(lambda: sk.spmm_max_fwd(graph, x, with_argmax=False), 10)
            noarg_plain_ms = median_ms(
                lambda: sk.spmm_max_fwd_plain(graph, x, with_argmax=False), 3)
            timed.append((f"spmm_max_fwd_noarg_{tag}", "spmm_max_fwd", noarg_err,
                          noarg_ms, noarg_plain_ms, fwd_lib_ms,
                          2 * n * k * esize + idx_bytes, fwd_ops,
                          e * k * esize + n * k * esize))
        for name, src, err_, ms, plain, lib, nbytes, ops, gather in timed:
            r = results[name] = kernel_entry(name, src, err_, ms, plain, lib,
                                             nbytes, ops, (n, k))
            print(f"  {name}: {ms:.3f} ms (plain {plain:.3f}, library {lib:.3f}, "
                  f"bound {r['bound_ms']:.3f} by {r['bound_by']}, no-reuse gather "
                  f"{gather / HBM_BYTES_PER_S * 1e3:.3f})", flush=True)


def check_sum_kernels(graph, k, label, results=None, suffix=""):
    """The segment-sum kernel against its plain version, forward and
    transpose, at K elements per row; with ``results``, also time both
    directions, the plain version and ``torch.sparse.mm`` on the CSR
    adjacency (a yardstick only, never on the path), entered under the
    kernel's counter name plus ``suffix``."""
    import torch

    from plagnn_tpu_torch.ops import spmm_kernels as sk

    n, e, dev = graph.n_nodes, graph.n_edges, graph.device
    gen = torch.Generator(device=dev).manual_seed(7)
    x32 = torch.randn((n, k), generator=gen, device=dev)
    xint = torch.randint(-8, 9, (n, k), generator=gen, device=dev).float()
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for transpose in (False, True):
            direction = "bwd" if transpose else "fwd"

            if dt == torch.float32:
                # the same terms summed in float32 in two orders; each order
                # is within ~sqrt(deg) eps of the sum of magnitudes
                x = x32
                out_k = sk.spmm_sum_rows(graph, x, transpose)
                torch.cuda.synchronize()
                if not torch.equal(out_k, sk.spmm_sum_rows(graph, x, transpose)):
                    fail(f"{label}: sum {direction} f32 is not deterministic run to run")
                out_p = sk.spmm_sum_plain(graph, x, transpose)
                mag = sk.spmm_sum_plain(graph, x.abs(), transpose)
                err = (out_k - out_p).abs()
                if bool((err > 1e-5 * mag + 1e-7).any()):
                    fail(f"{label}: sum {direction} f32 differs from plain beyond 1e-5 "
                         f"of the summed magnitudes (max abs {err.max().item()})")
            else:
                # small integers: every float32 partial sum is exact and both
                # round to bf16 once, so they are equal
                x = xint.to(dt)
                out_k = sk.spmm_sum_rows(graph, x, transpose)
                torch.cuda.synchronize()
                out_p = sk.spmm_sum_plain(graph, x, transpose)
                if not torch.equal(out_k, out_p):
                    fail(f"{label}: sum {direction} bf16 differs from plain on "
                         "small-integer inputs")
            err_max = (out_k.float() - out_p.float()).abs().max().item()
            print(f"{label}: sum {direction} {tag} K={k} max abs err {err_max:.3e}",
                  flush=True)
            if results is None:
                continue
            indptr, idx = ((graph.t_indptr, graph.t_dst) if transpose
                           else (graph.indptr, graph.src))
            adj = torch.sparse_csr_tensor(indptr, idx, torch.ones(e, dtype=dt, device=dev),
                                          size=(n, n), check_invariants=False)
            ms = median_ms(lambda: sk.spmm_sum_rows(graph, x, transpose), 10)
            plain = median_ms(lambda: sk.spmm_sum_plain(graph, x, transpose), 3)
            lib = median_ms(lambda: torch.sparse.mm(adj, x), 10)
            esize = x.element_size()
            name = f"spmm_sum_{direction}_{tag}{suffix}"
            r = results[name] = kernel_entry(
                name, "spmm_sum", err_max, ms, plain, lib,
                2 * n * k * esize + 4 * (n + 1 + e), e * k, (n, k))
            print(f"  {name}: {ms:.3f} ms (plain {plain:.3f}, library {lib:.3f}, "
                  f"bound {r['bound_ms']:.3f} by {r['bound_by']}, no-reuse gather "
                  f"{(e + n) * k * esize / HBM_BYTES_PER_S * 1e3:.3f})", flush=True)
            del adj
    del x32, xint
    torch.cuda.empty_cache()


def train_cli(data_root, cmd, agg, epochs):
    """One training run through the CLI, as a user calls it."""
    from plagnn_tpu_torch import cli

    return cli.main([cmd, "-data", "GSE30931", "--data-root", data_root,
                     "-e", str(epochs), "--rounds", "1", "-f", str(FOLDS),
                     "--fold-batch", str(FOLDS), "--agg-dtype", agg])


def reset_launches():
    from plagnn_tpu_torch.ops import common_neighbors, pcc_scan
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    sk.reset_launches()
    pcc_scan.reset_launches()
    common_neighbors.reset_launches()


def launch_counts():
    """Every kernel wrapper's launch count, by counter name."""
    from plagnn_tpu_torch.ops import common_neighbors, pcc_scan
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    return {**sk.LAUNCHES, **pcc_scan.LAUNCHES, **common_neighbors.LAUNCHES}


def check_launches(label, expected):
    """Every counter equals the run's expected count (0 where the run names
    none); returns the counts."""
    counts = launch_counts()
    for name, c in counts.items():
        want = expected.get(name, 0)
        if c != want:
            fail(f"{label}: {name} launched {c} times, expected {want}")
    return counts


def gnn32_launches(tag, epochs):
    """A GNN32 run: its dtype's max forward (with argmax) and backward once
    per SAGE-pool layer per epoch."""
    return {f"spmm_max_fwd_{tag}": LAYERS * epochs,
            f"spmm_max_bwd_{tag}": LAYERS * epochs}


def profile_epochs(label, run, expected, smi_line):
    """torch.profiler over one training run (``run()`` returns its chunk
    stats), which must launch the ``expected`` kernels: device time per
    epoch by kernel group, and the device's idle share against the steady
    epoch time.  Returns {kernel name: (ms per epoch, launches per epoch)}."""
    from torch.profiler import ProfilerActivity, profile

    reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stats = run()
    check_launches(f"profiled {label}", expected)
    ms = [m for s in stats for m in s.epoch_ms]
    groups = {}
    top = []
    per_kernel = {}
    for total_ms, count, name in device_kernel_times(prof):
        low = name.lower()
        if "spmm_max" in low:
            grp = "spmm_max kernels"
        elif "spmm_sum" in low:
            grp = "spmm_sum kernels"
        elif any(t in low for t in ("gemm", "xmma", "cutlass", "sm90", "ampere")):
            grp = "matmul"
        elif any(t in low for t in ("sort", "radix", "search")):
            grp = "sort/searchsorted (AUC)"
        elif "reduce" in low:
            grp = "reductions"
        elif "htod" in low or "dtoh" in low:
            grp = SETUP_COPIES
        else:
            grp = "elementwise/copy/other"
        groups[grp] = groups.get(grp, 0.0) + total_ms / len(ms)
        top.append((total_ms / len(ms), count // len(ms), name[:90]))
        per_kernel[name] = (total_ms / len(ms), count / len(ms))
    steady = statistics.median(ms[1:])
    busy = sum(t for grp, t in groups.items() if grp != SETUP_COPIES)
    if busy <= 0:
        print("profile: no device time in the trace (not measured)")
        return {}
    print(f"profile ({label}, {len(ms)} epochs x {FOLDS} folds, AUC sampled "
          f"at epochs 0 and {len(ms) - 1}, {smi_line}): steady {steady:.3f} ms/epoch "
          f"wall, {busy:.3f} ms/epoch device busy, idle share "
          f"{max(0.0, 1 - busy / steady):.3f}", flush=True)
    for grp, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {grp}: {t:.3f} ms/epoch ({t / steady:.3f} of steady wall)")
    for t, cnt, name in sorted(top, reverse=True)[:12]:
        print(f"  kernel {t:8.3f} ms/epoch  x{cnt:<4} {name}")
    return per_kernel


def crosscheck_max_fwd(per_kernel, results, smi_line):
    """The layer-1 float32 max forward's profiled time per launch beside
    phase 3's CUDA-event median at the same shape (K = 10 x 503).  Layer 1
    is the only layer whose K takes 8-byte vectors, so its chunk kernel is
    the float32 one launched once per epoch; the combine kernel serves all
    three layers, and its mean per launch is added."""
    chunk = [t / c for name, (t, c) in per_kernel.items()
             if "spmm_max_fwd_kernel<float" in name and c == 1]
    comb = [t / c for name, (t, c) in per_kernel.items()
            if "spmm_max_fwd_combine_kernel<float" in name and c > 0]
    event_ms = results["spmm_max_fwd_f32"]["ms"]
    if len(chunk) != 1 or len(comb) != 1:
        print(f"cross-check of the max forward: kernels not found in the profile "
              f"({len(chunk)} chunk, {len(comb)} combine; not measured)")
        return
    total = chunk[0] + comb[0]
    print(f"cross-check, max forward f32 at K = {FOLDS * F_IN} ({smi_line}): profiled "
          f"{chunk[0]:.3f} ms/launch chunk kernel + {comb[0]:.3f} combine (mean "
          f"of the 3 layers) = {total:.3f} ms; phase 3 CUDA events {event_ms:.3f} ms "
          f"(median of 10, both kernels); ratio {total / event_ms:.3f}", flush=True)


def record_launches(results, counts):
    """Each kernel entry takes the launches of the run whose path it is on:
    its counter's, at every width that run aggregates (an entry at conv2's
    width is the same kernel as its counter's)."""
    for name, r in results.items():
        c = counts.get(name.removesuffix(CONV2), 0)
        if c:
            r["launches"] = c


def check_artifacts(label, d):
    """The artifact contract of one round of FOLDS folds, finite logits."""
    import numpy as np

    for f in range(1, FOLDS + 1):
        p = os.path.join(d, f"1_{f}_loc_logits.npy")
        if not os.path.exists(p):
            fail(f"{label}: missing {p}")
        lg = np.load(p)
        if lg.shape != (NODES, CLASSES) or not np.isfinite(lg).all():
            fail(f"{label}: {p} has shape {lg.shape} or non-finite values")
    for fname in ("log.tsv", "txt_log.txt", "fig_data_1.json"):
        if not os.path.exists(os.path.join(d, fname)):
            fail(f"{label}: missing {fname}")


def report_run(label, stats, wall, counts, smi_line):
    import torch

    ep = [m for s in stats for m in s.epoch_ms]
    steady = statistics.median(ep[1:]) if len(ep) > 1 else ep[0]
    print(f"slice {label}: {len(ep)} epochs x {FOLDS} folds, "
          f"epoch ms {[round(m, 3) for m in ep]}, steady {steady:.3f} ms/epoch, "
          f"run wall {wall:.1f} s, launches { {k: c for k, c in counts.items() if c} }, "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"on {smi_line}", flush=True)


# 2 GraphConvs: one sum forward and one transpose each per epoch
GCN2_LAUNCHES = {"spmm_sum_fwd_f32": 2 * EPOCHS_GCN2, "spmm_sum_bwd_f32": 2 * EPOCHS_GCN2}


def train_gcn2(data_root, path, chunk_callback=None):
    """GCN2 at full width through ``train()``, as a user of the JAX package
    calls it (``TrainConfig(model="gcn2")``), float32, with a mid-round
    checkpoint every 2 epochs; returns the chunk stats."""
    from plagnn_tpu_torch.data.artifacts import load_condition
    from plagnn_tpu_torch.train.engine import TrainConfig, train
    from plagnn_tpu_torch.train.kfold import FOLD_SEEDS
    from plagnn_tpu_torch.utils.precision import set_aggregation_dtype

    set_aggregation_dtype("float32")
    bundle = load_condition(data_root, "GSE30931", "normal")
    cfg = TrainConfig(model="gcn2", fold_num=FOLDS, fold_batch=FOLDS,
                      epoch_num=EPOCHS_GCN2, fold_seeds=FOLD_SEEDS[:1],
                      hidden=(GCN2_HIDDEN,), checkpoint_every=2,
                      chunk_callback=chunk_callback)
    return train(bundle.graph, bundle.feats, bundle.labels, bundle.label_with_loc,
                 bundle.loc_mat, cfg, path + os.sep, label_names=bundle.uniprot,
                 device_name="cuda")


def check_gcn2(data_root, results, smi_line):
    """Phase 4c's checks: the sum kernels only, the artifact contract, and
    the checkpoint seen after epoch 2 and gone at the end."""
    import torch

    path = os.path.join(data_root, "log_gcn2")
    ck_file = os.path.join(path, "ckpt_a0_j0.npz")
    seen = []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    stats = train_gcn2(data_root, path, lambda r, a, c0, done: seen.append(
        (done, os.path.exists(ck_file))))
    wall = time.perf_counter() - t0
    counts = check_launches("GCN2 train()", GCN2_LAUNCHES)
    record_launches(results, counts)
    check_artifacts("GCN2 train()", path)
    if not seen or seen[0] != (2, True):
        fail(f"GCN2 train(): no checkpoint seen after epoch 2 ({seen})")
    if os.path.exists(ck_file):
        fail("GCN2 train(): the checkpoint was not removed at the end")
    report_run("GCN2 train() float32", stats, wall, counts, smi_line)


def build_perturbed_topologies(data_root):
    """Phase 4a's topology step, as the preprocess step runs it: per
    dataset a seeded perturbed expr_inter.npy, then PPI_inter.npz from the
    port's modify_network_topology on the card.  Returns {dataset: (PPI_inter
    COO, wall seconds of the topology call)}."""
    import numpy as np
    import scipy.sparse as sp

    from plagnn_tpu_torch.data.expression import pcc_factors
    from plagnn_tpu_torch.data.topology import modify_network_topology

    gm = os.path.join(data_root, "generate_materials")
    ppi = sp.load_npz(os.path.join(gm, "PPI_normal.npz"))
    rng = np.random.default_rng(SEED)
    out = {}
    for name, thr in ANALYSIS_DATASETS:
        d = os.path.join(gm, f"{name}_data")
        expr_n = np.load(os.path.join(d, "expr_normal.npy"))
        expr_i = expr_n * np.exp(PERTURB_SIGMA * rng.standard_normal(expr_n.shape))
        np.save(os.path.join(d, "expr_inter.npy"), expr_i)
        t0 = time.perf_counter()
        new = modify_network_topology(ppi, pcc_factors(expr_n), pcc_factors(expr_i),
                                      thr, device=DEVICE)
        out[name] = (new, time.perf_counter() - t0)
        sp.save_npz(os.path.join(d, "PPI_inter"), new)
    return out


def run_analysis_cli(data_root):
    """score, performance and statistics through the port's CLI, as a user
    calls them after training.  Returns {subcommand: (result, wall s)}."""
    from plagnn_tpu_torch import cli

    out = {}
    for argv in (["score"], ["performance", "--rounds", "1", "--folds", str(FOLDS)],
                 ["statistics"]):
        t0 = time.perf_counter()
        res = cli.main(argv + ["--data-root", data_root])
        out[argv[0]] = (res, time.perf_counter() - t0)
    return out


def check_analysis_outputs(data_root, cli_out):
    """The CSV non-empty, res_alldata.json parsing, finite metrics and a
    statistics.txt section per dataset."""
    res_dir = os.path.join(data_root, "res", "GSE30931")
    with open(os.path.join(res_dir, "loc_change_record.csv")) as f:
        csv_rows = sum(1 for _ in f) - 1
    if csv_rows < 1:
        fail("score: loc_change_record.csv has no ranked entry")
    with open(os.path.join(res_dir, "res_alldata.json")) as f:
        proteins = len(json.load(f))
    perf = cli_out["performance"][0]
    values = [v for metrics in perf.values() for v in metrics.values()]
    if "GSE30931/normal" not in perf or not all(math.isfinite(v) for v in values):
        fail(f"performance: missing or non-finite metrics {perf}")
    with open(os.path.join(data_root, "log", "statistics.txt")) as f:
        sections = sum(1 for line in f if line.startswith("#" * 20 + " GSE"))
    if sections != len(ANALYSIS_DATASETS):
        fail(f"statistics.txt has {sections} dataset sections, expected "
             f"{len(ANALYSIS_DATASETS)}")
    m = perf["GSE30931/normal"]
    print(f"analysis outputs: {csv_rows} ranked entries over {proteins} proteins; "
          f"AIM {m['AIM']:.4f} COV {m['COV']:.4f} mlACC {m['mlACC']:.4f} "
          f"AUC micro {m['AUC_micro']:.4f} macro {m['AUC_macro']:.4f} F1 micro "
          f"{m['F1_micro']:.4f}; {sections} statistics sections", flush=True)


def pcc_inputs(data_root, name, thr):
    """The float64 factors on the card, (lo, hi) and the PPI's CSR, as the
    statistics (factors from pcc_factors_torch) and the topology step (the
    PPI_normal CSR) compute them for one dataset."""
    import numpy as np
    import scipy.sparse as sp

    from plagnn_tpu_torch.data.expression import pcc_factors_torch
    from plagnn_tpu_torch.data.topology import diff_stats
    from plagnn_tpu_torch.ops.pcc_scan import csr_tensors

    gm = os.path.join(data_root, "generate_materials")
    d = os.path.join(gm, f"{name}_data")
    z_n = pcc_factors_torch(np.load(os.path.join(d, "expr_normal.npy")), DEVICE)
    z_i = pcc_factors_torch(np.load(os.path.join(d, "expr_inter.npy")), DEVICE)
    mean, std = diff_stats(z_i, z_n)
    ppi = sp.load_npz(os.path.join(gm, "PPI_normal.npz")).tocsr().astype(np.int8)
    return z_i, z_n, mean - thr * std, mean + thr * std, csr_tensors(ppi, DEVICE)


def check_pcc_kernels(data_root, topologies, stats):
    """Per dataset, the kernels against their plain versions on the card:
    the hit list pair for pair and in order (and equal to PPI_inter's added
    tail), the counts equal and equal to the statistics' l_num / r_num."""
    import numpy as np
    import torch

    from plagnn_tpu_torch.ops import pcc_scan

    for name, thr in ANALYSIS_DATASETS:
        z_i, z_n, lo, hi, csr = pcc_inputs(data_root, name, thr)
        rows, cols = pcc_scan.pcc_diff_hits(z_i, z_n, hi, csr)
        torch.cuda.synchronize()
        p_rows, p_cols = pcc_scan.pcc_diff_hits_plain(z_i, z_n, hi, csr)
        if not (torch.equal(rows, p_rows) and torch.equal(cols, p_cols)):
            fail(f"{name}: the hit kernel's list differs from the plain version's "
                 f"({rows.numel()} vs {p_rows.numel()} pairs)")
        ppi_inter = topologies[name][0]
        m = rows.numel()
        if not (np.array_equal(ppi_inter.row[ppi_inter.nnz - m:], rows.cpu().numpy())
                and np.array_equal(ppi_inter.col[ppi_inter.nnz - m:], cols.cpu().numpy())):
            fail(f"{name}: PPI_inter's added pairs differ from the hit kernel's list")
        counts = pcc_scan.pcc_diff_counts(z_i, z_n, lo, hi)
        plain = pcc_scan.pcc_diff_counts_plain(z_i, z_n, lo, hi)
        said = (stats[name]["l_num"], stats[name]["r_num"])
        if not counts == plain == said:
            fail(f"{name}: counts kernel {counts}, plain {plain}, statistics {said}")
        print(f"{name}: {m} added pairs (kernel = plain, in order), "
              f"{stats[name]['removed']} removed; counts < lo / > hi {counts} "
              f"(kernel = plain = statistics)", flush=True)


def time_pcc_kernels(data_root, results):
    """The count and hit kernels at full width on GSE30931's inputs: CUDA
    events (median of 10; each wrapper call ends in its host sync), their
    plain versions (median of 3) and the blocked-DGEMM yardstick
    (torch.matmul of both K = k products per 2,048-row block, subtract,
    compare; for the hits also the edge mask and torch.nonzero; median of 3),
    never on the path."""
    import torch

    from plagnn_tpu_torch.ops import pcc_scan

    name, thr = ANALYSIS_DATASETS[0]
    z_i, z_n, lo, hi, csr = pcc_inputs(data_root, name, thr)
    n, k = z_i.shape
    indptr, indices = csr
    ptr = indptr.cpu().numpy()

    def lib_block(r0, r1):
        d = z_i[r0:r1] @ z_i.T - z_n[r0:r1] @ z_n.T
        rr = torch.arange(r0, r1, device=d.device)
        d[rr - r0, rr] = 0.0
        return d

    def lib_counts():
        n_lo = torch.zeros((), dtype=torch.int64, device=DEVICE)
        n_hi = torch.zeros((), dtype=torch.int64, device=DEVICE)
        for r0 in range(0, n, LIB_BLOCK_ROWS):
            d = lib_block(r0, min(r0 + LIB_BLOCK_ROWS, n))
            n_lo += (d < lo).sum()
            n_hi += (d > hi).sum()
        return int(n_lo), int(n_hi)

    def lib_hits():
        out = []
        for r0 in range(0, n, LIB_BLOCK_ROWS):
            r1 = min(r0 + LIB_BLOCK_ROWS, n)
            hit = lib_block(r0, r1) > hi
            e0, e1 = int(ptr[r0]), int(ptr[r1])
            er = torch.repeat_interleave(torch.arange(r1 - r0, device=DEVICE),
                                         indptr[r0 + 1:r1 + 1] - indptr[r0:r1])
            hit[er, indices[e0:e1].long()] = False
            out.append(torch.nonzero(hit))
        return torch.cat(out)

    n_hits = pcc_scan.pcc_diff_hits(z_i, z_n, hi, csr)[0].numel()
    lib_n = (lib_counts(), lib_hits().shape[0])
    pairs = n * n
    timed = (
        ("pcc_diff_count_f64", lambda: pcc_scan.pcc_diff_counts(z_i, z_n, lo, hi),
         lambda: pcc_scan.pcc_diff_counts_plain(z_i, z_n, lo, hi), lib_counts,
         2 * n * k * 8 + 16, pairs * (4 * k - 1 + 2)),
        ("pcc_diff_hits_f64", lambda: pcc_scan.pcc_diff_hits(z_i, z_n, hi, csr),
         lambda: pcc_scan.pcc_diff_hits_plain(z_i, z_n, hi, csr), lib_hits,
         2 * n * k * 8 + 8 * (n + 1) + 4 * indices.numel() + 8 * n_hits,
         pairs * (4 * k - 1 + 1)),
    )
    for kname, kern, plain, lib, nbytes, ops in timed:
        ms = median_ms(kern, 10)
        plain_ms = median_ms(plain, 3)
        lib_ms = median_ms(lib, 3)
        r = results[kname] = kernel_entry(kname, "pcc_diff_scan", 0.0, ms, plain_ms,
                                          lib_ms, nbytes, ops, (n, k), FP64_OPS_PER_S)
        print(f"  {kname}: {ms:.3f} ms (plain {plain_ms:.3f}, blocked DGEMM "
              f"{lib_ms:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']}) at "
              f"N = {n}, k = {k}, {n_hits} hits", flush=True)
    print(f"  the yardstick's own answers (GEMM rounding): counts {lib_n[0]}, "
          f"{lib_n[1]} hits", flush=True)
    for kname, kern, *_ in timed:
        profile_call(kname, kern)
    torch.cuda.empty_cache()


def device_kernel_times(prof):
    """(ms, launches, name) of each kernel in a torch.profiler trace, from
    its device-side events only (the op that launched a kernel reports the
    same time as its own)."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    return rows


def profile_call(label, fn):
    """One call under torch.profiler: its wall time and the device time of
    each kernel it ran (the wrapper's own kernels, its checks and its
    bookkeeping), so a wrapper's time splits into its parts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_kernel_times(prof)
    busy = sum(r[0] for r in rows)
    print(f"  profile of one {label} call: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms", flush=True)
    for ms, cnt, name in sorted(rows, reverse=True)[:8]:
        print(f"    {ms:8.3f} ms x{cnt:<3} {name[:80]}", flush=True)


def analysis_phase(data_root, results):
    """Phase 4a: the main path (topology step, score, performance,
    statistics) with every launch counter at 0 before and read after, then
    the checks and the timings."""
    reset_launches()
    topologies = build_perturbed_topologies(data_root)
    cli_out = run_analysis_cli(data_root)
    n_data = len(ANALYSIS_DATASETS)
    counts = check_launches("analysis", {"pcc_diff_hits_f64": n_data,
                                         "pcc_diff_count_f64": n_data})
    for name, (_, wall) in topologies.items():
        print(f"wall: topology {name} (modify_network_topology on the card) "
              f"{wall:.3f} s", flush=True)
    for cmd, (_, wall) in cli_out.items():
        print(f"wall: {cmd} {wall:.3f} s", flush=True)
    check_analysis_outputs(data_root, cli_out)
    check_pcc_kernels(data_root, topologies, cli_out["statistics"][0])
    time_pcc_kernels(data_root, results)
    record_launches(results, counts)


def write_raw_inputs(root):
    """Phase 4p's synthetic raw files under root/support_materials (the
    layout tests/test_preprocess_pipeline.py writes): the mitab, one
    expression CSV per dataset and the UniProt dat.  Returns the pairs."""
    import csv
    import gzip

    import numpy as np
    import scipy.sparse as sp

    from plagnn_tpu_torch.data.preprocess import DEFAULT_DATASETS
    from plagnn_tpu_torch.data.synthetic import powerlaw_ppi

    sm = os.path.join(root, "support_materials")
    os.makedirs(sm, exist_ok=True)
    pairs = sp.triu(powerlaw_ppi(NODES, EDGES, SEED), 1).tocoo()
    rows, cols = pairs.row.astype(np.int64), pairs.col.astype(np.int64)
    deg = np.bincount(np.concatenate([rows, cols]), minlength=NODES)
    lone = np.flatnonzero(deg == 0)  # join each to its successor
    rows, cols = np.concatenate([rows, lone]), np.concatenate([cols, (lone + 1) % NODES])
    prots = [f"P{i:05d}" for i in range(NODES)]
    with open(os.path.join(sm, "BIOGRID-ORGANISM-Homo_sapiens-4.4.203.mitab.txt"), "w") as f:
        f.write("#header\n")
        f.writelines(f"x\ty\tbiogrid:1|uniprot/swiss-prot:{prots[a]}|x\t"
                     f"biogrid:2|uniprot/swiss-prot:{prots[b]}|y\t-\t-\t-\t-\t-\t-\t-\t"
                     "psi-mi:MI:0915(physical association)\n"
                     for a, b in zip(rows.tolist(), cols.tolist()))

    rng = np.random.default_rng(SEED)
    for ds in DEFAULT_DATASETS:
        probes = rng.choice([1, 2, 3], NODES, p=[0.7, 0.2, 0.1])
        probes[rng.random(NODES) < 0.05] = 0
        owner = np.repeat(np.arange(NODES), probes)
        normal = rng.gamma(2.0, 2.0, (len(owner), 3))
        inter = normal * np.exp(PERTURB_SIGMA * rng.standard_normal(normal.shape))
        with open(os.path.join(root, ds.expr_csv), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["", "uniprot_id", *ds.normal_samples, *ds.intervention_samples])
            for k, i in enumerate(rng.permutation(len(owner)).tolist()):
                w.writerow([k + 1, prots[owner[i]], *map(repr, normal[i].tolist()),
                            *map(repr, inter[i].tolist())])

    with open(os.path.join(sm, "cellular_component.txt"), "w") as f:
        f.write("\n".join(CC_TERMS) + "\n")
    with gzip.open(os.path.join(sm, "uniprot_sprot_human.dat.gz"), "wt") as f:
        for p in prots:
            f.write(f"ID   {p}_HUMAN\nAC   {p};\n")
            for go in rng.choice(CC_TERMS, size=int(rng.integers(0, 4)), replace=False):
                f.write(f"DR   GO; {go}; C:somewhere; IDA:x.\n")
            f.write("//\n")
    return len(rows)


def check_preprocess_artifacts(root):
    """The artifact contract (tests/test_preprocess_pipeline.py), lean mode:
    no GCN_*.npz."""
    from plagnn_tpu_torch.data.preprocess import DEFAULT_DATASETS

    gm = os.path.join(root, "generate_materials")
    want = [os.path.join(gm, n) for n in (
        "PPI_normal.npz", "ECC_normal.npz", "loc_matrix.npz", "ECC_normal_pca.npy",
        "protein_ppi.json", "label_with_loc_list.json", "label_list.json")]
    for ds in DEFAULT_DATASETS:
        d = os.path.join(gm, f"{ds.name}_data")
        want += [os.path.join(d, n) for n in (
            "expr_normal.npy", "expr_inter.npy", "PPI_inter.npz", "ECC_inter.npz",
            "GCN_normal_pca.npy", "GCN_inter_pca.npy", "ECC_inter_pca.npy")]
        for n in ("GCN_normal.npz", "GCN_inter.npz"):
            if os.path.exists(os.path.join(d, n)):
                fail(f"preprocess --no-dense-gcn wrote {ds.name}_data/{n}")
    missing = [p for p in want if not os.path.exists(p)]
    if missing:
        fail(f"preprocess: missing {missing}")


def ecc_graphs(root):
    """[(name, binary CSR on the card, query rows, query cols, the saved
    ECC values of the queries, the degrees)] for PPI_normal and each
    PPI_inter, set up as data/ecc.py sets them up."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from plagnn_tpu_torch.data.preprocess import DEFAULT_DATASETS
    from plagnn_tpu_torch.ops.pcc_scan import csr_tensors

    gm = os.path.join(root, "generate_materials")
    files = [("PPI_normal", "PPI_normal.npz", "ECC_normal.npz")]
    files += [(f"{ds.name} PPI_inter", f"{ds.name}_data/PPI_inter.npz",
               f"{ds.name}_data/ECC_inter.npz") for ds in DEFAULT_DATASETS]
    out = []
    for name, ppi_file, ecc_file in files:
        a = sp.load_npz(os.path.join(gm, ppi_file)).tocsr().astype(np.float64)
        a.data[:] = 1.0
        q = sp.triu(a, k=1).tocoo()
        saved = sp.load_npz(os.path.join(gm, ecc_file))
        out.append((name, csr_tensors(a, DEVICE),
                    torch.as_tensor(q.row.astype(np.int32), device=DEVICE),
                    torch.as_tensor(q.col.astype(np.int32), device=DEVICE),
                    saved.data[:q.nnz], np.asarray(a.sum(axis=1)).ravel()))
    return out


def check_ecc_counts(graphs):
    """Per graph: the kernel's counts equal the plain version's on the card
    pair for pair, and give the saved ECC values (data/ecc.py's ratio)."""
    import numpy as np
    import torch

    from plagnn_tpu_torch.ops import common_neighbors as cn

    for name, csr, rows, cols, saved, deg in graphs:
        got = cn.common_neighbors(csr, rows, cols)
        torch.cuda.synchronize()
        plain = cn.common_neighbors_plain(csr, rows, cols)
        if not torch.equal(got, plain):
            fail(f"{name}: the ECC kernel's counts differ from the plain version's "
                 f"at {int((got != plain).sum())} of {rows.numel()} pairs")
        r, c = rows.cpu().numpy(), cols.cpu().numpy()
        den = np.minimum(deg[r], deg[c]) - 1.0
        tri = plain.cpu().numpy().astype(np.float64)
        if not np.array_equal(np.where(den > 0, tri / np.maximum(den, 1.0), 0.0), saved):
            fail(f"{name}: the saved ECC values differ from the plain counts' ratios")
        print(f"{name}: {rows.numel()} pairs, ECC counts kernel = plain, saved ECC "
              f"= their ratios", flush=True)


def check_pca_mid():
    """The card's pca against the CPU's at N = PCA_MID, 250 components (the
    randomized solver, n_iter 7), on a matrix with evenly spaced leading
    singular values 50 .. 10: every column within PCA_RTOL of the largest."""
    import numpy as np

    from plagnn_tpu_torch.data.pca import choose_solver, pca

    rng = np.random.default_rng(SEED)
    k = PCA_COMPONENTS + 20
    u = np.linalg.qr(rng.standard_normal((PCA_MID, k)))[0]
    v = np.linalg.qr(rng.standard_normal((PCA_MID, k)))[0]
    x = (u * np.linspace(50.0, 10.0, k)) @ v.T
    t0 = time.perf_counter()
    card = pca(x, PCA_COMPONENTS, device=DEVICE)
    t1 = time.perf_counter()
    cpu = pca(x, PCA_COMPONENTS, device="cpu")
    t2 = time.perf_counter()
    err = float(np.abs(card - cpu).max())
    if not err <= PCA_RTOL * 50.0:
        fail(f"pca at N = {PCA_MID}: the card's differs from the CPU's by {err}")
    print(f"pca N = {PCA_MID}, {PCA_COMPONENTS} components "
          f"({choose_solver(x.shape, PCA_COMPONENTS)}): card = CPU within {err:.3e} "
          f"(limit {PCA_RTOL * 50.0:.1e}); card {t1 - t0:.3f} s, CPU {t2 - t1:.3f} s",
          flush=True)


def time_ecc(graphs, results, smi_line):
    """The ECC kernel on the normal graph and on the first PPI_inter: CUDA
    events (median of 10; the wrapper's checks and item table included),
    the plain version (median of 3, of 1 on PPI_inter), the bound (the CSR
    and the queries read once, the counts written once; one int32 lookup
    per element of each pair's shorter row) and cuSPARSE's A·A
    (``torch.sparse.mm`` on the CSR, float32 ones; normal graph only, a
    yardstick never on the path)."""
    import torch

    from plagnn_tpu_torch.ops import common_neighbors as cn

    for g, (name, csr, rows, cols, _, _) in enumerate(graphs[:2]):
        indptr, indices = csr
        n, nnz, q = indptr.numel() - 1, indices.numel(), rows.numel()
        deg = indptr[1:] - indptr[:-1]
        d_r, d_c = deg[rows.long()], deg[cols.long()]
        lookups = int(torch.minimum(d_r, d_c).sum())
        probes = int((torch.minimum(d_r, d_c).double()
                      * torch.ceil(torch.log2(torch.maximum(d_r, d_c).double() + 1))).sum())
        ms = median_ms(lambda: cn.common_neighbors(csr, rows, cols), 10)
        plain_ms = median_ms(lambda: cn.common_neighbors_plain(csr, rows, cols),
                             3 if g == 0 else 1)
        lib_ms = None
        if g == 0:
            adj = torch.sparse_csr_tensor(indptr, indices.long(),
                                          torch.ones(nnz, device=DEVICE), size=(n, n))
            lib_ms = median_ms(lambda: torch.sparse.mm(adj, adj), 3)
            lib_nnz = torch.sparse.mm(adj, adj)._nnz()
            del adj
            torch.cuda.empty_cache()
        nbytes = 8 * (n + 1) + 4 * nnz + 8 * q + 4 * q
        entry = kernel_entry("ecc_common_neighbors_i32", "common_neighbors", 0.0, ms,
                             plain_ms, lib_ms, nbytes, lookups, (n, q), INT32_OPS_PER_S)
        if g == 0:
            results["ecc_common_neighbors_i32"] = entry
        profile_call(f"ECC counts on {name}", lambda: cn.common_neighbors(csr, rows, cols))
        print(f"  ECC counts on {name} ({smi_line}): {ms:.3f} ms (plain {plain_ms:.3f}, "
              f"A·A {'not measured' if lib_ms is None else f'{lib_ms:.3f}'}, bound "
              f"{entry['bound_ms']:.4f} by {entry['bound_by']}) at N = {n}, {q} pairs, "
              f"max degree {int(deg.max())}, sum min(deg) {lookups} lookups, "
              f"~{probes} binary-search probes"
              + (f", A·A nnz {lib_nnz}" if g == 0 else ""), flush=True)


def time_pca(root, smi_line):
    """One full-width PCA of phase 4p's ECC_normal on the card, split into
    its parts, with the peak device memory."""
    import scipy.sparse as sp
    import torch

    from plagnn_tpu_torch.data.pca import pca

    ecc = sp.load_npz(os.path.join(root, "generate_materials", "ECC_normal.npz"))
    torch.cuda.reset_peak_memory_stats()
    parts = {}
    t0 = time.perf_counter()
    pca(ecc, PCA_COMPONENTS, device=DEVICE, timings=parts)
    wall = time.perf_counter() - t0
    print(f"  PCA ECC_normal {ecc.shape[0]}^2 -> {PCA_COMPONENTS} ({smi_line}): "
          f"{wall:.3f} s = dense input {parts['dense']:.3f} + range finder "
          f"{parts['power']:.3f} + SVD, flip and copy {parts['svd']:.3f}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def preprocess_phase(results, smi_line):
    """Phase 4p: the main path (preprocess through the CLI, then one epoch
    on its bundle), each with every launch counter at 0 before and read
    after, then the checks and the timings."""
    import numpy as np
    import torch

    from plagnn_tpu_torch import cli
    from plagnn_tpu_torch.data.artifacts import load_condition
    from plagnn_tpu_torch.data.preprocess import DEFAULT_DATASETS

    root = tempfile.mkdtemp(prefix="chip_smoke_prep_")
    try:
        t0 = time.perf_counter()
        pairs = write_raw_inputs(root)
        print(f"raw inputs: {NODES} proteins, {pairs} pairs, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        steps = cli.main(["preprocess", "--data-root", root, "--no-dense-gcn", "-d", DEVICE])
        wall = time.perf_counter() - t0
        counts = check_launches("preprocess", {"ecc_common_neighbors_i32": 4,
                                               "pcc_diff_hits_f64": len(DEFAULT_DATASETS)})
        print(f"wall: preprocess {wall:.3f} s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi_line})", flush=True)
        for name, sec in steps:
            print(f"  step {name}: {sec:.3f} s", flush=True)
        if len(steps) != 1 + 4 + 3 + 3 + 1 + 10:
            fail(f"preprocess ran {len(steps)} steps: {[n for n, _ in steps]}")
        check_preprocess_artifacts(root)
        graphs = ecc_graphs(root)
        check_ecc_counts(graphs)
        check_pca_mid()
        for ds in DEFAULT_DATASETS:
            for cond in ("normal", "inter"):
                feats = load_condition(root, ds.name, cond).feats
                if feats.shape[1] != F_IN or not np.isfinite(feats).all():
                    fail(f"{ds.name} {cond}: features {feats.shape}, finite "
                         f"{bool(np.isfinite(feats).all())}")
        print(f"bundles: 6 conditions load with {F_IN} finite features", flush=True)
        reset_launches()
        stats = train_cli(root, "train-normal", "float32", 1)
        check_launches("train-normal on the preprocessed bundle", gnn32_launches("f32", 1))
        check_artifacts("train-normal on the preprocessed bundle",
                        os.path.join(root, "log", "GSE30931", "normal"))
        print(f"train-normal on the preprocessed bundle: 1 epoch x {FOLDS} folds, "
              f"{stats[0].epoch_ms[0]:.3f} ms", flush=True)
        time_ecc(graphs, results, smi_line)
        record_launches(results, counts)
        del graphs
        torch.cuda.empty_cache()
        time_pca(root, smi_line)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def sweep_row_chunk(full):
    """Median times of the row-chunked kernels (float32 sum forward and
    transpose at K = 10 x 400 and 10 x 12, max forward and backward at 10 x
    503) on the full graph's edges cut at each chunk size."""
    import torch

    from plagnn_tpu_torch.ops import spmm_kernels as sk
    from plagnn_tpu_torch.ops.graph_format import build_graph

    src, dst = full.src.numpy(), full.dst.numpy()
    gen = torch.Generator(device="cuda").manual_seed(9)
    n = full.n_nodes
    x = torch.randn((n, FOLDS * F_IN), generator=gen, device="cuda").relu_()
    g = torch.randn((n, FOLDS * F_IN), generator=gen, device="cuda")
    for cap in (128, 256, 512, 1024):
        graph = build_graph(src, dst, full.n_real_nodes, row_chunk=cap).to("cuda")
        _, arg = sk.spmm_max_fwd(graph, x)
        row = {"row_chunk": cap, "chunks": graph.chunks.n_chunks,
               "split_rows": graph.chunks.n_split,
               "max_fwd_f32_k5030": median_ms(lambda: sk.spmm_max_fwd(graph, x), 10),
               "max_bwd_f32_k5030": median_ms(lambda: sk.spmm_max_bwd(graph, g, arg), 10)}
        for width in SUM_WIDTHS:
            xs = x[:, :FOLDS * width].contiguous()
            for transpose in (False, True):
                key = f"sum_{'bwd' if transpose else 'fwd'}_f32_k{FOLDS * width}"
                row[key] = median_ms(lambda: sk.spmm_sum_rows(graph, xs, transpose), 10)
        print("row-chunk sweep: " + json.dumps(row), flush=True)


def tie_graph():
    """Small graph with a hub row, empty rows and many tied values."""
    import numpy as np

    from plagnn_tpu_torch.ops.graph_format import build_graph

    rng = np.random.default_rng(3)
    n = 300
    src = rng.integers(0, n, 2500)
    dst = rng.integers(0, n - 40, 2500)         # the last 40 rows stay empty
    src = np.concatenate([src, np.arange(n)])   # row 0: in-edges from everyone
    dst = np.concatenate([dst, np.zeros(n, np.int64)])
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    graph = build_graph(pairs[:, 0], pairs[:, 1], n, add_self_loops=False)
    k = 3 * 37
    vals = np.maximum(np.round(rng.standard_normal((graph.n_nodes, k)) * 2) / 2, 0)
    return graph, vals.astype(np.float32)


def cross_chunk_tie_graph():
    """Row 0 takes 3*ROW_CHUNK + 5 in-edges, from nodes 1 ... 3*ROW_CHUNK + 5
    (so the node at rank r is r + 1), and splits into 4 chunks; random
    edges elsewhere.  K = 130 (even, not a multiple of 4: the main path's
    8-byte float32 vectors, as at K = 5,030).  Columns by k % 4: 0 all
    equal (every row's first source wins); 1 all -inf (the same); 2 a
    maximum of 5 first reached at the first edge of row 0's chunk 1, 2 or
    3 and tied at every later chunk's first edge and at the row's last
    edge; 3 relu-style ties."""
    import numpy as np

    from plagnn_tpu_torch.ops.graph_format import ROW_CHUNK, build_graph

    rng = np.random.default_rng(13)
    n, hub, k = 1200, 3 * ROW_CHUNK + 5, 130
    src = rng.integers(0, n, 8000)
    dst = rng.integers(1, n - 20, 8000)         # no random edge into row 0
    src = np.concatenate([src, 1 + np.arange(hub)])
    dst = np.concatenate([dst, np.zeros(hub, np.int64)])
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    graph = build_graph(pairs[:, 0], pairs[:, 1], n)
    vals = np.maximum(np.round(rng.standard_normal((graph.n_nodes, k)) * 2) / 2, 0)
    cols = np.arange(k)
    vals[:, cols % 4 == 0] = 1.5
    vals[:, cols % 4 == 1] = -np.inf
    for c in cols[cols % 4 == 2]:
        vals[:, c] = np.minimum(vals[:, c], 2.0)
        first = 1 + (c // 4) % 3                # chunk of the first maximum
        vals[1 + np.arange(first, 4) * ROW_CHUNK, c] = 5.0
        vals[hub, c] = 5.0
    return graph, vals.astype(np.float32)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only-kernels", action="store_true",
                    help="stop after phase 3 (build and kernel checks); "
                         "prints no result line")
    ap.add_argument("--sweep-row-chunk", action="store_true",
                    help="after phase 3, time the row-chunked kernels on the "
                         "full graph at each chunk size and stop; prints no "
                         "result line")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "plagnn_tpu_torch")):
        fail("the plagnn_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    phase("1 device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi_line} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {kind} x{torch.cuda.device_count()}", flush=True)

    phase("2 build")
    from plagnn_tpu_torch.ops import _build

    build_s, logs = _build.timed_build(verbose=True)
    for name, log in logs.items():
        for fn, line in ptxas_report(log):
            print(f"  {name} {fn}: {line}")
    print(f"build: {build_s:.1f} s ({len(logs)} compiled)", flush=True)

    phase("3 kernels vs plain")
    from plagnn_tpu_torch.data.synthetic import powerlaw_ppi
    from plagnn_tpu_torch.ops.graph_format import from_scipy_coo

    graph, vals = tie_graph()
    check_kernels(graph.to("cuda"), torch.from_numpy(vals).cuda(), "tie graph")
    cross, cross_vals = cross_chunk_tie_graph()
    check_kernels(cross.to("cuda"), torch.from_numpy(cross_vals).cuda(),
                  f"cross-chunk tie graph ({cross.chunks.n_chunks} chunks, "
                  f"{cross.chunks.n_split} split row)")
    full = from_scipy_coo(powerlaw_ppi(NODES, EDGES, SEED), add_self_loops=True)
    print(f"full graph: N_pad {full.n_nodes}, E {full.n_edges}, max in-degree "
          f"{int(full.in_degree.max())}", flush=True)
    rng = np.random.default_rng(SEED)
    x_full = rng.standard_normal((full.n_nodes, FOLDS * F_IN), dtype=np.float32)
    # relu of bf16-representable values: ties at 0, identical in f32 and bf16
    x_full = torch.from_numpy(x_full).cuda().to(torch.bfloat16).float().relu_()
    for direction, ch in (("forward", full.chunks), ("transpose", full.t_chunks)):
        print(f"full graph {direction} row chunks (ROW_CHUNK {ch.cap}): "
              f"{ch.n_chunks} chunks over {full.n_nodes} rows, {ch.n_split} split "
              f"rows, {ch.n_slots} partial slots", flush=True)
    full_cuda = full.to("cuda")
    results = {}
    check_kernels(full_cuda, x_full, "full graph layer 1", results)
    # the main path's other widths (layers 2 and 3): checked, not timed
    for layer, width in enumerate(AGG_WIDTHS[1:], start=2):
        check_kernels(full_cuda, x_full[:, :FOLDS * width].contiguous(),
                      f"full graph layer {layer}")
    del x_full
    torch.cuda.empty_cache()
    # segment sum: GCN2's widths, conv1 timed
    check_sum_kernels(graph.to("cuda"), vals.shape[1], "tie graph")
    check_sum_kernels(full_cuda, FOLDS * SUM_WIDTHS[0], "full graph GCN2 conv1", results)
    # conv2's narrow rows: its float32 entries go into the kernels line too
    check_sum_kernels(full_cuda, FOLDS * SUM_WIDTHS[1], "full graph GCN2 conv2",
                      results, suffix=CONV2)
    del full_cuda
    torch.cuda.empty_cache()
    if args.only_kernels or args.sweep_row_chunk:
        print(json.dumps({"kernels": list(results.values())}))
        if args.sweep_row_chunk:
            sweep_row_chunk(full)
        return

    phase("4 GNN32 at full width")
    from plagnn_tpu_torch import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cli.main(["synth", "--data-root", tmp, "--nodes", str(NODES),
                  "--edges", str(EDGES), "--seed", str(SEED)])
        runs = (
            ("train-normal", "normal", "float32", EPOCHS_F32, "f32"),
            ("train-inter", "perturbation", "bfloat16", EPOCHS_BF16, "bf16"),
        )
        for cmd, subdir, agg, epochs, tag in runs:
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            stats = train_cli(tmp, cmd, agg, epochs)
            wall = time.perf_counter() - t0
            counts = check_launches(f"{cmd} --agg-dtype {agg}",
                                    gnn32_launches(tag, epochs))
            record_launches(results, counts)
            check_artifacts(cmd, os.path.join(tmp, "log", "GSE30931", subdir))
            report_run(f"GNN32 {cmd} {agg}", stats, wall, counts, smi_line)
        phase("4a analysis at full width")
        analysis_phase(tmp, results)
        phase("4b profile")
        # the earlier run's artifacts would make this one resume past its round
        shutil.rmtree(os.path.join(tmp, "log"))
        per_kernel = profile_epochs(
            "GNN32 train-normal f32",
            lambda: train_cli(tmp, "train-normal", "float32", EPOCHS_F32),
            gnn32_launches("f32", EPOCHS_F32), smi_line)
        crosscheck_max_fwd(per_kernel, results, smi_line)
        phase("4c GCN2 at full width")
        check_gcn2(tmp, results, smi_line)
        profile_epochs("GCN2 train() f32",
                       lambda: train_gcn2(tmp, os.path.join(tmp, "log_gcn2_profiled")),
                       GCN2_LAUNCHES, smi_line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase("4p preprocess at full width")
    preprocess_phase(results, smi_line)

    phase("5 summary")
    kernels = [results[k] for k in (
        "spmm_max_fwd_f32", "spmm_max_fwd_bf16", "spmm_max_fwd_noarg_f32",
        "spmm_max_bwd_f32", "spmm_max_bwd_bf16",
        "spmm_sum_fwd_f32", "spmm_sum_fwd_bf16", "spmm_sum_bwd_f32", "spmm_sum_bwd_bf16",
        "spmm_sum_fwd_f32" + CONV2, "spmm_sum_bwd_f32" + CONV2,
        "pcc_diff_count_f64", "pcc_diff_hits_f64", "ecc_common_neighbors_i32")]
    for r in kernels:
        if not all(math.isfinite(r[k]) for k in ("ms", "plain_ms", "bound_ms", "library_ms")):
            fail(f"{r['name']}: non-finite timing")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
