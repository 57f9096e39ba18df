#!/usr/bin/env python3
"""On-card acceptance check of the PyTorch/CUDA port (plagnn_tpu_torch).

    python3 chip_smoke.py [--only-...]

Needs one CUDA card and nvcc.  It answers whether each kernel and each path
is right on the card at full shapes: every kernel against its plain PyTorch
version, every CLI path trained with its launch counts and artifacts
checked.  How fast each benchmark cell runs is ``gpubench/run.py``'s
question (``--trace 1`` adds the per-kernel device times and idle share);
the card's unit tests are ``tests/test_torch_cuda*.py -m cuda``.  Each
kernel is also timed at its path's shape (CUDA events) beside its plain
version, a library yardstick and its compulsory bytes at the HBM rate, as
``gpubench/counts.py`` and ``gpubench/kinds/`` count them, for PERF.md's
kernel table.  Phases, in order; any failure exits nonzero:

1. Device: the card's name and power limit (nvidia-smi).
2. Build: the kernels in plagnn_tpu_torch/csrc, with each kernel's
   registers and spills as ptxas reports them.
3. Kernels against their plain versions: the segment max (forward with and
   without the argmax, backward) and sum (forward, transpose) on a tie
   graph, a cross-chunk tie graph and the 24k-node synthetic PPI at each
   width GNN32 and GCN2 aggregate, float32 and bfloat16, bit-exact or
   within check_kernels' / check_sum_kernels' tolerances and run to run;
   the edge-weighted sum at GCN2 conv1's K.
   3g. GCN's scaled sum at GCN2's shapes (24k nodes; 330,000 nodes at
   K = 8 x 400), bit-identical to the composition of the card's passes.
   3i. GAT's edge-softmax pair at the GAT cell's widths, within GAT_RTOL /
   GAT_ATOL of its plain version; after 4c, GAT through ``train()``: its
   launches and artifacts.
   3h. The hub cache's kernels at every width, bit-equal to the kernels
   without the hub and held to their plain versions; timed by k and at
   k = 0 (zero_hub), with the warps an SM holds.
   3d. The gather probe (plagnn_tpu_torch/bench/dma_ceiling.py) bit-equal
   to its plain version at CHECK_SHAPES, then its short sweep.
4. GNN32 at full width through the CLI: synth, train-normal float32 and
   train-inter bfloat16: each run's launches per epoch and the artifacts.
   4a. score, performance and statistics through the CLI on 4's log; the
   ΔPCC hit and count kernels against their plain versions.
   4f. ``figures --diff-hist --alpha-dist``: the ΔPCC histogram kernel
   against its plain version, the JSON files; ``--save-diff`` at N = 4,096.
   4c. GCN2 through ``train()`` with a mid-round checkpoint: its launches,
   the artifacts, the checkpoint seen after epoch 2 and removed at the end.
   4m. The multi-device path on the one card: every P = 2 / 4 shard through
   the -inf max kernels; ``train()`` at fold=1,graph=2 and fold=2,graph=2
   on gloo ranks against 4's single-card float32 run; a NCCL group of one.
   4q. The mesh planner's anchors (rate sweep, fold ceiling, structure
   tax), ``plan-mesh`` and ``train-normal --mesh auto``.
   4h. The hub on the main path: GNN32 and GCN2 with ``--hub-cache off``
   and HUB_MAIN_K write byte-identical files; the hub kernels' launches.
   4s. The hub on the mesh's interior pass: (a) every P = 2 / 4 interior
   shard bit-equal to the kernels without the hub; (b), in 4g, config 5's
   P = 2 shard; (c) the NCCL graph=1 runner and (d) the CLI's
   fold=1,graph=2 with and without the hub, bit-identical.
   4p. ``preprocess --no-dense-gcn`` at full width from synthetic raw
   files: the ECC and ΔPCC kernels' launches and counts, the PCA against
   the CPU's, the bundles and one epoch on them.
   4o. The other ops: sampled graphs through the max kernels and the
   weighted sum (one forward traced), and both kernels under the identity,
   RCM and greedy orders.
   4g. The big graph (BASELINE.json config 5: 330,000 nodes, 10 M edges):
   the positional and the id-based int32 max kernels against their plain
   versions and each other, at the rule's K-slice and at 1 KB; GNN32
   through the CLI at 8 folds; each argmax form's peak memory; the hub.
5. The ``{"kernels": [...]}`` line, the nvidia-smi line and last the
   ``{"ok": true, "device": {...}}`` line.

Each ``--only-*`` flag runs phases 1-2 and the phases it names, then stops
without the ``ok`` line: ``--only-kernels`` (3 with 3g, 3i's kernels, 3h
and 3d), ``--only-gcn-sum`` (3g), ``--only-gat`` (3i), ``--only-hub`` (3's
layer-1 checks, 3h, 4h), ``--only-dma-ceiling`` (3d), ``--only-mesh`` (4's
float32 run, 4m), ``--only-planner`` (4m's NCCL group, 4q),
``--only-mesh-hub`` (4s) and ``--only-big-graph`` (4g).  Those that time
kernels print their entries of the ``kernels`` line.
"""
import contextlib
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
    "dma_ceiling": "plagnn_tpu_torch/csrc/dma_ceiling.cu",
    "spmm_gat": "plagnn_tpu_torch/csrc/spmm_gat.cu",
}
_FWD_BODY = "plagnn_tpu/ops/pallas/spmm_kernels.py:513"  # _spmm_fwd_kernel
_HUB_FWD = "plagnn_tpu/ops/pallas/spmm_kernels.py:588"  # _spmm_fwd_kernel's hub groups
CONV2 = "_k120"  # name suffix of the sum's entries at GCN2 conv2's width
# the JAX package's edge-weighted sum: ell_reduce_sum(use_val=True), XLA
_VAL_SUM = "plagnn_tpu/ops/spmm.py:105"
# the JAX package's gcn_propagate around pallas_spmm_sum (_FWD_BODY)
_GCN = "plagnn_tpu/ops/spmm.py:210"
REPLACES = {
    "spmm_max_fwd_f32": _FWD_BODY,
    "spmm_max_fwd_bf16": _FWD_BODY,
    "spmm_max_fwd_noarg_f32": _FWD_BODY,
    # empty_value=-inf: a graph shard's interior and boundary passes
    "spmm_max_fwd_empty_f32": _FWD_BODY,
    "spmm_max_fwd_empty_bf16": _FWD_BODY,
    "spmm_max_bwd_f32": "plagnn_tpu/ops/pallas/spmm_kernels.py:982",
    "spmm_max_bwd_bf16": "plagnn_tpu/ops/pallas/spmm_kernels.py:1270",
    # the positional argmax: the same bodies' positional mode (:1007,
    # :1297), build_pallas_graph(positional=...) :1755
    "spmm_max_fwd_pos_f32": _FWD_BODY,
    "spmm_max_fwd_pos_bf16": _FWD_BODY,
    "spmm_max_bwd_pos_f32": "plagnn_tpu/ops/pallas/spmm_kernels.py:982",
    "spmm_max_bwd_pos_bf16": "plagnn_tpu/ops/pallas/spmm_kernels.py:1270",
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
    # no Pallas kernel: numpy GEMM blocks and np.histogram
    "pcc_diff_hist_f64": "plagnn_tpu/analysis/figures.py:33",
    "spmm_sum_val_fwd_f32": _VAL_SUM,
    "spmm_sum_val_fwd_bf16": _VAL_SUM,
    "spmm_sum_val_bwd_f32": _VAL_SUM,
    "spmm_sum_val_bwd_bf16": _VAL_SUM,
    # GCN's scaled sum: the sum body with gcn_propagate's norm='both' passes
    # and GraphConv's bias folded in
    "spmm_sum_gcn_fwd_f32": _GCN,
    "spmm_sum_gcn_fwd_bf16": _GCN,
    "spmm_sum_gcn_bwd_f32": _GCN,
    "spmm_sum_gcn_bwd_bf16": _GCN,
    # the hub cache: the with_hub paths of the three bodies
    "spmm_max_fwd_hub_f32": _HUB_FWD,
    "spmm_max_fwd_hub_bf16": _HUB_FWD,
    "spmm_max_bwd_hub_f32": "plagnn_tpu/ops/pallas/spmm_kernels.py:1009",
    "spmm_max_bwd_hub_bf16": "plagnn_tpu/ops/pallas/spmm_kernels.py:1299",
    "spmm_sum_fwd_hub_f32": _HUB_FWD,
    "spmm_sum_fwd_hub_bf16": _HUB_FWD,
    "spmm_sum_bwd_hub_f32": _HUB_FWD,
    "spmm_sum_bwd_hub_bf16": _HUB_FWD,
    # the gather probe of the benchmark folder (build_bench :117 -> :152)
    "dma_ring_f32": "benchmarks/dma_ceiling.py:47",
    # no Pallas kernel: the JAX package has no attention GNN (DGL 0.8
    # GATConv's edge_softmax and u_mul_e_sum, and their backward)
    "spmm_gat_fwd_f32": "none",
    "spmm_gat_bwd_f32": "none",
}
NODES, EDGES, SEED = 24041, 700000, 70
FOLDS, F_IN = 10, 503
EPOCHS_F32, EPOCHS_BF16, EPOCHS_GCN2 = 3, 2, 3
LAYERS = 3
AGG_WIDTHS = (F_IN, 400, 300)  # per-fold width of each SAGE-pool aggregation
MESH_EPOCHS = EPOCHS_F32  # phase 4m: the single-card run it compares with is 4's
MESH_RUNS = ((1, 2), (2, 2))   # (fold, graph) of phase 4m's sharded runs
SHARD_PARTS = (2, 4)    # graph ranks of phase 4m's shard-kernel checks
MESH_TIMEOUT_S = 600    # a hung rank fails phase 4m
# Logits and losses of a sharded run against the single-card run of the
# same jobs.  The JAX package's sharded engine tests hold 1e-5 over 4
# epochs at a small size, as tests/test_torch_parallel.py does; at full
# width a 3-epoch fold=1,graph=2 run gave 1.98e-5 (float32 sums of C-row
# against N-row matmuls, through Adam's normalised step, which can turn a
# near-zero gradient's rounding into a +-lr move).  Gate: 1e-4, the
# tolerance tests/test_torch_train.py holds the runner to against JAX.
MESH_ATOL = 1e-4
GCN2_HIDDEN, CLASSES = 400, 12
# per-fold width of each GCN2 aggregation: W first (503 > 400, 400 > 12)
SUM_WIDTHS = (GCN2_HIDDEN, CLASSES)
# phase 3i: the GAT cell's fold batch, (heads, width a head) of layers 1-2
# and of layer 3, and the train() run's epochs.  The pair on the card
# against its plain version on the card (tests/test_torch_gat.py's
# CARD_TOL): an online softmax against exp(e - lse), sums in another order,
# __expf; the gradients' atol scaled by their largest magnitude (sums of up
# to ~10^4 terms)
GAT_FOLDS, GAT_SHAPES, GAT_EPOCHS = 32, ((4, 256), (6, 12)), 2
GAT_RTOL, GAT_ATOL = 2e-4, 2e-5
# the datasets' topology thresholds (plagnn_tpu/analysis/statistics.py:65-67)
ANALYSIS_DATASETS = (("GSE30931", 2.75), ("GSE74572", 2.91), ("GSE27182", 2.99))
PERTURB_SIGMA = 0.1   # expr_inter = expr_normal x exp(0.1 N(0, 1)), seeded
LIB_BLOCK_ROWS = 2048  # row block of the blocked-DGEMM yardstick
DEVICE = "cuda"        # phases 3d, 4a and 4g ("cpu" runs their logic on the plain versions)
CC_TERMS = ("GO:0005938", "GO:0005829", "GO:0015629", "GO:0005794", "GO:0005783",
            "GO:0005730", "GO:0005777", "GO:0005739", "GO:0005764", "GO:0005813",
            "GO:0005634", "GO:0005886")
PCA_COMPONENTS = 250
PCA_MID = 4096         # size of the card-vs-CPU PCA check (the randomized solver)
PCA_RTOL = 1e-9        # tests/test_torch_preprocess.py's, relative to sigma_0
SAVE_DIFF_NODES = 4096  # the --save-diff bundle (N² float64 a file)
FANOUTS = (10, 25)      # phase 4o's sampled graphs
# phase 4g: BASELINE.json config 5, the synthetic 10M-edge PPI-like graph
# (benchmarks/big_graph.py: run_rate), 8 folds in one batch
BIG_NODES, BIG_EDGES, BIG_FOLDS, BIG_EPOCHS = 330000, 10_000_000, 8, 2
BIG_TIES = 64           # phase 4g's all-equal column block: columns [0, 64)
BIG_MEGA_COLS = 64      # then columns whose top row's maximum is past the rank cap
LIB_SLICE_BYTES = 4 << 30  # phase 4g's library yardstick: gathered bytes a slice
# phase 3h: the explicit hub sizes tried (each halved to fit by
# pick_hub_sizes: two stages take k <= 113 at 1 KB rows), and the k of the
# main path's hub runs (phase 4h)
HUB_KS = (32, 64, 75, 113)
HUB_MAIN_K = 128
# phase 4s: the hub sizes tried on the 24k graph's interior shards (each
# halved to fit), the k of their kernels-line entries and of the CLI mesh
# runs (d), those runs' epochs and dtypes; (b) and (c) take HUB_MAIN_K
SHARD_HUB_KS = (32, 64, 128)
SHARD_HUB_K = 64
CLI_MESH_EPOCHS = 2
CLI_MESH_AGGS = (("float32", "f32", 4), ("bfloat16", "bf16", 2))
# phase 4q: the rate sweep's fold batches (those checked against the plain
# versions), the fold batches of the peak-memory epochs, the plans' card
# counts and the --mesh auto run's rounds; phase 4m (c)'s epochs (the first
# warms up; the tax is the median of the rest)
PLAN_BS = (10, 16, 20, 24, 28, 32, 48, 64)
PLAN_CHECK_BS = (10, 64)
CEILING_BS = (10, 20)
PLAN_DEVICES = (1, 2, 4, 8)
PLAN_ROUNDS = 3
TAX_EPOCHS = 5
ANCHORS_FILE = os.path.join(HERE, "chiprun_out", "planner_anchors.json")
# phase 3d: the probe's row widths (the max kernels' 256 B and 1 KB
# K-slices, a whole layer-1 row of 10 x 503 f32 padded to 20,480 B), its
# tables (the 24k graph's N_pad, 165 k nodes between it and phase 4g's,
# phase 4g's N_pad), MiB fetched a launch, repetitions and ring depth; the
# widths of the 24k graph's edge-order ids
DMA_WIDTHS = (256, 1024, 20480)
DMA_TABLES = (24064, 165000, 330112)
DMA_TARGET_MB = 256
DMA_REPS = 10
DMA_RING = 8
DMA_EDGE_WIDTHS = (256, 1024)
# per traced session: (the block's launches without a kernel event, its
# launches, its earliest kernel start less its launch's in us, the
# warm-up's launches without a kernel event)
TRACE_SESSIONS = []


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


def timed_ms(fn):
    """(fn's result, the time of that one call in ms by CUDA events)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


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
                 ops_per_s=FP32_OPS_PER_S, slice_bytes=None):
    """One entry of the ``kernels`` line; ``bound_ms`` from the compulsory
    bytes (each input read once, each output written once) at the HBM rate
    and the operations at their type's rate (float32 unless given),
    whichever is larger; ``slice_bytes`` the K-slice width its timed launch
    walked: as given, else as its wrapper recorded its last launch at this
    shape (spmm_kernels.LAUNCH_SLICES; None for a kernel without K-slices).
    Launches are filled in from the main path's runs."""
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    if slice_bytes is None:
        slice_bytes = sk.LAUNCH_SLICES.get((counter_of(name), *shape))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": KERNEL_SOURCE[source],
        "replaces": REPLACES[counter_of(name)],
        "launches": 0,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib,
        "shape": list(shape),
        "slice_bytes": slice_bytes,
    }


def bench_shape(graph, asize=None):
    """``graph``'s shape as the benchmark counts compulsory bytes
    (gpubench/counts.py: GraphShape), held to the argmax's element size
    ``asize`` that the kernels stored, where given."""
    from gpubench.counts import GraphShape

    shape = GraphShape(n=graph.n_real_nodes, n_pad=graph.n_nodes, edges=graph.n_edges,
                       positional=graph.positional, n_mega=graph.n_mega)
    if asize is not None and shape.arg_bytes != asize:
        fail(f"graph of {graph.n_nodes} rows: a {asize}-byte argmax, the byte count's is "
             f"{shape.arg_bytes}")
    return shape


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


def check_kernels(graph, x32, label, results=None, dtypes=None):
    """Kernel vs plain version on one graph and input (float32 and bfloat16,
    or ``dtypes``); with ``results``, also time both and the library
    yardsticks at this shape."""
    import torch

    from gpubench.counts import max_bwd_bytes, max_fwd_bytes
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    n, k = x32.shape
    e = graph.n_edges
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        if dtypes is not None and dt not in dtypes:
            continue
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
        shape = bench_shape(graph, asize)
        fwd_ops = e * k                      # one compare per edge element
        bwd_ops = e * k + nonempty * k       # compares + one add per hit
        timed = [
            (f"spmm_max_fwd_{tag}", "spmm_max_fwd", fwd_err, fwd_ms, fwd_plain_ms,
             fwd_lib_ms, max_fwd_bytes(shape, k, esize), fwd_ops,
             e * k * esize + n * k * (esize + asize)),
            (f"spmm_max_bwd_{tag}", "spmm_max_bwd", bwd_err, bwd_ms, bwd_plain_ms,
             bwd_lib_ms, max_bwd_bytes(shape, k, esize), bwd_ops,
             e * k * (esize + asize) + n * k * esize),
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
                          2 * n * k * esize + 4 * (n + 1 + e), fwd_ops,
                          e * k * esize + n * k * esize))
        for name, src, err_, ms, plain, lib, nbytes, ops, gather in timed:
            r = results[name] = kernel_entry(name, src, err_, ms, plain, lib,
                                             nbytes, ops, (n, k))
            print(f"  {name}: {ms:.3f} ms (plain {plain:.3f}, library {lib:.3f}, "
                  f"bound {r['bound_ms']:.3f} by {r['bound_by']}, no-reuse gather "
                  f"{gather / HBM_BYTES_PER_S * 1e3:.3f})", flush=True)


def check_sum_kernels(graph, k, label, results=None, suffix="", dtypes=None):
    """The segment-sum kernel against its plain version, forward and
    transpose, at K elements per row; with ``results``, also time both
    directions, the plain version and ``torch.sparse.mm`` on the CSR
    adjacency (a yardstick only, never on the path), entered under the
    kernel's counter name plus ``suffix``."""
    import torch

    from gpubench.counts import sum_bytes
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    n, e, dev = graph.n_nodes, graph.n_edges, graph.device
    gen = torch.Generator(device=dev).manual_seed(7)
    x32 = torch.randn((n, k), generator=gen, device=dev)
    xint = torch.randint(-8, 9, (n, k), generator=gen, device=dev).float()
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        if dtypes is not None and dt not in dtypes:
            continue
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
                sum_bytes(bench_shape(graph), k, esize), e * k, (n, k))
            print(f"  {name}: {ms:.3f} ms (plain {plain:.3f}, library {lib:.3f}, "
                  f"bound {r['bound_ms']:.3f} by {r['bound_by']}, no-reuse gather "
                  f"{(e + n) * k * esize / HBM_BYTES_PER_S * 1e3:.3f})", flush=True)
            del adj
    del x32, xint
    torch.cuda.empty_cache()


def check_gcn_sum(graph, k, label, results, suffix=""):
    """Kernel-table row 3d, GCN's scaled sum (``spmm_sum_gcn_rows``) at K
    elements a row: forward with a bias and transpose, float32 and bfloat16,
    each bit-identical to the composition of the card's passes (scale,
    unscaled sum, scale, bias) and, in float32, within 1e-5 of the summed
    magnitudes of the plain version; then times (median of 10) the scaled
    kernel beside the unscaled kernel and the composition in the same
    call, the plain version (median of 3) and ``torch.sparse.mm`` on the
    normalised adjacency (a yardstick: one call, no bias).  Entered under
    the kernel's counter name plus ``suffix``."""
    import torch

    from gpubench.counts import sum_bytes
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    n, e, dev = graph.n_nodes, graph.n_edges, graph.device
    gen = torch.Generator(device=dev).manual_seed(9)
    x32 = torch.randn((n, k), generator=gen, device=dev)
    bias32 = torch.randn(k, generator=gen, device=dev)
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x, bias = x32.to(dt), bias32.to(dt)
        pre, post = sk.gcn_scales(graph, dt)
        for transpose in (False, True):
            direction = "bwd" if transpose else "fwd"
            a, b = (post, pre) if transpose else (pre, post)
            a, b = a.to(dt)[:, None], b.to(dt)[:, None]
            bf = None if transpose else bias.float()

            def scaled():
                return sk.spmm_sum_gcn_rows(graph, x, bf, transpose)

            def composed():
                s = sk.spmm_sum_rows(graph, x * a, transpose) * b
                return s if transpose else s + bias

            out_k = scaled()
            torch.cuda.synchronize()
            if not torch.equal(out_k, scaled()):
                fail(f"{label}: scaled sum {direction} {tag} is not deterministic run to run")
            if not torch.equal(out_k, composed()):
                fail(f"{label}: scaled sum {direction} {tag} differs from the composition "
                     "of the card's passes")
            out_p = sk.spmm_sum_gcn_plain(graph, x, a[:, 0].float(), b[:, 0].float(), bf,
                                          transpose)
            err_max = (out_k.float() - out_p.float()).abs().max().item()
            if dt == torch.float32:
                mag = sk.spmm_sum_gcn_plain(graph, x.abs(), a[:, 0], b[:, 0],
                                            None if bf is None else bf.abs(), transpose)
                if bool(((out_k - out_p).abs() > 1e-5 * mag + 1e-7).any()):
                    fail(f"{label}: scaled sum {direction} f32 differs from plain beyond 1e-5 "
                         f"of the summed magnitudes (max abs {err_max})")
            print(f"{label}: scaled sum {direction} {tag} K={k} bit-identical to the "
                  f"composition; max abs err against plain {err_max:.3e}", flush=True)
            indptr, idx = ((graph.t_indptr, graph.t_dst) if transpose
                           else (graph.indptr, graph.src))
            rows = torch.repeat_interleave(torch.arange(n, device=dev), indptr.diff().long())
            vals = (a[idx.long(), 0].float() * b[rows, 0].float()).to(dt)
            adj = torch.sparse_csr_tensor(indptr, idx, vals, size=(n, n),
                                          check_invariants=False)
            ms = median_ms(scaled, 10)
            unscaled = median_ms(lambda: sk.spmm_sum_rows(graph, x, transpose), 10)
            comp = median_ms(composed, 10)
            plain = median_ms(lambda: sk.spmm_sum_gcn_plain(
                graph, x, a[:, 0].float(), b[:, 0].float(), bf, transpose), 3)
            lib = median_ms(lambda: torch.sparse.mm(adj, x), 10)
            esize = x.element_size()
            name = f"spmm_sum_gcn_{direction}_{tag}{suffix}"
            # the sum's bytes, the two scales and the bias; a multiply and an
            # add an edge element, a multiply and an add a stored element
            r = results[name] = kernel_entry(
                name, "spmm_sum", err_max, ms, plain, lib,
                sum_bytes(bench_shape(graph), k, esize) + 8 * n + (0 if transpose else 4 * k),
                2 * e * k + 2 * n * k, (n, k))
            r["unscaled_ms"] = unscaled
            r["composition_ms"] = comp
            print(f"  {name}: {ms:.3f} ms (unscaled {unscaled:.3f}, composition {comp:.3f}, "
                  f"plain {plain:.3f}, library {lib:.3f}, bound {r['bound_ms']:.3f} by "
                  f"{r['bound_by']})", flush=True)
            del adj, rows, vals
    del x32, bias32
    torch.cuda.empty_cache()


def gcn_sum_phase(results, smi_line, full=None):
    """Kernel-table row 3d on GCN2's two graphs: the 24k-node graph (``full``,
    or built here) at conv1's K = 10 x 400 and conv2's 10 x 12, and
    BASELINE.json config 5's 330,000 nodes and 10 M edges at conv1's
    K = 8 x 400 (entries ``@n<N_pad>``)."""
    import torch

    from plagnn_tpu_torch.data.synthetic import powerlaw_ppi
    from plagnn_tpu_torch.ops.graph_format import from_scipy_coo

    if full is None:
        full = from_scipy_coo(powerlaw_ppi(NODES, EDGES, SEED), add_self_loops=True)
    g = full.to(DEVICE)
    check_gcn_sum(g, FOLDS * SUM_WIDTHS[0], "full graph GCN2 conv1", results)
    check_gcn_sum(g, FOLDS * SUM_WIDTHS[1], "full graph GCN2 conv2", results, suffix=CONV2)
    del g
    t0 = time.perf_counter()
    big = from_scipy_coo(powerlaw_ppi(BIG_NODES, BIG_EDGES, SEED), add_self_loops=True)
    print(f"big graph: N_pad {big.n_nodes}, E {big.n_edges}, forward chunks "
          f"{big.chunks.n_chunks} ({big.chunks.n_split} split rows), transpose "
          f"{big.t_chunks.n_chunks} ({big.t_chunks.n_split}); built in "
          f"{time.perf_counter() - t0:.1f} s ({smi_line})", flush=True)
    check_gcn_sum(big.to(DEVICE), BIG_FOLDS * GCN2_HIDDEN, "big graph GCN2 conv1", results,
                  suffix=f"@n{big.n_nodes}")
    torch.cuda.empty_cache()


def check_gat_pair(graph, heads, f, label, results, suffix=""):
    """GAT's pair at K = GAT_FOLDS x heads x f against its plain versions
    on the card: bit-identical run to run, within GAT_RTOL / GAT_ATOL (lse
    on the real rows: a padding row has no in-edge); then each timed beside
    its plain version and its bytes bound, the benchmark's count
    (gpubench/kinds/gat_conv.py) (entries ``spmm_gat_{fwd,bwd}_f32`` +
    ``suffix``)."""
    import torch

    from gpubench.kinds import gat_conv
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    n, e, dev = graph.n_nodes, graph.n_edges, graph.device
    bh = GAT_FOLDS * heads
    k = bh * f
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wh = torch.randn((n, k), generator=gen, device=dev)
    el = 2 * torch.randn((n, bh), generator=gen, device=dev)
    er = 2 * torch.randn((n, bh), generator=gen, device=dev)
    g = torch.randn((n, k), generator=gen, device=dev)
    names = ("out", "lse", "dwh", "del", "der")
    runs = []
    for _ in range(2):
        out, lse = sk.spmm_gat_fwd(graph, wh, el, er, f)
        runs.append((out, lse, *sk.spmm_gat_bwd(graph, g, wh, el, er, lse, f)))
        torch.cuda.synchronize()
    for name, a, b in zip(names, *runs):
        if not torch.equal(a, b):
            fail(f"{label}: GAT {name} is not deterministic")
    got = runs[0]
    del runs
    p_out, p_lse = sk.spmm_gat_fwd_plain(graph, wh, el, er, f)
    want = (p_out, p_lse, *sk.spmm_gat_bwd_plain(graph, g, wh, el, er, p_lse, f))
    real = graph.n_real_nodes
    errs = {}
    for name, a, w in zip(names, got, want):
        if name == "lse":
            a, w = a[:real], w[:real]
        scale = max(float(w.abs().max()), 1.0) if name.startswith("d") else 1.0
        err = (a - w).abs()
        if bool((err > GAT_ATOL * scale + GAT_RTOL * w.abs()).any()):
            fail(f"{label}: GAT {name} differs from plain beyond rtol {GAT_RTOL}, atol "
                 f"{GAT_ATOL} x {scale:.3g} (max abs {float(err.max()):.3e})")
        errs[name] = float(err.max())
        del err
    print(f"{label}: GAT pair K={k} ({GAT_FOLDS} x {heads} x {f}) max abs err "
          f"{ {k_: f'{v:.3e}' for k_, v in errs.items()} }", flush=True)
    lse = got[1]
    del got, want, p_out, p_lse
    torch.cuda.empty_cache()
    timed = {
        "fwd": (median_ms(lambda: sk.spmm_gat_fwd(graph, wh, el, er, f), 10),
                median_ms(lambda: sk.spmm_gat_fwd_plain(graph, wh, el, er, f), 3),
                max(errs["out"], errs["lse"]), 2 * e * k),
        "bwd": (median_ms(lambda: sk.spmm_gat_bwd(graph, g, wh, el, er, lse, f), 10),
                median_ms(lambda: sk.spmm_gat_bwd_plain(graph, g, wh, el, er, lse, f), 3),
                max(errs["dwh"], errs["del"], errs["der"]), 4 * e * k)}
    shape = bench_shape(graph)
    nbytes = {"fwd": gat_conv.fwd_bytes(shape, k, bh), "bwd": gat_conv.bwd_bytes(shape, k, bh)}
    for direction, (ms, plain, err, ops) in timed.items():
        name = f"spmm_gat_{direction}_f32{suffix}"
        # a multiply and an add an edge element forward; the backward's
        # dwh term and the dot of g with wh, each a multiply and an add
        r = results[name] = kernel_entry(name, "spmm_gat", err, ms, plain, None,
                                         nbytes[direction], ops, (n, k))
        print(f"  {name}: {ms:.3f} ms (plain {plain:.3f}, {plain / ms:.1f}x; bound "
              f"{r['bound_ms']:.3f} by {r['bound_by']}, {100 * r['bound_ms'] / ms:.1f}%; "
              f"gathered rows {e * k * 4 / ms / 1e9:.2f} TB/s)", flush=True)
    del wh, el, er, g, lse
    torch.cuda.empty_cache()


def gat_phase(results, full=None):
    """Phase 3i's kernel checks on the 24k-node graph (``full``, or built
    here), at layers 1-2's width and, as entries ``@k<K>``, layer 3's."""
    import torch

    from plagnn_tpu_torch.data.synthetic import powerlaw_ppi
    from plagnn_tpu_torch.ops.graph_format import from_scipy_coo

    if full is None:
        full = from_scipy_coo(powerlaw_ppi(NODES, EDGES, SEED), add_self_loops=True)
    g = full.to(DEVICE)
    print(f"GAT graph: N_pad {g.n_nodes}, E {g.n_edges}, split rows forward "
          f"{g.chunks.n_split}, transpose {g.t_chunks.n_split}", flush=True)
    if not (g.chunks.n_split and g.t_chunks.n_split):
        fail("GAT graph: no split row in one direction, so a combine goes unchecked")
    for layer, (heads, f) in enumerate(GAT_SHAPES):
        suffix = "" if layer == 0 else f"@k{GAT_FOLDS * heads * f}"
        check_gat_pair(g, heads, f, f"full graph GAT layer {'1-2' if layer == 0 else 3}",
                       results, suffix)
    del g
    torch.cuda.empty_cache()


def gat_launches(graph, epochs):
    """A GAT ``train()`` run: each of its 3 layers one forward and one
    backward an epoch, the backward with its der and del passes, and each
    direction's combine where that direction of ``graph`` has split rows."""
    from plagnn_tpu_torch.models.gnn32 import GAT_HEADS

    n = len(GAT_HEADS) * epochs
    want = {f"spmm_gat_{k}_f32": n for k in ("fwd", "bwd", "bwd_der", "bwd_del")}
    if graph.chunks.n_split:
        want["spmm_gat_fwd_combine_f32"] = n
    if graph.t_chunks.n_split:
        want["spmm_gat_bwd_combine_f32"] = n
    return want


def check_gat_train(data_root, results, smi_line):
    """Phase 3i's ``train()`` run: GAT at full width (``TrainConfig(model=
    "gat", hidden=(256, 256))``, the published heads), float32, FOLDS folds
    in one batch, GAT_EPOCHS epochs: the GAT pair's launches only, and the
    artifact contract."""
    import torch

    from plagnn_tpu_torch.data.artifacts import load_condition
    from plagnn_tpu_torch.train.engine import TrainConfig, train
    from plagnn_tpu_torch.train.kfold import FOLD_SEEDS
    from plagnn_tpu_torch.utils.precision import set_aggregation_dtype

    set_aggregation_dtype("float32")
    bundle = load_condition(data_root, "GSE30931", "normal")
    path = os.path.join(data_root, "log_gat")
    cfg = TrainConfig(model="gat", hidden=(256, 256), fold_num=FOLDS, fold_batch=FOLDS,
                      epoch_num=GAT_EPOCHS, fold_seeds=FOLD_SEEDS[:1])
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    stats = train(bundle.graph, bundle.feats, bundle.labels, bundle.label_with_loc,
                  bundle.loc_mat, cfg, path + os.sep, label_names=bundle.uniprot,
                  device_name="cuda")
    wall = time.perf_counter() - t0
    counts = check_launches("GAT train()", gat_launches(bundle.graph, GAT_EPOCHS))
    record_launches(results, counts)
    check_artifacts("GAT train()", path)
    report_run("GAT train() float32", stats, wall, counts, smi_line)


def weighted_graph(coo_ppi, seed):
    """The graph of a PPI with self-loops and edge values seeded uniform in
    [0.5, 1.5) (1.0 on the self-loops), on the card."""
    import numpy as np

    from plagnn_tpu_torch.ops.graph_format import from_scipy_coo

    val = np.random.default_rng(seed).uniform(0.5, 1.5, coo_ppi.nnz)
    return from_scipy_coo(coo_ppi, add_self_loops=True, edge_val=val).to(DEVICE)


def check_val_sum_kernels(graph, k, label, results):
    """The edge-weighted sum against its plain version at K elements per
    row, forward and transpose: float32 within 1e-5 of the summed weighted
    magnitudes and bit-identical run to run; bfloat16 on small integers with
    the values rounded to eighths (dyadic: every product and partial sum
    exact, one rounding each) equal.  Times each beside the unweighted
    kernel, the plain version and ``torch.sparse.mm`` with the values."""
    import dataclasses

    import torch

    from gpubench.counts import sum_bytes
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    n, e, dev = graph.n_nodes, graph.n_edges, graph.device
    dyadic = dataclasses.replace(graph, val=torch.round(graph.val * 8) / 8,
                                 t_val=torch.round(graph.t_val * 8) / 8)
    gen = torch.Generator(device=dev).manual_seed(8)
    x32 = torch.randn((n, k), generator=gen, device=dev)
    xint = torch.randint(-8, 9, (n, k), generator=gen, device=dev).float()
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for transpose in (False, True):
            direction = "bwd" if transpose else "fwd"
            if dt == torch.float32:
                x, g = x32, graph
                out_k = sk.spmm_sum_rows(g, x, transpose, use_val=True)
                torch.cuda.synchronize()
                if not torch.equal(out_k, sk.spmm_sum_rows(g, x, transpose, use_val=True)):
                    fail(f"{label}: weighted sum {direction} f32 is not deterministic")
                out_p = sk.spmm_sum_plain(g, x, transpose, use_val=True)
                mag = sk.spmm_sum_plain(g, x.abs(), transpose, use_val=True)
                err = (out_k - out_p).abs()
                if bool((err > 1e-5 * mag + 1e-7).any()):
                    fail(f"{label}: weighted sum {direction} f32 differs from plain beyond "
                         f"1e-5 of the summed magnitudes (max abs {err.max().item()})")
            else:
                x, g = xint.to(dt), dyadic
                out_k = sk.spmm_sum_rows(g, x, transpose, use_val=True)
                torch.cuda.synchronize()
                out_p = sk.spmm_sum_plain(g, x, transpose, use_val=True)
                if not torch.equal(out_k, out_p):
                    fail(f"{label}: weighted sum {direction} bf16 differs from plain on "
                         "small integers with dyadic values")
            err_max = (out_k.float() - out_p.float()).abs().max().item()
            print(f"{label}: weighted sum {direction} {tag} K={k} max abs err "
                  f"{err_max:.3e}", flush=True)
            indptr, idx, val = ((graph.t_indptr, graph.t_dst, graph.t_val) if transpose
                                else (graph.indptr, graph.src, graph.val))
            adj = torch.sparse_csr_tensor(indptr, idx, val.to(dt), size=(n, n),
                                          check_invariants=False)
            ms = median_ms(lambda: sk.spmm_sum_rows(graph, x, transpose, use_val=True), 10)
            unweighted = median_ms(lambda: sk.spmm_sum_rows(graph, x, transpose), 10)
            plain = median_ms(lambda: sk.spmm_sum_plain(graph, x, transpose, use_val=True), 3)
            lib = median_ms(lambda: torch.sparse.mm(adj, x), 10)
            esize = x.element_size()
            name = f"spmm_sum_val_{direction}_{tag}"
            # the sum's bytes and the edge values; a multiply and an add per
            # edge element
            r = results[name] = kernel_entry(
                name, "spmm_sum", err_max, ms, plain, lib,
                sum_bytes(bench_shape(graph), k, esize) + 4 * e, 2 * e * k, (n, k))
            print(f"  {name}: {ms:.3f} ms (unweighted {unweighted:.3f}, plain {plain:.3f}, "
                  f"library {lib:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']})",
                  flush=True)
            del adj
    del x32, xint, dyadic
    torch.cuda.empty_cache()


def train_cli(data_root, cmd, agg, epochs, folds=FOLDS, hub_cache="auto"):
    """One training run through the CLI, as a user calls it: one round of
    ``folds`` folds in one batch."""
    from plagnn_tpu_torch import cli

    return cli.main([cmd, "-data", "GSE30931", "--data-root", data_root,
                     "-e", str(epochs), "--rounds", "1", "-f", str(folds),
                     "--fold-batch", str(folds), "--agg-dtype", agg,
                     "--hub-cache", hub_cache])


def reset_launches():
    from plagnn_tpu_torch.bench import dma_ceiling
    from plagnn_tpu_torch.ops import common_neighbors, pcc_scan
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    sk.reset_launches()
    pcc_scan.reset_launches()
    common_neighbors.reset_launches()
    dma_ceiling.reset_launches()


def launch_counts():
    """Every kernel wrapper's launch count, by counter name."""
    from plagnn_tpu_torch.bench import dma_ceiling
    from plagnn_tpu_torch.ops import common_neighbors, pcc_scan
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    return {**sk.LAUNCHES, **pcc_scan.LAUNCHES, **common_neighbors.LAUNCHES,
            **dma_ceiling.LAUNCHES}


def check_launches(label, expected):
    """Every counter equals the run's expected count (0 where the run names
    none); returns the counts."""
    counts = launch_counts()
    for name, c in counts.items():
        want = expected.get(name, 0)
        if c != want:
            fail(f"{label}: {name} launched {c} times, expected {want}")
    return counts


def auto_hub(model, tag):
    """(k_fwd, k_bwd) that hub_cache="auto" resolves to for a full-width
    run of ``model`` with ``tag`` messages (train/engine.py: resolve_hub)."""
    from plagnn_tpu_torch.ops.hub import pick_hub_sizes

    if model == "gcn2":
        return pick_hub_sizes("auto", FOLDS * GCN2_HIDDEN, 4, 0)
    return pick_hub_sizes("auto", FOLDS * F_IN, 4 if tag == "f32" else 2)


def gnn32_launches(tag, epochs, hub=None):
    """A GNN32 run: its dtype's max forward (with argmax) and backward once
    per SAGE-pool layer per epoch, each the hub kernel where the run's hub
    (default: what "auto" resolves to) has that direction."""
    kf, kb = auto_hub("gnn32", tag) if hub is None else hub
    return {f"spmm_max_fwd_{'hub_' if kf else ''}{tag}": LAYERS * epochs,
            f"spmm_max_bwd_{'hub_' if kb else ''}{tag}": LAYERS * epochs}


def note_trace(path, label):
    """Add the trace at ``path`` to TRACE_SESSIONS; print its launches
    without a kernel event, if any."""
    from plagnn_tpu_torch.utils.profiling import kernel_launches

    lost, offsets, warm_lost = kernel_launches(path)
    TRACE_SESSIONS.append((lost, lost + len(offsets), min(offsets, default=0.0), warm_lost))
    if lost:
        print(f"  trace of {label}: {lost} of {lost + len(offsets)} launches have no kernel "
              f"event (the profiler lost them; its device times undercount)", flush=True)


def profiled(fn, label):
    """(fn's result, device_kernel_times of its trace) of one call inside
    utils.profiling.trace, which fails where the call launched kernels and
    its trace holds none."""
    from plagnn_tpu_torch.utils.profiling import TRACE_FILE, trace

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        with trace(log_dir):
            out = fn()
        path = os.path.join(log_dir, TRACE_FILE)
        note_trace(path, label)
        rows = device_kernel_times(path)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    return out, rows


def counter_of(name):
    """The launch counter of a kernels-line entry: an entry at conv2's
    width (CONV2) or at a shard's shape (``@...``) is its counter's kernel."""
    return name.split("@")[0].removesuffix(CONV2)


def record_launches(results, counts, names=None):
    """Each kernel entry takes the launches of the run whose path it is on:
    its counter's, at every width that run aggregates (an entry at conv2's
    width is the same kernel as its counter's); ``names`` limits the
    entries a run sets."""
    for name, r in results.items():
        c = counts.get(counter_of(name), 0)
        if c and (names is None or name in names):
            r["launches"] = c


def check_artifacts(label, d, folds=FOLDS, nodes=NODES, rounds=1):
    """The artifact contract of ``rounds`` rounds of ``folds`` folds, finite
    logits."""
    import numpy as np

    for r in range(1, rounds + 1):
        for f in range(1, folds + 1):
            p = os.path.join(d, f"{r}_{f}_loc_logits.npy")
            if not os.path.exists(p):
                fail(f"{label}: missing {p}")
            lg = np.load(p)
            if lg.shape != (nodes, CLASSES) or not np.isfinite(lg).all():
                fail(f"{label}: {p} has shape {lg.shape} or non-finite values")
    for fname in ("log.tsv", "txt_log.txt",
                  *(f"fig_data_{r}.json" for r in range(1, rounds + 1))):
        if not os.path.exists(os.path.join(d, fname)):
            fail(f"{label}: missing {fname}")


def report_run(label, stats, wall, counts, smi_line, folds=FOLDS):
    import torch

    ep = [m for s in stats for m in s.epoch_ms]
    steady = statistics.median(ep[1:]) if len(ep) > 1 else ep[0]
    print(f"slice {label}: {len(ep)} epochs x {folds} folds, "
          f"epoch ms {[round(m, 3) for m in ep]}, steady {steady:.3f} ms/epoch, "
          f"run wall {wall:.1f} s, launches { {k: c for k, c in counts.items() if c} }, "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"on {smi_line}", flush=True)


def gcn2_launches(hub=None):
    """A GCN2 run: 2 GraphConvs, one sum forward and one transpose each per
    epoch: the scaled sum where the run has no hub (default: "auto"'s), else
    the unscaled sum, the hub kernel in each direction that has one."""
    kf, kb = auto_hub("gcn2", "f32") if hub is None else hub
    if not (kf or kb):
        return {"spmm_sum_gcn_fwd_f32": 2 * EPOCHS_GCN2, "spmm_sum_gcn_bwd_f32": 2 * EPOCHS_GCN2}
    return {f"spmm_sum_fwd_{'hub_' if kf else ''}f32": 2 * EPOCHS_GCN2,
            f"spmm_sum_bwd_{'hub_' if kb else ''}f32": 2 * EPOCHS_GCN2}


def train_gcn2(data_root, path, chunk_callback=None, hub_cache="auto"):
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
                      chunk_callback=chunk_callback, hub_cache=hub_cache)
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
    counts = check_launches("GCN2 train()", gcn2_launches())
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
    # d(i, j) and d(j, i) are the same bits (products commute, t ascending
    # in both), so the function needs d once per unordered pair
    pairs = n * (n - 1) // 2
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
    split_wrapper(results["pcc_diff_count_f64"], "pcc_diff_count_f64", timed[0][1],
                  ("pcc_diff_count_kernel",))
    split_wrapper(results["pcc_diff_hits_f64"], "pcc_diff_hits_f64", timed[1][1],
                  ("pcc_diff_mark_kernel", "pcc_diff_unmark_kernel", "pcc_diff_write_kernel"))
    torch.cuda.empty_cache()


def device_kernel_times(path):
    """(ms, launches, name) of each kernel, copy and memset that the block
    of the trace at ``path`` ran (utils.profiling.block_device_events)."""
    from plagnn_tpu_torch.utils.profiling import block_device_events

    rows = {}
    for name, us in block_device_events(path):
        total, count = rows.get(name, (0.0, 0))
        rows[name] = (total + us, count + 1)
    return [(total / 1e3, count, name) for name, (total, count) in rows.items()]


def profile_call(label, fn):
    """One call inside utils.profiling.trace: its wall time and the device
    time of each kernel it ran (the wrapper's own kernels, its checks and its
    bookkeeping), so a wrapper's time splits into its parts.  Returns (wall
    ms, device busy ms, [(ms, launches, name)])."""
    import torch

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    fn()
    torch.cuda.synchronize()
    wall, rows = profiled(timed, label)
    busy = sum(r[0] for r in rows)
    print(f"  profile of one {label} call: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms", flush=True)
    for ms, cnt, name in sorted(rows, reverse=True)[:8]:
        print(f"    {ms:8.3f} ms x{cnt:<3} {name[:80]}", flush=True)
    return wall, busy, rows


def kernel_ms(rows, *names):
    """Device ms of the profiled kernels whose name holds one of ``names``."""
    return sum(ms for ms, _, name in rows if any(k in name for k in names))


def host_syncs(fn):
    """The host syncs one call of ``fn`` takes: torch's sync debug mode
    warns at each synchronizing operation (a scalar read, a copy to the
    host), and the warnings are counted."""
    import warnings

    import torch

    counts = []
    for _ in range(2):  # the fewer of two calls: a first may pay one-off syncs
        fn()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts.append(sum(1 for w in caught if "synchroniz" in str(w.message).lower()))
    return min(counts)


def split_wrapper(entry, label, fn, kernels):
    """Profiles one call of a kernel's wrapper and counts its host syncs;
    records the kernel's own device time and the syncs in ``entry`` and
    prints them beside the wrapper's CUDA-event time."""
    _, busy, rows = profile_call(label, fn)
    entry["device_ms"] = kernel_ms(rows, *kernels)
    entry["host_syncs"] = host_syncs(fn)
    print(f"  {label}: wrapper {entry['ms']:.3f} ms = kernel {entry['device_ms']:.3f} ms "
          f"({' + '.join(kernels)}) + other device work "
          f"{busy - entry['device_ms']:.3f} ms + host; {entry['host_syncs']} host "
          f"sync(s) a call", flush=True)


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


def json_numbers(obj):
    """Every number in a parsed JSON value."""
    if isinstance(obj, dict):
        return [v for x in obj.values() for v in json_numbers(x)]
    if isinstance(obj, list):
        return [v for x in obj for v in json_numbers(x)]
    return [obj] if isinstance(obj, (int, float)) and not isinstance(obj, bool) else []


def hist_inputs(data_root, name):
    """As ``figures --diff-hist`` sets up one dataset on the card: the
    float64 factors, the reference's edges and PPI_normal's entries > 0."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from plagnn_tpu_torch.analysis.figures import default_bins, positive_csr
    from plagnn_tpu_torch.data.expression import pcc_factors

    gm = os.path.join(data_root, "generate_materials")
    d = os.path.join(gm, f"{name}_data")
    z_i, z_n = (torch.as_tensor(pcc_factors(np.load(os.path.join(d, f))), device=DEVICE)
                for f in ("expr_inter.npy", "expr_normal.npy"))
    ppi = sp.load_npz(os.path.join(gm, "PPI_normal.npz"))
    edges = torch.as_tensor(default_bins(), device=DEVICE)
    return z_i, z_n, edges, positive_csr(ppi, DEVICE)


def check_hist(data_root, name):
    """One dataset's diff_hist.json against the plain version on the card,
    bin for bin, and the counts' sums against N² - N and the PPI's
    off-diagonal entries, less the pairs outside the edges."""
    import torch

    from plagnn_tpu_torch.data.expression import pcc_at_edges_torch
    from plagnn_tpu_torch.ops import pcc_scan

    z_i, z_n, edges, csr = hist_inputs(data_root, name)
    n = z_i.shape[0]
    with open(os.path.join(data_root, "generate_materials", f"{name}_data",
                           "diff_hist.json")) as f:
        hist = json.load(f)
    p_linked, p_unlinked = pcc_scan.pcc_diff_histogram_plain(z_i, z_n, edges, csr)
    if not (hist["linked"] == p_linked.tolist() and hist["unlinked"] == p_unlinked.tolist()):
        fail(f"{name}: the histogram kernel's counts differ from the plain version's")
    e_lo, e_hi = float(edges[0]), float(edges[-1])
    below, above = pcc_scan.pcc_diff_counts(z_i, z_n, e_lo, e_hi)  # d(i, i) = 0 is inside
    indptr, indices = csr
    rows = torch.repeat_interleave(torch.arange(n, device=DEVICE), indptr[1:] - indptr[:-1])
    off = rows != indices.long()
    d = (pcc_at_edges_torch(z_i, rows[off], indices[off].long())
         - pcc_at_edges_torch(z_n, rows[off], indices[off].long()))
    links_inside = int(((d >= e_lo) & (d <= e_hi)).sum())
    total = sum(hist["linked"]) + sum(hist["unlinked"])
    if total != n * n - n - below - above or sum(hist["linked"]) != links_inside:
        fail(f"{name}: histogram sums {sum(hist['linked'])} + {sum(hist['unlinked'])}, "
             f"expected {links_inside} linked of {n * n - n - below - above}")
    print(f"{name}: ΔPCC histogram kernel = plain bin for bin; {sum(hist['linked'])} "
          f"linked + {sum(hist['unlinked'])} unlinked = N² - N - {below + above} outside "
          f"the edges; {int(off.sum())} off-diagonal links, {links_inside} inside", flush=True)


def check_save_diff(smi_line):
    """``figures --save-diff`` on a synth bundle of SAVE_DIFF_NODES
    proteins with a perturbed expr_inter.npy: the arrays' lengths and
    hist_data.json's sums."""
    import numpy as np
    import scipy.sparse as sp

    from plagnn_tpu_torch import cli

    root = tempfile.mkdtemp(prefix="chip_smoke_diff_")
    try:
        n = SAVE_DIFF_NODES
        cli.main(["synth", "--data-root", root, "--nodes", str(n),
                  "--edges", str(EDGES * n // NODES), "--seed", str(SEED)])
        gm = os.path.join(root, "generate_materials")
        rng = np.random.default_rng(SEED)
        for name, _ in ANALYSIS_DATASETS:
            d = os.path.join(gm, f"{name}_data")
            expr_n = np.load(os.path.join(d, "expr_normal.npy"))
            np.save(os.path.join(d, "expr_inter.npy"),
                    expr_n * np.exp(PERTURB_SIGMA * rng.standard_normal(expr_n.shape)))
        t0 = time.perf_counter()
        cli.main(["figures", "--data-root", root, "--save-diff"])
        wall = time.perf_counter() - t0
        ppi = sp.load_npz(os.path.join(gm, "PPI_normal.npz")).tocsr()
        ppi.sum_duplicates()
        links = int((ppi.data > 0).sum())
        for name, _ in ANALYSIS_DATASETS:
            d = os.path.join(gm, f"{name}_data")
            sizes = {f: np.load(os.path.join(d, f"diff{f}.npy"), mmap_mode="r").shape[0]
                     for f in ("", "_link", "_unlink")}
            if sizes != {"": n * n, "_link": links, "_unlink": n * n - links}:
                fail(f"save-diff {name}: lengths {sizes}, expected N² {n * n}, "
                     f"{links} links and the rest")
            with open(os.path.join(d, "hist_data.json")) as f:
                hist = json.load(f)
            sums = {flag: sum(c for _, c in hist[flag][1]) for flag in ("all", "link", "unlink")}
            if sums != {"all": sizes[""], "link": sizes["_link"], "unlink": sizes["_unlink"]}:
                fail(f"save-diff {name}: hist_data.json sums {sums}, arrays {sizes}")
        print(f"figures --save-diff at N = {n} ({smi_line}): {wall:.3f} s for 3 datasets; "
              f"diff.npy {n * n}, diff_link.npy {links}, diff_unlink.npy {n * n - links} "
              f"values each, hist_data.json sums equal", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def time_hist_kernel(data_root, results, smi_line):
    """The histogram kernel on GSE30931's inputs at full width: CUDA events
    (median of 10), its plain version (median of 3) and the blocked yardstick
    (torch.matmul of both products per 2,048-row block, bucketize against the
    edges, the CSR mask, bincount; median of 3), never on the path."""
    import torch

    from plagnn_tpu_torch.ops import pcc_scan

    z_i, z_n, edges, csr = hist_inputs(data_root, ANALYSIS_DATASETS[0][0])
    n, k = z_i.shape
    nb = edges.numel() - 1
    indptr, indices = csr
    ptr = indptr.cpu().numpy()

    def lib_hist():
        counts = torch.zeros(2 * nb, dtype=torch.int64, device=DEVICE)
        for r0 in range(0, n, LIB_BLOCK_ROWS):
            r1 = min(r0 + LIB_BLOCK_ROWS, n)
            d = z_i[r0:r1] @ z_i.T - z_n[r0:r1] @ z_n.T
            counts += pcc_scan._bin_block(d, edges, indptr, indices, ptr, r0, r1)
        return counts

    kern = lambda: pcc_scan.pcc_diff_histogram(z_i, z_n, edges, csr)  # noqa: E731
    ms = median_ms(kern, 10)
    plain_ms = median_ms(lambda: pcc_scan.pcc_diff_histogram_plain(z_i, z_n, edges, csr), 3)
    lib_ms = median_ms(lib_hist, 3)
    # z read once, the edges, the CSR, the counts written; per unordered pair
    # (d(i, j) and d(j, i) are the same bits, and so is their bin) d (4k - 1
    # float64 operations), the range (2 compares) and the bin's two edges
    nbytes = 2 * n * k * 8 + 8 * (nb + 1) + 8 * (n + 1) + 4 * indices.numel() + 16 * nb
    r = results["pcc_diff_hist_f64"] = kernel_entry(
        "pcc_diff_hist_f64", "pcc_diff_scan", 0.0, ms, plain_ms, lib_ms, nbytes,
        n * (n - 1) // 2 * (4 * k + 3), (n, k), FP64_OPS_PER_S)
    print(f"  pcc_diff_hist_f64 ({smi_line}): {ms:.3f} ms (plain {plain_ms:.3f}, blocked "
          f"DGEMM + bucketize + bincount {lib_ms:.3f}, bound {r['bound_ms']:.3f} by "
          f"{r['bound_by']}) at N = {n}, k = {k}, {nb} bins", flush=True)
    split_wrapper(r, "pcc_diff_hist_f64", kern,
                  ("pcc_diff_adjacency_kernel", "pcc_diff_hist_kernel"))
    torch.cuda.empty_cache()


def figures_phase(data_root, results, smi_line):
    """Phase 4f: ``figures --diff-hist --alpha-dist`` through the CLI with
    every launch counter at 0 before and read after, then the checks, the
    --save-diff run at SAVE_DIFF_NODES and the kernel's timings."""
    from plagnn_tpu_torch import cli

    reset_launches()
    t0 = time.perf_counter()
    written = cli.main(["figures", "--data-root", data_root, "--diff-hist", "--alpha-dist",
                        "-d", DEVICE])
    wall = time.perf_counter() - t0
    counts = check_launches("figures", {"pcc_diff_hist_f64": len(ANALYSIS_DATASETS)})
    print(f"wall: figures --diff-hist --alpha-dist {wall:.3f} s ({smi_line}), "
          f"{len(written)} JSON files", flush=True)
    want = {"diff_hist.json": len(ANALYSIS_DATASETS), "alpha_dist.json": 2,
            "AIM.json": 2, "COV.json": 2, "mlACC.json": 2}
    got = {f: sum(1 for p in written if os.path.basename(p) == f) for f in want}
    if got != want:
        fail(f"figures wrote {got}, expected {want}")
    for path in written:
        with open(path) as f:
            numbers = json_numbers(json.load(f))
        if not numbers or not all(math.isfinite(v) for v in numbers):
            fail(f"figures: {path} holds no numbers or non-finite ones")
    for name, _ in ANALYSIS_DATASETS:
        check_hist(data_root, name)
    check_save_diff(smi_line)
    time_hist_kernel(data_root, results, smi_line)
    record_launches(results, counts, ("pcc_diff_hist_f64",))


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
    events (median of 10; the wrapper's checks and slice tables included),
    the plain version (median of 3, of 1 on PPI_inter), the bound (the CSR
    and the queries read once, the counts written once; one int32 bit test
    per element of each pair's shorter row) and cuSPARSE's A·A
    (``torch.sparse.mm`` on the CSR, float32 ones, median of 3 on the
    normal graph and of 1 on PPI_inter; a yardstick never on the path)."""
    import torch

    from plagnn_tpu_torch.ops import common_neighbors as cn

    for g, (name, csr, rows, cols, _, _) in enumerate(graphs[:2]):
        indptr, indices = csr
        n, nnz, q = indptr.numel() - 1, indices.numel(), rows.numel()
        deg = indptr[1:] - indptr[:-1]
        d_r, d_c = deg[rows.long()], deg[cols.long()]
        lookups = int(torch.minimum(d_r, d_c).sum())
        slices = int(cn._slices(cn.longer_rows(indptr, rows, cols), n, cn.SLICE_QUERIES)[2][-1])
        ms = median_ms(lambda: cn.common_neighbors(csr, rows, cols), 10)
        plain_ms = median_ms(lambda: cn.common_neighbors_plain(csr, rows, cols),
                             3 if g == 0 else 1)
        adj = torch.sparse_csr_tensor(indptr, indices.long(),
                                      torch.ones(nnz, device=DEVICE), size=(n, n))
        lib_ms, lib_note = None, ""
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        try:
            # a yardstick only: where cuSPARSE cannot run A·A, its error and
            # the memory asked for are the finding
            lib_ms = median_ms(lambda: torch.sparse.mm(adj, adj), 3 if g == 0 else 1)
            lib_note = f", A·A nnz {torch.sparse.mm(adj, adj)._nnz()}"
        except (torch.cuda.OutOfMemoryError, RuntimeError) as err:
            free, total = torch.cuda.mem_get_info()
            lib_note = (f", A·A failed: {str(err).splitlines()[0][:300]} (peak "
                        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB "
                        f"allocated for it; {free / 2**30:.1f} of {total / 2**30:.1f} GiB "
                        f"free after)")
        del adj
        torch.cuda.empty_cache()
        nbytes = 8 * (n + 1) + 4 * nnz + 8 * q + 4 * q
        entry = kernel_entry("ecc_common_neighbors_i32", "common_neighbors", 0.0, ms,
                             plain_ms, lib_ms, nbytes, lookups, (n, q), INT32_OPS_PER_S)
        if g == 0:
            results["ecc_common_neighbors_i32"] = entry
        split_wrapper(entry, f"ECC counts on {name}",
                      lambda: cn.common_neighbors(csr, rows, cols), ("common_neighbors_kernel",))
        print(f"  ECC counts on {name} ({smi_line}): {ms:.3f} ms (plain {plain_ms:.3f}, "
              f"A·A {'not measured' if lib_ms is None else f'{lib_ms:.3f}'}, bound "
              f"{entry['bound_ms']:.4f} by {entry['bound_by']}) at N = {n}, {q} pairs, "
              f"max degree {int(deg.max())}, sum min(deg) {lookups} bit tests, "
              f"{slices} slices of <= {cn.SLICE_QUERIES} queries{lib_note}", flush=True)


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


def relu_features(n_pad, k, seed):
    """(n_pad, k) float32 on the card: relu of bf16-representable normals
    (ties at 0, identical in f32 and bf16)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((n_pad, k), generator=gen, device=DEVICE)
    return x.to(torch.bfloat16).float().relu_()


def time_orders(label, coo_ppi, smi_line):
    """The max forward (with the argmax, K = 10 x 503) and the sum (K = 10
    x 400) on one topology under the identity, RCM and greedy orders: each
    order's graph is built from the relabelled edges, features go in as
    x[perm] and outputs come back as out[inv_perm], which must equal the
    identity order's (the sum on small integers, exact in any order)."""
    import numpy as np
    import torch

    from plagnn_tpu_torch.ops import reorder
    from plagnn_tpu_torch.ops import spmm_kernels as sk
    from plagnn_tpu_torch.ops.graph_format import build_graph

    src, dst = coo_ppi.row.astype(np.int64), coo_ppi.col.astype(np.int64)
    t0 = time.perf_counter()
    rcm = reorder.rcm_order(src, dst, NODES)
    t1 = time.perf_counter()
    greedy = reorder.greedy_coalesce_order(src, dst, NODES)
    t2 = time.perf_counter()
    orders = (("identity", np.arange(NODES, dtype=np.int64), 0.0),
              ("rcm", rcm, t1 - t0), ("greedy", greedy, t2 - t1))
    base = build_graph(src, dst, NODES, add_self_loops=True)
    x_max = relu_features(base.n_nodes, FOLDS * F_IN, 21)
    gen = torch.Generator(device=DEVICE).manual_seed(22)
    x_sum = torch.randint(-8, 9, (base.n_nodes, FOLDS * GCN2_HIDDEN), generator=gen,
                          device=DEVICE).float()
    want = None
    for name, perm, host_s in orders:
        s, d = reorder.relabel_edges(src, dst, perm)
        g = build_graph(s, d, NODES, add_self_loops=True).to(DEVICE)
        p = torch.as_tensor(perm, device=DEVICE)
        inv = torch.empty_like(p)
        inv[p] = torch.arange(NODES, device=DEVICE)
        xm, xs = torch.zeros_like(x_max), torch.zeros_like(x_sum)
        xm[:NODES], xs[:NODES] = x_max[p], x_sum[p]
        got = (sk.spmm_max_fwd(g, xm)[0][inv], sk.spmm_sum_rows(g, xs)[inv])
        torch.cuda.synchronize()
        if want is None:
            want = got
        elif not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"{label} {name} order: the restored outputs differ from the identity's")
        max_ms = median_ms(lambda: sk.spmm_max_fwd(g, xm), 10)
        sum_ms = median_ms(lambda: sk.spmm_sum_rows(g, xs), 10)
        print(f"  order {label} {name} ({smi_line}): max forward f32 K={FOLDS * F_IN} "
              f"{max_ms:.3f} ms, sum f32 K={FOLDS * GCN2_HIDDEN} {sum_ms:.3f} ms, host "
              f"order {host_s:.3f} s; outputs restored = identity's", flush=True)
        del g, xm, xs
    t0 = time.perf_counter()
    report = reorder.coalesce_report(src, dst, NODES)
    print(f"  coalesce_report {label} ({time.perf_counter() - t0:.3f} s): "
          + json.dumps(report), flush=True)
    del x_max, x_sum
    torch.cuda.empty_cache()


def other_ops_phase(results, smi_line):
    """Phase 4o: the sampled graphs' max forward and backward (the first
    inside utils.profiling.trace) and the weighted sum's forward and
    backward through autograd, with every launch counter at 0 before and
    read after; then the checks and the reorder timings."""
    import numpy as np
    import torch

    from plagnn_tpu_torch.data.synthetic import clustered_ppi, powerlaw_ppi
    from plagnn_tpu_torch.ops.graph_format import build_graph
    from plagnn_tpu_torch.ops.sampling import sample_neighbors, sampled_graph
    from plagnn_tpu_torch.ops.spmm import spmm_max, spmm_sum
    from plagnn_tpu_torch.utils.profiling import (TRACE_FILE, TRACE_MARGIN_S,
                                                  WARMUP_LAUNCHES, trace)

    ppi = powerlaw_ppi(NODES, EDGES, SEED)
    src, dst = ppi.row.astype(np.int64), ppi.col.astype(np.int64)
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        reset_launches()
        graphs = {}
        for fanout in FANOUTS:
            t0 = time.perf_counter()
            g = sampled_graph(src, dst, NODES, fanout, seed=SEED).to(DEVICE)
            host_s = time.perf_counter() - t0
            x = relu_features(g.n_nodes, FOLDS * F_IN, fanout).requires_grad_()
            if fanout == FANOUTS[0]:
                with trace(trace_dir) as prof:
                    out = spmm_max(g, x)
                    torch.cuda.synchronize()
                table = [ev.key for ev in prof.key_averages() if "spmm" in ev.key]
            else:
                out = spmm_max(g, x)
            out.backward(torch.ones_like(out))
            torch.cuda.synchronize()
            graphs[fanout] = g
            print(f"sampled graph fanout {fanout}: {g.n_edges} edges (with self-loops), "
                  f"max in-degree {int(g.in_degree.max())}, sampled and built in "
                  f"{host_s:.3f} s", flush=True)
        s, d = sample_neighbors(src, dst, NODES, FANOUTS[0], seed=SEED)
        val = np.random.default_rng(SEED).uniform(0.5, 1.5, len(s))
        wg = build_graph(s, d, NODES, add_self_loops=True, edge_val=val).to(DEVICE)
        for dt in (torch.float32, torch.bfloat16):
            x = relu_features(wg.n_nodes, FOLDS * GCN2_HIDDEN, 3).to(dt).requires_grad_()
            out = spmm_sum(wg, x, use_val=True)
            out.backward(torch.ones_like(out))
        torch.cuda.synchronize()
        n_max = len(FANOUTS)
        counts = check_launches("other ops", {
            "spmm_max_fwd_f32": n_max, "spmm_max_bwd_f32": n_max,
            "spmm_sum_val_fwd_f32": 1, "spmm_sum_val_bwd_f32": 1,
            "spmm_sum_val_fwd_bf16": 1, "spmm_sum_val_bwd_bf16": 1})
        record_launches(results, counts, [n for n in counts if n.startswith("spmm_sum_val_")])
        with open(os.path.join(trace_dir, TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
        kernels = [str(ev.get("name")) for ev in events if ev.get("cat") == "kernel"]
        if not any("spmm_max_fwd" in k for k in kernels):
            cats = {}
            for ev in events:
                cats[ev.get("cat")] = cats.get(ev.get("cat"), 0) + 1
            fail(f"the trace of the sampled-graph forward names no max-forward kernel: "
                 f"{len(events)} events by category {cats}, kernels {kernels[:5]}; "
                 f"the profiler's own table: {table[:5]}")
        note_trace(os.path.join(trace_dir, TRACE_FILE), "the sampled-graph forward")
        early = [-s[2] for s in TRACE_SESSIONS if s[2] < 0]
        print(f"trace: {TRACE_FILE} names the max-forward kernel "
              f"({[k[:60] for k in kernels if 'spmm_max_fwd' in k]}); {len(TRACE_SESSIONS)} "
              f"traced sessions, {sum(1 for s in TRACE_SESSIONS if s[0])} of them with "
              f"{sum(s[0] for s in TRACE_SESSIONS)} of {sum(s[1] for s in TRACE_SESSIONS)} "
              f"block launches without a kernel event; the warm-ups lost "
              f"{[s[3] for s in TRACE_SESSIONS]} of {WARMUP_LAUNCHES} launches; "
              f"{len(early)} hold a kernel whose start precedes its launch, by up to "
              f"{max(early, default=0.0) / 1e3:.3f} ms (margin {TRACE_MARGIN_S * 1e3:.0f} ms)",
              flush=True)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    for fanout, g in graphs.items():
        check_kernels(g, relu_features(g.n_nodes, FOLDS * F_IN, 30 + fanout),
                      f"sampled graph fanout {fanout}")
    del graphs, wg
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    clustered = clustered_ppi(NODES, EDGES, SEED)
    print(f"clustered_ppi({NODES}, {EDGES}, seed {SEED}): {clustered.nnz} entries, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for label, coo in (("powerlaw", ppi), ("clustered", clustered)):
        time_orders(label, coo, smi_line)


# ---------------------------------------------------------------------------
# Phase 4m: the multi-device path on the one card.
# ---------------------------------------------------------------------------


def shard_ks(p):
    """K of phase 4m (a) at P = p graph ranks: the full fold batch's width
    at each layer, and every width the sharded runs at P aggregate."""
    ks = {FOLDS // f * w for f, g in MESH_RUNS if g == p for w in AGG_WIDTHS}
    return sorted(ks | {FOLDS * w for w in AGG_WIDTHS}, reverse=True)


def shard_work(graph, own_rows, k, esize, asize):
    """(forward bytes, backward bytes, forward operations, backward
    operations) a shard pass must do at width K: the distinct source rows it
    reads (the forward's x, the backward's dx) and the own rows whose output
    the sharded layer keeps (out and arg, g and arg), each once, and the
    index; a compare a gathered element, and the backward's one more a
    non-empty row's element."""
    import torch

    e, c = graph.n_edges, own_rows
    n_src = int(torch.unique(graph.src).numel())
    nonempty = int((graph.in_degree > 0).sum().item())
    return (n_src * k * esize + 4 * (c + 1 + e) + c * k * (esize + asize),
            c * k * (esize + asize) + 4 * (n_src + 1 + e) + n_src * k * esize,
            e * k, e * k + nonempty * k)


def shard_max_entries(graph, own_rows, x32, label):
    """spmm_max(empty_value=-inf) on one shard graph at one K, both dtypes:
    forward (out, arg) and backward exactly equal to the plain versions
    (small-integer gradients keep every float32 sum exact, so the single
    rounding to bf16 agrees too), then timed (CUDA events, median of 10;
    plain and library median of 3).  The bytes a pass must move: the
    distinct source rows it reads (the forward's x, the backward's dx) and
    the own rows whose output the sharded layer keeps (out and arg, g and
    arg), each once, and the index.  Returns {(kind, tag): row}."""
    import torch

    from plagnn_tpu_torch.ops import spmm_kernels as sk

    ninf = -math.inf
    n, k = x32.shape
    e = graph.n_edges
    src_l, dst_l = graph.src.long(), graph.dst.long()
    empty = graph.in_degree == 0
    gen = torch.Generator(device="cuda").manual_seed(k + e)
    rows = {}
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = x32.to(dt)
        out_k, arg_k = sk.spmm_max_fwd(graph, x, empty_value=ninf)
        out_2, arg_2 = sk.spmm_max_fwd(graph, x, empty_value=ninf)
        out_p, arg_p = sk.spmm_max_fwd_plain(graph, x, empty_value=ninf)
        torch.cuda.synchronize()
        if not (torch.equal(out_k, out_p) and torch.equal(arg_k, arg_p)):
            fail(f"{label} {tag}: empty_value=-inf forward differs from plain")
        if not (torch.equal(out_k, out_2) and torch.equal(arg_k, arg_2)):
            fail(f"{label} {tag}: empty_value=-inf forward not identical run to run")
        if not (bool(torch.isneginf(out_k[empty].float()).all())
                and bool((arg_k[empty] == -1).all())):
            fail(f"{label} {tag}: an empty row is not -inf with argmax -1")
        g = torch.randint(-8, 9, (n, k), generator=gen, device="cuda").to(dt)
        dx_k = sk.spmm_max_bwd(graph, g, arg_k)
        dx_p = sk.spmm_max_bwd_plain(graph, g, arg_k)
        torch.cuda.synchronize()
        if not torch.equal(dx_k, dx_p):
            fail(f"{label} {tag}: backward differs from plain "
                 f"(max abs {(dx_k.float() - dx_p.float()).abs().max().item()})")
        esize, asize = x.element_size(), arg_k.element_size()
        fwd_ms = median_ms(lambda: sk.spmm_max_fwd(graph, x, empty_value=ninf), 10)
        fwd_plain = median_ms(lambda: sk.spmm_max_fwd_plain(graph, x, empty_value=ninf), 3)
        gathered = x[src_l]
        sidx = dst_l[:, None].expand(-1, k)
        lib_out = torch.full_like(x, ninf)
        fwd_lib = median_ms(lambda: lib_out.scatter_reduce_(0, sidx, gathered, "amax",
                                                            include_self=False), 3)
        del gathered, lib_out, sidx
        bwd_ms = median_ms(lambda: sk.spmm_max_bwd(graph, g, arg_k), 10)
        bwd_plain = median_ms(lambda: sk.spmm_max_bwd_plain(graph, g, arg_k), 3)
        masked = torch.where(arg_k[dst_l].long() == src_l[:, None], g[dst_l].float(), 0.0)
        lib_dx = torch.zeros((n, k), device="cuda")
        bwd_lib = median_ms(lambda: lib_dx.index_add_(0, src_l, masked), 3)
        del masked, lib_dx
        fwd_bytes, bwd_bytes, fwd_ops, bwd_ops = shard_work(graph, own_rows, k, esize, asize)
        rows[("fwd", tag)] = dict(err=0.0, ms=fwd_ms, plain=fwd_plain, lib=fwd_lib,
                                  nbytes=fwd_bytes, ops=fwd_ops)
        rows[("bwd", tag)] = dict(err=0.0, ms=bwd_ms, plain=bwd_plain, lib=bwd_lib,
                                  nbytes=bwd_bytes, ops=bwd_ops)
        del x, out_k, arg_k, out_2, arg_2, out_p, arg_p, g, dx_k, dx_p
        torch.cuda.empty_cache()
    return rows


def shard_kernel_phase(results, smi_line):
    """Phase 4m (a): the full graph partitioned at P = 2 and 4 (balanced);
    every shard's interior and boundary graph through the -inf max forward
    and its backward at shard_ks(P), f32 and bf16 (shard_max_entries).
    The kernels line takes, per (P, part, K, dtype, direction), the slowest
    rank's times (an SPMD step waits for it); phase 4m (b) fills in the
    launches of the shapes its runs took."""
    import numpy as np
    import torch

    from plagnn_tpu_torch.data.synthetic import powerlaw_ppi
    from plagnn_tpu_torch.parallel.partition import partition_graph

    ppi = powerlaw_ppi(NODES, EDGES, SEED)
    rng = np.random.default_rng(SEED)
    for p in SHARD_PARTS:
        pg = partition_graph(ppi.row, ppi.col, NODES, p, add_self_loops=True, balance=True)
        recv = [int((pg.send_idx[:, r] >= 0).sum()) for r in range(p)]
        print(f"partition P={p} (balanced): own rows C {pg.own_rows}, halo slots per "
              f"peer S {pg.halo_per_peer}, gather space {pg.n_local} rows, halo rows "
              f"received per rank {recv}, layer-1 halo buffer per exchange "
              f"{p * pg.halo_per_peer * FOLDS * F_IN * 4 / 1e6:.1f} MB f32 per rank",
              flush=True)
        slowest = {}
        ks = shard_ks(p)
        for r in range(p):
            shard = pg.shard(r, "cuda")
            for part in ("interior", "boundary"):
                graph = getattr(shard, part)
                base = rng.standard_normal((graph.n_nodes, max(ks)), dtype=np.float32)
                base = torch.from_numpy(base).cuda().to(torch.bfloat16).float().relu_()
                for k in ks:
                    label = f"P={p} rank {r} {part} (E {graph.n_edges}) K {k}"
                    rows = shard_max_entries(graph, pg.own_rows, base[:, :k].contiguous(),
                                             label)
                    for (kind, tag), row in rows.items():
                        key = (kind, tag, part, k)
                        if key not in slowest or row["ms"] > slowest[key][0]["ms"]:
                            slowest[key] = (row, graph.n_nodes, r)
                    print(f"  {label}: " + ", ".join(
                        f"{kind} {tag} {row['ms']:.3f} ms (bound "
                        f"{row['nbytes'] / HBM_BYTES_PER_S * 1e3:.3f})"
                        for (kind, tag), row in rows.items()), flush=True)
                del base
            del shard
            torch.cuda.empty_cache()
        for (kind, tag, part, k), (row, n, r) in sorted(slowest.items()):
            counter = f"spmm_max_fwd_empty_{tag}" if kind == "fwd" else f"spmm_max_bwd_{tag}"
            name = f"{counter}@p{p}_{part}_k{k}"
            source = "spmm_max_fwd" if kind == "fwd" else "spmm_max_bwd"
            results[name] = kernel_entry(name, source, row["err"], row["ms"], row["plain"],
                                         row["lib"], row["nbytes"], row["ops"], (n, k))
            results[name]["rank"] = r
    print(f"shard kernels: every interior and boundary graph at P = {SHARD_PARTS}, K = "
          f"{ {p: shard_ks(p) for p in SHARD_PARTS} }, f32 and bf16: forward and backward "
          f"equal to their plain versions ({smi_line})", flush=True)


def mesh_train_worker(rank, device, data_root, out, fold, graph, result_dir):
    """One rank of a phase-4m run: train() at full width over the mesh, then
    the halo exchange timed alone at each layer's width; writes its launch
    counts, epoch times and exchange figures to result_dir."""
    import torch
    import torch.distributed as dist

    from plagnn_tpu_torch.data.artifacts import load_condition, load_label_names
    from plagnn_tpu_torch.ops import spmm_kernels as sk
    from plagnn_tpu_torch.parallel.partition import partition_graph
    from plagnn_tpu_torch.parallel.sharded import halo_exchange, make_mesh
    from plagnn_tpu_torch.train.engine import TrainConfig, train
    from plagnn_tpu_torch.train.kfold import FOLD_SEEDS

    bundle = load_condition(data_root, "GSE30931", "normal")
    cfg = TrainConfig(fold_num=FOLDS, fold_batch=FOLDS, epoch_num=MESH_EPOCHS,
                      fold_seeds=FOLD_SEEDS[:1], mesh_fold=fold, mesh_graph=graph,
                      verbose=False)
    sk.reset_launches()
    t0 = time.perf_counter()
    stats = train(bundle.graph, bundle.feats, bundle.labels, bundle.label_with_loc,
                  bundle.loc_mat, cfg, out + os.sep,
                  label_names=load_label_names(data_root) or bundle.uniprot,
                  device_name=str(device))
    wall = time.perf_counter() - t0
    counts = dict(sk.LAUNCHES)
    mesh = make_mesh(graph, fold)
    g = bundle.graph
    pg = partition_graph(g.src.numpy(), g.dst.numpy(), g.n_real_nodes, graph, balance=True)
    # the launches by shape: the pass of this rank's shard with that many edges
    part_of = {len(pg.interior_edges[mesh.graph_index][0]): "interior",
               len(pg.boundary_edges[mesh.graph_index][0]): "boundary"}
    shape_counts = {}
    for (name, _, n_edges, k), c in sk.LAUNCH_SHAPES.items():
        key = f"{name}@{part_of.get(n_edges, f'unknown graph of {n_edges} edges')}_k{k}"
        shape_counts[key] = shape_counts.get(key, 0) + c
    # the exchange alone, synchronous, at each layer's width (B/F folds)
    send = torch.from_numpy(pg.send_idx[mesh.graph_index]).to(device)
    exch = []
    for width in AGG_WIDTHS:
        k = FOLDS // fold * width
        x = torch.rand((pg.own_rows, k), device=device)
        times = []
        for _ in range(4):
            dist.barrier(group=mesh.graph_group)
            torch.cuda.synchronize()
            a = time.perf_counter()
            halo_exchange(x, send, mesh.graph_group)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - a) * 1e3)
        exch.append({"k": k, "buffer_bytes": graph * pg.halo_per_peer * k * 4,
                     "ms": statistics.median(times[1:])})
    recv_rows = int((pg.send_idx[:, mesh.graph_index] >= 0).sum())
    with open(os.path.join(result_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"counts": counts, "shape_counts": shape_counts, "epoch_ms": [m for st in stats for m in st.epoch_ms],
                   "wall_s": wall, "exchange": exch, "halo_rows_received": recv_rows,
                   "own_rows": pg.own_rows, "halo_per_peer": pg.halo_per_peer,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}, f)


def compare_mesh_artifacts(label, got_dir, want_dir):
    """A sharded run's artifacts against the single-card run of the same
    jobs: logits and every loss within MESH_ATOL (relative for losses
    above 1); threshold metrics within
    2 flipped predictions of their row count (+1e-5, tests/test_torch_train.py
    's allowance); AUC within 1e-4 per row of 1e-4 and pred_num within 3 per
    class; log.tsv the same rows.  Returns the largest differences."""
    import numpy as np

    worst = {"logits": 0.0, "loss": 0.0, "metric": 0.0, "tsv_flips": 0}
    for f in range(1, FOLDS + 1):
        a = np.load(os.path.join(want_dir, f"1_{f}_loc_logits.npy"))
        b = np.load(os.path.join(got_dir, f"1_{f}_loc_logits.npy"))
        worst["logits"] = max(worst["logits"], float(np.abs(a - b).max()))
    with open(os.path.join(want_dir, "fig_data_1.json")) as fh:
        fa = json.load(fh)
    with open(os.path.join(got_dir, "fig_data_1.json")) as fh:
        fb = json.load(fh)
    tsv = [open(os.path.join(d, "log.tsv")).read().splitlines() for d in (want_dir, got_dir)]
    rows = {"train": {}, "validation": {}}
    for line in tsv[0][1:]:
        cols = line.split("\t")
        split = "train" if cols[2] == "0" else "validation"
        rows[split][cols[1]] = rows[split].get(cols[1], 0) + 1
    for split, by_alpha in fa.items():
        for alpha, folds in by_alpha.items():
            for fold, curves in folds.items():
                for key, v in curves.items():
                    v = np.asarray(v, float)
                    got = np.asarray(fb[split][alpha][fold][key], float)
                    d = float(np.abs(got - v).max())
                    if key == "loss":
                        worst["loss"] = max(worst["loss"], d)
                        if d > MESH_ATOL * max(1.0, float(np.abs(v).max())):
                            fail(f"{label}: {split} fold {fold} loss differs by {d}")
                    elif key == "pred_num_final":
                        if d > 3:
                            fail(f"{label}: fold {fold} pred_num differs by {d}")
                    else:
                        worst["metric"] = max(worst["metric"], d)
                        if d > 2.0 / rows[split][fold] + 1e-5:
                            fail(f"{label}: {split} fold {fold} {key} differs by {d}")
    if worst["logits"] > MESH_ATOL:
        fail(f"{label}: logits differ from the single-card run by {worst['logits']}")
    if len(tsv[0]) != len(tsv[1]) or any(
            a.split("\t")[:5] != b.split("\t")[:5] for a, b in zip(*tsv)):
        fail(f"{label}: log.tsv rows differ from the single-card run's")
    worst["tsv_flips"] = sum(a != b for a, b in zip(*tsv))
    return worst


def mesh_train_phase(data_root, want_dir, results, smi_line):
    """Phase 4m (b): ranks sharing the one card through gloo, train() at
    full width at each of MESH_RUNS, against the single-card run of the
    same jobs (phase 4's train-normal float32, the CLI's defaults)."""
    from plagnn_tpu_torch.ops import _build
    from plagnn_tpu_torch.parallel.launch import spawn_local

    _build.build_all()     # the ranks load the libraries; none builds
    print("phase 4m ranks: gloo process groups whose ranks all share cuda:0 (one "
          "card); a correctness run through host-staged gloo, not a scaling figure",
          flush=True)
    shard_launches = {}
    for fold, graph in MESH_RUNS:
        n = fold * graph
        tag = f"fold={fold},graph={graph}"
        out = os.path.join(data_root, f"log_mesh_f{fold}g{graph}")
        res_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
        reset_launches()
        t0 = time.perf_counter()
        spawn_local(mesh_train_worker, n, backend="gloo", devices=["cuda:0"] * n,
                    rdzv_dir=res_dir, args=(data_root, out, fold, graph, res_dir),
                    timeout_s=MESH_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if any(launch_counts().values()):
            fail(f"mesh {tag}: the parent launched kernels during the sharded run")
        ranks = []
        for r in range(n):
            with open(os.path.join(res_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        shutil.rmtree(res_dir, ignore_errors=True)
        counts = {}
        for rr in ranks:
            for k, c in rr["counts"].items():
                counts[k] = counts.get(k, 0) + c
        per_rank = 2 * LAYERS * MESH_EPOCHS      # interior + boundary, each layer
        expected = {"spmm_max_fwd_empty_f32": n * per_rank,
                    "spmm_max_bwd_f32": n * per_rank}
        for k, c in counts.items():
            if c != expected.get(k, 0):
                fail(f"mesh {tag}: {k} launched {c} times, expected {expected.get(k, 0)}")
        # each launch to its shard-shape entry: (counter, P, part, K)
        for rr in ranks:
            for key, c in rr["shape_counts"].items():
                counter, shape = key.split("@")
                name = f"{counter}@p{graph}_{shape}"
                if name not in results:
                    fail(f"mesh {tag}: {c} launches of {key}, a shape phase 4m (a) "
                         "did not check")
                shard_launches[name] = shard_launches.get(name, 0) + c
        worst = compare_mesh_artifacts(f"mesh {tag}", out, want_dir)
        ep = ranks[0]["epoch_ms"]
        print(f"mesh {tag} ({n} gloo ranks on one card, {smi_line}): epoch ms "
              f"{[round(m, 3) for m in ep]}, steady {statistics.median(ep[1:]):.3f} "
              f"ms/epoch (rank 0), run wall {wall:.1f} s with spawn, peak "
              f"{max(rr['peak_gib'] for rr in ranks):.2f} GiB a rank, launches "
              f"{ {k: c for k, c in counts.items() if c} }", flush=True)
        for layer, ex in enumerate(ranks[0]["exchange"], start=1):
            slowest = max(rr["exchange"][layer - 1]["ms"] for rr in ranks)
            print(f"  layer {layer} halo exchange (K {ex['k']}): buffer "
                  f"{ex['buffer_bytes'] / 1e6:.1f} MB a rank a direction "
                  f"(S {ranks[0]['halo_per_peer']}, halo rows received "
                  f"{[rr['halo_rows_received'] for rr in ranks]}), slowest rank "
                  f"{slowest:.3f} ms (median of 3, gloo host-staged)", flush=True)
        print(f"  against one card: logits max abs diff {worst['logits']:.3e} (gate "
              f"{MESH_ATOL}), losses {worst['loss']:.3e}, threshold/AUC metrics "
              f"{worst['metric']:.3e}, log.tsv rows with a flipped prediction "
              f"{worst['tsv_flips']}", flush=True)
    # the shard entries launched by the runs; the other shapes stay at 0
    for name, c in shard_launches.items():
        results[name]["launches"] = c


@contextlib.contextmanager
def nccl_one_rank():
    """A NCCL process group of one rank on cuda:0, in this process."""
    import datetime

    import torch.distributed as dist

    rdzv = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{rdzv}/rdzv", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdzv, ignore_errors=True)


def nccl_phase(data_root, smi_line):
    """Phase 4m (c): a NCCL group of one rank on cuda:0 (in this process):
    the halo exchange at P = 1 (all slots padding: zeros, and a zero
    gradient) and an all_reduce of CUDA tensors; then TAX_EPOCHS epochs of
    the sharded runner on a graph axis of size 1 (the local pass, no
    exchange) against the single-card runner from the same models.  Returns
    (the sharded runner's epoch ms, the single-card runner's): phase 4q's
    structure tax."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from plagnn_tpu_torch.data.artifacts import load_condition
    from plagnn_tpu_torch.parallel.partition import partition_graph
    from plagnn_tpu_torch.parallel.sharded import (
        halo_exchange, make_mesh, make_sharded_fold_runner)
    from plagnn_tpu_torch.train.engine import (
        TrainConfig, fold_seed, init_fold_model, make_batched_fold_runner)
    from plagnn_tpu_torch.train.kfold import FOLD_SEEDS, fold_node_masks
    from plagnn_tpu_torch.train.losses import weight_cal

    with nccl_one_rank():
        mesh = make_mesh(1, 1)
        b = load_condition(data_root, "GSE30931", "normal")
        g = b.graph
        pg = partition_graph(g.src.numpy(), g.dst.numpy(), g.n_real_nodes, 1)
        shard = pg.shard(0, "cuda")
        x = torch.rand((pg.own_rows, FOLDS * F_IN), device="cuda", requires_grad=True)
        halo = halo_exchange(x, shard.send_idx, mesh.graph_group)
        halo.backward(torch.ones_like(halo))
        t = torch.arange(1024, dtype=torch.float32, device="cuda")
        dist.all_reduce(t, group=mesh.graph_group)
        torch.cuda.synchronize()
        if halo.shape != (pg.halo_per_peer, FOLDS * F_IN) or bool(halo.any()):
            fail("NCCL: the P = 1 halo is not all padding zeros")
        if bool(x.grad.any()) or not torch.equal(
                t, torch.arange(1024, dtype=torch.float32, device="cuda")):
            fail("NCCL: the exchange's gradient or the all_reduce is wrong")
        cfg = TrainConfig(fold_num=FOLDS, epoch_num=TAX_EPOCHS, verbose=False)
        tr, va = fold_node_masks(b.label_with_loc, g.n_nodes, FOLDS, FOLD_SEEDS[0])
        seeds = [fold_seed(cfg.seed, 1, f + 1, 0) for f in range(FOLDS)]
        w = weight_cal(b.loc_mat)
        n = g.n_real_nodes
        run_s = make_sharded_fold_runner(mesh, pg, shard, b.feats[:n], b.labels[:n], w,
                                         cfg, torch.device("cuda"))
        _, _, probs_s, hist_s, ms_s = run_s(
            init_fold_model(cfg, F_IN, seeds, "cuda"), None, tr, va, 0.1)
        gd = g.to("cuda")
        run_1 = make_batched_fold_runner(
            gd, torch.as_tensor(np.asarray(b.feats, np.float32), device="cuda"),
            torch.as_tensor(np.asarray(b.labels, np.float32), device="cuda"), w,
            torch.arange(g.n_nodes, device="cuda") < n, cfg)
        _, _, probs_1, hist_1, ms_1 = run_1(
            init_fold_model(cfg, F_IN, seeds, "cuda"), None,
            torch.as_tensor(tr, device="cuda"), torch.as_tensor(va, device="cuda"), 0.1)
        d = (probs_s - probs_1[:, :n]).abs().max().item()
        dl = max(float(np.abs(hist_s[s]["loss"] - hist_1[s]["loss"]).max())
                 for s in ("train", "val"))
        if d > MESH_ATOL or dl > MESH_ATOL:
            fail(f"NCCL graph=1 step: probabilities differ by {d}, losses by {dl}")
        print(f"NCCL (1 rank, cuda:0, {smi_line}): halo exchange at P = 1 and "
              f"all_reduce on CUDA tensors ran; graph=1 epochs "
              f"{[round(m, 3) for m in ms_s]} ms against the single-card runner's "
              f"{[round(m, 3) for m in ms_1]}, probabilities max abs diff {d:.3e}, "
              f"losses {dl:.3e}", flush=True)
    return ms_s, ms_1


def mesh_phase(data_root, results, smi_line):
    """Phase 4m, on a synthetic bundle whose log holds the single-card
    train-normal float32 run of MESH_EPOCHS epochs; returns 4m (c)'s epoch
    times."""
    phase("4m multi-device path on one card")
    shard_kernel_phase(results, smi_line)
    mesh_train_phase(data_root, os.path.join(data_root, "log", "GSE30931", "normal"),
                     results, smi_line)
    return nccl_phase(data_root, smi_line)


def mesh_only(smi_line):
    """``--only-mesh``: the single-card run phase 4m compares with, then 4m."""
    from plagnn_tpu_torch import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cli.main(["synth", "--data-root", tmp, "--nodes", str(NODES),
                  "--edges", str(EDGES), "--seed", str(SEED)])
        train_cli(tmp, "train-normal", "float32", MESH_EPOCHS)
        mesh_phase(tmp, {}, smi_line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def planner_only(smi_line):
    """``--only-planner``: phase 4m (c) for the structure tax, then 4q."""
    from plagnn_tpu_torch import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cli.main(["synth", "--data-root", tmp, "--nodes", str(NODES),
                  "--edges", str(EDGES), "--seed", str(SEED)])
        phase("4m (c) NCCL group of one rank")
        tax_ms = nccl_phase(tmp, smi_line)
        phase("4q planner anchors and --mesh auto")
        planner_phase(tmp, tax_ms, smi_line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 4q: the mesh planner's anchors, measured here, and --mesh auto.
# ---------------------------------------------------------------------------


def rate_sweep(graph, smi_line):
    """Phase 4q (a): the max forward (with the argmax) and backward at layer
    1's K = B x 503 for each B of PLAN_BS, bfloat16 and float32, each the
    median of 10 launches by CUDA events; at PLAN_CHECK_BS checked against
    the plain versions as phase 3 checks them.  Returns {B: the bfloat16
    pair's edge-folds/s}, E x B over the two kernels' time."""
    import torch

    from gpubench.counts import max_bwd_bytes, max_fwd_bytes
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    n, e = graph.n_nodes, graph.n_edges
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rates = {}
    for b in PLAN_BS:
        k = b * F_IN
        # relu of bf16-representable values: ties at 0, the same in both dtypes
        x32 = torch.randn((n, k), generator=gen, device="cuda").to(torch.bfloat16)
        x32 = x32.float().relu_()
        if b in PLAN_CHECK_BS:
            check_kernels(graph, x32, f"4q B = {b}")
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x = x32.to(dt)
            _, arg = sk.spmm_max_fwd(graph, x)
            g = torch.randn((n, k), generator=gen, device="cuda").to(dt)
            fwd = median_ms(lambda: sk.spmm_max_fwd(graph, x), 10)
            bwd = median_ms(lambda: sk.spmm_max_bwd(graph, g, arg), 10)
            shape = bench_shape(graph, arg.element_size())
            nbytes = (max_fwd_bytes(shape, k, x.element_size())
                      + max_bwd_bytes(shape, k, x.element_size()))
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            rate = e * b / ((fwd + bwd) / 1e3)
            if dt == torch.bfloat16:
                rates[b] = rate
            print(f"4q rate B = {b} (K {k}) {tag}: fwd {fwd:.3f} + bwd {bwd:.3f} ms = "
                  f"{rate:.4e} edge-folds/s; bytes bound {bound:.3f} ms "
                  f"({(fwd + bwd) / bound:.2f}x; {smi_line})", flush=True)
            del x, arg, g
        del x32
        torch.cuda.empty_cache()
    return rates


def fold_ceiling(data_root, smi_line):
    """Phase 4q (b): the peak device memory of one GNN32 training epoch
    (the single-card runner at full width, float32 and bfloat16 messages)
    at each B of CEILING_BS; the per-fold slope of the larger peak (the
    caching allocator's reserve) against the memory the allocator can reach
    gives each dtype's ceiling; one epoch at the smaller of the two must
    fit.  Returns that B."""
    import gc

    import numpy as np
    import torch

    from plagnn_tpu_torch.data.artifacts import load_condition
    from plagnn_tpu_torch.train.engine import (
        TrainConfig, fold_seed, init_fold_model, make_batched_fold_runner)
    from plagnn_tpu_torch.train.kfold import fold_node_masks
    from plagnn_tpu_torch.train.losses import weight_cal
    from plagnn_tpu_torch.utils.precision import set_aggregation_dtype

    bundle = load_condition(data_root, "GSE30931", "normal")
    graph = bundle.graph.to("cuda")
    feats = torch.as_tensor(np.asarray(bundle.feats, np.float32), device="cuda")
    labels = torch.as_tensor(np.asarray(bundle.labels, np.float32), device="cuda")
    weight = weight_cal(bundle.loc_mat)
    valid = torch.arange(graph.n_nodes, device="cuda") < graph.n_real_nodes

    def epoch_peak(b, agg):
        """(peak allocated, peak reserved, epoch ms) of one epoch at B = b:
        b jobs of ceil(b / 10) rounds of 10 folds, the data resident."""
        set_aggregation_dtype(agg)
        cfg = TrainConfig(fold_num=FOLDS, epoch_num=1, fold_batch=b, verbose=False)
        masks = [fold_node_masks(bundle.label_with_loc, graph.n_nodes, FOLDS, 1 + r)
                 for r in range(-(-b // FOLDS))]
        tr = torch.as_tensor(np.concatenate([m[0] for m in masks])[:b], device="cuda")
        va = torch.as_tensor(np.concatenate([m[1] for m in masks])[:b], device="cuda")
        seeds = [fold_seed(cfg.seed, 1 + j // FOLDS, 1 + j % FOLDS, 0) for j in range(b)]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            run = make_batched_fold_runner(graph, feats, labels, weight, valid, cfg)
            out = run(init_fold_model(cfg, F_IN, seeds, "cuda"), None, tr, va, 0.1)
            torch.cuda.synchronize()
            return (torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved(),
                    out[-1][0])
        finally:
            set_aggregation_dtype("float32")

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    reach = free + torch.cuda.memory_reserved()
    print(f"4q memory: card total {total / 2**30:.2f} GiB, the allocator can reach "
          f"{reach / 2**30:.2f} GiB ({smi_line})", flush=True)
    ceilings = {}
    for agg in ("float32", "bfloat16"):
        peaks = {b: epoch_peak(b, agg) for b in CEILING_BS}
        (b0, (a0, r0, _)), (b1, (a1, r1, _)) = sorted(peaks.items())
        slope = (r1 - r0) / (b1 - b0)
        ceilings[agg] = b0 + int((reach - r0) // slope)
        for b, (a, r, ms) in sorted(peaks.items()):
            print(f"4q {agg} epoch at B = {b}: peak {a / 2**30:.3f} GiB allocated, "
                  f"{r / 2**30:.3f} reserved; {ms:.1f} ms", flush=True)
        print(f"4q {agg}: {(a1 - a0) / (b1 - b0) / 2**20:.2f} MiB allocated, "
              f"{slope / 2**20:.2f} reserved a fold; ceiling B = {ceilings[agg]}",
              flush=True)
    ceiling = min(ceilings.values())
    agg = min(ceilings, key=ceilings.get)
    try:
        a, r, ms = epoch_peak(ceiling, agg)
    except torch.cuda.OutOfMemoryError as exc:
        fail(f"4q: one {agg} epoch at the reckoned ceiling B = {ceiling} does not "
             f"fit: {exc}")
    print(f"4q {agg} epoch at the ceiling B = {ceiling}: peak {a / 2**30:.3f} GiB "
          f"allocated, {r / 2**30:.3f} reserved of {reach / 2**30:.2f}; {ms:.1f} ms "
          f"({smi_line})", flush=True)
    return ceiling


class _Tee:
    """A stdout that also keeps what was written."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def planner_phase(data_root, tax_ms, smi_line):
    """Phase 4q, on phase 4's synthetic bundle: (a) the rate sweep, (b) the
    fold ceiling, (c) the structure tax from phase 4m (c)'s epochs (``tax_ms``:
    the sharded runner's and the single-card runner's epoch ms), (d) the
    anchors written to ANCHORS_FILE with planner.write_anchors, ``plan-mesh
    --devices D`` through the CLI for each D of PLAN_DEVICES on them, and
    ``train-normal --mesh auto`` (D = 1 here) for 2 epochs of PLAN_ROUNDS
    rounds: the planner's line, the plan's fold batch in every chunk, 3 max
    forwards and 3 backwards an epoch, the artifact contract."""
    import re

    import torch

    from plagnn_tpu_torch import cli
    from plagnn_tpu_torch.data.artifacts import load_condition
    from plagnn_tpu_torch.parallel import planner

    graph = load_condition(data_root, "GSE30931", "normal").graph
    rates = rate_sweep(graph.to("cuda"), smi_line)
    ceiling = fold_ceiling(data_root, smi_line)
    ms_s, ms_1 = tax_ms
    measured_tax = statistics.median(ms_s[1:]) / statistics.median(ms_1[1:])
    tax = max(1.0, measured_tax)
    print(f"4q structure tax: sharded runner at graph=1 (NCCL, 1 rank) steady "
          f"{statistics.median(ms_s[1:]):.3f} ms/epoch {[round(m, 3) for m in ms_s]}, "
          f"single-card runner {statistics.median(ms_1[1:]):.3f} "
          f"{[round(m, 3) for m in ms_1]}: {measured_tax:.4f} (written {tax:.4f})",
          flush=True)

    if os.path.exists(ANCHORS_FILE):
        os.remove(ANCHORS_FILE)
    planner.write_anchors({"bf16_rates": {str(b): r for b, r in rates.items()},
                           "structure_tax": tax, "hbm_fold_ceiling_full_graph": ceiling},
                          f"chip_smoke.py phase 4q on {smi_line}", ANCHORS_FILE)
    anc = planner.load_anchors(ANCHORS_FILE)
    if anc["source"] != ANCHORS_FILE or anc["rates"] != rates:
        fail(f"4q: {ANCHORS_FILE} does not read back ({anc['source']})")
    baked = planner.load_anchors("baked")
    print(f"4q anchors written to {ANCHORS_FILE}; measured / baked: rates "
          + ", ".join(f"B = {b} {r / baked['rates'].get(b, float('nan')):.3f}"
                      for b, r in sorted(rates.items()))
          + f"; tax {tax:.4f} / {baked['tax']}; ceiling {ceiling} / "
          f"{baked['hbm_ceiling']}", flush=True)

    os.environ[planner.ANCHORS_ENV] = ANCHORS_FILE
    try:
        for d in PLAN_DEVICES:
            t0 = time.perf_counter()
            plan = cli.main(["plan-mesh", "--devices", str(d), "--data-root", data_root])
            if (plan.anchors_source != ANCHORS_FILE
                    or f"anchors: {ANCHORS_FILE}" not in plan.summary()):
                fail(f"4q: plan-mesh --devices {d} read {plan.anchors_source}")
            print(f"4q plan-mesh --devices {d}: {time.perf_counter() - t0:.1f} s "
                  f"(modeled, not measured)", flush=True)

        # --mesh auto: the counts from 0 just before the run, read just after
        shutil.rmtree(os.path.join(data_root, "log"), ignore_errors=True)
        tee = _Tee(sys.stdout)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            stats = cli.main(["train-normal", "-data", "GSE30931", "--data-root", data_root,
                              "-e", "2", "--rounds", str(PLAN_ROUNDS), "-f", str(FOLDS),
                              "--mesh", "auto"])
        wall = time.perf_counter() - t0
        epochs = sum(len(s.epoch_ms) for s in stats)
        counts = check_launches("train-normal --mesh auto", gnn32_launches("f32", epochs))
        m = re.search(r"mesh planner: D=(\d+) -> fold=(\d+) x graph=(\d+) "
                      r"\(b_local=(\d+), fold_batch=(\d+)", "".join(tee.text))
        if m is None:
            fail("4q: train-normal --mesh auto printed no planner line")
        d, fold, graph_p, _, fold_batch = map(int, m.groups())
        jobs = PLAN_ROUNDS * FOLDS
        want = planner.plan_mesh(1, graph.src.numpy(), graph.dst.numpy(),
                                 graph.n_real_nodes, total_jobs=jobs)
        widths = [s.folds for s in stats]
        if ((d, fold, graph_p) != (1, 1, 1) or fold_batch != want.chosen.fold_batch
                or widths[0] != min(fold_batch, jobs) or max(widths) > fold_batch
                or sum(widths) != jobs):
            fail(f"4q: --mesh auto planned D={d} fold={fold} graph={graph_p} "
                 f"fold_batch={fold_batch} (want {want.chosen.fold_batch}) and ran "
                 f"chunks of {widths} folds")
        check_artifacts("train-normal --mesh auto",
                        os.path.join(data_root, "log", "GSE30931", "normal"),
                        rounds=PLAN_ROUNDS)
        report_run(f"GNN32 train-normal --mesh auto (fold_batch {fold_batch}, chunks "
                   f"{widths})", stats, wall, counts, smi_line, folds=fold_batch)
    finally:
        del os.environ[planner.ANCHORS_ENV]


# ---------------------------------------------------------------------------
# Phase 4g: the big-graph path (the positional argmax) on the one card.
# ---------------------------------------------------------------------------


def big_inputs(graph):
    """Layer 1's input at phase 4g's shape (K = 8 x 503) on the card: relu
    of seeded bf16-representable values (ties at 0, the same in float32 and
    bfloat16), an all-equal block (columns [0, BIG_TIES)), and in the next
    BIG_MEGA_COLS columns the top row's maximum (50.0, above every other
    value) at one rank past the rank cap a column.  Returns x, that row and
    the ranks."""
    import numpy as np
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    x = torch.randn((graph.n_nodes, BIG_FOLDS * F_IN), generator=gen, device=DEVICE)
    x = x.to(torch.bfloat16).float().relu_()
    x[:, :BIG_TIES] = 1.5
    deg = graph.in_degree.cpu().numpy()
    top, cap = int(np.argmax(deg)), graph.rank_cap
    if deg[top] < cap + 2 + BIG_MEGA_COLS:
        fail(f"big graph: top in-degree {deg[top]} leaves no rank past the cap {cap}")
    ranks = cap + 1 + np.arange(BIG_MEGA_COLS) * ((deg[top] - cap - 2) // BIG_MEGA_COLS)
    at = int(graph.indptr[top]) + torch.from_numpy(ranks).to(DEVICE)
    x[graph.src[at].long(), torch.arange(BIG_TIES, BIG_TIES + BIG_MEGA_COLS, device=DEVICE)] = 50.0
    return x, top, ranks


def sliced_library_ms(graph, x, g, arg_ids):
    """The library yardsticks where the gathered (edges, K) operand does not
    fit the card (10.3 M x 4,024 x 4 bytes = 166 GB): ``scatter_reduce_``
    amax (forward) and ``index_add_`` of the masked gradient (backward),
    each over column slices whose gathered operand fits LIB_SLICE_BYTES;
    one call a slice after a warm-up, summed, the gathers untimed as in
    phase 3.
    Returns (forward ms, backward ms, columns a slice)."""
    import torch

    n, k = x.shape
    w = max(1, min(k, LIB_SLICE_BYTES // (graph.n_edges * 4)))
    src_l, dst_l = graph.src.long(), graph.dst.long()
    src_i = graph.src[:, None]
    fwd = bwd = 0.0
    for c0 in range(0, k, w):
        c1 = min(c0 + w, k)
        gathered = x[:, c0:c1][src_l]
        idx = dst_l[:, None].expand(-1, c1 - c0)
        out = torch.zeros((n, c1 - c0), dtype=x.dtype, device=DEVICE)
        fwd += median_ms(lambda: out.scatter_reduce_(0, idx, gathered, "amax",
                                                     include_self=False), 1)
        del gathered, out
        masked = torch.where(arg_ids[dst_l, c0:c1] == src_i, g[dst_l, c0:c1].float(), 0.0)
        dx = torch.zeros((n, c1 - c0), device=DEVICE)
        bwd += median_ms(lambda: dx.index_add_(0, src_l, masked), 1)
        del masked, dx
    torch.cuda.empty_cache()
    return fwd, bwd, w


def big_fwd_check(graph, x, label):
    """One argmax form's max forward on the big graph against its plain
    version: out and argmax bit-exact with plain and run to run, the
    argmax of the form's dtype and rows.  Returns (out, arg, the plain
    version's ms)."""
    import torch

    from plagnn_tpu_torch.ops import spmm_kernels as sk

    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    out, arg = sk.spmm_max_fwd(graph, x)
    out_2, arg_2 = sk.spmm_max_fwd(graph, x)
    torch.cuda.synchronize()
    if arg.dtype != sk.arg_dtype(graph) or arg.shape != (sk.arg_rows(graph), x.shape[1]):
        fail(f"{label}: argmax {arg.dtype} {tuple(arg.shape)}")
    if not (torch.equal(out.view(bits), out_2.view(bits)) and torch.equal(arg, arg_2)):
        fail(f"{label}: forward not bit-identical run to run")
    del out_2, arg_2
    (out_p, arg_p), plain_ms = timed_ms(lambda: sk.spmm_max_fwd_plain(graph, x))
    if not torch.equal(out, out_p):
        fail(f"{label}: out differs from plain")
    if not torch.equal(arg, arg_p):
        fail(f"{label}: argmax differs from plain ({(arg != arg_p).sum().item()} elements)")
    return out, arg, plain_ms


def big_bwd_check(graph, g, arg, label, other=None):
    """One argmax form's max backward on the big graph against its plain
    version as phase 3 holds it: bit-identical run to run; float32 within
    1e-5 of the summed hit magnitudes (the same hits summed in two orders),
    bfloat16 within 1 ulp (small-integer gradients, one rounding at the
    store).  ``other``, the other form's dx, is held to the same tolerance.
    Returns (dx, max abs err against plain, the plain version's ms, whether
    dx is bit-equal to ``other``)."""
    import torch

    from plagnn_tpu_torch.ops import spmm_kernels as sk

    bits = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
    dx = sk.spmm_max_bwd(graph, g, arg)
    dx_2 = sk.spmm_max_bwd(graph, g, arg)
    torch.cuda.synchronize()
    if not torch.equal(dx.view(bits), dx_2.view(bits)):
        fail(f"{label}: backward not bit-identical run to run")
    del dx_2
    dx_p, plain_ms = timed_ms(lambda: sk.spmm_max_bwd_plain(graph, g, arg))
    if g.dtype == torch.float32:
        tol = sk.spmm_max_bwd_plain(graph, g.abs(), arg).mul_(1e-5).add_(1e-7)
    else:
        tol = bf16_ulp(torch.maximum(dx.float().abs(), dx_p.float().abs()))
    err = dx_p.float().sub_(dx.float()).abs_()
    del dx_p
    if bool((err > tol).any()):
        fail(f"{label}: backward differs from plain beyond tolerance "
             f"(max abs {err.max().item()})")
    err_max = err.max().item()
    del err
    same = other is not None and torch.equal(dx.view(bits), other.view(bits))
    if other is not None and not same:
        if bool((other.float().sub_(dx.float()).abs_() > tol).any()):
            fail(f"{label}: backward differs from the other argmax form's beyond tolerance")
    return dx, err_max, plain_ms, same


def launched_slice(counter, n, k):
    """The K-slice width the max wrapper passed to its kernel at the last
    launch of ``counter`` at N_pad ``n`` and K ``k``."""
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    return sk.LAUNCH_SLICES[counter, n, k]


def check_big_kernels(gp, gi, x32, top, ranks, results):
    """Phase 4g's kernel checks at every width the path aggregates (K = 8 x
    503 / 400 / 300, each a column prefix of layer 1's input, so the
    all-equal block and the mega-row columns are in each), float32 and
    bfloat16: the positional kernels (graph ``gp``) and the id-based int32
    kernels on the same graph (``gi``), each against its own plain version
    as phase 3 holds them, and the two forms against each other.  At layer
    1 each kernel is timed (median of 10) beside its plain version (its one
    call in the check), the sliced library yardstick and its bytes bound."""
    import torch

    from gpubench.counts import max_bwd_bytes, max_fwd_bytes
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    n = x32.shape[0]
    e, cap = gp.n_edges, gp.rank_cap
    m = int(gp.mega_of[top])
    mega_cols = slice(BIG_TIES, BIG_TIES + BIG_MEGA_COLS)
    want = torch.from_numpy(ranks).to(DEVICE)
    live = gp.in_degree > 0
    nonempty = int(live.sum().item())
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    for layer, width in enumerate(AGG_WIDTHS, start=1):
        xw = x32 if width == F_IN else x32[:, :BIG_FOLDS * width].contiguous()
        k = xw.shape[1]
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            label = f"big graph layer {layer} {tag} (K = {k})"
            x = xw.to(dt)
            bits = torch.int16 if dt == torch.bfloat16 else torch.int32
            esize = x.element_size()
            out_k, arg_k, fwd_plain = big_fwd_check(gp, x, f"{label} positional")
            out_i, arg_i, fwd_plain_i = big_fwd_check(gi, x, f"{label} id-based")
            if not torch.equal(out_k.view(bits), out_i.view(bits)):
                fail(f"{label}: positional out differs from the id-based kernel's")
            widths = {}
            for form, pre, graph, out_r, arg_r in (("positional", "pos_", gp, out_k, arg_k),
                                                   ("id-based", "", gi, out_i, arg_i)):
                widths[form] = [launched_slice(f"spmm_max_fwd_{pre}{tag}", n, k)]
                out_1, arg_1 = sk.spmm_max_fwd(graph, x, force_slice=1024)
                if not (torch.equal(out_1.view(bits), out_r.view(bits))
                        and torch.equal(arg_1, arg_r)):
                    fail(f"{label} {form}: forward at the rule's width differs from 1 KB")
                del out_1, arg_1
            del out_k, out_i
            for c0 in range(0, k, 512):
                if not torch.equal(sk._arg_sources(gp, arg_k[:, c0:c0 + 512]),
                                   arg_i[:, c0:c0 + 512].long()):
                    fail(f"{label}: positional argmax names other sources than the "
                         f"id-based one in columns {c0}..{c0 + 511}")
            if not bool((arg_k[:n][live, :BIG_TIES] == 0).all()):
                fail(f"{label}: an all-equal column's argmax is not rank 0")
            if not (torch.equal(arg_k[n + m, mega_cols].long(), want // cap)
                    and torch.equal(arg_k[top, mega_cols].long(), want % cap)):
                fail(f"{label}: the top row's maximum past rank {cap} is not its "
                     "(segment, rank)")

            if dt == torch.float32:
                g = torch.randn((n, k), generator=gen, device=DEVICE)
            else:
                g = torch.randint(-8, 9, (n, k), generator=gen, device=DEVICE).to(dt)
            dx_k, bwd_err, bwd_plain, _ = big_bwd_check(gp, g, arg_k, f"{label} positional")
            dx_i, bwd_err_i, bwd_plain_i, same_as_pos = big_bwd_check(
                gi, g, arg_i, f"{label} id-based", other=dx_k)
            for form, pre, graph, dx_r, arg_r in (("positional", "pos_", gp, dx_k, arg_k),
                                                  ("id-based", "", gi, dx_i, arg_i)):
                widths[form].append(launched_slice(f"spmm_max_bwd_{pre}{tag}", n, k))
                dx_1 = sk.spmm_max_bwd(graph, g, arg_r, force_slice=1024)
                if not torch.equal(dx_1.view(bits), dx_r.view(bits)):
                    fail(f"{label} {form}: backward at the rule's width differs from 1 KB")
                del dx_1
            del dx_k, dx_i
            torch.cuda.empty_cache()
            print(f"{label}: each form's fwd out/argmax bit-exact with its plain version "
                  f"and run to run, the positional out equal to the id-based int32 "
                  f"kernel's and its argmax naming the same sources (all-equal block at "
                  f"rank 0, the top row's maximum past rank {cap} as (segment, rank)); "
                  f"bwd max abs err vs plain {bwd_err:.3e} positional, {bwd_err_i:.3e} "
                  f"id-based, the two forms' dx "
                  f"{'bit-equal' if same_as_pos else 'within tolerance'}; at the rule's "
                  f"K-slices (fwd, bwd bytes: {widths}) out, argmax and dx bit-equal to "
                  f"the 1 KB slice's", flush=True)
            if width != F_IN:
                del arg_k, arg_i, g, x
                torch.cuda.empty_cache()
                continue

            # -- timings, at layer 1 ---------------------------------------------
            times = {   # the rule's K-slice, then the forced 1 KB one
                "fwd_pos": median_ms(lambda: sk.spmm_max_fwd(gp, x), 10),
                "fwd_id": median_ms(lambda: sk.spmm_max_fwd(gi, x), 10),
                "bwd_pos": median_ms(lambda: sk.spmm_max_bwd(gp, g, arg_k), 10),
                "bwd_id": median_ms(lambda: sk.spmm_max_bwd(gi, g, arg_i), 10),
            }
            timed_slice = {key: launched_slice(counter, n, k) for key, counter in (
                ("fwd_pos", f"spmm_max_fwd_pos_{tag}"), ("fwd_id", f"spmm_max_fwd_{tag}"),
                ("bwd_pos", f"spmm_max_bwd_pos_{tag}"), ("bwd_id", f"spmm_max_bwd_{tag}"))}
            times |= {
                "fwd_pos_1kb": median_ms(lambda: sk.spmm_max_fwd(gp, x, force_slice=1024), 10),
                "fwd_id_1kb": median_ms(lambda: sk.spmm_max_fwd(gi, x, force_slice=1024), 10),
                "bwd_pos_1kb": median_ms(
                    lambda: sk.spmm_max_bwd(gp, g, arg_k, force_slice=1024), 10),
                "bwd_id_1kb": median_ms(
                    lambda: sk.spmm_max_bwd(gi, g, arg_i, force_slice=1024), 10),
            }
            torch.cuda.empty_cache()
            fwd_lib, bwd_lib, slice_w = sliced_library_ms(gi, x, g, arg_i)
            del arg_k, arg_i, g, x
            torch.cuda.empty_cache()
            # the positional form's bytes count mega_of (both), t_rank
            # (backward) and the argmax's side table too
            pos, ids = bench_shape(gp, 2), bench_shape(gi, 4)
            entries = [
                (f"spmm_max_fwd_pos_{tag}", "spmm_max_fwd", 0.0, "fwd_pos",
                 fwd_plain, fwd_lib, max_fwd_bytes(pos, k, esize), e * k),
                (f"spmm_max_bwd_pos_{tag}", "spmm_max_bwd", bwd_err, "bwd_pos",
                 bwd_plain, bwd_lib, max_bwd_bytes(pos, k, esize), e * k + nonempty * k),
                (f"spmm_max_fwd_{tag}@n{n}", "spmm_max_fwd", 0.0, "fwd_id",
                 fwd_plain_i, fwd_lib, max_fwd_bytes(ids, k, esize), e * k),
                (f"spmm_max_bwd_{tag}@n{n}", "spmm_max_bwd", bwd_err_i, "bwd_id",
                 bwd_plain_i, bwd_lib, max_bwd_bytes(ids, k, esize), e * k + nonempty * k),
            ]
            for name, src, err_, key, plain, lib, nbytes, ops in entries:
                ms = times[key]
                r = results[name] = kernel_entry(name, src, err_, ms, plain, lib, nbytes,
                                                 ops, (n, k), slice_bytes=timed_slice[key])
                # the K-slice's re-reads of the chunks' index (and t_rank), not in
                # the bound: E x 4 bytes a slice
                slices = sk.slice_layout(r["slice_bytes"], k, esize)[2]
                r["index_reread_bytes"] = (2 if key == "bwd_pos" else 1) * 4 * e * slices
                r["ms_1kb"] = times[key + "_1kb"]
                print(f"  {name}: {ms:.3f} ms at the rule's {r['slice_bytes']} B K-slice, "
                      f"{r['ms_1kb']:.3f} ms at 1 KB (index re-read "
                      f"{r['index_reread_bytes'] / 1e9:.2f} GB; plain {plain:.3f}, library "
                      f"{lib:.3f} over "
                      f"{-(-k // slice_w)} column slices of {slice_w}, bound "
                      f"{r['bound_ms']:.3f} by {r['bound_by']}, no-reuse gather "
                      f"{e * k * esize / HBM_BYTES_PER_S * 1e3:.3f})", flush=True)


def big_hub_check(host, gi, x32, results, smi_line):
    """Phase 4g's hub check: the id-based layer-1 max forward and backward
    (int32 argmax) with a hub at HUB_MAIN_K's sizes, against the same
    kernels without it (out and argmax bit-exact, dx bit-identical) and
    their plain versions, each timed beside the kernel without the hub;
    the coverage by k at this size.  No training run takes the hub here:
    the engine turns it off past 2^15 nodes, as the JAX package's does."""
    import dataclasses

    import torch

    from gpubench.counts import max_bwd_bytes, max_fwd_bytes
    from plagnn_tpu_torch.ops import spmm_kernels as sk
    from plagnn_tpu_torch.ops.hub import pick_hub_sizes

    ids_host = dataclasses.replace(host, positional=False, t_rank=None, mega_of=None,
                                   n_mega=0)
    print(f"big graph hub coverage: {hub_coverage(ids_host, sorted({*HUB_KS, 128, 256}))}",
          flush=True)
    n, k = x32.shape
    e = gi.n_edges
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = x32.to(dt)
        esize = x.element_size()
        pair = pick_hub_sizes(str(HUB_MAIN_K), k, esize, arg_size=4)
        gh = ids_host.with_hub(*pair).to(DEVICE)
        if dt == torch.float32:
            g = torch.randn((n, k), generator=gen, device=DEVICE)
        else:
            g = torch.randint(-8, 9, (n, k), generator=gen, device=DEVICE).to(dt)
        label = f"big graph hub {tag} (K = {k}, k = {pair})"
        out_h, arg_h, dx_h = hub_max_equal(gi, gh, x, g, label)
        (out_p, arg_p), fwd_plain = timed_ms(lambda: sk.spmm_max_fwd_plain(gh, x))
        if not (torch.equal(out_h, out_p) and torch.equal(arg_h, arg_p)):
            fail(f"{label}: forward differs from its plain version")
        del out_h, out_p, arg_p
        dx_p, bwd_plain = timed_ms(lambda: sk.spmm_max_bwd_plain(gh, g, arg_h))
        bwd_err = (dx_h.float() - dx_p.float()).abs().max().item()
        del dx_h, dx_p
        gz = zero_hub(gi)
        times = {"fwd0": median_ms(lambda: sk.spmm_max_fwd(gi, x), 10),
                 "fwd": median_ms(lambda: sk.spmm_max_fwd(gh, x), 10),
                 "fwd_k0": median_ms(lambda: sk.spmm_max_fwd(gz, x), 10),
                 "bwd_k0": median_ms(lambda: sk.spmm_max_bwd(gz, g, arg_h), 10),
                 "bwd": median_ms(lambda: sk.spmm_max_bwd(gh, g, arg_h), 10),
                 "bwd0": median_ms(lambda: sk.spmm_max_bwd(gi, g, arg_h), 10)}
        del gz
        nonempty = int((gi.in_degree > 0).sum().item())
        shape = bench_shape(gi, 4)
        for kind, kk, plain, err, ops, nbytes in (
                ("fwd", pair[0], fwd_plain, 0.0, e * k, max_fwd_bytes(shape, k, esize)),
                ("bwd", pair[1], bwd_plain, bwd_err, e * k + nonempty * k,
                 max_bwd_bytes(shape, k, esize))):
            fill = hub_fill_bytes(kk, k, esize, 4 if kind == "bwd" else 0)
            name = f"spmm_max_{kind}_hub_{tag}@n{n}"
            warps = sk.hub_warps(f"max_{kind}", dt, k, kk, torch.int32)
            r = results[name] = hub_entry(
                name, f"spmm_max_{kind}", err, times[kind], plain,
                results[f"spmm_max_{kind}_{tag}@n{n}"]["library_ms"], nbytes, ops, (n, k),
                kk, {kk: times[kind]}, {"hub": warps[0], "without": warps[1]}, fill)
            r.update(hub_layout_fields(f"max_{kind}", dt, k, kk, torch.int32),
                     ms_k0=times[kind + "_k0"], ms_without=times[kind + "0"])
            print(f"  {name}: k={kk} {r['ms']:.3f} ms, without the hub "
                  f"{times[kind + '0']:.3f}, k=0 {r['ms_k0']:.3f}; warps an SM holds "
                  f"{warps[0]}, without the hub {warps[1]}; {r['stages']} stages, "
                  f"{r['blocks_per_sm']} block(s) an SM, fill route {r['fill_route']}; "
                  f"plain {plain:.3f}, bound {r['bound_ms']:.3f} by "
                  f"{r['bound_by']} (arena fill {fill / 1e6:.1f} MB); {smi_line}",
                  flush=True)
        print(f"{label}: forward bit-exact and backward bit-identical to the id-based "
              f"kernels without the hub and run to run; forward equal to its plain "
              f"version, dx max abs err {bwd_err:.3e}", flush=True)
        del gh, g, x, arg_h
        torch.cuda.empty_cache()


def big_peak_memory(gp, gi, feats):
    """Peak device memory of one forward and backward of BatchedGNN32 at B =
    BIG_FOLDS on the big graph in float32, with the positional argmax and
    with the id-based (int32) one, beside the saving reckoned from the
    saved argmax's bytes; each pass launches 3 forwards and 3 backwards of
    its form and no other kernel."""
    import torch

    from plagnn_tpu_torch.train.engine import TrainConfig, init_fold_model
    from plagnn_tpu_torch.utils.precision import set_aggregation_dtype

    set_aggregation_dtype("float32")
    x = torch.as_tensor(feats, device=DEVICE)
    model = init_fold_model(TrainConfig(fold_batch=BIG_FOLDS), F_IN, range(BIG_FOLDS),
                            DEVICE)
    peaks = {}
    for form, graph, counters in (
            ("positional", gp, ("spmm_max_fwd_pos_f32", "spmm_max_bwd_pos_f32")),
            ("id-based", gi, ("spmm_max_fwd_f32", "spmm_max_bwd_f32"))):
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        model(graph, x).sum().backward()
        torch.cuda.synchronize()
        check_launches(f"big graph fwd+bwd, {form} argmax", {c: LAYERS for c in counters})
        peaks[form] = torch.cuda.max_memory_allocated()
        print(f"big graph BatchedGNN32 B={BIG_FOLDS} f32 forward+backward, {form} argmax: "
              f"peak {peaks[form] / 2**30:.3f} GiB ({(peaks[form] - base) / 2**30:.3f} "
              f"above the inputs and weights)", flush=True)
    reckoned = gp.n_nodes * BIG_FOLDS * sum(AGG_WIDTHS) * 2
    saving = peaks["id-based"] - peaks["positional"]
    print(f"big graph argmax saving: measured {saving / 2**30:.3f} GiB, reckoned "
          f"{reckoned / 2**30:.3f} GiB (N_pad x {BIG_FOLDS} x "
          f"({' + '.join(map(str, AGG_WIDTHS))}) x 2 bytes)", flush=True)
    del model, x
    torch.cuda.empty_cache()


def big_graph_phase(results, smi_line):
    """Phase 4g: BASELINE.json config 5 through the CLI (``synth --nodes
    330000 --edges 10000000``: N_pad 330,112, E 10.33 M with self-loops, 5
    rows past the rank cap), whose graph takes the positional argmax:
    check_big_kernels, big_hub_check and phase 4s (b) on it; GNN32 at
    BIG_FOLDS folds in one batch, train-normal float32 and train-inter
    bfloat16, exactly 3 positional forwards and backwards an epoch and no
    id-based max kernel, the artifact contract; then big_peak_memory.  No
    training run takes the hub here: the engine turns it off past 2^15
    nodes on one card."""
    import dataclasses

    import numpy as np
    import torch

    from plagnn_tpu_torch import cli
    from plagnn_tpu_torch.data.artifacts import load_condition

    tmp = tempfile.mkdtemp(prefix="chip_smoke_big_")
    try:
        t0 = time.perf_counter()
        cli.main(["synth", "--data-root", tmp, "--nodes", str(BIG_NODES),
                  "--edges", str(BIG_EDGES), "--seed", str(SEED)])
        t1 = time.perf_counter()
        bundle = load_condition(tmp, "GSE30931", "normal")
        host = bundle.graph
        t2 = time.perf_counter()
        if not host.positional:
            fail(f"big graph: N_pad {host.n_nodes} built without the positional argmax")
        deg = np.sort(host.in_degree.numpy())[::-1]
        print(f"big graph: N_pad {host.n_nodes}, E {host.n_edges} (self-loops included), "
              f"top in-degrees {deg[:5].tolist()}, {host.n_mega} mega rows over rank cap "
              f"{host.rank_cap}; forward chunks {host.chunks.n_chunks} ({host.chunks.n_split} "
              f"split rows), transpose {host.t_chunks.n_chunks} ({host.t_chunks.n_split}); "
              f"synth {t1 - t0:.1f} s, load_condition (graph build included) "
              f"{t2 - t1:.1f} s", flush=True)
        gp = host.to(DEVICE)
        # the same graph's id-based form: the same tensors, no ranks
        gi = dataclasses.replace(gp, positional=False, t_rank=None, mega_of=None, n_mega=0)
        x32, top, ranks = big_inputs(gp)
        t0 = time.perf_counter()
        check_big_kernels(gp, gi, x32, top, ranks, results)
        print(f"big graph kernel checks and times: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        big_hub_check(host, gi, x32, results, smi_line)
        print(f"big graph hub checks and times: {time.perf_counter() - t0:.1f} s",
              flush=True)
        del x32
        torch.cuda.empty_cache()
        phase("4s (b) big graph shard with a hub")
        big_shard_hub_check(host.src.numpy(), host.dst.numpy(), host.n_real_nodes, False,
                            results, smi_line)
        torch.cuda.empty_cache()
        runs = (("train-normal", "normal", "float32", "f32"),
                ("train-inter", "perturbation", "bfloat16", "bf16"))
        for cmd, subdir, agg, tag in runs:
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            stats = train_cli(tmp, cmd, agg, BIG_EPOCHS, BIG_FOLDS)
            wall = time.perf_counter() - t0
            pos = (f"spmm_max_fwd_pos_{tag}", f"spmm_max_bwd_pos_{tag}")
            counts = check_launches(f"big graph {cmd} --agg-dtype {agg}",
                                    {c: LAYERS * BIG_EPOCHS for c in pos})
            record_launches(results, counts, pos)
            check_artifacts(f"big graph {cmd}", os.path.join(tmp, "log", "GSE30931", subdir),
                            BIG_FOLDS, BIG_NODES)
            report_run(f"GNN32 big graph {cmd} {agg}", stats, wall, counts, smi_line,
                       BIG_FOLDS)
        big_peak_memory(gp, gi, bundle.feats)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 3h: the hub cache's kernels; phase 4h: the hub on the main path.
# ---------------------------------------------------------------------------


def zero_hub(graph):
    """``graph`` with hub tables of k = 0 both ways: the hub kernels'
    structure with an empty arena (every edge from device memory).  Each
    table holds one dummy id (``N_pad - 1``), which no edge names."""
    import dataclasses

    import torch

    from plagnn_tpu_torch.ops.graph_format import HubTable

    def table(nbr):
        ids = torch.full((1,), graph.n_nodes - 1, dtype=torch.int32, device=graph.device)
        return HubTable(ids=ids, idx=nbr, k=0, n_hub=0, n_covered=0)

    return dataclasses.replace(graph, hub=table(graph.src), t_hub=table(graph.t_dst))


def hub_sizes(k_width, esize, arg_size=2):
    """The (k_fwd, k_bwd) pairs phase 3h runs at this K and message size
    (``arg_size``: the max backward's argmax bytes, 0 for the sum): "auto"'s
    where it has a hub, and each of HUB_KS halved to fit."""
    from plagnn_tpu_torch.ops.hub import pick_hub_sizes

    pairs = [pick_hub_sizes("auto", k_width, esize, arg_size)]
    pairs += [pick_hub_sizes(str(k), k_width, esize, arg_size) for k in HUB_KS]
    return sorted({p for p in pairs if p[0] and p[1]})


def hub_fill_bytes(k, k_width, esize, arg_size=0):
    """Bytes the hub kernels read to fill their arenas: k rows of each
    K-slice (the gathered operand's, plus the argmax's), once a block, one
    block per SM per slice."""
    import torch

    from plagnn_tpu_torch.ops.hub import HUB_SLICE_BYTES, arena_bytes

    slices = -(-k_width // (HUB_SLICE_BYTES // esize))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return n_sm * slices * arena_bytes(k, k_width, esize, arg_size)


def bits_of(t):
    import torch

    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def hub_max_equal(g0, gh, x, g, label, empty_value=0.0):
    """The hub max kernels against the same kernels without the hub: out
    and argmax bit-exact, dx bit-identical, each bit-identical run to run
    (one result held at a time: phase 4g's run at 330 k nodes); an empty
    row stores ``empty_value`` (-inf: a mesh's interior pass).  Returns the
    hub's (out, arg, dx)."""
    import torch

    from plagnn_tpu_torch.ops import spmm_kernels as sk

    def same(a, b):
        return torch.equal(bits_of(a), bits_of(b))

    out0, arg0 = sk.spmm_max_fwd(g0, x, empty_value=empty_value)
    out, arg = sk.spmm_max_fwd(gh, x, empty_value=empty_value)
    if not (same(out, out0) and torch.equal(arg, arg0)):
        fail(f"{label}: hub forward differs from the kernel without the hub "
             f"({(arg != arg0).sum().item()} argmax elements)")
    del out0
    out2, arg2 = sk.spmm_max_fwd(gh, x, empty_value=empty_value)
    if not (same(out2, out) and torch.equal(arg2, arg)):
        fail(f"{label}: hub forward not bit-identical run to run")
    del out2, arg2
    dx0 = sk.spmm_max_bwd(g0, g, arg0)
    del arg0
    dx = sk.spmm_max_bwd(gh, g, arg)
    if not same(dx, dx0):
        fail(f"{label}: hub backward differs from the kernel without the hub "
             f"(max abs {(dx.float() - dx0.float()).abs().max().item()})")
    del dx0
    if not same(sk.spmm_max_bwd(gh, g, arg), dx):
        fail(f"{label}: hub backward not bit-identical run to run")
    torch.cuda.empty_cache()
    return out, arg, dx


def hub_sum_equal(g0, gh, x, label):
    """The hub sum kernels, forward and transpose, bit-identical to the
    kernels without the hub and run to run."""
    import torch

    from plagnn_tpu_torch.ops import spmm_kernels as sk

    for transpose in (False, True):
        want = sk.spmm_sum_rows(g0, x, transpose)
        for _ in range(2):
            got = sk.spmm_sum_rows(gh, x, transpose)
            if not torch.equal(bits_of(got), bits_of(want)):
                fail(f"{label}: hub sum {'transpose' if transpose else 'forward'} differs "
                     f"from the kernel without the hub "
                     f"(max abs {(got.float() - want.float()).abs().max().item()})")


def hub_coverage(full, ks):
    """Share of edges whose row the arena serves, by k, each direction."""
    parts = []
    for k in ks:
        gh = full.with_hub(k, k)
        parts.append(f"k={k} forward {gh.hub.n_covered / full.n_edges:.4f} transpose "
                     f"{gh.t_hub.n_covered / full.n_edges:.4f}")
    return "; ".join(parts)


def hub_kernel_phase(full, x_full, results, smi_line):
    """Phase 3h: every hub kernel at every width its path aggregates (max:
    K = 10 x 503 / 400 / 300; sum: 10 x 400 and 10 x 12), f32 and bf16, at
    each of hub_sizes' (k_fwd, k_bwd), against the kernels without the hub
    and, at the first pair, its plain version with phase 3's tolerances; the
    fill route each max width takes; at the first layer's shapes the times
    and warps by k (hub_max_times, hub_sum_times)."""
    import torch

    from plagnn_tpu_torch.ops import spmm_kernels as sk

    print(f"full graph hub coverage (share of edges whose row the arena serves): "
          f"{hub_coverage(full, sorted({*HUB_KS, 128, 256}))}", flush=True)
    g0 = full.to("cuda")
    hub_graphs = {}

    def with_hub(pair):
        if pair not in hub_graphs:
            hub_graphs[pair] = full.with_hub(*pair).to("cuda")
        return hub_graphs[pair]

    n, e = full.n_nodes, full.n_edges
    gen = torch.Generator(device="cuda").manual_seed(11)
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        esize = torch.finfo(dt).bits // 8
        # -- the max kernels at K = 10 x 503 / 400 / 300 ------------------------
        for layer, width in enumerate(AGG_WIDTHS, start=1):
            k = FOLDS * width
            x = x_full[:, :k].contiguous().to(dt)
            if dt == torch.float32:
                g = torch.randn((n, k), generator=gen, device="cuda")
            else:
                g = torch.randint(-8, 9, (n, k), generator=gen, device="cuda").to(dt)
            pairs = hub_sizes(k, esize)
            for pair in pairs:
                hub_max_equal(g0, with_hub(pair), x, g, f"hub {tag} max K={k} k={pair}")
            check_kernels(with_hub(pairs[0]), x_full[:, :k].contiguous(),
                          f"hub graph k={pairs[0]} layer {layer}", dtypes=(dt,))
            print(f"hub {tag} max K={k}: forward bit-exact and backward bit-identical "
                  f"to the kernels without the hub, and run to run, at (k_fwd, k_bwd) "
                  f"{pairs}", flush=True)
            if layer == 1:
                hub_max_times(g0, with_hub, pairs, x, g, tag, results, smi_line)
            routes = {kind: sk.hub_layout(f"max_{kind}", dt, k, pairs[-1][i])["route"]
                      for i, kind in enumerate(("fwd", "bwd"))}
            for kind, route in routes.items():
                results[f"spmm_max_{kind}_hub_{tag}"].setdefault(
                    "fill_route_by_k_width", {})[str(k)] = route
            print(f"hub {tag} max K={k}: fill route forward {routes['fwd']}, backward "
                  f"{routes['bwd']}", flush=True)
            del x, g
        # -- the sum, forward and transpose, at K = 10 x 400 and 10 x 12 --------
        for width in SUM_WIDTHS:
            k = FOLDS * width
            pairs = hub_sizes(k, esize, 0)
            x = torch.randint(-8, 9, (n, k), generator=gen, device="cuda").to(dt)
            if dt == torch.float32:
                x = x + torch.randn((n, k), generator=gen, device="cuda")
            for pair in pairs:
                hub_sum_equal(g0, with_hub(pair), x, f"hub {tag} sum K={k} k={pair}")
            check_sum_kernels(with_hub(pairs[0]), k, f"hub graph k={pairs[0]} sum",
                              dtypes=(dt,))
            print(f"hub {tag} sum K={k}: forward and transpose bit-identical to the "
                  f"kernels without the hub, and run to run, at (k_fwd, k_bwd) {pairs}",
                  flush=True)
            if width == SUM_WIDTHS[0]:
                hub_sum_times(g0, with_hub, pairs, x, tag, results, smi_line)
            del x
        torch.cuda.empty_cache()
    del hub_graphs
    torch.cuda.empty_cache()


def _by_k(times):
    return "{" + ", ".join(f"{k}: {v:.3f}" for k, v in times.items()) + "}"


def hub_entry(name, source, err, ms, plain, lib, nbytes, ops, shape, k, by_k, warps,
              fill):
    """A hub kernel's ``kernels`` entry, with its arena size and, by k, its
    times and the warps an SM holds (with the hub, without).  ``nbytes`` is
    what the function must move, the same as the kernel's without the hub,
    so the bound is that kernel's; the bytes the arenas' fill reads, a cost
    of this design, are ``arena_fill_bytes`` beside it."""
    r = kernel_entry(name, source, err, ms, plain, lib, nbytes, ops, shape)
    r.update(hub_k=k, ms_by_k=by_k, warps_per_sm=warps, arena_fill_bytes=fill)
    return r


def hub_layout_fields(kind, dt, k, kk, arg_type=None):
    """A hub entry's layout fields for ``kind`` ("max_fwd", "max_bwd",
    "sum"): the arena's stages, the hub blocks an SM holds and the fill
    route at this K (spmm_kernels.hub_layout)."""
    import torch

    from plagnn_tpu_torch.ops import spmm_kernels as sk

    lay = sk.hub_layout(kind, dt, k, kk, arg_type or torch.int16)
    return {"stages": lay["stages"], "blocks_per_sm": lay["blocks_per_sm"],
            "fill_route": lay["route"]}


def hub_max_times(g0, with_hub, pairs, x, g, tag, results, smi_line):
    """Phase 3h's times at layer 1: each hub max kernel by k and at k = 0
    (its structure with an empty arena) beside the kernel without the hub
    (median of 10 each, in turns), the warps an SM holds, the arena's
    stages, blocks an SM and fill route, and its plain version at
    HUB_MAIN_K's sizes; entries for the kernels line at those sizes (with
    the spread of the runs without the hub, which "auto"'s policy reads)."""
    import torch

    from gpubench.counts import max_bwd_bytes, max_fwd_bytes
    from plagnn_tpu_torch.ops import spmm_kernels as sk
    from plagnn_tpu_torch.ops.hub import pick_hub_sizes

    n, k = x.shape
    e = g0.n_edges
    esize = x.element_size()
    main = pick_hub_sizes(str(HUB_MAIN_K), k, esize)
    _, arg0 = sk.spmm_max_fwd(g0, x)
    gz = zero_hub(g0)
    t = {"fwd": {}, "bwd": {}, "fwd0": [], "bwd0": [], "fwd_k0": [], "bwd_k0": []}
    for pair in pairs:
        gh = with_hub(pair)
        t["fwd0"].append(median_ms(lambda: sk.spmm_max_fwd(g0, x), 10))
        t["fwd"][pair[0]] = median_ms(lambda: sk.spmm_max_fwd(gh, x), 10)
        t["fwd_k0"].append(median_ms(lambda: sk.spmm_max_fwd(gz, x), 10))
        t["bwd_k0"].append(median_ms(lambda: sk.spmm_max_bwd(gz, g, arg0), 10))
        t["bwd"][pair[1]] = median_ms(lambda: sk.spmm_max_bwd(gh, g, arg0), 10)
        t["bwd0"].append(median_ms(lambda: sk.spmm_max_bwd(g0, g, arg0), 10))
    gh = with_hub(main)
    (out_p, arg_p), fwd_plain = timed_ms(lambda: sk.spmm_max_fwd_plain(gh, x))
    out_h, arg_h = sk.spmm_max_fwd(gh, x)
    if not (torch.equal(out_h, out_p) and torch.equal(arg_h, arg_p)):
        fail(f"hub max fwd {tag}: differs from its plain version")
    dx_p, bwd_plain = timed_ms(lambda: sk.spmm_max_bwd_plain(gh, g, arg0))
    bwd_err = (sk.spmm_max_bwd(gh, g, arg0).float() - dx_p.float()).abs().max().item()
    del out_p, arg_p, dx_p
    shape = bench_shape(g0, 2)
    for kind, kk, asize in (("fwd", main[0], 0), ("bwd", main[1], 2)):
        warps = {kk_: sk.hub_warps(f"max_{kind}", x.dtype, k, kk_)[0] for kk_ in t[kind]}
        warps0 = sk.hub_warps(f"max_{kind}", x.dtype, k, kk)[1]
        base = results[f"spmm_max_{kind}_{tag}"]
        fill = hub_fill_bytes(kk, k, esize, asize)
        name = f"spmm_max_{kind}_hub_{tag}"
        if kind == "fwd":
            nbytes = max_fwd_bytes(shape, k, esize)
            ops, plain, err = e * k, fwd_plain, 0.0
        else:
            nonempty = int((g0.in_degree > 0).sum().item())
            nbytes = max_bwd_bytes(shape, k, esize)
            ops, plain, err = e * k + nonempty * k, bwd_plain, bwd_err
        r = results[name] = hub_entry(
            name, f"spmm_max_{kind}", err, t[kind][kk], plain, base["library_ms"], nbytes,
            ops, (n, k), kk, t[kind], {"hub": warps, "without": warps0}, fill)
        without = statistics.median(t[f"{kind}0"])
        r.update(hub_layout_fields(f"max_{kind}", x.dtype, k, kk),
                 ms_k0=statistics.median(t[f"{kind}_k0"]), ms_without=without,
                 without_runs=t[f"{kind}0"], k0_runs=t[f"{kind}_k0"])
        print(f"  {name}: k={kk} {r['ms']:.3f} ms, without the hub {without:.3f} "
              f"(runs {[round(v, 3) for v in t[f'{kind}0']]}); k=0 {r['ms_k0']:.3f} (runs "
              f"{[round(v, 3) for v in t[f'{kind}_k0']]}); by k {_by_k(t[kind])}; "
              f"warps an SM holds {warps}, without the hub {warps0}; {r['stages']} stages, "
              f"{r['blocks_per_sm']} block(s) an SM, fill route {r['fill_route']}; plain "
              f"{plain:.3f}, library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by "
              f"{r['bound_by']} (arena fill {fill / 1e6:.1f} MB); {smi_line}", flush=True)


def hub_sum_times(g0, with_hub, pairs, x, tag, results, smi_line):
    """Phase 3h's times of the hub sum at GCN2 conv1's K, forward and
    transpose, as hub_max_times does for the max: by k and at k = 0 beside
    the kernel without the hub (median of 10 each, in turns), the warps an
    SM holds, the arena's stages, blocks an SM and fill route, and its
    plain version at HUB_MAIN_K's sizes."""
    import torch

    from gpubench.counts import sum_bytes
    from plagnn_tpu_torch.ops import spmm_kernels as sk
    from plagnn_tpu_torch.ops.hub import pick_hub_sizes

    n, k = x.shape
    e = g0.n_edges
    esize = x.element_size()
    main = pick_hub_sizes(str(HUB_MAIN_K), k, esize, 0)
    gz = zero_hub(g0)
    for transpose, kk, direction in ((False, main[0], "fwd"), (True, main[1], "bwd")):
        by_k, base_runs, k0_runs, warps = {}, [], [], {}
        for pair in pairs:
            kh = pair[1] if transpose else pair[0]
            gh = with_hub(pair)
            base_runs.append(median_ms(lambda: sk.spmm_sum_rows(g0, x, transpose), 10))
            by_k[kh] = median_ms(lambda: sk.spmm_sum_rows(gh, x, transpose), 10)
            k0_runs.append(median_ms(lambda: sk.spmm_sum_rows(gz, x, transpose), 10))
            warps[kh] = sk.hub_warps("sum", x.dtype, k, kh)[0]
        if not torch.equal(bits_of(sk.spmm_sum_rows(gz, x, transpose)),
                           bits_of(sk.spmm_sum_rows(g0, x, transpose))):
            fail(f"hub sum {direction} {tag}: k = 0 differs from the kernel without the hub")
        gh = with_hub(main)
        out_p, plain = timed_ms(lambda: sk.spmm_sum_plain(gh, x, transpose))
        err = (sk.spmm_sum_rows(gh, x, transpose).float() - out_p.float()).abs().max().item()
        fill = hub_fill_bytes(kk, k, esize)
        base = results[f"spmm_sum_{direction}_{tag}"]
        name = f"spmm_sum_{direction}_hub_{tag}"
        r = results[name] = hub_entry(
            name, "spmm_sum", err, by_k[kk], plain, base["library_ms"],
            sum_bytes(bench_shape(g0), k, esize), e * k, (n, k), kk, by_k,
            {"hub": warps, "without": sk.hub_warps("sum", x.dtype, k, kk)[1]}, fill)
        without = statistics.median(base_runs)
        r.update(hub_layout_fields("sum", x.dtype, k, kk), ms_k0=statistics.median(k0_runs),
                 ms_without=without, without_runs=base_runs, k0_runs=k0_runs)
        print(f"  {name}: k={kk} {r['ms']:.3f} ms, without the hub {without:.3f} "
              f"(runs {[round(v, 3) for v in base_runs]}); k=0 {r['ms_k0']:.3f} (runs "
              f"{[round(v, 3) for v in k0_runs]}); by k {_by_k(by_k)}; warps an SM holds "
              f"{r['warps_per_sm']}; {r['stages']} stages, {r['blocks_per_sm']} block(s) an "
              f"SM, fill route {r['fill_route']}; plain {plain:.3f}, library "
              f"{r['library_ms']:.3f}, bound {r['bound_ms']:.3f} by {r['bound_by']} (arena "
              f"fill {fill / 1e6:.1f} MB); {smi_line}", flush=True)


def same_files(label, got_dir, want_dir):
    """Every file of ``want_dir`` byte-identical in ``got_dir``."""
    names = sorted(os.listdir(want_dir))
    if sorted(os.listdir(got_dir)) != names:
        fail(f"{label}: files {sorted(os.listdir(got_dir))} against {names}")
    for f in names:
        with open(os.path.join(got_dir, f), "rb") as a, open(os.path.join(want_dir, f), "rb") as b:
            if a.read() != b.read():
                fail(f"{label}: {f} differs from the run without the hub")
    print(f"{label}: all {len(names)} files (logits included) byte-identical to the run "
          f"without the hub", flush=True)


def hub_train_phase(data_root, results, smi_line):
    """Phase 4h: the hub on the main path.  train-normal (float32) and
    train-inter --agg-dtype bfloat16 through the CLI with --hub-cache off
    and --hub-cache HUB_MAIN_K: each hub run launches each hub max kernel 3
    times an epoch and no max kernel without the hub, and writes every file
    byte-identical to the run without it; then GCN2 through train() with
    hub_cache off and HUB_MAIN_K: the sum hub kernels 2 + 2 times an
    epoch, the same files."""
    import torch

    from plagnn_tpu_torch.ops.hub import pick_hub_sizes

    runs = (("train-normal", "normal", "float32", EPOCHS_F32, "f32", 4),
            ("train-inter", "perturbation", "bfloat16", EPOCHS_BF16, "bf16", 2))
    log = os.path.join(data_root, "log")
    for cmd, subdir, agg, epochs, tag, esize in runs:
        dirs = {}
        for hub in ("off", str(HUB_MAIN_K)):
            shutil.rmtree(log, ignore_errors=True)
            pair = pick_hub_sizes(hub, FOLDS * F_IN, esize)
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            stats = train_cli(data_root, cmd, agg, epochs, hub_cache=hub)
            wall = time.perf_counter() - t0
            counts = check_launches(f"{cmd} --hub-cache {hub}",
                                    gnn32_launches(tag, epochs, pair))
            if hub != "off":
                record_launches(results, counts,
                                (f"spmm_max_fwd_hub_{tag}", f"spmm_max_bwd_hub_{tag}"))
            dirs[hub] = os.path.join(data_root, f"log_hub_{hub}")
            shutil.rmtree(dirs[hub], ignore_errors=True)
            shutil.move(os.path.join(log, "GSE30931", subdir), dirs[hub])
            report_run(f"GNN32 {cmd} {agg} --hub-cache {hub} {pair}", stats, wall, counts,
                       smi_line)
        same_files(f"{cmd} --hub-cache {HUB_MAIN_K}", dirs[str(HUB_MAIN_K)], dirs["off"])
    shutil.rmtree(log, ignore_errors=True)
    dirs = {}
    for hub in ("off", str(HUB_MAIN_K)):
        pair = pick_hub_sizes(hub, FOLDS * GCN2_HIDDEN, 4, 0)
        path = os.path.join(data_root, f"log_gcn2_hub_{hub}")
        reset_launches()
        t0 = time.perf_counter()
        stats = train_gcn2(data_root, path, hub_cache=hub)
        wall = time.perf_counter() - t0
        counts = check_launches(f"GCN2 train(hub_cache={hub!r})", gcn2_launches(pair))
        if hub != "off":
            record_launches(results, counts, ("spmm_sum_fwd_hub_f32", "spmm_sum_bwd_hub_f32"))
        dirs[hub] = path
        report_run(f"GCN2 train() float32 hub_cache={hub!r} {pair}", stats, wall, counts,
                   smi_line)
    same_files(f"GCN2 train(hub_cache={HUB_MAIN_K!r})", dirs[str(HUB_MAIN_K)], dirs["off"])


# ---------------------------------------------------------------------------
# Phase 4s: the hub on the mesh's interior pass.
# ---------------------------------------------------------------------------


def shard_hub_times(host, own_rows, k, dt, pairs, label):
    """One interior shard graph (``host``, on the host) at width K in dtype
    ``dt`` with each hub pair of ``pairs``: the -inf forward (the interior
    pass's) and the backward against the kernels without the hub
    (hub_max_equal) and against their plain versions, out, argmax and dx
    the same bits (small-integer gradients keep every float32 sum exact);
    then each hub form timed beside the form without the hub (CUDA events,
    median of 10, in turns), and at k = 0 (the structure) once.  Own rows
    relu'd and bf16-representable (ties),
    the rest zero, as the interior pass's [own | 0].  Returns the times by
    k, the forms without the hub, the plain versions' (first pair) and the
    library's, and the argmax's element size."""
    import torch

    from plagnn_tpu_torch.ops import spmm_kernels as sk

    ninf = -math.inf
    g0 = host.to(DEVICE)
    n = g0.n_nodes
    gen = torch.Generator(device=DEVICE).manual_seed(n + k)
    x = torch.zeros((n, k), device=DEVICE)
    x[:own_rows] = torch.randn((own_rows, k), generator=gen, device=DEVICE)
    x = x.to(torch.bfloat16).float().relu_().to(dt)
    g = torch.randint(-8, 9, (n, k), generator=gen, device=DEVICE).to(dt)
    t = {"fwd": {}, "bwd": {}, "fwd0": [], "bwd0": []}
    for i, pair in enumerate(pairs):
        gh = host.with_hub(*pair).to(DEVICE)
        lab = f"{label} k={pair}"
        out, arg, dx = hub_max_equal(g0, gh, x, g, lab, ninf)
        if arg.dtype != sk.arg_dtype(g0):
            fail(f"{lab}: argmax {arg.dtype}, the graph's is {sk.arg_dtype(g0)}")
        dx_p, bwd_plain = timed_ms(lambda: sk.spmm_max_bwd_plain(gh, g, arg))
        if not torch.equal(bits_of(dx), bits_of(dx_p)):
            fail(f"{lab}: hub backward differs from its plain version "
                 f"(max abs {(dx.float() - dx_p.float()).abs().max().item()})")
        del dx, dx_p
        (out_p, arg_p), fwd_plain = timed_ms(
            lambda: sk.spmm_max_fwd_plain(gh, x, empty_value=ninf))
        if not (torch.equal(bits_of(out), bits_of(out_p)) and torch.equal(arg, arg_p)):
            fail(f"{lab}: hub forward differs from its plain version")
        empty = g0.in_degree == 0
        if not (bool(torch.isneginf(out[empty].float()).all())
                and bool((arg[empty] == -1).all())):
            fail(f"{lab}: an empty row is not -inf with argmax -1")
        del out, out_p, arg_p
        if i == 0:
            t["plain"] = (fwd_plain, bwd_plain)
            t["lib"] = sliced_library_ms(g0, x, g, arg)[:2]
            gz = zero_hub(host).to(DEVICE)
            t["fwd_k0"] = median_ms(lambda: sk.spmm_max_fwd(gz, x, empty_value=ninf), 10)
            t["bwd_k0"] = median_ms(lambda: sk.spmm_max_bwd(gz, g, arg), 10)
            del gz
            t["asize"] = arg.element_size()
            # past WIDE_SLICE_FROM the forms without the hub take a narrower
            # K-slice than the hub's 1 KB: those forms at 1 KB too
            if sk.slice_bytes(n, x.element_size()) != 1024:
                t["fwd0_1kb"] = median_ms(lambda: sk.spmm_max_fwd(
                    g0, x, empty_value=ninf, force_slice=1024), 10)
            if sk.slice_bytes(n, x.element_size(), t["asize"]) != 1024:
                t["bwd0_1kb"] = median_ms(lambda: sk.spmm_max_bwd(
                    g0, g, arg, force_slice=1024), 10)
        t["fwd0"].append(median_ms(lambda: sk.spmm_max_fwd(g0, x, empty_value=ninf), 10))
        t["fwd"][pair[0]] = median_ms(lambda: sk.spmm_max_fwd(gh, x, empty_value=ninf), 10)
        t["bwd"][pair[1]] = median_ms(lambda: sk.spmm_max_bwd(gh, g, arg), 10)
        t["bwd0"].append(median_ms(lambda: sk.spmm_max_bwd(g0, g, arg), 10))
        del gh, arg
        torch.cuda.empty_cache()
    del x, g
    torch.cuda.empty_cache()
    return t


def shard_hub_entries(results, prefix, host, own_rows, k, dt, tag, main, per_rank,
                      smi_line):
    """Kernels-line entries of the hub on an interior shard at the hub pair
    ``main`` (the slowest rank's times by kind, of ``per_rank``'s
    shard_hub_times): bound the pass's work (shard_work, the bytes the
    kernel without the hub must move), the times by k, the form without
    the hub, the warps an SM holds (hub_warps) and the arenas' fill."""
    import torch

    from plagnn_tpu_torch.ops import spmm_kernels as sk

    esize = torch.finfo(dt).bits // 8
    for kind, kk, ix in (("fwd", main[0], 0), ("bwd", main[1], 1)):
        r = max(per_rank, key=lambda rr: per_rank[rr][kind][kk])
        tr = per_rank[r]
        asize = tr["asize"]
        arg_type = torch.int32 if asize == 4 else torch.int16
        work = shard_work(host[r], own_rows, k, esize, asize)
        warps = {k_: sk.hub_warps(f"max_{kind}", dt, k, k_, arg_type)[0] for k_ in tr[kind]}
        warps0 = sk.hub_warps(f"max_{kind}", dt, k, kk, arg_type)[1]
        fill = hub_fill_bytes(kk, k, esize, asize if kind == "bwd" else 0)
        name = f"spmm_max_{kind}_hub_{tag}@{prefix}_interior_k{k}"
        e = results[name] = hub_entry(
            name, f"spmm_max_{kind}", 0.0, tr[kind][kk], tr["plain"][ix], tr["lib"][ix],
            work[ix], work[2 + ix], (host[r].n_nodes, k), kk, tr[kind],
            {"hub": warps, "without": warps0}, fill)
        e.update(rank=r, ms_without=statistics.median(tr[f"{kind}0"]),
                 argmax_bytes=asize, edges=host[r].n_edges, ms_k0=tr[f"{kind}_k0"],
                 **hub_layout_fields(f"max_{kind}", dt, k, kk, arg_type))
        w0 = sk.LAUNCH_SLICES.get(
            (f"spmm_max_{kind}_{'empty_' if kind == 'fwd' else ''}{tag}", host[r].n_nodes, k))
        at_1kb = ""
        if f"{kind}0_1kb" in tr:
            e["ms_without_1kb"] = tr[f"{kind}0_1kb"]
            at_1kb = f", at 1 KB {e['ms_without_1kb']:.3f}"
        print(f"  {name}: slowest rank {r} (E {host[r].n_edges}), k={kk} {e['ms']:.3f} ms, "
              f"without the hub {e['ms_without']:.3f} at {w0} B{at_1kb}, k=0 "
              f"{e['ms_k0']:.3f}; {e['stages']} stages, {e['blocks_per_sm']} block(s) an SM, "
              f"fill route {e['fill_route']}; by k "
              f"{_by_k(tr[kind])}; warps an "
              f"SM holds {warps}, without the hub {warps0}; plain {e['plain_ms']:.3f}, "
              f"library {e['library_ms']:.3f}, bound {e['bound_ms']:.3f} by "
              f"{e['bound_by']} (arena fill {fill / 1e6:.1f} MB); {smi_line}", flush=True)


def shard_hub_kernel_phase(results, smi_line):
    """Phase 4s (a): the 24k graph partitioned at P = 2 and 4 (balanced);
    every rank's interior shard at layer 1's K = 10 x 503, f32 and bf16,
    with each of SHARD_HUB_KS halved to fit (pick_hub_sizes with the
    shard's argmax: int32 past 2^15 gather rows, as at P = 2)
    (shard_hub_times); entries at SHARD_HUB_K's sizes from the slowest
    rank."""
    import torch

    from plagnn_tpu_torch.data.synthetic import powerlaw_ppi
    from plagnn_tpu_torch.ops.hub import pick_hub_sizes
    from plagnn_tpu_torch.ops.spmm_kernels import argmax_bytes
    from plagnn_tpu_torch.parallel.partition import partition_graph

    ppi = powerlaw_ppi(NODES, EDGES, SEED)
    k = FOLDS * F_IN
    for p in SHARD_PARTS:
        pg = partition_graph(ppi.row, ppi.col, NODES, p, add_self_loops=True, balance=True)
        asize = argmax_bytes(pg.n_pad)
        host = {r: pg.shard(r).interior for r in range(p)}
        cover = {r: host[r].with_hub(SHARD_HUB_K, SHARD_HUB_K) for r in range(p)}
        print(f"P={p} interior shards (gather space {pg.n_pad} rows, argmax {8 * asize} "
              f"bits): edges {[host[r].n_edges for r in range(p)]}, k={SHARD_HUB_K} "
              f"coverage forward "
              f"{[round(cover[r].hub.n_covered / host[r].n_edges, 4) for r in range(p)]}, "
              f"transpose "
              f"{[round(cover[r].t_hub.n_covered / host[r].n_edges, 4) for r in range(p)]}",
              flush=True)
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            esize = torch.finfo(dt).bits // 8
            pairs = sorted({pick_hub_sizes(str(kk), k, esize, asize) for kk in SHARD_HUB_KS})
            per_rank = {}
            for r in range(p):
                t = per_rank[r] = shard_hub_times(host[r], pg.own_rows, k, dt, pairs,
                                                  f"P={p} rank {r} interior {tag}")
                print(f"  P={p} rank {r} interior {tag}: forward by k {_by_k(t['fwd'])} "
                      f"(without {[round(v, 3) for v in t['fwd0']]}), backward by k "
                      f"{_by_k(t['bwd'])} (without {[round(v, 3) for v in t['bwd0']]}); "
                      f"bit-equal to the kernels without the hub and to the plain "
                      f"versions at (k_fwd, k_bwd) {pairs}", flush=True)
            main = pick_hub_sizes(str(SHARD_HUB_K), k, esize, asize)
            shard_hub_entries(results, f"p{p}", host, pg.own_rows, k, dt, tag, main,
                              per_rank, smi_line)


def big_shard_hub_check(src, dst, n_real, add_self_loops, results, smi_line):
    """Phase 4s (b), in phase 4g: rank 0's interior shard of BASELINE.json
    config 5 at P = 2 (balanced), whose gather space passes 2^15 rows (an
    int32 argmax), f32 at K = BIG_FOLDS x 503 with the hub at HUB_MAIN_K's
    sizes for that argmax (shard_hub_times)."""
    import torch

    from plagnn_tpu_torch.ops.hub import pick_hub_sizes
    from plagnn_tpu_torch.ops.spmm_kernels import argmax_bytes
    from plagnn_tpu_torch.parallel.partition import partition_graph

    t0 = time.perf_counter()
    pg = partition_graph(src, dst, n_real, 2, add_self_loops=add_self_loops, balance=True)
    host = pg.shard(0).interior
    k = BIG_FOLDS * F_IN
    asize = argmax_bytes(pg.n_pad)
    if asize != 4:
        fail(f"big graph P=2 shard: gather space {pg.n_pad} rows takes no int32 argmax")
    pair = pick_hub_sizes(str(HUB_MAIN_K), k, 4, asize)
    cover = host.with_hub(*pair)
    print(f"big graph P=2 rank 0 interior: gather space {pg.n_pad} rows (C {pg.own_rows}), "
          f"E {host.n_edges}, int32 argmax, hub {pair} covers forward "
          f"{cover.hub.n_covered / host.n_edges:.4f}, transpose "
          f"{cover.t_hub.n_covered / host.n_edges:.4f}; partition and build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del cover
    t = shard_hub_times(host, pg.own_rows, k, torch.float32, [pair],
                        "big graph P=2 rank 0 interior f32")
    shard_hub_entries(results, "big_p2", {0: host}, pg.own_rows, k, torch.float32, "f32",
                      pair, {0: t}, smi_line)
    print(f"big graph P=2 interior hub {pair}: forward and backward bit-equal to the "
          f"kernels without the hub and to the plain versions ({smi_line})", flush=True)


def same_history(a, b):
    """Two runner histories equal element for element."""
    import numpy as np

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_history(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


def nccl_hub_phase(data_root, smi_line):
    """Phase 4s (c): the sharded runner on a graph axis of size 1 over a
    NCCL group of one rank (as 4m (c)), TAX_EPOCHS epochs with hub_cache
    "off" and HUB_MAIN_K from the same models: the local pass launches the
    hub kernels (3 forwards and 3 backwards an epoch, no other max kernel),
    and the probabilities and every history curve are the same bits."""
    import torch

    from plagnn_tpu_torch.data.artifacts import load_condition
    from plagnn_tpu_torch.ops.hub import pick_hub_sizes
    from plagnn_tpu_torch.ops.spmm_kernels import argmax_bytes
    from plagnn_tpu_torch.parallel.partition import partition_graph
    from plagnn_tpu_torch.parallel.sharded import make_mesh, make_sharded_fold_runner
    from plagnn_tpu_torch.train.engine import TrainConfig, fold_seed, init_fold_model
    from plagnn_tpu_torch.train.kfold import FOLD_SEEDS, fold_node_masks
    from plagnn_tpu_torch.train.losses import weight_cal
    from plagnn_tpu_torch.utils.precision import set_aggregation_dtype

    set_aggregation_dtype("float32")
    with nccl_one_rank():
        mesh = make_mesh(1, 1)
        b = load_condition(data_root, "GSE30931", "normal")
        g = b.graph
        pg = partition_graph(g.src.numpy(), g.dst.numpy(), g.n_real_nodes, 1)
        cfg = TrainConfig(fold_num=FOLDS, epoch_num=TAX_EPOCHS, verbose=False)
        tr, va = fold_node_masks(b.label_with_loc, g.n_nodes, FOLDS, FOLD_SEEDS[0])
        seeds = [fold_seed(cfg.seed, 1, f + 1, 0) for f in range(FOLDS)]
        w = weight_cal(b.loc_mat)
        n = g.n_real_nodes
        runs = {}
        for hub in ("off", str(HUB_MAIN_K)):
            pair = pick_hub_sizes(hub, FOLDS * F_IN, 4, argmax_bytes(pg.n_pad))
            shard = pg.shard(0, DEVICE, *pair)
            run = make_sharded_fold_runner(mesh, pg, shard, b.feats[:n], b.labels[:n], w,
                                           cfg, torch.device(DEVICE))
            reset_launches()
            _, _, probs, hist, ms = run(init_fold_model(cfg, F_IN, seeds, DEVICE), None,
                                        tr, va, 0.1)
            torch.cuda.synchronize()
            check_launches(f"NCCL graph=1 hub_cache={hub!r}",
                           gnn32_launches("f32", TAX_EPOCHS, pair))
            runs[hub] = (probs, hist, ms, pair)
            del shard, run
    (p0, h0, ms0, _), (p1, h1, ms1, pair) = runs["off"], runs[str(HUB_MAIN_K)]
    if not (torch.equal(bits_of(p0), bits_of(p1)) and same_history(h0, h1)):
        fail(f"NCCL graph=1 hub {pair}: probabilities or history differ from the run "
             f"without the hub (max abs {(p0 - p1).abs().max().item()})")
    print(f"NCCL graph=1 (1 rank, cuda:0, {smi_line}): hub_cache={HUB_MAIN_K!r} {pair} "
          f"epochs {[round(m, 3) for m in ms1]} ms, steady {statistics.median(ms1[1:]):.3f}; "
          f"'off' {[round(m, 3) for m in ms0]}, steady {statistics.median(ms0[1:]):.3f}; "
          f"probabilities and every history curve bit-identical", flush=True)


def cli_mesh_worker(rank, device, args, parts, result_dir):
    """One gloo rank of phase 4s (d): the CLI's rank entry
    (``cli._train_rank``, which a plain ``train-normal --mesh`` runs in
    each rank it spawns) on the parsed flags; writes its launch counts by
    counter and by pass (``parts[rank]``: interior or boundary by edge
    count) and its epoch times to result_dir."""
    from plagnn_tpu_torch import cli
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    sk.reset_launches()
    t0 = time.perf_counter()
    stats = cli._train_rank(rank, device, args, "normal")
    wall = time.perf_counter() - t0
    by_pass = {}
    for (name, _, n_edges, k), c in sk.LAUNCH_SHAPES.items():
        key = f"{name}@{parts[rank].get(n_edges, f'unknown graph of {n_edges} edges')}_k{k}"
        by_pass[key] = by_pass.get(key, 0) + c
    with open(os.path.join(result_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"counts": dict(sk.LAUNCHES), "by_pass": by_pass, "wall_s": wall,
                   "epoch_ms": [m for st in stats for m in st.epoch_ms]}, f)


def cli_mesh_hub_phase(data_root, results, smi_line):
    """Phase 4s (d): ``train-normal --mesh fold=1,graph=2`` with --hub-cache
    off and SHARD_HUB_K on 2 gloo ranks sharing cuda:0 (the CLI's flags
    through its own parser; each rank runs cli_mesh_worker, since the CLI
    itself gives each rank a card of its own), CLI_MESH_EPOCHS epochs in
    each of CLI_MESH_AGGS: every file byte-identical, and on every rank the
    hub kernels launched by the interior pass only, the kernels without
    the hub by the boundary pass (3 of each kind an epoch on each pass)."""
    import argparse

    from plagnn_tpu_torch import cli
    from plagnn_tpu_torch.data.artifacts import load_condition
    from plagnn_tpu_torch.ops import _build
    from plagnn_tpu_torch.ops.hub import pick_hub_sizes
    from plagnn_tpu_torch.ops.spmm_kernels import argmax_bytes
    from plagnn_tpu_torch.parallel.launch import spawn_local
    from plagnn_tpu_torch.parallel.partition import partition_graph

    _build.build_all()     # the ranks load the libraries; none builds
    g = load_condition(data_root, "GSE30931", "normal").graph
    pg = partition_graph(g.src.numpy(), g.dst.numpy(), g.n_real_nodes, 2, balance=True)
    parts = [{len(pg.interior_edges[r][0]): "interior", len(pg.boundary_edges[r][0]):
              "boundary"} for r in range(2)]
    k = FOLDS * F_IN
    per = LAYERS * CLI_MESH_EPOCHS
    log = os.path.join(data_root, "log")
    for agg, tag, esize in CLI_MESH_AGGS:
        dirs = {}
        for hub in ("off", str(SHARD_HUB_K)):
            shutil.rmtree(log, ignore_errors=True)
            kf, kb = pick_hub_sizes(hub, k, esize, argmax_bytes(pg.n_pad))
            ap = argparse.ArgumentParser()
            cli._add_train_flags(ap)
            args = ap.parse_args([
                "-data", "GSE30931", "--data-root", data_root, "-e", str(CLI_MESH_EPOCHS),
                "--rounds", "1", "-f", str(FOLDS), "--fold-batch", str(FOLDS),
                "--agg-dtype", agg, "--mesh", "fold=1,graph=2", "--hub-cache", hub])
            res_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_mesh_")
            reset_launches()
            t0 = time.perf_counter()
            spawn_local(cli_mesh_worker, 2, backend="gloo", devices=[f"{DEVICE}:0"] * 2,
                        rdzv_dir=res_dir, args=(args, parts, res_dir),
                        timeout_s=MESH_TIMEOUT_S)
            wall = time.perf_counter() - t0
            if any(launch_counts().values()):
                fail(f"CLI mesh {tag} --hub-cache {hub}: the parent launched kernels")
            ranks = []
            for r in range(2):
                with open(os.path.join(res_dir, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            shutil.rmtree(res_dir, ignore_errors=True)
            fwd_int = f"spmm_max_fwd_{'hub' if kf else 'empty'}_{tag}"
            bwd_int = f"spmm_max_bwd_{'hub_' if kb else ''}{tag}"
            want = {}
            for name in (fwd_int, f"spmm_max_fwd_empty_{tag}", bwd_int,
                         f"spmm_max_bwd_{tag}"):
                want[name] = want.get(name, 0) + per
            label = f"CLI mesh fold=1,graph=2 {agg} --hub-cache {hub} ({kf}, {kb})"
            for r, rr in enumerate(ranks):
                for name, c in rr["counts"].items():
                    if c != want.get(name, 0):
                        fail(f"{label}: rank {r} launched {name} {c} times, expected "
                             f"{want.get(name, 0)}")
                for key, c in rr["by_pass"].items():
                    counter, where = key.split("@")
                    if ("_hub_" in counter) != (kf > 0 and where.startswith("interior")):
                        fail(f"{label}: rank {r} launched {counter} {c} times on the "
                             f"{where} pass")
            if kf:
                for kind in ("fwd", "bwd"):
                    name = f"spmm_max_{kind}_hub_{tag}@p2_interior_k{k}"
                    c = sum(rr["by_pass"].get(f"spmm_max_{kind}_hub_{tag}@interior_k{k}", 0)
                            for rr in ranks)
                    if name in results:
                        results[name]["launches"] = c
            ep = ranks[0]["epoch_ms"]
            print(f"{label}: 2 gloo ranks on one card ({smi_line}), epoch ms "
                  f"{[round(m, 3) for m in ep]} (rank 0), run wall {wall:.1f} s with spawn, "
                  f"launches by pass (rank 0) {ranks[0]['by_pass']}", flush=True)
            dirs[hub] = os.path.join(data_root, f"log_cli_mesh_{tag}_{hub}")
            shutil.rmtree(dirs[hub], ignore_errors=True)
            shutil.move(os.path.join(log, "GSE30931", "normal"), dirs[hub])
        same_files(f"CLI mesh fold=1,graph=2 {agg} --hub-cache {SHARD_HUB_K}",
                   dirs[str(SHARD_HUB_K)], dirs["off"])
    shutil.rmtree(log, ignore_errors=True)


def mesh_hub_phase(data_root, results, smi_line):
    """Phase 4s (a), (c) and (d) on a synthetic 24k bundle; (b) runs in
    phase 4g on its graph."""
    phase("4s hub cache on the mesh's interior pass")
    shard_hub_kernel_phase(results, smi_line)
    nccl_hub_phase(data_root, smi_line)
    cli_mesh_hub_phase(data_root, results, smi_line)


def mesh_hub_only(smi_line):
    """``--only-mesh-hub``: phase 4s on a synthetic bundle of its own, (b)
    on config 5's edges from powerlaw_ppi (the graph ``synth`` writes)
    with their self-loops; prints the phase's kernels entries."""
    from plagnn_tpu_torch import cli
    from plagnn_tpu_torch.data.synthetic import powerlaw_ppi

    results = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cli.main(["synth", "--data-root", tmp, "--nodes", str(NODES),
                  "--edges", str(EDGES), "--seed", str(SEED)])
        mesh_hub_phase(tmp, results, smi_line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase("4s (b) big graph shard")
    ppi = powerlaw_ppi(BIG_NODES, BIG_EDGES, SEED)
    big_shard_hub_check(ppi.row, ppi.col, BIG_NODES, True, results, smi_line)
    print(json.dumps({"kernels": list(results.values())}))


def hub_only(smi_line):
    """``--only-hub``: phase 3's layer-1 checks on the full graph (its
    kernels' entries), phase 3h and phase 4h on a bundle of its own; prints
    the hub entries."""
    import numpy as np
    import torch

    from plagnn_tpu_torch import cli
    from plagnn_tpu_torch.data.synthetic import powerlaw_ppi
    from plagnn_tpu_torch.ops.graph_format import from_scipy_coo

    full = from_scipy_coo(powerlaw_ppi(NODES, EDGES, SEED), add_self_loops=True)
    rng = np.random.default_rng(SEED)
    x_full = rng.standard_normal((full.n_nodes, FOLDS * F_IN), dtype=np.float32)
    x_full = torch.from_numpy(x_full).cuda().to(torch.bfloat16).float().relu_()
    results = {}
    full_cuda = full.to("cuda")
    check_kernels(full_cuda, x_full, "full graph layer 1", results)
    check_sum_kernels(full_cuda, FOLDS * SUM_WIDTHS[0], "full graph GCN2 conv1", results)
    del full_cuda
    phase("3h hub cache kernels")
    hub_kernel_phase(full, x_full, results, smi_line)
    del x_full
    torch.cuda.empty_cache()
    phase("4h hub cache on the main path")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cli.main(["synth", "--data-root", tmp, "--nodes", str(NODES),
                  "--edges", str(EDGES), "--seed", str(SEED)])
        hub_train_phase(tmp, results, smi_line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"kernels": [r for name, r in results.items() if "_hub_" in name]}))


def dma_equal(dc, x, idx, ng, g, label):
    """The probe's kernel against its plain version on the same inputs: bit
    for bit (it copies rows).  Returns the largest difference."""
    import torch

    out = dc.dma_ring(x, idx, ng, g)
    if out.is_cuda:
        torch.cuda.synchronize()
    want = dc.dma_ring_plain(x, idx, ng, g)
    err = float((out - want).abs().max())
    if not torch.equal(out, want):
        fail(f"{label}: dma_ring differs from its plain version (max |diff| {err})")
    return err


def dma_point(dc, bench, row_bytes, pattern, n_rows, results):
    """One point of phase 3d's sweep on ``bench`` (a build_bench result):
    the kernel against its plain version, then timed through ``measure``
    with the launch counter set to 0 just before and read just after; its
    plain version, ``torch.index_select`` into a buffer and the compulsory
    bytes' bound on the same inputs."""
    import torch

    _, n_fetch, (idx, x, g) = bench
    name = f"dma_ring_f32@{row_bytes}B/{n_rows}/{pattern}"
    err = dma_equal(dc, x, idx, DMA_RING, g, name)
    dc.reset_launches()
    rec = dc.measure(row_bytes, DMA_RING, pattern, n_rows, reps=DMA_REPS, device=x.device,
                     bench=bench)
    launches = dc.LAUNCHES["dma_ring_f32"]
    if not launches:
        fail(f"{name}: the sweep launched no kernel")
    plain = median_ms(lambda: dc.dma_ring_plain(x, idx, DMA_RING, g), 3)
    buf = torch.empty((n_fetch, x.shape[1]), device=x.device)
    lib = median_ms(lambda: torch.index_select(x, 0, idx, out=buf), DMA_REPS)
    del buf
    distinct = int(torch.unique(idx).numel())
    nbytes = distinct * row_bytes + n_fetch * 4 + g * row_bytes
    entry = kernel_entry(name, "dma_ceiling", err, rec["ms"], plain, lib, nbytes, 0,
                         (n_rows, row_bytes // 4, n_fetch, DMA_RING, g))
    entry.update(launches=launches, gbps=rec["gbps"], gbps_lo=rec["gbps_lo"],
                 gbps_hi=rec["gbps_hi"], distinct_rows=distinct,
                 table_bytes=rec["table_bytes"], fits_l2=rec["fits_l2"])
    results[name] = entry
    print(f"  {name}: {rec['ms']:.4f} ms ({rec['gbps']:.1f} GB/s service rate, "
          f"[{rec['gbps_lo']:.1f}, {rec['gbps_hi']:.1f}]; g {g}, {n_fetch} rows, "
          f"{distinct} distinct, table {rec['table_bytes'] / 2**20:.1f} MiB"
          f"{'' if rec['fits_l2'] else ' > L2'}) | bound {entry['bound_ms']:.4f} | "
          f"plain {plain:.4f} | index_select {lib:.4f} | launches {launches}", flush=True)


def dma_phase(results, smi_line, full=None):
    """Phase 3d: the gather probe bit-equal to its plain version at every
    shape of the module's CHECK_SHAPES, random and sequential ids; then its
    short sweep at ring depth DMA_RING (dma_point): rows of DMA_WIDTHS over
    tables of DMA_TABLES rows, random and sequential, at least DMA_TARGET_MB
    MiB a launch, and the 24k graph's source ids in edge order at
    DMA_EDGE_WIDTHS.  Its rate is a service rate, not a roofline share.
    ``full``: the 24k synthetic graph (built here where not given)."""
    import torch

    from plagnn_tpu_torch.bench import dma_ceiling as dc

    t0 = time.perf_counter()
    for row_bytes, ng, g, windows in dc.CHECK_SHAPES:
        print(f"  check {row_bytes} B ng {ng} g {g}: {windows} windows over a grid of "
              f"{dc.grid_blocks(row_bytes, ng, g, DEVICE)} blocks", flush=True)
        for pattern in ("random", "sequential"):
            _, _, (idx, x, _) = dc.build_bench(dc.CHECK_ROWS, row_bytes, windows * dc.T_E, ng,
                                               pattern, device=DEVICE, g=g)
            dma_equal(dc, x, idx, ng, g,
                      f"{row_bytes} B ng {ng} g {g} {windows} windows {pattern}")
    print(f"dma_ring bit-equal to its plain version at {len(dc.CHECK_SHAPES)} shapes x 2 "
          f"orders ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"sweep at ring depth {DMA_RING}, {DMA_TARGET_MB} MiB a launch, median of "
          f"{DMA_REPS} by CUDA events ({smi_line}):", flush=True)
    for n_rows in DMA_TABLES:
        for pattern in ("random", "sequential"):
            for row_bytes in DMA_WIDTHS:
                n_fetch = dc.sweep_fetch(row_bytes, DMA_RING, DMA_TARGET_MB, DEVICE)
                dma_point(dc, dc.build_bench(n_rows, row_bytes, n_fetch, DMA_RING, pattern,
                                             device=DEVICE, rng="torch"),
                          row_bytes, pattern, n_rows, results)
                if DEVICE == "cuda":
                    torch.cuda.empty_cache()
    if full is None:
        from plagnn_tpu_torch.data.synthetic import powerlaw_ppi
        from plagnn_tpu_torch.ops.graph_format import from_scipy_coo

        full = from_scipy_coo(powerlaw_ppi(NODES, EDGES, SEED), add_self_loops=True)
    src = full.src.to(DEVICE)
    for row_bytes in DMA_EDGE_WIDTHS:
        dma_point(dc, dc.build_bench(full.n_nodes, row_bytes, 0, DMA_RING, "edges",
                                     device=DEVICE, rng="torch", ids=src),
                  row_bytes, "edges", full.n_nodes, results)
    dc.reset_launches()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    print(f"phase 3d: {time.perf_counter() - t0:.1f} s", flush=True)


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
    ap.add_argument("--only-mesh", action="store_true",
                    help="phases 1-2, the single-card train-normal float32 run "
                         "and phase 4m; prints no result line")
    ap.add_argument("--only-planner", action="store_true",
                    help="phases 1-2, phase 4m (c) and phase 4q (the planner's "
                         "anchors and --mesh auto); prints no result line")
    ap.add_argument("--only-mesh-hub", action="store_true",
                    help="phases 1-2 and phase 4s (the hub on the mesh's interior "
                         "pass; its (b) on config 5's edges); prints its kernels "
                         "entries and no result line")
    ap.add_argument("--only-dma-ceiling", action="store_true",
                    help="phases 1-2 and phase 3d (the gather probe: checks and "
                         "its short sweep); prints its kernels entries and no "
                         "result line")
    ap.add_argument("--only-gcn-sum", action="store_true",
                    help="phases 1-2 and phase 3g (GCN's scaled sum, kernel-table row "
                         "3d, at 24k and 330k nodes); prints its kernels entries and "
                         "no result line")
    ap.add_argument("--only-gat", action="store_true",
                    help="phases 1-2 and phase 3i (GAT's edge-softmax pair, kernel-table "
                         "row 11, at the GAT cell's widths, and a GAT train() run's "
                         "launches); prints its kernels entries and no result line")
    ap.add_argument("--only-big-graph", action="store_true",
                    help="phases 1-2 and phase 4g (the big-graph path); prints "
                         "no result line")
    ap.add_argument("--only-hub", action="store_true",
                    help="phases 1-2, phase 3's layer-1 checks on the full graph, "
                         "phase 3h and phase 4h; prints the hub entries and no "
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
    if args.only_mesh:
        mesh_only(smi_line)
        return
    if args.only_planner:
        planner_only(smi_line)
        return
    if args.only_mesh_hub:
        mesh_hub_only(smi_line)
        return
    if args.only_hub:
        hub_only(smi_line)
        return
    if args.only_dma_ceiling:
        phase("3d dma ceiling")
        results = {}
        dma_phase(results, smi_line)
        print(json.dumps({"kernels": list(results.values())}))
        return
    if args.only_gcn_sum:
        phase("3g GCN scaled sum")
        results = {}
        gcn_sum_phase(results, smi_line)
        print(json.dumps({"kernels": list(results.values())}))
        return
    if args.only_gat:
        phase("3i GAT edge-softmax pair")
        results = {}
        gat_phase(results)
        from plagnn_tpu_torch import cli

        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            cli.main(["synth", "--data-root", tmp, "--nodes", str(NODES),
                      "--edges", str(EDGES), "--seed", str(SEED)])
            check_gat_train(tmp, results, smi_line)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"kernels": list(results.values())}))
        return
    if args.only_big_graph:
        phase("4g big graph")
        big_graph_phase({}, smi_line)
        return
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
    # segment sum: GCN2's widths, conv1 timed
    check_sum_kernels(graph.to("cuda"), vals.shape[1], "tie graph")
    check_sum_kernels(full_cuda, FOLDS * SUM_WIDTHS[0], "full graph GCN2 conv1", results)
    # conv2's narrow rows: its float32 entries go into the kernels line too
    check_sum_kernels(full_cuda, FOLDS * SUM_WIDTHS[1], "full graph GCN2 conv2",
                      results, suffix=CONV2)
    del full_cuda
    torch.cuda.empty_cache()
    phase("3g GCN scaled sum")
    gcn_sum_phase(results, smi_line, full)
    phase("3i GAT edge-softmax pair")
    gat_phase(results, full)
    phase("3h hub cache kernels")
    hub_kernel_phase(full, x_full, results, smi_line)
    del x_full
    torch.cuda.empty_cache()
    # the edge-weighted sum at conv1's width
    check_val_sum_kernels(weighted_graph(powerlaw_ppi(NODES, EDGES, SEED), SEED),
                          FOLDS * SUM_WIDTHS[0], "full graph weighted", results)
    torch.cuda.empty_cache()
    phase("3d dma ceiling")
    dma_phase(results, smi_line, full)
    if args.only_kernels:
        print(json.dumps({"kernels": list(results.values())}))
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
        phase("4f figures at full width")
        figures_phase(tmp, results, smi_line)
        phase("4c GCN2 at full width")
        check_gcn2(tmp, results, smi_line)
        phase("3i GAT train()")
        check_gat_train(tmp, results, smi_line)
        # phase 4's train-normal float32 run is the single-card run of the
        # sharded runs' jobs
        tax_ms = mesh_phase(tmp, results, smi_line)
        phase("4q planner anchors and --mesh auto")
        planner_phase(tmp, tax_ms, smi_line)
        phase("4h hub cache on the main path")
        hub_train_phase(tmp, results, smi_line)
        mesh_hub_phase(tmp, results, smi_line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase("4p preprocess at full width")
    preprocess_phase(results, smi_line)
    phase("4o other ops at full width")
    other_ops_phase(results, smi_line)
    phase("4g big graph")
    big_graph_phase(results, smi_line)

    phase("5 summary")
    kernels = [results[k] for k in (
        "spmm_max_fwd_f32", "spmm_max_fwd_bf16", "spmm_max_fwd_noarg_f32",
        "spmm_max_bwd_f32", "spmm_max_bwd_bf16",
        "spmm_sum_fwd_f32", "spmm_sum_fwd_bf16", "spmm_sum_bwd_f32", "spmm_sum_bwd_bf16",
        "spmm_sum_fwd_f32" + CONV2, "spmm_sum_bwd_f32" + CONV2,
        "spmm_sum_gcn_fwd_f32", "spmm_sum_gcn_fwd_bf16", "spmm_sum_gcn_bwd_f32",
        "spmm_sum_gcn_bwd_bf16", "spmm_sum_gcn_fwd_f32" + CONV2, "spmm_sum_gcn_bwd_f32" + CONV2,
        "pcc_diff_count_f64", "pcc_diff_hits_f64", "ecc_common_neighbors_i32",
        "pcc_diff_hist_f64", "spmm_sum_val_fwd_f32", "spmm_sum_val_bwd_f32",
        "spmm_sum_val_fwd_bf16", "spmm_sum_val_bwd_bf16",
        "spmm_max_fwd_pos_f32", "spmm_max_fwd_pos_bf16",
        "spmm_max_bwd_pos_f32", "spmm_max_bwd_pos_bf16",
        "spmm_max_fwd_hub_f32", "spmm_max_fwd_hub_bf16",
        "spmm_max_bwd_hub_f32", "spmm_max_bwd_hub_bf16",
        "spmm_sum_fwd_hub_f32", "spmm_sum_fwd_hub_bf16",
        "spmm_sum_bwd_hub_f32", "spmm_sum_bwd_hub_bf16",
        "spmm_gat_fwd_f32", "spmm_gat_bwd_f32")]
    kernels += [r for name, r in sorted(results.items()) if "@" in name]
    for r in kernels:
        # library_ms is None where no one library call computes the function
        if not all(math.isfinite(r[k]) for k in ("ms", "plain_ms", "bound_ms", "library_ms")
                   if r[k] is not None or k != "library_ms"):
            fail(f"{r['name']}: non-finite timing")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
