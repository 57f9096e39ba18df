#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (plagnn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc.  Phases, in order; any failure exits nonzero:

1. Device: the card's name and power limit (nvidia-smi).
2. Build: the kernels in plagnn_tpu_torch/csrc, from source, one nvcc each.
3. Kernels against their plain PyTorch versions on the card, on a small
   tie-heavy graph and on the full synthetic PPI graph at each width the
   main path aggregates (B=10 folds x F=503, 400, 300): forward out and
   argmax bit-exact; float32 dx within 1e-5 of the summed hit magnitudes
   (the two sum the same hits in float32 in different orders); bfloat16 dx
   within 1 bf16 ulp.  At the layer-1 shape, times each kernel (CUDA
   events, median), its plain version and a PyTorch library call.
4. The slice at full width through the CLI: synth (24,041 nodes, 700k
   edges), train-normal (float32, 3 epochs, 10 folds in one batch), then
   train-inter with --agg-dtype bfloat16 (2 epochs).  Each run must launch
   each of its kernels 3 times per epoch (3 SAGE-pool layers) and write the
   artifact contract with finite logits.
   Then the float32 train-normal run once more under torch.profiler:
   device time per epoch by kernel group and the device's idle share.
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
KERNEL_SOURCE = {
    "spmm_max_fwd": "plagnn_tpu_torch/csrc/spmm_max_fwd.cu",
    "spmm_max_bwd": "plagnn_tpu_torch/csrc/spmm_max_bwd.cu",
}
REPLACES = {
    "spmm_max_fwd_f32": "plagnn_tpu/ops/pallas/spmm_kernels.py:513",
    "spmm_max_fwd_bf16": "plagnn_tpu/ops/pallas/spmm_kernels.py:513",
    "spmm_max_bwd_f32": "plagnn_tpu/ops/pallas/spmm_kernels.py:982",
    "spmm_max_bwd_bf16": "plagnn_tpu/ops/pallas/spmm_kernels.py:1270",
}
NODES, EDGES, SEED = 24041, 700000, 70
FOLDS, F_IN = 10, 503
EPOCHS_F32, EPOCHS_BF16 = 3, 2
LAYERS = 3
AGG_WIDTHS = (F_IN, 400, 300)  # per-fold width of each SAGE-pool aggregation
SETUP_COPIES = "host<->device copies (data in, history out; not per epoch)"


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
        out_k, arg_k = sk.spmm_max_fwd(graph, x)
        torch.cuda.synchronize()
        out_p, arg_p = sk.spmm_max_fwd_plain(graph, x)
        if not torch.equal(out_k, out_p):
            fail(f"{label}: fwd {tag} out differs from plain "
                 f"(max abs {(out_k.float() - out_p.float()).abs().max().item()})")
        if not torch.equal(arg_k, arg_p):
            fail(f"{label}: fwd {tag} argmax differs from plain "
                 f"({(arg_k != arg_p).sum().item()} elements)")
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
        print(f"{label}: {tag} fwd out/arg bit-exact, bwd max abs err {bwd_err:.3e}",
              flush=True)
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
        for name, ms, plain, lib, nbytes, ops, gather in (
            (f"spmm_max_fwd_{tag}", fwd_ms, fwd_plain_ms, fwd_lib_ms,
             fwd_bytes, fwd_ops, e * k * esize + n * k * (esize + asize)),
            (f"spmm_max_bwd_{tag}", bwd_ms, bwd_plain_ms, bwd_lib_ms,
             bwd_bytes, bwd_ops, e * k * (esize + asize) + n * k * esize),
        ):
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / FP32_OPS_PER_S * 1e3
            results[name] = {
                "name": name,
                "route": "cuda",
                "source": KERNEL_SOURCE[name.rsplit("_", 1)[0]],
                "replaces": REPLACES[name],
                "launches": None,
                "max_abs_err": fwd_err if "fwd" in name else bwd_err,
                "ms": ms,
                "plain_ms": plain,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib,
                "shape": [n, k],
            }
            print(f"  {name}: {ms:.3f} ms (plain {plain:.3f}, library {lib:.3f}, "
                  f"bound {max(t_bytes, t_ops):.3f} by bytes, no-reuse gather "
                  f"{gather / HBM_BYTES_PER_S * 1e3:.3f})", flush=True)


def train_cli(data_root, cmd, agg, epochs):
    """One training run through the CLI, as a user calls it."""
    from plagnn_tpu_torch import cli

    return cli.main([cmd, "-data", "GSE30931", "--data-root", data_root,
                     "-e", str(epochs), "--rounds", "1", "-f", str(FOLDS),
                     "--fold-batch", str(FOLDS), "--agg-dtype", agg])


def check_launches(label, tag, epochs):
    """Each kernel of the run's dtype launched once per layer per epoch,
    the other dtype's not at all; returns the counts."""
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    counts = dict(sk.LAUNCHES)
    for name, c in counts.items():
        want = LAYERS * epochs if name.endswith(tag) else 0
        if c != want:
            fail(f"{label}: {name} launched {c} times, expected {want}")
    return counts


def profile_epochs(data_root, smi_line):
    """torch.profiler over a float32 train-normal run through the CLI:
    device time per epoch by kernel group, and the device's idle share
    against the steady epoch time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from plagnn_tpu_torch.ops import spmm_kernels as sk

    # the earlier run's artifacts would make this one resume past its round
    shutil.rmtree(os.path.join(data_root, "log"))
    sk.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stats = train_cli(data_root, "train-normal", "float32", EPOCHS_F32)
    check_launches("profiled train-normal", "f32", EPOCHS_F32)
    ms =[m for s in stats for m in s.epoch_ms]
    groups = {}
    top = []
    for ev in prof.key_averages():
        # device-side events only: the op that launched a kernel reports
        # the same time as its own
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us <= 0:
            continue
        name = ev.key
        low = name.lower()
        if "spmm_max" in low:
            grp = "spmm_max kernels"
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
        groups[grp] = groups.get(grp, 0.0) + us / 1e3 / len(ms)
        top.append((us / 1e3 / len(ms), ev.count // len(ms), name[:90]))
    steady = statistics.median(ms[1:])
    busy = sum(t for grp, t in groups.items() if grp != SETUP_COPIES)
    if busy <= 0:
        print("profile: no device time in the trace (not measured)")
        return
    print(f"profile (train-normal f32, {len(ms)} epochs x {FOLDS} folds, AUC sampled "
          f"at epochs 0 and {len(ms) - 1}, {smi_line}): steady {steady:.3f} ms/epoch "
          f"wall, {busy:.3f} ms/epoch device busy, idle share "
          f"{max(0.0, 1 - busy / steady):.3f}", flush=True)
    for grp, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {grp}: {t:.3f} ms/epoch ({t / steady:.3f} of steady wall)")
    for t, cnt, name in sorted(top, reverse=True)[:12]:
        print(f"  kernel {t:8.3f} ms/epoch  x{cnt:<4} {name}")


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


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only-kernels", action="store_true",
                    help="stop after phase 3 (build and kernel checks); "
                         "prints no result line")
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"build: {build_s:.1f} s ({len(logs)} compiled)", flush=True)

    phase("3 kernels vs plain")
    from plagnn_tpu_torch.data.synthetic import powerlaw_ppi
    from plagnn_tpu_torch.ops import spmm_kernels as sk
    from plagnn_tpu_torch.ops.graph_format import from_scipy_coo

    graph, vals = tie_graph()
    check_kernels(graph.to("cuda"), torch.from_numpy(vals).cuda(), "tie graph")
    full = from_scipy_coo(powerlaw_ppi(NODES, EDGES, SEED), add_self_loops=True)
    print(f"full graph: N_pad {full.n_nodes}, E {full.n_edges}, max in-degree "
          f"{int(full.in_degree.max())}", flush=True)
    rng = np.random.default_rng(SEED)
    x_full = rng.standard_normal((full.n_nodes, FOLDS * F_IN), dtype=np.float32)
    # relu of bf16-representable values: ties at 0, identical in f32 and bf16
    x_full = torch.from_numpy(x_full).cuda().to(torch.bfloat16).float().relu_()
    full_cuda = full.to("cuda")
    results = {}
    check_kernels(full_cuda, x_full, "full graph layer 1", results)
    # the main path's other widths (layers 2 and 3): checked, not timed
    for layer, width in enumerate(AGG_WIDTHS[1:], start=2):
        check_kernels(full_cuda, x_full[:, :FOLDS * width].contiguous(),
                      f"full graph layer {layer}")
    del x_full, full_cuda
    torch.cuda.empty_cache()
    if args.only_kernels:
        print(json.dumps({"kernels": list(results.values())}))
        return

    phase("4 slice at full width")
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
            sk.reset_launches()
            t0 = time.perf_counter()
            stats = train_cli(tmp, cmd, agg, epochs)
            wall = time.perf_counter() - t0
            counts = check_launches(f"{cmd} --agg-dtype {agg}", tag, epochs)
            for name, c in counts.items():
                if c:
                    results[name]["launches"] = c
            d = os.path.join(tmp, "log", "GSE30931", subdir)
            for f in range(1, FOLDS + 1):
                p = os.path.join(d, f"1_{f}_loc_logits.npy")
                if not os.path.exists(p):
                    fail(f"{cmd}: missing {p}")
                lg = np.load(p)
                if lg.shape != (NODES, 12) or not np.isfinite(lg).all():
                    fail(f"{cmd}: {p} has shape {lg.shape} or non-finite values")
            for fname in ("log.tsv", "txt_log.txt", "fig_data_1.json"):
                if not os.path.exists(os.path.join(d, fname)):
                    fail(f"{cmd}: missing {fname}")
            ep = [m for s in stats for m in s.epoch_ms]
            steady = statistics.median(ep[1:]) if len(ep) > 1 else ep[0]
            print(f"slice {cmd} {agg}: {len(ep)} epochs x {FOLDS} folds, "
                  f"epoch ms {[round(m, 3) for m in ep]}, steady {steady:.3f} ms/epoch, "
                  f"run wall {wall:.1f} s, launches {counts}, "
                  f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                  f"on {smi_line}", flush=True)
        phase("4b profile")
        profile_epochs(tmp, smi_line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    phase("5 summary")
    kernels = [results[k] for k in ("spmm_max_fwd_f32", "spmm_max_fwd_bf16",
                                    "spmm_max_bwd_f32", "spmm_max_bwd_bf16")]
    for r in kernels:
        if not all(math.isfinite(r[k]) for k in ("ms", "plain_ms", "bound_ms")):
            fail(f"{r['name']}: non-finite timing")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
