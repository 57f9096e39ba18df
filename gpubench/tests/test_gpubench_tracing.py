"""The reduction of a Chrome trace to the window's device numbers."""
import json

from gpubench.tracing import BLOCK, read_trace


def _write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_block_kernels_union_gaps_and_lost_launches(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": BLOCK, "ts": 100, "dur": 900},
        # a warm-up launch before the block: not read
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 50, "dur": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "warm", "ts": 60, "dur": 5,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 150, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 160, "dur": 2,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 200, "dur": 300,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 170, "dur": 2,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "relu", "ts": 400, "dur": 200,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 610, "dur": 300},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 620, "dur": 2,
         "args": {"correlation": 4}},
    ]
    t = read_trace(_write(tmp_path, ev))
    assert [k[0] for k in t.kernels] == ["gemm", "relu"]
    assert t.window == (100, 1000) and abs(t.window_s - 900e-6) < 1e-15
    assert abs(t.busy_s - 400e-6) < 1e-15          # [200, 600): the kernels overlap
    assert t.lost == 1                             # correlation 4 ran no kernel
    gaps = dict(t.idle_gaps())
    assert abs(gaps["aten::mm"] - 100e-6) < 1e-15  # [100, 200)
    assert abs(gaps["aten::sort"] - 400e-6) < 1e-15
    assert t.device_ops()[0][0] == "gemm"
