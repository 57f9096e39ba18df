"""No run of the harness loads JAX or the JAX package, and the reference
loads nothing of the port; checked in fresh interpreters (names compared
whole: the port's name starts with the JAX package's)."""
import os
import re
import subprocess
import sys

from gpubench.harness import BENCH_DIR, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "plagnn_tpu")

RUN_TINY = """
import sys, time
sys.path.insert(0, {root!r})
from gpubench.harness import run_cell
from gpubench.tests.tiny import tiny_cell
run_cell(tiny_cell("gnn32_ppi24k"), 5, 0.1, False, "cpu", time.perf_counter())
print(sorted({{m.split(".")[0] for m in sys.modules}} & set({bad!r})))
"""

REFERENCE_ONLY = """
import sys
sys.path.insert(0, {root!r})
from gpubench.harness import load_cell
from gpubench.inputs import make_inputs
from gpubench.reference.metrics import metric_rows
from gpubench.reference.model import PlainGraph, train_steps
c = load_cell("gcn2_ppi24k")
t = dict(c.traffic, nodes=200, edges=1200, fold_batch=2)
cfg = dict(c.config, fold_num=4)
i = make_inputs(cfg, t, 3, "cpu")
g = PlainGraph.build(i.src, i.dst, i.n, True)
s = train_steps(cfg, g, i.feats[:i.n], i.labels[:i.n], i.train_masks[:, :i.n], i.weights, 2)
metric_rows(s.probs, i.labels[:i.n], i.train_masks[:, :i.n], i.val_masks[:, :i.n], 0.1, 5, 200)
print(sorted({{m.split(".")[0] for m in sys.modules}} & set({bad!r})))
"""


def _fresh(code):
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_no_jax_package():
    assert _fresh(RUN_TINY.format(root=str(ROOT), bad=FORBIDDEN)) == "[]"


def test_the_reference_loads_nothing_of_the_port():
    bad = FORBIDDEN + ("plagnn_tpu_torch",)
    assert _fresh(REFERENCE_ONLY.format(root=str(ROOT), bad=bad)) == "[]"


def test_sources_import_no_jax_package_and_reference_no_port():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|plagnn_tpu|benchmarks|bench)"
                     r"(\.|\s|,|$)", re.MULTILINE)
    # the reference imports only itself (one leading dot) and the libraries
    port = re.compile(r"^\s*(import|from)\s+(plagnn_tpu_torch|gpubench|\.\.)", re.MULTILINE)
    for base, _, files in os.walk(BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            src = open(os.path.join(base, f)).read()
            assert not pat.search(src), f
            if os.path.basename(base) == "reference":
                assert not port.search(src), f


def test_run_without_a_card_or_the_port_prints_no_result(tmp_path):
    # this machine has no card: the run fails before any result
    r = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "gnn32_ppi24k",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout.strip() == ""
