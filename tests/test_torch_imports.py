"""Import rules of the PyTorch port: no JAX, nothing of plagnn_tpu or of the
benchmarks folder, none of sklearn, pandas or matplotlib (the card's
machine has none of them), and entry points that refuse to fall back to the
CPU."""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "plagnn_tpu_torch")

# whole module names only: plagnn_tpu_torch must not match plagnn_tpu
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|plagnn_tpu|benchmarks|sklearn|pandas|matplotlib)"
    r"(\.|\s|,|$)",
    re.MULTILINE)


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PKG):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return paths


def test_import_closure_has_no_jax_or_reference_package():
    # a fresh interpreter: this test process already imported jax (conftest)
    code = (
        "import importlib, pkgutil, sys\n"
        "import plagnn_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    plagnn_tpu_torch.__path__, 'plagnn_tpu_torch.')]\n"
        "assert 'plagnn_tpu_torch.cli' in mods, mods\n"
        "assert {'plagnn_tpu_torch.parallel.' + m for m in\n"
        "        ('partition', 'multihost', 'launch', 'sharded', 'planner')\n"
        "        } <= set(mods), mods\n"
        "assert 'plagnn_tpu_torch.bench.dma_ceiling' in mods, mods\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'plagnn_tpu', 'benchmarks', 'sklearn',\n"
        "              'pandas', 'matplotlib'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_have_no_forbidden_imports():
    offenders = []
    for p in _port_sources():
        with open(p) as f:
            src = f.read()
        offenders += [f"{p}: {m.group(0).strip()}" for m in FORBIDDEN.finditer(src)]
    assert not offenders, offenders


def test_forbidden_pattern_is_prefix_safe():
    assert FORBIDDEN.search("import plagnn_tpu.cli")
    assert FORBIDDEN.search("from plagnn_tpu import cli")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from sklearn.metrics import roc_auc_score")
    assert FORBIDDEN.search("import pandas as pd")
    assert FORBIDDEN.search("import matplotlib.pyplot as plt")
    assert FORBIDDEN.search("from benchmarks.anchors_io import update_anchors")
    assert not FORBIDDEN.search("from plagnn_tpu_torch import cli")
    assert not FORBIDDEN.search("import plagnn_tpu_torch.cli")
    assert not FORBIDDEN.search("import jaxtyping")


def test_cli_without_card_raises(monkeypatch, tmp_path):
    from plagnn_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # -d defaults to cuda; the run must refuse before touching any data
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train-normal", "-data", "GSE30931",
                  "--data-root", str(tmp_path / "absent")])


def test_cli_refuses_mesh_and_mid_round_checkpoints(tmp_path, monkeypatch):
    """The mesh the CLI refuses before touching any data: one of more ranks
    than visible cards (one rank per card); mid-round checkpoints are
    ported."""
    from plagnn_tpu_torch import cli

    root = str(tmp_path)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="needs 2 cards"):
            cli.main(["train-normal", "-data", "GSE30931", "--data-root", root,
                      "--mesh", "fold=2,graph=1"])
    cli.main(["synth", "--data-root", root, "--nodes", "64", "--edges", "200"])
    # mid-round checkpoints are ported: the run writes its artifacts and
    # leaves no checkpoint behind
    cli.main(["train-normal", "-data", "GSE30931", "--data-root", root,
              "-d", "cpu", "-e", "3", "--rounds", "1", "-f", "2",
              "--fold-batch", "2", "--checkpoint-every", "1"])
    d = os.path.join(root, "log", "GSE30931", "normal")
    for fold in (1, 2):
        assert os.path.exists(os.path.join(d, f"1_{fold}_loc_logits.npy"))
    assert os.path.exists(os.path.join(d, "fig_data_1.json"))
    assert not [f for f in os.listdir(d) if f.startswith("ckpt_")]


def test_cuda_wrappers_never_fall_back(monkeypatch):
    """A CUDA tensor goes to the kernel: the wrapper asks the loader for the
    library (which cannot build here) instead of running the plain version."""
    from plagnn_tpu_torch.ops import pcc_scan
    from plagnn_tpu_torch.ops import spmm_kernels as sk

    calls = []

    def fake_load(name):
        calls.append(name)
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(sk._build, "load", fake_load)

    class FakeCuda:
        type = "cuda"

    g = sk.Graph(*(torch.zeros(1, dtype=torch.int32),) * 7, n_nodes=4,
                 n_real_nodes=3, n_edges=0, val=torch.zeros(0), t_val=torch.zeros(0))
    x = torch.zeros(4, 3)
    z = torch.zeros(4, 3, dtype=torch.float64)
    edges = torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float64)
    csr = (torch.zeros(5, dtype=torch.int64), torch.zeros(0, dtype=torch.int32))
    monkeypatch.setattr(sk, "_check", lambda *a: None)
    # the (fake) devices of two tensors never compare equal: skip the checks
    monkeypatch.setattr(pcc_scan, "_check_z", lambda *a: None)
    monkeypatch.setattr(pcc_scan, "_check_csr", lambda c, *a, **k: c)
    monkeypatch.setattr(pcc_scan, "_check_edges", lambda *a: (-1.0, 1.0))
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: FakeCuda()))
    with pytest.raises(RuntimeError, match="no kernel library"):
        sk.spmm_max_fwd(g, x)
    with pytest.raises(RuntimeError, match="no kernel library"):
        sk.spmm_max_bwd(g, x, torch.zeros(4, 3, dtype=torch.int16))
    with pytest.raises(RuntimeError, match="no kernel library"):
        sk.spmm_sum_rows(g, x)
    with pytest.raises(RuntimeError, match="no kernel library"):
        sk.spmm_sum_rows(g, x, transpose=True)
    for transpose in (False, True):
        with pytest.raises(RuntimeError, match="no kernel library"):
            sk.spmm_sum_rows(g, x, transpose=transpose, use_val=True)
    with pytest.raises(RuntimeError, match="no kernel library"):
        pcc_scan.pcc_diff_histogram(z, z, edges, csr)
    assert calls == ["spmm_max_fwd", "spmm_max_bwd", "spmm_sum", "spmm_sum", "spmm_sum",
                     "spmm_sum", "pcc_diff_scan"]
