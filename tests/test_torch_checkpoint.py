"""Mid-round checkpoints of the port: a run cut into stretches of epochs,
or stopped and resumed, writes the same artifacts, byte for byte, as an
uninterrupted run (the model, the whole Adam state and the carried AUC
cross the checkpoint); a checkpoint of another configuration, schema or
framework is refused."""
import json
import os

import numpy as np
import pytest
import torch

from plagnn_tpu_torch.data.synthetic import synthetic_dataset
from plagnn_tpu_torch.models.gnn32 import GCN2
from plagnn_tpu_torch.ops.graph_format import from_scipy_coo, pad_features
from plagnn_tpu_torch.train import checkpoint
from plagnn_tpu_torch.train.engine import TrainConfig, make_adam, train

MODELS = ["gnn32", "gcn2"]


def _tiny_train(tmp_dir, **cfg_kw):
    """5 epochs x 2 folds on a 96-node graph; returns every artifact's bytes."""
    ppi, feats, loc, label_list = synthetic_dataset(
        n_nodes=96, n_edges=500, seed=4, feature_dims=(3, 6, 6))
    graph = from_scipy_coo(ppi, add_self_loops=True)
    kw = dict(lr=1e-3, fold_num=2, epoch_num=5, fold_batch=2, fold_seeds=(12,),
              hidden=(13, 9, 7, 5), verbose=False)
    kw.update(cfg_kw)
    train(graph, pad_features(feats, graph.n_nodes), pad_features(loc, graph.n_nodes),
          label_list, loc, TrainConfig(**kw), str(tmp_dir) + "/", device_name="cpu")
    return {f: open(os.path.join(tmp_dir, f), "rb").read()
            for f in sorted(os.listdir(tmp_dir))}


def _bomb(calls):
    def cb(round_idx, alpha, start, done):
        calls.append(done)
        if len(calls) == 1:
            raise RuntimeError("injected crash")
    return cb


def _crash_after_first_stretch(d, **kw):
    calls = []
    with pytest.raises(RuntimeError, match="injected crash"):
        _tiny_train(d, checkpoint_every=2, chunk_callback=_bomb(calls), **kw)
    assert calls == [2]
    cks = [f for f in os.listdir(d) if f.startswith("ckpt_")]
    assert cks == ["ckpt_a0_j0.npz"]
    return os.path.join(d, cks[0])


@pytest.mark.parametrize("model", MODELS)
def test_chunked_run_bit_identical(tmp_path, model):
    """5 epochs as 2+2+1 with checkpoints, AUC sampled every 5 epochs (so
    the carried value crosses two checkpoints off its cadence)."""
    ref = _tiny_train(tmp_path / "plain", model=model)
    seen = []
    got = _tiny_train(tmp_path / "chunked", model=model, checkpoint_every=2,
                      chunk_callback=lambda r, a, c0, done: seen.append(
                          (done, os.path.exists(tmp_path / "chunked" / "ckpt_a0_j0.npz"))))
    assert seen == [(2, True), (4, True), (5, True)]
    assert set(got) == set(ref) and "1_2_loc_logits.npy" in ref
    for f in ref:
        assert got[f] == ref[f], f
    auc = json.loads(ref["fig_data_1.json"])["validation"]["0.1"]["1"]["auc_micro"]
    assert auc[1] == auc[0] and auc[3] == auc[0] and auc[4] != 0.5


@pytest.mark.parametrize("model", MODELS)
def test_stopped_and_resumed_run_bit_identical(tmp_path, model):
    ref = _tiny_train(tmp_path / "plain", model=model)
    d = tmp_path / "crashy"
    _crash_after_first_stretch(d, model=model)
    got = _tiny_train(d, model=model, checkpoint_every=2)
    assert set(got) == set(ref)
    for f in ref:
        assert got[f] == ref[f], f


def test_resume_refuses_config_drift(tmp_path):
    d = tmp_path / "crashy"
    _crash_after_first_stretch(d)
    for kw in ({"fold_batch": 1}, {"epoch_num": 7}, {"model": "gcn2"}, {"lr": 2e-3}):
        with pytest.raises(ValueError, match="different run configuration"):
            _tiny_train(d, checkpoint_every=2, **kw)


def _rewrite_meta(ck, **changes):
    with np.load(ck) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    meta.update(changes)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(ck, **arrays)


@pytest.mark.parametrize("kind", ["schema", "jax", "not_npz", "unfingerprinted"])
def test_resume_refuses_foreign_checkpoints(tmp_path, kind):
    d = tmp_path / "crashy"
    ck = _crash_after_first_stretch(d)
    if kind == "schema":
        _rewrite_meta(ck, schema=99)
        match = "schema version 99"
    elif kind == "jax":
        # a checkpoint the JAX package wrote: optax leaves, no framework
        import jax.numpy as jnp
        from plagnn_tpu.train.checkpoint import save_state as jax_save_state

        jax_save_state(ck, {"params": {"w": jnp.zeros(3)}, "opt_state": (jnp.zeros(3),),
                            "epochs_done": 2, "history": {"loss": jnp.zeros(2)},
                            "config": {}})
        match = "framework None"
    elif kind == "not_npz":
        with open(ck, "wb") as f:
            f.write(b"\x80\x04not an npz")
        match = "is not an npz"
    else:
        _rewrite_meta(ck, config=None)
        match = "predates config fingerprinting"
    with pytest.raises(ValueError, match=match):
        _tiny_train(d, checkpoint_every=2)


def test_state_and_params_round_trip(tmp_path):
    """save_state/load_state/restore_state carry the model and every Adam
    tensor, step included; save_params/load_params a state_dict."""
    torch.manual_seed(0)
    model = GCN2(5, 4, 3)
    opt = make_adam(model, TrainConfig())
    for _ in range(3):
        opt.zero_grad()
        sum(p.pow(2).sum() for p in model.parameters()).backward()
        opt.step()
    hist = {"train": {"loss": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "pred_num": np.ones((2, 3, 4), np.int32)}
    path = str(tmp_path / "ck.npz")
    checkpoint.save_state(path, model, opt, 3, hist, {"seed": 1})
    st = checkpoint.load_state(path)
    assert st["epochs_done"] == 3 and st["config"] == {"seed": 1}
    np.testing.assert_array_equal(st["history"]["train"]["loss"], hist["train"]["loss"])
    np.testing.assert_array_equal(st["history"]["pred_num"], hist["pred_num"])
    model2 = GCN2(5, 4, 3)
    opt2 = make_adam(model2, TrainConfig())
    checkpoint.restore_state(st, model2, opt2)
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v)
    s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert set(s1) == set(s2) == {0, 1, 2, 3}
    for i in s1:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s1[i][key], s2[i][key])
    assert float(s2[0]["step"]) == 3.0
    assert not os.path.exists(path + ".tmp.npz")

    checkpoint.save_params(str(tmp_path / "p.npz"), model.state_dict())
    loaded = checkpoint.load_params(str(tmp_path / "p.npz"))
    assert set(loaded) == set(model.state_dict())
    for k, v in loaded.items():
        assert torch.equal(v, model.state_dict()[k])
