"""Training components, the fold-batched runner, the log writers and the CLI
of the port, held against the JAX package on the same numpy inputs."""
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from plagnn_tpu.data import synthetic as jax_synth
from plagnn_tpu.ops import from_scipy_coo as jax_from_scipy_coo
from plagnn_tpu.ops import pad_features
from plagnn_tpu.train import engine as jax_engine
from plagnn_tpu.train import kfold as jax_kfold
from plagnn_tpu.train import losses as jax_losses
from plagnn_tpu.train import metrics as jax_metrics
from plagnn_tpu.train import postprocess as jax_post
from plagnn_tpu_torch import cli
from plagnn_tpu_torch.data import synthetic
from plagnn_tpu_torch.models.batched import BatchedGNN32
from plagnn_tpu_torch.models.convert import params_from_jax
from plagnn_tpu_torch.ops.graph_format import from_scipy_coo
from plagnn_tpu_torch.train import engine, kfold, losses, metrics, postprocess

# float32 reductions in another order: a few ulp of O(1) values
TOL = dict(rtol=1e-5, atol=1e-6)


def _probs_labels(rng, b=3, n=90, c=12, ties=False):
    probs = rng.random((b, n, c)).astype(np.float32)
    if ties:
        probs = np.round(probs * 8) / 8
    labels = (rng.random((n, c)) < 0.3).astype(np.float32)
    masks = rng.random((b, n)) < 0.6
    return probs, labels, masks


def test_weight_cal_and_multi_loss_with_grad(rng):
    probs, labels, masks = _probs_labels(rng)
    probs[0, 0, :3] = [0.0, 1.0, 1e-12]       # clamp edges
    loc = (rng.random((200, 12)) < 0.2).astype(np.float32)
    w = losses.weight_cal(loc)
    np.testing.assert_array_equal(w, jax_losses.weight_cal(loc))
    w32 = w.astype(np.float32)

    pt = torch.tensor(probs, requires_grad=True)
    got = losses.multi_loss(pt, torch.from_numpy(labels), torch.from_numpy(masks),
                            torch.from_numpy(w32))
    got.sum().backward()
    for b in range(len(probs)):
        def f(p):
            return jax_losses.multi_loss(p, jnp.asarray(labels), jnp.asarray(masks[b]),
                                         jnp.asarray(w32))
        ref, gref = jax.value_and_grad(f)(jnp.asarray(probs[b]))
        np.testing.assert_allclose(got[b].item(), float(ref), **TOL)
        np.testing.assert_allclose(pt.grad[b].numpy(), np.asarray(gref), **TOL)


def test_protein_loc_correction_batched_excludes_padding(rng):
    probs, _, _ = _probs_labels(rng)
    valid = np.arange(probs.shape[1]) < 80
    probs[:, 80:] = 5.0  # padding rows must not enter the column statistics
    got = postprocess.protein_loc_correction(
        torch.from_numpy(probs), 0.1, torch.from_numpy(valid)).numpy()
    for b in range(len(probs)):
        ref = jax_post.protein_loc_correction(jnp.asarray(probs[b]), jnp.float32(0.1),
                                              jnp.asarray(valid))
        np.testing.assert_array_equal(got[b], np.asarray(ref))
    np.testing.assert_array_equal(
        postprocess.protein_loc_correction_np(probs[0], 0.1),
        jax_post.protein_loc_correction_np(probs[0], 0.1))


@pytest.mark.parametrize("ties", [False, True])
def test_metrics_match_jax(rng, ties):
    probs, labels, masks = _probs_labels(rng, ties=ties)
    preds = (probs > 0.55).astype(np.float32)
    t_l, t_p, t_m, t_s = (torch.from_numpy(a) for a in (labels, preds, masks, probs))
    aim, cov, acc = metrics.aim_cov_acc(t_l, t_p, t_m)
    pairs = [(metrics.micro_f1(t_l, t_p, t_m), jax.jit(jax_metrics.micro_f1)),
             (metrics.macro_f1(t_l, t_p, t_m), jax.jit(jax_metrics.macro_f1))]
    aucs = [(metrics.micro_auc(t_s, t_l, t_m), jax.jit(jax_metrics.micro_auc)),
            (metrics.macro_auc(t_s, t_l, t_m), jax.jit(jax_metrics.macro_auc))]
    for b in range(len(probs)):
        ref = jax.jit(jax_metrics.aim_cov_acc)(
            jnp.asarray(labels), jnp.asarray(preds[b]), jnp.asarray(masks[b]))
        np.testing.assert_allclose([aim[b].item(), cov[b].item(), acc[b].item()],
                                   [float(r) for r in ref], **TOL)
        for got, fn in pairs:
            np.testing.assert_allclose(
                got[b].item(),
                float(fn(jnp.asarray(labels), jnp.asarray(preds[b]), jnp.asarray(masks[b]))),
                **TOL)
        # AUC with average-rank ties
        for got, fn in aucs:
            np.testing.assert_allclose(
                got[b].item(),
                float(fn(jnp.asarray(probs[b]), jnp.asarray(labels), jnp.asarray(masks[b]))),
                **TOL)


def test_kfold_masks_match_sklearn_for_all_fold_seeds():
    labelled = np.sort(np.random.default_rng(1).choice(1500, 1003, replace=False))
    assert kfold.FOLD_SEEDS == jax_kfold.FOLD_SEEDS
    for seed in kfold.FOLD_SEEDS:
        tr, va = kfold.fold_node_masks(labelled, 1536, 10, seed)
        tr_j, va_j = jax_kfold.fold_node_masks(labelled, 1536, 10, seed)
        np.testing.assert_array_equal(tr, tr_j)
        np.testing.assert_array_equal(va, va_j)


def test_synthetic_data_bit_identical():
    a = synthetic.synthetic_dataset(n_nodes=300, n_edges=2000, seed=11)
    b = jax_synth.synthetic_dataset(n_nodes=300, n_edges=2000, seed=11)
    for x, y in zip(a[:3], b[:3]):
        if hasattr(x, "toarray"):
            x, y = x.toarray(), y.toarray()
        np.testing.assert_array_equal(x, y)
    assert a[3] == b[3]


def test_runner_matches_jax_over_8_epochs():
    """8 epochs, 3 folds in one batch, hidden (13, 9, 7, 5), from the same
    JAX-initialised params, against the JAX package's XLA runner (which
    tests/test_batched_engine.py holds equal to its Pallas runner).

    The JAX runner runs one fold at a time (vmap width 1, one compile):
    vmapped over these 3 folds on XLA:CPU it gets fold 2's conv1.w_pool
    gradient column 462 wrong (its b_pool gradient and a float64 x^T.dz
    agree with the port and with the unbatched JAX gradient), and Adam
    turns that into a +-lr step.

    Probabilities and losses: allclose 1e-4 (float32 drift over 8 Adam
    steps).  Threshold metrics: a prediction within float32 noise of its
    row's threshold may flip; each flip moves one fold's metric by at most
    1/|rows|, so at most 2 flips' worth is allowed per value."""
    ppi, feats, loc, label_list = jax_synth.synthetic_dataset(n_nodes=512, n_edges=4000, seed=70)
    jg = jax_from_scipy_coo(ppi, add_self_loops=True, widths=(4, 16, 64))
    g = from_scipy_coo(ppi, add_self_loops=True)
    n = g.n_nodes
    feats_p = pad_features(feats, n)
    labels_p = pad_features(loc, n)
    node_valid = np.arange(n) < 512
    w = losses.weight_cal(loc)
    tr_np, va_np = kfold.fold_node_masks(label_list, n, 3, 12)
    jcfg = jax_engine.TrainConfig(lr=1e-3, fold_num=3, epoch_num=8, hidden=(13, 9, 7, 5),
                                  verbose=False)
    # jitted set-up and host-side slicing keep XLA:CPU to a few compiles
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: jax_engine.init_fold_params(k, jcfg, feats.shape[1], 3))(
            jax.random.PRNGKey(5)))

    run_j, _ = jax_engine.make_fold_runner(
        jg, jnp.asarray(feats_p), jnp.asarray(labels_p), w, jnp.asarray(node_valid), jcfg)
    init_opt = jax.jit(run_j.init_opt)
    per_fold = []
    for i in range(3):
        p_i = jax.tree.map(lambda a: a[i:i + 1], params)
        per_fold.append(run_j(p_i, init_opt(p_i), jnp.asarray(tr_np[i:i + 1]),
                              jnp.asarray(va_np[i:i + 1]), jnp.float32(0.1)))
    probs_j = np.concatenate([np.asarray(r[2]) for r in per_fold])
    hist_j = jax.tree.map(lambda *a: np.concatenate(a),
                          *[jax.device_get(r[3]) for r in per_fold])

    pcfg = engine.TrainConfig(lr=1e-3, fold_num=3, epoch_num=8, hidden=(13, 9, 7, 5),
                              verbose=False)
    model = BatchedGNN32(3, feats.shape[1], 13, 9, 7, 5)
    model.load_state_dict(params_from_jax(params))
    run_p = engine.make_batched_fold_runner(
        g, torch.from_numpy(feats_p), torch.from_numpy(labels_p), w,
        torch.from_numpy(node_valid), pcfg)
    _, _, probs_p, hist_p, epoch_ms = run_p(
        model, None, torch.from_numpy(tr_np), torch.from_numpy(va_np), 0.1)
    assert len(epoch_ms) == 8

    np.testing.assert_allclose(probs_p.numpy(), probs_j, rtol=1e-4, atol=1e-4)
    for split in ("train", "val"):
        np.testing.assert_allclose(hist_p[split]["loss"], hist_j[split]["loss"],
                                   rtol=1e-4, atol=1e-4)
    rows = {"train": tr_np.sum(1), "val": va_np.sum(1)}
    for split, keys in (("train", ("aim", "cov", "acc")),
                        ("val", ("aim", "cov", "acc", "f1_micro", "f1_macro",
                                 "auc_micro", "auc_macro"))):
        for k in keys:
            allow = 2.0 / rows[split][:, None] + 1e-5
            diff = np.abs(hist_p[split][k] - hist_j[split][k])
            assert np.all(diff <= allow), (split, k, diff.max())
    np.testing.assert_allclose(hist_p["pred_num"], hist_j["pred_num"], atol=3)
    assert hist_p["pred_num"].dtype == np.int32


def _fake_history(rng, b=2, e=7, c=12):
    h = {"train": {}, "val": {}}
    for split in h:
        for k in ("aim", "cov", "acc", "loss"):
            h[split][k] = rng.random((b, e)).astype(np.float32)
    h["pred_num"] = rng.integers(0, 300, (b, e, c)).astype(np.int32)
    return h


def test_log_writers_byte_identical(rng, tmp_path):
    hist = _fake_history(rng)
    n_real = 300
    labels_np = (rng.random((n_real, 12)) < 0.3).astype(np.float32)
    logits = rng.random((n_real, 12)).astype(np.float32)
    tr = rng.random(320) < 0.5
    va = ~tr & (rng.random(320) < 0.5)
    names = [f"P{i:05d}" for i in range(n_real)]
    p_num = labels_np.astype(int).sum(0)
    p_scale = p_num / 200 * 100
    outs = []
    for mod, cfg in ((jax_engine, jax_engine.TrainConfig(epoch_num=7, verbose=False)),
                     (engine, engine.TrainConfig(epoch_num=7, verbose=False))):
        d = tmp_path / mod.__name__
        d.mkdir()
        txt, tsv = str(d / "txt_log.txt"), str(d / "log.tsv")
        flag = True
        for b, fold in ((0, 1), (1, 2)):
            mod._write_epoch_logs(txt, cfg, 1, fold, 0.1, hist, b, p_scale, p_num,
                                  "dev", n_real)
            flag = mod._write_tsv(tsv, flag, 1, fold, 0.1, logits, labels_np, tr, va,
                                  names if fold == 1 else None, n_real, node_alpha=0.1)
        outs.append((open(txt, "rb").read(), open(tsv, "rb").read()))
    assert outs[0] == outs[1]
    assert len(outs[0][0]) > 1000 and len(outs[0][1]) > 1000


def test_cli_synth_and_train_cpu_write_artifacts(tmp_path, capsys):
    root = str(tmp_path)
    cli.main(["synth", "--data-root", root, "--nodes", "256", "--edges", "1500",
              "--seed", "7"])
    flags = ["-data", "GSE30931", "--data-root", root, "-d", "cpu", "-e", "3",
             "--rounds", "1", "-f", "2", "--fold-batch", "2"]
    stats = cli.main(["train-normal"] + flags)
    assert [len(s.epoch_ms) for s in stats] == [3]
    stats = cli.main(["train-inter", "--agg-dtype", "bfloat16"] + flags)
    from plagnn_tpu_torch.utils.precision import set_aggregation_dtype
    set_aggregation_dtype("float32")
    out = capsys.readouterr().out
    assert "tra --" in out and "val --" in out
    for cond in ("normal", "perturbation"):
        d = os.path.join(root, "log", "GSE30931", cond)
        for fold in (1, 2):
            lg = np.load(os.path.join(d, f"1_{fold}_loc_logits.npy"))
            assert lg.shape == (256, 12) and np.all((lg >= 0) & (lg <= 1))
        txt = open(os.path.join(d, "txt_log.txt")).read()
        assert "device:cpu" in txt
        assert open(os.path.join(d, "log.tsv")).readline().startswith("round\tfold")
        fig = json.load(open(os.path.join(d, "fig_data_1.json")))
        assert set(fig) == {"train", "validation"}
        val = fig["validation"]["0.1"]["1"]
        assert len(val["loss"]) == 3 and len(val["auc_micro"]) == 3
        assert len(val["pred_num_final"]) == 12
    # resume: the same flags skip the finished round
    cli.main(["train-normal"] + flags)
    assert "skipping" in capsys.readouterr().out
