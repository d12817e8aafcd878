"""The port's trainer against the JAX package's: the same grouped layout,
the same Adam updates from the same parameters on the same batch
indices (the indices the JAX package's own ``_run_epochs`` draws), the
same per-slot predictions and coverage."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.models import train as jt
from learnedmetricindex_tpu.models.mlp import init_stacked_mlp
from learnedmetricindex_tpu_torch.models import train as pt

torch.set_num_threads(2)

M, C, B, TILE = 3, 5, 32, 64


def _setup(scaled: bool):
    data, _ = synthetic_blobs(700, 12, 4, n_clusters=9, seed=4)
    rng = np.random.default_rng(4)
    groups = rng.integers(0, M, 700)
    groups[:20] = 1  # node 1 larger than one batch, node sizes differ
    groups[groups == 2] = np.where(rng.random((groups == 2).sum()) < 0.9, 0, 2)  # node 2 < B rows
    labels = rng.integers(0, C, 700).astype(np.int32)
    scales = None
    if scaled:
        scales = (np.abs(data).max(1) / 127).astype(np.float32)
        data = np.round(data / scales[:, None]).astype(np.int8)
    jg = jt.group_rows(data, groups, M, labels=labels, tile=TILE, scales=scales)
    pg = pt.group_rows(data if not scaled else torch.as_tensor(data), groups, M, labels=labels,
                       tile=TILE, scales=scales, device="cpu")
    return data, groups, labels, jg, pg


@pytest.mark.parametrize("scaled", [False, True])
def test_group_rows_fields_equal(scaled):
    _, _, _, jg, pg = _setup(scaled)
    for f in ("slot_rows", "labels", "tile_model", "seg_starts", "seg_lens"):
        np.testing.assert_array_equal(getattr(pg, f).numpy(), np.asarray(getattr(jg, f)), err_msg=f)
    np.testing.assert_array_equal(pg.slot_rows_np, jg.slot_rows_np)
    assert pg.tile == jg.tile
    vals = np.arange(len(jg.slot_rows_np))
    np.testing.assert_array_equal(pg.scatter_to_rows(vals, 700, -1), jg.scatter_to_rows(vals, 700, -1))
    if scaled:
        np.testing.assert_array_equal(pg.x_scales.numpy(), np.asarray(jg.x_scales))


def _jax_indices(key, jg, steps, ref):
    """The slot indices ``jt._run_epochs`` draws for ``key`` (its :240-252)."""
    seg_starts, seg_lens = jnp.asarray(jg.seg_starts), jnp.asarray(jg.seg_lens)
    out = []
    for skey in jax.random.split(key, steps):
        idx = seg_starts[:, None] + jax.random.randint(
            skey, (M, B), 0, jnp.maximum(seg_lens, 1)[:, None])
        if ref:
            seq = seg_starts[:, None] + (jnp.arange(B)[None, :] % jnp.maximum(seg_lens, 1)[:, None])
            idx = jnp.where((seg_lens <= B)[:, None], seq, idx)
        out.append(np.array(idx))
    return out


def _flat(params):
    return [torch.tensor(np.asarray(leaf)) for layer in params for leaf in (layer["w"], layer["b"])]


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rule", ["minibatch", "reference"])
def test_steps_match_optax_adam(steps, weighted, rule):
    """``train_step`` on the indices the JAX package draws equals its
    ``_run_epochs`` (optax.adam under ``_tree_where_model``); model 1 is
    frozen: its parameters and both moments stay, the count advances."""
    scaled = weighted  # cover the int8 + row-scales batches too
    _, _, _, jg, pg = _setup(scaled)
    ref = rule == "reference"
    params = init_stacked_mlp(jax.random.PRNGKey(1), M, "MLP-6", 12, C)
    mask = np.ones((M, C), bool)
    mask[2, 4] = False
    cw = None
    if weighted:
        cw = np.random.default_rng(2).uniform(0.5, 2.0, (M, C)).astype(np.float32)
    active = np.array([True, False, True])
    lr = 0.01
    key = jax.random.PRNGKey(7)
    jp, js, jl = jt._run_epochs(
        params, optax.adam(lr).init(params), key, jg.x, jg.x_scales, jg.slot_rows, jg.labels,
        jg.seg_starts, jg.seg_lens, jnp.asarray(mask), jnp.asarray(active, jnp.float32),
        None if cw is None else jnp.asarray(cw),
        n_models=M, batch_size=B, steps=steps, lr=lr, ref_dynamics=ref,
    )

    p = _flat(params)
    state = pt.adam_init(p)
    mask_t, act_t = torch.as_tensor(mask), torch.as_tensor(active)
    cw_t = None if cw is None else torch.as_tensor(cw)
    runt = (pg.seg_lens.clamp_min(1) - 1) % B + 1 if ref else None
    for idx in _jax_indices(key, jg, steps, ref):
        xb, yb = pt.batch_rows(pg, torch.as_tensor(idx).long())
        p, state, losses = pt.train_step(p, state, xb, yb, mask_t, act_t, cw_t, lr=lr,
                                         all_active=False, runt=runt)

    adam = js[0]
    assert state.count == int(adam.count) == steps
    for got, want in zip(p, _flat(jp)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)
    for got, want in zip(state.mu + state.nu, _flat(adam.mu) + _flat(adam.nu)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-5)
    # the frozen model: parameters and moments untouched
    for got, start in zip(p, _flat(params)):
        np.testing.assert_array_equal(got[1].numpy(), start[1].numpy())
    assert all(float(t[1].abs().max()) == 0.0 for t in state.mu + state.nu)


def test_predictions_and_coverage_match():
    _, _, _, jg, pg = _setup(True)
    params = init_stacked_mlp(jax.random.PRNGKey(5), M, "MLP-6", 12, C)
    mask = np.ones((M, C), bool)
    mask[0, 1] = False
    jp = np.asarray(jt._predict_own_tiles(params, jg.x, jg.x_scales, jg.slot_rows, jg.tile_model,
                                          jnp.asarray(mask), tile=TILE, n_classes=C))
    pp = pt._predict_own_tiles(_flat(params), pg, torch.as_tensor(mask), block_bytes=4 * TILE * 12)
    np.testing.assert_array_equal(pp.numpy(), jp)
    for m in (mask, np.ones((M, C), bool)):
        jc = np.asarray(jt._coverage(jnp.asarray(jp), jg.labels, jg.tile_model, jnp.asarray(m),
                                     n_models=M, n_classes=C))
        pc = pt._coverage(pp, pg.labels, pg.tile_model, torch.as_tensor(m))
        np.testing.assert_array_equal(pc.numpy(), jc)


def test_weighted_mean_ce_matches():
    rng = np.random.default_rng(0)
    ce = rng.random((M, 9)).astype(np.float32)
    yb = rng.integers(-1, C, (M, 9))
    w = rng.random((M, C)).astype(np.float32)
    for cw in (None, w):
        ref = np.asarray(jt._weighted_mean_ce(jnp.asarray(ce), jnp.asarray(yb),
                                              None if cw is None else jnp.asarray(cw)))
        got = pt._weighted_mean_ce(torch.as_tensor(ce), torch.as_tensor(yb),
                                   None if cw is None else torch.as_tensor(cw))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


def test_trainer_fit_covers_and_reference_api():
    data, _ = synthetic_blobs(1500, 16, 4, n_clusters=6, seed=2)
    labels = np.argmax(data @ data[:4].T, axis=1).astype(np.int32)
    trainer, preds = pt.train_until_covered(data, labels, 4, model_type="MLP", lr=0.01,
                                            epochs=3, batch_size=64, seed=1, device="cpu")
    assert preds.shape == (1500,) and set(np.unique(preds)) == {0, 1, 2, 3}
    assert (preds == labels).mean() > 0.9
    probs = trainer.predict_proba_all(data[:10])
    assert probs.shape == (1, 10, 4)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)

    net = pt.NeuralNetwork(16, 4, lr=0.05, model_type="MLP-6", seed=3, device="cpu")
    net.train_batch(data, labels, epochs=5)
    assert (net.predict(data) == labels).mean() > 0.9
    p, c = net.predict_proba(data[:5])
    assert p.shape == c.shape == (5, 4) and (np.diff(p, axis=1) <= 0).all()
    full = pt.NeuralNetwork(16, 4, lr=0.05, class_weight=np.ones(4), device="cpu")
    full.train(data, labels, epochs=30)
    assert (full.predict(data) == labels).mean() > 0.5
    with pytest.raises(ValueError, match="class_weight"):
        pt.NeuralNetwork(16, 4, class_weight=np.ones(3), device="cpu")
    with pytest.raises(ValueError, match="update_rule"):
        pt.StackedNodeTrainer(1, 4, 2, update_rule="sgd", device="cpu")
