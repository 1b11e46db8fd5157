"""The port's schedules and optimizer against pasero_tpu's optax chain.

The same numpy gradients go through ``pasero_tpu.optimization.make_optimizer``
(applied as the JAX trainer applies it, ``p + u``) and the port's
``make_optimizer``, over 5 updates, with clipping on and off, weight decay
and a trainable mask. Tolerance: 1e-6 (float32; the norms and the power in
the bias correction are summed or rounded in another order).

One difference is pinned on purpose: a frozen parameter stays unchanged in
the port. In the JAX package ``optax.masked`` passes a frozen leaf's
gradient through as its update and the trainer adds it, so the frozen leaf
moves by its gradient at every step (ROADMAP.md, queue C); the test checks
both behaviours.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasero_tpu import optimization as jax_opt
from pasero_torch import optimization as opt

SHAPES = {"encoder.layers_0.fc1.kernel": (6, 5),
          "encoder.layers_0.fc1.bias": (5,),
          "decoder.final_norm.scale": (6,),
          "shared_embed.embedding": (9, 6)}


def config(**kw):
    base = dict(lr=5e-3, warmup=3, init_lr=0.0, min_lr=0.0, max_steps=10,
                clip_norm=1.0, adam_betas=[0.9, 0.98], weight_decay=0.0)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("kw", [
    dict(warmup=8), dict(warmup=8, init_lr=1e-4, min_lr=2e-4),
    dict(warmup=0, max_steps=16), dict(warmup=0, max_steps=16, min_lr=1e-3)])
def test_schedules_match_jax(kw):
    cfg = config(**kw)
    want = jax_opt.lr_schedule_from_config(cfg)
    got = opt.lr_schedule_from_config(cfg)
    for step in range(0, 2 * max(cfg.warmup, 8) + 1):
        assert got(step) == pytest.approx(
            float(want(jnp.asarray(step, jnp.int32))), rel=1e-6, abs=1e-12)


def run_both(cfg, mask=None, updates=5, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(updates)]

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tx = jax_opt.make_optimizer(cfg, mask=mask)
    state = tx.init(jparams)
    for g in grads:
        u, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                             state, jparams)
        jparams = {k: (jparams[k] + u[k]).astype(jnp.float32)
                   for k in jparams}

    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tx_t = opt.make_optimizer(cfg, tparams, mask)
    for g in grads:
        tx_t.step({k: torch.from_numpy(v) for k, v in g.items()})
    assert tx_t.count == updates
    return params, grads, {k: np.asarray(v) for k, v in jparams.items()}, \
        {k: v.numpy() for k, v in tparams.items()}


@pytest.mark.parametrize("kw,scale", [
    (dict(), 1.0),                       # norms above 1: the clip fires
    (dict(), 0.05),                      # norms below 1: it does not
    (dict(clip_norm=0.0), 1.0),          # no clip in the chain
    (dict(weight_decay=0.01), 1.0),
    (dict(warmup=0, max_steps=6, weight_decay=0.1, adam_betas=[0.8, 0.99]),
     0.3),
])
def test_optimizer_matches_optax(kw, scale):
    _, _, want, got = run_both(config(**kw), scale=scale)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


def test_masked_optimizer_keeps_frozen_parameters():
    """Trainable leaves match optax (the clip norm covers them only); a
    frozen leaf is unchanged in the port and moves by the sum of its
    gradients in the reference."""
    frozen = "shared_embed.embedding"
    names = list(SHAPES)
    mask = opt.trainable_mask(names, freeze_regex=r"^shared_embed\.")
    assert mask == {k: k != frozen for k in names}
    # the JAX package's own mask over its dotted names agrees
    jax_mask = jax_opt.trainable_mask(
        {k: jnp.zeros(1) for k in names}, freeze_regex=r"^shared_embed\.")
    assert dict(jax_mask) == mask
    params, grads, want, got = run_both(config(weight_decay=0.01), mask=mask)
    for k in names:
        if k != frozen:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[frozen], params[frozen])
    np.testing.assert_allclose(want[frozen],
                               params[frozen] + sum(g[frozen] for g in grads),
                               rtol=1e-6, atol=1e-6)


def test_trainable_mask_regexes_use_flax_names():
    linear = torch.zeros(5, 6)
    assert opt.flax_name("encoder.layers_0.fc1.weight", linear) == \
        "encoder.layers_0.fc1.kernel"
    assert opt.flax_name("decoder.final_norm.weight", torch.zeros(6)) == \
        "decoder.final_norm.scale"
    assert opt.flax_name("shared_embed.embedding", linear) == \
        "shared_embed.embedding"
    names = ["encoder.layers_0.fc1.kernel", "decoder.final_norm.scale"]
    assert opt.trainable_mask(names, train_regex="^decoder") == \
        {names[0]: False, names[1]: True}


def test_global_norm_matches_optax():
    rng = np.random.default_rng(4)
    tree = [rng.normal(size=s).astype(np.float32) for s in SHAPES.values()]
    want = float(jax_opt.global_norm([jnp.asarray(t) for t in tree]))
    got = opt.global_norm([torch.from_numpy(t) for t in tree]).item()
    assert got == pytest.approx(want, rel=1e-6)
