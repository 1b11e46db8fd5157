"""The port's decoder-only (Llama-shaped) pieces against pasero_tpu's, in
float32, on the same inputs and weights.

RMSNorm, the gated FFNs and RoPE against their flax/JAX functions; a small
Llama-shaped Transformer (2 layers, width 64, 4 query heads over 2 K/V
heads, SwiGLU, RMSNorm, RoPE, untied head) against the JAX model on
``params_to_state_dict`` weights, with the ``xla`` and the ``flash``
attention kernels (JAX's Pallas kernels in interpret mode); three
``Trainer.train_step``s against the JAX Trainer; the initialization of the
new parameters against flax's; each package loading the other's checkpoint.

Tolerances: max-abs 1e-4 on logits and activations, rtol 1e-4 on the
trainer's loss, nll and gnorm (float32, summation order only); the loss
rtol 1e-5 and each parameter gradient within 1e-5 + 1e-4 of its largest
magnitude (float32; the attention paths sum in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import traverse_util

import pasero_tpu.ops.flash_attention as jax_fa
from pasero_tpu import checkpoints as jax_checkpoints
from pasero_tpu.config import TrainingConfig as JaxTrainingConfig
from pasero_tpu.config import get_model_config_cls as jax_config_cls
from pasero_tpu.models import modules as jax_modules
from pasero_tpu.models import positional as jax_positional
from pasero_tpu.models.transformer import Transformer as JaxTransformer
from pasero_tpu.parallel import make_mesh
from pasero_tpu.training import Trainer as JaxTrainer
from pasero_torch import checkpoints
from pasero_torch.config import TrainingConfig
from pasero_torch.config import get_model_config_cls as torch_config_cls
from pasero_torch.models import modules
from pasero_torch.models.positional import apply_rope
from pasero_torch.models.transformer import Transformer
from pasero_torch.scripts.bench_decode import random_state
from pasero_torch.training import Trainer, shift_targets

ATOL = 1e-4
VOCAB = 61
SMALL = dict(decoder_layers=2, embed_dim=64, decoder_attention_heads=4,
             attention_heads_kv=2, decoder_ffn_dim=128)


@pytest.fixture(autouse=True)
def interpret_mode():
    jax_fa.INTERPRET = True
    yield
    jax_fa.INTERPRET = False


def close(a, b, atol=ATOL):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= atol, np.abs(a - b).max()


def configs(**overrides):
    out = []
    for cls in (jax_config_cls("llama_7b"), torch_config_cls("llama_7b")):
        cfg = cls(strict=False, **{**SMALL, **overrides})
        cfg.set_defaults("language_modeling")
        cfg.dropout = 0.0
        out.append(cfg)
    return out


def flax_params(jmodel, seed=0):
    params = jmodel.init(jax.random.PRNGKey(seed),
                         decoder_input=jnp.zeros((1, 4), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))


def flax_params_of(module, x):
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))


def pair(kernel, seed=0, **overrides):
    """A flax-initialized small Llama and its port, same weights."""
    jcfg, tcfg = configs(**overrides)
    jmodel = JaxTransformer(jcfg, src_vocab_size=VOCAB, dtype=jnp.float32,
                            kernel=kernel)
    params = flax_params(jmodel, seed)
    tmodel = Transformer(tcfg, VOCAB, dtype=torch.float32, kernel=kernel)
    tmodel.load_state_dict(checkpoints.params_to_state_dict(
        traverse_util.flatten_dict(params, sep="/")))
    return jmodel, params, tmodel.eval()


def tokens(seed=0, B=3, T=12):
    """Right-padded rows (pad 0, the Llama arch's)."""
    rng = np.random.default_rng(seed)
    dec = rng.integers(4, VOCAB, (B, T)).astype(np.int32)
    dec[:, 0] = 1
    dec[1, 8:] = 0
    dec[2, 5:] = 0
    return dec


def test_rms_norm_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 3
    scale = rng.normal(size=(32,)).astype(np.float32)
    want = jax_modules.RMSNorm(epsilon=1e-6, dtype=jnp.float32).apply(
        {"params": {"scale": scale}}, jnp.asarray(x))
    norm = modules.RMSNorm(32, epsilon=1e-6, dtype=torch.float32)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        close(want, norm(torch.from_numpy(x)), 1e-5)


@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_gated_ffn_matches_flax(activation):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    flax_ffn = jax_modules.FeedForward(ffn_dim=24, activation=activation,
                                       use_bias=False, dtype=jnp.float32)
    params = flax_params_of(flax_ffn, x)
    ffn = modules.FeedForward(16, 24, activation, use_bias=False,
                              dtype=torch.float32)
    ffn.load_state_dict(checkpoints.params_to_state_dict(
        traverse_util.flatten_dict(params, sep="/")))
    with torch.no_grad():
        close(flax_ffn.apply({"params": params}, jnp.asarray(x)),
              ffn(torch.from_numpy(x)), 1e-5)


@pytest.mark.parametrize("base", [10000.0, 5e6])
def test_apply_rope_matches_jax(base):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 9, 16)).astype(np.float32)
    positions = np.stack([np.arange(9), np.maximum(np.arange(9) - 3, 0)])
    want = jax_positional.apply_rope(jnp.asarray(x), jnp.asarray(positions),
                                     base)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(positions), base)
    close(want, got, 1e-5)
    xb = torch.from_numpy(x).bfloat16()
    assert apply_rope(xb, torch.from_numpy(positions), base).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("kernel", ["xla", "flash"])
def test_logits_match_jax(kernel):
    jmodel, params, tmodel = pair(kernel)
    dec = tokens()
    want = jmodel.apply({"params": params},
                        decoder_input=jnp.asarray(dec))["logits"]
    with torch.no_grad():
        got = tmodel(None, torch.from_numpy(dec))["logits"]
    close(want, got)


def test_sliding_window_logits_match_jax():
    """At the tokens (not the padding: a padded row whose window holds only
    padding sees no key, and the two packages fill it differently), with
    flash against JAX's flash and against the port's plain path."""
    jmodel, params, tmodel = pair("flash", sliding_window=4)
    dec = tokens(seed=3)
    real = dec != 0
    want = jmodel.apply({"params": params},
                        decoder_input=jnp.asarray(dec))["logits"]
    with torch.no_grad():
        got = tmodel(None, torch.from_numpy(dec))["logits"]
        xla = Transformer(tmodel.cfg, VOCAB, dtype=torch.float32,
                          kernel="xla")
        xla.load_state_dict(tmodel.state_dict())
        plain = xla.eval()(None, torch.from_numpy(dec))["logits"]
    close(np.asarray(want)[real], got.numpy()[real])
    close(plain.numpy()[real], got.numpy()[real])


def test_loss_and_gradients_match_jax_with_flash():
    jmodel, params, tmodel = pair("flash")
    dec = tokens(seed=4)
    targets = np.asarray(shift_targets(torch.from_numpy(dec), 0))

    def loss_fn(p):
        return jmodel.apply({"params": p}, decoder_input=jnp.asarray(dec),
                            targets=jnp.asarray(targets))["loss_sum"]

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    tmodel.train()
    loss_t = tmodel(None, torch.from_numpy(dec),
                    targets=torch.from_numpy(targets))["loss_sum"]
    loss_t.backward()
    assert loss_t.item() == pytest.approx(float(loss_j), rel=1e-5)
    want = jax_checkpoints.flatten_params(grads_j)
    got = checkpoints.state_dict_to_params(
        {k: p.grad for k, p in tmodel.named_parameters()})
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        atol = 1e-5 + 1e-4 * np.abs(value).max()
        np.testing.assert_allclose(got[key], value, rtol=0, atol=atol,
                                   err_msg=key)


def test_checkpoints_load_across_packages(tmp_path):
    """The port loads a flax tree saved by pasero_tpu.checkpoints and the
    JAX model loads the port's: k/v at Hkv * D width, gate/fc1/fc2, RMSNorm
    scale and the untied head."""
    jmodel, params, tmodel = pair("xla", seed=5)
    path = str(tmp_path / "jax.npz")
    checkpoints.save_flat(path, jax_checkpoints.flatten_params(params))
    port = Transformer(tmodel.cfg, VOCAB, dtype=torch.float32)
    checkpoints.load_into(port, path)
    state = port.state_dict()
    assert state["decoder.layers_0.self_attn.k_proj.weight"].shape == (32, 64)
    assert state["decoder.layers_1.ffn.gate.weight"].shape == (128, 64)
    assert state["decoder.output_projection.weight"].shape == (VOCAB, 64)
    assert "decoder.layers_0.cross_attn.q_proj.weight" not in state
    back = str(tmp_path / "port.npz")
    checkpoints.save_flat(back, checkpoints.state_dict_to_params(
        random_state(port, 1)))
    loaded, missing, unexpected = jax_checkpoints.load_params(back, params)
    assert not missing and not unexpected
    port.load_state_dict(random_state(port, 1))
    dec = tokens(seed=6)
    want = jmodel.apply({"params": loaded},
                        decoder_input=jnp.asarray(dec))["logits"]
    with torch.no_grad():
        close(want, port.eval()(None, torch.from_numpy(dec))["logits"])


def test_initialization_matches_flax():
    """RMSNorm scales are ones; gate, fc1, fc2 and the untied head draw
    flax's truncated LeCun normal (std fan_in^-1/2, cut at two of its
    standard deviations); embeddings normal with std E^-1/2."""
    jcfg, tcfg = configs(embed_dim=256, decoder_ffn_dim=512)
    flat = traverse_util.flatten_dict(
        flax_params(JaxTransformer(jcfg, src_vocab_size=500)), sep="/")
    torch.manual_seed(0)
    port = checkpoints.state_dict_to_params(
        Transformer(tcfg, 500).state_dict())
    assert sorted(port) == sorted(flat)
    for key, want in flat.items():
        got = port[key]
        if key.endswith("scale"):
            assert (got == 1).all() and (want == 1).all(), key
            continue
        assert got.std() == pytest.approx(want.std(), rel=0.05), key
        bound = 2 * got.shape[0] ** -0.5 / 0.87962566103423978
        if not key.endswith("embedding"):
            assert np.abs(got).max() <= bound * 1.0001, key
            assert np.abs(want).max() <= bound * 1.0001, key


def make_lm_cfg(cls, tmp, ckpt):
    os.makedirs(os.path.join(tmp, "data"), exist_ok=True)
    cfg = cls("--task", "language_modeling", "--arch", "llama_7b",
              "--data-dir", os.path.join(tmp, "data"), "-o",
              os.path.join(tmp, "model"), "--max-steps", "3",
              "--valid-interval", "3", "--log-interval", "1", "--seed", "0",
              "--dropout", "0", "--lr", "1e-3", "--warmup", "2", "--ckpt",
              ckpt, "--attention-kernel", "flash")
    for k, v in SMALL.items():
        setattr(cfg.model_cfg, k, v)
    return cfg


def lm_batch(seed):
    rng = np.random.default_rng(seed)
    B, T = 4, 10
    dec = rng.integers(4, VOCAB, (B, T)).astype(np.int32)
    dec[:, 0] = 1
    target_mask = np.ones((B, T), bool)
    target_mask[1 + seed % 3, T - 2 - seed % 4:] = False
    dec[~target_mask] = 0
    return {"decoder_input": dec, "target_mask": target_mask,
            "prompt_mask": np.zeros((B, T), bool), "num_real_rows": B}


def test_trainer_steps_match_jax(tmp_path):
    """Three updates of the small Llama through the flash path, from the
    same numpy weights: per-step loss, nll and gnorm rtol 1e-4."""
    tmp = str(tmp_path)
    ckpt = os.path.join(tmp, "init.npz")
    cfg = make_lm_cfg(TrainingConfig, os.path.join(tmp, "torch"), ckpt)
    model = Transformer(cfg.model_cfg, VOCAB, dtype=torch.float32)
    checkpoints.save_flat(ckpt, checkpoints.state_dict_to_params(
        random_state(model, 0)))
    batches = [lm_batch(seed) for seed in range(3)]
    trainer = Trainer(cfg, None, model, device="cpu")
    it = iter(batches)
    torch_logs = [trainer.train_step(it) for _ in range(3)]

    jcfg = make_lm_cfg(JaxTrainingConfig, os.path.join(tmp, "jax"), ckpt)
    # with a prng_impl the JAX Trainer switches jax's process-wide default
    # PRNG, which later tests in this worker would inherit; dropout is 0
    jcfg.prng_impl = None
    jmodel = JaxTransformer(jcfg.model_cfg, src_vocab_size=VOCAB,
                            dtype=jnp.float32)
    mesh = make_mesh(1, 1, 1, devices=jax.devices()[:1])
    jtrainer = JaxTrainer(jcfg, task=None, model=jmodel, mesh=mesh)
    it = iter(batches)
    jax_logs = [jtrainer.train_step(it) for _ in range(3)]
    for got, want in zip(torch_logs, jax_logs):
        for key in ("loss", "nll_loss", "gnorm"):
            assert got[key] == pytest.approx(want[key], rel=1e-4), key
        assert got["num_tokens"] == want["num_tokens"]


def test_kernel_choice_follows_jax():
    """JAX's rule (attention.py:256-279): 'auto' takes flash for grouped K/V
    heads from Sq * Sk >= 1024^2 and for any heads from 4096^2, never at
    decode or under live attention dropout; enc-dec MT at S = 128 keeps the
    plain path."""
    from pasero_torch.models.attention import MultiheadAttention
    gqa = MultiheadAttention(64, 4, kv_heads=2, causal=True)
    dense = MultiheadAttention(64, 4, causal=True)
    assert gqa.use_flash(1024, 1024, decode=False)
    assert not gqa.use_flash(1023, 1024, decode=False)
    assert not gqa.use_flash(2048, 2048, decode=True)
    assert not dense.use_flash(128, 128, decode=False)
    assert not dense.use_flash(2048, 2048, decode=False)
    assert dense.use_flash(4096, 4096, decode=False)
    live = MultiheadAttention(64, 4, kv_heads=2, dropout=0.1).train()
    assert not live.use_flash(4096, 4096, decode=False)
    assert live.eval().use_flash(4096, 4096, decode=False)
    forced = MultiheadAttention(64, 4, kernel="flash")
    assert forced.use_flash(8, 8, decode=False)
    assert not MultiheadAttention(64, 4, kernel="xla").use_flash(
        8192, 8192, decode=False)
