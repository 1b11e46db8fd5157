"""Checkpoint IO of the port and the JAX -> PyTorch weight map."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import traverse_util

from pasero_tpu import checkpoints as jax_checkpoints
from pasero_tpu.config import get_model_config_cls as jax_config_cls
from pasero_tpu.models.transformer import Transformer as JaxTransformer
from pasero_torch import checkpoints
from pasero_torch.config import get_model_config_cls as torch_config_cls
from pasero_torch.models.transformer import Transformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI2 = os.path.join(ROOT, "models", "deen-mini2")
NPZ = os.path.join(MINI2, "model_1000.npz")


def test_state_dict_round_trip_is_bit_identical():
    flat = checkpoints.load_flat(NPZ)
    assert len(flat) == 127
    back = checkpoints.state_dict_to_params(checkpoints.params_to_state_dict(flat))
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        assert back[key].dtype == value.dtype == np.float32
        np.testing.assert_array_equal(back[key], value)


def test_load_and_save_through_the_model(tmp_path):
    from pasero_torch.decoding.generator import load_model_config
    arch, cfg = load_model_config(MINI2)
    cfg.set_defaults("translation")
    flat = checkpoints.load_flat(NPZ)
    model = Transformer(cfg, flat["shared_embed/embedding"].shape[0])
    checkpoints.load_into(model, checkpoints.find_checkpoint(MINI2))
    # flax (in, out) kernels arrive transposed, norm scales as weights
    np.testing.assert_array_equal(
        model.encoder.layers_0.self_attn.q_proj.weight.detach().numpy(),
        flat["encoder/layers_0/self_attn/q_proj/kernel"].T)
    np.testing.assert_array_equal(
        model.decoder.layers_2.cross_attn_norm.weight.detach().numpy(),
        flat["decoder/layers_2/cross_attn_norm/scale"])
    path = checkpoints.save_checkpoint(str(tmp_path), 1000, model)
    assert os.path.realpath(tmp_path / "model_last.npz") == path
    saved = jax_checkpoints.load_flat(path)      # the JAX package reads it
    assert sorted(saved) == sorted(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(saved[key], value)


def test_find_checkpoint_order(tmp_path):
    assert os.path.realpath(checkpoints.find_checkpoint(MINI2)) == \
        os.path.realpath(NPZ)
    with pytest.raises(FileNotFoundError):
        checkpoints.find_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        checkpoints.find_checkpoint(MINI2, "model_7.npz")


def test_load_rejects_mismatched_checkpoint(tmp_path):
    flat = checkpoints.load_flat(NPZ)
    flat.pop("decoder/layers_0/ffn/fc1/bias")
    path = tmp_path / "model_1.npz"
    checkpoints.save_flat(str(path), flat)
    from pasero_torch.decoding.generator import load_model_config
    _, cfg = load_model_config(MINI2)
    cfg.set_defaults("translation")
    model = Transformer(cfg, 2192)
    with pytest.raises(ValueError, match="missing"):
        checkpoints.load_into(model, str(path))


@pytest.mark.parametrize("tied", [True, False])
def test_flax_initialized_model_carries_over(tied):
    """Full-forward logits of a flax-initialized model and of the port
    loaded through params_to_state_dict agree to max-abs 1e-4 in float32
    (summation order differs)."""
    overrides = dict(encoder_layers=2, decoder_layers=2, embed_dim=64,
                     encoder_ffn_dim=128, decoder_ffn_dim=128,
                     encoder_attention_heads=4, decoder_attention_heads=4,
                     tied_output_projection=tied, dropout=0.0)
    jcfg = jax_config_cls("transformer")(strict=False, **overrides)
    tcfg = torch_config_cls("transformer")(strict=False, **overrides)
    for cfg in (jcfg, tcfg):
        cfg.set_defaults("translation")
    V = 97
    jmodel = JaxTransformer(jcfg, src_vocab_size=V, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    src = rng.integers(4, V, (2, 7))
    dec = rng.integers(4, V, (2, 5))
    params = jmodel.init(jax.random.PRNGKey(1), src_tokens=jnp.asarray(src),
                         decoder_input=jnp.asarray(dec))["params"]
    flat = traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params)), sep="/")
    model = Transformer(tcfg, V, dtype=torch.float32)
    model.load_state_dict(checkpoints.params_to_state_dict(flat))
    want = jmodel.apply({"params": params}, src_tokens=jnp.asarray(src),
                        decoder_input=jnp.asarray(dec))["logits"]
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(dec))["logits"]
    assert np.abs(np.asarray(want) - got.numpy()).max() <= 1e-4
