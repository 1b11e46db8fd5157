"""pasero_torch imports nothing of JAX or pasero_tpu, and its entry points
run on the card unless the caller asks for the CPU."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "models", "deen-mini2")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pasero_tpu")


def port_sources():
    files = glob.glob(os.path.join(ROOT, "pasero_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py")]


def test_importing_every_module_loads_no_jax():
    """In a fresh interpreter: the pytest process already holds jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pasero_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    pasero_torch.__path__, 'pasero_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count = int(proc.stdout.split()[0])
    assert count >= 30, proc.stdout


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_has_no_jax_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path}:{node.lineno} imports {name}"


def test_generator_without_device_raises_without_cuda(monkeypatch):
    from pasero_torch.decoding.generator import TextGenerator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TextGenerator.build(MODEL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TextGenerator.build(MODEL, device="cuda")
    assert TextGenerator.build(MODEL, device="cpu").device.type == "cpu"


def test_decode_cli_without_device_raises_without_cuda(monkeypatch, tmp_path):
    from pasero_torch.cli.decode import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.de"
    src.write_text("Guten Morgen.\n")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([MODEL, "-i", str(src)])


@pytest.mark.parametrize("override,item", [
    (dict(encoder_positional_encoding="t5", decoder_positional_encoding="t5",
          checkpoint_activations=True), "A.8"),
    (dict(decoder_positional_encoding="t5", parallel_attention=True), "A.8"),
    (dict(parallel_attention=True), "A.8"),
    (dict(checkpoint_activations=True), "A.8"),
    (dict(lora_rank=4), "A.10"),
    (dict(attention_kernel="ring"), "A.12"),
])
def test_unported_options_name_their_roadmap_item(override, item):
    from pasero_torch.config import get_model_config_cls
    from pasero_torch.models.transformer import Transformer
    cfg = get_model_config_cls("transformer")(strict=False, **override)
    cfg.set_defaults("translation")
    with pytest.raises(NotImplementedError, match=item):
        Transformer(cfg, 50)


def test_unported_families_name_their_roadmap_item():
    from pasero_torch.config import get_model_cls
    for arch in ("moe_transformer_small", "adapter_transformer_small",
                 "hybrid_transformer_small"):
        model_cls, cfg_cls = get_model_cls(arch)
        cfg = cfg_cls()
        cfg.set_defaults("translation")
        with pytest.raises(NotImplementedError, match="A.10"):
            model_cls(cfg, 50)


def test_decoder_only_options_build():
    """What the decoder-only slice brings builds: rotary positions, grouped
    K/V heads, RMSNorm, gated FFNs, sliding windows, decoder-only stacks."""
    from pasero_torch.config import get_model_cls
    model_cls, cfg_cls = get_model_cls("mistral_7b")
    cfg = cfg_cls(strict=False, decoder_layers=1, embed_dim=64,
                  decoder_attention_heads=4, attention_heads_kv=2,
                  decoder_ffn_dim=96, sliding_window=8)
    cfg.set_defaults("language_modeling")
    model = model_cls(cfg, 50)
    assert not model.is_encoder_decoder and not hasattr(model, "encoder")
    names = dict(model.named_parameters())
    assert names["decoder.layers_0.self_attn.k_proj.weight"].shape == (32, 64)
    assert "decoder.layers_0.ffn.gate.weight" in names
    assert "decoder.layers_0.cross_attn.q_proj.weight" not in names


@pytest.mark.parametrize("bad,error", [("head_dim", ValueError),
                                       ("dtype", TypeError),
                                       ("mixed", TypeError),
                                       ("device", ValueError),
                                       ("device_f32", ValueError)])
def test_flash_kernel_wrapper_refuses_what_it_does_not_take(bad, error):
    """The CUDA wrappers take q, k and v all bfloat16 or all float32 at head
    dims 32, 64 and 128 on the card and raise for anything else (another
    type, mixed types, CPU tensors of either type), before any launch (no
    fallback)."""
    from pasero_torch.ops.flash_attention import (flash_bwd, flash_fwd,
                                                  launch_counts)
    D = 48 if bad == "head_dim" else 64
    dtype = {"dtype": torch.float16, "mixed": torch.float32,
             "device_f32": torch.float32}.get(bad, torch.bfloat16)
    q = torch.zeros((1, 2, 8, D), dtype=dtype)
    kv = q.to(torch.bfloat16) if bad == "mixed" else q
    mask = torch.ones((1, 8), dtype=torch.bool)
    before = launch_counts()
    with pytest.raises(error):
        flash_fwd(q, kv, kv, mask, 0.125, True, None)
    with pytest.raises(error):
        flash_bwd(q, kv, kv, mask, q, q[..., 0].float(), q, 0.125, True, None)
    assert launch_counts() == before


@pytest.mark.parametrize("option,item", [
    (dict(ensemble_ckpt=["other.npz"]), "A.6"),
    (dict(tp_size=2), "A.12"),
    (dict(dp_size=2), "A.12"),
])
def test_unported_decoding_options_name_their_roadmap_item(option, item):
    """Decoder-only models, --quantize int8, sampling and --speculative
    decode now; ensembles and multi-device decoding still raise."""
    from pasero_torch.decoding.generator import TextGenerator
    with pytest.raises(NotImplementedError, match=item):
        TextGenerator.build(MODEL, device="cpu", **option)


@pytest.mark.parametrize("keyword", ["return_layers", "return_weights"])
def test_unported_decode_keywords_name_their_roadmap_item(keyword):
    """decode() refuses what it cannot return yet instead of dropping it."""
    from pasero_torch.decoding.generator import TextGenerator
    gen = TextGenerator.build(MODEL, device="cpu")
    with pytest.raises(NotImplementedError, match="A.6"):
        gen.decode("Guten Morgen .", **{keyword: True})


def test_decoding_options_of_the_serving_slice_build():
    from pasero_torch.decoding.generator import TextGenerator
    lm = os.path.join(ROOT, "pasero_torch", "testdata", "lm-mini2")
    gen = TextGenerator.build(lm, device="cpu", quantize="int8",
                              speculative=True, sampling=True)
    assert gen.model_cfg.model_type == "decoder"


ST = os.path.join(ROOT, "pasero_torch", "testdata", "st-mini")


def test_speech_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """TextGenerator on a speech model, the decode CLI on a feature file,
    feature extraction and the task's wav loading run on the card unless
    asked for the CPU."""
    from pasero_torch.cli.decode import main as decode_main
    from pasero_torch.decoding.generator import TextGenerator
    from pasero_torch.scripts.extract_features import main as extract_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = os.path.join(ST, "wav", "00000.wav")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TextGenerator.build(ST)
    with pytest.raises(RuntimeError, match="--device cpu"):
        decode_main([ST, "-i", os.path.join(ST, "test.feats")])
    out = str(tmp_path / "x.feats")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_main([wav, "-o", out])
    gen = TextGenerator.build(ST, device="cpu")
    gen.task.device = None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gen.task.input_to_sample(wav)
    extract_main([wav, "-o", out, "--device", "cpu"])
    assert os.path.exists(out)
