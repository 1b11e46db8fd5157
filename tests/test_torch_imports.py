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
    (dict(decoder_positional_encoding="rotary"), "A.8"),
    (dict(attention_heads_kv=2), "A.8"),
    (dict(rms_norm=True), "A.8"),
    (dict(activation_fn="swiglu"), "A.8"),
    (dict(lora_rank=4), "A.10"),
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
