#!/usr/bin/env python3
"""Full-width decode benchmark and profile of the PyTorch port on one card
(the counterpart of scripts/bench_decode.py, scripts/profile_decode.py and
scripts/bench_1b.py --decode).

Two workloads, with weights from a numpy seed:

- ``--model transformer`` (the default): transformer-base MT, B sentences of
  source length S, beam K (1 = greedy), a left-aligned prompt bucket of P
  slots holding BOS, and N new tokens, through Transformer.encode and
  beam_search / sample_decode;
- ``--model llama_1b`` (scripts/bench_1b.py --decode's shape): the llama_1b
  arch with the language-modeling defaults and a 32000-word vocabulary, B = 8
  prompts of 128 tokens (``--prompt-style copy``: a 16-token phrase repeated,
  where prompt-lookup drafts verify; ``random``: i.i.d. tokens, where they
  almost never do) and 64 new tokens, greedy through sample_decode or, with
  ``--speculative``, speculative_greedy_decode with drafts of 8; with
  ``--quantize int8`` the weights are quantized after loading
  (ops/quantize.py), with ``--fused-head`` the greedy head is the fused
  argmax kernel (``PASERO_FUSED_HEAD=1``);
- ``--model bloom_560m``: the bloom_560m arch (24 layers, width 1024, 16
  heads, ALiBi) with Bloom's vocabulary of 250880 and seeded weights,
  written as a model directory under build/bloom_560m (the alibi-mini
  anchor's bpecodes and dictionary, padded with filler words), decoded
  through ``TextGenerator.decode``: B = 8 prompts of up to 128 tokens
  (words of deen-mini's test.en) and 64 new tokens, greedy; every decoder
  call builds the ALiBi bias over the cache and runs the plain attention
  (decoding never takes flash), and each single-token call writes the cache
  through one slot-write launch per layer;
- ``--model t5_base``: the t5_base arch (12 + 12 layers, width 768, 12
  heads, T5 buckets) with T5's vocabulary of 32128 and seeded weights,
  written as a model directory under build/t5_base (the t5-mini anchor's
  tokenizer and special ids, the dictionary padded with filler words,
  ``attention_kernel: flash``), decoded through ``TextGenerator.decode``:
  B = 8 German sources of 512 tokens (deen-mini's test.de read as a ring)
  and 64 new tokens, greedy; the encoder runs the T5 flash forward once
  per layer, the decoder builds its T5 bias over the cache at every call
  and runs the plain attention, and each single-token call writes the
  cache through one slot-write launch per layer;
- ``--model whisper_base`` (examples/Whisper/inference.yaml's decode): the
  whisper_base arch with Whisper's vocabulary of 51865 and seeded weights,
  written as a model directory under build/whisper_base with B = 8 wavs of
  30 s (seeded noise), decoded through ``TextGenerator.decode``: one launch
  of the mel kernel per wav, 3000 frames into the convolution subsampler
  and 1500 encoder positions, then greedy decoding of 64 new tokens after
  BOS and the three target tags ``<|en|>``, ``<|transcribe|>``,
  ``<|notimestamps|>``.

Prints output tokens/s, ms per decoder call and peak device memory (for
whisper_base also the milliseconds of the features and of the encoder,
each run alone); with --profile, also the device's busy share over one
decode and the device time by kernel, from the chrome trace of
torch.profiler (written to build/profile_decode.json).

    python -m pasero_torch.scripts.bench_decode [--batch 64] [--beam 5]
        [--src-len 32] [--prompt-len 8] [--max-new 64] [--vocab 32768]
        [--arch transformer] [--repeats 3] [--profile]
    python -m pasero_torch.scripts.bench_decode --model llama_1b
        [--quantize int8] [--fused-head] [--speculative]
        [--prompt-style copy|random] [--repeats 3] [--profile]
    python -m pasero_torch.scripts.bench_decode --model bloom_560m
        [--batch 8] [--prompt-len 128] [--max-new 64] [--repeats 3] [--profile]
    python -m pasero_torch.scripts.bench_decode --model t5_base
        [--batch 8] [--src-len 512] [--max-new 64] [--repeats 3] [--profile]
    python -m pasero_torch.scripts.bench_decode --model whisper_base
        [--batch 8] [--max-new 64] [--repeats 3] [--profile]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def random_state(model, seed: int) -> dict:
    """Weights from a numpy seed: normal(0, fan_in^-0.5) matrices, conv
    kernels and embeddings, unit norm scales, zero biases."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, value in model.state_dict().items():
        shape = tuple(value.shape)
        if name.endswith("bias"):
            array = np.zeros(shape, np.float32)
        elif len(shape) == 1:
            array = np.ones(shape, np.float32)
        else:
            # (out, in) and (vocab, embed) weights: fan-in shape[-1];
            # (out, in, k) conv kernels: in * k
            array = (rng.standard_normal(shape, dtype=np.float32)
                     * int(np.prod(shape[1:])) ** -0.5)
        state[name] = torch.from_numpy(array)
    return state


class Workload:
    """A seeded model and batch, and one decode over them."""

    def __init__(self, arch="transformer", vocab=32768, batch=64, src_len=32,
                 prompt_len=8, max_new=64, beam=5, seed=0, device="cuda",
                 dtype=torch.bfloat16):
        from pasero_torch.config import get_model_cls
        model_cls, cfg_cls = get_model_cls(arch)
        cfg = cfg_cls()
        cfg.set_defaults("translation")
        model = model_cls(cfg, src_vocab_size=vocab, dtype=dtype)
        model.load_state_dict(random_state(model, seed))
        self.cfg, self.model = cfg, model.to(device).eval()
        self.beam, self.max_new = beam, max_new
        rng = np.random.default_rng(seed)
        self.src = torch.as_tensor(rng.integers(4, vocab, (batch, src_len)),
                                   device=device)
        self.prompt = torch.full((batch, prompt_len), cfg.padding_idx,
                                 device=device)
        self.prompt[:, -1] = cfg.bos_idx                 # left-aligned BOS
        self.prompt_mask = self.prompt != cfg.padding_idx

    @torch.inference_mode()
    def run(self) -> dict:
        from pasero_torch.decoding.search import beam_search, sample_decode
        encoder_out, encoder_mask = self.model.encode(self.src)
        common = dict(max_new=self.max_new, eos_idx=self.cfg.eos_idx,
                      pad_idx=self.cfg.padding_idx, encoder_out=encoder_out,
                      encoder_mask=encoder_mask)
        if self.beam == 1:
            return sample_decode(self.model, self.prompt, self.prompt_mask,
                                 **common)
        return beam_search(self.model, self.prompt, self.prompt_mask,
                           beam_size=self.beam, **common)

    @staticmethod
    def output_tokens(out) -> int:
        lengths = out["lengths"]
        return int((lengths if lengths.dim() == 1 else lengths[:, 0]).sum())


class LMWorkload:
    """llama_1b with seeded weights and a prompt batch of bench_1b's decode,
    and one greedy or speculative decode over them. ``fused_head`` and
    ``speculative`` may be changed between runs; ``quantize()`` turns the
    weights to int8 in place."""

    VOCAB = 32000

    def __init__(self, batch=8, prompt_len=128, max_new=64,
                 prompt_style="copy", draft_len=8, seed=0, device="cuda",
                 dtype=torch.bfloat16):
        from pasero_torch.config import get_model_cls
        model_cls, cfg_cls = get_model_cls("llama_1b")
        cfg = cfg_cls()
        cfg.set_defaults("language_modeling")
        cfg.dropout = 0.0
        model = model_cls(cfg, src_vocab_size=self.VOCAB, dtype=dtype)
        model.load_state_dict(random_state(model, seed))
        self.cfg, self.model = cfg, model.to(device).eval()
        self.max_new, self.draft_len = max_new, draft_len
        self.fused_head = self.speculative = False
        self.quantized, self.quantized_bytes = 0, (0, 0)
        rng = np.random.default_rng(seed)
        if prompt_style == "copy":
            phrase = rng.integers(4, self.VOCAB, 16)
            prompt = np.tile(phrase, (batch, prompt_len // 16))
        elif prompt_style == "random":
            prompt = rng.integers(4, self.VOCAB, (batch, prompt_len))
        else:
            raise ValueError(f"unknown prompt style {prompt_style!r}")
        self.prompt = torch.as_tensor(prompt, device=device)
        self.prompt_mask = torch.ones_like(self.prompt, dtype=torch.bool)

    def quantize(self) -> None:
        from pasero_torch.ops.quantize import quantize_params, quantized_bytes
        self.quantized = quantize_params(self.model)
        self.quantized_bytes = quantized_bytes(self.model)

    @torch.inference_mode()
    def run(self, sampling: Optional[dict] = None) -> dict:
        """One decode: speculative or greedy, or sampling with
        ``sampling = {"top_k": ..., "generator": ...}``."""
        from pasero_torch.decoding.search import (sample_decode,
                                                  speculative_greedy_decode)
        common = dict(max_new=self.max_new, eos_idx=self.cfg.eos_idx,
                      pad_idx=self.cfg.padding_idx)
        saved = os.environ.get("PASERO_FUSED_HEAD")
        os.environ["PASERO_FUSED_HEAD"] = "1" if self.fused_head else "0"
        try:
            if sampling is not None:
                return sample_decode(self.model, self.prompt, self.prompt_mask,
                                     greedy=False, **sampling, **common)
            if self.speculative:
                return speculative_greedy_decode(
                    self.model, self.prompt, self.prompt_mask,
                    draft_len=self.draft_len, **common)
            return sample_decode(self.model, self.prompt, self.prompt_mask,
                                 **common)
        finally:
            if saved is None:
                del os.environ["PASERO_FUSED_HEAD"]
            else:
                os.environ["PASERO_FUSED_HEAD"] = saved

    output_tokens = staticmethod(Workload.output_tokens)


ST_MINI = os.path.join(ROOT, "pasero_torch", "testdata", "st-mini")
ALIBI_MINI = os.path.join(ROOT, "pasero_torch", "testdata", "alibi-mini")
T5_MINI = os.path.join(ROOT, "pasero_torch", "testdata", "t5-mini")
DEEN_MINI = os.path.join(ROOT, "examples", "deen-mini", "data")


def write_dictionary(src_dir: str, model_dir: str, vocab: int) -> None:
    """``src_dir``'s bpecodes and dictionary in ``model_dir``, the dictionary
    padded with filler words to ``vocab`` entries (it adds its 4 special
    tokens in front)."""
    import shutil
    shutil.copy(os.path.join(src_dir, "bpecodes"), model_dir)
    with open(os.path.join(src_dir, "dict.txt")) as f:
        words = f.read().splitlines()
    words += [f"w{i}@ 0" for i in range(vocab - 4 - len(words))]
    with open(os.path.join(model_dir, "dict.txt"), "w") as f:
        f.write("\n".join(words) + "\n")


def write_lm_dir(model_dir: str, arch: str, vocab: int, max_new: int = 64,
                 seed: int = 0, layers: Optional[int] = None) -> None:
    """A decoder-only model directory as the training CLI leaves one
    (config.json, model_best.npz, inference.yaml, bpecodes, dict.txt) for
    ``arch`` with the language-modeling defaults, weights from a numpy seed
    and the alibi-mini anchor's tokenizer with a dictionary of ``vocab``
    entries. ``layers`` cuts the depth."""
    import yaml

    from pasero_torch.checkpoints import save_flat, state_dict_to_params
    from pasero_torch.config import get_model_cls
    model_cls, cfg_cls = get_model_cls(arch)
    cfg = cfg_cls()
    cfg.set_defaults("language_modeling")
    cfg.dropout = 0.0
    if layers:
        cfg.decoder_layers = layers
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({**cfg.as_dict(), "arch": arch}, f, indent=2, default=str)
    write_dictionary(ALIBI_MINI, model_dir, vocab)
    with open(os.path.join(ALIBI_MINI, "inference.yaml")) as f:
        inference = yaml.safe_load(f)
    inference.update(arch=arch, max_output_len=max_new,
                     max_len=cfg.decoder_max_len)
    with open(os.path.join(model_dir, "inference.yaml"), "w") as f:
        yaml.safe_dump(inference, f)
    model = model_cls(cfg, src_vocab_size=vocab)
    save_flat(os.path.join(model_dir, "model_best.npz"),
              state_dict_to_params(random_state(model, seed)))


def write_t5_dir(model_dir: str, vocab: int, max_new: int = 64, seed: int = 0,
                 layers: Optional[int] = None) -> None:
    """A t5_base model directory as the training CLI leaves one
    (config.json, model_best.npz, inference.yaml, bpecodes, dict.txt), with
    the translation defaults, ``attention_kernel: flash``, weights from a
    numpy seed, and the t5-mini anchor's tokenizer and special ids with a
    dictionary of ``vocab`` entries. ``layers`` cuts the depth of both
    stacks."""
    import yaml

    from pasero_torch.checkpoints import save_flat, state_dict_to_params
    from pasero_torch.config import get_model_cls
    model_cls, cfg_cls = get_model_cls("t5_base")
    cfg = cfg_cls()
    cfg.set_defaults("translation")
    cfg.dropout = 0.0
    cfg.attention_kernel = "flash"
    with open(os.path.join(T5_MINI, "config.json")) as f:
        anchor = json.load(f)
    for key in ("padding_idx", "bos_idx", "eos_idx", "unk_idx"):
        setattr(cfg, key, anchor[key])
    if layers:
        cfg.encoder_layers = cfg.decoder_layers = layers
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({**cfg.as_dict(), "arch": "t5_base"}, f, indent=2,
                  default=str)
    write_dictionary(T5_MINI, model_dir, vocab)
    with open(os.path.join(T5_MINI, "inference.yaml")) as f:
        inference = yaml.safe_load(f)
    inference.update(beam_size=1, max_output_len=max_new,
                     max_source_len=cfg.encoder_max_len,
                     max_target_len=cfg.decoder_max_len)
    with open(os.path.join(model_dir, "inference.yaml"), "w") as f:
        yaml.safe_dump(inference, f)
    model = model_cls(cfg, src_vocab_size=vocab)
    save_flat(os.path.join(model_dir, "model_best.npz"),
              state_dict_to_params(random_state(model, seed)))


def ring_texts(generator, batch: int, max_len: int, name: str,
               field: str) -> list:
    """``batch`` texts of the words of deen-mini's file ``name`` (read as a
    ring), each the longest run of words from its own start, 97 words after
    the last one's, whose ``field`` of the preprocessed sample fits
    ``max_len`` tokens."""
    with open(os.path.join(DEEN_MINI, name)) as f:
        words = f.read().split()
    task, meta = generator.task, generator.task.make_meta()

    def prompt(start, n):
        return " ".join(words[(start + j) % len(words)] for j in range(n))

    def length(text):   # a sample the task skips is too long
        sample = task.preprocess(task.input_to_sample(text, meta))
        return len(sample[field]) if sample else max_len + 1

    prompts = []
    for i in range(batch):
        n = 1
        while length(prompt(i * 97, n + 1)) <= max_len:
            n += 1
        prompts.append(prompt(i * 97, n))
    return prompts


def write_whisper_dir(model_dir: str, batch: int = 8, seconds: float = 30.0,
                      max_new: int = 64, seed: int = 0,
                      layers: Optional[int] = None) -> list:
    """A whisper_base model directory as the training CLI leaves one
    (config.json, model_best.npz, inference.yaml, bpecodes, dict.txt), with
    weights from a numpy seed and a dictionary of Whisper's 51865 entries
    (st-mini's words and target tags, then filler words), and ``batch``
    16 kHz wavs of ``seconds`` of seeded noise beside it; returns the wav
    paths. ``layers`` cuts the depth of both stacks."""
    import wave

    import yaml

    from pasero_torch.checkpoints import save_flat, state_dict_to_params
    from pasero_torch.config import get_model_cls
    model_cls, cfg_cls = get_model_cls("whisper_base")
    cfg = cfg_cls()
    cfg.set_defaults("speech_translation")
    cfg.dropout = 0.0
    if layers:
        cfg.encoder_layers = cfg.decoder_layers = layers
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({**cfg.as_dict(), "arch": "whisper_base"}, f, indent=2,
                  default=str)
    write_dictionary(ST_MINI, model_dir, WhisperWorkload.VOCAB)
    with open(os.path.join(ST_MINI, "inference.yaml")) as f:
        inference = yaml.safe_load(f)
    inference.update(max_output_len=max_new, max_source_len=cfg.encoder_max_len,
                     max_target_len=cfg.decoder_max_len)
    with open(os.path.join(model_dir, "inference.yaml"), "w") as f:
        yaml.safe_dump(inference, f)
    model = model_cls(cfg, src_vocab_size=0,
                      tgt_vocab_size=WhisperWorkload.VOCAB)
    save_flat(os.path.join(model_dir, "model_best.npz"),
              state_dict_to_params(random_state(model, seed)))
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(batch):
        audio = np.clip(0.1 * rng.standard_normal(int(seconds * 16000)),
                        -1.0, 32767 / 32768)
        paths.append(os.path.join(model_dir, f"{i:05d}.wav"))
        with wave.open(paths[-1], "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((audio * 32768).astype(np.int16).tobytes())
    return paths


class GeneratorWorkload:
    """A ``TextGenerator`` on a model directory and its inputs; one run is
    ``TextGenerator.decode`` of the inputs, with the decoder calls counted
    by a forward pre-hook."""

    def __init__(self, model_dir: str, inputs: list, device="cuda"):
        from pasero_torch.decoding.generator import TextGenerator
        self.generator = TextGenerator.build(model_dir, device=device)
        self.model, self.cfg = self.generator.model, self.generator.model_cfg
        self.inputs = inputs
        self.decoder_calls = 0

        def count(*_):
            self.decoder_calls += 1
        self.model.decoder.register_forward_pre_hook(count)

    def run(self) -> dict:
        """One ``TextGenerator.decode``; its decoder calls and its tokens."""
        calls = self.decoder_calls
        hyps = self.generator.decode(self.inputs, return_scores=True)
        return {"hyps": hyps, "model_calls": self.decoder_calls - calls}

    @staticmethod
    def output_tokens(out) -> int:
        return sum(len(h[0]["tokens"]) for h in out["hyps"])


class WhisperWorkload(GeneratorWorkload):
    """whisper_base with seeded weights in a model directory
    (``write_whisper_dir``) and B wavs of 30 s; one run is
    ``TextGenerator.decode`` of the wav paths: each wav read and turned into
    log-mel features by one mel launch and brought back to the host, the
    batch bucketed and padded, the encoder, and greedy decoding of up to 64
    new tokens after BOS and the three target tags."""

    VOCAB = 51865

    def __init__(self, batch=8, seconds=30.0, max_new=64, seed=0,
                 device="cuda", model_dir=None, layers=None):
        model_dir = model_dir or os.path.join(ROOT, "build", "whisper_base")
        self.wavs = write_whisper_dir(model_dir, batch, seconds, max_new,
                                      seed, layers)
        super().__init__(model_dir, self.wavs, device)
        self.prompt = self.generator.task.get_target_tags(
            self.generator.task.make_meta())

    @torch.inference_mode()
    def stages(self) -> dict:
        """Host milliseconds of two parts of a decode, each run alone and
        ended by a synchronize: the features (read, mel, copy to the host)
        of every wav, and the encoder on the collated batch."""
        gen = self.generator
        meta = gen.task.make_meta()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = [gen.task.preprocess(gen.task.input_to_sample(w, meta))
                   for w in self.wavs]
        t1 = time.perf_counter()
        batch = gen._prepare_batch(samples)
        src = gen._tensor(batch["src_tokens"])
        mask = gen._tensor(batch["src_mask"], torch.bool)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        gen.model.encode(src, mask)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return {"features": (t1 - t0) * 1e3, "collate": (t2 - t1) * 1e3,
                "encoder": (t3 - t2) * 1e3}


class T5Workload(GeneratorWorkload):
    """t5_base with seeded weights in a model directory (``write_t5_dir``)
    and B German sources of up to 512 tokens (``ring_texts`` of test.de),
    decoded greedily."""

    VOCAB = 32128

    def __init__(self, batch=8, src_len=512, max_new=64, seed=0,
                 device="cuda", model_dir=None, layers=None):
        model_dir = model_dir or os.path.join(ROOT, "build", "t5_base")
        write_t5_dir(model_dir, self.VOCAB, max_new, seed, layers)
        super().__init__(model_dir, [], device)
        self.inputs = ring_texts(self.generator, batch, src_len, "test.de",
                                 "encoder_input")


class BloomWorkload(GeneratorWorkload):
    """bloom_560m with seeded weights in a model directory (``write_lm_dir``)
    and B text prompts of up to 128 tokens (``ring_texts`` of test.en),
    decoded greedily."""

    VOCAB = 250880

    def __init__(self, batch=8, prompt_len=128, max_new=64, seed=0,
                 device="cuda", model_dir=None, layers=None):
        model_dir = model_dir or os.path.join(ROOT, "build", "bloom_560m")
        write_lm_dir(model_dir, "bloom_560m", self.VOCAB, max_new, seed,
                     layers)
        super().__init__(model_dir, [], device)
        self.inputs = ring_texts(self.generator, batch, prompt_len, "test.en",
                                 "decoder_input")


def trace_profile(fn, path: str, kernel_names: tuple = ()) -> dict:
    """Run ``fn`` under torch.profiler and summarize its chrome trace
    (written to ``path``): wall time, the device's busy time and share (the
    union of kernel, copy and memset intervals), the device time of the 15
    largest operations, and launches and mean device time of each kernel
    whose name contains one of ``kernel_names``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    # union of device intervals (microseconds)
    busy, end = 0.0, None
    for s, d in sorted((e["ts"], e["dur"]) for e in device):
        if end is None or s > end:
            busy, end = busy + d, s + d
        elif s + d > end:
            busy, end = busy + s + d - end, s + d
    by_name: dict = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    kernels = {}
    for key in kernel_names:
        durs = [e["dur"] for e in device if key in e["name"]]
        kernels[key] = {"launches": len(durs),
                        "device_us_mean": sum(durs) / max(len(durs), 1)}
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / (wall * 1e3),
            "device_ops": len(device), "kernels": kernels,
            "top_device_ms": [(name[:90], us / 1e3) for name, us in top]}


# the port's kernels by a part of their names in a trace
KERNELS = {"slot_write": "slot_write_kernel",
           # flash_bwd:: the bf16 ones of every bias kind, flash_f32:: the
           # float32 ones
           "flash_fwd": "::fwd_kernel",
           # the decode kernel (M <= 80) and the prompt's, together and
           # apart (weight_gemm.cuh's mainloops with int8_matmul.cu's
           # epilogues)
           "int8_matmul": "int8mm::",
           "int8_decode": "int8mm::StoreDecode",
           "int8_prompt": "int8mm::StorePrompt",
           # the fused head's partials (its decode kernel's, int8 prompt
           # kernel's or bf16 gemm_kernel's epilogue) and their merge
           "fused_head_partials": "Partials",
           "fused_head_combine": "fused_head::combine_kernel",
           "power_mel": "power_mel_kernel"}


def profile(work, out_dir: str) -> dict:
    """Device busy share and device time by kernel over one decode."""
    out = trace_profile(work.run, os.path.join(out_dir, "profile_decode.json"),
                        tuple(KERNELS.values()))
    found = out.pop("kernels")
    for name, key in KERNELS.items():
        out[f"{name}_launches"] = found[key]["launches"]
        out[f"{name}_device_us_mean"] = found[key]["device_us_mean"]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="transformer",
                        choices=["transformer", "llama_1b", "bloom_560m",
                                 "t5_base", "whisper_base"])
    parser.add_argument("--arch", default="transformer",
                        help="the MT arch (--model transformer)")
    parser.add_argument("--batch", type=int)
    parser.add_argument("--beam", type=int, default=5)
    parser.add_argument("--src-len", type=int)
    parser.add_argument("--prompt-len", type=int)
    parser.add_argument("--max-new", type=int, default=64)
    parser.add_argument("--vocab", type=int, default=32768)
    parser.add_argument("--quantize", choices=["int8"])
    parser.add_argument("--fused-head", action="store_true")
    parser.add_argument("--speculative", action="store_true")
    parser.add_argument("--prompt-style", default="copy",
                        choices=["copy", "random"])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this benchmark measures a CUDA card and none is "
                         "available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if args.model == "llama_1b":
        work = LMWorkload(args.batch or 8, args.prompt_len or 128,
                          args.max_new, args.prompt_style)
        work.fused_head, work.speculative = args.fused_head, args.speculative
        if args.quantize:
            work.quantize()
        shape = {"batch": args.batch or 8, "prompt_len": args.prompt_len or 128,
                 "max_new": args.max_new, "vocab": LMWorkload.VOCAB,
                 "quantize": args.quantize, "fused_head": args.fused_head,
                 "speculative": args.speculative,
                 "prompt_style": args.prompt_style,
                 "quantized_weights": work.quantized,
                 "quantized_mib": work.quantized_bytes[0] / 2 ** 20}
    elif args.model == "bloom_560m":
        work = BloomWorkload(args.batch or 8, args.prompt_len or 128,
                             args.max_new)
        shape = {"batch": args.batch or 8,
                 "prompt_len": args.prompt_len or 128,
                 "max_new": args.max_new, "vocab": BloomWorkload.VOCAB}
    elif args.model == "t5_base":
        src_len = args.src_len or 512
        work = T5Workload(args.batch or 8, src_len, args.max_new)
        shape = {"batch": args.batch or 8, "src_len": src_len,
                 "max_new": args.max_new, "vocab": T5Workload.VOCAB}
    elif args.model == "whisper_base":
        work = WhisperWorkload(args.batch or 8, max_new=args.max_new)
        shape = {"batch": args.batch or 8, "seconds": 30.0,
                 "frames": 3000, "encoder_positions": 1500,
                 "prompt": work.prompt, "max_new": args.max_new,
                 "vocab": WhisperWorkload.VOCAB}
    else:
        work = Workload(args.arch, args.vocab, args.batch or 64,
                        args.src_len or 32, args.prompt_len or 8,
                        args.max_new, args.beam)
        shape = {"arch": args.arch, "batch": args.batch or 64,
                 "beam": args.beam, "src_len": args.src_len or 32,
                 "prompt_len": args.prompt_len or 8,
                 "max_new": args.max_new, "vocab": args.vocab}
    work.run()                                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = work.run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    tokens = work.output_tokens(out)
    best = min(times)
    result = {"card": smi, "model": args.model, **shape,
              "output_tokens": tokens, "model_calls": out["model_calls"],
              "seconds": times, "tok_per_s": tokens / best,
              "ms_per_decoder_call": best * 1e3 / out["model_calls"],
              "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    if args.model == "whisper_base":
        result["stages_ms"] = work.stages()
    if args.profile:
        result["profile"] = profile(work, os.path.join(ROOT, "build"))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
