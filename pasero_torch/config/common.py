# Copy of pasero_tpu/config/common.py; only compute_dtype differs: it returns torch dtypes.
"""Distributed / tracker / decoding / eval / preprocessing / task option groups.

Field surface follows the reference's public API (pasero/config.py:500-743), with
TPU-native semantics: ranks and NCCL init methods are replaced by a device-mesh
description (data/tensor/expert axes) consumed by ``pasero_tpu.parallel``.
"""

from __future__ import annotations

import random
from typing import Optional

from .core import Config, argument

BLEU_TOKENIZERS = ("13a", "intl", "zh", "ja-mecab", "char", "none", "flores200")
METRICS = ("bleu", "spbleu", "chrf", "chrf++", "len_ratio", "wer", "langid")


class DistributedConfig(Config):
    """Parallelism topology. On TPU this configures a single `jax.sharding.Mesh`
    with (data, tensor, expert) axes instead of NCCL process groups
    (pasero/config.py:500-546). ``tp_size * dp_size * ep_size`` must divide the
    device count; unlike the reference, TP x DP composition is supported."""

    dp_size: Optional[int] = argument(
        help="data-parallel axis size (default: devices / (tp_size * ep_size))")
    tp_size: int = argument(
        1, help="tensor-parallel axis size: shard attention heads and FFN inner dim "
                "across this many devices (GSPMD)")
    ep_size: int = argument(
        1, help="expert-parallel axis size for Mixture-of-Experts layers")
    cp_size: int = argument(
        1, help="context-parallel axis size: shard the sequence dimension and "
                "run self-attention as a ring collective over the 'seq' mesh "
                "axis (exact attention on N x longer contexts; a capability "
                "the reference lacks)")
    pp_size: int = argument(
        1, help="pipeline-parallel axis size: stack the decoder layers over "
                "the 'stage' mesh axis and train with a GPipe microbatch "
                "schedule (decoder-only models; composes with dp_size). The "
                "reference's PP is inference-only layer placement; big-model "
                "inference here uses --tp-size/--fsdp mesh decode instead")
    pp_microbatches: Optional[int] = argument(
        help="microbatches per step with --pp-size (default: 2 x pp_size; "
             "more microbatches shrink the pipeline bubble)")
    fsdp: bool = argument(
        False, help="ZeRO-style sharding of parameters and optimizer state along the "
                    "data axis (GSPMD equivalent of torch FSDP)")
    sequence_parallel: bool = argument(
        True, help="with tp_size>1, also shard layer-norm/residual activations "
                   "(subsumed by GSPMD activation sharding; disabled at inference)")
    dtype: str = argument(
        "bfloat16", choices=["float16", "float32", "bfloat16"],
        help="compute dtype; on TPU, float16 is treated as bfloat16 (MXU-native). "
             "Parameters and optimizer states stay float32")
    seed: Optional[int] = argument(
        help="RNG seed (default: random). The input pipeline is seeded per host")
    per_host_data: str = argument(
        "replicated", choices=["replicated", "sharded"],
        help="multi-host input mode (ignored single-process): 'replicated' — "
             "every host builds the same global batches (shared filesystem, "
             "same seed) and its devices pull their rows, exact "
             "single-process semantics; 'sharded' — each host samples a "
             "disjoint stream and contributes 1/num_processes of every "
             "batch (fixed batch shapes, scales input I/O with the pod)")
    prng_impl: str = argument(
        "rbg", choices=["rbg", "unsafe_rbg", "threefry2x32"],
        help="device PRNG for dropout: the hardware rng_bit_generator ('rbg', "
             "~25%% faster training steps than threefry on TPU) or the "
             "splittable threefry (bit-for-bit reproducible across backends)")
    # accepted for CLI compatibility with the reference; ignored on TPU:
    start_rank: int = argument(0, hidden=True)
    distributed_init_method: Optional[str] = argument(hidden=True)

    @property
    def distributed_world_size(self) -> int:
        return ((self.dp_size or 1) * (self.tp_size or 1)
                * (self.ep_size or 1) * (self.cp_size or 1)
                * (self.pp_size or 1))

    @property
    def compute_dtype(self):
        import torch
        return {"float16": torch.bfloat16, "bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype]

    def pick_seed(self):
        if self.seed is None or self.seed == -1:
            self.seed = random.randrange(10 ** 9)
        return self.seed


class TrackerConfig(Config):
    tracker: str = argument(
        "none", choices=["wandb", "neptune", "mlflow", "none"],
        help="experiment tracker backend")
    tracker_project_name: Optional[str] = argument(help="tracker project name")
    tracker_run_name: Optional[str] = argument(help="tracker run name")


class DecodingConfig(Config):
    """Generation options (pasero/config.py:563-600)."""

    max_output_len: int = argument(
        100, help="maximum number of generated tokens (prompt excluded)")
    beam_size: Optional[int] = argument(
        defaults={"language_modeling": 1, "translation": 5, "dialogue": 1,
                  "speech_translation": 5, "doc_level_translation": 5,
                  "nllb_translation": 5, "default": 5},
        help="beam size (1 = greedy)")
    repeat_penalty: float = argument(
        1.0, help="divide logits of already-generated tokens by this (sampling only)")
    sampling: bool = argument(False, help="sample instead of beam search")
    speculative: bool = argument(
        False, help="greedy decoding with prompt-lookup speculation: verify "
                    "a chunk of drafted tokens (n-gram continuations of the "
                    "source/prompt/prefix) per decoder call — exact greedy "
                    "output, fewer model calls on copy-heavy text. Applies "
                    "when beam_size=1, no sampling, and no blacklist/stop "
                    "sequences are set")
    speculative_draft_len: int = argument(
        6, help="drafted tokens verified per decoder call with --speculative")
    sampling_topk: int = argument(0, help="restrict sampling to the k best tokens")
    sampling_topp: float = argument(1.0, help="nucleus sampling probability mass")
    sampling_temperature: float = argument(1.0, help="softmax temperature for sampling")
    len_penalty: float = argument(
        1.0, help="normalize hypothesis scores by (length+1)^p for beam ranking")


class EvalConfig(Config):
    teacher_forcing: bool = argument(
        False, help="score the reference instead of free decoding")
    bleu_tok: Optional[str] = argument(
        aliases=["bleu_tokenize"], choices=BLEU_TOKENIZERS,
        help="sacreBLEU tokenizer (default: zh for Chinese, ja-mecab for Japanese, 13a otherwise)")
    eval_lc: bool = argument(
        False, aliases=["bleu_lc"], help="lowercase before BLEU")
    metrics: Optional[list[str]] = argument(
        choices=METRICS,
        defaults={"language_modeling": [], "dialogue": [],
                  "default": ["chrf", "bleu", "chrf++", "spbleu", "len_ratio"]},
        help="evaluation metrics to compute")


class NoiseConfig(Config):
    """Training-time text noise (pasero/config.py:627-656, tokenizers/noise.py)."""

    space_noise: float = argument(0.0, help="drop/insert whitespace with this probability")
    punct_noise: float = argument(0.0, help="drop punctuation with this probability")
    char_noise: float = argument(0.0, help="apply char-level edits with this probability")
    noise_ops: list[str] = argument(
        ["ins", "del", "sub", "swap"], choices=["ins", "del", "sub", "swap"], nargs="+",
        help="allowed character noise operations")
    word_noise: float = argument(0.0, help="drop whole words with this probability")
    masking: float = argument(0.0, help="mask whole words with this probability")


class PreprocessingConfig(NoiseConfig):
    tokenizer: str = argument(
        "pasero", choices=["pasero", "sentencepiece", "none", "hf", "char"],
        help="subword tokenizer implementation")
    tokenizer_path: Optional[str] = argument(
        help="path to the tokenizer model, absolute or relative to the data/model dir")
    inline_case: bool = argument(
        False, help="lowercase text and emit <T>/<U> case tags after the affected "
                    "subword (on by default with --tokenizer pasero)")
    dict: Optional[str] = argument(
        aliases=["source_dict"],
        help="path to the (source) dictionary; defaults to dict.json or dict.txt")
    bpe_dropout: float = argument(0.0, help="BPE dropout rate on source training data")
    spell_out: float = argument(0.0, help="probability of spelling out a source word")
    keep_whitespaces: Optional[bool] = argument(
        defaults={"language_modeling": True, "dialogue": True, "default": False},
        help="keep whitespace / non-printing characters verbatim")
    normalize_punctuation: bool = argument(
        False, help="apply Moses-style punctuation normalization rules")
    blacklist: list[str] = argument([], help="tokens that must not be generated")
    stop_sequences: list[str] = argument(
        [], help="raw-text sequences that stop generation (sampling only)")
    strip_prompt: bool = argument(True, help="remove the prompt from detokenized output")
    protect_tokens: list[str] = argument(
        [], help="extra user tokens protected from tokenization")


class TaskConfig(PreprocessingConfig):
    batch_size: int = argument(
        4096, help="max tokens per batch (a pair counts as max(src_len, tgt_len))")
    batch_size_multiple: Optional[int] = argument(
        help="round the number of lines per batch down to a multiple of this")
    lines_per_batch: Optional[int] = argument(help="max lines per batch")
    domains: Optional[list[str]] = argument(
        aliases=["domain"], nargs="+", help="domain(s) for tags and domain adapters")

    def replace_placeholders(self, path: str) -> str:
        raise NotImplementedError

    def finalize(self):
        for opt in ("tokenizer_path", "dict"):
            value = getattr(self, opt, None)
            if value:
                setattr(self, opt, self.replace_placeholders(value))

    def set_max_length(self, model_cfg) -> int:
        raise NotImplementedError

    def inference_options(self) -> dict:
        """Non-default preprocessing options worth saving to inference.yaml."""
        base = PreprocessingConfig()
        out = {}
        for name in PreprocessingConfig._fields:
            value = getattr(self, name)
            if value != getattr(base, name):
                out[name] = value
        return out
