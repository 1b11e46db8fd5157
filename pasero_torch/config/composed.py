# Copy of pasero_tpu/config/composed.py, verbatim.
"""Composed top-level configs: TrainingConfig and Decoding{API,CLI}Config.

These merge options from four sources with precedence CLI > kwargs > YAML >
task-dependent defaults, distributing each option to the config group that owns
it (main / task / dataset / model), as in pasero/config.py:1711-1760 and
744-869.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
from typing import Optional, Union

import yaml

from .core import Config, argument
from .common import (DecodingConfig, DistributedConfig, EvalConfig, TaskConfig,
                     TrackerConfig)
from .models import TransformerConfig
from .registry import get_model_config_cls
from .tasks import get_task_config_cls

DATASET_CONFIG_REGISTRY: dict[str, type] = {}


def register_dataset_config(name: str):
    def wrapper(cls):
        DATASET_CONFIG_REGISTRY[name] = cls
        return cls
    return wrapper


def get_dataset_config_cls(name: str) -> type:
    if name not in DATASET_CONFIG_REGISTRY:
        raise KeyError(f"unknown dataset type {name!r}; available: {sorted(DATASET_CONFIG_REGISTRY)}")
    return DATASET_CONFIG_REGISTRY[name]


# ---------------------------------------------------------------------------
# dataset configs (pasero/config.py:942-1054)
# ---------------------------------------------------------------------------

class TrainingDatasetConfig(Config):
    buffer_size: int = argument(
        100000, help="lines preprocessed before batching; larger = better "
                     "length-sorting, slower startup")
    batch_by: Optional[list[str]] = argument(
        choices=["lang", "source_lang", "target_lang", "domain"],
        help="homogeneous batching on this metadata (needed for per-lang adapters)")
    lang_temperature: float = argument(
        1.0, help="language-pair sampling temperature (1: by size, large: uniform)")
    dataloader_workers: int = argument(
        1, help="worker threads for host-side collation")
    reset_line_index: bool = argument(False, help="rebuild the cached line index")
    cache_line_index: bool = argument(True, help="cache line positions on disk")
    line_index_path: Optional[str] = argument(help="path of the line-index cache")
    block_size: int = argument(
        256, help="consecutive lines are grouped into blocks of this size for "
                  "sampling and indexed reads")
    num_workers: int = argument(4, help="tokenizer worker processes")
    telemetry_interval: float = argument(
        180, help="seconds between pipeline-statistics log lines (0: off)")
    shuffle: bool = argument(True, help="shuffle corpus lines and batches")
    max_lines: Optional[int] = argument(help="max line pairs per training corpus")
    truncate: bool = argument(False, help="truncate too-long examples instead of skipping")
    close_files: bool = argument(False, help="close files between reads")
    store_files_under: int = argument(
        2 ** 27, help="keep files smaller than this many bytes in memory")
    # accepted for reference CLI compatibility (torch DataLoader knobs; no-ops here)
    dataloader_pin_memory: bool = argument(True, hidden=True)
    dataloader_prefetch_factor: int = argument(2, hidden=True)


@register_dataset_config("dynamic")
class DynamicTrainingDatasetConfig(TrainingDatasetConfig):
    per_gpu_batching: bool = argument(
        False, help="each host process batches its own shard instead of a shared batcher")


@register_dataset_config("simple")
class SimpleDynamicTrainingDatasetConfig(DynamicTrainingDatasetConfig):
    buffer_size: int = 5000
    dataloader_workers: int = 4
    dataloader_prefetch_factor: int = 10
    store_files_under: int = 0
    cache_data: bool = argument(
        False, help="cache preprocessed samples in memory (small/speech datasets)")
    max_cache_size: int = argument(128, help="max cache size in GiB per host")


@register_dataset_config("debug")
class DebugTrainingDatasetConfig(SimpleDynamicTrainingDatasetConfig):
    buffer_size: int = 1000
    dataloader_workers: int = 0
    dataloader_prefetch_factor: int = 1


# ---------------------------------------------------------------------------
# source merging
# ---------------------------------------------------------------------------

def _build_parser(cfg_classes: list[type]) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(conflict_handler="resolve", add_help=False)
    for cls in cfg_classes:
        cls.add_args(parser)
    return parser


def _parse_cli(opts: list[str], cfg_classes: list[type], strict: bool) -> dict:
    parser = _build_parser(cfg_classes)
    if strict:
        ns = parser.parse_args(list(opts))
    else:
        ns, _ = parser.parse_known_args(list(opts))
    return vars(ns)


def _distribute(options: dict, configs: list[Config], strict: bool, label: str):
    """Apply each option to every config that owns the field; error on orphans."""
    unclaimed = []
    for key, value in options.items():
        owners = [cfg for cfg in configs if key in cfg._fields]
        if not owners:
            unclaimed.append(key)
            continue
        for cfg in owners:
            cfg.update({key: value})
    if unclaimed and strict:
        raise TypeError(f"unknown {label} option(s): {unclaimed}")


class TrainingConfig(DistributedConfig, TrackerConfig, EvalConfig, DecodingConfig):
    """Top-level training configuration (pasero/config.py:1469-1860)."""

    # composed sub-configs, set in __init__ (not CLI-visible):
    dataset_cfg: Optional[TrainingDatasetConfig] = argument(None, hidden=True)
    model_cfg: Optional[TransformerConfig] = argument(None, hidden=True)
    task_cfg: Optional[TaskConfig] = argument(None, hidden=True)

    lr: float = argument(0.0005, help="peak learning rate")
    adam_betas: list[float] = argument([0.9, 0.999], nargs="2", help="Adam betas")
    warmup: int = argument(
        4000, help="linear warmup steps; 0 switches to linear decay to min_lr")
    init_lr: float = argument(0.0, help="initial LR during warmup")
    min_lr: float = argument(0.0, help="LR floor")
    weight_decay: float = argument(0.0, help="AdamW weight decay")
    clip_norm: float = argument(1.0, help="global gradient-norm clip")
    reset: bool = argument(False, help="ignore existing checkpoints; train from scratch")
    reset_optimizer: bool = argument(
        False, help="load model weights only; reset optimizer/scheduler/metrics")
    flexible: bool = argument(
        False, help="tolerate missing/unexpected checkpoint parameters")
    amp: bool = argument(False, hidden=True)  # GPU AMP; no-op on TPU (bf16 default)
    virtual_dp_size: int = argument(
        1, help="gradient accumulation factor, normalized by dp_size")
    find_unused_parameters: bool = argument(False, hidden=True)  # DDP knob; no-op
    flat_fp16: bool = argument(False, hidden=True)  # fairseq fp16 path; no-op on TPU
    memory_efficient_fp16: bool = argument(True, hidden=True)
    optimizer_states_as_fp32: bool = argument(
        True, help="keep Adam moments in float32 regardless of compute dtype")
    reset_params_regex: Optional[str] = argument(
        help="drop checkpoint parameters matching this regex on load")
    config: Optional[str] = argument(aliases=["c"], help="YAML configuration file")
    data_dir: Optional[str] = argument(help="directory with training data (required)")
    model_dir: Optional[str] = argument(
        aliases=["o"], help="output directory for checkpoints and logs (required)")
    train_corpora: list = argument(
        ["train"], nargs="+", help="training corpus prefixes (or dicts in YAML)")
    valid_corpora: list = argument(
        ["valid"], nargs="+", help="validation corpus prefixes (or dicts in YAML)")
    ckpt: Optional[str] = argument(help="checkpoint to restore")
    continue_: bool = argument(
        False, help="continue from CKPT keeping optimizer state and step count")
    arch: str = argument("transformer", help="model architecture name")
    max_steps: Optional[int] = argument(help="number of training updates (required)")
    valid_interval: Optional[int] = argument(help="updates between validations (required)")
    log_interval: int = argument(100, help="updates between metric logs")
    log_file: Optional[str] = argument(help="log path relative to model_dir")
    save_interval: Optional[int] = argument(
        help="updates between checkpoints (default valid_interval)")
    save_initial_checkpoint: bool = argument(
        False, help="save weights as model_init before training")
    save_trainable_only: bool = argument(
        False, help="checkpoint only trainable parameters (e.g. adapters)")
    keep_interval: Optional[int] = argument(
        help="keep checkpoints whose step is a multiple of this")
    keep_last: int = argument(1, help="number of last checkpoints to keep")
    async_save: bool = argument(
        False, help="write checkpoints from a background thread (one save in "
                    "flight) so the training loop never blocks on the "
                    "device->host transfer and npz write")
    average_checkpoints: bool = argument(
        False, help="average the last checkpoints before validation")
    validate_at_start: bool = argument(False, help="validate before training")
    only_validate: bool = argument(False, help="run validation only")
    benchmark: bool = argument(False, help="profile per-component time")
    verbose: bool = argument(False, aliases=["v"], help="log data examples")
    freeze_params_regex: Optional[str] = argument(
        help="freeze parameters matching this regex")
    train_params_regex: Optional[str] = argument(
        help="train only parameters matching this regex")
    task: str = argument("translation", help="task name")
    dataset_type: str = argument("dynamic", help="dataset pipeline type")
    debug: bool = argument(False, help="single-process verbose debug mode")
    early_stopping_metric: Optional[str] = argument(
        defaults={"language_modeling": "nll_loss", "dialogue": "nll_loss",
                  "default": "chrf"},
        help="metric selecting the best checkpoint")
    patience: Optional[int] = argument(
        help="stop when validation has not improved for N evaluations")
    patience_min_steps: int = argument(0, help="steps before patience starts")
    expected_scores: list = argument(
        [], help="regression-test scores (YAML only): [{corpus, steps, metrics}]")

    def __init__(self, *opts, strict: bool = True, **kwargs):
        opts = list(opts) or sys.argv[1:]
        for field in self._fields.values():  # defaults first
            setattr(self, field.name, field.default_value())

        # 1. bootstrap: find --config/--arch/--task/--dataset-type
        boot = _parse_cli(opts, [type(self)], strict=False)
        boot_kwargs = {k: v for k, v in kwargs.items() if k in self._fields}
        self.update({**boot_kwargs, **boot}, strict=False)

        yaml_opts: dict = {}
        if self.config:
            with open(self.config) as f:
                yaml_opts = yaml.safe_load(f) or {}
            if "config" in yaml_opts:
                del yaml_opts["config"]
            # YAML may also name the arch/task/dataset_type
            for key in ("arch", "task", "dataset_type", "debug"):
                if key in yaml_opts and key not in boot and key not in boot_kwargs:
                    setattr(self, key, yaml_opts[key])

        if self.debug:
            self.dataset_type = "debug"
            self.verbose = True

        dataset_cfg = get_dataset_config_cls(self.dataset_type)()
        model_cfg = get_model_config_cls(self.arch)()
        task_cfg = get_task_config_cls(self.task)()
        configs: list[Config] = [self, task_cfg, dataset_cfg, model_cfg]

        # 2. precedence YAML < kwargs < CLI
        cli = _parse_cli(opts, [type(c) for c in configs], strict=strict)
        _distribute(yaml_opts, configs, strict=strict, label="YAML")
        _distribute(kwargs, configs, strict=strict, label="keyword")
        _distribute(cli, configs, strict=False, label="CLI")

        self.dataset_cfg = dataset_cfg
        self.model_cfg = model_cfg
        self.task_cfg = task_cfg

        for cfg in configs:
            cfg.set_defaults(self.task)
        self.finalize()

    def as_dict(self, exclude_defaults: bool = False) -> dict:
        out = super().as_dict(exclude_defaults=exclude_defaults)
        for sub in (self.dataset_cfg, self.model_cfg, self.task_cfg):
            if sub is not None:
                out.update(sub.as_dict(exclude_defaults=exclude_defaults))
        for key in ("dataset_cfg", "model_cfg", "task_cfg"):
            out.pop(key, None)
        return dict(sorted(out.items()))

    def finalize(self):
        if self.model_cfg is None:
            return
        assert self.data_dir, "--data-dir is required"
        assert self.model_dir, "-o/--model-dir is required"
        for opt in ("data_dir", "model_dir", "tracker_project_name",
                    "tracker_run_name", "ckpt"):
            value = getattr(self, opt, None)
            if value:
                setattr(self, opt, self.task_cfg.replace_placeholders(value))

        self.task_cfg.set_max_length(self.model_cfg)
        self.task_cfg.finalize()

        if self.only_validate:
            # validation-only runs need no schedule (set before the
            # schedule asserts: --only-validate alone must work)
            self.max_steps = 0
            self.valid_interval = self.valid_interval or self.log_interval
        assert self.max_steps is not None, "--max-steps is required"
        assert self.valid_interval, "--valid-interval is required"
        if not self.save_interval:
            self.save_interval = self.valid_interval
        assert os.path.isdir(self.data_dir), "data directory does not exist"
        assert self.valid_interval % self.log_interval == 0, \
            "valid interval must be a multiple of logging interval"
        assert self.save_interval % self.log_interval == 0, \
            "save interval must be a multiple of logging interval"
        assert self.valid_interval % self.save_interval == 0, \
            "valid interval must be a multiple of save interval"
        assert not self.keep_interval or self.keep_interval % self.save_interval == 0, \
            "keep interval must be a multiple of save interval"

        if self.only_validate:
            self.max_steps = 0
            self.validate_at_start = True
            self.reset_optimizer = True
            self.log_file = self.log_file or "valid.log"
        else:
            self.log_file = self.log_file or "train.log"

        self.pick_seed()

        for name in ("train_corpora", "valid_corpora"):
            corpora = getattr(self, name)
            if corpora is None:
                continue
            for i, corpus in enumerate(corpora):
                if isinstance(corpus, str):
                    corpora[i] = {"paths": [corpus]}
                else:
                    assert isinstance(corpus, dict)

        if self.dataset_cfg.cache_line_index and self.dataset_cfg.line_index_path is None:
            data_dir = os.path.realpath(self.data_dir)
            index_name = (data_dir.replace("/", "_") + "_index.bin").strip("_")
            tmp_dir = os.environ.get("PASERO_TMP") or "tmp"
            self.dataset_cfg.line_index_path = os.path.join(tmp_dir, index_name)

    @property
    def inference_options(self) -> dict:
        """Non-default decoding options, saved as inference.yaml
        (pasero/config.py:1849-1868)."""
        options: dict = {}
        if self.save_trainable_only and self.ckpt:
            options["other_ckpt"] = [self.ckpt]
        options["dtype"] = self.dtype
        default = DecodingConfig()
        for name in DecodingConfig._fields:
            value = getattr(self, name)
            if value != getattr(default, name):
                options[name] = value
        return options


class DecodingAPIConfig(DistributedConfig, DecodingConfig):
    """Inference configuration built from a model dir + inference.yaml + kwargs
    (pasero/config.py:744-869)."""

    task_cfg: Optional[TaskConfig] = argument(None, hidden=True)

    task: str = argument("translation", help="task name")
    model: Optional[str] = argument(help="model directory or checkpoint path")
    model_dir: Optional[str] = argument(help="model directory (prefer --model)")
    ckpt: Optional[str] = argument(help="checkpoint path (prefer --model)")
    other_ckpt: list[str] = argument(
        [], help="additional checkpoints merged with MODEL (e.g. adapter-only)")
    ensemble_ckpt: list[str] = argument([], help="checkpoints to ensemble with MODEL")
    moe_stats: bool = argument(False, help="output MoE gate statistics after decoding")
    devices: Optional[list[str]] = argument(
        aliases=["device"], help="device list for layer placement (reference pipeline "
                                 "parallelism; on TPU the mesh handles placement)")
    benchmark: bool = argument(False, help="profile per-component time")
    quantize: Optional[str] = argument(
        choices=["int8"],
        help="weight-only quantization at load time: 'int8' stores the big "
             "matmul weights as int8 with per-channel scales, roughly "
             "halving the HBM weight read that bounds large-model decoding "
             "(beyond-reference capability; single-device decode only)")
    flexible: bool = argument(
        False, help="tolerate missing/unexpected checkpoint parameters")
    model_args: Optional[Union[dict, str]] = argument(
        help="JSON dict of model-config overrides")
    encoder_adapters: Optional[list[str]] = argument(
        help="override encoder adapter stack names")
    decoder_adapters: Optional[list[str]] = argument(
        help="override decoder adapter stack names")
    encoder_decoder_swapping: bool = argument(
        False, help="offload the inactive module to host memory")
    arch: Optional[str] = argument(help="override the model architecture")
    batch_size: int = argument(4096, hidden=True)  # owned by task_cfg; kept for kwargs

    def __init__(self, *opts, strict: bool = True, **kwargs):
        opts = list(opts)
        for field in self._fields.values():
            setattr(self, field.name, field.default_value())

        boot = _parse_cli(opts, [type(self)], strict=False)
        boot_kwargs = {k: v for k, v in kwargs.items() if k in self._fields}
        self.update({**boot_kwargs, **boot}, strict=False)

        # resolve model_dir / ckpt from --model
        if self.model is not None:
            if os.path.isfile(self.model):
                self.ckpt = self.model
            else:
                self.model_dir = self.model
        if self.ckpt is not None and self.model_dir is None:
            self.model_dir, self.ckpt = os.path.split(self.ckpt)
        assert self.model_dir and os.path.isdir(self.model_dir), \
            f"model directory {self.model_dir!r} does not exist"

        yaml_opts: dict = {}
        yaml_path = os.path.join(self.model_dir, "inference.yaml")
        if os.path.exists(yaml_path):
            with open(yaml_path) as f:
                yaml_opts = yaml.safe_load(f) or {}
        if "task" in yaml_opts and "task" not in boot and "task" not in boot_kwargs:
            self.task = yaml_opts["task"]
        if "arch" in yaml_opts and self.arch is None:
            self.arch = yaml_opts["arch"]

        self.set_defaults(self.task)
        task_cfg = get_task_config_cls(self.task)()
        configs: list[Config] = [self, task_cfg]

        cli = _parse_cli(opts, [type(c) for c in configs], strict=strict)
        _distribute({k: v for k, v in yaml_opts.items() if k not in ("task", "arch")},
                    configs, strict=False, label="inference.yaml")
        _distribute(kwargs, configs, strict=strict, label="keyword")
        _distribute(cli, configs, strict=False, label="CLI")

        self.task_cfg = task_cfg
        task_cfg.set_defaults(self.task)
        task_cfg.finalize()

        if self.ckpt is None:
            for name in ("model_best.bin", "model_latest.bin", "model_last.bin",
                         "model_best.npz", "model_latest.npz", "model_last.npz"):
                path = os.path.join(self.model_dir, name)
                if os.path.isfile(path):
                    self.ckpt = path
                    break
            assert self.ckpt is not None, f"no checkpoint found in {self.model_dir!r}"
        elif not os.path.isfile(self.ckpt):
            self.ckpt = os.path.join(self.model_dir, self.ckpt)
        assert os.path.isfile(self.ckpt), f"checkpoint {self.ckpt!r} does not exist"

        assert (self.beam_size == 1 or self.sampling) or not task_cfg.stop_sequences, \
            "beam search does not support --stop-sequences"

        if self.seed == -1:
            self.seed = random.randrange(10 ** 9)
        elif self.seed is None:
            self.seed = 42

    def as_dict(self, exclude_defaults: bool = False) -> dict:
        out = super().as_dict(exclude_defaults=exclude_defaults)
        out.pop("task_cfg", None)
        if self.task_cfg is not None:
            out.update(self.task_cfg.as_dict(exclude_defaults=exclude_defaults))
        return dict(sorted(out.items()))


class DecodingCLIConfig(DecodingAPIConfig, EvalConfig):
    model: str = argument(positional=True, help="model directory or checkpoint")
    input: Optional[list[str]] = argument(
        aliases=["i"], nargs="+", help="input file(s) (default stdin)")
    max_lines: Optional[int] = argument(help="read at most this many input lines")
    output: Optional[list[str]] = argument(
        aliases=["o"], nargs="+",
        help="output file(s) (default stdout); may contain {pair}/{src}/{tgt}/{lang}")
    reference: Optional[list[str]] = argument(
        aliases=["r"], nargs="+", help="reference file(s) for evaluation metrics")
    eval_corpus: Optional[str] = argument(
        aliases=["e"], help="corpus prefix to evaluate (paths inferred from -s/-t)")
    continue_: bool = argument(
        False, help="resume decoding after the existing output lines")
    buffer_size: int = argument(
        aliases=["n"], default=100,
        help="input lines read at once before batching (1 = interactive)")
    verbose: bool = argument(
        False, aliases=["v"], help="show scores and tokenization while decoding")
    quiet: bool = argument(False, aliases=["q"], help="suppress stdout output")
    log_file: Optional[str] = argument(help="log path relative to model_dir")

    def __init__(self, *opts, strict: bool = True, **kwargs):
        opts = list(opts) or sys.argv[1:]
        super().__init__(*opts, strict=strict, **kwargs)
