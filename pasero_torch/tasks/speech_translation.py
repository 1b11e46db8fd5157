# Copy of pasero_tpu/tasks/speech_translation.py; only _load_audio differs: the port's
# log_mel_spectrogram on the generator's device.
"""Speech translation task (pasero/tasks/speech_translation.py:14-106).

Sources are speech features: either precomputed (binary 'numpy' feature files,
data/files.py NumpyFile) or raw waveforms converted on the fly with the mel
frontend (ops/mel.py — a capability the reference delegates to offline HF
scripts). No source tokenizer; features pass straight to the encoder's conv
subsampler.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import numpy as np

from ..config import register_task
from ..config.tasks import SpeechTranslationTaskConfig
from .task import Corpus
from .translation import (InferenceParallelCorpus, ParallelCorpus,
                          TranslationTask)

logger = logging.getLogger("task")


class SpeechCorpus(ParallelCorpus):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # the source side is a feature file, the target side text
        self.file_formats = ["numpy", self.file_formats[1]]


class InferenceSpeechCorpus(InferenceParallelCorpus):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.file_formats = ["numpy", self.file_formats[1]]


@register_task("speech_translation")
class SpeechTranslationTask(TranslationTask):
    cfg: SpeechTranslationTaskConfig

    @classmethod
    def _get_corpus(cls, *args, **kwargs) -> SpeechCorpus:
        return SpeechCorpus(*args, **kwargs)

    @property
    def encoder_num_embeddings(self) -> int:
        return 0  # continuous inputs, no source embedding table

    def input_to_sample(self, input: Any, meta: dict = {}) -> dict:
        """Inputs may be feature arrays, waveform arrays, or audio paths."""
        if isinstance(input, str):
            features = self._load_audio(input)
        else:
            features = np.asarray(input)
        return {"source": features, "target": None, "meta": meta}

    def _load_audio(self, path: str) -> np.ndarray:
        if path.endswith(".npy"):
            return np.load(path)
        import torch
        from .. import resolve_device
        from ..ops.mel import log_mel_spectrogram
        import wave

        with wave.open(path) as w:
            assert w.getframerate() == 16000, "expected 16kHz audio"
            raw = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        audio = raw.astype(np.float32) / 32768.0
        # the mel runs on the task's device: the CUDA kernel on the card, its
        # plain version on the CPU; the features come back to the host
        audio = torch.from_numpy(audio[None]).to(resolve_device(self.device))
        return log_mel_spectrogram(audio)[0].cpu().numpy()

    def preprocess(self, sample: dict, truncate: bool = False,
                   tokenize: bool = True, append_eos: bool = False) -> dict:
        """Features bypass the source tokenizer entirely
        (speech_translation.py:29-35)."""
        source = sample.get("source")
        target = sample.get("target")
        meta = sample.get("meta") or {}
        assert isinstance(source, np.ndarray), \
            "speech sources must be feature arrays"
        if truncate and self.max_source_len:
            source = source[:self.max_source_len]
        elif self.max_source_len and len(source) > self.max_source_len:
            return {}

        tgt_tags = self.get_target_tags(meta) if tokenize else []
        prompt_len = len(tgt_tags)
        target_tok = list(tgt_tags)
        if target:
            target_tok += (self.tgt_preprocessor.tokenize(target) if tokenize
                           else target.split())
        decoder_input = self.tgt_preprocessor.binarize(
            target_tok, max_len=self.max_target_len if truncate else None,
            prepend_bos=self.prepend_bos, append_eos=append_eos)
        if self.max_target_len and len(decoder_input) > self.max_target_len \
                and not truncate:
            return {}
        prompt_mask = np.zeros_like(decoder_input, dtype=bool)
        prompt_mask[:prompt_len + int(self.prepend_bos)] = True
        return {"encoder_input": source.astype(np.float32),
                "decoder_input": decoder_input, "prompt_mask": prompt_mask,
                "emojis": [], "meta": meta}

    @classmethod
    def get_inference_corpora(cls, cfg, input_paths=None, output_paths=None,
                              ref_paths=None, corpus_prefix=None):
        corpora = super().get_inference_corpora(
            cfg, input_paths=input_paths, output_paths=output_paths,
            ref_paths=ref_paths, corpus_prefix=corpus_prefix)
        return [InferenceSpeechCorpus(
            c.input_path, source_lang=c.source_lang, target_lang=c.target_lang,
            ref_path=c.ref_path, output_path=c.output_path) for c in corpora]
