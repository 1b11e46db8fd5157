# Copy of pasero_tpu/evaluation.py, verbatim.
"""Evaluation metrics and corpus filtering (pasero/evaluation.py).

BLEU/spBLEU/chrF/chrF++ via sacrebleu when installed, else the native
sacrebleu-exact implementations in metrics_text.py (the reference hard
-depends on sacrebleu, evaluation.py:17,252-302 — quality scores here work
on any image); len_ratio/WER native (the reference uses jiwer); langid
gated on fasttext.
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, Optional

import numpy as np

logger = logging.getLogger("evaluation")

METRICS = ("bleu", "spbleu", "chrf", "chrf++", "len_ratio", "wer", "langid")
BLEU_TOKENIZERS = ("13a", "intl", "zh", "ja-mecab", "char", "none", "flores200")

# metrics where lower is better (for early stopping direction)
LOWER_IS_BETTER = {"wer", "len_ratio", "nll_loss", "loss", "ppl"}


def default_bleu_tokenizer(lang: Optional[str]) -> str:
    if lang == "zh":
        return "zh"
    if lang == "ja":
        return "ja-mecab"
    return "13a"


def _sacrebleu():
    """The sacrebleu package if importable, else None (the native
    implementations in metrics_text.py take over). PASERO_NATIVE_METRICS=1
    forces the native path (used by the parity tests and for images where
    a broken sacrebleu install shadows the name)."""
    if os.environ.get("PASERO_NATIVE_METRICS"):
        return None
    try:
        import sacrebleu
        return sacrebleu
    except ImportError:
        return None


def _spbleu(hypotheses: list, references: list) -> float:
    """spBLEU: BLEU over flores SPM pieces. Tries sacrebleu's flores200
    tokenizer, then the native scorer with a local SPM model
    (FLORES200_SPM_PATH); degrades to BLEU-intl with a loud warning if
    neither is possible (the NLLB baseline tables are written in spBLEU,
    examples/NLLB-200/README.md)."""
    sb = _sacrebleu()
    if sb is not None:
        try:
            return sb.corpus_bleu(hypotheses, [references],
                                  tokenize="flores200").score
        except Exception as e:
            first_error = e
    else:
        first_error = ImportError("sacrebleu not installed")
    spm_path = os.environ.get("FLORES200_SPM_PATH")
    if spm_path and os.path.exists(spm_path):
        try:
            from .metrics_text import corpus_spbleu
            return corpus_spbleu(hypotheses, [references], spm_path)
        except Exception as e:
            first_error = e
    _warn_spbleu_fallback(first_error)
    return score("bleu", hypotheses, references, bleu_tok="intl")


def score(metric: str, hypotheses: list, references: list,
          sources: Optional[list] = None, lang: Optional[str] = None,
          bleu_tok: Optional[str] = None, lowercase: bool = False) -> float:
    from . import metrics_text

    if lowercase:
        hypotheses = [h.lower() for h in hypotheses]
        references = [r.lower() for r in references]
    sb = _sacrebleu()

    if metric == "bleu":
        tok = bleu_tok or default_bleu_tokenizer(lang)
        if sb is not None:
            return sb.corpus_bleu(hypotheses, [references],
                                  tokenize=tok).score
        return metrics_text.corpus_bleu(hypotheses, [references],
                                        tokenizer=tok)
    if metric == "spbleu":
        return _spbleu(hypotheses, references)
    if metric == "chrf":
        if sb is not None:
            return sb.corpus_chrf(hypotheses, [references]).score
        return metrics_text.corpus_chrf(hypotheses, [references])
    if metric == "chrf++":
        if sb is not None:
            return sb.corpus_chrf(hypotheses, [references],
                                  word_order=2).score
        return metrics_text.corpus_chrf(hypotheses, [references],
                                        word_order=2)
    if metric == "len_ratio":
        hyp_len = sum(len(h.split()) for h in hypotheses)
        ref_len = sum(len(r.split()) for r in references)
        return 100.0 * hyp_len / max(1, ref_len)
    if metric == "wer":
        return 100.0 * word_error_rate(hypotheses, references)
    if metric == "langid":
        return langid_accuracy(hypotheses, lang)
    raise ValueError(f"unknown metric {metric!r}")


_UNAVAILABLE_WARNED: set = set()


def safe_score(metric: str, hypotheses: list, references: list,
               **kwargs) -> Optional[float]:
    """Score, or None — never raises into a decoding/validation run.

    'None' is reserved for *inapplicable* situations (no references, langid
    without a model).  A metric whose computation *fails* logs a loud
    once-per-metric warning so a quality-regression gate reading None knows
    the metric was unavailable rather than silently passing
    (reference behavior: pasero/evaluation.py safe_score swallows all)."""
    try:
        if not hypotheses or (metric != "langid" and not references):
            return None
        return round(score(metric, hypotheses, references, **kwargs), 2)
    except Exception as e:  # scoring must never kill a decoding run
        if metric not in _UNAVAILABLE_WARNED:
            _UNAVAILABLE_WARNED.add(metric)
            logger.error(
                f"metric {metric!r} is UNAVAILABLE in this environment "
                f"({type(e).__name__}: {e}); its scores will be reported as "
                "None and cannot gate expected_scores regressions")
        return None


_SPBLEU_WARNED = False


def _warn_spbleu_fallback(error: Exception) -> None:
    global _SPBLEU_WARNED
    if not _SPBLEU_WARNED:
        _SPBLEU_WARNED = True
        logger.warning(
            "spBLEU (flores200 SPM tokenization) is unavailable "
            f"({type(error).__name__}); falling back to BLEU with the 'intl' "
            "tokenizer — these scores are NOT comparable to published spBLEU "
            "numbers. Point FLORES200_SPM_PATH at the flores200 SPM model "
            "(read natively, no sentencepiece package needed) to restore "
            "true spBLEU.")


def word_error_rate(hypotheses: Iterable[str], references: Iterable[str]) -> float:
    """Corpus-level WER: total edit distance / total reference words."""
    total_errors = total_words = 0
    for hyp, ref in zip(hypotheses, references):
        h, r = hyp.split(), ref.split()
        d = np.zeros((len(r) + 1, len(h) + 1), dtype=np.int32)
        d[:, 0] = np.arange(len(r) + 1)
        d[0, :] = np.arange(len(h) + 1)
        for i in range(1, len(r) + 1):
            for j in range(1, len(h) + 1):
                sub = d[i - 1, j - 1] + (r[i - 1] != h[j - 1])
                d[i, j] = min(sub, d[i - 1, j] + 1, d[i, j - 1] + 1)
        total_errors += int(d[len(r), len(h)])
        total_words += len(r)
    return total_errors / max(1, total_words)


_LANGID_MODEL = None


def langid_accuracy(hypotheses: list, lang: Optional[str]) -> Optional[float]:
    """Share of hypotheses identified as ``lang`` by fasttext LID (gated)."""
    global _LANGID_MODEL
    if lang is None:
        return None
    try:
        import fasttext
    except ImportError:
        logger.warning("fasttext is not installed; langid metric unavailable")
        return None
    if _LANGID_MODEL is None:
        path = os.environ.get("LANGID_MODEL_PATH", "lid.176.bin")
        if not os.path.exists(path):
            return None
        _LANGID_MODEL = fasttext.load_model(path)
    correct = 0
    for h in hypotheses:
        pred = _LANGID_MODEL.predict(h.replace("\n", " "))[0][0]
        correct += pred.removeprefix("__label__").split("_")[0] == lang
    return 100.0 * correct / max(1, len(hypotheses))


def is_better(metric: str, new: float, old: float) -> bool:
    if metric in LOWER_IS_BETTER:
        return new < old
    return new > old


# -- corpus filtering (pasero/evaluation.py:92-239) ---------------------------

class FilterByLang:
    """Keep line pairs whose sides are identified as the expected languages."""

    def __init__(self, source_lang: str, target_lang: str):
        self.source_lang, self.target_lang = source_lang, target_lang
        try:
            import fasttext
            path = os.environ.get("LANGID_MODEL_PATH", "lid.176.bin")
            self.model = fasttext.load_model(path) if os.path.exists(path) else None
        except ImportError:
            self.model = None

    def __call__(self, pairs):
        if self.model is None:
            yield from pairs
            return
        for src, tgt in pairs:
            src_pred = self.model.predict(src.replace("\n", " "))[0][0]
            tgt_pred = self.model.predict(tgt.replace("\n", " "))[0][0]
            if (src_pred.endswith(self.source_lang)
                    and tgt_pred.endswith(self.target_lang)):
                yield src, tgt


class Dedup:
    def __init__(self):
        self.seen: set = set()

    def __call__(self, pairs):
        for pair in pairs:
            key = hash(pair)
            if key not in self.seen:
                self.seen.add(key)
                yield pair


class FilterByLen:
    def __init__(self, min_len: int = 1, max_len: int = 1000,
                 max_ratio: float = 9.0):
        self.min_len, self.max_len, self.max_ratio = min_len, max_len, max_ratio

    def __call__(self, pairs):
        for src, tgt in pairs:
            ls, lt = len(src.split()), len(tgt.split())
            if (self.min_len <= ls <= self.max_len
                    and self.min_len <= lt <= self.max_len
                    and max(ls, lt) / max(1, min(ls, lt)) <= self.max_ratio):
                yield src, tgt


class Shuffle:
    def __init__(self, seed: int = 0):
        self.seed = seed

    def __call__(self, pairs):
        pairs = list(pairs)
        np.random.default_rng(self.seed).shuffle(pairs)
        yield from pairs
