# Copy of pasero_tpu/metrics_text.py, verbatim.
"""Self-contained BLEU / chrF / chrF++ (no external scoring deps).

The reference delegates quality metrics to the sacrebleu package
(pasero/evaluation.py:17,252-302); images without it would silently lose
every BLEU/chrF number (training validation, `pasero-decode`,
`expected_scores` gating).  This module natively implements the same
published algorithms so scores exist everywhere:

- BLEU (Papineni et al. 2002) with the WMT 'exp' (mteval/NIST) smoothing,
  closest-reference length brevity penalty, and the mteval-v13a /
  mteval-v14-international tokenizations;
- chrF / chrF++ (Popović 2015/2017): char 6-gram (+ word 1-2-gram for ++)
  F2 with effective-order smoothing;
- spBLEU = BLEU over SentencePiece pieces of a local flores-style model
  (needs the `sentencepiece` package + a model file).

tests/test_metrics_native.py pins exact parity against sacrebleu-2.6.0
vectors (recomputed live when sacrebleu is importable, frozen constants
otherwise), so these are drop-in equal, not approximations.
"""

from __future__ import annotations

import math
from collections import Counter
from functools import lru_cache
from typing import Optional, Sequence

MAX_BLEU_ORDER = 4
CHRF_CHAR_ORDER = 6
CHRF_BETA = 2

_PUNCT = set('!"#$%&\'()*+,-./:;<=>?@[\\]^_`{|}~')


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------

# mteval-v13a "language-dependent part": split out the ASCII punctuation
# ranges {-~ [-` space-& (-+ :-@ and /
_13A_PUNCT = set("{|}~[\\]^_` !\"#$%&()*+:;<=>?@/")


def _tokenize_13a(line: str) -> list:
    """WMT mteval-v13a tokenization (language independent)."""
    line = (line.replace("<skipped>", "").replace("-\n", "")
                .replace("\n", " "))
    if "&" in line:
        line = (line.replace("&quot;", '"').replace("&amp;", "&")
                    .replace("&lt;", "<").replace("&gt;", ">"))
    line = f" {line} "
    out = []
    n = len(line)
    for i, ch in enumerate(line):
        if ch in _13A_PUNCT:
            out.append(f" {ch} ")
        elif ch in ".,":
            # split period/comma unless it sits between two digits
            prev_digit = i > 0 and line[i - 1].isascii() and line[i - 1].isdigit()
            next_digit = (i + 1 < n and line[i + 1].isascii()
                          and line[i + 1].isdigit())
            if prev_digit and next_digit:
                out.append(ch)
            else:
                out.append(f" {ch} ")
        elif ch == "-" and i > 0 and line[i - 1].isascii() \
                and line[i - 1].isdigit():
            # split dash when preceded by a digit
            out.append(" - ")
        else:
            out.append(ch)
    return "".join(out).split()


_INTL_RULES = None


def _tokenize_intl(line: str) -> list:
    """mteval-v14 international tokenization: the three substitution rules
    of mteval-v14.pl:954-983 (split unicode punctuation off non-numbers,
    split all symbols), applied sequentially."""
    global _INTL_RULES
    if _INTL_RULES is None:
        import regex  # unicode-property regex (same dep as the tokenizers)
        _INTL_RULES = [
            (regex.compile(r"(\P{N})(\p{P})"), r"\1 \2 "),
            (regex.compile(r"(\p{P})(\P{N})"), r" \1 \2"),
            (regex.compile(r"(\p{S})"), r" \1 "),
        ]
    for rule, repl in _INTL_RULES:
        line = rule.sub(repl, line)
    return line.split()


def _tokenize_char(line: str) -> list:
    return [ch for ch in line if not ch.isspace()]


def tokenize(line: str, method: str = "13a") -> list:
    if method == "13a":
        return _tokenize_13a(line)
    if method == "intl":
        return _tokenize_intl(line)
    if method == "char":
        return _tokenize_char(line)
    if method == "none":
        return line.split()
    raise ValueError(f"unknown tokenizer {method!r} "
                     "(native metrics support 13a/intl/char/none)")


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

def _word_ngrams(tokens: Sequence[str], max_order: int) -> Counter:
    grams: Counter = Counter()
    for order in range(1, max_order + 1):
        for i in range(len(tokens) - order + 1):
            grams[tuple(tokens[i:i + order])] += 1
    return grams


def _closest_ref_len(hyp_len: int, ref_lens: Sequence[int]) -> int:
    """Closest reference length; ties go to the shorter reference."""
    return min(ref_lens, key=lambda r: (abs(hyp_len - r), r))


def corpus_bleu(hypotheses: Sequence[str], references: Sequence[Sequence[str]],
                tokenizer: str = "13a", lowercase: bool = False,
                max_order: int = MAX_BLEU_ORDER,
                tokenize_fn=None) -> float:
    """Corpus BLEU with WMT defaults (13a tokenization, 'exp' smoothing).

    ``references``: one list of reference streams, each as long as
    ``hypotheses`` (the sacrebleu corpus_bleu convention).
    """
    assert references and all(len(r) == len(hypotheses) for r in references)
    tok = tokenize_fn or (lambda line: tokenize(line, tokenizer))

    correct = [0] * max_order
    total = [0] * max_order
    hyp_len_sum = ref_len_sum = 0
    for i, hyp in enumerate(hypotheses):
        if lowercase:
            hyp = hyp.lower()
        hyp_tokens = tok(hyp)
        hyp_len_sum += len(hyp_tokens)

        merged: Counter = Counter()
        ref_lens = []
        for stream in references:
            ref = stream[i].lower() if lowercase else stream[i]
            ref_tokens = tok(ref)
            ref_lens.append(len(ref_tokens))
            for gram, count in _word_ngrams(ref_tokens, max_order).items():
                merged[gram] = max(merged[gram], count)
        ref_len_sum += _closest_ref_len(len(hyp_tokens), ref_lens)

        for gram, count in _word_ngrams(hyp_tokens, max_order).items():
            order = len(gram) - 1
            total[order] += count
            correct[order] += min(count, merged.get(gram, 0))

    return _bleu_from_stats(correct, total, hyp_len_sum, ref_len_sum,
                            max_order)


def _bleu_from_stats(correct, total, hyp_len: int, ref_len: int,
                     max_order: int) -> float:
    if hyp_len == 0:
        return 0.0
    bp = 1.0 if hyp_len >= ref_len else math.exp(1.0 - ref_len / hyp_len)
    if not any(correct):
        return 0.0
    log_sum = 0.0
    smooth = 1.0
    for order in range(max_order):
        if total[order] == 0:
            # shorter corpus than the order: mteval treats missing orders
            # as if absent (sacrebleu breaks out of the loop, then takes
            # log(0) -> -inf through my_log... which floors at ~0 score)
            return 0.0
        if correct[order] == 0:
            smooth *= 2.0   # NIST 'exp' smoothing
            precision = 100.0 / (smooth * total[order])
        else:
            precision = 100.0 * correct[order] / total[order]
        log_sum += math.log(precision)
    return bp * math.exp(log_sum / max_order)


# ---------------------------------------------------------------------------
# chrF / chrF++
# ---------------------------------------------------------------------------

def _char_ngram_stats(line: str, max_order: int) -> list:
    """Whitespace-stripped char n-gram Counters for orders 1..max_order."""
    squeezed = "".join(line.split())
    return [Counter(squeezed[i:i + n] for i in range(len(squeezed) - n + 1))
            for n in range(1, max_order + 1)]


def _chrf_words(line: str) -> list:
    """chrF++'s primitive word tokenization: split leading/trailing
    punctuation off each whitespace token."""
    words = []
    for w in line.split():
        if len(w) > 1 and w[-1] in _PUNCT:
            words += [w[:-1], w[-1]]
        elif len(w) > 1 and w[0] in _PUNCT:
            words += [w[0], w[1:]]
        else:
            words.append(w)
    return words


def _ngram_counters(line: str, word_order: int) -> list:
    counters = _char_ngram_stats(line, CHRF_CHAR_ORDER)
    if word_order:
        words = _chrf_words(line)
        for n in range(1, word_order + 1):
            counters.append(Counter(
                " ".join(words[i:i + n])
                for i in range(len(words) - n + 1)))
    return counters


def _match_stats(hyp_counters: list, ref_counters: list) -> list:
    """[hyp_count, ref_count, match_count] per order, flattened.
    An order with an empty reference contributes no hypothesis count
    either (chrF++ convention: no credit, no penalty, for orders the
    reference cannot attest)."""
    stats = []
    for h, r in zip(hyp_counters, ref_counters):
        match = sum(min(count, r[gram]) for gram, count in h.items())
        stats += [sum(h.values()) if r else 0, sum(r.values()), match]
    return stats


def _chrf_f_score(stats: list, num_orders: int,
                  beta: int = CHRF_BETA) -> float:
    """Effective-order-smoothed F_beta over the order-averaged P/R."""
    factor = beta ** 2
    avg_prec = avg_rec = 0.0
    effective = 0
    for i in range(num_orders):
        n_hyp, n_ref, n_match = stats[3 * i: 3 * i + 3]
        if n_hyp > 0 and n_ref > 0:
            avg_prec += n_match / n_hyp
            avg_rec += n_match / n_ref
            effective += 1
    if effective == 0:
        return 0.0
    avg_prec /= effective
    avg_rec /= effective
    if avg_prec + avg_rec == 0:
        return 0.0
    return 100.0 * (1 + factor) * avg_prec * avg_rec \
        / (factor * avg_prec + avg_rec)


def corpus_chrf(hypotheses: Sequence[str],
                references: Sequence[Sequence[str]],
                word_order: int = 0, lowercase: bool = False) -> float:
    """chrF (word_order=0) / chrF++ (word_order=2): per-segment best
    reference by F-score, statistics summed over the corpus."""
    assert references and all(len(r) == len(hypotheses) for r in references)
    num_orders = CHRF_CHAR_ORDER + word_order
    totals = [0] * (3 * num_orders)
    for i, hyp in enumerate(hypotheses):
        if lowercase:
            hyp = hyp.lower()
        hyp_counters = _ngram_counters(hyp, word_order)
        best_stats, best_f = None, -1.0
        for stream in references:
            ref = stream[i].lower() if lowercase else stream[i]
            stats = _match_stats(hyp_counters,
                                 _ngram_counters(ref, word_order))
            f = _chrf_f_score(stats, num_orders)
            if f > best_f:
                best_f, best_stats = f, stats
        for j, v in enumerate(best_stats):
            totals[j] += v
    return _chrf_f_score(totals, num_orders)


# ---------------------------------------------------------------------------
# spBLEU (BLEU over SentencePiece pieces of a local model)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=4)
def _load_spm(path: str):
    # real sentencepiece when installed, else the vendored pure-python
    # reader (tokenizers/spm_model.py) — spBLEU runs either way
    from .tokenizers.spm_model import load_processor
    return load_processor(path)


def corpus_spbleu(hypotheses: Sequence[str],
                  references: Sequence[Sequence[str]],
                  spm_path: str, lowercase: bool = False) -> float:
    """BLEU over SentencePiece pieces (the flores101/200 'spBLEU' scheme:
    tokenize with the released SPM model, then plain BLEU)."""
    sp = _load_spm(spm_path)
    return corpus_bleu(hypotheses, references, lowercase=lowercase,
                       tokenize_fn=lambda line: sp.EncodeAsPieces(line))
