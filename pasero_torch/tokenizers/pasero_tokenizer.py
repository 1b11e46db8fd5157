# Copy of pasero_tpu/tokenizers/pasero_tokenizer.py, verbatim.
"""Pasero-style BPE tokenizer: trainer + encoder with inline casing.

From-scratch implementation, behavior-compatible with the reference
(pasero/tokenizers/pasero_tokenizer.py:157-864) and its on-disk model format:

- model file = optional ``# {json config}`` header line followed by one merge
  ("left right") per line;
- SentencePiece-style ``▁`` whitespace marker; a leading lone ``▁`` is dropped;
- inline casing: text is lowercased before BPE and ``<T>``/``<U>`` tags are
  emitted *after* subwords that were Title/UPPER cased in the original;
- optional NFKC, protected-token regex, BPE dropout, spell-out;
- vocabulary restriction splits out-of-vocabulary merges back into their parts;
- the trainer uses subword-nmt pair statistics (max-frequency pair, ties broken
  by the lexicographically largest pair) with per-language temperature-based
  oversampling of vocabularies and script/aggressivity-based pre-splitting.
"""

from __future__ import annotations

import io
import json
import os
import sys
import unicodedata
from collections import Counter, defaultdict
from functools import lru_cache
from typing import Iterable, Optional, Union

import numpy as np
import regex

from .noise import MASK

WORD_SEP = "▁"
COPY_TAG = "<PHL>"
_PROTECT = "╳"
_MASK_STANDIN = "⧈"
_PHL_STANDIN = "⧇"
_WS = regex.compile(r"\s+")
# split so that a token never mixes cases: optional leading cap + lowercase run,
# or an all-caps run, or a lone word separator
_NO_MIXED_CASE = regex.compile(
    "(▁?[[:upper:]]?[^[:upper:]\\s▁{0}]+|▁?[[:upper:]]+|▁|{0})".format(regex.escape(_PROTECT)))
_SP_SPLIT = regex.compile("(▁?[^\\s▁{0}]+|▁|{0})".format(regex.escape(_PROTECT)))

# pre-splitting aggressivity levels used at training time
_SPLIT_REGEXES = [
    None,
    regex.compile(r"(▁?[[:alnum:]]+|[^[:alnum:]]+)"),
    regex.compile(r"(▁?[[:alpha:]]+|▁?[[:digit:]]+|[^[:alnum:]]+)"),
    regex.compile(r"(▁?[[:alpha:]]+|▁?[[:digit:]]+|[^[:alnum:]])"),
    regex.compile(r"(▁?[[:alpha:]]+|▁?[[:digit:]]|[^[:alnum:]])"),
]

UPPER, TITLE, LOWER = range(3)
CASE_TAGS = ["<U>", "<T>", None]


def inline_case_to_cased(tokens: list[str]) -> list[str]:
    """Apply trailing <T>/<U> case tags to the preceding token and drop them."""
    out = list(tokens)
    for i, token in enumerate(out):
        if token == "<T>":
            out[i - 1] = out[i - 1].title()
        elif token == "<U>":
            out[i - 1] = out[i - 1].upper()
    return [t for t in out if t not in ("<T>", "<U>")]


def detokenize(tokens: list[str], strip: bool = True) -> str:
    tokens = inline_case_to_cased(tokens)
    text = " ".join(t for t in tokens if t != "</s>")
    text = text.replace(" ", "").replace(WORD_SEP, " ")
    return text.strip() if strip else text


# -- unicode script handling (regex \p{Script}) ------------------------------

_SCRIPT_NAMES = (
    "Latin Cyrillic Greek Arabic Hebrew Han Hangul Hiragana Katakana Thai "
    "Devanagari Bengali Tamil Telugu Kannada Malayalam Gujarati Gurmukhi "
    "Oriya Sinhala Myanmar Khmer Lao Tibetan Georgian Armenian Ethiopic "
    "Mongolian Thaana Syriac Cherokee Common Inherited"
).split()
_SCRIPT_PATTERNS = None


@lru_cache(maxsize=65536)
def char_script(ch: str) -> int:
    """Script id of a character (index into _SCRIPT_NAMES; -1 = unknown)."""
    global _SCRIPT_PATTERNS
    if _SCRIPT_PATTERNS is None:
        _SCRIPT_PATTERNS = [regex.compile(rf"\p{{{name}}}") for name in _SCRIPT_NAMES]
    for i, pattern in enumerate(_SCRIPT_PATTERNS):
        if pattern.match(ch):
            return i
    return -1


def split_by_script(tokens: list[str]) -> list[str]:
    """Break tokens at script boundaries (so e.g. Latin and Han never mix)."""
    out = []
    for token in tokens:
        current, script = "", None
        for ch in token:
            if ch in (" ", WORD_SEP):
                current += ch
                continue
            s = char_script(ch)
            if script is not None and s != script:
                out.append(current)
                current = ""
            current += ch
            script = s
        if current:
            out.append(current)
    return out


class PaseroTokenizer:
    """BPE encoder/trainer with inline casing (reference-format model files)."""

    def __init__(
        self,
        path_or_merges: Union[str, list],
        vocab: Optional[Iterable[str]] = None,
        inline_case: bool = True,
        nfkc: bool = False,
        protect_regex: Optional[str] = None,
        **kwargs,
    ):
        config = dict(kwargs)
        if isinstance(path_or_merges, str):
            merges = []
            with open(path_or_merges) as f:
                first = f.readline()
                if first.startswith("#"):
                    try:
                        config = json.loads(first.strip("# \n\r"))
                    except Exception:
                        pass
                elif first.strip():
                    merges.append(tuple(first.rstrip("\r\n").rsplit(" ", maxsplit=1)))
                for line in f:
                    if line.rstrip("\r\n"):
                        merges.append(tuple(line.rstrip("\r\n").rsplit(" ", maxsplit=1)))
        else:
            merges = [tuple(m) for m in path_or_merges]

        self.inline_case = config.get("inline_case", inline_case)
        self.nfkc = config.get("nfkc", nfkc)
        protect = config.get("protect_regex", protect_regex)
        self.protect_regex = regex.compile(protect) if protect else None

        # pair -> rank; on duplicates the earliest rank wins
        self.merges: dict[tuple, int] = {}
        for i, pair in enumerate(merges):
            self.merges.setdefault(pair, i)
        self.merges_reverse = {a + b: (a, b) for a, b in self.merges}
        self.vocab = set(vocab) if vocab else None
        self._cache: dict[str, list[str]] = {}
        self._native = None
        try:  # C++ merge core (native/bpe_core.cpp); python fallback otherwise
            from .native import NativeBPE
            ordered = [p for p, _ in sorted(self.merges.items(),
                                            key=lambda kv: kv[1])]
            self._native = NativeBPE(ordered)
        except Exception:
            self._native = None

    def __getstate__(self):
        """Pickle support for worker processes: the ctypes handle of the C++
        merge core cannot cross process boundaries (same concern as the
        reference's SentencePiece pickling workaround,
        tokenizers/__init__.py:33-167) — drop it and rebuild on unpickle."""
        state = self.__dict__.copy()
        state["_native"] = None
        state["_cache"] = {}
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        try:
            from .native import NativeBPE
            ordered = [p for p, _ in sorted(self.merges.items(),
                                            key=lambda kv: kv[1])]
            self._native = NativeBPE(ordered)
        except Exception:
            self._native = None

    def __len__(self) -> int:
        return len(self.merges)

    # -- encoding ----------------------------------------------------------

    def tokenize(self, sentence: str, unk: Optional[str] = None,
                 dropout: float = 0.0, spell_out: float = 0.0) -> list[str]:
        tokens = self._tokenize(sentence, unk=unk, dropout=dropout, spell_out=spell_out)
        if tokens and tokens[0] == WORD_SEP:
            tokens.pop(0)  # a lone leading separator carries no information
        return tokens

    def _tokenize(self, sentence: str, unk=None, dropout=0.0, spell_out=0.0) -> list[str]:
        sentence = sentence.strip()
        if not sentence:
            return []
        if self.nfkc:
            sentence = unicodedata.normalize("NFKC", sentence)

        protected_tokens: list[str] = []
        if self.protect_regex is not None:
            sentence = sentence.replace(_PROTECT, " ")
            protected_tokens = [m.group(0) for m in self.protect_regex.finditer(sentence)]
            sentence = self.protect_regex.sub(_PROTECT, sentence)

        # shield <mask> and the copy placeholder from BPE
        sentence = sentence.replace(_MASK_STANDIN, "").replace(MASK, _MASK_STANDIN)
        sentence = sentence.replace(_PHL_STANDIN, "").replace(COPY_TAG, _PHL_STANDIN)

        if self.inline_case:
            for tag in CASE_TAGS:
                if tag:
                    sentence = sentence.replace(tag, " ")

        sentence = sentence.replace(WORD_SEP, " ")
        sentence = WORD_SEP + _WS.sub(WORD_SEP, sentence)
        splitter = _NO_MIXED_CASE if self.inline_case else _SP_SPLIT
        words = splitter.findall(sentence)

        cased_words = words
        if self.inline_case:
            words = [w.lower() for w in words]

        pieces_per_word = [
            self._encode_cached(w, dropout=dropout, spell_out=spell_out) if w else []
            for w in words
        ]

        if self.inline_case:
            rendered = []
            for cased, pieces in zip(cased_words, pieces_per_word):
                i, parts = 0, []
                for piece in pieces:
                    original = cased[i:i + len(piece)]
                    i += len(piece)
                    if original.isupper():
                        case = UPPER
                    elif original.istitle():
                        case = TITLE
                    else:
                        case = LOWER
                    parts.append(piece if CASE_TAGS[case] is None
                                 else piece + " " + CASE_TAGS[case])
                rendered.append(" ".join(parts))
        else:
            rendered = [" ".join(pieces) for pieces in pieces_per_word]

        sentence = " ".join(rendered)

        if self.protect_regex is not None:
            sentence = sentence.replace(_PROTECT + " " + WORD_SEP + " ", _PROTECT + " ")
            for token in protected_tokens:
                sentence = sentence.replace(_PROTECT, token, 1)
            sentence = _WS.sub(" ", sentence)

        sentence = sentence.replace(_MASK_STANDIN, MASK).replace(_PHL_STANDIN, COPY_TAG)

        tokens = sentence.split()
        if unk is not None and self.vocab:
            tokens = [t if t in self.vocab else unk.replace("{token}", t) for t in tokens]
        return tokens

    def _encode_cached(self, word: str, dropout=0.0, spell_out=0.0) -> list[str]:
        if spell_out and np.random.random() < spell_out:
            return list(word)
        if dropout:
            return self._encode(word, dropout=dropout)
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        pieces = self._encode(word)
        self._cache[word] = pieces
        if len(self._cache) > 2 ** 20:
            self._cache.pop(next(iter(self._cache)))
        return pieces

    def _encode(self, word: str, dropout: float = 0.0) -> list[str]:
        """Apply merges in rank order until none applies."""
        if self._native is not None and not dropout:
            pieces = self._native.encode_word(word)
            if pieces is not None:
                out: list[str] = []
                for piece in pieces:
                    out.extend(self._restrict(piece))
                return out
        symbols = list(word)
        while len(symbols) > 1:
            candidates = {pair: self.merges[pair]
                          for pair in zip(symbols, symbols[1:]) if pair in self.merges}
            if dropout:
                candidates = {p: r for p, r in candidates.items()
                              if np.random.random() > dropout}
            if not candidates:
                break
            best = min(candidates, key=candidates.get)
            left, right = best
            merged, i = [], 0
            while i < len(symbols):
                if i < len(symbols) - 1 and symbols[i] == left and symbols[i + 1] == right:
                    merged.append(left + right)
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        out: list[str] = []
        for piece in symbols:
            out.extend(self._restrict(piece))
        return out

    def _restrict(self, segment: str):
        """Recursively undo merges whose result is not in the vocabulary."""
        if self.vocab is None or segment in self.vocab or segment not in self.merges_reverse:
            yield segment
        else:
            for part in self.merges_reverse[segment]:
                yield from self._restrict(part)

    # -- vocabulary extraction (training) ----------------------------------

    @classmethod
    def _line_vocab(cls, lines: Iterable[str], tokenization: int = 2,
                    inline_case: bool = True, split_script: bool = True,
                    nfkc: bool = False, protect_regex: Optional[str] = None,
                    **_) -> tuple[dict, int]:
        vocab: dict[str, int] = {}
        line_count = 0
        protect = regex.compile(protect_regex) if protect_regex else None
        for line in lines:
            line = line.strip()
            if not line:
                continue
            line_count += 1
            if nfkc:
                line = unicodedata.normalize("NFKC", line)
            if protect:
                line = protect.sub(" ", line)
            line = WORD_SEP + _WS.sub(WORD_SEP, line.replace(WORD_SEP, " "))
            if inline_case:
                tokens = [t.lower() for t in _NO_MIXED_CASE.findall(line)]
            else:
                tokens = _SP_SPLIT.findall(line)
            if split_script:
                tokens = split_by_script(tokens)
            splitter = _SPLIT_REGEXES[tokenization]
            if splitter is not None:
                tokens = [piece for t in tokens for piece in splitter.findall(t)]
            for t in tokens:
                vocab[t] = vocab.get(t, 0) + 1
        return vocab, line_count

    @classmethod
    def _read_vocabularies(cls, inputs: list[str], max_lines: int = 10 ** 7,
                           **kwargs) -> tuple[dict, dict]:
        """Per-language token vocabularies; counts extrapolated to full file size."""
        if len(inputs) > 1:
            langs = []
            for filename in inputs:
                m = regex.match(r".+\.([a-z]+)", filename or "")
                assert m, f"could not infer language from file name {filename!r}"
                langs.append(m.group(1))
        else:
            langs = ["any"]
        vocabs: dict[str, dict] = defaultdict(dict)
        line_counts: dict[str, int] = defaultdict(int)
        for filename, lang in zip(inputs, langs):
            infile = sys.stdin if not filename else open(filename)
            lines = []
            for _ in range(max_lines):
                line = infile.readline()
                if not line:
                    break
                lines.append(line)
            vocab, count = cls._line_vocab(lines, **kwargs)
            ratio = 1.0
            if infile is not sys.stdin:
                read = infile.tell()
                infile.seek(0, io.SEEK_END)
                total = infile.tell()
                infile.close()
                if read:
                    ratio = total / read
            for k, v in vocab.items():
                vocabs[lang][k] = vocabs[lang].get(k, 0) + int(ratio * v)
            line_counts[lang] += int(ratio * count)
        return dict(vocabs), dict(line_counts)

    @staticmethod
    def _merge_vocabularies(vocabs: dict, line_counts: dict,
                            temperature: float = 1.0, **_) -> Counter:
        """Temperature-based oversampling so low-resource languages contribute
        proportionally more merges (multiplier 1 for the largest language)."""
        if not temperature or temperature < 0:
            temperature = 1.0
        if len(vocabs) <= 1:
            return Counter(next(iter(vocabs.values())))
        counts = np.array([line_counts.get(lang, 0) for lang in vocabs], dtype=np.float64)
        probs = counts / counts.sum()
        probs = probs ** (1.0 / temperature)
        probs /= probs.sum()
        multipliers = (counts.max() * probs) / (probs.max() * counts)
        vocab: dict[str, float] = {}
        for lang, multiplier in zip(vocabs, multipliers.tolist()):
            for k, v in vocabs[lang].items():
                vocab[k] = vocab.get(k, 0) + v * multiplier
        return Counter({k: round(v) for k, v in vocab.items()})

    # -- BPE training -------------------------------------------------------

    @classmethod
    def train(cls, inputs: list[str], output: Optional[str] = None,
              num_symbols: int = 8000, existing_bpe_path: Optional[str] = None,
              **kwargs) -> tuple["PaseroTokenizer", dict]:
        """Learn ``num_symbols`` merges and write the model file.

        Returns (tokenizer, per-language encoded vocabularies) — the latter is
        used to build dictionaries with frequencies.
        """
        vocabs, line_counts = cls._read_vocabularies(inputs, **kwargs)
        vocab = cls._merge_vocabularies(vocabs, line_counts, **kwargs)

        config = {k: kwargs[k] for k in ("tokenization", "inline_case",
                                         "protect_regex", "nfkc") if k in kwargs}
        if existing_bpe_path:
            existing = cls(existing_bpe_path)
            merges = [p for p, _ in sorted(existing.merges.items(), key=lambda kv: kv[1])]
        else:
            merges = cls._learn_merges(vocab, num_symbols)

        if output is not None:
            dirname = os.path.dirname(output)
            if dirname:
                os.makedirs(dirname, exist_ok=True)
            with open(output, "w") as f:
                print("#", json.dumps(config, ensure_ascii=False), file=f)
                for left, right in merges:
                    print(left, right, file=f)

        model = cls(merges, **{k: v for k, v in config.items() if k != "tokenization"})
        encoded_vocabs = {}
        for lang, v in vocabs.items():
            enc: dict[str, int] = defaultdict(int)
            for word, count in v.items():
                for piece in model._encode(word):
                    enc[piece] += count
            encoded_vocabs[lang] = Counter(enc)
        return model, encoded_vocabs

    @staticmethod
    def _learn_merges(vocab: Counter, num_symbols: int) -> list[tuple]:
        """Greedy max-frequency pair merging with incremental statistics.

        Ties are broken by the lexicographically largest pair, like subword-nmt,
        so models trained on identical corpora match the reference merge-for-merge.
        """
        words = [(tuple(w), c) for w, c in sorted(vocab.items(), key=lambda kv: kv[1],
                                                  reverse=True)]
        stats: dict[tuple, int] = defaultdict(int)
        where: dict[tuple, dict[int, int]] = defaultdict(lambda: defaultdict(int))
        for idx, (word, freq) in enumerate(words):
            for pair in zip(word, word[1:]):
                stats[pair] += freq
                where[pair][idx] += 1

        merges: list[tuple] = []
        while len(merges) < num_symbols and stats:
            best = max(stats, key=lambda p: (stats[p], p))
            if stats[best] < 2:
                break
            merges.append(best)
            left, right = best
            joined = left + right
            occurrences = where.pop(best)
            stats.pop(best)
            for idx, n in occurrences.items():
                if n < 1:
                    continue
                old_word, freq = words[idx]
                new_word: list[str] = []
                i = 0
                while i < len(old_word):
                    if (i < len(old_word) - 1 and old_word[i] == left
                            and old_word[i + 1] == right):
                        new_word.append(joined)
                        i += 2
                    else:
                        new_word.append(old_word[i])
                        i += 1
                # replace this word's contribution to the pair statistics
                for pair in zip(old_word, old_word[1:]):
                    if pair != best:
                        stats[pair] -= freq
                        where[pair][idx] -= 1
                for pair in zip(new_word, new_word[1:]):
                    stats[pair] += freq
                    where[pair][idx] += 1
                words[idx] = (tuple(new_word), freq)
            # drop non-positive entries to keep max() scans tight
            if len(merges) % 256 == 0:
                stats = defaultdict(int, {p: c for p, c in stats.items() if c > 0})
        return merges

    # -- dictionary building -------------------------------------------------

    @staticmethod
    def build_dict(encoded_vocabs: dict, vocab_size: Optional[int] = None,
                   min_count: int = 1, padding_factor: int = 8,
                   extra_tokens: Optional[list[str]] = None,
                   placeholders: int = 0, padding_offset: int = 4,
                   char_coverage: float = 1.0) -> list[tuple]:
        """Merge per-language encoded vocabularies into a (token, count) list
        sorted by frequency, optionally truncated/padded like the reference CLI
        (cli/tokenizer.py add_dict_args: placeholders, padding offset,
        character coverage)."""
        total: Counter = Counter()
        for v in encoded_vocabs.values():
            total.update(v)
        items = [(t, c) for t, c in total.most_common() if c >= min_count]
        if char_coverage < 1.0:
            # drop the rarest single characters outside the coverage ratio
            chars = [(t, c) for t, c in items if len(t.lstrip(WORD_SEP)) <= 1]
            char_total = sum(c for _, c in chars) or 1
            covered, keep = 0, set()
            for t, c in chars:  # most_common order
                if covered / char_total >= char_coverage:
                    break
                keep.add(t)
                covered += c
            items = [(t, c) for t, c in items
                     if len(t.lstrip(WORD_SEP)) > 1 or t in keep]
        if vocab_size:
            items = items[:vocab_size]
        for token in extra_tokens or []:
            if all(t != token for t, _ in items):
                items.append((token, 0))
        for i in range(placeholders):
            items.append((f"<placeholder{i}>", 0))
        if padding_factor and padding_factor > 1:
            # final size including `padding_offset` specials, padded to a multiple
            i = placeholders
            while (len(items) + padding_offset) % padding_factor != 0:
                items.append((f"madeupword{i:04}", 0))
                i += 1
        return items
