# Copy of pasero_tpu/tokenizers/__init__.py, verbatim.
"""Tokenizer implementations and wrappers (pasero/tokenizers/__init__.py).

``PaseroTokenizer`` (our own BPE) is the default; SentencePiece and HuggingFace
wrappers are optional-import gated (sentencepiece is not guaranteed in the TPU
image). All tokenizers share the protocol:

    tokenize(text, **opts) -> list[str]        # subword tokens with ▁ markers
    detokenize via module-level ``detokenize(tokens)``
"""

from __future__ import annotations

import unicodedata
from typing import Iterable, Optional

import regex

from .noise import MASK, noisify
from .pasero_tokenizer import (CASE_TAGS, COPY_TAG, LOWER, TITLE, UPPER,
                               WORD_SEP, PaseroTokenizer, detokenize,
                               inline_case_to_cased, _NO_MIXED_CASE)

sep, bos, pad, eos, unk = "<sep>", "<s>", "<pad>", "</s>", "<unk>"
mask = MASK
copy_tag = COPY_TAG


def load_vocab(path: str, threshold: Optional[int] = None) -> list[str]:
    """Load a fairseq-format vocabulary: one 'token [freq]' per line."""
    vocab = []
    with open(path, newline="\n") as f:
        for line in f:
            m = regex.match(r"(.+?)(\s\d+)?$", line)
            if not m:
                continue
            word, freq = m.groups()
            if threshold is None or (int(freq) if freq else 0) >= threshold:
                vocab.append(word)
    return vocab


class SentencePieceTokenizer:
    """Wrapper over a SentencePiece model with optional vocabulary restriction
    and inline-case post-processing (pasero/tokenizers/__init__.py:33-167)."""

    def __init__(self, path: str, vocab: Optional[list[str]] = None,
                 inline_case: bool = False):
        # real sentencepiece when installed; else the vendored pure-python
        # ModelProto reader + unigram/BPE encoder (tokenizers/spm_model.py),
        # so spm models work on images without the C++ package
        from .spm_model import load_processor
        self.path = path
        self.inline_case = inline_case
        self._sp = load_processor(path)
        if vocab:
            self._sp.SetVocabulary(list(vocab))
            self._vocab = vocab
        else:
            self._vocab = [self._sp.IdToPiece(i) for i in range(self._sp.vocab_size())]

    def __getstate__(self):
        return {"path": self.path, "vocab": self._vocab, "inline_case": self.inline_case}

    def __setstate__(self, state):
        self.__init__(**state)

    def __len__(self):
        return len(self._sp)

    def _pieces(self, text: str) -> list[str]:
        out = []
        for piece in self._sp.EncodeAsPieces(text):
            if self._sp.IsUnknown(self._sp.PieceToId(piece)):
                out.extend(list(piece))  # spell out unknown pieces
            else:
                out.append(piece)
        return out

    @staticmethod
    def _case_of(s: str):
        if s.istitle():
            return TITLE
        if s.isupper():
            return UPPER
        if s.islower() or s.lower() == s:
            return LOWER
        return None

    def tokenize(self, text: str, **_) -> list[str]:
        if not self.inline_case:
            return self._pieces(text)
        orig = regex.sub(r"\s+", " ", unicodedata.normalize("NFKC", text)).strip()
        # lowercase words only when lowercasing preserves length (for alignment)
        orig_lower = " ".join(w if len(w) != len(w.lower()) else w.lower()
                              for w in orig.split())
        pieces = self._pieces(orig_lower)
        out: list[str] = []
        j = 0
        for piece in pieces:
            if piece == WORD_SEP:
                out.append(piece)
                continue
            prefix = ""
            bare = piece
            if bare.startswith(WORD_SEP):
                prefix, bare = WORD_SEP, bare[1:]
            i = orig_lower.find(bare, j)
            if i < 0:
                out.append(piece)
                continue
            j = i + len(bare)
            cased = orig[i:j]
            case = self._case_of(cased)
            if case is None and len(cased) == len(bare):
                # mixed case inside one piece: split it further
                k = 0
                for m, part in enumerate(_NO_MIXED_CASE.findall(cased)):
                    c = self._case_of(part) or LOWER
                    out.append((prefix if m == 0 else "") + bare[k:k + len(part)])
                    if CASE_TAGS[c]:
                        out.append(CASE_TAGS[c])
                    k += len(part)
            else:
                out.append(prefix + bare)
                if case is not None and CASE_TAGS[case]:
                    out.append(CASE_TAGS[case])
        return out

    def decode_hex_bytes(self, text: str) -> str:
        """Decode Llama-style '<0x0A>' byte tokens."""
        def sub(m):
            try:
                return bytes([int(m.group(1), 16)]).decode("utf-8", errors="ignore")
            except ValueError:
                return m.group(0)
        return regex.sub(r"<0x([0-9A-Fa-f]{2})>", sub, text)


class HuggingFaceTokenizer:
    """AutoTokenizer wrapper mapping HF special tokens onto <s>/<pad>/</s>/<unk>
    names and supporting streaming detokenization by re-decode diffing
    (pasero/tokenizers/__init__.py:170-214)."""

    def __init__(self, path: str, **kwargs):
        from transformers import AutoTokenizer
        self._tok = AutoTokenizer.from_pretrained(path, use_fast=True, **kwargs)
        self.path = path

    def __len__(self):
        return len(self._tok)

    @property
    def vocab(self) -> dict:
        v = dict(self._tok.get_vocab())
        remap = {self._tok.bos_token: bos, self._tok.eos_token: eos,
                 self._tok.pad_token: pad, self._tok.unk_token: unk}
        for old, new in remap.items():
            if old is not None and old in v and new not in v:
                v[new] = v.pop(old)
        return v

    def tokenize(self, text: str, **_) -> list[str]:
        return self._tok.tokenize(text)

    def detokenize(self, tokens: list[str]) -> str:
        ids = self._tok.convert_tokens_to_ids(tokens)
        return self._tok.decode(ids, skip_special_tokens=True)


class CharacterTokenizer:
    """Character-level tokenization with ▁ marking word starts."""

    def tokenize(self, text: str, **_) -> list[str]:
        tokens = []
        for word in text.split():
            tokens.extend([WORD_SEP + word[0]] + list(word[1:]))
        return tokens

    def __len__(self):
        return 0


def build_tokenizer(impl: str, path: Optional[str] = None,
                    vocab: Optional[Iterable[str]] = None,
                    inline_case: bool = False, **kwargs):
    """Factory resolving the --tokenizer option to an implementation."""
    if impl == "pasero":
        assert path, "--tokenizer pasero requires --tokenizer-path"
        return PaseroTokenizer(path, vocab=list(vocab) if vocab else None,
                               inline_case=inline_case, **kwargs)
    if impl == "sentencepiece":
        return SentencePieceTokenizer(path, vocab=list(vocab) if vocab else None,
                                      inline_case=inline_case)
    if impl == "hf":
        return HuggingFaceTokenizer(path)
    if impl == "char":
        return CharacterTokenizer()
    if impl == "none" or impl is None:
        return None
    raise ValueError(f"unknown tokenizer implementation {impl!r}")
