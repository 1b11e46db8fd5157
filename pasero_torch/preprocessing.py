# Copy of pasero_tpu/preprocessing.py, verbatim.
"""Dictionary and text preprocessing pipeline.

Re-implements the reference's preprocessing layer (pasero/preprocessing.py):
fairseq/JSON dictionaries with mutable special ids, lang/domain tags, and the
``TextPreprocessor`` pipeline (normalization → noise → protected-token
splitting → subword tokenization → binarization → (de)tokenization).

Binarized outputs are numpy int32 arrays — device tensors are only created by
the batch collator, keeping this layer host-only and multiprocessing-friendly.
"""

from __future__ import annotations

import collections
import copy
import itertools
import json
import logging
import os
from typing import Iterable, Iterator, Optional, Sequence, Union

import numpy as np
import regex

from .config import PreprocessingConfig
from .config.common import NoiseConfig
from .tokenizers import (CharacterTokenizer, HuggingFaceTokenizer,
                         PaseroTokenizer, SentencePieceTokenizer, bos, copy_tag,
                         eos, load_vocab, mask, pad, sep, unk)
from .tokenizers.noise import noisify
from .utils.text import (find_file, remove_non_printing_char,
                         replace_unicode_punct)

logger = logging.getLogger("preprocessing")


def mask_padding(ids: Sequence[int], eos_idx: int, padding_idx: int) -> list[int]:
    """1 at padding positions, everything after the first EOS included."""
    out = []
    for token_id in ids:
        out.append(1 if token_id == padding_idx else 0)
        if token_id == eos_idx:
            break
    return out + [1] * (len(ids) - len(out))


class Dictionary:
    """fairseq-style token <-> id mapping (pasero/preprocessing.py:45-151).

    Three input formats:
    - fairseq text dict (no special tokens): ``<sep> <pad> </s> <unk>`` are
      prepended as ids 0-3;
    - custom text dict that already contains ``</s>``: ids = line numbers;
    - HF JSON vocab mapping tokens to ids.
    Special ids are mutable so the model config can override them
    (tasks/task.py:242-257 in the reference).
    """

    def __init__(self, vocab: Union[list, dict], size: Optional[int] = None):
        assert not isinstance(vocab, str), "use Dictionary.build(path)"
        id_of = (self._ids_from_map(vocab) if isinstance(vocab, dict)
                 else self._ids_from_entries(vocab))
        vocab_len = 1 + max(id_of.values())
        token_of = [unk] * vocab_len
        for token, idx in id_of.items():
            token_of[idx] = token  # id-range gaps stay unk placeholders
        self.tokens, self.indices = token_of, id_of
        if size is not None:
            self.extend(size)
        self._resolve_special_ids()

    @staticmethod
    def _ids_from_map(vocab: dict) -> dict:
        """HF-style token->id JSON map, taken as-is."""
        assert vocab and min(vocab.values()) >= 0, "negative ids not allowed"
        return dict(vocab)

    @staticmethod
    def _ids_from_entries(vocab) -> dict:
        """Text dictionary: line number = id, with the fairseq convention
        (specials absent from the file, implicitly occupying ids 0-3)."""
        entries = list(vocab)
        if eos not in entries:
            clash = sorted({sep, bos, pad, unk} & set(entries))
            assert not clash, (
                f"dictionary has a partial set of special tokens {clash}: "
                "either none (fairseq-style) or at least '</s>' "
                "(custom-style)")
            entries = [sep, pad, eos, unk] + entries
        return {t: i for i, t in enumerate(entries)}

    def _resolve_special_ids(self):
        """Each special falls back along a chain when its token is absent;
        all five stay mutable (model configs may override them)."""
        found = self.indices.get
        self.eos_idx = found(eos)
        self.padding_idx = found(pad, found(unk))
        self.unk_idx = found(unk, self.padding_idx)
        self.bos_idx = found(bos, self.eos_idx)
        self.sep_idx = found(sep, self.bos_idx)

    @classmethod
    def build(cls, path: str, size: Optional[int] = None) -> "Dictionary":
        if path.endswith(".json"):
            with open(path) as f:
                return cls(json.load(f), size=size)
        return cls(load_vocab(path), size=size)

    def save(self, path: str, counts: Optional[dict] = None) -> None:
        """Write in fairseq text format (specials stripped from the head)."""
        with open(path, "w") as f:
            start = 4 if self.tokens[:4] == [sep, pad, eos, unk] else 0
            for token in self.tokens[start:]:
                print(token, (counts or {}).get(token, 0), file=f)

    def extend(self, size: int) -> None:
        """Pad to ``size`` with fairseq 'madeupwordNNNN' filler entries."""
        fillers = (f"madeupword{n:04}" for n in itertools.count())
        while len(self.tokens) < size:
            token = next(fillers)
            if token in self.indices:
                continue
            self.indices[token] = len(self.tokens)
            self.tokens.append(token)

    def __len__(self):
        return len(self.tokens)

    def __contains__(self, token: str) -> bool:
        return token in self.indices

    def __iter__(self):
        return iter(self.tokens)

    def __getitem__(self, idx: int) -> str:
        # special ids win over the token list (eos/bos may share an id);
        # read the attributes live — they are mutable
        for token, special_idx in ((eos, self.eos_idx), (pad, self.padding_idx),
                                   (bos, self.bos_idx), (sep, self.sep_idx),
                                   (unk, self.unk_idx)):
            if idx == special_idx:
                return token
        return self.tokens[idx]

    def __setitem__(self, idx: int, token: str):
        if idx >= len(self.tokens):
            # a model's special ids may exceed a small dictionary (e.g. Whisper
            # declares bos at 50258); grow with placeholder tokens
            self.extend(idx + 1)
        self.tokens[idx] = token
        self.indices[token] = idx

    def __eq__(self, other):
        return isinstance(other, Dictionary) and other.tokens == self.tokens

    def idx(self, token: str) -> int:
        return self.indices.get(token, self.unk_idx)

    def to_indices(self, tokens: list[str], max_len: Optional[int] = None,
                   append_eos: bool = True, prepend_bos: bool = False,
                   truncate_left: bool = False) -> np.ndarray:
        ids = [self.idx(t) for t in tokens]
        if max_len is not None:
            budget = max_len - int(append_eos) - int(prepend_bos)
            ids = ids[-budget:] if truncate_left else ids[:budget]
        if prepend_bos:
            ids.insert(0, self.bos_idx)
        if append_eos:
            ids.append(self.eos_idx)
        return np.asarray(ids, dtype=np.int32)

    def to_string(self, ids: Sequence[int]) -> list[str]:
        return [self[i] for i in ids if i != self.padding_idx]

    def remap_embed(self, old_embed: np.ndarray, old_dict: "Dictionary",
                    default: Optional[str] = None,
                    init_fn=None) -> np.ndarray:
        """Re-map embedding rows to this dictionary's token order
        (test-time vocabulary filtering, pasero/preprocessing.py:217-236)."""
        old_embed = np.asarray(old_embed)
        row_shape = old_embed.shape[1:]
        fallback = old_dict.indices[default] if default else None

        def new_row():
            if init_fn is not None:
                return init_fn(row_shape)
            return np.random.normal(0, row_shape[-1] ** -0.5, row_shape)

        misses = 0
        rows = np.zeros((len(self.tokens),) + row_shape, old_embed.dtype)
        for i, token in enumerate(self.tokens):
            src = old_dict.indices.get(token, fallback)
            if src is None:
                rows[i] = new_row()
            else:
                rows[i] = old_embed[src]
            misses += token not in old_dict.indices
        logger.info(f"re-mapped embeddings: {misses}/{len(rows)} tokens "
                    f"mapped to {default!r}")
        return rows


# -- lang / domain tags -------------------------------------------------------

_LANG_PREFIX = "lang:"
_DOMAIN_PREFIX = "domain:"
_LANG_RE = regex.compile(rf"<{_LANG_PREFIX}(.+?)>")
_DOMAIN_RE = regex.compile(rf"<{_DOMAIN_PREFIX}(.+?)>")


def is_lang_code(token: str) -> bool:
    return bool(_LANG_RE.fullmatch(token))


def is_domain_tag(token: str) -> bool:
    return bool(_DOMAIN_RE.fullmatch(token))


def is_tag(token: str) -> bool:
    return is_lang_code(token) or is_domain_tag(token)


def split_tags(line: str) -> list[str]:
    """Split leading lang/domain tags from a line: returns [*tags, rest]."""
    tokens = line.split()
    tags = list(itertools.takewhile(is_tag, tokens))
    for tag in tags:
        line = regex.sub(rf"\s*{regex.escape(tag)}\s*", "", line, count=1)
    return [*tags, line]


def get_lang_code(lang: Optional[str]) -> Optional[str]:
    return f"<{_LANG_PREFIX}{lang}>" if lang else None


def get_domain_tag(domain: Optional[str]) -> Optional[str]:
    return f"<{_DOMAIN_PREFIX}{domain}>" if domain else None


# -- preprocessor -------------------------------------------------------------

class TextPreprocessor:
    """normalization → noise → protected-token split → BPE → binarize
    (pasero/preprocessing.py:272-670)."""

    def __init__(self, cfg: PreprocessingConfig, dir: str, **kwargs):
        self.training = False
        self.dir = dir
        self.cfg = cfg.clone() if hasattr(cfg, "clone") else copy.copy(cfg)
        for k, v in kwargs.items():
            setattr(self.cfg, k, v)

        if self.cfg.keep_whitespaces:
            assert not self.cfg.normalize_punctuation, \
                "--keep-whitespaces is incompatible with normalization"
        if not self.cfg.tokenizer_path:
            self.cfg.tokenizer_path = self.default_tokenizer_path(self.cfg.tokenizer) or dir
        if self.cfg.bpe_dropout or self.cfg.spell_out:
            assert self.cfg.tokenizer == "pasero", \
                "--spell-out/--bpe-dropout require --tokenizer pasero"

        self.dict_path = self.tokenizer_path = None
        self.load_tokenizer()
        assert not self.cfg.masking or mask in self.dictionary, f"{mask} is OOV"

        protected = [sep, bos, eos, unk] + list(self.cfg.protect_tokens)
        self.protected_tokens_regex = regex.compile(
            "|".join(regex.escape(t) for t in protected))
        split_tokens = protected + list(self.cfg.stop_sequences)
        self.split_tokens_regex = regex.compile(
            "(" + "|".join(regex.escape(t) for t in split_tokens) + ")")
        self.set_stop_sequences(list(self.cfg.stop_sequences))

    # mutable special ids, proxied to the dictionary: assigning an id also
    # registers the special token at that slot (bos additionally accepts -1
    # for "no bos")
    def _special_id_proxy(attr, token, skip_negative=False):
        def read(self):
            return getattr(self.dictionary, attr)

        def write(self, value):
            setattr(self.dictionary, attr, value)
            if not (skip_negative and value < 0):
                self.dictionary[value] = token
        return property(read, write)

    bos_idx = _special_id_proxy("bos_idx", bos, skip_negative=True)
    eos_idx = _special_id_proxy("eos_idx", eos)
    padding_idx = _special_id_proxy("padding_idx", pad)
    unk_idx = _special_id_proxy("unk_idx", unk)
    del _special_id_proxy

    @classmethod
    def default_tokenizer_path(cls, tokenizer: str) -> Optional[str]:
        return {"sentencepiece": "spm.model", "pasero": "bpecodes"}.get(tokenizer)

    def train(self):
        self.training = True

    def eval(self):
        self.training = False

    def infer_langs(self) -> set:
        return {m.group(1) for t in self.dictionary
                if (m := _LANG_RE.fullmatch(t))}

    @property
    def num_symbols(self) -> int:
        return len(self.dictionary)

    @property
    def files(self) -> set:
        """Files to copy into the model directory at training."""
        return {self.tokenizer_path, self.dict_path} - {None}

    def load_tokenizer(self) -> None:
        requires_dict = self.cfg.tokenizer in ("none", "char", "pasero")
        if self.cfg.dict:
            self.dict_path = find_file(self.cfg.dict, dirs=[self.dir, "."],
                                       fail=requires_dict)
        else:
            self.dict_path = find_file("dict.json", "dict.txt", dirs=[self.dir],
                                       fail=requires_dict)
        self.dictionary = Dictionary.build(self.dict_path) if self.dict_path else None

        impl = self.cfg.tokenizer
        if impl == "none":
            self._tokenizer = None
        elif impl == "char":
            self._tokenizer = CharacterTokenizer()
        elif impl == "hf":
            self._tokenizer = HuggingFaceTokenizer(self.cfg.tokenizer_path or self.dir)
            if self.dictionary is None:
                self.dictionary = Dictionary(self._tokenizer.vocab)
        elif impl == "pasero":
            self.tokenizer_path = find_file(self.cfg.tokenizer_path,
                                            dirs=[self.dir, "."], fail=True)
            self._tokenizer = PaseroTokenizer(
                self.tokenizer_path,
                vocab=self.dictionary.tokens if self.dictionary else None,
                inline_case=self.cfg.inline_case)
        elif impl == "sentencepiece":
            self.tokenizer_path = find_file(self.cfg.tokenizer_path,
                                            dirs=[self.dir, "."], fail=True)
            self._tokenizer = SentencePieceTokenizer(
                self.tokenizer_path,
                vocab=self.dictionary.tokens if self.dictionary else None,
                inline_case=self.cfg.inline_case)
            if self.dictionary is None:
                self.dictionary = Dictionary(
                    {p: i for i, p in enumerate(self._tokenizer._vocab)})
        else:
            raise ValueError(f"unknown tokenizer type {impl!r}")
        assert self.dictionary is not None, "no dictionary could be loaded"

    @property
    def inference_options(self) -> dict:
        """Non-default preprocessing options for inference.yaml, with tokenizer
        paths rewritten to the model-dir basenames."""
        noise_only = set(NoiseConfig._fields)
        defaults = PreprocessingConfig()
        options = {}
        for name in PreprocessingConfig._fields:
            value = getattr(self.cfg, name, None)
            if name not in noise_only and value != getattr(defaults, name):
                options[name] = value
        for name, value in (("tokenizer_path", self.tokenizer_path),
                            ("dict", self.dict_path)):
            options.pop(name, None)
            if value is not None:
                options[name] = os.path.basename(value)
        if self.cfg.tokenizer == "hf":
            options["tokenizer_path"] = self.cfg.tokenizer_path
        return options

    def get_oov(self, tokens: list[str]):
        counts = collections.Counter(tokens)
        oov = {w for w in counts if w not in self.dictionary}
        return counts, oov

    def binarize(self, tokens: list[str], max_len: Optional[int] = None,
                 append_eos: bool = True, prepend_bos: bool = False,
                 truncate_left: bool = False) -> np.ndarray:
        return self.dictionary.to_indices(
            tokens, max_len=max_len, append_eos=append_eos,
            prepend_bos=prepend_bos, truncate_left=truncate_left)

    def escape_emojis(self, line: str):
        """Replace OOV emojis by a placeholder; returns (line, emojis)."""
        if copy_tag in self.dictionary:
            placeholder = copy_tag
        elif "🙂" in self.dictionary:
            placeholder = "🙂"
        else:
            return line, []
        try:
            import emoji as emoji_mod
        except ImportError:
            return line, []
        emojis = []
        for e in emoji_mod.emoji_list(line):
            e = e["emoji"]
            if e not in self.dictionary:
                emojis.append(e)
                line = line.replace(e, placeholder)
        return line, emojis

    def deescape_emojis(self, line: str, emojis: list[str]) -> str:
        placeholder = copy_tag if copy_tag in line else "🙂"
        for e in emojis:
            line = regex.sub(regex.escape(placeholder), e, line, count=1)
        line = line.replace(copy_tag, "")
        return " ".join(line.split(" "))

    def tokenize(self, line: str) -> list[str]:
        if not self.cfg.keep_whitespaces:
            line = remove_non_printing_char(line)
            line = " ".join(line.split())
            if line and self.cfg.normalize_punctuation:
                line = replace_unicode_punct(line)
        if self.training:
            line = noisify(line, **{k: getattr(self.cfg, k) for k in
                                    ("noise_ops", "char_noise", "word_noise",
                                     "space_noise", "punct_noise", "masking")})
        if not line or self.cfg.tokenizer == "none":
            return line.split()
        dropout = self.cfg.bpe_dropout if self.training else 0.0
        spell_out = self.cfg.spell_out if self.training else 0.0
        tokens: list[str] = []
        for split in self.split_tokens_regex.split(line):
            if not split:
                continue
            if self.protected_tokens_regex.fullmatch(split):
                tokens.append(split)
            else:
                tokens += self._tokenizer.tokenize(split, dropout=dropout,
                                                   spell_out=spell_out)
        return tokens

    def debinarize(self, ids: Sequence[int]) -> list[str]:
        return self.dictionary.to_string(ids)

    def detokenize(self, tokens: list[str]) -> str:
        tokens = self.remove_special_tokens(tokens)
        if self._tokenizer is not None and hasattr(self._tokenizer, "detokenize"):
            line = self._tokenizer.detokenize(tokens)
        elif self._tokenizer is not None:
            from .tokenizers import detokenize as detok
            line = detok(tokens)
        else:
            line = " ".join(tokens)
        if not self.cfg.keep_whitespaces:
            line = line.rstrip()
        return line

    def set_stop_sequences(self, stop_sequences: list[str]) -> None:
        self.raw_stop_sequences = stop_sequences
        self.tok_stop_sequences = [self.tokenize(s) for s in stop_sequences]
        self.bin_stop_sequences = [self.binarize(t, append_eos=False)
                                   for t in self.tok_stop_sequences]

    @property
    def blacklist(self) -> list[int]:
        return [self.dictionary.idx(t) for t in self.cfg.blacklist]

    def is_special_token(self, token: str) -> bool:
        return (token in (unk, eos)
                or any(len(s) == 1 and token == s[0] for s in self.tok_stop_sequences))

    def remove_special_tokens(self, tokens: list[str]) -> list[str]:
        tokens = [t for t in tokens if not self.is_special_token(t)]
        for stop_seq in self.tok_stop_sequences:
            if len(stop_seq) > 1 and tokens[-len(stop_seq):] == stop_seq:
                tokens = tokens[:-len(stop_seq)]
                break
        return tokens

    def detokenize_on_the_fly(self, tokens: Iterable[str]) -> Iterator[tuple]:
        """Stream tokens → stream of (word, [tokens]) pairs; words carry their
        leading space so concatenation reproduces the detokenized text."""
        from .tokenizers.pasero_tokenizer import WORD_SEP, inline_case_to_cased
        buffer: list[str] = []

        def flush():
            cased = inline_case_to_cased(buffer)
            word = "".join(cased).replace(WORD_SEP, " ")
            return word, list(buffer)

        for token in tokens:
            if self.is_special_token(token):
                continue
            starts_word = token.startswith(WORD_SEP)
            if starts_word and buffer:
                yield flush()
                buffer = []
            buffer.append(token)
        if buffer:
            yield flush()
