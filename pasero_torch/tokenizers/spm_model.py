# Copy of pasero_tpu/tokenizers/spm_model.py, verbatim.
"""Self-contained SentencePiece model reader + encoder.

The reference depends on the `sentencepiece` pip package (C++ extension,
pasero/tokenizers/__init__.py:33-167) — absent from this TPU image.  An spm
``.model`` file is just a protobuf ``ModelProto`` whose payload is the piece
inventory (piece string, log-probability score, piece type) plus trainer /
normalizer specs; this module parses that wire format directly and
implements the two encoding algorithms spm models use:

- **unigram** (the flores200 / NLLB models): Viterbi segmentation that
  maximizes the sum of piece log-probabilities;
- **bpe**: iterated merging of the adjacent pair whose merged piece has the
  highest score (spm stores BPE merge priority as the piece score).

`MiniSentencePieceProcessor` exposes the subset of the SentencePieceProcessor
API the rest of the stack uses (EncodeAsPieces / SetVocabulary / IdToPiece /
PieceToId / IsUnknown / vocab_size), so `SentencePieceTokenizer` and spBLEU
(`metrics_text.corpus_spbleu`) run without the dependency.  `write_model`
serializes a ModelProto for fixtures and tooling.

Normalization: real spm applies a precompiled normalizer (default
``nmt_nfkc``); this reader approximates it with NFKC + whitespace collapse,
which matches on the ASCII/Latin text of the in-tree fixtures and recipes.
"""

from __future__ import annotations

import struct
import unicodedata
from typing import Iterable, Optional

WORD_SEP = "▁"  # ▁

# SentencePiece.Type enum values (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
# TrainerSpec.ModelType
UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4


# ---------------------------------------------------------------------------
# protobuf wire format (just enough for ModelProto)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = value = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, i
        shift += 7


def _skip_field(buf: bytes, i: int, wire_type: int) -> int:
    if wire_type == 0:
        _, i = _read_varint(buf, i)
    elif wire_type == 1:
        i += 8
    elif wire_type == 2:
        n, i = _read_varint(buf, i)
        i += n
    elif wire_type == 5:
        i += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return i


def _iter_fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 5:
            value = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wire == 1:
            value = struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value = buf[i:i + n]
            i += n
        else:
            i = _skip_field(buf, i, wire)
            continue
        yield field, wire, value


def parse_model(data: bytes) -> tuple[list[tuple[str, float, int]], int]:
    """ModelProto bytes -> ([(piece, score, type)], model_type)."""
    pieces: list[tuple[str, float, int]] = []
    model_type = UNIGRAM
    for field, wire, value in _iter_fields(data):
        if field == 1 and wire == 2:          # repeated SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for f2, _w2, v2 in _iter_fields(value):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = float(v2)
                elif f2 == 3:
                    ptype = int(v2)
            pieces.append((piece, score, ptype))
        elif field == 2 and wire == 2:        # TrainerSpec
            for f2, _w2, v2 in _iter_fields(value):
                if f2 == 3 and isinstance(v2, bytes):
                    name = v2.decode("utf-8", "ignore").upper()
                    model_type = {"UNIGRAM": UNIGRAM, "BPE": BPE,
                                  "WORD": WORD, "CHAR": CHAR}.get(name,
                                                                  UNIGRAM)
                elif f2 == 3:
                    model_type = int(v2)
    return pieces, model_type


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def write_model(pieces: Iterable[tuple[str, float, int]],
                path: Optional[str] = None, model_type: int = UNIGRAM) -> bytes:
    """Serialize a minimal ModelProto (fixture/tooling helper)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        sp = bytearray()
        raw = piece.encode("utf-8")
        sp += _field(1, 2) + _varint(len(raw)) + raw
        sp += _field(2, 5) + struct.pack("<f", score)
        sp += _field(3, 0) + _varint(ptype)
        out += _field(1, 2) + _varint(len(sp)) + bytes(sp)
    trainer = _field(3, 0) + _varint(model_type)
    out += _field(2, 2) + _varint(len(trainer)) + trainer
    data = bytes(out)
    if path:
        with open(path, "wb") as f:
            f.write(data)
    return data


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

class MiniSentencePieceProcessor:
    """Pure-python stand-in for sentencepiece.SentencePieceProcessor."""

    _UNK_PENALTY = 10.0  # spm's unigram unk score penalty below the minimum

    def __init__(self, model_file: str):
        with open(model_file, "rb") as f:
            data = f.read()
        self._pieces, self._model_type = parse_model(data)
        assert self._pieces, f"{model_file}: no pieces parsed"
        self._ids = {p: i for i, (p, _, _) in enumerate(self._pieces)}
        self._unk_id = next((i for i, (_, _, t) in enumerate(self._pieces)
                             if t == UNKNOWN), 0)
        min_score = min((s for _, s, t in self._pieces if t == NORMAL),
                        default=0.0)
        self._unk_score = min_score - self._UNK_PENALTY
        self._active: Optional[set] = None
        self._max_piece_len = max(len(p) for p, _, _ in self._pieces)

    # -- API subset -----------------------------------------------------------
    def vocab_size(self) -> int:
        return len(self._pieces)

    def __len__(self) -> int:
        return len(self._pieces)

    def IdToPiece(self, i: int) -> str:
        return self._pieces[i][0]

    def PieceToId(self, piece: str) -> int:
        return self._ids.get(piece, self._unk_id)

    def IsUnknown(self, i: int) -> bool:
        return i == self._unk_id

    def SetVocabulary(self, vocab: Iterable[str]) -> None:
        """Restrict encoding to these pieces (test-time vocab filtering,
        reference tokenizers/__init__.py:74-86); single-char NORMAL pieces
        stay usable so every input remains encodable."""
        allowed = set(vocab)
        self._active = {p for p, _, t in self._pieces
                        if p in allowed or t != NORMAL or len(p) == 1}

    def ResetVocabulary(self) -> None:
        self._active = None

    def _usable(self, piece: str) -> bool:
        if piece not in self._ids:
            return False
        ptype = self._pieces[self._ids[piece]][2]
        if ptype in (UNKNOWN, CONTROL, UNUSED):
            return False
        return self._active is None or piece in self._active

    def _score(self, piece: str) -> float:
        return self._pieces[self._ids[piece]][1]

    @staticmethod
    def normalize(text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = " ".join(text.split())
        return (WORD_SEP + text.replace(" ", WORD_SEP)) if text else ""

    def EncodeAsPieces(self, text: str) -> list[str]:
        s = self.normalize(text)
        if not s:
            return []
        if self._model_type == BPE:
            return self._encode_bpe(s)
        return self._encode_unigram(s)

    def EncodeAsIds(self, text: str) -> list[int]:
        return [self.PieceToId(p) for p in self.EncodeAsPieces(text)]

    def DecodePieces(self, pieces: list[str]) -> str:
        return "".join(pieces).replace(WORD_SEP, " ").strip()

    # -- algorithms -----------------------------------------------------------
    def _encode_unigram(self, s: str) -> list[str]:
        """Viterbi over piece log-probabilities (spm unigram inference).
        Characters no piece covers surface as themselves (the wrapper's
        IsUnknown check then spells them out, matching real spm's
        EncodeAsPieces which emits the raw surface for unknowns)."""
        n = len(s)
        best = [float("-inf")] * (n + 1)
        back: list[tuple[int, str]] = [(0, "")] * (n + 1)
        best[0] = 0.0
        maxlen = self._max_piece_len
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            matched = False
            for j in range(i + 1, min(n, i + maxlen) + 1):
                piece = s[i:j]
                if self._usable(piece):
                    matched = True
                    score = best[i] + self._score(piece)
                    if score > best[j]:
                        best[j] = score
                        back[j] = (i, piece)
            # unknown single char fallback
            if not matched or not self._usable(s[i:i + 1]):
                score = best[i] + self._unk_score
                if score > best[i + 1]:
                    best[i + 1] = score
                    back[i + 1] = (i, s[i:i + 1])
        pieces = []
        j = n
        while j > 0:
            i, piece = back[j]
            pieces.append(piece)
            j = i
        return pieces[::-1]

    def _encode_bpe(self, s: str) -> list[str]:
        """Greedy highest-score merging (spm BPE inference: the score of a
        piece is its merge priority; always merge the best adjacent pair)."""
        symbols = list(s)
        while len(symbols) > 1:
            best_score, best_i = float("-inf"), -1
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                if self._usable(merged) and self._score(merged) > best_score:
                    best_score, best_i = self._score(merged), i
            if best_i < 0:
                break
            symbols[best_i:best_i + 2] = [symbols[best_i] +
                                          symbols[best_i + 1]]
        return symbols


def load_processor(model_file: str):
    """Real sentencepiece when importable, else the mini reader."""
    try:
        import sentencepiece as spm
        return spm.SentencePieceProcessor(model_file=model_file)
    except ImportError:
        return MiniSentencePieceProcessor(model_file)
