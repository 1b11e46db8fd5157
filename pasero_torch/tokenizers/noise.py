# Copy of pasero_tpu/tokenizers/noise.py, verbatim.
"""Training-time text noise: word/space/punct drops, char edits, masking.

Behavioral equivalent of the reference noise module
(pasero/tokenizers/noise.py:44-95): operations are sampled per character/word
with the configured probabilities; consecutive masks collapse to one.
"""

from __future__ import annotations

import string

import numpy as np
import regex

MASK = "<mask>"
_ALPHABET = list(string.ascii_letters)
_NONWORD = regex.compile(r"\W")
_MASK_RUN = regex.compile(rf"{regex.escape(MASK)}( ?{regex.escape(MASK)})*")


def _split_words(line: str) -> tuple[list[str], list[bool]]:
    tokens = [t for t in regex.split(r"(\W)", line) if t]
    return tokens, [not _NONWORD.match(t) for t in tokens]


def noisify(
    line: str,
    rng: np.random.Generator | None = None,
    noise_ops=("ins", "del", "sub", "swap"),
    char_noise: float = 0.0,
    word_noise: float = 0.0,
    space_noise: float = 0.0,
    punct_noise: float = 0.0,
    masking: float = 0.0,
    **_,
) -> str:
    rng = rng or np.random.default_rng()
    toss = lambda p: p > 0 and rng.random() < p  # noqa: E731

    if word_noise or space_noise or punct_noise:
        tokens, is_word = _split_words(line)
        for i, token in enumerate(tokens):
            if toss(space_noise):
                tokens[i] = "" if token == " " else " " + tokens[i]
            if not is_word[i] and token != " " and toss(punct_noise):
                tokens[i] = ""
            if is_word[i] and toss(word_noise):
                tokens[i] = ""
        line = " ".join("".join(tokens).split())

    if char_noise:
        chars = list(line)
        for i, c in enumerate(chars):
            if c == " " or not toss(char_noise):
                continue
            op = noise_ops[rng.integers(len(noise_ops))]
            if op == "ins":
                chars[i] = _ALPHABET[rng.integers(len(_ALPHABET))] + c
            elif op == "sub":
                chars[i] = _ALPHABET[rng.integers(len(_ALPHABET))]
            elif op == "del":
                chars[i] = ""
            elif op == "swap" and i > 0 and chars[i - 1] != " ":
                chars[i - 1], chars[i] = chars[i], chars[i - 1]
        line = " ".join("".join(chars).split())

    if masking:
        tokens, is_word = _split_words(line)
        for i in range(len(tokens)):
            if is_word[i] and toss(masking):
                tokens[i] = MASK
                is_word[i] = False
        line = _MASK_RUN.sub(MASK, "".join(tokens))
        line = " ".join(line.split())

    return line
