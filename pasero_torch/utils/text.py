# Copy of pasero_tpu/utils/text.py, verbatim.
"""Host-side text utilities: file lookup and Moses-style normalization.

Replaces the reference's stopes dependency (pasero/preprocessing.py:20,552-558)
with self-contained equivalents.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Optional

import regex


def find_file(*names: str, dirs: list[str] = (".",), fail: bool = False) -> Optional[str]:
    """Return the first existing path among names x dirs (absolute names win)."""
    for name in names:
        if not name:
            continue
        if os.path.isabs(name) and os.path.isfile(name):
            return name
        for d in dirs:
            path = os.path.join(d, name)
            if os.path.isfile(path):
                return path
    if fail:
        raise FileNotFoundError(f"could not find {names} in {list(dirs)}")
    return None


_NON_PRINTING = regex.compile(r"[\p{C}\p{Zl}\p{Zp}]")  # control chars & line/para separators


def remove_non_printing_char(line: str) -> str:
    return _NON_PRINTING.sub(" ", line)


# Moses-style punctuation normalization (subset used by NLLB preprocessing)
_PUNCT_MAP = {
    "\u00a0": " ", "\u2018": "'", "\u2019": "'", "\u201a": "'", "\u201b": "'",
    "\u201c": '"', "\u201d": '"', "\u201e": '"', "\u201f": '"',
    "\u2013": "-", "\u2014": "-", "\u2015": "-", "\u2010": "-", "\u2011": "-",
    "\u2026": "...", "\u00ab": '"', "\u00bb": '"', "\u2039": "'", "\u203a": "'",
    "\uff02": '"', "\u3002": ". ", "\uff0c": ", ", "\uff1b": "; ",
    "\uff1a": ": ", "\uff1f": "? ", "\uff01": "! ", "\uff08": " (",
    "\uff09": ") ", "\u3001": ", ",
}
_PUNCT_RE = regex.compile("|".join(regex.escape(k) for k in _PUNCT_MAP))


def replace_unicode_punct(line: str) -> str:
    line = _PUNCT_RE.sub(lambda m: _PUNCT_MAP[m.group(0)], line)
    return " ".join(line.split())
