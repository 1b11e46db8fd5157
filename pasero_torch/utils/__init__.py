# Copy of pasero_tpu/utils/__init__.py, verbatim.
"""Host-side utilities (text/file helpers, metrics, benchmark, logging)."""

from .text import find_file, remove_non_printing_char, replace_unicode_punct
