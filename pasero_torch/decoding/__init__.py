"""Decoding engine: search algorithms + the TextGenerator API."""

from .search import beam_search, left_align, sample_decode
