"""Model families: the Transformer, encoder-decoder or decoder-only (the
hybrid and MoE variants come with later slices, see ROADMAP.md)."""

from .transformer import (Transformer, TransformerDecoder, TransformerEncoder,
                          positions_from_mask)
