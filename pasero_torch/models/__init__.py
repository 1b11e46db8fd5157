"""Model families: the Transformer encoder-decoder (decoder-only, hybrid and
MoE variants come with later slices, see ROADMAP.md)."""

from .transformer import (Transformer, TransformerDecoder, TransformerEncoder,
                          positions_from_mask)
