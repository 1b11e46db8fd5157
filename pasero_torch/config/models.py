# Copy of pasero_tpu/config/models.py, verbatim.
"""Model hyper-parameter configs: Transformer family + adapter/hybrid/MoE variants.

Field surface mirrors the reference (pasero/config.py:1055-1468). TPU-specific
notes: dtype handling is bf16-first, ``checkpoint_activations`` maps to
``jax.checkpoint`` rematerialisation, and sharding is controlled by the mesh
(config.common.DistributedConfig) rather than per-parameter regexes.
"""

from __future__ import annotations

import json
from typing import Optional, Union

from .core import Config, argument
from .registry import register_model_config


class TransformerConfig(Config):
    encoder_layers: int = argument(6, help="number of encoder layers")
    decoder_layers: int = argument(6, help="number of decoder layers")
    shared_embeddings: bool = argument(True, help="share encoder and decoder embeddings")
    conv_kernel_sizes: Optional[list[int]] = argument(
        nargs="*", help="1-D conv subsampler kernel sizes (speech frontend)")
    conv_strides: Optional[list[int]] = argument(
        nargs="*", help="1-D conv subsampler strides (default 2 each)")
    conv_activation: Optional[str] = argument(
        "glu", choices=["glu", "gelu"], help="activation after each conv layer")
    input_dim: Optional[int] = argument(help="dimension of continuous (feature) inputs")
    conv_input_dim: Optional[int] = argument(
        help="conv input dim; if != input_dim a ReLU projection is inserted")
    conv_channels: Optional[int] = argument(help="conv inner channels (default conv_input_dim)")
    embed_dim: int = argument(512, help="model/embedding dimension")
    encoder_ffn_dim: int = argument(2048, help="encoder FFN inner dimension")
    decoder_ffn_dim: int = argument(2048, help="decoder FFN inner dimension")
    encoder_attention_heads: int = argument(8, help="encoder attention heads")
    decoder_attention_heads: int = argument(8, help="decoder attention heads")
    attention_heads_kv: Optional[int] = argument(
        help="KV head count for GQA (1 = multi-query attention)")
    sliding_window: Optional[int] = argument(help="sliding-window self-attention size")
    scale_attn: bool = argument(True, help="scale QK^T by 1/sqrt(head_dim)")
    check_inf: bool = argument(
        False, help="clamp non-finite block outputs (T5 half-precision trick)")
    attention_key_bias: bool = argument(True, help="bias on attention key projection")
    attention_kernel: str = argument(
        "auto", choices=["auto", "xla", "flash", "ring"],
        help="attention implementation: 'auto' (default, mirrors the "
             "reference's flash-attn auto-selection, modules.py:689-705) "
             "uses fused XLA softmax for short sequences and the Pallas "
             "flash kernel when the score matrix would be memory-bound "
             "(>= 4096^2); 'ring' runs attention over the 'seq' mesh axis "
             "for context parallelism (--cp-size)")
    dropout: float = argument(0.1, help="residual dropout")
    decoder_dropout: Optional[float] = argument(help="decoder dropout (default: dropout)")
    attention_dropout: float = argument(0.0, help="attention-weight dropout")
    activation_dropout: float = argument(0.0, help="FFN inner dropout")
    label_smoothing: Optional[float] = argument(
        defaults={"language_modeling": 0.0, "dialogue": 0.0, "default": 0.1},
        help="label smoothing mass")
    tied_output_projection: bool = argument(
        True, help="tie decoder embedding and output projection")
    fused_ce: bool = argument(
        True, help="compute the training loss without materializing the "
                   "fp32 (B, T, V) logits tensor in HBM (ops/fused_ce.py "
                   "flash kernel on TPU, chunked_cross_entropy elsewhere). "
                   "Disable to force the full-logits loss path")
    ce_impl: str = argument(
        "auto", choices=["auto", "flash", "chunked"],
        help="--fused-ce implementation: 'flash' = Pallas online-logsumexp "
             "kernel (logits tiles live only in VMEM, fused backward), "
             "'chunked' = lax.scan over sequence chunks, 'auto' = flash on "
             "TPU, chunked elsewhere")
    ce_chunks: int = argument(
        8, help="sequence chunks for --ce-impl chunked (more chunks = less "
                "live logits memory, slightly more scan overhead)")
    activation_fn: str = argument(
        "relu", choices=["relu", "gelu", "gelu_tanh", "swiglu", "geglu"],
        help="FFN activation")
    has_bias: bool = argument(True, help="linear layers have bias (Llama: False)")
    encoder_prenorm: bool = argument(False, help="pre-norm encoder blocks")
    decoder_prenorm: Optional[bool] = argument(False, help="pre-norm decoder blocks")
    encoder_embed_norm: bool = argument(False, help="layer-norm after encoder embeddings")
    decoder_embed_norm: bool = argument(False, help="layer-norm after decoder embeddings")
    rms_norm: bool = argument(False, help="RMSNorm instead of LayerNorm")
    norm_eps: float = argument(1e-5, help="normalization epsilon")
    norm_bias: bool = argument(True, help="layer-norm bias")
    shared_norm: bool = argument(
        False, help="share one norm between attention and FFN blocks (Falcon-7B)")
    parallel_attention: bool = argument(
        False, help="attention and FFN computed in parallel from the same input")
    encoder_positional_encoding: str = argument(
        "sinusoidal", choices=["learned", "sinusoidal", "alibi", "rotary", "t5", "none"],
        help="encoder positional encoding")
    decoder_positional_encoding: str = argument(
        "sinusoidal", choices=["learned", "sinusoidal", "alibi", "rotary", "t5", "none"],
        help="decoder positional encoding")
    alibi_max_bias: int = argument(8, help="maximum ALiBi bias")
    rope_base: int = argument(10000, help="RoPE base frequency")
    max_qkv: Optional[float] = argument(help="clamp queries/keys/values to this value")
    positional_encoding_shift: int = argument(
        2, help="shift positions by this offset (fairseq compat)")
    shift_encoder_layers: Optional[int] = argument(
        help="shift checkpoint encoder layers up by N on load (new bottom layers random)")
    shift_decoder_layers: Optional[int] = argument(help="same for decoder layers")
    checkpoint_activations: bool = argument(
        False, help="rematerialize layer activations in the backward pass (jax.checkpoint)")
    checkpoint_policy: str = argument(
        "dots", choices=["full", "dots", "dots_all"],
        help="--checkpoint-activations rematerialization policy: 'full' "
             "recomputes the whole layer in backward (cheapest memory, one "
             "extra forward), 'dots' (default) saves weight-matmul outputs "
             "(jax dots_with_no_batch_dims_saveable: q/k/v/out projections "
             "and FFN matmuls kept, elementwise + attention recomputed — "
             "measurably faster at 1B scale), 'dots_all' additionally saves "
             "the attention QK/PV products (most memory)")
    checkpoint_interval: int = argument(
        1, help="with --checkpoint-activations, rematerialize every Nth "
                "layer only (the rest save all activations): N=2 halves the "
                "recompute cost of full remat for half its memory saving — "
                "the knob that fits the largest no-remat-affordable batch "
                "(PERFORMANCE.md 1B remat-policy A/B)")
    model_type: Optional[str] = argument(
        choices=["encoder_decoder", "decoder"],
        defaults={"language_modeling": "decoder", "dialogue": "decoder",
                  "default": "encoder_decoder"},
        help="encoder-decoder (T5-style) or decoder-only (GPT-style)")
    prompt_loss: float = argument(
        1.0, help="loss multiplier for prompt tokens (0 disables prompt loss)")
    scale_embed: bool = argument(True, help="scale embeddings by sqrt(dim)")
    embed_dropout: Optional[float] = argument(help="embedding dropout (default: dropout)")
    encoder_max_len: int = argument(256, help="maximum encoder positions")
    decoder_max_len: Optional[int] = argument(
        defaults={"language_modeling": 1024, "dialogue": 1024, "default": 256},
        help="maximum decoder positions")
    lora_rank: int = argument(0, help="train LoRA adapters with this rank (rest frozen)")
    lora_alpha: int = argument(8, help="LoRA scaling numerator")
    padding_idx: int = argument(1, help="padding token id")
    bos_idx: int = argument(2, help="first decoder input token id (-1 disables)")
    eos_idx: int = argument(2, help="end-of-sequence token id")
    unk_idx: int = argument(3, help="unknown token id")

    # -- derived helpers ---------------------------------------------------
    @property
    def kv_heads(self) -> int:
        return self.attention_heads_kv or self.decoder_attention_heads

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.decoder_attention_heads

    def setup_for_inference(self, cfg) -> None:
        """Apply decoding-time overrides (pasero/config.py:1301-1319)."""
        model_args = getattr(cfg, "model_args", None)
        if model_args:
            if isinstance(model_args, str):
                model_args = json.loads(model_args)
            for name, value in model_args.items():
                setattr(self, name, value)
        self.shift_encoder_layers = None
        self.shift_decoder_layers = None
        self.lora_rank = 0  # LoRA weights are merged into dense weights on load
        self.set_defaults(cfg.task)
        if self.decoder_max_len < cfg.max_output_len:
            raise ValueError("--max-output-len exceeds the model's decoder_max_len")


@register_model_config("adapter_transformer")
class AdapterTransformerConfig(TransformerConfig):
    encoder_adapter_dim: int = argument(64, help="encoder adapter bottleneck dim")
    decoder_adapter_dim: int = argument(64, help="decoder adapter bottleneck dim")
    encoder_adapter_layer_ids: Optional[list[int]] = argument(
        help="encoder layers with adapters (default: all)")
    decoder_adapter_layer_ids: Optional[list[int]] = argument(
        help="decoder layers with adapters (default: all)")
    encoder_adapters: Optional[list[str]] = argument(
        help="encoder adapter names (several = stacked; empty = disabled)")
    decoder_adapters: Optional[list[str]] = argument(
        help="decoder adapter names (several = stacked; empty = disabled)")
    encoder_adapters_by: list[str] = argument(
        [], choices=["lang", "source_lang", "target_lang", "domain"],
        help="per-metadata encoder adapters (adds the key to --batch-by)")
    decoder_adapters_by: list[str] = argument(
        [], choices=["lang", "source_lang", "target_lang", "domain"],
        help="per-metadata decoder adapters (adds the key to --batch-by)")
    adapter_zero_init: bool = argument(
        False, help="zero-init adapters (exact identity; useful at inference)")
    train_all_params: bool = argument(
        False, help="train every parameter, not just adapters")

    def setup_for_inference(self, cfg) -> None:
        self.encoder_adapter_layer_ids = None
        self.decoder_adapter_layer_ids = None
        super().setup_for_inference(cfg)
        enc = getattr(cfg, "encoder_adapters", None)
        dec = getattr(cfg, "decoder_adapters", None)
        self.encoder_adapters = enc if enc is not None else self.encoder_adapters
        self.decoder_adapters = dec if dec is not None else self.decoder_adapters
        if enc is not None:
            self.encoder_adapters_by = []
        if dec is not None:
            self.decoder_adapters_by = []
        self.adapter_zero_init = True


@register_model_config("hybrid_transformer")
class HybridTransformerConfig(TransformerConfig):
    decoder_layers: int = 2
    decoder_hidden_size: int = argument(512, help="LSTM hidden size")
    decoder_embed_proj: bool = argument(
        False, help="project decoder input embeddings before the first LSTM")


@register_model_config("adapter_hybrid_transformer")
class AdapterHybridTransformerConfig(AdapterTransformerConfig):
    decoder_layers: int = 2
    decoder_hidden_size: int = argument(512, help="LSTM hidden size")
    decoder_embed_proj: bool = argument(
        False, help="project decoder input embeddings before the first LSTM")


@register_model_config("moe_transformer")
class MOETransformerConfig(TransformerConfig):
    encoder_expert_count: Union[int, dict] = argument(
        4, help="experts per encoder MoE layer (or {layer_id: count} dict)")
    decoder_expert_count: Union[int, dict] = argument(
        4, help="experts per decoder MoE layer (or {layer_id: count} dict)")
    encoder_expert_dim: Optional[int] = argument(
        help="encoder expert FFN dim (default encoder_ffn_dim)")
    decoder_expert_dim: Optional[int] = argument(
        help="decoder expert FFN dim (default decoder_ffn_dim)")
    encoder_expert_layer_ids: Optional[list[int]] = argument(
        help="encoder layers with experts (zero-indexed)")
    decoder_expert_layer_ids: Optional[list[int]] = argument(
        help="decoder layers with experts (zero-indexed)")
    encoder_expert_interval: int = argument(1, help="experts at every Nth encoder layer")
    decoder_expert_interval: int = argument(1, help="experts at every Nth decoder layer")
    moe_impl: str = argument(
        "fused", choices=["basic", "fused", "tutel", "sharded"],
        help="MoE dispatch implementation; 'sharded' (accepts alias 'tutel') uses "
             "expert parallelism with all-to-all over the expert mesh axis")
    moe_dispatch: str = argument(
        "auto", choices=["auto", "gather", "einsum"],
        help="token dispatch: 'gather' = scatter/gather reshuffle (O(T*D), "
             "the single-chip winner), 'einsum' = one-hot contractions that "
             "lower to the EP all-to-all under GSPMD, 'auto' = gather for "
             "single-chip impls, einsum for sharded")
    capacity_factor: float = argument(
        0.0, help="per-expert capacity = 2*factor*tokens/experts; 0 = derived from "
                  "top-2 worst case (TPU needs a static capacity)")
    load_balancing: float = argument(0.0, help="load-balancing loss scale")
