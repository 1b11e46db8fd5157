# Copy of pasero_tpu/config/archs.py, verbatim.
"""Architecture zoo: named model configurations (pasero/config.py:2182-2615).

Hyper-parameters follow the published architectures (Transformer base/big/wide,
mBART, NLLB, BLOOM, Llama 1/2, Qwen, Yi, Mistral, Mixtral, MPT, Falcon, Whisper,
T5) so that converted checkpoints load without extra flags.
"""

from __future__ import annotations

from typing import Optional

from .models import (AdapterHybridTransformerConfig, AdapterTransformerConfig,
                     HybridTransformerConfig, MOETransformerConfig,
                     TransformerConfig)
from .registry import register_model_config

register_model_config("transformer")(TransformerConfig)


@register_model_config("transformer_big", "transformer_wmt_en_de_big",
                       "transformer_vaswani_wmt_en_de_big")
class TransformerBigConfig(TransformerConfig):
    embed_dim: int = 1024
    encoder_ffn_dim: int = 4096
    decoder_ffn_dim: int = 4096
    encoder_attention_heads: int = 16
    decoder_attention_heads: int = 16


@register_model_config("transformer_wide")
class TransformerWideConfig(TransformerBigConfig):
    encoder_ffn_dim: int = 8192
    decoder_ffn_dim: int = 8192


@register_model_config("transformer_small", "transformer_iwslt_de_en")
class TransformerSmallConfig(TransformerConfig):
    embed_dim: int = 512
    encoder_ffn_dim: int = 1024
    decoder_ffn_dim: int = 1024
    encoder_attention_heads: int = 4
    decoder_attention_heads: int = 4


@register_model_config("adapter_hybrid_transformer_big")
class AdapterHybridTransformerBigConfig(AdapterHybridTransformerConfig):
    embed_dim: int = 1024
    encoder_ffn_dim: int = 4096
    encoder_attention_heads: int = 16
    decoder_hidden_size: int = 1024


@register_model_config("adapter_hybrid_transformer_wide")
class AdapterHybridTransformerWideConfig(AdapterHybridTransformerBigConfig):
    encoder_ffn_dim: int = 8192
    decoder_hidden_size: int = 2048


@register_model_config("mbart_large")
class MBARTConfig(TransformerBigConfig):
    encoder_layers: int = 12
    decoder_layers: int = 12
    encoder_embed_norm: bool = True
    decoder_embed_norm: bool = True
    encoder_positional_encoding: str = "learned"
    decoder_positional_encoding: str = "learned"
    encoder_prenorm: bool = True
    decoder_prenorm: bool = True
    encoder_max_len: int = 1024
    decoder_max_len: int = 1024


@register_model_config("nllb_600m")
class NLLB600MConfig(TransformerBigConfig):
    encoder_layers: int = 12
    decoder_layers: int = 12
    encoder_prenorm: bool = True
    decoder_prenorm: bool = True


@register_model_config("nllb_1b3")
class NLLB1B3Config(NLLB600MConfig):
    encoder_layers: int = 24
    decoder_layers: int = 24
    encoder_ffn_dim: int = 8192
    decoder_ffn_dim: int = 8192


@register_model_config("nllb_3b3")
class NLLB3B3Config(NLLB1B3Config):
    embed_dim: int = 2048


@register_model_config("bloom_560m")
class Bloom560MConfig(TransformerConfig):
    decoder_layers: int = 24
    decoder_max_len: int = 2048
    model_type: str = "decoder"
    decoder_positional_encoding: str = "alibi"
    decoder_prenorm: bool = True
    embed_dim: int = 1024
    decoder_ffn_dim: int = 4096
    decoder_attention_heads: int = 16
    scale_embed: bool = False
    decoder_embed_norm: bool = True
    activation_fn: str = "gelu_tanh"
    bos_idx: int = -1


@register_model_config("bloom_1b1")
class Bloom1B1Config(Bloom560MConfig):
    embed_dim: int = 1536
    decoder_ffn_dim: int = 6144


@register_model_config("bloom_1b7")
class Bloom1B7Config(Bloom560MConfig):
    embed_dim: int = 2048
    decoder_ffn_dim: int = 8192


@register_model_config("bloom_3b")
class Bloom3BConfig(Bloom560MConfig):
    decoder_layers: int = 30
    embed_dim: int = 2560
    decoder_ffn_dim: int = 10240
    decoder_attention_heads: int = 32


@register_model_config("bloom_7b")
class Bloom7BConfig(Bloom560MConfig):
    decoder_layers: int = 30
    embed_dim: int = 4096
    decoder_ffn_dim: int = 16384
    decoder_attention_heads: int = 32


@register_model_config("llama_7b")
class Llama7BConfig(TransformerConfig):
    decoder_layers: int = 32
    decoder_max_len: int = 4096
    model_type: str = "decoder"
    decoder_positional_encoding: str = "rotary"
    decoder_prenorm: bool = True
    tied_output_projection: bool = False
    embed_dim: int = 4096
    decoder_ffn_dim: int = 11008
    decoder_attention_heads: int = 32
    scale_embed: bool = False
    activation_fn: str = "swiglu"
    rms_norm: bool = True
    has_bias: bool = False
    padding_idx: int = 0
    bos_idx: int = 1
    eos_idx: int = 2
    unk_idx: int = 0


@register_model_config("llama_13b")
class Llama13BConfig(Llama7BConfig):
    decoder_layers: int = 40
    embed_dim: int = 5120
    decoder_ffn_dim: int = 13824
    decoder_attention_heads: int = 40


@register_model_config("qwen_14b")
class Qwen14BConfig(Llama13BConfig):
    decoder_ffn_dim: int = 13696
    decoder_max_len: int = 8192
    norm_eps: float = 1e-06


@register_model_config("llama_34b")
class Llama34BConfig(Llama7BConfig):
    decoder_layers: int = 48
    embed_dim: int = 8192
    decoder_ffn_dim: int = 22016
    decoder_attention_heads: int = 64
    attention_heads_kv: int = 8


@register_model_config("yi_34b")
class Yi34BConfig(Llama7BConfig):
    decoder_layers: int = 60
    embed_dim: int = 7168
    decoder_ffn_dim: int = 20480
    decoder_attention_heads: int = 56
    attention_heads_kv: int = 8
    decoder_max_len: int = 4096
    rope_base: int = 5000000


@register_model_config("yi_34b_200k")
class Yi34B200KConfig(Yi34BConfig):
    decoder_max_len: int = 200000


@register_model_config("llama_70b")
class Llama70BConfig(Llama7BConfig):
    decoder_layers: int = 80
    embed_dim: int = 8192
    decoder_ffn_dim: int = 28672
    decoder_attention_heads: int = 64
    attention_heads_kv: int = 8


@register_model_config("llama_30b")
class Llama30BConfig(Llama7BConfig):
    decoder_layers: int = 60
    embed_dim: int = 6656
    decoder_ffn_dim: int = 17920
    decoder_attention_heads: int = 52
    norm_eps: float = 1e-06
    decoder_max_len: int = 2048


@register_model_config("llama_65b")
class Llama65BConfig(Llama7BConfig):
    decoder_layers: int = 80
    embed_dim: int = 8192
    decoder_ffn_dim: int = 22016
    decoder_attention_heads: int = 64
    decoder_max_len: int = 2048


@register_model_config("llama_3b")
class Llama3BConfig(Llama7BConfig):
    decoder_layers: int = 26
    embed_dim: int = 3200
    decoder_ffn_dim: int = 8640
    decoder_attention_heads: int = 32
    decoder_max_len: int = 2048
    norm_eps: float = 1e-06


@register_model_config("llama_1b")
class Llama1BConfig(Llama7BConfig):
    decoder_layers: int = 22
    embed_dim: int = 2048
    decoder_ffn_dim: int = 5632
    decoder_attention_heads: int = 32
    decoder_max_len: int = 2048
    norm_eps: float = 1e-05
    attention_heads_kv: int = 4


@register_model_config("mistral_7b")
class Mistral7BConfig(Llama7BConfig):
    attention_heads_kv: int = 8
    decoder_ffn_dim: int = 14336
    sliding_window: int = 4096
    decoder_max_len: int = 32768


@register_model_config("mixtral_7b")
class Mixtral7BConfig(MOETransformerConfig, Mistral7BConfig):
    decoder_expert_count: int = 8
    rope_base: int = 1000000
    moe_impl: str = "fused"
    sliding_window: Optional[int] = None


@register_model_config("mpt_7b")
class MPT7BConfig(TransformerConfig):
    decoder_layers: int = 32
    decoder_max_len: int = 2048
    model_type: str = "decoder"
    decoder_positional_encoding: str = "alibi"
    decoder_prenorm: bool = True
    embed_dim: int = 4096
    decoder_ffn_dim: int = 16384
    decoder_attention_heads: int = 32
    scale_embed: bool = False
    activation_fn: str = "gelu"
    has_bias: bool = False
    norm_bias: bool = False
    bos_idx: int = 0
    eos_idx: int = 0
    padding_idx: int = 1
    unk_idx: int = 1


@register_model_config("mpt_7b_65k")
class MPT7B65kConfig(MPT7BConfig):
    alibi_max_bias: int = 16
    max_qkv: float = 6.0
    decoder_max_len: int = 65536


@register_model_config("mpt_30b")
class MPT30BConfig(MPT7BConfig):
    decoder_layers: int = 48
    decoder_max_len: int = 8192
    embed_dim: int = 7168
    decoder_ffn_dim: int = 28672
    decoder_attention_heads: int = 64


@register_model_config("falcon_7b")
class Falcon7BConfig(TransformerConfig):
    decoder_layers: int = 32
    decoder_max_len: int = 2048
    model_type: str = "decoder"
    decoder_positional_encoding: str = "rotary"
    decoder_prenorm: bool = True
    embed_dim: int = 4544
    decoder_ffn_dim: int = 18176
    decoder_attention_heads: int = 71
    attention_heads_kv: int = 1
    scale_embed: bool = False
    activation_fn: str = "gelu"
    has_bias: bool = False
    shared_norm: bool = True
    parallel_attention: bool = True
    bos_idx: int = 11
    eos_idx: int = 11
    padding_idx: int = 9
    unk_idx: int = 9


@register_model_config("falcon_40b")
class Falcon40BConfig(Falcon7BConfig):
    decoder_layers: int = 60
    embed_dim: int = 8192
    decoder_ffn_dim: int = 32768
    decoder_attention_heads: int = 128
    attention_heads_kv: int = 8
    shared_norm: bool = False


@register_model_config("adapter_transformer_big")
class AdapterTransformerBigConfig(AdapterTransformerConfig, TransformerBigConfig):
    pass


@register_model_config("adapter_transformer_small")
class AdapterTransformerSmallConfig(AdapterTransformerConfig, TransformerSmallConfig):
    pass


@register_model_config("adapter_transformer_wide")
class AdapterTransformerWideConfig(AdapterTransformerConfig, TransformerWideConfig):
    pass


@register_model_config("hybrid_transformer_big", "rnmt_big")
class HybridTransformerBigConfig(HybridTransformerConfig):
    embed_dim: int = 1024
    encoder_ffn_dim: int = 4096
    encoder_attention_heads: int = 16
    decoder_hidden_size: int = 1024


@register_model_config("hybrid_transformer_wide")
class HybridTransformerWideConfig(HybridTransformerBigConfig):
    encoder_ffn_dim: int = 8192
    decoder_hidden_size: int = 2048


@register_model_config("hybrid_transformer_small")
class HybridTransformerSmallConfig(HybridTransformerConfig):
    embed_dim: int = 512
    encoder_ffn_dim: int = 1024
    decoder_ffn_dim: int = 1024
    encoder_attention_heads: int = 4
    decoder_attention_heads: int = 4
    decoder_hidden_size: int = 512


@register_model_config("adapter_nllb_600m")
class AdapterNLLB600MConfig(AdapterTransformerConfig, NLLB600MConfig):
    pass


@register_model_config("adapter_nllb_1b3")
class AdapterNLLB1B3Config(AdapterTransformerConfig, NLLB1B3Config):
    pass


@register_model_config("adapter_nllb_3b3")
class AdapterNLLB3B3Config(AdapterTransformerConfig, NLLB3B3Config):
    pass


@register_model_config("adapter_mbart_large")
class AdapterMBARTConfig(AdapterTransformerConfig, MBARTConfig):
    pass


@register_model_config("moe_transformer_small")
class MOETransformerSmallConfig(MOETransformerConfig, TransformerSmallConfig):
    pass


@register_model_config("moe_transformer_big")
class MOETransformerBigConfig(MOETransformerConfig, TransformerBigConfig):
    pass


@register_model_config("moe_transformer_wide")
class MOETransformerWideConfig(MOETransformerConfig, TransformerWideConfig):
    pass


@register_model_config("adapter_bloom_1b7")
class AdapterBloom1B7Config(AdapterTransformerConfig, Bloom1B7Config):
    pass


@register_model_config("adapter_bloom_7b")
class AdapterBloom7BConfig(AdapterTransformerConfig, Bloom7BConfig):
    pass


@register_model_config("adapter_llama_7b")
class AdapterLlama7BConfig(AdapterTransformerConfig, Llama7BConfig):
    pass


@register_model_config("adapter_llama_13b")
class AdapterLlama13BConfig(AdapterTransformerConfig, Llama13BConfig):
    pass


@register_model_config("whisper_base")
class WhisperConfig(TransformerConfig):
    encoder_layers: int = 6
    decoder_layers: int = 6
    embed_dim: int = 512
    encoder_ffn_dim: int = 2048
    decoder_ffn_dim: int = 2048
    encoder_attention_heads: int = 8
    decoder_attention_heads: int = 8
    encoder_prenorm: bool = True
    decoder_prenorm: bool = True
    activation_fn: str = "gelu"
    encoder_positional_encoding: str = "learned"
    decoder_positional_encoding: str = "learned"
    positional_encoding_shift: int = 0
    scale_embed: bool = False
    input_dim: int = 80
    conv_input_dim: int = 80
    conv_channels: int = 512
    conv_kernel_sizes: list[int] = [3, 3]
    conv_strides: list[int] = [1, 2]
    conv_activation: str = "gelu"
    encoder_max_len: int = 3000
    decoder_max_len: int = 448
    attention_key_bias: bool = False
    padding_idx: int = 50256
    eos_idx: int = 50257
    bos_idx: int = 50258


@register_model_config("whisper_large")
class WhisperLargeConfig(WhisperConfig):
    encoder_layers: int = 32
    decoder_layers: int = 32
    embed_dim: int = 1280
    conv_channels: int = 1280
    encoder_ffn_dim: int = 5120
    decoder_ffn_dim: int = 5120
    encoder_attention_heads: int = 20
    decoder_attention_heads: int = 20


@register_model_config("t5_base")
class T5BaseConfig(TransformerConfig):
    encoder_layers: int = 12
    decoder_layers: int = 12
    encoder_max_len: int = 512
    decoder_max_len: int = 512
    encoder_prenorm: bool = True
    decoder_prenorm: bool = True
    tied_output_projection: bool = False
    embed_dim: int = 768
    encoder_ffn_dim: int = 2048
    decoder_ffn_dim: int = 2048
    encoder_attention_heads: int = 12
    decoder_attention_heads: int = 12
    encoder_positional_encoding: str = "t5"
    decoder_positional_encoding: str = "t5"
    activation_fn: str = "geglu"
    rms_norm: bool = True
    has_bias: bool = False
    norm_eps: float = 1e-06
    scale_embed: bool = False
    scale_attn: bool = False
    check_inf: bool = True
    bos_idx: int = -1
    eos_idx: int = 1
    padding_idx: int = 0
    unk_idx: int = 0


@register_model_config("t5_large")
class T5LargeConfig(T5BaseConfig):
    encoder_layers: int = 24
    decoder_layers: int = 24
    embed_dim: int = 1024
    encoder_ffn_dim: int = 2816
    decoder_ffn_dim: int = 2816
    encoder_attention_heads: int = 16
    decoder_attention_heads: int = 16
