"""The BERT-family encoder (MiniLM/BGE configs) and its checkpoint import."""

from pathway_tpu_torch.models.hf_import import (
    import_hf_encoder,
    load_sentence_transformer,
)
from pathway_tpu_torch.models.transformer import (
    Encoder,
    EncoderConfig,
    bge_base,
    bge_small,
    default_attn_fn,
    dense_attention,
    embed,
    encoder_forward,
    minilm_l6,
    params_from_jax,
    pool,
)

__all__ = [
    "Encoder",
    "EncoderConfig",
    "bge_base",
    "bge_small",
    "default_attn_fn",
    "dense_attention",
    "embed",
    "encoder_forward",
    "import_hf_encoder",
    "load_sentence_transformer",
    "minilm_l6",
    "params_from_jax",
    "pool",
]
