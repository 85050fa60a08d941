"""The BERT-family encoder (MiniLM/BGE configs), its checkpoint import, and its
contrastive train step."""

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
from pathway_tpu_torch.models.train import (
    ContrastiveBatch,
    TrainState,
    adamw,
    info_nce_loss,
    make_train_step,
)

__all__ = [
    "ContrastiveBatch",
    "Encoder",
    "EncoderConfig",
    "TrainState",
    "adamw",
    "bge_base",
    "bge_small",
    "default_attn_fn",
    "dense_attention",
    "embed",
    "encoder_forward",
    "import_hf_encoder",
    "info_nce_loss",
    "load_sentence_transformer",
    "make_train_step",
    "minilm_l6",
    "params_from_jax",
    "pool",
]
