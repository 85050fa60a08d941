"""The LLM xpack's local embedder and tokenizers."""

from pathway_tpu_torch.xpacks.llm._tokenizer import (
    HashTokenizer,
    WordPieceTokenizer,
    pad_to_buckets,
)
from pathway_tpu_torch.xpacks.llm.embedders import (
    EncoderEmbedder,
    SentenceTransformerEmbedder,
)

__all__ = [
    "EncoderEmbedder",
    "HashTokenizer",
    "SentenceTransformerEmbedder",
    "WordPieceTokenizer",
    "pad_to_buckets",
]
