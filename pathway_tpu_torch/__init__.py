"""PyTorch/CUDA port of ``pathway_tpu``'s streaming-RAG device path.

The JAX package ``pathway_tpu`` is the reference; this package imports nothing of it
and no JAX. It holds the embedder (``xpacks.llm.EncoderEmbedder``), the encoder
(``models``), the flash-attention kernel for Hopper (``ops.flash_attention``,
``csrc/flash_attention_fwd.cu``) and the as-of-now KNN index on the card
(``engine.DeviceKnnIndex``). Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

from pathway_tpu_torch.engine import DeviceKnnIndex, HostKnnIndex
from pathway_tpu_torch.models import Encoder, EncoderConfig, embed
from pathway_tpu_torch.ops import knn_search, knn_update
from pathway_tpu_torch.ops.flash_attention import flash_attention
from pathway_tpu_torch.xpacks.llm import EncoderEmbedder, SentenceTransformerEmbedder

__all__ = [
    "DeviceKnnIndex",
    "Encoder",
    "EncoderConfig",
    "EncoderEmbedder",
    "HostKnnIndex",
    "SentenceTransformerEmbedder",
    "embed",
    "flash_attention",
    "knn_search",
    "knn_update",
]
