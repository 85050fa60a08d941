"""The LLM xpack's local models on the card: the sentence and image embedders, the
rerankers, the decoder chat, and the tokenizers."""

from pathway_tpu_torch.xpacks.llm._tokenizer import (
    HashTokenizer,
    WordPieceTokenizer,
    pad_to_buckets,
)
from pathway_tpu_torch.xpacks.llm.embedders import (
    EncoderEmbedder,
    ImageEmbedder,
    SentenceTransformerEmbedder,
)
from pathway_tpu_torch.xpacks.llm.llms import (
    CohereChat,
    HFPipelineChat,
    LiteLLMChat,
    OpenAIChat,
    PipelineChat,
    prompt_chat_single_qa,
)
from pathway_tpu_torch.xpacks.llm.rerankers import (
    CrossEncoderReranker,
    EncoderReranker,
    LLMReranker,
    rerank_topk_filter,
)

__all__ = [
    "CohereChat",
    "CrossEncoderReranker",
    "EncoderEmbedder",
    "EncoderReranker",
    "HFPipelineChat",
    "HashTokenizer",
    "ImageEmbedder",
    "LLMReranker",
    "LiteLLMChat",
    "OpenAIChat",
    "PipelineChat",
    "SentenceTransformerEmbedder",
    "WordPieceTokenizer",
    "pad_to_buckets",
    "prompt_chat_single_qa",
    "rerank_topk_filter",
]
