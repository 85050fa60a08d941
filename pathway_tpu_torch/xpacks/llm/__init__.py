"""The LLM xpack: the local models on the card (the sentence and image embedders, the
rerankers, the decoder chat), the remote chats over an injected client, the
tokenizers, and the RAG document pipeline (parsers, splitters, ``DocumentStore``,
``VectorStoreServer``, the question answerers) and its evaluation harness
(``rag_evals``), and the REST servers (``servers``: ``DocumentStoreServer``, the
question answerers' ``QARestServer``), which ``VectorStoreServer.run_server`` runs."""

from pathway_tpu_torch.xpacks.llm import (
    embedders,
    llms,
    mocks,
    parsers,
    prompts,
    rag_evals,
    rerankers,
    splitters,
)
from pathway_tpu_torch.xpacks.llm._tokenizer import (
    HashTokenizer,
    WordPieceTokenizer,
    pad_to_buckets,
)
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
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
from pathway_tpu_torch.xpacks.llm.question_answering import (
    AdaptiveRAGQuestionAnswerer,
    BaseRAGQuestionAnswerer,
    RAGClient,
    answer_with_geometric_rag_strategy,
)
from pathway_tpu_torch.xpacks.llm.rag_evals import (
    RagEvalReport,
    RagEvalSample,
    RagEvaluator,
    load_dataset,
    run_experiment,
)
from pathway_tpu_torch.xpacks.llm.rerankers import (
    CrossEncoderReranker,
    EncoderReranker,
    LLMReranker,
    rerank_topk_filter,
)
from pathway_tpu_torch.xpacks.llm.vector_store import (
    VectorStoreClient,
    VectorStoreServer,
)

__all__ = [
    "AdaptiveRAGQuestionAnswerer",
    "BaseRAGQuestionAnswerer",
    "CohereChat",
    "CrossEncoderReranker",
    "DocumentStore",
    "EncoderEmbedder",
    "EncoderReranker",
    "HFPipelineChat",
    "HashTokenizer",
    "ImageEmbedder",
    "LLMReranker",
    "LiteLLMChat",
    "OpenAIChat",
    "PipelineChat",
    "RAGClient",
    "RagEvalReport",
    "RagEvalSample",
    "RagEvaluator",
    "SentenceTransformerEmbedder",
    "VectorStoreClient",
    "VectorStoreServer",
    "WordPieceTokenizer",
    "answer_with_geometric_rag_strategy",
    "embedders",
    "llms",
    "load_dataset",
    "mocks",
    "pad_to_buckets",
    "parsers",
    "prompt_chat_single_qa",
    "prompts",
    "rag_evals",
    "rerank_topk_filter",
    "rerankers",
    "run_experiment",
    "splitters",
]
