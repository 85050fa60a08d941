"""PyTorch/CUDA port of ``pathway_tpu``: the streaming-RAG pipeline through its own
engine, and its embedder's contrastive trainer.

The JAX package ``pathway_tpu`` is the reference; this package imports nothing of it
and no JAX. It holds the engine (``pw.run``, ``pw.io.python``, ``pw.io.subscribe``,
``pw.debug``'s static tables, tables with ``select``, ``filter``, ``groupby`` /
``reduce`` with ``pw.reducers``, the joins with ``pw.left`` / ``pw.right``, ``concat``,
``flatten``, ``ix`` and the other relational operations, the groupby's reductions and
the join's pair matcher on the card, UDFs with a batch executor, lazy device rows,
``stdlib.indexing.DataIndex`` over the as-of-now KNN index on the card), the embedder
UDF (``xpacks.llm.EncoderEmbedder``), the encoder and its train step (``models``,
``models.make_train_step``), and the flash-attention kernels for Hopper
(``ops.flash_attention``: the forward in ``csrc/flash_attention_fwd.cu``, the backward
in ``csrc/flash_attention_bwd.cu``) and the ordered segment sum under the groupby
(``ops.segment_reduce``, ``csrc/segment_reduce.cu``). Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

from pathway_tpu_torch import io
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.engine import DeviceKnnIndex, HostKnnIndex
from pathway_tpu_torch.engine.value import ERROR, Pointer, ref_scalar
from pathway_tpu_torch.internals.errors import global_error_log, local_error_log
from pathway_tpu_torch.internals.expression import apply, make_tuple
from pathway_tpu_torch.internals.parse_graph import run
from pathway_tpu_torch.internals.schema import Schema, column_definition, schema_from_types
from pathway_tpu_torch.internals.table import JoinMode, Table
from pathway_tpu_torch.internals.thisclass import left, right, this
from pathway_tpu_torch.internals.udfs import UDF, udf
from pathway_tpu_torch.models import Encoder, EncoderConfig, embed
from pathway_tpu_torch.ops import knn_search, knn_update
from pathway_tpu_torch.ops.flash_attention import flash_attention
from pathway_tpu_torch.xpacks.llm import EncoderEmbedder, SentenceTransformerEmbedder

from pathway_tpu_torch import debug  # noqa: E402  (imports Table)

__all__ = [
    "DeviceKnnIndex",
    "ERROR",
    "Encoder",
    "EncoderConfig",
    "EncoderEmbedder",
    "HostKnnIndex",
    "JoinMode",
    "Pointer",
    "Schema",
    "SentenceTransformerEmbedder",
    "Table",
    "UDF",
    "apply",
    "column_definition",
    "debug",
    "embed",
    "flash_attention",
    "global_error_log",
    "io",
    "knn_search",
    "knn_update",
    "left",
    "local_error_log",
    "make_tuple",
    "reducers",
    "ref_scalar",
    "right",
    "run",
    "schema_from_types",
    "this",
    "udf",
]
