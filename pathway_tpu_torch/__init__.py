"""PyTorch/CUDA port of ``pathway_tpu``: the streaming-RAG pipeline through its own
engine, and its embedder's contrastive trainer.

The JAX package ``pathway_tpu`` is the reference; this package imports nothing of it
and no JAX. It holds the engine (``pw.run``, ``pw.io.python``, ``pw.io.subscribe``,
``pw.debug``'s static tables, the file connectors (``pw.io.fs``, ``csv``,
``jsonlines``, ``plaintext``, ``null``), persistence (``pw.persistence``: input
journals, operator snapshots, UDF caching), tables with ``select``, ``filter``, ``groupby`` /
``reduce`` with ``pw.reducers``, the joins with ``pw.left`` / ``pw.right``, ``concat``,
``flatten``, ``ix``, ``deduplicate``, ``sort``, ``having`` and the other relational
operations, the temporal operators (``pw.temporal``: windows, behaviors, the interval,
asof, asof-now and window joins), ``pw.iterate`` (with ``stdlib.graphs``' PageRank and
Bellman-Ford), ``pw.debug.StreamGenerator``, the expression namespaces ``.str`` / ``.dt`` / ``.num``, the groupby's
reductions and the join's pair matcher on the card, UDFs with a batch executor and
``pw.apply_async``, lazy device rows, ``stdlib.indexing.DataIndex`` over the as-of-now
KNN index on the card), the embedder UDF (``xpacks.llm.EncoderEmbedder``) and the rest
of the LLM xpack (the image embedder, rerankers, chats, the RAG document pipeline:
``DocumentStore``, ``VectorStoreServer``, parsers, splitters, the RAG answerers, and
the ``rag_evals`` harness; UDFs may be async, cached and retried), the encoder and its
train step (``models``, ``models.make_train_step``), and the flash-attention kernels for
Hopper (``ops.flash_attention``: the forward in ``csrc/flash_attention_fwd.cu``, the
backward in ``csrc/flash_attention_bwd.cu``) and the ordered segment sum under the
groupby (``ops.segment_reduce``, ``csrc/segment_reduce.cu``), and the observability
planes: metrics, traces and profiles, the monitoring dashboard and HTTP endpoint
(``pw.MonitoringLevel``, ``pw.run(with_http_server=True)``), the metrics history and
its SLOs, OpenTelemetry spans (``pw.set_monitoring_config``) and the lock-order
watcher, and the connectors of ``pw.io`` (with the licensed SharePoint source in
``xpacks.connectors``, gated by ``pw.set_license_key``). Entry points run on CUDA unless
the caller passes ``device="cpu"``. The reference's names that are not ported yet raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from pathway_tpu_torch.internals import lockwatch as _lockwatch

# PATHWAY_TPU_LOCKWATCH=1: wrap Lock/RLock creation BEFORE the modules below (and torch,
# which they import) make theirs, so the order recorder sees them all
_lockwatch.maybe_install()

from pathway_tpu_torch import io, persistence  # noqa: E402
from pathway_tpu_torch.internals import reducers  # noqa: E402
from pathway_tpu_torch.engine import DeviceKnnIndex, HostKnnIndex  # noqa: E402
from pathway_tpu_torch.engine.value import (  # noqa: E402
    ERROR,
    DateTimeNaive,
    DateTimeUtc,
    Duration,
    Json,
    Pointer,
    PyObjectWrapper,
    ref_scalar,
    unsafe_make_pointer,
)
from pathway_tpu_torch.internals import universe as _universe_mod  # noqa: E402
from pathway_tpu_torch.internals.errors import global_error_log, local_error_log  # noqa: E402
from pathway_tpu_torch.internals.expression import (  # noqa: E402
    ColumnExpression,
    ColumnReference,
    apply,
    apply_async,
    apply_with_type,
    cast,
    coalesce,
    declare_type,
    fill_error,
    if_else,
    make_tuple,
    require,
    unwrap,
)
from pathway_tpu_torch.internals.parse_graph import G, run, run_all  # noqa: E402
from pathway_tpu_torch.internals.schema import (  # noqa: E402
    Schema,
    assert_table_has_schema,
    column_definition,
    schema_builder,
    schema_from_csv,
    schema_from_dict,
    schema_from_types,
)
from pathway_tpu_torch.internals.table import JoinMode, Table  # noqa: E402
from pathway_tpu_torch.internals.thisclass import left, right, this  # noqa: E402
from pathway_tpu_torch.internals import udfs  # noqa: E402
from pathway_tpu_torch.internals.config import set_license_key  # noqa: E402
from pathway_tpu_torch.internals.udfs import UDF, udf  # noqa: E402
from pathway_tpu_torch.internals.unported import module_getattr as _module_getattr  # noqa: E402
from pathway_tpu_torch.models import Encoder, EncoderConfig, embed  # noqa: E402
from pathway_tpu_torch.ops import knn_search, knn_update  # noqa: E402
from pathway_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402
from pathway_tpu_torch.xpacks.llm import EncoderEmbedder, SentenceTransformerEmbedder  # noqa: E402

from pathway_tpu_torch import debug  # noqa: E402  (imports Table)
from pathway_tpu_torch import stdlib  # noqa: E402
from pathway_tpu_torch.internals.iterate import iterate  # noqa: E402
from pathway_tpu_torch.internals.monitoring import MonitoringLevel  # noqa: E402
from pathway_tpu_torch.internals.telemetry import set_monitoring_config  # noqa: E402
from pathway_tpu_torch.stdlib import temporal  # noqa: E402


class universes:
    """Universe promises: ``pw.universes.promise_are_equal`` and
    ``promise_is_subset_of``, registered with the universe solver."""

    @staticmethod
    def promise_are_equal(*tables: Table) -> None:
        for other in tables[1:]:
            _universe_mod.solver.register_equal(tables[0]._universe, other._universe)

    @staticmethod
    def promise_is_subset_of(sub: Table, sup: Table) -> None:
        _universe_mod.solver.register_subset(sub._universe, sup._universe)


def wrap_py_object(obj: object, **kwargs: object) -> PyObjectWrapper:
    return PyObjectWrapper(obj)


__getattr__ = _module_getattr(__name__, {
    **dict.fromkeys(
        (
            "sql", "demo", "load_yaml", "export_table", "import_table", "AsyncTransformer",
            "LiveTable", "enable_interactive_mode", "stop_interactive_mode",
            "PathwayConfig", "get_pathway_config",
        ),
        "8: the rest of the package",
    ),
    **dict.fromkeys(
        (
            "ClassArg", "attribute", "input_attribute", "input_method", "method",
            "output_attribute", "transformer",
        ),
        "8: the rest of the package (the row transformers)",
    ),
})

__all__ = [
    "ColumnExpression",
    "ColumnReference",
    "DateTimeNaive",
    "DateTimeUtc",
    "DeviceKnnIndex",
    "Duration",
    "ERROR",
    "Encoder",
    "EncoderConfig",
    "EncoderEmbedder",
    "G",
    "HostKnnIndex",
    "JoinMode",
    "Json",
    "MonitoringLevel",
    "Pointer",
    "PyObjectWrapper",
    "Schema",
    "SentenceTransformerEmbedder",
    "Table",
    "UDF",
    "apply",
    "apply_async",
    "apply_with_type",
    "assert_table_has_schema",
    "cast",
    "coalesce",
    "column_definition",
    "debug",
    "declare_type",
    "embed",
    "fill_error",
    "flash_attention",
    "global_error_log",
    "if_else",
    "io",
    "iterate",
    "knn_search",
    "knn_update",
    "left",
    "local_error_log",
    "make_tuple",
    "persistence",
    "reducers",
    "ref_scalar",
    "require",
    "right",
    "run",
    "run_all",
    "schema_builder",
    "schema_from_csv",
    "schema_from_dict",
    "schema_from_types",
    "set_license_key",
    "set_monitoring_config",
    "stdlib",
    "temporal",
    "this",
    "udf",
    "udfs",
    "universes",
    "unsafe_make_pointer",
    "unwrap",
    "wrap_py_object",
]
