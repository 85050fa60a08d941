"""The port stands alone: importing every ``pathway_tpu_torch`` module, and what
chip_smoke.py imports, loads neither JAX nor the JAX package; and nothing builds or
touches a card at import."""

import os
import pkgutil
import subprocess
import sys

import pytest

import pathway_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    names = ["pathway_tpu_torch"]
    for info in pkgutil.walk_packages(pathway_tpu_torch.__path__, "pathway_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_is_listed():
    names = _modules()
    for expected in (
        "pathway_tpu_torch.ops.flash_attention",
        "pathway_tpu_torch.ops.knn",
        "pathway_tpu_torch.models.transformer",
        "pathway_tpu_torch.models.hf_import",
        "pathway_tpu_torch.models.train",
        "pathway_tpu_torch.models.vision",
        "pathway_tpu_torch.models.decoder",
        "pathway_tpu_torch.xpacks.llm.rerankers",
        "pathway_tpu_torch.xpacks.llm.llms",
        "pathway_tpu_torch.engine.external_index",
        "pathway_tpu_torch.xpacks.llm.embedders",
        "pathway_tpu_torch.xpacks.llm._tokenizer",
        "pathway_tpu_torch._build",
        "pathway_tpu_torch.engine.value",
        "pathway_tpu_torch.engine.batch",
        "pathway_tpu_torch.engine.expression",
        "pathway_tpu_torch.engine.device",
        "pathway_tpu_torch.engine.device_pipeline",
        "pathway_tpu_torch.internals.metrics",
        "pathway_tpu_torch.internals.tracing",
        "pathway_tpu_torch.internals.profiling",
        "pathway_tpu_torch.internals.lockwatch",
        "pathway_tpu_torch.internals.timeseries",
        "pathway_tpu_torch.internals.monitoring",
        "pathway_tpu_torch.internals.telemetry",
        "pathway_tpu_torch.engine.graph",
        "pathway_tpu_torch.engine.connectors",
        "pathway_tpu_torch.internals.dtype",
        "pathway_tpu_torch.internals.schema",
        "pathway_tpu_torch.internals.expression",
        "pathway_tpu_torch.internals.thisclass",
        "pathway_tpu_torch.internals.desugaring",
        "pathway_tpu_torch.internals.universe",
        "pathway_tpu_torch.internals.errors",
        "pathway_tpu_torch.internals.config",
        "pathway_tpu_torch.internals.trace",
        "pathway_tpu_torch.internals.table",
        "pathway_tpu_torch.internals.udfs",
        "pathway_tpu_torch.internals.udfs.executors",
        "pathway_tpu_torch.internals.parse_graph",
        "pathway_tpu_torch.internals.runner",
        "pathway_tpu_torch.io.python",
        "pathway_tpu_torch.io._subscribe",
        "pathway_tpu_torch.io._utils",
        "pathway_tpu_torch.io._synchronization",
        "pathway_tpu_torch.io.http",
        "pathway_tpu_torch.io.logstash",
        "pathway_tpu_torch.io.sqlite",
        "pathway_tpu_torch.io.s3",
        "pathway_tpu_torch.io.minio",
        "pathway_tpu_torch.io.s3_csv",
        "pathway_tpu_torch.io.pyfilesystem",
        "pathway_tpu_torch.io.gdrive",
        "pathway_tpu_torch.io.deltalake",
        "pathway_tpu_torch.engine.storage",
        "pathway_tpu_torch.stdlib.indexing.data_index",
        "pathway_tpu_torch.engine.device_ops",
        "pathway_tpu_torch.engine.reducers",
        "pathway_tpu_torch.ops.segment_reduce",
        "pathway_tpu_torch.internals.reducers",
        "pathway_tpu_torch.internals.groupbys",
        "pathway_tpu_torch.internals.joins",
        "pathway_tpu_torch.debug",
        "pathway_tpu_torch.internals.udfs.caches",
        "pathway_tpu_torch.internals.udfs.retries",
        "pathway_tpu_torch.internals.jmespath_lite",
        "pathway_tpu_torch.stdlib.indexing.bm25",
        "pathway_tpu_torch.stdlib.indexing.hybrid_index",
        "pathway_tpu_torch.xpacks.llm.prompts",
        "pathway_tpu_torch.xpacks.llm.mocks",
        "pathway_tpu_torch.xpacks.llm.splitters",
        "pathway_tpu_torch.xpacks.llm._pdf",
        "pathway_tpu_torch.xpacks.llm.parsers",
        "pathway_tpu_torch.xpacks.llm.document_store",
        "pathway_tpu_torch.xpacks.llm.vector_store",
        "pathway_tpu_torch.xpacks.llm.question_answering",
        "pathway_tpu_torch.optimize",
        "pathway_tpu_torch.optimize.pushdown",
        "pathway_tpu_torch.optimize.elide",
        "pathway_tpu_torch.optimize.fuse",
        "pathway_tpu_torch.optimize.placement",
        "pathway_tpu_torch.analysis",
        "pathway_tpu_torch.analysis.runtime",
        "pathway_tpu_torch.analysis.usage",
        "pathway_tpu_torch.analysis.shards",
        "pathway_tpu_torch.engine.sharded",
        "pathway_tpu_torch.engine.device_residency",
        "pathway_tpu_torch.native",
        "pathway_tpu_torch.persistence",
        "pathway_tpu_torch.engine.persistence",
        "pathway_tpu_torch.io.fs",
        "pathway_tpu_torch.io.csv",
        "pathway_tpu_torch.io.jsonlines",
        "pathway_tpu_torch.io.plaintext",
        "pathway_tpu_torch.io.null",
        "pathway_tpu_torch.engine.formats",
        "pathway_tpu_torch.io._kafka_wire",
        "pathway_tpu_torch.io._avro",
        "pathway_tpu_torch.io.kafka",
        "pathway_tpu_torch.io.redpanda",
        "pathway_tpu_torch.io.debezium",
        "pathway_tpu_torch.io._nats_wire",
        "pathway_tpu_torch.io.nats",
        "pathway_tpu_torch.io.pubsub",
        "pathway_tpu_torch.io._pg_wire",
        "pathway_tpu_torch.io.postgres",
        "pathway_tpu_torch.io._mongo_wire",
        "pathway_tpu_torch.io.mongodb",
        "pathway_tpu_torch.io._es_wire",
        "pathway_tpu_torch.io.elasticsearch",
        "pathway_tpu_torch.io.bigquery",
        "pathway_tpu_torch.io.slack",
        "pathway_tpu_torch.io._iceberg_rest",
        "pathway_tpu_torch.io.iceberg",
        "pathway_tpu_torch.io.airbyte",
        "pathway_tpu_torch.internals.license",
        "pathway_tpu_torch.xpacks.connectors",
        "pathway_tpu_torch.xpacks.connectors.sharepoint",
        "pathway_tpu_torch.engine.faults",
        "pathway_tpu_torch.engine.distributed",
        "pathway_tpu_torch.engine.supervisor",
        "pathway_tpu_torch.cli",
        "pathway_tpu_torch.serving",
        "pathway_tpu_torch.serving.snapshot",
        "pathway_tpu_torch.serving.result_cache",
        "pathway_tpu_torch.serving.server",
        "pathway_tpu_torch.serving.stream",
        "pathway_tpu_torch.serving.replica",
        "pathway_tpu_torch.serving.federation",
        "pathway_tpu_torch.xpacks.llm.servers",
    ):
        assert expected in names


def test_engine_api_imports_no_jax_and_touches_no_card():
    """``import pathway_tpu_torch as pw`` with the names a pipeline uses loads neither
    JAX nor the JAX package, and initialises no CUDA context."""
    code = "\n".join(
        [
            "import sys",
            f"sys.path.insert(0, {REPO!r})",
            "import pathway_tpu_torch as pw",
            "from pathway_tpu_torch.stdlib.indexing import DataIndex, DeviceKnnFactory",
            "from pathway_tpu_torch.xpacks.llm import (AdaptiveRAGQuestionAnswerer, DocumentStore,",
            "    VectorStoreServer, mocks, parsers, splitters)",
            "names = [pw.run, pw.io.python.read, pw.io.python.ConnectorSubject,",
            "         pw.io.subscribe, pw.this.x, pw.schema_from_types, pw.Table, pw.udf, pw.UDF,",
            "         pw.reducers.sum, pw.left.x, pw.right.x, pw.debug.table_from_markdown,",
            "         pw.io.fs.read, pw.io.csv.write, pw.io.jsonlines.read, pw.io.plaintext.read,",
            "         pw.io.null.write, pw.persistence.Config, pw.persistence.Backend.filesystem,",
            "         pw.io.http.rest_connector, pw.io.http.write, pw.io.logstash.write,",
            "         pw.io.sqlite.read, pw.io.s3.read, pw.io.minio.read, pw.io.s3_csv.read,",
            "         pw.io.pyfilesystem.read, pw.io.gdrive.read, pw.io.deltalake.read,",
            "         pw.io.register_input_synchronization_group, pw.persistence.Backend.s3,",
            "         pw.io.kafka.read, pw.io.kafka.write, pw.io.redpanda.read, pw.io.debezium.read,",
            "         pw.io.nats.read, pw.io.nats.write, pw.io.pubsub.write,",
            "         pw.io.postgres.write, pw.io.postgres.write_snapshot, pw.io.mongodb.write,",
            "         pw.io.elasticsearch.write, pw.io.bigquery.write, pw.io.slack.send_alerts,",
            "         pw.io.iceberg.read, pw.io.iceberg.write, pw.io.airbyte.read,",
            "         pw.set_license_key]",
            "from pathway_tpu_torch.xpacks.connectors import sharepoint",
            "assert sharepoint.read",
            "from pathway_tpu_torch.cli import main, rescale, spawn",
            "from pathway_tpu_torch.engine.distributed import DistributedScheduler, MeshTransport",
            "from pathway_tpu_torch.engine.supervisor import MeshSupervisor",
            "from pathway_tpu_torch.internals.runner import DistributedGraphRunner",
            "assert 'aiohttp' not in sys.modules and 'pyarrow' not in sys.modules",
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pathway_tpu'))",
            "assert not bad, bad",
            "import torch",
            "assert not torch.cuda.is_initialized()",
            "print('clean')",
        ]
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_port_and_chip_smoke_import_no_jax():
    code = "\n".join(
        [
            "import importlib, sys",
            f"sys.path.insert(0, {REPO!r})",
            *[f"importlib.import_module({m!r})" for m in _modules()],
            "import chip_smoke",
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pathway_tpu'))",
            "assert not bad, bad",
            "from pathway_tpu_torch.ops.flash_attention import KERNEL",
            "assert KERNEL._fn is None and KERNEL.launches == 0",
            "from pathway_tpu_torch.ops.flash_attention import BWD_DQ_KERNEL, BWD_DKV_KERNEL",
            "assert BWD_DQ_KERNEL._fn is None and BWD_DKV_KERNEL._fn is None",
            "from pathway_tpu_torch.ops.segment_reduce import DADD_CHAIN, KERNELS",
            "assert all(k._fn is None and k.launches == 0 for k in [*KERNELS.values(), DADD_CHAIN])",
            "from pathway_tpu_torch import native",
            "assert native._module is None and native.hit_counts() == {}",
            "print('clean')",
        ]
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True, cwd=REPO,
        timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo, the
    script exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True, cwd=tmp_path,
        env=env, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_default_device_raises_where_there_is_no_card():
    import torch

    from pathway_tpu_torch.models import Encoder, minilm_l6
    from pathway_tpu_torch.ops.knn import knn_init
    from pathway_tpu_torch.stdlib.indexing import DeviceKnnFactory
    from pathway_tpu_torch.models import Decoder, VisionEncoder, tiny_decoder, vit_tiny
    from pathway_tpu_torch.xpacks.llm import (
        CrossEncoderReranker,
        EncoderEmbedder,
        ImageEmbedder,
        PipelineChat,
    )

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for entry in (
        lambda: Encoder(minilm_l6()),
        lambda: knn_init(8, 4),
        lambda: DeviceKnnFactory(dimensions=4).build(),
        lambda: EncoderEmbedder(),
        lambda: VisionEncoder(vit_tiny()),
        lambda: Decoder(tiny_decoder()),
        lambda: ImageEmbedder("vit-tiny"),
        lambda: CrossEncoderReranker(),
        lambda: PipelineChat("tiny"),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    """A build where there is no CUDA toolkit raises; it never yields a stub."""
    import shutil

    from pathway_tpu_torch import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert "flash_attention_fwd" in _build.sources()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    from pathway_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one")
    first = _build._library_path(src)
    src.write_text("// two")
    assert _build._library_path(src) != first
    assert first.parent == tmp_path and first.name.startswith("libk-")


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a ``csrc/*.cuh`` header rebuilds every library that may include it."""
    from pathway_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text('#include "common.cuh"')
    header = tmp_path / "common.cuh"
    header.write_text("// one")
    first = _build._library_path(src)
    header.write_text("// two")
    assert _build._library_path(src) != first


def test_host_kernels_import_no_jax():
    """``pathway_tpu_torch.native`` builds and runs its kernels without JAX or the JAX
    package, and its source includes nothing of the JAX package."""
    code = "\n".join(
        [
            "import sys",
            f"sys.path.insert(0, {REPO!r})",
            "from pathway_tpu_torch import native",
            "k = native.get()",
            "assert k.entry_diffs([(1, (), 3)]).tolist() == [3]",
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pathway_tpu'))",
            "assert not bad, bad",
            "print('clean')",
        ]
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
    from pathway_tpu_torch import native

    includes = [
        line.split(None, 1)[1].strip()
        for line in native.SOURCE.read_text().splitlines()
        if line.startswith("#include")
    ]
    assert includes and all(inc.startswith("<") and inc.endswith(">") for inc in includes), includes
    assert not any("pathway_tpu" in inc for inc in includes)


def test_host_kernel_build_raises_instead_of_falling_back(tmp_path, monkeypatch):
    """A host build with an unusable compiler raises a RuntimeError carrying the
    command; the kernels are never quietly replaced by the Python branches."""
    from pathway_tpu_torch import _build, native

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "GXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_module", None)
    monkeypatch.delenv(native.DISABLE_ENV, raising=False)
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.get()
    with pytest.raises(RuntimeError, match="host kernel build failed"):
        native.available()
    assert native._module is None
    # a compiler that runs and fails: its output is in the error
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "GXX", "g++")
    with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
        _build.build_host(bad)
    assert not list((tmp_path / "build").glob("*.so"))
    # only the explicit switch reaches the Python branches
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    assert native.get() is None and native._module is None
