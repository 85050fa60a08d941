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
            "         pw.reducers.sum, pw.left.x, pw.right.x, pw.debug.table_from_markdown]",
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
