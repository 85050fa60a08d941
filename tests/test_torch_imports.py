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
        "pathway_tpu_torch.engine.external_index",
        "pathway_tpu_torch.xpacks.llm.embedders",
        "pathway_tpu_torch.xpacks.llm._tokenizer",
        "pathway_tpu_torch._build",
    ):
        assert expected in names


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

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for entry in (lambda: Encoder(minilm_l6()), lambda: knn_init(8, 4)):
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
