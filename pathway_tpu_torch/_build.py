"""Build the hand-written CUDA kernels under ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface (headers shared between sources are
``csrc/*.cuh``), at first use, into ``_build/`` beside this file (listed in
``.gitignore``). A library's file name carries a hash of its source, the shared headers
and the flags, so an edited source is rebuilt and a built one is reused. Nothing is compiled
when the package is imported: the CPU tests import every module on machines with no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    library: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output, with the -Xptxas -v register/shared-memory lines


def _nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _library_path(source: Path) -> Path:
    """The library's path, named by a hash of its source, the shared headers it may
    include (``csrc/*.cuh``) and the flags."""
    digest = hashlib.blake2s(source.read_bytes() + " ".join(NVCC_FLAGS).encode(), digest_size=8)
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()}.so"


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: list[str] | None = None) -> dict[str, BuildResult]:
    """Compile the named kernels (default: every ``csrc/*.cu``), one ``nvcc`` per
    source, all started together. Raises if any build fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: dict[str, BuildResult] = {}
    running = []
    for name in names:
        source = CSRC / f"{name}.cu"
        lib = _library_path(source)
        if lib.exists():
            log_path = lib.with_suffix(".log")
            log = log_path.read_text() if log_path.exists() else ""
            results[name] = BuildResult(name, lib, 0.0, log)
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc, time.perf_counter()))
    failures = []
    for name, lib, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
        results[name] = BuildResult(name, lib, seconds, log)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return results


def sass(name: str) -> str:
    """The SASS of the built library of ``csrc/<name>.cu``, from ``cuobjdump -sass``
    beside ``nvcc``: what the card runs, to count its tensor-core instructions."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    library = build([name])[name].library
    return subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True, check=True).stdout


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build([name])[name].library))
        return _loaded[name]


class CudaKernel:
    """A C entry point of one kernel library, and the count of its launches.

    ``launches`` is a plain integer that grows by one on every successful launch and
    nowhere else, so a run can show that it went through the kernel."""

    def __init__(self, source: str, symbol: str, argtypes: list) -> None:
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._lib: ctypes.CDLL | None = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            self._lib = load(self.source)
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err_fn = self._lib.pt_cuda_error_string
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            reason = self._lib.pt_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} did not launch: CUDA error {err} ({reason})")
        self.launches += 1
