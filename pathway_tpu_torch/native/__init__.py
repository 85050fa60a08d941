"""The engine's C++ host kernels (``enginecore.cpp``), built by the port at first use.

Counterpart of ``pathway_tpu/native``: CPython C++ kernels for the engine's per-row
object plumbing (consolidation, state application, the input session's overlay, key
bytes and digests, the filter sweep, the join's sides and pairs). ``enginecore.cpp`` is
compiled with ``g++`` by :func:`pathway_tpu_torch._build.build_host` into ``_build/``
the first time a caller asks for the kernels, never at import. Each kernel returns
``None`` ("bails") for inputs outside its exact type set, and its caller then runs the
Python branch beside it, which is the kernel's plain version.

Deliberate difference from the reference: a failed build or load raises a
``RuntimeError`` carrying the compiler's output; nothing falls back quietly.
``PATHWAY_TPU_DISABLE_NATIVE=1`` is the one way to the Python branches. It is read
each time the kernels are looked up, so one process can run a workload both ways.

Public surface: ``get()`` (the kernels' module, or None when disabled; call sites use
it), ``available()``, ``kernels`` (the same as ``get()``), ``load_error()``,
``hit_counts()``, ``kernel_ns()`` and ``reset_hit_counts()``.
"""

from __future__ import annotations

import importlib.util
import os
import threading
from pathlib import Path
from types import ModuleType

SOURCE = Path(__file__).resolve().parent / "enginecore.cpp"
DISABLE_ENV = "PATHWAY_TPU_DISABLE_NATIVE"

_lock = threading.Lock()
_module: ModuleType | None = None
#: seconds the build took in this process (0.0 when the library was built already)
build_seconds: float | None = None


def disabled() -> bool:
    return os.environ.get(DISABLE_ENV) == "1"


def _load() -> ModuleType:
    global _module, build_seconds
    with _lock:
        if _module is None:
            from pathway_tpu_torch import _build

            built = _build.build_host(SOURCE)  # raises with g++'s output
            try:
                spec = importlib.util.spec_from_file_location("_enginecore", built.library)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
            except Exception as e:
                raise RuntimeError(f"loading the host kernels {built.library} failed: {e!r}") from e
            build_seconds = built.seconds
            _module = mod
        return _module


def get() -> ModuleType | None:
    """The kernels' module, built and loaded at the first call; None under
    ``PATHWAY_TPU_DISABLE_NATIVE=1``. Raises ``RuntimeError`` if the build fails."""
    if disabled():
        return None
    mod = _module
    return mod if mod is not None else _load()


def available() -> bool:
    """True when the kernels are in use (built and loaded, and not disabled)."""
    return get() is not None


def load_error() -> str | None:
    """Why the kernels are not in use: the disable notice, or None (a failed build
    raises instead of being recorded)."""
    return f"disabled via {DISABLE_ENV}=1" if disabled() else None


def hit_counts() -> dict[str, int]:
    """Calls of each kernel since the library was loaded (or the last
    :func:`reset_hit_counts`); empty before the first build. Never builds."""
    return _module.hit_counts() if _module is not None else {}


def kernel_ns() -> dict[str, int]:
    """Cumulative wall nanoseconds inside each kernel, as :func:`hit_counts`."""
    return _module.kernel_ns() if _module is not None else {}


def reset_hit_counts() -> None:
    if _module is not None:
        _module.reset_hit_counts()


def __getattr__(name: str):
    if name == "kernels":
        return get()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
