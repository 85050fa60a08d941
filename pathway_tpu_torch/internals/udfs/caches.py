"""UDF result caches.

Counterpart of ``pathway_tpu/internals/udfs/caches.py``, with the same cache keys: a
key is the SHA-256 of ``(cache name, args)`` pickled at protocol 4 (their ``repr`` when
they do not pickle), so the two packages file the same call under the same key.
``InMemoryCache`` keeps results in a dict (``max_size`` evicts the oldest entry);
``DiskCache`` (and ``DefaultCache``) keeps one pickle per key in a directory resolved
at first use.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Callable

_SENTINEL = object()


def _digest(name: str, args: tuple) -> str:
    """``name`` must uniquely identify the UDF (see UDF._cache_name: it
    includes module, qualname and a code hash so same-named UDFs or edited
    code never collide in a shared disk cache)."""
    try:
        payload = pickle.dumps((name, args), protocol=4)
    except Exception:  # unpicklable args — hash reprs
        payload = repr((name, args)).encode()
    return hashlib.sha256(payload).hexdigest()


def fn_cache_name(fn: Callable) -> str:
    """Stable-across-runs identifier for a function: module + qualname +
    bytecode digest (invalidates cached results when the code changes)."""
    module = getattr(fn, "__module__", "?")
    qualname = getattr(fn, "__qualname__", getattr(fn, "__name__", "udf"))
    code = getattr(fn, "__code__", None)
    code_hash = (
        hashlib.sha256(code.co_code).hexdigest()[:16] if code is not None else ""
    )
    return f"{module}.{qualname}#{code_hash}"


class CacheStrategy:
    def get(self, key: str) -> Any:
        return _SENTINEL

    def put(self, key: str, value: Any) -> None:
        pass

    @staticmethod
    def missing(value: Any) -> bool:
        return value is _SENTINEL


class InMemoryCache(CacheStrategy):
    def __init__(self, max_size: int | None = None) -> None:
        self._data: dict[str, Any] = {}
        self._max_size = max_size

    def get(self, key: str) -> Any:
        return self._data.get(key, _SENTINEL)

    def put(self, key: str, value: Any) -> None:
        if self._max_size is not None and len(self._data) >= self._max_size:
            self._data.pop(next(iter(self._data)))
        self._data[key] = value


_udf_cache_root: str | None = None


def set_udf_cache_root(path: str | None) -> None:
    """Wire persistence-config UDF caching (PersistenceMode.UDF_CACHING):
    DiskCaches constructed without an explicit directory resolve here."""
    global _udf_cache_root
    _udf_cache_root = path


class DiskCache(CacheStrategy):
    """Pickle-per-key directory cache. The directory resolves lazily at
    first use: explicit ``directory`` > persistence-config root
    (set_udf_cache_root) > PATHWAY_TPU_UDF_CACHE env > ./.pathway/udf-cache
    — so a cache declared at UDF-definition time honors a persistence
    config passed later to pw.run."""

    def __init__(self, directory: str | None = None) -> None:
        self._explicit = directory
        self._resolved: str | None = None

    def _base(self) -> str:
        resolved = (
            self._explicit
            or _udf_cache_root
            or os.environ.get("PATHWAY_TPU_UDF_CACHE")
            or os.path.join(".pathway", "udf-cache")
        )
        if resolved != self._resolved:
            os.makedirs(resolved, exist_ok=True)
            self._resolved = resolved
        return resolved

    def _path(self, key: str) -> str:
        return os.path.join(self._base(), key[:2], key)

    def get(self, key: str) -> Any:
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except (FileNotFoundError, EOFError, pickle.UnpicklingError):
            return _SENTINEL

    def put(self, key: str, value: Any) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(value, f, protocol=4)
            os.replace(tmp, path)
        except Exception:  # unpicklable result — skip caching
            try:
                os.unlink(tmp)
            except OSError:
                pass


class DefaultCache(DiskCache):
    """Reference-compatible alias (udfs.DefaultCache == disk-backed)."""
