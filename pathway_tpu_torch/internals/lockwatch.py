"""Runtime lock-order recorder.

Counterpart of ``pathway_tpu/internals/lockwatch.py``, with the same env vars, report
file, flight event and metric families. It wraps ``threading.Lock`` / ``RLock``
creation so every acquisition records:

- the **lock-order graph**: an edge ``A -> B`` whenever ``B`` is acquired while ``A``
  is held. A new edge that closes a directed cycle is a potential deadlock: it lands
  in the flight recorder (``lock_order_cycle``), in :func:`cycles`, and as a
  ``pathway_lockwatch_cycle_p<pid>.json`` report under ``PATHWAY_TPU_LOCKWATCH_DIR``
  (default: the temp dir);
- **hold-time gauges**: ``pathway_lock_hold_seconds_max{lock=...}`` and
  ``pathway_lock_acquisitions_total{lock=...}`` on the process registry, keyed by the
  lock's creation site (``file.py:lineno``, the file's basename).

Enable with ``PATHWAY_TPU_LOCKWATCH=1``. Installation must happen before the runtime
modules create their locks: ``pathway_tpu_torch/__init__`` calls :func:`maybe_install`
first thing, before it imports torch, so torch's own Python locks are watched too.
Disabled, nothing is patched and the overhead is zero; enabled, each acquire/release
pays two dict operations and a perf-counter read.

A wrapped lock also answers the private methods CPython's standard library calls on a
lock, delegated to the inner lock: ``_at_fork_reinit`` (``concurrent.futures``
registers it at import, which ``import torch`` reaches) and ``_recursion_count``
(``multiprocessing``'s resource tracker); the JAX package's wrapper raises
``AttributeError`` on both (ROADMAP: deliberate differences). As in the JAX
package, ``_release_save`` / ``_acquire_restore`` are not delegated, so
``Condition.wait`` on a watched RLock held more than once releases one level only.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time as _time
from typing import Any

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

#: creation-site name -> {successor name -> first-observed (file, line)}
_ORDER: dict[str, dict[str, tuple[str, int]]] = {}
_ORDER_LOCK = _REAL_LOCK()
_CYCLES: list[dict[str, Any]] = []
_HELD = threading.local()
_INSTALLED = False
_METRIC_HANDLES: dict[str, tuple[Any, Any]] = {}


def enabled() -> bool:
    return os.environ.get("PATHWAY_TPU_LOCKWATCH", "0") not in ("0", "", "false")


def _creation_site(depth: int = 2) -> str:
    """``file.py:lineno`` of the lock's creation, skipping this module."""
    frame = sys._getframe(depth)
    while frame is not None and frame.f_code.co_filename == __file__:
        frame = frame.f_back
    if frame is None:
        return "<unknown>"
    fname = os.path.basename(frame.f_code.co_filename)
    return f"{fname}:{frame.f_lineno}"


def _held_stack() -> list[str]:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


def _handles(name: str) -> tuple[Any, Any]:
    pair = _METRIC_HANDLES.get(name)
    if pair is None:
        from pathway_tpu_torch.internals import metrics as _metrics

        pair = (
            _metrics.REGISTRY.gauge(
                "pathway_lock_hold_seconds_max",
                "longest observed hold of this lock",
                lock=name,
            ),
            _metrics.REGISTRY.counter(
                "pathway_lock_acquisitions_total",
                "times this lock was acquired",
                lock=name,
            ),
        )
        _METRIC_HANDLES[name] = pair
    return pair


def _report_cycle(path: list[str], mod_edge: tuple[str, str]) -> None:
    report = {
        "kind": "lock_order_cycle",
        "cycle": path,
        "closing_edge": list(mod_edge),
        "pid": os.getpid(),
        "wall": _time.time(),
    }
    _CYCLES.append(report)
    try:
        from pathway_tpu_torch.internals.metrics import FLIGHT

        FLIGHT.record(
            "lock_order_cycle",
            cycle=" -> ".join(path),
            closing_edge=f"{mod_edge[0]} -> {mod_edge[1]}",
        )
    except Exception:  # noqa: BLE001 — the report file below still lands
        pass
    directory = os.environ.get("PATHWAY_TPU_LOCKWATCH_DIR") or tempfile.gettempdir()
    try:
        os.makedirs(directory, exist_ok=True)
        path_out = os.path.join(directory, f"pathway_lockwatch_cycle_p{os.getpid()}.json")
        with open(path_out, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(report) + "\n")
    except OSError:
        pass


def _record_edge(holder: str, target: str) -> None:
    """Add ``holder -> target``; on a NEW edge, DFS for a return path."""
    cycle: list[str] | None = None
    with _ORDER_LOCK:
        succ = _ORDER.setdefault(holder, {})
        if target in succ:
            return
        succ[target] = ("", 0)
        # does target already reach holder? (the new edge closes a cycle)
        stack, seen = [target], {target}
        path_parent: dict[str, str] = {}
        while stack and cycle is None:
            node = stack.pop()
            if node == holder:
                cycle = [holder]
                cur = holder
                while cur != target:
                    cur = path_parent[cur]
                    cycle.append(cur)
                cycle.append(holder)
                break
            for nxt in _ORDER.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    path_parent[nxt] = node
                    stack.append(nxt)
    if cycle is not None:
        # emit OUTSIDE the order lock: the flight recorder's own (watched) lock
        # acquisition re-enters this module
        _report_cycle(cycle, (holder, target))


class _WatchedLock:
    """Delegating wrapper; quacks enough like ``threading.Lock`` for ``Condition``
    (acquire/release/locked + context manager) and for the standard library's other
    callers (``_at_fork_reinit``, ``_recursion_count``)."""

    __slots__ = ("_inner", "_name", "_t0", "_reentry")

    def __init__(self, inner: Any, name: str) -> None:
        self._inner = inner
        self._name = name
        self._t0 = 0.0
        self._reentry = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            stack = _held_stack()
            if self._name in stack:
                # RLock re-entry: no new edge, no double bookkeeping
                self._reentry += 1
            else:
                if stack:
                    _record_edge(stack[-1], self._name)
                stack.append(self._name)
                self._t0 = _time.perf_counter()
        return got

    def release(self) -> None:
        stack = _held_stack()
        dur = None
        if self._reentry and self._name in stack:
            self._reentry -= 1
        elif self._name in stack:
            stack.remove(self._name)
            dur = _time.perf_counter() - self._t0
        # inner FIRST: the gauge update below re-enters the registry, whose own lock
        # may be the very lock being released
        self._inner.release()
        if dur is not None and not getattr(_HELD, "in_metrics", False):
            _HELD.in_metrics = True
            try:
                g_max, c_total = _handles(self._name)
                if dur > g_max.value:
                    g_max.value = round(dur, 6)
                c_total.inc()
            except Exception:  # noqa: BLE001 — metrics must not break locks
                pass
            finally:
                _HELD.in_metrics = False

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    # Condition() introspects these when present on RLocks; delegate so a watched
    # RLock still wait()s correctly.
    def _is_owned(self) -> bool:
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _at_fork_reinit(self) -> None:
        """The child of a fork: a fresh, unheld inner lock (``os.register_at_fork``
        hooks of ``concurrent.futures``, ``logging`` and ``threading`` call this)."""
        self._inner._at_fork_reinit()
        self._reentry = 0

    def _recursion_count(self) -> int:
        """An RLock's depth in the calling thread (``multiprocessing``'s resource
        tracker, which torch starts, asks it)."""
        return self._inner._recursion_count()

    def __repr__(self) -> str:
        return f"<WatchedLock {self._name} {self._inner!r}>"


def _make_lock() -> _WatchedLock:
    return _WatchedLock(_REAL_LOCK(), _creation_site())


def _make_rlock() -> _WatchedLock:
    return _WatchedLock(_REAL_RLOCK(), _creation_site())


def install() -> None:
    """Patch ``threading.Lock``/``RLock`` factories (idempotent)."""
    global _INSTALLED
    if _INSTALLED:
        return
    threading.Lock = _make_lock  # type: ignore[assignment]
    threading.RLock = _make_rlock  # type: ignore[assignment]
    _INSTALLED = True


def uninstall() -> None:
    global _INSTALLED
    if not _INSTALLED:
        return
    threading.Lock = _REAL_LOCK  # type: ignore[assignment]
    threading.RLock = _REAL_RLOCK  # type: ignore[assignment]
    _INSTALLED = False


def maybe_install() -> None:
    if enabled():
        install()


def cycles() -> list[dict[str, Any]]:
    """Cycle reports recorded so far (this process)."""
    with _ORDER_LOCK:
        return list(_CYCLES)


def reset() -> None:
    """Drop recorded state (tests)."""
    with _ORDER_LOCK:
        _ORDER.clear()
        _CYCLES.clear()
