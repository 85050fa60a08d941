"""Async device pipeline: the commit boundary as a pipeline stage between the host
dataflow and the card.

Counterpart of ``pathway_tpu/engine/device_pipeline.py``, with the same names, knobs
and defaults. A synchronous engine ends every commit by completing each device batch's
host twin and dropping its tensor, so ingest of commit N+1 waits until commit N's
device work has retired. Here:

- **staging** — at each commit boundary the scheduler hands the commit's live
  :class:`~pathway_tpu_torch.engine.device.DeviceBatchHandle` set to
  :meth:`DevicePipeline.commit_boundary`. Each handle's copy into pinned memory is
  started there, on the scheduler thread, behind an event (``prefetch``), and the
  commit goes on a FIFO; the scheduler returns to the connector loop at once.
- **completion** — one daemon thread (``pw-device-pipeline``) pops staged commits in
  order and completes them: ``decay()`` waits on each handle's event (the wait releases
  the GIL), copies the host twin out of the pinned buffer and drops the device tensor.
  It enqueues nothing on the card. Commit N is host-resident before commit N+1 is;
  :meth:`DevicePipeline.drain_until` is the barrier a checkpoint of commit N waits on.
- **backpressure** — at most ``depth`` commits (``PATHWAY_TPU_DEVICE_INFLIGHT``,
  default 2) are in flight; staging one more blocks until the oldest retires, so
  device memory holds at most ``depth`` commits of batches.
- **feedback** — :class:`AdaptiveBatchController` reads the pipeline's pressure each
  device commit and sets the embedder's micro-batch (:func:`suggested_batch_size`, read
  by ``BatchExecutor``'s sizer) and the connectors' autocommit window scale
  (:func:`ingest_window_scale`, read by ``InputDriver.effective_autocommit_s``).

``PATHWAY_TPU_ASYNC_DEVICE=0`` decays inline instead, bit for bit the synchronous
boundary. A failure on the completion thread is raised on the scheduler thread at the
next staging, ``drain_until`` or ``drain``; only ``reset`` drops it. Each boundary and
drain first decays the residency plane's resident batches
(``device_residency.decay_resident_batches``). :meth:`stats` reports the device
operators, the collective exchange and the residency plane beside the pipeline. With
tracing
on (``PATHWAY_TPU_TRACE=1``) the controller reads the last traced commit's critical
path, and a staging blocked on the in-flight limit records a ``device-backpressure``
span (``cat="wait"``, the queue-wait bucket); with tracing off it reads none.
"""

from __future__ import annotations

import os
import threading
import time as _time
from collections import deque

from pathway_tpu_torch.engine import collective_exchange as _collective
from pathway_tpu_torch.engine import device as _device
from pathway_tpu_torch.engine import device_ops as _dops
from pathway_tpu_torch.engine import device_residency as _dres
from pathway_tpu_torch.internals import metrics as _metrics
from pathway_tpu_torch.internals import tracing as _tracing

__all__ = [
    "AdaptiveBatchController",
    "DevicePipeline",
    "PIPELINE",
    "async_enabled",
    "commit_boundary",
    "drain",
    "drain_until",
    "reset",
    "stop_worker",
    "suggested_batch_size",
    "ingest_window_scale",
]

#: dispatch -> completion latency bucket bounds, seconds
DISPATCH_BUCKETS = (
    0.0001,
    0.00025,
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
)


def async_enabled() -> bool:
    """``PATHWAY_TPU_ASYNC_DEVICE=0`` restores the synchronous inline-decay commit
    boundary (the bit-exact spec)."""
    return os.environ.get("PATHWAY_TPU_ASYNC_DEVICE", "1").lower() not in (
        "0",
        "false",
        "no",
    )


def _env_int(name: str, default: int, floor: int = 1) -> int:
    try:
        return max(floor, int(os.environ.get(name, str(default))))
    except ValueError:
        return default


class AdaptiveBatchController:
    """The feedback loop from the pipeline's pressure to batch and window sizes.

    Read once per device commit: the staged depth, whether staging had to block on the
    in-flight bound, the completion stage's occupancy (EMA, 0..1) and the host queue
    gauge (``pathway_queue_depth``). Sets ``batch_size`` (the device micro-batch; a
    ``BatchExecutor`` only narrows its cap with it), ``depth`` (the in-flight bound)
    and ``window_scale`` (1.0..4.0, on connector autocommit windows).

    The rules are monotone and clamped: saturation doubles the batch and widens the
    window by 1.25; an idle completion stage with a host-bound critical path halves the
    batch and narrows the window back toward 1.0; in between nothing changes.
    """

    #: occupancy below which the device stage counts as starved
    IDLE_OCCUPANCY = 0.25

    def __init__(self) -> None:
        self.min_batch = _env_int("PATHWAY_TPU_DEVICE_BATCH_MIN", 32)
        self.max_batch = _env_int("PATHWAY_TPU_DEVICE_BATCH_MAX", 65536)
        self.batch_size = _env_int(
            "PATHWAY_TPU_DEVICE_BATCH", 1024, floor=self.min_batch
        )
        self.depth = _env_int("PATHWAY_TPU_DEVICE_INFLIGHT", 2)
        self.window_scale = 1.0
        self.ticks = 0
        self.grows = 0
        self.shrinks = 0
        self._queue_gauge = None

    def _host_queue_depth(self) -> float:
        g = self._queue_gauge
        if g is None:
            g = self._queue_gauge = _metrics.REGISTRY.gauge(
                "pathway_queue_depth",
                "operators with pending delta batches (backpressure)",
            )
        return g.value

    @staticmethod
    def _last_critical_path() -> dict | None:
        """The last traced commit's critical-path buckets; None with tracing off."""
        if not _tracing.TRACER.enabled:
            return None
        traces = _tracing.TRACER.traces()
        return traces[-1]["critical_path"] if traces else None

    def observe(self, *, staged_depth: int, blocked: bool, occupancy: float) -> None:
        """One device-commit tick of the feedback loop."""
        self.ticks += 1
        if blocked or staged_depth >= self.depth:
            # the completion stage is the bottleneck: fatter device batches and
            # fewer, larger commits amortize the dispatch
            self.batch_size = min(self.max_batch, self.batch_size * 2)
            self.window_scale = min(4.0, self.window_scale * 1.25)
            self.grows += 1
            return
        if occupancy < self.IDLE_OCCUPANCY:
            cp = self._last_critical_path()
            host_bound = cp is None or cp.get("host_compute_s", 0.0) >= cp.get(
                "device_s", 0.0
            )
            if host_bound and self._host_queue_depth() >= 0.0:
                # the device starves while the host works: smaller batches reach the
                # device sooner, and the ingest window relaxes toward its setting
                if self.batch_size > self.min_batch:
                    self.batch_size = max(self.min_batch, self.batch_size // 2)
                    self.shrinks += 1
                self.window_scale = max(1.0, self.window_scale / 1.25)

    def stats(self) -> dict:
        return {
            "batch_size": self.batch_size,
            "depth": self.depth,
            "window_scale": round(self.window_scale, 3),
            "ticks": self.ticks,
            "grows": self.grows,
            "shrinks": self.shrinks,
        }


class DevicePipeline:
    """The process-wide staging and completion pipe (the singleton :data:`PIPELINE`).

    A commit with no device batches costs one WeakSet truthiness test: the lock, the
    completion thread and the metrics are touched by device commits only.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        #: FIFO of (commit time, handles, dispatch perf_counter) awaiting completion
        self._staged: deque = deque()  # guarded-by: self._cv
        self._active_time: int | None = None  # guarded-by: self._cv
        self._completed_time = -1  # guarded-by: self._cv
        self._worker: threading.Thread | None = None
        self._stop = False  # guarded-by: self._cv
        self._error: BaseException | None = None  # guarded-by: self._cv
        self._occ_mark: float | None = None  # guarded-by: self._cv
        self._occupancy = 0.0  # guarded-by: self._cv
        self.controller = AdaptiveBatchController()
        self._g_depth = _metrics.REGISTRY.gauge(
            "pathway_device_queue_depth",
            "device-pipeline commits staged or completing",
        )
        self._g_occ = _metrics.REGISTRY.gauge(
            "pathway_device_occupancy_ratio",
            "EMA share of wall time the device completion stage is busy",
        )
        self._h_latency = _metrics.REGISTRY.histogram(
            "pathway_device_dispatch_complete_seconds",
            "device commit dispatch -> in-order completion latency",
            buckets=DISPATCH_BUCKETS,
        )
        self._c_commits = _metrics.REGISTRY.counter(
            "pathway_device_pipeline_commits_total",
            "device commits retired through the async pipeline",
        )

    # -- lifecycle -----------------------------------------------------------

    def configure(self) -> None:
        """Drain outstanding work and re-read the env knobs: tests and benches call
        this between runs instead of mutating the singleton."""
        self.drain()
        with self._cv:
            self._error = None
            self._completed_time = -1
            self._occ_mark = None
            self._occupancy = 0.0
            self._g_occ.value = 0.0
        self.controller = AdaptiveBatchController()

    def _ensure_worker(self) -> None:
        w = self._worker
        if w is None or not w.is_alive():
            with self._cv:
                self._stop = False
            self._worker = threading.Thread(
                target=self._run_completions,
                name="pw-device-pipeline",
                daemon=True,
            )
            self._worker.start()

    def stop_worker(self, timeout: float = 5.0) -> None:
        """Reap the completion thread (run teardown). It first retires anything still
        staged, so a clean run loses nothing; ``_ensure_worker`` respawns it on next
        use."""
        w = self._worker
        if w is None:
            return
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if w.is_alive():
            w.join(timeout=timeout)
        if not w.is_alive():
            self._worker = None

    def _take_error_locked(self) -> BaseException | None:
        err = self._error
        self._error = None
        return err

    def _raise_pending(self) -> None:
        with self._cv:
            err = self._take_error_locked()
        if err is not None:
            raise err

    # -- staging side (scheduler thread) ---------------------------------------

    def commit_boundary(self, time: int) -> None:
        """The end of a commit. Sync mode (``PATHWAY_TPU_ASYNC_DEVICE=0``): decay
        inline. Async mode: start every live handle's copy, stage the commit on the
        FIFO (blocking only while ``depth`` commits are in flight) and return. Resident
        batches are materialized first, so none outlives its commit."""
        _dres.decay_resident_batches()
        handles = _device.stage_device_batches()
        if not handles:
            return
        if not async_enabled():
            for handle in handles:
                handle.decay()
            return
        self._raise_pending()
        t0 = _time.perf_counter()
        for handle in handles:
            handle.prefetch()  # enqueue the copy here; never wait for it here
        self._ensure_worker()
        blocked = False
        ctx = _tracing.current()
        with self._cv:
            while (
                len(self._staged) + (1 if self._active_time is not None else 0)
                >= self.controller.depth
            ):
                blocked = True
                if ctx is not None:
                    bp0 = _time.perf_counter()
                self._cv.wait(timeout=60.0)
                if ctx is not None:
                    # the host blocked on the device stage: the queue-wait bucket
                    ctx.span("device-backpressure", "wait", bp0, _time.perf_counter(),
                             inflight=len(self._staged))
                err = self._take_error_locked()
                if err is not None:
                    raise err
            self._staged.append((int(time), handles, t0))
            self._g_depth.value = float(
                len(self._staged) + (1 if self._active_time is not None else 0)
            )
            self._cv.notify_all()
            staged_depth = len(self._staged)
            occupancy = self._occupancy
        self.controller.observe(
            staged_depth=staged_depth, blocked=blocked, occupancy=occupancy
        )

    # -- completion side (worker thread) ---------------------------------------

    def _run_completions(self) -> None:
        while True:
            with self._cv:
                # a bounded wait and the stop flag: an untimed wait could strand the
                # thread if the last notify races the run's teardown
                while not self._staged:
                    if self._stop:
                        return
                    self._cv.wait(timeout=0.5)
                time_, handles, t_dispatch = self._staged.popleft()
                self._active_time = time_
                self._g_depth.value = float(len(self._staged) + 1)
                self._cv.notify_all()
            t0 = _time.perf_counter()
            err: BaseException | None = None
            try:
                for handle in handles:
                    handle.decay()
            except BaseException as e:  # noqa: BLE001 — raised on the scheduler thread
                err = e
            t1 = _time.perf_counter()
            with self._cv:
                mark = self._occ_mark
                self._occ_mark = t1
                if mark is not None and t1 > mark:
                    ratio = min(1.0, (t1 - t0) / (t1 - mark))
                    self._occupancy = 0.8 * self._occupancy + 0.2 * ratio
                    self._g_occ.value = round(self._occupancy, 4)
                self._completed_time = time_
                self._active_time = None
                self._g_depth.value = float(len(self._staged))
                self._h_latency.observe(max(0.0, t1 - t_dispatch))
                self._c_commits.inc()
                if err is not None and self._error is None:
                    self._error = err
                self._cv.notify_all()

    # -- barriers (runner thread) ----------------------------------------------

    def drain_until(self, time: int) -> None:
        """Block until every staged commit at or before ``time`` has completed: the
        seam a checkpoint or a published snapshot of commit N waits on."""
        _dres.decay_resident_batches()
        if self._worker is None:
            return
        with self._cv:
            while (self._staged and self._staged[0][0] <= time) or (
                self._active_time is not None and self._active_time <= time
            ):
                self._cv.wait(timeout=60.0)
        self._raise_pending()

    def drain(self) -> None:
        """Complete everything in flight (run end, tests)."""
        _dres.decay_resident_batches()
        if self._worker is None:
            return
        with self._cv:
            while self._staged or self._active_time is not None:
                self._cv.wait(timeout=60.0)
        self._raise_pending()

    def reset(self) -> None:
        """Recovery: the in-flight commits belong to a timeline a rollback undoes.
        Completing them is still correct (decay only frees device memory and fills
        host twins), so drain, then drop any queued error."""
        try:
            self.drain()
        except BaseException:  # noqa: BLE001 — rolled-back work may not raise
            pass
        with self._cv:
            self._error = None
            self._completed_time = -1

    # -- read side -------------------------------------------------------------

    def inflight(self) -> int:
        with self._cv:
            return len(self._staged) + (1 if self._active_time is not None else 0)

    def completed_time(self) -> int:
        return self._completed_time

    def occupancy(self) -> float:
        return self._occupancy

    def stats(self) -> dict:
        """Roll-up for a bench's JSON line, with the device planes beside the pipe:
        the device operators' engagement and calls, the collective exchange's
        engagement and events, and the residency plane's transfer ledger."""
        return {
            "enabled": async_enabled(),
            "inflight": self.inflight(),
            "completed_commits": int(self._c_commits.value),
            "occupancy_ratio": round(self._occupancy, 4),
            "dispatch_complete_p50_ms": round(
                self._h_latency.quantile(0.5) * 1000.0, 3
            ),
            "dispatch_complete_p99_ms": round(
                self._h_latency.quantile(0.99) * 1000.0, 3
            ),
            "controller": self.controller.stats(),
            "device_ops": {"enabled": _dops.enabled(), "hit_counts": _dops.hit_counts()},
            "collective_exchange": {
                "enabled": _collective.enabled(),
                "events": dict(_collective.COLLECTIVE_STATS),
            },
            "device_residency": _dres.stats(),
        }


#: the process-wide pipeline every scheduler's commit boundary feeds
PIPELINE = DevicePipeline()


def commit_boundary(time: int) -> None:
    PIPELINE.commit_boundary(time)


def drain() -> None:
    PIPELINE.drain()


def drain_until(time: int) -> None:
    PIPELINE.drain_until(time)


def stop_worker() -> None:
    PIPELINE.stop_worker()


def reset() -> None:
    PIPELINE.reset()


def suggested_batch_size() -> int | None:
    """The controller's device micro-batch; None in sync mode (executors then use
    their configured cap). A ``BatchExecutor`` sizer only narrows its cap with it."""
    if not async_enabled():
        return None
    return PIPELINE.controller.batch_size


def ingest_window_scale() -> float:
    """The multiplier on connector autocommit windows: 1.0 when the pipeline is off or
    has nothing in flight, so host-only programs keep their commit cadence."""
    if not async_enabled() or PIPELINE.inflight() == 0:
        return 1.0
    return PIPELINE.controller.window_scale
