"""Continuous sampling profiler: phase-tagged flamegraphs.

Counterpart of ``pathway_tpu/internals/profiling.py``, with the same names, phase rules,
payloads and documents. The metrics plane answers *how much*, the tracer
(``internals/tracing.py``) *why for one commit*; this module answers *where host time
goes, all the time*: a daemon sampler walks every thread's stack
(``sys._current_frames()``), folds the stacks and tags each with the phase it was
caught in (ingest, operator, exchange, device, serving, other: the taxonomy of the
critical-path buckets), so a profile's phase totals reconcile with
``critical_path()`` shares (:func:`reconcile_with_critical_path`). The rules are path
fragments (``engine/device_pipeline``, ``engine/graph``, ...), so this package's frames
classify as the JAX package's do; the pipeline's completion thread, parked in a CUDA
event sync, classifies as ``device``.

- **default-off costs nothing**: nothing samples unless ``PATHWAY_TPU_PROFILE=1``
  (:meth:`SampleProfiler.maybe_start` is a boolean test when disabled);
- **self-limiting**: each tick measures its own cost and the period doubles when the
  duty cycle nears the 2% target, decaying back to the base rate
  (``PATHWAY_TPU_PROFILE_HZ``, default 50);
- **bounded**: at most ``MAX_STACKS`` distinct folded stacks are kept (overflow folds
  into a ``(truncated)`` leaf, so no weight is lost);
- **exported** by :meth:`SampleProfiler.export` into ``PATHWAY_TPU_PROFILE_DIR``:
  collapsed-stack text (:func:`folded_text`) and speedscope JSON (:func:`speedscope`)
  render the document, and :func:`validate_profile` checks it.

Every payload carries :func:`device_counters`: the kernel ns of both kernel planes and
the card's allocator (``torch.cuda.memory_stats``, keyed ``cuda:<i>``), read only once
this process has a CUDA context, so a scrape never makes one. The JAX package's
compile-cache and live-array gauges have no torch counterpart and are left out
(ROADMAP: deliberate differences). The mesh half: a follower's payload rides its round
frames to the leader, which :meth:`SampleProfiler.absorb` s it; the mesh's recovery and
rescale paths :meth:`~SampleProfiler.prune` dead or out-of-width peers; the mesh's resync
raises the epoch fence (``engine/distributed.py``, ``DistributedGraphRunner``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time as _time
import weakref
from typing import Any, Iterable

from pathway_tpu_torch.internals import metrics as _metrics

__all__ = [
    "PHASES",
    "SampleProfiler",
    "PROFILER",
    "classify_stack",
    "device_counters",
    "profile_document",
    "merge_documents",
    "phase_totals",
    "folded_text",
    "speedscope",
    "validate_profile",
    "reconcile_with_critical_path",
]

#: phase tags, mirroring the tracer's span taxonomy and critical-path buckets
PHASES = ("ingest", "operator", "exchange", "device", "serving", "other")

#: sampler duty-cycle share that triggers a period doubling — the same
#: target the adaptive trace sampler uses (half the 5% gate, headroom)
OVERHEAD_TARGET = 0.02

#: stack frames kept per sample (leaf-most wins; deeper is truncated)
MAX_DEPTH = 48

#: distinct folded stacks kept per worker before folding into
#: ``(truncated)`` — bounds payload and memory like tracing.MAX_SPANS
MAX_STACKS = 2048

#: profile document schema version (validate_profile checks it)
VERSION = 1

_TRUTHY = ("1", "true", "yes")

# leaf-to-root phase classification rules: (path fragment, function
# prefix or None) -> phase.  Ordered most-specific first; the first rule
# matching the leaf-most frame wins, so an operator process() reached
# through _exchange_rounds still classifies as "operator".
_PHASE_RULES: tuple[tuple[str, str | None, str], ...] = (
    ("serving/server", None, "serving"),
    ("serving/snapshot", None, "serving"),
    ("engine/device_pipeline", None, "device"),
    ("engine/device_ops", None, "device"),
    ("engine/device", None, "device"),
    ("engine/connectors", None, "ingest"),
    ("engine/routing", None, "exchange"),
    ("engine/distributed", "_exchange", "exchange"),
    ("engine/distributed", "_recv", "exchange"),
    ("engine/distributed", "_apply_remote", "exchange"),
    ("engine/distributed", "send", "exchange"),
    ("engine/distributed", "recv", "exchange"),
    ("engine/graph", None, "operator"),
    ("engine/reducers", None, "operator"),
    ("engine/expression", None, "operator"),
    ("engine/batch", None, "operator"),
    ("engine/temporal", None, "operator"),
    ("engine/external_index", None, "operator"),
)


def classify_stack(frames: Iterable[tuple[str, str]]) -> str:
    """Phase tag for one sampled stack: ``frames`` is leaf-first
    ``(filename, funcname)`` pairs; the first rule matching the
    leaf-most frame decides (so work reached *through* the exchange
    loop still attributes to the operator actually running)."""
    for filename, func in frames:
        path = filename.replace("\\", "/")
        for fragment, prefix, phase in _PHASE_RULES:
            if fragment in path and (
                prefix is None or func.startswith(prefix)
            ):
                return phase
    return "other"


def _frame_label(filename: str, func: str) -> str:
    base = os.path.basename(filename)
    if base.endswith(".py"):
        base = base[:-3]
    return f"{base}:{func}"


#: code object -> (its frame label, the phase of the first rule its frame matches, or
#: None): a tick then labels and classifies a stack with one lookup a frame, as
#: :func:`_frame_label` and :func:`classify_stack` would
_CODE_INFO: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _code_info(code: Any) -> tuple[str, str | None]:
    info = _CODE_INFO.get(code)
    if info is None:
        filename, func = code.co_filename, code.co_name
        phase = classify_stack([(filename, func)])
        info = _CODE_INFO[code] = (
            _frame_label(filename, func),
            None if phase == "other" else phase,
        )
    return info


def device_counters() -> dict:
    """Device-side counters folded into every payload: cumulative kernel nanoseconds
    across both kernel planes (the C++ host kernels and the device operators, the merge
    the tracer's critical path uses) and the card's allocator stats."""
    from pathway_tpu_torch.internals.tracing import _kernel_ns_snapshot

    out: dict = {}
    kernel_ns = _kernel_ns_snapshot()
    if kernel_ns:
        out["kernel_ns"] = kernel_ns
    out.update(_torch_telemetry())
    return out


#: (monotonic stamp, telemetry) cache, so a collector read on every scrape walks the
#: devices at most once a second
_TELEMETRY_LOCK = threading.Lock()
_TELEMETRY_CACHE: list = [float("-inf"), {}]  # guarded-by: _TELEMETRY_LOCK


def _torch_telemetry(max_age_s: float = 1.0) -> dict:
    """``{"memory": {"cuda:<i>": {bytes_in_use, peak_bytes_in_use, bytes_limit}}}``
    for each visible card whose caching allocator has reserved memory, from
    ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``; empty until this
    process has a CUDA context (``mem_get_info`` would make one). A card error
    raises."""
    with _TELEMETRY_LOCK:
        stamp, cached = _TELEMETRY_CACHE
        if _time.monotonic() - stamp < max_age_s:
            return dict(cached)
    fresh: dict = {}
    import torch

    if torch.cuda.is_initialized():
        memory: dict = {}
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats.get("reserved_bytes.all.peak", 0):
                continue  # never allocated on: it may have no context to read
            memory[f"cuda:{i}"] = {
                "bytes_in_use": int(stats["allocated_bytes.all.current"]),
                "peak_bytes_in_use": int(stats["allocated_bytes.all.peak"]),
                "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
            }
        if memory:
            fresh["memory"] = memory
    with _TELEMETRY_LOCK:
        _TELEMETRY_CACHE[0] = _time.monotonic()
        _TELEMETRY_CACHE[1] = fresh
    return dict(fresh)


def _device_telemetry_collector() -> list[tuple]:
    """Registry pull collector: the card allocator's gauges."""
    out: list[tuple] = []
    for dev, stats in (_torch_telemetry().get("memory") or {}).items():
        for stat, value in stats.items():
            out.append(
                (
                    "pathway_device_memory_bytes",
                    "gauge",
                    "device allocator stats (torch.cuda.memory_stats)",
                    {"device": dev, "stat": stat},
                    value,
                )
            )
    return out


_metrics.REGISTRY.register_collector(_device_telemetry_collector)


def _tick_handles() -> tuple:
    return (
        _metrics.REGISTRY.histogram(
            "pathway_profile_sample_seconds",
            "wall cost of one profiler sampling tick",
            buckets=(1e-5, 1e-4, 1e-3, 1e-2, 0.1),
        ),
        _metrics.REGISTRY.counter(
            "pathway_profile_samples_total",
            "stack samples aggregated by the profiler",
        ),
        _metrics.REGISTRY.gauge(
            "pathway_profile_rate_hz",
            "current (adaptive) profiler sampling rate",
        ),
    )


class SampleProfiler:
    """Process-wide sampling profiler (singleton: :data:`PROFILER`).

    The engine's only contact points are :meth:`maybe_start` (a boolean
    test when profiling is off) and :meth:`stop`; :meth:`payload` and
    :meth:`export` read the aggregate, and :meth:`absorb` / :meth:`prune`
    are the mesh leader's (their callers come with the distributed
    runner)."""

    def __init__(
        self, enabled: bool | None = None, hz: float | None = None
    ) -> None:
        self._lock = threading.Lock()
        #: (phase, folded-stack) -> [weight_s, count]; the sampler
        #: thread accumulates while payload()/export() snapshot
        self._folded: dict[tuple[str, str], list] = {}  # guarded-by: self._lock
        #: peer id -> latest epoch-current payload (leader side)
        self._peers: dict[int, dict] = {}  # guarded-by: self._lock
        self._thread: threading.Thread | None = None  # guarded-by: self._lock
        self._stop = threading.Event()
        self._started_mono = 0.0
        self._seq = 0  # guarded-by: self._lock
        self._export_seq = 0
        self._samples = 0  # guarded-by: self._lock
        self._dropped = 0  # guarded-by: self._lock
        self._overhead_ema: float | None = None
        #: (tick histogram, sample counter, rate gauge), made at start
        self._handles: tuple | None = None
        #: mesh recovery fence — raised by resync()/failover alongside
        #: TRACER.epoch; payloads stamped below it are zombies
        self.epoch = 0
        self.period = 0.0
        self.configure(enabled=enabled, hz=hz)

    # -- configuration -------------------------------------------------------

    def configure(
        self,
        enabled: bool | None = None,
        hz: float | None = None,
        clear: bool = False,
    ) -> None:
        """(Re)read the knobs; tests and benches call this directly
        instead of mutating the environment."""
        if enabled is None:
            enabled = (
                os.environ.get("PATHWAY_TPU_PROFILE", "").lower() in _TRUTHY
            )
        if hz is None:
            try:
                hz = float(os.environ.get("PATHWAY_TPU_PROFILE_HZ", "50"))
            except ValueError:
                hz = 50.0
        self.enabled = bool(enabled)
        self.base_period = 1.0 / max(1e-3, float(hz))
        self.period = self.base_period
        try:
            self.worker_id = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
        except ValueError:
            self.worker_id = 0
        self._overhead_ema = None
        if clear:
            with self._lock:
                self._folded.clear()
                self._peers.clear()
                self._samples = 0
                self._dropped = 0

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def maybe_start(self) -> bool:
        """Start the daemon sampler thread if profiling is enabled and it is not running
        yet. Returns True when a thread runs after the call; the default-off path is one
        boolean test and no thread ever exists."""
        if not self.enabled:
            return False
        with self._lock:
            if self.running:
                return True
            self._stop.clear()
            self._started_mono = _time.monotonic()
            self._handles = _tick_handles()
            self._thread = threading.Thread(
                target=self._run, name="pathway-profiler", daemon=True
            )
            self._thread.start()
        return True

    def stop(self) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None and thread.is_alive():
            self._stop.set()
            thread.join(timeout=2.0)

    # -- sampling ------------------------------------------------------------

    def _run(self) -> None:
        """The daemon thread's loop: a tick every period, its own stack left out."""
        own_tid = threading.get_ident()
        last = _time.monotonic()
        while not self._stop.wait(self.period):
            t0 = _time.perf_counter()
            now = _time.monotonic()
            weight = max(0.0, now - last)
            last = now
            try:
                frames = sys._current_frames()
            except Exception:
                continue
            self._tick(frames, own_tid, weight, t0)
            del frames

    def _tick(self, frames: dict, own_tid: int, weight: float, t0: float) -> None:
        """Fold one sample of ``frames``, time it and adapt the period to its cost."""
        n = self._ingest(frames, own_tid, weight)
        cost = _time.perf_counter() - t0
        tick_hist, samples_ctr, rate_gauge = self._handles
        tick_hist.observe(cost)
        samples_ctr.inc(n)
        self._adapt(cost)
        rate_gauge.set(1.0 / max(self.period, 1e-9))

    def _ingest(self, frames: dict, own_tid: int, weight: float) -> int:
        n = 0
        for tid, top in frames.items():
            if tid == own_tid:
                continue
            labels: list[str] = []
            phase = None
            frame = top
            depth = 0
            while frame is not None and depth < MAX_DEPTH:
                label, frame_phase = _code_info(frame.f_code)
                labels.append(label)
                if phase is None:
                    phase = frame_phase  # the leaf-most frame a rule matches decides
                frame = frame.f_back
                depth += 1
            if not labels:
                continue
            labels.reverse()
            key = (phase or "other", ";".join(labels))
            n += 1
            with self._lock:
                cell = self._folded.get(key)
                if cell is None:
                    if len(self._folded) >= MAX_STACKS:
                        # keep the weight, lose the detail: overflow
                        # folds into a per-phase synthetic leaf
                        self._dropped += 1
                        key = (phase, "(truncated)")
                        cell = self._folded.get(key)
                        if cell is None:
                            cell = self._folded[key] = [0.0, 0]
                    else:
                        cell = self._folded[key] = [0.0, 0]
                cell[0] += weight
                cell[1] += 1
                self._samples += 1
        return n

    def _adapt(self, cost_s: float) -> None:
        """Keep the sampler duty cycle under the overhead target:
        double the period when one tick's cost is too large a share of
        the period, decay back toward the configured base when the cost
        is comfortably below it (mirrors TraceRecorder._adapt)."""
        ratio = cost_s / max(self.period, 1e-9)
        ema = self._overhead_ema
        self._overhead_ema = ratio if ema is None else 0.5 * ema + 0.5 * ratio
        if self._overhead_ema > OVERHEAD_TARGET:
            self.period = min(self.period * 2.0, 2.0)
            self._overhead_ema /= 2.0  # doubling halves the duty cycle
        elif (
            self.period > self.base_period
            and self._overhead_ema < OVERHEAD_TARGET / 4.0
        ):
            self.period = max(self.base_period, self.period / 2.0)
            self._overhead_ema *= 2.0

    # -- payloads ------------------------------------------------------------

    def payload(self) -> dict:
        """This worker's picklable profile payload — what a quiet
        follower embeds (as ``"__profile__"``) in the metrics snapshot
        it already piggybacks to the leader.  Latest-wins per worker:
        ``seq`` increases monotonically."""
        with self._lock:
            self._seq += 1
            samples = [
                [phase, stack, round(cell[0], 6), cell[1]]
                for (phase, stack), cell in self._folded.items()
            ]
            seq = self._seq
            dropped = self._dropped
            total = self._samples
        return {
            "v": VERSION,
            "worker": self.worker_id,
            "pid": os.getpid(),
            "seq": seq,
            "epoch": self.epoch,
            "wall_s": round(
                max(0.0, _time.monotonic() - self._started_mono), 6
            )
            if self._started_mono
            else 0.0,
            "rate_hz": round(1.0 / max(self.period, 1e-9), 3),
            "samples": samples,
            "sample_count": total,
            "dropped_stacks": dropped,
            "device": device_counters(),
        }

    def absorb(self, peer: int, payload: dict) -> bool:
        """Leader-side: keep a peer's piggybacked payload.  A payload
        stamped with an epoch below this process's fence floor is a
        zombie incarnation's — dropped (and counted) instead of merged;
        a current payload raises the floor."""
        try:
            epoch = int(payload.get("epoch", 0))
        except (TypeError, ValueError):
            return False
        if epoch < self.epoch:
            _metrics.REGISTRY.counter(
                "pathway_profile_fenced_total",
                "stale-epoch profile payloads dropped at absorption",
            ).inc(1)
            return False
        self.epoch = max(self.epoch, epoch)
        with self._lock:
            prev = self._peers.get(peer)
            if prev is not None and prev.get("seq", 0) > payload.get("seq", 0):
                return False  # reordered older payload: latest wins
            self._peers[int(peer)] = payload
        return True

    def prune(self, dead: Iterable[int] = (), width: int | None = None) -> None:
        """Drop absorbed payloads of peers that no longer exist —
        mirrors ``DistributedScheduler.prune_mesh_metrics`` so a merged
        export never shows dead workers."""
        gone = set(dead)
        with self._lock:
            for peer in list(self._peers):
                if peer in gone or (width is not None and peer >= width):
                    self._peers.pop(peer, None)

    def mesh_payloads(self) -> dict[int, dict]:
        """Worker-keyed payloads for one merged document: this worker's
        live payload plus every absorbed epoch-current peer payload."""
        with self._lock:
            peers = {
                p: payload
                for p, payload in self._peers.items()
                if int(payload.get("epoch", 0)) >= self.epoch
            }
        out: dict[int, dict] = {}
        if self.running or self._folded:
            out[self.worker_id] = self.payload()
        out.update(peers)
        return out

    # -- export --------------------------------------------------------------

    def export(self, directory: str | None = None) -> str | None:
        """Dump one merged profile document
        (``pathway_profile_p<worker>_pid<pid>_<n>.json``) into
        ``directory`` / ``PATHWAY_TPU_PROFILE_DIR`` / the system temp
        dir.  Returns the path, or None when there is nothing to dump
        or the dump itself fails (export must never mask a run)."""
        doc = profile_document(self.mesh_payloads())
        if not doc["workers"]:
            return None
        try:
            directory = (
                directory
                or os.environ.get("PATHWAY_TPU_PROFILE_DIR")
                or tempfile.gettempdir()
            )
            os.makedirs(directory, exist_ok=True)
            self._export_seq += 1
            path = os.path.join(
                directory,
                f"pathway_profile_p{self.worker_id}"
                f"_pid{os.getpid()}_{self._export_seq:03d}.json",
            )
            with open(path, "w") as fh:
                json.dump(doc, fh, default=repr)
            return path
        except Exception:
            return None


# -- documents ----------------------------------------------------------------


def profile_document(payloads: dict[int, dict]) -> dict:
    """One merged, export-ready document from worker-keyed payloads:
    the shape ``cli profile`` consumes, ``validate_profile`` checks,
    and the speedscope/folded renderers read."""
    workers = {
        str(wid): payload for wid, payload in sorted(payloads.items())
    }
    return {
        "version": VERSION,
        "workers": workers,
        "phases": phase_totals({"workers": workers}),
    }


def merge_documents(docs: Iterable[dict]) -> dict:
    """Merge per-process export files into one document — latest
    ``seq`` wins per worker (each worker re-exports cumulative state,
    so later files supersede earlier ones)."""
    best: dict[str, dict] = {}
    for doc in docs:
        for wid, payload in (doc.get("workers") or {}).items():
            prev = best.get(str(wid))
            if prev is None or payload.get("seq", 0) >= prev.get("seq", 0):
                best[str(wid)] = payload
    return {
        "version": VERSION,
        "workers": best,
        "phases": phase_totals({"workers": best}),
    }


def phase_totals(doc: dict) -> dict[str, float]:
    """Aggregate sampled weight (seconds) per phase across every
    worker of a document — the side that reconciles against the tracer's
    critical-path buckets."""
    totals: dict[str, float] = {}
    for payload in (doc.get("workers") or {}).values():
        for phase, _stack, weight, _count in payload.get("samples", ()):
            totals[phase] = totals.get(phase, 0.0) + float(weight)
    return {k: round(v, 6) for k, v in sorted(totals.items())}


def folded_text(doc: dict) -> str:
    """Collapsed-stack text (flamegraph.pl / speedscope importable):
    one ``worker<i>;<phase>;frame;frame count`` line per folded stack,
    sample counts as weights."""
    lines = []
    for wid in sorted(doc.get("workers") or {}, key=lambda w: str(w)):
        payload = doc["workers"][wid]
        for phase, stack, _weight, count in sorted(
            payload.get("samples", ())
        ):
            lines.append(f"worker{wid};{phase};{stack} {int(count)}")
    return "\n".join(lines) + "\n" if lines else ""


def speedscope(doc: dict) -> dict:
    """Render a document as speedscope JSON
    (https://www.speedscope.app/file-format-schema.json): one
    ``sampled`` profile per worker sharing a frame table; each folded
    stack becomes one sample whose weight is its sampled seconds."""
    frames: list[dict] = []
    index: dict[str, int] = {}

    def frame_of(name: str) -> int:
        i = index.get(name)
        if i is None:
            i = index[name] = len(frames)
            frames.append({"name": name})
        return i

    profiles = []
    for wid in sorted(doc.get("workers") or {}, key=lambda w: str(w)):
        payload = doc["workers"][wid]
        samples: list[list[int]] = []
        weights: list[float] = []
        for phase, stack, weight, _count in payload.get("samples", ()):
            chain = [frame_of(f"[{phase}]")]
            chain.extend(frame_of(part) for part in stack.split(";") if part)
            samples.append(chain)
            weights.append(round(float(weight), 6))
        total = round(sum(weights), 6)
        profiles.append(
            {
                "type": "sampled",
                "name": f"worker {wid}",
                "unit": "seconds",
                "startValue": 0,
                "endValue": total,
                "samples": samples,
                "weights": weights,
            }
        )
    # the same name and exporter tag as the JAX package's, so both render one
    # document alike
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": profiles,
        "name": "pathway_tpu profile",
        "activeProfileIndex": 0,
        "exporter": "pathway_tpu.internals.profiling",
    }


def validate_profile(doc: Any) -> dict:
    """Strict invariant check over a profile document (the export
    schema gate): version match, well-formed
    per-worker payloads, known phase tags, non-negative finite
    weights, and a structurally sound speedscope rendering (every
    sample indexes a shared frame, one weight per sample, endValue
    equal to the weight sum).  Returns the document; raises
    ``ValueError`` on any violation."""
    if not isinstance(doc, dict):
        raise ValueError(f"not a profile document: {type(doc).__name__}")
    if doc.get("version") != VERSION:
        raise ValueError(f"unsupported profile version {doc.get('version')!r}")
    workers = doc.get("workers")
    if not isinstance(workers, dict) or not workers:
        raise ValueError("profile document has no workers")
    for wid, payload in workers.items():
        if not isinstance(payload, dict):
            raise ValueError(f"worker {wid}: payload is not an object")
        if int(payload.get("epoch", -1)) < 0:
            raise ValueError(f"worker {wid}: missing/negative epoch")
        samples = payload.get("samples")
        if not isinstance(samples, list):
            raise ValueError(f"worker {wid}: samples is not a list")
        for i, sample in enumerate(samples):
            if not isinstance(sample, (list, tuple)) or len(sample) != 4:
                raise ValueError(
                    f"worker {wid} sample {i}: not a "
                    "[phase, stack, weight, count] quad"
                )
            phase, stack, weight, count = sample
            if phase not in PHASES:
                raise ValueError(
                    f"worker {wid} sample {i}: unknown phase {phase!r}"
                )
            if not isinstance(stack, str) or not stack:
                raise ValueError(f"worker {wid} sample {i}: empty stack")
            w = float(weight)
            if not (w >= 0.0) or w != w or w == float("inf"):
                raise ValueError(
                    f"worker {wid} sample {i}: bad weight {weight!r}"
                )
            if int(count) < 1:
                raise ValueError(
                    f"worker {wid} sample {i}: count {count!r} < 1"
                )
    rendered = speedscope(doc)
    n_frames = len(rendered["shared"]["frames"])
    for prof in rendered["profiles"]:
        if len(prof["samples"]) != len(prof["weights"]):
            raise ValueError(f"{prof['name']}: samples/weights mismatch")
        for chain in prof["samples"]:
            if not chain:
                raise ValueError(f"{prof['name']}: empty sample chain")
            for idx in chain:
                if not (0 <= idx < n_frames):
                    raise ValueError(
                        f"{prof['name']}: frame index {idx} out of range"
                    )
        total = sum(prof["weights"])
        if abs(total - prof["endValue"]) > 1e-3 + 1e-6 * max(1.0, total):
            raise ValueError(
                f"{prof['name']}: endValue {prof['endValue']} != "
                f"weight sum {total}"
            )
    return doc


# -- reconciliation with critical-path buckets --------------------------------

#: profile phase -> critical-path bucket.  Serving is excluded: queries
#: run concurrently with commits and are attributed separately by the
#: tracer (record_query), so they have no commit bucket to land in.
PHASE_TO_BUCKET = {
    "ingest": "queue_wait",
    "exchange": "exchange",
    "device": "device",
    "operator": "host_compute",
    "other": "host_compute",
}


def reconcile_with_critical_path(doc: dict, cp: dict) -> dict:
    """Compare a profile's phase mix against a critical-path breakdown
    (one ``critical_path()`` dict or a ``critical_path_mean`` roll-up):
    both sides normalize to bucket fractions, and ``max_abs_diff`` is
    the largest disagreement — tests assert it stays within sampling
    error on synthetic data and a loose bound live."""
    totals = phase_totals(doc) if "workers" in doc else dict(doc)
    prof_buckets: dict[str, float] = {
        b: 0.0 for b in ("queue_wait", "exchange", "device", "host_compute")
    }
    for phase, weight in totals.items():
        bucket = PHASE_TO_BUCKET.get(phase)
        if bucket is not None:
            prof_buckets[bucket] += float(weight)
    prof_total = sum(prof_buckets.values())
    prof_frac = {
        b: (v / prof_total if prof_total > 0 else 0.0)
        for b, v in prof_buckets.items()
    }
    shares = cp.get("shares")
    if shares is None:
        wall = max(float(cp.get("wall_s", 0.0)), 1e-9)
        shares = {
            "queue_wait": float(cp.get("queue_wait_s", 0.0)) / wall,
            "exchange": float(cp.get("exchange_s", 0.0)) / wall,
            "device": float(cp.get("device_s", 0.0)) / wall,
            "host_compute": float(cp.get("host_compute_s", 0.0)) / wall,
        }
    trace_frac = {b: float(shares.get(b, 0.0)) for b in prof_frac}
    diffs = {b: abs(prof_frac[b] - trace_frac[b]) for b in prof_frac}
    return {
        "profile": {b: round(v, 4) for b, v in prof_frac.items()},
        "trace": {b: round(v, 4) for b, v in trace_frac.items()},
        "max_abs_diff": round(max(diffs.values()) if diffs else 0.0, 4),
    }


#: the process-wide profiler every runtime surface consults
PROFILER = SampleProfiler()
