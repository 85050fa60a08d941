"""The collective exchange: a columnar repartition moved on the card instead of by the
host gather.

Counterpart of ``pathway_tpu/engine/collective_exchange.py``. When every destination
worker of a repartition sits in this process (the in-process
:class:`~pathway_tpu_torch.engine.sharded.ShardedScheduler`, or a
:class:`~pathway_tpu_torch.engine.distributed.DistributedScheduler` delivering to its
own workers), the batch's raw bytes go to the device once, one kernel puts every row in
its destination's place, and each destination's rows come back as a
:class:`~pathway_tpu_torch.engine.batch.Columns`, or stay on the device as a
:class:`~pathway_tpu_torch.engine.device_residency.DeviceResidentColumns` when the
consumer is a device operator.

Mechanics (bit for bit by construction: the kernel only moves bytes):

1. **pack**: the 16-byte key digests, the diff vector if any, and every fixed-width
   column, viewed as little-endian bytes, side by side in one ``(n_rows, W)`` uint8
   matrix (:func:`_pack_payload`, byte for byte the reference's wire layout). An object
   or void column cannot travel raw: the batch declines (``None``) and the caller's host
   path delivers it.
2. **order**: ``perm = np.argsort(shards, kind="stable")`` and the destinations' row
   counts, on the host. Within a destination the rows keep ascending source index,
   which is the order of the host path's ``np.flatnonzero(shards == d)``.
3. **swap**: ``ops/bucket_swap.py::bucket_swap`` (``csrc/bucket_swap.cu`` on the card)
   gathers the payload by ``perm`` into one destination-major matrix. Destination d's
   rows are ``out[dest_off[d]:dest_off[d + 1]]``.
4. **unpack**: one fetch of the whole output and one :func:`_unpack_rows` per
   destination; or, under residency, each destination's slice of the output (no copy)
   wrapped as a resident batch, whose diffs alone are fetched at once.

Deliberate differences from the reference (ROADMAP, "deliberate differences"):

- **No padded buffer.** The reference's XLA program needs static shapes, so it pads the
  source chunk and the bucket depth to powers of two and swaps ``n * n * depth`` rows.
  Here the counts are known on the host before the launch, so the output is compacted;
  the transfer ledger counts the real bytes, and no padded tail is saved or counted.
- **The mesh rule.** In auto mode the reference's rule stands: one device per shard
  (:func:`mesh_ready`). Such a mesh spans several cards, and the swap across cards
  (peer copies or NCCL) comes with ROADMAP queue 1 item 6, so an auto-mode exchange
  declines to the host gather; on one card auto never engages, as the reference never
  does on one chip. In forced mode the shards share the device the device operators are
  configured for (``engine/device_ops.py::device``): the card, or the CPU where the
  caller configured ``device="cpu"``, the port's stand-in for the simulated devices the
  reference's tests run on.

Control surface, read on every call: ``PATHWAY_TPU_COLLECTIVE_EXCHANGE=0`` off, the host
gather is the spec; ``=1`` forced, every codeable repartition with at least two shards;
unset auto, on when the configured device is a CUDA device (and then declining until
item 6, as above). The reference's per-edge host-or-device policy and its
``PATHWAY_TPU_COLLECTIVE_MIN_ROWS`` threshold only act in auto mode, so they come with
item 6, when auto mode has a path that engages and a measurement to set them by.

A decline (``None``) always comes before any push, so the caller's host path delivers
the whole batch: the rollback seam. A decline happens only before any device work (not
enabled, mesh not ready, a column that cannot travel raw). Once the batch is on the
device, a failure raises, as every kernel of the port does: a swap that does not launch,
a CUDA fault, a resident egress that cannot be wrapped. The reference instead declines
on any device error and fetches its whole buffer when the resident trim fails; the port
moves no work back to the host behind a failing card.

Observability: ``pathway_collective_exchange_events_total{kind}`` (mirrors
:data:`COLLECTIVE_STATS`), ``pathway_collective_exchange_ns_total`` and
``pathway_collective_exchange_bytes_total``; the tracing spans ``collective-pack`` and
``collective-unpack`` in the ``exchange`` bucket; the swap's wall through
``device_ops.record_kernel("collective_exchange.all_to_all", ns)``.
"""

from __future__ import annotations

import os
import time as _time
from typing import TYPE_CHECKING

import numpy as np
import torch

from pathway_tpu_torch.internals import metrics as _metrics
from pathway_tpu_torch.internals import tracing as _tracing
from pathway_tpu_torch.ops.bucket_swap import bucket_swap, prepare

if TYPE_CHECKING:  # pragma: no cover
    from pathway_tpu_torch.engine.batch import Columns

__all__ = [
    "COLLECTIVE_STATS",
    "enabled",
    "exchange",
    "forced",
    "mesh_ready",
    "reset_counters",
    "stats",
]

#: the exchange's event counters, mirrored into
#: ``pathway_collective_exchange_events_total{kind=...}``
COLLECTIVE_STATS = _metrics.MirroredCounterDict(
    "pathway_collective_exchange_events_total",
    "kind",
    {
        "exchanges": 0,  # batches repartitioned on the device
        "declined_non_codeable": 0,  # an object or void column: the host path
    },
    help="collective exchange events by kind (mirrors COLLECTIVE_STATS)",
)

_C_NS = _metrics.REGISTRY.counter(
    "pathway_collective_exchange_ns_total",
    "total wall ns spent in collective exchanges (pack+kernel+unpack)",
)
_C_BYTES = _metrics.REGISTRY.counter(
    "pathway_collective_exchange_bytes_total",
    "payload bytes repartitioned through the device collective",
)

_FORCE = ("1", "true", "on", "yes", "force")
_OFF = ("0", "false", "off", "no")


def _raw() -> str:
    return os.environ.get("PATHWAY_TPU_COLLECTIVE_EXCHANGE", "").strip().lower()


def enabled() -> bool:
    """Whether the collective may engage at all (the contract above)."""
    raw = _raw()
    if raw in _OFF:
        return False
    if raw in _FORCE:
        return True
    from pathway_tpu_torch.engine import device_ops as _dops

    return _dops.configured_on_card()


def forced() -> bool:
    """True under ``PATHWAY_TPU_COLLECTIVE_EXCHANGE=1``: every codeable repartition
    takes the collective, and the shards share the configured device."""
    return _raw() in _FORCE


def mesh_ready(n_shards: int) -> bool:
    """The mesh rule: at least two shards, and in auto mode one CUDA device per shard
    (the reference's rule); in forced mode the shards share the configured device, so
    any count of two or more holds. Never raises."""
    if n_shards < 2:
        return False
    if forced():
        return True
    return torch.cuda.device_count() >= n_shards


# -- the wire layout -------------------------------------------------------------------


def _as_bytes(arr: np.ndarray, width: int) -> np.ndarray:
    """(n, width) raw-byte view of a fixed-width 1-D array."""
    arr = np.ascontiguousarray(arr)
    try:
        return arr.view(np.uint8).reshape(len(arr), width)
    except (TypeError, ValueError):
        return np.frombuffer(arr.tobytes(), np.uint8).reshape(len(arr), width)


def _pack_payload(columns: "Columns"):
    """keys | diffs | columns as one ``(n, W)`` uint8 matrix: ``(payload, layout,
    has_diffs)``, or ``(None, None, False)`` when a column cannot travel raw (object or
    void dtype) or the keys cannot be derived (the decline)."""
    n = columns.n
    try:
        kb = np.ascontiguousarray(columns.kbytes(), np.uint8)
    except Exception:  # noqa: BLE001 — underivable keys decline to the host path
        return None, None, False
    segs = [kb.reshape(n, 16)]
    has_diffs = columns.diffs is not None
    if has_diffs:
        segs.append(_as_bytes(np.ascontiguousarray(columns.diffs, np.int64), 8))
    layout: list[tuple] = []
    for col in columns.cols:
        if col.dtype.kind in "OV":
            return None, None, False
        width = col.dtype.itemsize
        segs.append(_as_bytes(col, width))
        layout.append((col.dtype, width))
    return np.concatenate(segs, axis=1), layout, has_diffs


def _unpack_rows(rows: np.ndarray, layout: list, has_diffs: bool) -> "Columns":
    """The inverse of :func:`_pack_payload` for one destination's rows."""
    from pathway_tpu_torch.engine.batch import Columns

    m = len(rows)
    kb = np.ascontiguousarray(rows[:, :16])
    off = 16
    diffs = None
    if has_diffs:
        diffs = np.ascontiguousarray(rows[:, off : off + 8]).view(np.int64).ravel()
        off += 8
    cols = []
    for dtype, width in layout:
        seg = np.ascontiguousarray(rows[:, off : off + width])
        cols.append(seg.view(dtype).ravel())
        off += width
    return Columns(m, cols, kbytes=kb, diffs=diffs)


# -- the exchange ------------------------------------------------------------------------


def exchange(
    edge: int,
    columns: "Columns",
    shards: np.ndarray,
    n: int,
    consumer=None,
) -> "list[Columns | None] | None":
    """Repartition ``columns`` by the precomputed ``shards`` vector over ``n`` workers.
    Returns one :class:`Columns` per destination (``None`` where a destination gets no
    rows), or ``None`` to decline (not enabled, mesh not ready, an auto-mode mesh across
    cards, a column not codeable); a decline comes before any device work, and the
    caller's host path then delivers the batch. A failure on the device raises.

    The residency plane hooks both ends: a still-resident input re-packs from its
    device rows (the wire layout is the resident layout), so only ``perm`` is uploaded;
    and when ``consumer`` is a device operator whose seam may stay resident
    (``device_residency.consumer_resident_ok``), each destination's slice of the
    output is delivered as a resident batch. Transfers are counted in both modes."""
    n_rows = columns.n
    if n_rows == 0 or not enabled() or not mesh_ready(n):
        return None
    if not forced():
        # auto: one card per shard, a mesh across cards; the swap across cards is
        # ROADMAP queue 1 item 6, until then the host gather delivers
        return None
    from pathway_tpu_torch.engine import device_ops as _dops
    from pathway_tpu_torch.engine import device_residency as _dres

    dev = _dops.device()
    prepare(dev)  # a failed build raises here, before anything is packed
    trace = _tracing.current()
    t0 = _time.perf_counter()
    dev_payload = None
    payload = None
    if isinstance(columns, _dres.DeviceResidentColumns):
        dev_payload = columns.device_rows()
    if dev_payload is not None:
        layout, has_diffs = columns.layout, columns.has_diffs
        payload_nbytes = n_rows * int(dev_payload.shape[1])
    else:
        payload, layout, has_diffs = _pack_payload(columns)
        if payload is None:
            COLLECTIVE_STATS["declined_non_codeable"] += 1
            return None
        payload_nbytes = int(payload.nbytes)
    p1 = _time.perf_counter()
    if trace is not None:
        # the exchange bucket takes the byte marshalling only, as the host path's
        # encode span; the ordering below is routing work, as columnar_shards is
        trace.span("collective-pack", "exchange", t0, p1, rows=n_rows, bytes=payload_nbytes,
                   edge=edge)
    shards64 = shards.astype(np.int64, copy=False)
    # a stable sort by destination keeps ascending source index within each one
    perm = np.argsort(shards64, kind="stable").astype(np.int32)
    dest_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(shards64, minlength=n), out=dest_off[1:])
    k0 = _time.perf_counter()
    perm_d = torch.from_numpy(perm).to(dev)
    if dev_payload is not None:
        payload_d = dev_payload
        _dres.record_h2d(perm.nbytes)  # only the order crosses
        _dres.record_saved(payload_nbytes)
        _dres.RESIDENCY_STATS["device_consumes"] += 1
    else:
        payload_d = torch.from_numpy(payload).to(dev)
        _dres.record_h2d(payload.nbytes + perm.nbytes)
    out_d = bucket_swap(payload_d, perm_d)
    resident_out = _dres.consumer_resident_ok(consumer)
    fetched = None
    if not resident_out:
        fetched = out_d.cpu().numpy()
        _dres.record_d2h(fetched.nbytes)
    k1 = _time.perf_counter()
    seam_key = _dres.consumer_seam_key(consumer) if resident_out else None
    parts: list = [None] * n
    for d in range(n):
        lo, hi = int(dest_off[d]), int(dest_off[d + 1])
        if hi == lo:
            continue
        if resident_out:
            parts[d] = _dres.DeviceResidentColumns.from_device_rows(
                out_d[lo:hi], layout, has_diffs, seam_key=seam_key
            )
        else:
            parts[d] = _unpack_rows(fetched[lo:hi], layout, has_diffs)
    _dops.record_kernel("collective_exchange.all_to_all", int((k1 - k0) * 1e9))
    t1 = _time.perf_counter()
    if trace is not None:
        trace.span("collective-unpack", "exchange", k1, t1, rows=n_rows, edge=edge,
                   resident=bool(resident_out))
    COLLECTIVE_STATS["exchanges"] += 1
    _C_NS.inc(int((t1 - t0) * 1e9))
    _C_BYTES.inc(float(payload_nbytes))
    return parts


def stats() -> dict:
    """Roll-up for a run's report."""
    return {
        "enabled": enabled(),
        "forced": forced(),
        "events": dict(COLLECTIVE_STATS),
        "ns_total": int(_C_NS.value),
        "bytes_total": int(_C_BYTES.value),
    }


def reset_counters() -> None:
    """Zero the event counters and the ns and bytes counters."""
    for key in list(COLLECTIVE_STATS):
        COLLECTIVE_STATS[key] = 0
    _C_NS.value = 0.0
    _C_BYTES.value = 0.0
