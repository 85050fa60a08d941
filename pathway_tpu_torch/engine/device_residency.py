"""The residency plane: exchange outputs kept on the device between device operators,
the transfer accounting, the commit-boundary decay and the seam keys placement reads.

Counterpart of ``pathway_tpu/engine/device_residency.py``. The collective exchange
(``engine/collective_exchange.py``) can deliver each destination's rows as a
:class:`DeviceResidentColumns`: a :class:`~pathway_tpu_torch.engine.batch.Columns`
whose packed bytes (16-byte key digest | int64 diff | fixed-width columns, the
exchange's wire layout) stay on the device, a zero-copy slice of the swap's output,
while the host keeps only the row count, the layout and the diffs, fetched at once
(every delivery path reads them). Any host access (``cols``, ``kbytes()``, ``gather``,
...) materializes the batch with one trimmed copy to the host, decoded as the
exchange's host path decodes it, so a consumer that cannot read device buffers pays
the copy it would have paid anyway. A consumer that can reads
:meth:`DeviceResidentColumns.device_column` (the join's int64 key twin, which the pair
matcher consumes in place of an upload) or :meth:`DeviceResidentColumns.device_rows`
(the exchange re-packing a resident batch) and skips the transfer.

- **transfer accounting**: :func:`record_h2d` / :func:`record_d2h` count every copy the
  device planes make between the host and the device (the exchange's payload and
  order, its fetch, a materialization, the segment reduction's upload and fetch, the
  matcher's key uploads and index fetch), in
  ``pathway_device_transfer_{h2d,d2h}_{events,bytes}_total``; :func:`record_saved`
  counts bytes that stayed resident instead of crossing.
- **the commit-boundary decay**: :func:`decay_resident_batches`, called from
  ``device_pipeline.commit_boundary`` / ``drain_until`` / ``drain``, materializes every
  resident batch that outlives its commit and drops its device buffer, so device memory
  stays bounded by one commit and a checkpoint sees host state only.
- **the seam keys**: :func:`consumer_seam_key` and :func:`consumer_resident_ok`, read
  from the placement pass's annotations (``_device_ops_eligible``,
  ``_device_residency_downstream``); a materialization reports its cost to the
  consumer's seam (``PlacementPolicy.record_seam``), which credits chain-aware
  placement.

Control surface, ``PATHWAY_TPU_DEVICE_RESIDENCY``: ``0`` off; ``1`` forced; unset auto,
on when the device operators' configured device is a CUDA device (the port's reading of
the JAX package's "a real accelerator backend"), and then only while the consumer's
measured placement has it on the card. The variable is read on every call.
"""

from __future__ import annotations

import os
import time as _time
import weakref

import numpy as np
import torch

from pathway_tpu_torch.engine.batch import Columns
from pathway_tpu_torch.internals import metrics as _metrics
from pathway_tpu_torch.internals import tracing as _tracing

__all__ = [
    "DeviceResidentColumns",
    "RESIDENCY_STATS",
    "consumer_resident_ok",
    "consumer_seam_key",
    "decay_resident_batches",
    "enabled",
    "forced",
    "live_resident_batches",
    "record_d2h",
    "record_h2d",
    "record_saved",
    "reset_counters",
    "stats",
]

#: the plane's event counters, mirrored into
#: ``pathway_device_residency_events_total{kind=...}``
RESIDENCY_STATS = _metrics.MirroredCounterDict(
    "pathway_device_residency_events_total",
    "kind",
    {
        "resident_batches": 0,  # batches kept resident at a seam
        "materializations": 0,  # resident batches fetched to the host
        "device_consumes": 0,  # device buffers consumed with no transfer
        "declines": 0,  # the reference's egress fallback; the port raises instead, so 0
    },
    help="device-residency events by kind (mirrors RESIDENCY_STATS)",
)

_H2D_EVENTS = _metrics.REGISTRY.counter(
    "pathway_device_transfer_h2d_events_total",
    "host->device transfers performed by the delta-batch plane",
)
_H2D_BYTES = _metrics.REGISTRY.counter(
    "pathway_device_transfer_h2d_bytes_total",
    "host->device bytes moved by the delta-batch plane",
)
_D2H_EVENTS = _metrics.REGISTRY.counter(
    "pathway_device_transfer_d2h_events_total",
    "device->host transfers performed by the delta-batch plane",
)
_D2H_BYTES = _metrics.REGISTRY.counter(
    "pathway_device_transfer_d2h_bytes_total",
    "device->host bytes moved by the delta-batch plane",
)
_SAVED_BYTES = _metrics.REGISTRY.counter(
    "pathway_device_residency_bytes_saved_total",
    "bytes that stayed device-resident instead of crossing the seam",
)

#: this commit's live resident batches; decay_resident_batches() materializes the
#: survivors at commit boundaries
_LIVE_RESIDENT: "weakref.WeakSet" = weakref.WeakSet()

_FORCE = ("1", "true", "on", "yes", "force")
_OFF = ("0", "false", "off", "no")


def _raw() -> str:
    return os.environ.get("PATHWAY_TPU_DEVICE_RESIDENCY", "").strip().lower()


def enabled() -> bool:
    """Whether exchange outputs may stay resident at all (the contract above)."""
    raw = _raw()
    if raw in _OFF:
        return False
    if raw in _FORCE:
        return True
    from pathway_tpu_torch.engine import device_ops as _dops

    return _dops.configured_on_card()


def forced() -> bool:
    """True under ``PATHWAY_TPU_DEVICE_RESIDENCY=1``: every eligible seam stays
    resident; auto mode consults the consumer's measured placement instead."""
    return _raw() in _FORCE


def consumer_seam_key(consumer) -> "tuple | None":
    """The placement key a delivery to ``consumer`` belongs to: the consumer itself
    when it is an annotated device-eligible operator, else the eligible operator the
    placement pass marked it as feeding, else None."""
    if consumer is None:
        return None
    kind = getattr(consumer, "_device_ops_eligible", None)
    if kind is not None:
        return (kind, consumer.index)
    return getattr(consumer, "_device_residency_downstream", None)


def consumer_resident_ok(consumer) -> bool:
    """Should an output bound for ``consumer`` stay resident? When residency is on,
    the delivery belongs to a device-eligible operator's seam, and (in auto mode) the
    measured placement has that operator on the card."""
    if not enabled():
        return False
    key = consumer_seam_key(consumer)
    if key is None:
        return False
    if forced():
        return True
    from pathway_tpu_torch.optimize.placement import POLICY

    return POLICY.is_device(*key)


# -- transfer accounting ------------------------------------------------------------


def record_h2d(nbytes: int) -> None:
    """Count one host->device transfer of ``nbytes``."""
    _H2D_EVENTS.inc()
    _H2D_BYTES.inc(float(nbytes))


def record_d2h(nbytes: int) -> None:
    """Count one device->host transfer of ``nbytes``."""
    _D2H_EVENTS.inc()
    _D2H_BYTES.inc(float(nbytes))


def record_saved(nbytes: int) -> None:
    """Count ``nbytes`` that stayed resident instead of crossing."""
    if nbytes > 0:
        _SAVED_BYTES.inc(float(nbytes))


# -- resident batches --------------------------------------------------------------

_HOST_SLOTS = frozenset(("cols", "_kbytes", "_kobjs", "_kb_thunk"))

#: the torch dtype each numpy dtype's bytes reinterpret as on the device
_TORCH_VIEW = {
    np.dtype(np_t): t
    for np_t, t in (
        (np.bool_, torch.bool),
        (np.int8, torch.int8),
        (np.uint8, torch.uint8),
        (np.int16, torch.int16),
        (np.int32, torch.int32),
        (np.int64, torch.int64),
        (np.float16, torch.float16),
        (np.float32, torch.float32),
        (np.float64, torch.float64),
        (np.complex64, torch.complex64),
        (np.complex128, torch.complex128),
        (np.uint16, getattr(torch, "uint16", None)),
        (np.uint32, getattr(torch, "uint32", None)),
        (np.uint64, getattr(torch, "uint64", None)),
    )
    if t is not None
}


class DeviceResidentColumns(Columns):
    """A :class:`Columns` whose payload bytes live on the device.

    ``_dev_rows`` is the ``(n, W)`` uint8 packed-row tensor (the exchange's wire layout:
    16-byte key digest | int64 diff if any | fixed-width columns); ``_layout`` the
    host-side ``[(dtype, width), ...]``. ``n`` and ``diffs`` are set at once; the base
    class's host slots (``cols``, ``_kbytes``, ``_kobjs``, ``_kb_thunk``) stay unset
    until :meth:`_materialize` fills them, so any host access goes through
    ``__getattr__`` and fetches the batch. The device rows outlive materialization (the
    exchange can still re-pack them) until :meth:`decay` drops them."""

    __slots__ = ("_dev_rows", "_layout", "_has_diffs", "_seam_key", "__weakref__")

    def __init__(
        self,
        dev_rows: torch.Tensor,
        layout: list,
        has_diffs: bool,
        n: int,
        diffs: "np.ndarray | None" = None,
        seam_key: "tuple | None" = None,
    ) -> None:
        # Columns.__init__ is not called: the host slots stay unset, so __getattr__ is
        # the one gate to materialization
        self.n = n
        self.diffs = diffs
        self._dev_rows = dev_rows
        self._layout = layout
        self._has_diffs = has_diffs
        self._seam_key = seam_key
        _LIVE_RESIDENT.add(self)
        RESIDENCY_STATS["resident_batches"] += 1

    @classmethod
    def from_device_rows(
        cls,
        dev_rows: torch.Tensor,
        layout: list,
        has_diffs: bool,
        seam_key: "tuple | None" = None,
    ) -> "DeviceResidentColumns":
        """Wrap a device ``(n, W)`` packed-row tensor. The diffs (8n bytes, the column
        every delivery path screens) are fetched now; the keys and columns stay."""
        n = int(dev_rows.shape[0])
        diffs = None
        if has_diffs:
            seg = dev_rows[:, 16:24].cpu().numpy()
            record_d2h(seg.nbytes)
            diffs = np.ascontiguousarray(seg).view(np.int64).ravel()
        return cls(dev_rows, layout, has_diffs, n, diffs=diffs, seam_key=seam_key)

    # -- the host side, on demand --------------------------------------------------

    def __getattr__(self, name: str):
        if name in _HOST_SLOTS:
            self._materialize()
            return object.__getattribute__(self, name)
        raise AttributeError(name)

    def resident(self) -> bool:
        """True while the device rows are held."""
        return object.__getattribute__(self, "_dev_rows") is not None

    def _materialized(self) -> bool:
        try:
            object.__getattribute__(self, "cols")
            return True
        except AttributeError:
            return False

    def _materialize(self) -> None:
        """Fetch the packed rows once (one trimmed copy to the host) and fill the base
        class's slots with what the exchange's host path decodes from the same bytes;
        report the copy's cost to the consumer's seam."""
        if self._materialized():
            return
        dev = self._dev_rows
        if dev is None:  # pragma: no cover — decay materializes first
            raise RuntimeError("resident batch decayed before materializing")
        t0 = _time.perf_counter()
        rows = dev.cpu().numpy()
        record_d2h(rows.nbytes)
        RESIDENCY_STATS["materializations"] += 1
        kb = np.ascontiguousarray(rows[:, :16])
        off = 16 + (8 if self._has_diffs else 0)
        cols = []
        for dtype, width in self._layout:
            cols.append(np.ascontiguousarray(rows[:, off : off + width]).view(dtype).ravel())
            off += width
        self._kbytes = kb
        self._kobjs = None
        self._kb_thunk = None
        self.cols = cols
        t1 = _time.perf_counter()
        seam = self._seam_key
        if seam is not None:
            from pathway_tpu_torch.optimize.placement import POLICY

            POLICY.record_seam(seam[0], seam[1], self.n, int((t1 - t0) * 1e9))
        trace = _tracing.current()
        if trace is not None:
            trace.span("residency-materialize", "exchange", t0, t1, rows=self.n,
                       bytes=int(rows.nbytes))

    # -- the device side --------------------------------------------------------------

    def device_rows(self) -> "torch.Tensor | None":
        """The device ``(n, W)`` packed rows (None once decayed): the exchange re-packs
        from them instead of uploading host bytes."""
        return object.__getattribute__(self, "_dev_rows")

    @property
    def layout(self) -> list:
        return self._layout

    @property
    def has_diffs(self) -> bool:
        return self._has_diffs

    def device_column(self, i: int) -> "torch.Tensor | None":
        """Column ``i`` on the device, its byte lane reinterpreted (no transfer), or
        None once decayed: the same bits as ``cols[i]``. The lane is made contiguous on
        the device first (a device copy), since its row stride and offset need not
        divide the dtype's size. Raises ``TypeError`` for a dtype torch cannot view
        (``datetime64``, fixed-width ``U``, a non-native byte order)."""
        dev = object.__getattribute__(self, "_dev_rows")
        if dev is None:
            return None
        dtype, width = self._layout[i]
        tdtype = _TORCH_VIEW.get(np.dtype(dtype))
        if tdtype is None:
            raise TypeError(f"device_column: torch has no dtype to view {np.dtype(dtype)} as")
        off = 16 + (8 if self._has_diffs else 0) + sum(w for _dt, w in self._layout[:i])
        return dev[:, off : off + width].contiguous().view(tdtype).reshape(-1)

    def decay(self) -> None:
        """Materialize if needed, then drop the device rows: device memory stays
        bounded by one commit, and whatever still holds the batch sees host data."""
        if object.__getattribute__(self, "_dev_rows") is None:
            return
        self._materialize()
        self._dev_rows = None


# -- lifecycle ---------------------------------------------------------------------


def decay_resident_batches() -> None:
    """The end-of-commit hook: materialize and release every still-live resident
    batch, so device memory stays bounded by one commit and a checkpoint never sees
    device-only state."""
    if not _LIVE_RESIDENT:
        return
    for batch in list(_LIVE_RESIDENT):
        batch.decay()
    _LIVE_RESIDENT.clear()


def live_resident_batches() -> int:
    """Resident batches alive now (0 after every commit boundary)."""
    return len(_LIVE_RESIDENT)


# -- stats -------------------------------------------------------------------------


def stats() -> dict:
    """Roll-up for a run's report."""
    return {
        "enabled": enabled(),
        "forced": forced(),
        "events": dict(RESIDENCY_STATS),
        "h2d": {"events": int(_H2D_EVENTS.value), "bytes": int(_H2D_BYTES.value)},
        "d2h": {"events": int(_D2H_EVENTS.value), "bytes": int(_D2H_BYTES.value)},
        "bytes_saved": int(_SAVED_BYTES.value),
    }


def reset_counters() -> None:
    """Zero the event and transfer counters."""
    for key in list(RESIDENCY_STATS):
        RESIDENCY_STATS[key] = 0
    for counter in (_H2D_EVENTS, _H2D_BYTES, _D2H_EVENTS, _D2H_BYTES, _SAVED_BYTES):
        counter.value = 0.0
