"""The residency plane on one card: transfer accounting, the commit-boundary decay and
the seam keys placement reads.

Counterpart of ``pathway_tpu/engine/device_residency.py`` (lines 167-265 and 438-483
there). In the JAX package this plane keeps the sharded exchange's outputs on the
device between a device operator and the next (``DeviceResidentColumns``), so a
groupby on the card feeding a join on the card pays no copy to the host and back at
the seam between them. Such batches are made in one place only, the collective
exchange of the sharded scheduler, which needs one device per shard; the port's
exchange has its host planes only, so nothing here produces or consumes them.
``DeviceResidentColumns`` and the collective exchange come with ROADMAP queue 1 item 14,
slice c, and raise ``NotImplementedError`` until then.

What one card has:

- **transfer accounting**: :func:`record_h2d` / :func:`record_d2h` count every copy the
  device operators make between the host and the card (``engine/device_ops.py``: the
  segment reduction's upload and fetch, the matcher's key uploads and index fetch), in
  ``pathway_device_transfer_{h2d,d2h}_{events,bytes}_total``; :func:`record_saved`
  counts bytes that stayed resident (none on one card).
- **the commit-boundary decay**: :func:`decay_resident_batches`, called from
  ``device_pipeline.commit_boundary`` / ``drain_until`` / ``drain`` as in the JAX
  package, materializes any resident batch that outlives its commit. On one card the
  set is always empty, so the call is a no-op kept at its call sites.
- **the seam keys**: :func:`consumer_seam_key` and :func:`consumer_resident_ok`, read
  from the placement pass's annotations (``_device_ops_eligible``,
  ``_device_residency_downstream``).

Control surface, ``PATHWAY_TPU_DEVICE_RESIDENCY``: ``0`` off; ``1`` forced; unset auto,
on when the device operators' configured device is a CUDA device (the port's reading of
the JAX package's "a real accelerator backend"). The variable is read on every call.
"""

from __future__ import annotations

import os
import weakref

from pathway_tpu_torch.internals import metrics as _metrics
from pathway_tpu_torch.internals.unported import module_getattr

__all__ = [
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
        "declines": 0,  # residency attempted, fell back to the host
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
#: survivors at commit boundaries (nothing registers here on one card)
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


__getattr__ = module_getattr(__name__, dict.fromkeys(
    ("DeviceResidentColumns",), "14, slice c: the collective exchange"
))
