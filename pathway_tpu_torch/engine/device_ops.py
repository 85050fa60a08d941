"""Device operators under the groupby and the join.

Counterpart of ``pathway_tpu/engine/device_ops.py`` without its placement policy. Two
operator cores run on the card, on the columnar delta batches' arrays (+1/-1 diffs
included):

- **the groupby's segment reductions**: the columnar groupby's per-commit
  ``device.segment_count`` and ``device.segment_sum`` become one upload, one stable sort
  of the group index and one launch of the ordered segment-sum kernel
  (``ops/segment_reduce.py``, ``csrc/segment_reduce.cu``) per column. Dispatch is split
  from fetch (:func:`segment_reduce_dispatch`, :meth:`SegmentReduceJob.fetch`), so the
  kernels run while the host resolves group ids.
- **the join's pair matcher**: ``graph._match_join_pairs`` over int64 key codes as
  torch ops on the card (:func:`match_pairs`): stable sort, ``searchsorted`` left and
  right, ``repeat_interleave`` and ``cumsum``, with the same swap rule (the smaller
  side is the sorted haystack) and the same emission order (probe index ascending,
  then build index ascending), so its pairs are the host matcher's, pair for pair.

The host kernels stay the spec. The weights (``col.astype(int64) * diffs``, ``col *
diffs``) are computed on the host with NumPy, so their rounding is the spec's; the card
adds them in the spec's order, so the sums are the spec's bits.

The device comes from the caller: :func:`configure` names it (``None``, the default,
is the card; with no card the first operator that reaches the card raises, unless the
caller configured ``device="cpu"``, where the same torch code runs on CPU tensors with
the kernel's plain version). ``PATHWAY_TPU_DEVICE_OPS=0`` keeps its JAX meaning: host
kernels only. Otherwise every representable batch takes the device operators, as the
JAX package's forced mode ``PATHWAY_TPU_DEVICE_OPS=1`` does; there is no placement
policy, and an error on the card raises.
"""

from __future__ import annotations

import os
import threading
import time as _time
from typing import Sequence

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.engine import device as _host
from pathway_tpu_torch.ops.segment_reduce import ordered_segment_sum, segment_offsets

__all__ = [
    "SegmentReduceJob",
    "configure",
    "device",
    "enabled",
    "hit_counts",
    "kernel_ns",
    "match_pairs",
    "record_kernel",
    "reset_counters",
    "segment_reduce_dispatch",
    "stats",
]

_LOCK = threading.Lock()
#: per-operator call counts and host-observed ns
_HITS: dict[str, int] = {}
_NS: dict[str, int] = {}

_ENABLED_CACHE: tuple[str, bool] | None = None
_DEVICE_ARG: "str | torch.device | None" = None
_DEVICE: torch.device | None = None


def configure(device: "str | torch.device | None" = None) -> None:
    """Name the device of the operators: ``None`` is the card (resolved at first use),
    ``"cpu"`` runs the same code on CPU tensors."""
    global _DEVICE_ARG, _DEVICE
    _DEVICE_ARG = device
    _DEVICE = None


def device() -> torch.device:
    """The operators' device, resolved once through ``_device.resolve_device``: with
    no card and no configured device this raises."""
    global _DEVICE
    if _DEVICE is None:
        _DEVICE = resolve_device(_DEVICE_ARG)
    return _DEVICE


def enabled() -> bool:
    """False under ``PATHWAY_TPU_DEVICE_OPS=0`` (host kernels only), else True; cached
    per value of the variable, since the operators ask once per batch."""
    global _ENABLED_CACHE
    raw = os.environ.get("PATHWAY_TPU_DEVICE_OPS", "").strip().lower()
    cached = _ENABLED_CACHE
    if cached is not None and cached[0] == raw:
        return cached[1]
    val = raw not in ("0", "false", "off", "no")
    _ENABLED_CACHE = (raw, val)
    return val


# -- accounting ----------------------------------------------------------------


def record_kernel(name: str, ns: int, hits: int = 1) -> None:
    with _LOCK:
        _HITS[name] = _HITS.get(name, 0) + hits
        _NS[name] = _NS.get(name, 0) + int(ns)


def hit_counts() -> dict[str, int]:
    with _LOCK:
        return dict(_HITS)


def kernel_ns() -> dict[str, int]:
    with _LOCK:
        return dict(_NS)


def reset_counters() -> None:
    with _LOCK:
        _HITS.clear()
        _NS.clear()


def stats() -> dict:
    """Roll-up for a run's report: whether the operators may engage, their device (if
    resolved), and the calls and ns per operator."""
    return {
        "enabled": enabled(),
        "device": None if _DEVICE is None else str(_DEVICE),
        "hit_counts": hit_counts(),
        "kernel_ns": kernel_ns(),
    }


# -- transfers -------------------------------------------------------------------


def _upload(arrays: Sequence[np.ndarray], dev: torch.device) -> list[torch.Tensor]:
    """Same-length int64 or float64 arrays -> their copies on ``dev``, in one
    host-to-device copy (float64 rides as its int64 bits)."""
    stacked = torch.from_numpy(np.stack([a.view(np.int64) for a in arrays])).to(dev)
    return [
        stacked[i].view(torch.float64) if a.dtype == np.float64 else stacked[i]
        for i, a in enumerate(arrays)
    ]


# -- groupby: segment reduction ----------------------------------------------------


class SegmentReduceJob:
    """An in-flight segment reduction: :func:`segment_reduce_dispatch` enqueued the
    upload, the sort and the kernels, and the copy of the results back into pinned
    memory; :meth:`fetch` waits for that copy only."""

    __slots__ = ("_host", "_done", "_kinds", "_t0")

    def __init__(self, host: torch.Tensor, done, kinds: list, t0: int) -> None:
        self._host = host  # [1 + columns, groups] int64 (float64 rows as bits)
        self._done = done  # event behind the copy back, or None on the CPU
        self._kinds = kinds
        self._t0 = t0

    def fetch(self) -> tuple[np.ndarray, list]:
        """(gdiffs, deltas): the dtypes and bits of ``device.segment_count`` and
        ``device.segment_sum``."""
        if self._done is not None:
            self._done.synchronize()
        rows = self._host.numpy()
        gdiffs = rows[0].copy()
        deltas: list = []
        i = 1
        for kind in self._kinds:
            if kind is None:
                deltas.append(None)
                continue
            deltas.append(rows[i].view(np.float64).copy() if kind == "f" else rows[i].copy())
            i += 1
        record_kernel("segment_reduce", _time.perf_counter_ns() - self._t0)
        return gdiffs, deltas


def segment_reduce_dispatch(
    inverse: np.ndarray,
    diffs: np.ndarray,
    vals: Sequence[np.ndarray | None],
    n_groups: int,
) -> SegmentReduceJob:
    """Device twin of the columnar groupby's per-commit reductions:
    ``segment_count(inverse, diffs)`` plus one ``segment_sum`` per sum column, on
    :func:`device`. The weight products are computed here with NumPy, as the spec
    computes them."""
    t0 = _time.perf_counter_ns()
    dev = device()
    diffs = np.ascontiguousarray(diffs, np.int64)
    arrays = [np.ascontiguousarray(inverse, np.int64), diffs]
    kinds: list = []
    for col in vals:
        if col is None:
            kinds.append(None)
        elif col.dtype.kind in "ib":
            kinds.append("i")
            arrays.append(col.astype(np.int64, copy=False) * diffs)
        else:
            kinds.append("f")
            arrays.append(np.ascontiguousarray(col * diffs, np.float64))
    up = _upload(arrays, dev)
    inv_d, weights = up[0], up[1:]
    order, offsets = segment_offsets(inv_d, n_groups)
    out = torch.empty((len(weights), n_groups), dtype=torch.int64, device=dev)
    for w, row in zip(weights, out):
        ordered_segment_sum(w, order, offsets, out=row.view(w.dtype))
    if dev.type == "cpu":
        return SegmentReduceJob(out, None, kinds, t0)
    host = torch.empty(out.shape, dtype=torch.int64, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return SegmentReduceJob(host, done, kinds, t0)


# -- join: sort-based pair matcher ----------------------------------------------------


def _match_pairs_device(la: np.ndarray, ra: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``graph._match_join_pairs`` in torch ops on :func:`device`: the same swap rule,
    stable sort and emission arithmetic, so the pair sequence is the host matcher's.
    Two points wait for the card: ``int(counts.sum())``, the pair count that sizes the
    output, and the copy of the two index arrays back to the host."""
    empty = np.empty(0, np.int64)
    if len(la) == 0 or len(ra) == 0:
        return empty, empty
    if len(ra) > len(la):
        r_idx, l_idx = _match_pairs_device(ra, la)
        return l_idx, r_idx
    dev = device()
    la_d = torch.from_numpy(la).to(dev)
    ra_d = torch.from_numpy(ra).to(dev)
    rs, order = torch.sort(ra_d, stable=True)
    lo = torch.searchsorted(rs, la_d, side="left")
    hi = torch.searchsorted(rs, la_d, side="right")
    counts = hi - lo
    total = int(counts.sum())  # waits for the card
    if total == 0:
        return empty, empty
    l_idx = torch.repeat_interleave(
        torch.arange(len(la), device=dev), counts, output_size=total
    )
    starts = torch.repeat_interleave(lo, counts, output_size=total)
    csum = torch.cumsum(counts, 0) - counts
    offs = torch.arange(total, device=dev) - torch.repeat_interleave(
        csum, counts, output_size=total
    )
    r_idx = order[starts + offs]
    return l_idx.cpu().numpy(), r_idx.cpu().numpy()


def match_pairs(
    l_arrays: "list[np.ndarray]", r_arrays: "list[np.ndarray]"
) -> tuple[np.ndarray, np.ndarray] | None:
    """The device pair matcher over dtype-unified join-key columns: ``(l_idx,
    r_idx)``, or ``None`` when a column has no int64 code view (NaN floats, strings,
    objects); the batch then takes the host matcher. Multi-column keys reduce to joint
    codes with the host factorization the NumPy path uses, so only the matcher runs on
    the card."""
    from pathway_tpu_torch.engine.graph import _as_match_codes

    t0 = _time.perf_counter_ns()
    lc = [_as_match_codes(a) for a in l_arrays]
    if any(c is None for c in lc):
        return None
    rc = [_as_match_codes(a) for a in r_arrays]
    if any(c is None for c in rc):
        return None
    if len(lc) == 1:
        la, ra = lc[0], rc[0]
    else:
        nl = len(lc[0])
        both = [np.concatenate([lcol, rcol]) for lcol, rcol in zip(lc, rc)]
        _first, inverse = _host.factorize_multi(both)
        la = np.ascontiguousarray(inverse[:nl], np.int64)
        ra = np.ascontiguousarray(inverse[nl:], np.int64)
    out = _match_pairs_device(la, ra)
    record_kernel("match_pairs", _time.perf_counter_ns() - t0)
    return out
