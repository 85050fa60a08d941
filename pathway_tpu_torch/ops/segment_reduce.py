"""The groupby's per-commit segment reduction.

Counterpart of the scatter-add in ``pathway_tpu/engine/device_ops.py`` (``_scatter_add``
:213, launched by ``segment_reduce_dispatch`` :270), held to the host spec of
``pathway_tpu/engine/device.py`` (``segment_count`` / ``segment_sum``): per group, the
int64 sum with wrapping add, or the float64 sum added in row order from +0.0, which is
what ``np.add.at`` and ``np.bincount`` compute.

:func:`segment_reduce` takes the group index and all the int64 and float64 weight
columns of one commit and returns every per-group sum in one ``[columns, groups]``
int64 buffer (float rows as their bits). Its stages, each a hand-written kernel of
``csrc/segment_reduce.cu`` on CUDA tensors and its plain PyTorch version on CPU tensors
(and only there; a CUDA input the kernel does not take raises):

- :func:`segment_sum_int`: the int64 columns, in no order (wrapping adds commute);
- :func:`radix_pass`, once per digit of :func:`radix_passes`: a stable partition of the
  rows by group that carries the float64 columns along and gives where each digit's
  rows end (after a single pass, the runs' ends); :func:`run_ends` after two passes
  reads each group's run off the sorted keys;
- :func:`fold_runs`: each group's contiguous run added in row order from +0.0.

The pass plan (:func:`radix_passes`), the tile count and where the run ends come from
are computed here, in Python that both routes share. On the card :func:`segment_reduce`
validates once, takes all its scratch as one buffer and calls the stages' launchers
directly.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pathway_tpu_torch._build import CudaKernel

__all__ = [
    "DADD_CHAIN",
    "FOLD_RUNS",
    "INT_SUM",
    "KERNELS",
    "RADIX_PASS",
    "RUN_ENDS",
    "dadd_chain",
    "fold_runs",
    "fold_runs_reference",
    "partition",
    "partition_reference",
    "radix_pass",
    "radix_pass_reference",
    "radix_passes",
    "run_ends",
    "run_ends_reference",
    "segment_reduce",
    "segment_reduce_reference",
    "segment_sum_int",
    "segment_sum_int_reference",
]

_SOURCE = "segment_reduce"
_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
INT_SUM = CudaKernel(_SOURCE, "pt_segment_sum_int", [_p, _p, _p, _ll, _ll, _i, _p])
RADIX_PASS = CudaKernel(
    _SOURCE, "pt_radix_pass", [_p, _i, _p, _i, _ll, _i, _i, _p, _ll, _p, _p, _p, _p]
)
RUN_ENDS = CudaKernel(_SOURCE, "pt_run_ends", [_p, _ll, _ll, _p, _p])
FOLD_RUNS = CudaKernel(_SOURCE, "pt_fold_runs", [_p, _i, _ll, _p, _ll, _p, _p, _p])
DADD_CHAIN = CudaKernel(_SOURCE, "pt_dadd_chain", [_p, _p, _ll, _p])
#: the entry points of :func:`segment_reduce` on the card (``DADD_CHAIN`` only calibrates)
KERNELS = {"int_sum": INT_SUM, "radix_pass": RADIX_PASS, "run_ends": RUN_ENDS, "fold_runs": FOLD_RUNS}

MAX_DIGIT_BITS = 11  # digits of at most 2,048 values: one pass up to 2,048 groups
TILE_ROWS = 2048  # rows a tile of the partition (the kernel's kTile)
LONG_RUN = 32  # a run of this many rows or more is folded by a warp (the kernel's kLongRun)
_MAX_ROWS = (1 << 31) - 1  # int32 keys, ranks and run ends


def radix_passes(n_groups: int) -> list[tuple[int, int]]:
    """The partition's passes for group indices in ``[0, n_groups)``: ``(shift, bits)``
    per pass, least significant digit first, over the ``ceil(log2 n_groups)`` bits an
    index can have, split as evenly as ``MAX_DIGIT_BITS`` allows (none for one group)."""
    bits = max(int(n_groups) - 1, 0).bit_length()
    if bits == 0:
        return []
    passes = -(-bits // MAX_DIGIT_BITS)
    base, extra = divmod(bits, passes)
    plan, shift = [], 0
    for p in range(passes):
        width = base + (1 if p < extra else 0)
        plan.append((shift, width))
        shift += width
    return plan


def tiles(n: int) -> int:
    return -(-n // TILE_ROWS)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA inputs (the kernel), False for CPU ones (the plain version); raises
    on any other device or a mix."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    return dev.type == "cuda"


def _need(t: torch.Tensor, name: str, dtype: torch.dtype, dim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be {dim}-D and contiguous, not {tuple(t.shape)}")


def _need_rows(name: str, n: int) -> None:
    if not 0 < n <= _MAX_ROWS:
        raise ValueError(f"{name} takes 1 to 2^31 - 1 rows on the card, not {n}")


# -- int64 columns -----------------------------------------------------------------------


def segment_sum_int_reference(inverse: torch.Tensor, w: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Plain version: ``[cols, groups]`` int64 sums by ``index_add_`` (exact: int64 adds
    wrap and commute)."""
    out = torch.zeros((w.shape[0], n_groups), dtype=torch.int64, device=w.device)
    return out.index_add_(1, inverse, w)


def _int_sum_card(inverse, w, n_groups, out, stream) -> None:
    cols, n = w.shape
    INT_SUM(inverse.data_ptr(), w.data_ptr(), out.data_ptr(), n, n_groups, cols, stream)


def segment_sum_int(inverse: torch.Tensor, w: torch.Tensor, n_groups: int) -> torch.Tensor:
    """``[cols, groups]`` int64: ``out[c, g]`` is the wrapping sum of ``w[c, r]`` over
    the rows with ``inverse[r] == g``. ``inverse`` int64 ``[n]``, ``w`` int64 ``[cols,
    n]``. The kernel picks its path (shared-memory sums or global atomics) by shape."""
    on_card = _on_card("segment_sum_int", inverse, w)
    _need(inverse, "inverse", torch.int64, 1)
    _need(w, "w", torch.int64, 2)
    cols, n = w.shape
    if inverse.numel() != n:
        raise ValueError(f"inverse has {inverse.numel()} rows, w {n}")
    if not on_card:
        return segment_sum_int_reference(inverse, w, n_groups)
    _need_rows("segment_sum_int", n)
    out = torch.empty((cols, n_groups), dtype=torch.int64, device=w.device)
    with torch.cuda.device(w.device):
        _int_sum_card(inverse, w, n_groups, out, _stream(w))
    return out


# -- float64 columns: the partition ------------------------------------------------------


def radix_pass_reference(
    keys: torch.Tensor, payload: torch.Tensor, shift: int, bits: int, keep_keys: bool = True
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of one pass: a stable sort by the digit ``(key >> shift) & (2^bits
    - 1)`` (``torch.sort(stable=True)``), and where each digit's rows end. -> (int32
    keys, payload ``[cols, n]``, digit ends int32 ``[2^bits]``)."""
    digit = (keys.to(torch.int64) >> shift) & ((1 << bits) - 1)
    _, order = torch.sort(digit, stable=True)
    digit_end = torch.cumsum(torch.bincount(digit, minlength=1 << bits), 0).to(torch.int32)
    return keys[order].to(torch.int32), payload[:, order], digit_end


def _radix_pass_card(keys, payload, shift, bits, counts, digit_end, keys_out, payload_out, stream):
    """Launch one pass into the given scratch (``counts`` int32 ``[2^bits * (tiles +
    1)]`` at least, ``digit_end`` ``[2^bits]`` at least) and outputs (``keys_out`` may
    be None)."""
    RADIX_PASS(
        keys.data_ptr(), keys.element_size(), payload.data_ptr(), payload.shape[0], keys.numel(),
        shift, bits, counts.data_ptr(), tiles(keys.numel()), digit_end.data_ptr(),
        0 if keys_out is None else keys_out.data_ptr(), payload_out.data_ptr(), stream,
    )


def radix_pass(
    keys: torch.Tensor, payload: torch.Tensor, shift: int, bits: int, keep_keys: bool = True
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """One stable pass by the digit ``(key >> shift) & (2^bits - 1)``: -> (the keys in
    their new order as int32, or None on the card when ``keep_keys`` is False; the
    payload ``[cols, n]`` float64 in the same order; where each digit's rows end, int32
    ``[2^bits]``). ``keys`` int64 or int32 ``[n]``."""
    on_card = _on_card("radix_pass", keys, payload)
    if keys.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"keys must be int64 or int32, not {keys.dtype}")
    _need(keys, "keys", keys.dtype, 1)
    _need(payload, "payload", torch.float64, 2)
    if payload.shape[1] != keys.numel():
        raise ValueError(f"keys have {keys.numel()} rows, payload {payload.shape[1]}")
    if not 1 <= bits <= MAX_DIGIT_BITS or shift < 0 or shift + bits > 31:
        raise ValueError(f"digit of {bits} bits at {shift}")
    if not on_card:
        return radix_pass_reference(keys, payload, shift, bits, keep_keys)
    n, digits = keys.numel(), 1 << bits
    _need_rows("radix_pass", n)
    counts, digit_end, keys_out = _scratch(
        keys.device, (torch.int32, digits * (tiles(n) + 1)), (torch.int32, digits),
        (torch.int32, n if keep_keys else 0),
    )
    payload_out = torch.empty_like(payload)
    with torch.cuda.device(keys.device):
        _radix_pass_card(keys, payload, shift, bits, counts, digit_end,
                         keys_out if keep_keys else None, payload_out, _stream(keys))
    return (keys_out if keep_keys else None), payload_out, digit_end


def run_ends_reference(keys: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Plain version: ``ends[g]`` = the first row whose key exceeds ``g``, int32."""
    probe = torch.arange(n_groups, dtype=keys.dtype, device=keys.device)
    return torch.searchsorted(keys, probe, right=True).to(torch.int32)


def _run_ends_card(keys, n_groups, ends, stream):
    RUN_ENDS(keys.data_ptr(), keys.numel(), n_groups, ends.data_ptr(), stream)
    return ends


def run_ends(keys: torch.Tensor, n_groups: int) -> torch.Tensor:
    """``[n_groups]`` int32: where each group's run ends in the sorted int32 ``keys``."""
    on_card = _on_card("run_ends", keys)
    _need(keys, "keys", torch.int32, 1)
    if not on_card:
        return run_ends_reference(keys, n_groups)
    _need_rows("run_ends", keys.numel())
    if n_groups <= 0:
        raise ValueError(f"run_ends takes at least one group, not {n_groups}")
    ends = torch.empty(n_groups, dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        return _run_ends_card(keys, n_groups, ends, _stream(keys))


def _partition(inverse, w, n_groups, pass_fn, ends_fn):
    """The partition's stages in order: ``pass_fn(p, keys, payload, shift, bits,
    keep_keys)`` for pass ``p`` of the plan, then ``ends_fn(keys, n_groups)`` past one
    pass."""
    plan = radix_passes(n_groups)
    keys, payload, digit_end = inverse, w, None
    for p, (shift, bits) in enumerate(plan):
        keys, payload, digit_end = pass_fn(p, keys, payload, shift, bits, len(plan) > 1)
    if not plan:  # one group: the rows are its run as they stand
        return payload, None
    if len(plan) == 1:  # the digit is the group
        return payload, digit_end[:n_groups]
    return payload, ends_fn(keys, n_groups)


def partition(inverse: torch.Tensor, w: torch.Tensor, n_groups: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The rows of ``w`` (float64 ``[cols, n]``) grouped by ``inverse``, each group's
    rows in row order: -> (payload, ends), group ``g``'s run ending at ``ends[g]``
    (``ends`` is None for one group: all ``n`` rows)."""
    return _partition(inverse, w, n_groups, lambda _p, *a: radix_pass(*a), run_ends)


def partition_reference(inverse, w, n_groups):
    """:func:`partition` through the stages' plain versions, on any device."""
    return _partition(inverse, w, n_groups, lambda _p, *a: radix_pass_reference(*a), run_ends_reference)


# -- float64 columns: the fold -----------------------------------------------------------


def fold_runs_reference(w: torch.Tensor, ends: torch.Tensor | None, n_groups: int) -> torch.Tensor:
    """Plain version, on any device: step ``k`` adds the ``k``-th row of every run that
    has one, so each run's adds go in row order, one elementwise add at a time, from
    +0.0. -> ``[cols, groups]`` float64."""
    cols, n = w.shape
    acc = torch.zeros((cols, n_groups), dtype=w.dtype, device=w.device)
    if n_groups == 0 or n == 0:
        return acc
    if ends is None:
        stop = torch.full((n_groups,), n, dtype=torch.int64, device=w.device)
    else:
        stop = ends.to(torch.int64)
    start = torch.cat([torch.zeros(1, dtype=torch.int64, device=w.device), stop[:-1]])
    lens = stop - start
    by_len = torch.argsort(lens, descending=True, stable=True)
    starts = start[by_len]
    desc = lens[by_len].cpu().numpy()
    # live[k]: how many runs have a k-th row (a prefix of by_len)
    live = np.searchsorted(-desc, -np.arange(int(desc[0])), side="left")
    sorted_acc = torch.zeros_like(acc)
    for k, m in enumerate(live.tolist()):
        sorted_acc[:, :m] += w[:, starts[:m] + k]
    acc[:, by_len] = sorted_acc
    return acc


def _long_runs_size(n: int, n_groups: int) -> int:
    return 1 + min(n_groups, n // LONG_RUN)


def _fold_runs_card(w, ends, n_groups, out, long_runs, stream) -> None:
    cols, n = w.shape
    FOLD_RUNS(
        w.data_ptr(), cols, n, 0 if ends is None else ends.data_ptr(), n_groups, out.data_ptr(),
        long_runs.data_ptr(), stream,
    )


def fold_runs(w: torch.Tensor, ends: torch.Tensor | None, n_groups: int) -> torch.Tensor:
    """``[cols, groups]`` float64: each group's run of ``w`` (float64 ``[cols, n]``, runs
    as :func:`partition` gives them) added in row order from +0.0."""
    on_card = _on_card("fold_runs", w, *(() if ends is None else (ends,)))
    _need(w, "w", torch.float64, 2)
    if ends is None:
        if n_groups != 1:
            raise ValueError("fold_runs without run ends takes one group")
    else:
        _need(ends, "ends", torch.int32, 1)
        if ends.numel() != n_groups:
            raise ValueError(f"{ends.numel()} run ends for {n_groups} groups")
    if not on_card:
        return fold_runs_reference(w, ends, n_groups)
    cols, n = w.shape
    _need_rows("fold_runs", n)
    out = torch.empty((cols, n_groups), dtype=torch.float64, device=w.device)
    long_runs = torch.empty(_long_runs_size(n, n_groups), dtype=torch.int32, device=w.device)
    with torch.cuda.device(w.device):
        _fold_runs_card(w, ends, n_groups, out, long_runs, _stream(w))
    return out


# -- the whole reduction -------------------------------------------------------------------


def _check_reduce(inverse, w_int, w_float, n_groups) -> bool:
    on_card = _on_card("segment_reduce", inverse, w_int, w_float)
    _need(inverse, "inverse", torch.int64, 1)
    _need(w_int, "w_int", torch.int64, 2)
    _need(w_float, "w_float", torch.float64, 2)
    n = inverse.numel()
    if w_int.shape[1] != n or w_float.shape[1] != n:
        raise ValueError(f"inverse has {n} rows, w_int {w_int.shape[1]}, w_float {w_float.shape[1]}")
    if n_groups < 0 or (n > 0 and n_groups == 0):
        raise ValueError(f"{n} rows in {n_groups} groups")
    if on_card and n > _MAX_ROWS:
        raise ValueError(f"segment_reduce takes at most 2^31 - 1 rows on the card, not {n}")
    return on_card


def _scratch(device: torch.device, *regions: tuple[torch.dtype, int]) -> list[torch.Tensor]:
    """One allocation for a call's scratch: a 1-D view for each ``(dtype, numel)``, each
    starting on a 256-byte boundary."""
    offsets, size = [], 0
    for dtype, numel in regions:
        offsets.append(size)
        size += -(-numel * dtype.itemsize // 256) * 256
    buf = torch.empty(size, dtype=torch.uint8, device=device)
    return [buf[o : o + numel * dtype.itemsize].view(dtype) for o, (dtype, numel) in zip(offsets, regions)]


def _float_sums_card(inverse, w, n_groups, out, stream) -> None:
    """The float64 columns' sums into ``out`` (float64 ``[cols, groups]``): the
    partition's passes and the fold, every scratch array carved from one buffer (the
    payloads and keys ping-pong between two halves past one pass; the tile counts are
    reused by every pass)."""
    cols, n = w.shape
    plan = radix_passes(n_groups)
    multi = len(plan) > 1
    digits = max((1 << bits for _s, bits in plan), default=1)
    payloads = min(len(plan), 2)
    regions = _scratch(
        inverse.device,
        *[(torch.float64, cols * n)] * payloads,
        *[(torch.int32, n)] * (2 if multi else 0),
        (torch.int32, digits * (tiles(n) + 1)),
        (torch.int32, digits),
        (torch.int32, n_groups if multi else 0),
        (torch.int32, _long_runs_size(n, n_groups)),
    )
    pays = [r.view(cols, n) for r in regions[:payloads]]
    keys_bufs = regions[payloads:-4]
    counts, digit_end, ends, long_runs = regions[-4:]

    def pass_fn(p, keys, payload, shift, bits, keep_keys):
        keys_out = keys_bufs[p % 2] if keep_keys else None
        _radix_pass_card(keys, payload, shift, bits, counts, digit_end, keys_out, pays[p % 2], stream)
        return keys_out, pays[p % 2], digit_end

    payload, run_ends_ = _partition(
        inverse, w, n_groups, pass_fn, lambda k, g: _run_ends_card(k, g, ends, stream)
    )
    _fold_runs_card(payload, run_ends_, n_groups, out, long_runs, stream)


def segment_reduce(
    inverse: torch.Tensor, w_int: torch.Tensor, w_float: torch.Tensor, n_groups: int
) -> torch.Tensor:
    """All the per-group sums of one commit: ``inverse`` int64 ``[n]`` (each in ``[0,
    n_groups)``), ``w_int`` int64 ``[ni, n]``, ``w_float`` float64 ``[nf, n]`` ->
    ``[ni + nf, n_groups]`` int64, the int sums first, then the float sums as their bits.
    On the card the int columns take no partition, so a call with no float column
    launches nothing else; on CPU tensors, :func:`segment_reduce_reference`."""
    if not _check_reduce(inverse, w_int, w_float, n_groups):
        return segment_reduce_reference(inverse, w_int, w_float, n_groups)
    ni, nf = w_int.shape[0], w_float.shape[0]
    out = torch.empty((ni + nf, n_groups), dtype=torch.int64, device=inverse.device)
    if inverse.numel() == 0 or n_groups == 0:
        return out.zero_()
    with torch.cuda.device(inverse.device):
        stream = _stream(inverse)
        if ni:
            _int_sum_card(inverse, w_int, n_groups, out[:ni], stream)
        if nf:
            _float_sums_card(inverse, w_float, n_groups, out[ni:].view(torch.float64), stream)
    return out


def segment_reduce_reference(
    inverse: torch.Tensor, w_int: torch.Tensor, w_float: torch.Tensor, n_groups: int
) -> torch.Tensor:
    """:func:`segment_reduce` through the stages' plain versions, on any device."""
    _check_reduce(inverse, w_int, w_float, n_groups)
    ni, nf = w_int.shape[0], w_float.shape[0]
    out = torch.zeros((ni + nf, n_groups), dtype=torch.int64, device=inverse.device)
    if inverse.numel() == 0 or n_groups == 0:
        return out
    if ni:
        out[:ni] = segment_sum_int_reference(inverse, w_int, n_groups)
    if nf:
        out[ni:].view(torch.float64).copy_(
            fold_runs_reference(*partition_reference(inverse, w_float, n_groups), n_groups)
        )
    return out


# -- calibration ---------------------------------------------------------------------------


def dadd_chain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """``x[0] + x[1] + x[1] + ...``: ``iters`` float64 adds, each waiting on the last, in
    one thread on the card (timed, the latency of a dependent add); a Python loop of the
    same round-to-nearest adds on the CPU."""
    on_card = _on_card("dadd_chain", x)
    _need(x, "x", torch.float64, 1)
    if x.numel() != 2 or iters <= 0:
        raise ValueError("dadd_chain takes x = [start, step] and iters > 0")
    if not on_card:
        acc, step = float(x[0]), float(x[1])
        for _ in range(iters):
            acc += step
        return torch.tensor([acc], dtype=torch.float64)
    out = torch.empty(1, dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        DADD_CHAIN(x.data_ptr(), out.data_ptr(), iters, _stream(x))
    return out
