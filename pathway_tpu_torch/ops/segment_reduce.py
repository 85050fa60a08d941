"""The ordered segment sum under the groupby's device reductions.

Counterpart of the scatter-add in ``pathway_tpu/engine/device_ops.py`` (``_scatter_add``
:213, launched by ``segment_reduce_dispatch`` :270), held to the host spec of
``pathway_tpu/engine/device.py`` (``segment_count`` / ``segment_sum``): per group, the
int64 sum with wrapping add, or the float64 sum added in row order from +0.0, which is
what ``np.add.at`` and ``np.bincount`` compute.

:func:`segment_offsets` sorts the group index stably and builds the group offsets, so
``order[offsets[g]:offsets[g + 1]]`` lists group ``g``'s rows in row order.
:func:`ordered_segment_sum` adds each group's weights along that order: on CUDA tensors
in the hand-written kernel of ``csrc/segment_reduce.cu`` (one thread per group, adds in
order), on CPU tensors in its plain PyTorch version
(:func:`ordered_segment_sum_reference`), which takes the same adds in the same order
and so gives the same bits on any device. There is no fallback: a CUDA input the kernel
does not take raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pathway_tpu_torch._build import CudaKernel

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel(
    "segment_reduce", "pt_ordered_segment_sum", [_p, _p, _p, _p, _i, _ll, _p]
)
_FLOAT_CODES = {torch.int64: 0, torch.float64: 1}


def segment_offsets(inverse: torch.Tensor, n_groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (order ``[n]``, offsets ``[n_groups + 1]``), both int64 on ``inverse``'s
    device: the rows sorted stably by group, and where each group's run starts."""
    _, order = torch.sort(inverse, stable=True)
    offsets = torch.zeros(n_groups + 1, dtype=torch.int64, device=inverse.device)
    torch.cumsum(torch.bincount(inverse, minlength=n_groups), 0, out=offsets[1:])
    return order, offsets


def ordered_segment_sum_reference(
    w: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor, out: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: step ``k`` adds the ``k``-th
    row of every group that has one, so each group's adds run in row order, one
    elementwise add at a time (int64 adds wrap)."""
    counts = offsets[1:] - offsets[:-1]
    n_groups = counts.numel()
    if out is None:
        out = torch.empty(n_groups, dtype=w.dtype, device=w.device)
    out.zero_()
    if n_groups == 0 or w.numel() == 0:
        return out
    by_len = torch.argsort(counts, descending=True, stable=True)
    starts = offsets[:-1][by_len]
    lens = counts[by_len].cpu().numpy()  # descending
    # live[k]: how many groups have a k-th row (a prefix of by_len)
    live = np.searchsorted(-lens, -np.arange(int(lens[0])), side="left")
    sorted_w = w[order]
    acc = torch.zeros(n_groups, dtype=w.dtype, device=w.device)
    for k, m in enumerate(live.tolist()):
        acc[:m] += sorted_w[starts[:m] + k]
    out[by_len] = acc
    return out


def _check_cuda_inputs(w: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor, out) -> None:
    if w.dtype not in _FLOAT_CODES:
        raise TypeError(f"ordered_segment_sum takes int64 or float64 weights, not {w.dtype}")
    if order.dtype != torch.int64 or offsets.dtype != torch.int64:
        raise TypeError("order and offsets must be int64")
    for name, t in (("w", w), ("order", order), ("offsets", offsets)):
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be 1-D and contiguous")
    if order.numel() != w.numel():
        raise ValueError(f"order has {order.numel()} rows, w {w.numel()}")
    if out is not None and (
        out.dtype != w.dtype or out.device != w.device or not out.is_contiguous()
        or out.shape != (offsets.numel() - 1,)
    ):
        raise ValueError("out must be a contiguous [groups] tensor of w's dtype and device")


def ordered_segment_sum(
    w: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor, out: torch.Tensor | None = None
) -> torch.Tensor:
    """Per-group sums ``[groups]`` in ``w``'s dtype (int64 or float64): group ``g``
    adds ``w[order[j]]`` for ``j`` in ``[offsets[g], offsets[g + 1])``, in ``j`` order.
    The kernel on CUDA tensors, the plain version on CPU tensors."""
    if w.device.type == "cpu":
        return ordered_segment_sum_reference(w, order, offsets, out)
    if w.device.type != "cuda":
        raise ValueError(f"ordered_segment_sum runs on cuda or cpu, not {w.device}")
    _check_cuda_inputs(w, order, offsets, out)
    n_groups = offsets.numel() - 1
    if out is None:
        out = torch.empty(n_groups, dtype=w.dtype, device=w.device)
    if n_groups == 0:
        return out
    with torch.cuda.device(w.device):
        KERNEL(
            w.data_ptr(), order.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            _FLOAT_CODES[w.dtype], n_groups, torch.cuda.current_stream(w.device).cuda_stream,
        )
    return out
