"""The collective exchange's device step: packed rows gathered into destination order.

Counterpart of ``bucket_and_swap`` in ``pathway_tpu/engine/collective_exchange.py``
(``_kernel`` :375: ``payload[gidx]`` per source chunk, then one ``lax.all_to_all``).
:func:`bucket_swap` takes the ``(n_rows, W)`` uint8 payload of one batch (16-byte key
digest | int64 diff | fixed-width columns) and the stable argsort of the rows'
destinations, and returns ``payload[perm]``: one compacted, destination-major matrix,
where destination d's rows are a contiguous slice in ascending source index. That is
the reference's trimmed per-destination concatenation, with no power-of-two padding
(``engine/collective_exchange.py`` says why the order is the same).

On a CUDA tensor it launches the hand-written kernel of ``csrc/bucket_swap.cu`` or
raises; on a CPU tensor (and only there) it runs the plain version,
:func:`bucket_swap_reference` (``index_select``).
"""

from __future__ import annotations

import ctypes

import torch

from pathway_tpu_torch._build import CudaKernel
from pathway_tpu_torch.ops.segment_reduce import _need, _on_card, _stream

__all__ = ["BUCKET_SWAP", "KERNELS", "bucket_swap", "bucket_swap_reference", "prepare", "word_bytes"]

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
BUCKET_SWAP = CudaKernel("bucket_swap", "pt_bucket_swap", [_p, _p, _p, _ll, _ll, _i, _p])
KERNELS = {"bucket_swap": BUCKET_SWAP}

_MAX_ROWS = (1 << 31) - 1  # int32 row indices


def prepare(device: torch.device) -> None:
    """Build and load the kernel's library ahead of the first launch on a CUDA device
    (a no-op for the CPU), so that a failed build raises where the caller can tell it
    from a failed swap."""
    if device.type == "cuda":
        BUCKET_SWAP.bind()


def word_bytes(width: int, *ptrs: int) -> int:
    """The widest copy, 16, 8 or 4 bytes, that divides the row width and every base
    address, else 1."""
    for word in (16, 8, 4):
        if width % word == 0 and all(p % word == 0 for p in ptrs):
            return word
    return 1


def bucket_swap_reference(payload: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Plain version: ``payload.index_select(0, perm)``."""
    return payload.index_select(0, perm)


def bucket_swap(payload: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``(len(perm), W)`` uint8: ``out[i] = payload[perm[i]]``. ``payload`` is a
    contiguous ``(rows, W)`` uint8 matrix, ``perm`` contiguous int32 row indices in
    ``[0, rows)``."""
    on_card = _on_card("bucket_swap", payload, perm)
    _need(payload, "payload", torch.uint8, 2)
    _need(perm, "perm", torch.int32, 1)
    if not on_card:
        return bucket_swap_reference(payload, perm)
    n, width = perm.numel(), payload.shape[1]
    if n > _MAX_ROWS or payload.shape[0] > _MAX_ROWS:
        raise ValueError(f"bucket_swap takes at most 2^31 - 1 rows on the card, not {n}")
    out = torch.empty((n, width), dtype=torch.uint8, device=payload.device)
    if n == 0 or width == 0:
        return out
    word = word_bytes(width, payload.data_ptr(), out.data_ptr())
    with torch.cuda.device(payload.device):
        BUCKET_SWAP(payload.data_ptr(), perm.data_ptr(), out.data_ptr(), n, width, word,
                    _stream(payload))
    return out
