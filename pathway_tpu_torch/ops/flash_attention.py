"""Flash attention forward for the encoder's attention seam.

Counterpart of ``pathway_tpu/ops/flash_attention.py``: ``flash_attention`` keeps the
``[b, t, h, d]`` contract of the JAX ``flash_attention`` (:350) and ``dense_attention``,
with mask ``[b, t]`` bool (True = real token) or None. On CUDA tensors the work runs in
the hand-written Hopper kernel ``csrc/flash_attention_fwd.cu``; on CPU tensors in
``flash_attention_fwd_reference``, the plain PyTorch version of the same arithmetic
(f32 scores, f32 softmax, f32 products, one cast of the output). There is no fallback:
a CUDA input the kernel does not take raises.

One deliberate departure from the JAX package: a query row whose keys are all masked
averages v over exactly the t keys given. The JAX glue (``_prepare``) pads t up to the
128 tile with zero-v keys, so for t not a multiple of 128 its answer is
``mean(v) * t / ceil128(t)``; both agree where t is a multiple of 128 (the encoder's
buckets). tests/test_torch_flash_attention.py pins the difference.

The backward kernels of the JAX package (``_flash_bwd_dq_kernel``,
``_flash_bwd_dkv_kernel``) are not ported yet, so this path is inference-only.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pathway_tpu_torch._build import CudaKernel

NEG_INF = -1e30  # finite: a fully masked row averages v instead of turning NaN
HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel(
    "flash_attention_fwd",
    "pt_flash_attention_fwd",
    [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i]
    + [_ll] * 9
    + [ctypes.c_float, _p],
)


def flash_attention_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device: -> (o ``[b, t, h, d]`` in
    q's dtype, lse ``[b, h, t]`` f32)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)
    return o, lse


def _check_cuda_inputs(q, k, v, bias) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [b, t, h, d] shape, got {q.shape}, {k.shape}, {v.shape}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes bf16 or f32 q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {d}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch and heads must be at most 65535, got {b}, {h}")
    vec = 16 // q.element_size()  # the kernel moves 16-byte chunks
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along the head dim")
        if x.data_ptr() % 16 or any(s % vec for s in x.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned with strides in multiples of {vec}")
    if bias is not None:
        if bias.shape != (b, t) or bias.dtype != torch.float32 or bias.device != q.device:
            raise ValueError(f"bias must be [b, t] float32 on {q.device}")
        if not bias.is_contiguous():
            raise ValueError("bias must be contiguous")


def flash_attention_fwd(
    q: torch.Tensor,  # [b, t, h, d]
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,  # [b, t] f32, 0 or -1e30 per key
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (o ``[b, t, h, d]`` in q's dtype, lse ``[b, h, t]`` f32). The kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, not {q.device}")
    _check_cuda_inputs(q, k, v, bias)
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], b, t, h, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    return o, lse


def mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """``[b, t]`` bool mask -> f32 additive key bias (0 real, -1e30 masked)."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, neg)


def flash_attention(
    q: torch.Tensor,  # [b, t, h, d]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None,  # [b, t] bool
) -> torch.Tensor:
    """Drop-in attention function (``models/transformer.py`` ``dense_attention``
    contract) -> ``[b, t, h, d]``."""
    bias = None if mask is None else mask_bias(mask)
    return flash_attention_fwd(q, k, v, bias)[0]
