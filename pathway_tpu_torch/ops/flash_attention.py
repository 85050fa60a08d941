"""Flash attention for the encoder's attention seam: the forward and its gradient.

Counterpart of ``pathway_tpu/ops/flash_attention.py``: ``flash_attention`` keeps the
``[b, t, h, d]`` contract of the JAX ``flash_attention`` (:350) and ``dense_attention``,
with mask ``[b, t]`` bool (True = real token) or None, and is differentiable through
``FlashAttention``, the counterpart of the JAX ``_flash_diff`` custom_vjp. On CUDA
tensors the work runs in hand-written Hopper kernels: the forward in
``csrc/flash_attention_fwd.cu``, the backward's dQ and dK/dV kernels in
``csrc/flash_attention_bwd.cu``. On CPU tensors it runs in their plain PyTorch versions
(``flash_attention_fwd_reference``, ``flash_attention_bwd_reference``): the same
formulas with f32 scores, the softmax recomputed from the saved per-row logsumexp in
the backward, f32 products and one cast of each output, the yardstick the kernels are
held to. The kernels' bf16 instances run their products on the tensor cores: the
forward rounds P to bf16 before P.V, the dK/dV kernel carries P and dS as two bf16
terms each (hi + lo) into its products, and both skip 16-key tiles whose keys are all
masked (exact: such keys weigh exactly 0 in f32). The dQ kernel and the f32 instances
keep f32 products. There is no fallback: a CUDA input a kernel does not take raises.

Two rules for a query row whose keys are all masked:

- Forward: the row averages v over exactly the t keys given. The JAX glue
  (``_prepare``) pads t up to the 128 tile with zero-v keys, so for t not a multiple of
  128 its answer is ``mean(v) * t / ceil128(t)``; both agree where t is a multiple of
  128 (the encoder's buckets). tests/test_torch_flash_attention.py pins the difference.
- Backward: the row's lse is ``-1e30 + log t``, which rounds to -1e30 in f32, so the
  recomputed P is 1 for every key, not 1/t: its contributions to dQ, dK and dV are t
  times those of dense autograd. The JAX kernel does the same (over the padded
  length). The port's kernel and plain version agree on it;
  tests/test_torch_flash_backward.py pins it. Every sequence the trainer sees holds at
  least its CLS and SEP tokens, so no such row reaches its gradient.
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
_strides_arg = ctypes.POINTER(_ll)
BWD_DQ_KERNEL = CudaKernel(
    "flash_attention_bwd",
    "pt_flash_attention_bwd_dq",
    [_p] * 9 + [_i] * 5 + [_strides_arg, ctypes.c_float, _p],
)
BWD_DKV_KERNEL = CudaKernel(
    "flash_attention_bwd",
    "pt_flash_attention_bwd_dkv",
    [_p] * 10 + [_i] * 5 + [_strides_arg, ctypes.c_float, _p],
)


def _scores(q, k, bias) -> torch.Tensor:
    """s = (q / sqrt(d)) . k + bias, ``[b, h, t, t]`` f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    return s


def flash_attention_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device: -> (o ``[b, t, h, d]`` in
    q's dtype, lse ``[b, h, t]`` f32)."""
    s = _scores(q, k, bias)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)
    return o, lse


def _check_cuda_inputs(q, k, v, bias, **more: torch.Tensor) -> None:
    """Raise unless the kernels take these inputs: q, k, v and ``more`` (the backward's
    o and do) of one ``[b, t, h, d]`` shape and dtype, strided as the kernels read."""
    named = {"q": q, "k": k, "v": v, **more}
    if q.dim() != 4 or any(x.shape != q.shape for x in named.values()):
        shapes = {name: tuple(x.shape) for name, x in named.items()}
        raise ValueError(f"{', '.join(named)} must share one [b, t, h, d] shape, got {shapes}")
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in named.values()):
        dtypes = {name: x.dtype for name, x in named.items()}
        raise ValueError(f"the kernels take bf16 or f32 inputs of one dtype, got {dtypes}")
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernels take head dims {HEAD_DIMS}, got {d}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch and heads must be at most 65535, got {b}, {h}")
    vec = 16 // q.element_size()  # the kernels move 16-byte chunks
    for name, x in named.items():
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


def _on_cuda(name: str, q: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs), True for CUDA ones (the kernel
    runs); anything else raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    return True


def flash_attention_fwd(
    q: torch.Tensor,  # [b, t, h, d]
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,  # [b, t] f32, 0 or -1e30 per key
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (o ``[b, t, h, d]`` in q's dtype, lse ``[b, h, t]`` f32). The kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if not _on_cuda("flash_attention_fwd", q):
        return flash_attention_fwd_reference(q, k, v, bias)
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


def flash_attention_bwd_dq_reference(q, k, v, bias, do, o, lse) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dQ kernel, on any device: -> (dq ``[b, t, h, d]``
    in q's dtype, delta = rowsum(do * o) ``[b, h, t]`` f32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, bias) - lse[..., None])  # recomputed from the lse
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds, k.float()) * scale
    return dq.to(q.dtype), delta


def flash_attention_bwd_dkv_reference(
    q, k, v, bias, do, lse, delta
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dK/dV kernel, on any device: -> (dk, dv
    ``[b, t, h, d]`` in k's and v's dtypes, dbias per head ``[b, h, t]`` f32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, bias) - lse[..., None])
    dv = torch.einsum("bhts,bthd->bshd", p, do.float())
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float() * scale)
    return dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=2)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None,
    do: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the two backward kernels, on any device: the kernels'
    own formulas (P from the saved lse, delta from do and o, f32 inside, one cast at
    the end), not autograd of the forward. -> (dq, dk, dv ``[b, t, h, d]`` in the
    inputs' dtypes, dbias ``[b, t]`` f32, summed over heads)."""
    dq, delta = flash_attention_bwd_dq_reference(q, k, v, bias, do, o, lse)
    dk, dv, dbias = flash_attention_bwd_dkv_reference(q, k, v, bias, do, lse, delta)
    return dq, dk, dv, dbias.sum(dim=1)


def _check_stats(name: str, x: torch.Tensor, q: torch.Tensor) -> None:
    b, t, h, _d = q.shape
    if x.shape != (b, h, t) or x.dtype != torch.float32 or x.device != q.device or not x.is_contiguous():
        raise ValueError(f"{name} must be [b, h, t] float32 contiguous on {q.device}")


def _strides(*xs: torch.Tensor):
    flat = [s for x in xs for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def flash_attention_bwd_dq(q, k, v, bias, do, o, lse) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (dq ``[b, t, h, d]`` in q's dtype, delta ``[b, h, t]`` f32). The dQ kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if not _on_cuda("flash_attention_bwd_dq", q):
        return flash_attention_bwd_dq_reference(q, k, v, bias, do, o, lse)
    _check_cuda_inputs(q, k, v, bias, o=o, do=do)
    _check_stats("lse", lse, q)
    b, t, h, d = q.shape
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        BWD_DQ_KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _DTYPE_CODES[q.dtype], b, t, h, d, _strides(q, k, v, o, do),
            1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    return dq, delta


def flash_attention_bwd_dkv(
    q, k, v, bias, do, lse, delta
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dk, dv ``[b, t, h, d]`` in the inputs' dtype, dbias per head ``[b, h, t]``
    f32). The dK/dV kernel on CUDA tensors, the plain version on CPU tensors."""
    if not _on_cuda("flash_attention_bwd_dkv", q):
        return flash_attention_bwd_dkv_reference(q, k, v, bias, do, lse, delta)
    _check_cuda_inputs(q, k, v, bias, do=do)
    _check_stats("lse", lse, q)
    _check_stats("delta", delta, q)
    b, t, h, d = q.shape
    dk = torch.empty((b, t, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, t, h, d), dtype=v.dtype, device=q.device)
    dbias = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        BWD_DKV_KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
            _DTYPE_CODES[q.dtype], b, t, h, d, _strides(q, k, v, do),
            1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    return dk, dv, dbias


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None,
    do: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention_fwd`` -> (dq, dk, dv ``[b, t, h, d]``, dbias
    ``[b, t]`` f32): the dQ kernel (which also computes delta), then the dK/dV kernel,
    on CUDA tensors; the plain versions on CPU tensors. dbias is summed over heads here,
    with a torch op, so the result is the same from run to run."""
    dq, delta = flash_attention_bwd_dq(q, k, v, bias, do, o, lse)
    dk, dv, dbias = flash_attention_bwd_dkv(q, k, v, bias, do, lse, delta)
    return dq, dk, dv, dbias.sum(dim=1)


class FlashAttention(torch.autograd.Function):
    """Attention with a saved-lse backward, the counterpart of the JAX ``_flash_diff``
    and its ``defvjp``: ``FlashAttention.apply(q, k, v, bias, fwd, bwd)`` -> o, where
    ``fwd(q, k, v, bias) -> (o, lse)`` and ``bwd(q, k, v, bias, do, o, lse) -> (dq, dk,
    dv, dbias)``. ``flash_attention`` passes the kernels' wrappers; passing the plain
    versions gives the same route with the plain arithmetic on any device."""

    @staticmethod
    def forward(ctx, q, k, v, bias, fwd, bwd):
        o, lse = fwd(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.bwd = bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        # the kernels read do with its own strides but need unit stride along d
        dq, dk, dv, dbias = ctx.bwd(q, k, v, bias, do.contiguous(), o, lse)
        return dq, dk, dv, dbias if ctx.needs_input_grad[3] else None, None, None


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
    contract) -> ``[b, t, h, d]``, differentiable: the forward kernel, and in the
    backward the dQ and dK/dV kernels, on CUDA tensors; the plain versions on CPU
    tensors."""
    bias = None if mask is None else mask_bias(mask)
    return FlashAttention.apply(q, k, v, bias, flash_attention_fwd, flash_attention_bwd)
