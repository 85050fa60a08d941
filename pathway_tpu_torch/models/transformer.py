"""BERT-family text encoder in PyTorch.

Counterpart of ``pathway_tpu/models/transformer.py``: the same configs (``minilm_l6``
for all-MiniLM-L6-v2, ``bge_base``, ``bge_small``) and the same arithmetic, which is
the spec:

- the embedding sum in f32, then one cast to the compute dtype;
- layer norm in f32 with the population variance, then a cast back;
- tanh-approximate GELU;
- masked attention scores filled with -1e30;
- compute in ``cfg.dtype`` (bf16 by default), pooling and L2 normalisation in f32.

``Encoder`` is an ``nn.Module`` whose parameter names follow the JAX param pytree
(``tok_emb``, ``emb_ln.scale``, ``layers.0.qkv_w``, ...), so ``params_from_jax`` carries
weights over leaf by leaf. A serving encoder holds its matmul weights in the compute
dtype, with no gradients; a trainable one (``trainable=True``, as ``models/train.py``
builds it) holds every leaf as an f32 master with a gradient, and the forward casts the
matmul weights to the compute dtype at each matmul, as the JAX forward does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_qkv,
    split_heads,
)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    intermediate: int = 1536
    max_len: int = 512
    type_vocab: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    pooling: str = "mean"  # mean | cls

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


def minilm_l6() -> EncoderConfig:
    return EncoderConfig(hidden=384, layers=6, heads=12, intermediate=1536)


def bge_base() -> EncoderConfig:
    return EncoderConfig(
        hidden=768, layers=12, heads=12, intermediate=3072, pooling="cls"
    )


def bge_small() -> EncoderConfig:
    return EncoderConfig(
        hidden=384, layers=12, heads=12, intermediate=1536, pooling="cls"
    )


AttnFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor, "torch.Tensor | None"], torch.Tensor
]


def _param(shape, dtype, device, trainable: bool, fill: float | None = None) -> nn.Parameter:
    data = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        data.fill_(fill)
    return nn.Parameter(data, requires_grad=trainable)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, device, trainable: bool) -> None:
        super().__init__()
        self.scale = _param((dim,), torch.float32, device, trainable, 1.0)
        self.bias = _param((dim,), torch.float32, device, trainable, 0.0)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, device, trainable: bool) -> None:
        super().__init__()
        hid, inter, tr = cfg.hidden, cfg.intermediate, trainable
        # Serving holds the matmul weights and biases in the compute dtype: one cast at
        # load gives the same numbers as the JAX forward's ``.astype(cfg.dtype)`` at
        # every matmul, and each forward then reads half the bytes. Training holds f32
        # masters, since AdamW steps of ~1e-4 would mostly round away on bf16 weights.
        dt = torch.float32 if trainable else cfg.dtype
        self.qkv_w = _param((hid, 3 * hid), dt, device, tr)
        self.qkv_b = _param((3 * hid,), dt, device, tr, 0.0)
        self.out_w = _param((hid, hid), dt, device, tr)
        self.out_b = _param((hid,), dt, device, tr, 0.0)
        self.attn_ln = LayerNorm(hid, device, tr)
        self.fc1_w = _param((hid, inter), dt, device, tr)
        self.fc1_b = _param((inter,), dt, device, tr, 0.0)
        self.fc2_w = _param((inter, hid), dt, device, tr)
        self.fc2_b = _param((hid,), dt, device, tr, 0.0)
        self.mlp_ln = LayerNorm(hid, device, tr)


class Encoder(nn.Module):
    """MiniLM/BGE-style encoder. Embedding tables and layer norms stay f32 (the
    embedding sum and the normalisation are f32 in the spec); the matmul weights are
    held in ``cfg.dtype``, or as f32 masters with gradients when ``trainable``. Weights
    are seeded random unless loaded (``load_state_dict``)."""

    def __init__(
        self,
        cfg: EncoderConfig,
        *,
        device: "str | torch.device | None" = None,
        seed: int | None = 0,
        trainable: bool = False,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        f32, tr = torch.float32, trainable
        self.tok_emb = _param((cfg.vocab_size, cfg.hidden), f32, device, tr)
        self.pos_emb = _param((cfg.max_len, cfg.hidden), f32, device, tr)
        self.type_emb = _param((cfg.type_vocab, cfg.hidden), f32, device, tr)
        self.emb_ln = LayerNorm(cfg.hidden, device, tr)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device, trainable) for _ in range(cfg.layers)
        )
        if seed is not None:
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Seeded random init with the JAX package's scheme: matrices and embedding
        tables N(0, 0.02), biases 0, layer-norm scales 1. (The numbers differ from
        JAX's: the two generators differ.)"""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("_emb") or name.endswith("_w"):
                noise = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
                p.copy_(0.02 * noise)

    def forward(
        self,
        token_ids: torch.Tensor,  # [b, t] int
        mask: torch.Tensor | None,  # [b, t] bool (True = real token)
        attn_fn: AttnFn | None = None,
    ) -> torch.Tensor:
        return encoder_forward(self, token_ids, mask, attn_fn)


def layer_norm(x: torch.Tensor, p: LayerNorm, eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * p.scale + p.bias).to(x.dtype)


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None
) -> torch.Tensor:
    """Plain masked attention: q/k/v ``[b, t, h, d]``, mask ``[b, t]``."""
    d = q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(d)
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", p, v)


def default_attn_fn(device: torch.device) -> AttnFn:
    """The flash kernel for CUDA tensors, plain dense attention for CPU tensors (as
    the JAX package runs dense attention off the accelerator)."""
    return flash_attention if device.type == "cuda" else dense_attention


def encoder_forward(
    model: Encoder,
    token_ids: torch.Tensor,  # [b, t] int
    mask: torch.Tensor | None,  # [b, t] bool (True = real token)
    attn_fn: AttnFn | None = None,
) -> torch.Tensor:
    """Token-level hidden states ``[b, t, hidden]`` (in ``cfg.dtype``)."""
    cfg = model.cfg
    if attn_fn is None:
        attn_fn = default_attn_fn(token_ids.device)
    b, t = token_ids.shape
    # ``embedding`` and not ``tok_emb[ids]``: the same gather, but its backward sums
    # the rows of repeated ids (padding repeats id 0) with a sort, not one by one.
    x = (
        nn.functional.embedding(token_ids.long(), model.tok_emb)
        + model.pos_emb[None, :t]
        + model.type_emb[0][None, None]
    ).to(cfg.dtype)
    x = layer_norm(x, model.emb_ln, cfg.layer_norm_eps)
    dt = cfg.dtype
    for lp in model.layers:
        # ``x @ w + b`` and not ``F.linear``: the bias is added after the product
        # is rounded to the compute dtype, as in the JAX forward. ``.to(dt)`` casts a
        # trainable encoder's f32 masters and returns a serving encoder's weights as
        # they are, with no kernel.
        qkv = x @ lp.qkv_w.to(dt) + lp.qkv_b.to(dt)
        if attn_fn is flash_attention:
            # The one place the route is chosen: the flash kernels take the fused
            # projection as it is, and their backward writes dq, dk and dv into one
            # dqkv buffer instead of autograd concatenating them. Any other attention
            # function, including a wrapper of flash_attention, gets q, k, v views.
            a = flash_attention_qkv(qkv, mask, cfg.heads)
        else:
            a = attn_fn(*split_heads(qkv, cfg.heads), mask)
        a = a.reshape(b, t, cfg.hidden)
        a = a @ lp.out_w.to(dt) + lp.out_b.to(dt)
        x = layer_norm(x + a, lp.attn_ln, cfg.layer_norm_eps)
        h = x @ lp.fc1_w.to(dt) + lp.fc1_b.to(dt)
        h = nn.functional.gelu(h, approximate="tanh")
        h = h @ lp.fc2_w.to(dt) + lp.fc2_b.to(dt)
        x = layer_norm(x + h, lp.mlp_ln, cfg.layer_norm_eps)
    return x


def pool(
    hidden: torch.Tensor, mask: torch.Tensor | None, cfg: EncoderConfig
) -> torch.Tensor:
    """Sentence embedding from token states, L2-normalised ``[b, hidden]`` f32."""
    h32 = hidden.float()
    if cfg.pooling == "cls":
        emb = h32[:, 0]
    elif mask is None:
        emb = h32.mean(dim=1)
    else:
        m = mask.float()[..., None]
        emb = (h32 * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)


@torch.inference_mode()
def embed(
    model: Encoder,
    token_ids: torch.Tensor,
    mask: torch.Tensor | None,
    attn_fn: AttnFn | None = None,
) -> torch.Tensor:
    """The embedder entry point: tokens -> normalised sentence embeddings.
    ``attn_fn=None`` picks the device default (the flash kernel on CUDA)."""
    return pool(encoder_forward(model, token_ids, mask, attn_fn), mask, model.cfg)


class CrossEncoder(Encoder):
    """The reranker's cross-encoder: an ``Encoder`` with a relevance head, ``head_w``
    ``[hidden, 1]`` and ``head_b`` ``[1]``, both f32 (the JAX head takes them
    uncast). Seeded init draws ``head_w`` as the matrices, N(0, 0.02)."""

    def __init__(
        self,
        cfg: EncoderConfig,
        *,
        device: "str | torch.device | None" = None,
        seed: int | None = 0,
    ) -> None:
        super().__init__(cfg, device=device, seed=None)
        self.head_w = _param((cfg.hidden, 1), torch.float32, self.device, False)
        self.head_b = _param((1,), torch.float32, self.device, False, 0.0)
        if seed is not None:
            self.init_weights(seed)


@torch.inference_mode()
def cross_encode(
    model: CrossEncoder,
    token_ids: torch.Tensor,  # [b, t]: [CLS] doc [SEP] query [SEP] pairs
    mask: torch.Tensor | None,
    attn_fn: AttnFn | None = None,
) -> torch.Tensor:
    """Relevance score per pair ``[b]`` f32 (the pre-sigmoid logit): the f32 CLS state
    through the head."""
    cls = encoder_forward(model, token_ids, mask, attn_fn)[:, 0].float()
    return (cls @ model.head_w + model.head_b)[:, 0]


def params_from_jax(tree: Any) -> dict[str, torch.Tensor]:
    """The JAX package's encoder param pytree (nested dicts and lists, leaves as
    numpy arrays) -> a ``state_dict`` for ``Encoder``, leaf by leaf: ``{"layers":
    [{"qkv_w": ...}]}`` becomes ``"layers.0.qkv_w"``. Leaves come over as f32;
    ``Encoder.load_state_dict`` casts the matmul weights to the compute dtype of a
    serving encoder and keeps them f32 in a trainable one."""
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, dict):
            for key, child in node.items():
                walk(f"{prefix}{key}.", child)
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(f"{prefix}{i}.", child)
        else:
            out[prefix[:-1]] = torch.tensor(np.asarray(node, np.float32))

    walk("", tree)
    return out
