"""ViT/CLIP-style image encoder in PyTorch: the vision leg of the multimodal stack.

Counterpart of ``pathway_tpu/models/vision.py``: the same configs (``clip_vit_b16``,
``vit_tiny``) and the same arithmetic, which is the spec:

- patchify by reshape (rows of patches, then columns) and one matmul, no convolution;
- the patch embed, the CLS concatenation and the ``pos_emb`` add in the compute dtype
  (bf16 by default; the text encoder sums its embeddings in f32 instead);
- pre-LN blocks, layer norm in f32 with eps 1e-5, tanh-approximate GELU;
- the residual ``x + a @ out_w + out_b`` evaluated left to right;
- the output ``x[:, 0] @ proj`` in the compute dtype, then f32, then L2-normalised with
  a 1e-12 floor.

``VisionEncoder`` is an ``nn.Module`` whose parameter names follow the JAX param pytree
(``patch_w``, ``cls``, ``pos_emb``, ``pre_ln.scale``, ``layers.0.ln1.scale``,
``layers.0.qkv_w``, ..., ``final_ln``, ``proj``), so ``params_from_jax`` carries the
JAX weights over. It holds every leaf but the layer norms in the compute dtype: the
JAX forward casts each of them to it at its use, so one cast at load gives the same
numbers. Attention runs the flash forward kernel on CUDA tensors through the encoder's
fused route (``flash_attention_qkv``, no mask), and plain dense attention on CPU
tensors, as ``default_attn_fn`` chooses.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.models.transformer import (
    AttnFn,
    LayerNorm,
    _param,
    default_attn_fn,
    layer_norm,
)
from pathway_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_qkv,
    split_heads,
)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch: int = 16
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    out_dim: int = 512
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2


def clip_vit_b16() -> VisionConfig:
    """CLIP ViT-B/16 image tower shape."""
    return VisionConfig()


def vit_tiny() -> VisionConfig:
    """Small config for tests and dry runs."""
    return VisionConfig(
        image_size=32, patch=8, hidden=64, layers=2, heads=4, intermediate=128, out_dim=32
    )


class VisionLayer(nn.Module):
    def __init__(self, cfg: VisionConfig, device) -> None:
        super().__init__()
        hid, inter, dt = cfg.hidden, cfg.intermediate, cfg.dtype
        self.ln1 = LayerNorm(hid, device, False)
        self.qkv_w = _param((hid, 3 * hid), dt, device, False)
        self.qkv_b = _param((3 * hid,), dt, device, False, 0.0)
        self.out_w = _param((hid, hid), dt, device, False)
        self.out_b = _param((hid,), dt, device, False, 0.0)
        self.ln2 = LayerNorm(hid, device, False)
        self.fc1_w = _param((hid, inter), dt, device, False)
        self.fc1_b = _param((inter,), dt, device, False, 0.0)
        self.fc2_w = _param((inter, hid), dt, device, False)
        self.fc2_b = _param((hid,), dt, device, False, 0.0)


class VisionEncoder(nn.Module):
    """The ViT image tower, for serving (no gradients). Weights are seeded random
    unless loaded (``load_state_dict``, e.g. of ``params_from_jax``)."""

    def __init__(
        self,
        cfg: VisionConfig,
        *,
        device: "str | torch.device | None" = None,
        seed: int | None = 0,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dt = cfg.dtype
        patch_dim = cfg.patch * cfg.patch * 3
        self.patch_w = _param((patch_dim, cfg.hidden), dt, device, False)
        self.cls = _param((cfg.hidden,), dt, device, False)
        self.pos_emb = _param((cfg.n_patches + 1, cfg.hidden), dt, device, False)
        self.pre_ln = LayerNorm(cfg.hidden, device, False)
        self.layers = nn.ModuleList(VisionLayer(cfg, device) for _ in range(cfg.layers))
        self.final_ln = LayerNorm(cfg.hidden, device, False)
        self.proj = _param((cfg.hidden, cfg.out_dim), dt, device, False)
        if seed is not None:
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.patch_w.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Seeded random init with the JAX package's scheme: ``patch_w``, ``cls``,
        ``pos_emb``, ``proj`` and every matrix N(0, 0.02), biases 0, layer-norm scales
        1. (The numbers differ from JAX's: the two generators differ.)"""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("_w") or name in ("cls", "pos_emb", "proj"):
                noise = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
                p.copy_(0.02 * noise)

    def forward(self, pixels: torch.Tensor, attn_fn: AttnFn | None = None) -> torch.Tensor:
        return vision_forward(self, pixels, attn_fn)


def patchify(pixels: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """``[b, H, W, 3]`` -> ``[b, n_patches, patch*patch*3]`` by reshape (rows of
    patches, then columns): the conv-free patch embed's feed."""
    b = pixels.shape[0]
    g, p = cfg.image_size // cfg.patch, cfg.patch
    x = pixels.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)  # [b, g, g, p, p, 3]
    return x.reshape(b, g * g, p * p * 3)


@torch.inference_mode()
def vision_forward(
    model: VisionEncoder, pixels: torch.Tensor, attn_fn: AttnFn | None = None
) -> torch.Tensor:
    """``pixels [b, H, W, 3]`` (normalised floats) -> L2-normalised embeddings
    ``[b, out_dim]`` f32. ``attn_fn=None`` picks the device default (the flash kernel
    on CUDA, dense attention on the CPU)."""
    cfg, dt = model.cfg, model.cfg.dtype
    if attn_fn is None:
        attn_fn = default_attn_fn(pixels.device)
    b = pixels.shape[0]
    x = patchify(pixels.to(dt), cfg) @ model.patch_w
    x = torch.cat([model.cls[None, None].expand(b, 1, cfg.hidden), x], dim=1)
    x = x + model.pos_emb[None]
    x = layer_norm(x, model.pre_ln, cfg.layer_norm_eps)
    t = x.shape[1]
    for lp in model.layers:
        h = layer_norm(x, lp.ln1, cfg.layer_norm_eps)
        qkv = h @ lp.qkv_w + lp.qkv_b
        if attn_fn is flash_attention:
            a = flash_attention_qkv(qkv, None, cfg.heads)
        else:
            a = attn_fn(*split_heads(qkv, cfg.heads), None)
        a = a.reshape(b, t, cfg.hidden)
        x = x + a @ lp.out_w + lp.out_b
        h = layer_norm(x, lp.ln2, cfg.layer_norm_eps)
        h = nn.functional.gelu(h @ lp.fc1_w + lp.fc1_b, approximate="tanh")
        x = x + h @ lp.fc2_w + lp.fc2_b
    x = layer_norm(x, model.final_ln, cfg.layer_norm_eps)
    emb = (x[:, 0] @ model.proj).float()
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)


#: CLIP preprocessing constants (OpenAI CLIP mean and std)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_image(img: Any, cfg: VisionConfig) -> np.ndarray:
    """PIL image -> normalised ``[H, W, 3]`` f32 numpy (resize, then CLIP
    statistics), on the host."""
    arr = preprocess_image_u8(img, cfg).astype(np.float32) / 255.0
    return (arr - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)


def preprocess_image_u8(img: Any, cfg: VisionConfig) -> np.ndarray:
    """PIL image -> resized ``[H, W, 3]`` uint8 (bilinear). The bytes stay small on
    the host; ``normalize_u8`` normalises them on the card, a 4x smaller upload than
    f32 pixels."""
    img = img.convert("RGB").resize((cfg.image_size, cfg.image_size), resample=2)
    return np.asarray(img, np.uint8)


def normalize_u8(pixels_u8: torch.Tensor) -> torch.Tensor:
    """CLIP normalisation of uint8 pixels ``[b, H, W, 3]`` -> f32, on their device."""
    x = pixels_u8.float() / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
