"""Contrastive training for the embedder: the full train step, on one device.

Counterpart of ``pathway_tpu/models/train.py``: in-batch-negative InfoNCE over (query,
positive-doc) pairs, with AdamW at ``optax.adamw``'s defaults, on the same encoder the
serving path runs. The encoder is built ``trainable``: f32 master leaves, cast to
``cfg.dtype`` at each matmul, as the JAX step keeps its params.

Two deliberate differences from the JAX step:

- There is no mesh, so no ``batch_sharding`` is returned: data, tensor and sequence
  parallelism are later work. The caller puts the batch on the step's device.
- Attention routing. JAX's ``_mesh_attn`` takes ``dense_attention`` whenever the mesh
  has no ``seq`` axis; this step takes ``default_attn_fn(device)``, as the port's
  ``embed`` does: the flash kernels (forward, dQ and dK/dV) on the card, dense attention
  on the CPU. The two agree on every sequence with a real token.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.models.transformer import (
    Encoder,
    EncoderConfig,
    default_attn_fn,
    encoder_forward,
    pool,
)


class ContrastiveBatch(NamedTuple):
    """(query, positive) token batches; in-batch negatives."""

    q_ids: torch.Tensor  # [b, t] int
    q_mask: torch.Tensor  # [b, t] bool
    d_ids: torch.Tensor  # [b, t] int
    d_mask: torch.Tensor  # [b, t] bool


def info_nce_loss(
    model: Encoder,
    batch: ContrastiveBatch,
    cfg: EncoderConfig,
    temperature: float = 0.05,
    attn_fn: Callable | None = None,
) -> torch.Tensor:
    """Symmetric cross-entropy over ``q @ d.T / temperature`` (f32 scalar).
    ``attn_fn=None`` picks the device default (the flash kernels on CUDA)."""
    q = pool(encoder_forward(model, batch.q_ids, batch.q_mask, attn_fn), batch.q_mask, cfg)
    d = pool(encoder_forward(model, batch.d_ids, batch.d_mask, attn_fn), batch.d_mask, cfg)
    logits = (q @ d.T) / temperature  # [b, b]: in-batch negatives
    labels = torch.arange(logits.shape[0], device=logits.device)
    l_qd = nn.functional.cross_entropy(logits, labels)
    l_dq = nn.functional.cross_entropy(logits.T, labels)
    return (l_qd + l_dq) / 2.0


def adamw(params, learning_rate: float = 1e-4) -> torch.optim.AdamW:
    """AdamW at ``optax.adamw``'s defaults, not torch's: betas (0.9, 0.999), eps 1e-8
    outside the square root, weight decay 1e-4 (torch's default is 1e-2), on every leaf
    (optax is given no mask: biases, layer norms and embedding tables decay too)."""
    return torch.optim.AdamW(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )


class TrainState(NamedTuple):
    params: Encoder  # updated in place by each step
    opt_state: torch.optim.AdamW
    step: int


def make_train_step(
    cfg: EncoderConfig,
    learning_rate: float = 1e-4,
    temperature: float = 0.05,
    device: "str | torch.device | None" = None,
):
    """Returns ``(init_fn, step_fn)`` on one device (the card unless ``device`` names
    another).

    ``init_fn(seed=0, params=None) -> TrainState``: a trainable encoder, seeded, or
    loaded from ``params`` (an ``Encoder`` state_dict, e.g. from ``params_from_jax``),
    and its optimizer. ``step_fn(state, batch) -> (state, loss)``: one AdamW step on
    the InfoNCE loss of ``batch``; the encoder and optimizer are updated in place, and
    the loss comes back as a detached device scalar (no host sync)."""
    device = resolve_device(device)
    attn_fn = default_attn_fn(device)

    def init_fn(seed: int | None = 0, params: dict | None = None) -> TrainState:
        model = Encoder(cfg, device=device, seed=None if params is not None else seed,
                        trainable=True)
        if params is not None:
            model.load_state_dict(params)
        return TrainState(model, adamw(model.parameters(), learning_rate), 0)

    def step_fn(state: TrainState, batch: ContrastiveBatch):
        model, opt = state.params, state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = info_nce_loss(model, batch, cfg, temperature, attn_fn)
        loss.backward()
        opt.step()
        return TrainState(model, opt, state.step + 1), loss.detach()

    return init_fn, step_fn
