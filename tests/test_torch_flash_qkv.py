"""The fused route of the port's flash attention on the CPU: ``flash_attention_qkv``
takes the encoder's ``[b, t, 3 h d]`` projection, and its backward writes dq, dk and dv
into the three thirds of one dqkv buffer (on CPU tensors, the plain versions' results
copied there). Inputs come from numpy with a seed.

(a) Its dqkv equals the split route's ``torch.cat`` of dq, dk and dv exactly (the same
    plain functions on the same inputs; only where the results land differs), at
    t in {77, 128}, with and without a mask.
(b) ``encoder_forward`` routes ``flash_attention``, and only it, through the fused
    route: on a hidden-64 f32 encoder the InfoNCE loss and every parameter's gradient
    agree with the split route (a wrapper of the same function) within 1e-6.
(c) JAX's ``_flash_diff`` gradient (Pallas in interpret mode on the CPU, as
    tests/test_flash_attention.py runs it) agrees with the fused route's dqkv at
    t=128 within 2e-4, the tolerance of tests/test_torch_flash_backward.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu_torch.models import train as ttrain
from pathway_tpu_torch.models import transformer as tt
from pathway_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("pathway_tpu.ops.flash_attention")

JAX_TOL = 2e-4
ROUTE_TOL = 1e-6


def _inputs(b, t, h, d, seed, masked=True):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, t, 3 * h * d)).astype(np.float32)
    do = rng.normal(size=(b, t, h, d)).astype(np.float32)
    mask = np.arange(t)[None, :] < rng.integers(1, t + 1, b)[:, None] if masked else None
    return qkv, do, mask


def _fused_grad(qkv, do, mask, h):
    x = torch.from_numpy(qkv).requires_grad_()
    o = tfa.flash_attention_qkv(x, None if mask is None else torch.from_numpy(mask), h)
    (g,) = torch.autograd.grad(o, x, torch.from_numpy(do))
    return o.detach(), g


@pytest.mark.parametrize("t", [77, 128])
@pytest.mark.parametrize("masked", [True, False])
def test_fused_dqkv_equals_the_split_routes_concatenation(t, masked):
    b, h, d = 3, 2, 16
    qkv, do, mask = _inputs(b, t, h, d, seed=t, masked=masked)
    o, dqkv = _fused_grad(qkv, do, mask, h)
    xs = [x.clone().requires_grad_() for x in tfa.split_heads(torch.from_numpy(qkv), h)]
    o_split = tfa.flash_attention(*xs, None if mask is None else torch.from_numpy(mask))
    grads = torch.autograd.grad(o_split, xs, torch.from_numpy(do))
    assert torch.equal(o, o_split.detach())
    assert torch.equal(dqkv, torch.cat([g.reshape(b, t, h * d) for g in grads], dim=-1))


def _graph_nodes(loss: torch.Tensor) -> set[str]:
    seen, todo, names = set(), [loss.grad_fn], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        todo.extend(nxt for nxt, _ in node.next_functions)
    return names


def test_encoder_routes_only_flash_attention_through_the_fused_route():
    cfg = tt.EncoderConfig(vocab_size=512, hidden=64, layers=2, heads=4, intermediate=128,
                           max_len=64, dtype=torch.float32)
    model = tt.Encoder(cfg, device="cpu", seed=3, trainable=True)
    rng = np.random.default_rng(4)
    sides = []
    for _side in range(2):
        mask = np.arange(16)[None, :] < rng.integers(2, 17, 8)[:, None]
        ids = np.where(mask, rng.integers(4, 512, (8, 16)), 0)
        sides += [torch.from_numpy(ids), torch.from_numpy(mask)]
    batch = ttrain.ContrastiveBatch(*sides)

    def run(attn_fn):
        model.zero_grad(set_to_none=True)
        loss = ttrain.info_nce_loss(model, batch, cfg, 0.05, attn_fn)
        nodes = _graph_nodes(loss)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}, nodes

    fused_loss, fused, fused_nodes = run(tfa.flash_attention)
    split_loss, split, split_nodes = run(lambda q, k, v, mask: tfa.flash_attention(q, k, v, mask))
    _, _, dense_nodes = run(tt.dense_attention)
    assert "FlashAttentionQKVBackward" in fused_nodes and "SplitBackward0" not in fused_nodes
    assert "FlashAttentionBackward" in split_nodes and "SplitBackward0" in split_nodes
    assert "FlashAttentionQKVBackward" not in dense_nodes and "SplitBackward0" in dense_nodes
    assert abs(fused_loss - split_loss) <= ROUTE_TOL
    for name, g in fused.items():
        assert (g - split[name]).abs().max().item() <= ROUTE_TOL, name


@pytest.mark.parametrize("masked", [True, False])
def test_fused_dqkv_matches_jax_pallas_backward(masked):
    b, t, h, d = 2, 128, 2, 16
    qkv, do, mask = _inputs(b, t, h, d, seed=5, masked=masked)
    _o, dqkv = _fused_grad(qkv, do, mask, h)
    q, k, v = (x.reshape(b, t, h, d) for x in np.split(qkv, 3, axis=-1))
    bias = np.zeros((b, t), np.float32) if mask is None else np.where(mask, 0.0, tfa.NEG_INF).astype(np.float32)
    _out, vjp = jax.vjp(jfa._flash_diff, *(jnp.asarray(x) for x in (q, k, v, bias)))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))[:3]]
    ours = [g.numpy() for g in tfa.split_heads(dqkv, h)]
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        assert np.abs(a - r).max() < JAX_TOL, name
