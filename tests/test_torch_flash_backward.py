"""The port's flash-attention backward (its plain version, which CPU tensors take)
against the JAX package's Pallas backward (``_flash_diff``'s custom_vjp, in interpret
mode on the CPU, as tests/test_flash_attention.py runs it, with ``_BLOCK = 32`` so a
test-sized t spans several tiles), and the port's differentiable ``flash_attention``
against torch autograd of ``dense_attention``. Inputs and cotangents come from numpy
with a seed and go to both sides as numpy.

Tolerance: 2e-4 on every gradient, in f32 (tests/test_flash_attention.py's own bar for
the gradients: the same arithmetic, summed in another order and through exp). The
CUDA kernels are held against the plain version on the card in tests/test_torch_gpu.py
(marked ``gpu``) and in chip_smoke.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu_torch.ops.flash_attention as tfa
from pathway_tpu_torch.models.transformer import dense_attention

# the JAX package's ``ops`` re-exports the function under the module's name
jfa = importlib.import_module("pathway_tpu.ops.flash_attention")

TOL = 2e-4
# b * h = 9 is used by no other test, so the JAX kernels traced here with 32-row
# tiles are never a cached trace of another tile size
B, H, D = 3, 3, 16


@pytest.fixture
def small_tiles(monkeypatch):
    monkeypatch.setattr(jfa, "_BLOCK", 32)


def _inputs(t, seed, masked="ragged"):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, t, H, D)).astype(np.float32) for _ in range(4))
    if masked == "none":
        return q, k, v, do, None
    lengths = rng.integers(1, t + 1, B)
    mask = np.arange(t)[None, :] < lengths[:, None]
    if masked == "dead_row":
        mask[1] = False
    return q, k, v, do, mask


def _bias(mask, t):
    if mask is None:
        return np.zeros((B, t), np.float32)
    return np.where(mask, 0.0, tfa.NEG_INF).astype(np.float32)


def _jax_grads(q, k, v, do, mask):
    t = q.shape[1]
    args = [jnp.asarray(x) for x in (q, k, v, _bias(mask, t))]
    _out, vjp = jax.vjp(jfa._flash_diff, *args)
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, mask, bwd=tfa.flash_attention_bwd_reference):
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    bias = None if mask is None else torch.from_numpy(_bias(mask, q.shape[1]))
    o, lse = tfa.flash_attention_fwd(qt, kt, vt, bias)
    return [g.numpy() for g in bwd(qt, kt, vt, bias, dot, o, lse)]


@pytest.mark.parametrize(
    "t,masked", [(64, "ragged"), (64, "none"), (96, "ragged"), (96, "none")]
)
def test_plain_backward_matches_jax_pallas_backward(small_tiles, t, masked):
    q, k, v, do, mask = _inputs(t, seed=t, masked=masked)
    ours = _port_grads(q, k, v, do, mask)
    ref = _jax_grads(q, k, v, do, mask)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), ours, ref):
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() < TOL, name


def test_cpu_wrapper_uses_plain_version_and_counts_no_launch():
    q, k, v, do, mask = _inputs(32, seed=1)
    before = (tfa.BWD_DQ_KERNEL.launches, tfa.BWD_DKV_KERNEL.launches)
    ours = _port_grads(q, k, v, do, mask, bwd=tfa.flash_attention_bwd)
    ref = _port_grads(q, k, v, do, mask)
    for a, b in zip(ours, ref):
        assert np.array_equal(a, b)
    assert (tfa.BWD_DQ_KERNEL.launches, tfa.BWD_DKV_KERNEL.launches) == before


def test_masked_keys_get_exact_zero_gradients():
    q, k, v, do, mask = _inputs(40, seed=2)
    _dq, dk, dv, dbias = _port_grads(q, k, v, do, mask)
    assert (~mask).any()
    assert (dk[~mask] == 0).all() and (dv[~mask] == 0).all() and (dbias[~mask] == 0).all()
    assert (dv[mask] != 0).any()


@pytest.mark.parametrize("t", [16, 200])
def test_autograd_matches_dense_attention(t):
    q, k, v, _do, mask = _inputs(t, seed=t + 7)

    def grads(attn):
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = attn(*xs, torch.from_numpy(mask))
        (out * torch.cos(out)).sum().backward()
        return [x.grad.numpy() for x in xs]

    for name, a, b in zip(("dq", "dk", "dv"), grads(tfa.flash_attention), grads(dense_attention)):
        assert np.abs(a - b).max() < TOL, name


def test_autograd_returns_dbias_only_when_asked():
    q, k, v, do, mask = _inputs(16, seed=3)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    bias = torch.from_numpy(_bias(mask, 16)).requires_grad_()
    args = (tfa.flash_attention_fwd, tfa.flash_attention_bwd)
    tfa.FlashAttention.apply(*xs, bias, *args).backward(torch.from_numpy(do))
    ref = _port_grads(q, k, v, do, mask)
    for x, g in zip([*xs, bias], ref):
        assert np.abs(x.grad.numpy() - g).max() < 1e-6
    # the mask's bias takes no gradient in flash_attention
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tfa.flash_attention(*xs, torch.from_numpy(mask)).sum().backward()
    assert all(x.grad is not None for x in xs)


def test_fully_masked_row_backward_rule(small_tiles):
    """Pinned as documented in ``ops/flash_attention.py``: a fully masked query row has
    lse = -1e30 (-1e30 + log t rounds there in f32), so the recomputed P is 1 for every
    key, not 1/t. The JAX kernel does the same where t is a multiple of its tile (64
    here, with 32-row tiles), and the port agrees with it on every gradient; against
    dense autograd that row's dV is t times larger. Sequences with a real key agree
    with dense autograd."""
    t = 64
    q, k, v, do, mask = _inputs(t, seed=4, masked="dead_row")
    ours = _port_grads(q, k, v, do, mask)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), ours, _jax_grads(q, k, v, do, mask)):
        assert np.abs(a - b).max() < TOL, name

    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    dense_attention(*xs, torch.from_numpy(mask)).backward(torch.from_numpy(do))
    dense_dv = xs[2].grad.numpy()
    dead, live = 1, [0, 2]
    assert np.abs(ours[2][dead] - t * dense_dv[dead]).max() < TOL
    assert np.abs(ours[2][dead] - do[dead].sum(axis=0)[None]).max() < TOL
    assert np.abs(ours[2][live] - dense_dv[live]).max() < TOL
    assert np.abs(ours[0][live] - xs[0].grad.numpy()[live]).max() < TOL
