"""The port's flash attention (its plain version on CPU tensors) against the JAX
package's Pallas kernel (``pathway_tpu.ops.flash_attention``, in interpret mode on the
CPU, as tests/test_flash_attention.py runs it). Inputs come from numpy with a seed and
go to both sides as numpy.

Tolerances: 2e-5 in f32 (tests/test_flash_attention.py's own bar: only the order of
the f32 sums differs) and 2e-2 in bf16 (outputs rounded to bf16 may differ by an ulp
near 1). The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_gpu.py (marked ``gpu``) and in chip_smoke.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu_torch.ops.flash_attention as tfa

# the JAX package's ``ops`` re-exports the function under the module's name
jfa = importlib.import_module("pathway_tpu.ops.flash_attention")

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3)]


def _padding_mask(b, t, seed):
    mask = np.random.default_rng(seed).random((b, t)) > 0.3
    mask[:, 0] = True
    return mask


def _jax(q, k, v, mask, dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    m = None if mask is None else jnp.asarray(mask)
    return np.asarray(jfa.flash_attention(*args, m), np.float32)


def _torch(q, k, v, mask, dtype=torch.float32):
    args = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    return tfa.flash_attention(*args, m).float().numpy()


@pytest.mark.parametrize("t", [8, 64, 200, 256])
def test_matches_jax_with_padding_mask(t):
    q, k, v = _qkv(2, t, 4, 32, seed=t)
    mask = _padding_mask(2, t, seed=t + 1)
    assert np.abs(_torch(q, k, v, mask) - _jax(q, k, v, mask)).max() < F32_TOL


def test_mask_none():
    q, k, v = _qkv(1, 16, 2, 16, seed=3)
    assert np.abs(_torch(q, k, v, None) - _jax(q, k, v, None)).max() < F32_TOL


@pytest.mark.parametrize("t", [32, 200])
def test_bf16_inputs(t):
    q, k, v = _qkv(2, t, 2, 32, seed=5)
    mask = _padding_mask(2, t, seed=6)
    ours = _torch(q, k, v, mask, torch.bfloat16)
    ref = _jax(q, k, v, mask, jnp.bfloat16)
    assert np.abs(ours - ref).max() < BF16_TOL


@pytest.mark.parametrize("t", [64, 256])
def test_fully_masked_row_is_mean_of_v(t):
    # t a multiple of the JAX kernel's tile: for other t the JAX glue pads keys in,
    # and a fully masked row there averages over the padded length too
    q, k, v = _qkv(2, t, 2, 32, seed=7)
    mask = _padding_mask(2, t, seed=8)
    mask[1] = False
    ours = _torch(q, k, v, mask)
    assert np.abs(ours - _jax(q, k, v, mask)).max() < F32_TOL
    assert np.abs(ours[1] - v[1].mean(axis=0)[None]).max() < F32_TOL
    assert np.isfinite(ours).all()


@pytest.mark.parametrize("t", [8, 200])
def test_lse_matches_jax_kernel(t):
    """flash_attention_fwd's second output is the JAX kernel's per-row
    logsumexp (its backward residual), as [b, h, t]."""
    b, h = 2, 4
    q, k, v = _qkv(b, t, h, 32, seed=9)
    mask = _padding_mask(b, t, seed=10)
    bias = np.where(mask, 0.0, tfa.NEG_INF).astype(np.float32)
    _out, res = jfa._flash_diff_fwd(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(bias))
    jax_lse = np.asarray(res[5]).reshape(b, h, -1)[:, :, :t]
    o, lse = tfa.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(bias))
    assert lse.shape == (b, h, t) and lse.dtype == torch.float32
    assert np.abs(lse.numpy() - jax_lse).max() < 1e-4
    assert np.abs(o.numpy() - _jax(q, k, v, mask)).max() < F32_TOL


def test_cpu_wrapper_uses_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 2, 16, seed=11))
    before = tfa.KERNEL.launches
    o, lse = tfa.flash_attention_fwd(q, k, v)
    ro, rlse = tfa.flash_attention_fwd_reference(q, k, v)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert tfa.KERNEL.launches == before


def test_fully_masked_row_at_ragged_t_averages_the_real_keys():
    """A deliberate departure from the JAX glue, pinned so it cannot drift: for t not a
    multiple of the JAX kernel's 128 tile, ``_prepare`` pads keys with zero v and
    -1e30 bias, so a fully masked row averages over ceil128(t) keys, i.e. mean(v) *
    t / ceil128(t). The port (plain version and CUDA kernel alike) averages exactly
    the t keys it was given. Rows with a real key agree with JAX at the f32 bar."""
    t, padded = 200, 256
    q, k, v = _qkv(2, t, 2, 32, seed=12)
    mask = _padding_mask(2, t, seed=13)
    mask[1] = False
    ours, ref = _torch(q, k, v, mask), _jax(q, k, v, mask)
    mean_v = v[1].mean(axis=0)[None]
    assert np.abs(ours[1] - mean_v).max() < F32_TOL
    assert np.abs(ref[1] - mean_v * t / padded).max() < F32_TOL
    assert np.abs(ours[0] - ref[0]).max() < F32_TOL
