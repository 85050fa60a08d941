"""What the tensor-core flash kernels rely on, pinned on the CPU at small sizes.

(a) Skipping fully masked 16-key tiles is exact: the plain versions over every key and
    over the keys of the live tiles only (gathered) agree to 1e-6 in f32 (only the order
    of the f32 sums may differ), and the masked keys' dK, dV and dbias are exactly 0.
(b) JAX's Pallas kernel (interpret mode, as tests/test_flash_attention.py runs it) agrees
    with the port's plain forward on the new mask patterns at t=128, to 2e-5 (the f32
    bar of tests/test_torch_flash_attention.py).
(c) The kernels' rounding points stay inside the 2e-2 bar against the plain versions:
    the forward rounds P to bf16 before P.V; the dK/dV kernel carries P^T and dS^T as
    two bf16 terms each (hi + lo) into the dV and dK products; the dQ kernel visits only
    the live 16-key tiles (all of them for a dead sequence) and carries dS as two bf16
    terms into dS.K; everything else is f32. The bar: bf16 outputs 2e-2 absolute,
    gradients 2e-2 relative to max(1, |plain|), as chip_smoke.py and
    tests/test_torch_gpu.py hold the kernels. A single bf16 rounding of dS^T (dK/dV) or
    dS (dQ) does not hold it on a dead sequence (P = 1 for every key), which is why the
    kernels carry two terms.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu_torch.ops.flash_attention as tfa

jfa = importlib.import_module("pathway_tpu.ops.flash_attention")

TILE = 16
EXACT_TOL = 1e-6
JAX_TOL = 2e-5
BF16_TOL = 2e-2


def _inputs(b, t, h, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32)).to(dtype) for _ in range(4)]


def _tiled_mask(b, t, seed) -> np.ndarray:
    """Whole 16-key tiles masked among live ones; inside a live tile its first key is
    real and the others are real with probability 0.7."""
    rng = np.random.default_rng(seed)
    tiles = -(-t // TILE)
    mask = np.zeros((b, t), bool)
    for i in range(b):
        live = rng.random(tiles) < 0.4
        live[rng.integers(tiles)] = True
        for j in np.flatnonzero(live):
            keys = np.arange(j * TILE, min(t, (j + 1) * TILE))
            mask[i, keys] = rng.random(len(keys)) < 0.7
            mask[i, keys[0]] = True
    return mask


def _pattern(name, b, t, seed) -> np.ndarray:
    """The mask patterns chip_smoke.py and tests/test_torch_gpu.py add for the kernels."""
    pos = np.arange(t)[None, :]
    if name == "late_keys":  # real keys only in the last 16-key tile
        return np.broadcast_to(pos >= t - TILE, (b, t)).copy()
    if name == "gappy":  # live and fully masked 16-key tiles in turn
        return np.broadcast_to((pos // TILE) % 2 == 0, (b, t)).copy()
    if name == "late_keys_t200":  # real keys only past position 128
        return np.broadcast_to(pos >= 128, (b, t)).copy()
    if name == "mixed_dead":  # one dead sequence among live ragged ones
        mask = pos < np.random.default_rng(seed).integers(10, 35, b)[:, None]
        mask[b // 2] = False
        return mask
    raise ValueError(name)


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref.float()).abs() / ref.float().abs().clamp(min=1)).max().item()


@pytest.mark.parametrize("t", [128, 200])
def test_skipping_masked_tiles_is_exact(t):
    b, h, d = 4, 3, 32
    q, k, v, do = _inputs(b, t, h, d, seed=t)
    mask = _tiled_mask(b, t, seed=t + 1)
    bias = tfa.mask_bias(torch.from_numpy(mask))
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, bias)
    dq, delta = tfa.flash_attention_bwd_dq_reference(q, k, v, bias, do, o, lse)
    dk, dv, dbias_h = tfa.flash_attention_bwd_dkv_reference(q, k, v, bias, do, lse, delta)
    for i in range(b):
        live_tiles = [j for j in range(-(-t // TILE)) if mask[i, j * TILE:(j + 1) * TILE].any()]
        keep = torch.tensor([key for j in live_tiles for key in range(j * TILE, min(t, (j + 1) * TILE))])
        qi, doi = q[i:i + 1], do[i:i + 1]
        ki, vi, bi = k[i:i + 1, keep], v[i:i + 1, keep], bias[i:i + 1, keep]
        oi, lsei = tfa.flash_attention_fwd_reference(qi, ki, vi, bi)
        assert (oi - o[i:i + 1]).abs().max().item() <= EXACT_TOL
        assert ((lsei - lse[i:i + 1]).abs() / lse[i:i + 1].abs().clamp(min=1)).max().item() <= EXACT_TOL
        dqi, deltai = tfa.flash_attention_bwd_dq_reference(qi, ki, vi, bi, doi, o[i:i + 1], lse[i:i + 1])
        dki, dvi, dbi = tfa.flash_attention_bwd_dkv_reference(qi, ki, vi, bi, doi, lse[i:i + 1], deltai)
        assert _rel(dqi, dq[i:i + 1]) <= EXACT_TOL
        assert _rel(dki, dk[i:i + 1, keep]) <= EXACT_TOL
        assert _rel(dvi, dv[i:i + 1, keep]) <= EXACT_TOL
        assert _rel(dbi, dbias_h[i:i + 1, :, keep]) <= EXACT_TOL
        skipped = torch.ones(t, dtype=torch.bool)
        skipped[keep] = False
        assert skipped.any()  # the mask really has fully masked tiles
        assert (dk[i, skipped] == 0).all() and (dv[i, skipped] == 0).all()
        assert (dbias_h[i, :, skipped] == 0).all()


@pytest.mark.parametrize("pattern", ["late_keys", "gappy", "mixed_dead"])
def test_jax_agrees_on_the_new_mask_patterns(pattern):
    b, t, h, d = 3, 128, 2, 32
    q, k, v, _ = _inputs(b, t, h, d, seed=21)
    mask = _pattern(pattern, b, t, seed=22)
    ours = tfa.flash_attention(q, k, v, torch.from_numpy(mask)).numpy()
    ref = np.asarray(jfa.flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)), jnp.asarray(mask)))
    assert np.abs(ours - ref).max() < JAX_TOL


def _split(x: torch.Tensor) -> torch.Tensor:
    """x carried as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), summed in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _emulated_fwd(q, k, v, bias):
    """The forward kernel's arithmetic: 16-key tiles holding a real key in order (every
    tile for a dead sequence), an online softmax in f32, P rounded to bf16 before P.V,
    the row sum from the unrounded P, o rounded once."""
    b, t, h, d = q.shape
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(d) + bias[:, None, None, :]
    live = bias > tfa.NEG_INF / 2
    m = torch.full((b, h, t), tfa.NEG_INF)
    l = torch.zeros((b, h, t))
    acc = torch.zeros((b, h, t, d))
    dead = ~live.any(dim=1)
    for j in range(-(-t // TILE)):
        keys = slice(j * TILE, min(t, (j + 1) * TILE))
        visit = (live[:, keys].any(dim=1) | dead)[:, None, None]
        sj = s[..., keys]
        m_new = torch.maximum(m, sj.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sj - m_new[..., None])
        l = torch.where(visit, l * alpha + p.sum(-1), l)
        acc = torch.where(visit[..., None], acc * alpha[..., None] + _bf16(p) @ v[:, keys].float().transpose(1, 2), acc)
        m = torch.where(visit, m_new, m)
    o = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    return o, m + torch.log(l)


def _emulated_dkv(q, k, v, bias, do, lse, delta, operand):
    """The dK/dV kernel's arithmetic: P^T, dP^T and dS^T in f32, P^T and dS^T through
    ``operand`` before the dV and dK products, dbias from the unrounded dS^T, the scale
    applied to the f32 dK."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale + bias[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhts,bthd->bshd", operand(p), do.float())
    dk = torch.einsum("bhts,bthd->bshd", operand(ds), q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=2)


def _emulated_dq(q, k, v, bias, do, o, lse, operand):
    """The dQ kernel's arithmetic: S, P, dP and dS in f32 over the 16-key tiles holding
    a real key (every tile for a dead sequence), delta from dO and O in f32, dS through
    ``operand`` before the dS.K product, the scale applied to the f32 dQ, one cast."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale + bias[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    live = bias > tfa.NEG_INF / 2
    tiles = -(-t // TILE)
    padded = torch.zeros((b, tiles * TILE), dtype=torch.bool)
    padded[:, :t] = live
    visit = padded.view(b, tiles, TILE).any(dim=-1) | ~live.any(dim=1, keepdim=True)
    visit = visit.repeat_interleave(TILE, dim=1)[:, :t]
    ds = torch.where(visit[:, None, None, :], ds, torch.zeros(()))
    dq = torch.einsum("bhts,bshd->bthd", operand(ds), k.float()) * scale
    return dq.to(q.dtype), delta.contiguous()


def _main_path_inputs(dead: bool):
    """b=8 sequences of 128 tokens with 10-34 real keys (the serving and train batches'
    range), h=12, d=32, bf16; with ``dead``, sequence 3 has no real key."""
    b, t, h, d = 8, 128, 12, 32
    q, k, v, do = _inputs(b, t, h, d, seed=31, dtype=torch.bfloat16)
    mask = np.arange(t)[None, :] < np.random.default_rng(32).integers(10, 35, b)[:, None]
    if dead:
        mask[3] = False
    return q, k, v, do, tfa.mask_bias(torch.from_numpy(mask))


def test_forward_rounding_points_stay_inside_the_bar():
    q, k, v, _, bias = _main_path_inputs(dead=False)
    o, lse = _emulated_fwd(q, k, v, bias)
    ro, rlse = tfa.flash_attention_fwd_reference(q, k, v, bias)
    assert (o.float() - ro.float()).abs().max().item() <= BF16_TOL
    assert ((lse - rlse).abs() / rlse.abs().clamp(min=1)).max().item() <= 1e-4


@pytest.mark.parametrize("dead", [False, True])
def test_backward_rounding_points_stay_inside_the_bar(dead):
    q, k, v, do, bias = _main_path_inputs(dead)
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, bias)
    _, delta = tfa.flash_attention_bwd_dq_reference(q, k, v, bias, do, o, lse)
    ref = tfa.flash_attention_bwd_dkv_reference(q, k, v, bias, do, lse, delta)
    ours = _emulated_dkv(q, k, v, bias, do, lse, delta, _split)
    for name, a, r in zip(("dk", "dv", "dbias"), ours, ref):
        assert _rel(a, r) <= BF16_TOL, name
    single = _emulated_dkv(q, k, v, bias, do, lse, delta, _bf16)
    if dead:  # P = 1 for every key of the dead sequence: one bf16 term is not enough
        assert _rel(single[0], ref[0]) > BF16_TOL


@pytest.mark.parametrize("dead", [False, True])
def test_dq_rounding_points_stay_inside_the_bar(dead):
    """The dQ kernel's emulated arithmetic against its plain version: dq within 2e-2
    relative to max(1, |plain|), delta within 1e-5 (f32 sums in another order). One bf16
    term for dS reads 0.0078 on live sequences but 0.066 on the dead one (t times a live
    row's dS), past the bar, which is why the kernel carries two."""
    q, k, v, do, bias = _main_path_inputs(dead)
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, bias)
    ref, ref_delta = tfa.flash_attention_bwd_dq_reference(q, k, v, bias, do, o, lse)
    dq, delta = _emulated_dq(q, k, v, bias, do, o, lse, _split)
    assert _rel(dq, ref) <= BF16_TOL
    assert (delta - ref_delta).abs().max().item() <= 1e-5
    single, _ = _emulated_dq(q, k, v, bias, do, o, lse, _bf16)
    if dead:
        assert _rel(single, ref) > BF16_TOL
    else:
        assert _rel(single, ref) <= BF16_TOL
