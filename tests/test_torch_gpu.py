"""Card-only tests of the port: the CUDA kernels against their plain versions, and the
index, encoder and train step on the card against their CPU runs. Marked ``gpu``; each
skips where there is no card (decided inside the fixture, never at import). Run on the
card with

    python -m pytest -m gpu tests/test_torch_*.py

Tolerances: bf16 outputs 2e-2 (outputs rounded to bf16 may differ by an ulp near 1),
f32 1e-4 (only the order of the f32 sums differs), lse 1e-4 relative. The backward's
gradients grow past 1 (a key's dV sums over every query row), so their error is taken
relative to max(1, |plain|) elementwise, as lse's: an ulp of bf16 there is 2^-7
relative at most.
"""

import numpy as np
import pytest
import torch

import pathway_tpu_torch.ops.flash_attention as tfa
from pathway_tpu_torch.engine import DeviceKnnIndex
from pathway_tpu_torch.models import (
    ContrastiveBatch,
    Encoder,
    EncoderConfig,
    embed,
    make_train_step,
    minilm_l6,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3)]


def _mask(pattern: str, b: int, t: int, rng) -> np.ndarray:
    """``random`` keys with sequence 0 fully masked, ``ragged`` 10-34 real keys, or
    ``dead_row`` (ragged, sequence 0 fully masked); and the patterns that exercise the
    kernels' skipping of fully masked 16-key tiles: ``late_keys`` (real keys only in
    the last tile), ``gappy`` (live and masked tiles in turn), ``late_keys_t200`` (real
    keys only past position 128) and ``mixed_dead`` (ragged, the middle sequence fully
    masked)."""
    pos = np.arange(t)[None, :]
    if pattern == "random":
        mask = rng.random((b, t)) > 0.3
        mask[:, 0] = True
        mask[0] = False
    elif pattern == "late_keys":
        mask = np.broadcast_to(pos >= t - 16, (b, t)).copy()
    elif pattern == "gappy":
        mask = np.broadcast_to((pos // 16) % 2 == 0, (b, t)).copy()
    elif pattern == "late_keys_t200":
        mask = np.broadcast_to(pos >= 128, (b, t)).copy()
    else:
        mask = pos < rng.integers(10, 35, b)[:, None]
        if pattern == "dead_row":
            mask[0] = False
        elif pattern == "mixed_dead":
            mask[b // 2] = False
    return mask


@pytest.mark.parametrize(
    "shape,dtype,pattern",
    [
        ((256, 128, 12, 32), torch.bfloat16, "random"),
        ((8, 200, 4, 64), torch.bfloat16, "random"),
        ((4, 77, 2, 16), torch.float32, "random"),
        ((2, 300, 3, 32), torch.float32, "random"),
        ((64, 128, 12, 32), torch.bfloat16, "late_keys"),
        ((8, 128, 4, 32), torch.float32, "late_keys"),
        ((64, 128, 12, 32), torch.bfloat16, "gappy"),
        ((8, 128, 4, 64), torch.float32, "gappy"),
        ((16, 200, 12, 32), torch.bfloat16, "late_keys_t200"),
        ((4, 200, 4, 32), torch.float32, "late_keys_t200"),
        ((64, 128, 12, 32), torch.bfloat16, "mixed_dead"),
        ((8, 128, 4, 32), torch.float32, "mixed_dead"),
    ],
)
def test_kernel_matches_plain_version(cuda, shape, dtype, pattern):
    b, t, h, d = shape
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in _qkv(b, t, h, d, seed=12))
    mask = torch.from_numpy(_mask(pattern, b, t, np.random.default_rng(13))).to(cuda)
    bias = tfa.mask_bias(mask)
    before = tfa.KERNEL.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert tfa.KERNEL.launches == before + 1
    ro, rlse = tfa.flash_attention_fwd_reference(q, k, v, bias)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert (o.float() - ro.float()).abs().max().item() <= tol
    assert ((lse - rlse).abs() / rlse.abs().clamp(min=1)).max().item() <= 1e-4
    o2, _ = tfa.flash_attention_fwd(q, k, v, None)
    r2, _ = tfa.flash_attention_fwd_reference(q, k, v, None)
    assert (o2.float() - r2.float()).abs().max().item() <= tol


def test_kernel_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 24), device=cuda)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, q, q)  # head dim 24
    q = torch.zeros((1, 8, 2, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, q, q)  # fp16


def test_encoder_on_card_matches_cpu(cuda):
    cfg = EncoderConfig(vocab_size=512, hidden=64, layers=2, heads=4, intermediate=128,
                        max_len=64, dtype=torch.float32)
    cpu = Encoder(cfg, device="cpu", seed=5)
    gpu = Encoder(cfg, device=cuda, seed=None)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(4, 512, (8, 32)).astype(np.int32))
    mask = torch.arange(32)[None, :] < torch.from_numpy(rng.integers(2, 33, 8))[:, None]
    before = tfa.KERNEL.launches
    ours = embed(gpu, ids.to(cuda), mask.to(cuda)).cpu()
    assert tfa.KERNEL.launches == before + cfg.layers
    ref = embed(cpu, ids, mask)
    assert (ours - ref).abs().max().item() < 1e-4


def test_index_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(1)
    data = rng.integers(-3, 4, (300, 16)).astype(np.float32)
    data[:, 0] += 5.0  # no zero rows
    queries = rng.integers(-3, 4, (9, 16)).astype(np.float32)
    for metric in ("cos", "l2sq", "dot"):
        a = DeviceKnnIndex(dim=16, metric=metric, capacity=64, device=cuda)
        b = DeviceKnnIndex(dim=16, metric=metric, capacity=64, device="cpu")
        a.add(range(200), torch.from_numpy(data[:200]).to(cuda))
        b.add(range(200), list(data[:200]))
        a.remove(range(0, 200, 7))
        b.remove(range(0, 200, 7))
        a.add(range(150, 300), list(torch.from_numpy(data[150:]).to(cuda)))
        b.add(range(150, 300), list(data[150:]))
        assert a.key_to_slot == b.key_to_slot
        assert a.search(torch.from_numpy(queries).to(cuda), 10) == b.search(list(queries), 10)


def test_index_scores_stay_full_f32_with_tf32_on(cuda):
    """TF32 turned on by the process (both the legacy flag and the precision setting)
    does not reach the index's score matmul, and the process keeps its setting. Bar:
    1e-4 against float64 (TF32 products miss by ~1e-2 here)."""
    rng = np.random.default_rng(2)
    db = rng.normal(size=(4096, 384)).astype(np.float32)
    q = rng.normal(size=(16, 384)).astype(np.float32)
    index = DeviceKnnIndex(dim=384, metric="dot", capacity=4096, device=cuda)
    index.add(range(4096), torch.from_numpy(db).to(cuda))
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        qd, dbd = torch.from_numpy(q).to(cuda), torch.from_numpy(db).to(cuda)
        tf32_err = ((qd @ dbd.T).double().cpu().numpy() - q.astype(np.float64) @ db.astype(np.float64).T)
        hits = index.search(qd, 10)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    ref = q.astype(np.float64) @ db.astype(np.float64).T
    assert np.abs(tf32_err).max() > 1e-3  # TF32 really was on for a plain matmul
    for i, row in enumerate(hits):
        keys = [key for key, _ in row]
        assert keys == list(np.argsort(-ref[i], kind="stable")[:10])
        assert max(abs(s - ref[i, key]) for key, s in row) < 1e-4


def _rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref.float()).abs() / ref.float().abs().clamp(min=1)).max().item()


@pytest.mark.parametrize(
    "shape,dtype,masked",
    [
        ((64, 128, 12, 32), torch.bfloat16, "ragged"),
        ((8, 128, 12, 32), torch.float32, "ragged"),
        ((8, 200, 4, 64), torch.bfloat16, "ragged"),
        ((2, 512, 3, 32), torch.float32, "ragged"),
        ((4, 77, 2, 16), torch.float32, "none"),
        ((4, 200, 2, 32), torch.bfloat16, "dead_row"),
        ((64, 128, 12, 32), torch.bfloat16, "late_keys"),
        ((8, 128, 4, 32), torch.float32, "late_keys"),
        ((64, 128, 12, 32), torch.bfloat16, "gappy"),
        ((8, 128, 4, 64), torch.float32, "gappy"),
        ((16, 200, 12, 32), torch.bfloat16, "late_keys_t200"),
        ((4, 200, 4, 32), torch.float32, "late_keys_t200"),
        ((64, 128, 12, 32), torch.bfloat16, "mixed_dead"),
        ((8, 128, 4, 32), torch.float32, "mixed_dead"),
    ],
)
def test_backward_kernels_match_plain_version(cuda, shape, dtype, masked):
    b, t, h, d = shape
    rng = np.random.default_rng(14)
    q, k, v, do = (
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype) for _ in range(4)
    )
    bias = None
    if masked != "none":
        mask = torch.from_numpy(_mask(masked, b, t, rng)).to(cuda)
        bias = tfa.mask_bias(mask)
    o, lse = tfa.flash_attention_fwd(q, k, v, bias)
    before = (tfa.BWD_DQ_KERNEL.launches, tfa.BWD_DKV_KERNEL.launches)
    ours = tfa.flash_attention_bwd(q, k, v, bias, do, o, lse)
    torch.cuda.synchronize()
    assert (tfa.BWD_DQ_KERNEL.launches, tfa.BWD_DKV_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    ref = tfa.flash_attention_bwd_reference(q, k, v, bias, do, o, lse)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), ours, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert _rel_err(a, r) <= tol, name
    if bias is not None:  # masked keys of sequences with a real key: exact zeros
        dead = ~mask & mask.any(dim=1, keepdim=True)
        assert (ours[1][dead] == 0).all() and (ours[2][dead] == 0).all() and (ours[3][dead] == 0).all()


@pytest.mark.parametrize(
    "shape,dtype,pattern",
    [
        ((64, 128, 12, 32), torch.bfloat16, "ragged"),
        ((8, 200, 4, 64), torch.bfloat16, "mixed_dead"),
        ((4, 77, 2, 16), torch.float32, "random"),
    ],
)
def test_fused_route_matches_split_route_bit_for_bit(cuda, shape, dtype, pattern):
    """``flash_attention_qkv``'s gradient (the kernels writing dq, dk and dv into the
    thirds of one dqkv buffer) equals the split route's dq, dk and dv concatenated, bit
    for bit: the same kernels on the same inputs, no atomics, only the output addresses
    differ."""
    b, t, h, d = shape
    rng = np.random.default_rng(15)
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * h * d)).astype(np.float32)).to(cuda, dtype)
    do = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
    mask = torch.from_numpy(_mask(pattern, b, t, rng)).to(cuda)
    x = qkv.clone().requires_grad_()
    before = (tfa.BWD_DQ_KERNEL.launches, tfa.BWD_DKV_KERNEL.launches)
    o = tfa.flash_attention_qkv(x, mask, h)
    (dqkv,) = torch.autograd.grad(o, x, do)
    assert (tfa.BWD_DQ_KERNEL.launches, tfa.BWD_DKV_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    xs = [y.clone().requires_grad_() for y in tfa.split_heads(qkv, h)]
    o_split = tfa.flash_attention(*xs, mask)
    grads = torch.autograd.grad(o_split, xs, do)
    torch.cuda.synchronize()
    assert torch.equal(o, o_split)
    assert torch.equal(dqkv, torch.cat([g.reshape(b, t, h * d) for g in grads], dim=-1))


def test_backward_kernels_raise_on_what_they_do_not_take(cuda):
    for d, dtype in ((24, torch.float32), (32, torch.float16)):
        x = torch.zeros((1, 8, 2, d), device=cuda, dtype=dtype)
        lse = torch.zeros((1, 2, 8), device=cuda)
        with pytest.raises(ValueError):
            tfa.flash_attention_bwd(x, x, x, None, x, x, lse)
        with pytest.raises(ValueError):
            tfa.flash_attention_bwd_dkv(x, x, x, None, x, lse, lse)
    # outputs are held to the inputs' rules: here a view off the 16-byte grid
    x = torch.zeros((1, 8, 2, 32), device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8), device=cuda)
    bad = torch.zeros((1, 8, 2, 33), device=cuda, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_dq(x, x, x, None, x, x, lse, dq=bad)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_dkv(x, x, x, None, x, lse, lse, dk=bad)


def test_train_step_launches_each_kernel_twelve_times(cuda):
    cfg = minilm_l6()
    init_fn, step_fn = make_train_step(cfg, device=cuda)
    state = init_fn(seed=0)
    rng = np.random.default_rng(3)
    b, t = 16, 32
    ids, masks = [], []
    for _side in range(2):
        mask = np.arange(t)[None, :] < rng.integers(3, t + 1, b)[:, None]
        ids.append(torch.from_numpy(np.where(mask, rng.integers(4, cfg.vocab_size, (b, t)), 0)).to(cuda))
        masks.append(torch.from_numpy(mask).to(cuda))
    batch = ContrastiveBatch(ids[0], masks[0], ids[1], masks[1])
    kernels = (tfa.KERNEL, tfa.BWD_DQ_KERNEL, tfa.BWD_DKV_KERNEL)
    before = [kern.launches for kern in kernels]
    state, loss = step_fn(state, batch)
    torch.cuda.synchronize()
    assert [kern.launches - n for kern, n in zip(kernels, before)] == [2 * cfg.layers] * 3
    assert state.step == 1 and torch.isfinite(loss)
    assert all(torch.isfinite(p).all() for p in state.params.parameters())
