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

import time

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


def test_kernel_matches_plain_version_at_the_vit_shape_with_no_mask(cuda):
    """The vision path's call: t = 197 (not a multiple of the tile), head dim 64, no
    key bias, so the last key tile's tail is read with nothing to mask it."""
    b, t, h, d = 8, 197, 12, 64
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _qkv(b, t, h, d, seed=21))
    before = tfa.KERNEL.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, None)
    torch.cuda.synchronize()
    assert tfa.KERNEL.launches == before + 1
    ro, rlse = tfa.flash_attention_fwd_reference(q, k, v, None)
    assert (o.float() - ro.float()).abs().max().item() <= 2e-2
    assert ((lse - rlse).abs() / rlse.abs().clamp(min=1)).max().item() <= 1e-4


def test_vision_tower_on_card_matches_cpu(cuda):
    from pathway_tpu_torch.models import VisionConfig, VisionEncoder, vision_forward, vit_tiny

    cfg = VisionConfig(**{**vit_tiny().__dict__, "dtype": torch.float32})
    cpu = VisionEncoder(cfg, device="cpu", seed=5)
    gpu = VisionEncoder(cfg, device=cuda, seed=None)
    gpu.load_state_dict(cpu.state_dict())
    pixels = torch.from_numpy(np.random.default_rng(4).normal(size=(6, 32, 32, 3)).astype(np.float32))
    before = tfa.KERNEL.launches
    ours = vision_forward(gpu, pixels.to(cuda)).cpu()
    assert tfa.KERNEL.launches == before + cfg.layers
    assert (ours - vision_forward(cpu, pixels)).abs().max().item() < 1e-4


def test_tiny_decoder_greedy_tokens_repeat_on_the_card(cuda):
    from pathway_tpu_torch.models import Decoder, greedy_generate, tiny_decoder

    model = Decoder(tiny_decoder(), device=cuda, seed=2)
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(rng.integers(4, 512, (3, 9))).to(cuda)
    mask = torch.ones((3, 9), dtype=torch.bool, device=cuda)
    mask[1, :4] = False
    first = greedy_generate(model, ids, 16, eos_id=2, prompt_mask=mask)
    second = greedy_generate(model, ids, 16, eos_id=2, prompt_mask=mask)
    assert first.shape == (3, 16) and torch.equal(first, second)


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


def test_pinned_prefetch_waits_for_the_copy(cuda):
    """The host twin is copied into pinned memory behind the kernels that make the
    batch; ``host()`` is called while the card is still busy with them (the copy not
    yet landed) and must still return the device rows bit for bit."""
    from pathway_tpu_torch.engine import device as tdev

    base = torch.randn((4096, 384), device=cuda)
    # The first pinned allocation of a process, and the first launch of a kernel (its
    # module loads lazily), can wait for the card: make both here with the same ops and
    # sizes (decay returns the pinned buffer to the cache), so that below the host
    # reaches host() while the card is still busy.
    tdev.lazy_rows(base * 3.0 + 1.0, 1)[0].batch.decay()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)  # keep the stream busy ahead of the copy (~0.5 s)
    dev = base * 3.0 + 1.0
    rows = tdev.lazy_rows(dev, 4000)
    handle = rows[0].batch
    in_flight = not handle._copied.query()
    host = handle.host()
    assert in_flight, "the copy had landed before host() was called"
    assert np.array_equal(host, dev.cpu().numpy())
    assert np.array_equal(np.asarray(rows[3999]), dev[3999].cpu().numpy())
    assert host.dtype == np.float32
    handle.decay()
    assert handle.dev is None and tdev.device_batches_held() == 0


def test_staged_handle_read_while_the_worker_waits_on_its_copy(cuda, monkeypatch):
    """A commit staged on the async pipeline: the completion thread waits on the
    handle's copy event (the card is kept busy ahead of the copy) while the scheduler
    thread calls ``host()`` on the same handle; the read waits its turn and returns
    the device rows bit for bit, and the drain leaves no tensor behind."""
    from pathway_tpu_torch.engine import device as tdev
    from pathway_tpu_torch.engine import device_pipeline as dp

    monkeypatch.setenv("PATHWAY_TPU_ASYNC_DEVICE", "1")
    tdev._LIVE_HANDLES.clear()
    dp.PIPELINE.configure()
    base = torch.randn((4096, 384), device=cuda)
    # warm the first pinned allocation and the kernels' first launch (see above)
    tdev.lazy_rows(base * 3.0 + 1.0, 1)[0].batch.decay()
    tdev._LIVE_HANDLES.clear()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)  # keep the stream busy ahead of the copy (~0.5 s)
    dev = base * 3.0 + 1.0
    rows = tdev.lazy_rows(dev, 4096)
    handle = rows[0].batch
    event = handle._copied
    try:
        dp.commit_boundary(0)
        for _ in range(2000):  # the completion thread takes the commit
            if dp.PIPELINE._active_time == 0:
                break
            time.sleep(0.0005)
        waiting = dp.PIPELINE._active_time == 0 and not event.query()
        host = handle.host()
        assert waiting, "the copy had landed before the completion thread waited on it"
        assert np.array_equal(host, dev.cpu().numpy())
        assert np.array_equal(np.asarray(rows[4095]), dev[4095].cpu().numpy())
        dp.drain()
        assert handle.dev is None and dp.PIPELINE.inflight() == 0
        assert dp.PIPELINE.stats()["completed_commits"] >= 1
    finally:
        dp.PIPELINE.configure()
        dp.PIPELINE.stop_worker()


def test_lazy_rows_reach_the_index_with_no_host_copy(cuda):
    from pathway_tpu_torch.engine import device as tdev

    dev = torch.randn((64, 32), device=cuda)
    rows = tdev.lazy_rows(dev, 50, prefetch=False)
    before = dict(tdev.TRANSFERS)
    index = DeviceKnnIndex(dim=32, capacity=128, device=cuda)
    index.add(range(50), rows[::-1])
    torch.cuda.synchronize()
    assert index.rows_device == 50 and index.rows_host == 0
    assert tdev.TRANSFERS == before and rows[0].batch._host is None
    slots = torch.tensor([index.key_to_slot[k] for k in range(50)], device=cuda)
    assert torch.equal(index.state.vectors[slots], dev[:50].flip(0))
    rows[0].batch.decay()


# -- the relational operators on the card -----------------------------------------------


def _zipf_index(rng, n, groups, s=1.1):
    """Zipf(s) over ``[0, groups)``: a draw past the last group is drawn again, so group
    0 keeps its own share of the rows."""
    inverse = rng.zipf(s, n) - 1
    out = inverse >= groups
    while out.any():
        inverse[out] = rng.zipf(s, int(out.sum())) - 1
        out = inverse >= groups
    return inverse.astype(np.int64)


def _segment_inputs(n, groups, cols, rng, zipf=False):
    if zipf:
        inverse = _zipf_index(rng, n, groups)
    else:
        inverse = rng.integers(0, groups, n).astype(np.int64)
    w_int = rng.integers(-(1 << 62), 1 << 62, (cols, n)).astype(np.int64)
    w_float = rng.standard_normal((cols, n)) * 10.0 ** rng.integers(-6, 7, (cols, n))
    return inverse, w_int, w_float


def _counts(kernels) -> dict:
    return {name: k.launches for name, k in kernels.items()}


# by shape (int_sums_shared in csrc/segment_reduce.cu): the shared path at [200k, 1,024]
# with one and two columns, [100k, 8] and [1M, 4,096]; global atomics at [100k, 4,096]
# (few rows a group), [50k, 50k] (the sums past a block's shared memory), [1,000,
# 3,000] and [2,000, 1,000] (few rows)
@pytest.mark.parametrize(
    "n, groups, cols",
    [(200_000, 1024, 1), (200_000, 1024, 2), (100_000, 8, 1), (1_000_000, 4096, 1),
     (100_000, 4096, 1), (50_000, 50_000, 1), (1000, 3000, 3), (2000, 1000, 2)],
)
def test_segment_sum_int_kernel_matches_plain_version(cuda, n, groups, cols):
    """The int kernel at shapes that take each of its paths (shared-memory sums,
    warp-aggregated global atomics), bit for bit against ``index_add_`` and
    ``np.add.at``, wrapping."""
    from pathway_tpu_torch.ops import segment_reduce as sr

    rng = np.random.default_rng(n + groups + cols)
    inverse, w_int, _ = _segment_inputs(n, groups, cols, rng)
    inv_d, w_d = torch.from_numpy(inverse).to(cuda), torch.from_numpy(w_int).to(cuda)
    launches = sr.INT_SUM.launches
    got = sr.segment_sum_int(inv_d, w_d, groups)
    torch.cuda.synchronize()
    assert sr.INT_SUM.launches == launches + 1
    plain = sr.segment_sum_int_reference(inv_d, w_d, groups)
    assert torch.equal(got, plain)
    host = np.zeros((cols, groups), np.int64)
    for c in range(cols):
        np.add.at(host[c], inverse, w_int[c])
    assert np.array_equal(got.cpu().numpy(), host)


@pytest.mark.parametrize(
    "n, shift, bits, key_dtype",
    [(100_000, 0, 10, torch.int64), (100_000, 0, 11, torch.int64), (100_000, 6, 6, torch.int32),
     (4097, 0, 3, torch.int64), (1, 0, 1, torch.int64), (300_000, 11, 10, torch.int32)],
)
def test_radix_pass_kernel_matches_plain_version(cuda, n, shift, bits, key_dtype):
    """One pass (histogram, the scans along tiles and digits, the stable scatter)
    against ``torch.sort(stable=True)`` over the same digit: keys, payload and digit
    ends bit for bit."""
    from pathway_tpu_torch.ops import segment_reduce as sr

    rng = np.random.default_rng(n + bits)
    keys = torch.from_numpy(rng.integers(0, 1 << (shift + bits), n)).to(key_dtype).to(cuda)
    payload = torch.from_numpy(rng.standard_normal((2, n))).to(cuda)
    launches = sr.RADIX_PASS.launches
    got = sr.radix_pass(keys, payload, shift, bits)
    torch.cuda.synchronize()
    assert sr.RADIX_PASS.launches == launches + 1
    plain = sr.radix_pass_reference(keys, payload, shift, bits)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_run_ends_kernel_matches_plain_version(cuda):
    from pathway_tpu_torch.ops import segment_reduce as sr

    rng = np.random.default_rng(5)
    keys = torch.from_numpy(np.sort(rng.integers(0, 70_000, 200_000))).to(torch.int32).to(cuda)
    launches = sr.RUN_ENDS.launches
    got = sr.run_ends(keys, 80_000)  # groups past the last key end at n
    torch.cuda.synchronize()
    assert sr.RUN_ENDS.launches == launches + 1
    assert torch.equal(got, sr.run_ends_reference(keys, 80_000))


@pytest.mark.parametrize(
    "n, groups, zipf",
    [(100_000, 8, False), (100_000, 1024, False), (50_000, 50_000, False), (100_000, 4096, True),
     (1000, 1, False), (31, 1, False), (1000, 3000, False)],
)
def test_fold_runs_kernel_matches_plain_version(cuda, n, groups, zipf):
    """Both run classes (a thread per run under 32 rows, a warp per run and column
    above), over the partition's runs, bit for bit against the plain fold."""
    from pathway_tpu_torch.ops import segment_reduce as sr

    rng = np.random.default_rng(n + groups)
    inverse, _, w_float = _segment_inputs(n, groups, 2, rng, zipf=zipf)
    payload, ends = sr.partition_reference(
        torch.from_numpy(inverse).to(cuda), torch.from_numpy(w_float).to(cuda), groups
    )
    launches = sr.FOLD_RUNS.launches
    got = sr.fold_runs(payload, ends, groups)
    torch.cuda.synchronize()
    assert sr.FOLD_RUNS.launches == launches + 1
    plain = sr.fold_runs_reference(payload, ends, groups)
    assert torch.equal(got.view(torch.int64), plain.view(torch.int64))


@pytest.mark.parametrize(
    "n, groups, ni, nf, zipf",
    [(100_000, 1024, 1, 1, False), (100_000, 8, 1, 2, False), (60_000, 60_000, 2, 1, False),
     (200_000, 65_536, 1, 1, True), (100_000, 4096, 2, 0, False), (5, 3, 1, 1, False),
     (100_000, 1, 1, 1, False)],
)
def test_segment_reduce_kernels_match_the_host(cuda, n, groups, ni, nf, zipf):
    """The whole function on the card against its plain version, ``np.add.at`` and
    ``np.bincount``, bit for bit; an int-only call launches no partition."""
    from pathway_tpu_torch.ops import segment_reduce as sr

    rng = np.random.default_rng(n + groups + nf)
    inverse, w_int, w_float = _segment_inputs(n, groups, max(ni, nf), rng, zipf=zipf)
    w_int, w_float = w_int[:ni], w_float[:nf]
    args = [torch.from_numpy(a).to(cuda) for a in (inverse, w_int, w_float)]
    before = _counts(sr.KERNELS)
    got = sr.segment_reduce(*args, groups)
    torch.cuda.synchronize()
    after = _counts(sr.KERNELS)
    assert after["int_sum"] == before["int_sum"] + 1
    if nf == 0:
        assert all(after[k] == before[k] for k in after if k != "int_sum")
    plain = sr.segment_reduce_reference(*args, groups)
    assert torch.equal(got, plain)
    host = got.cpu().numpy()
    for c in range(ni):
        want = np.zeros(groups, np.int64)
        np.add.at(want, inverse, w_int[c])
        assert np.array_equal(host[c], want)
    for c in range(nf):
        want = np.bincount(inverse, weights=w_float[c], minlength=groups)
        assert np.array_equal(host[ni + c], want.view(np.int64))


def test_segment_reduce_special_values_match_the_host(cuda):
    """NaN, +-inf, -0.0 and long runs of them (a warp's fold pads its last chunk with
    +0.0): the card's bits against ``np.bincount``'s."""
    from pathway_tpu_torch.ops import segment_reduce as sr

    rng = np.random.default_rng(9)
    n, groups = 20_000, 64
    inverse = rng.integers(0, groups, n).astype(np.int64)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-310, -1e308, 1e308])
    w = np.where(rng.random(n) < 0.002, specials[rng.integers(0, 8, n)], rng.standard_normal(n))
    w[inverse == 5] = -0.0  # a long run of -0.0 alone sums to +0.0
    w[inverse == 6] = np.where(np.arange(n)[inverse == 6] % 2, 1e308, -1e308)
    args = [torch.from_numpy(a).to(cuda) for a in (inverse, np.empty((0, n), np.int64), w[None])]
    got = sr.segment_reduce(*args, groups)[0].cpu().numpy()
    want = np.bincount(inverse, weights=w, minlength=groups)
    assert np.array_equal(got, want.view(np.int64))


def test_segment_reduce_raises_on_what_it_does_not_take(cuda):
    from pathway_tpu_torch.ops import segment_reduce as sr

    inv = torch.zeros(8, dtype=torch.int64, device=cuda)
    w_int = torch.zeros((1, 8), dtype=torch.int64, device=cuda)
    w_float = torch.zeros((1, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        sr.segment_reduce(inv, w_int, w_float.float(), 2)
    with pytest.raises(ValueError):
        sr.segment_reduce(inv, w_int, w_float[:, :7].contiguous(), 2)
    with pytest.raises(ValueError):
        sr.segment_reduce(inv, w_int, w_float.cpu(), 2)
    with pytest.raises(ValueError):
        sr.segment_sum_int(inv, w_int[:, :7].contiguous(), 2)


def test_dadd_chain_kernel_rounds_every_add(cuda):
    from pathway_tpu_torch.ops import segment_reduce as sr

    assert sr.dadd_chain(torch.tensor([0.0, 1.0], dtype=torch.float64, device=cuda), 4096).item() == 4096.0
    tiny = torch.tensor([1.0, 2.0**-53], dtype=torch.float64, device=cuda)
    assert sr.dadd_chain(tiny, 64).item() == 1.0


def test_device_operators_on_the_card_match_the_host(cuda):
    """``segment_reduce_dispatch`` and ``match_pairs`` on the card against the host
    kernels, bit for bit."""
    from pathway_tpu_torch.engine import device as hd
    from pathway_tpu_torch.engine import device_ops as dops
    from pathway_tpu_torch.engine import graph as g

    dops.configure(device="cuda")
    try:
        rng = np.random.default_rng(2)
        n, nu = 200_000, 1024
        inverse = rng.integers(0, nu, n)
        diffs = rng.choice([-1, 1], n)
        vals = [rng.standard_normal(n), None, rng.integers(-1000, 1000, n)]
        gd, deltas = dops.segment_reduce_dispatch(inverse, diffs, vals, nu).fetch()
        assert np.array_equal(gd, hd.segment_count(inverse, diffs, nu))
        assert np.array_equal(
            deltas[0].view(np.int64), hd.segment_sum(inverse, vals[0], diffs, nu).view(np.int64)
        )
        assert deltas[1] is None
        assert np.array_equal(deltas[2], hd.segment_sum(inverse, vals[2], diffs, nu))
        la, ra = rng.integers(0, 5000, 100_000), rng.integers(0, 5000, 10_000)
        got = dops.match_pairs([la], [ra])
        ref = g._match_join_pairs(la, ra)
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    finally:
        dops.configure()


def test_kernel_matches_plain_version_at_the_bge_base_shape(cuda):
    """One BGE-base embed call of the vector store: 256 docs of 10-34 tokens in the
    128 bucket, 12 heads of 64, bf16."""
    b, t, h, d = 256, 128, 12, 64
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _qkv(b, t, h, d, seed=31))
    bias = tfa.mask_bias(torch.from_numpy(_mask("ragged", b, t, np.random.default_rng(32))).to(cuda))
    before = tfa.KERNEL.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert tfa.KERNEL.launches == before + 1
    ro, rlse = tfa.flash_attention_fwd_reference(q, k, v, bias)
    assert (o.float() - ro.float()).abs().max().item() <= 2e-2
    assert ((lse - rlse).abs() / rlse.abs().clamp(min=1)).max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_document_store_on_card_matches_cpu(cuda, dtype):
    """A small ``DocumentStore`` over a hidden-64 ``EncoderEmbedder`` (2 layers, the same
    seeded weights) on the card against the same program on the CPU: every top-1 is the query's own
    doc on both; rank by rank the same text, or two texts whose dists are within the
    bar of each other (a seeded model this small maps many docs to nearly the same
    vector, so neighbours that close may trade places), and the dists within the bar:
    1e-4 in f32, 2e-2 (the bf16 bar) in bf16."""
    import pathway_tpu_torch as tpw
    from pathway_tpu_torch.engine import device_ops
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.xpacks.llm import DocumentStore, EncoderEmbedder

    words = "stream table index vector engine commit window join reduce shard".split()
    rng = np.random.default_rng(4)
    texts = [" ".join(words[j] for j in rng.integers(0, len(words), 6)) for _ in range(24)]
    cfg = EncoderConfig(vocab_size=512, hidden=64, layers=2, heads=4, intermediate=128,
                        max_len=64, dtype=dtype)
    bar = 1e-4 if dtype == torch.float32 else 2e-2

    # seeded weights are drawn per device, so the card takes the CPU encoder's
    weights = EncoderEmbedder(cfg, seed=3, device="cpu").encoder.state_dict()

    def answers(device):
        emb = EncoderEmbedder(cfg, max_len=32, max_batch_size=16, params=weights, device=device)
        docs = tpw.debug.table_from_rows(
            tpw.schema_from_types(data=str, _metadata=dict),
            [(t, {"path": f"/d/{i}"}) for i, t in enumerate(texts)],
        )
        store = DocumentStore(docs, embedder=emb, device=device)
        queries = tpw.debug.table_from_rows(tpw.schema_from_types(query=str, k=int),
                                            [(texts[i], 5) for i in range(0, 24, 5)])
        data, _ = tpw.debug.table_to_dicts(store.retrieve_query(queries))
        return [data[key]["result"] for key in sorted(data, key=int)]

    device_ops.configure(device="cpu")
    try:
        ours, ref = answers(cuda), answers("cpu")
    finally:
        device_ops.configure()
        G.clear()
    queries = [texts[i] for i in range(0, 24, 5)]
    assert len(ours) == len(ref) == len(queries)
    assert sorted(r[0]["text"] for r in ours) == sorted(r[0]["text"] for r in ref) == sorted(queries)
    for got, want in zip(ours, ref):
        pairs = [(a["text"], b["text"], a["dist"], b["dist"]) for a, b in zip(got, want)]
        assert len(got) == len(want) == 5, pairs
        assert all(abs(da - db) <= bar for _ta, _tb, da, db in pairs), pairs
        # the top 4: where the card's text differs, the CPU ranks it in its top 5 at a
        # dist within the bar of the CPU's text at that rank
        cpu_dist = {h["text"]: h["dist"] for h in want}
        for ta, tb, _da, _db in pairs[:4]:
            assert ta == tb or (ta in cpu_dist and abs(cpu_dist[ta] - cpu_dist[tb]) <= bar), pairs


def test_rag_evaluator_on_card_matches_cpu(cuda):
    """``RagEvaluator`` over a small ``DocumentStore`` on the card (a hidden-64 f32
    ``EncoderEmbedder``, the CPU encoder's seeded weights) against the same run with
    ``device="cpu"``: each question is a doc's own text, its answer that doc's first
    three words, its source the doc; an oracle chat keyed on the question. Top-1
    retrieval is the question's own doc on both devices, so the reports are equal field
    for field, and the oracle scores 1.0 with no sample missing."""
    import dataclasses

    import pathway_tpu_torch as tpw
    from pathway_tpu_torch.engine import device_ops
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.internals.udfs.executors import stop_event_loop
    from pathway_tpu_torch.xpacks.llm import (
        BaseRAGQuestionAnswerer,
        DocumentStore,
        EncoderEmbedder,
        RagEvalSample,
        RagEvaluator,
    )

    words = "stream table index vector engine commit window join reduce shard".split()
    rng = np.random.default_rng(6)
    texts = [f"doc{i} " + " ".join(words[j] for j in rng.integers(0, len(words), 6))
             for i in range(24)]
    samples = [RagEvalSample(question=t, answer=" ".join(t.split()[:3]), source=t)
               for t in texts[::3]]
    answers = {s.question: s.answer for s in samples}
    cfg = EncoderConfig(vocab_size=512, hidden=64, layers=2, heads=4, intermediate=128,
                        max_len=64, dtype=torch.float32)
    weights = EncoderEmbedder(cfg, seed=3, device="cpu").encoder.state_dict()

    @tpw.udf
    def oracle(prompt: str) -> str:
        question = prompt.rsplit("Question: ", 1)[-1].split("\n", 1)[0]
        return answers.get(question, "No information found.")

    def report(device):
        emb = EncoderEmbedder(cfg, max_len=32, max_batch_size=16, params=weights, device=device)
        docs = tpw.debug.table_from_rows(
            tpw.schema_from_types(data=str, _metadata=dict),
            [(t, {"path": f"/d/{i}"}) for i, t in enumerate(texts)],
        )
        store = DocumentStore(docs, embedder=emb, device=device)
        return RagEvaluator(BaseRAGQuestionAnswerer(oracle, store, search_topk=1)).evaluate(samples)

    device_ops.configure(device="cpu")
    try:
        ours, ref = report(cuda), report("cpu")
    finally:
        device_ops.configure()
        stop_event_loop()
        G.clear()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.n_missing == 0 and ours.n_samples == len(samples)
    assert ours.answer_exact_match == ours.answer_token_f1 == ours.retrieval_hit_rate == 1.0
