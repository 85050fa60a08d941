"""Card-only tests of the port: the CUDA kernel against its plain version, and the
index and encoder on the card against their CPU runs. Marked ``gpu``; each skips where
there is no card (decided inside the fixture, never at import). Run on the card with

    python -m pytest -m gpu tests/test_torch_*.py

Tolerances: bf16 outputs 2e-2 (outputs rounded to bf16 may differ by an ulp near 1),
f32 1e-4 (only the order of the f32 sums differs), lse 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import pathway_tpu_torch.ops.flash_attention as tfa
from pathway_tpu_torch.engine import DeviceKnnIndex
from pathway_tpu_torch.models import Encoder, EncoderConfig, embed

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((256, 128, 12, 32), torch.bfloat16),
        ((8, 200, 4, 64), torch.bfloat16),
        ((4, 77, 2, 16), torch.float32),
        ((2, 300, 3, 32), torch.float32),
    ],
)
def test_kernel_matches_plain_version(cuda, shape, dtype):
    b, t, h, d = shape
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in _qkv(b, t, h, d, seed=12))
    mask = torch.from_numpy(np.random.default_rng(13).random((b, t)) > 0.3).to(cuda)
    mask[:, 0] = True
    mask[0] = False  # one fully masked row
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
