"""The port's encoder (``pathway_tpu_torch.models``) against the JAX package's
``embed`` on the same weights, carried over by ``params_from_jax``. Small config:
hidden 64, 2 layers, 4 heads, vocab 512. Ids and masks come from numpy with a seed.

Tolerances: 1e-5 in f32 (the same arithmetic, summed in another order) and 2e-3 in
bf16 on the L2-normalised embeddings (both sides round the same values to bf16 at the
same places; the bf16 matmuls of the two libraries may still round a few values the
other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import transformer as jt
from pathway_tpu_torch.models import transformer as tt

SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, intermediate=128, max_len=64)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jt.EncoderConfig(**SMALL)
    return jax.tree_util.tree_map(np.asarray, jt.init_encoder_params(jax.random.key(0), cfg))


def _batch(seed, b=4, t=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, SMALL["vocab_size"], (b, t)).astype(np.int32)
    lengths = rng.integers(2, t + 1, b)
    mask = np.arange(t)[None, :] < lengths[:, None]
    ids[~mask] = 0
    return ids, mask


def _port_encoder(params, dtype, pooling="mean"):
    cfg = tt.EncoderConfig(**SMALL, dtype=dtype, pooling=pooling)
    enc = tt.Encoder(cfg, device="cpu", seed=None)
    enc.load_state_dict(tt.params_from_jax(params))
    return enc


@pytest.mark.parametrize(
    "jdtype,tdtype,tol",
    [(jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 2e-3)],
)
@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_embed_matches_jax(jax_params, jdtype, tdtype, tol, pooling):
    ids, mask = _batch(seed=1)
    cfg = jt.EncoderConfig(**SMALL, dtype=jdtype, pooling=pooling)
    ref = np.asarray(jt.embed(jax_params, jnp.asarray(ids), jnp.asarray(mask), cfg))
    enc = _port_encoder(jax_params, tdtype, pooling)
    ours = tt.embed(enc, torch.from_numpy(ids), torch.from_numpy(mask))
    assert ours.dtype == torch.float32 and ours.shape == (4, SMALL["hidden"])
    assert np.abs(ours.numpy() - ref).max() < tol


def test_hidden_states_match_jax_with_mask_none(jax_params):
    ids, _ = _batch(seed=2)
    cfg = jt.EncoderConfig(**SMALL, dtype=jnp.float32)
    ref = np.asarray(jt.encoder_forward(jax_params, jnp.asarray(ids), None, cfg))
    enc = _port_encoder(jax_params, torch.float32)
    ours = tt.encoder_forward(enc, torch.from_numpy(ids), None)
    assert np.abs(ours.numpy() - ref).max() < 1e-5


def test_param_names_follow_the_jax_pytree(jax_params):
    state = tt.params_from_jax(jax_params)
    enc = tt.Encoder(tt.EncoderConfig(**SMALL), device="cpu")
    assert set(state) == set(enc.state_dict())
    assert "layers.1.qkv_w" in state and "emb_ln.scale" in state
    # embedding tables and layer norms stay f32; matmul weights take the compute dtype
    assert enc.tok_emb.dtype == torch.float32
    assert enc.layers[0].attn_ln.scale.dtype == torch.float32
    assert enc.layers[0].qkv_w.dtype == torch.bfloat16


def test_flash_attention_seam_matches_dense_on_cpu(jax_params):
    """The kernel's plain version plugged into the encoder gives the dense
    attention's embeddings (f32)."""
    from pathway_tpu_torch.ops.flash_attention import flash_attention

    ids, mask = _batch(seed=3)
    enc = _port_encoder(jax_params, torch.float32)
    a = tt.embed(enc, torch.from_numpy(ids), torch.from_numpy(mask))
    b = tt.embed(enc, torch.from_numpy(ids), torch.from_numpy(mask), attn_fn=flash_attention)
    assert (a - b).abs().max().item() < 1e-5


def test_seeded_init_is_deterministic():
    cfg = tt.EncoderConfig(**SMALL)
    a = tt.Encoder(cfg, device="cpu", seed=7).state_dict()
    b = tt.Encoder(cfg, device="cpu", seed=7).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert 0.015 < a["tok_emb"].std().item() < 0.025
    assert torch.all(a["layers.0.mlp_ln.scale"] == 1)
