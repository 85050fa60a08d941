"""The port's causal decoder (``pathway_tpu_torch.models.decoder``) against the JAX
package's on the same weights, carried over by ``params_from_jax``, at
``tiny_decoder`` (vocab 512, hidden 64, 2 layers, 4 heads over 2 kv heads). Ids, masks
and activations come from numpy with a seed.

Tolerances: ``rms_norm``, ``rope`` and ``_attend`` 1e-5 in f32 (the same arithmetic,
summed in another order); logits relative to max(1, |x|), 1e-4 in f32 and 2e-2 in
bf16 (bf16 activations round an ulp apart here and there); the cache-chunked forward
2e-4 against the full one (the JAX test's own bar). Greedy tokens are compared for
equality in f32. ``_filter_logits``' keep mask equals JAX's exactly. Sampling cannot
give JAX's tokens (torch has no ``fold_in`` stream), so it is held to its properties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import decoder as jd
from pathway_tpu_torch.models import decoder as td
from pathway_tpu_torch.models import params_from_jax

VOCAB = 512


def _jcfg(dtype=jnp.float32):
    return jd.DecoderConfig(**{**jd.tiny_decoder().__dict__, "dtype": dtype})


def _tcfg(dtype=torch.float32):
    return td.DecoderConfig(**{**td.tiny_decoder().__dict__, "dtype": dtype})


@pytest.fixture(scope="module")
def jax_params():
    return jd.init_decoder_params(jax.random.key(3), jd.tiny_decoder())


@pytest.fixture(scope="module")
def model(jax_params):
    return _port_model(jax_params, torch.float32)


def _port_model(jax_params, dtype):
    m = td.Decoder(_tcfg(dtype), device="cpu", seed=None)
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params)))
    return m


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


def _left_padded(seed: int):
    """Three prompts of 7, 4 and 6 tokens, left-padded to 7."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, VOCAB, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), bool)
    mask[1, :3] = False
    mask[2, :1] = False
    ids[~mask] = 0
    return ids, mask


def test_param_names_follow_the_jax_pytree(jax_params):
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    m = td.Decoder(td.tiny_decoder(), device="cpu")
    assert set(state) == set(m.state_dict())
    assert {"tok_emb", "final_norm", "lm_head", "layers.1.kv_w", "layers.0.mlp_norm"} <= set(state)
    # norm scales stay f32; matmul weights and tok_emb take the compute dtype
    assert m.final_norm.dtype == m.layers[0].attn_norm.dtype == torch.float32
    assert m.tok_emb.dtype == m.layers[0].gate_w.dtype == torch.bfloat16


def test_seeded_init_follows_the_jax_scheme():
    m = td.Decoder(_tcfg(), device="cpu", seed=7)
    assert abs(float(m.tok_emb.std()) - 0.02) < 2e-3
    assert abs(float(m.layers[0].gate_w.std()) - 1 / np.sqrt(64)) < 1e-2
    assert abs(float(m.layers[0].down_w.std()) - 1 / np.sqrt(128)) < 1e-2
    assert torch.equal(m.final_norm, torch.ones(64))
    again = td.Decoder(_tcfg(), device="cpu", seed=7)
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(), again.state_dict().values()))


@pytest.mark.parametrize("fn", ["rms_norm", "rope", "attend"])
def test_primitives_match_jax(fn):
    rng = np.random.default_rng(11)
    if fn == "rms_norm":
        x = rng.normal(size=(2, 5, 64)).astype(np.float32)
        scale = rng.normal(size=(64,)).astype(np.float32)
        theirs = jd.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
        ours = td.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    elif fn == "rope":
        x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
        pos = rng.integers(0, 100, (2, 6)).astype(np.int32)
        theirs = jd.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
        ours = td.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    else:
        q = rng.normal(size=(2, 3, 4, 16)).astype(np.float32)
        k = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
        v = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
        q_pos = np.array([[4, 5, 6], [6, 7, 8]], np.int32)
        k_valid = rng.random((2, 9)) > 0.3
        k_valid[:, 0] = True
        cfg_j, cfg_t = _jcfg(), _tcfg()
        theirs = jd._attend(*map(jnp.asarray, (q, k, v, q_pos, k_valid)), cfg_j)
        ours = td._attend(*map(torch.from_numpy, (q, k, v, q_pos, k_valid)), cfg_t)
    assert ours.shape == theirs.shape
    assert np.abs(ours.numpy() - np.asarray(theirs)).max() < 1e-5


@pytest.mark.parametrize(
    "jdtype,tdtype,tol", [(jnp.float32, torch.float32, 1e-4), (jnp.bfloat16, torch.bfloat16, 2e-2)]
)
def test_decoder_forward_without_cache_matches_jax(jax_params, jdtype, tdtype, tol):
    ids, mask = _left_padded(1)
    theirs, cache = jd.decoder_forward(jax_params, jnp.asarray(ids), _jcfg(jdtype),
                                       attn_mask=jnp.asarray(mask))
    assert cache is None
    ours, cache = td.decoder_forward(_port_model(jax_params, tdtype), torch.from_numpy(ids),
                                     attn_mask=torch.from_numpy(mask))
    assert cache is None and ours.dtype == torch.float32 and ours.shape == (3, 7, VOCAB)
    assert _rel(ours.numpy(), theirs) < tol


def test_cache_chunks_match_the_full_forward(model):
    """As tests/test_models.py's cache test: a 6-token prefill then 4 single-token
    steps into a static cache give the full forward's logits; the cache is written in
    place and its length and valid slots advance."""
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, VOCAB, (2, 10)))
    full, _ = td.decoder_forward(model, ids)
    cache = td.init_cache(model.cfg, 2, 12, "cpu")
    k0 = cache.k[0]
    logits, out = td.decoder_forward(model, ids[:, :6], cache)
    assert out is cache and cache.k[0] is k0
    assert (logits - full[:, :6]).abs().max().item() < 2e-4
    for i in range(6, 10):
        logits, cache = td.decoder_forward(model, ids[:, i:i + 1], cache)
        assert (logits[:, 0] - full[:, i]).abs().max().item() < 2e-4
    assert int(cache.length) == 10
    assert cache.valid[:, :10].all() and not cache.valid[:, 10:].any()
    assert cache.k[1][:, 10:].abs().sum().item() == 0


@pytest.mark.parametrize("case", ["ones", "left_padded_eos", "left_padded"])
def test_greedy_tokens_equal_jax(jax_params, model, case):
    if case == "ones":
        ids, mask, eos = np.ones((2, 4), np.int32), None, None
    else:
        ids, mask = _left_padded(2)
        eos = None
    kw_j = {} if mask is None else {"prompt_mask": jnp.asarray(mask)}
    kw_t = {} if mask is None else {"prompt_mask": torch.from_numpy(mask)}
    theirs = np.asarray(jd.greedy_generate(jax_params, jnp.asarray(ids), _jcfg(), 12, **kw_j))
    if case == "left_padded_eos":
        # an id the rows emit mid-reply becomes the eos: after it, every token is eos
        eos = int(theirs[1, 3])
        theirs = np.asarray(
            jd.greedy_generate(jax_params, jnp.asarray(ids), _jcfg(), 12, eos_id=eos, **kw_j)
        )
        assert (theirs[1, 4:] == eos).all()
    ours = td.greedy_generate(model, torch.from_numpy(ids), 12, eos_id=eos, **kw_t)
    assert ours.shape == (ids.shape[0], 12)
    np.testing.assert_array_equal(ours.numpy(), theirs)


def _filter_cases():
    # ties included: logits quantised to halves collide often
    rng = np.random.default_rng(3)
    mats = [np.round(rng.normal(size=(3, 50)).astype(np.float32) * 4) / 2 for _ in range(6)]
    mats.append(np.log(np.asarray([[0.4, 0.4, 0.2], [0.5, 0.3, 0.2]], np.float32)))
    knobs = [(None, 0.9), (None, 0.3), (5, None), (1, None), (8, 0.6), (50, 1.0),
             (None, 1e-12), (2, 0.3), (None, 0.7)]
    return [(i, k, p) for i in range(len(mats)) for k, p in knobs], mats


_CASES, _MATS = _filter_cases()


@pytest.mark.parametrize("mat,top_k,top_p", _CASES)
def test_filter_logits_keep_mask_equals_jax(mat, top_k, top_p):
    logits = _MATS[mat]
    theirs = np.isfinite(np.asarray(jd._filter_logits(jnp.asarray(logits), top_k, top_p)))
    out = td._filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(out), theirs)
    # kept logits keep their values
    np.testing.assert_array_equal(out[theirs], logits[theirs])


def _sample(model, ids, seeds, **kw):
    kw.setdefault("temperature", 1.5)
    return td.sample_generate(model, torch.from_numpy(ids), 8, seeds, **kw).numpy()


def test_sampling_top_k_1_is_greedy(model):
    ids, mask = _left_padded(4)
    greedy = td.greedy_generate(model, torch.from_numpy(ids), 8, eos_id=2,
                                prompt_mask=torch.from_numpy(mask)).numpy()
    sampled = _sample(model, ids, [5, 6, 7], top_k=1, eos_id=2, prompt_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(sampled, greedy)


def test_sampling_is_deterministic_per_seed_and_varies_across_seeds(model):
    ids = np.random.default_rng(5).integers(4, VOCAB, (2, 5)).astype(np.int32)
    a = _sample(model, ids, np.array([7, 8], np.uint32))
    b = _sample(model, ids, torch.tensor([7, 8]))
    np.testing.assert_array_equal(a, b)
    c = _sample(model, ids, [9, 10])
    assert (a != c).any()


def test_sampled_row_alone_equals_the_row_in_a_batch(model):
    ids, mask = _left_padded(6)
    batch = _sample(model, ids, [11, 12, 13], top_p=0.9, prompt_mask=torch.from_numpy(mask))
    for row in range(3):
        real = ids[row][mask[row]][None]
        alone = _sample(model, real, [11 + row], top_p=0.9)
        np.testing.assert_array_equal(alone[0], batch[row])


def test_samples_stay_within_the_filtered_support(model):
    """Every sampled token lies in the top-k/top-p support of its step's scaled
    logits, recomputed by teacher forcing the emitted tokens through the cache."""
    ids = np.random.default_rng(9).integers(4, VOCAB, (4, 5)).astype(np.int32)
    toks = _sample(model, ids, [1, 2, 3, 4], top_k=6, top_p=0.8)
    cache = td.init_cache(model.cfg, 4, 5 + 8, "cpu")
    logits, cache = td.decoder_forward(model, torch.from_numpy(ids), cache)
    for step in range(8):
        allowed = torch.isfinite(td._filter_logits(logits[:, -1] * (1 / 1.5), 6, 0.8))
        assert 1 <= int(allowed.sum(dim=1).min()) and int(allowed.sum(dim=1).max()) <= 6
        assert allowed[torch.arange(4), torch.from_numpy(toks[:, step])].all()
        logits, cache = td.decoder_forward(model, torch.from_numpy(toks[:, step:step + 1]), cache)
    assert len(np.unique(toks)) > 4  # the draws do move


def test_sample_generate_checks_its_seeds(model):
    with pytest.raises(ValueError, match="row seeds"):
        td.sample_generate(model, torch.ones((2, 3), dtype=torch.long), 4, [1])
