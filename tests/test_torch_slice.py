"""The slice as a whole: texts ingested in commits and then queried, through the
port's ``EncoderEmbedder`` + ``DeviceKnnIndex`` and through the JAX package's ``embed``
+ ``DeviceKnnIndex``, with the same weights (``params_from_jax``) and the same hashing
tokenizer and padding buckets. Compute is f32 on both sides, so the embeddings agree to
1e-5 and the hits must be the same keys in the same order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.engine.external_index import DeviceKnnIndex as JaxIndex
from pathway_tpu.models import transformer as jt
from pathway_tpu.xpacks.llm._tokenizer import HashTokenizer, pad_to_buckets
from pathway_tpu_torch.engine import DeviceKnnIndex
from pathway_tpu_torch.models import EncoderConfig, params_from_jax
from pathway_tpu_torch.xpacks.llm import EncoderEmbedder

SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, intermediate=128, max_len=64)
WORDS = (
    "stream table index vector engine commit window join reduce shard "
    "tensor batch query embed token device mesh scatter gather fuse"
).split()


def _text(i):
    rng = np.random.default_rng(i)
    return " ".join(WORDS[j] for j in rng.integers(0, len(WORDS), 4 + int(rng.integers(0, 12))))


@pytest.fixture(scope="module")
def setup():
    jcfg = jt.EncoderConfig(**SMALL, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jt.init_encoder_params(jax.random.key(3), jcfg))
    port = EncoderEmbedder(
        EncoderConfig(**SMALL, dtype=torch.float32),
        max_len=32, max_batch_size=16, params=params_from_jax(params), device="cpu",
    )
    tok = HashTokenizer(SMALL["vocab_size"])

    def jax_embed(texts):
        ids, mask = tok.encode_batch(texts, 32)
        ids, mask, real = pad_to_buckets(ids, mask)
        return np.asarray(jt.embed(params, jnp.asarray(ids), jnp.asarray(mask), jcfg))[:real]

    return port, jax_embed


def test_ingest_then_query_gives_the_same_hits(setup):
    port, jax_embed = setup
    texts = [_text(i) for i in range(40)]
    ours = DeviceKnnIndex(dim=SMALL["hidden"], capacity=16, device="cpu")
    theirs = JaxIndex(dim=SMALL["hidden"], capacity=16)
    for start in (0, 7, 20, 33):  # uneven commits; the second grows the index
        end = {0: 7, 7: 20, 20: 33, 33: 40}[start]
        commit = texts[start:end]
        vecs = port.embed_batch(commit)
        ref = jax_embed(commit)
        assert vecs.shape == (len(commit), SMALL["hidden"])
        assert np.abs(vecs.numpy() - ref).max() < 1e-5
        ours.add(range(start, end), vecs)
        theirs.add(list(range(start, end)), list(ref))
    assert ours.key_to_slot == theirs.key_to_slot
    queries = [texts[i] for i in (0, 5, 17, 39)] + ["join shard fuse", "window"]
    hits = ours.search(port.embed_batch(queries), k=5)
    ref_hits = theirs.search(list(jax_embed(queries)), k=5)
    assert [[key for key, _ in h] for h in hits] == [[key for key, _ in h] for h in ref_hits]
    for h, r in zip(hits, ref_hits):
        assert np.abs(np.array([s for _, s in h]) - np.array([s for _, s in r])).max() < 1e-5
    for q, h in zip((0, 5, 17, 39), hits):
        assert h[0][0] == q  # each doc text finds itself first


def test_embed_batch_chunks_by_max_batch_size(setup):
    port, _ = setup
    texts = [_text(i) for i in range(37)]
    whole = port.embed_batch(texts)  # chunks of 16, 16, 5
    parts = torch.cat([port.embed_batch(texts[i:i + 5]) for i in range(0, 37, 5)])
    assert whole.shape == (37, SMALL["hidden"])
    assert (whole - parts).abs().max().item() < 1e-5
    assert port.embed_batch([]).shape == (0, SMALL["hidden"])


def test_default_device_raises_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EncoderEmbedder(EncoderConfig(**SMALL))
