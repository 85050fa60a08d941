"""The committed real checkpoint (tests/fixtures/tiny_bert) through the port's own
importer and encoder reproduces its golden torch embeddings to 1e-4, the bar of
tests/test_checkpoint_parity.py; and the port's tokenizers give the JAX package's ids
bit for bit."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pathway_tpu.xpacks.llm import _tokenizer as jtok
from pathway_tpu_torch.models import Encoder, embed, import_hf_encoder, load_sentence_transformer
from pathway_tpu_torch.xpacks.llm import _tokenizer as ttok
from pathway_tpu_torch.xpacks.llm import EncoderEmbedder

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_bert")

TEXTS = [
    "Stream processing with incremental joins!",
    "The quick brown fox — jumps over 12 lazy dogs.",
    "naïve café déjà-vu, 東京 and snake_case_words",
    "",
    "a " * 80,
]


@pytest.fixture(scope="module")
def golden():
    data = np.load(os.path.join(FIXTURE, "golden_embeddings.npz"))
    return (
        [str(t) for t in data["texts"]],
        np.asarray(data["embeddings"], np.float32),
        np.asarray(data["input_ids"], np.int64),
    )


def test_port_reproduces_torch_goldens_to_1e4(golden):
    texts, expected, _ids = golden
    state, cfg, tok = load_sentence_transformer(FIXTURE)
    assert tok is not None
    # the head count comes from config.json (invisible in tensor shapes)
    assert (cfg.hidden, cfg.layers, cfg.heads) == (64, 2, 4)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    enc = Encoder(cfg, device="cpu", seed=None)
    enc.load_state_dict(state)
    ids, mask = tok.encode_batch(texts, 32)
    ours = embed(enc, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.abs(ours - expected).max() < 1e-4
    sims = ours @ expected.T
    assert np.allclose(np.diag(sims), 1.0, atol=1e-4)


def test_importer_matches_jax_importer_leaf_by_leaf():
    from pathway_tpu.models.hf_import import import_hf_encoder as jax_import
    from pathway_tpu_torch.models import params_from_jax

    import jax

    jparams, jcfg = jax_import(os.path.join(FIXTURE, "model.npz"))
    ours, cfg = import_hf_encoder(os.path.join(FIXTURE, "model.npz"))
    theirs = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(ours) == set(theirs)
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)
    assert (cfg.vocab_size, cfg.hidden, cfg.layers, cfg.intermediate) == (
        jcfg.vocab_size, jcfg.hidden, jcfg.layers, jcfg.intermediate)


def test_importer_reads_a_torch_state_dict_file(tmp_path):
    sd = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(FIXTURE, "model.npz")).items()}
    path = tmp_path / "pytorch_model.bin"
    torch.save({f"bert.{k}": v for k, v in sd.items()}, path)
    a, _ = import_hf_encoder(str(path))
    b, _ = import_hf_encoder(os.path.join(FIXTURE, "model.npz"))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_embedder_serves_fixture_checkpoint(golden):
    texts, expected, _ids = golden
    emb = EncoderEmbedder(model=FIXTURE, max_len=32, device="cpu")
    assert emb.config.heads == 4
    out = emb.embed_batch(texts).numpy()
    # bf16 compute (the default config): the f32 bar is the test above
    assert np.abs(out - expected).max() < 2e-2
    assert (np.argmax(out @ expected.T, axis=1) == np.arange(len(texts))).all()


def test_wordpiece_ids_equal_jax(golden):
    texts, _emb, input_ids = golden
    vocab = os.path.join(FIXTURE, "vocab.txt")
    ours, theirs = ttok.WordPieceTokenizer(vocab), jtok.WordPieceTokenizer(vocab)
    for text in list(texts) + TEXTS:
        assert ours.encode(text, 32) == theirs.encode(text, 32)
    for row, text in zip(input_ids, texts):
        assert ours.encode(text) == [int(t) for t in row if t != ours.pad_id]
    a_ids, a_mask = ours.encode_batch(TEXTS, 16)
    b_ids, b_mask = theirs.encode_batch(TEXTS, 16)
    assert np.array_equal(a_ids, b_ids) and np.array_equal(a_mask, b_mask)


@pytest.mark.parametrize("vocab_size", [30522, 512])
def test_hash_tokenizer_ids_equal_jax(vocab_size):
    ours, theirs = ttok.HashTokenizer(vocab_size), jtok.HashTokenizer(vocab_size)
    for max_len in (8, 128):
        a = ours.encode_batch(TEXTS, max_len)
        b = theirs.encode_batch(TEXTS, max_len)
        assert a[0].dtype == b[0].dtype == np.int32
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    a = ours.encode_pair_batch(TEXTS, TEXTS[::-1], 24)
    b = theirs.encode_pair_batch(TEXTS, TEXTS[::-1], 24)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_pad_to_buckets_equals_jax():
    ids, mask = ttok.HashTokenizer().encode_batch(TEXTS, 128)
    for seq_min in (8, 128):
        a = ttok.pad_to_buckets(ids, mask, seq_bucket_min=seq_min)
        b = jtok.pad_to_buckets(ids, mask, seq_bucket_min=seq_min)
        assert a[2] == b[2] == len(TEXTS)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
