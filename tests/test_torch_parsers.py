"""The port's document parsers and splitters (``pathway_tpu_torch/xpacks/llm``:
``parsers.py``, ``_pdf.py``, ``splitters.py``, ``prompts.py``, ``mocks.py``) against
the JAX package's on the same inputs.

Bit for bit: ``ParseUtf8`` and ``Utf8Parser`` parts, ``PypdfParser`` text on PDFs
built here (Flate and plain streams, TJ arrays, escapes), the gated parsers'
``ImportError``, ``TokenCountSplitter`` chunks, the null splitters, the prompt texts
and the mock models' vectors and replies. The image parsers run the vision seam over
``vit_tiny`` (32 px, hidden 64, 2 layers) with the JAX weights carried across by
``params_from_jax``, both in f32: embeddings within 1e-5 (the same f32 arithmetic
summed in another order), texts equal up to their ``sig=`` field (a hash of the
embedding rounded to 3 decimals, which such differences may flip)."""

from __future__ import annotations

import io
import re
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pathway_tpu.models import vision as jv
from pathway_tpu.xpacks.llm import mocks as jmocks
from pathway_tpu.xpacks.llm import parsers as jparsers
from pathway_tpu.xpacks.llm import prompts as jprompts
from pathway_tpu.xpacks.llm import splitters as jsplitters
from pathway_tpu_torch.models import params_from_jax
from pathway_tpu_torch.models import vision as tv
from pathway_tpu_torch.xpacks.llm import mocks as tmocks
from pathway_tpu_torch.xpacks.llm import parsers as tparsers
from pathway_tpu_torch.xpacks.llm import prompts as tprompts
from pathway_tpu_torch.xpacks.llm import splitters as tsplitters

EMB_TOL = 1e-5


def _pdf(content: bytes, flate: bool = True, trailing_eol: bytes = b"\n") -> bytes:
    body = zlib.compress(content) if flate else content
    filt = b" /Filter /FlateDecode" if flate else b""
    return (
        b"%PDF-1.4\n1 0 obj\n<< /Length " + str(len(body)).encode() + filt
        + b" >>\nstream\n" + body + trailing_eol + b"endstream\nendobj\n%%EOF"
    )


PDFS = {
    "flate": _pdf(b"BT /F1 12 Tf 72 700 Td (Hello pathway PDF) Tj ET"),
    "tj_array": _pdf(rb"BT [(Hel) -30 (lo)] TJ T* (wor\(ld\)) Tj ET", flate=False),
    "escapes": _pdf(rb"BT (tab\there \101\102 back\\slash) Tj 0 -14 Td (  next line  ) ' ET"),
    "two_blocks": _pdf(b"BT (first) Tj ET q BT (second) Tj T* (third) Tj ET Q"),
    "crlf": _pdf(b"BT (windows line) Tj ET", trailing_eol=b"\r\n"),
    "no_text": _pdf(b"0 0 m 10 10 l S"),
}


def _fn(udf, *args):
    return udf._fn(*args)


@pytest.mark.parametrize("name", sorted(PDFS))
@pytest.mark.parametrize("cleanup", [True, False])
def test_pypdf_parser_matches_jax(name, cleanup):
    ours = _fn(tparsers.PypdfParser(apply_text_cleanup=cleanup), PDFS[name])
    theirs = _fn(jparsers.PypdfParser(apply_text_cleanup=cleanup), PDFS[name])
    assert ours == theirs
    assert ours[0][1] == {"format": "pdf"}
    if name == "flate":
        assert ours[0][0] == "Hello pathway PDF"


def test_pdf_extraction_refuses_what_is_not_a_pdf():
    from pathway_tpu_torch.xpacks.llm._pdf import extract_pdf_text

    with pytest.raises(ValueError, match="not a PDF"):
        extract_pdf_text(b"plain text")
    # the parser's UDF reports the failure per row, as the JAX package's does
    ours = tparsers.PypdfParser().execute_rows([(b"plain",)], n_pos=1)
    theirs = jparsers.PypdfParser().execute_rows([(b"plain",)], n_pos=1)
    assert [(ok, str(v)) for ok, v in ours] == [(ok, str(v)) for ok, v in theirs]


@pytest.mark.parametrize("contents", [b"caf\xc3\xa9 bytes", b"bad \xff utf8", "a str", 42])
@pytest.mark.parametrize("cls", ["ParseUtf8", "Utf8Parser"])
def test_utf8_parsers_match_jax(cls, contents):
    assert _fn(getattr(tparsers, cls)(), contents) == _fn(getattr(jparsers, cls)(), contents)


@pytest.mark.parametrize("cls", ["ParseUnstructured", "OpenParse"])
def test_gated_parsers_raise_import_error_as_jax(cls):
    messages = []
    for mod in (tparsers, jparsers):
        with pytest.raises(ImportError) as err:
            getattr(mod, cls)()
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert getattr(tparsers, cls).__name__ == cls


def _long_text(seed: int, n: int) -> str:
    rng = np.random.default_rng(seed)
    words = ["stream", "tablé", "index-of", "x", "commit,", "windowwwwwwwwwww", "42", "a.b"]
    return "  ".join(words[j] for j in rng.integers(0, len(words), n))


@pytest.mark.parametrize("min_tokens, max_tokens", [(1, 3), (5, 12), (50, 500), (0, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_token_count_splitter_matches_jax(min_tokens, max_tokens, seed):
    text = _long_text(seed, 60)
    meta = {"path": "/x", "n": seed}
    ours = _fn(tsplitters.TokenCountSplitter(min_tokens, max_tokens), text, meta)
    theirs = _fn(jsplitters.TokenCountSplitter(min_tokens, max_tokens), text, meta)
    assert ours == theirs
    assert " ".join(c for c, _m in ours) == " ".join(text.split())
    assert all(m == meta for _c, m in ours)


@pytest.mark.parametrize("text", ["", "one", _long_text(3, 10)])
def test_null_splitters_match_jax(text):
    assert _fn(tsplitters.NullSplitter(), text, {"a": 1}) == _fn(jsplitters.NullSplitter(), text, {"a": 1})
    assert tsplitters.null_splitter(text) == jsplitters.null_splitter(text)
    assert _fn(tsplitters.TokenCountSplitter(), text) == _fn(jsplitters.TokenCountSplitter(), text)


@pytest.mark.parametrize("docs", [[], ["one doc"], ["a", "b\nc", 3]])
def test_prompts_match_jax(docs):
    q = "what is a stream?"
    assert tprompts.prompt_qa(q, docs) == jprompts.prompt_qa(q, docs)
    assert tprompts.prompt_qa(q, docs, "nope") == jprompts.prompt_qa(q, docs, "nope")
    assert tprompts.prompt_citing_qa(q, docs) == jprompts.prompt_citing_qa(q, docs)
    assert tprompts.prompt_summarize(docs) == jprompts.prompt_summarize(docs)


@pytest.mark.parametrize("dim", [4, 16, 384])
def test_mock_models_match_jax(dim):
    for text in ("", "stream table", "é"):
        np.testing.assert_array_equal(tmocks.fake_embeddings_model(text, dim),
                                      jmocks.fake_embeddings_model(text, dim))
    ours, theirs = tmocks.FakeEmbedder(dim), jmocks.FakeEmbedder(dim)
    assert ours.get_embedding_dimension() == theirs.get_embedding_dimension() == dim
    np.testing.assert_array_equal(_fn(ours, "x"), _fn(theirs, "x"))
    assert _fn(tmocks.IdentityMockChat("m"), "hi") == _fn(jmocks.IdentityMockChat("m"), "hi")
    assert _fn(tmocks.FakeChatModel("ans"), "q") == _fn(jmocks.FakeChatModel("ans"), "q") == "ans"


# -- the image parsers' vision seam ----------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return jv.init_vision_params(jax.random.key(2), jv.vit_tiny())


@pytest.fixture
def encoders(jax_params, monkeypatch):
    """The JAX and the port's vit-tiny image embedders on the same weights, in f32."""
    from pathway_tpu.xpacks.llm.embedders import TpuImageEmbedder
    from pathway_tpu_torch.xpacks.llm import ImageEmbedder
    from pathway_tpu_torch.xpacks.llm import embedders as temb

    tiny_j, tiny_t = jv.vit_tiny(), tv.vit_tiny()
    monkeypatch.setattr(jv, "vit_tiny", lambda: jv.VisionConfig(**{**tiny_j.__dict__, "dtype": jnp.float32}))
    monkeypatch.setitem(temb._VISION_CONFIGS, "vit_tiny",
                        lambda: tv.VisionConfig(**{**tiny_t.__dict__, "dtype": torch.float32}))
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    theirs = TpuImageEmbedder(model="vit-tiny", params=jax_params, device_resident=False)
    ours = ImageEmbedder(model="vit-tiny", params=state, device_resident=False, device="cpu")
    return ours, theirs


def _image(seed: int, size=(40, 28), mode="RGB") -> Image.Image:
    arr = np.random.default_rng(seed).integers(0, 255, (size[1], size[0], 3), np.uint8)
    return Image.fromarray(arr, "RGB").convert(mode)


def _bytes(img: Image.Image, fmt: str = "PNG", **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _deck() -> bytes:
    frames = [_image(s) for s in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, format="TIFF", save_all=True, append_images=frames[1:])
    return buf.getvalue()


def _without_sig(text: str) -> str:
    return re.sub(r"sig=[0-9a-f]+", "sig=", text)


def _same_parts(ours, theirs):
    assert len(ours) == len(theirs)
    for (text, meta), (their_text, their_meta) in zip(ours, theirs):
        assert _without_sig(text) == _without_sig(their_text)
        emb, their_emb = meta.pop("image_embedding", None), their_meta.pop("image_embedding", None)
        assert meta == their_meta
        assert (emb is None) == (their_emb is None)
        if emb is not None:
            assert len(emb) == len(their_emb) == 32
            np.testing.assert_allclose(emb, their_emb, rtol=0, atol=EMB_TOL)


@pytest.mark.parametrize("blob", [
    _bytes(_image(0)),
    _bytes(_image(1, size=(90, 30)), "JPEG"),
    _bytes(_image(2, mode="L")),
])
@pytest.mark.parametrize("downsize", [None, 32])
def test_image_parser_vision_seam_matches_jax(encoders, blob, downsize):
    ours_enc, their_enc = encoders
    ours = _fn(tparsers.ImageParser(vision=ours_enc, downsize_horizontal_width=downsize), blob)
    theirs = _fn(jparsers.ImageParser(vision=their_enc, downsize_horizontal_width=downsize), blob)
    _same_parts([(t, dict(m)) for t, m in ours], [(t, dict(m)) for t, m in theirs])


def test_slide_parser_vision_seam_matches_jax(encoders):
    ours_enc, their_enc = encoders
    ours = _fn(tparsers.SlideParser(vision=ours_enc), _deck())
    theirs = _fn(jparsers.SlideParser(vision=their_enc), _deck())
    assert len(ours) == 3
    _same_parts([(t, dict(m)) for t, m in ours], [(t, dict(m)) for t, m in theirs])


@pytest.mark.parametrize("cls", ["ImageParser", "SlideParser"])
def test_image_parsers_without_the_encoder_match_jax(cls):
    """An injected vision LLM, and ``vision=None`` (metadata-only text)."""
    blob = _deck() if cls == "SlideParser" else _bytes(_image(4))

    def llm(img, prompt):
        return f"{prompt} {img.width}x{img.height}"

    for kw in ({"llm": llm}, {"vision": None}):
        ours = _fn(getattr(tparsers, cls)(**kw), blob)
        theirs = _fn(getattr(jparsers, cls)(**kw), blob)
        assert ours == theirs
    assert getattr(tparsers, cls)(llm=llm)._deterministic is False


def test_default_vision_encoder_is_the_card_image_embedder(monkeypatch):
    """With no vision LLM and no encoder given, the parsers build one shared
    ``ImageEmbedder`` of the preset named by ``PATHWAY_VISION_PRESET``, on the card:
    where there is none, that raises (no CPU fallback)."""
    monkeypatch.setattr(tparsers, "_shared_vision_encoder", None)
    monkeypatch.setenv("PATHWAY_VISION_PRESET", "vit-tiny")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default encoder is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparsers._default_vision_encoder()
