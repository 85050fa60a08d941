"""Document parsers.

Counterpart of ``pathway_tpu/xpacks/llm/parsers.py``. ``ParseUtf8`` (``Utf8Parser``)
is the core path and ``PypdfParser`` extracts PDF text natively (``_pdf.py``);
``ImageParser`` and ``SlideParser`` embed images with the ViT on the card unless a
vision LLM is injected. ``ParseUnstructured`` and ``OpenParse`` need optional
libraries and raise ``ImportError``, as in the JAX package. Every parser returns a
tuple of ``(text, metadata)`` parts.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.udfs import UDF, SyncExecutor


class ParseUtf8(UDF):
    """bytes/str -> ((text, metadata),) — the identity document parser."""

    def __init__(self) -> None:
        def parse(contents: Any) -> tuple:
            if isinstance(contents, bytes):
                text = contents.decode("utf-8", errors="replace")
            else:
                text = str(contents)
            return ((text, {}),)

        super().__init__(parse, executor=SyncExecutor(), deterministic=True)


class Utf8Parser(ParseUtf8):
    """Newer reference alias."""


def _gated(name: str, dep: str) -> type:
    class _Gated(UDF):
        def __init__(self, *a: Any, **kw: Any) -> None:
            raise ImportError(
                f"{name} requires the optional dependency {dep!r}, which is "
                f"not available in this environment; use ParseUtf8 or "
                f"pre-extract text upstream"
            )

    _Gated.__name__ = name
    return _Gated


ParseUnstructured = _gated("ParseUnstructured", "unstructured")
OpenParse = _gated("OpenParse", "openparse")


class PypdfParser(UDF):
    """PDF bytes -> ((text, {"format": "pdf"}),) (reference PypdfParser
    parsers.py:746), by the native extractor of ``_pdf.py``: machine-generated PDFs
    with Flate text streams; scanned decks need the vision path."""

    def __init__(self, apply_text_cleanup: bool = True) -> None:
        from pathway_tpu_torch.xpacks.llm._pdf import extract_pdf_text

        def parse(contents: Any) -> tuple:
            data = (
                contents
                if isinstance(contents, bytes)
                else str(contents).encode("latin-1", errors="replace")
            )
            text = extract_pdf_text(data)
            if apply_text_cleanup:
                text = "\n".join(
                    line.strip() for line in text.splitlines() if line.strip()
                )
            return ((text, {"format": "pdf"}),)

        super().__init__(parse, executor=SyncExecutor(), deterministic=True)


_shared_vision_encoder: Any = None


def _default_vision_encoder():
    """The shared ``ImageEmbedder`` on the card behind the parsers' vision seam when
    no vision LLM is injected (preset from ``PATHWAY_VISION_PRESET``; ``vit-b16``, the
    CLIP image tower, by default), built at first use. One instance serves every
    parser, so the ViT's weights are made once per process."""
    global _shared_vision_encoder
    if _shared_vision_encoder is None:
        import os

        from pathway_tpu_torch.xpacks.llm.embedders import ImageEmbedder

        _shared_vision_encoder = ImageEmbedder(
            model=os.environ.get("PATHWAY_VISION_PRESET", "vit-b16"),
            device_resident=False,
        )
    return _shared_vision_encoder


def _vision_parts(images: list, metas: list, vision: Any) -> list:
    """Embed PIL images with the ViT in one batched forward
    (``vision.embed_images``): each vector lands in its metadata (the multimodal
    retrieval payload) and the text part carries a content signature, so downstream
    text stays content-dependent. One call per document: a 30-page deck is one
    forward, not 30."""
    import hashlib

    import numpy as np

    vecs = vision.embed_images(images)
    texts = []
    for meta, vec in zip(metas, vecs):
        meta["image_embedding"] = [float(x) for x in vec]
        sig = hashlib.blake2s(
            np.round(np.asarray(vec, np.float32), 3).tobytes(), digest_size=6
        ).hexdigest()
        texts.append(
            f"image {meta['format']} {meta['width']}x{meta['height']} "
            f"{meta['mode']} sig={sig}"
        )
    return texts


class ImageParser(UDF):
    """Image bytes -> ((description, metadata),) (reference ImageParser
    parsers.py:396: a vision LLM schema-parses the image).

    ``llm``: callable(image: PIL.Image, prompt: str) -> str — the vision
    model seam (remote vision chat in a deployment, a mock offline).
    Without it the default is the ViT on the card (``ImageEmbedder``, any object
    with ``embed_images`` may be passed as ``vision``): the image's CLIP-style
    embedding lands in ``metadata["image_embedding"]`` (the multimodal retrieval
    payload) and the text part carries a content-dependent signature.
    ``vision=None`` disables the encoder (metadata-only text)."""

    def __init__(
        self,
        llm: Any = None,
        parse_prompt: str = "Describe the image contents.",
        downsize_horizontal_width: int | None = None,
        vision: Any = "default",
    ) -> None:
        import io as _io

        from PIL import Image

        def parse(contents: Any) -> tuple:
            img = Image.open(_io.BytesIO(contents))
            if (
                downsize_horizontal_width
                and img.width > downsize_horizontal_width
            ):
                ratio = downsize_horizontal_width / img.width
                img = img.resize(
                    (downsize_horizontal_width, max(1, int(img.height * ratio)))
                )
            meta = {
                "format": (img.format or "").lower(),
                "width": img.width,
                "height": img.height,
                "mode": img.mode,
            }
            if llm is not None:
                text = str(llm(img, parse_prompt))
            elif vision is not None:
                enc = (
                    _default_vision_encoder() if vision == "default" else vision
                )
                (text,) = _vision_parts([img], [meta], enc)
            else:
                text = (
                    f"image {meta['format']} {img.width}x{img.height} "
                    f"{img.mode}"
                )
            return ((text, meta),)

        super().__init__(
            parse, executor=SyncExecutor(), deterministic=llm is None
        )


class SlideParser(UDF):
    """Slide-deck images -> one (text, metadata) part per frame (reference
    SlideParser parsers.py:569 — OCR+vision over decks). Multi-frame
    images (TIFF/GIF) yield one part per page; the vision seam matches
    ImageParser."""

    def __init__(
        self,
        llm: Any = None,
        parse_prompt: str = "Describe the slide.",
        vision: Any = "default",
    ) -> None:
        import io as _io

        from PIL import Image, ImageSequence

        def parse(contents: Any) -> tuple:
            img = Image.open(_io.BytesIO(contents))
            frames, metas = [], []
            for page, frame in enumerate(ImageSequence.Iterator(img)):
                frames.append(frame.copy())
                metas.append(
                    {
                        "format": (img.format or "").lower(),
                        "page": page,
                        "width": frame.width,
                        "height": frame.height,
                        "mode": frame.mode,
                    }
                )
            if llm is not None:
                texts = [str(llm(f, parse_prompt)) for f in frames]
            elif vision is not None:
                enc = (
                    _default_vision_encoder()
                    if vision == "default"
                    else vision
                )
                # the whole deck in one batched forward
                texts = [
                    f"slide {m['page']}: {t}"
                    for m, t in zip(
                        metas, _vision_parts(frames, metas, enc)
                    )
                ]
            else:
                texts = [
                    f"slide {m['page']}: {m['format']} "
                    f"{m['width']}x{m['height']}"
                    for m in metas
                ]
            return tuple(zip(texts, metas))

        super().__init__(
            parse, executor=SyncExecutor(), deterministic=llm is None
        )
