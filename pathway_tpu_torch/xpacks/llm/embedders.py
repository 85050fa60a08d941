"""Local embedders on the card, UDFs of the engine: sentences (``EncoderEmbedder``)
and images (``ImageEmbedder``, the vision leg of multimodal RAG).

Counterpart of ``TpuEncoderEmbedder`` in ``pathway_tpu/xpacks/llm/embedders.py``: the
same presets, checkpoint-directory loading, ``max_len``, ``max_batch_size`` chunking (by
the UDF's batch executor), ``seq_bucket_min`` and power-of-two padding buckets, and the
rule that derives the mask from the ids on the device when the tokenizer pads with id
0. Used in ``select`` (``embedder(pw.this.text)``), each chunk of a commit is one embed
call whose rows enter the engine as lazy device rows (``device_resident``, on unless
``PATHWAY_DEVICE_RESIDENT_UDF=0``; off, host arrays): the KNN index reads them on the
card, and a host reader gets their host twin. The device pipeline's adaptive controller
narrows the chunks below ``max_batch_size`` (the executor's sizer). ``embed_batch``
returns the tensor to direct callers. With a ``cache_strategy`` the UDF serves repeated
texts from the cache (a lazy row stored in a disk cache pickles as its host array).

``ImageEmbedder`` is the counterpart of ``TpuImageEmbedder``: image bytes are decoded
and resized on the host, sent to the card as uint8 ``[b, 224, 224, 3]`` (a quarter of
f32 pixels' bytes), normalised there (``normalize_u8``, where the JAX package fuses it
into the jitted forward) and embedded by the ViT of ``models/vision.py``, the batch
padded to a power of two of at least 8.

The remote embedders (``OpenAIEmbedder``, ``LiteLLMEmbedder``, ``GeminiEmbedder``) run
as the reference's do, over an injected ``client(model=..., input=text)`` (sync or
async) on the async executor: the package makes no network call of its own, and one
with no client raises ``ValueError``. Their vectors are host f32 arrays.
"""

from __future__ import annotations

import hashlib
import io
import os
from typing import Any, Callable, Sequence

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.engine import device_pipeline
from pathway_tpu_torch.engine.device import lazy_rows
from pathway_tpu_torch.internals.udfs import (
    UDF,
    AsyncRetryStrategy,
    CacheStrategy,
    async_executor,
    batch_executor,
)
from pathway_tpu_torch.models.hf_import import load_sentence_transformer
from pathway_tpu_torch.models.transformer import (
    Encoder,
    EncoderConfig,
    bge_base,
    bge_small,
    embed,
    minilm_l6,
)
from pathway_tpu_torch.models.vision import (
    VisionEncoder,
    clip_vit_b16,
    normalize_u8,
    preprocess_image_u8,
    vision_forward,
    vit_tiny,
)
from pathway_tpu_torch.xpacks.llm._tokenizer import (
    HashTokenizer,
    Tokenizer,
    pad_to_buckets,
)
from pathway_tpu_torch.xpacks.llm.llms import _checkpoint_digest

_ENCODER_PRESETS = {
    "all-MiniLM-L6-v2": "minilm_l6",
    "sentence-transformers/all-MiniLM-L6-v2": "minilm_l6",
    "BAAI/bge-base-en": "bge_base",
    "BAAI/bge-base-en-v1.5": "bge_base",
    "BAAI/bge-small-en-v1.5": "bge_small",
}
_CONFIGS = {"minilm_l6": minilm_l6, "bge_base": bge_base, "bge_small": bge_small}


_VISION_PRESETS = {
    "vit-b16": "clip_vit_b16",
    "clip-vit-b16": "clip_vit_b16",
    "openai/clip-vit-base-patch16": "clip_vit_b16",
    "vit-tiny": "vit_tiny",
}
_VISION_CONFIGS = {"clip_vit_b16": clip_vit_b16, "vit_tiny": vit_tiny}


def _resolve_device_resident(device_resident: "bool | None") -> bool:
    """The device-resident lazy-row mode: the argument, else
    ``PATHWAY_DEVICE_RESIDENT_UDF`` (on by default)."""
    if device_resident is not None:
        return device_resident
    return os.environ.get("PATHWAY_DEVICE_RESIDENT_UDF", "1").lower() in (
        "1",
        "true",
        "yes",
        "on",
    )


def _rows_from_device(vecs: torch.Tensor, device_resident: bool) -> list:
    """A batch of embeddings ``[n, dim]`` -> one row cell each: lazy device rows, all
    of one batch, whose host copy starts at once; or, with ``device_resident`` off, f32
    host arrays."""
    if device_resident:
        return lazy_rows(vecs, vecs.shape[0])
    host = vecs.detach().float().cpu().numpy()
    return [host[i] for i in range(host.shape[0])]


def _weights_tag(path: str) -> str:
    """Identifies a checkpoint directory's weights, not its name: two checkpoints can
    share a basename."""
    h = hashlib.blake2s(digest_size=8)
    for entry in sorted(os.listdir(path)):
        st = os.stat(os.path.join(path, entry))
        h.update(f"{entry}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()


class EncoderEmbedder(UDF):
    """Sentence embedder on the card.

    ``model`` is a preset name, a local sentence-transformers/HF checkpoint directory
    (real weights and WordPiece vocab), or an ``EncoderConfig``. Weights are seeded
    random unless they come from a checkpoint directory or ``params`` (an
    ``Encoder`` state_dict, e.g. from ``params_from_jax``).
    """

    def __init__(
        self,
        model: "str | EncoderConfig" = "all-MiniLM-L6-v2",
        *,
        max_len: int = 128,
        max_batch_size: int = 256,
        tokenizer: Tokenizer | None = None,
        params: dict[str, torch.Tensor] | None = None,
        seed: int = 0,
        seq_bucket_min: int = 8,
        device: "str | torch.device | None" = None,
        cache_strategy: CacheStrategy | None = None,
        device_resident: bool | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.device_resident = _resolve_device_resident(device_resident)
        weights_tag = None
        if isinstance(model, EncoderConfig):
            self.config = model
            preset = "config"
        elif os.path.isdir(model):
            if params is not None and tokenizer is not None:
                # the dir would contribute nothing but a large deserialization
                raise ValueError(
                    "pass either a checkpoint dir or explicit "
                    "params+tokenizer, not both"
                )
            loaded, self.config, wp_tokenizer = load_sentence_transformer(model)
            params = loaded if params is None else params
            tokenizer = wp_tokenizer if tokenizer is None else tokenizer
            weights_tag = _weights_tag(model)
            preset = os.path.basename(os.path.normpath(model))
        else:
            preset = _ENCODER_PRESETS.get(model, model)
            cfg_fn = _CONFIGS.get(preset)
            if cfg_fn is None:
                raise ValueError(
                    f"unknown encoder preset {model!r}; "
                    f"known: {sorted(_ENCODER_PRESETS)} + "
                    f"{sorted(_CONFIGS)}, or a local checkpoint dir"
                )
            self.config = cfg_fn()
        # a checkpoint's positional table caps the usable sequence length
        self.max_len = min(max_len, self.config.max_len)
        #: minimum power-of-two sequence bucket: raise it (up to max_len) to trade
        #: padding FLOPs for fewer distinct shapes
        self.seq_bucket_min = min(seq_bucket_min, self.max_len)
        self.max_batch_size = max_batch_size
        self.tokenizer = tokenizer or HashTokenizer(self.config.vocab_size)
        self.encoder = Encoder(
            self.config, device=self.device, seed=None if params is not None else seed
        )
        if params is not None:
            self.encoder.load_state_dict(params)
        # when the tokenizer pads with id 0 (both built-ins do; bucket padding is
        # 0 too), the mask is derived on the device as ids != 0, which halves the
        # host-to-device uploads per chunk
        pad = getattr(
            self.tokenizer, "pad_id", getattr(self.tokenizer, "pad_token_id", None)
        )
        self._mask_from_ids = pad == 0
        super().__init__(
            self._embed_rows,
            # the device pipeline's controller can only narrow ``max_batch_size``
            executor=batch_executor(
                max_batch_size=max_batch_size, sizer=device_pipeline.suggested_batch_size
            ),
            deterministic=True,
            cache_strategy=cache_strategy,
            cache_name=(
                f"EncoderEmbedder:{preset}:{max_len}:"
                + (f"ckpt{weights_tag}" if weights_tag else f"seed{seed}")
            ),
        )

    def _embed_rows(self, texts: list) -> list:
        """The UDF's body: one executor chunk of texts -> one row per text."""
        return _rows_from_device(self.embed_batch(texts), self.device_resident)

    def get_embedding_dimension(self) -> int:
        return self.config.hidden

    def tokenize(self, texts: Sequence[str]) -> tuple[torch.Tensor, torch.Tensor, int]:
        """-> (ids ``[B, T]``, mask ``[B, T]`` on the device, real batch size), with
        batch and sequence padded to the buckets."""
        ids, mask = self.tokenizer.encode_batch([str(t) for t in texts], self.max_len)
        ids, mask, real = pad_to_buckets(ids, mask, seq_bucket_min=self.seq_bucket_min)
        ids_dev = torch.from_numpy(ids).to(self.device)
        if self._mask_from_ids and np.array_equal(mask, ids != 0):
            mask_dev = ids_dev != 0
        else:
            mask_dev = torch.from_numpy(mask).to(self.device)
        return ids_dev, mask_dev, real

    def embed_batch(self, texts: Sequence[str]) -> torch.Tensor:
        """Texts -> L2-normalised embeddings ``[n, hidden]`` f32 on the device, in
        chunks of at most ``max_batch_size``. The rows stay on the card:
        ``DeviceKnnIndex.add`` and ``search`` take them there."""
        texts = list(texts)
        if not texts:
            return torch.empty((0, self.config.hidden), device=self.device)
        out = []
        for start in range(0, len(texts), self.max_batch_size):
            ids, mask, real = self.tokenize(texts[start : start + self.max_batch_size])
            out.append(embed(self.encoder, ids, mask)[:real])
        return out[0] if len(out) == 1 else torch.cat(out)


class SentenceTransformerEmbedder(EncoderEmbedder):
    """The name the reference's embedder goes by."""


class ImageEmbedder(UDF):
    """Image bytes (or PIL images) -> L2-normalised vectors on the card, by the ViT of
    ``models/vision.py``.

    ``model`` is a preset name (``"vit-b16"``, the CLIP ViT-B/16 image tower, or
    ``"vit-tiny"``). Weights are seeded random unless ``params`` (a ``VisionEncoder``
    state_dict, e.g. from ``params_from_jax``) is given: a random ViT still maps
    nearby images to nearby vectors, so retrieval pipelines keep their true shape."""

    def __init__(
        self,
        model: str = "vit-b16",
        *,
        params: dict[str, torch.Tensor] | None = None,
        seed: int = 0,
        max_batch_size: int = 64,
        cache_strategy: CacheStrategy | None = None,
        device_resident: bool | None = None,
        device: "str | torch.device | None" = None,
    ) -> None:
        preset = _VISION_PRESETS.get(model, model)
        cfg_fn = _VISION_CONFIGS.get(preset)
        if cfg_fn is None:
            raise ValueError(
                f"unknown vision preset {model!r}; known: {sorted(_VISION_PRESETS)}"
            )
        self.config = cfg_fn()
        self.device = resolve_device(device)
        self.device_resident = _resolve_device_resident(device_resident)
        self.encoder = VisionEncoder(
            self.config, device=self.device, seed=None if params is not None else seed
        )
        if params is not None:
            self.encoder.load_state_dict(params)
            # the namespace names the weights, so two checkpoints never share one
            weights_part = f"ckpt{_checkpoint_digest(params, None)}"
        else:
            weights_part = f"seed{seed}"
        super().__init__(
            self._embed_blobs,
            executor=batch_executor(
                max_batch_size=max_batch_size, sizer=device_pipeline.suggested_batch_size
            ),
            deterministic=True,
            cache_strategy=cache_strategy,
            cache_name=f"ImageEmbedder:{preset}:{weights_part}",
        )

    def _embed_blobs(self, blobs: list) -> list:
        """The UDF's body: one executor chunk of images -> one row per image."""
        from PIL import Image

        pixels = np.stack([
            preprocess_image_u8(
                Image.open(io.BytesIO(b)) if isinstance(b, (bytes, bytearray)) else b,
                self.config,
            )
            for b in blobs
        ])
        return self.embed_pixels(pixels)

    def embed_pixels(self, pixels: np.ndarray) -> list:
        """``[b, H, W, 3]`` uint8 pixels -> one row per image: lazy device rows, or host
        arrays with ``device_resident`` off."""
        return _rows_from_device(self.forward_u8(pixels), self.device_resident)

    def forward_u8(self, pixels: np.ndarray) -> torch.Tensor:
        """``[b, H, W, 3]`` uint8 pixels -> embeddings ``[b, out_dim]`` f32 on the
        device: the batch padded to a power of two of at least 8, uploaded as uint8,
        normalised and embedded on the card."""
        real = pixels.shape[0]
        b = 8
        while b < real:
            b *= 2
        if b != real:
            pad = np.zeros((b - real,) + pixels.shape[1:], pixels.dtype)
            pixels = np.concatenate([pixels, pad])
        dev = torch.from_numpy(np.ascontiguousarray(pixels)).to(self.device)
        return vision_forward(self.encoder, normalize_u8(dev))[:real]

    def embed_images(self, images: list) -> np.ndarray:
        """PIL images -> ``[n, out_dim]`` f32 host array, for direct callers."""
        return np.stack([np.asarray(v, np.float32) for v in self._fn(list(images))])

    def get_embedding_dimension(self) -> int:
        return self.config.out_dim


class _RemoteEmbedder(UDF):
    """A remote embedder behind ``client(model=..., input=text, **client_kwargs)``,
    which may return the vector or an awaitable of it; the vector is taken as host
    f32. Runs on the async executor (``capacity`` calls at once, ``timeout`` seconds a
    call), with the optional cache and retry strategies; the cache name is the class
    and the model."""

    def __init__(
        self,
        model: str,
        client: Callable[..., Any] | None = None,
        *,
        capacity: int | None = None,
        timeout: float | None = None,
        cache_strategy: CacheStrategy | None = None,
        retry_strategy: AsyncRetryStrategy | None = None,
        **client_kwargs: Any,
    ) -> None:
        self.model = model
        self.kwargs = client_kwargs
        if client is None:
            raise ValueError(
                f"{type(self).__name__} needs an async `client` callable "
                "(no network egress here); use xpacks.llm.mocks.fake_embeddings_model "
                "for offline runs"
            )

        async def call(text: str) -> Any:
            result = client(model=self.model, input=str(text), **self.kwargs)
            if hasattr(result, "__await__"):
                result = await result
            return np.asarray(result, np.float32)

        super().__init__(
            call,
            executor=async_executor(capacity=capacity, timeout=timeout),
            cache_strategy=cache_strategy,
            retry_strategy=retry_strategy,
            cache_name=f"{type(self).__name__}:{model}",
        )


class OpenAIEmbedder(_RemoteEmbedder):
    """Reference: embedders.py:85."""

    def __init__(self, model: str = "text-embedding-3-small", **kw: Any):
        super().__init__(model, **kw)


class LiteLLMEmbedder(_RemoteEmbedder):
    """Reference: embedders.py:180."""

    def __init__(self, model: str = "", **kw: Any):
        super().__init__(model, **kw)


class GeminiEmbedder(_RemoteEmbedder):
    """Reference: embedders.py:330."""

    def __init__(self, model: str = "models/text-embedding-004", **kw: Any):
        super().__init__(model, **kw)
