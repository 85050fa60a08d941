"""The port's image tower and image embedder (``pathway_tpu_torch.models.vision``,
``ImageEmbedder``) against the JAX package's ``vision_forward`` and
``TpuImageEmbedder`` on the same weights, carried over by ``params_from_jax``, at
``vit_tiny`` (32 px, patch 8, hidden 64, 2 layers, 4 heads). Pixels and images come
from numpy with a seed.

Tolerances: patchify and the host preprocessing bit for bit (reshapes and PIL's own
resize); ``normalize_u8`` 1e-6 (f32 arithmetic on both sides, the constants rounded
alike); the normalised embeddings 1e-5 in f32 (the same arithmetic, summed in another
order) and 2e-3 in bf16 (both sides round the same values to bf16 at the same places;
the bf16 matmuls of the two libraries may still round a few values the other way).
"""

import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pathway_tpu.models import vision as jv
from pathway_tpu_torch.models import params_from_jax
from pathway_tpu_torch.models import vision as tv

WAIT_S = 60.0  # every wait is bounded: a stalled pipeline fails, never hangs


@pytest.fixture(scope="module")
def jax_params():
    return jv.init_vision_params(jax.random.key(0), jv.vit_tiny())


@pytest.fixture(scope="module")
def state(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _img(seed: int, size: int = 40) -> Image.Image:
    arr = np.random.default_rng(seed).integers(0, 255, (size, size, 3), np.uint8)
    return Image.fromarray(arr, "RGB")


def _png(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _noisy(img: Image.Image, seed: int) -> Image.Image:
    arr = np.asarray(img, np.uint8).astype(np.int16)
    arr = arr + np.random.default_rng(seed).integers(-14, 14, arr.shape)
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8), "RGB")


def _port_tower(state, dtype):
    cfg = tv.VisionConfig(**{**tv.vit_tiny().__dict__, "dtype": dtype})
    model = tv.VisionEncoder(cfg, device="cpu", seed=None)
    model.load_state_dict(state)
    return model


def test_param_names_follow_the_jax_pytree(state):
    model = tv.VisionEncoder(tv.vit_tiny(), device="cpu")
    assert set(state) == set(model.state_dict())
    assert {"patch_w", "cls", "pos_emb", "pre_ln.scale", "layers.0.ln1.scale",
            "layers.1.qkv_w", "final_ln.bias", "proj"} <= set(state)
    # layer norms stay f32; every other leaf takes the compute dtype
    assert model.pre_ln.scale.dtype == torch.float32
    assert model.patch_w.dtype == model.pos_emb.dtype == model.layers[0].qkv_w.dtype == torch.bfloat16


def test_patchify_and_host_preprocessing_are_bit_equal():
    cfg_j, cfg_t = jv.vit_tiny(), tv.vit_tiny()
    pixels = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(np.float32)
    ours = tv.patchify(torch.from_numpy(pixels), cfg_t).numpy()
    assert np.array_equal(ours, np.asarray(jv.patchify(jnp.asarray(pixels), cfg_j)))
    img = _img(2, size=57)
    assert np.array_equal(tv.preprocess_image_u8(img, cfg_t), jv.preprocess_image_u8(img, cfg_j))
    np.testing.assert_array_equal(tv.preprocess_image(img, cfg_t), jv.preprocess_image(img, cfg_j))


def test_normalize_u8_matches_jax():
    pixels = np.random.default_rng(3).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    ours = tv.normalize_u8(torch.from_numpy(pixels)).numpy()
    theirs = np.asarray(jv.normalize_u8(jnp.asarray(pixels)))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "jdtype,tdtype,tol", [(jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 2e-3)]
)
def test_vision_forward_matches_jax(jax_params, state, jdtype, tdtype, tol):
    cfg = jv.VisionConfig(**{**jv.vit_tiny().__dict__, "dtype": jdtype})
    pixels = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(np.float32)
    theirs = np.asarray(jv.vision_forward(jax_params, jnp.asarray(pixels), cfg))
    ours = tv.vision_forward(_port_tower(state, tdtype), torch.from_numpy(pixels))
    assert ours.dtype == torch.float32 and ours.shape == (4, 32)
    np.testing.assert_allclose(np.linalg.norm(ours.numpy(), axis=-1), 1.0, atol=1e-5)
    assert np.abs(ours.numpy() - theirs).max() < tol


@pytest.mark.parametrize("n_images", [3, 9])  # padded to batches of 8 and 16
def test_image_embedder_matches_tpu_image_embedder(jax_params, state, monkeypatch, n_images):
    """PNG bytes through ``ImageEmbedder`` and ``TpuImageEmbedder`` (host rows), with
    the batch padding, both presets set to f32 compute: this holds the embedders'
    decoding, padding, upload and normalisation at the f32 bar. (In bf16 the JAX
    embedder's jitted forward and JAX's own eager forward differ by 2.05e-3 on these
    images, past the bf16 bar, so the bf16 arithmetic is held eagerly, by
    ``test_vision_forward_matches_jax``.)"""
    from pathway_tpu.xpacks.llm.embedders import TpuImageEmbedder
    from pathway_tpu_torch.xpacks.llm import ImageEmbedder
    from pathway_tpu_torch.xpacks.llm import embedders as temb

    tiny_j, tiny_t = jv.vit_tiny(), tv.vit_tiny()
    monkeypatch.setattr(jv, "vit_tiny", lambda: jv.VisionConfig(**{**tiny_j.__dict__, "dtype": jnp.float32}))
    monkeypatch.setitem(temb._VISION_CONFIGS, "vit_tiny",
                        lambda: tv.VisionConfig(**{**tiny_t.__dict__, "dtype": torch.float32}))
    blobs = [_png(_img(i)) for i in range(n_images)]
    theirs = TpuImageEmbedder(model="vit-tiny", params=jax_params, device_resident=False)
    ours = ImageEmbedder(model="vit-tiny", params=state, device_resident=False, device="cpu")
    assert ours.config.dtype == torch.float32 and theirs.config.dtype == jnp.float32
    assert ours.get_embedding_dimension() == theirs.get_embedding_dimension() == 32
    a = np.stack(ours._fn(blobs))
    b = np.stack([np.asarray(v, np.float32) for v in theirs._fn(blobs)])
    assert a.shape == b.shape == (n_images, 32)
    assert np.abs(a - b).max() < 1e-5


def test_image_embedder_rows_are_lazy_device_rows_by_default(state):
    from pathway_tpu_torch.engine.device import LazyDeviceVector
    from pathway_tpu_torch.xpacks.llm import ImageEmbedder

    emb = ImageEmbedder(model="vit-tiny", params=state, device="cpu")
    rows = emb._fn([_png(_img(1)), _png(_img(2))])
    assert all(isinstance(r, LazyDeviceVector) for r in rows)
    assert rows[0].batch is rows[1].batch  # one batch, of the real rows only
    host = ImageEmbedder(model="vit-tiny", params=state, device_resident=False, device="cpu")
    np.testing.assert_array_equal(np.stack([np.asarray(r) for r in rows]),
                                  np.stack(host._fn([_png(_img(1)), _png(_img(2))])))


def test_image_embedder_options(state):
    from pathway_tpu_torch.xpacks.llm import ImageEmbedder

    from pathway_tpu_torch.internals.udfs import InMemoryCache

    cached = ImageEmbedder(model="vit-tiny", params=state, cache_strategy=InMemoryCache(),
                           device_resident=False, device="cpu")
    blobs = [_png(_img(1)), _png(_img(2)), _png(_img(1))]
    rows = cached.execute_rows([(b,) for b in blobs], n_pos=1)
    assert len(cached._cache._data) == 2  # one entry per distinct image
    np.testing.assert_array_equal(np.asarray(rows[0][1]), np.asarray(rows[2][1]))
    with pytest.raises(ValueError, match="unknown vision preset"):
        ImageEmbedder(model="vit-huge", device="cpu")
    seeded = ImageEmbedder(model="vit-tiny", seed=4, device="cpu")
    assert seeded._cache_name == "ImageEmbedder:vit_tiny:seed4"
    custom = ImageEmbedder(model="vit-tiny", params=state, device="cpu")
    again = ImageEmbedder(model="vit-tiny", params=state, device="cpu")
    assert custom._cache_name.startswith("ImageEmbedder:vit_tiny:ckpt")
    assert custom._cache_name == again._cache_name


def test_locality_nearest_neighbor_recovers_source():
    """A noisy variant of an image embeds nearer its source than the other images do:
    the property multimodal retrieval rests on (tests/test_vision.py's, on the port)."""
    from pathway_tpu_torch.xpacks.llm import ImageEmbedder

    emb = ImageEmbedder(model="vit-tiny", device_resident=False, device="cpu")
    base = [_img(i) for i in range(6)]
    mat = emb.embed_images(base)
    q = emb.embed_images([_noisy(base[3], 0)])[0]
    sims = mat @ q
    assert int(np.argmax(sims)) == 3, sims


def test_pw_run_answers_each_noisy_image_with_its_source():
    """``bench.py::multimodal_leg``'s program at tiny size through the port's
    ``pw.run``: images through the python connector and the embedder UDF into
    ``DataIndex``; each noisy query's top-1 is its source image."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.stdlib.indexing import DataIndex, DeviceKnnFactory
    from pathway_tpu_torch.xpacks.llm import ImageEmbedder

    n_imgs, n_queries = 12, 4
    images = [_img(i) for i in range(n_imgs)]
    embedder = ImageEmbedder(model="vit-tiny", max_batch_size=8, device="cpu")
    ingest_done, answer_seen = threading.Event(), threading.Event()
    img_ids, answers, failures = {}, {}, []

    class ImgFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i, img in enumerate(images):
                self.next(img_id=i, data=_png(img))

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            if not ingest_done.wait(WAIT_S):
                failures.append("images did not all arrive")
                return
            for i in range(n_queries):
                answer_seen.clear()
                self.next(qid=i, data=_png(_noisy(images[(i * 5) % n_imgs], i)))
                if not answer_seen.wait(WAIT_S):
                    failures.append(f"no answer to query {i}")
                    return

    imgs = pw.io.python.read(ImgFeed(), schema=pw.schema_from_types(img_id=int, data=bytes),
                             autocommit_duration_ms=50)
    imgs = imgs.select(img_id=pw.this.img_id, emb=embedder(pw.this.data))
    queries = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(qid=int, data=bytes),
                                autocommit_duration_ms=None)
    queries = queries.select(qid=pw.this.qid, qemb=embedder(pw.this.data))
    factory = DeviceKnnFactory(dimensions=embedder.get_embedding_dimension(), capacity=16,
                               device="cpu")
    res = DataIndex(imgs, factory, imgs.emb).query_as_of_now(queries, queries.qemb,
                                                             number_of_matches=1)

    def on_img(key, row, time, is_addition):
        if is_addition:
            img_ids[key] = row["img_id"]
            if len(img_ids) == n_imgs:
                ingest_done.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            hits = row["_pw_index_reply_ids"]
            answers[row["qid"]] = img_ids.get(hits[0]) if hits else None
            answer_seen.set()

    pw.io.subscribe(imgs, on_change=on_img)
    pw.io.subscribe(res, on_change=on_answer)
    runner = threading.Thread(target=pw.run, daemon=True)
    runner.start()
    runner.join(4 * WAIT_S)
    assert not runner.is_alive(), "pw.run did not end"
    assert not failures, failures
    assert answers == {i: (i * 5) % n_imgs for i in range(n_queries)}
