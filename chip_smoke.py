#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device paths once, on one card: the streaming-RAG
serving path, the same pipeline through the port's own engine (``pw.run``), the
contrastive trainer, the other model families (the ViT image embedder of multimodal
RAG, the cross-encoder reranker and the local decoder chat), the relational operators,
the xpack's RAG document pipeline (``VectorStoreServer`` over BGE-base, and the
adaptive RAG question answerer over it), its ``rag_evals`` harness, and the table
operations (the expression namespaces, deduplicate, sort, having, ``apply_async``).

    python3 chip_smoke.py

Phases, each printing one JSON line (and each number beside the card's name and power
limit):

1. device: the card's name, count and power limit; no CUDA means exit 1.
2. build: every ``pathway_tpu_torch/csrc/*.cu`` compiled with ``nvcc`` for ``sm_90a``,
   with its build time and ``-Xptxas -v`` register, shared-memory and spill lines; any
   spill fails. sass: the tensor-core instructions (HMMA, HGMMA) of each kernel's bf16
   instances, counted in ``cuobjdump -sass``; every bf16 instance of the forward, dQ and
   dK/dV must have some.
3. kernel: the flash-attention kernel against its plain PyTorch version on the card at
   the main path's shape and at the edge shapes (head dim 64, t not a multiple of the
   tile, multi-tile t, no mask, a fully masked row, the ViT-B/16 call: t = 197, d = 64,
   no mask, the BGE-base embed call of the vector store: [256, 128, 12, 64] with 10-34
   real keys) and the tile-skipping patterns (real keys only in the last 16-key tile or
   past position 128, live and masked tiles in turn, a dead sequence among live ones);
   then its time at the serving, the train, the vision and the BGE-base serving shape
   against its bound, the plain version and
   ``scaled_dot_product_attention`` (timed here only, as a yardstick; the port never
   calls it).
4. train_kernel: the flash-attention backward's two kernels (dQ, dK/dV) against their
   plain PyTorch version on the card at the train shape, the edge shapes and the
   tile-skipping patterns (masked keys' dK, dV and dbias exact zeros); the fused route
   (``flash_attention_qkv``, whose backward writes dq, dk and dv into one dqkv buffer)
   against the split route's dq, dk and dv at the train shape, bit for bit, and against
   the plain versions; then each kernel's time against its bound and its plain version,
   and the backward of ``scaled_dot_product_attention`` with the same mask (its forward
   and backward less its forward; timed here only, as a yardstick).
5. checkpoint: the committed ``tests/fixtures/tiny_bert`` checkpoint through the port's
   importer and the kernel in f32 reproduces its golden embeddings.
6. relational: ``bench_dataflow.py``'s workloads at its own sizes through the port's
   Scope and Scheduler (groupby_sum: 1M rows by ``i % 1024``, sum and count;
   wordcount: 1M rows over 4,096 string keys; join_inner and join_multikey: 500,000 x
   50,000 rows on one and two int keys; incremental_update: after the 1M-row load, 100
   commits of 1,000 retractions and 1,000 inserts), each once on the host kernels
   (``PATHWAY_TPU_DEVICE_OPS=0``, the spec) and once on the card after a warm-up:
   rows/s each way, the operators' calls and ns, the routes the batches took, the
   segment stage kernels' launches in the timed card run (each of ``SEGMENT_PATH_KERNELS``
   where the workload has a float sum, the int kernel alone for wordcount) and peak
   device memory. The card's output state must be the host's bit for bit (keys equal,
   floats through their int64 views), and every batch must take the device route. A
   profiler window over one 1M-row device groupby commit; ``t_dadd``, the latency of a
   dependent float64 add (a 2^20-add chain in one thread); then ``segment_reduce`` alone
   on float64 sums at [1M rows, 1,024 | 8 | 1M groups], on int64 diffs at [1M, 1,024 |
   4,096] (no partition launched), on groupby_sum's own commit (an int64 count and a
   float64 sum in one call), on one of incremental_update's 2,000-row commits and on a
   Zipf-skewed (s = 1.1) float64 index over 65,536 groups, each against its plain
   version (bit for bit), ``np.add.at`` and ``np.bincount``, ``index_add_`` per column
   (timed only, on CUDA events and on device busy time), its byte bound and its
   chain floor (the longest run times ``t_dadd``), with the whole dispatch (upload,
   kernels, fetch) timed apart; the device matcher at the join_inner shape against the
   host matcher, on the host clock and between CUDA events, against its byte bound.
7. relational_engine: one ``pw.run`` program through the Table API at
   ``device_ops_leg``'s size: 200,000 rows through ``pw.io.python`` into
   ``groupby(k).reduce(k, s=sum(v), c=count())``, ``join_left`` with a 1,024-row table
   from ``pw.debug.table_from_rows``, ``filter``, ``concat_reindex`` with a second
   stream of 50,000 rows joined inner to the same table, ``pw.io.subscribe``; the
   subscriber's state must equal NumPy's answer, the groupby's commits and the inner
   join's batches must take the device route (the left join takes its row path, as in
   the JAX package).
8. main_path: MiniLM-L6 at full width (seeded weights) embeds 20,000 generated docs in
   256-doc commits into a 1,048,576-slot f32 index on the card, 980,000 seeded unit
   vectors are bulk-added so 1,000,000 rows are live, and 64 queries are embedded and
   searched one per commit. Reports docs/s, query p50/p95, peak memory and the kernels'
   launches (the forward's must be 6 per embed call, the backward's 0). Checks that every key's slot holds its
   input vector bit for bit, and recall@10 against exact f32 search in a host index
   built from the same inputs through its own ``add``; then one 256-doc batch through
   the kernel against the plain attention (cosine, beside the readings of two broken
   attentions), and profiler windows over a few more ingest commits and queries:
   device time by kernel and the device's idle share.
9. engine_pipeline: ``bench.py::pipeline_leg``'s program through the port's engine:
   20,000 docs through ``pw.io.python`` (100 ms autocommit), the embedder UDF (lazy
   device rows, 256-doc chunks) and ``DataIndex`` into a 1,048,576-slot index, 64
   as-of-now queries once every doc has reached the doc subscriber, two subscribe
   sinks, with the async device pipeline on (``configure()`` before every ``pw.run``:
   its controller persists across runs in a process). Reports docs/s (beside
   main_path's), query p50/p95, recall@10 against exact f32 search over the streamed
   embeddings, the kernels' launches, the rows the index took by its device and host
   routes, device memory and the pipeline's stats; checks that every doc arrives and
   takes the device route, every query is answered and finds its own doc, no device
   batch outlives the run, the subscriber's rows equal the index's stored vectors bit
   for bit, the pipeline completed commits, has none in flight after the run and left
   no completion thread. engine_async_parity: 2,048 docs fed as 8 commits of 256,
   once with the synchronous commit boundary (``PATHWAY_TPU_ASYNC_DEVICE=0``) and once
   with the async pipeline; the doc subscriber's events and the index's stored rows
   must be the same bits; per mode docs/s, commits, embed chunk sizes, launches, the
   controller's stats, occupancy, the deepest in-flight count and the dispatch-to-
   completion p50/p99; then a GIL check (two commits in flight while the completion
   thread waits on a copy held behind card work, and the scheduler thread keeps
   running). engine_host_cost: a profiled ``pw.run`` of 2,048 docs with the scheduler's
   probe on, beside the device-path loop over the same docs (wall and device-busy ms,
   idle share, per-node batches, insertions, deletions and time, and the engine's own
   host time per 256 docs: in-commit wall less the batch-apply node's time).
10. train: ``make_train_step(minilm_l6())`` at full width (seeded weights) takes 20 AdamW
   steps on one batch of 1,024 (query, positive) pairs of 128 tokens (a doc's first
   3-8 words, and the doc). Reports the per-step ms, pairs/s, peak memory, the loss
   curve (which must fall and stay finite) and each kernel's launches (which must be
   12 a step: 6 layers x 2 embed calls); a profiler window over two more steps gives
   device time by kernel and the device's idle share, and shows that no concatenation
   of dq, dk and dv (autograd of the qkv split) runs. Then one parity step at 128
   pairs from the same initial weights: the loss and each parameter's gradient through
   the kernels against the plain forward and backward through the same
   ``autograd.Function``, and the same reading with a deliberately broken backward
   (delta left out), which must fall below the bar.
11. vision_parity: one 64-image batch of 224-px pixels through ``ImageEmbedder``'s
   CLIP ViT-B/16 tower (seeded, full width) with the kernel (12 launches) and with the
   plain attention, the embeddings within the bf16 bar; ``normalize_u8`` on the card
   against the host's ``preprocess_image`` within 1e-6; the forward's time against
   its FLOP bound. multimodal_pipeline: ``bench.py::multimodal_leg`` through
   ``pw.run`` (512 PNG images of 64x64, 16 noisy queries, top-1 from a 1,024-slot
   index): images/s, the noisy-query top-1, launches (12 per embed call); every
   answer must be the top-1 of an exact f32 host search over the embeddings the
   subscriber received; a second, profiled run gives the device's idle share inside
   commits.
12. rerank: ``bench.py::reranker_leg``, the MiniLM-L6 cross-encoder reranker over 256
   pairs in a 3 s loop: pairs/s, launches per call (6), a profiler window; one batch's
   scores with the kernel against the plain attention; one ``pw.run`` of the same pairs
   as a two-column UDF, whose scores must be the direct call's on the same chunks.
13. decode: ``bench.py::decode_leg``, the Mistral-7B shape with seeded bf16 weights
   (after the earlier phases' index and models are freed): greedy decode of a
   128-token prompt of ones, prefill ms, per-step ms, tokens/s, HBM utilisation
   against the 4.24 ms byte bound of a step, peak memory, a profiler window over decode
   steps; checks: two greedy runs agree, ``top_k=1`` sampling gives the greedy tokens
   (up to a tie of the top logits), sampled rows are independent of the batch.
14. chat_engine: eight prompts through ``PipelineChat("mistral-7b")`` in ``pw.run`` with
   the decode phase's weights; every reply must be the tokenizer's decode of a direct
   ``greedy_generate`` on the same left-padded batch.
15. vector_store: ``bench.py::vector_store_leg`` (BASELINE config #2) through
   ``pw.run``: 3,000 docs with ``_metadata={"path": ...}`` through ``pw.io.python``
   into a ``VectorStoreServer`` over ``EncoderEmbedder("BAAI/bge-base-en-v1.5")`` at
   full width (768 hidden, 12 layers, 12 heads, bf16, seeded, 128-token buckets,
   256-doc chunks) and a 4,096-slot index, then 16 queries of docs' own texts with k =
   10, one at a time. Reports docs/s, query p50/p95 (and each query's ms), peak memory,
   the forward's launches (12 per embed call) and the groupby's device calls; checks
   that every query is answered, each top-1 is its own doc, each answer's hits and
   dists are the exact f32 host search's over the vectors the index received (dist = 1
   - cos within 1e-5; neighbours closer than that may trade places) and every doc takes
   the device route. A profiled run of 768 docs gives the device's idle share in
   commits.
16. rag: ``AdaptiveRAGQuestionAnswerer`` over the same store program with the decode
   phase's chat (the Mistral-7B shape): 4 prompts in one commit, whose expansion loops
   run at once on the async executor's worker threads; every prompt must be answered,
   each reply must equal the chat's direct batch-1 reply to ``prompts.prompt_qa`` of
   the first two retrieved docs (the seeded chat never says "No information found.",
   checked), and no event-loop thread may outlive the run.
17. rag_evals: BASELINE config #5's ``rag_evals`` harness. ``RagEvaluator`` over
   ``BaseRAGQuestionAnswerer(search_topk=2)`` and a ``DocumentStore`` of the same 3,000
   docs (a static table) over the vector store's BGE-base and a 4,096-slot index, on
   256 samples labelled here (a doc's text as the question, its first three words as
   the answer, the doc as the source) with an oracle chat keyed on the question (exact
   match, token F1 and hit rate must be 1.0, none missing), then on the first 16 with
   the decode phase's chat, handed one prompt a call (each answer must be the chat's
   direct batch-1 reply to ``prompt_qa`` of the same retrieved docs, hit rate 1.0, none
   missing); both reports, each run's seconds, the forward's launches (12 per embed
   call).
18. table_ops: one streamed ``pw.run`` of 200,000 seeded rows in 20 commits through the
   expression namespaces (``.str``, ``.dt``, ``.num``), ``deduplicate`` (4,096
   instances), ``sort`` (1,024 instances), ``having`` and a groupby (count and sum) over
   the deduplicated rows on the card's segment reduction, with a 4,096-row stream
   through ``apply_async`` and ``await_futures``; every output equal to a plain Python /
   NumPy computation; rows/s and the segment kernels' launches.
19. The kernels line (the three flash kernels and ``segment_reduce``; the forward's
   ``launches_by_path`` includes ``rag_evals``, the segment reduction's ``table_ops``),
   the ``nvidia-smi`` line, and last ``{"ok": true, ...}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

import pathway_tpu_torch as pw
from pathway_tpu_torch import _build
from pathway_tpu_torch.engine import DeviceKnnIndex, HostKnnIndex
from pathway_tpu_torch.engine import device as hd
from pathway_tpu_torch.engine import device_ops, device_pipeline
from pathway_tpu_torch.engine.batch import Columns
from pathway_tpu_torch.engine.device import TRANSFERS, device_batches_held, lazy_rows
from pathway_tpu_torch.engine.graph import Scheduler, Scope, _match_join_pairs
from pathway_tpu_torch.engine.reducers import ReducerKind, make_reducer
from pathway_tpu_torch.internals.runner import GraphRunner
from pathway_tpu_torch.models import (
    ContrastiveBatch,
    Encoder,
    cross_encode,
    decoder_forward,
    embed,
    greedy_generate,
    info_nce_loss,
    init_cache,
    load_sentence_transformer,
    make_train_step,
    minilm_l6,
    normalize_u8,
    preprocess_image,
    preprocess_image_u8,
    sample_generate,
    vision_forward,
)
from pathway_tpu_torch.ops import flash_attention as fa
from pathway_tpu_torch.ops import segment_reduce as sr
from pathway_tpu_torch.stdlib.indexing import DataIndex, DeviceKnnFactory
from pathway_tpu_torch.xpacks.llm import (
    AdaptiveRAGQuestionAnswerer,
    CrossEncoderReranker,
    DocumentStore,
    EncoderEmbedder,
    ImageEmbedder,
    PipelineChat,
    VectorStoreServer,
    prompt_chat_single_qa,
)
from pathway_tpu_torch.xpacks.llm.llms import EOS_ID
from pathway_tpu_torch.xpacks.llm._tokenizer import HashTokenizer, pad_to_buckets

SEED = 0
N_DOCS = 20_000  # the JAX bench's N_DOCS
N_BULK = 980_000  # seeded unit vectors: 1,000,000 live rows in all
N_QUERIES = 64
CHUNK = 256
SEQ_LEN = 128
K = 10
CAPACITY = 1 << 20
DIM = 384
LAYERS = 6
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "tiny_bert")

# H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

# Parity bars, kernel against its plain version on the same card: the JAX bench's
# own bar for bf16 outputs (values rounded to bf16 differ by an ulp near 1), 1e-4 for
# f32, where only the order of the f32 sums differs. lse is f32 in both dtypes.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-4  # relative to max(1, |lse|)
# min cosine of the main path's embeddings, kernel against plain attention
EMBED_COS_BAR = 0.999
# The backward's outputs grow past 1 (a key's dV sums over every query row), so their
# error is taken relative to max(1, |plain|) elementwise, as lse's, against TOL.
TRAIN_PAIRS = 1024  # the all-MiniLM-L6-v2 recipe's batch
TRAIN_STEPS = 20
PARITY_PAIRS = 128
# min over parameters (``_grad_cosines``) of the cosine between a gradient through the
# kernels and through the plain versions; and the bar on the two losses' difference
GRAD_COS_BAR = 0.99
LOSS_TOL = 1e-2
VIT_ATTN_SHAPE = (64, 197, 12, 64)  # ViT-B/16 at 224 px: 196 patches + CLS, 12 heads of 64
BGE_ATTN_SHAPE = (CHUNK, SEQ_LEN, 12, 64)  # BGE-base: 256 docs in the 128 bucket, 12 heads of 64
TILE = 16  # keys per tile that the kernels skip when all of its keys are masked
# the tile-skipping parity cases, forward and backward, each in bf16 and f32
TILE_CASES = [
    ("late_keys", (64, 128, 12, 32), torch.bfloat16, "late_keys"),
    ("late_keys_f32", (16, 128, 12, 32), torch.float32, "late_keys"),
    ("gappy", (64, 128, 12, 32), torch.bfloat16, "gappy"),
    ("gappy_f32", (16, 128, 12, 64), torch.float32, "gappy"),
    ("late_keys_t200", (32, 200, 12, 32), torch.bfloat16, "late_keys_t200"),
    ("late_keys_t200_f32", (8, 200, 12, 32), torch.float32, "late_keys_t200"),
    ("mixed_dead", (64, 128, 12, 32), torch.bfloat16, "mixed_dead"),
    ("mixed_dead_f32", (16, 128, 12, 32), torch.float32, "mixed_dead"),
]

_WORDS = (
    "stream table index vector engine commit window join reduce shard "
    "tensor batch query embed token device mesh scatter gather fuse"
).split()


def doc_text(i: int) -> str:
    """The JAX bench's generated doc text (bench.py ``_doc_text``)."""
    rng = np.random.default_rng(i)
    n = 8 + int(rng.integers(0, 24))
    return " ".join(_WORDS[j] for j in rng.integers(0, len(_WORDS), n))


class Card:
    def __init__(self) -> None:
        self.name = torch.cuda.get_device_name(0)
        self.count = torch.cuda.device_count()
        self.smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]

    def emit(self, phase: str, **fields) -> None:
        print(json.dumps({"phase": phase, "card": self.smi, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the sequence with no real key in the ``dead_row`` and ``mixed_dead`` patterns
def dead_sequence(masked: str, b: int) -> int | None:
    return {"dead_row": 0, "mixed_dead": b // 2}.get(masked)


def attn_inputs(b, t, h, d, dtype, gen, *, masked: str):
    """q, k, v as views of one fused [b, t, 3*h*d] projection (the encoder's layout)
    and a key bias, as ``attn_qkv`` makes them."""
    qkv, bias = attn_qkv(b, t, h, d, dtype, gen, masked=masked)
    return (*fa.split_heads(qkv, h), bias)


def attn_qkv(b, t, h, d, dtype, gen, *, masked: str):
    """One fused [b, t, 3*h*d] projection (the encoder's layout) and a key bias: ``ragged`` (10-34 real tokens, as the bench's docs), ``random``,
    ``none``, ``ragged`` with sequence 0 fully masked (``dead_row``), and the patterns
    that exercise the kernels' skipping of fully masked 16-key tiles: ``late_keys``
    (real keys only in the last tile), ``gappy`` (live and fully masked tiles in
    turn), ``late_keys_t200`` (real keys only past position 128) and ``mixed_dead``
    (ragged, with the middle sequence fully masked)."""
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda").to(dtype)
    pos = torch.arange(t, device="cuda")[None, :]
    if masked == "none":
        return qkv, None
    if masked == "random":
        mask = torch.rand((b, t), generator=gen, device="cuda") > 0.3
        mask[:, 0] = True
    elif masked == "late_keys":
        mask = (pos >= t - TILE).expand(b, t)
    elif masked == "gappy":
        mask = ((pos // TILE) % 2 == 0).expand(b, t)
    elif masked == "late_keys_t200":
        mask = (pos >= 128).expand(b, t)
    else:
        real = torch.randint(10, 35, (b,), generator=gen, device="cuda")
        mask = pos < real[:, None]
        dead = dead_sequence(masked, b)
        if dead is not None:
            mask[dead] = False
    return qkv, fa.mask_bias(mask)


def _weighted_keys(bias: torch.Tensor | None, b: int, t: int) -> int:
    """Keys that carry weight, summed over sequences: the real keys, or all t for a
    sequence with none (its rows weigh every key)."""
    if bias is None:
        return b * t
    real = (bias > fa.NEG_INF / 2).sum(dim=1)
    return int(torch.where(real > 0, real, t).sum())


def attn_bound_ms(q: torch.Tensor, bias: torch.Tensor | None) -> tuple[float, str]:
    """The least time one call can take on these inputs. Bytes: q read and o written
    for every row, lse written, the bias read, and k and v read only for the keys that
    carry weight: a key with bias -1e30 has exp(s - m) == 0 in f32 for every row that
    has a real key, so its k and v rows change nothing; a fully masked row weighs all t
    keys. Operations: q.k and p.v over those keys for every query row."""
    b, t, h, d = q.shape
    elt = q.element_size()
    keys = _weighted_keys(bias, b, t)
    nbytes = 2 * b * t * h * d * elt + 2 * keys * h * d * elt + b * h * t * 4
    nbytes += 0 if bias is None else b * t * 4
    flops = 4 * t * h * d * keys
    peak = BF16_FLOP_PER_S if elt == 2 else F32_FLOP_PER_S
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def attn_bwd_bound_ms(q: torch.Tensor, bias: torch.Tensor | None, kernel: str) -> tuple[float, str]:
    """The least time one backward kernel can take on these inputs, counted as
    ``attn_bound_ms`` counts the forward's. dQ: q, dO and O (delta's input) read and dQ
    written for every row, lse read and delta written, k and v read for the keys that
    carry weight; 6d operations per (row, weighted key) and 2d per row for delta.
    dK/dV: q, dO, lse and delta read for every row, k and v for the weighted keys, dK
    and dV written for every key and dbias per (batch, head, key); 8d operations per
    (row, weighted key)."""
    b, t, h, d = q.shape
    elt = q.element_size()
    keys = _weighted_keys(bias, b, t)
    rows = b * t * h * d * elt  # one [b, t, h, d] tensor
    stats = b * h * t * 4  # one [b, h, t] f32 tensor
    kv = 2 * keys * h * d * elt
    nbytes = kv + (0 if bias is None else b * t * 4)
    if kernel == "dq":
        nbytes += 4 * rows + 2 * stats
        flops = 6 * t * h * d * keys + 2 * b * t * h * d
    else:
        nbytes += 4 * rows + 3 * stats
        flops = 8 * t * h * d * keys
    peak = BF16_FLOP_PER_S if elt == 2 else F32_FLOP_PER_S
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def phase_build(card: Card) -> None:
    t0 = time.perf_counter()
    results = _build.build()
    for r in results.values():
        lines = [ln.strip() for ln in r.log.splitlines()
                 if "Compiling entry" in ln or "registers" in ln or "spill" in ln or "smem" in ln]
        card.emit("build", kernel=r.name, seconds=r.seconds, ptxas=lines)
        spills = [ln for ln in lines if "spill" in ln]
        check(bool(spills) and all(" 0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills),
              f"{r.name}: ptxas reports spills: {spills}")
    card.emit("build_total", seconds=time.perf_counter() - t0, kernels=sorted(results))


# kernel -> (its library, the marks of its bf16 instances' mangled names)
SASS_KERNELS = {
    "flash_attention_fwd": ("flash_attention_fwd", ("flash_fwd_mma_kernel",)),
    "flash_attention_bwd_dq": ("flash_attention_bwd", ("flash_bwd_dq_mma_kernel",)),
    "flash_attention_bwd_dkv": ("flash_attention_bwd", ("flash_bwd_dkv_mma_kernel",)),
}


def phase_sass(card: Card) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in the built libraries' bf16 instances,
    from ``cuobjdump -sass``: every bf16 instance of every kernel must use them."""
    texts = {lib: _build.sass(lib) for lib in {lib for lib, _ in SASS_KERNELS.values()}}
    totals = {}
    for name, (lib, marks) in SASS_KERNELS.items():
        per_head_dim, instance = {}, None  # "d=32" -> count
        for line in texts[lib].splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                instance = None
                if all(m in found.group(1) for m in marks):
                    instance = "d=" + re.search(r"Li(\d+)E", found.group(1)).group(1)
                    per_head_dim[instance] = 0
            elif instance and re.search(r"\bH(G)?MMA\b", line):
                per_head_dim[instance] += 1
        totals[name] = sum(per_head_dim.values())
        card.emit("sass", kernel=name, library=lib, bf16_instances=per_head_dim,
                  tensor_core_instructions=totals[name])
        check(len(per_head_dim) == len(fa.HEAD_DIMS), f"{name}: bf16 instances {per_head_dim}")
        check(all(n > 0 for n in per_head_dim.values()), f"{name}: no tensor-core instructions {per_head_dim}")
    return totals


def phase_kernel(card: Card) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        ("main", (256, 128, 12, 32), torch.bfloat16, "ragged"),
        ("main_f32", (32, 128, 12, 32), torch.float32, "ragged"),
        ("head_dim_64", (64, 128, 12, 64), torch.bfloat16, "ragged"),
        ("t_200", (8, 200, 12, 32), torch.bfloat16, "random"),
        ("t_200_f32", (8, 200, 12, 32), torch.float32, "random"),
        ("t_512", (4, 512, 12, 64), torch.bfloat16, "random"),
        ("mask_none", (16, 128, 12, 32), torch.bfloat16, "none"),
        ("dead_row_f32", (4, 128, 12, 32), torch.float32, "dead_row"),
        ("dead_row", (4, 200, 12, 32), torch.bfloat16, "dead_row"),
        # the vision path's call: t = 197 (not a multiple of the tile), d = 64, no mask
        ("vit_b16", VIT_ATTN_SHAPE, torch.bfloat16, "none"),
        # one BGE-base embed call of the vector store: 256 docs of 10-34 tokens in the
        # 128 bucket, 12 heads of 64
        ("bge_base", BGE_ATTN_SHAPE, torch.bfloat16, "ragged"),
        *TILE_CASES,
    ]
    main_err = None
    for name, shape, dtype, masked in cases:
        q, k, v, bias = attn_inputs(*shape, dtype, gen, masked=masked)
        o, lse = fa.flash_attention_fwd(q, k, v, bias)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_fwd_reference(q, k, v, bias)
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = ((lse - rlse).abs() / rlse.abs().clamp(min=1.0)).max().item()
        card.emit("kernel_parity", case=name, shape=list(shape), dtype=str(dtype),
                  max_abs_err=err, tol=TOL[dtype], lse_rel_err=lse_err, lse_tol=LSE_TOL)
        check(math.isfinite(err) and err <= TOL[dtype], f"{name}: o error {err}")
        check(math.isfinite(lse_err) and lse_err <= LSE_TOL, f"{name}: lse error {lse_err}")
        dead = dead_sequence(masked, shape[0])
        if dead is not None:
            uniform = v[dead].float().mean(dim=0)  # [h, d]: the uniform average over t keys
            dead_err = (o[dead].float() - uniform[None]).abs().max().item()
            check(dead_err <= TOL[dtype], f"{name}: fully masked row is not the mean of v ({dead_err})")
        if name == "main":
            main_err = err

    # the serving shape (one embed call of 256 docs), the train shape (one embed call
    # of the trainer's 1,024 sequences), the vision shape (one ViT-B/16 forward call
    # of 64 images, no mask) and the vector store's (one BGE-base embed call of 256 docs)
    times = {}
    for path, (b, t, h, d), masked in (("serving", (CHUNK, SEQ_LEN, 12, DIM // 12), "ragged"),
                                       ("train", (TRAIN_PAIRS, SEQ_LEN, 12, DIM // 12), "ragged"),
                                       ("vision", VIT_ATTN_SHAPE, "none"),
                                       ("bge_serving", BGE_ATTN_SHAPE, "ragged")):
        q, k, v, bias = attn_inputs(b, t, h, d, torch.bfloat16, gen, masked=masked)
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, bias), iters=200)
        plain_ms = cuda_ms(lambda: fa.flash_attention_fwd_reference(q, k, v, bias), iters=10, warmup=2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        add_mask = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=add_mask), iters=200)
        bound_ms, bound_by = attn_bound_ms(q, bias)
        # labels only: the bound if every key were real (k and v read in full), and
        # one PyTorch copy of q's strided view into a contiguous o, the bulk of the
        # call's bytes moved with the same access pattern and no arithmetic
        dense_bound_ms, _ = attn_bound_ms(q, None)
        o_like = torch.empty_like(q, memory_format=torch.contiguous_format)
        copy_ms = cuda_ms(lambda: o_like.copy_(q), iters=200)
        card.emit("kernel_time", path=path, shape=[b, t, h, d], dtype="bfloat16", ms=ms,
                  plain_ms=plain_ms, library_ms=library_ms, library="scaled_dot_product_attention",
                  bound_ms=bound_ms, bound_by=bound_by, roofline_share=bound_ms / ms,
                  real_keys_per_seq=_weighted_keys(bias, b, t) / b, dense_bound_ms=dense_bound_ms,
                  q_to_o_copy_ms=copy_ms)
        times[path] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": library_ms}
        del q, k, v, bias, qt, kt, vt, add_mask, o_like
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "pathway_tpu/ops/flash_attention.py:47",
        "max_abs_err": main_err,
        **times["serving"],
        "train_shape": times["train"],
        "vision_shape": times["vision"],
        "bge_serving_shape": times["bge_serving"],
    }


def _rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)).max().item()


def phase_train_kernel(card: Card) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    train_shape = (TRAIN_PAIRS, SEQ_LEN, 12, DIM // 12)
    cases = [
        ("train", train_shape, torch.bfloat16, "ragged"),
        ("train_f32", (64, 128, 12, 32), torch.float32, "ragged"),
        ("head_dim_64", (64, 128, 12, 64), torch.bfloat16, "ragged"),
        ("t_200", (8, 200, 12, 32), torch.bfloat16, "random"),
        ("t_200_f32", (8, 200, 12, 32), torch.float32, "random"),
        ("t_512", (4, 512, 12, 64), torch.bfloat16, "random"),
        ("mask_none", (16, 128, 12, 32), torch.bfloat16, "none"),
        ("dead_row_f32", (4, 128, 12, 32), torch.float32, "dead_row"),
        ("dead_row", (4, 200, 12, 32), torch.bfloat16, "dead_row"),
        *TILE_CASES,
    ]
    names = ("dq", "dk", "dv", "dbias")
    train_err = {}
    for name, shape, dtype, masked in cases:
        q, k, v, bias = attn_inputs(*shape, dtype, gen, masked=masked)
        do = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, bias)
        ours = fa.flash_attention_bwd(q, k, v, bias, do, o, lse)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_reference(q, k, v, bias, do, o, lse)
        rel = {n: _rel_err(a, r) for n, a, r in zip(names, ours, ref)}
        abs_err = {n: (a.float() - r.float()).abs().max().item() for n, a, r in zip(names, ours, ref)}
        zeros = True
        if bias is not None:  # masked keys of sequences with a real key: exact zeros
            masked_keys = (bias < fa.NEG_INF / 2) & (bias > fa.NEG_INF / 2).any(dim=1, keepdim=True)
            zeros = all(bool((x[masked_keys] == 0).all()) for x in ours[1:])
        card.emit("train_kernel_parity", case=name, shape=list(shape), dtype=str(dtype),
                  rel_err=rel, max_abs_err=abs_err, tol=TOL[dtype],
                  max_abs_plain={n: r.float().abs().max().item() for n, r in zip(names, ref)},
                  masked_keys_exact_zero=zeros)
        for n in names:
            check(math.isfinite(rel[n]) and rel[n] <= TOL[dtype], f"{name}: {n} error {rel[n]}")
        check(zeros, f"{name}: masked keys' dk, dv, dbias are not exact zeros")
        if name == "train":
            train_err = abs_err
        del q, k, v, bias, do, o, lse, ours, ref

    phase_fused_vs_split(card, gen, train_shape)
    q, k, v, bias = attn_inputs(*train_shape, torch.bfloat16, gen, masked="ragged")
    do = torch.randn(train_shape, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, bias)
    _dq, delta = fa.flash_attention_bwd_dq(q, k, v, bias, do, o, lse)
    times = {
        "dq": cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, bias, do, o, lse), iters=50),
        "dkv": cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, bias, do, lse, delta), iters=50),
    }
    plain = {
        "dq": cuda_ms(lambda: fa.flash_attention_bwd_dq_reference(q, k, v, bias, do, o, lse),
                      iters=5, warmup=2),
        "dkv": cuda_ms(lambda: fa.flash_attention_bwd_dkv_reference(q, k, v, bias, do, lse, delta),
                       iters=5, warmup=2),
    }
    # the yardstick: SDPA's backward with the same additive mask, as its forward and
    # backward less its forward (it computes dq, dk and dv, not dbias)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    add_mask = bias[:, None, None, :].to(torch.bfloat16)
    sdpa_fwd_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=add_mask), iters=50)
    sdpa_fwd_bwd_ms = cuda_ms(
        lambda: torch.autograd.grad(sdpa(qt, kt, vt, attn_mask=add_mask), (qt, kt, vt), dot), iters=50
    )
    library_ms = sdpa_fwd_bwd_ms - sdpa_fwd_ms
    rows = []
    for kern, name, replaces in (
        ("dq", "flash_attention_bwd_dq", "pathway_tpu/ops/flash_attention.py:125"),
        ("dkv", "flash_attention_bwd_dkv", "pathway_tpu/ops/flash_attention.py:166"),
    ):
        bound_ms, bound_by = attn_bwd_bound_ms(q, bias, kern)
        card.emit("train_kernel_time", kernel=name, shape=list(train_shape), dtype="bfloat16",
                  ms=times[kern], plain_ms=plain[kern], bound_ms=bound_ms, bound_by=bound_by,
                  roofline_share=bound_ms / times[kern], library_ms=library_ms,
                  library="scaled_dot_product_attention backward (fwd+bwd less fwd), dq+dk+dv",
                  sdpa_fwd_ms=sdpa_fwd_ms, sdpa_fwd_bwd_ms=sdpa_fwd_bwd_ms,
                  real_keys_per_seq=float((bias == 0).sum()) / train_shape[0])
        errs = [train_err["dq"]] if kern == "dq" else [train_err[n] for n in ("dk", "dv", "dbias")]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "pathway_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": replaces,
            "max_abs_err": max(errs),
            "ms": times[kern],
            "plain_ms": plain[kern],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        })
    return rows


def phase_fused_vs_split(card: Card, gen: torch.Generator, shape) -> None:
    """The fused route at the train shape: ``flash_attention_qkv``'s gradient (the
    kernels writing into the three thirds of one dqkv buffer) against the split route's
    dq, dk and dv from the same kernels on the same inputs, concatenated, which must
    agree bit for bit (the kernels use no atomics; only the output addresses differ);
    and each third against the plain versions, within the bars."""
    b, t, h, d = shape
    qkv, bias = attn_qkv(b, t, h, d, torch.bfloat16, gen, masked="ragged")
    do = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    x = qkv.detach().requires_grad_()
    o = fa.flash_attention_qkv(x, bias == 0, h)
    (dqkv,) = torch.autograd.grad(o, x, do)
    q, k, v = fa.split_heads(qkv, h)
    o_split, lse = fa.flash_attention_fwd(q, k, v, bias)
    dq, dk, dv, _ = fa.flash_attention_bwd(q, k, v, bias, do, o_split, lse)
    split = torch.cat([g.reshape(b, t, h * d) for g in (dq, dk, dv)], dim=-1)
    torch.cuda.synchronize()
    identical = torch.equal(o, o_split) and torch.equal(dqkv, split)
    ref = fa.flash_attention_bwd_reference(q, k, v, bias, do, o_split, lse)
    rel = {n: _rel_err(g, r) for n, g, r in zip(("dq", "dk", "dv"), fa.split_heads(dqkv, h), ref)}
    card.emit("fused_vs_split", shape=list(shape), dtype="bfloat16", bit_identical=identical,
              rel_err_vs_plain=rel, tol=TOL[torch.bfloat16],
              dqkv_strides=list(dqkv.stride()), dqkv_contiguous=dqkv.is_contiguous())
    check(identical, "the fused route's dqkv differs from the split route's dq, dk, dv")
    for n, err in rel.items():
        check(math.isfinite(err) and err <= TOL[torch.bfloat16], f"fused route: {n} error {err}")


def phase_checkpoint(card: Card) -> None:
    data = np.load(os.path.join(FIXTURE, "golden_embeddings.npz"))
    texts = [str(x) for x in data["texts"]]
    expected = np.asarray(data["embeddings"], np.float32)
    state, cfg, tok = load_sentence_transformer(FIXTURE)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    enc = Encoder(cfg, device="cuda", seed=None)
    enc.load_state_dict(state)
    ids, mask = tok.encode_batch(texts, 32)
    ours = embed(enc, torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()).cpu().numpy()
    err = float(np.abs(ours - expected).max())
    card.emit("checkpoint", fixture="tests/fixtures/tiny_bert", head_dim=cfg.head_dim,
              max_abs_err=err, tol=1e-4)
    check(err <= 1e-4, f"tiny_bert goldens: {err}")


def phase_main_path(card: Card) -> int:
    corpus = [doc_text(i) for i in range(N_DOCS)]
    embedder = EncoderEmbedder("all-MiniLM-L6-v2", max_len=SEQ_LEN, max_batch_size=CHUNK,
                               seq_bucket_min=SEQ_LEN, seed=SEED)
    check(embedder.get_embedding_dimension() == DIM, "MiniLM-L6 width")
    index = DeviceKnnIndex(dim=DIM, capacity=CAPACITY)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for kern in (fa.KERNEL, fa.BWD_DQ_KERNEL, fa.BWD_DKV_KERNEL):
        kern.launches = 0
    embed_calls = 0
    doc_vecs = []  # the embedder's outputs, kept on the card for the checks below
    t0 = time.perf_counter()
    for start in range(0, N_DOCS, CHUNK):
        texts = corpus[start:start + CHUNK]
        vecs = embedder.embed_batch(texts)
        embed_calls += 1
        index.add(range(start, start + len(texts)), vecs)
        doc_vecs.append(vecs)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bulk = torch.randn((N_BULK, DIM), generator=gen, device="cuda")
    bulk /= torch.linalg.vector_norm(bulk, dim=1, keepdim=True)
    t0 = time.perf_counter()
    index.add(range(N_DOCS, N_DOCS + N_BULK), bulk)
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0
    check(len(index) == N_DOCS + N_BULK, "live rows")

    latencies, answers, qvecs, qdocs = [], [], [], []
    for i in range(N_QUERIES):
        doc = i * 37 % N_DOCS  # queries reuse doc texts, as the JAX bench does
        t0 = time.perf_counter()
        q = embedder.embed_batch([doc_text(doc)])
        embed_calls += 1
        hits = index.search(q, k=K)[0]
        latencies.append(time.perf_counter() - t0)
        answers.append([key for key, _ in hits])
        qvecs.append(q[0].cpu().numpy())
        qdocs.append(doc)
    launches = fa.KERNEL.launches
    backward_launches = fa.BWD_DQ_KERNEL.launches + fa.BWD_DKV_KERNEL.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # the index's state against its inputs: every key's slot holds its vector bit for
    # bit, with its squared norm, and exactly the 1M slots are live
    inputs = torch.cat([torch.cat(doc_vecs).float(), bulk])
    del doc_vecs, bulk
    slot_of = torch.tensor([index.key_to_slot[key] for key in range(N_DOCS + N_BULK)], device="cuda")
    check(torch.equal(index.state.vectors.index_select(0, slot_of), inputs), "stored vectors")
    check(torch.allclose(index.state.norms[slot_of], (inputs * inputs).sum(dim=1), rtol=1e-5),
          "stored squared norms")
    check(bool(index.state.valid[slot_of].all()) and int(index.state.valid.sum()) == N_DOCS + N_BULK,
          "live slots")
    # exact f32 search on the host over an index built from the same inputs through
    # its own add, not from the device index's buffers
    inputs = inputs.cpu().numpy()
    host = HostKnnIndex(dim=DIM, capacity=CAPACITY)
    host.add(range(N_DOCS + N_BULK), inputs)
    del inputs, slot_of
    exact = host.search(qvecs, k=K)
    recalls = [len(set(a) & {key for key, _ in e}) / len(e) for a, e in zip(answers, exact)]
    recall = float(np.mean(recalls))
    self_hit = all(doc in a for doc, a in zip(qdocs, answers))

    lat_ms = sorted(1e3 * x for x in latencies)
    card.emit("main_path", model="all-MiniLM-L6-v2 (hidden 384, 6 layers, 12 heads, seeded)",
              n_docs=N_DOCS, live_rows=len(index), capacity=index.capacity,
              index_gb=index.state.vectors.numel() * 4 / 1e9,
              docs_per_s=N_DOCS / ingest_s, ingest_s=ingest_s, bulk_add_s=bulk_s,
              query_p50_ms=lat_ms[len(lat_ms) // 2], query_p95_ms=lat_ms[int(0.95 * len(lat_ms))],
              peak_device_gib=peak_gib, embed_calls=embed_calls, flash_launches=launches,
              backward_launches=backward_launches,
              recall_at_10=recall, self_hit=self_hit)
    check(launches > 0 and launches == LAYERS * embed_calls,
          f"flash launches {launches} != {LAYERS} x {embed_calls} embed calls")
    check(backward_launches == 0, f"serving launched {backward_launches} backward kernels")
    check(recall >= 0.99, f"recall@10 {recall}")
    check(self_hit, "every query finds its own doc")

    phase_embed_parity(card, embedder, corpus)
    phase_profile(card, embedder, index, corpus)
    return {"launches": launches, "docs_per_s": N_DOCS / ingest_s}


def plain_attention(q, k, v, mask):
    """The forward kernel's plain PyTorch version as an attention function: the
    kernel's arithmetic with no kernel, on the same card."""
    return fa.flash_attention_fwd_reference(q, k, v, None if mask is None else fa.mask_bias(mask))[0]


def phase_embed_parity(card: Card, embedder: EncoderEmbedder, corpus) -> None:
    """One 256-doc batch through the kernel against the same encoder on the plain
    attention, on the card (min cosine over the batch). To show what the bar can see,
    the same reading with two deliberately broken attentions: the mask ignored, and
    uniform weights over the real keys (q.k ignored). With seeded N(0, 0.02) weights
    the attention's scores are small, so the second fault passes the bar: this check
    guards the mask and the sum over v (an ignored mask must fall below the bar, or
    the script fails), and the kernel-level parity guards the scores."""
    def mask_ignored(q, k, v, mask):
        return fa.flash_attention_fwd_reference(q, k, v, None)[0]

    def uniform(q, k, v, mask):
        return plain_attention(torch.zeros_like(q), k, v, mask)

    ids, mask, real = embedder.tokenize(corpus[:CHUNK])
    ref = embed(embedder.encoder, ids, mask, attn_fn=plain_attention)[:real]

    def min_cos(attn_fn=None) -> float:
        out = embed(embedder.encoder, ids, mask, attn_fn=attn_fn)[:real]
        check(bool(torch.isfinite(out).all()) and out.shape == (CHUNK, DIM), "embedding shape and finiteness")
        return float((out * ref).sum(dim=1).min())

    cos_min = min_cos()
    broken = {"mask_ignored": min_cos(mask_ignored), "uniform_weights": min_cos(uniform)}
    card.emit("embed_parity", batch=CHUNK, min_cosine=cos_min, bar=EMBED_COS_BAR,
              broken_min_cosine=broken)
    check(cos_min >= EMBED_COS_BAR, f"kernel vs plain attention embeddings: cosine {cos_min}")
    check(broken["mask_ignored"] < EMBED_COS_BAR, f"the bar cannot see an ignored mask: {broken}")


def _profiled(fn) -> tuple[float, list[tuple[float, str, int]], dict[str, int]]:
    """Run ``fn`` under the profiler -> (wall ms, [(device ms, kernel, count)], {host
    op or autograd node: count}), counting only device-side events as kernels, so no
    kernel is counted twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [
        (evt.self_device_time_total / 1e3, evt.key, evt.count)
        for evt in prof.key_averages()
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0
    ]
    ops = {evt.key: evt.count for evt in prof.key_averages() if evt.device_type == DeviceType.CPU}
    return wall_ms, sorted(kernels, reverse=True), ops


def phase_profile(card: Card, embedder: EncoderEmbedder, index: DeviceKnnIndex, corpus) -> None:
    """Where the time goes: profiler windows over a few more ingest commits and
    queries on the same 1M-row index, with device time by kernel and the device's
    idle share of each window."""
    commits, queries = 8, 8
    base = 2 * CAPACITY  # keys past every key of the main path

    def ingest() -> None:
        for c in range(commits):
            keys = range(base + c * CHUNK, base + (c + 1) * CHUNK)
            index.add(keys, embedder.embed_batch(corpus[c * CHUNK:(c + 1) * CHUNK]))

    def query() -> None:
        for i in range(queries):
            index.search(embedder.embed_batch([corpus[i]]), k=K)

    for name, fn, n in (("ingest", ingest, commits), ("query", query, queries)):
        wall_ms, kernels, _ops = _profiled(fn)
        busy_ms = sum(k[0] for k in kernels)
        card.emit(
            "profile",
            window=f"{n} {name} commits on the 1M-row index",
            wall_ms_per_commit=wall_ms / n,
            device_busy_ms_per_commit=busy_ms / n if kernels else "not measured",
            device_idle_share=(1.0 - busy_ms / wall_ms) if kernels else "not measured",
            top=[{"kernel": k[:80], "device_ms_per_commit": ms / n, "launches": c}
                 for ms, k, c in kernels[:12]],
        )


class _KeptKnnFactory(DeviceKnnFactory):
    """The pipeline's index factory, keeping the index it builds so the script can read
    its routes' row counts and its stored vectors after the run."""

    def build(self) -> DeviceKnnIndex:
        self.built = super().build()
        return self.built


def _engine_program(embedder: EncoderEmbedder, corpus, n_docs: int, n_queries: int,
                    factory: DeviceKnnFactory, wait_s: float, pace: int | None = None):
    """``bench.py::pipeline_leg``'s program against the port: the python connector ->
    the embedder UDF -> DataIndex -> as-of-now query -> two subscribe sinks. Queries
    start once every doc has reached the doc subscriber. With ``pace`` the feed pushes
    the docs in batches of ``pace``, each once the one before has reached the doc
    subscriber, so each batch is a commit of its own. Returns the observations (filled
    in while ``pw.run`` runs) and the function that runs it."""
    obs = {"docs": {}, "doc_times": set(), "answers": {}, "latencies": [], "timeouts": [],
           "failures": [], "run_start": 0.0, "first_doc_seen": 0.0, "ingest_end": 0.0}
    ingest_done, answer_seen, batch_seen = threading.Event(), threading.Event(), threading.Event()

    class DocFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            obs["run_start"] = time.perf_counter()
            step = pace or n_docs
            for start in range(0, n_docs, step):
                batch_seen.clear()
                for i in range(start, min(n_docs, start + step)):
                    self.next(doc_id=i, text=corpus[i])
                if pace and not batch_seen.wait(timeout=wait_s):
                    obs["failures"].append(f"docs {start}.. never reached the subscriber")
                    return

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            if not ingest_done.wait(timeout=wait_s):
                obs["failures"].append(f"{len(obs['docs'])} of {n_docs} docs arrived")
                return
            for i in range(n_queries):
                answer_seen.clear()
                t0 = time.perf_counter()
                self.next(query_id=i, text=doc_text(i * 37 % N_DOCS))
                if answer_seen.wait(timeout=wait_s):
                    obs["latencies"].append(time.perf_counter() - t0)
                else:
                    obs["timeouts"].append(i)

    docs = pw.io.python.read(DocFeed(), schema=pw.schema_from_types(doc_id=int, text=str),
                             autocommit_duration_ms=100)
    docs = docs.select(doc_id=pw.this.doc_id, emb=embedder(pw.this.text))
    queries = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(query_id=int, text=str),
                                autocommit_duration_ms=None)
    queries = queries.select(query_id=pw.this.query_id, qemb=embedder(pw.this.text))
    res = DataIndex(docs, factory, docs.emb).query_as_of_now(queries, queries.qemb,
                                                             number_of_matches=K)

    def on_doc(key, row, time, is_addition):
        if is_addition:
            if not obs["docs"]:
                obs["first_doc_seen"] = perf_counter()
            obs["docs"][key] = (row["doc_id"], np.asarray(row["emb"], np.float32))
            obs["doc_times"].add(time)
            if pace and len(obs["docs"]) % pace == 0:
                batch_seen.set()
            if len(obs["docs"]) == n_docs:
                obs["ingest_end"] = perf_counter()
                ingest_done.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            obs["answers"][row["query_id"]] = (tuple(row["_pw_index_reply_ids"]),
                                               np.asarray(row["qemb"], np.float32))
            answer_seen.set()

    perf_counter = time.perf_counter  # the callbacks' ``time`` argument shadows the module
    pw.io.subscribe(docs, on_change=on_doc)
    pw.io.subscribe(res, on_change=on_answer)
    return obs, pw.run


def _count_embed_calls(embedder: EncoderEmbedder) -> tuple[list[int], list[int]]:
    """Count the embed calls the UDF makes (one per chunk of at most CHUNK texts; the
    device pipeline's controller may narrow the chunks) -> ([calls], the texts handed
    over per call)."""
    calls, sizes = [0], []
    embed_batch = embedder.embed_batch

    def counted(texts):
        calls[0] += math.ceil(len(texts) / CHUNK)
        sizes.append(len(texts))
        return embed_batch(texts)

    embedder.embed_batch = counted
    return calls, sizes


def _pipeline_threads() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.is_alive() and t.name == "pw-device-pipeline"]


def _track_inflight() -> list[int]:
    """Record the device pipeline's in-flight commits just after each staging (its
    deepest point) -> the list it fills; ``_untrack_inflight`` restores the pipe."""
    seen = []
    boundary = device_pipeline.PIPELINE.commit_boundary

    def tracked(time_: int) -> None:
        boundary(time_)
        seen.append(device_pipeline.PIPELINE.inflight())

    device_pipeline.PIPELINE.commit_boundary = tracked
    return seen


def _untrack_inflight() -> None:
    device_pipeline.PIPELINE.__dict__.pop("commit_boundary", None)


def _pipe_mark() -> tuple[float, list[int]]:
    """The pipeline's commit counter and latency histogram, which count for the whole
    process, read before a run so that ``_pipe_since`` can give the run's own."""
    pipe = device_pipeline.PIPELINE
    return pipe._c_commits.value, list(pipe._h_latency.counts)


def _pipe_since(mark: tuple[float, list[int]]) -> dict:
    from pathway_tpu_torch.internals.metrics import Histogram

    pipe = device_pipeline.PIPELINE
    hist = Histogram(device_pipeline.DISPATCH_BUCKETS)
    hist.counts = [a - b for a, b in zip(pipe._h_latency.counts, mark[1])]
    hist.count = sum(hist.counts)
    return {"completed_commits_in_run": int(pipe._c_commits.value - mark[0]),
            "dispatch_complete_p50_ms_in_run": 1e3 * hist.quantile(0.5),
            "dispatch_complete_p99_ms_in_run": 1e3 * hist.quantile(0.99)}


def phase_engine_pipeline(card: Card, main_path_docs_per_s: float) -> int:
    """The streaming-RAG pipeline through the port's own engine, as ``bench.py::
    pipeline_leg`` drives the JAX package: 20,000 docs through the python connector
    (100 ms autocommit), the embedder UDF (256-doc chunks, lazy device rows) and
    DataIndex into a 1,048,576-slot index on the card; 64 queries, one commit each,
    once every doc has reached the doc subscriber. Then the engine's host cost: a
    profiled pw.run of 2,048 docs beside the device-path loop over the same docs."""
    corpus = [doc_text(i) for i in range(N_DOCS)]
    embedder = EncoderEmbedder("all-MiniLM-L6-v2", max_len=SEQ_LEN, max_batch_size=CHUNK,
                               seq_bucket_min=SEQ_LEN, seed=SEED)
    embed_calls, _sizes = _count_embed_calls(embedder)
    factory = _KeptKnnFactory(dimensions=DIM, capacity=CAPACITY)
    obs, run = _engine_program(embedder, corpus, N_DOCS, N_QUERIES, factory, wait_s=300.0)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_bytes = torch.cuda.memory_allocated()
    d2h_before = TRANSFERS["d2h_copies"]
    # the controller persists across runs in a process: start each run from its knobs
    device_pipeline.PIPELINE.configure()
    check(device_pipeline.async_enabled(), "the device pipeline must run async here")
    mark = _pipe_mark()
    for kern in (fa.KERNEL, fa.BWD_DQ_KERNEL, fa.BWD_DKV_KERNEL):
        kern.launches = 0
    t0 = time.perf_counter()
    run()
    run_s = time.perf_counter() - t0
    launches = fa.KERNEL.launches
    pipe = {**device_pipeline.PIPELINE.stats(), **_pipe_since(mark)}
    threads_after = _pipeline_threads()
    backward_launches = fa.BWD_DQ_KERNEL.launches + fa.BWD_DKV_KERNEL.launches
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    index = factory.built
    held = device_batches_held()
    index_bytes = sum(x.numel() * x.element_size() for x in index.state)
    weight_bytes = sum(p.numel() * p.element_size() for p in embedder.encoder.parameters())
    after_bytes = torch.cuda.memory_allocated()

    # recall@10 of the streamed index against exact search over the same vectors,
    # computed as pipeline_leg computes it
    docs, answers = obs["docs"], obs["answers"]
    keys = list(docs)
    mat = np.stack([docs[k][1] for k in keys])
    norms = np.linalg.norm(mat, axis=1)
    recalls, self_hit = [], True
    key_of = {doc_id: key for key, (doc_id, _emb) in docs.items()}
    for qid, (hit_keys, qvec) in answers.items():
        scores = mat @ qvec / np.maximum(norms * np.linalg.norm(qvec), 1e-30)
        exact = {keys[j] for j in np.argsort(-scores)[:K]}
        recalls.append(len(exact & set(hit_keys)) / len(exact))
        self_hit &= key_of.get(qid * 37 % N_DOCS) in hit_keys
    recall = float(np.mean(recalls)) if recalls else float("nan")
    # a sample of the subscriber's rows (host twins) against the index's stored rows
    rng = np.random.default_rng(SEED)
    sample = [keys[i] for i in rng.choice(len(keys), 256, replace=False)]
    slots = torch.tensor([index.key_to_slot[k] for k in sample], device="cuda")
    stored = index.state.vectors.index_select(0, slots).cpu().numpy()
    bit_equal = bool(np.array_equal(stored, np.stack([docs[k][1] for k in sample])))

    lat_ms = sorted(1e3 * x for x in obs["latencies"])
    ingest_s = obs["ingest_end"] - obs["run_start"]
    docs_per_s = N_DOCS / ingest_s if ingest_s > 0 else float("nan")
    card.emit(
        "engine_pipeline",
        model="all-MiniLM-L6-v2 (hidden 384, 6 layers, 12 heads, seeded)",
        n_docs=len(docs), n_queries=len(lat_ms), query_timeouts=len(obs["timeouts"]),
        capacity=index.capacity, docs_per_s=docs_per_s, ingest_s=ingest_s,
        first_doc_seen_s=obs["first_doc_seen"] - obs["run_start"] if docs else None,
        doc_commits=len(obs["doc_times"]), run_s=run_s,
        docs_per_s_over_main_path=docs_per_s / main_path_docs_per_s,
        main_path_docs_per_s=main_path_docs_per_s,
        query_p50_ms=lat_ms[len(lat_ms) // 2] if lat_ms else None,
        query_p95_ms=lat_ms[int(0.95 * len(lat_ms))] if lat_ms else None,
        recall_at_10=recall, self_hit=self_hit, embed_calls=embed_calls[0],
        flash_launches=launches, backward_launches=backward_launches,
        index_rows_device_route=index.rows_device, index_rows_host_route=index.rows_host,
        live_device_batches_after_run=held, peak_device_gib=peak_gib,
        device_gib_after_run=after_bytes / 2**30, device_gib_before_run=before_bytes / 2**30,
        index_gib=index_bytes / 2**30, weights_gib=weight_bytes / 2**30,
        after_run_beyond_index_and_weights_mib=(after_bytes - index_bytes - weight_bytes) / 2**20,
        host_twin_copies=TRANSFERS["d2h_copies"] - d2h_before,
        subscriber_rows_bit_equal_to_index=bit_equal,
        device_pipeline=pipe, pipeline_threads_after_run=threads_after,
        failures=obs["failures"],
    )
    check(not obs["failures"], f"engine pipeline: {obs['failures']}")
    check(len(docs) == N_DOCS, f"{len(docs)} of {N_DOCS} docs arrived")
    check(len(lat_ms) == N_QUERIES and not obs["timeouts"],
          f"{len(lat_ms)} answers, timeouts {obs['timeouts']}")
    check(recall >= 0.99, f"engine recall@10 {recall}")
    check(self_hit, "engine: every query finds its own doc")
    check(launches > 0 and launches == LAYERS * embed_calls[0],
          f"engine: flash launches {launches} != {LAYERS} x {embed_calls[0]} embed calls")
    check(backward_launches == 0, f"engine launched {backward_launches} backward kernels")
    check(index.rows_device == N_DOCS and index.rows_host == 0,
          f"index routes: {index.rows_device} device, {index.rows_host} host")
    check(held == 0, f"{held} device batches still hold a tensor after pw.run")
    check(bit_equal, "the subscriber's rows differ from the index's stored vectors")
    check(pipe["completed_commits_in_run"] > 0, f"device pipeline: {pipe}")
    check(pipe["inflight"] == 0, f"{pipe['inflight']} commits in flight after pw.run")
    check(not threads_after, f"completion threads alive after pw.run: {threads_after}")
    del factory, index, obs, docs, answers, mat
    parity = phase_engine_async_parity(card, embedder, corpus)
    phase_engine_host_cost(card, embedder, corpus)
    return launches, parity


def _gil_check() -> dict:
    """The completion thread's wait on a copy event releases the GIL: a commit whose
    copy sits behind ~0.2 s of card work is staged, then a second one, so two commits
    are in flight while the first one's wait runs; meanwhile the scheduler thread
    counts loop turns, against the same count just before."""

    def turns(seconds: float) -> int:
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            n += 1
        return n

    device_pipeline.PIPELINE.configure()
    base = torch.randn((CHUNK, DIM), device="cuda")
    torch.cuda.synchronize()
    baseline = turns(0.05)
    torch.cuda._sleep(400_000_000)  # ~0.2 s of card time ahead of the first copy
    first = lazy_rows(base * 2.0, CHUNK)
    device_pipeline.commit_boundary(0)
    second = lazy_rows(base * 3.0, CHUNK)
    device_pipeline.commit_boundary(1)
    depth = device_pipeline.PIPELINE.inflight()
    during = turns(0.05)
    still_waiting = first[0].batch.dev is not None
    device_pipeline.drain()
    ok_bits = (np.array_equal(first[0].batch.host(), (base * 2.0).cpu().numpy())
               and np.array_equal(second[0].batch.host(), (base * 3.0).cpu().numpy()))
    out = {"inflight_after_second_staging": depth, "first_commit_still_waiting": still_waiting,
           "scheduler_turns_during_wait_over_before": during / baseline,
           "host_twins_bit_equal": ok_bits}
    device_pipeline.PIPELINE.configure()
    return out


def phase_engine_async_parity(card: Card, embedder: EncoderEmbedder, corpus) -> int:
    """The same program on 2,048 docs fed as 8 commits of 256 (the feed waits for each
    batch at the doc subscriber before it pushes the next), run twice in this call:
    with the synchronous commit boundary (``PATHWAY_TPU_ASYNC_DEVICE=0``) and with the
    async pipeline, ``configure()`` before each. The doc subscriber's events (keys,
    doc ids, embeddings) and the index's stored row of every key must be the same bits
    in both modes. Then the GIL check of the completion thread's wait."""
    n = 8 * CHUNK
    modes, runs = {}, {}
    prior = os.environ.get("PATHWAY_TPU_ASYNC_DEVICE")
    try:
        for mode in ("0", "1"):
            os.environ["PATHWAY_TPU_ASYNC_DEVICE"] = mode
            embed_calls, sizes = _count_embed_calls(embedder)
            factory = _KeptKnnFactory(dimensions=DIM, capacity=CAPACITY)
            obs, run = _engine_program(embedder, corpus, n, 0, factory, wait_s=120.0,
                                       pace=CHUNK)
            device_pipeline.PIPELINE.configure()
            mark = _pipe_mark()
            inflight = _track_inflight()
            for kern in (fa.KERNEL, fa.BWD_DQ_KERNEL, fa.BWD_DKV_KERNEL):
                kern.launches = 0
            try:
                run()
            finally:
                _untrack_inflight()
                del embedder.embed_batch  # back to the class's method
            launches = fa.KERNEL.launches
            backward_launches = fa.BWD_DQ_KERNEL.launches + fa.BWD_DKV_KERNEL.launches
            pipe = {**device_pipeline.PIPELINE.stats(), **_pipe_since(mark)}
            check(not obs["failures"] and len(obs["docs"]) == n,
                  f"parity run (async={mode}): {len(obs['docs'])} docs, {obs['failures']}")
            index = factory.built
            keys = sorted(obs["docs"], key=int)
            slots = torch.tensor([index.key_to_slot[k] for k in keys], device="cuda")
            runs[mode] = {
                "keys": [int(k) for k in keys],
                "doc_ids": [obs["docs"][k][0] for k in keys],
                "emb": np.stack([obs["docs"][k][1] for k in keys]),
                "stored": index.state.vectors.index_select(0, slots).cpu().numpy(),
            }
            ingest_s = obs["ingest_end"] - obs["run_start"]
            modes["async" if mode == "1" else "sync"] = {
                "docs_per_s": n / ingest_s, "ingest_s": ingest_s,
                "doc_commits": len(obs["doc_times"]),
                "embed_chunk_sizes": sizes, "embed_calls": embed_calls[0],
                "flash_launches": launches, "backward_launches": backward_launches,
                "index_rows_device_route": index.rows_device,
                "index_rows_host_route": index.rows_host,
                "max_inflight_after_staging": max(inflight, default=0),
                "live_device_batches_after_run": device_batches_held(),
                "device_pipeline": pipe,
                "subscriber_rows_bit_equal_to_index": bool(
                    np.array_equal(runs[mode]["emb"], runs[mode]["stored"])),
            }
            check(launches == LAYERS * embed_calls[0] and backward_launches == 0,
                  f"parity: flash launches {launches} != {LAYERS} x {embed_calls[0]}, "
                  f"or {backward_launches} backward launches")
            del factory, index, obs
    finally:
        if prior is None:
            os.environ.pop("PATHWAY_TPU_ASYNC_DEVICE", None)
        else:
            os.environ["PATHWAY_TPU_ASYNC_DEVICE"] = prior
    sync, asy = runs["0"], runs["1"]
    same = {
        "keys": sync["keys"] == asy["keys"],
        "doc_ids": sync["doc_ids"] == asy["doc_ids"],
        "embeddings": bool(np.array_equal(sync["emb"], asy["emb"])),
        "index_rows": bool(np.array_equal(sync["stored"], asy["stored"])),
    }
    gil = _gil_check()
    card.emit("engine_async_parity",
              window=f"{n} docs in {n // CHUNK} paced batches of {CHUNK}, pw.run with the "
                     "sync boundary and with the async pipeline",
              modes=modes, bit_identical=same, gil_check=gil)
    check(all(same.values()), f"async against sync: {same}")
    for name, m in modes.items():
        check(m["doc_commits"] >= n // CHUNK, f"{name}: {m['doc_commits']} doc commits")
        check(m["index_rows_device_route"] == n and m["index_rows_host_route"] == 0,
              f"{name}: index routes {m['index_rows_device_route']} / {m['index_rows_host_route']}")
        check(m["live_device_batches_after_run"] == 0, f"{name}: batches held after the run")
        check(m["subscriber_rows_bit_equal_to_index"], f"{name}: subscriber rows != index rows")
        check(m["device_pipeline"]["inflight"] == 0, f"{name}: commits in flight after pw.run")
    check(modes["sync"]["device_pipeline"]["completed_commits_in_run"] == 0,
          "the sync boundary must not go through the completion thread")
    check(modes["async"]["device_pipeline"]["completed_commits_in_run"] >= n // CHUNK,
          f"async: {modes['async']['device_pipeline']}")
    check(gil["inflight_after_second_staging"] == 2 and gil["first_commit_still_waiting"],
          f"GIL check: two commits must be in flight during the wait: {gil}")
    check(gil["scheduler_turns_during_wait_over_before"] > 0.5,
          f"GIL check: the scheduler thread stalled during the completion wait: {gil}")
    check(gil["host_twins_bit_equal"], "GIL check: host twins differ from the device rows")
    device_pipeline.stop_worker()
    return modes["async"]["flash_launches"]


def _profiled_commits(run) -> tuple[float, list, list[float], Scheduler]:
    """``_profiled(run)`` for a ``pw.run``, timing each commit of its scheduler -> (wall
    ms, device kernels as ``_profiled`` gives them, seconds inside each commit, the
    scheduler)."""
    inside, schedulers = [], []
    commit = Scheduler.commit

    def timed_commit(self):
        if not schedulers:
            schedulers.append(self)
        t0 = time.perf_counter()
        try:
            return commit(self)
        finally:
            inside.append(time.perf_counter() - t0)

    Scheduler.commit = timed_commit
    try:
        wall_ms, kernels, _ops = _profiled(run)
    finally:
        Scheduler.commit = commit
    return wall_ms, kernels, inside, schedulers[0]


def phase_engine_host_cost(card: Card, embedder: EncoderEmbedder, corpus) -> None:
    """The engine's host cost: a pw.run of 2,048 docs (no queries) under the profiler,
    and the device-path loop (embed_batch + index.add per 256 docs) over the same docs,
    in the same call. Wall and device-busy ms per commit, per 256 docs, and the
    device's idle share: over the whole run and over the time spent inside commits
    (the run's wall also holds the 100 ms autocommit window and the pump's idle
    polls)."""
    n = 8 * CHUNK
    factory = DeviceKnnFactory(dimensions=DIM, capacity=CAPACITY)
    obs, run = _engine_program(embedder, corpus, n, 0, factory, wait_s=120.0)
    device_pipeline.PIPELINE.configure()
    mark = _pipe_mark()
    prior = os.environ.get("PATHWAY_PROCESS_METRICS")
    os.environ["PATHWAY_PROCESS_METRICS"] = "1"  # pw.run turns the scheduler's probe on
    try:
        wall_ms, kernels, inside, sched = _profiled_commits(run)
    finally:
        if prior is None:
            os.environ.pop("PATHWAY_PROCESS_METRICS", None)
        else:
            os.environ["PATHWAY_PROCESS_METRICS"] = prior
    check(len(obs["docs"]) == n and not obs["failures"], f"profiled engine run: {obs['failures']}")
    check(sched.probe and sched.stats, "the probe kept no per-node stats")
    nodes = []
    for node in sched.scope.nodes:
        st = sched.stats.get(node.index)
        if st is not None:
            nodes.append({"node": node.index, "type": type(node).__name__,
                          "name": getattr(node, "name", None), "batches": st.batches,
                          "insertions": st.insertions, "deletions": st.deletions,
                          "time_spent_ms": 1e3 * st.time_spent})
    udf_ms = sum(x["time_spent_ms"] for x in nodes if x["type"] == "BatchApplyNode")
    probed_ms = sum(x["time_spent_ms"] for x in nodes)
    busy_ms = sum(k[0] for k in kernels)
    doc_commits = len(obs["doc_times"])
    commit_ms = 1e3 * sum(inside)
    engine = {
        "docs": n, "commits_with_docs": doc_commits, "commits": len(inside),
        "wall_ms": wall_ms, "in_commit_wall_ms": commit_ms,
        "device_busy_ms": busy_ms if kernels else "not measured",
        "wall_ms_per_doc_commit": wall_ms / doc_commits,
        "device_busy_ms_per_doc_commit": busy_ms / doc_commits if kernels else "not measured",
        "wall_ms_per_256_docs": wall_ms / (n / CHUNK),
        "in_commit_wall_ms_per_256_docs": commit_ms / (n / CHUNK),
        "device_busy_ms_per_256_docs": busy_ms / (n / CHUNK) if kernels else "not measured",
        "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else "not measured",
        "device_idle_share_in_commits": (1.0 - busy_ms / commit_ms) if kernels else "not measured",
        "batch_apply_ms": udf_ms, "probed_nodes_ms": probed_ms,
        # the engine's own host time: in-commit wall less the batch-apply node's
        # time, which holds the embed calls
        "engine_own_ms_per_256_docs": (commit_ms - udf_ms) / (n / CHUNK),
        "outside_nodes_ms_per_256_docs": (commit_ms - probed_ms) / (n / CHUNK),
        "device_pipeline": {**device_pipeline.PIPELINE.stats(), **_pipe_since(mark)},
    }
    index = DeviceKnnIndex(dim=DIM, capacity=CAPACITY)

    def loop() -> None:
        for c in range(n // CHUNK):
            keys = range(c * CHUNK, (c + 1) * CHUNK)
            index.add(keys, embedder.embed_batch(corpus[c * CHUNK:(c + 1) * CHUNK]))

    loop_wall_ms, loop_kernels, _ops = _profiled(loop)
    loop_busy_ms = sum(k[0] for k in loop_kernels)
    device_path = {
        "docs": n, "commits": n // CHUNK, "wall_ms": loop_wall_ms,
        "device_busy_ms": loop_busy_ms if loop_kernels else "not measured",
        "wall_ms_per_commit": loop_wall_ms / (n // CHUNK),
        "device_busy_ms_per_commit": loop_busy_ms / (n // CHUNK) if loop_kernels else "not measured",
        "device_idle_share": (1.0 - loop_busy_ms / loop_wall_ms) if loop_kernels else "not measured",
    }
    card.emit("engine_host_cost", window=f"{n} docs through pw.run and through the device-path loop",
              engine=engine, device_path_loop=device_path, nodes=nodes,
              engine_top=[{"kernel": k[:80], "device_ms": ms, "launches": c} for ms, k, c in kernels[:8]])
    del index


def train_batch(n: int, vocab_size: int) -> ContrastiveBatch:
    """n (query, positive) pairs on the card, padded to SEQ_LEN: each positive is a
    generated doc, its query the doc's first 3-8 words."""
    rng = np.random.default_rng(SEED)
    docs = [doc_text(i) for i in range(n)]
    queries = [" ".join(doc.split()[: int(rng.integers(3, 9))]) for doc in docs]
    tok = HashTokenizer(vocab_size)
    out = []
    for texts in (queries, docs):
        ids, mask = tok.encode_batch(texts, SEQ_LEN)
        ids, mask, real = pad_to_buckets(ids, mask, batch_bucket_min=n, seq_bucket_min=SEQ_LEN)
        check(real == n and ids.shape == (n, SEQ_LEN), "train batch shape")
        out += [torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()]
    return ContrastiveBatch(*out)


def _grad_cosines(a: dict, b: dict, hidden: int) -> dict:
    """Cosine between two gradients, per parameter. The fused qkv projection counts as
    its three projections (the q, k and v columns of ``qkv_w`` and ``qkv_b``): the
    attention's dQ and dK reach only the q and k columns, which the v columns would
    otherwise outweigh. The k columns of ``qkv_b`` are left out: a key bias adds the
    same q.b to every score of a row, which the softmax ignores, so their exact
    gradient is zero and the computed one is rounding noise."""
    out = {}
    for name, x in a.items():
        y = b[name]
        parts = {name: (x, y)}
        if name.endswith(("qkv_w", "qkv_b")):
            parts = {f"{name}[{p}]": (x[..., i * hidden:(i + 1) * hidden], y[..., i * hidden:(i + 1) * hidden])
                     for i, p in enumerate("qkv") if not (p == "k" and name.endswith("qkv_b"))}
        for part, (u, w) in parts.items():
            nu, nw = float(u.norm()), float(w.norm())
            out[part] = 1.0 if nu == nw == 0.0 else float((u * w).sum()) / max(nu * nw, 1e-30)
    return out


def phase_train(card: Card) -> dict:
    cfg = minilm_l6()
    init_fn, step_fn = make_train_step(cfg)
    state = init_fn(seed=SEED)
    weights = {n: p.detach().clone() for n, p in state.params.state_dict().items()}
    batch = train_batch(TRAIN_PAIRS, cfg.vocab_size)
    real_tokens = [float(m.sum(dim=1).float().mean()) for m in (batch.q_mask, batch.d_mask)]
    kernels = {"flash_attention_fwd": fa.KERNEL, "flash_attention_bwd_dq": fa.BWD_DQ_KERNEL,
               "flash_attention_bwd_dkv": fa.BWD_DKV_KERNEL}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for kern in kernels.values():
        kern.launches = 0
    events, losses = [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step_fn(state, batch)
        end.record()
        events.append((start, end))
        losses.append(loss)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [s.elapsed_time(e) for s, e in events]
    losses = [float(x) for x in losses]
    steady_ms = float(np.median(step_ms[1:]))
    card.emit("train", model="all-MiniLM-L6-v2 (hidden 384, 6 layers, 12 heads, seeded, f32 masters, bf16 compute)",
              pairs=TRAIN_PAIRS, seq_len=SEQ_LEN, steps=TRAIN_STEPS,
              real_tokens_per_seq={"query": real_tokens[0], "doc": real_tokens[1]},
              step_ms=step_ms, step_ms_median=steady_ms, pairs_per_s=TRAIN_PAIRS / (steady_ms / 1e3),
              wall_s=wall_s, peak_device_gib=peak_gib, losses=losses, launches=launches,
              launches_per_step={name: n / TRAIN_STEPS for name, n in launches.items()})
    for name, n in launches.items():
        check(n == 2 * cfg.layers * TRAIN_STEPS, f"{name}: {n} launches in {TRAIN_STEPS} steps, not 12 a step")
    check(all(math.isfinite(x) for x in losses), f"finite losses {losses}")
    check(losses[2] < losses[0] and losses[-1] < losses[0], f"the loss falls: {losses}")
    phase_train_profile(card, lambda: step_fn(state, batch))
    del state, batch

    phase_train_parity(card, cfg, weights)
    return launches


def phase_train_profile(card: Card, step, steps: int = 2) -> None:
    """Where a train step's time goes: a profiler window over a few more steps, with
    device time by kernel, by group, and the device's idle share; and whether dq, dk and
    dv are still concatenated (autograd of a split of the qkv projection, ``cat`` on the
    host and its copy kernel on the card): the fused route leaves no split to undo."""
    def run() -> None:
        for _ in range(steps):
            step()

    wall_ms, kernels, ops = _profiled(run)
    busy_ms = sum(k[0] for k in kernels)
    groups = {"flash kernels (this port)": ("flash_",), "matmuls (cuBLAS)": ("nvjet", "gemm", "cutlass"),
              "optimizer (AdamW, foreach)": ("multi_tensor_apply",)}
    by_group = {name: 0.0 for name in (*groups, "other (elementwise, reductions, copies)")}
    for ms, key, _count in kernels:
        group = next((g for g, marks in groups.items() if any(m in key for m in marks)),
                     "other (elementwise, reductions, copies)")
        by_group[group] += ms / steps
    card.emit(
        "train_profile",
        window=f"{steps} train steps at {TRAIN_PAIRS} pairs",
        wall_ms_per_step=wall_ms / steps,
        device_busy_ms_per_step=busy_ms / steps if kernels else "not measured",
        device_idle_share=(1.0 - busy_ms / wall_ms) if kernels else "not measured",
        device_ms_per_step_by_group=by_group,
        top=[{"kernel": k[:80], "device_ms_per_step": ms / steps, "launches": c}
             for ms, k, c in kernels[:15]],
    )
    split_nodes = {k: n for k, n in ops.items() if k.startswith(("SplitBackward", "SplitWithSizesBackward"))}
    cat_kernels = [{"kernel": k[:80], "device_ms_per_step": ms / steps, "launches": c}
                   for ms, k, c in kernels if "CatArray" in k]  # at::cat's copy kernels
    card.emit("qkv_grad_concat", window=f"{steps} train steps at {TRAIN_PAIRS} pairs",
              split_backward_nodes=split_nodes, aten_cat_calls=ops.get("aten::cat", 0),
              cat_kernels=cat_kernels)
    check(not split_nodes, f"a split's backward still concatenates gradients: {split_nodes}")


def phase_train_parity(card: Card, cfg, weights: dict) -> None:
    """One step's loss and gradients at PARITY_PAIRS pairs from the same initial
    weights, through the kernels and through the plain versions on the same
    ``autograd.Function``; and, to show what the bar can see, through the plain
    versions with a broken backward that leaves delta out (o read as zeros)."""
    def plain(q, k, v, mask):
        bias = None if mask is None else fa.mask_bias(mask)
        return fa.FlashAttention.apply(q, k, v, bias, fa.flash_attention_fwd_reference,
                                       fa.flash_attention_bwd_reference)

    def no_delta_bwd(q, k, v, bias, do, o, lse):
        return fa.flash_attention_bwd_reference(q, k, v, bias, do, torch.zeros_like(o), lse)

    def broken(q, k, v, mask):
        bias = None if mask is None else fa.mask_bias(mask)
        return fa.FlashAttention.apply(q, k, v, bias, fa.flash_attention_fwd_reference, no_delta_bwd)

    model = Encoder(cfg, device="cuda", seed=None, trainable=True)
    model.load_state_dict(weights)
    batch = train_batch(PARITY_PAIRS, cfg.vocab_size)

    def loss_and_grads(attn_fn):
        model.zero_grad(set_to_none=True)
        loss = info_nce_loss(model, batch, cfg, 0.05, attn_fn)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    kernel_loss, kernel_grads = loss_and_grads(fa.flash_attention)
    plain_loss, plain_grads = loss_and_grads(plain)
    broken_loss, broken_grads = loss_and_grads(broken)
    cos = _grad_cosines(kernel_grads, plain_grads, cfg.hidden)
    broken_cos = _grad_cosines(broken_grads, plain_grads, cfg.hidden)
    worst = min(cos, key=cos.get)
    broken_worst = min(broken_cos, key=broken_cos.get)
    card.emit("train_parity", pairs=PARITY_PAIRS, kernel_loss=kernel_loss, plain_loss=plain_loss,
              loss_tol=LOSS_TOL, min_grad_cosine=cos[worst], min_grad_cosine_param=worst,
              bar=GRAD_COS_BAR, grad_cosine=cos,
              broken_no_delta={"loss": broken_loss, "min_grad_cosine": broken_cos[broken_worst],
                               "min_grad_cosine_param": broken_worst})
    check(all(math.isfinite(x) for x in (kernel_loss, plain_loss)), "finite parity losses")
    check(abs(kernel_loss - plain_loss) <= LOSS_TOL, f"parity loss {kernel_loss} vs {plain_loss}")
    check(cos[worst] >= GRAD_COS_BAR, f"gradient cosine {cos[worst]} ({worst})")
    check(broken_cos[broken_worst] < GRAD_COS_BAR,
          f"the bar cannot see a backward without delta: {broken_cos[broken_worst]}")


# -- the other model families: vision (BASELINE config #5), the reranker (#3), the
# decoder and its chat (#4) --------------------------------------------------------

N_IMAGES = 512  # bench.py multimodal_leg's BENCH_MM_IMAGES
N_IMAGE_QUERIES = 16  # and its BENCH_MM_QUERIES
IMAGE_BATCH = 64  # the embedder's max_batch_size in multimodal_leg
RERANK_BATCH = 256  # reranker_leg's BENCH_RERANK_BATCH
RERANK_SECONDS = 3.0  # reranker_leg's timed loop
DECODE_PROMPT = 128  # decode_leg's prompt of ones (bench.py SEQ_LEN)
SAMPLE_TOKENS = 16
CHAT_PROMPTS = 8
CHAT_NEW_TOKENS = 32
# Mistral-7B shape: every parameter of DecoderConfig() (embedding and lm_head untied)
MISTRAL_7B_PARAMS = 7_241_732_096


def make_png(i: int, noisy_rng: "np.random.Generator | None" = None) -> bytes:
    """bench.py multimodal_leg's ``make_png``: a 64x64 RGB image seeded by ``i``, with
    noise of +-12 levels from ``noisy_rng`` (the bench's one generator of seed 0, drawn
    in query order) when given."""
    from PIL import Image

    arr = np.random.default_rng(i).integers(0, 255, (64, 64, 3), np.uint8)
    if noisy_rng is not None:
        noise = noisy_rng.integers(-12, 12, arr.shape)
        arr = np.clip(arr.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="PNG")
    return buf.getvalue()


def vit_flops(cfg, b: int) -> float:
    """Multiply-adds x 2 of one ViT forward over b images: the patch embed, per layer
    the qkv, attention, output and MLP products, the projection."""
    t, hid = cfg.n_patches + 1, cfg.hidden
    per_layer = 2 * t * hid * (3 * hid + hid + 2 * cfg.intermediate) + 4 * t * t * hid
    return b * (2 * cfg.n_patches * cfg.patch * cfg.patch * 3 * hid
                + cfg.layers * per_layer + 2 * hid * cfg.out_dim)


def _count_calls(obj, name: str) -> list[int]:
    """Count the calls of ``obj.name`` (an instance attribute shadowing the method)
    -> the list of each call's row count; ``del obj.name`` restores the method."""
    sizes = []
    method = getattr(obj, name)

    def counted(rows, *args):
        sizes.append(len(rows))
        return method(rows, *args)

    setattr(obj, name, counted)
    return sizes


def phase_vision_parity(card: Card, embedder) -> int:
    """One 64-image batch of 224-px pixels (the bench's PNGs, resized on the host)
    through ``ImageEmbedder``'s forward with the kernel, and through the same weights
    with the plain attention on the card; and ``normalize_u8`` on the card against the
    host's ``preprocess_image``. Then the forward's time against its FLOP bound."""
    from PIL import Image

    cfg = embedder.config
    images = [Image.open(io.BytesIO(make_png(i))) for i in range(IMAGE_BATCH)]
    pixels = np.stack([preprocess_image_u8(img, cfg) for img in images])
    host = np.stack([preprocess_image(img, cfg) for img in images])
    dev = torch.from_numpy(pixels).cuda()
    norm_err = float(np.abs(normalize_u8(dev).cpu().numpy() - host).max())
    fa.KERNEL.launches = 0
    ours = embedder.forward_u8(pixels)
    torch.cuda.synchronize()
    launches = fa.KERNEL.launches
    ref = vision_forward(embedder.encoder, normalize_u8(dev), attn_fn=plain_attention)
    err = (ours - ref).abs().max().item()
    cos_min = float((ours * ref).sum(dim=1).min())
    finite = bool(torch.isfinite(ours).all()) and ours.shape == (IMAGE_BATCH, cfg.out_dim)
    norms = torch.linalg.vector_norm(ours, dim=1)
    forward_ms = cuda_ms(lambda: embedder.forward_u8(pixels), iters=20)
    flops = vit_flops(cfg, IMAGE_BATCH)
    card.emit("vision_parity", model="CLIP ViT-B/16 image tower (224 px, patch 16, hidden 768, "
              "12 layers, 12 heads, seeded)", batch=IMAGE_BATCH, max_abs_err=err,
              tol=TOL[torch.bfloat16], min_cosine=cos_min, normalize_u8_max_abs_err=norm_err,
              normalize_tol=1e-6, flash_launches=launches,
              unit_norm_max_dev=float((norms - 1).abs().max()),
              forward_ms=forward_ms, forward_gflop=flops / 1e9,
              forward_bound_ms=1e3 * flops / BF16_FLOP_PER_S,
              forward_roofline_share=1e3 * flops / BF16_FLOP_PER_S / forward_ms,
              note="forward_ms includes the uint8 upload and normalize_u8")
    check(finite, "vision embeddings: shape and finiteness")
    check(float((norms - 1).abs().max()) < 1e-3, "vision embeddings are unit vectors")
    check(math.isfinite(err) and err <= TOL[torch.bfloat16], f"vision kernel vs plain: {err}")
    check(norm_err <= 1e-6, f"normalize_u8 on the card vs the host: {norm_err}")
    check(launches == cfg.layers, f"vision: {launches} forward launches, not {cfg.layers}")
    return launches


def _multimodal_program(embedder, blobs: list, query_blobs: list, factory):
    """``bench.py::multimodal_leg``'s program against the port: PNG bytes through the
    python connector (100 ms autocommit), the image embedder UDF and DataIndex; one
    noisy query per commit once every image has reached the subscriber, top-1."""
    obs = {"imgs": {}, "answers": {}, "failures": [], "run_start": 0.0, "ingest_end": 0.0}
    ingest_done, answer_seen = threading.Event(), threading.Event()

    class ImgFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            obs["run_start"] = time.perf_counter()
            for i, blob in enumerate(blobs):
                self.next(img_id=i, data=blob)

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            if not ingest_done.wait(timeout=300.0):
                obs["failures"].append(f"{len(obs['imgs'])} of {len(blobs)} images arrived")
                return
            for i, blob in enumerate(query_blobs):
                answer_seen.clear()
                self.next(qid=i, data=blob)
                if not answer_seen.wait(timeout=120.0):
                    obs["failures"].append(f"no answer to query {i}")
                    return

    imgs = pw.io.python.read(ImgFeed(), schema=pw.schema_from_types(img_id=int, data=bytes),
                             autocommit_duration_ms=100)
    imgs = imgs.select(img_id=pw.this.img_id, emb=embedder(pw.this.data))
    queries = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(qid=int, data=bytes),
                                autocommit_duration_ms=None)
    queries = queries.select(qid=pw.this.qid, qemb=embedder(pw.this.data))
    res = DataIndex(imgs, factory, imgs.emb).query_as_of_now(queries, queries.qemb,
                                                             number_of_matches=1)

    def on_img(key, row, time, is_addition):
        if is_addition:
            obs["imgs"][key] = (row["img_id"], np.asarray(row["emb"], np.float32))
            if len(obs["imgs"]) == len(blobs):
                obs["ingest_end"] = perf_counter()
                ingest_done.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            obs["answers"][row["qid"]] = (tuple(row["_pw_index_reply_ids"]),
                                          np.asarray(row["qemb"], np.float32))
            answer_seen.set()

    perf_counter = time.perf_counter  # the callbacks' ``time`` argument shadows the module
    pw.io.subscribe(imgs, on_change=on_img)
    pw.io.subscribe(res, on_change=on_answer)
    return obs, pw.run


def phase_multimodal_pipeline(card: Card, embedder) -> int:
    """``bench.py::multimodal_leg`` (BASELINE config #5) through the port's ``pw.run``:
    512 PNG images of 64x64 and 16 noisy queries, ViT-B/16 at full width, a 1,024-slot
    index. Reports images/s, the noisy-query top-1 and the forward's launches; checks
    that every query is answered with the top-1 of an exact f32 host search over the
    embeddings the subscriber received. Then the same program under the profiler, for
    the device's idle share inside commits."""
    blobs = [make_png(i) for i in range(N_IMAGES)]
    noise = np.random.default_rng(0)
    query_blobs = [make_png((i * 31) % N_IMAGES, noise) for i in range(N_IMAGE_QUERIES)]
    for b in (8, IMAGE_BATCH):
        embedder._fn(blobs[:b])  # warm, as the bench does
    dim = embedder.get_embedding_dimension()
    sizes = _count_calls(embedder, "forward_u8")
    factory = _KeptKnnFactory(dimensions=dim, capacity=1024)
    obs, run = _multimodal_program(embedder, blobs, query_blobs, factory)
    device_pipeline.PIPELINE.configure()
    fa.KERNEL.launches = 0
    t0 = time.perf_counter()
    try:
        run()
    finally:
        del embedder.forward_u8
    run_s = time.perf_counter() - t0
    launches = fa.KERNEL.launches
    imgs, answers = obs["imgs"], obs["answers"]
    keys = list(imgs)
    mat = np.stack([imgs[k][1] for k in keys])
    norms = np.linalg.norm(mat, axis=1)
    exact_ok, top1 = [], []
    for qid, (hits, qvec) in sorted(answers.items()):
        scores = mat @ qvec / np.maximum(norms * np.linalg.norm(qvec), 1e-30)
        exact_ok.append(len(hits) == 1 and hits[0] == keys[int(np.argmax(scores))])
        top1.append(bool(hits) and imgs[hits[0]][0] == (qid * 31) % N_IMAGES)
    ingest_s = obs["ingest_end"] - obs["run_start"]
    index = factory.built

    # the same program under the profiler: the device's idle share inside commits
    factory2 = DeviceKnnFactory(dimensions=dim, capacity=1024)
    obs2, run2 = _multimodal_program(embedder, blobs, query_blobs, factory2)
    device_pipeline.PIPELINE.configure()
    wall_ms, kernels, inside, _sched = _profiled_commits(run2)
    busy_ms = sum(k[0] for k in kernels)
    commit_ms = 1e3 * sum(inside)
    card.emit(
        "multimodal_pipeline",
        model="CLIP ViT-B/16 image tower (224 px, hidden 768, 12 layers, seeded)",
        n_images=len(imgs), n_queries=len(answers), images_per_s=N_IMAGES / ingest_s if ingest_s > 0 else None,
        ingest_s=ingest_s, run_s=run_s, noisy_query_top1=float(np.mean(top1)) if top1 else None,
        answers_equal_exact_f32_search=all(exact_ok) and len(exact_ok) == N_IMAGE_QUERIES,
        embed_calls=len(sizes), embed_chunk_sizes=sizes, flash_launches=launches,
        index_rows_device_route=index.rows_device, index_rows_host_route=index.rows_host,
        live_device_batches_after_run=device_batches_held(),
        profiled_run={"wall_ms": wall_ms, "in_commit_wall_ms": commit_ms, "commits": len(inside),
                      "device_busy_ms": busy_ms if kernels else "not measured",
                      "device_idle_share": (1 - busy_ms / wall_ms) if kernels else "not measured",
                      "device_idle_share_in_commits": (1 - busy_ms / commit_ms) if kernels else "not measured",
                      "images": len(obs2["imgs"]), "answers": len(obs2["answers"]),
                      "top": [{"kernel": k[:80], "device_ms": ms, "launches": c} for ms, k, c in kernels[:8]]},
        failures=obs["failures"] + obs2["failures"],
    )
    check(not obs["failures"] and not obs2["failures"], f"multimodal: {obs['failures'] + obs2['failures']}")
    check(len(imgs) == N_IMAGES and len(obs2["imgs"]) == N_IMAGES, f"{len(imgs)} of {N_IMAGES} images arrived")
    check(len(answers) == N_IMAGE_QUERIES and len(obs2["answers"]) == N_IMAGE_QUERIES,
          f"{len(answers)} of {N_IMAGE_QUERIES} queries answered")
    check(all(exact_ok), "multimodal: an answer differs from the exact f32 search")
    check(launches > 0 and launches == embedder.config.layers * len(sizes),
          f"multimodal: {launches} forward launches for {len(sizes)} embed calls")
    check(index.rows_device == N_IMAGES and index.rows_host == 0,
          f"multimodal index routes: {index.rows_device} device, {index.rows_host} host")
    check(device_batches_held() == 0, "device batches held after the multimodal run")
    return launches


def phase_rerank(card: Card) -> int:
    """``bench.py::reranker_leg`` (BASELINE config #3): the cross-encoder reranker over
    256 (doc, query) pairs in a 3 s loop, pairs/s; the forward's launches per call; a
    profiler window over a few calls; one batch's scores with the kernel against the
    plain attention; and one ``pw.run`` of the same pairs as a two-column UDF, whose
    scores must be the direct call's on the same chunks."""
    rr = CrossEncoderReranker(max_batch_size=RERANK_BATCH, seed=SEED)
    docs = [doc_text(i) for i in range(RERANK_BATCH)]
    queries = [doc_text(i * 7) for i in range(RERANK_BATCH)]
    direct = rr._fn(docs, queries)  # warm
    fa.KERNEL.launches = 0
    calls, pairs = 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < RERANK_SECONDS:
        scores = rr._fn(docs, queries)
        calls += 1
        pairs += len(scores)
    loop_s = time.perf_counter() - t0
    launches = fa.KERNEL.launches
    wall_ms, kernels, _ops = _profiled(lambda: [rr._fn(docs, queries) for _ in range(4)])
    busy_ms = sum(k[0] for k in kernels)

    ids, mask, real = rr.tokenize(docs, queries)
    ours = cross_encode(rr.model, ids, mask)[:real]
    ref = cross_encode(rr.model, ids, mask, attn_fn=plain_attention)[:real]
    rel = _rel_err(ours, ref)

    # the same pairs through pw.run, select(score=rr(doc, query))
    chunks, score_batch = [], rr._fn

    def recorded(d, q):
        chunks.append((list(d), list(q)))
        return score_batch(d, q)

    rr._fn = recorded
    got, done = {}, threading.Event()

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i, (d, q) in enumerate(zip(docs, queries)):
                self.next(pair_id=i, doc=d, query=q)

    rows = pw.io.python.read(Feed(), schema=pw.schema_from_types(pair_id=int, doc=str, query=str),
                             autocommit_duration_ms=100)
    scored = rows.select(pair_id=pw.this.pair_id, score=rr(pw.this.doc, pw.this.query))

    def on_change(key, row, time, is_addition):
        if is_addition:
            got[row["pair_id"]] = row["score"]
            if len(got) == RERANK_BATCH:
                done.set()

    pw.io.subscribe(scored, on_change=on_change)
    device_pipeline.PIPELINE.configure()
    try:
        pw.run()
    finally:
        rr._fn = score_batch
    same_chunks = {}
    for d, q in chunks:
        same_chunks.update(zip(d, score_batch(d, q)))
    engine_scores = [got.get(i) for i in range(RERANK_BATCH)]
    equal_chunks = engine_scores == [same_chunks.get(d) for d in docs]
    card.emit("rerank", model="MiniLM-L6 cross-encoder (hidden 384, 6 layers, 12 heads, seeded)",
              batch=RERANK_BATCH, padded_shape=list(ids.shape), pairs_per_s=pairs / loop_s,
              calls=calls, loop_s=loop_s, flash_launches=launches,
              launches_per_call=launches / calls if calls else None,
              profile={"window": "4 calls of 256 pairs", "wall_ms_per_call": wall_ms / 4,
                       "device_busy_ms_per_call": busy_ms / 4 if kernels else "not measured",
                       "device_idle_share": (1 - busy_ms / wall_ms) if kernels else "not measured",
                       "top": [{"kernel": k[:80], "device_ms_per_call": ms / 4, "launches": c}
                               for ms, k, c in kernels[:8]]},
              kernel_vs_plain_rel_err=rel, tol=TOL[torch.bfloat16],
              engine={"answered": len(got), "chunks": [len(d) for d, _q in chunks],
                      "scores_equal_direct_on_same_chunks": equal_chunks,
                      "scores_equal_one_direct_call": engine_scores == direct})
    check(launches == LAYERS * calls, f"rerank: {launches} forward launches for {calls} calls")
    check(all(math.isfinite(x) for x in direct), "rerank scores are finite")
    check(math.isfinite(rel) and rel <= TOL[torch.bfloat16], f"rerank kernel vs plain: {rel}")
    check(len(got) == RERANK_BATCH, f"rerank pw.run answered {len(got)} of {RERANK_BATCH}")
    check(equal_chunks, "rerank: pw.run scores differ from the direct call's")
    return launches


def _step_logits(model, prompt: torch.Tensor, max_new: int, prefix: torch.Tensor) -> torch.Tensor:
    """The logits greedy decode sees at step ``len(prefix)``: the prompt's prefill and
    one cached step per prefix token, at the shapes ``greedy_generate`` uses (its cache
    length), so the logits are the same bits."""
    cache = init_cache(model.cfg, prompt.shape[0], prompt.shape[1] + max_new)
    offset = torch.zeros((prompt.shape[0],), dtype=torch.int64, device=prompt.device)
    logits, cache = decoder_forward(model, prompt, cache, pos_offset=offset)
    for j in range(prefix.shape[1]):
        logits, cache = decoder_forward(model, prefix[:, j:j + 1], cache, pos_offset=offset)
    return logits[:, -1]


def phase_decode(card: Card) -> "PipelineChat":
    """``bench.py::decode_leg`` (BASELINE config #4): the Mistral-7B shape with seeded
    bf16 weights on one card (built by ``PipelineChat``, whose decoder the chat phase
    reuses), greedy decode of a 128-token prompt of ones for 4 and for 36 new tokens:
    per-step ms by the bench's formula ((t36 - t4) / 32), tokens/s, HBM utilisation by
    the bench's formula and the step against its byte bound; the prefill and 32 steps
    after it timed alone; a profiler window over decode steps; and the checks:
    two greedy runs give the same tokens, ``top_k=1`` sampling gives the greedy tokens
    (up to a tie of the top logits, which top-k keeps as JAX's filter does), two rows of
    one prompt and one seed in a batch of 3 give the same tokens, and a sampled row
    gives the batch's tokens alone up to the first step where its logits differ (cuBLAS
    may round a product of another shape apart)."""
    gc.collect()
    torch.cuda.empty_cache()
    before_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chat = PipelineChat("mistral-7b", max_new_tokens=CHAT_NEW_TOKENS, max_batch_size=CHAT_PROMPTS,
                        seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dec = chat.decoder
    cfg = dec.cfg
    n_params = sum(p.numel() for p in dec.parameters())
    weight_gib = sum(p.numel() * p.element_size() for p in dec.parameters()) / 2**30
    prompt = torch.ones((1, DECODE_PROMPT), dtype=torch.int64, device="cuda")

    def timed(n_new: int) -> tuple[torch.Tensor, float]:
        torch.cuda.synchronize()
        start = time.perf_counter()
        toks = greedy_generate(dec, prompt, n_new)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - start

    first4, _ = timed(4)  # warm
    first36, _ = timed(36)
    toks4, t4 = timed(4)
    toks36, t36 = timed(36)
    # the bench's per-step time: 36 new tokens less 4, over the 32 steps between
    per_step = (t36 - t4) / 32.0
    tok_s = 1.0 / per_step
    # the prefill alone (cache, 128-token forward, first token), and 32 decode steps
    # after it, each ended by a synchronise: the median of three
    offset = torch.zeros((1,), dtype=torch.int64, device="cuda")
    prefills, step_runs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        cache = init_cache(cfg, 1, DECODE_PROMPT + 36)
        logits, cache = decoder_forward(dec, prompt, cache, pos_offset=offset)
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        prefills.append(time.perf_counter() - start)
        start = time.perf_counter()
        for _ in range(32):
            logits, cache = decoder_forward(dec, tok[:, None], cache, pos_offset=offset)
            tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        step_runs.append((time.perf_counter() - start) / 32)
    prefill = float(np.median(prefills))
    per_step_direct = float(np.median(step_runs))
    del cache
    step_bytes = 2 * (n_params - cfg.vocab_size * cfg.hidden)  # every weight but tok_emb
    bound_ms = 1e3 * step_bytes / HBM_BYTES_PER_S
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # a profiler window over decode steps alone, after a prefill
    cache = init_cache(cfg, 1, DECODE_PROMPT + 16)
    logits, cache = decoder_forward(dec, prompt, cache, pos_offset=offset)
    state = {"tok": logits[:, -1].argmax(-1)}
    n_steps = 8

    def steps() -> None:
        for _ in range(n_steps):
            out, _cache = decoder_forward(dec, state["tok"][:, None], cache, pos_offset=offset)
            state["tok"] = out[:, -1].argmax(-1)

    wall_ms, kernels, _ops = _profiled(steps)
    busy_ms = sum(k[0] for k in kernels)
    device_ops = sum(k[2] for k in kernels)
    del cache

    # top_k=1 sampling against greedy
    sampled = sample_generate(dec, prompt, 36, [SEED], top_k=1)
    diverge = (sampled[0] != toks36[0]).nonzero()
    tie = None
    if len(diverge):
        j = int(diverge[0])
        step_logits = _step_logits(dec, prompt, 36, toks36[:, :j])[0]
        g, s_ = int(toks36[0, j]), int(sampled[0, j])
        tie = {"step": j, "greedy_token": g, "sampled_token": s_,
               "tied_at_the_max": bool(step_logits[g] == step_logits[s_] == step_logits.max())}
    # a sampled row alone and inside a batch of 3. Rows 0 and 2 are one prompt with one
    # seed: inside one batch they meet the same products, so their tokens must be the
    # same. Alone, a row meets products of another shape, which cuBLAS may round apart
    # in bf16: its tokens must be the batch's up to the first step where its logits
    # differ between the two runs.
    rng = np.random.default_rng(SEED)
    other = torch.from_numpy(rng.integers(4, cfg.vocab_size, (1, DECODE_PROMPT))).cuda()
    batch_prompts = torch.cat([prompt, other, prompt])
    seeds = [11, 12, 11]
    knobs = dict(temperature=0.8, top_k=50, top_p=0.9, eos_id=EOS_ID)
    batch = sample_generate(dec, batch_prompts, SAMPLE_TOKENS, seeds, **knobs)
    alone_rows = []
    for r in range(2):
        alone = sample_generate(dec, batch_prompts[r:r + 1], SAMPLE_TOKENS, [seeds[r]], **knobs)
        diverge = (alone[0] != batch[r]).nonzero()
        row = {"row": r, "steps_equal": int(diverge[0]) if len(diverge) else SAMPLE_TOKENS}
        if len(diverge):
            j = row["steps_equal"]
            in_batch = _step_logits(dec, batch_prompts, SAMPLE_TOKENS, batch[:, :j])[r]
            by_itself = _step_logits(dec, batch_prompts[r:r + 1], SAMPLE_TOKENS, alone[:, :j])[0]
            row["logits_differ_at_divergence"] = not torch.equal(in_batch, by_itself)
            row["logits_max_abs_diff"] = (in_batch - by_itself).abs().max().item()
        alone_rows.append(row)
    duplicate_rows_equal = bool(torch.equal(batch[0], batch[2]))

    card.emit(
        "decode",
        model=f"Mistral-7B shape (hidden {cfg.hidden}, {cfg.layers} layers, {cfg.heads} heads / "
              f"{cfg.kv_heads} kv heads, intermediate {cfg.intermediate}, vocab {cfg.vocab_size}; "
              "seeded bf16 weights)",
        n_params=n_params, weights_gib=weight_gib, init_s=init_s, prompt_len=DECODE_PROMPT,
        device_gib_before_phase=before_gib, peak_device_gib=peak_gib,
        t4_s=t4, t36_s=t36, prefill_ms=1e3 * prefill, prefill_ms_runs=[1e3 * x for x in prefills],
        per_step_ms=1e3 * per_step, per_step_ms_direct=1e3 * per_step_direct,
        per_step_ms_direct_runs=[1e3 * x for x in step_runs], decode_tokens_per_s=tok_s,
        hbm_utilization=2.0 * n_params * tok_s / HBM_BYTES_PER_S,
        step_bound_ms=bound_ms, step_bound_by="bytes (every bf16 weight but tok_emb, once a step)",
        step_roofline_share=bound_ms / (1e3 * per_step),
        profile={"window": f"{n_steps} decode steps at batch 1 after a {DECODE_PROMPT}-token prefill",
                 "wall_ms_per_step": wall_ms / n_steps,
                 "device_busy_ms_per_step": busy_ms / n_steps if kernels else "not measured",
                 "device_idle_share": (1 - busy_ms / wall_ms) if kernels else "not measured",
                 "device_ops_per_step": device_ops / n_steps,
                 "top": [{"kernel": k[:80], "device_ms_per_step": ms / n_steps, "launches": c}
                         for ms, k, c in kernels[:10]]},
        greedy_tokens=toks36[0].tolist(),
        greedy_runs_equal=bool(torch.equal(first36, toks36) and torch.equal(first4, toks4)),
        top_k_1_equals_greedy=tie is None, top_k_1_tie=tie,
        sampled_duplicate_rows_equal_in_batch=duplicate_rows_equal,
        sampled_row_alone_against_batch=alone_rows,
    )
    check(n_params == MISTRAL_7B_PARAMS, f"Mistral-7B shape: {n_params} parameters")
    check(toks36.shape == (1, 36) and bool(((toks36 >= 0) & (toks36 < cfg.vocab_size)).all()),
          "greedy tokens: shape and range")
    check(torch.equal(first36, toks36) and torch.equal(first4, toks4), "two greedy runs differ")
    check(tie is None or tie["tied_at_the_max"],
          f"top_k=1 sampling left greedy decode without a tie of the top logits: {tie}")
    check(duplicate_rows_equal, "two rows of one prompt and one seed sampled apart in a batch")
    check(all(row["steps_equal"] == SAMPLE_TOKENS or row["logits_differ_at_divergence"]
              for row in alone_rows),
          f"a sampled row left the batch's tokens with the same logits: {alone_rows}")
    check(per_step > 0 and per_step_direct > 0 and prefill > 0,
          f"decode timing: step {per_step} / {per_step_direct}, prefill {prefill}")
    return chat


def phase_chat_engine(card: Card, chat) -> dict:
    """Eight prompts through ``PipelineChat("mistral-7b", max_new_tokens=32)`` in
    ``pw.run``, with the decode phase's weights. Every prompt must be answered, and each
    reply must be the tokenizer's decode of a direct ``greedy_generate`` on the same
    left-padded batch (the chunk the UDF was handed)."""
    prompts = [prompt_chat_single_qa(doc_text(i)) if i % 2 else doc_text(i)
               for i in range(CHAT_PROMPTS)]
    chunks, generate = [], chat._fn

    def recorded(batch):
        chunks.append(list(batch))
        return generate(batch)

    chat._fn = recorded
    replies, done = {}, threading.Event()

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i, p in enumerate(prompts):
                self.next(prompt_id=i, prompt=p)

    rows = pw.io.python.read(Feed(), schema=pw.schema_from_types(prompt_id=int, prompt=str),
                             autocommit_duration_ms=100)
    answered = rows.select(prompt_id=pw.this.prompt_id, reply=chat(pw.this.prompt))

    def on_change(key, row, time, is_addition):
        if is_addition:
            replies[row["prompt_id"]] = row["reply"]
            if len(replies) == CHAT_PROMPTS:
                done.set()

    pw.io.subscribe(answered, on_change=on_change)
    device_pipeline.PIPELINE.configure()
    t0 = time.perf_counter()
    try:
        pw.run()
    finally:
        chat._fn = generate
    run_s = time.perf_counter() - t0
    direct = {}
    for batch in chunks:
        ids, mask, _texts = chat.encode_prompts(batch)
        toks = greedy_generate(chat.decoder, ids, CHAT_NEW_TOKENS, eos_id=EOS_ID, prompt_mask=mask)
        direct.update(zip(batch, (chat.tokenizer.decode(list(r)) for r in toks.cpu().numpy())))
    equal = [replies.get(i) == direct.get(p) for i, p in enumerate(prompts)]
    card.emit("chat_engine", model="Mistral-7B shape (the decode phase's weights)",
              prompts=CHAT_PROMPTS, max_new_tokens=CHAT_NEW_TOKENS, answered=len(replies),
              chunks=[len(c) for c in chunks], run_s=run_s,
              generated_tokens_per_s=CHAT_PROMPTS * CHAT_NEW_TOKENS / run_s,
              replies_equal_direct_greedy=equal,
              reply_words=[len(replies.get(i, "").split()) for i in range(CHAT_PROMPTS)])
    check(len(replies) == CHAT_PROMPTS, f"chat: {len(replies)} of {CHAT_PROMPTS} prompts answered")
    check(all(equal), f"chat replies differ from the direct greedy decode: {equal}")
    return {"replies": len(replies)}


# -- the RAG document pipeline of the xpack ----------------------------------------------

VS_DOCS = 3000  # bench.py vector_store_leg's BENCH_VS_DOCS
VS_QUERIES = 16  # and its BENCH_VS_QUERIES
VS_CAPACITY = 4096  # its index capacity: 1 << max(10, (n_docs - 1).bit_length())
VS_PROFILED_DOCS = 768  # the profiled second run: three 256-doc commits' worth
RAG_PROMPTS = 4
DIST_TOL = 1e-5  # dist = 1 - cos, against the exact f32 host search
BGE = "BAAI/bge-base-en-v1.5"


def _vector_store_program(embedder: EncoderEmbedder, corpus, n_queries: int,
                          factory: DeviceKnnFactory, wait_s: float):
    """``bench.py::vector_store_leg``'s program against the port: docs with
    ``_metadata={"path": ...}`` through the python connector (100 ms autocommit) into a
    ``VectorStoreServer`` (parse, split, embed, index on the card), and queries of docs'
    own texts with k = 10, sent one at a time once every chunk has reached the
    subscriber of ``store.indexed``. Returns the observations and the run."""
    n_docs = len(corpus)
    obs = {"chunks": {}, "answers": {}, "latencies": [], "timeouts": [], "failures": [],
           "run_start": 0.0, "ingest_end": 0.0, "doc_times": set()}
    ingest_done, answer_seen = threading.Event(), threading.Event()

    class DocFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            obs["run_start"] = time.perf_counter()
            for i in range(n_docs):
                self.next(data=corpus[i], _metadata={"path": f"/d/{i}"})

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            if not ingest_done.wait(timeout=wait_s):
                obs["failures"].append(f"{len(obs['chunks'])} of {n_docs} chunks arrived")
                return
            for i in range(n_queries):
                answer_seen.clear()
                t0 = time.perf_counter()
                self.next(query=corpus[(i * 53) % n_docs], k=K)
                if answer_seen.wait(timeout=wait_s):
                    obs["latencies"].append(time.perf_counter() - t0)
                else:
                    obs["timeouts"].append(i)

    docs = pw.io.python.read(DocFeed(), schema=pw.schema_from_types(data=str, _metadata=dict),
                             autocommit_duration_ms=100)
    store = VectorStoreServer(docs, embedder=embedder, index_capacity=VS_CAPACITY)
    store.index.factory = factory  # the same index, kept so its routes can be read
    queries = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(query=str, k=int),
                                autocommit_duration_ms=None)
    res = store.retrieve_query(queries)
    perf_counter = time.perf_counter  # the callbacks' ``time`` argument shadows the module

    def on_chunk(key, row, time, is_addition):
        if is_addition:
            meta = row["_metadata"]
            path = getattr(meta, "value", meta)["path"]
            obs["chunks"][path] = (row["text"], np.asarray(row["emb"], np.float32))
            obs["doc_times"].add(time)
            if len(obs["chunks"]) == n_docs:
                obs["ingest_end"] = perf_counter()
                ingest_done.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            obs["answers"][len(obs["answers"])] = row["result"]
            answer_seen.set()

    pw.io.subscribe(store.indexed, on_change=on_chunk)
    pw.io.subscribe(res, on_change=on_answer)
    return obs, pw.run


def _exact_top_k(chunks: dict, qvec: np.ndarray, k: int):
    """Exact f32 cosine search over the vectors the index received -> (paths in rank
    order, dists 1 - cos in that order, the (k+1)-th dist)."""
    paths = sorted(chunks)
    mat = np.stack([chunks[p][1] for p in paths])
    cos = (mat @ qvec) / np.maximum(np.linalg.norm(mat, axis=1) * np.linalg.norm(qvec),
                                    np.float32(1e-30))
    order = np.argsort(-cos, kind="stable")
    dist = 1.0 - cos[order].astype(np.float64)
    return [paths[j] for j in order[:k]], dist[:k], dist[k] if len(order) > k else math.inf


def _check_answer(result, query: str, qvec: np.ndarray, chunks: dict) -> dict:
    """One answer against the exact f32 host search: its top-1 is the query's own doc;
    its paths are the exact top-k's and in its order, where neighbours' dists differ by
    more than DIST_TOL (closer ones are a tie either search may order either way, as is
    the k-th against the (k+1)-th); each dist is 1 - cos of the query and that doc's
    vector within DIST_TOL; each text and path belong together."""
    paths = [hit["metadata"]["path"] for hit in result]
    dists = np.array([hit["dist"] for hit in result], np.float64)
    exact_paths, exact_dist, next_dist = _exact_top_k(chunks, qvec, len(result))
    own = [chunks[p][1] for p in paths]
    direct = np.array([1.0 - float(np.dot(v, qvec) / (np.linalg.norm(v) * np.linalg.norm(qvec)))
                       for v in own])
    ties_only = all(
        a == b or abs(float(exact_dist[i]) - float(dists[i])) <= DIST_TOL
        for i, (a, b) in enumerate(zip(paths, exact_paths))
    ) and (set(paths) == set(exact_paths) or abs(float(exact_dist[-1]) - next_dist) <= DIST_TOL)
    return {
        "k": len(result),
        "top1_own_doc": bool(result) and result[0]["text"] == query,
        "texts_match_paths": all(hit["text"] == chunks[p][0] for hit, p in zip(result, paths)),
        "order_exact": paths == exact_paths,
        "order_within_ties": ties_only,
        "max_dist_err_vs_exact": float(np.abs(dists - exact_dist).max()) if result else None,
        "max_dist_err_vs_own_vector": float(np.abs(dists - direct).max()) if result else None,
    }


def phase_vector_store(card: Card) -> tuple[EncoderEmbedder, int]:
    """``bench.py::vector_store_leg`` (BASELINE config #2) through the port's ``pw.run``:
    3,000 generated docs with ``_metadata`` through the python connector into a
    ``VectorStoreServer`` whose embedder is BGE-base at full width (768 hidden, 12
    layers, 12 heads of 64, bf16, seeded weights, 128-token buckets, 256-doc chunks),
    a 4,096-slot index on the card, then 16 queries of docs' own texts with k = 10, one
    at a time. Reports docs/s (first doc into the connector to the last chunk at the
    subscriber), query p50/p95, peak memory, the forward's launches (12 per embed call)
    and the groupby's device calls; checks that every query is answered, that each
    answer's top-1 is its own doc and its hits and dists are the exact f32 search's
    over the vectors the index received, and that every doc takes the device route.
    Then a profiled run of 768 docs for the device's idle share inside commits."""
    corpus = [doc_text(i) for i in range(VS_DOCS)]
    embedder = EncoderEmbedder(BGE, max_len=SEQ_LEN, max_batch_size=CHUNK,
                               seq_bucket_min=SEQ_LEN, seed=SEED)
    check(embedder.config.hidden == 768 and embedder.config.layers == 12
          and embedder.config.heads == 12 and embedder.config.dtype == torch.bfloat16,
          f"BGE-base config: {embedder.config}")
    for b in (8, 64, CHUNK):
        embedder.embed_batch(corpus[:b])  # warm, as the bench does
    embed_calls, _sizes = _count_embed_calls(embedder)
    factory = _KeptKnnFactory(dimensions=embedder.get_embedding_dimension(), capacity=VS_CAPACITY)
    obs, run = _vector_store_program(embedder, corpus, VS_QUERIES, factory, wait_s=300.0)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    device_pipeline.PIPELINE.configure()
    device_ops.reset_counters()
    fa.KERNEL.launches = 0
    t0 = time.perf_counter()
    try:
        run()
    finally:
        del embedder.embed_batch
    run_s = time.perf_counter() - t0
    launches = fa.KERNEL.launches
    groupby_device_calls = device_ops.hit_counts()
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    index = factory.built
    chunks, answers = obs["chunks"], obs["answers"]
    checks = []
    for i, result in sorted(answers.items()):
        query = corpus[(i * 53) % VS_DOCS]
        qvec = embedder.embed_batch([query]).float().cpu().numpy()[0]  # the run's own shape
        checks.append(_check_answer(result, query, qvec, chunks))
    lat_ms = sorted(1e3 * x for x in obs["latencies"])
    ingest_s = obs["ingest_end"] - obs["run_start"]

    # the same program under the profiler, on fewer docs and no queries: the device's
    # idle share inside commits
    factory2 = DeviceKnnFactory(dimensions=embedder.get_embedding_dimension(), capacity=VS_CAPACITY)
    obs2, run2 = _vector_store_program(embedder, corpus[:VS_PROFILED_DOCS], 0, factory2, wait_s=300.0)
    device_pipeline.PIPELINE.configure()
    wall_ms, kernels, inside, _sched = _profiled_commits(run2)
    busy_ms = sum(k[0] for k in kernels)
    commit_ms = 1e3 * sum(inside)

    # statistics_query's count over the same 3,000 docs (a BM25 store: the count needs
    # no embedding): does the groupby's count take the device route at this size?
    static_docs = pw.debug.table_from_rows(
        pw.schema_from_types(data=str, _metadata=dict),
        [(corpus[i], {"path": f"/d/{i}"}) for i in range(VS_DOCS)])
    stats_query = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,)])
    device_ops.reset_counters()
    stats, _ = pw.debug.table_to_dicts(
        DocumentStore(static_docs, retriever_factory="bm25").statistics_query(stats_query))
    stats_device_calls = device_ops.hit_counts()
    stats_count = [row["count"] for row in stats.values()]
    card.emit(
        "vector_store",
        model=f"{BGE} (hidden 768, 12 layers, 12 heads of 64, bf16, seeded)",
        n_docs=len(chunks), n_queries=len(lat_ms), query_timeouts=len(obs["timeouts"]),
        capacity=index.capacity, docs_per_s=VS_DOCS / ingest_s if ingest_s > 0 else None,
        ingest_s=ingest_s, doc_commits=len(obs["doc_times"]), run_s=run_s,
        query_p50_ms=lat_ms[len(lat_ms) // 2] if lat_ms else None,
        query_p95_ms=lat_ms[int(0.95 * len(lat_ms))] if lat_ms else None,
        query_ms_in_order=[1e3 * x for x in obs["latencies"]],
        top1_self_retrieval=float(np.mean([c["top1_own_doc"] for c in checks])) if checks else None,
        answers_order_exact=sum(c["order_exact"] for c in checks),
        max_dist_err_vs_exact=max((c["max_dist_err_vs_exact"] for c in checks), default=None),
        max_dist_err_vs_own_vector=max((c["max_dist_err_vs_own_vector"] for c in checks), default=None),
        embed_calls=embed_calls[0], flash_launches=launches,
        groupby_device_calls=groupby_device_calls,
        statistics_query={"count": stats_count, "groupby_device_calls": stats_device_calls},
        index_rows_device_route=index.rows_device, index_rows_host_route=index.rows_host,
        live_device_batches_after_run=device_batches_held(), peak_device_gib=peak_gib,
        profiled_run={"docs": len(obs2["chunks"]), "wall_ms": wall_ms, "in_commit_wall_ms": commit_ms,
                      "commits": len(inside),
                      "device_busy_ms": busy_ms if kernels else "not measured",
                      "device_idle_share_in_commits": (1 - busy_ms / commit_ms) if kernels else "not measured",
                      "top": [{"kernel": k[:80], "device_ms": ms, "launches": c} for ms, k, c in kernels[:10]]},
        failures=obs["failures"] + obs2["failures"],
    )
    check(not obs["failures"] and not obs2["failures"], f"vector store: {obs['failures'] + obs2['failures']}")
    check(len(chunks) == VS_DOCS and len(obs2["chunks"]) == VS_PROFILED_DOCS,
          f"{len(chunks)} of {VS_DOCS} chunks arrived")
    check(len(answers) == VS_QUERIES and not obs["timeouts"],
          f"vector store: {len(answers)} answers, timeouts {obs['timeouts']}")
    check(all(c["k"] == K for c in checks), f"vector store: answers of {[c['k'] for c in checks]} hits")
    check(all(c["top1_own_doc"] for c in checks), "vector store: a query's top-1 is not its own doc")
    check(all(c["texts_match_paths"] for c in checks), "vector store: a hit's text and path disagree")
    check(all(c["order_within_ties"] for c in checks),
          "vector store: an answer is not the exact f32 search's top-k")
    check(all(c["max_dist_err_vs_exact"] <= DIST_TOL and c["max_dist_err_vs_own_vector"] <= DIST_TOL
              for c in checks), f"vector store: dist off 1 - cos by more than {DIST_TOL}")
    check(launches > 0 and launches == embedder.config.layers * embed_calls[0],
          f"vector store: {launches} forward launches for {embed_calls[0]} embed calls")
    check(index.rows_device == VS_DOCS and index.rows_host == 0,
          f"vector store index routes: {index.rows_device} device, {index.rows_host} host")
    check(device_batches_held() == 0, "device batches held after the vector store run")
    check(stats_count == [VS_DOCS], f"statistics_query counted {stats_count} chunks")
    return embedder, launches


def phase_rag(card: Card, chat, embedder: EncoderEmbedder) -> int:
    """BASELINE config #4's template: ``AdaptiveRAGQuestionAnswerer`` over the vector
    store's program (the same 3,000 docs, BGE-base and index) with the decode phase's
    chat (the Mistral-7B shape, so no second model is loaded); 4 prompts in one commit
    once every chunk has arrived, so their expansion loops run at once on the event
    loop's worker threads, each calling the chat on the card. Checks that every prompt
    is answered and that each reply is the chat's direct batch-1 reply to the prompt
    ``prompts.prompt_qa`` builds from the first two retrieved docs: the seeded model's
    replies are token ids, which never say "No information found.", so no prompt
    expands (checked)."""
    from pathway_tpu_torch.internals.udfs.executors import stop_event_loop
    from pathway_tpu_torch.xpacks.llm import prompts

    corpus = [doc_text(i) for i in range(VS_DOCS)]
    questions = [corpus[(i * 331) % VS_DOCS] for i in range(RAG_PROMPTS)]
    obs = {"chunks": 0, "replies": {}, "failures": [], "sent": 0.0, "done": 0.0}
    ingest_done, all_answered = threading.Event(), threading.Event()
    perf_counter = time.perf_counter

    class DocFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i in range(VS_DOCS):
                self.next(data=corpus[i], _metadata={"path": f"/d/{i}"})

    class PromptFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            if not ingest_done.wait(timeout=300.0):
                obs["failures"].append(f"{obs['chunks']} of {VS_DOCS} chunks arrived")
                return
            obs["sent"] = perf_counter()
            for q in questions:
                self.next(prompt=q)
            if not all_answered.wait(timeout=300.0):
                obs["failures"].append(f"{len(obs['replies'])} of {RAG_PROMPTS} prompts answered")

    docs = pw.io.python.read(DocFeed(), schema=pw.schema_from_types(data=str, _metadata=dict),
                             autocommit_duration_ms=100)
    store = VectorStoreServer(docs, embedder=embedder, index_capacity=VS_CAPACITY)
    rag = AdaptiveRAGQuestionAnswerer(chat, store, n_starting_documents=2, factor=2,
                                      max_iterations=4)
    queries = pw.io.python.read(PromptFeed(), schema=pw.schema_from_types(prompt=str),
                                autocommit_duration_ms=None)
    answered = rag.answer_query(queries)
    out = queries.restrict(answered).select(prompt=queries.prompt, result=answered.result,
                                            docs=answered.context_docs)

    def on_chunk(key, row, time, is_addition):
        if is_addition:
            obs["chunks"] += 1
            if obs["chunks"] == VS_DOCS:
                ingest_done.set()

    def on_reply(key, row, time, is_addition):
        if is_addition:
            obs["replies"][row["prompt"]] = (row["result"], [d["text"] for d in row["docs"]])
            if len(obs["replies"]) == RAG_PROMPTS:
                obs["done"] = perf_counter()
                all_answered.set()

    pw.io.subscribe(store.chunks, on_change=on_chunk)
    pw.io.subscribe(out, on_change=on_reply)
    calls, generate = [], chat._fn

    def counted(batch):
        calls.append(len(batch))
        return generate(batch)

    chat._fn = counted  # what the UDF calls; the direct calls below take the method
    device_pipeline.PIPELINE.configure()
    fa.KERNEL.launches = 0
    t0 = time.perf_counter()
    try:
        pw.run()
    finally:
        chat._fn = generate
    run_s = time.perf_counter() - t0
    launches = fa.KERNEL.launches
    loop_threads = [t.name for t in threading.enumerate() if t.is_alive() and t.name == "pw-udf-loop"]
    stop_event_loop()
    rows, direct_s = [], 0.0
    for q in questions:
        reply, doc_texts = obs["replies"].get(q, (None, []))
        t1 = time.perf_counter()
        direct = chat.generate_batch([prompts.prompt_qa(q, doc_texts[:2])])[0]
        direct_s += time.perf_counter() - t1
        rows.append({"answered": reply is not None, "equal_direct": reply == direct,
                     "expanded": "no information found." in (direct or "").lower(),
                     "docs": len(doc_texts), "own_doc_first": bool(doc_texts) and doc_texts[0] == q,
                     "reply_words": len((reply or "").split())})
    card.emit("rag", model="Mistral-7B shape (the decode phase's weights) over the vector store "
                           f"({BGE}, {VS_DOCS} docs)",
              prompts=RAG_PROMPTS, answered=len(obs["replies"]), run_s=run_s,
              prompts_to_replies_s=(obs["done"] - obs["sent"]) if obs["done"] else None,
              direct_calls_one_after_another_s=direct_s,
              chat_calls=len(calls), chat_batch_sizes=calls, flash_launches=launches,
              udf_loop_threads_after_run=loop_threads, replies=rows, failures=obs["failures"])
    check(not obs["failures"], f"rag: {obs['failures']}")
    check(len(obs["replies"]) == RAG_PROMPTS, f"rag: {len(obs['replies'])} of {RAG_PROMPTS} answered")
    check(not any(r["expanded"] for r in rows), "rag: the seeded chat said it found nothing")
    check(all(r["equal_direct"] for r in rows), f"rag: replies differ from the direct calls: {rows}")
    check(calls == [1] * RAG_PROMPTS, f"rag: chat calls {calls}, one batch-1 call a prompt expected")
    check(not loop_threads, f"rag: event-loop threads alive after pw.run: {loop_threads}")
    check(launches > 0 and launches % embedder.config.layers == 0,
          f"rag: {launches} forward launches, not {embedder.config.layers} a call")
    return launches


RAG_EVAL_SAMPLES = 256
RAG_EVAL_CHAT_SAMPLES = 16


def _rag_eval_samples() -> list:
    """BASELINE config #5's harness on labelled samples made here: each question is a
    doc's own text, its answer that doc's first three words, its source the doc."""
    from pathway_tpu_torch.xpacks.llm import RagEvalSample

    corpus = [doc_text(i) for i in range(VS_DOCS)]
    picks = [(i * 89) % VS_DOCS for i in range(RAG_EVAL_SAMPLES)]  # 89 is prime to 3,000
    return [RagEvalSample(question=corpus[i], answer=" ".join(corpus[i].split()[:3]),
                          source=corpus[i]) for i in picks]


def _question_of(prompt: str) -> str:
    """The question of a ``prompts.prompt_qa`` prompt."""
    return prompt.rsplit("\nQuestion: ", 1)[1].rsplit("\nAnswer:", 1)[0]


def phase_rag_evals(card: Card, chat, embedder: EncoderEmbedder) -> int:
    """BASELINE config #5's ``rag_evals`` harness on the card: ``RagEvaluator`` over
    ``BaseRAGQuestionAnswerer(search_topk=2)`` and a ``DocumentStore`` over the vector
    store phase's BGE-base (full width, seeded) with the same 3,000 docs from a static
    table and a 4,096-slot index; one static run (``GraphRunner().capture``) each.
    Run A: 256 samples and an oracle chat, a host UDF keyed on the prompt's question; it
    must score exact match, token F1 and hit rate 1.0 with no sample missing. Run B: the
    decode phase's chat (the Mistral-7B shape) on the first 16 samples, its UDF handed
    one prompt a call; each answer must be the chat's direct batch-1 reply to
    ``prompts.prompt_qa`` of the same retrieved docs, the hit rate 1.0, none missing.
    Reports both reports, each run's wall seconds and the forward's launches (12 per
    embed call)."""
    from pathway_tpu_torch.internals.udfs.executors import BatchExecutor, stop_event_loop
    from pathway_tpu_torch.xpacks.llm import BaseRAGQuestionAnswerer, RagEvaluator, prompts

    class KeptRows(RagEvaluator):
        """Keeps the captured (prompt, result, context_docs) rows."""

        def _run(self, samples):
            self.rows = super()._run(samples)
            return self.rows

    phase_t0 = time.perf_counter()
    corpus = [doc_text(i) for i in range(VS_DOCS)]
    samples = _rag_eval_samples()
    answers = {s.question: s.answer for s in samples}

    @pw.udf
    def oracle(prompt: str) -> str:
        return answers.get(_question_of(prompt), "No information found.")

    def evaluator(llm, n: int):
        docs = pw.debug.table_from_rows(
            pw.schema_from_types(data=str, _metadata=dict),
            [(corpus[i], {"path": f"/d/{i}"}) for i in range(VS_DOCS)])
        store = DocumentStore(docs, embedder=embedder, index_capacity=VS_CAPACITY)
        return KeptRows(BaseRAGQuestionAnswerer(llm, store, search_topk=2)), samples[:n]

    device_pipeline.PIPELINE.configure()
    embed_calls, _sizes = _count_embed_calls(embedder)
    fa.KERNEL.launches = 0
    try:
        ev_a, samples_a = evaluator(oracle, RAG_EVAL_SAMPLES)
        t0 = time.perf_counter()
        report_a = ev_a.evaluate(samples_a)
        run_a_s = time.perf_counter() - t0
        calls_a, launches_a = embed_calls[0], fa.KERNEL.launches

        chat_calls, generate, executor = [], chat._fn, chat._executor

        def counted(batch):
            chat_calls.append(len(batch))
            return generate(batch)

        chat._fn, chat._executor = counted, BatchExecutor(max_batch_size=1)
        try:
            ev_b, samples_b = evaluator(chat, RAG_EVAL_CHAT_SAMPLES)
            t0 = time.perf_counter()
            report_b = ev_b.evaluate(samples_b)
            run_b_s = time.perf_counter() - t0
        finally:
            chat._fn, chat._executor = generate, executor
    finally:
        del embedder.embed_batch
    launches = fa.KERNEL.launches
    calls = embed_calls[0]
    loop_threads = [t.name for t in threading.enumerate() if t.is_alive() and t.name == "pw-udf-loop"]
    stop_event_loop()
    direct_equal, own_doc_first = [], []
    for prompt, result, docs in ev_b.rows:
        texts = [d["text"] for d in docs]
        direct_equal.append(result == chat.generate_batch([prompts.prompt_qa(prompt, texts)])[0])
        own_doc_first.append(bool(texts) and texts[0] == prompt)
    card.emit("rag_evals",
              store=f"{BGE} (hidden 768, 12 layers, bf16, seeded), {VS_DOCS} docs, "
                    f"{VS_CAPACITY}-slot index, search_topk=2",
              oracle_run={"samples": len(samples_a), "report": report_a.as_dict(), "run_s": run_a_s,
                          "embed_calls": calls_a, "flash_launches": launches_a},
              chat_run={"model": "Mistral-7B shape (the decode phase's weights)",
                        "samples": len(samples_b), "report": report_b.as_dict(), "run_s": run_b_s,
                        "embed_calls": calls - calls_a, "flash_launches": launches - launches_a,
                        "chat_calls": len(chat_calls), "chat_batch_sizes": sorted(set(chat_calls)),
                        "answers_equal_direct": sum(direct_equal),
                        "own_doc_first": sum(own_doc_first)},
              flash_launches=launches, embed_calls=calls, udf_loop_threads_after_run=loop_threads,
              phase_s=time.perf_counter() - phase_t0)
    a, b = report_a, report_b
    check(a.n_samples == RAG_EVAL_SAMPLES and a.n_missing == 0,
          f"rag_evals oracle run: {a.n_samples} samples, {a.n_missing} missing")
    check(a.answer_exact_match == a.answer_token_f1 == a.retrieval_hit_rate == 1.0,
          f"rag_evals oracle run: {a.as_dict()}")
    check(b.n_samples == RAG_EVAL_CHAT_SAMPLES and b.n_missing == 0 and b.retrieval_hit_rate == 1.0,
          f"rag_evals chat run: {b.as_dict()}")
    check(len(ev_b.rows) == RAG_EVAL_CHAT_SAMPLES and all(direct_equal),
          f"rag_evals chat run: answers equal to the direct calls {direct_equal}")
    check(chat_calls == [1] * RAG_EVAL_CHAT_SAMPLES, f"rag_evals chat calls {chat_calls}")
    check(not loop_threads, f"rag_evals: event-loop threads alive after the runs: {loop_threads}")
    check(launches > 0 and launches == embedder.config.layers * calls,
          f"rag_evals: {launches} forward launches for {calls} embed calls")
    return launches


N_OPS = 200_000  # rows of table_ops: device_ops_leg's size, as relational_engine
OPS_COMMITS = 20
OPS_DEDUP_INSTANCES = 4096
OPS_SORT_INSTANCES = 1024
OPS_GROUPS = 64
OPS_PICKS = 4096  # ids that having keeps
OPS_ASYNC_ROWS = 4096
OPS_FLOOR = 900  # seconds: dt.floor to 15 minutes
OPS_EPOCH = datetime.datetime(2024, 1, 1)


def _ops_rows() -> dict:
    """Seeded rows in bench_dataflow.py's manner: a primary-key row number, an int key, a float
    value (distinct multiples of 1/8, so every sum is exact in float64 in any order and
    every instance has one largest value), a word of mixed case and a timestamp (whole
    seconds around 2024-01-01)."""
    rng = np.random.default_rng(SEED + 11)
    return {
        "id": np.arange(N_OPS),
        "key": rng.integers(0, 1 << 20, N_OPS),
        "v": (rng.permutation(N_OPS) - N_OPS // 2) * 0.125,
        "word": [w.upper() if f else w for w, f in
                 zip((_WORDS[j] for j in rng.integers(0, len(_WORDS), N_OPS)),
                     rng.random(N_OPS) < 0.5)],
        "secs": rng.integers(-10**8, 10**8, N_OPS),
        "picks": rng.choice(N_OPS, OPS_PICKS, replace=False),
    }


def _ops_expected(rows: dict) -> dict:
    """The plain Python / NumPy answer of table_ops' program on ``rows``."""
    ids, keys, vals, words, secs = (rows[c] for c in ("id", "key", "v", "word", "secs"))
    sel = {}
    for i in range(N_OPS):
        s = int(secs[i])
        sel[i] = (int(keys[i]), words[i].lower(), len(words[i]),
                  (OPS_EPOCH + datetime.timedelta(seconds=s)).hour,
                  OPS_EPOCH + datetime.timedelta(seconds=s // OPS_FLOOR * OPS_FLOOR), abs(float(vals[i])))
    best: dict[int, int] = {}
    for i in range(N_OPS):
        inst = int(keys[i]) % OPS_DEDUP_INSTANCES
        if inst not in best or vals[i] > vals[best[inst]]:
            best[inst] = i
    dedup = {inst: int(ids[i]) for inst, i in best.items()}
    groups: dict[int, list] = {}
    for inst, i in best.items():
        g = groups.setdefault(int(keys[i]) % OPS_GROUPS, [0, 0.0])
        g[0] += 1
        g[1] += float(vals[i])
    order: dict[int, list] = {}
    for i in np.argsort(vals, kind="stable"):
        order.setdefault(int(keys[i]) % OPS_SORT_INSTANCES, []).append(int(i))
    neighbours = {}
    for members in order.values():
        for j, i in enumerate(members):
            neighbours[i] = (members[j - 1] if j else None,
                             members[j + 1] if j + 1 < len(members) else None)
    return {"sel": sel, "dedup": dedup, "groups": {g: tuple(x) for g, x in groups.items()},
            "sort": neighbours, "having": sorted(int(i) for i in rows["picks"])}


async def _ops_async_fn(v: float) -> float:
    return 3.0 * v + 1.0


def phase_table_ops(card: Card) -> int:
    """One streamed ``pw.run`` of 200,000 rows through ``pw.io.python`` in 20 commits of
    10,000 (the feed waits for each commit to reach the subscriber): one ``select`` of
    the expression namespaces (``.str.lower()``, ``.str.len()``, ``.dt.hour()``,
    ``.dt.floor(15 min)``, ``.num.abs()``), ``deduplicate(value=v, instance=key % 4096)``
    keeping the largest value, ``sort(key=v, instance=key % 1024)``, ``having`` over
    4,096 picked ids from a static table, and ``groupby(key % 64).reduce(count, sum)``
    over the deduplicated rows, whose commits the card's segment reduction takes; with
    a second stream of 4,096 rows through ``pw.apply_async`` and ``await_futures``.
    Every output's final state must equal a plain Python / NumPy computation of the same
    rows exactly. Reports rows/s, the commits and the segment kernels' launches."""
    import datetime

    from pathway_tpu_torch.internals.udfs.executors import stop_event_loop

    phase_t0 = time.perf_counter()
    rows = _ops_rows()
    t0 = time.perf_counter()
    want = _ops_expected(rows)
    plain_s = time.perf_counter() - t0
    n_batch = N_OPS // OPS_COMMITS
    seen = {"sel": 0}
    batch_seen = threading.Semaphore(0)
    failures: list = []

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for b in range(OPS_COMMITS):
                for i in range(b * n_batch, (b + 1) * n_batch):
                    self.next(rid=i, key=int(rows["key"][i]), v=float(rows["v"][i]),
                              word=rows["word"][i],
                              ts=OPS_EPOCH + datetime.timedelta(seconds=int(rows["secs"][i])))
                if not batch_seen.acquire(timeout=300.0):
                    failures.append(f"batch {b} did not reach the subscriber")
                    return

    class AsyncFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i in range(OPS_ASYNC_ROWS):
                self.next(rid=i, v=float(rows["v"][i]))

    schema = pw.schema_from_dict({
        "rid": pw.column_definition(dtype=int, primary_key=True),
        "key": int, "v": float, "word": str, "ts": datetime.datetime,
    })
    t = pw.io.python.read(Feed(), schema=schema, autocommit_duration_ms=100)
    sel = t.select(pw.this.rid, pw.this.key, low=pw.this.word.str.lower(), n=pw.this.word.str.len(),
                   hour=pw.this.ts.dt.hour(), q=pw.this.ts.dt.floor(datetime.timedelta(seconds=OPS_FLOOR)),
                   a=pw.this.v.num.abs())
    dedup = t.deduplicate(value=pw.this.v, instance=pw.this.key % OPS_DEDUP_INSTANCES,
                          acceptor=lambda new, old: new > old)
    groups = dedup.select(g=pw.this.key % OPS_GROUPS, v=pw.this.v).groupby(pw.this.g).reduce(
        pw.this.g, c=pw.reducers.count(), s=pw.reducers.sum(pw.this.v))
    srt = t.sort(key=pw.this.v, instance=pw.this.key % OPS_SORT_INSTANCES)
    picks = pw.debug.table_from_rows(pw.schema_from_types(r=int), [(int(r),) for r in rows["picks"]])
    kept = t.having(picks.select(p=t.pointer_from(picks.r)).p)
    a = pw.io.python.read(AsyncFeed(), schema=pw.schema_from_types(rid=int, v=float),
                          autocommit_duration_ms=100)
    awaited = a.select(pw.this.rid, w=pw.apply_async(_ops_async_fn, pw.this.v)).await_futures()

    states = {name: {} for name in ("sel", "dedup", "groups", "sort", "having", "async")}
    times: set = set()

    def sink(name: str):
        state = states[name]

        def on_change(key, row, time, is_addition):
            if is_addition:
                state[key] = row
            else:
                state.pop(key, None)
            if name == "sel":
                times.add(time)
                seen["sel"] += 1
                if seen["sel"] % n_batch == 0:
                    batch_seen.release()

        return on_change

    for name, table in (("sel", sel), ("dedup", dedup), ("groups", groups), ("sort", srt),
                        ("having", kept), ("async", awaited)):
        pw.io.subscribe(table, on_change=sink(name))
    device_ops.configure()
    device_ops.reset_counters()
    device_pipeline.PIPELINE.configure()
    _zero_segment_launches()
    with _KeptRunner() as keep:
        t0 = time.perf_counter()
        pw.run()
        run_s = time.perf_counter() - t0
    by_kernel = _segment_launches()
    launches = sum(by_kernel.values())
    loop_threads = [th.name for th in threading.enumerate() if th.is_alive() and th.name == "pw-udf-loop"]
    stop_event_loop()
    routes = {type(n).__name__ + f"#{n.index}": dict(n.routes) for n in keep.runners[0].scope.nodes
              if hasattr(n, "routes")}

    st = states
    got_sel = {r["rid"]: (r["key"], r["low"], r["n"], r["hour"], r["q"], r["a"]) for r in st["sel"].values()}
    id_of = {k: r["rid"] for k, r in st["sel"].items()}
    got_dedup = {r["key"] % OPS_DEDUP_INSTANCES: r["rid"] for r in st["dedup"].values()}
    got_groups = {r["g"]: (r["c"], r["s"]) for r in st["groups"].values()}
    got_sort = {id_of.get(k): (id_of.get(r["prev"]), id_of.get(r["next"])) for k, r in st["sort"].items()}
    got_having = sorted(r["rid"] for r in st["having"].values())
    got_async = {r["rid"]: r["w"] for r in st["async"].values()}
    want_async = {i: 3.0 * float(rows["v"][i]) + 1.0 for i in range(OPS_ASYNC_ROWS)}
    bits = lambda d: {k: tuple(np.float64(x).view(np.int64).item() if isinstance(x, float) else x  # noqa: E731
                               for x in (v if isinstance(v, tuple) else (v,))) for k, v in d.items()}
    same = {
        "sel": bits(got_sel) == bits(want["sel"]),
        "dedup": got_dedup == want["dedup"],
        "groups": bits(got_groups) == bits(want["groups"]),
        "sort": got_sort == want["sort"],
        "having": got_having == want["having"],
        "async": bits(got_async) == bits(want_async),
    }
    groupbys = [r for name, r in routes.items() if name.startswith("GroupbyNode")]
    card.emit("table_ops", rows=N_OPS, commits=len(times), async_rows=OPS_ASYNC_ROWS,
              dedup_instances=OPS_DEDUP_INSTANCES, sort_instances=OPS_SORT_INSTANCES,
              run_s=run_s, rows_per_s=N_OPS / run_s, plain_answer_s=plain_s,
              out_rows={name: len(s) for name, s in states.items()},
              equals_plain=same, segment_launches=by_kernel, groupby_routes=groupbys,
              hit_counts=device_ops.hit_counts(), udf_loop_threads_after_run=loop_threads,
              failures=failures, phase_s=time.perf_counter() - phase_t0)
    check(not failures, f"table_ops: {failures}")
    check(all(same.values()), f"table_ops: outputs differ from the plain computation: {same}")
    check(len(groupbys) == 1 and groupbys[0]["device"] > 0 and groupbys[0]["host"] == 0,
          f"table_ops groupby routes {groupbys}")
    check(launches > 0, f"table_ops launched no segment kernel: {by_kernel}")
    check(not loop_threads, f"table_ops: event-loop threads alive after pw.run: {loop_threads}")
    return launches


# -- the relational operators -----------------------------------------------------------

N_REL = 1_000_000  # bench_dataflow.py's N
N_RIGHT = 50_000  # its join_inner / join_multikey right side
N_ENGINE = 200_000  # its device_ops_leg's size
ENGINE_CHUNK = 25_000  # rows between the connector's pauses in relational_engine
N_DIM = 1024
INC_COMMITS, INC_DELTA = 100, 1000  # its incremental_update
# the segment reduction alone: (case, rows, groups, int64 columns, float64 columns,
# index). The float64 sums at groupby_sum's shape and at the two ends; the int64 diffs
# at groupby_sum's (+1/-1) and wordcount's (+1) shapes; groupby_sum's own commit (index
# i % 1,024, an int64 count and the float64 sum of float(i) in one call); one of
# incremental_update's 2,000-row commits (1,000 groups of a retraction and an insert, a
# count and a float sum); a skewed float64 case (Zipf s = 1.1 over 65,536 groups, drawn
# again past the last group: two partition passes and both run classes)
SEGMENT_CASES = (
    ("float64_1024", N_REL, 1024, 0, 1, "uniform"),
    ("float64_8", N_REL, 8, 0, 1, "uniform"),
    ("float64_1M", N_REL, N_REL, 0, 1, "uniform"),
    ("int64_1024", N_REL, 1024, 1, 0, "uniform"),
    ("int64_4096", N_REL, 4096, 1, 0, "uniform"),
    ("commit_1024", N_REL, 1024, 1, 1, "groupby_sum"),
    ("commit_2000", 2 * INC_DELTA, INC_DELTA, 1, 1, "incremental_update"),
    ("zipf_65536", N_REL, 65_536, 0, 1, "zipf"),
)
DADD_ITERS = 1 << 20  # the calibration chain of dependent float64 adds
# the segment entry points a relational path's shapes launch (run_ends only follows a
# second partition pass, past 2,048 groups in a commit with a float column)
SEGMENT_PATH_KERNELS = ("int_sum", "radix_pass", "fold_runs")
PROFILED_CALLS = 5  # segment_reduce calls in each case's profiler window


def _relational_rows() -> dict:
    """bench_dataflow.py's rows, keyed as it keys them (the port's ``ref_scalar``)."""
    keys = [pw.ref_scalar(i) for i in range(N_REL)]
    lkeys = [pw.ref_scalar(("l", i)) for i in range(N_REL // 2)]
    rkeys = [pw.ref_scalar(("r", i)) for i in range(N_RIGHT)]
    return {
        "groupby": [(k, (i % 1024, float(i))) for i, k in enumerate(keys)],
        "words": [(k, (f"w{i % 4096}",)) for i, k in enumerate(keys)],
        "join_l": [(k, (i % N_RIGHT, float(i))) for i, k in enumerate(lkeys)],
        "join_r": [(k, (i, f"name{i}")) for i, k in enumerate(rkeys)],
        "multi_l": [(k, (i % 250, (i // 250) % 200, float(i))) for i, k in enumerate(lkeys)],
        "multi_r": [(k, (i % 250, i // 250, f"name{i}")) for i, k in enumerate(rkeys)],
    }


def _final_state(node) -> tuple:
    """A node's output state for a bit-for-bit comparison: its columnar output
    batches stacked and sorted by key bytes (float columns as int64 bits), or its row
    state with floats as their bits where the output is not columnar."""
    lag = node._state_lag
    if not node._state and lag and all(b.columns is not None and b.columns.diffs is None for b in lag):
        cols = Columns.concat([b.columns for b in lag]) if len(lag) > 1 else lag[0].columns
        if cols is not None:
            kb = np.ascontiguousarray(cols.kbytes())
            order = np.lexsort(kb.T[::-1])
            arrays = [c[order].view(np.int64) if c.dtype == np.float64 else c[order] for c in cols.cols]
            return "columns", kb[order], arrays
    bits = lambda v: np.float64(v).view(np.int64).item() if isinstance(v, float) else v  # noqa: E731
    return "rows", {int(k): tuple(map(bits, row)) for k, row in node.current.items()}


def _same_state(a: tuple, b: tuple) -> bool:
    if a[0] != b[0]:
        return False
    if a[0] == "rows":
        return a[1] == b[1]
    return np.array_equal(a[1], b[1]) and len(a[2]) == len(b[2]) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a[2], b[2])
    )


def _groupby_prepared(rows, reducers, n_in):
    """A groupby over an input session holding ``rows``, before its commit."""
    scope = Scope()
    sess = scope.input_session(n_in)
    node = scope.group_by_table(sess, by_cols=[0], reducers=reducers)
    sched = Scheduler(scope)
    for key, row in rows:
        sess.insert(key, row)
    return sched, node


def _groupby_once(rows, reducers, n_in):
    sched, node = _groupby_prepared(rows, reducers, n_in)
    t0 = time.perf_counter()
    sched.commit()
    return time.perf_counter() - t0, node


def _sum_count():
    return [(make_reducer(ReducerKind.SUM), [1]), (make_reducer(ReducerKind.COUNT), [])]


def _workload(name: str, rows: dict):
    """-> (rows the timed part moves, run() -> (seconds, output node))."""
    if name == "groupby_sum":
        return N_REL, lambda: _groupby_once(rows["groupby"], _sum_count(), 2)
    if name == "wordcount":
        return N_REL, lambda: _groupby_once(rows["words"], [(make_reducer(ReducerKind.COUNT), [])], 1)
    if name in ("join_inner", "join_multikey"):
        side = "join" if name == "join_inner" else "multi"
        nk = 1 if name == "join_inner" else 2

        def run():
            scope = Scope()
            left, right = scope.input_session(nk + 1), scope.input_session(nk + 1)
            node = scope.join_tables(left, right, list(range(nk)), list(range(nk)), kind="inner")
            sched = Scheduler(scope)
            for key, row in rows[f"{side}_l"]:
                left.insert(key, row)
            for key, row in rows[f"{side}_r"]:
                right.insert(key, row)
            t0 = time.perf_counter()
            sched.commit()
            return time.perf_counter() - t0, node

        return N_REL // 2 + N_RIGHT, run
    if name == "incremental_update":

        def run():
            scope = Scope()
            sess = scope.input_session(2)
            node = scope.group_by_table(sess, by_cols=[0], reducers=[(make_reducer(ReducerKind.SUM), [1])])
            sched = Scheduler(scope)
            data = rows["groupby"]
            for key, row in data:
                sess.insert(key, row)
            sched.commit()
            t = 0.0
            for c in range(INC_COMMITS):
                base = (c * INC_DELTA) % (N_REL - INC_DELTA)
                for i in range(base, base + INC_DELTA):
                    key, row = data[i]
                    sess.remove(key, row)
                    sess.insert(key, (row[0], row[1] + 1.0))
                t0 = time.perf_counter()
                sched.commit()
                t += time.perf_counter() - t0
            return t, node

        return INC_COMMITS * 2 * INC_DELTA, run
    raise KeyError(name)


def _with_device_ops(flag: str, fn):
    prev = os.environ.get("PATHWAY_TPU_DEVICE_OPS")
    os.environ["PATHWAY_TPU_DEVICE_OPS"] = flag
    try:
        return fn()
    finally:
        if prev is None:
            os.environ.pop("PATHWAY_TPU_DEVICE_OPS")
        else:
            os.environ["PATHWAY_TPU_DEVICE_OPS"] = prev


def _segment_bound_ms(n: int, groups: int, cols: int) -> float:
    """The byte bound of ``segment_reduce``: the group index read once (8 bytes a row),
    every weight column read once (8 bytes a row) and every sum written once (8 bytes a
    group)."""
    return (8 * n + 8 * n * cols + 8 * groups * cols) / HBM_BYTES_PER_S * 1e3


def _segment_launches() -> dict[str, int]:
    return {name: k.launches for name, k in sr.KERNELS.items()}


def _zero_segment_launches() -> None:
    for k in sr.KERNELS.values():
        k.launches = 0


def phase_relational(card: Card) -> dict:
    """bench_dataflow.py's workloads through the port's Scope and Scheduler, once on
    the host kernels (``PATHWAY_TPU_DEVICE_OPS=0``, the spec) and once on the card
    after a warm-up; the card's output state must be the host's bit for bit, and every
    batch must have taken the device route. Then the segment reduction alone against
    its plain version and ``index_add_``, the whole dispatch, and the matcher alone
    against the host matcher."""
    device_ops.configure()
    t0 = time.perf_counter()
    rows = _relational_rows()
    card.emit("relational_rows", seconds=time.perf_counter() - t0, rows=N_REL)
    launches = dict.fromkeys(sr.KERNELS, 0)  # the timed card runs' launches only
    for name in ("groupby_sum", "wordcount", "join_inner", "join_multikey", "incremental_update"):
        n, run = _workload(name, rows)
        host_s, host_node = _with_device_ops("0", run)
        host_state = _final_state(host_node)
        check(host_node.routes["device"] == 0, f"{name}: host run took the card")
        del host_node
        _with_device_ops("1", run)  # warm-up
        device_ops.reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_segment_launches()
        dev_s, dev_node = _with_device_ops("1", run)
        run_launches = _segment_launches()
        for k, v in run_launches.items():
            launches[k] += v
        peak = torch.cuda.max_memory_allocated()
        stats = device_ops.stats()
        routes = dict(dev_node.routes)
        same = _same_state(host_state, _final_state(dev_node))
        card.emit("relational", workload=name, rows=n, host_rows_per_s=n / host_s,
                  device_rows_per_s=n / dev_s, host_s=host_s, device_s=dev_s, routes=routes,
                  segment_launches=run_launches, hit_counts=stats["hit_counts"],
                  kernel_ns=stats["kernel_ns"], peak_device_mib=peak / 2**20,
                  bit_identical=same)
        check(same, f"{name}: the card's output state differs from the host spec")
        check(routes["device"] > 0 and routes["host"] == 0 and routes["rows"] == 0,
              f"{name}: routes {routes}")
        if name in ("groupby_sum", "incremental_update"):  # a count and a float sum
            check(all(run_launches[k] > 0 for k in SEGMENT_PATH_KERNELS),
                  f"{name}: segment launches {run_launches}")
        elif name == "wordcount":  # the count alone: the int path, no partition
            check(run_launches["int_sum"] > 0 and sum(run_launches.values()) == run_launches["int_sum"],
                  f"{name}: segment launches {run_launches}")
        del dev_node
    check(all(launches[k] > 0 for k in SEGMENT_PATH_KERNELS),
          f"the relational path left a segment kernel unlaunched: {launches}")

    profile_groupby(card, rows)
    del rows
    gc.collect()
    kernel = segment_kernel_parity_and_time(card)
    matcher_alone(card)
    return {**kernel, "launches": sum(launches.values()), "launches_by_kernel": launches}


def profile_groupby(card: Card, rows: dict) -> None:
    """One device groupby_sum commit of 1M rows under the profiler: where the time
    goes between the host, the upload and the segment kernels."""
    sched, _node = _groupby_prepared(rows["groupby"], _sum_count(), 2)
    wall_ms, kernels, _ops = _profiled(lambda: _with_device_ops("1", sched.commit))
    busy = sum(ms for ms, _k, _c in kernels)
    card.emit("relational_profile", workload="groupby_sum", rows=N_REL, wall_ms=wall_ms,
              device_busy_ms=busy, idle_share=1 - busy / wall_ms,
              device_ms_by_kernel=[[k, ms, c] for ms, k, c in kernels[:12]])


def _segment_case(n: int, groups: int, ni: int, nf: int, index: str, gen):
    """-> (inverse, int64 [ni, n], float64 [nf, n]) on the host."""
    if index == "groupby_sum":  # bench_dataflow.py's rows: i % 1024, float(i), a +1 count
        inverse = np.arange(n, dtype=np.int64) % groups
        return inverse, np.ones((ni, n), np.int64), np.arange(n, dtype=np.float64)[None].repeat(nf, 0)
    if index == "incremental_update":  # its commit: each row retracted, then inserted + 1.0
        inverse = np.tile(np.arange(groups, dtype=np.int64), 2)
        diffs = np.repeat(np.array([-1, 1], np.int64), groups)[None].repeat(ni, 0)
        vals = np.arange(groups, dtype=np.float64)
        return inverse, diffs, (np.concatenate([vals, vals + 1.0]) * diffs[0])[None].repeat(nf, 0)
    if index == "zipf":
        inverse = _zipf_index(gen, n, groups, 1.1)
    else:
        inverse = gen.integers(0, groups, n)
    w_float = gen.standard_normal((nf, n)) * 10.0 ** gen.integers(-6, 7, (nf, n))
    # diffs: the +1/-1 of a retracting commit, or wordcount's +1s
    w_int = gen.choice(np.array([-1, 1], np.int64), (ni, n)) if groups == 1024 else np.ones((ni, n), np.int64)
    return inverse, w_int, w_float


def _zipf_index(gen, n: int, groups: int, s: float) -> np.ndarray:
    """Zipf(s) over ``[0, groups)``: a draw past the last group is drawn again, so group
    0 keeps its own share of the rows."""
    inverse = gen.zipf(s, n) - 1
    out = inverse >= groups
    while out.any():
        inverse[out] = gen.zipf(s, int(out.sum())) - 1
        out = inverse >= groups
    return inverse.astype(np.int64)


def _kernel_name(key: str) -> str:
    """A profiler key's function name with its template arguments, without the
    namespace and the parameter list."""
    m = re.search(r"(\w+(?:<[^()]*>)?)\(", key)
    return m.group(1) if m else key[:48]


def _once_ms(fn):
    """(fn's result, its card time in ms), one call between CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def segment_kernel_parity_and_time(card: Card) -> dict:
    """``segment_reduce`` alone at each of ``SEGMENT_CASES``: bit for bit against its
    plain version on the card and against ``np.add.at`` / ``np.bincount``; its whole
    card time (the int path, the partition passes, the fold, every column of the call)
    against its byte bound and the chain floor (the longest run times ``t_dadd``, the
    latency of a dependent float64 add measured here); ``index_add_`` per column (timed
    only, on CUDA events and on the profiler's busy time as the kernel is: for int64 the
    same function, for float64 a yardstick in another order); and the whole dispatch on
    the host clock."""
    gen = np.random.default_rng(SEED)
    x = torch.tensor([0.0, 1.0], dtype=torch.float64).cuda()
    chain = sr.dadd_chain(x, DADD_ITERS)
    torch.cuda.synchronize()
    check(chain.item() == float(DADD_ITERS), f"dadd_chain gave {chain.item()}")
    t_dadd_ns = cuda_ms(lambda: sr.dadd_chain(x, DADD_ITERS), iters=3, warmup=1) * 1e6 / DADD_ITERS
    card.emit("dadd_latency", iters=DADD_ITERS, t_dadd_ns=t_dadd_ns)
    out: dict = {}
    worst = 0.0
    for case, n, groups, ni, nf, index in SEGMENT_CASES:
        inverse, w_int, w_float = _segment_case(n, groups, ni, nf, index, gen)
        host = np.zeros((ni + nf, groups), np.int64)
        for c in range(ni):
            np.add.at(host[c], inverse, w_int[c])
        for c in range(nf):
            host[ni + c] = np.bincount(inverse, weights=w_float[c], minlength=groups).view(np.int64)
        args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (inverse, w_int, w_float)]
        before = _segment_launches()
        got = sr.segment_reduce(*args, groups)
        torch.cuda.synchronize()
        stages = {k: v - before[k] for k, v in _segment_launches().items()}
        plain, plain_ms = _once_ms(lambda: sr.segment_reduce_reference(*args, groups))
        got_h, plain_h = got.cpu().numpy(), plain.cpu().numpy()
        bits_plain = np.array_equal(got_h, plain_h)
        bits_host = np.array_equal(got_h, host)
        as_values = lambda a: np.concatenate([a[:ni].astype(np.float64).ravel(), a[ni:].view(np.float64).ravel()])  # noqa: E731
        with np.errstate(invalid="ignore"):
            err = float(np.nan_to_num(np.abs(as_values(got_h) - as_values(plain_h))).max())
        worst = max(worst, err)
        ms = cuda_ms(lambda: sr.segment_reduce(*args, groups), iters=20, warmup=2)
        # the card's own time by kernel (CUDA events above read the host's pace where
        # it enqueues more slowly than the card runs), and the host's time to enqueue
        _wall, kernels, _ops = _profiled(
            lambda: [sr.segment_reduce(*args, groups) for _ in range(PROFILED_CALLS)])
        device_busy_ms = sum(k_ms for k_ms, _k, _c in kernels) / PROFILED_CALLS
        by_kernel = [[_kernel_name(k), k_ms / PROFILED_CALLS, c // PROFILED_CALLS]
                     for k_ms, k, c in kernels]
        t0 = time.perf_counter()
        for _ in range(20):
            sr.segment_reduce(*args, groups)
        host_enqueue_ms = 1e3 * (time.perf_counter() - t0) / 20
        torch.cuda.synchronize()
        inv_d = args[0]
        columns = [*args[1], *args[2]]
        def library():
            return [torch.zeros(groups, dtype=w.dtype, device=w.device).index_add_(0, inv_d, w)
                    for w in columns]

        library_ms = cuda_ms(library, iters=20, warmup=2)
        _wall, lib_kernels, _ops = _profiled(lambda: [library() for _ in range(PROFILED_CALLS)])
        library_busy_ms = sum(k_ms for k_ms, _k, _c in lib_kernels) / PROFILED_CALLS
        longest = int(np.bincount(inverse, minlength=groups).max())
        chain_floor_ms = longest * t_dadd_ns * 1e-6 if nf else None
        bound_ms = _segment_bound_ms(n, groups, ni + nf)
        row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
               "library_ms": library_ms, "library_busy_ms": library_busy_ms,
               "roofline_share": bound_ms / ms,
               "device_busy_ms": device_busy_ms, "busy_roofline_share": bound_ms / device_busy_ms,
               "host_enqueue_ms": host_enqueue_ms, "device_ms_by_kernel": by_kernel,
               "chain_floor_ms": chain_floor_ms, "longest_run": longest,
               "passes": len(sr.radix_passes(groups)) if nf else 0, "stage_launches": stages}
        if nf == 0:
            check(sum(stages.values()) == stages["int_sum"] == 1, f"{case}: int-only launches {stages}")
        diffs = w_int[0] if ni else np.ones(n, np.int64)
        vals = [*w_int[1:], *w_float]
        device_ops.segment_reduce_dispatch(inverse, diffs, vals, groups).fetch()  # warm
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            device_ops.segment_reduce_dispatch(inverse, diffs, vals, groups).fetch()
        row["dispatch_ms"] = 1e3 * (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        hd.segment_count(inverse, diffs, groups)
        for col in vals:
            hd.segment_sum(inverse, col, diffs, groups)
        row["host_spec_ms"] = 1e3 * (time.perf_counter() - t0)
        card.emit("segment_kernel", case=case, rows=n, groups=groups, int_columns=ni,
                  float_columns=nf, index=index, max_abs_err=err, tol=0.0,
                  bits_equal_plain=bits_plain, bits_equal_host=bits_host,
                  host="np.add.at + np.bincount", library="index_add_ per column",
                  t_dadd_ns=t_dadd_ns, **row)
        check(bits_plain and bits_host, f"segment_reduce {case}: bits differ")
        out[case] = row
        del args, got, plain, inv_d, columns
    main = out["commit_1024"]
    return {
        "name": "segment_reduce",
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/segment_reduce.cu",
        "replaces": "pathway_tpu/engine/device_ops.py:213",
        "max_abs_err": worst,
        **main,
        "t_dadd_ns": t_dadd_ns,
        "shapes": out,
    }


def matcher_alone(card: Card) -> None:
    """The device pair matcher at the join_inner shape against the host matcher: the
    whole call on the host clock (uploads and fetch included), and its on-card part
    (``_pairs_on_card`` over codes already on the card, one wait for the pair count
    included) between CUDA events, against its byte bound (la and ra read once, the
    pairs written once). No single PyTorch call computes the pair list."""
    la = np.arange(N_REL // 2, dtype=np.int64) % N_RIGHT
    ra = np.arange(N_RIGHT, dtype=np.int64)
    device_ops.match_pairs([la], [ra])  # warm
    t0 = time.perf_counter()
    got = device_ops.match_pairs([la], [ra])
    dev_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ref = _match_join_pairs(la, ra)
    host_ms = 1e3 * (time.perf_counter() - t0)
    same = np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    la_d, ra_d = torch.from_numpy(la).cuda(), torch.from_numpy(ra).cuda()
    card_ms = cuda_ms(lambda: device_ops._pairs_on_card(la_d, ra_d), iters=10, warmup=2)
    pairs = len(ref[0])
    bound_ms = (8 * (len(la) + len(ra)) + 16 * pairs) / HBM_BYTES_PER_S * 1e3
    card.emit("matcher", left=len(la), right=len(ra), pairs=pairs, device_ms=dev_ms,
              card_ms=card_ms, bound_ms=bound_ms, bound_by="bytes", roofline_share=bound_ms / card_ms,
              library_ms=None, host_ms=host_ms, pairs_equal=same)
    check(same, "device matcher pairs differ from the host matcher's")


class _KeptRunner:
    """Keeps the GraphRunner of the next ``pw.run``, to read its nodes' routes."""

    def __enter__(self):
        self.runners = []
        self._run = GraphRunner.run
        kept = self.runners

        def run(runner):
            kept.append(runner)
            return self._run(runner)

        GraphRunner.run = run
        return self

    def __exit__(self, *exc):
        GraphRunner.run = self._run


def phase_relational_engine(card: Card) -> int:
    """One ``pw.run`` program through the Table API at device_ops_leg's size: a python
    connector (200,000 rows) into a groupby (sum and count), a left join with a
    1,024-row dimension table from ``pw.debug.table_from_rows``, a filter, and a
    concat_reindex with a second stream (50,000 rows) joined inner to the same
    dimension table; the subscriber's final state must equal a NumPy computation of
    the same answer, and the groupby must have reduced more than one commit on the
    card. The values are multiples of 1/8 well inside float64's exact range,
    so every sum is exact and the answer does not depend on how the stream splits into
    commits."""

    class Feed(pw.io.python.ConnectorSubject):
        def __init__(self, keys, vals) -> None:
            super().__init__()
            self.keys, self.vals = keys, vals

        def run(self) -> None:
            # a pause every 25,000 rows lets the 50 ms autocommit cut the stream into
            # commits, so the groupby's later commits carry retractions
            for i, (k, v) in enumerate(zip(self.keys, self.vals)):
                self.next(k=k, v=v)
                if i % ENGINE_CHUNK == ENGINE_CHUNK - 1:
                    time.sleep(0.2)

    rng = np.random.default_rng(SEED)
    a_k = rng.integers(0, N_DIM + 64, N_ENGINE)  # 64 groups with no dimension row
    a_v = rng.integers(-4000, 4000, N_ENGINE) * 0.125
    b_k = rng.integers(0, N_DIM + 64, N_ENGINE // 4)
    b_v = rng.integers(-4000, 4000, N_ENGINE // 4) * 0.125
    min_count = int(np.median(np.bincount(a_k)))
    schema = pw.schema_from_types(k=int, v=float)
    a = pw.io.python.read(Feed(a_k.tolist(), a_v.tolist()), schema=schema, autocommit_duration_ms=50)
    b = pw.io.python.read(Feed(b_k.tolist(), b_v.tolist()), schema=schema, autocommit_duration_ms=50)
    dim = pw.debug.table_from_rows(pw.schema_from_types(k=int, name=str),
                                   [(i, f"d{i}") for i in range(N_DIM)])
    g = a.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v), c=pw.reducers.count())
    j = g.join_left(dim, pw.left.k == pw.right.k).select(pw.left.k, pw.left.s, pw.left.c,
                                                         name=pw.right.name)
    f = j.filter(pw.this.c >= min_count)
    bj = b.join_inner(dim, pw.left.k == pw.right.k).select(pw.left.k, s=pw.left.v, c=1,
                                                           name=pw.right.name)
    out = f.concat_reindex(bj)
    state: dict = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            state[key] = (row["k"], row["s"], row["c"], row["name"])
        else:
            state.pop(key, None)

    pw.io.subscribe(out, on_change=on_change)
    device_ops.configure()
    device_ops.reset_counters()
    _zero_segment_launches()
    torch.cuda.reset_peak_memory_stats()
    with _KeptRunner() as kept:
        t0 = time.perf_counter()
        pw.run()
        run_s = time.perf_counter() - t0
    by_kernel = _segment_launches()
    launches = sum(by_kernel.values())
    nodes = kept.runners[0].scope.nodes
    routes = {type(n).__name__ + f"#{n.index}": dict(n.routes) for n in nodes if hasattr(n, "routes")}

    counts = np.bincount(a_k, minlength=N_DIM + 64)
    sums = np.bincount(a_k, weights=a_v, minlength=N_DIM + 64)
    want = [
        (k, float(sums[k]), int(counts[k]), f"d{k}" if k < N_DIM else None)
        for k in range(N_DIM + 64) if counts[k] >= min_count
    ] + [(int(k), float(v), 1, f"d{k}") for k, v in zip(b_k, b_v) if k < N_DIM]
    bits = lambda r: (r[0], np.float64(r[1]).view(np.int64).item(), r[2], r[3])  # noqa: E731
    same = sorted(map(bits, state.values()), key=repr) == sorted(map(bits, want), key=repr)
    card.emit("relational_engine", rows=N_ENGINE, second_stream=N_ENGINE // 4, dim_rows=N_DIM,
              out_rows=len(state), expected_rows=len(want), rows_per_s=(N_ENGINE * 5 // 4) / run_s,
              run_s=run_s, routes=routes, segment_launches=by_kernel,
              hit_counts=device_ops.hit_counts(), peak_device_mib=torch.cuda.max_memory_allocated() / 2**20,
              equals_numpy=same)
    check(same, "relational_engine: the subscriber's state differs from NumPy's answer")
    groupbys = [r for name, r in routes.items() if name.startswith("GroupbyNode")]
    joins = [r for name, r in routes.items() if name.startswith("JoinNode")]
    check(len(groupbys) == 1 and groupbys[0]["device"] > 1 and groupbys[0]["host"] == 0
          and groupbys[0]["rows"] == 0, f"groupby routes {groupbys}")
    # the inner join's matcher took the card; the left join takes the row path, as it
    # does in the JAX package (its columnar path is inner-only)
    check(any(r["device"] > 0 for r in joins) and all(r["host"] == 0 for r in joins),
          f"join routes {joins}")
    check(all(by_kernel[k] > 0 for k in SEGMENT_PATH_KERNELS),
          f"relational_engine left a segment kernel unlaunched: {by_kernel}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = Card()
    card.emit("device", name=card.name, count=card.count, torch=torch.__version__,
              cuda=torch.version.cuda)
    phase_build(card)
    sass = phase_sass(card)
    fwd = phase_kernel(card)
    bwd = phase_train_kernel(card)
    phase_checkpoint(card)
    relational = phase_relational(card)
    relational_engine = phase_relational_engine(card)
    serving = phase_main_path(card)
    engine, parity = phase_engine_pipeline(card, serving["docs_per_s"])
    train = phase_train(card)
    image_embedder = ImageEmbedder("vit-b16", max_batch_size=IMAGE_BATCH, seed=SEED)
    vision = phase_vision_parity(card, image_embedder)
    multimodal = phase_multimodal_pipeline(card, image_embedder)
    del image_embedder
    rerank = phase_rerank(card)
    chat = phase_decode(card)
    phase_chat_engine(card, chat)
    bge, vector_store = phase_vector_store(card)
    rag = phase_rag(card, chat, bge)
    rag_evals = phase_rag_evals(card, chat, bge)
    del chat, bge
    table_ops = phase_table_ops(card)
    fwd["launches"] = serving["launches"]
    fwd["launches_by_path"] = {"serving": serving["launches"], "engine": engine,
                               "engine_async_parity": parity,
                               "train": train[fwd["name"]], "vision": vision,
                               "multimodal": multimodal, "rerank": rerank,
                               "vector_store": vector_store, "rag": rag,
                               "rag_evals": rag_evals}
    for row in bwd:
        row["launches"] = train[row["name"]]
        row["launches_by_path"] = {"train": train[row["name"]]}
    for row in (fwd, *bwd):
        row["tensor_core_instructions"] = sass[row["name"]]
    relational["launches_by_path"] = {"relational": relational["launches"],
                                      "relational_engine": relational_engine,
                                      "table_ops": table_ops}
    print(json.dumps({"kernels": [fwd, *bwd, relational]}), flush=True)
    print(card.smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card.name, "count": card.count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
