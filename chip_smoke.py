#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two device paths once, on one card: the streaming-RAG
serving path and the contrastive trainer.

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
   tile, multi-tile t, no mask, a fully masked row) and the tile-skipping patterns
   (real keys only in the last 16-key tile or past position 128, live and masked tiles
   in turn, a dead sequence among live ones); then its time at the serving and the
   train shape against its bound, the plain version and
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
6. main_path: MiniLM-L6 at full width (seeded weights) embeds 20,000 generated docs in
   256-doc commits into a 1,048,576-slot f32 index on the card, 980,000 seeded unit
   vectors are bulk-added so 1,000,000 rows are live, and 64 queries are embedded and
   searched one per commit. Reports docs/s, query p50/p95, peak memory and the kernels'
   launches (the forward's must be 6 per embed call, the backward's 0). Checks that every key's slot holds its
   input vector bit for bit, and recall@10 against exact f32 search in a host index
   built from the same inputs through its own ``add``; then one 256-doc batch through
   the kernel against the plain attention (cosine, beside the readings of two broken
   attentions), and profiler windows over a few more ingest commits and queries:
   device time by kernel and the device's idle share.
7. train: ``make_train_step(minilm_l6())`` at full width (seeded weights) takes 20 AdamW
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
8. The kernels line, the ``nvidia-smi`` line, and last ``{"ok": true, ...}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from pathway_tpu_torch import _build
from pathway_tpu_torch.engine import DeviceKnnIndex, HostKnnIndex
from pathway_tpu_torch.models import (
    ContrastiveBatch,
    Encoder,
    embed,
    info_nce_loss,
    load_sentence_transformer,
    make_train_step,
    minilm_l6,
)
from pathway_tpu_torch.ops import flash_attention as fa
from pathway_tpu_torch.xpacks.llm import EncoderEmbedder
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

    # the serving shape (one embed call of 256 docs) and the train shape (one embed call
    # of the trainer's 1,024 sequences)
    times = {}
    for path, b in (("serving", CHUNK), ("train", TRAIN_PAIRS)):
        t, h, d = SEQ_LEN, 12, DIM // 12
        q, k, v, bias = attn_inputs(b, t, h, d, torch.bfloat16, gen, masked="ragged")
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, bias), iters=200)
        plain_ms = cuda_ms(lambda: fa.flash_attention_fwd_reference(q, k, v, bias), iters=10, warmup=2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        add_mask = bias[:, None, None, :].to(torch.bfloat16)
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
                  real_keys_per_seq=float((bias == 0).sum()) / b, dense_bound_ms=dense_bound_ms,
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
    return launches


def phase_embed_parity(card: Card, embedder: EncoderEmbedder, corpus) -> None:
    """One 256-doc batch through the kernel against the same encoder on the plain
    attention, on the card (min cosine over the batch). To show what the bar can see,
    the same reading with two deliberately broken attentions: the mask ignored, and
    uniform weights over the real keys (q.k ignored). With seeded N(0, 0.02) weights
    the attention's scores are small, so the second fault passes the bar: this check
    guards the mask and the sum over v (an ignored mask must fall below the bar, or
    the script fails), and the kernel-level parity guards the scores."""
    def plain(q, k, v, mask):
        return fa.flash_attention_fwd_reference(q, k, v, None if mask is None else fa.mask_bias(mask))[0]

    def mask_ignored(q, k, v, mask):
        return fa.flash_attention_fwd_reference(q, k, v, None)[0]

    def uniform(q, k, v, mask):
        return plain(torch.zeros_like(q), k, v, mask)

    ids, mask, real = embedder.tokenize(corpus[:CHUNK])
    ref = embed(embedder.encoder, ids, mask, attn_fn=plain)[:real]

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
    serving = phase_main_path(card)
    train = phase_train(card)
    fwd["launches"] = serving
    fwd["launches_by_path"] = {"serving": serving, "train": train[fwd["name"]]}
    for row in bwd:
        row["launches"] = train[row["name"]]
        row["launches_by_path"] = {"train": train[row["name"]]}
    for row in (fwd, *bwd):
        row["tensor_core_instructions"] = sass[row["name"]]
    print(json.dumps({"kernels": [fwd, *bwd]}), flush=True)
    print(card.smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card.name, "count": card.count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
