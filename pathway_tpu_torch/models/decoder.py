"""Causal decoder LM in PyTorch: RoPE + RMSNorm + SwiGLU + GQA, the local chat's model.

Counterpart of ``pathway_tpu/models/decoder.py``: the same configs (``mistral_7b``,
``tiny_decoder``) and the same arithmetic, which is the spec:

- RMSNorm in f32, cast back; rotary embedding on split halves (not interleaved pairs),
  in f32, cast back, at rotary positions ``max(slot - pos_offset, 0)``;
- GQA attention with the head order ``q.reshape(b, t, kv_heads, g, d)``, f32 scores
  over sqrt(d), a causal mask on cache *slots* combined with the slots' validity,
  masked scores filled with -1e30;
- SwiGLU with its SiLU evaluated op by op (``_silu``), as XLA evaluates it;
- compute in ``cfg.dtype`` (bf16 by default), logits in f32.

``Decoder`` is an ``nn.Module`` whose parameter names follow the JAX param pytree
(``tok_emb``, ``final_norm``, ``lm_head``, ``layers.0.q_w``, ...), so
``params_from_jax`` carries JAX weights over. It holds the matmul weights and
``tok_emb`` in the compute dtype and the norm scales in f32: the JAX forward casts
each weight to the compute dtype at its use, so one cast at load gives the same
numbers.

The KV cache keeps a static shape ``[b, max_len, kv_heads, d]`` per layer and is
written in place (``index_copy_`` at slot indices held as a tensor), where the JAX
version returns new arrays; ``decoder_forward`` still returns ``(logits, cache)``. The
decode step's shapes and positions are tensors of fixed shape, so a step can later be
captured as a CUDA graph. Attention, rope, RMSNorm and SwiGLU are torch ops, as the
JAX package leaves them to XLA outside any Pallas kernel.

Sampling cannot reproduce JAX's ``fold_in`` stream, so the port's sampled tokens differ
from the JAX package's. What it keeps is the property the per-row keys give: each row
draws from its own ``torch.Generator`` seeded from its 32-bit seed and the step, so a
row's tokens depend on nothing else in the batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.models.transformer import _param
from pathway_tpu_torch.ops.flash_attention import NEG_INF


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8
    intermediate: int = 14336
    max_len: int = 8192
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


def mistral_7b() -> DecoderConfig:
    return DecoderConfig()


def tiny_decoder(vocab_size: int = 512) -> DecoderConfig:
    """Small config for tests and dry runs."""
    return DecoderConfig(
        vocab_size=vocab_size, hidden=64, layers=2, heads=4, kv_heads=2,
        intermediate=128, max_len=128,
    )


def _weight(shape, dtype, device) -> nn.Parameter:
    return _param(shape, dtype, device, False)


def _ones(dim, device) -> nn.Parameter:
    return _param((dim,), torch.float32, device, False, 1.0)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, device) -> None:
        super().__init__()
        hid, dt = cfg.hidden, cfg.dtype
        hd, kvd = cfg.heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
        self.q_w = _weight((hid, hd), dt, device)
        self.kv_w = _weight((hid, 2 * kvd), dt, device)
        self.o_w = _weight((hd, hid), dt, device)
        self.attn_norm = _ones(hid, device)
        self.gate_w = _weight((hid, 2 * cfg.intermediate), dt, device)
        self.down_w = _weight((cfg.intermediate, hid), dt, device)
        self.mlp_norm = _ones(hid, device)


class Decoder(nn.Module):
    """Mistral-style decoder, for serving (no gradients). Weights are seeded random
    unless loaded (``load_state_dict``, e.g. of ``params_from_jax``)."""

    def __init__(
        self,
        cfg: DecoderConfig,
        *,
        device: "str | torch.device | None" = None,
        seed: int | None = 0,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.tok_emb = _weight((cfg.vocab_size, cfg.hidden), cfg.dtype, device)
        self.final_norm = _ones(cfg.hidden, device)
        self.lm_head = _weight((cfg.hidden, cfg.vocab_size), cfg.dtype, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device) for _ in range(cfg.layers))
        if seed is not None:
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Seeded random init with the JAX package's scheme: ``tok_emb`` N(0, 0.02),
        each matrix N(0, 1/fan_in), norm scales 1. Each tensor is drawn in f32 on its
        device and cast at once, so the f32 peak is one tensor, not the model. (The
        numbers differ from JAX's: the two generators differ.)"""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if p.dim() != 2:
                continue
            scale = 0.02 if name == "tok_emb" else 1.0 / math.sqrt(p.shape[0])
            noise = torch.randn(p.shape, generator=gen, device=p.device, dtype=torch.float32)
            p.copy_(noise.mul_(scale))
            del noise


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    out = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (out * scale).to(x.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` evaluated op by op in x's dtype, ``x * (1 / (1 + exp(-x)))``,
    each step rounded, as XLA evaluates ``jax.nn.silu``: in bf16 this gives the JAX
    forward's logits bit for bit at ``tiny_decoder``, where torch's fused ``silu``
    (one rounding) leaves them 0.025 apart, past the 2e-2 bar."""
    return x * (1 / (1 + torch.exp(-x)))


def _rope_angles(positions: torch.Tensor, d: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotary angles at ``positions [b, t]`` -> each ``[b, t, 1,
    d/2]`` f32, shared by every head and layer of a forward."""
    freqs = torch.pow(theta, -torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d)
    angles = positions[..., None].float() * freqs  # [b, t, d/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on split halves: x ``[b, t, h, d]``, positions ``[b, t]``."""
    return _rotate(x, *_rope_angles(positions, x.shape[-1], theta))


@dataclasses.dataclass
class KVCache:
    """Static-shape per-layer cache ``[b, max_len, kv_heads, head_dim]``, written in
    place. ``valid`` marks the usable slots: the left-pad slots of shorter prompts in
    a batch stay False forever, so no token attends to a pad."""

    k: list
    v: list
    length: torch.Tensor  # [] int64: the filled prefix
    valid: torch.Tensor  # [b, max_len] bool: non-pad filled slots


def init_cache(
    cfg: DecoderConfig, batch: int, max_len: int, device: "str | torch.device | None" = None
) -> KVCache:
    device = resolve_device(device)
    shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)
    return KVCache(
        k=[torch.zeros(shape, dtype=cfg.dtype, device=device) for _ in range(cfg.layers)],
        v=[torch.zeros(shape, dtype=cfg.dtype, device=device) for _ in range(cfg.layers)],
        length=torch.zeros((), dtype=torch.int64, device=device),
        valid=torch.zeros((batch, max_len), dtype=torch.bool, device=device),
    )


def _masked_out(q_pos: torch.Tensor, k_valid: torch.Tensor) -> torch.Tensor:
    """The keys a query may not see, ``[b, 1, 1, t, s]``: later slots than the query's
    (causal by slot) and slots that are unfilled or pads (``k_valid`` False)."""
    k_pos = torch.arange(k_valid.shape[1], device=q_pos.device)
    causal = q_pos[:, :, None] >= k_pos[None, None, :]  # [b, t, s]
    return ~(causal & k_valid[:, None, :])[:, None, None]


def _attend_masked(q, k, v, masked_out, cfg: DecoderConfig) -> torch.Tensor:
    g = cfg.heads // cfg.kv_heads
    b, t, h, d = q.shape
    qg = q.reshape(b, t, cfg.kv_heads, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k).float() / math.sqrt(d)
    probs = torch.softmax(scores.masked_fill(masked_out, NEG_INF), dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, h * d)


def _attend(q, k, v, q_pos, k_valid, cfg: DecoderConfig) -> torch.Tensor:
    """GQA attention; q ``[b, t, h, d]``, k/v ``[b, s, kv_heads, d]``; causal by slot
    with ``k_valid`` masking unfilled and pad slots -> ``[b, t, h*d]``."""
    return _attend_masked(q, k, v, _masked_out(q_pos, k_valid), cfg)


@torch.inference_mode()
def decoder_forward(
    model: Decoder,
    token_ids: torch.Tensor,  # [b, t]
    cache: KVCache | None = None,
    *,
    attn_mask: torch.Tensor | None = None,  # [b, t] True = real (non-pad) token
    pos_offset: torch.Tensor | None = None,  # [b] per-row left-pad count
) -> tuple[torch.Tensor, KVCache | None]:
    """Logits ``[b, t, vocab]`` f32, and the cache with this chunk written in.

    Without a cache this is the plain causal forward. With one, ``token_ids`` is the
    next chunk (often t=1), written at slots ``[cache.length, cache.length + t)``.
    Left-padded batches pass ``attn_mask`` (False on pads, which no token ever attends
    to) and ``pos_offset`` (the pad count per row, subtracted from the rotary positions
    so that token 0 of every prompt sits at rotary position 0)."""
    cfg, dt = model.cfg, model.cfg.dtype
    b, t = token_ids.shape
    dev = token_ids.device
    x = nn.functional.embedding(token_ids.long(), model.tok_emb).to(dt)
    start = cache.length if cache is not None else torch.zeros((), dtype=torch.int64, device=dev)
    slots = start + torch.arange(t, device=dev)
    # slot index (causal order) against rotary position (logical, pad-corrected)
    q_slot = slots[None, :].expand(b, t)
    q_pos = q_slot if pos_offset is None else torch.clamp(q_slot - pos_offset[:, None].long(), min=0)
    chunk_valid = attn_mask if attn_mask is not None else torch.ones((b, t), dtype=torch.bool, device=dev)
    if cache is not None:
        cache.valid.index_copy_(1, slots, chunk_valid)
    # what every layer shares, made once: the rotary angles and the attention mask
    cos, sin = _rope_angles(q_pos, cfg.head_dim, cfg.rope_theta)
    masked_out = _masked_out(q_slot, cache.valid if cache is not None else chunk_valid)
    for i, lp in enumerate(model.layers):
        h = rms_norm(x, lp.attn_norm, cfg.rms_eps)
        q = (h @ lp.q_w).reshape(b, t, cfg.heads, cfg.head_dim)
        k, v = (h @ lp.kv_w).chunk(2, dim=-1)
        k = k.reshape(b, t, cfg.kv_heads, cfg.head_dim)
        v = v.reshape(b, t, cfg.kv_heads, cfg.head_dim)
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        if cache is not None:
            cache.k[i].index_copy_(1, slots, k)
            cache.v[i].index_copy_(1, slots, v)
            k, v = cache.k[i], cache.v[i]
        x = x + _attend_masked(q, k, v, masked_out, cfg) @ lp.o_w
        h = rms_norm(x, lp.mlp_norm, cfg.rms_eps)
        gate, up = (h @ lp.gate_w).chunk(2, dim=-1)
        x = x + (_silu(gate) * up) @ lp.down_w
    x = rms_norm(x, model.final_norm, cfg.rms_eps)
    logits = (x @ model.lm_head).float()
    if cache is not None:
        cache.length.add_(t)
    return logits, cache


Choose = Callable[[torch.Tensor, int], torch.Tensor]


@torch.inference_mode()
def _generate_loop(
    model: Decoder,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    eos_id: int | None,
    prompt_mask: torch.Tensor | None,
    choose: Choose,
) -> torch.Tensor:
    """The decode scaffold shared by greedy and sampled generation: prompt prefill,
    then one cached decode step per token. ``choose(logits [b, vocab], step_no) ->
    [b]`` picks each next token. With ``prompt_mask`` (left-padded prompts of unequal
    length) pads are never attended to and rotary positions start at 0 for every
    prompt. Once a row has emitted ``eos_id``, every later token of the row is
    ``eos_id``. The JAX loop runs one more forward, whose token is never emitted; this
    loop skips it, which changes no output."""
    b, t_prompt = prompt_ids.shape
    dev = prompt_ids.device
    cache = init_cache(model.cfg, b, t_prompt + max_new_tokens, dev)
    if prompt_mask is not None:
        # left-padding: the pad count is the leading False run, t_prompt - true count
        pos_offset = t_prompt - prompt_mask.sum(dim=1)
    else:
        pos_offset = torch.zeros((b,), dtype=torch.int64, device=dev)
    logits, cache = decoder_forward(
        model, prompt_ids, cache, attn_mask=prompt_mask, pos_offset=pos_offset
    )
    tok = choose(logits[:, -1], 0)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    out = [tok]
    for step_no in range(max_new_tokens - 1):
        logits, cache = decoder_forward(model, tok[:, None], cache, pos_offset=pos_offset)
        new_tok = choose(logits[:, -1], step_no + 1)
        if eos_id is not None:
            done = done | (tok == eos_id)
            new_tok = torch.where(done, eos_id, new_tok)
        tok = new_tok
        out.append(tok)
    return torch.stack(out, dim=1)


def greedy_generate(
    model: Decoder,
    prompt_ids: torch.Tensor,  # [b, t_prompt]
    max_new_tokens: int,
    eos_id: int | None = None,
    prompt_mask: torch.Tensor | None = None,  # [b, t_prompt] True = real token
) -> torch.Tensor:
    """Greedy decode with a static-shape cache -> tokens ``[b, max_new_tokens]``
    int64."""

    def choose(logits: torch.Tensor, _step: int) -> torch.Tensor:
        return torch.argmax(logits, dim=-1)

    return _generate_loop(model, prompt_ids, max_new_tokens, eos_id, prompt_mask, choose)


def _filter_logits(logits: torch.Tensor, top_k: int | None, top_p: float | None) -> torch.Tensor:
    """HF-style logit filtering: keep the top-k logits (every logit equal to the k-th
    value stays) and/or the nucleus, the tokens up to and including the one whose
    cumulative probability crosses ``top_p`` in a stable descending sort (a tie at the
    boundary is dropped by its sorted index); everything else -> -inf. The exclusive
    cumulative sum against ``max(top_p, 1e-9)`` always keeps the argmax."""
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p is not None and top_p < 1.0:
        order = torch.argsort(-logits, dim=-1, stable=True)
        sorted_desc = torch.gather(logits, -1, order)
        probs = torch.softmax(sorted_desc, dim=-1)
        cumulative = torch.cumsum(probs, dim=-1)
        keep_sorted = (cumulative - probs) < max(top_p, 1e-9)
        # back through the inverse permutation
        keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
        logits = logits.masked_fill(~keep, -math.inf)
    return logits


_MASK64 = (1 << 64) - 1


def _step_seed(row_seed: int, step_no: int) -> int:
    """A 64-bit generator seed from a row's 32-bit seed and the step (splitmix64 of
    the two packed side by side): distinct pairs give unrelated streams."""
    z = (((row_seed & 0xFFFFFFFF) << 32) | (step_no & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def sample_generate(
    model: Decoder,
    prompt_ids: torch.Tensor,  # [b, t_prompt]
    max_new_tokens: int,
    row_seeds: "Sequence[int] | np.ndarray | torch.Tensor",  # [b] 32-bit seeds, one a row
    *,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    eos_id: int | None = None,
    prompt_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sampling decode: temperature scaling, then top-k/top-p filtering, then a
    categorical draw per row (Gumbel-max over the filtered logits, with uniform noise
    from the row's own generator, seeded from its seed and the step): a row's draws
    depend on nothing else in the batch, so its tokens are a function of the weights,
    its prompt and its seed. (On the card a bf16 product of another batch shape may
    still round the row's logits apart.)"""
    if isinstance(row_seeds, torch.Tensor):
        row_seeds = row_seeds.cpu().numpy()
    seeds = [int(s) & 0xFFFFFFFF for s in np.asarray(row_seeds).reshape(-1)]
    if len(seeds) != prompt_ids.shape[0]:
        raise ValueError(f"{len(seeds)} row seeds for {prompt_ids.shape[0]} rows")
    inv_temp = 1.0 / max(temperature, 1e-6)
    tiny = torch.finfo(torch.float32).tiny

    def choose(logits: torch.Tensor, step_no: int) -> torch.Tensor:
        filtered = _filter_logits(logits * inv_temp, top_k, top_p)
        vocab, dev = logits.shape[-1], logits.device
        noise = torch.stack([
            torch.rand(
                (vocab,), generator=torch.Generator(device=dev).manual_seed(_step_seed(s, step_no)),
                device=dev,
            )
            for s in seeds
        ])
        gumbel = -torch.log(-torch.log(noise.clamp_(min=tiny)))
        return torch.argmax(filtered + gumbel, dim=-1)

    return _generate_loop(model, prompt_ids, max_new_tokens, eos_id, prompt_mask, choose)
