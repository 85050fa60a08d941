"""Chat models: the local decoder chat on the card, a UDF of the engine.

Counterpart of ``pathway_tpu/xpacks/llm/llms.py``. ``PipelineChat`` (``TpuPipelineChat``
there; ``HFPipelineChat`` keeps its name) is the causal decoder of ``models/decoder.py``
with greedy or sampled decode over a static KV cache, micro-batched by the UDF's batch
executor: each chunk of prompts is tokenized, left-padded and generated as one batch.
The remote chats (``OpenAIChat``, ``LiteLLMChat``, ``CohereChat``) are async UDFs over
an injected ``client`` callable (sync or async): the package makes no network call of
its own.
"""

from __future__ import annotations

import hashlib
import json
import zlib
from typing import Any, Callable

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.internals.udfs import (
    UDF,
    AsyncRetryStrategy,
    CacheStrategy,
    async_executor,
    batch_executor,
)
from pathway_tpu_torch.models.decoder import (
    Decoder,
    greedy_generate,
    mistral_7b,
    sample_generate,
    tiny_decoder,
)
from pathway_tpu_torch.xpacks.llm._tokenizer import SEP_ID, HashTokenizer

_DECODER_PRESETS = {"mistral-7b": mistral_7b, "tiny": tiny_decoder}
#: the end of a reply: the tokenizer's SEP id (2), as in the JAX chat
EOS_ID = SEP_ID


def _checkpoint_digest(params: "dict[str, torch.Tensor] | None", tokenizer: Any) -> str:
    """A stable fingerprint of custom weights (a ``state_dict``) and tokenizer, so a
    cache namespace tells two checkpoints apart across restarts. Per tensor: its name,
    shape and dtype, a 16-element head sample and an f32 sum of the whole tensor; the
    samples and sums come to the host in one device-to-host copy, so a fine-tune that
    moves any weight moves its sum without downloading the weights. (Its bytes differ
    from the JAX package's digest of the same weights.)"""
    h = hashlib.blake2b(digest_size=8)
    if params:
        names = sorted(params)
        rows = []
        for name in names:
            flat = params[name].detach().reshape(-1)
            row = torch.zeros((17,), dtype=torch.float32, device=flat.device)
            head = flat[:16].float()
            row[: head.numel()] = head
            row[16] = flat.sum(dtype=torch.float32)
            rows.append(row)
        prints = torch.stack(rows).cpu().numpy()
        for name, row in zip(names, prints):
            x = params[name]
            h.update(name.encode())
            h.update(str(tuple(x.shape)).encode())
            h.update(str(x.dtype).encode())
            h.update(np.ascontiguousarray(row).tobytes())
    if tokenizer is not None:
        h.update(type(tokenizer).__name__.encode())
        vocab = getattr(tokenizer, "vocab", None)
        if vocab is not None:
            vocab_list = list(vocab)
            h.update(str(len(vocab_list)).encode())
            for tok in vocab_list[:8] + vocab_list[-8:]:
                h.update(str(tok).encode())
    return h.hexdigest()


class PipelineChat(UDF):
    """Local decode on the card.

    ``model`` picks a decoder preset (``"mistral-7b"`` or ``"tiny"``); weights are
    seeded random unless ``params`` (a ``Decoder`` state_dict, e.g. from
    ``params_from_jax``) is passed. A custom tokenizer with ``encode``/``decode`` may
    be given. Greedy unless ``do_sample``; sampled rows are seeded from
    ``(crc32(prompt) ^ seed)``, so a prompt's reply does not depend on its batch."""

    def __init__(
        self,
        model: str = "tiny",
        *,
        max_new_tokens: int = 32,
        max_prompt_len: int = 128,
        params: "dict[str, torch.Tensor] | None" = None,
        tokenizer: Any = None,
        seed: int = 0,
        max_batch_size: int = 8,
        cache_tag: str | None = None,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: int | None = None,
        top_p: float | None = None,
        device: "str | torch.device | None" = None,
    ) -> None:
        cfg_fn = _DECODER_PRESETS.get(model)
        if cfg_fn is None:
            raise ValueError(f"unknown decoder preset {model!r}")
        self.config = cfg_fn()
        self.device = resolve_device(device)
        self.max_new_tokens = max_new_tokens
        self.max_prompt_len = max_prompt_len
        self.do_sample = do_sample
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.seed = seed
        self.tokenizer = tokenizer or HashTokenizer(self.config.vocab_size)
        self.decoder = Decoder(
            self.config, device=self.device, seed=None if params is not None else seed
        )
        if params is not None:
            self.decoder.load_state_dict(params)
        if cache_tag is not None:
            weights_part = f":tag{cache_tag}"
        elif params is not None or tokenizer is not None:
            weights_part = f":ckpt{_checkpoint_digest(params, tokenizer)}"
        else:
            weights_part = ""
        super().__init__(
            self.generate_batch,
            executor=batch_executor(max_batch_size=max_batch_size),
            deterministic=True,
            # the sampling knobs shape the output only when sampling
            cache_name=(
                f"PipelineChat:{model}:{max_new_tokens}:{max_prompt_len}:seed{seed}"
                + weights_part
                + (f":sample:{temperature}:{top_k}:{top_p}" if do_sample else "")
            ),
        )

    def encode_prompts(self, prompts: list) -> tuple[torch.Tensor, torch.Tensor, list[str]]:
        """Prompts -> left-padded ids and mask ``[n, t_max]`` on the device (generation
        happens at the end of each row), and the prompt texts."""
        texts = [_coerce_prompt(p) for p in prompts]
        encoded = [self.tokenizer.encode(t, self.max_prompt_len) for t in texts]
        t_max = max(len(e) for e in encoded)
        ids = np.zeros((len(texts), t_max), np.int64)
        mask = np.zeros((len(texts), t_max), bool)
        for i, e in enumerate(encoded):
            ids[i, t_max - len(e):] = e
            mask[i, t_max - len(e):] = True
        return (
            torch.from_numpy(ids).to(self.device),
            torch.from_numpy(mask).to(self.device),
            texts,
        )

    def generate_batch(self, prompts: list) -> list[str]:
        """The UDF's body: one executor chunk of prompts -> one reply each."""
        ids, mask, texts = self.encode_prompts(prompts)
        if self.do_sample:
            row_seeds = [(zlib.crc32(t.encode()) ^ self.seed) & 0xFFFFFFFF for t in texts]
            toks = sample_generate(
                self.decoder, ids, self.max_new_tokens, row_seeds,
                temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
                eos_id=EOS_ID, prompt_mask=mask,
            )
        else:
            toks = greedy_generate(
                self.decoder, ids, self.max_new_tokens, eos_id=EOS_ID, prompt_mask=mask
            )
        return [self.tokenizer.decode(list(row)) for row in toks.cpu().numpy()]


class HFPipelineChat(PipelineChat):
    """The name the reference's local chat goes by; decode runs on the card."""


def _coerce_prompt(prompt: Any) -> str:
    """Accept plain strings or OpenAI-style message lists."""
    if isinstance(prompt, str):
        try:
            parsed = json.loads(prompt)
        except (json.JSONDecodeError, ValueError):
            return prompt
        prompt = parsed
    if isinstance(prompt, (list, tuple)):
        return "\n".join(
            f"{m.get('role', 'user')}: {m.get('content', '')}"
            for m in prompt
            if isinstance(m, dict)
        )
    return str(prompt)


class _RemoteChat(UDF):
    """A chat behind ``client(model=..., prompt=..., **client_kwargs)``, which may
    return the reply or an awaitable of it; the reply is taken as ``str``. Runs on the
    async executor (``capacity`` calls at once, ``timeout`` seconds a call), with the
    optional cache and retry strategies; the cache name is the class and the model."""

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
                "(no network egress here); use xpacks.llm.mocks for tests"
            )

        async def call(prompt: Any) -> str:
            result = client(model=self.model, prompt=prompt, **self.kwargs)
            if hasattr(result, "__await__"):
                result = await result
            return str(result)

        super().__init__(
            call,
            executor=async_executor(capacity=capacity, timeout=timeout),
            cache_strategy=cache_strategy,
            retry_strategy=retry_strategy,
            cache_name=f"{type(self).__name__}:{model}",
        )


class OpenAIChat(_RemoteChat):
    """Reference: llms.py:84."""

    def __init__(self, model: str = "gpt-4o-mini", **kw: Any):
        super().__init__(model, **kw)


class LiteLLMChat(_RemoteChat):
    """Reference: llms.py:313."""

    def __init__(self, model: str = "", **kw: Any):
        super().__init__(model, **kw)


class CohereChat(_RemoteChat):
    """Reference: llms.py:544."""

    def __init__(self, model: str = "command", **kw: Any):
        super().__init__(model, **kw)


def prompt_chat_single_qa(question: str) -> str:
    """Wrap a question as a single-turn message list (reference llms.py:686)."""
    return json.dumps([{"role": "user", "content": str(question)}])
