"""The port's local chat (``PipelineChat``, ``pathway_tpu_torch.xpacks.llm.llms``)
against the JAX package's ``TpuPipelineChat`` on the same weights, carried over by
``params_from_jax``, and the same ``HashTokenizer``, at the ``tiny`` preset (vocab 512,
hidden 64, 2 layers).

Replies are compared for equality. Both presets are set to f32 compute for that: the
JAX chat decodes in a ``lax.scan``, compiled whole, whose bf16 logits differ from its
own eager forward by 4e-2 relative at this size, so a near-tie can pick another token
in bf16; in f32 the two decoders agree to ~1e-6 and their argmaxes coincide. The
decoder's bf16 arithmetic is held in ``tests/test_torch_decoder.py``.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu.models as jmodels
from pathway_tpu.models import decoder as jd
from pathway_tpu_torch.models import decoder as td
from pathway_tpu_torch.models import params_from_jax
from pathway_tpu_torch.xpacks.llm import llms as tllms

WAIT_S = 60.0  # every wait is bounded: a stalled pipeline fails, never hangs
PROMPTS = [
    "what is a stream table",
    json.dumps([{"role": "system", "content": "be brief"}, {"role": "user", "content": "index?"}]),
    "join reduce shard tensor batch query embed token device mesh",
    "x",
    "commit window",
]


@pytest.fixture
def f32_presets(monkeypatch):
    tiny_j, tiny_t = jd.tiny_decoder(), td.tiny_decoder()
    monkeypatch.setattr(jmodels, "tiny_decoder",
                        lambda: jd.DecoderConfig(**{**tiny_j.__dict__, "dtype": jnp.float32}))
    monkeypatch.setitem(tllms._DECODER_PRESETS, "tiny",
                        lambda: td.DecoderConfig(**{**tiny_t.__dict__, "dtype": torch.float32}))


@pytest.fixture(scope="module")
def jax_params():
    return jd.init_decoder_params(jax.random.key(5), jd.tiny_decoder())


def _chats(jax_params, **kw):
    from pathway_tpu.xpacks.llm.llms import TpuPipelineChat

    theirs = TpuPipelineChat("tiny", params=jax_params, **kw)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    ours = tllms.PipelineChat("tiny", params=state, device="cpu", **kw)
    assert ours.config.dtype == torch.float32 and theirs.config.dtype == jnp.float32
    return ours, theirs


@pytest.mark.parametrize("max_new_tokens", [6, 20])
def test_greedy_replies_equal_tpu_pipeline_chat(f32_presets, jax_params, max_new_tokens):
    ours, theirs = _chats(jax_params, max_new_tokens=max_new_tokens)
    mine = ours._fn(PROMPTS)
    assert mine == theirs._fn(PROMPTS)
    assert all(isinstance(r, str) for r in mine) and len(set(mine)) > 1
    # a reply is the tokenizer's decode of the row's tokens: eos and the other
    # reserved ids (<= 3) print nothing
    assert all(all(int(w[1:-1]) > 3 for w in r.split()) for r in mine)


def test_greedy_replies_through_pw_run_equal_tpu_pipeline_chat(f32_presets, jax_params):
    import pathway_tpu_torch as pw

    ours, theirs = _chats(jax_params, max_new_tokens=8, max_batch_size=2)
    expected = theirs._fn(PROMPTS)
    replies, done = {}, threading.Event()

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i, p in enumerate(PROMPTS):
                self.next(prompt_id=i, prompt=p)

    rows = pw.io.python.read(Feed(), schema=pw.schema_from_types(prompt_id=int, prompt=str),
                             autocommit_duration_ms=50)
    answered = rows.select(prompt_id=pw.this.prompt_id, reply=ours(pw.this.prompt))

    def on_change(key, row, time, is_addition):
        if is_addition:
            replies[row["prompt_id"]] = row["reply"]
            if len(replies) == len(PROMPTS):
                done.set()

    pw.io.subscribe(answered, on_change=on_change)
    runner = threading.Thread(target=pw.run, daemon=True)
    runner.start()
    runner.join(4 * WAIT_S)
    assert not runner.is_alive(), "pw.run did not end"
    assert done.is_set()
    assert [replies[i] for i in range(len(PROMPTS))] == expected


def test_sampled_replies_do_not_depend_on_the_batch(f32_presets, jax_params):
    """The JAX chat's own sampling test, on the port: a prompt's sampled reply is the
    same alone and in a batch, with top-k 1 the greedy reply, and it moves with the
    seed. (In f32: top-k 1 keeps every logit tied with the top one, as JAX's filter
    does, and bf16 logits tie often enough that a draw among tied tokens can leave the
    greedy reply.)"""
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))

    def chat(**kw):
        return tllms.PipelineChat("tiny", params=state, device="cpu", max_new_tokens=6, **kw)

    sampled = chat(do_sample=True, temperature=0.8, top_k=16, seed=3)
    batch = sampled._fn(PROMPTS)
    assert [sampled._fn([p])[0] for p in PROMPTS] == batch
    assert chat(do_sample=True, top_k=1, seed=3)._fn(PROMPTS) == chat()._fn(PROMPTS)
    others = chat(do_sample=True, temperature=0.8, top_k=16, seed=4)._fn(PROMPTS)
    assert others != batch


@pytest.mark.parametrize("prompt", [
    "plain text",
    "[1, 2]",
    "{\"role\": \"user\"}",
    json.dumps([{"role": "user", "content": "hi"}, {"content": "no role"}, "skipped"]),
    ["not", "dicts"],
    ({"role": "assistant", "content": "a tuple"},),
    42,
])
def test_coerce_prompt_matches_jax(prompt):
    from pathway_tpu.xpacks.llm.llms import _coerce_prompt

    assert tllms._coerce_prompt(prompt) == _coerce_prompt(prompt)


def test_prompt_chat_single_qa_matches_jax():
    from pathway_tpu.xpacks.llm.llms import prompt_chat_single_qa

    for q in ("what is pathway?", 'quote " and \\ slash', 7):
        assert tllms.prompt_chat_single_qa(q) == prompt_chat_single_qa(q)


@pytest.mark.parametrize("name", ["OpenAIChat", "LiteLLMChat", "CohereChat"])
def test_remote_chats_are_not_ported_yet(name):
    """The remote chats over an injected client (a sync one, then an async one with a
    client keyword): the same replies, cache names and executor as the JAX package's,
    and no client means a ValueError in both."""
    import asyncio

    from pathway_tpu.xpacks.llm import llms as jllms
    from pathway_tpu_torch.internals.udfs.executors import stop_event_loop

    def sync_client(model, prompt, **kw):
        return f"{model}|{prompt}|{sorted(kw.items())}"

    async def async_client(model, prompt, **kw):
        await asyncio.sleep(0)
        return len(str(prompt)) if prompt != "boom" else 1 // 0

    rows = [("hello",), ("boom",), (json.dumps([{"role": "user", "content": "hi"}]),)]
    got = []
    for mod in (tllms, jllms):
        cls = getattr(mod, name)
        with pytest.raises(ValueError, match="client"):
            cls()
        plain = cls(client=sync_client)
        keyed = cls(model="m-1", client=async_client, temperature=0.5, capacity=2)
        assert plain._executor.kind == keyed._executor.kind == "async"
        got.append((
            plain._cache_name,
            keyed._cache_name,
            plain.execute_rows(rows, n_pos=1),
            [(ok, v if ok else type(v).__name__) for ok, v in keyed.execute_rows(rows, n_pos=1)],
        ))
    stop_event_loop()
    assert got[0] == got[1]
    assert got[0][3] == [(True, "5"), (False, "ZeroDivisionError"), (True, str(len(rows[2][0])))]


@pytest.mark.parametrize("kw", [
    {},
    {"max_new_tokens": 7, "max_prompt_len": 64, "seed": 9},
    {"cache_tag": "v2"},
    {"do_sample": True, "temperature": 0.7, "top_k": 5, "top_p": 0.9},
])
def test_cache_name_follows_the_jax_forms(kw):
    from pathway_tpu.xpacks.llm.llms import TpuPipelineChat

    theirs = TpuPipelineChat("tiny", **kw)._cache_name
    ours = tllms.PipelineChat("tiny", device="cpu", **kw)._cache_name
    assert ours == "PipelineChat" + theirs[len("TpuPipelineChat"):]


def test_cache_name_of_custom_weights_names_the_weights():
    """Custom weights or a tokenizer get a content digest; the same weights give the
    same name, a changed weight another; a cache tag takes the digest's place."""
    base = td.Decoder(td.tiny_decoder(), device="cpu", seed=1).state_dict()
    same = {k: v.clone() for k, v in base.items()}
    moved = {k: v.clone() for k, v in base.items()}
    moved["layers.1.down_w"][5, 7] += 0.5

    def name(**kw):
        return tllms.PipelineChat("tiny", device="cpu", **kw)._cache_name

    a = name(params=base)
    assert a.startswith("PipelineChat:tiny:32:128:seed0:ckpt") and len(a.split("ckpt")[1]) == 16
    assert name(params=same) == a
    assert name(params=moved) != a
    assert name(tokenizer=tllms.HashTokenizer(512)) not in (a, name())
    assert name(params=base, cache_tag="t") == "PipelineChat:tiny:32:128:seed0:tagt"


def test_presets_and_hf_name():
    with pytest.raises(ValueError, match="unknown decoder preset"):
        tllms.PipelineChat("llama-70b", device="cpu")
    chat = tllms.HFPipelineChat("tiny", device="cpu", max_new_tokens=3)
    assert isinstance(chat, tllms.PipelineChat)
    assert chat.config == td.tiny_decoder() and chat.decoder.cfg.vocab_size == 512
    replies = chat._fn(["hello", "world"])
    assert len(replies) == 2
