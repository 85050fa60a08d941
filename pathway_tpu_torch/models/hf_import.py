"""HF checkpoint -> ``Encoder`` weights for the BERT-family encoders.

Counterpart of ``pathway_tpu/models/hf_import.py``. Accepts a torch ``state_dict``
(or a dict of numpy arrays, or a ``.npz`` / ``pytorch_model.bin`` file) in HF BERT
naming, with or without the ``bert.`` prefix, and returns a ``state_dict`` in the
``Encoder``'s naming (f32, on the CPU) with its ``EncoderConfig``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.models.transformer import EncoderConfig


def _to_np(t: Any) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _normalize_state_dict(state: Any) -> dict[str, np.ndarray]:
    if isinstance(state, (str, bytes, os.PathLike)):
        path = os.fsdecode(state)
        if path.endswith(".npz"):
            with np.load(path) as data:
                return {k: np.asarray(v) for k, v in data.items()}
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        return {k: _to_np(v) for k, v in loaded.items()}
    return {k: _to_np(v) for k, v in dict(state).items()}


def _strip_prefix(state: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    for prefix in ("bert.", "model.", "encoder.bert."):
        if any(k.startswith(prefix) for k in state):
            state = {
                (k[len(prefix):] if k.startswith(prefix) else k): v
                for k, v in state.items()
            }
    return state


def config_from_state_dict(state: Any) -> EncoderConfig:
    """Infer the architecture from tensor shapes."""
    sd = _strip_prefix(_normalize_state_dict(state))
    vocab, hidden = sd["embeddings.word_embeddings.weight"].shape
    max_len = sd["embeddings.position_embeddings.weight"].shape[0]
    type_vocab = sd["embeddings.token_type_embeddings.weight"].shape[0]
    intermediate = sd["encoder.layer.0.intermediate.dense.weight"].shape[0]
    layers = 0
    while f"encoder.layer.{layers}.intermediate.dense.weight" in sd:
        layers += 1
    # heads: only config.json says; every BERT-family checkpoint the embedders
    # default to uses head_dim 32 or 64 — prefer 64 when it divides
    heads = hidden // 64 if hidden % 64 == 0 else hidden // 32
    return EncoderConfig(
        vocab_size=vocab,
        hidden=hidden,
        layers=layers,
        heads=heads,
        intermediate=intermediate,
        max_len=max_len,
        type_vocab=type_vocab,
    )


def import_hf_encoder(
    state: Any, cfg: EncoderConfig | None = None
) -> tuple[dict[str, torch.Tensor], EncoderConfig]:
    """-> (``Encoder`` state_dict, config). HF Linear stores ``weight [out, in]``;
    the forward computes ``x @ W``, so weights transpose on import."""
    sd = _strip_prefix(_normalize_state_dict(state))
    if cfg is None:
        cfg = config_from_state_dict(sd)

    out: dict[str, torch.Tensor] = {}

    def put(name: str, arr: np.ndarray) -> None:
        out[name] = torch.tensor(np.ascontiguousarray(arr, np.float32))

    def put_ln(name: str, prefix: str) -> None:
        put(f"{name}.scale", sd[f"{prefix}.weight"])
        put(f"{name}.bias", sd[f"{prefix}.bias"])

    put("tok_emb", sd["embeddings.word_embeddings.weight"])
    put("pos_emb", sd["embeddings.position_embeddings.weight"])
    put("type_emb", sd["embeddings.token_type_embeddings.weight"])
    put_ln("emb_ln", "embeddings.LayerNorm")
    for i in range(cfg.layers):
        pre, dst = f"encoder.layer.{i}", f"layers.{i}"
        att = f"{pre}.attention.self"
        put(f"{dst}.qkv_w", np.concatenate(
            [sd[f"{att}.{n}.weight"].T for n in ("query", "key", "value")], axis=1
        ))
        put(f"{dst}.qkv_b", np.concatenate(
            [sd[f"{att}.{n}.bias"] for n in ("query", "key", "value")]
        ))
        put(f"{dst}.out_w", sd[f"{pre}.attention.output.dense.weight"].T)
        put(f"{dst}.out_b", sd[f"{pre}.attention.output.dense.bias"])
        put_ln(f"{dst}.attn_ln", f"{pre}.attention.output.LayerNorm")
        put(f"{dst}.fc1_w", sd[f"{pre}.intermediate.dense.weight"].T)
        put(f"{dst}.fc1_b", sd[f"{pre}.intermediate.dense.bias"])
        put(f"{dst}.fc2_w", sd[f"{pre}.output.dense.weight"].T)
        put(f"{dst}.fc2_b", sd[f"{pre}.output.dense.bias"])
        put_ln(f"{dst}.mlp_ln", f"{pre}.output.LayerNorm")
    return out, cfg


def load_sentence_transformer(
    model_path: str,
    *,
    pooling: str = "mean",
) -> tuple[dict[str, torch.Tensor], EncoderConfig, Any]:
    """Load a locally cached sentence-transformers/HF directory: weights
    (``pytorch_model.bin`` / ``model.npz``) + ``vocab.txt`` WordPiece.
    -> (state_dict, config, tokenizer or None)."""
    # imported here: the xpack package imports this module
    from pathway_tpu_torch.xpacks.llm._tokenizer import WordPieceTokenizer

    state_path = None
    for candidate in ("pytorch_model.bin", "model.npz", "model.pt"):
        p = os.path.join(model_path, candidate)
        if os.path.exists(p):
            state_path = p
            break
    if state_path is None:
        raise FileNotFoundError(
            f"no pytorch_model.bin / model.npz under {model_path}"
        )
    state, cfg = import_hf_encoder(state_path)
    overrides: dict[str, Any] = {"pooling": pooling}
    cfg_json = os.path.join(model_path, "config.json")
    if os.path.exists(cfg_json):
        # the head count is invisible in tensor shapes (MiniLM: 384 hidden =
        # 12 heads x 32, not the inferred 6 x 64): config.json decides
        with open(cfg_json, encoding="utf-8") as f:
            hf_cfg = json.load(f)
        if "num_attention_heads" in hf_cfg:
            overrides["heads"] = int(hf_cfg["num_attention_heads"])
    cfg = dataclasses.replace(cfg, **overrides)
    vocab_path = os.path.join(model_path, "vocab.txt")
    tokenizer = (
        WordPieceTokenizer(vocab_path) if os.path.exists(vocab_path) else None
    )
    return state, cfg, tokenizer
