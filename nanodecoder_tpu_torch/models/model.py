"""Seq2seq serving model: encode, prepare serving params, decode step.

The port's counterpart of the serving path in
`nanodecoder_tpu.models.model`.  Params are the nested dict that
`train.checkpoint.params_from_numpy` builds.  For lean models
(`lean_step`) `prepare_serving_params` adds the folded encoder
(`_enc_lean`) and decoder (`_lean`) weights in the compute dtype once per
run; unfolded models serve from the master weights, as the JAX package's
do.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from nanodecoder_tpu_torch.config import ModelConfig
from nanodecoder_tpu_torch.models import decoder as dec
from nanodecoder_tpu_torch.models import modules as nn
from nanodecoder_tpu_torch.models.encoder import (compute_dtype, encoder_apply,
                                                  encoder_apply_lean,
                                                  fold_encoder_lean)

_NOT_FOLDED = "params lack the serving fold; call prepare_serving_params first"


def _check_transformer(cfg: ModelConfig) -> None:
    if cfg.encoder_type != "transformer" or cfg.decoder_type != "transformer":
        raise ValueError("the port serves transformer models only "
                         "(encoder_type = decoder_type = 'transformer')")


def prepare_serving_params(params: dict[str, Any], cfg: ModelConfig):
    """A copy of `params`; for a lean model with the folded, pre-cast
    serving weights of the encoder and the decoder (compute dtype)."""
    _check_transformer(cfg)
    out = dict(params)
    if cfg.lean_step:
        dtype = compute_dtype(cfg)
        out["_lean"] = dec.fold_lean_params(params["decoder"], params["generator"],
                                            cfg, dtype)
        out["_enc_lean"] = fold_encoder_lean(params["encoder"], cfg, dtype)
    return out


def encode(params, cfg: ModelConfig, signal: torch.Tensor,
           lengths: torch.Tensor):
    """Raw signal chunk batch (B, S) -> (memory (B, T, D), enc_lengths)."""
    if not cfg.lean_step:
        return encoder_apply(params["encoder"], cfg, signal, lengths)
    if "_enc_lean" not in params:
        raise ValueError(_NOT_FOLDED)
    return encoder_apply_lean(params["_enc_lean"], cfg, signal, lengths)


def init_decode_state(params, cfg: ModelConfig, memory: torch.Tensor,
                      mem_lengths: torch.Tensor, beam_k: int = 1) -> dict[str, Any]:
    """Decode state for the (B, S, D) memory bank.  beam_k > 1: B * beam_k
    chunk-major decode rows sharing each chunk's cross K/V."""
    return dec.init_transformer_cache(params["decoder"], cfg, memory,
                                      mem_lengths, memory.shape[0], memory.dtype,
                                      beam_k=beam_k)


def reorder_decode_state_beam(state: dict[str, Any],
                              beam_origin: torch.Tensor) -> dict[str, Any]:
    """Gather the path-dependent self caches by beam origin.
    beam_origin: (B, K) int, the within-chunk origin beam of each new
    beam.  Cross K/V and masks are beam-invariant and stay as they are.
    The gathers make fresh tensors, so the decode steps' in-place writes
    (K2 into self_kv, the staged block, the per-layer caches) never reach
    an earlier alias."""
    bsz, k = beam_origin.shape
    flat = (torch.arange(bsz, device=beam_origin.device)[:, None] * k
            + beam_origin.long()).reshape(-1)
    if "self_kv" in state:
        return {**state, "self_kv": state["self_kv"].index_select(0, flat),
                "self_kv_stage": state["self_kv_stage"].index_select(0, flat)}
    return {**state, "layers": [
        {**cache, "self_k": cache["self_k"].index_select(0, flat),
         "self_v": cache["self_v"].index_select(0, flat)}
        for cache in state["layers"]]}


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor,
                  position: int) -> torch.Tensor:
    """tokens (B, 1) -> (B, 1, D): embedding * sqrt(d) + PE row `position`."""
    dtype = compute_dtype(cfg)
    y = nn.embed(params["tgt_embed"], tokens, dtype)
    y = y * torch.tensor(math.sqrt(float(cfg.d_model)), dtype=dtype,
                         device=y.device)
    pe = nn.sinusoidal_positions(cfg.max_decode_len + 1, cfg.d_model,
                                 y.device).to(dtype)
    return y + pe[position][None, None, :]


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                state: dict[str, Any]):
    """One decode step.  tokens: (B,) int current input tokens.
    Returns (log_probs (B, V) f32, attn_pos (B,) int32 — the last layer's
    cross-attention argmax over encoder positions — and the new state)."""
    y1 = _embed_tokens(params, cfg, tokens[:, None], state["step"])
    if cfg.lean_step:
        if "_lean" not in params:
            raise ValueError(_NOT_FOLDED)
        lean = params["_lean"]
        hidden, attn_pos, new_state = dec._transformer_decoder_step_lean(
            lean, cfg, y1, state)
        logits = hidden[:, 0, :].to(torch.float32) @ lean["gen_w"] + lean["gen_b"]
        return torch.log_softmax(logits, dim=-1), attn_pos, new_state
    hidden, (probs, amax), new_state = dec.transformer_decoder_step(
        params["decoder"], cfg, y1, state)
    attn_pos = amax if probs is None else dec._head_mean_argmax(probs)
    gen = params["generator"]
    logits = hidden[:, 0, :].to(torch.float32) @ gen["w"] + gen["b"]
    return torch.log_softmax(logits, dim=-1), attn_pos, new_state
