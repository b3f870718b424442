"""Seq2seq model: init, encode, teacher-forced decode, prepare serving
params, decode step.

The port's counterpart of `nanodecoder_tpu.models.model`, for the four
encoder (transformer, lstm) x decoder (transformer, rnn) combinations.
Params are the nested dict of float32 tensors that `init_model` or
`train.checkpoint.params_from_numpy` builds.  For lean models
(`lean_step`) `prepare_serving_params` adds the folded weights in the
compute dtype once per run, of each side that is a transformer: the
encoder's (`_enc_lean`) and the decoder's (`_lean`).  Unfolded models,
the biLSTM encoder and the RNN decoder serve from the master weights, as
the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from nanodecoder_tpu_torch import prng
from nanodecoder_tpu_torch.config import ModelConfig
from nanodecoder_tpu_torch.models import decoder as dec
from nanodecoder_tpu_torch.models import modules as nn
from nanodecoder_tpu_torch.models import encoder as enc
from nanodecoder_tpu_torch.models.encoder import (compute_dtype, encoder_apply,
                                                  encoder_apply_lean,
                                                  fold_encoder_lean, init_encoder)
from nanodecoder_tpu_torch.vocab import vocab_size_for

_NOT_FOLDED = "params lack the serving fold; call prepare_serving_params first"


def init_model(key, cfg: ModelConfig, device: torch.device | str = "cpu") -> dict[str, Any]:
    """Random float32 params on `device`: glorot-uniform weights, zero
    biases, unit layer-norm scales, N(0, 1/d) embeddings, drawn from the
    threefry `key` (`prng.PRNGKey(seed)`) split as the JAX package splits
    it (encoder, decoder, embedding, generator), so the same seed gives the
    JAX package's `init_model(jax.random.PRNGKey(seed))`."""
    expected = vocab_size_for(cfg.kmer_k)
    if cfg.vocab_size != expected:
        raise ValueError(
            f"ModelConfig.vocab_size={cfg.vocab_size} does not match "
            f"kmer_k={cfg.kmer_k} (expected vocab_size_for({cfg.kmer_k})="
            f"{expected}); set both consistently")
    decoders = {"transformer": dec.init_transformer_decoder, "rnn": dec.init_rnn_decoder}
    if cfg.decoder_type not in decoders:
        raise ValueError(f"unknown decoder_type {cfg.decoder_type!r}")
    k_enc, k_dec, k_emb, k_gen = prng.split(key, 4)
    return {"encoder": init_encoder(k_enc, cfg, device),
            "decoder": decoders[cfg.decoder_type](k_dec, cfg, device),
            "tgt_embed": nn.init_embedding(k_emb, cfg.vocab_size, cfg.d_model, device),
            "generator": nn.init_dense(k_gen, cfg.d_model, cfg.vocab_size, device=device)}


def named_leaves(params, prefix: str = "") -> dict[str, torch.Tensor]:
    """Every tensor of a params tree under its `/`-joined path (the keys
    of the JAX package's `save_params_npz`), in nesting order."""
    if isinstance(params, (dict, list)):
        items = params.items() if isinstance(params, dict) else enumerate(params)
        out: dict[str, torch.Tensor] = {}
        for k, v in items:
            out.update(named_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: params}


def params_to(params, device: torch.device | str):
    """The params tree with every tensor on `device` (those already there
    as they are)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


def param_count(params) -> int:
    return sum(t.numel() for t in named_leaves(params).values())


def prepare_serving_params(params: dict[str, Any], cfg: ModelConfig):
    """A copy of `params`; for a lean model with the folded, pre-cast
    serving weights (compute dtype) of a transformer decoder (`_lean`)
    and of a transformer encoder (`_enc_lean`)."""
    out = dict(params)
    dtype = compute_dtype(cfg)
    if cfg.lean_step and cfg.decoder_type == "transformer":
        out["_lean"] = dec.fold_lean_params(params["decoder"], params["generator"],
                                            cfg, dtype)
    if cfg.lean_step and cfg.encoder_type == "transformer":
        out["_enc_lean"] = fold_encoder_lean(params["encoder"], cfg, dtype)
    return out


def encode(params, cfg: ModelConfig, signal: torch.Tensor, lengths: torch.Tensor,
           rng=None, train: bool = False, row0: int = 0):
    """Raw signal chunk batch (B, S) -> (memory (B, T, D), enc_lengths).
    The folded lean encoder runs when the params carry it (`_enc_lean`,
    from prepare_serving_params) and this is not a training pass; else
    the unfolded encoder over the master weights.  `rng` (a threefry key)
    keys training's dropout; `row0` is the first row of this batch in the
    global batch whose masks JAX draws (a data-parallel rank's rows)."""
    if not train and "_enc_lean" in params:
        return encoder_apply_lean(params["_enc_lean"], cfg, signal, lengths)
    return encoder_apply(params["encoder"], cfg, signal, lengths, rng, train, row0)


def dropout_draw_keys(cfg: ModelConfig, rng) -> list:
    """The key of each dropout draw (each launch of R1) that `encode` then
    `decode_teacher_forced` make in a training pass under `rng`, in launch
    order: a transformer encoder layer draws r1 (the attention output's
    mask, which its residual shares), then r2 twice (the FFN's hidden
    layer, its residual); a transformer decoder layer r1, r2 (the
    attention residuals), then r3 twice.  The biLSTM encoder and the RNN
    decoder draw nothing, nor does a rate of 0."""
    if rng is None or cfg.dropout <= 0.0:
        return []
    keys = []
    if cfg.encoder_type == "transformer":
        for r1, r2 in enc.dropout_keys(cfg, rng):
            keys += [r1, r2, r2]
    if cfg.decoder_type == "transformer":
        for r1, r2, r3 in dec.dropout_keys(cfg, rng):
            keys += [r1, r2, r3, r3]
    return keys


def init_decode_state(params, cfg: ModelConfig, memory: torch.Tensor,
                      mem_lengths: torch.Tensor, beam_k: int = 1) -> dict[str, Any]:
    """Decode state for the (B, S, D) memory bank.  beam_k > 1 (transformer
    only): B * beam_k chunk-major decode rows sharing each chunk's cross
    K/V; the RNN decoder's beam search tiles the memory bank instead."""
    if cfg.decoder_type == "rnn":
        if beam_k != 1:
            raise ValueError("beam-grouped decode state is transformer-only")
        return dec.init_rnn_state(cfg, memory, mem_lengths, memory.shape[0], memory.dtype)
    return dec.init_transformer_cache(params["decoder"], cfg, memory,
                                      mem_lengths, memory.shape[0], memory.dtype,
                                      beam_k=beam_k)


def reorder_decode_state_beam(state: dict[str, Any],
                              beam_origin: torch.Tensor) -> dict[str, Any]:
    """Gather the path-dependent state by beam origin: the self caches of a
    transformer decoder, the hidden, cell and input-feed state of an RNN
    decoder.  beam_origin: (B, K) int, the within-chunk origin beam of
    each new beam.  Cross K/V, the (tiled) memory bank and masks are
    beam-invariant and stay as they are.  The gathers make fresh tensors,
    so the decode steps' in-place writes (K2 into self_kv, the staged
    block, the per-layer caches) never reach an earlier alias."""
    bsz, k = beam_origin.shape
    flat = (torch.arange(bsz, device=beam_origin.device)[:, None] * k
            + beam_origin.long()).reshape(-1)
    if "hidden" in state:
        return {**state, "input_feed": state["input_feed"].index_select(0, flat),
                "hidden": [{"h": hc["h"].index_select(0, flat),
                            "c": hc["c"].index_select(0, flat)}
                           for hc in state["hidden"]]}
    if "self_kv" in state:
        return {**state, "self_kv": state["self_kv"].index_select(0, flat),
                "self_kv_stage": state["self_kv_stage"].index_select(0, flat)}
    return {**state, "layers": [
        {**cache, "self_k": cache["self_k"].index_select(0, flat),
         "self_v": cache["self_v"].index_select(0, flat)}
        for cache in state["layers"]]}


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor,
                  position: int | None = None) -> torch.Tensor:
    """tokens (B, T) -> (B, T, D): embedding * sqrt(d), plus for a
    transformer decoder the positional encoding, rows 0..T-1, or row
    `position` for a one-token step (the RNN decoder gets none)."""
    dtype = compute_dtype(cfg)
    y = nn.embed(params["tgt_embed"], tokens, dtype)
    # sqrt(d) rounded to the compute dtype on the host, as a 0-d tensor of
    # that dtype would hold it, then multiplied as a Python scalar: no copy
    # to the device, which would wait for the stream.
    y = y * torch.tensor(math.sqrt(float(cfg.d_model)), dtype=dtype).item()
    if cfg.decoder_type == "rnn":
        return y
    pe = nn.sinusoidal_positions(cfg.max_decode_len + 1, cfg.d_model,
                                 y.device).to(dtype)
    if position is None:
        return y + pe[None, :tokens.shape[1], :]
    return y + pe[position][None, None, :]


def generator_log_probs(params, hidden: torch.Tensor) -> torch.Tensor:
    """hidden (..., D) -> vocab log-probs, f32."""
    gen = params["generator"]
    return torch.log_softmax(hidden.to(torch.float32) @ gen["w"] + gen["b"], dim=-1)


def decode_teacher_forced(params, cfg: ModelConfig, tgt_in: torch.Tensor,
                          memory: torch.Tensor, mem_lengths: torch.Tensor,
                          rng=None, train: bool = False, row0: int = 0):
    """Full teacher-forced decode: tgt_in (B, T) int (BOS-prefixed) ->
    (log-probs (B, T, V) f32, the last layer's cross-attention probs
    (B, H, T, S) f32; H = 1 for the RNN decoder's Luong attention, which
    drops nothing out).  `rng` and `row0` as `encode`'s: the JAX package
    passes encode and this one the same key."""
    y = _embed_tokens(params, cfg, tgt_in)
    if cfg.decoder_type == "rnn":
        hidden, attn = dec.rnn_decoder_forced(params["decoder"], cfg, y, memory,
                                              mem_lengths)
        return generator_log_probs(params, hidden), attn
    hidden, attn = dec.transformer_decoder_forced(params["decoder"], cfg, y, memory,
                                                  mem_lengths, rng, train, row0)
    return generator_log_probs(params, hidden), attn


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                state: dict[str, Any], return_attn: bool = False):
    """One decode step.  tokens: (B,) int current input tokens.
    Returns (log_probs (B, V) f32, attn_pos (B,) int32 — the last layer's
    cross-attention argmax over encoder positions (the RNN decoder's:
    of its f32 Luong probabilities, ties to the lowest position) — and
    the new state).

    With return_attn, returns (log_probs, attn_pos, attn_mean (B, S) f32,
    new state): attn_mean is the head mean of the last layer's
    cross-attention probabilities, taken in f32 (the RNN decoder's Luong
    probabilities), which the beam coverage penalty accumulates.  The
    kernels never materialise the probabilities, so a transformer step
    then runs unfolded (over per-layer self caches, from
    init_decode_state with lean_step false) with use_pallas false."""
    y1 = _embed_tokens(params, cfg, tokens[:, None], state["step"])
    if cfg.decoder_type == "rnn":
        hidden, probs, new_state = dec.rnn_decoder_step(params["decoder"], cfg, y1, state)
        attn_mean = probs[:, 0, 0, :]
        attn_pos = attn_mean.argmax(dim=-1).to(torch.int32)
        log_probs = generator_log_probs(params, hidden[:, 0, :])
        if return_attn:
            return log_probs, attn_pos, attn_mean, new_state
        return log_probs, attn_pos, new_state
    if cfg.lean_step and not return_attn:
        if "_lean" not in params:
            raise ValueError(_NOT_FOLDED)
        lean = params["_lean"]
        hidden, attn_pos, new_state = dec._transformer_decoder_step_lean(
            lean, cfg, y1, state)
        logits = hidden[:, 0, :].to(torch.float32) @ lean["gen_w"] + lean["gen_b"]
        return torch.log_softmax(logits, dim=-1), attn_pos, new_state
    scfg = dataclasses.replace(cfg, use_pallas=False) if return_attn else cfg
    hidden, (probs, amax), new_state = dec.transformer_decoder_step(
        params["decoder"], scfg, y1, state)
    log_probs = generator_log_probs(params, hidden[:, 0, :])
    if probs is None:
        return log_probs, amax, new_state
    attn_mean = dec._head_mean(probs)
    attn_pos = attn_mean.argmax(dim=-1).to(torch.int32)
    if return_attn:
        return log_probs, attn_pos, attn_mean, new_state
    return log_probs, attn_pos, new_state
