"""Decoders: the transformer decoder (the teacher-forced training pass,
and decode steps lean (one combined self cache) and unfolded (per-layer
self caches)) and the input-feed RNN decoder with Luong attention.

The port's counterpart of `nanodecoder_tpu.models.decoder`:
`init_transformer_decoder`, `transformer_decoder_forced`,
`init_transformer_cache`, `_attn_step`, `_ln_normalize`, `_fold_ln_dense`,
`fold_lean_params`, `_transformer_decoder_step_lean` and
`transformer_decoder_step` for transformers; `init_global_attention`,
`global_attention`, `init_rnn_decoder`, `init_rnn_state`,
`rnn_decoder_step` and `rnn_decoder_forced` for the RNN decoder
(`decoder_type` "rnn"), which is plain PyTorch on every device, never
folded, and applies no dropout, as in the JAX package.

Decode state (a dict, like the JAX package's), for B chunks decoded in
R = B * beam_k rows (row b * beam_k + j is beam j of chunk b):
  layers:        per layer {cross_k, cross_v} (B, S, Hk, Dh), projected
                 once; with cross_cache_int8 they are int8 and the layer
                 also holds cross_k_scale, cross_v_scale (B, Hk * Dh) f32;
                 unfolded (lean_step false): also self_k, self_v
                 (R, T, Hk, Dh), written at `step` in place
  cross_mask:    (B, 1, 1, S) bool
  mem_lengths:   (B,) int32
  step:          host int, the position being decoded
  lean only:
  self_kv:       (R, T, C_pad) every layer's [K|V] row for each position,
                 C = layers * 2 * Hk * Dh padded up to a multiple of 128
  self_kv_stage: (R, 8, C_pad) rows of the aligned 8-step block holding
                 `step`, flushed into self_kv by kernel K2 every step

Cross K/V and masks stay per chunk: the beams of a chunk share them.
With `use_pallas`, cross attention of an MHA model (Hk == H) runs kernel
K4a (one row per chunk) or K4b (the beams of a chunk against its one
cache row); GQA/MQA, and every model with `use_pallas` false, runs plain
PyTorch, over dequantized caches when they are int8.

The steps update their self caches (on the card) in place and return the
new state dict.

RNN decode state, for R rows (beam search tiles the memory bank K times,
row b * K + j):
  hidden:      per layer {h, c} (R, D)
  input_feed:  (R, D), the previous step's attention output
  memory:      (R, S, D); mem_mask (R, S) bool
  step:        host int
"""

from __future__ import annotations

import math
from typing import Any

import torch

from nanodecoder_tpu_torch import prng
from nanodecoder_tpu_torch.config import ModelConfig
from nanodecoder_tpu_torch.models import modules as nn
from nanodecoder_tpu_torch.ops.attention import (decode_attention,
                                                 decode_attention_grouped,
                                                 dequantize_cache_int8,
                                                 quantize_cache_int8)
from nanodecoder_tpu_torch.ops.cache_update import BLOCK, write_cache_block


def init_transformer_decoder(key, cfg: ModelConfig, device: torch.device | str = "cpu"):
    d = cfg.d_model
    layers = []
    for k in prng.split(key, cfg.dec_layers):
        k1, k2, k3 = prng.split(k, 3)
        layers.append({"ln1": nn.init_layer_norm(d, device),
                       "self_attn": nn.init_mha(k1, d, cfg.dec_heads, cfg.dec_kv, device),
                       "ln2": nn.init_layer_norm(d, device),
                       "cross_attn": nn.init_mha(k2, d, cfg.dec_heads, cfg.dec_kv, device),
                       "ln3": nn.init_layer_norm(d, device),
                       "ffn": nn.init_ffn(k3, d, cfg.dec_ffn_dim, device)})
    return {"layers": layers, "ln_out": nn.init_layer_norm(d, device)}


def dropout_keys(cfg: ModelConfig, rng) -> list[tuple]:
    """The transformer decoder's dropout keys under `rng`, (r1, r2, r3) a
    layer: rng, r1, r2, r3 = split(rng, 4) in turn, as the JAX package
    splits."""
    keys = []
    for _ in range(cfg.dec_layers):
        rng, r1, r2, r3 = prng.split(rng, 4)
        keys.append((r1, r2, r3))
    return keys


def transformer_decoder_forced(p, cfg: ModelConfig, y: torch.Tensor,
                               memory: torch.Tensor, mem_lengths: torch.Tensor,
                               rng=None, train: bool = False, row0: int = 0):
    """Teacher-forced full-sequence pass; differentiable, no kernel.
    y: (B, T, D) embedded target inputs; memory: (B, S, D).  Causal self
    attention, cross attention under the memory's length mask, each with
    `dec_kv` KV heads; training drops out each residual branch and the
    FFN's hidden layer (not the attention outputs, as in the JAX package),
    with per layer rng, r1, r2, r3 = split(rng, 4): r1 and r2 for the
    attention residuals, r3 for the FFN's hidden layer and its residual.
    `row0`: the first row of y in the global batch.
    Returns (hidden (B, T, D), the last layer's cross-attention probs
    (B, H, T, S) f32, still on the graph)."""
    t, s = y.shape[1], memory.shape[1]
    self_mask = nn.causal_mask(t, y.device)
    cross_mask = nn.length_mask(mem_lengths, s)[:, None, None, :]
    rate = cfg.dropout
    probs = None
    keys = dropout_keys(cfg, rng) if train and rng is not None else \
        [(None, None, None)] * len(p["layers"])
    for layer, (r1, r2, r3) in zip(p["layers"], keys):
        h = nn.layer_norm(layer["ln1"], y)
        a, _ = nn.mha(layer["self_attn"], cfg.dec_heads, h, h, self_mask,
                      kv_heads=cfg.dec_kv)
        y = y + nn.dropout(a, rate, r1, train, row0)
        h = nn.layer_norm(layer["ln2"], y)
        a, probs = nn.mha(layer["cross_attn"], cfg.dec_heads, h, memory, cross_mask,
                          kv_heads=cfg.dec_kv)
        y = y + nn.dropout(a, rate, r2, train, row0)
        f = nn.ffn(layer["ffn"], nn.layer_norm(layer["ln3"], y), rate, r3, train, row0)
        y = y + nn.dropout(f, rate, r3, train, row0)
    return nn.layer_norm(p["ln_out"], y), probs


def init_transformer_cache(p, cfg: ModelConfig, memory: torch.Tensor,
                           mem_lengths: torch.Tensor, batch: int,
                           dtype: torch.dtype, beam_k: int = 1) -> dict[str, Any]:
    """Project the cross K/V of every layer once (per chunk), quantized to
    int8 with cross_cache_int8, and allocate the zeroed self caches of
    length max_decode_len for batch * beam_k decode rows: one combined
    cache on the lean path, per-layer caches otherwise."""
    tmax = cfg.max_decode_len
    hk, dh = cfg.dec_kv, cfg.d_model // cfg.dec_heads
    rows = batch * beam_k
    dev = memory.device
    combined = cfg.lean_step
    if combined and tmax % BLOCK:
        raise ValueError(f"max_decode_len must be a multiple of {BLOCK}; got {tmax}")
    layers = []
    for layer in p["layers"]:
        ck, cv = nn.mha_project_kv(layer["cross_attn"], cfg.dec_heads, memory,
                                   kv_heads=hk)
        entry = {} if combined else {
            "self_k": torch.zeros((rows, tmax, hk, dh), dtype=dtype, device=dev),
            "self_v": torch.zeros((rows, tmax, hk, dh), dtype=dtype, device=dev),
        }
        if cfg.cross_cache_int8:
            b_, s_ = ck.shape[:2]
            kq, ks = quantize_cache_int8(ck.reshape(b_, s_, hk * dh))
            vq, vs = quantize_cache_int8(cv.reshape(b_, s_, hk * dh))
            entry.update(cross_k=kq.reshape(ck.shape), cross_v=vq.reshape(cv.shape),
                         cross_k_scale=ks, cross_v_scale=vs)
        else:
            entry.update(cross_k=ck, cross_v=cv)
        layers.append(entry)
    s = memory.shape[1]
    state = {
        "layers": layers,
        "cross_mask": nn.length_mask(mem_lengths, s)[:, None, None, :],
        "mem_lengths": mem_lengths.to(torch.int32),
        "step": 0,
    }
    if combined:
        c = len(p["layers"]) * 2 * hk * dh
        c_pad = -(-c // 128) * 128
        state["self_kv"] = torch.zeros((rows, tmax, c_pad), dtype=dtype, device=dev)
        state["self_kv_stage"] = torch.zeros((rows, BLOCK, c_pad), dtype=dtype,
                                             device=dev)
    return state


def _ln_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """layer_norm without the affine (folded into the next matmul);
    statistics in f32."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _fold_ln_dense(ln, dense_p, dtype: torch.dtype):
    """Fold an LN affine into the dense after it:
    layer_norm(x) @ W + b == normalize(x) @ (g * W) + (b_ln @ W + b).
    Returns (w', b') in `dtype`, folded in f32."""
    g = ln["scale"].to(torch.float32)
    bl = ln["bias"].to(torch.float32)
    w = dense_p["w"].to(torch.float32)
    b = dense_p["b"].to(torch.float32) if "b" in dense_p else 0.0
    return (g[:, None] * w).to(dtype), (bl @ w + b).to(dtype)


def fold_lean_params(p_dec, p_gen, cfg: ModelConfig, dtype: torch.dtype):
    """Decoder + generator params -> folded decode-step weights.  The
    generator stays f32 with the ln_out affine folded in."""
    layers = []
    for layer in p_dec["layers"]:
        sa, ca, ff = layer["self_attn"], layer["cross_attn"], layer["ffn"]
        wq, bq = _fold_ln_dense(layer["ln1"], sa["q"], dtype)
        wk, bk = _fold_ln_dense(layer["ln1"], sa["k"], dtype)
        wv, bv = _fold_ln_dense(layer["ln1"], sa["v"], dtype)
        wcq, bcq = _fold_ln_dense(layer["ln2"], ca["q"], dtype)
        wf1, bf1 = _fold_ln_dense(layer["ln3"], ff["in"], dtype)
        layers.append({
            "w_qkv": torch.cat([wq, wk, wv], dim=1),
            "b_qkv": torch.cat([bq, bk, bv]),
            "self_o": {"w": sa["o"]["w"].to(dtype), "b": sa["o"]["b"].to(dtype)},
            "cross_q": {"w": wcq, "b": bcq},
            "cross_o": {"w": ca["o"]["w"].to(dtype), "b": ca["o"]["b"].to(dtype)},
            "w_f1": wf1, "b_f1": bf1,
            "w_f2": ff["out"]["w"].to(dtype),
            "b_f2": ff["out"]["b"].to(dtype),
        })
    gen_w = p_gen["w"].to(torch.float32)
    gw = p_dec["ln_out"]["scale"].to(torch.float32)[:, None] * gen_w
    gb = p_dec["ln_out"]["bias"].to(torch.float32) @ gen_w \
        + p_gen["b"].to(torch.float32)
    return {"layers": layers, "gen_w": gw, "gen_b": gb}


def _attn_step(p, n_heads: int, h: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, mask: torch.Tensor, valid_lens: torch.Tensor,
               use_kernel: bool, k_scale=None, v_scale=None):
    """One-token attention of h (R, 1, D) against a cache (B, T, Hk, Dh).
    R = B * group: the `group` consecutive rows of a chunk share its cache
    row.  k_scale/v_scale ((B, Hk * Dh) f32) mark int8 caches.

    use_kernel and MHA (Hk == H): kernel K4a (group 1) or K4b, which
    return the head-summed attention argmax and no probabilities.
    Otherwise plain PyTorch over the (dequantized) cache: the grouped
    einsum for group > 1, else mha_step.
    Returns (out (R, 1, D), probs (R, H, 1, T) f32 or None, amax (R,) or
    None)."""
    b, t, hk, dh = k_cache.shape
    group = h.shape[0] // b
    d = hk * dh
    if use_kernel and hk == n_heads:
        q = nn.dense(p["q"], h)[:, 0, :]
        kc, vc = k_cache.reshape(b, t, d), v_cache.reshape(b, t, d)
        if group > 1:
            ctx, amax = decode_attention_grouped(q, kc, vc, valid_lens, n_heads, group,
                                                 k_scale, v_scale)
        else:
            ctx, amax = decode_attention(q, kc, vc, valid_lens, n_heads, k_scale,
                                         v_scale)
        return nn.dense(p["o"], ctx[:, None, :]), None, amax
    if k_scale is not None:
        k_cache = dequantize_cache_int8(k_cache.reshape(b, t, d), k_scale,
                                        h.dtype).reshape(b, t, hk, dh)
        v_cache = dequantize_cache_int8(v_cache.reshape(b, t, d), v_scale,
                                        h.dtype).reshape(b, t, hk, dh)
    if group == 1:
        out, probs = nn.mha_step(p, n_heads, h, k_cache, v_cache, mask)
        return out, probs, None
    # Beam-grouped: the cache stays per chunk, only the query carries the
    # beam dim.
    r = n_heads // hk
    q5 = nn.dense(p["q"], h).reshape(b, group, hk, r, dh)
    scores = torch.einsum("bgkrd,btkd->bgkrt", q5.to(torch.float32),
                          k_cache.to(torch.float32))
    # The JAX branch divides by sqrt(dh), a constant that XLA turns into
    # a multiply by its f32 reciprocal: the same scale as attention_core.
    scores = scores * (1.0 / math.sqrt(dh))
    scores = torch.where(mask.reshape(b, 1, 1, 1, t), scores, torch.tensor(
        nn.NEG_INF, dtype=scores.dtype, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bgkrt,btkd->bgkrd", probs.to(v_cache.dtype), v_cache)
    out = nn.dense(p["o"], ctx.reshape(b * group, 1, n_heads * dh))
    return out, probs.reshape(b * group, n_heads, 1, t), None


def _head_mean(probs: torch.Tensor) -> torch.Tensor:
    """probs (R, H, 1, T) -> (R, T) f32 head mean, taken after the upcast."""
    return probs[:, :, 0, :].to(torch.float32).mean(dim=1)


def _head_mean_argmax(probs: torch.Tensor) -> torch.Tensor:
    """probs (R, H, 1, T) -> (R,) int32 argmax of the head mean."""
    return _head_mean(probs).argmax(dim=-1).to(torch.int32)


def _transformer_decoder_step_lean(lean, cfg: ModelConfig, y1: torch.Tensor,
                                   state: dict[str, Any]):
    """One-token decode over folded weights.  y1: (B, 1, D) embedded
    token.  Returns (hidden (B, 1, D) normalized WITHOUT the ln_out
    affine, which lives in the generator; attn_pos (B,) int32, the last
    layer's cross-attention argmax (head sum from K4a/K4b, head mean
    otherwise); new state)."""
    step = state["step"]
    tmax = cfg.max_decode_len
    b = y1.shape[0]
    nh, dh = cfg.dec_heads, cfg.d_model // cfg.dec_heads
    d = nh * dh
    hk = cfg.dec_kv
    dk = hk * dh
    pos = torch.arange(tmax, device=y1.device)
    self_mask = (pos <= step)[None, None, None, :]
    at_cur = (pos == step)[None, :, None, None]   # broadcasts to (B, T, Hk, Dh)
    kv_read = state["self_kv"]
    n_layers = len(lean["layers"])
    new_rows = []
    amax = None
    for i, (ll, cache) in enumerate(zip(lean["layers"], state["layers"])):
        h = _ln_normalize(y1)
        qkv = h @ ll["w_qkv"] + ll["b_qkv"]                 # (B, 1, D + 2Dk)
        k1 = nn._split_heads(qkv[..., d:d + dk], hk)
        v1 = nn._split_heads(qkv[..., d + dk:], hk)
        k_c = kv_read[:, :, 2 * dk * i:2 * dk * i + dk].reshape(b, tmax, hk, dh)
        v_c = kv_read[:, :, 2 * dk * i + dk:2 * dk * (i + 1)].reshape(b, tmax, hk, dh)
        # The current token's K/V replace row `step` by a select: the same
        # values as writing the cache first.
        k_use = torch.where(at_cur, k1, k_c)
        v_use = torch.where(at_cur, v1, v_c)
        a, _ = nn.attention_core(nn._split_heads(qkv[..., :d], nh), k_use,
                                 v_use, self_mask)
        y1 = y1 + nn.dense(ll["self_o"], nn._merge_heads(a))
        h = _ln_normalize(y1)
        a, probs, am = _attn_step(
            {"q": ll["cross_q"], "o": ll["cross_o"]}, nh, h, cache["cross_k"],
            cache["cross_v"], state["cross_mask"], state["mem_lengths"], cfg.use_pallas,
            cache.get("cross_k_scale"), cache.get("cross_v_scale"))
        if am is not None:
            amax = am
        elif i == n_layers - 1:
            amax = _head_mean_argmax(probs)
        y1 = y1 + a
        h = _ln_normalize(y1)
        y1 = y1 + torch.relu(h @ ll["w_f1"] + ll["b_f1"]) @ ll["w_f2"] + ll["b_f2"]
        new_rows.append(qkv[..., d:])                       # (B, 1, 2Dk)
    # Stage the current aligned 8-step block (rows after `step` zero, the
    # lane pad zero) and flush it into the cache with kernel K2.
    stage = state["self_kv_stage"]
    local = step % BLOCK
    stage[:, local:] = 0
    stage[:, local, :n_layers * 2 * dk] = torch.cat(new_rows, dim=2)[:, 0]
    self_kv = write_cache_block(state["self_kv"], stage, step)
    out = _ln_normalize(y1)
    new_state = {**state, "self_kv": self_kv, "self_kv_stage": stage,
                 "step": step + 1}
    return out, amax, new_state


def transformer_decoder_step(p, cfg: ModelConfig, y1: torch.Tensor,
                             state: dict[str, Any]):
    """One-token decode over the unfolded weights and per-layer self
    caches.  y1: (R, 1, D) embedded token.  Writes this token's self K/V
    into the caches at `step` in place.  Returns (hidden (R, 1, D) after
    ln_out, (probs (R, H, 1, S) f32 or None, amax (R,) or None) of the
    last layer's cross attention, new state)."""
    if "self_kv" in state:
        raise ValueError("state was built for the lean (combined-cache) step")
    step = state["step"]
    hk = cfg.dec_kv
    pos = torch.arange(cfg.max_decode_len, device=y1.device)
    self_mask = (pos <= step)[None, None, None, :]
    probs = amax = None
    for layer, cache in zip(p["layers"], state["layers"]):
        h = nn.layer_norm(layer["ln1"], y1)
        sa = layer["self_attn"]
        cache["self_k"][:, step] = nn._split_heads(nn.dense(sa["k"], h), hk)[:, 0]
        cache["self_v"][:, step] = nn._split_heads(nn.dense(sa["v"], h), hk)[:, 0]
        a, _, _ = _attn_step(sa, cfg.dec_heads, h, cache["self_k"], cache["self_v"],
                             self_mask, None, False)
        y1 = y1 + a
        h = nn.layer_norm(layer["ln2"], y1)
        a, probs, amax = _attn_step(
            layer["cross_attn"], cfg.dec_heads, h, cache["cross_k"], cache["cross_v"],
            state["cross_mask"], state["mem_lengths"], cfg.use_pallas,
            cache.get("cross_k_scale"), cache.get("cross_v_scale"))
        y1 = y1 + a
        h = nn.layer_norm(layer["ln3"], y1)
        y1 = y1 + nn.ffn(layer["ffn"], h)
    out = nn.layer_norm(p["ln_out"], y1)
    return out, (probs, amax), {**state, "step": step + 1}


# ---------------------------------------------------------------------------
# input-feed RNN decoder with Luong attention

LUONG_SCORES = ("dot", "general", "mlp")


def init_global_attention(key, d_model: int, score: str,
                          device: torch.device | str = "cpu"):
    """Luong attention params: `general` has wa (D, D), `mlp` has wq (no
    bias), wk (with bias) and va (D, 1, no bias), `dot` none of them; all
    have wo (2D, D), with a bias only under `mlp`.  Keys as the JAX
    package's: wa from `key` itself, wq/wk/va from split(key, 3), wo from
    fold_in(key, 7)."""
    if score not in LUONG_SCORES:
        raise ValueError(f"unknown attention score {score!r}")
    d = d_model
    p: dict[str, Any] = {}
    if score == "general":
        p["wa"] = nn.init_dense(key, d, d, use_bias=False, device=device)
    elif score == "mlp":
        k1, k2, k3 = prng.split(key, 3)
        p["wq"] = nn.init_dense(k1, d, d, use_bias=False, device=device)
        p["wk"] = nn.init_dense(k2, d, d, device=device)
        p["va"] = nn.init_dense(k3, d, 1, use_bias=False, device=device)
    p["wo"] = nn.init_dense(prng.fold_in(key, 7), 2 * d, d, use_bias=score == "mlp",
                            device=device)
    return p


def global_attention(p, query: torch.Tensor, memory: torch.Tensor,
                     mem_mask: torch.Tensor, score: str = "general"):
    """query (B, D), memory (B, S, D), mem_mask (B, S) bool.  Scores in f32
    (dot and general from f32 operands; mlp computed in the compute dtype,
    then cast), masked to NEG_INF, softmax in f32; the probabilities cast
    to the memory's dtype for the context.  Returns (tanh(wo [ctx ;
    query]) (B, D), probs (B, S) f32)."""
    if score == "dot" or score == "general":
        q = query if score == "dot" else nn.dense(p["wa"], query)
        scores = torch.bmm(memory.to(torch.float32), q.to(torch.float32)[:, :, None])[..., 0]
    elif score == "mlp":
        k = nn.dense(p["wk"], memory)
        scores = nn.dense(p["va"], torch.tanh(nn.dense(p["wq"], query)[:, None, :] + k)
                          )[..., 0].to(torch.float32)
    else:
        raise ValueError(f"unknown attention score {score!r}")
    # A Python scalar: no copy to the device inside the RNN decoder's
    # training pass, which a CUDA graph captures.
    scores = torch.where(mem_mask, scores, nn.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.bmm(probs.to(memory.dtype)[:, None, :], memory)[:, 0]
    return torch.tanh(nn.dense(p["wo"], torch.cat([ctx, query], dim=-1))), probs


def init_rnn_decoder(key, cfg: ModelConfig, device: torch.device | str = "cpu"):
    """dec_layers LSTM cells of width D (the first takes [embedding ;
    input feed], 2D wide) and the Luong attention of `rnn_attention`, from
    split(key, dec_layers + 1) (the attention takes the last key)."""
    d = cfg.d_model
    keys = prng.split(key, cfg.dec_layers + 1)
    layers = [nn.init_lstm_cell(keys[i], 2 * d if i == 0 else d, d, device)
              for i in range(cfg.dec_layers)]
    return {"layers": layers,
            "attn": init_global_attention(keys[-1], d, cfg.rnn_attention, device)}


def init_rnn_state(cfg: ModelConfig, memory: torch.Tensor, mem_lengths: torch.Tensor,
                   batch: int, dtype: torch.dtype) -> dict[str, Any]:
    """Zero hidden, cell and input-feed state for `batch` rows over the
    memory bank (batch, S, D)."""
    dev = memory.device

    def zeros():
        return torch.zeros((batch, cfg.d_model), dtype=dtype, device=dev)

    return {"hidden": [{"h": zeros(), "c": zeros()} for _ in range(cfg.dec_layers)],
            "input_feed": zeros(), "memory": memory,
            "mem_mask": nn.length_mask(mem_lengths, memory.shape[1]), "step": 0}


def _rnn_cells(p, x: torch.Tensor, hidden):
    """Run the stacked cells on x (B, 2D); returns (top h, [(h, c)])."""
    out = []
    for cell, (h, c) in zip(p["layers"], hidden):
        h, c = nn.lstm_cell(cell, x, h, c)
        out.append((h, c))
        x = h
    return x, out


def rnn_decoder_step(p, cfg: ModelConfig, y1: torch.Tensor, state: dict[str, Any]):
    """One input-feed step.  y1: (B, 1, D) embedded token.  Returns
    (attention output (B, 1, D), probs (B, 1, 1, S) f32, new state)."""
    x = torch.cat([y1[:, 0, :], state["input_feed"]], dim=-1)
    top, hidden = _rnn_cells(p, x, [(hc["h"], hc["c"]) for hc in state["hidden"]])
    out, probs = global_attention(p["attn"], top, state["memory"], state["mem_mask"],
                                  cfg.rnn_attention)
    new_state = {**state, "hidden": [{"h": h, "c": c} for h, c in hidden],
                 "input_feed": out, "step": state["step"] + 1}
    return out[:, None, :], probs[:, None, None, :], new_state


def rnn_decoder_forced(p, cfg: ModelConfig, y: torch.Tensor, memory: torch.Tensor,
                       mem_lengths: torch.Tensor):
    """Teacher-forced pass, a loop over time; differentiable, no kernel.
    y: (B, T, D) embedded target inputs.  Returns (hidden (B, T, D), attn
    (B, 1, T, S) f32)."""
    b = y.shape[0]
    state = init_rnn_state(cfg, memory, mem_lengths, b, y.dtype)
    hidden = [(hc["h"], hc["c"]) for hc in state["hidden"]]
    feed, mask = state["input_feed"], state["mem_mask"]
    outs, probs = [], []
    for t in range(y.shape[1]):
        top, hidden = _rnn_cells(p, torch.cat([y[:, t], feed], dim=-1), hidden)
        feed, pr = global_attention(p["attn"], top, memory, mask, cfg.rnn_attention)
        outs.append(feed)
        probs.append(pr)
    return torch.stack(outs, dim=1), torch.stack(probs, dim=1)[:, None]
