"""Signal encoder: conv front-end + transformer or biLSTM body.

The port's counterpart of `nanodecoder_tpu.models.encoder`:
`init_encoder`, `conv_frontend`, `transformer_encoder` and
`encoder_apply` (the unfolded transformer body, which projects q, k and v apart;
for inference with `use_pallas` it calls kernel K5 for the attention,
while a training pass (`train=True`) always takes the differentiable
`mha`, as the JAX package's does, since the kernels have no backward),
and `fold_encoder_lean`,
`transformer_encoder_lean` and `encoder_apply_lean` (the lean body, which
folds each layer norm's affine into the matmul after it, runs one fused
QKV projection per layer, and calls kernel K1).  With `use_pallas` false
both bodies take `attention_core` with the length mask instead, as the
JAX package's XLA path does.

The biLSTM body (`encoder_type` "lstm": `init_lstm_encoder`,
`lstm_encoder`) is plain PyTorch on every device and never folded, as in
the JAX package; it applies no dropout.  Each layer hoists the input
projection of both directions out of the time loop (one GEMM per
direction, bias included) and runs the two directions together, one
batched matmul a step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nanodecoder_tpu_torch import prng
from nanodecoder_tpu_torch.config import ModelConfig
from nanodecoder_tpu_torch.models import modules as nn
from nanodecoder_tpu_torch.models.decoder import _fold_ln_dense, _ln_normalize
from nanodecoder_tpu_torch.models.modules import init_lstm_cell, lstm_gates
from nanodecoder_tpu_torch.ops.encoder_attention import (flash_encoder_attention_nld,
                                                         flash_encoder_attention_qkv)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def init_conv_frontend(key, cfg: ModelConfig, device: torch.device | str = "cpu"):
    """Conv weights drawn over the JAX package's (W, I, O) shape (its fan
    rule and its draw) and stored as torch's (O, I, W)."""
    keys = prng.split(key, len(cfg.conv_channels) + 1)
    layers = []
    in_ch = 1
    for k, ch, ker in zip(keys, cfg.conv_channels, cfg.conv_kernels):
        w = nn.glorot(k, (ker, in_ch, ch), device).permute(2, 1, 0).contiguous()
        layers.append({"w": w, "b": torch.zeros((ch,), dtype=torch.float32,
                                                device=device)})
        in_ch = ch
    return {"convs": layers, "proj": nn.init_dense(keys[-1], in_ch, cfg.d_model,
                                                   device=device),
            "ln": nn.init_layer_norm(cfg.d_model, device)}


def init_transformer_encoder(key, cfg: ModelConfig, device: torch.device | str = "cpu"):
    d = cfg.d_model
    layers = []
    for k in prng.split(key, cfg.enc_layers):
        k1, k2 = prng.split(k)
        layers.append({"ln1": nn.init_layer_norm(d, device),
                       "attn": nn.init_mha(k1, d, cfg.enc_heads, device=device),
                       "ln2": nn.init_layer_norm(d, device),
                       "ffn": nn.init_ffn(k2, d, cfg.enc_ffn_dim, device)})
    return {"layers": layers, "ln_out": nn.init_layer_norm(d, device)}


def init_lstm_encoder(key, cfg: ModelConfig, device: torch.device | str = "cpu"):
    """Stacked biLSTM: per layer a fwd and a bwd cell over d_model inputs
    and a (2H, D) projection of their concatenated outputs."""
    d, hdim = cfg.d_model, cfg.lstm_hidden
    layers = []
    for k in prng.split(key, cfg.enc_layers):
        kf, kb, kp = prng.split(k, 3)
        layers.append({"fwd": init_lstm_cell(kf, d, hdim, device),
                       "bwd": init_lstm_cell(kb, d, hdim, device),
                       "proj": nn.init_dense(kp, 2 * hdim, d, device=device)})
    return {"layers": layers, "ln_out": nn.init_layer_norm(d, device)}


def init_encoder(key, cfg: ModelConfig, device: torch.device | str = "cpu"):
    """Front-end and body from the first two of three keys split from
    `key` (the third goes unused, as in the JAX package)."""
    bodies = {"transformer": init_transformer_encoder, "lstm": init_lstm_encoder}
    if cfg.encoder_type not in bodies:
        raise ValueError(f"unknown encoder_type {cfg.encoder_type!r}")
    k1, k2, _k3 = prng.split(key, 3)
    return {"frontend": init_conv_frontend(k1, cfg, device),
            "body": bodies[cfg.encoder_type](k2, cfg, device)}


def conv_frontend(p, cfg: ModelConfig, signal: torch.Tensor,
                  lengths: torch.Tensor):
    """signal: (B, S) float; lengths: (B,) valid samples.
    Returns (x (B, S', d_model), out_lengths), S' = ceil(S / prod(strides)).
    Conv weights are torch's (O, I, W); each layer pads k//2 on both
    sides and keeps ceil(length / stride) valid positions."""
    dtype = compute_dtype(cfg)
    x = signal.to(dtype)[:, None, :]  # (B, 1, S)
    out_lengths = lengths
    for layer, stride in zip(p["convs"], cfg.conv_strides):
        w = layer["w"].to(dtype)
        k = w.shape[2]
        x = F.conv1d(x, w, stride=stride, padding=k // 2)
        x = torch.relu(x + layer["b"].to(dtype)[None, :, None])
        out_lengths = torch.div(out_lengths + (stride - 1), stride,
                                rounding_mode="floor")
    x = nn.dense(p["proj"], x.transpose(1, 2))
    x = nn.layer_norm(p["ln"], x)
    return x, out_lengths


def dropout_keys(cfg: ModelConfig, rng) -> list[tuple]:
    """The transformer encoder's dropout keys under `rng`, (r1, r2) a
    layer: rng, r1, r2 = split(rng, 3) in turn, as the JAX package splits."""
    keys = []
    for _ in range(cfg.enc_layers):
        rng, r1, r2 = prng.split(rng, 3)
        keys.append((r1, r2))
    return keys


def transformer_encoder(p, cfg: ModelConfig, x: torch.Tensor,
                        enc_lengths: torch.Tensor, rng=None, train: bool = False,
                        row0: int = 0) -> torch.Tensor:
    """Pre-norm transformer over the master weights.
    x: (B, T, D) in the compute dtype; returns the memory bank (B, T, D),
    zero at padded positions.  Training (`train` with a key) drops out the
    attention output, each residual branch and the FFN's hidden layer with
    the JAX package's keys: per layer rng, r1, r2 = split(rng, 3); r1 for
    the attention output and its residual (the same mask, drawn once: one
    flat count and row length), r2 for the FFN's hidden layer and its
    residual.  `row0`: the first row of x in the global batch (a
    data-parallel rank's).  K5 runs only for inference with `use_pallas`."""
    b, t, d = x.shape
    valid = nn.length_mask(enc_lengths, t)
    attn_mask = valid[:, None, None, :]
    lengths32 = enc_lengths.to(torch.int32).contiguous()
    rate = cfg.dropout
    keys = dropout_keys(cfg, rng) if train and rng is not None else \
        [(None, None)] * len(p["layers"])
    for layer, (r1, r2) in zip(p["layers"], keys):
        m1 = nn.dropout_mask(r1, rate, (b, t, d), x.device, row0)
        h = nn.layer_norm(layer["ln1"], x)
        ap = layer["attn"]
        if cfg.use_pallas and not train:
            ctx = flash_encoder_attention_nld(nn.dense(ap["q"], h), nn.dense(ap["k"], h),
                                              nn.dense(ap["v"], h), lengths32,
                                              cfg.enc_heads)
            a = nn.dense(ap["o"], ctx)
        else:
            a, _ = nn.mha(ap, cfg.enc_heads, h, h, attn_mask, rate, r1, train,
                          drop_mask=m1)
        x = x + nn.dropout(a, rate, r1, train, mask=m1)
        f = nn.ffn(layer["ffn"], nn.layer_norm(layer["ln2"], x), rate, r2, train, row0)
        x = x + nn.dropout(f, rate, r2, train, row0)
    x = nn.layer_norm(p["ln_out"], x)
    return x * valid[:, :, None].to(x.dtype)


def _add_positions(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    pe = nn.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    return x + pe[None, :, :]


def _bilstm_layer(layer, xs: torch.Tensor) -> torch.Tensor:
    """Both directions of one layer over xs (T, B, D): the forward cell
    from t = 0, the backward cell from t = T - 1 over the whole buffer
    (padding included), each from zero state.  Returns (T, B, 2H), the
    forward then the backward output at each t."""
    t, b, _ = xs.shape
    dt = xs.dtype
    fwd, bwd = layer["fwd"], layer["bwd"]
    # The input projections of all steps in one GEMM per direction (the
    # bias added here, once), the backward one in its scan order.
    xw = torch.stack([(xs @ fwd["wx"].to(dt) + fwd["b"].to(dt)),
                      (xs @ bwd["wx"].to(dt) + bwd["b"].to(dt)).flip(0)])
    wh = torch.stack([fwd["wh"].to(dt), bwd["wh"].to(dt)])       # (2, H, 4H)
    h = xs.new_zeros((2, b, wh.shape[1]))
    c = torch.zeros_like(h)
    hs = []
    for s in range(t):
        h, c = lstm_gates(torch.baddbmm(xw[:, s], h, wh), c)
        hs.append(h)
    ys = torch.stack(hs)                                           # (T, 2, B, H)
    return torch.cat([ys[:, 0], ys[:, 1].flip(0)], dim=-1)


def lstm_encoder(p, x: torch.Tensor, enc_lengths: torch.Tensor) -> torch.Tensor:
    """biLSTM body: x (B, T, D) in the compute dtype -> memory bank
    (B, T, D).  Padded positions are zeroed on the input of every layer;
    each layer's two directions are concatenated and projected back to
    D; the output goes through ln_out and is zeroed at padded positions.
    (pack_padded_sequence would start each row's backward pass at its own
    last valid step: a different function.)"""
    valid = nn.length_mask(enc_lengths, x.shape[1])
    vmask = valid.T[:, :, None].to(x.dtype)                        # (T, B, 1)
    xs = x.transpose(0, 1)
    for layer in p["layers"]:
        xs = nn.dense(layer["proj"], _bilstm_layer(layer, xs * vmask))
    out = nn.layer_norm(p["ln_out"], xs.transpose(0, 1))
    return out * valid[:, :, None].to(out.dtype)


def encoder_apply(p, cfg: ModelConfig, signal: torch.Tensor, lengths: torch.Tensor,
                  rng=None, train: bool = False, row0: int = 0):
    """Unfolded encoder: conv front-end + transformer body (positional
    encoding added first) or biLSTM body (none, and no dropout).
    Returns (memory (B, T, D), enc_lengths (B,))."""
    x, enc_lengths = conv_frontend(p["frontend"], cfg, signal, lengths)
    if cfg.encoder_type == "lstm":
        return lstm_encoder(p["body"], x, enc_lengths), enc_lengths
    return transformer_encoder(p["body"], cfg, _add_positions(x, cfg),
                               enc_lengths, rng, train, row0), enc_lengths


def fold_encoder_lean(p_enc, cfg: ModelConfig, dtype: torch.dtype):
    """Encoder params -> pre-folded serving weights in `dtype`."""
    fe = p_enc["frontend"]
    frontend = {
        "convs": [{"w": l["w"].to(dtype), "b": l["b"].to(dtype)}
                  for l in fe["convs"]],
        "proj": {"w": fe["proj"]["w"].to(dtype), "b": fe["proj"]["b"].to(dtype)},
        # The front-end LN affine cannot fold forward: the positional
        # encoding is added between it and layer 1's ln1.
        "ln": fe["ln"],
    }
    layers = []
    for layer in p_enc["body"]["layers"]:
        ap, ff = layer["attn"], layer["ffn"]
        wq, bq = _fold_ln_dense(layer["ln1"], ap["q"], dtype)
        wk, bk = _fold_ln_dense(layer["ln1"], ap["k"], dtype)
        wv, bv = _fold_ln_dense(layer["ln1"], ap["v"], dtype)
        wf1, bf1 = _fold_ln_dense(layer["ln2"], ff["in"], dtype)
        layers.append({
            "w_qkv": torch.cat([wq, wk, wv], dim=1),
            "b_qkv": torch.cat([bq, bk, bv]),
            "o": {"w": ap["o"]["w"].to(dtype), "b": ap["o"]["b"].to(dtype)},
            "w_f1": wf1, "b_f1": bf1,
            "w_f2": ff["out"]["w"].to(dtype),
            "b_f2": ff["out"]["b"].to(dtype),
        })
    return {"frontend": frontend, "layers": layers,
            "ln_out": p_enc["body"]["ln_out"]}


def transformer_encoder_lean(lean, cfg: ModelConfig, x: torch.Tensor,
                             enc_lengths: torch.Tensor) -> torch.Tensor:
    """Pre-norm transformer over folded weights.  x: (B, T, D) in the
    compute dtype; returns the memory bank (B, T, D), zero at padded
    positions."""
    t, d = x.shape[1], cfg.d_model
    valid = nn.length_mask(enc_lengths, t)
    attn_mask = valid[:, None, None, :]
    lengths32 = enc_lengths.to(torch.int32).contiguous()
    for layer in lean["layers"]:
        h = _ln_normalize(x)
        qkv = h @ layer["w_qkv"] + layer["b_qkv"]   # (B, T, 3D) one matmul
        if cfg.use_pallas:
            ctx = flash_encoder_attention_qkv(qkv, lengths32, cfg.enc_heads)
        else:
            q, k, v = (nn._split_heads(qkv[..., i * d:(i + 1) * d], cfg.enc_heads)
                       for i in range(3))
            ctx = nn._merge_heads(nn.attention_core(q, k, v, attn_mask)[0])
        x = x + nn.dense(layer["o"], ctx)
        h = _ln_normalize(x)
        x = x + torch.relu(h @ layer["w_f1"] + layer["b_f1"]) @ layer["w_f2"] \
            + layer["b_f2"]
    x = nn.layer_norm(lean["ln_out"], x)
    return x * valid[:, :, None].to(x.dtype)


def encoder_apply_lean(lean, cfg: ModelConfig, signal: torch.Tensor,
                       lengths: torch.Tensor):
    """Folded-weights serving encoder: conv front-end + lean body.
    Returns (memory (B, T, D), enc_lengths (B,))."""
    x, enc_lengths = conv_frontend(lean["frontend"], cfg, signal, lengths)
    return transformer_encoder_lean(lean, cfg, _add_positions(x, cfg),
                                    enc_lengths), enc_lengths
