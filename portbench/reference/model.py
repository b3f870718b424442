"""The basecaller's plain forward pass: conv front-end, pre-norm
transformer encoder, teacher-forced transformer decoder, generator.

Plain PyTorch over the flat `.npz` parameter names, float32 and no
kernel, importing nothing of the program.  `precision` puts every matrix
product's operands (convolutions, projections, attention's two products,
the generator) through a lower precision while sums, layer norms and
softmax stay float32: "bfloat16", or "float8" (e4m3, one scale per
tensor, as an fp8 GEMM takes it), the control that must fail the
comparison.  `tile_kv_heads` turns the MQA decoder into the same
function in MHA form.  Training passes a threefry key: dropout then
falls where the program's trainer drops, with the same masks.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import threefry

NEG = -1e9
E4M3_MAX = 448.0


def load_flat(path: str, device) -> dict[str, torch.Tensor]:
    with np.load(path) as data:
        return {k: torch.from_numpy(np.asarray(data[k], np.float32)).to(device)
                for k in data.files}


def tile_kv_heads(flat: dict, heads: int) -> dict:
    """Every decoder K/V projection (w (D, Dh), b (Dh,)) tiled across the
    query heads: MHA caches holding one MQA head eight times."""
    out = dict(flat)
    for key, arr in flat.items():
        if key.startswith("decoder/layers/") and ("_attn/k/" in key or "_attn/v/" in key):
            reps = (1,) * (arr.ndim - 1) + (heads,)
            out[key] = (np.tile(arr, reps) if isinstance(arr, np.ndarray)
                        else arr.repeat(*reps))
    return out


class Ref:
    """One forward-pass configuration: parameters, widths and precision."""

    def __init__(self, flat: dict[str, torch.Tensor], model: dict, precision="float32",
                 dropout: float = 0.0):
        self.p = flat
        self.m = model
        self.precision = precision
        self.rate = dropout

    # -- arithmetic ---------------------------------------------------
    def rnd(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "float32":
            return x
        if self.precision == "bfloat16":
            return x.to(torch.bfloat16).to(torch.float32)
        if self.precision == "float8":
            scale = x.detach().abs().amax().clamp_min(1e-12) / E4M3_MAX
            return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        raise ValueError(f"unknown precision {self.precision!r}")

    def mm(self, a, b):
        return self.rnd(a) @ self.rnd(b)

    def dense(self, name, x):
        y = self.mm(x, self.p[name + "/w"])
        b = self.p.get(name + "/b")
        return y if b is None else y + b

    def ln(self, name, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-6) * self.p[name + "/scale"] \
            + self.p[name + "/bias"]

    def drop(self, x, key, mask=None):
        """Inverted dropout at rate `self.rate` where a key is given: the
        keep mask drawn from `key` over x's flat count, x times the float32
        reciprocal of keep."""
        if key is None or self.rate <= 0.0:
            return x
        if mask is None:
            mask = threefry.bernoulli(key, 1.0 - self.rate, x.shape, x.device)
        keep = float(np.float32(1.0 - self.rate))
        inv = float(np.float32(1.0) / np.float32(keep))
        return torch.where(mask.reshape(x.shape), x * inv, torch.zeros_like(x))

    def attend(self, q, k, v, mask):
        """q (B, Tq, H, Dh), k/v (B, Tk, Hk, Dh), each KV head serving a
        contiguous group of query heads; mask broadcasts to (B, H, Tq, Tk).
        Returns (out (B, Tq, H, Dh), probs (B, H, Tq, Tk))."""
        h, hk = q.shape[2], k.shape[2]
        if hk != h:
            k = k.repeat_interleave(h // hk, dim=2)
            v = v.repeat_interleave(h // hk, dim=2)
        scores = self.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) \
            * (1.0 / math.sqrt(q.shape[3]))
        scores = torch.where(mask, scores, torch.full_like(scores, NEG))
        probs = torch.softmax(scores, dim=-1)
        return self.mm(probs, v.transpose(1, 2)).transpose(1, 2), probs

    def mha(self, name, x, kv, heads, mask, out_key=None):
        d = x.shape[-1]
        dh = d // heads
        q = self.dense(name + "/q", x).reshape(*x.shape[:2], heads, dh)
        k = self.dense(name + "/k", kv)
        v = self.dense(name + "/v", kv)
        hk = k.shape[-1] // dh
        k = k.reshape(*kv.shape[:2], hk, dh)
        v = v.reshape(*kv.shape[:2], hk, dh)
        out, probs = self.attend(q, k, v, mask)
        out = self.drop(out.reshape(*x.shape[:2], d), out_key[0] if out_key else None,
                        out_key[1] if out_key else None)
        return self.dense(name + "/o", out), probs

    # -- the model ----------------------------------------------------
    def encode(self, signal, lengths, key=None):
        """signal (B, S) f32, lengths (B,) -> (memory (B, T, D), enc lengths)."""
        m = self.m
        x = signal[:, None, :]
        lens = lengths.to(torch.int64)
        for i, stride in enumerate(m["conv_strides"]):
            w = self.p[f"encoder/frontend/convs/{i}/w"].permute(2, 1, 0)
            x = F.conv1d(self.rnd(x), self.rnd(w), stride=stride, padding=w.shape[2] // 2)
            x = torch.relu(x + self.p[f"encoder/frontend/convs/{i}/b"][None, :, None])
            lens = torch.div(lens + stride - 1, stride, rounding_mode="floor")
        x = self.ln("encoder/frontend/ln", self.dense("encoder/frontend/proj", x.transpose(1, 2)))
        t, d = x.shape[1], x.shape[2]
        x = x + positions(t, d, x.device)[None]
        valid = torch.arange(t, device=x.device)[None, :] < lens[:, None]
        mask = valid[:, None, None, :]
        for i in range(m["enc_layers"]):
            pre = f"encoder/body/layers/{i}"
            r1 = r2 = m1 = None
            if key is not None:
                key, r1, r2 = threefry.split(key, 3)
                m1 = threefry.bernoulli(r1, 1.0 - self.rate, x.shape, x.device)
            a, _ = self.mha(pre + "/attn", self.ln(pre + "/ln1", x),
                            self.ln(pre + "/ln1", x), m["enc_heads"], mask,
                            out_key=(r1, m1) if key is not None else None)
            x = x + self.drop(a, r1, m1)
            f = self.ffn(pre + "/ffn", self.ln(pre + "/ln2", x), r2)
            x = x + self.drop(f, r2)
        x = self.ln("encoder/body/ln_out", x)
        return x * valid[:, :, None], lens

    def ffn(self, name, x, key=None):
        return self.dense(name + "/out", self.drop(torch.relu(self.dense(name + "/in", x)), key))

    def decode(self, tgt_in, memory, mem_lens, key=None):
        """Teacher-forced: tgt_in (B, T) -> (log-probs (B, T, V) f32, the
        last layer's cross-attention probs (B, H, T, S))."""
        m = self.m
        d = memory.shape[2]
        t, s = tgt_in.shape[1], memory.shape[1]
        y = self.p["tgt_embed/table"][tgt_in] * math.sqrt(d)
        y = y + positions(m["max_decode_len"] + 1, d, y.device)[None, :t]
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=y.device))[None, None]
        cross = (torch.arange(s, device=y.device)[None, :] < mem_lens[:, None])[:, None, None, :]
        probs = None
        for i in range(m["dec_layers"]):
            pre = f"decoder/layers/{i}"
            r1 = r2 = r3 = None
            if key is not None:
                key, r1, r2, r3 = threefry.split(key, 4)
            h = self.ln(pre + "/ln1", y)
            a, _ = self.mha(pre + "/self_attn", h, h, m["dec_heads"], causal)
            y = y + self.drop(a, r1)
            a, probs = self.mha(pre + "/cross_attn", self.ln(pre + "/ln2", y), memory,
                                m["dec_heads"], cross)
            y = y + self.drop(a, r2)
            y = y + self.drop(self.ffn(pre + "/ffn", self.ln(pre + "/ln3", y), r3), r3)
        h = self.ln("decoder/ln_out", y)
        return torch.log_softmax(self.dense("generator", h), dim=-1), probs


def positions(n: int, d: int, device) -> torch.Tensor:
    """(n, d) sinusoids: sin in even columns, cos in odd ones."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe
