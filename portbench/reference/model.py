"""The basecaller's plain forward pass: conv front-end, pre-norm
transformer encoder, teacher-forced transformer decoder, generator; the
names and shapes of its parameters (`param_shapes`) and the operations a
training step and a served batch need (`train_step_flops`,
`serve_batch_flops`).  A configuration without a "reference" key is
judged and counted by this module (`reference.module`).

Plain PyTorch over the flat `.npz` parameter names, float32 and no
kernel, importing nothing of the program.  `precision` puts every matrix
product's operands (convolutions, projections, attention's two products,
the generator) through a lower precision while sums, layer norms and
softmax stay float32: "bfloat16", or "float8" (e4m3, one scale per
tensor, as an fp8 GEMM takes it), the control that must fail the
comparison.  `tile_kv_heads` turns the MQA decoder into the same
function in MHA form.  Training passes a threefry key: dropout then
falls where the program's trainer drops, with the same masks.

Serving counts the work the chunks needed: the encoder over every real
chunk's positions (attention over each chunk's valid positions), the
cross K/V projection once a chunk, and the decoder once for each served
token.  Training counts the forward pass over the whole batch shape
(causal self attention over its lower triangle) and twice that for the
backward pass.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench import work
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
    def frontend(self, signal, lengths):
        """signal (B, S) f32, lengths (B,) -> (the conv front-end's output
        (B, T, D) after its projection and layer norm, enc lengths)."""
        x = signal[:, None, :]
        lens = lengths.to(torch.int64)
        for i, stride in enumerate(self.m["conv_strides"]):
            w = self.p[f"encoder/frontend/convs/{i}/w"].permute(2, 1, 0)
            x = F.conv1d(self.rnd(x), self.rnd(w), stride=stride, padding=w.shape[2] // 2)
            x = torch.relu(x + self.p[f"encoder/frontend/convs/{i}/b"][None, :, None])
            lens = torch.div(lens + stride - 1, stride, rounding_mode="floor")
        x = self.dense("encoder/frontend/proj", x.transpose(1, 2))
        return self.ln("encoder/frontend/ln", x), lens

    def encode(self, signal, lengths, key=None):
        """signal (B, S) f32, lengths (B,) -> (memory (B, T, D), enc lengths)."""
        m = self.m
        x, lens = self.frontend(signal, lengths)
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


# ---------------------------------------------------------------------------
# parameters and work


def frontend_shapes(model: dict) -> dict[str, tuple[int, ...]]:
    """The conv front-end's flat names and stored shapes (a conv weight
    (W, I, O)), its projection and layer norm, the target embedding and
    the generator: what every family has."""
    d, v = model["d_model"], model["vocab_size"]
    shapes: dict[str, tuple[int, ...]] = {}
    cin = 1
    for i, (ch, ker) in enumerate(zip(model["conv_channels"], model["conv_kernels"])):
        shapes[f"encoder/frontend/convs/{i}/w"] = (ker, cin, ch)
        shapes[f"encoder/frontend/convs/{i}/b"] = (ch,)
        cin = ch
    shapes.update(dense_shapes("encoder/frontend/proj", cin, d))
    shapes.update(ln_shapes("encoder/frontend/ln", d))
    shapes["tgt_embed/table"] = (v, d)
    shapes.update(dense_shapes("generator", d, v))
    return shapes


def dense_shapes(name: str, n_in: int, n_out: int) -> dict[str, tuple[int, ...]]:
    return {name + "/w": (n_in, n_out), name + "/b": (n_out,)}


def ln_shapes(name: str, d: int) -> dict[str, tuple[int, ...]]:
    return {name + "/scale": (d,), name + "/bias": (d,)}


def param_shapes(model: dict) -> dict[str, tuple[int, ...]]:
    """Flat name -> stored shape of the transformer encoder and decoder."""
    d, f = model["d_model"], model["enc_ffn_dim"]
    dk = d // model["dec_heads"] * (model["dec_kv_heads"] or model["dec_heads"])
    shapes = frontend_shapes(model)
    for i in range(model["enc_layers"]):
        pre = f"encoder/body/layers/{i}"
        shapes.update(ln_shapes(pre + "/ln1", d))
        shapes.update(ln_shapes(pre + "/ln2", d))
        for name in "qkvo":
            shapes.update(dense_shapes(f"{pre}/attn/{name}", d, d))
        shapes.update(dense_shapes(pre + "/ffn/in", d, f))
        shapes.update(dense_shapes(pre + "/ffn/out", f, d))
    shapes.update(ln_shapes("encoder/body/ln_out", d))
    for i in range(model["dec_layers"]):
        pre = f"decoder/layers/{i}"
        for ln in ("ln1", "ln2", "ln3"):
            shapes.update(ln_shapes(f"{pre}/{ln}", d))
        for attn in ("self_attn", "cross_attn"):
            for name, width in (("q", d), ("k", dk), ("v", dk), ("o", d)):
                shapes.update(dense_shapes(f"{pre}/{attn}/{name}", d, width))
        shapes.update(dense_shapes(pre + "/ffn/in", d, model["dec_ffn_dim"]))
        shapes.update(dense_shapes(pre + "/ffn/out", model["dec_ffn_dim"], d))
    shapes.update(ln_shapes("decoder/ln_out", d))
    return shapes


def encoder_flops(model: dict, samples: int, lengths: np.ndarray) -> float:
    """The conv front-end, projection and transformer body over chunks of
    `samples` samples with these valid lengths (one per chunk)."""
    d, f = model["d_model"], model["enc_ffn_dim"]
    n = len(lengths)
    s = work.enc_positions(model, samples)
    per_chunk = work.frontend_flops(model, samples)
    per_chunk += model["enc_layers"] * s * (2.0 * 4 * d * d + 2.0 * 2 * d * f)
    keys = work.enc_lengths(model, lengths)
    keys = np.where(keys > 0, keys, s).astype(np.float64)
    attn = model["enc_layers"] * 4.0 * s * d * keys.sum()
    return n * per_chunk + attn


def decoder_token_flops(model: dict, t: np.ndarray, mem: np.ndarray) -> float:
    """Decoder steps at positions t (0-based) over memories of `mem` valid
    positions, the generator included: summed over the arrays."""
    d, f, v = model["d_model"], model["dec_ffn_dim"], model["vocab_size"]
    dk = d // model["dec_heads"] * (model["dec_kv_heads"] or model["dec_heads"])
    t = np.asarray(t, np.float64)
    mem = np.asarray(mem, np.float64)
    dense = model["dec_layers"] * (2.0 * d * (d + 2 * dk) + 3 * 2.0 * d * d
                                   + 2.0 * 2 * d * f) + 2.0 * d * v
    attn = model["dec_layers"] * 4.0 * d * ((t + 1) + mem)
    return float(dense * t.size + attn.sum())


def cross_kv_flops(model: dict, samples: int, n_chunks: int) -> float:
    d = model["d_model"]
    dk = d // model["dec_heads"] * (model["dec_kv_heads"] or model["dec_heads"])
    s = work.enc_positions(model, samples)
    return model["dec_layers"] * 2.0 * s * d * 2 * dk * n_chunks


def serve_batch_flops(model: dict, samples: int, lengths: np.ndarray,
                      decoded: np.ndarray) -> float:
    """One greedy batch's needed operations: `lengths` of its real chunks
    and the served tokens of each."""
    mem = work.enc_lengths(model, lengths)
    total = encoder_flops(model, samples, lengths) + cross_kv_flops(model, samples, len(lengths))
    t = np.concatenate([np.arange(n) for n in decoded]) if len(decoded) else np.zeros(0)
    m = np.repeat(mem, decoded)
    return total + decoder_token_flops(model, t, m)


def train_step_flops(model: dict, batch: int, samples: int, tmax: int) -> float:
    """Forward and backward of one step at the batch shape."""
    s = work.enc_positions(model, samples)
    lengths = np.full(batch, samples)
    fwd = encoder_flops(model, samples, lengths) + cross_kv_flops(model, samples, batch)
    d, f, v = model["d_model"], model["dec_ffn_dim"], model["vocab_size"]
    dk = d // model["dec_heads"] * (model["dec_kv_heads"] or model["dec_heads"])
    per_tok = model["dec_layers"] * (2.0 * d * (d + 2 * dk) + 3 * 2.0 * d * d
                                     + 2.0 * 2 * d * f) + 2.0 * d * v
    causal = model["dec_layers"] * 4.0 * d * (tmax * (tmax + 1) / 2)
    cross = model["dec_layers"] * 4.0 * d * tmax * s
    fwd += batch * (per_tok * tmax + causal + cross)
    return 3.0 * fwd
