"""The recurrent basecaller's plain forward pass (`encoder_type` "lstm",
`decoder_type` "rnn"): the conv front-end, a stacked biLSTM encoder, an
input-feed LSTM decoder with Luong attention and the generator; the names
and shapes of its parameters, and the operations a training step and a
served batch need.

Plain PyTorch, float32 and no kernel, importing nothing of the program.
The front-end and the arithmetic (`precision`, dense, layer norm) are the
transformer reference's (`model.Ref`), so `precision` gives the same
bfloat16 and float8 controls.  It follows the port's documented function:
  * encoder: each layer's input zeroed at padded positions; a forward
    cell from t = 0 and a backward cell from t = T - 1, each from zero
    state over the whole padded buffer; [forward; backward] projected
    back to D; after the last layer `ln_out`, and padded positions
    zeroed.  OpenNMT packs the padded batch (`pack_padded_sequence`),
    which starts each row's backward pass at its own last valid step: a
    different function, which the port does not compute either.
  * decoder: the target embedding times sqrt(D), no positions; the first
    cell takes [embedding; input feed], the input feed starting at zero;
    the top cell's output is the query of Luong `general` attention
    (scores memory . (q W_a)) with scores in float32, masked to -1e9 and
    softmaxed; tanh(W_o [context; query]) is the next input feed and the
    generator's input.
  * LSTM cells: gates x W_x + h W_h + b in the order i, f, g, o;
    c = sigmoid(f) c + sigmoid(i) tanh(g), h = sigmoid(o) tanh(c).  The
    encoder's cells are `lstm_hidden` wide, the decoder's D.
  * no dropout: the recurrent path draws none, so a key is taken and
    ignored.

Work: a cell step costs its two products, 2 (in + H) 4H; the encoder runs
over every position of a chunk's buffer (the backward direction reads
the padding), the decoder once a served token with attention over the
chunk's valid positions; training counts the forward pass over the batch
shape and twice that for the backward pass.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import work
from portbench.reference import model as transformer
from portbench.reference.model import NEG, dense_shapes, frontend_shapes, ln_shapes


class Ref(transformer.Ref):
    """One forward-pass configuration of the recurrent family."""

    def cell(self, name, x, h, c, x_proj=None):
        """One LSTM step of the cell `name`: (h, c).  `x_proj`, where
        given, is x W_x + b already."""
        if x_proj is None:
            gates = self.mm(x, self.p[name + "/wx"]) + self.mm(h, self.p[name + "/wh"]) \
                + self.p[name + "/b"]
        else:
            gates = x_proj + self.mm(h, self.p[name + "/wh"])
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def direction(self, name, xs, reverse: bool):
        """One direction of a layer over xs (B, T, D) from zero state:
        (B, T, H), the output at each t.  The steps' input projections are
        taken apart with `unbind`, whose backward stacks their gradients:
        indexing each step would add a full-size gradient a step."""
        x_proj = (self.mm(xs, self.p[name + "/wx"]) + self.p[name + "/b"]).unbind(1)
        h = xs.new_zeros((xs.shape[0], self.p[name + "/wh"].shape[0]))
        c = torch.zeros_like(h)
        out = [None] * len(x_proj)
        for s in (range(len(x_proj) - 1, -1, -1) if reverse else range(len(x_proj))):
            h, c = self.cell(name, None, h, c, x_proj[s])
            out[s] = h
        return torch.stack(out, dim=1)

    def encode(self, signal, lengths, key=None):
        """signal (B, S) f32, lengths (B,) -> (memory (B, T, D), enc lengths)."""
        x, lens = self.frontend(signal, lengths)
        valid = (torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None])[:, :, None]
        for i in range(self.m["enc_layers"]):
            pre = f"encoder/body/layers/{i}"
            xs = x * valid
            both = torch.cat([self.direction(pre + "/fwd", xs, False),
                              self.direction(pre + "/bwd", xs, True)], dim=-1)
            x = self.dense(pre + "/proj", both)
        return self.ln("encoder/body/ln_out", x) * valid, lens

    def decode(self, tgt_in, memory, mem_lens, key=None):
        """Teacher-forced: tgt_in (B, T) -> (log-probs (B, T, V) f32, the
        attention probs (B, 1, T, S))."""
        m = self.m
        b, d = memory.shape[0], memory.shape[2]
        y = self.p["tgt_embed/table"][tgt_in] * math.sqrt(d)
        mask = torch.arange(memory.shape[1], device=memory.device)[None, :] < mem_lens[:, None]
        state = [(memory.new_zeros((b, d)), memory.new_zeros((b, d)))
                 for _ in range(m["dec_layers"])]
        feed = memory.new_zeros((b, d))
        outs, probs = [], []
        for t in range(tgt_in.shape[1]):
            x = torch.cat([y[:, t], feed], dim=-1)
            for i in range(m["dec_layers"]):
                x, c = self.cell(f"decoder/layers/{i}", x, *state[i])
                state[i] = (x, c)
            feed, pr = self.attend_luong(x, memory, mask)
            outs.append(feed)
            probs.append(pr)
        lp = torch.log_softmax(self.dense("generator", torch.stack(outs, dim=1)), dim=-1)
        return lp, torch.stack(probs, dim=1)[:, None]

    def attend_luong(self, query, memory, mask):
        """query (B, D), memory (B, S, D), mask (B, S) -> (tanh(W_o [ctx;
        query]) (B, D), probs (B, S))."""
        if self.m["rnn_attention"] != "general":
            raise ValueError(f"no reference for {self.m['rnn_attention']!r} attention")
        q = self.dense("decoder/attn/wa", query)
        scores = self.mm(memory, q[:, :, None])[..., 0]
        probs = torch.softmax(torch.where(mask, scores, torch.full_like(scores, NEG)), dim=-1)
        ctx = self.mm(probs[:, None, :], memory)[:, 0]
        return torch.tanh(self.dense("decoder/attn/wo", torch.cat([ctx, query], dim=-1))), probs


# ---------------------------------------------------------------------------
# parameters and work


def lstm_shapes(name: str, n_in: int, hidden: int) -> dict[str, tuple[int, ...]]:
    return {name + "/wx": (n_in, 4 * hidden), name + "/wh": (hidden, 4 * hidden),
            name + "/b": (4 * hidden,)}


def param_shapes(model: dict) -> dict[str, tuple[int, ...]]:
    """Flat name -> stored shape of the biLSTM encoder and the RNN decoder."""
    d, hdim = model["d_model"], model["lstm_hidden"]
    shapes = frontend_shapes(model)
    for i in range(model["enc_layers"]):
        pre = f"encoder/body/layers/{i}"
        for direction in ("fwd", "bwd"):
            shapes.update(lstm_shapes(f"{pre}/{direction}", d, hdim))
        shapes.update(dense_shapes(pre + "/proj", 2 * hdim, d))
    shapes.update(ln_shapes("encoder/body/ln_out", d))
    for i in range(model["dec_layers"]):
        shapes.update(lstm_shapes(f"decoder/layers/{i}", 2 * d if i == 0 else d, d))
    shapes["decoder/attn/wa/w"] = (d, d)
    shapes["decoder/attn/wo/w"] = (2 * d, d)
    return shapes


def cell_flops(n_in: int, hidden: int) -> float:
    return 2.0 * (n_in + hidden) * 4 * hidden


def encoder_flops(model: dict, samples: int) -> float:
    """One chunk's front-end and biLSTM body over its whole buffer."""
    d, hdim = model["d_model"], model["lstm_hidden"]
    layer = 2 * cell_flops(d, hdim) + 2.0 * 2 * hdim * d
    return work.frontend_flops(model, samples) \
        + model["enc_layers"] * work.enc_positions(model, samples) * layer


def decoder_token_flops(model: dict) -> float:
    """A decoder step's cells, attention projections (W_a, W_o) and
    generator, less the scores and context over the memory (4 D a memory
    position)."""
    d = model["d_model"]
    cells = cell_flops(2 * d, d) + (model["dec_layers"] - 1) * cell_flops(d, d)
    return cells + 2.0 * d * d + 2.0 * 2 * d * d + 2.0 * d * model["vocab_size"]


def serve_batch_flops(model: dict, samples: int, lengths: np.ndarray,
                      decoded: np.ndarray) -> float:
    """One greedy batch's needed operations: `lengths` of its real chunks
    and the served tokens of each."""
    mem = work.enc_lengths(model, lengths).astype(np.float64)
    decoded = np.asarray(decoded, np.float64)
    attn = 4.0 * model["d_model"] * float((mem * decoded).sum())
    return len(lengths) * encoder_flops(model, samples) \
        + decoder_token_flops(model) * float(decoded.sum()) + attn


def train_step_flops(model: dict, batch: int, samples: int, tmax: int) -> float:
    """Forward and backward of one step at the batch shape."""
    s = work.enc_positions(model, samples)
    per_tok = decoder_token_flops(model) + 4.0 * model["d_model"] * s
    return 3.0 * batch * (encoder_flops(model, samples) + tmax * per_tok)
