"""Random-sampling decoding (temperature, top-k, top-p).

The port's counterpart of `nanodecoder_tpu.decode.sampling` (the
reference's `-random_sampling_topk` / `-random_sampling_temp`).  Per
step, in this order:

  1. temperature: log_softmax(log_probs / T) for T != 1 (the division
     by the constant T is a multiply by its f32 reciprocal, as XLA
     compiles the JAX package's);
  2. the min_len mask of EOS;
  3. restrict: keep the top-k tokens (k 0: all) and the top-p nucleus
     (p 0: off), renormalized;
  4. draw: `prng.categorical(fold_in(key, t), restricted log-probs)`, the
     argmax of the log-probs plus Gumbel noise drawn as
     `jax.random.categorical` draws it (kernel R1 on the card).

One stage at max_decode_len, as the JAX package's loop (it does not
stage); the loop runs on the host and stops once every row has emitted
EOS.  The recorded per-token score is the chosen token's log-prob under
the restricted distribution, in f32, as the Phred qualities read it.

The noise is the JAX package's from the same key, bit for bit up to
the final logs (which round within about 1e-6 of XLA's), on the CPU and
on the card alike: a token can differ from the JAX package's only where
two candidates' noisy scores tie within that.
"""

from __future__ import annotations

import numpy as np
import torch

from nanodecoder_tpu_torch import prng
from nanodecoder_tpu_torch.config import DecodeConfig, ModelConfig
from nanodecoder_tpu_torch.decode.greedy import GreedyResult
from nanodecoder_tpu_torch.models.model import decode_step, init_decode_state
from nanodecoder_tpu_torch.utils.profiling import span
from nanodecoder_tpu_torch.vocab import BOS_ID, EOS_ID, PAD_ID

NEG_INF = -1.0e9


def restrict_log_probs(log_probs: torch.Tensor, topk: int, topp: float) -> torch.Tensor:
    """Mask the log-probs (B, V) f32 outside the top-k set and the top-p
    nucleus to -1e9 and renormalize (log_softmax).  Ties at the k-th
    value are all kept.  The nucleus is the shortest prefix of the
    descending order whose mass reaches p: a token is kept while the
    mass before it is under p."""
    v = log_probs.shape[-1]
    lp = log_probs
    if topk and 0 < topk < v:
        kth = torch.sort(lp, dim=-1).values[:, v - topk:v - topk + 1]
        lp = torch.where(lp < kth, NEG_INF, lp)
    if topp and 0.0 < topp < 1.0:
        sorted_lp = torch.sort(lp, dim=-1, descending=True).values
        probs = torch.exp(sorted_lp)
        keep = (torch.cumsum(probs, dim=-1) - probs) < topp
        min_kept = torch.where(keep, sorted_lp, torch.inf).min(dim=-1, keepdim=True).values
        lp = torch.where(lp < min_kept, NEG_INF, lp)
    return torch.log_softmax(lp, dim=-1)


@torch.inference_mode()
def sample_decode(params, cfg: ModelConfig, dcfg: DecodeConfig, memory: torch.Tensor,
                  mem_lengths: torch.Tensor, key, row0: int = 0) -> GreedyResult:
    """Sample one hypothesis per row of the memory bank (B, S, D).
    `params` must carry the serving fold.  Step t draws with fold_in(key,
    t) over the (B, V) log-probs, the rows at their place row0.. in the
    batch that the key draws for (a data-parallel rank's share), as the
    JAX package's sample_decode does.  Returns greedy's result fields."""
    if dcfg.temperature <= 0.0:
        raise ValueError("sample mode needs temperature > 0")
    b = memory.shape[0]
    dev = memory.device
    tmax = cfg.max_decode_len
    temp = float(dcfg.temperature)
    inv_temp = torch.tensor(np.float32(1.0) / np.float32(temp), device=dev)
    state = init_decode_state(params, cfg, memory, mem_lengths)
    cur = torch.full((b,), BOS_ID, dtype=torch.int64, device=dev)
    tokens = torch.full((b, tmax), PAD_ID, dtype=torch.int32, device=dev)
    lps = torch.zeros((b, tmax), dtype=torch.float32, device=dev)
    pos = torch.zeros((b, tmax), dtype=torch.int32, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
    t = 0
    done = b == 0
    while t < tmax and not done:
        with span("decode.step", step=t):
            log_probs, attn_pos, state = decode_step(params, cfg, cur, state)
            if temp != 1.0:
                log_probs = torch.log_softmax(log_probs * inv_temp, dim=-1)
            if t < dcfg.min_len:  # EOS is no legal continuation yet
                log_probs[:, EOS_ID] = NEG_INF
            lp_r = restrict_log_probs(log_probs, dcfg.sampling_topk, dcfg.sampling_topp)
            nxt = prng.categorical(prng.fold_in(key, t), lp_r, row0=row0)
            lp = lp_r.gather(1, nxt[:, None])[:, 0]
            # Finished rows keep emitting PAD with zero score.
            nxt = torch.where(finished, PAD_ID, nxt)
            lp = torch.where(finished, 0.0, lp)
            tokens[:, t] = nxt.to(torch.int32)
            lps[:, t] = lp
            pos[:, t] = attn_pos
            lengths = torch.where(finished, lengths, t + 1)
            finished = finished | (nxt == EOS_ID)
            cur = nxt
            t += 1
            with span("decode.sync"):
                done = bool(finished.all())
    # Rows that never emitted EOS have length tmax.
    lengths = torch.where(finished, lengths, tmax)
    return GreedyResult(tokens=tokens, lengths=lengths, token_log_probs=lps,
                        scores=lps.sum(dim=-1), attn_pos=pos, steps=t)
