"""Greedy (argmax) decoding with staged cache growth.

The port's counterpart of `nanodecoder_tpu.decode.greedy`.  The loop
runs on the host, one decode step per iteration, and stops early once
every row has emitted EOS.  On the lean transformer path with
`staged_decode` the self cache grows through the stages of
`decode_stage_lengths` (for a max length of 96: 24, 48, 96 rows), so
each step reads only the live prefix.  The RNN decoder has no cache to
grow and runs one stage.

Tie-breaking: torch.argmax returns the lowest index on ties, like
jnp.argmax.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from nanodecoder_tpu_torch.config import ModelConfig
from nanodecoder_tpu_torch.models.model import decode_step, init_decode_state
from nanodecoder_tpu_torch.vocab import BOS_ID, EOS_ID, PAD_ID


def decode_stage_lengths(tmax: int, schedule: tuple[int, ...] = ()) -> list[int]:
    """Stage schedule for staged cache growth: by default about a
    quarter, a half and all of tmax, each a multiple of 8.  An explicit
    `schedule` (ModelConfig.stage_schedule) overrides the split."""
    if schedule:
        qs = sorted(set(schedule))
        if qs[-1] != tmax or any(q % 8 != 0 or q <= 0 for q in qs):
            raise ValueError(
                f"stage_schedule {schedule} must be ascending multiples of 8 "
                f"ending at max_decode_len={tmax}")
        return qs
    qs = sorted({max(8, (tmax // 4) // 8 * 8),
                 max(8, (tmax // 2) // 8 * 8), tmax})
    return [q for q in qs if q <= tmax]


def staged_lengths(cfg: ModelConfig) -> list[int]:
    """The stages a decode runs: `decode_stage_lengths` where the self
    cache can grow (a lean transformer decoder's combined cache, with
    `staged_decode`), else one stage of max_decode_len."""
    if cfg.staged_decode and cfg.lean_step and cfg.decoder_type == "transformer":
        return decode_stage_lengths(cfg.max_decode_len, cfg.stage_schedule)
    return [cfg.max_decode_len]


def grow_self_cache(state, new_t: int):
    """Pad the combined self cache's T dim with zeros up to new_t (the
    padded rows stay masked until written)."""
    kv = state["self_kv"]
    pad = kv.new_zeros((kv.shape[0], new_t - kv.shape[1], kv.shape[2]))
    return {**state, "self_kv": torch.cat([kv, pad], dim=1)}


class GreedyResult(NamedTuple):
    tokens: torch.Tensor           # (B, max_len) int32, PAD after EOS
    lengths: torch.Tensor          # (B,) int32, tokens emitted incl. EOS
    token_log_probs: torch.Tensor  # (B, max_len) f32, log-prob of the chosen token
    scores: torch.Tensor           # (B,) f32, summed log-probs
    attn_pos: torch.Tensor         # (B, max_len) int32, cross-attention argmax
    steps: int                     # decode steps run


@torch.inference_mode()
def greedy_decode(params, cfg: ModelConfig, memory: torch.Tensor,
                  mem_lengths: torch.Tensor, min_len: int = 0) -> GreedyResult:
    """Decode every row of a memory-bank batch greedily.  `params` must
    carry the serving fold (models.model.prepare_serving_params).
    min_len masks EOS before that many tokens."""
    b = memory.shape[0]
    dev = memory.device
    tmax = cfg.max_decode_len
    stages = staged_lengths(cfg)
    state = init_decode_state(
        params, dataclasses.replace(cfg, max_decode_len=stages[0]), memory,
        mem_lengths)
    cur = torch.full((b,), BOS_ID, dtype=torch.int64, device=dev)
    tokens = torch.full((b, tmax), PAD_ID, dtype=torch.int32, device=dev)
    lps = torch.zeros((b, tmax), dtype=torch.float32, device=dev)
    pos = torch.zeros((b, tmax), dtype=torch.int32, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
    t = 0
    for i, st in enumerate(stages):
        scfg = dataclasses.replace(cfg, max_decode_len=st)
        while t < st and not bool(finished.all()):
            log_probs, attn_pos, state = decode_step(params, scfg, cur, state)
            if t < min_len:
                log_probs[:, EOS_ID] = -1e9
            nxt = log_probs.argmax(dim=-1)
            lp = log_probs.gather(1, nxt[:, None])[:, 0]
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
        if i + 1 < len(stages):
            state = grow_self_cache(state, stages[i + 1])
    # Rows that never emitted EOS have length tmax.
    lengths = torch.where(finished, lengths, tmax)
    return GreedyResult(tokens=tokens, lengths=lengths, token_log_probs=lps,
                        scores=lps.sum(dim=-1), attn_pos=pos, steps=t)
