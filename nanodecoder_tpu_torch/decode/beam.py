"""Beam-search decoding with staged cache growth.

The port's counterpart of `nanodecoder_tpu.decode.beam`: the alive /
finished formulation over one (B * K)-row batch (row b * K + j is beam j
of chunk b).  Each step:

  decode step -> advance (score add, top 2K over K * V, new alive set,
  merged finished set) -> gather the self caches by beam origin.

The advance is kernel K3 with `DecodeConfig.use_pallas`, else
`advance_top_k`, the counterpart of the JAX package's three `lax.top_k`
selections (which do not repeat an index where K3's extraction does).

The loop runs on the host, one step per iteration, as in
`decode.greedy`; before each step one host read checks the admissible
early stop (the best score an alive beam can still reach against the
worst kept finished score).  On the lean transformer path with
`staged_decode` the self cache grows through the stages of
`decode_stage_lengths` between steps.  A transformer decoder's beams
share their chunk's cross K/V; the RNN decoder decodes over the memory
bank tiled K times (row b * K + j), as the JAX package does, and its
beam reorder gathers the hidden, cell and input-feed state.

Sequences are kept as backpointers: every step writes the alive beams'
(token, origin, log-prob, attention position) into one (B, K, T, 4) f32
history, and the finished set keeps (eos step, parent beam, finished
flag, EOS log-prob, EOS position) as (B, K, 5) f32 channels (integer
channels are exact in f32).  `_backtrack` rebuilds the sequences after
the loop.

The coverage penalty (`coverage_penalty` "wu" or "summary" with a
non-zero `beta`) changes the loop, as in the JAX package.  It needs each
step's cross-attention probabilities, which the kernels never
materialise.  The whole decode (init, steps, reorder) then runs on the
unfolded step over per-layer self caches with use_pallas false
(`decode_step(return_attn=True)`), and the advance takes the top-k
route, never K3.  A (B, K, S) f32 carry accumulates each hypothesis's
attention mass; a finished candidate scores its penalized score minus
the coverage penalty of its mass.

The path-indirection reorder (`DecodeConfig.path_reorder`) is accepted
and runs the physical reorder, which it equals token for token.  The
JAX package's path mode keeps the self cache in write-time frame and
reads it through a (B, K, T) ancestry map; a port of that read gathers
the whole self cache every step, the bytes the physical reorder moves,
so the port keeps one reorder.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from nanodecoder_tpu_torch.config import DecodeConfig, ModelConfig
from nanodecoder_tpu_torch.decode.greedy import grow_self_cache, staged_lengths
from nanodecoder_tpu_torch.decode.penalties import coverage_penalty, length_penalty
from nanodecoder_tpu_torch.models.model import (decode_step, init_decode_state,
                                                reorder_decode_state_beam)
from nanodecoder_tpu_torch.ops.beam_step import NEG_INF, beam_advance
from nanodecoder_tpu_torch.vocab import BOS_ID, EOS_ID, PAD_ID


class BeamResult(NamedTuple):
    tokens: torch.Tensor           # (B, K, max_len) int32, best first
    lengths: torch.Tensor          # (B, K) int32, tokens emitted incl. EOS
    scores: torch.Tensor           # (B, K) f32, length-penalized log-prob
    finished: torch.Tensor         # (B, K) bool, hypothesis ended with EOS
    token_log_probs: torch.Tensor  # (B, K, max_len) f32
    attn_pos: torch.Tensor         # (B, K, max_len) int32, cross-attention argmax
    steps: int                     # decode steps run


def needs_coverage(dcfg: DecodeConfig) -> bool:
    """Whether the decode carries the coverage penalty (and so leaves the
    kernels: see the module docstring)."""
    return dcfg.coverage_penalty != "none" and dcfg.beta != 0.0


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, M) -> (B, M, C)."""
    return x.gather(1, idx.long()[:, :, None].expand(-1, -1, x.shape[2]))


def _top_k(x: torch.Tensor, n: int):
    """The n largest entries of each row, in order, ties to the lowest
    index (`lax.top_k`'s order; `torch.topk` promises no order of ties)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :n], idx[:, :n]


def advance_top_k(alive: torch.Tensor, log_probs: torch.Tensor, fin: torch.Tensor,
                  pen: float, k: int, v: int, eos_id: int,
                  fin_penalty: Callable[[torch.Tensor], torch.Tensor] | None = None):
    """The advance without kernel K3, as the JAX package runs it when
    use_pallas is false or under the coverage penalty: the top 2K
    candidates of alive + log_probs over K * V, the best K of them that
    are not EOS, and the best K of the old finished scores and the EOS
    candidates divided by pen (an IEEE f32 division), less
    fin_penalty(top_ids) (B, 2K) where given.  Returns K3's (top_ids,
    alive_s, alive_sel, fin_s, fin_sel), indices int64."""
    b = log_probs.shape[0]
    flat = (alive[:, :, None] + log_probs).reshape(b, k * v)
    tops, top_ids = _top_k(flat, 2 * k)
    is_eos = top_ids % v == eos_id
    alive_s, alive_sel = _top_k(torch.where(is_eos, NEG_INF, tops), k)
    # A device tensor divisor: a host scalar may become a reciprocal multiply.
    pen_t = torch.tensor(pen, dtype=torch.float32, device=tops.device)
    fin_sc = tops / pen_t
    if fin_penalty is not None:
        fin_sc = fin_sc - fin_penalty(top_ids)
    fin_cand = torch.where(is_eos, fin_sc, NEG_INF)
    fin_s, fin_sel = _top_k(torch.cat([fin, fin_cand], dim=1), k)
    return top_ids, alive_s, alive_sel, fin_s, fin_sel


def _backtrack(hist, eos_at, start_beam, emit_eos, fin_lp, fin_pos, tmax: int):
    """Rebuild (tokens, log-probs, positions), each (B, S, tmax), from
    the backpointer history.

    For each output slot: eos_at is the position of its last token (EOS
    for a finished hypothesis, one past the last token for an alive
    fallback; -1 gives an all-PAD row), start_beam the alive beam its
    path ends in, emit_eos whether position eos_at holds EOS, whose
    log-prob and position (fin_lp, fin_pos) were kept at finalization.
    A reverse loop over T of gathers, as the JAX package's reverse scan;
    it starts at max(eos_at), since every later position is PAD."""
    b, s = eos_at.shape
    dev = hist.device
    tokens = torch.full((b, s, tmax), PAD_ID, dtype=torch.int32, device=dev)
    lps = torch.zeros((b, s, tmax), dtype=torch.float32, device=dev)
    pos = torch.zeros((b, s, tmax), dtype=torch.int32, device=dev)
    cur = start_beam.long()
    t_last = int(eos_at.max()) if eos_at.numel() else -1
    for t in range(min(t_last, tmax - 1), -1, -1):
        r4 = _gather(hist[:, :, t, :], cur)
        at_eos = (eos_at == t) & emit_eos
        before = t < eos_at
        tokens[:, :, t] = torch.where(at_eos, EOS_ID, torch.where(
            before, r4[..., 0].to(torch.int32), PAD_ID)).to(torch.int32)
        lps[:, :, t] = torch.where(at_eos, fin_lp, torch.where(before, r4[..., 2], 0.0))
        pos[:, :, t] = torch.where(at_eos, fin_pos, torch.where(
            before, r4[..., 3].to(torch.int32), 0)).to(torch.int32)
        cur = torch.where(before, r4[..., 1].long(), start_beam.long())
    return tokens, lps, pos


@torch.inference_mode()
def beam_decode(params, cfg: ModelConfig, dcfg: DecodeConfig,
                memory: torch.Tensor, mem_lengths: torch.Tensor,
                mark: Callable[[str], None] | None = None) -> BeamResult:
    """Beam-search decode a memory-bank batch (B, S, D).  `params` must
    carry the serving fold (models.model.prepare_serving_params).
    `mark`, if given, is called with the name of each phase as it starts
    ("decode step", "advance + reorder", "backtrack"), for a profiler."""
    mark = mark or (lambda _name: None)
    b = memory.shape[0]
    k = dcfg.beam_size
    v = cfg.vocab_size
    tmax = cfg.max_decode_len
    dev = memory.device
    need_cov = needs_coverage(dcfg)
    if need_cov and cfg.lean_step:  # the unfolded step over the master weights
        cfg = dataclasses.replace(cfg, lean_step=False)
    stages = staged_lengths(cfg)
    if cfg.decoder_type == "rnn":  # memory bank tiled beam-wise
        state = init_decode_state(params, cfg, memory.repeat_interleave(k, dim=0),
                                  mem_lengths.repeat_interleave(k, dim=0))
    else:
        state = init_decode_state(
            params, dataclasses.replace(cfg, max_decode_len=stages[0]), memory,
            mem_lengths, beam_k=k)

    cur = torch.full((b * k,), BOS_ID, dtype=torch.int64, device=dev)
    # Beam 0 starts at 0, the others at -1e9, so step 0 expands beam 0.
    alive = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    alive[:, 0] = 0.0
    hist = torch.zeros((b, k, tmax, 4), dtype=torch.float32, device=dev)
    fin_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    fin_meta = torch.zeros((b, k, 5), dtype=torch.float32, device=dev)
    fin_meta[..., 0] = -1.0                                  # eos step
    # Accumulated cross-attention mass of each alive hypothesis.
    cov = torch.zeros((b, k, memory.shape[1] if need_cov else 1),
                      dtype=torch.float32, device=dev)
    # Scores at tmax are multiplied by the f32 reciprocal of the penalty,
    # as XLA compiles the JAX package's division by this constant.
    inv_max_pen = (1.0 / length_penalty(tmax, dcfg.length_penalty,
                                        dcfg.alpha)).to(dev)

    def done() -> bool:
        # Log-probs only decrease, and for negative scores the penalty
        # divisor is largest at tmax: no alive beam can beat this bound.
        best_alive_bound = alive[:, 0] * inv_max_pen
        worst_finished = torch.where(fin_meta[..., 2] > 0.5, fin_scores,
                                     NEG_INF).min(dim=1).values
        return bool((worst_finished >= best_alive_bound).all())

    advance = beam_advance if dcfg.use_pallas else advance_top_k
    t = 0
    for i, st in enumerate(stages):
        scfg = dataclasses.replace(cfg, max_decode_len=st)
        while t < st and not done():
            mark("decode step")
            if need_cov:
                log_probs, step_attn, attn_mean, state = decode_step(
                    params, scfg, cur, state, return_attn=True)
            else:
                log_probs, step_attn, state = decode_step(params, scfg, cur, state)
            mark("advance + reorder")
            if t < dcfg.min_len:  # EOS is no legal continuation yet
                log_probs[:, EOS_ID] = NEG_INF
            lp = log_probs.reshape(b, k, v)
            pen = float(length_penalty(t + 1, dcfg.length_penalty, dcfg.alpha))
            if need_cov:
                # A candidate's mass: its origin beam's, plus the origin's
                # attention row of this step.
                cov_step = cov + attn_mean.reshape(b, k, -1)
                top_ids, alive, alive_idx, fin_scores, fin_idx = advance_top_k(
                    alive, lp, fin_scores, pen, k, v, EOS_ID,
                    lambda ids: coverage_penalty(_gather(cov_step, ids // v),
                                                 dcfg.coverage_penalty, dcfg.beta))
            else:
                top_ids, alive, alive_idx, fin_scores, fin_idx = advance(
                    alive, lp, fin_scores, pen, k, v, EOS_ID)
            top_ids = top_ids.long()
            tok = top_ids % v
            origin = top_ids // v
            is_eos = tok == EOS_ID
            # Per candidate: its token's log-prob and its origin beam's
            # attention position.
            cand_lp = lp.reshape(b, k * v).gather(1, top_ids)
            cand_pos = step_attn.reshape(b, k).gather(1, origin).to(torch.float32)
            cand_pack = torch.stack([tok.to(torch.float32), origin.to(torch.float32),
                                     cand_lp, cand_pos], dim=2)       # (B, 2K, 4)
            alive_pack = _gather(cand_pack, alive_idx)                # (B, K, 4)
            hist[:, :, t, :] = alive_pack
            cur = alive_pack[..., 0].long().reshape(-1)
            alive_origin = alive_pack[..., 1].long()
            if need_cov:
                cov = _gather(cov_step, alive_origin)
            state = reorder_decode_state_beam(state, alive_origin)
            cand_meta = torch.stack([
                torch.full((b, 2 * k), float(t), device=dev), origin.to(torch.float32),
                is_eos.to(torch.float32), cand_lp, cand_pos], dim=2)  # (B, 2K, 5)
            fin_meta = _gather(torch.cat([fin_meta, cand_meta], dim=1), fin_idx)
            t += 1
        if i + 1 < len(stages):
            state = grow_self_cache(state, stages[i + 1])

    mark("backtrack")
    m_step = fin_meta[..., 0].to(torch.int32)
    m_origin = fin_meta[..., 1].to(torch.int32)
    m_flags = fin_meta[..., 2] > 0.5
    # Rows with no finished hypothesis fall back to their best alive
    # beams, penalized at tmax (and by their coverage).
    sel = ~m_flags.any(dim=1, keepdim=True)                    # (B, 1)
    alive_final = alive * inv_max_pen
    if need_cov:
        alive_final = alive_final - coverage_penalty(cov, dcfg.coverage_penalty,
                                                     dcfg.beta)
    beam_ids = torch.arange(k, dtype=torch.int32, device=dev).expand(b, k)
    eos_at = torch.where(sel, t, torch.where(m_flags, m_step, -1))
    start_beam = torch.where(sel, beam_ids, m_origin)
    emit_eos = ~sel & m_flags
    tokens, token_lps, attn_pos = _backtrack(
        hist, eos_at, start_beam, emit_eos,
        torch.where(sel, 0.0, fin_meta[..., 3]),
        torch.where(sel, 0, fin_meta[..., 4].to(torch.int32)), tmax)
    return BeamResult(
        tokens=tokens,
        lengths=torch.where(sel, tmax, torch.where(m_flags, m_step + 1, 0)).to(torch.int32),
        scores=torch.where(sel, alive_final, fin_scores),
        finished=~sel & m_flags,
        token_log_probs=token_lps,
        attn_pos=attn_pos,
        steps=t)
