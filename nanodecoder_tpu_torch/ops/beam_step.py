"""Beam-search advance (kernel K3) and top-n extraction (kernel K7).

Both kernels score the beam candidates of each chunk row,
flat = alive[:, :, None] + log_probs flattened over (K * V), and pick
their best entries by iterated extraction, exactly as the JAX package's
`_extract_top` does:

    m = max(flat); i = lowest index with flat >= m; flat[i] = -1e9

A picked slot is overwritten with -1e9, not removed, so once every
remaining value is at or below -1e9 the same index is picked again (for
example the all -1e9 finished set of the first step returns slot 0 K
times).  `torch.topk` neither promises the lowest index on ties nor
repeats an index, so it is no stand-in for either kernel.

On a CUDA tensor each wrapper launches its kernel in
`csrc/beam_step.cu` (one warp per row for V >= 4 and K * V <= 2048 with
K <= 10 in K3, K <= 32 and n_out <= 20 in K7, else one block per row);
on a CPU tensor it runs the plain PyTorch version below.  Nothing falls back from one to the other.
The inputs are finite or -inf (log-softmax outputs, -1e9 from the
min_len mask): the order of NaNs is not part of the contract, and of two
tied zeros of opposite sign the kernels return the one at the picked
index.
"""

from __future__ import annotations

import torch

from nanodecoder_tpu_torch.ops import _build

NEG_INF = -1.0e9
_BIG = 2**30


def _extract_top(flat: torch.Tensor, n_out: int):
    """(B, N) f32 -> top n_out (scores (B, n_out) f32, ids (B, n_out)
    int32), iterated as the module docstring says."""
    idx = torch.arange(flat.shape[1], device=flat.device).expand_as(flat)
    s_cols, i_cols = [], []
    for _ in range(n_out):
        m = flat.max(dim=1, keepdim=True).values
        amax = torch.where(flat >= m, idx, _BIG).min(dim=1, keepdim=True).values
        s_cols.append(m)
        i_cols.append(amax)
        flat = torch.where(idx == amax, NEG_INF, flat)
    return torch.cat(s_cols, dim=1), torch.cat(i_cols, dim=1).to(torch.int32)


def _candidates(alive: torch.Tensor, log_probs: torch.Tensor) -> torch.Tensor:
    b, k, v = log_probs.shape
    return (alive[:, :, None] + log_probs).reshape(b, k * v)


def beam_topk_plain(alive: torch.Tensor, log_probs: torch.Tensor, n_out: int):
    """K7's plain version."""
    return _extract_top(_candidates(alive, log_probs), n_out)


def beam_advance_plain(alive: torch.Tensor, log_probs: torch.Tensor,
                       fin: torch.Tensor, pen: float, k: int, v: int,
                       eos_id: int):
    """K3's plain version, the iterated extraction in torch ops."""
    tops, topi = _extract_top(_candidates(alive, log_probs), 2 * k)
    tok = topi - (topi // v) * v
    is_eos = tok == eos_id
    alive_s, alive_sel = _extract_top(torch.where(is_eos, NEG_INF, tops), k)
    # A device tensor divisor: on CUDA a host scalar divisor turns the
    # division into a multiply by its reciprocal, which is not IEEE a / b.
    pen_t = torch.tensor(pen, dtype=torch.float32, device=tops.device)
    fin_cand = torch.where(is_eos, tops / pen_t, NEG_INF)
    fin_s, fin_sel = _extract_top(torch.cat([fin, fin_cand], dim=1), k)
    return topi, alive_s, alive_sel, fin_s, fin_sel


def _check(name: str, x: torch.Tensor, shape: tuple[int, ...]) -> None:
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")


def _cuda_ready(*xs: torch.Tensor) -> bool:
    """False for CPU tensors (plain version); True for contiguous tensors
    on one CUDA device; raises otherwise."""
    dev = xs[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError("inputs must lie on one CUDA device")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("inputs must be contiguous")
    return True


def beam_advance(alive: torch.Tensor, log_probs: torch.Tensor, fin: torch.Tensor,
                 pen: float, k: int, v: int, eos_id: int):
    """One beam-search advance.

    alive: (B, K) f32 cumulative scores of the alive beams; log_probs:
    (B, K, V) f32 step log-probs; fin: (B, K) f32 length-penalized
    finished scores; pen: the f32 length-penalty divisor of this step.
    Returns (top_ids (B, 2K) int32 into K*V, alive_s (B, K) f32,
    alive_sel (B, K) int32 into 2K, fin_s (B, K) f32, fin_sel (B, K)
    int32 into 3K: j < K is old finished slot j, j >= K new candidate
    j - K).  Scores of EOS candidates are divided by pen (IEEE f32)."""
    if log_probs.dim() != 3:
        raise ValueError(f"log_probs must be (B, K, V), got {tuple(log_probs.shape)}")
    b = log_probs.shape[0]
    _check("log_probs", log_probs, (b, k, v))
    _check("alive", alive, (b, k))
    _check("fin", fin, (b, k))
    if not 0 <= eos_id < v:
        raise ValueError(f"eos_id {eos_id} outside [0, {v})")
    pen = float(pen)
    if not _cuda_ready(alive, log_probs, fin):
        return beam_advance_plain(alive, log_probs, fin, pen, k, v, eos_id)
    # The five outputs are views of two allocations (host cost per call).
    ints = torch.empty((4 * b * k,), dtype=torch.int32, device=alive.device)
    floats = torch.empty((2 * b * k,), dtype=torch.float32, device=alive.device)
    top_ids = ints[:2 * b * k].view(b, 2 * k)
    alive_sel = ints[2 * b * k:3 * b * k].view(b, k)
    fin_sel = ints[3 * b * k:].view(b, k)
    alive_s = floats[:b * k].view(b, k)
    fin_s = floats[b * k:].view(b, k)
    if b:
        lib = _build.load()
        stream = torch.cuda.current_stream(alive.device).cuda_stream
        _build.check(lib.nd_beam_advance(
            alive.data_ptr(), log_probs.data_ptr(), fin.data_ptr(), pen, b, k, v,
            eos_id, top_ids.data_ptr(), alive_s.data_ptr(), alive_sel.data_ptr(),
            fin_s.data_ptr(), fin_sel.data_ptr(), stream), "beam advance kernel")
        beam_advance.launches += 1
    return top_ids, alive_s, alive_sel, fin_s, fin_sel


def beam_topk(alive: torch.Tensor, log_probs: torch.Tensor, n_out: int):
    """Top n_out of alive + log_probs over (K * V): alive (B, K) f32,
    log_probs (B, K, V) f32 -> (scores (B, n_out) f32, ids (B, n_out)
    int32 into K*V)."""
    if log_probs.dim() != 3:
        raise ValueError(f"log_probs must be (B, K, V), got {tuple(log_probs.shape)}")
    b, k, v = log_probs.shape
    _check("log_probs", log_probs, (b, k, v))
    _check("alive", alive, (b, k))
    if n_out < 1:
        raise ValueError(f"n_out must be positive, got {n_out}")
    if not _cuda_ready(alive, log_probs):
        return beam_topk_plain(alive, log_probs, n_out)
    dev = alive.device
    scores = torch.empty((b, n_out), dtype=torch.float32, device=dev)
    ids = torch.empty((b, n_out), dtype=torch.int32, device=dev)
    if b:
        lib = _build.load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.nd_beam_topk(
            alive.data_ptr(), log_probs.data_ptr(), b, k, v, n_out,
            scores.data_ptr(), ids.data_ptr(), stream), "beam top-k kernel")
        beam_topk.launches += 1
    return scores, ids


beam_advance.launches = 0
beam_topk.launches = 0
