"""Label-smoothed NLL, guided attention, and the per-batch metrics (the
port's counterpart of `nanodecoder_tpu.train.loss`).

Label smoothing puts 1 - eps on the gold label and spreads eps over the
V - 2 labels that are neither gold nor PAD, as the JAX package does;
`torch.nn.functional.cross_entropy(label_smoothing=)` spreads it over all
V and is a different function.
"""

from __future__ import annotations

import torch

from nanodecoder_tpu_torch.vocab import PAD_ID


def _gold(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return log_probs.gather(-1, targets.long()[..., None])[..., 0]


def label_smoothed_nll(log_probs: torch.Tensor, targets: torch.Tensor,
                       smoothing: float = 0.1, pad_id: int = PAD_ID):
    """log_probs: (B, T, V) f32; targets: (B, T) int.  Returns (loss_sum,
    n_tokens, n_correct) over the non-PAD targets; the prediction is the
    argmax, ties to the lowest index."""
    v = log_probs.shape[-1]
    valid = targets != pad_id
    gold_lp = _gold(log_probs, targets)
    if smoothing > 0.0:
        smooth_lp = log_probs.sum(dim=-1) - gold_lp - log_probs[..., pad_id]
        per_tok = -((1.0 - smoothing) * gold_lp + (smoothing / (v - 2)) * smooth_lp)
    else:
        per_tok = -gold_lp
    loss_sum = torch.where(valid, per_tok, torch.zeros((), dtype=per_tok.dtype,
                                                       device=per_tok.device)).sum()
    n_correct = ((log_probs.argmax(dim=-1) == targets) & valid).sum()
    return loss_sum, valid.sum(), n_correct


def guided_attention_loss(attn: torch.Tensor, tgt_lengths: torch.Tensor,
                          enc_lengths: torch.Tensor, sigma: float = 0.2) -> torch.Tensor:
    """Diagonal guided-attention penalty on cross-attention probs
    attn (B, H, T, S): the mass at (t, s) weighted by
    1 - exp(-(s/el - t/tl)^2 / (2 sigma^2)) inside the valid rectangle,
    summed per (b, h), over the valid target rows, mean over (b, h)."""
    _b, _h, t, s = attn.shape
    dev = attn.device
    t_ids = torch.arange(t, dtype=torch.float32, device=dev)[None, :, None]
    s_ids = torch.arange(s, dtype=torch.float32, device=dev)[None, None, :]
    tl = torch.clamp(tgt_lengths.to(torch.float32), min=1.0)[:, None, None]
    el = torch.clamp(enc_lengths.to(torch.float32), min=1.0)[:, None, None]
    diff = s_ids / el - t_ids / tl
    w = 1.0 - torch.exp(-diff.square() / (2.0 * sigma * sigma))
    valid = ((t_ids < tl) & (s_ids < el)).to(torch.float32)
    w = w * valid
    pen = (attn.to(torch.float32) * w[:, None, :, :]).sum(dim=(2, 3))  # (B, H)
    denom = torch.clamp(valid[:, :, 0].sum(dim=-1), min=1.0)[:, None]
    return (pen / denom).mean()


def loss_and_metrics(log_probs: torch.Tensor, targets: torch.Tensor,
                     smoothing: float = 0.1):
    """(mean smoothed loss per token, metrics): loss_sum, xent_sum (the
    unsmoothed NLL, for perplexity), n_tokens, n_correct, all tensors."""
    loss_sum, n_tokens, n_correct = label_smoothed_nll(log_probs, targets, smoothing)
    loss = loss_sum / torch.clamp(n_tokens, min=1).to(torch.float32)
    valid = targets != PAD_ID
    gold_lp = _gold(log_probs, targets)
    xent_sum = -torch.where(valid, gold_lp, torch.zeros((), dtype=gold_lp.dtype,
                                                        device=gold_lp.device)).sum()
    return loss, {"loss_sum": loss_sum, "xent_sum": xent_sum,
                  "n_tokens": n_tokens, "n_correct": n_correct}
