"""Batch basecalling: host orchestration around encode + decode.

The port's counterpart of `nanodecoder_tpu.decode.translator`, in
greedy, beam and sample mode:
  * normalize and chunk each read (io.signal) and pack the chunks into
    fixed-size batches (`DecodeConfig.effective_batch_chunks`), padding
    the last with length-0 rows;
  * per batch: convert to the H2D wire on the host, unpack it on the
    device, encode, decode (greedy, beam search keeping the best
    hypothesis, or sampling), and bring back a compact result (int16 ids and
    positions, f16 log-probs);
  * expand tokens to bases with per-base Phred qualities and stitch the
    chunks back into reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from nanodecoder_tpu_torch import prng
from nanodecoder_tpu_torch.config import Config
from nanodecoder_tpu_torch.decode.beam import beam_decode, needs_coverage
from nanodecoder_tpu_torch.decode.finish import stitch_read
from nanodecoder_tpu_torch.decode.greedy import greedy_decode
from nanodecoder_tpu_torch.decode.sampling import sample_decode
from nanodecoder_tpu_torch.device import resolve_device
from nanodecoder_tpu_torch.io.fast5 import RawRead
from nanodecoder_tpu_torch.io.signal import (chunk_signal, convert_h2d,
                                             normalize_signal, wire_to_f32)
from nanodecoder_tpu_torch.models.model import encode, params_to, prepare_serving_params
from nanodecoder_tpu_torch.utils.logging import get_logger
from nanodecoder_tpu_torch.vocab import make_vocab


@dataclasses.dataclass
class Basecall:
    """One basecalled read."""

    read_id: str
    sequence: str
    mean_qscore: float
    n_chunks: int
    n_samples: int
    # Per-base Phred scores, positionally aligned with `sequence`.
    qualities: np.ndarray | None = None


class Translator:
    """Basecaller over one model on one device, greedy, beam search or
    sampling (`config.decode.mode`).

    params: the nested parameter dict of train.checkpoint.load_params_npz.
    The serving fold runs once here, on the device.  Counters for the
    record: `batches` (device batches run) and `decode_steps` (decode
    steps run over all batches).

    Sample mode needs temperature > 0.  It is keyed as the JAX package's
    Translator keys it: each dispatched batch draws with fold_in(
    PRNGKey(sampling_seed), batch_no), batch_no counting the batches that
    `decode_program` ran, from 0, so a fixed seed and batch order give the
    JAX package's tokens, on the CPU and on the card alike."""

    def __init__(self, params: dict[str, Any], config: Config,
                 device: str | torch.device = "cuda"):
        mode = config.decode.mode
        if mode not in ("greedy", "beam", "sample"):
            raise ValueError(f"unknown decode mode {mode!r}")
        if mode == "sample" and config.decode.temperature <= 0.0:
            raise ValueError("sample mode needs temperature > 0")
        if mode == "beam" and needs_coverage(config.decode) and config.decode.use_pallas:
            get_logger("beam").warning(
                "coverage_penalty=%r turns off the beam advance kernel (K3) and the "
                "decode kernels: it needs the attention probabilities, which they "
                "never materialise; expect a slower decode",
                config.decode.coverage_penalty)
        self.device = resolve_device(device)
        # Full-precision f32 products: a float32 conv would otherwise run
        # in TF32 through cuDNN, which the f32 goldens do not tolerate.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.inference_mode():
            self.params = prepare_serving_params(
                params_to(params, self.device), config.model)
        self.config = config
        self.vocab = make_vocab(config.model.kmer_k)
        self._h2d = config.decode.resolve_h2d(config.model.compute_dtype)
        self.batches = 0
        self.decode_steps = 0
        self.sample_batches = 0
        self._sample_key = prng.PRNGKey(config.decode.sampling_seed)

    @staticmethod
    def _compact_d2h(tokens, lengths, lps, scores, sample_pos):
        """Shrink the device->host transfer: ids and sample positions fit
        int16, f16 log-probs keep ~3 significant digits (far inside Phred
        rounding).  decode_chunk_batch converts back on the host."""
        return (tokens.to(torch.int16), lengths, lps.to(torch.float16), scores,
                sample_pos.to(torch.int16))

    def _encode(self, wire: np.ndarray, lengths: np.ndarray):
        signal = wire_to_f32(torch.from_numpy(wire).to(self.device), self._h2d,
                             self.config.signal.clip_sigma,
                             self.config.signal.chunk_len)
        lens = torch.from_numpy(lengths.astype(np.int32)).to(self.device)
        return encode(self.params, self.config.model, signal, lens)

    def _beam(self, wire: np.ndarray, lengths: np.ndarray):
        res = beam_decode(self.params, self.config.model, self.config.decode,
                          *self._encode(wire, lengths))
        self.decode_steps += res.steps
        return res

    @torch.inference_mode()
    def decode_program(self, wire: np.ndarray, lengths: np.ndarray, rows: slice | None = None):
        """Encode and decode one batch of wire rows on the device; the best
        hypothesis of each chunk in beam mode, with its per-token log-probs
        and positions; in sample mode with the next batch's key.  `rows`
        decodes only those rows of the batch (a data-parallel rank's share,
        `parallel.mesh.MeshPlan.shard_decode_fn`); sample mode then draws
        these rows' noise at their place in the batch, so each row samples
        as it does in the whole batch.  Returns the compact device
        tensors of `_compact_d2h`: (tokens int16, lengths, log-probs f16,
        scores, sample positions int16).  The streaming engine runs it too."""
        cfg = self.config.model
        row0 = 0
        if rows is not None:
            row0 = rows.start or 0
            wire, lengths = wire[rows], lengths[rows]
        if self.config.decode.mode == "beam":
            res = self._beam(wire, lengths)
            tokens, tok_lengths, lps, scores, attn_pos = (
                res.tokens[:, 0], res.lengths[:, 0], res.token_log_probs[:, 0],
                res.scores[:, 0], res.attn_pos[:, 0])
        else:
            if self.config.decode.mode == "sample":
                key = prng.fold_in(self._sample_key, self.sample_batches)
                self.sample_batches += 1
                res = sample_decode(self.params, cfg, self.config.decode,
                                    *self._encode(wire, lengths), key, row0)
            else:
                res = greedy_decode(self.params, cfg, *self._encode(wire, lengths),
                                    min_len=self.config.decode.min_len)
            self.decode_steps += res.steps
            tokens, tok_lengths, lps, scores, attn_pos = (
                res.tokens, res.lengths, res.token_log_probs, res.scores,
                res.attn_pos)
        # Encoder position -> sample position (center of the conv window).
        ds = cfg.time_downsample
        sample_pos = attn_pos * ds + ds // 2
        return self._compact_d2h(tokens, tok_lengths, lps, scores, sample_pos)

    def decode_nbest(self, chunks: np.ndarray, lengths: np.ndarray):
        """Beam mode's n-best hypotheses of each chunk, all chunks in one
        batch: (tokens (N, n_best, T), lengths (N, n_best), scores
        (N, n_best)) as numpy."""
        dcfg = self.config.decode
        if dcfg.mode != "beam":
            raise ValueError("decode_nbest requires beam mode")
        wire = convert_h2d(np.asarray(chunks, np.float32), self._h2d,
                           self.config.signal.clip_sigma)
        with torch.inference_mode():
            res = self._beam(wire, np.asarray(lengths))
        self.batches += 1
        nb = min(dcfg.n_best, dcfg.beam_size)
        return (res.tokens[:, :nb].cpu().numpy(), res.lengths[:, :nb].cpu().numpy(),
                res.scores[:, :nb].cpu().numpy())

    def decode_chunk_batch(self, chunks: np.ndarray, lengths: np.ndarray):
        """chunks: (N, chunk_len) -> (tokens, tok_lengths, token_lps,
        scores, attn_sample_pos) as numpy, with padding rows stripped."""
        bsz = self.config.decode.effective_batch_chunks()
        n = chunks.shape[0]
        outs: list[list[np.ndarray]] = [[], [], [], [], []]
        for i in range(0, n, bsz):
            batch = chunks[i:i + bsz]
            blen = lengths[i:i + bsz]
            real = batch.shape[0]
            if real < bsz:  # pad to the fixed batch shape with length-0 rows
                batch = np.concatenate(
                    [batch, np.zeros((bsz - real, batch.shape[1]), batch.dtype)])
                blen = np.concatenate([blen, np.zeros((bsz - real,), blen.dtype)])
            wire = convert_h2d(np.asarray(batch, np.float32), self._h2d,
                               self.config.signal.clip_sigma)
            results = self.decode_program(wire, blen)
            self.batches += 1
            for acc, r in zip(outs, results):
                acc.append(r[:real].cpu().numpy())
        # Restore host working dtypes from the compact forms.
        host_dtypes = (np.int32, np.int32, np.float32, np.float32, np.int32)
        return tuple(np.concatenate(acc).astype(dt)
                     for acc, dt in zip(outs, host_dtypes))

    def basecall_read(self, read: RawRead, stitch_method: str = "trim") -> Basecall:
        scfg = self.config.signal
        norm = normalize_signal(read.signal, scfg.normalization, scfg.mad_scale,
                                scfg.clip_sigma)
        cb = chunk_signal(norm, scfg.chunk_len, scfg.chunk_overlap,
                          scfg.min_chunk_fill)
        tokens, tok_lengths, token_lps, _scores, attn_pos = \
            self.decode_chunk_batch(cb.chunks, cb.lengths)
        parts = [(tokens[i], int(tok_lengths[i]), token_lps[i], attn_pos[i])
                 for i in range(cb.n_chunks)]
        seq, qual = stitch_read(parts, cb.starts, cb.lengths, scfg.chunk_len,
                                scfg.chunk_overlap, stitch_method, self.vocab)
        mean_q = float(qual.mean()) if qual.size else 0.0
        return Basecall(read_id=read.read_id, sequence=seq, mean_qscore=mean_q,
                        n_chunks=cb.n_chunks, n_samples=read.n_samples,
                        qualities=qual)

    def basecall_reads(self, reads: Iterable[RawRead]) -> Iterator[Basecall]:
        for read in reads:
            yield self.basecall_read(read)
