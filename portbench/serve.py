"""Serving cells: the program's streaming engine basecalling simulated
reads greedily for a fixed window, and the comparison that decides
`correct`.

Set-up builds one `StreamingBasecaller` on the card from the
configuration's weights (its decoder K/V tiled by the benchmark's own
copy where it asks for MHA) and runs it once over a fixed warm-up stream
of reads, which starts the ingest processes, builds the kernels and
meets every shape the window uses (full and partial batches, every
decode stage).  The window runs `StreamingBasecaller.run` over the seed's
stream, as the basecall CLI does (trim stitch, FASTQ); when it closes the
stream stops and the engine finishes what it was given.  The rate's
window runs from the start to the first record the engine reports written
at or after `--seconds` (`Window.rate_window`).

The reads compared are `identity_reads` of the first `compare_from` of
the stream, drawn from the seed (`compare_plan`): a fixed number, at
fixed places, which never grows with the program's speed, spread over
the batches before and after the engine's dispatch-ahead fills.  The
stream never stops before it has given them.  The engine dispatches as
it does without the benchmark; a helper thread waits for each batch's
copy to the host (polling its event, without spinning a core) and keeps
the decoded lengths of every batch and the tokens and log-probabilities
of the batches that hold compared rows.
After the window the reference works those reads out again (the
normalization, chunks and int6 wire) and judges:
  * every read the engine was given is written exactly once, and nothing
    else (`reads_not_once`, limit 0);
  * the compared reads' records equal the k-mer expansion and trim
    stitch of their chunks' served tokens, the qualities within one
    Phred (`records_mismatched`, limit 0);
  * over every chunk of the compared reads, the plain float32 model
    teacher-forced over the chunk's served tokens: the widest gap by
    which a served token's log-probability lies below the reference's
    best (`token_gap_max`).
"""

from __future__ import annotations

import dataclasses
import io
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench import reference, sim
from portbench.feed import Feed, simulated_ingest
from portbench.identity import Identity
from portbench.reference import signal as rsig
from portbench.reference.model import tile_kv_heads

WARM_SEED = 7
BLOCK_CHUNKS = 64
PICK_STREAM = 1 << 41
POLL_S = 0.005           # the helper thread's sleep between polls of a batch's event


class WindowMeter:
    """The engine's meter: the time and samples of each record written."""

    def __init__(self):
        self.marks: list[tuple[float, int]] = []
        self.n_samples = self.n_reads = self.n_bases = self.n_chunks = 0

    def update(self, n_samples: int, n_bases: int, n_chunks: int, n_reads: int = 1) -> None:
        self.marks.append((time.perf_counter(), n_samples))


@dataclasses.dataclass
class Plan:
    """The reads a window's comparison covers (sorted stream indices),
    each one's first row in the stream of batch rows and its chunks, and
    the batches that hold their rows."""
    reads: list[int]
    first_rows: list[int]
    n_chunks: list[int]
    batches: set[int]


def compare_plan(seed: int, traffic: dict, scfg: dict, batch_rows: int) -> Plan:
    """`identity_reads` reads drawn from the seed among the stream's first
    `compare_from`; their rows follow from the lengths of the reads before
    them (the engine packs chunks in stream order)."""
    picked = np.sort(np.random.default_rng([int(seed), PICK_STREAM]).choice(
        traffic["compare_from"], traffic["identity_reads"], replace=False))
    source = sim.ReadSource(seed, traffic["reads"])
    wanted, plan, row = set(picked.tolist()), Plan([], [], [], set()), 0
    for i in range(int(picked[-1]) + 1):
        n = len(rsig.chunk_starts(source.n_samples(i), scfg["chunk_len"],
                                  scfg["chunk_overlap"], scfg["min_chunk_fill"]))
        if i in wanted:
            plan.reads.append(i)
            plan.first_rows.append(row)
            plan.n_chunks.append(n)
            plan.batches.update(range(row // batch_rows, (row + n - 1) // batch_rows + 1))
        row += n
    return plan


def keep_outputs(host, event, full: bool):
    """On the helper thread: wait for a batch's copy to the host and keep
    pageable copies of its decoded lengths, and with `full` of its tokens
    and log-probabilities.  The wait polls the event and sleeps between
    polls: `event.synchronize()` spins a CPU core for as long as it waits,
    which is the whole window here, and that core is taken from the
    engine's dispatching thread and ingest processes."""
    if event is not None:
        while not event.query():
            time.sleep(POLL_S)
    tokens, tlens, lps = host[:3]
    if not full:
        return None, np.array(tlens.numpy()), None
    return np.array(tokens.numpy()), np.array(tlens.numpy()), np.array(lps.numpy())


@dataclasses.dataclass
class Window:
    seed: int
    seconds: float
    t0: float
    meter: WindowMeter
    records: str
    batches: list            # [outputs (tokens or None, lengths, log-probs or None),
                             #  wire lengths, steps, dispatch start, dispatch end] per batch
    given: int               # reads given to the engine
    stages: dict
    traced: range
    plan: Plan | None

    def rate_window(self) -> tuple[int, float]:
        """(samples, seconds) of the window: from its start to the first
        record written at or after `seconds` (the engine writes a batch's
        records together, so a fixed end would count whole batches), and the
        samples of every record written up to then, that one included."""
        marks = sorted(self.meter.marks)
        end = self.t0 + self.seconds
        after = [t for t, _n in marks if t >= end]
        close = after[0] if after else (marks[-1][0] if marks else end)
        return sum(n for t, n in marks if t <= close), close - self.t0


class ServeCell:
    def __init__(self, config: dict, traffic: dict, flat: dict, device):
        from nanodecoder_tpu_torch.config import Config
        from nanodecoder_tpu_torch.decode.engine import StreamingBasecaller
        from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy

        if traffic["mode"] != "greedy":
            raise ValueError(f"no comparison for {traffic['mode']!r} serving yet")
        cfg = Config.from_json(json.dumps(config["config"]))
        serving = config["serving"]
        dec = dict(serving["decode"], mode="greedy",
                   batch_chunks_engine=traffic["batch_chunks"])
        self.cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **serving["model"]),
            decode=dataclasses.replace(cfg.decode, **dec))
        if config.get("kv_tiling") == "mha":
            flat = tile_kv_heads(flat, cfg.model.dec_heads)
        self.flat = flat
        self.traffic = traffic
        self.reads = traffic["reads"]
        self.device = torch.device(device)
        self.model = dataclasses.asdict(self.cfg.model)
        self.engine = StreamingBasecaller(params_from_numpy(flat, self.cfg.model, self.device),
                                          self.cfg, depth=traffic["depth"], attn_pos=False,
                                          device=self.device)

    def plan(self, seed: int) -> Plan:
        scfg = dataclasses.asdict(self.cfg.signal)
        return compare_plan(seed, self.traffic, scfg, self.cfg.decode.batch_chunks_engine)

    def warm(self) -> None:
        """A full batch and a partial one over the warm-up stream (reads of
        about 19 chunks on average)."""
        n = int(1.5 * self.cfg.decode.batch_chunks_engine / 19) + 1
        self.window(WARM_SEED, None, limit=n)

    def window(self, seed: int, seconds: float | None, limit: int | None = None,
               tracer=None, trace_batches: range = range(0), plan: Plan | None = None) -> Window:
        eng = self.engine
        feed = Feed(seed, self.reads, limit,
                    min_reads=plan.reads[-1] + 1 if plan is not None else 0)
        meter, sink = WindowMeter(), io.StringIO()
        batches: list = []
        dispatch = eng._decode
        keeper = ThreadPoolExecutor(max_workers=1, thread_name_prefix="portbench-keep")
        full = plan.batches if plan is not None else set()

        def record(wire, lengths, stop=False):
            b = len(batches)
            if tracer is not None and b == trace_batches.start:
                tracer.start()
            if tracer is not None and b == trace_batches.stop:
                tracer.stop()
            s0, t0 = eng.decode_steps, time.perf_counter()
            host, event, stopped = dispatch(wire, lengths, stop)
            kept = None if host is None else keeper.submit(keep_outputs, host, event, b in full)
            batches.append([kept, np.array(lengths), eng.decode_steps - s0, t0,
                            time.perf_counter()])
            return host, event, stopped

        from nanodecoder_tpu_torch.utils.profiling import StageTimer

        timer = StageTimer()
        eng._decode = record
        closer = threading.Timer(seconds, feed.stop) if seconds is not None else None
        try:
            with simulated_ingest():
                t0 = time.perf_counter()
                if closer is not None:
                    closer.start()
                eng.run(feed, sink, stitch_method="trim", num_workers=self.traffic["workers"],
                        meter=meter, stage_timer=timer)
                run_s = time.perf_counter() - t0
        finally:
            if closer is not None:
                closer.cancel()
            del eng._decode
            keeper.shutdown(wait=True)
        for b in batches:
            b[0] = b[0].result() if b[0] is not None else None
        if tracer is not None and tracer.trace is None and len(batches) > trace_batches.start:
            tracer.stop()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return Window(seed=seed, seconds=seconds or run_s, t0=t0, meter=meter,
                      records=sink.getvalue(), batches=batches, given=feed.given,
                      stages=timer.summary(), traced=trace_batches, plan=plan)

    def free(self) -> None:
        self.engine = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the comparison


def parse_fastq(text: str) -> list[tuple[str, str, str]]:
    lines = text.splitlines()
    return [(lines[i][1:], lines[i + 1], lines[i + 3]) for i in range(0, len(lines) - 3, 4)]


@dataclasses.dataclass
class ReadRef:
    index: int
    truth: str
    chunks: np.ndarray    # the signal the device decodes, (n, chunk_len) f32
    lengths: np.ndarray
    starts: np.ndarray
    first_row: int        # the read's first row in the stream of batch rows


def reference_reads(source: sim.ReadSource, plan: Plan, scfg: dict) -> list[ReadRef]:
    out = []
    for i, row, n in zip(plan.reads, plan.first_rows, plan.n_chunks):
        truth, signal = source.read(i)
        z = rsig.normalize(signal, scfg["mad_scale"], scfg["clip_sigma"])
        chunks, lengths, starts = rsig.chunk(z, scfg["chunk_len"], scfg["chunk_overlap"],
                                             scfg["min_chunk_fill"])
        assert chunks.shape[0] == n, (i, chunks.shape[0], n)
        out.append(ReadRef(i, truth, rsig.int6_round_trip(chunks), lengths, starts, row))
    return out


def served(win: Window, rr: ReadRef, batch_rows: int):
    """The read's chunks as served: [(tokens, n tokens, log-probs)]."""
    parts = []
    for r in range(rr.first_row, rr.first_row + rr.chunks.shape[0]):
        tokens, tlens, lps = win.batches[r // batch_rows][0]
        row = r % batch_rows
        parts.append((tokens[row].astype(np.int64), int(tlens[row]),
                      lps[row].astype(np.float32)))
    return parts


def record_matches(rec: tuple[str, str], rr: ReadRef, parts, itos, chunk_len: int) -> bool:
    seqs, quals = [], []
    for tokens, n, lps in parts:
        s, (lp,) = rsig.expand(tokens[:n], itos, lps[:n])
        seqs.append(s)
        quals.append(rsig.phred(lp.astype(np.float32)) if lp.size else np.zeros(0))
    seq, qual = rsig.trim_stitch(seqs, quals, rr.starts, rr.lengths, chunk_len)
    if rec[0] != seq or len(rec[1]) != len(seq):
        return False
    want = 33 + np.clip(np.rint(qual), 0, 93)
    got = np.frombuffer(rec[1].encode("ascii"), np.uint8).astype(np.float64)
    return bool(np.all(np.abs(got - want) <= 1))


@torch.no_grad()
def token_gaps(ref_cls, flat_t: dict, model: dict, rows: list, device,
               precision: str | None):
    """Teacher-force the float32 reference (`ref_cls`, a reference
    module's `Ref`) over each chunk's served tokens.
    rows: [(signal (chunk_len,), length, tokens (T,), n tokens)].
    Returns (the widest gap below the reference's best of the served
    tokens, and with `precision`, the widest such gap of the token that
    this precision's reference, put in the program's place, puts first)."""
    ref = ref_cls(flat_t, model)
    ctl = ref_cls(flat_t, model, precision) if precision else None
    tok_gap = ctl_tok = 0.0
    tmax = model["max_decode_len"]
    for lo in range(0, len(rows), BLOCK_CHUNKS):
        blk = rows[lo:lo + BLOCK_CHUNKS]
        sig = torch.from_numpy(np.stack([r[0] for r in blk])).to(device)
        slen = torch.tensor([r[1] for r in blk], device=device)
        toks = torch.from_numpy(np.stack([r[2] for r in blk])).to(device)
        n = torch.tensor([r[3] for r in blk], device=device)
        tgt_in = torch.cat([torch.ones_like(toks[:, :1]), toks[:, :-1]], dim=1).clamp_min(0)
        valid = torch.arange(tmax, device=device)[None, :] < n[:, None]
        readings = []
        for m in (ref, ctl) if ctl else (ref,):
            mem, mlen = m.encode(sig, slen)
            lp, _ = m.decode(tgt_in, mem, mlen)
            readings.append(lp)
        lp = readings[0]
        best = lp.max(dim=-1).values
        at = lp.gather(-1, toks[..., None].clamp_min(0))[..., 0]
        tok_gap = max(tok_gap, float(torch.where(valid, best - at, 0.0).max()))
        if ctl:
            first = readings[1].argmax(dim=-1, keepdim=True)
            ctl_tok = max(ctl_tok, float(torch.where(
                valid, best - lp.gather(-1, first)[..., 0], 0.0).max()))
    return tok_gap, ctl_tok


def judge(cell: ServeCell, win: Window, config: dict, device, control: str | None = None):
    """(checks {name: value}, read_identity, control readings or None,
    what was compared)."""
    scfg = config["config"]["signal"]
    source = sim.ReadSource(win.seed, cell.reads)
    recs = parse_fastq(win.records)
    counts: dict[str, int] = {}
    for rid, _s, _q in recs:
        counts[rid] = counts.get(rid, 0) + 1
    fed = {sim.ReadSource.read_id(i) for i in range(win.given)}
    not_once = sum(1 for r in fed if counts.get(r, 0) != 1) + sum(
        1 for r in counts if r not in fed)
    by_id = {rid: (s, q) for rid, s, q in recs}
    refs = reference_reads(source, win.plan, scfg)
    itos = rsig.kmer_tokens(cell.model["kmer_k"])
    rows_b = cell.cfg.decode.batch_chunks_engine
    ident = Identity()
    identities, mismatched = [], 0
    for rr in refs:
        rec = by_id.get(sim.ReadSource.read_id(rr.index))
        if rec is None:
            continue
        identities.append(ident(rec[0], rr.truth))
        if not record_matches(rec, rr, served(win, rr, rows_b), itos, scfg["chunk_len"]):
            mismatched += 1
    rows = []
    for rr in refs:
        for (tokens, n, _lps), c, ln in zip(served(win, rr, rows_b), rr.chunks, rr.lengths):
            rows.append((c, int(ln), tokens, n))
    flat_t = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
              for k, v in cell.flat.items()}
    tok_gap, ctl_tok = token_gaps(reference.module(config).Ref, flat_t, cell.model, rows,
                                  device, control)
    checks = {"reads_not_once": not_once, "records_mismatched": mismatched,
              "token_gap_max": tok_gap}
    ctl = {"token_gap_max": ctl_tok} if control else None
    extra = {"tokens_compared": int(sum(r[3] for r in rows)), "chunks_compared": len(rows),
             "batches_compared": sorted(win.plan.batches)}
    return checks, float(np.mean(identities)) if identities else 0.0, ctl, extra
