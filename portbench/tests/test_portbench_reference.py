"""The benchmark's plain reference against the program, at tiny sizes on
the CPU: the forward pass (MQA, MHA, the tiling), the dropout masks, the
train step, the host side of basecalling and read identity."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from nanodecoder_tpu_torch import prng
from nanodecoder_tpu_torch.config import tiny_test_config
from nanodecoder_tpu_torch.models.model import decode_teacher_forced, encode, init_model
from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy, params_to_numpy
from portbench import sim, train
from portbench.reference import signal as rsig
from portbench.reference import threefry
from portbench.reference.model import Ref, tile_kv_heads


def tiny(kv_heads):
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dec_kv_heads=kv_heads))


def inputs(cfg, seed=0, rows=3):
    rng = np.random.default_rng(seed)
    s = cfg.signal.chunk_len
    signal = torch.from_numpy(rng.normal(size=(rows, s)).astype(np.float32))
    lengths = torch.tensor([s, s // 2, s // 3])[:rows]
    tgt = torch.from_numpy(rng.integers(4, cfg.model.vocab_size,
                                        size=(rows, cfg.model.max_decode_len)))
    tgt[:, 0] = 1
    return signal, lengths, tgt


@pytest.mark.parametrize("kv_heads", [0, 1])
@pytest.mark.parametrize("dropout", [False, True])
def test_forward_matches_the_program(kv_heads, dropout):
    cfg = tiny(kv_heads)
    params = init_model(prng.PRNGKey(3), cfg.model)
    flat = {k: torch.from_numpy(v) for k, v in params_to_numpy(params).items()}
    model = dataclasses.asdict(cfg.model)
    key = prng.PRNGKey(11) if dropout else None
    signal, lengths, tgt = inputs(cfg)
    with torch.no_grad():
        mem, mlen = encode(params, cfg.model, signal, lengths, key, train=dropout)
        lp, attn = decode_teacher_forced(params, cfg.model, tgt, mem, mlen, key, train=dropout)
        ref = Ref(flat, model, dropout=cfg.model.dropout)
        rmem, rlen = ref.encode(signal, lengths, key=key)
        rlp, rattn = ref.decode(tgt, rmem, rlen, key=key)
    assert torch.equal(mlen.long(), rlen)
    torch.testing.assert_close(rmem, mem, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rlp, lp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rattn, attn, rtol=1e-5, atol=1e-6)


def test_tiling_is_the_same_function():
    cfg = tiny(1)
    flat = params_to_numpy(init_model(prng.PRNGKey(5), cfg.model))
    tiled = tile_kv_heads(flat, cfg.model.dec_heads)
    assert tiled["decoder/layers/0/cross_attn/k/w"].shape[1] == cfg.model.d_model
    signal, lengths, tgt = inputs(cfg, 1)
    outs = []
    for f, kv in ((flat, 1), (tiled, 0)):
        model = dict(dataclasses.asdict(cfg.model), dec_kv_heads=kv)
        ref = Ref({k: torch.from_numpy(v) for k, v in f.items()}, model)
        with torch.no_grad():
            outs.append(ref.decode(tgt, *ref.encode(signal, lengths))[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("offset", [0, 5, 2**32 - 3])
def test_dropout_masks_are_the_programs(offset):
    key = prng.split(prng.PRNGKey(2**31 + 7))[1]
    ours = threefry.bernoulli(key, 0.9, (3, 50, 7), "cpu", offset=offset)
    theirs = prng.bernoulli(key, 0.9, (3, 50, 7), device="cpu", offset=offset)
    assert torch.equal(ours, theirs)
    assert np.array_equal(threefry.split(key, 4), prng.split(key, 4))


def test_train_steps_match_the_program():
    cfg = tiny(1)
    params = init_model(prng.PRNGKey(9), cfg.model)
    flat = params_to_numpy(params)
    config = {"config": json.loads(cfg.to_json())}
    traffic = {"batch": 4, "prefetch": 2}
    cell = train.TrainCell(config, traffic, flat, "cpu", seed=2**33 + 1)
    cell.read_first_steps()
    prog = (cell.losses, cell.grad1, cell.params3)
    cell.free()
    ref = train.reference_readings(config, traffic, flat, 2**33 + 1, "cpu")
    g = train.gaps(prog, ref, flat)
    assert g["loss_gap"] < 1e-5 and g["grad_gap"] < 1e-4 and g["change_gap"] < 1e-2, g


def test_host_side_matches_the_program():
    from nanodecoder_tpu_torch.decode.finish import stitch_read
    from nanodecoder_tpu_torch.io.signal import (chunk_signal, convert_h2d, normalize_signal,
                                                 wire_to_f32)
    from nanodecoder_tpu_torch.vocab import make_vocab

    src = sim.ReadSource(2**40 + 3, {"median_bases": 600, "sigma": 0.7, "min_bases": 300,
                                     "max_bases": 2000, "block": 8, "per_file": 4})
    _truth, sig = src.read(3)
    z = normalize_signal(sig, "mad", 1.4826, 5.0)
    assert np.array_equal(rsig.normalize(sig, 1.4826, 5.0), z)
    cb = chunk_signal(z, 2048, 256, 0.25)
    chunks, lengths, starts = rsig.chunk(z, 2048, 256, 0.25)
    assert np.array_equal(chunks, cb.chunks) and np.array_equal(starts, cb.starts)
    wire = wire_to_f32(torch.from_numpy(convert_h2d(cb.chunks, "int6", 5.0)), "int6", 5.0, 2048)
    assert np.array_equal(rsig.int6_round_trip(chunks), wire.numpy())
    rng = np.random.default_rng(4)
    parts = []
    for _ in range(cb.n_chunks):
        n = int(rng.integers(1, 60))
        toks = rng.integers(4, 344, size=96)
        toks[n - 1] = 2
        parts.append((toks, n, -rng.random(96).astype(np.float32), np.zeros(96, np.int64)))
    seq, qual = stitch_read(parts, cb.starts, cb.lengths, 2048, 256, "trim", make_vocab(4))
    itos = rsig.kmer_tokens(4)
    seqs, quals = [], []
    for toks, n, lps, _pos in parts:
        s, (lp,) = rsig.expand(toks[:n], itos, lps[:n])
        seqs.append(s)
        quals.append(rsig.phred(lp))
    rseq, rqual = rsig.trim_stitch(seqs, quals, starts, lengths, 2048)
    assert rseq == seq
    np.testing.assert_allclose(rqual, qual, rtol=1e-6)


def test_kmer_ids_are_the_vocabulary():
    from nanodecoder_tpu_torch.vocab import make_vocab

    bases = np.random.default_rng(1).integers(0, 4, size=23)
    text = "".join("ACGT"[b] for b in bases)
    assert np.array_equal(sim.kmer_ids(bases.astype(np.uint8), 4), make_vocab(4).encode(text))


def test_identity_matches_the_program():
    from nanodecoder_tpu_torch.identity import read_identity_plain

    from portbench.identity import Identity

    ident = Identity()
    rng = np.random.default_rng(8)
    for n in (0, 5, 300, 1200):
        a = "".join(rng.choice(list("ACGT"), size=n))
        b = list(a)
        for i in rng.integers(0, max(n, 1), size=n // 10):
            b[min(int(i), len(b) - 1)] = "A" if n else ""
        b = "".join(b)[:max(n - n // 20, 0)] + "GATTACA"
        assert ident(b, a) == pytest.approx(read_identity_plain(b, a), abs=0)


def test_compare_plan_rows_follow_the_stream():
    from portbench import serve

    reads = {"median_bases": 600, "sigma": 0.7, "min_bases": 300, "max_bases": 2000,
             "block": 8, "per_file": 4}
    traffic = {"reads": reads, "identity_reads": 5, "compare_from": 20}
    scfg = {"chunk_len": 2048, "chunk_overlap": 256, "min_chunk_fill": 0.25}
    plan = serve.compare_plan(2**33 + 5, traffic, scfg, batch_rows=3)
    assert plan == serve.compare_plan(2**33 + 5, traffic, scfg, batch_rows=3)
    assert len(plan.reads) == 5 and plan.reads == sorted(plan.reads) and plan.reads[-1] < 20
    src = sim.ReadSource(2**33 + 5, reads)
    row, firsts, counts = 0, {}, {}
    for i in range(plan.reads[-1] + 1):
        _truth, sig = src.read(i)
        assert src.n_samples(i) == sig.shape[0]
        firsts[i], counts[i] = row, rsig.chunk(sig, 2048, 256, 0.25)[0].shape[0]
        row += counts[i]
    assert plan.first_rows == [firsts[i] for i in plan.reads]
    assert plan.n_chunks == [counts[i] for i in plan.reads]
    want = {r // 3 for i in plan.reads for r in range(firsts[i], firsts[i] + counts[i])}
    assert plan.batches == want
