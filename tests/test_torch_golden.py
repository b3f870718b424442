"""PyTorch port, end to end on the CPU: the port's Translator basecalls
the three golden reads of tests/golden/flagship_golden.json with the
committed flagship checkpoint (f32 compute, float32 wire) to exactly the
stored strings, and its per-base qualities stay within 1 Phred of the
JAX Translator's.  batch_chunks is lowered to 32 to keep CPU time small:
rows decode independently, so the strings cannot depend on the padding."""

import dataclasses
import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "bench_results", "flagship_params.npz")
CONFIG = os.path.join(REPO, "bench_results", "config.json")
GOLDEN = os.path.join(REPO, "tests", "golden", "flagship_golden.json")
GOLDEN_READS = [(101, 900), (202, 2500), (303, 5200)]  # scripts/make_golden.py


def _f32(cfg):
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        decode=dataclasses.replace(cfg.decode, h2d_dtype="float32",
                                   batch_chunks=32))


@pytest.fixture(scope="module")
def calls():
    from nanodecoder_tpu_torch.config import Config
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.io.fast5 import RawRead
    from nanodecoder_tpu_torch.train.checkpoint import load_params_npz
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    cfg = _f32(Config.from_json(open(CONFIG).read()))
    tr = Translator(load_params_npz(NPZ, cfg.model, device="cpu"), cfg,
                    device="cpu")
    spec = SimSpec()
    levels = spec.level_table()
    out = {}
    for seed, n in GOLDEN_READS:
        _truth, sig = simulate_read(np.random.default_rng(seed), n, spec, levels)
        out[f"golden_{seed}"] = (sig, tr.basecall_read(RawRead(f"golden_{seed}", sig, "sim")))
    return out


def test_golden_sequences_exact(calls):
    with open(GOLDEN) as f:
        golden = json.load(f)["reads"]
    assert sorted(calls) == sorted(golden)
    for rid, (_sig, bc) in calls.items():
        assert bc.sequence == golden[rid]["sequence"], rid
        assert bc.qualities.shape == (len(bc.sequence),)


def test_golden_qualities_match_jax_translator(calls):
    import jax

    from nanodecoder_tpu.config import Config as JConfig
    from nanodecoder_tpu.decode.translator import Translator as JTranslator
    from nanodecoder_tpu.io.fast5 import RawRead as JRead
    from nanodecoder_tpu.io.fastx import _phred_string
    from nanodecoder_tpu.models.model import init_model
    from nanodecoder_tpu.train.checkpoint import load_params_npz

    cfg = _f32(JConfig.from_json(open(CONFIG).read()))
    jtr = JTranslator(load_params_npz(NPZ, init_model(jax.random.PRNGKey(0),
                                                      cfg.model)), cfg)
    for rid, (sig, bc) in calls.items():
        ref = jtr.basecall_read(JRead(rid, sig, "sim"))
        assert bc.sequence == ref.sequence, rid
        diff = np.abs(bc.qualities - ref.qualities)
        assert diff.max() <= 1.0, (rid, float(diff.max()))
        # The FASTQ quality strings, Phred+33 rounded, differ by at most 1.
        a = np.frombuffer(_phred_string(bc.qualities).encode(), np.uint8)
        b = np.frombuffer(_phred_string(ref.qualities).encode(), np.uint8)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, rid
