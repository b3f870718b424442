"""What a configuration file brings of its own: the reference module that
judges it and counts its work, and its weights (an `.npz` or a draw); the
recurrent family's reference against the program, and a tiny RNN
training run through the harness."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from nanodecoder_tpu_torch import prng
from nanodecoder_tpu_torch.config import Config, tiny_test_config
from nanodecoder_tpu_torch.models.model import decode_teacher_forced, encode, init_model
from nanodecoder_tpu_torch.train.checkpoint import expected_param_shapes, params_to_numpy
from portbench import reference, run, train, weights, work
from portbench.reference import model as transformer
from portbench.reference import rnn
from portbench.tests.helpers import tiny_spec

SEED = 2**35 + 17
RNN_FILE = "portbench/tests/rnn-flagship.json"


def config(name):
    return run.load_json(run.BENCH, "configs", name + ".json")


def rnn_spec():
    """The RNN flagship, at its widths, under the train cell's traffic
    (cut to a batch of 4) and limits."""
    spec = tiny_spec("mqa.train")
    spec["config"] = run.load_json(run.ROOT, RNN_FILE)
    return spec


def test_a_configuration_names_its_reference():
    assert reference.module(config("mqa-flagship")) is transformer
    assert "reference" not in config("mha-flagship")
    assert reference.module(run.load_json(run.ROOT, RNN_FILE)) is rnn


# The transformer's counts as work.py gave them before they moved to its
# reference module: a served batch of five chunks, and a step at the train
# cell's shape.
LENGTHS, DECODED = np.array([2048, 2048, 1500, 700, 512]), np.array([96, 80, 61, 30, 1])
PINNED = {"mqa-flagship": (15897275392.0, 5487986737152.0),
          "mha-flagship": (16962497536.0, 5860038279168.0)}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_transformer_work_is_pinned(name):
    m = config(name)["config"]["model"]
    assert transformer.serve_batch_flops(m, 2048, LENGTHS, DECODED) == PINNED[name][0]
    assert transformer.train_step_flops(m, 512, 2048, 96) == PINNED[name][1]


def test_rnn_work_counts_every_weight_twice_a_use():
    """A dense product costs 2 operations a weight a use: the biLSTM's
    matrices once an encoder position, the decoder's cells, attention
    projections and generator once a token, and 4 D a memory position a
    token for the scores and the context."""
    m = run.load_json(run.ROOT, RNN_FILE)["config"]["model"]
    shapes = rnn.param_shapes(m)
    size = {k: math.prod(v) for k, v in shapes.items() if len(v) == 2}
    enc = sum(n for k, n in size.items() if k.startswith("encoder/body/"))
    dec = sum(n for k, n in size.items() if k.startswith(("decoder/", "generator")))
    s, d, tmax = 256, m["d_model"], 96
    front = transformer.param_shapes(m)   # the same front-end
    assert all(front[k] == shapes[k] for k in front if k.startswith("encoder/frontend/"))
    fwd = work.frontend_flops(m, 2048) + s * 2.0 * enc
    per_tok = 2.0 * dec + 4.0 * d * s
    assert rnn.train_step_flops(m, 512, 2048, tmax) == pytest.approx(
        3 * 512 * (fwd + tmax * per_tok), rel=1e-12)
    served = rnn.serve_batch_flops(m, 2048, LENGTHS, DECODED)
    mem = -(-LENGTHS // 8)
    assert served == pytest.approx(5 * fwd + DECODED.sum() * 2.0 * dec
                                   + 4.0 * d * (mem * DECODED).sum(), rel=1e-12)


def test_the_draw_repeats_and_has_the_programs_names_and_shapes():
    conf = run.load_json(run.ROOT, RNN_FILE)
    cfg = Config.from_json(json.dumps(conf["config"]))
    a = weights.flat_params(conf, run.ROOT)
    b = weights.flat_params(conf, run.ROOT)
    assert {k: v.shape for k, v in a.items()} == expected_param_shapes(cfg.model)
    assert all(np.array_equal(a[k], b[k]) and a[k].dtype == np.float32 for k in a)
    other = weights.flat_params(dict(conf, params={"draw": "glorot", "seed": 15}), run.ROOT)
    assert not np.array_equal(a["generator/w"], other["generator/w"])
    for k, v in a.items():
        if v.ndim == 1:
            assert np.all(v == (1.0 if k.endswith("/scale") else 0.0)), k
        else:
            bound = math.sqrt(6.0 / (v.shape[-2] + v.shape[-1]))
            assert 0.9 * bound < np.abs(v).max() <= bound, k


def test_the_flagship_npz_has_the_references_names_and_shapes():
    conf = config("mqa-flagship")
    flat = weights.flat_params(conf, run.ROOT)
    assert {k: v.shape for k, v in flat.items()} == transformer.param_shapes(
        conf["config"]["model"])


def test_rnn_forward_matches_the_program():
    """Teacher-forced at a small size on seeded weights (the decoder's cells
    scaled 3x, as a random recurrence needs to move), the encoder 24 wide
    beside d 32.  Both sides are float32 on the CPU and add in other orders
    (the program projects each direction's input once before the loop and
    steps both directions in one batched product), so they part by a few
    ulps that the recurrences carry: 1e-5."""
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, encoder_type="lstm", decoder_type="rnn", lstm_hidden=24,
        rnn_attention="general"))
    params = init_model(prng.PRNGKey(3), cfg.model)
    for cell in params["decoder"]["layers"]:
        cell["wx"], cell["wh"] = cell["wx"] * 3.0, cell["wh"] * 3.0
    flat = {k: torch.from_numpy(v) for k, v in params_to_numpy(params).items()}
    assert {k: tuple(v.shape) for k, v in flat.items()} == rnn.param_shapes(
        dataclasses.asdict(cfg.model))
    rng = np.random.default_rng(0)
    s = cfg.signal.chunk_len
    signal = torch.from_numpy(rng.normal(size=(3, s)).astype(np.float32))
    lengths = torch.tensor([s, s // 2, s // 3])
    tgt = torch.from_numpy(rng.integers(4, cfg.model.vocab_size,
                                        size=(3, cfg.model.max_decode_len)))
    tgt[:, 0] = 1
    with torch.no_grad():
        mem, mlen = encode(params, cfg.model, signal, lengths)
        lp, attn = decode_teacher_forced(params, cfg.model, tgt, mem, mlen)
        ref = rnn.Ref(flat, dataclasses.asdict(cfg.model))
        rmem, rlen = ref.encode(signal, lengths)
        rlp, rattn = ref.decode(tgt, rmem, rlen)
    assert torch.equal(mlen.long(), rlen)
    torch.testing.assert_close(rmem, mem, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rlp, lp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rattn, attn, rtol=1e-5, atol=1e-6)


def test_rnn_training_run_is_correct_and_half_batch_is_not():
    spec = rnn_spec()
    res = run.run_cell(spec, SEED, 1.0, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] > train.READ_STEPS and res["failed"] == 0
    conf, traffic, lim = spec["config"], spec["traffic"], spec["limits"]
    flat = run.load_flat(conf)
    ref = train.reference_readings(conf, traffic, flat, SEED, "cpu")
    half = train.reference_readings(conf, traffic, flat, SEED, "cpu", half_batch=True)
    fault = train.gaps(half, ref, flat)
    assert any(fault[k] > lim[k] for k in lim), fault
