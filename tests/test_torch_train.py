"""PyTorch port, training: init, dropout, the teacher-forced pass, the
kernels' autograd guard, losses, schedules, optimizer updates, the train
and eval steps, early stopping, and the trainer's checkpoints.

Each comparison feeds the same numpy inputs (and the JAX package's
params, carried over by `params_from_numpy`, or both packages'
`init_model` from one seed) to the JAX package and to the port on the
CPU at the tiny config in float32.  The port keys its dropout as the JAX
package does (`nanodecoder_tpu_torch.prng`), so the steps at dropout 0.1
are compared too.  The tests marked `cuda` hold the card against the CPU
and skip where there is none.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from nanodecoder_tpu_torch.config import tiny_test_config
from nanodecoder_tpu_torch.models import model as tm
from nanodecoder_tpu_torch.models import modules as tnn
from nanodecoder_tpu_torch.prng import PRNGKey
from nanodecoder_tpu_torch.train.checkpoint import (CheckpointManager, expected_param_shapes,
                                                    params_from_numpy, params_to_numpy)
from nanodecoder_tpu_torch.train.trainer import Trainer, make_eval_step
from nanodecoder_tpu_torch.vocab import PAD_ID


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny model's many small ops run fastest on one thread, and far
    faster than on eight when the suite's other workers hold the cores;
    restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _replace(cfg, model=None, train=None):
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **(model or {})),
        train=dataclasses.replace(cfg.train, **(train or {})))


def _cfgs(model=None, train=None):
    """(JAX config, port config): the tiny config with these overrides."""
    from nanodecoder_tpu.config import tiny_test_config as jax_tiny

    return _replace(jax_tiny(), model, train), _replace(tiny_test_config(), model, train)


def _flat(params) -> dict:
    """JAX params -> the flat save_params_npz arrays."""
    import jax

    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp):
            np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _jax_params(jcfg, seed=0):
    import jax
    from nanodecoder_tpu.models.model import init_model

    return init_model(jax.random.PRNGKey(seed), jcfg.model)


def _port_params(jparams, cfg, device="cpu"):
    return params_from_numpy(_flat(jparams), cfg.model, device)


def _batch(jcfg, seed=0, accum_axis=False):
    from nanodecoder_tpu.train.data import synthetic_batches

    return next(synthetic_batches(jcfg, seed=seed, accum_axis=accum_axis))


def _t(batch, device="cpu"):
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def _grad_np(key, t):
    g = t.grad.numpy()
    return g.transpose(2, 1, 0) if key.startswith("encoder/frontend/convs/") \
        and key.endswith("/w") else g


# --------------------------------------------------------------------------
# init and dropout


@pytest.mark.parametrize("kv_heads", [0, 1])
def test_init_model_keys_shapes_and_count_match_jax(kv_heads):
    from nanodecoder_tpu.models.model import param_count

    jcfg, cfg = _cfgs(model={"dec_kv_heads": kv_heads})
    jp = _jax_params(jcfg)
    params = tm.init_model(PRNGKey(0), cfg.model)
    shapes = {k: v.shape for k, v in params_to_numpy(params).items()}
    assert shapes == {k: v.shape for k, v in _flat(jp).items()}
    assert shapes == expected_param_shapes(cfg.model)
    assert tm.param_count(params) == param_count(jp)
    assert all(t.dtype == torch.float32 for t in tm.named_leaves(params).values())


def test_init_model_statistics_and_determinism():
    """Glorot weights lie within +-sqrt(6 / (fan_in + fan_out)) (the JAX
    fan rule: the last two dims of the stored shape) with the uniform's
    std within 10%; the embedding's std is 1/sqrt(D) within 5%; biases 0,
    layer-norm scales 1; the same seed gives the same params."""
    cfg = _replace(tiny_test_config(), model={"d_model": 64, "enc_ffn_dim": 128})
    flat = params_to_numpy(tm.init_model(PRNGKey(0), cfg.model))
    again = params_to_numpy(tm.init_model(PRNGKey(0), cfg.model))
    other = params_to_numpy(tm.init_model(PRNGKey(1), cfg.model))
    for key, arr in flat.items():
        assert np.array_equal(arr, again[key]), key
        if key.endswith("/b") or key.endswith("/bias"):
            assert not arr.any(), key
        elif key.endswith("/scale"):
            assert (arr == 1).all(), key
        elif key == "tgt_embed/table":
            assert abs(arr.std() / (1 / math.sqrt(64)) - 1) < 0.05
        else:
            bound = math.sqrt(6.0 / (arr.shape[-2] + arr.shape[-1]))
            assert np.abs(arr).max() <= bound, key
            if arr.size >= 1000:
                assert abs(arr.std() / (bound / math.sqrt(3)) - 1) < 0.1, key
    assert not np.array_equal(flat["generator/w"], other["generator/w"])
    bad = _replace(cfg, model={"vocab_size": 9})
    with pytest.raises(ValueError, match="does not match kmer_k"):
        tm.init_model(PRNGKey(0), bad.model)


def test_dropout_identity_scaling_fraction_and_determinism():
    """Identity at rate 0, with train False or without a key; kept
    elements are x times the float32 reciprocal of keep (XLA's x / keep),
    the rest 0; over 10^6 draws the kept fraction lies within 5 binomial
    sigmas of keep; one key gives one mask."""
    x = torch.rand(1000, 1000) + 0.5
    key = PRNGKey(0)
    for args in ((0.0, key, True), (0.3, key, False), (0.3, None, True)):
        assert tnn.dropout(x, *args) is x
    y = tnn.dropout(x, 0.3, PRNGKey(5), True)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] * float(np.float32(1) / np.float32(0.7)),
                               rtol=0, atol=0)
    n, keep = x.numel(), 0.7
    assert abs(kept.sum().item() - n * keep) < 5 * math.sqrt(n * keep * (1 - keep))
    y2 = tnn.dropout(x, 0.3, PRNGKey(5), True)
    assert torch.equal(y, y2)
    assert y.dtype == x.dtype
    assert not torch.equal(kept, tnn.dropout(x, 0.3, PRNGKey(6),
                                             True) != 0)


def test_dropout_changes_the_training_pass_only():
    """With dropout on, a training pass depends on the key and an
    inference pass is the dropout-free function."""
    cfg = _replace(tiny_test_config(), model={"dropout": 0.2})
    params = tm.init_model(PRNGKey(0), cfg.model)
    from nanodecoder_tpu_torch.train.data import synthetic_batches

    b = _t(next(synthetic_batches(cfg, seed=0, accum_axis=False)))

    def run(key, train):
        mem, ml = tm.encode(params, cfg.model, b["signal"], b["sig_lengths"], key, train)
        return tm.decode_teacher_forced(params, cfg.model, b["tgt_in"], mem, ml, key,
                                        train)[0]

    a = run(PRNGKey(1), True)
    assert torch.equal(a, run(PRNGKey(1), True))
    assert not torch.equal(a, run(PRNGKey(2), True))
    plain = _replace(cfg, model={"dropout": 0.0})
    mem, ml = tm.encode(params, plain.model, b["signal"], b["sig_lengths"])
    want = tm.decode_teacher_forced(params, plain.model, b["tgt_in"], mem, ml)[0]
    assert torch.equal(run(PRNGKey(1), False), want)


# --------------------------------------------------------------------------
# the teacher-forced pass and the kernels' autograd guard


@pytest.mark.parametrize("kv_heads", [1, 0], ids=["mqa", "mha"])
def test_teacher_forced_pass_matches_jax(kv_heads):
    """encode(train=True) and decode_teacher_forced at dropout 0: memory,
    log-probs and the last layer's cross probs (B, H, T, S) within atol
    1e-5 of the JAX package's; the probs are f32 and on the graph."""
    import jax.numpy as jnp
    from nanodecoder_tpu.models import model as jm

    jcfg, cfg = _cfgs(model={"dec_kv_heads": kv_heads, "dropout": 0.0})
    jp = _jax_params(jcfg)
    params = _port_params(jp, cfg)
    for t in tm.named_leaves(params).values():
        t.requires_grad_(True)
    b = _batch(jcfg, seed=2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jmem, jml = jm.encode(jp, jcfg.model, jb["signal"], jb["sig_lengths"], train=True)
    jlp, jattn = jm.decode_teacher_forced(jp, jcfg.model, jb["tgt_in"], jmem, jml,
                                          train=True)
    tb = _t(b)
    mem, ml = tm.encode(params, cfg.model, tb["signal"], tb["sig_lengths"], train=True)
    lp, attn = tm.decode_teacher_forced(params, cfg.model, tb["tgt_in"], mem, ml,
                                        train=True)
    np.testing.assert_array_equal(ml.numpy(), np.asarray(jml))
    np.testing.assert_allclose(mem.detach().numpy(), np.asarray(jmem), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), atol=1e-5, rtol=0)
    assert attn.shape == (4, cfg.model.dec_heads, 48, mem.shape[1])
    assert attn.dtype == torch.float32 and attn.requires_grad
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(jattn), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel", ["K1", "K5", "K6"])
def test_encoder_kernels_refuse_inputs_that_need_a_gradient(kernel):
    """A kernel called with grad mode on and an input that requires grad
    raises (on every device; on the CPU before its plain version runs);
    under no_grad, or on inputs that need none, it runs."""
    from nanodecoder_tpu_torch.ops import encoder_attention as ea

    b, s, h, dh = 2, 8, 2, 4
    lens = torch.tensor([8, 5], dtype=torch.int32)
    if kernel == "K1":
        args = [torch.randn(b, s, 3 * h * dh)]
        call = lambda *a: ea.flash_encoder_attention_qkv(*a, lens, h)  # noqa: E731
    elif kernel == "K5":
        args = [torch.randn(b, s, h * dh) for _ in range(3)]
        call = lambda *a: ea.flash_encoder_attention_nld(*a, lens, h)  # noqa: E731
    else:
        args = [torch.randn(b, s, h, dh) for _ in range(3)]
        call = lambda *a: ea.flash_encoder_attention(*a, lens)  # noqa: E731
    want = call(*args)
    for i in range(len(args)):
        needs = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match="has no backward"):
            call(*needs)
        with torch.no_grad():
            torch.testing.assert_close(call(*needs), want, rtol=0, atol=0)


def _spy_kernel(monkeypatch, fail: bool):
    from nanodecoder_tpu_torch.models import encoder

    calls = []
    real = encoder.flash_encoder_attention_nld

    def spy(*args, **kw):
        if fail:
            raise AssertionError("a training pass reached kernel K5")
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(encoder, "flash_encoder_attention_nld", spy)
    return calls


def test_training_pass_never_reaches_the_kernel(monkeypatch):
    """use_pallas with train=True takes the differentiable attention: the
    kernel entry (patched to raise) is never called, and the attention
    weights of every encoder layer get a gradient."""
    _spy_kernel(monkeypatch, fail=True)
    cfg = _replace(tiny_test_config(), model={"use_pallas": True, "dropout": 0.1})
    params = tm.init_model(PRNGKey(0), cfg.model)
    for t in tm.named_leaves(params).values():
        t.requires_grad_(True)
    from nanodecoder_tpu_torch.train.data import synthetic_batches

    b = _t(next(synthetic_batches(cfg, seed=0, accum_axis=False)))
    key = PRNGKey(0)
    mem, ml = tm.encode(params, cfg.model, b["signal"], b["sig_lengths"], key, train=True)
    lp, _ = tm.decode_teacher_forced(params, cfg.model, b["tgt_in"], mem, ml, key, True)
    lp.sum().backward()
    for layer in params["encoder"]["body"]["layers"]:
        for name in "qkvo":
            assert layer["attn"][name]["w"].grad.abs().sum() > 0, name


@pytest.mark.parametrize("use_pallas", [True, False])
def test_inference_pass_takes_the_kernel_route_with_use_pallas(monkeypatch, use_pallas):
    """train=False with use_pallas selects K5 once per encoder layer (its
    plain version on the CPU), and never without use_pallas; the two
    routes give the same memory bank."""
    calls = _spy_kernel(monkeypatch, fail=False)
    cfg = _replace(tiny_test_config(), model={"use_pallas": use_pallas})
    plain = _replace(cfg, model={"use_pallas": False})
    params = tm.init_model(PRNGKey(0), cfg.model)
    from nanodecoder_tpu_torch.train.data import synthetic_batches

    b = _t(next(synthetic_batches(cfg, seed=0, accum_axis=False)))
    mem, _ = tm.encode(params, cfg.model, b["signal"], b["sig_lengths"])
    assert len(calls) == (cfg.model.enc_layers if use_pallas else 0)
    want, _ = tm.encode(params, plain.model, b["signal"], b["sig_lengths"])
    torch.testing.assert_close(mem, want, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# losses


def _loss_inputs(rng, b=3, t=7, v=8):
    logits = rng.normal(size=(b, t, v)).astype(np.float32)
    logits[0, 0, 5] = logits[0, 0, 6] = 9.0      # a tie: argmax is the lower index
    logits[1, 2, 4] = logits[1, 2, 7] = 9.0
    lp = torch.log_softmax(torch.from_numpy(logits), dim=-1).numpy()
    tgt = rng.integers(4, v, size=(b, t)).astype(np.int32)
    tgt[0, 0], tgt[1, 2] = 5, 7
    tgt[1, 5:] = PAD_ID
    tgt[2, 1:] = PAD_ID
    return lp, tgt


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_losses_match_jax(smoothing, rng_np):
    """label_smoothed_nll and loss_and_metrics (with PAD targets and
    argmax ties): sums within rtol 1e-6, counts exact."""
    import jax.numpy as jnp
    from nanodecoder_tpu.train import loss as jl
    from nanodecoder_tpu_torch.train import loss as tl

    lp, tgt = _loss_inputs(rng_np)
    got = tl.label_smoothed_nll(torch.from_numpy(lp), torch.from_numpy(tgt), smoothing)
    ref = jl.label_smoothed_nll(jnp.asarray(lp), jnp.asarray(tgt), smoothing)
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
    assert [int(x) for x in got[1:]] == [int(x) for x in ref[1:]]
    loss, metrics = tl.loss_and_metrics(torch.from_numpy(lp), torch.from_numpy(tgt),
                                        smoothing)
    rloss, rmetrics = jl.loss_and_metrics(jnp.asarray(lp), jnp.asarray(tgt), smoothing)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-6)
    for k in ("loss_sum", "xent_sum"):
        np.testing.assert_allclose(float(metrics[k]), float(rmetrics[k]), rtol=1e-6)
    for k in ("n_tokens", "n_correct"):
        assert int(metrics[k]) == int(rmetrics[k]), k


def test_label_smoothing_spreads_over_v_minus_2(rng_np):
    """eps goes to the V - 2 labels that are neither gold nor PAD; torch's
    cross_entropy(label_smoothing=) spreads it over all V and differs."""
    from nanodecoder_tpu_torch.train import loss as tl

    lp, tgt = _loss_inputs(rng_np)
    lp_t, tgt_t = torch.from_numpy(lp), torch.from_numpy(tgt)
    got = float(tl.label_smoothed_nll(lp_t, tgt_t, 0.1)[0])
    valid = tgt != PAD_ID
    gold = np.take_along_axis(lp, tgt[..., None].astype(np.int64), -1)[..., 0]
    rest = lp.sum(-1) - gold - lp[..., PAD_ID]
    want = -(0.9 * gold + 0.1 / 6 * rest)[valid].sum()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    torch_ce = torch.nn.functional.cross_entropy(
        lp_t.reshape(-1, 8), tgt_t.reshape(-1).long(), ignore_index=PAD_ID,
        label_smoothing=0.1, reduction="sum")
    assert abs(float(torch_ce) - got) > 1e-3


def test_guided_attention_loss_matches_jax(rng_np):
    """The guided-attention penalty (zero-length rows included) within
    rtol 1e-6 of the JAX package's."""
    import jax.numpy as jnp
    from nanodecoder_tpu.train.loss import guided_attention_loss as jga
    from nanodecoder_tpu_torch.train.loss import guided_attention_loss

    attn = torch.softmax(torch.from_numpy(rng_np.normal(size=(3, 4, 9, 13))
                                          .astype(np.float32)), dim=-1).numpy()
    tl_ = np.array([9, 4, 0], np.int32)
    el = np.array([13, 7, 0], np.int32)
    for sigma in (0.2, 0.5):
        got = guided_attention_loss(torch.from_numpy(attn), torch.from_numpy(tl_),
                                    torch.from_numpy(el), sigma)
        ref = jga(jnp.asarray(attn), jnp.asarray(tl_), jnp.asarray(el), sigma)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


# --------------------------------------------------------------------------
# schedules and optimizer updates


@pytest.mark.parametrize("schedule,warmup", [("noam", 10), ("constant", 10),
                                             ("cosine", 10), ("cosine", 0)])
def test_schedules_match_optax_and_host_lr_matches_jax(schedule, warmup):
    """build_schedule over steps 0 .. train_steps + 10 within 1e-6 of the
    JAX package's optax schedule, relative to the value and to the
    learning rate (optax computes in float32, whose cosine resolves the
    decayed tail to about 1e-7 of the peak); host_lr equal to the JAX
    package's host formula."""
    from nanodecoder_tpu.train import optim as jo
    from nanodecoder_tpu_torch.train import optim as to

    lr = 3e-4 if schedule != "noam" else 2.0
    jcfg, cfg = _cfgs(train={"lr_schedule": schedule, "warmup_steps": warmup,
                             "learning_rate": lr})
    ref, got = jo.build_schedule(jcfg.train, 32), to.build_schedule(cfg.train, 32)
    for step in range(cfg.train.train_steps + 11):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, atol=1e-6 * lr)
        if warmup:
            assert to.host_lr(cfg.train, 32, step) == jo.host_lr(jcfg.train, 32, step)


@pytest.mark.parametrize("clip", ["above", "below"])
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_updates_match_optax(name, clip, rng_np):
    """Three updates on fixed gradients (global norm above or below
    grad_clip): params, mu, nu and count within 1e-6 of optax's."""
    import jax
    import jax.numpy as jnp
    import optax
    from nanodecoder_tpu.train.optim import build_optimizer as jbuild
    from nanodecoder_tpu_torch.train.optim import build_optimizer

    jcfg, cfg = _cfgs(train={"optimizer": name, "lr_schedule": "noam",
                             "warmup_steps": 2, "learning_rate": 2.0})
    shapes = {"a": (5, 7), "b": (7,), "c": (3, 4, 2)}
    params = {k: rng_np.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng_np.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    norm = math.sqrt(sum(float((g ** 2).sum()) for g in grads[0].values()))
    scale = 0.1 if clip == "below" else 3.0
    grads = [{k: v * (scale * cfg.train.grad_clip / norm) for k, v in g.items()}
             for g in grads]
    jopt, _ = jbuild(jcfg.train, 32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
    opt, _ = build_optimizer(cfg.train, 32, tp)
    for g in grads:
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    for k, t in tp.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
    state = opt.state
    assert int(state["count"]) == 3
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    if name == "sgd":
        assert not adam and "mu" not in state
        return
    assert int(adam[0].count) == 3
    for k in tp:
        np.testing.assert_allclose(state["mu"][k].numpy(), np.asarray(adam[0].mu[k]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(state["nu"][k].numpy(), np.asarray(adam[0].nu[k]),
                                   atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# train and eval steps


def _capture():
    """An optax stage that keeps the incoming gradients as its state."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, _s, p=None: (g, g))


# The most an Adam step (b1 0.9, b2 0.998) can move an element, in units
# of lr, in its first three steps: 1 in the first, 1.0013 and 1.0035 in
# the second and third when the gradient changes between steps.
ADAM_STEP = 1.01


def _is_key_bias(key: str) -> bool:
    return key.endswith("/k/b")


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("accum,ga", [(1, 0.0), (1, 0.3), (2, 0.0), (2, 0.3)])
def test_train_step_matches_jax(accum, ga, optimizer):
    """Three steps (constant lr 1e-3) from the same params and batches at
    dropout 0: metrics equal (counts exact, loss_sum and xent_sum rtol
    1e-5), the first step's gradients within rtol 1e-4 / atol 1e-6,
    params after 3 steps within atol 1e-5.  With Adam, the elements whose
    gradient was non-zero and under 1e-6 in any step are held to the step
    bound instead (ADAM_STEP lr a step): Adam's g / (|g| + 1e-8) turns the
    rounding noise of a gradient near zero into a step of about lr in
    either direction.  The attention key biases, whose gradient is zero
    in exact arithmetic (a softmax does not see a shift shared by all
    keys), are of this kind; the exempt elements stay under 2%."""
    import jax
    import jax.numpy as jnp
    import optax
    from nanodecoder_tpu.train import trainer as jt
    from nanodecoder_tpu.train.data import synthetic_batches
    from nanodecoder_tpu.train.optim import build_optimizer

    over = {"accum_steps": accum, "guided_attention_weight": ga, "optimizer": optimizer,
            "lr_schedule": "constant", "learning_rate": 1e-3}
    jcfg, cfg = _cfgs(model={"dropout": 0.0}, train=over)
    jp = _jax_params(jcfg)
    jopt = optax.chain(_capture(), build_optimizer(jcfg.train, 32)[0])
    jstate = jt.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jt.make_train_step(jcfg, jopt))
    trainer = Trainer(cfg, _port_params(jp, cfg))
    it = synthetic_batches(jcfg, seed=0)
    lr_max = 0.0
    tiny = {}  # param key -> elements whose gradient fell under 1e-6
    for i in range(3):
        batch = next(it)
        if accum == 2 and i == 0:  # unequal token counts in the micro-batches
            for k in ("tgt_in", "tgt_out"):
                batch[k] = batch[k].copy()
                batch[k][1, :, 4:] = PAD_ID
        lr_max = max(lr_max, trainer.schedule(i))
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(i))
        metrics = trainer.train_step(batch)
        for k in ("n_tokens", "n_correct"):
            assert int(metrics[k]) == int(jm[k]), k
        for k in ("loss_sum", "xent_sum"):
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5)
        jgrads = _flat(jstate.opt_state[0])
        for key, g in jgrads.items():
            tiny[key] = tiny.get(key, False) | ((np.abs(g) < 1e-6) & (g != 0))
        if i == 0:
            for key, t in tm.named_leaves(trainer.params).items():
                np.testing.assert_allclose(_grad_np(key, t), jgrads[key], rtol=1e-4,
                                           atol=1e-6, err_msg=key)
                if optimizer == "adam" and _is_key_bias(key):
                    assert np.abs(jgrads[key]).max() < 1e-6, key
    assert trainer.step == 3
    got, want, start = params_to_numpy(trainer.params), _flat(jstate.params), _flat(jp)
    for key in want:
        held = ~tiny[key] if optimizer == "adam" else np.ones(want[key].shape, bool)
        np.testing.assert_allclose(got[key][held], want[key][held], atol=1e-5, rtol=0,
                                   err_msg=key)
        assert np.all(np.abs(got[key] - start[key])[~held] <= 3 * lr_max * ADAM_STEP), key
    if optimizer == "adam":  # the exemption stays narrow (0.6% when written)
        assert sum(int(m.sum()) for m in tiny.values()) < 0.02 * sum(
            m.size for m in tiny.values())


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_with_dropout_match_jax(accum):
    """Three Adam steps (constant lr 1e-3) at dropout 0.1, each side from
    its own init_model(PRNGKey(7)) and its trainer's key chain (the step
    key split off PRNGKey(train.seed) each step, split(step key, A) for
    the micro-batches): the masks are the JAX package's, so the training
    row's tolerances hold as at dropout 0 (counts exact, loss sums rtol
    1e-5, the first step's gradients rtol 1e-4 / atol 1e-6, params atol
    1e-5 but for the elements whose gradient fell under 1e-6, held to the
    Adam step bound).  The port's key after the steps is JAX's, and a
    restored state leaves the key alone (JAX's trainer re-keys from the
    seed, not from a checkpoint)."""
    import jax
    import jax.numpy as jnp
    import optax
    from nanodecoder_tpu.train import trainer as jt
    from nanodecoder_tpu.train.data import synthetic_batches
    from nanodecoder_tpu.train.optim import build_optimizer

    over = {"accum_steps": accum, "lr_schedule": "constant", "learning_rate": 1e-3,
            "seed": 7}
    jcfg, cfg = _cfgs(model={"dropout": 0.1}, train=over)
    jp = _jax_params(jcfg, seed=7)
    jopt = optax.chain(_capture(), build_optimizer(jcfg.train, 32)[0])
    jstate = jt.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jt.make_train_step(jcfg, jopt))
    trainer = Trainer(cfg, tm.init_model(PRNGKey(7), cfg.model))
    rng = jax.random.PRNGKey(7)
    it = synthetic_batches(jcfg, seed=0)
    tiny = {}
    for i in range(3):
        batch = next(it)
        rng, step_rng = jax.random.split(rng)
        jstate, jm = jstep(jstate, batch, step_rng)
        metrics = trainer.train_step(batch)
        for k in ("n_tokens", "n_correct"):
            assert int(metrics[k]) == int(jm[k]), k
        for k in ("loss_sum", "xent_sum"):
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5)
        jgrads = _flat(jstate.opt_state[0])
        for key, g in jgrads.items():
            tiny[key] = tiny.get(key, False) | ((np.abs(g) < 1e-6) & (g != 0))
        if i == 0:
            for key, t in tm.named_leaves(trainer.params).items():
                np.testing.assert_allclose(_grad_np(key, t), jgrads[key], rtol=1e-4,
                                           atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(trainer.key, np.asarray(rng))
    got, want = params_to_numpy(trainer.params), _flat(jstate.params)
    start = params_to_numpy(tm.init_model(PRNGKey(7), cfg.model))
    for key in want:
        held = ~tiny[key]
        np.testing.assert_allclose(got[key][held], want[key][held], atol=1e-5, rtol=0,
                                   err_msg=key)
        assert np.all(np.abs(got[key] - start[key])[~held] <= 3e-3 * ADAM_STEP), key
    assert sum(int(m.sum()) for m in tiny.values()) < 0.02 * sum(
        m.size for m in tiny.values())
    fresh = Trainer(cfg, tm.init_model(PRNGKey(8), cfg.model))
    fresh.state = trainer.state
    np.testing.assert_array_equal(fresh.key, PRNGKey(7))


def test_train_step_spans():
    """With the span recorder on, each step fed by prefetch_batches has its
    data wait and a train.step span holding the batch's copy, a forward
    and a backward a micro-batch and the update, all with its number."""
    from nanodecoder_tpu_torch.train.data import prefetch_batches, synthetic_batches
    from nanodecoder_tpu_torch.utils import profiling

    cfg = _replace(tiny_test_config(), train={"accum_steps": 2})
    trainer = Trainer(cfg, tm.init_model(PRNGKey(7), cfg.model))
    feed = prefetch_batches(synthetic_batches(cfg, seed=0), depth=2)
    profiling.drain()
    profiling.enable()
    try:
        for _ in range(3):
            trainer.train_step(next(feed))
    finally:
        profiling.disable()
        feed.close()
    spans = profiling.drain()
    for step in range(3):
        mine = [s for s in spans if s.step == step]
        names = sorted(s.name for s in mine)
        assert names == sorted(["train.data_wait", "train.step", "train.h2d", "train.update"]
                               + ["train.forward", "train.backward"] * 2), step
        (outer,) = [s for s in mine if s.name == "train.step"]
        assert all(s.parent == outer.id for s in mine if s.name not in
                   ("train.step", "train.data_wait"))


def test_accumulation_equals_one_batch_with_unequal_token_counts():
    """Two micro-batches with very different token counts give the step
    of one batch holding both (SGD, no clip): the objective divides by
    the token count of all micro-batches, not a mean of means."""
    from nanodecoder_tpu.train.data import synthetic_batches

    over = {"optimizer": "sgd", "lr_schedule": "constant", "learning_rate": 0.1,
            "grad_clip": 0.0, "accum_steps": 2}
    jcfg, cfg = _cfgs(model={"dropout": 0.0}, train=over)
    it = synthetic_batches(jcfg, seed=3, accum_axis=False)
    mb1, mb2 = next(it), next(it)
    for k in ("tgt_in", "tgt_out"):
        mb2[k] = mb2[k].copy()
        mb2[k][:, 4:] = PAD_ID
    jp = _jax_params(jcfg)
    accum = Trainer(cfg, _port_params(jp, cfg))
    accum.train_step({k: np.stack([mb1[k], mb2[k]]) for k in mb1})
    single_cfg = _replace(cfg, train={"accum_steps": 1, "batch_size": 8})
    single = Trainer(single_cfg, _port_params(jp, single_cfg))
    single.train_step({k: np.concatenate([mb1[k], mb2[k]])[None] for k in mb1})
    a, s = params_to_numpy(accum.params), params_to_numpy(single.params)
    for key in a:
        np.testing.assert_allclose(a[key], s[key], rtol=2e-4, atol=2e-5, err_msg=key)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_eval_step_matches_jax(use_pallas):
    """make_eval_step's metrics equal the JAX package's (its Pallas K5 in
    interpret mode with use_pallas): counts exact, sums rtol 1e-5."""
    import jax.numpy as jnp
    from nanodecoder_tpu.train.trainer import make_eval_step as jax_eval_step

    jcfg, cfg = _cfgs(model={"use_pallas": use_pallas})
    jp = _jax_params(jcfg)
    params = _port_params(jp, cfg)
    batch = _batch(jcfg, seed=5)
    ref = jax_eval_step(jcfg)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(cfg)(params, _t(batch))
    for k in ("n_tokens", "n_correct"):
        assert int(got[k]) == int(ref[k]), k
    for k in ("loss_sum", "xent_sum"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5)


def test_loss_falls_with_dropout():
    """Thirty steps of the trainer on simulated batches with dropout 0.1
    (constant lr 1e-3, as the JAX package's smoke test) lower the mean
    cross-entropy of the last five steps by 2% against the first five."""
    from nanodecoder_tpu_torch.train.data import synthetic_batches

    cfg = _replace(tiny_test_config(), train={"lr_schedule": "constant",
                                              "learning_rate": 1e-3})
    trainer = Trainer(cfg, tm.init_model(PRNGKey(0), cfg.model))
    it = synthetic_batches(cfg, seed=0)
    losses = []
    for _ in range(30):
        m = trainer.train_step(next(it))
        losses.append(float(m["xent_sum"]) / max(int(m["n_tokens"]), 1))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.98, losses


@pytest.mark.parametrize("metric,patience,min_delta", [("xent", 2, 0.0),
                                                       ("xent", 1, 0.05),
                                                       ("accuracy", 2, 0.0),
                                                       ("accuracy", 3, 0.02)])
def test_early_stopping_matches_jax(metric, patience, min_delta):
    """The same decisions, best value and bad count after each of a
    scripted sequence of validations."""
    from nanodecoder_tpu.train.earlystopping import EarlyStopping as JaxES
    from nanodecoder_tpu.utils.statistics import Statistics as JaxStats
    from nanodecoder_tpu_torch.train.earlystopping import EarlyStopping
    from nanodecoder_tpu_torch.utils.statistics import Statistics

    script = [(12.0, 10, 3), (9.0, 10, 5), (9.2, 10, 5), (8.7, 10, 6), (8.7, 10, 6),
              (8.8, 10, 6), (8.0, 10, 8), (8.05, 10, 8), (9.0, 10, 7), (9.5, 10, 7)]
    ours, ref = EarlyStopping(patience, metric, min_delta), JaxES(patience, metric, min_delta)
    for loss, n, correct in script:
        s, r = Statistics(), JaxStats()
        s.update(loss, n, correct)
        r.update(loss, n, correct)
        assert ours.update(s) == ref.update(r)
        assert (ours.best, ours.bad_count, ours.stopped) == (ref.best, ref.bad_count,
                                                             ref.stopped)
    with pytest.raises(ValueError, match="unknown early-stopping metric"):
        EarlyStopping(metric="bleu").update(Statistics())


def test_trainer_validates_stops_early_and_saves(tmp_path):
    """Trainer.train validates every valid_every steps, stops when early
    stopping says so, and saves every save_every steps."""
    from nanodecoder_tpu_torch.train.data import synthetic_batches, synthetic_valid_batches
    from nanodecoder_tpu_torch.train.earlystopping import EarlyStopping

    cfg = _replace(tiny_test_config(), train={"valid_every": 2, "save_every": 3,
                                              "train_steps": 12})
    params = tm.init_model(PRNGKey(0), cfg.model)
    ckpt = CheckpointManager(str(tmp_path / "ck"), cfg)
    stop = EarlyStopping(patience=1, metric="accuracy", min_delta=10.0)  # never improves
    trainer = Trainer(cfg, params, checkpointer=ckpt, early_stopping=stop)
    valid = synthetic_valid_batches(cfg, n_batches=1)
    calls = []

    def valid_fn():
        calls.append(trainer.step)
        return iter(valid)

    trainer.train(synthetic_batches(cfg, seed=0), valid_fn)
    assert calls == [2, 4] and trainer.step == 4 and stop.stopped
    trainer.early_stopping = None
    trainer.train(synthetic_batches(cfg, seed=1), None, steps=7)
    assert trainer.step == 7 and ckpt.all_steps() == [3, 6]


# --------------------------------------------------------------------------
# checkpoints


def _tiny_trainer(seed=0, **train):
    cfg = _replace(tiny_test_config(), model={"dropout": 0.0}, train=train)
    return cfg, Trainer(cfg, tm.init_model(PRNGKey(seed), cfg.model))


def _assert_same_state(a, b, exact=True):
    pa, pb = tm.named_leaves(a.params), tm.named_leaves(b.params)
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k].detach(), pb[k].detach()), k
    assert int(a.opt_state["count"]) == int(b.opt_state["count"])
    for name in ("mu", "nu"):
        for k in pa:
            assert torch.equal(a.opt_state[name][k], b.opt_state[name][k]), (name, k)
    assert a.step == b.step


def test_checkpoint_round_trip_and_max_to_keep(tmp_path):
    """A saved state restores exactly (params, mu, nu, count, step) into a
    fresh trainer; only the newest max_to_keep steps stay; config.json
    holds the config."""
    from nanodecoder_tpu_torch.train.checkpoint import load_config
    from nanodecoder_tpu_torch.train.data import synthetic_batches

    cfg, trainer = _tiny_trainer()
    ckpt = CheckpointManager(str(tmp_path), cfg, max_to_keep=2)
    assert ckpt.latest_step() is None
    it = synthetic_batches(cfg, seed=0)
    for _ in range(3):
        trainer.train_step(next(it))
        ckpt.save(trainer.step, trainer.state)
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    assert load_config(str(tmp_path)) == cfg
    fresh = Trainer(cfg, tm.init_model(PRNGKey(9), cfg.model))
    fresh.state = ckpt.restore(device="cpu")
    _assert_same_state(fresh.state, trainer.state)
    older = ckpt.restore(step=2, device="cpu")
    assert older.step == 2 and int(older.opt_state["count"]) == 2
    ckpt.save(3, trainer.state)  # a re-save replaces the step
    assert ckpt.all_steps() == [2, 3]


def test_interrupted_save_leaves_the_previous_step(tmp_path, monkeypatch):
    """A save that dies while writing leaves the earlier step as the
    latest, readable, and no partial step."""
    from nanodecoder_tpu_torch.train import checkpoint as ck
    from nanodecoder_tpu_torch.train.data import synthetic_batches

    cfg, trainer = _tiny_trainer()
    ckpt = CheckpointManager(str(tmp_path), cfg)
    it = synthetic_batches(cfg, seed=0)
    trainer.train_step(next(it))
    ckpt.save(1, trainer.state)
    trainer.train_step(next(it))
    real = np.savez

    def dies(path, **arrays):
        if str(path).endswith("opt_state.npz"):
            raise KeyboardInterrupt
        real(path, **arrays)

    monkeypatch.setattr(ck.np, "savez", dies)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save(2, trainer.state)
    monkeypatch.setattr(ck.np, "savez", real)
    assert ckpt.all_steps() == [1]
    assert ckpt.restore(device="cpu").step == 1


def test_resume_equals_uninterrupted_run(tmp_path):
    """At dropout 0: two steps, save, restore into a fresh trainer, two
    more steps equals four straight steps, exactly."""
    from nanodecoder_tpu_torch.train.data import synthetic_batches

    cfg, straight = _tiny_trainer(guided_attention_weight=0.3)
    batches = [next(it) for it in [synthetic_batches(cfg, seed=4)] for _ in range(4)]
    for b in batches:
        straight.train_step(b)
    _cfg, first = _tiny_trainer(guided_attention_weight=0.3)
    for b in batches[:2]:
        first.train_step(b)
    ckpt = CheckpointManager(str(tmp_path), cfg)
    ckpt.save(first.step, first.state)
    _cfg, resumed = _tiny_trainer(seed=5, guided_attention_weight=0.3)
    resumed.state = ckpt.restore(device="cpu")
    for b in batches[2:]:
        resumed.train_step(b)
    _assert_same_state(resumed.state, straight.state)


def test_jax_reads_the_port_params_and_decodes_alike(tmp_path):
    """The JAX package's load_params_npz reads the port's params.npz
    unchanged, and its greedy decode on them gives the port's tokens."""
    import jax
    import jax.numpy as jnp
    from nanodecoder_tpu.decode.greedy import greedy_decode as jax_greedy
    from nanodecoder_tpu.models import model as jm
    from nanodecoder_tpu.train.checkpoint import load_params_npz as jax_load
    from nanodecoder_tpu_torch.decode.greedy import greedy_decode
    from nanodecoder_tpu_torch.train.data import synthetic_batches

    cfg, trainer = _tiny_trainer()
    it = synthetic_batches(cfg, seed=0)
    for _ in range(3):
        trainer.train_step(next(it))
    ckpt = CheckpointManager(str(tmp_path), cfg)
    ckpt.save(3, trainer.state)
    jcfg, _ = _cfgs(model={"dropout": 0.0})
    jp = jax.tree_util.tree_map(jnp.asarray, jax_load(str(tmp_path / "3" / "params.npz"),
                                                      _jax_params(jcfg)))
    flat = _flat(jp)
    for key, arr in params_to_numpy(trainer.params).items():
        assert np.array_equal(flat[key], arr), key
    b = next(synthetic_batches(cfg, seed=7, accum_axis=False))
    mem, ml = jm.encode(jp, jcfg.model, jnp.asarray(b["signal"]),
                        jnp.asarray(b["sig_lengths"]))
    ref = jax_greedy(jp, jcfg.model, mem, ml)
    with torch.no_grad():
        params = tm.prepare_serving_params(trainer.params, cfg.model)
        tb = _t(b)
        tmem, tml = tm.encode(params, cfg.model, tb["signal"], tb["sig_lengths"])
        got = greedy_decode(params, cfg.model, tmem, tml)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jax.device_get(ref[0])))


# --------------------------------------------------------------------------
# the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_train_steps_on_card_match_cpu(cuda):
    """Three Adam steps at the tiny config, dropout 0, f32 without TF32,
    guided attention 0.3, constant lr 1e-3, on the card and on the CPU:
    losses within rtol 1e-4, the first step's gradients within rtol 1e-4 /
    atol 1e-6, params after 3 steps within atol 1e-5.  The elements whose
    gradient was non-zero and under 1e-6 on either side in a step are held
    to the step bound instead (Adam turns the rounding noise of such a
    gradient into a step of about lr; they stay under 2%).  Every other
    element moves by about lr a step, so a wrong update on the card (a
    flipped sign, a lost bias correction, a skipped step) fails."""
    from nanodecoder_tpu_torch.train.data import synthetic_batches

    lr, steps = 1e-3, 3
    cfg = _replace(tiny_test_config(), model={"dropout": 0.0},
                   train={"guided_attention_weight": 0.3, "optimizer": "adam",
                          "lr_schedule": "constant", "learning_rate": lr})

    def leaves(params, grad=False):  # copies in the port's layout, on the host
        return {k: (t.grad if grad else t).detach().cpu().numpy().copy()
                for k, t in tm.named_leaves(params).items()}

    start = tm.init_model(PRNGKey(0), cfg.model)
    begin = leaves(start)
    card = Trainer(cfg, tm.params_to(start, cuda))
    cpu = Trainer(cfg, start)
    tiny = {}  # param key -> elements whose gradient fell under 1e-6
    it = synthetic_batches(cfg, seed=0)
    for i in range(steps):
        b = next(it)
        mc, mg = cpu.train_step(b), card.train_step(b)
        np.testing.assert_allclose(float(mg["loss_sum"]), float(mc["loss_sum"]), rtol=1e-4)
        gc, gg = leaves(cpu.params, grad=True), leaves(card.params, grad=True)
        for key in gc:
            if i == 0:
                np.testing.assert_allclose(gg[key], gc[key], rtol=1e-4, atol=1e-6,
                                           err_msg=key)
            lo = np.minimum(np.abs(gc[key]), np.abs(gg[key]))
            hi = np.maximum(np.abs(gc[key]), np.abs(gg[key]))
            tiny[key] = tiny.get(key, False) | ((lo < 1e-6) & (hi > 0))
    a, g = leaves(cpu.params), leaves(card.params)
    for key in a:
        held = ~tiny[key]
        np.testing.assert_allclose(g[key][held], a[key][held], atol=1e-5, rtol=0,
                                   err_msg=key)
        assert np.all(np.abs(g[key] - begin[key])[~held] <= steps * lr * ADAM_STEP), key
    assert sum(int(m.sum()) for m in tiny.values()) < 0.02 * sum(
        m.size for m in tiny.values())


@pytest.mark.cuda
def test_encoder_kernel_guard_on_card(cuda):
    """K5 on the card raises for inputs that need a gradient and matches
    its plain version under no_grad."""
    from nanodecoder_tpu_torch.ops import encoder_attention as ea

    q, k, v = (torch.randn(2, 64, 128, device=cuda, requires_grad=True) for _ in range(3))
    lens = torch.tensor([64, 30], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="has no backward"):
        ea.flash_encoder_attention_nld(q, k, v, lens, 2)
    with torch.no_grad():
        got = ea.flash_encoder_attention_nld(q, k, v, lens, 2)
        want = ea.encoder_attention_nld_plain(q, k, v, lens, 2)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
