"""Write the orbax checkpoint fixture that the port's reader is held to
on the CPU (tests/test_torch_orbax.py) and on the card (chip_smoke.py
phase 17, which must not import JAX).

The JAX package trains the tiny config (`tiny_test_config`: Adam, clip
5.0, noam schedule) for 3 steps on its simulator's batches (seed 0) on
the CPU and saves the TrainState with its own CheckpointManager (orbax,
`StandardSave`):

    tests/golden/jax_orbax_tiny/               config.json, 3/ (about 470 KB)
    tests/golden/jax_orbax_tiny_expected.npz   the JAX package's restore of
                                               step 3, under the port's keys:
                                               params/<key>, mu/<key>,
                                               nu/<key> (save_params_npz keys
                                               and layouts), count, step

Needs the JAX package (and orbax) importable:

    python scripts/make_orbax_fixture.py [--out tests/golden]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

STEPS = 3
NAME = "jax_orbax_tiny"


def flat(tree) -> dict[str, np.ndarray]:
    """A pytree -> its save_params_npz keys and arrays."""
    import jax

    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp):
            np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def expected_arrays(state) -> dict[str, np.ndarray]:
    """A restored JAX TrainState of an Adam run under the port's names:
    optax's chain state ends with (ScaleByAdamState, ScaleByScheduleState)
    after the clip's EmptyState, or alone without clipping."""
    adam = state.opt_state[-1][0]
    out = {f"params/{k}": v for k, v in flat(state.params).items()}
    for name in ("mu", "nu"):
        out.update({f"{name}/{k}": v for k, v in flat(getattr(adam, name)).items()})
    out["count"] = np.asarray(adam.count)
    out["step"] = np.asarray(state.step)
    return out


def write_fixture(out_dir: str, config=None, steps: int = STEPS) -> tuple[str, str]:
    """Train, save and restore with the JAX package; (checkpoint directory,
    expected npz)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from nanodecoder_tpu.config import tiny_test_config
    from nanodecoder_tpu.models.model import init_model
    from nanodecoder_tpu.train.checkpoint import CheckpointManager
    from nanodecoder_tpu.train.data import synthetic_batches
    from nanodecoder_tpu.train.optim import build_optimizer
    from nanodecoder_tpu.train.trainer import Trainer, TrainState

    config = config or tiny_test_config()
    ckpt_dir = os.path.join(out_dir, NAME)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    params = init_model(jax.random.PRNGKey(config.train.seed), config.model)
    trainer = Trainer(config, params)
    trainer.train(synthetic_batches(config, seed=config.train.seed), steps=steps)
    mgr = CheckpointManager(ckpt_dir, config, max_to_keep=config.train.keep_checkpoints)
    mgr.save(steps, trainer.state, wait=True)
    template_params = init_model(jax.random.PRNGKey(0), config.model)
    optimizer, _ = build_optimizer(config.train, config.model.d_model)
    template = TrainState(template_params, optimizer.init(template_params),
                          jnp.zeros((), jnp.int32))
    restored = mgr.restore(template, steps)
    mgr.close()
    npz = os.path.join(out_dir, f"{NAME}_expected.npz")
    np.savez(npz, **expected_arrays(restored))
    return ckpt_dir, npz


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "golden"))
    args = ap.parse_args(argv)
    ckpt_dir, npz = write_fixture(args.out)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ckpt_dir)
               for f in fs)
    print(f"wrote {ckpt_dir} ({size} bytes) and {npz}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
