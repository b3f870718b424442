"""Write the jax.random fixture that the port's threefry draws are held to
on the CPU (tests/test_torch_prng.py) and on the card (chip_smoke.py
phase 18, which must not import JAX).

JAX's own draws on the CPU from PRNGKey(SEED), as float32 / uint32 / bool
arrays in tests/golden/jax_prng.npz (about 0.4 MB):

    key                         the key's two uint32 words
    bits, uniform, bernoulli,   jax.random.bits / uniform(GLOROT_LO, -lo) /
    normal, gumbel              bernoulli(P) / normal / gumbel over (N0,)
    offset                      OFFSET, a counter past 2^32 - N1 / 2
    off_bits, off_uniform,      the same five draws for the N1 counters from
    off_bernoulli, off_normal,  OFFSET on: JAX's own float transforms
    off_gumbel                  (jax/_src/random.py) over bits that JAX's
                                threefry2x32 primitive hashes there

jax.random draws any array from counter 0, so the offset draws swap
`jax._src.random._random_bits` for JAX's threefry2x32 primitive over the
offset counters while jax.random's samplers run.  Needs JAX:

    python scripts/make_prng_fixture.py [--out tests/golden/jax_prng.npz]
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

SEED = 42
N0 = 1 << 14          # draws from counter 0
N1 = 1 << 12          # draws from OFFSET
OFFSET = 2**32 - N1 // 2
P = 0.9               # the keep probability of dropout 0.1
GLOROT_LO = -math.sqrt(6.0 / (256 + 1024))  # the flagship's FFN weights
KINDS = ("bits", "uniform", "bernoulli", "normal", "gumbel")


@contextlib.contextmanager
def counters_from(offset: int):
    """jax.random's samplers draw their bits at counters offset.. instead
    of 0.. (JAX's threefry2x32 primitive on the pairs (i >> 32, i mod 2^32))."""
    import jax
    import jax.numpy as jnp
    from jax._src import prng as jprng
    from jax._src import random as jrandom

    real = jrandom._random_bits

    def offset_bits(key, bit_width, shape):
        assert bit_width == 32
        words = jax.random.key_data(key)
        i = np.arange(math.prod(shape), dtype=np.uint64) + np.uint64(offset)
        hi = jnp.asarray((i >> np.uint64(32)).astype(np.uint32))
        lo = jnp.asarray((i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        b1, b2 = jprng.threefry2x32_p.bind(words[0], words[1], hi, lo)
        return (b1 ^ b2).reshape(shape)

    jax.clear_caches()
    jrandom._random_bits = offset_bits
    try:
        yield
    finally:
        jrandom._random_bits = real
        jax.clear_caches()


def draws(key, n: int) -> dict[str, np.ndarray]:
    import jax

    return {
        "bits": np.asarray(jax.random.bits(key, (n,))),
        "uniform": np.asarray(jax.random.uniform(key, (n,), minval=GLOROT_LO,
                                                 maxval=-GLOROT_LO)),
        "bernoulli": np.asarray(jax.random.bernoulli(key, P, (n,))),
        "normal": np.asarray(jax.random.normal(key, (n,))),
        "gumbel": np.asarray(jax.random.gumbel(key, (n,))),
    }


def fixture() -> dict[str, np.ndarray]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    key = jax.random.PRNGKey(SEED)
    out = {"key": np.asarray(key), "offset": np.asarray(OFFSET, np.uint64)}
    out.update(draws(key, N0))
    with counters_from(OFFSET):
        out.update({f"off_{k}": v for k, v in draws(key, N1).items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "golden", "jax_prng.npz"))
    args = ap.parse_args(argv)
    arrays = fixture()
    np.savez(args.out, **arrays)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
