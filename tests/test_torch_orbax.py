"""PyTorch port, the JAX package's orbax checkpoints: the native zstd
decoder, CRC32C, the OCDBT and zarr readers, the TrainState importer, and
the CLIs that take such a checkpoint.

The oracles run here only: `zstandard` for the decoder, `tensorstore`
for the OCDBT and zarr readers, and the JAX package (orbax, optax) for
the checkpoints.  A "JAX run" below is the tiny config (dropout 0,
constant lr 1e-3) trained 3 steps by the JAX package on its simulator's
batches (seed 0) from the port's init of the same widths: its train
step's gradients (`make_train_step`, compiled once for every optimizer)
and the config's optax optimizer (`build_optimizer`), saved and
restored by its CheckpointManager.
Reads are held bit-equal; a resumed run at `test_torch_train.py`'s
tolerances.
"""

import dataclasses
import functools
import hashlib
import itertools
import json
import os
import shutil

import numpy as np
import pytest
import torch
import zstandard

from nanodecoder_tpu_torch.native import zstd
from nanodecoder_tpu_torch.prng import PRNGKey

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "jax_orbax_tiny")
EXPECTED = GOLDEN + "_expected.npz"
FLAGSHIP_CONFIG = os.path.join(REPO, "bench_results", "config.json")
FLAGSHIP_NPZ = os.path.join(REPO, "bench_results", "flagship_params.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- zstd ------------------------------------------------------------------------

SIZES = (0, 1, 127 * 1024, 129 * 1024, 1 << 20)


@functools.lru_cache(maxsize=None)
def _source(kind: str) -> bytes:
    """1 MiB of one kind of input, made from a seed."""
    rng = np.random.default_rng(7)
    n = 1 << 20
    if kind == "zeros":
        return bytes(n)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "text":
        words = ["".join(chr(97 + c) for c in rng.integers(0, 26, int(rng.integers(2, 9))))
                 for _ in range(400)]
        out = " ".join(words[int(i)] for i in rng.zipf(1.3, n // 3) % 400).encode()
        return out[:n]
    if kind == "f32":
        with np.load(FLAGSHIP_NPZ) as w:
            return b"".join(w[k].tobytes() for k in sorted(w.files))[:n]
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["zeros", "text", "random", "f32"])
@pytest.mark.parametrize("level", [1, 3, 19, -5])
def test_zstd_matches_zstandard(level, kind):
    """Every size, one-shot (content size in the header) without and with
    the checksum, and streamed (no content size, a window descriptor)."""
    for size in SIZES:
        data = _source(kind)[:size]
        plain = zstandard.ZstdCompressor(level=level).compress(data)
        summed = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data)
        cobj = zstandard.ZstdCompressor(level=level, write_checksum=True).compressobj()
        streamed = cobj.compress(data) + cobj.flush()
        for frame in (plain, summed, streamed):
            assert zstd.decompress(frame) == data, (size, len(frame))


def _rle_literals(n=600_000) -> bytes:
    """Copies of a random pool joined by b"x": past the pool's block the
    only literals are x's."""
    rng = np.random.default_rng(3)
    pool = rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()
    out = bytearray(pool)
    while len(out) < n:
        o, length = int(rng.integers(0, 65536 - 64)), int(rng.integers(16, 64))
        out += pool[o:o + length] + b"x"
    return bytes(out)


def _rle_sequences(n=400_000) -> bytes:
    """4 random bytes, then the 8 bytes 16 back, over and over: every
    sequence has the same codes."""
    rng = np.random.default_rng(2)
    out = bytearray(rng.integers(0, 256, 16, dtype=np.uint8).tobytes())
    while len(out) < n:
        out += rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
        out += out[-16:-8]
    return bytes(out)


def _small_alphabet(n=200_000) -> bytes:
    rng = np.random.default_rng(4)
    p = np.r_[[0.3, 0.2, 0.1], [0.4 / 13] * 13]
    return rng.choice(16, n, p=p).astype(np.uint8).tobytes()


def _skippable(payload: bytes) -> bytes:
    return (0x184D2A53).to_bytes(4, "little") + len(payload).to_bytes(4, "little") + payload


def test_zstd_reaches_every_format_path():
    """A corpus that drives every block type, literals mode (raw, RLE,
    Huffman 1 and 4 streams, treeless; weights direct and FSE-coded),
    sequences mode (predefined, RLE, FSE, repeat), checksummed,
    size-less and skippable frames, all equal to the input."""
    corpus = [(_source("text")[:500], 3), (_source("text")[:300_000], 1),
              (_source("random")[:200_000], 3),
              (_source("zeros")[:300_000], 3), (_rle_literals(), 19),
              (_rle_sequences(), 3), (_small_alphabet(), 3), (_small_alphabet(), 19),
              (_source("text"), 19)]
    zstd.mode_counts(reset=True)
    for data, level in corpus:
        one_shot = zstandard.ZstdCompressor(level=level).compress(data)
        cobj = zstandard.ZstdCompressor(level=level, write_checksum=True).compressobj()
        streamed = cobj.compress(data) + cobj.flush()
        assert zstd.decompress(_skippable(b"meta") + one_shot + streamed) == data + data
    counts = zstd.mode_counts(reset=True)
    assert not [m for m in zstd.MODES if counts[m] == 0], counts


def test_zstd_concatenated_and_skippable_frames():
    a, b = _source("text")[:50_000], _source("f32")[:70_000]
    frames = (zstandard.ZstdCompressor(level=3).compress(a) + _skippable(b"\0" * 9)
              + zstandard.ZstdCompressor(level=19, write_checksum=True).compress(b)
              + zstandard.ZstdCompressor(level=1).compress(b""))
    assert zstd.decompress(frames) == a + b
    assert zstd.decompress(_skippable(b"")) == b""


def test_zstd_flipped_bytes_raise_and_never_crash():
    """Every single-byte flip of a checksummed frame decodes to the input
    (a bit the decoder ignores, e.g. the window size) or raises
    ZstdError; flips in the compressed payload raise.  Without the
    checksum no flip crashes the process."""
    data = _source("text")[:20_000]
    summed = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    raised = 0
    for i in range(len(summed)):
        bad = bytearray(summed)
        bad[i] ^= 0x5A
        try:
            assert zstd.decompress(bytes(bad)) == data, i
        except zstd.ZstdError:
            raised += 1
    assert raised >= len(summed) - 8
    plain = zstandard.ZstdCompressor(level=19).compress(data)
    rng = np.random.default_rng(0)
    for i in rng.integers(4, len(plain), 300):
        bad = bytearray(plain)
        bad[int(i)] ^= 1 << int(rng.integers(0, 8))
        try:
            zstd.decompress(bytes(bad))
        except zstd.ZstdError:
            pass
    for cut in (1, 5, len(plain) // 2, len(plain) - 1):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(plain[:cut])


def test_zstd_refuses_a_dictionary_and_other_inputs():
    # Magic, a single-segment header with a 1-byte dictionary ID (42) and
    # a 1-byte content size, then one raw last block of 3 bytes.
    frame = (0xFD2FB528).to_bytes(4, "little") + bytes([0x21, 42, 3, 0x19, 0, 0]) + b"abc"
    with pytest.raises(zstd.ZstdError, match="dictionary 42"):
        zstd.decompress(frame)
    assert zstd.decompress(frame[:4] + bytes([0x20, 3, 0x19, 0, 0]) + b"abc") == b"abc"
    for bad, why in ((b"", "empty"), (b"PK\x03\x04rest", "magic"),
                     (frame[:4] + bytes([0x28, 3]), "reserved")):
        with pytest.raises(zstd.ZstdError, match=why):
            zstd.decompress(bad)


def test_crc32c_check_values_and_the_content_checksum():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0
    assert zstd.crc32c(b"\0" * 32) == 0x8A9136AA
    data = _source("random")[:100_003]  # raw blocks: only the checksum sees a change
    frame = bytearray(zstandard.ZstdCompressor(level=1, write_checksum=True).compress(data))
    frame[-1] ^= 1
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))


def test_no_fallback_where_the_zstd_library_cannot_build(monkeypatch, tmp_path):
    """A failed build raises ZstdUnavailable with the compiler's error on
    every call and every orbax read; the overlap scorer's library is
    another and still loads."""
    from nanodecoder_tpu_torch import native
    from nanodecoder_tpu_torch.io.ocdbt import OcdbtStore

    monkeypatch.setenv("NANODECODER_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(zstd, "COMPILER", "no-such-compiler-g++")
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd, "_error", None)
    for _ in range(2):
        with pytest.raises(zstd.ZstdUnavailable, match="no-such-compiler-g"):
            zstd.decompress(zstandard.ZstdCompressor().compress(b"abc"))
    with pytest.raises(zstd.ZstdUnavailable):
        OcdbtStore(os.path.join(GOLDEN, "3", "default"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    assert native.load() is not None


# -- OCDBT -----------------------------------------------------------------------

def _ts_kvstore(path: str, config: dict | None = None):
    import tensorstore as ts

    spec = {"driver": "ocdbt", "base": f"file://{path}"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def _write_store(path: str, config: dict, n_keys: int, commits: int) -> None:
    import tensorstore as ts

    kv = _ts_kvstore(path, config)
    rng = np.random.default_rng(n_keys)
    for c in range(commits):
        with ts.Transaction() as txn:
            for i in range(c, n_keys, commits):
                value = rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8)
                kv.with_transaction(txn).write(f"k/{i % 7}/{i:05d}", value.tobytes()).result()
        if c == 1:
            kv.delete_range(ts.KvStore.KeyRange("k/3/", "k/3/00100")).result()


@pytest.mark.parametrize("case", ["fixture", "fixture_process", "deep", "uncompressed",
                                  "indirect"])
def test_ocdbt_matches_tensorstore(case, tmp_path):
    from nanodecoder_tpu_torch.io.ocdbt import OcdbtStore

    if case == "fixture":
        path = os.path.join(GOLDEN, "3", "default")
    elif case == "fixture_process":
        path = os.path.join(GOLDEN, "3", "default", "ocdbt.process_0")
    else:
        path = str(tmp_path / "db")
        config = {"deep": {"max_decoded_node_bytes": 500, "max_inline_value_bytes": 100},
                  "uncompressed": {"compression": None},
                  "indirect": {"compression": {"id": "zstd", "level": 5},
                               "max_inline_value_bytes": 0}}[case]
        _write_store(path, config, 600 if case == "deep" else 120, 3)
    kv = _ts_kvstore(path)
    want = sorted(k.decode() for k in kv.list().result())
    store = OcdbtStore(path)
    assert store.keys() == want and len(want) > 50
    for key in want:
        assert store.read(key) == kv.read(key).result().value, key
    assert "no/such/key" not in store
    with pytest.raises(KeyError):
        store.read("no/such/key")


def test_ocdbt_refuses_a_numbered_manifest(tmp_path):
    """TensorStore's other manifest kind (versions in manifest.<n> files),
    which orbax does not write, raises rather than reading an old version."""
    from nanodecoder_tpu_torch.io.ocdbt import OcdbtError, OcdbtStore

    path = str(tmp_path / "db")
    _write_store(path, {"manifest_kind": "numbered"}, 60, 2)
    with pytest.raises(OcdbtError, match="manifest kind 1"):
        OcdbtStore(path)


def test_ocdbt_checks_magic_length_and_crc(tmp_path):
    """A flipped byte in a manifest or a node, a truncated node, or a
    file with another magic raises OcdbtError."""
    from nanodecoder_tpu_torch.io.ocdbt import OcdbtError, OcdbtStore

    src = os.path.join(GOLDEN, "3", "default")
    nodes = [os.path.join(d, f) for d, _, fs in os.walk(src) for f in fs
             if open(os.path.join(d, f), "rb").read(4) == bytes.fromhex("0cdb20de")]
    top = os.path.relpath(next(n for n in nodes if "process" not in n), src)
    for target, edit in (("manifest.ocdbt", "flip"), (top, "flip"), (top, "cut"),
                         ("manifest.ocdbt", "magic")):
        root = str(tmp_path / f"{edit}-{len(os.listdir(tmp_path))}")
        shutil.copytree(src, root)
        path = os.path.join(root, target)
        data = bytearray(open(path, "rb").read())
        if edit == "flip":
            data[len(data) // 2] ^= 0x10
        elif edit == "cut":
            data = data[:-7]
        else:
            data[:4] = bytes.fromhex("0cdb20de")
        open(path, "wb").write(bytes(data))
        with pytest.raises(OcdbtError, match="CRC32C|length|magic|past the end"):
            OcdbtStore(root)


# -- zarr ------------------------------------------------------------------------

def _ts_zarr(path: str, name: str, shape, chunks, dtype, compressor, fill=None, **extra):
    import tensorstore as ts

    meta = {"shape": list(shape), "chunks": list(chunks), "dtype": dtype,
            "compressor": compressor, "fill_value": fill, **extra}
    return ts.open({"driver": "zarr", "create": True, "metadata": meta,
                    "kvstore": {"driver": "ocdbt", "base": f"file://{path}",
                                "path": f"{name}/"}}).result()


ZARR_CASES = [("<f4", (37, 50), (16, 16)), ("<f2", (6, 6), (4, 4)),
              ("<i4", (5, 7, 9), (2, 3, 4)), ("<i8", (), ()), ("|u1", (10, 3), (4, 3)),
              ("bfloat16", (100,), (33,)), ("<f4", (300,), (300,))]


@pytest.mark.parametrize("dtype,shape,chunks", ZARR_CASES)
def test_zarr_matches_tensorstore(dtype, shape, chunks, tmp_path):
    """Multi-chunk arrays with edge chunks, zstd or no compressor; where a
    chunk is left unwritten it reads as fill_value."""
    import tensorstore as ts

    from nanodecoder_tpu_torch.io.ocdbt import OcdbtStore
    from nanodecoder_tpu_torch.io.zarr import ZarrArray

    rng = np.random.default_rng(len(shape))
    np_dtype = ts.bfloat16.numpy_dtype if dtype == "bfloat16" else np.dtype(dtype)
    x = (rng.normal(size=shape) * 50).astype(np_dtype)
    path = str(tmp_path / "db")
    compressor = None if chunks == shape else {"id": "zstd", "level": 3}
    arr = _ts_zarr(path, "a", shape, chunks, dtype, compressor)
    arr.write(x).result()
    partial = len(shape) >= 2
    if partial:  # only the first chunk row is written; fill_value 7 elsewhere
        _ts_zarr(path, "b", shape, chunks, dtype, compressor, fill=7)[:chunks[0]].write(
            x[:chunks[0]]).result()
    store = OcdbtStore(path)
    got = ZarrArray(store, "a")
    assert got.shape == tuple(shape) and got.dtype == dtype
    raw = got.read()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(raw, x.view(np.uint16))
        np.testing.assert_array_equal(got.as_float32(), x.astype(np.float32))
    else:
        np.testing.assert_array_equal(raw, x)
        assert raw.dtype == np.dtype(dtype)
    if partial:
        b = ZarrArray(store, "b").read()
        want = np.full(shape, 7, np_dtype)
        want[:chunks[0]] = x[:chunks[0]]
        np.testing.assert_array_equal(b, want)


@pytest.mark.parametrize("meta,why", [
    ({"compressor": {"id": "blosc", "cname": "lz4"}}, "blosc"),
    ({"filters": [{"id": "delta", "dtype": "<f4"}]}, "delta"),
    ({"dtype": ">f8"}, ">f8"),
    ({"zarr_format": 3}, "zarr_format"),
    ({"dimension_separator": "/"}, "dimension_separator"),
])
def test_zarr_refuses_what_it_does_not_read(meta, why):
    from nanodecoder_tpu_torch.io.zarr import ZarrArray, ZarrError

    base = {"chunks": [2], "compressor": None, "dtype": "<f4", "fill_value": None,
            "filters": None, "order": "C", "shape": [4], "zarr_format": 2}

    class Store(dict):
        def read(self, key):
            return self[key]

    store = Store({"x/.zarray": json.dumps({**base, **meta}).encode()})
    with pytest.raises(ZarrError, match=why):
        ZarrArray(store, "x")


# -- the TrainState ---------------------------------------------------------------

CASES = {"adam_clip": ("adam", 5.0), "adam_noclip": ("adam", 0.0),
         "adamw": ("adamw", 5.0), "sgd": ("sgd", 5.0)}


def _jax_cfg(optimizer: str = "adam", clip: float = 5.0):
    from nanodecoder_tpu.config import tiny_test_config

    c = tiny_test_config()
    return dataclasses.replace(
        c, model=dataclasses.replace(c.model, dropout=0.0),
        train=dataclasses.replace(c.train, optimizer=optimizer, grad_clip=clip,
                                  lr_schedule="constant", learning_rate=1e-3))


@functools.lru_cache(maxsize=None)
def _jax_grad_step():
    """The JAX package's train step with a transform that keeps the
    gradients as its state and leaves the params: compiled once."""
    import jax
    import jax.numpy as jnp
    import optax
    from nanodecoder_tpu.train import trainer as jt

    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, _s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    return jax.jit(jt.make_train_step(_jax_cfg(), capture)), capture


@functools.lru_cache(maxsize=None)
def _batches() -> tuple:
    from nanodecoder_tpu.train.data import synthetic_batches

    return tuple(itertools.islice(synthetic_batches(_jax_cfg(), seed=0), 5))


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The port's init (seed 0) of the tiny model as the JAX package's
    params tree (nested dicts and lists of jax arrays, its layouts)."""
    import jax.numpy as jnp

    from nanodecoder_tpu_torch.models.model import init_model
    from nanodecoder_tpu_torch.train.checkpoint import params_to_numpy

    from nanodecoder_tpu_torch.config import Config

    model = Config.from_json(_jax_cfg().to_json()).model
    root: dict = {}
    flat = params_to_numpy(init_model(PRNGKey(0), model))
    for key in sorted(flat, key=lambda k: [(0, int(p), "") if p.isdigit() else (1, 0, p)
                                          for p in k.split("/")]):
        node, parts = root, key.split("/")
        for part, nxt in zip(parts[:-1], parts[1:]):
            if isinstance(node, list):
                if int(part) == len(node):
                    node.append([] if nxt.isdigit() else {})
                node = node[int(part)]
            else:
                node = node.setdefault(part, [] if nxt.isdigit() else {})
        node[parts[-1]] = jnp.asarray(flat[key])
    return root


@functools.lru_cache(maxsize=None)
def _jax_optimizer(optimizer: str, clip: float):
    """The JAX package's optax chain for the config, its init and update
    compiled."""
    import jax
    from nanodecoder_tpu.train.optim import build_optimizer

    cfg = _jax_cfg(optimizer, clip)
    opt = build_optimizer(cfg.train, cfg.model.d_model)[0]
    return jax.jit(opt.init), jax.jit(opt.update)


def _jax_init(cfg):
    import jax.numpy as jnp
    from nanodecoder_tpu.train import trainer as jt

    init, _update = _jax_optimizer(cfg.train.optimizer, cfg.train.grad_clip)
    params = _jax_params()
    return jt.TrainState(params, init(params), jnp.zeros((), jnp.int32))


def _jax_train(cfg, state, batches):
    """Steps of the JAX package: its train step's gradients, then the
    config's optax optimizer."""
    import jax
    import optax
    from nanodecoder_tpu.train import trainer as jt

    step, capture = _jax_grad_step()
    _init, update = _jax_optimizer(cfg.train.optimizer, cfg.train.grad_clip)
    for b in batches:
        grads = step(jt.TrainState(state.params, capture.init(state.params), state.step), b,
                     jax.random.PRNGKey(int(state.step)))[0].opt_state
        updates, opt_state = update(grads, state.opt_state, state.params)
        state = jt.TrainState(optax.apply_updates(state.params, updates), opt_state,
                              state.step + 1)
    return state


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """case -> (checkpoint directory, JAX config, the JAX package's
    restore of step 3); each made once."""
    made = {}

    def get(case: str):
        if case not in made:
            from nanodecoder_tpu.train.checkpoint import CheckpointManager

            cfg = _jax_cfg(*CASES[case])
            state = _jax_train(cfg, _jax_init(cfg), _batches()[:3])
            path = str(tmp_path_factory.mktemp(case) / "ckpts")
            mgr = CheckpointManager(path, cfg)
            mgr.save(3, state, wait=True)
            restored = mgr.restore(_jax_init(cfg), 3)
            mgr.close()
            made[case] = (path, cfg, restored)
        return made[case]

    return get


def _flat(tree) -> dict:
    import jax

    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp):
            np.asarray(leaf) for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_bit_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want) and got
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_train_state_bit_equal_to_jax_restore(case, jax_run, jax_basecall):
    # (jax_basecall starts the JAX package's CLI for a later test here, so
    # that it runs beside these.)
    from nanodecoder_tpu_torch.train.checkpoint import params_to_numpy, read_jax_checkpoint

    path, cfg, want = jax_run(case)
    got = read_jax_checkpoint(path, device="cpu")
    _assert_bit_equal(params_to_numpy(got.params), _flat(want.params))
    chain = want.opt_state[-1]
    assert int(got.opt_state["count"]) == int(chain[-1].count) == 3
    assert got.step == int(want.step) == 3
    if cfg.train.optimizer == "sgd":
        assert set(got.opt_state) == {"count"}
        return
    assert int(chain[0].count) == 3
    for name in ("mu", "nu"):
        _assert_bit_equal(params_to_numpy(got.opt_state[name]), _flat(getattr(chain[0], name)))


def test_committed_fixture_matches_the_jax_restore():
    """The checkpoint chip_smoke.py phase 17 reads on the card, held here
    to the JAX package's own restore (scripts/make_orbax_fixture.py)."""
    from nanodecoder_tpu_torch.train.checkpoint import (jax_steps, params_to_numpy,
                                                        read_jax_checkpoint)

    assert jax_steps(GOLDEN) == [3]
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(GOLDEN) for f in fs)
    assert size < 1 << 20
    with np.load(EXPECTED) as e:
        want = {k: e[k] for k in e.files}
    got = read_jax_checkpoint(GOLDEN, device="cpu")
    for name, tree in (("params", got.params), ("mu", got.opt_state["mu"]),
                       ("nu", got.opt_state["nu"])):
        _assert_bit_equal(params_to_numpy(tree),
                          {k[len(name) + 1:]: v for k, v in want.items()
                           if k.startswith(name + "/")})
    assert int(got.opt_state["count"]) == int(want["count"]) and got.step == int(want["step"])


def test_flagship_full_width_bit_equal_to_the_npz(tmp_path):
    """The flagship's 7,657,432 params in a TrainState (optimizer.init)
    saved by the JAX package; the port's read equals the npz bit for bit."""
    import jax.numpy as jnp
    from nanodecoder_tpu.config import Config as JaxConfig
    from nanodecoder_tpu.models.model import init_model
    from nanodecoder_tpu.train import trainer as jt
    from nanodecoder_tpu.train.checkpoint import CheckpointManager, load_params_npz
    from nanodecoder_tpu.train.optim import build_optimizer

    from nanodecoder_tpu_torch.train.checkpoint import params_to_numpy, read_jax_params

    import jax

    cfg = JaxConfig.from_json(open(FLAGSHIP_CONFIG).read())
    like = jax.eval_shape(lambda: init_model(jax.random.PRNGKey(0), cfg.model))
    params = load_params_npz(FLAGSHIP_NPZ, like)
    opt = build_optimizer(cfg.train, cfg.model.d_model)[0]
    mgr = CheckpointManager(str(tmp_path / "ck"), cfg)
    mgr.save(1000, jt.TrainState(params, opt.init(params), jnp.full((), 1000, jnp.int32)),
             wait=True)
    mgr.close()
    got = params_to_numpy(read_jax_params(str(tmp_path / "ck"), device="cpu"))
    with np.load(FLAGSHIP_NPZ) as w:
        want = {k: w[k] for k in w.files}
    assert sum(v.size for v in want.values()) == 7_657_432
    _assert_bit_equal(got, want)


def test_read_refuses_leaves_the_config_does_not_have(jax_run):
    """A config with another optimizer or clip setting than the run's
    finds missing or left-over leaves; a model config of other widths
    another shape."""
    from nanodecoder_tpu_torch.config import Config
    from nanodecoder_tpu_torch.train.checkpoint import read_jax_checkpoint

    path, cfg, _ = jax_run("adam_clip")
    port = Config.from_json(cfg.to_json())
    for train in ({"optimizer": "sgd"}, {"optimizer": "adamw"}, {"grad_clip": 0.0}):
        other = dataclasses.replace(port, train=dataclasses.replace(port.train, **train))
        with pytest.raises(ValueError, match="missing|left over"):
            read_jax_checkpoint(path, device="cpu", config=other)
    other = dataclasses.replace(port, model=dataclasses.replace(port.model, dec_ffn_dim=48))
    with pytest.raises(ValueError, match="shape"):
        read_jax_checkpoint(path, device="cpu", config=other)


# -- through the CLIs -----------------------------------------------------------------

def _tree_hashes(root: str) -> dict[str, str]:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def _npz_export(path: str, cfg, state, root) -> str:
    """The JAX state's params as save_params_npz writes them, with
    config.json beside."""
    os.makedirs(root, exist_ok=True)
    npz = os.path.join(str(root), "params.npz")
    np.savez(npz, **_flat(state.params))
    with open(os.path.join(str(root), "config.json"), "w") as f:
        f.write(cfg.to_json())
    return npz


@pytest.fixture(scope="module")
def jax_basecall(jax_run, tmp_path_factory):
    """The JAX package's basecall CLI on the adam_clip run's directory, in
    a process of its own (one CPU device: batches of 4 chunks), started
    at its first request so that it runs beside the tests that follow:
    (reads directory, the CLI arguments but --output, the directory's
    file hashes before, a function that waits for the FASTQ)."""
    import subprocess
    import sys

    from test_torch_engine import write_fast5_files

    path, _cfg, _ = jax_run("adam_clip")
    root = tmp_path_factory.mktemp("basecall")
    reads = root / "reads"
    reads.mkdir()
    write_fast5_files(reads)
    common = ["--input", str(reads), "--ckpt", path, "--parity", "--workers", "2",
              "--stitch", "attn"]
    before = _tree_hashes(path)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO, "XLA_FLAGS": "",
           "JAX_COMPILATION_CACHE_DIR": str(root / "jax_cache")}
    out, log = root / "jax.fastq", open(root / "jax.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "nanodecoder_tpu.cli.basecall", "--cpu",
                             "--output", str(out), *common], cwd=str(root), env=env,
                            stdout=log, stderr=subprocess.STDOUT)

    def fastq() -> str:
        proc.wait(timeout=300)
        log.close()
        assert proc.returncode == 0, (root / "jax.log").read_text()[-3000:]
        return out.read_text()

    yield str(reads), common, before, fastq
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    log.close()


def test_basecall_and_evaluate_clis_take_the_orbax_directory(jax_run, jax_basecall,
                                                             tmp_path, capsys):
    """The port's basecall CLI on the orbax directory: the JAX package's
    basecall CLI's FASTQ on the same directory (ids, sequences and order
    equal, qualities within 1 Phred), and byte-equal to the port's own
    run on the npz export; the evaluate CLI's JSON equal on both."""
    from test_torch_engine import assert_fastq_close

    from nanodecoder_tpu_torch.cli import basecall, evaluate

    path, cfg, restored = jax_run("adam_clip")
    _reads, common, before, jax_fastq = jax_basecall
    npz = _npz_export(path, cfg, restored, tmp_path / "export")
    outs = {}
    for name, ckpt in (("orbax", path), ("npz", npz)):
        outs[name] = str(tmp_path / f"{name}.fastq")
        args = [a if a != path else ckpt for a in common]
        assert basecall.main(["--cpu", "--output", outs[name], *args]) == 0
    got = open(outs["orbax"]).read()
    assert got == open(outs["npz"]).read()

    summaries = []
    for ckpt in (path, npz):
        capsys.readouterr()
        assert evaluate.main(["--cpu", "--ckpt", ckpt, "--simulate", "2", "--dtype",
                              "float32", "--read-bases", "200", "--json"]) == 0
        summaries.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert summaries[0] == summaries[1] and summaries[0]["n_reads"] == 2
    assert_fastq_close(got, jax_fastq())
    assert _tree_hashes(path) == before


def _held_close(got: dict, want: dict, start: dict, tiny: dict, steps: int, lr: float):
    """test_torch_train.py's tolerance: atol 1e-5, except Adam's elements
    whose gradient was non-zero and under 1e-6 in a step (a step of about
    lr in either direction), held to ADAM_STEP lr a step; those stay
    under 2%."""
    from test_torch_train import ADAM_STEP

    for key in want:
        held = ~tiny[key]
        np.testing.assert_allclose(got[key][held], want[key][held], atol=1e-5, rtol=0,
                                   err_msg=key)
        assert np.all(np.abs(got[key] - start[key])[~held] <= steps * lr * ADAM_STEP), key
    assert sum(int(m.sum()) for m in tiny.values()) < 0.02 * sum(m.size for m in tiny.values())


def test_resume_from_the_orbax_directory_matches_the_jax_resume(jax_run):
    """The JAX package restores step 3 and takes steps 4 and 5; the
    port's CheckpointManager restores the same directory into a Trainer,
    which takes the same two batches."""
    from nanodecoder_tpu.train.checkpoint import CheckpointManager as JaxManager

    from nanodecoder_tpu_torch.config import Config
    from nanodecoder_tpu_torch.models.model import named_leaves
    from nanodecoder_tpu_torch.train.checkpoint import CheckpointManager, params_to_numpy
    from nanodecoder_tpu_torch.train.trainer import Trainer

    path, cfg, _ = jax_run("adam_clip")
    mgr = JaxManager(path, cfg)
    jstate = mgr.restore(_jax_init(cfg))
    mgr.close()
    start = _flat(jstate.params)
    want = _flat(_jax_train(cfg, jstate, _batches()[3:5]).params)

    port_cfg = Config.from_json(cfg.to_json())
    state = CheckpointManager(path, port_cfg).restore(device="cpu")
    assert state.step == 3
    trainer = Trainer(port_cfg, state.params)
    trainer.state = state
    tiny = {k: np.zeros(v.shape, bool) for k, v in start.items()}
    for b in _batches()[3:5]:
        trainer.train_step(b)
        for key, p in named_leaves(trainer.params).items():
            g = params_to_numpy({key: p.grad})[key] if p.grad is not None else 0 * start[key]
            tiny[key] |= (np.abs(g) < 1e-6) & (g != 0)
    assert trainer.step == 5 and int(trainer.optimizer.state["count"]) == 5
    _held_close(params_to_numpy(trainer.params), want, start, tiny, 2, 1e-3)


def test_port_save_onto_a_jax_step_raises(jax_run, tmp_path):
    from nanodecoder_tpu_torch.config import Config
    from nanodecoder_tpu_torch.train.checkpoint import CheckpointManager, jax_steps

    src, cfg, _ = jax_run("adam_clip")
    path = str(tmp_path / "ck")
    shutil.copytree(src, path)
    before = _tree_hashes(path)
    mgr = CheckpointManager(path, Config.from_json(cfg.to_json()))
    state = mgr.restore(device="cpu")
    with pytest.raises(FileExistsError, match=os.path.join(path, "3")):
        mgr.save(3, state)
    mgr.save(4, state)  # beside it
    assert mgr.all_steps() == [4] and jax_steps(path) == [3]
    assert mgr.latest() == (4, False)
    after = _tree_hashes(path)
    assert {k: v for k, v in after.items() if not k.startswith("4/")} == before


def test_train_cli_resume_leaves_the_jax_files_as_they_were(jax_run, tmp_path):
    """`cli.train --resume` from the JAX step 3 with a save every step
    and one kept: steps 4 to 6 are saved and 4, 5 pruned, the JAX step
    and config.json hash as before; without --resume a save reaching
    step 3 raises and leaves them too."""
    from nanodecoder_tpu_torch.cli import train

    src, cfg, _ = jax_run("adam_clip")
    path = str(tmp_path / "ck")
    shutil.copytree(src, path)
    before = _tree_hashes(path)
    conf = tmp_path / "train.json"
    conf.write_text(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, save_every=1, keep_checkpoints=1)).to_json())
    args = ["--cpu", "--ckpt-dir", path, "--config", str(conf), "--report-every", "100"]
    assert train.main([*args, "--steps", "6", "--resume"]) == 0
    assert sorted(os.listdir(path)) == ["3", "6", "config.json"]
    after = _tree_hashes(path)
    assert {k: v for k, v in after.items() if not k.startswith("6/")} == before
    shutil.rmtree(os.path.join(path, "6"))
    with pytest.raises(FileExistsError):
        train.main([*args, "--steps", "4"])
    assert {k: v for k, v in _tree_hashes(path).items() if k[0] not in "12"} == before


@pytest.mark.parametrize("resume", [False, True])
def test_train_cli_final_save_never_drops_the_state(jax_run, tmp_path, resume):
    """`cli.train --steps 3` with no periodic save at step 3 (save_every
    10) on a copy of a JAX run's directory, which holds step 3: without
    --resume the run trains steps 1 to 3 of its own, and its final save
    onto the JAX step raises rather than exit 0 with that state dropped;
    with --resume it restores step 3, trains no further and writes
    nothing.  The JAX files hash as before either way."""
    from nanodecoder_tpu_torch.cli import train

    src, cfg, _ = jax_run("adam_clip")
    path = str(tmp_path / "ck")
    shutil.copytree(src, path)
    before = _tree_hashes(path)
    conf = tmp_path / "train.json"
    conf.write_text(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, save_every=10)).to_json())
    args = ["--cpu", "--ckpt-dir", path, "--config", str(conf), "--steps", "3",
            "--report-every", "100"]
    if resume:
        assert train.main([*args, "--resume"]) == 0
    else:
        with pytest.raises(FileExistsError, match=os.path.join(path, "3")):
            train.main(args)
    assert _tree_hashes(path) == before


def test_a_directory_of_both_formats_serves_its_newest_step(jax_run, tmp_path):
    """load_params_and_config takes the highest step of either format and,
    on a tie (a step directory holding both), the port's."""
    from nanodecoder_tpu_torch.cli.common import load_params_and_config
    from nanodecoder_tpu_torch.config import Config
    from nanodecoder_tpu_torch.train.checkpoint import (CheckpointManager, jax_steps,
                                                        params_from_numpy, params_to_numpy)

    src, cfg, _ = jax_run("adam_clip")
    path = str(tmp_path / "ck")
    shutil.copytree(src, path)
    mgr = CheckpointManager(path, Config.from_json(cfg.to_json()))
    state = mgr.restore(device="cpu")
    jax_params = params_to_numpy(state.params)
    bumped = {k: v + 1 for k, v in jax_params.items()}
    port_state = state._replace(params=params_from_numpy(bumped, mgr.config.model, "cpu"))

    def served():
        return params_to_numpy(load_params_and_config(path, "cpu")[0])

    _assert_bit_equal(served(), jax_params)  # the JAX step 3 alone
    mgr.save(2, port_state)
    _assert_bit_equal(served(), jax_params)  # 3 beats the port's 2
    mgr.save(5, port_state)
    _assert_bit_equal(served(), bumped)      # the port's 5 beats 3
    shutil.rmtree(os.path.join(path, "5"))
    for name in (CheckpointManager.PARAMS, CheckpointManager.OPT):
        shutil.copy(os.path.join(path, "2", name), os.path.join(path, "3", name))
    assert mgr.all_steps() == [2, 3] and jax_steps(path) == [3]
    _assert_bit_equal(served(), bumped)      # a tie: the port's
