"""PyTorch port, the native host library (`nanodecoder_tpu_torch.native`):
it builds, and its overlap scorer and banded edit distance equal the
numpy versions (`io.stitch._best_overlap_len_plain`,
`identity.edit_distance_plain`) and the JAX package's native module on the
same seeded pairs, exactly (integer results); stitched sequences do not
change; without a compiler the numpy versions run after one warning.

The port's counterparts of tests/test_native.py, plus the comparisons.
"""

import logging
import os

import numpy as np
import pytest
import torch

from nanodecoder_tpu_torch import identity, native
from nanodecoder_tpu_torch.io import stitch

BASES = list("ACGT")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As the port's other test modules: one torch thread while the suite's
    other workers hold the cores; restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _py_best_overlap(left: str, right: str, max_k: int) -> int:
    max_k = min(max_k, len(left), len(right))
    if max_k <= 0:
        return 0
    lbuf = np.frombuffer(left[-max_k:].encode(), np.uint8)
    rbuf = np.frombuffer(right[:max_k].encode(), np.uint8)
    best_k, best_score = 0, 0
    for k in range(1, max_k + 1):
        eq = int(np.count_nonzero(lbuf[max_k - k:] == rbuf[:k]))
        score = 2 * eq - k
        if score > best_score:
            best_k, best_score = k, score
    return best_k


def _slow_distance(a: str, b: str) -> int:
    n, m = len(a), len(b)
    d = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        d[i][0] = i
    for j in range(m + 1):
        d[0][j] = j
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d[i][j] = min(d[i - 1][j] + 1, d[i][j - 1] + 1,
                          d[i - 1][j - 1] + (a[i - 1] != b[j - 1]))
    return d[n][m]


def _mutated(rng, truth: str, n_edits: int) -> str:
    b = list(truth)
    for _ in range(n_edits):
        p = int(rng.integers(0, len(b) + 1))
        op = int(rng.integers(0, 3))
        if op == 0:
            b.insert(p, BASES[int(rng.integers(4))])
        elif b and p < len(b):
            if op == 1:
                b.pop(p)
            else:
                b[p] = BASES[int(rng.integers(4))]
    return "".join(b)


def _pairs(seed: int, n: int, max_len: int = 400):
    """Seeded (a, b) pairs: half unrelated, half b an edited copy of a."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        a = "".join(rng.choice(BASES, int(rng.integers(0, max_len))))
        if i % 2:
            b = _mutated(rng, a, int(rng.integers(0, max(1, len(a) // 5) + 1)))
        else:
            b = "".join(rng.choice(BASES, int(rng.integers(0, max_len))))
        yield a, b


def test_native_builds():
    assert native.load() is not None, "g++ build of the native host library failed"


def test_native_matches_python(rng_np):
    for _ in range(50):
        n1 = int(rng_np.integers(1, 200))
        n2 = int(rng_np.integers(1, 200))
        left = "".join(rng_np.choice(BASES, size=n1))
        right = "".join(rng_np.choice(BASES, size=n2))
        if rng_np.random() < 0.5 and n1 > 20:  # sometimes a true overlap
            k = int(rng_np.integers(5, min(n1, 60)))
            right = left[-k:] + right
        max_k = int(rng_np.integers(1, 120))
        want = _py_best_overlap(left, right, max_k)
        assert native.best_overlap_len_native(left.encode(), right.encode(),
                                              max_k) == want
        assert stitch._best_overlap_len(left, right, max_k) == want
        assert stitch._best_overlap_len_plain(left, right, max_k) == want


def test_native_finds_known_overlap():
    left = "A" * 50 + "ACGTACGTACGTACGT"
    right = "ACGTACGTACGTACGT" + "C" * 50
    assert native.best_overlap_len_native(left.encode(), right.encode(), 40) == 16


def test_known_distances():
    for ed in (native.edit_distance, identity.edit_distance_plain):
        assert ed("", "") == 0
        assert ed("ACGT", "ACGT") == 0
        assert ed("ACGT", "AGGT") == 1   # substitution
        assert ed("ACGT", "ACGGT") == 1  # insertion
        assert ed("ACGT", "AGT") == 1    # deletion
        assert ed("AAAA", "TTTT") == 4
        assert ed("", "ACG") == 3


def test_matches_python_dp(rng_np):
    for _ in range(20):
        a = "".join(rng_np.choice(BASES, size=rng_np.integers(0, 60)))
        b = "".join(rng_np.choice(BASES, size=rng_np.integers(0, 60)))
        want = _slow_distance(a, b)
        assert native.edit_distance(a, b) == want, (a, b)
        assert identity.edit_distance_plain(a, b) == want, (a, b)


def test_read_identity():
    for rid in (native.read_identity, identity.read_identity_plain):
        assert rid("ACGT", "ACGT") == 1.0
        assert abs(rid("ACGA", "ACGT") - 0.75) < 1e-9
        assert rid("", "ACGT") == 0.0
        assert rid("", "") == 1.0


def test_native_and_numpy_equal_jax_native():
    """The port's native and numpy routes against the JAX package's native
    module, on the same 400 seeded pairs (distances, identities, overlaps)
    and on two 3000-base reads at the flagship's identity level."""
    from nanodecoder_tpu import native as jax_native

    assert jax_native.load() is not None
    for i, (a, b) in enumerate(_pairs(5, 400)):
        want = jax_native.edit_distance(a, b)
        assert identity.edit_distance(a, b) == want, (a, b)
        assert identity.edit_distance_plain(a, b) == want, (a, b)
        assert identity.read_identity(b, a) == jax_native.read_identity(b, a)
        k = 1 + i % 150
        want_k = jax_native.best_overlap_len_native(a.encode(), b.encode(), k)
        assert native.best_overlap_len_native(a.encode(), b.encode(), k) == want_k
        assert stitch._best_overlap_len_plain(a, b, k) == want_k
    rng = np.random.default_rng(9)
    truth = "".join(rng.choice(BASES, 3000))
    for called in (_mutated(rng, truth, 220), truth[:900] + truth[1000:2500] + "ACGT" * 30):
        want = jax_native.read_identity(called, truth)
        assert identity.read_identity(called, truth) == want
        assert identity.read_identity_plain(called, truth) == want


@pytest.mark.parametrize("seed", [0, 1])
def test_stitched_sequences_unchanged(seed):
    """The align stitch (the native scorer's caller) gives the same
    sequence and qualities with the native scorer and with numpy."""
    rng = np.random.default_rng(seed)
    starts = np.array([0, 1792, 3584, 5376], np.int64)
    lengths = np.array([2048, 2048, 2048, 900], np.int32)
    seqs = ["".join(rng.choice(BASES, n)) for n in (230, 226, 231, 90)]
    for i in range(1, 4):  # give adjacent calls a true overlap to find
        k = int(rng.integers(10, 40))
        seqs[i] = seqs[i - 1][-k:] + seqs[i][k:]
    quals = [rng.uniform(1, 50, len(s)).astype(np.float32) for s in seqs]
    got = stitch.stitch_chunks(seqs, starts, lengths, 2048, 256, "align", quals)
    orig = stitch._best_overlap_len
    try:
        stitch._best_overlap_len = stitch._best_overlap_len_plain
        want = stitch.stitch_chunks(seqs, starts, lengths, 2048, 256, "align", quals)
    finally:
        stitch._best_overlap_len = orig
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def test_fallback_without_compiler(tmp_path, monkeypatch, caplog):
    """No compiler: one warning, then the numpy versions give the same
    results; the build directory is the environment's override."""
    monkeypatch.setenv("NANODECODER_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "COMPILER", "no-such-compiler-g++")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    # The package's loggers stop at its own handler; give them caplog's.
    package_log = logging.getLogger("nanodecoder_tpu_torch")
    package_log.addHandler(caplog.handler)

    def warned() -> int:
        return sum("native host library unavailable" in r.getMessage()
                   for r in caplog.records)
    try:
        assert native.load() is None
        first = warned()
        assert first >= 1
        assert native.load() is None
        assert native.best_overlap_len_native(b"ACGT", b"GTAA", 4) is None
        assert native.edit_distance("ACGT", "AGT") == 1
        assert identity.read_identity("ACGA", "ACGT") == 0.75
        assert stitch._best_overlap_len("AAACGT", "CGTTT", 5) == 3
        assert warned() == first  # warned once, not at every call
    finally:
        package_log.removeHandler(caplog.handler)
    assert (tmp_path / "build").is_dir()
    assert not list((tmp_path / "build").iterdir())  # no half-built library left


def test_build_into_override_dir(tmp_path, monkeypatch):
    """A fresh build goes into the override directory with its stamp, and a
    changed compiler command makes it build again."""
    monkeypatch.setenv("NANODECODER_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    lib = native.load()
    assert lib is not None
    so = tmp_path / native.LIBRARY_NAME
    stamp = (tmp_path / (native.LIBRARY_NAME + ".stamp")).read_text()
    assert stamp.split("\0") == [native.COMPILER, *native.FLAGS]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        native.LIBRARY_NAME, native.LIBRARY_NAME + ".stamp"]
    built = so.stat().st_mtime_ns
    monkeypatch.setattr(native, "FLAGS", [*native.FLAGS, "-O2"])
    monkeypatch.setattr(native, "_lib", None)
    assert native.load() is not None
    assert so.stat().st_mtime_ns != built
    assert (tmp_path / (native.LIBRARY_NAME + ".stamp")).read_text().endswith("-O2")


def test_host_tier_imports_no_torch(tmp_path):
    """The engine's finishing workers import `decode.finish` (and with it
    stitch, identity and the native library): none of it loads torch."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; import nanodecoder_tpu_torch.decode.finish, "
            "nanodecoder_tpu_torch.identity as i; from nanodecoder_tpu_torch import native; "
            "native.load(); assert i.read_identity('ACGA', 'ACGT') == 0.75; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))")
    env = {**os.environ, "NANODECODER_TORCH_BUILD_DIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
