"""Raw-read ingest from fast5 (HDF5) and pod5 files (the port's copy of
`nanodecoder_tpu.io.fast5`).

fast5 is read through h5py: the raw signal dataset
(`/Raw/Reads/Read_*/Signal` for single-read fast5, `/<read_id>/Raw/Signal`
for multi-read fast5) with the channel calibration (range, digitisation,
offset) applied to give picoamps.  pod5 is read through the pure-Python
reader in io/pod5.py (pyarrow, zstandard and flatbuffers).  Either
library may be missing; a reader raises when the one it needs is.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover - optional
    h5py = None


@dataclasses.dataclass
class RawRead:
    """One nanopore read: calibrated picoamp signal + identity."""

    read_id: str
    signal: np.ndarray  # float32 picoamps (or raw DAC if uncalibrated)
    source_file: str
    channel_offset: float = 0.0
    channel_range: float = 0.0
    digitisation: float = 0.0

    @property
    def n_samples(self) -> int:
        return int(self.signal.shape[0])


def _calibrate(raw: np.ndarray, offset: float, rng: float, digitisation: float) -> np.ndarray:
    """DAC counts -> picoamps: (raw + offset) * range / digitisation."""
    raw = np.asarray(raw, dtype=np.float32)
    if digitisation and rng:
        return (raw + np.float32(offset)) * np.float32(rng / digitisation)
    return raw


def _channel_params(grp) -> tuple[float, float, float]:
    attrs = grp.attrs
    return (
        float(attrs.get("offset", 0.0)),
        float(attrs.get("range", 0.0)),
        float(attrs.get("digitisation", 0.0)),
    )


def _read_single_fast5(f, path: str) -> Iterator[RawRead]:
    """Single-read fast5 layout: /Raw/Reads/Read_<n>/Signal +
    /UniqueGlobalKey/channel_id calibration attrs."""
    offset = rng = digi = 0.0
    if "UniqueGlobalKey/channel_id" in f:
        offset, rng, digi = _channel_params(f["UniqueGlobalKey/channel_id"])
    reads_grp = f["Raw/Reads"]
    for name in reads_grp:
        grp = reads_grp[name]
        read_id = grp.attrs.get("read_id", name)
        if isinstance(read_id, bytes):
            read_id = read_id.decode()
        sig = _calibrate(grp["Signal"][()], offset, rng, digi)
        yield RawRead(str(read_id), sig, path, offset, rng, digi)


def _read_multi_fast5(f, path: str) -> Iterator[RawRead]:
    """Multi-read fast5 layout: /<read_xxx>/Raw/Signal with per-read
    /<read_xxx>/channel_id calibration."""
    for key in f:
        grp = f[key]
        if "Raw" not in grp:
            continue
        offset = rng = digi = 0.0
        if "channel_id" in grp:
            offset, rng, digi = _channel_params(grp["channel_id"])
        raw_grp = grp["Raw"]
        read_id = raw_grp.attrs.get("read_id", key.removeprefix("read_"))
        if isinstance(read_id, bytes):
            read_id = read_id.decode()
        sig = _calibrate(raw_grp["Signal"][()], offset, rng, digi)
        yield RawRead(str(read_id), sig, path, offset, rng, digi)


def read_fast5_file(path: str) -> list[RawRead]:
    """Read all raw reads from one signal file: fast5 (single- or
    multi-read HDF5) or pod5 (dispatched by extension)."""
    if path.endswith(".pod5"):
        return _read_pod5_file(path)
    if h5py is None:  # pragma: no cover
        raise RuntimeError("h5py is required for fast5 ingest")
    with h5py.File(path, "r") as f:
        if "Raw" in f and "Reads" in f["Raw"]:
            return list(_read_single_fast5(f, path))
        return list(_read_multi_fast5(f, path))


def _read_pod5_file(path: str) -> list[RawRead]:
    """pod5 ingest through the pure-Python reader in io/pod5.py."""
    from nanodecoder_tpu_torch.io.pod5 import read_pod5

    out = []
    for r in read_pod5(path):
        # calibration: pA = scale * (raw + offset)
        sig = (np.asarray(r.signal, np.float32) + np.float32(r.calibration_offset)) \
            * np.float32(r.calibration_scale or 1.0)
        out.append(RawRead(str(r.read_id), sig, path,
                           channel_offset=r.calibration_offset))
    return out


FAST5_EXTS = (".fast5", ".f5", ".hdf5", ".h5")


def list_signal_files(root: str) -> list[str]:
    """All fast5/pod5 files under `root` (file or directory), sorted."""
    if os.path.isfile(root):
        return [root]
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            if fn.endswith(FAST5_EXTS) or fn.endswith(".pod5"):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def iter_fast5_reads(root: str) -> Iterator[RawRead]:
    """Iterate reads across every signal file under `root`."""
    for path in list_signal_files(root):
        yield from read_fast5_file(path)
