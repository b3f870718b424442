"""The read record the basecaller consumes (the port's copy of
`nanodecoder_tpu.io.fast5.RawRead`).  The fast5 and pod5 file readers
are not ported yet; reads come from the simulator or from the caller."""

from __future__ import annotations

import dataclasses

import numpy as np


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
