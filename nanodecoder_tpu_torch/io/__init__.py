"""Host I/O: signal normalization, chunking and wire, stitching, the
fast5/pod5 readers, FASTX, and the ingest pipeline.

The JAX package's re-exports resolve on first use, so the numpy-only
modules (stitch, fastx) load without torch."""

from nanodecoder_tpu_torch._lazy import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "ChunkBatch": "signal", "chunk_signal": "signal", "normalize_signal": "signal",
    "stitch_chunks": "stitch",
    "RawRead": "fast5", "iter_fast5_reads": "fast5", "read_fast5_file": "fast5",
    "merge_fastx_shards": "fastx", "write_fasta": "fastx", "write_fastq": "fastx",
})
