"""Host I/O: signal normalization, chunking and wire, stitching, FASTX."""
