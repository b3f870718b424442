"""Pure-Python pod5 reader and writer (the port's copy of
`nanodecoder_tpu.io.pod5`; no pod5 wheel required).

pod5 is the columnar successor to fast5, built from Apache Arrow IPC
tables (pyarrow), a FlatBuffers footer (flatbuffers), and zstd-compressed
svb16 signal (zstandard, imported at its first use, + numpy for the
StreamVByte codec).  The layout, as published:

    [signature][section marker]
    [embedded Arrow file: signal table][padding][section marker]
    [embedded Arrow file: reads  table][padding][section marker]
    [FlatBuffer footer][footer length: int64 LE][section marker][signature]

  * signal table columns: read_id fixed_size_binary(16) UUID,
    signal large_binary (vbz-compressed), samples uint32 - one row per
    signal CHUNK (reads longer than the chunk size span several rows).
  * reads table columns: read_id, signal large_list<uint64> (row
    indices into the signal table), read_number uint32,
    calibration_offset float32, calibration_scale float32.
  * vbz signal codec = zstd( svb16_encode( signal, delta+zigzag ) );
    svb16 is the 16-bit StreamVByte variant: one control BIT per value
    (LSB-first within each key byte; 0 -> 1 data byte, 1 -> 2 data
    bytes, little-endian), keys block then data block, vectorized in
    numpy below.

The reader locates embedded tables via the footer and looks up columns
by name (uncompressed large_list<int16> signal is accepted as well as
vbz), and FAILS LOUDLY on structural inconsistency rather than decoding
garbage: every function that needs the three libraries raises when one
is missing (`_require`), footer entries must lie inside the file, and
the svb16 data-block length implied by the control bits must exactly
match the stream (see svb16_decode).
"""

from __future__ import annotations

import dataclasses
import struct
import uuid

import numpy as np

try:
    import pyarrow as pa
    import pyarrow.ipc as pa_ipc
except ImportError:  # pragma: no cover
    pa = None
_UNLOADED = object()
_zstd = _UNLOADED  # zstandard once vbz needs it; None where not installed
try:
    import flatbuffers as _fb
except ImportError:  # pragma: no cover
    _fb = None

SIGNATURE = b"\x8bPOD\r\n\x1a\n"
DEFAULT_SIGNAL_CHUNK = 102400  # samples per signal-table row (spec default)

# Footer FlatBuffer enums (footer.fbs)
FORMAT_FEATHER_V2 = 1
CONTENT_READS_TABLE = 0
CONTENT_SIGNAL_TABLE = 1
CONTENT_RUN_INFO_TABLE = 2


def _require():
    missing = [n for n, m in (("pyarrow", pa), ("flatbuffers", _fb)) if m is None]
    if missing:  # pragma: no cover
        raise RuntimeError(f"pod5 support needs {missing} (not installed)")


def _zstandard():
    """zstandard, imported at the first call (vbz's codec)."""
    global _zstd
    if _zstd is _UNLOADED:
        try:
            import zstandard
        except ImportError:  # pragma: no cover
            zstandard = None
        _zstd = zstandard
    if _zstd is None:
        raise RuntimeError("pod5 signal needs zstandard (not installed)")
    return _zstd


# --------------------------------------------------------------------------
# svb16: 16-bit StreamVByte with zigzag-delta, vectorized in numpy.


def _zigzag_encode(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.int32)
    return ((x << 1) ^ (x >> 15)).astype(np.uint16)


def _zigzag_decode(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint16)
    return ((u >> 1).astype(np.int16) ^ -(u & 1).astype(np.int16)).astype(np.int16)


def svb16_encode(values: np.ndarray, delta: bool = True, zigzag: bool = True) -> bytes:
    """int16 array -> svb16 stream (keys block ++ data block)."""
    v = np.asarray(values, np.int16)
    n = v.shape[0]
    if delta:
        v = np.diff(v.astype(np.int32), prepend=0)
        v = (v & 0xFFFF).astype(np.uint16)
    else:
        v = v.view(np.uint16)
    if zigzag:
        u = _zigzag_encode(v.astype(np.int16))
    else:
        u = v.astype(np.uint16)
    big = u > 0xFF  # needs 2 data bytes
    # keys: one bit per value, LSB-first within each byte
    bits = np.zeros(((n + 7) // 8) * 8, np.uint8)
    bits[:n] = big
    keys = np.packbits(bits.reshape(-1, 8), axis=1, bitorder="little").reshape(-1)
    # data: 1 or 2 little-endian bytes per value
    nbytes = 1 + big.astype(np.int64)
    ends = np.cumsum(nbytes)
    data = np.zeros(int(ends[-1]) if n else 0, np.uint8)
    starts = ends - nbytes
    data[starts] = (u & 0xFF).astype(np.uint8)
    two = np.flatnonzero(big)
    data[starts[two] + 1] = (u[two] >> 8).astype(np.uint8)
    return keys.tobytes() + data.tobytes()


def svb16_decode(stream: bytes, count: int, delta: bool = True,
                 zigzag: bool = True) -> np.ndarray:
    """svb16 stream + value count -> int16 array.

    Fails loudly on layout mismatch: the data-block length implied by
    the control bits must EXACTLY equal the remaining stream bytes.  A
    wrong keys-bit-order / layout assumption vs a file from another
    producer changes the per-value byte counts and is caught here
    instead of decoding garbage signal."""
    n = count
    nkeys = (n + 7) // 8
    if len(stream) < nkeys:
        raise ValueError(
            f"svb16 stream truncated: {len(stream)} bytes < {nkeys}-byte "
            f"key block for {n} values")
    buf = np.frombuffer(stream, np.uint8)
    keys, data = buf[:nkeys], buf[nkeys:]
    bits = np.unpackbits(keys, bitorder="little")[:n].astype(np.int64)
    nbytes = 1 + bits
    expected_data = int(nbytes.sum()) if n else 0
    if expected_data != data.shape[0]:
        raise ValueError(
            f"svb16 layout mismatch: control bits imply {expected_data} "
            f"data bytes but stream carries {data.shape[0]} — the file "
            f"was likely written with a different svb16 variant "
            f"(bit order / key layout); refusing to decode garbage")
    starts = np.cumsum(nbytes) - nbytes
    lo = data[starts].astype(np.uint16)
    hi = np.where(bits == 1, data[np.minimum(starts + 1, data.shape[0] - 1)], 0)
    u = (lo | (hi.astype(np.uint16) << 8)).astype(np.uint16)
    if zigzag:
        v = _zigzag_decode(u)
    else:
        v = u.view(np.int16)
    if delta:
        v = np.cumsum(v.astype(np.int64)).astype(np.int16)
    return v


def vbz_compress(signal: np.ndarray) -> bytes:
    return _zstandard().ZstdCompressor(level=1).compress(svb16_encode(signal))


def vbz_decompress(blob: bytes, count: int) -> np.ndarray:
    raw = _zstandard().ZstdDecompressor().decompress(
        blob, max_output_size=2 * count + (count + 7) // 8 + 16)
    return svb16_decode(raw, count)


# --------------------------------------------------------------------------
# Footer FlatBuffer (hand-rolled: 2 tables, no codegen).


def _footer_bytes(file_id: str, software: str, contents) -> bytes:
    """contents: list of (offset, length, format, content_type)."""
    b = _fb.Builder(256)
    file_id_off = b.CreateString(file_id)
    software_off = b.CreateString(software)
    version_off = b.CreateString("0.3.2")
    entries = []
    for off, ln, fmt, ctype in contents:
        b.StartObject(4)
        b.PrependInt64Slot(0, off, 0)
        b.PrependInt64Slot(1, ln, 0)
        b.PrependInt16Slot(2, fmt, 0)
        b.PrependInt16Slot(3, ctype, 0)
        entries.append(b.EndObject())
    b.StartVector(4, len(entries), 4)
    for e in reversed(entries):
        b.PrependUOffsetTRelative(e)
    vec = b.EndVector()
    b.StartObject(4)
    b.PrependUOffsetTRelativeSlot(0, file_id_off, 0)
    b.PrependUOffsetTRelativeSlot(1, software_off, 0)
    b.PrependUOffsetTRelativeSlot(2, version_off, 0)
    b.PrependUOffsetTRelativeSlot(3, vec, 0)
    b.Finish(b.EndObject())
    return bytes(b.Output())


def _parse_footer(buf: bytes):
    """-> list of (offset, length, format, content_type)."""
    from flatbuffers import encode as _enc
    from flatbuffers import number_types as _nt

    root = _enc.Get(_nt.UOffsetTFlags.packer_type, buf, 0)
    tab = _fb.table.Table(buf, root)
    out = []
    o = tab.Offset(4 + 3 * 2)  # field id 3 (contents) -> vtable slot 10
    if o == 0:
        return out
    vec = tab.Vector(o)
    n = tab.VectorLen(o)
    for i in range(n):
        etab_pos = tab.Indirect(vec + i * 4)
        etab = _fb.table.Table(buf, etab_pos)

        def _i64(t, slot):
            oo = t.Offset(4 + slot * 2)
            return t.Get(_nt.Int64Flags, t.Pos + oo) if oo else 0

        def _i16(t, slot):
            oo = t.Offset(4 + slot * 2)
            return t.Get(_nt.Int16Flags, t.Pos + oo) if oo else 0

        out.append((_i64(etab, 0), _i64(etab, 1), _i16(etab, 2), _i16(etab, 3)))
    return out


# --------------------------------------------------------------------------
# Container write / read.


@dataclasses.dataclass
class Pod5Read:
    read_id: str
    signal: np.ndarray        # int16 raw DAC
    read_number: int = 0
    calibration_offset: float = 0.0
    calibration_scale: float = 1.0


def _read_id_bytes(rid: str) -> bytes:
    try:
        return uuid.UUID(rid).bytes
    except ValueError:
        # Non-UUID ids (test fixtures): deterministic UUID5.
        return uuid.uuid5(uuid.NAMESPACE_OID, rid).bytes


def write_pod5(path: str, reads: list[Pod5Read],
               chunk_size: int = DEFAULT_SIGNAL_CHUNK) -> None:
    _require()
    # --- signal table rows (chunked + vbz) ---
    sig_ids, sig_blobs, sig_samples = [], [], []
    read_rows: list[list[int]] = []
    for r in reads:
        rid = _read_id_bytes(r.read_id)
        rows = []
        sig = np.asarray(r.signal, np.int16)
        for start in range(0, max(len(sig), 1), chunk_size):
            part = sig[start:start + chunk_size]
            rows.append(len(sig_blobs))
            sig_ids.append(rid)
            sig_blobs.append(vbz_compress(part))
            sig_samples.append(len(part))
        read_rows.append(rows)
    signal_table = pa.table({
        "read_id": pa.array(sig_ids, pa.binary(16)),
        "signal": pa.array(sig_blobs, pa.large_binary()),
        "samples": pa.array(sig_samples, pa.uint32()),
    })
    reads_table = pa.table({
        "read_id": pa.array([_read_id_bytes(r.read_id) for r in reads],
                            pa.binary(16)),
        "read_id_str": pa.array([r.read_id for r in reads], pa.string()),
        "signal": pa.array(read_rows, pa.large_list(pa.uint64())),
        "read_number": pa.array([r.read_number for r in reads], pa.uint32()),
        "calibration_offset": pa.array(
            [r.calibration_offset for r in reads], pa.float32()),
        "calibration_scale": pa.array(
            [r.calibration_scale for r in reads], pa.float32()),
    })

    marker = uuid.uuid4().bytes
    contents = []
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(marker)
        for table, ctype in ((signal_table, CONTENT_SIGNAL_TABLE),
                             (reads_table, CONTENT_READS_TABLE)):
            start = f.tell()
            sink = pa.BufferOutputStream()
            with pa_ipc.new_file(sink, table.schema) as w:
                w.write_table(table)
            buf = sink.getvalue().to_pybytes()
            f.write(buf)
            contents.append((start, len(buf), FORMAT_FEATHER_V2, ctype))
            pad = (-f.tell()) % 8
            f.write(b"\0" * pad)
            f.write(marker)
        footer = _footer_bytes(str(uuid.UUID(bytes=marker)), "nanodecoder_tpu_torch",
                               contents)
        f.write(footer)
        f.write(struct.pack("<q", len(footer)))
        f.write(marker)
        f.write(SIGNATURE)


def read_pod5(path: str) -> list[Pod5Read]:
    _require()
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE or data[-8:] != SIGNATURE:
        raise ValueError(f"{path}: not a pod5 file (bad signature)")
    (footer_len,) = struct.unpack("<q", data[-32:-24])
    footer = data[-32 - footer_len:-32]
    tables: dict[int, pa.Table] = {}
    for off, ln, _fmt, ctype in _parse_footer(footer):
        if off < 0 or ln < 0 or off + ln > len(data):
            # Fail loudly: a silently truncated slice would hand Arrow
            # a partial buffer and could mis-parse.
            raise ValueError(
                f"{path}: footer entry [{off}, {off + ln}) exceeds file "
                f"size {len(data)} — corrupt or incompatible footer")
        reader = pa_ipc.open_file(pa.BufferReader(data[off:off + ln]))
        tables[ctype] = reader.read_all()
    if CONTENT_READS_TABLE not in tables or CONTENT_SIGNAL_TABLE not in tables:
        raise ValueError(f"{path}: footer lists no reads/signal table")
    rt = tables[CONTENT_READS_TABLE]
    st = tables[CONTENT_SIGNAL_TABLE]
    names = set(rt.column_names)
    sig_blobs = st.column("signal").to_pylist()
    sig_samples = st.column("samples").to_pylist()
    sig_is_binary = pa.types.is_large_binary(st.schema.field("signal").type) \
        or pa.types.is_binary(st.schema.field("signal").type)
    out = []
    for i in range(rt.num_rows):
        rows = rt.column("signal")[i].as_py()
        parts = []
        for ridx in rows:
            if sig_is_binary:
                parts.append(vbz_decompress(sig_blobs[ridx],
                                            int(sig_samples[ridx])))
            else:  # uncompressed list<int16> variant
                parts.append(np.asarray(sig_blobs[ridx], np.int16))
        sig = np.concatenate(parts) if parts else np.zeros(0, np.int16)
        if "read_id_str" in names:
            rid = rt.column("read_id_str")[i].as_py()
        else:
            rid = str(uuid.UUID(bytes=rt.column("read_id")[i].as_py()))
        out.append(Pod5Read(
            read_id=rid,
            signal=sig,
            read_number=(int(rt.column("read_number")[i].as_py())
                         if "read_number" in names else 0),
            calibration_offset=(float(rt.column("calibration_offset")[i].as_py())
                                if "calibration_offset" in names else 0.0),
            calibration_scale=(float(rt.column("calibration_scale")[i].as_py())
                               if "calibration_scale" in names else 1.0),
        ))
    return out
