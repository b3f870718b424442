"""A read-only OCDBT key-value store: the on-disk format TensorStore gives
the JAX package's orbax checkpoints (`<step>/default/`).

    store = OcdbtStore("ckpts/3/default")
    store.keys()                        # sorted keys, e.g. "step/.zarray"
    store.read("step/0")                # the value's bytes

The format is TensorStore's "OCDBT storage format":

- `manifest.ocdbt` holds the database's config, a table of data files and
  the version tree; the newest version (highest generation) names the
  root of its B+tree by (data file, offset, length).  (TensorStore's
  other manifest kind, "numbered", which orbax does not write, raises.)
- A B+tree node (interior or leaf) holds a data-file table of its own and
  columnar entries: varint key-prefix lengths shared with the previous
  key, suffix lengths and suffix bytes; an interior node adds, per child,
  the length of the prefix common to all of the child's keys (stripped
  from the keys stored in the child) and the child's location; a leaf
  adds per value its length and whether it is inline or a reference
  (data file, offset) into a data file.
- A data file is named by a base path and a relative path below the
  store's directory.  A node's table is read relative to the base path
  of the file that holds the node, so a root written by a multi-process
  save (`default/d/...`) reaches each process's files
  (`default/ocdbt.process_<n>/d/...`).
- Every manifest and node starts with a magic number (0x0cdb3a2a,
  0x0cdb20de, big-endian), its whole length (u64, little-endian), a
  format version (varint, 0) and its compression (varint: 0 none, 1
  zstd over the rest), and ends with the CRC32C of everything before it.
  Each is checked; a corrupted byte raises `OcdbtError`.

Zstandard and CRC32C run in the native library (`native.zstd`), which
has no fallback.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

from nanodecoder_tpu_torch.native import zstd

MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_OFFSET = (1 << 64) - 1  # the location of an empty tree's root


class OcdbtError(ValueError):
    """An OCDBT file that is not well formed."""


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.data):
                raise OcdbtError(f"{self.what}: truncated varint")
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint over 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.raw(1)[0]


class _DataFile(NamedTuple):
    base: str      # base path, with the transitive base of the file that named it
    relative: str


class _Ref(NamedTuple):
    file: _DataFile
    offset: int
    length: int


def _decode_file(buf: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node: magic, length and CRC32C checked,
    decompressed."""
    if len(buf) < 16:
        raise OcdbtError(f"{what}: {len(buf)} bytes is too short")
    (got_magic,) = struct.unpack(">I", buf[:4])
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic 0x{got_magic:08x}, want 0x{magic:08x}")
    (length,) = struct.unpack("<Q", buf[4:12])
    if length != len(buf):
        raise OcdbtError(f"{what}: header length {length}, file {len(buf)} bytes")
    (crc,) = struct.unpack("<I", buf[-4:])
    if zstd.crc32c(buf[:-4]) != crc:
        raise OcdbtError(f"{what}: CRC32C mismatch")
    r = _Reader(buf[:-4], what)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = buf[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise OcdbtError(f"{what}: compression format {compression}")


def _prefixed(r: _Reader, n: int, prefix_lengths: list[int], suffix_lengths: list[int]
              ) -> list[bytes]:
    out, prev = [], b""
    for i in range(n):
        if prefix_lengths[i] > len(prev):
            raise OcdbtError(f"{r.what}: key prefix longer than the previous key")
        prev = prev[:prefix_lengths[i]] + r.raw(suffix_lengths[i])
        out.append(prev)
    return out


def _data_file_table(r: _Reader, transitive: str) -> list[_DataFile]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    files = []
    for path, b in zip(_prefixed(r, n, prefix, suffix), base_len):
        if b > len(path):
            raise OcdbtError(f"{r.what}: base path longer than the path")
        text = path.decode()
        files.append(_DataFile(transitive + text[:b], text[b:]))
    return files


class OcdbtStore:
    """Read-only view of the newest version of the OCDBT database at
    `path` (the directory that holds `manifest.ocdbt`)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._files: dict[str, bytes] = {}
        manifest = self._manifest()
        self._index: dict[bytes, bytes | _Ref] = {}
        if manifest is not None:
            root, height = manifest
            self._walk(root, height, b"")

    # -- files ---------------------------------------------------------------

    def _file(self, df: _DataFile) -> bytes:
        rel = df.base + df.relative
        full = os.path.normpath(os.path.join(self.path, rel))
        if os.path.isabs(rel) or not full.startswith(self.path + os.sep):
            raise OcdbtError(f"data file {rel!r} lies outside {self.path}")
        if full not in self._files:
            with open(full, "rb") as f:
                self._files[full] = f.read()
        return self._files[full]

    def _slice(self, ref: _Ref, what: str) -> bytes:
        data = self._file(ref.file)
        if ref.offset + ref.length > len(data):
            raise OcdbtError(f"{what}: bytes {ref.offset}..{ref.offset + ref.length} lie "
                             f"past the end of {ref.file.base + ref.file.relative} "
                             f"({len(data)} bytes)")
        return data[ref.offset:ref.offset + ref.length]

    # -- manifest --------------------------------------------------------------

    def _manifest(self) -> tuple[_Ref, int] | None:
        """(root location, root height) of the newest version; None when the
        database is empty."""
        path = os.path.join(self.path, MANIFEST)
        with open(path, "rb") as f:
            r = _Reader(_decode_file(f.read(), MANIFEST_MAGIC, path), path)
        kind = self._config(r)
        if kind != 0:  # 1, "numbered": versions in manifest.<n> files
            raise OcdbtError(f"{path}: manifest kind {kind}; only single-file manifests "
                             "(what orbax writes) are read")
        files = _data_file_table(r, "")
        n = r.varint()
        generation = r.varints(n)
        height = list(r.raw(n))
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)
        if n == 0:
            return None
        newest = max(range(n), key=generation.__getitem__)
        if num_keys[newest] == 0 or offset[newest] == _NO_OFFSET:
            return None
        if file_id[newest] >= len(files):
            raise OcdbtError(f"{path}: data file {file_id[newest]} of {len(files)}")
        return _Ref(files[file_id[newest]], offset[newest], length[newest]), height[newest]

    @staticmethod
    def _config(r: _Reader) -> int:
        r.raw(16)  # uuid
        kind = r.varint()
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()    # version_tree_arity_log2
        method = r.varint()
        if method == 1:
            r.raw(4)  # zstd level (int32)
        elif method != 0:
            raise OcdbtError(f"{r.what}: compression method {method}")
        return kind

    # -- B+tree ----------------------------------------------------------------

    def _walk(self, ref: _Ref, height: int, prefix: bytes) -> None:
        what = f"{ref.file.base + ref.file.relative}@{ref.offset}"
        r = _Reader(_decode_file(self._slice(ref, what), NODE_MAGIC, what), what)
        got = r.byte()
        if got != height:
            raise OcdbtError(f"{what}: node height {got}, its parent says {height}")
        files = _data_file_table(r, ref.file.base)
        n = r.varint()
        prefix_len = [0] + r.varints(n - 1) if n else []
        suffix_len = r.varints(n)
        if height > 0:
            common = r.varints(n)
            keys = _prefixed(r, n, prefix_len, suffix_len)
            file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
            for i in range(n):
                if file_id[i] >= len(files) or common[i] > len(keys[i]):
                    raise OcdbtError(f"{what}: child {i} is malformed")
                self._walk(_Ref(files[file_id[i]], offset[i], length[i]), height - 1,
                           prefix + keys[i][:common[i]])
            return
        keys = _prefixed(r, n, prefix_len, suffix_len)
        value_len = r.varints(n)
        kind = r.varints(n)
        indirect = [i for i in range(n) if kind[i] == 1]
        if any(k not in (0, 1) for k in kind):
            raise OcdbtError(f"{what}: unknown value kind")
        file_id = r.varints(len(indirect))
        offset = r.varints(len(indirect))
        for i, fid, off in zip(indirect, file_id, offset):
            if fid >= len(files):
                raise OcdbtError(f"{what}: data file {fid} of {len(files)}")
            self._index[prefix + keys[i]] = _Ref(files[fid], off, value_len[i])
        for i in range(n):
            if kind[i] == 0:
                self._index[prefix + keys[i]] = r.raw(value_len[i])
        if r.pos != len(r.data):
            raise OcdbtError(f"{what}: {len(r.data) - r.pos} bytes left over")

    # -- public ----------------------------------------------------------------

    def keys(self) -> list[str]:
        """Every key of the newest version, sorted."""
        return sorted(k.decode() for k in self._index)

    def __contains__(self, key: str | bytes) -> bool:
        return (key.encode() if isinstance(key, str) else key) in self._index

    def read(self, key: str | bytes) -> bytes:
        """The value stored under `key`; KeyError where there is none."""
        k = key.encode() if isinstance(key, str) else key
        value = self._index[k]
        if isinstance(value, bytes):
            return value
        return self._slice(value, f"value of {k.decode(errors='replace')!r}")
