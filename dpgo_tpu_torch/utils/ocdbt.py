"""Reader of the OCDBT key-value store (tensorstore's "optionally
cooperative distributed B+tree"), as far as Orbax writes it from one
process: what ``StandardCheckpointer`` puts under a checkpoint's
``state/`` when ``use_ocdbt`` is on (orbax-checkpoint 0.11, tensorstore
0.1.80).  The standard library only (``utils.zstd`` for the
compressed nodes).

On disk (every integer a LEB128 varint unless its width is given):

* ``manifest.ocdbt`` and every B-tree node share one envelope: a 4-byte
  big-endian magic (``0x0cdb3a2a`` manifest, ``0x0cdb20de`` node), the
  u64 little-endian length of the whole file or node, a format version
  (0), a compression id (0 none, 1 zstd) and the body, compressed as the
  id says, then the CRC-32C (u32 little-endian) of every byte before it.
* The manifest's body: the config (16-byte UUID, manifest kind — only 0,
  a single manifest, is read —, max inline value bytes, max decoded node
  bytes, u8 version-tree arity log2, compression method and, for zstd, an
  i32 level), then the version tree's inline versions: a data-file
  table, the version count and, column by column, generation, u8 root
  height, root file id, offset, length, key count, tree bytes, indirect
  value bytes and u64 commit time.  The newest generation is read; older
  ones and the version-tree node references after them are not.
* A data-file table: file count, then the prefix length (shared with the
  previous path) of every path but the first, the suffix length and the
  base-path length of every path, then the suffixes.  A path is relative
  to the store's directory.
* A node's body: u8 height, a data-file table, the entry count, the keys
  (prefix lengths, suffix lengths, for an interior node each entry's
  subtree common-prefix length, then the suffixes).  A leaf then gives
  every value's length and kind (0 inline, 1 in a data file), the file id
  and offset of each indirect value, and the inline values.  An interior
  node gives each child's file id, offset and length, key count, tree
  bytes and indirect value bytes.  A node's keys are relative to the
  prefix its parent's entry passed down (that entry's key, cut to its
  common-prefix length, after the parent's own prefix).

Anything else — a wrong magic or length, a CRC mismatch, an unknown
format version or compression, a numbered manifest, a path outside the
store or into another process's tree — raises ``ValueError`` naming the
file.
"""

from __future__ import annotations

import os
import struct

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
NO_ROOT = (1 << 64) - 1

#: The one process tree a single-process Orbax save writes.
PROCESS_DIR = "ocdbt.process_"
OWN_PROCESS = "ocdbt.process_0"


def _crc_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT seals its files with."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Reads varints, fixed-width integers and bytes off a body."""

    def __init__(self, buf: bytes, name: str):
        self.buf, self.pos, self.name = buf, 0, name

    def fail(self, what: str):
        raise ValueError(f"{self.name}: {what}")

    def varint(self) -> int:
        v = shift = 0
        while True:
            if self.pos >= len(self.buf):
                self.fail("truncated varint")
            b = self.buf[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            self.fail("truncated body")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]


def _unseal(buf: bytes, magic: int, name: str) -> bytes:
    """The body of an OCDBT manifest or node, its envelope checked."""
    if len(buf) < 18:
        raise ValueError(f"{name}: {len(buf)} bytes is too short for OCDBT")
    (got,) = struct.unpack_from(">I", buf, 0)
    if got != magic:
        raise ValueError(f"{name}: magic {got:#010x}, expected {magic:#010x}")
    (length,) = struct.unpack_from("<Q", buf, 4)
    if length != len(buf):
        raise ValueError(f"{name}: length field {length} but {len(buf)} "
                         "bytes")
    (crc,) = struct.unpack_from("<I", buf, len(buf) - 4)
    if crc32c(buf[:-4]) != crc:
        raise ValueError(f"{name}: CRC-32C mismatch")
    cur = _Cursor(buf[:-4], name)
    cur.pos = 12
    version = cur.varint()
    if version != 0:
        cur.fail(f"unknown format version {version}")
    compression = cur.varint()
    body = buf[cur.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as e:
            cur.fail(f"zstd body: {e}")
    cur.fail(f"unknown compression id {compression}")


def _file_table(cur: _Cursor) -> list[str]:
    n = cur.varint()
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    cur.varints(n)                            # base-path lengths
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            cur.fail("data-file path prefix longer than the previous path")
        prev = prev[:p] + cur.take(s)
        paths.append(prev.decode())
    return paths


def _keys(cur: _Cursor, n: int, interior: bool) -> tuple[list[bytes], list]:
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else []
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            cur.fail("key prefix longer than the previous key")
        prev = prev[:p] + cur.take(s)
        keys.append(prev)
    return keys, common


class OcdbtStore:
    """The newest version of the OCDBT store in ``directory``, read-only:
    ``get(key)`` returns a value's bytes (``None`` for an absent key)."""

    def __init__(self, directory: str):
        self.root = os.path.abspath(directory)
        for entry in sorted(os.listdir(self.root)):
            if entry.startswith(PROCESS_DIR) and entry != OWN_PROCESS:
                raise ValueError(
                    f"{os.path.join(self.root, entry)}: a second process's "
                    "OCDBT tree; only single-process checkpoints are read")
        name = os.path.join(self.root, "manifest.ocdbt")
        with open(name, "rb") as f:
            cur = _Cursor(_unseal(f.read(), MANIFEST_MAGIC, name), name)
        cur.take(16)                          # UUID
        kind = cur.varint()
        if kind != 0:
            cur.fail(f"manifest kind {kind}; only a single manifest is read")
        cur.varint()                          # max inline value bytes
        cur.varint()                          # max decoded node bytes
        cur.u8()                              # version-tree arity log2
        if cur.varint() == 1:
            cur.take(4)                       # zstd level
        files = _file_table(cur)
        n = cur.varint()
        if n == 0:
            cur.fail("no version")
        gen = cur.varints(n)
        height = [cur.u8() for _ in range(n)]
        fid, off, length = cur.varints(n), cur.varints(n), cur.varints(n)
        newest = max(range(n), key=gen.__getitem__)
        self._root = None
        if off[newest] != NO_ROOT:
            self._root = (self._path(files, fid[newest], name),
                          off[newest], length[newest], height[newest])

    def _path(self, files: list[str], fid: int, where: str) -> str:
        if fid >= len(files):
            raise ValueError(f"{where}: data file id {fid} out of range")
        rel = files[fid]
        path = os.path.normpath(os.path.join(self.root, rel))
        if os.path.commonpath([self.root, path]) != self.root:
            raise ValueError(f"{where}: data file {rel!r} outside the store")
        top = rel.split("/", 1)[0]
        if top.startswith(PROCESS_DIR) and top != OWN_PROCESS:
            raise ValueError(f"{path}: a second process's OCDBT tree; only "
                             "single-process checkpoints are read")
        return path

    @staticmethod
    def _read(path: str, offset: int, length: int) -> bytes:
        with open(path, "rb") as f:
            f.seek(offset)
            buf = f.read(length)
        if len(buf) != length:
            raise ValueError(f"{path}: {length} bytes at {offset} run past "
                             "the end of the file")
        return buf

    def _node(self, path: str, offset: int, length: int, height: int):
        name = f"{path}@{offset}"
        cur = _Cursor(_unseal(self._read(path, offset, length), NODE_MAGIC,
                             name), name)
        if cur.u8() != height:
            cur.fail(f"node height differs from its reference's {height}")
        files = _file_table(cur)
        n = cur.varint()
        keys, common = _keys(cur, n, height > 0)
        if height == 0:
            lengths = cur.varints(n)
            kinds = cur.varints(n)
            if any(k > 1 for k in kinds):
                cur.fail("unknown value kind")
            out_of_line = [i for i in range(n) if kinds[i] == 1]
            fid = cur.varints(len(out_of_line))
            off = cur.varints(len(out_of_line))
            values: list = [None] * n
            for i, f, o in zip(out_of_line, fid, off):
                values[i] = (self._path(files, f, name), o, lengths[i])
            for i in range(n):
                if kinds[i] == 0:
                    values[i] = cur.take(lengths[i])
            return keys, values
        fid, off = cur.varints(n), cur.varints(n)
        length = cur.varints(n)
        children = [(self._path(files, fid[i], name), off[i], length[i],
                     common[i]) for i in range(n)]
        return keys, children

    def get(self, key: str) -> bytes | None:
        want = key.encode()
        ref, prefix = self._root, b""
        while ref is not None:
            path, offset, length, height = ref
            keys, entries = self._node(path, offset, length, height)
            if height == 0:
                for k, v in zip(keys, entries):
                    if prefix + k == want:
                        return v if isinstance(v, bytes) else self._read(*v)
                return None
            below = [i for i, k in enumerate(keys) if prefix + k <= want]
            if not below:
                return None
            cpath, coff, clen, common = entries[below[-1]]
            ref = (cpath, coff, clen, height - 1)
            prefix = prefix + keys[below[-1]][:common]
        return None
