"""The OCDBT key-value store of Orbax checkpoints, read and written with the
standard library and :mod:`scgrhc_torch.native.zstd`.

OCDBT ("optionally-cooperative distributed B+tree") is tensorstore's
on-disk key-value format; Orbax keeps a checkpoint's zarr arrays in one.
A store is a directory:

* ``manifest.ocdbt``: the config and the version list, whose last entry
  points at the B+tree root of the latest version;
* data files (``d/<hex>``, and in Orbax's multi-process layout
  ``ocdbt.process_0/d/<hex>``): B+tree nodes and out-of-line values
  packed end to end, each node self-delimiting.

A manifest or a node is ``magic (u32 big-endian) | length (u64, the whole
encoding) | version (varint 0) | compression (varint, 1 = zstd) | body |
crc32c (u32) of everything before it``.  Bodies are column-major: every
field of every entry, one field after another.  Integers are LEB128
varints.  A node's data-file table names the files its references point
into, as prefix-compressed ``base_path + relative_path`` strings, where a
base path is taken relative to that of the file that holds the node.
Keys are prefix-compressed within a node, and each interior entry says how
much of its key (``subtree_common_prefix_length``) every key under it
shares: the child stores its keys with that prefix cut off.

:func:`read` opens a store from its top-level manifest as tensorstore does
and follows the references (so Orbax's ``ocdbt.process_0/`` split needs
nothing special), checking every CRC.  :func:`write` writes one
single-process store: one manifest with one version, and one data file
holding the values and then one leaf, the B+tree's root, under the config
Orbax opens its stores with.
"""

from __future__ import annotations

import os
import struct
import time
import uuid as uuidlib

from scgrhc_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
COMPRESSION_NONE, COMPRESSION_ZSTD = 0, 1
MANIFEST_SINGLE = 0
_MISSING = (1 << 64) - 1  # offset and length of an empty version's root


# The config Orbax opens its stores with, which tensorstore requires an
# existing store to match; the writer uses it, the reader takes any.
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
ZSTD_LEVEL = 0


# ---- CRC-32C (Castagnoli), table-driven --------------------------------------

def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ---- decoding ------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.what}: truncated")

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.buf[self.pos - 1]

    def bytes(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.buf):
            raise ValueError(f"{self.what}: {len(self.buf) - self.pos} trailing bytes")


def _unframe(buf: bytes, magic: int, what: str) -> _Reader:
    """Check a manifest's or a node's magic, length and CRC; its body."""
    if len(buf) < 18:
        raise ValueError(f"{what}: {len(buf)} bytes is too short")
    (got_magic,) = struct.unpack_from(">I", buf, 0)
    (length,) = struct.unpack_from("<Q", buf, 4)
    if got_magic != magic:
        raise ValueError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(buf):
        raise ValueError(f"{what}: says {length} bytes, has {len(buf)}")
    (crc,) = struct.unpack_from("<I", buf, len(buf) - 4)
    if crc32c(buf[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch")
    r = _Reader(buf[:-4], what)
    r.pos = 12
    if r.varint() != FORMAT_VERSION:
        raise ValueError(f"{what}: unsupported format version")
    compression = r.varint()
    body = r.buf[r.pos:]
    if compression == COMPRESSION_ZSTD:
        body = zstd.decompress(body)
    elif compression != COMPRESSION_NONE:
        raise ValueError(f"{what}: unknown compression {compression}")
    return _Reader(body, what)


def _read_table(r: _Reader, transitive: str) -> list[tuple[str, str]]:
    """A data-file table: each file's ``(base path, path)`` under the
    store's root, both prefixed with ``transitive``, the base path of the
    file that holds the table."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: bad data-file table")
        full = prev[:prefix[i]] + r.bytes(suffix[i])
        if base_len[i] > len(full):
            raise ValueError(f"{r.what}: bad data-file table")
        files.append((transitive + full[:base_len[i]].decode(), transitive + full.decode()))
        prev = full
    return files


def _read_keys(r: _Reader, n: int, interior: bool):
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: bad key prefix")
        key = prev[:prefix[i]] + r.bytes(suffix[i])
        keys.append(key)
        prev = key
    return keys, common


class _Store:
    def __init__(self, root: str):
        self.root = root
        self._files: dict[str, bytes] = {}

    def file(self, rel: str) -> bytes:
        if rel not in self._files:
            if not rel or os.path.isabs(rel) or ".." in rel.split("/"):
                raise ValueError(f"bad data file path {rel!r}")
            with open(os.path.join(self.root, rel), "rb") as f:
                self._files[rel] = f.read()
        return self._files[rel]

    def slice(self, rel: str, offset: int, length: int) -> bytes:
        data = self.file(rel)
        if offset + length > len(data):
            raise ValueError(f"{rel}: [{offset}, {offset + length}) past its {len(data)} bytes")
        return data[offset:offset + length]

    def node(self, file: tuple[str, str], offset: int, length: int, height: int,
             prefix: bytes, out: dict) -> None:
        base, rel = file
        what = f"node {rel}@{offset}"
        r = _unframe(self.slice(rel, offset, length), NODE_MAGIC, what)
        if r.byte() != height:
            raise ValueError(f"{what}: height differs from its reference's")
        files = _read_table(r, base)
        n = r.varint()
        if n == 0:
            raise ValueError(f"{what}: empty node")
        keys, common = _read_keys(r, n, height > 0)
        if height > 0:
            file_id, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
            r.done()
            for i in range(n):
                self.node(files[file_id[i]], offsets[i], lengths[i], height - 1,
                          prefix + keys[i][:common[i]], out)
            return
        value_len = r.varints(n)
        kind = r.varints(n)
        indirect = [i for i in range(n) if kind[i] == 1]
        if any(k not in (0, 1) for k in kind):
            raise ValueError(f"{what}: unknown value kind")
        file_id = r.varints(len(indirect))
        offsets = r.varints(len(indirect))
        ref = dict(zip(indirect, zip(file_id, offsets)))
        for i in range(n):
            if i in ref:
                fid, off = ref[i]
                out[prefix + keys[i]] = self.slice(files[fid][1], off, value_len[i])
            else:
                out[prefix + keys[i]] = r.bytes(value_len[i])
        r.done()


def _read_config(r: _Reader) -> None:
    """Skip the manifest's config: nodes say their own compression."""
    r.bytes(16)  # uuid
    if r.varint() != MANIFEST_SINGLE:
        raise ValueError(f"{r.what}: only single-file manifests are supported")
    r.varint(), r.varint(), r.byte()  # inline value limit, node limit, version arity
    compression = r.varint()
    if compression == COMPRESSION_ZSTD:
        r.bytes(4)  # level
    elif compression != COMPRESSION_NONE:
        raise ValueError(f"{r.what}: unknown node compression {compression}")


def read(root: str) -> dict[bytes, bytes]:
    """Every key and value of the latest version of the store at ``root``."""
    store = _Store(root)
    with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
        r = _unframe(f.read(), MANIFEST_MAGIC, f"{root}/manifest.ocdbt")
    _read_config(r)
    files = _read_table(r, "")
    n = r.varint()
    if n == 0:
        return {}
    r.varints(n)  # generation numbers
    heights = [r.byte() for _ in range(n)]
    file_id, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    out: dict[bytes, bytes] = {}
    if offsets[-1] == _MISSING:  # the latest version is empty
        return out
    store.node(files[file_id[-1]], offsets[-1], lengths[-1], heights[-1], b"", out)
    return out


# ---- encoding ------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _frame(magic: int, body: bytes) -> bytes:
    body = zstd.compress(body, ZSTD_LEVEL)
    head = _varint(FORMAT_VERSION) + _varint(COMPRESSION_ZSTD)
    length = 4 + 8 + len(head) + len(body) + 4
    out = struct.pack(">I", magic) + struct.pack("<Q", length) + head + body
    return out + struct.pack("<I", crc32c(out))


def _table(paths: list[str]) -> bytes:
    """A data-file table of paths with empty base paths."""
    raw = [p.encode() for p in paths]
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(raw, raw[1:])]
    suffix = [r[p:] for r, p in zip(raw, [0] + prefix)]
    return (_varint(len(raw)) + _varints(prefix) + _varints(map(len, suffix))
            + _varints(0 for _ in raw) + b"".join(suffix))


def _keys(keys: list[bytes]) -> bytes:
    """A leaf's prefix-compressed key columns."""
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    suffix = [k[p:] for k, p in zip(keys, [0] + prefix)]
    return _varints(prefix) + _varints(map(len, suffix)) + b"".join(suffix)


def write(root: str, items: dict[bytes, bytes]) -> None:
    """Write ``items`` as a new single-version store at ``root`` (which must
    not hold one yet): one data file with the out-of-line values and then
    the one leaf that is the B+tree's root, then ``manifest.ocdbt``.  A
    checkpoint's leaf is tens of KB; one that would pass the node limit
    raises."""
    name = f"d/{uuidlib.uuid4().hex}"
    table = _table([name])
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    keys = sorted(items)
    data = bytearray()
    where: dict[bytes, int] = {}
    for k in keys:
        if len(items[k]) > MAX_INLINE_VALUE_BYTES:
            where[k] = len(data)
            data += items[k]
    indirect_bytes = len(data)
    root_ref = None
    if keys:
        ind = [k for k in keys if k in where]
        body = (bytes([0]) + table + _varint(len(keys)) + _keys(keys)
                + _varints(len(items[k]) for k in keys)
                + _varints(1 if k in where else 0 for k in keys)
                + _varints(0 for _ in ind) + _varints(where[k] for k in ind)
                + b"".join(items[k] for k in keys if k not in where))
        if len(body) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"{len(keys)} keys make a {len(body)}-byte leaf, past the "
                             f"{MAX_DECODED_NODE_BYTES}-byte node limit")
        node = _frame(NODE_MAGIC, body)
        root_ref = (len(data), len(node), len(keys))
        data += node
    with open(os.path.join(root, name), "wb") as f:
        f.write(data)

    body = bytearray(uuidlib.uuid4().bytes)
    body += (_varint(MANIFEST_SINGLE) + _varint(MAX_INLINE_VALUE_BYTES)
             + _varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2])
             + _varint(COMPRESSION_ZSTD) + struct.pack("<i", ZSTD_LEVEL))
    if root_ref is not None:
        offset, length, n_keys = root_ref
        body += table + _varint(1) + _varint(1) + bytes([0])  # generation 1, height 0
        body += _varints([0, offset, length, n_keys, length, indirect_bytes])
    else:  # an empty store: the version's root is the empty reference
        body += _table([""]) + _varint(1) + _varint(1) + bytes([0])
        body += _varints([0, _MISSING, _MISSING, 0, 0, 0])
    body += struct.pack("<Q", time.time_ns()) + _varint(0)  # no version tree nodes
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(_frame(MANIFEST_MAGIC, bytes(body)))
