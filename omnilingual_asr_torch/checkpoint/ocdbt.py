"""OCDBT, the key-value store under an Orbax checkpoint: a reader, and a
writer of single-version databases.

An OCDBT database is a directory with a ``manifest.ocdbt`` and data files
(``d/<id>``). The manifest holds the configuration and a version tree; each
version names the root of a B-tree whose leaves map keys to values. Every
manifest, B-tree node and version-tree node is framed the same way:

- a big-endian magic (:data:`MANIFEST_MAGIC`, :data:`BTREE_MAGIC`,
  :data:`VERSION_TREE_MAGIC`);
- the total length, u64 little-endian;
- a varint format version (0) and a varint compression method (0: none,
  1: zstd), then the body from byte 14;
- a u32 little-endian CRC-32C of every byte before it.

A node refers to others, and to values too large to inline, as (data file,
offset, length); data files hold those bytes concatenated, with no header,
and are named by a per-node table of prefix-compressed paths relative to
the database root. Keys are prefix-compressed within a node, and an
interior node's child stores its keys without the subtree's common prefix.

:class:`Store` reads any such database (any height of either tree; the
latest version); :func:`write_store` writes one leaf node and one data
file, uncompressed.
"""

from __future__ import annotations

import os
import struct
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_TREE_MAGIC = 0x0CDB1234
_HEADER = 12           # magic + length
_MISSING = (1 << 64) - 1   # offset and length of an empty tree's root
_MANIFEST = "manifest.ocdbt"
#: values longer than this go to the data file (Orbax's configuration)
MAX_INLINE_VALUE_BYTES = 1024
#: the largest decoded node the written configuration allows (Orbax's)
MAX_DECODED_NODE_BYTES = 100_000_000


class _Cursor:
    """Reads a node body; running off its end raises ValueError."""

    def __init__(self, data: bytes, what: str):
        self.b, self.p, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.p + n > len(self.b):
            raise ValueError(f"OCDBT {self.what}: truncated")
        v = self.b[self.p:self.p + n]
        self.p += n
        return v

    def byte(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        v = shift = 0
        while True:
            c = self.byte()
            v |= (c & 0x7F) << shift
            if not c & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError(f"OCDBT {self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.p != len(self.b):
            raise ValueError(f"OCDBT {self.what}: {len(self.b) - self.p} "
                             f"bytes after the end")


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


def decode_frame(data: bytes, magic: int, what: str) -> bytes:
    """Check a manifest or node's framing (magic, length, CRC-32C, format
    version) and return its body, decompressed."""
    if len(data) < _HEADER + 2 + 4:
        raise ValueError(f"OCDBT {what}: truncated ({len(data)} bytes)")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise ValueError(f"OCDBT {what}: bad magic {got:#010x}, expected "
                         f"{magic:#010x}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise ValueError(f"OCDBT {what}: length field {length}, "
                         f"{len(data)} bytes read")
    crc = struct.unpack("<I", data[-4:])[0]
    if zstd.crc32c(data[:-4]) != crc:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    c = _Cursor(data[:-4], what)
    c.p = _HEADER
    version, method = c.varint(), c.varint()
    if version != 0:
        raise ValueError(f"OCDBT {what}: format version {version}")
    body = data[c.p:-4]
    if method == 0:
        return body
    if method == 1:
        return zstd.decompress(body)
    raise ValueError(f"OCDBT {what}: compression method {method}")


def encode_frame(body: bytes, magic: int) -> bytes:
    """Frame a body uncompressed (method 0) with its length and CRC-32C."""
    head = bytes([0, 0])                      # format version, method
    length = _HEADER + len(head) + len(body) + 4
    data = struct.pack(">I", magic) + struct.pack("<Q", length) + head + body
    return data + struct.pack("<I", zstd.crc32c(data))


def _read_paths(c: _Cursor) -> List[str]:
    """A node's data-file table: full paths (base path + relative path)."""
    n = c.varint()
    if n == 0:
        return []
    prefix = [0] + c.varints(n - 1)
    suffix = c.varints(n)
    c.varints(n)                              # base path lengths
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {c.what}: bad data-file prefix")
        prev = prev[:prefix[i]] + c.take(suffix[i])
        out.append(prev.decode())
    return out


def _write_paths(paths: List[str]) -> bytes:
    enc = [p.encode() for p in paths]
    out = [_varint(len(enc))]
    prefix = [0]
    for a, b in zip(enc, enc[1:]):
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        prefix.append(k)
    out += [_varint(k) for k in prefix[1:]]
    out += [_varint(len(e) - k) for e, k in zip(enc, prefix)]
    out += [_varint(0) for _ in enc]          # base path lengths
    out += [e[k:] for e, k in zip(enc, prefix)]
    return b"".join(out)


def _read_keys(c: _Cursor, n: int, interior: bool):
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common = c.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {c.what}: bad key prefix")
        prev = prev[:prefix[i]] + c.take(suffix[i])
        keys.append(prev)
    return keys, common


@dataclass(frozen=True)
class Config:
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: int                 # 0 none, 1 zstd
    zstd_level: Optional[int]


@dataclass(frozen=True)
class Ref:
    """Bytes at (data file, offset, length) under the database root."""

    file: str
    offset: int
    length: int


@dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: Optional[Ref]              # None: the empty tree
    num_keys: int
    commit_time: int


def _read_config(c: _Cursor) -> Config:
    uuid = c.take(16)
    kind = c.varint()
    max_inline = c.varint()
    max_node = c.varint()
    arity = c.byte()
    method = c.varint()
    level = None
    if method == 1:
        level = struct.unpack("<i", c.take(4))[0]
    elif method != 0:
        raise ValueError(f"OCDBT manifest: compression method {method}")
    return Config(uuid, kind, max_inline, max_node, arity, method, level)


def _read_versions(c: _Cursor, n: int, files: List[str]) -> List[Version]:
    gen = c.varints(n)
    height = [c.byte() for _ in range(n)]
    fid, off, ln = c.varints(n), c.varints(n), c.varints(n)
    num_keys = c.varints(n)
    c.varints(n)                              # num_tree_bytes
    c.varints(n)                              # num_indirect_value_bytes
    commit = [c.u64() for _ in range(n)]
    out = []
    for i in range(n):
        root = None
        if ln[i] not in (0, _MISSING):
            if fid[i] >= len(files):
                raise ValueError(f"OCDBT {c.what}: data file {fid[i]} out "
                                 f"of range")
            root = Ref(files[fid[i]], off[i], ln[i])
        out.append(Version(gen[i], height[i], root, num_keys[i], commit[i]))
    return out


def _read_version_refs(c: _Cursor, n: int, files: List[str],
                       heights: Optional[List[int]] = None):
    gen = c.varints(n)
    fid, off, ln = c.varints(n), c.varints(n), c.varints(n)
    c.varints(n)                              # num_generations
    [c.u64() for _ in range(n)]               # commit times
    if heights is None:
        heights = [c.byte() for _ in range(n)]
    for i in range(n):
        if fid[i] >= len(files):
            raise ValueError(f"OCDBT {c.what}: data file {fid[i]} out of "
                             f"range")
    return [(gen[i], heights[i], Ref(files[fid[i]], off[i], ln[i]))
            for i in range(n)]


class Store:
    """A read-only OCDBT database at ``root`` (a directory), at its latest
    version. Keys are ``str`` (the bytes decoded as UTF-8)."""

    def __init__(self, root):
        self.root = Path(root)
        path = self.root / _MANIFEST
        data = path.read_bytes()
        c = _Cursor(decode_frame(data, MANIFEST_MAGIC, f"manifest {path}"),
                    f"manifest {path}")
        self.config = _read_config(c)
        if self.config.manifest_kind != 0:
            raise ValueError(f"OCDBT manifest {path}: manifest kind "
                             f"{self.config.manifest_kind} (only the "
                             f"single-file manifest is read)")
        files = _read_paths(c)
        self._inline = _read_versions(c, c.varint(), files)
        self._version_refs = _read_version_refs(c, c.varint(), files)
        c.done()
        self.version = self._latest()
        self._index: Optional[Dict[bytes, object]] = None

    # -- versions -------------------------------------------------------

    def _fetch(self, ref: Ref) -> bytes:
        with open(self.root / ref.file, "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise ValueError(f"OCDBT: {ref.file} is shorter than "
                             f"{ref.offset} + {ref.length}")
        return data

    def _version_node(self, ref: Ref, height: int):
        what = f"version node {ref.file}@{ref.offset}"
        c = _Cursor(decode_frame(self._fetch(ref), VERSION_TREE_MAGIC, what),
                    what)
        c.byte()                              # version_tree_arity_log2
        h = c.byte()
        if h != height:
            raise ValueError(f"OCDBT {what}: height {h}, expected {height}")
        files = _read_paths(c)
        n = c.varint()
        if h == 0:
            out = _read_versions(c, n, files)
        else:
            out = _read_version_refs(c, n, files, [h - 1] * n)
        c.done()
        return out

    def _latest(self) -> Version:
        """The newest version: the manifest's last inline one, else the
        last leaf entry down the version tree's rightmost path."""
        if self._inline:
            return self._inline[-1]
        if not self._version_refs:
            raise ValueError(f"OCDBT {self.root}: the manifest holds no "
                             f"version")
        _, height, ref = self._version_refs[-1]
        while True:
            entries = self._version_node(ref, height)
            if not entries:
                raise ValueError(f"OCDBT {self.root}: empty version node")
            if height == 0:
                return entries[-1]
            _, height, ref = entries[-1]

    # -- the B-tree -----------------------------------------------------

    def _btree_node(self, ref: Ref, height: int):
        what = f"B-tree node {ref.file}@{ref.offset}"
        c = _Cursor(decode_frame(self._fetch(ref), BTREE_MAGIC, what), what)
        h = c.byte()
        if h != height:
            raise ValueError(f"OCDBT {what}: height {h}, expected {height}")
        files = _read_paths(c)
        n = c.varint()
        keys, common = _read_keys(c, n, h > 0)

        def ref_at(fid, off, ln):
            if fid >= len(files):
                raise ValueError(f"OCDBT {what}: data file {fid} out of "
                                 f"range")
            return Ref(files[fid], off, ln)

        if h == 0:
            lengths, kinds = c.varints(n), c.varints(n)
            indirect = [i for i in range(n) if kinds[i] == 1]
            if any(k > 1 for k in kinds):
                raise ValueError(f"OCDBT {what}: unknown value kind")
            fid = c.varints(len(indirect))
            off = c.varints(len(indirect))
            values: List[object] = [None] * n
            for j, i in enumerate(indirect):
                values[i] = ref_at(fid[j], off[j], lengths[i])
            for i in range(n):
                if kinds[i] == 0:
                    values[i] = c.take(lengths[i])
            c.done()
            return keys, values
        fid, off, ln = c.varints(n), c.varints(n), c.varints(n)
        for _ in range(3):                    # keys, tree and value bytes
            c.varints(n)
        c.done()
        children = [(common[i], ref_at(fid[i], off[i], ln[i]))
                    for i in range(n)]
        return keys, children

    def _entries(self) -> Iterator[Tuple[bytes, object]]:
        v = self.version
        if v.root is None:
            return

        def walk(ref, height, prefix):
            keys, items = self._btree_node(ref, height)
            if height == 0:
                for k, val in zip(keys, items):
                    yield prefix + k, val
                return
            for k, (common, child) in zip(keys, items):
                yield from walk(child, height - 1, prefix + k[:common])

        yield from walk(v.root, v.root_height, b"")

    def _values(self) -> Dict[bytes, object]:
        if self._index is None:
            self._index = dict(self._entries())
        return self._index

    def list(self) -> List[str]:
        """Every key, sorted."""
        return sorted(k.decode() for k in self._values())

    def read(self, key: str) -> bytes:
        """The value of ``key`` (KeyError when absent)."""
        val = self._values().get(key.encode())
        if val is None:
            raise KeyError(key)
        return self._fetch(val) if isinstance(val, Ref) else val

    def get(self, key: str) -> Optional[bytes]:
        """The value of ``key``, None when absent."""
        try:
            return self.read(key)
        except KeyError:
            return None


def write_store(root, entries: Dict[str, bytes]) -> None:
    """Write a new OCDBT database of ``entries`` into the directory
    ``root``: one version whose B-tree is a single leaf node, values longer
    than :data:`MAX_INLINE_VALUE_BYTES` in one data file, nothing
    compressed. The configuration is the one Orbax writes its checkpoints
    with."""
    if not entries:
        raise ValueError("OCDBT: nothing to write")
    root = Path(root)
    (root / "d").mkdir(parents=True, exist_ok=True)
    keys = sorted(k.encode() for k in entries)
    values = [entries[k.decode()] for k in keys]
    data_name = "d/" + os.urandom(16).hex()
    node_name = "d/" + os.urandom(16).hex()

    offsets, chunks, at = {}, [], 0
    for i, v in enumerate(values):
        if len(v) > MAX_INLINE_VALUE_BYTES:
            offsets[i] = at
            chunks.append(v)
            at += len(v)
    indirect = sorted(offsets)
    if indirect:
        with open(root / data_name, "wb") as f:
            for v in chunks:
                f.write(v)

    body = [bytes([0]), _write_paths([data_name] if indirect else []),
            _varint(len(keys))]
    prefix = [0]
    for a, b in zip(keys, keys[1:]):
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        prefix.append(k)
    body += [_varint(k) for k in prefix[1:]]
    body += [_varint(len(key) - k) for key, k in zip(keys, prefix)]
    body += [key[k:] for key, k in zip(keys, prefix)]
    body += [_varint(len(v)) for v in values]
    body += [_varint(1 if i in offsets else 0) for i in range(len(keys))]
    body += [_varint(0) for _ in indirect]
    body += [_varint(offsets[i]) for i in indirect]
    body += [v for i, v in enumerate(values) if i not in offsets]
    node = encode_frame(b"".join(body), BTREE_MAGIC)
    with open(root / node_name, "wb") as f:
        f.write(node)

    manifest = b"".join([
        os.urandom(16),                       # uuid
        _varint(0),                           # single-file manifest
        _varint(MAX_INLINE_VALUE_BYTES), _varint(MAX_DECODED_NODE_BYTES),
        bytes([4]),                           # version_tree_arity_log2
        _varint(0),                           # no compression
        _write_paths([node_name]),
        _varint(1),                           # one inline version
        _varint(1), bytes([0]),               # generation 1, a leaf root
        _varint(0), _varint(0), _varint(len(node)),
        _varint(len(keys)), _varint(len(node)), _varint(at),
        struct.pack("<Q", time.time_ns()),
        _varint(0),                           # no version-tree nodes
    ])
    tmp = root / (_MANIFEST + ".tmp")
    tmp.write_bytes(encode_frame(manifest, MANIFEST_MAGIC))
    tmp.replace(root / _MANIFEST)
