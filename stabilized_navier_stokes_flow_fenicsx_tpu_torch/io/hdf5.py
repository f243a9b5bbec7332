"""A reader and writer for the subset of HDF5 that the solution files use.

The files are those that ``h5py`` writes by default (HDF5 1.8 to 1.14,
the earliest library version bound) for a few datasets in nested groups:

* superblock version 0, 8-byte offsets and lengths;
* version-1 object headers;
* symbol-table groups: a version-1 group B-tree (``TREE``) over symbol
  table nodes (``SNOD``), the names in a local heap (``HEAP``);
* contiguous, uncompressed, little-endian datasets of float64, float32,
  int64 and int32.

Anything else (chunked, compact or filtered layouts, later superblocks,
version-2 object headers and link messages, big-endian or
variable-length types) raises a ``ValueError`` that names the dataset
and the feature.  Numpy and ``struct`` only; the field layouts follow
the HDF5 File Format Specification, version 2.0 (sections II.A, III.A,
III.B, III.C, III.D, IV.A.1 and IV.A.2).

``Hdf5Writer`` appends each dataset's raw bytes at the end of the file;
``flush`` then appends a fresh copy of the metadata (every group and
dataset header) and rewrites the superblock's root entry and end-of-file
address in place, so the file is whole after every flush and a series
can grow one step at a time.  The space of the superseded metadata stays
in the file unused, a few hundred bytes a dataset.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF           # the undefined address
HEAP_FREE_NULL = 1                   # a local heap's "no free block"
LEAF_K, NODE_K = 4, 16               # group leaf / internal node K (defaults)
SUPERBLOCK_SIZE = 96
ENTRY_SIZE = 40                      # a symbol table entry
OH_PREFIX = 16                       # a version-1 object header's prefix

# message types of a version-1 object header
NIL, DATASPACE, DATATYPE, FILL_OLD, FILL, LAYOUT = 0x0, 0x1, 0x3, 0x4, 0x5, 0x8
CONTINUATION, SYMBOL_TABLE = 0x10, 0x11
# messages that do not bear on reading the raw data
_IGNORED = {NIL, FILL_OLD, FILL, 0x0C, 0x0D, 0x0E, 0x12, 0x15, 0x16}
_REFUSED = {0x02: "a new-style group (link info message)",
            0x06: "a new-style group (link message)",
            0x0A: "a new-style group (group info message)",
            0x07: "external storage",
            0x0B: "a filter pipeline (compressed or filtered data)"}

# float (class 1) properties: offset, precision, exponent location and
# size, mantissa location and size, exponent bias; sign bit in the flags
_FLOAT_PROPS = {4: (0, 32, 23, 8, 0, 23, 127), 8: (0, 64, 52, 11, 0, 52, 1023)}
_KINDS = {("f", 4), ("f", 8), ("i", 4), ("i", 8)}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _le_dtype(name: str, a: np.ndarray) -> np.dtype:
    dt = a.dtype
    if (dt.kind, dt.itemsize) not in _KINDS:
        raise ValueError(f"{name}: dtype {dt} is not one of float64, "
                         f"float32, int64, int32")
    return dt.newbyteorder("<")


def _msg(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\0" * (_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(msgs: List[bytes]) -> bytes:
    data = b"".join(msgs)
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(data)) + data


def _dataset_header(dt: np.dtype, shape, addr: int, nbytes: int) -> bytes:
    rank = len(shape)
    space = struct.pack(f"<BBB5x{2 * rank}Q", 1, rank, 1, *shape, *shape)
    if dt.kind == "f":
        sign = 8 * dt.itemsize - 1
        dtype = struct.pack("<BBBBI", 0x11, 0x20, sign, 0, dt.itemsize) + \
            struct.pack("<HHBBBBI", *_FLOAT_PROPS[dt.itemsize])
    else:
        dtype = struct.pack("<BBBBIHH", 0x10, 0x08, 0, 0, dt.itemsize, 0,
                            8 * dt.itemsize)
    # fill value v2: allocation late, written if set, default value
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)
    layout = struct.pack("<BBQQ", 3, 1, addr, nbytes)
    return _object_header([_msg(DATASPACE, space), _msg(DATATYPE, dtype, 1),
                           _msg(FILL, fill, 1), _msg(LAYOUT, layout)])


class _Meta:
    """The metadata block being laid out from ``base`` on."""

    def __init__(self, base: int):
        self.base = base
        self.buf = bytearray()

    def alloc(self, n: int) -> int:
        addr = self.base + len(self.buf)
        self.buf += b"\0" * _pad8(n)
        return addr

    def put(self, addr: int, data: bytes) -> None:
        off = addr - self.base
        self.buf[off:off + len(data)] = data

    def add(self, data: bytes) -> int:
        addr = self.alloc(len(data))
        self.put(addr, data)
        return addr


def _emit_group(meta: _Meta, tree: dict):
    """Lay out one group and, first, everything below it.  Returns its
    (object header, B-tree, local heap) addresses."""
    names = sorted(tree, key=lambda s: s.encode())   # strcmp order
    entries = []
    for name in names:
        node = tree[name]
        if isinstance(node, dict):
            oh, bt, hp = _emit_group(meta, node)
            entries.append((oh, 1, struct.pack("<QQ", bt, hp)))
        else:
            entries.append((meta.add(_dataset_header(*node)), 0, b"\0" * 16))

    heap = bytearray(8)                              # offset 0: ""
    offsets = []
    for name in names:
        offsets.append(len(heap))
        raw = name.encode() + b"\0"
        heap += raw + b"\0" * (_pad8(len(raw)) - len(raw))
    heap_addr = meta.alloc(32 + len(heap))
    meta.put(heap_addr, b"HEAP\0\0\0\0" + struct.pack(
        "<QQQ", len(heap), HEAP_FREE_NULL, heap_addr + 32) + bytes(heap))

    # symbol table nodes, 2 * LEAF_K entries each, allocated at full size
    per = 2 * LEAF_K
    level = []                       # (address, key of its last name)
    for i in range(0, len(names), per):
        chunk = range(i, min(i + per, len(names)))
        addr = meta.alloc(8 + per * ENTRY_SIZE)
        meta.put(addr, b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk)) +
                 b"".join(struct.pack("<QQII", offsets[j], entries[j][0],
                                      entries[j][1], 0) + entries[j][2]
                          for j in chunk))
        level.append((addr, offsets[chunk[-1]]))

    # B-tree nodes, 2 * NODE_K children each, level by level up to one
    # root; key i + 1 is the last name under child i, key 0 the last name
    # before the node (the empty string at the left edge)
    per = 2 * NODE_K
    size = 24 + per * 8 + (per + 1) * 8
    depth = 0
    while True:
        groups = [level[i:i + per] for i in range(0, len(level), per)] or [[]]
        addrs = [meta.alloc(size) for _ in groups]
        up, key0 = [], 0
        for k, kids in enumerate(groups):
            left = addrs[k - 1] if k else UNDEF
            right = addrs[k + 1] if k + 1 < len(addrs) else UNDEF
            body = struct.pack("<Q", key0)
            for child, last in kids:
                body += struct.pack("<QQ", child, last)
                key0 = last
            meta.put(addrs[k], b"TREE" + struct.pack(
                "<BBHQQ", 0, depth, len(kids), left, right) + body)
            up.append((addrs[k], key0))
        if len(up) == 1:
            btree = up[0][0]
            break
        level, depth = up, depth + 1
    sym = struct.pack("<QQ", btree, heap_addr)
    return meta.add(_object_header([_msg(SYMBOL_TABLE, sym)])), btree, \
        heap_addr


def _superblock(eof: int, root) -> bytes:
    oh, bt, hp = root
    return SIGNATURE + struct.pack(
        "<8BHHI4Q", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, NODE_K, 0,
        0, UNDEF, eof, UNDEF) + struct.pack("<QQII QQ", 0, oh, 1, 0, bt, hp)


class Hdf5Writer:
    """An HDF5 file written dataset by dataset.

    ``write(name, array)`` appends the raw bytes; ``flush()`` makes the
    file whole (metadata, then the superblock); ``close()`` flushes."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(b"\0" * SUPERBLOCK_SIZE)
        self._tree: dict = {}
        self._eof = SUPERBLOCK_SIZE
        self._dirty = True

    def write(self, name: str, array) -> None:
        a = np.asarray(array)
        dt = _le_dtype(name, a)
        parts = name.strip("/").split("/")
        if not all(parts):
            raise ValueError(f"{name!r}: empty path component")
        node = self._tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"{name}: {p!r} is a dataset, not a group")
        if parts[-1] in node:
            raise ValueError(f"{name}: already written")
        a = np.ascontiguousarray(a, dtype=dt)
        addr = self._eof
        self._f.seek(addr)
        self._f.write(a.tobytes())
        node[parts[-1]] = (dt, a.shape, addr, a.nbytes)
        self._eof = _pad8(addr + a.nbytes)
        self._dirty = True

    def flush(self) -> None:
        meta = _Meta(self._eof)
        root = _emit_group(meta, self._tree)
        self._f.seek(self._eof)
        self._f.write(meta.buf)
        self._eof += len(meta.buf)
        self._f.seek(0)
        self._f.write(_superblock(self._eof, root))
        self._f.flush()
        self._dirty = False

    def close(self) -> None:
        if self._f.closed:
            return
        try:
            if self._dirty:
                self.flush()
        finally:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_hdf5(path: str, datasets: Dict[str, np.ndarray]) -> None:
    """Write ``{"group/.../name": array}`` as one file."""
    with Hdf5Writer(path) as w:
        for name, a in datasets.items():
            w.write(name, a)


class Hdf5Reader:
    """Datasets and group listings of one file, by path."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._groups: dict = {}
        try:
            self._size = self._f.seek(0, 2)
            sb = self._at(0, SUPERBLOCK_SIZE)
            if sb[:8] != SIGNATURE:
                raise ValueError(f"{path}: no HDF5 signature at offset 0")
            if sb[8] != 0:
                raise ValueError(f"{path}: superblock version {sb[8]} "
                                 f"(only version 0 is read)")
            if sb[13:15] != b"\x08\x08":
                raise ValueError(f"{path}: offsets and lengths of "
                                 f"{sb[13]} and {sb[14]} bytes (only 8)")
            self.leaf_k, self.node_k = struct.unpack_from("<HH", sb, 16)
            base, _, eof = struct.unpack_from("<QQQ", sb, 24)
            if base != 0:
                raise ValueError(f"{path}: base address {base} (a user "
                                 f"block)")
            if eof > self._size:
                raise ValueError(f"{path}: truncated ({self._size} bytes, "
                                 f"end-of-file address {eof})")
            self._root = struct.unpack_from("<Q", sb, 64)[0]
        except BaseException:
            self._f.close()
            raise

    def _at(self, addr: int, n: int) -> bytes:
        if addr + n > self._size:
            raise ValueError(f"{self.path}: address {addr} + {n} bytes "
                             f"beyond the end of the file")
        self._f.seek(addr)
        return self._f.read(n)

    def _messages(self, addr: int, what: str) -> list:
        head = self._at(addr, OH_PREFIX)
        if head[:4] == b"OHDR":
            raise ValueError(f"{what}: a version-2 object header")
        ver, _, n, _, size = struct.unpack_from("<BBHII", head)
        if ver != 1:
            raise ValueError(f"{what}: object header version {ver}")
        chunks, msgs = [(addr + OH_PREFIX, size)], []
        while chunks and len(msgs) < n:
            start, size = chunks.pop(0)
            data, p = self._at(start, size), 0
            while p + 8 <= size and len(msgs) < n:
                mtype, msize = struct.unpack_from("<HH", data, p)
                body = data[p + 8:p + 8 + msize]
                if mtype == CONTINUATION:
                    chunks.append(struct.unpack_from("<QQ", body))
                msgs.append((mtype, body))
                p += 8 + msize
        return msgs

    def _group(self, addr: int, what: str) -> Dict[str, int]:
        """{name: object header address} of the group at ``addr``."""
        if addr in self._groups:
            return self._groups[addr]
        sym = [b for t, b in self._messages(addr, what) if t == SYMBOL_TABLE]
        if not sym:
            raise ValueError(f"{what}: not a symbol-table group")
        btree, heap = struct.unpack_from("<QQ", sym[0])
        hh = self._at(heap, 32)
        if hh[:4] != b"HEAP":
            raise ValueError(f"{what}: no local heap at {heap}")
        hsize, _, hdata = struct.unpack_from("<QQQ", hh, 8)
        names = self._at(hdata, hsize)
        out: Dict[str, int] = {}
        self._walk(btree, names, out, what)
        self._groups[addr] = out
        return out

    def _walk(self, addr: int, names: bytes, out: dict, what: str) -> None:
        head = self._at(addr, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            raise ValueError(f"{what}: no group B-tree node at {addr}")
        level, n = head[5], struct.unpack_from("<H", head, 6)[0]
        if n > 2 * self.node_k:
            raise ValueError(f"{what}: B-tree node of {n} children, more "
                             f"than 2K = {2 * self.node_k}")
        body = self._at(addr + 24, 16 * n + 8)
        for i in range(n):
            child = struct.unpack_from("<Q", body, 16 * i + 8)[0]
            if level:
                self._walk(child, names, out, what)
                continue
            node = self._at(child, 8)
            k = struct.unpack_from("<H", node, 6)[0]
            if node[:4] != b"SNOD" or k > 2 * self.leaf_k:
                raise ValueError(f"{what}: bad symbol table node at {child}")
            ents = self._at(child + 8, ENTRY_SIZE * k)
            for j in range(k):
                off, oh = struct.unpack_from("<QQ", ents, ENTRY_SIZE * j)
                name = names[off:names.index(b"\0", off)].decode()
                out[name] = oh

    def _lookup(self, path: str) -> int:
        addr, where = self._root, ""
        for part in (p for p in path.split("/") if p):
            group = self._group(addr, where or "/")
            if part not in group:
                raise KeyError(f"{self.path}: no {path!r}")
            addr, where = group[part], f"{where}/{part}"
        return addr

    def keys(self, group: str = "/") -> List[str]:
        """The names in ``group``, in the file's (strcmp) order."""
        return list(self._group(self._lookup(group), group))

    def read(self, name: str) -> np.ndarray:
        shape = dt = layout = None
        for mtype, body in self._messages(self._lookup(name), name):
            if mtype == DATASPACE:
                shape = _dataspace(body, name)
            elif mtype == DATATYPE:
                dt = _datatype(body, name)
            elif mtype == LAYOUT:
                layout = _layout(body, name)
            elif mtype == SYMBOL_TABLE:
                raise ValueError(f"{name}: a group, not a dataset")
            elif mtype in _REFUSED:
                raise ValueError(f"{name}: {_REFUSED[mtype]}")
            elif mtype not in _IGNORED and mtype != CONTINUATION:
                raise ValueError(f"{name}: object header message type "
                                 f"{mtype:#x}")
        if shape is None or dt is None or layout is None:
            raise ValueError(f"{name}: no dataspace, datatype or layout")
        addr, nbytes = layout
        count = int(np.prod(shape, dtype=np.int64))
        if nbytes != count * dt.itemsize:
            raise ValueError(f"{name}: {nbytes} bytes stored for {shape} "
                             f"of {dt}")
        if count == 0:
            return np.zeros(shape, dt)
        if addr == UNDEF:
            raise ValueError(f"{name}: no storage allocated")
        if addr + nbytes > self._size:
            raise ValueError(f"{name}: data beyond the end of the file")
        self._f.seek(addr)
        return np.fromfile(self._f, dt, count).reshape(shape)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _dataspace(b: bytes, name: str) -> tuple:
    ver, rank = b[0], b[1]
    if ver != 1:
        raise ValueError(f"{name}: dataspace message version {ver}")
    return struct.unpack_from(f"<{rank}Q", b, 8)


def _datatype(b: bytes, name: str) -> np.dtype:
    cls, f0, f1 = b[0] & 0x0F, b[1], b[2]
    size = struct.unpack_from("<I", b, 4)[0]
    if cls not in (0, 1):
        what = {3: "a string", 6: "a compound", 9: "a variable-length"}
        raise ValueError(f"{name}: {what.get(cls, f'a class-{cls}')} "
                         f"datatype")
    if f0 & 0x01 or (cls == 1 and f0 & 0x40):
        raise ValueError(f"{name}: big-endian data")
    if cls == 0:
        if not f0 & 0x08:
            raise ValueError(f"{name}: unsigned integers")
        offset, prec = struct.unpack_from("<HH", b, 8)
        kind = "i"
        ok = offset == 0 and prec == 8 * size
    else:
        props = struct.unpack_from("<HHBBBBI", b, 8)
        kind = "f"
        ok = props == _FLOAT_PROPS.get(size) and f1 == 8 * size - 1
    if (kind, size) not in _KINDS or not ok:
        raise ValueError(f"{name}: a {size}-byte class-{cls} datatype other "
                         f"than float64, float32, int64, int32")
    return np.dtype(f"<{kind}{size}")


def _layout(b: bytes, name: str) -> tuple:
    ver, cls = b[0], b[1]
    if ver not in (3, 4):
        raise ValueError(f"{name}: layout message version {ver}")
    if cls != 1:
        what = {0: "compact", 2: "chunked", 3: "virtual"}
        raise ValueError(f"{name}: {what.get(cls, f'class-{cls}')} layout "
                         f"(only contiguous is read)")
    return struct.unpack_from("<QQ", b, 2)
