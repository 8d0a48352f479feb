"""An HDF5 reader of the port's own, for the files the NYUv2 HDF5 datasets
read (``nyuv2_s2d``, ``nyuv2_r2r``): ``File(path)[name][:]``, the subset of
``h5py`` they use, and nothing more.

It reads what ``h5py`` writes by default (``libver='earliest'``):

- superblock version 0 (at offset 0, 512, 1024, ...), 8-byte offsets and
  lengths;
- version 1 object headers, with continuation messages;
- symbol-table groups: a version 1 B-tree of group nodes, the local heap of
  the names and the symbol-table nodes (``SNOD``); nested groups by
  ``a/b`` paths;
- dataspace version 1 (the current dimensions);
- fixed-point (signed or not) and IEEE float datatypes, either byte order;
- data layout version 3: contiguous data (a copy out of the file's memory
  map),
  and chunked data with a version 1 chunk B-tree and the deflate filter
  (``zlib``), edge chunks that run past the extent included.

Any other superblock, header version, layout, filter (shuffle, lzf,
fletcher32, ...) or datatype (strings, compounds, ...) raises
``ValueError``, naming the file and what it found.

``write_contiguous`` writes such a file: a root group holding contiguous
datasets, in the layout above, which ``h5py`` reads back.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from typing import Dict

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
MSG_DATASPACE, MSG_DATATYPE, MSG_FILL = 0x01, 0x03, 0x05
MSG_LAYOUT, MSG_FILTERS, MSG_CONTINUATION = 0x08, 0x0B, 0x10
MSG_SYMBOL_TABLE, MSG_LINK, MSG_LINK_INFO = 0x11, 0x06, 0x02
FILTER_DEFLATE = 1
FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                5: "nbit", 6: "scaleoffset", 32000: "lzf"}


class _Reader:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            # pages are read as the structures and data are reached
            self.buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self.base = self._find_superblock()

    def close(self):
        self.buf.close()

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what}")

    def at(self, addr: int, n: int) -> bytes:
        pos = self.base + addr
        if addr == UNDEF or pos + n > len(self.buf):
            self.fail(f"address {addr:#x} (+{n}) lies outside the file")
        return self.buf[pos:pos + n]

    def u(self, addr: int, n: int) -> int:
        return int.from_bytes(self.at(addr, n), "little")

    def _find_superblock(self) -> int:
        off = 0
        while off + 8 <= len(self.buf):
            if self.buf[off:off + 8] == SIGNATURE:
                break
            off = 512 if off == 0 else off * 2
        else:
            raise ValueError(f"{self.path}: no HDF5 signature")
        version = self.buf[off + 8]
        if version != 0:
            self.fail(f"superblock version {version}; this reader takes "
                      f"version 0 (h5py's libver='earliest')")
        so, sl = self.buf[off + 13], self.buf[off + 14]
        if (so, sl) != (8, 8):
            self.fail(f"offsets of {so} and lengths of {sl} bytes; this "
                      f"reader takes 8 and 8")
        # the base address; the root group's symbol table entry at 56
        self.root_header = int.from_bytes(self.buf[off + 64:off + 72],
                                          "little")
        return int.from_bytes(self.buf[off + 24:off + 32], "little")

    # ------------------------------------------------------ object headers
    def messages(self, addr: int):
        """[(type, flags, body)] of the v1 object header at ``addr``,
        continuation blocks followed."""
        version = self.at(addr, 1)[0]
        if version != 1:
            what = "OHDR (version 2)" if self.at(addr, 4) == b"OHDR" \
                else f"version {version}"
            self.fail(f"object header {what} at {addr:#x}; this reader "
                      f"takes version 1")
        count = self.u(addr + 2, 2)
        blocks = [(addr + 16, self.u(addr + 8, 4))]
        out = []
        while blocks and len(out) < count:
            pos, size = blocks.pop(0)
            end = pos + size
            while pos + 8 <= end and len(out) < count:
                mtype, msize = self.u(pos, 2), self.u(pos + 2, 2)
                flags = self.at(pos + 4, 1)[0]
                body = self.at(pos + 8, msize)
                if mtype == MSG_CONTINUATION:
                    blocks.append((int.from_bytes(body[:8], "little"),
                                   int.from_bytes(body[8:16], "little")))
                out.append((mtype, flags, body))
                pos += 8 + msize
        return out

    # --------------------------------------------------------------- groups
    def children(self, header: int) -> Dict[str, int]:
        """{name: object header address} of the symbol-table group whose
        header is at ``header``."""
        msgs = self.messages(header)
        st = [b for t, _, b in msgs if t == MSG_SYMBOL_TABLE]
        if not st:
            kinds = {t for t, _, _ in msgs}
            if kinds & {MSG_LINK, MSG_LINK_INFO}:
                self.fail(f"object at {header:#x} is a new-style (link "
                          f"message) group; this reader takes symbol-table "
                          f"groups")
            self.fail(f"object at {header:#x} is not a group")
        btree = int.from_bytes(st[0][:8], "little")
        heap = int.from_bytes(st[0][8:16], "little")
        if self.at(heap, 4) != b"HEAP":
            self.fail(f"no local heap at {heap:#x}")
        heap_data = self.u(heap + 24, 8)
        out = {}
        for snod in self._btree_leaves(btree, node_type=0):
            if self.at(snod, 4) != b"SNOD":
                self.fail(f"no symbol table node at {snod:#x}")
            for i in range(self.u(snod + 6, 2)):
                e = snod + 8 + 40 * i
                name_off, obj = self.u(e, 8), self.u(e + 8, 8)
                start = self.base + heap_data + name_off
                name = self.buf[start:self.buf.find(b"\0", start)]
                out[name.decode()] = obj
        return out

    def _btree_leaves(self, addr: int, node_type: int):
        """The child addresses of the level-0 nodes of the v1 B-tree at
        ``addr``, left to right, with their keys (chunk trees)."""
        if self.at(addr, 4) != b"TREE":
            self.fail(f"no v1 B-tree node at {addr:#x}")
        ntype, level = self.at(addr + 4, 1)[0], self.at(addr + 5, 1)[0]
        if ntype != node_type:
            self.fail(f"B-tree node type {ntype} at {addr:#x}, expected "
                      f"{node_type}")
        used = self.u(addr + 6, 2)
        key = 8 if node_type == 0 else self.key_size
        pos = addr + 24
        for _ in range(used):
            k, child = pos, self.u(pos + key, 8)
            pos += key + 8
            if level:
                yield from self._btree_leaves(child, node_type)
            elif node_type == 0:
                yield child
            else:
                yield k, child

    def lookup(self, name: str) -> int:
        header = self.root_header
        for part in [p for p in name.split("/") if p]:
            kids = self.children(header)
            if part not in kids:
                raise KeyError(f"{self.path}: no object {name!r}")
            header = kids[part]
        return header

    # ------------------------------------------------------------- datasets
    def dtype(self, body: bytes) -> np.dtype:
        cls, version = body[0] & 0x0F, body[0] >> 4
        bits, size = body[1], int.from_bytes(body[4:8], "little")
        order = ">" if bits & 1 else "<"
        if cls == 0 and size in (1, 2, 4, 8):
            kind = "i" if bits & 0x08 else "u"
            offset, prec = struct.unpack("<HH", body[8:12])
            if (offset, prec) == (0, 8 * size):
                return np.dtype(f"{order}{kind}{size}")
        elif cls == 1 and size in (2, 4, 8) and not bits & 0x40:
            offset, prec = struct.unpack("<HH", body[8:12])
            if (offset, prec) == (0, 8 * size):
                return np.dtype(f"{order}f{size}")
        names = {0: "fixed-point", 1: "floating-point", 2: "time",
                 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enumeration", 9: "variable-length",
                 10: "array"}
        self.fail(f"datatype class {cls} ({names.get(cls, '?')}, version "
                  f"{version}, {size} bytes); this reader takes fixed-point "
                  f"and IEEE floats")

    def shape(self, body: bytes):
        version, rank = body[0], body[1]
        if version != 1:
            self.fail(f"dataspace version {version}; this reader takes "
                      f"version 1")
        return tuple(int.from_bytes(body[8 + 8 * i:16 + 8 * i], "little")
                     for i in range(rank))

    def filters(self, body: bytes):
        version, n = body[0], body[1]
        if version != 1:
            self.fail(f"filter pipeline version {version}; this reader "
                      f"takes version 1")
        pos, ids = 8, []
        for _ in range(n):
            fid, name_len, _flags, nvals = struct.unpack(
                "<HHHH", body[pos:pos + 8])
            if fid != FILTER_DEFLATE:
                self.fail(f"filter {fid} "
                          f"({FILTER_NAMES.get(fid, 'unknown')}); this "
                          f"reader takes deflate only")
            ids.append(fid)
            pos += 8 + (name_len + 7) // 8 * 8 + 4 * nvals + 4 * (nvals % 2)
        return ids

    def read(self, header: int) -> np.ndarray:
        msgs = {}
        for t, flags, body in self.messages(header):
            if flags & 0x02 and t == MSG_DATATYPE:
                self.fail("a shared (committed) datatype; this reader "
                          "takes datatypes in the header")
            msgs.setdefault(t, body)
        if MSG_DATASPACE not in msgs or MSG_DATATYPE not in msgs \
                or MSG_LAYOUT not in msgs:
            self.fail(f"object at {header:#x} is not a dataset")
        dt = self.dtype(msgs[MSG_DATATYPE])
        shape = self.shape(msgs[MSG_DATASPACE])
        lay = msgs[MSG_LAYOUT]
        if lay[0] != 3:
            self.fail(f"data layout version {lay[0]}; this reader takes "
                      f"version 3")
        pipeline = self.filters(msgs[MSG_FILTERS]) \
            if MSG_FILTERS in msgs else []
        if lay[1] == 1:
            if pipeline:
                self.fail("filters on contiguous data")
            addr = int.from_bytes(lay[2:10], "little")
            size = int.from_bytes(lay[10:18], "little")
            n = int(np.prod(shape, dtype=np.int64))
            if addr == UNDEF:  # never written: the fill value, 0
                return np.zeros(shape, dt)
            if size != n * dt.itemsize:
                self.fail(f"contiguous data of {size} bytes for {shape} "
                          f"{dt}")
            view = np.frombuffer(self.buf, dt, count=n,
                                 offset=self.base + addr)
            out = view.reshape(shape).copy()
            del view  # the map closes only once no view holds it
            return out
        if lay[1] == 2:
            return self._chunked(lay, shape, dt, pipeline)
        kind = {0: "compact"}.get(lay[1], f"class {lay[1]}")
        self.fail(f"{kind} data layout; this reader takes contiguous and "
                  f"chunked")

    def _chunked(self, lay: bytes, shape, dt: np.dtype, pipeline):
        rank = lay[2] - 1
        btree = int.from_bytes(lay[3:11], "little")
        chunk = tuple(int.from_bytes(lay[11 + 4 * i:15 + 4 * i], "little")
                      for i in range(rank))
        if rank != len(shape):
            self.fail(f"chunks of rank {rank} for a rank {len(shape)} "
                      f"dataset")
        padded = tuple(-(-s // c) * c for s, c in zip(shape, chunk))
        out = np.zeros(padded, dt)
        if btree == UNDEF:
            return out[tuple(slice(0, s) for s in shape)]
        self.key_size = 8 + 8 * (rank + 1)
        nbytes = int(np.prod(chunk, dtype=np.int64)) * dt.itemsize
        for key, addr in self._btree_leaves(btree, node_type=1):
            size, mask = self.u(key, 4), self.u(key + 4, 4)
            start = tuple(self.u(key + 8 + 8 * i, 8) for i in range(rank))
            data = self.at(addr, size)
            for i in reversed(range(len(pipeline))):
                if not mask >> i & 1:
                    data = zlib.decompress(data)
            if len(data) != nbytes:
                self.fail(f"chunk at {start} holds {len(data)} bytes, "
                          f"expected {nbytes}")
            out[tuple(slice(s, s + c) for s, c in zip(start, chunk))] = \
                np.frombuffer(data, dt).reshape(chunk)
        return out[tuple(slice(0, s) for s in shape)]


class Dataset:
    def __init__(self, reader: _Reader, header: int):
        self._reader, self._header = reader, header

    def __getitem__(self, key) -> np.ndarray:
        if key != slice(None):
            raise ValueError("this reader takes [:] only")
        return self._reader.read(self._header)


class File:
    """``File(path)[name][:]``: the whole dataset ``name`` (a path through
    nested groups) as a numpy array in the file's byte order."""

    def __init__(self, path: str):
        self._reader = _Reader(path)

    def __getitem__(self, name: str) -> Dataset:
        return Dataset(self._reader, self._reader.lookup(name))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        self._reader.close()


# ------------------------------------------------------------------ writer
def _msg(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\0" * (-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _header(messages) -> bytes:
    data = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(data)) + data


def _datatype(dt: np.dtype) -> bytes:
    big = dt.byteorder == ">"
    if dt.kind in "iu":
        bits = int(big) | (0x08 if dt.kind == "i" else 0)
        return struct.pack("<B3BIHH", 0x10, bits, 0, 0, dt.itemsize, 0,
                           8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in (4, 8):
        exp, mant, bias = {4: (8, 23, 127), 8: (11, 52, 1023)}[dt.itemsize]
        sign = 8 * dt.itemsize - 1
        return struct.pack("<B3BIHHBBBBI", 0x11, int(big) | 0x20, sign, 0,
                           dt.itemsize, 0, 8 * dt.itemsize, mant, exp, 0,
                           mant, bias)
    raise ValueError(f"write_contiguous takes integer and f32/f64 arrays, "
                     f"got {dt}")


def write_contiguous(path: str, arrays: Dict[str, np.ndarray]):
    """Write ``arrays`` as contiguous datasets of the root group, in the
    subset ``File`` reads (superblock 0, v1 headers, a symbol-table root
    group of one node), which ``h5py`` reads back."""
    names = sorted(arrays)
    leaf_k, node_k = 4, 16
    if len(names) > 2 * leaf_k:
        raise ValueError(f"write_contiguous writes at most {2 * leaf_k} "
                         f"datasets, got {len(names)}")
    arrays = {n: np.ascontiguousarray(arrays[n]) for n in names}
    # the local heap: "" at 0, then each name, 8-byte aligned; no free list
    heap = bytearray(8)
    name_off = {}
    for n in names:
        name_off[n] = len(heap)
        heap += n.encode() + b"\0"
        heap += b"\0" * (-len(heap) % 8)

    def dataset_header(a, data_addr):
        return _header([
            _msg(MSG_DATASPACE, struct.pack("<BBB5x", 1, a.ndim, 0)
                 + b"".join(struct.pack("<Q", d) for d in a.shape)),
            _msg(MSG_DATATYPE, _datatype(a.dtype), flags=1),
            # fill value v2: allocated late, written if set, none defined
            _msg(MSG_FILL, struct.pack("<BBBB", 2, 2, 2, 0)),
            _msg(MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, data_addr,
                                         a.nbytes))])

    root_hdr = 96
    btree = root_hdr + len(_header([_msg(MSG_SYMBOL_TABLE, bytes(16))]))
    heap_hdr = btree + 24 + 2 * node_k * 8 + (2 * node_k + 1) * 8
    heap_data = heap_hdr + 32
    snod = heap_data + len(heap)
    addr = snod + 8 + 2 * leaf_k * 40
    headers = {}
    for n in names:
        headers[n] = addr
        addr += len(dataset_header(arrays[n], 0))
    data_addr = {}
    for n in names:
        addr += -addr % 8
        data_addr[n] = addr
        addr += arrays[n].nbytes
    eof = addr

    out = bytearray(eof)

    def put(at, b):
        out[at:at + len(b)] = b

    put(0, SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
        + struct.pack("<HHI", leaf_k, node_k, 0)
        + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
        # the root's symbol table entry, its cache holding B-tree and heap
        + struct.pack("<QQIIQQ", 0, root_hdr, 1, 0, btree, heap_hdr))
    put(root_hdr, _header([_msg(MSG_SYMBOL_TABLE,
                                struct.pack("<QQ", btree, heap_hdr))]))
    node = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1 if names else 0, UNDEF,
                                 UNDEF)
    if names:  # keys: "" and the last name, about the one SNOD
        node += struct.pack("<QQQ", 0, snod, name_off[names[-1]])
    put(btree, node)
    put(heap_hdr, b"HEAP" + bytes(4) + struct.pack("<QQQ", len(heap), 1,
                                                   heap_data))
    put(heap_data, bytes(heap))
    put(snod, b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + b"".join(
        struct.pack("<QQII16x", name_off[n], headers[n], 0, 0)
        for n in names))
    for n in names:
        put(headers[n], dataset_header(arrays[n], data_addr[n]))
        put(data_addr[n], arrays[n].tobytes())
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(out)
    os.replace(tmp, path)
