"""Minimal pure-Python read-only LMDB reader (a copy of
gagan_tpu/data/lmdb_reader.py, which imports nothing of JAX).

Replaces the `lmdb` package dependency of the reference's LSUN ingestion
path (`DissimilarDomains/dataset_tool.py:117-141`), which is not available
in this environment.  Implements just enough of the LMDB 0.9.x on-disk
format (little-endian, 64-bit) to iterate all key/value pairs of the main
database in key order: meta-page selection by txnid, B+tree walk over
branch/leaf pages, and big-value overflow pages.  Not supported (raises):
MDB_DUPSORT sub-databases and MDB_DUPFIXED LEAF2 pages — LSUN exports use
neither.

Format reference: the public LMDB source (mdb.c / lmdb.h) struct layouts:
  MDB_page   { pgno u64; pad u16; flags u16; lower u16; upper u16; ... }
  MDB_meta   { magic u32; version u32; address ptr; mapsize u64;
               MDB_db dbs[2]; last_pg u64; txnid u64 }
  MDB_db     { pad u32; flags u16; depth u16; branch_pages u64;
               leaf_pages u64; overflow_pages u64; entries u64; root u64 }
  MDB_node   { lo u16; hi u16; flags u16; ksize u16; data char[] }
The page size is persisted as dbs[0].pad (mm_psize).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Tuple

MDB_MAGIC = 0xBEEFC0DE

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01
F_DUPDATA = 0x04

_PAGEHDRSZ = 16
_INVALID_PAGE = 0xFFFFFFFFFFFFFFFF


class LMDBFormatError(IOError):
    pass


class LMDBReader:
    """Iterate (key, value) pairs of an LMDB environment's main database."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._path = path
        # mmap, not read(): LSUN exports run to tens of GB.
        import mmap

        self._file = open(path, "rb")
        self._data = mmap.mmap(self._file.fileno(), 0,
                               access=mmap.ACCESS_READ)
        self._parse_meta()

    def close(self):
        self._data.close()
        self._file.close()

    # -- meta ------------------------------------------------------------

    def _parse_meta(self):
        # Meta pages live at offsets 0 and psize; psize is itself stored in
        # the meta, so read meta 0 first assuming it starts at offset 0
        # (always true), then locate meta 1 with the recovered psize.
        m0 = self._read_meta(0)
        self._psize = m0["psize"]
        try:
            m1 = self._read_meta(self._psize)
        except LMDBFormatError:
            m1 = None
        meta = m0 if (m1 is None or m0["txnid"] >= m1["txnid"]) else m1
        self._main_db = meta["main_db"]
        self.entries = self._main_db["entries"]

    def _read_meta(self, offset: int) -> dict:
        d = self._data
        if len(d) < offset + 152:
            raise LMDBFormatError("file too small for meta page")
        flags = struct.unpack_from("<H", d, offset + 10)[0]
        if not flags & P_META:
            raise LMDBFormatError(f"page at {offset} is not a meta page")
        magic, version = struct.unpack_from("<II", d, offset + 16)
        if magic != MDB_MAGIC:
            raise LMDBFormatError(f"bad LMDB magic {magic:#x}")
        if version not in (1,):
            raise LMDBFormatError(f"unsupported LMDB data version {version}")

        def read_db(off):
            pad, dflags, depth = struct.unpack_from("<IHH", d, off)
            branch, leaf, overflow, entries, root = struct.unpack_from(
                "<5Q", d, off + 8)
            return dict(pad=pad, flags=dflags, depth=depth, entries=entries,
                        root=root)

        free_db = read_db(offset + 40)
        main_db = read_db(offset + 88)
        txnid = struct.unpack_from("<Q", d, offset + 144)[0]
        return dict(psize=free_db["pad"], main_db=main_db, txnid=txnid)

    # -- pages -----------------------------------------------------------

    def _page(self, pgno: int) -> Tuple[int, int]:
        off = pgno * self._psize
        if off + _PAGEHDRSZ > len(self._data):
            raise LMDBFormatError(f"page {pgno} beyond end of file")
        flags = struct.unpack_from("<H", self._data, off + 10)[0]
        return off, flags

    def _iter_page(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        d = self._data
        off, flags = self._page(pgno)
        if flags & P_LEAF2:
            raise LMDBFormatError("MDB_DUPFIXED (LEAF2) pages not supported")
        lower = struct.unpack_from("<H", d, off + 12)[0]
        nkeys = (lower - _PAGEHDRSZ) // 2
        ptrs = struct.unpack_from(f"<{nkeys}H", d, off + _PAGEHDRSZ)
        for ptr in ptrs:
            node = off + ptr
            lo, hi, nflags, ksize = struct.unpack_from("<4H", d, node)
            key = d[node + 8: node + 8 + ksize]
            if flags & P_BRANCH:
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._iter_page(child)
            elif flags & P_LEAF:
                if nflags & F_DUPDATA:
                    raise LMDBFormatError(
                        "MDB_DUPSORT sub-databases not supported")
                dsize = lo | (hi << 16)
                if nflags & F_BIGDATA:
                    ovf_pgno = struct.unpack_from(
                        "<Q", d, node + 8 + ksize)[0]
                    ovf_off, ovf_flags = self._page(ovf_pgno)
                    if not ovf_flags & P_OVERFLOW:
                        raise LMDBFormatError(
                            f"page {ovf_pgno} is not an overflow page")
                    start = ovf_off + _PAGEHDRSZ
                    value = d[start: start + dsize]
                else:
                    start = node + 8 + ksize
                    value = d[start: start + dsize]
                yield key, value
            else:
                raise LMDBFormatError(f"unexpected page flags {flags:#x}")

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        root = self._main_db["root"]
        if root == _INVALID_PAGE or self.entries == 0:
            return
        yield from self._iter_page(root)

    def __len__(self) -> int:
        return self.entries
