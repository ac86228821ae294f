"""Pure-Python LMDB file-format reader and writer (copied from
``doc2tex_tpu.data.pylmdb``; the standard library only).

The reference stores datasets in LMDB through the ``lmdb`` package
(``doc2tex/data/lmdb_dataset.py:12-101``, writer
``create_lmdb_dataset.py:36-98``).  The port does without that package and
liblmdb, so this module implements the on-disk MDB format directly:

- ``PyLmdbReader``: opens ``<root>/data.mdb``, walks the main DB's B+tree
  (meta page selection by txnid, branch/leaf node layout, overflow pages)
  and reads any store the reference pipeline produced.
- ``write_pylmdb``: single-transaction writer that builds the B+tree
  bottom-up from sorted key/value pairs and emits a spec-conformant file
  (meta pair, leaf/branch pages, overflow chains), which liblmdb opens.

Format facts encoded below (LMDB 0.9.x, MDB_DATA_VERSION=1):
- page header: pgno u64, pad u16, flags u16, lower u16 / upper u16 (or
  pb_pages u32 for overflow);  PAGEHDRSZ=16; ptr array of u16 at 16.
- flags: BRANCH=0x01 LEAF=0x02 OVERFLOW=0x04 META=0x08 LEAF2=0x20.
- node: lo u16, hi u16, flags u16, ksize u16, key..., data...;
  leaf datasize = lo | hi<<16; branch child pgno = lo | hi<<16 | flags<<32.
- node flag F_BIGDATA=0x01: leaf data is an 8-byte overflow pgno.
- meta page: magic 0xBEEFC0DE u32, version u32, address u64, mapsize u64,
  dbs[2] (pad u32, flags u16, depth u16, branch/leaf/overflow pages u64,
  entries u64, root u64), last_pg u64, txnid u64; page size lives in
  dbs[0].pad; live meta = larger txnid of pages 0/1.
- node max = (psize - 16) / 2 rounded even, minus header; larger data
  spills to overflow pages.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional, Sequence

MAGIC = 0xBEEFC0DE
VERSION = 1
P_BRANCH, P_LEAF, P_OVERFLOW, P_META, P_LEAF2 = 0x01, 0x02, 0x04, 0x08, 0x20
F_BIGDATA = 0x01
PAGEHDRSZ = 16
P_INVALID = 0xFFFFFFFFFFFFFFFF

_META_DB = struct.Struct("<IHHQQQQQ")  # pad flags depth branch leaf ovf entries root
_META = struct.Struct("<IIQQ")  # magic version address mapsize  (then dbs, last_pg, txnid)


class PyLmdbReader:
    """Read-only main-DB access over a memory-loaded data.mdb."""

    def __init__(self, root: str):
        path = root
        if os.path.isdir(root):
            path = os.path.join(root, "data.mdb")
        with open(path, "rb") as f:
            self.buf = f.read()
        meta = self._pick_meta()
        self.psize = meta["psize"]
        self.root_pg = meta["main_root"]
        self.entries = meta["main_entries"]

    # ---------------------------------------------------------------- meta
    def _parse_meta(self, off: int) -> Optional[dict]:
        b = self.buf
        flags = struct.unpack_from("<H", b, off + 10)[0]
        if not flags & P_META:
            return None
        m = off + PAGEHDRSZ
        magic, version, _addr, mapsize = _META.unpack_from(b, m)
        if magic != MAGIC:
            return None
        db0 = _META_DB.unpack_from(b, m + 24)
        db1 = _META_DB.unpack_from(b, m + 24 + _META_DB.size)
        last_pg, txnid = struct.unpack_from("<QQ", b, m + 24 + 2 * _META_DB.size)
        return {
            "psize": db0[0],
            "main_root": db1[7],
            "main_entries": db1[6],
            "depth": db1[2],
            "last_pg": last_pg,
            "txnid": txnid,
            "mapsize": mapsize,
        }

    def _pick_meta(self) -> dict:
        # A torn meta-0 with a valid meta-1 is a legitimate LMDB
        # crash-recovery state (liblmdb opens via the other meta page), so
        # parse both independently and take the valid one with the larger
        # txnid.  The page size is unknown until one meta parses; when
        # meta-0 is bad, probe common page sizes for meta-1.
        m0 = self._try_meta(0)
        sizes = [m0["psize"]] if m0 else [4096, 8192, 16384, 32768, 65536]
        m1 = None
        for ps in sizes:
            m1 = self._try_meta(ps)
            if m1 is not None:
                break
        if m0 is None and m1 is None:
            raise ValueError("not an LMDB file (both meta pages invalid)")
        if m0 is None or (m1 is not None and m1["txnid"] > m0["txnid"]):
            return m1
        return m0

    def _try_meta(self, off: int) -> Optional[dict]:
        try:
            return self._parse_meta(off)
        except struct.error:
            return None

    # --------------------------------------------------------------- pages
    def _page(self, pgno: int) -> int:
        return pgno * self.psize

    def _page_flags(self, off: int) -> int:
        return struct.unpack_from("<H", self.buf, off + 10)[0]

    def _numkeys(self, off: int) -> int:
        lower = struct.unpack_from("<H", self.buf, off + 12)[0]
        return (lower - PAGEHDRSZ) // 2

    def _node(self, page_off: int, i: int) -> int:
        ptr = struct.unpack_from("<H", self.buf, page_off + PAGEHDRSZ + 2 * i)[0]
        return page_off + ptr

    def _node_key(self, noff: int) -> bytes:
        ksize = struct.unpack_from("<H", self.buf, noff + 6)[0]
        return self.buf[noff + 8 : noff + 8 + ksize]

    def _leaf_data(self, noff: int) -> bytes:
        lo, hi, nflags, ksize = struct.unpack_from("<HHHH", self.buf, noff)
        dsize = lo | (hi << 16)
        dstart = noff + 8 + ksize
        if nflags & F_BIGDATA:
            (ovf,) = struct.unpack_from("<Q", self.buf, dstart)
            o = self._page(ovf) + PAGEHDRSZ
            return self.buf[o : o + dsize]
        return self.buf[dstart : dstart + dsize]

    def _branch_child(self, noff: int) -> int:
        lo, hi, flags = struct.unpack_from("<HHH", self.buf, noff)
        return lo | (hi << 16) | (flags << 32)

    # -------------------------------------------------------------- lookup
    def get(self, key: bytes) -> Optional[bytes]:
        if self.root_pg == P_INVALID:
            return None
        off = self._page(self.root_pg)
        while True:
            flags = self._page_flags(off)
            n = self._numkeys(off)
            if flags & P_BRANCH:
                # child i covers keys in [key_i, key_{i+1}); key_0 is empty
                lo_i, hi_i, child = 1, n - 1, 0
                while lo_i <= hi_i:  # last i with key_i <= key
                    mid = (lo_i + hi_i) // 2
                    if self._node_key(self._node(off, mid)) <= key:
                        child = mid
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                off = self._page(self._branch_child(self._node(off, child)))
            elif flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    noff = self._node(off, mid)
                    k = self._node_key(noff)
                    if k == key:
                        return self._leaf_data(noff)
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            else:
                raise ValueError(f"unsupported page flags 0x{flags:x}")

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        """In-order scan of the main DB."""
        if self.root_pg == P_INVALID:
            return
        stack = [self._page(self.root_pg)]
        while stack:
            off = stack.pop()
            flags = self._page_flags(off)
            n = self._numkeys(off)
            if flags & P_BRANCH:
                for i in reversed(range(n)):
                    stack.append(
                        self._page(self._branch_child(self._node(off, i)))
                    )
            else:
                for i in range(n):
                    noff = self._node(off, i)
                    yield self._node_key(noff), self._leaf_data(noff)


# --------------------------------------------------------------------------
# writer


def _even(n: int) -> int:
    return (n + 1) & ~1


class _PageBuilder:
    """Fills pages with nodes; ptr array grows from 16, data from the top."""

    def __init__(self, psize: int, flags: int):
        self.psize = psize
        self.flags = flags
        self.reset()

    def reset(self):
        self.nodes: list[bytes] = []
        self.lower = PAGEHDRSZ
        self.upper = self.psize

    def fits(self, node: bytes) -> bool:
        return self.lower + 2 + _even(len(node)) <= self.upper

    def add(self, node: bytes) -> None:
        self.nodes.append(node)
        self.lower += 2
        self.upper -= _even(len(node))

    def render(self, pgno: int) -> bytes:
        out = bytearray(self.psize)
        struct.pack_into("<QHHHH", out, 0, pgno, 0, self.flags,
                         self.lower, self.upper)
        pos = self.psize
        ptrs = []
        for node in self.nodes:
            pos -= _even(len(node))
            out[pos : pos + len(node)] = node
            ptrs.append(pos)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", out, PAGEHDRSZ + 2 * i, p)
        return bytes(out)


def write_pylmdb(
    root: str,
    pairs: Sequence[tuple[bytes, bytes]],
    map_size: int = 1 << 30,
    psize: int = 4096,
) -> None:
    """Write ``<root>/data.mdb`` containing ``pairs`` in the main DB."""
    os.makedirs(root, exist_ok=True)
    pairs = sorted(pairs)
    node_max = ((psize - PAGEHDRSZ) // 2) & ~1  # mdb me_nodemax

    pages: dict[int, bytes] = {}
    next_pg = 2  # 0/1 are metas

    def alloc(n: int = 1) -> int:
        nonlocal next_pg
        p = next_pg
        next_pg += n
        return p

    # ---- leaves (+ overflow chains), tracking first key per page
    leaf_infos: list[tuple[bytes, int]] = []  # (first_key, pgno)
    n_ovf = 0
    builder = _PageBuilder(psize, P_LEAF)
    first_key: Optional[bytes] = None

    def flush_leaf():
        nonlocal builder, first_key
        if not builder.nodes:
            return
        pg = alloc()
        pages[pg] = builder.render(pg)
        leaf_infos.append((first_key, pg))
        builder = _PageBuilder(psize, P_LEAF)
        first_key = None

    for key, val in pairs:
        if len(key) > 511:
            raise ValueError("LMDB max key size is 511 bytes")
        big = 8 + len(key) + len(val) > node_max
        if big:
            n_pages = -(-(len(val) + PAGEHDRSZ) // psize)
            ovf_pg = alloc(n_pages)
            blob = bytearray(n_pages * psize)
            struct.pack_into("<QHHI", blob, 0, ovf_pg, 0, P_OVERFLOW, n_pages)
            blob[PAGEHDRSZ : PAGEHDRSZ + len(val)] = val
            for k in range(n_pages):
                pages[ovf_pg + k] = bytes(blob[k * psize : (k + 1) * psize])
            n_ovf += n_pages
            data = struct.pack("<Q", ovf_pg)
            nflags = F_BIGDATA
        else:
            data = val
            nflags = 0
        dsize = len(val)
        node = (
            struct.pack("<HHHH", dsize & 0xFFFF, dsize >> 16, nflags, len(key))
            + key
            + data
        )
        if not builder.fits(node):
            flush_leaf()
        if first_key is None:
            first_key = key
        builder.add(node)
    flush_leaf()

    # ---- branch levels bottom-up
    depth = 1
    n_branch = 0
    level = leaf_infos
    while len(level) > 1:
        depth += 1
        next_level: list[tuple[bytes, int]] = []
        builder = _PageBuilder(psize, P_BRANCH)
        first_key = None

        def flush_branch():
            nonlocal builder, first_key, n_branch
            if not builder.nodes:
                return
            pg = alloc()
            pages[pg] = builder.render(pg)
            next_level.append((first_key, pg))
            n_branch += 1
            builder = _PageBuilder(psize, P_BRANCH)
            first_key = None

        for k, child_pg in level:
            key = b"" if not builder.nodes else k  # leftmost key empty
            node = (
                struct.pack(
                    "<HHHH",
                    child_pg & 0xFFFF,
                    (child_pg >> 16) & 0xFFFF,
                    (child_pg >> 32) & 0xFFFF,
                    len(key),
                )
                + key
            )
            if not builder.fits(node):
                flush_branch()
                key = b""
                node = (
                    struct.pack(
                        "<HHHH",
                        child_pg & 0xFFFF,
                        (child_pg >> 16) & 0xFFFF,
                        (child_pg >> 32) & 0xFFFF,
                        0,
                    )
                )
            if first_key is None:
                first_key = k
            builder.add(node)
        flush_branch()
        level = next_level

    root_pg = level[0][1] if level else P_INVALID
    if not pairs:
        depth = 0

    # ---- metas
    last_pg = next_pg - 1
    mapsize = max(map_size, next_pg * psize)

    def meta_page(pgno: int, txnid: int, root: int) -> bytes:
        out = bytearray(psize)
        struct.pack_into("<QHHHH", out, 0, pgno, 0, P_META, 0, 0)
        m = PAGEHDRSZ
        _META.pack_into(out, m, MAGIC, VERSION, 0, mapsize)
        # free DB: page size in pad, MDB_INTEGERKEY flags, empty
        _META_DB.pack_into(out, m + 24, psize, 0x08, 0, 0, 0, 0, 0, P_INVALID)
        # main DB
        _META_DB.pack_into(
            out, m + 24 + _META_DB.size, 0, 0, depth,
            n_branch, len(leaf_infos), n_ovf, len(pairs),
            root,
        )
        struct.pack_into(
            "<QQ", out, m + 24 + 2 * _META_DB.size, last_pg, txnid
        )
        return bytes(out)

    with open(os.path.join(root, "data.mdb"), "wb") as f:
        f.write(meta_page(0, 0, P_INVALID))
        f.write(meta_page(1, 1, root_pg))
        for pg in range(2, next_pg):
            f.write(pages[pg])
