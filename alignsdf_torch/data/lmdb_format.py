"""Minimal LMDB file-format reader/writer (pure Python, no liblmdb): the
JAX package's ``data/lmdb_format.py``, copied so that the port imports
nothing of it.

Produces and reads real LMDB databases (``data.mdb``: 4096-byte pages, two
meta pages, B+tree of leaf/branch pages, overflow pages for large values), so
the datasets written by the JAX package's tools/create_lmdb.py and by
``data/synthetic.py:write_synthetic_lmdb`` are byte-level compatible with
the reference's liblmdb readers (reference utils/sdf_utils.py:119-163,
utils/img_utils.py:15-27) and vice versa.  Used as the engine of
``data/lmdb_backend.py`` when the ``lmdb`` package is not installed.

Scope (all this project needs):
  * writer: one bulk write transaction of unique keys (sorted internally),
    default-comparator (memcmp) main DB only;
  * reader: point lookups + full iteration on the main DB, 64-bit layout,
    page size taken from the file's meta page.

Layout references: LMDB 0.9 ``mdb.c`` struct definitions (MDB_page, MDB_node,
MDB_db, MDB_meta).  All integers little-endian.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

PAGESIZE = 4096
PAGEHDRSZ = 16
MAGIC = 0xBEEFC0DE
VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01
P_INVALID = 0xFFFFFFFFFFFFFFFF

# MDB_node header: mn_lo, mn_hi, mn_flags, mn_ksize (4 x uint16)
_NODE = struct.Struct("<HHHH")
# MDB_db: md_pad(u32) md_flags(u16) md_depth(u16) branch/leaf/overflow pages,
# entries, root (5 x u64)
_DB = struct.Struct("<IHHQQQQQ")
# page header: mp_pgno(u64) mp_pad(u16) mp_flags(u16) + {lower,upper | pages}
_PGHDR = struct.Struct("<QHHHH")
_PGHDR_OVF = struct.Struct("<QHHI")

# node max for a 4096 page: (pagesize - PAGEHDRSZ) / MDB_MINKEYS(2) & -2
NODEMAX = ((PAGESIZE - PAGEHDRSZ) // 2) & ~1


def _leaf_node(key: bytes, data: bytes, bigdata_pgno: Optional[int]) -> bytes:
    dsize = len(data)
    if bigdata_pgno is not None:
        body = struct.pack("<Q", bigdata_pgno)
        node = _NODE.pack(dsize & 0xFFFF, dsize >> 16, F_BIGDATA, len(key)) \
            + key + body
    else:
        node = _NODE.pack(dsize & 0xFFFF, dsize >> 16, 0, len(key)) + key + data
    if len(node) & 1:
        node += b"\x00"
    return node


def _branch_node(key: bytes, pgno: int) -> bytes:
    node = _NODE.pack(pgno & 0xFFFF, (pgno >> 16) & 0xFFFF,
                      (pgno >> 32) & 0xFFFF, len(key)) + key
    if len(node) & 1:
        node += b"\x00"
    return node


def _build_page(pgno: int, flags: int, nodes: List[bytes]) -> bytes:
    """Assemble one leaf/branch page: ptrs grow from the header, node data
    packs downward from the page end (mdb.c mdb_node_add)."""
    n = len(nodes)
    lower = PAGEHDRSZ + 2 * n
    upper = PAGESIZE
    offsets = []
    blob = bytearray(PAGESIZE)
    for node in nodes:
        upper -= len(node)
        offsets.append(upper)
        blob[upper:upper + len(node)] = node
    assert lower <= upper, "page overflow"
    blob[0:PAGEHDRSZ] = _PGHDR.pack(pgno, 0, flags, lower, upper)
    for i, off in enumerate(offsets):
        blob[PAGEHDRSZ + 2 * i: PAGEHDRSZ + 2 * i + 2] = struct.pack("<H", off)
    return bytes(blob)


class LmdbWriter:
    """Bulk writer: put() everything, then close() builds the B+tree.

    Mirrors ``lmdb.open(path); env.begin(write=True); txn.put(...)`` usage
    shape closely enough for the packer; ``map_size`` only sets the mapsize
    recorded in the meta page (the file itself is exactly as big as needed).
    """

    def __init__(self, path: str, map_size: Optional[int] = None,
                 subdir: bool = True):
        self.path = path
        self.map_size = map_size
        self.subdir = subdir
        self.items: Dict[bytes, bytes] = {}
        self.closed = False

    def put(self, key, value) -> None:
        if isinstance(key, str):
            key = key.encode("ascii")
        self.items[bytes(key)] = bytes(memoryview(value))

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self.subdir:
            os.makedirs(self.path, exist_ok=True)
            target = os.path.join(self.path, "data.mdb")
        else:
            target = self.path

        items = sorted(self.items.items())
        pages: Dict[int, bytes] = {}
        next_pg = 2  # 0, 1 are meta pages
        n_overflow = 0

        def alloc(n: int = 1) -> int:
            nonlocal next_pg
            pg = next_pg
            next_pg += n
            return pg

        # 1. overflow chains for big values, leaf nodes
        nodes: List[Tuple[bytes, bytes]] = []  # (key, encoded node)
        for key, value in items:
            if _NODE.size + len(key) + len(value) > NODEMAX:
                npages = (PAGEHDRSZ + len(value) + PAGESIZE - 1) // PAGESIZE
                pg = alloc(npages)
                n_overflow += npages
                chain = bytearray(npages * PAGESIZE)
                chain[0:PAGEHDRSZ] = _PGHDR_OVF.pack(pg, 0, P_OVERFLOW, npages)
                chain[PAGEHDRSZ:PAGEHDRSZ + len(value)] = value
                for i in range(npages):
                    pages[pg + i] = bytes(chain[i * PAGESIZE:(i + 1) * PAGESIZE])
                nodes.append((key, _leaf_node(key, value, pg)))
            else:
                nodes.append((key, _leaf_node(key, value, None)))

        # 2. pack leaves greedily (ptr costs 2 bytes per node)
        leaves: List[Tuple[bytes, int]] = []  # (first key, pgno)
        n_leaf = 0
        cur: List[bytes] = []
        cur_first: Optional[bytes] = None
        cur_size = PAGEHDRSZ

        def flush_leaf():
            nonlocal cur, cur_first, cur_size, n_leaf
            if not cur:
                return
            pg = alloc()
            pages[pg] = _build_page(pg, P_LEAF, cur)
            leaves.append((cur_first, pg))
            n_leaf += 1
            cur, cur_first, cur_size = [], None, PAGEHDRSZ

        for key, node in nodes:
            if cur and cur_size + len(node) + 2 > PAGESIZE:
                flush_leaf()
            if not cur:
                cur_first = key
            cur.append(node)
            cur_size += len(node) + 2
        flush_leaf()

        # 3. branch levels until a single root
        depth = 1
        n_branch = 0
        level = leaves
        while len(level) > 1:
            depth += 1
            parents: List[Tuple[bytes, int]] = []
            cur_b: List[bytes] = []
            first_key: Optional[bytes] = None
            size_b = PAGEHDRSZ

            def flush_branch():
                nonlocal cur_b, first_key, size_b, n_branch
                if not cur_b:
                    return
                pg = alloc()
                pages[pg] = _build_page(pg, P_BRANCH, cur_b)
                parents.append((first_key, pg))
                n_branch += 1
                cur_b, first_key, size_b = [], None, PAGEHDRSZ

            for key, child_pg in level:
                # node 0 of every branch page carries no key (mdb convention)
                node = _branch_node(b"" if not cur_b else key, child_pg)
                if cur_b and size_b + len(node) + 2 > PAGESIZE:
                    # re-encode with the real key as this page's node 0
                    flush_branch()
                    node = _branch_node(b"", child_pg)
                if not cur_b:
                    first_key = key
                cur_b.append(node)
                size_b += len(node) + 2
            flush_branch()
            level = parents

        if items:
            root = level[0][1]
        else:
            root, depth = P_INVALID, 0

        last_pg = next_pg - 1 if next_pg > 2 else 1
        file_size = (last_pg + 1) * PAGESIZE
        map_size = self.map_size or 0
        map_size = max(map_size, file_size, 1 << 20)
        map_size = -(-map_size // PAGESIZE) * PAGESIZE

        def meta_page(pgno: int, txnid: int, with_tree: bool) -> bytes:
            # mm_dbs[FREE_DBI].md_pad carries the env page size (mdb.c
            # mdb_env_init_meta / mdb_env_read_header)
            free_db = _DB.pack(PAGESIZE, 0, 0, 0, 0, 0, 0, P_INVALID)
            if with_tree:
                main_db = _DB.pack(0, 0, depth, n_branch, n_leaf, n_overflow,
                                   len(items), root)
            else:
                main_db = _DB.pack(0, 0, 0, 0, 0, 0, 0, P_INVALID)
            meta = struct.pack("<IIQQ", MAGIC, VERSION, 0, map_size) \
                + free_db + main_db + struct.pack("<QQ", last_pg, txnid)
            page = bytearray(PAGESIZE)
            page[0:PAGEHDRSZ] = _PGHDR.pack(pgno, 0, P_META, 0, 0)
            page[PAGEHDRSZ:PAGEHDRSZ + len(meta)] = meta
            return bytes(page)

        with open(target, "wb") as f:
            f.write(meta_page(0, 0, False))   # pristine meta (txn 0)
            f.write(meta_page(1, 1, True))    # committed tree (txn 1)
            for pg in range(2, next_pg):
                f.write(pages[pg])

    # context-manager sugar
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MiniLmdb:
    """Read-only LMDB environment (main DB, default comparator)."""

    def __init__(self, path: str):
        target = os.path.join(path, "data.mdb") if os.path.isdir(path) else path
        with open(target, "rb") as f:
            self.buf = f.read()
        # page size comes from meta 0's FREE_DBI md_pad (mdb_env_read_header)
        psize = _DB.unpack_from(self.buf, PAGEHDRSZ + 24)[0] or PAGESIZE
        best = None
        for pg in (0, 1):
            off = pg * psize + PAGEHDRSZ
            magic, version = struct.unpack_from("<II", self.buf, off)
            if magic != MAGIC:
                raise IOError(f"{target}: not an LMDB file (bad magic)")
            # meta layout: magic(4) version(4) address(8) mapsize(8)
            # dbs(2x48) last_pg(8) txnid(8)
            txnid = struct.unpack_from("<Q", self.buf,
                                       off + 24 + 2 * _DB.size + 8)[0]
            if best is None or txnid >= best[0]:
                best = (txnid, off)
        self.psize = psize
        main = _DB.unpack_from(self.buf, best[1] + 24 + _DB.size)
        self.depth, self.root, self.entries = main[2], main[7], main[6]

    def _page(self, pgno: int) -> Tuple[int, int, int, int]:
        off = pgno * self.psize
        _, _, flags, lower, upper = _PGHDR.unpack_from(self.buf, off)
        return off, flags, lower, upper

    def _node(self, page_off: int, i: int):
        ptr = struct.unpack_from("<H", self.buf, page_off + PAGEHDRSZ + 2 * i)[0]
        off = page_off + ptr
        lo, hi, flags, ksize = _NODE.unpack_from(self.buf, off)
        key = self.buf[off + _NODE.size: off + _NODE.size + ksize]
        return lo, hi, flags, key, off + _NODE.size + ksize

    def _leaf_value(self, lo: int, hi: int, flags: int, data_off: int) -> bytes:
        dsize = lo | (hi << 16)
        if flags & F_BIGDATA:
            ovf_pg = struct.unpack_from("<Q", self.buf, data_off)[0]
            start = ovf_pg * self.psize + PAGEHDRSZ
            return self.buf[start:start + dsize]
        return self.buf[data_off:data_off + dsize]

    def get(self, key) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode("ascii")
        if self.root == P_INVALID:
            return None
        pgno = self.root
        while True:
            off, flags, lower, upper = self._page(pgno)
            n = (lower - PAGEHDRSZ) >> 1
            if flags & P_BRANCH:
                # greatest child whose separator key <= target (node 0 = -inf)
                lt, rt = 1, n - 1
                pick = 0
                while lt <= rt:
                    mid = (lt + rt) // 2
                    _, _, _, k, _ = self._node(off, mid)
                    if k <= key:
                        pick = mid
                        lt = mid + 1
                    else:
                        rt = mid - 1
                nlo, nhi, nflags, _, _ = self._node(off, pick)
                pgno = nlo | (nhi << 16) | (nflags << 32)
            elif flags & P_LEAF:
                lt, rt = 0, n - 1
                while lt <= rt:
                    mid = (lt + rt) // 2
                    lo, hi, nflags, k, data_off = self._node(off, mid)
                    if k == key:
                        return self._leaf_value(lo, hi, nflags, data_off)
                    if k < key:
                        lt = mid + 1
                    else:
                        rt = mid - 1
                return None
            else:
                raise IOError(f"unexpected page flags {flags:#x} at page {pgno}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        def walk(pgno: int):
            off, flags, lower, _ = self._page(pgno)
            n = (lower - PAGEHDRSZ) >> 1
            if flags & P_BRANCH:
                for i in range(n):
                    nlo, nhi, nflags, _, _ = self._node(off, i)
                    yield from walk(nlo | (nhi << 16) | (nflags << 32))
            else:
                for i in range(n):
                    lo, hi, nflags, k, data_off = self._node(off, i)
                    yield k, self._leaf_value(lo, hi, nflags, data_off)

        if self.root != P_INVALID:
            yield from walk(self.root)

    def __len__(self) -> int:
        return self.entries


class _MiniTxn:
    def __init__(self, db: MiniLmdb):
        self._db = db

    def get(self, key):
        return self._db.get(key)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class MiniEnv:
    """``lmdb.Environment``-shaped read-only facade over MiniLmdb."""

    def __init__(self, path: str, **kw):
        self._db = MiniLmdb(path)

    def begin(self, write: bool = False, **kw) -> _MiniTxn:
        if write:
            raise NotImplementedError("MiniEnv is read-only; use LmdbWriter")
        return _MiniTxn(self._db)

    def close(self) -> None:
        pass


def open_env(path: str, **kw):
    """``lmdb.open``-compatible: prefer the real package, else MiniEnv."""
    try:
        import lmdb  # type: ignore

        if getattr(lmdb, "open", None) and getattr(lmdb, "__file__", None):
            return lmdb.open(path, **kw)
    except ImportError:
        pass
    return MiniEnv(path)
