"""BGZF (block-gzip) writer with .gzi index, and a reader.

The on-disk format of ``panagram_tpu.io.bgzf``, which the reference tool's
readers consume:

* each block is an independent gzip member with a BC extra subfield holding
  the compressed block size; uncompressed payload <= 65280 bytes per block;
* the file ends with the standard 28-byte BGZF EOF marker;
* the ``.gzi`` index is ``(n_entries: u64, [compressed_off: u64,
  uncompressed_off: u64] * n_entries)`` listing the start of every block
  after the first.

Blocks are compressed with zlib at level 6 as raw deflate (wbits -15), the
settings of panagram_tpu's writer, so the same input gives the same bytes.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# htslib BGZF_BLOCK_SIZE = 0xff00: max uncompressed payload bytes per block.
MAX_BLOCK_DATA = 0xFF00

# Standard BGZF EOF marker (an empty block), identical to htslib's.
EOF_MARKER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HEADER = struct.Struct("<4BI2BH2BHH")  # gzip header + XLEN + BC subfield

# blocks written per pool round once a write spans at least this many
_MT_MIN_BLOCKS = 8


def _block_header(bsize: int) -> bytes:
    return _HEADER.pack(
        0x1F, 0x8B, 0x08, 0x04,  # magic, deflate, FEXTRA
        0,                        # mtime
        0, 0xFF,                  # XFL, OS=unknown
        6,                        # XLEN
        0x42, 0x43,               # 'B','C'
        2,                        # SLEN
        bsize - 1,                # BSIZE (total block size minus 1)
    )


def compress_block(data: bytes, level: int = 6) -> bytes:
    """One BGZF block; a payload that would not fit 64 KiB is stored."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = co.compress(data) + co.flush()
    bsize = len(payload) + 26
    if bsize > 65536:
        co = zlib.compressobj(0, zlib.DEFLATED, -15)
        payload = co.compress(data) + co.flush()
        bsize = len(payload) + 26
    return (_block_header(bsize) + payload
            + struct.pack("<II", zlib.crc32(data), len(data)))


class BgzfWriter:
    """Streaming BGZF writer that also records the .gzi block table.

    ``write()`` accepts bytes or any buffer (e.g. a uint8 ndarray); blocks
    are cut at MAX_BLOCK_DATA.  Large writes compress their blocks on a
    small thread pool (zlib releases the GIL; order is kept, so the bytes
    equal the serial path's).  ``close()`` appends the EOF marker and shuts
    the pool down.  ``write_gzi(path)`` dumps the index: an entry for the
    start of every block after the first, the last one at end-of-data."""

    def __init__(self, path, level: int = 6):
        self._fh = open(path, "wb")
        self.level = level
        self._buf = bytearray()
        self._coffset = 0
        self._uoffset = 0
        self._blocks: list[tuple[int, int]] = []
        self._pool: ThreadPoolExecutor | None = None
        self._closed = False

    def write(self, data) -> int:
        if not isinstance(data, (bytes, bytearray)):
            data = memoryview(data)
            if not data.c_contiguous:
                data = data.tobytes()
        n = data.nbytes if isinstance(data, memoryview) else len(data)
        self._buf += data
        nblocks = len(self._buf) // MAX_BLOCK_DATA
        if nblocks >= _MT_MIN_BLOCKS:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=min(4, os.cpu_count() or 1),
                    thread_name_prefix="bgzf")
            span = nblocks * MAX_BLOCK_DATA
            raw = bytes(self._buf[:span])
            del self._buf[:span]
            chunks = [raw[i * MAX_BLOCK_DATA:(i + 1) * MAX_BLOCK_DATA]
                      for i in range(nblocks)]
            for block in self._pool.map(
                    lambda c: compress_block(c, self.level), chunks):
                self._emit(block, MAX_BLOCK_DATA)
        while len(self._buf) >= MAX_BLOCK_DATA:
            self._emit(compress_block(bytes(self._buf[:MAX_BLOCK_DATA]),
                                      self.level), MAX_BLOCK_DATA)
            del self._buf[:MAX_BLOCK_DATA]
        return n

    def _emit(self, block: bytes, ulen: int):
        self._fh.write(block)
        self._coffset += len(block)
        self._uoffset += ulen
        self._blocks.append((self._coffset, self._uoffset))

    def flush(self):
        if self._buf:
            self._emit(compress_block(bytes(self._buf), self.level),
                       len(self._buf))
            self._buf.clear()

    def write_gzi(self, path: str):
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", len(self._blocks)))
            for c, u in self._blocks:
                f.write(struct.pack("<QQ", c, u))

    def close(self):
        if self._closed:
            return
        try:
            self.flush()
            self._fh.write(EOF_MARKER)
        finally:
            self._closed = True
            self._fh.close()
            if self._pool is not None:
                self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_gzi(path: str) -> np.ndarray:
    """A .gzi as an (nblocks+1)-entry (rstart, dstart) array with the
    implicit leading (0, 0)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        dtype = np.dtype([("rstart", "<u8"), ("dstart", "<u8")])
        entries = np.fromfile(f, dtype, n)
    blocks = np.zeros(int(n) + 1, dtype=dtype)
    blocks[1:] = entries
    return blocks.astype([("rstart", int), ("dstart", int)])


def _bc_size(extra: bytes):
    """BSIZE from the BC subfield of a gzip extra field, or None."""
    i = 0
    while i + 4 <= len(extra):
        si1, si2 = extra[i], extra[i + 1]
        slen = struct.unpack("<H", extra[i + 2:i + 4])[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2 and i + 6 <= len(extra):
            return struct.unpack("<H", extra[i + 4:i + 6])[0] + 1
        i += 4 + slen
    return None


def _read_header(fh, coffset: int):
    """(bsize, xlen) of the block at coffset, or None at end of file.  The
    extra field is read to its declared XLEN, whatever that is."""
    fh.seek(coffset)
    head = fh.read(12)
    if len(head) < 12:
        return None
    if head[0] != 0x1F or head[1] != 0x8B:
        raise ValueError(f"bad BGZF magic at offset {coffset}")
    xlen = struct.unpack("<H", head[10:12])[0]
    bsize = _bc_size(fh.read(xlen))
    if bsize is None:
        raise ValueError(f"BGZF BC subfield missing at offset {coffset}")
    return bsize, xlen


class BgzfReader:
    """Random-access BGZF reader: ``read_at(uoffset, n)`` through a .gzi,
    or ``read_all()``."""

    def __init__(self, path: str, gzi: str | None = None):
        self._fh = open(path, "rb")
        self.blocks = load_gzi(gzi) if gzi else None

    def _block(self, coffset: int):
        """(data, next coffset) of the block at coffset; b'' at EOF."""
        hdr = _read_header(self._fh, coffset)
        if hdr is None:
            return b"", coffset
        bsize, xlen = hdr
        payload = self._fh.read(bsize - 12 - xlen - 8)
        return zlib.decompress(payload, -15), coffset + bsize

    def read_at(self, uoffset: int, size: int) -> bytes:
        if self.blocks is None:
            raise ValueError("read_at requires a .gzi index")
        blk = np.searchsorted(self.blocks["dstart"], uoffset, side="right") - 1
        within = int(uoffset - self.blocks["dstart"][blk])
        coffset = int(self.blocks["rstart"][blk])
        out = bytearray()
        while len(out) < size:
            data, coffset = self._block(coffset)
            if not data:
                break
            out += data[within:within + size - len(out)]
            within = 0
        return bytes(out)

    def read_all(self) -> bytes:
        out = bytearray()
        coffset = 0
        while True:
            data, coffset = self._block(coffset)
            if not data:
                break
            out += data
        return bytes(out)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def decompress_file(path: str) -> bytes:
    with BgzfReader(path) as r:
        return r.read_all()


def is_bgzf(path: str) -> bool:
    """True when the file starts with a BGZF block (gzip + FEXTRA with a
    'BC' subfield)."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
            if len(head) < 12 or head[0] != 0x1F or head[1] != 0x8B \
                    or not (head[3] & 0x04):
                return False
            xlen = struct.unpack("<H", head[10:12])[0]
            return _bc_size(f.read(xlen)) is not None
    except OSError:
        return False


def build_gzi(path: str, gzi_path: str | None = None) -> str:
    """Create a .gzi for an existing BGZF file by walking the block headers
    and each member's ISIZE trailer."""
    if gzi_path is None:
        gzi_path = str(path) + ".gzi"
    entries: list[tuple[int, int]] = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        coffset = uoffset = 0
        while coffset < size:
            hdr = _read_header(f, coffset)
            if hdr is None:
                break
            bsize, _ = hdr
            f.seek(coffset + bsize - 4)
            (isize,) = struct.unpack("<I", f.read(4))
            coffset += bsize
            uoffset += isize
            if isize == 0 and coffset >= size:
                break  # EOF marker
            entries.append((coffset, uoffset))
    tmp = gzi_path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(entries)))
        for c, u in entries:
            f.write(struct.pack("<QQ", c, u))
    os.replace(tmp, gzi_path)
    return gzi_path
