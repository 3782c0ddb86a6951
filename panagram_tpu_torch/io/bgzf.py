"""BGZF (block-gzip) writer with .gzi index, and a random-access reader.

The on-disk format of ``panagram_tpu.io.bgzf``, which the reference tool's
readers consume:

* each block is an independent gzip member with a BC extra subfield holding
  the compressed block size; uncompressed payload <= 65280 bytes per block;
* the file ends with the standard 28-byte BGZF EOF marker;
* the ``.gzi`` index is ``(n_entries: u64, [compressed_off: u64,
  uncompressed_off: u64] * n_entries)`` listing the start of every block
  after the first.

``BgzfPieceWriter`` and ``stitch_bgzf_pieces`` write one file from several
processes (panagram_tpu's multi-host bitmap writes).

Blocks are deflated at level 6 as raw deflate (wbits -15), the settings of
panagram_tpu's writer, so the same input gives the same bytes: by the
native compressor (native/bgzf_native.cpp, built at first use), or by
Python's zlib where it cannot be built (the reason is printed once on
stderr).  The reader inflates through the same library.
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

# a write of at least this many whole blocks is compressed on the pool
_MT_MIN_BLOCKS = 8


def make_virtual_offset(block_start_offset: int,
                        within_block_offset: int) -> int:
    """BGZF virtual offset: the block's file offset << 16 | the offset of
    a byte within the block's uncompressed data."""
    if within_block_offset >= 65536:
        raise ValueError("within_block_offset must be < 65536")
    return (block_start_offset << 16) | within_block_offset


def split_virtual_offset(voffset: int) -> tuple[int, int]:
    """(block file offset, offset within its uncompressed data)."""
    return voffset >> 16, voffset & 0xFFFF


def _native():
    """native.bgzf_native when its library loads, else None."""
    from ..native import bgzf_native

    return bgzf_native if bgzf_native.load() is not None else None


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


def compress_block(data, level: int = 6) -> bytes:
    """One BGZF block by Python's zlib; a payload that would not fit 64 KiB
    is stored.  The native compressor gives the same bytes."""
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
    are cut at MAX_BLOCK_DATA of the stream, whatever the writes' sizes.
    The whole blocks a write completes are compressed straight from its
    buffer, in one call of the native compressor per run of blocks; a write
    of _MT_MIN_BLOCKS blocks or more is cut into one run per thread of a
    small pool (the compressor releases the interpreter lock; order is
    kept, so the bytes equal the serial path's).  ``close()`` appends the
    EOF marker and shuts the pool down.  ``write_gzi(path)`` dumps the
    index: an entry for the start of every block after the first, the last
    one at end-of-data."""

    def __init__(self, path, level: int = 6):
        self._fh = open(path, "wb")
        self.level = level
        self._buf = bytearray()
        self._coffset = 0
        self._uoffset = 0
        self._blocks: list[tuple[int, int]] = []
        self._native = _native()
        self._pool: ThreadPoolExecutor | None = None
        self._closed = False

    def write(self, data) -> int:
        mv = memoryview(data)
        if not mv.c_contiguous:
            mv = memoryview(mv.tobytes())
        mv = mv.cast("B")
        n = mv.nbytes
        pos = 0
        if self._buf:
            pos = min(n, MAX_BLOCK_DATA - len(self._buf))
            self._buf += mv[:pos]
            if len(self._buf) < MAX_BLOCK_DATA:
                return n
            self._write_blocks(bytes(self._buf))
            self._buf.clear()
        whole = (n - pos) // MAX_BLOCK_DATA * MAX_BLOCK_DATA
        if whole:
            self._write_blocks(mv[pos:pos + whole])
        self._buf += mv[pos + whole:]
        return n

    def _compress(self, raw) -> tuple[bytes, list]:
        """The blocks of `raw` (cut every MAX_BLOCK_DATA bytes) back to
        back, and each one's compressed size."""
        if self._native is not None:
            return self._native.compress_buffer(raw, self.level)
        blocks = [compress_block(raw[i:i + MAX_BLOCK_DATA], self.level)
                  for i in range(0, len(raw), MAX_BLOCK_DATA)]
        return b"".join(blocks), [len(b) for b in blocks]

    def _write_blocks(self, raw):
        """Compress and write `raw`: whole blocks, the last one possibly
        short (a flush)."""
        nblocks = -(-len(raw) // MAX_BLOCK_DATA)
        if nblocks >= _MT_MIN_BLOCKS:
            workers = min(4, os.cpu_count() or 1)
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=workers,
                                                thread_name_prefix="bgzf")
            per = -(-nblocks // workers) * MAX_BLOCK_DATA
            runs = self._pool.map(self._compress, [
                raw[i:i + per] for i in range(0, len(raw), per)])
        else:
            runs = [self._compress(raw)]
        left = len(raw)
        for out, sizes in runs:
            self._fh.write(out)
            for size in sizes:
                self._coffset += int(size)
                self._uoffset += min(left, MAX_BLOCK_DATA)
                left -= MAX_BLOCK_DATA
                self._blocks.append((self._coffset, self._uoffset))

    def flush(self):
        if self._buf:
            self._write_blocks(bytes(self._buf))
            self._buf.clear()

    def write_gzi(self, path: str):
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", len(self._blocks)))
            for c, u in self._blocks:
                f.write(struct.pack("<QQ", c, u))

    def tell(self) -> int:
        """Compressed bytes written so far (where the next block starts)."""
        return self._coffset

    def close(self, eof: bool = True):
        """Flush, append the EOF marker (unless eof=False: a piece that
        stitch_bgzf_pieces joins to others) and close."""
        if self._closed:
            return
        try:
            self.flush()
            if eof:
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


class BgzfPieceWriter:
    """One process's share of a bitmap written by several processes (a
    multi-process mesh build): ``write_piece(u_start, data)`` writes a run
    of rows as whole BGZF blocks and records where the run belongs in the
    whole uncompressed stream; ``close()`` saves that manifest beside the
    piece file (<path>.manifest.npy) and writes no EOF marker.
    ``stitch_bgzf_pieces`` joins the processes' pieces in stream order
    without recompressing: the result differs from one writer's file only
    in where blocks end, not in its decompressed bytes."""

    def __init__(self, path: str, level: int = 6):
        self.path = str(path)
        self._w = BgzfWriter(path, level)
        # (uncompressed start in the stream, compressed offset, compressed
        #  length, uncompressed length) per piece
        self.manifest: list[tuple[int, int, int, int]] = []

    def write_piece(self, u_start: int, data):
        w = self._w
        c0 = w.tell()
        n = w.write(data)
        if n == 0:
            return
        w.flush()
        self.manifest.append((u_start, c0, w.tell() - c0, n))

    def close(self):
        self._w.close(eof=False)
        np.save(self.path + ".manifest.npy",
                np.asarray(self.manifest, dtype="<u8").reshape(-1, 4))


def stitch_bgzf_pieces(piece_paths: list, out_path: str,
                       gzi_path: str | None = None) -> int:
    """Join piece files of BgzfPieceWriter into one BGZF file (+ .gzi) in
    stream order: a byte copy of whole blocks, then one EOF marker.  A gap
    in the uncompressed coverage raises.  Returns the uncompressed size."""
    runs = []  # (u_start, path, compressed offset, compressed len, u_len)
    for p in piece_paths:
        for u_start, c_off, c_len, u_len in np.load(str(p) + ".manifest.npy"):
            runs.append((int(u_start), str(p), int(c_off), int(c_len),
                         int(u_len)))
    runs.sort(key=lambda r: r[0])
    tmp = f"{out_path}.tmp.{os.getpid()}"
    total = 0
    handles = {}
    try:
        with open(tmp, "wb") as out:
            for u_start, path, c_off, c_len, u_len in runs:
                if u_start != total:
                    raise ValueError(
                        f"{out_path}: piece coverage gap at uncompressed "
                        f"offset {total} (next piece starts {u_start})")
                fh = handles.get(path)
                if fh is None:
                    fh = handles[path] = open(path, "rb")
                fh.seek(c_off)
                left = c_len
                while left:
                    buf = fh.read(min(left, 1 << 20))
                    if not buf:
                        raise ValueError(f"{path}: truncated piece file")
                    out.write(buf)
                    left -= len(buf)
                total += u_len
            out.write(EOF_MARKER)
    finally:
        for fh in handles.values():
            fh.close()
    os.replace(tmp, out_path)
    build_gzi(out_path, gzi_path)
    return total


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
    """Random-access BGZF reader with a one-block cache: ``seek(virtual
    offset)`` then ``read(n)`` (the access of panagram_tpu's and htslib's
    readers), ``read_to(virtual offset)`` (a CSI chunk's end), ``read_at(
    uoffset, n)`` through a .gzi, or ``read_all()``.  Reading moves a
    position, so one reader serves one thread at a time."""

    def __init__(self, path: str, gzi: str | None = None):
        self._fh = open(path, "rb")
        self.blocks = load_gzi(gzi) if gzi else None
        self._native = _native()
        self._cache_start = -1     # file offset of the cached block
        self._cache = b""          # its uncompressed data
        self._next = None          # file offset of the block after it
        self._within = 0           # read position inside the cached block

    def _load_block(self, coffset: int) -> bytes:
        """The uncompressed data of the block at file offset `coffset`
        (b'' at the end of the file), made the cached block."""
        if coffset == self._cache_start:
            return self._cache
        hdr = _read_header(self._fh, coffset)
        if hdr is None:
            data = b""
        else:
            bsize, xlen = hdr
            body = self._fh.read(bsize - 12 - xlen)   # payload, CRC, ISIZE
            payload, isize = body[:-8], int.from_bytes(body[-4:], "little")
            data = (self._native.decompress_block(payload, isize)
                    if self._native is not None
                    else zlib.decompress(payload, -15))
            self._next = coffset + bsize
        self._cache_start, self._cache = coffset, data
        return data

    def seek(self, virtual_offset: int) -> int:
        coffset, within = split_virtual_offset(virtual_offset)
        self._load_block(coffset)
        self._within = within
        return virtual_offset

    def read(self, size: int) -> bytes:
        """Up to `size` bytes from the position, across blocks; fewer at
        the end of the file."""
        out = bytearray()
        while len(out) < size:
            take = self._cache[self._within:self._within + size - len(out)]
            out += take
            self._within += len(take)
            if len(out) < size:
                if self._next is None or not self._load_block(self._next):
                    break
                self._within = 0
        return bytes(out)

    def read_to(self, virtual_offset: int) -> bytes:
        """The bytes from the position up to `virtual_offset` (a CSI
        chunk's end, in this block or a later one)."""
        end_block, end_within = split_virtual_offset(virtual_offset)
        out = bytearray()
        while self._cache_start != end_block:
            out += self._cache[self._within:]
            if self._next is None or not self._load_block(self._next):
                return bytes(out)
            self._within = 0
        out += self._cache[self._within:end_within]
        self._within = max(self._within, end_within)
        return bytes(out)

    def read_at(self, uoffset: int, size: int) -> bytes:
        """`size` bytes at uncompressed offset `uoffset`, found through the
        .gzi."""
        if self.blocks is None:
            raise ValueError("read_at requires a .gzi index")
        blk = np.searchsorted(self.blocks["dstart"], uoffset, side="right") - 1
        self.seek(make_virtual_offset(int(self.blocks["rstart"][blk]),
                                      int(uoffset - self.blocks["dstart"][blk])))
        return self.read(size)

    def read_all(self) -> bytes:
        out = bytearray()
        coffset = 0
        while True:
            data = self._load_block(coffset)
            if not data:
                break
            out += data
            coffset = self._next
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
