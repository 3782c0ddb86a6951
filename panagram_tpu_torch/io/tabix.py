"""Tabix-style indexed BED files: BGZF compression + CSI index.

``write_tabix`` writes the files of ``panagram_tpu.io.tabix``: CSI v1
(min_shift=14, depth=5, the htslib defaults of ``tabix --csi``, deeper
when coordinates need it), byte-identical to panagram_tpu's for the same
rows.  ``TabixFile`` reads them (or htslib's): ``fetch(chrom, start, end)``
yields the records overlapping [start, end) as tuples of column strings.
"""

from __future__ import annotations

import struct

from .bgzf import BgzfReader, BgzfWriter, make_virtual_offset

MIN_SHIFT = 14
DEPTH = 5
# tabix preset for BED (TBX_UCSC): 0-based half-open
TBX_PRESET_BED = 0x10000


def _reg2bin(beg: int, end: int, min_shift: int = MIN_SHIFT,
             depth: int = DEPTH) -> int:
    """The smallest bin holding [beg, end) (CSI spec reg2bin)."""
    end -= 1
    s = min_shift
    t = ((1 << depth * 3) - 1) // 7
    lvl = depth
    while lvl > 0:
        if beg >> s == end >> s:
            return t + (beg >> s)
        lvl -= 1
        s += 3
        t -= 1 << (lvl * 3)
    return 0


def _reg2bins(beg: int, end: int, min_shift: int = MIN_SHIFT,
              depth: int = DEPTH) -> list[int]:
    """All bins that may overlap [beg, end) (CSI spec reg2bins)."""
    bins = []
    end -= 1
    t = 0
    s = min_shift + depth * 3
    for lvl in range(depth + 1):
        bins.extend(range(t + (beg >> s), t + (end >> s) + 1))
        s -= 3
        t += 1 << (lvl * 3)
    return bins


def _linear_index(lw: dict[int, int]) -> list[int]:
    """htslib's gap-filled linear index: for each min_shift window the
    smallest virtual offset of a record overlapping it, unset windows
    taking the previous value (leading gaps 0)."""
    if not lw:
        return []
    filled = [0] * (max(lw) + 1)
    cur = 0
    for i in range(len(filled)):
        cur = lw.get(i, cur)
        filled[i] = cur
    return filled


def _bin_loffset(lidx: list[int], b: int, depth: int) -> int:
    """htslib loffset: the linear index at the bin's first min_shift
    window, i.e. the first record overlapping the bin's interval."""
    if not lidx:
        return 0
    t = 0
    level = 0
    for lvl in range(depth + 1):
        size = 1 << (3 * lvl)
        if b < t + size:
            level = lvl
            break
        t += size
    w0 = (b - t) << (3 * (depth - level))
    return lidx[min(w0, len(lidx) - 1)]


def write_tabix(rows, bgz_path: str, csi_path: str | None = None,
                seq_col: int = 0, beg_col: int = 1, end_col: int = 2):
    """Write rows (sequences of str-able values, sorted by (chrom, start))
    as tab-separated BGZF + .csi.  Returns (bgz_path, csi_path)."""
    if csi_path is None:
        csi_path = bgz_path + ".csi"
    rows = list(rows)
    max_end = max((int(r[end_col]) for r in rows), default=0)
    depth = DEPTH
    while max_end >= 1 << (MIN_SHIFT + 3 * depth):
        depth += 1

    names: list[str] = []
    name_idx: dict[str, int] = {}
    ref_bins: list[dict[int, list[tuple[int, int]]]] = []
    ref_lw: list[dict[int, int]] = []
    w = BgzfWriter(bgz_path)

    def cur_voffset() -> int:
        # buffered data lands in the block that starts at w._coffset
        return make_virtual_offset(w._coffset, len(w._buf))

    try:
        for row in rows:
            chrom = str(row[seq_col])
            beg = int(row[beg_col])
            end = max(int(row[end_col]), beg + 1)
            if chrom not in name_idx:
                name_idx[chrom] = len(names)
                names.append(chrom)
                ref_bins.append({})
                ref_lw.append({})
            vbeg = cur_voffset()
            w.write(("\t".join(str(x) for x in row) + "\n").encode())
            vend = cur_voffset()
            rid = name_idx[chrom]
            ref_bins[rid].setdefault(_reg2bin(beg, end, MIN_SHIFT, depth),
                                     []).append((vbeg, vend))
            lw = ref_lw[rid]
            for wdw in range(beg >> MIN_SHIFT, ((end - 1) >> MIN_SHIFT) + 1):
                if wdw not in lw or vbeg < lw[wdw]:
                    lw[wdw] = vbeg
    finally:
        w.close()

    with open(csi_path, "wb") as f:
        f.write(b"CSI\x01")
        f.write(struct.pack("<ii", MIN_SHIFT, depth))
        nm = b"".join(n.encode() + b"\x00" for n in names)
        aux = struct.pack("<7i", TBX_PRESET_BED, seq_col + 1, beg_col + 1,
                          end_col + 1, ord("#"), 0, len(nm)) + nm
        f.write(struct.pack("<i", len(aux)))
        f.write(aux)
        f.write(struct.pack("<i", len(ref_bins)))
        for bins, lw in zip(ref_bins, ref_lw):
            lidx = _linear_index(lw)
            f.write(struct.pack("<i", len(bins)))
            for b in sorted(bins):
                merged: list[tuple[int, int]] = []
                for c in sorted(bins[b]):
                    if merged and c[0] <= merged[-1][1]:
                        merged[-1] = (merged[-1][0], max(merged[-1][1], c[1]))
                    else:
                        merged.append(c)
                f.write(struct.pack("<IQi", b, _bin_loffset(lidx, b, depth),
                                    len(merged)))
                for cb, ce in merged:
                    f.write(struct.pack("<QQ", cb, ce))
        f.write(struct.pack("<Q", 0))  # n_no_coor
    return bgz_path, csi_path


class TabixFile:
    """The reader of panagram_tpu.io.tabix.TabixFile (pysam.TabixFile's
    fetch): ``fetch(chrom, start, end)`` yields tuples of column strings of
    the records with start < end and end > start; an unknown contig raises
    ValueError; ``fetch()`` yields every record."""

    def __init__(self, bgz_path: str, csi_path: str | None = None):
        self._reader = BgzfReader(bgz_path)
        self._load_csi(csi_path or bgz_path + ".csi")

    def _load_csi(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"CSI\x01":
            raise ValueError(f"{path}: not a CSI index")
        self.min_shift, self.depth = struct.unpack_from("<ii", data, 4)
        (l_aux,) = struct.unpack_from("<i", data, 12)
        aux = data[16:16 + l_aux]
        off = 16 + l_aux
        _, sc, bc, ec, _, _, l_nm = struct.unpack_from("<7i", aux, 0)
        self.seq_col, self.beg_col, self.end_col = sc - 1, bc - 1, ec - 1
        self.names = [n.decode() for n in aux[28:28 + l_nm].split(b"\x00")[:-1]]
        self.name_idx = {n: i for i, n in enumerate(self.names)}
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        # per reference: bin -> (loffset, chunks); loffset is the virtual
        # offset of the first record overlapping the bin's interval (the
        # CSI form of tabix's linear index), which prunes chunks
        self.ref_bins: list[dict[int, tuple[int, list[tuple[int, int]]]]] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins = {}
            for _ in range(n_bin):
                b, loffset, n_chunk = struct.unpack_from("<IQi", data, off)
                off += 16
                chunks = [struct.unpack_from("<QQ", data, off + 16 * i)
                          for i in range(n_chunk)]
                off += 16 * n_chunk
                bins[b] = (loffset, chunks)
            self.ref_bins.append(bins)

    @property
    def contigs(self) -> list[str]:
        return list(self.names)

    def fetch(self, chrom=None, start=None, end=None, **kw):
        if chrom is None:
            for name in self.names:
                yield from self.fetch(name)
            return
        if chrom not in self.name_idx:
            raise ValueError(f"unknown contig {chrom!r}")
        bins = self.ref_bins[self.name_idx[chrom]]
        start = 0 if start is None else start
        if end is None:
            end = 1 << (self.min_shift + self.depth * 3)
        # htslib's min_off: the loffset of the leaf bin holding `start`, or
        # of its nearest present ancestor, bounds the first record that can
        # overlap; chunks ending before it are skipped, others clipped
        b = ((1 << self.depth * 3) - 1) // 7 + (start >> self.min_shift)
        min_off = 0
        while True:
            if b in bins:
                min_off = bins[b][0]
                break
            if b == 0:
                break
            b = (b - 1) >> 3
        chunks = set()
        for b in _reg2bins(start, max(end, start + 1), self.min_shift,
                           self.depth):
            if b in bins:
                chunks.update(bins[b][1])
        runs: list[tuple[int, int]] = []
        for cb, ce in sorted(chunks):
            if ce <= min_off:
                continue
            cb = max(cb, min_off)
            if runs and cb <= runs[-1][1]:   # overlapping: one read
                runs[-1] = (runs[-1][0], max(runs[-1][1], ce))
            else:
                runs.append((cb, ce))
        for cb, ce in runs:
            self._reader.seek(cb)
            for line in self._reader.read_to(ce).split(b"\n"):
                if not line:
                    continue
                cols = line.decode().split("\t")
                try:
                    rbeg = int(cols[self.beg_col])
                    rend = int(cols[self.end_col])
                except (ValueError, IndexError):
                    continue
                if rbeg < end and rend > start:
                    yield tuple(cols)

    def close(self):
        self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
