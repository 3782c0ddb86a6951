"""The port's native BGZF compressor (native/bgzf_native.cpp, built at first
use with g++) against the Python zlib path, and the BGZF reader's
virtual-offset interface, on the CPU.

Every comparison is byte for byte (tolerance 0): the native compressor and
Python's zlib.compressobj(6, DEFLATED, -15) run the same deflate with the
same settings on the same libz, so their blocks must be equal, and so must
files written through either, and a build's bitmap files must equal
panagram_tpu's.
"""

import os
import struct
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from panagram_tpu.io.bgzf import BgzfWriter as JaxBgzfWriter
from panagram_tpu.pipeline import build_index as jax_build_index
from panagram_tpu_torch import _build
from panagram_tpu_torch.io import bgzf
from panagram_tpu_torch.io.bgzf import (
    MAX_BLOCK_DATA,
    BgzfReader,
    BgzfWriter,
    compress_block,
    make_virtual_offset,
    split_virtual_offset,
)
from panagram_tpu_torch.native import bgzf_native
from panagram_tpu_torch.pipeline import build_index
from tests.test_torch_index import assert_same_file, write_fixture

torch.set_num_threads(2)


def block_inputs():
    """name -> bytes: whole blocks of several kinds, short and empty ones."""
    rng = np.random.default_rng(7)
    masks = rng.integers(0, 2, (MAX_BLOCK_DATA // 4, 30), dtype=np.uint8)
    masks[rng.random(len(masks)) < 0.9] = 1        # mostly all present
    return {
        "random": rng.integers(0, 256, MAX_BLOCK_DATA, np.uint8).tobytes(),
        "zeros": bytes(MAX_BLOCK_DATA),
        "incompressible": os.urandom(MAX_BLOCK_DATA),
        "bases": rng.integers(0, 4, MAX_BLOCK_DATA, np.uint8).tobytes(),
        "bitmap": np.packbits(masks, axis=1, bitorder="little").tobytes(),
        "text": (b"chr1\t100\t200\tgene\tG1\n" * 4000)[:MAX_BLOCK_DATA],
        "short": rng.integers(0, 256, 4097, np.uint8).tobytes(),
        "one": b"\x01",
        "empty": b"",
    }


@pytest.fixture(scope="module")
def native():
    assert bgzf_native.status() == "native", bgzf_native.status()
    return bgzf_native


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("kind", list(block_inputs()))
def test_native_block_equals_zlib(native, kind, level):
    data = block_inputs()[kind]
    block = native.compress_block(data, level)
    assert block == compress_block(data, level)
    assert zlib.decompress(block[18:-8], -15) == data
    assert struct.unpack("<II", block[-8:]) == (zlib.crc32(data), len(data))


def test_stored_fallback_is_unreachable(native):
    """A block is stored (level 0) only when level 6 deflates it to more
    than 65,510 bytes, so that the block would pass 64 KiB.  No input of
    MAX_BLOCK_DATA bytes can: zlib's deflateBound for 65,280 bytes is about
    65,305 (incompressible data goes into stored deflate blocks of 5 bytes'
    overhead each), so neither path ever takes the fallback.  This checks
    that the worst inputs stay under the limit and agree."""
    for _ in range(5):
        data = os.urandom(MAX_BLOCK_DATA)
        block = native.compress_block(data)
        assert block == compress_block(data)
        assert len(block) - 26 <= 65_510
        assert len(block) - 26 <= MAX_BLOCK_DATA + 5 * -(-MAX_BLOCK_DATA // 16_383) + 2


def test_compress_buffer_equals_blocks(native):
    rng = np.random.default_rng(1)
    for n in (0, 1, MAX_BLOCK_DATA, 3 * MAX_BLOCK_DATA, 5 * MAX_BLOCK_DATA + 999):
        data = rng.integers(0, 4, n, np.uint8).tobytes()
        out, sizes = native.compress_buffer(data)
        blocks = [compress_block(data[i:i + MAX_BLOCK_DATA])
                  for i in range(0, n, MAX_BLOCK_DATA)]
        assert out == b"".join(blocks)
        assert list(sizes) == [len(b) for b in blocks]


@pytest.mark.parametrize("kind", list(block_inputs()))
def test_native_decompress_block(native, kind):
    data = block_inputs()[kind]
    block = compress_block(data)
    assert native.decompress_block(block[18:-8], len(data)) == data


def write_pattern(writer_cls, path, data, pattern):
    """Write `data` in the pieces of `pattern`; returns the block table."""
    with writer_cls(str(path)) as w:
        if pattern == "one":
            w.write(data)
        elif pattern == "odd":
            for i in range(0, len(data), 37_777):
                w.write(data[i:i + 37_777])
        elif pattern == "rows":          # 2-D rows and strided views
            a = np.frombuffer(data, np.uint8).reshape(-1, 5)
            w.write(a[:70_001])
            w.write(a[70_001::3].copy())
            w.write(a[70_001::3][::-1])
            w.write(memoryview(a[-7:]))
        elif pattern == "blocks":        # exact blocks, empty writes
            w.write(b"")
            for i in range(0, len(data), MAX_BLOCK_DATA):
                w.write(data[i:i + MAX_BLOCK_DATA])
                w.write(b"")
    w.write_gzi(str(path) + ".gzi")


@pytest.mark.parametrize("pattern", ["one", "odd", "rows", "blocks"])
def test_writer_native_equals_zlib_and_jax(native, tmp_path, monkeypatch,
                                           pattern):
    """The same writes through the native writer, the zlib writer and
    panagram_tpu's writer give the same .gz and .gzi bytes."""
    rng = np.random.default_rng(2)
    data = rng.integers(0, 4, 20 * MAX_BLOCK_DATA + 12_345,
                        np.uint8).tobytes()
    write_pattern(BgzfWriter, tmp_path / "n.gz", data, pattern)
    write_pattern(JaxBgzfWriter, tmp_path / "j.gz", data, pattern)
    monkeypatch.setattr(bgzf, "_native", lambda: None)
    write_pattern(BgzfWriter, tmp_path / "z.gz", data, pattern)
    for ext in ("gz", "gz.gzi"):
        n = (tmp_path / f"n.{ext}").read_bytes()
        assert n == (tmp_path / f"z.{ext}").read_bytes()
        assert n == (tmp_path / f"j.{ext}").read_bytes()


def test_writers_in_threads(native, tmp_path):
    """Eight writers in eight threads at once (the --cores route), each
    compressing on its own pool, with a short switch interval: every file
    equals the one written alone."""
    rng = np.random.default_rng(3)
    datas = [rng.integers(0, 4, 9 * MAX_BLOCK_DATA + i, np.uint8).tobytes()
             for i in range(8)]
    for i, d in enumerate(datas):
        write_pattern(BgzfWriter, tmp_path / f"alone{i}.gz", d, "odd")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=write_pattern, args=(
            BgzfWriter, tmp_path / f"t{i}.gz", d, "odd"))
            for i, d in enumerate(datas)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for i in range(8):
        assert (tmp_path / f"t{i}.gz").read_bytes() == \
            (tmp_path / f"alone{i}.gz").read_bytes()


@pytest.mark.parametrize("inflate", ["native", "zlib"])
def test_reader_virtual_offsets(native, tmp_path, monkeypatch, inflate):
    """tests/test_io.py's virtual-offset read, reads across blocks and to a
    chunk's end, through either inflater."""
    if inflate == "zlib":
        monkeypatch.setattr(bgzf, "_native", lambda: None)
    data = bytes(range(256)) * 1000
    with BgzfWriter(str(tmp_path / "z.gz")) as w:
        w.write(data)
    blocks = w._blocks
    r = BgzfReader(str(tmp_path / "z.gz"))
    c1, u1 = blocks[0]
    assert r.seek(make_virtual_offset(c1, 5)) == (c1 << 16) | 5
    assert r.read(10) == data[u1 + 5:u1 + 15]
    assert split_virtual_offset(make_virtual_offset(c1, 5)) == (c1, 5)
    # across the next block's start, then to the end
    r.seek(make_virtual_offset(c1, MAX_BLOCK_DATA - 4))
    assert r.read(10) == data[u1 + MAX_BLOCK_DATA - 4:u1 + MAX_BLOCK_DATA + 6]
    r.seek(make_virtual_offset(0, 100))
    assert r.read(len(data)) == data[100:]
    assert r.read(10) == b""
    # read_to: within a block and across two
    r.seek(make_virtual_offset(0, 3))
    assert r.read_to(make_virtual_offset(0, 40)) == data[3:40]
    c2, u2 = blocks[1]
    r.seek(make_virtual_offset(0, 65_000))
    assert r.read_to(make_virtual_offset(c2, 7)) == data[65_000:u2 + 7]
    with pytest.raises(ValueError):
        make_virtual_offset(0, 65536)
    r.close()


def test_degrades_to_zlib_without_a_compiler(tmp_path, monkeypatch, capsys):
    """Without a toolchain the writer uses Python's zlib (the same bytes)
    and says why, once, on stderr."""
    data = np.random.default_rng(4).integers(0, 4, 3 * MAX_BLOCK_DATA + 5,
                                             np.uint8).tobytes()
    write_pattern(BgzfWriter, tmp_path / "n.gz", data, "odd")

    def no_compiler(*args, **kwargs):
        raise RuntimeError("no host C++ compiler: g++ is not on PATH")

    monkeypatch.setattr(bgzf_native, "_state", {})
    monkeypatch.setattr(bgzf_native, "build_host_library", no_compiler)
    capsys.readouterr()
    write_pattern(BgzfWriter, tmp_path / "z.gz", data, "odd")
    assert bgzf_native.load() is None
    assert bgzf_native.status() == \
        "zlib (no host C++ compiler: g++ is not on PATH)"
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and "g++ is not on PATH" in err[0]
    assert (tmp_path / "z.gz").read_bytes() == (tmp_path / "n.gz").read_bytes()
    with pytest.raises(RuntimeError, match="unavailable"):
        bgzf_native.compress_block(b"x")


def test_build_host_library_names_the_failure(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("#include <no_such_header_here.h>\nint f() { return 0; }\n")
    with pytest.raises(RuntimeError, match="no_such_header_here.h"):
        _build.build_host_library(str(src), f"libbroken_{os.getpid()}.so")
    assert not any(f.startswith(f"libbroken_{os.getpid()}")
                   for f in os.listdir(_build.BUILD_DIR))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ is not on PATH"):
        _build.build_host_library(str(src), f"libnone_{os.getpid()}.so")


def test_build_with_native_compressor_is_byte_identical(native,
                                                        tmp_path_factory):
    """The 3-genome fixture built by the port, its blocks compressed by the
    native library: every file equals panagram_tpu's (assert_same_file)."""
    tmp = tmp_path_factory.mktemp("native_build")
    samples = write_fixture(tmp, np.random.default_rng(1234))
    jax_build_index(str(samples), prefix=str(tmp / "jax"), k=11)
    build_index(str(samples), prefix=str(tmp / "port"), k=11, device="cpu")
    n = 0
    for g in ("g1", "g2", "g3"):
        for f in ("bitmap.1.gz", "bitmap.1.gzi", "bitmap.100.gz",
                  "bitmap.100.gzi", "chrs.tsv", "bitsum.bins.tsv"):
            assert_same_file(str(tmp / "port" / "anchor" / g / f),
                             str(tmp / "jax" / "anchor" / g / f))
            n += 1
    assert n == 18
