"""ctypes bindings of bgzf_native.cpp: BGZF blocks deflated and inflated by
zlib in C++.

The library is built at first use (``_build.build_host_library``, g++ with
``-lz``) into ``panagram_tpu_torch/_built/``.  ``load()`` returns it, or
None when it cannot be built or loaded; the reason is printed once on
stderr and kept in ``status()``, and io/bgzf.py then uses Python's zlib,
which gives the same bytes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

from .._build import build_host_library

SOURCE = os.path.join(os.path.dirname(os.path.realpath(__file__)),
                      "bgzf_native.cpp")
BLOCK_CAP = 65536          # a BGZF block's largest size, header and footer
MAX_BLOCK_DATA = 0xFF00    # uncompressed bytes per block

_lock = threading.Lock()
_state: dict = {}          # {"lib": ctypes.CDLL} or {"error": str}


def _declare(lib):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bgzf_compress_block.restype = i
    lib.bgzf_compress_block.argtypes = [vp, i, vp, i]
    lib.bgzf_decompress_block.restype = i
    lib.bgzf_decompress_block.argtypes = [vp, i, vp, i]
    lib.bgzf_compress_buffer.restype = ll
    lib.bgzf_compress_buffer.argtypes = [vp, ll, vp, vp, i]


def load():
    """The library (built first if missing or stale), or None when the
    host has no g++, no zlib.h or cannot load it."""
    with _lock:
        if not _state:
            try:
                lib = ctypes.CDLL(build_host_library(SOURCE,
                                                     "libbgzf_native.so",
                                                     ["-lz"]))
                _declare(lib)
                _state["lib"] = lib
            except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
                _state["error"] = str(e)
                print("panagram_tpu_torch: BGZF blocks are compressed with "
                      f"Python's zlib: the native compressor is unavailable "
                      f"({e})", file=sys.stderr)
        return _state.get("lib")


def status() -> str:
    """'native', or 'zlib (<why the library is unavailable>)'."""
    return "native" if load() is not None else f"zlib ({_state['error']})"


def _lib():
    lib = load()
    if lib is None:
        raise RuntimeError(f"bgzf_native unavailable: {_state['error']}")
    return lib


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def compress_block(data, level: int = 6) -> bytes:
    """One BGZF block of `data` (any buffer of at most MAX_BLOCK_DATA
    bytes)."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(BLOCK_CAP, np.uint8)
    n = _lib().bgzf_compress_block(_ptr(src), len(src), _ptr(out), level)
    if n < 0:
        raise RuntimeError("bgzf_compress_block failed")
    return out[:n].tobytes()


def decompress_block(payload, isize: int) -> bytes:
    """The `isize` bytes a block's raw-deflate payload inflates to."""
    src = np.frombuffer(payload, np.uint8)
    out = np.empty(max(isize, 1), np.uint8)
    n = _lib().bgzf_decompress_block(_ptr(src), len(src), _ptr(out), len(out))
    if n < 0:
        raise RuntimeError("bgzf_decompress_block failed")
    return out[:n].tobytes()


def compress_buffer(data, level: int = 6) -> tuple[bytes, np.ndarray]:
    """`data` (any buffer) cut every MAX_BLOCK_DATA bytes into BGZF blocks
    in one call: (the blocks back to back, each block's size int32)."""
    src = np.frombuffer(data, np.uint8)
    nblocks = max(1, -(-len(src) // MAX_BLOCK_DATA))
    out = np.empty(nblocks * BLOCK_CAP, np.uint8)
    sizes = np.zeros(nblocks, np.int32)
    n = _lib().bgzf_compress_buffer(_ptr(src), len(src), _ptr(out),
                                    _ptr(sizes), level)
    if n < 0:
        raise RuntimeError("bgzf_compress_buffer failed")
    return out[:n].tobytes(), sizes[:nblocks if len(src) else 0]
