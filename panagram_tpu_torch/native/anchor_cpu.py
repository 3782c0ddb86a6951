"""ctypes bindings of anchor_cpu.cpp: ``CpuAnchorer``, the multithreaded
host anchorer over an open-addressed hash of the dictionary, the CPU
baseline that the card's anchoring is measured against.

The library is built at import (``_build.build_host_library``, g++ with
``-lpthread``) into ``panagram_tpu_torch/_built/``.  Without g++, or when
the compile fails, the import raises OSError naming why: a missing
baseline must not pass for a slower one, so there is no fallback.

panagram_tpu's library also holds ``acpu_rle_expand`` and
``acpu_rle_expand_pal``, the host decoders of its run-length anchor
protocols (v3 / v4).  The port copies dense chunk results back and has no
such protocol, so they are not ported.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .._build import build_host_library

SOURCE = os.path.join(os.path.dirname(os.path.realpath(__file__)),
                      "anchor_cpu.cpp")
MAX_WORDS = 8

try:
    LIB_PATH = build_host_library(SOURCE, "libanchor_cpu.so", ["-lpthread"])
    _lib = ctypes.CDLL(LIB_PATH)
except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
    raise OSError(f"panagram_tpu_torch: the host anchorer is unavailable "
                  f"({e})") from e

_vp, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_lib.acpu_build.restype = _vp
_lib.acpu_build.argtypes = [_vp, _vp, _ll, _i]
_lib.acpu_free.restype = None
_lib.acpu_free.argtypes = [_vp]
_lib.acpu_anchor.restype = None
_lib.acpu_anchor.argtypes = [_vp, _vp, _ll, _i, _i, _vp, _vp, _i]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class CpuAnchorer:
    """Multithreaded anchoring on the host, as
    panagram_tpu.native.anchor_cpu.CpuAnchorer.

    keys: CANONICAL k-mers (numpy uint64 [D]; not splitmix-mixed, so not
    the keys of a ``--device-dict`` pandict.npz); masks: uint32 [D, W]
    (or [D]), W <= 8."""

    def __init__(self, keys: np.ndarray, masks: np.ndarray):
        keys = np.ascontiguousarray(keys, np.uint64)
        masks = np.ascontiguousarray(masks, np.uint32)
        if masks.ndim == 1:
            masks = masks[:, None]
        self.nwords = masks.shape[1]
        if self.nwords > MAX_WORDS:
            raise ValueError("CpuAnchorer supports up to 256 genomes")
        self._h = _lib.acpu_build(_ptr(keys), _ptr(masks), len(keys),
                                  self.nwords)

    def anchor(self, codes: np.ndarray, k: int, nbytes: int,
               threads: int | None = None, out=None):
        """codes uint8 [L] -> (bytes uint8 [P, nbytes], popc int32 [P]),
        P = L - k + 1, on `threads` threads (all cores by default).
        `out=(out_b, out_p)` writes into the caller's C-contiguous buffers
        of those shapes and dtypes; other buffers raise ValueError, where
        panagram_tpu's asserts."""
        if not (1 <= k <= 32 and 0 <= nbytes <= 4 * MAX_WORDS):
            raise ValueError(f"CpuAnchorer.anchor: k={k}, nbytes={nbytes}")
        codes = np.ascontiguousarray(codes, np.uint8)
        P = len(codes) - k + 1
        if P <= 0:
            return np.zeros((0, nbytes), np.uint8), np.zeros(0, np.int32)
        if out is not None:
            out_b, out_p = out
            if not (out_b.shape == (P, nbytes) and out_b.dtype == np.uint8
                    and out_p.shape == (P,) and out_p.dtype == np.int32
                    and out_b.flags.c_contiguous
                    and out_p.flags.c_contiguous):
                raise ValueError(
                    f"CpuAnchorer.anchor: out= wants C-contiguous uint8 "
                    f"[{P}, {nbytes}] and int32 [{P}] arrays, got "
                    f"{out_b.dtype} {out_b.shape}, {out_p.dtype} "
                    f"{out_p.shape}")
        else:
            out_b = np.empty((P, nbytes), np.uint8)
            out_p = np.empty(P, np.int32)
        _lib.acpu_anchor(self._h, _ptr(codes), len(codes), k, nbytes,
                         _ptr(out_b), _ptr(out_p),
                         threads if threads else (os.cpu_count() or 1))
        return out_b, out_p

    def __del__(self):
        if getattr(self, "_h", None):
            _lib.acpu_free(self._h)
            self._h = None
