"""Build the CUDA kernels (csrc/*.cu) into one shared library at first use.

``nvcc`` compiles every source for Hopper (``sm_90a``) into
``_built/libpanagram_kernels.so`` beside this file; ``ops/kernels.py``
loads it with ctypes.  The library is rebuilt when it is missing or older
than any source.  An exclusive file lock serialises concurrent first uses
(test workers, several processes of one build), and the library appears
under its final name only once complete.  A failed ``nvcc`` raises with its
output.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
import time

_DIR = os.path.dirname(os.path.realpath(__file__))
SRC_DIR = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_built")
LIB_PATH = os.path.join(BUILD_DIR, "libpanagram_kernels.so")
LOG_PATH = os.path.join(BUILD_DIR, "build.log")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def _stale() -> bool:
    try:
        built = os.path.getmtime(LIB_PATH)
    except OSError:
        return True
    return any(os.path.getmtime(s) > built for s in sources())


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels of panagram_tpu_torch are built "
                       "from csrc/ at first use")


def build(force: bool = False) -> float:
    """Compile the library if it is missing, stale or `force`d; returns the
    seconds spent compiling (0.0 when the library was current)."""
    import fcntl

    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and not _stale():
            return 0.0
        tmp = f"{LIB_PATH}.tmp.{os.getpid()}"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *sources()]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, timeout=900)
        seconds = time.perf_counter() - t0
        out = res.stdout.decode("utf-8", "replace")
        with open(LOG_PATH, "w") as f:
            f.write(" ".join(cmd) + "\n" + out)
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"nvcc failed (rc={res.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
        os.replace(tmp, LIB_PATH)
        return seconds
