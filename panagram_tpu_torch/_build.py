"""Build the native libraries into ``_built/`` beside this file at first use.

CUDA kernels (``build``): one ``nvcc`` per source of csrc/*.cu, all
started together, compiles each for Hopper (``sm_90a``) into an object
file; one more links them into ``_built/libpanagram_kernels.so``;
``ops/kernels.py`` loads it with ctypes.  A failed ``nvcc`` raises with its
output.

Host C++ (``build_host_library``): one ``g++`` call per library, e.g. the
BGZF compressor of native/bgzf_native.cpp; a missing compiler or a failed
compile raises naming why, and the caller decides how to go on.

A library is rebuilt when it is missing or older than its sources.  An
exclusive file lock serialises concurrent first uses (test workers, several
processes of one build), and a library appears under its final name only
once complete.
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

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v", "-c"]


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
        nvcc = nvcc_path()
        objs = [os.path.join(BUILD_DIR, os.path.basename(src)[:-3]
                             + f".{os.getpid()}.o") for src in sources()]
        cmds = [[nvcc, *COMPILE_FLAGS, "-o", o, src]
                for src, o in zip(sources(), objs)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT) for c in cmds]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=900)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        failed = [c for c, proc in zip(cmds, procs) if proc.returncode != 0]
        log = [" ".join(c) + "\n" + o.decode("utf-8", "replace")
               for c, o in zip(cmds, outs)]
        if not failed:
            link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
            res = subprocess.run(link, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, timeout=300)
            log.append(" ".join(link) + "\n"
                       + res.stdout.decode("utf-8", "replace"))
            if res.returncode != 0:
                failed = [link]
        seconds = time.perf_counter() - t0
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        with open(LOG_PATH, "w") as f:
            f.write("".join(log))
        if failed:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"nvcc failed: {' '.join(failed[0])}\n"
                               + "".join(log))
        os.replace(tmp, LIB_PATH)
        return seconds


HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-Wall"]


def build_host_library(source: str, name: str, libs=()) -> str:
    """Compile one C++ source with the host's g++ into _built/<name> (link
    flags `libs`, e.g. ["-lz"]) unless the library is newer than the
    source; returns its path.  Raises RuntimeError naming why when g++ is
    missing or fails (its first error line, e.g. a missing header)."""
    import fcntl

    lib = os.path.join(BUILD_DIR, name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".host.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.getmtime(lib) >= os.path.getmtime(source):
                return lib
        except OSError:
            pass
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler: g++ is not on PATH")
        tmp = f"{lib}.tmp.{os.getpid()}"
        res = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp, source, *libs],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             timeout=300)
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            out = res.stdout.decode("utf-8", "replace").splitlines()
            err = next((line for line in out if "error" in line),
                       out[-1] if out else f"exit code {res.returncode}")
            raise RuntimeError(f"g++ failed on {os.path.basename(source)}: "
                               f"{err.strip()}")
        os.replace(tmp, lib)
    return lib
