# -*- coding: utf-8 -*-
"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The
library lives in ``george_tpu_torch/_build/`` under a name keyed on a hash
of the sources and the flags, so an edited source rebuilds at its next use
and an unchanged one is reused across processes. The build runs at first
use, never at import; a missing ``nvcc`` or a failed compile raises with
the compiler's output.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

__all__ = ["load", "build", "BUILD_DIR", "CSRC_DIR"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_info = {}   # what the last build did: seconds, compiler log, path


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError("no CUDA sources under %s" % CSRC_DIR)
    return srcs


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels of george_tpu_torch are built from source at first use"
    )


def _key(srcs):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile the sources if no library for their hash exists yet; return
    the library's path."""
    srcs = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, "libgeorge_kernels_%s.so" % _key(srcs))
    if os.path.exists(out):
        if build_info.get("path") != out:   # built by an earlier process
            build_info.update(path=out, seconds=0.0, log="(cached)")
        return out
    t0 = time.perf_counter()
    # compile to a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            "nvcc failed (exit %d): %s\n%s%s"
            % (proc.returncode, " ".join(cmd), proc.stdout, proc.stderr)
        )
    os.replace(tmp, out)
    build_info.update(path=out, seconds=time.perf_counter() - t0,
                      log=proc.stdout + proc.stderr)
    return out


def load():
    """The loaded kernel library (built first if needed), with the
    ``argtypes``/``restype`` of every exported function declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("george_chol_f32", "george_chol_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, i32, i32, ptr]
            fn.restype = i32
        lib.george_chol_uses_smem.argtypes = [i32, i32]
        lib.george_chol_uses_smem.restype = i32
        _lib = lib
    return _lib
