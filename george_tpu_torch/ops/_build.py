# -*- coding: utf-8 -*-
"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``
(all started together, so the build takes as long as the slowest source),
and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. The library lives in
``george_tpu_torch/_build/`` under a name keyed on a hash of the sources
and the flags, so an edited source rebuilds at its next use
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    nvcc = _nvcc()
    # private scratch, then rename: a concurrent process never loads a
    # half-written library
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    jobs = []
    try:
        for src in srcs:
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append("nvcc failed (exit %d): %s\n%s"
                              % (proc.returncode, " ".join(cmd), logs[-1]))
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(work, "lib.so")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
               *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed (exit %d): %s\n%s%s"
                               % (proc.returncode, " ".join(cmd),
                                  proc.stdout, proc.stderr))
        os.replace(tmp, out)
    finally:
        for _, _, proc in jobs:           # none outlives a failed build
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    build_info.update(path=out, seconds=time.perf_counter() - t0,
                      log="".join(logs))
    return out


def load():
    """The loaded kernel library (built first if needed), with the
    ``argtypes``/``restype`` of every exported function declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # A, L, scratch, B, m, then the launch plan (variant, threads per
        # block, blocks per CTA, shared bytes), then the stream
        chol_plan = [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
        dia_plan = [ptr, ptr, ptr, ptr, i64, i32, i32, i32, ptr, ptr]
        cg_step = [ptr] * 9 + [i64, i32, ctypes.c_double, i32, i32, i32, ptr]
        signatures = {
            "george_chol_f32": chol_plan,
            "george_chol_f64": chol_plan,
            "george_chol_tile_f32": chol_plan,
            "george_chol_tile_f64": chol_plan,
            "george_chol_device_limits": [ptr],
            # vals, diag, y, out, n, D, d_min, r, the launch plan (18 ints,
            # ops/dia.py::_plan_words), the stream
            "george_dia_f32": dia_plan,
            "george_dia_f64": dia_plan,
            "george_dia_prepare": [],
            # itemsize, n, r, out (grid, shared bytes)
            "george_cg_plan": [i32, i64, i32, ptr],
            # X, R, P, AP, minv, rz, b2, state, work, n, r, tol2, maxiter,
            # grid, shared bytes, the stream
            "george_cg_step_f32": cg_step,
            "george_cg_step_f64": cg_step,
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i32
        _lib = lib
    return _lib
