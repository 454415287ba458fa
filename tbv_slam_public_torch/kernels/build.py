"""Build and load the package's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` of this package (one
process per source, all started together; ``-gencode
arch=compute_90a,code=sm_90a``) and links them into one shared library with
a plain C interface (the ``csrc/*.cuh`` headers they include count
toward its name), placed under ``build/tbv_torch_kernels/`` at the
repository root and named by a hash of the sources and flags, and loads it
with ``ctypes``.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tbv_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
#: build record of the library in use: path, seconds, ptxas report
BUILD_INFO: dict = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the package's kernels")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + headers:
        with open(s, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libtbv_kernels_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    report = ""
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        outs = [p.communicate()[0] for p in procs]
        failed = [f"nvcc failed on {src} ({p.returncode}):\n{out}"
                  for src, p, out in zip(sources, procs, outs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("\n".join(failed))
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        for obj in objs:
            os.remove(obj)
        os.replace(tmp, path)
        report = "".join(outs)
    lib = ctypes.CDLL(path)
    # both entries: 4 clouds/masks, 4 row strides, 3 sizes, r^2, outputs,
    # scratch and its size, stream
    for fn in (lib.coral_moments_launch, lib.coral_pair_moments_launch):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + \
            [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 2 + \
            [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # op, strided, the call's description (kernels/refmath.py::OP_ARGS),
    # stream
    lib.refmath_op_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_void_p]
    lib.refmath_op_launch.restype = ctypes.c_int
    # op, kernel (vector, flat, strided), registers out, blocks a
    # multiprocessor out
    lib.refmath_op_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
    lib.refmath_op_info.restype = ctypes.c_int
    # site, the site's SiteArgs (kernels/refmath.py::SITE_ARGS), stream
    lib.refmath_site_launch.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                        ctypes.c_void_p]
    lib.refmath_site_launch.restype = ctypes.c_int
    # chain (kernels/refmath.py::CHAIN_KERNELS), its ChainArgs
    # (kernels/refmath.py::chain_struct), stream
    lib.refmath_chain_launch.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                         ctypes.c_void_p]
    lib.refmath_chain_launch.restype = ctypes.c_int
    # x, out, scratch, n, stream
    lib.refmath_cumsum_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p]
    lib.refmath_cumsum_launch.restype = ctypes.c_int
    # 5 inputs, 7 outputs, P, C, r2, weight_intensity, floor, min_neighbors,
    # max_cond, min_det, origin x, y, stream
    lib.cells_launch.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_float, ctypes.c_int] + [ctypes.c_float] * 4 + [
        ctypes.c_void_p]
    lib.cells_launch.restype = ctypes.c_int
    # theta, a, b, out, n, one_system, stream
    lib.refmath_lm_update_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.refmath_lm_update_launch.restype = ctypes.c_int
    # a, b, out, rows, cols, depth, stream
    lib.refmath_dot_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.refmath_dot_launch.restype = ctypes.c_int
    # x, v, out, rows, n, mode, interleave, epilogue width, stream
    lib.refmath_loop_dot_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.refmath_loop_dot_launch.restype = ctypes.c_int
    # h, g, out, n, k, stream
    lib.refmath_lu_solve_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.refmath_lu_solve_launch.restype = ctypes.c_int
    # h, final_score, n_res, cov, ok, n, p2l, fallback diagonal, stream
    lib.refmath_ceres_covariance_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int] + [ctypes.c_float] * 3 + [
        ctypes.c_void_p]
    lib.refmath_ceres_covariance_launch.restype = ctypes.c_int
    # 10 inputs, 3 outputs, rows, T, C, cost, loss, k0..k3, max_iter,
    # init_lambda, one_system, batch, cluster, stream
    lib.lm_solve_launch.argtypes = [ctypes.c_void_p] * 13 + \
        [ctypes.c_int] * 5 + [ctypes.c_float] * 4 + [
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
    lib.lm_solve_launch.restype = ctypes.c_int
    # the launch's EntryArgs (kernels/lm_solve.py::ENTRY_ARGS), stream
    for fn in (lib.register_window_launch, lib.evaluate_cost_launch):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # the launch's TailParams (kernels/coral_moments.py::TAIL_PARAMS),
    # cluster, cluster used out, stream
    lib.coral_tail_launch.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p]
    lib.coral_tail_launch.restype = ctypes.c_int
    # cov, scale, fallback, out, n, stream
    lib.refmath_sqrt_info_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_void_p]
    lib.refmath_sqrt_info_launch.restype = ctypes.c_int
    # desc, out, rows, R, S, ring, 1 / count, stream
    lib.sc_key_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_void_p]
    lib.sc_key_launch.restype = ctypes.c_int
    # the launch's RingArgs / PairArgs (kernels/refmath.py::SC_RING_ARGS,
    # SC_PAIR_ARGS), stream
    for fn in (lib.sc_ring_distance_launch, lib.sc_distance_launch):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    BUILD_INFO.update(path=path, seconds=time.perf_counter() - t0,
                      ptxas=report)
    _LIB = lib
    return lib
