"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a into its own shared library
with a plain C interface under build/lidog_tpu_torch/ of the checkout, at
first use, and loaded with ctypes.  `build()` starts one nvcc per source,
all at once.  A library is rebuilt when its source or a shared header is
newer.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lidog_tpu_torch"
SOURCES = ("zconv3_fwd", "zconv_down_fwd", "zconv_up_fwd", "zconv3_bwd_dx",
           "zconv3_wgrad", "zconv_wgrad", "bev_scatter_max", "zconv_full",
           "stem_feat125", "zseg_sweeps", "zseg_tables", "sparse_conv",
           "voxelize", "label_gather", "window_gather", "window_copy",
           "masked_bn", "instance_norm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures: every pointer and the stream are void*, sizes are int (a
# 64-bit key is long long), scalars of the arithmetic float.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    "zconv3_fwd": [_P] * 7 + [_I] * 4 + [_P],
    "zconv_down_fwd": [_P] * 6 + [_I] * 5 + [_P],
    "zconv_up_fwd": [_P] * 7 + [_I] * 5 + [_P],
    "zconv3_bwd_dx": [_P] * 7 + [_I] * 4 + [_P],
    "zconv3_wgrad": [_P] * 8 + [_I] * 8 + [_P],
    "zconv_down_wgrad": [_P] * 7 + [_I] * 7 + [_P],
    "zconv_up_wgrad": [_P] * 7 + [_I] * 7 + [_P],
    "bev_scatter_max_fwd": [_P] * 4 + [_I] * 9 + [_P],
    "bev_scatter_max_bwd": [_P] * 6 + [_I] * 9 + [_P],
    "zconv_full_fwd": [_P] * 6 + [_I] * 6 + [_P],
    "zconv_full_wgrad": [_P] * 6 + [_I] * 7 + [_P],
    "stem_feat125": [_P] * 6 + [_I] * 9 + [_P],
    "stem_conv9_packed": [_P] * 6 + [_I] * 9 + [_P],
    "conv9_packed": [_P] * 5 + [_I] * 8 + [_P],
    "pos3_lookup": [_P] * 5 + [_I] * 6 + [_P],
    "build_packed": [_P] * 5 + [_I] * 6 + [_P],
    "column_grid": [_P] * 10 + [_I] * 10 + [_P],
    "real_words": [_P] * 10 + [_I] * 8 + [_P],
    "assemble_aug": [_P] * 8 + [_I] * 5 + [_P],
    "emit_rows": [_P] * 15 + [_I] * 7 + [_P],
    "sparse_conv_fwd": [_P] * 6 + [_I] * 6 + [_P],
    "sparse_conv_wgrad": [_P] * 6 + [_I] * 9 + [_P],
    "voxelize": [_P] * 13 + [_I] * 3 + [_L, _I, _P],
    "label_gather": [_P] * 5 + [_I] * 5 + [_P],
    "window_row_gather": [_P] * 3 + [_I] * 3 + [_P],
    "window_lane_gather": [_P] * 3 + [_I] * 4 + [_P],
    "lane_gather_sum": [_P] * 3 + [_I] * 2 + [_P],
    "window_copy": [_P] * 3 + [_I] * 4 + [_P],
    "bn_act": [_P] * 7 + [_I] * 10 + [_P],
    "bn_train_stats": [_P] * 13 + [_I] * 8 + [_F, _F, _I, _P],
    "bn_bwd_reduce": [_P] * 17 + [_I] * 9 + [_F, _I, _P],
    "bn_bwd_apply": [_P] * 8 + [_I] * 9 + [_P],
    "instance_norm_fwd": [_P] * 13 + [_I] * 16 + [_F, _I, _P],
    "instance_norm_bwd": [_P] * 15 + [_I] * 16 + [_F, _I, _P],
}
# the source (library) of each C function that is not named after its own
_SOURCE_OF = {"zconv_down_wgrad": "zconv_wgrad",
              "zconv_up_wgrad": "zconv_wgrad",
              "bev_scatter_max_fwd": "bev_scatter_max",
              "bev_scatter_max_bwd": "bev_scatter_max",
              "zconv_full_fwd": "zconv_full", "zconv_full_wgrad": "zconv_full",
              "stem_conv9_packed": "zseg_sweeps", "conv9_packed": "zseg_sweeps",
              "pos3_lookup": "zseg_sweeps", "build_packed": "zseg_sweeps",
              "column_grid": "zseg_tables", "real_words": "zseg_tables",
              "assemble_aug": "zseg_tables", "emit_rows": "zseg_tables",
              "sparse_conv_fwd": "sparse_conv",
              "sparse_conv_wgrad": "sparse_conv",
              "window_row_gather": "window_gather",
              "window_lane_gather": "window_gather",
              "lane_gather_sum": "window_gather",
              "bn_act": "masked_bn", "bn_train_stats": "masked_bn",
              "bn_bwd_reduce": "masked_bn", "bn_bwd_apply": "masked_bn",
              "instance_norm_fwd": "instance_norm",
              "instance_norm_bwd": "instance_norm"}

_libs = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime
                 for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build(names=SOURCES) -> float:
    """Compile the stale libraries in parallel; returns the seconds taken.
    Each compiler log (with -Xptxas -v register and spill counts) is kept
    beside its library."""
    todo = [n for n in names if _stale(n)]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        log = open(BUILD_DIR / f"{n}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(_lib_path(n)) + ".tmp",
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                    log)
    failed = []
    for n, (p, log) in procs.items():
        rc = p.wait()
        log.close()
        if rc != 0:
            failed.append(n)
        else:
            os.replace(str(_lib_path(n)) + ".tmp", _lib_path(n))
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return time.perf_counter() - t0


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source (built first if needed), with the
    C signature of each of its functions set."""
    lib = _libs.get(source)
    if lib is None:
        build((source,))
        lib = ctypes.CDLL(str(_lib_path(source)))
        for fn_name, argtypes in _ARGTYPES.items():
            if _SOURCE_OF.get(fn_name, fn_name) == source:
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _libs[source] = lib
    return lib


_fns = {}  # C function name -> its ctypes function, bound once
_device = _raw_stream = None  # torch's current device and its raw stream


def _bind(name: str):
    """The ctypes function of C function `name` (its library built and
    loaded first if needed), kept for every later call."""
    global _device, _raw_stream
    import torch

    _device = torch._C._cuda_getDevice
    _raw_stream = torch._C._cuda_getCurrentRawStream
    fn = _fns[name] = getattr(library(_SOURCE_OF.get(name, name)), name)
    return fn


def call(name: str, *args) -> None:
    """Launch C function `name` on the current device's current stream
    (read at every call); raise on a CUDA error."""
    fn = _fns.get(name) or _bind(name)
    err = fn(*args, _raw_stream(_device()))
    if err == 1:  # cudaErrorInvalidValue
        raise RuntimeError(f"{name}: CUDA error 1 (invalid value): the entry "
                           "point refused these shapes or sizes (its limits "
                           "are stated in its source)")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
