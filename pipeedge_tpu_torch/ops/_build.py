"""Build and load the port's CUDA kernels; count their launches.

At first use, every `csrc/*.cu` is compiled for Hopper (`sm_90a`) with
`nvcc`, one process per source started together, and the objects are
linked into one shared library with a plain C interface, loaded through
`ctypes`. The library's name carries a hash of the sources and flags, so
an edit rebuilds and a stale build is never loaded. The build directory
(`pipeedge_tpu_torch/_build/`) is listed in `.gitignore`.

Every C entry point takes its pointers and the CUDA stream as `void *`
and returns `cudaGetLastError()` after its launches; `check` raises on a
nonzero code, so a refused launch never passes silently. There is no
fallback: a failed build or launch raises.

`launch_counts` holds one plain integer per kernel wrapper. A wrapper
adds one where it launches its kernel (CUDA tensors only), so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

KERNELS = ("fused_encode", "fused_decode", "fused_attention", "int8_matmul",
           "decode_attention")
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}

# the most blocks a grid takes along y or z: a kernel whose grid carries
# the items (the encode) or batch cells (the decode attention) there is
# launched once per `launch_chunks` range
MAX_GRID_YZ = 65535

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_seconds: Optional[float] = None
ptxas_log: str = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# C signatures (csrc/*.cu, `extern "C"`); every entry returns cudaError_t
_SIGNATURES = {
    # x, data, scale, shift, B, n, bit, blocks per item, slice, vec, stream
    "pe_fused_encode": [_P, _P, _P, _P, _L, _L, _I, _I, _L, _I, _P],
    # data, scale, shift, out, B, n, bit, vec, stream
    "pe_fused_decode": [_P, _P, _P, _P, _L, _L, _I, _I, _P],
    # q, k, v, o, dtype, B, H, S, D, stride_b, stride_h, stride_s,
    # causal, stream
    "pe_fused_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _L, _L, _L, _I, _P],
    # x, xs, wt, ws, out, M, N, K, bk, xs_row_stride, xs_col_stride, flip,
    # stream
    "pe_int8_matmul": [_P, _P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _I, _P],
    # the same arguments, on the wgmma kernel
    "pe_int8_matmul_wgmma": [_P, _P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _I,
                             _P],
    # q, k_new, v_new, k_q, v_q, k_scale, k_shift, v_scale, v_shift, out,
    # dtype, B, H, D, pos, kv_stride_b, kv_stride_row, scale_stride_b,
    # scale_stride_row, scale, stream
    "pe_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _L, _L, _L, _L, _L, _F, _P],
    # pos -> the number of row ranges (cluster size) of the launch
    "pe_decode_attention_splits": [_L],
}


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def launch_chunks(n: int, size: int = MAX_GRID_YZ) -> List[Tuple[int, int]]:
    """The [start, end) ranges, at most `size` long, that cover [0, n)
    once and in order: one launch each."""
    return [(s, min(n, s + size)) for s in range(0, n, size)]


def _sources(csrc: Path) -> List[Path]:
    return sorted(csrc.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "pipeedge_tpu_torch are built on a host with "
                           "the CUDA toolkit")
    return nvcc


def build(csrc: Path = CSRC) -> Path:
    """Compile every `csrc`/*.cu in parallel and link one .so; returns it.
    `csrc` other than the package's own builds another version of the
    kernels beside it (an A/B of two versions on one card)."""
    global build_seconds, ptxas_log
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libpipeedge_kernels_{tag}.so"
    if lib_path.exists():
        build_seconds = 0.0
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.monotonic()
    work = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    work.mkdir(exist_ok=True)
    procs = []
    for src in _sources(csrc):
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    ptxas_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{ptxas_log}")
    tmp = work / lib_path.name
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.monotonic() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def load(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare the C signatures it has."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.pe_error_string.argtypes = [ctypes.c_int]
    lib.pe_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise on a nonzero cudaError_t from a C entry point."""
    if code != 0:
        msg = library().pe_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t "
                           f"{code} ({msg})")


def stream_handle(device) -> int:
    """Raw handle of PyTorch's current stream on `device`."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
