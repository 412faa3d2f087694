"""ctypes wrapper for the native host codec (`native/quantpack.cpp`).

Port of `pipeedge_tpu/ops/native_quant.py`. The codec packs k-bit codes
into uint32 words with the QuantPipe layout and math, so its words, scale
and shift are the plain codec's (`ops/quant.py`) bit for bit, and a v1
frame it encodes decodes anywhere (`comm/wire.py`). It runs on the host:
the v1 frame's encoder, and the v1 decoder on the CPU.

At first use the source is compiled as it stands with the host's C++
compiler (`sched/scheduler.py compiler`) into a shared library under the
gitignored `pipeedge_tpu_torch/_build/`, named by a hash of the source,
the flags and the toolchain, so an edit rebuilds and a build made on
another host is never loaded. `available()` is False on a host with no
compiler (or a failed build); the callers then use the plain codec.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..sched import scheduler
from ..utils.threads import make_lock

logger = logging.getLogger(__name__)

SOURCE = scheduler.NATIVE_DIR / "quantpack.cpp"
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = make_lock("native_quant.lib")
_load_failed = False


def library_path() -> Path:
    """Where `build` puts the library for the current source and
    toolchain."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(scheduler.toolchain_id().encode())
    digest.update(SOURCE.read_bytes())
    return scheduler.BUILD_DIR / f"libquantpack-{digest.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile `native/quantpack.cpp` into `library_path()` unless it is
    there; None when the host has no C++ compiler or the build failed.
    Concurrent builders serialize on a file lock, and the library is
    renamed into place whole."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = scheduler.compiler()
    if cxx is None:
        logger.warning("no C++ compiler on PATH: the native quant codec "
                       "is unavailable")
        return None
    import fcntl
    scheduler.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(scheduler.BUILD_DIR / ".quantpack.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
        cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            logger.error("building the native quant codec failed (%s):\n%s",
                         " ".join(cmd), proc.stderr.strip())
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        path = build()
        if path is None:
            _load_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.qp_abi_version.restype = ctypes.c_int
        if lib.qp_abi_version() != 1:
            logger.warning("native quant codec ABI mismatch; ignoring")
            _load_failed = True
            return None
        u32p = np.ctypeslib.ndpointer(np.uint32, flags='C_CONTIGUOUS')
        f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
        lib.qp_packed_words.restype = ctypes.c_int64
        lib.qp_packed_words.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.qp_encode_f32.restype = None
        lib.qp_encode_f32.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int, u32p, f32p, f32p]
        lib.qp_decode_f32.restype = None
        lib.qp_decode_f32.argtypes = [u32p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int, f32p, f32p, f32p]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native codec is loadable (builds it on first call)."""
    return _load() is not None


def _check(bit: int) -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native quant codec unavailable")
    if not 0 < bit <= 16:
        raise ValueError("native codec supports wire bitwidths 1..16")
    return lib


def encode_outerdim(x: np.ndarray, bit: int) \
        -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize each item along the leading axis: (packed [b, words]
    uint32, scale [b] f32, shift [b] f32), as `ops/quant.py
    tensor_encode_outerdim`."""
    lib = _check(bit)
    x = np.ascontiguousarray(x, dtype=np.float32)
    b = x.shape[0]
    n = int(np.prod(x.shape[1:], dtype=np.int64))
    words = lib.qp_packed_words(n, bit)
    packed = np.empty((b, words), np.uint32)
    scale = np.empty((b,), np.float32)
    shift = np.empty((b,), np.float32)
    lib.qp_encode_f32(x.reshape(b, n), b, n, bit, packed, scale, shift)
    return packed, scale, shift


def decode_outerdim(packed: np.ndarray, scale: np.ndarray, shift: np.ndarray,
                    shape: Sequence[int], bit: int) -> np.ndarray:
    """Inverse of `encode_outerdim`; `shape` is the full logical shape
    including the leading (microbatch) axis."""
    lib = _check(bit)
    shape = tuple(int(s) for s in shape)
    b = shape[0]
    n = int(np.prod(shape[1:], dtype=np.int64))
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    out = np.empty((b, n), np.float32)
    lib.qp_decode_f32(packed.reshape(b, -1), b, n, bit,
                      np.ascontiguousarray(scale, np.float32),
                      np.ascontiguousarray(shift, np.float32), out)
    return out.reshape(shape)
