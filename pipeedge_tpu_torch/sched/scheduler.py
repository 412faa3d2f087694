"""Subprocess wrapper for the native `sched-pipeline` scheduler binary.

After `pipeedge_tpu/sched/scheduler.py`: builds the CLI arguments, looks
for the binary in `app_paths`, then in the port's build directory, then
on `PATH`, and builds it from `native/*.cpp` if none is found; parses the
YAML schedule from its stdout into `[{host: [layer_l, layer_r]}, ...]`.

The port builds the binary itself (`build_native`) with the host's C++
compiler, one command and no cmake or ninja, into
`pipeedge_tpu_torch/_build/`, named by a hash of the sources, the flags,
the compiler (its path and `--version`) and the machine (architecture
and libc), so an edit of `native/` rebuilds it and a build made on
another host is never run here.
"""
import functools
import hashlib
import logging
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

from . import miniyaml

logger = logging.getLogger(__name__)

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("sched_pipeline_main.cpp", "partition.cpp")
HEADERS = ("partition.h", "miniyaml.h")
CXX_FLAGS = ("-std=c++17", "-O2", "-Wall", "-Wextra")
COMPILERS = ("c++", "g++", "clang++")

_build_failed = False


def compiler() -> Optional[str]:
    """The host's C++ compiler, or None."""
    for name in COMPILERS:
        path = shutil.which(name)
        if path:
            return path
    return None


@functools.lru_cache(maxsize=None)
def toolchain_id() -> str:
    """The compiler and machine a build depends on: the compiler's path
    and `--version` text, the architecture and the libc."""
    cxx = compiler()
    version = ""
    if cxx is not None:
        proc = subprocess.run([cxx, "--version"], capture_output=True,
                              text=True)
        version = proc.stdout.strip()
    return "\n".join([str(cxx), version, platform.machine(),
                      " ".join(platform.libc_ver())])


def binary_path() -> Path:
    """Where `build_native` puts the binary for the current sources and
    the current toolchain."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(toolchain_id().encode())
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"sched-pipeline-{digest.hexdigest()[:16]}"


def build_native(force: bool = False) -> Optional[str]:
    """Compile `native/sched_pipeline_main.cpp` and `native/partition.cpp`
    into `binary_path()` unless it is there; returns its path, or None
    when the host has no C++ compiler or the build failed (logged; a
    failure is remembered, so later calls do not retry unless `force`).

    Concurrent builders (test workers) serialize on a file lock; the
    binary is written under a temporary name and renamed into place, so
    no caller ever runs a half-written file."""
    global _build_failed
    binary = binary_path()
    if binary.exists() and not force:
        return str(binary)
    if _build_failed and not force:
        return None
    cxx = compiler()
    if cxx is None:
        logger.warning("no C++ compiler (%s) on PATH: cannot build "
                       "sched-pipeline", ", ".join(COMPILERS))
        _build_failed = True
        return None
    import fcntl
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".sched-pipeline.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if binary.exists() and not force:
            return str(binary)
        tmp = binary.with_name(f"{binary.name}.tmp{os.getpid()}")
        cmd = [cxx, *CXX_FLAGS, *(str(NATIVE_DIR / s) for s in SOURCES),
               "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            logger.error("building sched-pipeline failed (%s):\n%s",
                         " ".join(cmd), proc.stderr.strip())
            tmp.unlink(missing_ok=True)
            _build_failed = True
            return None
        os.replace(tmp, binary)
    _build_failed = False
    return str(binary)


def _log_cpe(exc: subprocess.CalledProcessError) -> None:
    logger.error("Scheduler subprocess failed, return code: %d", exc.returncode)
    stdout = exc.stdout.decode().strip()
    if stdout:
        logger.info("stdout:\n%s", stdout)
    stderr = exc.stderr.decode().strip()
    if stderr:
        logger.error("stderr:\n%s", stderr)


def sched_pipeline(model_name: str, buffers_in: int, buffers_out: int,
                   batch_size: int, dtype: str = 'torch.float32',
                   models_file: Optional[str] = None,
                   dev_types_file: Optional[str] = None,
                   dev_file: Optional[str] = None,
                   app_paths: Optional[List[str]] = None) \
        -> List[Dict[str, List[int]]]:
    """Run the native scheduler; returns the stage list in layer order.
    A failing run raises `subprocess.CalledProcessError` (its output is
    logged); a binary found nowhere and not buildable raises
    `FileNotFoundError`."""
    args = ['-i', str(buffers_in), '-o', str(buffers_out),
            '-b', str(batch_size), '-d', dtype, '-m', model_name]
    if models_file:
        args += ['-M', models_file]
    if dev_types_file:
        args += ['-T', dev_types_file]
    if dev_file:
        args += ['-D', dev_file]

    def run(app_path: str) -> Optional[subprocess.CompletedProcess]:
        try:
            return subprocess.run([app_path] + args, capture_output=True,
                                  check=True)
        except FileNotFoundError:
            return None
        except subprocess.CalledProcessError as exc:
            _log_cpe(exc)
            raise

    candidates = list(app_paths or []) + [str(binary_path()),
                                          'sched-pipeline']
    for app_path in candidates:
        proc = run(app_path)
        if proc is not None:
            break
    else:
        # found nowhere: build from native/ (only now, so an explicit
        # app path or an install on PATH takes precedence)
        built = build_native()
        proc = run(built) if built is not None else None
        if proc is None:
            logger.error("Could not locate sched-pipeline (tried %s) and "
                         "could not build it from %s", candidates,
                         NATIVE_DIR)
            raise FileNotFoundError('sched-pipeline')

    stderr = proc.stderr.decode().strip()
    if stderr:
        logger.warning(stderr)
    sched = miniyaml.loads(proc.stdout.decode())
    if sched is None:
        sched = []
    if not isinstance(sched, list):
        raise ValueError(f"sched-pipeline printed no schedule list: "
                         f"{proc.stdout.decode()!r}")
    return sched
