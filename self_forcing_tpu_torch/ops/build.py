"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by one ``nvcc`` into
``csrc/build/lib<name>-<hash>.so`` (the hash covers the source, the shared
``csrc/*.cuh`` headers and the flags, so an edit is rebuilt).  The sources have a plain C
interface, so no PyTorch headers and no ``ninja`` are needed.  A build
error raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source in csrc/ (without the .cu suffix)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return path


def _target(name: str) -> str:
    """Library path keyed by the source, the shared headers and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str) -> tuple[subprocess.Popen, str, str] | None:
    """Start the nvcc for ``name`` unless its library is built already."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, proc: subprocess.Popen, tmp: str,
            target: str) -> None:
    log, _ = proc.communicate()
    with open(os.path.join(BUILD_DIR, name + ".log"), "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)


def build_all() -> dict[str, float]:
    """Compile every source that is not built yet, all nvcc processes at
    once.  Returns the seconds each build took (0.0 if it was built)."""
    with _lock:
        t0 = time.perf_counter()
        started = {name: _start(name) for name in sources()}
        secs = {}
        try:
            for name, job in started.items():
                if job is not None:
                    _finish(name, *job)
                secs[name] = (time.perf_counter() - t0) if job else 0.0
        finally:
            for job in started.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
        return secs


def build_log(name: str) -> str:
    """The compiler's output (ptxas register and spill report) of the last
    build of ``name``, or '' if it was not built in this checkout."""
    path = os.path.join(BUILD_DIR, name + ".log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, *job)
            lib = ctypes.CDLL(_target(name))
            _loaded[name] = lib
    return lib


def function(name: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C launcher ``fn`` of ``csrc/<name>.cu``; it returns the CUDA
    error code of the launch."""
    f = getattr(load(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def raise_on(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
