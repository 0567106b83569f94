"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source in ``csrc/`` becomes one shared library with a plain C
interface, compiled for ``sm_90a`` (Hopper) at first CUDA use into
``build/elasticdeform_tpu_torch/<hash>/`` beside the package. The hash
covers the sources and the flags, so an edited source builds anew. All
sources build at once, one ``nvcc`` process each. Nothing here runs when
the package is imported.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "elasticdeform_tpu_torch"

# --fmad=false: every product and sum rounds on its own, as in PyTorch's
# elementwise operations, so a kernel can be held to its plain version.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
SOURCES = ("resample", "prefilter", "resample_bwd", "filters", "morphology",
           "probes", "distance")

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}   # source name -> nvcc's stderr (ptxas register use)
build_seconds: dict = {}  # source name -> seconds its nvcc ran


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of elasticdeform_tpu_torch are "
            "built with nvcc at first use (put the CUDA toolkit on PATH)")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source not yet built, all in parallel; return
    ``{name: path}``. Raises RuntimeError with nvcc's output on failure.
    nvcc's output is kept beside each library (``lib<name>.log``), so
    ``build_logs`` holds every source's, whether built now or before."""
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    logs = {name: out_dir / f"lib{name}.log" for name in SOURCES}
    todo = [name for name, p in paths.items()
            if not (p.exists() and logs[name].exists())]
    for name in SOURCES:
        if name not in todo and name not in build_logs:
            build_logs[name] = logs[name].read_text()
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        log = open(f"{tmp}.log", "w+")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, text=True))
    running = set(todo)
    while running:
        for name in list(running):
            if procs[name][2].poll() is not None:
                build_seconds[name] = time.perf_counter() - t0
                running.discard(name)
        time.sleep(0.1)
    failed = []
    for name, (tmp, log, proc) in procs.items():
        log.seek(0)
        build_logs[name] = log.read()
        log.close()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n"
                          f"{build_logs[name]}")
            tmp.unlink(missing_ok=True)
            os.unlink(log.name)
        else:
            # atomic against concurrent builds; the log first, so a
            # library never stands without its log
            os.replace(log.name, logs[name])
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
        return lib


def check(err: int, lib: ctypes.CDLL, error_string: str, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        fn = getattr(lib, error_string)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({fn(err).decode()})")
