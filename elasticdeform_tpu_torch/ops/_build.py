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
           "probes")

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}   # source name -> nvcc's stderr (ptxas register use)


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
    ``{name: path}``. Raises RuntimeError with nvcc's output on failure."""
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    todo = [name for name, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])   # atomic against concurrent builds
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
