"""B-spline prefilter (sample values -> spline coefficients) along one axis.

:func:`spline_filter1d` is the wrapper of kernel K2 (``csrc/prefilter.cu``),
which runs the causal / anti-causal recursion of :func:`_filter_lines` on
the card, one thread per line. On a CPU tensor it takes the plain version,
:func:`spline_filter1d_plain`: a ``tensordot`` with the dense float64 filter
matrix, as the JAX package computes it (``ops/prefilter.py:333`` there).

The float64 numpy helpers (poles, the reference recursion, the filter
matrix) are this package's own copies of the JAX package's.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from elasticdeform_tpu_torch.ops import _build
from elasticdeform_tpu_torch.ops.resample import cast_int_c, check_kernel_tensor

# truncation tolerance of the recursion's initialisation, as SciPy and the
# reference (deform.c:1046 ``TOLERANCE 1e-15``)
_TOLERANCE = 1e-15


def spline_poles(order: int):
    """IIR filter poles per order (reference deform.c:1063-1084)."""
    if order in (0, 1):
        return ()
    if order == 2:
        return (math.sqrt(8.0) - 3.0,)
    if order == 3:
        return (math.sqrt(3.0) - 2.0,)
    if order == 4:
        return (
            math.sqrt(664.0 - math.sqrt(438976.0)) + math.sqrt(304.0) - 19.0,
            math.sqrt(664.0 + math.sqrt(438976.0)) - math.sqrt(304.0) - 19.0,
        )
    if order == 5:
        return (
            math.sqrt(67.5 - math.sqrt(4436.25)) + math.sqrt(26.25) - 6.5,
            math.sqrt(67.5 + math.sqrt(4436.25)) - math.sqrt(26.25) - 6.5,
        )
    raise ValueError("order should be 0, 1, 2, 3, 4 or 5.")


def _horizon(p: float) -> int:
    return int(np.ceil(np.log(_TOLERANCE) / np.log(abs(p))))


def _gain(poles) -> float:
    weight = 1.0
    for p in poles:
        weight *= (1.0 - p) * (1.0 - 1.0 / p)
    return weight


def _filter_lines(lines: np.ndarray, order: int) -> np.ndarray:
    """The 1-D prefilter along axis 0 of ``lines`` in float64: the
    causal / anti-causal recursion with mirror initialisation behind
    ``scipy.ndimage.spline_filter1d(mode='mirror')`` (reference
    deform_grid.py:160,168). K2 runs these same steps."""
    poles = spline_poles(order)
    if not poles:
        return lines
    n = lines.shape[0]
    if n <= 1:
        return lines
    ln = np.array(lines, dtype=np.float64, copy=True)
    ln *= _gain(poles)
    for p in poles:
        horizon = _horizon(p)
        if horizon < n:
            zn = p
            acc = ln[0].copy()
            for k in range(1, horizon):
                acc += zn * ln[k]
                zn *= p
            ln[0] = acc
        else:
            zn = p
            iz = 1.0 / p
            z2n = p ** (n - 1)
            acc = ln[0] + z2n * ln[n - 1]
            z2n *= z2n * iz
            for k in range(1, n - 1):
                acc += (zn + z2n) * ln[k]
                zn *= p
                z2n *= iz
            ln[0] = acc / (1.0 - p ** (2 * n - 2))
        for k in range(1, n):
            ln[k] += p * ln[k - 1]
        ln[n - 1] = (p / (p * p - 1.0)) * (ln[n - 1] + p * ln[n - 2])
        for k in range(n - 2, -1, -1):
            ln[k] = p * (ln[k + 1] - ln[k])
    return ln


@functools.lru_cache(maxsize=None)
def filter_matrix(n: int, order: int) -> np.ndarray:
    """Dense ``n x n`` float64 prefilter matrix, ``coeffs = F @ samples``,
    built by filtering the identity."""
    if order <= 1 or n <= 1:
        return np.eye(n, dtype=np.float64)
    return np.ascontiguousarray(_filter_lines(np.eye(n, dtype=np.float64),
                                              order))


def _apply_matrix(x: torch.Tensor, mat: np.ndarray, axis: int):
    m = torch.as_tensor(mat, dtype=x.dtype, device=x.device)
    return torch.movedim(torch.tensordot(m, x, dims=([1], [axis])), 0, axis)


def spline_filter1d_plain(x: torch.Tensor, order: int, axis: int,
                          int_dtype=None) -> torch.Tensor:
    """Plain version of K2: the float64 filter matrix applied in the
    tensor's dtype, then, if ``int_dtype`` is given, the reference's
    integer writeback :func:`cast_int_c`."""
    if order <= 1:
        return x
    y = _apply_matrix(x, filter_matrix(x.shape[axis], order), axis)
    return y if int_dtype is None else cast_int_c(y, int_dtype)


@functools.lru_cache(maxsize=None)
def _kernel_params(n: int, order: int):
    poles = spline_poles(order)
    k = len(poles)
    return ((ctypes.c_double * k)(*poles),
            (ctypes.c_int * k)(*[_horizon(p) for p in poles]),
            (ctypes.c_double * k)(*[p ** (n - 1) for p in poles]),
            (ctypes.c_double * k)(*[1.0 - p ** (2 * n - 2) for p in poles]),
            _gain(poles))


def _lib():
    lib = _build.library("prefilter")
    fn = lib.ed_spline_prefilter
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.c_double, ctypes.c_int,
            ctypes.c_double, ctypes.c_void_p]
    return lib


def spline_filter1d(x: torch.Tensor, order: int, axis: int,
                    int_dtype=None) -> torch.Tensor:
    """Spline prefilter of ``x`` along ``axis`` (mirror boundary).

    ``int_dtype`` (a numpy integer or bool dtype) fuses the reference's
    per-axis integer writeback after the filter. Orders 0 and 1 need no
    filter and return ``x`` as it is. A CPU tensor takes
    :func:`spline_filter1d_plain`; a CUDA tensor launches K2 (contiguous
    float32 or float64 only) and adds one to ``spline_filter1d.launches``.
    """
    if order <= 1:
        return x
    if x.device.type == "cpu":
        return spline_filter1d_plain(x, order, axis, int_dtype)
    check_kernel_tensor(x, "spline_filter1d")
    axis = axis % x.dim()
    shape = x.shape
    n = int(shape[axis])
    outer = math.prod(shape[:axis])
    inner = math.prod(shape[axis + 1:])
    poles, horizons, pn1, denom, gain = _kernel_params(n, order)
    if int_dtype is None:
        bits, lo = 0, 0.0
    else:
        dt = np.dtype(int_dtype)
        info = np.iinfo(np.uint8 if dt.kind == "b" else dt)
        bits, lo = info.bits, float(info.min)
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.ed_spline_prefilter(
        0 if x.dtype == torch.float32 else 1, x.data_ptr(), out.data_ptr(),
        outer, n, inner, len(spline_poles(order)), poles, horizons, pn1,
        denom, gain, bits, lo, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, lib, "ed_prefilter_error_string", "spline_prefilter")
    spline_filter1d.launches += 1
    return out


spline_filter1d.launches = 0
