"""B-spline prefilter (sample values -> spline coefficients) along one axis.

:func:`spline_filter1d` is the wrapper of kernel K2 (``csrc/prefilter.cu``),
which runs the causal / anti-causal recursion of :func:`_filter_lines` on
the card, one thread per line. On a CPU tensor it takes the plain version,
:func:`spline_filter1d_plain`: a ``tensordot`` with the dense float64 filter
matrix, as the JAX package computes it (``ops/prefilter.py:333`` there).

:func:`spline_filter1d_transpose` is the wrapper of kernel K4 (the second
entry point of ``csrc/prefilter.cu``), the exact transpose of the filter
for the gradient: the stages of :func:`_filter_lines` transposed and run
in reverse, on the card. Its plain version,
:func:`spline_filter1d_transpose_plain`, is a ``tensordot`` with the
transposed filter matrix (``ops/prefilter.py:376`` there).

:func:`spline_filter1d_bc` and :func:`spline_filter1d_bc_transpose` are
the wrappers of kernels K6 and K7 (the third entry point of
``csrc/prefilter.cu``): the same recursion and its transpose under the
``reflect`` (half-sample symmetric) and ``wrap`` (periodic) boundary
conditions of SciPy >= 1.6, for the general resampler's modern modes and
``spline_filter``. Their plain versions are ``tensordot`` with
:func:`filter_matrix_bc` and its transpose (``ops/prefilter.py:150`` there).

The float64 numpy helpers (poles, the reference recursion, the filter
matrices) are this package's own copies of the JAX package's.
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


# B-spline kernel values at integer offsets, per order (the row of the
# sampling matrix around its diagonal)
_BSPLINE_INT_KERNEL = {
    2: (6 / 8, 1 / 8),
    3: (4 / 6, 1 / 6),
    4: (230 / 384, 76 / 384, 1 / 384),
    5: (66 / 120, 26 / 120, 1 / 120),
}

# kernel codes of the boundary conditions K6 and K7 take
_BC_CODES = {"reflect": 1, "wrap": 2}


def _fold_index_bc(q: int, n: int, bc: str) -> int:
    """Fold integer index ``q`` into ``[0, n)`` under a boundary condition:
    'mirror' (period ``2n-2``), 'reflect' (half-sample, period ``2n``) or
    'wrap' (period ``n``)."""
    if n == 1:
        return 0
    if bc == "mirror":
        m = q % (2 * n - 2)
        return 2 * n - 2 - m if m >= n else m
    if bc == "reflect":
        m = q % (2 * n)
        return 2 * n - 1 - m if m >= n else m
    if bc == "wrap":
        return q % n
    raise ValueError(f"unknown boundary condition {bc!r}")


@functools.lru_cache(maxsize=None)
def filter_matrix_bc(n: int, order: int, bc: str = "mirror") -> np.ndarray:
    """Exact ``n x n`` float64 prefilter matrix for a boundary condition:
    the inverse of the B-spline sampling matrix ``S[i, fold(i+k)] +=
    B(k)``; ``'mirror'`` is :func:`filter_matrix`."""
    if order <= 1 or n <= 1:
        return np.eye(n, dtype=np.float64)
    if bc == "mirror":
        return filter_matrix(n, order)
    ks = _BSPLINE_INT_KERNEL[order]
    r = len(ks) - 1
    S = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for k in range(-r, r + 1):
            S[i, _fold_index_bc(i + k, n, bc)] += ks[abs(k)]
    return np.ascontiguousarray(np.linalg.inv(S))


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


def spline_filter1d_transpose_plain(x: torch.Tensor, order: int,
                                    axis: int) -> torch.Tensor:
    """Plain version of K4: the transposed float64 filter matrix applied
    in the tensor's dtype (the JAX package's ``ops/prefilter.py:376``)."""
    if order <= 1:
        return x
    mat = np.ascontiguousarray(filter_matrix(x.shape[axis], order).T)
    return _apply_matrix(x, mat, axis)


def spline_filter1d_bc_plain(x: torch.Tensor, order: int, axis: int,
                            bc: str) -> torch.Tensor:
    """Plain version of K6: ``filter_matrix_bc(n, order, bc)`` applied in
    the tensor's dtype."""
    if order <= 1:
        return x
    return _apply_matrix(x, filter_matrix_bc(x.shape[axis], order, bc), axis)


def spline_filter1d_bc_transpose_plain(x: torch.Tensor, order: int,
                                       axis: int, bc: str) -> torch.Tensor:
    """Plain version of K7: the transposed ``filter_matrix_bc``."""
    if order <= 1:
        return x
    mat = np.ascontiguousarray(filter_matrix_bc(x.shape[axis], order, bc).T)
    return _apply_matrix(x, mat, axis)


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
        fn = lib.ed_spline_prefilter_transpose
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.c_double,
            ctypes.c_void_p]
        fn = lib.ed_spline_prefilter_bc
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ctypes.c_double, ctypes.c_void_p]
    return lib


def _lines(x: torch.Tensor, axis: int):
    """``(outer, n, inner)`` view of ``x`` around ``axis``."""
    axis = axis % x.dim()
    shape = x.shape
    return (math.prod(shape[:axis]), int(shape[axis]),
            math.prod(shape[axis + 1:]))


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
    outer, n, inner = _lines(x, axis)
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


def spline_filter1d_transpose(x: torch.Tensor, order: int,
                              axis: int) -> torch.Tensor:
    """The exact transpose of :func:`spline_filter1d` along ``axis`` (no
    integer writeback: the gradient path is linear). Orders 0 and 1 return
    ``x`` as it is. A CPU tensor takes
    :func:`spline_filter1d_transpose_plain`; a CUDA tensor launches K4
    (contiguous float32 or float64 only) and adds one to
    ``spline_filter1d_transpose.launches``.
    """
    if order <= 1:
        return x
    if x.device.type == "cpu":
        return spline_filter1d_transpose_plain(x, order, axis)
    check_kernel_tensor(x, "spline_filter1d_transpose")
    outer, n, inner = _lines(x, axis)
    poles, horizons, pn1, denom, gain = _kernel_params(n, order)
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.ed_spline_prefilter_transpose(
        0 if x.dtype == torch.float32 else 1, x.data_ptr(), out.data_ptr(),
        outer, n, inner, len(spline_poles(order)), poles, horizons, pn1,
        denom, gain, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, lib, "ed_prefilter_error_string",
                 "spline_prefilter_transpose")
    spline_filter1d_transpose.launches += 1
    return out


spline_filter1d_transpose.launches = 0


def _launch_bc(x: torch.Tensor, order: int, axis: int, bc: str,
               transpose: bool, what: str) -> torch.Tensor:
    check_kernel_tensor(x, what)
    if bc not in _BC_CODES:
        raise ValueError(f"{what}: bc must be 'reflect' or 'wrap', got {bc!r}")
    outer, n, inner = _lines(x, axis)
    poles = spline_poles(order)
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.ed_spline_prefilter_bc(
        0 if x.dtype == torch.float32 else 1, _BC_CODES[bc], int(transpose),
        x.data_ptr(), out.data_ptr(), outer, n, inner, len(poles),
        (ctypes.c_double * len(poles))(*poles), _gain(poles),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, lib, "ed_prefilter_error_string", what)
    return out


def spline_filter1d_bc(x: torch.Tensor, order: int, axis: int,
                       bc: str) -> torch.Tensor:
    """Spline prefilter of ``x`` along ``axis`` under the boundary condition
    ``bc``, ``'reflect'`` or ``'wrap'`` (the mirror one is
    :func:`spline_filter1d`). Orders 0 and 1 return ``x`` as it is. A CPU
    tensor takes :func:`spline_filter1d_bc_plain`; a CUDA tensor launches K6
    (contiguous float32 or float64 only) and adds one to
    ``spline_filter1d_bc.launches``.
    """
    if order <= 1:
        return x
    if x.device.type == "cpu":
        return spline_filter1d_bc_plain(x, order, axis, bc)
    out = _launch_bc(x, order, axis, bc, False, "spline_prefilter_bc")
    spline_filter1d_bc.launches += 1
    return out


spline_filter1d_bc.launches = 0


def spline_filter1d_bc_transpose(x: torch.Tensor, order: int, axis: int,
                                 bc: str) -> torch.Tensor:
    """The exact transpose of :func:`spline_filter1d_bc` along ``axis``.
    Orders 0 and 1 return ``x`` as it is. A CPU tensor takes
    :func:`spline_filter1d_bc_transpose_plain`; a CUDA tensor launches K7
    and adds one to ``spline_filter1d_bc_transpose.launches``.
    """
    if order <= 1:
        return x
    if x.device.type == "cpu":
        return spline_filter1d_bc_transpose_plain(x, order, axis, bc)
    out = _launch_bc(x, order, axis, bc, True,
                     "spline_prefilter_bc_transpose")
    spline_filter1d_bc_transpose.launches += 1
    return out


spline_filter1d_bc_transpose.launches = 0
