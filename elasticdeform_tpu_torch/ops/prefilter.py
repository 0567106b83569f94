"""B-spline prefilter (sample values -> spline coefficients) along one axis.

:func:`spline_filter1d` is the wrapper of kernel K2 (``csrc/prefilter.cu``),
which runs the causal / anti-causal recursion of :func:`_filter_lines` on
the card. On a CPU tensor it takes the plain version,
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

K2, K4, K6 and K7 take one of two routes, which :func:`_tile_plan` picks
from the shape: ``"tile"`` stages W whole lines of the axis in shared
memory and filters them there (every line of at most :func:`tile_cap`
elements: 1760 in float32, 880 in float64), ``"lines"`` runs one thread
per line in device memory (longer lines). Both compute the same operations
in the same order. Each wrapper counts its launches per route in
``.routes``.

With an integer writeback (``int_dtype``, an integer input to ``deform``)
K2 takes its ``"writeback"`` route instead: no recursion, but the row sums
of the filter matrix in one fixed order, then the truncating cast after the
axis (:func:`_row_sums`, which its plain version runs too), so that the
card and the CPU truncate to the same integers. It runs in a product form
(:func:`_writeback_plan`: a register-blocked product of bands of rows by
tiles of lines, the same chains; where the input came from an integer
array, a band skips the chunks of its table that are exactly zero), or on
the rows route (a tile form and a lines form, on the tile plan)
for views the product form does not take. With ``fixed_order`` (a call of
the general
resampler whose output is an integer, which rounds after the resample) K2
and K6 take that route without the cast: the row sums of ``filter_matrix``
or ``filter_matrix_bc`` in the same fixed order on both devices.

The float64 numpy helpers (poles, the reference recursion, the filter
matrices) are this package's own copies of the JAX package's.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

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


@functools.lru_cache(maxsize=64)
def _filter_table(n: int, order: int, dtype, device,
                  bc: str = "mirror") -> torch.Tensor:
    """``filter_matrix(n, order)`` (``bc`` ``'mirror'``) or
    ``filter_matrix_bc(n, order, bc)`` in ``dtype`` on ``device``, uploaded
    once: the table of K2's writeback route and of its twin."""
    mat = filter_matrix(n, order) if bc == "mirror" else \
        filter_matrix_bc(n, order, bc)
    return torch.as_tensor(mat, dtype=dtype, device=device)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """``fmaf(a, b, c)`` of float32 tensors (broadcast), rounded once, on
    any device. The product of two float32 values is exact in float64; the
    float64 sum with ``c`` is taken rounded to odd (the rounded sum, moved
    one step toward the exact sum where it is inexact and even, the error
    found exactly by TwoSum), and rounding that to float32 rounds the exact
    ``a * b + c`` once (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _row_sums(x: torch.Tensor, mat: torch.Tensor, axis: int):
    """``y[a] = sum_k mat[a, k] x[k]`` along ``axis`` in one fixed order,
    k ascending from 0: float64 a rounded multiply, then a rounded add (no
    fused multiply-add: separate PyTorch operations); float32 one fused
    multiply-add per term (:func:`_fma32`). The order of K2's writeback
    route, and of XLA's CPU dot where that is a sequential chain."""
    xm = torch.movedim(x, axis, 0)
    shape = (xm.shape[0],) + (1,) * (xm.dim() - 1)
    y = torch.zeros_like(xm)
    for k in range(xm.shape[0]):
        col = mat[:, k].reshape(shape)
        if x.dtype == torch.float32:
            y = _fma32(col, xm[k], y)
        else:
            y = y + col * xm[k]
    return torch.movedim(y, 0, axis)


def spline_filter1d_plain(x: torch.Tensor, order: int, axis: int,
                          int_dtype=None,
                          fixed_order: bool = False) -> torch.Tensor:
    """Plain version of K2: the float64 filter matrix applied in the
    tensor's dtype (``tensordot``); with ``int_dtype`` or ``fixed_order``,
    the plain version of its writeback route: the matrix's row sums in the
    route's order (:func:`_row_sums`), then with ``int_dtype`` the
    reference's integer writeback :func:`cast_int_c`."""
    if order <= 1:
        return x
    n = x.shape[axis]
    if int_dtype is None and not fixed_order:
        return _apply_matrix(x, filter_matrix(n, order), axis)
    y = _row_sums(x, _filter_table(n, order, x.dtype, x.device), axis)
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
                            bc: str,
                            fixed_order: bool = False) -> torch.Tensor:
    """Plain version of K6: ``filter_matrix_bc(n, order, bc)`` applied in
    the tensor's dtype; with ``fixed_order``, its row sums in the order of
    K2's writeback route (:func:`_row_sums`)."""
    if order <= 1:
        return x
    n = x.shape[axis]
    if fixed_order:
        return _row_sums(x, _filter_table(n, order, x.dtype, x.device, bc),
                         axis)
    return _apply_matrix(x, filter_matrix_bc(n, order, bc), axis)


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
            ctypes.POINTER(ctypes.c_double), ctypes.c_double,
            ctypes.c_void_p]
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
        fn = lib.ed_spline_prefilter_tile
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.c_double, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p]
        fn = lib.ed_spline_prefilter_writeback
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p]
        fn = lib.ed_spline_prefilter_writeback_product
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
            ctypes.c_longlong, ctypes.c_void_p]
        fn = lib.ed_prefilter_tile_blocks_per_sm
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 4
    return lib


def _lines(x: torch.Tensor, axis: int):
    """``(outer, n, inner)`` view of ``x`` around ``axis``."""
    axis = axis % x.dim()
    shape = x.shape
    return (math.prod(shape[:axis]), int(shape[axis]),
            math.prod(shape[axis + 1:]))


# shared memory a block may use on the H100 (227 KB); an SM holds 228 KB,
# less 1 KB for each block it runs
SMEM_LIMIT = 232448
_SM_SMEM = 233472
# lines of a tile, one thread each, in the order a plan prefers them
# among widths that fill as few rounds of SMs
TILE_WIDTHS = (64, 32, 128)
_ITEMSIZE = {torch.float32: 4, torch.float64: 8}


class TilePlan(NamedTuple):
    """How K2, K4, K6 or K7 runs on an ``(outer, n, inner)`` view: ``route``
    ``"tile"`` or ``"lines"``; for a tile, ``width`` threads and lines a
    block, ``packed`` (``inner < width``: a tile is ``lines // inner``
    whole outers, one contiguous run), ``lines`` of a full tile, the
    shared-memory ``stride`` (of a row ``k``, odd; packed, of an outer's
    run of ``n * inner`` elements, congruent to ``inner`` modulo 32) and
    ``smem`` bytes; ``blocks`` of the grid (the lines route: 256 lines a
    block)."""
    route: str
    width: int
    packed: bool
    lines: int
    stride: int
    smem: int
    blocks: int


def tile_cap(dtype) -> int:
    """The longest line the tile route takes: 32 lines at stride 33 fill
    at most :data:`SMEM_LIMIT` bytes (1760 in float32, 880 in float64)."""
    return SMEM_LIMIT // (33 * _ITEMSIZE[dtype])


def blocks_per_sm(plan: TilePlan) -> int:
    """Blocks of a tile plan that one SM holds: as many as its shared
    memory takes, up to the 1024 threads for which the kernel's launch
    bounds reserve registers (64 a thread)."""
    return min(_SM_SMEM // (plan.smem + 1024), 1024 // plan.width)


def waves(plan: TilePlan, sms: int) -> int:
    """How many rounds of blocks a tile plan takes on ``sms`` SMs."""
    return -(-plan.blocks // (sms * blocks_per_sm(plan)))


@functools.lru_cache(maxsize=1024)
def _tile_plan(outer: int, n: int, inner: int, dtype, width=None,
               route=None, sms: int = 132) -> TilePlan:
    """The launch of K2, K4, K6 or K7 on an ``(outer, n, inner)`` view of a
    ``dtype`` tensor: the tile route for ``n <= tile_cap(dtype)``, else the
    lines route. The tile width is the one of :data:`TILE_WIDTHS` whose
    blocks fill the fewest rounds (:func:`waves`) of ``sms`` SMs, the first
    in :data:`TILE_WIDTHS` among equals: a block stages, filters and
    stores in turn, so a last round that is nearly empty costs as much as
    a full one. ``width`` and ``route`` force a choice (``chip_smoke.py``
    times both routes and every width); a forced tile that does not fit
    raises ValueError. Cached: the wrappers ask for a plan at every
    launch."""
    if route is None:
        route = "tile" if n <= tile_cap(dtype) else "lines"
    if route == "lines":
        return TilePlan("lines", 0, False, 0, 0, 0,
                        -(-outer * inner // 256))
    if route != "tile":
        raise ValueError(f"route must be 'tile' or 'lines', got {route!r}")
    if width is None:
        plans = []
        for w in TILE_WIDTHS:
            try:
                plans.append(_tile_plan(outer, n, inner, dtype, w))
            except ValueError:
                continue
        if not plans:
            raise ValueError(f"a line of {n} does not fit a tile")
        return min(plans, key=lambda p: waves(p, sms))
    item = _ITEMSIZE[dtype]
    if width not in TILE_WIDTHS:
        raise ValueError(f"width must be one of {TILE_WIDTHS}, got {width}")
    packed = 0 < inner < width
    if packed:
        lines = inner * (width // inner)
        stride = n * inner + (inner - n * inner) % 32
        smem = width // inner * stride * item
    else:
        lines = width
        stride = lines | 1
        smem = n * stride * item
    if smem > SMEM_LIMIT:
        raise ValueError(f"a tile of {lines} lines of {n} takes {smem} "
                         f"bytes, over {SMEM_LIMIT}")
    if outer * inner == 0 or n == 0:
        blocks = 0
    elif packed:
        blocks = -(-outer // (width // inner))
    else:
        blocks = outer * -(-inner // width)
    return TilePlan("tile", width, packed, lines, stride, smem, blocks)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan_for(x: torch.Tensor, axis: int) -> TilePlan:
    """The wrapper's plan for a CUDA tensor, sized to its card's SMs."""
    return _tile_plan(*_lines(x, axis), x.dtype, sms=_sm_count(x.device))


# the tile kernel's stage sets (csrc/prefilter.cu), by kernel and boundary
# condition
_TILE_KINDS = {("K4", "mirror"): 0, ("K7", "reflect"): 1, ("K7", "wrap"): 2,
               ("K2", "mirror"): 3, ("K6", "reflect"): 4, ("K6", "wrap"): 5,
               ("K2 writeback", "mirror"): 6}


@functools.lru_cache(maxsize=None)
def _int_writeback(int_dtype):
    """``(bits, iinfo.min)`` of K2's integer writeback; ``(0, 0.0)`` for
    none."""
    if int_dtype is None:
        return 0, 0.0
    dt = np.dtype(int_dtype)
    info = np.iinfo(np.uint8 if dt.kind == "b" else dt)
    return info.bits, float(info.min)


def _row_groups(plan: TilePlan, n: int, lines: int, sms: int) -> int:
    """How many runs K2's writeback route splits each line's n output rows
    into, each run taken by its own block (tile form) or thread (lines
    form): every row is an independent sum, and a line's rows in turn are
    a chain of n * n steps, so with few lines the card would sit idle. As
    many runs as bring the launch to about 4 blocks of the plan (or 4
    blocks of 256 threads) per SM, each of at least 4 rows."""
    units = plan.blocks if plan.route == "tile" else lines
    want = 4 * sms * (1 if plan.route == "tile" else 256)
    return max(1, min(-(-want // max(units, 1)), -(-n // 4)))


# K2's writeback route in its product form (csrc WB_ROWS, WB_LINES,
# WbChunk): a block computes a band of WB_ROWS output rows of WB_LINES
# lines, walking k in chunks of WB_CHUNK elements
WB_ROWS = 64
WB_LINES = 64
WB_CHUNK = {torch.float32: 32, torch.float64: 16}


class WritebackPlan(NamedTuple):
    """How K2's writeback route runs on an ``(outer, n, inner)`` view:
    ``route`` ``"product"`` (the register-blocked product of a band of
    :data:`WB_ROWS` rows by a tile of :data:`WB_LINES` lines, ``packed``
    when ``inner < WB_LINES``: a tile is ``WB_LINES // inner`` whole
    outers; ``tiles`` of lines times ``bands`` of rows make the ``blocks``)
    or ``"rows"`` (``writeback_rows``: a thread's rows four at a time, in
    the tile or lines form of ``rows``, the :func:`_tile_plan` of the
    view)."""
    route: str
    packed: bool
    tiles: int
    bands: int
    blocks: int
    rows: TilePlan


@functools.lru_cache(maxsize=1024)
def _writeback_plan(outer: int, n: int, inner: int, dtype,
                    sms: int = 132) -> WritebackPlan:
    """K2's writeback route on an ``(outer, n, inner)`` view of a
    ``dtype`` tensor: the product form, unless a tile's span of lines
    leaves int32 or the grid would hold 2^31 blocks or more, where the
    rows route takes it (its plan is ``rows`` either way). Cached: the
    wrappers ask at every launch."""
    rows = _tile_plan(outer, n, inner, dtype, sms=sms)
    packed = inner < WB_LINES
    if packed:
        per = WB_LINES // inner
        tiles = -(-outer // per)
        span = per * n * inner
    else:
        tiles = outer * -(-inner // WB_LINES)
        span = WB_CHUNK[dtype] * inner + WB_LINES
    bands = -(-n // WB_ROWS)
    blocks = tiles * bands
    if span >= 2 ** 31 or blocks >= 2 ** 31 or n >= 2 ** 31:
        return WritebackPlan("rows", False, 0, 0, rows.blocks, rows)
    return WritebackPlan("product", packed, tiles, bands, blocks, rows)


def _writeback_plan_for(x: torch.Tensor, axis: int) -> WritebackPlan:
    """The writeback plan for a CUDA tensor, sized to its card's SMs."""
    return _writeback_plan(*_lines(x, axis), x.dtype, sms=_sm_count(x.device))


def writeback_chunk_runs(mat: np.ndarray, chunk: int):
    """The product form's chunk runs of an ``n x n`` table ``mat`` (in the
    kernel's dtype): per band of :data:`WB_ROWS` rows, the chunks of
    ``chunk`` columns where the band holds a nonzero entry as two runs
    ``[x, y)`` and ``[z, w)``, ascending (a band's nonzero chunks lie
    around its diagonal and, under wrap, in a corner), ``(bands, 4)``
    int32. A band skips the other chunks: their terms are ``0 * x``, which
    leave a sum of finite terms as it is. None where no band skips a chunk
    or a band's chunks take more than two runs: the kernel then takes every
    chunk."""
    n = mat.shape[0]
    bands, chunks = -(-n // WB_ROWS), -(-n // chunk)
    runs = np.zeros((bands, 4), dtype=np.int32)
    skips = False
    for b in range(bands):
        band = mat[b * WB_ROWS:(b + 1) * WB_ROWS]
        live = [bool(np.any(band[:, c * chunk:(c + 1) * chunk] != 0))
                for c in range(chunks)]
        edges = [c for c in range(chunks + 1)
                 if (c < chunks and live[c]) != (c > 0 and live[c - 1])]
        if len(edges) > 4:
            return None
        edges += [edges[-1] if edges else 0] * (4 - len(edges))
        runs[b] = edges
        skips = skips or not all(live)
    return runs if skips else None


@functools.lru_cache(maxsize=64)
def _writeback_tables(n: int, order: int, dtype, device, bc: str = "mirror"):
    """The product form's tables on ``device``, uploaded once: the
    transposed table of :func:`_filter_table` (``M^T``, row-major, in
    ``dtype``) and its chunk runs (:func:`writeback_chunk_runs`, or None:
    every chunk)."""
    mat = _filter_table(n, order, dtype, torch.device("cpu"), bc)
    runs = writeback_chunk_runs(mat.numpy(), WB_CHUNK[dtype])
    return (mat.t().contiguous().to(device),
            None if runs is None else torch.as_tensor(runs).to(device))


def _launch_product(x: torch.Tensor, order: int, axis: int, bc: str,
                    plan: WritebackPlan, int_dtype=None,
                    finite: bool = False) -> torch.Tensor:
    """K2's writeback route in its product form on ``plan``: the row sums
    of ``filter_matrix`` (``bc`` ``'mirror'``) or ``filter_matrix_bc``,
    then ``int_dtype``'s writeback or, with None, no cast; ``finite`` (an
    input known to be finite: it came from an integer array) lets each band
    skip the chunks where its rows of the table are exactly zero (its
    chunk runs). Counts nothing."""
    outer, n, inner = _lines(x, axis)
    out = torch.empty_like(x)
    lib = _lib()
    bits, lo = _int_writeback(int_dtype)
    mat_t, runs = _writeback_tables(n, order, x.dtype, x.device, bc)
    err = lib.ed_spline_prefilter_writeback_product(
        0 if x.dtype == torch.float32 else 1, x.data_ptr(), out.data_ptr(),
        mat_t.data_ptr(), runs.data_ptr() if finite and runs is not None
        else None, outer, n, inner, bits, lo, plan.blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, lib, "ed_prefilter_error_string",
                 "spline_prefilter writeback product")
    return out


def _launch_writeback(x: torch.Tensor, order: int, axis: int, bc: str,
                      plan, int_dtype=None,
                      finite: bool = False) -> torch.Tensor:
    """K2's writeback route on ``plan``: a :class:`WritebackPlan` (its
    product form, or its rows route), or a :class:`TilePlan`, which runs
    the rows route in that plan's tile or lines form. Counts nothing."""
    if isinstance(plan, WritebackPlan):
        if plan.route == "product":
            return _launch_product(x, order, axis, bc, plan, int_dtype,
                                   finite)
        plan = plan.rows
    return _launch_rows(x, order, axis, bc, plan, int_dtype)


def _launch_rows(x: torch.Tensor, order: int, axis: int, bc: str,
                 plan: TilePlan, int_dtype=None) -> torch.Tensor:
    """K2's writeback route on ``plan`` (its tile form on a tile plan, its
    lines form on a lines plan): the row sums of ``filter_matrix`` (``bc``
    ``'mirror'``) or ``filter_matrix_bc``, then ``int_dtype``'s writeback
    or, with None, no cast. Counts nothing."""
    outer, n, inner = _lines(x, axis)
    out = torch.empty_like(x)
    lib = _lib()
    bits, lo = _int_writeback(int_dtype)
    mat = _filter_table(n, order, x.dtype, x.device, bc)
    groups = _row_groups(plan, n, outer * inner, _sm_count(x.device))
    err = lib.ed_spline_prefilter_writeback(
        0 if x.dtype == torch.float32 else 1, x.data_ptr(), out.data_ptr(),
        mat.data_ptr(), outer, n, inner, bits, lo, groups, plan.width,
        int(plan.packed), plan.lines, plan.stride, plan.smem, plan.blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, lib, "ed_prefilter_error_string",
                 "spline_prefilter writeback")
    return out


def _launch_filter(x: torch.Tensor, order: int, axis: int, plan,
                   int_dtype=None, fixed_order: bool = False,
                   finite: bool = False) -> torch.Tensor:
    """K2 on a CUDA tensor along ``axis`` on the route and tile ``plan``
    names; with ``int_dtype`` or ``fixed_order``, K2's writeback route
    instead (:func:`_launch_writeback`, ``finite`` as there). Counts
    nothing (the public wrapper counts)."""
    check_kernel_tensor(x, "spline_prefilter")
    if int_dtype is not None or fixed_order:
        return _launch_writeback(x, order, axis, "mirror", plan, int_dtype,
                                 finite)
    outer, n, inner = _lines(x, axis)
    dt = 0 if x.dtype == torch.float32 else 1
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty_like(x)
    lib = _lib()
    poles, horizons, pn1, denom, gain = _kernel_params(n, order)
    npoles = len(spline_poles(order))
    if plan.route == "tile":
        err = lib.ed_spline_prefilter_tile(
            dt, _TILE_KINDS["K2", "mirror"], x.data_ptr(), out.data_ptr(),
            outer, n, inner, npoles, poles, horizons, pn1, denom, gain,
            plan.width, int(plan.packed), plan.lines, plan.stride, plan.smem,
            plan.blocks, stream)
    else:
        err = lib.ed_spline_prefilter(
            dt, x.data_ptr(), out.data_ptr(), outer, n, inner, npoles, poles,
            horizons, pn1, denom, gain, stream)
    _build.check(err, lib, "ed_prefilter_error_string", "spline_prefilter")
    return out


def _launch_poles(x: torch.Tensor, order: int, axis: int, bc: str,
                  plan: TilePlan, transpose: bool) -> torch.Tensor:
    """K4 (``bc='mirror'``, ``transpose``), K7 (``'reflect'``, ``'wrap'``,
    ``transpose``) or K6 (``'reflect'``, ``'wrap'``) on a CUDA tensor
    along ``axis``, on the route and tile ``plan`` names; counts nothing
    (the public wrappers count)."""
    what = ("spline_prefilter_transpose" if bc == "mirror" else
            "spline_prefilter_bc_transpose" if transpose else
            "spline_prefilter_bc")
    check_kernel_tensor(x, what)
    if bc not in _BC_CODES and (bc != "mirror" or not transpose):
        raise ValueError(f"{what}: bc must be 'reflect' or 'wrap', got {bc!r}")
    outer, n, inner = _lines(x, axis)
    poles = spline_poles(order)
    if bc == "mirror":
        cpoles, horizons, pn1, denom, gain = _kernel_params(n, order)
    else:
        cpoles = (ctypes.c_double * len(poles))(*poles)
        horizons = pn1 = denom = None
        gain = _gain(poles)
    dt = 0 if x.dtype == torch.float32 else 1
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty_like(x)
    lib = _lib()
    if plan.route == "tile":
        kernel = "K4" if bc == "mirror" else "K7" if transpose else "K6"
        err = lib.ed_spline_prefilter_tile(
            dt, _TILE_KINDS[kernel, bc], x.data_ptr(), out.data_ptr(), outer,
            n, inner, len(poles), cpoles, horizons, pn1, denom, gain,
            plan.width, int(plan.packed), plan.lines, plan.stride, plan.smem,
            plan.blocks, stream)
    elif bc == "mirror":
        err = lib.ed_spline_prefilter_transpose(
            dt, x.data_ptr(), out.data_ptr(), outer, n, inner, len(poles),
            cpoles, horizons, pn1, denom, gain, stream)
    else:
        err = lib.ed_spline_prefilter_bc(
            dt, _BC_CODES[bc], int(transpose), x.data_ptr(), out.data_ptr(),
            outer, n, inner, len(poles), cpoles, gain, stream)
    _build.check(err, lib, "ed_prefilter_error_string", what)
    return out


def _launch_transpose(x: torch.Tensor, order: int, axis: int, bc: str,
                      plan: TilePlan) -> torch.Tensor:
    """K4 (``bc='mirror'``) or K7 (``'reflect'``, ``'wrap'``) on ``plan``:
    :func:`_launch_poles`."""
    return _launch_poles(x, order, axis, bc, plan, True)


def _launch_bc_filter(x: torch.Tensor, order: int, axis: int, bc: str,
                      plan, fixed_order: bool = False,
                      finite: bool = False) -> torch.Tensor:
    """K6 under ``bc`` (``'reflect'`` or ``'wrap'``) on ``plan``:
    :func:`_launch_poles`; with ``fixed_order``, K2's writeback route on
    ``filter_matrix_bc`` with no cast (:func:`_launch_writeback`)."""
    if fixed_order:
        check_kernel_tensor(x, "spline_prefilter_bc")
        return _launch_writeback(x, order, axis, bc, plan, None, finite)
    return _launch_poles(x, order, axis, bc, plan, False)


def tile_blocks_per_sm(dtype, kernel: str, bc: str, plan: TilePlan) -> int:
    """Blocks of the tile kernel of ``kernel`` (``"K2"``, ``"K2
    writeback"``, ``"K4"``, ``"K6"`` or ``"K7"``) under ``bc`` (``'mirror'``
    for K2 and K4) that one SM holds under ``plan`` (CUDA's occupancy
    calculator; needs the card)."""
    kind = _TILE_KINDS[kernel, bc]
    lib = _lib()
    got = lib.ed_prefilter_tile_blocks_per_sm(
        0 if dtype == torch.float32 else 1, kind, plan.width, plan.smem)
    _build.check(max(-got, 0), lib, "ed_prefilter_error_string",
                 "tile occupancy")
    return got


def spline_filter1d(x: torch.Tensor, order: int, axis: int,
                    int_dtype=None, fixed_order: bool = False,
                    finite: bool = False) -> torch.Tensor:
    """Spline prefilter of ``x`` along ``axis`` (mirror boundary).

    ``int_dtype`` (a numpy integer or bool dtype) adds the reference's
    per-axis integer writeback after the filter, on K2's writeback route;
    ``fixed_order`` takes that route's fixed-order sums without the cast;
    ``finite`` says that ``x`` came from an integer array, so the route may
    skip the table's exact zeros (an integer writeback implies it).
    Orders 0 and 1 need no filter and return ``x`` as it is. A CPU tensor
    takes :func:`spline_filter1d_plain`; a CUDA tensor launches K2
    (contiguous float32 or float64 only) on the route of :func:`_tile_plan`,
    or with ``int_dtype`` or ``fixed_order`` on its writeback route (the
    form :func:`_writeback_plan` picks), and adds one to
    ``spline_filter1d.launches``, to that route's count in
    ``spline_filter1d.routes`` and, on the writeback route, to its form's
    count in ``spline_filter1d.writeback_routes``.
    """
    if order <= 1:
        return x
    if x.device.type == "cpu":
        return spline_filter1d_plain(x, order, axis, int_dtype, fixed_order)
    check_kernel_tensor(x, "spline_filter1d")
    if int_dtype is not None or fixed_order:
        plan = _writeback_plan_for(x, axis)
        out = _launch_filter(x, order, axis, plan, int_dtype, True,
                             finite or int_dtype is not None)
        spline_filter1d.writeback_routes[plan.route] += 1
        route = "writeback"
    else:
        plan = _plan_for(x, axis)
        out = _launch_filter(x, order, axis, plan)
        route = plan.route
    spline_filter1d.launches += 1
    spline_filter1d.routes[route] += 1
    return out


spline_filter1d.launches = 0
spline_filter1d.routes = {"tile": 0, "lines": 0, "writeback": 0}
spline_filter1d.writeback_routes = {"product": 0, "rows": 0}


def spline_filter1d_transpose(x: torch.Tensor, order: int,
                              axis: int) -> torch.Tensor:
    """The exact transpose of :func:`spline_filter1d` along ``axis`` (no
    integer writeback: the gradient path is linear). Orders 0 and 1 return
    ``x`` as it is. A CPU tensor takes
    :func:`spline_filter1d_transpose_plain`; a CUDA tensor launches K4
    (contiguous float32 or float64 only) on the route of
    :func:`_tile_plan` and adds one to
    ``spline_filter1d_transpose.launches`` and to its route's count in
    ``spline_filter1d_transpose.routes``.
    """
    if order <= 1:
        return x
    if x.device.type == "cpu":
        return spline_filter1d_transpose_plain(x, order, axis)
    check_kernel_tensor(x, "spline_filter1d_transpose")
    plan = _plan_for(x, axis)
    out = _launch_transpose(x, order, axis, "mirror", plan)
    spline_filter1d_transpose.launches += 1
    spline_filter1d_transpose.routes[plan.route] += 1
    return out


spline_filter1d_transpose.launches = 0
spline_filter1d_transpose.routes = {"tile": 0, "lines": 0}


def spline_filter1d_bc(x: torch.Tensor, order: int, axis: int,
                       bc: str, fixed_order: bool = False,
                       finite: bool = False) -> torch.Tensor:
    """Spline prefilter of ``x`` along ``axis`` under the boundary condition
    ``bc``, ``'reflect'`` or ``'wrap'`` (the mirror one is
    :func:`spline_filter1d`). Orders 0 and 1 return ``x`` as it is. A CPU
    tensor takes :func:`spline_filter1d_bc_plain`; a CUDA tensor launches K6
    (contiguous float32 or float64 only) on the route of :func:`_tile_plan`,
    or with ``fixed_order`` K2's writeback route on ``filter_matrix_bc``
    with no cast (``finite`` as for :func:`spline_filter1d`), and adds one
    to ``spline_filter1d_bc.launches``, to its route's count in
    ``spline_filter1d_bc.routes`` and, on the writeback route, to its
    form's count in ``spline_filter1d_bc.writeback_routes``.
    """
    if order <= 1:
        return x
    if x.device.type == "cpu":
        return spline_filter1d_bc_plain(x, order, axis, bc, fixed_order)
    check_kernel_tensor(x, "spline_prefilter_bc")
    if fixed_order:
        plan = _writeback_plan_for(x, axis)
        out = _launch_bc_filter(x, order, axis, bc, plan, True, finite)
        spline_filter1d_bc.writeback_routes[plan.route] += 1
        route = "writeback"
    else:
        plan = _plan_for(x, axis)
        out = _launch_bc_filter(x, order, axis, bc, plan)
        route = plan.route
    spline_filter1d_bc.launches += 1
    spline_filter1d_bc.routes[route] += 1
    return out


spline_filter1d_bc.launches = 0
spline_filter1d_bc.routes = {"tile": 0, "lines": 0, "writeback": 0}
spline_filter1d_bc.writeback_routes = {"product": 0, "rows": 0}


def spline_filter1d_bc_transpose(x: torch.Tensor, order: int, axis: int,
                                 bc: str) -> torch.Tensor:
    """The exact transpose of :func:`spline_filter1d_bc` along ``axis``.
    Orders 0 and 1 return ``x`` as it is. A CPU tensor takes
    :func:`spline_filter1d_bc_transpose_plain`; a CUDA tensor launches K7
    on the route of :func:`_tile_plan` and adds one to
    ``spline_filter1d_bc_transpose.launches`` and to its route's count in
    ``spline_filter1d_bc_transpose.routes``.
    """
    if order <= 1:
        return x
    if x.device.type == "cpu":
        return spline_filter1d_bc_transpose_plain(x, order, axis, bc)
    check_kernel_tensor(x, "spline_prefilter_bc_transpose")
    plan = _plan_for(x, axis)
    out = _launch_transpose(x, order, axis, bc, plan)
    spline_filter1d_bc_transpose.launches += 1
    spline_filter1d_bc_transpose.routes[plan.route] += 1
    return out


spline_filter1d_bc_transpose.launches = 0
spline_filter1d_bc_transpose.routes = {"tile": 0, "lines": 0}
