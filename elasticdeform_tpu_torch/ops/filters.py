"""The linear ndimage filter tier: 1-D and N-D correlation with SciPy's
filter boundary modes, and their exact transposes.

Counterpart of the JAX package's ``ops/filters.py``. There each 1-D filter
is a dense banded ``(n, n)`` matrix applied by a ``tensordot`` and the N-D
correlation a stack of such matrices; here they are stencils:

* :func:`correlate1d` is the wrapper of kernel K8 (``csrc/filters.cu``):
  ``out[i] = sum_k w[k] * x[fold(i + k - c)]`` along one axis, in the
  direct tap order or, for integer outputs, SciPy's paired order
  (``pair`` = 1 symmetric, -1 antisymmetric; the JAX package's
  ``apply_paired1d``). Its plain version :func:`correlate1d_plain` sums the
  same taps over slices of :func:`pad_axis`. Two routes, which
  :func:`_line_plan` picks (K8T's plan): ``"tile"`` stages W whole lines
  on K8T's line tile with the taps and a table of the pads' folds
  (:func:`_k8_edges`), ``"lines"`` is the old kernel (lines past the tile,
  tensors of 2^31 elements or more); both sum in one order, bit for bit. A
  NaN or an infinity, in the input or as ``cval``, reaches only the outputs
  whose taps read it, as in SciPy (note R12 of ``ROADMAP.md``; the JAX
  package's dense matrix spreads it over the line).
* :func:`correlate1d_transpose` is the wrapper of kernel K8T, the
  transpose: the correlation with the flipped taps into the padded extent,
  then each pad folded back onto the line (constant-mode pads dropped).
  Plain version :func:`correlate1d_transpose_plain`. Two routes, which
  :func:`_line_plan` picks: ``"tile"`` stages W whole lines in
  shared memory (K4's line tile, ``prefilter._tile_plan``) with the taps
  and an edge table of fold lists (:func:`_k8t_edges`), ``"lines"`` runs
  one thread per output in device memory (lines past the tile, tensors of
  2^31 elements or more); both sum in one order, bit for bit.
* :func:`correlate_nd` (K9) and :func:`correlate_nd_transpose` (K9T): the
  same for an N-D kernel, over its nonzero taps in raster order, with the
  fold on every axis. Axes where the kernel has extent 1 are batch axes;
  runs of them are merged before the launch, and the kernels take at most
  :data:`MAX_ND_AXES` axes after that. Each takes one of two routes, which
  :func:`_nd_plan` picks from the shapes: ``"tile"`` stages each block's
  halo box in shared memory (at most three axes where the kernel has extent
  > 1; K9's box holds the input folded by the mode or ``cval``, K9T's the
  cotangent), ``"nd"`` runs one thread per output in device memory
  (everything else). K9's two routes add the same terms in one order, bit
  for bit.

On a CPU tensor each wrapper takes its plain version; on a CUDA tensor it
launches its kernel (contiguous float32 or float64) or raises, and adds one
to its ``.launches`` counter and to its route's count in ``.routes``; the
taps, fold lists and tables go to the card once per kernel, shape and
device (``_k8_tables``, ``_k8t_tables``, ``_nd_tables``,
``_nd_tile_tables``).
:class:`Correlate1d` and :class:`CorrelateNd` are the autograd functions
(gradient to ``x`` only: the taps and ``cval`` are host constants, as in the
JAX package). The ``apply_*`` functions are the JAX package's, on tensors;
the numpy helpers (kernels, folds, dense filter matrices for the tests) are
this package's own copies.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from elasticdeform_tpu_torch.ops import _build
from elasticdeform_tpu_torch.ops import prefilter as _pf
from elasticdeform_tpu_torch.ops.prefilter import SMEM_LIMIT, _lines
from elasticdeform_tpu_torch.ops.resample import check_kernel_tensor

# K9 and K9T's fixed limit on the axes left after merging batch axes
# (ED_FILTER_MAXR in csrc/filters.cu)
MAX_ND_AXES = 8

_FILTER_MODES = ("reflect", "constant", "nearest", "mirror", "wrap")
_MODE_ALIASES = {"grid-mirror": "reflect", "grid-wrap": "wrap",
                 "grid-constant": "constant"}
# kernel codes of the filter modes (csrc/filters.cu)
_MODE_CODES = {"nearest": 0, "wrap": 1, "reflect": 2, "mirror": 3,
               "constant": 4}


# ---------------------------------------------------------------------------
# host-side numpy (float64)


def gaussian_kernel1d(sigma, order, radius):
    """The SciPy Gaussian (derivative) kernel, ``radius`` taps each side;
    ``order`` is the derivative order (Hermite-polynomial recursion)."""
    if order < 0:
        raise ValueError("order must be non-negative")
    sigma2 = sigma * sigma
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi_x = np.exp(-0.5 / sigma2 * x ** 2)
    phi_x = phi_x / phi_x.sum()
    if order == 0:
        return phi_x
    q = np.zeros(order + 1)
    q[0] = 1
    D = np.diag(np.arange(1, order + 1), 1)      # q -> q'
    P = np.diag(np.ones(order), -1) / -sigma2    # q -> q * p'
    for _ in range(order):
        q = (D + P).dot(q)
    return (x[:, None] ** np.arange(order + 1)).dot(q) * phi_x


def _fold_index(j, n, mode):
    """SciPy's filter-mode extension of index ``j`` into ``[0, n)`` (the
    filter modes, not the interpolation modes of ``ops/modes.py``)."""
    if mode == "nearest":
        return min(max(j, 0), n - 1)
    if mode == "wrap":
        return j % n
    if mode == "reflect":                        # (d c b a | a b c d |
        period = 2 * n
        j = j % period
        return j if j < n else period - 1 - j
    if mode == "mirror":                         # (d c b | a b c d |
        if n == 1:
            return 0
        period = 2 * n - 2
        j = j % period
        return j if j < n else period - j
    raise ValueError(f"unsupported filter mode: {mode}")


@functools.lru_cache(maxsize=None)
def filter_matrix(n, weights_key, mode, center=None):
    """``(M, b)``: correlation along an axis of length ``n`` with the taps
    ``weights_key`` under ``mode`` as a dense matrix, plus the
    constant-mode weight per row that multiplies ``cval``. ``center`` is the
    tap aligned with the output (default: the middle of an odd kernel)."""
    weights = np.asarray(weights_key, dtype=np.float64)
    r = (len(weights) - 1) // 2 if center is None else int(center)
    if not 0 <= r < len(weights):
        raise ValueError("origin shifts the filter off its support "
                         f"(center {r} for {len(weights)} taps).")
    M = np.zeros((n, n))
    b = np.zeros((n,))
    for k, w in enumerate(weights):
        off = k - r
        for i in range(n):
            j = i + off
            if 0 <= j < n:
                M[i, j] += w
            elif mode == "constant":
                b[i] += w
            else:
                M[i, _fold_index(j, n, mode)] += w
    return M, b


def gaussian_weights(sigma, order, truncate, radius):
    """The taps of ``gaussian_filter1d`` as ``correlate1d`` applies them
    (the kernel reversed), after SciPy's checks of ``sigma`` and
    ``radius``."""
    sigma = float(sigma)
    if sigma <= 0:
        raise ValueError("sigma must be positive")
    if radius is None:
        radius = int(float(truncate) * sigma + 0.5)
    radius = int(radius)
    if radius < 0:
        raise ValueError("radius must be a nonnegative integer")
    return gaussian_kernel1d(sigma, int(order), radius)[::-1].copy()


def gaussian_filter1d_matrix(n, sigma, order, mode, truncate, radius):
    """Filter matrix and bias of ``gaussian_filter1d`` on a line of ``n``."""
    return filter_matrix(int(n), tuple(gaussian_weights(
        sigma, order, truncate, radius).tolist()), mode)


_DBL_EPS = float(np.finfo(np.float64).eps)


def _scipy_pair_class(weights):
    """SciPy ``NI_Correlate1D``'s symmetry test: odd length and taps equal
    (1) or negated (-1) across the centre within DBL_EPSILON; 0 takes the
    general left-to-right order."""
    L = len(weights)
    if not L & 1:
        return 0
    s1 = L // 2
    fw = np.asarray(weights, np.float64)
    if all(abs(fw[s1 + i] - fw[s1 - i]) <= _DBL_EPS
           for i in range(1, s1 + 1)):
        return 1
    if all(abs(fw[s1 + i] + fw[s1 - i]) <= _DBL_EPS
           for i in range(1, s1 + 1)):
        return -1
    return 0


def normalize_sequence(value, n, name):
    """Broadcast a scalar to ``n`` entries or check a sequence's length
    (SciPy's ``_normalize_sequence``)."""
    if isinstance(value, (list, tuple, np.ndarray)):
        seq = list(value)
        if len(seq) != n:
            raise RuntimeError(
                f"{name} must have length equal to input rank ({n}); "
                f"got {len(seq)}")
        return seq
    return [value] * n


def check_mode(mode):
    """An N-D filter's mode name, ``grid-*`` aliases resolved."""
    mode = _MODE_ALIASES.get(mode, mode)
    if mode not in _FILTER_MODES:
        raise RuntimeError(f"boundary mode not supported: {mode!r}")
    return mode


def filter_mode(mode):
    """A 1-D filter's mode name: one of the five, as in the JAX package,
    whose 1-D tier takes no ``grid-*`` alias (its error for any other
    name)."""
    if mode not in _FILTER_MODES:
        raise ValueError(f"unsupported filter mode: {mode}")
    return mode


def _normalize_axes(axes, ndim):
    if axes is None:
        return tuple(range(ndim))
    if np.isscalar(axes):
        axes = (axes,)
    axes = tuple(int(a) % ndim for a in axes)
    if len(set(axes)) != len(axes):
        raise ValueError("axes must be unique")
    return axes


def _expand_to_ndim(arr, ndim, axes):
    """Singleton dims inserted so a ``len(axes)``-D kernel covers the full
    rank (SciPy's ``_expand_footprint``)."""
    arr = np.asarray(arr)
    if arr.ndim == ndim:
        return arr
    return np.expand_dims(
        arr, tuple(ax for ax in range(ndim) if ax not in axes))


@functools.lru_cache(maxsize=None)
def _fold_indices(n, lo, hi, mode):
    return np.array([_fold_index(j, n, mode) for j in range(-lo, n + hi)],
                    dtype=np.int64)


@functools.lru_cache(maxsize=None)
def fold_lists(n, lo, hi, mode):
    """Per position ``j`` of a line of ``n``, the positions of its padded
    extent ``[-lo, n + hi)`` that fold onto it: ``j`` itself first, then the
    pads in order (left ones, then right ones). Constant mode drops the
    pads. Returns CSR arrays ``(ptr, pos)`` (int32)."""
    rows = [[j] for j in range(n)]
    if mode != "constant":
        for p in list(range(-lo, 0)) + list(range(n, n + hi)):
            rows[_fold_index(p, n, mode)].append(p)
    ptr = np.zeros(n + 1, dtype=np.int32)
    ptr[1:] = np.cumsum([len(r) for r in rows])
    pos = np.array([p for r in rows for p in r], dtype=np.int32)
    return ptr, pos


# ---------------------------------------------------------------------------
# plain versions (torch, any device)


def pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int, mode: str,
             cval) -> torch.Tensor:
    """Extend one axis by ``(lo, hi)`` under a filter mode: one
    ``index_select`` with numpy fold indices, or ``cval`` blocks in
    constant mode (``cval`` a Python number that ``x``'s dtype holds). Any
    width works; the fold repeats as SciPy's does."""
    if lo == 0 and hi == 0:
        return x
    n = int(x.shape[axis])
    if mode == "constant":
        def block(k):
            shape = list(x.shape)
            shape[axis] = k
            return torch.full(shape, cval, dtype=x.dtype, device=x.device)
        return torch.cat([block(lo), x, block(hi)], axis)
    idx = torch.as_tensor(_fold_indices(n, int(lo), int(hi), mode),
                          device=x.device)
    return torch.index_select(x, axis, idx)


def pad_all(x: torch.Tensor, pads, modes, cval) -> torch.Tensor:
    for ax, ((lo, hi), mode) in enumerate(zip(pads, modes)):
        x = pad_axis(x, ax, lo, hi, mode, cval)
    return x


def unpad_axis(p: torch.Tensor, axis: int, lo: int, hi: int, mode: str
               ) -> torch.Tensor:
    """The transpose of :func:`pad_axis`: the line's own extent plus each
    pad added onto the position it folds to (``index_add_``, pads in
    order); constant mode drops the pads."""
    n = int(p.shape[axis]) - lo - hi
    out = p.narrow(axis, lo, n).clone()
    if mode == "constant" or lo + hi == 0:
        return out
    src = torch.cat([p.narrow(axis, 0, lo), p.narrow(axis, lo + n, hi)],
                    axis)
    idx = _fold_indices(n, int(lo), int(hi), mode)
    targets = np.concatenate([idx[:lo], idx[lo + n:]])
    return out.index_add_(axis, torch.as_tensor(targets, device=p.device),
                          src)


def correlate1d_plain(x: torch.Tensor, weights, axis: int, mode: str, cval,
                      center: int, pair: int = 0) -> torch.Tensor:
    """Plain version of K8: the taps summed over slices of the padded line,
    ``acc = x_0 w_0``, then ``acc + x_k w_k`` for k = 1..L-1; or, with
    ``pair``, SciPy's paired order ``acc = x_s w_s``, then ``acc + (x_{s-i}
    +- x_{s+i}) w_{s-i}`` for i = s..1, s = L // 2."""
    w = np.asarray(weights, dtype=np.float64)
    L, n = len(w), int(x.shape[axis])
    xp = pad_axis(x, axis, center, L - 1 - center, mode, cval)

    def sl(k):
        return xp.narrow(axis, k, n)

    if pair == 0:
        acc = sl(0) * float(w[0])
        for k in range(1, L):
            acc = acc + sl(k) * float(w[k])
        return acc
    s1 = L // 2
    acc = sl(s1) * float(w[s1])
    for ii in range(s1, 0, -1):
        t = sl(s1 - ii) + sl(s1 + ii) if pair > 0 else \
            sl(s1 - ii) - sl(s1 + ii)
        acc = acc + t * float(w[s1 - ii])
    return acc


def correlate1d_transpose_plain(g: torch.Tensor, weights, axis: int,
                                mode: str, center: int) -> torch.Tensor:
    """Plain version of K8T: ``g w_k`` added into the padded extent at
    shift k (k = 0..L-1, in order), then :func:`unpad_axis`."""
    w = np.asarray(weights, dtype=np.float64)
    L, n = len(w), int(g.shape[axis])
    shape = list(g.shape)
    shape[axis] = n + L - 1
    p = torch.zeros(shape, dtype=g.dtype, device=g.device)
    for k in range(L):
        sl = p.narrow(axis, k, n)
        sl.copy_(sl + g * float(w[k]))
    return unpad_axis(p, axis, center, L - 1 - center, mode)


def _nd_taps(w: np.ndarray):
    """The nonzero taps of an N-D kernel in raster order (SciPy's walk)."""
    return list(zip(*np.nonzero(w)))


def correlate_nd_plain(x: torch.Tensor, weights, centers, mode: str,
                       cval) -> torch.Tensor:
    """Plain version of K9: the nonzero taps in raster order summed over
    slices of the padded array, ``acc = x_t0 w_t0``, then ``acc + x_t w_t``.
    An all-zero kernel gives zeros."""
    w = np.asarray(weights, dtype=np.float64)
    taps = _nd_taps(w)
    if not taps:
        return torch.zeros_like(x)
    pads = [(c, k - 1 - c) for k, c in zip(w.shape, centers)]
    xp = pad_all(x, pads, [mode] * x.dim(), cval)
    acc = None
    for tap in taps:
        sl = xp[tuple(slice(int(t), int(t) + n)
                      for t, n in zip(tap, x.shape))]
        term = sl * float(w[tap])
        acc = term if acc is None else acc + term
    return acc


def correlate_nd_transpose_plain(g: torch.Tensor, weights, centers,
                                 mode: str) -> torch.Tensor:
    """Plain version of K9T: ``g w_t`` added into the padded extent at each
    nonzero tap in raster order, then :func:`unpad_axis` on every axis,
    the last first (the transpose of :func:`pad_all`)."""
    w = np.asarray(weights, dtype=np.float64)
    pads = [(c, k - 1 - c) for k, c in zip(w.shape, centers)]
    p = torch.zeros([n + lo + hi for n, (lo, hi) in zip(g.shape, pads)],
                    dtype=g.dtype, device=g.device)
    for tap in _nd_taps(w):
        sl = p[tuple(slice(int(t), int(t) + n)
                     for t, n in zip(tap, g.shape))]
        sl.copy_(sl + g * float(w[tap]))
    for ax in range(g.dim() - 1, -1, -1):
        p = unpad_axis(p, ax, pads[ax][0], pads[ax][1], mode)
    return p


# ---------------------------------------------------------------------------
# kernel wrappers (K8, K8T, K9, K9T)


def _lib():
    lib = _build.library("filters")
    if lib.ed_correlate1d.argtypes is None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn = lib.ed_correlate1d
        fn.restype = i
        fn.argtypes = [i, vp, vp, vp, ll, ll, ll, i, i, i, i,
                       ctypes.c_double, vp]
        fn = lib.ed_correlate1d_tile
        fn.restype = i
        fn.argtypes = [i, vp, vp, vp, vp, ll, ll, ll, i, i, i, i,
                       ctypes.c_double] + [i] * 9 + [ll, vp]
        fn = lib.ed_correlate1d_transpose
        fn.restype = i
        fn.argtypes = [i, vp, vp, vp, vp, vp, ll, ll, ll, i, i, vp]
        fn = lib.ed_correlate1d_transpose_tile
        fn.restype = i
        fn.argtypes = [i, vp, vp, vp, vp, ll, ll, ll] + [i] * 13 + [ll, vp]
        fn = lib.ed_correlate_nd
        fn.restype = i
        fn.argtypes = [i, i, vp, vp, vp, vp, vp, vp, vp, i,
                       ctypes.POINTER(ll), ctypes.POINTER(i),
                       ctypes.POINTER(i), ctypes.POINTER(i), i, i,
                       ctypes.c_double, vp]
        fn = lib.ed_correlate_nd_transpose_tile
        fn.restype = i
        pi, pl = ctypes.POINTER(i), ctypes.POINTER(ll)
        fn.argtypes = [i, vp, vp, vp, vp, vp, vp, pi, pl, pi, pi, pi, i, pl,
                       pl, i, i, i, ll, vp]
        fn = lib.ed_correlate_nd_tile
        fn.restype = i
        fn.argtypes = [i, vp, vp, vp, vp, pi, pl, pi, pi, i, pl, pl, i, i,
                       ctypes.c_double, i, i, ll, vp]
    return lib


_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def _stream(x: torch.Tensor) -> int:
    """The raw current stream of ``x``'s card (no Stream object built: the
    morphology driver launches K13 dozens of times a call)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


class K8tEdges(NamedTuple):
    """K8T's tile-route view of a line's fold lists: positions ``[a, b)``
    are plain (fold list ``[j]``, every tap inside the line: the lines
    route's interior branch); the ``rows`` others, ``j < a`` then ``j >=
    b``, keep their fold lists in ``table``, int32 CSR arrays (``rows + 1``
    offsets, then ``npos`` positions)."""
    a: int
    b: int
    rows: int
    npos: int
    table: np.ndarray


@functools.lru_cache(maxsize=None)
def _k8t_edges(n: int, taps: int, center: int, mode: str) -> K8tEdges:
    """The edge table of K8T's tile route on a line of ``n`` with ``taps``
    taps, tap ``center`` on the output: ``[a, b)`` is the longest run of
    plain positions (in the filter tier's modes about ``taps - 1`` rows are
    left, near the two ends)."""
    ptr, pos = fold_lists(n, center, taps - 1 - center, mode)
    j = np.arange(n)
    plain = (np.diff(ptr) == 1) & (j + center - (taps - 1) >= 0) & \
        (j + center < n)
    a = b = 0
    start = None
    for i, ok in enumerate(list(plain) + [False]):
        if ok and start is None:
            start = i
        elif not ok and start is not None:
            if i - start > b - a:
                a, b = start, i
            start = None
    rows = list(range(a)) + list(range(b, n))
    eptr = np.zeros(len(rows) + 1, dtype=np.int32)
    epos = [pos[ptr[r]:ptr[r + 1]] for r in rows]
    eptr[1:] = np.cumsum([len(e) for e in epos])
    epos = np.concatenate(epos) if epos else np.zeros(0, np.int32)
    table = np.concatenate([eptr, epos]).astype(np.int32)
    return K8tEdges(a, b, len(rows), len(epos), table)


# K8's and K8T's tile routes (csrc/filters.cu ED_K8T_THREADS): threads a
# block, and blocks an SM their kernels' registers allow (launch bounds of
# 64 a thread; K8's float64 window takes 85, so 3 blocks)
LINE_THREADS = 256
LINE_BLOCKS = 4


def k8_sm_blocks(dtype) -> int:
    """The blocks an SM that K8's tile kernel allows in ``dtype``."""
    return 3 if dtype == torch.float64 else LINE_BLOCKS


class LinePlan(NamedTuple):
    """How K8 or K8T runs on an ``(outer, n, inner)`` view: ``route``
    ``"tile"`` or ``"lines"``; for a tile, the line tile ``tile`` (a
    :class:`~elasticdeform_tpu_torch.ops.prefilter.TilePlan` of
    ``_tile_plan``) and ``smem``, the block's shared bytes: the tile, the
    taps and the edge table; ``gather``: a packed tile's outputs gather in
    a second tile in shared memory (where it fits), stored as one run;
    ``sm_blocks``: the blocks an SM the kernel's registers allow."""
    route: str
    tile: _pf.TilePlan | None = None
    smem: int = 0
    gather: bool = False
    sm_blocks: int = LINE_BLOCKS


@functools.lru_cache(maxsize=1024)
def _line_plan(outer: int, n: int, inner: int, dtype, taps: int,
               table: int, width=None, route=None, sms: int = 132,
               sm_blocks: int = LINE_BLOCKS) -> LinePlan:
    """The launch of K8 or K8T on an ``(outer, n, inner)`` view of a
    ``dtype`` tensor with ``taps`` taps and an edge table of ``table`` int32
    entries (:func:`_k8_edges`, :func:`_k8t_edges`): the tile route for
    lines up to :func:`~elasticdeform_tpu_torch.ops.prefilter.tile_cap`
    whose tile, taps and table fit :data:`SMEM_LIMIT`, in a tensor of fewer
    than 2^31 elements, else the lines route. The tile is K4's
    (``_tile_plan``), at the width of ``TILE_WIDTHS`` whose blocks, at this
    plan's shared bytes and at most ``sm_blocks`` blocks an SM (K8T's
    :data:`LINE_BLOCKS`, K8's :func:`k8_sm_blocks`), fill the fewest rounds
    of ``sms`` SMs (:func:`line_waves`; the first among equals), among the
    widths whose packed tile gathers its outputs where one does. ``width``
    and ``route``
    force a choice; a forced tile that does not fit raises ValueError.
    Cached: the wrappers ask for a plan at every launch."""
    if route not in (None, "tile", "lines"):
        raise ValueError(f"route must be 'tile' or 'lines', got {route!r}")
    item = _pf._ITEMSIZE[dtype]
    extra = taps * item + 4 * table
    fits = n <= _pf.tile_cap(dtype) and outer * n * inner < 2 ** 31
    if route == "lines" or (route is None and not fits):
        return LinePlan("lines")
    if not fits:
        raise ValueError(f"the line tile does not take lines of {n} "
                         f"({dtype}) in a tensor of {outer * n * inner} "
                         "elements")
    plans = []
    for w in (_pf.TILE_WIDTHS if width is None else (width,)):
        try:
            tile = _pf._tile_plan(outer, n, inner, dtype, w)
        except ValueError:
            continue
        # a packed tile gathers its outputs in a second tile where it fits
        for gather in ((True, False) if tile.packed else (False,)):
            plan = LinePlan("tile", tile, tile.smem * (1 + gather) + extra,
                            gather, sm_blocks)
            if plan.smem <= SMEM_LIMIT:
                plans.append(plan)
                break
    if not plans:
        if route is None:
            return LinePlan("lines")
        raise ValueError(f"the line tile: a tile of lines of {n}, "
                         f"{taps} taps and {table} table entries do not fit "
                         f"{SMEM_LIMIT} bytes")
    # a packed tile that stores its outputs directly writes a line apart in
    # each lane (K8 at c13's innermost float64 axis on an H100: 1.79 ms at
    # W = 64 storing directly, 0.76 at W = 32 gathered): where a width
    # gathers, take one
    gathered = [p for p in plans if p.gather]
    return min(gathered or plans, key=lambda p: line_waves(p, sms))


def line_waves(plan: LinePlan, sms: int) -> int:
    """How many rounds of blocks K8's or K8T's tile plan takes on ``sms``
    SMs: as many blocks an SM as its shared memory takes, at most the
    plan's ``sm_blocks``."""
    per_sm = min(_pf._SM_SMEM // (plan.smem + 1024), plan.sm_blocks)
    return -(-plan.tile.blocks // (sms * per_sm))


class K8Edges(NamedTuple):
    """K8's tile-route view of a line: outputs ``[a, b)`` read only samples
    inside it (the lines route's interior branch); the others read the
    samples that the pads of the padded line ``[-center, n + taps-1-center)``
    fold onto, ``table``: int32, the ``center`` left pads, then the ``taps
    - 1 - center`` right ones, each the sample index folded by the mode, or
    -1 where constant mode reads ``cval``."""
    a: int
    b: int
    table: np.ndarray


@functools.lru_cache(maxsize=None)
def _k8_edges(n: int, taps: int, center: int, mode: str) -> K8Edges:
    """The pad table of K8's tile route on a line of ``n`` with ``taps``
    taps, tap ``center`` on the output, and its plain run ``[a, b) =
    [center, n - taps + 1 + center)`` where that is not empty (else no
    plain output)."""
    a, b = center, n - (taps - 1) + center
    if a >= b:
        a = b = 0
    pads = list(range(-center, 0)) + list(range(n, n + taps - 1 - center))
    table = [-1 if mode == "constant" else _fold_index(j, n, mode)
             for j in pads]
    return K8Edges(a, b, np.asarray(table, dtype=np.int32))


@functools.lru_cache(maxsize=64)
def _k8_tables(wkey: bytes, mode: str, n: int, center: int, dtype, device):
    """K8's arguments, uploaded once per taps, mode, line length, centre,
    dtype and device: the taps and the edge table (the tile route) on
    ``device``, and the :class:`K8Edges`."""
    w = np.frombuffer(wkey, dtype=np.float64)
    edges = _k8_edges(n, len(w), center, mode)
    return (torch.as_tensor(w.copy()).to(device=device, dtype=dtype),
            torch.as_tensor(edges.table).to(device), edges)


def _launch_line(x: torch.Tensor, weights, axis: int, mode: str, cval,
                 center: int, pair: int, plan: LinePlan) -> torch.Tensor:
    """K8 on a CUDA tensor on the route ``plan`` names. Counts nothing
    (the public wrapper counts)."""
    check_kernel_tensor(x, "correlate1d")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    outer, n, inner = _lines(x, axis)
    w = np.ascontiguousarray(weights, dtype=np.float64)
    w_d, table_d, e = _k8_tables(w.tobytes(), mode, n, int(center), x.dtype,
                                 x.device)
    lib = _lib()
    args = (len(w), int(center), _MODE_CODES[mode], int(pair), float(cval))
    if plan.route == "lines":
        err = lib.ed_correlate1d(
            _DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(),
            w_d.data_ptr(), outer, n, inner, *args, _stream(x))
    else:
        t = plan.tile
        err = lib.ed_correlate1d_tile(
            _DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(),
            w_d.data_ptr(), table_d.data_ptr(), outer, n, inner, *args, e.a,
            e.b, int(plan.gather), t.width, int(t.packed), t.lines, t.stride,
            t.smem, plan.smem, t.blocks, _stream(x))
    _build.check(err, lib, "ed_filters_error_string", "correlate1d")
    return out


def correlate1d(x: torch.Tensor, weights, axis: int, mode: str, cval,
                center: int, pair: int = 0) -> torch.Tensor:
    """Correlation of ``x`` along ``axis`` with the taps ``weights``
    (float64 numpy), tap ``center`` on the output, filter mode ``mode``
    (``cval`` beyond the edge in constant mode), in the direct or, with
    ``pair``, SciPy's paired order. A CPU tensor takes
    :func:`correlate1d_plain`; a CUDA tensor launches K8 (contiguous
    float32 or float64) on the route of :func:`_line_plan` and adds one to
    ``correlate1d.launches`` and to its route's count in
    ``correlate1d.routes``."""
    axis = axis % x.dim()
    if x.device.type == "cpu":
        return correlate1d_plain(x, weights, axis, mode, cval, center, pair)
    check_kernel_tensor(x, "correlate1d")
    if x.numel() == 0:
        return torch.empty_like(x)
    outer, n, inner = _lines(x, axis)
    L = len(weights)
    e = _k8_edges(n, L, int(center), mode)
    plan = _line_plan(outer, n, inner, x.dtype, L, len(e.table),
                      sms=_pf._sm_count(x.device),
                      sm_blocks=k8_sm_blocks(x.dtype))
    out = _launch_line(x, weights, axis, mode, cval, center, pair, plan)
    correlate1d.launches += 1
    correlate1d.routes[plan.route] += 1
    return out


correlate1d.launches = 0
correlate1d.routes = {"tile": 0, "lines": 0}


@functools.lru_cache(maxsize=64)
def _k8t_tables(wkey: bytes, mode: str, n: int, center: int, dtype,
                device):
    """K8T's arguments, uploaded once per taps, mode, line length, centre,
    dtype and device: the taps, the fold lists (``ptr``, ``pos``: the lines
    route) and the edge table (the tile route) on ``device``, and the
    :class:`K8tEdges`."""
    w = np.frombuffer(wkey, dtype=np.float64).copy()
    edges = _k8t_edges(n, len(w), center, mode)
    ptr, pos = fold_lists(n, center, len(w) - 1 - center, mode)

    def up(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dt)
    return (up(w, dtype), up(ptr, torch.int32), up(pos, torch.int32),
            up(edges.table, torch.int32), edges)


def _launch_line_transpose(g: torch.Tensor, weights, axis: int, mode: str,
                           center: int, plan: LinePlan) -> torch.Tensor:
    """K8T on a CUDA tensor on the route ``plan`` names. Counts nothing
    (the public wrapper counts)."""
    what = "correlate1d_transpose"
    check_kernel_tensor(g, what)
    out = torch.empty_like(g)
    if g.numel() == 0:
        return out
    outer, n, inner = _lines(g, axis)
    w = np.ascontiguousarray(weights, dtype=np.float64)
    w_d, ptr_d, pos_d, table_d, e = _k8t_tables(w.tobytes(), mode, n,
                                                int(center), g.dtype,
                                                g.device)
    lib = _lib()
    if plan.route == "lines":
        err = lib.ed_correlate1d_transpose(
            _DTYPE_CODES[g.dtype], g.data_ptr(), out.data_ptr(),
            w_d.data_ptr(), ptr_d.data_ptr(), pos_d.data_ptr(), outer, n,
            inner, len(w), int(center), _stream(g))
    else:
        t = plan.tile
        err = lib.ed_correlate1d_transpose_tile(
            _DTYPE_CODES[g.dtype], g.data_ptr(), out.data_ptr(),
            w_d.data_ptr(), table_d.data_ptr(), outer, n, inner, len(w),
            int(center), e.a, e.b, e.rows, e.npos, int(plan.gather),
            t.width, int(t.packed),
            t.lines, t.stride, t.smem, plan.smem, t.blocks, _stream(g))
    _build.check(err, lib, "ed_filters_error_string", what)
    return out


def correlate1d_transpose(g: torch.Tensor, weights, axis: int, mode: str,
                          center: int) -> torch.Tensor:
    """The exact transpose of :func:`correlate1d` (either order) along
    ``axis``. A CPU tensor takes :func:`correlate1d_transpose_plain`; a
    CUDA tensor launches K8T on the route of :func:`_line_plan`
    and adds one to ``correlate1d_transpose.launches`` and to its route's
    count in ``correlate1d_transpose.routes``."""
    axis = axis % g.dim()
    if g.device.type == "cpu":
        return correlate1d_transpose_plain(g, weights, axis, mode, center)
    check_kernel_tensor(g, "correlate1d_transpose")
    if g.numel() == 0:
        return torch.empty_like(g)
    outer, n, inner = _lines(g, axis)
    L = len(weights)
    e = _k8t_edges(n, L, int(center), mode)
    plan = _line_plan(outer, n, inner, g.dtype, L, len(e.table),
                                sms=_pf._sm_count(g.device))
    out = _launch_line_transpose(g, weights, axis, mode, center, plan)
    correlate1d_transpose.launches += 1
    correlate1d_transpose.routes[plan.route] += 1
    return out


correlate1d_transpose.launches = 0
correlate1d_transpose.routes = {"tile": 0, "lines": 0}


def nd_geometry(shape, kshape):
    """Runs of axes where the kernel has extent 1 (batch axes, offset 0)
    merged: returns ``(merged shape, group of each axis, batch flag per
    merged axis)``."""
    merged, group, batch = [], [], []
    for n, k in zip(shape, kshape):
        if k == 1 and batch and batch[-1]:
            merged[-1] *= int(n)
        else:
            merged.append(int(n))
            batch.append(k == 1)
        group.append(len(merged) - 1)
    return merged, group, batch


@functools.lru_cache(maxsize=16)
def _nd_tables(wkey, kshape, centers, mode, shape, transpose, device, dtype):
    """The nd route's arguments, built and uploaded once per kernel, mode,
    shape, direction and device: the taps' weights, per-axis and linear
    offsets and K9T's fold lists on ``device``, and the host arrays of
    ``ed_correlate_nd``."""
    w = np.frombuffer(wkey, dtype=np.float64).reshape(kshape)
    merged, group, batch = nd_geometry(shape, kshape)
    rank = len(merged)
    taps = _nd_taps(w)
    off = np.zeros((len(taps), rank), dtype=np.int32)
    for t, tap in enumerate(taps):
        for d, k in enumerate(tap):
            if not batch[group[d]]:
                off[t, group[d]] = int(k) - int(centers[d])
    strides = np.cumprod([1] + merged[::-1])[:-1][::-1]
    delta = off.astype(np.int64) @ strides.astype(np.int64)
    lo, hi = off.min(axis=0), off.max(axis=0)
    ptr_base = [-1] * rank
    ptrs, poss = [np.zeros(1, np.int32)], [np.zeros(1, np.int32)]
    if transpose and mode != "constant":
        base = 1
        for d in range(rank):
            if batch[d]:
                continue
            a = group.index(d)
            k, c = int(w.shape[a]), int(centers[a])
            ptr, pos = fold_lists(merged[d], c, k - 1 - c, mode)
            ptr_base[d] = base
            ptrs.append(ptr + sum(len(p) for p in poss))
            poss.append(pos)
            base += len(ptr)

    def up(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dt)
    dev = (up(np.array([w[t] for t in taps]), dtype), up(off, torch.int32),
           up(delta, torch.int64), up(np.concatenate(ptrs), torch.int32),
           up(np.concatenate(poss), torch.int32))
    i = ctypes.c_int
    host = (rank, (ctypes.c_longlong * rank)(*merged),
            (i * rank)(*lo.tolist()), (i * rank)(*hi.tolist()),
            (i * rank)(*ptr_base), len(taps))
    return dev, host


def _launch_nd(x: torch.Tensor, weights, centers, mode: str, cval,
               transpose: bool):
    """K9, or with ``transpose`` K9T on its nd route; None, with no launch,
    for an empty tensor or an all-zero kernel. Counts nothing (the public
    wrappers count)."""
    what = "correlate_nd_transpose" if transpose else "correlate_nd"
    check_kernel_tensor(x, what)
    w = np.ascontiguousarray(weights, dtype=np.float64)
    rank = len(nd_geometry(x.shape, w.shape)[0])
    if rank > MAX_ND_AXES:
        raise ValueError(
            f"{what}: after merging the axes where the kernel has extent 1 "
            f"the correlation has {rank} axes; the CUDA kernel takes at most "
            f"{MAX_ND_AXES}")
    if x.numel() == 0 or not w.any():
        return None
    dev, host = _nd_tables(w.tobytes(), w.shape,
                           tuple(int(c) for c in centers), mode,
                           tuple(x.shape), bool(transpose), x.device, x.dtype)
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.ed_correlate_nd(
        _DTYPE_CODES[x.dtype], int(transpose), x.data_ptr(), out.data_ptr(),
        *[a.data_ptr() for a in dev], *host, _MODE_CODES[mode], float(cval),
        _stream(x))
    _build.check(err, lib, "ed_filters_error_string", what)
    return out


# K9's and K9T's tile route (csrc/filters.cu): a block of 8 x 32 threads,
# each with a column of C outputs along tile axis 0, C one of TILE_COLUMNS
ND_TILE = (8, 32)
TILE_COLUMNS = (8, 4, 2, 1)
# the column a plan takes where tile axis 0 is long enough and the box
# fits: the fastest of TILE_COLUMNS at c14's shapes on an H100
# (chip_smoke.py, phase 4)
ND_COLUMN = 8


def _contiguous_strides(shape):
    return [math.prod(shape[d + 1:]) for d in range(len(shape))]


class HaloTile(NamedTuple):
    """The geometry of a tile route whose blocks stage their output tile's
    halo box (K9's and K9T's, and K11's and K12's in
    ``ops/morphology.py``) on a
    tensor of ``shape`` under a kernel of ``kshape``: :func:`nd_geometry`'s
    ``merged`` shape, ``group`` and ``batch``, the ``merged`` axes'
    ``strides``, and ``axes``, the count of axes where the kernel has
    extent > 1. The rest only where ``axes`` is 1 to 3: the merged axis on
    each of the three tile axes, -1 for an extent of 1 (the kernel's axes,
    and for fewer than three the innermost batch axes, in memory order);
    the batch axes the grid walks; per tile axis its extent ``n3``, element
    stride ``st3`` and the kernel's extent ``k3``; ``span``, the elements a
    sample's tile axes span."""
    merged: tuple
    group: tuple
    batch: tuple
    strides: tuple
    axes: int
    tile_axes: tuple = ()
    grid_axes: tuple = ()
    n3: tuple = ()
    st3: tuple = ()
    k3: tuple = ()
    span: int = 0

    def box(self, tile):
        """The halo box of a ``tile`` (three extents)."""
        return tuple(t + k - 1 for t, k in zip(tile, self.k3))

    def blocks(self, tile):
        """The tiles of extent ``tile`` times the walked batch."""
        return (math.prod(-(-n // t) for n, t in zip(self.n3, tile))
                * math.prod(self.merged[d] for d in self.grid_axes))

    def kernel_axes(self):
        """``(tile axis, kernel axis)`` of each tile axis on one of the
        kernel's axes."""
        return [(a, self.group.index(d)) for a, d in enumerate(self.tile_axes)
                if d >= 0 and not self.batch[d]]

    def grid_host(self):
        """The grid's batch axes as the C entry points take them: their
        count, extents and strides."""
        ll, nb = ctypes.c_longlong, len(self.grid_axes)
        return (nb, (ll * max(nb, 1))(*[self.merged[d]
                                        for d in self.grid_axes]),
                (ll * max(nb, 1))(*[self.strides[d] for d in self.grid_axes]))


@functools.lru_cache(maxsize=1024)
def halo_tile(shape, kshape) -> HaloTile:
    """The :class:`HaloTile` of a kernel of ``kshape`` on ``shape``."""
    merged, group, batch = nd_geometry(tuple(int(n) for n in shape),
                                       tuple(int(k) for k in kshape))
    strides = _contiguous_strides(merged)
    spatial = [d for d, b in enumerate(batch) if not b]
    head = (tuple(merged), tuple(group), tuple(batch), tuple(strides),
            len(spatial))
    if not 1 <= len(spatial) <= 3:
        return HaloTile(*head)
    extra = [d for d, b in enumerate(batch) if b][::-1][:3 - len(spatial)]
    axes = sorted(spatial + extra)
    tile_axes = (-1,) * (3 - len(axes)) + tuple(axes)
    n3 = tuple(merged[d] if d >= 0 else 1 for d in tile_axes)
    st3 = tuple(strides[d] if d >= 0 else 0 for d in tile_axes)
    k3 = tuple(1 if d < 0 or batch[d] else int(kshape[group.index(d)])
               for d in tile_axes)
    return HaloTile(*head, tile_axes,
                    tuple(d for d in range(len(merged)) if d not in axes),
                    n3, st3, k3, sum((n - 1) * st for n, st in zip(n3, st3)))


class NdPlan(NamedTuple):
    """How K9 or K9T runs on a tensor of ``shape`` with a kernel of
    ``kshape``:
    ``route`` ``"tile"`` or ``"nd"``. For a tile: the merged axis (of
    :func:`nd_geometry`) on each of the three tile axes, -1 for an extent
    of 1 (the kernel's axes, and for fewer than three the innermost batch
    axes, in memory order); the batch axes the grid walks; the ``column``
    C of outputs a thread keeps along tile axis 0; the halo ``box`` (the
    tile ``(C, 8, 32)`` grown by the kernel's extent - 1); ``smem``, the
    shared bytes of the box and of ``prod(kshape)`` taps; ``blocks``, the
    tiles times the walked batch."""
    route: str
    tile_axes: tuple = ()
    grid_axes: tuple = ()
    column: int = 0
    box: tuple = ()
    smem: int = 0
    blocks: int = 0


@functools.lru_cache(maxsize=1024)
def _nd_plan(shape, kshape, dtype, column=None, route=None,
             finite: bool = True) -> NdPlan:
    """The launch of K9 or K9T on a ``dtype`` tensor of ``shape`` with a
    kernel of ``kshape`` (both kernels share the tile, box and shared
    bytes): the tile route when the kernel has extent > 1 on one to three
    axes, a tile's box fits :data:`SMEM_LIMIT`, a sample's tile axes span
    fewer than 2^31 elements, the grid fewer than 2^31 blocks and the
    weights are ``finite`` (in K9T a staged zero times an infinite weight
    would be NaN where the nd route adds no term; K9 keeps the rule); else
    the nd route. The column is
    :data:`ND_COLUMN`, less where tile axis 0 is shorter (the next power of
    two) or has extent 1 (1), and halved until the box fits. ``column``
    and ``route`` force a choice (``chip_smoke.py`` times every column);
    a forced tile that does not fit raises ValueError. Cached: the wrapper
    asks for a plan at every launch."""
    if route == "nd":
        return NdPlan("nd")
    if route not in (None, "tile"):
        raise ValueError(f"route must be 'tile' or 'nd', got {route!r}")
    if column is not None and column not in TILE_COLUMNS:
        raise ValueError(f"column must be one of {TILE_COLUMNS}, got "
                         f"{column}")

    def refuse(why):
        if route == "tile":
            raise ValueError(f"K9's and K9T's tile route does not take "
                             f"{why}")
        return NdPlan("nd")

    if not finite:
        return refuse("non-finite weights")
    geo = halo_tile(shape, kshape)
    if not 1 <= geo.axes <= 3:
        return refuse(f"a kernel with extent > 1 on {geo.axes} axes")
    if geo.span >= 2 ** 31:
        return refuse("a sample of 2^31 elements or more")
    item = 4 if dtype == torch.float32 else 8
    taps = math.prod(kshape)
    n0 = geo.n3[0]
    if column is None:
        want = 1 if n0 <= 1 else min(ND_COLUMN, 1 << (n0 - 1).bit_length())
        columns = [c for c in TILE_COLUMNS if c <= want]
    else:
        columns = [column]
    for c in columns:
        box = geo.box((c,) + ND_TILE)
        smem = math.prod(box) * item + taps * (item + 4)
        if smem <= SMEM_LIMIT:
            break
    else:
        return refuse(f"a box and {taps} taps over {SMEM_LIMIT} bytes")
    blocks = geo.blocks((c,) + ND_TILE)
    if blocks >= 2 ** 31:
        return refuse(f"{blocks} blocks")
    return NdPlan("tile", geo.tile_axes, geo.grid_axes, c, box, smem,
                  blocks)


@functools.lru_cache(maxsize=16)
def _nd_tile_tables(wkey, kshape, centers, mode, shape, device, dtype):
    """K9's and K9T's tile-route arguments, built and uploaded once per
    kernel, mode, shape and device: the taps' weights and offsets along the
    three tile axes and K9T's fold lists on ``device``, and the host arrays
    of ``ed_correlate_nd_transpose_tile`` (K9 takes them less the fold
    lists' bases)."""
    w = np.frombuffer(wkey, dtype=np.float64).reshape(kshape)
    taps = _nd_taps(w)
    geo = halo_tile(shape, kshape)
    off = np.zeros((len(taps), 3), dtype=np.int32)
    hi3, base3 = [0] * 3, [-1] * 3
    ptrs, poss = [np.zeros(1, np.int32)], [np.zeros(1, np.int32)]
    for a, ax in geo.kernel_axes():
        k, c = kshape[ax], int(centers[ax])
        hi3[a] = k - 1 - c
        off[:, a] = [int(t[ax]) - c for t in taps]
        if mode != "constant":
            ptr, pos = fold_lists(geo.n3[a], c, k - 1 - c, mode)
            base3[a] = sum(len(p) for p in ptrs)
            ptrs.append(ptr + sum(len(p) for p in poss))
            poss.append(pos)
    i, ll = ctypes.c_int, ctypes.c_longlong
    host = ((i * 3)(*geo.n3), (ll * 3)(*geo.st3), (i * 3)(*geo.k3),
            (i * 3)(*hi3), (i * 3)(*base3), *geo.grid_host(), len(taps))

    def up(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dt)
    dev = (up(np.array([w[t] for t in taps]), dtype), up(off, torch.int32),
           up(np.concatenate(ptrs), torch.int32),
           up(np.concatenate(poss), torch.int32))
    return dev, host


def _launch_nd_transpose(g: torch.Tensor, weights, centers, mode: str,
                         plan: NdPlan) -> torch.Tensor:
    """K9T on a CUDA tensor on the route ``plan`` names; zeros, with no
    launch, for an empty tensor or an all-zero kernel. Counts nothing (the
    public wrapper counts)."""
    what = "correlate_nd_transpose"
    check_kernel_tensor(g, what)
    w = np.ascontiguousarray(weights, dtype=np.float64)
    if g.numel() == 0 or not w.any():
        return torch.zeros_like(g)
    if plan.route == "nd":
        return _launch_nd(g, w, centers, mode, 0.0, True)
    (w_d, off_d, ptr_d, pos_d), host = _nd_tile_tables(
        w.tobytes(), w.shape, tuple(int(c) for c in centers), mode,
        tuple(g.shape), g.device, g.dtype)
    out = torch.empty_like(g)
    lib = _lib()
    err = lib.ed_correlate_nd_transpose_tile(
        _DTYPE_CODES[g.dtype], g.data_ptr(), out.data_ptr(), w_d.data_ptr(),
        off_d.data_ptr(), ptr_d.data_ptr(), pos_d.data_ptr(), *host,
        plan.column, plan.smem, plan.blocks, _stream(g))
    _build.check(err, lib, "ed_filters_error_string", what)
    return out


def _launch_correlate_nd(x: torch.Tensor, weights, centers, mode: str,
                         cval, plan: NdPlan):
    """K9 on a CUDA tensor on the route ``plan`` names; None, with no
    launch, for an empty tensor or an all-zero kernel. Counts nothing (the
    public wrapper counts)."""
    if plan.route == "nd":
        return _launch_nd(x, weights, centers, mode, cval, False)
    what = "correlate_nd"
    check_kernel_tensor(x, what)
    w = np.ascontiguousarray(weights, dtype=np.float64)
    if x.numel() == 0 or not w.any():
        return None
    (w_d, off_d, _, _), host = _nd_tile_tables(
        w.tobytes(), w.shape, tuple(int(c) for c in centers), mode,
        tuple(x.shape), x.device, x.dtype)
    n3, st3, k3, hi3, _, *grid = host
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.ed_correlate_nd_tile(
        _DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), w_d.data_ptr(),
        off_d.data_ptr(), n3, st3, k3, hi3, *grid, _MODE_CODES[mode],
        float(cval), plan.column, plan.smem, plan.blocks, _stream(x))
    _build.check(err, lib, "ed_filters_error_string", what)
    return out


def correlate_nd(x: torch.Tensor, weights, centers, mode: str,
                 cval) -> torch.Tensor:
    """N-D correlation of ``x`` with ``weights`` (float64 numpy, ``x``'s
    rank), tap ``centers[d]`` on the output along axis d, filter mode
    ``mode`` on every axis. A CPU tensor takes :func:`correlate_nd_plain`;
    a CUDA tensor launches K9 on the route of :func:`_nd_plan` and adds one
    to ``correlate_nd.launches`` and to its route's count in
    ``correlate_nd.routes`` (an all-zero kernel or an empty tensor gives
    zeros with no launch)."""
    if x.device.type == "cpu":
        return correlate_nd_plain(x, weights, centers, mode, cval)
    check_kernel_tensor(x, "correlate_nd")
    w = np.asarray(weights, dtype=np.float64)
    plan = _nd_plan(tuple(x.shape), w.shape, x.dtype,
                    finite=bool(np.isfinite(w).all()))
    out = _launch_correlate_nd(x, w, centers, mode, cval, plan)
    if out is None:
        return torch.zeros_like(x)
    correlate_nd.launches += 1
    correlate_nd.routes[plan.route] += 1
    return out


correlate_nd.launches = 0
correlate_nd.routes = {"tile": 0, "nd": 0}


def correlate_nd_transpose(g: torch.Tensor, weights, centers,
                           mode: str) -> torch.Tensor:
    """The exact transpose of :func:`correlate_nd`. A CPU tensor takes
    :func:`correlate_nd_transpose_plain`; a CUDA tensor launches K9T on
    the route of :func:`_nd_plan` and adds one to
    ``correlate_nd_transpose.launches`` and to its route's count in
    ``correlate_nd_transpose.routes`` (an all-zero kernel or an empty
    tensor gives zeros with no launch)."""
    if g.device.type == "cpu":
        return correlate_nd_transpose_plain(g, weights, centers, mode)
    check_kernel_tensor(g, "correlate_nd_transpose")
    w = np.asarray(weights, dtype=np.float64)
    if g.numel() == 0 or not w.any():
        return torch.zeros_like(g)
    plan = _nd_plan(tuple(g.shape), w.shape, g.dtype,
                    finite=bool(np.isfinite(w).all()))
    out = _launch_nd_transpose(g, w, centers, mode, plan)
    correlate_nd_transpose.launches += 1
    correlate_nd_transpose.routes[plan.route] += 1
    return out


correlate_nd_transpose.launches = 0
correlate_nd_transpose.routes = {"tile": 0, "nd": 0}


class Correlate1d(torch.autograd.Function):
    """:func:`correlate1d` (K8) as an autograd function of ``x``; the
    backward is :func:`correlate1d_transpose` (K8T)."""

    @staticmethod
    def forward(ctx, x, weights, axis, mode, cval, center, pair):
        ctx.args = (weights, axis, mode, center)
        return correlate1d(x, weights, axis, mode, cval, center, pair)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return (correlate1d_transpose(g.contiguous(), *ctx.args),
                None, None, None, None, None, None)


class CorrelateNd(torch.autograd.Function):
    """:func:`correlate_nd` (K9) as an autograd function of ``x``; the
    backward is :func:`correlate_nd_transpose` (K9T)."""

    @staticmethod
    def forward(ctx, x, weights, centers, mode, cval):
        ctx.args = (weights, centers, mode)
        return correlate_nd(x, weights, centers, mode, cval)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return (correlate_nd_transpose(g.contiguous(), *ctx.args),
                None, None, None, None)


# ---------------------------------------------------------------------------
# the JAX package's apply_* on tensors


def compute_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the filters' compute dtype, contiguous: float32 and float64
    stay, every other real dtype computes in float64 (the JAX package
    under x64)."""
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float64)
    return x.contiguous()


def apply_correlate1d(x: torch.Tensor, weights, axis: int, mode, cval,
                      origin, int_exact: bool = False) -> torch.Tensor:
    """SciPy ``correlate1d``: tap ``len(weights) // 2 + origin`` on the
    output. ``int_exact`` takes SciPy's paired order for a symmetric or
    antisymmetric kernel (integer outputs). Differentiable to ``x``."""
    weights = np.asarray(weights, dtype=np.float64)
    if weights.ndim != 1 or weights.size == 0:
        raise ValueError("weights must be a non-empty 1-D sequence")
    center = len(weights) // 2 + int(origin)
    if not 0 <= center < len(weights):
        raise ValueError("origin shifts the filter off its support "
                         f"(center {center} for {len(weights)} taps).")
    mode = filter_mode(mode)
    pair = _scipy_pair_class(weights) if int_exact else 0
    return Correlate1d.apply(compute_input(x), weights, axis % x.dim(), mode,
                             float(cval), center, pair)


def apply_filter1d(x: torch.Tensor, axis: int, sigma, order, mode, cval,
                   truncate, radius, int_exact: bool = False) -> torch.Tensor:
    """SciPy ``gaussian_filter1d`` along ``axis`` (the reversed Gaussian
    kernel, centred)."""
    return apply_correlate1d(x, gaussian_weights(sigma, order, truncate,
                                                 radius),
                             axis, mode, cval, 0, int_exact)


def apply_correlate(x: torch.Tensor, weights, mode, cval, origin,
                    convolution: bool = False) -> torch.Tensor:
    """SciPy ``correlate`` / ``convolve`` with an N-D kernel of ``x``'s
    rank; convolution flips the kernel and mirrors the origins.
    Differentiable to ``x``."""
    w = np.asarray(weights, dtype=np.float64)
    if w.ndim != x.dim():
        raise RuntimeError("filter weights array has incorrect shape.")
    if w.size == 0:
        raise ValueError("weights must not be empty")
    origins = [int(o) for o in normalize_sequence(origin, x.dim(), "origin")]
    if convolution:
        w = np.ascontiguousarray(w[(slice(None, None, -1),) * w.ndim])
        origins = [-o if k & 1 else -o - 1 for o, k in zip(origins, w.shape)]
    mode = check_mode(mode)
    centers = []
    for k, o in zip(w.shape, origins):
        c = k // 2 + o
        if not 0 <= c < k:
            raise ValueError("invalid origin")
        centers.append(c)
    return CorrelateNd.apply(compute_input(x), w, tuple(centers), mode,
                             float(cval))
