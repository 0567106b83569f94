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
  same taps over slices of :func:`pad_axis`.
* :func:`correlate1d_transpose` is the wrapper of kernel K8T, the
  transpose: the correlation with the flipped taps into the padded extent,
  then each pad folded back onto the line (constant-mode pads dropped).
  Plain version :func:`correlate1d_transpose_plain`.
* :func:`correlate_nd` (K9) and :func:`correlate_nd_transpose` (K9T): the
  same for an N-D kernel, over its nonzero taps in raster order, with the
  fold on every axis. Axes where the kernel has extent 1 are batch axes;
  runs of them are merged before the launch, and the kernels take at most
  :data:`MAX_ND_AXES` axes after that.

On a CPU tensor each wrapper takes its plain version; on a CUDA tensor it
launches its kernel (contiguous float32 or float64) or raises, and adds one
to its ``.launches`` counter. :class:`Correlate1d` and :class:`CorrelateNd`
are the autograd functions (gradient to ``x`` only: the taps and ``cval``
are host constants, as in the JAX package). The ``apply_*`` functions are
the JAX package's, on tensors; the numpy helpers (kernels, folds, dense
filter matrices for the tests) are this package's own copies.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from elasticdeform_tpu_torch.ops import _build
from elasticdeform_tpu_torch.ops.prefilter import _lines
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
        fn = lib.ed_correlate1d_transpose
        fn.restype = i
        fn.argtypes = [i, vp, vp, vp, vp, vp, ll, ll, ll, i, i, vp]
        fn = lib.ed_correlate_nd
        fn.restype = i
        fn.argtypes = [i, i, vp, vp, vp, vp, vp, vp, vp, i,
                       ctypes.POINTER(ll), ctypes.POINTER(i),
                       ctypes.POINTER(i), ctypes.POINTER(i), i, i,
                       ctypes.c_double, vp]
    return lib


_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def _on(a: np.ndarray, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A host array as a tensor on ``like``'s device (``dtype``, default
    ``like``'s)."""
    return torch.as_tensor(np.ascontiguousarray(a)).to(
        device=like.device, dtype=like.dtype if dtype is None else dtype)


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def correlate1d(x: torch.Tensor, weights, axis: int, mode: str, cval,
                center: int, pair: int = 0) -> torch.Tensor:
    """Correlation of ``x`` along ``axis`` with the taps ``weights``
    (float64 numpy), tap ``center`` on the output, filter mode ``mode``
    (``cval`` beyond the edge in constant mode), in the direct or, with
    ``pair``, SciPy's paired order. A CPU tensor takes
    :func:`correlate1d_plain`; a CUDA tensor launches K8 (contiguous
    float32 or float64) and adds one to ``correlate1d.launches``."""
    axis = axis % x.dim()
    if x.device.type == "cpu":
        return correlate1d_plain(x, weights, axis, mode, cval, center, pair)
    check_kernel_tensor(x, "correlate1d")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    outer, n, inner = _lines(x, axis)
    w = _on(weights, x)
    lib = _lib()
    err = lib.ed_correlate1d(
        _DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), w.data_ptr(),
        outer, n, inner, len(weights), int(center), _MODE_CODES[mode],
        int(pair), float(cval), _stream(x))
    _build.check(err, lib, "ed_filters_error_string", "correlate1d")
    correlate1d.launches += 1
    return out


correlate1d.launches = 0


def correlate1d_transpose(g: torch.Tensor, weights, axis: int, mode: str,
                          center: int) -> torch.Tensor:
    """The exact transpose of :func:`correlate1d` (either order) along
    ``axis``. A CPU tensor takes :func:`correlate1d_transpose_plain`; a
    CUDA tensor launches K8T and adds one to
    ``correlate1d_transpose.launches``."""
    axis = axis % g.dim()
    if g.device.type == "cpu":
        return correlate1d_transpose_plain(g, weights, axis, mode, center)
    check_kernel_tensor(g, "correlate1d_transpose")
    out = torch.empty_like(g)
    if g.numel() == 0:
        return out
    outer, n, inner = _lines(g, axis)
    L = len(weights)
    ptr, pos = fold_lists(n, int(center), L - 1 - int(center), mode)
    w = _on(weights, g)
    ptr_d, pos_d = _on(ptr, g, torch.int32), _on(pos, g, torch.int32)
    lib = _lib()
    err = lib.ed_correlate1d_transpose(
        _DTYPE_CODES[g.dtype], g.data_ptr(), out.data_ptr(), w.data_ptr(),
        ptr_d.data_ptr(), pos_d.data_ptr(), outer, n, inner, L, int(center),
        _stream(g))
    _build.check(err, lib, "ed_filters_error_string",
                 "correlate1d_transpose")
    correlate1d_transpose.launches += 1
    return out


correlate1d_transpose.launches = 0


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


def _launch_nd(x: torch.Tensor, weights, centers, mode: str, cval,
               wrapper) -> torch.Tensor:
    """K9 (``wrapper`` :func:`correlate_nd`) or K9T
    (:func:`correlate_nd_transpose`), whose counter it adds one to when it
    launches."""
    transpose = wrapper is correlate_nd_transpose
    what = wrapper.__name__
    check_kernel_tensor(x, what)
    w = np.asarray(weights, dtype=np.float64)
    merged, group, batch = nd_geometry(x.shape, w.shape)
    rank = len(merged)
    if rank > MAX_ND_AXES:
        raise ValueError(
            f"{what}: after merging the axes where the kernel has extent 1 "
            f"the correlation has {rank} axes; the CUDA kernel takes at most "
            f"{MAX_ND_AXES}")
    out = torch.empty_like(x)
    taps = _nd_taps(w)
    if x.numel() == 0 or not taps:
        return out.zero_()
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
    ptr_d = _on(np.concatenate(ptrs), x, torch.int32)
    pos_d = _on(np.concatenate(poss), x, torch.int32)
    w_d = _on(np.array([w[t] for t in taps]), x)
    off_d = _on(off, x, torch.int32)
    delta_d = _on(delta, x, torch.int64)
    i = ctypes.c_int
    lib = _lib()
    err = lib.ed_correlate_nd(
        _DTYPE_CODES[x.dtype], int(transpose), x.data_ptr(), out.data_ptr(),
        w_d.data_ptr(), off_d.data_ptr(), delta_d.data_ptr(),
        ptr_d.data_ptr(), pos_d.data_ptr(), rank,
        (ctypes.c_longlong * rank)(*merged), (i * rank)(*lo.tolist()),
        (i * rank)(*hi.tolist()), (i * rank)(*ptr_base), len(taps),
        _MODE_CODES[mode], float(cval), _stream(x))
    _build.check(err, lib, "ed_filters_error_string", what)
    wrapper.launches += 1
    return out


def correlate_nd(x: torch.Tensor, weights, centers, mode: str,
                 cval) -> torch.Tensor:
    """N-D correlation of ``x`` with ``weights`` (float64 numpy, ``x``'s
    rank), tap ``centers[d]`` on the output along axis d, filter mode
    ``mode`` on every axis. A CPU tensor takes :func:`correlate_nd_plain`;
    a CUDA tensor launches K9 and adds one to ``correlate_nd.launches``
    (an all-zero kernel or an empty tensor gives zeros with no launch)."""
    if x.device.type == "cpu":
        return correlate_nd_plain(x, weights, centers, mode, cval)
    return _launch_nd(x, weights, centers, mode, cval, correlate_nd)


correlate_nd.launches = 0


def correlate_nd_transpose(g: torch.Tensor, weights, centers,
                           mode: str) -> torch.Tensor:
    """The exact transpose of :func:`correlate_nd`. A CPU tensor takes
    :func:`correlate_nd_transpose_plain`; a CUDA tensor launches K9T and
    adds one to ``correlate_nd_transpose.launches``."""
    if g.device.type == "cpu":
        return correlate_nd_transpose_plain(g, weights, centers, mode)
    return _launch_nd(g, weights, centers, mode, 0.0, correlate_nd_transpose)


correlate_nd_transpose.launches = 0


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
