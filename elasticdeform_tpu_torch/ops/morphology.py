"""The ndimage order-statistic and morphology tier: minimum/maximum filters,
rank, median and percentile filters, grey and binary morphology.

Counterpart of the JAX package's ``ops/morphology.py`` (less
``watershed_ift``). Four kernels carry it (``csrc/morphology.cu``):

* :func:`min_max_filter1d` is the wrapper of K10: the min or max of ``size``
  samples along one axis, the filter mode folded in the kernel. The separable
  (box) footprints of :func:`apply_min_max_filter` run one K10 per axis, as
  the JAX package runs one ``lax.reduce_window``.
* :func:`min_max_filter` (K11): the min or max over an N-D footprint's taps,
  for a non-flat structure of ``x - s`` (erosion) or ``x + s`` (dilation) in
  the work type (float64 for integers and bool), whose result is truncated,
  saturated at the type's range and cast, as XLA casts it.
* :func:`rank_filter` (K12): the ``rank``-th smallest footprint tap; up to
  :data:`RANK_NETWORK_MAX_TAPS` taps through the JAX package's pruned Batcher
  network (NaN-propagating min/max, so a window holding a NaN gives NaN),
  above it a selection in the stable sort's order (NaN last, -0 equal to
  +0, equal values in tap order). The cap is kept for that NaN result,
  which differs between the two routes.
* :func:`binary_step` (K13, K11's kernel on bool): one AND (erosion) or OR
  (dilation) sweep over a structure's taps, ``border_value`` beyond the
  edge, mask-gated; :func:`binary_erosion_dilation` iterates it a fixed
  number of times or to the fixpoint.

Min and max order -0 below +0, as ``jnp.minimum`` and ``jnp.maximum`` do.

On a CPU tensor each wrapper takes its plain version (``*_plain``: the JAX
package's algorithm over slices of the padded array); on a CUDA tensor it
launches its kernel or raises, and adds one to its ``.launches`` counter.
Every result is a selection, or one subtraction per tap, so the kernels agree
with their plain versions, and the plain versions with the JAX package, bit
for bit. PyTorch lacks most operations on uint16, uint32 and uint64; the
plain versions work on uint16 and uint32 widened to the next signed type and
on uint64 with its top bit flipped into int64, which keep the order, and map
back. There is no gradient: the JAX package has no backward of its own here.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from elasticdeform_tpu_torch.ops import _build
from elasticdeform_tpu_torch.ops.filters import (
    _MODE_CODES, _expand_to_ndim, _normalize_axes, _on, _stream, check_mode,
    normalize_sequence, pad_axis,
)
from elasticdeform_tpu_torch.ops.prefilter import _lines
from elasticdeform_tpu_torch.ops.resample import numpy_dtype

# footprints up to this many taps select through the comparator network,
# larger ones in the sort's order: the two differ on windows holding a NaN
RANK_NETWORK_MAX_TAPS = 64
# K11, K12 and K13's fixed limit on the input's axes (ED_MORPH_MAXR)
MAX_ND_AXES = 8
# sweeps between two reads of the fixpoint's "changed" flag
SWEEPS_PER_CHECK = 8

_DTYPE_CODES = {torch.bool: 0, torch.uint8: 1, torch.int8: 2,
                torch.uint16: 3, torch.int16: 4, torch.uint32: 5,
                torch.int32: 6, torch.uint64: 7, torch.int64: 8,
                torch.float32: 9, torch.float64: 10}


# ---------------------------------------------------------------------------
# host-side numpy


def footprint_centers(fshape, origins):
    """The centre tap of each axis (``k // 2 + origin``), checked as SciPy
    checks it."""
    centers = []
    for k, o in zip(fshape, origins):
        c = k // 2 + int(o)
        if not 0 <= c < k:
            raise ValueError("invalid origin")
        centers.append(c)
    return centers


def _resolve_footprint(ndim, axes, size, footprint, structure):
    """SciPy's ``_min_or_max_filter`` front half: a separable box, or an
    explicit footprint with an optional non-flat structure."""
    separable = False
    sizes = None
    if structure is None:
        if footprint is None:
            if size is None:
                raise RuntimeError("no footprint provided")
            sizes = normalize_sequence(size, len(axes), "size")
            separable = True
        else:
            footprint = np.asarray(footprint, dtype=bool)
            if not footprint.any():
                raise ValueError("All-zero footprint is not supported.")
            if footprint.all():
                sizes = list(footprint.shape)
                footprint = None
                separable = True
    else:
        structure = np.asarray(structure, dtype=np.float64)
        if footprint is None:
            footprint = np.ones(structure.shape, bool)
        else:
            footprint = np.asarray(footprint, dtype=bool)
    return separable, sizes, footprint, structure


def generate_binary_structure(rank, connectivity):
    """SciPy's ``generate_binary_structure``: the taps of a 3^rank cube
    within L1 distance ``connectivity`` of its centre."""
    if connectivity < 1:
        connectivity = 1
    if rank < 1:
        return np.asarray(True)
    output = np.fabs(np.indices([3] * rank) - 1)
    output = np.add.reduce(output, 0)
    return output <= connectivity


def iterate_structure(structure, iterations, origin=None):
    """SciPy's ``iterate_structure``: the structure dilated with itself
    ``iterations - 1`` times (numpy)."""
    structure = np.asarray(structure, dtype=bool)
    if iterations < 2:
        out = structure.copy()
    else:
        ni = int(iterations) - 1
        shape = [ii + ni * (ii - 1) for ii in structure.shape]
        pos = [ni * (structure.shape[ii] // 2) for ii in range(len(shape))]
        slc = tuple(slice(pos[ii], pos[ii] + structure.shape[ii])
                    for ii in range(len(shape)))
        out = np.zeros(shape, bool)
        out[slc] = structure != 0
        out = _host_binary_dilation(out, structure, ni)
    if origin is None:
        return out
    origin = normalize_sequence(origin, structure.ndim, "origin")
    return out, [int(iterations) * o for o in origin]


def _host_binary_dilation(x, structure, iterations):
    """The numpy dilation :func:`iterate_structure` needs."""
    structure = np.asarray(structure, bool)
    offs = [tuple(int(t) - s // 2 for t, s in zip(off, structure.shape))
            for off in zip(*np.nonzero(structure[tuple(
                slice(None, None, -1) for _ in structure.shape)]))]
    for _ in range(int(iterations)):
        out = np.zeros_like(x)
        for off in offs:
            src = [slice(max(0, -o), x.shape[d] - max(0, o))
                   for d, o in enumerate(off)]
            dst = [slice(max(0, o), x.shape[d] - max(0, -o))
                   for d, o in enumerate(off)]
            out[tuple(dst)] |= x[tuple(src)]
        x = out
    return x


def _binary_stencil(structure, origin, dilation):
    """The structure one binary step applies (reflected for a dilation, as
    SciPy does) and its centre per axis (the origin mirrored, shifted by one
    on even axes, for a dilation)."""
    structure = np.asarray(structure, dtype=bool)
    origins = normalize_sequence(origin, structure.ndim, "origin")
    if dilation:
        structure = structure[tuple(slice(None, None, -1)
                                    for _ in structure.shape)]
        origins = [-o for o in origins]
        for ii, s in enumerate(structure.shape):
            if not s & 1:
                origins[ii] -= 1
    return structure, footprint_centers(structure.shape, origins)


@functools.lru_cache(maxsize=None)
def _batcher_pairs(n):
    """Batcher's odd-even mergesort comparators for a power-of-two ``n``
    ((i, j): wire i takes the min, wire j the max)."""
    pairs = []

    def merge(lo, m, r):
        step = r * 2
        if step < m:
            merge(lo, m, step)
            merge(lo + r, m, step)
            for i in range(lo + r, lo + m - r, step):
                pairs.append((i, i + r))
        else:
            pairs.append((lo, lo + r))

    def sort(lo, hi):
        if hi - lo >= 1:
            mid = lo + (hi - lo) // 2
            sort(lo, mid)
            sort(mid + 1, hi)
            merge(lo, hi - lo + 1, 1)

    sort(0, n - 1)
    return tuple(pairs)


@functools.lru_cache(maxsize=None)
def _rank_network(k, rank):
    """``(wires, comparators)``: Batcher's network for ``k`` taps padded to
    a power of two, pruned backwards to the comparators that can reach
    sorted position ``rank``."""
    n = 1 << max(0, (int(k) - 1).bit_length())
    pairs = _batcher_pairs(n) if n > 1 else ()
    live = {int(rank)}
    kept = []
    for i, j in reversed(pairs):
        if i in live or j in live:
            kept.append((i, j))
            live.add(i)
            live.add(j)
    return n, tuple(reversed(kept))


def _pad_max_value(dtype: torch.dtype):
    """The pad wires' value: the type's largest (``inf`` for floats)."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("inf")
    return int(torch.iinfo(dtype).max)


def raw_cval(cval, dtype: torch.dtype):
    """``cval`` as a pad of ``dtype`` holds it: numpy's conversion, which
    the JAX package's ``jnp.asarray(cval, dtype)`` makes. Integers truncate
    toward zero and raise OverflowError out of the type's range (NaN raises
    ValueError); bool is ``cval != 0``."""
    if dtype == torch.bool:
        return bool(cval)
    if dtype.is_floating_point:
        return float(cval)
    v = int(cval)
    info = torch.iinfo(dtype)
    if not info.min <= v <= info.max:
        raise OverflowError(f"Python integer {v} out of bounds for "
                            f"{numpy_dtype(dtype).name}")
    return v


def _pad_value(cval, dtype: torch.dtype, mode: str, pads):
    """``cval`` converted where the JAX package converts it (a constant
    mode pad of nonzero width), else 0, which no tap reads."""
    if mode == "constant" and any(lo or hi for lo, hi in pads):
        return raw_cval(cval, dtype)
    return False if dtype == torch.bool else 0


def _bits(value, dtype: torch.dtype) -> int:
    """``value`` in ``dtype``'s bytes, as the low bytes of an int64."""
    raw = np.asarray(value, dtype=numpy_dtype(dtype)).tobytes()
    return int.from_bytes(raw.ljust(8, b"\0"), "little", signed=True)


# ---------------------------------------------------------------------------
# plain versions (torch, any device)

_WIDEN = {torch.uint16: torch.int32, torch.uint32: torch.int64}
_I64_MIN = -(1 << 63)


def _plain(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a type every PyTorch operation takes, the order kept."""
    if x.dtype in _WIDEN:
        return x.to(_WIDEN[x.dtype])
    if x.dtype == torch.uint64:
        return x.view(torch.int64) ^ _I64_MIN
    return x


def _unplain(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`_plain`; always a new contiguous tensor."""
    if dtype in _WIDEN:
        return y.to(dtype, memory_format=torch.contiguous_format)
    if dtype == torch.uint64:
        return (y ^ _I64_MIN).contiguous().view(torch.uint64)
    return y.clone(memory_format=torch.contiguous_format)


def _plain_scalar(value, dtype: torch.dtype):
    return int(value) + _I64_MIN if dtype == torch.uint64 else value


def _tap_views(x: torch.Tensor, footprint, centers, mode: str, value):
    """The footprint's taps (raster order) as shifted views of ``x``
    padded by ``centers`` (``value`` in ``x``'s type in constant mode)."""
    xp = x
    for ax, (c, k) in enumerate(zip(centers, footprint.shape)):
        xp = pad_axis(xp, ax, c, k - 1 - c, mode, value)
    return [xp[tuple(slice(int(t), int(t) + n) for t, n in zip(tap, x.shape))]
            for tap in zip(*np.nonzero(footprint))]


def _signed_zero(out: torch.Tensor, taps, rank: int) -> torch.Tensor:
    """``out``, the ``rank``-th smallest of ``taps`` (or NaN), with a zero's
    sign as ``jnp.minimum`` and ``jnp.maximum`` order it, -0 below +0: -0
    where more than ``rank`` taps carry a sign bit. Of two equal zeros,
    ``torch.minimum`` and ``torch.maximum`` may return either."""
    if not out.dtype.is_floating_point:
        return out
    count = torch.zeros(out.shape, dtype=torch.int32, device=out.device)
    for t in taps:
        count += torch.signbit(t)
    zero = torch.zeros_like(out)
    return torch.where(out == 0, torch.where(count > rank, -zero, zero), out)


def min_max_filter1d_plain(x: torch.Tensor, size: int, axis: int, mode: str,
                           cval, center: int, minimum: bool) -> torch.Tensor:
    """Plain version of K10: the min or max of ``size`` slices of the line
    padded by ``(center, size - 1 - center)``."""
    dtype, n = x.dtype, int(x.shape[axis])
    xp = pad_axis(_plain(x), axis, center, size - 1 - center, mode,
                  _plain_scalar(cval, dtype))
    reduce = torch.minimum if minimum else torch.maximum
    taps = [xp.narrow(axis, k, n) for k in range(size)]
    acc = taps[0]
    for v in taps[1:]:
        acc = reduce(acc, v)
    return _unplain(_signed_zero(acc, taps, 0 if minimum else size - 1),
                    dtype)


def _saturate(acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K11's cast of a float64 result to an integer type as XLA converts:
    NaN to 0, truncated, saturated at the type's range (torch's own cast
    wraps). uint64 comes back in :func:`_plain`'s int64 form."""
    t = torch.trunc(acc)
    t = torch.where(torch.isnan(t), torch.zeros_like(t), t)
    if dtype == torch.uint64:
        low = t.clamp(0.0, 2.0 ** 63 - 1024).to(torch.int64) + _I64_MIN
        high = (t.clamp(2.0 ** 63, 2.0 ** 64 - 2048) - 2.0 ** 63).to(
            torch.int64)
        m = torch.where(t >= 2.0 ** 63, high, low)
        return torch.where(t >= 2.0 ** 64, torch.full_like(m, -_I64_MIN - 1),
                           m)
    if dtype == torch.int64:
        m = t.clamp(float(_I64_MIN), 2.0 ** 63 - 1024).to(torch.int64)
        return torch.where(t >= 2.0 ** 63, torch.full_like(m, -_I64_MIN - 1),
                           m)
    info = torch.iinfo(dtype)
    return _plain(t.clamp(float(info.min), float(info.max)).to(
        torch.int64).to(dtype))


def min_max_filter_plain(x: torch.Tensor, footprint, structure, centers,
                         mode: str, cval, minimum: bool) -> torch.Tensor:
    """Plain version of K11: the min or max of the footprint's tap views
    (``x`` padded by ``centers``), for a non-flat ``structure`` (float64
    numpy, or None) of ``v - s`` / ``v + s`` in the work type, then the
    saturating cast."""
    dtype = x.dtype
    flat = structure is None
    if flat:
        work, value = _plain(x), _plain_scalar(cval, dtype)
    else:
        work = x if dtype.is_floating_point else x.to(torch.float64)
        value = cval
    taps = list(zip(*np.nonzero(footprint)))
    views = _tap_views(work, footprint, centers, mode, value)

    def tap_values():
        for tap, v in zip(taps, views):
            if not flat:
                s = torch.tensor(float(structure[tap]), dtype=work.dtype,
                                 device=x.device)
                v = v - s if minimum else v + s
            yield v

    reduce = torch.minimum if minimum else torch.maximum
    acc = None
    for v in tap_values():
        acc = v if acc is None else reduce(acc, v)
    if flat or dtype.is_floating_point:
        return _unplain(_signed_zero(acc, tap_values(),
                                     0 if minimum else len(taps) - 1), dtype)
    if dtype == torch.bool:
        return (acc != 0).contiguous()
    return _unplain(_saturate(acc, dtype), dtype)


def rank_filter_plain(x: torch.Tensor, footprint, centers, mode: str, cval,
                      rank: int) -> torch.Tensor:
    """Plain version of K12: the JAX package's pruned network over the tap
    views (pad wires at the type's largest value) up to
    :data:`RANK_NETWORK_MAX_TAPS` taps, else the tap at ``rank`` of a stable
    ``torch.sort`` of the tap stack with -0 as +0 (NaN last, as
    ``jnp.sort``)."""
    dtype = x.dtype
    views = _tap_views(_plain(x), footprint, centers, mode,
                       _plain_scalar(cval, dtype))
    k = len(views)
    if k > RANK_NETWORK_MAX_TAPS:
        stack = torch.stack(views, -1)
        keys = stack
        if stack.dtype.is_floating_point:
            keys = torch.where(stack == 0, torch.zeros_like(stack), stack)
        order = torch.sort(keys, stable=True, dim=-1).indices
        pick = order[..., rank:rank + 1]
        return _unplain(stack.gather(-1, pick)[..., 0], dtype)
    n, pairs = _rank_network(k, rank)
    wires = list(views)
    if n > k:
        pad = torch.full(x.shape, _plain_scalar(_pad_max_value(dtype), dtype),
                         dtype=views[0].dtype, device=x.device)
        wires += [pad] * (n - k)
    for i, j in pairs:
        a, b = wires[i], wires[j]
        wires[i] = torch.minimum(a, b)
        wires[j] = torch.maximum(a, b)
    return _unplain(_signed_zero(wires[rank], views, rank), dtype)


def binary_step_plain(x: torch.Tensor, structure, centers, border: bool,
                      dilation: bool, mask=None, changed=None
                      ) -> torch.Tensor:
    """Plain version of K13: the OR (dilation) or AND (erosion) of the
    structure's tap views of ``x`` padded with ``border``; no tap gives all
    False (dilation) or all True (erosion). A voxel where ``mask`` is False
    keeps its value; ``changed`` (int32, one element) is set to 1 where a
    voxel changed."""
    views = _tap_views(x, structure, centers, "constant", bool(border))
    if not views:
        out = torch.full(x.shape, not dilation, dtype=torch.bool,
                         device=x.device)
    else:
        out = views[0]
        for v in views[1:]:
            out = out | v if dilation else out & v
        out = out.contiguous()
    if mask is not None:
        out = torch.where(mask, out, x)
    if changed is not None:
        changed |= (out != x).any().to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers (K10, K11, K12, K13)


def _lib():
    lib = _build.library("morphology")
    if lib.ed_min_max_filter1d.argtypes is None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lp, ip = ctypes.POINTER(ll), ctypes.POINTER(i)
        fn = lib.ed_min_max_filter1d
        fn.restype = i
        fn.argtypes = [i, i, vp, vp, ll, ll, ll, i, i, i, ll, vp]
        fn = lib.ed_min_max_filter
        fn.restype = i
        fn.argtypes = [i, i, i, vp, vp, vp, vp, vp, i, lp, ip, ip, i, i, ll,
                       vp]
        fn = lib.ed_rank_filter
        fn.restype = i
        fn.argtypes = [i, vp, vp, vp, vp, vp, i, i, i, i, lp, ip, ip, i, i,
                       ll, ll, vp]
        fn = lib.ed_binary_step
        fn.restype = i
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i, lp, ip, ip, i, i, i, vp]
    return lib


def _check(x: torch.Tensor, what: str) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of a type the kernels
    take."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: the kernel takes bool, integer, float32 or "
                        f"float64 tensors, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the kernel takes a contiguous tensor")


class _Geometry:
    """The host arrays of an N-D footprint on ``x``: per tap its offsets
    from the centre (``off``, int32) and linear offset (``delta``), the
    least and greatest offset per axis."""

    def __init__(self, x: torch.Tensor, footprint, centers, what: str):
        ndim = x.dim()
        if not 1 <= ndim <= MAX_ND_AXES:
            raise ValueError(f"{what}: the CUDA kernel takes 1 to "
                             f"{MAX_ND_AXES} axes, got {ndim}")
        taps = np.argwhere(np.asarray(footprint, dtype=bool))
        off = (taps - np.asarray(centers, dtype=np.int64)).astype(np.int32)
        off = off.reshape(len(taps), ndim)
        strides = np.cumprod([1] + list(x.shape[::-1]))[:-1][::-1]
        self.taps = len(taps)
        self.off = _on(off, x, torch.int32)
        self.delta = _on(off.astype(np.int64) @ np.asarray(strides, np.int64),
                         x, torch.int64)
        zeros = np.zeros(ndim, dtype=np.int32)
        lo = off.min(axis=0) if self.taps else zeros
        hi = off.max(axis=0) if self.taps else zeros
        i = ctypes.c_int
        self.args = (ndim, (ctypes.c_longlong * ndim)(*x.shape),
                     (i * ndim)(*lo.tolist()), (i * ndim)(*hi.tolist()),
                     self.taps)


def min_max_filter1d(x: torch.Tensor, size: int, axis: int, mode: str, cval,
                     center: int, minimum: bool) -> torch.Tensor:
    """The min (``minimum``) or max of ``size`` samples of ``x`` along
    ``axis``, sample ``center`` on the output, filter mode ``mode``, ``cval``
    (in ``x``'s type, see :func:`raw_cval`) beyond the edge in constant mode.
    A CPU tensor takes :func:`min_max_filter1d_plain`; a CUDA tensor
    launches K10 and adds one to ``min_max_filter1d.launches``."""
    axis = axis % x.dim()
    if x.device.type == "cpu":
        return min_max_filter1d_plain(x, size, axis, mode, cval, center,
                                      minimum)
    _check(x, "min_max_filter1d")
    out = torch.empty_like(x)
    outer, n, inner = _lines(x, axis)
    lib = _lib()
    err = lib.ed_min_max_filter1d(
        _DTYPE_CODES[x.dtype], int(minimum), x.data_ptr(), out.data_ptr(),
        outer, n, inner, int(size), int(center), _MODE_CODES[mode],
        _bits(cval, x.dtype), _stream(x))
    _build.check(err, lib, "ed_morphology_error_string", "min_max_filter1d")
    min_max_filter1d.launches += 1
    return out


min_max_filter1d.launches = 0


def min_max_filter(x: torch.Tensor, footprint, structure, centers, mode: str,
                   cval, minimum: bool) -> torch.Tensor:
    """The min or max over the taps of ``footprint`` (bool numpy, ``x``'s
    rank, tap ``centers[d]`` on the output), with a non-flat ``structure``
    (float64 numpy of the footprint's shape, or None for flat) applied in
    the work type: ``x``'s for floats, float64 otherwise, which ``cval`` is
    in. A CPU tensor takes :func:`min_max_filter_plain`; a CUDA tensor
    launches K11 and adds one to ``min_max_filter.launches``."""
    if x.device.type == "cpu":
        return min_max_filter_plain(x, footprint, structure, centers, mode,
                                    cval, minimum)
    _check(x, "min_max_filter")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    geo = _Geometry(x, footprint, centers, "min_max_filter")
    nonflat = structure is not None
    work = x.dtype if not nonflat or x.dtype.is_floating_point else \
        torch.float64
    sval = None
    if nonflat:
        s = np.asarray(structure, dtype=np.float64)[np.asarray(footprint,
                                                               dtype=bool)]
        sval = _on(s, x, work)
    lib = _lib()
    err = lib.ed_min_max_filter(
        _DTYPE_CODES[x.dtype], int(minimum), int(nonflat), x.data_ptr(),
        out.data_ptr(), geo.off.data_ptr(), geo.delta.data_ptr(),
        None if sval is None else sval.data_ptr(), *geo.args,
        _MODE_CODES[mode], _bits(cval, work), _stream(x))
    _build.check(err, lib, "ed_morphology_error_string", "min_max_filter")
    min_max_filter.launches += 1
    return out


min_max_filter.launches = 0


def rank_filter(x: torch.Tensor, footprint, centers, mode: str, cval,
                rank: int) -> torch.Tensor:
    """The ``rank``-th smallest of the taps of ``footprint`` (as
    :func:`min_max_filter`; ``cval`` in ``x``'s type). A CPU tensor takes
    :func:`rank_filter_plain`; a CUDA tensor launches K12 (the network
    route up to :data:`RANK_NETWORK_MAX_TAPS` taps, the select route above)
    and adds one to ``rank_filter.launches``."""
    if x.device.type == "cpu":
        return rank_filter_plain(x, footprint, centers, mode, cval, rank)
    _check(x, "rank_filter")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    geo = _Geometry(x, footprint, centers, "rank_filter")
    pairs, npairs, wires = None, 0, 0
    if geo.taps <= RANK_NETWORK_MAX_TAPS:
        wires, comparators = _rank_network(geo.taps, rank)
        npairs = len(comparators)
        pairs = _on(np.asarray(comparators, dtype=np.uint8).reshape(-1, 2),
                    x, torch.uint8)
    lib = _lib()
    err = lib.ed_rank_filter(
        _DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(),
        geo.off.data_ptr(), geo.delta.data_ptr(),
        None if npairs == 0 else pairs.data_ptr(), npairs,
        wires, int(rank), *geo.args, _MODE_CODES[mode], _bits(cval, x.dtype),
        _bits(_pad_max_value(x.dtype), x.dtype), _stream(x))
    _build.check(err, lib, "ed_morphology_error_string", "rank_filter")
    rank_filter.launches += 1
    return out


rank_filter.launches = 0


def binary_step(x: torch.Tensor, structure, centers, border: bool,
                dilation: bool, mask=None, changed=None, geometry=None
                ) -> torch.Tensor:
    """One binary erosion or dilation sweep of the bool tensor ``x`` over
    the taps of ``structure`` (bool numpy, ``x``'s rank, centre
    ``centers``), ``border`` beyond the edge; ``mask`` (bool, ``x``'s shape)
    gates which voxels may change; ``changed`` (int32, one element) is set
    to 1 where one did. ``geometry``: the structure's tap tables on ``x``,
    built once for many sweeps, or None to build them. A CPU tensor takes
    :func:`binary_step_plain`; a CUDA tensor launches K13 and adds one to
    ``binary_step.launches``."""
    if x.device.type == "cpu":
        return binary_step_plain(x, structure, centers, border, dilation,
                                 mask, changed)
    _check(x, "binary_step")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    geo = geometry or _Geometry(x, structure, centers, "binary_step")
    lib = _lib()
    err = lib.ed_binary_step(
        x.data_ptr(), out.data_ptr(),
        None if mask is None else mask.data_ptr(), geo.off.data_ptr(),
        geo.delta.data_ptr(), None if changed is None else changed.data_ptr(),
        *geo.args, int(bool(border)), int(bool(dilation)), _stream(x))
    _build.check(err, lib, "ed_morphology_error_string", "binary_step")
    binary_step.launches += 1
    return out


binary_step.launches = 0


# ---------------------------------------------------------------------------
# the JAX package's functions on tensors


def _full_origins(origin, axes, ndim):
    full = [0] * ndim
    for ax, o in zip(axes, normalize_sequence(origin, len(axes), "origin")):
        full[ax] = int(o)
    return full


def _pads(footprint_shape, centers):
    return [(c, k - 1 - c) for c, k in zip(centers, footprint_shape)]


def apply_min_max_filter1d(x: torch.Tensor, size, axis: int, mode, cval,
                           origin, minimum: bool) -> torch.Tensor:
    """SciPy ``minimum_filter1d`` / ``maximum_filter1d`` (K10)."""
    size = int(size)
    if size < 1:
        raise RuntimeError("incorrect filter size")
    axis = axis % x.dim()
    mode = check_mode(mode)
    c = size // 2 + int(origin)
    if not 0 <= c < size:
        raise ValueError("invalid origin")
    cv = _pad_value(cval, x.dtype, mode, [(c, size - 1 - c)])
    return min_max_filter1d(x.contiguous(), size, axis, mode, cv, c, minimum)


def apply_min_max_filter(x: torch.Tensor, size, footprint, structure, mode,
                         cval, origin, minimum: bool, axes=None
                         ) -> torch.Tensor:
    """N-D minimum / maximum filter, grey erosion / dilation with a
    non-flat ``structure``: SciPy's separable passes (K10) for a box,
    else the footprint's taps (K11)."""
    axes = _normalize_axes(axes, x.dim())
    separable, sizes, footprint, structure = _resolve_footprint(
        x.dim(), axes, size, footprint, structure)
    origins = normalize_sequence(origin, len(axes), "origin")
    modes = normalize_sequence(mode, len(axes), "mode")
    if separable:
        for ax, s, o, md in zip(axes, sizes, origins, modes):
            if int(s) > 1:
                x = apply_min_max_filter1d(x, int(s), ax, md, cval, o,
                                           minimum)
        return x
    if len({check_mode(m) for m in modes}) != 1:
        raise RuntimeError("A sequence of modes is not supported for "
                           "non-separable footprints")
    md = check_mode(modes[0])
    footprint = _expand_to_ndim(footprint, x.dim(), axes)
    if structure is not None:
        structure = _expand_to_ndim(structure, x.dim(), axes)
    centers = footprint_centers(footprint.shape,
                                _full_origins(origins, axes, x.dim()))
    flat = structure is None or not np.any(structure)
    work = x.dtype if flat or x.dtype.is_floating_point else torch.float64
    cv = _pad_value(cval, work, md, _pads(footprint.shape, centers))
    return min_max_filter(x.contiguous(), footprint,
                          None if flat else structure, centers, md, cv,
                          minimum)


def _footprint_for(x: torch.Tensor, size, footprint, origin, axes):
    """The footprint (bool numpy, ``x``'s rank) and full origins of the
    rank and generic filters (SciPy's ``axes=`` contract)."""
    axes = _normalize_axes(axes, x.dim())
    if footprint is None:
        if size is None:
            raise RuntimeError("no footprint or filter size provided")
        footprint = np.ones(normalize_sequence(size, len(axes), "size"),
                            dtype=bool)
    else:
        footprint = np.asarray(footprint, dtype=bool)
    footprint = _expand_to_ndim(footprint, x.dim(), axes)
    return footprint, _full_origins(origin, axes, x.dim())


def footprint_tap_stack(x: torch.Tensor, footprint, origins, mode, cval
                        ) -> torch.Tensor:
    """The footprint's taps of every voxel along a new trailing axis
    (raster order, SciPy's window order): pad once, one slice per tap."""
    footprint = np.asarray(footprint, dtype=bool)
    md = check_mode(mode)
    centers = footprint_centers(footprint.shape, origins)
    cv = _pad_value(cval, x.dtype, md, _pads(footprint.shape, centers))
    views = _tap_views(_plain(x), footprint, centers, md,
                       _plain_scalar(cv, x.dtype))
    return _unplain(torch.stack(views, -1), x.dtype)


def apply_rank_filter(x: torch.Tensor, rank, size, footprint, mode, cval,
                      origin, operation: str = "rank", axes=None
                      ) -> torch.Tensor:
    """SciPy ``rank_filter`` / ``median_filter`` / ``percentile_filter``
    (K12), with the rank rules and the min / max short-circuits."""
    footprint, full_origins = _footprint_for(x, size, footprint, origin, axes)
    filter_size = int(footprint.sum())
    if operation == "median":
        rank = filter_size // 2
    elif operation == "percentile":
        percentile = float(rank)
        if percentile < 0.0:
            percentile += 100.0
        if percentile < 0 or percentile > 100:
            raise RuntimeError("invalid percentile")
        if percentile == 100.0:
            rank = filter_size - 1
        else:
            rank = int(float(filter_size) * percentile / 100.0)
    rank = int(rank)
    if rank < 0:
        rank += filter_size
    if rank < 0 or rank >= filter_size:
        raise RuntimeError("rank not within filter footprint size")
    if rank == 0:
        return apply_min_max_filter(x, None, footprint, None, mode, cval,
                                    full_origins, True)
    if rank == filter_size - 1:
        return apply_min_max_filter(x, None, footprint, None, mode, cval,
                                    full_origins, False)
    if not isinstance(mode, str):
        raise RuntimeError("A sequence of modes is not supported by "
                           "non-separable rank filters")
    md = check_mode(mode)
    centers = footprint_centers(footprint.shape, full_origins)
    cv = _pad_value(cval, x.dtype, md, _pads(footprint.shape, centers))
    return rank_filter(x.contiguous(), footprint, centers, md, cv, rank)


def binary_erosion_dilation(x: torch.Tensor, structure, iterations, mask,
                            border_value, origin, dilation: bool
                            ) -> torch.Tensor:
    """``binary_erosion`` / ``binary_dilation``: K13 sweeps, ``iterations``
    of them, or to the fixpoint for ``iterations <= 0`` (the flag read every
    :data:`SWEEPS_PER_CHECK` sweeps), each gated by ``mask``."""
    x = (x != 0).contiguous()
    if structure is None:
        structure = generate_binary_structure(x.dim(), 1)
    structure = np.asarray(structure, dtype=bool)
    if structure.ndim != x.dim():
        raise RuntimeError("structure rank must equal input rank")
    structure, centers = _binary_stencil(structure, origin, dilation)
    border = bool(border_value)
    if mask is not None:
        mask = torch.broadcast_to(mask != 0, x.shape).contiguous()
    geo = None
    if x.device.type != "cpu" and x.numel():
        geo = _Geometry(x, structure, centers, "binary_step")

    def step(v, changed=None):
        return binary_step(v, structure, centers, border, dilation, mask,
                           changed, geo)

    iterations = int(iterations)
    if iterations >= 1:
        for _ in range(iterations):
            x = step(x)
        return x
    changed = torch.zeros(1, dtype=torch.int32, device=x.device)
    while True:
        for _ in range(SWEEPS_PER_CHECK - 1):
            x = step(x)
        changed.zero_()
        x = step(x, changed)
        if not int(changed.item()):
            return x
