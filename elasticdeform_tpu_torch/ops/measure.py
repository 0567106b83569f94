"""Labeling and region measurements: the kernels and their plain twins.

Counterpart of the JAX package's ``measure.py`` below its public functions
(which are in :mod:`elasticdeform_tpu_torch.measure`). Three kernels carry
them (``csrc/measure.cu``):

* :func:`label_roots` (K18): connected components of a bool mask under a
  symmetric 3^ndim structure, each foreground voxel given its component's
  least raveled index and each background voxel ``n`` (the voxel count),
  the JAX package's ``label_roots``. On the card a union-find whose roots
  are always the smaller index, so the result is that of the JAX package's
  propagation loop bit for bit, with no fixpoint and no flag read. With
  ``flags`` it also marks each root (``roots[i] == i``), and
  :func:`label_numbers` turns the roots into ``label``'s 1..n numbering:
  a ``torch.cumsum`` of the flags and one gather kernel.
* :func:`segment_reduce` (K19): per-segment sums, sums of squares, exact
  counts, coordinate-weighted sums, minima and maxima, coordinate bounds
  and histograms, the JAX package's ``jax.ops.segment_*`` calls. A voxel's
  segment comes from its label through ``_norm_labels_index``'s table
  (:func:`labels_index`), inside the kernel. Two routes: ``"shared"``,
  every segment's accumulators in a block's shared memory, flushed once;
  ``"device"``, atomics straight into device memory.
* :func:`segment_position` (K20): ``_positions``' second pass, the least
  raveled index of each segment's voxels equal to its extremum.

Minima and maxima go through order keys (:func:`order_keys`): int64 values
whose order is the dtype's, -0.0 below +0.0, and NaN below everything for a
minimum and above everything for a maximum, so NaN wins as in the JAX
package. The counts are exact int64 (the JAX package counts in float32,
which is exact below 2^24 voxels a segment: note R1).

On a CPU tensor each wrapper takes its plain version (``*_plain``: the JAX
package's algorithm on tensors); on a CUDA tensor it launches its kernel or
raises, and adds the number of kernels it launched to its ``.launches``
counter: one, but K18's roots three (two where the structure has no
offsets); K19 also adds one to its route's count in ``.routes``. The kernels index with 32 bits: 1 to 8 axes and
fewer than 2^31 voxels (``relax_check``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from elasticdeform_tpu_torch.ops import _build
from elasticdeform_tpu_torch.ops.filters import _stream
from elasticdeform_tpu_torch.ops.morphology import (
    generate_binary_structure, relax_check,
)
from elasticdeform_tpu_torch.ops.prefilter import _sm_count

# the shared route's budget: a block's accumulators of every segment, at
# most this many bytes (dynamic shared memory, of the H100's 227 KB a block)
SEGMENT_SMEM = 160 << 10
# the shared route's most blocks an SM (of csrc/measure.cu's 512 threads)
_SEGMENT_SM_BLOCKS = 4
_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1
_INT32_MAX = (1 << 31) - 1

# the kernels' dtype codes (csrc/measure.cu's DType)
DTYPE_CODES = {torch.bool: 0, torch.uint8: 1, torch.int8: 2, torch.int16: 3,
               torch.uint16: 4, torch.int32: 5, torch.uint32: 6,
               torch.int64: 7, torch.uint64: 8, torch.float32: 9,
               torch.float64: 10}
_UNSIGNED = (torch.bool, torch.uint8, torch.uint16, torch.uint32,
             torch.uint64)

# the accumulators K19 fills, by name: the sum, the sum of squares, the
# count, the coordinate-weighted sums (one per axis), the minimum's and the
# maximum's order keys, the coordinate bounds (min and max per axis), the
# histogram
STATS = ("sum", "sum2", "count", "csum", "min", "max", "bounds", "hist")


def structure_offsets(structure, ndim):
    """The structure's neighbour offsets, the centre dropped, in the raster
    order of ``np.nonzero``; the default is the cross. Raises as the JAX
    package's ``_structure_offsets``."""
    if structure is None:
        structure = generate_binary_structure(ndim, 1)
    structure = np.asarray(structure, dtype=bool)
    if structure.ndim != ndim:
        raise RuntimeError("structure rank must equal input rank")
    if structure.shape != (3,) * ndim:
        raise ValueError("structure dimensions must be 3")
    offs = [tuple(int(t) - 1 for t in off)
            for off in zip(*np.nonzero(structure))]
    offs = [o for o in offs if o != (0,) * ndim]
    if any(tuple(-c for c in o) not in offs for o in offs):
        raise ValueError("structure must be symmetric")
    return offs


_SIGNATURES = (
    ("ed_label_roots", "vvvvipiv"),
    ("ed_label_number", "vvvlv"),
    ("ed_segment_reduce", "vivivlipivvvvvvvvvidddiiv"),
    ("ed_segment_position", "vivivlipivvv"))
_entries: dict = {}


def _lib():
    """``csrc/measure.cu``'s library, its C entry points bound once into
    ``_entries``."""
    if not _entries:
        lib = _build.library("measure")
        types = {"v": ctypes.c_void_p, "i": ctypes.c_int,
                 "l": ctypes.c_longlong, "d": ctypes.c_double,
                 "p": ctypes.POINTER(ctypes.c_longlong)}
        for name, sig in _SIGNATURES:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [types[c] for c in sig]
            _entries[name] = fn
        _entries["lib"] = lib
    return _entries["lib"]


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check_launch(err: int, what: str) -> None:
    if err:
        _build.check(err, _entries["lib"], "ed_measure_error_string", what)


def _shape_arg(shape):
    return (ctypes.c_longlong * len(shape))(*shape)


def _check(x: torch.Tensor, what: str) -> None:
    relax_check(x, what)
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: the kernel takes bool, integer, float32 "
                        f"and float64 tensors, got {x.dtype}")


# ---------------------------------------------------------------------------
# K18: connected components


def half_taps(offsets, shape) -> np.ndarray:
    """K18's neighbour table: the offsets of lower raveled index (the
    structure is symmetric, so they cover every pair once) as int32 rows of
    a linear offset and an edge word (bit ``k`` the tap steps down along
    axis ``k``, bit ``8 + k`` up; ``csrc/array_dims.cuh``'s ``edge_bits``)."""
    strides = np.cumprod([1] + list(shape[::-1]))[:-1][::-1]
    rows = []
    for o in offsets:
        lin = int(np.dot(o, strides))
        if lin < 0:
            rows.append([lin, sum((1 << k) * (t < 0) + (1 << (8 + k)) * (t > 0)
                                  for k, t in enumerate(o))])
    return np.asarray(rows, dtype=np.int32).reshape(-1, 2)


@functools.lru_cache(maxsize=64)
def _taps_on(offsets, shape, device) -> torch.Tensor:
    """:func:`half_taps` on ``device``, uploaded once per structure, shape
    and device."""
    return torch.as_tensor(half_taps(offsets, shape)).to(device)


def _scan_keys(fg: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``(L - s) * (n + 1)`` with ``s = cumsum(~fg)`` along ``axis``: every
    background voxel starts a segment whose keys lie below the earlier
    segments', so a ``cummin`` of ``base + value`` restarts at it."""
    s = torch.cumsum((~fg).to(torch.int64), axis)
    return (fg.shape[axis] - s) * (n + 1)


def _seg_min_scan(l, fg, axis, base, big, reverse):
    """The JAX package's ``_seg_min_scan``: the running minimum along the
    contiguous foreground runs of ``axis``, one way."""
    vals = torch.where(fg, l, big)
    if reverse:
        vals = vals.flip(axis)
    v = torch.cummin(base + vals, axis).values % (big + 1)
    if reverse:
        v = v.flip(axis)
    return torch.where(fg, torch.minimum(l, v), big)


def label_roots_plain(fg: torch.Tensor, offsets, flags: bool = False):
    """The JAX package's ``label_roots`` loop on the bool ``fg``: segmented
    min-scans both ways along each axis the structure connects, the
    neighbour minimum over its diagonal offsets, one pointer jump, until
    nothing changes. Returns the int32 roots, and with ``flags`` also the
    int32 root flags (1 where ``roots[i] == i``)."""
    shape = tuple(fg.shape)
    ndim = fg.dim()
    n = fg.numel()
    axis_offs = [o for o in offsets if len([c for c in o if c]) == 1]
    diag_offs = [o for o in offsets if len([c for c in o if c]) > 1]
    scan_axes = [ax for ax in range(ndim) if any(o[ax] for o in axis_offs)]
    big = n
    iota = torch.arange(n, dtype=torch.int64, device=fg.device).view(shape)
    fwd = {ax: _scan_keys(fg, ax, n) for ax in scan_axes}
    rev = {ax: _scan_keys(fg.flip(ax), ax, n) for ax in scan_axes}
    l = torch.where(fg, iota, big)
    while True:
        m = l
        for ax in scan_axes:
            m = _seg_min_scan(m, fg, ax, fwd[ax], big, False)
            m = _seg_min_scan(m, fg, ax, rev[ax], big, True)
        if diag_offs:
            lp = torch.nn.functional.pad(m, [1, 1] * ndim, value=big)
            nm = m
            for off in diag_offs:
                nm = torch.minimum(nm, lp[tuple(
                    slice(1 + o, 1 + o + s) for o, s in zip(off, shape))])
            m = torch.where(fg, nm, big)
        taken = m.reshape(-1)[torch.where(m >= n, 0, m).reshape(-1)]
        m = torch.where(m >= n, big, taken.view(shape))
        if torch.equal(m, l):
            break
        l = m
    roots = l.to(torch.int32)
    if not flags:
        return roots
    return roots, (l == iota).to(torch.int32)


def label_roots(fg: torch.Tensor, offsets, flags: bool = False):
    """:func:`label_roots_plain` on a CPU tensor; on a CUDA tensor K18 (one
    host call: init, merge, compress, the flags written by the compress
    kernel; no merge where the structure has no offsets), adding the
    number of kernels launched, 3 or 2, to ``label_roots.launches``."""
    if fg.device.type == "cpu":
        return label_roots_plain(fg, offsets, flags)
    relax_check(fg, "label_roots")
    if fg.dtype != torch.bool:
        raise TypeError(f"label_roots: the kernel takes a bool mask, got "
                        f"{fg.dtype}")
    shape = tuple(fg.shape)
    roots = torch.empty(shape, dtype=torch.int32, device=fg.device)
    fl = torch.empty(shape, dtype=torch.int32, device=fg.device) \
        if flags else None
    taps = _taps_on(tuple(offsets), shape, fg.device)
    _lib()
    err = _entries["ed_label_roots"](
        fg.data_ptr(), roots.data_ptr(), _ptr(fl), _ptr(taps) if len(taps)
        else None, len(taps), _shape_arg(shape), fg.dim(), _stream(fg))
    _check_launch(err, "label_roots")
    label_roots.launches += 3 if len(taps) else 2
    return (roots, fl) if flags else roots


label_roots.launches = 0


def label_numbers_plain(roots: torch.Tensor, cum: torch.Tensor):
    """``label``'s numbering: ``cum[roots]`` (the inclusive count of roots
    up to a voxel's root, 1..n) where ``roots < n``, 0 elsewhere, int32."""
    n = roots.numel()
    flat = roots.reshape(-1).to(torch.int64)
    got = cum[torch.where(flat < n, flat, 0)]
    return torch.where(flat < n, got, 0).to(torch.int32).view(roots.shape)


def label_numbers(roots: torch.Tensor, flags: torch.Tensor):
    """``(labels, n)``: the roots numbered 1..n in raster order of their
    first voxel (SciPy's numbering), background 0, int32 on the roots'
    device, and the count as a Python int (the one host read). The inclusive
    ``torch.cumsum`` of the flags gives each root its number; on a CUDA
    tensor one gather kernel (K18's numbering) writes the labels, adding one
    to ``label_numbers.launches``."""
    cum = torch.cumsum(flags.reshape(-1), 0, dtype=torch.int32)
    if roots.device.type == "cpu":
        out = label_numbers_plain(roots, cum)
    else:
        relax_check(roots, "label_numbers")
        out = torch.empty_like(roots)
        _lib()
        err = _entries["ed_label_number"](
            roots.data_ptr(), cum.data_ptr(), out.data_ptr(), roots.numel(),
            _stream(roots))
        _check_launch(err, "label_numbers")
        label_numbers.launches += 1
    return out, int(cum[-1]) if cum.numel() else 0


label_numbers.launches = 0


# ---------------------------------------------------------------------------
# segments


def labels_index(labels: torch.Tensor, index, device):
    """``_norm_labels_index`` for given labels and index: ``(lut, K,
    expand, scalar)``, ``lut`` the int32 table from a label to its segment
    (-1 excluded) on ``device``, ``K`` the unique entries, ``expand`` the
    int64 tensor from each requested entry to its unique slot (None where
    the entries are sorted and unique); ``index`` None gives ``lut`` None
    (segment 0 where the label is positive)."""
    if index is None:
        return None, 1, None, True
    if isinstance(index, torch.Tensor):
        index = index.detach().cpu().numpy()
    scalar = np.isscalar(index)
    idx = np.atleast_1d(np.asarray(index, dtype=np.int64))
    if idx.size and int(idx.min()) < 0:
        raise ValueError("negative index values are not supported")
    if idx.ndim == 1 and bool(np.all(idx[1:] > idx[:-1])):
        # sorted and unique (``arange(1, n + 1)``): each entry is its own
        # slot, and np.unique's sort is skipped
        uniq, expand = idx, None
    else:
        uniq, inv = np.unique(idx, return_inverse=True)
        expand = torch.as_tensor(inv.reshape(-1).astype(np.int64)).to(device)
    lut_size = int(uniq.max()) + 2 if uniq.size else 2
    lut = np.full(lut_size, -1, dtype=np.int32)
    lut[uniq] = np.arange(len(uniq), dtype=np.int32)
    return torch.as_tensor(lut).to(device), len(uniq), expand, scalar


def _labels_int64(labels: torch.Tensor) -> torch.Tensor:
    """The labels as int64, as XLA converts them: integers wrap, floats
    truncate toward zero, saturate, and NaN gives 0."""
    if labels.dtype == torch.uint64:
        return labels.view(torch.int64)
    if not labels.dtype.is_floating_point:
        return labels.to(torch.int64)
    f = labels.to(torch.float64)
    t = torch.where(torch.isnan(f), 0.0, f).trunc()
    top = t >= 2.0 ** 63
    low = t < -2.0 ** 63
    t = torch.where(top | low, 0.0, t).to(torch.int64)
    return torch.where(top, _INT64_MAX, torch.where(low, _INT64_MIN, t))


def segment_ids_plain(labels, lut, shape, device) -> torch.Tensor:
    """Each voxel's segment, int64, -1 excluded, raveled: 0 everywhere
    without labels; without a table, 0 where the label is positive; else
    the table at the label where the label lies inside it."""
    n = int(np.prod(shape))
    if labels is None:
        return torch.zeros(n, dtype=torch.int64, device=device)
    flat = labels.reshape(-1)
    lab = _labels_int64(flat)
    if lut is None:
        if flat.dtype.is_floating_point:
            pos = flat > 0
        else:
            pos = lab != 0 if flat.dtype in _UNSIGNED else lab > 0
        return torch.where(pos, 0, -1).to(torch.int64)
    c = lab.clamp(0, lut.numel() - 1)
    return torch.where(lab == c, lut.to(torch.int64)[c], -1)


def order_keys(x: torch.Tensor, nan_key: int) -> torch.Tensor:
    """int64 keys whose order is the dtype's: -0.0 below +0.0, NaN mapped
    to ``nan_key`` (INT64_MIN for a minimum, INT64_MAX for a maximum),
    unsigned 64-bit values with the top bit flipped (``csrc/measure.cu``'s
    ``order_key``)."""
    if x.dtype == torch.float64:
        b = x.view(torch.int64)
        k = torch.where(b >= 0, b, b ^ _INT64_MAX)
    elif x.dtype == torch.float32:
        b = x.view(torch.int32).to(torch.int64)
        k = torch.where(b >= 0, b, b ^ _INT32_MAX)
    elif x.dtype == torch.uint64:
        return x.view(torch.int64) ^ _INT64_MIN
    else:
        return x.to(torch.int64)
    return torch.where(torch.isnan(x), nan_key, k)


def key_values(keys: torch.Tensor, dtype) -> torch.Tensor:
    """The values of :func:`order_keys` in ``dtype``; the NaN keys (and the
    empty segments' initial keys, INT64_MIN and INT64_MAX) give NaN in a
    float dtype."""
    if dtype == torch.float64:
        b = torch.where(keys >= 0, keys, keys ^ _INT64_MAX)
        nan = (keys == _INT64_MIN) | (keys == _INT64_MAX)
        return torch.where(nan, float("nan"), b.view(torch.float64))
    if dtype == torch.float32:
        nan = (keys == _INT64_MIN) | (keys == _INT64_MAX)
        k = torch.where(nan, 0, keys)
        b = torch.where(k >= 0, k, k ^ _INT32_MAX).to(torch.int32)
        return torch.where(nan, float("nan"), b.view(torch.float32))
    if dtype == torch.uint64:
        return (keys ^ _INT64_MIN).view(torch.uint64)
    if dtype == torch.bool:
        return keys != 0
    return keys.to(dtype)


def _coords(shape, device):
    """Each raveled voxel's coordinate along each axis, int64 ``(ndim,
    n)``."""
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device)
    out = []
    for k in range(len(shape)):
        stride = int(np.prod(shape[k + 1:]))
        out.append((idx // stride) % shape[k])
    return torch.stack(out) if out else idx[None]


def histogram_buckets(f: torch.Tensor, lo, hi, bins: int):
    """``histogram``'s bucket of each float64 value and whether it counts:
    ``floor((f - lo) * bins / (hi - lo))`` in float64 in that order, kept
    where ``lo <= f < hi``, clipped to ``[0, bins)``."""
    span = torch.tensor(float(hi - lo), dtype=torch.float64, device=f.device)
    ok = (f >= float(lo)) & (f < float(hi))
    q = torch.floor((f - float(lo)) * float(bins) / span)
    q = torch.where(ok, q, 0.0).to(torch.int64).clamp(0, bins - 1)
    return q, ok


def _init(stat, K, ndim, bins, device):
    """An accumulator before any voxel: sums and counts 0, minimum keys
    INT64_MAX, maximum keys INT64_MIN, coordinate bounds ``(INT32_MAX, -1)``
    per axis."""
    if stat in ("sum", "sum2"):
        return torch.zeros(K, dtype=torch.float64, device=device)
    if stat == "csum":
        return torch.zeros((K, ndim), dtype=torch.float64, device=device)
    if stat == "count":
        return torch.zeros(K, dtype=torch.int64, device=device)
    if stat == "min":
        return torch.full((K,), _INT64_MAX, dtype=torch.int64, device=device)
    if stat == "max":
        return torch.full((K,), _INT64_MIN, dtype=torch.int64, device=device)
    if stat == "bounds":
        b = torch.full((2, K, ndim), -1, dtype=torch.int32, device=device)
        b[0] = _INT32_MAX
        return b
    return torch.zeros((K, bins), dtype=torch.int64, device=device)


def segment_reduce_plain(x, labels, lut, K, stats, hist=None):
    """The JAX package's segment reductions (``_segment`` with
    ``segment_sum``, ``segment_min``, ``segment_max``; ``histogram``'s 2-D
    sum) over ``x``'s voxels by :func:`segment_ids_plain`, for each of
    ``stats``: a dict of ``"sum"``, ``"sum2"`` (float64 ``(K,)``),
    ``"count"`` (int64 ``(K,)``), ``"csum"`` (float64 ``(K, ndim)``: the
    sums of ``f * coord``), ``"min"``, ``"max"`` (:func:`order_keys`),
    ``"bounds"`` (int32 ``(2, K, ndim)``: each axis's least and greatest
    coordinate) and ``"hist"`` (int64 ``(K, bins)``; ``hist`` is ``(bins,
    lo, hi)``). Excluded voxels go to a segment ``K`` that is dropped."""
    dev = x.device
    shape = tuple(x.shape)
    ndim = len(shape)
    bins = hist[0] if hist else 0
    seg = segment_ids_plain(labels, lut, shape, dev)
    segk = torch.where(seg < 0, K, seg)
    out = {s: _init(s, K + 1, ndim, bins, dev) for s in stats if s != "hist"}
    need_f = {"sum", "sum2", "csum", "hist"} & set(stats)
    f = x.reshape(-1).to(torch.float64) if need_f else None
    if "sum" in out:
        out["sum"].index_add_(0, segk, f)
    if "sum2" in out:
        out["sum2"].index_add_(0, segk, f * f)
    if "count" in out:
        out["count"] = torch.bincount(segk, minlength=K + 1)
    if "csum" in out or "bounds" in out:
        co = _coords(shape, dev)
    if "csum" in out:
        for k in range(ndim):
            out["csum"][:, k].index_add_(0, segk, f * co[k].to(torch.float64))
    for stat, nan_key, how in (("min", _INT64_MIN, "amin"),
                               ("max", _INT64_MAX, "amax")):
        if stat in out:
            out[stat].scatter_reduce_(0, segk,
                                      order_keys(x.reshape(-1), nan_key), how)
    if "bounds" in out:
        out["bounds"] = torch.stack([torch.stack([
            torch.full((K + 1,), init, dtype=torch.int64,
                       device=dev).scatter_reduce_(0, segk, co[k], how)
            for k in range(ndim)], 1)
            for init, how in ((_INT32_MAX, "amin"), (-1, "amax"))]).to(
                torch.int32)
    res = {s: (v[:, :K] if s == "bounds" else v[:K]) for s, v in out.items()}
    if "hist" in stats:
        nb, lo, hi = hist
        q, ok = histogram_buckets(f, lo, hi, nb)
        key = torch.where(ok & (seg >= 0), seg * nb + q, K * nb)
        res["hist"] = torch.bincount(key, minlength=K * nb + 1)[
            :K * nb].view(K, nb)
    return res


def segment_smem(K, stats, ndim, bins=0) -> int:
    """The shared route's bytes of a block: every segment's accumulators
    (8 bytes a sum, sum of squares, coordinate sum and order key, 4 a count,
    coordinate bound and histogram bucket; ``csrc/measure.cu``'s
    ``shared_layout``)."""
    per = (8 * (("sum" in stats) + ("sum2" in stats) + ("min" in stats)
                + ("max" in stats) + ndim * ("csum" in stats))
           + 4 * (("count" in stats) + 2 * ndim * ("bounds" in stats)
                  + bins * ("hist" in stats)))
    return K * per


def segment_plan(K, stats, ndim, bins=0, route=None) -> str:
    """K19's route: ``"shared"`` where every segment's accumulators fit
    :data:`SEGMENT_SMEM`, else ``"device"``; ``route`` forces one (the
    shared route must fit)."""
    fits = segment_smem(K, stats, ndim, bins) <= SEGMENT_SMEM
    if route is None:
        return "shared" if fits else "device"
    if route not in ("shared", "device") or route == "shared" and not fits:
        raise ValueError(f"segment_reduce: route {route!r} does not take K="
                         f"{K} segments of {sorted(stats)}")
    return route


def _grid(x: torch.Tensor, route: str, smem: int) -> int:
    """K19's and K20's blocks: the shared route's (512 threads) a few an
    SM, fewer where the accumulators are large; the device route's (256
    threads) enough to give each warp a 32-voxel group, up to eight an
    SM."""
    sms = _sm_count(x.device)
    if route == "shared":
        return sms * max(1, min(_SEGMENT_SM_BLOCKS,
                                (227 << 10) // (smem + (1 << 10))))
    groups = -(-x.numel() // 32)
    return max(1, min(-(-groups // 8), sms * 8))


def segment_reduce(x, labels, lut, K, stats, hist=None, route=None):
    """:func:`segment_reduce_plain` on a CPU tensor; on a CUDA tensor K19
    (one launch on :func:`segment_plan`'s route), adding one to
    ``segment_reduce.launches`` and to its route's count in
    ``segment_reduce.routes``. ``x`` and ``labels`` (None or ``x``'s shape)
    are read in their own dtypes, the table ``lut`` (None or int32) on the
    card."""
    stats = tuple(s for s in STATS if s in stats)
    if x.device.type == "cpu":
        return segment_reduce_plain(x, labels, lut, K, stats, hist)
    _check(x, "segment_reduce")
    if labels is not None:
        _check(labels, "segment_reduce")
    ndim = x.dim()
    bins = hist[0] if hist else 0
    plan = segment_plan(K, stats, ndim, bins, route)
    out = {s: _init(s, K, ndim, bins, x.device) for s in stats}
    if x.numel() and K:
        blocks = _grid(x, plan, segment_smem(K, stats, ndim, bins))
        b = out.get("bounds")
        lo, hi = (float(hist[1]), float(hist[2])) if hist else (0.0, 0.0)
        span = float(hist[2] - hist[1]) if hist else 1.0
        _lib()
        err = _entries["ed_segment_reduce"](
            x.data_ptr(), DTYPE_CODES[x.dtype], _ptr(labels),
            DTYPE_CODES[labels.dtype] if labels is not None else 0,
            _ptr(lut), lut.numel() if lut is not None else 0, ndim,
            _shape_arg(x.shape), K, _ptr(out.get("sum")),
            _ptr(out.get("sum2")), _ptr(out.get("count")),
            _ptr(out.get("csum")), _ptr(out.get("min")),
            _ptr(out.get("max")), _ptr(b[0] if b is not None else None),
            _ptr(b[1] if b is not None else None), _ptr(out.get("hist")),
            bins, lo, hi, span, plan == "shared", blocks, _stream(x))
        _check_launch(err, "segment_reduce")
        segment_reduce.launches += 1
        segment_reduce.routes[plan] += 1
    return out


segment_reduce.launches = 0
segment_reduce.routes = {"shared": 0, "device": 0}


def segment_position_plain(x, labels, lut, K, keys):
    """``_positions``' second pass: per segment the least raveled index of
    a voxel equal (``==`` in ``x``'s dtype: -0.0 equals +0.0, NaN equals
    nothing) to the segment's extremum, whose order keys are ``keys``;
    ``x.numel()`` where none is, int64 ``(K,)``."""
    n = x.numel()
    if not K:
        return torch.zeros(0, dtype=torch.int64, device=x.device)
    seg = segment_ids_plain(labels, lut, tuple(x.shape), x.device)
    ext = key_values(keys, x.dtype)
    flat = x.reshape(-1)
    if flat.dtype in (torch.uint16, torch.uint32):
        flat, ext = flat.to(torch.int64), ext.to(torch.int64)
    elif flat.dtype == torch.uint64:
        flat, ext = flat.view(torch.int64), ext.view(torch.int64)
    hit = (flat == ext[seg.clamp(min=0)]) & (seg >= 0)
    segk = torch.where(hit, seg, K)
    pos = torch.full((K + 1,), n, dtype=torch.int64, device=x.device)
    pos.scatter_reduce_(0, segk, torch.arange(n, device=x.device), "amin")
    return pos[:K]


def segment_position(x, labels, lut, K, keys):
    """:func:`segment_position_plain` on a CPU tensor; on a CUDA tensor K20
    (one launch), adding one to ``segment_position.launches``."""
    if x.device.type == "cpu":
        return segment_position_plain(x, labels, lut, K, keys)
    _check(x, "segment_position")
    if labels is not None:
        _check(labels, "segment_position")
    pos = torch.full((K,), x.numel(), dtype=torch.int64, device=x.device)
    if x.numel() and K:
        blocks = _grid(x, "device", 0)
        _lib()
        err = _entries["ed_segment_position"](
            x.data_ptr(), DTYPE_CODES[x.dtype], _ptr(labels),
            DTYPE_CODES[labels.dtype] if labels is not None else 0,
            _ptr(lut), lut.numel() if lut is not None else 0, x.dim(),
            _shape_arg(x.shape), blocks, keys.data_ptr(),
            pos.data_ptr(), _stream(x))
        _check_launch(err, "segment_position")
        segment_position.launches += 1
    return pos


segment_position.launches = 0
