"""The ndimage order-statistic and morphology tier: minimum/maximum filters,
rank, median and percentile filters, grey and binary morphology, and the
watershed.

Counterpart of the JAX package's ``ops/morphology.py``. Four kernels carry
it (``csrc/morphology.cu``), and ``watershed_ift`` a fifth:

* :func:`min_max_box` is the wrapper of K10 (:func:`min_max_filter1d` its
  one-axis form): the min or max over a separable box, a 1-D pass per axis
  as the JAX package runs one ``lax.reduce_window`` per axis, each axis's
  mode folded in the kernel. Two routes, which :func:`_box_plan` picks:
  ``"box"`` (a box with extent > 1 on one to three axes whose box fits
  shared memory: one launch, a block staging its tile's halo box once and
  running every pass there) and ``"lines"`` (a launch a pass, the rest);
  both take each window in the same order, bit for bit. Its counters are
  ``min_max_filter1d.launches`` and ``.routes``.
* :func:`min_max_filter` (K11): the min or max over an N-D footprint's taps,
  for a non-flat structure of ``x - s`` (erosion) or ``x + s`` (dilation) in
  the work type (float64 for integers and bool), whose result is truncated,
  saturated at the type's range and cast, as XLA casts it. Two routes, which
  :func:`_min_max_plan` picks: ``"tile"`` (extent > 1 on at most three
  axes, a box that fits shared memory: a block stages its tile's halo box
  in the work type once and reduces from there, K12's select tile's
  geometry) and ``"nd"`` (one thread per voxel in device memory, the
  rest); both reduce the taps in raster order, bit for bit.
* :func:`rank_filter` (K12): the ``rank``-th smallest footprint tap; up to
  :data:`RANK_NETWORK_MAX_TAPS` taps through a Batcher comparator network
  (NaN-propagating min/max, so a window holding a NaN gives NaN; the JAX
  package's pruned network), above it a selection in the stable sort's
  order (NaN last, -0 equal to +0, equal values in tap order). The cap is
  kept for that NaN result, which differs between the two. Each takes one
  of two routes, which :func:`_rank_plan` picks. The network:
  ``"network_tile"`` (3-64 taps, extent > 1 on at most three axes, a box
  that fits shared memory: a block stages its tile's halo box of values
  once, each thread runs the network on its voxels' taps in registers) and
  ``"network"`` (the old kernel, one thread per voxel in device memory,
  the rest). The selection: ``"tile"`` (a block stages its tile's halo box
  of keys and values once and selects from there, several key bits a pass)
  and ``"nd"`` (one thread per voxel in device memory, the rest).
* :func:`binary_step` (K13): one AND (erosion) or OR (dilation) sweep over
  a structure's taps, ``border_value`` beyond the edge, mask-gated, on bool
  bytes; :func:`binary_sweeps` runs ``k`` of them in one launch on the
  bit-packed state of :func:`pack_bits`; :func:`binary_erosion_dilation`
  runs a fixed number of sweeps or sweeps to the fixpoint. Two routes,
  which :func:`_binary_plan` picks: ``"tile"`` (1-3 axes, a reach of at most
  32 voxels along the innermost axis, a box that fits shared memory: a
  block runs its sweeps on a tile of 32-voxel words and its halo) and
  ``"nd"`` (K11's kernel on bool, one sweep a launch, for the rest).
* :func:`watershed_ift`: K17's Jacobi sweeps of the (cost, steps, label)
  triples (:func:`~elasticdeform_tpu_torch.ops.distance.watershed_sweep`,
  beside K14-K16 in :mod:`~elasticdeform_tpu_torch.ops.distance`), run to
  the fixpoint by :func:`relax_to_fixpoint` over :class:`RelaxTaps` tables,
  as the chamfer distance's K16 sweeps are; :func:`sweep_to_fixpoint` reads
  the changed flag once a group of sweeps for them and for K13.

Min and max order -0 below +0, as ``jnp.minimum`` and ``jnp.maximum`` do.

On a CPU tensor each wrapper takes its plain version (``*_plain``: the JAX
package's algorithm over slices of the padded array); on a CUDA tensor it
launches its kernel or raises, and adds one to its ``.launches`` counter
(K11, K12 and K13 also to their route's count in ``.routes``); footprint
offsets, structure values, comparator pairs and tile tables go to the card
once per footprint, shape and device (``_geometry``, ``_structure_values``,
``_network_pairs``, ``_tile_tables``). Every
result is a selection, or one subtraction per tap, so the kernels agree with
their plain versions, and the plain versions with the JAX package, bit for
bit. PyTorch lacks most operations on uint16, uint32 and uint64; the plain
versions work on uint16 and uint32 widened to the next signed type and on
uint64 with its top bit flipped into int64, which keep the order, and map
back. There is no gradient: the JAX package has no backward of its own here.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F

from elasticdeform_tpu_torch.ops import _build
from elasticdeform_tpu_torch.ops.filters import (
    _MODE_CODES, _expand_to_ndim, _normalize_axes, _stream, check_mode,
    halo_tile, normalize_sequence, pad_axis,
)
from elasticdeform_tpu_torch.ops.prefilter import SMEM_LIMIT, _lines
from elasticdeform_tpu_torch.ops.resample import numpy_dtype

# footprints up to this many taps select through the comparator network,
# larger ones in the sort's order: the two differ on windows holding a NaN
RANK_NETWORK_MAX_TAPS = 64
# K11, K12 and K13's fixed limit on the input's axes (ED_MORPH_MAXR)
MAX_ND_AXES = 8
# sweeps between two reads of the fixpoint's "changed" flag, and the most
# sweeps one tile launch runs
SWEEPS_PER_CHECK = 8
# K13's tile route (csrc ED_BIN_*): threads a block, taps, the per-axis
# reach its tap encoding holds, a block's shared memory on the H100, and the
# card's SMs
BIN_THREADS = 1024
BIN_MAX_TAPS = 1024
BIN_MAX_REACH = 127
BIN_SMEM_LIMIT = 232448
_SMS = 132
# the tile plan's cost model, in word-row visits of one SM (a row's three
# words loaded and its taps shifted in, about 8 lane instructions): a launch
# with its host call costs about 8 us, some 200 K such visits; a staged box
# word costs 2 (packed) or 24 (a warp's ballot over 32 bytes), a written
# tile word 1 or 16
_LAUNCH_WORK = 200_000
_STAGE_WORK = {False: 2, True: 24}
_WRITE_WORK = {False: 1, True: 16}

# K12's select route on a halo box (csrc ED_RANK_*): a block of 8 x 32
# threads, each with a column of RANK_COLUMN voxels along tile axis 0 (1
# where that axis has extent 1); the kernel resolves ED_RANK_BITS = 2 key
# bits a pass
RANK_TILE = (8, 32)
RANK_COLUMN = 4
# K11's tile route (csrc ED_MINMAX_COLUMN): the same blocks, each thread
# with a column of MINMAX_COLUMN voxels (1 where tile axis 0 has extent 1)
MINMAX_COLUMN = 8
# K12's network route on a halo box (rank_network_tile_kernel, csrc
# ED_NET_COLUMN): the same blocks, each thread with a column of
# NETWORK_COLUMN voxels taken in turn
# (1 where tile axis 0 has extent 1), and the wire counts it is built for
# (two or fewer taps stay on the old kernel)
NETWORK_COLUMN = 4
NETWORK_TILE_WIRES = (4, 8, 16, 32, 64)
# K10's box route (csrc ED_BOX_SEGMENT): 256 threads a block; the output
# tile's extents it chooses among, per tile axis; the shared bytes a block
# aims at (two buffers of the box), so that three blocks share an SM
BOX_TILE_EXTENTS = ((1, 2, 4, 8, 16), (1, 2, 4, 8, 16, 32), (32, 64))
BOX_SMEM_AIM = 76 * 1024

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


def binary_sweeps_plain(x: torch.Tensor, structure, centers, border: bool,
                        dilation: bool, mask=None, k: int = 1, changed=None
                        ) -> torch.Tensor:
    """Plain version of a ``k``-sweep launch of K13's tile route: ``k``
    calls of :func:`binary_step_plain` on bool ``x``, ``changed`` set by the
    last one."""
    for s in range(k):
        x = binary_step_plain(x, structure, centers, border, dilation, mask,
                              changed if s == k - 1 else None)
    return x


def pack_bits_plain(x: torch.Tensor, border: bool) -> torch.Tensor:
    """Plain version of :func:`pack_bits`: bit ``j`` of word ``w`` is
    voxel ``32 w + j`` of the last axis, the pad bits ``border``; int32
    words of ``x.shape[:-1] + (ceil(n / 32),)``."""
    n = x.shape[-1]
    nw = -(-n // 32)
    v = x.to(torch.int64)
    if nw * 32 > n:
        v = torch.cat([v, torch.full(x.shape[:-1] + (nw * 32 - n,),
                                     int(bool(border)), dtype=torch.int64,
                                     device=x.device)], -1)
    bit = torch.arange(32, dtype=torch.int64, device=x.device)
    words = (v.reshape(*x.shape[:-1], nw, 32) << bit).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def unpack_bits_plain(words: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of :func:`unpack_bits`: the bool voxels of packed
    words, the last axis cut to ``n``."""
    bit = torch.arange(32, dtype=torch.int64, device=words.device)
    v = (words.to(torch.int64)[..., None] >> bit) & 1
    return v.reshape(*words.shape[:-1], -1)[..., :n].to(
        torch.bool).contiguous()


# ---------------------------------------------------------------------------
# K13's plan

_BinPlan = collections.namedtuple("_BinPlan",
                                  "route tile k box smem blocks")
_ND_PLAN = _BinPlan("nd", None, 1, None, 0, 0)


@functools.lru_cache(maxsize=512)
def _binary_plan(shape3, reach, ntaps, rows, want, bytes_io, route=None,
                 budget=BIN_SMEM_LIMIT):
    """K13's route for ``want`` sweeps a launch of an array of ``shape3``
    voxels (three axes, leading ones added) under a structure of ``ntaps``
    taps in ``rows`` rows (distinct offsets on the two outer axes) and
    per-axis ``reach``. ``"tile"``: the tile (voxels, voxels, words), the
    sweeps a launch ``k <= min(want, 8)``, the box (words per axis) and its shared
    bytes (the state twice, the gate, the row table) within ``budget``, chosen
    by the least modelled cost of ``want`` sweeps in launches of ``k`` and
    the rest: per launch a constant, plus the busiest SM's staging, sweeps
    (each row visit of each word of each sweep's region, in whole passes of
    the block's threads) and writes. ``"nd"`` where
    the reach along the innermost axis passes 32, an outer reach passes
    :data:`BIN_MAX_REACH`, the taps pass :data:`BIN_MAX_TAPS` or no box
    fits. ``route`` forces one (``"tile"`` raises where none fits)."""
    nz, ny, nx = shape3
    nw = -(-nx // 32)
    rz, ry, rx = reach
    fits = (rx <= 32 and max(rz, ry) <= BIN_MAX_REACH
            and ntaps <= BIN_MAX_TAPS)
    best = None
    if route != "nd" and fits:
        n3, r3 = (nz, ny, nw), (rz, ry, 1 if rx else 0)
        tws = (nw,) if nw <= 32 else (8, 16, 32)
        tys = sorted({min(ny, t) for t in (1, 2, 4, 8, 16, 32, 64)})
        tzs = sorted({min(nz, t) for t in (1, 2, 4, 8, 16, 32)})

        def region(tile, left):
            return math.prod(min(n, t + 2 * left * r)
                             for n, t, r in zip(n3, tile, r3))

        def launch(tile, k, box):
            """the modelled cost of one launch of ``k`` sweeps"""
            blocks = math.prod(-(-n // t) for n, t in zip(n3, tile))
            # a sweep takes its threads' slowest pass over the region
            work = (_STAGE_WORK[bytes_io] * math.prod(box)
                    + _WRITE_WORK[bytes_io] * math.prod(tile)
                    + (rows + 1) * sum(
                        -(-region(tile, left) // BIN_THREADS) * BIN_THREADS
                        for left in range(k)))
            return blocks, _LAUNCH_WORK + -(-blocks // _SMS) * work
        for k in range(1, min(int(want), SWEEPS_PER_CHECK) + 1):
            for tile in itertools.product(tzs, tys, tws):
                box = tuple(min(n, t + 2 * k * r)
                            for n, t, r in zip(n3, tile, r3))
                smem = (3 * math.prod(box) + rows + ntaps) * 4
                if smem > budget:
                    continue
                # ``want`` sweeps: launches of k, then the rest
                blocks, cost = launch(tile, k, box)
                full, rest = divmod(int(want), k)
                cost *= full
                if rest:
                    cost += launch(tile, rest, box)[1]
                key = (cost, -k, tile)
                if best is None or key < best[0]:
                    best = (key, _BinPlan("tile", tile, k, box, smem,
                                          blocks))
    if best is None:
        if route == "tile":
            raise ValueError("binary_step: the tile route cannot take this "
                             "structure")
        return _ND_PLAN
    return best[1]


class _Stencil:
    """A structure's taps on an array of ``shape``, for both of K13's
    routes: the tile route's tap offsets (leading axes of 1 added to reach
    three, sorted by row), its table of rows and dx values, rows and
    per-axis reach; the nd route's :class:`_Geometry`, built on first
    use."""

    def __init__(self, shape, structure, centers):
        self.shape = tuple(int(n) for n in shape)
        self.structure = np.asarray(structure, dtype=bool)
        self.centers = list(centers)
        ndim = len(self.shape)
        off = np.argwhere(self.structure) - np.asarray(self.centers,
                                                       dtype=np.int64)
        self.ntaps = len(off)
        self.tiled = ndim <= 3
        self._taps, self._geometry = {}, None
        if not self.tiled:
            return
        off3 = np.zeros((self.ntaps, 3), dtype=np.int64)
        off3[:, 3 - ndim:] = off.reshape(self.ntaps, ndim)
        off3 = off3[np.lexsort((off3[:, 2], off3[:, 1], off3[:, 0]))]
        self.shape3 = (1,) * (3 - ndim) + self.shape
        self.reach = tuple(int(r) for r in (np.abs(off3).max(0)
                                            if self.ntaps else (0, 0, 0)))
        self.offsets = off3
        rows = {}
        for oz, oy, dx in off3.tolist():
            rows.setdefault((oz, oy), []).append(dx)
        self.rows = len(rows)
        # the kernel's table: a code per row (oz, oy as signed bytes in bits
        # 24-31 and 16-23, its tap count in bits 1-8, bit 0 where a tap has
        # dx != 0), then every row's dx values in order
        codes = [(oz & 0xFF) << 24 | (oy & 0xFF) << 16 | len(dxs) << 1
                 | any(dxs) for (oz, oy), dxs in rows.items()]
        self.table = np.asarray(codes + [dx for dxs in rows.values()
                                         for dx in dxs],
                                dtype=np.int64).astype(np.uint32).view(
            np.int32)

    def plan(self, want, bytes_io, route=None, budget=BIN_SMEM_LIMIT):
        if not self.tiled:
            if route == "tile":
                raise ValueError("binary_step: the tile route takes 1 to 3 "
                                 "axes")
            return _ND_PLAN
        return _binary_plan(self.shape3, self.reach, self.ntaps, self.rows,
                            int(want), bool(bytes_io), route, budget)

    def taps_on(self, device):
        if device not in self._taps:
            self._taps[device] = torch.as_tensor(self.table).to(device)
        return self._taps[device]

    def geometry(self, x: torch.Tensor):
        if self._geometry is None:
            self._geometry = _geometry(x, self.structure, self.centers,
                                       "binary_step")
        return self._geometry


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
        fn = lib.ed_min_max_box
        fn.restype = i
        fn.argtypes = [i, i, vp, vp, ip, lp, ip, ip, ip, ip, i, ip, i, lp, lp,
                       ll, i, ll, vp]
        fn = lib.ed_min_max_filter
        fn.restype = i
        fn.argtypes = [i, i, i, vp, vp, vp, vp, vp, i, lp, ip, ip, i, i, ll,
                       vp]
        fn = lib.ed_rank_filter
        fn.restype = i
        fn.argtypes = [i, vp, vp, vp, vp, vp, i, i, i, i, lp, ip, ip, i, i,
                       ll, ll, vp]
        fn = lib.ed_rank_select_tile
        fn.restype = i
        fn.argtypes = [i, i, vp, vp, vp, ip, lp, ip, ip, i, lp, lp, i, i, i,
                       ll, i, ll, vp]
        fn = lib.ed_rank_network_tile
        fn.restype = i
        fn.argtypes = [i, i, i, vp, vp, vp, ip, lp, ip, ip, i, lp, lp, i, i,
                       i, ll, ll, i, ll, vp]
        fn = lib.ed_min_max_tile
        fn.restype = i
        fn.argtypes = [i, i, i, i, vp, vp, vp, vp, ip, lp, ip, ip, i, lp, lp,
                       i, i, ll, i, ll, vp]
        fn = lib.ed_binary_step
        fn.restype = i
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i, lp, ip, ip, i, i, i, vp]
        fn = lib.ed_binary_tile
        fn.restype = i
        fn.argtypes = [vp, vp, vp, vp, vp] + [i] * 15 + [vp]
        fn = lib.ed_binary_pack
        fn.restype = i
        fn.argtypes = [vp, vp, ll, i, i, i, vp]
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
    """The host arrays of an N-D footprint on an array of ``shape`` on
    ``device``: per tap its offsets from the centre (``off``, int32) and
    linear offset (``delta``), on the device, and the least and greatest
    offset per axis."""

    def __init__(self, shape, device, footprint, centers, what: str):
        ndim = len(shape)
        if not 1 <= ndim <= MAX_ND_AXES:
            raise ValueError(f"{what}: the CUDA kernel takes 1 to "
                             f"{MAX_ND_AXES} axes, got {ndim}")
        taps = np.argwhere(np.asarray(footprint, dtype=bool))
        off = (taps - np.asarray(centers, dtype=np.int64)).astype(np.int32)
        off = off.reshape(len(taps), ndim)
        strides = np.cumprod([1] + list(shape[::-1]))[:-1][::-1]
        self.taps = len(taps)
        self.off = torch.as_tensor(np.ascontiguousarray(off)).to(device)
        self.delta = torch.as_tensor(np.ascontiguousarray(
            off.astype(np.int64) @ np.asarray(strides, np.int64))).to(device)
        zeros = np.zeros(ndim, dtype=np.int32)
        lo = off.min(axis=0) if self.taps else zeros
        hi = off.max(axis=0) if self.taps else zeros
        i = ctypes.c_int
        self.args = (ndim, (ctypes.c_longlong * ndim)(*shape),
                     (i * ndim)(*lo.tolist()), (i * ndim)(*hi.tolist()),
                     self.taps)


@functools.lru_cache(maxsize=64)
def _cached_geometry(shape, fkey, fshape, centers, device, what):
    return _Geometry(shape, device, np.frombuffer(fkey, dtype=bool).reshape(
        fshape), centers, what)


def _geometry(x: torch.Tensor, footprint, centers, what: str) -> _Geometry:
    """The :class:`_Geometry` of ``footprint`` on ``x``, built and uploaded
    once per footprint, centres, shape and device."""
    fp = np.ascontiguousarray(footprint, dtype=bool)
    return _cached_geometry(tuple(int(n) for n in x.shape), fp.tobytes(),
                            fp.shape, tuple(int(c) for c in centers),
                            x.device, what)


@functools.lru_cache(maxsize=64)
def _network_pairs(taps: int, rank: int, device):
    """``(wires, comparators, pairs on device)`` of the network route,
    uploaded once per tap count, rank and device."""
    wires, comparators = _rank_network(taps, rank)
    pairs = torch.as_tensor(np.asarray(comparators, dtype=np.uint8).reshape(
        -1, 2)).to(device) if comparators else None
    return wires, len(comparators), pairs


class RankPlan(collections.namedtuple(
        "RankPlan", "route tile_axes grid_axes column box smem blocks",
        defaults=((), (), 0, (), 0, 0))):
    """How K12 (or K11) runs on a footprint of ``kshape`` over an array of
    ``shape``: ``route`` ``"network_tile"`` or ``"network"`` (K12 up to
    :data:`RANK_NETWORK_MAX_TAPS` taps), ``"tile"`` or ``"nd"`` (K11, and
    K12's select route above). For a tile (``"network_tile"`` or
    ``"tile"``): the tile and grid axes of
    :func:`~elasticdeform_tpu_torch.ops.filters.halo_tile`; the ``column``
    C of voxels a thread keeps along tile axis 0; the halo ``box`` (the
    tile ``(C, 8, 32)`` grown by the footprint's extent - 1); ``smem``, the
    shared bytes of the box (K12's network: values, then the wires'
    offsets; its select route: keys and values; K11: the work
    type, and the structure's values when non-flat) and the taps' offsets;
    ``blocks``, the tiles times the walked batch."""


def _halo_plan(what, shape, kshape, column, box_bytes, taps: int,
               route, names=("tile", "nd")) -> RankPlan:
    """The halo-box tile plan of K11 or K12 (``what``) on an array of
    ``shape`` under a footprint of ``kshape`` with ``taps`` taps: the tile
    route (``names[0]``) when the footprint has extent > 1 on one to three
    axes, the box's ``box_bytes(cells)`` bytes, rounded up to 4, and the
    taps' int32 offsets fit :data:`SMEM_LIMIT`, a sample's tile axes span
    fewer than 2^31 elements and the grid fewer than 2^31 blocks, else the
    other route (``names[1]``); the ``column``, 1 where tile axis 0 has
    extent 1. ``route`` forces a choice (a forced tile that does not fit
    raises ValueError)."""
    tile_route, other = names
    if route == other:
        return RankPlan(other)
    if route not in (None, tile_route):
        raise ValueError(f"route must be {tile_route!r} or {other!r}, got "
                         f"{route!r}")

    def refuse(why):
        if route == tile_route:
            raise ValueError(f"{what}'s {tile_route} route does not take "
                             f"{why}")
        return RankPlan(other)

    geo = halo_tile(shape, kshape)
    if not 1 <= geo.axes <= 3:
        return refuse(f"a footprint with extent > 1 on {geo.axes} axes")
    if geo.span >= 2 ** 31:
        return refuse("a sample of 2^31 elements or more")
    tile = (1 if geo.n3[0] == 1 else column,) + RANK_TILE
    box = geo.box(tile)
    smem = -(-box_bytes(math.prod(box)) // 4) * 4 + 4 * taps
    if smem > SMEM_LIMIT:
        return refuse(f"a box of {box} and {taps} taps: {smem} bytes, over "
                      f"{SMEM_LIMIT}")
    blocks = geo.blocks(tile)
    if blocks >= 2 ** 31:
        return refuse(f"{blocks} blocks")
    return RankPlan(tile_route, geo.tile_axes, geo.grid_axes, tile[0], box,
                    smem, blocks)


@functools.lru_cache(maxsize=1024)
def _rank_plan(shape, kshape, dtype, taps: int, route=None) -> RankPlan:
    """K12's route on a ``dtype`` array of ``shape`` under a footprint of
    ``kshape`` with ``taps`` taps. Up to :data:`RANK_NETWORK_MAX_TAPS` taps
    the comparator network (its NaN rule is the JAX package's there, so no
    other route may take them): :func:`_halo_plan`'s ``"network_tile"``
    (a box of values, then the wires' offsets, :data:`NETWORK_COLUMN`
    voxels a thread) for three to 64
    taps, else ``"network"``, the old kernel (two taps or fewer, and what
    the box does not take). Above, :func:`_halo_plan`'s select tile (a box
    of keys and values, :data:`RANK_COLUMN`) or the nd route. ``route``
    forces a choice (a forced tile that does not fit raises ValueError).
    Cached: the wrapper asks at every launch."""
    if taps <= RANK_NETWORK_MAX_TAPS:
        if route not in (None, "network_tile", "network"):
            raise ValueError(f"K12 takes {taps} taps on its network routes "
                             f"only, not {route!r}")
        wires, _ = _rank_network(taps, 0)
        if wires not in NETWORK_TILE_WIRES:
            if route == "network_tile":
                raise ValueError(f"K12's network_tile route does not take "
                                 f"{taps} taps")
            return RankPlan("network")
        return _halo_plan(
            "K12", shape, kshape, NETWORK_COLUMN,
            lambda cells: cells * dtype.itemsize + 4 * (wires - taps),
            taps, route, ("network_tile", "network"))
    return _halo_plan("K12", shape, kshape, RANK_COLUMN,
                      lambda cells: 2 * cells * dtype.itemsize, taps, route)


@functools.lru_cache(maxsize=1024)
def _min_max_plan(shape, kshape, work, taps: int, nonflat: bool,
                  route=None) -> RankPlan:
    """K11's route on an array of ``shape`` under a footprint of ``kshape``
    with ``taps`` taps, reduced in the ``work`` dtype: :func:`_halo_plan`'s
    tile route (a box in the work type, a ``nonflat`` structure's values
    beside it, :data:`MINMAX_COLUMN`) or the nd route. ``route`` forces a
    choice. Cached: the wrapper asks at every launch."""
    return _halo_plan(
        "K11", shape, kshape, MINMAX_COLUMN,
        lambda cells: (cells + (taps if nonflat else 0)) * work.itemsize,
        taps, route)


@functools.lru_cache(maxsize=64)
def _tile_tables(fkey, fshape, centers, shape, plan, device):
    """K11's and K12's tile route arguments for ``plan``, built and
    uploaded once per footprint, shapes and device: each tap's offset into
    the box (raster order) on ``device``, and the host arrays of
    ``ed_rank_select_tile`` and ``ed_min_max_tile``."""
    taps = np.argwhere(np.frombuffer(fkey, dtype=bool).reshape(fshape))
    geo = halo_tile(shape, fshape)
    idx = np.zeros((len(taps), 3), dtype=np.int64)
    c3 = [0] * 3
    for a, ax in geo.kernel_axes():
        c3[a] = int(centers[ax])
        idx[:, a] = taps[:, ax]
    P1, P0 = plan.box[2], plan.box[1] * plan.box[2]
    toff = (idx @ np.array([P0, P1, 1], dtype=np.int64)).astype(np.int32)
    i, ll = ctypes.c_int, ctypes.c_longlong
    host = ((i * 3)(*geo.n3), (ll * 3)(*geo.st3), (i * 3)(*geo.k3),
            (i * 3)(*c3), *geo.grid_host(), len(taps))
    return torch.as_tensor(toff).to(device), host


class BoxPlan(collections.namedtuple(
        "BoxPlan", "route tile_axes grid_axes tile box p2 smem blocks",
        defaults=((), (), (), (), 0, 0, 0))):
    """How K10 runs a separable box of extents ``kshape`` over an array of
    ``shape``: ``route`` ``"box"`` (every pass in one launch) or
    ``"lines"`` (a launch a pass). For the box: the tile and grid axes of
    :func:`~elasticdeform_tpu_torch.ops.filters.halo_tile`; the output
    ``tile`` and the staged ``box`` (the tile grown by the box's extent -
    1), three extents each; ``p2``, the box's row stride in shared memory
    (:func:`_box_row_stride`); ``smem``, two buffers of the box;
    ``blocks``, the tiles times the walked batch."""


def _box_row_stride(length: int, item: int) -> int:
    """The shared row stride of K10's box (csrc ``box_row_stride``): a row
    of ``length`` elements of ``item`` bytes padded to an odd number of
    32-bit words (of 8-byte elements for 8-byte types), so that
    neighbouring rows start on other banks."""
    p2 = length
    while (p2 * item % 4 or p2 * item // 4 % 2 == 0) if item <= 4 \
            else p2 % 2 == 0:
        p2 += 1
    return p2


@functools.lru_cache(maxsize=1024)
def _box_plan(shape, kshape, dtype) -> BoxPlan:
    """K10's route for a separable box of extents ``kshape`` (1 off the
    box; one to three axes of extent > 1 after merging, or the lines route)
    on a ``dtype`` array of ``shape``. The box route's tile is the one of
    :data:`BOX_TILE_EXTENTS` (clipped to the array) that stages the fewest
    box elements per output within :data:`BOX_SMEM_AIM` bytes, or within
    :data:`SMEM_LIMIT` where none fits the aim, the larger tile among
    equals; the elements count the last tile of each axis whole, so that a
    tile that leaves a part of a tile past the array's edge (an inner axis
    of 96 on tiles of 64) loses to one that does not. A sample's tile axes
    must span fewer than 2^31 elements and the grid fewer than 2^31 blocks.
    Cached: the wrappers ask at every launch."""
    lines = BoxPlan("lines")
    geo = halo_tile(shape, kshape)
    if not 1 <= geo.axes <= 3 or geo.span >= 2 ** 31:
        return lines
    item = dtype.itemsize
    best = None
    for tile in itertools.product(*[sorted({min(t, n) for t in ts})
                                    for ts, n in zip(BOX_TILE_EXTENTS,
                                                     geo.n3)]):
        box = geo.box(tile)
        p2 = _box_row_stride(box[2], item)
        smem = 2 * box[0] * box[1] * p2 * item
        if smem > SMEM_LIMIT:
            continue
        staged = math.prod(-(-n // t) * b
                           for n, t, b in zip(geo.n3, tile, box))
        key = (smem > BOX_SMEM_AIM, staged / math.prod(geo.n3),
               -math.prod(tile))
        if best is None or key < best[0]:
            best = (key, tile, box, p2, smem)
    if best is None:
        return lines
    _, tile, box, p2, smem = best
    blocks = geo.blocks(tile)
    if blocks >= 2 ** 31:
        return lines
    return BoxPlan("box", geo.tile_axes, geo.grid_axes, tile, box, p2, smem,
                   blocks)


@functools.lru_cache(maxsize=256)
def _box_tables(shape, passes, plan, floating: bool):
    """``ed_min_max_box``'s host arrays for ``plan`` and the ``passes``
    ``((axis, size, centre, mode), ...)``: per tile axis its extent,
    stride, the box's extent, centre and mode (nearest off the box), the
    tile; the passes' tile axes in order; the grid's batch axes. A box of a
    ``floating`` type keeps the caller's order (a window holding NaNs takes
    the first, as the sequential passes do); on integers and bool the min
    and max of a box do not depend on the order, and the pass along tile
    axis 2 runs first, so that the last pass, along axis 0 or 1, stores the
    tile with its threads along the contiguous axis."""
    kshape = [1] * len(shape)
    for axis, size, _, _ in passes:
        kshape[axis] = size
    geo = halo_tile(shape, tuple(kshape))
    k3, c3, m3 = [1] * 3, [0] * 3, [_MODE_CODES["nearest"]] * 3
    order = []
    for axis, size, center, mode in passes:
        a = geo.tile_axes.index(geo.group[axis])
        k3[a], c3[a], m3[a] = size, center, _MODE_CODES[mode]
        order.append(a)
    if not floating:
        order.sort(key=lambda a: a != 2)
    i, ll = ctypes.c_int, ctypes.c_longlong
    return ((i * 3)(*geo.n3), (ll * 3)(*geo.st3), (i * 3)(*k3),
            (i * 3)(*c3), (i * 3)(*m3), (i * 3)(*plan.tile), len(order),
            (i * 3)(*order), *geo.grid_host())


def _launch_lines(x: torch.Tensor, size: int, axis: int, mode: str, cval,
                  center: int, minimum: bool) -> torch.Tensor:
    """K10's lines route, one pass along ``axis`` (``min_max_1d_kernel``).
    Counts nothing."""
    _check(x, "min_max_filter1d")
    out = torch.empty_like(x)
    outer, n, inner = _lines(x, axis)
    lib = _lib()
    err = lib.ed_min_max_filter1d(
        _DTYPE_CODES[x.dtype], int(minimum), x.data_ptr(), out.data_ptr(),
        outer, n, inner, int(size), int(center), _MODE_CODES[mode],
        _bits(cval, x.dtype), _stream(x))
    _build.check(err, lib, "ed_morphology_error_string", "min_max_filter1d")
    return out


def _launch_box(x: torch.Tensor, passes, cval, minimum: bool,
                plan: BoxPlan) -> torch.Tensor:
    """K10 on the route ``plan`` names: the box route in one launch, or the
    lines route a launch a pass. Counts nothing."""
    if plan.route == "lines":
        for axis, size, center, mode in passes:
            x = _launch_lines(x, size, axis, mode, cval, center, minimum)
        return x
    _check(x, "min_max_filter1d")
    out = torch.empty_like(x)
    host = _box_tables(tuple(int(n) for n in x.shape), tuple(passes), plan,
                       x.dtype.is_floating_point)
    lib = _lib()
    err = lib.ed_min_max_box(
        _DTYPE_CODES[x.dtype], int(minimum), x.data_ptr(), out.data_ptr(),
        *host, _bits(cval, x.dtype), plan.smem, plan.blocks, _stream(x))
    _build.check(err, lib, "ed_morphology_error_string", "min_max_filter1d")
    return out


def min_max_box_plain(x: torch.Tensor, passes, cval,
                      minimum: bool) -> torch.Tensor:
    """Plain version of K10's box: :func:`min_max_filter1d_plain` once per
    pass ``(axis, size, centre, mode)``, in order."""
    for axis, size, center, mode in passes:
        x = min_max_filter1d_plain(x, size, axis, mode, cval, center,
                                   minimum)
    return x


def min_max_box(x: torch.Tensor, passes, cval,
                minimum: bool) -> torch.Tensor:
    """The min (``minimum``) or max over a separable box: a 1-D pass per
    ``(axis, size, centre, mode)`` of ``passes`` in order (sizes > 1,
    distinct axes), ``cval`` (in ``x``'s type, see :func:`raw_cval`) beyond
    the edge of a constant-mode axis. A CPU tensor takes
    :func:`min_max_box_plain`; a CUDA tensor launches K10 on the route of
    :func:`_box_plan`: the box route once, or the lines route once per
    pass, adding each launch to ``min_max_filter1d.launches`` and to its
    route's count in ``min_max_filter1d.routes``."""
    passes = tuple((int(a) % x.dim(), int(s), int(c), m)
                   for a, s, c, m in passes)
    if len({p[0] for p in passes}) != len(passes) or \
            min(p[1] for p in passes) < 2:
        raise ValueError(f"min_max_box takes distinct axes and sizes of 2 "
                         f"or more, got {passes}")
    if x.device.type == "cpu":
        return min_max_box_plain(x, passes, cval, minimum)
    _check(x, "min_max_filter1d")
    if x.numel() == 0:
        return torch.empty_like(x)
    kshape = [1] * x.dim()
    for axis, size, _, _ in passes:
        kshape[axis] = size
    plan = _box_plan(tuple(x.shape), tuple(kshape), x.dtype)
    out = _launch_box(x, passes, cval, minimum, plan)
    launches = 1 if plan.route == "box" else len(passes)
    min_max_filter1d.launches += launches
    min_max_filter1d.routes[plan.route] += launches
    return out


def min_max_filter1d(x: torch.Tensor, size: int, axis: int, mode: str, cval,
                     center: int, minimum: bool) -> torch.Tensor:
    """The min (``minimum``) or max of ``size`` samples of ``x`` along
    ``axis``, sample ``center`` on the output, filter mode ``mode``, ``cval``
    (in ``x``'s type, see :func:`raw_cval`) beyond the edge in constant mode.
    A CPU tensor takes :func:`min_max_filter1d_plain`; a CUDA tensor
    launches K10 (:func:`min_max_box` with one pass; a size of 1 on the
    lines route) and adds one to ``min_max_filter1d.launches`` and to its
    route's count in ``min_max_filter1d.routes``."""
    axis = axis % x.dim()
    if x.device.type == "cpu":
        return min_max_filter1d_plain(x, size, axis, mode, cval, center,
                                      minimum)
    _check(x, "min_max_filter1d")
    if int(size) > 1:
        return min_max_box(x, [(axis, size, center, mode)], cval, minimum)
    out = _launch_lines(x, size, axis, mode, cval, center, minimum)
    min_max_filter1d.launches += 1
    min_max_filter1d.routes["lines"] += 1
    return out


min_max_filter1d.launches = 0
min_max_filter1d.routes = {"box": 0, "lines": 0}


def _work_dtype(dtype: torch.dtype, nonflat: bool) -> torch.dtype:
    """K11's work type: ``dtype``, or float64 for a non-flat structure on
    integers and bool."""
    return dtype if not nonflat or dtype.is_floating_point else torch.float64


@functools.lru_cache(maxsize=64)
def _structure_values(skey, fkey, fshape, work, device):
    """A non-flat structure's values at the footprint's taps (raster
    order) in the ``work`` dtype on ``device``, uploaded once per
    structure, footprint, work type and device."""
    s = np.frombuffer(skey, dtype=np.float64).reshape(fshape)
    fp = np.frombuffer(fkey, dtype=bool).reshape(fshape)
    return torch.as_tensor(np.ascontiguousarray(s[fp])).to(device=device,
                                                           dtype=work)


def _launch_min_max(x: torch.Tensor, footprint, structure, centers,
                    mode: str, cval, minimum: bool,
                    plan: RankPlan) -> torch.Tensor:
    """K11 on a CUDA tensor on the route ``plan`` names. Counts nothing
    (the public wrapper counts)."""
    _check(x, "min_max_filter")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fp = np.ascontiguousarray(footprint, dtype=bool)
    nonflat = structure is not None
    work = _work_dtype(x.dtype, nonflat)
    sval = None
    if nonflat:
        sval = _structure_values(
            np.ascontiguousarray(structure, dtype=np.float64).tobytes(),
            fp.tobytes(), fp.shape, work, x.device)
    sptr = None if sval is None else sval.data_ptr()
    lib = _lib()
    if plan.route == "tile":
        toff, host = _tile_tables(
            fp.tobytes(), fp.shape, tuple(int(c) for c in centers),
            tuple(int(n) for n in x.shape), plan, x.device)
        err = lib.ed_min_max_tile(
            _DTYPE_CODES[x.dtype], int(minimum), int(nonflat), plan.column,
            x.data_ptr(), out.data_ptr(), toff.data_ptr(), sptr, *host,
            _MODE_CODES[mode], _bits(cval, work), plan.smem, plan.blocks,
            _stream(x))
    else:
        geo = _geometry(x, fp, centers, "min_max_filter")
        err = lib.ed_min_max_filter(
            _DTYPE_CODES[x.dtype], int(minimum), int(nonflat), x.data_ptr(),
            out.data_ptr(), geo.off.data_ptr(), geo.delta.data_ptr(), sptr,
            *geo.args, _MODE_CODES[mode], _bits(cval, work), _stream(x))
    _build.check(err, lib, "ed_morphology_error_string", "min_max_filter")
    return out


def min_max_filter(x: torch.Tensor, footprint, structure, centers, mode: str,
                   cval, minimum: bool) -> torch.Tensor:
    """The min or max over the taps of ``footprint`` (bool numpy, ``x``'s
    rank, tap ``centers[d]`` on the output), with a non-flat ``structure``
    (float64 numpy of the footprint's shape, or None for flat) applied in
    the work type: ``x``'s for floats, float64 otherwise, which ``cval`` is
    in. A CPU tensor takes :func:`min_max_filter_plain`; a CUDA tensor
    launches K11 on the route of :func:`_min_max_plan` and adds one to
    ``min_max_filter.launches`` and to its route's count in
    ``min_max_filter.routes``."""
    if x.device.type == "cpu":
        return min_max_filter_plain(x, footprint, structure, centers, mode,
                                    cval, minimum)
    _check(x, "min_max_filter")
    if x.numel() == 0:
        return torch.empty_like(x)
    if not 1 <= x.dim() <= MAX_ND_AXES:
        raise ValueError(f"min_max_filter: the CUDA kernel takes 1 to "
                         f"{MAX_ND_AXES} axes, got {x.dim()}")
    fp = np.asarray(footprint, dtype=bool)
    nonflat = structure is not None
    plan = _min_max_plan(tuple(x.shape), fp.shape,
                         _work_dtype(x.dtype, nonflat), int(fp.sum()),
                         nonflat)
    out = _launch_min_max(x, fp, structure, centers, mode, cval, minimum,
                          plan)
    min_max_filter.launches += 1
    min_max_filter.routes[plan.route] += 1
    return out


min_max_filter.launches = 0
min_max_filter.routes = {"tile": 0, "nd": 0}


def _launch_rank(x: torch.Tensor, footprint, centers, mode: str, cval,
                 rank: int, plan: RankPlan) -> torch.Tensor:
    """K12 on a CUDA tensor on the route ``plan`` names. Counts nothing
    (the public wrapper counts)."""
    _check(x, "rank_filter")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib()
    if plan.route in ("tile", "network_tile"):
        fp = np.ascontiguousarray(footprint, dtype=bool)
        toff, host = _tile_tables(
            fp.tobytes(), fp.shape, tuple(int(c) for c in centers),
            tuple(int(n) for n in x.shape), plan, x.device)
        if plan.route == "tile":
            err = lib.ed_rank_select_tile(
                _DTYPE_CODES[x.dtype], plan.column, x.data_ptr(),
                out.data_ptr(), toff.data_ptr(), *host, int(rank),
                _MODE_CODES[mode], _bits(cval, x.dtype), plan.smem,
                plan.blocks, _stream(x))
        else:
            taps = host[-1]
            wires, _ = _rank_network(taps, int(rank))
            err = lib.ed_rank_network_tile(
                _DTYPE_CODES[x.dtype], wires, plan.column, x.data_ptr(),
                out.data_ptr(), toff.data_ptr(), *host, int(rank),
                _MODE_CODES[mode], _bits(cval, x.dtype),
                _bits(_pad_max_value(x.dtype), x.dtype), plan.smem,
                plan.blocks, _stream(x))
    else:
        geo = _geometry(x, footprint, centers, "rank_filter")
        pairs, npairs, wires = None, 0, 0
        if plan.route == "network":
            wires, npairs, pairs = _network_pairs(geo.taps, int(rank),
                                                  x.device)
        err = lib.ed_rank_filter(
            _DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(),
            geo.off.data_ptr(), geo.delta.data_ptr(),
            None if npairs == 0 else pairs.data_ptr(), npairs, wires,
            int(rank), *geo.args, _MODE_CODES[mode], _bits(cval, x.dtype),
            _bits(_pad_max_value(x.dtype), x.dtype), _stream(x))
    _build.check(err, lib, "ed_morphology_error_string", "rank_filter")
    return out


def rank_filter(x: torch.Tensor, footprint, centers, mode: str, cval,
                rank: int) -> torch.Tensor:
    """The ``rank``-th smallest of the taps of ``footprint`` (as
    :func:`min_max_filter`; ``cval`` in ``x``'s type). A CPU tensor takes
    :func:`rank_filter_plain`; a CUDA tensor launches K12 on the route of
    :func:`_rank_plan` (the network route up to
    :data:`RANK_NETWORK_MAX_TAPS` taps, the tile or nd select route above)
    and adds one to ``rank_filter.launches`` and to its route's count in
    ``rank_filter.routes``."""
    if x.device.type == "cpu":
        return rank_filter_plain(x, footprint, centers, mode, cval, rank)
    _check(x, "rank_filter")
    if x.numel() == 0:
        return torch.empty_like(x)
    fp = np.asarray(footprint, dtype=bool)
    if not 1 <= x.dim() <= MAX_ND_AXES:
        raise ValueError(f"rank_filter: the CUDA kernel takes 1 to "
                         f"{MAX_ND_AXES} axes, got {x.dim()}")
    plan = _rank_plan(tuple(x.shape), fp.shape, x.dtype, int(fp.sum()))
    out = _launch_rank(x, fp, centers, mode, cval, rank, plan)
    rank_filter.launches += 1
    rank_filter.routes[plan.route] += 1
    return out


rank_filter.launches = 0
rank_filter.routes = {"network_tile": 0, "network": 0, "tile": 0, "nd": 0}


def _launch_tile(src: torch.Tensor, out: torch.Tensor, mask, sten, plan,
                 k: int, border: bool, dilation: bool, changed) -> None:
    """One launch of K13's tile route, ``k`` sweeps (``k <= plan.k``):
    bool bytes in and out where ``src`` is bool, else packed words."""
    nz, ny, nx = sten.shape3
    rz, ry, rx = sten.reach
    lib = _lib()
    err = lib.ed_binary_tile(
        src.data_ptr(), out.data_ptr(),
        None if mask is None else mask.data_ptr(),
        sten.taps_on(src.device).data_ptr() if sten.ntaps else None,
        None if changed is None else changed.data_ptr(),
        int(src.dtype == torch.bool), nz, ny, nx, *plan.tile, rz, ry, rx,
        int(k), sten.rows, sten.ntaps, int(bool(border)),
        int(bool(dilation)), _stream(src))
    _build.check(err, lib, "ed_morphology_error_string", "binary_step")


def _count_sweeps(route: str, k: int) -> None:
    binary_step.launches += 1
    binary_step.sweeps += k
    binary_step.routes[route] += 1


def binary_step(x: torch.Tensor, structure, centers, border: bool,
                dilation: bool, mask=None, changed=None, stencil=None,
                route=None) -> torch.Tensor:
    """One binary erosion or dilation sweep of the bool tensor ``x`` over
    the taps of ``structure`` (bool numpy, ``x``'s rank, centre
    ``centers``), ``border`` beyond the edge; ``mask`` (bool, ``x``'s shape)
    gates which voxels may change; ``changed`` (int32, one element) is set
    to 1 where one did. ``stencil``: the structure's :class:`_Stencil` on
    ``x``'s shape, built once for many sweeps, or None to build it;
    ``route`` forces ``"tile"`` or ``"nd"``. A CPU tensor takes
    :func:`binary_step_plain`; a CUDA tensor launches K13 on the route
    :func:`_binary_plan` picks for one sweep on bool bytes (the tile route
    packs them in shared memory) and adds one to ``binary_step.launches``,
    ``binary_step.sweeps`` and ``binary_step.routes[route]``."""
    if x.device.type == "cpu":
        return binary_step_plain(x, structure, centers, border, dilation,
                                 mask, changed)
    _check(x, "binary_step")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    sten = stencil or _Stencil(x.shape, structure, centers)
    plan = sten.plan(1, True, route)
    if plan.route == "tile":
        _launch_tile(x, out, mask, sten, plan, 1, border, dilation, changed)
    else:
        geo = sten.geometry(x)
        lib = _lib()
        err = lib.ed_binary_step(
            x.data_ptr(), out.data_ptr(),
            None if mask is None else mask.data_ptr(), geo.off.data_ptr(),
            geo.delta.data_ptr(),
            None if changed is None else changed.data_ptr(), *geo.args,
            int(bool(border)), int(bool(dilation)), _stream(x))
        _build.check(err, lib, "ed_morphology_error_string", "binary_step")
    _count_sweeps(plan.route, 1)
    return out


binary_step.launches = 0
binary_step.sweeps = 0
binary_step.routes = {"tile": 0, "nd": 0}


def binary_sweeps(state: torch.Tensor, structure, centers, border: bool,
                  dilation: bool, mask=None, k: int = 1, changed=None,
                  stencil=None, plan=None) -> torch.Tensor:
    """``k`` sweeps in one launch of K13's tile route. ``state``: the
    packed int32 words of :func:`pack_bits` (``mask`` too, packed with
    zero pad bits), or the bool array itself (``mask`` bool); ``stencil``
    (required for packed words) the structure's :class:`_Stencil` on the
    bool array's shape; ``plan`` a tile plan whose ``k`` is at least ``k``
    (by default :func:`_binary_plan`'s for ``k``). ``changed`` is set where
    the last sweep changed a voxel. A CPU tensor takes
    :func:`binary_sweeps_plain` (on packed words: unpacked, swept and packed
    again); a CUDA tensor launches the kernel and adds one to
    ``binary_step.launches`` and ``binary_step.routes["tile"]`` and ``k``
    to ``binary_step.sweeps``."""
    packed = state.dtype != torch.bool
    if stencil is None:
        if packed:
            raise ValueError("binary_sweeps: packed words need the stencil")
        stencil = _Stencil(state.shape, structure, centers)
    if state.device.type == "cpu":
        n = stencil.shape[-1]
        x = unpack_bits_plain(state, n) if packed else state
        m = unpack_bits_plain(mask, n) if packed and mask is not None \
            else mask
        y = binary_sweeps_plain(x, structure, centers, border, dilation, m,
                                k, changed)
        return pack_bits_plain(y, border) if packed else y
    _check(state, "binary_sweeps")
    plan = plan or stencil.plan(k, not packed, "tile")
    if plan.route != "tile" or not 1 <= k <= plan.k:
        raise ValueError(f"binary_sweeps: a tile plan of at least {k} "
                         f"sweeps is needed, got {plan}")
    out = torch.empty_like(state)
    _launch_tile(state, out, mask, stencil, plan, k, border, dilation,
                 changed)
    _count_sweeps("tile", k)
    return out


def pack_bits(x: torch.Tensor, border: bool) -> torch.Tensor:
    """The contiguous bool ``x`` packed along its last axis, 32 voxels to
    an int32 word (bit ``j`` of word ``w`` is voxel ``32 w + j``), the pad
    bits past the axis's end set to ``border``. A CPU tensor takes
    :func:`pack_bits_plain`; a CUDA tensor launches K13's pack kernel and
    adds one to ``pack_bits.launches``."""
    if x.device.type == "cpu":
        return pack_bits_plain(x, border)
    _check(x, "pack_bits")
    n = x.shape[-1]
    words = torch.empty(x.shape[:-1] + (-(-n // 32),), dtype=torch.int32,
                        device=x.device)
    lib = _lib()
    err = lib.ed_binary_pack(x.data_ptr(), words.data_ptr(), x.numel() // n,
                             n, int(bool(border)), 1, _stream(x))
    _build.check(err, lib, "ed_morphology_error_string", "pack_bits")
    pack_bits.launches += 1
    return words


pack_bits.launches = 0


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """The bool voxels of the packed ``words``, the last axis ``n`` long.
    A CPU tensor takes :func:`unpack_bits_plain`; a CUDA tensor launches
    K13's unpack kernel and adds one to ``unpack_bits.launches``."""
    if words.device.type == "cpu":
        return unpack_bits_plain(words, n)
    _check(words, "unpack_bits")
    out = torch.empty(words.shape[:-1] + (n,), dtype=torch.bool,
                      device=words.device)
    lib = _lib()
    err = lib.ed_binary_pack(out.data_ptr(), words.data_ptr(),
                             words.numel() // words.shape[-1], n, 0, 0,
                             _stream(words))
    _build.check(err, lib, "ed_morphology_error_string", "unpack_bits")
    unpack_bits.launches += 1
    return out


unpack_bits.launches = 0


# ---------------------------------------------------------------------------
# the JAX package's functions on tensors


def _full_origins(origin, axes, ndim):
    full = [0] * ndim
    for ax, o in zip(axes, normalize_sequence(origin, len(axes), "origin")):
        full[ax] = int(o)
    return full


def _pads(footprint_shape, centers):
    return [(c, k - 1 - c) for c, k in zip(centers, footprint_shape)]


def _box_pass(x: torch.Tensor, size, axis: int, mode, cval, origin):
    """A pass of K10, ``(axis, size, centre, mode)``, and its ``cval`` in
    ``x``'s type (:func:`_pad_value`), checked as SciPy checks them."""
    size = int(size)
    if size < 1:
        raise RuntimeError("incorrect filter size")
    mode = check_mode(mode)
    c = size // 2 + int(origin)
    if not 0 <= c < size:
        raise ValueError("invalid origin")
    return ((axis % x.dim(), size, c, mode),
            _pad_value(cval, x.dtype, mode, [(c, size - 1 - c)]))


def apply_min_max_filter1d(x: torch.Tensor, size, axis: int, mode, cval,
                           origin, minimum: bool) -> torch.Tensor:
    """SciPy ``minimum_filter1d`` / ``maximum_filter1d`` (K10)."""
    (axis, size, c, mode), cv = _box_pass(x, size, axis, mode, cval, origin)
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
        passes, cv = [], 0
        for ax, s, o, md in zip(axes, sizes, origins, modes):
            if int(s) > 1:
                p, v = _box_pass(x, s, ax, md, cval, o)
                passes.append(p)
                # every constant axis converts cval alike; no other reads it
                cv = v if p[3] == "constant" else cv
        if not passes:
            return x
        return min_max_box(x.contiguous(), passes, cv, minimum)
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
                            border_value, origin, dilation: bool,
                            route=None) -> torch.Tensor:
    """``binary_erosion`` / ``binary_dilation``: K13 sweeps, ``iterations``
    of them, or to the fixpoint for ``iterations <= 0`` (the flag of every
    :data:`SWEEPS_PER_CHECK`-th sweep read), each gated by ``mask``. On the
    tile route the sweeps run up to the plan's ``k`` a launch on the packed
    state (:func:`pack_bits` once, :func:`binary_sweeps`, :func:`unpack_bits`
    once); on the nd route one :func:`binary_step` a sweep. ``route``
    forces one. Every device runs the same schedule (a CPU tensor through
    the plain versions)."""
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
    iterations = int(iterations)
    if x.numel() == 0:
        return x.clone()
    sten = _Stencil(x.shape, structure, centers)
    want = SWEEPS_PER_CHECK if iterations < 1 else \
        min(iterations, SWEEPS_PER_CHECK)
    plan = sten.plan(want, False, route)
    if plan.route == "tile":
        state = pack_bits(x, border)
        gate = None if mask is None else pack_bits(mask, False)

        def sweep(n, changed=None):
            nonlocal state
            while n > 0:
                k = min(n, plan.k)
                state = binary_sweeps(state, structure, centers, border,
                                      dilation, gate, k,
                                      changed if k == n else None, sten,
                                      plan)
                n -= k
    else:
        state = x

        def sweep(n, changed=None):
            nonlocal state
            for s in range(n):
                state = binary_step(state, structure, centers, border,
                                    dilation, mask,
                                    changed if s == n - 1 else None, sten,
                                    "nd")
    if iterations >= 1:
        sweep(iterations)
    else:
        sweep_to_fixpoint(lambda changed: sweep(SWEEPS_PER_CHECK, changed),
                          x.device)
    if plan.route == "tile":
        return unpack_bits(state, x.shape[-1])
    return state


# ---------------------------------------------------------------------------
# Jacobi relaxations to the fixpoint: the chamfer distance (K16,
# ops/distance.py) and the watershed (K17, here), both in csrc/distance.cu

# the reference's "unreached" cost, step count and distance
RELAX_BIG = int(np.iinfo(np.int32).max // 4)


class RelaxTaps:
    """A 3^ndim structure's neighbours on an array of ``shape``: ``offs``,
    the offsets in the raster order of ``np.nonzero`` with the centre
    dropped (the order the plain twins and the JAX package visit them in),
    and :meth:`on`, the kernels' int32 ``(taps, 2)`` table of a linear
    offset and an edge word (bit ``k`` the tap steps down along axis ``k``,
    bit ``8 + k`` up), uploaded once per device."""

    def __init__(self, structure, shape):
        self.shape = tuple(int(n) for n in shape)
        self.offs = [tuple(int(t) - 1 for t in off)
                     for off in zip(*np.nonzero(structure))]
        self.offs = [o for o in self.offs if o != (0,) * len(self.shape)]
        strides = np.cumprod([1] + list(self.shape[::-1]))[:-1][::-1]
        self.table = np.asarray(
            [[int(np.dot(o, strides)),
              sum((1 << k) * (t < 0) + (1 << (8 + k)) * (t > 0)
                  for k, t in enumerate(o))] for o in self.offs],
            dtype=np.int32).reshape(-1, 2)
        self._dev = {}

    def on(self, device) -> torch.Tensor:
        t = self._dev.get(device)
        if t is None:
            t = self._dev[device] = torch.as_tensor(self.table).to(device)
        return t

    def c_args(self, device):
        """The table's pointer, its tap count, the rank and the extents as
        the C entry points take them."""
        ndim = len(self.shape)
        return (self.on(device).data_ptr(), len(self.offs), ndim,
                (ctypes.c_longlong * ndim)(*self.shape))


@functools.lru_cache(maxsize=32)
def _relax_taps(key, fshape, shape):
    return RelaxTaps(np.frombuffer(key, dtype=bool).reshape(fshape), shape)


def relax_taps(structure, shape) -> RelaxTaps:
    """The :class:`RelaxTaps` of ``structure`` (bool, 3^ndim) on ``shape``,
    built once per structure and shape."""
    st = np.ascontiguousarray(structure, dtype=bool)
    return _relax_taps(st.tobytes(), st.shape, tuple(int(n) for n in shape))


def sweep_to_fixpoint(group, device) -> None:
    """Run ``group(changed)``, :data:`SWEEPS_PER_CHECK` sweeps whose last
    sets the int32 flag ``changed`` where it changed a voxel, until a group
    changes nothing, the flag zeroed before each group and read once after
    it (K13's schedule, and K16's and K17's)."""
    changed = torch.zeros(1, dtype=torch.int32, device=device)
    while True:
        changed.zero_()
        group(changed)
        if not int(changed.item()):
            return


def relax_to_fixpoint(sweep, state, device):
    """Jacobi sweeps to the fixpoint by :func:`sweep_to_fixpoint`, each
    group of :data:`SWEEPS_PER_CHECK` one call ``state = sweep(state,
    changed, SWEEPS_PER_CHECK)``, which sets the flag by its last sweep
    (``ops/distance.py``'s sweepers launch the group from one host call):
    a sweep that changes nothing is a fixpoint, and sweeps past it change
    nothing, so the result is the reference's, which stops at the first
    such sweep. Returns the last state."""
    def group(changed):
        nonlocal state
        state = sweep(state, changed, SWEEPS_PER_CHECK)
    sweep_to_fixpoint(group, device)
    return state


def relax_check(x: torch.Tensor, what: str) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of fewer than 2^31
    elements (the kernels of csrc/distance.cu index with 32 bits)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the kernel takes a contiguous tensor")
    if x.numel() >= 2 ** 31 or not 1 <= x.dim() <= MAX_ND_AXES:
        raise ValueError(f"{what}: the CUDA kernel takes 1 to {MAX_ND_AXES} "
                         f"axes and fewer than 2^31 elements, got "
                         f"{tuple(x.shape)}")


def relax_pad(t: torch.Tensor, value) -> torch.Tensor:
    """``t`` padded by one voxel of ``value`` on every side, as the
    plain sweeps read their neighbours."""
    return F.pad(t, [1, 1] * t.dim(), value=value)


def tap_view(padded: torch.Tensor, off, shape) -> torch.Tensor:
    """The view of a :func:`relax_pad` array at neighbour offset ``off``."""
    return padded[tuple(slice(1 + o, 1 + o + n) for o, n in zip(off, shape))]


def nonzero_mask(x: torch.Tensor) -> torch.Tensor:
    """``x != 0`` for every dtype."""
    return _plain(x) != _plain_scalar(0, x.dtype)


def watershed_ift(x: torch.Tensor, markers: torch.Tensor, structure=None):
    """``watershed_ift`` (the JAX package's ``ops/morphology.py:522-597``):
    every voxel joins the marker of its lexicographically cheapest path
    (the path's greatest intensity, its length, the label), negative markers
    flooding too; K17 sweeps to the fixpoint (:func:`relax_to_fixpoint` of
    :func:`~elasticdeform_tpu_torch.ops.distance.watershed_sweeper`), the
    cross structure by default. ``x``: uint8 or uint16; the result has
    the markers' dtype, their values cast through int32 as ``astype``
    casts them."""
    # ops/distance.py imports this module
    from elasticdeform_tpu_torch.ops import distance
    if x.dtype not in (torch.uint8, torch.uint16):
        raise TypeError("only 8 and 16 unsigned inputs are supported")
    if tuple(markers.shape) != tuple(x.shape):
        raise RuntimeError("input and markers must have equal shapes")
    ndim = x.dim()
    if structure is None:
        structure = generate_binary_structure(ndim, 1)
    structure = np.asarray(structure, dtype=bool)
    if structure.shape != (3,) * ndim:
        raise RuntimeError("structure dimensions must be equal to 3")
    x = x.contiguous()
    if x.numel() == 0:
        return markers.clone()
    taps = relax_taps(structure, x.shape)
    seeded = nonzero_mask(markers)
    c = torch.where(seeded, x.to(torch.int32), RELAX_BIG).to(torch.int32)
    s = torch.where(seeded, 0, RELAX_BIG).to(torch.int32)
    lab = torch.where(seeded, _plain(markers).to(torch.int32), 0).to(
        torch.int32)
    _, _, lab = relax_to_fixpoint(
        distance.watershed_sweeper(x, taps),
        (c.contiguous(), s.contiguous(), lab.contiguous()), x.device)
    return _label_cast(lab, markers.dtype)


def _label_cast(lab: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int32 labels as ``astype(dtype)`` converts them (the unsigned types
    through int64)."""
    if dtype in (torch.uint16, torch.uint32):
        return lab.to(torch.int64).to(dtype)
    if dtype == torch.uint64:
        return lab.to(torch.int64).view(torch.uint64)
    return lab.to(dtype)
