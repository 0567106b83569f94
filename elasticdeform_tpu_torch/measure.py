"""Labeling and region measurements (``scipy.ndimage``'s measurements), the
counterparts of the JAX package's ``measure.py`` with the same arguments
plus ``device``.

:func:`label` and :func:`label_roots` run the connected components on the
card (kernel K18, :func:`~elasticdeform_tpu_torch.ops.measure.label_roots`:
a union-find whose roots are each component's least raveled index, the
JAX package's roots bit for bit) and number them 1..n there (a
``torch.cumsum`` of the root flags and K18's gather); the count is the one
host read. The statistics are one segment reduction each (K19,
:func:`~elasticdeform_tpu_torch.ops.measure.segment_reduce`), the
positions a second pass (K20). Their numeric results are tensors on the
device, 0-dim for a scalar index, in the JAX package's dtypes: float64
sums, means and variances, minima and maxima in the input's dtype (0 for a
region with no voxels, NaN where a region holds one). What the JAX package
assembles on the host has its types here too: positions and centres of
mass as tuples of Python ints and floats, histograms as an object array of
int64 counts (``None`` for a region with no voxels), slices.

The counts are exact: the JAX package counts in float32, exact below 2^24
voxels a region (note R1), and so :func:`mean` and :func:`variance` of a
larger region differ from it and agree with SciPy. :func:`median`,
:func:`labeled_comprehension` and :func:`value_indices` are finished on the
host in numpy as in the JAX package (their outputs are ragged), on a copy
of their inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from elasticdeform_tpu_torch.ops import measure as _ms
from elasticdeform_tpu_torch.ops.distance import _sqrt
from elasticdeform_tpu_torch.ops.morphology import nonzero_mask

__all__ = [
    "label", "label_roots", "find_objects", "sum_labels", "sum",
    "mean", "variance", "standard_deviation", "minimum", "maximum",
    "median", "minimum_position", "maximum_position", "extrema",
    "center_of_mass", "histogram", "labeled_comprehension",
    "value_indices",
]


def _input(X, device) -> torch.Tensor:
    """``X`` as a contiguous tensor on ``device`` (None: the card), out of
    any autograd graph (the measurements have no gradient)."""
    dev = torch.device("cuda" if device is None else device)
    if isinstance(X, torch.Tensor):
        return X.detach().to(dev).contiguous()
    a = np.asarray(X)
    return torch.as_tensor(a if a.flags.writeable else a.copy(),
                           device=dev).contiguous()


def _host(a):
    """An array-like (a tensor copied off its device) as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def label_roots(input, structure=None, *, device=None):
    """Each nonzero voxel's component (under ``structure``, symmetric,
    3^ndim; the cross by default) as its least raveled index, int32, and
    ``input.numel()`` for a zero voxel (NaN counts as nonzero)."""
    x = _input(input, device)
    offs = _ms.structure_offsets(structure, x.dim())
    return _ms.label_roots(nonzero_mask(x), offs)


def label(input, structure=None, *, device=None):
    """``scipy.ndimage.label``: ``(labels, n)``, the nonzero voxels'
    components numbered 1..n in raster order of their first voxel (SciPy's
    numbering), 0 elsewhere, an int32 tensor on the device, and ``n`` a
    Python int."""
    x = _input(input, device)
    offs = _ms.structure_offsets(structure, x.dim())
    roots, flags = _ms.label_roots(nonzero_mask(x), offs, flags=True)
    return _ms.label_numbers(roots, flags)


def _segments(input, labels, index, device):
    """``_norm_labels_index``: ``(x, labels, lut, K, expand, scalar)``, the
    labels and the table on ``x``'s device."""
    x = _input(input, device)
    if labels is None:
        return x, None, None, 1, None, True
    lab = _input(labels, x.device)
    if lab.shape != x.shape:
        raise ValueError("input and labels shapes are not equal")
    lut, K, expand, scalar = _ms.labels_index(lab, index, x.device)
    return x, lab, lut, K, expand, scalar


def _finish(arr, scalar, expand):
    if expand is not None:
        arr = arr[expand]          # unique slots -> requested entries
    return arr[0] if scalar else arr


def _reduce(input, labels, index, device, stats, hist=None):
    x, lab, lut, K, expand, scalar = _segments(input, labels, index, device)
    return x, _ms.segment_reduce(x, lab, lut, K, stats, hist), \
        (lab, lut, K, expand, scalar)


def sum_labels(input, labels=None, index=None, *, device=None):
    """``scipy.ndimage.sum_labels``: per-region float64 sums."""
    _, r, (_, _, _, expand, scalar) = _reduce(input, labels, index, device,
                                              ("sum",))
    return _finish(r["sum"], scalar, expand)


# scipy.ndimage.sum is the deprecated alias of sum_labels
sum = sum_labels


def mean(input, labels=None, index=None, *, device=None):
    """``scipy.ndimage.mean``: per-region float64 means."""
    _, r, (_, _, _, expand, scalar) = _reduce(input, labels, index, device,
                                              ("sum", "count"))
    return _finish(r["sum"] / r["count"].to(torch.float64), scalar, expand)


def variance(input, labels=None, index=None, *, device=None):
    """``scipy.ndimage.variance``: per-region (population) float64
    variance, ``s2 / c - (s / c)^2`` as the JAX package computes it."""
    _, r, (_, _, _, expand, scalar) = _reduce(input, labels, index, device,
                                              ("sum", "sum2", "count"))
    c = r["count"].to(torch.float64)
    m = r["sum"] / c
    return _finish(r["sum2"] / c - m * m, scalar, expand)


def standard_deviation(input, labels=None, index=None, *, device=None):
    """``scipy.ndimage.standard_deviation``: the square root of
    :func:`variance`, correctly rounded."""
    return _sqrt(variance(input, labels, index, device=device))


def _extremum(input, labels, index, device, stat):
    x, r, (_, _, _, expand, scalar) = _reduce(input, labels, index, device,
                                              ("count", stat))
    zero = int(_ms.order_keys(torch.zeros(1, dtype=x.dtype), 0)[0])
    keys = torch.where(r["count"] > 0, r[stat], zero)
    return _finish(_ms.key_values(keys, x.dtype), scalar, expand)


def minimum(input, labels=None, index=None, *, device=None):
    """``scipy.ndimage.minimum``: per-region minima in the input's dtype
    (NaN where a region holds one, -0.0 below +0.0); empty regions give
    0."""
    return _extremum(input, labels, index, device, "min")


def maximum(input, labels=None, index=None, *, device=None):
    """``scipy.ndimage.maximum``: per-region maxima, as :func:`minimum`."""
    return _extremum(input, labels, index, device, "max")


def _positions(input, labels, index, device, stat):
    """The raveled index of each region's first extremum (K19 for the
    extremum, K20 for its position), 0 for an empty region and the voxel
    count for a region whose extremum is NaN, as numpy int64 in the
    requested order; with the shape and the scalar flag."""
    x, r, (lab, lut, K, expand, scalar) = _reduce(input, labels, index,
                                                  device, ("count", stat))
    pos = _ms.segment_position(x, lab, lut, K, r[stat])
    pos = torch.where(r["count"] > 0, pos, 0)
    if expand is not None:
        pos = pos[expand]
    return _host(pos), tuple(x.shape), scalar


def _coords(pos, shape, scalar):
    coords = [tuple(int(c) for c in np.unravel_index(p, shape))
              for p in pos]
    return coords[0] if scalar else coords


def minimum_position(input, labels=None, index=None, *, device=None):
    """``scipy.ndimage.minimum_position``: the coordinates of each region's
    first minimum, a tuple of ints (a list of them for an index array); a
    region whose minimum is NaN raises ``ValueError`` as in the JAX
    package."""
    return _coords(*_positions(input, labels, index, device, "min"))


def maximum_position(input, labels=None, index=None, *, device=None):
    """``scipy.ndimage.maximum_position``, as :func:`minimum_position`."""
    return _coords(*_positions(input, labels, index, device, "max"))


def extrema(input, labels=None, index=None, *, device=None):
    """``scipy.ndimage.extrema``: (min, max, min_position,
    max_position)."""
    return (minimum(input, labels, index, device=device),
            maximum(input, labels, index, device=device),
            minimum_position(input, labels, index, device=device),
            maximum_position(input, labels, index, device=device))


def center_of_mass(input, labels=None, index=None, *, device=None):
    """``scipy.ndimage.center_of_mass``: each region's mass-weighted mean
    coordinate, a tuple of floats (a list of them for an index array)."""
    x, r, (_, _, K, expand, scalar) = _reduce(input, labels, index, device,
                                              ("sum", "csum"))
    coms = _host(r["csum"] / r["sum"][:, None])
    slots = range(K) if expand is None else _host(expand)
    out = [tuple(float(coms[i, ax]) for ax in range(x.dim()))
           for i in slots]
    return out[0] if scalar else out


def histogram(input, min, max, bins, labels=None, index=None, *,
              device=None):
    """``scipy.ndimage.histogram``: per-region int64 counts of ``bins``
    equal buckets over ``[min, max)`` (NaN dropped), numpy; ``None`` for a
    region with no voxels, an object array for an index array."""
    bins = int(bins)
    _, r, (_, _, _, expand, scalar) = _reduce(
        input, labels, index, device, ("count", "hist"), (bins, min, max))
    counts = _host(r["hist"])
    nvox = _host(r["count"])
    if expand is not None:
        counts = counts[_host(expand)]
        nvox = nvox[_host(expand)]
    if scalar:
        return counts[0] if nvox[0] > 0 else None
    out = np.empty(len(counts), dtype=object)
    for i in range(len(counts)):
        out[i] = counts[i] if nvox[i] > 0 else None
    return out


def _max_label(x: torch.Tensor) -> int:
    if not x.numel():
        return 0
    if x.dtype == torch.uint64:
        return int(x.cpu().numpy().max())
    if x.dtype in (torch.uint16, torch.uint32):
        x = x.to(torch.int64)
    return int(x.max())


def find_objects(input, max_label=0, *, device=None):
    """``scipy.ndimage.find_objects``: per label 1..max_label the bounding
    slices of its voxels (K19's coordinate bounds), ``None`` for a label
    with none."""
    labels = _input(input, device)
    if max_label <= 0:
        max_label = _max_label(labels)
    if max_label == 0:
        return []
    lut, K, _, _ = _ms.labels_index(labels, np.arange(1, max_label + 1),
                                    labels.device)
    r = _ms.segment_reduce(labels, labels, lut, K, ("count", "bounds"))
    counts = _host(r["count"])
    lo, hi = _host(r["bounds"])
    return [None if counts[i] == 0 else
            tuple(slice(int(lo[i, ax]), int(hi[i, ax]) + 1)
                  for ax in range(labels.dim()))
            for i in range(K)]


def median(input, labels=None, index=None):
    """``scipy.ndimage.median``: finished on the host in numpy (ragged
    per-region sorts), as the JAX package does."""
    input = _host(input)
    if labels is None:
        return float(np.median(input))
    labels = _host(labels)
    if index is None:
        return float(np.median(input[labels > 0]))
    scalar = np.isscalar(index)
    idx = np.atleast_1d(_host(index))
    out = np.array([np.median(input[labels == i])
                    if np.any(labels == i) else np.nan for i in idx])
    return float(out[0]) if scalar else out


def labeled_comprehension(input, labels, index, func, out_dtype, default,
                          pass_positions=False):
    """``scipy.ndimage.labeled_comprehension``: ``func`` applied per region
    on the host in numpy, as the JAX package does."""
    input = _host(input)
    scalar = index is None or np.isscalar(index)
    if labels is None:
        vals = [input.ravel()]
        poss = [np.arange(input.size)]
    else:
        labels = _host(labels)
        if index is None:
            sel = labels > 0
            vals = [input[sel]]
            poss = [np.nonzero(sel.ravel())[0]]
        else:
            idx = np.atleast_1d(_host(index))
            vals, poss = [], []
            for i in idx:
                sel = labels == i
                vals.append(input[sel])
                poss.append(np.nonzero(sel.ravel())[0])
    out = []
    for v, p in zip(vals, poss):
        if v.size == 0:
            out.append(default)
        elif pass_positions:
            out.append(func(v, p))
        else:
            out.append(func(v))
    out = np.asarray(out, dtype=out_dtype)
    return out[0] if scalar else out


def value_indices(arr, *, ignore_value=None):
    """``scipy.ndimage.value_indices``: each distinct integer value's tuple
    of index arrays, on the host in numpy."""
    arr = _host(arr)
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError("Parameter 'arr' must be an integer array")
    out = {}
    for v in np.unique(arr):
        if ignore_value is not None and v == ignore_value:
            continue
        out[v] = np.nonzero(arr == v)
    return out
