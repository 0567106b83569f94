"""The port's labeling and region measurements against the JAX package.

Both packages get the same numpy inputs, made from a seed; the port runs on
the CPU (its plain twins of K18-K20) and the JAX package under x64:

* ``label`` and ``label_roots``: roots, labels and counts exactly, on 1-D to
  4-D masks under every connectivity and random symmetric structures, a
  snake, empty and full masks, bool, integer and NaN-holding float inputs;
  every structure error in type and text;
* each statistic in the eleven dtypes (NaN and +-0 in the floats), with no
  labels, no index, a scalar index, and index arrays with duplicate and
  absent entries: counts, minima, maxima (by their bits), positions,
  slices and histograms exactly (``None`` for an empty region), float64
  sums to ``rtol=1e-12``, variance to ``1e-12 * s2/c`` per region, the
  errors in type and text;
* note R1: a region of 2^24 + 2^20 voxels, where the JAX package's float32
  count stops being exact, held to SciPy.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import elasticdeform_tpu as ed
from elasticdeform_tpu import measure as jm
import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch import measure as tm
from elasticdeform_tpu_torch.ops import measure as ms
from elasticdeform_tpu_torch.ops.morphology import generate_binary_structure

CPU = {"device": "cpu"}
# the statistics' shape (one, so that JAX compiles each operation once a
# dtype)
SHAPE = (3, 5, 6)

DTYPES = (np.bool_, np.uint8, np.int8, np.int16, np.uint16, np.int32,
          np.uint32, np.int64, np.uint64, np.float32, np.float64)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits_equal(got, want, what=""):
    """Equal in dtype, shape and value: floats by their bits (a zero's
    sign too), NaN where NaN."""
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind == "f":
        nan = np.isnan(got)
        np.testing.assert_array_equal(nan, np.isnan(want), err_msg=what)
        got, want = np.where(nan, 0, got), np.where(nan, 0, want)
        got = got.view(f"i{got.dtype.itemsize}")
        want = want.view(f"i{want.dtype.itemsize}")
    np.testing.assert_array_equal(got, want, err_msg=what)


def _structures(rs, nd):
    out = [generate_binary_structure(nd, c) for c in range(1, nd + 1)]
    r = rs.rand(*(3,) * nd) > 0.5
    out.append(r | r[(slice(None, None, -1),) * nd])
    return out


def _blobs(rs, shape):
    return ndi.gaussian_filter(rs.randn(*shape), 1.2) > 0.05


# ---------------------------------------------------------------------------
# label


# (shape, structure): connectivity 1..ndim, then ndim + 1 a random
# symmetric structure
@pytest.mark.parametrize("shape,which", [
    (shape, which) for shape in ((40,), (16, 18), (9, 10, 11), (5, 6, 4, 5))
    for which in range(len(shape) + 1)])
def test_label_matches_jax(shape, which):
    rs = np.random.RandomState(sum(shape) + which)
    st = _structures(rs, len(shape))[which]
    for x in (_blobs(rs, shape), rs.rand(*shape) < 0.55):
        wl, wn = ed.label(x, st)
        gl, gn = et.label(x, st, **CPU)
        assert gn == wn and isinstance(gn, int)
        _bits_equal(gl, wl)
        got = tm.label_roots(x, st, **CPU)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _roots_of(wl))


def _roots_of(labels):
    """The JAX package's roots from its labels: each labelled voxel's
    component's least raveled index (its first voxel), the voxel count
    elsewhere (``label_roots`` itself recompiles its loop at every call,
    so the tests call it where it matters: snakes, empty and full masks)."""
    flat = np.asarray(labels).ravel()
    first = np.zeros(flat.max() + 1 if flat.size else 1, dtype=np.int64)
    vals, idx = np.unique(flat, return_index=True)
    first[vals] = idx
    return np.where(flat > 0, first[flat], flat.size).reshape(
        np.shape(labels)).astype(np.int32)


def _snake(shape):
    m = np.zeros(shape, dtype=bool)
    rows = m.reshape(-1, shape[-1])
    rows[::2] = True
    for r in range(1, len(rows), 2):
        rows[r, -1 if (r // 2) % 2 == 0 else 0] = True
    return m


@pytest.mark.parametrize("shape", [(12, 12), (31, 17), (3, 9, 14)])
def test_label_snake(shape):
    # one serpentine component the length of the array
    x = _snake(shape)
    for st in (None, np.ones((3,) * len(shape))):
        gl, gn = et.label(x, st, **CPU)
        wl, wn = ed.label(x, st)
        assert gn == wn == 1
        _bits_equal(gl, wl)
        np.testing.assert_array_equal(tm.label_roots(x, st, **CPU).numpy(),
                                      np.asarray(jm.label_roots(x, st)))


@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.int16, np.uint32,
                                   np.float32, np.float64])
def test_label_input_dtypes(dtype):
    rs = np.random.RandomState(5)
    x = rs.randn(14, 15) * 3
    x[rs.rand(14, 15) < 0.4] = 0.0
    if np.dtype(dtype).kind == "f":
        # NaN is foreground, -0.0 background
        x[rs.rand(14, 15) < 0.1] = np.nan
        x[rs.rand(14, 15) < 0.1] = -0.0
    x = np.abs(x).astype(dtype) if np.dtype(dtype).kind == "u" else \
        x.astype(dtype)
    gl, gn = et.label(x, **CPU)
    wl, wn = ed.label(x)
    assert gn == wn
    _bits_equal(gl, wl)


@pytest.mark.parametrize("shape", [(7,), (5, 6), (3, 4, 5)])
def test_label_empty_and_full(shape):
    for x, n in ((np.zeros(shape, bool), 0), (np.ones(shape, bool), 1)):
        gl, gn = et.label(x, **CPU)
        wl, wn = ed.label(x)
        assert gn == wn == n
        _bits_equal(gl, wl)
        np.testing.assert_array_equal(tm.label_roots(x, **CPU).numpy(),
                                      np.asarray(jm.label_roots(x)))


@pytest.mark.parametrize("fn", ["label", "label_roots"])
def test_structure_errors(fn):
    s = np.zeros((3, 3), bool)
    s[1, 1] = s[0, 1] = True
    for x, st in ((np.ones((4, 4)), np.ones((3, 3, 3))),
                  (np.ones((4, 4)), np.ones((5, 5), bool)),
                  (np.ones((4, 4)), s)):
        with pytest.raises(Exception) as want:
            getattr(jm, fn)(x, st)
        with pytest.raises(type(want.value)) as got:
            getattr(tm, fn)(x, st, **CPU)
        assert str(got.value) == str(want.value)


def test_label_tensor_in_tensor_out():
    x = torch.as_tensor(_blobs(np.random.RandomState(3), (10, 12)))
    gl, gn = et.label(x, **CPU)
    assert gl.device.type == "cpu" and gl.dtype == torch.int32
    wl, wn = ed.label(x.numpy())
    assert gn == wn
    _bits_equal(gl, wl)


# ---------------------------------------------------------------------------
# statistics


def _values(rs, shape, dtype, nan=True):
    """Inputs in ``dtype``: floats with +0.0 and -0.0 (and NaN), integers
    over a few values each side of 0 with the type's least and greatest."""
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return rs.rand(*shape) > 0.5
    if dtype.kind == "f":
        v = rs.randn(*shape) * 3
        v[rs.rand(*shape) < 0.15] = 0.0
        v[rs.rand(*shape) < 0.15] = -0.0
        if nan:
            v[rs.rand(*shape) < 0.04] = np.nan
        return v.astype(dtype)
    info = np.iinfo(dtype)
    v = (rs.randint(-5, 6, shape) if info.min < 0
         else rs.randint(0, 8, shape)).astype(dtype)
    v.flat[0], v.flat[-1] = info.max, info.min
    return v


# (labels, index) forms: no labels; labels, no index; index arrays with an
# absent entry (7) and with duplicates; scalar indices
def _forms(rs, shape):
    lab = rs.randint(0, 6, shape).astype(np.int32)
    return [(None, None), (lab, None), (lab, [1, 2, 3, 4, 5, 7]),
            (lab, [2, 2, 0, 5, 2]), (lab, 3), (lab, np.int64(4))]


def _mean_sq(x, labels, index):
    """s2/c per requested region (SciPy's mean of the squares)."""
    f = np.asarray(x, dtype=np.float64)
    if labels is None:
        return np.mean(f * f)
    return np.asarray(ndi.mean(f * f, labels, index))


SUMS = ("sum_labels", "sum", "mean")


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("stat", SUMS + ("variance", "standard_deviation"))
def test_sums_match_jax(stat, dtype):
    rs = np.random.RandomState(11)
    x = _values(rs, SHAPE, dtype)
    for labels, index in _forms(rs, SHAPE):
        want = np.asarray(getattr(ed, stat)(x, labels, index))
        got = getattr(et, stat)(x, labels, index, **CPU)
        assert isinstance(got, torch.Tensor)
        got = got.numpy()
        assert got.dtype == want.dtype == np.float64
        assert got.shape == want.shape
        if stat in SUMS:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
            continue
        atol = 1e-12 * _mean_sq(x, labels, index)
        if stat == "standard_deviation":
            atol = np.sqrt(atol)
        ok = np.isnan(want) == np.isnan(got)
        assert ok.all()
        diff = np.abs(np.where(np.isnan(want), 0, got - want))
        assert (diff <= np.where(np.isnan(atol), 0, atol)).all(), \
            (stat, labels is None, index)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("stat", ["minimum", "maximum"])
def test_extrema_match_jax_bit_for_bit(stat, dtype):
    rs = np.random.RandomState(12)
    x = _values(rs, SHAPE, dtype)
    for labels, index in _forms(rs, SHAPE):
        want = getattr(ed, stat)(x, labels, index)
        got = getattr(et, stat)(x, labels, index, **CPU)
        _bits_equal(got, want, f"{stat} {index}")


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("stat", ["minimum_position", "maximum_position",
                                  "extrema"])
def test_positions_match_jax(stat, dtype):
    # no NaN: a region whose extremum is NaN raises (below)
    rs = np.random.RandomState(13)
    x = _values(rs, SHAPE, dtype, nan=False)
    for labels, index in _forms(rs, SHAPE):
        want = getattr(ed, stat)(x, labels, index)
        got = getattr(et, stat)(x, labels, index, **CPU)
        if stat == "extrema":
            for g, w in zip(got[:2], want[:2]):
                _bits_equal(g, w)
            got, want = got[2:], want[2:]
        assert got == want
        _assert_int_tuples(got)


def _assert_int_tuples(pos):
    """A position is a tuple of Python ints; lists and extrema's pairs hold
    positions."""
    if isinstance(pos, tuple) and all(isinstance(c, int) for c in pos):
        assert all(type(c) is int for c in pos)
        return
    assert isinstance(pos, (list, tuple))
    for p in pos:
        _assert_int_tuples(p)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_center_of_mass_matches_jax(dtype):
    rs = np.random.RandomState(14)
    x = _values(rs, SHAPE, dtype)
    for labels, index in _forms(rs, SHAPE):
        want = ed.center_of_mass(x, labels, index)
        got = et.center_of_mass(x, labels, index, **CPU)
        assert type(got) is type(want)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-12, atol=0)
        for c in (got if isinstance(got, list) else [got]):
            assert isinstance(c, tuple) and all(type(v) is float for v in c)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_histogram_matches_jax(dtype):
    rs = np.random.RandomState(15)
    x = _values(rs, SHAPE, dtype)
    for labels, index in _forms(rs, SHAPE):
        for lo, hi, bins in ((-4.0, 5.0, 7), (0, 3, 3), (-1.5, 1.5, 64)):
            want = ed.histogram(x, lo, hi, bins, labels, index)
            got = et.histogram(x, lo, hi, bins, labels, index, **CPU)
            if isinstance(want, np.ndarray) and want.dtype == object:
                assert got.dtype == object and len(got) == len(want)
                pairs = zip(got, want)
            else:
                pairs = [(got, want)]
            for g, w in pairs:
                assert (g is None) == (w is None)
                if w is not None:
                    _bits_equal(g, w)


def test_histogram_empty_region_is_none():
    x = np.array([1.0, 2.0, 50.0])
    lab = np.array([1, 1, 2])
    got = et.histogram(x, 0.0, 10.0, 5, lab, [1, 3, 2], **CPU)
    want = ed.histogram(x, 0.0, 10.0, 5, lab, [1, 3, 2])
    assert got[1] is None and want[1] is None
    _bits_equal(got[0], want[0])
    _bits_equal(got[2], want[2])        # zero, not None
    assert et.histogram(x, 0.0, 10.0, 5, lab, 3, **CPU) is None


@pytest.mark.parametrize("stat", ["minimum_position", "maximum_position"])
def test_position_of_nan_region_raises(stat):
    x = np.array([1.0, np.nan, 3.0, 2.0])
    lab = np.array([1, 1, 2, 2])
    with pytest.raises(ValueError) as want:
        getattr(ed, stat)(x, lab, [1, 2])
    with pytest.raises(ValueError) as got:
        getattr(et, stat)(x, lab, [1, 2], **CPU)
    assert str(got.value) == str(want.value)
    assert getattr(et, stat)(x, lab, 2, **CPU) == getattr(ed, stat)(x, lab, 2)


@pytest.mark.parametrize("stat", ["sum_labels", "mean", "minimum",
                                  "center_of_mass", "minimum_position"])
def test_errors_match_jax(stat):
    x = np.arange(6.0).reshape(2, 3)
    for labels, index in ((np.ones((3, 2), int), None),
                          (np.ones((2, 3), int), [1, -1])):
        with pytest.raises(ValueError) as want:
            getattr(ed, stat)(x, labels, index)
        with pytest.raises(ValueError) as got:
            getattr(et, stat)(x, labels, index, **CPU)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("ldtype", [np.float32, np.float64, np.bool_,
                                    np.uint8, np.int16, np.uint64])
def test_label_dtypes_match_jax(ldtype):
    # float labels truncate toward zero; bool labels are 0 and 1; uint64
    # labels past 2^63 wrap negative and are excluded
    rs = np.random.RandomState(16)
    x = rs.randn(6, 8)
    lab = rs.randint(0, 5, (6, 8)).astype(np.float64)
    if np.dtype(ldtype).kind == "f":
        lab = lab + rs.rand(6, 8) * 0.99 - 0.5
    lab = lab.astype(ldtype)
    if ldtype == np.uint64:
        lab[0, :3] = np.uint64(2 ** 63 + 2)
    for index in (None, [0, 1, 2, 3, 4, 9], 2):
        for stat in ("sum_labels", "maximum", "minimum_position"):
            want = getattr(ed, stat)(x, lab, index)
            got = getattr(et, stat)(x, lab, index, **CPU)
            if stat == "minimum_position":
                assert got == want
            elif stat == "maximum":
                _bits_equal(got, want)
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_scalar_and_tensor_results():
    x = torch.as_tensor(np.random.RandomState(17).randn(5, 6))
    lab = torch.as_tensor(np.random.RandomState(18).randint(0, 3, (5, 6)))
    s = et.sum_labels(x, lab, 1, **CPU)
    assert s.dim() == 0 and s.dtype == torch.float64
    m = et.minimum(x.to(torch.int16), lab, [1, 2], **CPU)
    assert m.shape == (2,) and m.dtype == torch.int16
    assert et.sum_labels(x, **CPU).dim() == 0
    np.testing.assert_allclose(float(et.sum(x, lab, **CPU)),
                               float(ed.sum(x.numpy(), lab.numpy())),
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# find_objects and the host-finished functions


@pytest.mark.parametrize("ldtype", [np.int32, np.uint8, np.int64,
                                    np.uint16])
def test_find_objects_matches_jax(ldtype):
    rs = np.random.RandomState(19)
    labels, n = ndi.label(_blobs(rs, (18, 17, 5)))
    labels = labels.astype(ldtype)
    for max_label in (0, n, n + 3, 2):
        want = ed.find_objects(labels, max_label=max_label)
        got = et.find_objects(labels, max_label=max_label, **CPU)
        assert got == want
    assert et.find_objects(np.zeros((3, 4), ldtype), **CPU) == []


def test_host_finished_match_jax():
    rs = np.random.RandomState(20)
    x = rs.randn(15, 16)
    labels, n = ndi.label(_blobs(rs, (15, 16)))
    index = np.arange(1, n + 2)
    np.testing.assert_array_equal(et.median(x, labels, index),
                                  ed.median(x, labels, index))
    assert et.median(x, labels) == ed.median(x, labels)
    assert et.median(torch.as_tensor(x)) == ed.median(x)
    fn = lambda v, p: float(np.sum(v * p))  # noqa: E731
    np.testing.assert_array_equal(
        et.labeled_comprehension(x, labels, index, fn, float, 0.0, True),
        ed.labeled_comprehension(x, labels, index, fn, float, 0.0, True))
    np.testing.assert_array_equal(
        et.labeled_comprehension(x, labels, None, np.mean, float, -1.0),
        ed.labeled_comprehension(x, labels, None, np.mean, float, -1.0))
    got = et.value_indices(torch.as_tensor(labels), ignore_value=0)
    want = ed.value_indices(labels, ignore_value=0)
    assert set(got) == set(want)
    for k in want:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="must be an integer array"):
        et.value_indices(x)


# ---------------------------------------------------------------------------
# note R1: exact counts


def test_counts_exact_past_2_24():
    # One region of 2^24 + 2^20 uint8 voxels. The JAX package counts in
    # float32, whose running sum of ones stops at 2^24, so its mean and
    # variance of such a region are off; the port counts in int64 and is
    # held to SciPy here instead.
    n = 2 ** 24 + 2 ** 20
    x = np.random.RandomState(21).randint(0, 256, n).astype(np.uint8)
    count = ms.segment_reduce(torch.as_tensor(x), None, None, 1,
                              ("count",))["count"]
    assert int(count[0]) == n
    m = et.mean(x, **CPU)
    np.testing.assert_allclose(float(m), ndi.mean(x), rtol=1e-12)
    v = float(et.variance(x, **CPU))
    s2c = float(np.mean(x.astype(np.float64) ** 2))
    assert abs(v - ndi.variance(x)) <= 1e-12 * s2c
    # the float32 count of the JAX package is short by 2^20
    assert np.float32(2 ** 24) + np.float32(1) == np.float32(2 ** 24)


# ---------------------------------------------------------------------------
# the kernels' helpers


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_order_keys_sort_and_round_trip(dtype):
    rs = np.random.RandomState(22)
    x = torch.as_tensor(_values(rs, (200,), dtype, nan=False))
    keys = ms.order_keys(x, 0)
    back = ms.key_values(keys, x.dtype)
    _bits_equal(back, x.numpy())
    # the keys sort as numpy sorts the values, -0.0 before +0.0
    order = np.argsort(keys.numpy(), kind="stable")
    srt = x.numpy()[order]
    assert (np.diff(srt.astype(np.float64)) >= 0).all()
    if x.dtype.is_floating_point:
        zeros = srt[srt == 0]
        sign = np.signbit(zeros)
        assert (np.diff(sign.astype(int)) <= 0).all()
        nan = torch.tensor([float("nan")], dtype=x.dtype)
        assert int(ms.order_keys(nan, -1 << 63)) == -1 << 63
        assert int(ms.order_keys(nan, (1 << 63) - 1)) == (1 << 63) - 1


@pytest.mark.parametrize("shape", [(5,), (4, 6), (3, 4, 5), (2, 3, 2, 3)])
def test_half_taps(shape):
    # every neighbour pair once: the offsets of lower raveled index, with
    # their linear offsets and edge words
    for st in _structures(np.random.RandomState(23), len(shape)):
        offs = ms.structure_offsets(st, len(shape))
        taps = ms.half_taps(offs, shape)
        assert 2 * len(taps) == len(offs)
        strides = np.cumprod((1,) + shape[::-1])[:-1][::-1]
        rows = {(int(np.dot(o, strides)),
                 sum((1 << k) * (t < 0) + (1 << (8 + k)) * (t > 0)
                     for k, t in enumerate(o))) for o in offs}
        assert all(lin < 0 and (lin, word) in rows for lin, word in taps)


def test_segment_plan():
    stats = ("count", "hist")
    assert ms.segment_smem(422, stats, 3, 64) == 422 * (4 + 4 * 64)
    assert ms.segment_plan(422, stats, 3, 64) == "shared"
    assert ms.segment_plan(325_000, ("sum",), 3) == "device"
    assert ms.segment_plan(10, ("sum",), 3, route="device") == "device"
    with pytest.raises(ValueError):
        ms.segment_plan(10 ** 6, ("sum",), 3, route="shared")


def test_wrappers_count_no_launch_on_the_cpu():
    before = (ms.label_roots.launches, ms.label_numbers.launches,
              ms.segment_reduce.launches, ms.segment_position.launches)
    x = np.random.RandomState(24).randn(6, 7)
    lab, _ = et.label(x > 0, **CPU)
    et.minimum_position(x, lab, [1, 2], **CPU)
    et.histogram(x, -1, 1, 4, lab, 1, **CPU)
    assert (ms.label_roots.launches, ms.label_numbers.launches,
            ms.segment_reduce.launches, ms.segment_position.launches) == \
        before
