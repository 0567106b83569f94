"""The port's morphology tier against the JAX package on the CPU.

The same numpy inputs (made from a seed) go through ``elasticdeform_tpu``
(CPU, x64, as ``conftest.py`` sets) and the port with ``device="cpu"``, where
kernels K10-K13 take their plain versions. Every comparison is exact: the
same dtype and shape, and every value equal (NaN where NaN). The tier only
selects values, or adds one structure value per tap in the work type, in
the JAX package's order.

Tests marked ``cuda`` hold the four kernels against their plain versions and
run only where a card is.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import elasticdeform_tpu as ej

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch.ops import morphology as tm

MODES = ["reflect", "constant", "nearest", "mirror", "wrap"]
INT_DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32,
              np.uint64, np.int64]
ALL_DTYPES = [np.bool_] + INT_DTYPES + [np.float32, np.float64]


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _equal(got, want):
    """The same dtype, shape and bits: floats by their bits (a zero's sign
    too), NaN where NaN (a NaN's payload is not compared)."""
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, want.dtype, got.shape, want.shape)
    if got.dtype.kind == "f":
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        bits = np.dtype(f"i{got.dtype.itemsize}")
        got = np.where(nan, 0, got).view(bits)
        want = np.where(nan, 0, want).view(bits)
    np.testing.assert_array_equal(got, want)


def _both(name, x, *args, **kw):
    """``(port, JAX)`` results of the function ``name`` on the same
    inputs."""
    return (getattr(et, name)(x, *args, device="cpu", **kw),
            getattr(ej, name)(x, *args, **kw))


def _raise_both(exc, match, name, x, *args, **kw):
    with pytest.raises(exc, match=match):
        getattr(et, name)(x, *args, device="cpu", **kw)
    with pytest.raises(exc, match=match):
        getattr(ej, name)(x, *args, **kw)


def _data(dtype, shape, seed=0, nan=True):
    """Seeded values of ``dtype``: the whole integer range with the extremes
    and repeats (ties), floats with NaN and infinities."""
    rs = np.random.RandomState(seed)
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return rs.rand(*shape) > 0.5
    if dtype.kind == "f":
        a = (rs.standard_normal(shape) * 10).astype(dtype)
        if nan:
            a.reshape(-1)[rs.choice(a.size, 3, replace=False)] = np.nan
            a.reshape(-1)[rs.choice(a.size, 2, replace=False)] = np.inf
        return a
    info = np.iinfo(dtype)
    a = rs.randint(info.min, info.max, size=shape, dtype=dtype)
    a.reshape(-1)[:2] = (info.min, info.max)
    a.reshape(-1)[5:9] = a.reshape(-1)[10]
    return a


def _blob(seed, shape, thresh=0.0):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal(shape)
    for ax in range(len(shape)):
        x = (x + np.roll(x, 1, ax) + np.roll(x, -1, ax)) / 3
    return x > thresh


# ---------------------------------------------------------------------------
# minimum / maximum filters (K10, K11)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("size", [1, 2, 3, 5, 12])
@pytest.mark.parametrize("name", ["minimum_filter1d", "maximum_filter1d"])
def test_min_max_filter1d(name, size, mode):
    """Every origin that keeps the centre on the window; 12 samples on an
    axis of 9 fold more than once."""
    x = _data(np.float64, (9, 11), seed=size)
    for origin in range(-(size // 2), size - size // 2):
        for axis in (0, -1):
            _equal(*_both(name, x, size, axis, mode=mode, cval=-1.25,
                          origin=origin))


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=lambda d: np.dtype(d).name)
def test_min_max_filter1d_dtypes(dtype):
    """Every dtype keeps its type; a fractional cval truncates into an
    integer pad (1.7 -> 1) and is ``!= 0`` for bool."""
    x = _data(dtype, (7, 10), seed=3)
    for name in ("minimum_filter1d", "maximum_filter1d"):
        for mode in ("constant", "mirror"):
            _equal(*_both(name, x, 4, 1, mode=mode, cval=1.7, origin=-1))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["minimum_filter", "maximum_filter"])
def test_min_max_filter_box_and_footprint(name, mode):
    """A box (separable, one K10 pass per axis), an all-true footprint (the
    same), and a sparse footprint (K11) with origins."""
    x = _data(np.float32, (10, 12, 7), seed=4)
    _equal(*_both(name, x, size=(2, 3, 1), mode=mode, cval=0.5))
    _equal(*_both(name, x, footprint=np.ones((3, 2, 2)), mode=mode,
                  origin=(1, 0, -1)))
    fp = np.random.RandomState(5).rand(3, 4, 2) > 0.4
    _equal(*_both(name, x, footprint=fp, mode=mode, cval=-2.0,
                  origin=(-1, 1, 0)))


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=lambda d: np.dtype(d).name)
def test_min_max_filter_footprint_dtypes(dtype):
    x = _data(dtype, (9, 11), seed=6)
    fp = np.array([[1, 0, 1], [0, 1, 1]], bool)
    for name in ("minimum_filter", "maximum_filter"):
        _equal(*_both(name, x, footprint=fp, mode="constant", cval=3.9))
        _equal(*_both(name, x, footprint=fp, mode="wrap"))


def test_min_max_filter_axes_and_per_axis_modes():
    x = _data(np.int16, (5, 8, 9), seed=7)
    _equal(*_both("minimum_filter", x, size=3, axes=(1, 2)))
    _equal(*_both("maximum_filter", x, footprint=np.eye(3, dtype=bool),
                  axes=(0, 2), origin=(1, 0)))
    _equal(*_both("maximum_filter", x, size=(3, 2, 4),
                  mode=["wrap", "constant", "nearest"], cval=-7))
    _equal(*_both("minimum_filter", x, size=3, mode="grid-wrap",
                  output=np.float32))


@pytest.mark.parametrize("dtype", [np.bool_] + INT_DTYPES
                         + [np.float32, np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_grey_nonflat_saturating_cast(dtype):
    """Integers (and bool) with a non-flat structure compute in float64 and
    are truncated, then saturated at the type's range, as XLA casts (torch's
    own cast would wrap); floats compute in their own type."""
    x = _data(dtype, (8, 9), seed=8)
    big = np.array([[0.0, 300.7, -2.5], [1e10, 0.0, -1e10], [7.5, -0.5, 0.0]])
    for name in ("grey_erosion", "grey_dilation"):
        _equal(*_both(name, x, structure=big))
        _equal(*_both(name, x, structure=big[:2] * 1e-9, mode="constant",
                      cval=-3.5))
        _equal(*_both(name, x, structure=big, footprint=big > 0))


def test_grey_flat_structure_is_a_min_max_filter():
    x = _data(np.float64, (9, 10), seed=9)
    _equal(*_both("grey_erosion", x, structure=np.zeros((3, 3))))
    _equal(*_both("grey_dilation", x, footprint=np.ones((2, 3)),
                  structure=np.zeros((2, 3))))


@pytest.mark.parametrize("mode", MODES)
def test_grey_erosion_dilation(mode):
    x = _data(np.float64, (11, 12), seed=10)
    st = np.random.RandomState(11).standard_normal((3, 4)).round(2)
    for name in ("grey_erosion", "grey_dilation"):
        _equal(*_both(name, x, size=(3, 2), mode=mode, cval=0.3))
        _equal(*_both(name, x, footprint=np.array([[1, 0], [1, 1], [0, 1]]),
                      mode=mode, origin=(1, 0)))
        _equal(*_both(name, x, structure=st, mode=mode, origin=(0, -1)))


def test_grey_dilation_even_footprint_and_edge_origins():
    """Even footprints and sizes (the dilation's origin shifts by one) and
    origins at the ends of the valid range."""
    x = _data(np.float64, (9, 9), seed=12, nan=False)
    fp = np.ones((2, 4), bool)
    fp[0, 1] = False
    _equal(*_both("grey_dilation", x, footprint=fp))
    _equal(*_both("grey_dilation", x, size=(2, 4), origin=(0, 1)))
    _equal(*_both("grey_dilation", x, size=4, origin=(-1, -2)))
    _equal(*_both("grey_erosion", x, size=(5, 2), origin=(2, -1)))
    _equal(*_both("grey_dilation", x, structure=np.ones((4, 2)),
                  origin=(-2, 0)))


@pytest.mark.parametrize("dtype", [np.float64, np.uint8, np.uint16, np.int32,
                                   np.uint64, np.bool_],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", ["grey_opening", "grey_closing",
                                  "morphological_gradient",
                                  "morphological_laplace", "white_tophat",
                                  "black_tophat"])
def test_grey_composites(name, dtype):
    """Integers wrap in the differences (uint16/uint32/uint64 too); bool
    top-hats are exclusive ors and bool differences raise TypeError, as in
    JAX."""
    x = _data(dtype, (9, 10), seed=13, nan=False)
    fp = np.array([[0, 1, 0], [1, 1, 1]], bool)
    if dtype == np.bool_ and name.startswith("morphological"):
        _raise_both(TypeError, "sub", name, x, size=3)
        return
    _equal(*_both(name, x, size=(3, 2)))
    _equal(*_both(name, x, footprint=fp, mode="nearest"))


def test_grey_composites_structure_and_output():
    x = _data(np.int16, (8, 9), seed=14)
    st = np.arange(6.0).reshape(2, 3) * 100
    for name in ("grey_opening", "white_tophat", "morphological_laplace"):
        _equal(*_both(name, x, structure=st))
    _equal(*_both("black_tophat", x, size=3, output=np.float64))
    out = np.zeros((8, 9), np.int32)
    got = et.grey_closing(x, size=2, output=out, device="cpu")
    assert got is out
    _equal(got, ej.grey_closing(x, size=2, output=np.zeros_like(out)))


# ---------------------------------------------------------------------------
# rank / median / percentile (K12)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rank", [1, 3, -2, 4])
def test_rank_filter(rank, mode):
    x = _data(np.float64, (9, 10), seed=15, nan=False)
    _equal(*_both("rank_filter", x, rank, size=3, mode=mode, cval=0.7))
    _equal(*_both("rank_filter", x, rank, footprint=np.array(
        [[1, 1, 0], [0, 1, 1], [1, 0, 1]]), mode=mode, origin=(0, 1)))


@pytest.mark.parametrize("size", [3, (3, 5, 1), (3, 1, 25), (5, 1, 14)],
                         ids=["27", "15", "75", "70"])
def test_median_filter_both_routes_with_nan(size):
    """The network route (up to 64 taps) gives NaN for a window holding a
    NaN; the select route (above 64 taps) orders NaN last, as jnp.sort. The
    two differ on the same windows, and each matches the JAX package."""
    x = _data(np.float64, (7, 8, 30), seed=16)
    got, want = _both("median_filter", x, size=size)
    _equal(got, want)
    k = int(np.prod(np.broadcast_to(size, (3,))))
    if k <= tm.RANK_NETWORK_MAX_TAPS:
        assert np.isnan(_np(got)).sum() > 3
    else:
        assert np.isnan(_np(got)).sum() == 0


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=lambda d: np.dtype(d).name)
def test_rank_filter_dtypes_both_routes(dtype):
    x = _data(dtype, (6, 7, 20), seed=17)
    _equal(*_both("median_filter", x, size=3, mode="constant", cval=2.2))
    _equal(*_both("rank_filter", x, 40, size=(3, 3, 9), mode="wrap"))


@pytest.mark.parametrize("percentile", [0, 10, 33.3, 50, 90, 100, -25])
def test_percentile_filter(percentile):
    x = _data(np.float32, (10, 11), seed=18, nan=False)
    _equal(*_both("percentile_filter", x, percentile, size=(3, 4)))
    _equal(*_both("percentile_filter", x, percentile,
                  footprint=np.array([[1, 0, 1], [1, 1, 1]]), mode="mirror"))


_FP3 = np.array([[[1, 0, 1], [1, 1, 0]], [[0, 1, 1], [1, 0, 1]]], bool)
_ST3 = np.array([[[0.0, -0.0, 1.5], [-0.0, 0.0, 0.0]],
                 [[0.0, 2.0, -0.0], [0.0, -1.5, 0.0]]])


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name, args, kw", [
    ("minimum_filter1d", (3,), {}),
    ("maximum_filter1d", (4,), dict(mode="constant", cval=-0.0)),
    ("minimum_filter", (), dict(size=(2, 3, 1))),
    ("maximum_filter", (), dict(footprint=_FP3, mode="constant", cval=-0.0)),
    ("grey_erosion", (), dict(structure=_ST3)),
    ("grey_dilation", (), dict(structure=[[[-0.0, 0.0, -2.0]]],
                               mode="wrap")),
    ("median_filter", (), dict(size=3)),
    ("percentile_filter", (70,), dict(footprint=_FP3, mode="constant",
                                      cval=-0.0)),
    ("rank_filter", (40,), dict(size=(3, 3, 9))),
    ("median_filter", (), dict(size=(3, 3, 9), mode="constant",
                               cval=-0.0)),
    ("rank_filter", (0,), dict(footprint=_FP3)),
    ("grey_opening", (), dict(size=(2, 3, 2))),
], ids=lambda v: v if isinstance(v, str) else "")
def test_signed_zeros(name, args, kw, dtype):
    """Zeros of both signs, bit for bit: min, max and the network route
    order -0 below +0 (jnp.minimum / jnp.maximum); the select route (81
    taps) takes equal values, -0 and +0 among them, in tap order, as the
    stable jnp.sort does. A few NaN and many ties."""
    rs = np.random.RandomState(44)
    x = rs.choice(np.array([-0.0, 0.0, 1.5, -1.5, 2.0], dtype),
                  size=(6, 7, 20))
    x.reshape(-1)[rs.choice(x.size, 4, replace=False)] = np.nan
    got, want = _both(name, x, *args, **kw)
    _equal(got, want)
    assert np.signbit(_np(got)[_np(got) == 0]).any()


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.uint64],
                         ids=lambda d: np.dtype(d).name)
def test_generic_filters_unsigned(dtype):
    """generic_filter1d and vectorized_filter pad unsigned inputs whose
    PyTorch CPU operations are missing (reflect folds, constant pads)."""
    x = _data(dtype, (6, 9), seed=45)
    fp = np.array([[1, 0, 1], [0, 1, 1]], bool)
    for kw in (dict(mode="reflect"), dict(mode="constant", cval=7.9)):
        _equal(*_both("generic_filter1d", x, lambda v: v[2:], 3, 1,
                      origin=-1, **kw))
        for fn, shape in ((lambda w, axis: w[..., 2, 1], dict(size=(3, 2))),
                          (lambda w, axis: w[..., 2], dict(footprint=fp))):
            _equal(et.vectorized_filter(x, fn, device="cpu", **shape, **kw),
                   ej.vectorized_filter(x, fn, **shape, **kw))


def test_rank_filter_short_circuits_axes_and_3d():
    """Rank 0 and k-1 run as minimum / maximum filters (per-axis modes
    allowed there); ``axes=``; a 3-D footprint."""
    x = _data(np.int32, (6, 7, 8), seed=19)
    _equal(*_both("rank_filter", x, 0, size=3,
                  mode=["wrap", "reflect", "nearest"]))
    _equal(*_both("rank_filter", x, -1, size=(2, 3, 2)))
    _equal(*_both("median_filter", x, size=3, axes=(0, 2)))
    _equal(*_both("percentile_filter", x, 70, footprint=np.ones((2, 3)),
                  axes=(1, 2), origin=(0, 1)))
    fp = np.random.RandomState(20).rand(3, 3, 3) > 0.5
    _equal(*_both("median_filter", x, footprint=fp, mode="constant",
                  cval=-5))


# ---------------------------------------------------------------------------
# errors and the cval conversion


def test_cval_conversion_raises_out_of_range():
    """cval converts into an integer pad as numpy converts: out of range
    raises OverflowError, NaN ValueError, in both packages."""
    u8 = _data(np.uint8, (6, 7), seed=21)
    _raise_both(OverflowError, "out of bounds", "minimum_filter1d", u8, 3,
                mode="constant", cval=-1.5)
    _raise_both(OverflowError, "out of bounds", "median_filter", u8, size=3,
                mode="constant", cval=256)
    _raise_both(ValueError, "NaN", "maximum_filter", u8, size=3,
                mode="constant", cval=float("nan"))
    # unused outside constant mode, and beside a non-flat structure the
    # pad is float64
    _equal(*_both("minimum_filter1d", u8, 3, mode="wrap", cval=-1.5))
    _equal(*_both("grey_erosion", u8, structure=np.ones((2, 2)),
                  mode="constant", cval=-1.5))


@pytest.mark.parametrize("call, exc, match", [
    (lambda m, x: m.minimum_filter(x, footprint=np.zeros((3, 3))),
     ValueError, "All-zero footprint"),
    (lambda m, x: m.minimum_filter1d(x, 0), RuntimeError,
     "incorrect filter size"),
    (lambda m, x: m.maximum_filter1d(x, 3, origin=2), ValueError,
     "invalid origin"),
    (lambda m, x: m.maximum_filter(x, footprint=np.eye(3),
                                   mode=["reflect", "wrap"]),
     RuntimeError, "sequence of modes"),
    (lambda m, x: m.median_filter(x, size=3, mode=["reflect", "wrap"]),
     RuntimeError, "sequence of modes"),
    (lambda m, x: m.minimum_filter(x), RuntimeError, "no footprint"),
    (lambda m, x: m.grey_erosion(x), ValueError, "must be specified"),
    (lambda m, x: m.grey_dilation(x), ValueError, "must be specified"),
    (lambda m, x: m.rank_filter(x, 9, size=3), RuntimeError,
     "rank not within"),
    (lambda m, x: m.rank_filter(x, 1, footprint=np.zeros((2, 2))),
     RuntimeError, "rank not within"),
    (lambda m, x: m.percentile_filter(x, 101, size=3), RuntimeError,
     "invalid percentile"),
    (lambda m, x: m.median_filter(x), RuntimeError, "no footprint"),
    (lambda m, x: m.minimum_filter(x, size=(2, 2, 2)), RuntimeError,
     "size must have length"),
    (lambda m, x: m.minimum_filter(x, size=3, mode="bogus"), RuntimeError,
     "boundary mode not supported"),
    (lambda m, x: m.binary_erosion(x, structure=np.ones((3, 3, 3))),
     RuntimeError, "structure rank must equal input rank"),
    (lambda m, x: m.binary_dilation(x, origin=(2, 0)), ValueError,
     "invalid origin"),
    (lambda m, x: m.generic_filter1d(x, lambda v: v, 3), ValueError,
     "lines of length"),
    (lambda m, x: m.generic_filter1d(x, lambda v: v, 0), RuntimeError,
     "invalid filter size"),
    (lambda m, x: m.vectorized_filter(x, np.max, size=3, cval=1.0),
     ValueError, "compatible only"),
    (lambda m, x: m.vectorized_filter(x, np.max, size=8, mode="valid"),
     ValueError, "must not exceed"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_errors_match(call, exc, match):
    x = _data(np.float64, (6, 7), seed=22, nan=False)

    class Port:
        def __getattr__(self, name):
            fn = getattr(et, name)
            return lambda *a, **k: fn(*a, device="cpu", **k)

    with pytest.raises(exc, match=match):
        call(Port(), x)
    with pytest.raises(exc, match=match):
        call(ej, x)


def test_no_gradient():
    x = torch.rand(5, 6, dtype=torch.float64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        et.median_filter(x, size=3, device="cpu")
    with pytest.raises(RuntimeError, match="no gradient"):
        et.binary_erosion(x, device="cpu")
    _equal(et.grey_dilation(x.detach(), size=2, device="cpu"),
           ej.grey_dilation(x.detach().numpy(), size=2))


# ---------------------------------------------------------------------------
# binary morphology (K13)


@pytest.mark.parametrize("border_value", [0, 1])
@pytest.mark.parametrize("iterations", [1, 2, 3, 0, -1])
@pytest.mark.parametrize("name", ["binary_erosion", "binary_dilation"])
def test_binary_erosion_dilation(name, iterations, border_value):
    """Fixed iterations, and ``iterations <= 0`` to the fixpoint."""
    x = _blob(23, (16, 17))
    st = ej.generate_binary_structure(2, 2)
    _equal(*_both(name, x, st, iterations=iterations,
                  border_value=border_value))
    _equal(*_both(name, x, iterations=iterations, border_value=border_value))


@pytest.mark.parametrize("iterations", [1, 2, 0])
@pytest.mark.parametrize("name", ["binary_erosion", "binary_dilation"])
def test_binary_mask(name, iterations):
    x = _blob(24, (13, 14))
    mask = _blob(25, (13, 14), -0.2)
    _equal(*_both(name, x, mask=mask, iterations=iterations))
    _equal(*_both(name, x.astype(np.uint8) * 3, mask=mask.astype(np.int16),
                  iterations=iterations, border_value=1))


def test_binary_default_structure_origin_and_even():
    x = _blob(26, (14, 15))
    _equal(*_both("binary_erosion", x, origin=(1, -1), border_value=1))
    _equal(*_both("binary_dilation", x, np.ones((2, 3), bool)))
    _equal(*_both("binary_erosion", x, np.ones((2, 4), bool), origin=(0, 1)))
    _equal(*_both("binary_dilation", x, np.ones((4, 1), bool),
                  origin=(-2, 0), iterations=2))
    _equal(*_both("binary_erosion", x, np.ones((3, 3), bool),
                  origin=(-1, 1)))


@pytest.mark.parametrize("name", ["binary_erosion", "binary_dilation",
                                  "binary_opening", "binary_closing"])
def test_binary_empty_structure(name):
    """An all-False structure: erosion is all True, dilation all False
    (SciPy's convention), mask-gated."""
    x = _blob(27, (9, 10))
    st = np.zeros((3, 3), bool)
    _equal(*_both(name, x, st))
    _equal(*_both(name, x, st, mask=_blob(28, (9, 10))))
    _equal(*_both(name, x, st, iterations=0))


@pytest.mark.parametrize("iterations", [1, 2])
def test_binary_opening_closing_3d(iterations):
    x = _blob(29, (8, 9, 10))
    st = ej.generate_binary_structure(3, 2)
    for name in ("binary_opening", "binary_closing"):
        _equal(*_both(name, x, st, iterations=iterations))
        _equal(*_both(name, x, iterations=iterations, border_value=1,
                      mask=_blob(30, (8, 9, 10), -0.3)))


def test_binary_propagation_fill_holes_hit_or_miss():
    x = _blob(31, (16, 18))
    seed = np.zeros_like(x)
    seed[8, 9] = seed[2, 3] = True
    _equal(*_both("binary_propagation", seed, mask=x))
    _equal(*_both("binary_propagation", seed, mask=x,
                  structure=np.ones((3, 3))))
    ring = np.zeros((12, 13), bool)
    ring[2:10, 2:11] = True
    ring[4:8, 4:9] = False
    ring[5, 6] = True
    _equal(*_both("binary_fill_holes", ring))
    _equal(*_both("binary_fill_holes", x, structure=np.ones((3, 3))))
    _equal(*_both("binary_hit_or_miss", x))
    _equal(*_both("binary_hit_or_miss", x, np.array([[0, 1, 0], [1, 1, 1]]),
                  origin1=(0, 1)))
    _equal(*_both("binary_hit_or_miss", x, np.ones((3, 3), bool)))
    _equal(*_both("binary_hit_or_miss", x, np.array([[1, 0], [0, 1]]),
                  np.array([[0, 1], [1, 0]]), origin2=(-1, 0)))


def test_binary_axes_and_brute_force():
    """``axes=``: the structure and origin cover only those axes."""
    x = _blob(32, (3, 10, 11))
    for name in ("binary_erosion", "binary_dilation", "binary_opening",
                 "binary_closing"):
        _equal(*_both(name, x, axes=(1, 2)))
        _equal(*_both(name, x, np.ones((2, 3)), axes=(1, 2),
                      origin=(0, 1), brute_force=True))
    _equal(*_both("binary_fill_holes", x, axes=(1, 2)))
    _equal(*_both("binary_propagation", x[:, 5:6].repeat(10, 1), mask=x,
                  axes=(0, 2)))
    _equal(*_both("binary_hit_or_miss", x, axes=(0, 1)))


def test_structure_helpers():
    for rank in range(0, 4):
        for conn in range(0, 4):
            _equal(et.generate_binary_structure(rank, conn),
                   ej.generate_binary_structure(rank, conn))
    st = ej.generate_binary_structure(2, 1)
    for its in (1, 2, 3):
        _equal(et.iterate_structure(st, its), ej.iterate_structure(st, its))
    got, go = et.iterate_structure(np.ones((2, 3)), 3, origin=(0, 1))
    want, wo = ej.iterate_structure(np.ones((2, 3)), 3, origin=(0, 1))
    _equal(got, want)
    assert go == wo


# ---------------------------------------------------------------------------
# generic filters (no kernel: glue over the tap stack and the line pad)


@pytest.mark.parametrize("mode", MODES)
def test_generic_filter(mode):
    """A callable on tensors is vmapped (the same on jnp arrays); a
    numpy-only callable (np.ptp) runs once per voxel on the host. The data
    are whole numbers, so the callables' sums are exact in any order."""
    x = np.round(_data(np.float64, (8, 9), seed=33, nan=False))
    fp = np.array([[1, 0, 1], [1, 1, 0]], bool)
    _equal(*_both("generic_filter", x, lambda v: v.max() - v.min(), size=3,
                  mode=mode, cval=0.5))
    _equal(*_both("generic_filter", x, np.ptp, footprint=fp, mode=mode,
                  origin=(0, 1)))
    _equal(*_both("generic_filter", x, lambda v, a, b=1.0: (v * a).sum() + b,
                  size=(2, 3), extra_arguments=(2.0,),
                  extra_keywords={"b": -1.0}, mode=mode))


def test_generic_filter_dtypes_and_output():
    x = _data(np.int16, (7, 8), seed=34)
    _equal(*_both("generic_filter", x, np.ptp, size=3))
    _equal(*_both("generic_filter", x, lambda v: v.max(), size=2,
                  output=np.float32, axes=(1,)))
    _equal(*_both("generic_filter", x.astype(np.uint16), np.ptp, size=3,
                  mode="constant", cval=9.9))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("size", [1, 3, 4])
def test_generic_filter1d(size, mode):
    x = _data(np.float64, (6, 9), seed=35, nan=False)
    n = x.shape[1]

    def fn(line):
        return line[size - 1:] * 2 - line[:n]

    for origin in {0, -(size // 2), size - 1 - size // 2}:
        _equal(*_both("generic_filter1d", x, fn, size, 1, mode=mode,
                      cval=1.5, origin=origin))
    _equal(*_both("generic_filter1d", x, lambda v: np.sort(v)[:x.shape[0]],
                  size, 0, mode=mode))


@pytest.mark.parametrize("mode", MODES + ["valid"])
def test_vectorized_filter(mode):
    """``function(windows, axis=...)`` is called once: torch's reductions
    take ``axis`` as jnp's do (whole numbers: the sums are exact; no -0,
    which ``torch.amax`` and ``jnp.max`` order differently)."""
    x = np.round(_data(np.float64, (8, 9, 5), seed=36, nan=False)) + 0.0
    kw = dict(mode=mode)
    if mode == "constant":
        kw["cval"] = 2.0
    _equal(et.vectorized_filter(x, torch.amax, size=(3, 2), axes=(0, 1),
                                device="cpu", **kw),
           ej.vectorized_filter(x, jnp.max, size=(3, 2), axes=(0, 1), **kw))
    _equal(et.vectorized_filter(x, torch.sum, size=3, device="cpu", **kw),
           ej.vectorized_filter(x, jnp.sum, size=3, **kw))
    fp = np.array([[1, 0, 1], [0, 1, 1]], bool)
    if mode != "valid":
        _equal(et.vectorized_filter(x[..., 0], torch.amin, footprint=fp,
                                    origin=(0, -1), device="cpu", **kw),
               ej.vectorized_filter(x[..., 0], jnp.min, footprint=fp,
                                    origin=(0, -1), **kw))


# ---------------------------------------------------------------------------
# plain versions: the uint widening and the select route's NaN order


def test_plain_unsigned_mapping_keeps_order():
    for dtype in (torch.uint16, torch.uint32, torch.uint64):
        info = torch.iinfo(dtype)
        a = torch.tensor([0, 1, info.max // 2, info.max // 2 + 1, info.max],
                         dtype=torch.int64 if dtype != torch.uint64 else
                         torch.float64)
        if dtype == torch.uint64:
            a = torch.as_tensor(np.array([0, 1, 2 ** 63 - 1, 2 ** 63,
                                          2 ** 64 - 1], dtype=np.uint64))
        else:
            a = a.to(dtype)
        p = tm._plain(a)
        assert bool((p[1:] > p[:-1]).all())
        _equal(tm._unplain(p, dtype), a)


def test_rank_network_matches_sorting():
    rs = np.random.RandomState(37)
    for k in range(2, 65):
        for rank in {0, k // 2, k - 1, int(rs.randint(k))}:
            n, pairs = tm._rank_network(k, rank)
            vals = rs.standard_normal((50, k))
            wires = np.concatenate([vals, np.full((50, n - k), np.inf)], 1)
            for i, j in pairs:
                a, b = wires[:, i].copy(), wires[:, j].copy()
                wires[:, i], wires[:, j] = np.minimum(a, b), np.maximum(a, b)
            np.testing.assert_array_equal(wires[:, rank],
                                          np.sort(vals, 1)[:, rank])


# ---------------------------------------------------------------------------
# the kernels on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions(cuda_device):
    """K10-K13 bit for bit against their plain versions (chip_smoke.py's
    phase 2 sweep)."""
    import chip_smoke
    chip_smoke._check_morph_kernels(np.random.RandomState(0), cuda_device)


@pytest.mark.cuda
def test_entry_points_on_the_card(cuda_device):
    x = _data(np.float32, (20, 21, 22), seed=38)
    for name, args, kw in (("median_filter", (), dict(size=3)),
                           ("median_filter", (), dict(size=5)),
                           ("grey_opening", (), dict(size=(3, 2, 4))),
                           ("white_tophat", (), dict(
                               footprint=np.ones((2, 3, 1))))):
        got = getattr(et, name)(x, *args, device=cuda_device, **kw)
        _equal(got.cpu(), getattr(et, name)(x, *args, device="cpu", **kw))
    b = _blob(39, (20, 21, 22))
    _equal(et.binary_fill_holes(b, device=cuda_device).cpu(),
           et.binary_fill_holes(b, device="cpu"))


@pytest.mark.parametrize("name, args, kw", [
    ("minimum_filter1d", (4,), dict(mode="constant", cval=-3.0)),
    ("maximum_filter", (), dict(size=3)),
    ("median_filter", (), dict(footprint=[1, 0, 1, 1])),
    ("rank_filter", (70,), dict(size=80, mode="mirror")),
    ("grey_dilation", (), dict(structure=[0.5, 0.0, -2.0])),
    ("binary_dilation", (), dict(iterations=0, mask=None)),
    ("binary_erosion", ([1, 1],), dict(border_value=1, iterations=2)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_one_dimensional(name, args, kw):
    x = _data(np.float64, (97,), seed=40)
    if name.startswith("binary"):
        x = x > 0
    _equal(*_both(name, x, *args, **kw))


def test_tensor_arguments_and_strides():
    """Non-contiguous tensors, tensor footprints, structures and masks."""
    x = torch.as_tensor(_data(np.int32, (9, 12), seed=41)).t()
    fp = torch.tensor([[1, 0], [1, 1]], dtype=torch.bool)
    xn = x.numpy()
    _equal(et.maximum_filter(x, footprint=fp, device="cpu"),
           ej.maximum_filter(xn, footprint=fp.numpy()))
    _equal(et.grey_erosion(x, structure=torch.ones(2, 3) * 4, device="cpu"),
           ej.grey_erosion(xn, structure=np.ones((2, 3)) * 4))
    _equal(et.percentile_filter(x[::2], 30, footprint=fp, device="cpu"),
           ej.percentile_filter(xn[::2], 30, footprint=fp.numpy()))
    b = torch.as_tensor(_blob(42, (12, 9))).t()
    m = torch.as_tensor(_blob(43, (9, 12), -0.3))
    _equal(et.binary_dilation(b, mask=m, iterations=0, device="cpu"),
           ej.binary_dilation(b.numpy(), mask=m.numpy(), iterations=0))
