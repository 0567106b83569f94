"""Note R12: the linear filter tier on non-finite inputs, against SciPy.

The port's rule is ``scipy.ndimage``'s ``correlate1d`` / ``correlate``: a
NaN or an infinity reaches only the outputs whose taps read it, and a NaN
or infinite ``cval`` only the outputs whose taps reach past the edge in
constant mode. The JAX package departs from it: its dense banded matrix
multiplies every sample of a line, so one non-finite value turns its whole
line into NaN (0 * NaN), and the next axis the whole volume; its
constant-mode bias ``b * cval`` does the same with an infinite ``cval``.
SciPy's ``uniform_filter`` spreads a NaN further still, forward along the
line (a running sum); the port does not copy that either: its
``uniform_filter`` reaches what its taps read.

On seeded float32 and float64 inputs holding NaN and +-inf, and with a
finite, NaN or infinite ``cval``, in the five modes, the port with
``device="cpu"`` (kernels K8 and K9 take their plain twins there) against
SciPy: NaN where NaN, the same infinities, and the finite values to the
tolerances ``test_torch_filters.py`` uses (float64 ``rtol=1e-12``, float32
``1e-5``, each times the largest finite reference value as ``atol``).
Where the JAX package's result is finite, and on the lines that hold only
finite samples and a finite ``cval``, the port also equals the JAX
package; one test pins the JAX package's departure on the case note R12
states, so that a change in the reference is noticed.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

import elasticdeform_tpu as ej
import elasticdeform_tpu_torch as et

MODES = ["reflect", "constant", "nearest", "mirror", "wrap"]
DTYPES = [np.float32, np.float64]
CVALS = [0.4, np.nan, np.inf, -np.inf]
RTOL = {np.float32: 1e-5, np.float64: 1e-12}

# (function, positional arguments, keywords), one axis or the whole volume
CALLS = {
    "correlate1d": (lambda rs: (rs.standard_normal(5),), {"axis": 1}),
    "gaussian_filter1d": (lambda rs: (1.2,), {"axis": 0}),
    "gaussian_filter": (lambda rs: (0.8,), {}),
    "correlate": (lambda rs: (rs.standard_normal((3, 2, 3)),), {}),
    "convolve": (lambda rs: (rs.standard_normal((2, 3, 3)),), {}),
    "sobel": (lambda rs: (), {"axis": 2}),
    "prewitt": (lambda rs: (), {"axis": 0}),
    "laplace": (lambda rs: (), {}),
    "gaussian_laplace": (lambda rs: (0.7,), {}),
}


def _volume(seed, dtype, shape=(7, 8, 9)):
    """Seeded values with a few NaN, +inf and -inf."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal(shape)
    flat = x.reshape(-1)
    picks = rs.choice(flat.size, 9, replace=False)
    flat[picks[:3]] = np.nan
    flat[picks[3:6]] = np.inf
    flat[picks[6:]] = -np.inf
    return x.astype(dtype)


def _port(name, x, args, kw):
    return np.asarray(getattr(et, name)(x, *args, device="cpu", **kw))


def _same_nonfinite(got, want, rtol):
    """NaN where ``want`` has NaN, the same infinities, the finite values
    within ``rtol`` (``atol`` ``rtol`` times the largest of them)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    scale = float(np.abs(want[fin]).max()) if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                               atol=rtol * scale)


@pytest.mark.parametrize("cval", CVALS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CALLS))
def test_port_is_scipy_on_nonfinite_inputs(name, mode, dtype, cval):
    make, kw = CALLS[name]
    args = make(np.random.RandomState(len(name)))
    x = _volume(3, dtype)
    kw = dict(kw, mode=mode, cval=cval)
    got = _port(name, x, args, kw)
    want = getattr(ndi, name)(x, *args, **kw)
    _same_nonfinite(got, want, RTOL[dtype])


@pytest.mark.parametrize("cval", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("name", ["correlate1d", "gaussian_filter1d",
                                  "gaussian_filter", "correlate"])
def test_nonfinite_cval_on_finite_input(name, cval):
    """A finite volume, a non-finite ``cval``: only the outputs whose taps
    reach past the edge in constant mode take it."""
    make, kw = CALLS[name]
    args = make(np.random.RandomState(len(name)))
    x = np.random.RandomState(5).standard_normal((15, 16, 17))
    kw = dict(kw, mode="constant", cval=cval)
    got = _port(name, x, args, kw)
    want = getattr(ndi, name)(x, *args, **kw)
    _same_nonfinite(got, want, RTOL[np.float64])
    assert np.isfinite(got).any() and not np.isfinite(got).all()


# the calls that pass along every axis they filter: one non-finite sample
# turns the JAX package's whole result into NaN after three passes, so the
# comparison with it takes two axes, leaving a free axis across which no
# pass carries a non-finite value
JAX_AXES = {"gaussian_filter": (0, 1), "gaussian_laplace": (0, 1),
            "sobel": (1, 2), "prewitt": (0, 1)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CALLS))
def test_port_is_jax_where_jax_is_finite(name, mode):
    """The existing oracle still binds: wherever the JAX package's result
    is finite (no non-finite value reached it there), the port equals it
    (float64, ``rtol=1e-12``). The non-finite samples lie in the last three
    slices along a free axis (axis 2, or the one outside ``JAX_AXES``), so
    that more than a quarter of the JAX result stays finite."""
    make, kw = CALLS[name]
    args = make(np.random.RandomState(len(name)))
    free = 2
    if name in JAX_AXES:
        kw = dict(kw, axes=JAX_AXES[name])
        free, = set(range(3)) - set(JAX_AXES[name])
    x = _volume(4, np.float64, (9, 8, 7))
    head = (slice(None),) * free + (slice(0, x.shape[free] - 3),)
    x[head] = np.random.RandomState(6).standard_normal(x[head].shape)
    assert not np.isfinite(x).all()
    kw = dict(kw, mode=mode, cval=0.4)
    got = _port(name, x, args, kw)
    want = np.asarray(getattr(ej, name)(x, *args, **kw))
    fin = np.isfinite(want)
    assert fin.mean() > 0.25
    scale = float(np.abs(want[fin]).max())
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12,
                               atol=1e-12 * scale)


@pytest.mark.parametrize("cval", CVALS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["correlate1d", "gaussian_filter1d"])
def test_finite_lines_match_jax(name, mode, cval):
    """A 1-D filter on lines that hold only finite samples: the port equals
    the JAX package there, and where ``cval`` is finite, or the mode never
    reads it, on every such line."""
    make, kw = CALLS[name]
    args = make(np.random.RandomState(len(name)))
    axis = kw["axis"]
    x = _volume(7, np.float64)
    kw = dict(kw, mode=mode, cval=cval)
    got = _port(name, x, args, kw)
    want = np.asarray(getattr(ej, name)(x, *args, **kw))
    finite_line = np.isfinite(x).all(axis=axis, keepdims=True)
    lines = np.broadcast_to(finite_line, x.shape)
    if mode != "constant" or np.isfinite(cval):
        assert lines.any()
        scale = float(np.abs(want[lines]).max())
        np.testing.assert_allclose(got[lines], want[lines], rtol=1e-12,
                                   atol=1e-12 * scale)
        assert np.isfinite(got[lines]).all()
    else:
        # JAX's cval bias multiplies every row by cval: its finite lines go
        # non-finite too, the port's only near the edges
        assert not np.isfinite(want[lines]).all()


def test_uniform_filter_reaches_its_taps_not_scipy_running_sum():
    """SciPy's uniform_filter1d keeps a running sum, so a NaN spreads
    forward along the line past the window; the port's uniform_filter
    reaches what its taps read: the correlation with ``ones(3) / 3`` per
    axis."""
    x = _volume(8, np.float64, (12, 13, 14))
    got = _port("uniform_filter", x, (3,), {})
    taps = x
    for axis in range(3):
        taps = ndi.correlate1d(taps, np.ones(3) / 3.0, axis)
    _same_nonfinite(got, taps, 1e-12)
    scipy_nan = np.isnan(ndi.uniform_filter(x, 3)).sum()
    assert scipy_nan > np.isnan(got).sum()


def test_jax_package_smears_a_nan():
    """Note R12's case: one NaN in a seeded 12x13x14 float64 volume through
    ``gaussian_filter(sigma=1)``. SciPy and the port give NaN at the outputs
    whose taps read it; the JAX package's banded matrix gives NaN
    everywhere. This pins the reference's departure, it does not endorse
    it."""
    x = np.random.RandomState(0).standard_normal((12, 13, 14))
    x[5, 6, 7] = np.nan
    port = _port("gaussian_filter", x, (1.0,), {})
    scipy_out = ndi.gaussian_filter(x, 1.0)
    jax_out = np.asarray(ej.gaussian_filter(x, 1.0))
    np.testing.assert_array_equal(np.isnan(port), np.isnan(scipy_out))
    assert 0 < np.isnan(port).sum() < x.size
    assert np.isnan(jax_out).all()
    # an infinite cval on a finite volume: SciPy and the port keep NaN out,
    # the JAX package's bias b * cval brings 0 * inf in
    y = np.random.RandomState(1).standard_normal((12, 13, 14))
    kw = dict(mode="constant", cval=np.inf)
    port = _port("gaussian_filter1d", y, (1.0,), kw)
    assert not np.isnan(port).any()
    assert not np.isnan(ndi.gaussian_filter1d(y, 1.0, **kw)).any()
    assert np.isnan(np.asarray(ej.gaussian_filter1d(y, 1.0, **kw))).any()
