"""The port's linear filter tier against the JAX package on the CPU.

The same numpy inputs (made from a seed) go through ``elasticdeform_tpu``
(CPU, float64 under x64, as ``conftest.py`` sets) and the port with
``device="cpu"``, where kernels K8, K8T, K9 and K9T take their plain
versions. Tolerances:

* float64 results: ``rtol=1e-12, atol=1e-12*max|ref|`` (the JAX package sums
  through a banded ``tensordot``, the port tap by tap);
* integer and bool outputs bit for bit, on SciPy's paired route and wherever
  the sum is exact (integer or dyadic taps);
* float32 results keep float32 and agree to ``rtol=1e-5``;
* gradients through ``Correlate1d`` / ``CorrelateNd`` against ``jax.vjp``
  with the same cotangent: ``1e-10``;
* the plain versions of K8T and K9T against dense transposes
  (``filter_matrix(...).T``, and the dense matrix of K9's plain version) on
  short lines: ``1e-13``.

Tests marked ``cuda`` hold the four kernels against their plain versions and
run only where a card is.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import elasticdeform_tpu as ej

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch.ops import filters as tf

MODES = ["reflect", "constant", "nearest", "mirror", "wrap"]
GRID_MODES = ["grid-mirror", "grid-wrap", "grid-constant"]
FWD, GRAD = 1e-12, 1e-10


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _close(got, want, rtol=FWD):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _equal(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _both(name, x, *args, **kw):
    """``(port, JAX)`` results of the function ``name`` on the same
    inputs."""
    return (getattr(et, name)(x, *args, device="cpu", **kw),
            getattr(ej, name)(x, *args, **kw))


# ---------------------------------------------------------------------------
# the Gaussian family


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("order", range(4))
@pytest.mark.parametrize("sigma", [0.7, 2.0, 5.0])
def test_gaussian_filter1d(sigma, order, mode):
    """sigma=5 has 41 taps on axes of 9 and 14: the fold repeats."""
    x = np.random.RandomState(order).standard_normal((9, 14))
    for axis in (0, -1):
        _close(*_both("gaussian_filter1d", x, sigma, axis, order=order,
                      mode=mode, cval=0.4))


@pytest.mark.parametrize("kw", [dict(truncate=2.0), dict(truncate=0.3),
                                dict(radius=3), dict(radius=0),
                                dict(radius=11, truncate=1.0)],
                         ids=["t2", "t0.3", "r3", "r0", "r11"])
def test_gaussian_filter1d_truncate_radius(kw):
    x = np.random.RandomState(1).standard_normal((7, 10))
    _close(*_both("gaussian_filter1d", x, 1.6, 1, mode="mirror", **kw))


@pytest.mark.parametrize("mode", MODES)
def test_gaussian_filter_per_axis(mode):
    x = np.random.RandomState(2).standard_normal((6, 7, 8))
    kw = dict(order=[0, 1, 2], radius=[None, 2, 5], mode=mode, cval=-0.3)
    _close(*_both("gaussian_filter", x, (0.7, 2.0, 1.2), **kw))


def test_gaussian_filter_zero_sigma_skips_and_modes_per_axis():
    x = np.random.RandomState(3).standard_normal((6, 7, 8))
    _close(*_both("gaussian_filter", x, (0.0, 1.5, 1e-16)))
    _close(*_both("gaussian_filter", x, 1.1,
                  mode=["wrap", "constant", "nearest"], cval=2.0))


@pytest.mark.parametrize("axes", [(1, 2, 3), (3, 1), 2, (-1, -2)],
                         ids=str)
def test_gaussian_filter_axes_on_field(axes):
    """A displacement field (3, *spatial): the component axis is carried."""
    f = np.random.RandomState(4).standard_normal((3, 8, 9, 10))
    _close(*_both("gaussian_filter", f, 2.0, axes=axes, mode="reflect"))


@pytest.mark.parametrize("name", ["gaussian_laplace",
                                  "gaussian_gradient_magnitude"])
@pytest.mark.parametrize("mode", MODES)
def test_gaussian_laplace_and_gradient_magnitude(name, mode):
    x = np.random.RandomState(5).standard_normal((9, 10, 11))
    _close(*_both(name, x, 1.5, mode=mode, cval=0.25))


@pytest.mark.parametrize("name", ["gaussian_laplace",
                                  "gaussian_gradient_magnitude"])
def test_gaussian_laplace_and_gradient_magnitude_axes(name):
    x = np.random.RandomState(6).standard_normal((2, 9, 10))
    _close(*_both(name, x, (0.9, 2.2), axes=(1, 2), truncate=3.0))
    _close(*_both(name, x[0], (0.9, 2.2), radius=[2, 4]))


# ---------------------------------------------------------------------------
# correlate1d / convolve1d / uniform / sobel / prewitt / laplace


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("taps", [1, 2, 3, 4, 7, 16])
def test_correlate1d_taps_and_origins(taps, mode):
    """Odd and even tap counts, every origin that keeps the centre on the
    support; 16 taps on an axis of 6 fold more than once."""
    rs = np.random.RandomState(taps)
    x = rs.standard_normal((6, 9))
    w = rs.standard_normal(taps)
    for origin in range(-(taps // 2), taps - taps // 2):
        _close(*_both("correlate1d", x, w, 0, mode=mode, cval=0.6,
                      origin=origin))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("taps", [3, 4])
def test_convolve1d(taps, mode):
    rs = np.random.RandomState(10 + taps)
    x = rs.standard_normal((8, 7))
    w = rs.standard_normal(taps)
    for origin in (-1, 0, 1):
        _close(*_both("convolve1d", x, w, -1, mode=mode, cval=-1.5,
                      origin=origin))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("size", [1, 2, 3, 6])
def test_uniform_filter1d(size, mode):
    x = np.random.RandomState(size).standard_normal((9, 8))
    for origin in sorted({0, -(size // 2), (size - 1) // 2}):
        _close(*_both("uniform_filter1d", x, size, 0, mode=mode, cval=0.5,
                      origin=origin))


def test_uniform_filter_per_axis():
    x = np.random.RandomState(12).standard_normal((7, 8, 9))
    _close(*_both("uniform_filter", x, 3))
    _close(*_both("uniform_filter", x, (2, 1, 4), origin=(0, 0, 1),
                  mode=["wrap", "constant", "mirror"], cval=1.0))
    _close(*_both("uniform_filter", x, 5, axes=(0, 2)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["sobel", "prewitt"])
def test_sobel_prewitt(name, mode):
    x = np.random.RandomState(13).standard_normal((7, 8, 9))
    for axis in (0, 1, -1):
        _close(*_both(name, x, axis, mode=mode, cval=0.3))
    _close(*_both(name, x, 2, axes=(0, 2)))


@pytest.mark.parametrize("mode", MODES)
def test_laplace(mode):
    x = np.random.RandomState(14).standard_normal((7, 8, 9))
    _close(*_both("laplace", x, mode=mode, cval=-0.3))
    _close(*_both("laplace", x, axes=(0, 1), mode=mode))


# ---------------------------------------------------------------------------
# N-D correlate / convolve


@pytest.mark.parametrize("mode", MODES + GRID_MODES)
@pytest.mark.parametrize("name", ["correlate", "convolve"])
def test_correlate_convolve_nd(name, mode):
    """A 3-D kernel with zeros in it, odd and even extents and origins."""
    rs = np.random.RandomState(15)
    x = rs.standard_normal((6, 7, 8))
    w = rs.standard_normal((3, 4, 2)) * (rs.rand(3, 4, 2) > 0.3)
    _close(*_both(name, x, w, mode=mode, cval=0.75, origin=(1, -1, 0)))
    _close(*_both(name, x, w[:, :, 0], mode=mode, cval=0.75, origin=0,
                  axes=(0, 2)))


@pytest.mark.parametrize("name", ["correlate", "convolve"])
def test_correlate_convolve_axes_and_origins(name):
    """``axes=`` with per-axis origins, a kernel longer than an axis, and
    an all-zero kernel."""
    rs = np.random.RandomState(16)
    x = rs.standard_normal((2, 5, 6, 7))
    w = rs.standard_normal((3, 3, 3))
    _close(*_both(name, x, w, axes=(1, 2, 3), mode="nearest"))
    _close(*_both(name, x, w[:2, 0], axes=(3, 1), origin=(1, -1),
                  mode="mirror"))
    _close(*_both(name, x[0], rs.standard_normal((9, 2, 1)), mode="wrap"))
    _close(*_both(name, x[0], np.zeros((2, 3, 1)), mode="constant",
                  cval=4.0))


@pytest.mark.parametrize("cval", [0.0, 0.5, -3.0])
def test_correlate_constant_cval(cval):
    rs = np.random.RandomState(17)
    x = rs.standard_normal((9, 10))
    w = rs.standard_normal((5, 5))
    _close(*_both("correlate", x, w, mode="constant", cval=cval,
                  origin=(2, -2)))


# ---------------------------------------------------------------------------
# generic_laplace / generic_gradient_magnitude


def _d2_torch(x, axis, mode, cval, scale=1.0):
    return et.correlate1d(x, [scale, -2.0 * scale, scale], axis, mode=mode,
                          cval=cval, device=x.device)


def _d2_jax(x, axis, mode, cval, scale=1.0):
    return ej.correlate1d(x, [scale, -2.0 * scale, scale], axis, mode=mode,
                          cval=cval)


def _d1_torch(x, axis, mode, cval):
    return et.correlate1d(x, [-0.5, 0.0, 0.5], axis, mode=mode, cval=cval,
                          device=x.device)


def _d1_jax(x, axis, mode, cval):
    return ej.correlate1d(x, [-0.5, 0.0, 0.5], axis, mode=mode, cval=cval)


@pytest.mark.parametrize("mode", ["reflect", "constant", "wrap"])
def test_generic_laplace_and_gradient_magnitude(mode):
    x = np.random.RandomState(18).standard_normal((7, 8, 9))
    kw = dict(mode=mode, cval=0.2)
    _close(et.generic_laplace(x, _d2_torch, extra_arguments=(0.5,),
                              device="cpu", **kw),
           ej.generic_laplace(x, _d2_jax, extra_arguments=(0.5,), **kw))
    _close(et.generic_laplace(x, _d2_torch, extra_keywords={"scale": 2.0},
                              axes=(0, 2), device="cpu", **kw),
           ej.generic_laplace(x, _d2_jax, extra_keywords={"scale": 2.0},
                              axes=(0, 2), **kw))
    _close(et.generic_gradient_magnitude(x, _d1_torch, device="cpu", **kw),
           ej.generic_gradient_magnitude(x, _d1_jax, **kw))
    _close(et.generic_gradient_magnitude(x, _d1_torch, axes=1,
                                         device="cpu", **kw),
           ej.generic_gradient_magnitude(x, _d1_jax, axes=1, **kw))


def test_generic_with_no_axes():
    x = np.random.RandomState(19).standard_normal((4, 5))
    _close(et.generic_laplace(x, _d2_torch, axes=(), device="cpu"),
           ej.generic_laplace(x, _d2_jax, axes=()))
    _close(et.generic_gradient_magnitude(x, _d1_torch, axes=(),
                                         device="cpu"),
           ej.generic_gradient_magnitude(x, _d1_jax, axes=()))


# ---------------------------------------------------------------------------
# the output contract: integers, bool, dtypes, arrays


def _int_input(dtype, shape, seed):
    rs = np.random.RandomState(seed)
    if dtype == np.bool_:
        return rs.rand(*shape) > 0.5
    info = np.iinfo(dtype)
    lo, hi = max(info.min, -3000), min(info.max, 3000)
    return rs.randint(lo, hi + 1, shape).astype(dtype)


INT_CASES = {
    "gaussian_filter": lambda m, x, **k: m.gaussian_filter(x, 1.3, **k),
    "gaussian_filter1d_order1": lambda m, x, **k: m.gaussian_filter1d(
        x, 2.0, 0, order=1, mode="mirror", **k),
    "gaussian_laplace": lambda m, x, **k: m.gaussian_laplace(x, 0.9, **k),
    "gaussian_gradient_magnitude": lambda m, x, **k:
        m.gaussian_gradient_magnitude(x, 1.1, mode="nearest", **k),
    "sobel": lambda m, x, **k: m.sobel(x, 0, mode="wrap", **k),
    "prewitt": lambda m, x, **k: m.prewitt(x, 1, **k),
    "laplace": lambda m, x, **k: m.laplace(x, mode="constant", cval=3, **k),
    "uniform_filter": lambda m, x, **k: m.uniform_filter(x, (3, 2), **k),
    "correlate1d_dyadic": lambda m, x, **k: m.correlate1d(
        x, [-1.0, 0.5, 0.25, -0.125], 1, origin=1, **k),
    "correlate_int_taps": lambda m, x, **k: m.correlate(
        x, [[1, -2, 0], [3, 0, -1]], mode="reflect", **k),
    "convolve_int_taps": lambda m, x, **k: m.convolve(
        x, [[2, 0, -1], [0, 1, 0], [1, 0, -3]], mode="mirror", **k),
}


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.bool_],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("case", sorted(INT_CASES))
def test_integer_outputs_bit_for_bit(case, dtype):
    """Integer inputs keep their dtype: float64 compute, SciPy's paired
    order where the taps are (anti)symmetric, truncation toward zero and
    wraparound (uint8 results of negative sums wrap); bool is trunc != 0."""
    x = _int_input(dtype, (9, 10), 20)
    fn = INT_CASES[case]
    _equal(fn(et, x, device="cpu"), fn(ej, x))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.bool_],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("case", ["gaussian_filter", "correlate1d_dyadic",
                                  "sobel"])
def test_float_input_integer_output(case, dtype):
    """``output=`` an integer dtype on float input, float32 and float64."""
    rs = np.random.RandomState(21)
    x = rs.standard_normal((9, 10)) * 90
    fn = INT_CASES[case]
    _equal(fn(et, x, output=dtype, device="cpu"), fn(ej, x, output=dtype))
    x32 = x.astype(np.float32)
    _equal(fn(et, x32, output=dtype, device="cpu"),
           fn(ej, x32, output=dtype))


def test_uint8_wraparound():
    x = np.array([[0, 40, 0, 20, 255, 0, 7]], dtype=np.uint8)
    got = et.correlate1d(x, [-1.0, 0.5, 0.25], device="cpu")
    _equal(got, ej.correlate1d(x, [-1.0, 0.5, 0.25]))
    # at least one negative sum wrapped to a large value
    assert int(got.max()) > 200


def test_output_dtype_and_array():
    rs = np.random.RandomState(22)
    x = rs.standard_normal((8, 9))
    _close(*_both("gaussian_filter", x, 1.5, output=np.float32), rtol=1e-6)
    out = np.zeros(x.shape, dtype=np.int32)
    res = et.sobel(x * 50, 0, output=out, device="cpu")
    assert res is out
    _equal(out, ej.sobel(x * 50, 0, output=np.int32))
    out = np.zeros(x.shape)
    assert et.correlate(x, np.ones((2, 3)), output=out, device="cpu") is out
    _close(out, ej.correlate(x, np.ones((2, 3))))
    got = et.gaussian_filter1d(x, 1.0, output=torch.float32, device="cpu")
    assert got.dtype == torch.float32


@pytest.mark.parametrize("name", ["gaussian_filter", "gaussian_laplace",
                                  "correlate1d", "correlate",
                                  "uniform_filter"])
def test_float32_stays_float32(name):
    x = np.random.RandomState(23).standard_normal((8, 9)).astype(np.float32)
    args = {"gaussian_filter": (1.2,), "gaussian_laplace": (1.2,),
            "correlate1d": ([0.25, 0.5, 0.25],),
            "correlate": (np.full((3, 2), 0.3),),
            "uniform_filter": (3,)}[name]
    got, want = _both(name, x, *args)
    assert got.dtype == torch.float32
    _close(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# errors


ERROR_CASES = [
    ("gaussian_filter1d", (1.0,), dict(mode="grid-wrap"), ValueError,
     "unsupported filter mode"),
    ("gaussian_filter1d", (-1.0,), {}, ValueError, "sigma must be positive"),
    ("gaussian_filter1d", (1.0,), dict(radius=-2), ValueError,
     "radius must be a nonnegative"),
    ("gaussian_filter1d", (1.0,), dict(order=-1), ValueError,
     "order must be non-negative"),
    ("gaussian_filter", ((1.0, 2.0, 3.0),), {}, ValueError,
     "one entry per"),
    ("correlate1d", ([],), {}, ValueError, "non-empty"),
    ("correlate1d", ([1.0, 2.0, 3.0],), dict(origin=2), ValueError,
     "origin shifts the filter off its support"),
    ("uniform_filter1d", (0,), {}, ValueError, "at least 1"),
    ("correlate", (np.ones(3),), {}, RuntimeError,
     "filter weights array has incorrect shape."),
    ("correlate", (np.ones((0, 3)),), {}, ValueError,
     "weights must not be empty"),
    ("correlate", (np.ones((3, 3)),), dict(mode="bogus"), RuntimeError,
     "boundary mode not supported"),
    ("convolve", (np.ones((3, 3)),), dict(origin=(2, 0)), ValueError,
     "invalid origin"),
    ("correlate", (np.ones((3, 3)),), dict(origin=(0, 0, 0)), RuntimeError,
     "origin must have length"),
    ("sobel", (), dict(output=np.zeros((2, 2))), RuntimeError,
     "output shape not correct"),
]


@pytest.mark.parametrize("case", ERROR_CASES,
                         ids=[f"{c[0]}-{c[4][:24]}" for c in ERROR_CASES])
def test_errors_match(case):
    name, args, kw, exc, msg = case
    x = np.zeros((5, 6))
    with pytest.raises(exc, match=msg):
        getattr(ej, name)(x, *args, **kw)
    with pytest.raises(exc, match=msg):
        getattr(et, name)(x, *args, device="cpu", **kw)


def test_complex_input_raises():
    with pytest.raises(TypeError):
        et.gaussian_filter(np.ones((4, 4), np.complex64), 1.0, device="cpu")


# ---------------------------------------------------------------------------
# gradients through Correlate1d and CorrelateNd


def _vjp_check(port_fn, jax_fn, x, seed):
    g = np.random.RandomState(seed).standard_normal(
        np.shape(jax_fn(jnp.asarray(x))))
    xt = torch.tensor(x, requires_grad=True)
    (got,) = torch.autograd.grad(port_fn(xt), xt, torch.as_tensor(g))
    _, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    _close(got, vjp(jnp.asarray(g))[0], rtol=GRAD)


@pytest.mark.parametrize("mode", MODES)
def test_gradient_gaussian_and_correlate1d(mode):
    x = np.random.RandomState(24).standard_normal((7, 9))
    _vjp_check(lambda a: et.gaussian_filter(a, (1.2, 5.0), mode=mode,
                                            cval=0.5, device="cpu"),
               lambda a: ej.gaussian_filter(a, (1.2, 5.0), mode=mode,
                                            cval=0.5), x, 1)
    w = [0.3, -1.2, 2.0, 0.7]
    _vjp_check(lambda a: et.correlate1d(a, w, 0, mode=mode, origin=-1,
                                        device="cpu"),
               lambda a: ej.correlate1d(a, w, 0, mode=mode, origin=-1),
               x, 2)
    _vjp_check(lambda a: et.uniform_filter1d(a, 4, 1, mode=mode,
                                             device="cpu"),
               lambda a: ej.uniform_filter1d(a, 4, 1, mode=mode), x, 3)


@pytest.mark.parametrize("name", ["gaussian_laplace",
                                  "gaussian_gradient_magnitude", "sobel",
                                  "laplace"])
def test_gradient_derived_filters(name):
    """(Not mirror: its antisymmetric derivatives vanish at the corners,
    where the gradient magnitude's root has no derivative.)"""
    x = np.random.RandomState(25).standard_normal((6, 7, 8))
    args = (1.3,) if name.startswith("gaussian") else ()
    _vjp_check(lambda a: getattr(et, name)(a, *args, mode="reflect",
                                           device="cpu"),
               lambda a: getattr(ej, name)(a, *args, mode="reflect"), x, 4)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["correlate", "convolve"])
def test_gradient_correlate_nd(name, mode):
    rs = np.random.RandomState(26)
    x = rs.standard_normal((5, 6, 7))
    w = rs.standard_normal((3, 2, 4)) * (rs.rand(3, 2, 4) > 0.25)
    kw = dict(mode=mode, cval=0.5, origin=(1, 0, -1))
    _vjp_check(lambda a: getattr(et, name)(a, w, device="cpu", **kw),
               lambda a: getattr(ej, name)(a, w, **kw), x, 5)
    w2 = rs.standard_normal((5, 3))
    _vjp_check(lambda a: getattr(et, name)(a, w2, axes=(2, 0), mode=mode,
                                           device="cpu"),
               lambda a: getattr(ej, name)(a, w2, axes=(2, 0), mode=mode),
               x, 6)


# ---------------------------------------------------------------------------
# the plain versions of the kernels against dense matrices


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [1, 2, 5])
def test_k8_k8t_plain_against_filter_matrix(n, mode):
    """K8's twin is ``M x + cval b`` and K8T's ``M^T g`` (constant pads
    dropped), for every centre of 1-9 taps, on lines shorter than the
    taps too; the paired order equals the direct one to round-off."""
    rs = np.random.RandomState(27 + n)
    for L in (1, 2, 4, 9):
        w = rs.standard_normal(L)
        for c in range(L):
            M, b = tf.filter_matrix(n, tuple(w.tolist()), mode, c)
            x = rs.standard_normal((3, n))
            got = tf.correlate1d_plain(torch.as_tensor(x), w, 1, mode, 0.7, c)
            np.testing.assert_allclose(got.numpy(), x @ M.T + 0.7 * b,
                                       rtol=1e-13, atol=1e-13)
            got = tf.correlate1d_transpose_plain(torch.as_tensor(x), w, 1,
                                                 mode, c)
            np.testing.assert_allclose(got.numpy(), x @ M, rtol=1e-13,
                                       atol=1e-13)
        if L & 1:
            ws = np.concatenate([w[:L // 2 + 1], w[:L // 2][::-1]])
            wa = np.concatenate([w[:L // 2], [0.0], -w[:L // 2][::-1]])
            for pair, ww in ((1, ws), (-1, wa)):
                assert tf._scipy_pair_class(ww) == pair or L == 1
                x = torch.as_tensor(rs.standard_normal((2, n)))
                np.testing.assert_allclose(
                    tf.correlate1d_plain(x, ww, 1, mode, 0.3, L // 2,
                                         pair).numpy(),
                    tf.correlate1d_plain(x, ww, 1, mode, 0.3,
                                         L // 2).numpy(),
                    rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("mode", MODES)
def test_k9_k9t_plain_against_dense_transpose(mode):
    """K9T's twin is the transpose of K9's linear part: both applied to the
    unit basis of a short 2-D array."""
    rs = np.random.RandomState(31)
    shape = (3, 4)
    w = rs.standard_normal((4, 3)) * (rs.rand(4, 3) > 0.3)
    centers = (3, 0)
    n = int(np.prod(shape))
    eye = torch.eye(n, dtype=torch.float64).reshape(n, *shape)
    fwd = np.stack([tf.correlate_nd_plain(e, w, centers, mode, 0.0)
                    .reshape(-1).numpy() for e in eye], 1)
    adj = np.stack([tf.correlate_nd_transpose_plain(e, w, centers, mode)
                    .reshape(-1).numpy() for e in eye], 1)
    np.testing.assert_allclose(adj, fwd.T, rtol=1e-13, atol=1e-13)


def test_fold_lists_and_batch_axes():
    """Each pad position lands in the list of the position it folds to;
    runs of axes where the kernel has extent 1 merge."""
    for mode in MODES:
        ptr, pos = tf.fold_lists(4, 3, 6, mode)
        assert len(ptr) == 5 and list(pos[ptr[:-1]]) == [0, 1, 2, 3]
        for j in range(4):
            for p in pos[ptr[j]:ptr[j + 1]]:
                assert p == j or tf._fold_index(int(p), 4, mode) == j
        assert len(pos) == (4 if mode == "constant" else 13)
    assert tf.nd_geometry((2, 3, 4, 5, 6), (1, 1, 3, 1, 1)) == (
        [6, 4, 30], [0, 0, 1, 2, 2], [True, False, True])


# ---------------------------------------------------------------------------
# the kernels on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k8_k8t_match_plain_on_card(cuda_device, dtype, mode):
    rs = np.random.RandomState(32)
    for shape, axis, L in (((5, 300), 1, 17), ((7, 9, 6), 1, 4),
                           ((4, 5), 0, 11)):
        x = torch.as_tensor(rs.standard_normal(shape), dtype=dtype,
                            device=cuda_device)
        w = rs.standard_normal(L)
        for c in (0, L // 2, L - 1):
            assert torch.equal(tf.correlate1d(x, w, axis, mode, 0.5, c),
                               tf.correlate1d_plain(x, w, axis, mode, 0.5, c))
            got = tf.correlate1d_transpose(x, w, axis, mode, c)
            want = tf.correlate1d_transpose_plain(x, w, axis, mode, c)
            tol = 1e-5 if dtype == torch.float32 else 1e-10
            torch.testing.assert_close(got, want, rtol=tol, atol=tol * 10)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k9_k9t_match_plain_on_card(cuda_device, dtype, mode):
    rs = np.random.RandomState(33)
    x = torch.as_tensor(rs.standard_normal((2, 9, 10, 11)), dtype=dtype,
                        device=cuda_device)
    w = rs.standard_normal((1, 3, 4, 5)) * (rs.rand(1, 3, 4, 5) > 0.3)
    centers = (0, 2, 1, 2)
    assert torch.equal(tf.correlate_nd(x, w, centers, mode, 0.5),
                       tf.correlate_nd_plain(x, w, centers, mode, 0.5))
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    torch.testing.assert_close(
        tf.correlate_nd_transpose(x, w, centers, mode),
        tf.correlate_nd_transpose_plain(x, w, centers, mode), rtol=tol,
        atol=tol * 10)
    # nine axes left after merging the batch axes: more than the kernels
    # take
    y = torch.zeros((2,) * 9, dtype=dtype, device=cuda_device)
    with pytest.raises(ValueError, match="at most 8"):
        tf.correlate_nd(y, np.ones((2, 1) * 4 + (2,)), (0, 0) * 4 + (0,),
                        mode, 0.0)
