"""The port's general resampler with the classic modes, against the JAX
package on the CPU.

The same numpy inputs (made from a seed) go through ``elasticdeform_tpu``
(CPU, float64, as ``conftest.py`` sets) and the port with ``device="cpu"``,
where kernels K1c, K3c and K5c take their plain versions:

* ``map_coordinates`` (+ ``_batch``), ``deform_field`` (+ ``_batch``) and
  the numpy API forward: float64 ``rtol=1e-10, atol=1e-12*max|ref|``,
  integer outputs bit for bit;
* ``map_coordinates_gradient`` and autograd to X, the coordinates and the
  field against the JAX gradient API and ``jax.vjp``: ``1e-9``;
* the shape checks with the reference's messages.

Tests marked ``cuda`` hold K1c, K3c and K5c against their plain versions
and run only where a card is.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import elasticdeform_tpu as ej
from elasticdeform_tpu import api as ja

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch import api as ta
from elasticdeform_tpu_torch.ops import resample as tr
from elasticdeform_tpu_torch.ops import resample_bwd as trb

MODES = ["nearest", "wrap", "reflect", "mirror", "constant"]
FWD, GRAD = 1e-10, 1e-9


def _close(got, want, rtol=FWD):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * scale)


def _coords(rs, in_shape, out_shape, margin=6.0):
    """Sample coordinates up to ``margin`` voxels past every edge."""
    return np.stack([rs.uniform(-margin, n - 1 + margin, size=out_shape)
                     for n in in_shape])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("order", range(6))
def test_map_coordinates_2d(order, mode):
    rs = np.random.RandomState(order * 5 + MODES.index(mode))
    X = rs.rand(40, 53)
    c = _coords(rs, X.shape, (31, 27))
    kw = dict(order=order, mode=mode, cval=-1.25)
    _close(et.map_coordinates(X, c, device="cpu", **kw),
           ej.map_coordinates(X, c, **kw))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("order", [1, 3])
def test_map_coordinates_3d(order, mode):
    rs = np.random.RandomState(40 + order)
    X = rs.rand(17, 23, 19)
    c = _coords(rs, X.shape, (9, 11, 7))
    kw = dict(order=order, mode=mode, cval=0.5)
    _close(et.map_coordinates(X, c, device="cpu", **kw),
           ej.map_coordinates(X, c, **kw))


@pytest.mark.parametrize("case", ["flat", "channels", "no_prefilter",
                                  "4d_rank", "float32_coords"])
def test_map_coordinates_options(case):
    rs = np.random.RandomState(3)
    kw = dict(order=3, mode="mirror")
    if case == "flat":
        # scipy semantics: the output shape is coordinates.shape[1:]
        X = rs.rand(30, 40)
        c = _coords(rs, X.shape, (257,))
    elif case == "channels":
        X = rs.rand(3, 26, 31)
        c = _coords(rs, (26, 31), (20, 22))
        kw.update(axis=(1, 2), mode="nearest")
    elif case == "no_prefilter":
        X = rs.rand(24, 28)
        c = _coords(rs, X.shape, (15, 17))
        kw.update(prefilter=False, mode="constant", cval=2.0)
    elif case == "4d_rank":
        X = rs.rand(9, 10, 8, 11)
        c = _coords(rs, X.shape, (5, 6, 4, 7), margin=2.0)
    else:
        # float64 input, float32 coordinates: float64 compute
        X = rs.rand(20, 25)
        c = _coords(rs, X.shape, (14, 15)).astype(np.float32)
    got = et.map_coordinates(X, c, device="cpu", **kw)
    _close(got, ej.map_coordinates(X, c, **kw))
    if case == "flat":
        assert tuple(got.shape) == (257,)


def test_map_coordinates_float32():
    """float32 input and coordinates compute in float32 in both packages;
    their prefilter products sum in other orders, so float32 tolerances."""
    rs = np.random.RandomState(4)
    X = rs.rand(20, 25).astype(np.float32)
    c = _coords(rs, X.shape, (14, 15)).astype(np.float32)
    got = et.map_coordinates(X, c, order=3, mode="mirror", device="cpu")
    want = np.asarray(ej.map_coordinates(X, c, order=3, mode="mirror"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
@pytest.mark.parametrize("prefilter", [True, False])
def test_map_coordinates_integer(dtype, prefilter):
    """Integer inputs are prefiltered in float with no per-axis integer
    writeback (scipy's map_coordinates, unlike deform_grid), then rounded
    and clamped: bit for bit."""
    rs = np.random.RandomState(5)
    X = (rs.rand(22, 26) * 200).astype(dtype)
    c = _coords(rs, X.shape, (14, 15), margin=0.0)
    kw = dict(order=3, mode="mirror", prefilter=prefilter)
    got = et.map_coordinates(X, c, device="cpu", **kw).numpy()
    want = np.asarray(ej.map_coordinates(X, c, **kw))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["plain", "channels_constant"])
def test_map_coordinates_batch(case):
    rs = np.random.RandomState(6)
    B = 3
    if case == "plain":
        X = rs.rand(B, 20, 24, 18)
        c = np.stack([_coords(rs, X.shape[1:], (12, 13, 9))
                      for _ in range(B)])
        kw = dict(order=3, mode="mirror")
    else:
        X = rs.rand(B, 3, 22, 25)
        c = np.stack([_coords(rs, (22, 25), (14, 16)) for _ in range(B)])
        kw = dict(order=3, mode="constant", cval=0.75, axis=(1, 2))
    _close(et.map_coordinates_batch(X, c, device="cpu", **kw),
           ej.map_coordinates_batch(X, c, **kw))


@pytest.mark.parametrize("case", ["channel_rank", "coordinates_shape",
                                  "batch_axis", "x_shape", "list_input",
                                  "bad_mode", "complex"])
def test_shape_and_argument_checks(case):
    """The same exception types and messages as the JAX package."""
    rs = np.random.RandomState(7)
    X = rs.rand(3, 26, 31)
    if case == "channel_rank":
        args = (X, _coords(rs, (26, 31), (440,)))
        kw, exc, match = dict(axis=(1, 2)), ValueError, "channel"
    elif case == "coordinates_shape":
        args, kw = (X[0], np.zeros((3, 10, 10))), {}
        exc, match = ValueError, "coordinates"
    elif case == "batch_axis":
        with pytest.raises(ValueError, match="batch"):
            ej.map_coordinates_batch(X, np.zeros((2, 2, 20, 20)))
        with pytest.raises(ValueError, match="batch"):
            et.map_coordinates_batch(X, np.zeros((2, 2, 20, 20)),
                                     device="cpu")
        return
    elif case == "x_shape":
        with pytest.raises(ValueError, match="X_shape"):
            ej.map_coordinates_gradient(np.zeros((5, 5)),
                                        np.zeros((2, 5, 5)))
        with pytest.raises(ValueError, match="X_shape"):
            et.map_coordinates_gradient(np.zeros((5, 5)),
                                        np.zeros((2, 5, 5)), device="cpu")
        return
    elif case == "list_input":
        args, kw = ([X[0], X[1]], np.zeros((2, 4, 4))), {}
        exc, match = ValueError, "single input"
    elif case == "bad_mode":
        args, kw = (X[0], np.zeros((2, 4, 4))), dict(mode="grid-bogus")
        exc, match = RuntimeError, "boundary mode"
    else:
        # complex stays out of the port for now (the JAX package splits it)
        with pytest.raises(TypeError, match="not supported"):
            et.map_coordinates(X[0] + 1j * X[1], np.zeros((2, 4, 4)),
                               device="cpu")
        return
    with pytest.raises(exc, match=match):
        ej.map_coordinates(*args, **kw)
    with pytest.raises(exc, match=match):
        et.map_coordinates(*args, device="cpu", **kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("order", [0, 1, 3, 5])
def test_map_coordinates_gradient(order, mode):
    rs = np.random.RandomState(50 + order)
    c = _coords(rs, (21, 18), (13, 17))
    dY = rs.randn(13, 17)
    kw = dict(order=order, mode=mode, cval=0.5, X_shape=(21, 18))
    _close(et.map_coordinates_gradient(dY, c, device="cpu", **kw),
           ej.map_coordinates_gradient(dY, c, **kw), GRAD)


def test_map_coordinates_gradient_channels_and_adjoint():
    """With channel axes; and the adjoint identity <dy, M x> == <M^T dy,
    x> of the port's forward and gradient in float64."""
    rs = np.random.RandomState(8)
    X = rs.rand(2, 21, 26, 18)
    c = _coords(rs, X.shape[1:], (13, 17, 11))
    dY = rs.randn(2, 13, 17, 11)
    kw = dict(order=3, mode="reflect", axis=(1, 2, 3))
    gx = et.map_coordinates_gradient(dY, c, X_shape=X.shape, device="cpu",
                                     **kw)
    _close(gx, ej.map_coordinates_gradient(dY, c, X_shape=X.shape, **kw),
           GRAD)
    y = et.map_coordinates(X, c, device="cpu", **kw).numpy()
    lhs, rhs = float(np.vdot(dY, y)), float(np.vdot(gx.numpy(), X))
    assert abs(lhs - rhs) <= 1e-12 * np.abs(dY * y).sum()


def _vjp_both(fn_j, fn_t, X, c, G):
    """Gradients to X and to the coordinates: JAX's vjp and torch autograd
    through the port."""
    _, vjp = jax.vjp(fn_j, jnp.asarray(X), jnp.asarray(c))
    want = vjp(jnp.asarray(G))
    xt = torch.tensor(X, requires_grad=True)
    ct = torch.tensor(c, requires_grad=True)
    got = torch.autograd.grad(fn_t(xt, ct), (xt, ct), torch.tensor(G))
    return got, want


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("order", [1, 2, 3, 5])
def test_autograd_to_x_and_coordinates(order, mode):
    rs = np.random.RandomState(60 + order)
    X = rs.rand(13, 11)
    c = _coords(rs, X.shape, (7, 6), margin=4.0)
    # coordinates exactly on the edges: nearest and constant clip there,
    # where jnp.clip passes half the gradient
    c[0, 0, :3] = (0.0, 12.0, 5.0)
    c[1, 1, :3] = (10.0, 0.0, 10.0)
    G = rs.randn(7, 6)
    kw = dict(order=order, mode=mode, cval=0.5)
    got, want = _vjp_both(
        lambda x, cc: ej.map_coordinates(x, cc, **kw),
        lambda x, cc: et.map_coordinates(x, cc, device="cpu", **kw), X, c, G)
    for a, b in zip(got, want):
        _close(a, b, GRAD)


def test_autograd_batch_channels():
    rs = np.random.RandomState(9)
    X = rs.rand(2, 3, 12, 14)
    c = np.stack([_coords(rs, (12, 14), (8, 9)) for _ in range(2)])
    G = rs.randn(2, 3, 8, 9)
    kw = dict(order=3, mode="constant", cval=0.25, axis=(1, 2))
    got, want = _vjp_both(
        lambda x, cc: ej.map_coordinates_batch(x, cc, **kw),
        lambda x, cc: et.map_coordinates_batch(x, cc, device="cpu", **kw),
        X, c, G)
    for a, b in zip(got, want):
        _close(a, b, GRAD)


@pytest.mark.parametrize("mode", ["mirror", "constant"])
def test_deform_field_matches_deform(mode):
    """deform_field on the JAX package's displacement_field of a grid
    equals deform with that grid."""
    rs = np.random.RandomState(10)
    X = rs.rand(33, 47)
    d = rs.randn(2, 4, 3) * 6
    field = np.asarray(ej.displacement_field(d, X.shape))
    kw = dict(order=3, mode=mode, cval=0.25)
    got = et.deform_field(X, field, device="cpu", **kw)
    _close(got, ej.deform(X, d, **kw))
    _close(got, ej.deform_field(X, field, **kw))


def test_deform_field_batch_and_autograd():
    rs = np.random.RandomState(11)
    B = 3
    X = rs.rand(B, 16, 18)
    field = rs.randn(B, 2, 16, 18) * 2
    G = rs.randn(B, 16, 18)
    kw = dict(order=3, mode="mirror")
    _close(et.deform_field_batch(X, field, device="cpu", **kw),
           ej.deform_field_batch(X, field, **kw))
    got, want = _vjp_both(
        lambda x, f: ej.deform_field_batch(x, f, **kw),
        lambda x, f: et.deform_field_batch(x, f, device="cpu", **kw),
        X, field, G)
    for a, b in zip(got, want):
        _close(a, b, GRAD)


def test_numpy_api():
    """api.map_coordinates / map_coordinates_gradient /
    geometric_transform: numpy in and out, as the JAX package's."""
    rs = np.random.RandomState(12)
    X = rs.rand(22, 27, 16)
    c = _coords(rs, X.shape, (12, 14, 9))
    got = ta.map_coordinates(X, c, order=3, mode="reflect", device="cpu")
    assert isinstance(got, np.ndarray)
    _close(got, ja.map_coordinates(X, c, order=3, mode="reflect"))
    dy = rs.rand(12, 14, 9)
    kw = dict(order=3, mode="reflect", X_shape=X.shape)
    _close(ta.map_coordinates_gradient(dy, c, device="cpu", **kw),
           ja.map_coordinates_gradient(dy, c, **kw), GRAD)
    X2 = rs.rand(14, 16)

    def mapping(cc):
        return (cc[0] * 0.9 + 0.7, cc[1] * 1.1 - 1.2)

    _close(ta.geometric_transform(X2, mapping, order=3, mode="wrap",
                                  device="cpu"),
           ja.geometric_transform(X2, mapping, order=3, mode="wrap"))
    Xu = (X2 * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        ta.map_coordinates(Xu, c[:2, :, :, 0], order=1, mode="mirror",
                           device="cpu"),
        ja.map_coordinates(Xu, c[:2, :, :, 0], order=1, mode="mirror"))


def test_plain_twins_at_coordinates_match_the_deform_twins():
    """K1c's, K3c's and K5c's plain versions at coordinates affine(j) +
    offset + displ equal K1's, K3's and K5's plain versions, to the
    rounding of the coordinate sum."""
    rs = np.random.RandomState(13)
    coeffs = torch.as_tensor(rs.rand(2, 9, 11, 2))
    displ = torch.as_tensor(rs.randn(2, 2, 7, 8) * 4)
    g = torch.as_tensor(rs.randn(2, 7, 8, 2))
    coords = torch.stack(tr.sample_coordinates(displ, None, (1, 2)), 1)
    for mode in range(5):
        args = (displ, None, (1, 2), 3, mode)
        torch.testing.assert_close(
            tr.resample_coords_plain(coeffs, coords, 3, mode, 0.5),
            tr.resample_plain(coeffs, *args, 0.5), rtol=0, atol=0)
        torch.testing.assert_close(
            trb.resample_coords_transpose_plain(g, coords, 3, mode, (9, 11)),
            trb.resample_transpose_plain(g, *args, (9, 11)), rtol=0, atol=0)
        torch.testing.assert_close(
            trb.resample_coords_grad_plain(coeffs, g, coords, 3, mode),
            trb.resample_coord_grad_plain(coeffs, g, *args), rtol=0, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("order", range(6))
@pytest.mark.parametrize("mode", range(5))
def test_coordinate_kernels_match_plain(cuda_device, order, mode):
    """K1c and K5c bit for bit, K3c to float64 rounding, flat outputs."""
    rs = np.random.RandomState(order * 5 + mode)
    coeffs = torch.as_tensor(rs.rand(2, 9, 11, 8, 2), device=cuda_device)
    coords = torch.as_tensor(rs.uniform(-20, 30, (2, 3, 57)),
                             device=cuda_device)
    g = torch.as_tensor(rs.randn(2, 57, 2), device=cuda_device)
    assert torch.equal(tr.resample_coords(coeffs, coords, order, mode, 0.5),
                       tr.resample_coords_plain(coeffs, coords, order, mode,
                                                0.5))
    assert torch.equal(
        trb.resample_coords_grad(coeffs, g, coords, order, mode),
        trb.resample_coords_grad_plain(coeffs, g, coords, order, mode))
    torch.testing.assert_close(
        trb.resample_coords_transpose(g, coords, order, mode, (9, 11, 8)),
        trb.resample_coords_transpose_plain(g, coords, order, mode,
                                            (9, 11, 8)),
        rtol=1e-10, atol=1e-10)
