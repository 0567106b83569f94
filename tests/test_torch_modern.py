"""The port's SciPy >= 1.6 boundary modes, scipy-convention resamplers and
spline filters, against the JAX package on the CPU.

The same numpy inputs (made from a seed) go through ``elasticdeform_tpu``
(CPU, float64, as ``conftest.py`` sets) and the port with ``device="cpu"``,
where kernels K1c, K3c, K5c, K2, K4, K6 and K7 take their plain versions:

* ``map_coordinates`` with the grid modes, ``affine_transform``, ``shift``,
  ``zoom``, ``rotate`` and ``geometric_transform`` with all eight mode
  names, ``spline_filter`` and ``spline_filter1d``: float64
  ``rtol=1e-10, atol=1e-12*max|ref|``, integer outputs bit for bit;
* gradients to X, the coordinates, ``matrix``/``offset``, ``shift`` and a
  ``geometric_transform`` parameter against ``jax.vjp``: ``1e-9``;
* K6's and K7's plain versions (``filter_matrix_bc`` and its transpose)
  against the JAX package's matrices, and a numpy model of the kernels'
  recursion against those matrices;
* the ring pads against ``numpy.pad`` and their transposes.

Tests marked ``cuda`` hold K6 and K7 against their plain versions and run
only where a card is.
"""

import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import elasticdeform_tpu as ej
from elasticdeform_tpu.ops import prefilter as jp

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch import core as tc
from elasticdeform_tpu_torch.ops import prefilter as tp

GRID_MODES = ["grid-mirror", "grid-wrap", "grid-constant"]
ALL_MODES = ["nearest", "wrap", "reflect", "mirror", "constant"] + GRID_MODES
FWD, GRAD = 1e-10, 1e-9


def _close(got, want, rtol=FWD):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * scale)


@pytest.mark.parametrize("mode", GRID_MODES)
@pytest.mark.parametrize("order", range(6))
def test_map_coordinates_grid_modes_2d(order, mode):
    rs = np.random.RandomState(order)
    x = rs.standard_normal((9, 12))
    # up to 25 voxels outside the extent
    cc = np.stack([rs.uniform(-22, 34, (150,)), rs.uniform(-22, 34, (150,))])
    kw = dict(order=order, mode=mode, cval=1.25)
    _close(et.map_coordinates(x, cc, device="cpu", **kw),
           ej.map_coordinates(x, cc, **kw))


@pytest.mark.parametrize("mode", GRID_MODES)
@pytest.mark.parametrize("case", ["1d", "3d", "no_prefilter", "channels",
                                  "batch"])
def test_map_coordinates_grid_modes_cases(case, mode):
    rs = np.random.RandomState(20)
    kw = dict(order=3, mode=mode, cval=-0.5)
    if case == "1d":
        x, cc = rs.standard_normal(13), rs.uniform(-30, 42, (1, 200))
    elif case == "3d":
        x = rs.standard_normal((7, 8, 9))
        cc = np.stack([rs.uniform(-10, 18, (5, 11)) for _ in range(3)])
    elif case == "no_prefilter":
        x = rs.standard_normal((10, 11))
        cc = np.stack([rs.uniform(-6, 16, (80,)) for _ in range(2)])
        kw["prefilter"] = False
    elif case == "channels":
        x = rs.standard_normal((3, 10, 11))
        cc = np.stack([rs.uniform(-3, 14, (6, 7)) for _ in range(2)])
        kw["axis"] = (1, 2)
    else:
        x = rs.standard_normal((3, 9, 10))
        cc = np.stack([np.stack([rs.uniform(-3, 12, (5, 6)),
                                 rs.uniform(-3, 12, (5, 6))])
                       for _ in range(3)])
        _close(et.map_coordinates_batch(x, cc, device="cpu", **kw),
               ej.map_coordinates_batch(x, cc, **kw))
        return
    _close(et.map_coordinates(x, cc, device="cpu", **kw),
           ej.map_coordinates(x, cc, **kw))


def test_grid_modes_integer_and_float32():
    """Integer inputs compute in float32 on the modern path, as in the JAX
    package, and round bit for bit; float32 inputs agree to float32."""
    rs = np.random.RandomState(21)
    x = rs.randint(0, 200, (9, 11)).astype(np.uint8)
    cc = np.stack([rs.uniform(-4, 13, (60,)), rs.uniform(-4, 13, (60,))])
    for mode in GRID_MODES:
        kw = dict(order=3, mode=mode, cval=7.0)
        got = et.map_coordinates(x, cc, device="cpu", **kw).numpy()
        np.testing.assert_array_equal(got, ej.map_coordinates(x, cc, **kw))
        xf = x.astype(np.float32) / 7
        np.testing.assert_allclose(
            et.map_coordinates(xf, cc, device="cpu", **kw).numpy(),
            ej.map_coordinates(xf, cc, **kw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ALL_MODES)
def test_affine_transform_modes(mode):
    rs = np.random.RandomState(22)
    x = rs.standard_normal((9, 10))
    m = np.array([[0.8, 0.1], [-0.2, 1.1]])
    kw = dict(offset=(-2.5, 1.5), order=3, mode=mode, cval=0.75)
    _close(et.affine_transform(x, m, device="cpu", **kw),
           ej.affine_transform(x, m, **kw))


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("order", [0, 1, 3, 5])
def test_shift_modes(mode, order):
    x = np.random.RandomState(23).standard_normal((12,))
    kw = dict(order=order, mode=mode, cval=1.25)
    _close(et.shift(x, 3.4, device="cpu", **kw), ej.shift(x, 3.4, **kw))


@pytest.mark.parametrize("mode", ALL_MODES)
def test_rotate_and_geometric_transform_modes(mode):
    rs = np.random.RandomState(24)
    x = rs.standard_normal((10, 13))
    kw = dict(order=3, mode=mode, cval=0.3)
    _close(et.rotate(x, 33.0, device="cpu", **kw), ej.rotate(x, 33.0, **kw))

    def mapping(c):
        return (c[0] - 2.3, c[1] * 1.07 + 1.7)

    _close(et.geometric_transform(x, mapping, device="cpu", **kw),
           ej.geometric_transform(x, mapping, **kw))


@pytest.mark.parametrize("mode", ["grid-constant", "grid-mirror", "nearest",
                                  "mirror", "grid-wrap"])
@pytest.mark.parametrize("zf", [0.6, 1.7])
@pytest.mark.parametrize("grid_mode", [True, False])
def test_zoom_modes(mode, zf, grid_mode):
    x = np.random.RandomState(25).standard_normal((11, 9))
    kw = dict(order=3, mode=mode, cval=0.1, grid_mode=grid_mode)
    _close(et.zoom(x, zf, device="cpu", **kw), ej.zoom(x, zf, **kw))


@pytest.mark.parametrize("case", ["rotate_3d_plane", "affine_forms",
                                  "zoom_per_axis", "geometric_extra_args",
                                  "shift_channels"])
def test_resampler_options(case):
    rs = np.random.RandomState(26)
    if case == "rotate_3d_plane":
        x = rs.rand(4, 20, 24)
        args, kw = (40.0,), dict(axes=(1, 2), order=3, mode="mirror")
        fn = "rotate"
    elif case == "affine_forms":
        x = rs.rand(24, 30)
        H = np.eye(3)
        H[:2, :2] = np.diag([1.25, 0.8])
        H[:2, 2] = (2.0, -1.5)
        for m, kw in ((np.array([1.25, 0.8]), dict(offset=(2.0, -1.5))),
                      (H, {})):
            kw.update(order=3, mode="nearest", output_shape=(16, 18))
            _close(et.affine_transform(x, m, device="cpu", **kw),
                   ej.affine_transform(x, m, **kw))
        return
    elif case == "zoom_per_axis":
        x = rs.rand(23, 30)
        args, kw, fn = ((1.4, 0.7),), dict(order=3, mode="reflect"), "zoom"
    elif case == "geometric_extra_args":
        x = rs.rand(15, 14, 6)

        def mapping(c, sy, sx):
            return (c[0] * sy, c[1] * sx, c[2] + 0.5)

        args = (mapping,)
        kw = dict(output_shape=(8, 9, 6), order=3, mode="constant",
                  cval=-1.0, extra_arguments=(1.3, 0.8))
        fn = "geometric_transform"
    else:
        x = rs.rand(3, 12, 14)
        args, kw = ((1.5, -2.25),), dict(axis=(1, 2), order=3,
                                          mode="grid-wrap")
        fn = "shift"
    _close(getattr(et, fn)(x, *args, device="cpu", **kw),
           getattr(ej, fn)(x, *args, **kw))


def test_argument_checks():
    rs = np.random.RandomState(27)
    x = rs.rand(20, 22)
    for mod in (ej, et):
        dev = {} if mod is ej else {"device": "cpu"}
        with pytest.raises(ValueError, match="matrix"):
            mod.affine_transform(x, np.eye(3)[:2], **dev)
        with pytest.raises(ValueError, match="output_shape"):
            mod.affine_transform(x, np.eye(2), output_shape=(5,), **dev)
        with pytest.raises(ValueError, match="zoom"):
            mod.zoom(x, (1.0, 2.0, 3.0), **dev)
        with pytest.raises(RuntimeError, match="boundary mode"):
            mod.spline_filter1d(x, order=3, mode="no-such-mode", **dev)
        with pytest.warns(UserWarning, match="grid-constant"):
            mod.zoom(x, 1.3, mode="constant", grid_mode=True, **dev)
    with pytest.raises(TypeError, match="not supported"):
        et.affine_transform(x.astype(np.float16), np.eye(2), device="cpu")


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_spline_filter1d_modes(mode, order):
    x = np.random.RandomState(28).standard_normal((9, 14))
    kw = dict(order=order, axis=1, mode=mode)
    _close(et.spline_filter1d(x, device="cpu", **kw),
           ej.spline_filter1d(x, **kw))


@pytest.mark.parametrize("case", ["float32_output_array", "int_input",
                                  "default_axis", "axis_subset"])
def test_spline_filter_output_contract(case):
    rs = np.random.RandomState(29)
    if case == "float32_output_array":
        x = rs.standard_normal((8, 9)).astype(np.float32)
        outs = [np.zeros_like(x), np.zeros_like(x)]
        for mod, out in zip((et, ej), outs):
            dev = {"device": "cpu"} if mod is et else {}
            ret = mod.spline_filter(x, order=3, mode="grid-wrap", output=out,
                                    **dev)
            assert ret is out
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5)
        return
    if case == "int_input":
        x = rs.randint(0, 100, (8, 9)).astype(np.int16)
        kw = dict(order=3, mode="reflect")
        _close(et.spline_filter(x, device="cpu", **kw),
               ej.spline_filter(x, **kw))
        _close(et.spline_filter1d(x, device="cpu", output=np.float64, **kw),
               ej.spline_filter1d(x, output=np.float64, **kw))
        return
    x = rs.standard_normal((6, 10, 5))
    kw = dict(order=4, mode="nearest")
    if case == "default_axis":
        _close(et.spline_filter1d(x, device="cpu", **kw),
               ej.spline_filter1d(x, **kw))
    else:
        _close(et.spline_filter(x, axis=(0, 2), device="cpu", **kw),
               ej.spline_filter(x, axis=(0, 2), **kw))


def _vjp(fn_j, fn_t, primals, cot):
    """The vjp of ``fn_j`` (JAX) and of ``fn_t`` (the port, by autograd)
    at the same float64 primals and cotangent."""
    _, vjp = jax.vjp(fn_j, *[jnp.asarray(p) for p in primals])
    want = vjp(jnp.asarray(cot))
    ts = [torch.tensor(p, requires_grad=True) for p in primals]
    got = torch.autograd.grad(fn_t(*ts), ts, torch.tensor(cot))
    return got, want


@pytest.mark.parametrize("mode", GRID_MODES + ["reflect", "nearest"])
@pytest.mark.parametrize("order", [1, 3, 5])
def test_autograd_modern_map_coordinates(mode, order):
    """Through the modern path (pads, prefilter with the mode's boundary
    condition, the mode's coordinate fold) to X and to the coordinates; a
    coordinate lies exactly on the nearest / grid-constant clip bound,
    where jnp.clip passes half the gradient."""
    rs = np.random.RandomState(30 + order)
    X = rs.standard_normal((9, 8))
    cc = np.stack([rs.uniform(-12, 20, (7, 6)), rs.uniform(-12, 20, (7, 6))])
    npad = 12 if order > 1 else 0
    cc[0, 0, 0] = -(npad + order + 2)
    cc[1, 0, 1] = 7 + npad + order + 2
    G = rs.standard_normal((7, 6))
    kw = dict(order=order, mode=mode, cval=0.4)
    if mode in GRID_MODES:
        def fj(x, c):
            return ej.map_coordinates(x, c, **kw)

        def ft(x, c):
            return et.map_coordinates(x, c, device="cpu", **kw)
    else:
        # reflect and nearest take their modern meaning on the
        # scipy-convention resamplers
        def fj(x, c):
            return ej.geometric_transform(x, lambda o: (c[0], c[1]),
                                          output_shape=(7, 6), **kw)

        def ft(x, c):
            return et.geometric_transform(x, lambda o: (c[0], c[1]),
                                          output_shape=(7, 6), device="cpu",
                                          **kw)
    got, want = _vjp(fj, ft, (X, cc), G)
    for a, b in zip(got, want):
        _close(a, b, GRAD)


@pytest.mark.parametrize("mode", ["reflect", "grid-wrap", "nearest",
                                  "mirror", "constant"])
def test_autograd_affine_matrix_offset(mode):
    rs = np.random.RandomState(31)
    X = rs.rand(13, 11)
    M = np.array([[0.9, 0.15], [-0.1, 1.05]])
    O = np.array([1.3, -0.7])
    G = rs.randn(13, 11)
    kw = dict(order=3, mode=mode, cval=0.2)
    got, want = _vjp(lambda x, m, o: ej.affine_transform(x, m, o, **kw),
                     lambda x, m, o: et.affine_transform(x, m, o,
                                                         device="cpu", **kw),
                     (X, M, O), G)
    for a, b in zip(got, want):
        _close(a, b, GRAD)


def test_autograd_shift_and_geometric_parameter():
    rs = np.random.RandomState(32)
    X = rs.rand(18, 20)
    G = rs.randn(18, 20)
    kw = dict(order=3, mode="nearest")
    got, want = _vjp(lambda x, s: ej.shift(x, s, **kw),
                     lambda x, s: et.shift(x, s, device="cpu", **kw),
                     (X, np.array([1.25, -0.75])), G)
    for a, b in zip(got, want):
        _close(a, b, GRAD)
    got, want = _vjp(
        lambda x, a: ej.geometric_transform(
            x, lambda c: (c[0] * a, c[1] + a), order=3, mode="mirror"),
        lambda x, a: et.geometric_transform(
            x, lambda c: (c[0] * a, c[1] + a), order=3, mode="mirror",
            device="cpu"), (X, np.array(0.95)), G)
    for a, b in zip(got, want):
        _close(a, b, GRAD)


@pytest.mark.parametrize("mode", GRID_MODES)
def test_map_coordinates_gradient_grid_modes(mode):
    rs = np.random.RandomState(33)
    cc = np.stack([rs.uniform(-3, 11, (7, 6)), rs.uniform(-3, 11, (7, 6))])
    dy = rs.standard_normal((7, 6))
    kw = dict(order=3, mode=mode, cval=0.5, X_shape=(8, 9))
    _close(et.map_coordinates_gradient(dy, cc, device="cpu", **kw),
           ej.map_coordinates_gradient(dy, cc, **kw), GRAD)


@pytest.mark.parametrize("bc", ["mirror", "reflect", "wrap"])
def test_filter_matrix_bc_is_the_jax_packages(bc):
    for order in range(6):
        for n in (1, 2, 3, 9, 40):
            np.testing.assert_array_equal(tp.filter_matrix_bc(n, order, bc),
                                          jp.filter_matrix_bc(n, order, bc))


def _kernel_model(x, order, bc, transpose):
    """numpy float64 model of K6 / K7 (``csrc/prefilter.cu``) on one line:
    the same stages, initialisations and operation order."""
    x = np.array(x, dtype=np.float64)
    n = len(x)
    poles = tp.spline_poles(order)
    if n <= 1 or not poles:
        return x
    if not transpose:
        x *= tp._gain(poles)
    for z in (poles[::-1] if transpose else poles):
        zn = z ** n
        if not transpose:
            if bc == "reflect":
                c0, zi, acc = x[0], 1.0, 0.0
                for i in range(n):
                    acc += zi * (x[i] + zn * x[n - 1 - i])
                    zi *= z
                x[0] = acc * (z / (1 - zn * zn)) + c0
            else:
                zi, acc = z, x[0]
                for i in range(1, n):
                    acc += zi * x[n - i]
                    zi *= z
                x[0] = acc * (1 / (1 - zn))
            for k in range(1, n):
                x[k] += z * x[k - 1]
            if bc == "reflect":
                x[n - 1] *= z / (z - 1)
            else:
                zi, acc = z, x[n - 1]
                for i in range(n - 1):
                    acc += zi * x[i]
                    zi *= z
                x[n - 1] = acc * (z / (zn - 1))
            for k in range(n - 2, -1, -1):
                x[k] = z * (x[k + 1] - x[k])
            continue
        u = x[0]
        for k in range(n - 1):
            u, x[k] = x[k + 1] + z * u, u * -z
        if bc == "reflect":
            x[n - 1] = u * (z / (z - 1))
        else:
            t = u * (z / (zn - 1))
            x[n - 1], zi = t, z
            for i in range(n - 1):
                x[i] += zi * t
                zi *= z
        v = x[n - 1]
        for k in range(n - 1, 0, -1):
            v = x[k - 1] + z * v
            x[k - 1] = v
        if bc == "reflect":
            t, zi = x[0] * (z / (1 - zn * zn)), 1.0
            for i in range(n):
                x[i] += zi * t
                x[n - 1 - i] += zn * zi * t
                zi *= z
        else:
            t = x[0] * (1 / (1 - zn))
            x[0], zi = t, z
            for i in range(1, n):
                x[n - i] += zi * t
                zi *= z
    return x * tp._gain(poles) if transpose else x


@pytest.mark.parametrize("bc", ["reflect", "wrap"])
@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_kernel_recursion_model_is_filter_matrix_bc(bc, order):
    """K6's recursion, with the exact whole-period initialisations, is
    filter_matrix_bc; K7's stage-by-stage transpose is its transpose; on
    lines shorter and longer than the poles' horizons."""
    for n in (1, 2, 3, 9, 45, 80):
        F = tp.filter_matrix_bc(n, order, bc)
        eye = np.eye(n)
        K6 = np.stack([_kernel_model(e, order, bc, False) for e in eye], 1)
        K7 = np.stack([_kernel_model(e, order, bc, True) for e in eye], 1)
        np.testing.assert_allclose(K6, F, rtol=0, atol=1e-13)
        np.testing.assert_allclose(K7, F.T, rtol=0, atol=1e-13)


@pytest.mark.parametrize("bc", ["reflect", "wrap"])
def test_bc_prefilter_plain_twins(bc):
    """The plain twins of K6 and K7 on any axis, and their adjoint
    identity."""
    rs = np.random.RandomState(34)
    x = torch.as_tensor(rs.randn(5, 9, 4))
    y = torch.as_tensor(rs.randn(5, 9, 4))
    for axis in range(3):
        F = tp.filter_matrix_bc(x.shape[axis], 3, bc)
        want = np.moveaxis(np.tensordot(F, x.numpy(), axes=([1], [axis])),
                           0, axis)
        _close(tp.spline_filter1d_bc(x, 3, axis, bc), want)
        lhs = float((tp.spline_filter1d_bc(x, 3, axis, bc) * y).sum())
        rhs = float((x * tp.spline_filter1d_bc_transpose(y, 3, axis,
                                                         bc)).sum())
        assert abs(lhs - rhs) < 1e-12 * float((x.abs() * 10).sum())


@pytest.mark.parametrize("pad_mode", ["symmetric", "wrap", "edge",
                                      "constant"])
def test_ring_pad_is_numpy_pad_and_transposes(pad_mode):
    """The index-built ring pad equals numpy.pad (widths past the axis
    length included), and autograd through it is its transpose."""
    rs = np.random.RandomState(35)
    for n in (1, 2, 3, 5):
        for width in (1, 4, 11):
            x = rs.randn(n, 3)
            kw = {"constant_values": 2.5} if pad_mode == "constant" else {}
            want = np.pad(x, [(width, width), (0, 0)], mode=pad_mode, **kw)
            xt = torch.tensor(x, requires_grad=True)
            got = tc._ring_pad(xt, [0], width, pad_mode, 2.5)
            np.testing.assert_array_equal(got.detach().numpy(), want)
            g = torch.as_tensor(rs.randn(*want.shape))
            (gx,) = torch.autograd.grad(got, xt, g)
            # <P x, g> == <x, P^T g> for the linear part P x = pad(x) -
            # pad(0)
            linear = want - np.pad(np.zeros_like(x), [(width, width), (0, 0)],
                                   mode=pad_mode, **kw)
            assert abs(float((gx.numpy() * x).sum())
                       - float((g.numpy() * linear).sum())) < 1e-10


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bc", ["reflect", "wrap"])
@pytest.mark.parametrize("order", [2, 3, 4, 5])
@pytest.mark.parametrize("axis", range(3))
def test_bc_prefilter_kernels_match_plain(cuda_device, bc, order, axis):
    rs = np.random.RandomState(order)
    x = torch.as_tensor(rs.rand(9, 64, 5) * 100, device=cuda_device)
    torch.testing.assert_close(tp.spline_filter1d_bc(x, order, axis, bc),
                               tp.spline_filter1d_bc_plain(x, order, axis,
                                                           bc),
                               rtol=1e-10, atol=1e-8)
    torch.testing.assert_close(
        tp.spline_filter1d_bc_transpose(x, order, axis, bc),
        tp.spline_filter1d_bc_transpose_plain(x, order, axis, bc),
        rtol=1e-10, atol=1e-8)


def test_no_warning_on_read_only_inputs():
    x = np.asarray(jnp.ones((6, 7)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        et.shift(x, 1.5, device="cpu")
