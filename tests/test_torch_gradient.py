"""The port's gradient path against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through ``elasticdeform_tpu``
(CPU, float64, as ``conftest.py`` sets) and the port with ``device="cpu"``,
where the kernel wrappers take their plain versions:

* ``deform_grid_gradient`` against the JAX package's, rtol 1e-9 and atol
  1e-12 * max|ref| (both are exact adjoints; they differ by the order of
  float64 sums);
* the pieces: the weight and fold derivatives against JAX's autodiff, the
  adjoint identities of the plain twins of K1/K3 and K2/K4, and the
  transposed dense displacement;
* ``torch.autograd.gradcheck`` of the autograd function.

Tests marked ``cuda`` hold kernels K3, K4 and K5 against their plain
versions and run only where a card is.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import elasticdeform_tpu as ej
from elasticdeform_tpu.ops import bspline as jb
from elasticdeform_tpu.ops import modes as jm

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch.ops import bspline as tb
from elasticdeform_tpu_torch.ops import displacement as td
from elasticdeform_tpu_torch.ops import modes as tm
from elasticdeform_tpu_torch.ops import prefilter as tp
from elasticdeform_tpu_torch.ops import resample as tr
from elasticdeform_tpu_torch.ops import resample_bwd as trb

MODES = ["nearest", "wrap", "reflect", "mirror", "constant"]
RTOL = 1e-9


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * scale)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("order", range(6))
def test_deform_grid_gradient_2d(order, mode):
    rs = np.random.RandomState(order * 5 + MODES.index(mode))
    d = rs.randn(2, 3, 4) * 6
    dY = rs.randn(15, 18)
    kw = dict(order=order, mode=mode, cval=0.75)
    _close(et.deform_grid_gradient(dY, d, device="cpu", **kw),
           ej.deform_grid_gradient(dY, d, **kw))


@pytest.mark.parametrize("mode", ["mirror", "constant"])
@pytest.mark.parametrize("order", [1, 3, 5])
def test_deform_grid_gradient_3d(order, mode):
    rs = np.random.RandomState(order)
    d = rs.randn(3, 3, 3, 3) * 4
    dY = rs.randn(9, 10, 8)
    kw = dict(order=order, mode=mode)
    _close(et.deform_grid_gradient(dY, d, device="cpu", **kw),
           ej.deform_grid_gradient(dY, d, **kw))


@pytest.mark.parametrize("case", ["crop", "crop_affine", "rotate_zoom",
                                  "no_prefilter"])
def test_deform_grid_gradient_options(case):
    rs = np.random.RandomState(7)
    if case in ("crop", "crop_affine"):
        shape = (12, 14, 10)
        crop = [slice(2, 10), slice(None), slice(3, 9)]
        d = rs.randn(3, 3, 4, 3) * 4
        dY = rs.randn(8, 14, 6)
        kw = dict(crop=crop, X_shape=shape, mode="constant")
        if case == "crop_affine":
            A = np.eye(3, 4)
            A[:, :3] += rs.randn(3, 3) * 0.1
            A[:, 3] = [1.5, -2.0, 0.5]
            kw["affine"] = A
    elif case == "rotate_zoom":
        d = rs.randn(2, 4, 3) * 5
        dY = rs.randn(16, 13)
        kw = dict(rotate=30, zoom=1.5, crop=[slice(3, 19), slice(2, 15)],
                  X_shape=(21, 18))
    else:
        d = rs.randn(2, 4, 3) * 5
        dY = rs.randn(21, 18)
        kw = dict(prefilter=False, order=3)
    _close(et.deform_grid_gradient(dY, d, device="cpu", **kw),
           ej.deform_grid_gradient(dY, d, **kw))


def test_gradient_multi_input_mixed_order_dtype_axis():
    rs = np.random.RandomState(4)
    d = rs.randn(2, 3, 4) * 6
    crop = [slice(2, 15), slice(3, 20)]
    d_rgb = rs.randn(3, 13, 17).astype(np.float32)
    d_vol = rs.randn(13, 17)
    kw = dict(order=[3, 1], mode=["mirror", "constant"], cval=[0.0, 2.0],
              axis=[(1, 2), (0, 1)], crop=crop,
              X_shape=[(3, 17, 23), (17, 23)])
    got = et.deform_grid_gradient([d_rgb, d_vol], d, device="cpu", **kw)
    want = ej.deform_grid_gradient([d_rgb, d_vol], d, **kw)
    assert isinstance(got, list) and len(got) == 2
    # a float32 cotangent comes back float32
    assert got[0].dtype == np.float32 and got[1].dtype == np.float64
    _close(got[0], want[0], rtol=1e-6)
    _close(got[1], want[1])


@pytest.mark.parametrize("mode", ["nearest", "constant"])
def test_zero_grid_hits_the_clip_ties(mode):
    # with a zero control grid the sample coordinates are the output
    # indices, so they hit 0 and len-1 exactly: jnp.clip passes half there
    rs = np.random.RandomState(3)
    X = rs.rand(9, 11)
    d = np.zeros((2, 3, 3))
    gy = rs.randn(9, 11)
    _, vjp = jax.vjp(lambda x, dd: ej.deform(x, dd, order=3, mode=mode),
                     jnp.asarray(X), jnp.asarray(d))
    gx, gd = vjp(jnp.asarray(gy))
    xt = torch.tensor(X, requires_grad=True)
    dt = torch.tensor(d, requires_grad=True)
    y = et.deform(xt, dt, order=3, mode=mode, device="cpu")
    tgx, tgd = torch.autograd.grad(y, (xt, dt), torch.as_tensor(gy))
    _close(tgx.numpy(), gx, rtol=1e-8)
    _close(tgd.numpy(), gd, rtol=1e-8)
    assert np.abs(np.asarray(gd)).max() > 0


@pytest.mark.parametrize("order", range(6))
def test_spline_weights_grad_matches_jax_jvp(order):
    rs = np.random.RandomState(order)
    cc = np.concatenate([rs.uniform(-3, 40, 300), np.arange(-4, 12) * 0.5])
    want = jax.jvp(lambda c: jb.spline_weights(c, order), (jnp.asarray(cc),),
                   (jnp.ones(cc.shape),))[1]
    got = tb.spline_weights_grad(torch.as_tensor(cc), order)
    assert len(got) == len(want) == order + 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-13)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("length", [1, 2, 7])
def test_map_coordinate_grad_matches_jax_grad(mode, length):
    rs = np.random.RandomState(length)
    cc = np.concatenate([rs.uniform(-9 * length - 5, 9 * length + 5, 200),
                         np.arange(-3 * length, 3 * length + 1) * 0.5,
                         [0.0, length - 1.0, -1.0, float(length)]])
    code = jm.mode_to_code(mode)
    want = jax.vmap(jax.grad(lambda c: jm.map_coordinate(c, length,
                                                         code)[0]))(
        jnp.asarray(cc))
    got = tm.map_coordinate_grad(torch.as_tensor(cc), length, code)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("in_sp", [(9, 2, 7), (64, 1, 2)])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("order", [0, 1, 3, 4])
def test_resample_adjoint_identity(order, mode, in_sp):
    # <resample_plain(x), g> == <x, resample_transpose_plain(g)>, cval 0:
    # the scatter into the padded coefficients and the fold of the pad
    # (the JAX package's structure) is the transpose of K1's plain twin,
    # on axes of 1 to 64 voxels
    rs = np.random.RandomState(order * 5 + MODES.index(mode))
    out_sp = (6, 5, 4)
    x = torch.as_tensor(rs.randn(2, *in_sp, 2))
    g = torch.as_tensor(rs.randn(2, *out_sp, 2))
    displ = torch.as_tensor(rs.randn(2, 3, *out_sp) * 12)
    A = torch.as_tensor(np.concatenate(
        [np.eye(3) + rs.randn(3, 3) * 0.1, rs.randn(3, 1)], 1))
    args = (displ, A, (1, 0, 2), order, tm.mode_to_code(mode))
    lhs = float((tr.resample_plain(x, *args, 0.0) * g).sum())
    rhs = float((x * trb.resample_transpose_plain(g, *args, in_sp)).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("order", [2, 3, 4, 5])
@pytest.mark.parametrize("n", [1, 2, 9, 64])
def test_prefilter_adjoint_identity(order, n):
    # <F x, y> == <x, F^T y> across the horizon (the full mirror-sum
    # initialisation for n = 9, the truncated one for n = 64)
    rs = np.random.RandomState(n * 7 + order)
    x = torch.as_tensor(rs.randn(3, n, 4))
    y = torch.as_tensor(rs.randn(3, n, 4))
    lhs = float((tp.spline_filter1d(x, order, 1) * y).sum())
    rhs = float((x * tp.spline_filter1d_transpose(y, order, 1)).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


def test_dense_displacement_transpose_adjoint():
    rs = np.random.RandomState(5)
    grid = torch.as_tensor(rs.randn(2, 2, 3, 4))
    dd = torch.as_tensor(rs.randn(2, 2, 10, 12))
    args = ((16, 20), (3, 5))
    lhs = float((td.dense_displacement(grid, (10, 12), *args) * dd).sum())
    rhs = float((grid * td.dense_displacement_transpose(dd, (3, 4),
                                                        *args)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_gradcheck_autograd_function():
    rs = np.random.RandomState(2)
    X = torch.tensor(rs.rand(7, 8), requires_grad=True)
    d = torch.tensor(rs.randn(2, 3, 3) * 2, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x, dd: et.deform(x, dd, order=3, mode="mirror", device="cpu"),
        (X, d), eps=1e-6, atol=1e-6, rtol=1e-5)


def _error_of(fn):
    try:
        fn()
    except Exception as e:  # the error itself is what is compared
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", ["crop_needs_x_shape", "wrong_x_shape"])
def test_gradient_errors_match(case):
    dY = np.zeros((8, 6))
    d = np.zeros((2, 3, 3))
    kw = {"crop_needs_x_shape": dict(crop=[slice(0, 8), slice(2, 8)]),
          "wrong_x_shape": dict(crop=[slice(None), slice(2, 8)],
                                X_shape=(10, 9))}[case]
    want = _error_of(lambda: ej.deform_grid_gradient(dY, d, **kw))
    got = _error_of(lambda: et.deform_grid_gradient(dY, d, device="cpu",
                                                    **kw))
    assert want is not None and got == want


def test_gradient_wrappers_take_plain_on_cpu_only():
    x = torch.rand(1, 6, 5, 1, dtype=torch.float64)
    displ = torch.zeros(1, 2, 6, 5, dtype=torch.float64)
    wrappers = (trb.resample_transpose, trb.resample_coord_grad,
                tp.spline_filter1d_transpose)
    before = [w.launches for w in wrappers]
    trb.resample_transpose(x, displ, None, (0, 0), 3, 3, (6, 5))
    trb.resample_coord_grad(x, x, displ, None, (0, 0), 3, 3)
    tp.spline_filter1d_transpose(x, 3, 1)
    assert [w.launches for w in wrappers] == before
    # a tensor neither on the CPU nor on a CUDA device is refused, never
    # computed by the plain version
    m, md = x.to("meta"), displ.to("meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        trb.resample_transpose(m, md, None, (0, 0), 3, 3, (6, 5))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        trb.resample_coord_grad(m, m, md, None, (0, 0), 3, 3)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tp.spline_filter1d_transpose(m, 3, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("order", range(6))
@pytest.mark.parametrize("mode", range(5))
def test_resample_bwd_kernels_match_plain(cuda_device, order, mode):
    rs = np.random.RandomState(order * 5 + mode)
    coeffs = torch.as_tensor(rs.rand(2, 9, 11, 8, 2), device=cuda_device)
    g = torch.as_tensor(rs.randn(2, 7, 8, 9, 2), device=cuda_device)
    displ = torch.as_tensor(rs.randn(2, 3, 7, 8, 9) * 30, device=cuda_device)
    args = (displ, None, (1, 0, 2), order, mode)
    torch.testing.assert_close(
        trb.resample_transpose(g, *args, (9, 11, 8)),
        trb.resample_transpose_plain(g, *args, (9, 11, 8)),
        rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(
        trb.resample_coord_grad(coeffs, g, *args),
        trb.resample_coord_grad_plain(coeffs, g, *args),
        rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 3, 4, 5])
@pytest.mark.parametrize("axis", range(3))
def test_prefilter_transpose_kernel_matches_plain(cuda_device, order, axis):
    rs = np.random.RandomState(order)
    x = torch.as_tensor(rs.rand(9, 64, 5) * 100, device=cuda_device)
    torch.testing.assert_close(
        tp.spline_filter1d_transpose(x, order, axis),
        tp.spline_filter1d_transpose_plain(x, order, axis),
        rtol=1e-10, atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["tile", "lines"])
@pytest.mark.parametrize("axis", range(3))
def test_prefilter_transpose_routes_match_plain(cuda_device, route, axis):
    rs = np.random.RandomState(axis)
    x = torch.as_tensor(rs.rand(9, 64, 5) * 100, device=cuda_device)
    plan = tp._tile_plan(*tp._lines(x, axis), x.dtype, route=route)
    torch.testing.assert_close(
        tp._launch_transpose(x, 3, axis, "mirror", plan),
        tp.spline_filter1d_transpose_plain(x, 3, axis),
        rtol=1e-10, atol=1e-8)
