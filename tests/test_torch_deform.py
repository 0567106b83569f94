"""elasticdeform_tpu_torch's public entry points against the JAX package.

The same numpy inputs go through ``elasticdeform_tpu`` (CPU, float64, as
``conftest.py`` sets) and through the port with ``device="cpu"``. The bar is
the reference's ``rtol=1e-5, atol=1e-8`` (BASELINE.json); integer and bool
outputs match bit for bit.
"""

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej
from elasticdeform_tpu import _normalize as jn
from elasticdeform_tpu.ops import deform as jdef

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch import _normalize as tn
from elasticdeform_tpu_torch import api as tapi
from elasticdeform_tpu_torch import core as tcore
from elasticdeform_tpu_torch.ops import deform as tdef
from elasticdeform_tpu_torch.ops import displacement as tdisp

MODES = ["nearest", "wrap", "reflect", "mirror", "constant"]
RTOL, ATOL = 1e-5, 1e-8


def _close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("order", range(6))
@pytest.mark.parametrize("shape", [(17, 23), (9, 10, 11)])
def test_deform_grid_orders_modes(shape, order, mode):
    rs = np.random.RandomState(order * 7 + len(shape))
    X = rs.rand(*shape) * 10 - 3
    # sigma well above the image size: coordinates land far past every edge
    d = rs.randn(len(shape), *([3] * len(shape))) * 25
    kw = dict(order=order, mode=mode, cval=1.25)
    _close(et.deform_grid(X, d, device="cpu", **kw), ej.deform_grid(X, d, **kw))


@pytest.mark.parametrize("case", ["crop", "crop_affine", "rotate_zoom",
                                  "no_prefilter", "cval", "homogeneous"])
def test_deform_grid_options(case):
    rs = np.random.RandomState(11)
    if case in ("crop", "crop_affine"):
        X = rs.rand(12, 14, 10)
        d = rs.randn(3, 3, 4, 3) * 4
        kw = dict(crop=[slice(2, 10), slice(None), slice(3, 9)])
        if case == "crop_affine":
            A = np.eye(3, 4)
            A[:, :3] += rs.randn(3, 3) * 0.1
            A[:, 3] = [1.5, -2.0, 0.5]
            kw["affine"] = A
    else:
        X = rs.rand(21, 18)
        d = rs.randn(2, 4, 3) * 5
        kw = {"rotate_zoom": dict(rotate=30, zoom=1.5, crop=[slice(3, 19),
                                                             slice(2, 15)]),
              "no_prefilter": dict(prefilter=False),
              "cval": dict(mode="constant", cval=-4.5),
              "homogeneous": dict(affine=np.array([[1.1, 0.2, 3.0],
                                                   [-0.1, 0.9, -2.0],
                                                   [0.0, 0.0, 1.0]]))}[case]
    _close(et.deform_grid(X, d, device="cpu", **kw), ej.deform_grid(X, d, **kw))


def test_multi_input_mixed_order_dtype_axis():
    rs = np.random.RandomState(4)
    rgb = rs.rand(3, 17, 23).astype(np.float32)
    seg = (rs.rand(17, 23, 2) * 4).astype(np.uint8)
    vol = rs.rand(17, 23)
    d = rs.randn(2, 3, 4) * 6
    kw = dict(order=[3, 0, 1], mode=["mirror", "nearest", "constant"],
              cval=[0.0, 0.0, 2.0], axis=[(1, 2), (0, 1), (0, 1)])
    got = et.deform_grid([rgb, seg, vol], d, device="cpu", **kw)
    want = ej.deform_grid([rgb, seg, vol], d, **kw)
    assert isinstance(got, list) and len(got) == 3
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.bool_, np.int32,
                                   np.float32])
@pytest.mark.parametrize("order", [0, 3, 5])
def test_integer_and_bool_dtypes(dtype, order):
    rs = np.random.RandomState(order)
    if dtype is np.bool_:
        X = rs.rand(16, 19) > 0.5
    else:
        info = np.iinfo(dtype) if np.dtype(dtype).kind in "iu" else None
        lo, hi = (info.min // 2, info.max // 2) if info else (-50, 50)
        X = rs.uniform(lo, hi, (16, 19)).astype(dtype)
    d = rs.randn(2, 3, 3) * 4
    _close(et.deform_grid(X, d, order=order, device="cpu"),
           ej.deform_grid(X, d, order=order))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_integer_output_sums_its_displacement_in_fixed_order(dtype):
    """A call with an integer output sums the dense displacement in
    ``dense_displacement``'s fixed order (the same bits on the card and
    the CPU); a float output keeps the ``tensordot``."""
    rs = np.random.RandomState(9)
    X = (rs.rand(16, 19) * 200).astype(dtype)
    d = rs.randn(2, 3, 3).astype(np.float32) * 4
    _, disp, _, spec = tcore._prepare(X, d, 3, "mirror", 0.0, None, True,
                                     None, None, None, None, "auto", None)
    disp = torch.as_tensor(disp)[None]
    _, got, _ = tdef._setup(disp, None, spec)
    want = tdisp.dense_displacement(disp, spec.out_spatial, spec.deform_shape,
                                    spec.offsets, dtype == np.uint8)
    assert torch.equal(got, want)


def test_deform_random_grid_same_seed():
    X = np.random.RandomState(0).rand(20, 25)
    np.random.seed(123)
    want = ej.deform_random_grid(X, sigma=8, points=[3, 4], mode="reflect")
    np.random.seed(123)
    got = et.deform_random_grid(X, sigma=8, points=[3, 4], mode="reflect",
                                device="cpu")
    _close(got, want)


def test_tensor_deform_matches_numpy_api():
    rs = np.random.RandomState(9)
    X = rs.rand(2, 15, 13).astype(np.float32)
    d = rs.randn(2, 3, 3) * 3
    y = et.deform(torch.as_tensor(X), torch.as_tensor(d), axis=(1, 2),
                  device="cpu")
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    _close(y.numpy(), ej.deform_grid(X, d, axis=(1, 2)))


@pytest.mark.parametrize("order", [1, 3])
def test_deform_batch_per_sample_grids(order):
    rs = np.random.RandomState(order)
    X = rs.rand(3, 10, 12, 9)
    seg = (rs.rand(3, 10, 12, 9) * 3).astype(np.uint8)
    d = rs.randn(3, 3, 3, 3, 3) * 4
    kw = dict(order=[order, 0], mode="mirror", crop=[slice(1, 9), slice(None),
                                                     slice(2, 8)])
    want = ej.deform_batch([X, seg], d, **kw)
    got = et.deform_batch([torch.as_tensor(X), torch.as_tensor(seg)],
                          torch.as_tensor(d), device="cpu", **kw)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))
    got_np = tapi.deform_batch([X, seg], d, device="cpu", **kw)
    for g, w in zip(got_np, want):
        _close(g, np.asarray(w))


def test_deform_batch_per_sample_affine():
    # per-sample inverse affines reach the batched pipeline directly (the
    # public deform_batch shares one affine), in both packages
    rs = np.random.RandomState(21)
    B, shape = 3, (11, 13)
    X = rs.rand(B, *shape)
    d = rs.randn(B, 2, 3, 3) * 3
    A = np.zeros((B, 2, 3))
    A[:, :, :2] = np.eye(2) + rs.randn(B, 2, 2) * 0.15
    A[:, :, 2] = rs.randn(B, 2) * 2
    args = ([X[0]], [(0, 1)], shape, [shape], (0, 0), [3], [3], [0.0], True,
            d.dtype)
    jspec = jn.build_spec(*args, True)
    tspec = tn.build_spec(*args)
    want = jdef.deform_apply_batched([X], d, A, jspec)[0]
    got = tdef.deform_apply_batched([torch.as_tensor(X)], torch.as_tensor(d),
                                    torch.as_tensor(A), tspec)[0]
    _close(got.numpy(), np.asarray(want))
    # and each sample equals the single-sample call with its own affine
    # (to round-off: the dense displacement's products batch differently)
    for b in range(B):
        single = tdef.deform_apply([torch.as_tensor(X[b])],
                                   torch.as_tensor(d[b]), A[b], tspec)[0]
        np.testing.assert_allclose(single.numpy(), got[b].numpy(),
                                   rtol=1e-12, atol=1e-12)


def _error_of(fn):
    try:
        fn()
    except Exception as e:  # the error itself is what is compared
        return type(e), str(e)
    return None


_BAD_CALLS = {
    "not_an_array": lambda m, X, d: m("nope", d),
    "empty_list": lambda m, X, d: m([], d),
    "list_of_junk": lambda m, X, d: m([X, 3], d),
    "displacement_ndim": lambda m, X, d: m(X, d[0]),
    "displacement_first_dim": lambda m, X, d: m(X, np.zeros((3, 3, 3))),
    "order_range": lambda m, X, d: m(X, d, order=6),
    "order_count": lambda m, X, d: m([X, X], d, order=[1, 2, 3]),
    "mode_name": lambda m, X, d: m(X, d, mode="grid-wrap"),
    "mode_count": lambda m, X, d: m([X, X], d, mode=["wrap"]),
    "cval_count": lambda m, X, d: m([X, X], d, cval=[0.0]),
    "cval_type": lambda m, X, d: m(X, d, cval="x"),
    "axis_unsorted": lambda m, X, d: m(X, d, axis=(1, 0)),
    "axis_count": lambda m, X, d: m([X, X], d, axis=[(0, 1)]),
    "axis_range": lambda m, X, d: m(X, d, axis=(0, 2)),
    "axis_type": lambda m, X, d: m(X, d, axis=[[0, 1]]),
    "shape_mismatch": lambda m, X, d: m([X, X[:5]], d),
    "crop_type": lambda m, X, d: m(X, d, crop=slice(0, 3)),
    "crop_slice": lambda m, X, d: m(X, d, crop=[0, slice(None)]),
    "crop_bounds": lambda m, X, d: m(X, d, crop=[slice(0, 40), slice(None)]),
    "crop_step": lambda m, X, d: m(X, d, crop=[slice(0, 4, 2), slice(None)]),
    "affine_shape": lambda m, X, d: m(X, d, affine=np.eye(2)),
    "affine_bottom": lambda m, X, d: m(X, d, affine=np.ones((3, 3))),
    "rotate_3d": lambda m, X, d: m(X[..., None], np.zeros((3, 3, 3, 3)),
                                   rotate=10),
}


@pytest.mark.parametrize("name", sorted(_BAD_CALLS))
def test_normalize_errors_match(name):
    rs = np.random.RandomState(0)
    X = rs.rand(12, 10)
    d = rs.randn(2, 3, 3)
    want = _error_of(lambda: _BAD_CALLS[name](ej.deform_grid, X, d))
    got = _error_of(lambda: _BAD_CALLS[name](
        lambda *a, **k: et.deform_grid(*a, device="cpu", **k), X, d))
    assert want is not None
    assert got == want


def test_unported_dtypes_raise_type_error():
    d = np.zeros((2, 3, 3))
    for X in (np.zeros((8, 8), np.complex64), np.zeros((8, 8), np.float16)):
        with pytest.raises(TypeError):
            et.deform_grid(X, d, device="cpu")


def test_requires_grad_raises():
    # a tensor that requires grad no longer raises: the gradient exists,
    # with the shape and dtype of the tensor it belongs to
    X = torch.rand(8, 9, requires_grad=True)
    y = et.deform(X, torch.zeros(2, 3, 3, dtype=torch.float64), device="cpu")
    (gx,) = torch.autograd.grad(y.sum(), X)
    assert gx.shape == X.shape and gx.dtype == torch.float32
    d = torch.zeros(2, 2, 3, 3, requires_grad=True)
    y = et.deform_batch(torch.rand(2, 8, 9, dtype=torch.float64), d,
                        device="cpu")
    (gd,) = torch.autograd.grad((y ** 2).sum(), d)
    assert gd.shape == d.shape and gd.dtype == torch.float32
    assert bool(torch.isfinite(gd).all()) and bool((gd != 0).any())
