"""Integer outputs of the general resampler sum their prefilter in one order.

``affine_transform``, ``zoom``, ``rotate``, ``shift`` and
``map_coordinates`` on an integer input filter it in float, resample and
round. The card's prefilter kernels (K2, K6) run a recursion and the CPU
path a matrix product: the two agree to the last bits, but an output near
a half rounds to different integers (``chip_smoke.py``'s
``_check_int_resampler`` found one int16 value of 1665 one apart, an
``affine_transform`` at order 3 in the modern reflect mode). So a call
whose output is an integer takes the prefilter's fixed-order route on
every device: the row sums of ``filter_matrix`` or ``filter_matrix_bc``, k
ascending (K2's writeback route with no cast; its twin ``_row_sums``).

On the CPU:

* a float32 model of K6's recursion (``k6_stages``) in place of the
  prefilter moves such a value: the output depends on the order of the
  prefilter's sums;
* every integer-output call passes ``fixed_order`` to the prefilter, every
  float one does not;
* the fixed-order twins equal ``filter_matrix(_bc)`` to the rounding of
  their sums, and the integer outputs still equal the JAX package's bit for
  bit.
"""

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch.ops import deform as td
from elasticdeform_tpu_torch.ops import prefilter as tp


def _recursion_bc(x, order, axis, bc):
    """K6's recursion (``k6_stages`` in ``csrc/prefilter.cu``, the model of
    ``tests/test_torch_k6.py``) along ``axis`` in ``x``'s dtype, every
    other axis at once."""
    xm = torch.movedim(x, axis, 0).clone()
    n = xm.shape[0]
    poles = tp.spline_poles(order)

    def t(v):
        return torch.tensor(v, dtype=x.dtype)
    xm = xm * t(tp._gain(poles))
    for z in poles:
        zn = z ** n
        if bc == "reflect":
            c0, zi, acc = xm[0].clone(), 1.0, torch.zeros_like(xm[0])
            for i in range(n):
                acc = acc + t(zi) * (xm[i] + t(zn) * xm[n - 1 - i])
                zi = zi * z
            xm[0] = acc * t(z / (1.0 - zn * zn)) + c0
        else:
            zi, acc = z, xm[0].clone()
            for i in range(1, n):
                acc = acc + t(zi) * xm[n - i]
                zi = zi * z
            xm[0] = acc * t(1.0 / (1.0 - zn))
        prev = xm[0].clone()
        for k in range(1, n):
            prev = xm[k] + t(z) * prev
            xm[k] = prev
        if bc == "reflect":
            prev = prev * t(z / (z - 1.0))
        else:
            zi, acc = z, prev.clone()
            for i in range(n - 1):
                acc = acc + t(zi) * xm[i]
                zi = zi * z
            prev = acc * t(z / (zn - 1.0))
        xm[n - 1] = prev
        for k in range(n - 2, -1, -1):
            prev = t(z) * (prev - xm[k])
            xm[k] = prev
    return torch.movedim(xm, 0, axis).contiguous()


def _affine_case(seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(-3000, 3000, (37, 45)).astype(np.int16)
    ang = np.deg2rad(12.0)
    mat = np.array([[np.cos(ang) * 1.1, np.sin(ang)],
                    [-np.sin(ang), np.cos(ang) * 1.1]])
    return x, mat, rs.uniform(-3, 3, 2)


@pytest.mark.parametrize("seed", [2, 6, 8])
def test_recursion_order_moves_an_integer_output(seed, monkeypatch):
    """The fault's cause: with K6's recursion in place of the fixed-order
    sums, one or two int16 outputs of a 37 x 45 ``affine_transform``
    (order 3, reflect) move by one."""
    x, mat, off = _affine_case(seed)
    kw = dict(order=3, mode="reflect", device="cpu")
    fixed = et.affine_transform(x, mat, off, **kw)
    monkeypatch.setattr(td.Prefilter1d, "apply",
                        lambda y, order, axis, bc, fixed_order=False,
                        finite=False: _recursion_bc(y, order, axis, bc))
    moved = et.affine_transform(x, mat, off, **kw)
    diff = (fixed.long() - moved.long()).abs()
    assert 1 <= int((diff > 0).sum()) <= 2 and int(diff.max()) == 1


def _calls(x, mode):
    nd = x.ndim
    coords = np.stack([np.linspace(-2, n + 1, 40).reshape(
        [-1 if k == h else 1 for k in range(nd)]) * np.ones([40] * nd)
        for h, n in enumerate(x.shape)])
    modern = mode != "mirror"
    return (
        ("affine_transform", lambda: et.affine_transform(
            x, np.eye(nd) * 0.9, 0.5, order=3, mode=mode, device="cpu")),
        ("zoom", lambda: et.zoom(x, 1.3, order=3, mode=mode, device="cpu")),
        ("rotate", lambda: et.rotate(x, 17.0, order=3, mode=mode,
                                     device="cpu")),
        ("shift", lambda: et.shift(x, 1.5, order=3, mode=mode,
                                   device="cpu")),
        ("map_coordinates", lambda: et.map_coordinates(
            x, coords, order=3, mode="grid-wrap" if modern else "mirror",
            device="cpu")))


@pytest.mark.parametrize("mode", ["mirror", "reflect"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_integer_outputs_ask_for_the_fixed_order(dtype, mode, monkeypatch):
    seen = []
    apply = td.Prefilter1d.apply

    def spy(y, order, axis, bc, fixed_order=False, finite=False):
        seen.append(fixed_order)
        return apply(y, order, axis, bc, fixed_order, finite)
    monkeypatch.setattr(td.Prefilter1d, "apply", spy)
    x = (np.random.RandomState(1).rand(12, 14) * 200).astype(dtype)
    for name, call in _calls(x, mode):
        seen.clear()
        out = call()
        assert seen, name
        want = np.dtype(dtype).kind in "iu"
        assert all(f is want for f in seen), name
        assert out.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype


@pytest.mark.parametrize("bc", ["mirror", "reflect", "wrap"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fixed_order_twins_are_the_filter(dtype, bc):
    rs = np.random.RandomState(3)
    x = torch.as_tensor(rs.rand(5, 33, 4) * 400 - 100, dtype=dtype)
    for order in (2, 3, 4, 5):
        if bc == "mirror":
            got = tp.spline_filter1d_plain(x, order, 1, fixed_order=True)
            want = tp.spline_filter1d_plain(x.double(), order, 1)
        else:
            got = tp.spline_filter1d_bc_plain(x, order, 1, bc, True)
            want = tp.spline_filter1d_bc_plain(x.double(), order, 1, bc)
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        np.testing.assert_allclose(got.double(), want, rtol=tol,
                                   atol=tol * 400)
        # the order of K2's writeback route with no cast
        mat = tp._filter_table(33, order, dtype, x.device, bc)
        assert torch.equal(got, tp._row_sums(x, mat, 1))


@pytest.mark.parametrize("mode", ["mirror", "reflect"])
def test_integer_outputs_equal_the_jax_package(mode):
    x = (np.random.RandomState(4).rand(12, 14) * 200).astype(np.uint8)
    nd = x.ndim
    got = et.affine_transform(x, np.eye(nd) * 0.9, 0.5, order=3, mode=mode,
                              device="cpu").numpy()
    want = np.asarray(ej.affine_transform(x, np.eye(nd) * 0.9, 0.5, order=3,
                                          mode=mode))
    np.testing.assert_array_equal(got, want)
