"""Integer ``output=`` arrays of ``spline_filter`` and ``spline_filter1d``
take the prefilter's fixed-order sums.

An integer (or bool) numpy ``output=`` array makes the call filter in
float64 and store with numpy's truncating cast. The card's prefilter kernels
(K2, K6) run a recursion and the CPU path a matrix product; the two agree to
the last bits, but a value on an integer, as a constant run of an integer
image filters to, truncates to different integers on the two devices. So
such a call takes the prefilter's fixed-order route on every device (K2's
writeback route with no cast; the twin ``_row_sums``), as the general
resampler's integer outputs do.

On the CPU:

* float64 models of K2's and K6's recursions (``k2_stages`` and
  ``k6_stages`` in ``csrc/prefilter.cu``, the models of
  ``tests/test_torch_k2.py`` and ``tests/test_torch_k6.py`` over whole
  arrays) in place of the prefilter move uint8 and int16 outputs of images
  with constant runs;
* with the recursion in place of the filter's other route only, the integer
  outputs do not move: the call asks for the fixed order;
* every integer or bool output array asks for the fixed order, in every
  mode and at orders 2-5; float outputs and dtypes do not;
* the integer outputs equal the JAX package's bit for bit where the orders
  of the sums agree (float64, lines of 4-64, column counts a multiple of 8).
"""

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch import core as tc
from elasticdeform_tpu_torch.ops import deform as td
from elasticdeform_tpu_torch.ops import prefilter as tp


def _k2_lines(x, order):
    """K2's recursion along axis 0 of float64 ``x``, every line at once, in
    the kernel's operation order (``_k2_model`` of ``test_torch_k2.py``)."""
    x = np.array(x, dtype=np.float64)
    n = len(x)
    poles = tp.spline_poles(order)
    if n <= 1 or not poles:
        return x
    x = x * tp._gain(poles)
    for z in poles:
        h = tp._horizon(z)
        if h < n:
            acc, zn = x[0].copy(), z
            for k in range(1, h):
                acc = acc + zn * x[k]
                zn = zn * z
        else:
            zn, iz = z, 1.0 / z
            z2n = z ** (n - 1)
            acc = x[0] + z2n * x[n - 1]
            z2n = z2n * (z2n * iz)
            for k in range(1, n - 1):
                acc = acc + (zn + z2n) * x[k]
                zn = zn * z
                z2n = z2n * iz
            acc = acc / (1.0 - z ** (2 * n - 2))
        x[0] = acc
        prev = x[0].copy()
        for k in range(1, n):
            prev = x[k] + z * prev
            x[k] = prev
        prev = (z / (z * z - 1.0)) * (prev + z * x[n - 2])
        x[n - 1] = prev
        for k in range(n - 2, -1, -1):
            prev = z * (prev - x[k])
            x[k] = prev
    return x


def _k6_lines(x, order, bc):
    """K6's recursion along axis 0 (``_k6_model`` of ``test_torch_k6.py``),
    every line at once."""
    x = np.array(x, dtype=np.float64)
    n = len(x)
    poles = tp.spline_poles(order)
    if n <= 1 or not poles:
        return x
    x = x * tp._gain(poles)
    for z in poles:
        zn = z ** n
        if bc == "reflect":
            c0, zi, acc = x[0].copy(), 1.0, 0.0
            for i in range(n):
                acc = acc + zi * (x[i] + zn * x[n - 1 - i])
                zi = zi * z
            x[0] = acc * (z / (1.0 - zn * zn)) + c0
        else:
            zi, acc = z, x[0].copy()
            for i in range(1, n):
                acc = acc + zi * x[n - i]
                zi = zi * z
            x[0] = acc * (1.0 / (1.0 - zn))
        prev = x[0].copy()
        for k in range(1, n):
            prev = x[k] + z * prev
            x[k] = prev
        if bc == "reflect":
            prev = prev * (z / (z - 1.0))
        else:
            zi, acc = z, prev.copy()
            for i in range(n - 1):
                acc = acc + zi * x[i]
                zi = zi * z
            prev = acc * (z / (zn - 1.0))
        x[n - 1] = prev
        for k in range(n - 2, -1, -1):
            prev = z * (prev - x[k])
            x[k] = prev
    return x


def _recursion(y, order, axis, bc):
    """The card's recursion (K2 for mirror, K6 for reflect and wrap) along
    ``axis`` of a float64 tensor."""
    xm = np.moveaxis(y.detach().numpy(), axis, 0)
    out = _k2_lines(xm, order) if bc == "mirror" else \
        _k6_lines(xm, order, bc)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(out, 0, axis)))


def _image(dtype, shape, seed):
    """Constant runs of a few levels (lines of 5-200 samples hold runs of
    2-40), which filter to values on or near integers."""
    rs = np.random.RandomState(seed)
    levels = {np.uint8: (0, 50, 100, 150),
              np.int16: (-3000, -100, 0, 700, 2500)}[dtype]
    flat = np.empty(int(np.prod(shape)), dtype=dtype)
    i = 0
    while i < flat.size:
        n = int(rs.randint(2, 41))
        flat[i:i + n] = levels[rs.randint(len(levels))]
        i += n
    return flat.reshape(shape)


def _calls(x, mode, order):
    out = np.empty(x.shape, x.dtype)
    return (
        ("spline_filter1d", lambda: et.spline_filter1d(
            x, order=order, axis=-1, mode=mode, output=out.copy(),
            device="cpu")),
        ("spline_filter1d axis 0", lambda: et.spline_filter1d(
            x, order=order, axis=0, mode=mode, output=out.copy(),
            device="cpu")),
        ("spline_filter", lambda: et.spline_filter(
            x, order=order, mode=mode, output=out.copy(), device="cpu")))


_CASES = [(np.uint8, "mirror", (40, 200)), (np.int16, "mirror", (24, 150)),
          (np.uint8, "reflect", (30, 120)), (np.int16, "grid-wrap", (20, 150)),
          (np.uint8, "nearest", (3, 20, 57))]


@pytest.mark.parametrize("dtype,mode,shape", _CASES)
def test_the_recursion_moves_integer_outputs(dtype, mode, shape,
                                             monkeypatch):
    """The fault: with the card's recursion in place of the fixed-order
    sums, truncated outputs move (the parent's routing sent every call
    there)."""
    x = _image(dtype, shape, 5)
    fixed = [call() for _, call in _calls(x, mode, 3)]
    monkeypatch.setattr(td.Prefilter1d, "apply",
                        lambda y, order, axis, bc, fixed_order=False:
                        _recursion(y, order, axis, bc))
    moved = [call() for _, call in _calls(x, mode, 3)]
    diff = sum(int((a.astype(np.int64) != b.astype(np.int64)).sum())
               for a, b in zip(fixed, moved))
    assert diff >= 1
    assert all(int(np.abs(a.astype(np.int64) - b).max()) <= 1
               for a, b in zip(fixed, moved))


@pytest.mark.parametrize("dtype,mode,shape", _CASES)
def test_integer_outputs_do_not_move(dtype, mode, shape, monkeypatch):
    """With the recursion on the filter's float route only, the integer
    outputs stay: the calls ask for the fixed order."""
    x = _image(dtype, shape, 6)
    want = [call() for _, call in _calls(x, mode, 3)]
    apply = td.Prefilter1d.apply

    def route(y, order, axis, bc, fixed_order=False):
        if fixed_order:
            return apply(y, order, axis, bc, True)
        return _recursion(y, order, axis, bc)
    monkeypatch.setattr(td.Prefilter1d, "apply", route)
    for (name, call), w in zip(_calls(x, mode, 3), want):
        np.testing.assert_array_equal(call(), w, err_msg=name)


@pytest.mark.parametrize("mode", sorted(tc._SPLINE_BC))
def test_integer_outputs_ask_for_the_fixed_order(mode, monkeypatch):
    seen = []
    apply = td.Prefilter1d.apply

    def spy(y, order, axis, bc, fixed_order=False):
        seen.append(fixed_order)
        return apply(y, order, axis, bc, fixed_order)
    monkeypatch.setattr(td.Prefilter1d, "apply", spy)
    x = _image(np.uint8, (9, 12), 1)
    for order in (0, 1, 2, 3, 4, 5):
        for out, want in ((np.empty(x.shape, np.int16), True),
                          (np.empty(x.shape, np.uint8), True),
                          (np.empty(x.shape, bool), True),
                          (np.empty(x.shape, np.float32), False),
                          (np.int16, False), (None, False)):
            for fn in (et.spline_filter, et.spline_filter1d):
                seen.clear()
                o = out.copy() if isinstance(out, np.ndarray) else out
                fn(x, order=order, mode=mode, output=o, device="cpu")
                assert len(seen) == (0 if order < 2 else
                                     2 if fn is et.spline_filter else 1)
                assert all(f is want for f in seen), (fn, order, out)


@pytest.mark.parametrize("mode", ["mirror", "reflect", "grid-wrap"])
@pytest.mark.parametrize("order", [2, 3, 4, 5])
@pytest.mark.parametrize("shape", [(16, 24), (8, 64), (4, 8, 16)])
def test_integer_outputs_equal_the_jax_package(shape, order, mode):
    """Where R10 says the orders of the sums agree: float64, lines of 4-64,
    every column count a multiple of 8."""
    x = _image(np.int16, shape, order).astype(np.float64)
    for dtype in (np.int16, np.uint8):
        xs = x if dtype == np.int16 else np.abs(x) % 256
        for name, port, jax_fn in (
                ("spline_filter", et.spline_filter, ej.spline_filter),
                ("spline_filter1d", et.spline_filter1d,
                 ej.spline_filter1d)):
            got = port(xs, order=order, mode=mode,
                       output=np.empty(shape, dtype), device="cpu")
            want = jax_fn(xs, order=order, mode=mode,
                          output=np.empty(shape, dtype))
            np.testing.assert_array_equal(got, want, err_msg=name)
