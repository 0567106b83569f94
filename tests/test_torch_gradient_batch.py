"""Autograd through the port's ``deform`` and ``deform_batch``, and the
batched gradient entry points, against the JAX package on the CPU.

``torch.autograd.grad`` with respect to X and the displacement grid is held
against ``jax.vjp`` of ``elasticdeform_tpu.deform`` / ``deform_batch`` with
the same cotangent, rtol 1e-8 and atol 1e-12 * max|ref| (float64; the two
differ by the order of float64 sums); ``deform_batch_gradient`` against the
JAX package's, rtol 1e-9.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import elasticdeform_tpu as ej
from elasticdeform_tpu import api as japi

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch import api as tapi
from elasticdeform_tpu_torch import core as tcore
from elasticdeform_tpu_torch.ops import deform as tdef

MODES = ["nearest", "wrap", "reflect", "mirror", "constant"]


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * scale)


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("order", [1, 2, 3, 4, 5])
def test_autograd_deform_matches_jax_vjp(order, mode):
    rs = np.random.RandomState(order * 5 + MODES.index(mode))
    X = rs.rand(13, 11)
    d = rs.randn(2, 3, 3) * 5
    gy = rs.randn(13, 11)
    kw = dict(order=order, mode=mode, cval=0.5)
    _, vjp = jax.vjp(lambda x, dd: ej.deform(x, dd, **kw), jnp.asarray(X),
                     jnp.asarray(d))
    gx, gd = vjp(jnp.asarray(gy))
    xt, dt = _leaf(X), _leaf(d)
    y = et.deform(xt, dt, device="cpu", **kw)
    tgx, tgd = torch.autograd.grad(y, (xt, dt), torch.as_tensor(gy))
    _close(tgx.numpy(), gx, 1e-8)
    _close(tgd.numpy(), gd, 1e-8)


@pytest.mark.parametrize("case", ["mirror", "constant_crop"])
def test_autograd_deform_batch_matches_jax_vjp(case):
    rs = np.random.RandomState(len(case))
    X = rs.rand(3, 10, 12, 9)
    d = rs.randn(3, 3, 3, 3, 3) * 3
    kw = dict(order=3, mode="mirror") if case == "mirror" else dict(
        order=3, mode="constant", crop=[slice(1, 9), slice(None),
                                        slice(2, 8)])
    y, vjp = jax.vjp(lambda x, dd: ej.deform_batch(x, dd, **kw),
                     jnp.asarray(X), jnp.asarray(d))
    gy = rs.randn(*y.shape)
    gx, gd = vjp(jnp.asarray(gy))
    xt, dt = _leaf(X), _leaf(d)
    yt = et.deform_batch(xt, dt, device="cpu", **kw)
    tgx, tgd = torch.autograd.grad(yt, (xt, dt), torch.as_tensor(gy))
    _close(tgx.numpy(), gx, 1e-8)
    _close(tgd.numpy(), gd, 1e-8)


def test_autograd_multi_input_sums_the_grid_gradient():
    # two float inputs share one grid: their grid gradients add; an
    # integer input's output is not differentiable and adds nothing
    rs = np.random.RandomState(8)
    a, b = rs.rand(12, 10), rs.rand(12, 10)
    seg = (rs.rand(12, 10) * 4).astype(np.uint8)
    d = rs.randn(2, 3, 3) * 4
    kw = dict(order=[3, 1, 0], mode=["mirror", "constant", "nearest"])
    ga, gb = rs.randn(12, 10), rs.randn(12, 10)
    _, vjp = jax.vjp(lambda dd: tuple(ej.deform(
        [jnp.asarray(a), jnp.asarray(b), jnp.asarray(seg)], dd,
        **kw)[:2]), jnp.asarray(d))
    (gd,) = vjp((jnp.asarray(ga), jnp.asarray(gb)))
    dt = _leaf(d)
    ys = et.deform([torch.as_tensor(a), torch.as_tensor(b),
                    torch.as_tensor(seg)], dt, device="cpu", **kw)
    assert ys[2].dtype == torch.uint8 and not ys[2].requires_grad
    (tgd,) = torch.autograd.grad(ys[:2], (dt,), (torch.as_tensor(ga),
                                                 torch.as_tensor(gb)))
    _close(tgd.numpy(), gd, 1e-8)


def test_autograd_float32_input_float64_grid_dtypes():
    rs = np.random.RandomState(6)
    xt = _leaf(rs.rand(9, 10).astype(np.float32))
    dt = _leaf(rs.randn(2, 3, 3))
    y = et.deform(xt, dt, device="cpu")
    gx, gd = torch.autograd.grad(y.sum(), (xt, dt))
    assert y.dtype == gx.dtype == torch.float32 and gd.dtype == torch.float64


def test_grid_gradient_runs_only_when_asked(monkeypatch):
    # the backward computes only what needs_input_grad asks for: without a
    # grid that requires grad, K5's wrapper is never called
    calls = []
    real = tdef.resample_coord_grad
    monkeypatch.setattr(tdef, "resample_coord_grad",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rs = np.random.RandomState(1)
    xt = _leaf(rs.rand(8, 9))
    d = torch.as_tensor(rs.randn(2, 3, 3))
    torch.autograd.grad(et.deform(xt, d, device="cpu").sum(), xt)
    assert calls == []
    dt = _leaf(d.numpy())
    torch.autograd.grad(et.deform(xt.detach(), dt, device="cpu").sum(), dt)
    assert calls == [1]


@pytest.mark.parametrize("case", ["plain", "crop_x_shape", "list"])
def test_deform_batch_gradient_matches_jax(case):
    rs = np.random.RandomState(2)
    B = 3
    d = rs.randn(B, 2, 3, 4) * 5
    if case == "plain":
        dY = rs.randn(B, 14, 12)
        kw = dict(order=3, mode="reflect")
    elif case == "crop_x_shape":
        dY = rs.randn(B, 10, 8)
        kw = dict(order=4, mode="constant", crop=[slice(2, 12), slice(1, 9)],
                  X_shape=(14, 12))
    else:
        dY = [rs.randn(B, 14, 12).astype(np.float32), rs.randn(B, 14, 12)]
        kw = dict(order=[1, 5], mode="wrap")
    want = japi.deform_batch_gradient(dY, d, **kw)
    got = tapi.deform_batch_gradient(dY, d, device="cpu", **kw)
    if case != "list":
        got, want = [got], [want]
    for g, w in zip(got, want):
        _close(g, w, 1e-6 if g.dtype == np.float32 else 1e-9)
    # the tensor entry point gives the same
    tg = tcore.deform_batch_gradient(
        [torch.as_tensor(y) for y in (dY if case == "list" else [dY])],
        torch.as_tensor(d), device="cpu", **kw)
    for g, w in zip(tg, got):
        np.testing.assert_array_equal(g.numpy(), w)


def test_deform_batch_gradient_matches_stacked_single_calls():
    rs = np.random.RandomState(9)
    d = rs.randn(2, 3, 3, 3, 3) * 3
    dY = rs.randn(2, 6, 7, 5)
    kw = dict(order=3, mode="mirror", crop=[slice(1, 7), slice(0, 7),
                                            slice(2, 7)], X_shape=(8, 7, 9))
    got = tapi.deform_batch_gradient(dY, d, device="cpu", **kw)
    for b in range(2):
        single = et.deform_grid_gradient(dY[b], d[b], device="cpu", **kw)
        np.testing.assert_allclose(got[b], single, rtol=1e-12, atol=1e-12)


def test_batch_gradient_batch_mismatch_error():
    with pytest.raises(ValueError, match="leading batch axis matching dY"):
        tapi.deform_batch_gradient(np.zeros((2, 8, 8)), np.zeros(
            (3, 2, 3, 3)), device="cpu")


@pytest.mark.parametrize("batched", [False, True])
def test_autograd_grid_gradient_mixed_order_dtype(batched):
    # the grid gradient alone (X needs none) of a float64 and a float32
    # input with different orders and modes, summed over both
    rs = np.random.RandomState(12)
    lead = (2,) if batched else ()
    xs = [rs.rand(*lead, 11, 9), rs.rand(*lead, 11, 9).astype(np.float32)]
    d = rs.randn(*lead, 2, 3, 3) * 4
    gys = [rs.randn(*lead, 11, 9), rs.randn(*lead, 11, 9).astype(np.float32)]
    kw = dict(order=[3, 2], mode=["reflect", "constant"])
    jfwd, tfwd = ((ej.deform_batch, et.deform_batch) if batched
                  else (ej.deform, et.deform))
    _, vjp = jax.vjp(lambda dd: tuple(jfwd([jnp.asarray(x) for x in xs], dd,
                                           **kw)), jnp.asarray(d))
    (want,) = vjp(tuple(jnp.asarray(g) for g in gys))
    dt = _leaf(d)
    ys = tfwd([torch.as_tensor(x) for x in xs], dt, device="cpu", **kw)
    assert [y.dtype for y in ys] == [torch.float64, torch.float32]
    (got,) = torch.autograd.grad(ys, (dt,),
                                 [torch.as_tensor(g) for g in gys])
    _close(got.numpy(), want, 1e-8)
