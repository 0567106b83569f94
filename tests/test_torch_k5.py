"""The coordinate gradient (kernels K5 and K5c) on the CPU.

* The plain twin, which contracts the taps axis by axis in the kernels'
  order, against the per-tap formula below (every tap's weight product
  formed anew): naxis 1-4, orders 0-5, the five
  modes, one and three channels, coordinates far past every edge and on
  the clip ties; float64, ``1e-12 * 2C * max|g| * max|coeffs|``.
* The port's gradients with respect to the coordinates, the dense field and
  the control-point grid against ``jax.vjp`` of the JAX package's
  ``map_coordinates``, ``deform_field`` and ``deform`` at naxis 1 and 4
  (the 2-D and 3-D cases are in ``test_torch_mapcoords.py`` and
  ``test_torch_gradient*.py``): float64, ``rtol=1e-9``,
  ``atol=1e-12 * max|ref|``.
* The index width the wrappers pick from the shapes.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import elasticdeform_tpu as ej

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch.ops import modes as tm
from elasticdeform_tpu_torch.ops import resample_bwd as trb
from elasticdeform_tpu_torch.ops.bspline import spline_weights_grad
from elasticdeform_tpu_torch.ops.resample import (
    map_all, mirror_pad, tap_geometry, tap_products,
)

MODES = ["nearest", "wrap", "reflect", "mirror", "constant"]
SHAPES = {1: ((23,), (40,)), 2: ((9, 11), (7, 8)),
          3: ((7, 6, 5), (5, 4, 6)), 4: ((5, 6, 4, 5), (3, 4, 3, 2))}
GRAD = 1e-9


def _per_tap_reference(coeffs, g, coords, order, mode):
    """d <resample_coords(coeffs, coords), g> / d coords, one tap at a
    time: for every tap the naxis weight products (the derivative weights
    along axis h in product h), formed left to right, times ``sum_c g_c *
    coeff_c``, summed over the taps with axis 0 slowest."""
    B, naxis = coords.shape[:2]
    if order == 0:
        return torch.zeros_like(coords)
    cc = [coords[:, h] for h in range(naxis)]
    in_spatial = tuple(coeffs.shape[1:naxis + 1])
    C = coeffs.shape[-1]
    mapped, inside = map_all(cc, in_spatial, mode)
    pad, padded, base, strides, weights = tap_geometry(in_spatial, mapped,
                                                       order)
    n_out = base.numel()
    dweights = [[d.reshape(n_out) for d in spline_weights_grad(m, order)]
                for m in mapped]
    factors = [[dweights[l] if l == h else weights[l] for l in range(naxis)]
               for h in range(naxis)]
    rows = B * math.prod(padded)
    xf = mirror_pad(coeffs, range(1, naxis + 1), pad).reshape(rows, C)
    g2 = g.reshape(n_out, C)
    acc = [None] * naxis
    for offset, parts in tap_products(order, strides, factors):
        vals = torch.index_select(xf, 0, torch.clamp(base + offset, 0,
                                                     rows - 1))
        gc = g2[:, 0] * vals[:, 0]
        for c in range(1, C):
            gc = gc + g2[:, c] * vals[:, c]
        for h in range(naxis):
            term = gc * parts[h]
            acc[h] = term if acc[h] is None else acc[h] + term
    out = torch.stack([
        tm.map_coordinate_grad(cc[h], in_spatial[h], mode).reshape(n_out)
        * acc[h] for h in range(naxis)])
    out = out.reshape(naxis, B, *coords.shape[2:]).transpose(0, 1)
    if inside is not None:
        out = torch.where(inside[:, None], out, torch.zeros((),
                                                            dtype=out.dtype))
    return out


def _tie_coords(rs, in_shape, out_shape, B=2, reach=2.5):
    """(B, naxis, *out_shape) coordinates from ``-reach`` to ``reach + 1``
    extents, the first voxels of each sample exactly on the clip ties
    (0 and len-1), on integers and at half a voxel below 0."""
    c = np.stack([np.stack([rs.uniform(-reach * n, (reach + 1) * n,
                                       size=out_shape) for n in in_shape])
                  for _ in range(B)])
    flat = c.reshape(B, len(in_shape), -1)
    for h, n in enumerate(in_shape):
        ties = (0.0, n - 1.0, float(n // 2), -0.5, 0.0, n - 1.0)
        k = min(len(ties), flat.shape[2])
        flat[:, h, :k] = ties[:k]
    return c


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("mode", range(5))
@pytest.mark.parametrize("order", range(6))
@pytest.mark.parametrize("naxis", [1, 2, 3, 4])
def test_twin_equals_per_tap_formula(naxis, order, mode, channels):
    rs = np.random.RandomState(naxis * 100 + order * 10 + mode + channels)
    in_shape, out_shape = SHAPES[naxis]
    coeffs = torch.as_tensor(rs.rand(2, *in_shape, channels) * 4 - 1)
    coords = torch.as_tensor(_tie_coords(rs, in_shape, out_shape))
    g = torch.as_tensor(rs.randn(2, *out_shape, channels))
    got = trb.resample_coords_grad_plain(coeffs, g, coords, order, mode)
    want = _per_tap_reference(coeffs, g, coords, order, mode)
    assert got.shape == coords.shape and got.dtype == coords.dtype
    scale = 2 * channels * float(g.abs().max()) * float(coeffs.abs().max())
    err = float((got - want).abs().max())
    assert err <= 1e-12 * scale, (err, scale)
    if order and mode != tm.MODE_CONSTANT:
        assert float(want.abs().max()) > 0


@pytest.mark.parametrize("naxis", [1, 4])
def test_twin_on_the_dense_displacement(naxis):
    """K5's twin (dense displacement, affine and crop offsets) equals K5c's
    at the same sample coordinates, and the per-tap formula."""
    rs = np.random.RandomState(naxis)
    in_shape, out_shape = SHAPES[naxis]
    coeffs = torch.as_tensor(rs.rand(2, *in_shape, 2))
    displ = torch.as_tensor(rs.randn(2, naxis, *out_shape) * 3)
    g = torch.as_tensor(rs.randn(2, *out_shape, 2))
    A = np.concatenate([np.eye(naxis) + rs.randn(naxis, naxis) * 0.1,
                        rs.randn(naxis, 1)], 1)
    affine = torch.as_tensor(A)
    offsets = tuple(range(1, naxis + 1))
    from elasticdeform_tpu_torch.ops.resample import sample_coordinates
    coords = torch.stack(sample_coordinates(displ, affine, offsets), 1)
    for mode in range(5):
        got = trb.resample_coord_grad_plain(coeffs, g, displ, affine,
                                            offsets, 3, mode)
        torch.testing.assert_close(
            got, trb.resample_coords_grad_plain(coeffs, g, coords, 3, mode),
            rtol=0, atol=0)
        scale = 4 * float(g.abs().max()) * float(coeffs.abs().max())
        want = _per_tap_reference(coeffs, g, coords, 3, mode)
        assert float((got - want).abs().max()) <= 1e-12 * scale


def _close(got, want, rtol=GRAD):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * scale)


def _vjp_both(fn_j, fn_t, X, c, G):
    """Gradients to X and to ``c``: JAX's vjp and torch autograd through
    the port on the CPU."""
    _, vjp = jax.vjp(fn_j, jnp.asarray(X), jnp.asarray(c))
    want = vjp(jnp.asarray(G))
    xt = torch.tensor(X, requires_grad=True)
    ct = torch.tensor(c, requires_grad=True)
    got = torch.autograd.grad(fn_t(xt, ct), (xt, ct), torch.tensor(G))
    return got, want


_IN = {1: (30,), 4: (6, 5, 4, 7)}


@pytest.mark.parametrize("mode", ["nearest", "mirror", "constant"])
@pytest.mark.parametrize("naxis", [1, 4])
def test_map_coordinates_vjp(naxis, mode):
    rs = np.random.RandomState(naxis * 7 + MODES.index(mode))
    X = rs.rand(*_IN[naxis])
    out_shape = (26,) if naxis == 1 else (4, 3, 5)
    c = _tie_coords(rs, X.shape, out_shape, B=1, reach=0.3)[0]
    G = rs.randn(*out_shape)
    kw = dict(order=3, mode=mode, cval=0.5)
    got, want = _vjp_both(
        lambda x, cc: ej.map_coordinates(x, cc, **kw),
        lambda x, cc: et.map_coordinates(x, cc, device="cpu", **kw), X, c, G)
    for a, b in zip(got, want):
        _close(a, b)
    assert np.abs(np.asarray(want[1])).max() > 0


@pytest.mark.parametrize("mode", ["reflect", "constant"])
@pytest.mark.parametrize("naxis", [1, 4])
def test_deform_field_vjp(naxis, mode):
    rs = np.random.RandomState(naxis * 11 + MODES.index(mode))
    X = rs.rand(*_IN[naxis])
    field = rs.randn(naxis, *X.shape) * 2
    G = rs.randn(*X.shape)
    kw = dict(order=3, mode=mode, cval=0.25)
    got, want = _vjp_both(
        lambda x, f: ej.deform_field(x, f, **kw),
        lambda x, f: et.deform_field(x, f, device="cpu", **kw), X, field, G)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("mode", ["wrap", "mirror"])
@pytest.mark.parametrize("naxis", [1, 4])
def test_deform_grid_vjp(naxis, mode):
    rs = np.random.RandomState(naxis * 13 + MODES.index(mode))
    X = rs.rand(*_IN[naxis])
    d = rs.randn(naxis, *(3,) * naxis) * (4 if naxis == 1 else 2)
    G = rs.randn(*X.shape)
    kw = dict(order=3, mode=mode)
    got, want = _vjp_both(
        lambda x, dd: ej.deform(x, dd, **kw),
        lambda x, dd: et.deform(x, dd, device="cpu", **kw), X, d, G)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("n_in, n_out, channels, naxis, wide", [
    (2 ** 31 - 1, 1000, 1, 3, False),
    (2 ** 31, 1000, 1, 3, True),
    (2 ** 30, 1000, 2, 3, True),
    ((2 ** 31 - 1) // 3, 1000, 3, 3, False),
    (1000, (2 ** 31 - 1) // 4, 1, 4, False),
    (1000, 2 ** 31 // 4, 1, 4, True),
    (1000, 2 ** 31 // 3 + 1, 3, 2, True),
    (1000, 2 ** 31 // 3, 3, 2, False),
])
def test_index_width_follows_the_shapes(n_in, n_out, channels, naxis, wide):
    """64-bit indices exactly when one sample of the coefficients
    (n_in * C), of g (n_out * C) or of the coordinates (naxis * n_out)
    reaches 2**31 elements."""
    assert trb.wide_indices(n_in, n_out, channels, naxis) is wide
