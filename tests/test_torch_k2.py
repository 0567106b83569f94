"""K2, the spline prefilter, on its two routes.

The card runs K2 (``spline_filter1d``) either as line tiles staged in
shared memory or one thread per line in device memory, with the stages of
``k2_stages`` in ``csrc/prefilter.cu`` on both; ``ops/prefilter.py``'s
``_tile_plan`` picks the route and the tile from the shape, as for K4 and
K7. On the CPU:

* a numpy model of ``k2_stages`` in the kernel's operation order (the
  gain, both branches of the causal initialisation, the passes) against
  ``filter_matrix(n, order)``, 1e-13;
* the K2 plain twin against the JAX package's ``spline_filter1d``
  (float64, 1e-10) at the shapes the route sweep of ``chip_smoke.py``
  adds, and with the integer writeback against the JAX package's
  ``ops/deform.py::_prefilter_input``, bit for bit;
* the plan at K2's shapes: every line in exactly one tile.

The ``cuda`` test holds both routes against the twin and each other (with
an integer writeback, K2's writeback route in its tile and lines forms,
bit for bit with the twin), and skips without a card.
"""

import itertools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from elasticdeform_tpu.ops import deform as jd
from elasticdeform_tpu.ops import prefilter as jp

from elasticdeform_tpu_torch.ops import prefilter as tp

DTYPES = [torch.float32, torch.float64]


def _cast_int_c(v, lo, span):
    """``cast_int_c`` in ``csrc/prefilter.cu``: truncate, wrap."""
    tr = np.trunc(v)
    return tr - np.floor((tr - lo) / span) * span


def _k2_model(x, order, int_dtype=None):
    """numpy float64 model of K2 on one line (``k2_stages`` in
    ``csrc/prefilter.cu``), in the kernel's operation order; with
    ``int_dtype``, then the integer writeback."""
    x = np.array(x, dtype=np.float64)
    n = len(x)
    poles = tp.spline_poles(order)
    if n > 1 and poles:
        x = x * tp._gain(poles)
        for z in poles:
            h = tp._horizon(z)
            if h < n:
                acc, zn = x[0], z
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
            prev = x[0]
            for k in range(1, n):
                prev = x[k] + z * prev
                x[k] = prev
            prev = (z / (z * z - 1.0)) * (prev + z * x[n - 2])
            x[n - 1] = prev
            for k in range(n - 2, -1, -1):
                prev = z * (prev - x[k])
                x[k] = prev
    if int_dtype is not None:
        bits, lo = tp._int_writeback(int_dtype)
        x = _cast_int_c(x, lo, 2.0 ** bits)
    return x


@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_k2_model_is_filter_matrix(order):
    """Both causal-initialisation branches: lines shorter than, at and
    longer than each pole's horizon, and 224 (c8's innermost axis)."""
    horizons = [tp._horizon(z) for z in tp.spline_poles(order)]
    lengths = sorted({1, 2, 3, 224} | {h + d for h in horizons
                                       for d in (-1, 0, 1)})
    for n in lengths:
        k2 = np.stack([_k2_model(e, order) for e in np.eye(n)], 1)
        np.testing.assert_allclose(k2, tp.filter_matrix(n, order), rtol=0,
                                   atol=1e-13)


@pytest.mark.parametrize("int_dtype", [np.uint8, np.int16, np.bool_])
@pytest.mark.parametrize("n", [1, 9, 40])
def test_k2_model_writeback_is_the_twin(n, int_dtype):
    """The recursion, then the cast, n = 1 included (no filter, the cast
    alone), against the twin's row sums and ``cast_int_c``: they agree on
    these draws. (At n = 2 and 3 the filter maps integers to rationals of
    small denominators, some of them integers, where truncation tells the
    two summation orders apart: so an integer input takes K2's writeback
    route, which sums in the twin's order; ``test_torch_k2_writeback.py``.)
    """
    rs = np.random.RandomState(n)
    lines = rs.randint(-3000, 3000, (5, n)).astype(np.float64)
    for order in (2, 3, 5):
        want = tp.spline_filter1d_plain(torch.as_tensor(lines), order, 1,
                                        int_dtype).numpy()
        got = np.stack([_k2_model(ln, order, int_dtype) for ln in lines])
        np.testing.assert_allclose(got, want, rtol=0, atol=0)


# (outer, n, inner): the route sweep's inner 1/3/33/64/100, c2's channel
# axis, lines at and past the float64 cap
TWIN_SHAPES = [(131, 9, 1), (23, 64, 3), (5, 40, 33), (3, 30, 64),
               (2, 24, 100), (200, 300, 3), (2, 880, 1), (1, 881, 2)]


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * float(np.abs(want).max()))


@pytest.mark.parametrize("order", [2, 3, 5])
@pytest.mark.parametrize("shape", TWIN_SHAPES)
def test_k2_twin_is_the_jax_filter(shape, order):
    x = np.random.RandomState(sum(shape) + order).standard_normal(shape)
    _close(tp.spline_filter1d_plain(torch.as_tensor(x), order, 1),
           jp.spline_filter1d(jnp.asarray(x), order, 1))


@pytest.mark.parametrize("dtype", ["uint8", "int16"])
@pytest.mark.parametrize("order", [2, 3, 5])
def test_k2_writeback_is_the_jax_prefilter_input(order, dtype):
    """Two axes of a (40, 33, 3) integer input, the integer writeback
    after each, as the JAX package's forward prefilters its input."""
    info = np.iinfo(dtype)
    rs = np.random.RandomState(order)
    x = rs.randint(info.min, int(info.max) + 1, (40, 33, 3)).astype(dtype)
    ispec = jd.InputSpec(shape=x.shape, dtype=dtype, axis=(0, 1),
                         order=order, mode=0, cval=0.0, out_shape=x.shape)
    spec = jd.DeformSpec(inputs=(ispec,), deform_shape=(40, 33),
                         out_spatial=(40, 33), offsets=(0, 0),
                         prefilter=True, compute_dtype="float64",
                         has_affine=False)
    want = np.asarray(jd._prefilter_input(jnp.asarray(x), ispec, spec,
                                          jnp.float64, True))
    got = torch.as_tensor(x.astype(np.float64))
    for axis in (0, 1):
        got = tp.spline_filter1d_plain(got, order, axis, np.dtype(dtype))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_plan_covers_its_lines_once(dtype):
    """K2's views at c1, c2, c5 and c10: each route the plan names; a tile
    plan puts every line in exactly one block."""
    shapes = [(1, 200, 300), (200, 300, 1), (1, 200, 900), (200, 300, 3),
              (64, 64, 4096), (4096, 64, 64), (262144, 64, 1),
              (1, 152, 23104), (23104, 152, 1)]
    for outer, n, inner in shapes:
        plan = tp._tile_plan(outer, n, inner, dtype)
        assert plan.route == "tile" and plan.smem <= tp.SMEM_LIMIT
        if plan.packed:
            g = plan.lines // inner
            assert plan.blocks == -(-outer // g)
            covered = min(plan.blocks * g, outer) * inner
        else:
            col = -(-inner // plan.width)
            assert plan.blocks == outer * col
            covered = outer * min(col * plan.width, inner)
        assert covered == outer * inner


def test_cpu_tensors_count_no_route():
    x = torch.as_tensor(np.random.RandomState(3).standard_normal((4, 9, 3)))
    before, routes = tp.spline_filter1d.launches, dict(
        tp.spline_filter1d.routes)
    tp.spline_filter1d(x, 3, 1)
    tp.spline_filter1d(x, 3, 1, np.uint8)
    assert tp.spline_filter1d.launches == before
    assert tp.spline_filter1d.routes == routes
    assert set(routes) == {"tile", "lines", "writeback"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("int_dtype", [None, np.uint8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_both_routes_match_plain_and_each_other(cuda_device, dtype,
                                                int_dtype):
    rs = np.random.RandomState(7)
    cap = tp.tile_cap(dtype)
    for (outer, n, inner), order in itertools.product(
            [(131, 64, 1), (23, 30, 3), (5, 40, 33), (2, 224, 100),
             (3, cap, 5), (2, cap + 1, 1), (4, 1, 3), (3, 2, 7)], (2, 3, 5)):
        x = torch.as_tensor(rs.rand(outer, n, inner) * 300 - 100,
                            dtype=dtype, device=cuda_device)
        plain = tp.spline_filter1d_plain(x, order, 1, int_dtype)
        lines = tp._launch_filter(x, order, 1, tp._tile_plan(
            outer, n, inner, dtype, route="lines"), int_dtype)
        scale = float(x.abs().max())
        tol = 1e-5 if dtype == torch.float32 else 1e-10
        if int_dtype is None:
            torch.testing.assert_close(lines, plain, rtol=tol,
                                       atol=tol * scale)
        else:   # the writeback route, in its twin's order
            assert torch.equal(lines, plain)
        for width in tp.TILE_WIDTHS:
            try:
                plan = tp._tile_plan(outer, n, inner, dtype, width=width,
                                     route="tile")
            except ValueError:
                continue
            assert torch.equal(tp._launch_filter(x, order, 1, plan,
                                                 int_dtype), lines)
