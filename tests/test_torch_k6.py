"""K6, the reflect/wrap spline prefilter, on its two routes.

The card runs K6 (``spline_filter1d_bc``) either as line tiles staged in
shared memory (the tile kernel of K2, K4 and K7, with K6's stage sets) or
one thread per line in device memory, with the stages of ``k6_stages`` in
``csrc/prefilter.cu`` on both; ``ops/prefilter.py``'s ``_tile_plan``
picks the route and the tile from the shape. On the CPU:

* a numpy model of ``k6_stages`` in the kernel's operation order (the
  gain, per pole the initialisation over the whole period, the causal
  pass, the anti-causal initialisation and pass) against
  ``filter_matrix_bc(n, order, bc)``, 1e-13;
* the plan at K6's shapes (c8's and c9's axes): every line in exactly one
  tile;
* K6's route counters: a CPU tensor takes the twin and counts nothing;
* reference note R3: on short lines ``filter_matrix_bc(n, order,
  'reflect')``, and so K6's twin, departs from SciPy's own
  ``spline_filter1d(mode='reflect')``; the size of the departure, pinned.

The ``cuda`` test holds both routes against the twin and each other and
skips without a card.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from elasticdeform_tpu_torch.ops import prefilter as tp

DTYPES = [torch.float32, torch.float64]


def _k6_model(x, order, bc):
    """numpy float64 model of K6 on one line (``k6_stages`` in
    ``csrc/prefilter.cu``), in the kernel's operation order."""
    x = np.array(x, dtype=np.float64)
    n = len(x)
    poles = tp.spline_poles(order)
    if n <= 1 or not poles:
        return x
    x = x * tp._gain(poles)
    for z in poles:
        zn = z ** n
        if bc == "reflect":
            c0, zi, acc = x[0], 1.0, 0.0
            for i in range(n):
                acc = acc + zi * (x[i] + zn * x[n - 1 - i])
                zi = zi * z
            x[0] = acc * (z / (1.0 - zn * zn)) + c0
        else:
            zi, acc = z, x[0]
            for i in range(1, n):
                acc = acc + zi * x[n - i]
                zi = zi * z
            x[0] = acc * (1.0 / (1.0 - zn))
        prev = x[0]
        for k in range(1, n):
            prev = x[k] + z * prev
            x[k] = prev
        if bc == "reflect":
            prev = prev * (z / (z - 1.0))
        else:
            zi, acc = z, prev
            for i in range(n - 1):
                acc = acc + zi * x[i]
                zi = zi * z
            prev = acc * (z / (zn - 1.0))
        x[n - 1] = prev
        for k in range(n - 2, -1, -1):
            prev = z * (prev - x[k])
            x[k] = prev
    return x


@pytest.mark.parametrize("bc", ["reflect", "wrap"])
@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_k6_model_is_filter_matrix_bc(order, bc):
    """Lines of 1-5, around the poles' horizons, and c8's and c9's axes."""
    horizons = [tp._horizon(z) for z in tp.spline_poles(order)]
    lengths = sorted({1, 2, 3, 4, 5, 96, 160, 192, 224} |
                     {h + d for h in horizons for d in (-1, 0, 1)})
    for n in lengths:
        k6 = np.stack([_k6_model(e, order, bc) for e in np.eye(n)], 1)
        np.testing.assert_allclose(k6, tp.filter_matrix_bc(n, order, bc),
                                   rtol=0, atol=1e-13)


def _covered(plan, outer, inner):
    """Lines the tiles of ``plan`` cover, each counted once per tile."""
    if plan.packed:
        g = plan.lines // inner
        assert plan.blocks == -(-outer // g)
        return min(plan.blocks * g, outer) * inner
    col = -(-inner // plan.width)
    assert plan.blocks == outer * col
    return outer * min(col * plan.width, inner)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [None, 32, 64, 128])
def test_plan_covers_k6_lines_once(dtype, width):
    """K6's views at c8 (1 x 160 x 192 x 224) and c9 (96^3), and partial
    last tiles: each on the tile route, every line in one tile."""
    shapes = [(1, 160, 43008), (160, 192, 224), (30720, 224, 1),
              (1, 96, 9216), (96, 96, 96), (9216, 96, 1), (7, 9, 33),
              (131, 64, 1), (5, 2, 100)]
    for outer, n, inner in shapes:
        plan = tp._tile_plan(outer, n, inner, dtype, width=width)
        assert plan.route == "tile" and plan.smem <= tp.SMEM_LIMIT
        assert _covered(plan, outer, inner) == outer * inner


def test_cpu_tensors_count_no_route():
    x = torch.as_tensor(np.random.RandomState(3).standard_normal((4, 9, 3)))
    fn = tp.spline_filter1d_bc
    for bc in ("reflect", "wrap"):
        before, routes = fn.launches, dict(fn.routes)
        np.testing.assert_array_equal(
            fn(x, 3, 1, bc).numpy(),
            tp.spline_filter1d_bc_plain(x, 3, 1, bc).numpy())
        assert fn.launches == before and fn.routes == routes
        assert set(routes) == {"tile", "lines", "writeback"}


# R3: max |filter_matrix_bc(n, order, 'reflect') - scipy's reflect filter|
# over the matrix, as found (scipy 1.17); the departure falls as the poles'
# powers over the line and is round-off from n = 24 on
R3_DEPARTURE = {2: {2: 3.59e-05, 3: 6.16e-06, 5: 5.36e-09},
                3: {2: 6.32e-04, 3: 1.68e-04, 5: 8.85e-07, 9: 2.35e-11},
                4: {2: 4.68e-03, 3: 1.66e-03, 5: 2.98e-05, 9: 8.65e-09},
                5: {2: 1.61e-02, 3: 6.68e-03, 5: 2.51e-04, 9: 2.97e-07,
                    16: 2.24e-12}}


@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_r3_reflect_departs_from_scipy_on_short_lines(order):
    """The K6 twin applied to the identity is ``filter_matrix_bc``; on lines
    shorter than the poles' horizons SciPy's reflect filter (its truncated
    initialisations) differs from it by the sizes found, within a factor
    of 2, and from n = 24 on by round-off only."""
    for n in (2, 3, 5, 9, 16, 24, 32, 64):
        eye = torch.eye(n, dtype=torch.float64)
        twin = tp.spline_filter1d_bc_plain(eye, order, 0, "reflect").numpy()
        scipy = np.stack([ndi.spline_filter1d(e, order, mode="reflect")
                          for e in np.eye(n)], 1)
        got = float(np.abs(twin - scipy).max())
        want = R3_DEPARTURE[order].get(n)
        if want is not None:
            assert want / 2 <= got <= want * 2, (n, got, want)
        else:
            assert got < 1e-10, (n, got)
            if n >= 24:
                assert got < 1e-14, (n, got)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bc", ["reflect", "wrap"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_both_routes_match_plain_and_each_other(cuda_device, dtype, bc):
    rs = np.random.RandomState(7)
    cap = tp.tile_cap(dtype)
    for (outer, n, inner), order in zip(
            [(131, 64, 1), (23, 30, 3), (5, 40, 33), (2, 224, 100),
             (3, cap, 5), (2, cap + 1, 1), (4, 1, 3), (3, 2, 7)],
            (2, 3, 4, 5, 3, 5, 3, 2)):
        x = torch.as_tensor(rs.rand(outer, n, inner) * 300 - 100,
                            dtype=dtype, device=cuda_device)
        lines = tp._launch_bc_filter(x, order, 1, bc, tp._tile_plan(
            outer, n, inner, dtype, route="lines"))
        tol = 1e-5 if dtype == torch.float32 else 1e-10
        torch.testing.assert_close(
            lines, tp.spline_filter1d_bc_plain(x, order, 1, bc), rtol=tol,
            atol=tol * float(x.abs().max()))
        for width in tp.TILE_WIDTHS:
            try:
                plan = tp._tile_plan(outer, n, inner, dtype, width=width,
                                     route="tile")
            except ValueError:
                continue
            assert torch.equal(tp._launch_bc_filter(x, order, 1, bc, plan),
                               lines)
