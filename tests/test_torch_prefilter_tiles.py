"""K4 and K7, the transposed spline prefilters, on their two routes.

The card runs K4 (``spline_filter1d_transpose``) and K7
(``spline_filter1d_bc_transpose``) either as line tiles staged in shared
memory or one thread per line in device memory; ``ops/prefilter.py``'s
``_tile_plan`` picks the route and the tile from the shape. On the
CPU:

* the plan over a sweep of ``(outer, n, inner, dtype)``: every line falls
  in exactly one tile, the shared bytes stay within the card's 227 KB, the
  route switches at the tile cap, a tile of an axis with ``inner < W``
  starts on an outer boundary, and the walk of such a tile visits every
  element once;
* a numpy model of K4's stages in the kernel's operation order (both
  branches of the causal initialisation) against
  ``filter_matrix(n, order).T``, 1e-13;
* the K4 and K7 plain twins against the JAX package's
  ``spline_filter1d_transpose`` and ``filter_matrix_bc(...).T`` at the
  shapes the tile sweep of ``chip_smoke.py`` adds, float64, 1e-10.

The ``cuda`` tests hold both routes against the twins and each other, and
skip without a card.
"""

import itertools

import numpy as np
import pytest
import torch

from elasticdeform_tpu.ops import prefilter as jp

from elasticdeform_tpu_torch.ops import prefilter as tp

DTYPES = [torch.float32, torch.float64]


def _tiles(plan, outer, inner):
    """The lines ``(o, i)`` of each block of a tile plan, as the kernel
    maps them: a packed tile is ``lines // inner`` whole outers, a column
    tile ``width`` consecutive ``i`` of one outer."""
    if plan.packed:
        g = plan.lines // inner
        return [[(o, i) for o in range(b * g, min(b * g + g, outer))
                 for i in range(inner)] for b in range(plan.blocks)]
    col = -(-inner // plan.width)
    return [[(b // col, i) for i in range(
        (b % col) * plan.width, min((b % col + 1) * plan.width, inner))]
        for b in range(plan.blocks)]


PLAN_SHAPES = [(outer, n, inner)
               for outer, n, inner in itertools.product(
                   (1, 2, 5, 23, 131), (1, 2, 9, 64, 224), (1, 3, 31, 33, 64,
                                                            100, 130))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [None, 32, 64, 128])
def test_plan_covers_every_line_once(dtype, width):
    for outer, n, inner in PLAN_SHAPES:
        plan = tp._tile_plan(outer, n, inner, dtype, width=width)
        assert plan.route == "tile"
        assert plan.width in tp.TILE_WIDTHS
        item = 4 if dtype == torch.float32 else 8
        assert plan.smem <= tp.SMEM_LIMIT
        assert plan.packed == (inner < plan.width)
        if plan.packed:     # each outer's run, lines in distinct banks
            assert plan.stride >= n * inner
            assert plan.stride % 32 == inner % 32
            assert plan.smem == plan.lines // inner * plan.stride * item
        else:               # rows of W lines at an odd stride
            assert plan.stride % 2 == 1 and plan.stride >= plan.lines
            assert plan.smem == n * plan.stride * item
        tiles = _tiles(plan, outer, inner)
        seen = [line for t in tiles for line in t]
        assert len(seen) == len(set(seen)) == outer * inner
        for t in tiles:
            assert 0 < len(t) <= plan.lines
            if plan.packed:   # whole outers, from an outer boundary
                assert t[0][1] == 0 and len(t) % inner == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_switches_route_at_the_cap(dtype):
    cap = tp.tile_cap(dtype)
    item = 4 if dtype == torch.float32 else 8
    assert cap * 33 * item <= tp.SMEM_LIMIT < (cap + 1) * 33 * item
    assert cap == (1760 if dtype == torch.float32 else 880)
    for outer, inner in ((1, 1), (3, 5), (2, 100)):
        below = tp._tile_plan(outer, cap, inner, dtype)
        above = tp._tile_plan(outer, cap + 1, inner, dtype)
        assert below.route == "tile" and below.width == 32  # only 32 fits
        assert below.smem <= tp.SMEM_LIMIT
        assert above.route == "lines" and above.smem == 0
        assert above.blocks == -(-outer * inner // 256)
        with pytest.raises(ValueError):
            tp._tile_plan(outer, cap + 1, max(inner, 32), dtype,
                          width=32, route="tile")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sms", [114, 132])
def test_plan_takes_the_width_with_fewest_waves(dtype, sms):
    """Among the widths that fit, the fewest rounds of blocks on ``sms``
    SMs, 64 lines first, then 32, then 128 among equals."""
    prefer = (64, 32, 128)
    assert tp.TILE_WIDTHS == prefer
    for outer, n, inner in PLAN_SHAPES + [(30720, 224, 1), (1, 160, 43008),
                                          (160, 192, 224), (64, 64, 4096),
                                          (262144, 64, 1), (4, 800, 64)]:
        plan = tp._tile_plan(outer, n, inner, dtype, sms=sms)
        fits = []
        for w in tp.TILE_WIDTHS:
            try:
                fits.append(tp._tile_plan(outer, n, inner, dtype,
                                          width=w))
            except ValueError:
                pass
        least = min(tp.waves(p, sms) for p in fits)
        assert tp.waves(plan, sms) == least
        assert plan.width == min((p.width for p in fits
                                  if tp.waves(p, sms) == least),
                                 key=prefer.index)
        bpsm = tp.blocks_per_sm(plan)
        assert 1 <= bpsm and bpsm * plan.width <= 1024
        assert bpsm * (plan.smem + 1024) <= 233472
    # c8's innermost axis: 128-line tiles fill one round of an H100's SMs
    assert tp._tile_plan(30720, 224, 1, torch.float32).width == 128


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tp._tile_plan(2, 9, 4, torch.float32, width=48)
    with pytest.raises(ValueError):
        tp._tile_plan(2, 9, 4, torch.float32, route="scan")
    with pytest.raises(ValueError):
        tp._tile_plan(2, 1200, 64, torch.float32, width=128,
                      route="tile")
    empty = tp._tile_plan(0, 9, 4, torch.float32)
    assert empty.route == "tile" and empty.blocks == 0


@pytest.mark.parametrize("n,inner,width", [
    (1, 1, 32), (9, 1, 64), (2, 3, 32), (9, 3, 128), (5, 7, 64),
    (64, 1, 128), (3, 33, 64), (40, 31, 32), (9, 64, 128)])
def test_packed_walk_visits_each_element_once(n, inner, width):
    """The walk of a packed tile (``packed_walk`` in ``csrc/prefilter.cu``):
    thread w takes elements w, w + W, ... of the run, carrying (outer,
    offset r in its run) by the step W = dol outers + dr elements; each
    element lands once, at shared offset outer * stride + r, where line
    (outer, i) finds its element k at outer * stride + k * inner + i, and
    the 32 lines a warp filters fall in 32 distinct banks."""
    for outer in (1, 2, 7):
        plan = tp._tile_plan(outer, n, inner, torch.float32,
                             width=width)
        assert plan.packed
        run = n * inner
        dol, dr = width // run, width % run
        outers = min(plan.lines // inner, outer)
        hits = {}
        for w in range(width):
            ol, r = w // run, w % run
            for e in range(w, outers * run, width):
                assert ol * run + r == e
                hits[e] = ol * plan.stride + r
                r += dr
                wrap = r >= run
                r -= run if wrap else 0
                ol += dol + wrap
        assert sorted(hits) == list(range(outers * run))
        assert len(set(hits.values())) == len(hits)
        assert max(hits.values()) < plan.smem // 4
        for k in range(n):
            for w0 in range(0, plan.lines, 32):
                banks = {((w // inner) * plan.stride + k * inner + w % inner)
                         % 32 for w in range(w0, min(w0 + 32, plan.lines))}
                assert len(banks) == min(32, plan.lines - w0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_line_up_to_the_cap_has_a_tile(dtype):
    """A packed tile pads each outer's run by up to 31 elements; it still
    fits at every length up to the cap."""
    cap = tp.tile_cap(dtype)
    for n in range(cap - 64, cap + 1):
        for inner in range(1, 40):
            plan = tp._tile_plan(3, n, inner, dtype)
            assert plan.route == "tile" and plan.smem <= tp.SMEM_LIMIT


def _k4_model(x, order):
    """numpy float64 model of K4 (``k4_stages`` in ``csrc/prefilter.cu``,
    then the gain) on one line, in the kernel's operation order."""
    x = np.array(x, dtype=np.float64)
    n = len(x)
    poles = tp.spline_poles(order)
    if n <= 1 or not poles:
        return x
    for z in poles[::-1]:
        u = x[0]
        for k in range(n - 1):
            u, x[k] = x[k + 1] + z * u, u * -z
        c = z / (z * z - 1.0)
        x[n - 2] = x[n - 2] + (c * z) * u
        x[n - 1] = u * c
        v = x[n - 1]
        for k in range(n - 1, 0, -1):
            v = x[k - 1] + z * v
            x[k - 1] = v
        horizon = tp._horizon(z)
        if horizon < n:
            c0, zn = x[0], z
            for k in range(1, horizon):
                x[k] = x[k] + zn * c0
                zn *= z
        else:
            zn, iz = z, 1.0 / z
            z2n = z ** (n - 1)
            t = x[0] / (1.0 - z ** (2 * n - 2))
            x[0] = t
            x[n - 1] = x[n - 1] + z2n * t
            z2n = z2n * (z2n * iz)
            for k in range(1, n - 1):
                x[k] = x[k] + (zn + z2n) * t
                zn *= z
                z2n *= iz
    return x * tp._gain(poles)


@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_k4_model_is_filter_matrix_transpose(order):
    """Both causal-initialisation branches: lines shorter than, at and
    longer than each pole's horizon."""
    horizons = [tp._horizon(z) for z in tp.spline_poles(order)]
    lengths = sorted({1, 2, 3, 9, 64} | {h + d for h in horizons
                                         for d in (-1, 0, 1)})
    for n in lengths:
        eye = np.eye(n)
        k4 = np.stack([_k4_model(e, order) for e in eye], 1)
        np.testing.assert_allclose(k4, tp.filter_matrix(n, order).T,
                                   rtol=0, atol=1e-13)


# (outer, n, inner): the tile sweep's inner 33 and 100, a straddled row of
# outers, and lines at and past the float64 cap
TWIN_SHAPES = [(3, 40, 33), (2, 40, 100), (23, 30, 3), (2, 880, 1),
               (1, 881, 2)]


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * float(np.abs(want).max()))


@pytest.mark.parametrize("order", [2, 3, 5])
@pytest.mark.parametrize("shape", TWIN_SHAPES)
def test_k4_twin_is_the_jax_transpose(shape, order):
    x = np.random.RandomState(sum(shape) + order).standard_normal(shape)
    _close(tp.spline_filter1d_transpose_plain(torch.as_tensor(x), order, 1),
           jp.spline_filter1d_transpose(x, order, 1))


@pytest.mark.parametrize("bc", ["reflect", "wrap"])
@pytest.mark.parametrize("order", [2, 3, 5])
@pytest.mark.parametrize("shape", TWIN_SHAPES)
def test_k7_twin_is_the_jax_transpose(shape, order, bc):
    x = np.random.RandomState(sum(shape) + order).standard_normal(shape)
    want = np.moveaxis(np.tensordot(jp.filter_matrix_bc(shape[1], order,
                                                        bc).T, x,
                                    axes=([1], [1])), 0, 1)
    _close(tp.spline_filter1d_bc_transpose_plain(torch.as_tensor(x), order,
                                                 1, bc), want)


def test_cpu_tensors_count_no_route():
    x = torch.as_tensor(np.random.RandomState(3).standard_normal((4, 9, 3)))
    for fn, args in ((tp.spline_filter1d_transpose, ()),
                     (tp.spline_filter1d_bc_transpose, ("reflect",))):
        before, routes = fn.launches, dict(fn.routes)
        fn(x, 3, 1, *args)
        assert fn.launches == before and fn.routes == routes
        assert set(routes) == {"tile", "lines"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bc", ["mirror", "reflect", "wrap"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_both_routes_match_plain_and_each_other(cuda_device, dtype, bc):
    rs = np.random.RandomState(7)
    cap = tp.tile_cap(dtype)
    for (outer, n, inner), order in itertools.product(
            [(131, 64, 1), (23, 30, 3), (5, 40, 33), (2, 224, 100),
             (3, cap, 5), (2, cap + 1, 1)], (2, 3, 5)):
        x = torch.as_tensor(rs.rand(outer, n, inner) * 100, dtype=dtype,
                            device=cuda_device)
        plain = (tp.spline_filter1d_transpose_plain(x, order, 1)
                 if bc == "mirror" else
                 tp.spline_filter1d_bc_transpose_plain(x, order, 1, bc))
        lines = tp._launch_transpose(x, order, 1, bc, tp._tile_plan(
            outer, n, inner, dtype, route="lines"))
        scale = float(x.abs().max())
        tol = 1e-5 if dtype == torch.float32 else 1e-10
        torch.testing.assert_close(lines, plain, rtol=tol, atol=tol * scale)
        for width in tp.TILE_WIDTHS:
            try:
                plan = tp._tile_plan(outer, n, inner, dtype,
                                     width=width, route="tile")
            except ValueError:
                continue
            assert torch.equal(tp._launch_transpose(x, order, 1, bc, plan),
                               lines)
