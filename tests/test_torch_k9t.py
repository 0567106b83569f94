"""K9T, the transposed N-D correlation, on its two routes.

The card runs K9T (``correlate_nd_transpose``) either on the tile route, a
block staging its tile's halo box of the cotangent in shared memory, or on
the nd route, one thread per output in device memory;
``ops/filters.py``'s ``_nd_plan`` picks the route from the
shapes. On the CPU:

* a numpy model of the tile route's index arithmetic (``csrc/filters.cu``
  ``correlate_nd_transpose_tile_kernel``): block -> batch index and tile,
  box origin, the zero-filled box, each tap's box offset, ``P(j)`` from
  the box in raster order, then the remaining entries of the fold lists'
  product from the array, against ``correlate_nd_transpose_plain`` and
  against ``jax.vjp`` of the JAX package's ``apply_correlate``, float64,
  1e-12, over the five modes, ranks 1-4 with merged batch axes, shapes that
  are not multiples of the tile, kernels longer than an axis, zero-weight
  taps and extreme origins;
* the plan's route choice and its refusals.

The ``cuda`` test holds both routes against the twin, and skips without a
card.
"""

import itertools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from elasticdeform_tpu.ops import filters as jf

from elasticdeform_tpu_torch.ops import filters as tf

MODES = ("reflect", "constant", "nearest", "mirror", "wrap")


def _tile_geometry(shape, w, centers, plan):
    """Per tile axis: extent, kernel extent, greatest tap offset, each
    tap's offset, and the original axis (None: a batch axis or an extent
    of 1), as ``_nd_tile_tables`` hands them to the kernel."""
    merged, group, batch = tf.nd_geometry(shape, w.shape)
    taps = tf._nd_taps(w)
    n3, k3, hi3, ax3 = [1] * 3, [1] * 3, [0] * 3, [None] * 3
    off = np.zeros((len(taps), 3), dtype=np.int64)
    for a, d in enumerate(plan.tile_axes):
        if d < 0:
            continue
        n3[a] = merged[d]
        if batch[d]:
            continue
        ax = group.index(d)
        k, c = w.shape[ax], centers[ax]
        k3[a], hi3[a], ax3[a] = k, k - 1 - c, ax
        off[:, a] = [t[ax] - c for t in taps]
    return merged, n3, k3, hi3, ax3, off, taps


def _tile_model(g, w, centers, mode, plan):
    """numpy float64 model of K9T's tile route, block by block."""
    g = np.asarray(g, dtype=np.float64)
    merged, n3, k3, hi3, ax3, off, taps = _tile_geometry(g.shape, w, centers,
                                                         plan)
    tile = (plan.column,) + tf.ND_TILE
    assert plan.box == tuple(t + k - 1 for t, k in zip(tile, k3))
    ntiles = [-(-n // t) for n, t in zip(n3, tile)]
    real = [d for d in plan.tile_axes if d >= 0]
    # the batch axes the grid walks first, then the tile axes (with their
    # extents of 1), the last grid axis fastest
    perm = list(plan.grid_axes) + real
    gt = np.transpose(g.reshape(merged), perm)
    grid_shape = gt.shape[:len(plan.grid_axes)]
    gt = gt.reshape(grid_shape + tuple(n3))
    out = np.full(gt.shape, np.nan)
    folds = [None if ax is None or mode == "constant" else
             tf.fold_lists(n, centers[ax], k - 1 - centers[ax], mode)
             for n, k, ax in zip(n3, k3, ax3)]
    weights = [float(w[t]) for t in taps]
    blocks = 0
    for bi in itertools.product(*[range(n) for n in grid_shape]):
        gs = gt[bi]
        for q in itertools.product(*[range(t) for t in ntiles]):
            blocks += 1
            start = [qq * t for qq, t in zip(q, tile)]
            origin = [s - h for s, h in zip(start, hi3)]
            box = np.zeros(plan.box)
            lo = [max(o, 0) for o in origin]
            hi = [min(o + b, n) for o, b, n in zip(origin, plan.box, n3)]
            if all(a < b for a, b in zip(lo, hi)):
                box[tuple(slice(a - o, b - o) for a, b, o in
                          zip(lo, hi, origin))] = gs[tuple(
                              slice(a, b) for a, b in zip(lo, hi))]
            # the taps' box offsets (hi - off per axis), raster order
            acc = None
            for (t0, t1, t2), wt in zip(hi3 - off, weights):
                v = box[t0:t0 + tile[0], t1:t1 + tile[1], t2:t2 + tile[2]]
                acc = v * wt if acc is None else acc + v * wt
            for c, y, x in itertools.product(*[range(t) for t in tile]):
                j = (start[0] + c, start[1] + y, start[2] + x)
                if any(jj >= n for jj, n in zip(j, n3)):
                    continue
                out[bi + j] = _fold_rest(acc[c, y, x], j, gs, n3, off,
                                         weights, folds)
    assert blocks == plan.blocks
    out = out.reshape(grid_shape + tuple(n for d, n in zip(plan.tile_axes,
                                                           n3) if d >= 0))
    return np.transpose(out, np.argsort(perm)).reshape(g.shape)


def _fold_rest(acc, j, gs, n3, off, weights, folds):
    """``fold_rest``: the other entries of the product of j's fold lists,
    the last axis fastest, each P(q) over the taps landing inside."""
    lists = []
    for jj, f in zip(j, folds):
        if f is None:
            lists.append([jj])
        else:
            ptr, pos = f
            lists.append([int(p) for p in pos[ptr[jj]:ptr[jj + 1]]])
    for qs in list(itertools.product(*lists))[1:]:
        part = 0.0
        for o, wt in zip(off, weights):
            i = [qq - oo for qq, oo in zip(qs, o)]
            if all(0 <= ii < n for ii, n in zip(i, n3)):
                part = part + gs[tuple(i)] * wt
        acc = acc + part
    return acc


# (shape, kernel shape): ranks 1-4, batch axes merged and walked, tiles
# left partial, kernels longer than an axis
CASES = [((7,), (3,)), ((5,), (9,)), ((13, 17), (3, 4)), ((5, 6), (7, 3)),
         ((9, 10, 11), (3, 2, 5)), ((2, 9, 10, 11), (1, 3, 3, 3)),
         ((6, 3, 7, 5), (4, 1, 1, 3)), ((3, 4, 9), (5, 6, 3)),
         ((2, 3, 9, 4), (1, 2, 3, 1)), ((3, 20, 2), (3, 7, 1))]


def _case(shape, kshape, seed, origin):
    rs = np.random.RandomState(seed)
    w = rs.standard_normal(kshape) * (rs.rand(*kshape) > 0.3)
    w.reshape(-1)[-1] = 1.0
    w.reshape(-1)[0] = 0.0            # a zero-weight first tap
    centers = tuple({"low": 0, "high": k - 1, "mid": k // 2}[origin]
                    for k in kshape)
    return rs.standard_normal(shape), w, centers


@pytest.mark.parametrize("origin", ["low", "mid", "high"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_tile_model_is_the_twin_and_the_jax_vjp(case, mode, origin):
    shape, kshape = CASES[case]
    g, w, centers = _case(shape, kshape, case, origin)
    plan = tf._nd_plan(shape, kshape, torch.float64)
    assert plan.route == "tile"
    got = _tile_model(g, w, centers, mode, plan)
    twin = tf.correlate_nd_transpose_plain(torch.as_tensor(g), w, centers,
                                           mode).numpy()
    scale = float(tf.correlate_nd_transpose_plain(
        torch.as_tensor(np.abs(g)), np.abs(w), centers, mode).max())
    np.testing.assert_allclose(got, twin, rtol=1e-12, atol=1e-12 * scale)
    origins = [c - k // 2 for c, k in zip(centers, kshape)]
    _, vjp = jax.vjp(lambda a: jf.apply_correlate(a, w, mode, 0.0, origins),
                     jnp.asarray(np.zeros(shape)))
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("column", tf.TILE_COLUMNS)
@pytest.mark.parametrize("mode", ["constant", "mirror"])
def test_every_column_is_the_twin(column, mode):
    shape, kshape = (11, 6, 37), (3, 2, 4)
    g, w, centers = _case(shape, kshape, column, "mid")
    plan = tf._nd_plan(shape, kshape, torch.float64,
                                 column=column, route="tile")
    assert plan.column == column
    twin = tf.correlate_nd_transpose_plain(torch.as_tensor(g), w, centers,
                                           mode).numpy()
    np.testing.assert_allclose(_tile_model(g, w, centers, mode, plan), twin,
                               rtol=1e-12, atol=1e-12)


def test_plan_at_c14():
    for dtype in (torch.float32, torch.float64):
        plan = tf._nd_plan((160, 192, 224), (5, 5, 5), dtype)
        c = tf.ND_COLUMN
        item = 4 if dtype == torch.float32 else 8
        assert plan == tf.NdPlan(
            "tile", (0, 1, 2), (), c, (c + 4, 12, 36),
            (c + 4) * 12 * 36 * item + 125 * (item + 4),
            -(-160 // c) * 24 * 7)
        conv = tf._nd_plan((2, 160, 192, 224), (1, 3, 3, 3), dtype)
        assert conv.route == "tile" and conv.tile_axes == (1, 2, 3)
        assert conv.grid_axes == (0,)
        assert conv.blocks == 2 * -(-160 // c) * 24 * 7


def test_plan_fills_short_ranks_with_batch_axes():
    # one kernel axis: the two innermost batch axes join the tile
    plan = tf._nd_plan((4, 5, 6, 7), (1, 3, 1, 1), torch.float32)
    merged, _, batch = tf.nd_geometry((4, 5, 6, 7), (1, 3, 1, 1))
    assert merged == [4, 5, 42] and batch == [True, False, True]
    assert plan.tile_axes == (0, 1, 2) and plan.grid_axes == ()
    assert plan.box == (plan.column, 10, 32)
    # two kernel axes, no batch: a leading extent of 1 and C = 1
    plan = tf._nd_plan((40, 50), (3, 3), torch.float32)
    assert plan.tile_axes == (-1, 0, 1) and plan.column == 1
    # a short tile axis 0 takes the next power of two
    plan = tf._nd_plan((3, 40, 50), (3, 3, 3), torch.float32)
    assert plan.column == min(4, tf.ND_COLUMN)


def test_plan_routes_the_rest_to_nd():
    f32, f64 = torch.float32, torch.float64
    nd = tf.NdPlan("nd")
    # four kernel axes, or none
    assert tf._nd_plan((3, 4, 5, 6), (2, 3, 2, 3), f32) == nd
    assert tf._nd_plan((3, 4, 5), (1, 1, 1), f32) == nd
    # non-finite weights
    assert tf._nd_plan((9, 9), (3, 3), f32, finite=False) == nd
    # a box that fits in float32 but not in float64
    assert tf._nd_plan((300, 300), (120, 120), f32).route == "tile"
    assert tf._nd_plan((300, 300), (120, 120), f64) == nd
    # a huge kernel
    assert tf._nd_plan((99, 99, 99), (64, 64, 64), f32) == nd
    # a sample of 2^31 elements, a grid of 2^31 blocks
    assert tf._nd_plan((2 ** 16, 2 ** 16), (3, 3), f32) == nd
    assert tf._nd_plan((2 ** 31, 4, 4, 4), (1, 3, 3, 3),
                                 f32) == nd
    assert tf._nd_plan((2 ** 31 - 1, 4, 4, 4), (1, 3, 3, 3),
                                 f32).route == "tile"
    assert tf._nd_plan((9, 9), (3, 3), f32, route="nd") == nd
    with pytest.raises(ValueError):
        tf._nd_plan((99, 99, 99), (64, 64, 64), f32, route="tile")
    with pytest.raises(ValueError):
        tf._nd_plan((2 ** 16, 2 ** 16), (3, 3), f32, route="tile")
    with pytest.raises(ValueError):
        tf._nd_plan((9, 9), (3, 3), f32, column=3)
    with pytest.raises(ValueError):
        tf._nd_plan((9, 9), (3, 3), f32, route="rows")


def test_cpu_tensors_count_no_route():
    g = torch.as_tensor(np.random.RandomState(3).standard_normal((6, 7)))
    fn = tf.correlate_nd_transpose
    before, routes = fn.launches, dict(fn.routes)
    fn(g, np.ones((3, 3)), (1, 1), "reflect")
    assert fn.launches == before and fn.routes == routes
    assert set(routes) == {"tile", "nd"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_both_routes_match_plain(cuda_device, dtype, mode):
    for case, origin in itertools.product(range(len(CASES)), ("low", "high")):
        shape, kshape = CASES[case]
        g, w, centers = _case(shape, kshape, case, origin)
        gt = torch.as_tensor(g, dtype=dtype, device=cuda_device)
        want = tf.correlate_nd_transpose_plain(gt, w, centers, mode)
        terms = tf.correlate_nd_transpose_plain(gt.abs(), np.abs(w), centers,
                                                mode)
        rtol = 1e-5 if dtype == torch.float32 else 1e-10
        for plan in (tf._nd_plan(shape, kshape, dtype),
                     tf._nd_plan(shape, kshape, dtype,
                                           route="nd")):
            got = tf._launch_nd_transpose(gt, w, centers, mode, plan)
            err = (got.double() - want.double()).abs()
            assert bool((err <= rtol * terms.double()).all()), plan
