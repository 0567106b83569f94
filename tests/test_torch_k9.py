"""K9, the N-D correlation, on its two routes.

The card runs K9 (``correlate_nd``) either on the tile route, a block
staging its output tile's halo box of the input in shared memory, each
element folded by the mode or ``cval`` in constant mode, and summing the
nonzero taps from there, or on the nd route, one thread per output reading
device memory at every tap; ``ops/filters.py``'s ``_nd_plan`` picks the
route from the shapes, as for K9T. On the CPU:

* a numpy model of the tile route (``csrc/filters.cu``
  ``correlate_nd_tile_kernel``), block by block: block -> batch index and
  tile, the box from the tile plus each axis' least tap offset, staged with
  the fold or ``cval``, each nonzero tap's box offset in raster order, and
  ``acc = v_0 w_0``, then ``acc + v_t w_t``, against
  ``correlate_nd_plain`` and the JAX package's ``correlate`` / ``convolve``
  bit for bit in float64 (the JAX package's unrolled branch, which sums
  the same terms in the same order; its matmul branch sums in another order
  and is held to 1e-12), over the five modes and the ``grid-*`` aliases,
  origins, 1-D to 3-D kernels, merged batch axes and a batch axis walked by
  the grid, every column C;
* the plan at c14's shapes and its refusals (the plan is K9T's);
* CPU tensors count no route.

The ``cuda`` test holds both routes against the twin bit for bit, and skips
without a card.
"""

import itertools

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej
from elasticdeform_tpu.ops import filters as jf

from elasticdeform_tpu_torch.ops import filters as tf

MODES = ("reflect", "constant", "nearest", "mirror", "wrap")
ALIASES = ("grid-mirror", "grid-wrap", "grid-constant")


def _fold(j, n, mode):
    """The kernel's ``fold``: the filter modes' index fold; -1 beyond the
    edge in constant mode."""
    if 0 <= j < n:
        return j
    if mode == "constant":
        return -1
    return tf._fold_index(j, n, mode)


def _tile_model(x, w, centers, mode, cval, plan):
    """numpy float64 model of K9's tile route on ``x``, block by block."""
    x = np.asarray(x, dtype=np.float64)
    merged, group, batch = tf.nd_geometry(x.shape, w.shape)
    strides = tf._contiguous_strides(merged)
    taps = tf._nd_taps(w)
    n3, st3, lo3 = [1] * 3, [0] * 3, [0] * 3
    off = np.zeros((len(taps), 3), dtype=np.int64)
    for a, d in enumerate(plan.tile_axes):
        if d < 0:
            continue
        n3[a], st3[a] = merged[d], strides[d]
        if not batch[d]:
            ax = group.index(d)
            off[:, a] = [int(t[ax]) - centers[ax] for t in taps]
            lo3[a] = -centers[ax]
    tile = (plan.column,) + tf.ND_TILE
    k3 = [w.shape[group.index(d)] if d >= 0 and not batch[d] else 1
          for d in plan.tile_axes]
    assert plan.box == tuple(t + k - 1 for t, k in zip(tile, k3))
    P0, P1 = plan.box[1] * plan.box[2], plan.box[2]
    toff = (off - lo3) @ np.array([P0, P1, 1])
    weights = np.array([float(w[t]) for t in taps])
    flat = x.reshape(-1)
    out = np.full(flat.shape, np.nan)
    ntiles = [-(-n // t) for n, t in zip(n3, tile)]
    bshape = [merged[d] for d in plan.grid_axes]
    blocks = 0
    for bi in itertools.product(*[range(n) for n in bshape]):
        base = sum(i * strides[d] for i, d in zip(bi, plan.grid_axes))
        for q in itertools.product(*[range(t) for t in ntiles]):
            blocks += 1
            s = [qq * t for qq, t in zip(q, tile)]
            f = [np.array([_fold(s[a] + lo3[a] + b, n3[a], mode)
                           for b in range(plan.box[a])]) for a in range(3)]
            inside = ((f[0] >= 0)[:, None, None] & (f[1] >= 0)[None, :, None]
                      & (f[2] >= 0)[None, None, :])
            addr = base + sum(np.maximum(f[a], 0).reshape(
                [-1 if b == a else 1 for b in range(3)]) * st3[a]
                for a in range(3))
            box = np.where(inside, flat[addr], cval).reshape(-1)
            at = (np.arange(tile[0])[:, None, None] * P0
                  + np.arange(tile[1])[None, :, None] * P1
                  + np.arange(tile[2])[None, None, :])
            acc = box[at + toff[0]] * weights[0]
            for t in range(1, len(taps)):
                acc = acc + box[at + toff[t]] * weights[t]
            j = [s[a] + np.arange(tile[a]) for a in range(3)]
            ok = ((j[0] < n3[0])[:, None, None] & (j[1] < n3[1])[None, :, None]
                  & (j[2] < n3[2])[None, None, :])
            oaddr = base + sum(j[a].reshape(
                [-1 if b == a else 1 for b in range(3)]) * st3[a]
                for a in range(3))
            out[oaddr[ok]] = acc[ok]
    assert blocks == plan.blocks
    return out.reshape(x.shape)


# (shape, kernel shape, dtype of the plan): 1-D to 3-D kernels, batch axes
# merged into the tile or walked by the grid, partial tiles, kernels longer
# than an axis, c14's two calls cut to size
CASES = [((7,), (3,)), ((5,), (9,)), ((13, 17), (3, 4)), ((5, 6), (7, 3)),
         ((9, 10, 11), (3, 2, 5)), ((2, 9, 10, 11), (1, 3, 3, 3)),
         ((6, 3, 7, 5), (4, 1, 1, 3)), ((3, 4, 9), (5, 6, 3)),
         ((2, 3, 9, 4), (1, 2, 3, 1)), ((3, 20, 2), (3, 7, 1)),
         ((10, 12, 40), (5, 5, 5)), ((2, 10, 12, 40), (1, 3, 3, 3))]


def _case(case, origin, seed=0):
    shape, kshape = CASES[case]
    rs = np.random.RandomState(100 * case + seed)
    w = np.round(rs.standard_normal(kshape), 2) * (rs.rand(*kshape) > 0.3)
    w.reshape(-1)[-1] = 1.25
    w.reshape(-1)[0] = 0.0            # a zero first tap: not a tap
    centers = tuple({"low": 0, "high": k - 1, "mid": k // 2}[origin]
                    for k in kshape)
    return rs.standard_normal(shape) * 10, w, centers


@pytest.fixture
def unrolled(monkeypatch):
    """The JAX package's unrolled tap sum (its matmul branch off)."""
    monkeypatch.setattr(jf, "_CORRELATE_MATMUL_BYTES", -1)


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("mode", MODES + ALIASES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_tile_model_is_the_twin_and_the_jax_package(case, mode, unrolled):
    origin = ("low", "mid", "high")[(case + len(mode)) % 3]
    x, w, centers = _case(case, origin)
    md = tf.check_mode(mode)
    plan = tf._nd_plan(x.shape, w.shape, torch.float64)
    assert plan.route == "tile"
    got = _tile_model(x, w, centers, md, 1.75, plan)
    _equal(got, tf.correlate_nd_plain(torch.as_tensor(x), w, centers, md,
                                      1.75).numpy())
    origins = [c - k // 2 for c, k in zip(centers, w.shape)]
    _equal(got, ej.correlate(x, w, mode=mode, cval=1.75, origin=origins))
    # convolve: the flipped kernel, mirrored origins
    flip = w[(slice(None, None, -1),) * w.ndim]
    corigins = [-o if k & 1 else -o - 1 for o, k in zip(origins, w.shape)]
    _equal(got, ej.convolve(x, flip, mode=mode, cval=1.75, origin=corigins))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", [4, 5, 10])
def test_tile_model_is_the_jax_matmul_branch_to_1e12(case, mode):
    x, w, centers = _case(case, "mid", 1)
    plan = tf._nd_plan(x.shape, w.shape, torch.float64)
    got = _tile_model(x, w, centers, mode, -2.5, plan)
    origins = [c - k // 2 for c, k in zip(centers, w.shape)]
    want = ej.correlate(x, w, mode=mode, cval=-2.5, origin=origins)
    scale = float(np.abs(x).max() * np.abs(w).sum())
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("column", tf.TILE_COLUMNS)
@pytest.mark.parametrize("mode", ["constant", "mirror", "wrap"])
def test_every_column_is_the_twin(column, mode):
    shape, kshape = (11, 6, 37), (3, 2, 4)
    rs = np.random.RandomState(column)
    x, w = rs.standard_normal(shape), rs.standard_normal(kshape)
    centers = (2, 0, 1)
    plan = tf._nd_plan(shape, kshape, torch.float64, column=column,
                       route="tile")
    assert plan.column == column
    _equal(_tile_model(x, w, centers, mode, 0.5, plan),
           tf.correlate_nd_plain(torch.as_tensor(x), w, centers, mode,
                                 0.5).numpy())


def test_plan_at_c14():
    for dtype in (torch.float32, torch.float64):
        item = 4 if dtype == torch.float32 else 8
        c = tf.ND_COLUMN
        plan = tf._nd_plan((160, 192, 224), (5, 5, 5), dtype)
        assert plan == tf.NdPlan(
            "tile", (0, 1, 2), (), c, (c + 4, 12, 36),
            (c + 4) * 12 * 36 * item + 125 * (item + 4),
            -(-160 // c) * 24 * 7)
        # convolve's 3^3 kernel on axes (1, 2, 3) of the batch of two
        conv = tf._nd_plan((2, 160, 192, 224), (1, 3, 3, 3), dtype)
        assert conv.route == "tile" and conv.tile_axes == (1, 2, 3)
        assert conv.grid_axes == (0,) and conv.box == (c + 2, 10, 34)
        assert conv.blocks == 2 * -(-160 // c) * 24 * 7


def test_plan_refusals():
    f32, f64 = torch.float32, torch.float64
    nd = tf.NdPlan("nd")
    assert tf._nd_plan((3, 4, 5, 6), (2, 3, 2, 3), f32) == nd
    assert tf._nd_plan((3, 4, 5), (1, 1, 1), f32) == nd
    assert tf._nd_plan((9, 9), (3, 3), f32, finite=False) == nd
    assert tf._nd_plan((300, 300), (120, 120), f32).route == "tile"
    assert tf._nd_plan((300, 300), (120, 120), f64) == nd
    assert tf._nd_plan((2 ** 16, 2 ** 16), (3, 3), f32) == nd
    assert tf._nd_plan((2 ** 31, 4, 4, 4), (1, 3, 3, 3), f32) == nd
    with pytest.raises(ValueError):
        tf._nd_plan((3, 4, 5, 6), (2, 3, 2, 3), f32, route="tile")


def test_cpu_tensors_count_no_route():
    x = torch.as_tensor(np.random.RandomState(3).standard_normal((6, 7)))
    fn = tf.correlate_nd
    before, routes = fn.launches, dict(fn.routes)
    fn(x, np.ones((3, 3)), (1, 1), "reflect", 0.0)
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
        x, w, centers = _case(case, origin)
        xt = torch.as_tensor(x, dtype=dtype, device=cuda_device)
        want = tf.correlate_nd_plain(xt, w, centers, mode, 0.5)
        for route in ("tile", "nd"):
            plan = tf._nd_plan(x.shape, w.shape, dtype, route=route)
            got = tf._launch_correlate_nd(xt, w, centers, mode, 0.5, plan)
            assert torch.equal(got, want), (case, route)
