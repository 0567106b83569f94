"""K3 and K3c, the backward scatter of the resampler, on the CPU.

The card runs K3 (``resample_transpose``) and K3c
(``resample_coords_transpose``) on the plan of ``ops/resample_bwd.py``'s
``_bwd_plan``: a block owns a tile of the output, sums its voxels' taps
into a box of the coefficients in shared memory at their unfolded
positions and flushes the box through the integer mirror fold with one
atomic per element; a block whose box exceeds the budget, or whose
coordinates are not finite, adds each tap at its folded offset (the direct
branch). Here:

* a numpy model of that arithmetic (``csrc/resample_bwd.cu``
  ``resample_bwd_kernel``), block by block: block to tile, the first
  taps' least and greatest per axis over the voxels inside, the box's
  origin and size, the unfolded accumulation and the flush's mirror fold,
  the direct branch for boxes over the cap and non-finite coordinates;
  held against ``resample_transpose_plain`` /
  ``resample_coords_transpose_plain`` and against ``jax.vjp`` of the JAX
  package's ``map_coordinates`` with ``strategy="windows"`` (which reaches
  ``resample_windows_transpose`` and ``_scatter_fold``,
  ``elasticdeform_tpu/ops/windows.py:1354``, ``:1174``), float64, 1e-12 of
  the sum of the absolute terms: the five modes, ranks 1-4, orders 0-5, one
  and three channels, affines with crop offsets, shapes that are not
  multiples of the tile, axes shorter than the tap window, coordinates 25
  voxels outside and a NaN coordinate;
* a numpy model of the direct route's kernel (``resample_direct_kernel``):
  one thread a voxel in raster order, each adding its own taps (nothing
  in constant mode outside, except from order 1 a NaN coordinate's NaN
  weights, its first tap 0); held against the twins in float64 at 1e-12
  of the sum of the absolute terms over orders 0 and 1, ranks 1-3, the
  five modes (constant with voxels outside), one and three channels, NaN
  coordinates and taps folded at both edges, with one atomic per tap and
  channel of the voxels that add;
* the plan's tiles, routes, direct grid and refusals.

The ``cuda`` test holds both routes against the twin, and skips without
a card.
"""

import itertools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import elasticdeform_tpu as ej

from elasticdeform_tpu_torch.ops import bspline, modes as tm
from elasticdeform_tpu_torch.ops import resample_bwd as rb
from elasticdeform_tpu_torch.ops.resample import sample_coordinates

MODES = ("nearest", "wrap", "reflect", "mirror", "constant")


def _fold(i, n):
    """The kernel's ``mirror_fold`` (C's truncating ``%``) of tap index
    ``i`` into ``[0, n)``."""
    i = np.asarray(i, dtype=np.int64)
    if n <= 1:
        return np.zeros_like(i)
    s2 = 2 * n - 2
    m = np.fmod(i, s2)
    m = np.where(m < 0, m + s2, m)
    return np.where(m >= n, s2 - m, m)


def _geometry(cc, in_shape, order, mode):
    """Per axis the folded coordinate, the first tap (0 where it is not
    finite: the card's float-to-int conversion of NaN) and the tap
    weights, and the voxels inside (constant mode), all numpy of ``cc``'s
    ``(B, *out)``."""
    ms, starts, weights, ok = [], [], [], None
    for h, n in enumerate(in_shape):
        m, inside = tm.map_coordinate(torch.as_tensor(cc[:, h]), n, mode)
        ok = inside if ok is None else ok & inside
        s = bspline.filter_start(m, order).numpy()
        ms.append(m.numpy())
        starts.append(np.where(np.isfinite(s), s, 0).astype(np.int64))
        weights.append([w.numpy() for w in bspline.spline_weights(m, order)])
    return ms, starts, weights, ok.numpy()


def _k3_model(g, cc, in_shape, order, mode, plan):
    """numpy float64 model of K3/K3c on ``plan``, block by block, for
    ``g`` ``(B, *out, C)`` at sample coordinates ``cc`` ``(B, naxis,
    *out)``. Returns the result ``(B, *in_shape, C)`` and the blocks that
    took each branch."""
    g = np.asarray(g, dtype=np.float64)
    B, C, naxis = g.shape[0], g.shape[-1], len(in_shape)
    nt = order + 1
    view, tile = plan.view, plan.tile
    ms, starts, weights, ok = _geometry(cc, in_shape, order, mode)

    def by_view(a):
        return a.reshape(B, *view)
    ms = [by_view(m) for m in ms]
    starts = [by_view(s) for s in starts]
    weights = [[by_view(w) for w in ws] for ws in weights]
    ok = by_view(ok)
    gv = g.reshape(B, *view, C)
    out = np.zeros((B, *in_shape, C))
    stats = {"tile": 0, "direct": 0}
    grid = [-(-n // t) for n, t in zip(view[1:], tile)]
    taps = list(itertools.product(range(nt), repeat=naxis))
    for b, o, q in itertools.product(range(B), range(view[0]),
                                     itertools.product(*map(range, grid))):
        sl = (b, o) + tuple(slice(k * t, (k + 1) * t)
                            for k, t in zip(q, tile))
        inb = ok[sl].reshape(-1)
        if not inb.any():
            continue

        def pick(a, inb=inb, sl=sl):
            return a[sl].reshape(-1)[inb]
        st = [pick(s) for s in starts]
        wt = [[pick(w) for w in ws] for ws in weights]
        gg = gv[sl].reshape(-1, C)[inb]
        bad = any((~(np.abs(pick(m)) < 2 ** 29)).any() for m in ms)
        lo = [int(s.min()) for s in st]
        ext = [int(s.max()) - lo_h + nt for s, lo_h in zip(st, lo)]
        if not bad and all(e <= plan.cap for e in ext) and \
                C * int(np.prod(ext)) <= plan.cap:
            stats["tile"] += 1
            box = np.zeros((*ext, C))
            for t in taps:
                wprod = wt[0][t[0]]
                for h in range(1, naxis):
                    wprod = wprod * wt[h][t[h]]
                np.add.at(box, tuple(st[h] - lo[h] + t[h]
                                     for h in range(naxis)),
                          gg * wprod[:, None])
            nz = box != 0
            pos = np.nonzero(nz)
            np.add.at(out[b], tuple(_fold(lo[h] + pos[h], in_shape[h])
                                    for h in range(naxis)) + (pos[-1],),
                      box[nz])
        else:
            stats["direct"] += 1
            for t in taps:
                wprod = wt[0][t[0]]
                for h in range(1, naxis):
                    wprod = wprod * wt[h][t[h]]
                np.add.at(out[b], tuple(_fold(st[h] + t[h], in_shape[h])
                                        for h in range(naxis)),
                          gg * wprod[:, None])
    return out, stats


def _tile_plan(in_shape, out_shape, C, order):
    """The tile route's plan in float64 (forced, so orders 0 and 1 take it
    too), or the direct route's where one voxel's box exceeds the cap."""
    try:
        return rb._bwd_plan(in_shape, out_shape, C, order, torch.float64,
                            route="tile")
    except ValueError:
        return rb._bwd_plan(in_shape, out_shape, C, order, torch.float64)


def _close(got, want, terms, what=""):
    bound = 1e-12 * np.abs(terms) + 1e-300
    err = np.abs(got - want)
    assert (err <= bound).all(), (what, float(err.max()))


def _draws(rs, naxis, in_shape, out_shape, C, outside=25.0):
    """Coordinates up to ``outside`` voxels past every edge (some exactly
    on the clip bounds) and a cotangent, B = 2."""
    cc = np.stack([rs.uniform(-outside, n - 1 + outside, (2, *out_shape))
                   for n in in_shape], 1)
    cc.reshape(-1)[:3] = (0.0, in_shape[0] - 1.0, -0.5)
    return cc, rs.standard_normal((2, *out_shape, C))


# (in_shape, out_shape): ranks 1-4, outputs that are not multiples of the
# tile, axes shorter than the tap window
SHAPES = [((37,), (600,)), ((2,), (50,)), ((23, 31), (20, 40)),
          ((3, 5), (17, 9)), ((11, 13, 9), (10, 12, 9)),
          ((2, 3, 5), (9, 17, 4)), ((7, 6, 5, 8), (6, 5, 4, 7)),
          ((3, 2, 4, 5), (4, 5, 3, 3))]


@pytest.mark.parametrize("mode", range(5))
@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_model_is_the_twin(case, mode):
    """K3c's model at coordinates up to 25 voxels outside, every order,
    one and three channels, against the twin; both branches taken."""
    in_shape, out_shape = SHAPES[case]
    naxis = len(in_shape)
    stats = {"tile": 0, "direct": 0}
    for order, C in itertools.product(range(6), (1, 3)):
        if naxis == 4 and order > 3 and C == 3:
            continue
        rs = np.random.RandomState(100 * case + 10 * mode + order + C)
        cc, g = _draws(rs, naxis, in_shape, out_shape, C,
                       outside=25.0 if order % 2 else 2.0)
        plan = _tile_plan(in_shape, out_shape, C, order)
        got, st = _k3_model(g, cc, in_shape, order, mode, plan)
        for k in stats:
            stats[k] += st[k]
        ct, gt = torch.as_tensor(cc), torch.as_tensor(g)
        want = rb.resample_coords_transpose_plain(gt, ct, order, mode,
                                                  in_shape).numpy()
        terms = rb.resample_coords_transpose_plain(gt.abs(), ct, order, mode,
                                                   in_shape).numpy()
        _close(got, want, terms, (order, C))
        direct = plan._replace(route="direct", cap=0, smem=0)
        got, st = _k3_model(g, cc, in_shape, order, mode, direct)
        assert st["tile"] == 0
        _close(got, want, terms, (order, C, "direct"))
    # a 4-D box of taps folded over (7, 6, 5, 8) exceeds 2048 elements
    assert stats["tile"] > 0 or in_shape == (7, 6, 5, 8)


@pytest.mark.parametrize("kind", ["shared", "per-sample"])
@pytest.mark.parametrize("naxis", [1, 2, 3, 4])
def test_model_with_affine_and_crop_is_the_twin(naxis, kind):
    """K3's model at ``affine(j) + offset + displ``, the coordinates its
    kernel computes from the output index the tile gives, against
    ``resample_transpose_plain``."""
    in_shape, out_shape = [s for s in SHAPES if len(s[0]) == naxis][0]
    rs = np.random.RandomState(naxis)
    B = 2
    A = np.zeros((B, naxis, naxis + 1))
    A[:, :, :naxis] = np.eye(naxis) + rs.standard_normal((B, naxis, naxis)) \
        * 0.2
    A[:, :, naxis] = rs.standard_normal((B, naxis)) * 3
    affine = torch.as_tensor(A if kind == "per-sample" else A[0])
    displ = torch.as_tensor(rs.standard_normal((B, naxis, *out_shape)) * 3)
    offsets = tuple(int(o) for o in rs.randint(0, 4, naxis))
    for order, mode in zip(range(6), itertools.cycle(range(5))):
        C = 1 + 2 * (order % 2)
        g = rs.standard_normal((B, *out_shape, C))
        cc = torch.stack(sample_coordinates(displ, affine, offsets),
                         1).numpy()
        plan = _tile_plan(in_shape, out_shape, C, order)
        got, _ = _k3_model(g, cc, in_shape, order, mode, plan)
        gt = torch.as_tensor(g)
        want = rb.resample_transpose_plain(gt, displ, affine, offsets, order,
                                           mode, in_shape).numpy()
        terms = rb.resample_transpose_plain(gt.abs(), displ, affine, offsets,
                                            order, mode, in_shape).numpy()
        _close(got, want, terms, (order, mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("naxis", [1, 2, 3, 4])
def test_model_is_the_jax_vjp(naxis, mode):
    """The model against ``jax.vjp`` of the JAX package's
    ``map_coordinates`` (no prefilter, ``strategy="windows"``) with
    respect to X, per sample."""
    in_shape, out_shape = [s for s in SHAPES if len(s[0]) == naxis][-1]
    code = MODES.index(mode)
    order = (naxis + code) % 6
    rs = np.random.RandomState(10 * naxis + code)
    C = 3 if naxis < 4 else 1
    cc, g = _draws(rs, naxis, in_shape, out_shape, C)
    plan = _tile_plan(in_shape, out_shape, C, order)
    got, _ = _k3_model(g, cc, in_shape, order, code, plan)
    terms = rb.resample_coords_transpose_plain(
        torch.as_tensor(np.abs(g)), torch.as_tensor(cc), order, code,
        in_shape).numpy()
    for b in range(2):
        def fwd(x, b=b):
            return ej.map_coordinates(
                x, jnp.asarray(cc[b]), order=order, mode=mode,
                prefilter=False, strategy="windows",
                axis=tuple(range(naxis)) if C > 1 else None)
        x0 = jnp.zeros((*in_shape, C) if C > 1 else in_shape)
        _, vjp = jax.vjp(fwd, x0)
        gb = g[b] if C > 1 else g[b, ..., 0]
        want = np.asarray(vjp(jnp.asarray(gb))[0]).reshape(*in_shape, C)
        _close(got[b], want, terms[b], b)


@pytest.mark.parametrize("mode", range(5))
def test_boxes_over_the_cap_take_the_direct_branch(mode):
    """On the tile route, the blocks whose box exceeds the cap (taps
    folded from 25 voxels outside over a 40^3 volume) take the direct
    branch and the others the box, in one launch; the sum is the twin's."""
    in_shape, out_shape = (40, 40, 40), (16, 16, 20)
    rs = np.random.RandomState(mode)
    cc, g = _draws(rs, 3, in_shape, out_shape, 1)
    # the first 8 rows near the identity: tiles whose boxes fit
    for h in range(3):
        cc[:, h, :8] = 3.0 + rs.uniform(0, 0.5, (2, 8, 16, 20)) + \
            np.arange(out_shape[h]).reshape([-1 if k == h else 1
                                             for k in range(3)])[:8]
    plan = rb._bwd_plan(in_shape, out_shape, 1, 3, torch.float64)
    got, stats = _k3_model(g, cc, in_shape, 3, mode, plan)
    assert stats["tile"] > 0 and stats["direct"] > 0
    ct, gt = torch.as_tensor(cc), torch.as_tensor(g)
    _close(got, rb.resample_coords_transpose_plain(gt, ct, 3, mode,
                                                   in_shape).numpy(),
           rb.resample_coords_transpose_plain(gt.abs(), ct, 3, mode,
                                              in_shape).numpy())


def test_flat_points_k3c():
    """K3c at a flat list of points: the output tiled in runs of 512."""
    in_shape = (5, 6, 4)
    plan = rb._bwd_plan(in_shape, (1100,), 2, 3, torch.float64)
    assert plan.view == (1, 1, 1, 1100) and plan.tile == (1, 1, 256)
    assert plan.blocks == 5
    rs = np.random.RandomState(5)
    cc, g = _draws(rs, 3, in_shape, (1100,), 2, outside=1.0)
    got, stats = _k3_model(g, cc, in_shape, 3, 3, plan)
    ct, gt = torch.as_tensor(cc), torch.as_tensor(g)
    _close(got, rb.resample_coords_transpose_plain(gt, ct, 3, 3,
                                                   in_shape).numpy(),
           rb.resample_coords_transpose_plain(gt.abs(), ct, 3, 3,
                                              in_shape).numpy())
    assert stats == {"tile": 10, "direct": 0}


@pytest.mark.parametrize("mode", range(5))
def test_nan_coordinate_takes_the_direct_branch(mode):
    """A NaN coordinate must not size a box: its block takes the direct
    branch; every other block, and every element the NaN voxel's taps do
    not reach, equals the twin."""
    in_shape, out_shape = (6, 5, 4), (9, 8, 20)
    rs = np.random.RandomState(mode)
    cc, g = _draws(rs, 3, in_shape, out_shape, 1, outside=1.0)
    cc[0, 1, 4, 3, 5] = np.nan
    plan = rb._bwd_plan(in_shape, out_shape, 1, 3, torch.float64)
    got, stats = _k3_model(g, cc, in_shape, 3, mode, plan)
    clean = cc.copy()
    clean[0, 1, 4, 3, 5] = 5.0
    _, clean_stats = _k3_model(g, clean, in_shape, 3, mode, plan)
    assert stats["direct"] == clean_stats["direct"] + 1
    ct, gt = torch.as_tensor(cc), torch.as_tensor(g)
    want = rb.resample_coords_transpose_plain(gt, ct, 3, mode,
                                              in_shape).numpy()
    terms = rb.resample_coords_transpose_plain(gt.abs(), ct, 3, mode,
                                               in_shape).numpy()
    fin = np.isfinite(got) & np.isfinite(want)
    # the NaN lands on the taps of one voxel, here or in the twin's pad
    assert (~fin).sum() <= 2 * 4 ** 3
    assert np.isnan(got).any()
    _close(got[fin], want[fin], terms[fin])


def test_plan_at_c5_c7_and_c8():
    f32 = torch.float32
    c5 = rb._bwd_plan((64, 64, 64), (64, 64, 64), 1, 3, f32)
    assert c5 == rb.BwdPlan("tile", (1, 64, 64, 64), (8, 8, 8), 4096,
                            16384, 512, False)
    # order 1 takes the direct route unless the tile is forced: one thread
    # a voxel, 256 a block
    c7 = rb._bwd_plan((160, 192, 224), (160, 192, 224), 1, 1, f32)
    n7 = 160 * 192 * 224
    assert c7 == rb.BwdPlan("direct", (1, 160, 192, 224), (8, 8, 8), 0, 0,
                            n7 // 256, False)
    assert rb._bwd_plan((160, 192, 224), (160, 192, 224), 1, 1, f32,
                        route="tile").cap == 4096
    assert rb._bwd_plan((9,) * 3, (9,) * 3, 1, 0, f32).route == "direct"
    assert rb._bwd_plan((9,) * 3, (9,) * 3, 1, 2, f32).route == "tile"
    c8 = rb._bwd_plan((172, 204, 236), (160, 192, 224), 1, 3, f32)
    assert c8.route == "tile" and c8.view == (1, 160, 192, 224)
    # float64 holds half the elements in the same bytes, and a block of
    # 256 threads half the tile
    f64 = rb._bwd_plan((64,) * 3, (64,) * 3, 1, 3, torch.float64)
    assert f64.cap == 2048 and f64.tile == (4, 8, 8) and f64.blocks == 1024
    assert rb._bwd_plan((9, 9), (40, 50), 1, 3, torch.float64).tile == \
        (1, 8, 32)
    # 64-bit offsets too
    wide = rb._bwd_plan((2 ** 31,), (1000,), 1, 1, torch.float32)
    assert wide.wide and wide.tile == (1, 1, 256)


def test_plan_fits_short_axes():
    plan = rb._bwd_plan((9, 9, 9), (3, 40, 50), 1, 3, torch.float32)
    assert plan.tile == (4, 8, 16) and plan.view == (1, 3, 40, 50)
    assert plan.blocks == 1 * 5 * 4
    # a 4-D output: its first axis walks the grid
    plan = rb._bwd_plan((7, 6, 5, 8), (6, 5, 4, 7), 1, 3, torch.float32)
    assert plan.view == (6, 5, 4, 7) and plan.tile == (8, 4, 8)
    assert plan.blocks == 6
    # 2-D and 1-D outputs
    assert rb._bwd_plan((30, 30), (100, 100), 1, 1,
                        torch.float32).tile == (1, 16, 32)
    assert rb._bwd_plan((30, 30), (5, 3), 1, 1,
                        torch.float32).tile == (1, 8, 4)
    assert rb._bwd_plan((30,), (7,), 1, 1, torch.float32).tile == (1, 1, 8)
    # the other tile of the model
    plan = rb._bwd_plan((64,) * 3, (64,) * 3, 1, 3, torch.float32,
                        tile=(4, 8, 16))
    assert plan.tile == (4, 8, 16) and plan.blocks == 16 * 8 * 4


def test_plan_routes_and_refusals():
    f32 = torch.float32
    # one voxel's taps over the budget: every block direct
    assert rb._bwd_plan((9,) * 3, (9,) * 3, 64, 3, f32).route == "tile"
    big = rb._bwd_plan((9,) * 3, (9,) * 3, 65, 3, f32)
    assert big.route == "direct" and big.cap == 0 and big.smem == 0
    assert rb._bwd_plan((9,) * 4, (9,) * 4, 4, 5, f32).route == "direct"
    assert rb._bwd_plan((9,) * 3, (9,) * 3, 1, 3, f32, budget=24576).cap == \
        6144
    # forced
    assert rb._bwd_plan((9,) * 3, (9,) * 3, 1, 3, f32,
                        route="direct").route == "direct"
    with pytest.raises(ValueError):
        rb._bwd_plan((9,) * 3, (9,) * 3, 65, 3, f32, route="tile")
    with pytest.raises(ValueError):
        rb._bwd_plan((9,) * 3, (9,) * 3, 1, 3, f32, route="lines")
    with pytest.raises(ValueError):
        rb._bwd_plan((9,) * 3, (9,) * 3, 1, 3, f32, tile=(8, 8, 16))
    with pytest.raises(ValueError):
        rb._bwd_plan((9,) * 3, (9,) * 3, 1, 3, f32, tile=(3, 8, 8))
    with pytest.raises(ValueError):
        rb._bwd_plan((9,) * 3, (9,) * 3, 1, 3, torch.float64,
                     tile=(8, 8, 8))


@pytest.mark.parametrize("in_shape, out_shape, channels, wide", [
    ((2 ** 31 - 1,), (100,), 1, False),
    ((2 ** 31,), (100,), 1, True),
    ((2 ** 10, 2 ** 10, 2 ** 10), (100,), 2, True),
    ((100,), (2 ** 31 - 1,), 1, False),
    ((100,), (2 ** 30,), 2, True),
    ((10, 10), (2 ** 30 - 1,), 1, False),
    ((10, 10), (2 ** 30,), 1, True),
    ((10, 10, 10), (2 ** 30,), 1, True),
])
def test_plan_index_width(in_shape, out_shape, channels, wide):
    """A sample of 2^31 elements or more (coefficients ``n_in * C``, g
    ``n_out * C``, coordinates ``naxis * n_out``) takes 64-bit offsets."""
    plan = rb._bwd_plan(in_shape, out_shape, channels, 1, torch.float32)
    assert plan.wide is wide


def test_cpu_tensors_count_no_route():
    rs = np.random.RandomState(3)
    g = torch.as_tensor(rs.standard_normal((1, 6, 7, 1)))
    coords = torch.as_tensor(rs.uniform(0, 5, (1, 2, 6, 7)))
    displ = torch.as_tensor(rs.standard_normal((1, 2, 6, 7)))
    for fn, args in ((rb.resample_coords_transpose,
                      (g, coords, 3, 3, (6, 7))),
                     (rb.resample_transpose,
                      (g, displ, None, (0, 0), 3, 3, (6, 7)))):
        before, routes = fn.launches, dict(fn.routes)
        fn(*args)
        assert fn.launches == before and fn.routes == routes
        assert set(routes) == {"tile", "direct"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", range(5))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_both_branches_match_plain(cuda_device, dtype, mode):
    rtol = 1e-5 if dtype == torch.float32 else 1e-10
    for case, order in itertools.product(range(len(SHAPES)), (1, 3, 5)):
        in_shape, out_shape = SHAPES[case]
        rs = np.random.RandomState(case)
        cc, g = _draws(rs, len(in_shape), in_shape, out_shape, 2)
        ct = torch.as_tensor(cc, dtype=dtype, device=cuda_device)
        gt = torch.as_tensor(g, dtype=dtype, device=cuda_device)
        want = rb.resample_coords_transpose_plain(gt, ct, order, mode,
                                                  in_shape)
        terms = rb.resample_coords_transpose_plain(gt.abs(), ct, order, mode,
                                                   in_shape)
        for route in (None, "tile", "direct"):
            try:
                plan = rb._bwd_plan(in_shape, out_shape, 2, order, dtype,
                                    route=route)
            except ValueError:      # one voxel's box over the cap
                continue
            got = rb._launch_k3c(gt, ct, order, mode, in_shape, plan)
            err = (got.double() - want.double()).abs()
            assert bool((err <= rtol * terms.double()).all()), plan


def _direct_model(g, cc, in_shape, order, mode):
    """numpy float64 model of K3/K3c's direct route: ``g`` ``(B, *out,
    C)`` at sample coordinates ``cc`` ``(B, naxis, *out)``, one thread a
    voxel in raster order, each adding its own taps at their folded
    offsets. Returns the result and the counts: the device-memory atomics
    the kernel issues (one per tap and channel of a voxel that adds) and
    the voxels that add."""
    g = np.asarray(g, dtype=np.float64)
    B, C, naxis = g.shape[0], g.shape[-1], len(in_shape)
    nt = order + 1
    n_out = int(np.prod(cc.shape[2:]))
    ms, starts, weights, ok = _geometry(cc, in_shape, order, mode)
    ms = [m.reshape(B, n_out) for m in ms]
    starts = [s.reshape(B, n_out) for s in starts]
    weights = [[w.reshape(B, n_out) for w in ws] for ws in weights]
    ok = ok.reshape(B, n_out)
    gf = g.reshape(B, n_out, C)
    out = np.zeros((B, *in_shape, C))
    taps = list(itertools.product(range(nt), repeat=naxis))
    stats = {"atomics": 0, "voxels": 0}
    for b, v in itertools.product(range(B), range(n_out)):
        # constant mode outside adds nothing, but from order 1 a NaN
        # coordinate adds its NaN weights
        if not (ok[b, v] or order > 0 and
                any(np.isnan(ms[h][b, v]) for h in range(naxis))):
            continue
        stats["voxels"] += 1
        for t in taps:
            w = weights[0][t[0]][b, v]
            for h in range(1, naxis):
                w = w * weights[h][t[h]][b, v]
            idx = tuple(_fold(starts[h][b, v] + t[h], in_shape[h])
                        for h in range(naxis))
            out[b][idx] += gf[b, v] * w
            stats["atomics"] += C
    return out, stats


def _smooth_draws(rs, in_shape, out_shape, C, reach=2.0, B=2):
    """Coordinates that run smoothly over each input axis from ``reach``
    voxels below it to ``reach`` above (windows folded at both edges,
    constant mode's voxels outside), with a wobble of a quarter voxel, and
    a cotangent."""
    axes = np.meshgrid(*[np.linspace(0, 1, n) for n in out_shape],
                       indexing="ij")
    cc = np.empty((B, len(in_shape), *out_shape))
    for b in range(B):
        for h, n in enumerate(in_shape):
            cc[b, h] = -reach + axes[h] * (n - 1 + 2 * reach) + 0.25 * \
                np.sin(7.0 * sum(axes) + rs.uniform(0, 6))
    return cc, rs.standard_normal((B, *out_shape, C))


DIRECT_SHAPES = [s for s in SHAPES if len(s[0]) <= 3] + \
    [((9, 7, 12), (5, 6, 30)), ((13,), (80,))]


def _twin_terms(g, cc, order, mode, in_shape):
    ct, gt = torch.as_tensor(cc), torch.as_tensor(g)
    return (rb.resample_coords_transpose_plain(gt, ct, order, mode,
                                               in_shape).numpy(),
            rb.resample_coords_transpose_plain(gt.abs(), ct, order, mode,
                                               in_shape).numpy())


@pytest.mark.parametrize("mode", range(5))
@pytest.mark.parametrize("case", range(len(DIRECT_SHAPES)))
def test_direct_model_is_the_twin(case, mode):
    """The direct route's model at smooth coordinates (taps folded at both
    edges) and at random ones (up to 25 voxels outside), orders 0 and 1,
    one and three channels: the twin's sums, with one atomic per tap and
    channel of the voxels that add."""
    in_shape, out_shape = DIRECT_SHAPES[case]
    for order, C, smooth in itertools.product((0, 1), (1, 3), (True, False)):
        rs = np.random.RandomState(100 * case + 10 * mode + 4 * order + C)
        cc, g = (_smooth_draws(rs, in_shape, out_shape, C) if smooth else
                 _draws(rs, len(in_shape), in_shape, out_shape, C))
        want, terms = _twin_terms(g, cc, order, mode, in_shape)
        got, st = _direct_model(g, cc, in_shape, order, mode)
        _close(got, want, terms, (order, C, smooth))
        assert st["atomics"] == st["voxels"] * (order + 1) ** len(
            in_shape) * C


@pytest.mark.parametrize("mode", range(5))
def test_direct_model_with_affine_is_the_twin(mode):
    """K3's direct route at ``affine(j) + offset + displ`` (its output
    index unravelled from the thread's voxel) against
    ``resample_transpose_plain``."""
    in_shape, out_shape = (11, 13, 9), (10, 12, 9)
    rs = np.random.RandomState(40 + mode)
    B, naxis = 2, 3
    A = np.zeros((B, naxis, naxis + 1))
    A[:, :, :naxis] = np.eye(naxis) + rs.standard_normal((B, 3, 3)) * 0.05
    A[:, :, naxis] = rs.standard_normal((B, naxis))
    affine = torch.as_tensor(A)
    displ = torch.as_tensor(rs.standard_normal((B, naxis, *out_shape)) * 0.3)
    offsets = (1, 0, 2)
    cc = torch.stack(sample_coordinates(displ, affine, offsets), 1).numpy()
    for order, C in itertools.product((0, 1), (1, 3)):
        g = rs.standard_normal((B, *out_shape, C))
        gt = torch.as_tensor(g)
        want = rb.resample_transpose_plain(gt, displ, affine, offsets, order,
                                           mode, in_shape).numpy()
        terms = rb.resample_transpose_plain(gt.abs(), displ, affine, offsets,
                                            order, mode, in_shape).numpy()
        assert rb._bwd_plan(in_shape, out_shape, C, order,
                            torch.float64).route == "direct"
        got, _ = _direct_model(g, cc, in_shape, order, mode)
        _close(got, want, terms, (order, C))


@pytest.mark.parametrize("mode", range(5))
def test_direct_model_nan_coordinate(mode):
    """NaN coordinates (one inside, one outside on another axis) and a NaN
    in g: their taps land where the twin puts them (a NaN coordinate's
    first tap is 0), NaN where NaN, the rest equal to the twin's sums."""
    in_shape, out_shape = (6, 5, 20), (9, 8, 24)
    rs = np.random.RandomState(mode)
    cc, g = _smooth_draws(rs, in_shape, out_shape, 1)
    cc[0, 1, 4, 3, 5] = np.nan
    cc[1, 2, 2, 2, 9] = np.nan
    cc[1, 0, 3, 3, 3], cc[1, 1, 3, 3, 3] = -1.5, np.nan
    g[1, 4, 4, 10, 0] = np.nan
    want, terms = _twin_terms(g, cc, 1, mode, in_shape)
    fin = ~np.isnan(want)
    got, st = _direct_model(g, cc, in_shape, 1, mode)
    assert st["voxels"] > 0
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    _close(got[fin], want[fin], terms[fin])


def test_direct_plan():
    """The direct route's grid: one thread a voxel, DIRECT_THREADS a block,
    whatever the order, channels or dtype; the tile route keeps its grid;
    the C entry point takes no tile arguments."""
    f32, f64 = torch.float32, torch.float64
    p = rb._bwd_plan((9,) * 3, (10, 12, 40), 1, 0, f32)
    assert (p.route, p.cap, p.smem) == ("direct", 0, 0)
    assert p.blocks == -(-4800 // rb.DIRECT_THREADS) == 19
    assert rb._bwd_plan((9,) * 3, (10, 12, 40), 3, 1, f64).blocks == 19
    hi = rb._bwd_plan((9,) * 3, (10, 12, 40), 1, 3, f32, route="direct")
    assert (hi.route, hi.blocks) == ("direct", 19)
    # a channel count whose one-voxel box exceeds the budget, order 3
    big = rb._bwd_plan((9,) * 3, (9,) * 3, 65, 3, f32)
    assert (big.route, big.blocks) == ("direct", 3)
    assert rb._bwd_plan((9,), (1100,), 1, 1, f32).blocks == 5
    t = rb._bwd_plan((9,) * 3, (9,) * 3, 1, 3, f32)
    assert (t.route, t.blocks) == ("tile", 8)
    assert rb._tile_args(p) == ()
    assert len(rb._tile_args(t)) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", range(5))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_direct_route_matches_plain(cuda_device, dtype, mode):
    """The direct kernel against the twin at smooth coordinates, orders 0
    and 1, one and three channels."""
    rtol = 1e-5 if dtype == torch.float32 else 1e-10
    for case, order, C in itertools.product(range(len(DIRECT_SHAPES)),
                                            (0, 1), (1, 3)):
        in_shape, out_shape = DIRECT_SHAPES[case]
        rs = np.random.RandomState(case)
        cc, g = _smooth_draws(rs, in_shape, out_shape, C)
        ct = torch.as_tensor(cc, dtype=dtype, device=cuda_device)
        gt = torch.as_tensor(g, dtype=dtype, device=cuda_device)
        want = rb.resample_coords_transpose_plain(gt, ct, order, mode,
                                                  in_shape)
        terms = rb.resample_coords_transpose_plain(gt.abs(), ct, order, mode,
                                                   in_shape)
        plan = rb._bwd_plan(in_shape, out_shape, C, order, dtype,
                            route="direct")
        got = rb._launch_k3c(gt, ct, order, mode, in_shape, plan)
        err = (got.double() - want.double()).abs()
        assert bool((err <= rtol * terms.double()).all()), plan
