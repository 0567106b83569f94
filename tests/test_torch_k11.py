"""K11, the footprint min/max (grey erosion and dilation), on its two routes.

The card runs K11 (``min_max_filter``) either on the tile route, a block
staging its output tile's halo box in the work type in shared memory, each
element folded by the mode or ``cval`` in constant mode, and reducing the
taps from there, or on the nd route, one thread per voxel reading device
memory at every tap; ``ops/morphology.py``'s ``_min_max_plan`` picks the
route from the shapes. On the CPU:

* a numpy model of the tile route (``csrc/morphology.cu``
  ``min_max_tile_kernel``), block by block: block -> batch index and tile,
  the box staged with the fold or ``cval`` in the work type (float64 for a
  non-flat structure on integers and bool), the taps' box offsets in raster
  order, ``v - s`` / ``v + s`` for a non-flat structure, ``acc = v_0`` then
  the NaN-propagating min or max with -0 below +0, and the saturating cast,
  against ``min_max_filter_plain`` and the JAX package's
  ``minimum_filter`` / ``maximum_filter`` / ``grey_erosion`` /
  ``grey_dilation`` bit for bit (NaN where NaN, a zero's sign too), flat and
  non-flat, in float32 with NaN and zeros of both signs, float64, int16,
  uint8 and bool, in every mode, 1-D to 3-D footprints and a batch axis;
* the plan at c16's shapes, its budget and its refusals;
* CPU tensors count no route.

The ``cuda`` test holds both routes against the twin, and skips without a
card.
"""

import itertools

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej

from elasticdeform_tpu_torch.ops import filters as tf
from elasticdeform_tpu_torch.ops import morphology as tm

MODES = ("reflect", "constant", "nearest", "mirror", "wrap")
DTYPES = ("float32", "float64", "int16", "uint8", "bool")


def _fold(j, n, mode):
    if 0 <= j < n:
        return j
    if mode == "constant":
        return -1
    return tf._fold_index(j, n, mode)


def _pick(a, b, minimum):
    """``nan_min`` / ``nan_max``: a NaN operand wins (the first), -0 counts
    below +0."""
    if a.dtype.kind != "f":
        return np.minimum(a, b) if minimum else np.maximum(a, b)
    with np.errstate(invalid="ignore"):
        less = b < a if minimum else a < b
        tie = np.where(np.signbit(a), b if not minimum else a,
                       a if not minimum else b)
        r = np.where(a == b, tie, np.where(less, b, a))
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, r))


def _finish(acc, dtype):
    """``finish<T, W>``: the work-type result in ``dtype``: bool ``!= 0``,
    integers NaN to 0, truncated and saturated."""
    if acc.dtype == dtype:
        return acc
    if dtype == np.bool_:
        return acc != 0
    info = np.iinfo(dtype)
    t = np.trunc(np.where(np.isnan(acc), 0.0, acc))
    return np.clip(t, info.min, info.max).astype(dtype)


def _tile_model(x, footprint, structure, centers, mode, cval, minimum,
                plan):
    """The tile route on ``x`` (numpy), block by block."""
    dtype = x.dtype
    work = dtype if structure is None or dtype.kind == "f" else \
        np.dtype(np.float64)
    merged, group, batch = tf.nd_geometry(x.shape, footprint.shape)
    strides = tf._contiguous_strides(merged)
    taps = np.argwhere(footprint)
    sval = None if structure is None else \
        np.asarray(structure, np.float64)[footprint].astype(work)
    tile = (plan.column,) + tm.RANK_TILE
    n3, st3, c3 = [1] * 3, [0] * 3, [0] * 3
    idx = np.zeros((len(taps), 3), np.int64)
    for a, d in enumerate(plan.tile_axes):
        if d < 0:
            continue
        n3[a], st3[a] = merged[d], strides[d]
        if not batch[d]:
            ax = group.index(d)
            c3[a] = centers[ax]
            idx[:, a] = taps[:, ax]
    box = plan.box
    P0, P1 = box[1] * box[2], box[2]
    toff = idx @ np.array([P0, P1, 1])
    flat = x.reshape(-1)
    out = np.zeros_like(flat)
    at = (np.arange(tile[0])[:, None, None] * P0
          + np.arange(tile[1])[None, :, None] * P1
          + np.arange(tile[2])[None, None, :])
    ntiles = [-(-n // t) for n, t in zip(n3, tile)]
    bshape = [merged[d] for d in plan.grid_axes]
    blocks = 0
    for bi in itertools.product(*[range(n) for n in bshape]):
        base = sum(i * strides[d] for i, d in zip(bi, plan.grid_axes))
        for q in itertools.product(*[range(t) for t in ntiles]):
            blocks += 1
            s = [qq * t for qq, t in zip(q, tile)]
            f = [np.array([_fold(s[a] - c3[a] + b, n3[a], mode)
                           for b in range(box[a])]) for a in range(3)]
            inside = ((f[0] >= 0)[:, None, None] & (f[1] >= 0)[None, :, None]
                      & (f[2] >= 0)[None, None, :])
            addr = base + sum(np.maximum(f[a], 0).reshape(
                [-1 if b == a else 1 for b in range(3)]) * st3[a]
                for a in range(3))
            vals = np.where(inside, flat[addr].astype(work),
                            np.asarray(cval, work)).reshape(-1)
            acc = None
            for t in range(len(taps)):
                v = vals[at + toff[t]]
                if sval is not None:
                    v = v - sval[t] if minimum else v + sval[t]
                acc = v if acc is None else _pick(acc, v, minimum)
            j = [s[a] + np.arange(tile[a]) for a in range(3)]
            ok = ((j[0] < n3[0])[:, None, None] & (j[1] < n3[1])[None, :, None]
                  & (j[2] < n3[2])[None, None, :])
            oaddr = base + sum(j[a].reshape(
                [-1 if b == a else 1 for b in range(3)]) * st3[a]
                for a in range(3))
            out[oaddr[ok]] = _finish(acc, dtype)[ok]
    assert blocks == plan.blocks
    return out.reshape(x.shape)


def _data(dtype, shape, rs):
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return rs.rand(*shape) > 0.5
    if dtype.kind == "f":
        a = np.round(rs.standard_normal(shape) * 4).astype(dtype) / 2
        a[rs.rand(*shape) < 0.1] = -0.0
        a[rs.rand(*shape) < 0.03] = np.nan
        a[rs.rand(*shape) < 0.01] = np.inf
        a[rs.rand(*shape) < 0.01] = -np.inf
        return a
    info = np.iinfo(dtype)
    a = rs.randint(info.min, int(info.max) + 1, size=shape).astype(dtype)
    a.reshape(-1)[:2] = (info.min, info.max)
    return a


def _ball(r):
    g = np.indices((2 * r + 1,) * 3) - r
    return (g ** 2).sum(0) <= r * r


# (footprint, shape): a ball, a sparse 3-D footprint, a 2-D cross, a 1-D
# comb, a footprint over a batch axis (its tile walks the batch)
def _footprint(kind, rs):
    if kind == "ball2":
        return _ball(2)
    if kind == "sparse":
        fp = rs.rand(3, 4, 5) > 0.4
        fp[0, 0, 0] = fp[-1, -1, -1] = True
        return fp
    if kind == "cross":
        fp = np.zeros((5, 3), bool)
        fp[2] = fp[:, 1] = True
        return fp
    if kind == "comb":
        return np.array([1, 0, 1, 1, 0, 0, 1], bool)
    if kind == "batch":
        return _ball(1)[None]
    raise ValueError(kind)


CASES = (("ball2", (11, 9, 35)), ("sparse", (4, 10, 33)),
         ("cross", (13, 40)), ("comb", (70,)), ("batch", (2, 5, 9, 33)))


def _case(i, dtype, nonflat, mode):
    rs = np.random.RandomState(7 * i + DTYPES.index(dtype) + 31 * nonflat)
    kind, shape = CASES[i]
    fp = _footprint(kind, rs)
    x = _data(dtype, shape, rs)
    centers = [int(rs.randint(0, k)) for k in fp.shape]
    st = np.round(rs.standard_normal(fp.shape) * 40, 1) if nonflat else None
    work = torch.float64 if nonflat and np.dtype(dtype).kind != "f" else \
        torch.from_numpy(np.zeros(0, dtype)).dtype
    cval = tm._pad_value(-2.5 if work.is_floating_point else 3, work, mode,
                         [(c, k - 1 - c) for c, k in zip(centers, fp.shape)])
    return x, fp, st, centers, cval


def _equal(got, want):
    """The same dtype, shape and bits (a zero's sign too), NaN where NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        bits = np.dtype(f"i{got.dtype.itemsize}")
        got = np.where(nan, 0, got).view(bits)
        want = np.where(nan, 0, want).view(bits)
    np.testing.assert_array_equal(got, want)


def _jax(x, fp, st, centers, mode, cval, minimum):
    """The JAX package's call that runs K11's function on these taps."""
    origins = [c - k // 2 for c, k in zip(centers, fp.shape)]
    kw = dict(mode=mode, cval=cval)
    if st is None:
        fn = ej.minimum_filter if minimum else ej.maximum_filter
        return fn(x, footprint=fp, origin=origins, **kw)
    if minimum:
        return ej.grey_erosion(x, footprint=fp, structure=st,
                               origin=origins, **kw)
    # grey_dilation reflects the footprint and structure and mirrors the
    # origin (one more on an even axis): undo both
    flip = (slice(None, None, -1),) * fp.ndim
    return ej.grey_dilation(
        x, footprint=fp[flip], structure=st[flip], origin=[
            k // 2 - c - (1 - k % 2) for c, k in zip(centers, fp.shape)],
        **kw)


@pytest.mark.parametrize("nonflat", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_tile_model_is_the_twin_and_the_jax_package(case, dtype, nonflat):
    """Each case, dtype and structure in two modes, erosion in one and
    dilation in the other (every mode over the cases)."""
    for k in range(2):
        mode = MODES[(2 * case + k + DTYPES.index(dtype)) % 5]
        minimum = bool(k)
        x, fp, st, centers, cval = _case(case, dtype, nonflat, mode)
        work = torch.float64 if nonflat and x.dtype.kind != "f" else \
            torch.from_numpy(x[:0]).dtype
        plan = tm._min_max_plan(x.shape, fp.shape, work, int(fp.sum()),
                                nonflat)
        assert plan.route == "tile"
        got = _tile_model(x, fp, st, centers, mode, cval, minimum, plan)
        _equal(got, tm.min_max_filter_plain(torch.as_tensor(x), fp, st,
                                            centers, mode, cval,
                                            minimum).numpy())
        _equal(got, _jax(x, fp, st, centers, mode, cval, minimum))


@pytest.mark.parametrize("mode", MODES)
def test_c16_kinds_cut_to_size(mode):
    """c16's two K11 calls at a cut size: the int16 ball erosion (flat, 33
    taps) and the non-flat 3^3 dilation in float64 work, saturating."""
    rs = np.random.RandomState(16 + MODES.index(mode))
    x = rs.randint(-1024, 3072, (9, 17, 40)).astype(np.int16)
    for fp, st, minimum in ((_ball(2), None, True),
                            (np.ones((3, 3, 3), bool),
                             -30.0 * (np.indices((3, 3, 3)) - 1).__pow__(2)
                             .sum(0) + 40000.0, False)):
        work = torch.int16 if st is None else torch.float64
        plan = tm._min_max_plan(x.shape, fp.shape, work, int(fp.sum()),
                                st is not None)
        centers = [k // 2 for k in fp.shape]
        got = _tile_model(x, fp, st, centers, mode, 0, minimum, plan)
        _equal(got, tm.min_max_filter_plain(torch.as_tensor(x), fp, st,
                                            centers, mode, 0,
                                            minimum).numpy())
        _equal(got, _jax(x, fp, st, centers, mode, 0, minimum))


def test_plan_at_c16():
    ball = _ball(2)
    plan = tm._min_max_plan((512, 512, 300), ball.shape, torch.int16, 33,
                            False)
    c = tm.MINMAX_COLUMN
    assert plan == tm.RankPlan(
        "tile", (0, 1, 2), (), c, (c + 4, 12, 36),
        -(-(c + 4) * 12 * 36 * 2 // 4) * 4 + 33 * 4,
        (512 // c) * 64 * 10)
    nonflat = tm._min_max_plan((256, 512, 300), (3, 3, 3), torch.float64,
                               27, True)
    assert nonflat == tm.RankPlan(
        "tile", (0, 1, 2), (), c, (c + 2, 10, 34),
        ((c + 2) * 10 * 34 + 27) * 8 + 27 * 4, (256 // c) * 64 * 10)


def test_plan_shapes_and_refusals():
    f32, f64 = torch.float32, torch.float64
    # 2-D: a leading extent of 1 and a column of 1
    plan = tm._min_max_plan((40, 50), (5, 3), f64, 7, False)
    assert plan.tile_axes == (-1, 0, 1) and plan.column == 1
    assert plan.box == (1, 12, 34)
    # a batch axis joins the tile, a second one the grid
    plan = tm._min_max_plan((2, 9, 10, 11), (1, 3, 3, 3), torch.uint8, 19,
                            False)
    assert plan.tile_axes == (1, 2, 3) and plan.grid_axes == (0,)
    nd = tm.RankPlan("nd")
    assert tm._min_max_plan((3, 4, 5, 6), (3, 3, 3, 3), f32, 81,
                            False) == nd
    # the budget's edge: a 126 x 126 plane's box (1, 133, 157) of float64
    # and its taps' offsets take 230552 bytes, a 127 x 127 one's 233892
    plan = tm._min_max_plan((300, 300), (126, 126), f64, 126 * 126, False)
    assert plan.route == "tile" and plan.smem == 230552 <= tm.SMEM_LIMIT
    assert tm._min_max_plan((300, 300), (127, 127), f64, 127 * 127,
                            False) == nd
    assert tm._min_max_plan((2 ** 16, 2 ** 16), (3, 3), f32, 9, False) == nd
    assert tm._min_max_plan((40, 50), (3, 3), f32, 9, False,
                            route="nd") == nd
    with pytest.raises(ValueError):
        tm._min_max_plan((300, 300), (127, 127), f64, 127 * 127, False,
                         route="tile")
    with pytest.raises(ValueError):
        tm._min_max_plan((3, 4, 5, 6), (3, 3, 3, 3), f32, 81, False,
                         route="tile")
    with pytest.raises(ValueError):
        tm._min_max_plan((40, 50), (3, 3), f32, 9, False, route="rows")


def test_cpu_tensors_count_no_route():
    x = torch.as_tensor(np.random.RandomState(3).standard_normal((9, 12)))
    fn = tm.min_max_filter
    before, routes = fn.launches, dict(fn.routes)
    fn(x, np.eye(3, dtype=bool), None, [1, 1], "reflect", 0.0, True)
    assert fn.launches == before and fn.routes == routes
    assert set(routes) == {"tile", "nd"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nonflat", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_both_routes_match_plain(cuda_device, dtype, nonflat):
    for case, mode in itertools.product(range(len(CASES)), MODES):
        x, fp, st, centers, cval = _case(case, dtype, nonflat, mode)
        xt = torch.as_tensor(x).to(cuda_device)
        work = tm._work_dtype(xt.dtype, nonflat)
        for minimum in (True, False):
            want = tm.min_max_filter_plain(xt, fp, st, centers, mode, cval,
                                           minimum)
            for route in ("tile", "nd"):
                plan = tm._min_max_plan(x.shape, fp.shape, work,
                                        int(fp.sum()), nonflat, route=route)
                got = tm._launch_min_max(xt, fp, st, centers, mode, cval,
                                         minimum, plan)
                _equal(got.cpu().numpy(), want.cpu().numpy())
