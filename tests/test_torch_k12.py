"""K12's select route (rank filters above 64 taps) on its two routes.

The card runs the select route either on the tile route, a block staging
its output tile's halo box of keys and values in shared memory and
selecting from there, or on the nd route, one thread per voxel reading
device memory at every pass; ``ops/morphology.py``'s ``_rank_plan`` picks
the route from the shapes. On the CPU:

* a numpy model of the tile route (``csrc/morphology.cu``
  ``rank_select_tile_kernel``), block by block: the box staged with the fold
  or ``cval``, the order-preserving keys, the taps' offsets into the box, a
  first pass of AND and OR, passes of the kernel's ``ED_RANK_BITS`` key bits
  with the digit counts packed in 8-bit fields of one 32-bit word (wrapping
  there as the kernel's do) and flushed every 255 taps, the stop when one
  key is left, and the pick in tap order, against ``rank_filter_plain`` and
  the JAX package's ``rank_filter`` / ``median_filter`` /
  ``percentile_filter`` bit for bit, over float32 with NaN and zeros of both
  signs, float64, int16, uint8 and bool, the five modes, 65-343 taps (boxes,
  a ball, sparse footprints) in 1-D to 3-D and with a batch axis;
* the plan's routes, its budget and its refusals.

The ``cuda`` test holds both routes against the twin, and skips without a
card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej
from elasticdeform_tpu_torch.ops import filters as tf
from elasticdeform_tpu_torch.ops import morphology as tm

MODES = ("reflect", "constant", "nearest", "mirror", "wrap")
RANKS = ("low", "mid", "high")
# the key bits the kernel resolves a pass, read from its source
RANK_BITS = int(re.search(r"#define ED_RANK_BITS (\d+)", (pathlib.Path(
    tm.__file__).parents[1] / "csrc" / "morphology.cu").read_text()).group(1))


def _keys(v):
    """``Key<T>::of`` in numpy: order-preserving unsigned keys, -0 and +0
    one key, every NaN the largest."""
    v = np.asarray(v)
    if v.dtype == np.bool_:
        return v.astype(np.uint64)
    if v.dtype.kind == "u":
        return v.astype(np.uint64)
    bits = 8 * v.dtype.itemsize
    u = v.view(f"u{v.dtype.itemsize}").astype(np.uint64)
    sign = np.uint64(1 << (bits - 1))
    if v.dtype.kind == "i":
        return u ^ sign
    full = np.uint64((1 << bits) - 1)
    u = np.where(v == 0, np.uint64(0), u)
    k = np.where(u & sign, ~u & full, u | sign)
    return np.where(np.isnan(v), full, k)


def _fold(j, n, mode):
    """``fold32``: the filter modes' index fold; -1 in constant mode."""
    if 0 <= j < n:
        return j
    if mode == "constant":
        return -1
    return tf._fold_index(j, n, mode)


def _select(kv, rank, width):
    """The kernel's selection on the keys ``kv`` (voxels x taps, uint64) of
    ``width``-bit registers: the rank-th key's prefix, the bit from which
    it is known, and what is left of the rank."""
    nv, taps = kv.shape
    u = np.uint64
    bits = RANK_BITS
    nd = 1 << bits
    assert nd <= 4, "the model packs the digit counts in one word"
    land = np.bitwise_and.reduce(kv, axis=1)
    diff = land ^ np.bitwise_or.reduce(kv, axis=1)
    hb = np.full(nv, -1, np.int64)
    for b in range(width):
        hb = np.where((diff >> u(b)) & u(1), b, hb)
    r = np.full(nv, rank, np.int64)
    m = np.full(nv, taps, np.int64)
    lo = hb + 1
    keep = np.where(lo >= width, u(0),
                    ~((u(1) << lo.astype(u)) - u(1)) & u((1 << width) - 1))
    prefix = np.where(diff == 0, land, land & keep)
    live = diff != 0
    while live.any():
        hs = np.maximum(lo - 1, 0).astype(u)
        ls = np.maximum(lo - bits, 0)
        x = kv ^ prefix[:, None]
        d = (x >> ls.astype(u)[:, None]) & u(nd - 1)
        match = (x >> hs[:, None]) <= u(1)
        wide = np.zeros((nv, nd - 1), np.int64)
        for t0 in range(0, taps, 255):
            sl = slice(t0, min(taps, t0 + 255))
            inc = np.where(match[:, sl], u(1) << (d[:, sl] << u(3)), u(0))
            cnt = inc.sum(axis=1) & u(0xFFFFFFFF)
            for f in range(nd - 1):
                wide[:, f] += ((cnt >> u(8 * f)) & u(255)).astype(np.int64)
        cum = np.cumsum(wide, axis=1)
        found = r[:, None] < cum
        dig = np.where(found.any(axis=1), found.argmax(axis=1), nd - 1)
        below = np.where(dig > 0, np.take_along_axis(
            np.concatenate([np.zeros((nv, 1), np.int64), cum], 1),
            dig[:, None], 1)[:, 0], 0)
        mm = np.where(dig < nd - 1, np.take_along_axis(
            np.concatenate([wide, np.zeros((nv, 1), np.int64)], 1),
            dig[:, None], 1)[:, 0], m - below)
        r = np.where(live, r - below, r)
        m = np.where(live, mm, m)
        prefix = np.where(live, prefix | (dig.astype(u) << ls.astype(u)),
                          prefix)
        lo = np.where(live, ls, lo)
        live = live & (mm > 1) & (ls > 0)
    return prefix, lo, r


def _box_values(flat, base, s, box, n3, st3, c3, mode, cval, dtype):
    """A block's box as the kernel stages it: each axis folded, ``cval``
    where one falls outside in constant mode."""
    f = [np.array([_fold(s[a] - c3[a] + b, n3[a], mode)
                   for b in range(box[a])]) for a in range(3)]
    inside = (f[0] >= 0)[:, None, None] & (f[1] >= 0)[None, :, None] & \
        (f[2] >= 0)[None, None, :]
    addr = base + (np.maximum(f[0], 0) * st3[0])[:, None, None] + \
        (np.maximum(f[1], 0) * st3[1])[None, :, None] + \
        (np.maximum(f[2], 0) * st3[2])[None, None, :]
    return np.where(inside, flat[addr], np.asarray(cval, dtype)).reshape(-1)


def _tile_model(x, footprint, centers, mode, cval, rank, plan):
    """The tile route on ``x`` (numpy), block by block."""
    shape = x.shape
    merged, group, batch = tf.nd_geometry(shape, footprint.shape)
    strides = tf._contiguous_strides(merged)
    flat = x.reshape(-1)
    out = np.zeros_like(flat)
    taps = np.argwhere(footprint)
    C, (TY, TX) = plan.column, tm.RANK_TILE
    tile = (C, TY, TX)
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
    P1, P0 = box[2], box[1] * box[2]
    toff = idx @ np.array([P0, P1, 1])
    tiles = [-(-n // t) for n, t in zip(n3, tile)]
    width = 64 if x.dtype.itemsize == 8 else 32
    vox = np.array(list(np.ndindex(*tile)))
    at = vox @ np.array([P0, P1, 1])
    bshape = [merged[d] for d in plan.grid_axes]
    for bi in np.ndindex(*bshape) if bshape else [()]:
        base = sum(int(i) * strides[d] for i, d in zip(bi, plan.grid_axes))
        for q in np.ndindex(*tiles):
            s = [qq * t for qq, t in zip(q, tile)]
            vals = _box_values(flat, base, s, box, n3, st3, c3, mode, cval,
                               x.dtype)
            kv = _keys(vals)[at[:, None] + toff[None, :]]
            prefix, lo, r = _select(kv, rank, width)
            mask = np.where(lo > 0, (np.uint64(1) << lo.astype(np.uint64))
                            - np.uint64(1), np.uint64(0))
            hit = (kv ^ prefix[:, None]) <= mask[:, None]
            t = (np.cumsum(hit, axis=1) == (r + 1)[:, None]).argmax(axis=1)
            j = vox + np.array(s)
            ok = np.all(j < np.array(n3), axis=1)
            addr = base + j[ok] @ np.array(st3)
            out[addr] = vals[at[ok] + toff[t[ok]]]
    return out.reshape(shape)


def _footprint(kind, rs):
    if kind == "box5":
        return np.ones((5, 5, 5), bool)
    if kind == "box7":
        return np.ones((7, 7, 7), bool)
    if kind == "ball3":
        g = np.indices((7, 7, 7)) - 3
        return (g ** 2).sum(0) <= 9
    if kind == "sparse":
        fp = rs.rand(5, 6, 4) > 0.25
        fp[0, 0, 0] = fp[-1, -1, -1] = True
        return fp
    if kind == "plane9":
        return np.ones((9, 9), bool)
    if kind == "line67":
        return np.ones(67, bool)
    raise ValueError(kind)


def _data(dtype, shape, rs):
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return rs.rand(*shape) > 0.5
    if dtype.kind == "f":
        a = np.round(rs.standard_normal(shape) * 4).astype(dtype) / 2
        a[rs.rand(*shape) < 0.05] = -0.0
        a[rs.rand(*shape) < 0.03] = np.nan
        a[rs.rand(*shape) < 0.01] = np.inf
        return a
    info = np.iinfo(dtype)
    lo, hi = max(info.min, -300), min(info.max, 300)
    a = rs.randint(lo, hi, size=shape).astype(dtype)
    a.reshape(-1)[:2] = (info.min, info.max)
    return a


# (footprint, shape, dtype): 125, 343, 123 (ball r=3), ~90 (sparse), 81
# and 67 taps, a batch axis, 1-D to 3-D
CASES = (("box5", (5, 9, 33), np.float32),
         ("box7", (4, 8, 34), np.float64),
         ("ball3", (6, 9, 7), np.int16),
         ("sparse", (2, 5, 7, 35), np.uint8),
         ("plane9", (11, 37), np.float32),
         ("line67", (70,), np.bool_),
         ("box5", (3, 5, 40), np.int16))


def _rank_case(i, which):
    rs = np.random.RandomState(40 + i)
    kind, shape, dtype = CASES[i]
    fp = _footprint(kind, rs)
    if len(shape) == 4:
        fp = fp[None]
    x = _data(dtype, shape, rs)
    k = int(fp.sum())
    rank = {"low": 1, "mid": k // 2, "high": k - 2}[which]
    centers = [int(rs.randint(0, s)) for s in fp.shape]
    return x, fp, centers, rank


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_tile_model_is_the_twin_and_the_jax_package(case, mode):
    """Each case in every mode, its rank 1, the middle or k - 2 in turn
    (every case takes all three over the modes)."""
    which = RANKS[(case + MODES.index(mode)) % 3]
    x, fp, centers, rank = _rank_case(case, which)
    tdt = torch.from_numpy(np.zeros(0, x.dtype)).dtype
    cval = tm._pad_value(-1.5 if x.dtype.kind == "f" else 7, tdt, mode,
                         [(c, k - 1 - c) for c, k in zip(centers, fp.shape)])
    plan = tm._rank_plan(x.shape, fp.shape, tdt, int(fp.sum()))
    assert plan.route == "tile"
    got = _tile_model(x, fp, centers, mode, cval, rank, plan)
    twin = tm.rank_filter_plain(torch.as_tensor(x), fp, centers, mode, cval,
                                rank).numpy()
    _equal(got, twin)
    origins = [c - k // 2 for c, k in zip(centers, fp.shape)]
    kw = dict(footprint=fp, mode=mode, cval=cval, origin=origins)
    _equal(got, ej.rank_filter(x, rank, **kw))
    if which == "mid":
        _equal(got, ej.median_filter(x, **kw))
    k = int(fp.sum())
    pct = 100.0 * rank / k
    if int(k * pct / 100.0) == rank:
        _equal(got, ej.percentile_filter(x, pct, **kw))


@pytest.mark.parametrize("which", RANKS)
def test_343_taps_are_the_twin(which):
    """The packed counters past one 255-tap chunk: float32 with NaN and
    zeros of both signs under a 7^3 box, ranks 1, middle and k - 2."""
    x, fp, centers, rank = _rank_case(1, which)
    x = _data(np.float32, x.shape, np.random.RandomState(RANKS.index(which)))
    plan = tm._rank_plan(x.shape, fp.shape, torch.float32, int(fp.sum()))
    assert plan.route == "tile" and int(fp.sum()) == 343
    got = _tile_model(x, fp, centers, "reflect", 0.0, rank, plan)
    _equal(got, tm.rank_filter_plain(torch.as_tensor(x), fp, centers,
                                     "reflect", 0.0, rank).numpy())


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


def test_keys_keep_the_sort_order():
    for dt in (np.float32, np.float64, np.int16, np.uint8, np.int64):
        v = _data(dt, (400,), np.random.RandomState(3))
        k = _keys(v)
        order = np.argsort(k, kind="stable")
        want = np.argsort(np.where(v == 0, 0, v), kind="stable")
        np.testing.assert_array_equal(order, want)


def test_plan_at_c15():
    f32 = torch.float32
    for shape in ((160, 192, 224), (80, 192, 224)):
        plan = tm._rank_plan(shape, (5, 5, 5), f32, 125)
        assert plan == tm.RankPlan(
            "tile", (0, 1, 2), (), 4, (8, 12, 36),
            2 * 8 * 12 * 36 * 4 + 125 * 4, (shape[0] // 4) * 24 * 7)
    assert tm._rank_plan((160, 192, 224), (3, 3, 3), f32, 27).route == \
        "network_tile"
    assert tm._rank_plan((160, 192, 224), (5, 5, 5), f32, 33).route == \
        "network_tile"


def test_plan_shapes_and_refusals():
    f32, f64 = torch.float32, torch.float64
    # 2-D: a leading extent of 1 and a column of 1
    plan = tm._rank_plan((40, 50), (9, 9), f64, 81)
    assert plan.tile_axes == (-1, 0, 1) and plan.column == 1
    assert plan.box == (1, 16, 40)
    # a batch axis joins the tile, a second one the grid
    plan = tm._rank_plan((2, 9, 10, 11), (1, 5, 5, 5), torch.int16, 100)
    assert plan.tile_axes == (1, 2, 3) and plan.grid_axes == (0,)
    plan = tm._rank_plan((3, 40, 50), (1, 9, 9), f32, 81)
    assert plan.tile_axes == (0, 1, 2) and plan.grid_axes == ()
    nd = tm.RankPlan("nd")
    # four footprint axes, a box over the budget, 2^31 elements
    assert tm._rank_plan((3, 4, 5, 6), (3, 3, 3, 3), f32, 81) == nd
    # the budget's edge: a 92 x 92 plane's box (1, 99, 123) of float64 keys
    # and values and its taps take 228688 bytes, a 93 x 93 plane's 232996
    plan = tm._rank_plan((300, 300), (92, 92), f64, 92 * 92)
    assert plan.route == "tile" and plan.smem == 228688 <= tm.SMEM_LIMIT
    assert tm._rank_plan((300, 300), (93, 93), f64, 93 * 93) == nd
    with pytest.raises(ValueError):
        tm._rank_plan((300, 300), (93, 93), f64, 93 * 93, route="tile")
    assert tm._rank_plan((99, 99, 99), (21, 21, 21), f64, 9261) == nd
    assert tm._rank_plan((2 ** 16, 2 ** 16), (9, 9), f32, 81) == nd
    assert tm._rank_plan((40, 50), (9, 9), f32, 81, route="nd") == nd
    with pytest.raises(ValueError):
        tm._rank_plan((3, 4, 5, 6), (3, 3, 3, 3), f32, 81, route="tile")
    with pytest.raises(ValueError):
        tm._rank_plan((40, 50), (3, 3), f32, 9, route="tile")
    with pytest.raises(ValueError):
        tm._rank_plan((40, 50), (9, 9), f32, 81, route="rows")


def test_cpu_tensors_count_no_route():
    x = torch.as_tensor(np.random.RandomState(3).standard_normal((9, 12)))
    fn = tm.rank_filter
    before, routes = fn.launches, dict(fn.routes)
    fn(x, np.ones((9, 9), bool), [4, 4], "reflect", 0.0, 40)
    assert fn.launches == before and fn.routes == routes
    assert set(routes) == {"network_tile", "network", "tile", "nd"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_both_routes_match_plain(cuda_device, mode):
    for case in range(len(CASES)):
        x, fp, centers, rank = _rank_case(case, "mid")
        xt = torch.as_tensor(x).to(cuda_device)
        cval = tm._pad_value(2, xt.dtype, mode, [(1, 1)])
        want = tm.rank_filter_plain(xt, fp, centers, mode, cval, rank)
        for route in ("tile", "nd"):
            plan = tm._rank_plan(x.shape, fp.shape, xt.dtype, int(fp.sum()),
                                 route=route)
            got = tm._launch_rank(xt, fp, centers, mode, cval, rank, plan)
            _equal(got.cpu().numpy(), want.cpu().numpy())
