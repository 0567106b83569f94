"""K12's network route (rank filters up to 64 taps) on its two routes.

The card runs the comparator network either on the network tile
(``csrc/morphology.cu`` ``rank_network_tile_kernel``: a block stages its
tile's halo box of values in shared memory, and each thread loads a voxel's
taps into N wires held in registers, runs Batcher's comparators at
compile-time indices and takes wire ``rank``) or on the old kernel, one
thread per voxel reading device memory; ``ops/morphology.py``'s
``_rank_plan`` picks the route. On the CPU:

* a Python model of the kernel's ``constexpr`` construction of the
  comparator list (``batcher_merge`` / ``batcher_sort``) against
  ``_batcher_pairs``, 2 to 64 wires, and its pair count against the
  source's ``ED_NET_MAX_PAIRS``;
* the whole list against the old kernel's pruned one: for every tap count
  up to 64 and every rank, ``_rank_network``'s list is the backward cone of
  wire ``rank`` in the whole list, and the two give the same wire ``rank``;
* a numpy model of the kernel's arithmetic (integer keys in nan_min /
  nan_max's order, a NaN flag, the whole list or the pruned one, wire
  ``rank`` taken by halves) against ``rank_filter_plain`` and the JAX
  package's ``rank_filter`` / ``median_filter`` / ``percentile_filter``
  bit for bit (NaN where NaN, a zero's sign), over float32 with NaN,
  infinities and zeros of both signs, float64, int16, uint8 and bool, in the
  five modes;
* the plan's routes and refusals.

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
_SRC = (pathlib.Path(tm.__file__).parents[1] / "csrc" /
        "morphology.cu").read_text()
MAX_PAIRS = int(re.search(r"#define ED_NET_MAX_PAIRS (\d+)", _SRC).group(1))


def _constexpr_batcher(n):
    """``batcher_net(n)`` of the kernel's source, step by step: a count and
    two arrays filled by ``batcher_sort`` and ``batcher_merge``."""
    net = {"count": 0, "i": [0] * MAX_PAIRS, "j": [0] * MAX_PAIRS}

    def merge(lo, m, r):
        step = r * 2
        if step < m:
            merge(lo, m, step)
            merge(lo + r, m, step)
            i = lo + r
            while i < lo + m - r:
                net["i"][net["count"]] = i
                net["j"][net["count"]] = i + r
                net["count"] += 1
                i += step
        else:
            net["i"][net["count"]] = lo
            net["j"][net["count"]] = lo + r
            net["count"] += 1

    def sort(lo, hi):
        if hi - lo >= 1:
            mid = lo + (hi - lo) // 2
            sort(lo, mid)
            sort(mid + 1, hi)
            merge(lo, hi - lo + 1, 1)

    sort(0, n - 1)
    c = net["count"]
    return tuple(zip(net["i"][:c], net["j"][:c]))


@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 64])
def test_constexpr_list_is_batcher_pairs(n):
    assert _constexpr_batcher(n) == tm._batcher_pairs(n)
    assert len(tm._batcher_pairs(64)) == MAX_PAIRS


def _cone(pairs, rank):
    """The comparators of ``pairs`` in the backward cone of wire ``rank``,
    in their order: those that can change it."""
    live, kept = {rank}, []
    for i, j in reversed(pairs):
        if i in live or j in live:
            kept.append((i, j))
            live.update((i, j))
    return tuple(reversed(kept))


@pytest.mark.parametrize("k", range(1, 65))
def test_whole_list_selects_what_the_pruned_list_does(k):
    """For every rank: ``_rank_network``'s list (the old kernel's) is the
    whole list's backward cone of wire ``rank``, and on random keys with
    pad wires at the largest the two lists leave the same wire ``rank``
    (the network tile runs the whole list)."""
    rs = np.random.RandomState(k)
    for rank in range(k):
        wires, kept = tm._rank_network(k, rank)
        pairs = tm._batcher_pairs(wires) if wires > 1 else ()
        assert _cone(pairs, rank) == kept
        w0 = np.concatenate([rs.randint(-5, 5, (40, k)),
                             np.full((40, wires - k), 99)], 1)
        got = []
        for net in (pairs, kept):
            w = w0.copy()
            for i, j in net:
                a, b = w[:, i].copy(), w[:, j].copy()
                w[:, i], w[:, j] = np.minimum(a, b), np.maximum(a, b)
            got.append(w[:, rank])
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_array_equal(got[0], np.sort(w0, 1)[:, rank])


def _keys(v):
    """``NetKey<T>::of``: integers and bool as they are (int64, or uint64
    for uint64), floats as their bits with the magnitude flipped under a
    set sign bit."""
    if v.dtype == np.float32:
        b = v.view(np.int32).astype(np.int64)
        return b ^ ((b >> 31) & 0x7FFFFFFF)
    if v.dtype == np.float64:
        b = v.view(np.int64)
        return b ^ ((b >> 63) & np.int64(0x7FFFFFFFFFFFFFFF))
    return v.astype(np.uint64 if v.dtype == np.uint64 else np.int64)


def _back(k, dtype):
    if dtype == np.float32:
        return (k ^ ((k >> 31) & 0x7FFFFFFF)).astype(np.int32).view(np.float32)
    if dtype == np.float64:
        return (k ^ ((k >> 63) & np.int64(0x7FFFFFFFFFFFFFFF))).view(
            np.float64)
    return k.astype(dtype)


def _tap_stack(x, fp, centers, mode, cval):
    """The footprint's taps of every voxel (raster order) from the array
    padded by the mode, or ``cval`` in constant mode: what the network
    tile's box holds at each tap's offset."""
    xt = torch.as_tensor(x)
    for ax, (k, c) in enumerate(zip(fp.shape, centers)):
        xt = tf.pad_axis(xt, ax, c, k - 1 - c, mode, cval)
    xp = xt.numpy()
    taps = np.argwhere(fp)
    return np.stack([xp[tuple(slice(int(t), int(t) + n)
                              for t, n in zip(tap, x.shape))]
                     for tap in taps], -1).reshape(-1, len(taps))


def _network_model(x, fp, centers, mode, cval, rank, pruned):
    """The network tile's arithmetic per voxel: keys, pad wires at the
    type's largest value, the whole comparator list (or, ``pruned``, the
    old kernel's), integer min and max, wire ``rank`` by halves, NaN where
    a tap is NaN."""
    dtype = x.dtype
    stack = _tap_stack(x, fp, centers, mode, cval)
    k = stack.shape[1]
    wires, kept = tm._rank_network(k, rank)
    pad = np.asarray(tm._pad_max_value(torch.as_tensor(x).dtype), dtype)
    w = _keys(np.concatenate(
        [stack, np.broadcast_to(pad, (len(stack), wires - k))], 1))
    for i, j in kept if pruned else tm._batcher_pairs(wires):
        a, b = w[:, i].copy(), w[:, j].copy()
        w[:, i], w[:, j] = np.minimum(a, b), np.maximum(a, b)
    half = wires // 2
    while half >= 1:
        if rank & half:
            w[:, :half] = w[:, half:2 * half]
        half //= 2
    out = _back(w[:, 0], dtype)
    if dtype.kind == "f":
        out = np.where(np.isnan(stack).any(1), dtype.type(np.nan), out)
    return out.reshape(x.shape)


def _same(got, want):
    """Bit for bit, NaN where NaN (a NaN's payload not compared)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        keep = ~np.isnan(want)
        got, want = got[keep], want[keep]
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    np.testing.assert_array_equal(got, want)


def _volume(rs, shape, dtype):
    """float32 with NaN, infinities and zeros of both signs; float64; int16
    over its range; uint8 from a pool of ties; bool."""
    if dtype == np.bool_:
        return rs.rand(*shape) > 0.5
    if dtype.kind == "f":
        a = (rs.randn(*shape) * 100).astype(dtype)
        a[rs.rand(*shape) < 0.1] = 0.0
        a[rs.rand(*shape) < 0.1] = -0.0
        if dtype == np.float32:
            a[rs.rand(*shape) < 0.02] = np.nan
            a[rs.rand(*shape) < 0.02] = np.inf
            a[rs.rand(*shape) < 0.02] = -np.inf
        return a
    if dtype == np.uint8:
        return rs.choice(np.array([0, 7, 7, 200, 255], dtype), size=shape)
    info = np.iinfo(dtype)
    return rs.randint(info.min, info.max, size=shape, dtype=dtype)


FOOTPRINTS = {
    "cube3": np.ones((3, 3, 3), bool),
    "ball33": (((np.indices((5, 5, 5)) - 2) ** 2).sum(0) <= 4),
    "plane5": np.ones((1, 5, 5), bool),
    "sparse": np.random.RandomState(3).rand(3, 2, 4) > 0.4,
    "line3": np.ones((3, 1, 1), bool),
    "cube4": np.ones((4, 4, 4), bool),
}
DTYPES = [np.float32, np.float64, np.int16, np.uint8, np.bool_]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", sorted(FOOTPRINTS))
def test_network_model_is_the_twin_and_the_jax_package(name, dtype, mode):
    dtype = np.dtype(dtype)
    rs = np.random.RandomState(sorted(FOOTPRINTS).index(name) * 7 +
                               DTYPES.index(dtype.type))
    fp = FOOTPRINTS[name]
    x = _volume(rs, (6, 7, 9), dtype)
    xt = torch.as_tensor(x)
    k = int(fp.sum())
    centers = [int(rs.randint(0, s)) for s in fp.shape]
    origins = [c - s // 2 for c, s in zip(centers, fp.shape)]
    cval = tm.raw_cval(float(rs.randint(-50 * (dtype.kind in "if"), 200))
                       if dtype.kind != "b" else 1.0, xt.dtype)
    for rank in sorted({1, k // 2, k - 2}):
        twin = tm.rank_filter_plain(xt, fp, centers, mode, cval, rank).numpy()
        for pruned in (False, True):
            _same(_network_model(x, fp, centers, mode, cval, rank, pruned),
                  twin)
        if k // 2 == rank and k % 2:
            want = ej.median_filter(x, footprint=fp, mode=mode, cval=cval,
                                    origin=origins)
        else:
            want = ej.rank_filter(x, rank, footprint=fp, mode=mode,
                                  cval=cval, origin=origins)
        _same(twin, np.asarray(want))
    pct = 100.0 * 2 / (k - 1) if k > 3 else 50.0
    want = ej.percentile_filter(x, pct, footprint=fp, mode=mode, cval=cval,
                                origin=origins)
    rank = int(pct / 100.0 * k)
    rank = min(max(rank, 0), k - 1)
    if 0 < rank < k - 1:
        _same(_network_model(x, fp, centers, mode, cval, rank, False),
              np.asarray(want))


def test_keys_order_values_as_nan_min_does():
    """The float keys' integer order is the values' order with -0 below +0;
    the map gives the bits back."""
    rs = np.random.RandomState(9)
    for dtype in (np.float32, np.float64):
        v = np.concatenate([rs.randn(500).astype(dtype) * 1e3,
                            np.array([0.0, -0.0, np.inf, -np.inf], dtype)])
        k = _keys(v)
        np.testing.assert_array_equal(_back(k, np.dtype(dtype)).view(
            v.view(f"u{v.itemsize}").dtype), v.view(f"u{v.itemsize}"))
        order = np.argsort(k, kind="stable")
        total = np.lexsort((~np.signbit(v), v))
        np.testing.assert_array_equal(v[order].view(f"u{v.itemsize}"),
                                      v[total].view(f"u{v.itemsize}"))


def test_plan_at_c15_and_wires():
    f32, f64 = torch.float32, torch.float64
    S = (160, 192, 224)
    for fs, k in (((3, 3, 3), 27), ((5, 5, 5), 33)):
        plan = tm._rank_plan(S, fs, f32, k)
        wires, _ = tm._rank_network(k, 0)
        box = (tm.NETWORK_COLUMN + fs[0] - 1, 8 + fs[1] - 1, 32 + fs[2] - 1)
        assert plan == tm.RankPlan(
            "network_tile", (0, 1, 2), (), tm.NETWORK_COLUMN, box,
            4 * int(np.prod(box)) + 4 * wires,
            (S[0] // 4) * 24 * 7)
    # every wire count of the tile; a column of one where tile axis 0 has
    # extent 1
    for k, wires in ((3, 4), (5, 8), (9, 16), (17, 32), (64, 64)):
        assert tm._rank_network(k, 0)[0] == wires
        plan = tm._rank_plan((40, 50), (1, k), f64, k)
        assert plan.route == "network_tile" and plan.column == 1
    assert tm._rank_plan((9, 40, 50), (3, 3, 3), f32, 27).column == \
        tm.NETWORK_COLUMN
    assert tm.NETWORK_COLUMN == int(re.search(
        r"#define ED_NET_COLUMN (\d+)", _SRC).group(1))


def test_plan_routes_and_refusals():
    f32 = torch.float32
    net = tm.RankPlan("network")
    # two taps or fewer: the old kernel only
    assert tm._rank_plan((40, 50), (1, 2), f32, 2) == net
    assert tm._rank_plan((40,), (1,), f32, 1) == net
    with pytest.raises(ValueError):
        tm._rank_plan((40, 50), (1, 2), f32, 2, route="network_tile")
    # four footprint axes, 2^31-element samples: the old kernel
    assert tm._rank_plan((3, 4, 5, 6), (2, 2, 2, 2), f32, 16) == net
    assert tm._rank_plan((2 ** 16, 2 ** 16), (3, 3), f32, 9) == net
    with pytest.raises(ValueError):
        tm._rank_plan((3, 4, 5, 6), (2, 2, 2, 2), f32, 16,
                      route="network_tile")
    # forced routes; the select routes do not take 64 taps or fewer
    assert tm._rank_plan((40, 50), (3, 3), f32, 9, route="network") == net
    assert tm._rank_plan((40, 50), (3, 3), f32, 9,
                         route="network_tile").route == "network_tile"
    for route in ("tile", "nd", "rows"):
        with pytest.raises(ValueError):
            tm._rank_plan((40, 50), (3, 3), f32, 9, route=route)
    # above 64 taps the select routes, as before
    assert tm._rank_plan((40, 50), (9, 9), f32, 81).route == "tile"


def test_cpu_tensors_count_no_route():
    x = torch.as_tensor(np.random.RandomState(4).standard_normal((6, 7, 8)))
    fn = tm.rank_filter
    before, routes = fn.launches, dict(fn.routes)
    fn(x, np.ones((3, 3, 3), bool), [1, 1, 1], "reflect", 0.0, 13)
    assert fn.launches == before and fn.routes == routes
    assert set(routes) == {"network_tile", "network", "tile", "nd"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_both_network_routes_match_plain(cuda_device, dtype, mode):
    rs = np.random.RandomState(11)
    for name, fp in sorted(FOOTPRINTS.items()):
        x = _volume(rs, (6, 9, 35), np.dtype(dtype))
        xt = torch.as_tensor(x, device=cuda_device)
        k = int(fp.sum())
        centers = [s // 2 for s in fp.shape]
        cval = tm.raw_cval(3.0, xt.dtype)
        for rank in sorted({1, k // 2, k - 2}):
            want = tm.rank_filter_plain(xt, fp, centers, mode, cval,
                                        rank).cpu().numpy()
            for route in ("network_tile", "network"):
                plan = tm._rank_plan(x.shape, fp.shape, xt.dtype, k,
                                     route=route)
                got = tm._launch_rank(xt, fp, centers, mode, cval, rank,
                                      plan)
                _same(got.cpu().numpy(), want)
