"""K10, the 1-D min/max, on its two routes: the box route and the lines route.

A separable box (``minimum_filter`` / ``maximum_filter`` / grey erosion and
dilation with a ``size``, ``minimum_filter1d`` / ``maximum_filter1d``) is a
1-D pass per axis. On the card K10 runs either every pass of the box in one
launch on its box route (``min_max_box_kernel``: a block stages its output
tile's halo box once, each axis folded by its own mode, ``cval`` where a
constant axis leaves the array, then runs the passes in the caller's order
in shared memory, each shrinking the box to the tile along its axis), or a
launch a pass on its lines route (``min_max_1d_kernel``);
``ops/morphology.py``'s ``_box_plan`` picks the route and the tile. On the
CPU:

* a numpy model of the box route, block by block (block -> batch index and
  tile, the box staged with the per-axis folds or ``cval``, each pass's
  window in order, the passes in the caller's order for floats and with
  tile axis 2 first for integers and bool, ``acc = w[0]`` then the
  NaN-propagating min or max with -0 below +0), against the sequential
  plain passes
  (``min_max_box_plain``), the port's ``minimum_filter`` /
  ``maximum_filter`` / ``grey_opening`` on the CPU and the JAX package's,
  bit for bit (NaN where NaN, a zero's sign too): the eleven dtypes, the
  five modes and sequences of per-axis modes, origins, ``cval`` NaN, -0
  and +0, sizes 1-7 and one longer than its axis, boxes of one to three
  axes on 1-D to 4-D inputs;
* the plan: its tile at c16's shapes, the routes it picks and the cases it
  sends to the lines route; the row stride's bank rule;
* CPU tensors count no launch.

The ``cuda`` test holds both routes against the twin, and skips without a
card.
"""

import itertools

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej
import elasticdeform_tpu_torch as et

from elasticdeform_tpu_torch.ops import filters as tf
from elasticdeform_tpu_torch.ops import morphology as tm

DTYPES = ("bool", "uint8", "int8", "uint16", "int16", "uint32", "int32",
          "uint64", "int64", "float32", "float64")


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


def _box_model(x, passes, cval, minimum, plan):
    """The box route on ``x`` (numpy) for ``passes`` ``((axis, size,
    centre, mode), ...)``, block by block."""
    kshape = [1] * x.ndim
    for ax, size, _, _ in passes:
        kshape[ax] = size
    geo = tf.halo_tile(x.shape, tuple(kshape))
    k3, c3, m3, order = [1] * 3, [0] * 3, ["nearest"] * 3, []
    for ax, size, c, mode in passes:
        a = geo.tile_axes.index(geo.group[ax])
        k3[a], c3[a], m3[a] = size, c, mode
        order.append(a)
    if x.dtype.kind != "f":
        # integers and bool: the pass along tile axis 2 first (the order
        # does not change a min or max without NaN)
        order.sort(key=lambda a: a != 2)
    assert tuple(geo.box(plan.tile)) == tuple(plan.box)
    tile, box, n3, st3 = plan.tile, plan.box, geo.n3, geo.st3
    flat = x.reshape(-1)
    out = np.zeros_like(flat)
    fill = np.asarray(cval, x.dtype)
    blocks = 0
    for bi in itertools.product(*[range(geo.merged[d])
                                  for d in plan.grid_axes]):
        base = sum(i * geo.strides[d] for i, d in zip(bi, plan.grid_axes))
        for q in itertools.product(*[range(-(-n // t))
                                     for n, t in zip(n3, tile)]):
            blocks += 1
            s = [qq * t for qq, t in zip(q, tile)]
            f = [np.array([_fold(s[a] - c3[a] + b, n3[a], m3[a])
                           for b in range(box[a])]) for a in range(3)]
            inside = ((f[0] >= 0)[:, None, None] & (f[1] >= 0)[None, :, None]
                      & (f[2] >= 0)[None, None, :])
            addr = base + sum(np.maximum(f[a], 0).reshape(
                [-1 if b == a else 1 for b in range(3)]) * st3[a]
                for a in range(3))
            vals = np.where(inside, flat[addr], fill)
            for a in order:
                m = vals.shape[a] - k3[a] + 1
                acc = np.take(vals, range(m), axis=a)
                for t in range(1, k3[a]):
                    acc = _pick(acc, np.take(vals, range(t, t + m), axis=a),
                                minimum)
                vals = acc
            assert vals.shape == tuple(tile)
            j = [s[a] + np.arange(tile[a]) for a in range(3)]
            ok = ((j[0] < n3[0])[:, None, None] & (j[1] < n3[1])[None, :, None]
                  & (j[2] < n3[2])[None, None, :])
            oaddr = base + sum(j[a].reshape(
                [-1 if b == a else 1 for b in range(3)]) * st3[a]
                for a in range(3))
            out[oaddr[ok]] = vals[ok]
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
    a = rs.randint(info.min, int(info.max) + 1, size=shape,
                   dtype=np.int64 if dtype.itemsize < 8 else dtype)
    a = a.astype(dtype)
    a.reshape(-1)[:2] = (info.min, info.max)
    if rs.rand() < 0.5:     # a pool of a few values: ties
        a = rs.choice(a.reshape(-1)[:5], size=shape)
    return a


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


# (shape, axes, sizes, origins, modes): a box of one to three axes on 1-D
# to 4-D inputs, the passes in the axes' order (not always ascending), a
# size of 1 (no pass), a size longer than its axis
CASES = (((37,), (0,), (5,), (1,), ("reflect",)),
         ((13, 17), (0, 1), (3, 4), (0, -1), ("reflect", "constant")),
         ((9, 7, 40), (0, 1, 2), (5, 3, 2), (1, 0, 0),
          ("mirror", "wrap", "nearest")),
         ((6, 5, 33), (2, 0), (7, 2), (-2, 0), ("constant", "reflect")),
         ((3, 4, 5, 6), (1, 3), (3, 6), (0, 2), ("wrap", "constant")),
         ((4, 70), (1,), (6,), (-3,), ("mirror",)),
         ((20, 3), (0, 1), (25, 1), (3, 0), ("nearest", "constant")),
         ((2, 6, 9, 33), (1, 2, 3), (2, 3, 4), (0, -1, 1),
          ("constant", "constant", "mirror")),
         ((11, 12, 13), (2, 1, 0), (3, 5, 7), (1, -2, 0),
          ("reflect", "nearest", "constant")))


def _cval(dtype, i):
    if dtype.kind == "f":
        return (np.nan, -0.0, 0.0, 2.5, -np.inf)[i % 5]
    if dtype == np.bool_:
        return i % 2
    return 3 if dtype.kind == "u" else -5


def _passes(case):
    shape, axes, sizes, origins, modes = case
    return [(ax, s, s // 2 + o, m) for ax, s, o, m in
            zip(axes, sizes, origins, modes) if s > 1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_box_model_is_the_twin_and_the_jax_package(case, dtype):
    """Each case and dtype, minimum and maximum: the model of the box route
    equals the sequential twin, the port's CPU filter and the JAX
    package's, bit for bit."""
    rs = np.random.RandomState(11 * case + DTYPES.index(dtype))
    shape, axes, sizes, origins, modes = CASES[case]
    x = _data(dtype, shape, rs)
    cval = _cval(x.dtype, case + DTYPES.index(dtype))
    passes = _passes(CASES[case])
    kshape = [1] * x.ndim
    for ax, size, _, _ in passes:
        kshape[ax] = size
    plan = tm._box_plan(shape, tuple(kshape), torch.as_tensor(x[:0]).dtype)
    assert plan.route == "box"
    raw = tm.raw_cval(cval, torch.as_tensor(x[:0]).dtype)
    for minimum in (True, False):
        got = _box_model(x, passes, raw, minimum, plan)
        _equal(got, tm.min_max_box_plain(torch.as_tensor(x), passes, raw,
                                         minimum).numpy())
        fn = et.minimum_filter if minimum else et.maximum_filter
        kw = dict(size=sizes, mode=list(modes), cval=cval,
                  origin=list(origins), axes=list(axes))
        _equal(got, np.asarray(fn(x, device="cpu", **kw)))
        jfn = ej.minimum_filter if minimum else ej.maximum_filter
        _equal(got, np.asarray(jfn(x, **kw)))


@pytest.mark.parametrize("dtype", ["int16", "float32", "uint8", "float64"])
@pytest.mark.parametrize("mode", ["reflect", "constant", "nearest", "mirror",
                                  "wrap"])
def test_grey_opening_is_two_boxes(mode, dtype):
    """c16's opening, cut to size: an erosion box, then a dilation box,
    each the model of one launch, equal to the JAX package's
    ``grey_opening`` and the port's on the CPU."""
    rs = np.random.RandomState(5 + len(mode))
    x = _data(dtype, (9, 17, 40), rs)
    passes = [(a, 5, 2, mode) for a in range(3)]
    plan = tm._box_plan(x.shape, (5, 5, 5), torch.as_tensor(x[:0]).dtype)
    cval = 0.0 if x.dtype.kind == "f" else 0
    got = _box_model(_box_model(x, passes, cval, True, plan), passes, cval,
                     False, plan)
    _equal(got, np.asarray(et.grey_opening(x, size=5, mode=mode,
                                           device="cpu")))
    _equal(got, np.asarray(ej.grey_opening(x, size=5, mode=mode)))


@pytest.mark.parametrize("size", range(1, 8))
@pytest.mark.parametrize("dtype", ["float32", "int16", "uint64", "bool"])
def test_one_axis_sizes_1_to_7(size, dtype):
    """``minimum_filter1d`` / ``maximum_filter1d`` at sizes 1-7 along the
    middle axis of a 3-D input, every origin, one mode each: a size over 1
    is a one-pass box (the model), size 1 a copy."""
    rs = np.random.RandomState(size)
    x = _data(dtype, (3, 6, 9), rs)
    raw = 0 if x.dtype.kind != "f" else 0.0
    for origin in range(-(size // 2), (size - 1) // 2 + 1):
        mode = ("reflect", "constant", "nearest", "mirror", "wrap")[
            (size + origin) % 5]
        for minimum in (True, False):
            fn = et.minimum_filter1d if minimum else et.maximum_filter1d
            jfn = ej.minimum_filter1d if minimum else ej.maximum_filter1d
            want = np.asarray(jfn(x, size, 1, mode=mode, origin=origin))
            _equal(np.asarray(fn(x, size, 1, mode=mode, origin=origin,
                                 device="cpu")), want)
            if size > 1:
                passes = [(1, size, size // 2 + origin, mode)]
                plan = tm._box_plan(x.shape, (1, size, 1),
                                    torch.as_tensor(x[:0]).dtype)
                _equal(_box_model(x, passes, raw, minimum, plan), want)


def test_plan_at_c16():
    """c16's int16 5^3 box: a 16 x 16 x 32 tile of a 20 x 20 x 36 box, rows
    at 38 elements (19 words), two buffers in 60800 bytes, three blocks an
    SM; the same box in float64 takes a smaller tile."""
    plan = tm._box_plan((512, 512, 300), (5, 5, 5), torch.int16)
    assert plan == tm.BoxPlan("box", (0, 1, 2), (), (16, 16, 32),
                              (20, 20, 36), 38, 60800, 32 * 32 * 10)
    assert 3 * (plan.smem + 1024) <= 233472
    f64 = tm._box_plan((512, 512, 300), (5, 5, 5), torch.float64)
    assert f64.route == "box" and f64.smem <= tm.BOX_SMEM_AIM
    assert np.prod(f64.tile) < np.prod(plan.tile)


def test_plan_routes_and_refusals():
    i16, f64 = torch.int16, torch.float64
    # 1-D and 2-D: leading tile extents of 1
    plan = tm._box_plan((37,), (5,), i16)
    assert plan.tile_axes == (-1, -1, 0) and plan.tile[:2] == (1, 1)
    plan = tm._box_plan((40, 50), (5, 3), f64)
    assert plan.tile_axes == (-1, 0, 1) and plan.tile[0] == 1
    # batch axes: the innermost joins the tile, the others the grid
    plan = tm._box_plan((2, 6, 9, 33), (1, 2, 3, 4), torch.uint8)
    assert plan.tile_axes == (1, 2, 3) and plan.grid_axes == (0,)
    plan = tm._box_plan((3, 4, 5, 6), (1, 3, 1, 6), i16)
    assert plan.route == "box" and plan.grid_axes == (0,)
    lines = tm.BoxPlan("lines")
    # four box axes, a sample of 2^31 elements, a box no tile fits
    assert tm._box_plan((3, 4, 5, 6), (2, 2, 2, 2), i16) == lines
    assert tm._box_plan((2 ** 16, 2 ** 15 + 1), (3, 1), i16) == lines
    assert tm._box_plan((200, 200, 200), (60, 60, 60), f64) == lines


@pytest.mark.parametrize("shape, kshape, dtype, tile", [
    ((64, 128, 128, 96), (1, 1, 5, 1), torch.uint8, (16, 32, 32)),
    ((64, 128, 128, 160), (1, 1, 5, 1), torch.int16, (8, 32, 32)),
    ((512, 512, 300), (1, 1, 5), torch.int16, (1, 32, 64)),
    ((512, 512, 300), (1, 1, 3), torch.int16, (1, 32, 64)),
    ((2048, 2048), (1, 5), torch.uint8, (1, 32, 64)),
])
def test_plan_counts_the_last_tile_whole(shape, kshape, dtype, tile):
    """The plan counts a tile that hangs past the array's edge as staged
    whole: a contiguous axis of 96 or 160 takes tiles of 32, which cover
    it, and not 64; where every tile leaves a part (300), the wider one."""
    plan = tm._box_plan(shape, kshape, dtype)
    assert plan.route == "box" and plan.tile == tile


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_one_pass_at_c16_takes_the_box_route(axis, size):
    """``minimum_filter1d`` / ``maximum_filter1d`` along any axis of c16's
    int16 volume run on the box route: on the card it was faster than the
    lines route along each axis, the contiguous one too (``PERF.md``
    §6)."""
    kshape = [1, 1, 1]
    kshape[axis] = size
    plan = tm._box_plan((512, 512, 300), tuple(kshape), torch.int16)
    assert plan.route == "box"
    assert plan.smem <= tm.BOX_SMEM_AIM


@pytest.mark.parametrize("item", [1, 2, 4, 8])
def test_row_stride_starts_rows_on_other_banks(item):
    """A box row padded to an odd number of 32-bit words (8-byte types: an
    odd number of elements): 32 consecutive rows start on 32 distinct
    banks (16 for 8-byte types, each two banks wide)."""
    for length in range(1, 200):
        p2 = tm._box_row_stride(length, item)
        assert length <= p2 < length + 8
        if item <= 4:
            assert p2 * item % 4 == 0 and p2 * item // 4 % 2 == 1
            words = p2 * item // 4
            assert len({r * words % 32 for r in range(32)}) == 32
        else:
            assert p2 % 2 == 1


def test_box_calls_validate_and_cpu_counts_nothing():
    x = torch.as_tensor(np.random.RandomState(3).standard_normal((9, 12)))
    fn = tm.min_max_filter1d
    before, routes = fn.launches, dict(fn.routes)
    tm.min_max_box(x, [(0, 3, 1, "reflect"), (1, 2, 0, "wrap")], 0.0, True)
    fn(x, 3, 1, "reflect", 0.0, 1, False)
    assert fn.launches == before and fn.routes == routes
    assert set(routes) == {"box", "lines"}
    for bad in ([(0, 3, 1, "reflect"), (0, 2, 0, "wrap")],
                [(1, 1, 0, "reflect")]):
        with pytest.raises(ValueError):
            tm.min_max_box(x, bad, 0.0, True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_box_route_is_the_lines_route_and_the_twin(cuda_device, dtype):
    for case in CASES:
        rs = np.random.RandomState(len(case[0]))
        x = torch.as_tensor(_data(dtype, case[0], rs)).to(cuda_device)
        passes = _passes(case)
        for minimum in (True, False):
            got = tm.min_max_box(x, passes, 0, minimum)
            lines = tm._launch_box(x, passes, 0, minimum, tm.BoxPlan("lines"))
            want = tm.min_max_box_plain(x, passes, 0, minimum)
            _equal(got.cpu().numpy(), want.cpu().numpy())
            _equal(lines.cpu().numpy(), want.cpu().numpy())
