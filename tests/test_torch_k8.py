"""K8, the 1-D correlation, on its two routes.

The card runs K8 either on the tile route (``csrc/filters.cu``
``correlate1d_tile_kernel``: a block stages W whole lines in shared memory
on K8T's line tile, then computes each line's outputs from there, Q at a
time from register windows on the line's plain run and one at a time near
its ends, reading the pads' folded samples from a small table) or on the
lines route, the old kernels; ``ops/filters.py``'s ``_line_plan``, shared
with K8T, picks the route and the width. On the CPU:

* the shared plan at c11's, c12's and c13's shapes and its refusals;
* the pad table (``_k8_edges``): the plain run is the lines route's
  interior branch, the table the folds of the padded line's pads;
* a numpy model of the tile route's walk, line by line and thread by
  thread (R = threads / W a line, segments of ceil(n / R), the window and
  the edge handling in both orders), against ``correlate1d_plain`` bit for
  bit (float64 and float32), the JAX package's ``correlate1d`` (its banded
  ``apply_matrix1d``) to ``rtol=1e-12``, and its ``apply_paired1d`` bit for
  bit after the integer outputs' truncation (to ``1e-12`` before it).

The ``cuda`` test holds both routes against the twin, and skips without a
card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej
from elasticdeform_tpu.ops import filters as jf
from elasticdeform_tpu_torch.ops import filters as tf
from elasticdeform_tpu_torch.ops import prefilter as pf

MODES = ("reflect", "constant", "nearest", "mirror", "wrap")
_SRC = (pathlib.Path(tf.__file__).parents[1] / "csrc" /
        "filters.cu").read_text()
THREADS = int(re.search(r"#define ED_K8T_THREADS (\d+)", _SRC).group(1))
Q = int(re.search(r"#define ED_K8_WINDOW (\d+)", _SRC).group(1))


def _lines(x, axis):
    n = x.shape[axis]
    return np.moveaxis(x, axis, -1).reshape(-1, n)


def _unlines(y, x, axis):
    shape = np.moveaxis(x, axis, -1).shape
    return np.moveaxis(y.reshape(shape), -1, axis)


def _tap_sum(w, L, pair, v):
    """``tap_sum``: the direct order or SciPy's paired order."""
    if pair == 0:
        acc = v(0) * w[0]
        for k in range(1, L):
            acc = acc + v(k) * w[k]
        return acc
    s1 = L // 2
    acc = v(s1) * w[s1]
    for ii in range(s1, 0, -1):
        t = v(s1 - ii) + v(s1 + ii) if pair > 0 else v(s1 - ii) - v(s1 + ii)
        acc = acc + t * w[s1 - ii]
    return acc


def _window(x, j0, w, L, pair):
    """``k8_window``: Q outputs whose first taps read samples j0 .. j0 +
    Q - 1, from register windows (the direct order's one new sample a tap,
    the paired order's left and right windows)."""
    if pair == 0:
        v = [x[:, j0 + q] for q in range(Q)]
        acc = [v[q] * w[0] for q in range(Q)]
        for k in range(1, L):
            v = v[1:] + [x[:, j0 + Q - 1 + k]]
            acc = [acc[q] + v[q] * w[k] for q in range(Q)]
        return acc
    s1 = L // 2
    acc = [x[:, j0 + s1 + q] * w[s1] for q in range(Q)]
    lft = [x[:, j0 + q] for q in range(Q)]
    rgt = [x[:, j0 + 2 * s1 + q] for q in range(Q)]
    for k in range(s1):
        acc = [acc[q] + ((lft[q] + rgt[q]) if pair > 0 else
                         (lft[q] - rgt[q])) * w[k] for q in range(Q)]
        if k + 1 < s1:
            lft = lft[1:] + [x[:, j0 + Q + k]]
            rgt = [x[:, j0 + 2 * s1 - k - 1]] + rgt[:-1]
    return acc


def _tile_model(x, w, axis, mode, cval, c, pair, width):
    """The tile route's walk on every line of ``x`` (numpy, its dtype;
    ``w`` in it): thread r of a line takes segment r, ceil(n / R) long, R =
    THREADS / width; on the plain run [a, b) Q outputs a step from the
    windows, elsewhere one at a time, near the ends each tap's sample
    through the pad table (-1: cval)."""
    with np.errstate(invalid="ignore", over="ignore"):
        return _walk(x, w, axis, mode, cval, c, pair, width)


def _walk(x, w, axis, mode, cval, c, pair, width):
    lines = _lines(x, axis)
    n, L = lines.shape[1], len(w)
    e = tf._k8_edges(n, L, c, mode)
    cv = x.dtype.type(cval)
    R = THREADS // width
    seg = -(-n // R)
    out = np.full(lines.shape, np.nan, x.dtype)

    def sample(f):
        return np.full(len(lines), cv) if f < 0 else lines[:, f]

    for r in range(R):
        j, j1 = r * seg, min(r * seg + seg, n)
        b1 = min(j1, e.b)
        while j < j1:
            if j >= e.a and j + Q <= b1:
                for q, v in enumerate(_window(lines, j - c, w, L, pair)):
                    out[:, j + q] = v
                j += Q
                continue
            if e.a <= j < e.b:
                out[:, j] = _tap_sum(w, L, pair,
                                     lambda k: lines[:, j - c + k])
            else:
                def v(k, j=j):
                    i = j - c + k
                    f = e.table[i + c] if i < 0 else \
                        e.table[c + i - n] if i >= n else i
                    return sample(int(f))
                out[:, j] = _tap_sum(w, L, pair, v)
            j += 1
    return _unlines(out, x, axis)


CASES = (((5, 40, 3), 1), ((9, 64), 1), ((4, 300), 1), ((3, 7, 2), 1),
         ((2, 1, 9), 1), ((6, 9), 0), ((2, 17, 33), 1))
KERNELS = ((17, 8, 0), (9, 4, 1), (9, 4, -1), (4, 0, 0), (5, 4, 0),
           (1, 0, 0), (41, 20, 0), (3, 1, -1))


def _taps(rs, L, pair):
    w = rs.standard_normal(L)
    if pair > 0:
        w = w + w[::-1]
    elif pair < 0:
        w = w - w[::-1]
    return w


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_tile_model_is_the_twin(case, mode):
    shape, axis = CASES[case]
    rs = np.random.RandomState(case)
    for (L, c, pair), dtype in zip(KERNELS, (np.float64, np.float32) * 4):
        x = rs.standard_normal(shape).astype(dtype) * 10
        w = _taps(rs, L, pair)
        for cval in (1.5, np.nan, np.inf):
            twin = tf.correlate1d_plain(torch.as_tensor(x), w, axis, mode,
                                        cval, c, pair).numpy()
            for W in pf.TILE_WIDTHS:
                got = _tile_model(x, w.astype(dtype), axis, mode, cval, c,
                                  pair, W)
                np.testing.assert_array_equal(got, twin)


@pytest.mark.parametrize("mode", MODES)
def test_tile_model_with_nonfinite_samples(mode):
    """Note R12: NaN and infinities reach only the outputs whose taps read
    them, on either order."""
    rs = np.random.RandomState(20)
    x = rs.standard_normal((6, 50)) * 5
    x[rs.rand(*x.shape) < 0.05] = np.nan
    x[rs.rand(*x.shape) < 0.05] = np.inf
    x[rs.rand(*x.shape) < 0.05] = -np.inf
    for L, c, pair in KERNELS:
        w = _taps(rs, L, pair)
        twin = tf.correlate1d_plain(torch.as_tensor(x), w, 1, mode, -np.inf,
                                    c, pair).numpy()
        got = _tile_model(x, w, 1, mode, -np.inf, c, pair, 64)
        np.testing.assert_array_equal(got, twin)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_tile_model_is_the_jax_package(case, mode):
    """The direct order against the JAX package's banded ``apply_matrix1d``
    (``correlate1d``), float64: ``rtol=1e-12``."""
    shape, axis = CASES[case]
    rs = np.random.RandomState(40 + case)
    x = rs.standard_normal(shape)
    for L, c, pair in KERNELS:
        if pair:
            continue
        w = rs.standard_normal(L)
        got = _tile_model(x, w, axis, mode, 0.7, c, 0, 64)
        want = np.asarray(ej.correlate1d(x, w, axis, mode=mode, cval=0.7,
                                         origin=c - L // 2))
        scale = float(np.abs(x).max() * np.abs(w).sum())
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sigma_order", [(1.0, 0), (1.0, 1), (1.5, 2)])
def test_paired_model_is_jax_apply_paired1d(sigma_order, mode):
    """SciPy's paired order (integer outputs, as c13 runs it): Gaussian
    taps on integer data, float64, against the JAX package's
    ``apply_paired1d`` to 1e-12 and bit for bit after truncation."""
    sigma, order = sigma_order
    rs = np.random.RandomState(int(sigma * 10) + order)
    x = rs.randint(-1024, 3072, (7, 40, 9)).astype(np.float64)
    w = tf.gaussian_weights(sigma, order, 4.0, None)
    pair = tf._scipy_pair_class(w)
    assert pair != 0
    c = len(w) // 2
    for axis in range(3):
        got = _tile_model(x, w, axis, mode, 7.0, c, pair, 32)
        want = np.asarray(jf.apply_paired1d(x, w, axis, mode, 7.0, c))
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
        np.testing.assert_array_equal(np.trunc(got), np.trunc(want))
        twin = tf.correlate1d_plain(torch.as_tensor(x), w, axis, mode, 7.0,
                                    c, pair).numpy()
        np.testing.assert_array_equal(got, twin)


@pytest.mark.parametrize("mode", MODES)
def test_pad_table(mode):
    """The plain run is the lines route's interior branch (every tap
    inside the line); the table holds the fold of each pad of the padded
    line ``[-c, n + L-1-c)``, -1 in constant mode."""
    for n in (1, 2, 3, 9, 40, 224):
        for L in (1, 2, 5, 17, 41):
            for c in sorted({0, L // 2, L - 1}):
                e = tf._k8_edges(n, L, c, mode)
                assert len(e.table) == L - 1 and e.table.dtype == np.int32
                if e.a < e.b:
                    assert (e.a, e.b) == (c, n - L + 1 + c)
                else:
                    assert (e.a, e.b) == (0, 0) and n - L + 1 <= 0
                pads = list(range(-c, 0)) + list(range(n, n + L - 1 - c))
                want = [-1 if mode == "constant" else
                        tf._fold_index(j, n, mode) for j in pads]
                assert list(e.table) == want


def _plan(shape, axis, dtype, L, c, mode, **kw):
    outer, n, inner = (int(np.prod(shape[:axis])), shape[axis],
                       int(np.prod(shape[axis + 1:])))
    e = tf._k8_edges(n, L, c, mode)
    return tf._line_plan(outer, n, inner, dtype, L, len(e.table),
                         sm_blocks=tf.k8_sm_blocks(dtype), **kw)


def test_plans_at_c11_c12_c13():
    """Every K8 launch of c11-c13 takes the tile route; a packed axis
    gathers its outputs; the width fills the fewest waves among those."""
    f32, f64 = torch.float32, torch.float64
    for shape, axes, dtype, L, c, mode in (
            ((3, 160, 192, 224), (1, 2, 3), f32, 17, 8, "reflect"),
            ((160, 192, 224), (0, 1, 2), f32, 13, 6, "nearest"),
            ((512, 512, 300), (0, 1, 2), f64, 9, 4, "mirror")):
        for axis in axes:
            plan = _plan(shape, axis, dtype, L, c, mode)
            assert plan.route == "tile"
            assert plan.tile.packed == (axis == len(shape) - 1)
            assert plan.gather == plan.tile.packed
            item = 4 if dtype == f32 else 8
            assert plan.smem == plan.tile.smem * (1 + plan.gather) + \
                L * item + 4 * (L - 1)
            waves = tf.line_waves(plan, 132)
            for W in pf.TILE_WIDTHS:
                other = _plan(shape, axis, dtype, L, c, mode, width=W)
                if other.route == "tile" and other.gather == plan.gather:
                    assert tf.line_waves(other, 132) >= waves
    # c11's packed axis: two blocks an SM at W = 64, as K8T's
    plan = _plan((3, 160, 192, 224), 3, f32, 17, 8, "reflect")
    assert plan.tile.width == 64 and tf.line_waves(plan, 132) == 6


@pytest.mark.parametrize("dtype,blocks", [(torch.float32, 4),
                                          (torch.float64, 3)])
def test_waves_count_the_kernels_blocks_an_sm(dtype, blocks):
    """K8's float64 tile kernel is launch-bounded to 3 blocks an SM (K8T's
    and K8's float32 to 4): where shared memory would take more, the plan's
    waves count the kernel's."""
    plan = _plan((16, 65536), 0, dtype, 9, 4, "reflect")
    assert plan.route == "tile" and plan.sm_blocks == blocks
    assert pf._SM_SMEM // (plan.smem + 1024) > blocks
    assert tf.line_waves(plan, 132) == -(-plan.tile.blocks // (132 * blocks))
    k8t = tf._line_plan(1, 16, 65536, dtype, 9, 16)
    assert k8t.sm_blocks == tf.LINE_BLOCKS == 4


def test_plan_refusals():
    f32, f64 = torch.float32, torch.float64
    lines = tf.LinePlan("lines")
    cap = pf.tile_cap(f32)
    assert _plan((4, cap + 1), 1, f32, 5, 2, "reflect") == lines
    assert _plan((4, pf.tile_cap(f64) + 1), 1, f64, 5, 2, "wrap") == lines
    assert _plan((2 ** 21, 1024), 1, f32, 5, 2, "mirror") == lines
    assert _plan((2 ** 21 - 1, 1024), 1, f32, 5, 2, "mirror").route == \
        "tile"
    # a long kernel's taps beside a tile at the cap do not fit
    assert _plan((4, cap), 1, f32, 8001, 4000, "nearest") == lines
    with pytest.raises(ValueError):
        _plan((4, cap + 1), 1, f32, 5, 2, "reflect", route="tile")
    with pytest.raises(ValueError):
        _plan((4, 9), 1, f32, 5, 2, "reflect", route="rows")
    assert _plan((4, 9), 1, f32, 5, 2, "reflect", route="lines") == lines


def test_cpu_tensors_count_no_route():
    x = torch.as_tensor(np.random.RandomState(3).standard_normal((6, 7)))
    fn = tf.correlate1d
    before, routes = fn.launches, dict(fn.routes)
    fn(x, np.ones(3), 1, "reflect", 0.0, 1)
    assert fn.launches == before and fn.routes == routes
    assert set(routes) == {"tile", "lines"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_both_routes_match_plain(cuda_device, dtype, mode):
    rs = np.random.RandomState(5)
    for (shape, axis), (L, c, pair) in zip(CASES * 2, KERNELS * 2):
        x = torch.as_tensor(rs.standard_normal(shape) * 10, dtype=dtype,
                            device=cuda_device)
        w = _taps(rs, L, pair)
        want = tf.correlate1d_plain(x, w, axis, mode, 1.5, c, pair)
        outer, n, inner = pf._lines(x, axis)
        for plan in (_plan(shape, axis, dtype, L, c, mode),
                     tf.LinePlan("lines")):
            got = tf._launch_line(x, w, axis, mode, 1.5, c, pair, plan)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
