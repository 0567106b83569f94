"""K8T, the transposed 1-D correlation, on its two routes.

The card runs K8T (``correlate1d_transpose``) either on the tile route, a
block staging W whole lines of the cotangent in shared memory (K4's line
tile) with the taps and an edge table of fold lists, or on the lines route,
one thread per output in device memory; ``ops/filters.py``'s
``_line_plan`` picks the route from the shapes. On the CPU:

* a numpy model of the tile route (``csrc/filters.cu``
  ``correlate1d_transpose_tile_kernel``), block by block and thread by
  thread on the kernel's schedule: the tile's span, the staging into a
  junk-filled tile at the plan's strides (a packed run at the block's step
  with the launch's carry, column tiles row by row), each thread's segment
  of its line, four outputs a step from the register window on the plain run
  and the fold lists of the edge table elsewhere, in the lines route's
  order, and a packed tile's outputs gathered in a second tile, against
  ``correlate1d_transpose_plain`` bit for bit in float64 and against
  ``jax.vjp`` of the JAX package's ``correlate1d`` / ``gaussian_filter1d``
  to 1e-12, over the five modes, every axis, line lengths 1 to past the
  taps, every width and kernels longer than the line;
* the edge table: its plain run is the lines route's interior branch;
* the plan's route and width choices and its refusals.

The ``cuda`` test holds both routes against the twin and each other, and
skips without a card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import elasticdeform_tpu as ej
from elasticdeform_tpu_torch.ops import filters as tf
from elasticdeform_tpu_torch.ops import prefilter as pf

MODES = ("reflect", "constant", "nearest", "mirror", "wrap")
JUNK = 1.0e300
# the tile kernel's threads a block and outputs a window, from its source
_SRC = (pathlib.Path(tf.__file__).parents[1] / "csrc" /
        "filters.cu").read_text()
THREADS = int(re.search(r"#define ED_K8T_THREADS (\d+)", _SRC).group(1))
Q = int(re.search(r"#define ED_K8T_WINDOW (\d+)", _SRC).group(1))


def _output(x, base, s, j, n, w, c, e, eptr, epos):
    """``x_bar[j]`` of the line at ``x[base + k * s]``, as
    ``k8t_output``: the interior sum, or the parts of j's fold list from
    the edge table, in the kernel's order and branches."""
    L = len(w)
    top = j + c

    def interior():
        acc = x[base + top * s] * w[0]
        for k in range(1, L):
            acc = acc + x[base + (top - k) * s] * w[k]
        return acc
    if e.a <= j < e.b:
        return interior()
    row = j if j < e.a else e.a + (j - e.b)
    beg, end = int(eptr[row]), int(eptr[row + 1])
    if end - beg == 1 and top - (L - 1) >= 0 and top < n:
        return interior()
    acc = 0.0
    for ll in range(beg, end):
        pq = int(epos[ll]) + c
        part = 0.0
        for k in range(max(0, pq - (n - 1)), min(L - 1, pq) + 1):
            part = part + x[base + (pq - k) * s] * w[k]
        acc = part if ll == beg else acc + part
    return acc


def _packed_walk(run, dol, dr, start, elems, stride, step):
    """``packed_walk``: (element, shared offset) of a packed tile's run
    from ``start`` in steps of ``step`` = ``dol`` runs + ``dr``, the outer
    and offset in its run carried without divisions."""
    ol, r = divmod(start, run)
    for q in range(start, elems, step):
        yield q, ol * stride + r
        r += dr
        wrap = r >= run
        r -= run if wrap else 0
        ol += dol + wrap


def _window(x, base, s, top0, w):
    """``k8t_window``: Q interior outputs at ``top0 ..`` from a register
    window sliding down the line, each in ``k8t_interior``'s order."""
    v = [x[base + (top0 + q) * s] for q in range(Q)]
    acc = [vq * w[0] for vq in v]
    for k in range(1, len(w)):
        v = [x[base + (top0 - k) * s]] + v[:-1]
        acc = [a + vq * w[k] for a, vq in zip(acc, v)]
    return acc


def _tile_model(g, w, axis, mode, c, plan):
    """The tile route on ``g`` (float64 numpy), block by block and thread
    by thread, on the kernel's schedule: ``THREADS`` threads (w, r), R =
    THREADS / W a line; a packed run staged and gathered at a step of
    THREADS elements with the launch's ``dol`` / ``dr``, column tiles row
    by row at a step of R; thread (w, r) on segment r, ceil(n / R) long,
    of line w, Q outputs a step from the window on the plain run [a, b),
    one at a time elsewhere."""
    outer, n, inner = pf._lines(torch.as_tensor(g), axis)
    t = plan.tile
    W, R = t.width, THREADS // t.width
    e = tf._k8t_edges(n, len(w), c, mode)
    eptr, epos = e.table[:e.rows + 1], e.table[e.rows + 1:]
    w = [float(v) for v in w]
    flat = g.reshape(-1)
    out = np.full(flat.size, np.nan)
    cells = (t.lines // inner if t.packed else n) * t.stride
    run = n * inner
    dol, dr = divmod(THREADS, run)    # ed_correlate1d_transpose_tile's
    col_tiles = -(-inner // W)
    for b in range(t.blocks):
        tile = np.full(cells, JUNK)
        obuf = np.full(cells, JUNK)
        if t.packed:                  # tile_span
            per = t.lines // inner
            o0 = b * per
            outers = min(outer - o0, per)
            width, first = outers * inner, o0 * run
            for tid in range(THREADS):
                for q, sh in _packed_walk(run, dol, dr, tid, outers * run,
                                          t.stride, THREADS):
                    tile[sh] = flat[first + q]
        else:
            o = b // col_tiles
            c0 = (b - o * col_tiles) * W
            width, first = min(W, inner - c0), o * run + c0
            for tid in range(THREADS):
                lw, lr = tid % W, tid // W
                if lw < width:
                    for k in range(lr, n, R):
                        tile[k * t.stride + lw] = flat[first + lw
                                                       + k * inner]
        for tid in range(THREADS):
            lw, lr = tid % W, tid // W
            if lw >= width:
                continue
            if t.packed:
                ol, ri = divmod(lw, inner)
                base, s, ds = ol * t.stride + ri, inner, inner
                dst, d0 = ((obuf, base) if plan.gather else
                           (out, first + ol * run + ri))
            else:
                base, s, dst, d0, ds = lw, t.stride, out, first + lw, inner
            seg = -(-n // R)
            j = lr * seg
            j1 = min(j + seg, n)
            bb = min(j1, e.b)
            while j < j1:
                if j >= e.a and j + Q <= bb:
                    for q, v in enumerate(_window(tile, base, s, j + c, w)):
                        dst[d0 + (j + q) * ds] = v
                    j += Q
                else:
                    dst[d0 + j * ds] = _output(tile, base, s, j, n, w, c, e,
                                               eptr, epos)
                    j += 1
        if plan.gather:
            for tid in range(THREADS):
                for q, sh in _packed_walk(run, dol, dr, tid, outers * run,
                                          t.stride, THREADS):
                    out[first + q] = obuf[sh]
    return out.reshape(g.shape)


# (shape, axis): packed tiles (inner < W), column tiles (inner >= W) with a
# partial last tile, lines of 1, 2 and 9, a channel count of 3 and 5
CASES = (((37, 9), 1), ((3, 1, 5), 1), ((2, 20), 1), ((70, 4), 0),
         ((5, 9, 3), 1), ((2, 13, 40), 1), ((6, 2, 5), 1), ((3, 7), 0))
KERNELS = ((17, 8), (4, 0), (5, 4), (11, 2), (23, 11))


def _case(i, mode):
    rs = np.random.RandomState(100 + i)
    shape, axis = CASES[i % len(CASES)]
    L, c = KERNELS[i % len(KERNELS)]
    return rs.standard_normal(shape), rs.standard_normal(L), axis, c


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_tile_model_is_the_twin_and_the_jax_vjp(case, mode):
    g, w, axis, c = _case(case, mode)
    outer, n, inner = pf._lines(torch.as_tensor(g), axis)
    e = tf._k8t_edges(n, len(w), c, mode)
    for W in pf.TILE_WIDTHS:
        plan = tf._line_plan(outer, n, inner, torch.float64,
                                       len(w), len(e.table), width=W)
        assert plan.route == "tile" and plan.tile.width == W
        got = _tile_model(g, w, axis, mode, c, plan)
        twin = tf.correlate1d_transpose_plain(torch.as_tensor(g), w, axis,
                                              mode, c).numpy()
        np.testing.assert_array_equal(got, twin)
    _, vjp = jax.vjp(lambda a: ej.correlate1d(a, w, axis, mode=mode,
                                              origin=c - len(w) // 2),
                     jnp.zeros(g.shape))
    scale = float(np.abs(g).max() * np.abs(w).sum())
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("mode", MODES)
def test_gaussian_tile_model_is_the_jax_vjp(mode):
    """c11's filter, sigma 2 (17 taps), on a short field: the model of
    every axis against ``jax.vjp`` of ``gaussian_filter1d``."""
    g = np.random.RandomState(7).standard_normal((2, 19, 6, 35))
    w = tf.gaussian_weights(2.0, 0, 4.0, None)
    for axis in (1, 2, 3):
        outer, n, inner = pf._lines(torch.as_tensor(g), axis)
        e = tf._k8t_edges(n, len(w), len(w) // 2, mode)
        plan = tf._line_plan(outer, n, inner, torch.float64,
                                       len(w), len(e.table))
        got = _tile_model(g, w, axis, mode, len(w) // 2, plan)
        _, vjp = jax.vjp(lambda a: ej.gaussian_filter1d(a, 2.0, axis,
                                                        mode=mode),
                         jnp.zeros(g.shape))
        np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_edge_table_plain_run_is_the_interior_branch(mode):
    """Every position of ``[a, b)`` takes the lines route's interior
    branch (fold list ``[j]``, taps inside); the rows hold the other
    positions' fold lists, ``j`` first."""
    for n in (1, 2, 3, 9, 40, 224):
        for L in (1, 2, 5, 17, 41):
            for c in sorted({0, L // 2, L - 1}):
                e = tf._k8t_edges(n, L, c, mode)
                ptr, pos = tf.fold_lists(n, c, L - 1 - c, mode)
                assert 0 <= e.a <= e.b <= n and e.rows == n - (e.b - e.a)
                for j in range(e.a, e.b):
                    assert ptr[j + 1] - ptr[j] == 1
                    assert j + c - (L - 1) >= 0 and j + c < n
                eptr, epos = e.table[:e.rows + 1], e.table[e.rows + 1:]
                rows = list(range(e.a)) + list(range(e.b, n))
                assert len(epos) == e.npos
                for r, j in enumerate(rows):
                    assert list(epos[eptr[r]:eptr[r + 1]]) == \
                        list(pos[ptr[j]:ptr[j + 1]])
                if n >= L:
                    assert e.rows <= 2 * L


def test_plan_at_c11():
    f32 = torch.float32
    shape = (3, 160, 192, 224)
    for axis in (1, 2, 3):
        outer, n, inner = (int(np.prod(shape[:axis])), shape[axis],
                           int(np.prod(shape[axis + 1:])))
        e = tf._k8t_edges(n, 17, 8, "reflect")
        plan = tf._line_plan(outer, n, inner, f32, 17,
                                       len(e.table))
        assert plan.route == "tile"
        assert plan.gather == (axis == 3)
        assert plan.smem == plan.tile.smem * (2 if axis == 3 else 1) + \
            17 * 4 + 4 * len(e.table)
        assert plan.tile.packed == (axis == 3)
        waves = tf.line_waves(plan, 132)
        for W in pf.TILE_WIDTHS:
            other = tf._line_plan(outer, n, inner, f32, 17,
                                            len(e.table), width=W)
            assert tf.line_waves(other, 132) >= waves


def test_plan_routes_the_rest_to_lines():
    f32, f64 = torch.float32, torch.float64
    lines = tf.LinePlan("lines")
    cap = pf.tile_cap(f32)
    # a packed tile at the cap stores its outputs directly: two do not fit
    at_cap = tf._line_plan(4, cap, 1, f32, 5, 20)
    assert at_cap.route == "tile" and not at_cap.gather
    assert tf._line_plan(4, 200, 1, f32, 5, 20).gather
    assert tf._line_plan(4, cap + 1, 1, f32, 5, 20) == lines
    assert tf._line_plan(4, pf.tile_cap(f64) + 1, 1, f64, 5,
                                   20) == lines
    # 2^31 elements
    assert tf._line_plan(2 ** 21, 1024, 1, f32, 5, 20) == lines
    assert tf._line_plan(2 ** 21 - 1, 1024, 1, f32, 5,
                                   20).route == "tile"
    # a tile at the cap leaves no room for a long kernel's taps and table
    assert tf._line_plan(4, cap, 1, f32, 4001, 9000) == lines
    assert tf._line_plan(4, 9, 1, f32, 5, 20,
                                   route="lines") == lines
    with pytest.raises(ValueError):
        tf._line_plan(4, cap + 1, 1, f32, 5, 20, route="tile")
    with pytest.raises(ValueError):
        tf._line_plan(4, 9, 1, f32, 5, 20, route="rows")


def test_cpu_tensors_count_no_route():
    g = torch.as_tensor(np.random.RandomState(3).standard_normal((6, 7)))
    fn = tf.correlate1d_transpose
    before, routes = fn.launches, dict(fn.routes)
    fn(g, np.ones(3), 1, "reflect", 1)
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
    for case in range(len(CASES)):
        g, w, axis, c = _case(case, mode)
        gt = torch.as_tensor(g, dtype=dtype, device=cuda_device)
        want = tf.correlate1d_transpose_plain(gt, w, axis, mode, c)
        terms = tf.correlate1d_transpose_plain(gt.abs(), np.abs(w), axis,
                                               mode, c)
        rtol = 1e-5 if dtype == torch.float32 else 1e-10
        outer, n, inner = pf._lines(gt, axis)
        e = tf._k8t_edges(n, len(w), c, mode)
        lines = tf._launch_line_transpose(gt, w, axis, mode, c,
                                          tf.LinePlan("lines"))
        for W in pf.TILE_WIDTHS:
            plan = tf._line_plan(outer, n, inner, dtype, len(w),
                                           len(e.table), width=W)
            got = tf._launch_line_transpose(gt, w, axis, mode, c, plan)
            assert torch.equal(got, lines), plan
        err = (lines.double() - want.double()).abs()
        assert bool((err <= rtol * terms.double()).all())
