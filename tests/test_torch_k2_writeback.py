"""K2's writeback route: the integer writeback of ``deform``'s prefilter.

An integer input to ``deform`` / ``deform_grid`` at order 2-5 with the
prefilter on is filtered axis by axis with a truncating, wrapping cast
after each axis (``cast_int_c``). Truncation tells apart two summation
orders that agree to 1e-13, so the card and the CPU must sum in one order.
K2's writeback route (``csrc/prefilter.cu``, ``writeback_rows``) and its
plain version (``ops/prefilter.py::_row_sums``) both compute
``y[a] = sum_k M[a, k] x[k]`` over the row of ``filter_matrix(n, order)``
cast to the compute dtype, k ascending from 0: float64 a rounded multiply
then a rounded add, float32 one fused multiply-add per term. On the CPU:

* the twin against the JAX package's ``ops/deform.py::_prefilter_input``
  bit for bit in float64, uint8 and int16, orders 2-5, axes of 4-64 with
  column counts that are multiples of 8;
* the twin's float32 fused multiply-add (``_fma32``) against exact
  ``Fraction`` arithmetic, on random draws and on sums next to a float32
  midpoint, where a float64 sum rounded again to float32 goes wrong;
* a numpy model of the kernel's row sum (its operation order, the float32
  fused multiply-add rounded exactly) against the twin, bit for bit;
* where the JAX package's own XLA CPU dot is not that chain (reference
  note R10 in ``ROADMAP.md``): lines of 2 and 3 in float64 (a fused
  chain), and the remainder columns of a column count that is not a
  multiple of 8.

The route's product form (``writeback_product_kernel``) runs the same
chains in register tiles and, where the input is known to be finite (it
came from an integer array), skips the chunks of k where a band's rows of
the table are exactly zero. On the CPU:

* a model of the skipping sums (each band's chunk runs, in order) against
  the twin bit for bit, float32 ``filter_matrix`` and
  ``filter_matrix_bc`` tables at n from 80 to 1760, integer inputs up to
  int32's edges; on NaN or an infinity the skip would change the result,
  which is why a float input keeps every term;
* the chunk runs' host builder, the product form's plan, and which
  calls declare their input finite (the general resampler's integer
  inputs, unless a constant pad of a non-finite ``cval`` was added) and
  which do not (``spline_filter`` into an integer output).

The ``cuda`` tests hold the route's tile and lines forms and its product
form, skip on and off, to the twin bit for bit and skip without a card.
"""

import itertools
from fractions import Fraction

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from elasticdeform_tpu.ops import deform as jd
from elasticdeform_tpu.ops import prefilter as jp

from elasticdeform_tpu_torch.ops import prefilter as tp

INT_RANGES = {"uint8": (0, 256), "int16": (-3000, 3000)}


def _jax_filtered(x, dtype, order, compute="float64"):
    """The JAX package's forward prefilter of an integer input ``x`` (the
    last axis a channel axis), the integer writeback after each axis."""
    naxis = x.ndim - 1
    ispec = jd.InputSpec(shape=x.shape, dtype=dtype,
                         axis=tuple(range(naxis)), order=order, mode=0,
                         cval=0.0, out_shape=x.shape)
    spec = jd.DeformSpec(inputs=(ispec,), deform_shape=x.shape[:naxis],
                         out_spatial=x.shape[:naxis], offsets=(0,) * naxis,
                         prefilter=True, compute_dtype=compute,
                         has_affine=False)
    return np.asarray(jd._prefilter_input(jnp.asarray(x), ispec, spec,
                                          getattr(jnp, compute), True))


def _twin_filtered(x, dtype, order, compute=torch.float64):
    got = torch.as_tensor(x.astype(np.float64)).to(compute)
    for axis in range(x.ndim - 1):
        got = tp.spline_filter1d_plain(got, order, axis, np.dtype(dtype))
    return got.numpy()


# (spatial axes..., channels): every axis's column count (the product of
# the other axes) a multiple of 8
WRITEBACK_SHAPES = [(4, 8), (9, 8), (64, 16), (5, 9, 8), (33, 4, 8),
                    (8, 40, 3), (64, 24, 1), (9, 5, 4, 8)]


@pytest.mark.parametrize("dtype", ["uint8", "int16"])
@pytest.mark.parametrize("order", [2, 3, 4, 5])
@pytest.mark.parametrize("shape", WRITEBACK_SHAPES)
def test_twin_is_the_jax_prefilter_input(shape, order, dtype):
    lo, hi = INT_RANGES[dtype]
    rs = np.random.RandomState(sum(shape) + order)
    x = rs.randint(lo, hi, shape).astype(dtype)
    np.testing.assert_array_equal(_twin_filtered(x, dtype, order),
                                  _jax_filtered(x, dtype, order))


def _round32(v: Fraction) -> np.float32:
    """The float32 nearest to the exact ``v``, ties to even."""
    f = np.float32(float(v))
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    return min(cands, key=lambda t: (abs(Fraction(float(t)) - v),
                                     int(np.array(t).view(np.int32)) & 1))


def _fma_exact(a, b, c) -> np.float32:
    return _round32(Fraction(float(a)) * Fraction(float(b)) +
                    Fraction(float(c)))


def _near_midpoints(rs, count):
    """(a, b, c) whose exact a*b + c lies within 2^-29 of a half float32
    ulp of c, above or below: a*b = h (1 + d 2^-46) with 0 < |d| < 2^17,
    from mantissas A*B = 2^46 + d."""
    out = []
    while len(out) < count:
        B = (1 << 23) + int(rs.randint(1, 1 << 22))
        up = rs.rand() < 0.5
        A = -(-(1 << 46) // B) if up else (1 << 46) // B
        d = A * B - (1 << 46)
        if d == 0 or abs(d) >= 1 << 17 or A >= 1 << 24:
            continue
        e = int(rs.randint(-20, 20))
        c = np.float32(np.ldexp(1.0 + rs.randint(1, 1 << 23) * 2.0 ** -23,
                                e))
        # a*b = 2^(e-24) * A*B / 2^46: half an ulp of c, times (1 + d/2^46)
        a = np.float32(np.ldexp(A, e - 24 - 23))
        b = np.float32(np.ldexp(B, -23))
        sign = np.float32(-1.0 if rs.rand() < 0.5 else 1.0)
        out.append((sign * a, b, sign * c))
    return out


def test_fma32_is_the_exactly_rounded_fused_multiply_add():
    rs = np.random.RandomState(0)
    draws = []
    # random magnitudes, as the row sums meet them
    for _ in range(3000):
        a, b, c = (np.float32(rs.standard_normal() * 10.0 **
                              rs.randint(-8, 5)) for _ in range(3))
        draws.append((a, b, c))
    near = _near_midpoints(rs, 1000)
    draws += near
    a, b, c = (torch.tensor(np.array(v, dtype=np.float32))
               for v in zip(*draws))
    got = tp._fma32(a, b, c).numpy()
    want = np.array([_fma_exact(*t) for t in draws], dtype=np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the near-midpoint draws are where a float64 sum rounded again to
    # float32 goes wrong
    a, b, c = (np.array(v, dtype=np.float32) for v in zip(*near))
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice != want[-len(near):]).sum() > 100


def _kernel_model(x, mat, int_dtype):
    """numpy model of ``writeback_rows`` in ``csrc/prefilter.cu`` on one
    line: for each row a, acc = 0, then k ascending ``acc = acc + m*x``
    (float64, each rounded) or ``acc = fmaf(m, x, acc)`` (float32, rounded
    once, exactly); then ``cast_int_c``."""
    n = len(x)
    bits, lo = tp._int_writeback(int_dtype)
    t = x.dtype.type
    span, lo = t(2.0 ** bits), t(lo)
    y = np.empty(n, dtype=x.dtype)
    for a in range(n):
        acc = t(0)
        for k in range(n):
            if x.dtype == np.float32:
                acc = _fma_exact(mat[a, k], x[k], acc)
            else:
                acc = acc + mat[a, k] * x[k]
        tr = np.trunc(acc)
        y[a] = tr - np.floor((tr - lo) / span) * span
    return y


@pytest.mark.parametrize("int_dtype", ["uint8", "int16"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 9])
def test_kernel_model_is_the_twin(n, dtype, int_dtype):
    lo, hi = INT_RANGES[int_dtype]
    rs = np.random.RandomState(n)
    lines = rs.randint(lo, hi, (6, n)).astype(dtype)
    for order in (2, 3, 4, 5):
        mat = tp.filter_matrix(n, order).astype(dtype)
        got = np.stack([_kernel_model(ln, mat, np.dtype(int_dtype))
                        for ln in lines])
        want = tp.spline_filter1d_plain(torch.as_tensor(lines), order, 1,
                                        np.dtype(int_dtype)).contiguous()
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.numpy().view(np.uint8))


def _row_sums_np(x, order):
    return tp._row_sums(torch.as_tensor(x), torch.as_tensor(
        tp.filter_matrix(x.shape[0], order), dtype=torch.float64), 0).numpy()


def test_r10_jax_fuses_its_chain_on_lines_of_2_and_3():
    """R10: on lines of 2 and 3, XLA's CPU dot in float64 is a chain of
    fused multiply-adds, not the rounded multiply and add of longer lines,
    so the twin departs from it before the truncation."""
    rs = np.random.RandomState(10)
    for n in (2, 3):
        x = rs.randint(0, 256, (n, 64)).astype(np.float64)
        mat = jp.filter_matrix(n, 3)
        jax_y = np.asarray(jp._apply_matrix(jnp.asarray(x), mat, 0))
        fused = np.array([[float(_fused64(mat[a], x[:, c]))
                           for c in range(64)] for a in range(n)])
        np.testing.assert_array_equal(jax_y, fused)
        assert (_row_sums_np(x, 3) != jax_y).sum() > 0


def _fused64(row, col):
    """A float64 fused multiply-add chain, k ascending, rounded exactly."""
    acc = 0.0
    for m, v in zip(row, col):
        acc = _round64(Fraction(m) * Fraction(v) + Fraction(acc))
    return acc


def _round64(v: Fraction) -> float:
    # Fraction.__float__ rounds once, to nearest, ties to even
    return float(v)


def test_r10_jax_departs_on_remainder_columns():
    """R10: with 99 columns the JAX package's float64 dot is the twin's
    chain on columns 0-95 and another order on the remainder columns
    96-98."""
    rs = np.random.RandomState(11)
    x = rs.randint(0, 256, (64, 99)).astype(np.float64)
    mat = jp.filter_matrix(64, 3)
    jax_y = np.asarray(jp._apply_matrix(jnp.asarray(x), mat, 0))
    differ = _row_sums_np(x, 3) != jax_y
    assert not differ[:, :96].any()
    assert differ[:, 96:].sum() > 0


def test_twin_routes_only_integer_inputs_to_row_sums():
    """Without ``int_dtype`` the twin is the ``tensordot`` it was; with it,
    the row sums and the cast."""
    rs = np.random.RandomState(12)
    x = torch.as_tensor(rs.randint(0, 256, (9, 16)).astype(np.float64))
    mat = torch.as_tensor(tp.filter_matrix(9, 3))
    np.testing.assert_array_equal(
        tp.spline_filter1d_plain(x, 3, 0).numpy(),
        torch.tensordot(mat, x, dims=([1], [0])).numpy())
    np.testing.assert_array_equal(
        tp.spline_filter1d_plain(x, 3, 0, np.uint8).numpy(),
        tp.cast_int_c(tp._row_sums(x, mat, 0), np.uint8).numpy())


def _row_run(n, groups, g):
    """``row_run`` in ``csrc/prefilter.cu``: group g's rows [a0, a1)."""
    run = (-(-n // groups) + 3) // 4 * 4
    a0 = min(g * run, n)
    return a0, min(a0 + run, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_groups_cover_every_row_once(dtype):
    """The writeback route's row groups at c2's, a 128^3 volume's and the
    sweep's views, on 132 SMs and on one: each row of a line in exactly one
    group's run, runs a multiple of 4 rows but the last."""
    shapes = [(1, 200, 300), (300, 200, 1), (1, 128, 16384),
              (16384, 128, 1), (5, 9, 1), (2, 24, 40), (131, 2, 1),
              (2, tp.tile_cap(dtype) + 1, 1), (3, 33, 5)]
    for (outer, n, inner), sms in itertools.product(shapes, (1, 132)):
        plan = tp._tile_plan(outer, n, inner, dtype, sms=sms)
        groups = tp._row_groups(plan, n, outer * inner, sms)
        assert 1 <= groups <= max(1, -(-n // 4))
        rows = [a for g in range(groups)
                for a in range(*_row_run(n, groups, g))]
        assert rows == list(range(n))
        for g in range(groups):
            a0, a1 = _row_run(n, groups, g)
            assert (a1 - a0) % 4 == 0 or a1 == n


def test_cpu_tensors_count_no_writeback():
    x = torch.as_tensor(np.random.RandomState(3).randint(0, 256, (4, 9, 3)),
                        dtype=torch.float64)
    before, routes = tp.spline_filter1d.launches, dict(
        tp.spline_filter1d.routes)
    tp.spline_filter1d(x, 3, 1, np.uint8)
    assert tp.spline_filter1d.launches == before
    assert tp.spline_filter1d.routes == routes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("int_dtype", [np.uint8, np.int16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_writeback_route_is_the_twin(cuda_device, dtype, int_dtype):
    rs = np.random.RandomState(13)
    lo, hi = INT_RANGES[np.dtype(int_dtype).name]
    cap = tp.tile_cap(dtype)
    for (outer, n, inner), order in zip(
            [(131, 2, 1), (23, 3, 3), (5, 9, 33), (3, 64, 100), (2, cap, 1),
             (2, cap + 1, 1)], (2, 3, 4, 5, 3, 5)):
        x = torch.as_tensor(rs.randint(lo, hi, (outer, n, inner)),
                            dtype=dtype, device=cuda_device)
        want = tp.spline_filter1d_plain(x, order, 1, int_dtype)
        plans = [tp._tile_plan(outer, n, inner, dtype, route="lines")]
        for width in tp.TILE_WIDTHS:
            try:
                plans.append(tp._tile_plan(outer, n, inner, dtype,
                                           width=width, route="tile"))
            except ValueError:
                continue
        for plan in plans:
            assert torch.equal(tp._launch_filter(x, order, 1, plan,
                                                 int_dtype), want)


def _skipping_sums(x, mat, runs, chunk):
    """The product form's sums with the chunk skip, modelled: row a of band
    b takes k of the chunks of its runs ``[x, y)`` and ``[z, w)`` only, in
    order, as the chain of :func:`tp._row_sums` (float32 ``_fma32``,
    float64 a rounded multiply, then a rounded add); ``x`` is
    ``(n, lines)``; ``runs`` None takes every chunk."""
    n = mat.shape[0]
    rows = torch.arange(n) // tp.WB_ROWS
    live = torch.ones(-(-n // tp.WB_ROWS), -(-n // chunk), dtype=torch.bool)
    if runs is not None:
        live[:] = False
        for b, (a0, a1, b0, b1) in enumerate(runs):
            live[b, a0:a1] = live[b, b0:b1] = True
    y = torch.zeros_like(x)
    for k in range(n):
        on = live[rows, k // chunk][:, None]
        col = mat[:, k][:, None]
        step = (tp._fma32(col, x[k], y) if x.dtype == torch.float32
                else y + col * x[k])
        y = torch.where(on, step, y)
    return y


@pytest.mark.parametrize("bc", ["mirror", "reflect", "wrap"])
@pytest.mark.parametrize("n", [80, 128, 200, 300, 512, 1760])
def test_chunk_skip_is_the_twin_on_integer_inputs(n, bc):
    """float32 tables are exactly zero far from the diagonal (and their
    mirror and wrap images); skipping the chunks a band sees only as zeros
    leaves every sum of integer inputs, up to int32's edges, bit for bit
    as the twin's."""
    rs = np.random.RandomState(n)
    mat = tp._filter_table(n, 3, torch.float32, torch.device("cpu"), bc)
    runs = tp.writeback_chunk_runs(mat.numpy(), tp.WB_CHUNK[torch.float32])
    a = rs.randint(-2 ** 31, 2 ** 31, (n, 3), dtype=np.int64)
    a[:2, 0] = (-2 ** 31, 2 ** 31 - 1)
    x = torch.as_tensor(a, dtype=torch.float32)
    want = tp._row_sums(x, mat, 0)
    got = _skipping_sums(x, mat, runs, tp.WB_CHUNK[torch.float32])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # from there on some band skips a chunk (wrap's corners reach every
    # chunk of a band below 300); below, no runs: every chunk
    assert (runs is None) == (n < (300 if bc == "wrap" else 200))


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_a_non_finite_input_keeps_every_term(value):
    """0 * NaN and 0 * inf are NaN: with one non-finite sample the twin
    puts NaN on every row whose table entry there is zero, which the skip
    would leave out; so a float input never takes the skip."""
    n = 300
    mat = tp._filter_table(n, 3, torch.float32, torch.device("cpu"),
                           "mirror")
    runs = tp.writeback_chunk_runs(mat.numpy(), tp.WB_CHUNK[torch.float32])
    x = torch.zeros(n, 1, dtype=torch.float32)
    x[n - 1, 0] = value
    want = tp._row_sums(x, mat, 0)
    got = _skipping_sums(x, mat, runs, tp.WB_CHUNK[torch.float32])
    zero = mat[:, n - 1] == 0
    assert torch.isnan(want[zero]).all()
    assert torch.isnan(got).sum() < torch.isnan(want).sum()
    assert not torch.isnan(got[:tp.WB_ROWS]).any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunk_runs_cover_the_nonzero_chunks(dtype):
    """Per band of WB_ROWS rows, two ascending runs of chunks that hold
    exactly the chunks with a nonzero entry; None where nothing is skipped
    (float64 filter tables have no zero) or a band needs three runs."""
    rs = np.random.RandomState(4)
    chunk = 16
    for n in (1, 5, 64, 65, 150, 300):
        for _ in range(4):
            m = np.zeros((n, n))
            for b in range(-(-n // tp.WB_ROWS)):
                for lo, hi in sorted(rs.randint(0, n + 1, (2, 2)).tolist()):
                    m[b * tp.WB_ROWS, lo:hi] = 1.0
            runs = tp.writeback_chunk_runs(m.astype(dtype), chunk)
            live = [[bool(np.any(m[b * tp.WB_ROWS:(b + 1) * tp.WB_ROWS,
                                   c * chunk:(c + 1) * chunk]))
                     for c in range(-(-n // chunk))]
                    for b in range(-(-n // tp.WB_ROWS))]
            if all(all(band) for band in live):
                assert runs is None
                continue
            if runs is None:    # some band takes three runs
                assert any(sum(1 for c in range(len(band)) if band[c] and
                               (c == 0 or not band[c - 1])) > 2
                           for band in live)
                continue
            assert runs.shape == (len(live), 4) and runs.dtype == np.int32
            for (x0, x1, z0, z1), band in zip(runs, live):
                assert 0 <= x0 <= x1 <= z0 <= z1 <= len(band)
                got = [x0 <= c < x1 or z0 <= c < z1 for c in range(len(band))]
                assert got == band
    for bc in ("mirror", "reflect", "wrap"):
        runs = tp.writeback_chunk_runs(
            tp.filter_matrix_bc(300, 3, bc).astype(dtype), chunk)
        assert (runs is None) == (dtype == np.float64)


def test_writeback_plan():
    """The product form's blocks: line tiles of WB_LINES lines (packed
    outers below that) times bands of WB_ROWS rows; a tile whose span
    leaves int32 goes to the rows route; either way ``rows`` holds the
    rows route's plan of the view."""
    f32 = torch.float32
    p = tp._writeback_plan(1, 200, 300, torch.float64)
    assert (p.route, p.packed, p.tiles, p.bands, p.blocks) == \
        ("product", False, 5, 4, 20)
    p = tp._writeback_plan(200, 300, 1, torch.float64)
    assert (p.route, p.packed, p.tiles, p.bands) == ("product", True, 4, 5)
    p = tp._writeback_plan(128, 128, 128, f32)
    assert (p.packed, p.tiles, p.bands, p.blocks) == (False, 256, 2, 512)
    p = tp._writeback_plan(7, 31, 3, f32)
    assert (p.packed, p.tiles, p.blocks) == (True, 1, 1)
    assert p.rows == tp._tile_plan(7, 31, 3, f32)
    wide = tp._writeback_plan(1, 2, 2 ** 27, f32)
    assert wide.route == "rows" and wide.rows.route == "tile"
    assert wide.rows == tp._tile_plan(1, 2, 2 ** 27, f32)
    assert tp._writeback_plan(1, 200, 300, f32).rows == \
        tp._tile_plan(1, 200, 300, f32)


def _spy(monkeypatch):
    from elasticdeform_tpu_torch.ops import deform as td
    seen = []
    for name in ("spline_filter1d", "spline_filter1d_bc"):
        real = getattr(td, name)

        def spy(*args, _real=real, finite=False, **kw):
            seen.append(finite)
            return _real(*args, **kw)
        monkeypatch.setattr(td, name, spy)
    return seen


@pytest.mark.parametrize("mode", ["mirror", "constant", "reflect",
                                  "grid-wrap", "grid-constant", "nearest"])
def test_integer_resampler_inputs_declare_finite(mode, monkeypatch):
    """The general resampler's integer inputs filter with ``finite`` on
    (the skip), float inputs with it off, in the legacy modes and the
    modern ones; a constant pad of a NaN or infinite ``cval`` (the modern
    ``grid-constant``) turns it off."""
    import elasticdeform_tpu_torch as et
    seen = _spy(monkeypatch)
    rs = np.random.RandomState(2)
    xi = rs.randint(0, 200, (9, 11)).astype(np.int16)
    et.zoom(xi, 1.3, order=3, mode=mode, device="cpu")
    assert seen and all(seen)
    seen.clear()
    et.zoom(xi.astype(np.float32), 1.3, order=3, mode=mode, device="cpu")
    assert seen and not any(seen)
    for cval, finite in ((np.nan, False), (np.inf, False), (7.0, True)):
        seen.clear()
        et.shift(xi, 0.5, order=3, mode=mode, cval=cval, device="cpu")
        assert seen and all(f is (finite or mode != "grid-constant")
                            for f in seen)


def test_spline_filter_into_an_integer_output_keeps_every_term(monkeypatch):
    """``spline_filter`` of a float input into an integer ``output=``
    array sums in the fixed order with every term: its input may hold NaN
    or an infinity."""
    import elasticdeform_tpu_torch as et
    seen = _spy(monkeypatch)
    x = np.random.RandomState(3).rand(9, 10).astype(np.float32) * 100
    x[2, 3] = np.nan
    out = np.zeros((9, 10), np.int16)
    et.spline_filter(x, order=3, output=out, device="cpu")
    assert seen and not any(seen)
