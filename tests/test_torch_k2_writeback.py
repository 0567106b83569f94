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

The ``cuda`` test holds the route's tile and lines forms to the twin bit
for bit and skips without a card.
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
