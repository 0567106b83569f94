"""elasticdeform_tpu_torch.ops against the JAX package's ops, on the CPU.

Each function of the port that has a JAX counterpart gets the same inputs
(made with numpy from a seed) and must agree: float64 to round-off
(``atol=1e-12``) or exactly, integer casts bit for bit. On CPU tensors the
kernel wrappers take their plain versions; the tests marked ``cuda`` hold
the kernels against those plain versions and run only where a card is.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from elasticdeform_tpu.ops import bspline as jb
from elasticdeform_tpu.ops import displacement as jd
from elasticdeform_tpu.ops import modes as jm
from elasticdeform_tpu.ops import prefilter as jp
from elasticdeform_tpu.ops import resample as jr

from elasticdeform_tpu_torch.ops import bspline as tb
from elasticdeform_tpu_torch.ops import displacement as td
from elasticdeform_tpu_torch.ops import modes as tm
from elasticdeform_tpu_torch.ops import prefilter as tp
from elasticdeform_tpu_torch.ops import resample as tr

MODES = ["nearest", "wrap", "reflect", "mirror", "constant"]


def _t(a):
    return torch.as_tensor(np.array(a))


def test_mode_to_code_matches():
    for m in MODES + [0, 1, 2, 3, 4]:
        assert tm.mode_to_code(m) == jm.mode_to_code(m)
    for bad in ["grid-wrap", 7, None]:
        with pytest.raises(RuntimeError, match="boundary mode not supported"):
            tm.mode_to_code(bad)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("length", [1, 2, 7, 30])
def test_map_coordinate_far_outside(mode, length):
    rs = np.random.RandomState(length)
    # coordinates far past both edges, plus the exact edges and half-steps
    cc = np.concatenate([rs.uniform(-9 * length - 5, 9 * length + 5, 400),
                         np.arange(-3 * length, 3 * length + 1) * 0.5,
                         [0.0, length - 1.0, -1.0, float(length)]])
    code = jm.mode_to_code(mode)
    jmapped, jinside = jm.map_coordinate(jnp.asarray(cc), length, code)
    tmapped, tinside = tm.map_coordinate(_t(cc), length, code)
    np.testing.assert_allclose(tmapped.numpy(), np.asarray(jmapped),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tinside.numpy(), np.asarray(jinside))


@pytest.mark.parametrize("length", [1, 2, 5, 11])
def test_mirror_index_np(length):
    idx = np.arange(-40, 41)
    np.testing.assert_array_equal(tm.mirror_index_np(idx, length),
                                  jm.mirror_index_np(idx, length))


@pytest.mark.parametrize("order", range(6))
def test_filter_start_and_weights(order):
    rs = np.random.RandomState(order)
    cc = np.concatenate([rs.uniform(-3, 40, 300), np.arange(-4, 12) * 0.5])
    np.testing.assert_array_equal(
        tb.filter_start(_t(cc), order).numpy(),
        np.asarray(jb.filter_start(jnp.asarray(cc), order)))
    tw = tb.spline_weights(_t(cc), order)
    jw = jb.spline_weights(jnp.asarray(cc), order)
    assert len(tw) == len(jw) == order + 1
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-15)
    # the numpy form (host matrices) is the JAX package's numpy form
    for a, b in zip(tb.spline_weights(cc, order),
                    jb.spline_weights(cc, order, xp=np)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("order", range(6))
def test_poles_and_filter_matrix(order):
    assert tp.spline_poles(order) == jp.spline_poles(order)
    for n in (1, 2, 9, 64):
        np.testing.assert_array_equal(tp.filter_matrix(n, order),
                                      jp.filter_matrix(n, order))


@pytest.mark.parametrize("odim,ncp,idim,offset", [
    (20, 3, 20, 0), (12, 4, 30, 7), (5, 6, 9, 4), (33, 2, 40, 0)])
@pytest.mark.parametrize("prefilter_grid", [False, True])
def test_displacement_matrix(odim, ncp, idim, offset, prefilter_grid):
    np.testing.assert_array_equal(
        td.displacement_matrix(odim, ncp, idim, offset, prefilter_grid),
        jd.displacement_matrix(odim, ncp, idim, offset, prefilter_grid))


def test_dense_displacement_batched():
    rs = np.random.RandomState(3)
    grids = rs.randn(2, 2, 3, 4) * 5
    got = td.dense_displacement(_t(grids), (10, 12), (16, 20), (3, 5))
    for b in range(2):
        want = jd.dense_displacement(jnp.asarray(grids[b]), (10, 12),
                                     (16, 20), (3, 5), jnp.float64,
                                     prefilter_grid=True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("order", [2, 3, 4, 5])
@pytest.mark.parametrize("n", [9, 200])
def test_spline_filter1d_plain(order, n):
    # n=9 takes the full mirror-sum initialisation, n=200 the truncated one
    rs = np.random.RandomState(n + order)
    x = rs.rand(4, n, 3) * 100 - 20
    want = np.asarray(jp.spline_filter1d(jnp.asarray(x), order, 1))
    got = tp.spline_filter1d(_t(x), order, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    # the reference recursion agrees with the matrix too
    np.testing.assert_allclose(
        np.moveaxis(tp._filter_lines(np.moveaxis(x, 1, 0), order), 0, 1),
        want, rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("int_dtype", [np.uint8, np.int16, np.bool_])
def test_spline_filter1d_integer_writeback(int_dtype):
    rs = np.random.RandomState(2)
    x = rs.randint(-300, 300, (6, 11, 2)).astype(np.float64)
    got = tp.spline_filter1d(_t(x), 3, 1, int_dtype)
    want = jr.cast_int_c(jp.spline_filter1d(jnp.asarray(x), 3, 1), int_dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("order", range(6))
@pytest.mark.parametrize("mode", ["mirror", "reflect", "constant"])
def test_resample_linear_plain(order, mode):
    rs = np.random.RandomState(order)
    x = rs.rand(7, 9, 2)
    cc = [rs.uniform(-20, 30, (5, 6)) for _ in range(2)]
    code = jm.mode_to_code(mode)
    jmapped, tmapped, jinside, tinside = [], [], None, None
    for h in range(2):
        m, ins = jm.map_coordinate(jnp.asarray(cc[h]), x.shape[h], code)
        jmapped.append(m)
        tmapped.append(_t(np.asarray(m))[None])
        if code == jm.MODE_CONSTANT:
            jinside = ins if jinside is None else jinside & ins
    if jinside is not None:
        tinside = _t(np.asarray(jinside))[None]
    want = jr.resample_linear(jnp.asarray(x), jmapped, jinside, order,
                              (5, 6), jnp.float64)
    got = tr.resample_linear(_t(x)[None], tmapped, tinside, order)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def test_pad_amount_and_mirror_pad():
    x = np.arange(5 * 4).reshape(1, 5, 4, 1).astype(np.float64)
    for order in range(6):
        assert tr.pad_amount(order) == jr.pad_amount(order)
    got = tr.mirror_pad(_t(x), (1, 2), 3)
    want = jr.mirror_pad(jnp.asarray(x[0]), 2, 3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


_CAST_VALUES = np.array([-1e6, -300.5, -129.5, -12.69, -2.5, -1.5, -0.5,
                         -0.49, 0.0, 0.49, 0.5, 1.5, 2.5, 127.5, 128.5,
                         254.5, 255.5, 256.0, 300.7, 32767.5, 32768.5,
                         70000.25, 1e9])


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.bool_])
def test_cast_output_and_cast_int_c(dtype):
    t = _t(_CAST_VALUES)
    got = tr.cast_output(t, dtype)
    want = np.asarray(jr.cast_output(jnp.asarray(_CAST_VALUES), dtype))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tr.cast_int_c(t, dtype).numpy(),
        np.asarray(jr.cast_int_c(jnp.asarray(_CAST_VALUES), dtype)))


def test_wrappers_take_plain_on_cpu_only():
    x = torch.rand(1, 6, 5, 1, dtype=torch.float64)
    displ = torch.zeros(1, 2, 6, 5, dtype=torch.float64)
    k1, k2 = tr.resample.launches, tp.spline_filter1d.launches
    tr.resample(x, displ, None, (0, 0), 3, 3, 0.0)
    tp.spline_filter1d(x, 3, 1)
    assert (tr.resample.launches, tp.spline_filter1d.launches) == (k1, k2)
    # a tensor that is neither on the CPU nor on a CUDA device is refused,
    # never computed by the plain version
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tp.spline_filter1d(x.to("meta"), 3, 1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tr.resample(x.to("meta"), displ.to("meta"), None, (0, 0), 3, 3, 0.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("order", range(6))
@pytest.mark.parametrize("mode", range(5))
def test_resample_kernel_matches_plain(cuda_device, order, mode):
    rs = np.random.RandomState(order * 5 + mode)
    coeffs = torch.as_tensor(rs.rand(2, 9, 11, 8, 2), device=cuda_device)
    displ = torch.as_tensor(rs.randn(2, 3, 7, 8, 9) * 30, device=cuda_device)
    args = (coeffs, displ, None, (1, 0, 2), order, mode, 0.5)
    torch.testing.assert_close(tr.resample(*args), tr.resample_plain(*args),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 3, 4, 5])
@pytest.mark.parametrize("axis", range(3))
def test_prefilter_kernel_matches_plain(cuda_device, order, axis):
    rs = np.random.RandomState(order)
    x = torch.as_tensor(rs.rand(9, 64, 5) * 100, device=cuda_device)
    torch.testing.assert_close(tp.spline_filter1d(x, order, axis),
                               tp.spline_filter1d_plain(x, order, axis),
                               rtol=1e-10, atol=1e-8)
