"""The forward resample (kernels K1 and K1c) on the CPU.

* A numpy model of the kernels' tap-offset rule (``tap_offsets`` in
  ``csrc/resample_common.cuh``: a run of taps inside its axis unfolded, a
  run over an edge through the integer mirror fold with C's truncating
  ``%``) against the twin's mirror-pad index (``mirror_index_np``, and
  the padded table ``tap_geometry`` gathers from), for every first tap from
  ``-2n`` to ``2n``, orders 0-5 and ``n`` in 1, 2, 3, 7, 30.
* The K1 and K1c twins (``resample_plain``, ``resample_coords_plain``)
  against the JAX package's forward at naxis 1 and 4, through ``deform``
  and ``map_coordinates`` with ``strategy='gather'``, which run
  ``ops/resample.py:66`` ``resample_linear`` there, without the prefilter
  so the resample stage is compared alone: orders 0-5, the five modes, one
  and three channels, and an affine with crop offsets on ``deform``;
  float64, ``rtol=1e-12``, ``atol=1e-12 * max|X|``.
* The index width the wrappers pick at K1's extents (coefficients
  ``n_in * C``, output ``n_out * C``, displacement or coordinates ``naxis *
  n_out``) on each side of ``2**31``.
"""

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch.ops import resample as trs
from elasticdeform_tpu_torch.ops.modes import mirror_index_np
from elasticdeform_tpu_torch.ops.resample import pad_amount

MODES = ["nearest", "wrap", "reflect", "mirror", "constant"]
TOL = 1e-12


def _kernel_offsets(start: int, order: int, n: int) -> np.ndarray:
    """The tap indices K1 reads along an axis of length ``n`` for the
    window that starts at ``start`` (``tap_offsets`` without the stride):
    ``start + t`` when the run lies inside the axis, else ``mirror_fold``,
    whose ``%`` truncates toward zero as C's does."""
    taps = start + np.arange(order + 1, dtype=np.int64)
    if start >= 0 and start + order + 1 <= n:
        return taps
    if n <= 1:
        return np.zeros_like(taps)
    s2 = 2 * n - 2
    m = np.fmod(taps, s2)
    m = np.where(m < 0, m + s2, m)
    return np.where(m >= n, s2 - m, m)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 30])
@pytest.mark.parametrize("order", range(6))
def test_tap_offset_rule_equals_the_mirror_pad(order, n):
    pad = pad_amount(order)
    padded = mirror_index_np(np.arange(-pad, n + pad), n)
    interior = 0
    for start in range(-2 * n, 2 * n + 1):
        got = _kernel_offsets(start, order, n)
        taps = start + np.arange(order + 1)
        np.testing.assert_array_equal(got, mirror_index_np(taps, n))
        assert ((got >= 0) & (got < n)).all()
        if -pad <= start and start + order < n + pad:
            # the first taps the twin can form: its padded table agrees
            np.testing.assert_array_equal(got, padded[taps + pad])
        interior += start >= 0 and start + order + 1 <= n
    # the unfolded branch is taken exactly where the run fits the axis
    assert interior == max(n - order, 0)


# naxis: (input shape, output shape of map_coordinates)
_SHAPES = {1: ((30,), (26,)), 4: ((6, 5, 4, 7), (4, 3, 2, 3))}


def _close(got, want, scale):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def _cases(naxis):
    """(order, mode, C): every order and mode; at naxis 1 both channel
    counts each, at naxis 4 one and three channels in turn (each JAX
    compile there takes about a second)."""
    for order in range(6):
        for m, mode in enumerate(MODES):
            if naxis == 1:
                yield from ((order, mode, c) for c in (1, 3))
            else:
                yield order, mode, 1 if (order + m) % 2 else 3


def _input(rs, naxis, channels):
    shape = _SHAPES[naxis][0]
    X = rs.rand(*shape, channels) * 4 - 1 if channels > 1 else \
        rs.rand(*shape) * 4 - 1
    axis = tuple(range(naxis)) if channels > 1 else None
    return X, axis


@pytest.mark.parametrize("naxis, order, mode, channels",
                         [(n, *c) for n in (1, 4) for c in _cases(n)])
def test_k1_twin_equals_jax_deform(naxis, order, mode, channels):
    rs = np.random.RandomState(naxis * 100 + order * 10 + MODES.index(mode)
                               + channels)
    X, axis = _input(rs, naxis, channels)
    # control points far enough apart that coordinates pass every edge
    d = rs.randn(naxis, *(3,) * naxis) * (12 if naxis == 1 else 4)
    kw = dict(order=order, mode=mode, cval=1.25, prefilter=False, axis=axis)
    want = ej.deform(X, d, strategy="gather", **kw)
    _close(et.deform(X, d, device="cpu", **kw), want, np.abs(X).max())


@pytest.mark.parametrize("naxis, order, mode, channels",
                         [(n, *c) for n in (1, 4) for c in _cases(n)])
def test_k1c_twin_equals_jax_map_coordinates(naxis, order, mode, channels):
    rs = np.random.RandomState(naxis * 100 + order * 10 + MODES.index(mode)
                               + channels + 7)
    X, axis = _input(rs, naxis, channels)
    in_shape, out_shape = _SHAPES[naxis]
    coords = np.stack([rs.uniform(-2.0 * n, 3.0 * n, out_shape)
                       for n in in_shape])
    # first taps exactly on the clip ties and on half voxels
    flat = coords.reshape(naxis, -1)
    for h, n in enumerate(in_shape):
        flat[h, :4] = (0.0, n - 1.0, -0.5, n - 0.5)
    kw = dict(order=order, mode=mode, cval=-0.75, prefilter=False, axis=axis)
    want = ej.map_coordinates(X, coords, strategy="gather", **kw)
    _close(et.map_coordinates(X, coords, device="cpu", **kw), want,
           np.abs(X).max())


@pytest.mark.parametrize("naxis", [1, 4])
@pytest.mark.parametrize("order", range(6))
def test_k1_twin_with_affine_and_crop(naxis, order):
    """K1's affine acts on the output index without the crop offset, which
    the kernel adds after it."""
    rs = np.random.RandomState(naxis * 10 + order)
    mode = MODES[order % 5]
    X, axis = _input(rs, naxis, 1 + 2 * (order % 2))
    shape = _SHAPES[naxis][0]
    d = rs.randn(naxis, *(3,) * naxis) * 2
    A = np.concatenate([np.eye(naxis) + rs.randn(naxis, naxis) * 0.1,
                        rs.randn(naxis, 1) * 2], 1)
    crop = tuple(slice(1, n - 1) for n in shape)
    kw = dict(order=order, mode=mode, cval=0.5, prefilter=False, axis=axis,
              affine=A, crop=crop)
    want = ej.deform(X, d, strategy="gather", **kw)
    _close(et.deform(X, d, device="cpu", **kw), want, np.abs(X).max())


@pytest.mark.parametrize("n_in, n_out, channels, naxis, wide", [
    # the coefficients: n_in * C
    (2 ** 31 - 1, 64 ** 3, 1, 3, False),
    (2 ** 31, 64 ** 3, 1, 3, True),
    ((2 ** 31 - 1) // 5, 1000, 5, 3, False),
    ((2 ** 31) // 5 + 1, 1000, 5, 3, True),
    # the output: n_out * C
    (1000, (2 ** 31 - 1) // 2, 2, 1, False),
    (1000, 2 ** 30, 2, 1, True),
    # the displacement or the coordinates: naxis * n_out
    (1000, (2 ** 31 - 1) // 3, 1, 3, False),
    (1000, 2 ** 31 // 3 + 1, 1, 3, True),
    (1000, (2 ** 31 - 1) // 4, 2, 4, False),
    (1000, 2 ** 29, 2, 4, True),
])
def test_k1_index_width_follows_the_shapes(n_in, n_out, channels, naxis,
                                           wide):
    """64-bit offsets exactly when one of K1's three extents within a
    sample reaches 2**31 elements."""
    assert trs.wide_indices(n_in, n_out, channels, naxis) is wide
