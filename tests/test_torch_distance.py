"""The distance transforms of the port against the JAX package.

``distance_transform_edt``, ``distance_transform_cdt`` and
``distance_transform_bf`` run with ``device="cpu"`` (the plain twins of
kernels K14, K15 and K16) on numpy masks made from a seed, and are held to
the JAX package under x64 with no tolerance: EDT distances bit for bit,
EDT, CDT and bf indices and CDT and bf distances exactly, dtypes equal.
The cases reach each tier of the EDT's passes (a line of at most 17 goes
straight to the dense tier; a line of 18 runs the band of 16, longer lines
the band of 64, the ladder's last width below n - 1; sparse background
escalates to the dense tier), with the rungs tried checked; isotropic, anisotropic and non-dyadic sampling; 1-D to 4-D;
the output-array contract and every error string. The ``cuda`` tests hold
the kernels against their twins and skip without a card.
"""

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch.ops import distance as dist
from elasticdeform_tpu_torch.ops import morphology as mo

CPU = {"device": "cpu"}


def _equal(port, ref, what):
    """``port`` (tensor, list of tensors or None) equals ``ref`` (the JAX
    result) in dtype, shape and bits."""
    if ref is None:
        assert port is None, what
        return
    if isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), what
        for p, r in zip(port, ref):
            _equal(p, r, what)
        return
    r = np.asarray(ref)
    p = port.cpu().numpy()
    assert p.dtype == r.dtype and p.shape == r.shape, (what, p.dtype,
                                                       r.dtype, p.shape)
    if r.dtype.kind == "f":
        assert np.array_equal(p.view(np.int64), r.view(np.int64)), (
            what, np.abs(p - r).max())
    else:
        assert np.array_equal(p, r), (what, int((p != r).sum()))


def _raises_same(jax_call, port_call):
    with pytest.raises(Exception) as je:
        jax_call()
    with pytest.raises(Exception) as pe:
        port_call()
    assert type(pe.value) is type(je.value)
    assert str(pe.value) == str(je.value)


def _stripes(shape, every, row=0):
    """All foreground but background voxels at ``row`` of axis 0 every
    ``every`` positions along the last axis."""
    m = np.ones(shape, dtype=bool)
    m[(row, Ellipsis, slice(0, None, every))] = False
    return m


# (name, mask, sampling, the rungs the last axis's pass runs)
def _edt_cases():
    rs = np.random.RandomState(19)
    return [
        ("1d", rs.rand(7) > 0.3, None, None),
        ("1d_no_background", np.ones(9, bool), 0.7, None),
        ("short_dense_tier", rs.rand(9, 13) > 0.2, None, [0]),
        ("short_all_background", np.zeros((9, 13), bool), 1.5, [0]),
        ("certified_w16", _stripes((6, 100), 10), None, [64]),
        ("random_w16", rs.rand(6, 100) > 0.3, 0.7, [64]),
        ("escalate_w64", _stripes((6, 100), 50), None, [64]),
        ("escalate_dense", _stripes((6, 100), 200), None, [64, 0]),
        ("dense_anisotropic", _stripes((6, 100), 200), (1.5, 1.0), [64, 0]),
        ("no_background", np.ones((6, 100), bool), (1.5, 1.0), [64, 0]),
        ("n18_only_w16", _stripes((6, 18), 100), 0.7, [16, 0]),
        ("3d_anisotropic", rs.rand(4, 6, 20) > 0.05, (1.5, 1.0, 1.0),
         None),
        ("3d_non_dyadic", rs.rand(4, 6, 20) > 0.5, 0.7, None),
        ("4d", rs.rand(2, 3, 4, 20) > 0.1, (1.5, 1.0, 0.7, 1.0), None),
    ]


_EDT = _edt_cases()


@pytest.mark.parametrize("name, mask, sampling, rungs", _EDT,
                         ids=[c[0] for c in _EDT])
def test_edt_matches_jax(name, mask, sampling, rungs, monkeypatch):
    tried = []
    real = dist.minplus_rung

    def spy(g, idx, axis, spacing, W):
        if axis == g.dim() - 1:
            tried.append(W)
        return real(g, idx, axis, spacing, W)

    monkeypatch.setattr(dist, "minplus_rung", spy)
    ref = ej.distance_transform_edt(mask, sampling=sampling,
                                    return_indices=True)
    got = et.distance_transform_edt(mask, sampling=sampling,
                                    return_indices=True, **CPU)
    _equal(got, ref, name)
    if rungs is not None:
        assert tried == rungs
    # distances alone and indices alone take the same path
    tried.clear()
    _equal(et.distance_transform_edt(mask, sampling=sampling, **CPU),
           ej.distance_transform_edt(mask, sampling=sampling), name)
    if rungs is not None:
        assert tried == rungs
    got_ix = et.distance_transform_edt(mask, sampling=sampling,
                                       return_distances=False,
                                       return_indices=True, **CPU)
    _equal(got_ix, ref[1], name)


def test_edt_ladder_is_fixed():
    """The ladder is the JAX package's default and reads no environment."""
    assert dist.EDT_LADDER == (16, 64) == ej.ops.distance._edt_band_ladder()


def test_edt_input_types():
    """Any dtype counts its nonzero voxels as foreground, as ``x != 0``."""
    rs = np.random.RandomState(3)
    base = rs.randint(0, 3, (6, 20))
    for dtype in (np.uint16, np.float32, np.uint64):
        x = base.astype(dtype)
        _equal(et.distance_transform_edt(x, return_indices=True, **CPU),
               ej.distance_transform_edt(x, return_indices=True),
               str(dtype))


def test_edt_0d():
    """A 0-d input: the sentinel's root or 0; indices raise, as the JAX
    package's stack of no arrays does."""
    for v in (0.0, 2.0):
        _equal(et.distance_transform_edt(np.array(v), **CPU),
               ej.distance_transform_edt(np.array(v)), str(v))
    _raises_same(
        lambda: ej.distance_transform_edt(np.array(1.0), return_indices=True),
        lambda: et.distance_transform_edt(np.array(1.0), return_indices=True,
                                          **CPU))


def test_edt_output_arrays():
    rs = np.random.RandomState(4)
    m = rs.rand(6, 20) > 0.2
    ref_d, ref_i = ej.distance_transform_edt(m, return_indices=True)
    d = np.zeros(m.shape, np.float64)
    i = np.zeros((2,) + m.shape, np.int32)
    assert et.distance_transform_edt(m, return_indices=True, distances=d,
                                     indices=i, **CPU) is None
    assert np.array_equal(d, np.asarray(ref_d))
    assert np.array_equal(i, np.asarray(ref_i))
    i2 = np.zeros((2,) + m.shape, np.int32)
    got = et.distance_transform_edt(m, return_indices=True, indices=i2,
                                    **CPU)
    _equal(got, ref_d, "distances returned, indices filled")
    assert np.array_equal(i2, np.asarray(ref_i))


_EDT_ERRORS = [
    ({"return_distances": False}, "neither"),
    ({"distances": np.zeros((6, 20), np.float32)}, "distances dtype"),
    ({"distances": np.zeros((6, 21), np.float64)}, "distances shape"),
    ({"return_indices": True, "indices": np.zeros((2, 6, 20), np.int64)},
     "indices dtype"),
    ({"return_indices": True, "indices": np.zeros((1, 6, 20), np.int32)},
     "indices shape"),
    ({"indices": np.zeros((2, 6, 20), np.int32)}, "indices not returned"),
    ({"return_distances": False, "return_indices": True,
      "distances": np.zeros((6, 20), np.float64)}, "distances not returned"),
    ({"sampling": (1.0, 2.0, 3.0)}, "sampling length"),
]


@pytest.mark.parametrize("kw, what", _EDT_ERRORS,
                         ids=[w for _, w in _EDT_ERRORS])
def test_edt_errors(kw, what):
    m = np.random.RandomState(5).rand(6, 20) > 0.2
    _raises_same(lambda: ej.distance_transform_edt(m, **kw),
                 lambda: et.distance_transform_edt(m, **kw, **CPU))


def _cdt_cases():
    rs = np.random.RandomState(23)
    custom2 = np.array([[0, 1, 1], [1, 1, 0], [0, 0, 1]], bool)
    return [
        ("1d_taxicab", rs.rand(30) > 0.2, "taxicab"),
        ("2d_cityblock", rs.rand(12, 20) > 0.1, "cityblock"),
        ("2d_chessboard", rs.rand(12, 20) > 0.1, "chessboard"),
        ("2d_custom", rs.rand(12, 20) > 0.1, custom2),
        ("2d_no_background", np.ones((12, 20), bool), "taxicab"),
        ("3d_taxicab", rs.rand(5, 7, 9) > 0.05, "taxicab"),
        ("3d_chessboard", rs.rand(5, 7, 9) > 0.05, "CHESSBOARD"),
        ("4d_taxicab", rs.rand(3, 4, 5, 6) > 0.1, "taxicab"),
    ]


_CDT = _cdt_cases()


@pytest.mark.parametrize("name, mask, metric", _CDT,
                         ids=[c[0] for c in _CDT])
def test_cdt_matches_jax(name, mask, metric):
    ref = ej.distance_transform_cdt(mask, metric=metric, return_indices=True)
    got = et.distance_transform_cdt(mask, metric=metric, return_indices=True,
                                    **CPU)
    _equal(got, ref, name)
    _equal(et.distance_transform_cdt(mask, metric=metric, **CPU), ref[0],
           name)


def test_cdt_output_arrays_and_errors():
    m = np.random.RandomState(6).rand(6, 9) > 0.2
    ref_d, ref_i = ej.distance_transform_cdt(m, return_indices=True)
    d = np.zeros(m.shape, np.int32)
    i = np.zeros((2,) + m.shape, np.int32)
    assert et.distance_transform_cdt(m, return_indices=True, distances=d,
                                     indices=i, **CPU) is None
    assert np.array_equal(d, np.asarray(ref_d))
    assert np.array_equal(i, np.asarray(ref_i))
    for kw in ({"metric": "euclidean"}, {"metric": np.ones((3,), bool)},
               {"return_distances": False},
               {"distances": np.zeros(m.shape, np.float64)}):
        _raises_same(lambda: ej.distance_transform_cdt(m, **kw),
                     lambda: et.distance_transform_cdt(m, **kw, **CPU))


_BF = [("euclidean", None), (1, 0.7), ("taxicab", None), (2, None),
       ("chessboard", None), (3, None), ("cityblock", None)]


@pytest.mark.parametrize("metric, sampling", _BF,
                         ids=[str(m) for m, _ in _BF])
def test_bf_matches_jax(metric, sampling):
    m = np.random.RandomState(7).rand(6, 20) > 0.15
    ref = ej.distance_transform_bf(m, metric=metric, sampling=sampling,
                                   return_indices=True)
    got = et.distance_transform_bf(m, metric=metric, sampling=sampling,
                                   return_indices=True, **CPU)
    _equal(got, ref, str(metric))


def test_bf_output_arrays_and_errors():
    m = np.random.RandomState(8).rand(6, 9) > 0.2
    ref = ej.distance_transform_bf(m, metric="taxicab")
    d = np.zeros(m.shape, np.uint32)
    assert et.distance_transform_bf(m, metric="taxicab", distances=d,
                                    **CPU) is None
    assert np.array_equal(d, np.asarray(ref))
    for kw in ({"metric": "minkowski"}, {"metric": 4},
               {"return_distances": False},
               {"metric": "taxicab", "distances": np.zeros(m.shape,
                                                           np.int32)}):
        _raises_same(lambda: ej.distance_transform_bf(m, **kw),
                     lambda: et.distance_transform_bf(m, **kw, **CPU))


def test_tap_table_matches_offsets():
    """K16/K17's tap table: each offset's linear step and edge word, in
    the raster order of the structure's nonzero taps, the centre
    dropped."""
    rs = np.random.RandomState(9)
    for ndim in (1, 2, 3, 4):
        st = rs.rand(*(3,) * ndim) > 0.4
        shape = tuple(rs.randint(2, 6, ndim))
        taps = mo.relax_taps(st, shape)
        want = [tuple(int(t) - 1 for t in o) for o in np.argwhere(st)]
        want = [o for o in want if any(o)]
        assert taps.offs == want
        strides = np.cumprod((1,) + shape[::-1])[:-1][::-1]
        for (delta, word), o in zip(taps.table, want):
            assert delta == int(np.dot(o, strides))
            for k, t in enumerate(o):
                assert bool(word >> k & 1) == (t < 0)
                assert bool(word >> (8 + k) & 1) == (t > 0)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    m = np.ones((4, 5), bool)
    for call in (lambda: et.distance_transform_edt(m),
                 lambda: et.distance_transform_cdt(m),
                 lambda: et.distance_transform_bf(m)):
        with pytest.raises((RuntimeError, AssertionError)):
            call()


# ---------------------------------------------------------------------------
# the kernels on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _same_bits(a, b):
    if a is None:
        return b is None
    if a.dtype.is_floating_point:
        return torch.equal(a.cpu().view(torch.int64),
                           b.cpu().view(torch.int64))
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_k14_k15_match_twins_on_card(cuda_device):
    rs = np.random.RandomState(10)
    for shape, p in (((7,), 0.3), ((9, 13), 0.2), ((6, 100), 0.02),
                     ((4, 90), 0.0), ((5, 7, 70), 0.05), ((3, 4, 5, 20), 0.1),
                     ((2, 2, 2, 2, 2, 2, 40), 0.1),
                     ((2, 1, 2, 1, 2, 3, 40, 2), 0.1)):
        m = torch.as_tensor(rs.rand(*shape) > p)
        for want in (False, True):
            a = dist.nearest_background(m.to(cuda_device), 1.5, want)
            b = dist.nearest_background_plain(m, 1.5, want)
            assert _same_bits(a[0], b[0]) and _same_bits(a[1], b[1])
        f, ix = b
        for ax in range(1, len(shape)):
            for W in (0, 16, 64):
                for idx in (None, ix):
                    a = dist.minplus_rung(
                        f.to(cuda_device),
                        None if idx is None else idx.to(cuda_device), ax,
                        0.7, W)
                    b = dist.minplus_rung(f, idx, ax, 0.7, W)
                    assert _same_bits(a[0], b[0]) and _same_bits(a[1], b[1])
                    assert a[2] == b[2]
            # the pass entry, its band kept (flag clear) or the dense tier
            # run over it (flag set), against the CPU schedule
            for idx in (None, ix):
                kept = [[], []]
                a = dist.minplus_pass(
                    f.to(cuda_device),
                    None if idx is None else idx.to(cuda_device), ax, 0.7,
                    kept[0])
                b = dist.minplus_pass(f, idx, ax, 0.7, kept[1])
                assert _same_bits(a[0], b[0]) and _same_bits(a[1], b[1])
                (_, wa, fa), (_, wb, fb) = kept[0][0], kept[1][0]
                assert wa == wb
                assert (fa is None and fb is None) or bool(
                    int(fa.item())) == bool(int(fb.item()))
            f, ix = dist.minplus_pass(f, ix, ax, 0.7)


@pytest.mark.cuda
def test_k16_matches_twin_on_card(cuda_device):
    rs = np.random.RandomState(11)
    for shape in ((30,), (12, 20), (5, 7, 9), (3, 4, 5, 6)):
        m = rs.rand(*shape) > 0.1
        for metric in ("taxicab", "chessboard"):
            a = et.distance_transform_cdt(m, metric=metric,
                                          return_indices=True,
                                          device=cuda_device)
            b = et.distance_transform_cdt(m, metric=metric,
                                          return_indices=True, **CPU)
            assert all(_same_bits(x, y) for x, y in zip(a, b))
