"""The EDT's pass schedule and K14/K15's scan orders against the JAX package.

K15 runs a pass as the band of the ladder's last width ``W < n - 1``, kept
where it certifies, else the dense tier, and both of its kernels stop their
scans early. K14 walks a line in segments that exchange their first and
last background. Numpy models of those scans (a line at a time, in each
kernel's visiting order, with its exit) are held bit for bit against the
plain twins ``banded_plain``, ``matrix_plain`` and
``nearest_background_plain``; the port's ``minplus_pass`` on the CPU is
held against the JAX package's ``_minplus_pass`` under x64 on draws where
the band of 16 certifies, where only the band of 64 does and where the
dense tier is needed, values and feature planes exactly; and K15's launch
plan is checked against its staging budget.
"""

import numpy as np
import pytest
import torch

from elasticdeform_tpu.ops import distance as jd

from elasticdeform_tpu_torch.ops import distance as dist

BIG = dist._BIG32


def _band_model(g, s, W):
    """K15's band kernel on one float64 line ``g``: each voxel's own value,
    then the offsets -k, k a step, k = 1 .. W, with a strict <, ``BIG``
    beyond the line, stopping at the first constant of -k >= the best so
    far (the kernel adds -k's constant for k too: they are equal)."""
    n = g.size
    table = dist._band_constants(s, W)
    out = np.empty(n)
    arg = np.empty(n, np.int64)
    for i in range(n):
        best, bj = g[i], i
        for k in range(1, W + 1):
            if table[2 * k - 2] >= best:
                break
            assert table[2 * k - 2] == table[2 * k - 1]
            for j, c0 in ((i - k, table[2 * k - 2]), (i + k, table[2 * k - 1])):
                c = (g[j] if 0 <= j < n else BIG) + c0
                if c < best:
                    best, bj = c, min(max(j, 0), n - 1)
        out[i], arg[i] = best, bj
    return out, arg


def _dense_model(g, s):
    """K15's dense kernel on one line: j in order of k = |i - j|, i - k
    before i + k, the least (cost, j) kept, stopping at the first
    ``s^2 k^2`` above the best."""
    n = g.size
    table = dist._dense_constants(s, n)
    out = np.empty(n)
    arg = np.empty(n, np.int64)
    for i in range(n):
        best, bj = g[i] + table[0], i
        for k in range(1, n):
            if table[k] > best:
                break
            if i - k >= 0:
                c = g[i - k] + table[k]
                if c <= best:
                    best, bj = c, i - k
            if i + k < n:
                c = g[i + k] + table[k]
                if c < best:
                    best, bj = c, i + k
        out[i], arg[i] = best, bj
    return out, arg


def _lines(rs, n, count):
    """Squared distances along axis 0 of a random mask (background shares
    from none to a half), as the pass after K14 sees them; some lines
    hold no background (``BIG`` throughout)."""
    share = rs.choice([0.0, 0.02, 0.1, 0.5], size=count)
    fg = torch.as_tensor(rs.rand(6, count, n) > share[:, None])
    f, _ = dist.nearest_background_plain(fg, float(rs.choice([0.7, 1.5])),
                                         False)
    return f[int(rs.randint(6))].numpy().copy()


_SPACINGS = (0.3, 0.7, 1.5, 2.1)


@pytest.mark.parametrize("n", (17, 18, 65, 66, 150))
@pytest.mark.parametrize("s", _SPACINGS)
def test_scan_models_match_twins(n, s):
    rs = np.random.RandomState(n * 10 + int(s * 10))
    g = _lines(rs, n, 12)
    g[0] = BIG                     # a line with no background
    pos = torch.arange(n, dtype=torch.int32).expand(g.shape).contiguous()
    idx = pos[None]
    gt = torch.as_tensor(g)
    for W in [w for w in dist.EDT_LADDER if 0 < w < n - 1]:
        out, planes = dist.banded_plain(gt, idx, 1, s, W)
        for r in range(g.shape[0]):
            mo, ma = _band_model(g[r], s, W)
            assert np.array_equal(mo.view(np.int64),
                                  out[r].numpy().view(np.int64)), (W, r)
            assert np.array_equal(ma, planes[0, r].numpy()), (W, r)
    out, planes = dist.matrix_plain(gt, idx, 1, s)
    for r in range(g.shape[0]):
        mo, ma = _dense_model(g[r], s)
        assert np.array_equal(mo.view(np.int64),
                              out[r].numpy().view(np.int64)), r
        assert np.array_equal(ma, planes[0, r].numpy()), r


def _k14_model(fg_line, s0, nseg):
    """K14's walk of one line in ``nseg`` segments: each segment's first
    and last background, exchanged for the nearest one before and after
    it, then one walk reading ahead from each background it passes."""
    n = fg_line.size
    seg = -(-n // nseg)
    bounds = [(min(n, k * seg), min(n, k * seg + seg)) for k in range(nseg)]
    first, last = [], []
    for a, b in bounds:
        bg = [i for i in range(a, b) if not fg_line[i]]
        first.append(bg[0] if bg else n)
        last.append(bg[-1] if bg else -1)
    f = np.empty(n)
    j_out = np.empty(n, np.int64)
    sent = 2 * n
    for sg, (a, b) in enumerate(bounds):
        l = max([-1] + last[:sg])
        after = min([n] + first[sg + 1:])
        nxt = first[sg] if first[sg] < n else after
        for i in range(a, b):
            if i == nxt:
                l = i
                if i == last[sg]:
                    nxt = after
                else:
                    nxt += 1
                    while fg_line[nxt]:
                        nxt += 1
            dl = i - l if l >= 0 else sent
            dr = nxt - i if nxt < n else sent
            d, j = (dl, l) if dl <= dr else (dr, nxt)
            t = s0 * float(d)
            f[i] = t * t if d < sent else BIG
            j_out[i] = min(max(j, 0), n - 1)
    return f, j_out


@pytest.mark.parametrize("n", (1, 2, 7, 17, 80, 150))
def test_k14_segments_match_twin(n):
    rs = np.random.RandomState(n)
    fg = rs.rand(n, 10) > rs.choice([0.0, 0.05, 0.3, 1.1], size=10)
    f, planes = dist.nearest_background_plain(torch.as_tensor(fg), 1.5, True)
    for nseg in (1, 3, 8, 256):
        for m in range(fg.shape[1]):
            mf, mj = _k14_model(fg[:, m], 1.5, nseg)
            assert np.array_equal(mf.view(np.int64),
                                  f[:, m].numpy().view(np.int64)), (nseg, m)
            assert np.array_equal(mj, planes[0, :, m].numpy()), (nseg, m)


def _mask(rs, shape, kind):
    """A mask whose pass along axis 1 keeps the tier ``kind`` names:
    background nearby, every 40 voxels along axis 1 in row 0, or once."""
    m = np.ones(shape, bool)
    if kind == "dense":            # background everywhere nearby
        m = rs.rand(*shape) > 0.3
    elif kind == "w64":            # a band of 16 fails, one of 64 holds
        m[0, ::40] = False
    elif kind == "sparse":         # background too far for any band
        m[0, 0] = False
    return m


# (shape, mask kind, sampling, the tier the pass along axis 1 keeps)
_PASSES = [
    ((5, 40), "dense", 1.0, 16),       # the band of 16 certifies
    ((4, 100), "dense", 0.7, 64),      # so would 16: the ladder collapses
    ((4, 100), "w64", 1.0, 64),        # only the band of 64 certifies
    ((4, 100), "sparse", 2.1, 0),      # the dense tier
    ((5, 17), "dense", 0.3, 0),        # no band below n - 1
    ((5, 18), "sparse", 1.5, 0),       # the band of 16 fails
    ((3, 70, 4), "w64", 0.7, 64),      # a strided axis
]


@pytest.mark.parametrize("shape, kind, s, kept", _PASSES,
                         ids=[f"{'x'.join(map(str, c[0]))}-{c[1]}-{c[2]}"
                              for c in _PASSES])
def test_minplus_pass_matches_jax(shape, kind, s, kept):
    rs = np.random.RandomState(sum(shape))
    fg = torch.as_tensor(_mask(rs, shape, kind))
    f, idx = dist.nearest_background_plain(fg, 1.5, True)
    flags = []
    got, got_idx = dist.minplus_pass(f, idx, 1, s, flags)
    ref, ref_idx = jd._minplus_pass(f.numpy(), 1, s,
                                    [p for p in idx.numpy()])
    assert np.array_equal(got.numpy().view(np.int64),
                          np.asarray(ref).view(np.int64))
    assert np.array_equal(got_idx.numpy(), np.stack(
        [np.asarray(r) for r in ref_idx]))
    noidx, _ = dist.minplus_pass(f, None, 1, s)
    assert np.array_equal(noidx.numpy().view(np.int64),
                          got.numpy().view(np.int64))
    assert dist.kept_rungs(flags) == {1: kept}


def test_band_width_is_the_ladders_last():
    for n, W in ((1, 0), (17, 0), (18, 16), (65, 16), (66, 64), (500, 64)):
        assert dist.band_width(n) == W
        ladder = [w for w in jd._edt_band_ladder() if 0 < w < n - 1]
        assert W == (ladder[-1] if ladder else 0)


@pytest.mark.parametrize("outer, n, inner", [
    (80, 192, 224), (15360, 224, 1), (2, 9, 67), (2, 70, 40), (5, 1000, 3),
    (4, 6144, 1), (4, 6145, 1), (2, 6150, 2), (1, 1, 1), (7, 300, 100),
    (64, 40, 1), (24, 40, 2), (128, 40, 1)])
@pytest.mark.parametrize("nidx", (0, 3, 7, 8))
def test_minplus_plan_fits_its_staging(outer, n, inner, nidx):
    plan = dist._minplus_plan(outer, n, inner, nidx)
    col = (8 + 4 * nidx) * n
    if col > dist.MINPLUS_SMEM:
        assert plan.route == "lines" and plan.smem == 0
        return
    assert plan.route == "tile"
    assert 1 <= plan.w <= inner and 1 <= plan.L <= outer
    assert plan.L == 1 or plan.w == inner
    assert plan.smem == plan.L * plan.w * col <= dist.MINPLUS_SMEM
    if inner >= dist.MINPLUS_COLS and col * dist.MINPLUS_COLS \
            <= dist.MINPLUS_SMEM:
        assert plan.w % dist.MINPLUS_COLS == 0 or plan.w == inner
