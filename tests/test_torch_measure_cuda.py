"""K18-K20 on the card against their plain twins.

``ops/measure.py``'s ``label_roots`` (K18's union-find, with the root
flags) and ``label_numbers`` (its numbering) bit for bit on 1-D to 4-D
masks under every connectivity and a random symmetric structure;
``segment_reduce`` (K19) on both routes in the eleven dtypes, with NaN and
+-0 in the floats: counts, order keys, coordinate bounds and histograms bit
for bit, float64 sums per segment to 1e-12 of the sum of their terms'
magnitudes (atomics reorder them); ``segment_position`` (K20) bit for bit;
the public measurements against the port's CPU run. Every test needs a
CUDA device and skips without one (the kernels have no CPU build). The
module imports no JAX, so it runs on the card with

    python -m pytest --noconftest tests/test_torch_measure_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch.ops import measure as ms
from elasticdeform_tpu_torch.ops.morphology import generate_binary_structure

DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.uint16,
          torch.int32, torch.uint32, torch.int64, torch.uint64,
          torch.float32, torch.float64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _same(got, want, what):
    """Equal bit for bit: floats by their bits, NaN where NaN."""
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype.is_floating_point:
        nan = torch.isnan(got)
        assert torch.equal(nan, torch.isnan(want)), what
        got = torch.where(nan, 0, got).view(
            torch.int64 if got.dtype == torch.float64 else torch.int32)
        want = torch.where(nan, 0, want).view(got.dtype)
    elif got.dtype in (torch.uint16, torch.uint32, torch.uint64):
        got, want = got.to(torch.int64), want.to(torch.int64)
    assert torch.equal(got, want), what


def _values(rs, shape, dtype, dev):
    if dtype == torch.bool:
        v = rs.rand(*shape) > 0.5
    elif dtype.is_floating_point:
        v = rs.randn(*shape) * 3
        v[rs.rand(*shape) < 0.1] = 0.0
        v[rs.rand(*shape) < 0.1] = -0.0
        v[rs.rand(*shape) < 0.03] = np.nan
        v = v.astype(str(dtype).split(".")[1])
    else:
        nd = np.dtype(str(dtype).split(".")[1])
        info = np.iinfo(nd)
        v = (rs.randint(-5, 6, shape) if info.min < 0
             else rs.randint(0, 8, shape)).astype(nd)
        v.flat[0], v.flat[-1] = info.max, info.min
    return torch.from_numpy(np.ascontiguousarray(v)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1,), (37,), (9, 13), (64, 70),
                                   (5, 7, 9), (24, 31, 33), (3, 4, 5, 6)])
def test_k18_matches_twin(cuda_device, shape):
    rs = np.random.RandomState(sum(shape))
    nd = len(shape)
    r = rs.rand(*(3,) * nd) > 0.5
    structs = [generate_binary_structure(nd, c) for c in range(1, nd + 1)]
    structs.append(r | r[(slice(None, None, -1),) * nd])
    for st in structs:
        offs = ms.structure_offsets(st, nd)
        for p in (0.0, 0.3, 0.55, 0.7, 1.0):
            fg = torch.as_tensor(rs.rand(*shape) < p, device=cuda_device)
            before = ms.label_roots.launches
            roots, flags = ms.label_roots(fg, offs, flags=True)
            # init and compress, and the merge where there are offsets
            assert ms.label_roots.launches - before == \
                (3 if len(ms.half_taps(offs, shape)) else 2)
            want, wflags = ms.label_roots_plain(fg, offs, flags=True)
            _same(roots, want, f"roots {shape} {p}")
            _same(flags, wflags, f"flags {shape} {p}")
            lab, n = ms.label_numbers(roots, flags)
            cum = torch.cumsum(wflags.reshape(-1), 0, dtype=torch.int32)
            _same(lab, ms.label_numbers_plain(want, cum), f"labels {shape}")
            assert n == int(wflags.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_k19_k20_match_twins(cuda_device, dtype):
    rs = np.random.RandomState(7)
    shape = (5, 7, 9)
    x = _values(rs, shape, dtype, cuda_device)
    lab = torch.as_tensor(rs.randint(-1, 8, shape).astype(np.int32),
                          device=cuda_device)
    cases = [(None, None, 1), (lab, None, 1)]
    for idx in ([1, 2, 3, 5, 9], [2, 2, 0, 4], 3):
        lut, K, _, _ = ms.labels_index(lab, idx, cuda_device)
        cases.append((lab, lut, K))
    for labels, lut, K in cases:
        want = ms.segment_reduce_plain(x, labels, lut, K, ms.STATS,
                                       (16, -3.0, 5.0))
        terms = ms.segment_reduce_plain(x.to(torch.float64).abs(), labels,
                                        lut, K, ("sum", "sum2", "csum"))
        for route in ("shared", "device"):
            got = ms.segment_reduce(x, labels, lut, K, ms.STATS,
                                    (16, -3.0, 5.0), route=route)
            for s, w in want.items():
                if s in terms:
                    err = (got[s] - w).abs()
                    ok = (err <= 1e-12 * terms[s]) | (got[s] == w) | (
                        torch.isnan(got[s]) & torch.isnan(w))
                    assert bool(ok.all()), (route, s)
                else:
                    _same(got[s], w, f"{route} {s}")
        for stat in ("min", "max"):
            _same(ms.segment_position(x, labels, lut, K, want[stat]),
                  ms.segment_position_plain(x, labels, lut, K, want[stat]),
                  f"K20 {stat}")


@pytest.mark.cuda
def test_k19_many_segments(cuda_device):
    rs = np.random.RandomState(8)
    shape = (40, 50, 60)
    lab = torch.as_tensor(rs.randint(0, 100_001, shape).astype(np.int32),
                          device=cuda_device)
    lut, K, _, _ = ms.labels_index(lab, np.arange(100_000), cuda_device)
    x = _values(rs, shape, torch.float32, cuda_device)
    assert ms.segment_plan(K, ms.STATS, 3, 8) == "device"
    want = ms.segment_reduce_plain(x, lab, lut, K, ms.STATS, (8, -2, 2))
    got = ms.segment_reduce(x, lab, lut, K, ms.STATS, (8, -2, 2))
    for s in ("count", "min", "max", "bounds", "hist"):
        _same(got[s], want[s], s)


@pytest.mark.cuda
def test_public_measurements_match_cpu(cuda_device):
    rs = np.random.RandomState(9)
    x = rs.rand(20, 24, 28).astype(np.float32)
    l_cpu, n = et.label(x > 0.6, device="cpu")
    l_gpu, n_gpu = et.label(x > 0.6, device=cuda_device)
    assert n == n_gpu
    _same(l_gpu, l_cpu, "label")
    idx = np.arange(1, n + 1)
    for fn in (et.minimum, et.maximum):
        _same(fn(x, l_gpu, idx, device=cuda_device),
              fn(x, l_cpu, idx, device="cpu"), fn.__name__)
    for fn in (et.sum_labels, et.mean):
        torch.testing.assert_close(fn(x, l_gpu, idx, device=cuda_device).cpu(),
                                   fn(x, l_cpu, idx, device="cpu"),
                                   rtol=1e-12, atol=0)
    for fn in (et.minimum_position, et.maximum_position):
        assert fn(x, l_gpu, idx, device=cuda_device) == fn(x, l_cpu, idx,
                                                            device="cpu")
    assert et.find_objects(l_gpu, device=cuda_device) == \
        et.find_objects(l_cpu, device="cpu")
    for g, w in zip(et.histogram(x, 0, 1, 8, l_gpu, idx, device=cuda_device),
                    et.histogram(x, 0, 1, 8, l_cpu, idx, device="cpu")):
        assert np.array_equal(g, w)
