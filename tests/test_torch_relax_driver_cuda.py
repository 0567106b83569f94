"""K16 and K17's sweepers and fixpoint drivers on the card.

``ops/distance.py``'s ``chamfer_sweeper`` and ``watershed_sweeper`` launch
a group of ``n`` sweeps from one host call, ping-ponging between the
state's buffers and a second set allocated once: each group is held to
``n`` sweeps of the plain twins bit for bit, the changed flag of the last
included, the result in the state's own buffers for an even ``n`` and in
the second set for an odd one, a state that is the second set refused;
the public CDT and watershed to the port's CPU run. Every test needs a
CUDA device and skips without one (the kernels have no CPU build). The
module imports no JAX, so it runs on the card with

    python -m pytest --noconftest tests/test_torch_relax_driver_cuda.py -m cuda
"""

import math

import numpy as np
import pytest
import torch

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch.ops import distance as ds
from elasticdeform_tpu_torch.ops import morphology as mo


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _structures(rs, nd):
    return (mo.generate_binary_structure(nd, 1),
            mo.generate_binary_structure(nd, nd), rs.rand(*(3,) * nd) > 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_chamfer_sweeper_groups_match_twin(cuda_device, n):
    rs = np.random.RandomState(20 + n)
    for shape in ((37,), (9, 13), (5, 7, 9), (3, 4, 5, 6)):
        for st in _structures(rs, len(shape)):
            taps = mo.relax_taps(st, shape)
            m = torch.as_tensor(rs.rand(*shape) > 0.1, device=cuda_device)
            d0 = torch.where(m, mo.RELAX_BIG, 0).to(torch.int32)
            ix0 = torch.arange(d0.numel(), dtype=torch.int32,
                               device=cuda_device).reshape(shape)
            for with_ix in (False, True):
                state = (d0.clone(), ix0.clone() if with_ix else None)
                want, want_flag = state, torch.zeros(
                    1, dtype=torch.int32, device=cuda_device)
                for j in range(n):
                    want = ds.chamfer_sweep_plain(
                        *want, taps.offs, want_flag if j == n - 1 else None)
                sweep = ds.chamfer_sweeper(*state, taps)
                flag = torch.zeros_like(want_flag)
                got = sweep(state, flag, n)
                # an even n ends in the state's own buffers
                assert (got[0].data_ptr() == state[0].data_ptr()) == (
                    n % 2 == 0)
                assert torch.equal(got[0], want[0])
                if with_ix:
                    assert torch.equal(got[1], want[1])
                assert int(flag) == int(want_flag)
                if n % 2:
                    with pytest.raises(ValueError):
                        sweep(got, None, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_watershed_sweeper_groups_match_twin(cuda_device, n):
    rs = np.random.RandomState(30 + n)
    for shape in ((37,), (9, 13), (5, 7, 9), (3, 4, 5, 6)):
        for st in _structures(rs, len(shape)):
            taps = mo.relax_taps(st, shape)
            for dtype, hi in ((torch.uint8, 256), (torch.uint16, 3)):
                img = torch.as_tensor(rs.randint(0, hi, shape),
                                      device=cuda_device).to(dtype)
                mk = np.zeros(math.prod(shape), np.int32)
                mk[rs.choice(mk.size, 3, replace=False)] = [3, -1, 7]
                mk = torch.as_tensor(mk.reshape(shape), device=cuda_device)
                seeded = mk != 0
                state = (torch.where(seeded, img.to(torch.int32),
                                     mo.RELAX_BIG).int(),
                         torch.where(seeded, 0, mo.RELAX_BIG).int(),
                         mk.clone())
                want, want_flag = state, torch.zeros(
                    1, dtype=torch.int32, device=cuda_device)
                for j in range(n):
                    want = ds.watershed_sweep_plain(
                        img, *want, taps.offs,
                        want_flag if j == n - 1 else None)
                flag = torch.zeros_like(want_flag)
                got = ds.watershed_sweeper(img, taps)(state, flag, n)
                assert all(torch.equal(g, w) for g, w in zip(got, want))
                assert int(flag) == int(want_flag)


@pytest.mark.cuda
def test_drivers_match_cpu_run(cuda_device):
    rs = np.random.RandomState(22)
    for shape in ((30,), (12, 20), (9, 10, 11), (3, 4, 5, 6)):
        m = rs.rand(*shape) > 0.1
        a = et.distance_transform_cdt(m, metric="taxicab",
                                      return_indices=True,
                                      device=cuda_device)
        b = et.distance_transform_cdt(m, metric="taxicab",
                                      return_indices=True, device="cpu")
        assert all(torch.equal(x.cpu(), y) for x, y in zip(a, b))
        img = rs.randint(0, 200, shape).astype(np.uint8)
        mk = np.zeros(shape, np.int32)
        mk.reshape(-1)[rs.choice(mk.size, 3, replace=False)] = [1, 2, -1]
        a = et.watershed_ift(img, mk, device=cuda_device)
        b = et.watershed_ift(img, mk, device="cpu")
        assert torch.equal(a.cpu(), b)
