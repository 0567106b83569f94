"""``watershed_ift`` of the port against the JAX package.

The port's ``device="cpu"`` run (the plain twin of kernel K17, swept to the
fixpoint in groups of eight) is held to the JAX package under x64 on numpy
images and markers made from a seed, labels exactly and dtypes equal: 1-D
to 4-D; uint8 and uint16 images; marker dtypes int8, int16, int32 and int64,
one of them past int32 (it wraps through int32 and sign-extends back, as
``astype`` does); negative markers; plateaus where ties go by the step
count and by the label; the cross, full and custom structures; every error.
Sweeps past the fixpoint change nothing. The ``cuda`` test holds K17
against its twin and skips without a card.
"""

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch.ops import distance as ds
from elasticdeform_tpu_torch.ops import morphology as mo

CPU = {"device": "cpu"}


def _markers(rs, shape, dtype, labels):
    m = np.zeros(shape, dtype=dtype)
    flat = m.reshape(-1)
    flat[rs.choice(flat.size, len(labels), replace=False)] = labels
    return m


def _cases():
    rs = np.random.RandomState(41)
    full2 = np.ones((3, 3), bool)
    custom3 = rs.rand(3, 3, 3) > 0.5
    cases = []
    for name, shape, idt, mdt, labels, structure in (
            ("1d_uint8_int8", (40,), np.uint8, np.int8, [1, 2, -1], None),
            ("2d_uint8_int16", (12, 20), np.uint8, np.int16, [3, -2, 7, 1],
             None),
            ("2d_uint16_int32", (12, 20), np.uint16, np.int32, [5, 1, -3],
             None),
            ("2d_full", (12, 20), np.uint8, np.int32, [1, 2, 3], full2),
            ("3d_uint16_int64", (5, 7, 9), np.uint16, np.int64,
             [2 ** 32 + 5, -(2 ** 33) - 1, 4, 9], None),
            ("3d_custom", (5, 7, 9), np.uint8, np.int16, [1, 2, -1],
             custom3),
            ("4d_uint8_int32", (3, 4, 5, 6), np.uint8, np.int32, [1, -1, 2],
             None)):
        hi = 256 if idt == np.uint8 else 65536
        img = rs.randint(0, hi, shape).astype(idt)
        cases.append((name, img, _markers(rs, shape, mdt, labels),
                      structure))
    # plateaus: a constant image, so every path costs the same and the
    # step count decides; equidistant markers, so the label decides
    flat = np.full((9, 11), 7, np.uint8)
    mk = np.zeros((9, 11), np.int32)
    mk[4, 1], mk[4, 9], mk[0, 5], mk[8, 5] = 5, 2, -4, 3
    cases.append(("plateau_ties", flat, mk, None))
    ridge = np.zeros((1, 21), np.uint16)
    ridge[0, 10] = 900
    mk = np.zeros((1, 21), np.int8)
    mk[0, 0], mk[0, 20] = 2, 1
    cases.append(("ridge_label_tie", ridge, mk, None))
    return cases


_CASES = _cases()


@pytest.mark.parametrize("name, img, markers, structure", _CASES,
                         ids=[c[0] for c in _CASES])
def test_watershed_matches_jax(name, img, markers, structure):
    ref = np.asarray(ej.watershed_ift(img, markers, structure=structure))
    got = et.watershed_ift(img, markers, structure=structure, **CPU)
    got = got.numpy()
    assert got.dtype == ref.dtype == markers.dtype
    assert np.array_equal(got, ref), int((got != ref).sum())


def test_int64_markers_wrap_through_int32():
    """An int64 label past int32 wraps, as the JAX package's ``astype``
    under x64 does, and sign-extends back."""
    img = np.zeros((1, 8), np.uint8)
    mk = np.zeros((1, 8), np.int64)
    mk[0, 0] = 2 ** 32 + 5
    mk[0, 7] = 2 ** 31 + 1
    got = et.watershed_ift(img, mk, **CPU).numpy()
    assert np.array_equal(got, np.asarray(ej.watershed_ift(img, mk)))
    assert got[0, 0] == 5 and got[0, 7] == -(2 ** 31) + 1


def test_sweeps_past_the_fixpoint_change_nothing(monkeypatch):
    rs = np.random.RandomState(42)
    img = torch.as_tensor(rs.randint(0, 200, (9, 10, 11)).astype(np.uint8))
    mk = torch.as_tensor(_markers(rs, (9, 10, 11), np.int32, [1, 2, -1, 4]))
    taps = mo.relax_taps(mo.generate_binary_structure(3, 1), img.shape)
    seeded = mk != 0
    state = (torch.where(seeded, img.to(torch.int32), mo.RELAX_BIG).int(),
             torch.where(seeded, 0, mo.RELAX_BIG).int(), mk.clone())
    sweeps = []
    one = ds.watershed_sweep

    def sweep(*args):
        sweeps.append(args[-1] is not None)
        return one(*args)

    # the CPU sweeper looks the one-sweep wrapper up at each sweep
    monkeypatch.setattr(ds, "watershed_sweep", sweep)
    state = mo.relax_to_fixpoint(ds.watershed_sweeper(img, taps), state,
                                 img.device)
    monkeypatch.undo()
    # the flag rides on the last sweep of each group of eight
    assert len(sweeps) % mo.SWEEPS_PER_CHECK == 0
    assert sweeps == ([False] * (mo.SWEEPS_PER_CHECK - 1) + [True]) * (
        len(sweeps) // mo.SWEEPS_PER_CHECK)
    changed = torch.zeros(1, dtype=torch.int32)
    again = state
    for _ in range(3):
        again = ds.watershed_sweep(img, *again, taps, changed)
    assert int(changed) == 0
    assert all(torch.equal(a, b) for a, b in zip(again, state))
    assert np.array_equal(state[2].numpy(), np.asarray(ej.watershed_ift(
        img.numpy(), mk.numpy())))


_ERRORS = [
    ("float input", np.zeros((4, 5), np.float32), np.zeros((4, 5), np.int32),
     None),
    ("int16 input", np.zeros((4, 5), np.int16), np.zeros((4, 5), np.int32),
     None),
    ("shapes", np.zeros((4, 5), np.uint8), np.zeros((4, 6), np.int32), None),
    ("structure", np.zeros((4, 5), np.uint8), np.zeros((4, 5), np.int32),
     np.ones((3, 3, 3), bool)),
]


@pytest.mark.parametrize("name, img, markers, structure", _ERRORS,
                         ids=[e[0] for e in _ERRORS])
def test_watershed_errors(name, img, markers, structure):
    with pytest.raises(Exception) as je:
        ej.watershed_ift(img, markers, structure=structure)
    with pytest.raises(Exception) as pe:
        et.watershed_ift(img, markers, structure=structure, **CPU)
    assert type(pe.value) is type(je.value)
    assert str(pe.value) == str(je.value)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        et.watershed_ift(np.zeros((4, 5), np.uint8),
                         np.ones((4, 5), np.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k17_matches_twin_on_card(cuda_device):
    for name, img, markers, structure in _CASES:
        a = et.watershed_ift(img, markers, structure=structure,
                             device=cuda_device)
        b = et.watershed_ift(img, markers, structure=structure, **CPU)
        assert torch.equal(a.cpu(), b), name
