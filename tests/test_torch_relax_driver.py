"""K16 and K17's fixpoint driver: ``relax_to_fixpoint`` and the sweepers.

``ops/morphology.py::relax_to_fixpoint`` runs the chamfer sweeps (K16,
``distance_transform_cdt``) and the watershed sweeps (K17,
``watershed_ift``) in groups of eight, the changed flag set by each
group's last sweep; ``ops/distance.py``'s ``chamfer_sweeper`` and
``watershed_sweeper`` check the inputs, bind the entry point and read the
stream once a call, and on the card launch a group's sweeps from one host
call, ping-ponging between the state's buffers and a second set allocated
once. On the CPU:

* the public CDT and watershed equal the JAX package's bit for bit on 1-4
  axes (the CDT with and without indices, the watershed on uint8 and
  uint16 images, random and plateaus, over the cross, full and custom
  structures), with the sweep count of the JAX package's ``while_loop``
  rounded up to whole groups of eight;
* the driver makes one sweeper call a group of eight sweeps, the flag
  handed to each, and the CPU sweepers run ``n`` twin sweeps with the flag
  on the last alone.

``tests/test_torch_relax_driver_cuda.py`` holds the sweepers and the
drivers on the card to the twins and the CPU run.
"""

import math

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch.ops import distance as ds
from elasticdeform_tpu_torch.ops import morphology as mo


def _reference_sweeps(sweep, state):
    """The JAX package's ``while_loop`` count: sweeps of the twin ``sweep``
    until one changes nothing, that one included."""
    n = 0
    while True:
        changed = torch.zeros(1, dtype=torch.int32)
        state = sweep(state, changed)
        n += 1
        if not int(changed):
            return n


def _groups(n):
    return mo.SWEEPS_PER_CHECK * -(-n // mo.SWEEPS_PER_CHECK)


def _counting(monkeypatch, name):
    """Count the sweeps that reach ``ds.name`` (the CPU sweepers look it
    up at each sweep)."""
    fn = getattr(ds, name)
    seen = {"sweeps": 0}

    def counted(*args, **kwargs):
        seen["sweeps"] += 1
        return fn(*args, **kwargs)
    monkeypatch.setattr(ds, name, counted)
    return seen


_CDT_SHAPES = [(40,), (14, 21), (6, 9, 11), (7, 8, 13), (3, 4, 5, 6)]


@pytest.mark.parametrize("want_idx", [False, True])
@pytest.mark.parametrize("metric", ["taxicab", "chessboard"])
@pytest.mark.parametrize("shape", _CDT_SHAPES,
                         ids=["x".join(map(str, s)) for s in _CDT_SHAPES])
def test_cdt_driver_matches_jax(monkeypatch, shape, metric, want_idx):
    m = np.random.RandomState(len(shape) + 3 * want_idx).rand(*shape) > 0.08
    ref = ej.distance_transform_cdt(m, metric=metric,
                                    return_indices=want_idx)
    seen = _counting(monkeypatch, "chamfer_sweep")
    got = et.distance_transform_cdt(m, metric=metric,
                                    return_indices=want_idx, device="cpu")
    got, ref = (got, ref) if want_idx else ((got,), (ref,))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    st = mo.generate_binary_structure(
        len(shape), 1 if metric == "taxicab" else len(shape))
    taps = mo.relax_taps(st, shape)
    fg = torch.as_tensor(m)
    d = torch.where(fg, mo.RELAX_BIG, 0).to(torch.int32)
    ix = torch.arange(m.size, dtype=torch.int32).reshape(shape)
    n = _reference_sweeps(
        lambda s, ch: ds.chamfer_sweep_plain(*s, taps.offs, ch),
        (d, ix if want_idx else None))
    assert seen["sweeps"] == _groups(n)


_WS_SHAPES = [(30,), (12, 20), (5, 7, 9), (3, 4, 5, 6)]


@pytest.mark.parametrize("kind", ["uint8 random", "uint16 plateaus"])
@pytest.mark.parametrize("sname", ["cross", "full", "custom"])
@pytest.mark.parametrize("shape", _WS_SHAPES,
                         ids=["x".join(map(str, s)) for s in _WS_SHAPES])
def test_watershed_driver_matches_jax(monkeypatch, shape, sname, kind):
    rs = np.random.RandomState(len(shape) + 5 * len(sname) + len(kind))
    nd = len(shape)
    dtype = np.uint8 if kind.startswith("uint8") else np.uint16
    hi = 3 if "plateaus" in kind else np.iinfo(dtype).max + 1
    img = rs.randint(0, hi, shape).astype(dtype)
    mk = np.zeros(math.prod(shape), np.int32)
    mk[rs.choice(mk.size, 4, replace=False)] = [2, -1, 5, 1]
    mk = mk.reshape(shape)
    st = {"cross": mo.generate_binary_structure(nd, 1),
          "full": mo.generate_binary_structure(nd, nd),
          "custom": rs.rand(*(3,) * nd) > 0.4}[sname]
    ref = np.asarray(ej.watershed_ift(img, mk, structure=st))
    seen = _counting(monkeypatch, "watershed_sweep")
    got = et.watershed_ift(img, mk, structure=st, device="cpu").numpy()
    assert np.array_equal(got, ref)
    taps = mo.relax_taps(st, shape)
    x = torch.as_tensor(img)
    seeded = torch.as_tensor(mk) != 0
    state = (torch.where(seeded, x.to(torch.int32), mo.RELAX_BIG).int(),
             torch.where(seeded, 0, mo.RELAX_BIG).int(),
             torch.as_tensor(mk))
    n = _reference_sweeps(
        lambda s, ch: ds.watershed_sweep_plain(x, *s, taps.offs, ch), state)
    assert seen["sweeps"] == _groups(n)


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_driver_runs_whole_groups(groups):
    """One sweeper call a group of eight sweeps, the flag handed to each,
    until the first group whose last sweep changed nothing."""
    calls = []

    def sweep(state, changed, n):
        calls.append((n, changed is not None))
        if len(calls) < groups:
            changed.fill_(1)
        return state + n

    last = mo.relax_to_fixpoint(sweep, 0, torch.device("cpu"))
    assert calls == [(mo.SWEEPS_PER_CHECK, True)] * groups
    assert last == groups * mo.SWEEPS_PER_CHECK


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_cpu_sweepers_flag_the_last_of_n(monkeypatch, n):
    """The CPU sweepers run ``n`` twin sweeps, the flag handed to the last
    alone, and equal ``n`` plain sweeps."""
    rs = np.random.RandomState(n)
    shape = (6, 7, 9)
    taps = mo.relax_taps(mo.generate_binary_structure(3, 1), shape)
    m = torch.as_tensor(rs.rand(*shape) > 0.1)
    d = torch.where(m, mo.RELAX_BIG, 0).to(torch.int32)
    ix = torch.arange(m.numel(), dtype=torch.int32).reshape(shape)
    img = torch.as_tensor(rs.randint(0, 256, shape).astype(np.uint8))
    mk = torch.zeros(shape, dtype=torch.int32)
    mk.view(-1)[torch.as_tensor(rs.choice(mk.numel(), 3, replace=False))] \
        = torch.tensor([3, -1, 7], dtype=torch.int32)
    seeded = mk != 0
    tri = (torch.where(seeded, img.to(torch.int32), mo.RELAX_BIG).int(),
           torch.where(seeded, 0, mo.RELAX_BIG).int(), mk)
    for name, sweeper, state, plain in (
            ("chamfer_sweep", lambda: ds.chamfer_sweeper(d, ix, taps),
             (d, ix), lambda s, ch: ds.chamfer_sweep_plain(*s, taps.offs,
                                                           ch)),
            ("watershed_sweep", lambda: ds.watershed_sweeper(img, taps),
             tri, lambda s, ch: ds.watershed_sweep_plain(img, *s, taps.offs,
                                                         ch))):
        flags = []
        one = getattr(ds, name)

        def counted(*args, one=one):
            flags.append(args[-1] is not None)
            return one(*args)
        monkeypatch.setattr(ds, name, counted)
        flag = torch.zeros(1, dtype=torch.int32)
        got = sweeper()(state, flag, n)
        monkeypatch.undo()
        want, want_flag = state, torch.zeros(1, dtype=torch.int32)
        for j in range(n):
            want = plain(want, want_flag if j == n - 1 else None)
        assert flags == [False] * (n - 1) + [True]
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert int(flag) == int(want_flag)
