"""K13, the binary erosion/dilation sweep, on its tile route.

On the card K13's tile route (``binary_tile_kernel`` in
``csrc/morphology.cu``) runs ``k`` sweeps a launch on a box of bit-packed
32-voxel words in shared memory; ``ops/morphology.py``'s ``_binary_plan``
picks the tile and ``k``, and ``binary_erosion_dilation`` drives it. On the
CPU:

* a numpy model of the kernel, block by block (packing with the pad bits at
  ``border``, the box clamped to the array, funnel-shift taps from a row's
  three words, the region shrinking by one reach a sweep, the gate, the
  flag of the last sweep), equals ``k`` sweeps of the plain twin for random
  structures, shapes, tiles and ``k`` = 1-8;
* the pack and unpack twins against numpy's ``packbits``;
* the plan's route, ``k`` and box-budget choices;
* the driver against the JAX package's binary morphology, fixed iterations
  and to the fixpoint, bit for bit, with the sweep count of the driver it
  replaced (one sweep a call, the flag read every eighth).

The ``cuda`` test holds both routes against the twins and skips without a
card.
"""

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch.ops import morphology as mo

MASK32 = np.uint64(0xFFFFFFFF)


def _pack(x3, border):
    """(nz, ny, nx) bool -> (nz, ny, nw) uint32 words, pad bits border."""
    nz, ny, nx = x3.shape
    nw = -(-nx // 32)
    v = np.full((nz, ny, nw * 32), bool(border))
    v[..., :nx] = x3
    bits = v.reshape(nz, ny, nw, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _unpack(words, nx):
    bits = (words[..., None].astype(np.uint64) >> np.arange(
        32, dtype=np.uint64)) & np.uint64(1)
    return bits.reshape(*words.shape[:-1], -1)[..., :nx].astype(bool)


def _widen(t0, t1, reach, n):
    return max(0, t0 - reach), min(n, t1 + reach)


def _shift(lo, hi, dx):
    """``__funnelshift_rc(lo, hi, dx)``: the low word of (hi:lo) >> dx."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v >> np.uint64(dx)) & MASK32).astype(np.uint32)


def _kernel_model(x, structure, centers, border, dilation, mask, k, tile):
    """``binary_tile_kernel``'s ``k`` sweeps of bool ``x`` (1-3 axes), block
    by block, with tiles of ``tile`` (voxels, voxels, words): ``(out,
    flag)``. A word of a block's buffer outside the region a sweep computes
    holds junk, so a read there shows."""
    sten = mo._Stencil(x.shape, structure, centers)
    nz, ny, nx = sten.shape3
    nw = -(-nx // 32)
    words = _pack(x.reshape(sten.shape3), border)
    valid = np.full((nz, ny, nw), 0xFFFFFFFF, dtype=np.uint32)
    valid[..., -1] = _pack(np.ones((1, 1, nx), bool), False)[0, 0, -1]
    gate = valid if mask is None else _pack(mask.reshape(sten.shape3), False)
    rz, ry, rx = sten.reach
    reach = (rz, ry, 1 if rx else 0)
    n3 = (nz, ny, nw)
    bdd = np.uint32(0xFFFFFFFF if border else 0)
    out = np.zeros_like(words)
    flag = False
    for tz, ty, tw in np.ndindex(*[-(-n // t) for n, t in zip(n3, tile)]):
        t0 = [i * t for i, t in zip((tz, ty, tw), tile)]
        t1 = [min(a + t, n) for a, t, n in zip(t0, tile, n3)]
        box = [_widen(a, b, k * r, n) for a, b, r, n in zip(t0, t1, reach,
                                                             n3)]
        sl = tuple(slice(a, b) for a, b in box)
        cur, g = words[sl].copy(), gate[sl]
        for s in range(k):
            left = k - 1 - s
            reg = [_widen(a, b, left * r, n) for a, b, r, n in
                   zip(t0, t1, reach, n3)]
            rel = tuple(slice(a - bo[0], b - bo[0]) for (a, b), bo in
                        zip(reg, box))
            # the box's buffer seen with border words beyond it (outside
            # the box is outside the array)
            pz, py = rz, ry
            pad = np.full((cur.shape[0] + 2 * pz, cur.shape[1] + 2 * py,
                           cur.shape[2] + 2), bdd, dtype=np.uint32)
            pad[pz:pz + cur.shape[0], py:py + cur.shape[1], 1:-1] = cur
            acc = np.full([b - a for a, b in reg],
                          0 if dilation else 0xFFFFFFFF, dtype=np.uint32)
            for oz, oy, dx in sten.offsets:
                rows = pad[rel[0].start + pz + oz:rel[0].stop + pz + oz,
                           rel[1].start + py + oy:rel[1].stop + py + oy]
                lft = rows[:, :, rel[2].start:rel[2].stop]
                ctr = rows[:, :, rel[2].start + 1:rel[2].stop + 1]
                rgt = rows[:, :, rel[2].start + 2:rel[2].stop + 2]
                v = _shift(ctr, rgt, dx) if dx >= 0 else _shift(lft, ctr,
                                                                32 + dx)
                acc = acc | v if dilation else acc & v
            old, gg = cur[rel], g[rel]
            now = (acc & gg) | (old & ~gg)
            if left == 0 and bool((now != old).any()):
                flag = True
            nxt = np.full_like(cur, 0xDEADBEEF)
            nxt[rel] = now
            cur = nxt
        tsl = tuple(slice(a, b) for a, b in zip(t0, t1))
        trel = tuple(slice(a - bo[0], b - bo[0]) for a, b, bo in
                     zip(t0, t1, box))
        out[tsl] = cur[trel]
    return _unpack(out, nx).reshape(x.shape), flag


def _case(seed):
    """A random shape (1-3 axes, innermost 1, 31, 32, 33 or 70), structure
    (reach up to 2 on the outer axes and 3 on the innermost, centre
    anywhere), border, mask and tile."""
    rs = np.random.RandomState(seed)
    ndim = 1 + seed % 3
    inner = (1, 31, 32, 33, 70)[seed % 5]
    shape = tuple(int(rs.randint(3, 9)) for _ in range(ndim - 1)) + (inner,)
    kshape = tuple(int(rs.randint(1, 4)) for _ in range(ndim - 1)) + (
        int(rs.randint(1, 5)),)
    st = rs.rand(*kshape) > 0.4
    centers = [int(rs.randint(0, s)) for s in kshape]
    x = rs.rand(*shape) > 0.5
    mask = rs.rand(*shape) > 0.3 if seed % 2 else None
    tile = (int(rs.randint(1, 4)), int(rs.randint(1, 5)), 1 + seed % 2)
    return x, st, centers, bool(seed % 4 >= 2), mask, tile


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("dilation", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_kernel_model_equals_k_twin_sweeps(seed, dilation, k):
    x, st, centers, border, mask, tile = _case(8 * seed + k)
    got, flag = _kernel_model(x, st, centers, border, dilation, mask, k,
                              tile)
    changed = torch.zeros(1, dtype=torch.int32)
    want = mo.binary_sweeps_plain(
        torch.from_numpy(x), st, centers, border, dilation,
        None if mask is None else torch.from_numpy(mask), k, changed)
    np.testing.assert_array_equal(got, want.numpy())
    assert flag == bool(changed.item())


@pytest.mark.parametrize("shape", [(1,), (31,), (32,), (33,), (3, 70),
                                   (2, 3, 65)])
@pytest.mark.parametrize("border", [False, True])
def test_pack_twins_are_numpy_packbits(shape, border):
    x = np.random.RandomState(len(shape)).rand(*shape) > 0.5
    words = mo.pack_bits_plain(torch.from_numpy(x), border)
    x3 = x.reshape((1,) * (3 - x.ndim) + shape)
    want = _pack(x3, border).reshape(shape[:-1] + (-1,))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(
        mo.unpack_bits_plain(words, shape[-1]).numpy(), x)
    # numpy's packbits in little bit order, word by word
    nx = shape[-1]
    padded = np.concatenate([x3, np.full(x3.shape[:-1] + (
        -nx % 32,), border)], -1)
    little = np.packbits(padded, axis=-1, bitorder="little")
    np.testing.assert_array_equal(
        little.view("<u4").reshape(want.shape), want)


def test_plan_routes():
    cross3 = mo.generate_binary_structure(3, 1)
    sten = mo._Stencil((160, 192, 224), cross3, [1, 1, 1])
    assert (sten.reach, sten.rows, sten.ntaps) == ((1, 1, 1), 5, 7)
    p = sten.plan(8, False)
    assert p.route == "tile" and p.k == 8
    assert p.smem == (3 * np.prod(p.box) + 5 + 7) * 4 <= mo.BIN_SMEM_LIMIT
    assert p.box == tuple(min(n, t + 2 * 8 * r) for n, t, r in zip(
        (160, 192, 7), p.tile, (1, 1, 1)))
    assert p.blocks == np.prod([-(-n // t) for n, t in zip((160, 192, 7),
                                                           p.tile)])
    one = sten.plan(1, True)
    assert one.route == "tile" and one.k == 1
    for want in range(1, 9):
        assert 1 <= sten.plan(want, False).k <= want
    # a budget that holds no box of 8 sweeps takes fewer sweeps a launch
    small = sten.plan(8, False, budget=3 * 12 * 4 * 7 * 4 + 48)
    assert small.route == "tile" and small.k < 8
    assert small.smem <= 3 * 12 * 4 * 7 * 4 + 48
    # the nd route: four axes, an innermost reach past 32, no box at all
    assert mo._Stencil((3, 4, 5, 6), np.ones((3, 1, 1, 3), bool),
                       [1, 0, 0, 1]).plan(8, False).route == "nd"
    wide = mo._Stencil((50, 100), np.ones((1, 67), bool), [0, 33])
    assert wide.reach == (0, 0, 33) and wide.plan(1, True).route == "nd"
    assert sten.plan(8, False, budget=100).route == "nd"
    assert sten.plan(8, False, route="nd").route == "nd"
    with pytest.raises(ValueError, match="tile route"):
        sten.plan(8, False, route="tile", budget=100)
    with pytest.raises(ValueError, match="1 to 3 axes"):
        mo._Stencil((3, 4, 5, 6), np.ones((1, 1, 1, 1), bool),
                    [0] * 4).plan(1, True, route="tile")
    # 1-D and 2-D arrays take leading axes of 1
    line = mo._Stencil((100,), np.ones(3, bool), [1])
    assert line.shape3 == (1, 1, 100) and line.reach == (0, 0, 1)
    assert mo._Stencil((9, 10), np.ones((3, 1), bool), [2, 0]).reach == \
        (0, 2, 0)


def test_row_table_decodes_to_the_taps():
    """The kernel's table (a code per row, then the rows' dx values)
    decodes to the structure's taps, row by row in sorted order."""
    st = np.random.RandomState(3).rand(3, 3, 5) > 0.3
    st[1, 1, 2] = False
    sten = mo._Stencil((6, 7, 40), st, [1, 0, 4])
    table = sten.table.astype(np.int64)
    taps, t = [], sten.rows
    for code in table[:sten.rows]:
        oz = np.int8((code >> 24) & 0xFF)
        oy = np.int8((code >> 16) & 0xFF)
        n = int((code >> 1) & 0xFF)
        dxs = table[t:t + n].tolist()
        assert bool(code & 1) == any(dxs)
        taps += [(int(oz), int(oy), dx) for dx in dxs]
        t += n
    assert t == len(table) == sten.rows + sten.ntaps
    np.testing.assert_array_equal(np.asarray(taps), sten.offsets)
    assert taps == sorted(taps)
    assert sten.rows == len({(a, b) for a, b, _ in taps})


def _old_driver_sweeps(x, structure, iterations, mask, border, dilation):
    """The sweeps of the driver before the tile route: one a call, the
    flag read after every eighth."""
    structure, centers = mo._binary_stencil(structure, 0, dilation)
    x = torch.from_numpy(x)
    m = None if mask is None else torch.from_numpy(mask)
    n = 0
    if iterations >= 1:
        for _ in range(iterations):
            x = mo.binary_step_plain(x, structure, centers, border, dilation,
                                     m)
            n += 1
        return x, n
    changed = torch.zeros(1, dtype=torch.int32)
    while True:
        for _ in range(mo.SWEEPS_PER_CHECK - 1):
            x = mo.binary_step_plain(x, structure, centers, border, dilation,
                                     m)
        changed.zero_()
        x = mo.binary_step_plain(x, structure, centers, border, dilation, m,
                                 changed)
        n += mo.SWEEPS_PER_CHECK
        if not int(changed.item()):
            return x, n


def _blob(seed, shape, bias=0.0):
    rs = np.random.RandomState(seed)
    return rs.rand(*shape) + bias > 0.55


@pytest.mark.parametrize("k_max", [None, 3])
@pytest.mark.parametrize("route", [None, "nd"])
@pytest.mark.parametrize("iterations", [1, 5, 0])
@pytest.mark.parametrize("dilation", [False, True])
@pytest.mark.parametrize("shape", [(70,), (9, 33), (5, 6, 40)])
def test_driver_equals_jax_and_the_old_sweep_count(shape, dilation,
                                                   iterations, route, k_max,
                                                   monkeypatch):
    """The new driver (on the tile route launches of up to ``k`` sweeps on
    the packed state, the flag from the last sweep of each eighth; on the
    nd route one sweep a launch) against the JAX package and the old
    driver's sweeps; ``k_max`` 3 forces launches of 3, 3 and 2 sweeps."""
    if k_max is not None:
        plan = mo._binary_plan

        def capped(*args, **kw):
            args = list(args)
            args[4] = min(args[4], k_max)
            return plan(*args, **kw)
        monkeypatch.setattr(mo, "_binary_plan", capped)
    x = _blob(len(shape) + iterations, shape)
    mask = _blob(7, shape, 0.3)
    st = ej.generate_binary_structure(len(shape), len(shape))
    count = [0]
    step = mo.binary_step_plain

    def counting(*a, **kw):
        count[0] += 1
        return step(*a, **kw)
    monkeypatch.setattr(mo, "binary_step_plain", counting)
    got = mo.binary_erosion_dilation(torch.from_numpy(x), st, iterations,
                                     torch.from_numpy(mask), 1, 0, dilation,
                                     route=route)
    monkeypatch.setattr(mo, "binary_step_plain", step)
    name = "binary_dilation" if dilation else "binary_erosion"
    want = getattr(ej, name)(x, st, iterations, mask, border_value=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    old, n_old = _old_driver_sweeps(x, st, iterations, mask, True, dilation)
    np.testing.assert_array_equal(got.numpy(), old.numpy())
    assert count[0] == n_old


@pytest.mark.parametrize("shape", [(40,), (16, 33), (7, 9, 34)])
def test_fill_holes_and_propagation_equal_jax(shape):
    x = _blob(11, shape, 0.1)
    seed = np.zeros(shape, bool)
    seed[tuple(n // 2 for n in shape)] = True
    for got, want in (
            (et.binary_fill_holes(x, device="cpu"),
             ej.binary_fill_holes(x)),
            (et.binary_propagation(seed, mask=x, device="cpu"),
             ej.binary_propagation(seed, mask=x)),
            (et.binary_opening(x, np.ones((3,) * len(shape)), iterations=2,
                               device="cpu"),
             ej.binary_opening(x, np.ones((3,) * len(shape)),
                               iterations=2))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_wrappers_count_nothing():
    before = (mo.binary_step.launches, mo.binary_step.sweeps,
              dict(mo.binary_step.routes), mo.pack_bits.launches,
              mo.unpack_bits.launches)
    x = torch.from_numpy(_blob(3, (6, 40)))
    st = np.ones((3, 3), bool)
    mo.binary_step(x, st, [1, 1], False, True)
    w = mo.pack_bits(x, False)
    sten = mo._Stencil(x.shape, st, [1, 1])
    got = mo.unpack_bits(mo.binary_sweeps(w, st, [1, 1], False, True, None,
                                          3, None, sten), 40)
    assert torch.equal(got, mo.binary_sweeps_plain(x, st, [1, 1], False,
                                                   True, None, 3))
    mo.binary_erosion_dilation(x, st, 0, None, 0, 0, True)
    assert before == (mo.binary_step.launches, mo.binary_step.sweeps,
                      dict(mo.binary_step.routes), mo.pack_bits.launches,
                      mo.unpack_bits.launches)
    with pytest.raises(ValueError, match="stencil"):
        mo.binary_sweeps(w, st, [1, 1], False, True)


# ---------------------------------------------------------------------------
# the kernels on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tile_route_matches_twins_on_card(cuda_device):
    for seed in range(24):
        x, st, centers, border, mask, _ = _case(seed)
        xt = torch.from_numpy(x).to(cuda_device)
        mt = None if mask is None else torch.from_numpy(mask).to(cuda_device)
        for dilation in (False, True):
            for route in ("tile", "nd"):
                flags = [torch.zeros(1, dtype=torch.int32,
                                     device=cuda_device) for _ in range(2)]
                got = mo.binary_step(xt, st, centers, border, dilation, mt,
                                     flags[0], route=route)
                want = mo.binary_step_plain(xt, st, centers, border,
                                            dilation, mt, flags[1])
                assert torch.equal(got, want) and torch.equal(*flags)
            sten = mo._Stencil(x.shape, st, centers)
            for k in range(1, 9):
                flags = [torch.zeros(1, dtype=torch.int32,
                                     device=cuda_device) for _ in range(2)]
                w = mo.pack_bits(xt, border)
                m = None if mt is None else mo.pack_bits(mt, False)
                got = mo.unpack_bits(mo.binary_sweeps(
                    w, st, centers, border, dilation, m, k, flags[0], sten),
                    x.shape[-1])
                want = mo.binary_sweeps_plain(xt, st, centers, border,
                                              dilation, mt, k, flags[1])
                assert torch.equal(got, want) and torch.equal(*flags)
