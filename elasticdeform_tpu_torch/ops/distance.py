"""The distance transforms: ``distance_transform_edt``, ``_cdt`` and
``_bf``, and the watershed's sweep.

Counterpart of the JAX package's ``ops/distance.py``; ``watershed_ift``,
which relaxes the same way, is in :mod:`~elasticdeform_tpu_torch.ops.
morphology` and sweeps by K17 here. Four kernels carry them
(``csrc/distance.cu``):

* :func:`nearest_background` (K14): the exact EDT's first pass, the
  distance along axis 0 to the nearest background voxel of each line, and
  the feature planes it starts (the JAX package's ``_nearest_bg_last``).
* :func:`minplus_pass` (K15): a later pass, ``f(i) = min_j f(j) + s^2 (i -
  j)^2`` along an axis, the feature planes gathered at the argmin. The JAX
  package climbs a ladder of bands, (16, 64), each kept where its global
  certificate holds, then the dense tier; a band that certifies gives the
  wider band's values and argmins too, so the ladder's result is the band
  of its last width ``W < n - 1`` where that certifies, else the dense
  tier, and the pass runs just those (the same indices, whose ties each
  tier breaks its own way: note R2). On the card a pass is one host call
  with no flag read: the band, then the dense tier, which reads the band's
  flag on the device. :func:`minplus_rung` runs one rung alone.
* :func:`chamfer_sweep` (K16): one Jacobi sweep of the chamfer relaxation
  (``cdt_core``), run to the fixpoint by
  :func:`~elasticdeform_tpu_torch.ops.morphology.relax_to_fixpoint`.
* :func:`watershed_sweep` (K17): one Jacobi sweep of ``watershed_ift``'s
  (cost, steps, label) triples, run to the fixpoint the same way.

The fixpoint drivers launch K16 and K17 through :func:`chamfer_sweeper` /
:func:`watershed_sweeper`, which check the inputs, bind the entry point
and read the stream once a call, and launch a group of sweeps from one
host call, ping-ponging between the state's buffers and a second set
allocated once a call.

The EDT works in float64, as the JAX package does under x64 and as SciPy
returns it. On a CPU tensor each wrapper takes its plain version
(``*_plain``: the JAX package's algorithm on tensors); on a CUDA tensor it
launches its kernel or raises, and adds one to its ``.launches`` counter.
Each constant a kernel adds is built on the host as the JAX package builds
it and uploaded once per line length, spacing and device; the kernels add
and compare in their twins' order, so they agree with them bit for bit, and
the twins with the JAX package. There is no gradient.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from elasticdeform_tpu_torch.ops import _build
from elasticdeform_tpu_torch.ops.filters import _stream, normalize_sequence
from elasticdeform_tpu_torch.ops.morphology import (
    RELAX_BIG, RelaxTaps, generate_binary_structure, nonzero_mask,
    relax_check, relax_pad, relax_taps, relax_to_fixpoint, tap_view,
)

# the sentinel of a line with no background (float32 max / 16)
_BIG32 = float(np.finfo(np.float32).max / 16)
# the banded pass's half-widths, tried in order before the dense tier
EDT_LADDER = (16, 64)
# K15's tile route: a block stages its lines' values and feature planes in
# shared memory, at most MINPLUS_SMEM bytes (the default dynamic shared
# memory, as csrc/distance.cu's ED_MINPLUS_SMEM), aiming at MINPLUS_TILE
# elements; a strided axis's tile is a multiple of MINPLUS_COLS inner
# positions wide (rows of 64 bytes of values, 32 of a plane)
MINPLUS_SMEM = 48 << 10
MINPLUS_TILE = 1536
MINPLUS_COLS = 8
# the plain dense tier's (lines, n, n) chunk: a few MB, which stays in cache
_DENSE_CHUNK_BYTES = 8 << 20


_SIGNATURES = (
    ("ed_nearest_background", "vvvipddv"),
    ("ed_minplus_rung", "vvvvililviddvviiv"),
    ("ed_minplus_pass", "vvvvililvidvdviiv"),
    ("ed_chamfer_sweep", "vvvvviipivv"),
    ("ed_watershed_sweep", "vivvvvvvviipivv"))
_entries: dict = {}


def _lib():
    """``csrc/distance.cu``'s library, its C entry points bound once into
    ``_entries`` (a lookup for every later launch)."""
    if not _entries:
        lib = _build.library("distance")
        types = {"v": ctypes.c_void_p, "i": ctypes.c_int,
                 "l": ctypes.c_longlong, "d": ctypes.c_double,
                 "p": ctypes.POINTER(ctypes.c_longlong)}
        for name, sig in _SIGNATURES:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [types[c] for c in sig]
            _entries[name] = fn
        _entries["lib"] = lib
    return _entries["lib"]


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check_launch(err: int, what: str) -> None:
    if err:
        _build.check(err, _entries["lib"], "ed_distance_error_string", what)


def _axis_iota(n: int, axis: int, ndim: int, device) -> torch.Tensor:
    view = [1] * ndim
    view[axis] = n
    return torch.arange(n, dtype=torch.int32, device=device).view(view)


# ---------------------------------------------------------------------------
# K14: the first axis


def nearest_background_plain(fg: torch.Tensor, s0: float, want_idx: bool):
    """The JAX package's ``_nearest_bg_last`` along axis 0 of the bool
    ``fg`` and ``edt_core``'s first pass (``distance.py:98``, ``:259-270``):
    ``(f, idx)``, ``f = (s0 d)^2`` in float64 (``_BIG32`` on a line with no
    background), ``idx`` None or the ``(ndim, *shape)`` int32 feature planes
    (plane 0 the nearest background's index, the left one on a tie; plane
    ``k`` the coordinate along axis ``k``)."""
    n = fg.shape[0]
    ndim = fg.dim()
    idx = _axis_iota(n, 0, ndim, fg.device)
    bg = ~fg
    left = torch.cummax(torch.where(bg, idx, -1), 0).values
    right_rev = torch.cummax(torch.where(bg.flip(0), idx, -1), 0).values
    right_rev = right_rev.flip(0)
    right = torch.where(right_rev >= 0, n - 1 - right_rev, n)
    sent = 2 * n
    dl = torch.where(left >= 0, idx - left, sent)
    dr = torch.where(right < n, right - idx, sent)
    take_l = dl <= dr
    d = torch.where(take_l, dl, dr)
    t = s0 * d.to(torch.float64)
    f = torch.where(d < sent, t * t, _BIG32)
    if not want_idx:
        return f, None
    planes = torch.empty((ndim,) + tuple(fg.shape), dtype=torch.int32,
                         device=fg.device)
    planes[0] = torch.where(take_l, left, right).clamp(0, n - 1)
    for k in range(1, ndim):
        planes[k] = _axis_iota(fg.shape[k], k, ndim, fg.device)
    return f, planes


def nearest_background(fg: torch.Tensor, s0: float, want_idx: bool):
    """:func:`nearest_background_plain` on a CPU tensor; on a CUDA tensor
    K14 (one launch), adding one to ``nearest_background.launches``."""
    if fg.device.type == "cpu":
        return nearest_background_plain(fg, s0, want_idx)
    relax_check(fg, "nearest_background")
    if fg.dtype != torch.bool:
        raise TypeError(f"nearest_background: the kernel takes a bool mask, "
                        f"got {fg.dtype}")
    shape = tuple(fg.shape)
    f = torch.empty(shape, dtype=torch.float64, device=fg.device)
    planes = torch.empty((fg.dim(),) + shape, dtype=torch.int32,
                         device=fg.device) if want_idx else None
    if fg.numel() == 0:
        return f, planes
    _lib()
    err = _entries["ed_nearest_background"](
        fg.data_ptr(), f.data_ptr(), _ptr(planes), fg.dim(),
        (ctypes.c_longlong * fg.dim())(*shape), float(s0), _BIG32,
        _stream(fg))
    _check_launch(err, "nearest_background")
    nearest_background.launches += 1
    return f, planes


nearest_background.launches = 0


# ---------------------------------------------------------------------------
# K15: the later axes


def _band_offsets(W: int):
    """The banded pass's offsets in its visiting order: -1, 1, -2, 2, ...
    (``sorted(range(-W, W + 1), key=abs)`` without 0)."""
    return [o for o in sorted(range(-W, W + 1), key=abs) if o]


def _band_constants(spacing: float, W: int):
    """``(s o)^2`` for each offset in visiting order, as the JAX package's
    ``_banded_last`` computes them (Python floats)."""
    return [(spacing * o) ** 2 for o in _band_offsets(W)]


def _dense_constants(spacing: float, n: int) -> np.ndarray:
    """``s^2 k^2`` for ``k = |i - j|`` in ``range(n)``, as the JAX package's
    ``_matrix_last`` builds its cost matrix (numpy float64)."""
    return float(spacing) ** 2 * np.arange(n, dtype=np.int64) ** 2


@functools.lru_cache(maxsize=64)
def _table(spacing: float, W: int, n: int, device) -> torch.Tensor:
    """K15's constants on ``device``: the band's (``W > 0``) or the dense
    tier's (``W = 0``), uploaded once per spacing, width, length and
    device. The band kernel adds offset ``-k``'s constant for ``k`` too,
    so the two must agree bit for bit (they do: ``(s o)^2`` is even in
    ``o``)."""
    vals = np.asarray(_band_constants(spacing, W) if W
                      else _dense_constants(spacing, n), dtype=np.float64)
    if W and not np.array_equal(vals[0::2].view(np.int64),
                                vals[1::2].view(np.int64)):
        raise ValueError(f"minplus: the band's constants of -k and k differ "
                         f"at spacing {spacing!r}")
    return torch.as_tensor(vals).to(device)


def _gather_planes(idx, bestj: torch.Tensor, axis: int):
    if idx is None:
        return None
    return torch.take_along_dim(
        idx, bestj.to(torch.int64).unsqueeze(0).expand_as(idx), axis + 1)


def banded_plain(g: torch.Tensor, idx, axis: int, spacing: float, W: int):
    """The JAX package's ``_banded_last`` along ``axis`` (``:120``):
    ``out[i] = min_{|o| <= W} g[i + o] + (s o)^2``, ``_BIG32`` beyond the
    line, offsets in :func:`_band_offsets`' order with a strict ``<``; the
    ``(ndim, *shape)`` feature planes ``idx`` (or None) gathered at the
    argmin. Works along the last axis, as the JAX package does (a strided
    axis is moved there and back). Returns ``(out, idx)``."""
    n = g.shape[axis]
    moved = g.movedim(axis, -1).contiguous()
    pad = torch.full(moved.shape[:-1] + (W,), _BIG32, dtype=g.dtype,
                     device=g.device)
    gp = torch.cat([pad, moved, pad], dim=-1)
    best = moved
    if idx is None:
        for o, c in zip(_band_offsets(W), _band_constants(spacing, W)):
            best = torch.minimum(best, gp[..., W + o:W + o + n] + c)
        return best.movedim(-1, axis).contiguous(), None
    pos = torch.arange(n, dtype=torch.int32, device=g.device)
    bestj = pos.expand(moved.shape)
    for o, c in zip(_band_offsets(W), _band_constants(spacing, W)):
        cand = gp[..., W + o:W + o + n] + c
        take = cand < best
        best = torch.where(take, cand, best)
        bestj = torch.where(take, (pos + o).clamp(0, n - 1), bestj)
    return (best.movedim(-1, axis).contiguous(),
            _gather_planes(idx, bestj.movedim(-1, axis), axis))


def matrix_plain(g: torch.Tensor, idx, axis: int, spacing: float):
    """The JAX package's ``_matrix_last`` along ``axis`` (``:147``): the
    dense min-plus against the cost matrix ``s^2 (i - j)^2``, its argmin the
    lowest ``j`` of a tie (``torch.min``'s index, the first minimum), in
    chunks of lines. Returns ``(out, idx)``."""
    n = g.shape[axis]
    moved = g.movedim(axis, -1)
    lead = moved.shape[:-1]
    flat = moved.reshape(-1, n)
    k = np.arange(n)
    D = torch.as_tensor(_dense_constants(spacing, n)[np.abs(
        k[:, None] - k[None, :])], device=g.device)
    chunk = max(1, _DENSE_CHUNK_BYTES // (n * n * g.element_size()))
    outs, js = [], []
    for start in range(0, flat.shape[0], chunk):
        best, jstar = torch.min(flat[start:start + chunk, None, :] + D[None],
                                -1)
        outs.append(best)
        js.append(jstar)
    out = torch.cat(outs).reshape(lead + (n,)).movedim(-1, axis).contiguous()
    if idx is None:
        return out, None
    bestj = torch.cat(js).reshape(lead + (n,)).movedim(-1, axis)
    return out, _gather_planes(idx, bestj, axis)


class MinplusPlan(NamedTuple):
    """K15's launch geometry along an axis: ``route`` ``"tile"`` (``w``
    inner positions and ``L`` outer slices a block, ``L > 1`` only where
    ``w`` is the whole inner extent; ``smem`` bytes of values and feature
    planes staged) or ``"lines"`` (one thread an output voxel; ``w = L =
    smem = 0``). The kernel's entry point derives its grid from these."""
    route: str
    w: int
    L: int
    smem: int


@functools.lru_cache(maxsize=256)
def _minplus_plan(outer: int, n: int, inner: int, nidx: int) -> MinplusPlan:
    """K15's plan for the ``(outer, n, inner)`` view with ``nidx`` feature
    planes: the tile route where a column of ``n`` elements (8 + 4 ``nidx``
    bytes each) fits :data:`MINPLUS_SMEM`, its width a multiple of
    :data:`MINPLUS_COLS` near :data:`MINPLUS_TILE` elements (halved until
    it fits), whole slabs where it spans ``inner`` (as many as
    :data:`MINPLUS_TILE` elements and :data:`MINPLUS_SMEM` allow); else
    the lines route."""
    col = (8 + 4 * nidx) * n
    if col > MINPLUS_SMEM:
        return MinplusPlan("lines", 0, 0, 0)
    w = min(inner, max(MINPLUS_COLS,
                       MINPLUS_TILE // n // MINPLUS_COLS * MINPLUS_COLS))
    while w * col > MINPLUS_SMEM:
        w //= 2
    L = max(1, min(outer, MINPLUS_TILE // (n * inner),
                   MINPLUS_SMEM // (w * col))) if w == inner else 1
    return MinplusPlan("tile", w, L, L * w * col)


def _k15_view(g: torch.Tensor, idx, axis: int, what: str):
    """Check K15's inputs; ``(outer, n, inner, plan, nidx)``."""
    relax_check(g, what)
    if g.dtype != torch.float64 or (idx is not None and (
            idx.dtype != torch.int32 or not idx.is_contiguous()
            or tuple(idx.shape[1:]) != tuple(g.shape)
            or idx.device != g.device)):
        raise TypeError(f"{what}: the kernel takes float64 values and "
                        f"contiguous int32 feature planes of their shape")
    n, inner = g.shape[axis], math.prod(g.shape[axis + 1:])
    outer = g.numel() // (n * inner)
    nidx = 0 if idx is None else idx.shape[0]
    return outer, n, inner, _minplus_plan(outer, n, inner, nidx), nidx


def _launch_rung(g: torch.Tensor, idx, axis: int, spacing: float, W: int,
                 pred=None, into=None):
    """One K15 launch, not counted: the band of ``W > 0`` (its flag a new
    int32 tensor, set where a voxel is not certified) or the dense tier
    (``W = 0``; where ``pred``, an int32 device tensor, is 0 its blocks
    return at once), written into ``into`` = ``(out, planes)`` or new
    buffers. Returns ``(out, planes, flag or None, plan)``."""
    outer, n, inner, plan, nidx = _k15_view(g, idx, axis, "minplus_rung")
    out, planes = into if into is not None else (
        torch.empty_like(g), None if idx is None else torch.empty_like(idx))
    fail = torch.zeros(1, dtype=torch.int32, device=g.device) if W else None
    _lib()
    err = _entries["ed_minplus_rung"](
        g.data_ptr(), out.data_ptr(), _ptr(idx), _ptr(planes), nidx,
        g.numel(), n, inner,
        _table(float(spacing), W, 0 if W else n, g.device).data_ptr(), W,
        (float(spacing) * W) ** 2, _BIG32, _ptr(fail), _ptr(pred), plan.w,
        plan.L, _stream(g))
    _check_launch(err, "minplus_rung")
    return out, planes, fail, plan


def minplus_rung(g: torch.Tensor, idx, axis: int, spacing: float, W: int):
    """One rung of the JAX package's ladder: the band of ``W`` (``W > 0``)
    or the dense tier (``W = 0``) along ``axis`` of the float64 ``g``, the
    feature planes ``idx`` (or None) gathered at the argmin. Returns
    ``(out, idx, certified)``: a band is certified where every output is
    at most ``(s W)^2``, the dense tier always. A CPU tensor takes
    :func:`banded_plain` / :func:`matrix_plain`; a CUDA tensor launches K15
    (one launch; a band's flag is read, a sync) and adds one to
    ``minplus_rung.launches`` and to its rung's count in
    ``minplus_rung.rungs``."""
    if g.device.type == "cpu":
        if not W:
            return (*matrix_plain(g, idx, axis, spacing), True)
        out, planes = banded_plain(g, idx, axis, spacing, W)
        return out, planes, bool((out <= (float(spacing) * W) ** 2).all())
    if g.numel() == 0:
        _k15_view(g, idx, axis, "minplus_rung")
        return torch.empty_like(g), _empty_like(idx), True
    out, planes, fail, _ = _launch_rung(g, idx, axis, spacing, W)
    minplus_rung.launches += 1
    key = f"w{W}" if W else "dense"
    minplus_rung.rungs[key] = minplus_rung.rungs.get(key, 0) + 1
    return out, planes, fail is None or not int(fail.item())


minplus_rung.launches = 0
minplus_rung.rungs = {f"w{w}": 0 for w in EDT_LADDER} | {"dense": 0}


def _empty_like(t):
    return None if t is None else torch.empty_like(t)


def band_width(n: int) -> int:
    """The band a pass along a line of ``n`` runs: the last width of
    :data:`EDT_LADDER` with ``0 < W < n - 1``, or 0 (the dense tier
    alone)."""
    return ([w for w in EDT_LADDER if 0 < w < n - 1] or [0])[-1]


def _launch_pass(g: torch.Tensor, idx, axis: int, spacing: float):
    """A whole K15 pass from one host call, not counted: ``(out, planes,
    W, flag)``, ``flag`` (int32, on the card; None where ``W = 0``) set
    where the band did not certify and the dense tier overwrote it."""
    outer, n, inner, plan, nidx = _k15_view(g, idx, axis, "minplus_pass")
    W = band_width(n)
    out, planes = torch.empty_like(g), _empty_like(idx)
    flag = torch.empty(1, dtype=torch.int32, device=g.device) if W else None
    dev = g.device
    _lib()
    err = _entries["ed_minplus_pass"](
        g.data_ptr(), out.data_ptr(), _ptr(idx), _ptr(planes), nidx,
        g.numel(), n, inner,
        _table(float(spacing), W, 0, dev).data_ptr() if W else None, W,
        (float(spacing) * W) ** 2, _table(float(spacing), 0, n, dev)
        .data_ptr(), _BIG32, _ptr(flag), plan.w, plan.L, _stream(g))
    _check_launch(err, "minplus_pass")
    return out, planes, W, flag


def minplus_pass(f: torch.Tensor, idx, axis: int, spacing: float,
                 flags: list | None = None):
    """The JAX package's ``_minplus_pass`` (``:193``): the band of
    :func:`band_width`, kept where its global certificate holds, else the
    dense tier (the ladder's result; its narrower rungs would only repeat
    it). A CPU tensor runs :func:`minplus_rung` for each; a CUDA tensor
    launches K15's band and dense kernels from one host call (the dense
    kernel reads the band's flag on the device; no host sync), adding one
    to ``minplus_pass.kernels`` per kernel and to ``.launches`` per
    launch. ``flags``, a list, gets ``(axis, W, flag)``:
    ``flag`` an int32 tensor of one element, nonzero where the dense tier
    was kept (None where ``W = 0``; on the card read it after the call).
    Returns ``(f, idx)``."""
    W = band_width(int(f.shape[axis]))
    if f.device.type == "cpu":
        flag = None
        if W:
            out, planes, ok = minplus_rung(f, idx, axis, spacing, W)
            flag = torch.tensor([0 if ok else 1], dtype=torch.int32)
        if not W or not ok:
            out, planes, _ = minplus_rung(f, idx, axis, spacing, 0)
    elif f.numel() == 0:
        _k15_view(f, idx, axis, "minplus_pass")
        out, planes = torch.empty_like(f), _empty_like(idx)
        flag = torch.zeros(1, dtype=torch.int32, device=f.device) if W \
            else None
    else:
        out, planes, W, flag = _launch_pass(f, idx, axis, spacing)
        kernels = ("band", "dense") if W else ("dense",)
        for k in kernels:
            minplus_pass.kernels[k] += 1
        minplus_pass.launches += len(kernels)
    if flags is not None:
        flags.append((axis, W, flag))
    return out, planes


minplus_pass.launches = 0
minplus_pass.kernels = {"band": 0, "dense": 0}


def edt_core(fg: torch.Tensor, samplings, want_idx: bool):
    """The squared EDT of the bool ``fg`` (the JAX package's ``edt_core``,
    ``:237``): ``(f, idx)``, ``f`` float64, ``idx`` None or the ``(ndim,
    *shape)`` int32 feature planes (None for a 0-d ``fg``). Each pass's
    ``(axis, W, flag)`` is kept in ``edt_core.flags`` until the next call,
    for :func:`kept_rungs`."""
    edt_core.flags = []
    if fg.dim() == 0:
        return torch.where(fg, _BIG32, 0.0).to(torch.float64), None
    fg = fg.contiguous()
    f, idx = nearest_background(fg, samplings[0], want_idx)
    for ax in range(1, fg.dim()):
        f, idx = minplus_pass(f, idx, ax, samplings[ax], edt_core.flags)
    return f, idx


edt_core.flags = []


def kept_rungs(flags) -> dict:
    """The rung each pass of ``flags`` (a list of :func:`minplus_pass`'s
    ``(axis, W, flag)``) kept, ``{axis: W}`` (0 the dense tier), read from
    its flag (a sync on the card)."""
    return {ax: W if W and not int(flag.item()) else 0
            for ax, W, flag in flags}


def _sqrt(f: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as XLA and the card compute it.
    PyTorch's float64 ``sqrt`` on the CPU (its vectorised path) can be one
    unit in the last place off (``sqrt(8)``), so a CPU tensor goes through
    numpy."""
    if f.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(f.numpy())))
    return torch.sqrt(f)


# ---------------------------------------------------------------------------
# the output contract


def fill_out_arrays(results, return_flags, out_arrays, dtypes, shapes):
    """SciPy's distance-transform output contract (the JAX package's
    ``_fill_out_arrays``, ``:278``): a supplied ``distances``/``indices``
    numpy array is checked (SciPy's error strings), filled in place and
    left out of the return; None when every requested output was
    supplied."""
    ret = []
    for res, (name, flag), arr, dt, shp in zip(
            results, return_flags, out_arrays, dtypes, shapes):
        if arr is None:
            if flag:
                ret.append(res)
            continue
        if not flag:
            raise RuntimeError(
                f"return_{name} must be True if {name} is supplied")
        arr = np.asarray(arr) if not isinstance(arr, np.ndarray) else arr
        if arr.dtype != np.dtype(dt):
            raise RuntimeError(f"{name} array must be {np.dtype(dt).name}")
        if arr.shape != shp:
            raise RuntimeError(f"{name} array has wrong shape")
        arr[...] = res.detach().cpu().numpy().astype(dt)
    if not ret:
        return None
    return ret[0] if len(ret) == 1 else ret


def _need_output(return_distances, return_indices):
    if not (return_distances or return_indices):
        raise RuntimeError("at least one of distances/indices must be "
                           "returned")


def distance_transform_edt(x: torch.Tensor, sampling=None,
                           return_distances=True, return_indices=False,
                           distances=None, indices=None):
    """``distance_transform_edt`` (``:305``) of the tensor ``x``: float64
    distances, ``(ndim, *shape)`` int32 indices, or both, as SciPy returns
    them; supplied arrays filled in place (:func:`fill_out_arrays`)."""
    _need_output(return_distances, return_indices)
    want = bool(return_indices or indices is not None)
    samplings = [float(s) for s in normalize_sequence(
        1.0 if sampling is None else sampling, x.dim(), "sampling")]
    if want and x.dim() == 0:
        # the JAX package stacks no index arrays
        raise ValueError("Need at least one array to stack.")
    f, idx = edt_core(nonzero_mask(x), samplings, want)
    dist = _sqrt(f) if return_distances else None
    return fill_out_arrays(
        [dist, idx],
        [("distances", return_distances), ("indices", return_indices)],
        [distances, indices], [np.float64, np.int32],
        [tuple(x.shape), (x.dim(),) + tuple(x.shape)])


# ---------------------------------------------------------------------------
# K16: the chamfer distance


def cdt_structure(metric, ndim: int):
    """The chamfer structure of a metric (the JAX package's
    ``_cdt_structure``, ``:332``)."""
    if isinstance(metric, str):
        m = metric.lower()
        if m in ("cityblock", "taxicab"):
            return generate_binary_structure(ndim, 1)
        if m == "chessboard":
            return generate_binary_structure(ndim, ndim)
        raise ValueError(f"invalid metric provided: {metric!r}")
    return np.asarray(metric, dtype=bool)


def chamfer_sweep_plain(d: torch.Tensor, ix, offs, changed=None):
    """One Jacobi sweep of the JAX package's ``cdt_core`` (``:362-375``):
    ``d <- min(d, d[u] + 1)`` over the neighbours ``u`` at ``offs`` in
    order, a strict ``<``, ``RELAX_BIG`` beyond the edge; ``ix`` (int32
    raveled indices, or None) carries the winner's. ``changed`` (int32, one
    element) is set to 1 where ``d`` changed."""
    dp = relax_pad(d, RELAX_BIG)
    ixp = None if ix is None else relax_pad(ix, 0)
    nd, nix = d, ix
    for off in offs:
        cand = tap_view(dp, off, d.shape) + 1
        take = cand < nd
        nd = torch.where(take, cand, nd)
        if ix is not None:
            nix = torch.where(take, tap_view(ixp, off, d.shape), nix)
    if changed is not None and bool((nd != d).any()):
        changed.fill_(1)
    return nd, nix


def _spare(state, spare: list):
    """The sweeper's second buffer set, allocated at its first launch;
    ``state`` must not be it."""
    if not spare:
        spare.append(tuple(None if t is None else torch.empty_like(t)
                           for t in state))
    if any(t is not None and t.data_ptr() == o.data_ptr()
           for t, o in zip(state, spare[0])):
        raise ValueError("a sweeper's state must not be its own second "
                         "buffer set")
    return spare[0]


def chamfer_sweeper(d: torch.Tensor, ix, taps: RelaxTaps):
    """The fixpoint driver's K16 sweeps for one call on ``d``'s shape and
    device (``ix`` None or not, as every state will be): ``sweep(state,
    changed=None, n=1)``, ``n`` sweeps of ``state = (d, ix)``, ``changed``
    set by the last, returning the result. A CPU tensor takes ``n`` sweeps
    of :func:`chamfer_sweep`'s twin. On the card the ``n`` launches go from
    one host call, ping-ponging between ``state``'s buffers and a second
    set allocated at the first launch, so the result lies in one of them
    (an even ``n`` overwrites ``state``). The inputs are checked, the entry
    point bound and the stream read once."""
    if d.device.type == "cpu":
        def sweep(state, changed=None, n=1):
            for j in range(n):
                state = chamfer_sweep(*state, taps,
                                      changed if j == n - 1 else None)
            return state
        return sweep
    relax_check(d, "chamfer_sweep")
    if d.dtype != torch.int32 or (ix is not None and (
            ix.dtype != torch.int32 or not ix.is_contiguous()
            or ix.shape != d.shape)):
        raise TypeError("chamfer_sweep: the kernel takes int32 distances "
                        "and indices")
    _lib()
    fn = _entries["ed_chamfer_sweep"]
    cargs = taps.c_args(d.device)
    stream = _stream(d)
    spare = []

    def sweep(state, changed=None, n=1):
        d, ix = state
        out = _spare(state, spare)
        _check_launch(fn(d.data_ptr(), _ptr(ix), out[0].data_ptr(),
                         _ptr(out[1]), *cargs, n, _ptr(changed), stream),
                      "chamfer_sweep")
        chamfer_sweep.launches += n
        return out if n % 2 else state
    return sweep


def chamfer_sweep(d: torch.Tensor, ix, taps: RelaxTaps, changed=None):
    """One sweep of :func:`chamfer_sweep_plain` over ``taps``. A CPU tensor
    takes the twin; a CUDA tensor launches K16 into new buffers and adds
    one to ``chamfer_sweep.launches``."""
    if d.device.type == "cpu":
        return chamfer_sweep_plain(d, ix, taps.offs, changed)
    return chamfer_sweeper(d, ix, taps)((d, ix), changed)


chamfer_sweep.launches = 0


def cdt_core(fg: torch.Tensor, structure, want_idx: bool):
    """The JAX package's ``cdt_core`` (``:343``): the chamfer distance
    (int32) of the bool ``fg`` over ``structure``'s neighbours, K16 sweeps
    to the fixpoint, and the winners' raveled indices (int32) or None."""
    ndim = fg.dim()
    shape = tuple(fg.shape)
    structure = np.asarray(structure, dtype=bool)
    if structure.shape != (3,) * ndim:
        raise RuntimeError("structure dimensions must be 3")
    d = torch.where(fg, RELAX_BIG, 0).to(torch.int32).contiguous()
    ix = torch.arange(fg.numel(), dtype=torch.int32, device=fg.device
                      ).reshape(shape) if want_idx else None
    if fg.numel() == 0:
        return d, ix
    taps = relax_taps(structure, shape)
    return relax_to_fixpoint(chamfer_sweeper(d, ix, taps), (d, ix),
                             fg.device)


# ---------------------------------------------------------------------------
# K17: the watershed's sweep


def watershed_sweep_plain(img: torch.Tensor, c: torch.Tensor,
                          s: torch.Tensor, l: torch.Tensor, offs,
                          changed=None):
    """One Jacobi sweep of ``watershed_ift`` (the JAX package's
    ``ops/morphology.py:571-592``) over the padded triples: a labelled
    neighbour offers ``(max(c, x), s + 1, l)``; the lexicographically
    smallest triple wins, strictly. ``changed`` (int32, one element) is set
    to 1 where a voxel changed."""
    cp, sp, lp = (relax_pad(c, RELAX_BIG), relax_pad(s, RELAX_BIG),
                  relax_pad(l, 0))
    xi = img.to(torch.int32)
    nc, ns, nl = c, s, l
    for off in offs:
        cc = torch.maximum(tap_view(cp, off, c.shape), xi)
        cs = tap_view(sp, off, c.shape) + 1
        cl = tap_view(lp, off, c.shape)
        same_c = cc == nc
        better = (cl != 0) & ((cc < nc) | (same_c & (cs < ns))
                              | (same_c & (cs == ns) & (cl < nl)))
        nc = torch.where(better, cc, nc)
        ns = torch.where(better, cs, ns)
        nl = torch.where(better, cl, nl)
    if changed is not None and bool(((nc != c) | (ns != s) | (nl != l))
                                    .any()):
        changed.fill_(1)
    return nc, ns, nl


def watershed_sweeper(img: torch.Tensor, taps: RelaxTaps):
    """The fixpoint driver's K17 sweeps for one call on the uint8 or uint16
    ``img``: ``sweep(state, changed=None, n=1)``, ``n`` sweeps of the
    triples ``state = (c, s, l)``, ``changed`` set by the last, returning
    the result. A CPU tensor takes ``n`` sweeps of
    :func:`watershed_sweep`'s twin; on the card the ``n`` launches go from
    one host call, ping-ponging as :func:`chamfer_sweeper`'s. The image is
    checked, the entry point bound and the stream read once; each state's
    triples are checked at each call."""
    if img.device.type == "cpu":
        def sweep(state, changed=None, n=1):
            for j in range(n):
                state = watershed_sweep(img, *state, taps,
                                        changed if j == n - 1 else None)
            return state
        return sweep
    relax_check(img, "watershed_sweep image")
    if img.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"watershed_sweep: the kernel takes a uint8 or "
                        f"uint16 image, got {img.dtype}")
    _lib()
    fn = _entries["ed_watershed_sweep"]
    cargs = taps.c_args(img.device)
    stream = _stream(img)
    nbytes = img.element_size()
    spare = []

    def sweep(state, changed=None, n=1):
        for t in state:
            if (t.dtype != torch.int32 or t.shape != img.shape
                    or not t.is_contiguous() or t.device != img.device):
                raise TypeError("watershed_sweep: the kernel takes "
                                "contiguous int32 triples of the image's "
                                "shape on its device")
        out = _spare(state, spare)
        _check_launch(fn(img.data_ptr(), nbytes,
                         *[t.data_ptr() for t in (*state, *out)], *cargs,
                         n, _ptr(changed), stream), "watershed_sweep")
        watershed_sweep.launches += n
        return out if n % 2 else state
    return sweep


def watershed_sweep(img: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
                    l: torch.Tensor, taps: RelaxTaps, changed=None):
    """One Jacobi sweep of the watershed's triples ``(c, s, l)`` (int32,
    ``img``'s shape; ``img`` uint8 or uint16) over ``taps``; ``changed`` as
    :func:`watershed_sweep_plain`. A CPU tensor takes
    :func:`watershed_sweep_plain`; a CUDA tensor launches K17 into new
    buffers (the triples in and out never alias) and adds one to
    ``watershed_sweep.launches``."""
    if img.device.type == "cpu":
        return watershed_sweep_plain(img, c, s, l, taps.offs, changed)
    return watershed_sweeper(img, taps)((c, s, l), changed)


watershed_sweep.launches = 0


def _unravel(ix: torch.Tensor, shape) -> torch.Tensor:
    """Raveled int32 indices as ``(ndim, *shape)`` int32 coordinates."""
    coords = torch.empty((len(shape),) + tuple(ix.shape), dtype=torch.int32,
                         device=ix.device)
    rem = ix
    for k in range(len(shape) - 1, -1, -1):
        coords[k] = torch.remainder(rem, shape[k])
        rem = torch.div(rem, shape[k], rounding_mode="floor")
    return coords


def _chamfer(x: torch.Tensor, structure, return_distances, return_indices,
             distances, indices, dist_dtype, np_dtype):
    want = bool(return_indices or indices is not None)
    d, ix = cdt_core(nonzero_mask(x), structure, want)
    coords = _unravel(ix, tuple(x.shape)) if want else None
    return fill_out_arrays(
        [d.to(dist_dtype) if return_distances else None, coords],
        [("distances", return_distances), ("indices", return_indices)],
        [distances, indices], [np_dtype, np.int32],
        [tuple(x.shape), (x.dim(),) + tuple(x.shape)])


def distance_transform_cdt(x: torch.Tensor, metric="chessboard",
                           return_distances=True, return_indices=False,
                           distances=None, indices=None):
    """``distance_transform_cdt`` (``:382``) of the tensor ``x``: int32
    chamfer distances for the cityblock/taxicab or chessboard metric or a
    3^ndim structure, ``(ndim, *shape)`` int32 indices, or both."""
    _need_output(return_distances, return_indices)
    structure = cdt_structure(metric, x.dim())
    return _chamfer(x, structure, return_distances, return_indices,
                    distances, indices, torch.int32, np.int32)


def distance_transform_bf(x: torch.Tensor, metric="euclidean", sampling=None,
                          return_distances=True, return_indices=False,
                          distances=None, indices=None):
    """``distance_transform_bf`` (``:410``): the Euclidean metric (or 1) by
    :func:`distance_transform_edt`; cityblock/taxicab (2) and chessboard (3)
    by the chamfer relaxation, cast to uint32."""
    _need_output(return_distances, return_indices)
    m = metric.lower() if isinstance(metric, str) else metric
    if m in ("euclidean", 1):
        return distance_transform_edt(x, sampling, return_distances,
                                      return_indices, distances, indices)
    if m in ("cityblock", "taxicab", 2):
        name = "taxicab"
    elif m in ("chessboard", 3):
        name = "chessboard"
    else:
        raise RuntimeError(f"{metric} metric not supported")
    return _chamfer(x, cdt_structure(name, x.dim()), return_distances,
                    return_indices, distances, indices, torch.uint32,
                    np.uint32)
