"""The adjoints of the B-spline resampling: the scatter to the coefficients
and the gradient with respect to the sample coordinates.

:func:`resample_transpose` is the wrapper of kernel K3 (``ed_resample_bwd``
in ``csrc/resample_bwd.cu``), the exact transpose of kernel K1 with respect
to the coefficients: each output voxel adds ``g * prod(weights)`` into the
coefficients its taps read. Its plain version,
:func:`resample_transpose_plain`, is the JAX package's formulation: a
scatter-add into the mirror-padded coefficients, then the padding folded
back (``ops/windows.py:1354``,
``:1174``, ``:1488`` there; tap for tap ``jax.linear_transpose`` of
``resample_linear``, ``ops/deform.py:453-467``).

:func:`resample_coord_grad` is the wrapper of kernel K5
(``ed_resample_coord_grad``), the gradient of ``<resample(coeffs), g>``
with respect to the dense displacement: per voxel and axis ``h``, the
fold's derivative times ``sum_c sum_taps g * coeff * w'_h * prod_{l != h}
w_l``, and 0 where constant mode falls outside (the d_cc branch of
``ops/windows.py:1247``, ``:1277-1308`` there). Its plain version is
:func:`resample_coord_grad_plain`. Both take the sum in one order: the
channels folded per tap, then the taps contracted axis by axis, innermost
first (:func:`_coord_grad_at`), so no tap re-forms a product of weights.

The coordinate-input wrappers serve the general resampler
(``map_coordinates``): :func:`resample_coords_transpose` (kernel K3c,
``ed_resample_coords_bwd``) is K3 at caller-given coordinates, and
:func:`resample_coords_grad` (kernel K5c, ``ed_resample_coords_grad``) is K5
with respect to those coordinates; their plain versions are
:func:`resample_coords_transpose_plain` and
:func:`resample_coords_grad_plain`.

K3 and K3c run on the plan of :func:`_bwd_plan`. On its ``"tile"`` route a
block owns a tile of the output (:data:`BWD_TILE`, 8 x 8 x 8 voxels of a
3-D output), sums its taps into a box of the coefficients in shared memory
and flushes the box with one device-memory atomic per element; a block
whose box exceeds the budget (:data:`BWD_BUDGET` bytes) or whose
coordinates are not finite adds each tap to the coefficients directly. Its
``"direct"`` route (orders below :data:`BWD_TILE_ORDER`, a channel count
whose single-voxel box exceeds the budget, or forced) launches a kernel of
its own, one thread per output voxel in raster order (a warp's lanes along
the output's innermost axis), each adding its own taps. ``.routes`` counts
the launches of each route.

Layouts are those of :mod:`~elasticdeform_tpu_torch.ops.resample`. On a CPU
tensor each wrapper takes its plain version; on a CUDA tensor it launches
its kernel or raises, and adds one to its ``.launches`` counter. The
kernels take float32 and float64; complex, float16 and bfloat16 raise
TypeError at the entry points.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from elasticdeform_tpu_torch.ops import _build
from elasticdeform_tpu_torch.ops import modes as _modes
from elasticdeform_tpu_torch.ops.bspline import spline_weights_grad
from elasticdeform_tpu_torch.ops.resample import (
    check_coords_args, check_kernel_tensor, check_resample_args,
    kernel_geometry, map_all,
    mirror_pad, mirror_unpad, sample_coordinates, tap_geometry, tap_products,
    wide_indices,
)


def _zero_outside(t: torch.Tensor, inside) -> torch.Tensor:
    if inside is None:
        return t
    return torch.where(inside, t, torch.zeros((), dtype=t.dtype,
                                               device=t.device))


# K3/K3c's tile of output voxels, one a thread: up to 512 for float32 with
# 32-bit offsets, up to 256 for the rest (``BwdThreads`` in
# ``csrc/resample_bwd.cu``)
BWD_MAX_TILE = 512
# the tile of a 3-D (or higher) output, and of a 2-D and a 1-D one, over
# the output's three innermost axes (a, b, c), c innermost; halved on its
# outermost axis above 1 where the block has 256 threads
BWD_TILE = (8, 8, 8)
BWD_TILES_BY_RANK = {0: (1, 1, 512), 1: (1, 1, 512), 2: (1, 16, 32)}
# the shared-memory bytes of a block's box
BWD_BUDGET = 16384
# the least order the plan puts on the tile route: a shared-memory float
# add is a compare-and-swap loop on the H100 that runs about as fast as a
# device-memory atomic, so the box pays where a voxel's taps overlap its
# neighbours' many times (order 3: 5.6 ms against 8.3 at c5, 2.1 against
# 2.4 at c8) and not at order 1 (1.11 against 1.13 at c5, 1.40 against
# 1.09 at c7; PERF.md section 6)
BWD_TILE_ORDER = 2
# the direct route's threads a block, one a voxel (``DIRECT_THREADS`` in
# ``csrc/resample_bwd.cu``)
DIRECT_THREADS = 256

BwdPlan = collections.namedtuple(
    "BwdPlan", "route view tile cap smem blocks wide")
BwdPlan.__doc__ = """K3/K3c's launch: ``route`` "tile" (a box of up to
``cap`` elements, ``smem`` bytes, per block) or "direct" (cap 0, one
thread a voxel); the output ``view`` ``(outer, a, b, c)``; the ``tile``
over ``(a, b, c)`` (the tile route's; the direct route does not use it);
the grid's ``blocks`` per sample; ``wide``: 64-bit offsets."""


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def bwd_view(out_shape) -> tuple:
    """The output ``(outer, a, b, c)`` that K3/K3c tile: the three
    innermost axes, the rest folded into ``outer``, 1s in front of a
    shorter shape."""
    out_shape = tuple(int(n) for n in out_shape)
    inner = out_shape[-3:] if len(out_shape) >= 3 else out_shape
    return ((math.prod(out_shape[:-3]),) + (1,) * (3 - len(inner))
            + tuple(inner))


def bwd_threads(dtype, wide: bool) -> int:
    """The threads of a K3/K3c block, one per voxel of its tile."""
    return BWD_MAX_TILE if dtype == torch.float32 and not wide \
        else BWD_MAX_TILE // 2


@functools.lru_cache(maxsize=1024)
def _bwd_plan(in_shape, out_shape, channels: int, order: int, dtype,
              route=None, budget: int = BWD_BUDGET, tile=None) -> BwdPlan:
    """The launch of K3 (``out_shape`` the displacement's spatial shape)
    or K3c (the coordinates' output shape) scattering into coefficients of
    spatial ``in_shape`` with ``channels`` channels. The tile is
    :data:`BWD_TILE` on a 3-D output (:data:`BWD_TILES_BY_RANK` below),
    halved to the block's threads (:func:`bwd_threads`), or ``tile``; an
    axis shorter than its tile extent takes the next power of two, and the
    voxels it frees go to the innermost axes that are longer. The route
    is "tile", with a box of ``budget`` bytes, from order
    :data:`BWD_TILE_ORDER` up, unless one voxel's taps (``(order + 1)^naxis
    x channels`` elements) exceed it; else "direct". ``route`` forces
    either (``chip_smoke.py`` and the tests hold both branches this way);
    a forced "tile" that cannot fit raises ValueError. The direct route
    runs :data:`DIRECT_THREADS` voxels a block. Offsets are 64-bit where a
    sample reaches 2^31 elements (``wide_indices``). Cached: the wrappers
    ask at every launch."""
    if route not in (None, "tile", "direct"):
        raise ValueError(f"route must be 'tile' or 'direct', got {route!r}")
    in_shape = tuple(int(n) for n in in_shape)
    naxis = len(in_shape)
    view = bwd_view(out_shape)
    wide = wide_indices(math.prod(in_shape), math.prod(view), channels,
                        naxis)
    threads = bwd_threads(dtype, wide)
    if tile is None:
        want = list(BWD_TILES_BY_RANK.get(len(tuple(out_shape)), BWD_TILE))
        while math.prod(want) > threads:
            a = next(k for k, d in enumerate(want) if d > 1)
            want[a] //= 2
        want = tuple(want)
    else:
        want = tuple(tile)
    if any(d < 1 or d & (d - 1) for d in want) or \
            math.prod(want) > threads:
        raise ValueError(f"a tile is three powers of two of at most "
                         f"{threads} voxels, got {want}")
    need = [_pow2_at_least(n) for n in view[1:]]
    dims = [min(d, n) for d, n in zip(want, need)]
    for a in (2, 1, 0):
        while math.prod(dims) < math.prod(want) and dims[a] < need[a]:
            dims[a] *= 2
    blocks = view[0] * math.prod(-(-n // d) for n, d in zip(view[1:], dims))
    if blocks >= 2 ** 31:
        raise ValueError(f"K3: {blocks} blocks a sample, over 2^31")
    item = 4 if dtype == torch.float32 else 8
    cap = int(budget) // item
    fits = channels * (order + 1) ** naxis <= cap
    if route == "tile" and not fits:
        raise ValueError(f"K3's box of one voxel, {channels} x "
                         f"{order + 1}^{naxis} elements, exceeds {budget} "
                         f"bytes")
    if route == "direct" or not fits or \
            route is None and order < BWD_TILE_ORDER:
        blocks = -(-math.prod(view) // DIRECT_THREADS)
        if blocks >= 2 ** 31:
            raise ValueError(f"K3: {blocks} blocks a sample, over 2^31")
        return BwdPlan("direct", view, tuple(dims), 0, 0, blocks, wide)
    return BwdPlan("tile", view, tuple(dims), cap, cap * item, blocks, wide)


def _tile_args(plan: BwdPlan):
    """The plan as the C entry points take it: view, log2 tile, cap on the
    tile route; nothing on the direct route."""
    if plan.route == "direct":
        return ()
    return ((ctypes.c_longlong * 4)(*plan.view),
            (ctypes.c_int * 3)(*[d.bit_length() - 1 for d in plan.tile]),
            plan.cap)


def resample_linear_transpose(g: torch.Tensor, mapped, inside, order: int,
                              in_spatial):
    """Transpose of :func:`~elasticdeform_tpu_torch.ops.resample.
    resample_linear` with respect to its coefficients: ``g`` ``(B,
    *out_spatial, C)``, zeroed where ``inside`` is False, is scatter-added
    with the tap weights into the mirror-padded coefficients, and the
    padding is folded back onto ``in_spatial``."""
    naxis = len(mapped)
    B, C = g.shape[0], g.shape[-1]
    g2 = _zero_outside(g, None if inside is None else inside[..., None])
    g2 = g2.reshape(-1, C)
    pad, padded, base, strides, weights = tap_geometry(in_spatial, mapped,
                                                       order)
    rows = B * math.prod(padded)
    dxp = torch.zeros((rows, C), dtype=g.dtype, device=g.device)
    for offset, (w,) in tap_products(order, strides, [weights]):
        idx = torch.clamp(base + offset, 0, rows - 1)
        dxp.index_add_(0, idx, g2 if w is None else w[:, None] * g2)
    return mirror_unpad(dxp.reshape(B, *padded, C), range(1, naxis + 1),
                        pad, in_spatial)


def resample_transpose_plain(g: torch.Tensor, displ: torch.Tensor, affine,
                             offsets, order: int, mode: int, in_spatial):
    """Plain version of K3: the coordinates and mode fold of K1, then
    :func:`resample_linear_transpose`."""
    cc = sample_coordinates(displ, affine, offsets)
    mapped, inside = map_all(cc, in_spatial, mode)
    return resample_linear_transpose(g, mapped, inside, order, in_spatial)


def resample_coords_transpose_plain(g: torch.Tensor, coords: torch.Tensor,
                                    order: int, mode: int, in_spatial):
    """Plain version of K3c: :func:`resample_transpose_plain` at the given
    coordinates ``(B, naxis, *out_spatial)``."""
    cc = [coords[:, h] for h in range(coords.shape[1])]
    mapped, inside = map_all(cc, in_spatial, mode)
    return resample_linear_transpose(g, mapped, inside, order, in_spatial)


def resample_coord_grad_plain(coeffs: torch.Tensor, g: torch.Tensor,
                              displ: torch.Tensor, affine, offsets,
                              order: int, mode: int) -> torch.Tensor:
    """Plain version of K5: ``d <resample(coeffs), g> / d displ``, shaped
    like ``displ``, summed in the kernel's order (:func:`_coord_grad_at`).
    """
    return _coord_grad_at(coeffs, g, sample_coordinates(displ, affine,
                                                        offsets),
                          order, mode, displ)


def resample_coords_grad_plain(coeffs: torch.Tensor, g: torch.Tensor,
                               coords: torch.Tensor, order: int,
                               mode: int) -> torch.Tensor:
    """Plain version of K5c: :func:`resample_coord_grad_plain` with respect
    to the given coordinates ``(B, naxis, *out_spatial)``."""
    return _coord_grad_at(coeffs, g,
                          [coords[:, h] for h in range(coords.shape[1])],
                          order, mode, coords)


def _coord_grad_at(coeffs, g, cc, order, mode, like):
    """K5's contraction: per tap the channels folded into ``gc = sum_c g_c
    * coeff_c`` (in channel order), then the taps contracted axis by axis,
    the innermost (last) axis first, each tap's terms summed in tap order.
    Contracting axis ``h`` turns the partials of the axes after it, ``[s,
    d_{h+1}, ..., d_{naxis-1}]`` (``s`` without a derivative weight, ``d_l``
    with the derivative along ``l``), into ``[sum w_h s, sum w'_h s, sum
    w_h d_{h+1}, ...]``. After axis 0 the derivative partials are the
    result; each is multiplied by its fold's derivative last."""
    B, naxis = like.shape[:2]
    if order == 0:
        return torch.zeros_like(like)
    in_spatial = tuple(coeffs.shape[1:naxis + 1])
    C = coeffs.shape[-1]
    mapped, inside = map_all(cc, in_spatial, mode)
    pad, padded, base, strides, weights = tap_geometry(in_spatial, mapped,
                                                       order)
    n_out = base.numel()
    dweights = [[d.reshape(n_out) for d in spline_weights_grad(m, order)]
                for m in mapped]
    rows = B * math.prod(padded)
    xf = mirror_pad(coeffs, range(1, naxis + 1), pad).reshape(rows, C)
    g2 = g.reshape(n_out, C)

    def contract(h, offset):
        acc = None
        for tap in range(order + 1):
            row = offset + tap * strides[h]
            if h == naxis - 1:
                vals = torch.index_select(xf, 0, torch.clamp(base + row, 0,
                                                             rows - 1))
                gc = g2[:, 0] * vals[:, 0]
                for c in range(1, C):
                    gc = gc + g2[:, c] * vals[:, c]
                sub = [gc]
            else:
                sub = contract(h + 1, row)
            w, dw = weights[h][tap], dweights[h][tap]
            terms = [w * sub[0], dw * sub[0]] + [w * s for s in sub[1:]]
            acc = terms if acc is None else [a + t for a, t in
                                             zip(acc, terms)]
        return acc

    acc = contract(0, 0)[1:]
    out = torch.stack([
        _modes.map_coordinate_grad(cc[h], in_spatial[h], mode).reshape(n_out)
        * acc[h] for h in range(naxis)])
    out = out.reshape(naxis, B, *like.shape[2:]).transpose(0, 1)
    return _zero_outside(out, None if inside is None else inside[:, None])


def _lib():
    lib = _build.library("resample_bwd")
    if lib.ed_resample_bwd.argtypes is None:
        ll_p = ctypes.POINTER(ctypes.c_longlong)
        int_p = ctypes.POINTER(ctypes.c_int)
        shape_args = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_longlong, ll_p, ll_p, ll_p,
                      ctypes.c_longlong]
        tile_args = [ll_p, int_p, ctypes.c_int]
        fn = lib.ed_resample_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + shape_args
                       + tile_args + [ctypes.c_void_p, ctypes.c_int])
        fn = lib.ed_resample_bwd_direct
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + shape_args
                       + [ctypes.c_void_p, ctypes.c_int])
        fn = lib.ed_resample_coord_grad
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + shape_args
                       + [ctypes.c_void_p, ctypes.c_int])
        coords_args = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ll_p,
                       ctypes.c_longlong]
        fn = lib.ed_resample_coords_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + coords_args
                       + tile_args + [ctypes.c_void_p, ctypes.c_int])
        fn = lib.ed_resample_coords_bwd_direct
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + coords_args
                       + [ctypes.c_void_p, ctypes.c_int])
        fn = lib.ed_resample_coords_grad
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + coords_args
                       + [ctypes.c_void_p, ctypes.c_int])
        fn = lib.ed_resample_bwd_blocks_per_sm
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 5
        fn = lib.ed_resample_direct_blocks_per_sm
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 4
    return lib


def bwd_occupancy(dtype, order: int, naxis: int, plan: BwdPlan) -> int:
    """K3's blocks per SM on ``plan`` from CUDA's occupancy calculator
    (the launch bounds of the plan's kernel; the box's shared bytes)."""
    dt = 0 if dtype == torch.float32 else 1
    if plan.route == "direct":
        return _lib().ed_resample_direct_blocks_per_sm(dt, order, naxis,
                                                       int(plan.wide))
    return _lib().ed_resample_bwd_blocks_per_sm(dt, order, naxis,
                                                int(plan.wide), plan.smem)


def _launch_k3(g, displ, affine, offsets, order, mode, in_spatial,
               plan: BwdPlan) -> torch.Tensor:
    """K3 on ``plan`` (no counts): ``g`` ``(B, *out_spatial, C)`` to ``(B,
    *in_spatial, C)``."""
    affine = check_resample_args("resample_transpose", g, displ, affine)
    if tuple(g.shape[1:-1]) != tuple(displ.shape[2:]):
        raise ValueError("resample_transpose: g must be (B, *out_spatial, C) "
                         "with the spatial shape of displ")
    naxis, B, in_shape, out_shape, offs, a_ptr, a_stride = kernel_geometry(
        in_spatial, displ, affine, offsets)
    C = g.shape[-1]
    # the kernel adds into this zero fill
    out = torch.zeros((B, *in_spatial, C), dtype=g.dtype, device=g.device)
    lib = _lib()
    fn = lib.ed_resample_bwd_direct if plan.route == "direct" else \
        lib.ed_resample_bwd
    err = fn(
        0 if g.dtype == torch.float32 else 1, g.data_ptr(), displ.data_ptr(),
        a_ptr, out.data_ptr(), naxis, order, mode, B, C, in_shape,
        out_shape, offs, a_stride, *_tile_args(plan),
        torch.cuda.current_stream(g.device).cuda_stream, int(plan.wide))
    _build.check(err, lib, "ed_resample_bwd_error_string", "resample_bwd")
    return out


def resample_transpose(g: torch.Tensor, displ: torch.Tensor, affine, offsets,
                       order: int, mode: int, in_spatial) -> torch.Tensor:
    """The transpose of
    :func:`~elasticdeform_tpu_torch.ops.resample.resample` with respect to
    the coefficients: maps ``g`` ``(B, *out_spatial, C)`` to ``(B,
    *in_spatial, C)``. ``cval`` does not enter: the gradient path is
    linear. A CPU tensor takes :func:`resample_transpose_plain`; a CUDA
    tensor launches K3 on the plan of :func:`_bwd_plan` and adds one to
    ``resample_transpose.launches`` and to its route's count in
    ``resample_transpose.routes``.
    """
    if g.device.type == "cpu":
        return resample_transpose_plain(g, displ, affine, offsets, order,
                                        mode, in_spatial)
    plan = _bwd_plan(tuple(in_spatial), tuple(displ.shape[2:]), g.shape[-1],
                     order, g.dtype)
    out = _launch_k3(g, displ, affine, offsets, order, mode, in_spatial,
                     plan)
    resample_transpose.launches += 1
    resample_transpose.routes[plan.route] += 1
    return out


resample_transpose.launches = 0
resample_transpose.routes = {"tile": 0, "direct": 0}


def resample_coord_grad(coeffs: torch.Tensor, g: torch.Tensor,
                        displ: torch.Tensor, affine, offsets, order: int,
                        mode: int) -> torch.Tensor:
    """Gradient of ``<resample(coeffs, displ, ...), g>`` with respect to
    ``displ``, shaped like ``displ`` ``(B, naxis, *out_spatial)``.
    ``coeffs`` are the prefiltered coefficients the forward resampled. A
    CPU tensor takes :func:`resample_coord_grad_plain`; a CUDA tensor
    launches K5 and adds one to ``resample_coord_grad.launches``.
    """
    if coeffs.device.type == "cpu":
        return resample_coord_grad_plain(coeffs, g, displ, affine, offsets,
                                         order, mode)
    affine = check_resample_args("resample_coord_grad", coeffs, displ,
                                 affine)
    check_resample_args("resample_coord_grad", g, displ, None)
    if tuple(g.shape[1:-1]) != tuple(displ.shape[2:]) or \
            g.shape[-1] != coeffs.shape[-1]:
        raise ValueError("resample_coord_grad: g must be (B, *out_spatial, "
                         "C) with the spatial shape of displ and the "
                         "channels of coeffs")
    naxis, B, in_shape, out_shape, offs, a_ptr, a_stride = kernel_geometry(
        coeffs.shape[1:-1], displ, affine, offsets)
    C = coeffs.shape[-1]
    out = torch.empty_like(displ)
    lib = _lib()
    err = lib.ed_resample_coord_grad(
        0 if g.dtype == torch.float32 else 1, coeffs.data_ptr(),
        g.data_ptr(), displ.data_ptr(), a_ptr, out.data_ptr(), naxis, order,
        mode, B, C, in_shape, out_shape, offs, a_stride,
        torch.cuda.current_stream(g.device).cuda_stream,
        int(wide_indices(math.prod(coeffs.shape[1:-1]),
                         math.prod(displ.shape[2:]), C, naxis)))
    _build.check(err, lib, "ed_resample_bwd_error_string",
                 "resample_coord_grad")
    resample_coord_grad.launches += 1
    return out


resample_coord_grad.launches = 0


def _launch_k3c(g, coords, order, mode, in_spatial,
                plan: BwdPlan) -> torch.Tensor:
    """K3c on ``plan`` (no counts): ``g`` ``(B, *out_spatial, C)`` at
    ``coords`` ``(B, naxis, *out_spatial)`` to ``(B, *in_spatial, C)``."""
    C = g.shape[-1]
    # the kernel adds into this zero fill
    out = torch.zeros((g.shape[0], *in_spatial, C), dtype=g.dtype,
                      device=g.device)
    naxis, B, in_shape, n_out = check_coords_args(
        "resample_coords_transpose", out, coords)
    check_kernel_tensor(g, "resample_coords_transpose")
    if tuple(g.shape[:-1]) != (B, *coords.shape[2:]) or \
            g.dtype != coords.dtype:
        raise ValueError("resample_coords_transpose: g must be (B, "
                         "*out_spatial, C) with the shape and dtype of "
                         "coords")
    lib = _lib()
    fn = lib.ed_resample_coords_bwd_direct if plan.route == "direct" else \
        lib.ed_resample_coords_bwd
    err = fn(
        0 if g.dtype == torch.float32 else 1, g.data_ptr(),
        coords.data_ptr(), out.data_ptr(), naxis, order, mode, B, C,
        in_shape, n_out, *_tile_args(plan),
        torch.cuda.current_stream(g.device).cuda_stream, int(plan.wide))
    _build.check(err, lib, "ed_resample_bwd_error_string",
                 "resample_coords_bwd")
    return out


def resample_coords_transpose(g: torch.Tensor, coords: torch.Tensor,
                              order: int, mode: int,
                              in_spatial) -> torch.Tensor:
    """The transpose of
    :func:`~elasticdeform_tpu_torch.ops.resample.resample_coords` with
    respect to the coefficients: ``g`` ``(B, *out_spatial, C)`` to ``(B,
    *in_spatial, C)``. A CPU tensor takes
    :func:`resample_coords_transpose_plain`; a CUDA tensor launches K3c on
    the plan of :func:`_bwd_plan` (tiled in ``coords``' output shape) and
    adds one to ``resample_coords_transpose.launches`` and to its route's
    count in ``resample_coords_transpose.routes``.
    """
    if g.device.type == "cpu":
        return resample_coords_transpose_plain(g, coords, order, mode,
                                               in_spatial)
    plan = _bwd_plan(tuple(in_spatial), tuple(coords.shape[2:]),
                     g.shape[-1], order, g.dtype)
    out = _launch_k3c(g, coords, order, mode, in_spatial, plan)
    resample_coords_transpose.launches += 1
    resample_coords_transpose.routes[plan.route] += 1
    return out


resample_coords_transpose.launches = 0
resample_coords_transpose.routes = {"tile": 0, "direct": 0}


def resample_coords_grad(coeffs: torch.Tensor, g: torch.Tensor,
                         coords: torch.Tensor, order: int,
                         mode: int) -> torch.Tensor:
    """Gradient of ``<resample_coords(coeffs, coords, ...), g>`` with
    respect to ``coords``, shaped like ``coords`` ``(B, naxis,
    *out_spatial)``. A CPU tensor takes :func:`resample_coords_grad_plain`;
    a CUDA tensor launches K5c and adds one to
    ``resample_coords_grad.launches``.
    """
    if coeffs.device.type == "cpu":
        return resample_coords_grad_plain(coeffs, g, coords, order, mode)
    naxis, B, in_shape, n_out = check_coords_args("resample_coords_grad",
                                                  coeffs, coords)
    C = coeffs.shape[-1]
    check_kernel_tensor(g, "resample_coords_grad")
    if tuple(g.shape) != (B, *coords.shape[2:], C) or \
            g.dtype != coords.dtype:
        raise ValueError("resample_coords_grad: g must be (B, *out_spatial, "
                         "C) with the shape and dtype of coords and the "
                         "channels of coeffs")
    out = torch.empty_like(coords)
    lib = _lib()
    err = lib.ed_resample_coords_grad(
        0 if g.dtype == torch.float32 else 1, coeffs.data_ptr(),
        g.data_ptr(), coords.data_ptr(), out.data_ptr(), naxis, order, mode,
        B, C, in_shape, n_out,
        torch.cuda.current_stream(g.device).cuda_stream,
        int(wide_indices(math.prod(coeffs.shape[1:-1]), n_out, C, naxis)))
    _build.check(err, lib, "ed_resample_bwd_error_string",
                 "resample_coords_grad")
    resample_coords_grad.launches += 1
    return out


resample_coords_grad.launches = 0
