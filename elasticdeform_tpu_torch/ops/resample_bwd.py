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

Layouts are those of :mod:`~elasticdeform_tpu_torch.ops.resample`. On a CPU
tensor each wrapper takes its plain version; on a CUDA tensor it launches
its kernel or raises, and adds one to its ``.launches`` counter. The
kernels take float32 and float64; complex, float16 and bfloat16 raise
TypeError at the entry points.
"""

from __future__ import annotations

import ctypes
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
        shape_args = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_longlong, ll_p, ll_p, ll_p,
                      ctypes.c_longlong, ctypes.c_void_p]
        fn = lib.ed_resample_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + shape_args
        fn = lib.ed_resample_coord_grad
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + shape_args
                       + [ctypes.c_int])
        coords_args = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ll_p,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn = lib.ed_resample_coords_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + coords_args
        fn = lib.ed_resample_coords_grad
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + coords_args
                       + [ctypes.c_int])
    return lib


def resample_transpose(g: torch.Tensor, displ: torch.Tensor, affine, offsets,
                       order: int, mode: int, in_spatial) -> torch.Tensor:
    """The transpose of
    :func:`~elasticdeform_tpu_torch.ops.resample.resample` with respect to
    the coefficients: maps ``g`` ``(B, *out_spatial, C)`` to ``(B,
    *in_spatial, C)``. ``cval`` does not enter: the gradient path is
    linear. A CPU tensor takes :func:`resample_transpose_plain`; a CUDA
    tensor launches K3 and adds one to ``resample_transpose.launches``.
    """
    if g.device.type == "cpu":
        return resample_transpose_plain(g, displ, affine, offsets, order,
                                        mode, in_spatial)
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
    err = lib.ed_resample_bwd(
        0 if g.dtype == torch.float32 else 1, g.data_ptr(), displ.data_ptr(),
        a_ptr, out.data_ptr(), naxis, order, mode, B, C, in_shape,
        out_shape, offs, a_stride,
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, lib, "ed_resample_bwd_error_string", "resample_bwd")
    resample_transpose.launches += 1
    return out


resample_transpose.launches = 0


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


def resample_coords_transpose(g: torch.Tensor, coords: torch.Tensor,
                              order: int, mode: int,
                              in_spatial) -> torch.Tensor:
    """The transpose of
    :func:`~elasticdeform_tpu_torch.ops.resample.resample_coords` with
    respect to the coefficients: ``g`` ``(B, *out_spatial, C)`` to ``(B,
    *in_spatial, C)``. A CPU tensor takes
    :func:`resample_coords_transpose_plain`; a CUDA tensor launches K3c and
    adds one to ``resample_coords_transpose.launches``.
    """
    if g.device.type == "cpu":
        return resample_coords_transpose_plain(g, coords, order, mode,
                                               in_spatial)
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
    err = lib.ed_resample_coords_bwd(
        0 if g.dtype == torch.float32 else 1, g.data_ptr(),
        coords.data_ptr(), out.data_ptr(), naxis, order, mode, B, C,
        in_shape, n_out, torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, lib, "ed_resample_bwd_error_string",
                 "resample_coords_bwd")
    resample_coords_transpose.launches += 1
    return out


resample_coords_transpose.launches = 0


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
