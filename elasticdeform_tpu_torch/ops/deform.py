"""Deformation: the per-call pipeline over one or more inputs, and its
exact adjoints.

Counterpart of the JAX package's ``ops/deform.py``. Forward, for a batch of
samples with per-sample control grids:

1. the raw control grids become a dense displacement field
   (:func:`~elasticdeform_tpu_torch.ops.displacement.dense_displacement`,
   the grid prefilter composed in, reference deform_grid.py:165-169 and
   deform.c:639-758), once for all inputs;
2. per input, channels go last, ``(B, *spatial, C)``, and the input is
   prefiltered along each deformed axis for ``order > 1`` (kernel K2,
   reference deform_grid.py:154-164), with the reference's per-axis integer
   writeback for integer inputs;
3. kernel K1 resamples it at ``affine(j) + offset + displacement`` with the
   boundary mode and cval (reference deform.c:768-903);
4. the result is cast to the input dtype by the reference's rules
   (deform.c:906-924) and put back in the input's axis order.

The gradient with respect to the inputs is the transpose of the linear
part, run backward (reference deform_grid.py:274-286, deform.c:926-997 and
1049-1168): kernel K3 scatters the output cotangent into the coefficients,
kernel K4 applies the transposed prefilter along each axis in reverse
order, and the result is cast to the cotangent's dtype. The path has no
integer writeback. The gradient with respect to the control grids is
kernel K5 per input, summed over the inputs, then the transpose of step 1.

The general resampler (``map_coordinates`` and its family, the JAX
package's ``ops/deform.py:533-635``) runs the same stages at caller-given
coordinates: the prefilter without the integer writeback (scipy's
``map_coordinates`` filters integer inputs in float), kernel K1c, the cast.
Its two autograd functions compose under autograd with any torch glue
around them: :class:`ResampleAt` (K1c; backward K3c to the coefficients,
K5c to the coordinates) and :class:`Prefilter1d` (K2 or K6; backward K4 or
K7).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from elasticdeform_tpu_torch.ops.displacement import (
    dense_displacement, dense_displacement_transpose,
)
from torch.autograd.function import once_differentiable

from elasticdeform_tpu_torch.ops.prefilter import (
    spline_filter1d, spline_filter1d_bc, spline_filter1d_bc_transpose,
    spline_filter1d_transpose,
)
from elasticdeform_tpu_torch.ops.resample import (
    cast_output, narrowed, resample, resample_coords,
)
from elasticdeform_tpu_torch.ops.resample_bwd import (
    resample_coord_grad, resample_coords_grad, resample_coords_transpose,
    resample_transpose,
)


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Static per-input configuration."""
    shape: Tuple[int, ...]        # full (uncropped) per-sample input shape
    dtype: str                    # numpy dtype name of the input
    axis: Tuple[int, ...]         # deformed axes, sorted
    order: int                    # 0-5
    mode: int                     # boundary mode code
    cval: float
    out_shape: Tuple[int, ...]    # full (cropped) per-sample output shape


@dataclasses.dataclass(frozen=True)
class DeformSpec:
    """Static call configuration shared by all inputs."""
    inputs: Tuple[InputSpec, ...]
    deform_shape: Tuple[int, ...]   # uncropped extent over deformed axes
    out_spatial: Tuple[int, ...]    # cropped output extent over deformed axes
    offsets: Tuple[int, ...]        # crop offsets per deformed axis
    prefilter: bool
    compute_dtype: str
    # the dtype K1/K1c read the coefficients in, "" for compute_dtype: the
    # opt-in narrow window table of the JAX package (``table_dtype=``)
    table_dtype: str = ""


def default_compute_dtype(*dtypes) -> str:
    """float64 if any operand is 64-bit, else float32: the JAX package's
    rule with x64 enabled. ``dtypes`` are numpy dtypes."""
    if any(np.dtype(d).itemsize >= 8 and np.dtype(d).kind in "fiu"
           for d in dtypes):
        return "float64"
    return "float32"


def _split_axes(ispec: InputSpec):
    """Deformed-axes-first permutation and channel shape for one input."""
    ndim = len(ispec.shape)
    channels = tuple(d for d in range(ndim) if d not in ispec.axis)
    perm = tuple(ispec.axis) + channels
    inv_perm = tuple(int(i) for i in np.argsort(perm))
    chan_shape = tuple(ispec.shape[d] for d in channels)
    return perm, inv_perm, chan_shape


def _to_spatial_channels(x: torch.Tensor, ispec: InputSpec, shape=None):
    """``(B, *shape)`` -> ``(B, *deform_spatial, C)``; ``shape`` defaults
    to the input's, the output cotangent passes ``ispec.out_shape``."""
    perm, _, chan_shape = _split_axes(ispec)
    shape = ispec.shape if shape is None else shape
    spatial = tuple(shape[d] for d in ispec.axis)
    xt = x.permute(0, *(p + 1 for p in perm))
    return xt.reshape(x.shape[0], *spatial, max(math.prod(chan_shape), 1))


def _from_spatial_channels(y: torch.Tensor, ispec: InputSpec, out_spatial):
    """Inverse of :func:`_to_spatial_channels` for the output."""
    _, inv_perm, chan_shape = _split_axes(ispec)
    y = y.reshape(y.shape[0], *out_spatial, *chan_shape)
    return y.permute(0, *(p + 1 for p in inv_perm)).contiguous()


def _prefilter_input(xt: torch.Tensor, ispec: InputSpec, spec: DeformSpec,
                     cdt: torch.dtype) -> torch.Tensor:
    """Per-axis input prefilter (reference deform_grid.py:154-164).

    The reference writes each axis's result into an array of the input
    dtype, so integer inputs are C-cast after every axis (truncate, wrap
    modulo 2**bits): K2 fuses that writeback.
    """
    xf = xt.to(cdt).contiguous()
    if spec.prefilter and ispec.order > 1:
        int_dtype = ispec.dtype if np.dtype(ispec.dtype).kind in "bui" \
            else None
        for d in range(len(ispec.axis)):
            xf = spline_filter1d(xf, ispec.order, d + 1, int_dtype)
    return xf


def _table(spec: DeformSpec):
    """The narrow table dtype of a call as a torch dtype, or None."""
    return getattr(torch, spec.table_dtype) if spec.table_dtype else None


def _setup(displacement: torch.Tensor, affine, spec: DeformSpec):
    """Compute dtype, dense displacement and affine tensor of a call."""
    cdt = getattr(torch, spec.compute_dtype)
    displ = dense_displacement(displacement.to(cdt), spec.out_spatial,
                               spec.deform_shape, spec.offsets)
    if affine is not None:
        affine = torch.as_tensor(affine, dtype=cdt, device=displ.device)
    return cdt, displ, affine


def deform_forward(xs, displacement: torch.Tensor, affine, spec: DeformSpec,
                   keep_coeffs: bool = False):
    """Forward deformation of a batch, returning ``(ys, displ, affine,
    coeffs)``: the outputs, the dense displacement and affine tensor it
    used, and, if ``keep_coeffs``, each input's prefiltered coefficients
    ``(B, *spatial, C)`` for the displacement gradient (else None)."""
    cdt, displ, affine = _setup(displacement, affine, spec)
    table = _table(spec)
    ys, coeffs = [], []
    for x, ispec in zip(xs, spec.inputs):
        xf = _prefilter_input(_to_spatial_channels(x, ispec), ispec, spec,
                              cdt)
        y = resample(xf, displ, affine, spec.offsets, ispec.order,
                     ispec.mode, ispec.cval, table)
        y = cast_output(y, ispec.dtype)
        ys.append(_from_spatial_channels(y, ispec, spec.out_spatial))
        coeffs.append(narrowed(xf, table) if keep_coeffs else None)
    return ys, displ, affine, (coeffs if keep_coeffs else None)


def deform_apply_batched(xs, displacement: torch.Tensor, affine,
                         spec: DeformSpec):
    """Forward deformation of a batch with per-sample control grids.

    ``xs[i]``: ``(B, *shape_i)`` tensors on one device; ``displacement``:
    ``(B, naxis, *points)``; ``affine``: None, a shared ``(naxis, naxis+1)``
    or a per-sample ``(B, naxis, naxis+1)`` inverse affine (array or
    tensor). Returns the list of ``(B, *out_shape_i)`` outputs.
    """
    return deform_forward(xs, displacement, affine, spec)[0]


def deform_apply(xs, displacement: torch.Tensor, affine, spec: DeformSpec):
    """Forward deformation of single samples: :func:`deform_apply_batched`
    with a batch of one."""
    ys = deform_apply_batched([x[None] for x in xs], displacement[None],
                              affine, spec)
    return [y[0] for y in ys]


def input_gradient(dy: torch.Tensor, ispec: InputSpec, spec: DeformSpec,
                   displ: torch.Tensor, affine, cdt) -> torch.Tensor:
    """The transpose of one input's forward: ``dy`` ``(B, *out_shape)`` to
    ``(B, *shape)`` in ``ispec.dtype`` (K3, then K4 per axis in reverse
    order, then the cast)."""
    g = _to_spatial_channels(dy, ispec, ispec.out_shape).to(cdt).contiguous()
    spatial = tuple(ispec.shape[d] for d in ispec.axis)
    dxt = resample_transpose(g, displ, affine, spec.offsets, ispec.order,
                             ispec.mode, spatial)
    if spec.prefilter and ispec.order > 1:
        for d in range(len(spatial) - 1, -1, -1):
            dxt = spline_filter1d_transpose(dxt, ispec.order, d + 1)
    return _from_spatial_channels(cast_output(dxt, ispec.dtype), ispec,
                                  spatial)


def deform_gradient_apply_batched(dys, displacement: torch.Tensor, affine,
                                  spec: DeformSpec):
    """Exact adjoint of :func:`deform_apply_batched` with respect to the
    inputs: ``dys[i]`` ``(B, *out_shape_i)`` output cotangents to ``(B,
    *shape_i)`` input cotangents with ``spec.inputs[i].dtype`` (the JAX
    package's ``deform_gradient_apply``, ``ops/deform.py:499``)."""
    cdt, displ, affine = _setup(displacement, affine, spec)
    return [input_gradient(dy, ispec, spec, displ, affine, cdt)
            for dy, ispec in zip(dys, spec.inputs)]


def deform_gradient_apply(dys, displacement: torch.Tensor, affine,
                          spec: DeformSpec):
    """:func:`deform_gradient_apply_batched` for single samples."""
    dxs = deform_gradient_apply_batched([dy[None] for dy in dys],
                                        displacement[None], affine, spec)
    return [dx[0] for dx in dxs]


def grid_gradient(coeffs, dys, displ, affine, spec: DeformSpec, points,
                  dtype) -> torch.Tensor:
    """Gradient with respect to the raw control grids ``(B, naxis,
    *points)``, in ``dtype``: K5 for each input whose coefficients and
    cotangent are given (not None), summed, then the transpose of the
    dense displacement. Integer and bool outputs are rounded, so they are
    not differentiable and add nothing, as under ``jax.grad``."""
    cdt = displ.dtype
    total = None
    for xf, dy, ispec in zip(coeffs, dys, spec.inputs):
        if xf is None or dy is None or np.dtype(ispec.dtype).kind in "biu":
            continue
        g = _to_spatial_channels(dy, ispec, ispec.out_shape).to(cdt)
        d = resample_coord_grad(xf, g.contiguous(), displ, affine,
                                spec.offsets, ispec.order, ispec.mode)
        total = d if total is None else total + d
    if total is None:
        total = torch.zeros_like(displ)
    return dense_displacement_transpose(
        total, points, spec.deform_shape, spec.offsets).to(dtype)


class ResampleAt(torch.autograd.Function):
    """:func:`~elasticdeform_tpu_torch.ops.resample.resample_coords` (K1c)
    as an autograd function of the coefficients ``(B, *spatial, C)`` and
    the coordinates ``(B, naxis, *out)``, both contiguous in one dtype,
    with the narrow table ``table`` (a torch dtype or None). The backward
    runs K3c for the coefficients and K5c for the coordinates, each only
    when asked; it is not itself differentiable. As in the JAX package the
    cast to the narrow table passes the coefficients' cotangent unchanged,
    and K5c reads the narrowed coefficients."""

    @staticmethod
    def forward(ctx, coeffs, coords, order, mode, cval, table=None):
        ctx.order, ctx.mode = order, mode
        ctx.in_spatial = tuple(coeffs.shape[1:-1])
        # the coefficients are kept only for K5c
        ctx.save_for_backward(
            coords,
            narrowed(coeffs, table) if ctx.needs_input_grad[1] else None)
        return resample_coords(coeffs, coords, order, mode, cval, table)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        coords, coeffs = ctx.saved_tensors
        g = g.contiguous()
        d_coeffs = d_coords = None
        if ctx.needs_input_grad[0]:
            d_coeffs = resample_coords_transpose(g, coords, ctx.order,
                                                 ctx.mode, ctx.in_spatial)
        if ctx.needs_input_grad[1]:
            d_coords = resample_coords_grad(coeffs, g, coords, ctx.order,
                                            ctx.mode)
        return d_coeffs, d_coords, None, None, None, None


class Prefilter1d(torch.autograd.Function):
    """The spline prefilter of a contiguous tensor along ``axis`` with the
    boundary condition ``bc`` (``'mirror'``: K2, ``'reflect'`` or
    ``'wrap'``: K6) as an autograd function; the backward is its exact
    transpose (K4 or K7). Orders 0 and 1 are not passed here."""

    @staticmethod
    def forward(ctx, x, order, axis, bc):
        ctx.order, ctx.axis, ctx.bc = order, axis, bc
        if bc == "mirror":
            return spline_filter1d(x, order, axis)
        return spline_filter1d_bc(x, order, axis, bc)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.bc == "mirror":
            d = spline_filter1d_transpose(g, ctx.order, ctx.axis)
        else:
            d = spline_filter1d_bc_transpose(g, ctx.order, ctx.axis, ctx.bc)
        return d, None, None, None


def _map_output(y: torch.Tensor, ispec: InputSpec, spatial):
    """``(B, *spatial, C)`` to the caller's layout: the channel axes put
    back where the input had them, or, with none, ``(B, *spatial)`` of any
    rank."""
    if len(ispec.shape) > len(ispec.axis):
        return _from_spatial_channels(y, ispec, spatial)
    return y.reshape(y.shape[0], *spatial)


def map_coordinates_apply_batched(x: torch.Tensor, coords: torch.Tensor,
                                  spec: DeformSpec) -> torch.Tensor:
    """Resample ``x`` ``(B, *shape)`` at per-sample coordinates ``(B,
    naxis, *out_spatial)``: the mirror prefilter in the compute dtype with
    no integer writeback, K1c, the cast (the JAX package's
    ``map_coordinates_apply_batched``). Differentiable with respect to
    ``x`` and ``coords``."""
    cdt = getattr(torch, spec.compute_dtype)
    ispec = spec.inputs[0]
    xt = _to_spatial_channels(x, ispec).to(cdt).contiguous()
    if spec.prefilter and ispec.order > 1:
        for d in range(len(ispec.axis)):
            xt = Prefilter1d.apply(xt, ispec.order, d + 1, "mirror")
    y = ResampleAt.apply(xt, coords.to(cdt).contiguous(), ispec.order,
                         ispec.mode, ispec.cval, _table(spec))
    return _map_output(cast_output(y, ispec.dtype), ispec, spec.out_spatial)


def map_coordinates_gradient_apply_batched(dy: torch.Tensor,
                                           coords: torch.Tensor,
                                           spec: DeformSpec) -> torch.Tensor:
    """Exact adjoint of :func:`map_coordinates_apply_batched` with respect
    to ``x``, with no forward pass: K3c, then K4 along each axis in reverse
    order, then the cast to ``spec.inputs[0].dtype`` (the JAX package's
    ``map_coordinates_gradient_apply``)."""
    cdt = getattr(torch, spec.compute_dtype)
    ispec = spec.inputs[0]
    spatial = tuple(ispec.shape[d] for d in ispec.axis)
    if len(ispec.shape) > len(ispec.axis):
        g = _to_spatial_channels(dy, ispec, ispec.out_shape)
    else:
        g = dy.reshape(dy.shape[0], *spec.out_spatial, 1)
    dxt = resample_coords_transpose(g.to(cdt).contiguous(),
                                    coords.to(cdt).contiguous(), ispec.order,
                                    ispec.mode, spatial)
    if spec.prefilter and ispec.order > 1:
        for d in range(len(spatial) - 1, -1, -1):
            dxt = spline_filter1d_transpose(dxt, ispec.order, d + 1)
    return _map_output(cast_output(dxt, ispec.dtype), ispec, spatial)
