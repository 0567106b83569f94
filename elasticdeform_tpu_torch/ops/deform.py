"""Forward deformation: the per-call pipeline over one or more inputs.

Counterpart of the JAX package's ``ops/deform.py`` (forward path only).
For a batch of samples with per-sample control grids:

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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from elasticdeform_tpu_torch.ops.displacement import dense_displacement
from elasticdeform_tpu_torch.ops.prefilter import spline_filter1d
from elasticdeform_tpu_torch.ops.resample import cast_output, resample


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Static per-input configuration."""
    shape: Tuple[int, ...]        # full (uncropped) per-sample input shape
    dtype: str                    # numpy dtype name of the input
    axis: Tuple[int, ...]         # deformed axes, sorted
    order: int                    # 0-5
    mode: int                     # boundary mode code
    cval: float


@dataclasses.dataclass(frozen=True)
class DeformSpec:
    """Static call configuration shared by all inputs."""
    inputs: Tuple[InputSpec, ...]
    deform_shape: Tuple[int, ...]   # uncropped extent over deformed axes
    out_spatial: Tuple[int, ...]    # cropped output extent over deformed axes
    offsets: Tuple[int, ...]        # crop offsets per deformed axis
    prefilter: bool
    compute_dtype: str


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


def _to_spatial_channels(x: torch.Tensor, ispec: InputSpec):
    """``(B, *shape)`` -> ``(B, *deform_spatial, C)``."""
    perm, _, chan_shape = _split_axes(ispec)
    spatial = tuple(ispec.shape[d] for d in ispec.axis)
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


def deform_apply_batched(xs, displacement: torch.Tensor, affine,
                         spec: DeformSpec):
    """Forward deformation of a batch with per-sample control grids.

    ``xs[i]``: ``(B, *shape_i)`` tensors on one device; ``displacement``:
    ``(B, naxis, *points)``; ``affine``: None, a shared ``(naxis, naxis+1)``
    or a per-sample ``(B, naxis, naxis+1)`` inverse affine (array or
    tensor). Returns the list of ``(B, *out_shape_i)`` outputs.
    """
    cdt = getattr(torch, spec.compute_dtype)
    displ = dense_displacement(displacement.to(cdt), spec.out_spatial,
                               spec.deform_shape, spec.offsets)
    if affine is not None:
        affine = torch.as_tensor(affine, dtype=cdt, device=displ.device)
    ys = []
    for x, ispec in zip(xs, spec.inputs):
        xf = _prefilter_input(_to_spatial_channels(x, ispec), ispec, spec,
                              cdt)
        y = resample(xf, displ, affine, spec.offsets, ispec.order,
                     ispec.mode, ispec.cval)
        y = cast_output(y, ispec.dtype)
        ys.append(_from_spatial_channels(y, ispec, spec.out_spatial))
    return ys


def deform_apply(xs, displacement: torch.Tensor, affine, spec: DeformSpec):
    """Forward deformation of single samples: :func:`deform_apply_batched`
    with a batch of one."""
    ys = deform_apply_batched([x[None] for x in xs], displacement[None],
                              affine, spec)
    return [y[0] for y in ys]
