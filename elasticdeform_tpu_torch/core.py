"""Tensor API: elastic deformation of torch tensors on the card.

Counterparts of the JAX package's ``core.deform`` and ``core.deform_batch``
with the same keywords, less the TPU-only ``strategy``, ``table_dtype`` and
``batch_impl``, plus ``device``: ``None`` means ``"cuda"``; the CPU runs
only when the caller passes ``device="cpu"``. Inputs are moved to that
device; outputs are tensors there, with the input dtypes.

Gradients are not implemented yet: an input that requires grad raises
NotImplementedError rather than giving a detached result.
"""

from __future__ import annotations

import numpy as np
import torch

from elasticdeform_tpu_torch import _normalize as _n
from elasticdeform_tpu_torch.ops.deform import (
    deform_apply, deform_apply_batched,
)


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if x.requires_grad:
            raise NotImplementedError(
                "elasticdeform_tpu_torch does not differentiate yet: the "
                "gradient w.r.t. X and the displacement comes with the "
                "port's second slice (see ROADMAP.md); pass tensors that "
                "do not require grad")
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def _prepare(X, displacement, order, mode, cval, crop, prefilter, axis,
             affine, rotate, zoom):
    Xs = _n.normalize_inputs(X)
    axis, deform_shape = _n.normalize_axis_list(axis, Xs)
    output_shapes, output_offset = _n.compute_output_shapes(
        Xs, axis, deform_shape, crop)
    displacement = _n.normalize_displacement(displacement, Xs, axis)
    orders = _n.normalize_order(order, Xs)
    modes = _n.normalize_mode(mode, Xs)
    cvals = _n.normalize_cval(cval, Xs)
    inv_affine = _n.resolve_affine(affine, rotate, zoom, axis, output_shapes)
    spec = _n.build_spec(Xs, axis, deform_shape, output_shapes, output_offset,
                         orders, modes, cvals, prefilter,
                         displacement.dtype)
    return Xs, displacement, inv_affine, spec


def deform(X, displacement, *, order=3, mode='constant', cval=0.0, crop=None,
           prefilter=True, axis=None, affine=None, rotate=None, zoom=None,
           device=None):
    """Elastic deformation of a tensor (or list of tensors) with a
    control-point displacement grid ``(naxis, *points)``.

    Parameters and semantics are those of
    :func:`elasticdeform_tpu_torch.deform_grid`; ``X`` and
    ``displacement`` may be tensors or numpy arrays. Returns tensors on
    ``device`` (default ``"cuda"``) with the input dtypes.
    """
    Xs, displacement, inv_affine, spec = _prepare(
        X, displacement, order, mode, cval, crop, prefilter, axis, affine,
        rotate, zoom)
    dev = _device(device)
    ys = deform_apply([_to_device(x, dev) for x in Xs],
                      _to_device(displacement, dev), inv_affine, spec)
    return ys if isinstance(X, list) else ys[0]


class _Shaped:
    """Shape-and-dtype stand-in for one sample of a batch."""

    def __init__(self, shape, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.ndim = len(self.shape)
        self.dtype = dtype


def _prepare_batch(X, displacement, order, mode, cval, crop, prefilter,
                   axis, affine, rotate, zoom):
    """Normalize a batched call on the per-sample shapes; returns
    ``(Xs, inv_affine, spec)``."""
    Xs = _n.normalize_inputs(X)
    B = int(Xs[0].shape[0])
    _n._check(all(int(x.shape[0]) == B for x in Xs),
              'All inputs should have the same batch size.')
    _n._check(int(displacement.shape[0]) == B,
              'displacement must have a leading batch axis matching X.')
    samples = [_Shaped(x.shape[1:], x.dtype) for x in Xs]
    axis_n, deform_shape = _n.normalize_axis_list(axis, samples)
    output_shapes, output_offset = _n.compute_output_shapes(
        samples, axis_n, deform_shape, crop)
    _n.normalize_displacement(
        _Shaped(displacement.shape[1:], displacement.dtype), samples, axis_n)
    orders = _n.normalize_order(order, samples)
    modes = _n.normalize_mode(mode, samples)
    cvals = _n.normalize_cval(cval, samples)
    inv_affine = _n.resolve_affine(affine, rotate, zoom, axis_n,
                                   output_shapes)
    spec = _n.build_spec(samples, axis_n, deform_shape, output_shapes,
                         output_offset, orders, modes, cvals, prefilter,
                         displacement.dtype)
    return Xs, inv_affine, spec


def deform_batch(X, displacement, *, order=3, mode='constant', cval=0.0,
                 crop=None, prefilter=True, axis=None, affine=None,
                 rotate=None, zoom=None, device=None):
    """Batched elastic deformation with per-sample displacement grids.

    ``X``: ``(B, *image_shape)`` tensor (or list of such tensors sharing the
    deformation); ``displacement``: ``(B, naxis, *points)``. The other
    parameters are shared by the batch and follow :func:`deform`
    (``axis``/``crop`` refer to the per-sample shape).
    """
    Xs, inv_affine, spec = _prepare_batch(
        X, displacement, order, mode, cval, crop, prefilter, axis, affine,
        rotate, zoom)
    dev = _device(device)
    ys = deform_apply_batched([_to_device(x, dev) for x in Xs],
                              _to_device(displacement, dev), inv_affine, spec)
    return ys if isinstance(X, list) else ys[0]
