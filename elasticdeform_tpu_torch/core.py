"""Tensor API: elastic deformation of torch tensors on the card, and its
exact adjoint.

Counterparts of the JAX package's ``core.deform``, ``deform_gradient``,
``deform_batch`` and ``deform_batch_gradient`` with the same keywords, less
the TPU-only ``strategy``, ``table_dtype`` and ``batch_impl``, plus
``device``: ``None`` means ``"cuda"``; the CPU runs only when the caller
passes ``device="cpu"``. Inputs are moved to that device; outputs are
tensors there, with the input dtypes.

:func:`deform` and :func:`deform_batch` are differentiable with respect to
``X`` and the displacement grid: when any of them requires grad, the call
goes through a ``torch.autograd.Function`` whose backward runs the
transposed pipeline (kernels K3 and K4) for the inputs and kernel K5 for
the grid, each only when it is asked for. The backward is not itself
differentiable (no double backward), and there is no gradient with respect
to the affine, which is a host-side constant as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from elasticdeform_tpu_torch import _normalize as _n
from elasticdeform_tpu_torch.ops import deform as _d


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


class _Deform(torch.autograd.Function):
    """:func:`~elasticdeform_tpu_torch.ops.deform.deform_apply_batched` as
    an autograd function of the control grids and the inputs."""

    @staticmethod
    def forward(ctx, affine, spec, displacement, *xs):
        want_grid = ctx.needs_input_grad[2]
        # with a grid gradient to come, the prefiltered coefficients are
        # kept for K5: one copy of each input in the compute dtype (67 MB
        # for 64 x 64^3 float32)
        ys, displ, affine_t, coeffs = _d.deform_forward(
            xs, displacement, affine, spec, keep_coeffs=want_grid)
        ctx.spec = spec
        ctx.grid_shape = displacement.shape
        ctx.grid_dtype = displacement.dtype
        ctx.has_affine = affine_t is not None
        ctx.n_coeffs = len(coeffs) if want_grid else 0
        saved = [displ] + ([affine_t] if ctx.has_affine else []) + \
            (coeffs if want_grid else [])
        ctx.save_for_backward(*saved)
        ctx.mark_non_differentiable(
            *[y for y in ys if not y.dtype.is_floating_point])
        ctx.set_materialize_grads(False)
        return tuple(ys)

    @staticmethod
    @once_differentiable
    def backward(ctx, *gys):
        spec = ctx.spec
        saved = ctx.saved_tensors
        displ = saved[0]
        affine = saved[1] if ctx.has_affine else None
        coeffs = saved[len(saved) - ctx.n_coeffs:] if ctx.n_coeffs else None
        d_grid = None
        if ctx.needs_input_grad[2]:
            d_grid = _d.grid_gradient(coeffs, gys, displ, affine, spec,
                                      ctx.grid_shape[2:], ctx.grid_dtype)
        d_xs = []
        for i, (gy, ispec) in enumerate(zip(gys, spec.inputs)):
            if gy is None or not ctx.needs_input_grad[3 + i]:
                d_xs.append(None)
            else:
                d_xs.append(_d.input_gradient(gy, ispec, spec, displ, affine,
                                              displ.dtype))
        return (None, None, d_grid, *d_xs)


def _apply(xs, displacement: torch.Tensor, affine, spec):
    """The batched forward, through :class:`_Deform` when a gradient may be
    asked for."""
    if torch.is_grad_enabled() and (
            displacement.requires_grad or any(x.requires_grad for x in xs)):
        return list(_Deform.apply(affine, spec, displacement, *xs))
    return _d.deform_apply_batched(xs, displacement, affine, spec)


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
    ``device`` (default ``"cuda"``) with the input dtypes, differentiable
    with respect to ``X`` and ``displacement`` where they require grad.
    """
    Xs, displacement, inv_affine, spec = _prepare(
        X, displacement, order, mode, cval, crop, prefilter, axis, affine,
        rotate, zoom)
    dev = _device(device)
    ys = _apply([_to_device(x, dev)[None] for x in Xs],
                _to_device(displacement, dev)[None], inv_affine, spec)
    ys = [y[0] for y in ys]
    return ys if isinstance(X, list) else ys[0]


def deform_gradient(dY, displacement, *, order=3, mode='constant', cval=0.0,
                    crop=None, prefilter=True, axis=None, X_shape=None,
                    affine=None, rotate=None, zoom=None, device=None):
    """Exact adjoint of :func:`deform` with respect to the inputs.

    Maps output cotangents ``dY`` (tensor, array or list) to input
    cotangents with the dtypes of ``dY`` and the uncropped shapes
    ``X_shape``, which is required with ``crop``; every other parameter
    must be the forward call's (see
    :func:`elasticdeform_tpu_torch.deform_grid_gradient`). Runs kernels K3
    and K4 on the card (``device=None`` means ``"cuda"``).
    """
    dYs = _n.normalize_inputs(dY)
    Xs = _n.gradient_inputs(dYs, X_shape, crop)
    axis, deform_shape = _n.normalize_axis_list(axis, Xs)
    output_shapes, output_offset = _n.compute_output_shapes(
        Xs, axis, deform_shape, crop)
    _n.check_gradient_shapes(output_shapes, dYs)
    displacement = _n.normalize_displacement(displacement, dYs, axis)
    orders = _n.normalize_order(order, dYs)
    modes = _n.normalize_mode(mode, dYs)
    cvals = _n.normalize_cval(cval, dYs)
    inv_affine = _n.resolve_affine(affine, rotate, zoom, axis, output_shapes)
    spec = _n.build_spec(Xs, axis, deform_shape, output_shapes, output_offset,
                         orders, modes, cvals, prefilter, displacement.dtype)
    dev = _device(device)
    dxs = _d.deform_gradient_apply([_to_device(dy, dev) for dy in dYs],
                                   _to_device(displacement, dev), inv_affine,
                                   spec)
    return dxs if isinstance(dY, list) else dxs[0]


def _prepare_batch(X, displacement, order, mode, cval, crop, prefilter,
                   axis, affine, rotate, zoom):
    """Normalize a batched call on the per-sample shapes; returns
    ``(Xs, inv_affine, spec, output_shapes)``."""
    Xs = _n.normalize_inputs(X)
    B = int(Xs[0].shape[0])
    _n._check(all(int(x.shape[0]) == B for x in Xs),
              'All inputs should have the same batch size.')
    _n._check(int(displacement.shape[0]) == B,
              'displacement must have a leading batch axis matching X.')
    samples = [_n.Shaped(x.shape[1:], x.dtype) for x in Xs]
    axis_n, deform_shape = _n.normalize_axis_list(axis, samples)
    output_shapes, output_offset = _n.compute_output_shapes(
        samples, axis_n, deform_shape, crop)
    _n.normalize_displacement(
        _n.Shaped(displacement.shape[1:], displacement.dtype), samples,
        axis_n)
    orders = _n.normalize_order(order, samples)
    modes = _n.normalize_mode(mode, samples)
    cvals = _n.normalize_cval(cval, samples)
    inv_affine = _n.resolve_affine(affine, rotate, zoom, axis_n,
                                   output_shapes)
    spec = _n.build_spec(samples, axis_n, deform_shape, output_shapes,
                         output_offset, orders, modes, cvals, prefilter,
                         displacement.dtype)
    return Xs, inv_affine, spec, output_shapes


def deform_batch(X, displacement, *, order=3, mode='constant', cval=0.0,
                 crop=None, prefilter=True, axis=None, affine=None,
                 rotate=None, zoom=None, device=None):
    """Batched elastic deformation with per-sample displacement grids.

    ``X``: ``(B, *image_shape)`` tensor (or list of such tensors sharing the
    deformation); ``displacement``: ``(B, naxis, *points)``. The other
    parameters are shared by the batch and follow :func:`deform`
    (``axis``/``crop`` refer to the per-sample shape). Differentiable with
    respect to ``X`` and ``displacement``.
    """
    Xs, inv_affine, spec, _ = _prepare_batch(
        X, displacement, order, mode, cval, crop, prefilter, axis, affine,
        rotate, zoom)
    dev = _device(device)
    ys = _apply([_to_device(x, dev) for x in Xs],
                _to_device(displacement, dev), inv_affine, spec)
    return ys if isinstance(X, list) else ys[0]


def deform_batch_gradient(dY, displacement, *, order=3, mode='constant',
                          cval=0.0, crop=None, prefilter=True, axis=None,
                          X_shape=None, affine=None, rotate=None, zoom=None,
                          device=None):
    """Exact adjoint of :func:`deform_batch` with respect to the inputs:
    batched output cotangents ``dY`` ``(B, *output_shape)`` (or a list) to
    batched input cotangents, given the per-sample grids ``(B, naxis,
    *points)`` of the forward call. ``X_shape`` is the per-sample uncropped
    input shape(s), required with ``crop``; see :func:`deform_gradient`.
    """
    dYs = _n.normalize_inputs(dY)
    B = int(dYs[0].shape[0])
    if int(displacement.shape[0]) != B:
        raise ValueError(
            "displacement must have a leading batch axis matching dY "
            f"(got {int(displacement.shape[0])} vs batch {B}).")
    fakes = [_n.Shaped((B, *s.shape), s.dtype)
             for s in _n.gradient_inputs(dYs, X_shape, crop, batched=True)]
    _, inv_affine, spec, output_shapes = _prepare_batch(
        fakes, _n.Shaped(displacement.shape, displacement.dtype), order,
        mode, cval, crop, prefilter, axis, affine, rotate, zoom)
    _n.check_gradient_shapes(output_shapes, dYs, batched=True)
    dev = _device(device)
    dxs = _d.deform_gradient_apply_batched(
        [_to_device(dy, dev) for dy in dYs], _to_device(displacement, dev),
        inv_affine, spec)
    return dxs if isinstance(dY, list) else dxs[0]
