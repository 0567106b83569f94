"""Tensor API: elastic deformation of torch tensors on the card, its exact
adjoint, and the general resampler family.

Counterparts of the JAX package's ``core.deform``, ``deform_gradient``,
``deform_batch`` and ``deform_batch_gradient`` with the same keywords plus
``device``: ``None`` means ``"cuda"``; the CPU runs only when the caller
passes ``device="cpu"``. Inputs are moved to that device; outputs are
tensors there, with the input dtypes.

``strategy`` and ``batch_impl`` are checked as the JAX package checks them
and change nothing: its strategies agree tap for tap
(``tests/test_strategies.py``), and its batch layouts are one layout here.
``table_dtype`` (``'bfloat16'``; ``'float32'`` under float64) is the opt-in
narrow window table of fast augmentation (the JAX package's
``core.py:77-83``): the prefiltered coefficients are cast to it and K1/K1c
read them in it, about 2^-8 relative error; the gradients with respect to
the inputs stay exact, the coordinate gradients read the narrow
coefficients, as in the JAX package. ``strategy='gather'`` keeps the full
table there, and so here.

:func:`deform` and :func:`deform_batch` are differentiable with respect to
``X`` and the displacement grid: when any of them requires grad, the call
goes through a ``torch.autograd.Function`` whose backward runs the
transposed pipeline (kernels K3 and K4) for the inputs and kernel K5 for
the grid, each only when it is asked for. The backward is not itself
differentiable (no double backward), and there is no gradient with respect
to the affine, which is a host-side constant as in the JAX package.

The general resampler family (the JAX package's ``core.py:471-1222``):
:func:`map_coordinates` (+ :func:`map_coordinates_batch`,
:func:`map_coordinates_gradient`), :func:`deform_field` (+
:func:`deform_field_batch`), :func:`affine_transform`, :func:`shift`,
:func:`zoom`, :func:`rotate`, :func:`geometric_transform`,
:func:`spline_filter` and :func:`spline_filter1d`, with the same keywords
plus ``device``.
They are torch glue around two autograd functions
(:class:`~elasticdeform_tpu_torch.ops.deform.ResampleAt`, kernel K1c with
K3c/K5c behind it, and
:class:`~elasticdeform_tpu_torch.ops.deform.Prefilter1d`, K2/K6 with K4/K7
behind it), so they are differentiable with respect to ``X``, the
coordinates, the field, ``matrix``/``offset``, ``shift`` and whatever a
``geometric_transform`` mapping closes over. The five classic mode names
keep the reference's pre-SciPy-1.6 meaning on :func:`map_coordinates`; the
``grid-*`` names, and every name on the scipy-convention resamplers, follow
SciPy >= 1.6.

The linear filter tier (the JAX package's ``core.py:1210-1573`` and
``1926-1977``): :func:`gaussian_filter1d`, :func:`gaussian_filter`,
:func:`gaussian_laplace`, :func:`gaussian_gradient_magnitude`,
:func:`correlate1d`, :func:`convolve1d`, :func:`uniform_filter1d`,
:func:`uniform_filter`, :func:`sobel`, :func:`prewitt`, :func:`laplace`,
:func:`correlate`, :func:`convolve`, :func:`generic_laplace` and
:func:`generic_gradient_magnitude`, with SciPy's filter boundary modes and
``output=`` contract, plus ``device``. The 1-D passes run through the
autograd function :class:`~elasticdeform_tpu_torch.ops.filters.Correlate1d`
(kernel K8, backward K8T), the N-D ones through
:class:`~elasticdeform_tpu_torch.ops.filters.CorrelateNd` (K9, backward
K9T), so the float results are differentiable with respect to ``X``.

The morphology tier (the JAX package's ``core.py:1576-1923`` and
``1980-2146``): the minimum / maximum filters, :func:`rank_filter`,
:func:`median_filter`, :func:`percentile_filter`, grey and binary
morphology and the generic filters, with the same keywords plus ``device``,
on kernels K10-K13 (:mod:`~elasticdeform_tpu_torch.ops.morphology`). It has
no gradient: a tensor that requires grad raises.

The distance transforms (the JAX package's ``ops/distance.py``):
:func:`distance_transform_edt` (kernels K14 and K15),
:func:`distance_transform_cdt` and :func:`distance_transform_bf` (K16, or
the EDT), and :func:`watershed_ift` (K17, the JAX package's
``ops/morphology.py:522-597``), with the same arguments plus ``device``;
the kernels are in ``csrc/distance.cu``
(:mod:`~elasticdeform_tpu_torch.ops.distance`).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from elasticdeform_tpu_torch import _normalize as _n
from elasticdeform_tpu_torch.ops import deform as _d
from elasticdeform_tpu_torch.ops import distance as _dist
from elasticdeform_tpu_torch.ops import filters as _f
from elasticdeform_tpu_torch.ops import modes as _modes
from elasticdeform_tpu_torch.ops import morphology as _m
from elasticdeform_tpu_torch.ops.resample import (
    cast_output, numpy_dtype, torch_dtype,
)


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A tensor (kept in the autograd graph) or an array-like, on
    ``device``; numpy's dtype rules for array-likes (Python floats are
    float64)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    # torch warns on (and must not write through) a read-only buffer
    return torch.as_tensor(a if a.flags.writeable else a.copy(),
                           device=device)


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
             affine, rotate, zoom, strategy, table_dtype):
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
                         displacement.dtype, strategy, table_dtype)
    return Xs, displacement, inv_affine, spec


def deform(X, displacement, *, order=3, mode='constant', cval=0.0, crop=None,
           prefilter=True, axis=None, affine=None, rotate=None, zoom=None,
           strategy="auto", table_dtype=None, device=None):
    """Elastic deformation of a tensor (or list of tensors) with a
    control-point displacement grid ``(naxis, *points)``.

    Parameters and semantics are those of
    :func:`elasticdeform_tpu_torch.deform_grid`; ``X`` and
    ``displacement`` may be tensors or numpy arrays. Returns tensors on
    ``device`` (default ``"cuda"``) with the input dtypes, differentiable
    with respect to ``X`` and ``displacement`` where they require grad.
    ``strategy`` and ``table_dtype``: see the module docstring.
    """
    Xs, displacement, inv_affine, spec = _prepare(
        X, displacement, order, mode, cval, crop, prefilter, axis, affine,
        rotate, zoom, strategy, table_dtype)
    dev = _device(device)
    ys = _apply([_to_device(x, dev)[None] for x in Xs],
                _to_device(displacement, dev)[None], inv_affine, spec)
    ys = [y[0] for y in ys]
    return ys if isinstance(X, list) else ys[0]


def deform_gradient(dY, displacement, *, order=3, mode='constant', cval=0.0,
                    crop=None, prefilter=True, axis=None, X_shape=None,
                    affine=None, rotate=None, zoom=None, strategy="auto",
                    device=None):
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
                         orders, modes, cvals, prefilter, displacement.dtype,
                         strategy)
    dev = _device(device)
    dxs = _d.deform_gradient_apply([_to_device(dy, dev) for dy in dYs],
                                   _to_device(displacement, dev), inv_affine,
                                   spec)
    return dxs if isinstance(dY, list) else dxs[0]


def _prepare_batch(X, displacement, order, mode, cval, crop, prefilter,
                   axis, affine, rotate, zoom, strategy, table_dtype=None):
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
                         displacement.dtype, strategy, table_dtype)
    return Xs, inv_affine, spec, output_shapes


def deform_batch(X, displacement, *, order=3, mode='constant', cval=0.0,
                 crop=None, prefilter=True, axis=None, affine=None,
                 rotate=None, zoom=None, strategy="auto", batch_impl="auto",
                 table_dtype=None, device=None):
    """Batched elastic deformation with per-sample displacement grids.

    ``X``: ``(B, *image_shape)`` tensor (or list of such tensors sharing the
    deformation); ``displacement``: ``(B, naxis, *points)``. The other
    parameters are shared by the batch and follow :func:`deform`
    (``axis``/``crop`` refer to the per-sample shape). Differentiable with
    respect to ``X`` and ``displacement``. ``strategy``, ``batch_impl`` and
    ``table_dtype``: see the module docstring.
    """
    Xs, inv_affine, spec, _ = _prepare_batch(
        X, displacement, order, mode, cval, crop, prefilter, axis, affine,
        rotate, zoom, strategy, table_dtype)
    dev = _device(device)
    ys = _apply([_to_device(x, dev) for x in Xs],
                _to_device(displacement, dev), inv_affine, spec)
    return ys if isinstance(X, list) else ys[0]


def deform_batch_gradient(dY, displacement, *, order=3, mode='constant',
                          cval=0.0, crop=None, prefilter=True, axis=None,
                          X_shape=None, affine=None, rotate=None, zoom=None,
                          strategy="auto", batch_impl="auto", device=None):
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
        mode, cval, crop, prefilter, axis, affine, rotate, zoom, strategy)
    _n.check_gradient_shapes(output_shapes, dYs, batched=True)
    dev = _device(device)
    dxs = _d.deform_gradient_apply_batched(
        [_to_device(dy, dev) for dy in dYs], _to_device(displacement, dev),
        inv_affine, spec)
    return dxs if isinstance(dY, list) else dxs[0]


# ---------------------------------------------------------------------------
# the general resampler family


# modern-SciPy (>= 1.6) boundary modes; on map_coordinates only the grid-*
# names take them, the classic five keep the reference's meaning
_GRID_MODE_NAMES = ('grid-mirror', 'grid-wrap', 'grid-constant')
_MODERN_MODE_NAMES = _GRID_MODE_NAMES + ('reflect', 'nearest')


def _refuse_list(X):
    if isinstance(X, list):
        raise ValueError("map_coordinates takes a single input array "
                         "(vmap it or loop for multiple inputs).")


def _prepare_map(X, coordinates, order, mode, cval, prefilter, axis,
                 strategy="auto", table_dtype=None):
    """Validate a map_coordinates call on the shapes of one sample and its
    coordinates; returns the :class:`DeformSpec`."""
    _refuse_list(X)
    axis_n, deform_shape = _n.normalize_axis_list(axis, [X])
    axis_t = axis_n[0]
    _check_coordinates(coordinates, len(axis_t))
    (order,) = _n.normalize_order(order, [X])
    return _n.build_map_spec(X, axis_t, deform_shape,
                             tuple(coordinates.shape[1:]), order, mode, cval,
                             prefilter, coordinates.dtype, strategy,
                             table_dtype)


def _check_coordinates(coordinates, naxis):
    if coordinates.ndim < 1 or coordinates.shape[0] != naxis:
        raise ValueError(
            "coordinates should have shape (naxis, *out_shape) with one "
            f"row per deformed axis; got {tuple(coordinates.shape)} for "
            f"{naxis} deformed axes.")


def _check_batch(X, coordinates):
    B = int(X.shape[0])
    if coordinates.ndim < 2 or int(coordinates.shape[0]) != B:
        raise ValueError(
            "coordinates must have a leading batch axis matching X "
            f"(got {tuple(coordinates.shape)} for batch {B}).")


def _sample(x) -> _n.Shaped:
    return _n.Shaped(x.shape[1:], x.dtype)


def _map_classic(X, coordinates, order, mode, cval, prefilter, axis, device,
                 batched=False, strategy="auto", table_dtype=None):
    """map_coordinates with the classic mode semantics; ``batched`` takes a
    leading batch axis on ``X`` and ``coordinates``."""
    dev = _device(device)
    _refuse_list(X)
    X = _to_device(X, dev)
    coordinates = _to_device(coordinates, dev)
    if batched:
        _check_batch(X, coordinates)
        spec = _prepare_map(_sample(X), _sample(coordinates), order, mode,
                            cval, prefilter, axis, strategy, table_dtype)
        return _d.map_coordinates_apply_batched(X, coordinates, spec)
    spec = _prepare_map(X, coordinates, order, mode, cval, prefilter, axis,
                        strategy, table_dtype)
    return _d.map_coordinates_apply_batched(X[None], coordinates[None],
                                            spec)[0]


def _ring_pad(y: torch.Tensor, axes, width: int, pad_mode: str, cval):
    """numpy's ``pad`` of ``width`` on both sides of each of ``axes``, by
    index so that autograd transposes it (``index_select``, whose backward
    is ``index_add_``): ``symmetric`` (half-sample reflect, period 2n),
    ``wrap``, ``edge``, or ``constant`` with ``cval``."""
    for a in axes:
        n = y.shape[a]
        i = np.arange(-width, n + width)
        if pad_mode == 'symmetric':
            m = np.mod(i, 2 * n)
            idx = np.where(m >= n, 2 * n - 1 - m, m)
        elif pad_mode == 'wrap':
            idx = np.mod(i, n)
        else:
            idx = np.clip(i, 0, n - 1)
        y = torch.index_select(y, a, torch.as_tensor(idx, device=y.device))
        if pad_mode == 'constant':
            view = [1] * y.dim()
            view[a] = len(i)
            inside = torch.as_tensor((i >= 0) & (i < n),
                                     device=y.device).view(view)
            y = torch.where(inside, y, torch.tensor(float(cval),
                                                    dtype=y.dtype,
                                                    device=y.device))
    return y


def _jnp_mod(t: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp.mod(t, n)`` for ``n > 0``: the exact ``fmod``, plus ``n``
    where it is negative; derivative 1."""
    r = torch.fmod(t, n)
    return torch.where((r != 0) & (r < 0), r + n, r)


def _jnp_clip(t: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(t, lo), hi)``, whose derivative
    passes half at an exact tie with a bound (``torch.clamp`` passes
    all)."""
    def c(v):
        return torch.tensor(v, dtype=t.dtype, device=t.device)
    return torch.minimum(torch.maximum(t, c(lo)), c(hi))


def _modern_map_coordinates(X, coordinates, *, order, mode, cval, prefilter,
                            axis, device, batched=False, strategy="auto",
                            table_dtype=None):
    """SciPy >= 1.6 resampling for ``mode`` in ``_MODERN_MODE_NAMES`` (the
    JAX package's ``core.py:503``): pad ``npad``, prefilter with the mode's
    boundary condition (K6 for reflect and wrap, K2 for mirror), pad a ring
    so every tap lies inside, fold the coordinates by the mode, then K1c
    with the classic ``nearest`` mode on the padded array, where its clamp
    does nothing. ``batched``: a leading batch axis on both."""
    dev = _device(device)
    _refuse_list(X)
    X = _to_device(X, dev)
    coordinates = _to_device(coordinates, dev)
    if batched:
        _check_batch(X, coordinates)
    else:
        X, coordinates = X[None], coordinates[None]
    sample = _sample(X)
    axis_n, _ = _n.normalize_axis_list(axis, [sample])
    axis_t = axis_n[0]
    _check_coordinates(_sample(coordinates), len(axis_t))
    (order,) = _n.normalize_order(order, [sample])
    out_dtype = numpy_dtype(X.dtype)
    comp = torch.float64 if out_dtype == np.float64 else torch.float32
    needs_filter = bool(prefilter) and order > 1
    r = order + 1                       # tap half-width bound
    if mode in ('reflect', 'grid-mirror'):
        bc, pad_mode, npad, ring = 'reflect', 'symmetric', 0, r + 2
    elif mode == 'grid-wrap':
        bc, pad_mode, npad, ring = 'wrap', 'wrap', 0, r + 2
    elif mode == 'nearest':
        bc, pad_mode = 'reflect', 'edge'
        npad, ring = (12 if needs_filter else 0), 2 * r + 3
    elif mode == 'grid-constant':
        bc, pad_mode = 'mirror', 'constant'
        npad, ring = (12 if needs_filter else 0), 2 * r + 3
    else:
        raise RuntimeError("boundary mode not supported")
    cval = _n.cval_scalar(cval)
    if isinstance(cval, complex):
        raise TypeError("complex cval is not supported by "
                        "elasticdeform_tpu_torch yet")
    axes = [a + 1 for a in axis_t]

    Y = X.to(comp)
    if npad:
        Y = _ring_pad(Y, axes, npad, pad_mode, cval)
    if needs_filter:
        # an integer output rounds the filtered values: filter in one fixed
        # order on every device; an integer input is finite, and so is its
        # padded copy unless a constant pad of a non-finite cval was added
        fixed = out_dtype.kind in "biu"
        finite = fixed and (not npad or pad_mode != 'constant' or
                            math.isfinite(float(torch.tensor(cval,
                                                             dtype=comp))))
        for a in axes:
            Y = _d.Prefilter1d.apply(Y.contiguous(), order, a, bc, fixed,
                                     finite)
    Y = _ring_pad(Y, axes, ring, pad_mode, cval)

    cc = coordinates.to(comp)
    shift = npad + ring
    rows = []
    for i, a in enumerate(axis_t):
        n_a = int(sample.shape[a])
        t = cc[:, i]
        if mode in ('reflect', 'grid-mirror'):
            t, _ = _modes.map_coordinate(t, n_a, _modes.MODE_REFLECT)
        elif mode == 'grid-wrap':
            t = _jnp_mod(t, n_a) if n_a > 1 else torch.zeros_like(t)
        else:                           # nearest / grid-constant
            t = _jnp_clip(t, -(npad + r + 1), n_a - 1 + npad + r + 1)
        rows.append(t + shift)
    coords2 = torch.stack(rows, 1)
    spec = _prepare_map(_sample(Y), _sample(coords2), order, 'nearest', 0.0,
                        False, axis, strategy, table_dtype)
    res = _d.map_coordinates_apply_batched(Y, coords2, spec)
    if out_dtype.kind in "biu":
        res = cast_output(res, out_dtype)
    else:
        res = res.to(torch_dtype(out_dtype))
    return res if batched else res[0]


def _map_coordinates_scipy(X, coordinates, *, order, mode, cval, prefilter,
                           axis, device, strategy, table_dtype):
    """The scipy-convention resamplers' dispatch: 'reflect', 'nearest' and
    the grid-* names take the modern path; 'mirror', 'wrap' and
    'constant', the same before and after SciPy 1.6, the classic one."""
    if mode in _MODERN_MODE_NAMES:
        return _modern_map_coordinates(
            X, coordinates, order=order, mode=mode, cval=cval,
            prefilter=prefilter, axis=axis, device=device, strategy=strategy,
            table_dtype=table_dtype)
    return _map_classic(X, coordinates, order, mode, cval, prefilter, axis,
                        device, strategy=strategy, table_dtype=table_dtype)


def map_coordinates(X, coordinates, *, order=3, mode='constant', cval=0.0,
                    prefilter=True, axis=None, strategy="auto",
                    table_dtype=None, device=None):
    """Resample ``X`` at explicit per-voxel coordinates
    (``scipy.ndimage.map_coordinates``; the JAX package's
    ``core.map_coordinates``).

    ``coordinates`` ``(naxis, *out_shape)`` gives the input position of
    every output voxel; the output has shape ``out_shape`` (any rank), or,
    with ``axis``, the input's with the deformed axes resized and the
    channel axes carried along. The five classic mode names keep the
    reference's pre-SciPy-1.6 meaning; ``'grid-mirror'``, ``'grid-wrap'``
    and ``'grid-constant'`` follow SciPy >= 1.6. Returns a tensor on
    ``device`` (default ``"cuda"``) with ``X``'s dtype, differentiable with
    respect to ``X`` and ``coordinates``. ``strategy`` and ``table_dtype``:
    see the module docstring.
    """
    if mode in _GRID_MODE_NAMES:
        return _modern_map_coordinates(
            X, coordinates, order=order, mode=mode, cval=cval,
            prefilter=prefilter, axis=axis, device=device, strategy=strategy,
            table_dtype=table_dtype)
    return _map_classic(X, coordinates, order, mode, cval, prefilter, axis,
                        device, strategy=strategy, table_dtype=table_dtype)


def map_coordinates_batch(X, coordinates, *, order=3, mode='constant',
                          cval=0.0, prefilter=True, axis=None,
                          strategy="auto", batch_impl="auto",
                          table_dtype=None, device=None):
    """Batched :func:`map_coordinates` with per-sample coordinates: ``X``
    ``(B, *image_shape)``, ``coordinates`` ``(B, naxis, *out_shape)``;
    ``axis`` refers to the per-sample shape. Differentiable with respect
    to ``X`` and ``coordinates``."""
    if mode in _GRID_MODE_NAMES:
        return _modern_map_coordinates(
            X, coordinates, order=order, mode=mode, cval=cval,
            prefilter=prefilter, axis=axis, device=device, batched=True,
            strategy=strategy, table_dtype=table_dtype)
    return _map_classic(X, coordinates, order, mode, cval, prefilter, axis,
                        device, batched=True, strategy=strategy,
                        table_dtype=table_dtype)


def _map_gradient_classic(dY, coordinates, order, mode, cval, prefilter,
                          axis, X_shape, device, strategy="auto"):
    dev = _device(device)
    dY = _to_device(dY, dev)
    coordinates = _to_device(coordinates, dev)
    shaped = _n.Shaped(X_shape, dY.dtype)
    spec = _prepare_map(shaped, coordinates, order, mode, cval, prefilter,
                        axis, strategy)
    return _d.map_coordinates_gradient_apply_batched(
        dY[None], coordinates[None], spec)[0]


def map_coordinates_gradient(dY, coordinates, *, order=3, mode='constant',
                             cval=0.0, prefilter=True, axis=None,
                             X_shape=None, strategy="auto", device=None):
    """Adjoint of :func:`map_coordinates` with respect to ``X``: maps an
    output cotangent ``dY`` to an input cotangent of shape ``X_shape``
    (required). The classic modes run the transposed stages with no
    forward pass (K3c, then K4); the grid modes, linear in ``X``, take the
    vector-Jacobian product at a zero input, as the JAX package does."""
    if X_shape is None:
        raise ValueError("X_shape is required (the input shape cannot be "
                         "inferred from dY).")
    X_shape = tuple(int(s) for s in X_shape)
    if mode in _GRID_MODE_NAMES:
        dev = _device(device)
        dY = _to_device(dY, dev)
        dt = dY.dtype if dY.dtype.is_floating_point else torch.float32
        zero = torch.zeros(X_shape, dtype=dt, device=dev, requires_grad=True)
        with torch.enable_grad():
            y = _modern_map_coordinates(
                zero, coordinates, order=order, mode=mode, cval=cval,
                prefilter=prefilter, axis=axis, device=dev,
                strategy=strategy)
            (g,) = torch.autograd.grad(y, zero, dY.to(dt))
        return g
    return _map_gradient_classic(dY, coordinates, order, mode, cval,
                                 prefilter, axis, X_shape, device, strategy)


def _identity_plus_field(field: torch.Tensor, lead: int) -> torch.Tensor:
    """``identity + field`` sample coordinates from a dense displacement
    field with ``lead`` leading (batch) axes before the component axis."""
    cdt = field.dtype if field.dtype in (torch.float32, torch.float64) \
        else torch.float64
    spatial = tuple(field.shape[lead + 1:])
    idx = torch.stack(_iotas(spatial, cdt, field.device))
    return idx.reshape((1,) * lead + tuple(idx.shape)) + field.to(cdt)


def _iotas(shape, dtype, device):
    """``jax.lax.broadcasted_iota`` of ``shape`` along each axis."""
    out = []
    for h, n in enumerate(shape):
        view = [1] * len(shape)
        view[h] = n
        out.append(torch.arange(n, dtype=dtype, device=device).view(view)
                   .expand(shape))
    return out


def deform_field(X, field, *, order=3, mode='constant', cval=0.0,
                 prefilter=True, axis=None, strategy="auto", table_dtype=None,
                 device=None):
    """Deform ``X`` with a dense per-voxel displacement field ``(naxis,
    *out_shape)``: output voxel ``v`` takes the input at ``v + field[:,
    v]``. With ``field`` the dense field of a control grid this equals
    :func:`deform`. Differentiable with respect to ``X`` and ``field``."""
    coords = _identity_plus_field(_to_device(field, _device(device)), 0)
    return map_coordinates(X, coords, order=order, mode=mode, cval=cval,
                           prefilter=prefilter, axis=axis, strategy=strategy,
                           table_dtype=table_dtype, device=device)


def deform_field_batch(X, field, *, order=3, mode='constant', cval=0.0,
                       prefilter=True, axis=None, strategy="auto",
                       batch_impl="auto", table_dtype=None, device=None):
    """Batched :func:`deform_field`: ``X`` ``(B, *image_shape)``, ``field``
    ``(B, naxis, *out_shape)``; the warp layer of registration training,
    differentiable with respect to ``X`` and ``field``."""
    coords = _identity_plus_field(_to_device(field, _device(device)), 1)
    return map_coordinates_batch(X, coords, order=order, mode=mode,
                                 cval=cval, prefilter=prefilter, axis=axis,
                                 strategy=strategy, batch_impl=batch_impl,
                                 table_dtype=table_dtype, device=device)


def affine_transform(X, matrix, offset=0.0, *, output_shape=None, order=3,
                     mode='constant', cval=0.0, prefilter=True, axis=None,
                     strategy="auto", table_dtype=None, device=None):
    """Affine resampling (``scipy.ndimage.affine_transform``): output voxel
    ``o`` takes the input at ``matrix @ o + offset``. ``matrix`` is
    ``(naxis, naxis)``, a length-``naxis`` scaling vector, or the
    homogeneous ``(naxis+1, naxis+1)`` form; every mode name takes its
    SciPy >= 1.6 meaning. Differentiable with respect to ``X``, ``matrix``
    and ``offset``."""
    dev = _device(device)
    axis_n, deform_shape = _n.normalize_axis_list(axis, [X])
    naxis = len(axis_n[0])
    matrix = _to_device(matrix, dev)
    cdt = torch.float64 if matrix.dtype == torch.float64 else torch.float32
    matrix = matrix.to(cdt)
    if matrix.dim() == 2 and tuple(matrix.shape) == (naxis + 1, naxis + 1):
        offset = matrix[:naxis, naxis]
        matrix = matrix[:naxis, :naxis]
    elif matrix.dim() == 1 and tuple(matrix.shape) != (naxis,) or \
            matrix.dim() == 2 and tuple(matrix.shape) != (naxis, naxis) or \
            matrix.dim() not in (1, 2):
        raise ValueError(
            f"matrix should have shape ({naxis},), ({naxis}, {naxis}) or "
            f"({naxis + 1}, {naxis + 1}); got {tuple(matrix.shape)}.")
    offset = torch.broadcast_to(_to_device(offset, dev).to(cdt), (naxis,))
    if output_shape is None:
        output_shape = tuple(deform_shape)
    else:
        output_shape = tuple(int(s) for s in output_shape)
        if len(output_shape) != naxis:
            raise ValueError(
                f"output_shape must have one entry per deformed axis "
                f"({naxis}); got {output_shape}.")
    iotas = _iotas(output_shape, cdt, dev)
    if matrix.dim() == 1:
        cc = [matrix[h] * iotas[h] + offset[h] for h in range(naxis)]
    else:
        cc = [sum(matrix[h, l] * iotas[l] for l in range(naxis))
              + offset[h] for h in range(naxis)]
    return _map_coordinates_scipy(X, torch.stack(cc), order=order,
                                  mode=mode, cval=cval, prefilter=prefilter,
                                  axis=axis, device=device, strategy=strategy,
                                  table_dtype=table_dtype)


def shift(X, shift, *, order=3, mode='constant', cval=0.0, prefilter=True,
          axis=None, strategy="auto", device=None):
    """Translate an image (``scipy.ndimage.shift``): ``output[o] =
    input[o - shift]``, ``shift`` a scalar or one value per deformed axis,
    differentiable. A wrapper of :func:`affine_transform`."""
    dev = _device(device)
    axis_n, _ = _n.normalize_axis_list(axis, [X])
    naxis = len(axis_n[0])
    sh = torch.broadcast_to(_to_device(shift, dev), (naxis,))
    return affine_transform(X, torch.ones(naxis, dtype=sh.dtype, device=dev),
                            offset=-sh, order=order, mode=mode, cval=cval,
                            prefilter=prefilter, axis=axis, strategy=strategy,
                            device=device)


def zoom(X, zoom, *, order=3, mode='constant', cval=0.0, prefilter=True,
         axis=None, strategy="auto", grid_mode=False, device=None):
    """Rescale an image (``scipy.ndimage.zoom``) to ``round(in_size *
    zoom)`` per deformed axis: output voxel ``o`` samples ``o * (in - 1) /
    (out - 1)``, or with ``grid_mode=True`` ``(o + 0.5) * in / out -
    0.5``."""
    axis_n, deform_shape = _n.normalize_axis_list(axis, [X])
    naxis = len(axis_n[0])
    if not isinstance(zoom, (list, tuple, np.ndarray)):
        zoom = [zoom] * naxis
    if len(zoom) != naxis:
        raise ValueError(f"zoom must be a scalar or give one factor per "
                         f"deformed axis ({naxis}); got {len(zoom)}.")
    out_shape = tuple(int(round(i * float(z)))
                      for i, z in zip(deform_shape, zoom))
    if grid_mode:
        if mode in ('constant', 'wrap'):
            warnings.warn(
                "It is recommended to use mode = 'grid-constant' or "
                "'grid-wrap' instead of 'constant'/'wrap' when "
                "grid_mode is True.", UserWarning, stacklevel=2)
        factors = np.array([i / o if o > 0 else 1.0
                            for i, o in zip(deform_shape, out_shape)])
        offsets = (factors - 1.0) / 2.0
        return affine_transform(X, factors, offsets,
                                output_shape=out_shape, order=order,
                                mode=mode, cval=cval, prefilter=prefilter,
                                axis=axis, strategy=strategy, device=device)
    factors = np.array([(i - 1) / (o - 1) if o > 1 else 1.0
                        for i, o in zip(deform_shape, out_shape)])
    return affine_transform(X, factors, 0.0, output_shape=out_shape,
                            order=order, mode=mode, cval=cval,
                            prefilter=prefilter, axis=axis, strategy=strategy,
                            device=device)


def rotate(X, angle, axes=(1, 0), *, reshape=True, order=3, mode='constant',
           cval=0.0, prefilter=True, strategy="auto", device=None):
    """Rotate an image in the plane of two axes (``scipy.ndimage.rotate``):
    ``angle`` in degrees; ``reshape=True`` enlarges the output to hold the
    whole rotated input; the other axes are carried along."""
    ndim = len(X.shape)
    axes = sorted(a % ndim for a in axes)
    if len(set(axes)) != 2:
        raise ValueError("axes should be two distinct axes")
    rad = np.deg2rad(float(angle))
    c, s = np.cos(rad), np.sin(rad)
    rot = np.array([[c, s], [-s, c]])
    in_plane = np.array([X.shape[axes[0]], X.shape[axes[1]]])
    if reshape:
        iy, ix = in_plane
        out_bounds = rot @ np.array([[0, 0, iy, iy], [0, ix, 0, ix]],
                                    dtype=float)
        out_plane = (np.ptp(out_bounds, axis=1) + 0.5).astype(int)
    else:
        out_plane = in_plane
    offset = (in_plane - 1) / 2 - rot @ ((out_plane - 1) / 2)
    return affine_transform(X, rot, offset,
                            output_shape=tuple(int(n) for n in out_plane),
                            order=order, mode=mode, cval=cval,
                            prefilter=prefilter, axis=tuple(axes),
                            strategy=strategy, device=device)


def geometric_transform(X, mapping, output_shape=None, *, order=3,
                        mode='constant', cval=0.0, prefilter=True,
                        extra_arguments=(), extra_keywords=None,
                        strategy="auto", table_dtype=None, device=None):
    """Resample through a coordinate mapping
    (``scipy.ndimage.geometric_transform``): ``mapping(output_coords,
    *extra_arguments, **extra_keywords)`` receives a tuple of float64
    coordinate tensors of shape ``output_shape`` on ``device`` and returns
    one input coordinate (tensor or broadcastable value) per input axis. It
    is applied to whole tensors, so autograd reaches whatever it closes
    over. Every mode name takes its SciPy >= 1.6 meaning."""
    dev = _device(device)
    out_shape = tuple(int(s) for s in output_shape) \
        if output_shape is not None else tuple(int(s) for s in X.shape)
    idx = tuple(_iotas(out_shape, torch.float64, dev))
    coords = mapping(idx, *extra_arguments, **(extra_keywords or {}))
    coordinates = torch.stack(
        [torch.broadcast_to(_to_device(c, dev).to(torch.float64), out_shape)
         for c in coords])
    return _map_coordinates_scipy(X, coordinates, order=order, mode=mode,
                                  cval=cval, prefilter=prefilter, axis=None,
                                  device=device, strategy=strategy,
                                  table_dtype=table_dtype)


# spline-filter boundary condition per scipy mode name (the JAX package's
# core.py:1134)
_SPLINE_BC = {'mirror': 'mirror', 'constant': 'mirror', 'wrap': 'mirror',
              'grid-constant': 'mirror', 'reflect': 'reflect',
              'nearest': 'reflect', 'grid-mirror': 'reflect',
              'grid-wrap': 'wrap'}


def _resolve_output(X, output):
    """scipy's ``output=`` contract: ``None`` keeps ``X``'s dtype, a
    dtype-like (numpy or torch) selects the result's, a numpy array is
    filled on the host and returned. Returns ``(numpy dtype, array or
    None)``."""
    if output is None:
        return numpy_dtype(X.dtype), None
    if isinstance(output, np.ndarray):
        if output.shape != tuple(X.shape):
            raise RuntimeError("output shape not correct")
        return output.dtype, output
    return numpy_dtype(output), None


def _finish(res: torch.Tensor, dtype, out_array):
    res = res.to(torch_dtype(dtype))
    if out_array is not None:
        out_array[...] = res.detach().cpu().numpy()
        return out_array
    return res


def _integer_array(out_array) -> bool:
    """True for an ``output=`` array that truncates (integer or bool): its
    filter then sums in one order on every device (``fixed_order``), so that
    the card stores the CPU's integers."""
    return out_array is not None and out_array.dtype.kind in "biu"


def _spline_filter1d(X, order, axis, mode, output, device, fixed):
    """:func:`spline_filter1d`; ``fixed``: the filter's sums in one order
    whatever ``output`` is (an integer ``output=`` array of
    :func:`spline_filter`, which truncates the last pass)."""
    (order,) = _n.normalize_order(order, [X])
    try:
        bc = _SPLINE_BC[mode]
    except KeyError:
        raise RuntimeError("boundary mode not supported") from None
    dtype, out_array = _resolve_output(X, output)
    if dtype.kind != "f":
        dtype = np.dtype(np.float64)
    Xf = _to_device(X, _device(device)).to(torch_dtype(dtype))
    if order > 1:
        Xf = _d.Prefilter1d.apply(Xf.contiguous(), order, axis % Xf.dim(),
                                  bc, fixed or _integer_array(out_array))
    return _finish(Xf, dtype, out_array)


def spline_filter1d(X, *, order=3, axis=-1, mode='mirror', output=None,
                    device=None):
    """B-spline prefilter along one axis (``scipy.ndimage.spline_filter1d``)
    with the boundary condition of ``mode`` (any of the eight scipy names:
    mirror on K2, reflect and wrap on K6). ``output`` follows scipy's
    contract; ``None`` keeps a floating input's dtype (integers give
    float64). An integer or bool ``output`` array, which truncates, takes
    the filter's fixed-order sums, so that every device stores the same
    integers. Differentiable; orders 0 and 1 return the input cast."""
    return _spline_filter1d(X, order, axis, mode, output, device, False)


def spline_filter(X, *, order=3, axis=None, mode='mirror', output=None,
                  device=None):
    """B-spline prefilter over several axes (``scipy.ndimage.spline_filter``):
    :func:`spline_filter1d` along each of ``axis`` (default all) in
    turn, with fixed-order sums for an integer or bool ``output`` array."""
    ndim = len(X.shape)
    if axis is None:
        axis = tuple(range(ndim))
    elif isinstance(axis, int):
        axis = (axis,)
    dtype, out_array = _resolve_output(X, output)
    for d in axis:
        X = _spline_filter1d(X, order, d, mode, None, device,
                             _integer_array(out_array))
    if dtype.kind != "f":
        dtype = numpy_dtype(X.dtype)
    return _finish(_to_device(X, _device(device)), dtype, out_array)


# ---------------------------------------------------------------------------
# the linear filter tier (the JAX package's core.py:1210-1573, 1926-1977)


def _filter_input(X, device) -> torch.Tensor:
    """``X`` on the device; complex, float16 and bfloat16 raise
    TypeError."""
    x = _to_device(X, _device(device))
    numpy_dtype(x.dtype)
    return x


def _truncating_dtype(dtype) -> bool:
    """True when :func:`_finish_filter` truncates (integer or bool output):
    the callers then take SciPy's paired order, so the value before the
    cast is SciPy's to the bit."""
    return np.dtype(dtype).kind in "biu"


def _trunc_int64(res: torch.Tensor) -> torch.Tensor:
    """``res`` truncated toward zero into int64 as XLA converts (the JAX
    package's ``astype``): NaN to 0, values past the range saturated. A
    plain ``.to(torch.int64)`` leaves those to the device (the CPU gives
    int64's least value for +inf, the card its greatest). One reduction
    (and a sync) finds whether any value needs that; the common case then
    costs no more passes than the plain cast."""
    t = torch.trunc(res)
    if t.numel() == 0:
        return t.to(torch.int64)
    lo, hi = torch.aminmax(t)                # NaN propagates into both
    if bool((lo >= -2.0 ** 63) & (hi < 2.0 ** 63)):
        return t.to(torch.int64)
    big = t >= 2.0 ** 63
    # the largest value of t's dtype below 2^63
    top = 2.0 ** 63 * (1 - torch.finfo(t.dtype).eps / 2)
    m = t.nan_to_num_(0.0).clamp_(-2.0 ** 63, top).to(torch.int64)
    return m.masked_fill_(big, torch.iinfo(torch.int64).max)


def _finish_filter(res: torch.Tensor, dtype, out_array=None):
    """A filter result cast to the output dtype as SciPy's C cast does:
    integers truncate toward zero, then wrap modulo 2^bits (through int64,
    as the JAX package under x64, NaN and values past int64 as XLA converts
    them: :func:`_trunc_int64`); bool is ``trunc != 0``."""
    dtype = np.dtype(dtype)
    if res.dtype != torch_dtype(dtype) and res.is_floating_point():
        if dtype.kind in "iu":
            res = _trunc_int64(res)
        elif dtype.kind == "b":
            res = torch.trunc(res)
    return _finish(res, dtype, out_array)


def _filter_axes(axes, ndim: int):
    if axes is None:
        return tuple(range(ndim))
    if isinstance(axes, int):
        axes = (axes,)
    return tuple(a % ndim for a in axes)


def _per_axis(p, name: str, n: int):
    if isinstance(p, (list, tuple, np.ndarray)):
        if len(p) != n:
            raise ValueError(
                f"{name} should be a scalar or have one entry per "
                f"filtered axis ({n}); got {len(p)}.")
        return list(p)
    return [p] * n


def gaussian_filter1d(X, sigma, axis=-1, *, order=0, mode='reflect',
                      cval=0.0, truncate=4.0, radius=None, output=None,
                      device=None):
    """Gaussian (derivative) filter along one axis
    (``scipy.ndimage.gaussian_filter1d``): kernel K8 on the card, the
    reversed Gaussian taps, SciPy's filter boundary modes ('reflect',
    'mirror', 'nearest', 'wrap', 'constant'; the 1-D tier takes no
    ``grid-*`` alias, as in the JAX package, the N-D :func:`correlate` and
    :func:`convolve` do).
    ``output`` follows SciPy: ``None`` keeps the input dtype, integer
    results truncate toward zero and wrap, computed in SciPy's paired order;
    a dtype selects the result's; a numpy array is filled and returned.
    Differentiable with respect to ``X`` (K8T)."""
    x = _filter_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    res = _f.apply_filter1d(x, axis, sigma, order, mode, cval, truncate,
                            radius, int_exact=_truncating_dtype(dtype))
    return _finish_filter(res, dtype, out_array)


def gaussian_filter(X, sigma, *, order=0, mode='reflect', cval=0.0,
                    truncate=4.0, radius=None, axes=None, output=None,
                    device=None):
    """Gaussian filter over ``axes`` (default all;
    ``scipy.ndimage.gaussian_filter``): :func:`gaussian_filter1d` along each
    in turn. ``sigma``, ``order``, ``radius`` and ``mode`` may be per-axis
    sequences; a sigma of at most 1e-15 skips its axis. Integer outputs
    truncate after each pass, as SciPy's passes do. To smooth a
    displacement field's spatial axes, pass ``axes=(1, ..., naxis)``."""
    x = _filter_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    axes = _filter_axes(axes, x.dim())
    n = len(axes)
    for ax, s, o, r, md in zip(axes, _per_axis(sigma, "sigma", n),
                               _per_axis(order, "order", n),
                               _per_axis(radius, "radius", n),
                               _per_axis(mode, "mode", n)):
        if float(s) <= 1e-15:
            continue
        x = gaussian_filter1d(x, s, ax, order=o, mode=md, cval=cval,
                              truncate=truncate, radius=r, output=dtype,
                              device=x.device)
    return _finish(x, dtype, out_array)


def gaussian_laplace(X, sigma, *, mode='reflect', cval=0.0, truncate=4.0,
                     radius=None, axes=None, output=None, device=None):
    """Laplacian of Gaussian (``scipy.ndimage.gaussian_laplace``): the sum
    over ``axes`` of the second-derivative Gaussian along each, smoothing
    along the others; the terms are summed in the output dtype."""
    x = _filter_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    axes = _filter_axes(axes, x.dim())
    out = None
    for i in range(len(axes)):
        orders = [0] * len(axes)
        orders[i] = 2
        term = gaussian_filter(x, sigma, order=orders, mode=mode, cval=cval,
                               truncate=truncate, radius=radius, axes=axes,
                               output=dtype, device=x.device)
        out = term if out is None else out + term
    return _finish_filter(out, dtype, out_array)


def gaussian_gradient_magnitude(X, sigma, *, mode='reflect', cval=0.0,
                                truncate=4.0, radius=None, axes=None,
                                output=None, device=None):
    """Gradient magnitude of Gaussian
    (``scipy.ndimage.gaussian_gradient_magnitude``): ``sqrt(sum_k
    (d/dx_k G * X)^2)`` over ``axes``, the squares summed in the output
    dtype and the root taken in float64."""
    x = _filter_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    axes = _filter_axes(axes, x.dim())
    acc = None
    for i in range(len(axes)):
        orders = [0] * len(axes)
        orders[i] = 1
        term = gaussian_filter(x, sigma, order=orders, mode=mode, cval=cval,
                               truncate=truncate, radius=radius, axes=axes,
                               output=dtype, device=x.device)
        acc = term * term if acc is None else acc + term * term
    return _finish_filter(torch.sqrt(acc.to(torch.float64)), dtype,
                          out_array)


def correlate1d(X, weights, axis=-1, *, mode='reflect', cval=0.0, origin=0,
                output=None, device=None):
    """1-D correlation with any taps (``scipy.ndimage.correlate1d``): tap
    ``len(weights) // 2 + origin`` on the output position; kernel K8 on the
    card. ``output`` as :func:`gaussian_filter1d`."""
    x = _filter_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    res = _f.apply_correlate1d(x, weights, axis, mode, cval, origin,
                               int_exact=_truncating_dtype(dtype))
    return _finish_filter(res, dtype, out_array)


def convolve1d(X, weights, axis=-1, *, mode='reflect', cval=0.0, origin=0,
               output=None, device=None):
    """1-D convolution (``scipy.ndimage.convolve1d``): correlation with the
    reversed taps and the mirrored origin (shifted by one for an even
    length)."""
    weights = np.asarray(weights, dtype=np.float64)[::-1]
    origin = -int(origin)
    if not len(weights) & 1:
        origin -= 1
    return correlate1d(X, weights, axis, mode=mode, cval=cval, origin=origin,
                       output=output, device=device)


def uniform_filter1d(X, size, axis=-1, *, mode='reflect', cval=0.0,
                     origin=0, output=None, device=None):
    """Box filter along one axis (``scipy.ndimage.uniform_filter1d``): unit
    taps, then a true division by ``size`` (a 0-dim tensor on the device:
    PyTorch's CUDA division by a host scalar multiplies by a rounded
    reciprocal)."""
    size = int(size)
    if size < 1:
        raise ValueError("size must be at least 1")
    x = _filter_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    res = _f.apply_correlate1d(x, np.ones(size), axis, mode, cval, origin)
    res = res / torch.tensor(float(size), dtype=res.dtype, device=res.device)
    return _finish_filter(res, dtype, out_array)


def uniform_filter(X, size=3, *, mode='reflect', cval=0.0, origin=0,
                   axes=None, output=None, device=None):
    """Box filter over ``axes`` (``scipy.ndimage.uniform_filter``);
    ``size``, ``origin`` and ``mode`` may be per-axis sequences; integer
    outputs truncate after each pass."""
    x = _filter_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    axes = _filter_axes(axes, x.dim())
    n = len(axes)
    for ax, s, o, md in zip(axes, _per_axis(size, "size", n),
                            _per_axis(origin, "origin", n),
                            _per_axis(mode, "mode", n)):
        if int(s) == 1 and int(o) == 0:
            continue
        x = uniform_filter1d(x, s, ax, mode=md, cval=cval, origin=o,
                             output=dtype, device=x.device)
    return _finish(x, dtype, out_array)


def _derivative_smooth(X, axis, deriv_taps, smooth_taps, mode, cval,
                       axes=None, output=None, device=None):
    """``deriv_taps`` along ``axis``, then ``smooth_taps`` along the other
    ``axes``, each pass cast to the output dtype."""
    x = _filter_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    axes = _filter_axes(axes, x.dim())
    axis = axis % x.dim()
    out = correlate1d(x, deriv_taps, axis, mode=mode, cval=cval,
                      output=dtype, device=x.device)
    for ax in axes:
        if ax != axis:
            out = correlate1d(out, smooth_taps, ax, mode=mode, cval=cval,
                              output=dtype, device=x.device)
    return _finish_filter(out, dtype, out_array)


def sobel(X, axis=-1, *, mode='reflect', cval=0.0, axes=None, output=None,
          device=None):
    """Sobel filter (``scipy.ndimage.sobel``): ``[-1, 0, 1]`` along
    ``axis``, ``[1, 2, 1]`` along the other ``axes``."""
    return _derivative_smooth(X, axis, [-1.0, 0.0, 1.0], [1.0, 2.0, 1.0],
                              mode, cval, axes, output, device)


def prewitt(X, axis=-1, *, mode='reflect', cval=0.0, axes=None, output=None,
            device=None):
    """Prewitt filter (``scipy.ndimage.prewitt``): ``[-1, 0, 1]`` along
    ``axis``, ``[1, 1, 1]`` along the other ``axes``."""
    return _derivative_smooth(X, axis, [-1.0, 0.0, 1.0], [1.0, 1.0, 1.0],
                              mode, cval, axes, output, device)


def laplace(X, *, mode='reflect', cval=0.0, axes=None, output=None,
            device=None):
    """Discrete Laplacian (``scipy.ndimage.laplace``): the sum over
    ``axes`` of ``[1, -2, 1]`` along each, in the output dtype."""
    x = _filter_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    out = None
    for ax in _filter_axes(axes, x.dim()):
        term = correlate1d(x, [1.0, -2.0, 1.0], ax, mode=mode, cval=cval,
                           output=dtype, device=x.device)
        out = term if out is None else out + term
    return _finish_filter(out, dtype, out_array)


def _expand_weights_axes(x, weights, origin, axes):
    """SciPy's ``axes=`` for N-D kernels: ``weights`` and the per-axis
    ``origin`` cover only ``axes``; the other (batch) axes get extent 1."""
    axes_t = _f._normalize_axes(axes, x.dim())
    if len(axes_t) == x.dim():
        return weights, origin
    weights = _f._expand_to_ndim(np.asarray(weights), x.dim(), axes_t)
    origins = _f.normalize_sequence(origin, len(axes_t), "origin")
    full = [0] * x.dim()
    for a, o in zip(axes_t, origins):
        full[a] = int(o)
    return weights, full


def correlate(X, weights, *, mode='reflect', cval=0.0, origin=0,
              output=None, axes=None, device=None):
    """N-D correlation (``scipy.ndimage.correlate``) over the kernel's
    nonzero taps in raster order: kernel K9 on the card, K9T for the
    gradient. With ``axes`` the kernel covers only those axes. ``output``
    as :func:`gaussian_filter1d` (no paired order: SciPy has none for N-D
    kernels)."""
    x = _filter_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    weights, origin = _expand_weights_axes(x, weights, origin, axes)
    res = _f.apply_correlate(x, weights, mode, cval, origin)
    return _finish_filter(res, dtype, out_array)


def convolve(X, weights, *, mode='reflect', cval=0.0, origin=0,
             output=None, axes=None, device=None):
    """N-D convolution (``scipy.ndimage.convolve``): correlation with the
    flipped kernel and mirrored origins."""
    x = _filter_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    weights, origin = _expand_weights_axes(x, weights, origin, axes)
    res = _f.apply_correlate(x, weights, mode, cval, origin,
                             convolution=True)
    return _finish_filter(res, dtype, out_array)


def generic_laplace(X, derivative2, *, mode='reflect', cval=0.0,
                    extra_arguments=(), extra_keywords=None, axes=None,
                    output=None, device=None):
    """Laplace with a second-derivative callable
    (``scipy.ndimage.generic_laplace``): ``derivative2(x, axis, mode, cval,
    *extra_arguments, **extra_keywords)`` takes and returns a tensor on the
    device and is called once per axis (SciPy's in-place ``output``
    argument is dropped); the terms are summed."""
    extra_keywords = extra_keywords or {}
    x = _filter_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    out = None
    for ax in _filter_axes(axes, x.dim()):
        term = _to_device(derivative2(x, ax, mode, cval, *extra_arguments,
                                      **extra_keywords), x.device)
        out = term if out is None else out + term
    if out is None:
        out = torch.zeros_like(x)
    return _finish_filter(out, dtype, out_array)


def generic_gradient_magnitude(X, derivative, *, mode='reflect', cval=0.0,
                               extra_arguments=(), extra_keywords=None,
                               axes=None, output=None, device=None):
    """Gradient magnitude with a derivative callable
    (``scipy.ndimage.generic_gradient_magnitude``; the callable as in
    :func:`generic_laplace`)."""
    extra_keywords = extra_keywords or {}
    x = _filter_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    out = None
    for ax in _filter_axes(axes, x.dim()):
        d = _to_device(derivative(x, ax, mode, cval, *extra_arguments,
                                  **extra_keywords), x.device)
        d = d * d
        out = d if out is None else out + d
    if out is None:
        return _finish_filter(torch.zeros_like(x), dtype, out_array)
    if not out.is_floating_point():
        out = out.to(torch.float64)
    return _finish_filter(torch.sqrt(out), dtype, out_array)


# ---------------------------------------------------------------------------
# the morphology tier (the JAX package's core.py:1576-1923, 1980-2146)


def _morph_input(X, device) -> torch.Tensor:
    """``X`` on the device (as :func:`_filter_input`); a tensor that
    requires grad raises: the morphology tier has no gradient."""
    x = _filter_input(X, device)
    if x.requires_grad:
        raise RuntimeError(
            "the morphology and rank filters of elasticdeform_tpu_torch have "
            "no gradient; pass a tensor that does not require grad (detach "
            "it)")
    return x


def _host_array(a):
    """A footprint or structure as a numpy array (tensors copied to the
    host); None stays None."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


_WRAP_VIA_INT64 = (torch.uint16, torch.uint32)


def _wrapping(op, a: torch.Tensor, *rest: torch.Tensor) -> torch.Tensor:
    """``op`` on same-typed tensors with integer wraparound, as the JAX
    package computes; uint16/uint32/uint64, which PyTorch cannot add or
    subtract, go through int64 (uint64 by its bits) and back. bool refuses
    subtraction, as JAX does."""
    if a.dtype == torch.bool and op is torch.sub:
        raise TypeError("sub does not accept dtype bool")
    if a.dtype in _WRAP_VIA_INT64:
        return op(a.to(torch.int64), *[t.to(torch.int64) for t in rest]).to(
            a.dtype)
    if a.dtype == torch.uint64:
        return op(a.view(torch.int64),
                  *[t.view(torch.int64) for t in rest]).view(torch.uint64)
    return op(a, *rest)


def minimum_filter1d(X, size, axis=-1, *, mode='reflect', cval=0.0, origin=0,
                     output=None, device=None):
    """1-D minimum filter (``scipy.ndimage.minimum_filter1d``): kernel K10 on
    the card, the input's dtype kept (no arithmetic). ``cval`` pads in the
    input's dtype as numpy converts it (a fraction truncates, a value out of
    the integer range raises OverflowError). ``output`` as
    :func:`gaussian_filter1d`."""
    x = _morph_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    res = _m.apply_min_max_filter1d(x, size, axis, mode, cval, origin, True)
    return _finish_filter(res, dtype, out_array)


def maximum_filter1d(X, size, axis=-1, *, mode='reflect', cval=0.0, origin=0,
                     output=None, device=None):
    """1-D maximum filter (``scipy.ndimage.maximum_filter1d``; K10)."""
    x = _morph_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    res = _m.apply_min_max_filter1d(x, size, axis, mode, cval, origin, False)
    return _finish_filter(res, dtype, out_array)


def minimum_filter(X, size=None, footprint=None, *, mode='reflect', cval=0.0,
                   origin=0, axes=None, output=None, device=None):
    """N-D minimum filter (``scipy.ndimage.minimum_filter``): a box runs one
    K10 pass per axis, as SciPy separates it; any other footprint runs K11
    over its taps. ``mode`` may be per axis for a box only."""
    x = _morph_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    res = _m.apply_min_max_filter(x, size, _host_array(footprint), None, mode,
                                  cval, origin, True, axes)
    return _finish_filter(res, dtype, out_array)


def maximum_filter(X, size=None, footprint=None, *, mode='reflect', cval=0.0,
                   origin=0, axes=None, output=None, device=None):
    """N-D maximum filter (``scipy.ndimage.maximum_filter``; K10 or K11)."""
    x = _morph_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    res = _m.apply_min_max_filter(x, size, _host_array(footprint), None, mode,
                                  cval, origin, False, axes)
    return _finish_filter(res, dtype, out_array)


def rank_filter(X, rank, size=None, footprint=None, *, mode='reflect',
                cval=0.0, origin=0, axes=None, output=None, device=None):
    """Order-statistic filter (``scipy.ndimage.rank_filter``): kernel K12,
    the JAX package's pruned comparator network up to 64 taps (a window
    holding a NaN gives NaN), a selection in sorted order above (NaN last).
    Negative ranks count from the top; the lowest and highest rank run as
    minimum / maximum filters."""
    x = _morph_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    res = _m.apply_rank_filter(x, rank, size, _host_array(footprint), mode,
                               cval, origin, 'rank', axes)
    return _finish_filter(res, dtype, out_array)


def median_filter(X, size=None, footprint=None, *, mode='reflect', cval=0.0,
                  origin=0, axes=None, output=None, device=None):
    """Median filter (``scipy.ndimage.median_filter``): :func:`rank_filter`
    at rank ``footprint_size // 2``."""
    x = _morph_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    res = _m.apply_rank_filter(x, 0, size, _host_array(footprint), mode, cval,
                               origin, 'median', axes)
    return _finish_filter(res, dtype, out_array)


def percentile_filter(X, percentile, size=None, footprint=None, *,
                      mode='reflect', cval=0.0, origin=0, axes=None,
                      output=None, device=None):
    """Percentile filter (``scipy.ndimage.percentile_filter``): SciPy's rank
    ``int(k * p / 100)`` of ``k`` taps."""
    x = _morph_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    res = _m.apply_rank_filter(x, percentile, size, _host_array(footprint),
                               mode, cval, origin, 'percentile', axes)
    return _finish_filter(res, dtype, out_array)


def grey_erosion(X, size=None, footprint=None, structure=None, *,
                 mode='reflect', cval=0.0, origin=0, axes=None, output=None,
                 device=None):
    """Greyscale erosion (``scipy.ndimage.grey_erosion``): ``min(x(y + z) -
    s(z))`` over the footprint (K11); a flat structure is a minimum filter.
    An integer or bool input with a non-flat structure computes in float64,
    then truncates and saturates at its type's range, as the JAX package
    casts."""
    if size is None and footprint is None and structure is None:
        raise ValueError("size, footprint, or structure must be specified")
    x = _morph_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    res = _m.apply_min_max_filter(x, size, _host_array(footprint),
                                  _host_array(structure), mode, cval, origin,
                                  True, axes)
    return _finish_filter(res, dtype, out_array)


def grey_dilation(X, size=None, footprint=None, structure=None, *,
                  mode='reflect', cval=0.0, origin=0, axes=None, output=None,
                  device=None):
    """Greyscale dilation (``scipy.ndimage.grey_dilation``): the footprint
    and structure reflected and the origin mirrored (shifted by one on even
    axes), as SciPy does, then a maximum (K10 or K11)."""
    if size is None and footprint is None and structure is None:
        raise ValueError("size, footprint, or structure must be specified")
    structure, footprint = _host_array(structure), _host_array(footprint)
    if structure is not None:
        structure = structure[(slice(None, None, -1),) * structure.ndim]
    if footprint is not None:
        footprint = footprint[(slice(None, None, -1),) * footprint.ndim]
    x = _morph_input(X, device)
    axes_t = tuple(range(x.dim())) if axes is None else (
        (axes,) if np.isscalar(axes) else tuple(axes))
    axes_t = tuple(int(a) % x.dim() for a in axes_t)
    origins = [-int(o) for o in
               _f.normalize_sequence(origin, len(axes_t), "origin")]
    for ii in range(len(origins)):
        if footprint is not None:
            sz = footprint.shape[ii]
        elif structure is not None:
            sz = structure.shape[ii]
        elif np.isscalar(size):
            sz = size
        else:
            sz = size[ii]
        if not sz & 1:
            origins[ii] -= 1
    dtype, out_array = _resolve_output(x, output)
    res = _m.apply_min_max_filter(x, size, footprint, structure, mode, cval,
                                  origins, False, axes_t)
    return _finish_filter(res, dtype, out_array)


def grey_opening(X, size=None, footprint=None, structure=None, *,
                 mode='reflect', cval=0.0, origin=0, axes=None, output=None,
                 device=None):
    """Greyscale opening (``scipy.ndimage.grey_opening``): erosion, then
    dilation."""
    x = _morph_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    kw = dict(mode=mode, cval=cval, origin=origin, axes=axes, device=x.device)
    tmp = grey_erosion(x, size, footprint, structure, **kw)
    res = grey_dilation(tmp, size, footprint, structure, **kw)
    return _finish_filter(res, dtype, out_array)


def grey_closing(X, size=None, footprint=None, structure=None, *,
                 mode='reflect', cval=0.0, origin=0, axes=None, output=None,
                 device=None):
    """Greyscale closing (``scipy.ndimage.grey_closing``): dilation, then
    erosion."""
    x = _morph_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    kw = dict(mode=mode, cval=cval, origin=origin, axes=axes, device=x.device)
    tmp = grey_dilation(x, size, footprint, structure, **kw)
    res = grey_erosion(tmp, size, footprint, structure, **kw)
    return _finish_filter(res, dtype, out_array)


def morphological_gradient(X, size=None, footprint=None, structure=None, *,
                           mode='reflect', cval=0.0, origin=0, axes=None,
                           output=None, device=None):
    """Morphological gradient (``scipy.ndimage.morphological_gradient``):
    dilation minus erosion, integers wrapping."""
    x = _morph_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    kw = dict(mode=mode, cval=cval, origin=origin, axes=axes, device=x.device)
    res = _wrapping(torch.sub,
                    grey_dilation(x, size, footprint, structure, **kw),
                    grey_erosion(x, size, footprint, structure, **kw))
    return _finish_filter(res, dtype, out_array)


def morphological_laplace(X, size=None, footprint=None, structure=None, *,
                          mode='reflect', cval=0.0, origin=0, axes=None,
                          output=None, device=None):
    """Morphological Laplace (``scipy.ndimage.morphological_laplace``):
    dilation + erosion - 2 x, in the JAX package's order, integers
    wrapping."""
    x = _morph_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    kw = dict(mode=mode, cval=cval, origin=origin, axes=axes, device=x.device)
    res = _wrapping(torch.add,
                    grey_dilation(x, size, footprint, structure, **kw),
                    grey_erosion(x, size, footprint, structure, **kw))
    res = _wrapping(torch.sub, _wrapping(torch.sub, res, x), x)
    return _finish_filter(res, dtype, out_array)


def white_tophat(X, size=None, footprint=None, structure=None, *,
                 mode='reflect', cval=0.0, origin=0, axes=None, output=None,
                 device=None):
    """White top-hat (``scipy.ndimage.white_tophat``): the input minus its
    opening (bool: exclusive or)."""
    x = _morph_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    tmp = grey_opening(x, size, footprint, structure, mode=mode, cval=cval,
                       origin=origin, axes=axes, device=x.device)
    if x.dtype == torch.bool and tmp.dtype == torch.bool:
        res = x ^ tmp
    else:
        res = _wrapping(torch.sub, x, tmp)
    return _finish_filter(res, dtype, out_array)


def black_tophat(X, size=None, footprint=None, structure=None, *,
                 mode='reflect', cval=0.0, origin=0, axes=None, output=None,
                 device=None):
    """Black top-hat (``scipy.ndimage.black_tophat``): the closing minus the
    input (bool: exclusive or)."""
    x = _morph_input(X, device)
    dtype, out_array = _resolve_output(x, output)
    tmp = grey_closing(x, size, footprint, structure, mode=mode, cval=cval,
                       origin=origin, axes=axes, device=x.device)
    if x.dtype == torch.bool and tmp.dtype == torch.bool:
        res = tmp ^ x
    else:
        res = _wrapping(torch.sub, tmp, x)
    return _finish_filter(res, dtype, out_array)


def _binary_axes_args(ndim: int, structure, origin, axes):
    """SciPy's ``axes=`` for binary morphology: the structure (default:
    connectivity 1 over ``axes``) and the per-axis ``origin`` cover only
    ``axes``; the other axes get extent 1."""
    axes_t = _f._normalize_axes(axes, ndim)
    structure = _host_array(structure)
    if len(axes_t) == ndim:
        return structure, origin
    if structure is None:
        structure = _m.generate_binary_structure(len(axes_t), 1)
    structure = _f._expand_to_ndim(structure, ndim, axes_t)
    origins = _f.normalize_sequence(origin, len(axes_t), "origin")
    full = [0] * ndim
    for a, o in zip(axes_t, origins):
        full[a] = int(o)
    return structure, full


def _binary(X, structure, iterations, mask, border_value, origin, axes,
            dilation, device):
    x = _morph_input(X, device)
    structure, origin = _binary_axes_args(x.dim(), structure, origin, axes)
    m = None if mask is None else _to_device(mask, x.device)
    return _m.binary_erosion_dilation(x, structure, iterations, m,
                                      border_value, origin, dilation)


def binary_erosion(X, structure=None, iterations=1, mask=None, *,
                   border_value=0, origin=0, axes=None, brute_force=False,
                   device=None):
    """Binary erosion (``scipy.ndimage.binary_erosion``): ``iterations``
    sweeps of kernel K13, or sweeps to the fixpoint for ``iterations <= 0``;
    ``mask`` gates which voxels may change each sweep; the border extends
    with ``border_value``; with ``axes`` the structure covers only those
    axes. ``brute_force`` is accepted and ignored, as in the JAX package
    (every sweep reconsiders every voxel). Returns a bool tensor."""
    return _binary(X, structure, iterations, mask, border_value, origin,
                   axes, False, device)


def binary_dilation(X, structure=None, iterations=1, mask=None, *,
                    border_value=0, origin=0, axes=None, brute_force=False,
                    device=None):
    """Binary dilation (``scipy.ndimage.binary_dilation``): the structure
    reflected and the origin mirrored, as SciPy does; otherwise as
    :func:`binary_erosion`."""
    return _binary(X, structure, iterations, mask, border_value, origin,
                   axes, True, device)


def binary_opening(X, structure=None, iterations=1, mask=None, *,
                   border_value=0, origin=0, axes=None, brute_force=False,
                   device=None):
    """Binary opening (``scipy.ndimage.binary_opening``): ``iterations``
    erosions, then as many dilations."""
    x = _morph_input(X, device)
    structure, origin = _binary_axes_args(x.dim(), structure, origin, axes)
    kw = dict(border_value=border_value, origin=origin, device=x.device)
    tmp = binary_erosion(x, structure, iterations, mask, **kw)
    return binary_dilation(tmp, structure, iterations, mask, **kw)


def binary_closing(X, structure=None, iterations=1, mask=None, *,
                   border_value=0, origin=0, axes=None, brute_force=False,
                   device=None):
    """Binary closing (``scipy.ndimage.binary_closing``): ``iterations``
    dilations, then as many erosions."""
    x = _morph_input(X, device)
    structure, origin = _binary_axes_args(x.dim(), structure, origin, axes)
    kw = dict(border_value=border_value, origin=origin, device=x.device)
    tmp = binary_dilation(x, structure, iterations, mask, **kw)
    return binary_erosion(tmp, structure, iterations, mask, **kw)


def binary_propagation(X, structure=None, mask=None, *, border_value=0,
                       origin=0, axes=None, device=None):
    """Binary propagation (``scipy.ndimage.binary_propagation``): dilation
    to the fixpoint inside ``mask`` (reconstruction by dilation)."""
    x = _morph_input(X, device)
    structure, origin = _binary_axes_args(x.dim(), structure, origin, axes)
    return binary_dilation(x, structure, -1, mask, border_value=border_value,
                           origin=origin, device=x.device)


def binary_fill_holes(X, structure=None, *, origin=0, axes=None,
                      device=None):
    """Hole filling (``scipy.ndimage.binary_fill_holes``): the background
    propagated from the border (``border_value=1``) through the complement,
    to the fixpoint, then inverted."""
    x = _morph_input(X, device) != 0
    structure, origin = _binary_axes_args(x.dim(), structure, origin, axes)
    seed = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    reached = binary_dilation(seed, structure, -1, ~x, border_value=1,
                              origin=origin, device=x.device)
    return ~reached


def binary_hit_or_miss(X, structure1=None, structure2=None, *, origin1=0,
                       origin2=None, axes=None, device=None):
    """Binary hit-or-miss (``scipy.ndimage.binary_hit_or_miss``):
    ``erosion(x, s1) & erosion(~x, s2)``, ``s2`` defaulting to ``~s1``, the
    second erosion with a border of 1."""
    x = _morph_input(X, device) != 0
    axes_t = _f._normalize_axes(axes, x.dim())
    if structure1 is None:
        structure1 = _m.generate_binary_structure(len(axes_t), 1)
    else:
        structure1 = _host_array(structure1)
    if structure2 is None:
        structure2 = np.logical_not(structure1)
    else:
        structure2 = _host_array(structure2)
    if origin2 is None:
        origin2 = origin1
    structure1, origin1 = _binary_axes_args(x.dim(), structure1, origin1,
                                            axes)
    structure2, origin2 = _binary_axes_args(x.dim(), structure2, origin2,
                                            axes)
    tmp1 = binary_erosion(x, structure1, 1, None, border_value=0,
                          origin=origin1, device=x.device)
    tmp2 = binary_erosion(~x, structure2, 1, None, border_value=1,
                          origin=origin2, device=x.device)
    return tmp1 & tmp2


# the RuntimeErrors torch.func.vmap raises when a callable turns a batched
# tensor into numpy or a Python number or bool: those callables run once per
# voxel (or line) on the host instead, as the JAX package's fallback does
_HOST_CALLABLE_ERRORS = (
    "Cannot access data pointer of Tensor that doesn't have storage",
    "vmap: It looks like you're calling .item() on a Tensor",
    "vmap: It looks like you're attempting to use a Tensor in some "
    "data-dependent control flow")


def _map_rows(fn, rows: torch.Tensor) -> torch.Tensor:
    """``fn`` over the rows of ``rows``: ``torch.func.vmap``, or one host
    call per row for a callable that needs numpy values."""
    try:
        return _to_device(torch.func.vmap(fn)(rows), rows.device)
    except RuntimeError as e:
        if not str(e).startswith(_HOST_CALLABLE_ERRORS):
            raise
    host = rows.cpu().numpy()
    return _to_device(np.asarray([fn(host[i]) for i in range(len(host))]),
                      rows.device)


def generic_filter(X, function, size=None, footprint=None, output=None, *,
                   mode='reflect', cval=0.0, origin=0, extra_arguments=(),
                   extra_keywords=None, axes=None, device=None):
    """Window filter with a callable (``scipy.ndimage.generic_filter``): the
    footprint's taps of every voxel stacked along a new trailing axis (raster
    order, SciPy's window order) and ``function(taps, *extra_arguments,
    **extra_keywords)`` mapped over all voxels with ``torch.func.vmap``; a
    callable that needs numpy values (``np.ptp``) runs once per voxel on the
    host."""
    extra_keywords = extra_keywords or {}
    x = _morph_input(X, device)
    out_dtype, out_array = _resolve_output(x, output)
    footprint, origins = _m._footprint_for(x, size, _host_array(footprint),
                                           origin, axes)
    stack = _m.footprint_tap_stack(x, footprint, origins, mode, cval)
    out = _map_rows(lambda v: function(v, *extra_arguments, **extra_keywords),
                    stack.reshape(-1, stack.shape[-1]))
    return _finish_filter(out.reshape(x.shape), out_dtype, out_array)


def generic_filter1d(X, function, filter_size, axis=-1, output=None, *,
                     mode='reflect', cval=0.0, origin=0, extra_arguments=(),
                     extra_keywords=None, device=None):
    """Line filter with a callable (``scipy.ndimage.generic_filter1d``), in
    the JAX package's functional form: ``function(line_in) -> line_out``,
    ``line_in`` the boundary-extended line of ``n + filter_size - 1``
    samples, ``line_out`` of ``n``; mapped over all lines as
    :func:`generic_filter` maps."""
    extra_keywords = extra_keywords or {}
    x = _morph_input(X, device)
    out_dtype, out_array = _resolve_output(x, output)
    axis = axis % x.dim()
    size = int(filter_size)
    if size < 1:
        raise RuntimeError("invalid filter size")
    c = size // 2 + int(origin)
    if not 0 <= c < size:
        raise ValueError("invalid origin")
    mode = _f.check_mode(mode)
    cv = _m._pad_value(cval, x.dtype, mode, [(c, size - 1 - c)])
    xp = _m._unplain(_f.pad_axis(_m._plain(x), axis, c, size - 1 - c, mode,
                                 _m._plain_scalar(cv, x.dtype)), x.dtype)
    n = int(x.shape[axis])
    moved = torch.movedim(xp, axis, -1)
    out = _map_rows(lambda v: function(v, *extra_arguments, **extra_keywords),
                    moved.reshape(-1, moved.shape[-1]))
    if out.shape[-1] != n:
        raise ValueError(f"function must return lines of length {n}; got "
                         f"{out.shape[-1]}")
    out = out.reshape(tuple(moved.shape[:-1]) + (n,))
    return _finish_filter(torch.movedim(out, -1, axis), out_dtype, out_array)


def vectorized_filter(X, function, *, size=None, footprint=None,
                      mode='reflect', cval=None, origin=None, axes=None,
                      batch_memory=None, device=None):
    """Window filter with a vectorized callable
    (``scipy.ndimage.vectorized_filter``): ``function(windows, axis=...)``
    is called once, the window axes appended as trailing axes (``axis`` the
    tuple of them) or, with a ``footprint``, its selected taps flattened into
    one trailing axis (``axis=-1``). The five modes, or ``'valid'`` (the
    output shrinks by ``size - 1``). ``batch_memory`` is accepted and
    ignored."""
    x = _morph_input(X, device)
    axes_t = _f._normalize_axes(axes, x.dim())
    n_axes = len(axes_t)
    footprint = _host_array(footprint)
    if footprint is not None:
        footprint = footprint.astype(bool)
        if footprint.ndim != n_axes:
            raise ValueError("footprint.ndim must equal len(axes)")
        sizes = list(footprint.shape)
    else:
        if size is None:
            raise ValueError("either size or footprint must be given")
        sizes = [int(s) for s in _f.normalize_sequence(size, n_axes, "size")]
    origins = [int(o) for o in _f.normalize_sequence(
        0 if origin is None else origin, n_axes, "origin")]
    if cval is not None and mode != 'constant':
        raise ValueError(
            "Use of `cval` is compatible only with `mode='constant'`.")
    cval = 0.0 if cval is None else cval
    work = _m._plain(x)
    out_shape = list(x.shape)
    if mode == 'valid':
        for ax, s in zip(axes_t, sizes):
            out_shape[ax] = x.shape[ax] - (s - 1)
            if out_shape[ax] < 1:
                raise ValueError("size must not exceed input shape in "
                                 "'valid' mode")
    else:
        md = _f.check_mode(mode)
        for ax, s, o in zip(axes_t, sizes, origins):
            lo, hi = s // 2 + o, (s - 1) // 2 - o
            cv = _m._pad_value(cval, x.dtype, md, [(lo, hi)])
            work = _f.pad_axis(work, ax, lo, hi, md,
                               _m._plain_scalar(cv, x.dtype))
    for ax, s in zip(axes_t, sizes):
        work = torch.stack([work.narrow(ax, k, out_shape[ax])
                            for k in range(s)], -1)

    def raw(w):
        return w if w.dtype == x.dtype else _m._unplain(w, x.dtype)

    if footprint is not None:
        sel = torch.as_tensor(np.nonzero(footprint.reshape(-1))[0],
                              device=x.device)
        work = work.reshape(tuple(work.shape[:x.dim()]) + (-1,))
        return function(raw(torch.index_select(work, -1, sel)), axis=-1)
    return function(raw(work), axis=tuple(range(-n_axes, 0)))


# ---------------------------------------------------------------------------
# the distance transforms and the watershed (the JAX package's
# ops/distance.py and ops/morphology.py:522-597)


def _distance_input(X, device) -> torch.Tensor:
    return _to_device(X, _device(device)).detach()


def distance_transform_edt(input, sampling=None, return_distances=True,
                           return_indices=False, distances=None,
                           indices=None, *, device=None):
    """Exact Euclidean distance transform
    (``scipy.ndimage.distance_transform_edt``): each nonzero voxel's float64
    distance to the nearest zero voxel under ``sampling``, and with
    ``return_indices`` that voxel's ``(ndim, *shape)`` int32 coordinates,
    ties broken as the JAX package breaks them. Kernel K14 runs the first
    axis, K15 the rungs of each later one. Supplied numpy ``distances`` /
    ``indices`` arrays are filled in place and left out of the return, as
    SciPy does."""
    return _dist.distance_transform_edt(
        _distance_input(input, device), sampling, return_distances,
        return_indices, distances, indices)


def distance_transform_cdt(input, metric="chessboard", return_distances=True,
                           return_indices=False, distances=None,
                           indices=None, *, device=None):
    """Chamfer distance transform (``scipy.ndimage.distance_transform_cdt``):
    int32 distances for the ``'cityblock'``/``'taxicab'`` or
    ``'chessboard'`` metric or a 3^ndim structure, K16 sweeps to the
    fixpoint; indices, ``distances`` and ``indices`` as
    :func:`distance_transform_edt`."""
    return _dist.distance_transform_cdt(
        _distance_input(input, device), metric, return_distances,
        return_indices, distances, indices)


def distance_transform_bf(input, metric="euclidean", sampling=None,
                          return_distances=True, return_indices=False,
                          distances=None, indices=None, *, device=None):
    """Brute-force distance transform
    (``scipy.ndimage.distance_transform_bf``): ``'euclidean'`` (or 1) as
    :func:`distance_transform_edt`; ``'cityblock'``/``'taxicab'`` (2) and
    ``'chessboard'`` (3) as :func:`distance_transform_cdt`, uint32."""
    return _dist.distance_transform_bf(
        _distance_input(input, device), metric, sampling, return_distances,
        return_indices, distances, indices)


def watershed_ift(input, markers, structure=None, *, device=None):
    """Watershed by image foresting transform (``scipy.ndimage.watershed_ift``
    as the JAX package computes it): each voxel of the uint8 or uint16
    ``input`` joins the marker of its cheapest path, lexicographically
    (greatest intensity, length, label); negative markers flood too. K17
    sweeps to the fixpoint; the cross structure by default. Returns the
    labels in the markers' dtype."""
    return _m.watershed_ift(_distance_input(input, device),
                            _distance_input(markers, device), structure)
