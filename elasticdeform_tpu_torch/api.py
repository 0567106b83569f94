"""Numpy API, mirroring the reference's public surface.

``deform_grid``, ``deform_random_grid`` and ``deform_grid_gradient``
(reference deform_grid.py:6-291), the batched ``deform_batch`` and
``deform_batch_gradient``, and the general resampler's ``map_coordinates``,
``geometric_transform`` and ``map_coordinates_gradient``: numpy in, numpy
out with the input dtypes, computed on ``device`` (default ``"cuda"``; pass
``device="cpu"`` to run on the host). Counterpart of the JAX package's
``api.py``, with its keyword-only ``strategy``, ``batch_impl`` and
``table_dtype`` (see :mod:`elasticdeform_tpu_torch.core`).
"""

from __future__ import annotations

import numpy as np

from elasticdeform_tpu_torch import _normalize as _n
from elasticdeform_tpu_torch import core as _core


def _to_host(ys, Xs):
    return [y.cpu().numpy().astype(np.dtype(x.dtype), copy=False)
            for y, x in zip(ys, Xs)]


def deform_random_grid(X, sigma=25, points=3, order=3, mode='constant',
                       cval=0.0, crop=None, prefilter=True, axis=None,
                       affine=None, rotate=None, zoom=None, *, device=None):
    """Elastic deformation of an image with a random displacement grid.

    Draws ``displacement = numpy.random.randn(naxis, *points) * sigma``
    from the *global* numpy RNG, as the reference does (seed it with
    ``numpy.random.seed``), and applies :func:`deform_grid`. ``points`` is
    an int or a per-axis sequence of control-point counts.
    """
    Xs = _n.normalize_inputs(X)
    _, deform_shape = _n.normalize_axis_list(axis, Xs)
    if not isinstance(points, (list, tuple)):
        points = [points] * len(deform_shape)
    displacement = np.random.randn(len(deform_shape), *points) * sigma
    return deform_grid(X, displacement, order, mode, cval, crop, prefilter,
                       axis, affine, rotate, zoom, device=device)


def deform_grid(X, displacement, order=3, mode='constant', cval=0.0,
                crop=None, prefilter=True, axis=None, affine=None,
                rotate=None, zoom=None, *, strategy="auto", device=None):
    """Elastic deformation of an image with a displacement grid.

    The coarse grid of per-axis displacement vectors is interpolated to a
    dense per-voxel field with cubic B-splines; the image is resampled at
    the displaced coordinates with a B-spline of the requested ``order``.

    Parameters
    ----------
    X : numpy array or list of arrays
        Image, or images deformed with the same grid; they may differ in
        dtype and channel axes but agree on the deformed axes' shape.
    displacement : numpy array
        ``(naxis, *points)`` control-point displacements, in voxels of the
        full image; control point ``i`` of ``points`` sits at
        ``i * (n - 1) / (points - 1)``.
    order : int or list of ints
        Spline order 0-5 (per input if a list).
    mode : str or list of str
        ``'nearest'``, ``'wrap'``, ``'reflect'``, ``'mirror'`` or
        ``'constant'``, with the reference's pre-SciPy-1.6 semantics.
    cval : float or list of floats
        Fill value of ``mode='constant'``.
    crop : None or list of slices
        One ``slice(start, stop)`` per deformed axis; only that window is
        computed, in full-image coordinates.
    prefilter : bool
        Prefilter the inputs for ``order > 1`` (False if they already are
        spline coefficients). The grid is always prefiltered.
    axis : None, int, tuple, or list of tuples
        Deformed axes per input (default all); the others are channels.
    affine : None or numpy array
        ``(naxis, naxis+1)`` or homogeneous ``(naxis+1, naxis+1)`` output
        transform; its inverse maps output coordinates before the
        displacement is added.
    rotate, zoom : None or float
        Rotation (degrees) and zoom about the output's centre, 2-D only.
    strategy : str, keyword-only
        ``'auto'``, ``'windows'`` or ``'gather'``, checked as the JAX
        package checks it; its strategies agree tap for tap, so it changes
        nothing here.
    device : None, str or torch.device, keyword-only
        Where to compute: ``None`` means ``"cuda"``.

    Returns
    -------
    numpy array or list of arrays
        The deformed image(s) with the input dtypes (integers rounded and
        clamped as the reference does, deform.c:287-306).
    """
    Xs = _n.normalize_inputs(X)
    ys = _core.deform(Xs, displacement, order=order, mode=mode, cval=cval,
                      crop=crop, prefilter=prefilter, axis=axis,
                      affine=affine, rotate=rotate, zoom=zoom,
                      strategy=strategy, device=device)
    outputs = _to_host(ys, Xs)
    return outputs if isinstance(X, list) else outputs[0]


def deform_grid_gradient(dY, displacement, order=3, mode='constant',
                         cval=0.0, crop=None, prefilter=True, axis=None,
                         X_shape=None, affine=None, rotate=None, zoom=None, *,
                         strategy="auto", device=None):
    """Gradient of :func:`deform_grid` with respect to the input image.

    Given the gradient ``dY`` of a scalar loss with respect to the output
    of :func:`deform_grid`, returns the gradient with respect to its input:
    the exact adjoint of the forward (scatter-add of the interpolation
    stencils, then the transposed spline prefilter), as the reference's
    ``deform_grid_gradient`` (reference deform_grid.py:182-291).

    Parameters
    ----------
    dY : numpy array or list of arrays
        Gradient(s) with respect to the deformed output(s), with the output
        shape(s) of the forward call (the cropped shape with ``crop``).
    displacement, order, mode, cval, crop, prefilter, axis, affine, \
rotate, zoom, strategy
        The values passed to the forward :func:`deform_grid` call.
    X_shape : None, tuple, or list of tuples
        Shape(s) of the forward input(s); required with ``crop``, else the
        shape(s) of ``dY``.
    device : None, str or torch.device, keyword-only
        Where to compute: ``None`` means ``"cuda"``.

    Returns
    -------
    numpy array or list of arrays
        Gradient(s) with respect to the input(s), with shape ``X_shape``
        and the dtype(s) of ``dY``. The gradient with respect to the
        displacement comes from autograd through
        :func:`elasticdeform_tpu_torch.deform`.
    """
    dYs = _n.normalize_inputs(dY)
    dxs = _core.deform_gradient(dYs, displacement, order=order, mode=mode,
                                cval=cval, crop=crop, prefilter=prefilter,
                                axis=axis, X_shape=X_shape, affine=affine,
                                rotate=rotate, zoom=zoom, strategy=strategy,
                                device=device)
    outputs = _to_host(dxs, dYs)
    return outputs if isinstance(dY, list) else outputs[0]


def deform_batch(X, displacement, order=3, mode='constant', cval=0.0,
                 crop=None, prefilter=True, axis=None, affine=None,
                 rotate=None, zoom=None, *, strategy="auto",
                 batch_impl="auto", table_dtype=None, device=None):
    """Batched :func:`deform_grid`: ``X`` ``(B, *image_shape)`` (or a list
    of such arrays), ``displacement`` ``(B, naxis, *points)`` per-sample
    grids; numpy in, numpy out. Other parameters are shared by the batch
    (``axis``/``crop`` refer to the per-sample shape)."""
    Xs = _n.normalize_inputs(X)
    ys = _core.deform_batch(Xs, displacement, order=order, mode=mode,
                            cval=cval, crop=crop, prefilter=prefilter,
                            axis=axis, affine=affine, rotate=rotate,
                            zoom=zoom, strategy=strategy,
                            batch_impl=batch_impl, table_dtype=table_dtype,
                            device=device)
    outputs = _to_host(ys, Xs)
    return outputs if isinstance(X, list) else outputs[0]


def deform_batch_gradient(dY, displacement, order=3, mode='constant',
                          cval=0.0, crop=None, prefilter=True, axis=None,
                          X_shape=None, affine=None, rotate=None, zoom=None,
                          *, strategy="auto", batch_impl="auto", device=None):
    """Batched :func:`deform_grid_gradient`: numpy in, numpy out. Maps
    ``dY`` ``(B, *output_shape)`` (or a list) to the input cotangents of
    :func:`deform_batch` given its per-sample grids ``(B, naxis,
    *points)``; ``X_shape`` is the per-sample uncropped input shape(s),
    required with ``crop``."""
    dYs = _n.normalize_inputs(dY)
    dxs = _core.deform_batch_gradient(
        dYs, displacement, order=order, mode=mode, cval=cval, crop=crop,
        prefilter=prefilter, axis=axis, X_shape=X_shape, affine=affine,
        rotate=rotate, zoom=zoom, strategy=strategy, batch_impl=batch_impl,
        device=device)
    outputs = _to_host(dxs, dYs)
    return outputs if isinstance(dY, list) else outputs[0]


def map_coordinates(X, coordinates, order=3, mode='constant', cval=0.0,
                    prefilter=True, axis=None, *, strategy="auto",
                    table_dtype=None, device=None):
    """Resample ``X`` at explicit per-voxel coordinates ``(naxis,
    *out_shape)``: numpy in, numpy out (the JAX package's
    ``api.map_coordinates``). The five mode names keep the reference's
    pre-SciPy-1.6 meaning; with ``axis`` the channel axes are carried
    along. See :func:`elasticdeform_tpu_torch.core.map_coordinates` for the
    tensor version, which also takes the grid modes and gives gradients."""
    X = np.asarray(X)
    y = _core._map_classic(X, np.asarray(coordinates), order, mode, cval,
                           prefilter, axis, device, strategy=strategy,
                           table_dtype=table_dtype)
    return y.cpu().numpy().astype(X.dtype, copy=False)


def geometric_transform(X, mapping, output_shape=None, order=3,
                        mode='constant', cval=0.0, prefilter=True,
                        extra_arguments=(), extra_keywords=None, *,
                        strategy="auto", device=None):
    """Resample through a coordinate mapping, numpy in and out
    (``scipy.ndimage.geometric_transform``): ``mapping`` gets a tuple of
    float64 output coordinate arrays of shape ``output_shape`` and returns
    one input coordinate array per axis; it runs once on the host, then
    :func:`map_coordinates` resamples on ``device``."""
    X = np.asarray(X)
    out_shape = tuple(int(s) for s in output_shape) \
        if output_shape is not None else X.shape
    idx = np.indices(out_shape, dtype=np.float64)
    coords = mapping(tuple(idx), *extra_arguments, **(extra_keywords or {}))
    coordinates = np.stack(
        [np.broadcast_to(np.asarray(c, dtype=np.float64), out_shape)
         for c in coords])
    return map_coordinates(X, coordinates, order, mode, cval, prefilter,
                           None, strategy=strategy, device=device)


def map_coordinates_gradient(dY, coordinates, order=3, mode='constant',
                             cval=0.0, prefilter=True, axis=None,
                             X_shape=None, *, strategy="auto", device=None):
    """Adjoint of :func:`map_coordinates` with respect to ``X``, numpy in
    and out: maps ``dY`` to an input cotangent of shape ``X_shape``
    (required) with the dtype of ``dY``, with no forward pass (kernels K3c
    and K4 on the card)."""
    if X_shape is None:
        raise ValueError("X_shape is required (the input shape cannot be "
                         "inferred from dY).")
    dY = np.asarray(dY)
    dx = _core._map_gradient_classic(
        dY, np.asarray(coordinates), order, mode, cval, prefilter, axis,
        tuple(int(s) for s in X_shape), device, strategy)
    return dx.cpu().numpy().astype(dY.dtype, copy=False)
