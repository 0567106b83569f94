"""Numpy API, mirroring the reference's public surface.

``deform_grid`` and ``deform_random_grid`` (reference deform_grid.py:6-179)
and the batched ``deform_batch``: numpy in, numpy out with the input
dtypes, computed on ``device`` (default ``"cuda"``; pass ``device="cpu"``
to run on the host). Counterpart of the JAX package's ``api.py``.
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
                rotate=None, zoom=None, *, device=None):
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
                      affine=affine, rotate=rotate, zoom=zoom, device=device)
    outputs = _to_host(ys, Xs)
    return outputs if isinstance(X, list) else outputs[0]


def deform_batch(X, displacement, order=3, mode='constant', cval=0.0,
                 crop=None, prefilter=True, axis=None, affine=None,
                 rotate=None, zoom=None, *, device=None):
    """Batched :func:`deform_grid`: ``X`` ``(B, *image_shape)`` (or a list
    of such arrays), ``displacement`` ``(B, naxis, *points)`` per-sample
    grids; numpy in, numpy out. Other parameters are shared by the batch
    (``axis``/``crop`` refer to the per-sample shape)."""
    Xs = _n.normalize_inputs(X)
    ys = _core.deform_batch(Xs, displacement, order=order, mode=mode,
                            cval=cval, crop=crop, prefilter=prefilter,
                            axis=axis, affine=affine, rotate=rotate,
                            zoom=zoom, device=device)
    outputs = _to_host(ys, Xs)
    return outputs if isinstance(X, list) else outputs[0]
