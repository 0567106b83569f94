"""Affine / rotate / zoom composition.

Host-side (numpy, float64) equivalents of reference deform_grid.py:382-438.
The affine is supplied as the *output* transform; the kernel consumes its
inverse (pull-back), with rotate negated and zoom inverted, composed around
the cropped-output center ``shape/2 - 0.5`` (reference deform_grid.py:426-438,
2D-only constraint at :429).
"""

from __future__ import annotations

import numpy as np


def _check(cond, msg):
    # assert-compatible validation that survives ``python -O`` (exact
    # reference error messages, see _normalize._check)
    if not cond:
        raise AssertionError(msg)


def normalize_affine(affine, n_axes: int):
    """Validate/convert an affine matrix (reference deform_grid.py:382-390).

    Accepts ``(n, n+1)`` or homogeneous ``(n+1, n+1)``; note the reference's
    homogeneous check compares the last row against ``[0, 0, 1]`` and so only
    works in 2D — we keep the general bottom-row check ``[0,...,0,1]`` which
    is the obvious intent and a strict superset for 2D.
    """
    if affine is None:
        return None
    affine = np.asarray(affine)
    if affine.shape == (n_axes + 1, n_axes + 1):
        expected = np.concatenate([np.zeros(n_axes), [1.0]])
        _check(np.allclose(affine[n_axes, :], expected),
               'Invalid affine matrix.')
        affine = affine[:n_axes, :]
    _check(affine.shape == (n_axes, n_axes + 1),
           'Affine matrix should have shape (ndim, ndim+1).')
    return np.asarray(affine, dtype=np.float64)


def inverse_affine(affine):
    """Invert an (n, n+1) affine (reference deform_grid.py:392-399)."""
    if affine is None:
        return None
    inv = np.zeros(affine.shape, dtype=np.float64)
    inv[:, :-1] = np.linalg.inv(affine[:, :-1])
    inv[:, -1] = -np.dot(inv[:, :-1], affine[:, -1])
    return inv


def _rotation_zoom_matrix(angle, zoom, center):
    """Homogeneous 2D rotate/zoom about ``center``
    (reference deform_grid.py:401-424)."""
    affine = None
    if center is not None:
        a = np.array([[1, 0, -center[0]],
                      [0, 1, -center[1]],
                      [0, 0, 1]], dtype=np.float64)
        affine = a
    if angle:
        theta = np.radians(angle)
        a = np.array([[np.cos(theta), -np.sin(theta), 0],
                      [np.sin(theta),  np.cos(theta), 0],
                      [0, 0, 1]], dtype=np.float64)
        affine = a if affine is None else np.dot(a, affine)
    if zoom:
        a = np.array([[zoom, 0, 0],
                      [0, zoom, 0],
                      [0, 0, 1]], dtype=np.float64)
        affine = a if affine is None else np.dot(a, affine)
    if center is not None:
        a = np.array([[1, 0, center[0]],
                      [0, 1, center[1]],
                      [0, 0, 1]], dtype=np.float64)
        affine = np.dot(a, affine)
    return affine


def apply_rotation_and_zoom(rotate, zoom, inv_affine, output_shape):
    """Fold rotate/zoom into the inverse affine
    (reference deform_grid.py:426-438)."""
    if rotate is None and zoom is None:
        return inv_affine
    _check(len(output_shape) == 2,
           'Zoom and rotate is only implemented for 2D images.')
    rotate = -float(rotate or 0)
    zoom = 1.0 / float(zoom or 1)
    center = np.asarray(output_shape, dtype=np.float64) / 2 - 0.5
    new_inv = _rotation_zoom_matrix(rotate, zoom, center)
    if inv_affine is not None:
        base = np.eye(3, dtype=np.float64)
        base[:-1, :] = inv_affine
        return np.dot(new_inv, base)[:2, :]
    return new_inv[:2, :]
