"""Argument normalization for the numpy and torch entry points.

Semantics and error messages follow reference deform_grid.py:295-399, as
the JAX package's ``_normalize.py`` does; only shapes and dtypes are read,
so numpy arrays and torch tensors both pass.
"""

from __future__ import annotations

from elasticdeform_tpu_torch.affine import (
    normalize_affine,
    inverse_affine,
    apply_rotation_and_zoom,
)
from elasticdeform_tpu_torch.ops.deform import (
    InputSpec,
    DeformSpec,
    default_compute_dtype,
)
from elasticdeform_tpu_torch.ops.modes import mode_to_code
from elasticdeform_tpu_torch.ops.resample import numpy_dtype


class Shaped:
    """Shape-and-dtype stand-in for an array that is not there: one
    sample of a batch, or the input of a gradient call."""

    def __init__(self, shape, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.ndim = len(self.shape)
        self.dtype = dtype


def _is_array(x):
    return hasattr(x, "shape") and hasattr(x, "ndim") and hasattr(x, "dtype")


def _check(cond, msg=None):
    """``assert``-compatible validation that survives ``python -O``.

    The reference validates with plain asserts (deform_grid.py:295-399),
    which vanish under ``-O``; raising AssertionError explicitly keeps the
    exception type and message while always validating.
    """
    if not cond:
        raise AssertionError(msg) if msg is not None else AssertionError()


def normalize_inputs(X):
    """Single array or list of arrays (reference deform_grid.py:295-306)."""
    if _is_array(X):
        Xs = [X]
    elif isinstance(X, list):
        Xs = X
    else:
        raise Exception(
            'X should be a numpy.ndarray or a list of numpy.ndarrays.')
    _check(len(Xs) > 0, 'You must provide at least one image.')
    _check(all(_is_array(x) for x in Xs),
           'All elements of X should be numpy.ndarrays.')
    return Xs


def normalize_axis_list(axis, Xs):
    """Per-input deformed-axis tuples (reference deform_grid.py:308-326)."""
    if axis is None:
        axis = [tuple(range(x.ndim)) for x in Xs]
    elif isinstance(axis, int):
        axis = (axis,)
    if isinstance(axis, tuple):
        axis = [axis] * len(Xs)
    _check(len(axis) == len(Xs),
           'Number of axis tuples should match number of inputs.')
    input_shapes = []
    for x, ax in zip(Xs, axis):
        _check(isinstance(ax, tuple), 'axis should be given as a tuple')
        _check(all(isinstance(a, int) for a in ax), 'axis must contain ints')
        _check(len(ax) == len(axis[0]),
               'All axis tuples should have the same length.')
        _check(ax == tuple(sorted(set(ax))), 'axis must be sorted and unique')
        _check(all(0 <= a < x.ndim for a in ax), 'invalid axis for input')
        input_shapes.append(tuple(int(x.shape[d]) for d in ax))
    _check(len(set(input_shapes)) == 1,
           'All inputs should have the same shape.')
    deform_shape = input_shapes[0]
    return [tuple(ax) for ax in axis], deform_shape


def compute_output_shapes(Xs, axis, deform_shape, crop):
    """Crop geometry (reference deform_grid.py:328-354)."""
    naxis = len(axis[0])
    output_offset = [0] * naxis
    if crop is not None:
        _check(isinstance(crop, (tuple, list)),
               "crop must be a tuple or a list.")
        _check(len(crop) == len(deform_shape))
        output_shapes = [list(int(s) for s in x.shape) for x in Xs]
        for d in range(naxis):
            if isinstance(crop[d], slice):
                _check(crop[d].step is None)
                start = (crop[d].start or 0)
                stop = (crop[d].stop or deform_shape[d])
                _check(start >= 0)
                _check(start < stop and stop <= deform_shape[d])
                for i in range(len(Xs)):
                    output_shapes[i][axis[i][d]] = stop - start
                output_offset[d] = start
            else:
                raise Exception('Crop must be a slice.')
        output_shapes = [tuple(s) for s in output_shapes]
    else:
        output_shapes = [tuple(int(s) for s in x.shape) for x in Xs]
    return output_shapes, tuple(output_offset)


def normalize_displacement(displacement, Xs, axis):
    """Reference deform_grid.py:356-360."""
    _check(_is_array(displacement),
           'Displacement matrix should be a numpy.ndarray.')
    _check(displacement.ndim == len(axis[0]) + 1,
           'Number of dimensions of displacement does not match input.')
    _check(displacement.shape[0] == len(axis[0]),
           'First dimension of displacement should match number of input '
           'dimensions.')
    return displacement


def normalize_order(order, Xs):
    """Reference deform_grid.py:362-367."""
    if not isinstance(order, (tuple, list)):
        order = [order] * len(Xs)
    _check(len(Xs) == len(order),
           'Number of order parameters should be equal to number of inputs.')
    _check(all(0 <= o and o <= 5 for o in order),
           'order should be 0, 1, 2, 3, 4 or 5.')
    return [int(o) for o in order]


def normalize_mode(mode, Xs):
    """Reference deform_grid.py:369-374."""
    if not isinstance(mode, (tuple, list)):
        mode = [mode] * len(Xs)
    mode = [mode_to_code(m) for m in mode]
    _check(len(Xs) == len(mode),
           'Number of mode parameters should be equal to number of inputs.')
    return mode


def cval_scalar(c):
    """Coerce one cval to a Python scalar with the reference's ``float()``
    (and its exception text for non-numeric values, deform_grid.py:380);
    complex values stay complex."""
    if isinstance(c, complex) or \
            getattr(getattr(c, "dtype", None), "kind", "") == "c":
        return complex(c)
    return float(c)


def normalize_cval(cval, Xs):
    """Reference deform_grid.py:376-380."""
    if not isinstance(cval, (tuple, list)):
        cval = [cval] * len(Xs)
    _check(len(Xs) == len(cval),
           'Number of cval parameters should be equal to number of inputs.')
    return [cval_scalar(c) for c in cval]


def resolve_affine(affine, rotate, zoom, axis, output_shapes):
    """Full inverse-affine resolution (reference deform_grid.py:146-152)."""
    affine = normalize_affine(affine, len(axis[0]))
    inv = inverse_affine(affine)
    inv = apply_rotation_and_zoom(
        rotate, zoom, inv, [output_shapes[0][d] for d in axis[0]])
    return inv


def build_spec(Xs, axis, deform_shape, output_shapes, output_offset,
               orders, modes, cvals, prefilter, displacement_dtype):
    """Assemble the static :class:`DeformSpec` for a call.

    Raises TypeError for dtypes this package does not take yet (complex,
    float16, bfloat16) and for a complex cval.
    """
    dtypes = [numpy_dtype(x.dtype) for x in Xs]
    if any(isinstance(c, complex) for c in cvals):
        raise TypeError("complex cval is not supported by "
                        "elasticdeform_tpu_torch yet")
    compute_dtype = default_compute_dtype(numpy_dtype(displacement_dtype),
                                          *dtypes)
    out_spatial = tuple(output_shapes[0][d] for d in axis[0])
    inputs = tuple(
        InputSpec(
            shape=tuple(int(s) for s in x.shape),
            dtype=dt.name,
            axis=tuple(ax),
            order=o,
            mode=m,
            cval=c,
            out_shape=tuple(int(s) for s in os),
        )
        for x, dt, ax, o, m, c, os in zip(Xs, dtypes, axis, orders, modes,
                                          cvals, output_shapes))
    return DeformSpec(
        inputs=inputs,
        deform_shape=tuple(deform_shape),
        out_spatial=out_spatial,
        offsets=tuple(output_offset),
        prefilter=bool(prefilter),
        compute_dtype=str(compute_dtype),
    )


def gradient_inputs(dYs, X_shape, crop, batched=False):
    """Stand-ins for the forward inputs of a gradient call: the uncropped
    shapes ``X_shape`` (per sample when ``batched``) with the dtypes of
    ``dYs`` (reference deform_grid.py:234-245; the JAX package's
    ``core.py:108-123`` and ``:303-313``). ``X_shape`` is a tuple, a list
    of tuples, or None, which means the shapes of ``dYs`` and is refused
    with ``crop``."""
    lead = 1 if batched else 0
    if isinstance(X_shape, tuple):
        X_shape = [X_shape]
    elif X_shape is None:
        if crop is not None:
            raise ValueError(
                "X_shape is required if the crop parameter is given.")
        X_shape = [tuple(dy.shape[lead:]) for dy in dYs]
    return [Shaped(s, dy.dtype) for s, dy in zip(X_shape, dYs)]


def check_gradient_shapes(output_shapes, dYs, batched=False):
    """Refuse ``dYs`` whose shapes are not the forward's output shapes
    (reference deform_grid.py:250-256)."""
    lead = 1 if batched else 0
    given = [tuple(int(d) for d in dy.shape[lead:]) for dy in dYs]
    if [tuple(s) for s in output_shapes] != given:
        raise ValueError("X_shape does not match output shape and cropping. "
                         "Expected output shape is %s, but %s given."
                         % (str(output_shapes), str(given)))
