"""Coarse control-point grid -> dense per-voxel displacement field.

The reference interpolates the prefiltered control grid with an order-3
B-spline per output voxel, folding out-of-grid taps with mirror arithmetic
(reference deform.c:639-758; ``cp = (ncp-1) * (j + offset) / (idim-1)``,
deform.c:643,655). Along each axis that is a fixed linear map, so it is a
host-built float64 matrix per axis, applied with ``torch.tensordot``: a
small dense product (``ncp`` is a handful of points), which the JAX package
also leaves to its compiler rather than to a kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from elasticdeform_tpu_torch.ops.bspline import filter_start, spline_weights
from elasticdeform_tpu_torch.ops.modes import mirror_index_np
from elasticdeform_tpu_torch.ops.prefilter import filter_matrix

_DORDER = 3  # displacement spline order, hardcoded as in reference deform.c:375


@functools.lru_cache(maxsize=None)
def displacement_matrix(odim: int, ncp: int, idim: int, offset: int,
                        prefilter_grid: bool = False) -> np.ndarray:
    """Interpolation matrix ``W (odim, ncp)`` with ``dense = W @ coeffs``.

    Row ``j`` holds the order-3 weights of output position ``j + offset``
    scattered into the mirror-folded control-point columns. With
    ``prefilter_grid=True`` the grid's order-3 prefilter (reference
    deform_grid.py:165-169) is composed in (``W @ F``), so the caller passes
    the raw grid.
    """
    if idim <= 1:
        raise ValueError("deformed axes must have at least 2 elements")
    jj = np.arange(odim, dtype=np.float64)
    cp = (ncp - 1) * (jj + offset) / (idim - 1)
    start = filter_start(cp, _DORDER).astype(np.int64)
    W = np.zeros((odim, ncp), dtype=np.float64)
    rows = np.arange(odim)
    for tap, w in enumerate(spline_weights(cp, _DORDER)):
        np.add.at(W, (rows, mirror_index_np(start + tap, ncp)), w)
    if prefilter_grid:
        W = W @ filter_matrix(ncp, _DORDER)
    return W


def dense_displacement(displacement: torch.Tensor, out_shape, in_shape,
                       offsets) -> torch.Tensor:
    """Dense field ``(B, naxis, *out_shape)`` from raw control grids
    ``(B, naxis, *points)``, prefilter composed in.

    ``in_shape`` is the uncropped extent (the ``cp`` formula divides by it,
    reference deform.c:643) and ``offsets`` the per-axis crop offsets.
    """
    out = displacement
    for h in range(len(out_shape)):
        W = displacement_matrix(out_shape[h], out.shape[h + 2], in_shape[h],
                                offsets[h], True)
        Wt = torch.as_tensor(W, dtype=out.dtype, device=out.device)
        out = torch.movedim(torch.tensordot(Wt, out, dims=([1], [h + 2])),
                            0, h + 2)
    return out.contiguous()
