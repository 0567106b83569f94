"""B-spline interpolation weights, orders 0-5.

The closed-form polynomials of the reference
``get_spline_interpolation_weights`` (reference deform.c:160-268), with the
"last weight = 1 - sum(others)" rule (deform.c:261-265). The functions take
a torch tensor (the resample kernel's plain version) or a numpy float64
array (host-built displacement matrices).

On tensors every division divides by a 0-dim tensor on the same device, so
that PyTorch on the card computes a true division, as ``csrc/resample.cu``
does, and not a product with a rounded reciprocal (see ``ops/modes.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def _floor(cc):
    return torch.floor(cc) if isinstance(cc, torch.Tensor) else np.floor(cc)


def _div(a, c: float):
    if isinstance(a, torch.Tensor):
        return a / torch.tensor(c, dtype=a.dtype, device=a.device)
    return a / c


def filter_start(cc, order: int):
    """First tap of the (order+1)-wide window, as a floating floor:
    ``floor(cc) - order//2`` for odd orders, ``floor(cc + 0.5) - order//2``
    for even ones (reference deform.c:783-788)."""
    if order & 1:
        return _floor(cc) - order // 2
    return _floor(cc + 0.5) - order // 2


def spline_weights(cc, order: int):
    """List of ``order + 1`` per-tap weight arrays shaped like ``cc``."""
    if order == 0:
        # order 0 takes one tap and skips weighting
        # (reference deform.c:896-898 guards with ``orders[ii] > 0``)
        if isinstance(cc, torch.Tensor):
            return [torch.ones_like(cc)]
        return [np.ones_like(cc)]

    if order & 1:
        x = cc - _floor(cc)
    else:
        x = cc - _floor(cc + 0.5)

    if order == 1:
        w0 = 1.0 - x
        return [w0, 1.0 - w0]

    if order == 2:
        w1 = 0.75 - x * x
        y = 0.5 - x
        w0 = 0.5 * y * y
        return [w0, w1, 1.0 - w0 - w1]

    if order == 3:
        y = x
        z = 1.0 - x
        w1 = _div(y * y * (y - 2.0) * 3.0 + 4.0, 6.0)
        w2 = _div(z * z * (z - 2.0) * 3.0 + 4.0, 6.0)
        w0 = _div(z * z * z, 6.0)
        return [w0, w1, w2, 1.0 - w0 - w1 - w2]

    if order == 4:
        t = x * x
        w2 = t * (t * 0.25 - 0.625) + 115.0 / 192.0
        y = 1.0 + x
        w1 = y * (y * (_div(y * (5.0 - y), 6.0) - 1.25) + 5.0 / 24.0) \
            + 55.0 / 96.0
        z = 1.0 - x
        w3 = z * (z * (_div(z * (5.0 - z), 6.0) - 1.25) + 5.0 / 24.0) \
            + 55.0 / 96.0
        y = 0.5 - x
        t = y * y
        w0 = _div(t * t, 24.0)
        return [w0, w1, w2, w3, 1.0 - w0 - w1 - w2 - w3]

    if order == 5:
        y = x
        z = 1.0 - x
        t = y * y
        w2 = t * (t * (0.25 - _div(y, 12.0)) - 0.5) + 0.55
        t = z * z
        w3 = t * (t * (0.25 - _div(z, 12.0)) - 0.5) + 0.55
        y1 = 1.0 + x
        w1 = y1 * (y1 * (y1 * (y1 * (_div(y1, 24.0) - 0.375) + 1.25) - 1.75)
                   + 0.625) + 0.425
        z1 = 2.0 - x
        w4 = z1 * (z1 * (z1 * (z1 * (_div(z1, 24.0) - 0.375) + 1.25) - 1.75)
                   + 0.625) + 0.425
        y2 = 1.0 - x
        t = y2 * y2
        w0 = _div(y2 * t * t, 120.0)
        return [w0, w1, w2, w3, w4, 1.0 - w0 - w1 - w2 - w3 - w4]

    raise ValueError("order should be 0, 1, 2, 3, 4 or 5.")
