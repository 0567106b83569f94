"""Boundary-mode coordinate mapping (PyTorch).

Same semantics as the JAX package's ``ops/modes.py``: the reference C
library's *pre-SciPy-1.6* conventions (reference deform.c:47-128):

* ``wrap`` uses a period of ``len - 1``, ``mirror`` a period of
  ``2*len - 2`` and ``reflect`` a period of ``2*len``;
* the boundary mode is applied once to the floating-point sample
  coordinate; filter taps that still fall outside the array are folded with
  mirror index arithmetic whatever the mode (:func:`mirror_index_np`);
* ``constant`` reports an explicit ``inside`` mask;
* :func:`map_coordinate_grad` is the fold's derivative, for the gradient
  with respect to the displacement.

The divisions below divide by a 0-dim tensor on the coordinates' device, not
by a Python number: PyTorch's CUDA division by a host scalar multiplies by
its reciprocal, which rounds differently from the true division that the
resample kernel (``csrc/resample.cu``) and the JAX package compute.
"""

from __future__ import annotations

import numpy as np
import torch

# integer codes, identical to reference deform_grid.py:443-452
MODE_NEAREST = 0
MODE_WRAP = 1
MODE_REFLECT = 2
MODE_MIRROR = 3
MODE_CONSTANT = 4

_MODE_NAMES = {
    "nearest": MODE_NEAREST,
    "wrap": MODE_WRAP,
    "reflect": MODE_REFLECT,
    "mirror": MODE_MIRROR,
    "constant": MODE_CONSTANT,
}


def mode_to_code(mode) -> int:
    """Convert a boundary-mode name to its integer code
    (reference deform_grid.py:440-454, including the error)."""
    if isinstance(mode, int):
        if mode in (0, 1, 2, 3, 4):
            return mode
        raise RuntimeError("boundary mode not supported")
    try:
        return _MODE_NAMES[mode]
    except KeyError:
        raise RuntimeError("boundary mode not supported") from None


def _const(value, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def map_coordinate(cc: torch.Tensor, length: int, mode: int):
    """Map coordinates outside ``[0, length-1]`` into range.

    Returns ``(mapped, inside)``; ``inside`` is all-True except for
    ``constant`` mode, where it marks the in-range samples.
    """
    inside = torch.ones(cc.shape, dtype=torch.bool, device=cc.device)
    below = cc < 0
    above = cc > length - 1

    if mode == MODE_CONSTANT:
        inside = ~(below | above)
        return torch.clamp(cc, 0, length - 1), inside
    if mode == MODE_NEAREST:
        return torch.clamp(cc, 0, length - 1), inside
    if length <= 1:
        return torch.zeros_like(cc), inside

    if mode == MODE_MIRROR:
        sz2 = 2 * length - 2
        d = _const(sz2, cc)
        neg = sz2 * torch.trunc(-cc / d) + cc
        neg = torch.where(neg <= 1 - length, neg + sz2, -neg)
        pos = cc - sz2 * torch.trunc(cc / d)
        pos = torch.where(pos >= length, sz2 - pos, pos)
        return torch.where(below, neg, torch.where(above, pos, cc)), inside

    if mode == MODE_REFLECT:
        sz2 = 2 * length
        d = _const(sz2, cc)
        neg0 = torch.where(cc < -sz2, sz2 * torch.trunc(-cc / d) + cc, cc)
        neg = torch.where(neg0 < -length, neg0 + sz2, -neg0 - 1)
        pos = cc - sz2 * torch.trunc(cc / d)
        pos = torch.where(pos >= length, sz2 - pos - 1, pos)
        return torch.where(below, neg, torch.where(above, pos, cc)), inside

    if mode == MODE_WRAP:
        sz = length - 1
        d = _const(sz, cc)
        neg = cc + sz * (torch.trunc(-cc / d) + 1)
        pos = cc - sz * torch.trunc(cc / d)
        return torch.where(below, neg, torch.where(above, pos, cc)), inside

    raise RuntimeError("boundary mode not supported")


def map_coordinate_grad(cc: torch.Tensor, length: int, mode: int):
    """``d mapped / d cc`` of :func:`map_coordinate`, as JAX's autodiff
    gives it for the JAX package's ``map_coordinate``.

    Mirror and reflect give +1 or -1 by branch and wrap gives 1 (``trunc``
    has a zero derivative). Nearest and constant clip with ``jnp.clip``,
    which is ``minimum(maximum(cc, 0), length-1)``: 1 inside, 0 outside,
    and each of the two operations passes half at an exact tie, so 0.5 at
    ``cc == 0`` or ``cc == length-1`` (0.25 when both hold). This is
    written out because ``torch.clamp``'s backward gives 1 at a tie.
    """
    one = torch.ones_like(cc)
    if mode in (MODE_CONSTANT, MODE_NEAREST):
        half, zero = 0.5 * one, torch.zeros_like(cc)
        lo = torch.where(cc > 0, one, torch.where(cc == 0, half, zero))
        hi = torch.where(cc < length - 1, one,
                         torch.where(cc == length - 1, half, zero))
        return lo * hi
    if length <= 1:
        return torch.zeros_like(cc)
    below = cc < 0
    above = cc > length - 1

    if mode == MODE_MIRROR:
        sz2 = 2 * length - 2
        d = _const(sz2, cc)
        neg = sz2 * torch.trunc(-cc / d) + cc
        pos = cc - sz2 * torch.trunc(cc / d)
        dneg = torch.where(neg <= 1 - length, one, -one)
        dpos = torch.where(pos >= length, -one, one)
        return torch.where(below, dneg, torch.where(above, dpos, one))

    if mode == MODE_REFLECT:
        sz2 = 2 * length
        d = _const(sz2, cc)
        neg0 = torch.where(cc < -sz2, sz2 * torch.trunc(-cc / d) + cc, cc)
        pos = cc - sz2 * torch.trunc(cc / d)
        dneg = torch.where(neg0 < -length, one, -one)
        dpos = torch.where(pos >= length, -one, one)
        return torch.where(below, dneg, torch.where(above, dpos, one))

    if mode == MODE_WRAP:
        return one

    raise RuntimeError("boundary mode not supported")


def mirror_index_np(idx, length: int):
    """Integer mirror fold of any index into ``[0, length-1]`` (period
    ``2*length - 2``), numpy; the tap-edge rule of reference
    deform.c:668-686 and 791-813."""
    idx = np.asarray(idx, dtype=np.int64)
    if length <= 1:
        return np.zeros_like(idx)
    s2 = 2 * length - 2
    m = np.mod(idx, s2)
    return np.where(m >= length, s2 - m, m)
