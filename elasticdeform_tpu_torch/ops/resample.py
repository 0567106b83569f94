"""B-spline resampling at displaced coordinates, and the output casts.

:func:`resample` is the wrapper of kernel K1 (``csrc/resample.cu``): from
the spline coefficients and the dense displacement it forms the sample
coordinates, folds them by the boundary mode, and sums the
``(order+1)^naxis`` weighted taps, one thread per output voxel. On a CPU
tensor it takes the plain version, :func:`resample_plain`: the JAX
package's formulation (``ops/resample.py:66`` there), a static mirror pad
and one gather per tap.

Layout: coefficients ``(B, *spatial, C)`` with the channels last, the dense
displacement ``(B, naxis, *out_spatial)``, the result ``(B, *out_spatial,
C)``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from elasticdeform_tpu_torch.ops import _build
from elasticdeform_tpu_torch.ops import modes as _modes
from elasticdeform_tpu_torch.ops.bspline import filter_start, spline_weights

# the kernel's fixed limit on the number of deformed axes (ED_MAXD)
MAX_KERNEL_AXES = 4

_TORCH_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "uint16": torch.uint16, "int32": torch.int32,
    "uint32": torch.uint32, "int64": torch.int64, "uint64": torch.uint64,
    "float32": torch.float32, "float64": torch.float64,
}
_NUMPY_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch or numpy dtype this slice supports.

    Complex, float16 and bfloat16 raise TypeError: they are not ported yet.
    """
    if isinstance(dtype, torch.dtype):
        name = _NUMPY_NAMES.get(dtype)
    else:
        name = np.dtype(dtype).name
        name = name if name in _TORCH_DTYPES else None
    if name is None:
        raise TypeError(
            f"dtype {dtype} is not supported by elasticdeform_tpu_torch yet "
            "(complex, float16 and bfloat16 inputs are not ported)")
    return np.dtype(name)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (see :func:`numpy_dtype`)."""
    return _TORCH_DTYPES[numpy_dtype(dtype).name]


def check_kernel_tensor(x: torch.Tensor, what: str) -> None:
    """Raise unless ``x`` is a contiguous float32/float64 CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: the kernel takes float32 or float64, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the kernel takes a contiguous tensor")


def pad_amount(order: int) -> int:
    """Mirror padding that keeps every filter tap in bounds.

    The mode fold leaves mirror coordinates in ``(len-1, len)`` and reflect
    coordinates in ``(-1, 0)`` (reference deform.c:52-69, 90-108), so taps
    reach ``order//2 + 1`` past each edge.
    """
    return order // 2 + 1


def mirror_pad(x: torch.Tensor, axes, pad: int) -> torch.Tensor:
    """Mirror-extend each of ``axes`` by ``pad`` on both sides
    (the fold of reference deform.c:668-686)."""
    if pad == 0:
        return x
    for a in axes:
        n = x.shape[a]
        idx = _modes.mirror_index_np(np.arange(-pad, n + pad), n)
        x = torch.index_select(x, a, torch.as_tensor(idx, device=x.device))
    return x


def sample_coordinates(displ: torch.Tensor, affine, offsets):
    """Sample coordinates per deformed axis, ``affine(j) + offset + displ``.

    ``displ``: ``(B, naxis, *out_spatial)``; ``affine``: None, a shared
    ``(naxis, naxis+1)`` or a per-sample ``(B, naxis, naxis+1)`` tensor.
    The affine acts on the output index without the crop offset (reference
    deform.c:768-781; the JAX package's ``ops/deform.py:148`` and ``:374``).
    """
    B, naxis = displ.shape[:2]
    out_spatial = displ.shape[2:]
    coords = []
    for h in range(naxis):
        view = [1] * naxis
        view[h] = out_spatial[h]
        coords.append(torch.arange(out_spatial[h], dtype=displ.dtype,
                                   device=displ.device).view(view))
    if affine is None:
        cc = coords
    else:
        lead = (B,) + (1,) * naxis
        cc = []
        for h in range(naxis):
            if affine.dim() == 3:
                acc = affine[:, h, naxis].reshape(lead)
                for l in range(naxis):
                    acc = acc + affine[:, h, l].reshape(lead) * coords[l]
            else:
                acc = affine[h, naxis]
                for l in range(naxis):
                    acc = acc + affine[h, l] * coords[l]
            cc.append(acc)
    return [cc[h] + offsets[h] + displ[:, h] for h in range(naxis)]


def resample_linear(x: torch.Tensor, mapped, inside, order: int):
    """Gather-resample ``x`` at boundary-mapped coordinates (no cval).

    ``x``: ``(B, *spatial, C)`` coefficients; ``mapped``: ``naxis`` tensors
    ``(B, *out_spatial)``; ``inside``: a bool mask of that shape (outside
    voxels give 0) or None. Returns ``(B, *out_spatial, C)``.
    """
    naxis = len(mapped)
    B, C = x.shape[0], x.shape[-1]
    out_spatial = tuple(mapped[0].shape[1:])
    n_out = B * math.prod(out_spatial)

    pad = pad_amount(order)
    xp = mirror_pad(x, range(1, naxis + 1), pad)
    padded = xp.shape[1:naxis + 1]
    per_sample = math.prod(padded)
    strides = [math.prod(padded[h + 1:]) for h in range(naxis)]
    xf = xp.reshape(B * per_sample, C)

    base = (torch.arange(B, device=x.device) * per_sample).view(
        (B,) + (1,) * naxis)
    weights = []
    for h in range(naxis):
        cc = mapped[h]
        start = filter_start(cc, order).to(torch.int64) + pad
        base = base + start * strides[h]
        weights.append([w.reshape(n_out) for w in spline_weights(cc, order)])
    base = base.reshape(n_out)

    # static tap loop, axis 0 slowest; partial weight products left to right
    # (the separable accumulation of reference deform.c:841-901)
    acc = None

    def visit(h, wpart, offset):
        nonlocal acc
        if h == naxis:
            idx = torch.clamp(base + offset, 0, B * per_sample - 1)
            vals = torch.index_select(xf, 0, idx)
            contrib = vals if wpart is None else wpart[:, None] * vals
            acc = contrib if acc is None else acc + contrib
            return
        for tap in range(order + 1):
            wnew = wpart if order == 0 else (
                weights[h][tap] if wpart is None else wpart * weights[h][tap])
            visit(h + 1, wnew, offset + tap * strides[h])

    visit(0, None, 0)
    if inside is not None:
        acc = torch.where(inside.reshape(n_out, 1), acc,
                          torch.zeros((), dtype=acc.dtype, device=acc.device))
    return acc.reshape(B, *out_spatial, C)


def resample_plain(coeffs: torch.Tensor, displ: torch.Tensor, affine,
                   offsets, order: int, mode: int, cval: float):
    """Plain version of K1: coordinates, mode fold, per-tap gathers, and
    ``cval`` where constant mode falls outside."""
    naxis = displ.shape[1]
    cc = sample_coordinates(displ, affine, offsets)
    mapped = []
    inside = None
    for h in range(naxis):
        m, ins = _modes.map_coordinate(cc[h], coeffs.shape[h + 1], mode)
        mapped.append(m)
        if mode == _modes.MODE_CONSTANT:
            inside = ins if inside is None else (inside & ins)
    y = resample_linear(coeffs, mapped, inside, order)
    if inside is not None:
        fill = torch.tensor(cval, dtype=y.dtype, device=y.device)
        y = y + torch.where(inside[..., None],
                            torch.zeros((), dtype=y.dtype, device=y.device),
                            fill)
    return y


def _lib():
    lib = _build.library("resample")
    fn = lib.ed_resample_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        ll_p = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ll_p, ll_p, ll_p,
            ctypes.c_longlong, ctypes.c_double, ctypes.c_void_p]
    return lib


def resample(coeffs: torch.Tensor, displ: torch.Tensor, affine, offsets,
             order: int, mode: int, cval: float) -> torch.Tensor:
    """Resample ``coeffs`` ``(B, *spatial, C)`` at ``affine(j) + offsets +
    displ`` with the boundary ``mode`` (code) and spline ``order``.

    ``displ`` is ``(B, naxis, *out_spatial)`` in the coefficients' dtype;
    ``affine`` None or a shared ``(naxis, naxis+1)`` or per-sample
    ``(B, naxis, naxis+1)`` tensor. A CPU tensor takes
    :func:`resample_plain`; a CUDA tensor launches K1 (contiguous float32
    or float64, ``naxis <= 4``) and adds one to ``resample.launches``.
    """
    if coeffs.device.type == "cpu":
        return resample_plain(coeffs, displ, affine, offsets, order, mode,
                              cval)
    check_kernel_tensor(coeffs, "resample")
    check_kernel_tensor(displ, "resample")
    B, naxis = displ.shape[:2]
    if naxis > MAX_KERNEL_AXES:
        raise ValueError(f"resample: the CUDA kernel deforms at most "
                         f"{MAX_KERNEL_AXES} axes, got {naxis}")
    if displ.dtype != coeffs.dtype or displ.device != coeffs.device:
        raise ValueError("resample: displ must match coeffs in dtype and "
                         "device")
    if coeffs.dim() != naxis + 2 or coeffs.shape[0] != B:
        raise ValueError("resample: coeffs must be (B, *spatial, C) with the "
                         "batch and rank of displ")
    if affine is not None:
        affine = affine.to(device=coeffs.device,
                           dtype=coeffs.dtype).contiguous()
        if affine.shape[-2:] != (naxis, naxis + 1) or \
                affine.dim() not in (2, 3) or \
                (affine.dim() == 3 and affine.shape[0] != B):
            raise ValueError("resample: affine must be (naxis, naxis+1) or "
                             "(B, naxis, naxis+1)")
    C = coeffs.shape[-1]
    out_spatial = tuple(displ.shape[2:])
    out = torch.empty((B, *out_spatial, C), dtype=coeffs.dtype,
                      device=coeffs.device)
    ll = ctypes.c_longlong * naxis
    lib = _lib()
    err = lib.ed_resample_fwd(
        0 if coeffs.dtype == torch.float32 else 1, coeffs.data_ptr(),
        displ.data_ptr(), None if affine is None else affine.data_ptr(),
        out.data_ptr(), naxis, order, mode, B, C,
        ll(*coeffs.shape[1:naxis + 1]), ll(*out_spatial), ll(*offsets),
        0 if affine is None or affine.dim() == 2 else naxis * (naxis + 1),
        float(cval), torch.cuda.current_stream(coeffs.device).cuda_stream)
    _build.check(err, lib, "ed_resample_error_string", "resample_fwd")
    resample.launches += 1
    return out


resample.launches = 0


def cast_int_c(t: torch.Tensor, dtype) -> torch.Tensor:
    """C truncating/wrapping cast of floats into an integer dtype, kept as
    the integral float it came in as: truncate toward zero, then wrap
    modulo 2**bits (scipy's line writeback, reference
    from_nd_image.c:434-487; bool is an unsigned char)."""
    dtype = np.dtype(dtype)
    if dtype.kind == "b":
        dtype = np.dtype(np.uint8)
    info = np.iinfo(dtype)
    tr = torch.trunc(t)
    span = float(2.0 ** info.bits)
    lo = float(info.min)
    return tr - torch.floor((tr - lo) / span) * span


def cast_output(t: torch.Tensor, dtype) -> torch.Tensor:
    """Cast the float result to ``dtype`` (numpy) with the reference's
    rules (reference deform.c:287-306): floats plain; unsigned ints
    ``t>0 ? t+0.5 : 0``, signed ints half away from zero, both clamped and
    truncated; bool by a C truncating cast, nonzero -> True."""
    dtype = np.dtype(dtype)
    if dtype.kind == "b":
        return torch.trunc(t) != 0
    if dtype.kind not in "iu":
        return t.to(torch_dtype(dtype))
    info = np.iinfo(dtype)
    if dtype.kind == "u":
        r = torch.where(t > 0, t + 0.5, torch.zeros((), dtype=t.dtype,
                                                    device=t.device))
    else:
        r = torch.where(t > 0, t + 0.5, t - 0.5)
    r = torch.clamp(r, info.min, info.max)
    return torch.trunc(r).to(torch_dtype(dtype))
