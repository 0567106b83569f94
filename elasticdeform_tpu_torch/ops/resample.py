"""B-spline resampling at displaced or given coordinates, and the output
casts.

:func:`resample` is the wrapper of kernel K1 (``csrc/resample.cu``): from
the spline coefficients and the dense displacement it forms the sample
coordinates, folds them by the boundary mode, and sums the
``(order+1)^naxis`` weighted taps, one thread per output voxel. On a CPU
tensor it takes the plain version, :func:`resample_plain`: the JAX
package's formulation (``ops/resample.py:66`` there), a static mirror pad
and one gather per tap.

:func:`resample_coords` is the wrapper of kernel K1c (the second entry
point of ``csrc/resample.cu``), the same resampling at coordinates the
caller gives (the general resampler, ``map_coordinates``); its plain
version is :func:`resample_coords_plain`.

Layout: coefficients ``(B, *spatial, C)`` with the channels last, the dense
displacement or the coordinates ``(B, naxis, *out_spatial)`` (for K1c of
any output rank), the result ``(B, *out_spatial, C)``. The kernels take
float32 and float64; complex, float16 and bfloat16 inputs raise TypeError
at the entry points (:func:`numpy_dtype`).

Both wrappers take ``table``, the opt-in narrow window table of the JAX
package (``table_dtype=``, its ``ops/windows.py:1201``): None, or a torch
dtype narrower than the compute dtype (bfloat16; float32 under float64).
The coefficients are cast to it and the kernels read them in that dtype
(an instantiation of the coefficient load), so the gather moves fewer
bytes; the arithmetic stays in the compute dtype. The plain versions round
the coefficients to ``table`` and back, then compute as before.
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
            f"dtype {dtype} is not supported by elasticdeform_tpu_torch yet: "
            "complex, float16 and bfloat16 inputs are not ported, on the "
            "deform path nor on the general resampler (map_coordinates and "
            "its family)")
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


def mirror_unpad(d: torch.Tensor, axes, pad: int, lengths) -> torch.Tensor:
    """Transpose of :func:`mirror_pad`: fold each padded axis of ``axes``
    back onto its ``lengths`` entry by adding the pad onto the mirror
    positions (the JAX package's ``window_unpad_axis``)."""
    if pad == 0:
        return d
    for a, n in zip(axes, lengths):
        idx = _modes.mirror_index_np(np.arange(-pad, n + pad), n)
        shape = list(d.shape)
        shape[a] = n
        out = torch.zeros(shape, dtype=d.dtype, device=d.device)
        d = out.index_add_(a, torch.as_tensor(idx, device=d.device), d)
    return d


def tap_geometry(spatial, mapped, order: int):
    """Per-voxel gather geometry into the mirror-padded ``(B, *spatial)``
    coefficients: the pad, the padded shape, the flat row of each voxel's
    first tap (``n_out``), the row strides per axis, and per axis the
    per-tap :func:`spline_weights` flattened to ``n_out``."""
    naxis = len(mapped)
    B = mapped[0].shape[0]
    n_out = mapped[0].numel()
    pad = pad_amount(order)
    padded = tuple(n + 2 * pad for n in spatial)
    per_sample = math.prod(padded)
    strides = [math.prod(padded[h + 1:]) for h in range(naxis)]
    base = (torch.arange(B, device=mapped[0].device) * per_sample).view(
        (B,) + (1,) * (mapped[0].dim() - 1))
    weights = []
    for h in range(naxis):
        cc = mapped[h]
        start = filter_start(cc, order).to(torch.int64) + pad
        base = base + start * strides[h]
        weights.append([w.reshape(n_out) for w in spline_weights(cc, order)])
    return pad, padded, base.reshape(n_out), strides, weights


def tap_products(order: int, strides, factors):
    """Yield ``(row offset, products)`` for each of the ``(order+1)^naxis``
    taps, axis 0 slowest (the separable loop of reference
    deform.c:841-901). ``factors[k][h][t]`` is the factor of tap ``t``
    along axis ``h`` in product ``k``; each product is formed left to right
    over the axes (None at order 0, which skips weighting)."""
    naxis = len(strides)

    def visit(h, parts, offset):
        if h == naxis:
            yield offset, parts
            return
        for tap in range(order + 1):
            new = parts if order == 0 else [
                f[h][tap] if p is None else p * f[h][tap]
                for p, f in zip(parts, factors)]
            yield from visit(h + 1, new, offset + tap * strides[h])

    yield from visit(0, [None] * len(factors), 0)


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
    pad, padded, base, strides, weights = tap_geometry(
        x.shape[1:naxis + 1], mapped, order)
    rows = B * math.prod(padded)
    xf = mirror_pad(x, range(1, naxis + 1), pad).reshape(rows, C)

    acc = None
    for offset, (w,) in tap_products(order, strides, [weights]):
        idx = torch.clamp(base + offset, 0, rows - 1)
        vals = torch.index_select(xf, 0, idx)
        contrib = vals if w is None else w[:, None] * vals
        acc = contrib if acc is None else acc + contrib
    if inside is not None:
        acc = torch.where(inside.reshape(n_out, 1), acc,
                          torch.zeros((), dtype=acc.dtype, device=acc.device))
    return acc.reshape(B, *out_spatial, C)


def map_all(cc, spatial, mode: int):
    """Mode-folded coordinates per axis and the constant-mode mask."""
    mapped = []
    inside = None
    for h, n in enumerate(spatial):
        m, ins = _modes.map_coordinate(cc[h], n, mode)
        mapped.append(m)
        if mode == _modes.MODE_CONSTANT:
            inside = ins if inside is None else (inside & ins)
    return mapped, inside


def resample_plain(coeffs: torch.Tensor, displ: torch.Tensor, affine,
                   offsets, order: int, mode: int, cval: float):
    """Plain version of K1: coordinates, mode fold, per-tap gathers, and
    ``cval`` where constant mode falls outside."""
    return _resample_at(coeffs, sample_coordinates(displ, affine, offsets),
                        order, mode, cval)


def resample_coords_plain(coeffs: torch.Tensor, coords: torch.Tensor,
                          order: int, mode: int, cval: float):
    """Plain version of K1c: :func:`resample_plain` at the given
    coordinates ``(B, naxis, *out_spatial)``."""
    return _resample_at(coeffs, [coords[:, h] for h in range(coords.shape[1])],
                        order, mode, cval)


def _resample_at(coeffs: torch.Tensor, cc, order: int, mode: int,
                 cval: float):
    naxis = len(cc)
    mapped, inside = map_all(cc, coeffs.shape[1:naxis + 1], mode)
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
            ctypes.c_longlong, ctypes.c_double, ctypes.c_int,
            ctypes.c_void_p]
        fn = lib.ed_resample_coords_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ll_p, ctypes.c_longlong, ctypes.c_double,
            ctypes.c_int, ctypes.c_void_p]
    return lib


# the C entry points' code of the coefficients' dtype: 0 the compute dtype
_TABLE_CODES = {torch.bfloat16: 1, torch.float32: 2}


def table_coeffs(coeffs: torch.Tensor, table):
    """``(coefficients as the kernel reads them, table code)`` for the
    narrow table ``table`` (None, or a torch dtype narrower than
    ``coeffs``'s: bfloat16, or float32 under float64)."""
    if table is None or table == coeffs.dtype:
        return coeffs, 0
    if table not in _TABLE_CODES or \
            table.itemsize >= coeffs.dtype.itemsize:
        raise ValueError(f"the narrow table must be bfloat16, or float32 "
                         f"under float64; got {table} for {coeffs.dtype}")
    return coeffs.to(table).contiguous(), _TABLE_CODES[table]


def narrowed(coeffs: torch.Tensor, table) -> torch.Tensor:
    """The coefficients as the kernels read them with the narrow table
    ``table`` (a torch dtype or None): rounded to it and back to their own
    dtype. The plain versions compute on these; so do the coordinate
    gradients (K5, K5c), as the JAX package's d_cc branch reads its cast
    table (``ops/windows.py:1282``); the scatters (K3, K3c) do not read the
    coefficients."""
    return coeffs if table is None else coeffs.to(table).to(coeffs.dtype)


def check_resample_args(what: str, x: torch.Tensor, displ: torch.Tensor,
                        affine):
    """Validate the tensors of a resample kernel (K1, K3, K5): ``x``
    ``(B, *spatial, C)`` and ``displ`` ``(B, naxis, *out_spatial)``,
    contiguous float32/float64 on one CUDA device in one dtype, ``naxis <=
    4``. Returns ``affine`` (None, ``(naxis, naxis+1)`` or ``(B, naxis,
    naxis+1)``) as a contiguous tensor of ``x``'s dtype and device."""
    check_kernel_tensor(x, what)
    check_kernel_tensor(displ, what)
    B, naxis = displ.shape[:2]
    if naxis > MAX_KERNEL_AXES:
        raise ValueError(f"{what}: the CUDA kernel deforms at most "
                         f"{MAX_KERNEL_AXES} axes, got {naxis}")
    if displ.dtype != x.dtype or displ.device != x.device:
        raise ValueError(f"{what}: displ must match the other tensors in "
                         "dtype and device")
    if x.dim() != naxis + 2 or x.shape[0] != B:
        raise ValueError(f"{what}: tensors must be (B, *spatial, C) with the "
                         "batch and rank of displ")
    if affine is None:
        return None
    affine = affine.to(device=x.device, dtype=x.dtype).contiguous()
    if affine.shape[-2:] != (naxis, naxis + 1) or \
            affine.dim() not in (2, 3) or \
            (affine.dim() == 3 and affine.shape[0] != B):
        raise ValueError(f"{what}: affine must be (naxis, naxis+1) or "
                         "(B, naxis, naxis+1)")
    return affine


def kernel_geometry(in_spatial, displ: torch.Tensor, affine, offsets):
    """The shape arguments shared by the resample kernels' C entry points:
    ``(naxis, B, in_shape, out_shape, offsets, affine pointer, affine
    stride)``, shapes as ctypes int64 arrays."""
    B, naxis = displ.shape[:2]
    ll = ctypes.c_longlong * naxis
    return (naxis, B, ll(*in_spatial), ll(*displ.shape[2:]), ll(*offsets),
            None if affine is None else affine.data_ptr(),
            0 if affine is None or affine.dim() == 2
            else naxis * (naxis + 1))


def resample(coeffs: torch.Tensor, displ: torch.Tensor, affine, offsets,
             order: int, mode: int, cval: float, table=None) -> torch.Tensor:
    """Resample ``coeffs`` ``(B, *spatial, C)`` at ``affine(j) + offsets +
    displ`` with the boundary ``mode`` (code) and spline ``order``.

    ``displ`` is ``(B, naxis, *out_spatial)`` in the coefficients' dtype;
    ``affine`` None or a shared ``(naxis, naxis+1)`` or per-sample
    ``(B, naxis, naxis+1)`` tensor; ``table`` the narrow table (module
    docstring). A CPU tensor takes :func:`resample_plain`; a CUDA tensor
    launches K1 (contiguous float32 or float64, ``naxis <= 4``) and adds
    one to ``resample.launches``.
    """
    if coeffs.device.type == "cpu":
        return resample_plain(narrowed(coeffs, table), displ, affine,
                              offsets, order, mode, cval)
    affine = check_resample_args("resample", coeffs, displ, affine)
    naxis, B, in_shape, out_shape, offs, a_ptr, a_stride = kernel_geometry(
        coeffs.shape[1:-1], displ, affine, offsets)
    C = coeffs.shape[-1]
    out = torch.empty((B, *displ.shape[2:], C), dtype=coeffs.dtype,
                      device=coeffs.device)
    src, code = table_coeffs(coeffs, table)
    lib = _lib()
    err = lib.ed_resample_fwd(
        0 if coeffs.dtype == torch.float32 else 1, src.data_ptr(),
        displ.data_ptr(), a_ptr, out.data_ptr(), naxis, order, mode, B, C,
        in_shape, out_shape, offs, a_stride, float(cval), code,
        torch.cuda.current_stream(coeffs.device).cuda_stream)
    _build.check(err, lib, "ed_resample_error_string", "resample_fwd")
    resample.launches += 1
    return out


resample.launches = 0


def check_coords_args(what: str, x: torch.Tensor, coords: torch.Tensor):
    """Validate the tensors of a coordinate-input kernel (K1c, K3c, K5c):
    ``x`` ``(B, *spatial, C)`` and ``coords`` ``(B, naxis, *out)``,
    contiguous float32/float64 on one CUDA device in one dtype, ``naxis <=
    4``. Returns ``(naxis, B, in_shape, n_out)``, ``in_shape`` a ctypes
    int64 array of ``x``'s spatial shape."""
    check_kernel_tensor(x, what)
    check_kernel_tensor(coords, what)
    if coords.dim() < 2:
        raise ValueError(f"{what}: coords must be (B, naxis, *out_spatial)")
    B, naxis = coords.shape[:2]
    if naxis > MAX_KERNEL_AXES:
        raise ValueError(f"{what}: the CUDA kernel resamples at most "
                         f"{MAX_KERNEL_AXES} axes, got {naxis}")
    if coords.dtype != x.dtype or coords.device != x.device:
        raise ValueError(f"{what}: coords must match the other tensors in "
                         "dtype and device")
    if x.dim() != naxis + 2 or x.shape[0] != B:
        raise ValueError(f"{what}: tensors must be (B, *spatial, C) with the "
                         "batch of coords and naxis spatial axes")
    return (naxis, B, (ctypes.c_longlong * naxis)(*x.shape[1:-1]),
            math.prod(coords.shape[2:]))


def resample_coords(coeffs: torch.Tensor, coords: torch.Tensor, order: int,
                    mode: int, cval: float, table=None) -> torch.Tensor:
    """Resample ``coeffs`` ``(B, *spatial, C)`` at the coordinates
    ``coords`` ``(B, naxis, *out_spatial)`` (any output rank, in the
    coefficients' dtype) with the boundary ``mode`` (code), spline
    ``order`` and narrow table ``table`` (module docstring); returns ``(B,
    *out_spatial, C)``. A CPU tensor takes :func:`resample_coords_plain`; a
    CUDA tensor launches K1c (contiguous float32 or float64, ``naxis <=
    4``) and adds one to ``resample_coords.launches``.
    """
    if coeffs.device.type == "cpu":
        return resample_coords_plain(narrowed(coeffs, table), coords,
                                     order, mode, cval)
    naxis, B, in_shape, n_out = check_coords_args("resample_coords", coeffs,
                                                  coords)
    C = coeffs.shape[-1]
    out = torch.empty((B, *coords.shape[2:], C), dtype=coeffs.dtype,
                      device=coeffs.device)
    src, code = table_coeffs(coeffs, table)
    lib = _lib()
    err = lib.ed_resample_coords_fwd(
        0 if coeffs.dtype == torch.float32 else 1, src.data_ptr(),
        coords.data_ptr(), out.data_ptr(), naxis, order, mode, B, C,
        in_shape, n_out, float(cval), code,
        torch.cuda.current_stream(coeffs.device).cuda_stream)
    _build.check(err, lib, "ed_resample_error_string", "resample_coords_fwd")
    resample_coords.launches += 1
    return out


resample_coords.launches = 0


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
