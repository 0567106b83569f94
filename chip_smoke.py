#!/usr/bin/env python3
"""Smoke run of elasticdeform_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is not 0):

1. device and build: prints the card's name and power limit, builds the
   CUDA kernels from ``elasticdeform_tpu_torch/csrc`` with nvcc;
2. each kernel against its plain PyTorch version on the card: K1 (resample),
   K3 (its transpose, a scatter) and K5 (the coordinate gradient) over
   orders 0-5 x five modes x 2-D/3-D in float32 and float64 with
   coordinates far past every edge, shared and per-sample affines and crop
   offsets; K1c, K3c and K5c (the same at caller-given coordinates, K1c
   and K5c bit for bit) over the same sweep plus a flat point list; K2
   (prefilter) over orders 2-5 and axis lengths 9/64/200 at every axis
   position, plus the uint8/int16 writeback, bit for bit; K4 (the
   transposed prefilter) over orders 2-5 and lengths 1/2/9/64/200 at every
   axis position; K6 and K7 (the reflect/wrap prefilter and its transpose)
   against ``filter_matrix_bc`` and its transpose over orders 2-5 x
   reflect/wrap x lengths 1/2/9/64/224/248 at every axis position; K8 and
   K8T (the 1-D correlation and its transpose) over the five filter modes,
   1-41 taps (longer than some axes) at every centre, every axis of 2-D and
   3-D shapes with odd sizes, and the paired integer route bit for bit; K9
   and K9T (the N-D correlation and its transpose) over the five modes and
   the grid aliases, 2-D to 4-D kernels with batch axes and origins; the
   K1/K3, K1c/K3c, K2/K4, K6/K7, K8/K8T and K9/K9T adjoint identities in
   float64; and, bit for bit in all eleven dtypes (bool, the eight integer
   types, float32 and float64 with NaN and infinities), K10 (1-D min/max)
   over sizes 1-15 at every centre, the five modes and every axis, K11
   (footprint min/max) over flat and non-flat 2-D to 4-D footprints with
   saturating integer casts, K12 (rank selection) over 2-343 taps on both
   routes, and K13 (binary sweep) over random, even and empty structures,
   borders, masks, its changed flag and the fixpoint; K1 and K1c reading a
   narrow (bfloat16 or float32) coefficient table, bit for bit; and the
   probe kernels at the JAX probes' default sizes: P1 (shared memory) at
   48-227 KiB, 228 KiB raising the CUDA error, P2 (row gather: copy,
   element and sum modes) bit for bit and its sums repeating bit for bit,
   P3 (row scatter-add) per element to the sum of its terms, integer
   counts exactly, P4 (bulk-copy row gather) as P2's sums;
3. the main path through the public entry points at the BASELINE configs
   c1, c2, c3 (forward, and ``deform_grid_gradient`` with crop, X_shape,
   affine and constant mode), c4 (forward and autograd to X), c5 (batched
   forward and backward) and c6 (batched, autograd to X and the grids),
   and the general resampler's c7 (``deform_field_batch``, autograd to X
   and the field), c8 (``affine_transform``, modern reflect, autograd to
   X), c9 (``zoom`` with ``grid-wrap``) and c10 (``map_coordinates`` with
   ``grid-constant``, then ``map_coordinates_gradient``), the filter tier's
   c11 (``gaussian_filter`` of a displacement field, autograd to it), c12
   (``gaussian_laplace`` and ``gaussian_gradient_magnitude``), c13 (an int16
   CT volume of 512x512x300: ``gaussian_filter`` and ``sobel`` with int16
   output, bit for bit) and c14 (N-D
   ``correlate`` with autograd, ``convolve`` on a batch), and the
   morphology tier's c15 (median and percentile filters of a 160x192x224
   float32 MRI-like volume, bit for bit), c16 (grey opening, white top-hat
   and a non-flat dilation of c13's int16 CT volume, bit for bit) and c17
   (binary opening, hole filling and propagation of a 160x192x224 bool
   segmentation), each compared with the port's own ``device="cpu"`` run;
   the launch counters, set to 0 before each config and read after it, must
   show each kernel on the configs that run it and none on the configs that
   do not need it (exact counts for c11-c16, and c17's K13 sweeps per
   call); then the probes' path: every Pallas probe through the port's
   public functions (``elasticdeform_tpu_torch.probes``) at the JAX probes'
   default sizes, counters set to 0 before and read after (exact counts of
   P1-P4, none of K1-K13), each output equal to phase 2's kernel output;
4. times: CUDA events, median of 10 runs after warm-up, for each kernel,
   its plain version and library yardstick (K1-K5 at the c5 shapes, also
   at order 1 beside ``grid_sample``; K1c, K3c, K5c at the c7 shapes beside
   ``grid_sample``; K6, K7 and again K1c, K3c at the c8 shapes; K8-K9T at
   the c11, c13 and c14 shapes; K10 and K11 at the c16 shapes beside
   ``max_pool3d``, K12 at the c15 shapes, K13 at the c17 shapes beside
   ``max_pool3d``; one line per probe, its calls timed back to back: ms,
   M rows/s, GB/s of the rows
   moved, from L2 or HBM, beside the byte bound, the twin and the library
   call, ``index_select``, ``gather``, ``embedding_bag`` or ``index_add_``;
   the library-only probes' rates), and each config (Mvox/s).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. It exits non-zero with no
result when no CUDA device is present or when the package is missing.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
FP64_FLOPS = 34e12            # H100 SXM float64 outside the tensor cores
REPS = 10

MODES = ("nearest", "wrap", "reflect", "mirror", "constant")

KERNELS = ("resample_fwd", "spline_prefilter", "resample_bwd",
           "spline_prefilter_transpose", "resample_coord_grad",
           "spline_prefilter_bc", "spline_prefilter_bc_transpose",
           "resample_coords_fwd", "resample_coords_bwd",
           "resample_coords_grad", "correlate1d", "correlate1d_transpose",
           "correlate_nd", "correlate_nd_transpose", "min_max_filter1d",
           "min_max_filter", "rank_filter", "binary_step", "smem_probe",
           "row_gather", "row_scatter_add", "row_gather_async")
FILTER_KERNELS = KERNELS[10:14]
MORPH_KERNELS = KERNELS[14:18]
PROBE_KERNELS = KERNELS[18:]
# the kernels of the deform, resampler, filter and morphology path (phase 3)
PATH_KERNELS = KERNELS[:18]


def _tol(dtype, scale):
    """(rtol, atol) of a kernel against its plain version: float32
    rtol=1e-5, atol=1e-5*max|x|; float64 1e-10 for both."""
    import torch
    if dtype == torch.float32:
        return 1e-5, 1e-5 * scale
    return 1e-10, 1e-10 * scale


def _assert_close(got, want, rtol, atol, what):
    """Raise unless |got - want| <= atol + rtol * |want| everywhere;
    ``atol`` is a number or a tensor of per-element bounds. Returns the
    largest absolute difference."""
    import torch
    err = (got.double() - want.double()).abs()
    bad = err > atol + rtol * want.double().abs()
    if bool(bad.any()):
        amax = float(atol.max()) if isinstance(atol, torch.Tensor) else atol
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} values off, max abs "
            f"err {float(err.max()):.3e} (rtol={rtol}, atol up to "
            f"{amax:.3e})")
    return float(err.max()) if err.numel() else 0.0


def _time_ms(fn, reps=REPS, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _loop_ms(fn, n=20, reps=3, warmup=2):
    """Milliseconds per call of ``fn()`` run ``n`` times back to back
    between two CUDA events, the median of ``reps`` such runs: as the JAX
    probes time, so that a kernel of a few tens of microseconds is not
    timed together with the host's work of launching it."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}; nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("float32 matmuls must run in full float32")
    return name, smi


def phase_build():
    from elasticdeform_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"build: {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def _smooth_displacement(rs, B, naxis, out_spatial, sigma, dtype, device):
    """A dense displacement that pushes coordinates far past every edge:
    large smooth swings plus per-voxel noise."""
    import torch
    grids = np.meshgrid(*[np.linspace(0, 1, n) for n in out_spatial],
                        indexing="ij")
    d = np.empty((B, naxis, *out_spatial))
    for b in range(B):
        for h in range(naxis):
            phase = rs.rand(naxis) * 6.0
            d[b, h] = sigma * np.sin(sum(g * 7 + p for g, p in
                                         zip(grids, phase)))
    d += rs.randn(*d.shape) * 2.0
    return torch.as_tensor(d, dtype=dtype, device=device)


def phase_kernels():
    """Phase 2: every kernel against its plain version on the card."""
    import torch
    from elasticdeform_tpu_torch.ops import prefilter as pf
    from elasticdeform_tpu_torch.ops import resample as rsm
    from elasticdeform_tpu_torch.ops import resample_bwd as rb
    dev = torch.device("cuda")
    rs = np.random.RandomState(1)
    worst = dict.fromkeys(KERNELS, 0.0)
    n = 0
    for naxis, in_sp, out_sp in ((2, (23, 31), (20, 27)),
                                 (3, (11, 13, 9), (10, 12, 8))):
        for dtype in (torch.float32, torch.float64):
            B, C = 2, 2
            for order in range(6):
                for mode in range(5):
                    coeffs = torch.as_tensor(
                        rs.rand(B, *in_sp, C) * 4 - 1, dtype=dtype,
                        device=dev)
                    displ = _smooth_displacement(
                        rs, B, naxis, out_sp, 3.0 * max(in_sp), dtype, dev)
                    kind = (order + mode) % 3
                    if kind == 0:
                        affine = None
                    else:
                        A = np.zeros((B, naxis, naxis + 1))
                        A[:, :, :naxis] = np.eye(naxis) + rs.randn(
                            B, naxis, naxis) * 0.2
                        A[:, :, naxis] = rs.randn(B, naxis) * 3
                        affine = torch.as_tensor(
                            A if kind == 2 else A[0], dtype=dtype,
                            device=dev)
                    offsets = tuple(int(o) for o in rs.randint(0, 3, naxis))
                    args = (coeffs, displ, affine, offsets, order, mode, 1.5)
                    got = rsm.resample(*args)
                    want = rsm.resample_plain(*args)
                    torch.cuda.synchronize()
                    what = (f"naxis={naxis} {dtype} order={order} "
                            f"mode={MODES[mode]}")
                    rtol, atol = _tol(dtype, 4.0)
                    err = _assert_close(got, want, rtol, atol, f"K1 {what}")
                    worst["resample_fwd"] = max(worst["resample_fwd"], err)
                    g = torch.as_tensor(rs.randn(B, *out_sp, C), dtype=dtype,
                                        device=dev)
                    bargs = (displ, affine, offsets, order, mode)
                    worst["resample_bwd"] = max(
                        worst["resample_bwd"],
                        _check_k3(rb, g, bargs, in_sp, dtype, f"K3 {what}"))
                    got = rb.resample_coord_grad(coeffs, g, *bargs)
                    want = rb.resample_coord_grad_plain(coeffs, g, *bargs)
                    torch.cuda.synchronize()
                    rtol, atol = _tol(dtype, _k5_scale(coeffs, g))
                    worst["resample_coord_grad"] = max(
                        worst["resample_coord_grad"],
                        _assert_close(got, want, rtol, atol, f"K5 {what}"))
                    if dtype == torch.float64:
                        _check_adjoint(
                            rsm.resample(coeffs, displ, affine, offsets,
                                         order, mode, 0.0), g, coeffs,
                            rb.resample_transpose(g, *bargs, in_sp),
                            f"K1/K3 {what}")
                    n += 1
    print(f"K1 resample_fwd, K3 resample_bwd, K5 resample_coord_grad vs "
          f"plain: {n} cases each pass, max abs err "
          f"{worst['resample_fwd']:.3e} / {worst['resample_bwd']:.3e} / "
          f"{worst['resample_coord_grad']:.3e}; the K1/K3 adjoint identity "
          f"holds in float64 ({n // 2} cases)")

    n = 0
    for dtype in (torch.float32, torch.float64):
        for order in (2, 3, 4, 5):
            for length in (9, 64, 200):
                for pos in range(4):
                    shape = [5, 6, 3, 4]
                    shape[pos] = length
                    x = torch.as_tensor(rs.rand(*shape) * 200 - 50,
                                        dtype=dtype, device=dev)
                    got = pf.spline_filter1d(x, order, pos)
                    want = pf.spline_filter1d_plain(x, order, pos)
                    torch.cuda.synchronize()
                    rtol, atol = _tol(dtype, float(x.abs().max()))
                    err = _assert_close(
                        got, want, rtol, atol,
                        f"K2 {dtype} order={order} n={length} axis={pos}")
                    worst["spline_prefilter"] = max(
                        worst["spline_prefilter"], err)
                    n += 1
    # the fused integer writeback, float64 as deform_grid computes it for a
    # float64 grid: must agree bit for bit after each of the axes
    for int_dtype, lo, hi in ((np.uint8, 0, 256), (np.int16, -3000, 3000)):
        for order in (2, 3, 4, 5):
            x = torch.as_tensor(rs.randint(lo, hi, (2, 40, 33, 3)),
                                dtype=torch.float64, device=dev)
            got, want = x, x
            for pos in (1, 2):
                got = pf.spline_filter1d(got, order, pos, int_dtype)
                want = pf.spline_filter1d_plain(want, order, pos,
                                                int_dtype).contiguous()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"K2 writeback {np.dtype(int_dtype)} order={order} "
                        f"axis={pos}: "
                        f"{int((got != want).sum())} values differ")
                n += 1
    print(f"K2 spline_prefilter vs plain: {n} cases pass, max abs err "
          f"{worst['spline_prefilter']:.3e}")

    n = 0
    for dtype in (torch.float32, torch.float64):
        for order in (2, 3, 4, 5):
            for length in (1, 2, 9, 64, 200):
                for pos in range(4):
                    shape = [5, 6, 3, 4]
                    shape[pos] = length
                    x = torch.as_tensor(rs.rand(*shape) * 200 - 50,
                                        dtype=dtype, device=dev)
                    got = pf.spline_filter1d_transpose(x, order, pos)
                    want = pf.spline_filter1d_transpose_plain(x, order, pos)
                    torch.cuda.synchronize()
                    what = f"{dtype} order={order} n={length} axis={pos}"
                    rtol, atol = _tol(dtype, float(x.abs().max()))
                    worst["spline_prefilter_transpose"] = max(
                        worst["spline_prefilter_transpose"],
                        _assert_close(got, want, rtol, atol, f"K4 {what}"))
                    if dtype == torch.float64:
                        y = torch.as_tensor(rs.randn(*shape), dtype=dtype,
                                            device=dev)
                        _check_adjoint(
                            pf.spline_filter1d(x, order, pos), y, x,
                            pf.spline_filter1d_transpose(y, order, pos),
                            f"K2/K4 {what}")
                    n += 1
    print(f"K4 spline_prefilter_transpose vs plain: {n} cases pass, max abs "
          f"err {worst['spline_prefilter_transpose']:.3e}; the K2/K4 adjoint "
          f"identity holds in float64 ({n // 2} cases)")
    _check_coords_kernels(rs, worst)
    _check_narrow_table(rs)
    _check_bc_prefilter(rs, worst)
    _check_filter_kernels(rs, worst)
    _check_morph_kernels(rs)
    return worst


def _check_coords_kernels(rs, worst):
    """K1c and K5c bit for bit against their twins, K3c per element as K3,
    and the K1c/K3c adjoint identity in float64, at coordinates up to 3x
    the extent past every edge, some exactly on the clip bounds, for 2-D,
    3-D and a flat point list."""
    import torch
    from elasticdeform_tpu_torch.ops import resample as rsm
    from elasticdeform_tpu_torch.ops import resample_bwd as rb
    dev = torch.device("cuda")
    n = 0
    for naxis, in_sp, out_sp in ((2, (23, 31), (20, 27)),
                                 (3, (11, 13, 9), (10, 12, 8)),
                                 (3, (11, 13, 9), (257,))):
        for dtype in (torch.float32, torch.float64):
            B, C = 2, 2
            for order in range(6):
                for mode in range(5):
                    coeffs = torch.as_tensor(
                        rs.rand(B, *in_sp, C) * 4 - 1, dtype=dtype,
                        device=dev)
                    ext = max(in_sp)
                    cc = rs.uniform(-3 * ext, 4 * ext, (B, naxis, *out_sp))
                    cc.reshape(-1)[:3] = (0.0, in_sp[0] - 1.0, -0.5)
                    coords = torch.as_tensor(cc, dtype=dtype, device=dev)
                    g = torch.as_tensor(rs.randn(B, *out_sp, C), dtype=dtype,
                                        device=dev)
                    what = (f"naxis={naxis} out={out_sp} {dtype} "
                            f"order={order} mode={MODES[mode]}")
                    for name, got, want in (
                            ("resample_coords_fwd",
                             rsm.resample_coords(coeffs, coords, order, mode,
                                                 1.5),
                             rsm.resample_coords_plain(coeffs, coords, order,
                                                       mode, 1.5)),
                            ("resample_coords_grad",
                             rb.resample_coords_grad(coeffs, g, coords, order,
                                                     mode),
                             rb.resample_coords_grad_plain(coeffs, g, coords,
                                                           order, mode))):
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"{name} {what}: not bit-identical to its "
                                f"plain twin, max abs err "
                                f"{float((got - want).abs().max()):.3e}")
                    got = rb.resample_coords_transpose(g, coords, order, mode,
                                                       in_sp)
                    want = rb.resample_coords_transpose_plain(
                        g, coords, order, mode, in_sp)
                    terms = rb.resample_coords_transpose_plain(
                        g.abs(), coords, order, mode, in_sp)
                    torch.cuda.synchronize()
                    rtol, _ = _tol(dtype, 1.0)
                    worst["resample_coords_bwd"] = max(
                        worst["resample_coords_bwd"],
                        _assert_close(got, want, rtol,
                                      rtol * terms.double().abs(),
                                      f"K3c {what}"))
                    if dtype == torch.float64:
                        _check_adjoint(
                            rsm.resample_coords(coeffs, coords, order, mode,
                                                0.0), g, coeffs, got,
                            f"K1c/K3c {what}")
                    n += 1
    print(f"K1c resample_coords_fwd and K5c resample_coords_grad bit for bit "
          f"with their plain twins, K3c resample_coords_bwd within "
          f"{worst['resample_coords_bwd']:.3e}: {n} cases each; the K1c/K3c "
          f"adjoint identity holds in float64 ({n // 2} cases)")


def _check_narrow_table(rs):
    """K1 and K1c with the narrow table (``table_dtype``): bfloat16 under
    float32 and float64, float32 under float64, bit for bit against their
    twins, which round the coefficients to the table and back."""
    import torch
    from elasticdeform_tpu_torch.ops import resample as rsm
    dev = torch.device("cuda")
    n = 0
    for dtype, table in ((torch.float32, torch.bfloat16),
                         (torch.float64, torch.bfloat16),
                         (torch.float64, torch.float32)):
        for naxis, in_sp, out_sp in ((2, (23, 31), (20, 27)),
                                     (3, (11, 13, 9), (10, 12, 8))):
            B, C = 2, 3
            for order in range(6):
                for mode in (0, 3, 4):
                    coeffs = torch.as_tensor(rs.rand(B, *in_sp, C) * 4 - 1,
                                             dtype=dtype, device=dev)
                    displ = _smooth_displacement(rs, B, naxis, out_sp,
                                                 2.0 * max(in_sp), dtype, dev)
                    ext = max(in_sp)
                    coords = torch.as_tensor(
                        rs.uniform(-ext, 2 * ext, (B, naxis, *out_sp)),
                        dtype=dtype, device=dev)
                    args = (displ, None, (1,) * naxis, order, mode, 1.5)
                    cargs = (coords, order, mode, 1.5)
                    what = (f"{dtype} table {table} naxis={naxis} "
                            f"order={order} mode={MODES[mode]}")
                    narrow = rsm.narrowed(coeffs, table)
                    for name, got, want in (
                            ("K1", rsm.resample(coeffs, *args, table),
                             rsm.resample_plain(narrow, *args)),
                            ("K1c", rsm.resample_coords(coeffs, *cargs,
                                                        table),
                             rsm.resample_coords_plain(narrow, *cargs))):
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"{name} narrow {what}: not bit-identical to "
                                "its plain twin, max abs err "
                                f"{float((got - want).abs().max()):.3e}")
                    n += 1
    print(f"K1 and K1c with the narrow table (bfloat16 under float32 and "
          f"float64, float32 under float64) bit for bit with their twins: "
          f"{n} cases each")


def _check_bc_prefilter(rs, worst):
    """K6 against ``filter_matrix_bc`` and K7 against its transpose (the
    plain twins), float32 rtol=1e-5, atol=1e-5*max|x|, float64 1e-10, and
    the K6/K7 adjoint identity in float64."""
    import torch
    from elasticdeform_tpu_torch.ops import prefilter as pf
    dev = torch.device("cuda")
    n = 0
    for dtype in (torch.float32, torch.float64):
        for bc in ("reflect", "wrap"):
            for order in (2, 3, 4, 5):
                for length in (1, 2, 9, 64, 224, 248):
                    for pos in range(4):
                        shape = [5, 6, 3, 4]
                        shape[pos] = length
                        x = torch.as_tensor(rs.rand(*shape) * 200 - 50,
                                            dtype=dtype, device=dev)
                        what = (f"{dtype} {bc} order={order} n={length} "
                                f"axis={pos}")
                        rtol, atol = _tol(dtype, float(x.abs().max()))
                        k6 = pf.spline_filter1d_bc(x, order, pos, bc)
                        k7 = pf.spline_filter1d_bc_transpose(x, order, pos,
                                                             bc)
                        torch.cuda.synchronize()
                        worst["spline_prefilter_bc"] = max(
                            worst["spline_prefilter_bc"], _assert_close(
                                k6, pf.spline_filter1d_bc_plain(
                                    x, order, pos, bc), rtol, atol,
                                f"K6 {what}"))
                        worst["spline_prefilter_bc_transpose"] = max(
                            worst["spline_prefilter_bc_transpose"],
                            _assert_close(
                                k7, pf.spline_filter1d_bc_transpose_plain(
                                    x, order, pos, bc), rtol, atol,
                                f"K7 {what}"))
                        if dtype == torch.float64:
                            y = torch.as_tensor(rs.randn(*shape),
                                                dtype=dtype, device=dev)
                            _check_adjoint(
                                k6, y, x,
                                pf.spline_filter1d_bc_transpose(y, order,
                                                                pos, bc),
                                f"K6/K7 {what}")
                        n += 1
    print(f"K6 spline_prefilter_bc and K7 spline_prefilter_bc_transpose vs "
          f"filter_matrix_bc and its transpose: {n} cases each pass, max abs "
          f"err {worst['spline_prefilter_bc']:.3e} / "
          f"{worst['spline_prefilter_bc_transpose']:.3e}; the K6/K7 adjoint "
          f"identity holds in float64 ({n // 2} cases)")


def _terms_tol(dtype, terms):
    """Per-element bound of a transpose against its twin, which sums the
    same terms in another order: rtol times the sum of the absolute terms
    landing on the element."""
    rtol, _ = _tol(dtype, 1.0)
    return rtol, rtol * terms.double().abs()


def _check_filter_kernels(rs, worst):
    """K8 and K9 against their twins (float32 rtol=1e-5, atol=1e-5*S,
    float64 1e-10, S = max|x| * sum|w|; the twins add in the kernels' order,
    so most cases agree bit for bit, which is counted), the paired route bit
    for bit on integer data in float64, K8T and K9T per element against the
    sum of their absolute terms, and the K8/K8T and K9/K9T adjoint
    identities in float64."""
    import torch
    from elasticdeform_tpu_torch.ops import filters as ft
    dev = torch.device("cuda")
    modes = ("reflect", "constant", "nearest", "mirror", "wrap")
    n = exact = 0
    for dtype in (torch.float32, torch.float64):
        for mode in modes:
            for shape in ((37, 300), (7, 33, 9)):
                for axis in range(len(shape)):
                    for L in (1, 2, 4, 17, 41):
                        x = torch.as_tensor(rs.rand(*shape) * 200 - 50,
                                            dtype=dtype, device=dev)
                        g = torch.as_tensor(rs.randn(*shape), dtype=dtype,
                                            device=dev)
                        w = rs.randn(L)
                        scale = float(x.abs().max()) * float(np.abs(w).sum())
                        for c in sorted({0, L // 2, L - 1}):
                            what = (f"{dtype} {mode} shape={shape} "
                                    f"axis={axis} taps={L} centre={c}")
                            got = ft.correlate1d(x, w, axis, mode, 1.5, c)
                            want = ft.correlate1d_plain(x, w, axis, mode,
                                                        1.5, c)
                            torch.cuda.synchronize()
                            exact += int(torch.equal(got, want))
                            worst["correlate1d"] = max(
                                worst["correlate1d"], _assert_close(
                                    got, want, *_tol(dtype, scale),
                                    f"K8 {what}"))
                            got = ft.correlate1d_transpose(g, w, axis, mode,
                                                           c)
                            want = ft.correlate1d_transpose_plain(
                                g, w, axis, mode, c)
                            terms = ft.correlate1d_transpose_plain(
                                g.abs(), np.abs(w), axis, mode, c)
                            torch.cuda.synchronize()
                            worst["correlate1d_transpose"] = max(
                                worst["correlate1d_transpose"],
                                _assert_close(got, want,
                                              *_terms_tol(dtype, terms),
                                              f"K8T {what}"))
                            if dtype == torch.float64:
                                _check_adjoint(
                                    ft.correlate1d(x, w, axis, mode, 0.0, c),
                                    g, x, got, f"K8/K8T {what}")
                            n += 1
    # the paired route (integer outputs): symmetric and antisymmetric
    # Gaussian taps on integer data in float64, bit for bit
    paired = 0
    for mode in modes:
        for order, pair in ((0, 1), (1, -1), (2, 1)):
            w = ft.gaussian_weights(1.0, order, 4.0, None)
            assert ft._scipy_pair_class(w) == pair
            x = torch.as_tensor(rs.randint(-3000, 3000, (33, 40, 31)),
                                dtype=torch.float64, device=dev)
            for axis in range(3):
                got = ft.correlate1d(x, w, axis, mode, 7.0, len(w) // 2,
                                     pair)
                want = ft.correlate1d_plain(x, w, axis, mode, 7.0,
                                            len(w) // 2, pair)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"K8 paired order={order} {mode} axis={axis}: "
                        f"{int((got != want).sum())} values differ")
                paired += 1
    print(f"K8 correlate1d vs plain: {n} cases pass ({exact} bit for bit), "
          f"max abs err {worst['correlate1d']:.3e}; the paired route bit "
          f"for bit in {paired} cases; K8T correlate1d_transpose within "
          f"{worst['correlate1d_transpose']:.3e}; the K8/K8T adjoint "
          f"identity holds in float64 ({n // 2} cases)")

    n = exact = 0
    for dtype in (torch.float32, torch.float64):
        for mode in modes + ("grid-mirror", "grid-wrap", "grid-constant"):
            for shape, kshape in (((13, 17), (3, 4)), ((5, 6), (7, 3)),
                                  ((9, 10, 11), (3, 2, 5)),
                                  ((2, 9, 10, 11), (1, 3, 3, 3)),
                                  ((6, 3, 7, 5), (4, 1, 1, 3)),
                                  ((3, 4, 5, 6), (2, 3, 2, 3))):
                x = torch.as_tensor(rs.rand(*shape) * 200 - 50, dtype=dtype,
                                    device=dev)
                g = torch.as_tensor(rs.randn(*shape), dtype=dtype, device=dev)
                w = rs.randn(*kshape) * (rs.rand(*kshape) > 0.3)
                w.reshape(-1)[0] = 1.0
                centers = tuple(int(rs.randint(0, k)) for k in kshape)
                md = ft.check_mode(mode)
                what = (f"{dtype} {mode} shape={shape} kernel={kshape} "
                        f"centres={centers}")
                got = ft.correlate_nd(x, w, centers, md, -2.5)
                want = ft.correlate_nd_plain(x, w, centers, md, -2.5)
                torch.cuda.synchronize()
                exact += int(torch.equal(got, want))
                scale = float(x.abs().max()) * float(np.abs(w).sum())
                worst["correlate_nd"] = max(
                    worst["correlate_nd"], _assert_close(
                        got, want, *_tol(dtype, scale), f"K9 {what}"))
                got = ft.correlate_nd_transpose(g, w, centers, md)
                want = ft.correlate_nd_transpose_plain(g, w, centers, md)
                terms = ft.correlate_nd_transpose_plain(g.abs(), np.abs(w),
                                                        centers, md)
                torch.cuda.synchronize()
                worst["correlate_nd_transpose"] = max(
                    worst["correlate_nd_transpose"],
                    _assert_close(got, want, *_terms_tol(dtype, terms),
                                  f"K9T {what}"))
                if dtype == torch.float64:
                    _check_adjoint(ft.correlate_nd(x, w, centers, md, 0.0),
                                   g, x, got, f"K9/K9T {what}")
                n += 1
    print(f"K9 correlate_nd vs plain: {n} cases pass ({exact} bit for bit), "
          f"max abs err {worst['correlate_nd']:.3e}; K9T "
          f"correlate_nd_transpose within "
          f"{worst['correlate_nd_transpose']:.3e}; the K9/K9T adjoint "
          f"identity holds in float64 ({n // 2} cases)")


# morphology dtypes, in the kernels' order
def _morph_dtypes():
    import torch
    return (torch.bool, torch.uint8, torch.int8, torch.uint16, torch.int16,
            torch.uint32, torch.int32, torch.uint64, torch.int64,
            torch.float32, torch.float64)


def _ball(radius):
    """A ball footprint of ``radius`` in a (2r+1)^3 cube (33 taps at r=2)."""
    g = np.indices((2 * radius + 1,) * 3) - radius
    return (g ** 2).sum(0) <= radius ** 2


def _rand_volume(rs, shape, dtype, dev):
    """Seeded values of ``dtype``: the whole integer range or a pool of a
    few values (ties), floats with about 3% NaN, 8% zeros of each sign and a
    few infinities."""
    import torch
    from elasticdeform_tpu_torch.ops.resample import numpy_dtype
    npt = numpy_dtype(dtype)
    if dtype == torch.bool:
        a = rs.rand(*shape) > 0.5
    elif dtype.is_floating_point:
        a = (rs.randn(*shape) * 100).astype(npt)
        a[rs.rand(*shape) < 0.08] = 0.0
        a[rs.rand(*shape) < 0.08] = -0.0
        a[rs.rand(*shape) < 0.03] = np.nan
        a[rs.rand(*shape) < 0.005] = np.inf
        a[rs.rand(*shape) < 0.005] = -np.inf
    else:
        info = np.iinfo(npt)
        a = rs.randint(info.min, info.max, size=shape, dtype=npt)
        a.reshape(-1)[:2] = (info.min, info.max)
        if rs.rand() < 0.5:
            a = rs.choice(a.reshape(-1)[:7], size=shape)
    return torch.as_tensor(np.ascontiguousarray(a)).to(dev)


def _same(got, want, what):
    """Raise unless ``got`` equals ``want`` bit for bit in dtype, shape and
    value: floats by their bits (a zero's sign too), NaN where NaN (a NaN's
    payload is not compared)."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {want.dtype}")
    views = {torch.uint16: torch.int16, torch.uint32: torch.int32,
             torch.uint64: torch.int64, torch.float32: torch.int32,
             torch.float64: torch.int64}
    ok = True
    if got.dtype.is_floating_point:
        nan = torch.isnan(got)
        ok = torch.equal(nan, torch.isnan(want))
        got = torch.where(nan, torch.zeros_like(got), got)
        want = torch.where(nan, torch.zeros_like(want), want)
    if got.dtype in views:
        got, want = got.view(views[got.dtype]), want.view(views[want.dtype])
    ok = ok and torch.equal(got, want)
    if not ok:
        raise AssertionError(f"{what}: not bit-identical to its plain twin, "
                             f"{int((got != want).sum())} values differ")


def _cval_for(rs, dtype):
    """A seeded constant-mode value that converts into ``dtype``."""
    import torch
    from elasticdeform_tpu_torch.ops import morphology as mo
    if dtype.is_floating_point:
        return float(rs.randn() * 50)
    if dtype.is_signed or dtype == torch.bool:
        return mo.raw_cval(rs.uniform(-100.0, 100.0), dtype)
    return mo.raw_cval(rs.uniform(0.0, 200.0), dtype)


def _check_morph_kernels(rs, dev=None):
    """K10-K13 against their plain twins, bit for bit (NaN where NaN; float
    data hold zeros of both signs, whose order min, max and the rank routes
    decide):
    K10 over sizes 1-15 (some longer than the axis) at every centre, the
    five modes, every axis of odd 2-D and 3-D shapes, all eleven dtypes, min
    and max; K11 over random flat and non-flat footprints from 2-D to 4-D,
    centres, modes and dtypes, the non-flat integers saturating; K12 over
    tap counts 2-64 at every rank and 65-343 at five ranks, NaN windows on
    both routes; K13 over random,
    even and empty structures, border 0 and 1, with and without a mask, one
    sweep (and its changed flag) and to the fixpoint."""
    import torch
    from elasticdeform_tpu_torch.ops import morphology as mo
    dev = torch.device("cuda") if dev is None else dev
    dtypes = _morph_dtypes()
    n = 0
    combos = (((37, 41), 0), ((37, 41), 1), ((7, 33, 9), 0), ((7, 33, 9), 1),
              ((7, 33, 9), 2))
    for dtype in dtypes:
        for minimum in (True, False):
            for size in range(1, 16):
                for center in range(size):
                    shape, axis = combos[n % 5]
                    mode = MODES[(n // 5) % 5]
                    x = _rand_volume(rs, shape, dtype, dev)
                    cval = _cval_for(rs, dtype)
                    args = (x, size, axis, mode, cval, center, minimum)
                    got = mo.min_max_filter1d(*args)
                    want = mo.min_max_filter1d_plain(*args)
                    torch.cuda.synchronize()
                    _same(got, want, f"K10 {dtype} {mode} shape={shape} "
                          f"axis={axis} size={size} centre={center} "
                          f"min={minimum}")
                    n += 1
    print(f"K10 min_max_filter1d bit for bit with its plain twin in {n} "
          f"cases")

    n = 0
    geoms = (((13, 17), (3, 3)), ((11, 12), (2, 5)), ((9, 10, 11), (3, 2, 4)),
             ((6, 9, 10), (1, 3, 3)), ((4, 5, 6, 7), (2, 2, 2, 3)))
    for dtype in dtypes:
        for minimum in (True, False):
            for shape, kshape in geoms:
                for nonflat in (False, True):
                    mode = MODES[n % 5]
                    fp = rs.rand(*kshape) > 0.3
                    fp.reshape(-1)[rs.randint(fp.size)] = True
                    centers = [int(rs.randint(0, k)) for k in kshape]
                    st = None
                    work = dtype
                    if nonflat:
                        st = np.round(rs.randn(*kshape) * 50, 1)
                        if not dtype.is_floating_point:
                            work = torch.float64
                    x = _rand_volume(rs, shape, dtype, dev)
                    cval = _cval_for(rs, work)
                    args = (x, fp, st, centers, mode, cval, minimum)
                    got = mo.min_max_filter(*args)
                    want = mo.min_max_filter_plain(*args)
                    torch.cuda.synchronize()
                    _same(got, want, f"K11 {dtype} {mode} shape={shape} "
                          f"footprint={kshape} centres={centers} "
                          f"nonflat={nonflat} min={minimum}")
                    n += 1
    print(f"K11 min_max_filter bit for bit with its plain twin in {n} cases")

    n = 0
    for k in list(range(2, 65)) + [65, 100, 125, 200, 343]:
        if k <= 25:
            shape, kshape = (13, 17), (5, 5)
        elif k <= 64:
            shape, kshape = (9, 10, 11), (4, 4, 4)
        elif k <= 125:
            shape, kshape = (9, 10, 11), (5, 5, 5)
        else:
            shape, kshape = (9, 10, 11), (7, 7, 7)
        ranks = range(k) if k <= 64 else (0, 1, k // 2, k - 2, k - 1)
        for rank in ranks:
            fp = np.zeros(int(np.prod(kshape)), dtype=bool)
            fp[rs.choice(fp.size, k, replace=False)] = True
            fp = fp.reshape(kshape)
            dtype = dtypes[(n + k) % len(dtypes)] if k > 4 else \
                torch.float32
            if k > 64 and n % 2 == 0:
                dtype = (torch.float32, torch.float64)[n % 4 // 2]
            mode = MODES[n % 5]
            centers = [int(rs.randint(0, s)) for s in kshape]
            x = _rand_volume(rs, shape, dtype, dev)
            args = (x, fp, centers, mode, _cval_for(rs, dtype), rank)
            got = mo.rank_filter(*args)
            want = mo.rank_filter_plain(*args)
            torch.cuda.synchronize()
            _same(got, want, f"K12 {dtype} {mode} taps={k} rank={rank} "
                  f"centres={centers}")
            n += 1
    print(f"K12 rank_filter bit for bit with its plain twin in {n} cases "
          f"(network route up to {mo.RANK_NETWORK_MAX_TAPS} taps, select "
          f"route above; float inputs hold NaN windows)")

    n = 0
    for shape, kshape in (((16, 17), (3, 3)), ((16, 17), (2, 3)),
                          ((16, 17), (1, 4)), ((9, 10, 11), (3, 3, 3)),
                          ((9, 10, 11), (2, 2, 3)), ((16, 17), (0, 0))):
        for border in (False, True):
            for use_mask in (False, True):
                for dilation in (False, True):
                    if kshape == (0, 0):
                        st = np.zeros((3, 3), dtype=bool)
                    else:
                        st = rs.rand(*kshape) > 0.4
                    centers = [int(rs.randint(0, s)) for s in st.shape]
                    x = torch.as_tensor(rs.rand(*shape) > 0.5).to(dev)
                    mask = torch.as_tensor(rs.rand(*shape) > 0.3).to(dev) \
                        if use_mask else None
                    flags = [torch.zeros(1, dtype=torch.int32, device=dev)
                             for _ in range(2)]
                    got = mo.binary_step(x, st, centers, border, dilation,
                                         mask, flags[0])
                    want = mo.binary_step_plain(x, st, centers, border,
                                                dilation, mask, flags[1])
                    torch.cuda.synchronize()
                    what = (f"K13 structure={st.astype(int).tolist()} "
                            f"border={border} mask={use_mask} "
                            f"dilation={dilation}")
                    _same(got, want, what)
                    _same(flags[0], flags[1], f"{what} changed flag")
                    # binary_erosion_dilation, three sweeps and to the
                    # fixpoint, against the CPU run; the centre tap keeps
                    # each sweep monotone, so the fixpoint is reached
                    st[tuple(k // 2 for k in st.shape)] |= kshape != (0, 0)
                    for its in (3, 0):
                        got = mo.binary_erosion_dilation(
                            x, st, its, mask, border, 0, dilation)
                        want = mo.binary_erosion_dilation(
                            x.cpu(), st, its,
                            None if mask is None else mask.cpu(), border, 0,
                            dilation)
                        torch.cuda.synchronize()
                        _same(got.cpu(), want, f"{what} iterations={its}")
                    n += 1
    print(f"K13 binary_step bit for bit with its plain twin in {n} cases, "
          f"each also at 3 iterations and to the fixpoint against the CPU "
          f"run")


def _check_k3(rb, g, bargs, in_sp, dtype, what):
    """K3 against its plain version. Atomics add in a run-dependent order,
    so float32 is held to rtol=1e-5 and atol=1e-5 * S elementwise, where S
    (the plain transpose of |g|) is the sum of the absolute terms that
    land on the element (B-spline weights are >= 0 up to rounding);
    float64 to 1e-10."""
    import torch
    got = rb.resample_transpose(g, *bargs, in_sp)
    want = rb.resample_transpose_plain(g, *bargs, in_sp)
    terms = rb.resample_transpose_plain(g.abs(), *bargs, in_sp)
    torch.cuda.synchronize()
    rtol, _ = _tol(dtype, 1.0)
    return _assert_close(got, want, rtol, rtol * terms.double().abs(),
                         what)


def _k5_scale(coeffs, g):
    """Bound on the sum of a K5 voxel's absolute terms: the weights are
    >= 0 and sum to 1, the derivative weights' absolute values to at most
    2, the fold's derivative is at most 1, so 2 * C * max|g| * max|coeffs|."""
    return 2.0 * coeffs.shape[-1] * float(g.abs().max()) * \
        float(coeffs.abs().max())


def _check_adjoint(ax, y, x, aty, what):
    """<A x, y> == <x, A^T y> in float64, to 1e-10 of the sum of the
    absolute products."""
    lhs = float((ax * y).sum())
    rhs = float((x * aty).sum())
    scale = float((ax.abs() * y.abs()).sum()) + \
        float((x.abs() * aty.abs()).sum())
    if abs(lhs - rhs) > 1e-10 * scale:
        raise AssertionError(f"{what}: adjoint identity off, <Ax,y>={lhs!r} "
                             f"<x,A^T y>={rhs!r}")


class _Config:
    """One BASELINE config: ``run(device, n)`` drives the public entry
    points and returns the tensors or arrays to compare (``n`` samples of a
    batch, all if None); ``tols`` holds (rtol, atol / max|ref|) per output;
    ``n_vox`` counts output voxels; ``nsub`` is the batch subset the CPU
    run recomputes (None: all)."""

    def __init__(self, name, run, n_vox, tols, nsub=None):
        self.name, self.run, self.n_vox = name, run, n_vox
        self.tols, self.nsub = tols, nsub


def _on(cache, device, *arrays):
    """The arrays as tensors on ``device``, uploaded once per device."""
    import torch
    key = str(device)
    if key not in cache:
        cache[key] = [torch.as_tensor(a).to(device) for a in arrays]
    return cache[key]


def _configs(seed=0):
    """The BASELINE configs: c1, c2, c3 and c3's gradient, c4, c5, c6."""
    import torch
    import elasticdeform_tpu_torch as et
    rs = np.random.RandomState(seed)
    F32 = (1e-5, 1e-4)   # float32 output against the CPU run
    EXACT = "exact"      # float output bit for bit with the CPU run
    # a float32 grid gradient sums 64^3 voxels' signed terms per sample;
    # reordered float32 sums of that length differ by ~1e-4 of the largest
    GRID32 = (1e-4, 1e-3)

    X1 = rs.rand(200, 300)

    def c1(device, n=None):
        np.random.seed(seed + 1)
        return [et.deform_random_grid(X1, sigma=25, points=3, order=3,
                                      mode="mirror", device=device)]

    rgb = rs.rand(200, 300, 3).astype(np.float32)
    seg = (rs.rand(200, 300) * 5).astype(np.uint8)
    d2 = rs.randn(2, 3, 3) * 25

    def c2(device, n=None):
        return et.deform_grid([rgb, seg], d2, order=[3, 0], axis=(0, 1),
                              device=device)

    X3 = rs.rand(128, 128, 128).astype(np.float32)
    d3 = (rs.randn(3, 3, 3, 3) * 8).astype(np.float32)
    th = np.radians(12.0)
    A3 = np.array([[np.cos(th), -np.sin(th), 0, 4.0],
                   [np.sin(th), np.cos(th), 0, -3.0],
                   [0, 0, 1.1, 2.0]])
    crop3 = [slice(16, 112)] * 3

    def c3(device, n=None):
        return [et.deform_grid(X3, d3, order=3, mode="constant", crop=crop3,
                               affine=A3, device=device)]

    dY3 = rs.rand(96, 96, 96).astype(np.float32)

    def c3_grad(device, n=None):
        return [et.deform_grid_gradient(dY3, d3, order=3, mode="constant",
                                        crop=crop3, X_shape=X3.shape,
                                        affine=A3, device=device)]

    # c4: one train step, mean((y - t)^2) differentiated with respect to X
    X4 = rs.rand(64, 64, 64).astype(np.float32)
    d4 = (rs.randn(3, 3, 3, 3) * 15).astype(np.float32)
    t4 = rs.rand(64, 64, 64).astype(np.float32)
    dev4 = {}

    def c4(device, n=None):
        x, d, t = _on(dev4, device, X4, d4, t4)
        x = x.detach().requires_grad_()
        y = et.deform(x, d, order=3, mode="mirror", device=device)
        (gx,) = torch.autograd.grad(torch.mean((y - t) ** 2), x)
        return [y.detach(), gx]

    # c5: the batched forward, then its backward with a given gy
    X5 = rs.rand(64, 64, 64, 64).astype(np.float32)
    d5 = (rs.randn(64, 3, 3, 3, 3) * 6).astype(np.float32)
    gy5 = rs.rand(64, 64, 64, 64).astype(np.float32)
    dev5 = {}

    def c5(device, n=None):
        x, d, gy = (a[:n] for a in _on(dev5, device, X5, d5, gy5))
        x = x.detach().requires_grad_()
        y = et.deform_batch(x, d, order=3, mode="mirror", device=device)
        (gx,) = torch.autograd.grad(y, x, gy)
        return [y.detach(), gx]

    # c6: batched, per-sample grids, autograd to X and to the grids
    X6 = rs.rand(8, 64, 64, 64).astype(np.float32)
    d6 = (rs.randn(8, 3, 3, 3, 3) * 6).astype(np.float32)
    gy6 = rs.randn(8, 64, 64, 64).astype(np.float32)
    dev6 = {}

    def c6(device, n=None):
        x, d, gy = (a[:n] for a in _on(dev6, device, X6, d6, gy6))
        x = x.detach().requires_grad_()
        d = d.detach().requires_grad_()
        y = et.deform_batch(x, d, order=3, mode="mirror", device=device)
        gx, gd = torch.autograd.grad(y, (x, d), gy)
        return [y.detach(), gx, gd]

    # c7: the registration training warp, deform_field_batch order 1
    # nearest on the VoxelMorph brain-MRI volume, autograd to X and the field
    S7 = (160, 192, 224)
    X7 = rs.rand(4, *S7).astype(np.float32)
    F7 = _smooth_field(rs, 4, S7, 4.0)
    gy7 = rs.randn(4, *S7).astype(np.float32)
    dev7 = {}

    def c7(device, n=None):
        x, f, gy = (a[:n] for a in _on(dev7, device, X7, F7, gy7))
        x = x.detach().requires_grad_()
        f = f.detach().requires_grad_()
        y = et.deform_field_batch(x, f, order=1, mode="nearest",
                                  device=device)
        gx, gf = torch.autograd.grad(y, (x, f), gy)
        return [y.detach(), gx, gf]

    # c8: affine_transform order 3, modern reflect, a 12 degree rotation,
    # a 1.1 zoom and a shift about the centre; autograd to X
    X8 = rs.rand(*S7).astype(np.float32)
    gy8 = rs.randn(*S7).astype(np.float32)
    M8, off8 = _c8_affine(S7)
    dev8 = {}

    def c8(device, n=None):
        x, gy = _on(dev8, device, X8, gy8)
        x = x.detach().requires_grad_()
        y = et.affine_transform(x, M8, off8, order=3, mode="reflect",
                                device=device)
        (gx,) = torch.autograd.grad(y, x, gy)
        return [y.detach(), gx]

    X9 = rs.rand(96, 96, 96).astype(np.float32)
    dev9 = {}

    def c9(device, n=None):
        (x,) = _on(dev9, device, X9)
        return [et.zoom(x, 2.0, order=3, mode="grid-wrap", grid_mode=True,
                        device=device)]

    # c10: map_coordinates, grid-constant with cval=-1 at coordinates up to
    # 25 voxels past the extent, then its adjoint
    X10 = rs.rand(128, 128, 128).astype(np.float32)
    j = np.arange(128, dtype=np.float64) * (177.0 / 127.0) - 25.0
    C10 = np.stack(np.meshgrid(j, j, j, indexing="ij"))
    C10 = (C10 + rs.randn(*C10.shape) * 0.3).astype(np.float32)
    dy10 = rs.randn(128, 128, 128).astype(np.float32)
    dev10 = {}

    def c10(device, n=None):
        x, c, dy = _on(dev10, device, X10, C10, dy10)
        kw = dict(order=3, mode="grid-constant", cval=-1.0, device=device)
        return [et.map_coordinates(x, c, **kw),
                et.map_coordinates_gradient(dy, c, X_shape=x.shape, **kw)]

    # c11: regularising a displacement field, as registration loops do every
    # iteration: gaussian_filter over the spatial axes of the VoxelMorph
    # volume's field, sigma 2, reflect; autograd of a given gy to the field
    F11 = _smooth_field(rs, 1, S7, 4.0)[0] + \
        rs.randn(3, *S7).astype(np.float32) * 0.5
    gy11 = rs.randn(3, *S7).astype(np.float32)
    dev11 = {}

    def c11(device, n=None):
        f, gy = (a[:n] for a in _on(dev11, device, F11, gy11))
        f = f.detach().requires_grad_()
        y = et.gaussian_filter(f, 2.0, mode="reflect", axes=(1, 2, 3),
                               device=device)
        (gf,) = torch.autograd.grad(y, f, gy)
        return [y.detach(), gf]

    # c12: similarity-pyramid features, LoG and gradient magnitude, nearest
    X12 = rs.rand(*S7).astype(np.float32)
    dev12 = {}

    def c12(device, n=None):
        (x,) = _on(dev12, device, X12)
        kw = dict(mode="nearest", device=device)
        return [et.gaussian_laplace(x, 1.5, **kw),
                et.gaussian_gradient_magnitude(x, 1.5, **kw)]

    # c13: an int16 CT volume smoothed with int16 output (the paired route
    # in float64, truncated per pass), then sobel along axis 0 (wraps); the
    # CPU run of the whole volume takes 11 s on the card's host
    X13 = rs.randint(-1024, 3072, (512, 512, 300)).astype(np.int16)
    dev13 = {}

    def c13(device, n=None):
        (x,) = _on(dev13, device, X13)
        kw = dict(output=np.int16, device=device)
        return [et.gaussian_filter(x, 1.0, mode="mirror", **kw),
                et.sobel(x, 0, **kw)]

    # c14: N-D correlation with a seeded 5^3 kernel, constant cval 0.5,
    # origin (1, 0, -1), autograd to X; convolve with a 3^3 kernel on the
    # spatial axes of a batch of two
    X14 = rs.rand(*S7).astype(np.float32)
    gy14 = rs.randn(*S7).astype(np.float32)
    W14 = rs.randn(5, 5, 5)
    B14 = rs.rand(2, *S7).astype(np.float32)
    K14 = rs.randn(3, 3, 3)
    dev14 = {}

    def c14(device, n=None):
        x, gy, b = _on(dev14, device, X14, gy14, B14)
        x = x.detach().requires_grad_()
        y = et.correlate(x, W14, mode="constant", cval=0.5, origin=(1, 0, -1),
                         device=device)
        (gx,) = torch.autograd.grad(y, x, gy)
        return [y.detach(), gx,
                et.convolve(b, K14, mode="reflect", axes=(1, 2, 3),
                            device=device)]

    # c15: median denoising of a brain-MRI-like volume (c7's shape) before
    # registration: 3^3 median (27 taps, network route), 5^3 median (125
    # taps, select route) of the first 80 slices, 20th percentile over a
    # ball of radius 2 (33 taps); the whole 5^3 median made the CPU run take
    # 18.4 s on the card's host
    X15 = _mri_like(rs, S7)
    dev15 = {}

    def c15(device, n=None):
        (x,) = _on(dev15, device, X15)
        return [et.median_filter(x, size=3, device=device),
                et.median_filter(x[:80], size=5, device=device),
                et.percentile_filter(x, 20, footprint=_ball(2),
                                     device=device)]

    # c16: grey morphology of c13's int16 CT volume: opening with a 5^3 box
    # (six K10 passes), white top-hat with a ball (K11 erosion and
    # dilation), dilation of the first 256 slices with a non-flat 3^3
    # structure (float64 work type, saturating cast); on the whole volume
    # it made the CPU run take 17.3 s on the card's host
    X16 = rs.randint(-1024, 3072, (512, 512, 300)).astype(np.int16)
    g3 = np.indices((3, 3, 3)) - 1
    S16 = -30.0 * (g3 ** 2).sum(0)
    dev16 = {}

    def c16(device, n=None):
        (x,) = _on(dev16, device, X16)
        return [et.grey_opening(x, size=5, device=device),
                et.white_tophat(x, footprint=_ball(2), device=device),
                et.grey_dilation(x[:256], structure=S16, device=device)]

    # c17: clean-up of a bool segmentation with enclosed holes: opening with
    # a 3^3 cube, two iterations (four K13 sweeps), hole filling and
    # propagation of a seed inside the mask (K13 to the fixpoint); the K13
    # launches of each call are kept in ``sweeps``
    M17, seed17 = _segmentation(rs, S7)
    dev17 = {}
    sweeps17 = {}

    def c17(device, n=None):
        from elasticdeform_tpu_torch.ops import morphology as mo
        m, sd = _on(dev17, device, M17, seed17)
        out = []
        for name, call in (
                ("opening", lambda: et.binary_opening(
                    m, structure=np.ones((3, 3, 3)), iterations=2,
                    device=device)),
                ("fill_holes", lambda: et.binary_fill_holes(m,
                                                            device=device)),
                ("propagation", lambda: et.binary_propagation(
                    sd, mask=m, device=device))):
            before = mo.binary_step.launches
            out.append(call())
            sweeps17[name] = mo.binary_step.launches - before
        return out

    cfg17 = _Config("c17", c17, 3 * math.prod(S7), [None, None, None])
    cfg17.sweeps = sweeps17

    return [_Config("c1", c1, 200 * 300, [(1e-10, 1e-10)]),
            _Config("c2", c2, 200 * 300, [F32, F32]),
            _Config("c3", c3, 96 ** 3, [F32]),
            _Config("c3_grad", c3_grad, 96 ** 3, [F32]),
            _Config("c4", c4, 64 ** 3, [F32, F32]),
            _Config("c5", c5, 64 * 64 ** 3, [F32, F32], nsub=2),
            _Config("c6", c6, 8 * 64 ** 3, [F32, F32, GRID32], nsub=2),
            _Config("c7", c7, 4 * math.prod(S7), [F32, F32, F32], nsub=1),
            _Config("c8", c8, math.prod(S7), [F32, F32]),
            _Config("c9", c9, 192 ** 3, [F32]),
            _Config("c10", c10, 128 ** 3, [F32, F32]),
            _Config("c11", c11, 3 * math.prod(S7), [F32, F32], nsub=1),
            _Config("c12", c12, math.prod(S7), [F32, F32]),
            _Config("c13", c13, 512 * 512 * 300, [None, None]),
            _Config("c14", c14, 3 * math.prod(S7), [F32, F32, F32]),
            _Config("c15", c15, (2 * 160 + 80) * 192 * 224, [EXACT] * 3),
            _Config("c16", c16, (2 * 512 + 256) * 512 * 300, [None] * 3),
            cfg17]


def _mri_like(rs, shape):
    """A float32 volume shaped like a brain MRI scan: a smooth intensity
    field inside an ellipsoid, dark outside, with 5% Gaussian noise."""
    axes = [np.linspace(-1, 1, n, dtype=np.float32) for n in shape]
    g = np.meshgrid(*axes, indexing="ij", sparse=True)
    r2 = sum(a * a / (0.85 ** 2) for a in g)
    brain = 0.6 + 0.3 * _smooth_field(rs, 1, shape, 1.0)[0, 0]
    vol = np.where(r2 < 1.0, brain, 0.05).astype(np.float32)
    return vol + rs.randn(*shape).astype(np.float32) * 0.05


def _segmentation(rs, shape):
    """A bool segmentation mask: an ellipsoid less where a noisy smooth field
    peaks (an irregular outline, speckle holes), with twelve enclosed
    spherical cavities of radius 4-10 voxels, and a seed voxel inside it."""
    axes = [np.linspace(-1, 1, n, dtype=np.float32) for n in shape]
    g = np.meshgrid(*axes, indexing="ij", sparse=True)
    r2 = sum(a * a / (0.8 ** 2) for a in g)
    field = _smooth_field(rs, 1, shape, 3.0)[0, 0]
    field = field + rs.randn(*shape).astype(np.float32) * 0.05
    mask = (r2 < 1.0) & (field < np.quantile(field, 0.9))
    idx = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij",
                      sparse=True)
    for _ in range(12):
        c = [int(n * rs.uniform(0.35, 0.65)) for n in shape]
        r = rs.uniform(4.0, 10.0)
        mask[sum((i - ci) ** 2 for i, ci in zip(idx, c)) <= r * r] = False
    seed = np.zeros(shape, dtype=bool)
    inside = np.argwhere(mask & (r2 < 0.1))
    seed[tuple(inside[len(inside) // 2])] = True
    return mask, seed


def _smooth_field(rs, B, shape, amplitude):
    """A smooth dense displacement field ``(B, naxis, *shape)`` float32 of
    about ``amplitude`` voxels: a few low-frequency sines per component."""
    axes = [np.linspace(0, 1, n, dtype=np.float32) for n in shape]
    f = np.empty((B, len(shape), *shape), dtype=np.float32)
    for b in range(B):
        for h in range(len(shape)):
            acc = np.zeros(shape, dtype=np.float32)
            for k, ax in enumerate(axes):
                view = [1] * len(shape)
                view[k] = -1
                acc = acc + np.sin(ax * rs.uniform(2, 6) + rs.uniform(0, 6)
                                   ).reshape(view)
            f[b, h] = acc * (amplitude / len(shape))
    return f


def _c8_affine(shape):
    """c8's pull-back matrix and offset: a 12 degree rotation in the plane
    of axes 0 and 1 and a 1.1 zoom about the centre, then a shift."""
    th = np.radians(12.0)
    rot = np.array([[np.cos(th), -np.sin(th), 0.0],
                    [np.sin(th), np.cos(th), 0.0],
                    [0.0, 0.0, 1.0]])
    M = rot / 1.1
    centre = (np.asarray(shape, dtype=np.float64) - 1) / 2
    return M, centre - M @ centre + np.array([3.0, -2.0, 1.5])


# kernels each config must launch, and kernels it must not (K5 and K5c
# only where a gradient to the grid or the coordinates is asked for)
_MUST_LAUNCH = {"c3_grad": ("resample_bwd", "spline_prefilter_transpose"),
                "c4": ("resample_bwd", "spline_prefilter_transpose"),
                "c5": ("resample_bwd", "spline_prefilter_transpose"),
                "c6": ("resample_bwd", "spline_prefilter_transpose",
                       "resample_coord_grad"),
                "c7": ("resample_coords_fwd", "resample_coords_bwd",
                       "resample_coords_grad"),
                "c8": ("spline_prefilter_bc", "resample_coords_fwd",
                       "resample_coords_bwd",
                       "spline_prefilter_bc_transpose"),
                "c9": ("spline_prefilter_bc", "resample_coords_fwd"),
                "c10": ("spline_prefilter", "resample_coords_fwd",
                        "resample_coords_bwd", "spline_prefilter_transpose"),
                "c11": ("correlate1d", "correlate1d_transpose"),
                "c12": ("correlate1d",),
                "c13": ("correlate1d",),
                "c14": ("correlate_nd", "correlate_nd_transpose"),
                "c15": ("rank_filter",),
                "c16": ("min_max_filter1d", "min_max_filter"),
                "c17": ("binary_step",)}
# exact launch counts of the filter configs: c11 one K8 and one K8T per
# spatial axis; c12 three passes for each of the three LoG and three
# gradient terms; c13 three gaussian passes and sobel's three; c14 K9 for
# correlate and convolve, K9T for the gradient
_EXACT_LAUNCHES = {
    "c11": {"correlate1d": 3, "correlate1d_transpose": 3, "correlate_nd": 0,
            "correlate_nd_transpose": 0},
    "c12": {"correlate1d": 18, "correlate1d_transpose": 0, "correlate_nd": 0,
            "correlate_nd_transpose": 0},
    "c13": {"correlate1d": 6, "correlate1d_transpose": 0, "correlate_nd": 0,
            "correlate_nd_transpose": 0},
    "c14": {"correlate1d": 0, "correlate1d_transpose": 0, "correlate_nd": 2,
            "correlate_nd_transpose": 1},
    # c15: one K12 per filter; c16: K10 on three axes for the erosion and
    # the dilation of the opening, K11 for the top-hat's erosion and
    # dilation and for the non-flat dilation
    "c15": {"min_max_filter1d": 0, "min_max_filter": 0, "rank_filter": 3,
            "binary_step": 0},
    "c16": {"min_max_filter1d": 6, "min_max_filter": 3, "rank_filter": 0,
            "binary_step": 0}}
_DEFORM_KERNELS = ("resample_fwd", "resample_bwd", "resample_coord_grad")
_MUST_NOT_LAUNCH = {"c3_grad": ("resample_coord_grad",),
                    "c4": ("resample_coord_grad",),
                    "c5": ("resample_coord_grad",),
                    "c7": ("spline_prefilter", "spline_prefilter_transpose",
                           "spline_prefilter_bc",
                           "spline_prefilter_bc_transpose") + _DEFORM_KERNELS,
                    "c8": ("resample_coords_grad", "spline_prefilter")
                + _DEFORM_KERNELS,
                    "c9": ("resample_coords_bwd", "resample_coords_grad",
                           "spline_prefilter", "spline_prefilter_transpose",
                           "spline_prefilter_bc_transpose") + _DEFORM_KERNELS,
                    "c10": ("resample_coords_grad", "spline_prefilter_bc",
                            "spline_prefilter_bc_transpose")
                    + _DEFORM_KERNELS}
# the resampler's configs run no filter or morphology kernel, the filter
# and morphology configs nothing outside their tier; c17 only K13 (its sweep
# counts are checked per call)
for _name in ("c1", "c2", "c3", "c3_grad", "c4", "c5", "c6", "c7", "c8",
              "c9", "c10"):
    _MUST_NOT_LAUNCH[_name] = _MUST_NOT_LAUNCH.get(_name, ()) + \
        FILTER_KERNELS + MORPH_KERNELS + PROBE_KERNELS
for _name, _tier in (("c11", FILTER_KERNELS), ("c12", FILTER_KERNELS),
                     ("c13", FILTER_KERNELS), ("c14", FILTER_KERNELS),
                     ("c15", MORPH_KERNELS), ("c16", MORPH_KERNELS),
                     ("c17", ("binary_step",))):
    _MUST_NOT_LAUNCH[_name] = tuple(k for k in KERNELS if k not in _tier)


def _wrappers():
    """Each kernel's wrappers, which hold its launch counters (P2 has one
    per mode)."""
    from elasticdeform_tpu_torch.ops import probes as po
    return {k: w if isinstance(w, tuple) else (w,)
            for k, w in {**_path_wrappers(), **po.KERNEL_WRAPPERS}.items()}


def _path_wrappers():
    from elasticdeform_tpu_torch.ops import filters as ft
    from elasticdeform_tpu_torch.ops import morphology as mo
    from elasticdeform_tpu_torch.ops import prefilter as pf
    from elasticdeform_tpu_torch.ops import resample as rsm
    from elasticdeform_tpu_torch.ops import resample_bwd as rb
    return {"resample_fwd": rsm.resample,
            "spline_prefilter": pf.spline_filter1d,
            "resample_bwd": rb.resample_transpose,
            "spline_prefilter_transpose": pf.spline_filter1d_transpose,
            "resample_coord_grad": rb.resample_coord_grad,
            "spline_prefilter_bc": pf.spline_filter1d_bc,
            "spline_prefilter_bc_transpose": pf.spline_filter1d_bc_transpose,
            "resample_coords_fwd": rsm.resample_coords,
            "resample_coords_bwd": rb.resample_coords_transpose,
            "resample_coords_grad": rb.resample_coords_grad,
            "correlate1d": ft.correlate1d,
            "correlate1d_transpose": ft.correlate1d_transpose,
            "correlate_nd": ft.correlate_nd,
            "correlate_nd_transpose": ft.correlate_nd_transpose,
            "min_max_filter1d": mo.min_max_filter1d,
            "min_max_filter": mo.min_max_filter,
            "rank_filter": mo.rank_filter,
            "binary_step": mo.binary_step}


def _counts():
    return {k: sum(w.launches for w in ws) for k, ws in _wrappers().items()}


def _reset_counts():
    for ws in _wrappers().values():
        for w in ws:
            w.launches = 0


def phase_main_path():
    """Phase 3: the public entry points on the card, counted, then each
    output against the port's CPU run."""
    import torch
    configs = _configs()
    outs, launches = {}, {}
    total = dict.fromkeys(PATH_KERNELS, 0)
    for cfg in configs:
        _reset_counts()
        outs[cfg.name] = cfg.run("cuda")
        torch.cuda.synchronize()
        launches[cfg.name] = _counts()
        for k in PATH_KERNELS:
            total[k] += launches[cfg.name][k]
    print(f"main path launches per config: {json.dumps(launches)}")
    if min(total.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never ran: {total}")
    for name, kernels in _MUST_LAUNCH.items():
        for k in kernels:
            if launches[name][k] <= 0:
                raise AssertionError(f"{name} did not launch {k}")
    for name, kernels in _MUST_NOT_LAUNCH.items():
        for k in kernels:
            if launches[name][k] != 0:
                raise AssertionError(f"{name} launched {k}, which it does "
                                     "not need")
    for name, counts in _EXACT_LAUNCHES.items():
        for k, v in counts.items():
            if launches[name][k] != v:
                raise AssertionError(f"{name} launched {k} "
                                     f"{launches[name][k]} times, not {v}")
    for cfg in configs:
        sweeps = getattr(cfg, "sweeps", None)
        if sweeps is None:
            continue
        print(f"{cfg.name} K13 sweeps per call: {json.dumps(sweeps)}")
        if sweeps["opening"] != 4 or min(sweeps.values()) < 1:
            raise AssertionError(f"{cfg.name}: the opening must take 4 K13 "
                                 "sweeps and each fixpoint at least one, got "
                                 f"{sweeps}")

    for cfg in configs:
        t0 = time.perf_counter()
        ref = cfg.run("cpu", cfg.nsub)
        print(f"{cfg.name}: CPU run {time.perf_counter() - t0:.1f} s")
        assert len(ref) == len(outs[cfg.name]) == len(cfg.tols)
        for i, (got, want, tol) in enumerate(zip(outs[cfg.name], ref,
                                                 cfg.tols)):
            what = f"{cfg.name} output {i}"
            got = torch.as_tensor(got).cpu()
            want = torch.as_tensor(want)
            got = got[:cfg.nsub] if cfg.nsub else got
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(
                    f"{what}: got {tuple(got.shape)} {got.dtype}, CPU run "
                    f"gives {tuple(want.shape)} {want.dtype}")
            if not bool(torch.isfinite(got.double()).all()):
                raise AssertionError(f"{what}: non-finite output")
            if tol == "exact":
                _same(got, want, f"{what} vs CPU")
                print(f"{what}: {tuple(got.shape)} {got.dtype} equals the "
                      "CPU run bit for bit")
                continue
            if not got.dtype.is_floating_point:
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{what}: {int((got != want).sum())} integer values "
                        "differ from the CPU run")
                print(f"{what}: {tuple(got.shape)} {got.dtype} equals the "
                      "CPU run")
                continue
            rtol, atol_scale = tol
            scale = float(want.abs().max())
            err = _assert_close(got, want, rtol, atol_scale * scale,
                                f"{what} vs CPU")
            print(f"{what}: {tuple(got.shape)} {got.dtype} matches the CPU "
                  f"run (max abs err {err:.3e}, rtol={rtol}, "
                  f"atol={atol_scale:g}*max|ref|)")
    return total, launches


# ---------------------------------------------------------------------------
# the probes: kernels P1-P4 at the JAX probes' default sizes


# probe_dyngather2's four runs: (label, contract, n_rows, chunk, idx_shape)
_PROBE_DEVICE = "cuda"
_DG2_RUNS = (("take axis=0, idx 1-D", "take", 1024, 1024, None),
             ("take_along_axis, idx 2-D", "take_along", 1024, 1024, "2d"),
             ("fancy [idx2d, iota]", "fancy", 1024, 1024, "2d"),
             ("take_along big (64K rows)", "take_along", 65536, 32768, "2d"))


def _probe_data():
    """Every probe's inputs on the card at the JAX probes' default sizes,
    drawn once: ``pl_dma``'s 2 GiB table serves phases 2-4, and is also
    the table of the ``xla`` and ``xla_map_sample`` yardsticks (the same
    draw)."""
    import torch
    from elasticdeform_tpu_torch.probes import _common
    from elasticdeform_tpu_torch.probes import probe_dyngather2 as dg2
    from elasticdeform_tpu_torch.probes import probe_pallas as pp
    t0 = time.perf_counter()
    dev = _PROBE_DEVICE
    d = {"dynload": pp.dynload_data(dev), "dynstore": pp.dynstore_data(dev),
         "dyngather": pp.dyngather_data(dev),
         "scatrate": pp.scatrate_data(device=dev),
         # pl_vmem, both pl_dg and xla_small; pl_loop_gather and
         # pl_loop_scatter; pl_dma; onehot
         "1m": _common.make_data(8192, 1 << 20, device=dev),
         "512k": _common.make_data(8192, 1 << 19, device=dev),
         "dma": _common.make_data(1 << 22, 1 << 18, device=dev),
         "onehot": _common.make_data(2048, 1 << 20, device=dev)}
    for label, _, n_rows, chunk, shape in _DG2_RUNS:
        d[label] = dg2.gather_data(n_rows, chunk, shape, dev)
    torch.cuda.synchronize()
    print(f"probe data drawn and uploaded in {time.perf_counter() - t0:.1f} "
          "s")
    return d


def _probe_cases(d):
    """``(label, kernel, entry, kernel call, plain call, kind)`` for every
    Pallas probe: ``entry`` drives the port's public probe function on
    ``d``, ``kernel call`` the wrapper directly; ``kind`` says how it is
    held against its twin: ``bits``, ``sum`` (1e-5 of the sum of the
    absolute terms, all positive here: the twin itself), ``scatter`` (the
    same, atomics), ``count`` (integer counts, exact)."""
    import torch
    from elasticdeform_tpu_torch.ops import probes as po
    from elasticdeform_tpu_torch.probes import probe_dyngather2 as dg2
    from elasticdeform_tpu_torch.probes import probe_gather as pg
    from elasticdeform_tpu_torch.probes import probe_gather2 as pg2
    from elasticdeform_tpu_torch.probes import probe_pallas as pp
    ones8 = torch.ones((8, 128), device=_PROBE_DEVICE)
    cases = [(f"smem{k}", "smem_probe",
              lambda k=k: pp.vmem(k, _PROBE_DEVICE),
              lambda k=k: po.smem_probe(ones8, k * 1024),
              lambda: ones8.clone(), "bits") for k in pp.SMEM_KIB[:-1]]
    t, i = d["dynload"]
    cases.append(("dynload", "row_gather",
                  lambda: pp.dynload(data=d["dynload"]),
                  lambda: po.row_gather_sum(t, i, 65536, 8),
                  lambda: po.row_gather_sum_plain(t, i, 65536, 8), "sum"))
    si, sv = d["dynstore"]
    cases.append(("dynstore", "row_scatter_add",
                  lambda: pp.dynstore(data=d["dynstore"]),
                  lambda: po.row_scatter_add(si, sv, 8192),
                  lambda: po.row_scatter_add_plain(si, sv, 8192), "scatter"))
    gt, gi = d["dyngather"]
    cases.append(("dyngather", "row_gather",
                  lambda: pp.dyngather(data=d["dyngather"]),
                  lambda: po.row_gather(gt, gi),
                  lambda: po.row_gather_plain(gt, gi), "bits"))
    ci, cv = d["scatrate"]
    cases.append(("scatrate", "row_scatter_add",
                  lambda: pp.scatrate(data=d["scatrate"]),
                  lambda: po.row_scatter_add(ci, cv, 40960),
                  lambda: po.row_scatter_add_plain(ci, cv, 40960),
                  "scatter"))
    t1, i1 = d["1m"]
    n1 = i1.numel()
    cases += [
        ("pl_vmem", "row_gather", lambda: pg.pl_vmem(data=d["1m"]),
         lambda: po.row_gather_sum(t1, i1, 8192),
         lambda: po.row_gather_sum_plain(t1, i1, 8192), "sum"),
        ("pl_dg", "row_gather", lambda: pg.pl_dg(data=d["1m"]),
         lambda: po.row_gather(t1, i1, n1 - 8192),
         lambda: po.row_gather_plain(t1, i1, n1 - 8192), "bits")]
    td, idd = d["dma"]
    cases.append(("pl_dma", "row_gather_async",
                  lambda: pg.pl_dma(data=d["dma"]),
                  lambda: po.row_gather_async(td, idd, 4096),
                  lambda: po.row_gather_sum_plain(td, idd, 4096), "sum"))
    t5, i5 = d["512k"]
    cases += [
        ("pl_loop_gather", "row_gather",
         lambda: pg2.pl_loop_gather(data=d["512k"]),
         lambda: po.row_gather(t5, i5), lambda: po.row_gather_plain(t5, i5),
         "bits"),
        ("gather2.pl_dg", "row_gather", lambda: pg2.pl_dg(data=d["1m"]),
         lambda: po.row_gather(t1, i1), lambda: po.row_gather_plain(t1, i1),
         "bits")]
    ones5 = torch.ones((i5.numel(), 128), device=_PROBE_DEVICE)
    cases.append(("pl_loop_scatter", "row_scatter_add",
                  lambda: pg2.pl_loop_scatter(data=d["512k"]),
                  lambda: po.row_scatter_add(i5, ones5, 8192),
                  lambda: po.row_scatter_add_plain(i5, ones5, 8192),
                  "count"))
    for label, contract, n_rows, chunk, shape in _DG2_RUNS:
        tt, ii, _ = d[label]
        fn = po.row_gather if contract == "take" else po.row_gather_element
        plain = po.row_gather_plain if contract == "take" \
            else po.row_gather_element_plain
        cases.append((
            f"dyngather2 {label}", "row_gather",
            lambda c=contract, n=n_rows, k=chunk, sh=shape, dd=d[label]:
            dg2.gather(c, n, k, sh, data=dd),
            lambda fn=fn, tt=tt, ii=ii: fn(tt, ii),
            lambda plain=plain, tt=tt, ii=ii: plain(tt, ii), "bits"))
    return cases


def _check_probe_kernels(d):
    """Phase 2 for P1-P4: every Pallas probe's kernel call against its
    plain twin on the card at the JAX probe's default sizes; the sums run
    twice and repeat bit for bit; the element mode also on an index that is
    not broadcast; P1 up to the card's limit, and one KiB past it must
    raise. Returns ``(worst error per kernel, kernel outputs by label)``."""
    import torch
    from elasticdeform_tpu_torch.ops import probes as po
    worst = dict.fromkeys(PROBE_KERNELS, 0.0)
    outs = {}
    limit = po.smem_limit()
    if limit != 227 * 1024:
        raise AssertionError(f"the card allows {limit} bytes of shared "
                             "memory per block, not 227 KiB")
    try:
        po.smem_probe(torch.ones((8, 128), device=_PROBE_DEVICE), 228 * 1024)
    except RuntimeError as e:
        if "CUDA error" not in str(e):
            raise
        print(f"P1 smem_probe at 228 KiB raises as it must: {e}")
    else:
        raise AssertionError("P1 smem_probe ran past the card's limit")
    for label, kernel, _, call, plain, kind in _probe_cases(d):
        got, want = call(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{label}: {tuple(got.shape)} {got.dtype} "
                                 f"vs {tuple(want.shape)} {want.dtype}")
        if kind in ("bits", "count"):
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{label} ({kernel}): not bit-identical to its twin, "
                    f"{int((got != want).sum())} values differ")
        else:
            worst[kernel] = max(worst[kernel], _assert_close(
                got, want, 0.0, 1e-5 * want.double().abs(),
                f"{label} ({kernel})"))
            if kind == "sum" and not torch.equal(got, call()):
                raise AssertionError(f"{label}: the sums did not repeat")
        outs[label] = got
    rs = np.random.RandomState(6)
    table = torch.as_tensor(rs.rand(4096, 128), dtype=torch.float32,
                            device=_PROBE_DEVICE)
    idx2d = torch.as_tensor(rs.randint(0, 4096, (8192, 128)),
                            dtype=torch.int32, device=_PROBE_DEVICE)
    if not torch.equal(po.row_gather_element(table, idx2d),
                       po.row_gather_element_plain(table, idx2d)):
        raise AssertionError("P2 element mode on a random index: differs")
    print(f"P1-P4 vs their plain twins at the JAX probes' default sizes: "
          f"{len(outs)} probes pass (gathers and counts bit for bit, sums "
          f"repeat bit for bit), max abs err {json.dumps(worst)}; the card "
          f"allows {limit} bytes of shared memory per block")
    return worst, outs


def phase_probe_path(d, kernel_outs):
    """The probes' main path: every Pallas probe through the port's public
    functions (``elasticdeform_tpu_torch.probes``) at the JAX probes'
    default sizes, with the launch counters set to 0 just before and read
    just after; each output must equal phase 2's kernel output (the
    atomics' within 1e-5 of the sum of their terms). Returns the launch
    counts."""
    import collections
    import torch
    cases = _probe_cases(d)
    _reset_counts()
    outs = {label: entry() for label, _, entry, *_ in cases}
    torch.cuda.synchronize()
    launches = _counts()
    want = collections.Counter(kernel for _, kernel, *_ in cases)
    print(f"probe path launches: "
          f"{json.dumps({k: launches[k] for k in PROBE_KERNELS})}")
    for k in KERNELS:
        if launches[k] != want.get(k, 0):
            raise AssertionError(f"the probe path launched {k} "
                                 f"{launches[k]} times, not {want.get(k, 0)}")
    for label, kernel, _, _, _, kind in cases:
        got, ref = outs[label], kernel_outs[label]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"probe {label}: non-finite output")
        if kind == "scatter":
            _assert_close(got, ref, 0.0, 1e-5 * ref.double().abs(),
                          f"probe {label}")
        elif not torch.equal(got, ref):
            raise AssertionError(f"probe {label}: the entry point's output "
                                 "differs from the kernel's in phase 2")
    print(f"probe path: {len(cases)} Pallas probes through the public "
          "functions match phase 2's kernel outputs")
    return launches


def _rows_bytes(table, *index_sets):
    """Bytes of the distinct table rows that the index tensors touch."""
    import torch
    rows = torch.unique(torch.cat([i.reshape(-1) for i in index_sets]))
    return rows.numel() * table.shape[1] * table.element_size()


def _times_probes(row, card, d, errs):
    """Phase 4 for the probes: per Pallas probe its kernel, twin and
    library times (calls back to back, :func:`_loop_ms`: one call of the
    small probes takes less device time than the host needs to launch it),
    M rows/s as the JAX probe counts them, and the GB/s of
    the rows it gathered or scattered (an L2 rate where the table fits the
    50 MB L2) beside the bound; then the library-only probes' rates; then
    the kernels' rows of the ``kernels`` line (P1 at smem227, P2 at
    pl_vmem, P3 at scatrate, P4 at pl_dma)."""
    import torch
    import torch.nn.functional as F
    from elasticdeform_tpu_torch.ops import probes as po
    from elasticdeform_tpu_torch.probes import probe_gather as pg
    from elasticdeform_tpu_torch.probes import probe_gather2 as pg2
    cases = {c[0]: c for c in _probe_cases(d)}
    t1, i1 = d["1m"]
    t5, i5 = d["512k"]
    td, idd = d["dma"]
    lt, li = d["dynload"]
    lstarts = po.window_starts(li, 8192, 8)
    lbags = lstarts[None] + torch.arange(8, dtype=torch.int32,
                                         device=_PROBE_DEVICE)[:, None]
    gt, gi = d["dyngather"]
    si, sv = d["dynstore"]
    ci, cv = d["scatrate"]
    ones5 = torch.ones((i5.numel(), 128), device=_PROBE_DEVICE)

    def zeros(n):
        return torch.zeros((n, 128), device=_PROBE_DEVICE)
    # label: (JAX's row count, rows moved, bytes the function needs,
    #         library call or None, table bytes (L2 or HBM))
    spec = {
        "smem227": (1, 0, 2 * 8 * 128 * 4, None, 0),
        "dynload": (65536, 65536 * 8,
                    _rows_bytes(lt, lbags) + li.numel() * 4 + 8 * 512,
                    lambda: F.embedding_bag(lbags, lt, mode="sum"),
                    lt.numel() * 4),
        "dynstore": (65536, 65536, (sv.numel() + si.numel()) * 4
                     + 8192 * 512,
                     lambda: zeros(8192).index_add_(0, si, sv), 8192 * 512),
        "dyngather": (1024, 1024, _rows_bytes(gt, gi) + 1024 * (4 + 512),
                      lambda: torch.index_select(gt, 0, gi), 1024 * 512),
        "scatrate": (1 << 20, 1 << 20, (cv.numel() + ci.numel()) * 4
                     + 40960 * 512,
                     lambda: zeros(40960).index_add_(0, ci, cv),
                     40960 * 512),
        "pl_vmem": (1 << 20, 1 << 20,
                    _rows_bytes(t1, i1) + i1.numel() * 4 + 128 * 512,
                    lambda: F.embedding_bag(i1.view(-1, 8192), t1,
                                            mode="sum"), t1.numel() * 4),
        "pl_dg": (1 << 20, 1 << 20,
                  _rows_bytes(t1, i1[-8192:]) + 8192 * 4 + 8192 * 512,
                  lambda: torch.index_select(t1, 0, i1[-8192:]),
                  t1.numel() * 4),
        "pl_dma": (1 << 18, 1 << 18,
                   _rows_bytes(td, idd) + idd.numel() * 4 + 64 * 512,
                   lambda: F.embedding_bag(idd.view(-1, 4096), td,
                                           mode="sum"), td.numel() * 4),
        "pl_loop_gather": (1 << 19, 1 << 19,
                           _rows_bytes(t5, i5) + i5.numel() * (4 + 512),
                           lambda: torch.index_select(t5, 0, i5),
                           t5.numel() * 4),
        "gather2.pl_dg": (1 << 20, 1 << 20,
                          _rows_bytes(t1, i1) + i1.numel() * (4 + 512),
                          lambda: torch.index_select(t1, 0, i1),
                          t1.numel() * 4),
        "pl_loop_scatter": (1 << 19, 1 << 19, (ones5.numel() + i5.numel())
                            * 4 + 8192 * 512,
                            lambda: zeros(8192).index_add_(0, i5, ones5),
                            8192 * 512)}
    for label, _, n_rows, chunk, shape in _DG2_RUNS:
        tt, ii, i1d = d[label]
        lib = (lambda tt=tt, ii=ii: torch.index_select(tt, 0, ii)) \
            if shape is None else \
            (lambda tt=tt, i64=ii.long(): torch.gather(tt, 0, i64))
        spec[f"dyngather2 {label}"] = (
            chunk, chunk, _rows_bytes(tt, i1d) + ii.numel() * 4
            + chunk * 512, lib, tt.numel() * 4)
    times = {}
    for label, (n_jax, moved, nbytes, lib, tbytes) in spec.items():
        _, kernel, _, call, plain, _ = cases[label]
        ms = _loop_ms(call)
        plain_ms = _loop_ms(plain, n=5, warmup=1)
        lib_ms = None if lib is None else _loop_ms(lib)
        bound = _bound(nbytes, 0)
        where = "L2" if tbytes < 50e6 else "HBM"
        rate = (f"{n_jax / ms / 1e3:.1f} M rows/s, "
                f"{moved * 512 / ms / 1e6:.1f} GB/s of rows ({where} table)"
                if moved else "a launch")
        lib_s = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"probe {label} ({kernel}): {ms:.4f} ms, {rate}; bound "
              f"{bound[0]:.4f} ms by bytes ({nbytes} B); plain "
              f"{plain_ms:.4f} ms, library {lib_s} [{card}]")
        times[label] = (ms, plain_ms, lib_ms, bound, moved)
    # the library-only probes of the same files
    gen = torch.Generator(device=_PROBE_DEVICE).manual_seed(0)
    idx_x = torch.randint(0, td.shape[0], (1 << 20,), generator=gen,
                          device=_PROBE_DEVICE, dtype=torch.int32)
    idx_s = torch.randint(0, 65536, (64, 262144), generator=gen,
                          device=_PROBE_DEVICE, dtype=torch.int32)
    for label, fn, n in (
            ("xla", lambda: pg.xla(data=(td, idx_x)), 1 << 20),
            ("xla_small", lambda: pg.xla_small(data=d["1m"]), 1 << 20),
            ("onehot", lambda: pg.onehot(data=d["onehot"]), 1 << 20),
            ("xla_map_sample", lambda: pg2.xla_map_sample(data=(td, idx_s)),
             64 * 262144)):
        ms = _loop_ms(fn, n=5, warmup=1)
        print(f"library probe {label}: {ms:.4f} ms, {n / ms / 1e3:.1f} M "
              f"rows/s, {n * 512 / ms / 1e6:.1f} GB/s of rows [{card}]")
    for kernel, label, replaces in (
            ("smem_probe", "smem227", "tools/probe_pallas.py:50"),
            ("row_gather", "pl_vmem", "tools/probe_gather.py:91"),
            ("row_scatter_add", "scatrate", "tools/probe_pallas.py:188"),
            ("row_gather_async", "pl_dma", "tools/probe_gather.py:179")):
        ms, plain_ms, lib_ms, bound, moved = times[label]
        extra = {"rows_gb_per_s": moved * 512 / ms / 1e6} if moved else {}
        if kernel == "row_gather":
            extra.update({f"{k}_ms": times[k][0] for k in (
                "dynload", "dyngather", "pl_dg", "pl_loop_gather",
                "gather2.pl_dg")})
        row(kernel, "probes.cu", replaces, ms, plain_ms, bound, lib_ms,
            errs.get(kernel, 0.0), at=label, extra=extra)



def _k1_ops(B, n_out, naxis, order, C):
    """Operations of one K1 or K3 call: per voxel, about 40 per axis for
    the coordinate, fold and weights, and per tap one weight product plus a
    multiply-add per channel."""
    return B * n_out * ((order + 1) ** naxis * (1 + 2 * C) + 40 * naxis)


def _k5_ops(B, n_out, naxis, order, C):
    """The fewest operations K5's function needs (not the kernel's own tap
    loop): per voxel, about 60 per axis for the coordinate, fold, weights
    and their derivatives; the channels folded into one value per tap
    (``sum_c g_c coeff_c``, nothing to fold for one channel, whose ``g``
    multiplies the naxis results instead); then the taps contracted axis by
    axis. Contracting the m-th axis, each of the m+1 partial sums so far
    (none or one derivative weight) goes on with ``w``, the one with none
    also with ``w'``: 2 operations per tap left, for m+1 outputs (naxis at
    the last axis, where the sum with no derivative is not needed)."""
    k = order + 1
    taps = k ** naxis
    fold = taps * (2 * C - 1) if C > 1 else naxis
    contract = sum((m + 1 if m < naxis else naxis) * 2 * k ** (naxis - m + 1)
                   for m in range(1, naxis + 1))
    return B * n_out * (60 * naxis + fold + contract)


def _select_comparisons(k, rank):
    """The comparisons a selection of the ``rank``-th smallest (from 0) of
    ``k`` values takes: the expected count of Hoare's quickselect (Knuth),
    2((k+1)H(k) - (k+2-rank)H(k-rank) - (rank+3)H(rank+1) + k + 3), about
    3.4 k for a median. Either K12 route computes this function."""
    def h(n):
        return sum(1.0 / i for i in range(1, n + 1))
    return 2.0 * ((k + 1) * h(k) - (k + 2 - rank) * h(k - rank)
                  - (rank + 3) * h(rank + 1) + k + 3)


def _bound(nbytes, ops, flops=FP32_FLOPS):
    """(bound ms, what bounds it) on the H100 SXM peaks (``flops``: the
    rate of the operations' type)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _grid_sample_yardstick(coeffs, coords, g, fwd, bwd, grad, label, at,
                           card):
    """Time the order-1, nearest-mode calls ``fwd``/``bwd``/``grad`` of a
    resample kernel and ``grid_sample``'s forward and its two backward
    halves (``grid_sampler_3d_backward`` with one output each) on the same
    inputs: ``coeffs`` ``(B, D, H, W, C)``, ``coords`` ``(B, 3, D, H, W)``,
    ``g`` like ``coeffs``. Returns ``{part: (kernel ms, library ms)}``."""
    import torch
    import torch.nn.functional as F
    spatial = coeffs.shape[1:-1]
    inp = coeffs.movedim(-1, 1).contiguous()
    grid = torch.stack([coords[:, h] * (2.0 / (spatial[h] - 1)) - 1.0
                        for h in (2, 1, 0)], -1).contiguous()
    gy = g.movedim(-1, 1).contiguous()

    def lib_fwd():
        return F.grid_sample(inp, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    def lib_bwd(mask):
        return lambda: torch.ops.aten.grid_sampler_3d_backward(
            gy, inp, grid, 0, 1, True, mask)

    diff = float((lib_fwd().movedim(1, -1) - fwd()).abs().max())
    out = {"fwd": (_time_ms(fwd), _time_ms(lib_fwd)),
           "bwd": (_time_ms(bwd), _time_ms(lib_bwd([True, False]))),
           "grad": (_time_ms(grad), _time_ms(lib_bwd([False, True])))}
    print(f"{label} at order 1, nearest, {at} shapes, kernel vs grid_sample "
          f"ms: forward {out['fwd'][0]:.4f} vs {out['fwd'][1]:.4f}, "
          f"transpose {out['bwd'][0]:.4f} vs {out['bwd'][1]:.4f}, "
          f"coordinate gradient {out['grad'][0]:.4f} vs "
          f"{out['grad'][1]:.4f}; forward outputs differ by {diff:.3e} "
          f"[{card}]")
    return out


def _times_resampler(row, card):
    """Phase 4 for the general resampler: K1c, K3c and K5c at the c7 shapes
    (order 1, nearest) beside grid_sample; K6 and K7 at the c8 shapes
    beside the tensordot with filter_matrix_bc; K1c and K3c at the c8
    shapes (order 3, on the ring-padded array)."""
    import torch
    from elasticdeform_tpu_torch.ops import prefilter as pf
    from elasticdeform_tpu_torch.ops import resample as rsm
    from elasticdeform_tpu_torch.ops import resample_bwd as rb
    dev = torch.device("cuda")
    rs = np.random.RandomState(7)
    S, B, naxis = (160, 192, 224), 4, 3
    n_out = math.prod(S)
    x = torch.as_tensor(rs.rand(B, *S, 1).astype(np.float32), device=dev)
    g = torch.as_tensor(rs.randn(B, *S, 1).astype(np.float32), device=dev)
    iota = torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=dev) for n in S],
        indexing="ij"))
    coords = (iota + torch.as_tensor(_smooth_field(rs, B, S, 4.0),
                                     device=dev)).contiguous()
    del iota
    a = (1, 0)
    o1 = _grid_sample_yardstick(
        x, coords, g, lambda: rsm.resample_coords(x, coords, *a, 0.0),
        lambda: rb.resample_coords_transpose(g, coords, *a, S),
        lambda: rb.resample_coords_grad(x, g, coords, *a), "K1c/K3c/K5c",
        "c7", card)
    vox = B * n_out
    row("resample_coords_fwd", "resample.cu",
        "elasticdeform_tpu/ops/deform.py:533", o1["fwd"][0],
        _time_ms(lambda: rsm.resample_coords_plain(x, coords, *a, 0.0),
                 reps=3, warmup=1),
        _bound(vox * (1 + naxis + 1) * 4, _k1_ops(B, n_out, naxis, 1, 1)),
        o1["fwd"][1], 0.0, at="c7")
    k3c_err = _assert_close(
        rb.resample_coords_transpose(g, coords, *a, S),
        rb.resample_coords_transpose_plain(g, coords, *a, S), 1e-5,
        1e-5 * rb.resample_coords_transpose_plain(
            g.abs(), coords, *a, S).double(), "K3c at c7 shapes")
    row("resample_coords_bwd", "resample_bwd.cu",
        "elasticdeform_tpu/ops/deform.py:608", o1["bwd"][0],
        _time_ms(lambda: rb.resample_coords_transpose_plain(g, coords, *a, S),
                 reps=3, warmup=1),
        _bound(vox * (1 + naxis + 1) * 4, _k1_ops(B, n_out, naxis, 1, 1)),
        o1["bwd"][1], k3c_err, at="c7")
    row("resample_coords_grad", "resample_bwd.cu",
        "elasticdeform_tpu/ops/windows.py:1247", o1["grad"][0],
        _time_ms(lambda: rb.resample_coords_grad_plain(x, g, coords, *a),
                 reps=3, warmup=1),
        _bound(vox * (1 + 1 + 2 * naxis) * 4,
               _k5_ops(B, n_out, naxis, 1, 1)),
        o1["grad"][1], 0.0, at="c7")
    del x, g, coords

    # K6 and K7 along the three axes of c8's volume, reflect
    v = torch.as_tensor(rs.rand(1, *S).astype(np.float32), device=dev)
    order, numel = 3, math.prod(S)
    mats = [torch.as_tensor(pf.filter_matrix_bc(n, order, "reflect"),
                            dtype=v.dtype, device=dev) for n in S]
    t_mats = [m.t().contiguous() for m in mats][::-1]

    def chain(fn, axes, lib_mats=None):
        def run():
            y = v
            for i, ax in enumerate(axes):
                y = fn(y, order, ax, "reflect") if lib_mats is None else \
                    torch.movedim(torch.tensordot(lib_mats[i], y,
                                                  dims=([1], [ax])), 0, ax)
            return y
        return run

    bound = _bound(3 * 2 * numel * 4,
                   3 * numel * (1 + 9 * len(pf.spline_poles(order))))
    scale = float(v.abs().max())
    for name, fn, plain, axes, lib_mats, replaces in (
            ("spline_prefilter_bc", pf.spline_filter1d_bc,
             pf.spline_filter1d_bc_plain, (1, 2, 3), mats,
             "elasticdeform_tpu/ops/prefilter.py:150"),
            ("spline_prefilter_bc_transpose",
             pf.spline_filter1d_bc_transpose,
             pf.spline_filter1d_bc_transpose_plain, (3, 2, 1), t_mats,
             "elasticdeform_tpu/ops/prefilter.py:177")):
        err = _assert_close(chain(fn, axes)(), chain(plain, axes)(),
                            *_tol(torch.float32, scale),
                            f"{name} at c8 shapes")
        per_axis = [_time_ms(lambda ax=ax: fn(v, order, ax, "reflect"))
                    for ax in (1, 2, 3)]
        print(f"{name} per-axis ms at (1, 160, 192, 224) f32, axes 1/2/3: "
              f"{per_axis} [{card}]")
        row(name, "prefilter.cu", replaces, _time_ms(chain(fn, axes)),
            _time_ms(chain(plain, axes)), bound,
            _time_ms(chain(None, axes, lib_mats)), err, at="c8")

    # K1c and K3c as c8 runs them: order 3, nearest, on the ring-padded
    # (6 each side) coefficients at the rotated, zoomed, reflect-folded
    # coordinates
    M, off = _c8_affine(S)
    P = tuple(n + 12 for n in S)
    coeffs = torch.as_tensor(rs.rand(1, *P, 1).astype(np.float32),
                             device=dev)
    gy = torch.as_tensor(rs.randn(1, *S, 1).astype(np.float32), device=dev)
    j = np.stack(np.meshgrid(*[np.arange(n) for n in S], indexing="ij"))
    cc = np.tensordot(M, j, axes=1) + off.reshape(3, 1, 1, 1)
    cc = np.stack([np.where(np.mod(c, 2 * n) >= n, 2 * n - 1 - np.mod(
        c, 2 * n), np.mod(c, 2 * n)) for c, n in zip(cc, S)]) + 6
    c8c = torch.as_tensor(cc[None].astype(np.float32), device=dev)
    k1 = _time_ms(lambda: rsm.resample_coords(coeffs, c8c, 3, 0, 0.0))
    k3 = _time_ms(lambda: rb.resample_coords_transpose(gy, c8c, 3, 0, P))
    b1 = _bound((math.prod(P) + 4 * numel) * 4, _k1_ops(1, numel, 3, 3, 1))
    b3 = _bound((4 * numel + math.prod(P)) * 4, _k1_ops(1, numel, 3, 3, 1))
    print(f"resample_coords_fwd at c8 shapes (order 3): {k1:.4f} ms, bound "
          f"{b1[0]:.4f} ms by {b1[1]}; resample_coords_bwd: {k3:.4f} ms, "
          f"bound {b3[0]:.4f} ms by {b3[1]} [{card}]")


def _times_filters(row, card):
    """Phase 4 for the filter tier: K8 and K8T along the three spatial axes
    of c11's field (sigma 2, 17 taps, reflect) beside the JAX package's
    formulation (a banded-matrix ``tensordot`` per axis, the library time)
    and ``conv3d`` with an (L,1,1), (1,L,1), (1,1,L) kernel under zero
    padding; K8 in float64 on the paired route at c13's shapes; K9 and K9T
    at c14's shapes (5^3 kernel, constant) beside ``conv3d`` and
    ``conv_transpose3d`` (zero padding). cuDNN's TF32 is off for the
    yardsticks."""
    import torch
    import torch.nn.functional as F
    from elasticdeform_tpu_torch.ops import filters as ft
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rs = np.random.RandomState(11)
    S = (160, 192, 224)
    f = torch.as_tensor(rs.rand(3, *S).astype(np.float32), device=dev)
    numel = f.numel()
    w = ft.gaussian_weights(2.0, 0, 4.0, None)
    L, c = len(w), len(w) // 2
    mats = {a: torch.as_tensor(ft.gaussian_filter1d_matrix(
        S[a - 1], 2.0, 0, "reflect", 4.0, None)[0], dtype=f.dtype,
        device=dev) for a in (1, 2, 3)}

    def chain(fn, axes):
        def run():
            y = f
            for a in axes:
                y = fn(y, a)
            return y
        return run

    def k8(y, a):
        return ft.correlate1d(y, w, a, "reflect", 0.0, c)

    def k8t(y, a):
        return ft.correlate1d_transpose(y, w, a, "reflect", c)

    def mat(y, a, t=False):
        m = mats[a].t() if t else mats[a]
        return torch.movedim(torch.tensordot(m, y, dims=([1], [a])), 0, a)

    wt = torch.as_tensor(w, dtype=f.dtype, device=dev)
    conv_w = [wt.view(1, 1, L, 1, 1), wt.view(1, 1, 1, L, 1),
              wt.view(1, 1, 1, 1, L)]
    pads = [(c, 0, 0), (0, c, 0), (0, 0, c)]

    def conv_chain():
        y = f[:, None]
        for k, p in zip(conv_w, pads):
            y = F.conv3d(y, k, padding=p)
        return y[:, 0]

    bound = _bound(3 * 2 * numel * 4, 3 * numel * 2 * L)
    scale = float(f.abs().max())
    err = _assert_close(chain(k8, (1, 2, 3))(),
                        chain(lambda y, a: ft.correlate1d_plain(
                            y, w, a, "reflect", 0.0, c), (1, 2, 3))(),
                        *_tol(torch.float32, scale), "K8 at c11 shapes")
    per_axis = [_time_ms(lambda a=a: k8(f, a)) for a in (1, 2, 3)]
    conv_ms = _time_ms(conv_chain)
    print(f"correlate1d per-axis ms at (3, 160, 192, 224) f32, 17 taps, "
          f"axes 1/2/3: {per_axis}; conv3d (zero padding) chain "
          f"{conv_ms:.4f} ms [{card}]")
    row("correlate1d", "filters.cu", "elasticdeform_tpu/ops/filters.py:125",
        _time_ms(chain(k8, (1, 2, 3))),
        _time_ms(chain(lambda y, a: ft.correlate1d_plain(
            y, w, a, "reflect", 0.0, c), (1, 2, 3))), bound,
        _time_ms(chain(mat, (1, 2, 3))), err, at="c11",
        extra={"conv3d_ms": conv_ms, "axis_ms": per_axis})
    g = f
    terms = chain(lambda y, a: ft.correlate1d_transpose_plain(
        y.abs(), np.abs(w), a, "reflect", c), (3, 2, 1))()
    err = _assert_close(chain(k8t, (3, 2, 1))(),
                        chain(lambda y, a: ft.correlate1d_transpose_plain(
                            y, w, a, "reflect", c), (3, 2, 1))(),
                        *_terms_tol(torch.float32, terms),
                        "K8T at c11 shapes")
    del terms
    per_axis = [_time_ms(lambda a=a: k8t(g, a)) for a in (1, 2, 3)]
    print(f"correlate1d_transpose per-axis ms at c11 shapes, axes 1/2/3: "
          f"{per_axis} [{card}]")
    row("correlate1d_transpose", "filters.cu",
        "elasticdeform_tpu/ops/filters.py:125",
        _time_ms(chain(k8t, (3, 2, 1))),
        _time_ms(chain(lambda y, a: ft.correlate1d_transpose_plain(
            y, w, a, "reflect", c), (3, 2, 1))), bound,
        _time_ms(chain(lambda y, a: mat(y, a, True), (3, 2, 1))), err,
        at="c11", extra={"axis_ms": per_axis})
    del f, g, mats

    # K8 on c13's paired route: float64, sigma 1 (9 taps), mirror
    v = torch.as_tensor(rs.randint(-1024, 3072, (512, 512, 300)),
                        dtype=torch.float64, device=dev)
    w1 = ft.gaussian_weights(1.0, 0, 4.0, None)
    k13 = [_time_ms(lambda a=a: ft.correlate1d(v, w1, a, "mirror", 0.0, 4, 1))
           for a in (0, 1, 2)]
    b13 = _bound(2 * v.numel() * 8, v.numel() * 2 * len(w1), FP64_FLOPS)
    print(f"correlate1d float64 paired route at (512, 512, 300), 9 taps, "
          f"per-axis ms 0/1/2: {k13}; bound per axis {b13[0]:.4f} ms by "
          f"{b13[1]} [{card}]")
    del v

    # K9 and K9T at c14's shapes
    x = torch.as_tensor(rs.rand(*S).astype(np.float32), device=dev)
    w5 = rs.randn(5, 5, 5)
    cen = (3, 2, 1)                     # origin (1, 0, -1)
    w5t = torch.as_tensor(w5, dtype=x.dtype, device=dev)[None, None]
    n9 = x.numel()
    bound9 = _bound(2 * n9 * 4, n9 * 2 * 125)
    scale = float(x.abs().max()) * float(np.abs(w5).sum())
    err = _assert_close(ft.correlate_nd(x, w5, cen, "constant", 0.5),
                        ft.correlate_nd_plain(x, w5, cen, "constant", 0.5),
                        *_tol(torch.float32, scale), "K9 at c14 shapes")
    row("correlate_nd", "filters.cu", "elasticdeform_tpu/ops/filters.py:317",
        _time_ms(lambda: ft.correlate_nd(x, w5, cen, "constant", 0.5)),
        _time_ms(lambda: ft.correlate_nd_plain(x, w5, cen, "constant", 0.5)),
        bound9, _time_ms(lambda: F.conv3d(x[None, None], w5t, padding=2)),
        err, at="c14")
    terms = ft.correlate_nd_transpose_plain(x.abs(), np.abs(w5), cen,
                                            "constant")
    err = _assert_close(ft.correlate_nd_transpose(x, w5, cen, "constant"),
                        ft.correlate_nd_transpose_plain(x, w5, cen,
                                                        "constant"),
                        *_terms_tol(torch.float32, terms), "K9T at c14 shapes")
    del terms
    row("correlate_nd_transpose", "filters.cu",
        "elasticdeform_tpu/ops/filters.py:317",
        _time_ms(lambda: ft.correlate_nd_transpose(x, w5, cen, "constant")),
        _time_ms(lambda: ft.correlate_nd_transpose_plain(x, w5, cen,
                                                         "constant")),
        bound9,
        _time_ms(lambda: F.conv_transpose3d(x[None, None], w5t, padding=2)),
        err, at="c14")


def _times_morphology(row, card):
    """Phase 4 for the morphology tier: K10 as the three passes of c16's
    5^3 dilation (int16, 512x512x300) beside ``max_pool3d`` (stride 1) on the
    reflect-padded float32 volume; K11 as the ball erosion of c16's
    top-hat, and its non-flat 3^3 float64 route; K12 at c15's shapes on its
    three filters (network 27 and 33 taps, select 125); K13 as one 3^3
    erosion sweep of c17's mask beside ``max_pool3d`` with a 3^3 window, and
    c17's hole filling per sweep. Every kernel is held to its twin bit for
    bit at these shapes."""
    import torch
    import torch.nn.functional as F
    from elasticdeform_tpu_torch.ops import filters as ft
    from elasticdeform_tpu_torch.ops import morphology as mo
    dev = torch.device("cuda")
    rs = np.random.RandomState(13)

    v = torch.as_tensor(rs.randint(-1024, 3072, (512, 512, 300)).astype(
        np.int16), device=dev)
    numel = v.numel()

    def dilate(fn):
        def run():
            y = v
            for a in (0, 1, 2):
                y = fn(y, 5, a, "reflect", 0, 2, False)
            return y
        return run

    _same(dilate(mo.min_max_filter1d)(), dilate(mo.min_max_filter1d_plain)(),
          "K10 at c16 shapes")
    vp = v.float()
    for a in (0, 1, 2):
        vp = ft.pad_axis(vp, a, 2, 2, "reflect", 0.0)
    vp = vp[None, None].contiguous()
    per_axis = [_time_ms(lambda a=a: mo.min_max_filter1d(
        v, 5, a, "reflect", 0, 2, False)) for a in (0, 1, 2)]
    print(f"min_max_filter1d per-axis ms at (512, 512, 300) int16, size 5: "
          f"{per_axis} [{card}]")
    row("min_max_filter1d", "morphology.cu",
        "elasticdeform_tpu/ops/morphology.py:119",
        _time_ms(dilate(mo.min_max_filter1d)),
        _time_ms(dilate(mo.min_max_filter1d_plain)),
        _bound(3 * 2 * numel * 2, 3 * numel * 4),
        _time_ms(lambda: F.max_pool3d(vp, 5, stride=1)), 0.0, at="c16",
        extra={"axis_ms": per_axis})
    del vp

    ball = _ball(2)
    cen = [2, 2, 2]
    _same(mo.min_max_filter(v, ball, None, cen, "reflect", 0, True),
          mo.min_max_filter_plain(v, ball, None, cen, "reflect", 0, True),
          "K11 at c16 shapes")
    g3 = np.indices((3, 3, 3)) - 1
    s3 = -30.0 * (g3 ** 2).sum(0)
    ones3 = np.ones((3, 3, 3), dtype=bool)
    nonflat = _time_ms(lambda: mo.min_max_filter(
        v, ones3, s3, [1, 1, 1], "reflect", 0.0, False))
    print(f"min_max_filter non-flat 3^3 (float64 work, saturating cast) at "
          f"c16 shapes: {nonflat:.4f} ms [{card}]")
    row("min_max_filter", "morphology.cu",
        "elasticdeform_tpu/ops/morphology.py:196",
        _time_ms(lambda: mo.min_max_filter(v, ball, None, cen, "reflect", 0,
                                           True)),
        _time_ms(lambda: mo.min_max_filter_plain(v, ball, None, cen,
                                                 "reflect", 0, True)),
        _bound(2 * numel * 2, numel * int(ball.sum())), None, 0.0, at="c16",
        extra={"nonflat_ms": nonflat})
    del v

    S = (160, 192, 224)
    x = torch.as_tensor(_mri_like(rs, S), device=dev)
    numel = x.numel()
    routes = {}
    for label, fp, rank in (("median3", np.ones((3, 3, 3), bool), 13),
                            ("median5", np.ones((5, 5, 5), bool), 62),
                            ("percentile20_ball2", ball, 6)):
        c = [k // 2 for k in fp.shape]
        k = int(fp.sum())
        args = (x, fp, c, "reflect", 0.0, rank)
        _same(mo.rank_filter(*args), mo.rank_filter_plain(*args),
              f"K12 {label} at c15 shapes")
        routes[label] = (_time_ms(lambda a=args: mo.rank_filter(*a)),
                         _time_ms(lambda a=args: mo.rank_filter_plain(*a),
                                  reps=3, warmup=1),
                         _bound(2 * numel * 4,
                                numel * _select_comparisons(k, rank)), k)
        ms, plain, b, _ = routes[label]
        print(f"rank_filter {label} ({k} taps, rank {rank}) at c15 shapes: "
              f"{ms:.4f} ms (plain {plain:.4f} ms, bound {b[0]:.4f} ms by "
              f"{b[1]}) [{card}]")
    ms, plain, b, _ = routes["median3"]
    row("rank_filter", "morphology.cu",
        "elasticdeform_tpu/ops/morphology.py:302", ms, plain, b, None, 0.0,
        at="c15", extra={label: {"ms": r[0], "plain_ms": r[1],
                                 "bound_ms": r[2][0], "taps": r[3]}
                         for label, r in routes.items()})
    del x

    m, _ = _segmentation(rs, S)
    m = torch.as_tensor(m, device=dev)
    numel = m.numel()
    cen = [1, 1, 1]
    _same(mo.binary_step(m, ones3, cen, False, False),
          mo.binary_step_plain(m, ones3, cen, False, False),
          "K13 at c17 shapes")
    mf = m.float()[None, None]
    before = mo.binary_step.launches
    fill_ms = _time_ms(lambda: mo.binary_erosion_dilation(
        torch.zeros_like(m), None, -1, ~m, 1, 0, True), reps=3, warmup=1)
    sweeps = (mo.binary_step.launches - before) // 4
    print(f"binary_step fill_holes at c17 shapes: {sweeps} sweeps, "
          f"{fill_ms:.4f} ms, {fill_ms / sweeps:.4f} ms per sweep [{card}]")
    row("binary_step", "morphology.cu",
        "elasticdeform_tpu/ops/morphology.py:452",
        _time_ms(lambda: mo.binary_step(m, ones3, cen, False, False)),
        _time_ms(lambda: mo.binary_step_plain(m, ones3, cen, False, False)),
        _bound(2 * numel, numel * 27),
        _time_ms(lambda: F.max_pool3d(mf, 3, stride=1, padding=1)), 0.0,
        at="c17", extra={"fill_holes_sweeps": sweeps,
                         "fill_holes_ms": fill_ms,
                         "fill_holes_ms_per_sweep": fill_ms / sweeps})


def phase_times(card, total_launches, errs, probe_data):
    """Phase 4: kernel, plain and library times at the c5 shapes (and the
    other tiers' shapes, the probes' default sizes), and the configs'
    throughput."""
    import torch
    from elasticdeform_tpu_torch.ops import prefilter as pf
    from elasticdeform_tpu_torch.ops import resample as rsm
    from elasticdeform_tpu_torch.ops import resample_bwd as rb
    from elasticdeform_tpu_torch.ops.displacement import dense_displacement
    dev = torch.device("cuda")
    rs = np.random.RandomState(5)
    B, S, C, order = 64, (64, 64, 64), 1, 3
    x = torch.as_tensor(rs.rand(B, *S, C).astype(np.float32), device=dev)
    gy = torch.as_tensor(rs.rand(B, *S, C).astype(np.float32), device=dev)
    grid = torch.as_tensor((rs.randn(B, 3, 3, 3, 3) * 6).astype(np.float32),
                           device=dev)
    displ = dense_displacement(grid, S, S, (0, 0, 0))
    save = {w: w.launches for ws in _wrappers().values() for w in ws}
    numel = x.numel()
    n_out = math.prod(S)
    rows = []

    def row(name, source, replaces, ms, plain_ms, bound, library_ms, err,
            at="c5", extra=None):
        rows.append({"name": name, "route": "cuda",
                     "source": f"elasticdeform_tpu_torch/csrc/{source}",
                     "replaces": replaces,
                     "launches": total_launches[name],
                     "max_abs_err": max(err, errs[name]), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "library_ms": library_ms,
                     "shapes": at, **(extra or {})})
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"{name} at {at} shapes: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"library {lib}, bound {bound[0]:.4f} ms by {bound[1]}) "
              f"{extra or ''} [{card}]")

    def per_axis(fn, axes):
        return [_time_ms(lambda a=a: fn(x, order, a)) for a in axes]

    def chain(fn, axes, mats=None):
        def run():
            y = x
            for i, a in enumerate(axes):
                y = fn(y, order, a) if mats is None else torch.movedim(
                    torch.tensordot(mats[i], y, dims=([1], [a])), 0, a)
            return y
        return run

    # K2 and K4: one launch per deformed axis, K4 in reverse axis order
    fwd_mats = [torch.as_tensor(pf.filter_matrix(n, order), dtype=x.dtype,
                                device=dev) for n in S]
    k2_err = _assert_close(chain(pf.spline_filter1d, (1, 2, 3))(),
                           chain(pf.spline_filter1d_plain, (1, 2, 3))(),
                           *_tol(torch.float32, float(x.abs().max())),
                           "K2 at c5 shapes")
    print(f"spline_prefilter per-axis ms at (64, 64, 64, 64, 1) f32, axes "
          f"1/2/3: {per_axis(pf.spline_filter1d, (1, 2, 3))} [{card}]")
    filter_bound = _bound(3 * 2 * numel * 4,
                          3 * numel * (1 + 4 * len(pf.spline_poles(order))))
    row("spline_prefilter", "prefilter.cu",
        "elasticdeform_tpu/ops/prefilter.py:333",
        _time_ms(chain(pf.spline_filter1d, (1, 2, 3))),
        _time_ms(chain(pf.spline_filter1d_plain, (1, 2, 3))), filter_bound,
        _time_ms(chain(None, (1, 2, 3), fwd_mats)), k2_err)
    coeffs = chain(pf.spline_filter1d, (1, 2, 3))()

    # (the transposed matrices in the order the axes are applied, 3, 2, 1)
    t_mats = [torch.as_tensor(pf.filter_matrix(n, order).T.copy(),
                              dtype=x.dtype, device=dev) for n in S][::-1]
    tr = pf.spline_filter1d_transpose
    k4_err = _assert_close(
        chain(tr, (3, 2, 1))(),
        chain(pf.spline_filter1d_transpose_plain, (3, 2, 1))(),
        *_tol(torch.float32, float(x.abs().max())), "K4 at c5 shapes")
    print(f"spline_prefilter_transpose per-axis ms at (64, 64, 64, 64, 1) "
          f"f32, axes 1/2/3: {per_axis(tr, (1, 2, 3))} [{card}]")
    row("spline_prefilter_transpose", "prefilter.cu",
        "elasticdeform_tpu/ops/prefilter.py:376",
        _time_ms(chain(tr, (3, 2, 1))),
        _time_ms(chain(pf.spline_filter1d_transpose_plain, (3, 2, 1))),
        filter_bound, _time_ms(chain(None, (3, 2, 1), t_mats)), k4_err)

    # K1, K3 and K5 at order 1, nearest, beside grid_sample (bilinear,
    # border, align_corners), which computes that function in one call;
    # orders >= 2 have none (bicubic grid_sample is Keys' kernel, not a
    # B-spline)
    iota = torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=dev) for n in S],
        indexing="ij"))
    a1 = (displ, None, (0, 0, 0), 1, 0)
    o1 = _grid_sample_yardstick(
        x, iota + displ, gy, lambda: rsm.resample(x, *a1, 0.0),
        lambda: rb.resample_transpose(gy, *a1, S),
        lambda: rb.resample_coord_grad(x, gy, *a1), "K1/K3/K5", "c5", card)

    # K1: resample of the prefiltered batch at its dense displacement
    args = (displ, None, (0, 0, 0), order, 3)
    k1_err = _assert_close(rsm.resample(coeffs, *args, 0.0),
                           rsm.resample_plain(coeffs, *args, 0.0),
                           *_tol(torch.float32, 1.0), "K1 at c5 shapes")
    row("resample_fwd", "resample.cu", "elasticdeform_tpu/ops/resample.py:66",
        _time_ms(lambda: rsm.resample(coeffs, *args, 0.0)),
        _time_ms(lambda: rsm.resample_plain(coeffs, *args, 0.0), warmup=1),
        _bound((numel + 3 * B * n_out + B * n_out * C) * 4,
               _k1_ops(B, n_out, 3, order, C)), o1["fwd"][1], k1_err,
        extra={"order1_ms": o1["fwd"][0],
               # the narrow table: the coefficients read as bfloat16
               "bf16_table_ms": _time_ms(lambda: rsm.resample(
                   coeffs, *args, 0.0, torch.bfloat16))})

    # K3: the scatter of gy back onto the coefficients (reads gy and the
    # displacement, writes d_coeffs once; the zero fill that its atomics
    # need is the design's cost, not the function's)
    k3_err = _check_k3(rb, gy, args, S, torch.float32, "K3 at c5 shapes")
    k3_ms = _time_ms(lambda: rb.resample_transpose(gy, *args, S))
    k3_bytes = (B * n_out * (C + 3) + numel) * 4
    row("resample_bwd", "resample_bwd.cu",
        "elasticdeform_tpu/ops/windows.py:1354", k3_ms,
        _time_ms(lambda: rb.resample_transpose_plain(gy, *args, S),
                 warmup=1),
        _bound(k3_bytes, _k1_ops(B, n_out, 3, order, C)), o1["bwd"][1],
        k3_err, extra={"order1_ms": o1["bwd"][0]})
    adds = B * n_out * (order + 1) ** 3 * C
    print(f"resample_bwd scatter-add rate at c5 shapes: {adds} atomic adds "
          f"in {k3_ms:.4f} ms = {adds / k3_ms / 1e6:.2f} G adds/s, "
          f"{k3_bytes / k3_ms / 1e6:.2f} GB/s of compulsory bytes [{card}]")

    # K5: the gradient with respect to the dense displacement
    k5_err = _assert_close(
        rb.resample_coord_grad(coeffs, gy, *args),
        rb.resample_coord_grad_plain(coeffs, gy, *args),
        *_tol(torch.float32, _k5_scale(coeffs, gy)), "K5 at c5 shapes")
    row("resample_coord_grad", "resample_bwd.cu",
        "elasticdeform_tpu/ops/windows.py:1247",
        _time_ms(lambda: rb.resample_coord_grad(coeffs, gy, *args)),
        _time_ms(lambda: rb.resample_coord_grad_plain(coeffs, gy, *args),
                 reps=3, warmup=1),
        _bound((numel + B * n_out * C + 2 * 3 * B * n_out) * 4,
               _k5_ops(B, n_out, 3, order, C)), o1["grad"][1], k5_err,
        extra={"order1_ms": o1["grad"][0]})
    del x, gy, coeffs, displ, iota
    _times_resampler(row, card)
    _times_filters(row, card)
    _times_morphology(row, card)
    _times_probes(row, card, probe_data, errs)
    for w, v in save.items():
        w.launches = v

    for cfg in _configs():
        ms = _time_ms(lambda run=cfg.run: run("cuda"))
        print(f"{cfg.name}: {ms:.3f} ms per call, "
              f"{cfg.n_vox / ms / 1e3:.2f} Mvox/s (output voxels) [{card}]")
    order_of = {k: i for i, k in enumerate(KERNELS)}
    return sorted(rows, key=lambda r: order_of[r["name"]])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import elasticdeform_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the package is missing ({e}); run from the "
              "root of the repository", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    errs = phase_kernels()
    probe_data = _probe_data()
    probe_errs, probe_outs = _check_probe_kernels(probe_data)
    errs.update(probe_errs)
    total, _ = phase_main_path()
    probe_launches = phase_probe_path(probe_data, probe_outs)
    del probe_outs
    total.update({k: probe_launches[k] for k in PROBE_KERNELS})
    kernels = phase_times(smi, total, errs, probe_data)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
