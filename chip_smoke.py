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
   offsets; K2 (prefilter) over orders 2-5 and axis lengths 9/64/200 at
   every axis position, plus the uint8/int16 writeback, bit for bit; K4
   (the transposed prefilter) over orders 2-5 and lengths 1/2/9/64/200 at
   every axis position; and the K1/K3 and K2/K4 adjoint identities in
   float64;
3. the main path through the public entry points at the BASELINE configs
   c1, c2, c3 (forward, and ``deform_grid_gradient`` with crop, X_shape,
   affine and constant mode), c4 (forward and autograd to X), c5 (batched
   forward and backward) and c6 (batched, autograd to X and the grids),
   each compared with the port's own ``device="cpu"`` run; the launch
   counters must show each kernel on the configs that run it, and K5 on no
   config that does not ask for the grid gradient;
4. times: CUDA events, median of 10 runs after warm-up, for each kernel,
   its plain version and library yardstick at the c5 shapes, and each
   config (Mvox/s).

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
REPS = 10

MODES = ("nearest", "wrap", "reflect", "mirror", "constant")

KERNELS = ("resample_fwd", "spline_prefilter", "resample_bwd",
           "spline_prefilter_transpose", "resample_coord_grad")


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
    return worst


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

    return [_Config("c1", c1, 200 * 300, [(1e-10, 1e-10)]),
            _Config("c2", c2, 200 * 300, [F32, F32]),
            _Config("c3", c3, 96 ** 3, [F32]),
            _Config("c3_grad", c3_grad, 96 ** 3, [F32]),
            _Config("c4", c4, 64 ** 3, [F32, F32]),
            _Config("c5", c5, 64 * 64 ** 3, [F32, F32], nsub=2),
            _Config("c6", c6, 8 * 64 ** 3, [F32, F32, GRID32], nsub=2)]


# kernels each config must launch (K5 only where the grid gradient is
# asked for, and never elsewhere)
_MUST_LAUNCH = {"c3_grad": ("resample_bwd", "spline_prefilter_transpose"),
                "c4": ("resample_bwd", "spline_prefilter_transpose"),
                "c5": ("resample_bwd", "spline_prefilter_transpose"),
                "c6": ("resample_bwd", "spline_prefilter_transpose",
                       "resample_coord_grad")}
_MUST_NOT_LAUNCH = {"c3_grad": ("resample_coord_grad",),
                    "c4": ("resample_coord_grad",),
                    "c5": ("resample_coord_grad",)}


def _wrappers():
    """Each kernel's wrapper, which holds its launch counter."""
    from elasticdeform_tpu_torch.ops import prefilter as pf
    from elasticdeform_tpu_torch.ops import resample as rsm
    from elasticdeform_tpu_torch.ops import resample_bwd as rb
    return {"resample_fwd": rsm.resample,
            "spline_prefilter": pf.spline_filter1d,
            "resample_bwd": rb.resample_transpose,
            "spline_prefilter_transpose": pf.spline_filter1d_transpose,
            "resample_coord_grad": rb.resample_coord_grad}


def _counts():
    return {k: w.launches for k, w in _wrappers().items()}


def phase_main_path():
    """Phase 3: the public entry points on the card, counted, then each
    output against the port's CPU run."""
    import torch
    configs = _configs()
    outs, launches = {}, {}
    for w in _wrappers().values():
        w.launches = 0
    for cfg in configs:
        before = _counts()
        outs[cfg.name] = cfg.run("cuda")
        torch.cuda.synchronize()
        launches[cfg.name] = {k: v - before[k] for k, v in _counts().items()}
    total = _counts()
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

    for cfg in configs:
        ref = cfg.run("cpu", cfg.nsub)
        assert len(ref) == len(outs[cfg.name]) == len(cfg.tols)
        for i, (got, want, (rtol, atol_scale)) in enumerate(
                zip(outs[cfg.name], ref, cfg.tols)):
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
            if not got.dtype.is_floating_point:
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{what}: {int((got != want).sum())} integer values "
                        "differ from the CPU run")
                continue
            scale = float(want.abs().max())
            err = _assert_close(got, want, rtol, atol_scale * scale,
                                f"{what} vs CPU")
            print(f"{what}: {tuple(got.shape)} {got.dtype} matches the CPU "
                  f"run (max abs err {err:.3e}, rtol={rtol}, "
                  f"atol={atol_scale:g}*max|ref|)")
    return total, launches


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


def _bound(nbytes, ops):
    """(bound ms, what bounds it) on the H100 SXM peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_times(card, total_launches, errs):
    """Phase 4: kernel, plain and library times at the c5 shapes, and the
    configs' throughput."""
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
    save = _counts()
    numel = x.numel()
    n_out = math.prod(S)
    rows = []

    def row(name, source, replaces, ms, plain_ms, bound, library_ms, err):
        rows.append({"name": name, "route": "cuda",
                     "source": f"elasticdeform_tpu_torch/csrc/{source}",
                     "replaces": replaces,
                     "launches": total_launches[name],
                     "max_abs_err": max(err, errs[name]), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "library_ms": library_ms})
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"{name} at c5 shapes: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"library {lib}, bound {bound[0]:.4f} ms by {bound[1]}) "
              f"[{card}]")

    def per_axis(fn, axes):
        return [_time_ms(lambda a=a: fn(x, order, a)) for a in axes]

    def chain(fn, axes, mats=None):
        def run():
            y = x
            for i, a in enumerate(axes):
                y = fn(y, order, a) if mats is None else torch.tensordot(
                    mats[i], y, dims=([1], [a]))
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

    # K1: resample of the prefiltered batch at its dense displacement
    args = (displ, None, (0, 0, 0), order, 3)
    k1_err = _assert_close(rsm.resample(coeffs, *args, 0.0),
                           rsm.resample_plain(coeffs, *args, 0.0),
                           *_tol(torch.float32, 1.0), "K1 at c5 shapes")
    row("resample_fwd", "resample.cu", "elasticdeform_tpu/ops/resample.py:66",
        _time_ms(lambda: rsm.resample(coeffs, *args, 0.0)),
        _time_ms(lambda: rsm.resample_plain(coeffs, *args, 0.0), warmup=1),
        _bound((numel + 3 * B * n_out + B * n_out * C) * 4,
               _k1_ops(B, n_out, 3, order, C)), None, k1_err)

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
        _bound(k3_bytes, _k1_ops(B, n_out, 3, order, C)), None, k3_err)
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
               _k5_ops(B, n_out, 3, order, C)), None, k5_err)
    for name, w in _wrappers().items():
        w.launches = save[name]

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
    total, _ = phase_main_path()
    kernels = phase_times(smi, total, errs)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
