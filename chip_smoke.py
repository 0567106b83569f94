#!/usr/bin/env python3
"""Smoke run of elasticdeform_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is not 0):

1. device and build: prints the card's name and power limit, builds the
   CUDA kernels from ``elasticdeform_tpu_torch/csrc`` with nvcc;
2. each kernel against its plain PyTorch version on the card: K1 (resample)
   over orders 0-5 x five modes x 2-D/3-D in float32 and float64 with
   coordinates far past every edge; K2 (prefilter) over orders 2-5 and
   axis lengths 9/64/200 at every axis position, plus the uint8/int16
   writeback, bit for bit;
3. the main path through the public entry points at the BASELINE configs
   c1, c2, c3 and c5, each compared with the port's own ``device="cpu"``
   run; the kernels' launch counters must grow;
4. times: CUDA events, median of 10 runs after warm-up, for each kernel,
   its plain version and library yardstick, and each config (Mvox/s).

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


def _tol(dtype, scale):
    """(rtol, atol) of a kernel against its plain version: float32
    rtol=1e-5, atol=1e-5*max|x|; float64 1e-10 for both."""
    import torch
    if dtype == torch.float32:
        return 1e-5, 1e-5 * scale
    return 1e-10, 1e-10 * scale


def _assert_close(got, want, rtol, atol, what):
    import torch
    err = (got.double() - want.double()).abs()
    bad = err > atol + rtol * want.double().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} values off, max abs "
            f"err {float(err.max()):.3e} (rtol={rtol}, atol={atol:.3e})")
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
    dev = torch.device("cuda")
    rs = np.random.RandomState(1)
    worst = {"resample_fwd": 0.0, "spline_prefilter": 0.0}
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
                    rtol, atol = _tol(dtype, 4.0)
                    err = _assert_close(
                        got, want, rtol, atol,
                        f"K1 naxis={naxis} {dtype} order={order} "
                        f"mode={MODES[mode]}")
                    worst["resample_fwd"] = max(worst["resample_fwd"], err)
                    n += 1
    print(f"K1 resample_fwd vs plain: {n} cases pass, max abs err "
          f"{worst['resample_fwd']:.3e}")

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
    return worst


def _configs(seed=0):
    """The BASELINE configs c1, c2, c3, c5 as (name, run(device), n_out_vox,
    rtol, atol-scale, samples compared)."""
    import torch
    import elasticdeform_tpu_torch as et
    rs = np.random.RandomState(seed)

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

    def c3(device, n=None):
        return [et.deform_grid(X3, d3, order=3, mode="constant",
                               crop=[slice(16, 112)] * 3, affine=A3,
                               device=device)]

    X5 = torch.as_tensor(rs.rand(64, 64, 64, 64).astype(np.float32))
    d5 = torch.as_tensor((rs.randn(64, 3, 3, 3, 3) * 6).astype(np.float32))
    X5_dev, d5_dev = {}, {}

    def c5(device, n=None):
        key = str(device)
        if key not in X5_dev:
            X5_dev[key] = X5.to(device)
            d5_dev[key] = d5.to(device)
        x, d = X5_dev[key], d5_dev[key]
        if n is not None:
            x, d = x[:n], d[:n]
        return [et.deform_batch(x, d, order=3, mode="mirror", device=device)]

    return [("c1", c1, 200 * 300, 1e-10, 1e-10, None),
            ("c2", c2, 200 * 300, 1e-5, 1e-5, None),
            ("c3", c3, 96 ** 3, 1e-5, 1e-4, None),
            ("c5", c5, 64 * 64 ** 3, 1e-5, 1e-4, 2)]


def phase_main_path():
    """Phase 3: the public entry points on the card, counted, then each
    output against the port's CPU run."""
    import torch
    from elasticdeform_tpu_torch.ops import prefilter as pf
    from elasticdeform_tpu_torch.ops import resample as rsm
    configs = _configs()
    outs, launches = {}, {}
    pf.spline_filter1d.launches = 0
    rsm.resample.launches = 0
    for name, run, _, _, _, _ in configs:
        k1, k2 = rsm.resample.launches, pf.spline_filter1d.launches
        outs[name] = run("cuda")
        torch.cuda.synchronize()
        launches[name] = {"resample_fwd": rsm.resample.launches - k1,
                          "spline_prefilter":
                              pf.spline_filter1d.launches - k2}
    total = {"resample_fwd": rsm.resample.launches,
             "spline_prefilter": pf.spline_filter1d.launches}
    print(f"main path launches per config: {json.dumps(launches)}")
    if min(total.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never ran: {total}")

    for name, run, _, rtol, atol_scale, nsub in configs:
        ref = run("cpu", nsub)
        for got, want in zip(outs[name], ref):
            got = got if isinstance(got, torch.Tensor) else torch.as_tensor(got)
            want = want if isinstance(want, torch.Tensor) \
                else torch.as_tensor(want)
            got = got.cpu()[:nsub] if nsub else got.cpu()
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(
                    f"{name}: got {tuple(got.shape)} {got.dtype}, CPU run "
                    f"gives {tuple(want.shape)} {want.dtype}")
            if not bool(torch.isfinite(got.double()).all()):
                raise AssertionError(f"{name}: non-finite output")
            if not got.dtype.is_floating_point:
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{name}: {int((got != want).sum())} integer values "
                        "differ from the CPU run")
                continue
            scale = float(want.abs().max())
            err = _assert_close(got, want, rtol, atol_scale * scale,
                                f"{name} vs CPU")
            print(f"{name}: {tuple(got.shape)} {got.dtype} matches the CPU "
                  f"run (max abs err {err:.3e}, rtol={rtol}, "
                  f"atol={atol_scale:g}*max|y|)")
    return total, launches


def _k1_ops(B, n_out, naxis, order, C):
    """Operations of one K1 call: per voxel, about 40 per axis for the
    coordinate, fold and weights, and per tap one weight product plus a
    multiply-add per channel."""
    return B * n_out * ((order + 1) ** naxis * (1 + 2 * C) + 40 * naxis)


def phase_times(card, total_launches, errs):
    """Phase 4: kernel, plain and library times at the c5 shapes, and the
    configs' throughput."""
    import torch
    from elasticdeform_tpu_torch.ops import prefilter as pf
    from elasticdeform_tpu_torch.ops import resample as rsm
    from elasticdeform_tpu_torch.ops.displacement import dense_displacement
    dev = torch.device("cuda")
    rs = np.random.RandomState(5)
    B, S, C, order = 64, (64, 64, 64), 1, 3
    x = torch.as_tensor(rs.rand(B, *S, C).astype(np.float32), device=dev)
    grid = torch.as_tensor((rs.randn(B, 3, 3, 3, 3) * 6).astype(np.float32),
                           device=dev)
    displ = dense_displacement(grid, S, S, (0, 0, 0))
    save = rsm.resample.launches, pf.spline_filter1d.launches

    # K2: one prefilter of the batch = one launch per deformed axis
    def k2():
        y = x
        for a in (1, 2, 3):
            y = pf.spline_filter1d(y, order, a)
        return y

    def k2_plain():
        y = x
        for a in (1, 2, 3):
            y = pf.spline_filter1d_plain(y, order, a)
        return y

    mats = [torch.as_tensor(pf.filter_matrix(n, order), dtype=x.dtype,
                            device=dev) for n in S]

    def k2_library():
        y = x
        for a, m in zip((1, 2, 3), mats):
            y = torch.tensordot(m, y, dims=([1], [a]))
        return y

    coeffs = k2()
    want = k2_plain()
    k2_err = _assert_close(coeffs, want, *_tol(torch.float32,
                                               float(x.abs().max())),
                           "K2 at c5 shapes")
    per_axis = []
    for a in (1, 2, 3):
        per_axis.append(_time_ms(lambda a=a: pf.spline_filter1d(x, order, a)))
    print(f"K2 per-axis ms at (64, 64, 64, 64, 1) f32, axes 1/2/3: "
          f"{per_axis} [{card}]")
    k2_ms = _time_ms(k2)
    k2_plain_ms = _time_ms(k2_plain)
    k2_lib_ms = _time_ms(k2_library)
    numel = x.numel()
    k2_bytes = 3 * 2 * numel * 4
    k2_ops = 3 * numel * (1 + 4 * len(pf.spline_poles(order)))
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / FP32_FLOPS) * 1e3

    # K1: resample of the prefiltered batch at its dense displacement
    def k1():
        return rsm.resample(coeffs, displ, None, (0, 0, 0), order, 3, 0.0)

    def k1_plain():
        return rsm.resample_plain(coeffs, displ, None, (0, 0, 0), order, 3,
                                  0.0)

    k1_err = _assert_close(k1(), k1_plain(), *_tol(torch.float32, 1.0),
                           "K1 at c5 shapes")
    k1_ms = _time_ms(k1)
    k1_plain_ms = _time_ms(k1_plain, reps=REPS, warmup=1)
    n_out = math.prod(S)
    k1_bytes = (B * n_out * C + 3 * B * n_out + B * n_out * C) * 4
    k1_ops = _k1_ops(B, n_out, 3, order, C)
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / FP32_FLOPS) * 1e3
    k1_by = "bytes" if k1_bytes / HBM_BYTES_PER_S >= k1_ops / FP32_FLOPS \
        else "operations"
    k2_by = "bytes" if k2_bytes / HBM_BYTES_PER_S >= k2_ops / FP32_FLOPS \
        else "operations"
    rsm.resample.launches, pf.spline_filter1d.launches = save
    print(f"K1 at c5 shapes: {k1_ms:.4f} ms (plain {k1_plain_ms:.4f} ms, "
          f"bound {k1_bound:.4f} ms by {k1_by}) [{card}]")
    print(f"K2 at c5 shapes (3 axes): {k2_ms:.4f} ms (plain "
          f"{k2_plain_ms:.4f} ms, tensordot {k2_lib_ms:.4f} ms, bound "
          f"{k2_bound:.4f} ms by {k2_by}) [{card}]")

    configs = _configs()
    for name, run, n_vox, _, _, _ in configs:
        ms = _time_ms(lambda run=run: run("cuda"))
        batch = 64 if name == "c5" else 1
        print(f"{name}: {ms:.3f} ms per call, "
              f"{n_vox / ms / 1e3:.2f} Mvox/s (output voxels"
              f"{' over the batch' if batch > 1 else ''}) [{card}]")

    return [
        {"name": "resample_fwd", "route": "cuda",
         "source": "elasticdeform_tpu_torch/csrc/resample.cu",
         "replaces": "elasticdeform_tpu/ops/resample.py:66",
         "launches": total_launches["resample_fwd"],
         "max_abs_err": max(k1_err, errs["resample_fwd"]),
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "spline_prefilter", "route": "cuda",
         "source": "elasticdeform_tpu_torch/csrc/prefilter.cu",
         "replaces": "elasticdeform_tpu/ops/prefilter.py:333",
         "launches": total_launches["spline_prefilter"],
         "max_abs_err": max(k2_err, errs["spline_prefilter"]),
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib_ms},
    ]



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
