#!/usr/bin/env python3
"""Smoke run of elasticdeform_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is not 0):

1. device and build: prints the card's name and power limit, builds the
   CUDA kernels from ``elasticdeform_tpu_torch/csrc`` with nvcc, prints
   each source's build time and ptxas figures and each K2/K4/K6/K7
   instantiation's (both routes, every tile width, K2's writeback route),
   K9T's tile instantiations (per dtype, column and fold flag), K2's
   writeback product (per dtype), K10's box (per dtype, min or max) and
   K1/K1c's, K5/K5c's and K3/K3c's (per dtype, index width, rank and
   order), K8T's and K8's tile instantiations (per dtype and width), K12's
   select tile (per dtype and column) and network tile (per dtype and wire
   count), K9's tile (per dtype and column) and K11's (per dtype, work
   type, min or max, flat or non-flat and column), which must have no
   stack frame and no spills, and holds
   K2/K4/K6/K7 and
   K9T's tile in float32, K6 and K2's
   writeback route in float64 too, K1/K1c and K5/K5c at orders 1 and 3 in
   float32, and every K3/K3c instantiation and K13's four tile
   instantiations and its pack and unpack kernels to no stack frame and no
   spills; prints the registers, stack frame, spills and shared bytes of
   K14-K17's eight kernels (``csrc/distance.cu``) and K18-K20's seven
   (``csrc/measure.cu``); then prints the atomic
   instructions of K3/K3c at rank 3 (``cuobjdump -sass``: native
   shared-memory adds or compare-and-swap loops);
2. each kernel against its plain PyTorch version on the card: K1 (resample),
   K3 (its transpose, a scatter, on the plan's tile route and with every
   block forced onto its direct branch, the blocks of each branch counted
   from a host model of the boxes) and K5 (the coordinate gradient) over
   orders 0-5 x five modes x 1-D to 4-D x one and two channels in float32
   and float64 with coordinates far past every edge, shared and per-sample
   affines and crop offsets; K1c, K3c and K5c (the same at caller-given
   coordinates, K1c and K5c bit for bit, K3c on both branches and at a
   NaN and a far-outside coordinate) over the same sweep plus a flat
   point list; K2 (prefilter) over orders 2-5 and axis lengths 9/64/200 at
   every axis position, plus the uint8/int16 writeback (K2's writeback
   route) in float32 and float64 on lines of 2-9, 33 and 40, bit for bit;
   K2's writeback route in its product form against its rows route and
   ``_row_sums``, bit for bit, in float32 and float64, the int8-int64 and
   uint8-uint32 writebacks and the fixed-order sums, the mirror, reflect
   and wrap tables, its chunk skip on (integer inputs) and off (inputs
   with NaN and infinities), c2's and c18's axes, packed and strided,
   lines at the tile cap and past it;
   K4 (the
   transposed prefilter) over orders 2-5 and lengths 1/2/9/64/200 at every
   axis position; K6 and K7 (the reflect/wrap prefilter and its transpose)
   against ``filter_matrix_bc`` and its transpose over orders 2-5 x
   reflect/wrap x lengths 1/2/9/64/224/248 at every axis position; K2, K4,
   K6 and K7 on both routes (shared-memory line tiles and one thread per
   line) over inner 1/3/33/64/100, partial last tiles and lines one below,
   at and one above the tile cap, c5's three axes, K2 also with the integer
   writeback (its writeback route, bit for bit with the twin), the tile
   route at every width equal to the lines route bit for bit; ``deform``
   and ``deform_grid`` with uint8 and int16 inputs at orders 2-5, float32
   and float64 compute, 1-D to 3-D (axes 2-64) and a 512x512 image, bit for
   bit with the same call on the CPU; K2 and K6 on their fixed-order route
   bit for bit with their twins, then ``affine_transform``, ``zoom``,
   ``rotate``, ``shift`` and ``map_coordinates`` on uint8 and int16 inputs
   at orders 0, 1 and 3, a legacy and a modern mode, 2-D and 3-D, bit for
   bit with the same call on the CPU; ``spline_filter`` and
   ``spline_filter1d`` into uint8 and int16 output arrays at orders 2-5 in
   every mode name, 1-D to 3-D and a 512x512 image, bit for bit with the
   CPU run, each axis on the fixed-order route; the filter tier's integer
   ``output=`` (``correlate`` and ``convolve`` through K9 into uint8,
   int16 and int32, ``correlate1d`` on K8's direct route,
   ``gaussian_filter`` of a float32 input into int16, ``uniform_filter``,
   ``sobel`` and ``prewitt``) in every mode, 1-D to 3-D and a 512x512
   image, bit for bit with the CPU run; K8 on both routes (a shared-memory
   line tile, one thread per output) over every mode and width, lines of 1
   to the tile cap, 1-41 taps, both orders, c11's, c12's and c13's axes,
   inputs holding NaN and infinities and a NaN or infinite cval, the tile
   route bit for bit with the lines route and both against the twin, NaN
   where NaN (note R12); K12's network route on both routes (a
   shared-memory halo box with the wires in registers, one thread per
   voxel) bit for bit with the twin in the eleven dtypes over 3-64 taps,
   five ranks, every mode and every column; K8T on both routes (shared-memory
   line tiles, one thread per output) over every mode and width, lines of 1
   to the tile cap, 1-41 taps and c11's axes, the tile route bit for bit
   with the lines route and both per element to the twin; K12's select
   route on both routes (a shared-memory halo box, one thread per voxel) bit
   for bit with the twin in the eleven dtypes over 65-343 taps, three ranks,
   every mode, 1-D to 3-D and a batch axis; K9 on both routes (a
   shared-memory halo box of the folded input or cval, one thread per
   output) bit for bit with the twin and each other at c14's shapes in every
   mode, every column, 1-D to rank-4 and sparse kernels; K11 on both routes
   bit for bit with the twin in the eleven dtypes, flat and non-flat, min
   and max, every mode; the morphology tier's ``output=`` (grey erosion,
   dilation, opening, closing, top-hats, gradient, Laplace, minimum and
   maximum filters, box, footprint and non-flat structure) from int16,
   uint8 and float32 inputs holding infinities and NaN into uint8, int16,
   int32 and float32 arrays, bit for bit with the CPU run;
   K9T on both routes (a shared-memory
   halo box and one thread per output) at c14's shapes in every mode, 2-D,
   rank-4 and sparse kernels, every column, per element to the twin and to
   each other; K8 and
   K8T (the 1-D correlation and its transpose) over the five filter modes,
   1-41 taps (longer than some axes) at every centre, every axis of 2-D and
   3-D shapes with odd sizes, and the paired integer route bit for bit; K9
   and K9T (the N-D correlation and its transpose) over the five modes and
   the grid aliases, 2-D to 4-D kernels with batch axes and origins; the
   K1/K3, K1c/K3c, K2/K4, K6/K7, K8/K8T and K9/K9T adjoint identities in
   float64; K8 and K9 (and K9's two routes, bit for bit) on inputs
   holding NaN and infinities with a finite, NaN or infinite cval, NaN and
   infinities where the twins have them; and, bit for bit in all eleven
   dtypes (bool, the eight integer
   types, float32 and float64 with NaN and infinities), K10 (1-D min/max)
   over sizes 1-15 at every centre, the five modes and every axis, and its
   box route (every pass of a separable box in one launch) against its
   lines route over boxes of 1-3 axes on 1-D to 5-D inputs, sizes 2-25,
   per-axis modes and centres (4 axes on the lines route), K11
   (footprint min/max) over flat and non-flat 2-D to 4-D footprints with
   saturating integer casts, K12 (rank selection) over 2-343 taps on both
   routes, and K13 (binary sweep) over random, even and empty structures,
   borders, masks and its changed flag on the plan's route and each route
   forced (tile and nd; the nd route alone at 4 axes and an innermost reach
   of 33), its driver at 3 iterations and to the fixpoint on the tile and
   nd routes against the CPU run, and its
   multi-sweep launches (k 1-8, 1-D to 3-D, innermost lengths 1-224,
   innermost reach up to 32) against k twin sweeps and the last sweep's
   flag; K1 and K1c reading a
   narrow (bfloat16 or float32) coefficient table, bit for bit; K1 and K1c
   with 64-bit offsets (forced through the C entry points) bit for bit
   with the 32-bit ones, and K1 with no affine and zero offsets bit for bit
   with K1c at ``iota + displ``; and the
   probe kernels at the JAX probes' default sizes: P1 (shared memory) at
   48-227 KiB, 228 KiB raising the CUDA error, P2 (row gather: copy,
   element and sum modes) bit for bit and its sums repeating bit for bit,
   P3 (row scatter-add) per element to the sum of its terms, integer
   counts exactly, P4 (bulk-copy row gather) as P2's sums; and, bit for
   bit, K14 (the EDT's nearest-background scan) with and without feature
   planes (lines of 1-300, segments of 1-19), K15 (its min-plus pass) at
   every rung of the ladder alone on lines of 3-97 (dense only, a band of
   16, both bands) with the certificate, on its tile route (column tiles,
   partial ones, whole slabs) and on lines of 6150 past the staging (its
   lines route), the dense kernel on a clear flag (it writes nothing) and
   on a set one, and the pass entry (band and predicated dense kernel from
   one host call) against the CPU schedule, its flag too, K16
   (the chamfer sweep) with and without indices and K17 (the watershed
   sweep) on uint8 and uint16 images, random and plateaus, over the cross,
   full and a custom structure, with the changed flag, one sweep a call
   and the fixpoint driver's groups of 3 and 8 sweeps from one host call,
   each on 1-D to 4-D shapes and with sampling 0.7 and (1.5, 1, ...),
   dense and sparse background, none and all; and the public transforms
   against the CPU run; K18 (the union-find labeling: roots, root flags
   and the numbering) bit for bit on 1-D to 4-D masks at five foreground
   shares under every connectivity and a random symmetric structure,
   snakes, and ``label`` of NaN-holding float inputs against the CPU run;
   K19 (every segment statistic at once) on both routes and K20 (both
   extrema's positions) in the eleven dtypes with NaN, +-0 and
   infinities, without labels, without an index, with duplicate and absent
   index entries and a scalar, and with 10^5 segments (the device route):
   counts, order keys,
   coordinate bounds, histograms and positions bit for bit, float64 sums
   per segment to 1e-12 of the sum of their terms' magnitudes;
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
   segmentation), c18 (``deform_grid`` of a 96^3 int16 CT volume at
   order 3, bit for bit) and c19 (``distance_transform_edt`` with indices
   at sampling (1.5, 1, 1) and ``distance_transform_cdt`` with indices of
   80 slices of c17's segmentation, ``watershed_ift`` of a uint8 gradient
   of 48 slices of c15's volume with 28 markers, bit for bit, with exact
   K14 and K15 launches (K15's band and dense kernels, two a pass) and K16
   and K17 sweeps per call and the tier each EDT pass kept, read from its
   flag after the call), and c20 (``label`` of 64 central slices of c17's
   segmentation under the 3^3 structure and of c15's volume above its
   median under the cross, then ``sum_labels``, ``mean``, ``variance``,
   ``minimum`` and ``maximum`` over the second labels and
   ``minimum_position``, ``maximum_position``, ``center_of_mass``,
   ``find_objects`` and a 64-bucket ``histogram`` over the first, each
   index 1..n; labels, counts, minima, maxima, positions, slices and
   histograms bit for bit, sums to rtol 1e-10, the variance to 1e-10 of
   s2/c), each compared with the port's own ``device="cpu"`` run;
   the launch counters, set to 0 before each config and read after it, must
   show each kernel on the configs that run it and none on the configs that
   do not need it (exact counts for c11-c16, c18 and c20 (K19 five
   launches on each route), and c17's K13 sweeps
   per
   call, 4, 80 and 168, all on the tile route, with its pack and unpack
   launches; K2's, K4's, K6's, K7's, K3's, K3c's, K8T's, K9's, K9T's,
   K10's, K11's and K12's launches split by route, the tile route taken
   (K10: its box route), c8's and c9's K6 only there, c11-c13's K8, c11's
   K8T, c14's K9 and K9T, c15's 5^3 median and c16's K11 on the tile
   route, c16's K10 in two box launches, c15's two network filters on the
   network tile, c18 alone on K2's writeback route, in its product form);
   then the probes' path: every Pallas probe through the port's
   public functions (``elasticdeform_tpu_torch.probes``) at the JAX probes'
   default sizes, counters set to 0 before and read after (exact counts of
   P1-P4, none of K1-K17), each output equal to phase 2's kernel output;
4. times: CUDA events, median of 10 runs after warm-up, for each kernel,
   its plain version and library yardstick (K1-K5 at the c5 shapes, K4,
   K6 and K7 also per axis with their route, tile width, blocks per SM and
   waves, every width, the lines route, the tile's copy alone and a plain
   device copy; K2's writeback route at c2's 200x300 and on a 128^3
   int16 volume in its product form, without the chunk skip and on the
   rows route, beside ``tensordot`` and its operation bound (a row of its
   own in the JSON line); also
   at order 1 beside ``grid_sample``; K1c, K3c, K5c at the c7 shapes beside
   ``grid_sample``; the share of K5's and K5c's blocks whose tap box would
   fit 16 KB of shared memory; K6, K7 and again K1c, K3c at the c8 shapes;
   K3 at c5 (orders 3 and 1) and K3c at c7 and c8 on the plan's route, the
   direct route, a 4x8x16 tile and a 24 KB box, with blocks per SM and the
   distribution of the tile's boxes (share that fits, median, p90, p99);
   one line each for K1 at c5 (orders 1 and 3) and K1c at c7 and c8: taps
   gathered per second beside P2's L2 element rate, the bfloat16-table time
   and ``grid_sample`` at order 1; one line each for K3 and K3c there: the
   shared-memory adds and the device-memory atomics per second beside P3's
   rate; K8-K9T at
   the c11, c13 and c14 shapes (K8 and K8T per axis with their route,
   width, shared bytes and waves, every width and the lines route, beside
   ``tensordot`` with M or M^T per axis, K8T also with a packed tile's
   direct stores; K8 on c13's float64 paired passes the same); K10 (c16's
   5^3 dilation on the box route and on the lines route, per axis, and
   c16's opening both ways) and K11 at the c16 shapes beside
   ``max_pool3d``, K12 at the c15 shapes on each
   route (the network tile at every column and the old network kernel, the
   select route's tile and nd routes)
   beside ``torch.kthvalue`` over the unfold windows of the padded volume
   (3^3 and 5^3, and the ball's 33 taps gathered from 5^3 windows), K13's
   single sweep at the c17
   shapes on each route beside ``max_pool3d`` and c17's hole filling per
   call and per sweep on the packed state, on bool bytes and on the nd
   route beside the call's byte bound; K2 per axis at c5 as K4 (route, W, blocks per SM,
   waves, every width, the lines route), K9 and K9T at c14 per column and
   on the nd route (K9 also for c14's 3^3 convolve), K11 at c16 on each
   route (the ball erosion, the non-flat 3^3 dilation and a flat 5^3 box
   beside ``max_pool3d``); K14-K17 at c19's shapes with their device ms
   (K14 beside two ``torch.cummax`` scans, K15 as c19's two passes, the
   pass entry's, and each kernel alone per axis, the dense one on a set
   and a clear flag, K16 and K17 per sweep (the driver's sweeper and the
   wrapper), per group of eight sweeps from one host call and per call,
   each on the device, K16's sweep beside ``-max_pool3d(-d)``, a
   chessboard sweep without indices); one line per
   probe, its calls timed back to back: ms,
   M rows/s, GB/s of the rows
   moved, from L2 or HBM, beside the byte bound, the twin and the library
   call, ``index_select``, ``gather``, ``embedding_bag`` or ``index_add_``;
   P2's host microseconds per call, device microseconds per call from the
   profiler and one launch between events, beside its library call's; the
   library-only probes' rates), K18-K20 at c20's shapes with their device
   ms (K18 on both masks and its numbering, K19 per statistic on each
   route beside ``index_add_`` and ``bincount``, K20 beside
   ``scatter_reduce_``), and each config (Mvox/s).

The line before the last is a JSON object with one entry per kernel (K2,
its writeback route, K4, K6, K7, K8, K8T, K9, K9T, K3, K3c, K10, K11, K12
and K13 with their launches per route;
K13 also
its sweeps and its pack and unpack launches; K14-K17 at c19's shapes, K15
with its kept tiers, plans and each kernel's time, K16 and K17 per sweep with their
call's time and sweeps; K18-K20 at c20's shapes, K19 with its launches per
route); the last line
is
``{"ok": true, "device": {...}}``. It exits non-zero with no result when no
CUDA device is present or when the package is missing.

``times_ab(card)`` times K2 at c5, K8T and K8 at c11, K8 on c13's paired
passes, K12's 5^3 median, 3^3 median and 33-tap percentile at c15,
K6 at c8 and c9, K2's integer writeback at c2 and c18, K9T and K9 at c14,
K10's 5^3 erosion and dilation and K11 at c16, K3 at c5
(orders 3 and 1), K3c at c7, K14, K15's passes, the EDT's, K16's and
K17's calls at c19 and every config
through the public wrappers only, and
prints digests of K6's and the EDT's output bits, so that a copy of this file put into
an older tree times (and checks) that tree's package in the same call to
the card.
"""

from __future__ import annotations

import itertools
import json
import math
import re
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
           "min_max_filter", "rank_filter", "binary_step",
           "nearest_background", "minplus_pass", "chamfer_sweep",
           "watershed_sweep", "label_roots", "segment_reduce",
           "segment_position", "smem_probe", "row_gather", "row_scatter_add",
           "row_gather_async")
FILTER_KERNELS = KERNELS[10:14]
MORPH_KERNELS = KERNELS[14:18]
DIST_KERNELS = KERNELS[18:22]
MEAS_KERNELS = KERNELS[22:25]
PROBE_KERNELS = KERNELS[25:]
# the kernels of the deform, resampler, filter, morphology, distance and
# measurement path (phase 3)
PATH_KERNELS = KERNELS[:25]


# the resample kernels' sweep (phase 2): (naxis, input shape, output shape)
SWEEP_SHAPES = ((1, (37,), (50,)), (2, (23, 31), (20, 27)),
                (3, (11, 13, 9), (10, 12, 8)), (4, (7, 6, 5, 8), (6, 5, 4, 7)))


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


# the rank-specialised kernels' instantiations (dtype, order, rank, index
# type): K5/K5c in resample_bwd.cu (order 1 in coord_grad_pair_kernel,
# which has no order parameter), K1/K1c in resample.cu, K3/K3c's tile
# route and its direct route
_K5_NAME = re.compile(
    r"coord_grad_(?:pair_)?kernelI([fd])(?:Li(\d)E)?Li(\d)E([il])E")
_K1_NAME = re.compile(r"resample_fwd_kernelI([fd])Li(\d)ELi(\d)E([il])E")
_K3_NAME = re.compile(r"resample_bwd_kernelI([fd])Li(\d)ELi(\d)E([il])E")
_K3D_NAME = re.compile(
    r"resample_direct_kernelI([fd])Li(\d)ELi(\d)E([il])E")


def _ptxas_kernels(log):
    """``{mangled kernel: [registers, stack frame bytes, spill store bytes,
    spill load bytes, ptxas ms, static shared bytes]}`` from nvcc's
    ``-Xptxas -v`` output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, [0, 0, 0, 0, 0.0, 0])
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur][1:4] = [int(x) for x in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur][0] = int(m.group(1))
        m = re.search(r"Compile time = ([\d.]+) ms", line)
        if m:
            out[cur][4] = float(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[cur][5] = int(m.group(1))
    return out


# K2/K4/K6/K7's kernels: the tile route (dtype, width, kind 0 K4 / 1 K7
# reflect / 2 K7 wrap / 3 K2 / 4 K6 reflect / 5 K6 wrap / 6 K2's writeback
# route) and the lines route (dtype; K6 and K7 with their boundary
# condition)
_TILE_KINDS = {"0": "K4", "1": "K7 reflect", "2": "K7 wrap", "3": "K2",
               "4": "K6 reflect", "5": "K6 wrap", "6": "K2 writeback"}
_K247_NAMES = (
    ("tile", re.compile(r"prefilter_tile_kernelI([fd])Li(\d+)ELi(\d)E")),
    ("lines", re.compile(r"prefilter_kernelI([fd])E"), "K2"),
    ("lines", re.compile(r"prefilter_transpose_kernelI([fd])E"), "K4"),
    ("lines", re.compile(r"prefilter_bc_transpose_kernelI([fd])Li(\d)E"),
     "K7"),
    ("lines", re.compile(r"prefilter_bc_kernelI([fd])Li(\d)E"), "K6"),
    ("lines", re.compile(r"prefilter_writeback_kernelI([fd])E"),
     "K2 writeback"))
# K9T's tile route (dtype, column C, fold lists)
_K9T_TILE = re.compile(r"correlate_nd_transpose_tile_kernelI([fd])Li(\d)"
                       r"ELb([01])E")


def _check_tile_ptxas(log):
    """Print each K2/K4/K6/K7 instantiation's registers, stack, spills and
    static shared bytes (the tile's own shared memory is dynamic: its bytes
    are the plan's, printed in phase 4); fail unless all 56 are found (42
    tile: 2 dtypes x 3 widths x 7 stage sets; 14 lines) or if one in
    float32, or one of K6 or K2's writeback route in either dtype, has a
    stack frame or spills."""
    found, bad = 0, []
    for fn, v in sorted(_ptxas_kernels(log).items()):
        for route, pat, *name in _K247_NAMES:
            m = pat.search(fn)
            if not m or fn.startswith("_ZZ"):   # _ZZ: a kernel's lambda
                continue
            g = m.groups()
            kind = (_TILE_KINDS[g[2]] if route == "tile" else
                    name[0] if len(g) == 1 else
                    f"{name[0]} {'reflect' if g[-1] == '1' else 'wrap'}")
            width = f" W={g[1]}" if route == "tile" else ""
            dt = "float32" if g[0] == "f" else "float64"
            print(f"  ptxas {kind} {route}{width} {dt}: {v[0]} registers, "
                  f"{v[1]} bytes stack frame, {v[2]}/{v[3]} bytes spill "
                  f"stores/loads, {v[5]} bytes static shared")
            found += 1
            held = g[0] == "f" or kind.startswith(("K6", "K2 writeback"))
            if held and any(v[1:4]):
                bad.append(fn)
    if found != 56 or bad:
        raise AssertionError(f"K2/K4/K6/K7: {found} of 56 instantiations "
                             f"found; with a stack frame or spills (float32, "
                             f"or K6 or K2's writeback route): {bad}")


# K13's tile route (dilation, bool bytes in and out) and its pack kernels
_K13_TILE = re.compile(r"binary_tile_kernelILb([01])ELb([01])E")
_K13_PACK = re.compile(r"binary_(un)?pack_kernel")


def _check_k13_ptxas(log):
    """Print K13's four tile instantiations (erosion or dilation, packed
    words or bool bytes) and its pack and unpack kernels; fail unless all
    six are found, or if one has a stack frame or spills."""
    found, bad = 0, []
    for fn, v in sorted(_ptxas_kernels(log).items()):
        m = _K13_TILE.search(fn)
        if m:
            label = (f"K13 tile {'dilation' if m.group(1) == '1' else 'erosion'}"
                     f" {'bytes' if m.group(2) == '1' else 'packed words'}")
        elif _K13_PACK.search(fn):
            label = f"K13 {'unpack' if 'unpack' in fn else 'pack'}"
        else:
            continue
        print(f"  ptxas {label}: {v[0]} registers, {v[1]} bytes stack frame, "
              f"{v[2]}/{v[3]} bytes spill stores/loads")
        found += 1
        if any(v[1:4]):
            bad.append(fn)
    if found != 6 or bad:
        raise AssertionError(f"K13: {found} of 6 tile and pack kernels found; "
                             f"with a stack frame or spills: {bad}")


# K14-K17's kernels in csrc/distance.cu: (label, mangled name part)
_DIST_PTXAS = (("K14 nearest_bg_kernel", "nearest_bg_kernel"),
               ("K15 band, tile route", "minplus_tile_kernelILb0E"),
               ("K15 dense, tile route", "minplus_tile_kernelILb1E"),
               ("K15 band, lines route", "minplus_lines_kernelILb0E"),
               ("K15 dense, lines route", "minplus_lines_kernelILb1E"),
               ("K16 chamfer_sweep_kernel", "chamfer_sweep_kernel"),
               ("K17 uint8", "watershed_sweep_kernelIhE"),
               ("K17 uint16", "watershed_sweep_kernelItE"))


def _check_distance_ptxas(log):
    """Print K14-K17's registers, stack frame, spills and shared bytes; fail
    unless each of their eight kernels is found once."""
    kern = _ptxas_kernels(log)
    for label, part in _DIST_PTXAS:
        hits = [v for fn, v in kern.items() if part in fn]
        if len(hits) != 1:
            raise AssertionError(f"{label}: {len(hits)} kernels named "
                                 f"{part} in the ptxas report, not 1")
        v = hits[0]
        print(f"  ptxas {label}: {v[0]} registers, {v[1]} bytes stack "
              f"frame, {v[2]}/{v[3]} bytes spill stores/loads, {v[5]} bytes "
              "static shared")


# K18-K20's kernels in csrc/measure.cu: (label, mangled name part)
_MEAS_PTXAS = (("K18 init", "uf_init_kernel"),
               ("K18 merge", "uf_merge_kernel"),
               ("K18 compress", "uf_compress_kernel"),
               ("K18 numbering", "label_number_kernel"),
               ("K19 shared route", "segment_reduce_kernelILb1E"),
               ("K19 device route", "segment_reduce_kernelILb0E"),
               ("K20", "segment_position_kernel"))


def _check_measure_ptxas(log):
    """Print K18-K20's registers, stack frame, spills and shared bytes; fail
    unless each of their seven kernels is found once."""
    kern = _ptxas_kernels(log)
    for label, part in _MEAS_PTXAS:
        hits = [v for fn, v in kern.items() if part in fn]
        if len(hits) != 1:
            raise AssertionError(f"{label}: {len(hits)} kernels named "
                                 f"{part} in the ptxas report, not 1")
        v = hits[0]
        print(f"  ptxas {label}: {v[0]} registers, {v[1]} bytes stack "
              f"frame, {v[2]}/{v[3]} bytes spill stores/loads, {v[5]} bytes "
              "static shared")


def _check_k9t_ptxas(log):
    """Print each K9T tile instantiation's registers, stack and spills per
    dtype, column C and fold flag; fail unless all 16 are found and none in
    float32 has a stack frame or spills."""
    found, bad = 0, []
    for fn, v in sorted(_ptxas_kernels(log).items()):
        m = _K9T_TILE.search(fn)
        if not m or fn.startswith("_ZZ"):
            continue
        dt, col, fold = m.groups()
        print(f"  ptxas K9T tile {'float32' if dt == 'f' else 'float64'} "
              f"C={col} {'fold' if fold == '1' else 'constant'}: {v[0]} "
              f"registers, {v[1]} bytes stack frame, {v[2]}/{v[3]} bytes "
              f"spill stores/loads")
        found += 1
        if dt == "f" and any(v[1:4]):
            bad.append(fn)
    if found != 16 or bad:
        raise AssertionError(f"K9T: {found} of 16 tile instantiations found; "
                             f"float32 with a stack frame or spills: {bad}")


# K8T's tile route (dtype, width W), K12's select route on a halo box
# (dtype, column C), K9's tile route (dtype, column C) and K11's (dtype, work
# type, minimum, non-flat, column C)
_K8T_TILE = re.compile(r"correlate1d_transpose_tile_kernelI([fd])Li(\d+)E")
_K12_TILE = re.compile(r"rank_select_tile_kernelI([bhatsjimlfd])Li(\d)E")
_K9_TILE = re.compile(r"correlate_nd_tile_kernelI([fd])Li(\d)E")
_K11_TILE = re.compile(r"min_max_tile_kernelI([bhatsjimlfd])([bhatsjimlfd])"
                       r"Lb([01])ELb([01])ELi(\d)E")
# K2's writeback product (dtype) and K10's box route (dtype, min or max)
_K2_PRODUCT = re.compile(r"writeback_product_kernelI([fd])E")
_K10_BOX = re.compile(r"min_max_box_kernelI([bhatsjimlfd])Lb([01])E")
# K8's tile route (dtype, width W) and K12's network tile (dtype, wires)
_K8_TILE = re.compile(r"correlate1d_tile_kernelI([fd])Li(\d+)E")
_K12_NET = re.compile(r"rank_network_tile_kernelI([bhatsjimlfd])Li(\d+)E")
_MANGLED = {"b": "bool", "h": "uint8", "a": "int8", "t": "uint16",
            "s": "int16", "j": "uint32", "i": "int32", "m": "uint64",
            "l": "int64", "f": "float32", "d": "float64"}


def _check_tile_table(label, log, pattern, count, name):
    """Print each instantiation of a tile kernel (``name`` formats its
    match groups) with its registers, stack and spills; fail unless all
    ``count`` are found and none has a stack frame or spills."""
    found, bad = 0, []
    for fn, v in sorted(_ptxas_kernels(log).items()):
        m = pattern.search(fn)
        if not m or fn.startswith("_ZZ"):
            continue
        print(f"  ptxas {label} {name(*m.groups())}: {v[0]} registers, "
              f"{v[1]} bytes stack frame, {v[2]}/{v[3]} bytes spill "
              f"stores/loads")
        found += 1
        if any(v[1:4]):
            bad.append(fn)
    if found != count or bad:
        raise AssertionError(f"{label}: {found} of {count} instantiations "
                             f"found; with a stack frame or spills: {bad}")


def _check_rank_table(label, log, pattern, orders, count, every=False):
    """Print the registers, stack and spills of a rank-specialised kernel's
    instantiations (K5/K5c, K1/K1c or K3/K3c) per dtype, index type and
    rank, one entry per order; fail unless all ``count`` are found and every
    float32 one at order 1 or 3 (``every``: every one) keeps its state in
    registers (no stack frame, no spills)."""
    found = {}
    for fn, v in _ptxas_kernels(log).items():
        m = pattern.search(fn)
        if m:
            # K5's order-1 kernel names no order
            dt, order, rank, ix = m.groups()
            found[dt, order or "1", rank, ix] = v
    for (dt, dname), (ix, width), rank in itertools.product(
            (("f", "float32"), ("d", "float64")),
            (("i", "int32"), ("l", "int64")), "1234"):
        parts = []
        for order in orders:
            r, st, ss, sl, ms = found.get((dt, order, rank, ix),
                                          [-1] * 6)[:5]
            parts.append(f"o{order} {r} {st}/{ss}/{sl} {ms / 1e3:.1f}s")
        print(f"  ptxas {label} {dname} rank {rank} {width} (registers, "
              f"stack/spill-store/spill-load bytes, ptxas s): "
              f"{'; '.join(parts)}")
    bad = {k: v for k, v in found.items()
           if (every or k[0] == "f" and k[1] in "13") and any(v[1:4])}
    if len(found) != count or bad:
        held = "any" if every else "float32 orders 1 and 3"
        raise AssertionError(f"{label}: {len(found)} of {count} "
                             f"instantiations found; {held} with a stack "
                             f"frame or spills: {bad}")


def _k3_sass(path):
    """Print the atomic instructions of K3/K3c's float32 and float64
    instantiations at rank 3 and orders 1 and 3 (32-bit offsets), from
    ``cuobjdump -sass`` of the built library: whether the shared-memory
    adds are native (ATOMS.ADD) or compare-and-swap loops (ATOMS.CAS*),
    and the device-memory ones (RED/ATOMG); the direct route's kernel at
    orders 0 and 1 too (one RED per tap).
    Returns ``{dtype: {opcode: count}}`` of the tile route at order 3;
    prints "not available" without cuobjdump."""
    import os
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("  sass K3/K3c: cuobjdump not available")
        return {}
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    found, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = _K3_NAME.search(m.group(1))
            d = _K3D_NAME.search(m.group(1))
            cur = k.groups() if k and k.group(3) == "3" and \
                k.group(4) == "i" and k.group(2) in "13" else None
            if d and d.group(3) == "3" and d.group(4) == "i" and \
                    d.group(2) in "01":
                cur = d.groups() + ("direct",)
            if cur:
                found[cur] = {}
            continue
        if cur:
            for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG)\.[\w.]+)",
                                 line):
                found[cur][op] = found[cur].get(op, 0) + 1
    out = {}
    for key, ops in sorted(found.items()):
        dt, order = key[:2]
        name = "float32" if dt == "f" else "float64"
        route = "direct route" if len(key) > 4 else "tile route"
        print(f"  sass K3/K3c {route} {name} rank 3 order {order}: " +
              ", ".join(f"{op} x{n}" for op, n in sorted(ops.items())))
        if order == "3" and len(key) == 4:
            out[name] = ops
    return out


def phase_build():
    """Build every source; print each one's nvcc time, its kernels' worst
    register, stack and spill figures, every other kernel with a stack
    frame or spills, K2/K4/K6/K7's, K9T's, K8T's, K12's, K9's and K11's tile
    instantiations and the K1/K1c, K5/K5c and K3/K3c tables, from the ptxas
    report kept beside each library (built in this run or before; a missing
    report fails). K2/K4/K6/K7 and K9T's tile in float32, K6 and K2's
    writeback route in float64 too, K1/K1c and K5/K5c at orders 1 and 3 in
    float32, and every K3/K3c, K8T, K12, K9 and K11 tile instantiation must
    keep their state in registers: no stack frame, no spills. Then K3/K3c's atomic instructions (:func:`_k3_sass`),
    which it returns."""
    from elasticdeform_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    each = ", ".join(f"{k} {v:.1f} s"
                     for k, v in sorted(_build.build_seconds.items()))
    print(f"build: {sorted(paths)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc per source: {each})")
    for name, log in sorted(_build.build_logs.items()):
        kern = _ptxas_kernels(log)
        worst = [max((v[i] for v in kern.values()), default=0)
                 for i in range(4)]
        print(f"  ptxas {name}: {len(kern)} kernels, at most {worst[0]} "
              f"registers, {worst[1]} bytes stack frame, {worst[2]} bytes "
              f"spill stores; ptxas "
              f"{sum(v[4] for v in kern.values()) / 1e3:.1f} s in all")
        for fn, v in kern.items():
            if not (_K5_NAME.search(fn) or _K1_NAME.search(fn) or
                    _K3_NAME.search(fn) or _K3D_NAME.search(fn)) and \
                    (v[1] or v[2]):
                print(f"  ptxas {name}: {fn}: {v[0]} registers, {v[1]} "
                      f"bytes stack frame, {v[2]}/{v[3]} bytes spill "
                      f"stores/loads")
    missing = set(_build.SOURCES) - _build.build_logs.keys()
    if missing:
        raise AssertionError(f"no ptxas report for {sorted(missing)}: the "
                             "register checks cannot run")
    _check_tile_ptxas(_build.build_logs["prefilter"])
    _check_k9t_ptxas(_build.build_logs["filters"])
    _check_tile_table(
        "K8T tile", _build.build_logs["filters"], _K8T_TILE, 6,
        lambda dt, w: f"{_MANGLED[dt]} W={w}")
    _check_tile_table(
        "K8 tile", _build.build_logs["filters"], _K8_TILE, 6,
        lambda dt, w: f"{_MANGLED[dt]} W={w}")
    _check_tile_table(
        "K12 network tile", _build.build_logs["morphology"], _K12_NET, 55,
        lambda dt, n: f"{_MANGLED[dt]} {n} wires")
    _check_k13_ptxas(_build.build_logs["morphology"])
    _check_distance_ptxas(_build.build_logs["distance"])
    _check_measure_ptxas(_build.build_logs["measure"])
    _check_tile_table(
        "K12 select tile", _build.build_logs["morphology"], _K12_TILE, 22,
        lambda dt, c: f"{_MANGLED[dt]} C={c}")
    _check_tile_table(
        "K9 tile", _build.build_logs["filters"], _K9_TILE, 8,
        lambda dt, c: f"{_MANGLED[dt]} C={c}")
    _check_tile_table(
        "K2 writeback product", _build.build_logs["prefilter"], _K2_PRODUCT,
        2, lambda dt: _MANGLED[dt])
    _check_tile_table(
        "K10 box", _build.build_logs["morphology"], _K10_BOX, 22,
        lambda dt, mn: f"{_MANGLED[dt]} {'min' if mn == '1' else 'max'}")
    _check_tile_table(
        "K11 tile", _build.build_logs["morphology"], _K11_TILE, 88,
        lambda dt, w, mn, nf, c: f"{_MANGLED[dt]} work {_MANGLED[w]} "
        f"{'min' if mn == '1' else 'max'} "
        f"{'non-flat' if nf == '1' else 'flat'} C={c}")
    for name, label, pattern, orders, count, every in (
            ("resample", "K1/K1c", _K1_NAME, "012345", 96, False),
            ("resample_bwd", "K5/K5c", _K5_NAME, "12345", 80, False),
            ("resample_bwd", "K3/K3c", _K3_NAME, "012345", 96, True),
            ("resample_bwd", "K3/K3c direct", _K3D_NAME, "012345", 96,
             True)):
        _check_rank_table(label, _build.build_logs[name], pattern, orders,
                          count, every)
    if {"resample", "resample_bwd"} <= _build.build_seconds.keys():
        print(f"  nvcc: resample.cu {_build.build_seconds['resample']:.1f} "
              f"s (K1/K1c, 96 instantiations), resample_bwd.cu "
              f"{_build.build_seconds['resample_bwd']:.1f} s (K3/K3c 96 "
              f"tile and 96 direct, K5/K5c 80) in the same build")
    return _k3_sass(paths["resample_bwd"])


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
    tally = {"tile": 0, "direct": 0}
    n = 0
    B = 2
    for (naxis, in_sp, out_sp), dtype, C, order, mode in itertools.product(
            SWEEP_SHAPES, (torch.float32, torch.float64), (1, 2), range(6),
            range(5)):
        coeffs = torch.as_tensor(rs.rand(B, *in_sp, C) * 4 - 1, dtype=dtype,
                                 device=dev)
        displ = _smooth_displacement(rs, B, naxis, out_sp, 3.0 * max(in_sp),
                                     dtype, dev)
        kind = (order + mode) % 3
        if kind == 0:
            affine = None
        else:
            A = np.zeros((B, naxis, naxis + 1))
            A[:, :, :naxis] = np.eye(naxis) + rs.randn(B, naxis, naxis) * 0.2
            A[:, :, naxis] = rs.randn(B, naxis) * 3
            affine = torch.as_tensor(A if kind == 2 else A[0], dtype=dtype,
                                     device=dev)
        offsets = tuple(int(o) for o in rs.randint(0, 3, naxis))
        args = (coeffs, displ, affine, offsets, order, mode, 1.5)
        got = rsm.resample(*args)
        want = rsm.resample_plain(*args)
        torch.cuda.synchronize()
        what = (f"naxis={naxis} C={C} {dtype} order={order} "
                f"mode={MODES[mode]}")
        rtol, atol = _tol(dtype, 4.0)
        err = _assert_close(got, want, rtol, atol, f"K1 {what}")
        worst["resample_fwd"] = max(worst["resample_fwd"], err)
        g = torch.as_tensor(rs.randn(B, *out_sp, C), dtype=dtype, device=dev)
        bargs = (displ, affine, offsets, order, mode)
        err, k3_outs = _check_k3(rb, g, bargs, in_sp, dtype, f"K3 {what}",
                                 tally)
        worst["resample_bwd"] = max(worst["resample_bwd"], err)
        got = rb.resample_coord_grad(coeffs, g, *bargs)
        want = rb.resample_coord_grad_plain(coeffs, g, *bargs)
        torch.cuda.synchronize()
        rtol, atol = _tol(dtype, _k5_scale(coeffs, g))
        worst["resample_coord_grad"] = max(
            worst["resample_coord_grad"],
            _assert_close(got, want, rtol, atol, f"K5 {what}"))
        if dtype == torch.float64:
            fwd = rsm.resample(coeffs, displ, affine, offsets, order, mode,
                               0.0)
            for got in k3_outs:
                _check_adjoint(fwd, g, coeffs, got, f"K1/K3 {what}")
        n += 1
    print(f"K1 resample_fwd, K3 resample_bwd (the plan's route, the tile "
          f"route and the direct route), K5 resample_coord_grad vs plain: "
          f"{n} cases each pass, max abs err {worst['resample_fwd']:.3e} / "
          f"{worst['resample_bwd']:.3e} / "
          f"{worst['resample_coord_grad']:.3e}; the K1/K3 adjoint identity "
          f"holds in float64 on every route ({n // 2} cases each); K3's "
          f"blocks on the tile route: {tally['tile']} fit their box, "
          f"{tally['direct']} took the direct branch")

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
    # the integer writeback (K2's writeback route), float32 and float64 as
    # deform computes it for a float32 or a float64 grid, on lines of 2-9,
    # 33 and 40: must agree with the twin bit for bit after each axis
    for (int_dtype, lo, hi), dtype, order, axes in itertools.product(
            ((np.uint8, 0, 256), (np.int16, -3000, 3000)),
            (torch.float32, torch.float64), (2, 3, 4, 5),
            ((40, 33), (2, 3), (4, 5), (6, 7), (8, 9))):
        x = torch.as_tensor(rs.randint(lo, hi, (2, *axes, 3)), dtype=dtype,
                            device=dev)
        got, want = x, x
        for pos in (1, 2):
            got = pf.spline_filter1d(got, order, pos, int_dtype)
            want = pf.spline_filter1d_plain(want, order, pos,
                                            int_dtype).contiguous()
            torch.cuda.synchronize()
            if not torch.equal(_bits(got), _bits(want)):
                raise AssertionError(
                    f"K2 writeback {np.dtype(int_dtype)} {dtype} "
                    f"order={order} lines {axes} axis={pos}: "
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
    _check_direct_routes(rs, worst)
    _check_narrow_table(rs)
    _check_k1_widths(rs)
    _check_bc_prefilter(rs, worst)
    _check_tile_routes(rs, worst)
    _check_k2_product(rs)
    _check_int_deform(rs)
    _check_int_resampler(rs)
    _check_int_cast(rs)
    _check_int_spline_filter(rs)
    _check_int_filters(rs)
    _check_k9_routes(rs)
    _check_k9t_routes(rs, worst)
    _check_k8t_routes(rs, worst)
    _check_k8_routes(rs, worst)
    _check_filter_kernels(rs, worst)
    _check_morph_outputs(rs)
    _check_morph_kernels(rs)
    _check_k10_box(rs, torch.device("cuda"))
    _check_k11_routes(rs, torch.device("cuda"))
    _check_k12_routes(rs, torch.device("cuda"))
    _check_k12_network_routes(rs, torch.device("cuda"))
    _check_distance_kernels(rs)
    _check_measure_kernels(rs, worst)
    return worst


def _check_coords_kernels(rs, worst):
    """K1c and K5c bit for bit against their twins, K3c per element as K3,
    and the K1c/K3c adjoint identity in float64, at coordinates up to 3x
    the extent past every edge, some exactly on the clip bounds, for the
    1-D to 4-D sweep shapes and a flat point list, one and two channels."""
    import torch
    from elasticdeform_tpu_torch.ops import resample as rsm
    from elasticdeform_tpu_torch.ops import resample_bwd as rb
    dev = torch.device("cuda")
    n = 0
    B = 2
    tally = {"tile": 0, "direct": 0}
    shapes = SWEEP_SHAPES + ((3, (11, 13, 9), (257,)),)
    for (naxis, in_sp, out_sp), dtype, C, order, mode in itertools.product(
            shapes, (torch.float32, torch.float64), (1, 2), range(6),
            range(5)):
        coeffs = torch.as_tensor(rs.rand(B, *in_sp, C) * 4 - 1, dtype=dtype,
                                 device=dev)
        ext = max(in_sp)
        cc = rs.uniform(-3 * ext, 4 * ext, (B, naxis, *out_sp))
        cc.reshape(-1)[:3] = (0.0, in_sp[0] - 1.0, -0.5)
        coords = torch.as_tensor(cc, dtype=dtype, device=dev)
        g = torch.as_tensor(rs.randn(B, *out_sp, C), dtype=dtype, device=dev)
        what = (f"naxis={naxis} out={out_sp} C={C} {dtype} order={order} "
                f"mode={MODES[mode]}")
        for name, got, want in (
                ("resample_coords_fwd",
                 rsm.resample_coords(coeffs, coords, order, mode, 1.5),
                 rsm.resample_coords_plain(coeffs, coords, order, mode,
                                           1.5)),
                ("resample_coords_grad",
                 rb.resample_coords_grad(coeffs, g, coords, order, mode),
                 rb.resample_coords_grad_plain(coeffs, g, coords, order,
                                               mode))):
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{name} {what}: not bit-identical to its plain twin, "
                    f"max abs err {float((got - want).abs().max()):.3e}")
        plans = [p for p in _k3_plans(rb, in_sp, out_sp, C, order, dtype)
                 if p is not None]
        outs = [rb.resample_coords_transpose(g, coords, order, mode, in_sp)]
        outs += [rb._launch_k3c(g, coords, order, mode, in_sp, p)
                 for p in plans]
        want = rb.resample_coords_transpose_plain(g, coords, order, mode,
                                                  in_sp)
        terms = rb.resample_coords_transpose_plain(g.abs(), coords, order,
                                                   mode, in_sp)
        torch.cuda.synchronize()
        if plans[0].route == "tile":
            _tally_boxes(tally, _bwd_boxes(coords, in_sp, order, mode,
                                           plans[0], C), plans[0])
        rtol, _ = _tol(dtype, 1.0)
        for got, route in zip(outs, ["plan"] + [p.route for p in plans]):
            worst["resample_coords_bwd"] = max(
                worst["resample_coords_bwd"],
                _assert_close(got, want, rtol, rtol * terms.double().abs(),
                              f"K3c ({route}) {what}"))
            if dtype == torch.float64:
                _check_adjoint(
                    rsm.resample_coords(coeffs, coords, order, mode, 0.0), g,
                    coeffs, got, f"K1c/K3c ({route}) {what}")
        n += 1
    _check_k3c_nan(rs)
    print(f"K1c resample_coords_fwd and K5c resample_coords_grad bit for bit "
          f"with their plain twins, K3c resample_coords_bwd (the plan's "
          f"route, the tile route and the direct route) within "
          f"{worst['resample_coords_bwd']:.3e}: {n} cases each; the K1c/K3c "
          f"adjoint identity holds in float64 on every route ({n // 2} cases "
          f"each); K3c's blocks on the tile route: {tally['tile']} fit their "
          f"box, {tally['direct']} took the direct branch")


def _smooth_coords(rs, B, in_sp, out_sp, dtype, dev, reach=2.0):
    """Coordinates that run smoothly over each input axis from ``reach``
    voxels below it to ``reach`` above, with a wobble of a quarter voxel:
    the direct route's taps fold at both edges."""
    import torch
    axes = np.meshgrid(*[np.linspace(0, 1, n) for n in out_sp],
                       indexing="ij")
    cc = np.empty((B, len(in_sp), *out_sp))
    for b in range(B):
        for h, n in enumerate(in_sp):
            cc[b, h] = -reach + axes[h] * (n - 1 + 2 * reach) + 0.25 * \
                np.sin(7.0 * sum(axes) + rs.uniform(0, 6))
    return torch.as_tensor(cc, dtype=dtype, device=dev)


def _check_direct_routes(rs, worst):
    """K3c and K3 on the direct route (``resample_direct_kernel``, one
    thread a voxel) against their twins per element to 1e-5 of the sum of
    the absolute terms (float64 1e-10): the sweep's 1-D to 4-D shapes and
    a (9, 7, 12) -> (10, 8, 30) volume, orders 0, 1 and 3, one and two
    channels, the five modes, at smooth coordinates (taps folded at both
    edges) and at coordinates up to 3x the extent outside; K3 at
    affine(j) + offset + displ with per-sample affines."""
    import torch
    from elasticdeform_tpu_torch.ops import resample_bwd as rb
    dev = torch.device("cuda")
    n = 0
    shapes = SWEEP_SHAPES + ((3, (9, 7, 12), (10, 8, 30)),)
    for (naxis, in_sp, out_sp), dtype, C, order, mode in itertools.product(
            shapes, (torch.float32, torch.float64), (1, 2), (0, 1, 3),
            range(5)):
        B = 2
        for smooth in (True, False):
            if smooth:
                coords = _smooth_coords(rs, B, in_sp, out_sp, dtype, dev)
            else:
                ext = max(in_sp)
                coords = torch.as_tensor(rs.uniform(
                    -3 * ext, 4 * ext, (B, naxis, *out_sp)), dtype=dtype,
                    device=dev)
            g = torch.as_tensor(rs.randn(B, *out_sp, C), dtype=dtype,
                                device=dev)
            want = rb.resample_coords_transpose_plain(g, coords, order, mode,
                                                      in_sp)
            terms = rb.resample_coords_transpose_plain(g.abs(), coords, order,
                                                       mode, in_sp)
            rtol, _ = _tol(dtype, 1.0)
            plan = rb._bwd_plan(in_sp, out_sp, C, order, dtype,
                                route="direct")
            got = rb._launch_k3c(g, coords, order, mode, in_sp, plan)
            torch.cuda.synchronize()
            worst["resample_coords_bwd"] = max(
                worst["resample_coords_bwd"], _assert_close(
                    got, want, rtol, rtol * terms.double().abs(),
                    f"K3c direct naxis={naxis} C={C} {dtype} "
                    f"order={order} mode={MODES[mode]} smooth={smooth}"))
            n += 1
        # K3: the coordinates from the output index, stepped voxel by voxel
        A = np.zeros((B, naxis, naxis + 1))
        A[:, :, :naxis] = np.eye(naxis) + rs.randn(B, naxis, naxis) * 0.05
        A[:, :, naxis] = rs.randn(B, naxis)
        affine = torch.as_tensor(A, dtype=dtype, device=dev)
        displ = torch.as_tensor(rs.randn(B, naxis, *out_sp) * 0.4,
                                dtype=dtype, device=dev)
        offsets = tuple(int(o) for o in rs.randint(0, 3, naxis))
        bargs = (displ, affine, offsets, order, mode)
        want = rb.resample_transpose_plain(g, *bargs, in_sp)
        terms = rb.resample_transpose_plain(g.abs(), *bargs, in_sp)
        plan = rb._bwd_plan(in_sp, out_sp, C, order, dtype, route="direct")
        got = rb._launch_k3(g, *bargs, in_sp, plan)
        torch.cuda.synchronize()
        worst["resample_bwd"] = max(worst["resample_bwd"], _assert_close(
            got, want, rtol, rtol * terms.double().abs(),
            f"K3 direct naxis={naxis} C={C} {dtype} order={order} "
            f"mode={MODES[mode]}"))
        n += 1
    print(f"K3/K3c's direct route vs plain: {n} cases pass")


def _int_cast_image(rs, shape, idt):
    """Integers of ``idt`` with a share at the type's greatest and least
    values."""
    info = np.iinfo(idt)
    lo, hi = max(int(info.min), -3000), min(int(info.max), 3000)
    x = rs.randint(lo, hi + 1, shape).astype(idt)
    x.reshape(-1)[rs.rand(x.size) < 0.2] = info.max
    x.reshape(-1)[rs.rand(x.size) < 0.1] = info.min
    return x


def _check_int_cast(rs):
    """Fault 7 on the card: the resamplers' integer outputs with NaN
    ``cval``, a NaN in the grid or among the coordinates, and inputs at
    their types' edges, int8-int64 and uint8-uint32: ``deform`` and
    ``deform_grid`` (orders 1 and 3, constant mode with a NaN ``cval``;
    mirror with a NaN grid), ``map_coordinates`` (orders 0, 1 and 3, a NaN
    ``cval`` and one NaN coordinate), ``affine_transform`` and ``shift``
    (order 1, NaN ``cval``): each equal to the same call with
    ``device="cpu"`` bit for bit."""
    import torch
    import elasticdeform_tpu_torch as et
    n = 0
    for idt in ("int8", "int16", "int32", "int64", "uint8", "uint16",
                "uint32"):
        x = _int_cast_image(rs, (20, 24), idt)
        line = _int_cast_image(rs, (30,), idt)
        grid = rs.randn(2, 3, 3) * 3
        nan_grid = grid.copy()
        nan_grid[0, 1, 1] = np.nan
        coords = rs.uniform(-2, 31, (1, 26))
        coords[0, 7] = np.nan
        coords[0, -1] = float(np.argmax(line == np.iinfo(idt).max))
        mat = np.array([[0.95, 0.2], [-0.2, 1.05]])
        calls = []
        for order in (1, 3):
            for api in ("deform", "deform_grid"):
                calls += [
                    (f"{api} cval=nan order={order}",
                     lambda d, api=api, o=order: getattr(et, api)(
                         x, grid, order=o, mode="constant", cval=np.nan,
                         device=d)),
                    (f"{api} nan grid order={order}",
                     lambda d, api=api, o=order: getattr(et, api)(
                         x, nan_grid, order=o, mode="mirror", device=d))]
        for order in (0, 1, 3):
            calls.append((f"map_coordinates order={order}",
                          lambda d, o=order: et.map_coordinates(
                              line, coords, order=o, mode="constant",
                              cval=np.nan, device=d)))
        calls += [("affine_transform", lambda d: et.affine_transform(
            x, mat, [2.5, -3.0], order=1, mode="constant", cval=np.nan,
            device=d)),
            ("shift", lambda d: et.shift(x, [2.5, -3.25], order=1,
                                         mode="constant", cval=np.nan,
                                         device=d))]
        for name, call in calls:
            got = call("cuda")
            torch.cuda.synchronize()
            want = call("cpu")
            got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
            want = want.numpy() if isinstance(want, torch.Tensor) else want
            if got.dtype != want.dtype or not np.array_equal(got, want):
                raise AssertionError(
                    f"{name} {idt}: {int((got != want).sum())} of "
                    f"{want.size} values differ from the CPU run")
            n += 1
    # cast_output alone, with CUDA's sync check raising on any sync: NaN,
    # infinities, each type's edges and the floats around 2^63
    from elasticdeform_tpu_torch.ops.resample import cast_output
    edges = [np.nan, np.inf, -np.inf, 1e30, -1e30, 2.0 ** 63, -2.0 ** 63,
             2.0 ** 63 - 1024, 2.0 ** 64, 2.0 ** 31, 2.0 ** 32, -0.5, 0.49,
             254.5]
    n_cast = 0
    for fdt, idt in itertools.product(
            (torch.float32, torch.float64),
            ("int8", "int16", "int32", "int64", "uint8", "uint16",
             "uint32", "uint64")):
        info = np.iinfo(idt)
        lo, hi = float(info.min), float(info.max)
        vals = np.concatenate([edges, [lo, hi, lo - 0.6, hi + 0.6],
                               rs.uniform(-1.2, 1.2, 200) * hi])
        t = torch.as_tensor(vals, dtype=fdt)
        tc = t.cuda()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = cast_output(tc, idt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = cast_output(t, idt)
        if got.dtype != want.dtype or not torch.equal(got.cpu(), want):
            raise AssertionError(
                f"cast_output {fdt} -> {idt}: "
                f"{int((got.cpu() != want).sum())} values differ from the "
                f"CPU run")
        n_cast += 1
    print(f"fault 7: deform, deform_grid, map_coordinates, affine_transform "
          f"and shift on int8-int64 and uint8-uint32 inputs with NaN cval, "
          f"NaN grids and coordinates and each type's edges: {n} calls "
          f"equal the CPU run bit for bit; cast_output alone on {n_cast} "
          f"float/integer pairs equal to the CPU run with no host sync "
          f"(set_sync_debug_mode('error'))")


def _check_k3c_nan(rs):
    """K3c at coordinates with a NaN, a NaN outside in constant mode (on one
    axis, outside on another) and one far outside (1e20), in the five
    modes, orders 1 and 3: a block holding either takes the direct branch,
    so the tile route's output equals the direct route's (NaN where NaN,
    which is where the twin puts it, the rest per element to 1e-5 of the
    sum of the absolute terms, float64 1e-10)."""
    import torch
    from elasticdeform_tpu_torch.ops import resample_bwd as rb
    in_sp, out_sp = (12, 10, 9), (9, 8, 10)
    n = 0
    for mode, dtype, order in itertools.product(
            range(5), (torch.float32, torch.float64), (1, 3)):
        cc = rs.uniform(-2, 12, (1, 3, *out_sp))
        cc[0, 1, 4, 3, 5] = np.nan
        cc[0, 0, 2, 2, 2], cc[0, 1, 2, 2, 2] = -1.5, np.nan
        cc[0, 2, 0, 0, 0] = 1e20
        coords = torch.as_tensor(cc, dtype=dtype, device="cuda")
        g = torch.as_tensor(rs.randn(1, *out_sp, 1), dtype=dtype,
                            device="cuda")
        plans = [rb._bwd_plan(in_sp, out_sp, 1, order, dtype, route=r)
                 for r in ("tile", "direct")]
        got = [rb._launch_k3c(g, coords, order, mode, in_sp, p)
               for p in plans]
        twin = rb.resample_coords_transpose_plain(g, coords, order, mode,
                                                  in_sp)
        terms = rb._launch_k3c(g.abs(), coords, order, mode, in_sp,
                               plans[1])
        what = (f"K3c with a NaN coordinate, mode={MODES[mode]} {dtype} "
                f"order={order}")
        rtol, _ = _tol(dtype, 1.0)
        for out, plan in zip(got, plans):
            if not torch.equal(out.isnan(), twin.isnan()):
                raise AssertionError(f"{what}: NaN elsewhere than the twin "
                                     f"puts it on {plan}")
            fin = ~twin.isnan()
            _assert_close(out[fin], got[0][fin], rtol,
                          rtol * terms[fin].double().abs(),
                          f"{what} ({plan.route})")
            n += 1
    print(f"K3c with NaN and far-outside coordinates: {n} launches on the "
          f"tile route and the direct route agree, NaN where the twin puts "
          f"it")


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


def _k1_entry(coeffs, src, affine, offsets, order, mode, cval, wide,
              coords):
    """K1 (``coords`` False: ``src`` the dense displacement) or K1c (the
    coordinates) through its C entry point with the index width ``wide``
    given, not the wrapper's: no launch is counted."""
    import torch
    from elasticdeform_tpu_torch.ops import _build
    from elasticdeform_tpu_torch.ops import resample as rsm
    lib = rsm._lib()
    C = coeffs.shape[-1]
    out = torch.empty((src.shape[0], *src.shape[2:], C), dtype=coeffs.dtype,
                      device=coeffs.device)
    dt = 0 if coeffs.dtype == torch.float32 else 1
    stream = torch.cuda.current_stream(coeffs.device).cuda_stream
    if coords:
        naxis, B, in_shape, n_out = rsm.check_coords_args("K1c", coeffs, src)
        err = lib.ed_resample_coords_fwd(
            dt, coeffs.data_ptr(), src.data_ptr(), out.data_ptr(), naxis,
            order, mode, B, C, in_shape, n_out, cval, 0, stream, wide)
    else:
        affine = rsm.check_resample_args("K1", coeffs, src, affine)
        naxis, B, in_shape, out_shape, offs, a_ptr, a_stride = \
            rsm.kernel_geometry(coeffs.shape[1:-1], src, affine, offsets)
        err = lib.ed_resample_fwd(
            dt, coeffs.data_ptr(), src.data_ptr(), a_ptr, out.data_ptr(),
            naxis, order, mode, B, C, in_shape, out_shape, offs, a_stride,
            cval, 0, stream, wide)
    _build.check(err, lib, "ed_resample_error_string", "K1/K1c")
    return out


def _check_k1_widths(rs):
    """K1 and K1c with 64-bit offsets (forced through the C entry points on
    the sweep's small shapes) bit for bit with the wrappers' 32-bit ones,
    and K1 with no affine and zero offsets bit for bit with K1c at ``iota
    + displ``: naxis 1-4, orders 0-5, the five modes, one and three
    channels, float32 and float64."""
    import torch
    from elasticdeform_tpu_torch.ops import resample as rsm
    dev = torch.device("cuda")
    n = 0
    B = 2
    for (naxis, in_sp, out_sp), dtype, C, order, mode in itertools.product(
            SWEEP_SHAPES, (torch.float32, torch.float64), (1, 3), range(6),
            range(5)):
        coeffs = torch.as_tensor(rs.rand(B, *in_sp, C) * 4 - 1, dtype=dtype,
                                 device=dev)
        displ = _smooth_displacement(rs, B, naxis, out_sp, 3.0 * max(in_sp),
                                     dtype, dev)
        A = np.zeros((B, naxis, naxis + 1))
        A[:, :, :naxis] = np.eye(naxis) + rs.randn(B, naxis, naxis) * 0.2
        A[:, :, naxis] = rs.randn(B, naxis) * 3
        affine = torch.as_tensor(A, dtype=dtype, device=dev)
        offsets = tuple(int(o) for o in rs.randint(0, 3, naxis))
        iota = torch.stack(torch.meshgrid(
            *[torch.arange(k, dtype=dtype, device=dev) for k in out_sp],
            indexing="ij"))
        coords = (iota + displ).contiguous()
        zeros = (0,) * naxis
        what = (f"naxis={naxis} C={C} {dtype} order={order} "
                f"mode={MODES[mode]}")
        for name, got, want in (
                ("K1 64-bit offsets",
                 _k1_entry(coeffs, displ, affine, offsets, order, mode, 1.5,
                           1, False),
                 rsm.resample(coeffs, displ, affine, offsets, order, mode,
                              1.5)),
                ("K1c 64-bit offsets",
                 _k1_entry(coeffs, coords, None, None, order, mode, 1.5, 1,
                           True),
                 rsm.resample_coords(coeffs, coords, order, mode, 1.5)),
                ("K1 without affine or offsets against K1c at iota + displ",
                 rsm.resample(coeffs, displ, None, zeros, order, mode, 1.5),
                 rsm.resample_coords(coeffs, coords, order, mode, 1.5))):
            torch.cuda.synchronize()
            if not torch.equal(_bits(got), _bits(want)):
                raise AssertionError(
                    f"{name} {what}: not bit-identical, max abs err "
                    f"{float((got - want).abs().max()):.3e}")
        n += 1
    print(f"K1 and K1c with 64-bit offsets bit for bit with 32-bit ones, and "
          f"K1 (no affine, zero offsets) bit for bit with K1c at iota + "
          f"displ: {n} cases each")


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


def _bits(t):
    """The tensor's bits as integers, for a bit-for-bit comparison."""
    import torch
    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.int64)


def _check_tile_routes(rs, worst):
    """K2, K4, K6 and K7 beyond the [5, 6, 3, 4] sweeps, on both routes:
    views (outer, n, inner) with inner 1, 3, 33, 64 and 100 and outers that
    make the last tile of every width partial, and lines one below, at and
    one above the tile route's cap, in float32 and float64; K2 also with the
    uint8 and int16 writebacks (its writeback route, in its tile and lines
    forms) and on c5's three axes. The wrapper is held to its plain twin
    (float32 rtol=1e-5, atol=1e-5*max|x|; float64 1e-10; the writeback
    route bit for bit, every length, both dtypes) and must take the route
    its plan names (its route count; ``"writeback"`` for an integer
    writeback); every tile width that fits must equal the lines route (the
    lines form) bit for bit; the K2/K4 and K6/K7 adjoint identities hold in
    float64."""
    import torch
    from elasticdeform_tpu_torch.ops import prefilter as pf
    dev = torch.device("cuda")
    kinds = (("K2", "spline_prefilter", "mirror", None),
             ("K2", "spline_prefilter", "mirror", np.uint8),
             ("K2", "spline_prefilter", "mirror", np.int16),
             ("K4", "spline_prefilter_transpose", "mirror", None),
             ("K6", "spline_prefilter_bc", "reflect", None),
             ("K6", "spline_prefilter_bc", "wrap", None),
             ("K7", "spline_prefilter_bc_transpose", "reflect", None),
             ("K7", "spline_prefilter_bc_transpose", "wrap", None))
    shapes = [(outer, n, inner) for inner, outer in
              ((1, 131), (3, 23), (33, 5), (64, 3), (100, 2))
              for n in (9, 64, 224)]
    for dtype in (torch.float32, torch.float64):
        cap = pf.tile_cap(dtype)
        shapes += [(3, n, 5) for n in (cap - 1, cap, cap + 1)]
        shapes += [(2, n, 1) for n in (cap - 1, cap, cap + 1)]
    # c5's three axes of (64, 64, 64, 64, 1)
    shapes += [(64, 64, 4096), (4096, 64, 64), (262144, 64, 1)]
    wrappers = {"K2": (pf.spline_filter1d, pf.spline_filter1d_plain),
                "K4": (pf.spline_filter1d_transpose,
                       pf.spline_filter1d_transpose_plain),
                "K6": (pf.spline_filter1d_bc, pf.spline_filter1d_bc_plain),
                "K7": (pf.spline_filter1d_bc_transpose,
                       pf.spline_filter1d_bc_transpose_plain)}
    n_cases = n_bits = 0
    for (outer, n, inner), dtype, order, (k, name, bc, idt) in \
            itertools.product(shapes, (torch.float32, torch.float64),
                              (2, 3, 4, 5), kinds):
        if n > 224 and order in (2, 4):
            continue    # long lines: orders 3 and 5 (one and two poles)
        if outer * inner > 4096 and (order != 3 or idt is not None):
            continue    # c5's axes: order 3, no writeback
        if idt is None:
            x = torch.as_tensor(rs.rand(outer, n, inner) * 200 - 50,
                                dtype=dtype, device=dev)
        else:
            x = torch.as_tensor(rs.randint(-3000, 3000, (outer, n, inner)),
                                dtype=dtype, device=dev)
        what = (f"{k} {bc} {dtype} order={order} (outer, n, inner)="
                f"{(outer, n, inner)}" + (f" writeback {np.dtype(idt)}"
                                          if idt is not None else ""))
        plan = pf._plan_for(x, 1)
        wrapper, plain = wrappers[k]
        args = (idt,) if k == "K2" else () if k == "K4" else (bc,)
        route = "writeback" if idt is not None else plan.route
        before = dict(wrapper.routes)
        got = wrapper(x, order, 1, *args)
        want = plain(x, order, 1, *args)

        def launch(p, k=k, x=x, order=order, bc=bc, idt=idt):
            if k == "K2":
                return pf._launch_filter(x, order, 1, p, idt)
            if k == "K6":
                return pf._launch_bc_filter(x, order, 1, bc, p)
            return pf._launch_transpose(x, order, 1, bc, p)
        if wrapper.routes[route] != before[route] + 1:
            raise AssertionError(f"{what}: the wrapper did not count a "
                                 f"launch on the {route} route")
        if plan.route != ("tile" if n <= pf.tile_cap(dtype) else "lines"):
            raise AssertionError(f"{what}: plan {plan} on the wrong route")
        torch.cuda.synchronize()
        if idt is None:
            worst[name] = max(worst[name], _assert_close(
                got, want, *_tol(dtype, float(x.abs().max())), what))
        elif not torch.equal(_bits(got), _bits(want)):
            raise AssertionError(f"{what}: {int((got != want).sum())} "
                                 "values differ from the plain twin")
        ref = launch(pf._tile_plan(outer, n, inner, dtype, route="lines"))
        for width in pf.TILE_WIDTHS:
            try:
                tp = pf._tile_plan(outer, n, inner, dtype, width=width,
                                   route="tile")
            except ValueError:      # the tile does not fit shared memory
                continue
            tile = launch(tp)
            torch.cuda.synchronize()
            if not torch.equal(_bits(tile), _bits(ref)):
                raise AssertionError(
                    f"{what}: tile route W={width} ({tp}) differs from the "
                    f"lines route in {int((tile != ref).sum())} values")
            n_bits += 1
        if dtype == torch.float64 and n <= 224 and k in ("K4", "K7") and \
                outer * inner <= 4096:
            y = torch.as_tensor(rs.randn(outer, n, inner), dtype=dtype,
                                device=dev)
            fwd = (pf.spline_filter1d(x, order, 1) if bc == "mirror" else
                   pf.spline_filter1d_bc(x, order, 1, bc))
            back = (pf.spline_filter1d_transpose(y, order, 1) if bc ==
                    "mirror" else
                    pf.spline_filter1d_bc_transpose(y, order, 1, bc))
            _check_adjoint(fwd, y, x, back, f"{what} adjoint")
        n_cases += 1
    print(f"K2, K4, K6 and K7 over inner 1/3/33/64/100, partial last tiles, "
          f"lines at the tile cap (float32 {pf.tile_cap(torch.float32)}, "
          f"float64 {pf.tile_cap(torch.float64)}) and one above, c5's three "
          f"axes, K2's writeback route with uint8 and int16 bit for bit: "
          f"{n_cases} cases pass against their twins; {n_bits} tile launches "
          f"(W {'/'.join(map(str, pf.TILE_WIDTHS))}) equal the lines route "
          f"bit for bit; the adjoint identities hold in float64")


# K2's writeback product checks: views (outer, n, inner) of c2's and 128^3's
# axes, packed (inner < 64) and strided, partial bands and tiles, lines
# at the tile cap and past it
_K2_PRODUCT_VIEWS = ((1, 200, 300), (200, 300, 1), (1, 128, 16384),
                     (128, 128, 128), (16384, 128, 1), (3, 5, 1), (2, 33, 3),
                     (5, 64, 63), (3, 65, 64), (2, 100, 65), (7, 31, 2),
                     (4, 1, 7), (3, 880, 1), (2, 881, 5), (2, 1761, 1),
                     (1, 1760, 3))
_K2_PRODUCT_INTS = (np.int8, np.uint8, np.int16, np.uint16, np.int32,
                    np.uint32, np.int64)


def _check_k2_product(rs):
    """K2's writeback route in its product form (``writeback_product_kernel``)
    against its rows route (``writeback_rows``, in the tile or lines form
    of the view's plan) and the twin ``_row_sums``, bit for bit: float32 and
    float64; the int8-int64 and uint8-uint32 writebacks and ``int_bits`` 0
    (the fixed-order sums); the mirror table and ``filter_matrix_bc``'s
    reflect and wrap; the chunk skip on (integer inputs, up to int32's
    edges for the wide types) and off (inputs holding NaN and infinities,
    NaN where the twin puts it); every view of :data:`_K2_PRODUCT_VIEWS`.
    The wrapper must take the product form and count it."""
    import torch
    from elasticdeform_tpu_torch.ops import prefilter as pf
    from elasticdeform_tpu_torch.ops.resample import cast_int_c
    dev = torch.device("cuda")
    kinds = ([("mirror", None, True), ("mirror", None, False),
              ("reflect", None, True), ("wrap", None, False)] +
             [("mirror", t, True) for t in _K2_PRODUCT_INTS])
    n_cases = n_skip = 0
    for (outer, n, inner), dtype in itertools.product(
            _K2_PRODUCT_VIEWS, (torch.float32, torch.float64)):
        big = outer * n * inner > 10 ** 6 or n > 800
        for i, (bc, idt, finite) in enumerate(kinds):
            if big and i % 3 != (n + inner) % 3:
                continue    # large views: a third of the kinds each
            order = (2, 3, 4, 5)[(i + n) % 4]
            if finite:
                info = np.iinfo(idt or np.int16)
                lo, hi = max(info.min, -2 ** 31), min(info.max, 2 ** 31 - 1)
                a = rs.randint(lo, hi, (outer, n, inner), dtype=np.int64)
                a.reshape(-1)[:2] = (lo, hi)
            else:
                a = rs.rand(outer, n, inner) * 2000 - 1000
                a.reshape(-1)[rs.randint(a.size, size=3)] = (np.nan, np.inf,
                                                              -np.inf)
            x = torch.as_tensor(a, dtype=dtype, device=dev)
            what = (f"K2 writeback product {dtype} {bc} order={order} "
                    f"(outer, n, inner)={(outer, n, inner)} int="
                    f"{None if idt is None else np.dtype(idt)} "
                    f"finite={finite}")
            plan = pf._writeback_plan(outer, n, inner, dtype,
                                      sms=pf._sm_count(dev))
            if plan.route != "product":
                raise AssertionError(f"{what}: plan {plan}")
            got = pf._launch_writeback(x, order, 1, bc, plan, idt, finite)
            rows = pf._launch_writeback(x, order, 1, bc, plan.rows, idt)
            want = pf._row_sums(x, pf._filter_table(n, order, dtype, dev, bc),
                                1)
            if idt is not None:
                want = cast_int_c(want, idt)
            torch.cuda.synchronize()
            for other, label in ((want, "_row_sums"), (rows, "rows route")):
                if not (torch.equal(torch.isnan(got), torch.isnan(other)) and
                        torch.equal(_bits(torch.nan_to_num(got)),
                                    _bits(torch.nan_to_num(other)))):
                    raise AssertionError(
                        f"{what}: {int((got != other).sum())} values differ "
                        f"from the {label}")
            n_cases += 1
            n_skip += finite
    # the wrapper: an integer writeback and the fixed-order sums take the
    # product form and count it
    x = torch.as_tensor(rs.randint(0, 256, (1, 200, 300, 1)),
                        dtype=torch.float64, device=dev)
    before = dict(pf.spline_filter1d.writeback_routes)
    for a in (1, 2):
        pf.spline_filter1d(x, 3, a, np.uint8)
    pf.spline_filter1d_bc(x, 3, 1, "reflect", True)
    if pf.spline_filter1d.writeback_routes["product"] != before["product"] + 2:
        raise AssertionError("K2's wrapper did not count its writeback "
                             "launches on the product form")
    print(f"K2 writeback product bit for bit with its rows route and "
          f"_row_sums in {n_cases} cases ({n_skip} with the chunk skip; "
          f"float32 and float64, int8-int64 / uint8-uint32 writebacks and "
          f"the fixed-order sums, mirror / reflect / wrap tables, "
          f"{len(_K2_PRODUCT_VIEWS)} views up to the tile cap and past it); "
          f"the wrapper counts the product form")


# the integer deform check's inputs: 1-D to 3-D, axes of 2, 3, 5, 8, 9,
# 33 and 64
_INT_DEFORM_SHAPES = ((2,), (33,), (64,), (2, 9), (5, 8), (3, 33), (64, 9),
                     (2, 3, 5), (8, 9, 33), (5, 64, 2))


def _check_int_deform(rs):
    """``deform`` (tensor API) and ``deform_grid`` (numpy API) with uint8
    and int16 inputs at orders 2-5, the prefilter on, computing in float32
    (a float32 grid) and float64 (a float64 grid), on 1-D to 3-D inputs
    with axes of 2, 3, 5, 8, 9, 33 and 64 and on one 512 x 512 uint8 image
    at order 3: each output equal to the same call with ``device="cpu"``
    bit for bit, and each call's integer prefilter on K2's writeback route,
    once per deformed axis (its count). The dense displacement, which
    places every sample and which an integer output sums in one fixed
    order, is held to the CPU's bit for bit too."""
    import torch
    import elasticdeform_tpu_torch as et
    from elasticdeform_tpu_torch.ops import prefilter as pf
    from elasticdeform_tpu_torch.ops.displacement import dense_displacement
    cases = [(shape, idt, order, gdt) for shape, idt, order, gdt in
             itertools.product(_INT_DEFORM_SHAPES, ("uint8", "int16"),
                               (2, 3, 4, 5), (np.float32, np.float64))]
    cases += [((512, 512), "uint8", 3, gdt)
              for gdt in (np.float32, np.float64)]
    n = 0
    for i, (shape, idt, order, gdt) in enumerate(cases):
        lo, hi = (0, 256) if idt == "uint8" else (-3000, 3000)
        x = rs.randint(lo, hi, shape).astype(idt)
        grid = (rs.randn(len(shape), *(3,) * len(shape)) *
                max(1.0, min(shape) / 4)).astype(gdt)
        mode = MODES[i % len(MODES)]
        what = (f"{idt} {shape} order={order} {np.dtype(gdt).name} grid "
                f"mode={mode}")
        displ = [dense_displacement(torch.as_tensor(grid, device=d)[None],
                                    shape, shape, (0,) * len(shape), True)
                 for d in ("cuda", "cpu")]
        if not torch.equal(_bits(displ[0].cpu()), _bits(displ[1])):
            raise AssertionError(f"{what}: the dense displacement differs "
                                 "from the CPU's")
        for api in ("deform", "deform_grid"):
            fn = getattr(et, api)
            before = pf.spline_filter1d.routes["writeback"]
            got = fn(x, grid, order=order, mode=mode, device="cuda")
            torch.cuda.synchronize()
            took = pf.spline_filter1d.routes["writeback"] - before
            want = fn(x, grid, order=order, mode=mode, device="cpu")
            got = got.cpu().numpy() if api == "deform" else got
            want = want.numpy() if api == "deform" else want
            if took != len(shape):
                raise AssertionError(f"{api} {what}: {took} launches on K2's "
                                     f"writeback route, not {len(shape)}")
            if got.dtype != want.dtype or not np.array_equal(got, want):
                raise AssertionError(
                    f"{api} {what}: {int((got != want).sum())} of "
                    f"{want.size} values differ from the CPU run (max "
                    f"|diff| {np.abs(got.astype(np.int64) - want).max()})")
            n += 1
    print(f"deform and deform_grid with uint8 and int16 inputs, orders 2-5, "
          f"float32 and float64 compute, 1-D to 3-D (axes 2-64) and a "
          f"512x512 uint8 image: {n} calls equal the CPU run bit for bit, "
          f"each prefilter axis on K2's writeback route")


def _check_int_resampler(rs):
    """The general resampler on integer inputs: ``affine_transform``,
    ``zoom``, ``rotate``, ``shift`` and ``map_coordinates`` with uint8 and
    int16 inputs, orders 0, 1 and 3, a legacy mode (mirror) and a modern
    one (reflect; grid-wrap for ``map_coordinates``), 2-D and 3-D: each
    output equal to the same call with ``device="cpu"`` bit for bit, and at
    order 3 each deformed axis's prefilter on the fixed-order route (K2's
    writeback route with no cast, on ``filter_matrix`` or
    ``filter_matrix_bc``: its count). First that route alone, K2 and K6
    under each boundary condition, bit for bit with its twin on lines of
    2-9, 33, 40 and 300."""
    import torch
    import elasticdeform_tpu_torch as et
    from elasticdeform_tpu_torch.ops import prefilter as pf
    n = 0
    for dtype, order, bc, length in itertools.product(
            (torch.float32, torch.float64), (2, 3, 4, 5),
            ("mirror", "reflect", "wrap"), (2, 5, 9, 33, 40, 300)):
        x = torch.as_tensor(rs.randint(-3000, 3000, (3, length, 7)),
                            dtype=dtype, device="cuda")
        if bc == "mirror":
            got = pf.spline_filter1d(x, order, 1, fixed_order=True)
            want = pf.spline_filter1d_plain(x, order, 1, fixed_order=True)
        else:
            got = pf.spline_filter1d_bc(x, order, 1, bc, True)
            want = pf.spline_filter1d_bc_plain(x, order, 1, bc, True)
        torch.cuda.synchronize()
        if not torch.equal(_bits(got), _bits(want.contiguous())):
            raise AssertionError(
                f"fixed-order prefilter {bc} {dtype} order={order} "
                f"n={length}: {int((got != want).sum())} values differ from "
                f"its twin")
        n += 1
    print(f"K2 and K6 on the fixed-order route (mirror, reflect, wrap), "
          f"orders 2-5, float32 and float64: {n} cases bit for bit with "
          f"their twins")
    routes = (pf.spline_filter1d.routes, pf.spline_filter1d_bc.routes)
    n = 0
    for shape, idt, order, legacy in itertools.product(
            ((37, 45), (17, 20, 23)), ("uint8", "int16"), (0, 1, 3),
            (True, False)):
        lo, hi = (0, 256) if idt == "uint8" else (-3000, 3000)
        x = rs.randint(lo, hi, shape).astype(idt)
        nd = len(shape)
        ang = np.deg2rad(12.0)
        mat = np.eye(nd) * 1.1
        mat[:2, :2] = [[np.cos(ang) * 1.1, np.sin(ang)],
                       [-np.sin(ang), np.cos(ang) * 1.1]]
        off = rs.uniform(-3, 3, nd)
        coords = np.stack([rs.uniform(-3, n + 3, shape) for n in shape])
        mode = "mirror" if legacy else "reflect"
        calls = (
            ("affine_transform", lambda d: et.affine_transform(
                x, mat, off, order=order, mode=mode, device=d)),
            ("zoom", lambda d: et.zoom(x, 1.3, order=order, mode=mode,
                                       device=d)),
            ("rotate", lambda d: et.rotate(x, 17.0, axes=(1, 0),
                                           order=order, mode=mode,
                                           device=d)),
            ("shift", lambda d: et.shift(x, off, order=order, mode=mode,
                                         device=d)),
            ("map_coordinates", lambda d: et.map_coordinates(
                x, coords, order=order,
                mode="mirror" if legacy else "grid-wrap", device=d)))
        for name, call in calls:
            before = sum(r["writeback"] for r in routes)
            got = call("cuda")
            torch.cuda.synchronize()
            took = sum(r["writeback"] for r in routes) - before
            want = call("cpu")
            got, want = got.cpu(), torch.as_tensor(want)
            what = f"{name} {idt} {shape} order={order} " \
                   f"{'legacy' if legacy else 'modern'} mode"
            if got.dtype != want.dtype or got.shape != want.shape or \
                    not torch.equal(got, want):
                diff = (got.long() - want.long()).abs() \
                    if got.shape == want.shape else None
                raise AssertionError(
                    f"{what}: differs from the CPU run "
                    f"({got.dtype} {tuple(got.shape)} vs {want.dtype} "
                    f"{tuple(want.shape)}; "
                    + ("" if diff is None else
                       f"{int((diff > 0).sum())} of {diff.numel()} values, "
                       f"max |diff| {int(diff.max())}") + ")")
            axes = 2 if name == "rotate" else nd
            if took != (axes if order > 1 else 0):
                raise AssertionError(f"{what}: {took} prefilter launches on "
                                     f"the fixed-order route, not {axes}")
            n += 1
    print(f"affine_transform, zoom, rotate, shift and map_coordinates with "
          f"uint8 and int16 inputs, orders 0, 1 and 3, a legacy and a "
          f"modern mode, 2-D and 3-D: {n} calls equal the CPU run bit for "
          f"bit, each prefilter axis at order 3 on the fixed-order route")


_INT_SPLINE_SHAPES = ((2,), (9,), (64,), (5, 8), (33, 2), (3, 9, 17),
                      (64, 3, 5))


def _runs_image(rs, shape, idt):
    """An integer image of constant runs (2-40 samples) at a few levels:
    the filter maps a run onto values on or next to integers, which a
    truncating cast sees."""
    levels = (0, 50, 100, 150) if idt == "uint8" else \
        (-3000, -100, 0, 700, 2500)
    flat = np.empty(math.prod(shape), dtype=idt)
    i = 0
    while i < flat.size:
        n = int(rs.randint(2, 41))
        flat[i:i + n] = levels[rs.randint(len(levels))]
        i += n
    return flat.reshape(shape)


def _check_int_spline_filter(rs):
    """Fault 5: ``spline_filter`` and ``spline_filter1d`` into a uint8 or
    int16 ``output=`` array, orders 2-5, every mode name (mirror, reflect,
    wrap and their aliases), 1-D to 3-D images of constant runs with axes
    of 2-64 and one 512 x 512 image: each output equal to the same call
    with ``device="cpu"`` bit for bit, each filtered axis on the
    fixed-order route (its count)."""
    import torch
    import elasticdeform_tpu_torch as et
    from elasticdeform_tpu_torch import core as tc
    from elasticdeform_tpu_torch.ops import prefilter as pf
    routes = (pf.spline_filter1d.routes, pf.spline_filter1d_bc.routes)
    cases = list(itertools.product(_INT_SPLINE_SHAPES, ("uint8", "int16"),
                                   (2, 3, 4, 5), sorted(tc._SPLINE_BC)))
    cases += [((512, 512), "uint8", order, mode) for order, mode in
              zip((2, 3, 4, 5), ("mirror", "reflect", "grid-wrap",
                                 "nearest"))]
    n = 0
    for shape, idt, order, mode in cases:
        x = _runs_image(rs, shape, idt)
        axis = int(rs.randint(len(shape)))
        for name, call, axes in (
                ("spline_filter1d", lambda d: et.spline_filter1d(
                    x, order=order, axis=axis, mode=mode,
                    output=np.empty(shape, idt), device=d), 1),
                ("spline_filter", lambda d: et.spline_filter(
                    x, order=order, mode=mode, output=np.empty(shape, idt),
                    device=d), len(shape))):
            before = sum(r["writeback"] for r in routes)
            got = call("cuda")
            torch.cuda.synchronize()
            took = sum(r["writeback"] for r in routes) - before
            want = call("cpu")
            what = f"{name} {idt} {shape} order={order} mode={mode}"
            if got.dtype != want.dtype or not np.array_equal(got, want):
                raise AssertionError(
                    f"{what}: {int((got != want).sum())} of {want.size} "
                    f"values differ from the CPU run")
            if took != axes:
                raise AssertionError(f"{what}: {took} prefilter launches on "
                                     f"the fixed-order route, not {axes}")
            n += 1
    print(f"spline_filter and spline_filter1d into uint8 and int16 output "
          f"arrays, orders 2-5, every mode name, 1-D to 3-D (axes 2-64) and "
          f"a 512x512 image: {n} calls equal the CPU run bit for bit, each "
          f"filtered axis on the fixed-order route")


_INT_FILTER_SHAPES = ((2,), (40,), (5, 8), (33, 9), (3, 9, 17),
                      (12, 5, 33))


def _int_filter_calls(rs, shape, idt):
    """The filter tier's calls into integer ``output=`` arrays on an
    ``idt`` image of ``shape`` (``_check_int_filters``): ``(label, call,
    {kernel: launches on the card})``, each call taking ``(mode, device)``.
    The N-D kernels hold small positive sevenths, so a constant run sums to
    a value on or next to an integer; ``correlate1d`` takes a kernel that
    is neither symmetric nor antisymmetric (K8's direct route)."""
    import elasticdeform_tpu_torch as et
    x = _runs_image(rs, shape, idt)
    nd = len(shape)
    kshape = tuple(int(k) for k in rs.randint(2, 5, nd))
    w = rs.randint(1, 5, kshape) / 7.0
    origin = [int(rs.randint(-(k // 2), (k - 1) // 2 + 1)) for k in kshape]
    w1 = np.array([0.3, 1.1, -0.2, 0.5, 0.4])
    axis = int(rs.randint(nd))
    xf = (rs.randn(*shape) * 300).astype(np.float32)
    outs = ("uint8", "int16", "int32")
    calls = []
    for odt in outs:
        calls += [
            (f"correlate {odt}", lambda m, d, odt=odt: et.correlate(
                x, w, mode=m, cval=2.5, origin=origin,
                output=np.empty(shape, odt), device=d),
             {"correlate_nd": 1}),
            (f"convolve {odt}", lambda m, d, odt=odt: et.convolve(
                x, w, mode=m, cval=2.5, origin=origin,
                output=np.empty(shape, odt), device=d),
             {"correlate_nd": 1})]
    odt = outs[int(rs.randint(3))]
    calls += [
        (f"correlate1d {odt} axis={axis}", lambda m, d: et.correlate1d(
            x, w1, axis, mode=m, cval=2.5, output=np.empty(shape, odt),
            device=d), {"correlate1d": 1}),
        ("gaussian_filter float32 -> int16", lambda m, d: et.gaussian_filter(
            xf, 1.3, mode=m, cval=2.5, output=np.empty(shape, "int16"),
            device=d), {"correlate1d": nd}),
        (f"uniform_filter {odt}", lambda m, d: et.uniform_filter(
            x, 3, mode=m, cval=2.5, output=np.empty(shape, odt), device=d),
         {"correlate1d": nd}),
        (f"sobel {odt} axis={axis}", lambda m, d: et.sobel(
            x, axis, mode=m, cval=2.5, output=np.empty(shape, odt),
            device=d), {"correlate1d": nd}),
        (f"prewitt {odt} axis={axis}", lambda m, d: et.prewitt(
            x, axis, mode=m, cval=2.5, output=np.empty(shape, odt),
            device=d), {"correlate1d": nd})]
    return calls


def _check_int_filters(rs):
    """Step 0 of the filter tier's integer outputs: ``correlate`` and
    ``convolve`` (K9) into uint8, int16 and int32 ``output=`` arrays,
    ``correlate1d`` on K8's direct route, ``gaussian_filter`` of a float32
    input into int16, ``uniform_filter``, ``sobel`` and ``prewitt`` into
    integer arrays, in every filter mode (N-D calls also the ``grid-*``
    aliases), 1-D to 3-D images of constant runs and one 512 x 512 image:
    each output equal to the same call with ``device="cpu"`` bit for bit,
    each card call with the launches it needs, K9's all on its tile
    route."""
    import torch
    from elasticdeform_tpu_torch.ops import filters as ft
    images = [(shape, idt) for shape in _INT_FILTER_SHAPES
              for idt in ("uint8", "int16")] + [((512, 512), "int16")]
    k9 = dict(ft.correlate_nd.routes)
    n = 0
    for shape, idt in images:
        for label, call, need in _int_filter_calls(rs, shape, idt):
            modes = MODES + (("grid-mirror", "grid-wrap", "grid-constant")
                             if label.startswith(("correlate ", "convolve"))
                             else ())
            for mode in modes:
                before = _counts()
                got = call(mode, "cuda")
                torch.cuda.synchronize()
                took = {k: _counts()[k] - before[k] for k in need}
                want = call(mode, "cpu")
                what = f"{label} {idt} {shape} mode={mode}"
                if got.dtype != want.dtype or not np.array_equal(got, want):
                    raise AssertionError(
                        f"{what}: {int((got != want).sum())} of {want.size} "
                        f"values differ from the CPU run")
                if took != need:
                    raise AssertionError(f"{what}: launches {took}, not "
                                         f"{need}")
                n += 1
    k9 = {r: v - k9[r] for r, v in ft.correlate_nd.routes.items()}
    if k9["nd"] or not k9["tile"]:
        raise AssertionError(f"K9 must take its tile route here: {k9}")
    print(f"correlate and convolve (K9, {k9['tile']} launches on its tile "
          f"route) into uint8/int16/int32, correlate1d "
          f"on K8's direct route, gaussian_filter float32 -> int16, "
          f"uniform_filter, sobel and prewitt into integer arrays, every "
          f"mode, 1-D to 3-D and a 512x512 image: {n} calls equal the CPU "
          f"run bit for bit")


def _check_k9t_routes(rs, worst):
    """K9T on both routes: the tile route at every column (C 1/2/4/8) held
    per element to the twin and to the nd route (1e-5 of the sum of the
    absolute terms landing there, float32; 1e-10 float64), and the wrapper
    to its route count; at c14's shapes (160x192x224, a 5^3 kernel at
    origin (1, 0, -1); a 3^3 kernel on a (2, 160, 192, 224) batch), in every
    mode; a 2-D and a rank-4 batch-merged case; a sparse 3x2x4 kernel at
    extreme origins; kernels longer than an axis; float64 too. The K9/K9T
    adjoint identity holds in float64 on the small cases."""
    import torch
    from elasticdeform_tpu_torch.ops import filters as ft
    dev = torch.device("cuda")
    modes = ("reflect", "constant", "nearest", "mirror", "wrap")
    w5 = rs.randn(5, 5, 5)
    w3 = rs.randn(1, 3, 3, 3)
    sparse = rs.randn(3, 2, 4) * (rs.rand(3, 2, 4) > 0.5)
    sparse[0, 0, 0] = 0.0       # a zero first tap
    sparse[2, 1, 3] = 1.5
    cases = [((160, 192, 224), w5, (3, 2, 1)),
             ((2, 160, 192, 224), w3, (0, 1, 1, 1)),
             ((37, 300), rs.randn(5, 3), (2, 1)),
             ((2, 9, 10, 11), rs.randn(1, 3, 3, 3), (0, 2, 0, 1)),
             ((9, 10, 11), sparse, (0, 1, 3)),
             ((9, 10, 11), sparse, (2, 0, 0)),
             ((5, 3, 40), rs.randn(7, 1, 5), (6, 0, 0)),
             ((3, 4, 9), rs.randn(5, 6, 3), (2, 5, 1))]
    n = exact = 0
    for (shape, w, centers), dtype, mode in itertools.product(
            cases, (torch.float32, torch.float64), modes):
        big = math.prod(shape) > 10 ** 6
        if big and dtype == torch.float64 and mode != "mirror":
            continue    # c14's shapes: float32 in every mode, float64 once
        g = torch.as_tensor(rs.randn(*shape), dtype=dtype, device=dev)
        what = f"K9T {dtype} {mode} shape={shape} kernel={w.shape} " \
            f"centres={centers}"
        want = ft.correlate_nd_transpose_plain(g, w, centers, mode)
        terms = ft.correlate_nd_transpose_plain(g.abs(), np.abs(w), centers,
                                                mode)
        rtol, atol = _terms_tol(dtype, terms)
        plan = ft._nd_plan(tuple(shape), w.shape, dtype)
        if plan.route != "tile":
            raise AssertionError(f"{what}: plan {plan}, not the tile route")
        before = dict(ft.correlate_nd_transpose.routes)
        got = ft.correlate_nd_transpose(g, w, centers, mode)
        if ft.correlate_nd_transpose.routes["tile"] != before["tile"] + 1:
            raise AssertionError(f"{what}: the wrapper did not count a tile "
                                 "launch")
        nd = ft._launch_nd_transpose(g, w, centers, mode,
                                     ft._nd_plan(shape, w.shape,
                                                           dtype, route="nd"))
        torch.cuda.synchronize()
        worst["correlate_nd_transpose"] = max(
            worst["correlate_nd_transpose"],
            _assert_close(got, want, rtol, atol, f"{what} vs plain"),
            _assert_close(got, nd, rtol, atol, f"{what} vs the nd route"))
        exact += int(torch.equal(got, nd))
        for c in ft.TILE_COLUMNS:
            tp = ft._nd_plan(shape, w.shape, dtype, column=c,
                                       route="tile")
            t = ft._launch_nd_transpose(g, w, centers, mode, tp)
            torch.cuda.synchronize()
            _assert_close(t, nd, rtol, atol, f"{what} C={c} vs the nd route")
            exact += int(torch.equal(t, nd))
            n += 1
        if dtype == torch.float64 and not big:
            x = torch.as_tensor(rs.rand(*shape), dtype=dtype, device=dev)
            _check_adjoint(ft.correlate_nd(x, w, centers, mode, 0.0), g, x,
                           got, f"K9/K9T {what}")
        del g, want, terms, nd, got
    print(f"K9T tile route (C {'/'.join(map(str, ft.TILE_COLUMNS))}) at c14's "
          f"shapes, 2-D, rank 4 and sparse kernels, every mode: {n} launches "
          f"within 1e-5 of the sum of their absolute terms of the twin and "
          f"the nd route ({exact} equal to the nd route); the K9/K9T adjoint "
          f"identity holds in float64")


def _check_k8t_routes(rs, worst):
    """K8T on both routes: the tile route at every width (W 32/64/128) bit
    for bit with the lines route and within 1e-5 of the sum of the absolute
    terms of the twin (float32; 1e-10 float64), the wrapper on the plan's
    route and its count; over the five modes, lines of 1, 2, 9, 100, 224 and
    the tile cap (and one past it, which takes the lines route), inner 1, 3,
    33, 64 and 100 (packed tiles, column tiles with a partial last one),
    1-41 taps (longer than some lines) at the first, middle and last
    centre, float32 and float64; c11's three axes in every mode; the K8/K8T
    adjoint identity in float64 to 1e-10; a repeated call uploads nothing
    (its tables come from the cache)."""
    import torch
    from elasticdeform_tpu_torch.ops import filters as ft
    from elasticdeform_tpu_torch.ops import prefilter as pf
    dev = torch.device("cuda")
    cases = []
    for dtype in (torch.float32, torch.float64):
        cap = pf.tile_cap(dtype)
        for n, inner in ((1, 64), (2, 3), (9, 1), (9, 33), (100, 100),
                         (224, 1), (cap, 1), (cap, 64), (cap + 1, 3)):
            outer = max(1, min(6, 40000 // (n * inner)))
            cases.append(((outer, n, inner), 1, dtype))
    c11 = (3, 160, 192, 224)
    cases += [(c11, a, torch.float32) for a in (1, 2, 3)]
    n = exact = 0
    for (shape, axis, dtype), mode in itertools.product(cases, MODES):
        big = math.prod(shape) > 10 ** 6
        g = torch.as_tensor(rs.randn(*shape), dtype=dtype, device=dev)
        x = torch.as_tensor(rs.rand(*shape), dtype=dtype, device=dev)
        outer, ln, inner = pf._lines(g, axis)
        kernels = ((17, 8),) if big else ((1, 0), (4, 0), (4, 3), (17, 8),
                                          (41, 20), (41, 40))
        for L, c in kernels:
            w = ft.gaussian_weights(2.0, 0, 4.0, None) if L == 17 else \
                rs.randn(L)
            what = f"K8T {dtype} {mode} shape={shape} axis={axis} taps={L} " \
                f"centre={c}"
            want = ft.correlate1d_transpose_plain(g, w, axis, mode, c)
            terms = ft.correlate1d_transpose_plain(g.abs(), np.abs(w), axis,
                                                   mode, c)
            tol = _terms_tol(dtype, terms)
            e = ft._k8t_edges(ln, L, c, mode)
            plan = ft._line_plan(outer, ln, inner, dtype, L,
                                           len(e.table))
            # past the cap the lines route; at the cap a column tile leaves
            # no room for the taps and the table, so either
            if (ln > pf.tile_cap(dtype)) != (plan.route == "lines") and \
                    (ln <= 224 or ln > pf.tile_cap(dtype)):
                raise AssertionError(f"{what}: plan {plan}")
            before = dict(ft.correlate1d_transpose.routes)
            got = ft.correlate1d_transpose(g, w, axis, mode, c)
            if ft.correlate1d_transpose.routes[plan.route] != \
                    before[plan.route] + 1:
                raise AssertionError(f"{what}: the wrapper did not count a "
                                     f"{plan.route} launch")
            lines = ft._launch_line_transpose(g, w, axis, mode, c,
                                              ft.LinePlan("lines"))
            torch.cuda.synchronize()
            worst["correlate1d_transpose"] = max(
                worst["correlate1d_transpose"],
                _assert_close(got, want, *tol, f"{what} vs plain"),
                _assert_close(lines, want, *tol, f"{what} lines vs plain"))
            exact += int(torch.equal(_bits(got), _bits(want)))
            if plan.route == "tile":
                for W in pf.TILE_WIDTHS:
                    t = ft._launch_line_transpose(
                        g, w, axis, mode, c, ft._line_plan(
                            outer, ln, inner, dtype, L, len(e.table),
                            width=W))
                    torch.cuda.synchronize()
                    if not torch.equal(_bits(t), _bits(lines)):
                        raise AssertionError(
                            f"{what} W={W}: the tile route differs from the "
                            f"lines route in "
                            f"{int((_bits(t) != _bits(lines)).sum())} "
                            "values")
                    n += 1
            if dtype == torch.float64 and not big:
                _check_adjoint(ft.correlate1d(x, w, axis, mode, 0.0, c), g,
                               x, got, f"K8/K8T {what}")
            del want, terms, got, lines
    # a repeated call uploads nothing: its tables come from the cache
    g = torch.as_tensor(rs.randn(3, 40, 50), dtype=torch.float32, device=dev)
    w = rs.randn(9)
    ft.correlate1d_transpose(g, w, 1, "mirror", 4)
    misses = ft._k8t_tables.cache_info().misses
    ft.correlate1d_transpose(g, w, 1, "mirror", 4)
    if ft._k8t_tables.cache_info().misses != misses:
        raise AssertionError("K8T uploaded its tables again at a repeated "
                             "call")
    print(f"K8T tile route (W {'/'.join(map(str, pf.TILE_WIDTHS))}) bit for "
          f"bit with the lines route in {n} launches, lines 1 to the tile "
          f"cap, inner 1-100, 1-41 taps, c11's axes, every mode; both within "
          f"1e-5 of the sum of their absolute terms of the twin ({exact} "
          f"equal to it); the K8/K8T adjoint identity holds in float64")


def _nonfinite(rs, shape, dtype, dev, scale=50.0):
    """Seeded values of a float ``dtype`` with about 3% NaN and 2% each of
    +inf and -inf (note R12's draws)."""
    import torch
    a = rs.randn(*shape) * scale
    a[rs.rand(*shape) < 0.03] = np.nan
    a[rs.rand(*shape) < 0.02] = np.inf
    a[rs.rand(*shape) < 0.02] = -np.inf
    return torch.as_tensor(a, dtype=dtype, device=dev)


def _close_nonfinite(got, want, rtol, atol, what):
    """NaN where ``want`` has NaN, the same infinities, and the finite
    positions within ``atol + rtol |want|``; returns their largest
    difference."""
    import torch
    nan, inf = torch.isnan(want), torch.isinf(want)
    if not torch.equal(torch.isnan(got), nan) or \
            not torch.equal(torch.isinf(got), inf) or \
            not torch.equal(got[inf], want[inf]):
        raise AssertionError(
            f"{what}: NaN or infinities differ from the twin's: "
            f"{int((torch.isnan(got) != nan).sum())} NaN, "
            f"{int((torch.isinf(got) != inf).sum())} inf")
    fin = torch.isfinite(want)
    return _assert_close(got[fin], want[fin], rtol, atol, what)


def _check_k8_routes(rs, worst):
    """K8 on both routes: the tile route at every width (W 32/64/128) bit
    for bit with the lines route (a zero's sign too, NaN where NaN), both
    against the twin (NaN and infinities where the twin has them, finite
    values at float32 rtol=1e-5, atol=1e-5*S, float64 1e-10, S = max of
    the finite |x| times sum|w|), the wrapper on the plan's route and its
    count; over the five modes, lines of 1, 2, 9, 100, 224 and the tile cap
    (and one past it, which takes the lines route), inner 1, 3, 33, 64 and
    100, 1-41 taps at the first, middle and last centre, the direct order
    and the paired order (symmetric and antisymmetric taps), float32 and
    float64, finite inputs and inputs holding NaN and infinities, cval 1.5,
    NaN, +inf or -inf; c11's and c12's three axes in every mode and c13's
    float64 paired passes (mirror); a repeated call uploads nothing (its
    taps and table come from the cache)."""
    import torch
    from elasticdeform_tpu_torch.ops import filters as ft
    from elasticdeform_tpu_torch.ops import prefilter as pf
    dev = torch.device("cuda")
    cases = []
    for dtype in (torch.float32, torch.float64):
        cap = pf.tile_cap(dtype)
        for n, inner in ((1, 64), (2, 3), (9, 1), (9, 33), (100, 100),
                         (224, 1), (cap, 1), (cap, 64), (cap + 1, 3)):
            outer = max(1, min(6, 40000 // (n * inner)))
            cases.append(((outer, n, inner), 1, dtype, MODES))
    cases += [((3, 160, 192, 224), a, torch.float32, MODES)
              for a in (1, 2, 3)]
    cases += [((160, 192, 224), a, torch.float32, ("nearest",))
              for a in (0, 1, 2)]
    cases += [((512, 512, 300), a, torch.float64, ("mirror",))
              for a in (0, 1, 2)]
    n = exact = 0
    for shape, axis, dtype, modes in cases:
        big = math.prod(shape) > 10 ** 6
        for mode in modes:
            finite = n % 2 == 0
            x = torch.as_tensor(rs.randn(*shape) * 50, dtype=dtype,
                                device=dev) if finite else \
                _nonfinite(rs, shape, dtype, dev)
            outer, ln, inner = pf._lines(x, axis)
            kernels = ((9, 4, 1),) if shape[0] == 512 else \
                ((17, 8, 0), (13, 6, 1)) if big else \
                ((1, 0, 0), (4, 0, 0), (4, 3, 0), (17, 8, 0), (9, 4, 1),
                 (9, 4, -1), (41, 20, 0), (41, 40, 0))
            for L, c, pair in kernels:
                w = rs.randn(L)
                if pair:
                    w = w + w[::-1] if pair > 0 else w - w[::-1]
                    w[L // 2] = 0.3 if pair > 0 else 0.0
                cval = (1.5, np.nan, np.inf, -np.inf)[n % 4]
                what = (f"K8 {dtype} {mode} shape={shape} axis={axis} "
                        f"taps={L} centre={c} pair={pair} cval={cval} "
                        f"{'finite' if finite else 'non-finite'}")
                fin = x[torch.isfinite(x)]
                scale = (float(fin.abs().max()) if fin.numel() else 1.0) * \
                    float(np.abs(w).sum())
                e = ft._k8_edges(ln, L, c, mode)
                plan = ft._line_plan(outer, ln, inner, dtype, L,
                                     len(e.table),
                                     sm_blocks=ft.k8_sm_blocks(dtype))
                if (ln > pf.tile_cap(dtype)) != (plan.route == "lines") and \
                        (ln <= 224 or ln > pf.tile_cap(dtype)):
                    raise AssertionError(f"{what}: plan {plan}")
                before = dict(ft.correlate1d.routes)
                got = ft.correlate1d(x, w, axis, mode, cval, c, pair)
                if ft.correlate1d.routes[plan.route] != \
                        before[plan.route] + 1:
                    raise AssertionError(f"{what}: the wrapper did not "
                                         f"count a {plan.route} launch")
                lines = ft._launch_line(x, w, axis, mode, cval, c, pair,
                                        ft.LinePlan("lines"))
                want = ft.correlate1d_plain(x, w, axis, mode, cval, c, pair)
                torch.cuda.synchronize()
                _same(got, lines, f"{what}: the plan's route vs the lines "
                      "route")
                worst["correlate1d"] = max(
                    worst["correlate1d"], _close_nonfinite(
                        got, want, *_tol(dtype, scale), f"{what} vs plain"))
                nan = torch.isnan(want)
                exact += int(torch.equal(
                    _bits(torch.where(nan, torch.zeros_like(got), got)),
                    _bits(torch.where(nan, torch.zeros_like(want), want))))
                if plan.route == "tile" and not big:
                    for W in pf.TILE_WIDTHS:
                        t = ft._launch_line(
                            x, w, axis, mode, cval, c, pair, ft._line_plan(
                                outer, ln, inner, dtype, L, len(e.table),
                                width=W, sm_blocks=ft.k8_sm_blocks(dtype)))
                        torch.cuda.synchronize()
                        _same(t, lines, f"{what} W={W}: the tile route vs "
                              "the lines route")
                        n += 1
                n += 1
                del got, lines, want
            del x
    # a repeated call uploads nothing: its taps and table come from the cache
    x = torch.as_tensor(rs.randn(3, 40, 50), dtype=torch.float32, device=dev)
    w = rs.randn(9)
    ft.correlate1d(x, w, 1, "mirror", 0.0, 4)
    misses = ft._k8_tables.cache_info().misses
    ft.correlate1d(x, w, 1, "mirror", 0.0, 4)
    ft._launch_line(x, w, 1, "mirror", 0.0, 4, 0, ft.LinePlan("lines"))
    if ft._k8_tables.cache_info().misses != misses:
        raise AssertionError("K8 uploaded its taps again at a repeated call")
    print(f"K8 tile route (W {'/'.join(map(str, pf.TILE_WIDTHS))}) bit for "
          f"bit with the lines route in {n} launches (NaN where NaN), lines 1 "
          f"to the tile cap, inner 1-100, 1-41 taps, both orders, c11's, "
          f"c12's and c13's axes, every mode, inputs with NaN and "
          f"infinities, cval 1.5 / NaN / +-inf; both against the twin, NaN "
          f"and infinities where it has them ({exact} cases bit for bit); a "
          f"repeated call uploads nothing")


def _check_k12_network_routes(rs, dev):
    """K12's network route on both routes: the network tile at every column
    (C 1/2/4) bit for bit with the old network kernel and the twin (a
    zero's sign too, NaN where NaN) and the wrapper on the network tile and
    its count, in the eleven dtypes (floats with NaN, infinities and zeros
    of both signs, integers over their range or a pool of ties), 3-64 taps
    (every wire count of the tile: a 3-tap line, 2x2, 2x2x2, 4x4, a 5x5
    plane, 3^3, a ball of radius 2, 4^3, a sparse footprint, a batch
    axis), ranks 0, 1, middle, k - 2 and k - 1, the five modes with a
    raw-dtype ``cval``, 1-D to 3-D; c15's 3^3 median and 33-tap percentile
    at its shape; a repeated call uploads nothing (its tables come from the
    caches)."""
    import torch
    from elasticdeform_tpu_torch.ops import morphology as mo
    fps = (np.ones(3, bool), np.ones((2, 2), bool), np.ones((2, 2, 2), bool),
           np.ones((4, 4), bool), np.ones((5, 5), bool),
           np.ones((3, 3, 3), bool), _ball(2), np.ones((4, 4, 4), bool),
           rs.rand(3, 4, 5) > 0.4, np.ones((1, 3, 3, 3), bool))
    shapes = {1: (150,), 2: (23, 37), 3: (9, 10, 35), 4: (2, 5, 9, 40)}
    n = 0
    for i, dtype in enumerate(_morph_dtypes()):
        for j, fp in enumerate(fps):
            k = int(fp.sum())
            shape = shapes[fp.ndim]
            x = _rand_volume(rs, shape, dtype, dev)
            for rank in sorted({0, 1, k // 2, k - 2, k - 1}):
                mode = MODES[n % 5]
                centers = [int(rs.randint(0, q)) for q in fp.shape]
                cval = _cval_for(rs, dtype)
                args = (x, fp, centers, mode, cval, rank)
                what = f"K12 network {dtype} {mode} shape={shape} taps={k} " \
                    f"rank={rank} centres={centers}"
                plan = mo._rank_plan(shape, fp.shape, dtype, k)
                if plan.route != "network_tile":
                    raise AssertionError(f"{what}: plan {plan}")
                before = dict(mo.rank_filter.routes)
                got = mo.rank_filter(*args)
                if mo.rank_filter.routes["network_tile"] != \
                        before["network_tile"] + 1:
                    raise AssertionError(f"{what}: the wrapper did not count "
                                         "a network_tile launch")
                old = mo._launch_rank(*args, mo._rank_plan(
                    shape, fp.shape, dtype, k, route="network"))
                want = mo.rank_filter_plain(*args)
                torch.cuda.synchronize()
                _same(got, want, f"{what} network tile vs plain")
                _same(old, want, f"{what} network route vs plain")
                n += 1
    # c15's two network filters at its shape, with NaN and zeros of both
    # signs
    S = (160, 192, 224)
    x = _rand_volume(rs, S, torch.float32, dev)
    for fp, rank in ((np.ones((3, 3, 3), bool), 13), (_ball(2), 6)):
        k = int(fp.sum())
        c = [q // 2 for q in fp.shape]
        args = (x, fp, c, "reflect", 0.0, rank)
        got = mo.rank_filter(*args)
        _same(got, mo._launch_rank(*args, mo._rank_plan(
            S, fp.shape, x.dtype, k, route="network")),
            f"K12 network tile at c15's shape, {k} taps, vs the network "
            "route")
        _same(got, mo.rank_filter_plain(*args),
              f"K12 network tile at c15's shape, {k} taps, vs plain")
        n += 1
    # a repeated call uploads nothing: its tables come from the caches
    x = _rand_volume(rs, (9, 10, 35), torch.float32, dev)
    caches = (mo._tile_tables,)
    fp = np.ones((3, 3, 3), bool)
    mo.rank_filter(x, fp, [1, 1, 1], "reflect", 0.0, 13)
    misses = [f.cache_info().misses for f in caches]
    mo.rank_filter(x, fp, [1, 1, 1], "reflect", 0.0, 13)
    if [f.cache_info().misses for f in caches] != misses:
        raise AssertionError("K12's network tile uploaded its tables again "
                             "at a repeated call")
    print(f"K12 network route: the network tile bit for bit with the old "
          f"network kernel and the twin in {n} cases (eleven dtypes with "
          f"NaN, infinities and zeros of both signs, 3-64 taps, ranks 0, 1, middle, k - 2, k - 1, every mode, "
          f"1-D to 3-D and a batch axis, c15's two filters at its shape); a "
          f"repeated call uploads nothing")


def _check_k12_routes(rs, dev):
    """K12's select route on both routes: the tile route bit for bit with
    the nd route and the twin (a zero's sign too, NaN where NaN) and the
    wrapper on the tile route and its count, in the eleven dtypes (floats
    with NaN, infinities and zeros of both signs, integers over their range
    or a pool of ties), 65-343 taps (5^3 and 7^3 boxes, balls of radius 3,
    sparse footprints, a 9x9 plane, a 67-tap line), ranks 1, middle and
    k - 2, the five modes with a raw-dtype ``cval``, 1-D to 3-D and a batch
    axis; a repeated call uploads nothing (its tables come from the caches)."""
    import torch
    from elasticdeform_tpu_torch.ops import morphology as mo
    g3 = np.indices((7, 7, 7)) - 3
    ball3 = (g3 ** 2).sum(0) <= 9
    shapes = {3: [(9, 10, 35), (4, 33, 40)], 2: [(23, 37)], 1: [(150,)]}
    n = 0
    for i, dtype in enumerate(_morph_dtypes()):
        for j, fp in enumerate((np.ones((5, 5, 5), bool),
                                np.ones((7, 7, 7), bool), ball3,
                                rs.rand(5, 6, 4) > 0.3,
                                np.ones((9, 9), bool), np.ones(67, bool),
                                np.ones((1, 5, 5, 5), bool))):
            k = int(fp.sum())
            if fp.ndim == 4:
                shape = (2, 5, 9, 40)
            else:
                opts = shapes[fp.ndim]
                shape = opts[(i + j) % len(opts)]
            x = _rand_volume(rs, shape, dtype, dev)
            for rank in (1, k // 2, k - 2):
                mode = MODES[n % 5]
                centers = [int(rs.randint(0, s)) for s in fp.shape]
                cval = _cval_for(rs, dtype)
                args = (x, fp, centers, mode, cval, rank)
                what = f"K12 {dtype} {mode} shape={shape} taps={k} " \
                    f"rank={rank} centres={centers}"
                plan = mo._rank_plan(shape, fp.shape, dtype, k)
                if plan.route != "tile":
                    raise AssertionError(f"{what}: plan {plan}")
                before = dict(mo.rank_filter.routes)
                got = mo.rank_filter(*args)
                if mo.rank_filter.routes["tile"] != before["tile"] + 1:
                    raise AssertionError(f"{what}: the wrapper did not count "
                                         "a tile launch")
                nd = mo._launch_rank(*args, mo._rank_plan(
                    shape, fp.shape, dtype, k, route="nd"))
                want = mo.rank_filter_plain(*args)
                torch.cuda.synchronize()
                _same(got, want, f"{what} tile route vs plain")
                _same(nd, want, f"{what} nd route vs plain")
                n += 1
    # a repeated call uploads nothing: its tables come from the caches
    x = _rand_volume(rs, (9, 10, 35), torch.float32, dev)
    caches = (mo._tile_tables, mo._cached_geometry, mo._network_pairs)
    for k, rank in ((125, 62), (27, 13)):
        fp = np.ones((5, 5, 5) if k == 125 else (3, 3, 3), bool)
        centers = [s // 2 for s in fp.shape]
        mo.rank_filter(x, fp, centers, "reflect", 0.0, rank)
        misses = [c.cache_info().misses for c in caches]
        mo.rank_filter(x, fp, centers, "reflect", 0.0, rank)
        if [c.cache_info().misses for c in caches] != misses:
            raise AssertionError(f"K12 ({k} taps) uploaded its tables again "
                                 "at a repeated call")
    print(f"K12 select route: the tile route bit for bit with the nd route "
          f"and the twin in {n} cases (eleven dtypes, 65-343 taps, ranks 1, "
          f"middle and k - 2, every mode, 1-D to 3-D and a batch axis)")


def _check_k9_routes(rs):
    """K9 on both routes: the tile route at the plan's column and at every
    column (C 1/2/4/8) bit for bit with the nd route and the twin, and the
    wrapper on the tile route and its count; at c14's shapes (160x192x224,
    a 5^3 kernel at origin (1, 0, -1), constant with cval 0.5; a 3^3 kernel
    on a (2, 160, 192, 224) batch) in every mode, float32 (float64 once);
    a 2-D and a rank-4 batch-merged case, a sparse 3x2x4 kernel at extreme
    origins, kernels longer than an axis, float64 too; a repeated call
    uploads nothing (its tables come from the caches)."""
    import torch
    from elasticdeform_tpu_torch.ops import filters as ft
    dev = torch.device("cuda")
    w5 = rs.randn(5, 5, 5)
    w3 = rs.randn(1, 3, 3, 3)
    sparse = rs.randn(3, 2, 4) * (rs.rand(3, 2, 4) > 0.5)
    sparse[0, 0, 0] = 0.0       # a zero first tap: not a tap
    sparse[2, 1, 3] = 1.5
    cases = [((160, 192, 224), w5, (3, 2, 1)),
             ((2, 160, 192, 224), w3, (0, 1, 1, 1)),
             ((37, 300), rs.randn(5, 3), (2, 1)),
             ((2, 9, 10, 11), rs.randn(1, 3, 3, 3), (0, 2, 0, 1)),
             ((9, 10, 11), sparse, (0, 1, 3)),
             ((9, 10, 11), sparse, (2, 0, 0)),
             ((5, 3, 40), rs.randn(7, 1, 5), (6, 0, 0)),
             ((3, 4, 9), rs.randn(5, 6, 3), (2, 5, 1)),
             ((70,), rs.randn(9), (8,))]
    n = launches = 0
    for (shape, w, centers), dtype, mode in itertools.product(
            cases, (torch.float32, torch.float64), MODES):
        big = math.prod(shape) > 10 ** 6
        if big and dtype == torch.float64 and mode != "mirror":
            continue    # c14's shapes: float32 in every mode, float64 once
        x = torch.as_tensor(rs.randn(*shape) * 50, dtype=dtype, device=dev)
        what = f"K9 {dtype} {mode} shape={shape} kernel={w.shape} " \
            f"centres={centers}"
        want = ft.correlate_nd_plain(x, w, centers, mode, 0.5)
        plan = ft._nd_plan(tuple(shape), w.shape, dtype)
        if plan.route != "tile":
            raise AssertionError(f"{what}: plan {plan}, not the tile route")
        before = dict(ft.correlate_nd.routes)
        got = ft.correlate_nd(x, w, centers, mode, 0.5)
        if ft.correlate_nd.routes["tile"] != before["tile"] + 1:
            raise AssertionError(f"{what}: the wrapper did not count a tile "
                                 "launch")
        nd = ft._launch_correlate_nd(x, w, centers, mode, 0.5,
                                     ft._nd_plan(shape, w.shape, dtype,
                                                 route="nd"))
        torch.cuda.synchronize()
        for label, t in (("the tile route", got), ("the nd route", nd)):
            if not torch.equal(_bits(t), _bits(want)):
                raise AssertionError(
                    f"{what}: {label} differs from the twin in "
                    f"{int((_bits(t) != _bits(want)).sum())} values, max "
                    f"abs err {float((t - want).abs().max()):.3e}")
        launches += 2
        for c in ft.TILE_COLUMNS:
            tp = ft._nd_plan(shape, w.shape, dtype, column=c, route="tile")
            t = ft._launch_correlate_nd(x, w, centers, mode, 0.5, tp)
            torch.cuda.synchronize()
            if not torch.equal(_bits(t), _bits(nd)):
                raise AssertionError(
                    f"{what} C={c}: the tile route differs from the nd "
                    f"route in {int((_bits(t) != _bits(nd)).sum())} values")
            launches += 1
        n += 1
        del x, want, got, nd
    # note R12: inputs holding NaN and infinities, a NaN or infinite cval;
    # both routes and the twin NaN where NaN, bit for bit elsewhere
    for (shape, w, centers), dtype, mode in itertools.product(
            cases, (torch.float32, torch.float64), MODES):
        if math.prod(shape) > 10 ** 6 and (dtype == torch.float64 or
                                           mode != "constant"):
            continue    # c14's shapes: float32 in constant mode
        x = _nonfinite(rs, shape, dtype, dev)
        cval = (np.nan, np.inf, -np.inf)[n % 3]
        what = f"K9 {dtype} {mode} cval={cval} shape={shape} " \
            f"kernel={w.shape}, non-finite"
        got = ft.correlate_nd(x, w, centers, mode, cval)
        nd = ft._launch_correlate_nd(x, w, centers, mode, cval,
                                     ft._nd_plan(shape, w.shape, dtype,
                                                 route="nd"))
        want = ft.correlate_nd_plain(x, w, centers, mode, cval)
        torch.cuda.synchronize()
        _same(got, want, f"{what}: the tile route vs the twin")
        _same(nd, want, f"{what}: the nd route vs the twin")
        launches += 2
        n += 1
        del x, got, nd, want
    # a repeated call uploads nothing: its tables come from the caches
    x = torch.as_tensor(rs.randn(9, 10, 11), device=dev)
    for route in ("tile", "nd"):
        plan = ft._nd_plan(x.shape, sparse.shape, x.dtype, route=route)
        ft._launch_correlate_nd(x, sparse, (1, 1, 2), "wrap", 0.0, plan)
        misses = [f.cache_info().misses for f in (ft._nd_tile_tables,
                                                  ft._nd_tables)]
        ft._launch_correlate_nd(x, sparse, (1, 1, 2), "wrap", 0.0, plan)
        if [f.cache_info().misses for f in (ft._nd_tile_tables,
                                            ft._nd_tables)] != misses:
            raise AssertionError(f"K9 ({route} route) uploaded its tables "
                                 "again at a repeated call")
    print(f"K9 tile route (C {'/'.join(map(str, ft.TILE_COLUMNS))}) and nd "
          f"route bit for bit with the twin and each other in {n} cases, "
          f"{launches} launches (c14's shapes in every mode, 2-D, rank 4, "
          f"1-D, sparse and long kernels, float32 and float64; inputs "
          f"holding NaN and infinities with a NaN or infinite cval, NaN where "
          f"NaN); repeated calls upload nothing")


# K10's box checks: (shape, ((axis, size), ...)) in the passes' order
_K10_BOX_CASES = (((37,), ((0, 3),)), ((5, 41), ((1, 4), (0, 2))),
                  ((9, 7, 40), ((0, 5), (1, 3), (2, 2))),
                  ((9, 7, 40), ((2, 7), (0, 2))),
                  ((3, 6, 5, 33), ((1, 3), (3, 9))), ((4, 70), ((1, 5),)),
                  ((6, 5, 4), ((0, 9), (2, 3), (1, 2))),
                  ((2, 3, 17, 19), ((2, 4), (3, 6), (0, 2))),
                  ((50, 3), ((0, 8),)), ((3, 4, 2, 5, 6), ((1, 3), (4, 2))),
                  ((33, 2, 3), ((1, 2), (0, 6))), ((20, 3), ((0, 25),)),
                  ((40, 37, 70), ((0, 5), (1, 5), (2, 5))),
                  ((2, 33, 150), ((2, 3), (1, 4))),
                  ((20, 45, 3, 66), ((3, 5), (0, 2), (1, 3))),
                  ((6, 40, 100), ((1, 3),)), ((3, 5, 200), ((2, 5),)),
                  ((11, 12, 13, 14), ((0, 2), (1, 2), (2, 2), (3, 2))))


def _check_k10_box(rs, dev):
    """K10's box route (every pass of a separable box in one launch) bit
    for bit with its lines route (one launch a pass) and the twin (a zero's
    sign too, NaN where NaN), through the wrapper and its count, in the
    eleven dtypes (floats with NaN, infinities and zeros of both signs,
    integers over their range or a pool of ties), min and max, boxes of
    one to three axes on 1-D to 5-D inputs (batch axes merged and walked by
    the grid), sizes 2-9 and one longer than its axis, per-axis modes and
    centres, a ``cval`` of the type (floats also NaN, -0, +0, inf); a box
    over four axes runs on the lines route, a launch a pass."""
    import torch
    from elasticdeform_tpu_torch.ops import morphology as mo
    n = 0
    for dtype, (shape, sizes), minimum in itertools.product(
            _morph_dtypes(), _K10_BOX_CASES, (True, False)):
        x = _rand_volume(rs, shape, dtype, dev)
        passes = [(ax, size, int(rs.randint(size)), MODES[rs.randint(5)])
                  for ax, size in sizes]
        cval = _cval_for(rs, dtype)
        if dtype.is_floating_point and rs.rand() < 0.4:
            cval = (float("nan"), -0.0, 0.0, float("inf"))[rs.randint(4)]
        kshape = [1] * len(shape)
        for ax, size in sizes:
            kshape[ax] = size
        plan = mo._box_plan(shape, tuple(kshape), dtype)
        want_route = "lines" if len(sizes) > 3 else "box"
        what = (f"K10 box {dtype} shape={shape} passes={passes} min="
                f"{minimum} cval={cval} plan={plan}")
        if plan.route != want_route:
            raise AssertionError(f"{what}: not on the {want_route} route")
        before = dict(mo.min_max_filter1d.routes)
        got = mo.min_max_box(x, passes, cval, minimum)
        count = 1 if want_route == "box" else len(passes)
        if mo.min_max_filter1d.routes[want_route] != \
                before[want_route] + count:
            raise AssertionError(f"{what}: the wrapper did not count "
                                 f"{count} launches on its route")
        lines = mo._launch_box(x, passes, cval, minimum, mo.BoxPlan("lines"))
        want = mo.min_max_box_plain(x, passes, cval, minimum)
        torch.cuda.synchronize()
        _same(got, want, f"{what} vs the twin")
        _same(lines, want, f"{what}: lines route vs the twin")
        n += 1
    print(f"K10 box route bit for bit with its lines route and the twin in "
          f"{n} cases (eleven dtypes, min and max, boxes of 1-3 axes on "
          f"1-D to 5-D inputs, sizes 2-25, per-axis modes and centres; 4 "
          f"axes on the lines route)")


def _check_k11_routes(rs, dev):
    """K11 on both routes: the tile route bit for bit with the nd route and
    the twin (a zero's sign too, NaN where NaN) and the wrapper on the tile
    route and its count, in the eleven dtypes (floats with NaN, infinities
    and zeros of both signs, integers over their range or a pool of ties),
    flat and non-flat (the non-flat integers and bool in float64 work,
    saturating), minimum and maximum, a ball of radius 2 (c16's 33 taps), a
    sparse 3-D footprint, a 2-D cross, a 1-D comb and a footprint over a
    batch axis, every mode with a ``cval`` in the work type; a repeated
    call uploads nothing."""
    import torch
    from elasticdeform_tpu_torch.ops import morphology as mo
    cross = np.zeros((5, 3), bool)
    cross[2] = cross[:, 1] = True
    footprints = ((_ball(2), (11, 9, 35)),
                  (rs.rand(3, 4, 5) > 0.4, (4, 10, 33)),
                  (cross, (13, 40)),
                  (np.array([1, 0, 1, 1, 0, 0, 1], bool), (70,)),
                  (_ball(1)[None], (2, 5, 9, 33)))
    n = 0
    for i, dtype in enumerate(_morph_dtypes()):
        for j, (fp, shape) in enumerate(footprints):
            x = _rand_volume(rs, shape, dtype, dev)
            for nonflat, minimum in itertools.product((False, True),
                                                      (True, False)):
                mode = MODES[(n + i) % 5]
                work = mo._work_dtype(dtype, nonflat)
                st = np.round(rs.randn(*fp.shape) * 50, 1) if nonflat \
                    else None
                centers = [int(rs.randint(0, k)) for k in fp.shape]
                args = (x, fp, st, centers, mode, _cval_for(rs, work),
                        minimum)
                what = f"K11 {dtype} {mode} shape={shape} taps=" \
                    f"{int(fp.sum())} nonflat={nonflat} min={minimum} " \
                    f"centres={centers}"
                plan = mo._min_max_plan(shape, fp.shape, work,
                                        int(fp.sum()), nonflat)
                if plan.route != "tile":
                    raise AssertionError(f"{what}: plan {plan}")
                before = dict(mo.min_max_filter.routes)
                got = mo.min_max_filter(*args)
                if mo.min_max_filter.routes["tile"] != before["tile"] + 1:
                    raise AssertionError(f"{what}: the wrapper did not count "
                                         "a tile launch")
                nd = mo._launch_min_max(*args, mo._min_max_plan(
                    shape, fp.shape, work, int(fp.sum()), nonflat,
                    route="nd"))
                want = mo.min_max_filter_plain(*args)
                torch.cuda.synchronize()
                _same(got, want, f"{what} tile route vs plain")
                _same(nd, want, f"{what} nd route vs plain")
                n += 1
    # a repeated call uploads nothing: its tables come from the caches
    x = _rand_volume(rs, (9, 10, 35), torch.int16, dev)
    caches = (mo._tile_tables, mo._structure_values, mo._cached_geometry)
    s3 = -30.0 * ((np.indices((3, 3, 3)) - 1) ** 2).sum(0)
    for route in ("tile", "nd"):
        plan = mo._min_max_plan(x.shape, (3, 3, 3), torch.float64, 27, True,
                                route=route)
        args = (x, np.ones((3, 3, 3), bool), s3, [1, 1, 1], "reflect", 0.0,
                False, plan)
        mo._launch_min_max(*args)
        misses = [c.cache_info().misses for c in caches]
        mo._launch_min_max(*args)
        if [c.cache_info().misses for c in caches] != misses:
            raise AssertionError(f"K11 ({route} route) uploaded its tables "
                                 "again at a repeated call")
    print(f"K11 tile route bit for bit with the nd route and the twin in {n} "
          f"cases (eleven dtypes, flat and non-flat, min and max, 7-33 taps "
          f"in 1-D to 3-D and over a batch axis, every mode); repeated calls "
          f"upload nothing")


# step 0 of the morphology tier's outputs: (function, keywords) per
# structure kind; minimum_filter and maximum_filter take no structure
_MORPH_OUTPUT_CALLS = ("minimum_filter", "maximum_filter", "grey_erosion",
                       "grey_dilation", "grey_opening", "grey_closing",
                       "white_tophat", "black_tophat",
                       "morphological_gradient", "morphological_laplace")


def _check_morph_outputs(rs):
    """Step 0 of the morphology tier's outputs: ``grey_erosion``,
    ``grey_dilation``, ``grey_opening``, ``grey_closing``, the top-hats,
    ``morphological_gradient`` and ``morphological_laplace`` with a box
    (K10), a flat footprint (K11) and a non-flat structure (K11, float64
    work for integers), ``minimum_filter`` and ``maximum_filter`` with the
    box and the footprint, from int16, uint8 and float32 inputs (the float32
    ones holding +-inf, NaN, 1e30 and zeros of both signs) into uint8,
    int16, int32 and float32 ``output=`` arrays, in every mode, 2-D and 3-D:
    each output equal to the same call with ``device="cpu"`` bit for bit
    (NaN where NaN: a NaN that arithmetic makes has another payload on each
    device).
    Prints the card's and the CPU's own float -> int64 conversion of inf,
    NaN and 1e30, which ``core._finish_filter`` no longer leaves to the
    device."""
    import torch
    import elasticdeform_tpu_torch as et
    edge = torch.tensor([np.inf, -np.inf, np.nan, 1e30])
    raw = {d: edge.to(d).to(torch.int64).cpu().tolist()
           for d in ("cpu", "cuda")}
    cross = np.zeros((3, 3, 3), bool)
    cross[1, 1] = cross[1, :, 1] = cross[:, 1, 1] = True
    s3 = -30.0 * ((np.indices((3, 3, 3)) - 1) ** 2).sum(0)
    kinds = (("box", dict(size=3)), ("footprint", dict(footprint=cross)),
             ("non-flat", dict(structure=s3)))
    n = 0
    for idt, shape in itertools.product(("int16", "uint8", "float32"),
                                        ((6, 9, 35), (33, 40))):
        if idt == "float32":
            x = (rs.randn(*shape) * 300).astype(np.float32)
            for value, share in ((np.inf, 0.03), (-np.inf, 0.03),
                                 (np.nan, 0.02), (1e30, 0.02), (0.0, 0.05),
                                 (-0.0, 0.05)):
                x[rs.rand(*shape) < share] = value
        else:
            info = np.iinfo(idt)
            x = rs.randint(info.min, int(info.max) + 1, shape).astype(idt)
        for name, (kind, kw), odt, mode in itertools.product(
                _MORPH_OUTPUT_CALLS, kinds, ("uint8", "int16", "int32",
                                             "float32"), MODES):
            if name.endswith("_filter") and kind == "non-flat":
                continue
            kw = {k: (v[1] if k != "size" and len(shape) == 2 else v)
                  for k, v in kw.items()}
            fn = getattr(et, name)
            got = fn(x, mode=mode, cval=2.5, output=np.empty(shape, odt),
                     device="cuda", **kw)
            want = fn(x, mode=mode, cval=2.5, output=np.empty(shape, odt),
                      device="cpu", **kw)
            _same(torch.as_tensor(got), torch.as_tensor(want),
                  f"{name} {kind} {idt} -> {odt} {shape} mode={mode} vs "
                  f"the CPU run")
            n += 1
    print(f"morphology output= (grey erosion, dilation, opening, closing, "
          f"top-hats, gradient, Laplace, minimum and maximum filters; box, "
          f"footprint and non-flat structure) from int16, uint8 and float32 "
          f"(+-inf, NaN, 1e30, +-0) into uint8/int16/int32/float32 arrays, "
          f"every mode, 2-D and 3-D: {n} calls equal the CPU run bit for "
          f"bit; the devices' own float -> int64 of [inf, -inf, nan, 1e30]: "
          f"cpu {raw['cpu']}, cuda {raw['cuda']}")


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

    # note R12: inputs holding NaN and infinities, and a NaN or infinite
    # cval; K8 and K9 give NaN and infinities where their twins do (SciPy's
    # rule: a non-finite value reaches only the outputs whose taps read it)
    n = 0
    for dtype, mode, cval in itertools.product(
            (torch.float32, torch.float64), modes,
            (1.5, np.nan, np.inf, -np.inf)):
        for shape in ((37, 300), (7, 33, 9)):
            x = _nonfinite(rs, shape, dtype, dev)
            fin = x[torch.isfinite(x)]
            for axis, L in itertools.product(range(len(shape)), (1, 4, 17)):
                w = rs.randn(L)
                scale = float(fin.abs().max()) * float(np.abs(w).sum())
                for c in sorted({0, L // 2, L - 1}):
                    got = ft.correlate1d(x, w, axis, mode, cval, c)
                    want = ft.correlate1d_plain(x, w, axis, mode, cval, c)
                    torch.cuda.synchronize()
                    worst["correlate1d"] = max(
                        worst["correlate1d"], _close_nonfinite(
                            got, want, *_tol(dtype, scale),
                            f"K8 {dtype} {mode} cval={cval} shape={shape} "
                            f"axis={axis} taps={L} centre={c}, non-finite"))
                    n += 1
            w = rs.randn(*((3, 4) if len(shape) == 2 else (3, 2, 5)))
            centers = tuple(int(rs.randint(0, k)) for k in w.shape)
            got = ft.correlate_nd(x, w, centers, mode, cval)
            want = ft.correlate_nd_plain(x, w, centers, mode, cval)
            torch.cuda.synchronize()
            scale = float(fin.abs().max()) * float(np.abs(w).sum())
            worst["correlate_nd"] = max(
                worst["correlate_nd"], _close_nonfinite(
                    got, want, *_tol(dtype, scale),
                    f"K9 {dtype} {mode} cval={cval} shape={shape} "
                    f"kernel={w.shape}, non-finite"))
            n += 1
    print(f"K8 and K9 on inputs holding NaN and infinities and with cval "
          f"1.5, NaN, +inf or -inf: {n} cases give NaN and infinities where "
          f"their twins do, the finite values within the tolerances above")


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
                          ((9, 10, 11), (2, 2, 3)), ((16, 17), (0, 0)),
                          ((3, 4, 5, 6), (3, 1, 1, 3)), ((5, 100), (1, 67))):
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
                    what = (f"K13 shape={shape} structure="
                            f"{st.astype(int).tolist()} border={border} "
                            f"mask={use_mask} dilation={dilation}")
                    sten = mo._Stencil(shape, st, centers)
                    tiled = sten.plan(1, True).route == "tile"
                    if tiled != (len(shape) <= 3 and kshape != (1, 67)):
                        raise AssertionError(f"{what}: the plan took the "
                                             f"{'tile' if tiled else 'nd'} "
                                             "route")
                    want_flag = torch.zeros(1, dtype=torch.int32, device=dev)
                    want = mo.binary_step_plain(x, st, centers, border,
                                                dilation, mask, want_flag)
                    # the plan's route, and each route forced
                    for route in (None, "tile", "nd") if tiled else \
                            (None, "nd"):
                        flag = torch.zeros(1, dtype=torch.int32, device=dev)
                        got = mo.binary_step(x, st, centers, border,
                                             dilation, mask, flag,
                                             route=route)
                        torch.cuda.synchronize()
                        _same(got, want, f"{what} route={route}")
                        _same(flag, want_flag, f"{what} route={route} "
                              "changed flag")
                    # binary_erosion_dilation, three sweeps and to the
                    # fixpoint, against the CPU run, on the plan's route and
                    # the nd route; the centre tap keeps each sweep
                    # monotone, so the fixpoint is reached
                    st[tuple(k // 2 for k in st.shape)] |= kshape != (0, 0)
                    for its in (3, 0):
                        want = mo.binary_erosion_dilation(
                            x.cpu(), st, its,
                            None if mask is None else mask.cpu(), border, 0,
                            dilation)
                        for route in (None, "nd"):
                            got = mo.binary_erosion_dilation(
                                x, st, its, mask, border, 0, dilation,
                                route=route)
                            torch.cuda.synchronize()
                            _same(got.cpu(), want, f"{what} iterations="
                                  f"{its} route={route}")
                    n += 1
    print(f"K13 binary_step bit for bit with its plain twin in {n} cases "
          f"on the plan's route and each route forced (the nd route alone "
          f"at 4 axes and an innermost reach of 33), each also at 3 "
          f"iterations and to the fixpoint against the CPU run (the plan's "
          f"route and the nd route)")
    _check_k13_sweeps(rs, dev)


def _dist_masks(rs, shape):
    """Masks for K14/K15: background shares 30% and 2%, none, all, and
    background at row 0 of axis 0 every 30 voxels along the last axis (a
    band of 16 fails there, one of 64 certifies)."""
    stripes = np.ones(shape, dtype=bool)
    stripes[(0,) * (len(shape) - 1) + (slice(0, None, 30),)] = False
    return (("bg 30%", rs.rand(*shape) > 0.3), ("bg 2%", rs.rand(*shape)
                                                 > 0.02),
            ("no background", np.ones(shape, bool)),
            ("all background", np.zeros(shape, bool)),
            ("stripes of 30", stripes))


def _check_distance_kernels(rs):
    """K14-K17 against their plain twins on the card, bit for bit, on odd
    small shapes of 1-4 axes (K14 and K15 also of 7 and 8, whose 7 and 8
    feature planes fill a slab tile's staging): K14 with and without the
    feature planes; K15
    at each rung of the ladder alone along each later axis (lines of 13,
    17, 40 and 70-97: n <= 17 dense only, 18-65 a band of 16, >= 66 both
    bands) with and without the planes, the certificate equal, on the
    plan's tile route (column tiles of a strided axis, partial ones too,
    and whole slabs) and, on lines of 6150, past the staging on the lines
    route; the dense kernel predicated on a clear flag (it writes nothing)
    and on a set one; the pass entry (band and predicated dense kernel from
    one host call) against the CPU schedule, its flag too; sampling 0.7
    and (1.5, 1, ...); masks with dense and sparse background, none and
    all; K16 with and without indices and K17 on uint8 and uint16 images
    (random, and plateaus where ties go by the step count and the label),
    negative markers, over the cross, full and a custom structure, six
    sweeps each, the changed flag equal, then the fixpoint driver's groups
    of 3 and 8 sweeps from one host call (:func:`_check_sweep_group`); then
    the public transforms against the port's CPU run. Fails unless every
    K15 rung, both routes and both flags of the pass ran."""
    import torch
    import elasticdeform_tpu_torch as et
    from elasticdeform_tpu_torch.ops import distance as ds
    from elasticdeform_tpu_torch.ops import morphology as mo
    dev = torch.device("cuda")
    n = dict.fromkeys(("K14", "K15", "K15 predicated", "K15 passes", "K16",
                       "K17", "K16 groups", "K17 groups", "calls"), 0)
    rungs0 = dict(ds.minplus_rung.rungs)
    routes, pass_flags = set(), set()
    clear = torch.zeros(1, dtype=torch.int32, device=dev)
    setf = torch.ones(1, dtype=torch.int32, device=dev)
    for shape in ((13,), (5, 17), (3, 40), (7, 70), (2, 70, 40), (3, 5, 19),
                  (2, 9, 67), (3, 4, 5, 21), (2, 3, 4, 97), (80, 6, 7),
                  (150, 40), (300, 3), (2, 6150), (2, 6150, 2),
                  (2, 2, 2, 2, 2, 2, 40), (2, 1, 2, 1, 2, 3, 40, 2)):
        nd = len(shape)
        masks = _dist_masks(rs, shape)
        samps = ((0.7,) * nd, (1.5,) + (1.0,) * (nd - 1))
        if max(shape) > 6144:
            # the lines route: fewer cases (the dense twin's cost matrix
            # is 300 MB a line)
            masks = [mm for mm in masks
                     if mm[0] in ("bg 30%", "no background", "stripes of 30")]
            samps = samps[:1]
        for label, m in masks:
            mc = torch.as_tensor(m, device=dev)
            for samp in samps:
                what = f"{shape} {label} sampling {samp}"
                for want in (False, True):
                    a = ds.nearest_background(mc, samp[0], want)
                    b = ds.nearest_background_plain(mc, samp[0], want)
                    _same(a[0], b[0], f"K14 f {what}")
                    if want:
                        _same(a[1], b[1], f"K14 planes {what}")
                    n["K14"] += 1
                f, ix = b
                for ax in range(1, nd):
                    size = shape[ax]
                    inner = math.prod(shape[ax + 1:])
                    routes.add(ds._minplus_plan(f.numel() // (size * inner),
                                                size, inner,
                                                ix.shape[0]).route)
                    for W in [w for w in ds.EDT_LADDER
                              if 0 < w < size - 1] + [0]:
                        for idx in (None, ix):
                            a = ds.minplus_rung(f, idx, ax, samp[ax], W)
                            if W:
                                b = ds.banded_plain(f, idx, ax, samp[ax], W)
                                ok = bool((b[0] <= (samp[ax] * W) ** 2)
                                          .all())
                            else:
                                b = ds.matrix_plain(f, idx, ax, samp[ax])
                                ok = True
                            w = f"K15 W={W} axis {ax} {what}"
                            _same(a[0], b[0], w)
                            if idx is not None:
                                _same(a[1], b[1], f"{w} planes")
                            if a[2] != ok:
                                raise AssertionError(f"{w}: certificate "
                                                     f"{a[2]}, twin {ok}")
                            n["K15"] += 1
                    # the dense kernel on a clear flag writes nothing; on a
                    # set flag it is the dense tier
                    w = f"K15 predicated dense axis {ax} {what}"
                    into = (torch.full_like(f, -7.0),
                            torch.full_like(ix, -3))
                    ds._launch_rung(f, ix, ax, samp[ax], 0, clear, into)
                    if not (bool((into[0] == -7.0).all())
                            and bool((into[1] == -3).all())):
                        raise AssertionError(f"{w}: wrote on a clear flag")
                    ds._launch_rung(f, ix, ax, samp[ax], 0, setf, into)
                    b = ds.matrix_plain(f, ix, ax, samp[ax])
                    _same(into[0], b[0], w)
                    _same(into[1], b[1], f"{w} planes")
                    n["K15 predicated"] += 1
                    # the pass entry against the CPU schedule
                    for idx in (None, ix):
                        kept = ([], [])
                        a = ds.minplus_pass(f, idx, ax, samp[ax], kept[0])
                        b = ds.minplus_pass(
                            f.cpu(), None if idx is None else idx.cpu(), ax,
                            samp[ax], kept[1])
                        w = f"K15 pass axis {ax} {what}"
                        _same(a[0].cpu(), b[0], w)
                        if idx is not None:
                            _same(a[1].cpu(), b[1], f"{w} planes")
                        got, want = (ds.kept_rungs(k) for k in kept)
                        if got != want:
                            raise AssertionError(f"{w}: kept {got}, the CPU "
                                                 f"schedule {want}")
                        if kept[0][0][2] is not None:
                            pass_flags.add(int(kept[0][0][2].item()))
                        n["K15 passes"] += 1
                    f, ix = ds.minplus_pass(f, ix, ax, samp[ax])
            if max(shape) > 6144:
                continue
            got = et.distance_transform_edt(m, sampling=samp[::-1],
                                            return_indices=True, device=dev)
            want = et.distance_transform_edt(m, sampling=samp[::-1],
                                             return_indices=True,
                                             device="cpu")
            _same(got[0].cpu(), want[0], f"EDT {shape} {label}")
            _same(got[1].cpu(), want[1], f"EDT indices {shape} {label}")
            n["calls"] += 1
    ran = {k: v - rungs0.get(k, 0) for k, v in ds.minplus_rung.rungs.items()}
    if min(ran[k] for k in ("w16", "w64", "dense")) <= 0:
        raise AssertionError(f"K15: a rung never ran in phase 2: {ran}")
    if routes != {"tile", "lines"} or pass_flags != {0, 1}:
        raise AssertionError(f"K15: routes {routes} and pass flags "
                             f"{pass_flags} in phase 2, not both of each")

    for shape in ((31,), (9, 13), (5, 7, 9), (3, 4, 5, 6)):
        nd = len(shape)
        structures = (("cross", mo.generate_binary_structure(nd, 1)),
                      ("full", mo.generate_binary_structure(nd, nd)),
                      ("custom", rs.rand(*(3,) * nd) > 0.5))
        m = rs.rand(*shape) > 0.15
        for sname, st in structures:
            taps = mo.relax_taps(st, shape)
            d = torch.where(torch.as_tensor(m, device=dev), mo.RELAX_BIG,
                            0).to(torch.int32)
            ix = torch.arange(d.numel(), dtype=torch.int32,
                              device=dev).reshape(shape)
            for sweep in range(6):
                for with_ix in (False, True):
                    flags = [torch.zeros(1, dtype=torch.int32, device=dev)
                             for _ in range(2)]
                    x = ix if with_ix else None
                    a = ds.chamfer_sweep(d, x, taps, flags[0])
                    b = ds.chamfer_sweep_plain(d, x, taps.offs, flags[1])
                    what = f"K16 {shape} {sname} sweep {sweep}"
                    _same(a[0], b[0], what)
                    if with_ix:
                        _same(a[1], b[1], f"{what} indices")
                    if int(flags[0]) != int(flags[1]):
                        raise AssertionError(f"{what}: flag differs")
                    n["K16"] += 1
                d, ix = a
            for group, with_ix in itertools.product((3, 8), (False, True)):
                state = (d.clone(), ix.clone() if with_ix else None)
                _check_sweep_group(
                    f"K16 {shape} {sname} indices={with_ix}",
                    ds.chamfer_sweeper(*state, taps), state,
                    lambda st, ch: ds.chamfer_sweep_plain(*st, taps.offs,
                                                          ch), group)
                n["K16 groups"] += 1
            got = et.distance_transform_cdt(m, metric=st, return_indices=True,
                                            device=dev)
            want = et.distance_transform_cdt(m, metric=st,
                                             return_indices=True,
                                             device="cpu")
            for g, w in zip(got, want):
                _same(g.cpu(), w, f"CDT {shape} {sname}")
            for dtype, hi in ((torch.uint8, 256), (torch.uint16, 65536)):
                for iname, img in (("random", rs.randint(0, hi, shape)),
                                   ("plateaus", rs.randint(0, 3, shape))):
                    img = torch.as_tensor(img, device=dev).to(dtype)
                    mk = np.zeros(d.numel(), np.int32)
                    mk[rs.choice(mk.size, 4, replace=False)] = [3, -1, 7, 2]
                    mk = torch.as_tensor(mk.reshape(shape), device=dev)
                    seeded = mk != 0
                    state = (torch.where(seeded, img.to(torch.int32),
                                         mo.RELAX_BIG).to(torch.int32),
                             torch.where(seeded, 0, mo.RELAX_BIG).to(
                                 torch.int32), mk)
                    for sweep in range(6):
                        flags = [torch.zeros(1, dtype=torch.int32,
                                             device=dev) for _ in range(2)]
                        a = ds.watershed_sweep(img, *state, taps, flags[0])
                        b = ds.watershed_sweep_plain(img, *state, taps.offs,
                                                     flags[1])
                        what = (f"K17 {shape} {sname} {dtype} {iname} sweep "
                                f"{sweep}")
                        for g, w, part in zip(a, b, "csl"):
                            _same(g, w, f"{what} {part}")
                        if int(flags[0]) != int(flags[1]):
                            raise AssertionError(f"{what}: flag differs")
                        n["K17"] += 1
                        state = a
                    for group in (3, 8):
                        st0 = tuple(t.clone() for t in state)
                        _check_sweep_group(
                            f"K17 {shape} {sname} {dtype} {iname}",
                            ds.watershed_sweeper(img, taps), st0,
                            lambda st, ch: ds.watershed_sweep_plain(
                                img, *st, taps.offs, ch), group)
                        n["K17 groups"] += 1
                    got = et.watershed_ift(img, mk, structure=st, device=dev)
                    want = et.watershed_ift(img.cpu(), mk.cpu(), structure=st,
                                            device="cpu")
                    _same(got.cpu(), want, f"watershed {shape} {sname} "
                          f"{dtype} {iname}")
                    n["calls"] += 1
    print(f"K14-K17 vs plain on the card, bit for bit: {json.dumps(n)} "
          f"cases (K15's launches per rung alone {json.dumps(ran)}, routes "
          f"{sorted(routes)}, pass flags {sorted(pass_flags)}); the public "
          "transforms equal the CPU run")


# ---------------------------------------------------------------------------
# K18-K20: labeling and region measurements


def _snake(shape):
    """A bool mask holding one serpentine component: every other line of
    the last axis, joined at alternating ends, plane by plane, and the
    planes joined at alternating corners."""
    m = np.zeros(shape, dtype=bool)
    rows = m.reshape(-1, shape[-1])
    rows[::2] = True
    for r in range(1, len(rows), 2):
        rows[r, -1 if (r // 2) % 2 == 0 else 0] = True
    return m


def _check_k18(rs, dev):
    """K18 (roots, root flags and numbering) against its twins, bit for
    bit, on 1-D to 4-D masks at foreground shares 0, 0.3, 0.55, 0.7 and 1
    under every connectivity and a random symmetric structure, snakes, and
    the public ``label`` of float inputs holding NaN against the CPU run."""
    import torch
    import elasticdeform_tpu_torch as et
    from elasticdeform_tpu_torch.ops import measure as ms
    from elasticdeform_tpu_torch.ops.morphology import (
        generate_binary_structure)
    t0 = time.perf_counter()
    n = 0
    for shape in ((1,), (37,), (300,), (9, 13), (64, 70), (5, 7, 9),
                  (24, 31, 33), (3, 4, 5, 6), (6, 7, 8, 9)):
        nd = len(shape)
        structs = [generate_binary_structure(nd, c) for c in range(1, nd + 1)]
        r = rs.rand(*(3,) * nd) > 0.5
        structs.append(r | r[(slice(None, None, -1),) * nd])
        for st, p in itertools.product(structs, (0.0, 0.3, 0.55, 0.7, 1.0)):
            offs = ms.structure_offsets(st, nd)
            fg = torch.as_tensor(rs.rand(*shape) < p, device=dev)
            before = ms.label_roots.launches
            got = ms.label_roots(fg, offs, flags=True)
            if ms.label_roots.launches - before != \
                    (3 if len(ms.half_taps(offs, shape)) else 2):
                raise AssertionError(f"K18 {shape}: counted "
                                     f"{ms.label_roots.launches - before} "
                                     f"kernels for one call")
            want = ms.label_roots_plain(fg, offs, flags=True)
            lab, count = ms.label_numbers(*got)
            cum = torch.cumsum(want[1].reshape(-1), 0, dtype=torch.int32)
            torch.cuda.synchronize()
            what = f"K18 {shape} p={p} {len(offs)} offsets"
            _same(got[0], want[0], f"{what} roots")
            _same(got[1], want[1], f"{what} flags")
            _same(lab, ms.label_numbers_plain(want[0], cum), f"{what} labels")
            if count != int(cum[-1]):
                raise AssertionError(f"{what}: {count} labels, not "
                                     f"{int(cum[-1])}")
            n += 1
    for shape in ((200, 200), (9, 40, 40)):
        for conn in (1, len(shape)):
            offs = ms.structure_offsets(
                generate_binary_structure(len(shape), conn), len(shape))
            fg = torch.as_tensor(_snake(shape), device=dev)
            _same(ms.label_roots(fg, offs), ms.label_roots_plain(fg, offs),
                  f"K18 snake {shape}")
            n += 1
    for shape in ((40, 50), (12, 20, 30)):
        x = rs.randn(*shape)
        x[rs.rand(*shape) < 0.4] = 0.0
        x[rs.rand(*shape) < 0.05] = np.nan
        for dt in (np.float32, np.float64):
            got, gn = et.label(x.astype(dt), device=dev)
            want, wn = et.label(x.astype(dt), device="cpu")
            _same(got.cpu(), want, f"label {shape} {np.dtype(dt)}")
            if gn != wn:
                raise AssertionError(f"label {shape}: {gn} labels, not {wn}")
            n += 1
    print(f"K18 label_roots and its numbering vs plain on the card, bit for "
          f"bit: {n} cases (1-D to 4-D, every connectivity and random "
          f"structures, snakes, NaN inputs through label); "
          f"{time.perf_counter() - t0:.1f} s")


def _k19_cases(rs, shape, dev):
    """(what, labels, lut, K) for K19 and K20: no labels; labels with no
    index; index arrays with an absent entry, with duplicates, and a
    scalar; the table built as ``_norm_labels_index`` builds it."""
    import torch
    from elasticdeform_tpu_torch.ops import measure as ms
    lab = torch.as_tensor(rs.randint(-1, 8, shape).astype(np.int32),
                          device=dev)
    out = [("no labels", None, None, 1), ("no index", lab, None, 1)]
    for idx in ([1, 2, 3, 5, 9], [2, 2, 0, 4, 2], 3):
        lut, K, _, _ = ms.labels_index(lab, idx, dev)
        out.append((f"index {idx}", lab, lut, K))
    return out


def _check_k19_k20(rs, dev, worst):
    """K19 (every statistic at once, the histogram's 16 buckets too) and
    K20 (both extrema's positions) against their twins on the card in the
    eleven dtypes (:func:`_rand_volume`: NaN, +-0 and infinities in the
    floats, ties), on 1-D to 4-D shapes: counts,
    order keys, coordinate bounds, histograms and positions bit for bit,
    float64 sums per segment to 1e-12 of the sum of their terms' magnitudes
    (atomics reorder them); small K on both routes, forced, and K = 10^5
    segments (the device route) with uint16 and float labels. Each shape
    and dtype takes two of :func:`_k19_cases`' five cases, turning with
    the shape and the dtype, so that every dtype meets every case and
    every shape every case."""
    import torch
    from elasticdeform_tpu_torch.ops import measure as ms
    t0 = time.perf_counter()
    n = {"shared": 0, "device": 0, "positions": 0}
    stats = ms.STATS
    for i, shape in enumerate(((37,), (9, 13), (5, 7, 9), (3, 4, 5, 6),
                               (40, 50, 60))):
        cases = _k19_cases(rs, shape, dev)
        for j, dtype in enumerate(_morph_dtypes()):
            x = _rand_volume(rs, shape, dtype, dev)
            hist = (16, -3.0, 5.0)
            for c in ((i + j) % len(cases), (i + j + 2) % len(cases)):
                what, lab, lut, K = cases[c]
                want = ms.segment_reduce_plain(x, lab, lut, K, stats, hist)
                terms = _k19_terms(x, lab, lut, K)
                for route in ("shared", "device"):
                    got = ms.segment_reduce(x, lab, lut, K, stats, hist,
                                            route=route)
                    torch.cuda.synchronize()
                    _k19_same(got, want, x, terms,
                              f"K19 {route} {shape} {dtype} {what}", worst)
                    n[route] += 1
                for stat in ("min", "max"):
                    _same(ms.segment_position(x, lab, lut, K, want[stat]),
                          ms.segment_position_plain(x, lab, lut, K,
                                                    want[stat]),
                          f"K20 {stat} {shape} {dtype} {what}")
                    n["positions"] += 1
    # K = 10^5 segments over 120 000 voxels: the device route
    shape = (40, 50, 60)
    for ldt in (np.uint16, np.float64):
        lab = torch.as_tensor(rs.randint(0, 100_001, shape).astype(ldt),
                              device=dev)
        lut, K, _, _ = ms.labels_index(lab, np.arange(100_000), dev)
        for dtype in (torch.int16, torch.float32, torch.float64):
            x = _rand_volume(rs, shape, dtype, dev)
            want = ms.segment_reduce_plain(x, lab, lut, K, stats, (8, -2, 2))
            if ms.segment_plan(K, stats, 3, 8) != "device":
                raise AssertionError("K19: 10^5 segments did not take the "
                                     "device route")
            got = ms.segment_reduce(x, lab, lut, K, stats, (8, -2, 2))
            _k19_same(got, want, x, _k19_terms(x, lab, lut, K),
                      f"K19 device K=1e5 {dtype} labels {np.dtype(ldt)}",
                      worst)
            n["device"] += 1
            for stat in ("min", "max"):
                _same(ms.segment_position(x, lab, lut, K, want[stat]),
                      ms.segment_position_plain(x, lab, lut, K, want[stat]),
                      f"K20 {stat} K=1e5 {dtype}")
                n["positions"] += 1
    print(f"K19 segment_reduce and K20 segment_position vs plain on the "
          f"card: {json.dumps(n)} cases in the eleven dtypes, exact but the "
          f"float64 sums (max abs err of a float input's "
          f"{worst['segment_reduce']:.3e}); "
          f"{time.perf_counter() - t0:.1f} s")


def _k19_terms(x, lab, lut, K):
    """The sums of K19's float64 sums' terms' magnitudes per segment, which
    scale their tolerance."""
    import torch
    from elasticdeform_tpu_torch.ops import measure as ms
    return ms.segment_reduce_plain(x.to(torch.float64).abs(), lab, lut, K,
                                   ("sum", "sum2", "csum"))


def _k19_same(got, want, x, terms, what, worst):
    """K19's accumulators against the twin's: exact, but the float64 sums
    to 1e-12 of the sum of their terms' magnitudes (``terms``,
    :func:`_k19_terms`) per segment; the largest error of a float input's
    sum goes into ``worst``."""
    import torch
    for s, w in want.items():
        g = got[s]
        if s in terms:
            bound = 1e-12 * terms[s]
            err = (g - w).abs()
            ok = (err <= bound) | (g == w) | (torch.isnan(g) &
                                                torch.isnan(w))
            if not bool(ok.all()):
                raise AssertionError(f"{what} {s}: {int((~ok).sum())} "
                                     f"segments off by more than 1e-12 of "
                                     f"their terms")
            # the reported error: float inputs' (integer inputs over their
            # whole range sum past 2^53, where only the relative bound
            # speaks)
            fin = torch.isfinite(err)
            if x.dtype.is_floating_point and bool(fin.any()):
                worst["segment_reduce"] = max(worst["segment_reduce"],
                                              float(err[fin].max()))
        else:
            _same(g, w, f"{what} {s}")


def _check_measure_kernels(rs, worst):
    import torch
    dev = torch.device("cuda")
    _check_k18(rs, dev)
    _check_k19_k20(rs, dev, worst)


def _check_sweep_group(what, sweeper, state, plain, group):
    """One call of ``sweeper`` (K16's or K17's, the fixpoint driver's) for
    ``group`` sweeps of ``state`` from one host call against ``group``
    sweeps of the twin ``plain(state, changed)``, bit for bit, the flag of
    the last sweep equal, the result in ``state``'s own buffers for an even
    ``group`` and in the sweeper's second set for an odd one."""
    import torch
    dev = state[0].device
    want, want_flag = state, torch.zeros(1, dtype=torch.int32, device=dev)
    for j in range(group):
        want = plain(want, want_flag if j == group - 1 else None)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    got = sweeper(state, flag, group)
    what = f"{what} group of {group}"
    if (got[0].data_ptr() == state[0].data_ptr()) != (group % 2 == 0):
        raise AssertionError(f"{what}: the result is in the wrong buffers")
    for g, w in zip(got, want):
        if w is not None:
            _same(g, w, what)
    if int(flag) != int(want_flag):
        raise AssertionError(f"{what}: flag {int(flag)}, twin "
                             f"{int(want_flag)}")


def _check_k13_sweeps(rs, dev):
    """K13's multi-sweep launches, ``k`` = 1-8, on random structures up to
    the tile route's reach (up to 4 on the outer axes, 32 on the innermost),
    with and without a mask and border, 1-D to 3-D, innermost lengths 1,
    31, 32, 33 and 224, and arrays smaller than one tile: each launch on the
    packed state and on bool bytes bit for bit with ``k`` twin sweeps and
    the flag of the last, and with ``k`` sweeps of the nd route."""
    import torch
    from elasticdeform_tpu_torch.ops import morphology as mo
    n = 0
    for inner, ndim, k in itertools.product((1, 31, 32, 33, 224), (1, 2, 3),
                                            range(1, 9)):
        shape = tuple(int(rs.randint(2, 12)) for _ in range(ndim - 1)) + (
            inner,)
        kx = int(rs.choice((1, 2, 3, 5, 9, 65)))
        kshape = tuple(int(rs.randint(1, 6)) for _ in range(ndim - 1)) + (kx,)
        st = rs.rand(*kshape) > 0.4
        centers = [int(rs.randint(0, s)) for s in kshape]
        if kx == 65:
            centers[-1] = 32
        border, dilation = bool(rs.rand() < 0.5), bool(rs.rand() < 0.5)
        x = torch.as_tensor(rs.rand(*shape) > 0.5).to(dev)
        mask = torch.as_tensor(rs.rand(*shape) > 0.3).to(dev) \
            if rs.rand() < 0.5 else None
        sten = mo._Stencil(shape, st, centers)
        what = (f"K13 sweeps k={k} shape={shape} structure {kshape} centres "
                f"{centers} border={border} dilation={dilation} "
                f"mask={mask is not None}")
        want_flag = torch.zeros(1, dtype=torch.int32, device=dev)
        want = mo.binary_sweeps_plain(x, st, centers, border, dilation, mask,
                                      k, want_flag)
        words = mo.pack_bits(x, border)
        gate = None if mask is None else mo.pack_bits(mask, False)
        for label, run in (
                ("packed", lambda f: mo.unpack_bits(mo.binary_sweeps(
                    words, st, centers, border, dilation, gate, k, f, sten),
                    inner)),
                ("bytes", lambda f: mo.binary_sweeps(
                    x, st, centers, border, dilation, mask, k, f, sten)),
                ("nd", lambda f: _nd_sweeps(mo, x, st, centers, border,
                                            dilation, mask, k, f, sten))):
            flag = torch.zeros(1, dtype=torch.int32, device=dev)
            got = run(flag)
            torch.cuda.synchronize()
            _same(got, want, f"{what} {label}")
            _same(flag, want_flag, f"{what} {label} changed flag")
        n += 1
    print(f"K13 multi-sweep launches bit for bit with k twin sweeps and the "
          f"last sweep's flag in {n} cases (k 1-8, 1-D to 3-D, innermost "
          f"1/31/32/33/224, innermost reach up to 32), on the packed state, "
          f"on bool bytes and against k sweeps of the nd route")


def _nd_sweeps(mo, x, st, centers, border, dilation, mask, k, flag, sten):
    for s in range(k):
        x = mo.binary_step(x, st, centers, border, dilation, mask,
                           flag if s == k - 1 else None, sten, "nd")
    return x


def _k3_plans(rb, *plan_args):
    """K3's plans for ``_bwd_plan(*plan_args)``: the tile route (None where
    one voxel's box exceeds the budget) and the direct route, forced."""
    try:
        tile = rb._bwd_plan(*plan_args, route="tile")
    except ValueError:
        tile = None
    return tile, rb._bwd_plan(*plan_args, route="direct")


def _check_k3(rb, g, bargs, in_sp, dtype, what, tally=None):
    """K3 against its plain version through the wrapper (the plan's route)
    and on both routes forced: the tile route (each block's box in shared
    memory where it fits, the direct branch where not) and every block on
    the direct branch. Atomics add in a run-dependent order,
    so float32 is held to rtol=1e-5 and atol=1e-5 * S elementwise, where S
    (the plain transpose of |g|) is the sum of the absolute terms that
    land on the element (B-spline weights are >= 0 up to rounding);
    float64 to 1e-10. ``tally`` adds the blocks of the tile route that fit
    their box and that do not (:func:`_bwd_boxes`). Returns the largest
    error and the outputs."""
    import torch
    from elasticdeform_tpu_torch.ops.resample import sample_coordinates
    displ = bargs[0]
    args = (tuple(in_sp), tuple(displ.shape[2:]), g.shape[-1], bargs[3],
            g.dtype)
    plans = [p for p in _k3_plans(rb, *args) if p is not None]
    outs = [rb.resample_transpose(g, *bargs, in_sp)] + \
        [rb._launch_k3(g, *bargs, in_sp, p) for p in plans]
    want = rb.resample_transpose_plain(g, *bargs, in_sp)
    terms = rb.resample_transpose_plain(g.abs(), *bargs, in_sp)
    torch.cuda.synchronize()
    if tally is not None and plans[0].route == "tile":
        cc = torch.stack(sample_coordinates(*bargs[:3]), 1)
        _tally_boxes(tally, _bwd_boxes(cc, in_sp, bargs[3], bargs[4],
                                       plans[0], g.shape[-1]), plans[0])
    rtol, _ = _tol(dtype, 1.0)
    err = max(_assert_close(got, want, rtol, rtol * terms.double().abs(),
                            f"{what} ({route})")
              for got, route in zip(outs, ["plan"] + [p.route
                                                      for p in plans]))
    return err, outs


def _bwd_boxes(coords, in_shape, order, mode, plan, channels=1):
    """K3/K3c's box per block (sample, tile) on ``plan``, at ``coords``
    ``(B, naxis, *out)`` as the kernel folds them: the elements of the
    box (``channels`` each), -1 where a coordinate is not finite or far
    outside (the direct branch), 0 where no voxel is inside (constant
    mode). A block fits where 0 < box <= ``plan.cap``."""
    import torch
    import torch.nn.functional as F
    from elasticdeform_tpu_torch.ops import bspline, modes
    B, naxis = coords.shape[:2]
    view, tile = plan.view, plan.tile
    pads = []
    for n, t in zip(view[:0:-1], tile[::-1]):
        pads += [0, -n % t]
    grid = (B * view[0], *(-(-n // t) for n, t in zip(view[1:], tile)))
    big = float(2 ** 30)
    size, bad, ok = None, None, None
    for h in range(naxis):
        m, inside = modes.map_coordinate(coords[:, h], in_shape[h], mode)
        ok = inside if ok is None else ok & inside
    ok = ok.reshape(B * view[0], *view[1:])
    for h in range(naxis):
        m, _ = modes.map_coordinate(coords[:, h], in_shape[h], mode)
        m = m.reshape(B * view[0], *view[1:])
        start = bspline.filter_start(m, order).double()
        far = ok & ~(m.abs() < 2 ** 29)
        lo = F.pad(torch.where(ok, start, big), pads, value=big)
        hi = F.pad(torch.where(ok, start, -big), pads, value=-big)
        far = F.pad(far, pads, value=False)
        shape = (grid[0], grid[1], tile[0], grid[2], tile[1], grid[3],
                 tile[2])
        lo = lo.reshape(shape).amin((2, 4, 6))
        hi = hi.reshape(shape).amax((2, 4, 6))
        far = far.reshape(shape).any(6).any(4).any(2)
        ext = (hi - lo + order + 1).clamp(min=0)
        size = ext * channels if size is None else size * ext
        bad = far if bad is None else bad | far
    size = torch.where(size.isfinite(), size, 0.0)
    return torch.where(bad, -1.0, size).reshape(-1)


def _tally_boxes(tally, boxes, plan):
    """Add ``boxes``' blocks that fit ``plan``'s cap (the tile branch) and
    that do not (the direct branch) to ``tally``."""
    fit = int(((boxes > 0) & (boxes <= plan.cap)).sum())
    tally["tile"] += fit
    tally["direct"] += int((boxes != 0).sum()) - fit


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
    """The BASELINE configs c1, c2, c3 and c3's gradient, c4, c5, c6, and
    c7-c20."""
    import torch
    import elasticdeform_tpu_torch as et
    from elasticdeform_tpu_torch.ops import distance as ds
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
    # sweeps, launches per route and pack and unpack launches of each call
    # are kept in ``sweeps``
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
            before = _k13_counts()
            out.append(call())
            sweeps17[name] = {k: v - before[k]
                              for k, v in _k13_counts().items()}
        return out

    cfg17 = _Config("c17", c17, 3 * math.prod(S7), [None, None, None])
    cfg17.sweeps = sweeps17

    # c18: deform_grid of an int16 CT volume at the reference's default
    # order 3, mirror, with a float32 3x3x3 grid (sigma 4): 3-D U-Net
    # pipelines augment int16 CT volumes without a float copy. The integer
    # input puts K2 on its writeback route (the product form), a launch per
    # axis, then K1. At 128^3 the CPU run took 32.7 s on the card's host,
    # so the config runs 96^3 (phase 4 times K2's writeback at 128^3)
    X18 = rs.randint(-1000, 3001, (96, 96, 96)).astype(np.int16)
    d18 = (rs.randn(3, 3, 3, 3) * 4).astype(np.float32)

    def c18(device, n=None):
        return [et.deform_grid(X18, d18, order=3, mode="mirror",
                               device=device)]

    # c19: the distance transforms of c17's segmentation (the EDT with
    # c7's anisotropic voxels, 1.5 along axis 0, and its feature indices;
    # the taxicab chamfer distance with its indices) and marker-controlled
    # watershed of c15's MRI-like volume, as organ and brain segmentation
    # pipelines run it: a uint8 gradient magnitude, -1 on the outer faces,
    # labels 1-27 at single voxels of a 3x3x3 lattice inside the ellipsoid.
    # The transforms run on the central C19_SLICES slices, the watershed
    # on the central C19_WS_SLICES (cut in PERF.md section 4); the per-call
    # K14 and K15 launches, K16 and K17 sweeps are kept in ``calls``, the
    # EDT passes' flags in ``flags``
    lo19 = (S7[0] - C19_SLICES) // 2
    M19 = M17[lo19:lo19 + C19_SLICES]
    lo19 = (S7[0] - C19_WS_SLICES) // 2
    G19 = _gradient_u8(X15[lo19:lo19 + C19_WS_SLICES])
    MK19 = _watershed_markers(rs, G19.shape)
    dev19 = {}
    calls19 = {}
    seconds19 = {}
    flags19 = {}

    def c19(device, n=None):
        m, img, mk = _on(dev19, device, M19, G19, MK19)
        out = []
        for name, call in (
                ("edt", lambda: et.distance_transform_edt(
                    m, sampling=(1.5, 1.0, 1.0), return_indices=True,
                    device=device)),
                ("cdt", lambda: et.distance_transform_cdt(
                    m, metric="taxicab", return_indices=True,
                    device=device)),
                ("watershed", lambda: [et.watershed_ift(img, mk,
                                                        device=device)])):
            before = _dist_counts()
            t0 = time.perf_counter()
            out.extend(call())
            if device == "cpu":
                seconds19[name] = time.perf_counter() - t0
            calls19[name] = {k: v - before[k]
                             for k, v in _dist_counts().items()}
            if name == "edt":
                # the passes' flags, read after the call (a tree before the
                # pass entry keeps none)
                flags19[str(device)] = list(getattr(ds.edt_core, "flags",
                                                    []))
        if device == "cpu":
            print(f"c19 CPU run per call, s: {json.dumps(seconds19)}")
        return out

    cfg19 = _Config("c19", c19, 2 * M19.size + G19.size,
                    ["exact", None, None, None, None])
    cfg19.calls = calls19
    cfg19.flags = flags19
    cfg19.inputs = (M19, G19, MK19)

    # c20: region labeling and measurement, as lesion and nuclei counting,
    # per-organ statistics after a segmentation and the largest-component
    # clean-up of a thresholded MRI run it: the components of c17's
    # segmentation under the full 3^3 structure (a few hundred) and of
    # c15's MRI-like volume above its median under the cross (about a third
    # of a million), then the sum, mean, variance, minimum and maximum of
    # the volume over the second labels and the extremum positions, centres
    # of mass, bounding boxes and 64-bucket histograms over the first, each
    # label's index 1..n. Both run on the central C20_SLICES slices (cut in
    # PERF.md section 4); the outputs that the port assembles on the host
    # (positions, centres, slices, histograms) are compared as tensors
    lo20 = (S7[0] - C20_SLICES) // 2
    M20 = M17[lo20:lo20 + C20_SLICES]
    X20 = X15[lo20:lo20 + C20_SLICES]
    T20 = float(np.median(X15))
    dev20 = {}
    seconds20 = {}

    def c20(device, n=None):
        m, x = _on(dev20, device, M20, X20)
        t0 = time.perf_counter()
        l1, n1 = et.label(m, structure=np.ones((3, 3, 3)), device=device)
        l2, n2 = et.label(x > T20, device=device)
        t1 = time.perf_counter()
        i1, i2 = np.arange(1, n1 + 1), np.arange(1, n2 + 1)
        out = [l1, l2, torch.tensor([n1, n2])]
        out += [f(x, l2, i2, device=device) for f in (
            et.sum_labels, et.mean, et.variance, et.minimum, et.maximum)]
        out += [torch.tensor(et.minimum_position(x, l1, i1, device=device)),
                torch.tensor(et.maximum_position(x, l1, i1, device=device)),
                torch.tensor(et.center_of_mass(x, l1, i1, device=device),
                             dtype=torch.float64),
                torch.tensor([[(-1, -1) if s is None else (s[k].start,
                                                           s[k].stop)
                               for k in range(3)] for s in
                              et.find_objects(l1, device=device)]),
                torch.tensor(np.stack([
                    np.full(64, -1) if h is None else h for h in
                    et.histogram(x, 0, 1, 64, l1, i1, device=device)]))]
        if device == "cpu":
            seconds20.update(label=t1 - t0, measure=time.perf_counter() - t1)
            print(f"c20 CPU run, s: {json.dumps(seconds20)}; {n1} and {n2} "
                  "labels")
        return out

    # the variance to 1e-10 of s2/c = var + mean^2 per region (output 4 the
    # mean); the float sums to rtol 1e-10
    SUM20 = (1e-10, 0.0)
    cfg20 = _Config("c20", c20, 2 * M20.size,
                    [None, None, None, SUM20, SUM20, ("variance", 4), EXACT,
                     EXACT, None, None, (1e-10, 1e-10), None, None])
    cfg20.inputs = (M20, X20, T20)

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
            cfg17,
            _Config("c18", c18, 96 ** 3, [None]),
            cfg19, cfg20]


# c19's central slices of the 160, cut to keep its CPU run under 15 s on
# the card's host: the transforms to 80 (the run took 19.6-24.8 s on the
# whole volume, 18.6 s at 112), the watershed to 48 (with the transforms at
# 80, 10.1-10.2 s at 48 and 21.8-23.6 s at 64; c19_cut.py)
C19_SLICES = 80
C19_WS_SLICES = 48
# c20's central slices of the 160, cut to keep its CPU run under 15 s on
# the card's host: the run took 76.7 s on the whole volume, 31.9 / 11.6 /
# 8.6 / 7.2 s on 128 / 96 / 80 / 64 slices (c20_cut.py, kept in commit
# 868588e), and 14.5 s on 80 inside chip_smoke.py's phase 3, so 64
# (PERF.md section 4)
C20_SLICES = 64


def _gradient_u8(vol):
    """The gradient magnitude of a float volume (central differences,
    ``np.gradient``) scaled so its 99th percentile is 255, as uint8."""
    g = np.sqrt(sum(a.astype(np.float64) ** 2 for a in np.gradient(
        vol.astype(np.float64))))
    return np.clip(g * (255.0 / np.quantile(g, 0.99)), 0, 255).astype(
        np.uint8)


def _watershed_markers(rs, shape):
    """int32 markers: -1 on the outer faces, labels 1-27 at single voxels
    of a 3 x 3 x 3 lattice at 30-70% of each axis (inside c15's ellipsoid),
    each jittered by up to 2 voxels from the seed."""
    mk = np.zeros(shape, dtype=np.int32)
    for ax in range(3):
        idx = [slice(None)] * 3
        for edge in (0, -1):
            idx[ax] = edge
            mk[tuple(idx)] = -1
    for label, frac in enumerate(itertools.product((0.3, 0.5, 0.7),
                                                   repeat=3), 1):
        pos = [int(f * (n - 1)) + int(rs.randint(-2, 3))
               for f, n in zip(frac, shape)]
        mk[tuple(pos)] = label
    return mk


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


def _c8_ring_coords(shape):
    """c8's sample coordinates as K1c reads them: the rotated, zoomed
    coordinates, reflect-folded, on the array ring-padded by 6 on each
    side; float32 ``(3, *shape)``."""
    M, off = _c8_affine(shape)
    j = np.stack(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"))
    cc = np.tensordot(M, j, axes=1) + off.reshape(3, 1, 1, 1)
    cc = np.stack([np.where(np.mod(c, 2 * n) >= n, 2 * n - 1 - np.mod(
        c, 2 * n), np.mod(c, 2 * n)) for c, n in zip(cc, shape)]) + 6
    return cc.astype(np.float32)


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
                "c17": ("binary_step",),
                "c18": ("spline_prefilter", "resample_fwd"),
                "c19": DIST_KERNELS,
                "c20": MEAS_KERNELS}
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
    # c15: one K12 per filter; c16: K10's box route for the erosion and
    # the dilation of the opening (a launch each, its three passes
    # inside), K11 for the top-hat's erosion and dilation and for the
    # non-flat dilation; c18: K2's writeback route a launch per axis, K1
    # once
    "c15": {"min_max_filter1d": 0, "min_max_filter": 0, "rank_filter": 3,
            "binary_step": 0},
    "c16": {"min_max_filter1d": 2, "min_max_filter": 3, "rank_filter": 0,
            "binary_step": 0},
    "c18": {"spline_prefilter": 3, "resample_fwd": 1,
            "spline_prefilter_transpose": 0, "resample_bwd": 0},
    # c19: K14 once, K15's band and dense kernels a pass (_C19_CALLS),
    # K16's and K17's sweeps
    "c19": {"nearest_background": 1, "minplus_pass": 4, "chamfer_sweep": 48,
            "watershed_sweep": 192},
    # c20: K18's three kernels (init, merge, compress) and its numbering
    # for each of the two labelings; K19 once for each statistic, the
    # positions' extrema included, K20 for each position
    "c20": {"label_roots": 8, "segment_reduce": 10, "segment_position": 2}}
# the launches per route of c11's K8 and K8T (one each per spatial axis),
# c12's and c13's K8, c14's K9 (correlate and convolve) and K9T, c15's K12
# (3^3 median and the 33-tap percentile on the network tile, the 5^3
# median on the select route's tile) and c16's K11 (the top-hat's erosion
# and dilation, the non-flat dilation)
_TILE_ROUTES = (("c11", "correlate1d", {"tile": 3, "lines": 0}),
                ("c11", "correlate1d_transpose", {"tile": 3, "lines": 0}),
                ("c12", "correlate1d", {"tile": 18, "lines": 0}),
                ("c13", "correlate1d", {"tile": 6, "lines": 0}),
                ("c14", "correlate_nd", {"tile": 2, "nd": 0}),
                ("c14", "correlate_nd_transpose", {"tile": 1, "nd": 0}),
                ("c15", "rank_filter", {"network_tile": 2, "network": 0,
                                        "tile": 1, "nd": 0}),
                ("c16", "min_max_filter", {"tile": 3, "nd": 0}),
                ("c16", "min_max_filter1d", {"box": 2, "lines": 0}),
                ("c18", "spline_prefilter", {"tile": 0, "lines": 0,
                                             "writeback": 3}),
                # c20: the few hundred regions' accumulators fit a block's
                # shared memory, the third of a million's do not
                ("c20", "segment_reduce", {"shared": 5, "device": 5}))
# c17's K13 sweeps per call (the fixpoints' counts of the seeded
# segmentation, as every PR since PR 5 measured them) and its (pack, unpack)
# launches: the opening packs and unpacks its erosion and its dilation, each
# fixpoint packs its input and its mask
_C17_SWEEPS = {"opening": 4, "fill_holes": 80, "propagation": 168}
_C17_PACKS = {"opening": (2, 2), "fill_holes": (2, 1),
              "propagation": (2, 1)}
# c19's launches per call: the EDT's K14 launch and K15's band and dense
# kernels (two passes, each the band of 64 and the dense kernel, which
# returns at once where the band certified; no rung alone), the CDT's K16
# sweeps and the watershed's K17 sweeps (multiples of
# SWEEPS_PER_CHECK), as the runs on the card counted them (the
# transforms' the same on 80 slices and on the whole volume; the
# watershed's on 48 slices as c19_cut.py counted them on the CPU)
_C19_CALLS = {"edt": {"nearest_background": 1, "minplus_band": 2,
                      "minplus_dense": 2},
              "cdt": {"chamfer_sweeps": 48},
              "watershed": {"watershed_sweeps": 192}}
# the tier each of c19's EDT passes keeps, read from the passes' flags after
# the call ({axis: W}, 0 the dense tier): axis 1 the dense tier (a band of
# 64 fails at 1606 voxels), axis 2 the band of 64
_C19_KEPT = {1: 0, 2: 64}
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
_MUST_NOT_LAUNCH["c18"] = ("spline_prefilter_transpose", "spline_prefilter_bc",
                           "spline_prefilter_bc_transpose",
                           "resample_coords_fwd", "resample_coords_bwd",
                           "resample_coords_grad") + _DEFORM_KERNELS[1:]
for _name in ("c1", "c2", "c3", "c3_grad", "c4", "c5", "c6", "c7", "c8",
              "c9", "c10", "c18"):
    _MUST_NOT_LAUNCH[_name] = _MUST_NOT_LAUNCH.get(_name, ()) + \
        FILTER_KERNELS + MORPH_KERNELS + DIST_KERNELS + MEAS_KERNELS + \
        PROBE_KERNELS
for _name, _tier in (("c11", FILTER_KERNELS), ("c12", FILTER_KERNELS),
                     ("c13", FILTER_KERNELS), ("c14", FILTER_KERNELS),
                     ("c15", MORPH_KERNELS), ("c16", MORPH_KERNELS),
                     ("c17", ("binary_step",)), ("c19", DIST_KERNELS),
                     ("c20", MEAS_KERNELS)):
    _MUST_NOT_LAUNCH[_name] = tuple(k for k in KERNELS if k not in _tier)


def _wrappers():
    """Each kernel's wrappers, which hold its launch counters (P2 has one
    per mode)."""
    from elasticdeform_tpu_torch.ops import probes as po
    return {k: w if isinstance(w, tuple) else (w,)
            for k, w in {**_path_wrappers(), **po.KERNEL_WRAPPERS}.items()}


def _path_wrappers():
    from elasticdeform_tpu_torch.ops import distance as ds
    from elasticdeform_tpu_torch.ops import measure as ms
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
            "binary_step": mo.binary_step,
            "nearest_background": ds.nearest_background,
            "minplus_pass": (ds.minplus_pass, ds.minplus_rung),
            "chamfer_sweep": ds.chamfer_sweep,
            "watershed_sweep": ds.watershed_sweep,
            "label_roots": (ms.label_roots, ms.label_numbers),
            "segment_reduce": ms.segment_reduce,
            "segment_position": ms.segment_position}


def _counts():
    return {k: sum(w.launches for w in ws) for k, ws in _wrappers().items()}


def _k13_counts():
    """K13's counters: sweeps, launches per route, pack and unpack
    launches (a tree before the tile route ran one sweep a launch on the
    nd route, with nothing to pack: :func:`times_ab` runs c17 there too)."""
    from elasticdeform_tpu_torch.ops import morphology as mo
    n = mo.binary_step.launches
    routes = getattr(mo.binary_step, "routes", {"tile": 0, "nd": n})
    return {"sweeps": getattr(mo.binary_step, "sweeps", n),
            **{f"{r}_launches": v for r, v in routes.items()},
            "pack_launches": getattr(getattr(mo, "pack_bits", None),
                                     "launches", 0),
            "unpack_launches": getattr(getattr(mo, "unpack_bits", None),
                                       "launches", 0)}


def _dist_counts():
    """K14-K17's launches, K15's per kernel of its passes (``band``,
    ``dense``) and of its rungs alone (``rung_w16``, ``rung_w64``,
    ``rung_dense``; a tree before the pass entry climbed the rungs); K16's
    and K17's launches are their sweeps."""
    from elasticdeform_tpu_torch.ops import distance as ds
    kernels = getattr(ds.minplus_pass, "kernels", {})
    return {"nearest_background": ds.nearest_background.launches,
            **{f"minplus_{k}": v for k, v in kernels.items()},
            **{f"minplus_rung_{k}": v
               for k, v in ds.minplus_rung.rungs.items()},
            "chamfer_sweeps": ds.chamfer_sweep.launches,
            "watershed_sweeps": ds.watershed_sweep.launches}


def _writeback_counts():
    """K2's and K6's writeback launches per form (``{"product": ..,
    "rows": ..}``; a tree without the product form counts all as rows)."""
    from elasticdeform_tpu_torch.ops import prefilter as pf
    out = {}
    for name, w in (("spline_prefilter", pf.spline_filter1d),
                    ("spline_prefilter_bc", pf.spline_filter1d_bc)):
        out[name] = dict(getattr(w, "writeback_routes", {
            "product": 0, "rows": w.routes["writeback"]}))
    return out


def _reset_counts():
    from elasticdeform_tpu_torch.ops import morphology as mo
    for ws in _wrappers().values():
        for w in ws:
            w.launches = 0
            for attr in ("routes", "writeback_routes", "rungs", "kernels"):
                for route in getattr(w, attr, {}):
                    getattr(w, attr)[route] = 0
    mo.binary_step.sweeps = mo.pack_bits.launches = 0
    mo.unpack_bits.launches = 0


def _route_counts():
    """K2's, K4's, K6's and K7's launches per route (``{"tile": ..,
    "lines": ..}``, K2 also ``"writeback"``), K9T's (``{"tile": ..,
    "nd": ..}``) and K3's and K3c's (``{"tile": .., "direct": ..}``)."""
    return {k: dict(w.routes) for k, ws in _path_wrappers().items()
            for w in (ws,) if hasattr(w, "routes")}


def _check_c19(configs):
    """c19's K14 and K15 launches and K16 and K17 sweeps per call, printed
    and held to :data:`_C19_CALLS`; the tier each EDT pass kept, read from
    the passes' flags after the call, held to :data:`_C19_KEPT`."""
    from elasticdeform_tpu_torch.ops import distance as ds
    for cfg in configs:
        if cfg.name != "c19":
            continue
        print(f"c19 K14 launches, K15 launches per kernel and K16 and K17 "
              f"sweeps per call: {json.dumps(cfg.calls)}")
        got = {name: {k: v for k, v in c.items() if v}
               for name, c in cfg.calls.items()}
        if got != _C19_CALLS:
            raise AssertionError(f"c19: launches per call {got}, not "
                                 f"{_C19_CALLS}")
        kept = ds.kept_rungs(cfg.flags["cuda"])
        print(f"c19 EDT: the tier each pass kept, from its flag: {kept} "
              "(0 the dense tier)")
        if kept != _C19_KEPT:
            raise AssertionError(f"c19: the passes kept {kept}, not "
                                 f"{_C19_KEPT}")


def _against_cpu(configs, outs):
    """Each config's outputs against the port's ``device="cpu"`` run."""
    import torch
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
            if isinstance(tol, tuple) and tol[0] == "variance":
                m = torch.as_tensor(ref[tol[1]])
                err = _assert_close(got, want, 0.0, 1e-10 * (want + m * m),
                                    f"{what} vs CPU")
                print(f"{what}: {tuple(got.shape)} {got.dtype} matches the "
                      f"CPU run (max abs err {err:.3e}, atol 1e-10 of s2/c "
                      "per region)")
                continue
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


def phase_main_path():
    """Phase 3: the public entry points on the card, counted, then each
    output against the port's CPU run."""
    import torch
    configs = _configs()
    outs, launches, cfg_routes = {}, {}, {}
    total = dict.fromkeys(PATH_KERNELS, 0)
    routes = {k: dict.fromkeys(v, 0) for k, v in _route_counts().items()}
    k13 = dict.fromkeys(_k13_counts(), 0)
    writeback = {}
    for cfg in configs:
        _reset_counts()
        outs[cfg.name] = cfg.run("cuda")
        torch.cuda.synchronize()
        launches[cfg.name] = _counts()
        cfg_routes[cfg.name] = _route_counts()
        writeback[cfg.name] = _writeback_counts()
        for k, v in _k13_counts().items():
            k13[k] += v
        for k in PATH_KERNELS:
            total[k] += launches[cfg.name][k]
        for k, by_route in cfg_routes[cfg.name].items():
            if sum(by_route.values()) != launches[cfg.name][k]:
                raise AssertionError(f"{cfg.name}: {k}'s route counts "
                                     f"{by_route} do not add up to its "
                                     f"{launches[cfg.name][k]} launches")
            for r, v in by_route.items():
                routes[k][r] += v
    print(f"main path launches per config: {json.dumps(launches)}")
    print(f"main path launches per route: {json.dumps(routes)}")
    shown = ("spline_prefilter", "spline_prefilter_bc", "resample_bwd",
             "resample_coords_bwd", "correlate1d", "correlate1d_transpose",
             "correlate_nd", "correlate_nd_transpose", "min_max_filter1d",
             "min_max_filter", "rank_filter")
    print("K2's, K6's, K3's, K3c's, K8's, K8T's, K9's, K9T's, K10's, K11's "
          "and K12's launches per route and config: " + json.dumps(
              {name: {k: r[k] for k in shown if sum(r[k].values())}
               for name, r in cfg_routes.items()}))
    # c11-c13's K8 launches, c11's three K8T launches, c14's K9 and K9T,
    # c15's network filters and 5^3 median and c16's K11 take the tile
    # routes
    for name, k, want in _TILE_ROUTES:
        if cfg_routes[name][k] != want:
            raise AssertionError(f"{name}: {k}'s launches per route "
                                 f"{cfg_routes[name][k]}, not {want}")
    # c18 alone has an integer input with the prefilter on: it takes K2's
    # writeback route, on the product form (no config takes K6's
    # fixed-order route); c8 and c9 run K6 on its tile route only
    print(f"K2's and K6's writeback launches per form and config: "
          f"{json.dumps({k: v for k, v in writeback.items() if any(sum(f.values()) for f in v.values())})}")
    if writeback["c18"]["spline_prefilter"] != {"product": 3, "rows": 0}:
        raise AssertionError(f"c18 must run K2's writeback route on its "
                             f"product form: {writeback['c18']}")
    for name, r in cfg_routes.items():
        if r["spline_prefilter"]["writeback"] and name != "c18":
            raise AssertionError(f"{name} took K2's writeback route: "
                                 f"{r['spline_prefilter']}")
        k6 = r["spline_prefilter_bc"]
        if k6["writeback"] or name in ("c8", "c9") and (k6["lines"] or
                                                       not k6["tile"]):
            raise AssertionError(f"{name} must run K6 on its tile route "
                                 f"only: {k6}")
    if min(total.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never ran: {total}")
    for k, by_route in routes.items():
        for main in {"min_max_filter1d": ("box",),
                     "segment_reduce": ("shared", "device")}.get(k,
                                                                 ("tile",)):
            if by_route[main] <= 0:
                raise AssertionError(f"{k} never ran on its {main} route: "
                                     f"{by_route}")
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
        print(f"{cfg.name} K13 sweeps, launches per route and pack/unpack "
              f"launches per call: {json.dumps(sweeps)}")
        got = {name: c["sweeps"] for name, c in sweeps.items()}
        if got != _C17_SWEEPS:
            raise AssertionError(f"{cfg.name}: K13 sweeps per call {got}, "
                                 f"not {_C17_SWEEPS}")
        for name, c in sweeps.items():
            if c["nd_launches"] or not c["tile_launches"] or \
                    (c["pack_launches"], c["unpack_launches"]) != \
                    _C17_PACKS[name]:
                raise AssertionError(
                    f"{cfg.name} {name}: K13 must run on its tile route, "
                    f"packing each input and mask once and unpacking each "
                    f"result once {_C17_PACKS[name]}: {c}")

    _check_c19(configs)
    _against_cpu(configs, outs)
    return total, launches, routes, k13


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


def _split_us(fn, n=200, profiled=20):
    """``(host, device, one launch)`` microseconds per call of ``fn``:
    the host's, ``n`` calls on ``time.perf_counter`` with no sync (the
    enqueue); the device's, the profiler's device time of ``profiled`` calls
    (every kernel, memset and copy they ran); and one call between two CUDA
    events after a sync (the launch's latency and the device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    host = _host_us(fn, n)
    one = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        one.append(start.elapsed_time(end) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            fn()
        torch.cuda.synchronize()
    device = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0)
                 for e in prof.key_averages()) / profiled
    return host, device, statistics.median(one)


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
    pl_vmem, P3 at scatrate, P4 at pl_dma). Returns ``{probe label: (ms,
    plain ms, library ms, bound, rows moved)}``."""
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
    # P2's host and device time per call, beside its library call's
    split = {}
    for label, (_, _, _, lib, _) in spec.items():
        _, kernel, _, call, _, _ = cases[label]
        if kernel != "row_gather":
            continue
        k, lb = _split_us(call), _split_us(lib)
        split[label] = {"host_us": k[0], "device_us": k[1],
                        "one_launch_us": k[2], "library_host_us": lb[0],
                        "library_device_us": lb[1],
                        "library_one_launch_us": lb[2]}
        print(f"P2 {label}: host {k[0]:.2f} us per call (no sync), device "
              f"{k[1]:.2f} us per call (profiler), one launch between "
              f"events {k[2]:.2f} us; library: host {lb[0]:.2f}, device "
              f"{lb[1]:.2f}, one launch {lb[2]:.2f} us [{card}]")
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
            extra["split_us"] = split
        row(kernel, "probes.cu", replaces, ms, plain_ms, bound, lib_ms,
            errs.get(kernel, 0.0), at=label, extra=extra)
    return times



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


def _tap_box_share(coords, in_shape, order, mode, block=256, limit=16384):
    """The share of K5's blocks (``block`` consecutive output voxels of a
    sample) whose taps' bounding box, float32 with one channel, fits
    ``limit`` bytes and needs no fold, and the median box in bytes: the
    blocks that staging the box in shared memory could serve."""
    from elasticdeform_tpu_torch.ops import bspline, modes
    B, naxis = coords.shape[:2]
    fits, vol = None, None
    for h in range(naxis):
        m, _ = modes.map_coordinate(coords[:, h], in_shape[h], mode)
        start = bspline.filter_start(m, order).reshape(B, -1, block)
        lo, hi = start.amin(-1), start.amax(-1) + order
        ok = (lo >= 0) & (hi <= in_shape[h] - 1)
        fits = ok if fits is None else fits & ok
        vol = hi - lo + 1 if vol is None else vol * (hi - lo + 1)
    fits &= vol * 4 <= limit
    return float(fits.float().mean()), float(vol.float().median()) * 4


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


# K3/K3c's plans that phase 4 times beside the wrapper's: each route, the
# other tile the model named, a larger box
_K3_VARIANTS = (("direct", dict(route="direct")),
                ("tile 8x8x8", dict(route="tile")),
                ("tile 4x8x16", dict(route="tile", tile=(4, 8, 16))),
                ("budget 24 KB", dict(route="tile", budget=24576)))


def _k3_times(label, run, coords, in_shape, order, mode, plan_args, card,
              k3_lines, library_ms=None):
    """Phase 4's K3 or K3c at one shape: ``run(plan)`` launches it on a
    plan (``_launch_k3`` or ``_launch_k3c``, no counts), ``plan_args`` are
    ``_bwd_plan``'s. Times the wrapper's plan and each of
    :data:`_K3_VARIANTS` (CUDA events, median of 10), the tile route's box
    per block at ``coords`` (:func:`_bwd_boxes`: share that fits, median,
    p90 and p99 in KB), its shared-memory adds (the taps of the blocks that
    fit) and an upper bound of its device-memory atomics (their box
    elements, plus the taps of the blocks that do not fit); prints one line
    and appends it to ``k3_lines`` for the rates beside P3's
    (:func:`_print_k3_lines`). Returns the numbers."""
    import torch
    from elasticdeform_tpu_torch.ops import resample_bwd as rb
    plan = rb._bwd_plan(*plan_args)
    tile = rb._bwd_plan(*plan_args, route="tile")
    out = {"route": plan.route, "tile": list(tile.tile), "smem": tile.smem,
           "ms": _time_ms(lambda: run(plan)),
           "blocks_per_sm": rb.bwd_occupancy(plan_args[4], order,
                                             len(in_shape), plan),
           "tile_blocks_per_sm": rb.bwd_occupancy(plan_args[4], order,
                                                  len(in_shape), tile)}
    for name, kw in _K3_VARIANTS:
        p = rb._bwd_plan(*plan_args, **kw)
        out[f"{name} ms"] = _time_ms(lambda p=p: run(p))
    # the tile kernel with no box: every block on its direct branch, the
    # direct route before it had a kernel of its own
    out["tile kernel, no box ms"] = _time_ms(lambda: run(tile._replace(
        cap=0, smem=0)))
    boxes = _bwd_boxes(coords, in_shape, order, mode, tile, plan_args[2])
    taps = (order + 1) ** len(in_shape) * plan_args[2]
    fit = (boxes > 0) & (boxes <= tile.cap)
    kb = boxes[boxes > 0].double() * (4 if plan_args[4] == torch.float32
                                      else 8) / 1024
    q = torch.quantile(kb.float().cpu(), torch.tensor([0.5, 0.9, 0.99]))
    # every voxel of c5, c7 and c8 is inside and every tile full
    n_vox = coords.shape[0] * math.prod(coords.shape[2:])
    share = float(fit.float().mean())
    out.update({"fit_share": share, "box_kb_median": float(q[0]),
                "box_kb_p90": float(q[1]), "box_kb_p99": float(q[2]),
                "shared_adds": n_vox * taps * share,
                "device_atomics_at_most": float(boxes[fit].double().sum())
                + n_vox * taps * (1 - share)})
    out["library_ms"] = library_ms
    lib = "" if library_ms is None else \
        f"; grid_sampler_3d_backward input half {library_ms:.4f} ms"
    print(f"{label}: the plan's {plan.route} route {out['ms']:.4f} ms "
          f"({out['blocks_per_sm']} blocks per SM); " + ", ".join(
              f"{n} {out[f'{n} ms']:.4f} ms" for n, _ in _K3_VARIANTS) +
          f", the tile kernel with no box (the older direct route) "
          f"{out['tile kernel, no box ms']:.4f} ms" +
          f"; the tile route ({'x'.join(map(str, tile.tile))}, "
          f"{tile.smem} B box budget, {out['tile_blocks_per_sm']} blocks per "
          f"SM): blocks whose box fits {100 * share:.2f}%, box median "
          f"{out['box_kb_median']:.1f} KB, p90 {out['box_kb_p90']:.1f}, p99 "
          f"{out['box_kb_p99']:.1f}{lib} [{card}]")
    k3_lines.append((label, out))
    return out


def _print_k3_lines(k3_lines, probe_times, card):
    """One line each for K3 at c5 (orders 3, 2 and 1) and K3c at c7 and
    c8: the tile route's shared-memory adds and device-memory atomics (at
    most) per second, and the direct route's device-memory atomics per
    second (one a tap), beside P3's measured rate of float32 atomics into
    L2 (probe scatrate) and the taps a second of
    ``grid_sampler_3d_backward``'s input half where it was timed."""
    ms, _, _, _, rows = probe_times["scatrate"]
    p3 = rows * 128 / ms / 1e6
    for label, o in k3_lines:
        t, d = o["tile 8x8x8 ms"], o["direct ms"]
        taps = o["shared_adds"] / o["fit_share"] if o["fit_share"] else 0.0
        print(f"{label}: tile route {o['shared_adds'] / t / 1e6:.1f} G "
              f"shared adds/s and at most "
              f"{o['device_atomics_at_most'] / t / 1e6:.1f} G device-memory "
              f"atomics/s ({o['device_atomics_at_most'] / 1e6:.1f} M); "
              f"direct route {taps / d / 1e6:.1f} G device-memory "
              f"atomics/s ({taps / 1e6:.1f} M, one a tap); P3's rate "
              f"{p3:.1f} G/s" + ("" if o["library_ms"] is None else
                                f"; the library's taps "
                                f"{taps / o['library_ms'] / 1e6:.1f} G/s") +
              f" [{card}]")


def _launcher(kernel, bc):
    """``run(x, order, axis, plan)`` of ``kernel`` (K2, K4, K6 or K7) under
    ``bc``, through the private launchers (no counts)."""
    from elasticdeform_tpu_torch.ops import prefilter as pf
    if kernel == "K2":
        return pf._launch_filter
    if kernel == "K6":
        return lambda x, o, a, p: pf._launch_bc_filter(x, o, a, bc, p)
    return lambda x, o, a, p: pf._launch_transpose(x, o, a, bc, p)


def _tile_axes(name, x, order, bc, card, kernel):
    """Phase 4's per-axis lines of ``kernel`` (K2, K4, K6 or K7) under
    ``bc`` on ``x`` along axes 1-3, through the private launchers (no
    counts): the wrapper's plan (route, W, blocks per SM, shared bytes)
    timed alone (CUDA events, median of 10) and back to back
    (``_loop_ms``), the lines route alone, and every tile width back to
    back. Returns the lists of per-axis ms and the width the wrapper took
    on each axis."""
    from elasticdeform_tpu_torch.ops import prefilter as pf
    res = {"per_axis_ms": [], "per_axis_loop_ms": [],
           "lines_route_per_axis_ms": [], "widths": [],
           "width_loop_ms": {w: [] for w in pf.TILE_WIDTHS},
           "stage_only_loop_ms": [], "clone_loop_ms": []}
    sms = pf._sm_count(x.device)
    for a in (1, 2, 3):
        shape = pf._lines(x, a)

        def run(plan, a=a, order=order):
            launch = _launcher(kernel, bc)
            return lambda: launch(x, order, a, plan)
        plan = pf._plan_for(x, a)
        ms, loop = _time_ms(run(plan)), _loop_ms(run(plan))
        lines_ms = _time_ms(run(pf._tile_plan(*shape, x.dtype,
                                              route="lines")))
        # the tile's copy alone (no poles: staged and stored, no recursion)
        # and a plain device copy of the volume
        stage = _loop_ms(run(plan, order=1))
        clone = _loop_ms(lambda: x.clone())
        for k, v in (("per_axis_ms", ms), ("per_axis_loop_ms", loop),
                     ("lines_route_per_axis_ms", lines_ms),
                     ("widths", plan.width), ("stage_only_loop_ms", stage),
                     ("clone_loop_ms", clone)):
            res[k].append(v)
        parts = []
        for w in pf.TILE_WIDTHS:
            try:
                p = pf._tile_plan(*shape, x.dtype, width=w, route="tile")
            except ValueError:
                res["width_loop_ms"][w].append(None)
                parts.append(f"W={w} does not fit")
                continue
            wm = _loop_ms(run(p))
            res["width_loop_ms"][w].append(wm)
            parts.append(f"W={w} {wm:.4f} ms "
                         f"({pf.tile_blocks_per_sm(x.dtype, kernel, bc, p)}"
                         f" blocks "
                         f"per SM, model {pf.blocks_per_sm(p)}; "
                         f"{pf.waves(p, sms)} waves; {p.smem} B)")
        occ = (f", {pf.tile_blocks_per_sm(x.dtype, kernel, bc, plan)} "
               f"blocks per SM"
               f", {pf.waves(plan, sms)} waves of {sms} SMs, {plan.smem} "
               f"bytes shared" if plan.route == "tile" else "")
        print(f"{name} axis {a} (outer, n, inner)={shape}: {ms:.4f} ms "
              f"(back to back {loop:.4f}) on the {plan.route} route, "
              f"W={plan.width}{occ}; lines route {lines_ms:.4f} ms; the "
              f"tile's copy alone {stage:.4f} ms, x.clone() {clone:.4f} ms; "
              f"tile widths back to back: {'; '.join(parts)} [{card}]")
    return res


def _k10_one_pass_times(v, card):
    """K10 on one axis (``minimum_filter1d`` / ``maximum_filter1d``) where
    the box route's edge tiles weigh most: c16's volume ``v`` along its
    contiguous axis at size 3, and batches whose contiguous axis of 96 or
    160 is not a multiple of 64 (1-byte and 2-byte types), along the axis
    above it. The wrapper (the plan's route) beside the lines route, each
    held to the other bit for bit; the plan's tile."""
    import torch
    from elasticdeform_tpu_torch.ops import morphology as mo
    gen = torch.Generator(device=v.device).manual_seed(7)
    cases = [("c16 axis 2 size 3", v, 2, 3)]
    for shape, dtype in (((64, 128, 128, 96), torch.uint8),
                         ((64, 128, 128, 160), torch.int16)):
        x = torch.randint(0, 120, shape, generator=gen, device=v.device,
                          dtype=torch.int16).to(dtype)
        cases.append((f"{shape} {str(dtype)[6:]} axis 2 size 5", x, 2, 5))
    out = {}
    for label, x, axis, size in cases:
        kshape = [1] * x.dim()
        kshape[axis] = size
        plan = mo._box_plan(tuple(x.shape), tuple(kshape), x.dtype)

        def box(x=x, axis=axis, size=size):
            return mo.min_max_filter1d(x, size, axis, "reflect", 0,
                                       size // 2, True)

        def lines(x=x, axis=axis, size=size):
            return mo._launch_lines(x, size, axis, "reflect", 0, size // 2,
                                    True)
        _same(box(), lines(), f"K10 one pass at {label}, box vs lines")
        out[label] = {"route": plan.route, "tile": plan.tile,
                      "ms": _time_ms(box), "lines_ms": _time_ms(lines)}
        print(f"K10 one pass at {label}: the plan's {plan.route} route, "
              f"tile {plan.tile}, {out[label]['ms']:.4f} ms; the lines route "
              f"{out[label]['lines_ms']:.4f} ms [{card}]")
    return out


def _times_writeback(rs, card):
    """K2's writeback route (an integer input with the prefilter on, order
    3) over every deformed axis at c2's 200 x 300 (uint8, float64 compute,
    as ``deform_grid`` with c2's float64 grid) and on a 128^3 int16
    volume (float32 compute, as ``deform_grid`` with a float32 grid, c18's
    kind at the size before its cut): the
    wrapper's time (the product form, chunk skip on), held to its twin bit
    for bit, beside the product form without the skip, the rows route
    (``writeback_rows``), the twin, K2's recursion without the writeback and
    ``tensordot`` on the same input, and its bound: ``numel * n``
    multiply-adds per axis at the float64 or float32 rate (each term
    counted, skipped or not)."""
    import torch
    from elasticdeform_tpu_torch.ops import prefilter as pf
    dev = torch.device("cuda")
    out = {}
    for label, shape, idt, dtype in (
            ("c2 200x300 uint8 float64", (1, 200, 300, 1), np.uint8,
             torch.float64),
            ("128^3 int16 float32", (1, 128, 128, 128, 1), np.int16,
             torch.float32)):
        lo, hi = (0, 256) if idt is np.uint8 else (-1000, 3001)
        x = torch.as_tensor(rs.randint(lo, hi, shape), dtype=dtype,
                            device=dev)
        axes = tuple(range(1, len(shape) - 1))
        mats = [torch.as_tensor(pf.filter_matrix(shape[a], 3), dtype=dtype,
                                device=dev) for a in axes]

        def chain(fn, int_dtype=idt, x=x, axes=axes):
            def run():
                y = x
                for a in axes:
                    y = fn(y, 3, a, int_dtype)
                return y
            return run

        def form(rows, finite):
            # the wrapper's plan (the product form at these shapes), or
            # its rows route's plan
            def fn(y, o, a, int_dtype):
                plan = pf._writeback_plan_for(y, a)
                if plan.route != "product":
                    raise AssertionError(f"K2 writeback at {label}: plan "
                                         f"{plan}")
                return pf._launch_writeback(y, o, a, "mirror",
                                            plan.rows if rows else plan,
                                            int_dtype, finite)
            return fn

        def lib(x=x, axes=axes, mats=mats):
            y = x
            for a, m in zip(axes, mats):
                y = torch.movedim(torch.tensordot(m, y, dims=([1], [a])), 0,
                                  a)
            return y
        got = chain(pf.spline_filter1d)()
        want = chain(pf.spline_filter1d_plain)().contiguous()
        for other, what in ((got, "the wrapper"),
                            (chain(form(False, False))(),
                             "the product form without the skip"),
                            (chain(form(True, True))(), "the rows route")):
            if not torch.equal(_bits(other), _bits(want)):
                raise AssertionError(f"K2 writeback at {label}: {what} "
                                     "differs from the plain twin")
        numel = x.numel()
        ops = sum(2 * numel * shape[a] for a in axes)
        bound = _bound(2 * len(axes) * numel * x.element_size(), ops,
                       FP64_FLOPS if dtype == torch.float64 else FP32_FLOPS)
        res = {"ms": _time_ms(chain(pf.spline_filter1d)),
               "no_skip_ms": _time_ms(chain(form(False, False))),
               "rows_ms": _time_ms(chain(form(True, True))),
               "device_ms": _device_ms(chain(pf.spline_filter1d)),
               "rows_device_ms": _device_ms(chain(form(True, True))),
               "library_device_ms": _device_ms(lib),
               "plain_ms": _time_ms(chain(pf.spline_filter1d_plain), reps=3,
                                    warmup=1),
               "recursion_ms": _time_ms(chain(pf.spline_filter1d, None)),
               "library_ms": _time_ms(lib), "bound_ms": bound[0],
               "bound_by": bound[1]}
        out[label] = res
        print(f"K2 writeback route at {label}, order 3, {len(axes)} axes: "
              f"product form {res['ms']:.4f} ms (without the chunk skip "
              f"{res['no_skip_ms']:.4f} ms; the rows route "
              f"{res['rows_ms']:.4f} ms; plain {res['plain_ms']:.4f} ms; "
              f"K2's recursion without the writeback "
              f"{res['recursion_ms']:.4f} ms; tensordot "
              f"{res['library_ms']:.4f} ms; bound {bound[0]:.4f} ms by "
              f"{bound[1]}); on the device {res['device_ms']:.4f} ms, the "
              f"rows route {res['rows_device_ms']:.4f} ms, tensordot "
              f"{res['library_device_ms']:.4f} ms [{card}]")
    return out


def _times_resampler(row, card, k1_lines, k3_lines):
    """Phase 4 for the general resampler: K1c, K3c and K5c at the c7 shapes
    (order 1, nearest) beside grid_sample; K6 and K7 at the c8 shapes
    beside the tensordot with filter_matrix_bc; K1c and K3c at the c8
    shapes (order 3, on the ring-padded array). K1c's two shapes go into
    ``k1_lines`` (:func:`_print_k1_lines`), K3c's into ``k3_lines``
    (:func:`_print_k3_lines`)."""
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
    bf16 = _time_ms(lambda: rsm.resample_coords(x, coords, *a, 0.0,
                                                torch.bfloat16))
    k1_lines.append(("K1c resample_coords_fwd at c7 shapes (order 1, "
                     "nearest)", o1["fwd"][0], vox * 2 ** naxis, bf16,
                     o1["fwd"][1]))
    row("resample_coords_fwd", "resample.cu",
        "elasticdeform_tpu/ops/deform.py:533", o1["fwd"][0],
        _time_ms(lambda: rsm.resample_coords_plain(x, coords, *a, 0.0),
                 reps=3, warmup=1),
        _bound(vox * (1 + naxis + 1) * 4, _k1_ops(B, n_out, naxis, 1, 1)),
        o1["fwd"][1], 0.0, at="c7", extra={"bf16_table_ms": bf16})
    k3c_err = _assert_close(
        rb.resample_coords_transpose(g, coords, *a, S),
        rb.resample_coords_transpose_plain(g, coords, *a, S), 1e-5,
        1e-5 * rb.resample_coords_transpose_plain(
            g.abs(), coords, *a, S).double(), "K3c at c7 shapes")
    k3c = _k3_times("K3c resample_coords_bwd at c7 shapes (order 1, "
                    "nearest)",
                    lambda plan: rb._launch_k3c(g, coords, *a, S, plan),
                    coords, S, *a, (S, S, 1, 1, g.dtype), card, k3_lines,
                    o1["bwd"][1])
    row("resample_coords_bwd", "resample_bwd.cu",
        "elasticdeform_tpu/ops/deform.py:608", k3c["ms"],
        _time_ms(lambda: rb.resample_coords_transpose_plain(g, coords, *a, S),
                 reps=3, warmup=1),
        _bound(vox * (1 + naxis + 1) * 4, _k1_ops(B, n_out, naxis, 1, 1)),
        o1["bwd"][1], k3c_err, at="c7", extra=k3c)
    box = _tap_box_share(coords, S, *a)
    print(f"K5c's 256-voxel blocks at c7 shapes (order 1, nearest) whose "
          f"tap box fits 16 KB unfolded: {100 * box[0]:.2f}%, median box "
          f"{box[1] / 1024:.1f} KB")
    row("resample_coords_grad", "resample_bwd.cu",
        "elasticdeform_tpu/ops/windows.py:1247", o1["grad"][0],
        _time_ms(lambda: rb.resample_coords_grad_plain(x, g, coords, *a),
                 reps=3, warmup=1),
        _bound(vox * (1 + 1 + 2 * naxis) * 4,
               _k5_ops(B, n_out, naxis, 1, 1)),
        o1["grad"][1], 0.0, at="c7", extra={"box_16k_share": box[0]})
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
    for name, kernel, fn, plain, axes, lib_mats, replaces in (
            ("spline_prefilter_bc", "K6", pf.spline_filter1d_bc,
             pf.spline_filter1d_bc_plain, (1, 2, 3), mats,
             "elasticdeform_tpu/ops/prefilter.py:150"),
            ("spline_prefilter_bc_transpose", "K7",
             pf.spline_filter1d_bc_transpose,
             pf.spline_filter1d_bc_transpose_plain, (3, 2, 1), t_mats,
             "elasticdeform_tpu/ops/prefilter.py:177")):
        err = _assert_close(chain(fn, axes)(), chain(plain, axes)(),
                            *_tol(torch.float32, scale),
                            f"{name} at c8 shapes")

        def lines(y, o, a, bc, kernel=kernel):
            return _launcher(kernel, bc)(y, o, a, pf._tile_plan(
                *pf._lines(y, a), y.dtype, route="lines"))
        if not torch.equal(_bits(chain(fn, axes)()),
                           _bits(chain(lines, axes)())):
            raise AssertionError(f"{name} at c8 shapes: the tile route "
                                 "differs from the lines route")
        extra = {"lines_route_ms": _time_ms(chain(lines, axes)),
                 **_tile_axes(f"{name} at (1, 160, 192, 224) f32", v,
                              order, "reflect", card, kernel)}
        row(name, "prefilter.cu", replaces, _time_ms(chain(fn, axes)),
            _time_ms(chain(plain, axes)), bound,
            _time_ms(chain(None, axes, lib_mats)), err, at="c8",
            extra=extra)

    # K1c and K3c as c8 runs them: order 3, nearest, on the ring-padded
    # (6 each side) coefficients at the rotated, zoomed, reflect-folded
    # coordinates
    P = tuple(n + 12 for n in S)
    coeffs = torch.as_tensor(rs.rand(1, *P, 1).astype(np.float32),
                             device=dev)
    gy = torch.as_tensor(rs.randn(1, *S, 1).astype(np.float32), device=dev)
    c8c = torch.as_tensor(_c8_ring_coords(S)[None], device=dev)
    k1 = _time_ms(lambda: rsm.resample_coords(coeffs, c8c, 3, 0, 0.0))
    k1_lines.append(("K1c resample_coords_fwd at c8 shapes (order 3, "
                     "nearest)", k1, numel * 4 ** 3,
                     _time_ms(lambda: rsm.resample_coords(
                         coeffs, c8c, 3, 0, 0.0, torch.bfloat16)), None))
    k3 = _k3_times("K3c resample_coords_bwd at c8 shapes (order 3, "
                   "nearest)",
                   lambda plan: rb._launch_k3c(gy, c8c, 3, 0, P, plan), c8c,
                   P, 3, 0, (P, S, 1, 3, gy.dtype), card, k3_lines)["ms"]
    b1 = _bound((math.prod(P) + 4 * numel) * 4, _k1_ops(1, numel, 3, 3, 1))
    b3 = _bound((4 * numel + math.prod(P)) * 4, _k1_ops(1, numel, 3, 3, 1))
    print(f"resample_coords_fwd at c8 shapes (order 3): {k1:.4f} ms, bound "
          f"{b1[0]:.4f} ms by {b1[1]}; resample_coords_bwd: {k3:.4f} ms, "
          f"bound {b3[0]:.4f} ms by {b3[1]} [{card}]")


def _k8_axes(label, x, w, c, mode, cval, pair, axes, card, mats=None):
    """K8 per axis of ``x`` (``w``, centre ``c``, ``mode``, ``pair``): the
    plan's route, width, shared bytes and waves, its ms, every width's, the
    lines route's and, with ``mats``, the banded ``tensordot`` with that
    axis' matrix, beside the axis' byte bound; the tile route held to the
    lines route bit for bit first. Returns the per-axis lists."""
    import torch
    from elasticdeform_tpu_torch.ops import filters as ft
    from elasticdeform_tpu_torch.ops import prefilter as pf
    L = len(w)
    lines_plan = ft.LinePlan("lines")
    out = {"axis_ms": [], "lines_route_axis_ms": [], "axis_tensordot_ms": [],
           "widths": [], "width_ms": []}
    item = x.element_size()
    axis_bound = _bound(2 * x.numel() * item, x.numel() * 2 * L,
                        FP32_FLOPS if item == 4 else FP64_FLOPS)
    for a in axes:
        outer, n, inner = pf._lines(x, a)
        e = ft._k8_edges(n, L, c, mode)
        blocks = ft.k8_sm_blocks(x.dtype)
        p = ft._line_plan(outer, n, inner, x.dtype, L, len(e.table),
                          sm_blocks=blocks)
        if not torch.equal(_bits(ft.correlate1d(x, w, a, mode, cval, c, pair)),
                           _bits(ft._launch_line(x, w, a, mode, cval, c,
                                                 pair, lines_plan))):
            raise AssertionError(f"K8 at {label} shapes, axis {a}: the tile "
                                 "route differs from the lines route")
        ms = _time_ms(lambda a=a: ft.correlate1d(x, w, a, mode, cval, c,
                                                 pair))
        lines_ms = _time_ms(lambda a=a: ft._launch_line(
            x, w, a, mode, cval, c, pair, lines_plan))
        every = {}
        for W in pf.TILE_WIDTHS:
            try:
                q = ft._line_plan(outer, n, inner, x.dtype, L, len(e.table),
                                  width=W, sm_blocks=blocks)
            except ValueError:
                continue
            every[W] = _time_ms(lambda q=q, a=a: ft._launch_line(
                x, w, a, mode, cval, c, pair, q))
        lib_ms = None
        if mats is not None:
            m = mats[a]
            lib_ms = _time_ms(lambda a=a, m=m: torch.movedim(
                torch.tensordot(m, x, dims=([1], [a])), 0, a))
        out["axis_ms"].append(ms)
        out["lines_route_axis_ms"].append(lines_ms)
        out["axis_tensordot_ms"].append(lib_ms)
        out["widths"].append(p.tile.width if p.route == "tile" else None)
        out["width_ms"].append(every)
        t = p.tile
        print(f"correlate1d at {label} shapes {tuple(x.shape)} {x.dtype}, "
              f"{L} taps, {'paired' if pair else 'direct'} order, axis {a}: "
              f"{p.route} route"
              + (f" W={t.width} {'packed' if t.packed else 'columns'}"
                 f"{', outputs gathered' if p.gather else ''}, {p.smem} B "
                 f"shared, {t.blocks} blocks, {ft.line_waves(p, 132)} waves"
                 if p.route == "tile" else "")
              + f"; {ms:.4f} ms (every width {json.dumps(every)}, lines "
              f"route {lines_ms:.4f}"
              + (f", tensordot {lib_ms:.4f}" if lib_ms is not None else "")
              + f", bound {axis_bound[0]:.4f} by {axis_bound[1]}) [{card}]")
    out["axis_bound_ms"] = axis_bound[0]
    return out


def _times_filters(row, card):
    """Phase 4 for the filter tier: K8 and K8T along the three spatial axes
    of c11's field (sigma 2, 17 taps, reflect) beside the JAX package's
    formulation (a banded-matrix ``tensordot`` per axis, the library time)
    and ``conv3d`` with an (L,1,1), (1,L,1), (1,1,L) kernel under zero
    padding, K8 per axis on each route and at every width (:func:`_k8_axes`);
    K8 in float64 on the paired route at c13's shapes, the same; K9 and K9T
    at c14's shapes (5^3 kernel, constant) beside ``conv3d`` and
    ``conv_transpose3d`` (zero padding), K9 on each route and at every
    column, also for c14's 3^3 convolve of a batch of two. cuDNN's TF32 is
    off for the yardsticks."""
    import torch
    import torch.nn.functional as F
    from elasticdeform_tpu_torch.ops import filters as ft
    from elasticdeform_tpu_torch.ops import prefilter as pf
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
    k8_axes = _k8_axes("c11", f, w, c, "reflect", 0.0, 0, (1, 2, 3), card,
                       mats)
    conv_ms = _time_ms(conv_chain)
    lines_plan = ft.LinePlan("lines")
    print(f"correlate1d conv3d (zero padding) chain at c11 shapes "
          f"{conv_ms:.4f} ms [{card}]")
    # K8 on c13's paired route: float64, sigma 1 (9 taps), mirror
    v = torch.as_tensor(rs.randint(-1024, 3072, (512, 512, 300)),
                        dtype=torch.float64, device=dev)
    w1 = ft.gaussian_weights(1.0, 0, 4.0, None)
    k13 = _k8_axes("c13", v, w1, 4, "mirror", 0.0, 1, (0, 1, 2), card)
    del v
    row("correlate1d", "filters.cu", "elasticdeform_tpu/ops/filters.py:125",
        _time_ms(chain(k8, (1, 2, 3))),
        _time_ms(chain(lambda y, a: ft.correlate1d_plain(
            y, w, a, "reflect", 0.0, c), (1, 2, 3))), bound,
        _time_ms(chain(lambda y, a: mat(y, a), (1, 2, 3))), err, at="c11",
        extra={"conv3d_ms": conv_ms, **k8_axes,
               "lines_route_ms": _time_ms(chain(
                   lambda y, a: ft._launch_line(y, w, a, "reflect", 0.0, c,
                                                0, lines_plan), (1, 2, 3))),
               "c13_paired_float64": k13})
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
    lib_axis = [_time_ms(lambda a=a: mat(g, a, True)) for a in (1, 2, 3)]
    lines_plan = ft.LinePlan("lines")
    lines_axis = [_time_ms(lambda a=a: ft._launch_line_transpose(
        g, w, a, "reflect", c, lines_plan)) for a in (1, 2, 3)]
    plans = []
    for a in (1, 2, 3):
        outer, n, inner = pf._lines(g, a)
        e = ft._k8t_edges(n, L, c, "reflect")
        plans.append(ft._line_plan(outer, n, inner, g.dtype, L,
                                             len(e.table)))
        if not torch.equal(_bits(k8t(g, a)), _bits(ft._launch_line_transpose(
                g, w, a, "reflect", c, lines_plan))):
            raise AssertionError(f"K8T at c11 shapes, axis {a}: the tile "
                                 "route differs from the lines route")
    axis_bound = _bound(2 * numel * 4, numel * 2 * L)[0]
    widths = []
    for a, p, ms, lib_ms, lines_ms in zip((1, 2, 3), plans, per_axis,
                                          lib_axis, lines_axis):
        t = p.tile
        outer, n, inner = pf._lines(g, a)
        e = ft._k8t_edges(n, L, c, "reflect")
        every = {}
        for W in pf.TILE_WIDTHS:
            q = ft._line_plan(outer, n, inner, g.dtype, L,
                                        len(e.table), width=W)
            every[W] = _time_ms(lambda q=q, a=a: ft._launch_line_transpose(
                g, w, a, "reflect", c, q))
        if p.gather:
            # the alternative: each thread stores its outputs directly
            direct = p._replace(gather=False, smem=p.smem - t.smem)
            every["direct stores"] = _time_ms(
                lambda a=a: ft._launch_line_transpose(g, w, a, "reflect", c,
                                                      direct))
        widths.append(every)
        print(f"correlate1d_transpose at c11 shapes, axis {a}: {p.route} "
              f"route W={t.width} {'packed' if t.packed else 'columns'}"
              f"{', outputs gathered' if p.gather else ''}, {p.smem} B "
              f"shared, {t.blocks} blocks, {ft.line_waves(p, 132)} waves; "
              f"{ms:.4f} ms (every width {json.dumps(every)}, lines route "
              f"{lines_ms:.4f}, tensordot with M^T {lib_ms:.4f}, bound "
              f"{axis_bound:.4f} by bytes) [{card}]")
    row("correlate1d_transpose", "filters.cu",
        "elasticdeform_tpu/ops/filters.py:125",
        _time_ms(chain(k8t, (3, 2, 1))),
        _time_ms(chain(lambda y, a: ft.correlate1d_transpose_plain(
            y, w, a, "reflect", c), (3, 2, 1))), bound,
        _time_ms(chain(lambda y, a: mat(y, a, True), (3, 2, 1))), err,
        at="c11", extra={"axis_ms": per_axis, "axis_tensordot_ms": lib_axis,
                         "lines_route_axis_ms": lines_axis,
                         "lines_route_ms": _time_ms(chain(
                             lambda y, a: ft._launch_line_transpose(
                                 y, w, a, "reflect", c, lines_plan),
                             (3, 2, 1))),
                         "widths": [p.tile.width for p in plans],
                         "width_ms": widths})
    del f, g, mats

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
    k9 = {}
    for label, y, w, c, mode, cval in (
            ("5^3", x, w5, cen, "constant", 0.5),
            ("3^3 batch 2", torch.as_tensor(rs.rand(2, *S).astype(
                np.float32), device=dev), rs.randn(1, 3, 3, 3), (0, 1, 1, 1),
             "reflect", 0.0)):
        plan = ft._nd_plan(tuple(y.shape), w.shape, y.dtype)
        nd = ft._nd_plan(tuple(y.shape), w.shape, y.dtype, route="nd")
        if not torch.equal(_bits(ft.correlate_nd(y, w, c, mode, cval)),
                           _bits(ft._launch_correlate_nd(y, w, c, mode, cval,
                                                         nd))):
            raise AssertionError(f"K9 {label} at c14 shapes: the tile route "
                                 "differs from the nd route")
        cols = {q: _time_ms(lambda q=q: ft._launch_correlate_nd(
            y, w, c, mode, cval, ft._nd_plan(tuple(y.shape), w.shape,
                                             y.dtype, column=q,
                                             route="tile")))
                for q in ft.TILE_COLUMNS}
        k9[label] = {
            "ms": _time_ms(lambda: ft.correlate_nd(y, w, c, mode, cval)),
            "nd_route_ms": _time_ms(lambda: ft._launch_correlate_nd(
                y, w, c, mode, cval, nd)),
            "column": plan.column, "column_ms": cols,
            "conv3d_ms": _time_ms(lambda: F.conv3d(
                y.reshape(-1, 1, *S), torch.as_tensor(
                    w.reshape(1, 1, *w.shape[-3:]), dtype=y.dtype,
                    device=dev), padding=tuple(k // 2 for k in
                                               w.shape[-3:]))),
            "bound": _bound(2 * y.numel() * 4,
                            y.numel() * 2 * int(np.count_nonzero(w)))}
        r = k9[label]
        print(f"correlate_nd {label} at c14 shapes: {plan.route} route, C="
              f"{plan.column}, box {plan.box}, {plan.smem} bytes shared, "
              f"{plan.blocks} blocks; {r['ms']:.4f} ms, per column "
              f"{', '.join(f'C={q} {v:.4f}' for q, v in cols.items())}; nd "
              f"route {r['nd_route_ms']:.4f} ms; conv3d (zero padding) "
              f"{r['conv3d_ms']:.4f} ms; bound {r['bound'][0]:.4f} ms by "
              f"{r['bound'][1]} [{card}]")
        del y
    row("correlate_nd", "filters.cu", "elasticdeform_tpu/ops/filters.py:317",
        k9["5^3"]["ms"],
        _time_ms(lambda: ft.correlate_nd_plain(x, w5, cen, "constant", 0.5)),
        bound9, k9["5^3"]["conv3d_ms"], err, at="c14",
        extra={"nd_route_ms": k9["5^3"]["nd_route_ms"],
               "column": k9["5^3"]["column"],
               "column_ms": k9["5^3"]["column_ms"],
               "batch_3^3": k9["3^3 batch 2"]})
    terms = ft.correlate_nd_transpose_plain(x.abs(), np.abs(w5), cen,
                                            "constant")
    err = _assert_close(ft.correlate_nd_transpose(x, w5, cen, "constant"),
                        ft.correlate_nd_transpose_plain(x, w5, cen,
                                                        "constant"),
                        *_terms_tol(torch.float32, terms), "K9T at c14 shapes")
    del terms
    plan = ft._nd_plan(x.shape, w5.shape, x.dtype)
    nd_plan = ft._nd_plan(x.shape, w5.shape, x.dtype, route="nd")
    nd_ms = _time_ms(lambda: ft._launch_nd_transpose(x, w5, cen, "constant",
                                                     nd_plan))
    cols = {}
    for c in ft.TILE_COLUMNS:
        p = ft._nd_plan(x.shape, w5.shape, x.dtype, column=c,
                                  route="tile")
        cols[c] = _time_ms(lambda p=p: ft._launch_nd_transpose(
            x, w5, cen, "constant", p))
    taps = n9 * 125
    print(f"correlate_nd_transpose at c14 shapes: {plan.route} route, C="
          f"{plan.column}, box {plan.box}, {plan.smem} bytes shared, "
          f"{plan.blocks} blocks; per column ms "
          f"{', '.join(f'C={c} {v:.4f}' for c, v in cols.items())}; nd route "
          f"{nd_ms:.4f} ms; {taps / cols[plan.column] / 1e6:.1f} G taps/s on "
          f"the tile route [{card}]")
    row("correlate_nd_transpose", "filters.cu",
        "elasticdeform_tpu/ops/filters.py:317",
        _time_ms(lambda: ft.correlate_nd_transpose(x, w5, cen, "constant")),
        _time_ms(lambda: ft.correlate_nd_transpose_plain(x, w5, cen,
                                                         "constant")),
        bound9,
        _time_ms(lambda: F.conv_transpose3d(x[None, None], w5t, padding=2)),
        err, at="c14", extra={"nd_route_ms": nd_ms, "column": plan.column,
                              "column_ms": cols})


def _times_distance(row, card, cfg19):
    """Phase 4 of K14-K17 at c19's shapes and inputs: each kernel's ms,
    device ms, its plain twin's ms on the card, its byte (and operation)
    bound, and the library call where one computes the same function: K14
    with the feature planes beside two ``torch.cummax`` scans (the JAX
    package's formulation); K15 as c19's two passes (the pass entry, band
    and predicated dense kernel from one host call) and each kernel alone
    per axis (the dense one on a set and on a clear flag); K16 and K17 per
    sweep on c19's start state (the driver's sweeper, into its second
    buffer set, and the wrapper, which allocates its outputs), per group
    of eight sweeps from one host call (the driver's) and per call, each on
    the device, K16's sweep beside a chessboard sweep without indices,
    ``-max_pool3d(-d)``."""
    import torch
    import torch.nn.functional as F
    from elasticdeform_tpu_torch.ops import distance as ds
    from elasticdeform_tpu_torch.ops import morphology as mo
    dev = torch.device("cuda")
    m, img, mk = (torch.as_tensor(a, device=dev) for a in cfg19.inputs)
    N = m.numel()
    samp = (1.5, 1.0, 1.0)
    plane_bytes = 3 * 4 * N

    # K14: the mask in, f and the three feature planes out
    idx = torch.arange(m.shape[0], dtype=torch.int32, device=dev).view(
        -1, 1, 1)
    bg = ~m
    left_in = torch.where(bg, idx, -1)
    right_in = torch.where(bg.flip(0), idx, -1)
    k14 = lambda: ds.nearest_background(m, samp[0], True)  # noqa: E731
    row("nearest_background", "distance.cu",
        "elasticdeform_tpu/ops/distance.py:98", _time_ms(k14),
        _time_ms(lambda: ds.nearest_background_plain(m, samp[0], True)),
        _bound(N * (1 + 8) + plane_bytes, 0), _time_ms(
            lambda: (torch.cummax(left_in, 0), torch.cummax(right_in, 0))),
        0.0, at=f"c19 {tuple(m.shape)} bool, sampling 1.5",
        extra={"device_ms": _device_ms(k14)})

    # K15: c19's two passes, f and the planes in and out each pass; each
    # pass the entry's one host call (band, then the dense kernel, which
    # reads the band's flag on the device)
    f0, ix0 = k14()
    kept = []

    def passes():
        f, ix = f0, ix0
        del kept[:]
        for ax in (1, 2):
            f, ix = ds.minplus_pass(f, ix, ax, samp[ax], kept)
        return f, ix

    def plain():
        f, ix = f0, ix0
        for ax in (1, 2):
            W = ds.band_width(f.shape[ax])
            out, planes = ds.banded_plain(f, ix, ax, samp[ax], W)
            if not bool((out <= (samp[ax] * W) ** 2).all()):
                out, planes = ds.matrix_plain(f, ix, ax, samp[ax])
            f, ix = out, planes
        return f, ix

    for a, b, part in zip(passes(), plain(), ("f", "planes")):
        _same(a, b, f"K15 at c19, {part}")
    tiers = ds.kept_rungs(kept)
    clear = torch.zeros(1, dtype=torch.int32, device=dev)
    setf = torch.ones(1, dtype=torch.int32, device=dev)
    alone, plans = {}, {}
    f, ix = f0, ix0
    visits = 0
    for ax in (1, 2):
        n = f.shape[ax]
        W = ds.band_width(n)
        inner = math.prod(f.shape[ax + 1:])
        plans[f"axis {ax}"] = ds._minplus_plan(f.numel() // (n * inner), n,
                                               inner, ix.shape[0])._asdict()
        # each kernel alone (the wrapper's outputs and flag allocated)
        for label, fn in (
                (f"axis {ax} band W={W}", lambda f=f, ix=ix, ax=ax, W=W:
                 ds._launch_rung(f, ix, ax, samp[ax], W)),
                (f"axis {ax} dense", lambda f=f, ix=ix, ax=ax:
                 ds._launch_rung(f, ix, ax, samp[ax], 0, setf)),
                (f"axis {ax} dense on a clear flag", lambda f=f, ix=ix, ax=ax:
                 ds._launch_rung(f, ix, ax, samp[ax], 0, clear))):
            alone[label] = {"ms": _time_ms(fn), "device_ms": _device_ms(fn)}
        out, planes = ds.minplus_pass(f, ix, ax, samp[ax])
        # the candidates this run's data needs: each voxel's own value and
        # the offsets k >= 1 on both sides with s^2 k^2 <= its result (the
        # band's up to W, the dense tier's up to n - 1, where it ran)
        reach = torch.floor(torch.sqrt(out) / samp[ax])
        for cap, ran in ((W, True), (n - 1, tiers[ax] == 0)):
            if ran:
                visits += int((1 + 2 * reach.clamp(max=cap)).sum())
        f, ix = out, planes
    row("minplus_pass", "distance.cu",
        "elasticdeform_tpu/ops/distance.py:193", _time_ms(passes),
        _time_ms(plain, reps=3, warmup=1),
        _bound(2 * 2 * (8 * N + plane_bytes), 2 * visits, FP64_FLOPS), None,
        0.0, at="c19 axes 1 and 2, sampling 1.0",
        extra={"rung_kept": {f"axis {a}": w for a, w in tiers.items()},
               "kernels_alone": alone, "plans": plans,
               "device_ms": _device_ms(passes)})

    # K16: one sweep reads d and ix and writes them; a call reads the mask
    # and writes d and ix
    cross = mo.generate_binary_structure(3, 1)
    taps = mo.relax_taps(cross, m.shape)
    d0 = torch.where(m, mo.RELAX_BIG, 0).to(torch.int32)
    ix0 = torch.arange(N, dtype=torch.int32, device=dev).reshape(m.shape)
    neg = -d0.to(torch.float32)[None]
    # the driver's sweeper: one sweep into its second buffer set, and a
    # group of eight from one host call (on a copy it relaxes in place)
    lean = ds.chamfer_sweeper(d0, ix0, taps)
    sweep = lambda: lean((d0, ix0))  # noqa: E731
    g = (d0.clone(), ix0.clone())
    lean_g = ds.chamfer_sweeper(*g, taps)
    group = lambda: lean_g(g, None, 8)  # noqa: E731
    call = lambda: ds.cdt_core(m, cross, True)  # noqa: E731
    before = ds.chamfer_sweep.launches
    call()
    sweeps = ds.chamfer_sweep.launches - before
    call_ms = _time_ms(call, reps=5, warmup=1)
    row("chamfer_sweep", "distance.cu",
        "elasticdeform_tpu/ops/distance.py:343", _time_ms(sweep),
        _time_ms(lambda: ds.chamfer_sweep_plain(d0, ix0, taps.offs)),
        _bound(4 * 4 * N, 0), _time_ms(
            lambda: F.max_pool3d(neg, 3, 1, 1)), 0.0,
        at="c19 one taxicab sweep with indices (library: a chessboard "
           "sweep without indices)",
        extra={"device_ms": _device_ms(sweep), "call_ms": call_ms,
               "call_device_ms": _device_ms(call, calls=3),
               "group_of_8_ms": _time_ms(group),
               "group_of_8_device_ms": _device_ms(group),
               "wrapper_ms": _time_ms(lambda: ds.chamfer_sweep(d0, ix0,
                                                               taps)),
               "call_bound_ms": _bound(N * (1 + 8), 0)[0],
               "sweeps_per_call": sweeps})

    # K17: one sweep reads the image and the triples and writes the
    # triples; a call reads the image and the markers and writes labels
    taps = mo.relax_taps(cross, img.shape)
    seeded = mk != 0
    state = (torch.where(seeded, img.to(torch.int32), mo.RELAX_BIG).to(
        torch.int32), torch.where(seeded, 0, mo.RELAX_BIG).to(torch.int32),
        mk)
    Nw = img.numel()
    lean = ds.watershed_sweeper(img, taps)
    sweep = lambda: lean(state)  # noqa: E731
    g = tuple(t.clone() for t in state)
    lean_g = ds.watershed_sweeper(img, taps)
    group = lambda: lean_g(g, None, 8)  # noqa: E731
    call = lambda: mo.watershed_ift(img, mk)  # noqa: E731
    before = ds.watershed_sweep.launches
    call()
    sweeps = ds.watershed_sweep.launches - before
    call_ms = _time_ms(call, reps=5, warmup=1)
    row("watershed_sweep", "distance.cu",
        "elasticdeform_tpu/ops/morphology.py:571", _time_ms(sweep),
        _time_ms(lambda: ds.watershed_sweep_plain(img, *state, taps.offs)),
        _bound(Nw * (1 + 2 * 3 * 4), 0), None, 0.0,
        at=f"c19 one sweep of the watershed, {tuple(img.shape)} uint8",
        extra={"device_ms": _device_ms(sweep), "call_ms": call_ms,
               "call_device_ms": _device_ms(call, calls=3),
               "group_of_8_ms": _time_ms(group),
               "group_of_8_device_ms": _device_ms(group),
               "wrapper_ms": _time_ms(lambda: ds.watershed_sweep(
                   img, *state, taps)),
               "call_bound_ms": _bound(Nw * (1 + 4 + 4), 0)[0],
               "sweeps_per_call": sweeps})


def _times_measure(row, card, cfg20):
    """Phase 4 of K18-K20 at c20's shapes and inputs: each kernel's ms,
    device ms, its plain twin's ms on the card, its byte bound and the
    library call where one computes the same function. K18 on both of
    c20's masks (roots and flags; the numbering, a ``torch.cumsum`` and
    the gather, beside it); K19 on its device route as ``sum_labels`` over
    the second labels (about a third of a million segments; the other
    statistics' launches beside it) beside ``index_add_`` of the
    float64 values at int64 segment ids made beforehand, and on its shared
    route as ``histogram``, ``minimum_position``'s minimum, ``center_of_mass``
    and ``find_objects`` over the first (a few hundred) beside
    ``bincount`` of the buckets made beforehand; K20 as ``minimum_position``'s
    second pass beside ``scatter_reduce_`` (``amin``) of the hits' indices
    made beforehand."""
    import torch
    import elasticdeform_tpu_torch as et
    from elasticdeform_tpu_torch.ops import measure as ms
    dev = torch.device("cuda")
    M20, X20, T20 = cfg20.inputs
    m = torch.as_tensor(M20, device=dev)
    x = torch.as_tensor(X20, device=dev)
    fg2 = x > T20
    N = m.numel()
    shape = f"c20 {tuple(m.shape)}"
    offs1 = ms.structure_offsets(np.ones((3, 3, 3)), 3)
    offs2 = ms.structure_offsets(None, 3)

    # K18: the function it replaces reads the mask and writes the roots (1
    # + 4 bytes a voxel; the root flags are its own design's); mapping the
    # roots to labels reads the roots and writes the labels (4 + 4)
    k18 = lambda: ms.label_roots(fg2, offs2, flags=True)  # noqa: E731
    k18a = lambda: ms.label_roots(m, offs1, flags=True)  # noqa: E731
    roots, flags = k18()
    number = lambda: ms.label_numbers(roots, flags)  # noqa: E731
    _same(roots, ms.label_roots_plain(fg2, offs2), "K18 at c20, roots")
    row("label_roots", "measure.cu", "elasticdeform_tpu/measure.py:93",
        _time_ms(k18), _time_ms(lambda: ms.label_roots_plain(fg2, offs2,
                                                             flags=True)),
        _bound(N * (1 + 4), 0), None, 0.0,
        at=f"{shape} bool above the median, cross",
        extra={"device_ms": _device_ms(k18),
               "full_structure_mask_ms": _time_ms(k18a),
               "full_structure_mask_device_ms": _device_ms(k18a),
               "full_structure_mask_plain_ms": _time_ms(
                   lambda: ms.label_roots_plain(m, offs1, flags=True)),
               "numbering_ms": _time_ms(number),
               "numbering_device_ms": _device_ms(number),
               "numbering_bound_ms": _bound(N * (4 + 4), 0)[0]})

    l1, n1 = et.label(m, structure=np.ones((3, 3, 3)), device=dev)
    l2, n2 = et.label(fg2, device=dev)
    lut1, K1, _, _ = ms.labels_index(l1, np.arange(1, n1 + 1), dev)
    lut2, K2, _, _ = ms.labels_index(l2, np.arange(1, n2 + 1), dev)
    seg1 = ms.segment_ids_plain(l1, lut1, tuple(l1.shape), dev)
    seg2 = ms.segment_ids_plain(l2, lut2, tuple(l2.shape), dev)
    f = x.reshape(-1).to(torch.float64)

    # K19's device route: sum_labels over the second labels (the input and
    # the labels in, K sums out), beside index_add_
    def k19(lab, lut, K, stats, hist=None):
        return lambda: ms.segment_reduce(x, lab, lut, K, stats, hist)

    segk2 = torch.where(seg2 < 0, K2, seg2)
    got = k19(l2, lut2, K2, ("sum",))()["sum"]
    want = ms.segment_reduce_plain(x, l2, lut2, K2, ("sum",))["sum"]
    terms = ms.segment_reduce_plain(x.abs(), l2, lut2, K2, ("sum",))["sum"]
    if not bool(((got - want).abs() <= 1e-12 * terms).all()):
        raise AssertionError("K19 at c20: sums off by more than 1e-12 of "
                             "their terms")
    err = float((got - want).abs().max())
    lib = torch.zeros(K2 + 1, dtype=torch.float64, device=dev)
    other = {}
    for name, lab, lut, K, stats, hist in (
            ("device_mean", l2, lut2, K2, ("sum", "count"), None),
            ("device_variance", l2, lut2, K2, ("sum", "sum2", "count"), None),
            ("device_minimum", l2, lut2, K2, ("count", "min"), None),
            ("shared_histogram", l1, lut1, K1, ("count", "hist"),
             (64, 0, 1)),
            ("shared_minimum", l1, lut1, K1, ("count", "min"), None),
            ("shared_center_of_mass", l1, lut1, K1, ("sum", "csum"), None),
            ("shared_find_objects", l1, lut1, K1, ("count", "bounds"),
             None)):
        fn = k19(lab, lut, K, stats, hist)
        route = ms.segment_plan(K, stats, 3, hist[0] if hist else 0)
        if route != name.split("_")[0]:
            raise AssertionError(f"K19 at c20: {name} took the {route} route")
        other[f"{name}_ms"] = _time_ms(fn)
        other[f"{name}_device_ms"] = _device_ms(fn)
    q, ok = ms.histogram_buckets(f, 0, 1, 64)
    hkey = torch.where(ok & (seg1 >= 0), seg1 * 64 + q, K1 * 64)
    other["shared_histogram_library_ms"] = _time_ms(
        lambda: torch.bincount(hkey, minlength=K1 * 64 + 1))
    k19d = k19(l2, lut2, K2, ("sum",))
    row("segment_reduce", "measure.cu", "elasticdeform_tpu/measure.py:201",
        _time_ms(k19d), _time_ms(
            lambda: ms.segment_reduce_plain(x, l2, lut2, K2, ("sum",))),
        _bound(N * (4 + 4) + K2 * 8, 0),
        _time_ms(lambda: lib.index_add_(0, segk2, f)), err,
        at=f"{shape} float32, {K2} segments (sum_labels)",
        extra={"device_ms": _device_ms(k19d), "segments": [K1, K2],
               **other})

    # K20: minimum_position's second pass over the first labels (the input,
    # the labels and K keys in, K positions out), beside scatter_reduce_
    keys = ms.segment_reduce(x, l1, lut1, K1, ("min",))["min"]
    k20 = lambda: ms.segment_position(x, l1, lut1, K1, keys)  # noqa: E731
    _same(k20(), ms.segment_position_plain(x, l1, lut1, K1, keys),
          "K20 at c20")
    ext = ms.key_values(keys, x.dtype)
    hit = (x.reshape(-1) == ext[seg1.clamp(min=0)]) & (seg1 >= 0)
    hseg = torch.where(hit, seg1, K1)
    iota = torch.arange(N, device=dev)
    pos = torch.full((K1 + 1,), N, dtype=torch.int64, device=dev)
    row("segment_position", "measure.cu", "elasticdeform_tpu/measure.py:298",
        _time_ms(k20), _time_ms(
            lambda: ms.segment_position_plain(x, l1, lut1, K1, keys)),
        _bound(N * (4 + 4) + K1 * 16, 0),
        _time_ms(lambda: pos.scatter_reduce_(0, hseg, iota, "amin")), 0.0,
        at=f"{shape} float32, {K1} segments (minimum_position)",
        extra={"device_ms": _device_ms(k20)})


def _times_morphology(row, card, k13=None):
    """Phase 4 for the morphology tier: K10 as the three passes of c16's
    5^3 dilation (int16, 512x512x300) beside ``max_pool3d`` (stride 1) on the
    reflect-padded float32 volume; K11 on each route as the ball erosion of
    c16's top-hat, its non-flat 3^3 float64 dilation and a flat 5^3 box
    beside the same ``max_pool3d``; K12 at c15's shapes on its
    three filters (network 27 and 33 taps, select 125); K13 as one 3^3
    erosion sweep of c17's mask on each route beside ``max_pool3d`` with a
    3^3 window, and c17's hole filling per call and per sweep on the packed
    state, on bool bytes and on the nd route, with its launches per call
    (``k13``: phase 3's K13 counters, kept in its row). Every kernel is
    held to its twin bit for bit at these shapes."""
    import torch
    import torch.nn.functional as F
    from elasticdeform_tpu_torch.ops import filters as ft
    from elasticdeform_tpu_torch.ops import morphology as mo
    dev = torch.device("cuda")
    rs = np.random.RandomState(13)

    v = torch.as_tensor(rs.randint(-1024, 3072, (512, 512, 300)).astype(
        np.int16), device=dev)
    numel = v.numel()

    # K10: c16's 5^3 dilation, its three passes in one launch on the box
    # route, and on the lines route (a launch a pass,
    # min_max_1d_kernel); the opening, an erosion and a dilation, both ways
    passes = [(a, 5, 2, "reflect") for a in (0, 1, 2)]
    lines = mo.BoxPlan("lines")
    box_plan = mo._box_plan(tuple(v.shape), (5, 5, 5), v.dtype)

    def dilate():
        return mo.min_max_box(v, passes, 0, False)

    def opening(plan):
        def run():
            y = mo._launch_box(v, passes, 0, True, plan)
            return mo._launch_box(y, passes, 0, False, plan)
        return run
    got = dilate()
    _same(got, mo.min_max_box_plain(v, passes, 0, False),
          "K10's box at c16 shapes vs the twin")
    _same(got, mo._launch_box(v, passes, 0, False, lines),
          "K10's box at c16 shapes vs the lines route")
    _same(opening(box_plan)(), opening(lines)(),
          "K10's opening at c16 shapes, box vs lines route")
    vp = v.float()
    for a in (0, 1, 2):
        vp = ft.pad_axis(vp, a, 2, 2, "reflect", 0.0)
    vp = vp[None, None].contiguous()
    per_axis = [_time_ms(lambda a=a: mo.min_max_filter1d(
        v, 5, a, "reflect", 0, 2, False)) for a in (0, 1, 2)]
    lines_axis = [_time_ms(lambda a=a: mo._launch_lines(
        v, 5, a, "reflect", 0, 2, False)) for a in (0, 1, 2)]
    one_pass = _k10_one_pass_times(v, card)
    k10 = {"lines_route_ms": _time_ms(
        lambda: mo._launch_box(v, passes, 0, False, lines)),
           "opening_ms": _time_ms(opening(box_plan)),
           "opening_lines_ms": _time_ms(opening(lines)),
           "axis_ms": per_axis, "lines_axis_ms": lines_axis,
           "device_ms": _device_ms(dilate),
           "lines_device_ms": _device_ms(
               lambda: mo._launch_box(v, passes, 0, False, lines)),
           "plan": box_plan._asdict(), "one_pass": one_pass,
           "per_pass_bound_ms": _bound(3 * 2 * numel * 2, 3 * numel * 4)[0]}
    print(f"K10 at (512, 512, 300) int16, size 5: one axis on the box route "
          f"{per_axis} ms, on the lines route {lines_axis} ms; the opening "
          f"(two boxes) {k10['opening_ms']:.4f} ms, on the lines route (six "
          f"passes) {k10['opening_lines_ms']:.4f} ms; the dilation on the "
          f"device {k10['device_ms']:.4f} ms, on the lines route "
          f"{k10['lines_device_ms']:.4f} ms; plan {box_plan} [{card}]")
    row("min_max_filter1d", "morphology.cu",
        "elasticdeform_tpu/ops/morphology.py:119", _time_ms(dilate),
        _time_ms(lambda: mo.min_max_box_plain(v, passes, 0, False)),
        _bound(2 * numel * 2, 3 * numel * 4),
        _time_ms(lambda: F.max_pool3d(vp, 5, stride=1)), 0.0, at="c16",
        extra=k10)

    # K11 on each route: c16's top-hat erosion (a ball of radius 2, 33
    # taps), its non-flat 3^3 dilation of the first 256 slices (float64
    # work) and a flat 5^3 box, the function max_pool3d computes (on the
    # padded float32 volume, values compared)
    g3 = np.indices((3, 3, 3)) - 1
    s3 = -30.0 * (g3 ** 2).sum(0)
    ones3 = np.ones((3, 3, 3), dtype=bool)
    k11 = {}
    for label, y, fp, st, cen, minimum in (
            ("ball2 erosion", v, _ball(2), None, [2, 2, 2], True),
            ("non-flat 3^3 dilation", v[:256], ones3, s3, [1, 1, 1], False),
            ("box 5^3 dilation", v, np.ones((5, 5, 5), bool), None,
             [2, 2, 2], False)):
        nonflat = st is not None
        work = mo._work_dtype(y.dtype, nonflat)
        args = (y, fp, st, cen, "reflect", 0.0 if nonflat else 0, minimum)
        plan = mo._min_max_plan(tuple(y.shape), fp.shape, work,
                                int(fp.sum()), nonflat)
        nd = mo._min_max_plan(tuple(y.shape), fp.shape, work, int(fp.sum()),
                              nonflat, route="nd")
        got = mo.min_max_filter(*args)
        _same(got, mo._launch_min_max(*args, nd),
              f"K11 {label} at c16 shapes, tile route vs nd route")
        r = {"route": plan.route, "taps": int(fp.sum()), "box": plan.box,
             "smem": plan.smem, "blocks": plan.blocks,
             "ms": _time_ms(lambda a=args: mo.min_max_filter(*a)),
             "nd_route_ms": _time_ms(
                 lambda a=args: mo._launch_min_max(*a, nd), reps=3),
             "bound": _bound(2 * y.numel() * 2,
                             y.numel() * int(fp.sum()))}
        _same(got, mo.min_max_filter_plain(*args),
              f"K11 {label} at c16 shapes vs plain")
        if fp.shape == (5, 5, 5) and fp.all():
            lib = F.max_pool3d(vp, 5, stride=1)[0, 0]
            r["max_pool3d_differs"] = int((lib.to(torch.int16) != got).sum())
            del lib
            r["max_pool3d_ms"] = _time_ms(lambda: F.max_pool3d(vp, 5,
                                                               stride=1))
        k11[label] = r
        print(f"min_max_filter {label} ({r['taps']} taps) at c16 shapes "
              f"{tuple(y.shape)} int16, {work} work: {r['route']} route "
              f"{r['ms']:.4f} ms (box {r['box']}, {r['smem']} B shared, "
              f"{r['blocks']} blocks), nd route {r['nd_route_ms']:.4f} ms, "
              f"bound {r['bound'][0]:.4f} ms by {r['bound'][1]}"
              + (f", max_pool3d {r['max_pool3d_ms']:.4f} ms (values "
                 f"differing from K11's: {r['max_pool3d_differs']})"
                 if "max_pool3d_ms" in r else "") + f" [{card}]")
        del got
    del vp
    ball, cen = _ball(2), [2, 2, 2]
    r = k11["ball2 erosion"]
    row("min_max_filter", "morphology.cu",
        "elasticdeform_tpu/ops/morphology.py:196", r["ms"],
        _time_ms(lambda: mo.min_max_filter_plain(v, ball, None, cen,
                                                 "reflect", 0, True)),
        r["bound"], k11["box 5^3 dilation"]["max_pool3d_ms"], 0.0, at="c16",
        extra={"library": "max_pool3d 5^3 stride 1 on the padded float32 "
               "volume, beside K11 on a flat 5^3 box (box_5^3)",
               "nd_route_ms": r["nd_route_ms"],
               "nonflat_3^3": k11["non-flat 3^3 dilation"],
               "box_5^3": k11["box 5^3 dilation"]})
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
        want = mo.rank_filter_plain(*args)
        _same(mo.rank_filter(*args), want, f"K12 {label} at c15 shapes")
        plan = mo._rank_plan(S, fp.shape, x.dtype, k)
        r = {"route": plan.route, "taps": k,
             "ms": _time_ms(lambda a=args: mo.rank_filter(*a)),
             "plain_ms": _time_ms(lambda a=args: mo.rank_filter_plain(*a),
                                  reps=3, warmup=1),
             "bound": _bound(2 * numel * 4,
                             numel * _select_comparisons(k, rank))}
        if plan.route == "tile":
            nd_plan = mo._rank_plan(S, fp.shape, x.dtype, k, route="nd")
            _same(mo._launch_rank(*args, nd_plan), want,
                  f"K12 {label} at c15 shapes, nd route")
            r["nd_route_ms"] = _time_ms(
                lambda a=args: mo._launch_rank(*a, nd_plan), reps=3)
            r.update(box=plan.box, smem=plan.smem, blocks=plan.blocks)
        if plan.route == "network_tile":
            # the old kernel (the network route)
            net = mo._rank_plan(S, fp.shape, x.dtype, k, route="network")
            _same(mo._launch_rank(*args, net), want,
                  f"K12 {label} at c15 shapes, network route")
            r["network_route_ms"] = _time_ms(
                lambda a=args: mo._launch_rank(*a, net), reps=5)
            wires = mo._rank_network(k, rank)[0]
            r.update(column=plan.column, box=plan.box, smem=plan.smem,
                     blocks=plan.blocks,
                     comparators=len(mo._batcher_pairs(wires)),
                     pruned=len(mo._rank_network(k, rank)[1]))
        if fp.all() or k == 33:
            # the library yardstick: kthvalue over the windows of the padded
            # volume (the unfold windows, the ball's 33 taps gathered from
            # them; built once, not timed); values compared on this finite
            # volume (kthvalue has its own NaN rule)
            xp = x
            for a in range(3):
                xp = ft.pad_axis(xp, a, c[a], c[a], "reflect", 0.0)
            win = xp.unfold(0, fp.shape[0], 1).unfold(
                1, fp.shape[1], 1).unfold(2, fp.shape[2], 1).reshape(
                *S, fp.size)
            del xp
            if not fp.all():
                win = win[..., torch.as_tensor(np.flatnonzero(fp),
                                               device=dev)]
            win = win.contiguous()
            if not torch.equal(torch.kthvalue(win, rank + 1, dim=-1).values,
                               want):
                raise AssertionError(f"K12 {label}: kthvalue's values differ "
                                     "from the twin")
            r["kthvalue_ms"] = _time_ms(
                lambda: torch.kthvalue(win, rank + 1, dim=-1), reps=5)
            del win
        routes[label] = r
        print(f"rank_filter {label} ({k} taps, rank {rank}) at c15 shapes: "
              f"{r['route']} route {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by "
              f"{r['bound'][1]}"
              + (f", kthvalue over unfold windows {r['kthvalue_ms']:.4f} ms"
                 if "kthvalue_ms" in r else "")
              + (f", nd route {r['nd_route_ms']:.4f} ms, box {r['box']}, "
                 f"{r['smem']} B shared, {r['blocks']} blocks"
                 if "nd_route_ms" in r else "")
              + (f", network route {r['network_route_ms']:.4f} ms, C="
                 f"{r['column']}, box {r['box']}, {r['smem']} B shared, "
                 f"{r['blocks']} blocks, {r['comparators']} comparators "
                 f"run ({r['pruned']} on the old route)"
                 if "network_route_ms" in r else "")
              + f") [{card}]")
        del want
    r = routes["median3"]
    row("rank_filter", "morphology.cu",
        "elasticdeform_tpu/ops/morphology.py:302", r["ms"], r["plain_ms"],
        r["bound"], r["kthvalue_ms"], 0.0, at="c15",
        extra={label: {**{k: v for k, v in q.items() if k != "bound"},
                       "bound_ms": q["bound"][0]}
               for label, q in routes.items()})
    del x

    m, _ = _segmentation(rs, S)
    m = torch.as_tensor(m, device=dev)
    numel = m.numel()
    cen = [1, 1, 1]
    # the single sweep: bool bytes in and out, the tile route with k = 1
    # (packed in shared memory), beside the nd route and max_pool3d
    for route in (None, "nd"):
        _same(mo.binary_step(m, ones3, cen, False, False, route=route),
              mo.binary_step_plain(m, ones3, cen, False, False),
              f"K13 at c17 shapes, route {route}")
    sten = mo._Stencil(S, ones3, cen)
    plan1 = sten.plan(1, True)
    one_ms = _time_ms(lambda: mo.binary_step(m, ones3, cen, False, False,
                                             stencil=sten))
    one_nd = _time_ms(lambda: mo.binary_step(m, ones3, cen, False, False,
                                             stencil=sten, route="nd"))
    print(f"binary_step one 3^3 erosion sweep at c17 shapes: tile route "
          f"{one_ms:.4f} ms (tile {plan1.tile}, box {plan1.box}, "
          f"{plan1.smem} B shared, {plan1.blocks} blocks), nd route "
          f"{one_nd:.4f} ms [{card}]")
    # the fixpoint of c17's hole filling: per call (its input, mask and
    # output the call's bytes, counted once) and per sweep, on the packed
    # state (binary_erosion_dilation's), on bool bytes packed at every launch
    # (the design alternative) and on the nd route (one sweep a launch)
    zeros, fill_mask = torch.zeros_like(m), ~m
    cross, cross_c = mo._binary_stencil(mo.generate_binary_structure(3, 1),
                                        0, True)
    cross_sten = mo._Stencil(S, cross, cross_c)
    bytes_plan = cross_sten.plan(8, True)

    def fill_bytes():
        """The design alternative: the fixpoint's schedule on bool bytes,
        packed in shared memory by ballots at every launch."""
        x = zeros
        changed = torch.zeros(1, dtype=torch.int32, device=dev)
        while True:
            changed.zero_()
            left = mo.SWEEPS_PER_CHECK
            while left:
                k = min(left, bytes_plan.k)
                x = mo.binary_sweeps(x, cross, cross_c, True, True,
                                     fill_mask, k,
                                     changed if k == left else None,
                                     cross_sten, bytes_plan)
                left -= k
            if not int(changed.item()):
                return x

    def fill(route=None):
        return mo.binary_erosion_dilation(zeros, None, -1, fill_mask, 1, 0,
                                          True, route=route)
    ref = fill(route="nd")
    fills = {}
    for label, run in (("packed", fill), ("bytes", fill_bytes),
                       ("nd", lambda: fill("nd"))):
        _same(run(), ref, f"K13 fill_holes {label}")
        _reset_counts()
        ms = _time_ms(run, reps=5, warmup=1)
        c = _k13_counts()
        calls = 5 + 1
        sweeps = c["sweeps"] // calls
        fills[label] = {"ms": ms, "sweeps": sweeps,
                        "ms_per_sweep": ms / sweeps,
                        "launches": {k: v // calls for k, v in c.items()
                                     if k != "sweeps"}}
        print(f"binary_step fill_holes at c17 shapes, {label}: {ms:.4f} ms "
              f"per call, {sweeps} sweeps, {ms / sweeps:.5f} ms per sweep, "
              f"launches per call {json.dumps(fills[label]['launches'])} "
              f"[{card}]")
    plan8 = sten.plan(8, False)
    call_bound = _bound(3 * numel, 0)
    print(f"binary_step fill_holes bound: the call's bytes once (input, "
          f"mask, output: {3 * numel} B) {call_bound[0]:.4f} ms; the "
          f"packed plan for 8 sweeps: tile {plan8.tile}, k {plan8.k}, box "
          f"{plan8.box}, {plan8.smem} B shared, {plan8.blocks} blocks "
          f"[{card}]")
    mf = m.float()[None, None]
    row("binary_step", "morphology.cu",
        "elasticdeform_tpu/ops/morphology.py:452", one_ms,
        _time_ms(lambda: mo.binary_step_plain(m, ones3, cen, False, False)),
        _bound(2 * numel, numel * 27),
        _time_ms(lambda: F.max_pool3d(mf, 3, stride=1, padding=1)), 0.0,
        at="c17", extra={"nd_route_ms": one_nd, "fill_holes": fills,
                         "fill_holes_call_bound_ms": call_bound[0],
                         **(k13 or {})})


def _print_k1_lines(k1_lines, probe_times, card):
    """One line each for K1 at c5 (orders 1 and 3) and K1c at c7 and c8:
    ms, taps gathered per second beside P2's L2 element rate (probe pl_dg:
    random 128-float rows from a table in L2, counted in elements), the
    time with a bfloat16 table and ``grid_sample``'s where it computes the
    same function (order 1)."""
    ms, _, _, _, rows = probe_times["pl_dg"]
    l2 = rows * 128 / ms / 1e6
    for label, k_ms, taps, bf16_ms, lib_ms in k1_lines:
        rate = taps / k_ms / 1e6
        lib = "none (no B-spline of that order)" if lib_ms is None else \
            f"{lib_ms:.4f} ms ({k_ms / lib_ms:.2f}x)"
        print(f"{label}: {k_ms:.4f} ms, {taps} taps = {rate:.1f} G taps/s, "
              f"{100 * rate / l2:.1f}% of P2's L2 element rate "
              f"({l2:.1f} G/s); bfloat16 table {bf16_ms:.4f} ms; "
              f"grid_sample {lib} [{card}]")


def times_c6(card, cfg):
    """K1 and K5 at c6's shapes (8 x 64^3 float32, order 3, mirror, the
    dense displacement of per-sample 3x3x3 grids), and the c6 config
    ``cfg`` whole, in ms over 30 calls each. It calls only the package's
    public wrappers, so it also times an older tree's package, one
    process per tree, in one call to the card."""
    import torch
    from elasticdeform_tpu_torch.ops import resample as rsm
    from elasticdeform_tpu_torch.ops import resample_bwd as rb
    from elasticdeform_tpu_torch.ops.displacement import dense_displacement
    dev = torch.device("cuda")
    rs = np.random.RandomState(6)
    B, S = 8, (64, 64, 64)
    x = torch.as_tensor(rs.rand(B, *S, 1).astype(np.float32), device=dev)
    gy = torch.as_tensor(rs.randn(B, *S, 1).astype(np.float32), device=dev)
    grid = torch.as_tensor((rs.randn(B, 3, 3, 3, 3) * 6).astype(np.float32),
                           device=dev)
    args = (dense_displacement(grid, S, S, (0, 0, 0)), None, (0, 0, 0), 3,
            3)
    out = {"K1": _time_ms(lambda: rsm.resample(x, *args, 0.0), reps=30),
           "K5": _time_ms(lambda: rb.resample_coord_grad(x, gy, *args),
                          reps=30),
           "c6": _time_ms(lambda: cfg.run("cuda"), reps=30)}
    print(f"at c6 shapes (8 x 64^3, order 3, mirror): K1 resample_fwd "
          f"{out['K1']:.4f} ms, K5 resample_coord_grad {out['K5']:.4f} ms; "
          f"c6 {out['c6']:.3f} ms per call [{card}]")
    return out


def _k6_digest(rs):
    """sha256 of K6's output bits (the public wrapper, as the plan routes
    it) over the tile sweep's views, orders 2-5, reflect and wrap, float32
    and float64: equal digests from two trees mean bit-equal K6s."""
    import hashlib
    import torch
    from elasticdeform_tpu_torch.ops import prefilter as pf
    h = hashlib.sha256()
    shapes = [(131, 9, 1), (23, 64, 3), (5, 224, 33), (3, 64, 64),
              (2, 9, 100), (2, 1760, 1), (3, 881, 5), (1, 160, 43008),
              (160, 192, 224), (30720, 224, 1)]
    for shape, dtype, order, bc in itertools.product(
            shapes, (torch.float32, torch.float64), (2, 3, 4, 5),
            ("reflect", "wrap")):
        x = torch.as_tensor(rs.rand(*shape) * 200 - 50, dtype=dtype,
                            device="cuda")
        h.update(_bits(pf.spline_filter1d_bc(x, order, 1, bc)).cpu()
                 .numpy().tobytes())
    return h.hexdigest()


def _grid_halves(coeffs, coords, g, reps):
    """``grid_sampler_3d_backward``'s input and grid halves (order 1,
    border padding, align_corners) on ``coeffs`` ``(B, D, H, W, 1)`` at
    ``coords`` ``(B, 3, D, H, W)`` with cotangent ``g``, in ms: the
    yardsticks of K3/K3c and K5/K5c at order 1."""
    import torch
    spatial = coeffs.shape[1:-1]
    inp = coeffs.movedim(-1, 1).contiguous()
    grid = torch.stack([coords[:, h] * (2.0 / (spatial[h] - 1)) - 1.0
                        for h in (2, 1, 0)], -1).contiguous()
    gy = g.movedim(-1, 1).contiguous()
    return [_time_ms(lambda m=m: torch.ops.aten.grid_sampler_3d_backward(
        gy, inp, grid, 0, 1, True, m), reps)
        for m in ([True, False], [False, True])]


def _times_ab_k3(rs, reps):
    """K3 at c5 (64 x 64^3 float32, order 3, mirror, per-sample 3^3 grids
    of sigma 6, and at order 1, nearest) and K3c at c7 (4 x 160 x 192 x
    224 float32, order 1, nearest, a smooth field of ~4 voxels), K5 at c5
    (orders 1 and 3) and K5c at c7, through the public wrappers only, in
    ms; beside them ``grid_sampler_3d_backward``'s input and grid halves
    at c5's and c7's order-1 shapes (:func:`_grid_halves`)."""
    import torch
    from elasticdeform_tpu_torch.ops import resample_bwd as rb
    from elasticdeform_tpu_torch.ops.displacement import dense_displacement
    dev = torch.device("cuda")
    S = (64, 64, 64)
    gy = torch.as_tensor(rs.rand(64, *S, 1).astype(np.float32), device=dev)
    x = torch.as_tensor(rs.rand(64, *S, 1).astype(np.float32), device=dev)
    grid = torch.as_tensor((rs.randn(64, 3, 3, 3, 3) * 6).astype(np.float32),
                           device=dev)
    displ = dense_displacement(grid, S, S, (0, 0, 0))
    out = {f"K3_c5_order{o}": _time_ms(
        lambda o=o, m=m: rb.resample_transpose(gy, displ, None, (0, 0, 0), o,
                                               m, S), reps)
        for o, m in ((3, 3), (1, 0))}
    out.update({f"K5_c5_order{o}": _time_ms(
        lambda o=o, m=m: rb.resample_coord_grad(x, gy, displ, None,
                                                (0, 0, 0), o, m), reps)
        for o, m in ((3, 3), (1, 0))})
    iota = torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=dev) for n in S],
        indexing="ij"))
    out["grid_sampler_bwd_c5_input"], out["grid_sampler_bwd_c5_grid"] = \
        _grid_halves(x, iota + displ, gy, reps)
    del gy, x, grid, displ, iota
    S = (160, 192, 224)
    g = torch.as_tensor(rs.randn(4, *S, 1).astype(np.float32), device=dev)
    x = torch.as_tensor(rs.rand(4, *S, 1).astype(np.float32), device=dev)
    iota = torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=dev) for n in S],
        indexing="ij"))
    coords = (iota + torch.as_tensor(_smooth_field(rs, 4, S, 4.0),
                                     device=dev)).contiguous()
    del iota
    out["K3c_c7"] = _time_ms(
        lambda: rb.resample_coords_transpose(g, coords, 1, 0, S), reps)
    out["K5c_c7"] = _time_ms(
        lambda: rb.resample_coords_grad(x, g, coords, 1, 0), reps)
    out["grid_sampler_bwd_c7_input"], out["grid_sampler_bwd_c7_grid"] = \
        _grid_halves(x, coords, g, reps)
    return out


def _host_us(fn, n=200):
    """Microseconds of the host per call of ``fn``, ``n`` calls on
    ``time.perf_counter`` with no sync (the enqueue)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _times_ab_p2_k13(reps):
    """P2 at ``probe_dyngather`` and ``probe_dyngather2``'s four runs
    (calls back to back, ms, and the host's and the device's microseconds
    per call, :func:`_split_us`), K13's
    single 3^3 erosion sweep of a c17-shaped segmentation (160 x 192 x 224
    bool, back to back) and its hole filling and propagation (one call to
    the sync, host clock), through the public wrappers only."""
    import torch
    import elasticdeform_tpu_torch as et
    from elasticdeform_tpu_torch.ops import morphology as mo
    from elasticdeform_tpu_torch.ops import probes as po
    from elasticdeform_tpu_torch.probes import probe_dyngather2 as dg2
    from elasticdeform_tpu_torch.probes import probe_pallas as pp
    gt, gi = pp.dyngather_data("cuda")
    cases = {"dyngather": lambda: po.row_gather(gt, gi)}
    for label, contract, n_rows, chunk, shape in _DG2_RUNS:
        t, i, _ = dg2.gather_data(n_rows, chunk, shape, "cuda")
        fn = po.row_gather if contract == "take" else po.row_gather_element
        cases[f"dyngather2 {label}"] = lambda fn=fn, t=t, i=i: fn(t, i)
    out = {}
    for label, fn in cases.items():
        out[f"P2 {label}"] = _loop_ms(fn, reps=reps)
        host, device, _ = _split_us(fn)
        out[f"P2 {label} host_us"] = host
        out[f"P2 {label} device_us"] = device
    m, sd = _segmentation(np.random.RandomState(17), (160, 192, 224))
    m = torch.as_tensor(m, device="cuda")
    sd = torch.as_tensor(sd, device="cuda")
    ones3 = np.ones((3, 3, 3), dtype=bool)
    out["K13 sweep"] = _loop_ms(lambda: mo.binary_step(
        m, ones3, [1, 1, 1], False, False), n=10, reps=reps)

    def wall(fn):
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])
    out["K13 fill_holes"] = wall(lambda: et.binary_fill_holes(
        m, device="cuda"))
    out["K13 propagation"] = wall(lambda: et.binary_propagation(
        sd, mask=m, device="cuda"))
    return out


def _times_ab_k10(rs, reps):
    """K10 for :func:`times_ab`: c16's 5^3 erosion and dilation (512 x 512
    x 300 int16, reflect), one pass of size 5 along each of its axes and
    of size 3 along its contiguous one, and one pass of size 5 along the
    axis above a contiguous axis of 96 (64 x 128 x 128 x 96 uint8) and of
    160 (int16), all through the public wrappers."""
    import torch
    from elasticdeform_tpu_torch.ops import morphology as mo
    dev = torch.device("cuda")
    out = {}
    v16 = torch.as_tensor(rs.randint(-1024, 3072, (512, 512, 300)).astype(
        np.int16), device=dev)
    for name, minimum in (("K10_c16_erosion", True),
                          ("K10_c16_dilation", False)):
        out[name] = _time_ms(lambda minimum=minimum: mo.apply_min_max_filter(
            v16, 5, None, None, "reflect", 0.0, 0, minimum), reps)
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = [(f"K10_c16_axis{a}", v16, a, 5) for a in (0, 1, 2)]
    cases.append(("K10_c16_axis2_size3", v16, 2, 3))
    for shape, dtype in (((64, 128, 128, 96), torch.uint8),
                         ((64, 128, 128, 160), torch.int16)):
        x = torch.randint(0, 120, shape, generator=gen, device=dev,
                          dtype=torch.int16).to(dtype)
        cases.append((f"K10_{shape[-1]}_{str(dtype)[6:]}_axis2", x, 2, 5))
    for name, x, axis, size in cases:
        out[name] = _time_ms(lambda x=x, axis=axis, size=size:
                             mo.min_max_filter1d(x, size, axis, "reflect", 0,
                                                 size // 2, True), reps)
    return out


def _times_ab_k9_k11(rs, reps):
    """K9 at c14's two calls (a 5^3 kernel at origin (1, 0, -1) on 160 x
    192 x 224 float32, constant, cval 0.5; a 3^3 kernel over a batch of
    two, reflect) and K11 at c16's three (512 x 512 x 300 int16: a ball of
    radius 2, erosion and dilation; the non-flat 3^3 dilation of 256
    slices), through the public wrappers only, in ms."""
    from elasticdeform_tpu_torch.ops import filters as ft
    from elasticdeform_tpu_torch.ops import morphology as mo
    import torch
    S = (160, 192, 224)
    x = torch.as_tensor(rs.rand(*S).astype(np.float32), device="cuda")
    b = torch.as_tensor(rs.rand(2, *S).astype(np.float32), device="cuda")
    w5, w3 = rs.randn(5, 5, 5), rs.randn(1, 3, 3, 3)
    out = {"K9_c14_5^3": _time_ms(lambda: ft.correlate_nd(
        x, w5, (3, 2, 1), "constant", 0.5), reps),
        "K9_c14_3^3_batch2": _time_ms(lambda: ft.correlate_nd(
            b, w3, (0, 1, 1, 1), "reflect", 0.0), reps)}
    del x, b
    v = torch.as_tensor(rs.randint(-1024, 3072, (512, 512, 300)).astype(
        np.int16), device="cuda")
    s3 = -30.0 * ((np.indices((3, 3, 3)) - 1) ** 2).sum(0)
    ball = _ball(2)
    for label, fn in (
            ("K11_c16_ball_erosion", lambda: mo.min_max_filter(
                v, ball, None, [2, 2, 2], "reflect", 0, True)),
            ("K11_c16_ball_dilation", lambda: mo.min_max_filter(
                v, ball, None, [2, 2, 2], "reflect", 0, False)),
            ("K11_c16_nonflat_3^3", lambda: mo.min_max_filter(
                v[:256], np.ones((3, 3, 3), bool), s3, [1, 1, 1], "reflect",
                0.0, False))):
        out[label] = _time_ms(fn, reps)
    return out


def times_ab(card, reps=REPS):
    """K2 over c5's three axes (64 x 64^3 float32, order 3) beside the
    ``tensordot`` chain, K8T and K8 over c11's three axes (3 x 160 x 192 x
    224 float32, 17 taps, reflect), K8 on c13's paired passes (512 x 512 x
    300 float64, 9 taps, mirror) per axis, K12's 5^3 median, 3^3 median and
    33-tap ball percentile at c15's 160 x 192 x 224 float32, K6 over c8's
    three axes (1 x 160 x 192 x 224
    float32, reflect, order 3) and c9's input (96^3, wrap) beside the
    ``tensordot`` chain, K2 with the uint8 writeback over c2's 200 x 300
    (float64), K9T at c14's shapes (160x192x224 float32, a 5^3 kernel at
    origin (1, 0, -1), constant mode) beside ``conv_transpose3d`` (TF32
    off), K9 at c14 and K11 at c16 (:func:`_times_ab_k9_k11`), K10
    (:func:`_times_ab_k10`), K3 and K3c
    (:func:`_times_ab_k3`: with K5 and K5c and ``grid_sampler_3d_backward``'s
    halves), P2 and K13
    (:func:`_times_ab_p2_k13`), and every config c1-c19
    whole, K16's and K17's calls at c19 (:func:`_times_ab_relax`), in ms
    (CUDA events, median of ``reps``); and the digest of K6's
    outputs over a sweep (:func:`_k6_digest`). It calls only the package's
    public wrappers and configs, so it also times an older tree's package,
    one process per tree, in one call to the card. Prints one line ``ab: {json}`` and
    returns it."""
    import torch
    import torch.nn.functional as F
    from elasticdeform_tpu_torch.ops import filters as ft
    from elasticdeform_tpu_torch.ops import prefilter as pf
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rs = np.random.RandomState(5)
    x = torch.as_tensor(rs.rand(64, 64, 64, 64, 1).astype(np.float32),
                        device=dev)
    mat = torch.as_tensor(pf.filter_matrix(64, 3), dtype=x.dtype, device=dev)

    def k2():
        y = x
        for a in (1, 2, 3):
            y = pf.spline_filter1d(y, 3, a)
        return y

    def k2_lib():
        y = x
        for a in (1, 2, 3):
            y = torch.movedim(torch.tensordot(mat, y, dims=([1], [a])), 0, a)
        return y
    v = torch.as_tensor(rs.rand(160, 192, 224).astype(np.float32),
                        device=dev)
    w5 = rs.randn(5, 5, 5)
    w5t = torch.as_tensor(w5, dtype=v.dtype, device=dev)[None, None]
    out = {"K2_c5": _time_ms(k2, reps), "tensordot_c5": _time_ms(k2_lib, reps),
           "K9T_c14": _time_ms(lambda: ft.correlate_nd_transpose(
               v, w5, (3, 2, 1), "constant"), reps),
           "conv_transpose3d_c14": _time_ms(
               lambda: F.conv_transpose3d(v[None, None], w5t, padding=2),
               reps)}
    del x
    for label, y, bc in (("c8", v[None], "reflect"),
                         ("c9", torch.as_tensor(rs.rand(1, 96, 96, 96).astype(
                             np.float32), device=dev), "wrap")):
        mats = [torch.as_tensor(pf.filter_matrix_bc(n, 3, bc),
                                dtype=y.dtype, device=dev)
                for n in y.shape[1:]]

        def k6(y=y, bc=bc):
            for a in (1, 2, 3):
                y = pf.spline_filter1d_bc(y, 3, a, bc)
            return y

        def k6_lib(y=y, mats=mats):
            for a in (1, 2, 3):
                y = torch.movedim(torch.tensordot(mats[a - 1], y,
                                                  dims=([1], [a])), 0, a)
            return y
        out[f"K6_{label}"] = _time_ms(k6, reps)
        out[f"tensordot_{label}"] = _time_ms(k6_lib, reps)
    xi = torch.as_tensor(rs.randint(0, 256, (1, 200, 300, 1)),
                         dtype=torch.float64, device=dev)

    def wb():
        y = xi
        for a in (1, 2):
            y = pf.spline_filter1d(y, 3, a, np.uint8)
        return y
    out["K2_writeback_c2"] = _time_ms(wb, reps)
    x18 = torch.as_tensor(rs.randint(-1000, 3001, (1, 128, 128, 128, 1)),
                          dtype=torch.float32, device=dev)

    def wb18():
        y = x18
        for a in (1, 2, 3):
            y = pf.spline_filter1d(y, 3, a, np.int16)
        return y
    out["K2_writeback_c18"] = _time_ms(wb18, reps)
    del x18
    out.update(_times_ab_k10(rs, reps))
    f11 = torch.as_tensor(rs.rand(3, 160, 192, 224).astype(np.float32),
                          device=dev)
    w11 = ft.gaussian_weights(2.0, 0, 4.0, None)

    def k8t():
        y = f11
        for a in (3, 2, 1):
            y = ft.correlate1d_transpose(y, w11, a, "reflect", 8)
        return y
    out["K8T_c11"] = _time_ms(k8t, reps)

    def k8():
        y = f11
        for a in (1, 2, 3):
            y = ft.correlate1d(y, w11, a, "reflect", 0.0, 8)
        return y
    out["K8_c11"] = _time_ms(k8, reps)
    del f11
    v13 = torch.as_tensor(rs.randint(-1024, 3072, (512, 512, 300)),
                          dtype=torch.float64, device=dev)
    w13 = ft.gaussian_weights(1.0, 0, 4.0, None)
    for a in (0, 1, 2):
        out[f"K8_c13_paired_axis{a}"] = _time_ms(
            lambda a=a: ft.correlate1d(v13, w13, a, "mirror", 0.0, 4, 1),
            reps)
    del v13
    x15 = torch.as_tensor(_mri_like(rs, (160, 192, 224)), device=dev)
    out["K12_select_c15"] = _time_ms(lambda: mo.rank_filter(
        x15, np.ones((5, 5, 5), bool), [2, 2, 2], "reflect", 0.0, 62), reps)
    out["K12_network_c15_median3"] = _time_ms(lambda: mo.rank_filter(
        x15, np.ones((3, 3, 3), bool), [1, 1, 1], "reflect", 0.0, 13), reps)
    out["K12_network_c15_ball33"] = _time_ms(lambda: mo.rank_filter(
        x15, _ball(2), [2, 2, 2], "reflect", 0.0, 6), reps)
    del x15
    out.update(_times_ab_k9_k11(rs, reps))
    out["K6_digest"] = _k6_digest(rs)
    del v, xi
    out.update(_times_ab_k3(rs, reps))
    out.update(_times_ab_p2_k13(reps))
    import elasticdeform_tpu_torch as et
    for cfg in _configs():
        if cfg.name == "c19" and not hasattr(et, "watershed_ift"):
            continue   # a tree before the distance transforms
        out[cfg.name] = _time_ms(lambda run=cfg.run: run("cuda"), reps)
        if cfg.name == "c19":
            out.update(_times_ab_relax(cfg, reps))
            out.update(_times_ab_edt(cfg, reps))
    print(f"ab: {json.dumps(out)} [{card}]")
    return out


def _times_ab_relax(cfg19, reps):
    """K16's and K17's calls at c19 through the public API: the taxicab CDT
    with indices of c19's mask and the watershed of its gradient, ms (CUDA
    events) and device ms (``torch.profiler``) per call."""
    import torch
    import elasticdeform_tpu_torch as et
    m, img, mk = (torch.as_tensor(a, device="cuda") for a in cfg19.inputs)
    out = {}
    for label, fn in (
            ("K16_call_c19", lambda: et.distance_transform_cdt(
                m, metric="taxicab", return_indices=True, device="cuda")),
            ("K17_call_c19", lambda: et.watershed_ift(img, mk,
                                                      device="cuda"))):
        out[label] = _time_ms(fn, reps)
        out[f"{label}_device"] = _device_ms(fn, calls=3)
    return out


def _times_ab_edt(cfg19, reps):
    """K14 and K15 at c19 through the module functions both trees have
    (``nearest_background`` with the planes; ``minplus_pass`` along axes 1
    and 2, c19's two passes) and the EDT call through the public API: ms
    (CUDA events) and device ms (``torch.profiler``) each, and a digest of
    the passes' output bits (equal digests: bit-equal results)."""
    import hashlib
    import torch
    import elasticdeform_tpu_torch as et
    from elasticdeform_tpu_torch.ops import distance as ds
    m = torch.as_tensor(cfg19.inputs[0], device="cuda")
    samp = (1.5, 1.0, 1.0)
    f0, ix0 = ds.nearest_background(m, samp[0], True)

    def passes():
        f, ix = f0, ix0
        for ax in (1, 2):
            f, ix = ds.minplus_pass(f, ix, ax, samp[ax])
        return f, ix

    out = {}
    for label, fn in (
            ("K14_c19", lambda: ds.nearest_background(m, samp[0], True)),
            ("K15_passes_c19", passes),
            ("EDT_call_c19", lambda: et.distance_transform_edt(
                m, sampling=samp, return_indices=True, device="cuda"))):
        out[label] = _time_ms(fn, reps)
        out[f"{label}_device"] = _device_ms(fn, calls=3)
    h = hashlib.sha256()
    for t in (*passes(), *ds.nearest_background(m, samp[0], True)):
        h.update(t.cpu().numpy().tobytes())
    out["EDT_digest_c19"] = h.hexdigest()[:16]
    return out


def phase_times(card, total_launches, errs, probe_data, routes=None,
                k13=None):
    """Phase 4: kernel, plain and library times at the c5 shapes (and the
    other tiers' shapes, the probes' default sizes), and the configs'
    throughput. ``routes``: phase 3's launches per route of the kernels
    that have routes, kept in their rows; ``k13``: phase 3's K13 sweeps
    and pack and unpack launches, kept in its row."""
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
    save_routes = _route_counts()
    numel = x.numel()
    n_out = math.prod(S)
    rows = []

    def row(name, source, replaces, ms, plain_ms, bound, library_ms, err,
            at="c5", extra=None):
        # "route" names the build route (CUDA C++); a kernel's own plan
        # route (K3's tile or direct) is kept as "plan_route"
        extra = dict(extra or {})
        if "route" in extra:
            extra["plan_route"] = extra.pop("route")
        rows.append({"name": name, "route": "cuda",
                     "source": f"elasticdeform_tpu_torch/csrc/{source}",
                     "replaces": replaces,
                     "launches": total_launches[name],
                     "max_abs_err": max(err, errs[name]), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "library_ms": library_ms,
                     "shapes": at, **(extra or {})})
        if routes and name in routes:
            rows[-1]["routes"] = routes[name]
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

    def k2_lines(y, o, a):
        return pf._launch_filter(y, o, a, pf._tile_plan(
            *pf._lines(y, a), y.dtype, route="lines"))
    if not torch.equal(_bits(chain(pf.spline_filter1d, (1, 2, 3))()),
                       _bits(chain(k2_lines, (1, 2, 3))())):
        raise AssertionError("K2 at c5 shapes: the tile route differs from "
                             "the lines route")
    axes = _tile_axes("spline_prefilter at (64, 64, 64, 64, 1) f32", x, order,
                      "mirror", card, "K2")
    filter_bound = _bound(3 * 2 * numel * 4,
                          3 * numel * (1 + 4 * len(pf.spline_poles(order))))
    row("spline_prefilter", "prefilter.cu",
        "elasticdeform_tpu/ops/prefilter.py:333",
        _time_ms(chain(pf.spline_filter1d, (1, 2, 3))),
        _time_ms(chain(pf.spline_filter1d_plain, (1, 2, 3))), filter_bound,
        _time_ms(chain(None, (1, 2, 3), fwd_mats)), k2_err,
        extra={"lines_route_ms": _time_ms(chain(k2_lines, (1, 2, 3))),
               **axes})
    # K2's writeback route, a kernel of its own (writeback_product_kernel),
    # on a 128^3 int16 volume (c18's kind, at the size before its cut); its
    # launches are phase 3's on that route
    wb = _times_writeback(rs, card)
    c18 = wb["128^3 int16 float32"]
    rows.append({"name": "spline_prefilter_writeback", "route": "cuda",
                 "source": "elasticdeform_tpu_torch/csrc/prefilter.cu",
                 "replaces": "elasticdeform_tpu/ops/deform.py:197",
                 "launches": (routes or {}).get("spline_prefilter", {}).get(
                     "writeback", 0),
                 "max_abs_err": 0.0, "ms": c18["ms"],
                 "plain_ms": c18["plain_ms"], "bound_ms": c18["bound_ms"],
                 "bound_by": c18["bound_by"],
                 "library_ms": c18["library_ms"],
                 "shapes": "128^3 int16 (c18's kind)",
                 "rows_route_ms": c18["rows_ms"],
                 "no_skip_ms": c18["no_skip_ms"], "at": wb})
    coeffs = chain(pf.spline_filter1d, (1, 2, 3))()

    # (the transposed matrices in the order the axes are applied, 3, 2, 1)
    t_mats = [torch.as_tensor(pf.filter_matrix(n, order).T.copy(),
                              dtype=x.dtype, device=dev) for n in S][::-1]
    tr = pf.spline_filter1d_transpose
    k4_err = _assert_close(
        chain(tr, (3, 2, 1))(),
        chain(pf.spline_filter1d_transpose_plain, (3, 2, 1))(),
        *_tol(torch.float32, float(x.abs().max())), "K4 at c5 shapes")

    def tr_lines(y, o, a):
        return pf._launch_transpose(y, o, a, "mirror", pf._tile_plan(
            *pf._lines(y, a), y.dtype, route="lines"))
    if not torch.equal(_bits(chain(tr, (3, 2, 1))()),
                       _bits(chain(tr_lines, (3, 2, 1))())):
        raise AssertionError("K4 at c5 shapes: the tile route differs from "
                             "the lines route")
    axes = _tile_axes("spline_prefilter_transpose at (64, 64, 64, 64, 1) "
                      "f32", x, order, "mirror", card, "K4")
    row("spline_prefilter_transpose", "prefilter.cu",
        "elasticdeform_tpu/ops/prefilter.py:376",
        _time_ms(chain(tr, (3, 2, 1))),
        _time_ms(chain(pf.spline_filter1d_transpose_plain, (3, 2, 1))),
        filter_bound, _time_ms(chain(None, (3, 2, 1), t_mats)), k4_err,
        extra={"lines_route_ms": _time_ms(chain(tr_lines, (3, 2, 1))),
               **axes})

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
    k1_ms = _time_ms(lambda: rsm.resample(coeffs, *args, 0.0))
    # the narrow table: the coefficients read as bfloat16
    bf16 = [_time_ms(lambda: rsm.resample(x, *a1, 0.0, torch.bfloat16)),
            _time_ms(lambda: rsm.resample(coeffs, *args, 0.0,
                                          torch.bfloat16))]
    k1_lines = [("K1 resample_fwd at c5 shapes (order 1, nearest)",
                 o1["fwd"][0], B * n_out * 2 ** 3 * C, bf16[0], o1["fwd"][1]),
                ("K1 resample_fwd at c5 shapes (order 3, mirror)", k1_ms,
                 B * n_out * 4 ** 3 * C, bf16[1], None)]
    row("resample_fwd", "resample.cu", "elasticdeform_tpu/ops/resample.py:66",
        k1_ms,
        _time_ms(lambda: rsm.resample_plain(coeffs, *args, 0.0), warmup=1),
        _bound((numel + 3 * B * n_out + B * n_out * C) * 4,
               _k1_ops(B, n_out, 3, order, C)), o1["fwd"][1], k1_err,
        extra={"order1_ms": o1["fwd"][0], "order1_bf16_table_ms": bf16[0],
               "bf16_table_ms": bf16[1]})

    # K3: the scatter of gy back onto the coefficients (reads gy and the
    # displacement, writes d_coeffs once; the zero fill that its atomics
    # need is the design's cost, not the function's), on each route and
    # tile, at orders 3 and 1 (the order-1 line beside grid_sample's input
    # half)
    k3_err, _ = _check_k3(rb, gy, args, S, torch.float32, "K3 at c5 shapes")
    k3_bytes = (B * n_out * (C + 3) + numel) * 4
    k3_lines = []
    k3 = {}
    for o, a in ((order, args), (2, (displ, None, (0, 0, 0), 2, 3)),
                 (1, a1)):
        k3[o] = _k3_times(
            f"K3 resample_bwd at c5 shapes (order {o}, "
            f"{'mirror' if a[4] == 3 else 'nearest'})",
            lambda plan, a=a: rb._launch_k3(gy, *a, S, plan),
            iota + displ, S, o, a[4], (S, S, C, o, gy.dtype), card,
            k3_lines, o1["bwd"][1] if o == 1 else None)
    row("resample_bwd", "resample_bwd.cu",
        "elasticdeform_tpu/ops/windows.py:1354", k3[order]["ms"],
        _time_ms(lambda: rb.resample_transpose_plain(gy, *args, S),
                 warmup=1),
        _bound(k3_bytes, _k1_ops(B, n_out, 3, order, C)), o1["bwd"][1],
        k3_err, extra={"order1_ms": k3[1]["ms"], **k3[order],
                       "order2": k3[2], "order1": k3[1]})

    # K5: the gradient with respect to the dense displacement
    k5_err = _assert_close(
        rb.resample_coord_grad(coeffs, gy, *args),
        rb.resample_coord_grad_plain(coeffs, gy, *args),
        *_tol(torch.float32, _k5_scale(coeffs, gy)), "K5 at c5 shapes")
    box = _tap_box_share(iota + displ, S, order, 3)
    print(f"K5's 256-voxel blocks at c5 shapes (order 3, mirror) whose tap "
          f"box fits 16 KB unfolded: {100 * box[0]:.2f}%, median box "
          f"{box[1] / 1024:.1f} KB")
    row("resample_coord_grad", "resample_bwd.cu",
        "elasticdeform_tpu/ops/windows.py:1247",
        _time_ms(lambda: rb.resample_coord_grad(coeffs, gy, *args)),
        _time_ms(lambda: rb.resample_coord_grad_plain(coeffs, gy, *args),
                 reps=3, warmup=1),
        _bound((numel + B * n_out * C + 2 * 3 * B * n_out) * 4,
               _k5_ops(B, n_out, 3, order, C)), o1["grad"][1], k5_err,
        extra={"order1_ms": o1["grad"][0], "box_16k_share": box[0]})
    del x, gy, coeffs, displ, iota
    _times_resampler(row, card, k1_lines, k3_lines)
    _times_filters(row, card)
    _times_morphology(row, card, k13)
    configs = _configs()
    _times_distance(row, card, next(c for c in configs if c.name == "c19"))
    _times_measure(row, card, next(c for c in configs if c.name == "c20"))
    probe_times = _times_probes(row, card, probe_data, errs)
    _print_k1_lines(k1_lines, probe_times, card)
    _print_k3_lines(k3_lines, probe_times, card)
    _times_displacement(card)
    for w, v in save.items():
        w.launches = v
    for k, by_route in save_routes.items():
        _path_wrappers()[k].routes.update(by_route)

    for cfg in configs:
        ms = _time_ms(lambda run=cfg.run: run("cuda"))
        print(f"{cfg.name}: {ms:.3f} ms per call, "
              f"{cfg.n_vox / ms / 1e3:.2f} Mvox/s (output voxels) [{card}]")
        _profile_config(cfg, card)
        if cfg.name == "c6":
            times_c6(card, cfg)
    order_of = {k: i for i, k in enumerate(KERNELS)}
    order_of["spline_prefilter_writeback"] = order_of["spline_prefilter"]
    return sorted(rows, key=lambda r: order_of[r["name"]])


def _times_displacement(card):
    """The dense displacement (``ops/displacement.py::dense_displacement``,
    a ``tensordot`` per axis of the control grid: no kernel of the port) at
    c5's and c6's shapes (64 and 8 samples of a 3 x 3 x 3 grid to 64^3
    float32), its ms beside its byte bound (the field written once), and
    its calls over one run of every config (phase 4 runs them on the card;
    a config that takes a dense field, as c7 does, makes none)."""
    import torch
    from elasticdeform_tpu_torch.ops import deform as dfm
    from elasticdeform_tpu_torch.ops.displacement import dense_displacement
    rs = np.random.RandomState(6)
    S = (64, 64, 64)
    for label, B in (("c5", 64), ("c6", 8)):
        grid = torch.as_tensor((rs.randn(B, 3, 3, 3, 3) * 6).astype(
            np.float32), device="cuda")
        ms = _time_ms(lambda: dense_displacement(grid, S, S, (0, 0, 0)))
        bound = _bound(B * 3 * math.prod(S) * 4, 0)
        print(f"dense displacement at {label} shapes ({B} x 3^3 grids to "
              f"64^3 float32): {ms:.4f} ms, bound {bound[0]:.4f} ms by "
              f"{bound[1]} [{card}]")
    calls = {}
    real = dfm.dense_displacement

    def counted(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **k)
    dfm.dense_displacement = counted
    try:
        for cfg in _configs():
            name = cfg.name
            cfg.run("cuda")
    finally:
        dfm.dense_displacement = real
    torch.cuda.synchronize()
    print(f"dense displacement calls per config run: {calls}; "
          f"{sum(calls.values())} in all [{card}]")


def _device_kernels(prof, calls):
    """``{name: (device ms, launches)}`` per call of the device's own
    events (kernels, copies, memsets) in a ``torch.profiler`` trace of
    ``calls`` calls. The host operators that launched them carry the same
    device time as their self time, so they are left out."""
    import torch
    kern = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)
        if t > 0 and getattr(e, "device_type",
                             None) != torch.autograd.DeviceType.CPU:
            kern[e.key] = (t / 1e3 / calls, e.count / calls)
    return kern


def profile_ab(card, names=("c14", "c16"), reps=REPS, calls=10):
    """Each config of ``names`` whole (CUDA events, median of ``reps``), then
    ``calls`` calls of it under ``torch.profiler``: per kernel its device
    time and launches per call, and the host's wall time per call; and K9
    and K9T alone at c14's shapes (a 5^3 kernel at origin (1, 0, -1) on
    160 x 192 x 224 float32, constant mode; a 3^3 kernel over a batch of
    two, reflect), CUDA events. Like :func:`times_ab` it calls only the
    package's public wrappers and configs, so it also profiles an older
    tree's package, one process per tree, in one call to the card. Prints
    one line ``profile_ab: {json}`` and returns it. K11 alone at c16's
    calls too (:func:`_times_ab_k9_k11`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from elasticdeform_tpu_torch.ops import filters as ft
    dev = torch.device("cuda")
    rs = np.random.RandomState(5)
    out = {}
    for cfg in _configs():
        if cfg.name not in names:
            continue
        out[cfg.name] = _time_ms(lambda run=cfg.run: run("cuda"), reps)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                cfg.run("cuda")
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / calls
        kern = _device_kernels(prof, calls)
        out[f"{cfg.name} profiled"] = {
            "wall_ms_per_call": wall,
            "device_ms_per_call": sum(t for t, _ in kern.values()),
            "kernels": {k[:90]: v for k, v in kern.items()}}
    out.update(_times_ab_k9_k11(rs, reps))
    x = torch.as_tensor(rs.rand(160, 192, 224).astype(np.float32), device=dev)
    w5 = rs.randn(5, 5, 5)
    out["K9T_c14"] = _time_ms(lambda: ft.correlate_nd_transpose(
        x, w5, (3, 2, 1), "constant"), reps)
    print(f"profile_ab: {json.dumps(out)} [{card}]")
    return out


def _device_ms(fn, calls=10):
    """The device's busy time per call of ``fn`` (every kernel, copy and
    memset it runs, :func:`_device_kernels`) over ``calls`` calls under
    ``torch.profiler``, after one warm-up call: unlike CUDA events around a
    call, it leaves out the host's time between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(t for t, _ in _device_kernels(prof, calls).values())


def _profile_config(cfg, card):
    """One call of a config under ``torch.profiler``: the host's wall time
    to the sync, the device's busy time (the self device time of every
    kernel, copy and memset; one stream, so they do not overlap), its idle
    share, and the three kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cfg.run("cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [(t, n, k) for k, (t, n) in _device_kernels(prof, 1).items()]
    busy = sum(t for t, _, _ in dev)
    top = "; ".join(f"{k[:60]} {t:.3f} ms x{n:g}"
                    for t, n, k in sorted(dev, reverse=True)[:3])
    print(f"{cfg.name} profiled: wall {wall:.3f} ms (profiler on), device "
          f"busy {busy:.3f} ms, idle {100 * max(0.0, 1 - busy / wall):.1f}%;"
          f" top: {top} [{card}]")


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
    total, _, routes, k13 = phase_main_path()
    probe_launches = phase_probe_path(probe_data, probe_outs)
    del probe_outs
    total.update({k: probe_launches[k] for k in PROBE_KERNELS})
    kernels = phase_times(smi, total, errs, probe_data, routes, k13)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
