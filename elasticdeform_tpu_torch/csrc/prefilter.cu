// K2 spline_prefilter: the B-spline prefilter (sample values -> spline
// coefficients) along one axis, as the causal / anti-causal recursion;
// and K4 spline_prefilter_transpose, its exact transpose for the gradient;
// both on the routes described below.
//
// Replaces the JAX package's prefilter stage:
// elasticdeform_tpu/ops/prefilter.py:333 spline_filter1d, which applies a
// dense n x n float64-built filter matrix (:109 filter_matrix) on the TPU's
// matrix unit, or an associative scan (:257) on long axes. Here the
// recursion of ops/prefilter.py:56 _filter_lines runs as written: the gain,
// then per pole the causal initialisation (the truncated sum when the
// horizon is shorter than the line, else the full mirror sum over
// 1 - p^(2n-2)), the causal pass, the anti-causal initialisation and the
// anti-causal pass. A line of length n <= 1 passes through unchanged. Its
// plain PyTorch twin is ops/prefilter.py:spline_filter1d_plain (tensordot
// with the float64 filter matrix).
//
// The tensor is viewed as (outer, n, inner) with the filtered axis in the
// middle; line (o, i) is o*n*inner + k*inner + i, k = 0..n-1. The stages
// (k2_stages: the gain, the poles) run on a line in shared memory on the
// tile route, in device memory on the lines route.
//
// Bound on the H100: bytes, 2 * numel * sizeof(T) (each element read once
// and written once) over 3.35 TB/s. The recursion touches each element
// about 2 + 4 * npoles times, in shared memory on the tile route.
//
// K4 replaces the JAX package's transpose prefilter:
// elasticdeform_tpu/ops/prefilter.py:376 spline_filter1d_transpose (the
// transposed filter matrix F^T on the TPU's matrix unit) and :287
// _filter_axis0_scan_transpose (the stage-by-stage adjoint of the scan on
// long axes, which covers the truncated initialisation only). K4 runs
// _filter_lines's stages transposed, in reverse, with both branches of the
// causal initialisation: the transposed full mirror sum spreads row 0's
// cotangent over every k with (p^k + p^(2n-2-k)) / (1 - p^(2n-2)). Its
// plain twin is ops/prefilter.py:spline_filter1d_transpose_plain, a
// tensordot with F^T. Bound: bytes, as K2.
//
// K6 spline_prefilter_bc and K7 spline_prefilter_bc_transpose: the same
// line-parallel recursion and its exact transpose under the 'reflect'
// (half-sample symmetric, period 2n) and 'wrap' (periodic, period n)
// boundary conditions of SciPy >= 1.6 (the public statement of the
// initialisations is ni_splines.c, _init_causal_reflect /
// _init_anticausal_reflect / _init_causal_wrap / _init_anticausal_wrap).
// They replace the JAX package's filter_matrix_bc + _apply_matrix
// (elasticdeform_tpu/ops/prefilter.py:150, :177; core.py:568-569 and
// :1176-1177), a dense n x n inverse of the B-spline sampling matrix on the
// TPU's matrix unit. Per pole, the causal initialisation is the full sum
// over the period, with no truncated branch:
//   reflect: c0 + z/(1 - z^2n) * sum_i z^i (c_i + z^n c_{n-1-i})
//   wrap:    (c0 + sum_{i>=1} z^i c_{n-i}) / (1 - z^n)
// and the anti-causal one c_{n-1} * z/(z - 1) (reflect) or
// (c_{n-1} + sum_{i<n-1} z^(i+1) c_i) * z/(z^n - 1) (wrap). K7 runs each
// stage's transpose in reverse, as K4 does: row 0's (row n-1's) cotangent
// spreads over the line with the same coefficients. Plain twins:
// ops/prefilter.py spline_filter1d_bc_plain / _transpose_plain (tensordot
// with filter_matrix_bc(n, order, bc) or its transpose). Bound as for K2.
// K6 (k6_stages) and K7 take K4's routes.
//
// K2, K4, K6 and K7 take one of two routes, picked on the host by
// ops/prefilter.py:_tile_plan from (outer, n, inner, dtype):
//
// * tile (every line that fits; the tile's geometry and staging are in
//   line_tile.cuh, shared with K8T): a block stages W whole lines (W = 32,
//   64 or 128) in shared memory, runs the recursion there with thread w on
//   line w, and stores the lines back: one read and one write of each
//   element in device memory. When inner >= W, a tile is W consecutive i
//   of one o: row k is W contiguous elements, kept as row k of the shared
//   tile at an odd stride, so that the threads touch consecutive words.
//   When inner < W (the innermost axis: inner is 1 or a channel count), a
//   tile is floor(W / inner) whole outers, one contiguous run of elements
//   that the block loads and stores linearly and keeps as it is in shared
//   memory, each outer's n * inner elements at a stride congruent to inner
//   modulo 32 words, so that the threads of consecutive lines still touch
//   distinct banks (float64 too: 8-byte words). A warp's loads and stores
//   then touch consecutive words in device and shared memory alike, on
//   every axis. The loads are cp.async copies straight into shared memory,
//   all of a thread's in flight at once. The last tile of a row of outers
//   may be partial and is guarded. The stages are the lines route's, word
//   for word (K2 and K6: the gain and the stages in shared memory, then a
//   raw store; K4 and K7: the stages, then a store with the gain),
//   so with --fmad=false the two routes agree bit for bit. The
//   host picks W so that the blocks fill the fewest rounds of the card's
//   SMs: a block's load, recursion and store run in turn, and several
//   blocks on an SM overlap them.
// * lines (a line too long for a tile of 32 lines in the card's 227 KB of
//   shared memory: n > 1760 in float32, n > 880 in float64): one thread per
//   line, the recursion in device memory, uncoalesced on the innermost
//   axis.
//
// K2's writeback route (an integer input: ops/deform.py passes int_dtype):
// the reference's per-axis integer writeback (truncate toward zero, wrap
// modulo 2^int_bits: ops/resample.py cast_int_c) is nonlinear, so where
// the exact value lies at or near an integer, two summation orders that
// agree to 1e-13 can truncate to different integers. This route therefore
// does not run the recursion: each output is the row sum
// y[a] = sum_k M[a,k] x[k] of filter_matrix(n, order) M (uploaded in T),
// k ascending from 0, float64 a rounded multiply then a rounded add
// (__dmul_rn, __dadd_rn), float32 one fused multiply-add per term (fmaf),
// then cast_int_c, stored straight to device memory. Its plain twin
// (ops/prefilter.py:_row_sums) runs the same order; it is the JAX
// package's order where XLA's CPU dot is a sequential chain. n
// multiply-adds per element: bound by operations. A tile form stages W
// lines as the tile route does; a lines form reads lines over the cap
// from device memory. Every row sum is independent, so the rows of a line
// split into runs (Params::row_groups, picked by ops/prefilter.py:
// _row_groups), each run by its own block or thread: with few lines, one
// thread's n * n chain steps would leave most of the card idle. With
// int_bits 0 the route stores the row sums uncast: the fixed-order float
// prefilter of a call whose output is an integer (the general resampler,
// ops/deform.py; K6's boundary conditions through filter_matrix_bc), which
// rounds at the end and so must also sum in one order on both devices.
// The route runs in a product form (writeback_product_kernel,
// below): a block computes a band of rows of a tile of lines as a
// register-blocked product from shared-memory chunks of M^T and of the
// lines, each sum still the same chain; ops/prefilter.py:_writeback_plan
// keeps the rows route above (writeback_rows) for views the product form
// does not take.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "line_tile.cuh"

#define ED_MAXPOLES 2

namespace {

enum { BC_REFLECT = 1, BC_WRAP = 2 };
// the tile kernel's stage sets: K4, K7 (BC_REFLECT, BC_WRAP), K2, K6
// (reflect, wrap) and K2's writeback route
enum { TILE_K4 = 0, TILE_K2 = 3, TILE_K6_REFLECT = 4, TILE_K6_WRAP = 5,
       TILE_K2_WRITEBACK = 6 };

struct Params {
  int64_t outer, n, inner;
  int npoles;
  double pole[ED_MAXPOLES];
  int horizon[ED_MAXPOLES];
  double pn1[ED_MAXPOLES];    // p^(n-1)
  double denom[ED_MAXPOLES];  // 1 - p^(2n-2)
  double zn[ED_MAXPOLES];     // p^n (K6, K7)
  double gain;
  int int_bits;       // K2's writeback route: the integer's bits
  double int_lo;      // iinfo(dtype).min
  const void* mat;    // K2's writeback route: filter_matrix(n) in T
  // K2's writeback route: the rows of a line split into this many runs,
  // each run by its own block (tile form) or thread (lines form)
  int row_groups;
};

template <typename T>
__device__ __forceinline__ T cast_int_c(T v, T lo, T span) {
  const T tr = trunc(v);
  return tr - floor((tr - lo) / span) * span;
}

// The writeback route's store: cast_int_c, or with no integer bits the sum
// as it is.
template <typename T>
__device__ __forceinline__ T wb_out(T v, int bits, T lo, T span) {
  return bits ? cast_int_c(v, lo, span) : v;
}

// The transposed passes and spreads of K4 and K7. Each loop loads kChunk
// elements ahead of its chain, so that a thread waits on one load per
// chunk, not on one per step; every element still sees the same
// operations in the same order. (Within a chunk the loads read no element
// that the chunk's earlier steps store.)
constexpr int kChunk = 8;

// The anti-causal pass ln[k] = z * (ln[k+1] - ln[k]), k = n-2 .. 0,
// transposed: ct[k+1] += z * ct[k], then ct[k] *= -z, k = 0 .. n-2.
// Returns row n-1's cotangent, which the pass leaves unstored.
template <typename T, typename I>
__device__ __forceinline__ T anticausal_t(T* x, const I n, const I s,
                                          const T z) {
  T u = x[0];
  I k = 0;
  for (; k + kChunk < n; k += kChunk) {
    T a[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) a[j] = x[(k + 1 + j) * s];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      x[(k + j) * s] = u * -z;
      u = a[j] + z * u;
    }
  }
  for (; k < n - 1; ++k) {
    const T next = x[(k + 1) * s] + z * u;
    x[k * s] = u * -z;
    u = next;
  }
  return u;
}

// The causal pass ln[k] += z * ln[k-1], k = 1 .. n-1, transposed:
// ct[k-1] += z * ct[k], k = n-1 .. 1.
template <typename T, typename I>
__device__ __forceinline__ void causal_t(T* x, const I n, const I s,
                                         const T z) {
  T v = x[(n - 1) * s];
  I k = n - 1;
  for (; k >= kChunk; k -= kChunk) {
    T a[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) a[j] = x[(k - 1 - j) * s];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      v = a[j] + z * v;
      x[(k - 1 - j) * s] = v;
    }
  }
  for (; k >= 1; --k) {
    v = x[(k - 1) * s] + z * v;
    x[(k - 1) * s] = v;
  }
}

// x[e] = x[e] + zm * t at e = first, first + dir, ... (count elements),
// zm starting at zm and multiplied by z after each.
template <typename T, typename I>
__device__ __forceinline__ void spread(T* x, const I s, const I first,
                                       const I dir, const I count, T zm,
                                       const T z, const T t) {
  I m = 0;
  for (; m + kChunk <= count; m += kChunk) {
    T a[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) a[j] = x[(first + (m + j) * dir) * s];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      x[(first + (m + j) * dir) * s] = a[j] + zm * t;
      zm = zm * z;
    }
  }
  for (; m < count; ++m) {
    const I e = (first + m * dir) * s;
    x[e] = x[e] + zm * t;
    zm = zm * z;
  }
}

// K7's reflect spread for i in [lo, hi): x[i] += zi * t, then
// x[n-1-i] += zn * zi * t, zi *= z. A range within one half of the line
// (i < n-1-i throughout, or i > n-1-i) touches each element once, so its
// chunks may load ahead; the middle element of an odd line is a range of
// its own.
template <typename T, typename I>
__device__ __forceinline__ void reflect_pairs(T* x, const I n, const I s,
                                              const I lo, const I hi, T& zi,
                                              const T z, const T zn,
                                              const T t) {
  I i = lo;
  for (; i + kChunk <= hi; i += kChunk) {
    T a[kChunk], b[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      a[j] = x[(i + j) * s];
      b[j] = x[(n - 1 - i - j) * s];
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      x[(i + j) * s] = a[j] + zi * t;
      x[(n - 1 - i - j) * s] = b[j] + zn * zi * t;
      zi = zi * z;
    }
  }
  for (; i < hi; ++i) {
    x[i * s] = x[i * s] + zi * t;
    x[(n - 1 - i) * s] = x[(n - 1 - i) * s] + zn * zi * t;
    zi = zi * z;
  }
}

// The forward passes of K2, on one line at stride s. Each loop loads
// kChunk elements ahead of its chain, as the transposed passes above do;
// every element sees the same operations in the same order as a loop of
// one step at a time.

// The truncated causal initialisation: x[0] + sum_{k=1}^{h-1} z^k x[k].
template <typename T, typename I>
__device__ __forceinline__ T causal_init_sum(const T* x, const I h, const I s,
                                             const T z) {
  T zn = z;
  T acc = x[0];
  I k = 1;
  for (; k + kChunk <= h; k += kChunk) {
    T a[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) a[j] = x[(k + j) * s];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      acc = acc + zn * a[j];
      zn = zn * z;
    }
  }
  for (; k < h; ++k) {
    acc = acc + zn * x[k * s];
    zn = zn * z;
  }
  return acc;
}

// The full mirror initialisation over the line, before the division by
// 1 - p^(2n-2): x[0] + p^(n-1) x[n-1] + sum_{k=1}^{n-2} (p^k + p^(2n-2-k))
// x[k], with p^(2n-2-k) carried down from pn1 = p^(n-1) by 1/p.
template <typename T, typename I>
__device__ __forceinline__ T causal_init_mirror(const T* x, const I n,
                                                const I s, const T z,
                                                const T pn1) {
  T zn = z;
  const T iz = T(1) / z;
  T z2n = pn1;
  T acc = x[0] + z2n * x[(n - 1) * s];
  z2n = z2n * (z2n * iz);
  I k = 1;
  for (; k + kChunk <= n - 1; k += kChunk) {
    T a[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) a[j] = x[(k + j) * s];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      acc = acc + (zn + z2n) * a[j];
      zn = zn * z;
      z2n = z2n * iz;
    }
  }
  for (; k < n - 1; ++k) {
    acc = acc + (zn + z2n) * x[k * s];
    zn = zn * z;
    z2n = z2n * iz;
  }
  return acc;
}

// The causal pass x[k] = x[k] + z * x[k-1], k = 1 .. n-1; returns x[n-1].
template <typename T, typename I>
__device__ __forceinline__ T causal_f(T* x, const I n, const I s,
                                      const T z) {
  T prev = x[0];
  I k = 1;
  for (; k + kChunk <= n; k += kChunk) {
    T a[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) a[j] = x[(k + j) * s];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      prev = a[j] + z * prev;
      x[(k + j) * s] = prev;
    }
  }
  for (; k < n; ++k) {
    prev = x[k * s] + z * prev;
    x[k * s] = prev;
  }
  return prev;
}

// The anti-causal pass x[k] = z * (x[k+1] - x[k]), k = n-2 .. 0, from
// prev = x[n-1].
template <typename T, typename I>
__device__ __forceinline__ void anticausal_f(T* x, const I n, const I s,
                                             const T z, T prev) {
  I k = n - 2;
  for (; k >= kChunk - 1; k -= kChunk) {
    T a[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) a[j] = x[(k - j) * s];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      prev = z * (prev - a[j]);
      x[(k - j) * s] = prev;
    }
  }
  for (; k >= 0; --k) {
    prev = z * (prev - x[k * s]);
    x[k * s] = prev;
  }
}

// K2's stages on a line already copied in raw: the gain; per pole the
// causal initialisation (the truncated sum when the horizon is shorter
// than the line, else the full mirror sum over 1 - p^(2n-2)), the causal
// pass, the anti-causal initialisation x[n-1] = c (x[n-1] + p x[n-2]) and
// pass. A line of n <= 1 (or no poles) is left as it is. x is one line at
// stride s: device memory on the lines route, a shared-memory tile on the
// tile route.
template <typename T, typename I>
__device__ __forceinline__ void k2_stages(T* x, const I n, const I s,
                                          const Params& p) {
  if (n > 1 && p.npoles > 0) {
    const T gain = T(p.gain);
    for (I k = 0; k < n; ++k) x[k * s] = x[k * s] * gain;
    // unrolled, as in k4_stages, so that no copy of Params stays on the
    // stack
#pragma unroll
    for (int q = 0; q < ED_MAXPOLES; ++q) {
      if (q >= p.npoles) continue;
      const T z = T(p.pole[q]);
      if (p.horizon[q] < n)
        x[0] = causal_init_sum(x, I(p.horizon[q]), s, z);
      else
        x[0] = causal_init_mirror(x, n, s, z, T(p.pn1[q])) / T(p.denom[q]);
      T prev = causal_f(x, n, s, z);
      prev = T(p.pole[q] / (p.pole[q] * p.pole[q] - 1.0)) *
             (prev + z * x[(n - 2) * s]);
      x[(n - 1) * s] = prev;
      anticausal_f(x, n, s, z, prev);
    }
  }
}

// K2, lines route: one thread per line in device memory.
template <typename T>
__global__ void __launch_bounds__(256)
prefilter_kernel(const T* __restrict__ in, T* __restrict__ out,
                 const Params p) {
  const int64_t line = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= p.outer * p.inner) return;
  const int64_t o = line / p.inner;
  const int64_t i = line - o * p.inner;
  const int64_t n = p.n;
  const int64_t s = p.inner;
  const T* src = in + o * n * s + i;
  T* x = out + o * n * s + i;

  for (int64_t k = 0; k < n; ++k) x[k * s] = src[k * s];
  k2_stages<T, int64_t>(x, n, s, p);
}

// K4's stages after the copy: the exact transpose of prefilter_kernel's
// filter (without the integer writeback and without the gain, which the
// caller applies last), equal with the gain to filter_matrix(n).T
// (ops/prefilter.py): per pole in reverse order, the transposed
// anti-causal pass and its init row, ln[n-1] = c (ln[n-1] + p ln[n-2]);
// the transposed causal pass ln[k] += p ln[k-1]; the transposed causal
// init (either branch). x is one line at stride s: device memory on the
// lines route, a shared-memory tile on the tile route.
template <typename T, typename I>
__device__ __forceinline__ void k4_stages(T* x, const I n, const I s,
                                          const Params& p) {
  // unrolled, so that each pole's parameters are read at a fixed offset
  // and the kernel keeps no copy of Params on its stack
#pragma unroll
  for (int q = ED_MAXPOLES - 1; q >= 0; --q) {
    if (q >= p.npoles) continue;
    const T z = T(p.pole[q]);
    const T u = anticausal_t(x, n, s, z);
    // the anti-causal init row ln[n-1] = c * (ln[n-1] + z * ln[n-2]),
    // transposed
    const double c = p.pole[q] / (p.pole[q] * p.pole[q] - 1.0);
    x[(n - 2) * s] = x[(n - 2) * s] + T(c * p.pole[q]) * u;
    x[(n - 1) * s] = u * T(c);
    causal_t(x, n, s, z);
    // causal initialisation, transposed: row 0 spreads onto the others
    if (p.horizon[q] < n) {
      spread(x, s, I(1), I(1), I(p.horizon[q] - 1), z, z, x[0]);
    } else {
      T zn = z;
      const T iz = T(1) / z;
      T z2n = T(p.pn1[q]);
      const T t = x[0] / T(p.denom[q]);
      x[0] = t;
      x[(n - 1) * s] = x[(n - 1) * s] + z2n * t;
      z2n = z2n * (z2n * iz);
      for (I k = 1; k < n - 1; ++k) {
        x[k * s] = x[k * s] + (zn + z2n) * t;
        zn = zn * z;
        z2n = z2n * iz;
      }
    }
  }
}

// K4, lines route: one thread per line in device memory.
template <typename T>
__global__ void __launch_bounds__(256)
prefilter_transpose_kernel(const T* __restrict__ in, T* __restrict__ out,
                           const Params p) {
  const int64_t line = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= p.outer * p.inner) return;
  const int64_t o = line / p.inner;
  const int64_t i = line - o * p.inner;
  const int64_t n = p.n;
  const int64_t s = p.inner;
  const T* src = in + o * n * s + i;
  T* x = out + o * n * s + i;

  for (int64_t k = 0; k < n; ++k) x[k * s] = src[k * s];
  if (n <= 1 || p.npoles == 0) return;
  k4_stages<T, int64_t>(x, n, s, p);
  const T gain = T(p.gain);
  for (int64_t k = 0; k < n; ++k) x[k * s] = x[k * s] * gain;
}

// K6's stages on a line already copied in raw: the filter of k2_stages
// with the initialisations of the boundary condition BC (reflect or wrap).
// The gain; per pole the causal initialisation over the whole period, the
// causal pass, the anti-causal initialisation and pass. A line of n <= 1
// (or no poles) is left as it is. x is one line at stride s, as in
// k2_stages.
template <typename T, int BC, typename I>
__device__ __forceinline__ void k6_stages(T* x, const I n, const I s,
                                          const Params& p) {
  if (n <= 1 || p.npoles == 0) return;
  const T gain = T(p.gain);
  for (I k = 0; k < n; ++k) x[k * s] = x[k * s] * gain;
#pragma unroll   // as in k2_stages
  for (int q = 0; q < ED_MAXPOLES; ++q) {
    if (q >= p.npoles) continue;
    const double zd = p.pole[q], znd = p.zn[q];
    const T z = T(zd);
    const T zn = T(znd);
    // causal initialisation over the whole period
    if (BC == BC_REFLECT) {
      const T c0 = x[0];
      T zi = T(1);
      T acc = T(0);
      for (I i = 0; i < n; ++i) {
        acc = acc + zi * (x[i * s] + zn * x[(n - 1 - i) * s]);
        zi = zi * z;
      }
      x[0] = acc * T(zd / (1.0 - znd * znd)) + c0;
    } else {
      T zi = z;
      T acc = x[0];
      for (I i = 1; i < n; ++i) {
        acc = acc + zi * x[(n - i) * s];
        zi = zi * z;
      }
      x[0] = acc * T(1.0 / (1.0 - znd));
    }
    T prev = causal_f(x, n, s, z);
    // anti-causal initialisation
    if (BC == BC_REFLECT) {
      prev = prev * T(zd / (zd - 1.0));
    } else {
      T zi = z;
      T acc = prev;
      for (I i = 0; i < n - 1; ++i) {
        acc = acc + zi * x[i * s];
        zi = zi * z;
      }
      prev = acc * T(zd / (znd - 1.0));
    }
    x[(n - 1) * s] = prev;
    anticausal_f(x, n, s, z, prev);
  }
}

// K6, lines route: one thread per line in device memory.
template <typename T, int BC>
__global__ void __launch_bounds__(256)
prefilter_bc_kernel(const T* __restrict__ in, T* __restrict__ out,
                    const Params p) {
  const int64_t line = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= p.outer * p.inner) return;
  const int64_t o = line / p.inner;
  const int64_t i0 = line - o * p.inner;
  const int64_t n = p.n;
  const int64_t s = p.inner;
  const T* src = in + o * n * s + i0;
  T* x = out + o * n * s + i0;

  for (int64_t k = 0; k < n; ++k) x[k * s] = src[k * s];
  k6_stages<T, BC, int64_t>(x, n, s, p);
}

// One sum-of-products step of K2's writeback route: float32 one fused
// multiply-add (fmaf, which --fmad=false leaves fused), float64 a rounded
// multiply, then a rounded add.
__device__ __forceinline__ float wb_step(float m, float v, float acc) {
  return fmaf(m, v, acc);
}
__device__ __forceinline__ double wb_step(double m, double v, double acc) {
  return __dadd_rn(acc, __dmul_rn(m, v));
}

// K2's writeback route on one line x at stride s (shared memory on the
// tile form, device memory on the lines form): for a = a0 .. a1-1 the row
// sum of p.mat (n x n, row-major, in T) with k ascending from 0, then
// cast_int_c (none with p.int_bits 0), stored to dst[a * ds]. Four rows
// at a time share each load of x[k] and run four independent chains; each
// row's own chain is the same.
template <typename T, typename I>
__device__ __forceinline__ void writeback_rows(const T* x, const I n,
                                               const I s, T* dst,
                                               const int64_t ds, const I a0,
                                               const I a1, const Params& p) {
  const T* __restrict__ mat = static_cast<const T*>(p.mat);
  const T lo = T(p.int_lo);
  const T span = T(ldexp(1.0, p.int_bits));
  I a = a0;
  for (; a + 4 <= a1; a += 4) {
    const T* r0 = mat + (int64_t)a * n;
    const T* r1 = r0 + n;
    const T* r2 = r1 + n;
    const T* r3 = r2 + n;
    T c0 = T(0), c1 = T(0), c2 = T(0), c3 = T(0);
#pragma unroll 2
    for (I k = 0; k < n; ++k) {
      const T v = x[k * s];
      c0 = wb_step(__ldg(r0 + k), v, c0);
      c1 = wb_step(__ldg(r1 + k), v, c1);
      c2 = wb_step(__ldg(r2 + k), v, c2);
      c3 = wb_step(__ldg(r3 + k), v, c3);
    }
    dst[a * ds] = wb_out(c0, p.int_bits, lo, span);
    dst[(a + 1) * ds] = wb_out(c1, p.int_bits, lo, span);
    dst[(a + 2) * ds] = wb_out(c2, p.int_bits, lo, span);
    dst[(a + 3) * ds] = wb_out(c3, p.int_bits, lo, span);
  }
  for (; a < a1; ++a) {
    const T* row = mat + (int64_t)a * n;
    T acc = T(0);
    for (I k = 0; k < n; ++k) acc = wb_step(__ldg(row + k), x[k * s], acc);
    dst[a * ds] = wb_out(acc, p.int_bits, lo, span);
  }
}

// The rows [a0, a1) of row group g of a line of n under p.row_groups: runs
// of a multiple of 4 rows (ops/prefilter.py:_row_groups).
template <typename I>
__device__ __forceinline__ void row_run(const I n, const int groups,
                                        const int g, I* a0, I* a1) {
  const I run = ((n + groups - 1) / groups + 3) / 4 * 4;
  *a0 = g * run < n ? g * run : n;
  *a1 = *a0 + run < n ? *a0 + run : n;
}

// K2's writeback route, lines form: one thread per line and row group,
// read from device memory.
template <typename T>
__global__ void __launch_bounds__(256)
prefilter_writeback_kernel(const T* __restrict__ in, T* __restrict__ out,
                           const Params p) {
  const int64_t lines = p.outer * p.inner;
  const int64_t id = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= lines * p.row_groups) return;
  const int64_t g = id / lines;
  const int64_t line = id - g * lines;
  const int64_t o = line / p.inner;
  const int64_t i = line - o * p.inner;
  const int64_t s = p.inner;
  const int64_t base = o * p.n * s + i;
  int64_t a0, a1;
  row_run<int64_t>(p.n, p.row_groups, (int)g, &a0, &a1);
  writeback_rows<T, int64_t>(in + base, p.n, s, out + base, s, a0, a1, p);
}

// K2's writeback route, product form: Y = M X on a block of
// WB_ROWS output rows (a band) x WB_LINES lines, the lines grouped as the
// tile route groups them (WB_LINES consecutive i of one o, or, packed,
// floor(WB_LINES / inner) whole outers). The block walks k in chunks of
// WbChunk<T>::K: each chunk's columns of M (from M^T, so a chunk is
// contiguous rows) and rows of the lines are staged in shared memory by
// cp.async, double-buffered, zero-filled past the line's end (0 * 0 leaves
// a sum as it is). Thread (ty, tx) keeps a 4 x 4 register tile of sums,
// rows ty*4 .. +3 and lines tx*4 .. +3, and reads each chunk element's
// operands with 16-byte shared loads: 8 loads for 16 multiply-adds, where
// writeback_rows needs 5 loads (one of them of M from L1/L2) for 4. Every
// sum is still one chain over k ascending (fmaf, or __dmul_rn then
// __dadd_rn), so the product form equals writeback_rows and _row_sums bit
// for bit. Tensor cores (DMMA, wgmma) sum inside an instruction in an
// order of their own, which the integer writeback cannot take, so they are
// not used. With chunk runs (runs != null: the calls whose input is
// finite, ops/prefilter.py:writeback_chunk_runs), a band takes only the
// chunks of its two runs, skipping those where its rows of the table are
// exactly zero: fmaf(0, v, acc) and acc + 0 * v are acc for a finite v,
// and a sum that starts at +0 never becomes -0. The block's sums go through shared memory (cast there) and are
// stored a row of a band at a time along the lines, or, packed, along
// each outer's contiguous run: coalesced on every axis.
constexpr int WB_THREADS = 256;
constexpr int WB_ROWS = 64;    // a band: 16 thread rows x 4 sums
constexpr int WB_LINES = 64;   // 16 thread columns x 4 sums
constexpr int WB_XSTRIDE = WB_LINES + 4;  // a staged row of lines (16 B)
constexpr int WB_YSTRIDE = WB_LINES + 1;  // a row of the block's sums

template <typename T> struct WbChunk;
template <> struct WbChunk<float> { static constexpr int K = 32; };
template <> struct WbChunk<double> { static constexpr int K = 16; };

// the product form's geometry (ops/prefilter.py:_writeback_plan)
struct WbGeom {
  int64_t outer, n, inner;
  int packed;          // inner < WB_LINES: a block's lines are whole outers
  int64_t col_tiles;   // not packed: line tiles per outer
  int outers;          // packed: outers a tile, floor(WB_LINES / inner)
  int bands;           // ceil(n / WB_ROWS)
  int nchunks;         // ceil(n / K)
  int int_bits;
  double int_lo;
};

// the shared bytes of the product form: two chunks of M and of the lines;
// the block's sums reuse them
template <typename T>
constexpr int wb_smem() {
  return 2 * WbChunk<T>::K * (WB_ROWS + WB_XSTRIDE) * (int)sizeof(T);
}

// v[0..3] = p[0..3], 16-byte aligned, in 16-byte shared loads
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

template <typename T>
__global__ void __launch_bounds__(WB_THREADS, 2)
writeback_product_kernel(const T* __restrict__ in, T* __restrict__ out,
                         const T* __restrict__ mat_t,
                         const int4* __restrict__ runs, const WbGeom g) {
  constexpr int K = WbChunk<T>::K;
  constexpr int NX = K * WB_LINES / WB_THREADS;  // staged lines a thread
  constexpr int NM = K * WB_ROWS / WB_THREADS;   // staged table a thread
  extern __shared__ __align__(16) unsigned char ed_smem[];
  T* ms = reinterpret_cast<T*>(ed_smem);          // [2][K][WB_ROWS]
  T* xs = ms + 2 * K * WB_ROWS;                   // [2][K][WB_XSTRIDE]
  T* ys = ms;                                     // [WB_ROWS][WB_YSTRIDE]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t tile = blockIdx.x / g.bands;
  const int band = (int)(blockIdx.x - tile * g.bands);
  const int a0 = band * WB_ROWS;
  const int64_t n = g.n, inner = g.inner;
  // the tile's lines: line w's element k at in + first + off(w) + k*inner
  int64_t first;
  int width, outers = 0;
  if (g.packed) {
    const int64_t o0 = tile * g.outers;
    outers = (int)(g.outer - o0 < g.outers ? g.outer - o0 : g.outers);
    width = outers * (int)inner;
    first = o0 * n * inner;
  } else {
    const int64_t o = tile / g.col_tiles;
    const int64_t c0 = (tile - o * g.col_tiles) * WB_LINES;
    width = (int)(inner - c0 < WB_LINES ? inner - c0 : WB_LINES);
    first = o * n * inner + c0;
  }
  // this thread's share of a chunk of lines: element j at shared offset
  // xoff[j] (row kk = xoff / WB_XSTRIDE; -1: none) from in + first +
  // k0 * inner + xrel[j] (the plan keeps a tile's span within int32)
  int xrel[NX], xoff[NX];
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const int e = tid + j * WB_THREADS;
    if (g.packed) {
      const int run = K * (int)inner;
      const int ol = e / run, r = e - ol * run;
      const int kk = r / (int)inner, i = r - kk * (int)inner;
      xoff[j] = ol < outers ? kk * WB_XSTRIDE + ol * (int)inner + i : -1;
      xrel[j] = (int)(ol * n * inner) + r;
    } else {
      const int kk = e / WB_LINES, w = e % WB_LINES;
      xoff[j] = w < width ? kk * WB_XSTRIDE + w : -1;
      xrel[j] = kk * (int)inner + w;
    }
  }
  // the band's chunks: [r.x, r.y), then [r.z, r.w)
  const int4 r = runs ? runs[band] : make_int4(0, g.nchunks, 0, 0);
  const int count = r.y - r.x + r.w - r.z;
  auto chunk = [&](int q) {
    return q < r.y - r.x ? r.x + q : r.z + q - (r.y - r.x);
  };
  auto stage = [&](int c, int buf) {
    const int k0 = c * K;
    const T* src = in + first + (int64_t)k0 * inner;
    T* xb = xs + buf * K * WB_XSTRIDE;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      if (xoff[j] < 0) continue;
      const bool ok = k0 + xoff[j] / WB_XSTRIDE < n;
      stage_async_zfill(xb + xoff[j], ok ? src + xrel[j] : in, ok);
    }
    T* mb = ms + buf * K * WB_ROWS;
#pragma unroll
    for (int j = 0; j < NM; ++j) {
      const int e = tid + j * WB_THREADS;
      const int kk = e / WB_ROWS, a = e % WB_ROWS;
      const bool ok = k0 + kk < n && a0 + a < n;
      stage_async_zfill(mb + e, ok ? mat_t + (k0 + kk) * n + a0 + a : mat_t,
                        ok);
    }
    stage_commit();
  };

  T acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[r][l] = T(0);
  if (count > 0) stage(chunk(0), 0);
  for (int q = 0; q < count; ++q) {
    const int buf = q & 1;
    if (q + 1 < count) {
      stage(chunk(q + 1), buf ^ 1);
      stage_wait_group<1>();
    } else {
      stage_wait_group<0>();
    }
    __syncthreads();
    const T* mrow = ms + buf * K * WB_ROWS + ty * 4;
    const T* xrow = xs + buf * K * WB_XSTRIDE + tx * 4;
#pragma unroll 4
    for (int kk = 0; kk < K; ++kk) {
      T m[4], v[4];
      load4(mrow + kk * WB_ROWS, m);
      load4(xrow + kk * WB_XSTRIDE, v);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[r][l] = wb_step(m[r], v[l], acc[r][l]);
    }
    __syncthreads();
  }
  // the sums, cast, through shared memory
  const T lo = T(g.int_lo);
  const T span = T(ldexp(1.0, g.int_bits));
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int l = 0; l < 4; ++l)
      ys[(ty * 4 + r) * WB_YSTRIDE + tx * 4 + l] =
          wb_out(acc[r][l], g.int_bits, lo, span);
  __syncthreads();
  T* dst = out + first + (int64_t)a0 * inner;
  const int rows = n - a0 < WB_ROWS ? (int)(n - a0) : WB_ROWS;
  if (g.packed) {
    const int run = rows * (int)inner;
    for (int e = tid; e < outers * run; e += WB_THREADS) {
      const int ol = e / run, r = e - ol * run;
      const int kk = r / (int)inner, i = r - kk * (int)inner;
      dst[ol * n * inner + r] = ys[kk * WB_YSTRIDE + ol * (int)inner + i];
    }
  } else {
    for (int e = tid; e < rows * WB_LINES; e += WB_THREADS) {
      const int kk = e / WB_LINES, w = e % WB_LINES;
      if (w < width) dst[kk * inner + w] = ys[kk * WB_YSTRIDE + w];
    }
  }
}

// K7's stages after the copy: the exact transpose of prefilter_bc_kernel,
// equal with the gain (applied last by the caller) to
// filter_matrix_bc(n, order, bc).T: per pole in reverse order, the
// transposed anti-causal pass (as K4), its transposed initialisation, the
// transposed causal pass (as K4), the transposed causal initialisation.
// x is one line at stride s, as in k4_stages.
template <typename T, int BC, typename I>
__device__ __forceinline__ void k7_stages(T* x, const I n, const I s,
                                          const Params& p) {
#pragma unroll   // as in k4_stages
  for (int q = ED_MAXPOLES - 1; q >= 0; --q) {
    if (q >= p.npoles) continue;
    const double zd = p.pole[q], znd = p.zn[q];
    const T z = T(zd);
    const T zn = T(znd);
    // the anti-causal pass, transposed; u is row n-1's cotangent
    const T u = anticausal_t(x, n, s, z);
    // its initialisation row, transposed
    if (BC == BC_REFLECT) {
      x[(n - 1) * s] = u * T(zd / (zd - 1.0));
    } else {
      const T t = u * T(zd / (znd - 1.0));
      x[(n - 1) * s] = t;
      spread(x, s, I(0), I(1), n - 1, z, z, t);
    }
    causal_t(x, n, s, z);
    // causal initialisation, transposed: row 0 spreads over the line
    if (BC == BC_REFLECT) {
      const T t = x[0] * T(zd / (1.0 - znd * znd));
      T zi = T(1);
      reflect_pairs(x, n, s, I(0), n / 2, zi, z, zn, t);
      reflect_pairs(x, n, s, n / 2, (n + 1) / 2, zi, z, zn, t);
      reflect_pairs(x, n, s, (n + 1) / 2, n, zi, z, zn, t);
    } else {
      const T t = x[0] * T(1.0 / (1.0 - znd));
      x[0] = t;
      spread(x, s, n - 1, I(-1), n - 1, z, z, t);
    }
  }
}

// K7, lines route: one thread per line in device memory.
template <typename T, int BC>
__global__ void __launch_bounds__(256)
prefilter_bc_transpose_kernel(const T* __restrict__ in, T* __restrict__ out,
                              const Params p) {
  const int64_t line = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= p.outer * p.inner) return;
  const int64_t o = line / p.inner;
  const int64_t i0 = line - o * p.inner;
  const int64_t n = p.n;
  const int64_t s = p.inner;
  const T* src = in + o * n * s + i0;
  T* x = out + o * n * s + i0;

  for (int64_t k = 0; k < n; ++k) x[k * s] = src[k * s];
  if (n <= 1 || p.npoles == 0) return;
  k7_stages<T, BC, int64_t>(x, n, s, p);
  const T gain = T(p.gain);
  for (int64_t k = 0; k < n; ++k) x[k * s] = x[k * s] * gain;
}

// K2 (KIND TILE_K2), K4 (TILE_K4), K6 (TILE_K6_REFLECT or TILE_K6_WRAP)
// and K7 (BC_REFLECT or BC_WRAP), tile route: stage W lines in shared
// memory, run the stages there and store them: K2 and K6 raw (their stages
// apply the gain first), K4 and K7 with the gain. K2's writeback route
// (TILE_K2_WRITEBACK) stages the same lines and stores each row sum
// straight to device memory. At most 1024 / W blocks' worth of registers per
// SM are asked for (64 registers a thread), so that shared memory, not
// registers, limits how many blocks share an SM at the main path's line
// lengths.
template <typename T, int W, int KIND>
__global__ void __launch_bounds__(W, 1024 / W)
prefilter_tile_kernel(const T* __restrict__ in, T* __restrict__ out,
                      const Params p, const Tile t) {
  extern __shared__ __align__(16) unsigned char ed_smem[];
  T* tile = reinterpret_cast<T*>(ed_smem);
  const int n = (int)p.n;
  const int w = threadIdx.x;
  // K2's writeback route runs p.row_groups blocks on each tile, one run of
  // rows each
  const int64_t tile_id = KIND == TILE_K2_WRITEBACK
                              ? (int64_t)blockIdx.x / p.row_groups
                              : (int64_t)blockIdx.x;
  // K2's and K6's stages apply the gain themselves and are stored raw; K4
  // and K7 filter, then scale by the gain on the store
  constexpr bool raw = KIND == TILE_K2 || KIND == TILE_K6_REFLECT ||
                       KIND == TILE_K6_WRAP;
  const bool filter = n > 1 && p.npoles > 0 && !raw;
  const T gain = T(p.gain);
  const TileSpan sp = tile_span<W>(t, tile_id, p.outer, p.n, p.inner, w);
  const int64_t first = sp.first;
  const int outers = sp.outers, width = sp.width;
  const int inner = t.packed ? (int)p.inner : 0;
  stage_tile<T, W>(tile, in, t, sp, n, p.inner, w);
  stage_wait();
  __syncthreads();
  // line w: element k at x[k * s]
  T* x = t.packed ? tile + (w / inner) * t.stride + w % inner : tile + w;
  const int s = t.packed ? inner : t.stride;
  if constexpr (KIND == TILE_K2_WRITEBACK) {
    // each row sum goes straight to device memory: no store phase
    if (w < width) {
      T* dst = out + first +
               (t.packed ? (int64_t)(w / inner) * n * inner + w % inner : 0);
      int a0, a1;
      row_run<int>(n, p.row_groups,
                   (int)(blockIdx.x - tile_id * p.row_groups), &a0, &a1);
      writeback_rows<T, int>(x, n, s, dst, p.inner, a0, a1, p);
    }
  } else {
    if ((filter || raw) && w < width) {
      if constexpr (KIND == TILE_K2)
        k2_stages<T, int>(x, n, s, p);
      else if constexpr (KIND == TILE_K4)
        k4_stages<T, int>(x, n, s, p);
      else if constexpr (KIND == TILE_K6_REFLECT)
        k6_stages<T, BC_REFLECT, int>(x, n, s, p);
      else if constexpr (KIND == TILE_K6_WRAP)
        k6_stages<T, BC_WRAP, int>(x, n, s, p);
      else
        k7_stages<T, KIND, int>(x, n, s, p);
    }
    __syncthreads();
    if (t.packed) {
      T* dst = out + first;
      packed_walk<W>(t, n * inner, outers, w, [&](int e, int sh) {
        dst[e] = filter ? tile[sh] * gain : tile[sh];
      });
    } else if (w < width) {
      T* dst = out + first;
      for (int k = 0; k < n; ++k, dst += p.inner) {
        const T v = tile[k * t.stride + w];
        *dst = filter ? v * gain : v;
      }
    }
  }
}

template <typename T, int BC, bool TRANSPOSE>
cudaError_t launch_bc(const void* in, void* out, const Params& p,
                      cudaStream_t stream) {
  const int64_t lines = p.outer * p.inner;
  if (lines == 0 || p.n == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (lines + threads - 1) / threads;
  if (TRANSPOSE)
    prefilter_bc_transpose_kernel<T, BC>
        <<<(unsigned)blocks, threads, 0, stream>>>(
            static_cast<const T*>(in), static_cast<T*>(out), p);
  else
    prefilter_bc_kernel<T, BC><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <bool TRANSPOSE>
cudaError_t dispatch_bc(int dtype, int bc, const void* in, void* out,
                        const Params& p, cudaStream_t s) {
  if (dtype == 0 && bc == BC_REFLECT)
    return launch_bc<float, BC_REFLECT, TRANSPOSE>(in, out, p, s);
  if (dtype == 0 && bc == BC_WRAP)
    return launch_bc<float, BC_WRAP, TRANSPOSE>(in, out, p, s);
  if (dtype == 1 && bc == BC_REFLECT)
    return launch_bc<double, BC_REFLECT, TRANSPOSE>(in, out, p, s);
  if (dtype == 1 && bc == BC_WRAP)
    return launch_bc<double, BC_WRAP, TRANSPOSE>(in, out, p, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_writeback(const void* in, void* out, const Params& p,
                             cudaStream_t stream) {
  const int64_t lines = p.outer * p.inner * p.row_groups;
  if (lines == 0 || p.n == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (lines + threads - 1) / threads;
  prefilter_writeback_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_product(const void* in, void* out, const void* mat_t,
                           const int4* runs, const WbGeom& g,
                           int64_t blocks, cudaStream_t stream) {
  writeback_product_kernel<T>
      <<<(unsigned)blocks, WB_THREADS, wb_smem<T>(), stream>>>(
          static_cast<const T*>(in), static_cast<T*>(out),
          static_cast<const T*>(mat_t), runs, g);
  return cudaGetLastError();
}

// The product form's geometry from the shape, as
// ops/prefilter.py:_writeback_plan computes it; false where a block's span
// of lines leaves int32 or the grid holds 2^31 blocks or more.
bool make_wb_geom(WbGeom* g, int chunk, long long outer, long long n,
                  long long inner, int int_bits, double int_lo,
                  long long blocks) {
  if (outer < 1 || n < 1 || inner < 1 || n > 0x7fffffffLL) return false;
  g->outer = outer;
  g->n = n;
  g->inner = inner;
  g->packed = inner < WB_LINES;
  g->bands = (int)((n + WB_ROWS - 1) / WB_ROWS);
  g->nchunks = (int)((n + chunk - 1) / chunk);
  g->int_bits = int_bits;
  g->int_lo = int_lo;
  int64_t tiles, span;
  if (g->packed) {
    g->outers = (int)(WB_LINES / inner);
    g->col_tiles = 0;
    tiles = (outer + g->outers - 1) / g->outers;
    span = (int64_t)g->outers * n * inner;
  } else {
    g->outers = 0;
    g->col_tiles = (inner + WB_LINES - 1) / WB_LINES;
    tiles = outer * g->col_tiles;
    span = (int64_t)chunk * inner + WB_LINES;
  }
  return span <= 0x7fffffffLL && blocks == tiles * g->bands &&
         blocks <= 0x7fffffffLL;
}

template <typename T, bool TRANSPOSE>
cudaError_t launch(const void* in, void* out, const Params& p,
                   cudaStream_t stream) {
  const int64_t lines = p.outer * p.inner;
  if (lines == 0 || p.n == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (lines + threads - 1) / threads;
  if (TRANSPOSE)
    prefilter_transpose_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), p);
  else
    prefilter_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), p);
  return cudaGetLastError();
}

// the shared memory a block may use on the H100 (227 KB)
constexpr int kSmemLimit = 232448;

// Launches the tile kernel <T, W, KIND>, or, when occupancy is not null,
// only writes how many of its blocks one SM holds at smem bytes each.
template <typename T, int W, int KIND>
cudaError_t launch_tile_w(const void* in, void* out, const Params& p,
                          const Tile& t, int smem, int64_t blocks,
                          cudaStream_t stream, int* occupancy) {
  auto kern = prefilter_tile_kernel<T, W, KIND>;
  if (smem > 48 * 1024 || occupancy) {
    // above 48 KB a launch is refused unless the kernel asks for it
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        occupancy ? kSmemLimit : smem);
    if (err != cudaSuccess) return err;
  }
  if (occupancy)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kern, W,
                                                         (size_t)smem);
  kern<<<(unsigned)blocks, W, (size_t)smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), p, t);
  return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t launch_tile_k(int width, const void* in, void* out,
                          const Params& p, const Tile& t, int smem,
                          int64_t blocks, cudaStream_t s, int* occ) {
  if (width == 32)
    return launch_tile_w<T, 32, KIND>(in, out, p, t, smem, blocks, s, occ);
  if (width == 64)
    return launch_tile_w<T, 64, KIND>(in, out, p, t, smem, blocks, s, occ);
  if (width == 128)
    return launch_tile_w<T, 128, KIND>(in, out, p, t, smem, blocks, s, occ);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_tile_t(int kind, int width, const void* in, void* out,
                          const Params& p, const Tile& t, int smem,
                          int64_t blocks, cudaStream_t s, int* occ) {
  if (kind == TILE_K4)
    return launch_tile_k<T, TILE_K4>(width, in, out, p, t, smem, blocks, s,
                                     occ);
  if (kind == TILE_K2)
    return launch_tile_k<T, TILE_K2>(width, in, out, p, t, smem, blocks, s,
                                     occ);
  if (kind == BC_REFLECT)
    return launch_tile_k<T, BC_REFLECT>(width, in, out, p, t, smem, blocks,
                                        s, occ);
  if (kind == BC_WRAP)
    return launch_tile_k<T, BC_WRAP>(width, in, out, p, t, smem, blocks, s,
                                     occ);
  if (kind == TILE_K6_REFLECT)
    return launch_tile_k<T, TILE_K6_REFLECT>(width, in, out, p, t, smem,
                                             blocks, s, occ);
  if (kind == TILE_K6_WRAP)
    return launch_tile_k<T, TILE_K6_WRAP>(width, in, out, p, t, smem, blocks,
                                          s, occ);
  if (kind == TILE_K2_WRITEBACK)
    return launch_tile_k<T, TILE_K2_WRITEBACK>(width, in, out, p, t, smem,
                                               blocks, s, occ);
  return cudaErrorInvalidValue;
}

cudaError_t launch_tile(int dtype, int kind, int width, const void* in,
                        void* out, const Params& p, const Tile& t, int smem,
                        int64_t blocks, cudaStream_t s, int* occ) {
  if (dtype == 0)
    return launch_tile_t<float>(kind, width, in, out, p, t, smem, blocks, s,
                                occ);
  if (dtype == 1)
    return launch_tile_t<double>(kind, width, in, out, p, t, smem, blocks,
                                 s, occ);
  return cudaErrorInvalidValue;
}

bool make_params(Params* p, long long outer, long long n, long long inner,
                 int npoles, const double* poles, const int* horizons,
                 const double* pn1, const double* denom, double gain) {
  if (npoles < 0 || npoles > ED_MAXPOLES) return false;
  p->outer = outer;
  p->n = n;
  p->inner = inner;
  p->npoles = npoles;
  for (int q = 0; q < ED_MAXPOLES; ++q) {
    const bool used = q < npoles;
    p->pole[q] = used ? poles[q] : 0.0;
    // the mirror terms are absent (null) for K6 and K7
    p->horizon[q] = used && horizons ? horizons[q] : 0;
    p->pn1[q] = used && pn1 ? pn1[q] : 0.0;
    p->denom[q] = used && denom ? denom[q] : 1.0;
    p->zn[q] = used ? pow(poles[q], (double)n) : 0.0;
  }
  p->gain = gain;
  p->int_bits = 0;
  p->int_lo = 0.0;
  p->mat = nullptr;
  p->row_groups = 1;
  return true;
}

}  // namespace

extern "C" {

// K2 on the lines route. dtype: 0 float32, 1 float64.
// poles/horizons/pn1/denom: npoles each (host-computed in float64). in and
// out must not overlap. Returns cudaGetLastError().
int ed_spline_prefilter(int dtype, const void* in, void* out, long long outer,
                        long long n, long long inner, int npoles,
                        const double* poles, const int* horizons,
                        const double* pn1, const double* denom, double gain,
                        void* stream) {
  Params p;
  if (!make_params(&p, outer, n, inner, npoles, poles, horizons, pn1, denom,
                   gain))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? launch<float, false>(in, out, p, s)
                    : dtype == 1 ? launch<double, false>(in, out, p, s)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

// K4 on the lines route, the transpose of ed_spline_prefilter's filter;
// the same arguments. Returns cudaGetLastError().
int ed_spline_prefilter_transpose(int dtype, const void* in, void* out,
                                  long long outer, long long n,
                                  long long inner, int npoles,
                                  const double* poles, const int* horizons,
                                  const double* pn1, const double* denom,
                                  double gain, void* stream) {
  Params p;
  if (!make_params(&p, outer, n, inner, npoles, poles, horizons, pn1, denom,
                   gain))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? launch<float, true>(in, out, p, s)
                    : dtype == 1 ? launch<double, true>(in, out, p, s)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

// K6 (transpose = 0) and K7 on the lines route (transpose = 1): the filter
// and its transpose under boundary condition bc (1 reflect, 2 wrap).
// poles: npoles, host float64. in and out must not overlap. Returns
// cudaGetLastError().
int ed_spline_prefilter_bc(int dtype, int bc, int transpose, const void* in,
                           void* out, long long outer, long long n,
                           long long inner, int npoles, const double* poles,
                           double gain, void* stream) {
  Params p;
  if (!make_params(&p, outer, n, inner, npoles, poles, nullptr, nullptr,
                   nullptr, gain))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = transpose ? dispatch_bc<true>(dtype, bc, in, out, p, s)
                              : dispatch_bc<false>(dtype, bc, in, out, p, s);
  return (int)err;
}

// K2 (kind 3) and K4 (kind 0), the mirror terms given, and K7 (kind 1
// reflect, 2 wrap) and K6 (kind 4 reflect, 5 wrap), horizons, pn1 and denom
// null, on the tile route, with the plan of ops/prefilter.py:_tile_plan:
// width W threads and lines a block, packed (inner < W), lines per full
// tile, shared row stride, shared bytes, blocks. A plan that does not fit
// the shape, or another kind, is refused with cudaErrorInvalidValue. in
// and out must not overlap. Returns cudaGetLastError().
int ed_spline_prefilter_tile(
    int dtype, int kind, const void* in, void* out, long long outer,
    long long n, long long inner, int npoles, const double* poles,
    const int* horizons, const double* pn1, const double* denom, double gain,
    int width, int packed, int lines, int stride, int smem, long long blocks,
    void* stream) {
  if (outer * inner == 0 || n == 0) return (int)cudaSuccess;
  Params p;
  Tile t;
  const int itemsize = dtype == 0 ? 4 : 8;
  const bool mirror = kind == TILE_K4 || kind == TILE_K2;
  if (kind < TILE_K4 || kind > TILE_K6_WRAP ||
      (mirror && (!horizons || !pn1 || !denom)) ||
      !make_params(&p, outer, n, inner, npoles, poles, horizons, pn1, denom,
                   gain) ||
      !make_tile(&t, itemsize, outer, n, inner, width, packed, lines, stride,
                 smem, blocks, kSmemLimit))
    return (int)cudaErrorInvalidValue;
  return (int)launch_tile(dtype, kind, width, in, out, p, t, smem, blocks,
                          static_cast<cudaStream_t>(stream), nullptr);
}

// K2's writeback route: each output the row sum of mat (filter_matrix(n),
// or filter_matrix_bc(n) for K6's, as n x n row-major T on the card) in
// the fixed order above, truncated and wrapped to int_bits bits from
// int_lo (iinfo.min), or with int_bits 0 stored as it is, the rows of each
// line split into row_groups runs. width 0: the lines form (a thread per
// line and run, blocks of 256); else the tile form with the plan's
// geometry, as for ed_spline_prefilter_tile, row_groups blocks on each
// tile. in and out must not overlap. Returns cudaGetLastError().
int ed_spline_prefilter_writeback(
    int dtype, const void* in, void* out, const void* mat, long long outer,
    long long n, long long inner, int int_bits, double int_lo,
    int row_groups, int width, int packed, int lines, int stride, int smem,
    long long blocks, void* stream) {
  if (outer * inner == 0 || n == 0) return (int)cudaSuccess;
  Params p;
  if (!mat || int_bits < 0 || int_bits > 64 || row_groups < 1 ||
      !make_params(&p, outer, n, inner, 0, nullptr, nullptr, nullptr,
                   nullptr, 1.0))
    return (int)cudaErrorInvalidValue;
  p.int_bits = int_bits;
  p.int_lo = int_lo;
  p.mat = mat;
  p.row_groups = row_groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 0)
    return (int)(dtype == 0   ? launch_writeback<float>(in, out, p, s)
                 : dtype == 1 ? launch_writeback<double>(in, out, p, s)
                              : cudaErrorInvalidValue);
  Tile t;
  if (!make_tile(&t, dtype == 0 ? 4 : 8, outer, n, inner, width, packed,
                 lines, stride, smem, blocks, kSmemLimit) ||
      blocks * row_groups > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return (int)launch_tile(dtype, TILE_K2_WRITEBACK, width, in, out, p, t,
                          smem, blocks * row_groups, s, nullptr);
}

// K2's writeback route in its product form (writeback_product_kernel):
// each output the row sum of the n x n table whose transpose mat_t is (in
// T on the card: filter_matrix(n), or filter_matrix_bc(n) for K6's), in
// the fixed order above, then the cast of ed_spline_prefilter_writeback.
// runs: null (every chunk of k), or per band of WB_ROWS rows four ints,
// its two runs of chunks [x, y) and [z, w) in ascending order (chunks of
// 32 k in float32, 16 in float64, 16-byte aligned): a band skips the rest,
// where its rows of the table are exactly zero (finite inputs only).
// blocks: the plan's, line tiles times bands. in and out must not
// overlap. Returns cudaGetLastError().
int ed_spline_prefilter_writeback_product(
    int dtype, const void* in, void* out, const void* mat_t,
    const void* runs, long long outer, long long n, long long inner,
    int int_bits, double int_lo, long long blocks, void* stream) {
  if (outer * inner == 0 || n == 0) return (int)cudaSuccess;
  WbGeom g;
  const int chunk = dtype == 0 ? WbChunk<float>::K : WbChunk<double>::K;
  if (!mat_t || (dtype != 0 && dtype != 1) || int_bits < 0 ||
      int_bits > 64 ||
      !make_wb_geom(&g, chunk, outer, n, inner, int_bits, int_lo, blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* c = static_cast<const int4*>(runs);
  return (int)(dtype == 0
                   ? launch_product<float>(in, out, mat_t, c, g, blocks, s)
                   : launch_product<double>(in, out, mat_t, c, g, blocks,
                                            s));
}

// Blocks of the tile kernel (dtype; kind as for ed_spline_prefilter_tile,
// or 6 for K2's writeback route; width) that one SM holds at smem bytes of
// shared memory each (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a
// negative CUDA error code on failure.
int ed_prefilter_tile_blocks_per_sm(int dtype, int kind, int width,
                                    int smem) {
  Params p{};
  Tile t{};
  int blocks = 0;
  const cudaError_t err = launch_tile(dtype, kind, width, nullptr, nullptr,
                                      p, t, smem, 0, nullptr, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

const char* ed_prefilter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
