// K10 min_max_filter1d, K11 min_max_filter, K12 rank_filter and K13
// binary_step: the ndimage order-statistic and morphology tier (SciPy's
// minimum/maximum filters, grey and binary morphology, rank, median and
// percentile filters).
//
// K10 replaces the JAX package's elasticdeform_tpu/ops/morphology.py:119
// min_max_filter1d (a fold pad, then lax.reduce_window): the min or max of
// `size` samples along one axis, out[i] = reduce_k x[fold(i + k - c)], of a
// contiguous tensor viewed as (outer, n, inner), the five filter modes folded
// here (no padded copy), cval for a constant-mode sample beyond the edge.
// min_max_filter (:176-192) runs it once per axis of a separable box. Two
// routes, picked on the host by ops/morphology.py:_box_plan: box (every
// pass of a box with extent > 1 on one to three axes in one launch:
// min_max_box_kernel stages a tile's halo box once, each axis folded by its
// own mode, and runs the passes in shared memory, so a box reads the array
// once and writes it once) and lines (min_max_1d_kernel, a launch a pass,
// for the rest); both take each window in the same order, bit for bit.
//
// K11 replaces morphology.py:196-230, the tap loop of min_max_filter: the min
// or max over an N-D footprint's taps (raster order), for a non-flat structure
// of x - s[t] (erosion) or x + s[t] (dilation) in the work type, which is x's
// for floats and float64 for integers and bool; the float64 result is then
// cast as XLA casts it: NaN to 0, truncated, saturated at the type's range
// (bool: != 0). Two routes, picked on the host by
// ops/morphology.py:_min_max_plan: tile (extent > 1 on at most three axes,
// a box within the shared-memory budget: min_max_tile_kernel stages a
// tile's halo box in the work type once, on K12's select tile's geometry,
// and reduces from shared memory) and nd (min_max_nd_kernel, one thread per
// voxel reading device memory at every tap, for the rest); both take the
// taps in raster order, so they agree bit for bit.
//
// K12 replaces morphology.py:302-321 _rank_select and :373 jnp.sort: the
// rank-th smallest footprint tap. Up to 64 taps it runs a Batcher comparator
// network over wires padded at the type's largest value, each comparator a
// NaN-propagating min/max pair, so a window holding a NaN gives NaN; above
// 64 taps a radix select over order-preserving keys orders NaN last and -0
// as +0, and picks among equal keys in tap order, as the stable sort does.
// The cap is kept because it decides the NaN result. Each takes one of two
// routes, picked on the host by ops/morphology.py:_rank_plan. The network:
// network_tile (3-64 taps, extent > 1 on at most three axes, a box within
// the shared-memory budget: rank_network_tile_kernel stages a tile's halo
// box of values once, each thread runs the whole comparator list at
// compile-time wire indices on integer keys held in registers) and network
// (rank_network_kernel, the pruned list of _rank_network read from device
// memory, wires in local memory, one thread per voxel, for the rest). The
// select: tile (rank_select_tile_kernel stages a tile's halo box of keys
// and values once and selects from shared memory, several key bits a pass)
// and nd (rank_select_kernel, one thread per voxel reading device memory at
// every bit, for the rest).
//
// K13 replaces morphology.py:452-515, _binary_step under fori_loop /
// while_loop: one AND (erosion) or OR (dilation) sweep of a boolean array over
// the structure's taps, border_value beyond the edge, mask-gated (a voxel
// outside the mask keeps its value); it sets *changed when a voxel changed.
// The caller iterates it (Jacobi: each sweep reads the previous array) and
// reads the flag every few sweeps: a fixpoint is absorbing. Two routes:
//
//   tile  (1-3 axes, a reach of at most 32 voxels along the innermost axis):
//         binary_tile_kernel. The state is bit-packed, 32 voxels of a line to
//         a uint32 word (bit j of word w is voxel 32 w + j; the pad bits past
//         a line's end hold border_value and never change). A block owns a
//         tile of words and runs k sweeps on a shared-memory box: the tile
//         plus k reaches on each side (clamped to the array; beyond it every
//         read is border_value), staged once, then ping-ponged between two
//         buffers, the computed region shrinking by one reach a sweep until
//         the last sweep computes the tile alone. A tap is a funnel shift of
//         a row's three neighbouring words, then an AND or OR; the gate (mask
//         AND the line's valid bits) keeps the rest. The flag is set when the
//         last sweep changed a voxel of the tile, which is what a caller that
//         zeroes it before that sweep reads. The state comes either as packed
//         words (binary_pack_kernel packs once, binary_unpack_kernel unpacks
//         at the end; the fixpoint driver's route) or as bool bytes, packed in
//         shared memory by warp ballots and unpacked on the way out (the
//         public single sweep). At 160x192x224 the packed state is 860 KB
//         and lives in L2: a sweep costs bit operations, not bytes.
//   nd    (4-8 axes, or a reach the box cannot hold): K11's kernel on bool
//         (AND is min, OR is max, border_value the cval) with the gate, the
//         flag and an exit at the first deciding tap, one sweep a launch.
//
// Min and max propagate NaN and order -0 below +0 as jnp.minimum /
// jnp.maximum do: the comparison is written out, never fminf / fmaxf, which
// return the other operand of a NaN.
//
// Layout and bound on the H100: one thread per output element, neighbouring
// threads on neighbouring addresses (the innermost index), so every tap's
// loads coalesce; the taps' reuse is served by L1. Interior elements (every
// tap inside the array) take a path with no fold. K10, K11 and K13 are bound
// by bytes (each input read once, each output written once over 3.35 TB/s;
// K10's box route once for the whole box, its lines route once a pass);
// K12 by the comparisons a selection of that rank needs per voxel
// (quickselect's expected count, about 3.4 per tap for a median) at the
// card's operation rate, or by bytes, whichever is larger. K13's tile route
// is bound by the bytes of the whole call (the input, mask and output read or
// written once), not per sweep: its sweeps run out of shared memory and L2.
// Selections copy values, so every kernel agrees with its plain twin
// (ops/morphology.py) bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <type_traits>
#include <utility>

#include "cp_async.cuh"

#define ED_MORPH_MAXR 8
#define ED_THREADS 256
#define ED_MAX_WIRES 64
#define ED_BIN_THREADS 1024
#define ED_PACK_THREADS 256
#define ED_BIN_MAX_TAPS 1024
#define ED_BIN_MAX_SWEEPS 8
#define ED_SMEM_LIMIT 232448
// K12's select route on a halo box: blocks of ED_RANK_TY x ED_RANK_TX
// threads, each with a column of C voxels along tile axis 0; key bits
// resolved a pass (the fastest of 1-4 at c15's shapes on an H100)
#define ED_RANK_TY 8
#define ED_RANK_TX 32
#define ED_RANK_BITS 2
// K11's tile route: the same blocks, a column of ED_MINMAX_COLUMN voxels a
// thread (1 where tile axis 0 has extent 1)
#define ED_MINMAX_COLUMN 8
// the box rows a warp of K11's and K12's tiles loads before it stores
#define ED_STAGE_ROWS 4
// K12's network tile: the comparators of 64 wires, and the voxels a thread
// keeps along tile axis 0 (1 where tile axis 0 has extent 1)
#define ED_NET_MAX_PAIRS 543
#define ED_NET_COLUMN 4

namespace {

enum { F_NEAREST = 0, F_WRAP = 1, F_REFLECT = 2, F_MIRROR = 3, F_CONSTANT = 4 };

// index j folded into [0, n) by the filter mode (ops/filters.py
// _fold_index); -1 for a sample beyond the edge in constant mode. I is
// int64_t, or int where j and 2n lie within int32 (the tile route's box)
template <typename I>
__device__ __forceinline__ I fold(I j, I n, int mode) {
  if (j >= 0 && j < n) return j;
  switch (mode) {
    case F_NEAREST:
      return j < 0 ? 0 : n - 1;
    case F_WRAP: {
      const I m = j % n;
      return m < 0 ? m + n : m;
    }
    case F_REFLECT: {
      const I per = 2 * n;
      I m = j % per;
      if (m < 0) m += per;
      return m < n ? m : per - 1 - m;
    }
    case F_MIRROR: {
      if (n == 1) return 0;
      const I per = 2 * n - 2;
      I m = j % per;
      if (m < 0) m += per;
      return m < n ? m : per - m;
    }
    default:
      return -1;
  }
}

// jnp.minimum / jnp.maximum: a NaN operand gives NaN, and -0 counts as
// less than +0
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) {
    if (a != a) return a;
    if (b != b) return b;
    if (a == b) return signbit(a) ? a : b;
  }
  return b < a ? b : a;
}

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) {
    if (a != a) return a;
    if (b != b) return b;
    if (a == b) return signbit(a) ? b : a;
  }
  return a < b ? b : a;
}

template <bool MIN, typename T>
__device__ __forceinline__ T pick(T a, T b) {
  return MIN ? nan_min(a, b) : nan_max(a, b);
}

// the range XLA's float -> integer convert saturates at
template <typename T> struct IntRange;
#define ED_RANGE(T, LO, HI)                   \
  template <> struct IntRange<T> {            \
    static constexpr T lo = LO, hi = HI;      \
  };
ED_RANGE(uint8_t, 0, UINT8_MAX)
ED_RANGE(int8_t, INT8_MIN, INT8_MAX)
ED_RANGE(uint16_t, 0, UINT16_MAX)
ED_RANGE(int16_t, INT16_MIN, INT16_MAX)
ED_RANGE(uint32_t, 0, UINT32_MAX)
ED_RANGE(int32_t, INT32_MIN, INT32_MAX)
ED_RANGE(uint64_t, 0, UINT64_MAX)
ED_RANGE(int64_t, INT64_MIN, INT64_MAX)
#undef ED_RANGE

// NaN to 0, truncate, saturate; (double)hi rounds up to 2^63 / 2^64 for the
// 64-bit types, so every value below it converts exactly
template <typename T>
__device__ __forceinline__ T saturate(double a) {
  if (a != a) return T(0);
  a = trunc(a);
  if (a <= (double)IntRange<T>::lo) return IntRange<T>::lo;
  if (a >= (double)IntRange<T>::hi) return IntRange<T>::hi;
  return (T)a;
}

// the work-type result cast to the output type
template <typename T, typename W>
__device__ __forceinline__ T finish(W a) {
  if constexpr (std::is_same<T, W>::value)
    return a;
  else if constexpr (std::is_same<T, bool>::value)
    return a != W(0);
  else
    return saturate<T>((double)a);
}

// ---------------------------------------------------------------------------
// K10

struct Line {
  int64_t outer, n, inner;
  int size, center, mode;
};

template <typename T, bool MIN>
__global__ void __launch_bounds__(ED_THREADS)
min_max_1d_kernel(const T* __restrict__ x, T* __restrict__ out, const Line p,
                  const T cval) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per_outer = p.n * p.inner;
  if (e >= p.outer * per_outer) return;
  const int64_t o = e / per_outer;
  const int64_t r = e - o * per_outer;
  const int64_t i = r / p.inner;
  const int64_t q = r - i * p.inner;
  const int64_t s = p.inner;
  const T* line = x + o * per_outer + q;
  const int64_t j0 = i - p.center;
  T acc = cval;
  if (j0 >= 0 && j0 + p.size <= p.n) {
    const T* base = line + j0 * s;
    acc = base[0];
    for (int k = 1; k < p.size; ++k) acc = pick<MIN>(acc, base[k * s]);
  } else {
    for (int k = 0; k < p.size; ++k) {
      const int64_t f = fold<int64_t>(j0 + k, p.n, p.mode);
      const T v = f < 0 ? cval : line[f * s];
      acc = k == 0 ? v : pick<MIN>(acc, v);
    }
  }
  out[e] = acc;
}

// ---------------------------------------------------------------------------
// the N-D footprint geometry of K11, K12 and K13

struct Nd {
  int ndim, taps, mode;
  int64_t total;
  int64_t n[ED_MORPH_MAXR], stride[ED_MORPH_MAXR];
  int lo[ED_MORPH_MAXR], hi[ED_MORPH_MAXR];  // least, greatest tap offset
};

__device__ __forceinline__ void unravel(int64_t e, const Nd& p,
                                        int64_t* idx) {
#pragma unroll
  for (int d = ED_MORPH_MAXR - 1; d >= 0; --d) {
    if (d < p.ndim) {
      const int64_t qd = e / p.n[d];
      idx[d] = e - qd * p.n[d];
      e = qd;
    } else {
      idx[d] = 0;
    }
  }
}

// true when every tap of the element lies inside the array
__device__ __forceinline__ bool interior(const int64_t* idx, const Nd& p) {
  bool in = true;
#pragma unroll
  for (int d = 0; d < ED_MORPH_MAXR; ++d)
    if (d < p.ndim && (idx[d] + p.lo[d] < 0 || idx[d] + p.hi[d] >= p.n[d]))
      in = false;
  return in;
}

// the address tap t of element e reads (off[t * ndim + d]: its offset along
// axis d, delta[t]: the same as a linear offset), or -1 beyond the edge in
// constant mode
__device__ __forceinline__ int64_t tap_address(
    int64_t e, const int64_t* idx, bool in, int t, const int* __restrict__ off,
    const int64_t* __restrict__ delta, const Nd& p) {
  if (in) return e + delta[t];
  int64_t a = 0;
#pragma unroll
  for (int d = 0; d < ED_MORPH_MAXR; ++d) {
    if (d < p.ndim) {
      const int64_t f =
          fold<int64_t>(idx[d] + off[t * p.ndim + d], p.n[d], p.mode);
      if (f < 0) return -1;
      a += f * p.stride[d];
    }
  }
  return a;
}

template <typename T, typename W>
__device__ __forceinline__ W tap_value(const T* __restrict__ x, int64_t e,
                                       const int64_t* idx, bool in, int t,
                                       const int* __restrict__ off,
                                       const int64_t* __restrict__ delta,
                                       const Nd& p, W cval) {
  const int64_t a = tap_address(e, idx, in, t, off, delta, p);
  return a < 0 ? cval : W(x[a]);
}

// ---------------------------------------------------------------------------
// K11, and K13 (BINARY: T and W bool, flat)

template <typename T, typename W, bool MIN, bool NONFLAT, bool BINARY>
__global__ void __launch_bounds__(ED_THREADS)
min_max_nd_kernel(const T* __restrict__ x, T* __restrict__ out,
                  const int* __restrict__ off,
                  const int64_t* __restrict__ delta,
                  const W* __restrict__ sval, const Nd p, const W cval,
                  const bool* __restrict__ mask, int* changed) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.total) return;
  int64_t idx[ED_MORPH_MAXR];
  unravel(e, p, idx);
  const bool in = interior(idx, p);
  // BINARY: no tap gives the empty conjunction (true) or disjunction (false)
  W acc = BINARY ? W(MIN) : cval;
  for (int t = 0; t < p.taps; ++t) {
    W v = tap_value<T, W>(x, e, idx, in, t, off, delta, p, cval);
    if constexpr (NONFLAT) v = MIN ? v - sval[t] : v + sval[t];
    acc = t == 0 ? v : pick<MIN>(acc, v);
    if constexpr (BINARY)
      if (acc != W(MIN)) break;  // a false tap decides an AND, a true an OR
  }
  if constexpr (BINARY) {
    const bool old = x[e];
    if (mask != nullptr && !mask[e]) acc = old;
    out[e] = acc;
    if (changed != nullptr && acc != old) *changed = 1;
  } else {
    out[e] = finish<T, W>(acc);
  }
}

// ---------------------------------------------------------------------------
// K12

// the network route: wires[0, taps) the taps, [taps, wires) pad; comparator
// c sends min(w[i], w[j]) to w[i] and the max to w[j], i = pairs[2c],
// j = pairs[2c + 1]
template <typename T>
__global__ void __launch_bounds__(ED_THREADS)
rank_network_kernel(const T* __restrict__ x, T* __restrict__ out,
                    const int* __restrict__ off,
                    const int64_t* __restrict__ delta,
                    const uint8_t* __restrict__ pairs, int npairs, int wires,
                    int rank, const T pad, const Nd p, const T cval) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.total) return;
  int64_t idx[ED_MORPH_MAXR];
  unravel(e, p, idx);
  const bool in = interior(idx, p);
  T w[ED_MAX_WIRES];
  for (int t = 0; t < p.taps; ++t)
    w[t] = tap_value<T, T>(x, e, idx, in, t, off, delta, p, cval);
  for (int t = p.taps; t < wires; ++t) w[t] = pad;
  for (int c = 0; c < npairs; ++c) {
    const int i = pairs[2 * c], j = pairs[2 * c + 1];
    const T a = w[i], b = w[j];
    w[i] = nan_min(a, b);
    w[j] = nan_max(a, b);
  }
  out[e] = w[rank];
}

// order-preserving unsigned keys in the sort's order: -0 and +0 share a key
// and every NaN maps to the largest key (NaN last), as jnp.sort compares
template <typename T> struct Key;
template <> struct Key<bool> {
  typedef uint8_t K;
  __device__ static K of(bool v) { return v ? 1 : 0; }
};
#define ED_UKEY(T)                                      \
  template <> struct Key<T> {                           \
    typedef T K;                                        \
    __device__ static K of(T v) { return v; }           \
  };
#define ED_SKEY(T, U)                                                   \
  template <> struct Key<T> {                                           \
    typedef U K;                                                        \
    static constexpr U sign = (U)((U)1 << (8 * sizeof(U) - 1));         \
    __device__ static K of(T v) { return (U)((U)v ^ sign); }            \
  };
ED_UKEY(uint8_t)
ED_UKEY(uint16_t)
ED_UKEY(uint32_t)
ED_UKEY(uint64_t)
ED_SKEY(int8_t, uint8_t)
ED_SKEY(int16_t, uint16_t)
ED_SKEY(int32_t, uint32_t)
ED_SKEY(int64_t, uint64_t)
#undef ED_UKEY
#undef ED_SKEY
template <> struct Key<float> {
  typedef uint32_t K;
  __device__ static K of(float v) {
    if (v != v) return 0xFFFFFFFFu;
    const uint32_t b = v == 0.0f ? 0u : __float_as_uint(v);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
};
template <> struct Key<double> {
  typedef uint64_t K;
  __device__ static K of(double v) {
    if (v != v) return 0xFFFFFFFFFFFFFFFFull;
    const uint64_t b = v == 0.0 ? 0ull : (uint64_t)__double_as_longlong(v);
    return (b & 0x8000000000000000ull) ? ~b : (b | 0x8000000000000000ull);
  }
};

// the select route: the rank-th smallest key, one bit at a time from the top
// (per bit, count the taps that match the prefix so far with a 0 there);
// what is left of the rank then picks among the taps of that key in tap
// order, as the stable sort does, so a zero keeps its sign and a NaN its bits
template <typename T>
__global__ void __launch_bounds__(ED_THREADS)
rank_select_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const int* __restrict__ off,
                   const int64_t* __restrict__ delta, int rank, const Nd p,
                   const T cval) {
  typedef typename Key<T>::K K;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.total) return;
  int64_t idx[ED_MORPH_MAXR];
  unravel(e, p, idx);
  const bool in = interior(idx, p);
  const int nbits = 8 * (int)sizeof(K);
  K prefix = 0;
  int r = rank;
  for (int bit = nbits - 1; bit >= 0; --bit) {
    const K above = bit + 1 < nbits ? (K)(~0ull << (bit + 1)) : (K)0;
    const K one = (K)(1ull << bit);
    int zeros = 0;
    for (int t = 0; t < p.taps; ++t) {
      const K k =
          Key<T>::of(tap_value<T, T>(x, e, idx, in, t, off, delta, p, cval));
      zeros += ((K)(k & above) == prefix && !(k & one)) ? 1 : 0;
    }
    if (r >= zeros) {
      r -= zeros;
      prefix = (K)(prefix | one);
    }
  }
  for (int t = 0; t < p.taps; ++t) {
    const T v = tap_value<T, T>(x, e, idx, in, t, off, delta, p, cval);
    if (Key<T>::of(v) == prefix && r-- == 0) {
      out[e] = v;
      return;
    }
  }
}

// the highest set bit of v != 0
__device__ __forceinline__ int top_bit(uint32_t v) {
  return 31 - __clz((int)v);
}
__device__ __forceinline__ int top_bit(uint64_t v) {
  return 63 - __clzll((long long)v);
}

// The halo-box tile geometry of K11's tile route and K12's select tile
// (ops/morphology.py:_min_max_plan, _rank_plan): three tile axes, each an
// axis of the footprint, a batch axis or an extent of 1, and the batch axes
// the grid walks.
struct RankTile {
  int n[3];      // extents of the tile axes
  int st[3];     // their element strides within a sample
  int c[3];      // the footprint's centre along each (0 on a batch axis)
  int box[3];    // the halo box: tile extent + footprint extent - 1
  int tiles[3];  // tiles along each axis
  int taps, rank, mode;
  int nb;                       // batch axes walked by the grid
  int bn[ED_MORPH_MAXR];        // their extents
  int64_t bst[ED_MORPH_MAXR];   // and strides
};

// The sample offset of block blockIdx.x's batch index, and its tile's first
// voxel (s0, s1, s2) for a C x ED_RANK_TY x ED_RANK_TX tile, without 64-bit
// division: the tile the fastest, the last tile axis the fastest of those,
// then the batch axes, the last fastest.
__device__ __forceinline__ int64_t tile_block(const RankTile& p, int C,
                                              int* s0, int* s1, int* s2) {
  unsigned rest = blockIdx.x;
  const unsigned per = (unsigned)(p.tiles[0] * p.tiles[1] * p.tiles[2]);
  unsigned bi = rest / per;
  rest -= bi * per;
  *s2 = (int)(rest % (unsigned)p.tiles[2]) * ED_RANK_TX;
  rest /= (unsigned)p.tiles[2];
  *s1 = (int)(rest % (unsigned)p.tiles[1]) * ED_RANK_TY;
  *s0 = (int)(rest / (unsigned)p.tiles[1]) * C;
  int64_t base = 0;
#pragma unroll
  for (int a = ED_MORPH_MAXR - 1; a >= 0; --a) {
    if (a < p.nb) {
      const unsigned e = bi % (unsigned)p.bn[a];
      bi /= (unsigned)p.bn[a];
      base += (int64_t)e * p.bst[a];
    }
  }
  return base;
}

// Visits the halo box of the tile at (s0, s1, s2): box element (b0, b1, b2),
// row-major at i = (b0 * box[1] + b1) * box[2] + b2, stands for array
// element s - c + b, folded by the mode on each axis as tap_value folds it.
// Calls put(i, v, true) with that element of xs, or put(i, T(0), false)
// where constant mode leaves the array. A warp takes ED_STAGE_ROWS rows at
// a time, its lanes along tile axis 2, and loads an element of each before
// it stores any: a load a thread at a time left the staging waiting on
// device memory's latency.
template <typename T, typename F>
__device__ __forceinline__ void visit_box(const RankTile& p, const T* xs,
                                          int s0, int s1, int s2, F put) {
  constexpr int U = ED_STAGE_ROWS;
  const int rows = p.box[0] * p.box[1];
  const int P1 = p.box[2];
  for (int r0 = threadIdx.y; r0 < rows; r0 += U * ED_RANK_TY) {
    int src[U];
    bool row_in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * ED_RANK_TY;
      const int b0 = r / p.box[1];
      const int f0 = fold<int>(s0 - p.c[0] + b0, p.n[0], p.mode);
      const int f1 =
          fold<int>(s1 - p.c[1] + r - b0 * p.box[1], p.n[1], p.mode);
      row_in[u] = r < rows && f0 >= 0 && f1 >= 0;
      src[u] = row_in[u] ? f0 * p.st[0] + f1 * p.st[1] : 0;
    }
    for (int b2 = threadIdx.x; b2 < P1; b2 += ED_RANK_TX) {
      const int f2 = fold<int>(s2 - p.c[2] + b2, p.n[2], p.mode);
      T v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = row_in[u] && f2 >= 0 ? xs[src[u] + f2 * p.st[2]] : T(0);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r0 + u * ED_RANK_TY < rows)
          put((r0 + u * ED_RANK_TY) * P1 + b2, v[u], row_in[u] && f2 >= 0);
    }
  }
}

// K12's select route on a halo box: block (batch, tile) stages the tile's
// box of keys (Key<T>::of, once per element) and raw values, the array
// folded at its edges or cval in constant mode, exactly as tap_value reads
// them, and the footprint's taps as int32 offsets into the box in raster
// order; thread (y, x) then selects the rank-th smallest key of each of its
// C voxels (c, y, x) from shared memory only. A first pass takes the AND
// and OR of a voxel's keys: their common leading bits are the answer's, and
// equal keys everywhere leave only the pick. Each further pass resolves the
// next ED_RANK_BITS bits: it counts, among the taps whose key matches the
// prefix so far, each value of the digit, in 8-bit fields packed in one
// register (c += 1 << 8 * digit; the top digit's count is what the others
// leave)
// and flushed to wide counters every 255 taps; the rank's digit joins the
// prefix. A voxel stops when one key is left or the key is whole. What is
// left of the rank then picks among the taps of the winning key (or of the
// one key left) in tap order, as the stable sort and rank_select_kernel
// do, so a zero keeps its sign and a NaN its bits.
template <typename T, int C>
__global__ void __launch_bounds__(ED_RANK_TY * ED_RANK_TX, 2)
rank_select_tile_kernel(const T* __restrict__ x, T* __restrict__ out,
                        const int* __restrict__ toff_g, const RankTile p,
                        const T cval) {
  typedef typename Key<T>::K K;
  typedef typename std::conditional<sizeof(K) == 8, uint64_t, uint32_t>::type
      U;
  constexpr int B = ED_RANK_BITS;
  constexpr int ND = 1 << B;  // digit values, an 8-bit count each
  static_assert(ND <= 4, "the digit counts fill one 32-bit register");
  extern __shared__ __align__(16) unsigned char ed_smem[];
  const int P1 = p.box[2], P0 = p.box[1] * p.box[2];
  const int cells = p.box[0] * P0;
  K* keys = reinterpret_cast<K*>(ed_smem);
  T* raw = reinterpret_cast<T*>(ed_smem + (size_t)cells * sizeof(K));
  int* toff = reinterpret_cast<int*>(
      ed_smem + ((2 * (size_t)cells * sizeof(K) + 3) & ~(size_t)3));
  int s0, s1, s2;
  const int64_t base = tile_block(p, C, &s0, &s1, &s2);
  visit_box(p, x + base, s0, s1, s2, [&](int i, T v, bool in) {
    v = in ? v : cval;
    keys[i] = Key<T>::of(v);
    raw[i] = v;
  });
  const int tid = threadIdx.y * ED_RANK_TX + threadIdx.x;
  for (int t = tid; t < p.taps; t += ED_RANK_TY * ED_RANK_TX)
    toff[t] = toff_g[t];
  __syncthreads();

  const int at = threadIdx.y * P1 + threadIdx.x;  // voxel c at at + c * P0
  // the common leading bits of each voxel's keys
  U lo_and[C], hi_or[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    lo_and[c] = ~(U)0;
    hi_or[c] = 0;
  }
  for (int t = 0; t < p.taps; ++t) {
    const K* kp = keys + at + toff[t];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const U k = kp[c * P0];
      lo_and[c] &= k;
      hi_or[c] |= k;
    }
  }
  // per voxel: the key's bits from `lo` up are `prefix`; m keys match it,
  // and the answer is the r-th of them (from 0)
  U prefix[C];
  int r[C], m[C], lo[C];
  bool live[C];
  bool any = false;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const U diff = lo_and[c] ^ hi_or[c];
    r[c] = p.rank;
    m[c] = p.taps;
    if (diff == 0) {
      prefix[c] = lo_and[c];
      lo[c] = 0;
      live[c] = false;
    } else {
      const int hb = top_bit(diff);
      const U above = hb + 1 < 8 * (int)sizeof(U) ? ~(U)0 << (hb + 1) : 0;
      prefix[c] = lo_and[c] & above;
      lo[c] = hb + 1;
      live[c] = true;
      any = true;
    }
  }
  while (any) {
    // this pass's digit: bits [ls, lo) of a key whose bits from lo up
    // match the prefix (x = key ^ prefix: x >> hs <= 1)
    int hs[C], ls[C];
    unsigned wide[C][ND - 1];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      hs[c] = lo[c] > 0 ? lo[c] - 1 : 0;
      ls[c] = lo[c] > B ? lo[c] - B : 0;
#pragma unroll
      for (int f = 0; f < ND - 1; ++f) wide[c][f] = 0;
    }
    for (int t0 = 0; t0 < p.taps; t0 += 255) {
      const int t1 = t0 + 255 < p.taps ? t0 + 255 : p.taps;
      unsigned cnt[C];
#pragma unroll
      for (int c = 0; c < C; ++c) cnt[c] = 0;
      for (int t = t0; t < t1; ++t) {
        const K* kp = keys + at + toff[t];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const U xk = (U)kp[c * P0] ^ prefix[c];
          const unsigned d = (unsigned)(xk >> ls[c]) & (ND - 1);
          const bool match = (xk >> hs[c]) <= 1;
          cnt[c] += match ? 1u << (d << 3) : 0u;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int f = 0; f < ND - 1; ++f)
          wide[c][f] += (cnt[c] >> (f << 3)) & 255u;
    }
    any = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!live[c]) continue;
      int d = ND - 1, below = 0, mm = 0;
#pragma unroll
      for (int f = 0; f < ND - 1; ++f) {
        if (d == ND - 1) {
          if (r[c] < below + (int)wide[c][f]) {
            d = f;
            mm = (int)wide[c][f];
          } else {
            below += (int)wide[c][f];
          }
        }
      }
      if (d == ND - 1) mm = m[c] - below;
      r[c] -= below;
      m[c] = mm;
      prefix[c] |= (U)d << ls[c];
      lo[c] = ls[c];
      live[c] = mm > 1 && ls[c] > 0;
      any = any || live[c];
    }
  }
  // the pick: the r-th tap, in tap order, whose key matches the prefix in
  // its bits from lo up
  U mask[C];
  T res[C];
  int left = C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    mask[c] = lo[c] > 0 ? ((U)1 << lo[c]) - 1 : 0;
    live[c] = true;
    res[c] = cval;
  }
  for (int t = 0; t < p.taps && left > 0; ++t) {
    const int o = at + toff[t];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (live[c] && ((U)keys[o + c * P0] ^ prefix[c]) <= mask[c]) {
        if (r[c] == 0) {
          res[c] = raw[o + c * P0];
          live[c] = false;
          --left;
        } else {
          --r[c];
        }
      }
    }
  }
  const int j1 = s1 + threadIdx.y, j2 = s2 + threadIdx.x;
  if (j1 >= p.n[1] || j2 >= p.n[2]) return;
  T* os = out + base + j1 * p.st[1] + j2 * p.st[2];
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (s0 + c < p.n[0]) os[(s0 + c) * p.st[0]] = res[c];
}

// K12's network route on a halo box. Batcher's odd-even mergesort
// comparators of N wires (N a power of two up to ED_MAX_WIRES), built at
// compile time by the recursion of ops/morphology.py:_batcher_pairs, in its
// order: comparator k sends the min of wires i[k], j[k] to i[k] and the max
// to j[k].
struct BatcherNet {
  int count;
  unsigned char i[ED_NET_MAX_PAIRS], j[ED_NET_MAX_PAIRS];
};

__host__ __device__ constexpr void batcher_merge(BatcherNet& net, int lo,
                                                 int m, int r) {
  const int step = r * 2;
  if (step < m) {
    batcher_merge(net, lo, m, step);
    batcher_merge(net, lo + r, m, step);
    for (int i = lo + r; i < lo + m - r; i += step) {
      net.i[net.count] = (unsigned char)i;
      net.j[net.count] = (unsigned char)(i + r);
      ++net.count;
    }
  } else {
    net.i[net.count] = (unsigned char)lo;
    net.j[net.count] = (unsigned char)(lo + r);
    ++net.count;
  }
}

__host__ __device__ constexpr void batcher_sort(BatcherNet& net, int lo,
                                                int hi) {
  if (hi - lo >= 1) {
    const int mid = lo + (hi - lo) / 2;
    batcher_sort(net, lo, mid);
    batcher_sort(net, mid + 1, hi);
    batcher_merge(net, lo, hi - lo + 1, 1);
  }
}

__host__ __device__ constexpr BatcherNet batcher_net(int n) {
  BatcherNet net{};
  batcher_sort(net, 0, n - 1);
  return net;
}

template <int N>
struct Batcher {
  static constexpr BatcherNet net = batcher_net(N);
  static constexpr int pairs = net.count;
};
static_assert(Batcher<64>::pairs == ED_NET_MAX_PAIRS, "64 wires, 543 pairs");

// comparator k's wires (device code reads the table's scalars only through
// a constexpr function called in a constant expression)
template <int N>
__host__ __device__ constexpr int net_lo(int k) {
  return Batcher<N>::net.i[k];
}
template <int N>
__host__ __device__ constexpr int net_hi(int k) {
  return Batcher<N>::net.j[k];
}

// The network tile's wires hold integer keys in the order nan_min /
// nan_max give the values, so that a comparator is one integer min and one
// max: the value itself for integers and bool (in 32 bits or the type's
// own 64), and for floats the bits as a signed integer with the magnitude
// bits flipped under a set sign bit (-inf < ... < -0 < +0 < ... < +inf).
// The map is one to one, so the selected key gives back the value's bits.
// A NaN tap is flagged apart: nan_min / nan_max send a NaN to the result
// through any correct selection network, so the result is then NaN.
template <typename T>
struct NetKey {
  typedef typename std::conditional<
      (sizeof(T) < 4), int,
      typename std::conditional<std::is_signed<T>::value, int64_t,
                                uint64_t>::type>::type Wide;
  typedef typename std::conditional<sizeof(T) == 4, T, Wide>::type K;
  __device__ static K of(T v) { return (K)v; }
  __device__ static T back(K k) { return (T)k; }
  __device__ static bool nan(T) { return false; }
};
template <>
struct NetKey<float> {
  typedef int K;
  __device__ static K of(float v) {
    const int b = __float_as_int(v);
    return b ^ ((b >> 31) & 0x7fffffff);
  }
  __device__ static float back(K k) {
    return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
  }
  __device__ static bool nan(float v) { return v != v; }
};
template <>
struct NetKey<double> {
  typedef long long K;
  __device__ static K of(double v) {
    const long long b = __double_as_longlong(v);
    return b ^ ((b >> 63) & 0x7fffffffffffffffll);
  }
  __device__ static double back(K k) {
    return __longlong_as_double(k ^ ((k >> 63) & 0x7fffffffffffffffll));
  }
  __device__ static bool nan(double v) { return v != v; }
};

// comparator C of N wires: one integer min and one max of the keys
template <typename K, int N, int C>
__device__ __forceinline__ void net_step(K (&w)[N]) {
  constexpr int i = net_lo<N>(C), j = net_hi<N>(C);
  const K a = w[i], b = w[j];
  w[i] = b < a ? b : a;
  w[j] = b < a ? a : b;
}

template <typename K, int N, size_t... C>
__device__ __forceinline__ void run_net(K (&w)[N], std::index_sequence<C...>) {
  (net_step<K, N, (int)C>(w), ...);
}

// wire `rank` of w into w[0], by halves: a select tree of compile-time
// indices (a chain of tests of t == rank let the compiler index the wires
// at run time, which put them in local memory)
template <typename K, int N, int H>
__device__ __forceinline__ void take_half(K (&w)[N], int rank) {
  if constexpr (H >= 1) {
    const bool upper = (rank & H) != 0;
#pragma unroll
    for (int t = 0; t < H; ++t) w[t] = upper ? w[t + H] : w[t];
    take_half<K, N, H / 2>(w, rank);
  }
}

// Blocks an SM that the network tile asks registers for: its N wires (two
// registers each for 8-byte types) and about 40 more, twice that at 64
// wires (which keep more comparators in flight: at 2 blocks, 128
// registers, their 4-byte types spilled on the H100), at most 4
template <typename T, int N>
struct NetBlocks {
  static constexpr int slack = 40;
  static constexpr int need =
      N * (sizeof(T) == 8 ? 2 : 1) + slack * (N == 64 ? 2 : 1);
  static constexpr int fit = 65536 / (ED_RANK_TY * ED_RANK_TX * need);
  static constexpr int value = fit < 1 ? 1 : fit > 4 ? 4 : fit;
};

// K12's network route on a halo box: block (batch, tile) stages the tile's
// box of values once (folded at the array's edges, or cval in constant
// mode: visit_box, as the select tile stages it), the taps' int32 offsets
// into the box (raster order, padded to N with 0). Thread (y, x) then takes
// each voxel (c, y, x) of its column of C in turn: its taps from shared
// memory into N wires of keys held in registers (every index a
// compile-time constant), the pad wires at the type's largest value,
// Batcher's whole comparator list, wire `rank` out by halves, NaN where a
// tap is NaN. Any correct selection network gives
// rank_network_kernel's result bit for bit: nan_min / nan_max order the
// values totally, -0 below +0, and send a NaN to the result.
template <typename T, int N>
__global__ void __launch_bounds__(ED_RANK_TY * ED_RANK_TX,
                                  NetBlocks<T, N>::value)
rank_network_tile_kernel(const T* __restrict__ x, T* __restrict__ out,
                         const int* __restrict__ toff_g,
                         const RankTile p, int column, const T cval,
                         const T pad) {
  extern __shared__ __align__(16) unsigned char ed_smem[];
  const int P1 = p.box[2], P0 = p.box[1] * p.box[2];
  const int cells = p.box[0] * P0;
  T* box = reinterpret_cast<T*>(ed_smem);
  int* toff = reinterpret_cast<int*>(
      ed_smem + (((size_t)cells * sizeof(T) + 3) & ~(size_t)3));
  int s0, s1, s2;
  const int64_t base = tile_block(p, column, &s0, &s1, &s2);
  visit_box(p, x + base, s0, s1, s2,
            [&](int i, T v, bool in) { box[i] = in ? v : cval; });
  const int tid = threadIdx.y * ED_RANK_TX + threadIdx.x;
  for (int t = tid; t < N; t += ED_RANK_TY * ED_RANK_TX)
    toff[t] = t < p.taps ? toff_g[t] : 0;
  __syncthreads();
  const int j1 = s1 + threadIdx.y, j2 = s2 + threadIdx.x;
  if (j1 >= p.n[1] || j2 >= p.n[2]) return;
  const T* col = box + threadIdx.y * P1 + threadIdx.x;  // voxel c: + c * P0
  T* os = out + base + j1 * p.st[1] + j2 * p.st[2];
  const int cn = p.n[0] - s0 < column ? p.n[0] - s0 : column;
  typedef NetKey<T> NK;
  typedef typename NK::K K;
  const K kpad = NK::of(pad);
#pragma unroll 1
  for (int c = 0; c < cn; ++c) {
    const T* v = col + c * P0;
    K w[N];
    bool nan = false;
    // (a pad wire's offset is 0: it loads box element 0 and drops it)
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const T a = v[toff[t]];
      const bool tap = t < p.taps;
      nan = nan || (tap && NK::nan(a));
      w[t] = tap ? NK::of(a) : kpad;
    }
    run_net<K, N>(w, std::make_index_sequence<(size_t)Batcher<N>::pairs>{});
    take_half<K, N, N / 2>(w, p.rank);
    T r = NK::back(w[0]);
    if constexpr (std::is_floating_point<T>::value) r = nan ? T(NAN) : r;
    os[(s0 + c) * p.st[0]] = r;
  }
}

// K11's tile route: block (batch, tile) stages the tile's halo box in the
// work type W, each element the array element tap_value reads there (W(x),
// folded) or cval in constant mode (visit_box), and the footprint's taps as
// int32 offsets into the box in raster order, with the structure's values
// when NONFLAT; thread (y, x) then reduces each of its C voxels (c, y, x)
// over the taps from shared memory with min_max_nd_kernel's code and order:
// v = box value (- or + s[t] when NONFLAT), acc = v_0, then pick(acc, v_t).
// So the two routes agree bit for bit, a NaN's bits and a zero's sign too.
// At most 4 blocks' worth of registers per SM are asked for (64 a thread).
template <typename T, typename W, bool MIN, bool NONFLAT, int C>
__global__ void __launch_bounds__(ED_RANK_TY * ED_RANK_TX, 4)
min_max_tile_kernel(const T* __restrict__ x, T* __restrict__ out,
                    const int* __restrict__ toff_g,
                    const W* __restrict__ sval_g, const RankTile p,
                    const W cval) {
  extern __shared__ __align__(16) unsigned char ed_smem[];
  const int P1 = p.box[2], P0 = p.box[1] * p.box[2];
  const int cells = p.box[0] * P0;
  // the box, the structure's values (NONFLAT), then the offsets
  W* box = reinterpret_cast<W*>(ed_smem);
  W* sv = box + cells;
  int* toff = reinterpret_cast<int*>(
      ed_smem + ((((size_t)cells + (NONFLAT ? p.taps : 0)) * sizeof(W) + 3) &
                 ~(size_t)3));
  int s0, s1, s2;
  const int64_t base = tile_block(p, C, &s0, &s1, &s2);
  visit_box(p, x + base, s0, s1, s2,
            [&](int i, T v, bool in) { box[i] = in ? W(v) : cval; });
  const int tid = threadIdx.y * ED_RANK_TX + threadIdx.x;
  for (int t = tid; t < p.taps; t += ED_RANK_TY * ED_RANK_TX) {
    toff[t] = toff_g[t];
    if constexpr (NONFLAT) sv[t] = sval_g[t];
  }
  __syncthreads();
  const W* col = box + threadIdx.y * P1 + threadIdx.x;  // voxel c: + c * P0
  W acc[C];
  {
    const W* v = col + toff[0];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      W a = v[c * P0];
      if constexpr (NONFLAT) a = MIN ? a - sv[0] : a + sv[0];
      acc[c] = a;
    }
  }
  // unrolled twice: further unrolling took a 1- or 2-byte work type from
  // 40 to 71-79 registers and fewer blocks an SM (at c16's ball, 1.18 ms
  // against 1.53-1.60 on an H100)
#pragma unroll 2
  for (int t = 1; t < p.taps; ++t) {
    const W* v = col + toff[t];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      W a = v[c * P0];
      if constexpr (NONFLAT) a = MIN ? a - sv[t] : a + sv[t];
      acc[c] = pick<MIN>(acc[c], a);
    }
  }
  const int j1 = s1 + threadIdx.y, j2 = s2 + threadIdx.x;
  if (j1 >= p.n[1] || j2 >= p.n[2]) return;
  T* os = out + base + j1 * p.st[1] + j2 * p.st[2];
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (s0 + c < p.n[0]) os[(s0 + c) * p.st[0]] = finish<T, W>(acc[c]);
}

// ---------------------------------------------------------------------------
// K13's tile route

// the array as (nz, ny, nx) voxels, nw words a line; a block's output tile
// of tz x ty voxels x tw words, gz x gy x gw tiles; one sweep's reach rz,
// ry voxels and rw words (0 or 1); k sweeps a launch; the box's largest
// extents bz, by, bw (words), which lay out shared memory
struct BinTile {
  int nz, ny, nx, nw;
  int tz, ty, tw;
  int gz, gy, gw;
  int rz, ry, rw;
  int k, nrows, ntaps;
  int bz, by, bw;
};

// n / d for n < 2^31 by a multiply (the magic number of PyTorch's
// IntDivider): the region loops divide every index twice
struct FastDiv {
  unsigned d, m, s;
};

__host__ __device__ __forceinline__ FastDiv make_div(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1u << s) < d) ++s;
  const unsigned long long one = 1;
  FastDiv f;
  f.d = d;
  f.s = s;
  f.m = (unsigned)(((one << 32) * ((one << s) - d)) / d + 1);
  return f;
}

__device__ __forceinline__ unsigned div_by(unsigned n, const FastDiv& f) {
  const unsigned t = __umulhi(n, f.m);
  return (unsigned)(((unsigned long long)t + n) >> f.s);
}

// [lo, hi) of an axis of n: the tile [t0, t1) widened by `reach` on each
// side, clamped to the array
__device__ __forceinline__ void widen(int t0, int t1, int reach, int n,
                                      int* lo, int* hi) {
  *lo = t0 - reach < 0 ? 0 : t0 - reach;
  *hi = t1 + reach > n ? n : t1 + reach;
}

// k <= ED_BIN_MAX_SWEEPS sweeps of a block's tile, by 1024 threads (a
// sweep's words wait on shared-memory loads, so a block brings 32 warps;
// the bound leaves them 64 registers, and at 32 the kernel spilled). taps: nrows row codes, then ntaps dx values. A row code holds
// the row's offsets oz, oy as signed bytes (bits 24-31, 16-23), its tap
// count (bits 1-8) and whether a tap has dx != 0 (bit 0); its taps' dx
// follow in order, so a row's words are loaded once. BYTES: in, out and
// mask are bool bytes of (nz, ny, nx); else in and out are packed words of
// (nz, ny, nw) and mask packed words with zero pad bits. mask may be NULL.
template <bool DIL, bool BYTES>
__global__ void __launch_bounds__(ED_BIN_THREADS, 1)
binary_tile_kernel(const void* __restrict__ in, void* __restrict__ out,
                   const void* __restrict__ mask,
                   const int* __restrict__ taps, const BinTile p,
                   const unsigned border, int* changed) {
  extern __shared__ unsigned ed_bin_smem[];
  // the region loops' divisors: the box, each sweep's region, the tile
  __shared__ FastDiv divs[ED_BIN_MAX_SWEEPS + 2][2];
  const int cap = p.bz * p.by * p.bw;
  unsigned* cur = ed_bin_smem;
  unsigned* nxt = cur + cap;
  unsigned* gate = nxt + cap;
  int* rowtab = reinterpret_cast<int*>(gate + cap);
  const int* dxs = rowtab + p.nrows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  int b = blockIdx.x;
  const int tiw = b % p.gw;
  b /= p.gw;
  const int tiy = b % p.gy;
  const int tiz = b / p.gy;
  const int z0 = tiz * p.tz, z1 = min(z0 + p.tz, p.nz);
  const int y0 = tiy * p.ty, y1 = min(y0 + p.ty, p.ny);
  const int w0 = tiw * p.tw, w1 = min(w0 + p.tw, p.nw);
  int Z0, Z1, Y0, Y1, W0, W1;
  widen(z0, z1, p.k * p.rz, p.nz, &Z0, &Z1);
  widen(y0, y1, p.k * p.ry, p.ny, &Y0, &Y1);
  widen(w0, w1, p.k * p.rw, p.nw, &W0, &W1);
  const int BZ = Z1 - Z0, BY = Y1 - Y0, BW = W1 - W0;
  const int nbox = BZ * BY * BW;
  const unsigned bdd = border ? ~0u : 0u;
  const unsigned last = (p.nx & 31) ? (1u << (p.nx & 31)) - 1u : ~0u;

  if (threadIdx.x < p.k + 2) {
    // slot 0 the box, slot 1 + s sweep s's region (the tile widened by the
    // reaches of the sweeps after it), slot k + 1 the tile
    const int j = threadIdx.x;
    const int left = j == 0 ? p.k : j <= p.k ? p.k - j : 0;
    int lo, hi, ylo, yhi;
    widen(w0, w1, left * p.rw, p.nw, &lo, &hi);
    widen(y0, y1, left * p.ry, p.ny, &ylo, &yhi);
    divs[j][0] = make_div(hi - lo);
    divs[j][1] = make_div(yhi - ylo);
  }
  for (int t = threadIdx.x; t < p.nrows + p.ntaps; t += blockDim.x)
    rowtab[t] = taps[t];
  __syncthreads();
  const FastDiv box_w = divs[0][0], box_y = divs[0][1];
  if constexpr (BYTES) {
    // a warp a word: lane j reads voxel 32 w + j, a ballot packs the word
    const uint8_t* xb = static_cast<const uint8_t*>(in);
    const uint8_t* mb = static_cast<const uint8_t*>(mask);
    for (int i = warp; i < nbox; i += nwarps) {
      const unsigned q = div_by(i, box_w);
      const int w = i - (int)q * BW;
      const unsigned zq = div_by(q, box_y);
      const int y = (int)q - (int)zq * BY;
      const int64_t line = (int64_t)(Z0 + (int)zq) * p.ny + Y0 + y;
      const int x = (W0 + w) * 32 + lane;
      const bool inside = x < p.nx;
      const int64_t at = line * p.nx + x;
      const unsigned word =
          __ballot_sync(0xffffffffu, inside ? xb[at] != 0 : border != 0);
      const unsigned g = __ballot_sync(
          0xffffffffu, inside && (mb == nullptr || mb[at] != 0));
      if (lane == 0) {
        cur[i] = word;
        gate[i] = g;
      }
    }
  } else {
    const unsigned* xw = static_cast<const unsigned*>(in);
    const unsigned* mw = static_cast<const unsigned*>(mask);
    for (int i = threadIdx.x; i < nbox; i += blockDim.x) {
      const unsigned q = div_by(i, box_w);
      const int w = i - (int)q * BW;
      const unsigned zq = div_by(q, box_y);
      const int y = (int)q - (int)zq * BY;
      const int64_t at =
          ((int64_t)(Z0 + (int)zq) * p.ny + Y0 + y) * p.nw + W0 + w;
      stage_async(cur + i, xw + at);
      const unsigned valid = W0 + w == p.nw - 1 ? last : ~0u;
      gate[i] = mw == nullptr ? valid : mw[at];
    }
    stage_wait();
  }
  __syncthreads();

  bool flag = false;
  for (int s = 0; s < p.k; ++s) {
    // this sweep computes the tile widened by the reaches of the sweeps
    // still to come; its reads lie in the last sweep's region or outside
    // the array
    const int left = p.k - 1 - s;
    int rz0, rz1, ry0, ry1, rw0, rw1;
    widen(z0, z1, left * p.rz, p.nz, &rz0, &rz1);
    widen(y0, y1, left * p.ry, p.ny, &ry0, &ry1);
    widen(w0, w1, left * p.rw, p.nw, &rw0, &rw1);
    const int RY = ry1 - ry0, RW = rw1 - rw0;
    const int n = (rz1 - rz0) * RY * RW;
    const FastDiv reg_w = divs[1 + s][0], reg_y = divs[1 + s][1];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const unsigned q = div_by(i, reg_w);
      const int bw = (int)(i - q * RW) + rw0 - W0;
      const unsigned zq = div_by(q, reg_y);
      const int by = (int)(q - zq * RY) + ry0 - Y0;
      const int bz = (int)zq + rz0 - Z0;
      unsigned acc = DIL ? 0u : ~0u;
      for (int j = 0, t = 0; j < p.nrows; ++j) {
        const int rc = rowtab[j];
        const int zz = bz + (int)(signed char)(rc >> 24);
        const int yy = by + (int)(signed char)(rc >> 16);
        // outside the box is outside the array
        const unsigned* row = zz < 0 || zz >= BZ || yy < 0 || yy >= BY
                                  ? nullptr
                                  : cur + (zz * BY + yy) * BW;
        const unsigned c = row != nullptr ? row[bw] : bdd;
        unsigned l = bdd, r = bdd;
        if (rc & 1) {
          l = row != nullptr && bw > 0 ? row[bw - 1] : bdd;
          r = row != nullptr && bw + 1 < BW ? row[bw + 1] : bdd;
        }
        const int end = t + ((rc >> 1) & 0xFF);
        for (; t < end; ++t) {
          const int dx = dxs[t];
          const unsigned v = dx >= 0 ? __funnelshift_rc(c, r, dx)
                                     : __funnelshift_rc(l, c, 32 + dx);
          acc = DIL ? (acc | v) : (acc & v);
        }
        if (acc == (DIL ? ~0u : 0u)) break;  // the word is decided
      }
      const int at = (bz * BY + by) * BW + bw;
      const unsigned old = cur[at], g = gate[at];
      const unsigned now = (acc & g) | (old & ~g);
      nxt[at] = now;
      if (left == 0 && now != old) flag = true;
    }
    __syncthreads();
    unsigned* t = cur;
    cur = nxt;
    nxt = t;
  }

  // the tile out of the last sweep's buffer
  const int TY = y1 - y0, TW = w1 - w0;
  const int ntile = (z1 - z0) * TY * TW;
  const FastDiv tile_w = divs[p.k + 1][0], tile_y = divs[p.k + 1][1];
  if constexpr (BYTES) {
    uint8_t* ob = static_cast<uint8_t*>(out);
    for (int i = warp; i < ntile; i += nwarps) {
      const unsigned q = div_by(i, tile_w);
      const int w = (int)(i - q * TW) + w0;
      const unsigned zq = div_by(q, tile_y);
      const int y = (int)(q - zq * TY) + y0;
      const int z = (int)zq + z0;
      const int x = w * 32 + lane;
      if (x < p.nx) {
        const unsigned word = cur[((z - Z0) * BY + y - Y0) * BW + w - W0];
        ob[((int64_t)z * p.ny + y) * p.nx + x] = (word >> lane) & 1u;
      }
    }
  } else {
    unsigned* ow = static_cast<unsigned*>(out);
    for (int i = threadIdx.x; i < ntile; i += blockDim.x) {
      const unsigned q = div_by(i, tile_w);
      const int w = (int)(i - q * TW) + w0;
      const unsigned zq = div_by(q, tile_y);
      const int y = (int)(q - zq * TY) + y0;
      const int z = (int)zq + z0;
      ow[((int64_t)z * p.ny + y) * p.nw + w] =
          cur[((z - Z0) * BY + y - Y0) * BW + w - W0];
    }
  }
  if (changed != nullptr && __any_sync(0xffffffffu, flag) && lane == 0)
    atomicOr(changed, 1);
}

// bool bytes of `lines` lines of nx voxels into packed words (nw a line),
// a warp a word; the pad bits past a line's end take `border`
__global__ void __launch_bounds__(ED_PACK_THREADS)
binary_pack_kernel(const uint8_t* __restrict__ x, unsigned* __restrict__ words,
                   int64_t nwords, int nx, int nw, int border) {
  const int lane = threadIdx.x & 31;
  const int64_t step = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       i < nwords; i += step) {
    const int64_t line = i / nw;
    const int xx = (int)(i - line * nw) * 32 + lane;
    const bool v = xx < nx ? x[line * nx + xx] != 0 : border != 0;
    const unsigned word = __ballot_sync(0xffffffffu, v);
    if (lane == 0) words[i] = word;
  }
}

// the inverse: packed words back to bool bytes
__global__ void __launch_bounds__(ED_PACK_THREADS)
binary_unpack_kernel(const unsigned* __restrict__ words,
                     uint8_t* __restrict__ x, int64_t nwords, int nx,
                     int nw) {
  const int lane = threadIdx.x & 31;
  const int64_t step = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       i < nwords; i += step) {
    const int64_t line = i / nw;
    const int xx = (int)(i - line * nw) * 32 + lane;
    if (xx < nx) x[line * nx + xx] = (words[i] >> lane) & 1u;
  }
}

// ---------------------------------------------------------------------------
// K10's box route: every pass of a separable box in one launch

// The geometry of ops/morphology.py:_box_plan: three tile axes (the box's
// axes, batch axes or extents of 1, as halo_tile orders them), the batch
// axes the grid walks, and the passes in their order (_box_tables).
struct MinMaxBox {
  int n[3];      // extents of the tile axes
  int st[3];     // their element strides within a sample
  int c[3];      // the box's centre along each (0 off the box)
  int mode[3];   // its filter mode
  int tile[3];   // the output tile
  int box[3];    // the staged box: tile + k - 1
  int tiles[3];  // tiles along each axis
  int p2;        // shared row stride in elements: box[2], padded
  int granules;  // 16-byte granules a staged row may span
  FastDiv dg, d1;  // by granules, by box[1]
  int npass;
  // the passes in order, each over the region its
  // predecessors left (make_box): the window k; lines of ned positions
  // along the pass's axis at stride sd, nf x ns of them at strides sf
  // (the fast axis: 2, or 1 for a pass along 2) and ss
  struct Pass {
    int k, nf, ns, ned, sf, ss, sd;
    int af, as, ad;  // the tile axes of the fast, slow and pass axes
    FastDiv df, ds;
  } pass[3];
  int nb;                      // batch axes walked by the grid
  int bn[ED_MORPH_MAXR];       // their extents
  int64_t bst[ED_MORPH_MAXR];  // and strides
};

// box output positions computed by a thread in turn along a pass's axis;
// the blocks an SM holds (ops/morphology.py:BOX_SMEM_AIM), which leaves a
// thread 85 registers (with only the threads bounded, ptxas took 64 and
// spilled the 2-byte types)
#define ED_BOX_SEGMENT 8
#define ED_BOX_BLOCKS 3

// Stages block's box: element (b0, b1, b2) at ((b0 * box[1] + b1) * p2 +
// b2) is x at the tile's origin - c + b, folded along each axis by that
// axis's mode, or cval where a constant axis leaves the array. Where tile
// axis 2 is contiguous, the part [lo, hi) of a row of the box (fixed b0,
// b1) inside the array along axis 2 is one run of memory, read in aligned
// 16-byte loads (the bytes around the run lie in the same aligned granules
// of the tensor's memory, so every load stays inside it), four in flight a
// thread, and scattered into shared memory; the row's positions beyond
// the array's edge along axis 2 fold element by element in a loop of their
// own (only edge blocks run it), as do constant rows and the rows of a
// strided axis 2.
template <typename T>
__device__ __forceinline__ void stage_minmax_box(const MinMaxBox& p,
                                                 const T* __restrict__ xs,
                                                 int s0, int s1, int s2,
                                                 T* box, const T cval) {
  constexpr int EPG = 16 / (int)sizeof(T);  // elements of a granule
  constexpr int U = 4;
  const int len = p.box[2];  // a row of the box
  const int G = p.granules;
  const int rows = p.box[0] * p.box[1];
  const int total = rows * G;
  const FastDiv dg = p.dg, d1 = p.d1;
  const int j2 = s2 - p.c[2];
  const int lo = max(0, -j2), hi = min(len, p.n[2] - j2);
  const bool unit = p.st[2] == 1 && lo < hi;
  for (int it0 = threadIdx.x; it0 < total; it0 += U * ED_THREADS) {
    uint4 v[U];
    int dst[U], from[U], head[U], q[U];
    bool cst[U], fast[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int it = it0 + u * ED_THREADS;
      const int r = (int)div_by((unsigned)(it < total ? it : 0), dg);
      q[u] = it - r * G;
      const int b0 = (int)div_by((unsigned)r, d1);
      const int b1 = r - b0 * p.box[1];
      const int f0 = fold<int>(s0 - p.c[0] + b0, p.n[0], p.mode[0]);
      const int f1 = fold<int>(s1 - p.c[1] + b1, p.n[1], p.mode[1]);
      cst[u] = f0 < 0 || f1 < 0;
      from[u] = cst[u] ? 0 : f0 * p.st[0] + f1 * p.st[1];
      dst[u] = it < total ? r * p.p2 : -1;
      fast[u] = unit && !cst[u];
      head[u] = 0;
      if (fast[u]) {
        // the row's position 0, which may lie before the array
        const uintptr_t a = (uintptr_t)(xs + from[u]) +
                            (uintptr_t)((intptr_t)j2 * (intptr_t)sizeof(T));
        head[u] = (int)(a & 15) / (int)sizeof(T);
        const int b2f = q[u] * EPG - head[u];
        if (dst[u] >= 0 && b2f < hi && b2f + EPG > lo)
          v[u] = __ldg(reinterpret_cast<const uint4*>(a - (a & 15)) + q[u]);
        else
          dst[u] = -1;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (dst[u] < 0) continue;
      T* row = box + dst[u];
      if (fast[u]) {
        const int b2f = q[u] * EPG - head[u];  // of the granule's byte 0
        if (sizeof(T) < 4 && b2f >= lo && b2f + EPG <= hi &&
            (reinterpret_cast<uintptr_t>(row + b2f) & 3) == 0) {
          // a whole granule at a 4-byte boundary: four 4-byte stores for
          // its 8 or 16 elements
          unsigned* d = reinterpret_cast<unsigned*>(row + b2f);
          d[0] = v[u].x;
          d[1] = v[u].y;
          d[2] = v[u].z;
          d[3] = v[u].w;
          continue;
        }
        T e[EPG];
        memcpy(e, &v[u], 16);
#pragma unroll
        for (int i = 0; i < EPG; ++i) {
          const int b2 = b2f + i;
          if (b2 >= lo && b2 < hi) row[b2] = e[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < EPG; ++i) {
          const int b2 = q[u] * EPG + i;
          if (b2 >= len) break;
          const int f2 = cst[u] ? -1 : fold<int>(j2 + b2, p.n[2], p.mode[2]);
          row[b2] = f2 < 0 ? cval : xs[from[u] + f2 * p.st[2]];
        }
      }
    }
  }
  if (!unit || (lo == 0 && hi == len)) return;
  // the loaded rows' positions past the array's edge along axis 2, folded
  const int edge = lo + len - hi;
  for (int it = threadIdx.x; it < rows * edge; it += ED_THREADS) {
    const int r = it / edge;
    const int e = it - r * edge;
    const int b2 = e < lo ? e : hi + e - lo;
    const int b0 = (int)div_by((unsigned)r, d1);
    const int f0 = fold<int>(s0 - p.c[0] + b0, p.n[0], p.mode[0]);
    const int f1 = fold<int>(s1 - p.c[1] + r - b0 * p.box[1], p.n[1],
                             p.mode[1]);
    if (f0 < 0 || f1 < 0) continue;  // a constant row, staged above
    const int f2 = fold<int>(j2 + b2, p.n[2], p.mode[2]);
    box[r * p.p2 + b2] =
        f2 < 0 ? cval : xs[f0 * p.st[0] + f1 * p.st[1] + f2];
  }
}

// Where a pass of K10's box route stores its outputs: position (f, sl, j)
// of its lines (fast, slow, along the pass's axis) at dst[f * gf + sl * gs
// + j * gd], where f < lf, sl < ls and j < ld: the next buffer of the box,
// or, for the last pass, the tile's elements inside the array in device
// memory.
template <typename T>
struct BoxDst {
  T* dst;
  int gf, gs, gd, lf, ls, ld;
};

// One pass q of K10's box route along a tile axis with a window of K
// (compile time), in the box's layout: `in` holds q.nf x q.ns lines of
// q.ned positions (MinMaxBox::Pass; consecutive threads take neighbouring
// lines along the fast axis), and q.ned - K + 1 positions of each line go
// to `o`. A thread takes a segment of ED_BOX_SEGMENT outputs of a line and
// slides a register window over it, so each staged element is read once a
// segment; an output is acc = w[j], then pick(acc, w[j + t]) for t = 1 ..
// K-1, min_max_1d_kernel's order.
template <typename T, bool MIN, int K>
__device__ __forceinline__ void box_pass(const T* __restrict__ in,
                                         const BoxDst<T>& o,
                                         const MinMaxBox::Pass& q) {
  constexpr int S = ED_BOX_SEGMENT;
  const int nf = q.nf, ns = q.ns, sf = q.sf, ss = q.ss, sd = q.sd;
  const int m = q.ned - K + 1;
  const int total = nf * ns * ((m + S - 1) / S);
  const FastDiv df = q.df, ds = q.ds;
  for (int it = threadIdx.x; it < total; it += ED_THREADS) {
    const int r1 = (int)div_by((unsigned)it, df);
    const int f = it - r1 * nf;
    const int seg = (int)div_by((unsigned)r1, ds);
    const int sl = r1 - seg * ns;
    const int j0 = seg * S;
    if (f >= o.lf || sl >= o.ls) continue;
    const T* src = in + f * sf + sl * ss + j0 * sd;
    T* dst = o.dst + f * o.gf + sl * o.gs + j0 * o.gd;
    const int mu = (m < o.ld ? m : o.ld) - j0;  // outputs of the segment
    T w[K];
#pragma unroll
    for (int t = 0; t < K - 1; ++t) w[t] = src[t * sd];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      if (u >= mu) break;
      w[(u + K - 1) % K] = src[(u + K - 1) * sd];
      T acc = w[u % K];
#pragma unroll
      for (int t = 1; t < K; ++t) acc = pick<MIN>(acc, w[(u + t) % K]);
      dst[u * o.gd] = acc;
    }
  }
}

// the same for a window longer than the register window takes: each
// output reads its K inputs from shared memory
template <typename T, bool MIN>
__device__ __forceinline__ void box_pass_any(const T* __restrict__ in,
                                             const BoxDst<T>& o,
                                             const MinMaxBox::Pass& q) {
  const int nf = q.nf, ns = q.ns, sf = q.sf, ss = q.ss, sd = q.sd, K = q.k;
  const int m = q.ned - K + 1;
  const int total = nf * ns * m;
  const FastDiv df = q.df, ds = q.ds;
  for (int it = threadIdx.x; it < total; it += ED_THREADS) {
    const int r1 = (int)div_by((unsigned)it, df);
    const int f = it - r1 * nf;
    const int j = (int)div_by((unsigned)r1, ds);
    const int sl = r1 - j * ns;
    if (f >= o.lf || sl >= o.ls || j >= o.ld) continue;
    const int off = f * sf + sl * ss + j * sd;
    T acc = in[off];
    for (int t = 1; t < K; ++t) acc = pick<MIN>(acc, in[off + t * sd]);
    o.dst[f * o.gf + sl * o.gs + j * o.gd] = acc;
  }
}

// v[a] of (v0, v1, v2) for a tile axis a, without indexing a local array
__device__ __forceinline__ int of_axis(int a, int v0, int v1, int v2) {
  return a == 0 ? v0 : a == 1 ? v1 : v2;
}

// K10's box route: block (batch, tile) stages the tile's box once
// (stage_minmax_box), runs the passes in order between two shared
// buffers, each pass shrinking the box along its axis to the tile, and
// stores the tile (the last pass itself where it runs along axis 0 or 1,
// its threads along the contiguous axis 2): one read of the box and one
// write of the tile in device memory for the whole box, where the lines
// route reads and writes the array once a pass. Every staged value is the
// one the sequential passes would have read there (each axis folds on its
// own, and a constant axis's cval stays cval through every pass), and each
// pass takes its window in min_max_1d_kernel's order; floats keep the
// caller's order of passes (a window of NaNs gives its first), integers
// and bool take axis 2's pass first (ops/morphology.py:_box_tables), which
// changes no min or max of theirs. So the routes agree bit for bit.
template <typename T, bool MIN>
__global__ void __launch_bounds__(ED_THREADS, ED_BOX_BLOCKS)
min_max_box_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const MinMaxBox p, const T cval) {
  extern __shared__ __align__(16) unsigned char ed_smem[];
  const int cells = p.box[0] * p.box[1] * p.p2;
  T* buf = reinterpret_cast<T*>(ed_smem);
  unsigned rest = blockIdx.x;
  const unsigned per = (unsigned)(p.tiles[0] * p.tiles[1] * p.tiles[2]);
  unsigned bi = rest / per;
  rest -= bi * per;
  const int s2 = (int)(rest % (unsigned)p.tiles[2]) * p.tile[2];
  rest /= (unsigned)p.tiles[2];
  const int s1 = (int)(rest % (unsigned)p.tiles[1]) * p.tile[1];
  const int s0 = (int)(rest / (unsigned)p.tiles[1]) * p.tile[0];
  int64_t base = 0;
#pragma unroll
  for (int a = ED_MORPH_MAXR - 1; a >= 0; --a) {
    if (a < p.nb) {
      const unsigned i = bi % (unsigned)p.bn[a];
      bi /= (unsigned)p.bn[a];
      base += (int64_t)i * p.bst[a];
    }
  }
  stage_minmax_box(p, x + base, s0, s1, s2, buf, cval);
  __syncthreads();
  // the tile's first element in device memory, and how many of its
  // positions along each axis lie inside the array
  T* tile = out + base + (int64_t)s0 * p.st[0] + (int64_t)s1 * p.st[1] +
            (int64_t)s2 * p.st[2];
  const int l0 = p.n[0] - s0 < p.tile[0] ? p.n[0] - s0 : p.tile[0];
  const int l1 = p.n[1] - s1 < p.tile[1] ? p.n[1] - s1 : p.tile[1];
  const int l2 = p.n[2] - s2 < p.tile[2] ? p.n[2] - s2 : p.tile[2];
  const int st0 = p.box[1] * p.p2, st1 = p.p2;
  int cur = 0;
  bool stored = false;
  for (int q = 0; q < p.npass; ++q) {
    // a copy at a constant index: no kernel parameter indexed at run time
    const MinMaxBox::Pass bp = q == 0 ? p.pass[0] : q == 1 ? p.pass[1]
                                                           : p.pass[2];
    const T* in = buf + cur * cells;
    BoxDst<T> o{buf + (cur ^ 1) * cells, bp.sf, bp.ss, bp.sd, bp.nf, bp.ns,
                bp.ned};
    // the last pass along axis 0 or 1 stores the tile itself: its threads
    // run along axis 2, so the stores coalesce
    if (q == p.npass - 1 && bp.ad != 2) {
      o = BoxDst<T>{tile, of_axis(bp.af, p.st[0], p.st[1], p.st[2]),
                    of_axis(bp.as, p.st[0], p.st[1], p.st[2]),
                    of_axis(bp.ad, p.st[0], p.st[1], p.st[2]),
                    of_axis(bp.af, l0, l1, l2), of_axis(bp.as, l0, l1, l2),
                    of_axis(bp.ad, l0, l1, l2)};
      stored = true;
    }
    switch (bp.k) {
      case 2: box_pass<T, MIN, 2>(in, o, bp); break;
      case 3: box_pass<T, MIN, 3>(in, o, bp); break;
      case 4: box_pass<T, MIN, 4>(in, o, bp); break;
      case 5: box_pass<T, MIN, 5>(in, o, bp); break;
      case 6: box_pass<T, MIN, 6>(in, o, bp); break;
      case 7: box_pass<T, MIN, 7>(in, o, bp); break;
      case 8: box_pass<T, MIN, 8>(in, o, bp); break;
      default: box_pass_any<T, MIN>(in, o, bp);
    }
    cur ^= 1;
    if (!stored) __syncthreads();
  }
  if (stored) return;
  // else the tile from shared memory, a warp a row, its lanes along axis 2
  const T* res = buf + cur * cells;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int b0 = 0, b1 = warp;
  while (b1 >= p.tile[1]) {
    b1 -= p.tile[1];
    ++b0;
  }
  for (; b0 < l0; ) {
    if (b1 < l1) {
      T* o = tile + b0 * p.st[0] + b1 * p.st[1];
      const T* src = res + b0 * st0 + b1 * st1;
      for (int b2 = lane; b2 < l2; b2 += 32) o[b2 * p.st[2]] = src[b2];
    }
    b1 += ED_THREADS / 32;
    while (b1 >= p.tile[1]) {
      b1 -= p.tile[1];
      ++b0;
    }
  }
}

// ---------------------------------------------------------------------------
// launches

bool blocks_for(int64_t total, unsigned* blocks) {
  const int64_t b = (total + ED_THREADS - 1) / ED_THREADS;
  if (b > INT32_MAX) return false;
  *blocks = (unsigned)b;
  return true;
}

template <typename T>
T from_bits(long long bits) {
  T v;
  memcpy(&v, &bits, sizeof(T));
  return v;
}

template <typename T>
cudaError_t launch_1d(bool minimum, const void* x, void* out, const Line& p,
                      long long cval_bits, cudaStream_t s) {
  unsigned blocks;
  if (!blocks_for(p.outer * p.n * p.inner, &blocks))
    return cudaErrorInvalidConfiguration;
  const T cval = from_bits<T>(cval_bits);
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (minimum)
    min_max_1d_kernel<T, true><<<blocks, ED_THREADS, 0, s>>>(xi, o, p, cval);
  else
    min_max_1d_kernel<T, false><<<blocks, ED_THREADS, 0, s>>>(xi, o, p, cval);
  return cudaGetLastError();
}

template <typename T, typename W, bool NONFLAT>
cudaError_t launch_nd_typed(bool minimum, const void* x, void* out,
                            const int* off, const int64_t* delta,
                            const void* sval, const Nd& p,
                            long long cval_bits, cudaStream_t s) {
  unsigned blocks;
  if (!blocks_for(p.total, &blocks)) return cudaErrorInvalidConfiguration;
  const W cval = from_bits<W>(cval_bits);
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  const W* sv = static_cast<const W*>(sval);
  if (minimum)
    min_max_nd_kernel<T, W, true, NONFLAT, false>
        <<<blocks, ED_THREADS, 0, s>>>(xi, o, off, delta, sv, p, cval,
                                       nullptr, nullptr);
  else
    min_max_nd_kernel<T, W, false, NONFLAT, false>
        <<<blocks, ED_THREADS, 0, s>>>(xi, o, off, delta, sv, p, cval,
                                       nullptr, nullptr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_nd(bool minimum, bool nonflat, const void* x, void* out,
                      const int* off, const int64_t* delta, const void* sval,
                      const Nd& p, long long cval_bits, cudaStream_t s) {
  if (!nonflat)
    return launch_nd_typed<T, T, false>(minimum, x, out, off, delta, sval, p,
                                        cval_bits, s);
  if constexpr (std::is_floating_point<T>::value)
    return launch_nd_typed<T, T, true>(minimum, x, out, off, delta, sval, p,
                                       cval_bits, s);
  else
    return launch_nd_typed<T, double, true>(minimum, x, out, off, delta, sval,
                                            p, cval_bits, s);
}

template <typename T>
cudaError_t launch_rank(const void* x, void* out, const int* off,
                        const int64_t* delta, const uint8_t* pairs,
                        int npairs, int wires, int rank, const Nd& p,
                        long long cval_bits, long long pad_bits,
                        cudaStream_t s) {
  unsigned blocks;
  if (!blocks_for(p.total, &blocks)) return cudaErrorInvalidConfiguration;
  const T cval = from_bits<T>(cval_bits);
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (wires > 0)
    rank_network_kernel<T><<<blocks, ED_THREADS, 0, s>>>(
        xi, o, off, delta, pairs, npairs, wires, rank, from_bits<T>(pad_bits),
        p, cval);
  else
    rank_select_kernel<T><<<blocks, ED_THREADS, 0, s>>>(xi, o, off, delta,
                                                        rank, p, cval);
  return cudaGetLastError();
}

Nd make_nd(int ndim, const long long* shape, const int* lo, const int* hi,
           int taps, int mode) {
  Nd p;
  p.ndim = ndim;
  p.taps = taps;
  p.mode = mode;
  p.total = 1;
  for (int d = ED_MORPH_MAXR - 1; d >= 0; --d) {
    const bool used = d < ndim;
    p.n[d] = used ? shape[d] : 1;
    p.stride[d] = p.total;
    p.total *= p.n[d];
    p.lo[d] = used ? lo[d] : 0;
    p.hi[d] = used ? hi[d] : 0;
  }
  return p;
}

bool bad_nd(int ndim, int taps, int mode) {
  return ndim < 1 || ndim > ED_MORPH_MAXR || taps < 0 || mode < 0 ||
         mode > 4;
}

// raise a kernel's dynamic shared memory limit once to what a launch needs
template <typename K>
cudaError_t allow_smem(K kernel, int* allowed, int bytes) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <typename T, bool MIN>
cudaError_t launch_box_k(const void* x, void* out, const MinMaxBox& p,
                         long long cval_bits, int smem, unsigned blocks,
                         cudaStream_t s) {
  static int allowed = 0;
  auto kern = min_max_box_kernel<T, MIN>;
  const cudaError_t err = allow_smem(kern, &allowed, smem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, ED_THREADS, (size_t)smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), p,
      from_bits<T>(cval_bits));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_box(bool minimum, const void* x, void* out,
                       const MinMaxBox& p, long long cval_bits, int smem,
                       unsigned blocks, cudaStream_t s) {
  return minimum ? launch_box_k<T, true>(x, out, p, cval_bits, smem, blocks, s)
                 : launch_box_k<T, false>(x, out, p, cval_bits, smem, blocks,
                                          s);
}

// The shared row stride of K10's box: the box's row of `len` elements of
// `item` bytes padded to an odd number of 32-bit words (8-byte elements:
// an odd number of elements), so that neighbouring rows start on other
// banks (ops/morphology.py:_box_row_stride).
int box_row_stride(int len, int item) {
  int p2 = len;
  while (item <= 4 ? (p2 * item % 4 != 0 || p2 * item / 4 % 2 == 0)
                   : p2 % 2 == 0)
    ++p2;
  return p2;
}

// K10's box geometry from the plan's host arrays; false where it does not
// fit the shapes (a sample past int32, a box over the shared memory,
// another grid than the tiles times the batch).
bool make_box(MinMaxBox* p, int item, const int* n3, const long long* st3,
              const int* k3, const int* c3, const int* mode3,
              const int* tile3, int npass, const int* pass, int nb,
              const long long* bn, const long long* bst, int smem,
              long long blocks) {
  if (npass < 1 || npass > 3 || nb < 0 || nb > ED_MORPH_MAXR) return false;
  int64_t span = 0, count = 1;
  bool seen[3] = {false, false, false};
  for (int q = 0; q < npass; ++q) {
    if (pass[q] < 0 || pass[q] > 2 || seen[pass[q]] || k3[pass[q]] < 2)
      return false;
    seen[pass[q]] = true;
  }
  p->npass = npass;
  p->nb = nb;
  for (int d = 0; d < 3; ++d) {
    if (n3[d] < 1 || st3[d] < 0 || k3[d] < 1 || c3[d] < 0 ||
        c3[d] >= k3[d] || mode3[d] < 0 || mode3[d] > 4 || tile3[d] < 1 ||
        (k3[d] > 1) != seen[d])
      return false;
    p->n[d] = n3[d];
    p->st[d] = n3[d] > 1 ? (int)st3[d] : 0;  // (within int32: span below)
    p->c[d] = c3[d];
    p->mode[d] = mode3[d];
    p->tile[d] = tile3[d];
    p->box[d] = tile3[d] + k3[d] - 1;
    p->tiles[d] = (n3[d] + tile3[d] - 1) / tile3[d];
    span += (int64_t)(n3[d] - 1) * st3[d];
    count *= p->tiles[d];
  }
  for (int a = 0; a < ED_MORPH_MAXR; ++a) {
    p->bn[a] = a < nb ? (int)bn[a] : 1;
    p->bst[a] = a < nb ? bst[a] : 0;
    if (a < nb && (bn[a] < 1 || bn[a] > INT32_MAX)) return false;
    count *= p->bn[a];
  }
  p->p2 = box_row_stride(p->box[2], item);
  p->granules = (15 + p->box[2] * item + 15) / 16;
  p->dg = make_div((unsigned)p->granules);
  p->d1 = make_div((unsigned)p->box[1]);
  // each pass over the region its predecessors left: lines along its axis
  // d, the fast axis 2 (1 for a pass along 2), the slow one 1 (0 for a
  // pass along 1 or 2)
  int e[3] = {p->box[0], p->box[1], p->box[2]};
  const int st[3] = {p->box[1] * p->p2, p->p2, 1};
  for (int q = 0; q < npass; ++q) {
    const int d = pass[q], fa = d == 2 ? 1 : 2, sa = d == 0 ? 1 : 0;
    MinMaxBox::Pass& bp = p->pass[q];
    bp.k = k3[d];
    bp.nf = e[fa];
    bp.ns = e[sa];
    bp.ned = e[d];
    bp.sf = st[fa];
    bp.ss = st[sa];
    bp.sd = st[d];
    bp.af = fa;
    bp.as = sa;
    bp.ad = d;
    bp.df = make_div((unsigned)bp.nf);
    bp.ds = make_div((unsigned)bp.ns);
    e[d] = p->tile[d];
  }
  const int64_t need = 2 * (int64_t)p->box[0] * p->box[1] * p->p2 * item;
  return span <= INT32_MAX && need == smem && smem <= ED_SMEM_LIMIT &&
         count == blocks && blocks <= INT32_MAX;
}

template <typename T, int C>
cudaError_t launch_rank_tile_c(const void* x, void* out, const int* toff,
                               const RankTile& p, long long cval_bits,
                               int smem, unsigned blocks, cudaStream_t s) {
  static int allowed = 0;
  auto kern = rank_select_tile_kernel<T, C>;
  const cudaError_t err = allow_smem(kern, &allowed, smem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, dim3(ED_RANK_TX, ED_RANK_TY), (size_t)smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), toff, p,
      from_bits<T>(cval_bits));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rank_tile(int column, const void* x, void* out,
                             const int* toff, const RankTile& p,
                             long long cval_bits, int smem, unsigned blocks,
                             cudaStream_t s) {
  if (column == 1)
    return launch_rank_tile_c<T, 1>(x, out, toff, p, cval_bits, smem, blocks,
                                    s);
  if (column == 4)
    return launch_rank_tile_c<T, 4>(x, out, toff, p, cval_bits, smem, blocks,
                                    s);
  return cudaErrorInvalidValue;
}

template <typename T, int N>
cudaError_t launch_net_tile_n(const void* x, void* out, const int* toff,
                              const RankTile& p, int column,
                              long long cval_bits, long long pad_bits,
                              int smem, unsigned blocks, cudaStream_t s) {
  static int allowed = 0;
  auto kern = rank_network_tile_kernel<T, N>;
  const cudaError_t err = allow_smem(kern, &allowed, smem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, dim3(ED_RANK_TX, ED_RANK_TY), (size_t)smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), toff, p, column,
      from_bits<T>(cval_bits), from_bits<T>(pad_bits));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_net_tile(int wires, const void* x, void* out,
                            const int* toff, const RankTile& p, int column,
                            long long cval_bits, long long pad_bits,
                            int smem, unsigned blocks, cudaStream_t s) {
  switch (wires) {
    case 4:
      return launch_net_tile_n<T, 4>(x, out, toff, p, column, cval_bits,
                                     pad_bits, smem, blocks, s);
    case 8:
      return launch_net_tile_n<T, 8>(x, out, toff, p, column, cval_bits,
                                     pad_bits, smem, blocks, s);
    case 16:
      return launch_net_tile_n<T, 16>(x, out, toff, p, column, cval_bits,
                                      pad_bits, smem, blocks, s);
    case 32:
      return launch_net_tile_n<T, 32>(x, out, toff, p, column, cval_bits,
                                      pad_bits, smem, blocks, s);
    case 64:
      return launch_net_tile_n<T, 64>(x, out, toff, p, column, cval_bits,
                                      pad_bits, smem, blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename W, bool MIN, bool NONFLAT, int C>
cudaError_t launch_min_max_tile_k(const void* x, void* out, const int* toff,
                                  const void* sval, const RankTile& p,
                                  long long cval_bits, int smem,
                                  unsigned blocks, cudaStream_t s) {
  static int allowed = 0;
  auto kern = min_max_tile_kernel<T, W, MIN, NONFLAT, C>;
  const cudaError_t err = allow_smem(kern, &allowed, smem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, dim3(ED_RANK_TX, ED_RANK_TY), (size_t)smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), toff,
      static_cast<const W*>(sval), p, from_bits<W>(cval_bits));
  return cudaGetLastError();
}

template <typename T, typename W, bool NONFLAT>
cudaError_t launch_min_max_tile_w(bool minimum, int column, const void* x,
                                  void* out, const int* toff,
                                  const void* sval, const RankTile& p,
                                  long long cval_bits, int smem,
                                  unsigned blocks, cudaStream_t s) {
  constexpr int C = ED_MINMAX_COLUMN;
  if (column == 1)
    return minimum ? launch_min_max_tile_k<T, W, true, NONFLAT, 1>(
                         x, out, toff, sval, p, cval_bits, smem, blocks, s)
                   : launch_min_max_tile_k<T, W, false, NONFLAT, 1>(
                         x, out, toff, sval, p, cval_bits, smem, blocks, s);
  if (column == C)
    return minimum ? launch_min_max_tile_k<T, W, true, NONFLAT, C>(
                         x, out, toff, sval, p, cval_bits, smem, blocks, s)
                   : launch_min_max_tile_k<T, W, false, NONFLAT, C>(
                         x, out, toff, sval, p, cval_bits, smem, blocks, s);
  return cudaErrorInvalidValue;
}

// K11's tile route; the work type W as launch_nd takes it
template <typename T>
cudaError_t launch_min_max_tile(bool minimum, bool nonflat, int column,
                                const void* x, void* out, const int* toff,
                                const void* sval, const RankTile& p,
                                long long cval_bits, int smem,
                                unsigned blocks, cudaStream_t s) {
  if (!nonflat)
    return launch_min_max_tile_w<T, T, false>(minimum, column, x, out, toff,
                                              sval, p, cval_bits, smem,
                                              blocks, s);
  if constexpr (std::is_floating_point<T>::value)
    return launch_min_max_tile_w<T, T, true>(minimum, column, x, out, toff,
                                             sval, p, cval_bits, smem, blocks,
                                             s);
  else
    return launch_min_max_tile_w<T, double, true>(minimum, column, x, out,
                                                  toff, sval, p, cval_bits,
                                                  smem, blocks, s);
}

// The halo-box tile geometry of K11's tile route and K12's select tile from
// the plan's host arrays (ed_rank_select_tile); the box's cells in *cells;
// false where the plan does not fit the shapes (a sample or a box past
// int32, more blocks than a grid takes).
bool make_rank_tile(RankTile* p, int column, const int* n3,
                    const long long* st3, const int* k3, const int* c3,
                    int nb, const long long* bn, const long long* bst,
                    int taps, int mode, long long blocks, int64_t* cells) {
  if (taps < 1 || mode < 0 || mode > 4 || nb < 0 || nb > ED_MORPH_MAXR)
    return false;
  const int tile[3] = {column, ED_RANK_TY, ED_RANK_TX};
  p->taps = taps;
  p->rank = 0;
  p->mode = mode;
  p->nb = nb;
  int64_t span = 0, count = 1;
  *cells = 1;
  for (int d = 0; d < 3; ++d) {
    if (n3[d] < 1 || st3[d] < 0 || k3[d] < 1 || c3[d] < 0 || c3[d] >= k3[d])
      return false;
    p->n[d] = n3[d];
    p->st[d] = n3[d] > 1 ? (int)st3[d] : 0;  // (within int32: span below)
    p->c[d] = c3[d];
    p->box[d] = tile[d] + k3[d] - 1;
    p->tiles[d] = (n3[d] + tile[d] - 1) / tile[d];
    span += (int64_t)(n3[d] - 1) * st3[d];
    count *= p->tiles[d];
    *cells *= p->box[d];
  }
  for (int a = 0; a < ED_MORPH_MAXR; ++a) {
    p->bn[a] = a < nb ? (int)bn[a] : 1;
    p->bst[a] = a < nb ? bst[a] : 0;
    if (a < nb && (bn[a] < 1 || bn[a] > INT32_MAX)) return false;
    count *= p->bn[a];
  }
  return span <= INT32_MAX && *cells <= INT32_MAX && count == blocks &&
         blocks <= INT32_MAX;
}

template <bool DIL, bool BYTES>
cudaError_t launch_tile(const void* x, void* out, const void* mask,
                        const int* taps, const BinTile& p, unsigned border,
                        int* changed, int smem, cudaStream_t s) {
  static int allowed = 0;
  const cudaError_t err =
      allow_smem(binary_tile_kernel<DIL, BYTES>, &allowed, smem);
  if (err != cudaSuccess) return err;
  binary_tile_kernel<DIL, BYTES>
      <<<(unsigned)p.gz * p.gy * p.gw, ED_BIN_THREADS, smem, s>>>(
          x, out, mask, taps, p, border, changed);
  return cudaGetLastError();
}

unsigned word_blocks(int64_t nwords) {
  // a warp a word, at most 16 blocks of 8 warps on each of 132 SMs
  const int64_t want = (nwords + 7) / 8;
  return (unsigned)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

}  // namespace

// the eleven element types: 0 bool, 1 uint8, 2 int8, 3 uint16, 4 int16,
// 5 uint32, 6 int32, 7 uint64, 8 int64, 9 float32, 10 float64
static const int kItemsize[11] = {1, 1, 1, 2, 2, 4, 4, 8, 8, 4, 8};
#define ED_DISPATCH(dtype, ...)          \
  switch (dtype) {                       \
    case 0: {                            \
      typedef bool T;                    \
      return (int)(__VA_ARGS__);         \
    }                                    \
    case 1: {                            \
      typedef uint8_t T;                 \
      return (int)(__VA_ARGS__);         \
    }                                    \
    case 2: {                            \
      typedef int8_t T;                  \
      return (int)(__VA_ARGS__);         \
    }                                    \
    case 3: {                            \
      typedef uint16_t T;                \
      return (int)(__VA_ARGS__);         \
    }                                    \
    case 4: {                            \
      typedef int16_t T;                 \
      return (int)(__VA_ARGS__);         \
    }                                    \
    case 5: {                            \
      typedef uint32_t T;                \
      return (int)(__VA_ARGS__);         \
    }                                    \
    case 6: {                            \
      typedef int32_t T;                 \
      return (int)(__VA_ARGS__);         \
    }                                    \
    case 7: {                            \
      typedef uint64_t T;                \
      return (int)(__VA_ARGS__);         \
    }                                    \
    case 8: {                            \
      typedef int64_t T;                 \
      return (int)(__VA_ARGS__);         \
    }                                    \
    case 9: {                            \
      typedef float T;                   \
      return (int)(__VA_ARGS__);         \
    }                                    \
    case 10: {                           \
      typedef double T;                  \
      return (int)(__VA_ARGS__);         \
    }                                    \
    default:                             \
      return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// K10 on a contiguous tensor viewed as (outer, n, inner). mode: 0 nearest,
// 1 wrap, 2 reflect, 3 mirror, 4 constant; cval_bits: cval in x's type, in
// the low bytes. x and out must not overlap. Returns cudaGetLastError().
int ed_min_max_filter1d(int dtype, int minimum, const void* x, void* out,
                        long long outer, long long n, long long inner,
                        int size, int center, int mode, long long cval_bits,
                        void* stream) {
  if (size < 1 || center < 0 || center >= size || mode < 0 || mode > 4)
    return (int)cudaErrorInvalidValue;
  if (outer * n * inner == 0) return 0;
  Line p;
  p.outer = outer;
  p.n = n;
  p.inner = inner;
  p.size = size;
  p.center = center;
  p.mode = mode;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ED_DISPATCH(dtype, launch_1d<T>(minimum != 0, x, out, p, cval_bits, s))
}

// K10's box route (ops/morphology.py:_box_plan): every pass of a separable
// box in one launch. Host arrays: per tile axis its extent n3, stride st3,
// the box's extent k3 (1 off the box), centre c3 and mode mode3 (0-4, as
// ed_min_max_filter1d), the output tile tile3; the passes' tile axes in
// order (npass of them, each with k3 > 1); the batch axes the grid walks
// (nb, bn, bst). cval_bits: cval in x's type. smem: two buffers of the
// box at its padded row stride; blocks: the tiles times the batch. A plan
// that does not fit the shapes is refused with cudaErrorInvalidValue. x
// and out must not overlap. Returns cudaGetLastError().
int ed_min_max_box(int dtype, int minimum, const void* x, void* out,
                   const int* n3, const long long* st3, const int* k3,
                   const int* c3, const int* mode3, const int* tile3,
                   int npass, const int* pass, int nb, const long long* bn,
                   const long long* bst, long long cval_bits, int smem,
                   long long blocks, void* stream) {
  MinMaxBox p;
  if (dtype < 0 || dtype > 10 ||
      !make_box(&p, kItemsize[dtype], n3, st3, k3, c3, mode3, tile3, npass,
                pass, nb, bn, bst, smem, blocks))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ED_DISPATCH(dtype, launch_box<T>(minimum != 0, x, out, p, cval_bits, smem,
                                   (unsigned)blocks, s))
}

// K11 on a contiguous tensor of ndim <= 8 axes with shape[ndim] (host).
// Device arrays: off[taps * ndim] (tap offsets from the centre), delta[taps]
// (the same, linear); sval[taps] the structure values in the work type when
// nonflat (x's type for float32 / float64, else float64). lo / hi (host): the
// least and greatest offset per axis. cval_bits: cval in the work type.
int ed_min_max_filter(int dtype, int minimum, int nonflat, const void* x,
                      void* out, const void* off, const void* delta,
                      const void* sval, int ndim, const long long* shape,
                      const int* lo, const int* hi, int taps, int mode,
                      long long cval_bits, void* stream) {
  if (bad_nd(ndim, taps, mode) || taps < 1 || (nonflat && sval == nullptr))
    return (int)cudaErrorInvalidValue;
  const Nd p = make_nd(ndim, shape, lo, hi, taps, mode);
  if (p.total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* of = static_cast<const int*>(off);
  const int64_t* de = static_cast<const int64_t*>(delta);
  ED_DISPATCH(dtype, launch_nd<T>(minimum != 0, nonflat != 0, x, out, of, de,
                                  sval, p, cval_bits, s))
}

// K12, geometry as ed_min_max_filter. wires > 0 takes the network route over
// that many wires (taps <= wires <= 64): pairs (device, uint8, 2 * npairs) is
// its comparator list, pad_bits the pad wires' value; wires == 0 takes the
// select route.
int ed_rank_filter(int dtype, const void* x, void* out, const void* off,
                   const void* delta, const void* pairs, int npairs,
                   int wires, int rank, int ndim, const long long* shape,
                   const int* lo, const int* hi, int taps, int mode,
                   long long cval_bits, long long pad_bits, void* stream) {
  if (bad_nd(ndim, taps, mode) || taps < 1 || rank < 0 || rank >= taps ||
      wires < 0 || (wires > 0 && (wires < taps || wires > ED_MAX_WIRES)) ||
      (npairs > 0 && pairs == nullptr))
    return (int)cudaErrorInvalidValue;
  const Nd p = make_nd(ndim, shape, lo, hi, taps, mode);
  if (p.total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* of = static_cast<const int*>(off);
  const int64_t* de = static_cast<const int64_t*>(delta);
  const uint8_t* pr = static_cast<const uint8_t*>(pairs);
  ED_DISPATCH(dtype, launch_rank<T>(x, out, of, de, pr, npairs, wires, rank,
                                    p, cval_bits, pad_bits, s))
}

// K12's select route on a halo box, with the plan of
// ops/morphology.py:_rank_plan. Host arrays: per tile axis (3) its extent
// n3, element stride st3, footprint extent k3 and centre c3; the nb batch
// axes the grid walks, extents bn and strides bst. Device: toff[taps], each
// tap's offset into the box, in raster order. column: C, the voxels a
// thread keeps along tile axis 0 (1 or 4); smem: the plan's shared bytes,
// at least the box's keys and values and the taps; blocks: the tiles times
// the batch. cval_bits: cval in x's type. A plan that does not fit the
// shapes is refused with cudaErrorInvalidValue. x and out must not overlap.
// Returns cudaGetLastError().
int ed_rank_select_tile(int dtype, int column, const void* x, void* out,
                        const void* toff, const int* n3,
                        const long long* st3, const int* k3, const int* c3,
                        int nb, const long long* bn, const long long* bst,
                        int taps, int rank, int mode, long long cval_bits,
                        int smem, long long blocks, void* stream) {
  RankTile p;
  int64_t cells;
  if (dtype < 0 || dtype > 10 || rank < 0 || rank >= taps ||
      (column != 1 && column != 4) ||
      !make_rank_tile(&p, column, n3, st3, k3, c3, nb, bn, bst, taps, mode,
                      blocks, &cells))
    return (int)cudaErrorInvalidValue;
  p.rank = rank;
  const int64_t need = ((2 * cells * kItemsize[dtype] + 3) & ~(int64_t)3) +
                       4 * (int64_t)taps;
  if (smem < need || smem > ED_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* to = static_cast<const int*>(toff);
  ED_DISPATCH(dtype, launch_rank_tile<T>(column, x, out, to, p, cval_bits,
                                         smem, (unsigned)blocks, s))
}

// K12's network route on a halo box, with the plan of
// ops/morphology.py:_rank_plan ("network_tile"): the host arrays of
// ed_rank_select_tile; wires N (4, 8, 16, 32 or 64, taps <= N < 2 taps)
// and column C (1 or ED_NET_COLUMN); device: toff[taps], each tap's offset
// into the box in raster order; smem: the plan's shared bytes, at least the
// box's values and N offsets. cval_bits: cval in x's type; pad_bits:
// the pad wires' value, the type's largest. A plan that does not fit the
// shapes is refused with cudaErrorInvalidValue. x and out must not
// overlap. Returns cudaGetLastError().
int ed_rank_network_tile(int dtype, int wires, int column, const void* x,
                         void* out, const void* toff,
                         const int* n3, const long long* st3, const int* k3,
                         const int* c3, int nb, const long long* bn,
                         const long long* bst, int taps, int rank, int mode,
                         long long cval_bits, long long pad_bits, int smem,
                         long long blocks, void* stream) {
  RankTile p;
  int64_t cells;
  if (dtype < 0 || dtype > 10 ||
      (wires != 4 && wires != 8 && wires != 16 && wires != 32 &&
       wires != 64) ||
      taps > wires || 2 * taps <= wires || rank < 0 || rank >= taps ||
      (column != 1 && column != ED_NET_COLUMN) ||
      !make_rank_tile(&p, column, n3, st3, k3, c3, nb, bn, bst, taps, mode,
                      blocks, &cells))
    return (int)cudaErrorInvalidValue;
  p.rank = rank;
  const int64_t need = ((cells * kItemsize[dtype] + 3) & ~(int64_t)3) +
                       4 * (int64_t)wires;
  if (smem < need || smem > ED_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* to = static_cast<const int*>(toff);
  ED_DISPATCH(dtype, launch_net_tile<T>(wires, x, out, to, p, column,
                                        cval_bits, pad_bits, smem,
                                        (unsigned)blocks, s))
}

// K11 on its tile route, with the plan of ops/morphology.py:_min_max_plan:
// the host arrays of ed_rank_select_tile; device: toff[taps], each tap's
// offset into the box in raster order, and sval[taps] as ed_min_max_filter
// takes it when nonflat. column: C, 1 or ED_MINMAX_COLUMN; smem: the plan's
// shared bytes, at least the box in the work type, the structure's values
// and the offsets; cval_bits: cval in the work type. A plan that does not
// fit the shapes is refused with cudaErrorInvalidValue. x and out must not
// overlap. Returns cudaGetLastError().
int ed_min_max_tile(int dtype, int minimum, int nonflat, int column,
                    const void* x, void* out, const void* toff,
                    const void* sval, const int* n3, const long long* st3,
                    const int* k3, const int* c3, int nb, const long long* bn,
                    const long long* bst, int taps, int mode,
                    long long cval_bits, int smem, long long blocks,
                    void* stream) {
  RankTile p;
  int64_t cells;
  if (dtype < 0 || dtype > 10 || (nonflat && sval == nullptr) ||
      (column != 1 && column != ED_MINMAX_COLUMN) ||
      !make_rank_tile(&p, column, n3, st3, k3, c3, nb, bn, bst, taps, mode,
                      blocks, &cells))
    return (int)cudaErrorInvalidValue;
  // the work type: float64 for a non-flat structure on integers and bool
  const int work = nonflat && dtype < 9 ? 8 : kItemsize[dtype];
  const int64_t need =
      (((cells + (nonflat ? taps : 0)) * work + 3) & ~(int64_t)3) +
      4 * (int64_t)taps;
  if (smem < need || smem > ED_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* to = static_cast<const int*>(toff);
  ED_DISPATCH(dtype, launch_min_max_tile<T>(minimum != 0, nonflat != 0,
                                            column, x, out, to, sval, p,
                                            cval_bits, smem, (unsigned)blocks,
                                            s))
}

// K13 on contiguous bool tensors, geometry as ed_min_max_filter (taps may be
// 0); mask (bool, x's shape) and changed (one int32) may be NULL.
int ed_binary_step(const void* x, void* out, const void* mask, const void* off,
                   const void* delta, void* changed, int ndim,
                   const long long* shape, const int* lo, const int* hi,
                   int taps, int border, int dilation, void* stream) {
  if (bad_nd(ndim, taps, F_CONSTANT)) return (int)cudaErrorInvalidValue;
  const Nd p = make_nd(ndim, shape, lo, hi, taps, F_CONSTANT);
  if (p.total == 0) return 0;
  unsigned blocks;
  if (!blocks_for(p.total, &blocks))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool* xi = static_cast<const bool*>(x);
  bool* o = static_cast<bool*>(out);
  const int* of = static_cast<const int*>(off);
  const int64_t* de = static_cast<const int64_t*>(delta);
  const bool* m = static_cast<const bool*>(mask);
  int* ch = static_cast<int*>(changed);
  if (dilation)
    min_max_nd_kernel<bool, bool, false, false, true>
        <<<blocks, ED_THREADS, 0, s>>>(xi, o, of, de, nullptr, p,
                                       border != 0, m, ch);
  else
    min_max_nd_kernel<bool, bool, true, false, true>
        <<<blocks, ED_THREADS, 0, s>>>(xi, o, of, de, nullptr, p,
                                       border != 0, m, ch);
  return (int)cudaGetLastError();
}

// K13's tile route: k <= 8 sweeps of an (nz, ny, nx) array (a shorter
// array with leading axes of 1), tiles of tz x ty voxels x tw words, one
// sweep's reach rz, ry voxels and rx <= 32 voxels along the innermost axis.
// taps (device, nrows + ntaps ints): the structure's nrows row codes (oz,
// oy as signed bytes in bits 24-31 and 16-23, the row's tap count in bits
// 1-8, bit 0 set where a tap has dx != 0), then its ntaps dx values, row
// by row. bytes_io: x, out and mask are bool bytes;
// else x and out are packed int32 words of (nz, ny, ceil(nx / 32)) whose
// pad bits hold border, mask packed words with zero pad bits. mask and
// changed may be NULL; x and out must not overlap.
int ed_binary_tile(const void* x, void* out, const void* mask,
                   const void* taps, void* changed, int bytes_io, int nz,
                   int ny, int nx, int tz, int ty, int tw, int rz, int ry,
                   int rx, int k, int nrows, int ntaps, int border,
                   int dilation, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || tz < 1 || ty < 1 || tw < 1 || rz < 0 ||
      ry < 0 || rx < 0 || rx > 32 || rz > 127 || ry > 127 || k < 1 ||
      k > ED_BIN_MAX_SWEEPS || ntaps < 0 || ntaps > ED_BIN_MAX_TAPS ||
      nrows < 0 || nrows > ntaps || (nrows == 0) != (ntaps == 0) ||
      (ntaps > 0 && taps == nullptr))
    return (int)cudaErrorInvalidValue;
  BinTile p;
  p.nz = nz;
  p.ny = ny;
  p.nx = nx;
  p.nw = (nx + 31) / 32;
  p.tz = tz;
  p.ty = ty;
  p.tw = tw;
  p.gz = (nz + tz - 1) / tz;
  p.gy = (ny + ty - 1) / ty;
  p.gw = (p.nw + tw - 1) / tw;
  p.rz = rz;
  p.ry = ry;
  p.rw = rx > 0 ? 1 : 0;
  p.k = k;
  p.nrows = nrows;
  p.ntaps = ntaps;
  p.bz = std::min(nz, tz + 2 * k * rz);
  p.by = std::min(ny, ty + 2 * k * ry);
  p.bw = std::min(p.nw, tw + 2 * k * p.rw);
  const int64_t blocks = (int64_t)p.gz * p.gy * p.gw;
  const int64_t smem =
      (3 * (int64_t)p.bz * p.by * p.bw + nrows + ntaps) * 4;
  if (blocks > INT32_MAX || smem > ED_SMEM_LIMIT)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tp = static_cast<const int*>(taps);
  int* ch = static_cast<int*>(changed);
  const unsigned bd = border ? 1u : 0u;
  const int sm = (int)smem;
  if (dilation)
    return (int)(bytes_io ? launch_tile<true, true>(x, out, mask, tp, p, bd,
                                                    ch, sm, s)
                          : launch_tile<true, false>(x, out, mask, tp, p, bd,
                                                     ch, sm, s));
  return (int)(bytes_io ? launch_tile<false, true>(x, out, mask, tp, p, bd,
                                                   ch, sm, s)
                        : launch_tile<false, false>(x, out, mask, tp, p, bd,
                                                    ch, sm, s));
}

// bool bytes (lines, nx) into packed int32 words (lines, ceil(nx / 32)),
// the pad bits set to border (pack = 1), or back (pack = 0)
int ed_binary_pack(void* bytes, void* words, long long lines, int nx,
                   int border, int pack, void* stream) {
  if (lines < 0 || nx < 1) return (int)cudaErrorInvalidValue;
  const int nw = (nx + 31) / 32;
  const int64_t nwords = (int64_t)lines * nw;
  if (nwords == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pack)
    binary_pack_kernel<<<word_blocks(nwords), ED_PACK_THREADS, 0, s>>>(
        static_cast<const uint8_t*>(bytes), static_cast<unsigned*>(words),
        nwords, nx, nw, border);
  else
    binary_unpack_kernel<<<word_blocks(nwords), ED_PACK_THREADS, 0, s>>>(
        static_cast<const unsigned*>(words), static_cast<uint8_t*>(bytes),
        nwords, nx, nw);
  return (int)cudaGetLastError();
}

const char* ed_morphology_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
