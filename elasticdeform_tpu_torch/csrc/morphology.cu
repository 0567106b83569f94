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
//
// K11 replaces morphology.py:196-230, the tap loop of min_max_filter: the min
// or max over an N-D footprint's taps (raster order), for a non-flat structure
// of x - s[t] (erosion) or x + s[t] (dilation) in the work type, which is x's
// for floats and float64 for integers and bool; the float64 result is then
// cast as XLA casts it: NaN to 0, truncated, saturated at the type's range
// (bool: != 0).
//
// K12 replaces morphology.py:302-321 _rank_select and :373 jnp.sort: the
// rank-th smallest footprint tap. Up to 64 taps it runs the same pruned
// Batcher comparator list (_rank_network, built on the host) over wires padded
// at the type's largest value, each comparator a NaN-propagating min/max pair,
// so a window holding a NaN gives NaN; above 64 taps a per-thread radix
// select over order-preserving keys orders NaN last and -0 as +0, and picks
// among equal keys in tap order, as the stable sort does. The cap is kept
// because it decides the NaN result.
//
// K13 replaces morphology.py:452-515, _binary_step under fori_loop /
// while_loop: one AND (erosion) or OR (dilation) sweep of a boolean array over
// the structure's taps, border_value beyond the edge, mask-gated (a voxel
// outside the mask keeps its value); it sets *changed when a voxel changed.
// It is K11's kernel on bool (AND is min, OR is max, border_value the cval)
// with the gate, the flag and an exit at the first deciding tap. The caller
// iterates it (Jacobi: each sweep reads the previous array) and reads the
// flag every few sweeps: a fixpoint is absorbing.
//
// Min and max propagate NaN and order -0 below +0 as jnp.minimum /
// jnp.maximum do: the comparison is written out, never fminf / fmaxf, which
// return the other operand of a NaN.
//
// Layout and bound on the H100: one thread per output element, neighbouring
// threads on neighbouring addresses (the innermost index), so every tap's
// loads coalesce; the taps' reuse is served by L1. Interior elements (every
// tap inside the array) take a path with no fold. K10, K11 and K13 are bound
// by bytes (each input read once, each output written once over 3.35 TB/s);
// K12 by the comparisons a selection of that rank needs per voxel
// (quickselect's expected count, about 3.4 per tap for a median) at the
// card's operation rate, or by bytes, whichever is larger. Selections copy
// values, so every kernel agrees with its plain twin (ops/morphology.py) bit
// for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#define ED_MORPH_MAXR 8
#define ED_THREADS 256
#define ED_MAX_WIRES 64

namespace {

enum { F_NEAREST = 0, F_WRAP = 1, F_REFLECT = 2, F_MIRROR = 3, F_CONSTANT = 4 };

// index j folded into [0, n) by the filter mode (ops/filters.py
// _fold_index); -1 for a sample beyond the edge in constant mode
__device__ __forceinline__ int64_t fold(int64_t j, int64_t n, int mode) {
  if (j >= 0 && j < n) return j;
  switch (mode) {
    case F_NEAREST:
      return j < 0 ? 0 : n - 1;
    case F_WRAP: {
      const int64_t m = j % n;
      return m < 0 ? m + n : m;
    }
    case F_REFLECT: {
      const int64_t per = 2 * n;
      int64_t m = j % per;
      if (m < 0) m += per;
      return m < n ? m : per - 1 - m;
    }
    case F_MIRROR: {
      if (n == 1) return 0;
      const int64_t per = 2 * n - 2;
      int64_t m = j % per;
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
      const int64_t f = fold(j0 + k, p.n, p.mode);
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
      const int64_t f = fold(idx[d] + off[t * p.ndim + d], p.n[d], p.mode);
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

}  // namespace

// the eleven element types: 0 bool, 1 uint8, 2 int8, 3 uint16, 4 int16,
// 5 uint32, 6 int32, 7 uint64, 8 int64, 9 float32, 10 float64
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

const char* ed_morphology_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
