// K8 correlate1d, K8T correlate1d_transpose, K9 correlate_nd and K9T
// correlate_nd_transpose: the linear ndimage filter tier (SciPy's
// correlate1d / correlate with the filter boundary modes) and the exact
// transposes its gradient needs.
//
// K8 replaces the JAX package's elasticdeform_tpu/ops/filters.py:125
// apply_matrix1d with :83 filter_matrix (a dense banded n x n matrix per
// axis, the boundary fold in its edge columns, applied by a HIGHEST
// tensordot on the TPU's matrix unit) and :194 apply_paired1d (SciPy's paired
// summation, for integer outputs). Here it is a stencil:
//   out[i] = sum_k w[k] * x[fold(i + k - c)],  k = 0..L-1,
// along one axis of a contiguous tensor viewed as (outer, n, inner), with
// fold() the five filter modes and cval for a constant-mode tap beyond the
// edge; any L, also longer than the axis (the fold then repeats). Two orders,
// chosen per launch: the direct one, acc = x_0 w_0, then acc + x_k w_k; and
// the paired one, acc = x_s w_s, then acc + (x_{s-i} +- x_{s+i}) w_{s-i} for
// i = s..1, s = L/2. Plain twin: ops/filters.py correlate1d_plain, the same
// order over slices of the padded line.
//
// K8T replaces the transpose JAX gets by autodiff of that tensordot: the
// correlation with the flipped taps into the padded extent [-c, n + L-1-c),
// P(p) = sum_k w[k] g[p + c - k] over the k that land inside, then each pad
// folded back: x_bar[j] = P(j) + sum of P(p) over the pads p that fold onto j
// (a host-built per-position list; constant mode drops the pads). A gather:
// no atomics. Twin: correlate1d_transpose_plain.
//
// K9 replaces ops/filters.py:317 apply_correlate (all three of its branches:
// the stacked banded matrices, the unrolled slice sum, the VALID convolution):
// the N-D correlation over the kernel's nonzero taps in raster order, with
// the fold on every axis and cval in constant mode; convolution is the flipped
// kernel with mirrored origins, done by the caller. Runs of axes where the
// kernel has extent 1 (batch axes) are merged by the caller; at most
// ED_FILTER_MAXR axes remain. K9T is its transpose, the N-D form of K8T: for
// output j, the sum over the product of the per-axis fold lists of P(p), the
// flipped-kernel correlation of g at padded position p. Twins:
// correlate_nd_plain and correlate_nd_transpose_plain.
//
// Layout and bound on the H100: one thread per output element, neighbouring
// threads on neighbouring addresses (the innermost index), so every tap's
// loads coalesce on any axis; the taps' reuse is served by L1. When the
// filtered axis is innermost (inner == 1), K8 has each block load a tile of
// 256 outputs plus its L-1 halo, folded, into shared memory. Interior
// elements (every tap inside the array) take a path with no fold. Each
// kernel's least time is its bytes, 2 * numel * sizeof(T) over 3.35 TB/s,
// for the tap counts of the filter tier (L FMAs per element at 67 TFLOP/s in
// float32 stay below that for L < ~40).
//
// Built with --fmad=false, as every source of this package: products and
// sums round on their own, so K8 and K9 add in their twins' order and agree
// with them bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define ED_FILTER_MAXR 8
#define ED_ROW_TILE 256
#define ED_THREADS 256

namespace {

enum { F_NEAREST = 0, F_WRAP = 1, F_REFLECT = 2, F_MIRROR = 3, F_CONSTANT = 4 };

// index j folded into [0, n) by the filter mode (ops/filters.py
// _fold_index); -1 for a tap beyond the edge in constant mode
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

struct Line {
  int64_t outer, n, inner;
  int taps, center, mode;
  int pair;  // 0 direct order; 1 / -1 SciPy's paired order, (anti)symmetric
  double cval;
};

// the taps of one output in the kernel's order; v(k) is the sample tap k
// reads
template <typename T, typename V>
__device__ __forceinline__ T tap_sum(const T* __restrict__ w, int L, int pair,
                                     V v) {
  if (pair == 0) {
    T acc = v(0) * w[0];
    for (int k = 1; k < L; ++k) acc = acc + v(k) * w[k];
    return acc;
  }
  const int s1 = L / 2;
  T acc = v(s1) * w[s1];
  for (int ii = s1; ii >= 1; --ii) {
    const T t = pair > 0 ? v(s1 - ii) + v(s1 + ii) : v(s1 - ii) - v(s1 + ii);
    acc = acc + t * w[s1 - ii];
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ T line_sample(const T* __restrict__ line, int64_t j,
                                         int64_t s, const Line& p, T cval) {
  const int64_t f = fold(j, p.n, p.mode);
  return f < 0 ? cval : line[f * s];
}

// K8 on any axis: thread e takes output (o, i, q) of the (outer, n, inner)
// view
template <typename T>
__global__ void __launch_bounds__(ED_THREADS)
correlate1d_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const T* __restrict__ w, const Line p) {
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
  if (j0 >= 0 && j0 + p.taps <= p.n) {
    const T* base = line + j0 * s;
    out[e] = tap_sum<T>(w, p.taps, p.pair,
                        [&](int k) { return base[k * s]; });
  } else {
    const T cval = T(p.cval);
    out[e] = tap_sum<T>(w, p.taps, p.pair, [&](int k) {
      return line_sample(line, j0 + k, s, p, cval);
    });
  }
}

// K8 on the innermost axis: block b takes outputs [t0, t0 + 256) of line o;
// the folded samples [t0 - c, t0 + 256 + L-1 - c) go to shared memory first
template <typename T>
__global__ void __launch_bounds__(ED_ROW_TILE)
correlate1d_rows_kernel(const T* __restrict__ x, T* __restrict__ out,
                        const T* __restrict__ w, const Line p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int64_t tiles = (p.n + ED_ROW_TILE - 1) / ED_ROW_TILE;
  const int64_t o = blockIdx.x / tiles;
  const int64_t t0 = (blockIdx.x - o * tiles) * (int64_t)ED_ROW_TILE;
  const T* line = x + o * p.n;
  const int width = ED_ROW_TILE + p.taps - 1;
  const T cval = T(p.cval);
  for (int k = threadIdx.x; k < width; k += blockDim.x)
    tile[k] = line_sample(line, t0 - p.center + k, 1, p, cval);
  __syncthreads();
  const int64_t i = t0 + threadIdx.x;
  if (i >= p.n) return;
  const T* v = tile + threadIdx.x;
  out[o * p.n + i] = tap_sum<T>(w, p.taps, p.pair,
                                [&](int k) { return v[k]; });
}

// K8T: x_bar[j] = sum over the fold list of j (j itself first, then the pads
// folding onto it, in order) of P(p) = sum_k w[k] g[p + c - k], k ascending,
// over the k with p + c - k inside the line
template <typename T>
__global__ void __launch_bounds__(ED_THREADS)
correlate1d_transpose_kernel(const T* __restrict__ g, T* __restrict__ out,
                             const T* __restrict__ w,
                             const int* __restrict__ ptr,
                             const int* __restrict__ pos, const Line p) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per_outer = p.n * p.inner;
  if (e >= p.outer * per_outer) return;
  const int64_t o = e / per_outer;
  const int64_t r = e - o * per_outer;
  const int64_t j = r / p.inner;
  const int64_t q = r - j * p.inner;
  const int64_t s = p.inner;
  const T* line = g + o * per_outer + q;
  const int beg = ptr[j], end = ptr[j + 1];
  const int64_t top = j + p.center;  // g index of tap 0 at position j
  if (end - beg == 1 && top - (p.taps - 1) >= 0 && top < p.n) {
    T acc = line[top * s] * w[0];
    for (int k = 1; k < p.taps; ++k) acc = acc + line[(top - k) * s] * w[k];
    out[e] = acc;
    return;
  }
  T acc = T(0);
  for (int l = beg; l < end; ++l) {
    const int64_t pq = (int64_t)pos[l] + p.center;
    T part = T(0);
    for (int k = 0; k < p.taps; ++k) {
      const int64_t i = pq - k;
      if (i >= 0 && i < p.n) part = part + line[i * s] * w[k];
    }
    acc = l == beg ? part : acc + part;
  }
  out[e] = acc;
}

struct Nd {
  int rank, taps, mode;
  double cval;
  int64_t total;
  int64_t n[ED_FILTER_MAXR], stride[ED_FILTER_MAXR];
  int lo[ED_FILTER_MAXR], hi[ED_FILTER_MAXR];  // least, greatest tap offset
  int ptr_base[ED_FILTER_MAXR];  // K9T: axis d's rows in ptr; -1 identity
};

__device__ __forceinline__ void unravel(int64_t e, const Nd& p,
                                        int64_t* idx) {
#pragma unroll
  for (int d = ED_FILTER_MAXR - 1; d >= 0; --d) {
    if (d < p.rank) {
      const int64_t qd = e / p.n[d];
      idx[d] = e - qd * p.n[d];
      e = qd;
    } else {
      idx[d] = 0;
    }
  }
}

// K9: off[t * rank + d] is tap t's offset along axis d, delta[t] the same as
// a linear offset
template <typename T>
__global__ void __launch_bounds__(ED_THREADS)
correlate_nd_kernel(const T* __restrict__ x, T* __restrict__ out,
                    const T* __restrict__ w, const int* __restrict__ off,
                    const int64_t* __restrict__ delta, const Nd p) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.total) return;
  int64_t idx[ED_FILTER_MAXR];
  unravel(e, p, idx);
  bool interior = true;
#pragma unroll
  for (int d = 0; d < ED_FILTER_MAXR; ++d)
    if (d < p.rank &&
        (idx[d] + p.lo[d] < 0 || idx[d] + p.hi[d] >= p.n[d]))
      interior = false;
  T acc = T(0);
  if (interior) {
    acc = x[e + delta[0]] * w[0];
    for (int t = 1; t < p.taps; ++t) acc = acc + x[e + delta[t]] * w[t];
  } else {
    const T cval = T(p.cval);
    for (int t = 0; t < p.taps; ++t) {
      int64_t a = 0;
      bool inside = true;
#pragma unroll
      for (int d = 0; d < ED_FILTER_MAXR; ++d) {
        if (d < p.rank && inside) {
          const int64_t f = fold(idx[d] + off[t * p.rank + d], p.n[d], p.mode);
          if (f < 0)
            inside = false;
          else
            a += f * p.stride[d];
        }
      }
      const T v = inside ? x[a] : cval;
      acc = t == 0 ? v * w[0] : acc + v * w[t];
    }
  }
  out[e] = acc;
}

// K9T: for output j, the sum over the product of the per-axis fold lists of
// P(p) = sum_t w[t] g[p - off_t] over the taps landing inside the array
template <typename T>
__global__ void __launch_bounds__(ED_THREADS)
correlate_nd_transpose_kernel(const T* __restrict__ g, T* __restrict__ out,
                              const T* __restrict__ w,
                              const int* __restrict__ off,
                              const int64_t* __restrict__ delta,
                              const int* __restrict__ ptr,
                              const int* __restrict__ pos, const Nd p) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.total) return;
  int64_t idx[ED_FILTER_MAXR];
  unravel(e, p, idx);
  int beg[ED_FILTER_MAXR], cnt[ED_FILTER_MAXR];
  bool interior = true;
#pragma unroll
  for (int d = 0; d < ED_FILTER_MAXR; ++d) {
    beg[d] = -1;
    cnt[d] = 1;
    if (d < p.rank) {
      if (p.ptr_base[d] >= 0) {
        const int* row = ptr + p.ptr_base[d] + idx[d];
        beg[d] = row[0];
        cnt[d] = row[1] - row[0];
        if (cnt[d] != 1) interior = false;
      }
      if (idx[d] - p.hi[d] < 0 || idx[d] - p.lo[d] >= p.n[d])
        interior = false;
    }
  }
  if (interior) {
    T acc = g[e - delta[0]] * w[0];
    for (int t = 1; t < p.taps; ++t) acc = acc + g[e - delta[t]] * w[t];
    out[e] = acc;
    return;
  }
  int c[ED_FILTER_MAXR];
  int64_t at[ED_FILTER_MAXR];
#pragma unroll
  for (int d = 0; d < ED_FILTER_MAXR; ++d) c[d] = 0;
  T acc = T(0);
  bool first = true;
  while (true) {
#pragma unroll
    for (int d = 0; d < ED_FILTER_MAXR; ++d)
      at[d] = beg[d] < 0 ? idx[d] : (int64_t)pos[beg[d] + c[d]];
    T part = T(0);
    for (int t = 0; t < p.taps; ++t) {
      int64_t a = 0;
      bool inside = true;
#pragma unroll
      for (int d = 0; d < ED_FILTER_MAXR; ++d) {
        if (d < p.rank && inside) {
          const int64_t i = at[d] - off[t * p.rank + d];
          if (i < 0 || i >= p.n[d])
            inside = false;
          else
            a += i * p.stride[d];
        }
      }
      if (inside) part = part + g[a] * w[t];
    }
    acc = first ? part : acc + part;
    first = false;
    // next position of the product, the last axis fastest
    int d = p.rank - 1;
    for (; d >= 0; --d) {
      if (++c[d] < cnt[d]) break;
      c[d] = 0;
    }
    if (d < 0) break;
  }
  out[e] = acc;
}

template <typename T>
cudaError_t launch_line(const void* x, void* out, const void* w,
                        const Line& p, cudaStream_t s) {
  const int64_t total = p.outer * p.n * p.inner;
  if (total == 0) return cudaSuccess;
  const size_t smem = (size_t)(ED_ROW_TILE + p.taps - 1) * sizeof(T);
  if (p.inner == 1 && smem <= 48 * 1024) {
    const int64_t blocks =
        p.outer * ((p.n + ED_ROW_TILE - 1) / ED_ROW_TILE);
    if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
    correlate1d_rows_kernel<T><<<(unsigned)blocks, ED_ROW_TILE, smem, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<const T*>(w), p);
  } else {
    const int64_t blocks = (total + ED_THREADS - 1) / ED_THREADS;
    if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
    correlate1d_kernel<T><<<(unsigned)blocks, ED_THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<const T*>(w), p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_line_transpose(const void* g, void* out, const void* w,
                                  const int* ptr, const int* pos,
                                  const Line& p, cudaStream_t s) {
  const int64_t total = p.outer * p.n * p.inner;
  if (total == 0) return cudaSuccess;
  const int64_t blocks = (total + ED_THREADS - 1) / ED_THREADS;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  correlate1d_transpose_kernel<T><<<(unsigned)blocks, ED_THREADS, 0, s>>>(
      static_cast<const T*>(g), static_cast<T*>(out),
      static_cast<const T*>(w), ptr, pos, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_nd(bool transpose, const void* x, void* out, const void* w,
                      const int* off, const int64_t* delta, const int* ptr,
                      const int* pos, const Nd& p, cudaStream_t s) {
  if (p.total == 0 || p.taps == 0) return cudaSuccess;
  const int64_t blocks = (p.total + ED_THREADS - 1) / ED_THREADS;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  if (transpose)
    correlate_nd_transpose_kernel<T><<<(unsigned)blocks, ED_THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<const T*>(w), off, delta, ptr, pos, p);
  else
    correlate_nd_kernel<T><<<(unsigned)blocks, ED_THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<const T*>(w), off, delta, p);
  return cudaGetLastError();
}

Line make_line(long long outer, long long n, long long inner, int taps,
               int center, int mode, int pair, double cval) {
  Line p;
  p.outer = outer;
  p.n = n;
  p.inner = inner;
  p.taps = taps;
  p.center = center;
  p.mode = mode;
  p.pair = pair;
  p.cval = cval;
  return p;
}

}  // namespace

extern "C" {

// K8. dtype: 0 float32, 1 float64; w: taps values of x's dtype on the
// device; mode: 0 nearest, 1 wrap, 2 reflect, 3 mirror, 4 constant; pair: 0
// direct order, 1 / -1 paired (odd taps only). x and out must not overlap.
// Returns cudaGetLastError().
int ed_correlate1d(int dtype, const void* x, void* out, const void* w,
                   long long outer, long long n, long long inner, int taps,
                   int center, int mode, int pair, double cval,
                   void* stream) {
  if (taps < 1 || center < 0 || center >= taps || mode < 0 || mode > 4 ||
      (pair != 0 && (taps % 2 == 0 || pair < -1 || pair > 1)))
    return (int)cudaErrorInvalidValue;
  const Line p = make_line(outer, n, inner, taps, center, mode, pair, cval);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? launch_line<float>(x, out, w, p, s)
                    : dtype == 1 ? launch_line<double>(x, out, w, p, s)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

// K8T, the transpose of ed_correlate1d. ptr (n + 1) and pos: the per-position
// fold lists of the padded extent (ops/filters.py fold_lists), on the device.
int ed_correlate1d_transpose(int dtype, const void* g, void* out,
                             const void* w, const void* ptr, const void* pos,
                             long long outer, long long n, long long inner,
                             int taps, int center, void* stream) {
  if (taps < 1 || center < 0 || center >= taps)
    return (int)cudaErrorInvalidValue;
  const Line p = make_line(outer, n, inner, taps, center, F_CONSTANT, 0, 0.0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(ptr);
  const int* ps = static_cast<const int*>(pos);
  cudaError_t err =
      dtype == 0   ? launch_line_transpose<float>(g, out, w, pt, ps, p, s)
      : dtype == 1 ? launch_line_transpose<double>(g, out, w, pt, ps, p, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

// K9 (transpose = 0) and K9T (transpose = 1) on a contiguous tensor of rank
// <= ED_FILTER_MAXR with shape[rank] (host). Device arrays: w[taps], off[taps
// * rank], delta[taps]; for K9T the fold lists ptr / pos, axis d's rows from
// ptr_base[d] (host; -1: the identity list). lo / hi (host): the least and
// greatest offset per axis. Returns cudaGetLastError().
int ed_correlate_nd(int dtype, int transpose, const void* x, void* out,
                    const void* w, const void* off, const void* delta,
                    const void* ptr, const void* pos, int rank,
                    const long long* shape, const int* lo, const int* hi,
                    const int* ptr_base, int taps, int mode, double cval,
                    void* stream) {
  if (rank < 1 || rank > ED_FILTER_MAXR || taps < 0 || mode < 0 || mode > 4)
    return (int)cudaErrorInvalidValue;
  Nd p;
  p.rank = rank;
  p.taps = taps;
  p.mode = mode;
  p.cval = cval;
  p.total = 1;
  for (int d = ED_FILTER_MAXR - 1; d >= 0; --d) {
    const bool used = d < rank;
    p.n[d] = used ? shape[d] : 1;
    p.stride[d] = p.total;
    p.total *= p.n[d];
    p.lo[d] = used ? lo[d] : 0;
    p.hi[d] = used ? hi[d] : 0;
    p.ptr_base[d] = used ? ptr_base[d] : -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* of = static_cast<const int*>(off);
  const int64_t* de = static_cast<const int64_t*>(delta);
  const int* pt = static_cast<const int*>(ptr);
  const int* ps = static_cast<const int*>(pos);
  cudaError_t err =
      dtype == 0
          ? launch_nd<float>(transpose != 0, x, out, w, of, de, pt, ps, p, s)
      : dtype == 1
          ? launch_nd<double>(transpose != 0, x, out, w, of, de, pt, ps, p, s)
          : cudaErrorInvalidValue;
  return (int)err;
}

const char* ed_filters_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
