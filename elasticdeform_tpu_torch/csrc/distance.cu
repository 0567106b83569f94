// K14 nearest_background, K15 minplus_pass, K16 chamfer_sweep and K17
// watershed_sweep: the distance transforms (SciPy's distance_transform_edt,
// _cdt and _bf) and the watershed by image foresting transform.
//
// K14 replaces the JAX package's elasticdeform_tpu/ops/distance.py:98
// _nearest_bg_last and the first pass of edt_core (:259-270): along axis 0
// of a bool mask, each voxel's index distance d to the nearest background
// (false) voxel of its line, the left one on a tie, d = 2n and j = 0 on a
// line with no background; f = (s0 d)^2, or the sentinel big (float32 max /
// 16) there. With indices it writes the (ndim, *shape) int32 feature
// array: plane 0 the nearest background's index j, plane k > 0 the voxel's
// own coordinate along axis k. One thread a line, neighbouring threads on
// neighbouring lines, so every load and store coalesces; a backward walk
// stores the nearest background at or after i in f, the forward walk reads
// it back and finishes.
//
// K15 replaces distance.py:120-234, one rung of _minplus_pass along an axis
// >= 1 of the contiguous (outer, n, inner) view: out(i) = min_j g(j) +
// cost(|i - j|), the feature planes gathered at the argmin. A band of W > 0
// (_banded_last) visits its own value first, then j = i - 1, i + 1, i - 2,
// i + 2, ... with a strict <, so a tie goes to the nearest j, the lower j
// first; j beyond the line reads big; the host's table holds (s o)^2 in that
// order, and the kernel sets *fail where out > (s W)^2, the certificate the
// host reads once a rung. W = 0 is the dense tier (_matrix_last): every j
// from 0, a strict <, so a tie goes to the lowest j, the host's table
// holding s^2 k^2 for k = |i - j|. One thread an output voxel in raster
// order: a warp takes adjacent lines of a strided axis (or adjacent voxels of
// the innermost one), so every candidate's load coalesces, and the reuse of
// a line's values is served by L1. Input and output never alias (ping-pong).
//
// K16 replaces distance.py:343-379, a Jacobi sweep of cdt_core: d <- min(d,
// d(u) + 1) over the structure's neighbours u in raster order (the centre
// dropped), a strict <, carrying the winner's raveled index; K17 replaces
// morphology.py:571-596, a Jacobi sweep of watershed_ift: a labelled
// neighbour u offers (max(c(u), x), s(u) + 1, l(u)), and the
// lexicographically smallest triple wins, strictly. Both read only the
// previous sweep's state and write a second buffer, so the fixpoint and the
// indices are those of the reference's sweeps; a neighbour beyond the edge
// takes no part (the reference's pad never wins). *changed is set when a
// voxel of the sweep changed; the host zeroes it before the 8th sweep of a
// group and reads it after (the schedule of K13's driver). One thread a
// voxel in raster order; per voxel a bit mask of the axes where it sits on
// the low and the high edge; a tap is a linear offset and the masks of the
// axes it steps down and up along, so it is skipped where it would leave
// the array. No shared memory: the neighbours' reuse is served by L1 and
// L2. The entry points launch a group of sweeps (the driver's eight,
// ops/morphology.py::relax_to_fixpoint) from one host call, ping-ponging
// between two buffer sets, so the host's time a sweep is one kernel launch
// and not a Python call, and the card runs the group back to back.
//
// Bound on the H100, each input read once and each output written once
// over 3.35 TB/s: K14 the mask and f (and the feature planes); K15 g, the
// feature planes in and out and f out, per pass. A launch of K16 or K17
// reads the state (K16 d and ix, 8 bytes a voxel; K17 the image and the
// triples, 13) and writes it (8; 12): at c19 0.0164 and 0.0154 ms. A
// call's bound is its input and result alone (the mask, d and ix; the
// image, markers and labels), 0.0092 and 0.0055 ms, while a call runs 48
// and 192 sweeps (about one per voxel of the longest path), so the sweeps
// stand far above it. Every kernel copies values or adds and
// compares in the order of its plain twin, built without contraction
// (--fmad=false), so it agrees with ops/distance.py and
// ops/morphology.py's twins bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define ED_DIST_MAXD 8
#define ED_DIST_THREADS 256
#define ED_DIST_BLOCKS 4096

namespace {

// the extents of an array of up to ED_DIST_MAXD axes (fewer than 2^31
// elements: the feature indices are int32)
struct Dims {
  int ndim;
  unsigned n[ED_DIST_MAXD];
};

// one block's vote: *flag |= any thread's local flag
__device__ __forceinline__ void block_flag(int* flag, bool local) {
  if (__syncthreads_or(local) && threadIdx.x == 0) atomicOr(flag, 1);
}

unsigned grid_for(long long n) {
  long long b = (n + ED_DIST_THREADS - 1) / ED_DIST_THREADS;
  return (unsigned)(b < ED_DIST_BLOCKS ? (b > 0 ? b : 1) : ED_DIST_BLOCKS);
}

// ---------------------------------------------------------------------------
// K14

__global__ void __launch_bounds__(ED_DIST_THREADS)
nearest_bg_kernel(const uint8_t* __restrict__ fg, double* __restrict__ f,
                  int* __restrict__ ix, Dims dm, unsigned lines, double s0,
                  double big) {
  const unsigned m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= lines) return;
  const int n = (int)dm.n[0];
  const int sent = 2 * n;
  // the nearest background at or after i (n where there is none)
  int r = n;
  for (int i = n - 1; i >= 0; --i) {
    const size_t v = (size_t)i * lines + m;
    if (!fg[v]) r = i;
    f[v] = (double)r;
  }
  int l = -1;
  for (int i = 0; i < n; ++i) {
    const size_t v = (size_t)i * lines + m;
    if (!fg[v]) l = i;
    const int rr = (int)f[v];
    const int dl = l >= 0 ? i - l : sent;
    const int dr = rr < n ? rr - i : sent;
    const bool take_l = dl <= dr;
    const int d = take_l ? dl : dr;
    int j = take_l ? l : rr;
    j = j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
    const double t = s0 * (double)d;
    f[v] = d < sent ? t * t : big;
    if (ix) ix[v] = j;
  }
  if (!ix) return;
  // planes 1..ndim-1: the line's own coordinates
  const size_t N = (size_t)n * lines;
  unsigned rem = m;
#pragma unroll
  for (int k = ED_DIST_MAXD - 1; k >= 1; --k) {
    if (k < dm.ndim) {
      const int c = (int)(rem % dm.n[k]);
      rem /= dm.n[k];
      int* plane = ix + (size_t)k * N + m;
      for (int i = 0; i < n; ++i) plane[(size_t)i * lines] = c;
    }
  }
}

// ---------------------------------------------------------------------------
// K15

template <bool DENSE>
__global__ void __launch_bounds__(ED_DIST_THREADS)
minplus_kernel(const double* __restrict__ g, double* __restrict__ out,
               const int* __restrict__ ix, int* __restrict__ ix_out,
               int nidx, unsigned total, int n, unsigned inner,
               const double* __restrict__ table, int W, double thr,
               double big, int* __restrict__ fail) {
  bool bad = false;
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x) {
    const int i = (int)((v / inner) % (unsigned)n);
    double best;
    int bj;
    if (DENSE) {
      const double* line = g + (v - (unsigned)i * inner);
      best = line[0] + __ldg(table + i);
      bj = 0;
      for (int j = 1; j < n; ++j) {
        const int k = j > i ? j - i : i - j;
        const double c = line[(size_t)j * inner] + __ldg(table + k);
        if (c < best) {
          best = c;
          bj = j;
        }
      }
    } else {
      best = g[v];
      bj = i;
      for (int t = 0; t < 2 * W; ++t) {
        const int o = (t & 1) ? (t >> 1) + 1 : -((t >> 1) + 1);
        const int j = i + o;
        const double gj =
            (j >= 0 && j < n) ? g[(long long)v + (long long)o * inner] : big;
        const double c = gj + __ldg(table + t);
        if (c < best) {
          best = c;
          bj = j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
        }
      }
      if (!(best <= thr)) bad = true;
    }
    out[v] = best;
    const long long from = (long long)v + (long long)(bj - i) * inner;
    for (int p = 0; p < nidx; ++p)
      ix_out[(size_t)p * total + v] = ix[(size_t)p * total + from];
  }
  if (!DENSE) block_flag(fail, bad);
}

// ---------------------------------------------------------------------------
// K16 and K17

// the axes where voxel v sits on the low edge (bits 0-7) and on the high
// edge (bits 8-15); a tap's word holds the axes it steps down along (bits
// 0-7) and up along (bits 8-15), so it leaves the array where the two meet
__device__ __forceinline__ unsigned edge_bits(unsigned v, const Dims& dm) {
  unsigned lo = 0, hi = 0, rem = v;
#pragma unroll
  for (int k = ED_DIST_MAXD - 1; k >= 0; --k) {
    if (k < dm.ndim) {
      const unsigned c = rem % dm.n[k];
      rem /= dm.n[k];
      lo |= (unsigned)(c == 0) << k;
      hi |= (unsigned)(c == dm.n[k] - 1) << k;
    }
  }
  return lo | (hi << 8);
}

__global__ void __launch_bounds__(ED_DIST_THREADS)
chamfer_sweep_kernel(const int* __restrict__ d, const int* __restrict__ ix,
                     int* __restrict__ d_out, int* __restrict__ ix_out,
                     const int2* __restrict__ taps, int ntaps, Dims dm,
                     unsigned total, int* __restrict__ changed) {
  bool any = false;
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x) {
    const unsigned edges = edge_bits(v, dm);
    const int d0 = d[v];
    int best = d0;
    int bix = ix ? ix[v] : 0;
    for (int t = 0; t < ntaps; ++t) {
      const int2 tp = __ldg(taps + t);
      if ((unsigned)tp.y & edges) continue;
      const unsigned u = v + tp.x;
      const int c = d[u] + 1;
      if (c < best) {
        best = c;
        if (ix) bix = ix[u];
      }
    }
    d_out[v] = best;
    if (ix) ix_out[v] = bix;
    any |= best != d0;
  }
  if (changed) block_flag(changed, any);
}

template <typename X>
__global__ void __launch_bounds__(ED_DIST_THREADS)
watershed_sweep_kernel(const X* __restrict__ img, const int* __restrict__ c,
                       const int* __restrict__ s, const int* __restrict__ l,
                       int* __restrict__ c_out, int* __restrict__ s_out,
                       int* __restrict__ l_out, const int2* __restrict__ taps,
                       int ntaps, Dims dm, unsigned total,
                       int* __restrict__ changed) {
  bool any = false;
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x) {
    const unsigned edges = edge_bits(v, dm);
    const int x = (int)img[v];
    const int c0 = c[v], s0 = s[v], l0 = l[v];
    int nc = c0, ns = s0, nl = l0;
    for (int t = 0; t < ntaps; ++t) {
      const int2 tp = __ldg(taps + t);
      if ((unsigned)tp.y & edges) continue;
      const unsigned u = v + tp.x;
      const int cl = l[u];
      if (cl == 0) continue;
      const int cu = c[u];
      const int cc = cu > x ? cu : x;
      const int cs = s[u] + 1;
      if (cc < nc || (cc == nc && (cs < ns || (cs == ns && cl < nl)))) {
        nc = cc;
        ns = cs;
        nl = cl;
      }
    }
    c_out[v] = nc;
    s_out[v] = ns;
    l_out[v] = nl;
    any |= nc != c0 || ns != s0 || nl != l0;
  }
  if (changed) block_flag(changed, any);
}

bool make_dims(int ndim, const long long* shape, Dims* dm,
               long long* total) {
  if (ndim < 1 || ndim > ED_DIST_MAXD) return false;
  long long t = 1;
  dm->ndim = ndim;
  for (int k = 0; k < ED_DIST_MAXD; ++k) dm->n[k] = 1;
  for (int k = 0; k < ndim; ++k) {
    if (shape[k] < 1) return false;
    dm->n[k] = (unsigned)shape[k];
    t *= shape[k];
    if (t >= (1LL << 31)) return false;
  }
  *total = t;
  return true;
}

}  // namespace

extern "C" {

// K14 on a contiguous bool mask of `ndim` axes (fewer than 2^31 voxels):
// f (float64, the mask's shape) and, where ix is not null, the (ndim,
// *shape) int32 feature planes. Returns cudaGetLastError().
int ed_nearest_background(const void* fg, double* f, int* ix, int ndim,
                          const long long* shape, double s0, double big,
                          void* stream) {
  Dims dm;
  long long total;
  if (!make_dims(ndim, shape, &dm, &total)) return (int)cudaErrorInvalidValue;
  const unsigned lines = (unsigned)(total / shape[0]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nearest_bg_kernel<<<(lines + ED_DIST_THREADS - 1) / ED_DIST_THREADS,
                      ED_DIST_THREADS, 0, st>>>(
      static_cast<const uint8_t*>(fg), f, ix, dm, lines, s0, big);
  return (int)cudaGetLastError();
}

// K15: one rung along the middle axis of the contiguous (outer, n, inner)
// view of `total` voxels (fewer than 2^31). W > 0: a band of W, `table` the
// 2W constants (s o)^2 in the visiting order, *fail set where out > thr;
// W = 0: the dense tier, `table` the n constants s^2 k^2. ix and ix_out:
// nidx feature planes of `total` int32 each, or null with nidx = 0. g and
// out, ix and ix_out must not overlap. Returns cudaGetLastError().
int ed_minplus_pass(const double* g, double* out, const int* ix, int* ix_out,
                    int nidx, long long total, int n, long long inner,
                    const double* table, int W, double thr, double big,
                    int* fail, void* stream) {
  if (total < 1 || total >= (1LL << 31) || n < 1 || inner < 1 || W < 0 ||
      nidx < 0 || (nidx > 0 && (!ix || !ix_out)) || (W > 0 && !fail))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(total);
  if (W == 0)
    minplus_kernel<true><<<grid, ED_DIST_THREADS, 0, st>>>(
        g, out, ix, ix_out, nidx, (unsigned)total, n, (unsigned)inner, table,
        0, thr, big, fail);
  else
    minplus_kernel<false><<<grid, ED_DIST_THREADS, 0, st>>>(
        g, out, ix, ix_out, nidx, (unsigned)total, n, (unsigned)inner, table,
        W, thr, big, fail);
  return (int)cudaGetLastError();
}

// K16: `nsweeps` Jacobi sweeps of the chamfer relaxation on a contiguous
// int32 array of `ndim` axes, launched from this one host call: sweep j
// reads set j % 2 and writes set (j + 1) % 2, set 0 (d, ix), set 1 (d_out,
// ix_out), so the result lies in set nsweeps % 2 (an even count overwrites
// set 0); taps: ntaps (linear offset, edge word) pairs; ix and ix_out null
// without indices; changed null or set where a voxel of the last sweep
// changed. The sets must not overlap. Returns the first launch's error
// (cudaGetLastError()), or 0.
int ed_chamfer_sweep(int* d, int* ix, int* d_out, int* ix_out,
                     const int* taps, int ntaps, int ndim,
                     const long long* shape, int nsweeps, int* changed,
                     void* stream) {
  Dims dm;
  long long total;
  if (!make_dims(ndim, shape, &dm, &total) || ntaps < 0 || nsweeps < 1 ||
      (ix == nullptr) != (ix_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* tp = reinterpret_cast<const int2*>(taps);
  for (int j = 0; j < nsweeps; ++j) {
    chamfer_sweep_kernel<<<grid_for(total), ED_DIST_THREADS, 0, st>>>(
        d, ix, d_out, ix_out, tp, ntaps, dm, (unsigned)total,
        j == nsweeps - 1 ? changed : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    int* t = d;
    d = d_out;
    d_out = t;
    t = ix;
    ix = ix_out;
    ix_out = t;
  }
  return 0;
}

// K17: `nsweeps` Jacobi sweeps of the watershed relaxation, from one host
// call as K16's; img uint8 (img_bytes 1) or uint16 (2); the int32 triples
// set 0 (c, s, l) and set 1 (c_out, s_out, l_out); taps and changed as
// K16's. Returns the first launch's error, or 0.
int ed_watershed_sweep(const void* img, int img_bytes, int* c, int* s,
                       int* l, int* c_out, int* s_out, int* l_out,
                       const int* taps, int ntaps, int ndim,
                       const long long* shape, int nsweeps, int* changed,
                       void* stream) {
  Dims dm;
  long long total;
  if (!make_dims(ndim, shape, &dm, &total) || ntaps < 0 || nsweeps < 1 ||
      (img_bytes != 1 && img_bytes != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* tp = reinterpret_cast<const int2*>(taps);
  int* in[3] = {c, s, l};
  int* out[3] = {c_out, s_out, l_out};
  for (int j = 0; j < nsweeps; ++j) {
    int* flag = j == nsweeps - 1 ? changed : nullptr;
    if (img_bytes == 1)
      watershed_sweep_kernel<uint8_t><<<grid_for(total), ED_DIST_THREADS, 0,
                                        st>>>(
          static_cast<const uint8_t*>(img), in[0], in[1], in[2], out[0],
          out[1], out[2], tp, ntaps, dm, (unsigned)total, flag);
    else
      watershed_sweep_kernel<uint16_t><<<grid_for(total), ED_DIST_THREADS, 0,
                                         st>>>(
          static_cast<const uint16_t*>(img), in[0], in[1], in[2], out[0],
          out[1], out[2], tp, ntaps, dm, (unsigned)total, flag);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int k = 0; k < 3; ++k) {
      int* t = in[k];
      in[k] = out[k];
      out[k] = t;
    }
  }
  return 0;
}

const char* ed_distance_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
