// K18 label_roots (with its numbering), K19 segment_reduce and K20
// segment_position: connected-component labeling and region measurements
// (SciPy's label and its measurements).
//
// K18 replaces elasticdeform_tpu/measure.py:93 label_roots (a while loop of
// segmented min-scans, a diagonal neighbour minimum and one pointer jump
// until nothing changes) and :150 label's numbering on the host. On the card
// it is a union-find in three launches from one host call: init (a
// foreground voxel points to itself, a background voxel holds n); merge
// (each foreground voxel hooks its foreground neighbours of lower raveled
// index, the structure's half table; a hook links the larger of two roots
// to the smaller by atomicCAS on the root, as ECL-CC does (Jaiganesh and
// Burtscher, HPDC 2018), and a find shortcuts the path it walks to its
// grandparents, which only ever points a voxel at another ancestor);
// compress (each voxel takes its root, and its root flag; only reads but
// its own store, so no late shortcut undoes a root). Every link
// points at a smaller index, so a component's root is its least raveled
// index whatever the order of the hooks: the JAX package's roots, bit for
// bit, with no fixpoint and no flag read. The numbering is a gather: a
// root's number is the inclusive count of the roots up to it (a
// torch.cumsum of the flags on the host side), background 0.
//
// K19 replaces the jax.ops.segment_sum / segment_min / segment_max calls of
// measure.py:201-416 (_segment, _count, _positions' first pass,
// center_of_mass, histogram, find_objects :435): per segment the float64
// sum and sum of squares, an exact int64 count (the JAX package's float32
// count is exact only below 2^24), the float64 sums of f * coord_k, minimum
// and maximum, each axis's least and greatest coordinate, and the
// histogram's bucket counts. A voxel's segment comes from its label through
// _norm_labels_index's table (-1 excluded), read in the labels' own dtype;
// the input is read in its own dtype (a run-time code, uniform over a
// launch, so one instantiation serves the eleven dtypes). Minima and maxima
// accumulate order keys: int64 values in the dtype's order, -0.0 below
// +0.0, NaN below everything for a minimum and above for a maximum (so NaN
// wins, as in XLA), unsigned 64-bit values with the top bit flipped. A warp
// first combines its lanes of one segment (__match_any_sync, then a tree
// over each group's lanes by shuffles), and the group's lowest lane applies
// the total with one atomic per accumulator: the shared route adds into
// every segment's accumulators in the block's shared memory and flushes the
// ones it touched once; the device route adds into device memory. Sums
// differ from a sequential sum in their order only.
//
// K20 replaces _positions' second pass (measure.py:298-310): a voxel equal
// (==, so -0.0 and +0.0 tie and NaN never hits) to its segment's extremum
// offers its raveled index, and the segment keeps the least (the group's
// lowest lane, then atomicMin).
//
// Bound on the H100 (3.35 TB/s, each input read once and each output
// written once): K18 reads the mask and writes the int32 roots and flags, 9
// bytes a voxel, and the numbering reads the roots and writes the labels, 8;
// K19 and K20 read the input and the labels (and write K or K x bins
// accumulators); their atomics and the union-find's pointer walks are the
// design's cost, not the function's. Built with --fmad=false, so every
// product and sum rounds as in the plain twins (ops/measure.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "array_dims.cuh"

#define ED_MEAS_MAXD ED_DIMS_MAXD
#define ED_MEAS_THREADS 256
#define ED_MEAS_BLOCKS 4096
// K19's shared route: threads a block (ops/measure.py::_grid's blocks) and
// the most dynamic shared memory a block takes
#define ED_SEG_SHARED_THREADS 512
#define ED_SEG_SMEM_MAX (227 * 1024)
#define ED_FULL 0xffffffffu

namespace {

// the kernels' dtype codes (ops/measure.py DTYPE_CODES)
enum DType {
  kBool = 0, kU8, kI8, kI16, kU16, kI32, kU32, kI64, kU64, kF32, kF64
};

constexpr long long kKeyMin = (long long)0x8000000000000000ull;
constexpr long long kKeyMax = 0x7fffffffffffffffll;

unsigned grid_for(long long n) {
  long long b = (n + ED_MEAS_THREADS - 1) / ED_MEAS_THREADS;
  return (unsigned)(b < ED_MEAS_BLOCKS ? (b > 0 ? b : 1) : ED_MEAS_BLOCKS);
}

// ---------------------------------------------------------------------------
// K18

__global__ void __launch_bounds__(ED_MEAS_THREADS)
uf_init_kernel(const uint8_t* __restrict__ fg, int* __restrict__ L,
               unsigned total) {
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x)
    L[v] = fg[v] ? (int)v : (int)total;
}

// v's root; the path walked is shortcut to each voxel's grandparent (a
// plain store: a non-root's pointer only ever moves to another ancestor,
// every pointer at a smaller index, so racing stores keep the forest)
__device__ __forceinline__ int uf_find(volatile int* L, int v) {
  int curr = L[v];
  if (curr != v) {
    int prev = v, next;
    while (curr > (next = L[curr])) {
      L[prev] = next;
      prev = curr;
      curr = next;
    }
  }
  return curr;
}

// join the trees of a and b: the larger root is linked to the smaller by a
// compare-and-swap that succeeds only on a root; a failed one gives the
// root's new parent, from which the hook goes on
__device__ __forceinline__ void uf_hook(volatile int* L, int a, int b) {
  a = uf_find(L, a);
  b = uf_find(L, b);
  while (a != b) {
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(const_cast<int*>(L + a), a, b);
    if (old == a) return;
    a = old;
  }
}

__global__ void __launch_bounds__(ED_MEAS_THREADS)
uf_merge_kernel(const uint8_t* __restrict__ fg, int* L,
                const int2* __restrict__ taps, int ntaps, Dims dm,
                unsigned total) {
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x) {
    if (!fg[v]) continue;
    const unsigned edges = edge_bits(v, dm);
    for (int t = 0; t < ntaps; ++t) {
      const int2 tp = __ldg(taps + t);
      if ((unsigned)tp.y & edges) continue;
      const unsigned u = v + tp.x;
      if (fg[u]) uf_hook(L, (int)v, (int)u);
    }
  }
}

// after the merge: each voxel takes its root. Only a voxel's own thread
// writes it here and the walks only read (a shortcut stored by another
// thread could land after the root and undo it), so every voxel ends at
// its root; a walk meeting a voxel already done jumps there at once.
__global__ void __launch_bounds__(ED_MEAS_THREADS)
uf_compress_kernel(int* L, int* __restrict__ flags, unsigned total) {
  volatile int* vl = L;
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x) {
    int root = vl[v];
    if (root < (int)total) {
      for (int next = vl[root]; next != root; next = vl[root]) root = next;
      vl[v] = root;
    }
    if (flags) flags[v] = root == (int)v;
  }
}

__global__ void __launch_bounds__(ED_MEAS_THREADS)
label_number_kernel(const int* __restrict__ L, const int* __restrict__ cum,
                    int* __restrict__ out, unsigned total) {
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x) {
    const int l = L[v];
    out[v] = l < (int)total ? __ldg(cum + l) : 0;
  }
}

// ---------------------------------------------------------------------------
// K19 and K20: reading values and labels in their dtypes

__device__ __forceinline__ double load_f64(const void* p, int code,
                                           unsigned i) {
  switch (code) {
    case kBool: return static_cast<const uint8_t*>(p)[i] ? 1.0 : 0.0;
    case kU8: return (double)static_cast<const uint8_t*>(p)[i];
    case kI8: return (double)static_cast<const int8_t*>(p)[i];
    case kI16: return (double)static_cast<const int16_t*>(p)[i];
    case kU16: return (double)static_cast<const uint16_t*>(p)[i];
    case kI32: return (double)static_cast<const int32_t*>(p)[i];
    case kU32: return (double)static_cast<const uint32_t*>(p)[i];
    case kI64: return (double)static_cast<const long long*>(p)[i];
    case kU64: return (double)static_cast<const unsigned long long*>(p)[i];
    case kF32: return (double)static_cast<const float*>(p)[i];
    default: return static_cast<const double*>(p)[i];
  }
}

// the order key of a float's bits: positive values keep them, negative
// ones flip all but the sign, so -0.0 (key -1) lies below +0.0 (key 0)
__device__ __forceinline__ long long f32_key(float f, long long nan_key) {
  if (f != f) return nan_key;
  const int b = __float_as_int(f);
  return b >= 0 ? (long long)b : (long long)(b ^ 0x7fffffff);
}

__device__ __forceinline__ long long f64_key(double f, long long nan_key) {
  if (f != f) return nan_key;
  const long long b = __double_as_longlong(f);
  return b >= 0 ? b : b ^ kKeyMax;
}

// the order key of element i (ops/measure.py order_keys)
__device__ __forceinline__ long long load_key(const void* p, int code,
                                              unsigned i, long long nan_key) {
  switch (code) {
    case kBool: return static_cast<const uint8_t*>(p)[i] != 0;
    case kU8: return static_cast<const uint8_t*>(p)[i];
    case kI8: return static_cast<const int8_t*>(p)[i];
    case kI16: return static_cast<const int16_t*>(p)[i];
    case kU16: return static_cast<const uint16_t*>(p)[i];
    case kI32: return static_cast<const int32_t*>(p)[i];
    case kU32: return static_cast<const uint32_t*>(p)[i];
    case kI64: return static_cast<const long long*>(p)[i];
    case kU64:
      return (long long)(static_cast<const unsigned long long*>(p)[i] ^
                         0x8000000000000000ull);
    case kF32: return f32_key(static_cast<const float*>(p)[i], nan_key);
    default: return f64_key(static_cast<const double*>(p)[i], nan_key);
  }
}

// a label as int64, as XLA converts it: integers wrap, floats truncate
// toward zero and saturate, NaN gives 0 (PTX's cvt.rzi)
__device__ __forceinline__ long long load_label(const void* p, int code,
                                                unsigned i) {
  switch (code) {
    case kF32: return (long long)static_cast<const float*>(p)[i];
    case kF64: return (long long)static_cast<const double*>(p)[i];
    case kU64:
      return (long long)static_cast<const unsigned long long*>(p)[i];
    default: return load_key(p, code, i, 0);
  }
}

// `label > 0` in the labels' dtype
__device__ __forceinline__ bool label_positive(const void* p, int code,
                                               unsigned i) {
  switch (code) {
    case kF32: return static_cast<const float*>(p)[i] > 0.0f;
    case kF64: return static_cast<const double*>(p)[i] > 0.0;
    case kBool: case kU8: case kU16: case kU32: case kU64:
      return load_label(p, code, i) != 0;
    default: return load_label(p, code, i) > 0;
  }
}

struct SegArgs {
  const void* x;
  const void* lab;       // null: every voxel in segment 0
  const int* lut;        // null (with labels): segment 0 where label > 0
  long long lut_size;
  int xcode, lcode, K, bins;
  Dims dm;
  unsigned total;
  // device-memory accumulators, null where not asked for (K20 reads its
  // extrema's keys from kmin)
  double* sum;
  double* sum2;
  unsigned long long* count;
  double* csum;          // K x ndim
  long long* kmin;
  long long* kmax;
  int* cmin;             // K x ndim
  int* cmax;             // K x ndim
  unsigned long long* hist;  // K x bins
  double lo, hi, span;
  // the shared route: byte offsets of each accumulator in the block's
  // shared memory (-1 absent; counts and histogram 32-bit there), and the
  // 32-voxel groups of a block
  int o_sum, o_sum2, o_csum, o_kmin, o_kmax, o_count, o_cmin, o_cmax,
      o_hist;
  unsigned chunk;
};

__device__ __forceinline__ int segment_of(const SegArgs& a, unsigned v) {
  if (!a.lab) return 0;
  if (!a.lut) return label_positive(a.lab, a.lcode, v) ? 0 : -1;
  const long long l = load_label(a.lab, a.lcode, v);
  if (l < 0 || l >= a.lut_size) return -1;
  return __ldg(a.lut + l);
}

// a reduction over each lane's group `peers` (the lanes of one segment,
// from __match_any_sync), after which the group's lowest lane holds its
// total (NVIDIA's reduce_peers): each round a lane adds the partial total
// of the next lane of its group still in play (every lane of the warp
// shuffles, src its own lane where it has none), and the lanes at an odd
// rank among those in play leave. PeerRounds keeps the state; the kernel
// runs `while (r.next(&src))` around its shuffles, so that its
// accumulators stay in registers.
struct PeerRounds {
  unsigned rank, higher;
  __device__ __forceinline__ explicit PeerRounds(unsigned peers) {
    const unsigned lane = threadIdx.x & 31;
    rank = __popc(peers & ((1u << lane) - 1u));
    higher = peers & (0xfffffffeu << lane);
  }
  // the next round's source lane in *src (-1: none); false when no lane of
  // the warp has a round left
  __device__ __forceinline__ bool next(int* src) {
    if (!__any_sync(ED_FULL, higher != 0)) return false;
    *src = __ffs(higher) - 1;
    higher &= ~__ballot_sync(ED_FULL, rank & 1u);
    rank >>= 1;
    return true;
  }
};

__device__ __forceinline__ void coords_of(unsigned v, const Dims& dm,
                                          unsigned* c) {
  unsigned rem = v;
#pragma unroll
  for (int k = ED_MEAS_MAXD - 1; k >= 0; --k) {
    if (k < dm.ndim) {
      c[k] = rem % dm.n[k];
      rem /= dm.n[k];
    }
  }
}

template <typename T>
__device__ __forceinline__ T* smem_at(unsigned char* base, int off) {
  return reinterpret_cast<T*>(base + off);
}

// ---------------------------------------------------------------------------
// K19

template <bool SHARED>
__global__ void __launch_bounds__(SHARED ? ED_SEG_SHARED_THREADS
                                         : ED_MEAS_THREADS)
segment_reduce_kernel(const SegArgs a) {
  extern __shared__ __align__(16) unsigned char ed_smem[];
  const int K = a.K, nd = a.dm.ndim;
  if (SHARED) {
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      if (a.o_sum >= 0) smem_at<double>(ed_smem, a.o_sum)[i] = 0.0;
      if (a.o_sum2 >= 0) smem_at<double>(ed_smem, a.o_sum2)[i] = 0.0;
      if (a.o_kmin >= 0) smem_at<long long>(ed_smem, a.o_kmin)[i] = kKeyMax;
      if (a.o_kmax >= 0) smem_at<long long>(ed_smem, a.o_kmax)[i] = kKeyMin;
      if (a.o_count >= 0) smem_at<unsigned>(ed_smem, a.o_count)[i] = 0u;
      for (int k = 0; k < nd; ++k) {
        if (a.o_csum >= 0)
          smem_at<double>(ed_smem, a.o_csum)[i * nd + k] = 0.0;
        if (a.o_cmin >= 0)
          smem_at<int>(ed_smem, a.o_cmin)[i * nd + k] = 0x7fffffff;
        if (a.o_cmax >= 0) smem_at<int>(ed_smem, a.o_cmax)[i * nd + k] = -1;
      }
    }
    if (a.o_hist >= 0)
      for (int i = threadIdx.x; i < K * a.bins; i += blockDim.x)
        smem_at<unsigned>(ed_smem, a.o_hist)[i] = 0u;
    __syncthreads();
  }
  const unsigned lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const unsigned groups = (a.total + 31) / 32;
  unsigned g = SHARED ? blockIdx.x * a.chunk : blockIdx.x * warps;
  const unsigned gend = SHARED ? min(groups, g + a.chunk) : groups;
  const unsigned step = SHARED ? warps : gridDim.x * warps;
  const bool want_f = a.sum || a.sum2 || a.csum || a.hist;
  const bool want_c = a.csum || a.cmin;
  for (g += threadIdx.x >> 5; g < gend; g += step) {
    const unsigned v = g * 32 + lane;
    const int seg = v < a.total ? segment_of(a, v) : -1;
    const bool in = seg >= 0;
    const unsigned peers =
        __match_any_sync(ED_FULL, in ? seg : -2 - (int)lane);
    const bool lead = in && (peers & ((1u << lane) - 1u)) == 0;
    const double f = in && want_f ? load_f64(a.x, a.xcode, v) : 0.0;
    unsigned c[ED_MEAS_MAXD];
#pragma unroll
    for (int k = 0; k < ED_MEAS_MAXD; ++k) c[k] = 0;
    if (in && want_c) coords_of(v, a.dm, c);
    double s = f, s2 = f * f, cs[ED_MEAS_MAXD];
    int lo[ED_MEAS_MAXD], hi[ED_MEAS_MAXD];
#pragma unroll
    for (int k = 0; k < ED_MEAS_MAXD; ++k) {
      cs[k] = f * (double)c[k];
      lo[k] = (int)c[k];
      hi[k] = (int)c[k];
    }
    long long kmn = a.kmin && in ? load_key(a.x, a.xcode, v, kKeyMin)
                                 : kKeyMax;
    long long kmx = a.kmax && in ? load_key(a.x, a.xcode, v, kKeyMax)
                                 : kKeyMin;
    PeerRounds rounds(peers);
    int src;
    while (rounds.next(&src)) {
      const int from = src < 0 ? (int)lane : src;
      if (a.sum) {
        const double t = __shfl_sync(ED_FULL, s, from);
        if (src >= 0) s += t;
      }
      if (a.sum2) {
        const double t = __shfl_sync(ED_FULL, s2, from);
        if (src >= 0) s2 += t;
      }
      if (a.kmin) {
        const long long t = __shfl_sync(ED_FULL, kmn, from);
        if (src >= 0 && t < kmn) kmn = t;
      }
      if (a.kmax) {
        const long long t = __shfl_sync(ED_FULL, kmx, from);
        if (src >= 0 && t > kmx) kmx = t;
      }
#pragma unroll
      for (int k = 0; k < ED_MEAS_MAXD; ++k) {
        if (k < nd && a.csum) {
          const double t = __shfl_sync(ED_FULL, cs[k], from);
          if (src >= 0) cs[k] += t;
        }
        if (k < nd && a.cmin) {
          const int tl = __shfl_sync(ED_FULL, lo[k], from);
          const int th = __shfl_sync(ED_FULL, hi[k], from);
          if (src >= 0) {
            lo[k] = min(lo[k], tl);
            hi[k] = max(hi[k], th);
          }
        }
      }
    }
    if (lead) {
      const unsigned n = __popc(peers);
      if (SHARED) {
        if (a.sum) atomicAdd(smem_at<double>(ed_smem, a.o_sum) + seg, s);
        if (a.sum2) atomicAdd(smem_at<double>(ed_smem, a.o_sum2) + seg, s2);
        if (a.count) atomicAdd(smem_at<unsigned>(ed_smem, a.o_count) + seg, n);
        if (a.kmin)
          atomicMin(smem_at<long long>(ed_smem, a.o_kmin) + seg, kmn);
        if (a.kmax)
          atomicMax(smem_at<long long>(ed_smem, a.o_kmax) + seg, kmx);
#pragma unroll
        for (int k = 0; k < ED_MEAS_MAXD; ++k) {
          if (k < nd && a.csum)
            atomicAdd(smem_at<double>(ed_smem, a.o_csum) + seg * nd + k,
                      cs[k]);
          if (k < nd && a.cmin) {
            atomicMin(smem_at<int>(ed_smem, a.o_cmin) + seg * nd + k, lo[k]);
            atomicMax(smem_at<int>(ed_smem, a.o_cmax) + seg * nd + k, hi[k]);
          }
        }
      } else {
        if (a.sum) atomicAdd(a.sum + seg, s);
        if (a.sum2) atomicAdd(a.sum2 + seg, s2);
        if (a.count) atomicAdd(a.count + seg, (unsigned long long)n);
        if (a.kmin) atomicMin(a.kmin + seg, kmn);
        if (a.kmax) atomicMax(a.kmax + seg, kmx);
#pragma unroll
        for (int k = 0; k < ED_MEAS_MAXD; ++k) {
          if (k < nd && a.csum)
            atomicAdd(a.csum + (size_t)seg * nd + k, cs[k]);
          if (k < nd && a.cmin) {
            atomicMin(a.cmin + (size_t)seg * nd + k, lo[k]);
            atomicMax(a.cmax + (size_t)seg * nd + k, hi[k]);
          }
        }
      }
    }
    if (a.hist) {
      // histogram's bucket, floor((f - lo) * bins / (hi - lo)) in that
      // order, kept where lo <= f < hi, clipped; a bucket's lanes counted
      // by their group's lowest lane
      const bool ok = in && f >= a.lo && f < a.hi;
      long long key = -2 - (long long)lane;
      if (ok) {
        long long q = (long long)floor((f - a.lo) * (double)a.bins / a.span);
        q = q < 0 ? 0 : (q >= a.bins ? a.bins - 1 : q);
        key = (long long)seg * a.bins + q;
      }
      const unsigned hp = __match_any_sync(ED_FULL, key);
      if (ok && (hp & ((1u << lane) - 1u)) == 0) {
        if (SHARED)
          atomicAdd(smem_at<unsigned>(ed_smem, a.o_hist) + key,
                    (unsigned)__popc(hp));
        else
          atomicAdd(a.hist + key, (unsigned long long)__popc(hp));
      }
    }
  }
  if (SHARED) {
    // flush the accumulators this block touched (an initial value adds
    // nothing: +0.0 + -0.0 is +0.0, as the sum's start)
    __syncthreads();
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      if (a.o_sum >= 0) {
        const double t = smem_at<double>(ed_smem, a.o_sum)[i];
        if (t != 0.0) atomicAdd(a.sum + i, t);
      }
      if (a.o_sum2 >= 0) {
        const double t = smem_at<double>(ed_smem, a.o_sum2)[i];
        if (t != 0.0) atomicAdd(a.sum2 + i, t);
      }
      if (a.o_count >= 0) {
        const unsigned t = smem_at<unsigned>(ed_smem, a.o_count)[i];
        if (t) atomicAdd(a.count + i, (unsigned long long)t);
      }
      if (a.o_kmin >= 0) {
        const long long t = smem_at<long long>(ed_smem, a.o_kmin)[i];
        if (t != kKeyMax) atomicMin(a.kmin + i, t);
      }
      if (a.o_kmax >= 0) {
        const long long t = smem_at<long long>(ed_smem, a.o_kmax)[i];
        if (t != kKeyMin) atomicMax(a.kmax + i, t);
      }
      for (int k = 0; k < nd; ++k) {
        const int j = i * nd + k;
        if (a.o_csum >= 0) {
          const double t = smem_at<double>(ed_smem, a.o_csum)[j];
          if (t != 0.0) atomicAdd(a.csum + j, t);
        }
        if (a.o_cmin >= 0) {
          const int tl = smem_at<int>(ed_smem, a.o_cmin)[j];
          const int th = smem_at<int>(ed_smem, a.o_cmax)[j];
          if (tl != 0x7fffffff) atomicMin(a.cmin + j, tl);
          if (th != -1) atomicMax(a.cmax + j, th);
        }
      }
    }
    if (a.o_hist >= 0)
      for (int i = threadIdx.x; i < K * a.bins; i += blockDim.x) {
        const unsigned t = smem_at<unsigned>(ed_smem, a.o_hist)[i];
        if (t) atomicAdd(a.hist + i, (unsigned long long)t);
      }
  }
}

// ---------------------------------------------------------------------------
// K20

// x's element i equals the value whose order key is `key` (== in x's dtype;
// the NaN keys, the extremes, equal nothing)
__device__ __forceinline__ bool equals_key(const void* p, int code,
                                           unsigned i, long long key) {
  if (code == kF32 || code == kF64) {
    if (key == kKeyMin || key == kKeyMax) return false;
    if (code == kF32) {
      const int k = (int)key;
      const float e = __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
      return static_cast<const float*>(p)[i] == e;
    }
    const double e = __longlong_as_double(key >= 0 ? key : key ^ kKeyMax);
    return static_cast<const double*>(p)[i] == e;
  }
  return load_key(p, code, i, 0) == key;
}

__global__ void __launch_bounds__(ED_MEAS_THREADS)
segment_position_kernel(const SegArgs a, const long long* __restrict__ keys,
                        long long* __restrict__ pos) {
  const unsigned lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const unsigned groups = (a.total + 31) / 32;
  for (unsigned g = blockIdx.x * warps + (threadIdx.x >> 5); g < groups;
       g += gridDim.x * warps) {
    const unsigned v = g * 32 + lane;
    const int seg = v < a.total ? segment_of(a, v) : -1;
    const bool hit =
        seg >= 0 && equals_key(a.x, a.xcode, v, __ldg(keys + seg));
    const unsigned peers =
        __match_any_sync(ED_FULL, hit ? seg : -2 - (int)lane);
    if (hit && (peers & ((1u << lane) - 1u)) == 0)
      atomicMin(pos + seg, (long long)v);
  }
}

bool seg_args(const void* x, int xcode, const void* lab, int lcode,
              const int* lut, long long lut_size, int ndim,
              const long long* shape, SegArgs* a) {
  long long total;
  *a = SegArgs{};
  if (!make_dims(ndim, shape, &a->dm, &total) || xcode < kBool ||
      xcode > kF64 || (lab && (lcode < kBool || lcode > kF64)) ||
      (lut && lut_size < 1))
    return false;
  a->x = x;
  a->xcode = xcode;
  a->lab = lab;
  a->lcode = lcode;
  a->lut = lut;
  a->lut_size = lut_size;
  a->total = (unsigned)total;
  a->o_sum = a->o_sum2 = a->o_csum = a->o_kmin = a->o_kmax = a->o_count =
      a->o_cmin = a->o_cmax = a->o_hist = -1;
  return true;
}

// the shared route's layout: the 8-byte accumulators, then the 4-byte ones
// (ops/measure.py segment_smem); returns the bytes
long long shared_layout(SegArgs* a) {
  const long long K = a->K, nd = a->dm.ndim;
  long long off = 0;
  auto put = [&](bool want, long long bytes, int* o) {
    if (!want) return;
    *o = (int)(off < (1ll << 30) ? off : (1ll << 30));
    off += bytes;
  };
  put(a->sum, 8 * K, &a->o_sum);
  put(a->sum2, 8 * K, &a->o_sum2);
  put(a->kmin, 8 * K, &a->o_kmin);
  put(a->kmax, 8 * K, &a->o_kmax);
  put(a->csum, 8 * K * nd, &a->o_csum);
  put(a->count, 4 * K, &a->o_count);
  put(a->cmin, 4 * K * nd, &a->o_cmin);
  put(a->cmax, 4 * K * nd, &a->o_cmax);
  put(a->hist, 4 * K * a->bins, &a->o_hist);
  return off;
}

}  // namespace

extern "C" {

// K18 on a contiguous bool mask of `ndim` axes (fewer than 2^31 voxels):
// roots (int32, the mask's shape) each foreground voxel's least raveled
// index in its component, total for a background voxel; flags (null or
// int32) 1 at each root; taps ntaps (linear offset, edge word) pairs, the
// structure's offsets of lower raveled index. Init, merge and compress from
// this one call. Returns the first launch's error (cudaGetLastError()), or
// 0.
int ed_label_roots(const void* fg, int* roots, int* flags, const int* taps,
                   int ntaps, const long long* shape, int ndim,
                   void* stream) {
  Dims dm;
  long long total;
  if (!make_dims(ndim, shape, &dm, &total) || ntaps < 0 ||
      (ntaps && !taps))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(fg);
  const unsigned n = (unsigned)total, grid = grid_for(total);
  uf_init_kernel<<<grid, ED_MEAS_THREADS, 0, st>>>(m, roots, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (ntaps) {
    uf_merge_kernel<<<grid, ED_MEAS_THREADS, 0, st>>>(
        m, roots, reinterpret_cast<const int2*>(taps), ntaps, dm, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  uf_compress_kernel<<<grid, ED_MEAS_THREADS, 0, st>>>(roots, flags, n);
  return (int)cudaGetLastError();
}

// K18's numbering: out[v] = cum[roots[v]] where roots[v] < total, else 0;
// cum the inclusive count of the root flags (int32).
int ed_label_number(const int* roots, const int* cum, int* out,
                    long long total, void* stream) {
  if (total < 1 || total >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  label_number_kernel<<<grid_for(total), ED_MEAS_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      roots, cum, out, (unsigned)total);
  return (int)cudaGetLastError();
}

// K19 on the contiguous input x (dtype code xcode) of `ndim` axes and the
// labels lab (null, or x's shape, code lcode) with the table lut (null, or
// lut_size int32 segments, -1 excluded) into K segments: each non-null
// accumulator, initialised by the caller (sums and counts 0, kmin INT64_MAX,
// kmax INT64_MIN, cmin INT32_MAX, cmax -1), gets the voxels' terms; hist
// (K x bins) counts buckets of [lo, hi) (span = hi - lo as the caller
// computes it). shared: the shared route (every accumulator in the block's
// shared memory); blocks: the grid. Returns the launch's error, or 0.
int ed_segment_reduce(const void* x, int xcode, const void* lab, int lcode,
                      const int* lut, long long lut_size, int ndim,
                      const long long* shape, int K, double* sum,
                      double* sum2, unsigned long long* count, double* csum,
                      long long* kmin, long long* kmax, int* cmin, int* cmax,
                      unsigned long long* hist, int bins, double lo,
                      double hi, double span, int shared, int blocks,
                      void* stream) {
  SegArgs a;
  if (!seg_args(x, xcode, lab, lcode, lut, lut_size, ndim, shape, &a) ||
      K < 1 || blocks < 1 || (hist && bins < 1) || (!cmin != !cmax))
    return (int)cudaErrorInvalidValue;
  a.K = K;
  a.bins = bins;
  a.sum = sum;
  a.sum2 = sum2;
  a.count = count;
  a.csum = csum;
  a.kmin = kmin;
  a.kmax = kmax;
  a.cmin = cmin;
  a.cmax = cmax;
  a.hist = hist;
  a.lo = lo;
  a.hi = hi;
  a.span = span;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared) {
    const long long smem = shared_layout(&a);
    if (smem > ED_SEG_SMEM_MAX) return (int)cudaErrorInvalidValue;
    const unsigned groups = (a.total + 31) / 32;
    a.chunk = (groups + (unsigned)blocks - 1) / (unsigned)blocks;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          segment_reduce_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    segment_reduce_kernel<true><<<blocks, ED_SEG_SHARED_THREADS,
                                   (size_t)smem, st>>>(a);
  } else {
    segment_reduce_kernel<false><<<blocks, ED_MEAS_THREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// K20: pos[s] (initialised by the caller to the voxel count) = the least
// raveled index of a voxel of segment s equal to the value whose order key
// is keys[s]; x, lab, lut as K19's; blocks: the grid. Returns the launch's
// error, or 0.
int ed_segment_position(const void* x, int xcode, const void* lab,
                        int lcode, const int* lut, long long lut_size,
                        int ndim, const long long* shape, int blocks,
                        const long long* keys, long long* pos,
                        void* stream) {
  SegArgs a;
  if (!seg_args(x, xcode, lab, lcode, lut, lut_size, ndim, shape, &a) ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  segment_position_kernel<<<blocks, ED_MEAS_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(a, keys,
                                                                 pos);
  return (int)cudaGetLastError();
}

const char* ed_measure_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
