// K1 resample_fwd: B-spline resampling of N-D images at displaced
// coordinates, one thread per (sample, output voxel).
//
// Replaces the JAX package's forward resample stage:
// elasticdeform_tpu/ops/resample.py:66 resample_linear, which is tap for tap
// the same as elasticdeform_tpu/ops/windows.py:1213 _windows_op /
// :1385 resample_windows (an XLA gather on the TPU, no Pallas kernel).
// Its plain PyTorch twin is ops/resample.py:resample_plain.
//
// What it computes, per sample b and output voxel j (naxis <= ED_MAXD):
//   cc_h = sum_l A[h,l] * j_l + A[h,naxis] + offset_h + displ[b,h,j]
//          (A = inverse affine, shared or per sample; without one cc_h = j_h
//          + offset_h + displ; the affine acts on j without the crop offset,
//          ops/deform.py:148-169 of the JAX package)
//   m_h  = the boundary-mode fold of cc_h (ops/modes.py:52), pre-SciPy-1.6
//   out[b,j,c] = sum over the (order+1)^naxis taps t of
//          prod_h w_h[t_h] * coeffs[b, fold(start_h + t_h), c]
//   where start/w are filter_start / spline_weights (ops/bspline.py) and
//   fold is the integer mirror fold (mirror_index_np) into the UNPADDED
//   coefficient array, so no padded copy is ever made. Constant mode
//   writes cval where any cc_h lies outside [0, len_h - 1].
//
// Bound on the H100: bytes. Each output voxel reads naxis displacement
// values and writes C outputs; the coefficients are read once if the
// (order+1)^naxis taps of neighbouring threads hit L1/L2, which they do for
// smooth displacement fields. Bytes moved at least
//   B*(n_in*C + naxis*n_out + n_out*C) * sizeof(T), over 3.35 TB/s.
//
// Design, for a kernel that waits on its gathers (as K5, resample_bwd.cu):
// * No 64-bit division. The grid's y walks the batch; the voxel index
//   unravels in the index type I; a run of taps that lies inside its axis
//   takes (start + t) * stride, and only a run over an edge takes the
//   integer mirror fold (resample_common.cuh voxel_coords, tap_offsets).
// * Offsets within a sample are int32 when every sample is under 2^31
//   elements (fits_32; the wrappers' wide_indices), in elements with the
//   channel stride folded in; the sample's base is an int64 pointer.
// * The rank is a template parameter, so every table index is a
//   compile-time constant and the weights and tap offsets stay in
//   registers. The two innermost axes are unrolled up to order 3, one
//   above; an outer axis loops over its taps and picks its table entries
//   by selects. The coordinate source (K1 or K1c) and the table's dtype
//   are run-time arguments, so 96 instantiations (order 0-5, rank 1-4,
//   float32/float64, int32/int64 offsets) serve every call.
// * The launch bounds ask for as many blocks per SM as fit the tables
//   without a spill (FwdBlocks).
// Neighbouring threads take neighbouring output voxels, so the displacement
// reads and output writes coalesce and a warp's taps fall in a few cache
// lines; the per-axis tap offsets and weights are computed once per voxel
// and reused for every channel.
//
// Numerics: built with --fmad=false and with every constant cast to T, so
// each operation rounds as PyTorch's elementwise operations do; the taps
// are summed in the plain version's order (axis 0 slowest, the first tap
// assigned, not added), and the weight product is formed left to right
// (its prefixes hoisted out of the inner axes, which leaves each product
// as it was). The kernel therefore reproduces the plain version up to the
// rounding of the dense displacement it is given.
//
// Narrow table (the JAX package's opt-in table_dtype, ops/windows.py:1201
// _cast_table): both entry points take the dtype in which the coefficients
// lie, T itself, bfloat16, or float32 under a float64 T. The load converts
// it to T exactly (bfloat16 is the top half of a float32), and all
// arithmetic stays in T, so the kernel matches its twin, which rounds the
// coefficients to the table and back. A bfloat16 table halves the
// coefficient bytes of the gather.
//
// K1c resample_coords_fwd is the same kernel with the coordinate source of
// resample_common.cuh: cc_h = coords[b, h, v] as the caller gives them
// (B, naxis, n_out), output (B, n_out, C) of any output rank. It replaces
// the JAX package's map_coordinates resample stage
// (elasticdeform_tpu/ops/deform.py:533 map_coordinates_apply, :573
// map_coordinates_apply_batched, which run _deform_one_linear(_batched),
// ops/deform.py:270, at the caller's coordinates). Its plain twin is
// ops/resample.py:resample_coords_plain. Bound: bytes, B*(n_in*C +
// naxis*n_out + n_out*C) * sizeof(T).

#include "resample_common.cuh"

namespace {

// The coefficient table's dtype: the compute type T, bfloat16, or float32
// under a float64 T (the C entry points' `table`).
enum { TABLE_SAME = 0, TABLE_BF16 = 1, TABLE_F32 = 2 };

// Coefficient i of the table at `src`, converted exactly to T.
template <typename T, typename I>
__device__ __forceinline__ T load_coeff(const void* __restrict__ src,
                                        const int table, const I i) {
  if (table == TABLE_BF16) {
    const unsigned short bits =
        __ldg(static_cast<const unsigned short*>(src) + i);
    return T(__uint_as_float(((unsigned)bits) << 16));
  }
  if constexpr (sizeof(T) == 8) {
    if (table == TABLE_F32) return T(__ldg(static_cast<const float*>(src) + i));
  }
  return __ldg(static_cast<const T*>(src) + i);
}

template <typename T, int NT, int NAXIS, int H, typename I>
__device__ __forceinline__ void fwd_axis(
    const void* __restrict__ src, int table, T wpre, I base,
    const T (&w)[NAXIS][NT], const I (&off)[NAXIS][NT], T& acc, bool& first);

// Tap t of axis H, whose weight product over axes 0..H is wt and whose
// element offset is o: at the innermost axis the channel takes wt *
// coefficient (at the voxel's first tap) or adds it; above, the taps of the
// next axis.
template <typename T, int NT, int NAXIS, int H, typename I>
__device__ __forceinline__ void fwd_tap(
    const void* __restrict__ src, const int table, const T wt, const I o,
    const T (&w)[NAXIS][NT], const I (&off)[NAXIS][NT], T& acc,
    bool& first) {
  if constexpr (H == NAXIS - 1) {
    const T contrib = wt * load_coeff<T>(src, table, o);
    acc = first ? contrib : acc + contrib;
    first = false;
  } else {
    fwd_axis<T, NT, NAXIS, H + 1, I>(src, table, wt, o, w, off, acc, first);
  }
}

// The taps of axes H..NAXIS-1 of one voxel, axis H slowest: `wpre` is the
// weight product over axes 0..H-1 and `base` their element offset.
template <typename T, int NT, int NAXIS, int H, typename I>
__device__ __forceinline__ void fwd_axis(
    const void* __restrict__ src, const int table, const T wpre,
    const I base, const T (&w)[NAXIS][NT], const I (&off)[NAXIS][NT],
    T& acc, bool& first) {
  if constexpr (H >= NAXIS - unrolled_axes(NT, NAXIS)) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
      fwd_tap<T, NT, NAXIS, H, I>(src, table, H == 0 ? w[H][t]
                                                     : wpre * w[H][t],
                                  base + off[H][t], w, off, acc, first);
  } else {
#pragma unroll 1
    for (int t = 0; t < NT; ++t) {
      const T wh = pick(w[H], t);
      fwd_tap<T, NT, NAXIS, H, I>(src, table, H == 0 ? wh : wpre * wh,
                                  base + pick(off[H], t), w, off, acc,
                                  first);
    }
  }
}

// One output voxel v of sample b: its coordinates, the mode fold and first
// tap of each axis, then (inside) the rank-NAXIS tables of weights and tap
// offsets and the taps, one channel at a time (no channel count is
// unrolled, so one channel, the common case, spends nothing on others).
template <typename T, int ORDER, int NAXIS, typename I>
__device__ __forceinline__ void resample_voxel(
    const void* __restrict__ coeffs, const T* __restrict__ displ,
    const T* __restrict__ affine, T* __restrict__ out, const Params& p,
    const bool coords, const int table, const int64_t b, const I v) {
  constexpr int NT = ORDER + 1;
  const I C = (I)p.channels;
  T* dst = out + b * p.n_out * p.channels + v * C;
  T cc[NAXIS];
  voxel_coords<T, NAXIS, I>(p, displ, affine, coords, b, v, cc);
  T m[NAXIS];
  I start[NAXIS];
  bool inside = true;
#pragma unroll
  for (int h = 0; h < NAXIS; ++h) {
    m[h] = map_coord(cc[h], p.in_shape[h], p.mode, &inside);
    start[h] = first_tap<T, ORDER, I>(m[h]);
  }
  if (!inside) {
    for (I c = 0; c < C; ++c) dst[c] = T(p.cval);
    return;
  }
  T w[NAXIS][NT];
#pragma unroll
  for (int h = 0; h < NAXIS; ++h) spline_weights<T, ORDER>(m[h], w[h]);
  I off[NAXIS][NT];
  tap_offsets<NT, NAXIS, I>(p, start, off);

  // the sample's base as a typed pointer: a byte offset (the sample's
  // elements times a run-time element size) cost 1-D order 1 a spill
  const int64_t sample = b * p.n_in * p.channels;
  const void* src =
      table == TABLE_BF16
          ? static_cast<const void*>(
                static_cast<const unsigned short*>(coeffs) + sample)
      : table == TABLE_F32
          ? static_cast<const void*>(static_cast<const float*>(coeffs) +
                                     sample)
          : static_cast<const void*>(static_cast<const T*>(coeffs) + sample);
  for (I c = 0; c < C; ++c) {
    T acc;
    bool first = true;
    fwd_axis<T, NT, NAXIS, 0, I>(src, table, T(1), c, w, off, acc, first);
    dst[c] = acc;
  }
}

// The blocks per SM that K1's launch bounds ask for, which set ptxas's
// register budget to 65536 / (256 * blocks): for float32 with 32-bit
// offsets, by the taps of a voxel, 6 (40 registers) up to 8 taps, 5 (48)
// up to 64 and 3 (80) above, the most blocks whose budget holds the tables
// and the unrolled taps without a spill at orders 1 and 3 (4-D order 5
// keeps an 8-byte stack frame). An A/B on the card chose them (PERF.md
// section 6): K1 waits on its gathers, so occupancy sets its speed, but 8
// blocks up to 8 taps ran slower than 6.
// float64 and 64-bit offsets take one block: their tables are twice as
// wide, and they are not the hot path.
template <typename T, int NT, int NAXIS, typename I>
struct FwdBlocks {
  static constexpr int taps = voxel_taps(NT, NAXIS);
  static constexpr int value = sizeof(T) > 4 || sizeof(I) > 4 ? 1
                               : taps <= 8                     ? 6
                               : taps <= 64                    ? 5
                                                               : 3;
};

// One thread per output voxel of a sample; the grid's y walks the batch.
template <typename T, int ORDER, int NAXIS, typename I>
__global__ void __launch_bounds__(
    256, (FwdBlocks<T, ORDER + 1, NAXIS, I>::value))
resample_fwd_kernel(const void* __restrict__ coeffs,
                    const T* __restrict__ displ, const T* __restrict__ affine,
                    T* __restrict__ out, const Params p, const bool coords,
                    const int table) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= p.n_out) return;
  for (int64_t b = blockIdx.y; b < p.batch; b += gridDim.y)
    resample_voxel<T, ORDER, NAXIS, I>(coeffs, displ, affine, out, p, coords,
                                       table, b, (I)v);
}

struct FwdArgs {
  const void* coeffs;
  const void* displ;
  const void* affine;
  void* out;
  bool coords;
  int table;
};

template <typename T, int ORDER, int NAXIS, typename I>
cudaError_t launch(const FwdArgs& a, const Params& p, cudaStream_t stream) {
  const int threads = 256;
  const dim3 grid((unsigned)((p.n_out + threads - 1) / threads),
                  (unsigned)(p.batch < 65535 ? p.batch : 65535));
  resample_fwd_kernel<T, ORDER, NAXIS, I><<<grid, threads, 0, stream>>>(
      a.coeffs, static_cast<const T*>(a.displ),
      static_cast<const T*>(a.affine), static_cast<T*>(a.out), p, a.coords,
      a.table);
  return cudaGetLastError();
}

template <typename T, int ORDER, typename I>
cudaError_t dispatch_rank(const FwdArgs& a, const Params& p,
                          cudaStream_t s) {
  switch (p.naxis) {
    case 1: return launch<T, ORDER, 1, I>(a, p, s);
    case 2: return launch<T, ORDER, 2, I>(a, p, s);
    case 3: return launch<T, ORDER, 3, I>(a, p, s);
    case 4: return launch<T, ORDER, 4, I>(a, p, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename I>
cudaError_t dispatch_order(int order, const FwdArgs& a, const Params& p,
                           cudaStream_t s) {
  switch (order) {
    case 0: return dispatch_rank<T, 0, I>(a, p, s);
    case 1: return dispatch_rank<T, 1, I>(a, p, s);
    case 2: return dispatch_rank<T, 2, I>(a, p, s);
    case 3: return dispatch_rank<T, 3, I>(a, p, s);
    case 4: return dispatch_rank<T, 4, I>(a, p, s);
    case 5: return dispatch_rank<T, 5, I>(a, p, s);
  }
  return cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 float64; table: TABLE_SAME, TABLE_BF16, or
// TABLE_F32 with dtype 1 only. Refuses 32-bit offsets that do not reach
// every element of a sample.
cudaError_t dispatch(int dtype, int order, bool wide, const FwdArgs& a,
                     const Params& p, cudaStream_t s) {
  if (a.table < TABLE_SAME || a.table > TABLE_F32 ||
      (a.table == TABLE_F32 && dtype != 1) || (!wide && !fits_32(p)))
    return cudaErrorInvalidValue;
  if (p.batch * p.n_out * p.channels == 0) return cudaSuccess;
  if (dtype == 0)
    return wide ? dispatch_order<float, int64_t>(order, a, p, s)
                : dispatch_order<float, int32_t>(order, a, p, s);
  if (dtype == 1)
    return wide ? dispatch_order<double, int64_t>(order, a, p, s)
                : dispatch_order<double, int32_t>(order, a, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64; table: the coefficients' dtype, 0 dtype,
// 1 bfloat16, 2 float32 (dtype 1 only). Shapes, offsets: naxis int64 each.
// affine: null, or (naxis, naxis+1) per sample at affine_stride elements
// apart (0 = one affine shared by the batch). wide: 64-bit offsets within
// a sample (required once a sample reaches 2^31 elements). Returns
// cudaGetLastError().
int ed_resample_fwd(int dtype, const void* coeffs, const void* displ,
                    const void* affine, void* out, int naxis, int order,
                    int mode, long long batch, long long channels,
                    const long long* in_shape, const long long* out_shape,
                    const long long* offsets, long long affine_stride,
                    double cval, int table, void* stream, int wide) {
  Params p;
  if (!make_params(&p, naxis, mode, batch, channels, in_shape, out_shape,
                   offsets, affine_stride, cval))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{coeffs, displ, affine, out, false, table};
  return (int)dispatch(dtype, order, wide != 0, a, p,
                       static_cast<cudaStream_t>(stream));
}

// K1c: coords (B, naxis, n_out) are the sample coordinates; out (B, n_out,
// C). in_shape: naxis int64; table and wide as above. Returns
// cudaGetLastError().
int ed_resample_coords_fwd(int dtype, const void* coeffs, const void* coords,
                           void* out, int naxis, int order, int mode,
                           long long batch, long long channels,
                           const long long* in_shape, long long n_out,
                           double cval, int table, void* stream, int wide) {
  Params p;
  if (!make_params_coords(&p, naxis, mode, batch, channels, in_shape, n_out,
                          cval))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{coeffs, coords, nullptr, out, true, table};
  return (int)dispatch(dtype, order, wide != 0, a, p,
                       static_cast<cudaStream_t>(stream));
}

const char* ed_resample_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
