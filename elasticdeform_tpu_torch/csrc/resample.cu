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
// Design: neighbouring threads take neighbouring output voxels, so the
// displacement reads and output writes coalesce and the tap reads of a warp
// fall in a few cache lines; the per-axis tap indices and weights are
// computed once per voxel into registers and reused for every channel chunk.
// Offsets are int64: B * n_in * C passes 2^31 at 64 x 128^3 x C.
//
// Numerics: built with --fmad=false and with every constant cast to T, so
// each operation rounds as PyTorch's elementwise operations do; the taps
// are summed in the plain version's order (axis 0 slowest), and the weight
// product is formed left to right. The kernel therefore reproduces the
// plain version up to the rounding of the dense displacement it is given.
// The coordinate, fold and weight code is in resample_common.cuh, shared
// with K3 and K5.
//
// Narrow table (the JAX package's opt-in table_dtype, ops/windows.py:1201
// _cast_table): both entry points take the dtype CT in which the
// coefficients lie, T itself, bfloat16, or float32 under a float64 T. The
// load converts CT to T exactly (bfloat16 is the top half of a float32), and
// all arithmetic stays in T, so the kernel matches its twin, which rounds
// the coefficients to CT and back. A bfloat16 table halves the coefficient
// bytes of the gather.
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

#include <cuda_bf16.h>

#include <type_traits>

#include "resample_common.cuh"

#define ED_CCH 4

namespace {

// One coefficient of the table, converted exactly to the compute type T.
template <typename T, typename CT>
__device__ __forceinline__ T load_coeff(const CT* q) {
  if constexpr (std::is_same<CT, __nv_bfloat16>::value) {
    const unsigned short bits =
        __ldg(reinterpret_cast<const unsigned short*>(q));
    return T(__uint_as_float(((unsigned)bits) << 16));
  } else {
    return T(__ldg(q));
  }
}

template <typename T, typename CT, int ORDER, bool COORDS>
__global__ void __launch_bounds__(256)
resample_fwd_kernel(const CT* __restrict__ coeffs, const T* __restrict__ displ,
                    const T* __restrict__ affine, T* __restrict__ out,
                    const Params p) {
  constexpr int NT = ORDER + 1;
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= p.batch * p.n_out) return;
  const int64_t b = gid / p.n_out;
  const int64_t v = gid - b * p.n_out;

  T w[ED_MAXD][NT];
  int64_t off[ED_MAXD][NT];
  int ntap[ED_MAXD];
  const bool inside =
      tap_tables<T, ORDER, COORDS>(p, displ, affine, b, v, w, off, ntap);

  const int64_t C = p.channels;
  T* dst = out + gid * C;
  if (!inside) {
    for (int64_t c = 0; c < C; ++c) dst[c] = T(p.cval);
    return;
  }
  const CT* src = coeffs + b * p.n_in * C;
  for (int64_t c0 = 0; c0 < C; c0 += ED_CCH) {
    T acc[ED_CCH];
    bool first = true;
    for (int t0 = 0; t0 < ntap[0]; ++t0) {
      for (int t1 = 0; t1 < ntap[1]; ++t1) {
        const T w01 = w[0][t0] * w[1][t1];
        const int64_t o01 = off[0][t0] + off[1][t1];
#pragma unroll
        for (int t2 = 0; t2 < NT; ++t2) {
          if (t2 >= ntap[2]) break;
          const T w012 = w01 * w[2][t2];
          const int64_t o012 = o01 + off[2][t2];
#pragma unroll
          for (int t3 = 0; t3 < NT; ++t3) {
            const T wt = w012 * w[3][t3];
            const CT* q = src + (o012 + off[3][t3]) * C + c0;
#pragma unroll
            for (int k = 0; k < ED_CCH; ++k) {
              if (c0 + k < C) {
                const T contrib = wt * load_coeff<T>(q + k);
                acc[k] = first ? contrib : acc[k] + contrib;
              }
            }
            first = false;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < ED_CCH; ++k)
      if (c0 + k < C) dst[c0 + k] = acc[k];
  }
}

template <typename T, typename CT, int ORDER, bool COORDS>
cudaError_t launch(const void* coeffs, const void* displ, const void* affine,
                   void* out, const Params& p, cudaStream_t stream) {
  const int64_t total = p.batch * p.n_out;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  resample_fwd_kernel<T, CT, ORDER, COORDS>
      <<<(unsigned)blocks, threads, 0, stream>>>(
          static_cast<const CT*>(coeffs), static_cast<const T*>(displ),
          static_cast<const T*>(affine), static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <typename T, typename CT, bool COORDS>
cudaError_t dispatch(int order, const void* coeffs, const void* displ,
                     const void* affine, void* out, const Params& p,
                     cudaStream_t s) {
  switch (order) {
    case 0: return launch<T, CT, 0, COORDS>(coeffs, displ, affine, out, p, s);
    case 1: return launch<T, CT, 1, COORDS>(coeffs, displ, affine, out, p, s);
    case 2: return launch<T, CT, 2, COORDS>(coeffs, displ, affine, out, p, s);
    case 3: return launch<T, CT, 3, COORDS>(coeffs, displ, affine, out, p, s);
    case 4: return launch<T, CT, 4, COORDS>(coeffs, displ, affine, out, p, s);
    case 5: return launch<T, CT, 5, COORDS>(coeffs, displ, affine, out, p, s);
  }
  return cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 float64; table: 0 the coefficients in that dtype,
// 1 bfloat16, 2 float32 (with dtype 1 only).
template <bool COORDS>
cudaError_t dispatch_table(int dtype, int table, int order,
                           const void* coeffs, const void* displ,
                           const void* affine, void* out, const Params& p,
                           cudaStream_t s) {
  if (dtype == 0 && table == 0)
    return dispatch<float, float, COORDS>(order, coeffs, displ, affine, out,
                                          p, s);
  if (dtype == 0 && table == 1)
    return dispatch<float, __nv_bfloat16, COORDS>(order, coeffs, displ,
                                                  affine, out, p, s);
  if (dtype == 1 && table == 0)
    return dispatch<double, double, COORDS>(order, coeffs, displ, affine,
                                            out, p, s);
  if (dtype == 1 && table == 1)
    return dispatch<double, __nv_bfloat16, COORDS>(order, coeffs, displ,
                                                   affine, out, p, s);
  if (dtype == 1 && table == 2)
    return dispatch<double, float, COORDS>(order, coeffs, displ, affine, out,
                                           p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64; table: the coefficients' dtype, 0 dtype,
// 1 bfloat16, 2 float32 (dtype 1 only). Shapes, offsets: naxis int64 each.
// affine: null, or (naxis, naxis+1) per sample at affine_stride elements
// apart (0 = one affine shared by the batch). Returns cudaGetLastError().
int ed_resample_fwd(int dtype, const void* coeffs, const void* displ,
                    const void* affine, void* out, int naxis, int order,
                    int mode, long long batch, long long channels,
                    const long long* in_shape, const long long* out_shape,
                    const long long* offsets, long long affine_stride,
                    double cval, int table, void* stream) {
  Params p;
  if (!make_params(&p, naxis, mode, batch, channels, in_shape, out_shape,
                   offsets, affine_stride, cval))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_table<false>(dtype, table, order, coeffs, displ,
                                    affine, out, p,
                                    static_cast<cudaStream_t>(stream));
}

// K1c: coords (B, naxis, n_out) are the sample coordinates; out (B, n_out,
// C). in_shape: naxis int64; table as above. Returns cudaGetLastError().
int ed_resample_coords_fwd(int dtype, const void* coeffs, const void* coords,
                           void* out, int naxis, int order, int mode,
                           long long batch, long long channels,
                           const long long* in_shape, long long n_out,
                           double cval, int table, void* stream) {
  Params p;
  if (!make_params_coords(&p, naxis, mode, batch, channels, in_shape, n_out,
                          cval))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_table<true>(dtype, table, order, coeffs, coords,
                                   nullptr, out, p,
                                   static_cast<cudaStream_t>(stream));
}

const char* ed_resample_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
