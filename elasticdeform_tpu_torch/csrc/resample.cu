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

#include "resample_common.cuh"

#define ED_CCH 4

namespace {

template <typename T, int ORDER>
__global__ void __launch_bounds__(256)
resample_fwd_kernel(const T* __restrict__ coeffs, const T* __restrict__ displ,
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
  T unused_dw[ED_MAXD][NT], unused_fd[ED_MAXD];
  const bool inside = tap_tables<T, ORDER, false>(
      p, displ, affine, b, v, w, off, ntap, unused_dw, unused_fd);

  const int64_t C = p.channels;
  T* dst = out + gid * C;
  if (!inside) {
    for (int64_t c = 0; c < C; ++c) dst[c] = T(p.cval);
    return;
  }
  const T* src = coeffs + b * p.n_in * C;
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
            const T* q = src + (o012 + off[3][t3]) * C + c0;
#pragma unroll
            for (int k = 0; k < ED_CCH; ++k) {
              if (c0 + k < C) {
                const T contrib = wt * __ldg(q + k);
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

template <typename T, int ORDER>
cudaError_t launch(const void* coeffs, const void* displ, const void* affine,
                   void* out, const Params& p, cudaStream_t stream) {
  const int64_t total = p.batch * p.n_out;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  resample_fwd_kernel<T, ORDER><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(coeffs), static_cast<const T*>(displ),
      static_cast<const T*>(affine), static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int order, const void* coeffs, const void* displ,
                     const void* affine, void* out, const Params& p,
                     cudaStream_t stream) {
  switch (order) {
    case 0: return launch<T, 0>(coeffs, displ, affine, out, p, stream);
    case 1: return launch<T, 1>(coeffs, displ, affine, out, p, stream);
    case 2: return launch<T, 2>(coeffs, displ, affine, out, p, stream);
    case 3: return launch<T, 3>(coeffs, displ, affine, out, p, stream);
    case 4: return launch<T, 4>(coeffs, displ, affine, out, p, stream);
    case 5: return launch<T, 5>(coeffs, displ, affine, out, p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64. Shapes, offsets: naxis int64 each.
// affine: null, or (naxis, naxis+1) per sample at affine_stride elements
// apart (0 = one affine shared by the batch). Returns cudaGetLastError().
int ed_resample_fwd(int dtype, const void* coeffs, const void* displ,
                    const void* affine, void* out, int naxis, int order,
                    int mode, long long batch, long long channels,
                    const long long* in_shape, const long long* out_shape,
                    const long long* offsets, long long affine_stride,
                    double cval, void* stream) {
  Params p;
  if (!make_params(&p, naxis, mode, batch, channels, in_shape, out_shape,
                   offsets, affine_stride, cval))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
      ? dispatch<float>(order, coeffs, displ, affine, out, p, s)
      : dtype == 1 ? dispatch<double>(order, coeffs, displ, affine, out, p, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

const char* ed_resample_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
