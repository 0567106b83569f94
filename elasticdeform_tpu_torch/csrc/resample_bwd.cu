// The adjoints of K1 (resample.cu), one thread per (sample, output voxel):
//
// K3 resample_bwd: the transpose of K1 with respect to the coefficients, a
// scatter. For each output voxel j inside the constant-mode mask and each
// of the (order+1)^naxis taps t:
//   d_coeffs[b, fold(start + t), c] += g[b, j, c] * prod_h w_h[t_h]
// with K1's coordinates, mode fold, tap fold and weights
// (resample_common.cuh). K1 reads the UNPADDED coefficients at the mirror
// fold of each tap index, so K3 adds straight into the folded index: no
// padded buffer and no separate un-pad fold. That equals the JAX package's
// scatter into the mirror-padded table followed by the fold of the pad
// (elasticdeform_tpu/ops/windows.py:1354 resample_windows_transpose, :1174
// _scatter_fold, :1135 _scatter_group, :1488 window_unpad_axis; an XLA
// scatter on the TPU, no Pallas kernel); the adjoint identity against K1
// checks it. Taps of one voxel fold onto one element on short axes and
// neighbouring voxels share elements: atomicAdd (float64 is native on
// sm_90) handles both, so the sums land in a run-dependent order, and the
// float32 result agrees with the plain twin
// (ops/resample_bwd.py:resample_transpose_plain) only to the rounding of a
// reordered sum. The caller zero-fills d_coeffs.
//
// K5 resample_coord_grad: the gradient of <K1(coeffs), g> with respect to
// the dense displacement. Per voxel and axis h (cc = A j + offset + displ,
// so d/d displ_h = d/d cc_h):
//   d_displ[b, h, j] = fold'_h(cc_h) * sum_taps (sum_c g[b,j,c] *
//                      coeffs[b, fold(start+t), c]) * w'_h[t_h] *
//                      prod_{l != h} w_l[t_l]
// and 0 where constant mode falls outside (the d_cc branch of
// elasticdeform_tpu/ops/windows.py:1247 _windows_op_bwd, :1277-1308, which
// JAX forms by forward mode through the weight polynomials). fold' is 0.5
// at the clip ties of nearest and constant, as JAX's jnp.clip gives. The
// channels are summed in order and the taps axis 0 slowest, the weight
// products left to right, as the plain twin
// (ops/resample_bwd.py:resample_coord_grad_plain) does.
//
// Bounds on the H100: bytes. K3 reads g and the dense displacement
// (C + naxis values per voxel) and writes d_coeffs once (its zero fill is
// this design's extra cost); K5 reads the coefficients, g and the
// displacement and writes naxis values per voxel, and the operations it
// needs (the taps contracted axis by axis) take less time than those bytes.
// Design: the first, simple form. Neighbouring threads take
// neighbouring output voxels, so the g and displacement reads coalesce and
// a warp's taps fall in a few cache lines; K3's atomics resolve in L2.
// Offsets are int64.
//
// Numerics: built with --fmad=false, every constant cast to T.

#include "resample_common.cuh"

#define ED_CCH 4

namespace {

template <typename T, int ORDER>
__global__ void __launch_bounds__(256)
resample_bwd_kernel(const T* __restrict__ g, const T* __restrict__ displ,
                    const T* __restrict__ affine, T* __restrict__ d_coeffs,
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
  if (!tap_tables<T, ORDER, false>(p, displ, affine, b, v, w, off, ntap,
                                   unused_dw, unused_fd))
    return;  // constant mode outside: g is zeroed there

  const int64_t C = p.channels;
  const T* src = g + gid * C;
  T* dst = d_coeffs + b * p.n_in * C;
  for (int64_t c0 = 0; c0 < C; c0 += ED_CCH) {
    T gk[ED_CCH];
#pragma unroll
    for (int k = 0; k < ED_CCH; ++k) gk[k] = c0 + k < C ? src[c0 + k] : T(0);
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
            T* q = dst + (o012 + off[3][t3]) * C + c0;
#pragma unroll
            for (int k = 0; k < ED_CCH; ++k)
              if (c0 + k < C) atomicAdd(q + k, gk[k] * wt);
          }
        }
      }
    }
  }
}

template <typename T, int ORDER>
__global__ void __launch_bounds__(256)
resample_coord_grad_kernel(const T* __restrict__ coeffs,
                           const T* __restrict__ g,
                           const T* __restrict__ displ,
                           const T* __restrict__ affine,
                           T* __restrict__ d_displ, const Params p) {
  constexpr int NT = ORDER + 1;
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= p.batch * p.n_out) return;
  const int64_t b = gid / p.n_out;
  const int64_t v = gid - b * p.n_out;
  const int naxis = p.naxis;
  const int lead = ED_MAXD - naxis;
  T* dst = d_displ + b * naxis * p.n_out + v;

  T w[ED_MAXD][NT];
  int64_t off[ED_MAXD][NT];
  int ntap[ED_MAXD];
  T dw[ED_MAXD][NT], fd[ED_MAXD];
  const bool inside = tap_tables<T, ORDER, true>(p, displ, affine, b, v, w,
                                                 off, ntap, dw, fd);
  if (!inside || ORDER == 0) {
    // outside the constant-mode mask, and at order 0 (one tap of weight
    // 1), the output does not depend on the coordinate
    for (int h = 0; h < naxis; ++h) dst[h * p.n_out] = T(0);
    return;
  }

  const int64_t C = p.channels;
  const T* src = coeffs + b * p.n_in * C;
  const T* gv = g + gid * C;
  T acc[ED_MAXD];
  bool first = true;
  int t[ED_MAXD];
  for (t[0] = 0; t[0] < ntap[0]; ++t[0]) {
    for (t[1] = 0; t[1] < ntap[1]; ++t[1]) {
      for (t[2] = 0; t[2] < ntap[2]; ++t[2]) {
#pragma unroll
        for (int t3 = 0; t3 < NT; ++t3) {
          t[3] = t3;
          const T* q = src + (off[0][t[0]] + off[1][t[1]] + off[2][t[2]] +
                              off[3][t3]) * C;
          T gc = gv[0] * __ldg(q);
          for (int64_t c = 1; c < C; ++c) gc = gc + gv[c] * __ldg(q + c);
#pragma unroll
          for (int s = 0; s < ED_MAXD; ++s) {
            if (s < lead) continue;
            // product over the slots, left to right, with the derivative
            // weights in slot s
            T part = s == 0 ? dw[0][t[0]] : w[0][t[0]];
#pragma unroll
            for (int l = 1; l < ED_MAXD; ++l)
              part = part * (l == s ? dw[l][t[l]] : w[l][t[l]]);
            const T term = gc * part;
            acc[s] = first ? term : acc[s] + term;
          }
          first = false;
        }
      }
    }
  }
  for (int h = 0; h < naxis; ++h)
    dst[h * p.n_out] = fd[lead + h] * acc[lead + h];
}

template <typename T, int ORDER>
cudaError_t launch_bwd(const void* g, const void* displ, const void* affine,
                       void* d_coeffs, const Params& p, cudaStream_t stream) {
  const int64_t total = p.batch * p.n_out;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  resample_bwd_kernel<T, ORDER><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(displ),
      static_cast<const T*>(affine), static_cast<T*>(d_coeffs), p);
  return cudaGetLastError();
}

template <typename T, int ORDER>
cudaError_t launch_coord_grad(const void* coeffs, const void* g,
                              const void* displ, const void* affine,
                              void* d_displ, const Params& p,
                              cudaStream_t stream) {
  const int64_t total = p.batch * p.n_out;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  resample_coord_grad_kernel<T, ORDER>
      <<<(unsigned)blocks, threads, 0, stream>>>(
          static_cast<const T*>(coeffs), static_cast<const T*>(g),
          static_cast<const T*>(displ), static_cast<const T*>(affine),
          static_cast<T*>(d_displ), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(int order, const void* g, const void* displ,
                         const void* affine, void* d_coeffs, const Params& p,
                         cudaStream_t s) {
  switch (order) {
    case 0: return launch_bwd<T, 0>(g, displ, affine, d_coeffs, p, s);
    case 1: return launch_bwd<T, 1>(g, displ, affine, d_coeffs, p, s);
    case 2: return launch_bwd<T, 2>(g, displ, affine, d_coeffs, p, s);
    case 3: return launch_bwd<T, 3>(g, displ, affine, d_coeffs, p, s);
    case 4: return launch_bwd<T, 4>(g, displ, affine, d_coeffs, p, s);
    case 5: return launch_bwd<T, 5>(g, displ, affine, d_coeffs, p, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_coord_grad(int order, const void* coeffs, const void* g,
                                const void* displ, const void* affine,
                                void* d_displ, const Params& p,
                                cudaStream_t s) {
  switch (order) {
    case 0: return launch_coord_grad<T, 0>(coeffs, g, displ, affine, d_displ,
                                           p, s);
    case 1: return launch_coord_grad<T, 1>(coeffs, g, displ, affine, d_displ,
                                           p, s);
    case 2: return launch_coord_grad<T, 2>(coeffs, g, displ, affine, d_displ,
                                           p, s);
    case 3: return launch_coord_grad<T, 3>(coeffs, g, displ, affine, d_displ,
                                           p, s);
    case 4: return launch_coord_grad<T, 4>(coeffs, g, displ, affine, d_displ,
                                           p, s);
    case 5: return launch_coord_grad<T, 5>(coeffs, g, displ, affine, d_displ,
                                           p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64. Shapes, offsets: naxis int64 each.
// affine: null, or (naxis, naxis+1) per sample at affine_stride elements
// apart (0 = one affine shared by the batch). d_coeffs (B, *in_shape, C)
// must be zero-filled. Returns cudaGetLastError().
int ed_resample_bwd(int dtype, const void* g, const void* displ,
                    const void* affine, void* d_coeffs, int naxis, int order,
                    int mode, long long batch, long long channels,
                    const long long* in_shape, const long long* out_shape,
                    const long long* offsets, long long affine_stride,
                    void* stream) {
  Params p;
  if (!make_params(&p, naxis, mode, batch, channels, in_shape, out_shape,
                   offsets, affine_stride, 0.0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0   ? dispatch_bwd<float>(order, g, displ, affine, d_coeffs, p,
                                         s)
      : dtype == 1 ? dispatch_bwd<double>(order, g, displ, affine, d_coeffs,
                                          p, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

// As ed_resample_bwd; coeffs (B, *in_shape, C), g (B, *out_shape, C),
// d_displ (B, naxis, *out_shape), every element written.
int ed_resample_coord_grad(int dtype, const void* coeffs, const void* g,
                           const void* displ, const void* affine,
                           void* d_displ, int naxis, int order, int mode,
                           long long batch, long long channels,
                           const long long* in_shape,
                           const long long* out_shape,
                           const long long* offsets, long long affine_stride,
                           void* stream) {
  Params p;
  if (!make_params(&p, naxis, mode, batch, channels, in_shape, out_shape,
                   offsets, affine_stride, 0.0) || channels < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0   ? dispatch_coord_grad<float>(order, coeffs, g, displ,
                                                affine, d_displ, p, s)
      : dtype == 1 ? dispatch_coord_grad<double>(order, coeffs, g, displ,
                                                 affine, d_displ, p, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

const char* ed_resample_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
