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
// reordered sum. The caller zero-fills d_coeffs. Bound on the H100: bytes;
// K3 reads g and the dense displacement (C + naxis values per voxel) and
// writes d_coeffs once (its zero fill is this design's extra cost). Design:
// the first, simple form. Neighbouring threads take neighbouring output
// voxels, so the g and displacement reads coalesce; the atomics resolve in
// L2. Offsets are int64.
//
// K5 resample_coord_grad: the gradient of <K1(coeffs), g> with respect to
// the dense displacement. Per voxel and axis h (cc = A j + offset + displ,
// so d/d displ_h = d/d cc_h):
//   d_displ[b, h, j] = fold'_h(cc_h) * sum_taps (sum_c g[b,j,c] *
//                      coeffs[b, fold(start+t), c]) * w'_h[t_h] *
//                      prod_{l != h} w_l[t_l]
// and 0 where constant mode falls outside. It replaces the d_cc branch of
// elasticdeform_tpu/ops/windows.py:1247 _windows_op_bwd (:1277-1308), which
// JAX forms by forward mode through the weight polynomials. fold' is 0.5 at
// the clip ties of nearest and constant, as JAX's jnp.clip gives; order 0
// writes zeros.
//
// Bound on the H100: bytes. It reads the coefficients, g and the
// displacement and writes naxis values per voxel: 0.160 ms at the c5
// shapes (64 x 64^3 float32, one channel) at 3.35 TB/s; the fewest
// operations its function needs (the taps contracted axis by axis, about
// 559 per voxel at order 3) take less.
//
// Design, for a kernel that waits on its gathers:
// * The sum is contracted axis by axis, innermost first: per tap the
//   channels fold into gc = sum_c g_c * coeff_c (in channel order), the
//   innermost axis forms sum_t w[t] gc and sum_t w'[t] gc, and each outer
//   axis carries the partial without a derivative on with w and w' and
//   every other partial with w. No tap forms a product of weights, where
//   the first form re-formed naxis four-factor products per tap (~1270
//   operations per voxel at order 3, 3-D). The plain twin
//   (ops/resample_bwd.py:_coord_grad_at) takes the same order, so K5c is
//   bit for bit with it and K5 within 1e-5 * 2C max|g| max|coeffs|.
// * The rank is a template parameter, so every table index is a
//   compile-time constant and the weights, derivative weights and tap
//   offsets stay in registers (the first form kept them, int64 offsets
//   included, in a 176-320 byte stack frame). The two innermost axes are
//   unrolled up to order 3, one above; an outer axis loops over its taps
//   and picks its table entries by selects, which keeps the 80
//   instantiations (order 1-5, rank 1-4, float32/float64, int32/int64
//   offsets) building in about a minute; fully unrolled, they took minutes.
// * The launch bounds ask for as many blocks per SM as fit the tables
//   without a spill (CoordGradBlocks): occupancy, not the operation count,
//   set the speed in the A/B of the bounds on the card.
// * Offsets within a sample are int32 when every sample is under 2^31
//   elements (the wrapper's wide_indices); the sample's base is an int64
//   pointer. A run of taps inside its axis takes start + t; only edge runs
//   take the integer mirror fold. The voxel index unravels in int32.
// * The fold, its derivative and each axis's first tap come before the
//   weights, so the division slow paths find few values live.
// Neighbouring threads take neighbouring output voxels, so the g and
// displacement reads coalesce and a warp's taps fall in a few cache lines.
//
// Numerics (K3 and K5): built with --fmad=false, every constant cast to T.
//
// K3c resample_coords_bwd and K5c resample_coords_grad are K3 and K5 with
// the coordinate source of resample_common.cuh: caller-given coordinates
// (B, naxis, n_out) in place of the displacement, so K5c's result is the
// gradient with respect to those coordinates. They replace the backward
// of the JAX package's map_coordinates (elasticdeform_tpu/ops/deform.py:608
// map_coordinates_gradient_apply, and the autodiff of :533 / :573, which
// reach _scatter_fold and the d_cc branch of _windows_op_bwd at the
// caller's coordinates). Plain twins: ops/resample_bwd.py
// resample_coords_transpose_plain and resample_coords_grad_plain. Bounds as
// for K3 and K5.

#include "resample_common.cuh"

#define ED_CCH 4

namespace {

template <typename T, int ORDER, bool COORDS>
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
  if (!tap_tables<T, ORDER, COORDS>(p, displ, affine, b, v, w, off, ntap))
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

// K5/K5c: the partial sums of one voxel. v[0] carries no derivative
// weight; v[1 + k] the derivative along the k-th of the axes contracted so
// far, outermost first.
template <typename T, int K>
struct Partials {
  T v[K];
};

template <typename T, int NT, int NAXIS, int H, typename I>
__device__ __forceinline__ Partials<T, NAXIS - H + 1> contract(
    const T* __restrict__ src, I base, const T (&w)[NAXIS][NT],
    const T (&dw)[NAXIS][NT], const I (&off)[NAXIS][NT],
    const T* __restrict__ gv, T g0, I C);

// Tap t of axis H (weight wt, derivative weight dwt, element offset o of
// the taps so far): the partials of the axes after H at o, or at the
// innermost axis gc = sum_c g_c * coeff_c in channel order; then each
// partial's term added to acc (or put there at the axis's first tap).
template <typename T, int NT, int NAXIS, int H, typename I>
__device__ __forceinline__ void contract_tap(
    Partials<T, NAXIS - H + 1>& acc, const bool first, const T wt,
    const T dwt, const I o, const T* __restrict__ src,
    const T (&w)[NAXIS][NT], const T (&dw)[NAXIS][NT],
    const I (&off)[NAXIS][NT], const T* __restrict__ gv, const T g0,
    const I C) {
  constexpr int K = NAXIS - H + 1;
  Partials<T, K - 1> sub;
  if constexpr (H == NAXIS - 1) {
    const T* q = src + o;
    T gc = g0 * __ldg(q);
    for (I c = 1; c < C; ++c) gc = gc + __ldg(gv + c) * __ldg(q + c);
    sub.v[0] = gc;
  } else {
    sub = contract<T, NT, NAXIS, H + 1, I>(src, o, w, dw, off, gv, g0, C);
  }
  T term[K];
  term[0] = wt * sub.v[0];
  term[1] = dwt * sub.v[0];
#pragma unroll
  for (int k = 1; k < K - 1; ++k) term[k + 1] = wt * sub.v[k];
#pragma unroll
  for (int k = 0; k < K; ++k) acc.v[k] = first ? term[k] : acc.v[k] + term[k];
}

// Contracts the taps of axes H..NAXIS-1 of one voxel whose outer taps sit
// at element offset `base`: innermost axis first, each axis's taps in
// order, as ops/resample_bwd.py:_coord_grad_at.
template <typename T, int NT, int NAXIS, int H, typename I>
__device__ __forceinline__ Partials<T, NAXIS - H + 1> contract(
    const T* __restrict__ src, const I base, const T (&w)[NAXIS][NT],
    const T (&dw)[NAXIS][NT], const I (&off)[NAXIS][NT],
    const T* __restrict__ gv, const T g0, const I C) {
  Partials<T, NAXIS - H + 1> acc = {};
  if constexpr (H >= NAXIS - unrolled_axes(NT, NAXIS)) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
      contract_tap<T, NT, NAXIS, H, I>(acc, t == 0, w[H][t], dw[H][t],
                                       base + off[H][t], src, w, dw, off, gv,
                                       g0, C);
  } else {
#pragma unroll 1
    for (int t = 0; t < NT; ++t)
      contract_tap<T, NT, NAXIS, H, I>(acc, t == 0, pick(w[H], t),
                                       pick(dw[H], t), base + pick(off[H], t),
                                       src, w, dw, off, gv, g0, C);
  }
  return acc;
}

// One output voxel v of sample b: its coordinates (read from `displ` when
// `coords`; else affine(j) + offset + displ, resample_common.cuh's
// operations), the rank-NAXIS tables of weights, derivative weights and
// tap offsets in elements (channels included), then the contraction.
// Offsets within a sample are of type I (int32 where the wrapper found
// every sample under 2^31 elements); the sample's base is int64. A run of
// taps that lies inside its axis takes start + t, unfolded.
template <typename T, int ORDER, int NAXIS, typename I>
__device__ __forceinline__ void coord_grad_voxel(
    const T* __restrict__ coeffs, const T* __restrict__ g,
    const T* __restrict__ displ, const T* __restrict__ affine,
    T* __restrict__ d_displ, const Params& p, const bool coords,
    const int64_t b, const I v) {
  constexpr int NT = ORDER + 1;
  const I n_out = (I)p.n_out;
  const I C = (I)p.channels;
  T* dst = d_displ + b * NAXIS * p.n_out + v;
  T cc[NAXIS];
  voxel_coords<T, NAXIS, I>(p, displ, affine, coords, b, v, cc);

  // the fold, its derivative and the first tap of each axis first, then
  // the weights, the derivative weights and the offsets: the divisions'
  // slow-path calls then find few values live and nothing spills
  T m[NAXIS], fd[NAXIS];
  I start[NAXIS];
  bool inside = true;
#pragma unroll
  for (int h = 0; h < NAXIS; ++h) {
    m[h] = map_coord(cc[h], p.in_shape[h], p.mode, &inside);
    fd[h] = map_coord_grad(cc[h], p.in_shape[h], p.mode);
    start[h] = first_tap<T, ORDER, I>(m[h]);
  }
  if (!inside) {
    // constant mode outside: the output does not depend on the coordinate
#pragma unroll
    for (int h = 0; h < NAXIS; ++h) dst[h * n_out] = T(0);
    return;
  }
  T w[NAXIS][NT], dw[NAXIS][NT];
#pragma unroll
  for (int h = 0; h < NAXIS; ++h) spline_weights<T, ORDER>(m[h], w[h]);
#pragma unroll
  for (int h = 0; h < NAXIS; ++h) spline_weights_grad<T, ORDER>(m[h], dw[h]);
  I off[NAXIS][NT];
  tap_offsets<NT, NAXIS, I>(p, start, off);

  const T* src = coeffs + b * p.n_in * p.channels;
  const T* gv = g + b * p.n_out * p.channels + v * C;
  const Partials<T, NAXIS + 1> r =
      contract<T, NT, NAXIS, 0, I>(src, I(0), w, dw, off, gv, gv[0], C);
#pragma unroll
  for (int h = 0; h < NAXIS; ++h) dst[h * n_out] = fd[h] * r.v[1 + h];
}

// The blocks per SM that K5's launch bounds ask for, which set ptxas's
// register budget to 65536 / (256 * blocks): for float32 with 32-bit
// offsets, the most blocks whose budget holds the tables and the unrolled
// taps without a spill (48 registers up to 8 taps, 64 up to 16, 80 up to
// 64, 128 above). The kernel waits on its gathers, so occupancy is its
// speed: given only the thread count, ptxas cut registers to fit more
// blocks and spilled; given one block, it spent up to twice the registers
// and the kernels ran far slower. float64 and 64-bit offsets take one
// block: their tables are twice as wide, and they are not the hot path.
template <typename T, int NT, int NAXIS, typename I>
struct CoordGradBlocks {
  static constexpr int taps = voxel_taps(NT, NAXIS);
  static constexpr int value = sizeof(T) > 4 || sizeof(I) > 4 ? 1
                               : taps <= 8                     ? 5
                               : taps <= 16                    ? 4
                               : taps <= 64                    ? 3
                                                               : 2;
};

// One thread per output voxel of a sample; the grid's y walks the batch.
template <typename T, int ORDER, int NAXIS, typename I>
__global__ void __launch_bounds__(
    256, (CoordGradBlocks<T, ORDER + 1, NAXIS, I>::value))
coord_grad_kernel(const T* __restrict__ coeffs, const T* __restrict__ g,
                  const T* __restrict__ displ, const T* __restrict__ affine,
                  T* __restrict__ d_displ, const Params p,
                  const bool coords) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= p.n_out) return;
  for (int64_t b = blockIdx.y; b < p.batch; b += gridDim.y)
    coord_grad_voxel<T, ORDER, NAXIS, I>(coeffs, g, displ, affine, d_displ,
                                         p, coords, b, (I)v);
}

template <typename T, int ORDER, bool COORDS>
cudaError_t launch_bwd(const void* g, const void* displ, const void* affine,
                       void* d_coeffs, const Params& p, cudaStream_t stream) {
  const int64_t total = p.batch * p.n_out;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  resample_bwd_kernel<T, ORDER, COORDS>
      <<<(unsigned)blocks, threads, 0, stream>>>(
          static_cast<const T*>(g), static_cast<const T*>(displ),
          static_cast<const T*>(affine), static_cast<T*>(d_coeffs), p);
  return cudaGetLastError();
}

template <typename T, bool COORDS>
cudaError_t dispatch_bwd(int order, const void* g, const void* displ,
                         const void* affine, void* d_coeffs, const Params& p,
                         cudaStream_t s) {
  switch (order) {
    case 0: return launch_bwd<T, 0, COORDS>(g, displ, affine, d_coeffs, p, s);
    case 1: return launch_bwd<T, 1, COORDS>(g, displ, affine, d_coeffs, p, s);
    case 2: return launch_bwd<T, 2, COORDS>(g, displ, affine, d_coeffs, p, s);
    case 3: return launch_bwd<T, 3, COORDS>(g, displ, affine, d_coeffs, p, s);
    case 4: return launch_bwd<T, 4, COORDS>(g, displ, affine, d_coeffs, p, s);
    case 5: return launch_bwd<T, 5, COORDS>(g, displ, affine, d_coeffs, p, s);
  }
  return cudaErrorInvalidValue;
}

struct GradArgs {
  const void* coeffs;
  const void* g;
  const void* displ;
  const void* affine;
  void* d_displ;
};

template <typename T, int ORDER, int NAXIS, typename I>
cudaError_t launch_coord_grad(const GradArgs& a, const Params& p,
                              bool coords, cudaStream_t stream) {
  const int threads = 256;
  const dim3 grid((unsigned)((p.n_out + threads - 1) / threads),
                  (unsigned)(p.batch < 65535 ? p.batch : 65535));
  coord_grad_kernel<T, ORDER, NAXIS, I><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(a.coeffs), static_cast<const T*>(a.g),
      static_cast<const T*>(a.displ), static_cast<const T*>(a.affine),
      static_cast<T*>(a.d_displ), p, coords);
  return cudaGetLastError();
}

template <typename T, int ORDER, typename I>
cudaError_t coord_grad_rank(const GradArgs& a, const Params& p, bool coords,
                            cudaStream_t s) {
  switch (p.naxis) {
    case 1: return launch_coord_grad<T, ORDER, 1, I>(a, p, coords, s);
    case 2: return launch_coord_grad<T, ORDER, 2, I>(a, p, coords, s);
    case 3: return launch_coord_grad<T, ORDER, 3, I>(a, p, coords, s);
    case 4: return launch_coord_grad<T, ORDER, 4, I>(a, p, coords, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int ORDER>
cudaError_t coord_grad_width(bool wide, const GradArgs& a, const Params& p,
                             bool coords, cudaStream_t s) {
  return wide ? coord_grad_rank<T, ORDER, int64_t>(a, p, coords, s)
              : coord_grad_rank<T, ORDER, int32_t>(a, p, coords, s);
}

// K5/K5c: order 0 (one tap of weight 1) does not depend on the
// coordinates, so its gradient is all zeros.
template <typename T>
cudaError_t dispatch_coord_grad(int order, bool wide, bool coords,
                                const GradArgs& a, const Params& p,
                                cudaStream_t s) {
  if (p.batch * p.n_out == 0) return cudaSuccess;
  switch (order) {
    case 0:
      return cudaMemsetAsync(a.d_displ, 0,
                             p.batch * p.naxis * p.n_out * sizeof(T), s);
    case 1: return coord_grad_width<T, 1>(wide, a, p, coords, s);
    case 2: return coord_grad_width<T, 2>(wide, a, p, coords, s);
    case 3: return coord_grad_width<T, 3>(wide, a, p, coords, s);
    case 4: return coord_grad_width<T, 4>(wide, a, p, coords, s);
    case 5: return coord_grad_width<T, 5>(wide, a, p, coords, s);
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
      dtype == 0   ? dispatch_bwd<float, false>(order, g, displ, affine,
                                                d_coeffs, p, s)
      : dtype == 1 ? dispatch_bwd<double, false>(order, g, displ, affine,
                                                 d_coeffs, p, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

// As ed_resample_bwd; coeffs (B, *in_shape, C), g (B, *out_shape, C),
// d_displ (B, naxis, *out_shape), every element written. wide: 64-bit
// offsets within a sample (required once a sample reaches 2^31 elements).
int ed_resample_coord_grad(int dtype, const void* coeffs, const void* g,
                           const void* displ, const void* affine,
                           void* d_displ, int naxis, int order, int mode,
                           long long batch, long long channels,
                           const long long* in_shape,
                           const long long* out_shape,
                           const long long* offsets, long long affine_stride,
                           void* stream, int wide) {
  Params p;
  if (!make_params(&p, naxis, mode, batch, channels, in_shape, out_shape,
                   offsets, affine_stride, 0.0) || channels < 1 ||
      (!wide && !fits_32(p)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GradArgs a{coeffs, g, displ, affine, d_displ};
  cudaError_t err =
      dtype == 0   ? dispatch_coord_grad<float>(order, wide, false, a, p, s)
      : dtype == 1 ? dispatch_coord_grad<double>(order, wide, false, a, p, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

// K3c: the transpose of K1c; g (B, n_out, C), coords (B, naxis, n_out),
// d_coeffs (B, *in_shape, C) zero-filled. Returns cudaGetLastError().
int ed_resample_coords_bwd(int dtype, const void* g, const void* coords,
                           void* d_coeffs, int naxis, int order, int mode,
                           long long batch, long long channels,
                           const long long* in_shape, long long n_out,
                           void* stream) {
  Params p;
  if (!make_params_coords(&p, naxis, mode, batch, channels, in_shape, n_out,
                          0.0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0   ? dispatch_bwd<float, true>(order, g, coords, nullptr,
                                               d_coeffs, p, s)
      : dtype == 1 ? dispatch_bwd<double, true>(order, g, coords, nullptr,
                                                d_coeffs, p, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

// K5c: the gradient of <K1c(coeffs), g> with respect to coords; d_coords
// (B, naxis, n_out), every element written; wide as for K5. Returns
// cudaGetLastError().
int ed_resample_coords_grad(int dtype, const void* coeffs, const void* g,
                            const void* coords, void* d_coords, int naxis,
                            int order, int mode, long long batch,
                            long long channels, const long long* in_shape,
                            long long n_out, void* stream, int wide) {
  Params p;
  if (!make_params_coords(&p, naxis, mode, batch, channels, in_shape, n_out,
                          0.0) || channels < 1 || (!wide && !fits_32(p)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GradArgs a{coeffs, g, coords, nullptr, d_coords};
  cudaError_t err =
      dtype == 0   ? dispatch_coord_grad<float>(order, wide, true, a, p, s)
      : dtype == 1 ? dispatch_coord_grad<double>(order, wide, true, a, p, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

const char* ed_resample_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
