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

#include <cuda_runtime.h>
#include <stdint.h>

#define ED_MAXD 4
#define ED_CCH 4

namespace {

enum { MODE_NEAREST = 0, MODE_WRAP = 1, MODE_REFLECT = 2, MODE_MIRROR = 3,
       MODE_CONSTANT = 4 };

struct Params {
  int naxis;
  int mode;
  int64_t batch;
  int64_t channels;
  int64_t n_in;    // prod(in_shape)
  int64_t n_out;   // prod(out_shape)
  int64_t affine_stride;  // elements between samples' affines; 0 = shared
  int64_t in_shape[ED_MAXD];
  int64_t in_stride[ED_MAXD];  // in voxels, row-major over in_shape
  int64_t out_shape[ED_MAXD];
  int64_t offset[ED_MAXD];
  double cval;
};

template <typename T>
__device__ __forceinline__ T clampT(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ops/modes.py map_coordinate; `inside` is cleared for constant mode.
template <typename T>
__device__ __forceinline__ T map_coord(T cc, int64_t length, int mode,
                                       bool* inside) {
  const T lm1 = T(length - 1);
  const bool below = cc < T(0);
  const bool above = cc > lm1;
  if (mode == MODE_CONSTANT) {
    if (below || above) *inside = false;
    return clampT(cc, T(0), lm1);
  }
  if (mode == MODE_NEAREST) return clampT(cc, T(0), lm1);
  if (length <= 1) return T(0);
  if (mode == MODE_MIRROR) {
    const T sz2 = T(2 * length - 2);
    if (below) {
      T neg = sz2 * trunc(-cc / sz2) + cc;
      return neg <= T(1 - length) ? neg + sz2 : -neg;
    }
    if (above) {
      T pos = cc - sz2 * trunc(cc / sz2);
      return pos >= T(length) ? sz2 - pos : pos;
    }
    return cc;
  }
  if (mode == MODE_REFLECT) {
    const T sz2 = T(2 * length);
    if (below) {
      T neg0 = cc < -sz2 ? sz2 * trunc(-cc / sz2) + cc : cc;
      return neg0 < T(-length) ? neg0 + sz2 : -neg0 - T(1);
    }
    if (above) {
      T pos = cc - sz2 * trunc(cc / sz2);
      return pos >= T(length) ? sz2 - pos - T(1) : pos;
    }
    return cc;
  }
  // MODE_WRAP, period len - 1
  const T sz = T(length - 1);
  if (below) return cc + sz * (trunc(-cc / sz) + T(1));
  if (above) return cc - sz * trunc(cc / sz);
  return cc;
}

__device__ __forceinline__ int64_t mirror_fold(int64_t i, int64_t n) {
  if (n <= 1) return 0;
  const int64_t s2 = 2 * n - 2;
  int64_t m = i % s2;
  if (m < 0) m += s2;
  return m >= n ? s2 - m : m;
}

// ops/bspline.py spline_weights, same operations in the same order.
template <typename T, int ORDER>
__device__ __forceinline__ void spline_weights(T cc, T* w) {
  if (ORDER == 0) {
    w[0] = T(1);
    return;
  }
  const T x = (ORDER & 1) ? cc - floor(cc) : cc - floor(cc + T(0.5));
  if (ORDER == 1) {
    w[0] = T(1) - x;
    w[1] = T(1) - w[0];
  } else if (ORDER == 2) {
    w[1] = T(0.75) - x * x;
    const T y = T(0.5) - x;
    w[0] = T(0.5) * y * y;
    w[2] = T(1) - w[0] - w[1];
  } else if (ORDER == 3) {
    const T y = x, z = T(1) - x;
    w[1] = (y * y * (y - T(2)) * T(3) + T(4)) / T(6);
    w[2] = (z * z * (z - T(2)) * T(3) + T(4)) / T(6);
    w[0] = z * z * z / T(6);
    w[3] = T(1) - w[0] - w[1] - w[2];
  } else if (ORDER == 4) {
    T t = x * x;
    w[2] = t * (t * T(0.25) - T(0.625)) + T(115.0 / 192.0);
    const T y = T(1) + x;
    w[1] = y * (y * (y * (T(5) - y) / T(6) - T(1.25)) + T(5.0 / 24.0)) +
           T(55.0 / 96.0);
    const T z = T(1) - x;
    w[3] = z * (z * (z * (T(5) - z) / T(6) - T(1.25)) + T(5.0 / 24.0)) +
           T(55.0 / 96.0);
    const T y2 = T(0.5) - x;
    t = y2 * y2;
    w[0] = t * t / T(24);
    w[4] = T(1) - w[0] - w[1] - w[2] - w[3];
  } else if (ORDER == 5) {
    const T y = x, z = T(1) - x;
    T t = y * y;
    w[2] = t * (t * (T(0.25) - y / T(12)) - T(0.5)) + T(0.55);
    t = z * z;
    w[3] = t * (t * (T(0.25) - z / T(12)) - T(0.5)) + T(0.55);
    const T y1 = T(1) + x;
    w[1] = y1 * (y1 * (y1 * (y1 * (y1 / T(24) - T(0.375)) + T(1.25)) -
                       T(1.75)) +
                 T(0.625)) +
           T(0.425);
    const T z1 = T(2) - x;
    w[4] = z1 * (z1 * (z1 * (z1 * (z1 / T(24) - T(0.375)) + T(1.25)) -
                       T(1.75)) +
                 T(0.625)) +
           T(0.425);
    const T y2 = T(1) - x;
    t = y2 * y2;
    w[0] = y2 * t * t / T(120);
    w[5] = T(1) - w[0] - w[1] - w[2] - w[3] - w[4];
  }
}

// The naxis real axes sit at the END of the ED_MAXD slots (slot
// ED_MAXD - naxis + h holds axis h); leading unused slots take one tap of
// weight 1 and offset 0. Multiplying by 1 is exact, so the weight product
// equals the plain version's left-to-right product over the real axes.
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
  const int naxis = p.naxis;
  const int lead = ED_MAXD - naxis;

  int64_t j[ED_MAXD];
  {
    int64_t rem = v;
#pragma unroll
    for (int h = ED_MAXD - 1; h >= 0; --h) {
      if (h < naxis) {
        j[h] = rem % p.out_shape[h];
        rem /= p.out_shape[h];
      } else {
        j[h] = 0;
      }
    }
  }

  T w[ED_MAXD][NT];
  int64_t off[ED_MAXD][NT];
  int ntap[ED_MAXD];
  bool inside = true;
  const T* A = affine ? affine + b * p.affine_stride : nullptr;
#pragma unroll
  for (int s = 0; s < ED_MAXD; ++s) {
    const int h = s - lead;
    if (h < 0) {
      ntap[s] = 1;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        w[s][t] = T(1);
        off[s][t] = 0;
      }
      continue;
    }
    ntap[s] = NT;
    T cc;
    if (A) {
      const T* row = A + h * (naxis + 1);
      T acc = row[naxis];
      for (int l = 0; l < naxis; ++l) acc = acc + row[l] * T(j[l]);
      cc = acc;
    } else {
      cc = T(j[h]);
    }
    cc = cc + T(p.offset[h]);
    cc = cc + displ[(b * naxis + h) * p.n_out + v];
    const T m = map_coord(cc, p.in_shape[h], p.mode, &inside);
    const T fs = (ORDER & 1) ? floor(m) - T(ORDER / 2)
                             : floor(m + T(0.5)) - T(ORDER / 2);
    const int64_t start = (int64_t)fs;
    spline_weights<T, ORDER>(m, w[s]);
#pragma unroll
    for (int t = 0; t < NT; ++t)
      off[s][t] = mirror_fold(start + t, p.in_shape[h]) * p.in_stride[h];
  }

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
  if (naxis < 1 || naxis > ED_MAXD || mode < 0 || mode > 4)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.naxis = naxis;
  p.mode = mode;
  p.batch = batch;
  p.channels = channels;
  p.affine_stride = affine_stride;
  p.cval = cval;
  p.n_in = 1;
  p.n_out = 1;
  for (int h = ED_MAXD - 1; h >= 0; --h) {
    if (h < naxis) {
      p.in_shape[h] = in_shape[h];
      p.out_shape[h] = out_shape[h];
      p.offset[h] = offsets[h];
      p.in_stride[h] = p.n_in;
      p.n_in *= in_shape[h];
      p.n_out *= out_shape[h];
    } else {
      p.in_shape[h] = p.out_shape[h] = 1;
      p.in_stride[h] = p.offset[h] = 0;
    }
  }
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
