// Device code shared by the resample kernels: K1 (resample.cu), K3 and K5
// (resample_bwd.cu). The sample coordinate, the boundary-mode fold and its
// derivative, the integer mirror fold of the taps, and the B-spline weights
// and their derivatives, each with the operations, in the order, of its
// plain PyTorch twin (ops/resample.py, ops/modes.py, ops/bspline.py), so
// that a kernel built with --fmad=false rounds as its twin does. Every
// kernel is rank-specialised and takes its coordinates, first taps and tap
// offsets from voxel_coords (or displaced_coords), first_tap and
// tap_offsets, in the index type that fits_32 allows.
//
// Layouts: coefficients (B, *in_shape, C) with the channels last, the dense
// displacement (B, naxis, *out_shape), the affine (naxis, naxis+1) per
// sample at affine_stride elements apart (0 = one shared affine). The
// coordinate-input kernels (K1c, K3c, K5c) read caller-given coordinates
// (B, naxis, n_out) in place of the displacement: the output is flat over
// n_out, so its rank is free.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define ED_MAXD 4

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

// Host side: the Params of the C entry points' arguments; false if they
// are out of range.
inline bool make_params(Params* p, int naxis, int mode, long long batch,
                        long long channels, const long long* in_shape,
                        const long long* out_shape, const long long* offsets,
                        long long affine_stride, double cval) {
  if (naxis < 1 || naxis > ED_MAXD || mode < 0 || mode > 4) return false;
  p->naxis = naxis;
  p->mode = mode;
  p->batch = batch;
  p->channels = channels;
  p->affine_stride = affine_stride;
  p->cval = cval;
  p->n_in = 1;
  p->n_out = 1;
  for (int h = ED_MAXD - 1; h >= 0; --h) {
    if (h < naxis) {
      p->in_shape[h] = in_shape[h];
      p->out_shape[h] = out_shape[h];
      p->offset[h] = offsets[h];
      p->in_stride[h] = p->n_in;
      p->n_in *= in_shape[h];
      p->n_out *= out_shape[h];
    } else {
      p->in_shape[h] = p->out_shape[h] = 1;
      p->in_stride[h] = p->offset[h] = 0;
    }
  }
  return true;
}

// Host side: the Params of the coordinate-input entry points, which give
// n_out in place of an output shape, and no offsets or affine.
inline bool make_params_coords(Params* p, int naxis, int mode,
                               long long batch, long long channels,
                               const long long* in_shape, long long n_out,
                               double cval) {
  const long long ones[ED_MAXD] = {1, 1, 1, 1};
  const long long zeros[ED_MAXD] = {0, 0, 0, 0};
  if (!make_params(p, naxis, mode, batch, channels, in_shape, ones, zeros, 0,
                   cval))
    return false;
  p->n_out = n_out;
  return true;
}

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

// ops/modes.py map_coordinate_grad: d map_coord / d cc as JAX's autodiff
// gives it. The branches are decided on the same values as map_coord's.
// jnp.clip passes half at each exact tie, so 0.5 at cc == 0 or len-1.
template <typename T>
__device__ __forceinline__ T map_coord_grad(T cc, int64_t length, int mode) {
  const T lm1 = T(length - 1);
  if (mode == MODE_CONSTANT || mode == MODE_NEAREST) {
    const T lo = cc > T(0) ? T(1) : (cc == T(0) ? T(0.5) : T(0));
    const T hi = cc < lm1 ? T(1) : (cc == lm1 ? T(0.5) : T(0));
    return lo * hi;
  }
  if (length <= 1) return T(0);
  const bool below = cc < T(0);
  const bool above = cc > lm1;
  if (mode == MODE_MIRROR) {
    const T sz2 = T(2 * length - 2);
    if (below) {
      T neg = sz2 * trunc(-cc / sz2) + cc;
      return neg <= T(1 - length) ? T(1) : T(-1);
    }
    if (above) {
      T pos = cc - sz2 * trunc(cc / sz2);
      return pos >= T(length) ? T(-1) : T(1);
    }
    return T(1);
  }
  if (mode == MODE_REFLECT) {
    const T sz2 = T(2 * length);
    if (below) {
      T neg0 = cc < -sz2 ? sz2 * trunc(-cc / sz2) + cc : cc;
      return neg0 < T(-length) ? T(1) : T(-1);
    }
    if (above) {
      T pos = cc - sz2 * trunc(cc / sz2);
      return pos >= T(length) ? T(-1) : T(1);
    }
    return T(1);
  }
  return T(1);  // MODE_WRAP
}

// The integer mirror fold of tap index i into [0, n), in the index type I.
template <typename I>
__device__ __forceinline__ I mirror_fold(I i, I n) {
  if (n <= 1) return 0;
  const I s2 = 2 * n - 2;
  I m = i % s2;
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

// ops/bspline.py spline_weights_grad: d w_t / d cc, floor's derivative 0,
// the last tap minus the sum of the others'. Same operations in the same
// order.
template <typename T, int ORDER>
__device__ __forceinline__ void spline_weights_grad(T cc, T* d) {
  if (ORDER == 0) {
    d[0] = T(0);
    return;
  }
  const T x = (ORDER & 1) ? cc - floor(cc) : cc - floor(cc + T(0.5));
  if (ORDER == 1) {
    d[0] = T(-1);
    d[1] = -d[0];
  } else if (ORDER == 2) {
    d[1] = x * T(-2);
    d[0] = -(T(0.5) - x);
    d[2] = -d[0] - d[1];
  } else if (ORDER == 3) {
    const T y = x, z = T(1) - x;
    d[1] = y * (T(1.5) * y - T(2));
    d[2] = -(z * (T(1.5) * z - T(2)));
    d[0] = (z * z) * T(-0.5);
    d[3] = -d[0] - d[1] - d[2];
  } else if (ORDER == 4) {
    const T t = x * x;
    d[2] = x * (t - T(1.25));
    const T y = T(1) + x;
    d[1] = y * (y * (T(15) - T(4) * y) / T(6) - T(2.5)) + T(5.0 / 24.0);
    const T z = T(1) - x;
    d[3] = -(z * (z * (T(15) - T(4) * z) / T(6) - T(2.5)) + T(5.0 / 24.0));
    const T y2 = T(0.5) - x;
    d[0] = -(y2 * y2 * y2 / T(6));
    d[4] = -d[0] - d[1] - d[2] - d[3];
  } else if (ORDER == 5) {
    const T y = x, z = T(1) - x;
    T t = y * y;
    d[2] = y * (t * (T(1) - T(5) * y / T(12)) - T(1));
    t = z * z;
    d[3] = -(z * (t * (T(1) - T(5) * z / T(12)) - T(1)));
    const T y1 = T(1) + x;
    d[1] = y1 * (y1 * (y1 * (T(5) * y1 / T(24) - T(1.5)) + T(3.75)) -
                 T(3.5)) +
           T(0.625);
    const T z1 = T(2) - x;
    d[4] = -(z1 * (z1 * (z1 * (T(5) * z1 / T(24) - T(1.5)) + T(3.75)) -
                   T(3.5)) +
             T(0.625));
    const T y2 = T(1) - x;
    t = y2 * y2;
    d[0] = -(t * t / T(24));
    d[5] = -d[0] - d[1] - d[2] - d[3] - d[4];
  }
}

// Whether 32-bit offsets reach every element of one sample: the
// coefficients (n_in * C), the output or g (n_out * C) and the displacement
// or coordinates (naxis * n_out). The wrappers' wide_indices
// (ops/resample.py) is the same rule; the C entry points check it again.
inline bool fits_32(const Params& p) {
  const int64_t lim = (int64_t)1 << 31;
  const int64_t per = p.channels > p.naxis ? p.channels : p.naxis;
  return p.n_in * p.channels < lim && p.n_out * per < lim;
}

// How many of the innermost axes a rank-specialised kernel unrolls: two up
// to order 3, one above (at most 16 taps). Each outer axis runs a loop over
// its taps that picks its table entries by selects, so every table stays in
// registers and the instantiations build in about a minute.
__host__ __device__ constexpr int unrolled_axes(int nt, int naxis) {
  const int k = nt <= 4 ? 2 : 1;
  return naxis < k ? naxis : k;
}

// The taps of one voxel, nt^naxis (the launch bounds' classes).
__host__ __device__ constexpr int voxel_taps(int nt, int naxis) {
  return naxis == 0 ? 1 : nt * voxel_taps(nt, naxis - 1);
}

// a[t] for a runtime t, by selects over the compile-time entries
template <typename V, int N>
__device__ __forceinline__ V pick(const V (&a)[N], const int t) {
  V r = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) r = t == k ? a[k] : r;
  return r;
}

// The NAXIS sample coordinates of output voxel v of sample b, whose output
// index is j, in the twin's operations (ops/resample.py
// sample_coordinates): affine(j) + offset + displ.
template <typename T, int NAXIS, typename I>
__device__ __forceinline__ void displaced_coords(const Params& p,
                                                 const T* __restrict__ displ,
                                                 const T* __restrict__ affine,
                                                 const int64_t b, const I v,
                                                 const I (&j)[NAXIS],
                                                 T (&cc)[NAXIS]) {
  const I n_out = (I)p.n_out;
  const T* cs = displ + b * NAXIS * p.n_out;
  const T* A = affine ? affine + b * p.affine_stride : nullptr;
#pragma unroll
  for (int h = 0; h < NAXIS; ++h) {
    T c;
    if (A) {
      const T* row = A + h * (NAXIS + 1);
      T acc = row[NAXIS];
#pragma unroll
      for (int l = 0; l < NAXIS; ++l) acc = acc + row[l] * T(j[l]);
      c = acc;
    } else {
      c = T(j[h]);
    }
    c = c + T(p.offset[h]);
    cc[h] = c + cs[h * n_out + v];
  }
}

// The NAXIS sample coordinates of output voxel v of sample b: read from
// `displ` as they are when `coords` (K1c, K3c, K5c: (B, naxis, n_out));
// else displaced_coords, with j unravelled from v in the index type I.
template <typename T, int NAXIS, typename I>
__device__ __forceinline__ void voxel_coords(const Params& p,
                                             const T* __restrict__ displ,
                                             const T* __restrict__ affine,
                                             const bool coords,
                                             const int64_t b, const I v,
                                             T (&cc)[NAXIS]) {
  if (coords) {
    const I n_out = (I)p.n_out;
    const T* cs = displ + b * NAXIS * p.n_out;
#pragma unroll
    for (int h = 0; h < NAXIS; ++h) cc[h] = cs[h * n_out + v];
    return;
  }
  I j[NAXIS];
  I rem = v;
#pragma unroll
  for (int h = NAXIS - 1; h > 0; --h) {
    const I n = (I)p.out_shape[h];
    const I q = rem / n;
    j[h] = rem - q * n;
    rem = q;
  }
  j[0] = rem;
  displaced_coords<T, NAXIS, I>(p, displ, affine, b, v, j, cc);
}

// The first tap of the (ORDER+1)-wide window at the folded coordinate m
// (ops/bspline.py filter_start), in the index type I; 0 for a NaN, as
// XLA's conversion and the twins give it (the card's own conversion of a
// float64 NaN does not).
template <typename T, int ORDER, typename I>
__device__ __forceinline__ I first_tap(const T m) {
  const T f = (ORDER & 1) ? floor(m) - T(ORDER / 2)
                          : floor(m + T(0.5)) - T(ORDER / 2);
  return (I)(f == f ? f : T(0));
}

// The element offsets (channels included) of each axis's NT taps from
// their first taps `start`: a run inside its axis takes (start + t) *
// stride unfolded; only a run over an edge takes the integer mirror fold.
template <int NT, int NAXIS, typename I>
__device__ __forceinline__ void tap_offsets(const Params& p,
                                            const I (&start)[NAXIS],
                                            I (&off)[NAXIS][NT]) {
#pragma unroll
  for (int h = 0; h < NAXIS; ++h) {
    const I n = (I)p.in_shape[h];
    const I stride = (I)(p.in_stride[h] * p.channels);
    if (start[h] >= 0 && start[h] + NT <= n) {
#pragma unroll
      for (int t = 0; t < NT; ++t) off[h][t] = (start[h] + t) * stride;
    } else {
#pragma unroll
      for (int t = 0; t < NT; ++t)
        off[h][t] = mirror_fold<I>(start[h] + t, n) * stride;
    }
  }
}

}  // namespace
