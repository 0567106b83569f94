// K2 spline_prefilter: the B-spline prefilter (sample values -> spline
// coefficients) along one axis, as the causal / anti-causal recursion,
// one thread per line; and K4 spline_prefilter_transpose, its exact
// transpose for the gradient, with the same line mapping.
//
// Replaces the JAX package's prefilter stage:
// elasticdeform_tpu/ops/prefilter.py:333 spline_filter1d, which applies a
// dense n x n float64-built filter matrix (:109 filter_matrix) on the TPU's
// matrix unit, or an associative scan (:257) on long axes. Here the
// recursion of ops/prefilter.py:56 _filter_lines runs as written: the gain,
// then per pole the causal initialisation (the truncated sum when the
// horizon is shorter than the line, else the full mirror sum over
// 1 - p^(2n-2)), the causal pass, the anti-causal initialisation and the
// anti-causal pass. A line of length n <= 1 passes through unchanged. Its
// plain PyTorch twin is ops/prefilter.py:spline_filter1d_plain (tensordot
// with the float64 filter matrix).
//
// The tensor is viewed as (outer, n, inner) with the filtered axis in the
// middle; thread (o, i) filters line o*n*inner + k*inner + i, k = 0..n-1.
// Neighbouring threads take neighbouring i, so their accesses coalesce
// when inner >= 32. Known limit: when the filtered axis is innermost
// (inner == 1) every access of a warp touches a different line, and the
// kernel is uncoalesced; a transposed tile in shared memory would fix it.
//
// Bound on the H100: bytes, 2 * numel * sizeof(T) (each element read once
// and written once) over 3.35 TB/s. The recursion touches each element
// about 2 + 4 * npoles times; the passes of one line stay in L1/L2.
//
// K4 replaces the JAX package's transpose prefilter:
// elasticdeform_tpu/ops/prefilter.py:376 spline_filter1d_transpose (the
// transposed filter matrix F^T on the TPU's matrix unit) and :287
// _filter_axis0_scan_transpose (the stage-by-stage adjoint of the scan on
// long axes, which covers the truncated initialisation only). K4 runs
// _filter_lines's stages transposed, in reverse, with both branches of the
// causal initialisation: the transposed full mirror sum spreads row 0's
// cotangent over every k with (p^k + p^(2n-2-k)) / (1 - p^(2n-2)). Its
// plain twin is ops/prefilter.py:spline_filter1d_transpose_plain, a
// tensordot with F^T. Bound and the innermost-axis limit as for K2.
//
// K6 spline_prefilter_bc and K7 spline_prefilter_bc_transpose: the same
// line-parallel recursion and its exact transpose under the 'reflect'
// (half-sample symmetric, period 2n) and 'wrap' (periodic, period n)
// boundary conditions of SciPy >= 1.6 (the public statement of the
// initialisations is ni_splines.c, _init_causal_reflect /
// _init_anticausal_reflect / _init_causal_wrap / _init_anticausal_wrap).
// They replace the JAX package's filter_matrix_bc + _apply_matrix
// (elasticdeform_tpu/ops/prefilter.py:150, :177; core.py:568-569 and
// :1176-1177), a dense n x n inverse of the B-spline sampling matrix on the
// TPU's matrix unit. Per pole, the causal initialisation is the full sum
// over the period, with no truncated branch:
//   reflect: c0 + z/(1 - z^2n) * sum_i z^i (c_i + z^n c_{n-1-i})
//   wrap:    (c0 + sum_{i>=1} z^i c_{n-i}) / (1 - z^n)
// and the anti-causal one c_{n-1} * z/(z - 1) (reflect) or
// (c_{n-1} + sum_{i<n-1} z^(i+1) c_i) * z/(z^n - 1) (wrap). K7 runs each
// stage's transpose in reverse, as K4 does: row 0's (row n-1's) cotangent
// spreads over the line with the same coefficients. Plain twins:
// ops/prefilter.py spline_filter1d_bc_plain / _transpose_plain (tensordot
// with filter_matrix_bc(n, order, bc) or its transpose). Bound and the
// innermost-axis limit as for K2.
//
// Optional fused writeback (int_bits > 0): after the axis, truncate toward
// zero and wrap modulo 2^int_bits (ops/resample.py cast_int_c), the
// reference's per-axis integer writeback, which is nonlinear and must run
// after each axis. It is computed in T with the plain version's operations.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ED_MAXPOLES 2

namespace {

enum { BC_REFLECT = 1, BC_WRAP = 2 };

struct Params {
  int64_t outer, n, inner;
  int npoles;
  double pole[ED_MAXPOLES];
  int horizon[ED_MAXPOLES];
  double pn1[ED_MAXPOLES];    // p^(n-1)
  double denom[ED_MAXPOLES];  // 1 - p^(2n-2)
  double zn[ED_MAXPOLES];     // p^n (K6, K7)
  double gain;
  int int_bits;       // 0: no writeback
  double int_lo;      // iinfo(dtype).min
};

template <typename T>
__device__ __forceinline__ T cast_int_c(T v, T lo, T span) {
  const T tr = trunc(v);
  return tr - floor((tr - lo) / span) * span;
}

template <typename T>
__global__ void __launch_bounds__(256)
prefilter_kernel(const T* __restrict__ in, T* __restrict__ out,
                 const Params p) {
  const int64_t line = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= p.outer * p.inner) return;
  const int64_t o = line / p.inner;
  const int64_t i = line - o * p.inner;
  const int64_t n = p.n;
  const int64_t s = p.inner;
  const T* src = in + o * n * s + i;
  T* x = out + o * n * s + i;

  if (n <= 1 || p.npoles == 0) {
    for (int64_t k = 0; k < n; ++k) x[k * s] = src[k * s];
  } else {
    const T gain = T(p.gain);
    for (int64_t k = 0; k < n; ++k) x[k * s] = src[k * s] * gain;
    for (int q = 0; q < p.npoles; ++q) {
      const T z = T(p.pole[q]);
      // causal initialisation, mirror boundary
      if (p.horizon[q] < n) {
        T zn = z;
        T acc = x[0];
        for (int k = 1; k < p.horizon[q]; ++k) {
          acc = acc + zn * x[k * s];
          zn = zn * z;
        }
        x[0] = acc;
      } else {
        T zn = z;
        const T iz = T(1) / z;
        T z2n = T(p.pn1[q]);
        T acc = x[0] + z2n * x[(n - 1) * s];
        z2n = z2n * (z2n * iz);
        for (int64_t k = 1; k < n - 1; ++k) {
          acc = acc + (zn + z2n) * x[k * s];
          zn = zn * z;
          z2n = z2n * iz;
        }
        x[0] = acc / T(p.denom[q]);
      }
      // causal pass
      T prev = x[0];
      for (int64_t k = 1; k < n; ++k) {
        prev = x[k * s] + z * prev;
        x[k * s] = prev;
      }
      // anti-causal initialisation and pass
      prev = T(p.pole[q] / (p.pole[q] * p.pole[q] - 1.0)) *
             (prev + z * x[(n - 2) * s]);
      x[(n - 1) * s] = prev;
      for (int64_t k = n - 2; k >= 0; --k) {
        prev = z * (prev - x[k * s]);
        x[k * s] = prev;
      }
    }
  }
  if (p.int_bits > 0) {
    const T lo = T(p.int_lo);
    const T span = T(ldexp(1.0, p.int_bits));
    for (int64_t k = 0; k < n; ++k) x[k * s] = cast_int_c(x[k * s], lo, span);
  }
}

// K4: the exact transpose of prefilter_kernel's filter (without the
// integer writeback), equal to filter_matrix(n).T (ops/prefilter.py): per
// pole in reverse order, the transposed anti-causal pass and its init row,
// ln[n-1] = c (ln[n-1] + p ln[n-2]); the transposed causal pass
// ln[k] += p ln[k-1]; the transposed causal init (either branch); the gain
// last.
template <typename T>
__global__ void __launch_bounds__(256)
prefilter_transpose_kernel(const T* __restrict__ in, T* __restrict__ out,
                           const Params p) {
  const int64_t line = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= p.outer * p.inner) return;
  const int64_t o = line / p.inner;
  const int64_t i = line - o * p.inner;
  const int64_t n = p.n;
  const int64_t s = p.inner;
  const T* src = in + o * n * s + i;
  T* x = out + o * n * s + i;

  for (int64_t k = 0; k < n; ++k) x[k * s] = src[k * s];
  if (n <= 1 || p.npoles == 0) return;
  for (int q = p.npoles - 1; q >= 0; --q) {
    const T z = T(p.pole[q]);
    // anti-causal pass ln[k] = z * (ln[k+1] - ln[k]), k = n-2 .. 0,
    // transposed: ct[k+1] += z * ct[k], then ct[k] *= -z, k = 0 .. n-2
    T u = x[0];
    for (int64_t k = 0; k < n - 1; ++k) {
      const T next = x[(k + 1) * s] + z * u;
      x[k * s] = u * -z;
      u = next;
    }
    // its init row ln[n-1] = c * (ln[n-1] + z * ln[n-2]), transposed
    const double c = p.pole[q] / (p.pole[q] * p.pole[q] - 1.0);
    x[(n - 2) * s] = x[(n - 2) * s] + T(c * p.pole[q]) * u;
    x[(n - 1) * s] = u * T(c);
    // causal pass ln[k] += z * ln[k-1], k = 1 .. n-1, transposed:
    // ct[k-1] += z * ct[k], k = n-1 .. 1
    T v = x[(n - 1) * s];
    for (int64_t k = n - 1; k >= 1; --k) {
      v = x[(k - 1) * s] + z * v;
      x[(k - 1) * s] = v;
    }
    // causal initialisation, transposed: row 0 spreads onto the others
    if (p.horizon[q] < n) {
      const T c0 = x[0];
      T zn = z;
      for (int k = 1; k < p.horizon[q]; ++k) {
        x[k * s] = x[k * s] + zn * c0;
        zn = zn * z;
      }
    } else {
      T zn = z;
      const T iz = T(1) / z;
      T z2n = T(p.pn1[q]);
      const T t = x[0] / T(p.denom[q]);
      x[0] = t;
      x[(n - 1) * s] = x[(n - 1) * s] + z2n * t;
      z2n = z2n * (z2n * iz);
      for (int64_t k = 1; k < n - 1; ++k) {
        x[k * s] = x[k * s] + (zn + z2n) * t;
        zn = zn * z;
        z2n = z2n * iz;
      }
    }
  }
  const T gain = T(p.gain);
  for (int64_t k = 0; k < n; ++k) x[k * s] = x[k * s] * gain;
}

// K6: the filter of prefilter_kernel with the initialisations of the
// boundary condition BC (reflect or wrap), no integer writeback.
template <typename T, int BC>
__global__ void __launch_bounds__(256)
prefilter_bc_kernel(const T* __restrict__ in, T* __restrict__ out,
                    const Params p) {
  const int64_t line = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= p.outer * p.inner) return;
  const int64_t o = line / p.inner;
  const int64_t i0 = line - o * p.inner;
  const int64_t n = p.n;
  const int64_t s = p.inner;
  const T* src = in + o * n * s + i0;
  T* x = out + o * n * s + i0;

  if (n <= 1 || p.npoles == 0) {
    for (int64_t k = 0; k < n; ++k) x[k * s] = src[k * s];
    return;
  }
  const T gain = T(p.gain);
  for (int64_t k = 0; k < n; ++k) x[k * s] = src[k * s] * gain;
  for (int q = 0; q < p.npoles; ++q) {
    const double zd = p.pole[q], znd = p.zn[q];
    const T z = T(zd);
    const T zn = T(znd);
    // causal initialisation over the whole period
    if (BC == BC_REFLECT) {
      const T c0 = x[0];
      T zi = T(1);
      T acc = T(0);
      for (int64_t i = 0; i < n; ++i) {
        acc = acc + zi * (x[i * s] + zn * x[(n - 1 - i) * s]);
        zi = zi * z;
      }
      x[0] = acc * T(zd / (1.0 - znd * znd)) + c0;
    } else {
      T zi = z;
      T acc = x[0];
      for (int64_t i = 1; i < n; ++i) {
        acc = acc + zi * x[(n - i) * s];
        zi = zi * z;
      }
      x[0] = acc * T(1.0 / (1.0 - znd));
    }
    // causal pass
    T prev = x[0];
    for (int64_t k = 1; k < n; ++k) {
      prev = x[k * s] + z * prev;
      x[k * s] = prev;
    }
    // anti-causal initialisation
    if (BC == BC_REFLECT) {
      prev = prev * T(zd / (zd - 1.0));
    } else {
      T zi = z;
      T acc = prev;
      for (int64_t i = 0; i < n - 1; ++i) {
        acc = acc + zi * x[i * s];
        zi = zi * z;
      }
      prev = acc * T(zd / (znd - 1.0));
    }
    x[(n - 1) * s] = prev;
    // anti-causal pass
    for (int64_t k = n - 2; k >= 0; --k) {
      prev = z * (prev - x[k * s]);
      x[k * s] = prev;
    }
  }
}

// K7: the exact transpose of prefilter_bc_kernel, equal to
// filter_matrix_bc(n, order, bc).T: per pole in reverse order, the
// transposed anti-causal pass (as K4), its transposed initialisation, the
// transposed causal pass (as K4), the transposed causal initialisation;
// the gain last.
template <typename T, int BC>
__global__ void __launch_bounds__(256)
prefilter_bc_transpose_kernel(const T* __restrict__ in, T* __restrict__ out,
                              const Params p) {
  const int64_t line = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= p.outer * p.inner) return;
  const int64_t o = line / p.inner;
  const int64_t i0 = line - o * p.inner;
  const int64_t n = p.n;
  const int64_t s = p.inner;
  const T* src = in + o * n * s + i0;
  T* x = out + o * n * s + i0;

  for (int64_t k = 0; k < n; ++k) x[k * s] = src[k * s];
  if (n <= 1 || p.npoles == 0) return;
  for (int q = p.npoles - 1; q >= 0; --q) {
    const double zd = p.pole[q], znd = p.zn[q];
    const T z = T(zd);
    const T zn = T(znd);
    // anti-causal pass, transposed; u ends as row n-1's cotangent
    T u = x[0];
    for (int64_t k = 0; k < n - 1; ++k) {
      const T next = x[(k + 1) * s] + z * u;
      x[k * s] = u * -z;
      u = next;
    }
    // its initialisation row, transposed
    if (BC == BC_REFLECT) {
      x[(n - 1) * s] = u * T(zd / (zd - 1.0));
    } else {
      const T t = u * T(zd / (znd - 1.0));
      x[(n - 1) * s] = t;
      T zi = z;
      for (int64_t i = 0; i < n - 1; ++i) {
        x[i * s] = x[i * s] + zi * t;
        zi = zi * z;
      }
    }
    // causal pass, transposed
    T v = x[(n - 1) * s];
    for (int64_t k = n - 1; k >= 1; --k) {
      v = x[(k - 1) * s] + z * v;
      x[(k - 1) * s] = v;
    }
    // causal initialisation, transposed: row 0 spreads over the line
    if (BC == BC_REFLECT) {
      const T t = x[0] * T(zd / (1.0 - znd * znd));
      T zi = T(1);
      for (int64_t i = 0; i < n; ++i) {
        x[i * s] = x[i * s] + zi * t;
        x[(n - 1 - i) * s] = x[(n - 1 - i) * s] + zn * zi * t;
        zi = zi * z;
      }
    } else {
      const T t = x[0] * T(1.0 / (1.0 - znd));
      x[0] = t;
      T zi = z;
      for (int64_t i = 1; i < n; ++i) {
        x[(n - i) * s] = x[(n - i) * s] + zi * t;
        zi = zi * z;
      }
    }
  }
  const T gain = T(p.gain);
  for (int64_t k = 0; k < n; ++k) x[k * s] = x[k * s] * gain;
}

template <typename T, int BC, bool TRANSPOSE>
cudaError_t launch_bc(const void* in, void* out, const Params& p,
                      cudaStream_t stream) {
  const int64_t lines = p.outer * p.inner;
  if (lines == 0 || p.n == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (lines + threads - 1) / threads;
  if (TRANSPOSE)
    prefilter_bc_transpose_kernel<T, BC>
        <<<(unsigned)blocks, threads, 0, stream>>>(
            static_cast<const T*>(in), static_cast<T*>(out), p);
  else
    prefilter_bc_kernel<T, BC><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <bool TRANSPOSE>
cudaError_t dispatch_bc(int dtype, int bc, const void* in, void* out,
                        const Params& p, cudaStream_t s) {
  if (dtype == 0 && bc == BC_REFLECT)
    return launch_bc<float, BC_REFLECT, TRANSPOSE>(in, out, p, s);
  if (dtype == 0 && bc == BC_WRAP)
    return launch_bc<float, BC_WRAP, TRANSPOSE>(in, out, p, s);
  if (dtype == 1 && bc == BC_REFLECT)
    return launch_bc<double, BC_REFLECT, TRANSPOSE>(in, out, p, s);
  if (dtype == 1 && bc == BC_WRAP)
    return launch_bc<double, BC_WRAP, TRANSPOSE>(in, out, p, s);
  return cudaErrorInvalidValue;
}

template <typename T, bool TRANSPOSE>
cudaError_t launch(const void* in, void* out, const Params& p,
                   cudaStream_t stream) {
  const int64_t lines = p.outer * p.inner;
  if (lines == 0 || p.n == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (lines + threads - 1) / threads;
  if (TRANSPOSE)
    prefilter_transpose_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), p);
  else
    prefilter_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), p);
  return cudaGetLastError();
}

bool make_params(Params* p, long long outer, long long n, long long inner,
                 int npoles, const double* poles, const int* horizons,
                 const double* pn1, const double* denom, double gain,
                 int int_bits, double int_lo) {
  if (npoles < 0 || npoles > ED_MAXPOLES) return false;
  p->outer = outer;
  p->n = n;
  p->inner = inner;
  p->npoles = npoles;
  for (int q = 0; q < ED_MAXPOLES; ++q) {
    const bool used = q < npoles;
    p->pole[q] = used ? poles[q] : 0.0;
    // the mirror terms are absent (null) for K6 and K7
    p->horizon[q] = used && horizons ? horizons[q] : 0;
    p->pn1[q] = used && pn1 ? pn1[q] : 0.0;
    p->denom[q] = used && denom ? denom[q] : 1.0;
    p->zn[q] = used ? pow(poles[q], (double)n) : 0.0;
  }
  p->gain = gain;
  p->int_bits = int_bits;
  p->int_lo = int_lo;
  return true;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64. poles/horizons/pn1/denom: npoles each
// (host-computed in float64). in and out must not overlap.
// Returns cudaGetLastError().
int ed_spline_prefilter(int dtype, const void* in, void* out, long long outer,
                        long long n, long long inner, int npoles,
                        const double* poles, const int* horizons,
                        const double* pn1, const double* denom, double gain,
                        int int_bits, double int_lo, void* stream) {
  Params p;
  if (!make_params(&p, outer, n, inner, npoles, poles, horizons, pn1, denom,
                   gain, int_bits, int_lo))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? launch<float, false>(in, out, p, s)
                    : dtype == 1 ? launch<double, false>(in, out, p, s)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

// K4, the transpose of ed_spline_prefilter's filter; the same arguments
// without the integer writeback. Returns cudaGetLastError().
int ed_spline_prefilter_transpose(int dtype, const void* in, void* out,
                                  long long outer, long long n,
                                  long long inner, int npoles,
                                  const double* poles, const int* horizons,
                                  const double* pn1, const double* denom,
                                  double gain, void* stream) {
  Params p;
  if (!make_params(&p, outer, n, inner, npoles, poles, horizons, pn1, denom,
                   gain, 0, 0.0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? launch<float, true>(in, out, p, s)
                    : dtype == 1 ? launch<double, true>(in, out, p, s)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

// K6 (transpose = 0) and K7 (transpose = 1): the filter and its transpose
// under boundary condition bc (1 reflect, 2 wrap). poles: npoles, host
// float64. in and out must not overlap. Returns cudaGetLastError().
int ed_spline_prefilter_bc(int dtype, int bc, int transpose, const void* in,
                           void* out, long long outer, long long n,
                           long long inner, int npoles, const double* poles,
                           double gain, void* stream) {
  Params p;
  if (!make_params(&p, outer, n, inner, npoles, poles, nullptr, nullptr,
                   nullptr, gain, 0, 0.0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = transpose ? dispatch_bc<true>(dtype, bc, in, out, p, s)
                              : dispatch_bc<false>(dtype, bc, in, out, p, s);
  return (int)err;
}

const char* ed_prefilter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
