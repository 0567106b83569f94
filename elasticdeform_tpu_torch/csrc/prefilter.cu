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
// Optional fused writeback (int_bits > 0): after the axis, truncate toward
// zero and wrap modulo 2^int_bits (ops/resample.py cast_int_c), the
// reference's per-axis integer writeback, which is nonlinear and must run
// after each axis. It is computed in T with the plain version's operations.

#include <cuda_runtime.h>
#include <stdint.h>

#define ED_MAXPOLES 2

namespace {

struct Params {
  int64_t outer, n, inner;
  int npoles;
  double pole[ED_MAXPOLES];
  int horizon[ED_MAXPOLES];
  double pn1[ED_MAXPOLES];    // p^(n-1)
  double denom[ED_MAXPOLES];  // 1 - p^(2n-2)
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
    p->horizon[q] = used ? horizons[q] : 0;
    p->pn1[q] = used ? pn1[q] : 0.0;
    p->denom[q] = used ? denom[q] : 1.0;
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

const char* ed_prefilter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
