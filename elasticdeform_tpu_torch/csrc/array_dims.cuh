// The extents of a contiguous array of up to ED_DIMS_MAXD axes and fewer
// than 2^31 elements, and each voxel's edge word, shared by the kernels that
// index a neighbour by a linear offset and an edge word: K16 and K17
// (distance.cu) and K18 (measure.cu).
#pragma once

#define ED_DIMS_MAXD 8

namespace {

struct Dims {
  int ndim;
  unsigned n[ED_DIMS_MAXD];
};

// fills dm from `ndim` extents; false unless 1 <= ndim <= ED_DIMS_MAXD,
// every extent >= 1 and fewer than 2^31 elements in all
bool make_dims(int ndim, const long long* shape, Dims* dm,
               long long* total) {
  if (ndim < 1 || ndim > ED_DIMS_MAXD) return false;
  long long t = 1;
  dm->ndim = ndim;
  for (int k = 0; k < ED_DIMS_MAXD; ++k) dm->n[k] = 1;
  for (int k = 0; k < ndim; ++k) {
    if (shape[k] < 1) return false;
    dm->n[k] = (unsigned)shape[k];
    t *= shape[k];
    if (t >= (1LL << 31)) return false;
  }
  *total = t;
  return true;
}

// the axes where voxel v sits on the low edge (bits 0-7) and on the high
// edge (bits 8-15); a tap's word holds the axes it steps down along (bits
// 0-7) and up along (bits 8-15), so it leaves the array where the two meet
__device__ __forceinline__ unsigned edge_bits(unsigned v, const Dims& dm) {
  unsigned lo = 0, hi = 0, rem = v;
#pragma unroll
  for (int k = ED_DIMS_MAXD - 1; k >= 0; --k) {
    if (k < dm.ndim) {
      const unsigned c = rem % dm.n[k];
      rem /= dm.n[k];
      lo |= (unsigned)(c == 0) << k;
      hi |= (unsigned)(c == dm.n[k] - 1) << k;
    }
  }
  return lo | (hi << 8);
}

}  // namespace
