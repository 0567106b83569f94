// The adjoints of K1 (resample.cu):
//
// K3 resample_bwd: the transpose of K1 with respect to the coefficients, a
// scatter. For each output voxel j inside the constant-mode mask and each
// of the (order+1)^naxis taps t:
//   d_coeffs[b, fold(start + t), c] += g[b, j, c] * prod_h w_h[t_h]
// with K1's coordinates, mode fold, tap fold and weights
// (resample_common.cuh). K1 reads the UNPADDED coefficients at the mirror
// fold of each tap index, so K3 adds into the folded index. That equals
// the JAX package's scatter into the mirror-padded table followed by the
// fold of the pad (elasticdeform_tpu/ops/windows.py:1354
// resample_windows_transpose, :1174 _scatter_fold, :1135 _scatter_group,
// :1488 window_unpad_axis; an XLA scatter on the TPU, no Pallas kernel);
// the adjoint identity against K1 checks it. The caller zero-fills
// d_coeffs. Bound on the H100: bytes; K3 reads g and the dense
// displacement (C + naxis values per voxel) and writes d_coeffs once.
//
// Design. The first form made one float32 atomicAdd into device memory
// per tap and channel (1.07 G at 64 x 64^3, order 3), at 76-79% of the
// card's L2 atomic rate: only fewer device-memory atomics could help. A
// block now owns a tile of the output (up to 8 x 8 x 8 voxels of the three
// innermost output axes, one voxel a thread; the outer axes and the batch
// walk the grid) and:
// 1. computes each voxel's coordinates, mode fold and first tap per axis
//    (kept in registers);
// 2. reduces the tile's least and greatest first tap per axis (a voxel
//    outside in constant mode does not count);
// 3. if the box of their taps, prod_h (hi - lo + order + 1) x C elements,
//    fits the plan's budget, zero-fills it in shared memory;
// 4. adds each tap's g * w at its UNFOLDED box position start + t - lo,
//    with shared-memory atomics (the weights recomputed from the fold);
// 5. flushes: each non-zero box element is mirror-folded per axis to its
//    element of d_coeffs and added there with one device-memory atomic.
//    Tiles overlap in their boxes, so the flush adds; an element left at
//    zero adds nothing and is skipped.
// That is the JAX package's scatter into a padded table and fold of the
// pad, one tile at a time. A block whose box does not fit, or whose
// coordinates are not finite or not of a sane size (a NaN must not size a
// box), takes the direct branch of the same kernel: one device-memory
// atomic per tap and channel at the folded offsets (tap_offsets).
// On the H100 a shared-memory float atomicAdd is a compare-and-swap loop
// (ATOMS.CAST.SPIN) that adds at about the rate of a device-memory atomic
// (PERF.md section 6): the box pays only where a voxel's taps overlap its
// neighbours' many times, so the plan keeps orders 0 and 1 on the direct
// route (ops/resample_bwd.py:BWD_TILE_ORDER), a kernel of its own
// (resample_direct_kernel, below), one thread a voxel. Variants measured
// at c5 (order 3; this form 5.6 ms, the direct branch 8.2) and not kept:
// swapping a run of taps with explicit compare-and-swap, several in
// flight, 26.7 ms; two or four boxes a block (fewer warps on each) 5.6;
// a __match_any_sync pre-reduction of the lanes that add at one box
// offset (rare: only voxels with one first tap share an offset), 14.6;
// a gather in place of the shared atomics, the voxels sorted by their
// first taps and each line of the box summed by one thread, 21.0, or
// each box element by one thread, 15.1.
// Like K1 and K5: the rank is a template parameter (tables in registers,
// outer axes picked by selects), offsets within a sample are int32 where
// fits_32 allows, the grid's y walks the batch (no 64-bit division per
// voxel), and channels are walked one at a time. The sums land in a
// run-dependent order (shared and device atomics), so the float32 result
// agrees with the plain twin (ops/resample_bwd.py:resample_transpose_plain)
// only to the rounding of a reordered sum.
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
// gradient with respect to those coordinates; K3c tiles the coordinates'
// own output shape, which the wrapper passes as the view of BwdTile (a
// flat point list is tiled in runs of 512). They replace the backward
// of the JAX package's map_coordinates (elasticdeform_tpu/ops/deform.py:608
// map_coordinates_gradient_apply, and the autodiff of :533 / :573, which
// reach _scatter_fold and the d_cc branch of _windows_op_bwd at the
// caller's coordinates). Plain twins: ops/resample_bwd.py
// resample_coords_transpose_plain and resample_coords_grad_plain. Bounds as
// for K3 and K5.

#include "resample_common.cuh"

namespace {

// K3/K3c's launch geometry: the output viewed as (outer, a, b, c), c
// innermost (the wrapper folds the output's leading axes into outer; K3's
// view is its output shape with leading 1s); a block owns a tile of
// 2^lg[0] x 2^lg[1] x 2^lg[2] voxels of (a, b, c) at one outer index of
// one sample, one voxel a thread. cap: the box elements (channels
// included) a block may stage in shared memory, cap * sizeof(T) bytes of
// dynamic shared memory; 0 sends every block to the direct branch.
struct BwdTile {
  int64_t view[4];
  int lg[3];
  int cap;
};

// The threads of a K3 block, one per voxel of its tile: 512 for float32
// with 32-bit offsets, 256 for the rest (their tables take twice the
// registers; at 512 threads a thread gets at most 128).
template <typename T, typename I>
struct BwdThreads {
  static constexpr int value = sizeof(T) > 4 || sizeof(I) > 4 ? 256 : 512;
};

// The blocks per SM that K3's launch bounds ask for (ptxas's register
// budget, 65536 / (threads * blocks)); see BwdThreads. Float32 with 32-bit
// offsets takes two (64 registers) up to 8 taps a voxel, but for rank 2
// at order 1, which spilled 8 bytes at 64; the rest one (128 registers
// at 512 threads, 255 at 256).
template <typename T, int NT, int NAXIS, typename I>
struct BwdBlocks {
  static constexpr int taps = voxel_taps(NT, NAXIS);
  static constexpr int value =
      sizeof(T) > 4 || sizeof(I) > 4           ? 1
      : taps <= 8 && !(NAXIS == 2 && NT == 2)  ? 2
                                               : 1;
};

// One voxel's taps land here: g_c * wt added at dst[o + c] for each
// channel c (g_0 held in a register, the others read per tap), with
// atomicAdd; dst is a box in shared memory (offsets of type int) or the
// sample's d_coeffs (offsets of type I, a reduction the thread does not
// wait on).
template <typename T, typename O>
struct TapSink {
  T* dst;
  const T* gv;
  T g0;
  O C;
  __device__ __forceinline__ void add(const O o, const T wt) const {
    atomicAdd(dst + o, g0 * wt);
    for (O c = 1; c < C; ++c) atomicAdd(dst + o + c, __ldg(gv + c) * wt);
  }
};

template <typename T, int NT, int NAXIS, int H, typename O, typename S>
__device__ __forceinline__ void scatter_axis(const S& sink, T wpre, O base,
                                             const T (&w)[NAXIS][NT],
                                             const O (&off)[NAXIS][NT]);

// Tap t of axis H, whose weight product over axes 0..H is wt and whose
// offset is o: at the innermost axis the sink takes it; above, the taps of
// the next axis.
template <typename T, int NT, int NAXIS, int H, typename O, typename S>
__device__ __forceinline__ void scatter_tap(const S& sink, const T wt,
                                            const O o,
                                            const T (&w)[NAXIS][NT],
                                            const O (&off)[NAXIS][NT]) {
  if constexpr (H == NAXIS - 1)
    sink.add(o, wt);
  else
    scatter_axis<T, NT, NAXIS, H + 1, O, S>(sink, wt, o, w, off);
}

// The taps of axes H..NAXIS-1 of one voxel, axis H slowest: `wpre` is the
// weight product over axes 0..H-1 (formed left to right, as K1 forms it)
// and `base` their offset. The innermost axes unroll, an outer axis loops
// and picks its table entries by selects (unrolled_axes).
template <typename T, int NT, int NAXIS, int H, typename O, typename S>
__device__ __forceinline__ void scatter_axis(const S& sink, const T wpre,
                                             const O base,
                                             const T (&w)[NAXIS][NT],
                                             const O (&off)[NAXIS][NT]) {
  if constexpr (H >= NAXIS - unrolled_axes(NT, NAXIS)) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
      scatter_tap<T, NT, NAXIS, H, O, S>(
          sink, H == 0 ? w[H][t] : wpre * w[H][t], base + off[H][t], w, off);
  } else {
#pragma unroll 1
    for (int t = 0; t < NT; ++t) {
      const T wh = pick(w[H], t);
      scatter_tap<T, NT, NAXIS, H, O, S>(sink, H == 0 ? wh : wpre * wh,
                                         base + pick(off[H], t), w, off);
    }
  }
}

template <typename V>
__device__ __forceinline__ V warp_min(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const V u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u < v ? u : v;
  }
  return v;
}

template <typename V>
__device__ __forceinline__ V warp_max(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const V u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// K3/K3c: one block per tile of one sample (BwdTile; the grid's y walks
// the batch), one voxel a thread, the steps of the design above.
template <typename T, int ORDER, int NAXIS, typename I>
__global__ void __launch_bounds__(
    (BwdThreads<T, I>::value), (BwdBlocks<T, ORDER + 1, NAXIS, I>::value))
resample_bwd_kernel(const T* __restrict__ g, const T* __restrict__ displ,
                    const T* __restrict__ affine, T* __restrict__ d_coeffs,
                    const Params p, const BwdTile tl, const bool coords) {
  constexpr int NT = ORDER + 1;
  constexpr int THREADS = BwdThreads<T, I>::value;
  constexpr int WARPS = THREADS / 32;
  extern __shared__ __align__(16) unsigned char ed_bwd_smem[];
  __shared__ I s_lo[WARPS][NAXIS], s_hi[WARPS][NAXIS];
  __shared__ int s_bad[WARPS];
  T* const box = reinterpret_cast<T*>(ed_bwd_smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const I C = (I)p.channels;

  // the tile's origin: blockIdx.x unravelled over (outer, a, b, c) tiles
  const int lg0 = tl.lg[0], lg1 = tl.lg[1], lg2 = tl.lg[2];
  const int64_t nt0 = ((tl.view[1] - 1) >> lg0) + 1;
  const int64_t nt1 = ((tl.view[2] - 1) >> lg1) + 1;
  const int64_t nt2 = ((tl.view[3] - 1) >> lg2) + 1;
  int64_t q = blockIdx.x;
  const int64_t q2 = q % nt2;
  q /= nt2;
  const int64_t q1 = q % nt1;
  q /= nt1;
  const I outer = (I)(q / nt0);
  // this thread's voxel: its output position and flat index in a sample
  const I y2 = (I)(q2 << lg2) + (tid & ((1 << lg2) - 1));
  const I y1 = (I)(q1 << lg1) + ((tid >> lg2) & ((1 << lg1) - 1));
  const I y0 = (I)((q % nt0) << lg0) + (tid >> (lg1 + lg2));
  const bool valid = (tid >> (lg0 + lg1 + lg2)) == 0 &&
                     y0 < (I)tl.view[1] && y1 < (I)tl.view[2] &&
                     y2 < (I)tl.view[3];
  const I v = ((outer * (I)tl.view[1] + y0) * (I)tl.view[2] + y1) *
                  (I)tl.view[3] + y2;

  for (int64_t b = blockIdx.y; b < p.batch; b += gridDim.y) {
    // 1. coordinates, mode folds and first taps
    T m[NAXIS];
    I st[NAXIS];
    bool ok = false, bad = false, nan = false;
    if (valid) {
      T cc[NAXIS];
      if (coords) {
        voxel_coords<T, NAXIS, I>(p, displ, affine, true, b, v, cc);
      } else {
        // K3's output index: the view's last NAXIS axes (outer is axis 0
        // of a 4-D output)
        const I y[4] = {outer, y0, y1, y2};
        I j[NAXIS];
#pragma unroll
        for (int h = 0; h < NAXIS; ++h) j[h] = y[h + 4 - NAXIS];
        displaced_coords<T, NAXIS, I>(p, displ, affine, b, v, j, cc);
      }
      ok = true;
#pragma unroll
      for (int h = 0; h < NAXIS; ++h) {
        m[h] = map_coord(cc[h], p.in_shape[h], p.mode, &ok);
        st[h] = first_tap<T, ORDER, I>(m[h]);
        // not finite, or far outside its axis: no box (the direct branch
        // takes the taps as K1 reads them)
        bad |= !(fabs(m[h]) < T(1 << 29));
        nan |= m[h] != m[h];
      }
      // from order 1 a NaN coordinate adds NaN to its taps even in
      // constant mode outside (the twin's NaN weights times a zeroed g)
      nan &= ORDER > 0;
      bad = (bad && ok) || nan;
    }

    // 2. the tile's least and greatest first tap per axis
    I lo[NAXIS], hi[NAXIS];
#pragma unroll
    for (int h = 0; h < NAXIS; ++h) {
      lo[h] = warp_min(ok ? st[h] : (I)(1 << 30));
      hi[h] = warp_max(ok ? st[h] : (I)(-(1 << 30)));
    }
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < NAXIS; ++h) {
        s_lo[warp][h] = lo[h];
        s_hi[warp][h] = hi[h];
      }
      s_bad[warp] = bad;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
#pragma unroll
      for (int h = 0; h < NAXIS; ++h) {
        lo[h] = s_lo[w][h] < lo[h] ? s_lo[w][h] : lo[h];
        hi[h] = s_hi[w][h] > hi[h] ? s_hi[w][h] : hi[h];
      }
      bad |= s_bad[w] != 0;
    }

    // 3. the box, prod_h (hi - lo + NT) x C elements, if it fits the cap
    int ext[NAXIS];
    int64_t size = p.channels;
    bool fits = !bad && lo[0] <= hi[0];
#pragma unroll
    for (int h = NAXIS - 1; h >= 0; --h) {
      const int64_t e = (int64_t)hi[h] - (int64_t)lo[h] + NT;
      fits &= e <= tl.cap;
      ext[h] = (int)(e < tl.cap ? e : tl.cap);
      size *= ext[h];
      fits &= size <= tl.cap;
      size = size < tl.cap ? size : tl.cap;
    }
    const T* gv = g + b * p.n_out * p.channels + v * C;
    T* const dst = d_coeffs + b * p.n_in * p.channels;

    if (fits) {
      const int n_box = (int)size;
      for (int e = tid; e < n_box; e += THREADS) box[e] = T(0);
      __syncthreads();
      // 4. the taps at their unfolded box positions, shared-memory atomics
      if (ok) {
        int bstride = (int)C;
        T w[NAXIS][NT];
        int boff[NAXIS][NT];
#pragma unroll
        for (int h = NAXIS - 1; h >= 0; --h) {
          spline_weights<T, ORDER>(m[h], w[h]);
          const int s0 = (int)(st[h] - lo[h]);
#pragma unroll
          for (int t = 0; t < NT; ++t) boff[h][t] = (s0 + t) * bstride;
          bstride *= ext[h];
        }
        const TapSink<T, int> sink{box, gv, gv[0], (int)C};
        scatter_axis<T, NT, NAXIS, 0, int>(sink, T(1), 0, w, boff);
      }
      __syncthreads();
      // 5. the flush: each non-zero box element mirror-folded per axis to
      // its element of d_coeffs, one device-memory atomic each
      for (int e = tid; e < n_box; e += THREADS) {
        const T val = box[e];
        if (val == T(0)) continue;
        int rem = e;
        I o = 0;
        if (C > 1) {
          o = (I)(rem % (int)C);
          rem /= (int)C;
        }
#pragma unroll
        for (int h = NAXIS - 1; h >= 0; --h) {
          int k = rem;
          if (h > 0) {
            k = rem % ext[h];
            rem /= ext[h];
          }
          const I n = (I)p.in_shape[h];
          const I at = lo[h] + (I)k;
          const I f = at >= 0 && at < n ? at : mirror_fold<I>(at, n);
          o += f * (I)(p.in_stride[h] * p.channels);
        }
        atomicAdd(dst + o, val);
      }
    } else if (ok || nan) {
      // the direct branch: one device-memory atomic per tap and channel
      T w[NAXIS][NT];
#pragma unroll
      for (int h = 0; h < NAXIS; ++h) spline_weights<T, ORDER>(m[h], w[h]);
      I off[NAXIS][NT];
      tap_offsets<NT, NAXIS, I>(p, st, off);
      const TapSink<T, I> sink{dst, gv, gv[0], C};
      scatter_axis<T, NT, NAXIS, 0, I>(sink, T(1), I(0), w, off);
    }
    __syncthreads();  // the box and the reduction's slots are reused
  }
}

// K3/K3c's direct route (the plan's "direct": orders 0 and 1, and the
// channel counts whose one-voxel box exceeds the budget). A kernel of its
// own, with no box, no tile reduction and no __syncthreads: one thread per
// output voxel in raster order, so a warp's 32 lanes take 32 consecutive
// voxels along the output's innermost axis and each tap's atomics and the
// coordinate and g reads fall in one row's consecutive elements, as
// grid_sampler_3d_backward's do (the tile route's warp of 8 x 4 voxels
// spread them over four rows: 184-202 G atomics/s at c7 against the
// library's 270; PERF.md section 6). Each voxel adds its taps as the tile
// route's direct branch does (direct_voxel), so NaN and infinities land
// where they did. Merging neighbouring voxels' taps before the atomics
// (across lanes by a warp shuffle, or a lane's 2-4 voxels in a register
// window with float2 / float4 reductions) cut the atomics but lost on the
// card at c7 and is not kept (PERF.md section 6).
constexpr int DIRECT_THREADS = 256;

// The taps t[0..NAXIS-2] (axis 0 slowest) of combination q of the outer
// axes' taps; unrolled, so with q a constant every t is one too (a call of
// the recursive voxel_taps here put a function call and its stack in the
// loop).
template <int NT, int NAXIS>
__device__ __forceinline__ void outer_taps(int q, int* t) {
#pragma unroll
  for (int h = NAXIS - 2; h >= 0; --h) {
    t[h] = q % NT;
    q /= NT;
  }
}

// The direct kernel's blocks per SM (its register budget, 65536 /
// (DIRECT_THREADS * blocks)), chosen by an A/B on the card: four (64
// registers, no spill) for float32 with 32-bit offsets up to 8 taps a
// voxel or ranks 1-3 up to order 4; two (128 registers) for float32's
// other tables, which spilled at 64; one for float64 and 64-bit offsets
// (their tables are twice as wide; not the hot path).
template <typename T, int NT, int NAXIS, typename I>
struct DirectBlocks {
  static constexpr int value =
      sizeof(T) > 4 || sizeof(I) > 4                       ? 1
      : voxel_taps(NT, NAXIS) > 8 && (NAXIS > 3 || NT > 5) ? 2
                                                           : 4;
};

// The output index j of flat voxel v (K3), in the index type I.
template <int NAXIS, typename I>
__device__ __forceinline__ void unravel(const Params& p, I v,
                                        I (&j)[NAXIS]) {
#pragma unroll
  for (int h = NAXIS - 1; h > 0; --h) {
    const I n = (I)p.out_shape[h];
    const I q = v / n;
    j[h] = v - q * n;
    v = q;
  }
  j[0] = v;
}

// One voxel's taps, one device-memory atomic per tap and channel: the
// tile route's direct branch, operation for operation. The coordinates of
// voxel v: K3c's given ones, or K3's at output index j.
template <typename T, int ORDER, int NAXIS, typename I>
__device__ __forceinline__ void direct_voxel(
    const T* __restrict__ g, const T* __restrict__ displ,
    const T* __restrict__ affine, T* __restrict__ dst, const Params& p,
    const bool coords, const int64_t b, const I v, const I (&j)[NAXIS]) {
  constexpr int NT = ORDER + 1;
  T cc[NAXIS];
  if (coords)
    voxel_coords<T, NAXIS, I>(p, displ, affine, true, b, v, cc);
  else
    displaced_coords<T, NAXIS, I>(p, displ, affine, b, v, j, cc);
  T m[NAXIS];
  I st[NAXIS];
  bool ok = true, nan = false;
#pragma unroll
  for (int h = 0; h < NAXIS; ++h) {
    m[h] = map_coord(cc[h], p.in_shape[h], p.mode, &ok);
    st[h] = first_tap<T, ORDER, I>(m[h]);
    nan |= m[h] != m[h];
  }
  // constant mode outside adds nothing, but from order 1 a NaN
  // coordinate's NaN weights do (the twin's NaN weights times its zeroed g)
  if (!ok && !(ORDER > 0 && nan)) return;
  T w[NAXIS][NT];
#pragma unroll
  for (int h = 0; h < NAXIS; ++h) spline_weights<T, ORDER>(m[h], w[h]);
  I off[NAXIS][NT];
  tap_offsets<NT, NAXIS, I>(p, st, off);
  const I C = (I)p.channels;
  const T* gv = g + b * p.n_out * p.channels + v * C;
  const TapSink<T, I> sink{dst, gv, gv[0], C};
  scatter_axis<T, NT, NAXIS, 0, I>(sink, T(1), I(0), w, off);
}

// K3/K3c's direct route: one thread per voxel of a sample; the grid's y
// walks the batch.
template <typename T, int ORDER, int NAXIS, typename I>
__global__ void __launch_bounds__(
    DIRECT_THREADS, (DirectBlocks<T, ORDER + 1, NAXIS, I>::value))
resample_direct_kernel(const T* __restrict__ g, const T* __restrict__ displ,
                       const T* __restrict__ affine, T* __restrict__ d_coeffs,
                       const Params p, const bool coords) {
  const int64_t t = (int64_t)blockIdx.x * DIRECT_THREADS + threadIdx.x;
  if (t >= p.n_out) return;
  const I v = (I)t;
  I j[NAXIS];
  if (coords) {
#pragma unroll
    for (int h = 0; h < NAXIS; ++h) j[h] = 0;
  } else {
    unravel<NAXIS, I>(p, v, j);
  }
  for (int64_t b = blockIdx.y; b < p.batch; b += gridDim.y)
    direct_voxel<T, ORDER, NAXIS, I>(g, displ, affine,
                                     d_coeffs + b * p.n_in * p.channels, p,
                                     coords, b, v, j);
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
// Order 1 runs two voxels a thread (coord_grad_pair_kernel): four blocks
// up to 8 taps (ranks 1-3), chosen by an A/B on the card (five spilled),
// two at rank 4 (four spilled).
template <typename T, int NT, int NAXIS, typename I>
struct CoordGradBlocks {
  static constexpr int taps = voxel_taps(NT, NAXIS);
  static constexpr int value = sizeof(T) > 4 || sizeof(I) > 4 ? 1
                               : NT == 2 && taps <= 8          ? 4
                               : NT == 2                       ? 2
                               : taps <= 8                     ? 5
                               : taps <= 16                    ? 4
                               : taps <= 64                    ? 3
                                                               : 2;
};

// Orders 2-5: one thread per output voxel of a sample; the grid's y walks
// the batch.
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

// K5/K5c at order 1 with a channel: two consecutive voxels a thread, the
// second reusing the coefficients of the first's taps
// that it shares. Along the innermost axis neighbouring voxels usually
// share their outer first taps and half their innermost taps (first taps
// one apart) or all of them (equal first taps), so a pair loads 12 or 8
// coefficients in 3-D instead of 16. Each voxel's contraction is
// contract's, operation for operation (contract_vals), so K5c stays bit
// for bit with the twin.

// contract for one channel, the coefficients of the taps given in `val`
// (tap order, the innermost axis fastest): the same operations in the same
// order as contract with C = 1.
template <typename T, int NT, int NAXIS, int H>
__device__ __forceinline__ Partials<T, NAXIS - H + 1> contract_vals(
    const T (&val)[voxel_taps(NT, NAXIS)], const int base,
    const T (&w)[NAXIS][NT], const T (&dw)[NAXIS][NT], const T g0) {
  constexpr int K = NAXIS - H + 1;
  Partials<T, K> acc = {};
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    Partials<T, K - 1> sub;
    if constexpr (H == NAXIS - 1)
      sub.v[0] = g0 * val[base * NT + t];
    else
      sub = contract_vals<T, NT, NAXIS, H + 1>(val, base * NT + t, w, dw, g0);
    T term[K];
    term[0] = w[H][t] * sub.v[0];
    term[1] = dw[H][t] * sub.v[0];
#pragma unroll
    for (int k = 1; k < K - 1; ++k) term[k + 1] = w[H][t] * sub.v[k];
#pragma unroll
    for (int k = 0; k < K; ++k)
      acc.v[k] = t == 0 ? term[k] : acc.v[k] + term[k];
  }
  return acc;
}

// One voxel of a pair at order 1 with one channel: coord_grad_voxel's
// operations, its coefficients loaded into `val` and its first taps kept
// in `start`, except the taps that are one of the pair's first voxel's
// (`prev_ok` if it was inside; its first taps `prev_start`: the same outer
// ones, an innermost tap at the same folded offset), which are taken from
// `prev_val`. Returns whether the voxel was inside.
template <typename T, int NAXIS, typename I>
__device__ __forceinline__ bool pair_voxel(
    const T* __restrict__ coeffs, const T* __restrict__ g,
    const T* __restrict__ displ, const T* __restrict__ affine,
    T* __restrict__ d_displ, const Params& p, const bool coords,
    const int64_t b, const I v, T (&val)[voxel_taps(2, NAXIS)],
    I (&start)[NAXIS], const bool prev_ok,
    const T (&prev_val)[voxel_taps(2, NAXIS)],
    const I (&prev_start)[NAXIS]) {
  constexpr int NT = 2;
  constexpr int TAPS = voxel_taps(NT, NAXIS);
  const I n_out = (I)p.n_out;
  T* dst = d_displ + b * NAXIS * p.n_out + v;
  T cc[NAXIS];
  voxel_coords<T, NAXIS, I>(p, displ, affine, coords, b, v, cc);
  T m[NAXIS], fd[NAXIS];
  bool inside = true;
#pragma unroll
  for (int h = 0; h < NAXIS; ++h) {
    m[h] = map_coord(cc[h], p.in_shape[h], p.mode, &inside);
    fd[h] = map_coord_grad(cc[h], p.in_shape[h], p.mode);
    start[h] = first_tap<T, 1, I>(m[h]);
  }
  if (!inside) {
#pragma unroll
    for (int h = 0; h < NAXIS; ++h) dst[h * n_out] = T(0);
    return false;
  }
  T w[NAXIS][NT], dw[NAXIS][NT];
#pragma unroll
  for (int h = 0; h < NAXIS; ++h) spline_weights<T, 1>(m[h], w[h]);
#pragma unroll
  for (int h = 0; h < NAXIS; ++h) spline_weights_grad<T, 1>(m[h], dw[h]);
  I off[NAXIS][NT];
  tap_offsets<NT, NAXIS, I>(p, start, off);
  // which of the first voxel's innermost taps each innermost tap equals,
  // where the outer first taps are the same (-1: none); one channel, so
  // an innermost tap's offset is its folded index
  bool same = prev_ok;
#pragma unroll
  for (int h = 0; h < NAXIS - 1; ++h) same &= start[h] == prev_start[h];
  const I n = (I)p.in_shape[NAXIS - 1], ps = prev_start[NAXIS - 1];
  const bool inner = ps >= 0 && ps + NT <= n;
  int match[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    match[t] = -1;
#pragma unroll
    for (int u = NT - 1; u >= 0; --u)
      match[t] = same && off[NAXIS - 1][t] ==
                             (inner ? ps + u : mirror_fold<I>(ps + u, n))
                     ? u : match[t];
  }
  const T* src = coeffs + b * p.n_in;
#pragma unroll
  for (int i = 0; i < TAPS; ++i) {
    int ti[NAXIS];
    outer_taps<NT, NAXIS + 1>(i, ti);
    I o = 0;
#pragma unroll
    for (int h = 0; h < NAXIS; ++h) o += off[h][ti[h]];
    const int t = i % NT, q = i - t;
    val[i] = match[t] < 0 ? __ldg(src + o)
             : match[t] == 0 ? prev_val[q] : prev_val[q + 1];
  }
  const T g0 = g[b * p.n_out + v];
  const Partials<T, NAXIS + 1> r =
      contract_vals<T, NT, NAXIS, 0>(val, 0, w, dw, g0);
#pragma unroll
  for (int h = 0; h < NAXIS; ++h) dst[h * n_out] = fd[h] * r.v[1 + h];
  return true;
}

// K5/K5c at order 1, two voxels a thread (v, v + 1); several channels take
// coord_grad_voxel for each.
template <typename T, int NAXIS, typename I>
__global__ void __launch_bounds__(256, (CoordGradBlocks<T, 2, NAXIS, I>::value))
coord_grad_pair_kernel(const T* __restrict__ coeffs, const T* __restrict__ g,
                       const T* __restrict__ displ,
                       const T* __restrict__ affine, T* __restrict__ d_displ,
                       const Params p, const bool coords) {
  constexpr int TAPS = voxel_taps(2, NAXIS);
  const int64_t v = 2 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (v >= p.n_out) return;
  const bool second = v + 1 < p.n_out;
  for (int64_t b = blockIdx.y; b < p.batch; b += gridDim.y) {
    if (p.channels != 1) {
      coord_grad_voxel<T, 1, NAXIS, I>(coeffs, g, displ, affine, d_displ, p,
                                       coords, b, (I)v);
      if (second)
        coord_grad_voxel<T, 1, NAXIS, I>(coeffs, g, displ, affine, d_displ,
                                         p, coords, b, (I)v + 1);
      continue;
    }
    T val[2][TAPS];
    I start[2][NAXIS];
    const bool ok = pair_voxel<T, NAXIS, I>(coeffs, g, displ, affine, d_displ,
                                            p, coords, b, (I)v, val[0],
                                            start[0], false, val[1],
                                            start[1]);
    if (second)
      pair_voxel<T, NAXIS, I>(coeffs, g, displ, affine, d_displ, p, coords, b,
                              (I)v + 1, val[1], start[1], ok, val[0],
                              start[0]);
  }
}

// K3/K3c's instantiation for a dtype, order, rank and index width, as a
// function pointer (the launch and the occupancy query take it).
template <typename T, int ORDER, typename I>
const void* bwd_kernel_rank(int naxis) {
  switch (naxis) {
    case 1: return (const void*)&resample_bwd_kernel<T, ORDER, 1, I>;
    case 2: return (const void*)&resample_bwd_kernel<T, ORDER, 2, I>;
    case 3: return (const void*)&resample_bwd_kernel<T, ORDER, 3, I>;
    case 4: return (const void*)&resample_bwd_kernel<T, ORDER, 4, I>;
  }
  return nullptr;
}

template <typename T, typename I>
const void* bwd_kernel_order(int order, int naxis) {
  switch (order) {
    case 0: return bwd_kernel_rank<T, 0, I>(naxis);
    case 1: return bwd_kernel_rank<T, 1, I>(naxis);
    case 2: return bwd_kernel_rank<T, 2, I>(naxis);
    case 3: return bwd_kernel_rank<T, 3, I>(naxis);
    case 4: return bwd_kernel_rank<T, 4, I>(naxis);
    case 5: return bwd_kernel_rank<T, 5, I>(naxis);
  }
  return nullptr;
}

// The threads of K3's block for a dtype and index width (BwdThreads).
int bwd_threads(int dtype, bool wide) {
  return dtype == 0 && !wide ? BwdThreads<float, int32_t>::value
                             : BwdThreads<double, int32_t>::value;
}

const void* bwd_kernel(int dtype, int order, int naxis, bool wide) {
  if (dtype == 0)
    return wide ? bwd_kernel_order<float, int64_t>(order, naxis)
                : bwd_kernel_order<float, int32_t>(order, naxis);
  if (dtype == 1)
    return wide ? bwd_kernel_order<double, int64_t>(order, naxis)
                : bwd_kernel_order<double, int32_t>(order, naxis);
  return nullptr;
}

// Host side: the tile from the C entry points' arguments; false if they
// are out of range (a view that is not n_out voxels, a tile over 512
// voxels, a grid of 2^31 blocks).
bool make_tile(BwdTile* tl, const Params& p, const long long* view,
               const int* lg, int cap) {
  int64_t n = 1;
  for (int k = 0; k < 4; ++k) {
    if (view[k] < 1) return false;
    tl->view[k] = view[k];
    n *= view[k];
  }
  if (n != p.n_out || cap < 0) return false;
  for (int k = 0; k < 3; ++k) {
    if (lg[k] < 0) return false;
    tl->lg[k] = lg[k];
  }
  if (lg[0] + lg[1] + lg[2] > 9) return false;  // at most 512 threads
  int64_t blocks = view[0];
  for (int k = 0; k < 3; ++k) blocks *= ((view[k + 1] - 1) >> lg[k]) + 1;
  tl->cap = cap;
  return blocks < ((int64_t)1 << 31);
}

// The zero fill of d_coeffs is the caller's; the kernel adds into it.
cudaError_t launch_bwd(int dtype, int order, bool wide, const void* g,
                       const void* displ, const void* affine, void* d_coeffs,
                       const Params& p, const BwdTile& tl, bool coords,
                       cudaStream_t stream) {
  if (p.channels < 1 || (!wide && !fits_32(p))) return cudaErrorInvalidValue;
  const void* fn = bwd_kernel(dtype, order, p.naxis, wide);
  const int threads = bwd_threads(dtype, wide);
  if (fn == nullptr || (1 << (tl.lg[0] + tl.lg[1] + tl.lg[2])) > threads)
    return cudaErrorInvalidValue;
  if (p.batch * p.n_out == 0) return cudaSuccess;
  int64_t blocks = tl.view[0];
  for (int k = 0; k < 3; ++k) blocks *= ((tl.view[k + 1] - 1) >> tl.lg[k]) + 1;
  const size_t smem = (size_t)tl.cap * (dtype == 0 ? 4 : 8);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)blocks,
                  (unsigned)(p.batch < 65535 ? p.batch : 65535));
  Params pc = p;
  BwdTile tc = tl;
  bool cf = coords;
  void* args[] = {(void*)&g,        (void*)&displ, (void*)&affine,
                  (void*)&d_coeffs, (void*)&pc,    (void*)&tc,
                  (void*)&cf};
  return cudaLaunchKernel(fn, grid, dim3(threads), args, smem, stream);
}

// The direct kernel's instantiation for a dtype (0 float32, 1 float64),
// order, rank and index width: F::run<T, ORDER, NAXIS, I>() of the functor
// `f` (the launch, or the function pointer for the occupancy query), or
// `none` if the arguments name none.
template <typename T, int ORDER, typename I, typename F, typename R>
R direct_rank(F& f, int naxis, R none) {
  switch (naxis) {
    case 1: return f.template run<T, ORDER, 1, I>();
    case 2: return f.template run<T, ORDER, 2, I>();
    case 3: return f.template run<T, ORDER, 3, I>();
    case 4: return f.template run<T, ORDER, 4, I>();
  }
  return none;
}

template <typename T, typename I, typename F, typename R>
R direct_order(F& f, int order, int naxis, R none) {
  switch (order) {
    case 0: return direct_rank<T, 0, I>(f, naxis, none);
    case 1: return direct_rank<T, 1, I>(f, naxis, none);
    case 2: return direct_rank<T, 2, I>(f, naxis, none);
    case 3: return direct_rank<T, 3, I>(f, naxis, none);
    case 4: return direct_rank<T, 4, I>(f, naxis, none);
    case 5: return direct_rank<T, 5, I>(f, naxis, none);
  }
  return none;
}

template <typename F, typename R>
R direct_dispatch(F& f, int dtype, int order, int naxis, bool wide, R none) {
  if (dtype == 0)
    return wide ? direct_order<float, int64_t>(f, order, naxis, none)
                : direct_order<float, int32_t>(f, order, naxis, none);
  if (dtype == 1)
    return wide ? direct_order<double, int64_t>(f, order, naxis, none)
                : direct_order<double, int32_t>(f, order, naxis, none);
  return none;
}

struct DirectPointer {
  template <typename T, int ORDER, int NAXIS, typename I>
  const void* run() {
    return (const void*)&resample_direct_kernel<T, ORDER, NAXIS, I>;
  }
};

struct DirectLaunch {
  const void* g;
  const void* displ;
  const void* affine;
  void* d_coeffs;
  Params p;
  bool coords;
  dim3 grid;
  cudaStream_t stream;
  template <typename T, int ORDER, int NAXIS, typename I>
  cudaError_t run() {
    resample_direct_kernel<T, ORDER, NAXIS, I>
        <<<grid, DIRECT_THREADS, 0, stream>>>(
            static_cast<const T*>(g), static_cast<const T*>(displ),
            static_cast<const T*>(affine), static_cast<T*>(d_coeffs), p,
            coords);
    return cudaGetLastError();
  }
};

// The zero fill of d_coeffs is the caller's; the kernel adds into it. One
// thread a voxel: a grid of 2^31 blocks or more is refused.
cudaError_t launch_direct(int dtype, int order, bool wide, const void* g,
                          const void* displ, const void* affine,
                          void* d_coeffs, const Params& p, bool coords,
                          cudaStream_t stream) {
  if (p.channels < 1 || (!wide && !fits_32(p))) return cudaErrorInvalidValue;
  const int64_t blocks = (p.n_out + DIRECT_THREADS - 1) / DIRECT_THREADS;
  if (blocks >= ((int64_t)1 << 31)) return cudaErrorInvalidValue;
  if (p.batch * p.n_out == 0) return cudaSuccess;
  DirectLaunch f{g, displ, affine, d_coeffs, p, coords,
                 dim3((unsigned)blocks,
                      (unsigned)(p.batch < 65535 ? p.batch : 65535)),
                 stream};
  return direct_dispatch(f, dtype, order, p.naxis, wide,
                         cudaErrorInvalidValue);
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
  const int64_t per = ORDER == 1 ? 2 * threads : threads;
  const dim3 grid((unsigned)((p.n_out + per - 1) / per),
                  (unsigned)(p.batch < 65535 ? p.batch : 65535));
  if constexpr (ORDER == 1) {
    coord_grad_pair_kernel<T, NAXIS, I><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(a.coeffs), static_cast<const T*>(a.g),
        static_cast<const T*>(a.displ), static_cast<const T*>(a.affine),
        static_cast<T*>(a.d_displ), p, coords);
  } else {
    coord_grad_kernel<T, ORDER, NAXIS, I><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(a.coeffs), static_cast<const T*>(a.g),
        static_cast<const T*>(a.displ), static_cast<const T*>(a.affine),
        static_cast<T*>(a.d_displ), p, coords);
  }
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

// K3. dtype: 0 float32, 1 float64. Shapes, offsets: naxis int64 each.
// affine: null, or (naxis, naxis+1) per sample at affine_stride elements
// apart (0 = one affine shared by the batch). d_coeffs (B, *in_shape, C)
// must be zero-filled. view: the output shape with leading 1s to 4 axes;
// lg: the tile's log2 extents over view's last three axes (at most the
// block's threads, BwdThreads); cap: the box elements a block may stage
// in shared memory (0: every block on the direct branch). wide: 64-bit offsets within a sample
// (required once a sample reaches 2^31 elements). Returns
// cudaGetLastError().
int ed_resample_bwd(int dtype, const void* g, const void* displ,
                    const void* affine, void* d_coeffs, int naxis, int order,
                    int mode, long long batch, long long channels,
                    const long long* in_shape, const long long* out_shape,
                    const long long* offsets, long long affine_stride,
                    const long long* view, const int* lg, int cap,
                    void* stream, int wide) {
  Params p;
  BwdTile tl;
  if (!make_params(&p, naxis, mode, batch, channels, in_shape, out_shape,
                   offsets, affine_stride, 0.0) ||
      !make_tile(&tl, p, view, lg, cap))
    return (int)cudaErrorInvalidValue;
  // K3 reads its output index off the view: the output shape itself
  for (int k = 0; k < 4; ++k)
    if (view[k] != (k < 4 - naxis ? 1 : out_shape[k - 4 + naxis]))
      return (int)cudaErrorInvalidValue;
  return (int)launch_bwd(dtype, order, wide != 0, g, displ, affine, d_coeffs,
                         p, tl, false, static_cast<cudaStream_t>(stream));
}

// K3 on the direct route (one thread a voxel, no box): as
// ed_resample_bwd without the tile's arguments.
int ed_resample_bwd_direct(int dtype, const void* g, const void* displ,
                           const void* affine, void* d_coeffs, int naxis,
                           int order, int mode, long long batch,
                           long long channels, const long long* in_shape,
                           const long long* out_shape,
                           const long long* offsets, long long affine_stride,
                           void* stream, int wide) {
  Params p;
  if (!make_params(&p, naxis, mode, batch, channels, in_shape, out_shape,
                   offsets, affine_stride, 0.0))
    return (int)cudaErrorInvalidValue;
  return (int)launch_direct(dtype, order, wide != 0, g, displ, affine,
                            d_coeffs, p, false,
                            static_cast<cudaStream_t>(stream));
}

// K3c on the direct route: as ed_resample_coords_bwd without the tile's
// arguments.
int ed_resample_coords_bwd_direct(int dtype, const void* g,
                                  const void* coords, void* d_coeffs,
                                  int naxis, int order, int mode,
                                  long long batch, long long channels,
                                  const long long* in_shape, long long n_out,
                                  void* stream, int wide) {
  Params p;
  if (!make_params_coords(&p, naxis, mode, batch, channels, in_shape, n_out,
                          0.0))
    return (int)cudaErrorInvalidValue;
  return (int)launch_direct(dtype, order, wide != 0, g, coords, nullptr,
                            d_coeffs, p, true,
                            static_cast<cudaStream_t>(stream));
}

// The direct kernel's blocks per SM (no dynamic shared memory), from
// CUDA's occupancy calculator; -1 if the arguments name no instantiation.
int ed_resample_direct_blocks_per_sm(int dtype, int order, int naxis,
                                     int wide) {
  DirectPointer f;
  const void* fn = direct_dispatch(f, dtype, order, naxis, wide != 0,
                                   (const void*)nullptr);
  int n = -1;
  if (fn == nullptr || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &n, fn, DIRECT_THREADS, 0) != cudaSuccess)
    return -1;
  return n;
}

// K3's blocks per SM with `smem` bytes of dynamic shared memory, from
// CUDA's occupancy calculator; -1 if the arguments name no instantiation.
int ed_resample_bwd_blocks_per_sm(int dtype, int order, int naxis, int wide,
                                  int smem) {
  const void* fn = bwd_kernel(dtype, order, naxis, wide != 0);
  int n = -1;
  if (fn == nullptr || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &n, fn, bwd_threads(dtype, wide != 0),
                           (size_t)smem) != cudaSuccess)
    return -1;
  return n;
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
// d_coeffs (B, *in_shape, C) zero-filled; view (the coordinates' output
// shape folded to 4 axes, n_out voxels), lg, cap and wide as for K3.
// Returns cudaGetLastError().
int ed_resample_coords_bwd(int dtype, const void* g, const void* coords,
                           void* d_coeffs, int naxis, int order, int mode,
                           long long batch, long long channels,
                           const long long* in_shape, long long n_out,
                           const long long* view, const int* lg, int cap,
                           void* stream, int wide) {
  Params p;
  BwdTile tl;
  if (!make_params_coords(&p, naxis, mode, batch, channels, in_shape, n_out,
                          0.0) ||
      !make_tile(&tl, p, view, lg, cap))
    return (int)cudaErrorInvalidValue;
  return (int)launch_bwd(dtype, order, wide != 0, g, coords, nullptr,
                         d_coeffs, p, tl, true,
                         static_cast<cudaStream_t>(stream));
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
