// K8 correlate1d, K8T correlate1d_transpose, K9 correlate_nd and K9T
// correlate_nd_transpose: the linear ndimage filter tier (SciPy's
// correlate1d / correlate with the filter boundary modes) and the exact
// transposes its gradient needs.
//
// K8 replaces the JAX package's elasticdeform_tpu/ops/filters.py:125
// apply_matrix1d with :83 filter_matrix (a dense banded n x n matrix per
// axis, the boundary fold in its edge columns, applied by a HIGHEST
// tensordot on the TPU's matrix unit) and :194 apply_paired1d (SciPy's paired
// summation, for integer outputs). Here it is a stencil:
//   out[i] = sum_k w[k] * x[fold(i + k - c)],  k = 0..L-1,
// along one axis of a contiguous tensor viewed as (outer, n, inner), with
// fold() the five filter modes and cval for a constant-mode tap beyond the
// edge; any L, also longer than the axis (the fold then repeats). Two orders,
// chosen per launch: the direct one, acc = x_0 w_0, then acc + x_k w_k; and
// the paired one, acc = x_s w_s, then acc + (x_{s-i} +- x_{s+i}) w_{s-i} for
// i = s..1, s = L/2. Plain twin: ops/filters.py correlate1d_plain, the same
// order over slices of the padded line. Two routes, picked on the host by
// ops/filters.py:_line_plan (K8T's plan):
// * tile (lines that fit a tile beside the taps and the pad table, fewer
//   than 2^31 elements): correlate1d_tile_kernel stages W whole lines with
//   cp.async on K8T's line tile (line_tile.cuh), the taps and the L - 1
//   folded pad indices in shared memory, then walks its lines' outputs from
//   there (tile_outputs): Q outputs a step from register windows on a
//   line's plain run, one at a time near its ends; each output in tap_sum's
//   order with the lines route's samples, so the two agree bit for bit.
// * lines (the rest): correlate1d_kernel, one thread per output, or
//   correlate1d_rows_kernel on the innermost axis.
// A non-finite sample or cval reaches only the outputs whose taps read it,
// as in SciPy (note R12 of ROADMAP.md).
//
// K8T replaces the transpose JAX gets by autodiff of that tensordot: the
// correlation with the flipped taps into the padded extent [-c, n + L-1-c),
// P(p) = sum_k w[k] g[p + c - k] over the k that land inside, then each pad
// folded back: x_bar[j] = P(j) + sum of P(p) over the pads p that fold onto j
// (a host-built per-position list; constant mode drops the pads). A gather:
// no atomics. Twin: correlate1d_transpose_plain. Two routes, picked on the
// host by ops/filters.py:_line_transpose_plan:
// * tile (lines that fit a tile beside the taps and the edge table, fewer
//   than 2^31 elements): a block stages W whole lines of g with cp.async
//   (line_tile.cuh, K4's tile and width choice), the taps and the edge table
//   in shared memory, then walks its lines' outputs from there: no tap, fold
//   list or index division touches device memory. The positions [a, b) of a
//   line are plain (fold list [j], every tap inside: the lines route's
//   interior branch); the 2(L - 1) or so others take their fold lists from
//   the table (ops/filters.py:_k8t_edges). Each output runs the lines
//   route's code in its order, so the two routes agree bit for bit.
// * lines (the rest): one thread per output, fold lists in device memory.
//
// K9 replaces ops/filters.py:317 apply_correlate (all three of its branches:
// the stacked banded matrices, the unrolled slice sum, the VALID convolution):
// the N-D correlation over the kernel's nonzero taps in raster order, with
// the fold on every axis and cval in constant mode; convolution is the flipped
// kernel with mirrored origins, done by the caller. Runs of axes where the
// kernel has extent 1 (batch axes) are merged by the caller; at most
// ED_FILTER_MAXR axes remain. K9T is its transpose, the N-D form of K8T: for
// output j, the sum over the product of the per-axis fold lists of P(p), the
// flipped-kernel correlation of g at padded position p. Twins:
// correlate_nd_plain and correlate_nd_transpose_plain. K9T's JAX reference
// is the autodiff of ops/filters.py:317 apply_correlate with respect to X.
//
// Layout and bound on the H100 of the lines and nd routes: one thread per
// output element, neighbouring threads on neighbouring addresses (the
// innermost index), so every tap's loads coalesce on any axis; the taps'
// reuse is served by L1. When the filtered axis is innermost (inner == 1),
// K8's lines route has each block load a tile of 256 outputs plus its L-1
// halo, folded, into shared memory. Interior
// elements (every tap inside the array) take a path with no fold. Each
// kernel's least time is its bytes, 2 * numel * sizeof(T) over 3.35 TB/s,
// for the tap counts of the filter tier (L FMAs per element at 67 TFLOP/s in
// float32 stay below that for L < ~40); a 5^3 kernel (c14) is bound by its
// operations.
//
// K9 and K9T take one of two routes each, picked on the host by
// ops/filters.py:_nd_plan from the shapes. K9's tile route
// (correlate_nd_tile_kernel) has K9T's geometry, block and tap column
// below; its box starts at the tile plus each axis' least tap offset and
// holds the element the nd route reads there, folded by the mode, or cval
// where constant mode leaves the array (stage_box_folded): so it adds the
// same terms in the same order as the nd route, bit for bit, with no fold
// in the tap loop. K9's nd route is correlate_nd_kernel. K9T's routes:
// * tile (at most 3 axes where the kernel has extent > 1, a box that fits
//   shared memory, each sample within int32): a block owns a tile of
//   C x 8 x 32 outputs over three tile axes (the kernel's axes; ranks 1-2
//   take batch axes or leading extents of 1 in their place), and the grid
//   walks the batch axes left over. The block first stages the tile's halo
//   box of g (the tile grown by the kernel's extent - 1 on each axis) into
//   shared memory with cp.async, zeros outside the array written by the
//   copy itself (its source size 0), and the nonzero taps (weight, and
//   offset into the box as int32, in raster order). Thread (y, x) keeps a
//   register column of C outputs along tile axis 0 and runs the tap list
//   for them (tap_column): one shared-memory load, one multiply and one add
//   per tap and output, no bounds test, no 64-bit index. An output sums its
//   taps in the nd route's raster order, acc = v_0 w_0, then acc + v_t w_t;
//   a tap landing outside reads a staged zero, so where the nd route adds no
//   term this route adds 0 * w_t: the same value up to the sign of a zero
//   (the check against the twin is per element to 1e-5 of the sum of the
//   absolute terms, which a zero term does not move; non-finite weights take
//   the nd route, since 0 * inf would be NaN). Outside constant mode a
//   border output then adds the other entries of the product of its fold
//   lists (j itself is the first), from device memory, in the nd route's
//   order and with its code (fold_rest); in constant mode every fold list is
//   [j] and the kernel has no such branch.
// * nd (everything else: more axes, a huge kernel, 2^31-element samples):
//   one thread per output with 64-bit indices, as described above.
//
// Built with --fmad=false, as every source of this package: products and
// sums round on their own, so K8 and K9 add in their twins' order and agree
// with them bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "line_tile.cuh"

#define ED_FILTER_MAXR 8
#define ED_ROW_TILE 256
#define ED_THREADS 256
// K8T's and K8's tile routes: threads a block, and outputs a thread
// computes at once
#define ED_K8T_THREADS 256
#define ED_K8T_WINDOW 4
#define ED_K8_WINDOW 4
// K9's and K9T's tile routes: a block of ED_TILE_Y x ED_TILE_X threads
#define ED_TILE_Y 8
#define ED_TILE_X 32

namespace {

enum { F_NEAREST = 0, F_WRAP = 1, F_REFLECT = 2, F_MIRROR = 3, F_CONSTANT = 4 };

// index j folded into [0, n) by the filter mode (ops/filters.py
// _fold_index); -1 for a tap beyond the edge in constant mode
__device__ __forceinline__ int64_t fold(int64_t j, int64_t n, int mode) {
  if (j >= 0 && j < n) return j;
  switch (mode) {
    case F_NEAREST:
      return j < 0 ? 0 : n - 1;
    case F_WRAP: {
      const int64_t m = j % n;
      return m < 0 ? m + n : m;
    }
    case F_REFLECT: {
      const int64_t per = 2 * n;
      int64_t m = j % per;
      if (m < 0) m += per;
      return m < n ? m : per - 1 - m;
    }
    case F_MIRROR: {
      if (n == 1) return 0;
      const int64_t per = 2 * n - 2;
      int64_t m = j % per;
      if (m < 0) m += per;
      return m < n ? m : per - m;
    }
    default:
      return -1;
  }
}

struct Line {
  int64_t outer, n, inner;
  int taps, center, mode;
  int pair;  // 0 direct order; 1 / -1 SciPy's paired order, (anti)symmetric
  double cval;
};

// the taps of one output in the kernel's order; v(k) is the sample tap k
// reads
template <typename T, typename V>
__device__ __forceinline__ T tap_sum(const T* __restrict__ w, int L, int pair,
                                     V v) {
  if (pair == 0) {
    T acc = v(0) * w[0];
    for (int k = 1; k < L; ++k) acc = acc + v(k) * w[k];
    return acc;
  }
  const int s1 = L / 2;
  T acc = v(s1) * w[s1];
  for (int ii = s1; ii >= 1; --ii) {
    const T t = pair > 0 ? v(s1 - ii) + v(s1 + ii) : v(s1 - ii) - v(s1 + ii);
    acc = acc + t * w[s1 - ii];
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ T line_sample(const T* __restrict__ line, int64_t j,
                                         int64_t s, const Line& p, T cval) {
  const int64_t f = fold(j, p.n, p.mode);
  return f < 0 ? cval : line[f * s];
}

// K8 on any axis: thread e takes output (o, i, q) of the (outer, n, inner)
// view
template <typename T>
__global__ void __launch_bounds__(ED_THREADS)
correlate1d_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const T* __restrict__ w, const Line p) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per_outer = p.n * p.inner;
  if (e >= p.outer * per_outer) return;
  const int64_t o = e / per_outer;
  const int64_t r = e - o * per_outer;
  const int64_t i = r / p.inner;
  const int64_t q = r - i * p.inner;
  const int64_t s = p.inner;
  const T* line = x + o * per_outer + q;
  const int64_t j0 = i - p.center;
  if (j0 >= 0 && j0 + p.taps <= p.n) {
    const T* base = line + j0 * s;
    out[e] = tap_sum<T>(w, p.taps, p.pair,
                        [&](int k) { return base[k * s]; });
  } else {
    const T cval = T(p.cval);
    out[e] = tap_sum<T>(w, p.taps, p.pair, [&](int k) {
      return line_sample(line, j0 + k, s, p, cval);
    });
  }
}

// K8 on the innermost axis: block b takes outputs [t0, t0 + 256) of line o;
// the folded samples [t0 - c, t0 + 256 + L-1 - c) go to shared memory first
template <typename T>
__global__ void __launch_bounds__(ED_ROW_TILE)
correlate1d_rows_kernel(const T* __restrict__ x, T* __restrict__ out,
                        const T* __restrict__ w, const Line p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int64_t tiles = (p.n + ED_ROW_TILE - 1) / ED_ROW_TILE;
  const int64_t o = blockIdx.x / tiles;
  const int64_t t0 = (blockIdx.x - o * tiles) * (int64_t)ED_ROW_TILE;
  const T* line = x + o * p.n;
  const int width = ED_ROW_TILE + p.taps - 1;
  const T cval = T(p.cval);
  for (int k = threadIdx.x; k < width; k += blockDim.x)
    tile[k] = line_sample(line, t0 - p.center + k, 1, p, cval);
  __syncthreads();
  const int64_t i = t0 + threadIdx.x;
  if (i >= p.n) return;
  const T* v = tile + threadIdx.x;
  out[o * p.n + i] = tap_sum<T>(w, p.taps, p.pair,
                                [&](int k) { return v[k]; });
}

// K8T: x_bar[j] = sum over the fold list of j (j itself first, then the pads
// folding onto it, in order) of P(p) = sum_k w[k] g[p + c - k], k ascending,
// over the k with p + c - k inside the line
template <typename T>
__global__ void __launch_bounds__(ED_THREADS)
correlate1d_transpose_kernel(const T* __restrict__ g, T* __restrict__ out,
                             const T* __restrict__ w,
                             const int* __restrict__ ptr,
                             const int* __restrict__ pos, const Line p) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per_outer = p.n * p.inner;
  if (e >= p.outer * per_outer) return;
  const int64_t o = e / per_outer;
  const int64_t r = e - o * per_outer;
  const int64_t j = r / p.inner;
  const int64_t q = r - j * p.inner;
  const int64_t s = p.inner;
  const T* line = g + o * per_outer + q;
  const int beg = ptr[j], end = ptr[j + 1];
  const int64_t top = j + p.center;  // g index of tap 0 at position j
  if (end - beg == 1 && top - (p.taps - 1) >= 0 && top < p.n) {
    T acc = line[top * s] * w[0];
    for (int k = 1; k < p.taps; ++k) acc = acc + line[(top - k) * s] * w[k];
    out[e] = acc;
    return;
  }
  T acc = T(0);
  for (int l = beg; l < end; ++l) {
    const int64_t pq = (int64_t)pos[l] + p.center;
    T part = T(0);
    for (int k = 0; k < p.taps; ++k) {
      const int64_t i = pq - k;
      if (i >= 0 && i < p.n) part = part + line[i * s] * w[k];
    }
    acc = l == beg ? part : acc + part;
  }
  out[e] = acc;
}

// K8T's tile route: the positions [a, b) of a line are plain (fold list
// [j], every tap inside the line: the lines route's interior branch); the
// others, j < a and then j >= b, are the table's rows, whose fold lists it
// holds as CSR arrays (rows + 1 offsets, then npos positions), built on the
// host (ops/filters.py:_k8t_edges) and staged in shared memory.
struct K8tEdges {
  int a, b, rows, npos;
  int gather;  // packed tiles: the outputs gather in a second shared tile
};

// P(top - c) at an interior position: acc = g[top] w_0, then acc +
// g[top - k] w_k, from the line x at stride s
template <typename T>
__device__ __forceinline__ T k8t_interior(const T* x, int s, int top,
                                          const T* w, int L) {
  const T* v = x + top * s;
  T acc = v[0] * w[0];
  for (int k = 1; k < L; ++k) acc = acc + v[-k * s] * w[k];
  return acc;
}

// x_bar[j] of the line x (at stride s in shared memory) in the lines
// route's order and with its branches: the interior sum, or the parts of
// j's fold list in order, each part from 0 over the taps landing inside
template <typename T>
__device__ __forceinline__ T k8t_output(const T* x, int s, int j, int n,
                                        int L, int c, const T* w,
                                        const K8tEdges& e, const int* eptr,
                                        const int* epos) {
  const int top = j + c;
  if (j >= e.a && j < e.b) return k8t_interior(x, s, top, w, L);
  const int row = j < e.a ? j : e.a + (j - e.b);
  const int beg = eptr[row], end = eptr[row + 1];
  if (end - beg == 1 && top - (L - 1) >= 0 && top < n)
    return k8t_interior(x, s, top, w, L);
  T acc = T(0);
  for (int l = beg; l < end; ++l) {
    const int pq = epos[l] + c;
    // the k with 0 <= pq - k < n, ascending
    const int k0 = pq - (n - 1) > 0 ? pq - (n - 1) : 0;
    const int k1 = pq < L - 1 ? pq : L - 1;
    T part = T(0);
    for (int k = k0; k <= k1; ++k) part = part + x[(pq - k) * s] * w[k];
    acc = l == beg ? part : acc + part;
  }
  return acc;
}

// Q interior outputs at tops top0 .. top0 + Q - 1 of the line x (stride s)
// from a register window sliding down the line: one shared-memory load a
// tap for all Q, each output still acc = g[top] w_0, then acc + g[top - k]
// w_k, k ascending (k8t_interior's order)
template <typename T, int Q>
__device__ __forceinline__ void k8t_window(T (&acc)[Q], const T* x, int s,
                                           int top0, const T* w, int L) {
  T v[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) v[q] = x[(top0 + q) * s];
  const T w0 = w[0];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = v[q] * w0;
  const T* down = x + top0 * s;
  for (int k = 1; k < L; ++k) {
#pragma unroll
    for (int q = Q - 1; q > 0; --q) v[q] = v[q - 1];
    v[0] = down[-k * s];
    const T wk = w[k];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = acc[q] + v[q] * wk;
  }
}

// The outputs of a line tile's lines (K8's and K8T's tile routes), once
// the tile is staged: thread (w, r) walks segment r of line w (R =
// ED_K8T_THREADS / W threads a line), Q outputs at a time from a register
// window (window(acc, x, s, j): outputs j .. j + Q - 1) on the plain run
// [a, b), one at a time elsewhere (single(x, s, j)). Line w's element k
// lies at x[k * s] in the tile. A warp's threads take consecutive lines at
// one position, so their branches agree and their shared-memory loads fall
// in distinct banks (the tile's strides). On column tiles (inner >= W)
// their stores are consecutive too; on packed ones (whole outers, inner <
// W) they lie a line apart, so where a second tile fits (gather, at obuf)
// the outputs gather there and the block stores them as one run.
template <typename T, int W, int Q, typename Win, typename One>
__device__ __forceinline__ void tile_outputs(T* __restrict__ out,
                                             const T* tile, T* obuf,
                                             const Tile& t,
                                             const TileSpan& sp, int n,
                                             int64_t inner, int a, int b,
                                             bool gather, Win window,
                                             One single) {
  constexpr int R = ED_K8T_THREADS / W;
  const int tid = threadIdx.x;
  const int lw = tid % W, lr = tid / W;
  if (lw < sp.width) {
    // line lw: element k at x[k * s] in the tile, output k at dst[k * ds]
    const T* x;
    T* dst;
    int s;
    int64_t ds;
    if (t.packed) {
      const int in = (int)inner, ol = lw / in, ri = lw - ol * in;
      x = tile + ol * t.stride + ri;
      dst = gather ? obuf + ol * t.stride + ri
                   : out + sp.first + (int64_t)ol * n * in + ri;
      s = in;
      ds = in;
    } else {
      x = tile + lw;
      dst = out + sp.first;
      s = t.stride;
      ds = inner;
    }
    const int seg = (n + R - 1) / R;
    int j = lr * seg;
    const int j1 = j + seg < n ? j + seg : n;
    const int b1 = j1 < b ? j1 : b;
    while (j < j1) {
      if (j >= a && j + Q <= b1) {
        T acc[Q];
        window(acc, x, s, j);
#pragma unroll
        for (int q = 0; q < Q; ++q) dst[(j + q) * ds] = acc[q];
        j += Q;
      } else {
        dst[j * ds] = single(x, s, j);
        ++j;
      }
    }
  }
  if (gather) {
    __syncthreads();
    T* o = out + sp.first;
    packed_walk<ED_K8T_THREADS>(t, n * (int)inner, sp.outers, tid,
                                [&](int q, int sh) { o[q] = obuf[sh]; });
  }
}

// K8T, tile route: block b stages tile b's W lines of g (line_tile.cuh),
// the taps and the edge table in shared memory with all ED_K8T_THREADS
// threads, then computes every output of its lines from there
// (tile_outputs): Q outputs at a time from a register window on the plain
// run, one at a time at the edges. At most 4 blocks' worth of registers
// per SM are asked for (64 a thread).
template <typename T, int W>
__global__ void __launch_bounds__(ED_K8T_THREADS, 4)
correlate1d_transpose_tile_kernel(const T* __restrict__ g,
                                  T* __restrict__ out,
                                  const T* __restrict__ w,
                                  const int* __restrict__ table,
                                  const Line p, const Tile t,
                                  const K8tEdges e) {
  constexpr int R = ED_K8T_THREADS / W;
  constexpr int Q = ED_K8T_WINDOW;
  extern __shared__ __align__(16) unsigned char ed_smem[];
  T* tile = reinterpret_cast<T*>(ed_smem);
  const int n = (int)p.n;
  const int tid = threadIdx.x;
  const int lw = tid % W, lr = tid / W;
  const TileSpan sp = tile_span<W>(t, blockIdx.x, p.outer, p.n, p.inner, lw);
  // packed, the outputs may gather in a second tile, stored as one run
  const int cells = (t.packed ? t.lines / (int)p.inner : n) * t.stride;
  T* obuf = tile + cells;
  T* tw = tile + (e.gather ? 2 : 1) * cells;
  int* eptr = reinterpret_cast<int*>(tw + p.taps);
  const int* epos = eptr + e.rows + 1;
  stage_tile<T, W, R>(tile, g, t, sp, n, p.inner, lw, lr);
  for (int k = tid; k < p.taps; k += ED_K8T_THREADS) tw[k] = w[k];
  for (int k = tid; k < e.rows + 1 + e.npos; k += ED_K8T_THREADS)
    eptr[k] = table[k];
  stage_wait();
  __syncthreads();
  const int L = p.taps, c = p.center;
  tile_outputs<T, W, Q>(
      out, tile, obuf, t, sp, n, p.inner, e.a, e.b, e.gather != 0,
      [&](T(&acc)[Q], const T* x, int s, int j) {
        k8t_window<T, Q>(acc, x, s, j + c, tw, L);
      },
      [&](const T* x, int s, int j) {
        return k8t_output(x, s, j, n, L, c, tw, e, eptr, epos);
      });
}

// K8's tile route: outputs [a, b) of a line read only samples inside it
// (i - c >= 0, i - c + L <= n: the lines route's interior branch); the
// others read the samples the pads of the padded line [-c, n + L-1-c) fold
// onto, from a table of L - 1 int32 entries (the c left pads, then the L-1-c
// right ones), each the sample index folded by the mode or -1 for cval
// (ops/filters.py:_k8_edges), staged in shared memory
struct K8Edges {
  int a, b;
  int gather;  // packed tiles: the outputs gather in a second shared tile
};

// Q interior outputs of the line x (stride s) whose first taps read
// samples j0 .. j0 + Q - 1, from register windows sliding along the line,
// one shared-memory load a tap (direct order) or two a pair (paired order)
// for all Q, each output still in tap_sum's order: acc = x_0 w_0, then acc
// + x_k w_k; or acc = x_s w_s, then acc + (x_{s-i} +- x_{s+i}) w_{s-i} for
// i = s..1
template <typename T, int Q>
__device__ __forceinline__ void k8_window(T (&acc)[Q], const T* x, int s,
                                          int j0, const T* w, int L,
                                          int pair) {
  if (pair == 0) {
    T v[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = x[(j0 + q) * s];
    const T w0 = w[0];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = v[q] * w0;
    for (int k = 1; k < L; ++k) {
#pragma unroll
      for (int q = 0; q < Q - 1; ++q) v[q] = v[q + 1];
      v[Q - 1] = x[(j0 + Q - 1 + k) * s];
      const T wk = w[k];
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[q] = acc[q] + v[q] * wk;
    }
    return;
  }
  const int s1 = L / 2;
  const T ws = w[s1];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = x[(j0 + s1 + q) * s] * ws;
  // lft[q] = x_{j0+q+k}, rgt[q] = x_{j0+q+2 s1-k} at pair k = s1 - i
  T lft[Q], rgt[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    lft[q] = x[(j0 + q) * s];
    rgt[q] = x[(j0 + 2 * s1 + q) * s];
  }
  for (int k = 0; k < s1; ++k) {
    const T wk = w[k];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const T tq = pair > 0 ? lft[q] + rgt[q] : lft[q] - rgt[q];
      acc[q] = acc[q] + tq * wk;
    }
    if (k + 1 < s1) {
#pragma unroll
      for (int q = 0; q < Q - 1; ++q) lft[q] = lft[q + 1];
      lft[Q - 1] = x[(j0 + Q + k) * s];
#pragma unroll
      for (int q = Q - 1; q > 0; --q) rgt[q] = rgt[q - 1];
      rgt[0] = x[(j0 + 2 * s1 - k - 1) * s];
    }
  }
}

// K8, tile route: block b stages tile b's W lines of x (line_tile.cuh),
// the taps and the edge table in shared memory with all ED_K8T_THREADS
// threads, then computes every output of its lines from there
// (tile_outputs, K8T's walk): Q = ED_K8_WINDOW outputs at a time from
// register windows on the plain run, one at a time at the edges, each in
// the lines route's order (tap_sum) and with its samples, so the two
// routes agree bit for bit, NaN and infinities included. At most 4 blocks'
// worth of registers per SM are asked for in float32 (64 a thread), 3 in
// float64 (85: at 64 the paired window spilled on the H100; the plan's
// wave count, line_waves, assumes up to 4).
template <typename T, int W>
__global__ void __launch_bounds__(ED_K8T_THREADS, sizeof(T) == 8 ? 3 : 4)
correlate1d_tile_kernel(const T* __restrict__ x, T* __restrict__ out,
                        const T* __restrict__ w,
                        const int* __restrict__ table, const Line p,
                        const Tile t, const K8Edges e) {
  constexpr int R = ED_K8T_THREADS / W;
  constexpr int Q = ED_K8_WINDOW;
  extern __shared__ __align__(16) unsigned char ed_smem[];
  T* tile = reinterpret_cast<T*>(ed_smem);
  const int n = (int)p.n;
  const int tid = threadIdx.x;
  const int lw = tid % W, lr = tid / W;
  const TileSpan sp = tile_span<W>(t, blockIdx.x, p.outer, p.n, p.inner, lw);
  const int cells = (t.packed ? t.lines / (int)p.inner : n) * t.stride;
  T* obuf = tile + cells;
  T* tw = tile + (e.gather ? 2 : 1) * cells;
  int* pads = reinterpret_cast<int*>(tw + p.taps);
  stage_tile<T, W, R>(tile, x, t, sp, n, p.inner, lw, lr);
  for (int k = tid; k < p.taps; k += ED_K8T_THREADS) tw[k] = w[k];
  for (int k = tid; k < p.taps - 1; k += ED_K8T_THREADS) pads[k] = table[k];
  stage_wait();
  __syncthreads();
  const int L = p.taps, c = p.center, pair = p.pair;
  const T cval = T(p.cval);
  tile_outputs<T, W, Q>(
      out, tile, obuf, t, sp, n, p.inner, e.a, e.b, e.gather != 0,
      [&](T(&acc)[Q], const T* xl, int s, int j) {
        k8_window<T, Q>(acc, xl, s, j - c, tw, L, pair);
      },
      [&](const T* xl, int s, int j) {
        if (j >= e.a && j < e.b) {
          const T* base = xl + (j - c) * s;
          return tap_sum<T>(tw, L, pair, [&](int k) { return base[k * s]; });
        }
        return tap_sum<T>(tw, L, pair, [&](int k) {
          const int i = j - c + k;
          const int f = i < 0 ? pads[i + c] : i >= n ? pads[c + i - n] : i;
          return f < 0 ? cval : xl[f * s];
        });
      });
}

struct Nd {
  int rank, taps, mode;
  double cval;
  int64_t total;
  int64_t n[ED_FILTER_MAXR], stride[ED_FILTER_MAXR];
  int lo[ED_FILTER_MAXR], hi[ED_FILTER_MAXR];  // least, greatest tap offset
  int ptr_base[ED_FILTER_MAXR];  // K9T: axis d's rows in ptr; -1 identity
};

__device__ __forceinline__ void unravel(int64_t e, const Nd& p,
                                        int64_t* idx) {
#pragma unroll
  for (int d = ED_FILTER_MAXR - 1; d >= 0; --d) {
    if (d < p.rank) {
      const int64_t qd = e / p.n[d];
      idx[d] = e - qd * p.n[d];
      e = qd;
    } else {
      idx[d] = 0;
    }
  }
}

// K9: off[t * rank + d] is tap t's offset along axis d, delta[t] the same as
// a linear offset
template <typename T>
__global__ void __launch_bounds__(ED_THREADS)
correlate_nd_kernel(const T* __restrict__ x, T* __restrict__ out,
                    const T* __restrict__ w, const int* __restrict__ off,
                    const int64_t* __restrict__ delta, const Nd p) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.total) return;
  int64_t idx[ED_FILTER_MAXR];
  unravel(e, p, idx);
  bool interior = true;
#pragma unroll
  for (int d = 0; d < ED_FILTER_MAXR; ++d)
    if (d < p.rank &&
        (idx[d] + p.lo[d] < 0 || idx[d] + p.hi[d] >= p.n[d]))
      interior = false;
  T acc = T(0);
  if (interior) {
    acc = x[e + delta[0]] * w[0];
    for (int t = 1; t < p.taps; ++t) acc = acc + x[e + delta[t]] * w[t];
  } else {
    const T cval = T(p.cval);
    for (int t = 0; t < p.taps; ++t) {
      int64_t a = 0;
      bool inside = true;
#pragma unroll
      for (int d = 0; d < ED_FILTER_MAXR; ++d) {
        if (d < p.rank && inside) {
          const int64_t f = fold(idx[d] + off[t * p.rank + d], p.n[d], p.mode);
          if (f < 0)
            inside = false;
          else
            a += f * p.stride[d];
        }
      }
      const T v = inside ? x[a] : cval;
      acc = t == 0 ? v * w[0] : acc + v * w[t];
    }
  }
  out[e] = acc;
}

// K9T: for output j, the sum over the product of the per-axis fold lists of
// P(p) = sum_t w[t] g[p - off_t] over the taps landing inside the array
template <typename T>
__global__ void __launch_bounds__(ED_THREADS)
correlate_nd_transpose_kernel(const T* __restrict__ g, T* __restrict__ out,
                              const T* __restrict__ w,
                              const int* __restrict__ off,
                              const int64_t* __restrict__ delta,
                              const int* __restrict__ ptr,
                              const int* __restrict__ pos, const Nd p) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.total) return;
  int64_t idx[ED_FILTER_MAXR];
  unravel(e, p, idx);
  int beg[ED_FILTER_MAXR], cnt[ED_FILTER_MAXR];
  bool interior = true;
#pragma unroll
  for (int d = 0; d < ED_FILTER_MAXR; ++d) {
    beg[d] = -1;
    cnt[d] = 1;
    if (d < p.rank) {
      if (p.ptr_base[d] >= 0) {
        const int* row = ptr + p.ptr_base[d] + idx[d];
        beg[d] = row[0];
        cnt[d] = row[1] - row[0];
        if (cnt[d] != 1) interior = false;
      }
      if (idx[d] - p.hi[d] < 0 || idx[d] - p.lo[d] >= p.n[d])
        interior = false;
    }
  }
  if (interior) {
    T acc = g[e - delta[0]] * w[0];
    for (int t = 1; t < p.taps; ++t) acc = acc + g[e - delta[t]] * w[t];
    out[e] = acc;
    return;
  }
  int c[ED_FILTER_MAXR];
  int64_t at[ED_FILTER_MAXR];
#pragma unroll
  for (int d = 0; d < ED_FILTER_MAXR; ++d) c[d] = 0;
  T acc = T(0);
  bool first = true;
  while (true) {
#pragma unroll
    for (int d = 0; d < ED_FILTER_MAXR; ++d)
      at[d] = beg[d] < 0 ? idx[d] : (int64_t)pos[beg[d] + c[d]];
    T part = T(0);
    for (int t = 0; t < p.taps; ++t) {
      int64_t a = 0;
      bool inside = true;
#pragma unroll
      for (int d = 0; d < ED_FILTER_MAXR; ++d) {
        if (d < p.rank && inside) {
          const int64_t i = at[d] - off[t * p.rank + d];
          if (i < 0 || i >= p.n[d])
            inside = false;
          else
            a += i * p.stride[d];
        }
      }
      if (inside) part = part + g[a] * w[t];
    }
    acc = first ? part : acc + part;
    first = false;
    // next position of the product, the last axis fastest
    int d = p.rank - 1;
    for (; d >= 0; --d) {
      if (++c[d] < cnt[d]) break;
      c[d] = 0;
    }
    if (d < 0) break;
  }
  out[e] = acc;
}

// K9's and K9T's tile route geometry (ops/filters.py:_nd_plan): three
// tile axes, each an axis of the kernel, a batch axis or an extent of 1,
// and the batch axes the grid walks.
struct NdTile {
  int n[3];         // extents of the tile axes
  int st[3];        // their element strides within a sample
  int lo[3], hi[3]; // least and greatest tap offset (0 on a batch axis)
  int box[3];       // the halo box: tile extent + kernel extent - 1
  int tiles[3];     // tiles along each axis
  int ptr_base[3];  // K9T: the axis' fold lists in ptr; -1 the identity
  int taps;
  int nb;                        // batch axes walked by the grid
  int bn[ED_FILTER_MAXR];        // their extents
  int64_t bst[ED_FILTER_MAXR];   // and strides
};

// The sample offset of block blockIdx.x's batch index, and its tile's first
// output (s0, s1, s2), without 64-bit division: the tile the fastest, the
// last tile axis the fastest of those, then the batch axes, the last
// fastest.
template <int C>
__device__ __forceinline__ int64_t tile_block(const NdTile& p, int* s0,
                                              int* s1, int* s2) {
  unsigned rest = blockIdx.x;
  const unsigned per = (unsigned)(p.tiles[0] * p.tiles[1] * p.tiles[2]);
  unsigned bi = rest / per;
  rest -= bi * per;
  *s2 = (int)(rest % (unsigned)p.tiles[2]) * ED_TILE_X;
  rest /= (unsigned)p.tiles[2];
  *s1 = (int)(rest % (unsigned)p.tiles[1]) * ED_TILE_Y;
  *s0 = (int)(rest / (unsigned)p.tiles[1]) * C;
  int64_t base = 0;
#pragma unroll
  for (int a = ED_FILTER_MAXR - 1; a >= 0; --a) {
    if (a < p.nb) {
      const unsigned e = bi % (unsigned)p.bn[a];
      bi /= (unsigned)p.bn[a];
      base += (int64_t)e * p.bst[a];
    }
  }
  return base;
}

// Stages the box of gs whose first element is (o0, o1, o2) in the tile
// axes' indices into shared memory, row-major (row (b0, b1) at
// (b0 * box[1] + b1) * box[2]): warp `warp` of `warps` takes rows warp,
// warp + warps, ..., its lanes consecutive elements of a row, so that the
// copies coalesce along tile axis 2. Elements outside the array are zeros.
template <typename T>
__device__ __forceinline__ void stage_box(T* box, const T* gs,
                                          const NdTile& p, int o0, int o1,
                                          int o2, int warp, int warps,
                                          int lane) {
  const int rows = p.box[0] * p.box[1];
  for (int r = warp; r < rows; r += warps) {
    const int b0 = r / p.box[1];
    const int i0 = o0 + b0, i1 = o1 + r - b0 * p.box[1];
    const bool row_in = (unsigned)i0 < (unsigned)p.n[0] &&
                        (unsigned)i1 < (unsigned)p.n[1];
    const T* src = gs + (row_in ? i0 * p.st[0] + i1 * p.st[1] : 0);
    T* dst = box + r * p.box[2];
    for (int b2 = lane; b2 < p.box[2]; b2 += 32) {
      const int i2 = o2 + b2;
      const bool in = row_in && (unsigned)i2 < (unsigned)p.n[2];
      stage_async_zfill(dst + b2, in ? src + i2 * p.st[2] : gs, in);
    }
  }
}

// K9's box: as stage_box, each element the array element it stands for
// folded by the filter mode on every axis, as the nd route reads it, or
// cval in constant mode where one axis falls outside (the thread then
// stores cval itself). (One stager for both, K9T's in constant mode with
// cval 0, made K9T 13% slower at c14 on an H100: stage_box's zero fill is
// part of the copy.)
template <typename T>
__device__ __forceinline__ void stage_box_folded(T* box, const T* xs,
                                                 const NdTile& p, int o0,
                                                 int o1, int o2, int mode,
                                                 T cval, int warp, int warps,
                                                 int lane) {
  const int rows = p.box[0] * p.box[1];
  for (int r = warp; r < rows; r += warps) {
    const int b0 = r / p.box[1];
    const int64_t f0 = fold(o0 + b0, p.n[0], mode);
    const int64_t f1 = fold(o1 + r - b0 * p.box[1], p.n[1], mode);
    const bool row_in = f0 >= 0 && f1 >= 0;
    const T* src = xs + (row_in ? (int)f0 * p.st[0] + (int)f1 * p.st[1] : 0);
    T* dst = box + r * p.box[2];
    for (int b2 = lane; b2 < p.box[2]; b2 += 32) {
      const int64_t f2 = fold(o2 + b2, p.n[2], mode);
      if (row_in && f2 >= 0)
        stage_async(dst + b2, src + (int)f2 * p.st[2]);
      else
        dst[b2] = cval;
    }
  }
}

// The tap loop for a register column of C outputs, output c's box element
// at col + c * P0 + toff[t] for tap t: acc = v_0 w_0, then acc + v_t w_t,
// the taps in raster order (K9T's and K9's).
template <typename T, int C>
__device__ __forceinline__ void tap_column(T (&acc)[C], const T* col, int P0,
                                           const T* tw, const int* toff,
                                           int taps) {
  {
    const T* v = col + toff[0];
    const T w0 = tw[0];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = v[c * P0] * w0;
  }
  for (int t = 1; t < taps; ++t) {
    const T* v = col + toff[t];
    const T wt = tw[t];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = acc[c] + v[c * P0] * wt;
  }
}

// acc holds P(j), from the box. Adds P(q) for every other entry of the
// product of j's per-axis fold lists (j itself is the first), the last axis
// fastest, each P(q) = sum over the taps landing inside the array of
// w_t g[q - off_t] from device memory: the nd route's code and order.
template <typename T>
__device__ __forceinline__ T fold_rest(T acc, int j0, int j1, int j2,
                                       const NdTile& p, const T* gs,
                                       const T* tw, const int* off,
                                       const int* ptr, const int* pos) {
  int b0 = -1, b1 = -1, b2 = -1, n0 = 1, n1 = 1, n2 = 1;
  if (p.ptr_base[0] >= 0) {
    b0 = ptr[p.ptr_base[0] + j0];
    n0 = ptr[p.ptr_base[0] + j0 + 1] - b0;
  }
  if (p.ptr_base[1] >= 0) {
    b1 = ptr[p.ptr_base[1] + j1];
    n1 = ptr[p.ptr_base[1] + j1 + 1] - b1;
  }
  if (p.ptr_base[2] >= 0) {
    b2 = ptr[p.ptr_base[2] + j2];
    n2 = ptr[p.ptr_base[2] + j2 + 1] - b2;
  }
  if (n0 * n1 * n2 == 1) return acc;
  for (int c0 = 0; c0 < n0; ++c0) {
    const int q0 = b0 < 0 ? j0 : pos[b0 + c0];
    for (int c1 = 0; c1 < n1; ++c1) {
      const int q1 = b1 < 0 ? j1 : pos[b1 + c1];
      for (int c2 = c0 == 0 && c1 == 0 ? 1 : 0; c2 < n2; ++c2) {
        const int q2 = b2 < 0 ? j2 : pos[b2 + c2];
        T part = T(0);
        for (int t = 0; t < p.taps; ++t) {
          const int i0 = q0 - off[3 * t], i1 = q1 - off[3 * t + 1],
                    i2 = q2 - off[3 * t + 2];
          if ((unsigned)i0 < (unsigned)p.n[0] &&
              (unsigned)i1 < (unsigned)p.n[1] &&
              (unsigned)i2 < (unsigned)p.n[2])
            part = part + gs[i0 * p.st[0] + i1 * p.st[1] + i2 * p.st[2]] *
                              tw[t];
        }
        acc = acc + part;
      }
    }
  }
  return acc;
}

// K9T, tile route: block (batch, tile) stages its halo box and the taps,
// then thread (y, x) computes outputs (c, y, x) of the tile, c < C. off
// holds each tap's offset along the three tile axes (0 on a batch axis).
// FOLD: some axis has fold lists (not constant mode). At most 4 blocks'
// worth of registers per SM are asked for (64 registers a thread).
template <typename T, int C, bool FOLD>
__global__ void __launch_bounds__(ED_TILE_Y * ED_TILE_X, 4)
correlate_nd_transpose_tile_kernel(const T* __restrict__ g,
                                   T* __restrict__ out,
                                   const T* __restrict__ w,
                                   const int* __restrict__ off,
                                   const int* __restrict__ ptr,
                                   const int* __restrict__ pos,
                                   const NdTile p) {
  extern __shared__ __align__(16) unsigned char ed_smem[];
  T* box = reinterpret_cast<T*>(ed_smem);
  const int P1 = p.box[2], P0 = p.box[1] * p.box[2];
  T* tw = box + p.box[0] * P0;
  int* toff = reinterpret_cast<int*>(tw + p.taps);
  int s0, s1, s2;
  const int64_t base = tile_block<C>(p, &s0, &s1, &s2);
  const T* gs = g + base;
  const int tid = threadIdx.y * ED_TILE_X + threadIdx.x;
  // output j reads g[j - off_t]: the box starts hi before the tile
  stage_box(box, gs, p, s0 - p.hi[0], s1 - p.hi[1], s2 - p.hi[2],
            (int)threadIdx.y, ED_TILE_Y, (int)threadIdx.x);
  for (int t = tid; t < p.taps; t += ED_TILE_Y * ED_TILE_X) {
    tw[t] = w[t];
    toff[t] = (p.hi[0] - off[3 * t]) * P0 + (p.hi[1] - off[3 * t + 1]) * P1 +
              (p.hi[2] - off[3 * t + 2]);
  }
  stage_wait();
  __syncthreads();
  T acc[C];
  tap_column<T, C>(acc, box + threadIdx.y * P1 + threadIdx.x, P0, tw, toff,
                   p.taps);
  const int j1 = s1 + threadIdx.y, j2 = s2 + threadIdx.x;
  if (j1 >= p.n[1] || j2 >= p.n[2]) return;
  T* os = out + base + j1 * p.st[1] + j2 * p.st[2];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j0 = s0 + c;
    if (j0 < p.n[0]) {
      T v = acc[c];
      if constexpr (FOLD)
        v = fold_rest(v, j0, j1, j2, p, gs, tw, off, ptr, pos);
      os[j0 * p.st[0]] = v;
    }
  }
}

// K9, tile route: block (batch, tile) stages its halo box of x, folded by
// the mode or cval (stage_box_folded), and the nonzero taps, then thread
// (y, x) sums outputs (c, y, x) of the tile, c < C, from shared memory in
// the nd route's raster order (tap_column). off holds each tap's offset
// along the three tile axes (0 on a batch axis). At most 4 blocks' worth of
// registers per SM are asked for (64 registers a thread), as K9T's.
template <typename T, int C>
__global__ void __launch_bounds__(ED_TILE_Y * ED_TILE_X, 4)
correlate_nd_tile_kernel(const T* __restrict__ x, T* __restrict__ out,
                         const T* __restrict__ w, const int* __restrict__ off,
                         const NdTile p, const int mode, const T cval) {
  extern __shared__ __align__(16) unsigned char ed_smem[];
  T* box = reinterpret_cast<T*>(ed_smem);
  const int P1 = p.box[2], P0 = p.box[1] * p.box[2];
  T* tw = box + p.box[0] * P0;
  int* toff = reinterpret_cast<int*>(tw + p.taps);
  int s0, s1, s2;
  const int64_t base = tile_block<C>(p, &s0, &s1, &s2);
  const int tid = threadIdx.y * ED_TILE_X + threadIdx.x;
  // output j reads x[j + off_t]: the box starts lo (at most 0) from the tile
  stage_box_folded(box, x + base, p, s0 + p.lo[0], s1 + p.lo[1],
                   s2 + p.lo[2], mode, cval, (int)threadIdx.y, ED_TILE_Y,
                   (int)threadIdx.x);
  for (int t = tid; t < p.taps; t += ED_TILE_Y * ED_TILE_X) {
    tw[t] = w[t];
    toff[t] = (off[3 * t] - p.lo[0]) * P0 + (off[3 * t + 1] - p.lo[1]) * P1 +
              (off[3 * t + 2] - p.lo[2]);
  }
  stage_wait();
  __syncthreads();
  T acc[C];
  tap_column<T, C>(acc, box + threadIdx.y * P1 + threadIdx.x, P0, tw, toff,
                   p.taps);
  const int j1 = s1 + threadIdx.y, j2 = s2 + threadIdx.x;
  if (j1 >= p.n[1] || j2 >= p.n[2]) return;
  T* os = out + base + j1 * p.st[1] + j2 * p.st[2];
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (s0 + c < p.n[0]) os[(s0 + c) * p.st[0]] = acc[c];
}

template <typename T>
cudaError_t launch_line(const void* x, void* out, const void* w,
                        const Line& p, cudaStream_t s) {
  const int64_t total = p.outer * p.n * p.inner;
  if (total == 0) return cudaSuccess;
  const size_t smem = (size_t)(ED_ROW_TILE + p.taps - 1) * sizeof(T);
  if (p.inner == 1 && smem <= 48 * 1024) {
    const int64_t blocks =
        p.outer * ((p.n + ED_ROW_TILE - 1) / ED_ROW_TILE);
    if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
    correlate1d_rows_kernel<T><<<(unsigned)blocks, ED_ROW_TILE, smem, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<const T*>(w), p);
  } else {
    const int64_t blocks = (total + ED_THREADS - 1) / ED_THREADS;
    if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
    correlate1d_kernel<T><<<(unsigned)blocks, ED_THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<const T*>(w), p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_line_transpose(const void* g, void* out, const void* w,
                                  const int* ptr, const int* pos,
                                  const Line& p, cudaStream_t s) {
  const int64_t total = p.outer * p.n * p.inner;
  if (total == 0) return cudaSuccess;
  const int64_t blocks = (total + ED_THREADS - 1) / ED_THREADS;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  correlate1d_transpose_kernel<T><<<(unsigned)blocks, ED_THREADS, 0, s>>>(
      static_cast<const T*>(g), static_cast<T*>(out),
      static_cast<const T*>(w), ptr, pos, p);
  return cudaGetLastError();
}

// the shared memory a block may use on the H100 (227 KB)
constexpr int kSmemLimit = 232448;

template <typename T, int W>
cudaError_t launch_k8t_tile_w(const void* g, void* out, const void* w,
                              const int* table, const Line& p, const Tile& t,
                              const K8tEdges& e, int smem, unsigned blocks,
                              cudaStream_t s) {
  auto kern = correlate1d_transpose_tile_kernel<T, W>;
  if (smem > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel asks for it
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<blocks, ED_K8T_THREADS, (size_t)smem, s>>>(
      static_cast<const T*>(g), static_cast<T*>(out),
      static_cast<const T*>(w), table, p, t, e);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_k8_tile_w(const void* x, void* out, const void* w,
                             const int* table, const Line& p, const Tile& t,
                             const K8Edges& e, int smem, unsigned blocks,
                             cudaStream_t s) {
  auto kern = correlate1d_tile_kernel<T, W>;
  if (smem > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel asks for it
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<blocks, ED_K8T_THREADS, (size_t)smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const T*>(w), table, p, t, e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k8_tile(int width, const void* x, void* out,
                           const void* w, const int* table, const Line& p,
                           const Tile& t, const K8Edges& e, int smem,
                           unsigned blocks, cudaStream_t s) {
  switch (width) {
    case 32:
      return launch_k8_tile_w<T, 32>(x, out, w, table, p, t, e, smem,
                                     blocks, s);
    case 64:
      return launch_k8_tile_w<T, 64>(x, out, w, table, p, t, e, smem,
                                     blocks, s);
    case 128:
      return launch_k8_tile_w<T, 128>(x, out, w, table, p, t, e, smem,
                                      blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_k8t_tile(int width, const void* g, void* out,
                            const void* w, const int* table, const Line& p,
                            const Tile& t, const K8tEdges& e, int smem,
                            unsigned blocks, cudaStream_t s) {
  switch (width) {
    case 32:
      return launch_k8t_tile_w<T, 32>(g, out, w, table, p, t, e, smem,
                                      blocks, s);
    case 64:
      return launch_k8t_tile_w<T, 64>(g, out, w, table, p, t, e, smem,
                                      blocks, s);
    case 128:
      return launch_k8t_tile_w<T, 128>(g, out, w, table, p, t, e, smem,
                                       blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_nd(bool transpose, const void* x, void* out, const void* w,
                      const int* off, const int64_t* delta, const int* ptr,
                      const int* pos, const Nd& p, cudaStream_t s) {
  if (p.total == 0 || p.taps == 0) return cudaSuccess;
  const int64_t blocks = (p.total + ED_THREADS - 1) / ED_THREADS;
  if (blocks > INT32_MAX) return cudaErrorInvalidConfiguration;
  if (transpose)
    correlate_nd_transpose_kernel<T><<<(unsigned)blocks, ED_THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<const T*>(w), off, delta, ptr, pos, p);
  else
    correlate_nd_kernel<T><<<(unsigned)blocks, ED_THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<const T*>(w), off, delta, p);
  return cudaGetLastError();
}

template <typename T, int C, bool FOLD>
cudaError_t launch_nd_tile_c(const void* g, void* out, const void* w,
                             const int* off, const int* ptr, const int* pos,
                             const NdTile& p, int smem, unsigned blocks,
                             cudaStream_t s) {
  auto kern = correlate_nd_transpose_tile_kernel<T, C, FOLD>;
  if (smem > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel asks for it
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<blocks, dim3(ED_TILE_X, ED_TILE_Y), (size_t)smem, s>>>(
      static_cast<const T*>(g), static_cast<T*>(out),
      static_cast<const T*>(w), off, ptr, pos, p);
  return cudaGetLastError();
}

template <typename T, bool FOLD>
cudaError_t launch_nd_tile_f(int column, const void* g, void* out,
                             const void* w, const int* off, const int* ptr,
                             const int* pos, const NdTile& p, int smem,
                             unsigned blocks, cudaStream_t s) {
  switch (column) {
    case 1:
      return launch_nd_tile_c<T, 1, FOLD>(g, out, w, off, ptr, pos, p, smem,
                                          blocks, s);
    case 2:
      return launch_nd_tile_c<T, 2, FOLD>(g, out, w, off, ptr, pos, p, smem,
                                          blocks, s);
    case 4:
      return launch_nd_tile_c<T, 4, FOLD>(g, out, w, off, ptr, pos, p, smem,
                                          blocks, s);
    case 8:
      return launch_nd_tile_c<T, 8, FOLD>(g, out, w, off, ptr, pos, p, smem,
                                          blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_nd_tile(bool fold, int column, const void* g, void* out,
                           const void* w, const int* off, const int* ptr,
                           const int* pos, const NdTile& p, int smem,
                           unsigned blocks, cudaStream_t s) {
  return fold ? launch_nd_tile_f<T, true>(column, g, out, w, off, ptr, pos,
                                          p, smem, blocks, s)
              : launch_nd_tile_f<T, false>(column, g, out, w, off, ptr, pos,
                                           p, smem, blocks, s);
}

template <typename T, int C>
cudaError_t launch_k9_tile_c(const void* x, void* out, const void* w,
                             const int* off, const NdTile& p, int mode,
                             double cval, int smem, unsigned blocks,
                             cudaStream_t s) {
  auto kern = correlate_nd_tile_kernel<T, C>;
  if (smem > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel asks for it
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<blocks, dim3(ED_TILE_X, ED_TILE_Y), (size_t)smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const T*>(w), off, p, mode, T(cval));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k9_tile(int column, const void* x, void* out,
                           const void* w, const int* off, const NdTile& p,
                           int mode, double cval, int smem, unsigned blocks,
                           cudaStream_t s) {
  switch (column) {
    case 1:
      return launch_k9_tile_c<T, 1>(x, out, w, off, p, mode, cval, smem,
                                    blocks, s);
    case 2:
      return launch_k9_tile_c<T, 2>(x, out, w, off, p, mode, cval, smem,
                                    blocks, s);
    case 4:
      return launch_k9_tile_c<T, 4>(x, out, w, off, p, mode, cval, smem,
                                    blocks, s);
    case 8:
      return launch_k9_tile_c<T, 8>(x, out, w, off, p, mode, cval, smem,
                                    blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The tile geometry of K9's and K9T's tile routes from the plan's host
// arrays (ed_correlate_nd_transpose_tile); false where the plan does not
// fit the shapes: a sample past int32, more blocks than a grid takes, a box
// and the taps past smem or the card's shared memory.
bool make_nd_tile(NdTile* p, int dtype, int column, const int* n3,
                  const long long* st3, const int* k3, const int* hi3,
                  const int* ptr_base3, int nb, const long long* bn,
                  const long long* bst, int taps, int smem,
                  long long blocks) {
  const int tile[3] = {column, ED_TILE_Y, ED_TILE_X};
  const int itemsize = dtype == 0 ? 4 : dtype == 1 ? 8 : 0;
  if (itemsize == 0 || taps < 1 || nb < 0 || nb > ED_FILTER_MAXR ||
      (column != 1 && column != 2 && column != 4 && column != 8))
    return false;
  p->taps = taps;
  p->nb = nb;
  int64_t span = 0, count = 1, box = 1;
  for (int d = 0; d < 3; ++d) {
    if (n3[d] < 1 || st3[d] < 0 || k3[d] < 1 || hi3[d] < 0 ||
        hi3[d] >= k3[d])
      return false;
    p->n[d] = n3[d];
    p->st[d] = n3[d] > 1 ? (int)st3[d] : 0;  // (within int32: span below)
    p->hi[d] = hi3[d];
    p->lo[d] = hi3[d] - (k3[d] - 1);
    p->box[d] = tile[d] + k3[d] - 1;
    p->tiles[d] = (n3[d] + tile[d] - 1) / tile[d];
    p->ptr_base[d] = ptr_base3[d];
    span += (int64_t)(n3[d] - 1) * st3[d];
    count *= p->tiles[d];
    box *= p->box[d];
  }
  for (int a = 0; a < ED_FILTER_MAXR; ++a) {
    p->bn[a] = a < nb ? (int)bn[a] : 1;
    p->bst[a] = a < nb ? bst[a] : 0;
    if (a < nb && (bn[a] < 1 || bn[a] > INT32_MAX)) return false;
    count *= p->bn[a];
  }
  const int64_t need = box * itemsize + (int64_t)taps * (itemsize + 4);
  return span <= INT32_MAX && count == blocks && blocks <= INT32_MAX &&
         smem >= need && smem <= kSmemLimit;
}

Line make_line(long long outer, long long n, long long inner, int taps,
               int center, int mode, int pair, double cval) {
  Line p;
  p.outer = outer;
  p.n = n;
  p.inner = inner;
  p.taps = taps;
  p.center = center;
  p.mode = mode;
  p.pair = pair;
  p.cval = cval;
  return p;
}

}  // namespace

extern "C" {

// K8. dtype: 0 float32, 1 float64; w: taps values of x's dtype on the
// device; mode: 0 nearest, 1 wrap, 2 reflect, 3 mirror, 4 constant; pair: 0
// direct order, 1 / -1 paired (odd taps only). x and out must not overlap.
// Returns cudaGetLastError().
int ed_correlate1d(int dtype, const void* x, void* out, const void* w,
                   long long outer, long long n, long long inner, int taps,
                   int center, int mode, int pair, double cval,
                   void* stream) {
  if (taps < 1 || center < 0 || center >= taps || mode < 0 || mode > 4 ||
      (pair != 0 && (taps % 2 == 0 || pair < -1 || pair > 1)))
    return (int)cudaErrorInvalidValue;
  const Line p = make_line(outer, n, inner, taps, center, mode, pair, cval);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? launch_line<float>(x, out, w, p, s)
                    : dtype == 1 ? launch_line<double>(x, out, w, p, s)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

// K8 on the tile route, with the plan of ops/filters.py:_line_plan: the
// arguments of ed_correlate1d, then a and b (the plain run [a, b) of a
// line, empty or [center, n - (taps - 1) + center)), gather (a packed
// tile's outputs gather in a second tile), width W, packed (inner < W),
// lines of a full tile, shared row stride, the tile's own shared bytes
// (tile_smem), blocks (ops/prefilter.py:_tile_plan's geometry) and smem,
// the block's shared bytes: the tile (twice with gather), the taps in x's
// dtype and the pad table's taps - 1 int32 entries. table (device): the
// sample index each pad of the padded line [-center, n + taps-1-center)
// folds onto, or -1 for cval (ops/filters.py:_k8_edges). A plan that does
// not fit the shape is refused with cudaErrorInvalidValue. x and out must
// not overlap. Returns cudaGetLastError().
int ed_correlate1d_tile(int dtype, const void* x, void* out, const void* w,
                        const void* table, long long outer, long long n,
                        long long inner, int taps, int center, int mode,
                        int pair, double cval, int a, int b, int gather,
                        int width, int packed, int lines, int stride,
                        int tile_smem, int smem, long long blocks,
                        void* stream) {
  if (outer * n * inner == 0) return (int)cudaSuccess;
  const int itemsize = dtype == 0 ? 4 : dtype == 1 ? 8 : 0;
  Tile t;
  if (itemsize == 0 || taps < 1 || center < 0 || center >= taps ||
      mode < 0 || mode > 4 ||
      (pair != 0 && (taps % 2 == 0 || pair < -1 || pair > 1)) ||
      !(a == b ? a == 0 : a == center && b == n - (taps - 1) + center) ||
      (gather && !packed) || outer * n * inner > INT32_MAX ||
      !make_tile(&t, itemsize, outer, n, inner, width, packed, lines, stride,
                 tile_smem, blocks, kSmemLimit) ||
      (int64_t)smem != (gather ? 2 : 1) * (int64_t)tile_smem +
                           (int64_t)taps * itemsize +
                           4 * (int64_t)(taps - 1) ||
      smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const Line p = make_line(outer, n, inner, taps, center, mode, pair, cval);
  if (t.packed) {
    // the block's threads walk the packed run together
    t.dol = (int)(ED_K8T_THREADS / (n * inner));
    t.dr = (int)(ED_K8T_THREADS % (n * inner));
  }
  K8Edges e;
  e.a = a;
  e.b = b;
  e.gather = gather;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  cudaError_t err =
      dtype == 0 ? launch_k8_tile<float>(width, x, out, w, tb, p, t, e, smem,
                                         (unsigned)blocks, s)
                 : launch_k8_tile<double>(width, x, out, w, tb, p, t, e,
                                          smem, (unsigned)blocks, s);
  return (int)err;
}

// K8T, the transpose of ed_correlate1d. ptr (n + 1) and pos: the per-position
// fold lists of the padded extent (ops/filters.py fold_lists), on the device.
int ed_correlate1d_transpose(int dtype, const void* g, void* out,
                             const void* w, const void* ptr, const void* pos,
                             long long outer, long long n, long long inner,
                             int taps, int center, void* stream) {
  if (taps < 1 || center < 0 || center >= taps)
    return (int)cudaErrorInvalidValue;
  const Line p = make_line(outer, n, inner, taps, center, F_CONSTANT, 0, 0.0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(ptr);
  const int* ps = static_cast<const int*>(pos);
  cudaError_t err =
      dtype == 0   ? launch_line_transpose<float>(g, out, w, pt, ps, p, s)
      : dtype == 1 ? launch_line_transpose<double>(g, out, w, pt, ps, p, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

// K8T on the tile route, with the plan of
// ops/filters.py:_line_transpose_plan: width W threads and lines a block,
// packed (inner < W), lines of a full tile, shared row stride, the tile's
// own shared bytes (tile_smem), blocks (ops/prefilter.py:_tile_plan's
// geometry), and smem, the block's shared bytes: the tile (twice with
// gather, a packed tile whose outputs gather in a second one), the taps in
// g's dtype and the edge table's rows + 1 + npos int32 entries. w (taps) and
// table (device, int32): the plain range [a, b) and the fold lists of the
// other rows (ops/filters.py:_k8t_edges). A plan that does not fit the
// shape is refused with cudaErrorInvalidValue. g and out must not overlap.
// Returns cudaGetLastError().
int ed_correlate1d_transpose_tile(
    int dtype, const void* g, void* out, const void* w, const void* table,
    long long outer, long long n, long long inner, int taps, int center,
    int a, int b, int rows, int npos, int gather, int width, int packed,
    int lines, int stride, int tile_smem, int smem, long long blocks,
    void* stream) {
  if (outer * n * inner == 0) return (int)cudaSuccess;
  const int itemsize = dtype == 0 ? 4 : dtype == 1 ? 8 : 0;
  Tile t;
  if (itemsize == 0 || taps < 1 || center < 0 || center >= taps || a < 0 ||
      a > b || b > n || rows != n - (b - a) || npos < rows ||
      (gather && !packed) ||
      outer * n * inner > INT32_MAX ||
      !make_tile(&t, itemsize, outer, n, inner, width, packed, lines, stride,
                 tile_smem, blocks, kSmemLimit) ||
      (int64_t)smem != (gather ? 2 : 1) * (int64_t)tile_smem +
                           (int64_t)taps * itemsize +
                           4 * ((int64_t)rows + 1 + npos) ||
      smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const Line p = make_line(outer, n, inner, taps, center, F_CONSTANT, 0, 0.0);
  if (t.packed) {
    // the block's threads walk the packed run together
    t.dol = (int)(ED_K8T_THREADS / (n * inner));
    t.dr = (int)(ED_K8T_THREADS % (n * inner));
  }
  K8tEdges e;
  e.a = a;
  e.b = b;
  e.rows = rows;
  e.npos = npos;
  e.gather = gather;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  cudaError_t err =
      dtype == 0 ? launch_k8t_tile<float>(width, g, out, w, tb, p, t, e, smem,
                                          (unsigned)blocks, s)
                 : launch_k8t_tile<double>(width, g, out, w, tb, p, t, e,
                                           smem, (unsigned)blocks, s);
  return (int)err;
}

// K9 (transpose = 0) and K9T (transpose = 1) on a contiguous tensor of rank
// <= ED_FILTER_MAXR with shape[rank] (host). Device arrays: w[taps], off[taps
// * rank], delta[taps]; for K9T the fold lists ptr / pos, axis d's rows from
// ptr_base[d] (host; -1: the identity list). lo / hi (host): the least and
// greatest offset per axis. Returns cudaGetLastError().
int ed_correlate_nd(int dtype, int transpose, const void* x, void* out,
                    const void* w, const void* off, const void* delta,
                    const void* ptr, const void* pos, int rank,
                    const long long* shape, const int* lo, const int* hi,
                    const int* ptr_base, int taps, int mode, double cval,
                    void* stream) {
  if (rank < 1 || rank > ED_FILTER_MAXR || taps < 0 || mode < 0 || mode > 4)
    return (int)cudaErrorInvalidValue;
  Nd p;
  p.rank = rank;
  p.taps = taps;
  p.mode = mode;
  p.cval = cval;
  p.total = 1;
  for (int d = ED_FILTER_MAXR - 1; d >= 0; --d) {
    const bool used = d < rank;
    p.n[d] = used ? shape[d] : 1;
    p.stride[d] = p.total;
    p.total *= p.n[d];
    p.lo[d] = used ? lo[d] : 0;
    p.hi[d] = used ? hi[d] : 0;
    p.ptr_base[d] = used ? ptr_base[d] : -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* of = static_cast<const int*>(off);
  const int64_t* de = static_cast<const int64_t*>(delta);
  const int* pt = static_cast<const int*>(ptr);
  const int* ps = static_cast<const int*>(pos);
  cudaError_t err =
      dtype == 0
          ? launch_nd<float>(transpose != 0, x, out, w, of, de, pt, ps, p, s)
      : dtype == 1
          ? launch_nd<double>(transpose != 0, x, out, w, of, de, pt, ps, p, s)
          : cudaErrorInvalidValue;
  return (int)err;
}

// K9T on the tile route, with the plan of ops/filters.py:_nd_plan.
// Host arrays: per tile axis (3) its extent n3, element stride st3, kernel
// extent k3, greatest tap offset hi3 and fold-list base ptr_base3 (-1 the
// identity); the nb batch axes the grid walks, extents bn and strides bst.
// Device arrays: w[taps], off[taps * 3] (each tap's offset along the tile
// axes), the fold lists ptr / pos. column: C, the outputs a thread keeps
// along tile axis 0 (1, 2, 4 or 8); smem: the plan's shared bytes, at least
// the box and the taps; blocks: the tiles times the batch. A plan that does
// not fit the shapes (a sample past int32, more blocks than a grid takes, a
// box past smem) is refused with cudaErrorInvalidValue. g and out must not
// overlap. Returns cudaGetLastError().
int ed_correlate_nd_transpose_tile(
    int dtype, const void* g, void* out, const void* w, const void* off,
    const void* ptr, const void* pos, const int* n3, const long long* st3,
    const int* k3, const int* hi3, const int* ptr_base3, int nb,
    const long long* bn, const long long* bst, int taps, int column,
    int smem, long long blocks, void* stream) {
  NdTile p;
  if (!make_nd_tile(&p, dtype, column, n3, st3, k3, hi3, ptr_base3, nb, bn,
                    bst, taps, smem, blocks))
    return (int)cudaErrorInvalidValue;
  const bool fold =
      ptr_base3[0] >= 0 || ptr_base3[1] >= 0 || ptr_base3[2] >= 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* of = static_cast<const int*>(off);
  const int* pt = static_cast<const int*>(ptr);
  const int* ps = static_cast<const int*>(pos);
  cudaError_t err =
      dtype == 0 ? launch_nd_tile<float>(fold, column, g, out, w, of, pt, ps,
                                         p, smem, (unsigned)blocks, s)
                 : launch_nd_tile<double>(fold, column, g, out, w, of, pt, ps,
                                          p, smem, (unsigned)blocks, s);
  return (int)err;
}

// K9 on the tile route, with the plan of ops/filters.py:_nd_plan: the
// host and device arrays of ed_correlate_nd_transpose_tile less the fold
// lists (off: each tap's offset along the tile axes, from the output to the
// element it reads; hi3: the greatest per tile axis), the mode (0-4, as
// ed_correlate_nd) and cval. A plan that does not fit the shapes is
// refused with cudaErrorInvalidValue. x and out must not overlap. Returns
// cudaGetLastError().
int ed_correlate_nd_tile(int dtype, const void* x, void* out, const void* w,
                         const void* off, const int* n3, const long long* st3,
                         const int* k3, const int* hi3, int nb,
                         const long long* bn, const long long* bst, int taps,
                         int mode, double cval, int column, int smem,
                         long long blocks, void* stream) {
  const int identity[3] = {-1, -1, -1};
  NdTile p;
  if (mode < 0 || mode > 4 ||
      !make_nd_tile(&p, dtype, column, n3, st3, k3, hi3, identity, nb, bn,
                    bst, taps, smem, blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* of = static_cast<const int*>(off);
  cudaError_t err =
      dtype == 0 ? launch_k9_tile<float>(column, x, out, w, of, p, mode, cval,
                                         smem, (unsigned)blocks, s)
                 : launch_k9_tile<double>(column, x, out, w, of, p, mode,
                                          cval, smem, (unsigned)blocks, s);
  return (int)err;
}

const char* ed_filters_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
