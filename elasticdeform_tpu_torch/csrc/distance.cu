// K14 nearest_background, K15 minplus_pass, K16 chamfer_sweep and K17
// watershed_sweep: the distance transforms (SciPy's distance_transform_edt,
// _cdt and _bf) and the watershed by image foresting transform.
//
// K14 replaces the JAX package's elasticdeform_tpu/ops/distance.py:98
// _nearest_bg_last and the first pass of edt_core (:259-270): along axis 0
// of a bool mask, each voxel's index distance d to the nearest background
// (false) voxel of its line, the left one on a tie, d = 2n and j = 0 on a
// line with no background; f = (s0 d)^2, or the sentinel big (float32 max /
// 16) there. With indices it writes the (ndim, *shape) int32 feature
// array: plane 0 the nearest background's index j, plane k > 0 the voxel's
// own coordinate along axis k. A block takes up to 32 neighbouring lines
// and cuts each into 256 / lines segments, one thread a (line, segment),
// neighbouring threads on neighbouring lines, so every load and store
// coalesces. A thread walks its segment for its first and last background;
// the block exchanges them in shared memory, which gives each segment the
// nearest background before and after it; a second walk writes f and the
// planes, finding the next background by reading ahead from the one it
// passes (each mask byte read at most twice, f written once). The line's
// own coordinates (planes 1..) come from its index, once a thread.
//
// K15 replaces distance.py:120-234, _minplus_pass along an axis >= 1 of the
// contiguous (outer, n, inner) view: out(i) = min_j g(j) + cost(|i - j|),
// the feature planes gathered at the argmin. The ladder's rungs collapse:
// where a band of 16 certifies (every out <= (16 s)^2), every candidate
// beyond it costs at least (17 s)^2 and the band of 64 gives the same
// values and argmins, so a pass is the band of the ladder's last width W <
// n - 1, kept where it certifies, else the dense tier. The band
// (_banded_last) visits its own value, then j = i - 1, i + 1, i - 2, i + 2,
// ... with a strict <, so a tie goes to the nearest j, the lower j first; j
// beyond the line reads big; the host's table holds (s o)^2 in that order,
// and the kernel sets *fail where !(out <= (s W)^2). The dense tier
// (_matrix_last) takes the lowest j of the least cost; it visits j in
// order of |i - j| (i - k before i + k) and keeps the least (cost, j), the
// host's table holding s^2 k^2. Both stop early without changing a bit, for
// g >= 0 (squared distances or big): the band at the first constant >= its
// best (every later candidate costs at least its constant), the dense tier
// at the first s^2 k^2 > its best. A block stages its lines' values and
// feature planes once in shared memory, four loads in flight a thread (tile
// route): for a strided axis a tile of adjacent inner positions x the line
// (rows of 64 bytes of values, 32 of each plane), or whole (n, inner) slabs
// where inner is narrow, the innermost axis's lines among them; the planes
// are gathered from the staging and every store coalesces. Lines past the
// staging's ED_MINPLUS_SMEM bytes take the lines route, one thread an
// output voxel reading device memory. The dense kernel reads the band's flag on the
// device and returns at once where it is clear, so a pass (zero the flag,
// the band, the dense kernel) is one host call with no flag read; the
// dense tier then overwrites the band's outputs. Input and output never
// alias (ping-pong).
//
// K16 replaces distance.py:343-379, a Jacobi sweep of cdt_core: d <- min(d,
// d(u) + 1) over the structure's neighbours u in raster order (the centre
// dropped), a strict <, carrying the winner's raveled index; K17 replaces
// morphology.py:571-596, a Jacobi sweep of watershed_ift: a labelled
// neighbour u offers (max(c(u), x), s(u) + 1, l(u)), and the
// lexicographically smallest triple wins, strictly. Both read only the
// previous sweep's state and write a second buffer, so the fixpoint and the
// indices are those of the reference's sweeps; a neighbour beyond the edge
// takes no part (the reference's pad never wins). *changed is set when a
// voxel of the sweep changed; the host zeroes it before the 8th sweep of a
// group and reads it after (the schedule of K13's driver). One thread a
// voxel in raster order; per voxel a bit mask of the axes where it sits on
// the low and the high edge; a tap is a linear offset and the masks of the
// axes it steps down and up along, so it is skipped where it would leave
// the array. No shared memory: the neighbours' reuse is served by L1 and
// L2. The entry points launch a group of sweeps (the driver's eight,
// ops/morphology.py::relax_to_fixpoint) from one host call, ping-ponging
// between two buffer sets, so the host's time a sweep is one kernel launch
// and not a Python call, and the card runs the group back to back.
//
// Bound on the H100, each input read once and each output written once
// over 3.35 TB/s: K14 the mask and f (and the feature planes); K15 g, the
// feature planes in and out and f out, per pass. A launch of K16 or K17
// reads the state (K16 d and ix, 8 bytes a voxel; K17 the image and the
// triples, 13) and writes it (8; 12): at c19 0.0164 and 0.0154 ms. A
// call's bound is its input and result alone (the mask, d and ix; the
// image, markers and labels), 0.0092 and 0.0055 ms, while a call runs 48
// and 192 sweeps (about one per voxel of the longest path), so the sweeps
// stand far above it. Every kernel copies values or adds and
// compares in the order of its plain twin, built without contraction
// (--fmad=false), so it agrees with ops/distance.py and
// ops/morphology.py's twins bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define ED_DIST_MAXD 8
#define ED_DIST_THREADS 256
#define ED_DIST_BLOCKS 4096
// K14: a block's lines at most (a warp's width)
#define ED_K14_LINES 32
// K15's tile route: the bytes a block stages at most (values and feature
// planes), within the default dynamic shared memory
// (ops/distance.py::MINPLUS_SMEM)
#define ED_MINPLUS_SMEM 49152

namespace {

// the extents of an array of up to ED_DIST_MAXD axes (fewer than 2^31
// elements: the feature indices are int32)
struct Dims {
  int ndim;
  unsigned n[ED_DIST_MAXD];
};

// one block's vote: *flag |= any thread's local flag
__device__ __forceinline__ void block_flag(int* flag, bool local) {
  if (__syncthreads_or(local) && threadIdx.x == 0) atomicOr(flag, 1);
}

unsigned grid_for(long long n) {
  long long b = (n + ED_DIST_THREADS - 1) / ED_DIST_THREADS;
  return (unsigned)(b < ED_DIST_BLOCKS ? (b > 0 ? b : 1) : ED_DIST_BLOCKS);
}

// ---------------------------------------------------------------------------
// K14

__global__ void __launch_bounds__(ED_DIST_THREADS)
nearest_bg_kernel(const uint8_t* __restrict__ fg, double* __restrict__ f,
                  int* __restrict__ ix, Dims dm, unsigned lines, int bl,
                  double s0, double big) {
  __shared__ int first_bg[ED_DIST_THREADS];
  __shared__ int last_bg[ED_DIST_THREADS];
  const int n = (int)dm.n[0];
  const int nseg = ED_DIST_THREADS / bl;
  const int lx = (int)threadIdx.x % bl, sg = (int)threadIdx.x / bl;
  const unsigned m = blockIdx.x * (unsigned)bl + (unsigned)lx;
  const bool live = m < lines;
  const int seg = (n + nseg - 1) / nseg;
  const int a = sg * seg < n ? sg * seg : n;
  const int b = a + seg < n ? a + seg : n;
  // walk 1: the segment's first and last background (n and -1: none)
  int fb = n, lb = -1;
  if (live)
    for (int i = a; i < b; ++i)
      if (!fg[(size_t)i * lines + m]) {
        if (fb == n) fb = i;
        lb = i;
      }
  first_bg[threadIdx.x] = fb;
  last_bg[threadIdx.x] = lb;
  __syncthreads();
  if (!live) return;
  // l: the nearest background at or before i (-1: none); after: the first
  // one after the segment and nxt at or after i (n: none)
  int l = -1, after = n;
  for (int k = 0; k < sg; ++k) l = max(l, last_bg[k * bl + lx]);
  for (int k = sg + 1; k < nseg; ++k) after = min(after, first_bg[k * bl + lx]);
  int nxt = fb < n ? fb : after;
  // the line's own coordinates along axes 1..ndim-1 (planes 1..)
  int coord[ED_DIST_MAXD];
  unsigned rem = m;
#pragma unroll
  for (int k = ED_DIST_MAXD - 1; k >= 1; --k) {
    coord[k] = 0;
    if (k < dm.ndim) {
      coord[k] = (int)(rem % dm.n[k]);
      rem /= dm.n[k];
    }
  }
  const size_t N = (size_t)n * lines;
  const int sent = 2 * n;
  for (int i = a; i < b; ++i) {
    const size_t v = (size_t)i * lines + m;
    if (i == nxt) {
      l = i;
      if (i == lb) {
        nxt = after;
      } else {
        // a background lies in (i, lb]
        do ++nxt;
        while (fg[(size_t)nxt * lines + m]);
      }
    }
    const int dl = l >= 0 ? i - l : sent;
    const int dr = nxt < n ? nxt - i : sent;
    const bool take_l = dl <= dr;
    const int d = take_l ? dl : dr;
    int j = take_l ? l : nxt;
    j = j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
    const double t = s0 * (double)d;
    f[v] = d < sent ? t * t : big;
    if (ix) {
      ix[v] = j;
#pragma unroll
      for (int k = 1; k < ED_DIST_MAXD; ++k)
        if (k < dm.ndim) ix[(size_t)k * N + v] = coord[k];
    }
  }
}

// ---------------------------------------------------------------------------
// K15

// the band's scan of a voxel at index i of a line of n: p[0] its value,
// p[o * step] its neighbour at offset o; best and bj the least cost and its
// index, as _banded_last's strict < in the visiting order, a pair of
// offsets -k, k at a time, each pair's one constant table[2k - 2] (the
// host holds table[2k - 1], k's, equal to it bit for bit); it stops at the
// first constant >= best (g >= 0: no later candidate can win or tie, so a
// pair scanned past that point changes nothing). Where both sides lie in
// the line (k <= min(i, n - 1 - i)) it takes two pairs a step, the exit
// checked once a step; then one pair a step, big beyond the line.
__device__ __forceinline__ void band_pair(const double* p, long long step,
                                          int k, double c0, double& best,
                                          int& bj, int i) {
  const double cl = p[-(long long)k * step] + c0;
  if (cl < best) {
    best = cl;
    bj = i - k;
  }
  const double cr = p[(long long)k * step] + c0;
  if (cr < best) {
    best = cr;
    bj = i + k;
  }
}

__device__ __forceinline__ void band_scan(const double* p, long long step,
                                          int i, int n,
                                          const double* __restrict__ table,
                                          int W, double big, double& best,
                                          int& bj) {
  best = p[0];
  bj = i;
  const int kin = min(W, min(i, n - 1 - i));
  int k = 1;
  for (; k < kin; k += 2) {
    const double c0 = __ldg(table + 2 * k - 2), c1 = __ldg(table + 2 * k);
    if (c0 >= best) return;
    band_pair(p, step, k, c0, best, bj, i);
    band_pair(p, step, k + 1, c1, best, bj, i);
  }
  for (; k <= W; ++k) {
    const double c0 = __ldg(table + 2 * k - 2);
    if (c0 >= best) return;
    const double cl = (i - k >= 0 ? p[-(long long)k * step] : big) + c0;
    if (cl < best) {
      best = cl;
      bj = i - k < 0 ? 0 : i - k;
    }
    const double cr = (i + k < n ? p[(long long)k * step] : big) + c0;
    if (cr < best) {
      best = cr;
      bj = i + k > n - 1 ? n - 1 : i + k;
    }
  }
}

// the dense tier's scan: the least (cost, j) over the line, j visited in
// order of k = |i - j|, i - k before i + k (so i - k takes a tie, i + k
// only a strictly smaller cost); it stops at the first s^2 k^2 > best (a
// pair scanned past that point cannot win or tie). Two pairs a step, the
// exit checked once a step, where both sides lie in the line; then one.
__device__ __forceinline__ void dense_pair(const double* p, long long step,
                                           int k, double c0, double& best,
                                           int& bj, int i) {
  const double cl = p[-(long long)k * step] + c0;
  if (cl <= best) {
    best = cl;
    bj = i - k;
  }
  const double cr = p[(long long)k * step] + c0;
  if (cr < best) {
    best = cr;
    bj = i + k;
  }
}

__device__ __forceinline__ void dense_scan(const double* p, long long step,
                                           int i, int n,
                                           const double* __restrict__ table,
                                           double& best, int& bj) {
  best = p[0] + __ldg(table);
  bj = i;
  const int kin = min(i, n - 1 - i);
  int k = 1;
  for (; k < kin; k += 2) {
    const double c0 = __ldg(table + k), c1 = __ldg(table + k + 1);
    if (c0 > best) return;
    dense_pair(p, step, k, c0, best, bj, i);
    dense_pair(p, step, k + 1, c1, best, bj, i);
  }
  for (; k < n; ++k) {
    const double c0 = __ldg(table + k);
    if (c0 > best) return;
    if (i - k >= 0) {
      const double c = p[-(long long)k * step] + c0;
      if (c <= best) {
        best = c;
        bj = i - k;
      }
    }
    if (i + k < n) {
      const double c = p[(long long)k * step] + c0;
      if (c < best) {
        best = c;
        bj = i + k;
      }
    }
  }
}

// the feature planes of voxel v gathered at the argmin bj (v at index i)
__device__ __forceinline__ void gather_planes(const int* __restrict__ ix,
                                              int* __restrict__ ix_out,
                                              int nidx, unsigned total,
                                              size_t v, int i, int bj,
                                              unsigned inner) {
  const long long from = (long long)v + (long long)(bj - i) * inner;
  for (int p = 0; p < nidx; ++p)
    ix_out[(size_t)p * total + v] = __ldg(ix + (size_t)p * total + from);
}

// a tile-route block's tile: L outer slices x n x w inner positions (L > 1
// only where w = inner, whole contiguous slabs); the grid walks wtiles
// tiles across inner, then the outer slices
struct Tile {
  unsigned w, L, wtiles, outer;
};

// element e of a tile of L slabs of n x w: its offset in the (outer, n,
// inner) array from the tile's first element
__device__ __forceinline__ size_t tile_offset(unsigned e, unsigned slab,
                                              unsigned w, int n,
                                              unsigned inner) {
  const unsigned l = e / slab, r = e - l * slab, i = r / w;
  return ((size_t)l * n + i) * inner + (r - i * w);
}

// stage a tile of src (elems elements) into dst, four loads in flight a
// thread
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src,
                                           unsigned elems, unsigned slab,
                                           unsigned w, int n,
                                           unsigned inner) {
  const unsigned B = blockDim.x;
  unsigned e = threadIdx.x;
  for (; e + 3 * B < elems; e += 4 * B) {
    T v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = __ldg(src + tile_offset(e + u * B, slab, w, n, inner));
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[e + u * B] = v[u];
  }
  for (; e < elems; e += B)
    dst[e] = __ldg(src + tile_offset(e, slab, w, n, inner));
}

// K15 on the tile route: one tile a block, its values and its feature
// planes staged once (8 + 4 nidx bytes an element), the argmin's planes
// gathered from the staging. The band (DENSE false) sets *fail where a
// voxel is not certified; the dense kernel returns at once where pred is
// not null and *pred is 0.
template <bool DENSE>
__global__ void __launch_bounds__(ED_DIST_THREADS)
minplus_tile_kernel(const double* __restrict__ g, double* __restrict__ out,
                    const int* __restrict__ ix, int* __restrict__ ix_out,
                    int nidx, unsigned total, int n, unsigned inner, Tile tl,
                    const double* __restrict__ table, int W, double thr,
                    double big, int* __restrict__ fail,
                    const int* __restrict__ pred) {
  if (DENSE && pred && !*pred) return;
  extern __shared__ double ed_lines[];
  const unsigned ot = blockIdx.x / tl.wtiles, pt = blockIdx.x % tl.wtiles;
  const unsigned o0 = ot * tl.L, p0 = pt * tl.w;
  const unsigned L = min(tl.L, tl.outer - o0), w = min(tl.w, inner - p0);
  const unsigned slab = (unsigned)n * w;
  const unsigned elems = L * slab;
  const size_t base = (size_t)o0 * n * inner + p0;
  int* planes = reinterpret_cast<int*>(ed_lines + elems);
  stage_tile(ed_lines, g + base, elems, slab, w, n, inner);
  for (int p = 0; p < nidx; ++p)
    stage_tile(planes + (size_t)p * elems, ix + (size_t)p * total + base,
               elems, slab, w, n, inner);
  __syncthreads();
  bool bad = false;
  for (unsigned e = threadIdx.x; e < elems; e += blockDim.x) {
    const unsigned l = e / slab, r = e - l * slab, i = r / w;
    const size_t v = base + ((size_t)l * n + i) * inner + (r - i * w);
    double best;
    int bj;
    if (DENSE) {
      dense_scan(ed_lines + e, w, (int)i, n, table, best, bj);
    } else {
      band_scan(ed_lines + e, w, (int)i, n, table, W, big, best, bj);
      if (!(best <= thr)) bad = true;
    }
    out[v] = best;
    const unsigned from = e + (unsigned)((bj - (int)i) * (int)w);
    for (int p = 0; p < nidx; ++p)
      ix_out[(size_t)p * total + v] = planes[(size_t)p * elems + from];
  }
  if (!DENSE) block_flag(fail, bad);
}

// K15 on the lines route: one thread an output voxel, its line read from
// device memory; flags as minplus_tile_kernel's
template <bool DENSE>
__global__ void __launch_bounds__(ED_DIST_THREADS)
minplus_lines_kernel(const double* __restrict__ g, double* __restrict__ out,
                     const int* __restrict__ ix, int* __restrict__ ix_out,
                     int nidx, unsigned total, int n, unsigned inner,
                     const double* __restrict__ table, int W, double thr,
                     double big, int* __restrict__ fail,
                     const int* __restrict__ pred) {
  if (DENSE && pred && !*pred) return;
  bool bad = false;
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x) {
    const int i = (int)((v / inner) % (unsigned)n);
    double best;
    int bj;
    if (DENSE) {
      dense_scan(g + v, inner, i, n, table, best, bj);
    } else {
      band_scan(g + v, inner, i, n, table, W, big, best, bj);
      if (!(best <= thr)) bad = true;
    }
    out[v] = best;
    gather_planes(ix, ix_out, nidx, total, v, i, bj, inner);
  }
  if (!DENSE) block_flag(fail, bad);
}

// ---------------------------------------------------------------------------
// K16 and K17

// the axes where voxel v sits on the low edge (bits 0-7) and on the high
// edge (bits 8-15); a tap's word holds the axes it steps down along (bits
// 0-7) and up along (bits 8-15), so it leaves the array where the two meet
__device__ __forceinline__ unsigned edge_bits(unsigned v, const Dims& dm) {
  unsigned lo = 0, hi = 0, rem = v;
#pragma unroll
  for (int k = ED_DIST_MAXD - 1; k >= 0; --k) {
    if (k < dm.ndim) {
      const unsigned c = rem % dm.n[k];
      rem /= dm.n[k];
      lo |= (unsigned)(c == 0) << k;
      hi |= (unsigned)(c == dm.n[k] - 1) << k;
    }
  }
  return lo | (hi << 8);
}

__global__ void __launch_bounds__(ED_DIST_THREADS)
chamfer_sweep_kernel(const int* __restrict__ d, const int* __restrict__ ix,
                     int* __restrict__ d_out, int* __restrict__ ix_out,
                     const int2* __restrict__ taps, int ntaps, Dims dm,
                     unsigned total, int* __restrict__ changed) {
  bool any = false;
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x) {
    const unsigned edges = edge_bits(v, dm);
    const int d0 = d[v];
    int best = d0;
    int bix = ix ? ix[v] : 0;
    for (int t = 0; t < ntaps; ++t) {
      const int2 tp = __ldg(taps + t);
      if ((unsigned)tp.y & edges) continue;
      const unsigned u = v + tp.x;
      const int c = d[u] + 1;
      if (c < best) {
        best = c;
        if (ix) bix = ix[u];
      }
    }
    d_out[v] = best;
    if (ix) ix_out[v] = bix;
    any |= best != d0;
  }
  if (changed) block_flag(changed, any);
}

template <typename X>
__global__ void __launch_bounds__(ED_DIST_THREADS)
watershed_sweep_kernel(const X* __restrict__ img, const int* __restrict__ c,
                       const int* __restrict__ s, const int* __restrict__ l,
                       int* __restrict__ c_out, int* __restrict__ s_out,
                       int* __restrict__ l_out, const int2* __restrict__ taps,
                       int ntaps, Dims dm, unsigned total,
                       int* __restrict__ changed) {
  bool any = false;
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += gridDim.x * blockDim.x) {
    const unsigned edges = edge_bits(v, dm);
    const int x = (int)img[v];
    const int c0 = c[v], s0 = s[v], l0 = l[v];
    int nc = c0, ns = s0, nl = l0;
    for (int t = 0; t < ntaps; ++t) {
      const int2 tp = __ldg(taps + t);
      if ((unsigned)tp.y & edges) continue;
      const unsigned u = v + tp.x;
      const int cl = l[u];
      if (cl == 0) continue;
      const int cu = c[u];
      const int cc = cu > x ? cu : x;
      const int cs = s[u] + 1;
      if (cc < nc || (cc == nc && (cs < ns || (cs == ns && cl < nl)))) {
        nc = cc;
        ns = cs;
        nl = cl;
      }
    }
    c_out[v] = nc;
    s_out[v] = ns;
    l_out[v] = nl;
    any |= nc != c0 || ns != s0 || nl != l0;
  }
  if (changed) block_flag(changed, any);
}

bool make_dims(int ndim, const long long* shape, Dims* dm,
               long long* total) {
  if (ndim < 1 || ndim > ED_DIST_MAXD) return false;
  long long t = 1;
  dm->ndim = ndim;
  for (int k = 0; k < ED_DIST_MAXD; ++k) dm->n[k] = 1;
  for (int k = 0; k < ndim; ++k) {
    if (shape[k] < 1) return false;
    dm->n[k] = (unsigned)shape[k];
    t *= shape[k];
    if (t >= (1LL << 31)) return false;
  }
  *total = t;
  return true;
}

// one K15 launch along the middle axis of the (outer, n, inner) view: the
// band (W > 0) or the dense tier (W = 0, skipped where pred is not null
// and *pred is 0), on the tile route where tile_w > 0 (tile_w inner
// positions and tile_l outer slices a block) or the lines route
int launch_minplus(const double* g, double* out, const int* ix, int* ix_out,
                   int nidx, long long total, int n, long long inner,
                   const double* table, int W, double thr, double big,
                   int* fail, const int* pred, int tile_w, int tile_l,
                   cudaStream_t st) {
  if (tile_w > 0) {
    const long long outer = total / ((long long)n * inner);
    const size_t smem = (size_t)tile_l * n * tile_w *
                        (sizeof(double) + nidx * sizeof(int));
    if (tile_w > inner || tile_l < 1 || tile_l > outer ||
        (tile_l > 1 && tile_w != inner) || smem > ED_MINPLUS_SMEM)
      return (int)cudaErrorInvalidValue;
    Tile tl;
    tl.w = (unsigned)tile_w;
    tl.L = (unsigned)tile_l;
    tl.wtiles = (unsigned)((inner + tile_w - 1) / tile_w);
    tl.outer = (unsigned)outer;
    const unsigned blocks = (unsigned)((outer + tile_l - 1) / tile_l) *
                            tl.wtiles;
    if (W == 0)
      minplus_tile_kernel<true><<<blocks, ED_DIST_THREADS, smem, st>>>(
          g, out, ix, ix_out, nidx, (unsigned)total, n, (unsigned)inner, tl,
          table, 0, thr, big, fail, pred);
    else
      minplus_tile_kernel<false><<<blocks, ED_DIST_THREADS, smem, st>>>(
          g, out, ix, ix_out, nidx, (unsigned)total, n, (unsigned)inner, tl,
          table, W, thr, big, fail, pred);
  } else {
    const unsigned grid = grid_for(total);
    if (W == 0)
      minplus_lines_kernel<true><<<grid, ED_DIST_THREADS, 0, st>>>(
          g, out, ix, ix_out, nidx, (unsigned)total, n, (unsigned)inner,
          table, 0, thr, big, fail, pred);
    else
      minplus_lines_kernel<false><<<grid, ED_DIST_THREADS, 0, st>>>(
          g, out, ix, ix_out, nidx, (unsigned)total, n, (unsigned)inner,
          table, W, thr, big, fail, pred);
  }
  return (int)cudaGetLastError();
}

bool minplus_args(const double* g, const int* ix, const int* ix_out,
                  int nidx, long long total, int n, long long inner) {
  return g && total >= 1 && total < (1LL << 31) && n >= 1 && inner >= 1 &&
         total % ((long long)n * inner) == 0 && nidx >= 0 &&
         (nidx == 0 || (ix && ix_out));
}

}  // namespace

extern "C" {

// K14 on a contiguous bool mask of `ndim` axes (fewer than 2^31 voxels):
// f (float64, the mask's shape) and, where ix is not null, the (ndim,
// *shape) int32 feature planes. Returns cudaGetLastError().
int ed_nearest_background(const void* fg, double* f, int* ix, int ndim,
                          const long long* shape, double s0, double big,
                          void* stream) {
  Dims dm;
  long long total;
  if (!make_dims(ndim, shape, &dm, &total)) return (int)cudaErrorInvalidValue;
  const unsigned lines = (unsigned)(total / shape[0]);
  // a block's lines: a warp's 32, fewer (a power of two) for fewer lines
  int bl = 1;
  while (bl < ED_K14_LINES && (unsigned)bl < lines) bl *= 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nearest_bg_kernel<<<(lines + bl - 1) / bl, ED_DIST_THREADS, 0, st>>>(
      static_cast<const uint8_t*>(fg), f, ix, dm, lines, bl, s0, big);
  return (int)cudaGetLastError();
}

// K15, one rung along the middle axis of the contiguous (outer, n, inner)
// view of `total` voxels (fewer than 2^31). W > 0: a band of W, `table` the
// 2W constants (s o)^2 in the visiting order, *fail set where !(out <=
// thr) (the caller zeroes it); W = 0: the dense tier, `table` the n
// constants s^2 k^2, skipped by every block where pred is not null and
// *pred is 0. ix and ix_out: nidx feature planes of `total` int32 each, or
// null with nidx = 0. tile_w > 0: the tile route, tile_w inner positions
// and tile_l outer slices a block (tile_l > 1 only where tile_w = inner),
// at most ED_MINPLUS_SMEM bytes staged (8 + 4 nidx an element); tile_w =
// 0: the lines route. g and
// out, ix and ix_out must not overlap. Returns cudaGetLastError().
int ed_minplus_rung(const double* g, double* out, const int* ix, int* ix_out,
                    int nidx, long long total, int n, long long inner,
                    const double* table, int W, double thr, double big,
                    int* fail, const int* pred, int tile_w, int tile_l,
                    void* stream) {
  if (!minplus_args(g, ix, ix_out, nidx, total, n, inner) || W < 0 ||
      (W > 0 && !fail))
    return (int)cudaErrorInvalidValue;
  return launch_minplus(g, out, ix, ix_out, nidx, total, n, inner, table, W,
                        thr, big, fail, pred, tile_w, tile_l,
                        static_cast<cudaStream_t>(stream));
}

// K15, a whole pass from one host call, with no flag read: for W > 0,
// zero *flag, launch the band of W (band_table, thr) and then the dense
// tier (dense_table), whose blocks return at once where the band left
// *flag clear and otherwise overwrite the band's out and ix_out; for W = 0
// the dense tier alone. *flag is then set where the dense tier ran over
// the band. Arguments as ed_minplus_rung's. Returns the first error.
int ed_minplus_pass(const double* g, double* out, const int* ix, int* ix_out,
                    int nidx, long long total, int n, long long inner,
                    const double* band_table, int W, double thr,
                    const double* dense_table, double big, int* flag,
                    int tile_w, int tile_l, void* stream) {
  if (!minplus_args(g, ix, ix_out, nidx, total, n, inner) || W < 0 ||
      (W > 0 && !flag))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W > 0) {
    cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    const int e = launch_minplus(g, out, ix, ix_out, nidx, total, n, inner,
                                 band_table, W, thr, big, flag, nullptr,
                                 tile_w, tile_l, st);
    if (e) return e;
  }
  return launch_minplus(g, out, ix, ix_out, nidx, total, n, inner,
                        dense_table, 0, 0.0, big, nullptr,
                        W > 0 ? flag : nullptr, tile_w, tile_l, st);
}

// K16: `nsweeps` Jacobi sweeps of the chamfer relaxation on a contiguous
// int32 array of `ndim` axes, launched from this one host call: sweep j
// reads set j % 2 and writes set (j + 1) % 2, set 0 (d, ix), set 1 (d_out,
// ix_out), so the result lies in set nsweeps % 2 (an even count overwrites
// set 0); taps: ntaps (linear offset, edge word) pairs; ix and ix_out null
// without indices; changed null or set where a voxel of the last sweep
// changed. The sets must not overlap. Returns the first launch's error
// (cudaGetLastError()), or 0.
int ed_chamfer_sweep(int* d, int* ix, int* d_out, int* ix_out,
                     const int* taps, int ntaps, int ndim,
                     const long long* shape, int nsweeps, int* changed,
                     void* stream) {
  Dims dm;
  long long total;
  if (!make_dims(ndim, shape, &dm, &total) || ntaps < 0 || nsweeps < 1 ||
      (ix == nullptr) != (ix_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* tp = reinterpret_cast<const int2*>(taps);
  for (int j = 0; j < nsweeps; ++j) {
    chamfer_sweep_kernel<<<grid_for(total), ED_DIST_THREADS, 0, st>>>(
        d, ix, d_out, ix_out, tp, ntaps, dm, (unsigned)total,
        j == nsweeps - 1 ? changed : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    int* t = d;
    d = d_out;
    d_out = t;
    t = ix;
    ix = ix_out;
    ix_out = t;
  }
  return 0;
}

// K17: `nsweeps` Jacobi sweeps of the watershed relaxation, from one host
// call as K16's; img uint8 (img_bytes 1) or uint16 (2); the int32 triples
// set 0 (c, s, l) and set 1 (c_out, s_out, l_out); taps and changed as
// K16's. Returns the first launch's error, or 0.
int ed_watershed_sweep(const void* img, int img_bytes, int* c, int* s,
                       int* l, int* c_out, int* s_out, int* l_out,
                       const int* taps, int ntaps, int ndim,
                       const long long* shape, int nsweeps, int* changed,
                       void* stream) {
  Dims dm;
  long long total;
  if (!make_dims(ndim, shape, &dm, &total) || ntaps < 0 || nsweeps < 1 ||
      (img_bytes != 1 && img_bytes != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* tp = reinterpret_cast<const int2*>(taps);
  int* in[3] = {c, s, l};
  int* out[3] = {c_out, s_out, l_out};
  for (int j = 0; j < nsweeps; ++j) {
    int* flag = j == nsweeps - 1 ? changed : nullptr;
    if (img_bytes == 1)
      watershed_sweep_kernel<uint8_t><<<grid_for(total), ED_DIST_THREADS, 0,
                                        st>>>(
          static_cast<const uint8_t*>(img), in[0], in[1], in[2], out[0],
          out[1], out[2], tp, ntaps, dm, (unsigned)total, flag);
    else
      watershed_sweep_kernel<uint16_t><<<grid_for(total), ED_DIST_THREADS, 0,
                                         st>>>(
          static_cast<const uint16_t*>(img), in[0], in[1], in[2], out[0],
          out[1], out[2], tp, ntaps, dm, (unsigned)total, flag);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int k = 0; k < 3; ++k) {
      int* t = in[k];
      in[k] = out[k];
      out[k] = t;
    }
  }
  return 0;
}

const char* ed_distance_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
