// The card's own ceilings for the memory patterns of the resampling
// kernels: a block's shared memory, random row gathers (from L2 and from
// HBM) and row scatter-adds. A row is LANES = 128 float32, 512 bytes, as in
// the JAX package's Pallas probes, which these replace:
//
// P1 smem_probe: copies an (8, 128) float32 tile through nbytes of dynamic
//   shared memory, after asking for that many bytes with
//   cudaFuncSetAttribute(MaxDynamicSharedMemorySize). The tile sits at the
//   top of the allocation and crosses threads there, so the whole size must
//   be addressable. A size past the card's limit (227 KB = 232,448 bytes on
//   the H100) fails with the CUDA error: it is never clamped. Replaces
//   tools/probe_pallas.py:50 probe_vmem (a VMEM scratch of 16-120 MiB, which
//   has no counterpart on the card). Bound: launch latency.
//
// P2 row_gather: a warp gathers rows, one float4 per lane (a 512-byte row
//   is one coalesced warp load), with eight rows in flight (four in the
//   element mode). Modes:
//   copy     out[k - keep_from] = table[idx[k]] for k >= keep_from; every
//            row k < keep_from is read too (volatile loads), which is
//            tools/probe_gather.py:113 probe_pl_dg, whose grid steps all
//            write output block (0, 0) so the last chunk's rows are what
//            stays (keep_from = n_idx - chunk, made explicit here: blocks
//            run in no order). keep_from = 0 is the plain copy of
//            tools/probe_pallas.py:141 probe_dyngather,
//            tools/probe_gather2.py:46 probe_pl_loop_gather, :67 probe_pl_dg
//            and tools/probe_dyngather2.py:49 run's 1-D take;
//   element  out[k, l] = table[idx2d[k, l], l], take_along_axis's meaning
//            (run's 2-D contracts), whatever idx2d holds;
//   sum      out[c, r] = sum over the chunk's k of table[s_k + r], r < w,
//            with s_k = idx[k] (w = 1: tools/probe_gather.py:91
//            probe_pl_vmem) or, for windows of w rows, idx[k] clamped to
//            [0, n_rows - w] as jax.lax.dynamic_slice clamps (reference
//            note R8: tools/probe_pallas.py:85 probe_dynload reads its
//            8-row window past the table's end). A chunk is split into
//            `parts` blocks; each warp sums its rows in order, the block
//            sums its warps in order, and a second kernel sums the parts in
//            order, so a run repeats bit for bit.
//   Bound: bytes, each gathered row read once (from L2 where the table
//   fits its 50 MB) and each output written once.
//
// P3 row_scatter_add: out[idx[k]] += vals[k], one warp per input row, one
//   float32 atomicAdd per element into the zeroed output (the caller
//   zero-fills). Replaces tools/probe_pallas.py:120 probe_dynstore, :188
//   probe_scatrate and tools/probe_gather2.py:116 probe_pl_loop_scatter,
//   whose sequential read-modify-write fixes one summation order; the
//   atomics do not, so float sums agree to the rounding of a reordered sum
//   (integer-valued sums below 2^24 exactly). Bound: bytes, vals and idx
//   read once, out written once; the atomics' rate is what it measures.
//
// P4 row_gather_async: per-chunk row sums like P2's sum mode, with every
//   row brought from global to shared memory by a 1-D bulk copy
//   (cp.async.bulk ... mbarrier::complete_tx::bytes) into a ring of 16
//   row slots per warp, one mbarrier per slot: a slot is waited on, summed,
//   then refilled with the row 16 ahead. Replaces
//   tools/probe_gather.py:179 probe_pl_dma (pltpu.make_async_copy with 16
//   DMA semaphores in flight). Its table of 4M rows (2 GiB) is far past the
//   50 MB L2: the card's random-row rate from HBM. Chunks are split across
//   blocks and combined in a fixed order as in P2. Bound: bytes.
//
// The kernels launch on the caller's stream and allocate nothing; each C
// entry point returns cudaGetLastError() (or the error of the call that
// failed).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;               // floats in a row
constexpr int kVec = kLanes / 4;          // float4s in a row: one per lane
constexpr int kThreads = 256;             // P2 / P3 blocks: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWindow = 8;             // rows per window in sum mode
constexpr int kInFlight = 8;              // P2 row loads in flight per warp
constexpr int kElemInFlight = 4;          // the same in element mode
constexpr int kRing = 16;                 // P4 row slots per warp
constexpr int kAsyncWarps = 4;            // P4 warps per block

// ---------------------------------------------------------------------------
// P1

__global__ void __launch_bounds__(256)
smem_probe_kernel(const float4* __restrict__ in, float4* __restrict__ out,
                  int64_t tile) {
  extern __shared__ float4 smem[];
  const int t = threadIdx.x;
  smem[tile + t] = in[t];
  __syncthreads();
  out[255 - t] = smem[tile + 255 - t];
}

// ---------------------------------------------------------------------------
// P2

// One float4 of a table row. Volatile, so that a gathered row is read even
// where its value is not kept (copy mode below keep_from).
__device__ __forceinline__ float4 load_row4(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t warp_id() {
  return ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
}

__device__ __forceinline__ int64_t warp_count() {
  return ((int64_t)gridDim.x * blockDim.x) >> 5;
}

// A warp takes kInFlight rows per step, all loads first: a use of a load
// stalls the warp until it lands, so one row per step would keep one load
// in flight.
__global__ void __launch_bounds__(kThreads)
gather_copy_kernel(const float4* __restrict__ table,
                   const int* __restrict__ idx, float4* __restrict__ out,
                   int64_t n_idx, int64_t keep_from) {
  const int lane = threadIdx.x & 31;
  const int64_t step = warp_count();
  for (int64_t k0 = warp_id(); k0 < n_idx; k0 += step * kInFlight) {
    float4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int64_t k = k0 + u * step;
      if (k < n_idx) v[u] = load_row4(table + (int64_t)__ldg(idx + k) * kVec +
                                      lane);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int64_t k = k0 + u * step;
      if (k < n_idx && k >= keep_from)
        out[(k - keep_from) * kVec + lane] = v[u];
    }
  }
}

// As the copy mode, up to kElemInFlight rows a warp a step (a warp a row
// up to grid_for's 16,896 warps, then several): every row's indices, then
// every element load, then the stores. Four rows, not eight: a row holds
// its indices and values in eight registers a lane, and the launch bound
// keeps 64 registers a thread, four blocks an SM.
__global__ void __launch_bounds__(kThreads, 4)
gather_element_kernel(const float* __restrict__ table,
                      const int* __restrict__ idx2d, float* __restrict__ out,
                      int64_t n_idx) {
  const int lane = threadIdx.x & 31;
  const int l = 4 * lane;
  const int64_t step = warp_count();
  for (int64_t k0 = warp_id(); k0 < n_idx; k0 += step * kElemInFlight) {
    int4 r[kElemInFlight];
#pragma unroll
    for (int u = 0; u < kElemInFlight; ++u) {
      const int64_t k = k0 + u * step;
      if (k < n_idx)
        r[u] = __ldg(reinterpret_cast<const int4*>(idx2d + k * kLanes) +
                     lane);
    }
    float4 v[kElemInFlight];
#pragma unroll
    for (int u = 0; u < kElemInFlight; ++u) {
      if (k0 + u * step < n_idx) {
        v[u].x = __ldg(table + (int64_t)r[u].x * kLanes + l);
        v[u].y = __ldg(table + (int64_t)r[u].y * kLanes + l + 1);
        v[u].z = __ldg(table + (int64_t)r[u].z * kLanes + l + 2);
        v[u].w = __ldg(table + (int64_t)r[u].w * kLanes + l + 3);
      }
    }
#pragma unroll
    for (int u = 0; u < kElemInFlight; ++u) {
      const int64_t k = k0 + u * step;
      if (k < n_idx) reinterpret_cast<float4*>(out)[k * kVec + lane] = v[u];
    }
  }
}

// The items [lo, hi) of block (c, p): part p of chunk c.
__device__ __forceinline__ void part_range(int64_t chunk, int parts,
                                           int64_t* lo, int64_t* hi) {
  const int64_t c = blockIdx.x / parts;
  const int64_t p = blockIdx.x - c * parts;
  const int64_t len = (chunk + parts - 1) / parts;
  *lo = c * chunk + min64(p * len, chunk);
  *hi = c * chunk + min64((p + 1) * len, chunk);
}

// partial[blockIdx.x, r, lane] = sum over the block's warps, in order, of
// acc[warp][r] (red: kWarps * w * 32 float4 of shared memory).
__device__ __forceinline__ void block_sum(const float4* acc, int w,
                                          int nwarps, float4* red,
                                          float4* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kMaxWindow; ++r)
    if (r < w) red[(wi * w + r) * 32 + lane] = acc[r];
  __syncthreads();
  if (wi == 0) {
    for (int r = 0; r < w; ++r) {
      float4 s = red[r * 32 + lane];
      for (int j = 1; j < nwarps; ++j) add4(s, red[(j * w + r) * 32 + lane]);
      partial[((int64_t)blockIdx.x * w + r) * kVec + lane] = s;
    }
  }
}

// W rows per window; a warp loads U windows (kInFlight rows) before it
// adds them, in the order of k, so the sums do not depend on U.
template <int W>
__global__ void __launch_bounds__(kThreads)
gather_sum_kernel(const float4* __restrict__ table,
                  const int* __restrict__ idx, float4* __restrict__ partial,
                  int64_t n_rows, int64_t chunk, int parts, int clamp) {
  constexpr int U = (kInFlight + W - 1) / W;
  __shared__ float4 red[kWarps * W * 32];
  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x >> 5;
  int64_t lo, hi;
  part_range(chunk, parts, &lo, &hi);
  float4 acc[W];
#pragma unroll
  for (int r = 0; r < W; ++r) acc[r] = make_float4(0, 0, 0, 0);
  for (int64_t k0 = lo + wi; k0 < hi; k0 += kWarps * U) {
    float4 v[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t k = k0 + u * kWarps;
      if (k < hi) {
        int64_t s = __ldg(idx + k);
        if (clamp) s = s < 0 ? 0 : (s > n_rows - W ? n_rows - W : s);
#pragma unroll
        for (int r = 0; r < W; ++r)
          v[u][r] = load_row4(table + (s + r) * kVec + lane);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k0 + u * kWarps < hi) {
#pragma unroll
        for (int r = 0; r < W; ++r) add4(acc[r], v[u][r]);
      }
  }
  block_sum(acc, W, kWarps, red, partial);
}

template <int W>
cudaError_t launch_sum(const void* table, const void* idx, void* partial,
                       long long n_rows, long long n_chunks, long long chunk,
                       int parts, int clamp, cudaStream_t s) {
  gather_sum_kernel<W><<<(unsigned)(n_chunks * parts), kThreads, 0, s>>>(
      static_cast<const float4*>(table), static_cast<const int*>(idx),
      static_cast<float4*>(partial), n_rows, chunk, parts, clamp);
  return cudaGetLastError();
}

// out[c, r, :] = sum over p, in order, of partial[c, p, r, :].
__global__ void __launch_bounds__(kThreads)
combine_parts_kernel(const float4* __restrict__ partial,
                     float4* __restrict__ out, int64_t n_chunks, int parts,
                     int w) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per_chunk = (int64_t)w * kVec;
  if (i >= n_chunks * per_chunk) return;
  const int64_t c = i / per_chunk;
  const int64_t e = i - c * per_chunk;
  const float4* src = partial + c * parts * per_chunk + e;
  float4 s = src[0];
  for (int p = 1; p < parts; ++p) add4(s, src[p * per_chunk]);
  out[i] = s;
}

// ---------------------------------------------------------------------------
// P3

__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const int* __restrict__ idx,
                   const float4* __restrict__ vals, float* __restrict__ out,
                   int64_t n_idx) {
  const int lane = threadIdx.x & 31;
  for (int64_t k = warp_id(); k < n_idx; k += warp_count()) {
    const int64_t row = __ldg(idx + k);
    const float4 v = __ldg(vals + k * kVec + lane);
    float* o = out + row * kLanes + 4 * lane;
    atomicAdd(o, v.x);
    atomicAdd(o + 1, v.y);
    atomicAdd(o + 2, v.z);
    atomicAdd(o + 3, v.w);
  }
}

// ---------------------------------------------------------------------------
// P4

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Lane 0: arm the slot's mbarrier for one row and start its bulk copy.
__device__ __forceinline__ void fetch_row(uint32_t bar, uint32_t dst,
                                          const float4* src) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(kLanes * 4)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(kLanes * 4), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wait_slot(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__global__ void __launch_bounds__(kAsyncWarps * 32)
gather_async_sum_kernel(const float4* __restrict__ table,
                        const int* __restrict__ idx,
                        float4* __restrict__ partial, int64_t chunk,
                        int parts) {
  __shared__ alignas(128) float4 ring[kAsyncWarps][kRing][kVec];
  __shared__ alignas(8) uint64_t bars[kAsyncWarps][kRing];
  __shared__ float4 red[kAsyncWarps * 32];
  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x >> 5;
  int64_t lo, hi;
  part_range(chunk, parts, &lo, &hi);
  // each warp sums a contiguous share of the part, in order
  const int64_t share = (hi - lo + kAsyncWarps - 1) / kAsyncWarps;
  const int64_t my_lo = min64(lo + wi * share, hi);
  const int64_t n = min64(my_lo + share, hi) - my_lo;

  if (lane == 0) {
    for (int s = 0; s < kRing; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(&bars[wi][s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int64_t j = 0; j < n && j < kRing; ++j)
      fetch_row(smem_u32(&bars[wi][j]), smem_u32(&ring[wi][j][0]),
                table + (int64_t)__ldg(idx + my_lo + j) * kVec);
  }
  __syncwarp();

  float4 acc = make_float4(0, 0, 0, 0);
  for (int64_t j = 0; j < n; ++j) {
    const int slot = (int)(j % kRing);
    wait_slot(smem_u32(&bars[wi][slot]), (uint32_t)((j / kRing) & 1));
    add4(acc, ring[wi][slot][lane]);
    __syncwarp();  // every lane has read the slot before it is refilled
    if (lane == 0 && j + kRing < n) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      fetch_row(smem_u32(&bars[wi][slot]), smem_u32(&ring[wi][slot][0]),
                table + (int64_t)__ldg(idx + my_lo + j + kRing) * kVec);
    }
  }
  block_sum(&acc, 1, kAsyncWarps, red, partial);
}

cudaError_t combine(const void* partial, void* out, long long n_chunks,
                    int parts, int w, cudaStream_t s) {
  const long long total = n_chunks * w * kVec;
  combine_parts_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                         kThreads, 0, s>>>(
      static_cast<const float4*>(partial), static_cast<float4*>(out),
      n_chunks, parts, w);
  return cudaGetLastError();
}

unsigned grid_for(long long items) {
  // one warp per item up to 16 blocks of 8 warps per SM (132 SMs); a
  // grid-stride loop takes the rest
  const long long want = (items + kWarps - 1) / kWarps;
  return (unsigned)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

}  // namespace

extern "C" {

// P1: copy in (8, 128) float32 to out through nbytes of dynamic shared
// memory (a multiple of 16, at least 4096). Returns the error of
// cudaFuncSetAttribute when nbytes passes the card's limit.
int ed_smem_probe(const void* in, void* out, long long nbytes, void* stream) {
  if (nbytes < 4096 || nbytes % 16 != 0 || nbytes > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)nbytes);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // leave no error behind for later launches
    return (int)err;
  }
  smem_probe_kernel<<<1, 256, (size_t)nbytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(in), static_cast<float4*>(out),
      nbytes / 16 - 256);
  return (int)cudaGetLastError();
}

// The most dynamic shared memory a block of this card may ask for, in
// bytes (into *out).
int ed_smem_limit(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// P2 copy: table (n_rows, 128) float32, idx (n_idx,) int32, out
// (n_idx - keep_from, 128).
int ed_row_gather_copy(const void* table, const void* idx, void* out,
                       long long n_idx, long long keep_from, void* stream) {
  if (keep_from < 0 || keep_from > n_idx) return (int)cudaErrorInvalidValue;
  if (n_idx == 0) return 0;
  gather_copy_kernel<<<grid_for(n_idx), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(idx),
      static_cast<float4*>(out), n_idx, keep_from);
  return (int)cudaGetLastError();
}

// P2 element: idx2d and out (n_idx, 128).
int ed_row_gather_element(const void* table, const void* idx2d, void* out,
                          long long n_idx, void* stream) {
  if (n_idx == 0) return 0;
  gather_element_kernel<<<grid_for(n_idx), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx2d),
      static_cast<float*>(out), n_idx);
  return (int)cudaGetLastError();
}

// P2 sum: idx (n_chunks * chunk,), partial (n_chunks * parts, w, 128), out
// (n_chunks, w, 128); windows of w <= 8 rows, their starts clamped when
// clamp != 0.
int ed_row_gather_sum(const void* table, const void* idx, void* partial,
                      void* out, long long n_rows, long long n_chunks,
                      long long chunk, int parts, int w, int clamp,
                      void* stream) {
  if (w < 1 || w > kMaxWindow || parts < 1 || n_rows < w || chunk < 1)
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (w) {
    case 1: err = launch_sum<1>(table, idx, partial, n_rows, n_chunks, chunk,
                                parts, clamp, s); break;
    case 2: err = launch_sum<2>(table, idx, partial, n_rows, n_chunks, chunk,
                                parts, clamp, s); break;
    case 3: err = launch_sum<3>(table, idx, partial, n_rows, n_chunks, chunk,
                                parts, clamp, s); break;
    case 4: err = launch_sum<4>(table, idx, partial, n_rows, n_chunks, chunk,
                                parts, clamp, s); break;
    case 5: err = launch_sum<5>(table, idx, partial, n_rows, n_chunks, chunk,
                                parts, clamp, s); break;
    case 6: err = launch_sum<6>(table, idx, partial, n_rows, n_chunks, chunk,
                                parts, clamp, s); break;
    case 7: err = launch_sum<7>(table, idx, partial, n_rows, n_chunks, chunk,
                                parts, clamp, s); break;
    default: err = launch_sum<8>(table, idx, partial, n_rows, n_chunks, chunk,
                                 parts, clamp, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)combine(partial, out, n_chunks, parts, w, s);
}

// P3: out (n_rows, 128) float32, zeroed by the caller; idx (n_idx,) int32,
// vals (n_idx, 128) float32.
int ed_row_scatter_add(const void* idx, const void* vals, void* out,
                       long long n_idx, void* stream) {
  if (n_idx == 0) return 0;
  scatter_add_kernel<<<grid_for(n_idx), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float4*>(vals),
      static_cast<float*>(out), n_idx);
  return (int)cudaGetLastError();
}

// P4: as P2 sum with w = 1 and no clamp; partial (n_chunks * parts, 128).
int ed_row_gather_async(const void* table, const void* idx, void* partial,
                        void* out, long long n_chunks, long long chunk,
                        int parts, void* stream) {
  if (parts < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather_async_sum_kernel<<<(unsigned)(n_chunks * parts), kAsyncWarps * 32,
                            0, s>>>(
      static_cast<const float4*>(table), static_cast<const int*>(idx),
      static_cast<float4*>(partial), chunk, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)combine(partial, out, n_chunks, parts, 1, s);
}

const char* ed_probes_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
