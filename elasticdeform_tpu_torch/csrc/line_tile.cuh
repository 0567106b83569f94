// The line tile shared by K2/K4/K6/K7 (prefilter.cu) and K8T (filters.cu):
// a block stages W whole lines of a contiguous tensor viewed as (outer, n,
// inner), line (o, i) at o*n*inner + k*inner + i, k = 0..n-1, in shared
// memory with cp.async, one read of each element from device memory.
//
// When inner >= W, a tile is W consecutive i of one o: row k is W
// contiguous elements, kept as row k of the shared tile at an odd stride,
// so that the threads touch consecutive words. When inner < W (the
// innermost axis: inner is 1 or a channel count), a tile is floor(W /
// inner) whole outers ("packed"), one contiguous run of elements that the
// block loads linearly and keeps as it is in shared memory, each outer's n
// * inner elements at a stride congruent to inner modulo 32 words, so that
// the threads of consecutive lines still touch distinct banks. A warp's
// loads then touch consecutive words in device and shared memory alike, on
// every axis. The geometry comes from ops/prefilter.py:_tile_plan.
#pragma once

#include <stdint.h>

#include "cp_async.cuh"

namespace {

// The tile route's geometry (ops/prefilter.py:_tile_plan).
struct Tile {
  int packed;     // 1: inner < W, a tile is whole outers, one run of memory
  int lines;      // lines of a full tile: W, or inner * floor(W / inner)
  // shared-memory stride in elements: of a row k (odd), or, packed, of an
  // outer's run of n * inner elements (congruent to inner modulo 32)
  int stride;
  int64_t col_tiles;  // not packed: tiles per outer, ceil(inner / W)
  // packed: a thread walks the run in steps of W elements, W = dol outers
  // + dr elements, as (outer, offset in its run) with a carry
  int dol, dr;
};

// Calls f(global offset from base, shared offset) for each element of a
// packed tile that thread w moves: elements w, w + W, ... of the run of
// `outers` whole outers, (outer, offset in its run) carried without
// divisions.
template <int W, typename F>
__device__ __forceinline__ void packed_walk(const Tile& t, int run,
                                            int outers, int w, F f) {
  const int elems = outers * run;
  int ol = w / run;
  int r = w - ol * run;
  for (int e = w; e < elems; e += W) {
    f(e, ol * t.stride + r);
    r += t.dr;
    const int wrap = r >= run;
    r -= wrap ? run : 0;
    ol += t.dol + wrap;
  }
}

// Where tile `tile_id` lies: packed, the run of `outers` whole outers from
// offset `first`; else line w of the tile's `width` lines starts at offset
// `first` (w included). The grid holds fewer than 2^31 blocks (make_tile),
// so the division is 32-bit.
struct TileSpan {
  int64_t first;
  int outers, width;
};

template <int W>
__device__ __forceinline__ TileSpan tile_span(const Tile& t, int64_t tile_id,
                                              int64_t outer, int64_t n,
                                              int64_t inner, int w) {
  TileSpan s;
  if (t.packed) {
    const int64_t g = t.lines / inner;
    const int64_t o0 = tile_id * g;
    const int64_t left = outer - o0;
    s.outers = (int)(left < g ? left : g);
    s.width = s.outers * (int)inner;
    s.first = o0 * n * inner;
  } else {
    const unsigned o = (unsigned)tile_id / (unsigned)t.col_tiles;
    const int64_t c0 = ((int64_t)tile_id - (int64_t)o * t.col_tiles) * W;
    const int64_t left = inner - c0;
    s.outers = 0;
    s.width = (int)(left < W ? left : W);
    s.first = (int64_t)o * n * inner + c0 + w;
  }
  return s;
}

// Thread w's share of staging the tile of `s` from `in` into `tile`, all
// its copies in flight at once; the caller waits (stage_wait) and syncs.
// With R threads a line (K8T), thread (w, r) stages rows r, r + R, ... of
// column w, or, packed, elements w + W r, w + W (r + R), ... of the run
// (t.dol and t.dr then step W * R elements).
template <typename T, int W, int R = 1>
__device__ __forceinline__ void stage_tile(T* tile, const T* __restrict__ in,
                                           const Tile& t, const TileSpan& s,
                                           int n, int64_t inner, int w,
                                           int r = 0) {
  const T* src = in + s.first;
  if (t.packed) {
    packed_walk<W * R>(t, n * (int)inner, s.outers, w + W * r,
                       [&](int e, int sh) { stage_async(tile + sh, src + e); });
  } else if (w < s.width) {
    src += r * inner;
    for (int k = r; k < n; k += R, src += R * inner)
      stage_async(tile + k * t.stride + w, src);
  }
}

// Checks a tile plan against the shape and fills in what the kernel walks
// by; false when the plan does not fit the shape or the card. smem: the
// tile's own bytes (the plan's, less what a kernel keeps beside it).
bool make_tile(Tile* t, int itemsize, int64_t outer, int64_t n,
               int64_t inner, int width, int packed, int lines, int stride,
               int smem, int64_t blocks, int smem_limit) {
  if (width != 32 && width != 64 && width != 128) return false;
  if (n < 1 || outer < 1 || inner < 1 || smem > smem_limit) return false;
  t->packed = packed;
  t->lines = lines;
  t->stride = stride;
  t->col_tiles = (inner + width - 1) / width;
  int64_t want;
  if (packed) {
    const int64_t run = n * inner, g = width / inner;
    if (inner >= width || lines != inner * g || stride < run ||
        stride % 32 != inner % 32 || g * stride * itemsize != smem)
      return false;
    t->dol = (int)(width / run);
    t->dr = (int)(width % run);
    want = (outer + g - 1) / g;
  } else {
    if (inner < width || lines != width || stride < lines ||
        stride % 2 == 0 || (int64_t)stride * n * itemsize != smem)
      return false;
    t->dol = t->dr = 0;
    want = outer * t->col_tiles;
  }
  return blocks == want && blocks <= 0x7fffffffLL;
}

}  // namespace
