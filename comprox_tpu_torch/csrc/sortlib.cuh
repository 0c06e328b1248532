// Shared by the whole-block sort finder K4 (sortfind.cu: mode R, its
// mode-X entry K4x and its mode-F entry K7) and by K13c (lzpcand.cu):
// 8-byte unaligned loads from the zero-padded block and the stable LSD
// radix sort of (u32 key, position).
//
// The sort (replaces jax.lax.sort((h, idx), num_keys=1, is_stable=True) at
// comprox_tpu/codec/block.py:854 and comprox_tpu/codec/fast.py:198): 8
// bits a pass, four passes at most, each stable, from position order, so
// equal keys keep their position order.  One sweep a pass, after Adinets
// and Merrill's Onesweep (2022):
//   rs_hist      reads the keys once and counts all four digits, each CTA
//                in shared memory, then adds its counts to the global ones;
//   rs_plan      one CTA: the four exclusive digit sums, and which passes
//                run: a pass whose digit is the same for every key (one bin
//                holds N) is the identity of a stable sort and is skipped;
//   rs_pass      one kernel a pass: a CTA takes the next tile of RS_TILE
//                keys from a counter (so a tile's predecessors have all
//                started, and the look-back below cannot wait on a CTA that
//                is not resident), ranks its keys by digit in shared memory
//                (__match_any_sync in each warp, then a prefix over the
//                warps), publishes its 256 digit counts as flag|value
//                words, looks back over the earlier tiles' words for its
//                global offsets (decoupled look-back), and writes keys and
//                positions from shared memory in digit order, so that
//                consecutive threads store consecutive addresses of a
//                digit's run;
//   rs_finish    where an odd number of passes ran, copies the result back
//                into the first halves; where none ran, writes the
//                identity positions (a caller that reads the half the
//                passes left, K13c, skips it: rs_sorted_half).
// Ties keep their input order inside a tile (earlier item, then lower
// lane), and tiles take their offsets in tile order: the sort is stable.
// The first pass that runs reads no positions: they are the identity.
//
// Bound on the H100: bytes.  Each pass that runs reads and writes 8 bytes
// a key; rs_hist reads 4.  At the main path's N = 8 Mi, four passes move
// ~0.57 GB (~0.17 ms at 3.35 TB/s); the sort as a function (keys read
// once, keys and positions written once) needs 0.1 GB.
#pragma once

#include "ppm_r.cuh"

#define FIND_OK (1 << 17)   // lw flag: the candidate is usable
#define FIND_EQ1 (1 << 16)  // lw flag: its first byte equals the position's

// The 8 bytes at byte offset j of an 8-byte aligned buffer, little-endian;
// the buffer's zero tail covers the second word.
static __device__ __forceinline__ uint64_t load_u64(const uint64_t* w, long long j) {
  const long long k = j >> 3;
  const int sh = (int)(j & 7) * 8;
  const uint64_t lo = w[k];
  return sh ? (lo >> sh) | (w[k + 1] << (64 - sh)) : lo;
}

// Leading equal bytes of two 8-byte little-endian windows: 0..8.
static __device__ __forceinline__ int eq_bytes(uint64_t x) {
  return x ? (__ffsll((long long)x) - 1) >> 3 : 8;
}

#define RS_THREADS 256  // threads of an rs_pass CTA: one a digit
#define RS_ITEMS 16     // keys a thread
#define RS_TILE (RS_THREADS * RS_ITEMS)  // keys a CTA and pass (block.py::K4_TILE)
#define RS_WARPS (RS_THREADS / 32)
#define RS_PASSES 4
// The scratch (ints), zeroed by radix_sort_pairs: [0, 1024) the digit
// counts of the four passes, then their exclusive sums; RS_CTR the passes'
// tile counters; RS_PLAN per pass -1 (skipped) or the half it reads (bit
// 0) | 2 on the first pass that runs; RS_PLAN + RS_PASSES the number of
// passes run; from RS_HDR the look-back words, 256 a tile and pass
// (block.py::_sort_stage sizes it: RS_HDR + RS_PASSES * 256 * tiles).
#define RS_CTR 1024
#define RS_PLAN (RS_CTR + RS_PASSES)
#define RS_RUNS (RS_PLAN + RS_PASSES)
#define RS_HDR 1040
#define RS_AGG (1u << 30)  // look-back word: the tile's own count
#define RS_INC (2u << 30)  // look-back word: the count of the tiles up to it
#define RS_VAL ((1u << 30) - 1u)

static inline int rs_tiles(int n) { return (n + RS_TILE - 1) / RS_TILE; }

static __global__ void __launch_bounds__(512) rs_hist(const uint32_t* __restrict__ key,
                                                       int n, int* __restrict__ hist) {
  __shared__ int cnt[RS_PASSES * 256];
  for (int k = threadIdx.x; k < RS_PASSES * 256; k += blockDim.x) cnt[k] = 0;
  __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* k4 = reinterpret_cast<const uint4*>(key);
  auto add = [&](uint32_t u) {
#pragma unroll
    for (int q = 0; q < RS_PASSES; ++q) atomicAdd(&cnt[q * 256 + ((u >> (8 * q)) & 0xFFu)], 1);
  };
  for (int j = first; j < n / 4; j += stride) {
    const uint4 v = k4[j];
    add(v.x);
    add(v.y);
    add(v.z);
    add(v.w);
  }
  for (int j = n / 4 * 4 + first; j < n; j += stride) add(key[j]);
  __syncthreads();
  for (int k = threadIdx.x; k < RS_PASSES * 256; k += blockDim.x)
    if (cnt[k]) atomicAdd(&hist[k], cnt[k]);
}

// Exclusive sum of v over the 256 threads of a CTA, in thread order (two
// barriers: call by every thread).
static __device__ __forceinline__ int rs_block_excl(int v, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  __syncthreads();
  return before + incl - v;
}

// One CTA of 256 threads, thread d for digit d.
static __global__ void __launch_bounds__(RS_THREADS) rs_plan(int* __restrict__ scratch, int n) {
  __shared__ int wsum[RS_WARPS];
  const int d = threadIdx.x;
  int skip[RS_PASSES];
#pragma unroll
  for (int q = 0; q < RS_PASSES; ++q) {
    const int c = scratch[q * 256 + d];
    skip[q] = __syncthreads_or(c == n);
    scratch[q * 256 + d] = rs_block_excl(c, wsum);
  }
  if (d == 0) {
    int runs = 0;
#pragma unroll
    for (int q = 0; q < RS_PASSES; ++q) {
      scratch[RS_PLAN + q] = skip[q] ? -1 : (runs & 1) | (runs == 0 ? 2 : 0);
      runs += !skip[q];
    }
    scratch[RS_RUNS] = runs;
  }
}

static __device__ __forceinline__ uint32_t rs_load_word(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

static __device__ __forceinline__ void rs_store_word(uint32_t* p, uint32_t v) {
  *reinterpret_cast<volatile uint32_t*>(p) = v;
}

// Pass q over key and pos, [2, n] arrays: reads the half the plan names,
// writes the other.  One CTA a tile; the grid has every tile.
static __global__ void __launch_bounds__(RS_THREADS) rs_pass(
    uint32_t* __restrict__ key, int* __restrict__ pos, int n, int q,
    int* __restrict__ scratch) {
  const int plan = scratch[RS_PLAN + q];
  if (plan < 0) return;  // the digit is the same for every key
  __shared__ int s_tile;
  __shared__ int wsum[RS_WARPS];
  __shared__ int whist[RS_WARPS][256];  // counts, then offsets, a warp and digit
  __shared__ int dig_first[256];        // the tile's first index of each digit
  __shared__ int dig_dst[256];          // its global index, less dig_first
  __shared__ uint32_t skey[RS_TILE];
  __shared__ int spos[RS_TILE];
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int shift = 8 * q, a = plan & 1;
  const bool ident = plan & 2;
  const uint32_t* kin = key + (size_t)a * n;
  const int* pin = pos + (size_t)a * n;
  uint32_t* kout = key + (size_t)(a ^ 1) * n;
  int* pout = pos + (size_t)(a ^ 1) * n;
  if (tid == 0) s_tile = atomicAdd(&scratch[RS_CTR + q], 1);
  for (int k = tid; k < RS_WARPS * 256; k += RS_THREADS) (&whist[0][0])[k] = 0;
  __syncthreads();
  const int tile = s_tile;
  // warp w holds keys [w * 32 * RS_ITEMS, (w + 1) * 32 * RS_ITEMS) of the
  // tile, item u of lane j at 32 * u + j: every load is coalesced, and
  // (warp, item, lane) is the input order
  const int base = tile * RS_TILE + warp * 32 * RS_ITEMS;
  uint32_t k[RS_ITEMS];
  int p[RS_ITEMS], rank[RS_ITEMS];
#pragma unroll
  for (int u = 0; u < RS_ITEMS; ++u) {
    const int e = base + 32 * u + lane;
    k[u] = e < n ? kin[e] : 0u;
    p[u] = e < n ? (ident ? e : pin[e]) : 0;
  }
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < RS_ITEMS; ++u) {
    const bool valid = base + 32 * u + lane < n;
    // keys past the end form a group of their own (digit 256)
    const int dg = valid ? (int)((k[u] >> shift) & 0xFFu) : 256;
    const unsigned peers = __match_any_sync(full, dg);
    const int before = valid ? whist[warp][dg] : 0;
    rank[u] = before + __popc(peers & lower);
    __syncwarp();
    if (valid && lane == 31 - __clz(peers)) whist[warp][dg] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // thread d: the warps' offsets within digit d, the tile's count of it
  const int d = tid;
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < RS_WARPS; ++w) {
    const int c = whist[w][d];
    whist[w][d] = cnt;
    cnt += c;
  }
  uint32_t* const look = reinterpret_cast<uint32_t*>(scratch + RS_HDR) +
                         ((size_t)q * gridDim.x) * 256 + d;
  rs_store_word(look + (size_t)tile * 256, (tile == 0 ? RS_INC : RS_AGG) | (uint32_t)cnt);
  const int first = rs_block_excl(cnt, wsum);
  dig_first[d] = first;
  // decoupled look-back: the counts of digit d in the tiles before this one
  int before = 0;
  for (int j = tile - 1; j >= 0; --j) {
    uint32_t w;
    do {
      w = rs_load_word(look + (size_t)j * 256);
    } while (!(w & (RS_AGG | RS_INC)));
    before += (int)(w & RS_VAL);
    if (w & RS_INC) break;
  }
  if (tile > 0) rs_store_word(look + (size_t)tile * 256, RS_INC | (uint32_t)(before + cnt));
  dig_dst[d] = scratch[q * 256 + d] + before - first;
  __syncthreads();
  // the tile in (digit, input) order in shared memory
#pragma unroll
  for (int u = 0; u < RS_ITEMS; ++u) {
    if (base + 32 * u + lane < n) {
      const int dg = (int)((k[u] >> shift) & 0xFFu);
      const int at = dig_first[dg] + whist[warp][dg] + rank[u];
      skey[at] = k[u];
      spos[at] = p[u];
    }
  }
  __syncthreads();
  const int tile_n = min(RS_TILE, n - tile * RS_TILE);
  for (int e = tid; e < tile_n; e += RS_THREADS) {
    const uint32_t kk = skey[e];
    const int dst = dig_dst[(kk >> shift) & 0xFFu] + e;
    kout[dst] = kk;
    pout[dst] = spos[e];
  }
}

static __global__ void rs_finish(uint32_t* __restrict__ key, int* __restrict__ pos,
                                 int n, const int* __restrict__ scratch) {
  const int runs = scratch[RS_RUNS];
  if (runs > 0 && !(runs & 1)) return;
  const int stride = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n; j += stride) {
    if (runs == 0) {
      pos[j] = j;
    } else {
      key[j] = key[n + j];
      pos[j] = pos[n + j];
    }
  }
}

// The half of key and pos that holds the sorted pairs when rs_finish did
// not run, or -1 where no pass ran (the keys in order, the positions the
// identity, never written).
static __device__ __forceinline__ int rs_sorted_half(const int* scratch) {
  const int runs = scratch[RS_RUNS];
  return runs ? runs & 1 : -1;
}

// Sorts (key, position) pairs by key, stably.  key and pos are [2, n]
// arrays; key's first half holds the keys (16-byte aligned), and on return
// the first halves hold the sorted keys and their positions (the input
// order is the identity); without `finish`, the half rs_sorted_half names.
// scratch: RS_HDR + RS_PASSES * 256 * rs_tiles(n) ints.
static inline int radix_sort_pairs(uint32_t* key, int* pos, int* scratch, int n,
                                   cudaStream_t st, bool finish = true) {
  const int tiles = rs_tiles(n);
  cudaMemsetAsync(scratch, 0, (RS_HDR + (size_t)RS_PASSES * 256 * tiles) * sizeof(int), st);
  rs_hist<<<min(tiles, 264), 512, 0, st>>>(key, n, scratch);
  rs_plan<<<1, RS_THREADS, 0, st>>>(scratch, n);
  for (int q = 0; q < RS_PASSES; ++q)
    rs_pass<<<tiles, RS_THREADS, 0, st>>>(key, pos, n, q, scratch);
  if (finish)
    rs_finish<<<min((n + 255) / 256, 1056), 256, 0, st>>>(key, pos, n, scratch);
  return (int)cudaGetLastError();
}
