// Shared by the two whole-block sort finders, K4 (sortfind.cu, mode R) and
// K7 (f2find.cu, mode F): 8-byte unaligned loads from the zero-padded block,
// the stable LSD radix sort of (u32 key, position), the byte-exact match
// extension, and the last stage of both finders (diagonal-run recovery, the
// cap, the [T, S] layout).
//
// The sort: 8 bits a pass, four passes, each pass stable, starting from
// position order, so equal keys keep their position order —
// jax.lax.sort(is_stable=True)'s result.  A warp counts the digits of its
// tile of 2048 keys (rs_hist); one CTA takes the exclusive sum over (digit,
// tile) (rs_scan); the warp then places its tile 32 keys at a time, ranking
// equal digits inside the warp with __match_any_sync (rs_scatter).
#pragma once

#include "ppm_r.cuh"

#define RS_TILE 2048  // keys per warp and pass (block.py::K4_TILE)
#define RS_WARPS 4
#define FIND_MAX_CANDS 7
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

// Leading equal bytes of the block at cand and at i, at most ext (8 bytes a
// compare, stopped at the first difference).
static __device__ __forceinline__ int match_len(const uint64_t* bytes, int cand,
                                                int i, int ext) {
  int len = 0;
  for (; len < ext; len += 8) {
    const uint64_t x = load_u64(bytes, (long long)cand + len) ^
                       load_u64(bytes, (long long)i + len);
    if (x) {
      len += eq_bytes(x);
      break;
    }
  }
  return min(len, ext);
}

static __global__ void __launch_bounds__(RS_WARPS * 32) rs_hist(
    const uint32_t* __restrict__ key, int big, int tiles, int shift,
    int* __restrict__ hist) {
  __shared__ int cnt_all[RS_WARPS][256];
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int tile = blockIdx.x * RS_WARPS + warp;
  int* const cnt = cnt_all[warp];
  for (int u = j; u < 256; u += 32) cnt[u] = 0;
  __syncwarp();
  if (tile >= tiles) return;
  const int base = tile * RS_TILE;
  for (int e = j; e < RS_TILE; e += 32)
    if (base + e < big) atomicAdd(&cnt[(key[base + e] >> shift) & 0xFFu], 1);
  __syncwarp();
  for (int u = j; u < 256; u += 32) hist[(size_t)u * tiles + tile] = cnt[u];
}

// In-place exclusive sum over hist[0 .. total), one CTA of 1024 threads.
static __global__ void __launch_bounds__(1024) rs_scan(int* __restrict__ hist, int total) {
  __shared__ int part[1024];
  const int tid = threadIdx.x;
  const int chunk = (total + 1023) / 1024;
  const int b = min(tid * chunk, total), e = min(b + chunk, total);
  int s = 0;
  for (int k = b; k < e; ++k) s += hist[k];
  part[tid] = s;
  __syncthreads();
  for (int off = 1; off < 1024; off <<= 1) {
    const int v = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int run = part[tid] - s;
  for (int k = b; k < e; ++k) {
    const int v = hist[k];
    hist[k] = run;
    run += v;
  }
}

static __global__ void __launch_bounds__(RS_WARPS * 32) rs_scatter(
    const uint32_t* __restrict__ key, const int* __restrict__ pos, int big,
    int tiles, int shift, const int* __restrict__ hist,
    uint32_t* __restrict__ key_out, int* __restrict__ pos_out) {
  __shared__ int off_all[RS_WARPS][256];
  const unsigned full = 0xffffffffu;
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int tile = blockIdx.x * RS_WARPS + warp;
  if (tile >= tiles) return;  // the whole warp
  int* const off = off_all[warp];
  for (int u = j; u < 256; u += 32) off[u] = hist[(size_t)u * tiles + tile];
  __syncwarp();
  const int base = tile * RS_TILE;
  for (int e = j; e < RS_TILE; e += 32) {
    const bool valid = base + e < big;
    const uint32_t k = valid ? key[base + e] : 0;
    const int p = valid ? pos[base + e] : 0;
    // threads past the end form a group of their own (digit 256)
    const int digit = valid ? (int)((k >> shift) & 0xFFu) : 256;
    const unsigned same = __match_any_sync(full, digit);
    const int rank = __popc(same & ((1u << j) - 1u));
    int dst = 0;
    if (valid) dst = off[digit] + rank;
    __syncwarp();
    if (valid && rank == 0) off[digit] += __popc(same);
    __syncwarp();
    if (valid) {
      key_out[dst] = k;
      pos_out[dst] = p;
    }
  }
}

// Sorts (key, pos) pairs by key, stably.  key and pos are [2, big] arrays
// whose first halves hold the input (pos in ascending order for a (key,
// position) sort) and, on return, the sorted order.  hist has
// 256 * ceil(big / RS_TILE) ints.
static inline void radix_sort_pairs(uint32_t* key, int* pos, int* hist, int big,
                                    cudaStream_t st) {
  const int tiles = (big + RS_TILE - 1) / RS_TILE;
  uint32_t* k[2] = {key, key + big};
  int* p[2] = {pos, pos + big};
  const int grid = (tiles + RS_WARPS - 1) / RS_WARPS;
  for (int pass = 0; pass < 4; ++pass) {
    const int a = pass & 1, b = a ^ 1, shift = 8 * pass;
    rs_hist<<<grid, RS_WARPS * 32, 0, st>>>(k[a], big, tiles, shift, hist);
    rs_scan<<<1, 1024, 0, st>>>(hist, 256 * tiles);
    rs_scatter<<<grid, RS_WARPS * 32, 0, st>>>(k[a], p[a], big, tiles, shift,
                                              hist, k[b], p[b]);
  }
}

// Last stage of a finder, one thread per output element.  cand_in and lw_in
// are [n_cands, N] in position order: the candidate, and its extension
// length | FIND_OK | FIND_EQ1.  Diagonal-run recovery: the run of positions
// from i whose candidates stay on one diagonal (cand[j + 1] == cand[j] + 1
// over the flat block) and whose first bytes match, plus (tail) a matching
// byte where it ends — a forward walk of at most cap positions, taken only
// where the extension fell short of the cap; after the cap it equals the
// JAX reverse running minimum.  Then the cap min(T - t, n - i, len_cap) and
// the [2 * n_cands, T, S] layout (len, src per candidate).
static __global__ void finder_final(int S, int T, int n, int n_cands, int len_cap,
                                    int tail, const int* __restrict__ cand_in,
                                    const int* __restrict__ lw_in,
                                    int* __restrict__ out) {
  const int big = S * T;
  const long long oo = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (oo >= big) return;
  const int t = (int)(oo / S), lane = (int)(oo % S);
  const int i = lane * T + t;
  const int cap = max(min(min(T - t, n - i), len_cap), 0);
  for (int u = 0; u < n_cands; ++u) {
    const int* const cand = cand_in + (size_t)u * big;
    const int* const lw = lw_in + (size_t)u * big;
    const int v = lw[i];
    int len = v & 0xFFFF;
    if ((v & FIND_OK) && len < cap) {
      int jj = i, run = cap;
      while (jj - i < cap) {
        const bool eq1 = lw[jj] & FIND_EQ1;
        if (!(eq1 && jj + 1 < big && cand[jj + 1] == cand[jj] + 1)) {
          run = jj - i + ((eq1 && tail) ? 1 : 0);
          break;
        }
        ++jj;
      }
      len = max(len, run);
    }
    out[(size_t)(2 * u) * big + oo] = (v & FIND_OK) ? min(len, cap) : 0;
    out[(size_t)(2 * u + 1) * big + oo] = cand[i];
  }
}
