// Byte-window and scored-row reads shared by the two encoder scans that
// search the ROLZ bucket table: the search scan (KS, search.cu) and the
// rank scan (K5, rank.cu).
#pragma once

#include "ppm_r.cuh"

// The 8 block bytes at start, little-endian, each 0 at an index >= lim
// (lim <= cap).  Two aligned 64-bit loads and a funnel shift: inp is
// 8-byte aligned and cap = S*T is a multiple of 8 (lanes % 8 == 0), so a
// word that holds any index < cap lies inside the buffer.
static __device__ __forceinline__ uint64_t load8(const uint8_t* inp, long long cap,
                                          long long start, long long lim) {
  long long valid = lim - start;
  if (valid <= 0) return 0;
  const uint64_t* w = reinterpret_cast<const uint64_t*>(inp);
  long long k = start >> 3, nw = cap >> 3;
  int sh = (int)(start & 7) * 8;
  uint64_t lo = k < nw ? w[k] : 0, hi = k + 1 < nw ? w[k + 1] : 0;
  uint64_t v = sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
  return valid < 8 ? v & ((1ull << (8 * valid)) - 1) : v;
}

// Common prefix (up to width) of the lane's upcoming bytes, zero past its
// row, and the block bytes at src, zero past the block: 8 bytes per
// compare, eight compares' loads in flight together, the first difference
// by its lowest set bit.
static __device__ int prefix_len(const uint8_t* inp, const Cfg& c, int lane, int t,
                          int src, int width) {
  long long cap = (long long)c.S * c.T;
  long long cur = (long long)lane * c.T + t, row_end = (long long)(lane + 1) * c.T;
  long long base = max(src, 0);
  for (int l = 0; l < width; l += 64) {
    uint64_t diff[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      diff[u] = load8(inp, cap, cur + l + 8 * u, row_end) ^
                load8(inp, cap, base + l + 8 * u, cap);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (diff[u])
        return min(l + 8 * u + ((__ffsll((long long)diff[u]) - 1) >> 3), width);
  }
  return width;
}

// Every alive lane's bucket row, read by its warp (coalesced, eight rows
// in flight): positions into the lane's row of pos, and each entry's
// prefix score against the lane's next four bytes (own) into its row of
// score: the number of leading bytes of the 4-byte prefix cache that
// match, -1 for an empty slot.  Returns the lane's fill.  Call with the
// warp converged.
static __device__ int warp_load_scored_rows(const int* rolz, int d, bool want,
                                     uint32_t rctx, uint32_t own, int* pos,
                                     int8_t* score, int pitch) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, wbase = threadIdx.x & ~31;
  const unsigned wanted = __ballot_sync(full, want);
  int fill = 0;
  for (int g = 0; g < 32; g += 8) {
    if (!((wanted >> g) & 0xFFu)) continue;
    int2 v[8][3];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      uint32_t r = __shfl_sync(full, rctx, g + u);
      bool w = (wanted >> (g + u)) & 1u;
      const int2* row = reinterpret_cast<const int2*>(rolz) + (size_t)r * d;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        int j = lane + 32 * m;
        v[u][m] = (w && j < d) ? row[j] : make_int2(0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (!((wanted >> (g + u)) & 1u)) continue;
      const uint32_t own_l = __shfl_sync(full, own, g + u);
      const size_t off = (size_t)(wbase + g + u) * pitch;
      int cnt = 0;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        int j = lane + 32 * m;
        if (j < d) {
          int p = v[u][m].x;
          uint32_t diff = (uint32_t)v[u][m].y ^ own_l;
          int sc = ((diff & 0xFFu) == 0) + ((diff & 0xFFFFu) == 0) +
                   ((diff & 0xFFFFFFu) == 0) + (diff == 0);
          pos[off + j] = p;
          score[off + j] = (int8_t)(p > 0 ? sc : -1);
          cnt += p > 0;
        }
      }
      cnt = __reduce_add_sync(full, cnt);
      if (lane == g + u) fill = cnt;
    }
  }
  return fill;
}
