// Byte-window and scored-row reads shared by the encoder scans that search
// a bucket table: the search scans (KS and KSx, search.cu) and, for its
// byte loads, the rank scan (K5, rank.cu); the window compare also serves
// mode P's whole-block candidate pass (K13c, lzpcand.cu), which measures
// every step's candidate before crp's modeling scan runs.
#pragma once

#include <climits>

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

// 8 bytes at byte shift sh (0..56) of the aligned words lo, hi, those at
// or past `valid` zeroed (load8's rule).
static __device__ __forceinline__ uint64_t bytes8(uint64_t lo, uint64_t hi, int sh,
                                                  long long valid) {
  const uint64_t v = sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
  if (valid >= 8) return v;
  return valid <= 0 ? 0 : v & ((1ull << (8 * valid)) - 1);
}

// Common prefix (up to width) of the lane's upcoming bytes, zero past its
// row, and the block bytes at src, zero past the block: 64 bytes a thread
// and round, the nine aligned words of each side loaded together (indices
// clamped into the buffer, the bytes past a limit masked, so no load waits
// on a branch), then eight 8-byte compares, the first difference by its
// lowest set bit.  With TPL threads a lane (K5), thread q of the lane's
// takes bytes 64 q.. of a round and the first difference is their least
// (shuffles over `mask`, the lane's threads, which all call it).  A
// candidate buffer `cand` of cand_cap bytes (8-byte aligned, cand_cap a
// multiple of 8) takes the block's place for the bytes at src: K5's chain
// arm reads its sources from the [prev | cur] window.
template <int TPL = 1>
static __device__ int prefix_len(const uint8_t* inp, const Cfg& c, int lane, int t,
                          int src, int width, int q = 0, unsigned mask = 0,
                          const uint8_t* cand = nullptr, long long cand_cap = 0) {
  const long long cap = (long long)c.S * c.T, nw = cap >> 3;
  const long long cur = (long long)lane * c.T + t, row_end = (long long)(lane + 1) * c.T;
  const long long base = max(src, 0);
  const uint64_t* w = reinterpret_cast<const uint64_t*>(inp);
  const uint64_t* wc = cand ? reinterpret_cast<const uint64_t*>(cand) : w;
  const long long ccap = cand ? cand_cap : cap, nwc = ccap >> 3;
  const int sa = (int)(cur & 7) * 8, sb = (int)(base & 7) * 8;
  for (int l0 = 0; l0 < width; l0 += 64 * TPL) {
    const int l = l0 + 64 * q;
    int first = width;
    if (l < width) {
      const long long ka = (cur + l) >> 3, kb = (base + l) >> 3;
      uint64_t a[9], b[9];
#pragma unroll
      for (int u = 0; u < 9; ++u) {
        a[u] = __ldg(w + min(ka + u, nw - 1));
        b[u] = __ldg(wc + min(kb + u, nwc - 1));
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const uint64_t diff = bytes8(a[u], a[u + 1], sa, row_end - (cur + l + 8 * u)) ^
                              bytes8(b[u], b[u + 1], sb, ccap - (base + l + 8 * u));
        if (diff) {
          first = l + 8 * u + ((__ffsll((long long)diff) - 1) >> 3);
          break;
        }
      }
    }
#pragma unroll
    for (int o = 1; o < TPL; o <<= 1) first = min(first, __shfl_xor_sync(mask, first, o));
    if (first < width) return first;
  }
  return width;
}

// The longest match that may start at lane i's step t: to the end of the
// lane, of the block and of what the format codes (below 0 past the block).
static __device__ __forceinline__ int len_cap_at(const Cfg& c, int i, int t) {
  return min(min(c.T - t, c.n - (i * c.T + t)), min(c.window, c.min_len + LEN_W - 1));
}

// Every alive lane's bucket row, read by its warp (coalesced, eight rows
// in flight): positions into the lane's row of pos, and each entry's
// prefix score against the lane's next four bytes (own) into its row of
// score: the number of leading bytes of the 4-byte prefix cache that
// match, -1 for an empty slot and for an entry at or after the lane's
// fwd_limit (KSx: the lane's position; a distance cannot name it).  Returns
// the lane's fill.  Call with the warp converged.
static __device__ int warp_load_scored_rows(const int* rolz, int d, bool want,
                                     uint32_t rctx, uint32_t own, int* pos,
                                     int8_t* score, int pitch,
                                     int fwd_limit = INT_MAX) {
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
      const int limit_l = __shfl_sync(full, fwd_limit, g + u);
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
          score[off + j] = (int8_t)(p > 0 && p - 1 < limit_l ? sc : -1);
          cnt += p > 0;
        }
      }
      cnt = __reduce_add_sync(full, cnt);
      if (lane == g + u) fill = cnt;
    }
  }
  return fill;
}

// top_k <= 8 (the CLI's -m maps to 1..8; block.py::search_scan checks it)
#define KS_TOPK_MAX 8

// The best entry of the lane's scored bucket row (block.py::_rolz_best_match
// after the row read): the top k_top entries by (score, position, slot),
// each whose 4-byte prefix matched probed to c.probe bytes, the first
// longest extended to the full window, capped.
struct BestMatch {
  int length, src, slot;
};

static __device__ BestMatch rolz_best(const uint8_t* inp, const Cfg& c, int i, int t,
                                      const int* pos_row, const int8_t* score_row,
                                      uint64_t own8) {
  const int d = c.rolz_depth, k_top = min(c.top_k, d);
  const long long cur = (long long)i * c.T + t, row_end = (long long)(i + 1) * c.T;
  // the top k_top entries by (score, position, slot), descending: the
  // JAX rank key score*D + (D-1-recency), unique per slot.  A sorted
  // list of packed keys (score+2) << 40 | position << 8 | slot, which
  // order like those triples (positions < 2^31, slots < 2^8); an entry
  // that does not beat the last kept key is skipped.
  unsigned long long top[KS_TOPK_MAX];
#pragma unroll
  for (int u = 0; u < KS_TOPK_MAX; ++u) top[u] = 0;  // below every key
  for (int s = 0; s < d; ++s) {
    const unsigned long long key =
        ((unsigned long long)(score_row[s] + 2) << 40) |
        ((unsigned long long)(unsigned)pos_row[s] << 8) | (unsigned)s;
    if (key <= top[KS_TOPK_MAX - 1]) continue;
#pragma unroll
    for (int u = KS_TOPK_MAX - 1; u > 0; --u)
      top[u] = key > top[u - 1] ? top[u - 1] : (key > top[u] ? key : top[u]);
    top[0] = key > top[0] ? key : top[0];
  }
  // probe the candidates whose 4-byte prefix matched (score 4); with
  // probe <= 32, one 32-byte window each, all loads in flight together
  const long long cap_n = (long long)c.S * c.T;
  uint64_t cw[4];
  cw[0] = own8;
#pragma unroll
  for (int u = 1; u < 4; ++u)
    cw[u] = c.probe <= 32 ? load8(inp, cap_n, cur + 8 * u, row_end) : 0;
  BestMatch best{-1, 0, 0};
#pragma unroll
  for (int k = 0; k < KS_TOPK_MAX; ++k) {
    if (k >= k_top) break;
    const int sc = (int)(top[k] >> 40) - 2, slot = (int)(top[k] & 0xFFu);
    const int src_k = (int)((top[k] >> 8) & 0x7FFFFFFFu) - 1;
    int len_k = 0;
    if (sc == 4 && c.probe <= 32) {
      len_k = c.probe;
      const long long sb = max(src_k, 0);
#pragma unroll
      for (int u = 3; u >= 0; --u) {
        uint64_t diff = load8(inp, cap_n, sb + 8 * u, cap_n) ^ cw[u];
        if (diff) len_k = 8 * u + ((__ffsll((long long)diff) - 1) >> 3);
      }
      len_k = min(len_k, c.probe);
    } else if (sc == 4) {
      len_k = prefix_len(inp, c, i, t, src_k, c.probe);
    }
    if (len_k > best.length) best = BestMatch{len_k, src_k, slot};  // first maximum (argmax)
  }
  if (best.length >= c.probe)
    best.length = prefix_len(inp, c, i, t, best.src, c.window);
  best.length = min(best.length, len_cap_at(c, i, t));
  return best;
}
