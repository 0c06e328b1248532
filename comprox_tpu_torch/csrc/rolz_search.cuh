// Byte windows and a lane's quad of threads, shared by the encoder scans
// that read a bucket table: the rank scan (K5, rank.cu) and the search
// scans (KS and KSx, search.cu), which copy a step's bucket rows into
// shared tiles and scan them four threads a lane; the window compare also
// serves mode P's whole-block candidate pass (K13c, lzpcand.cu), which
// measures every step's candidate before crp's modeling scan runs.
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

// ---- a lane's quad: K5's and the search scans' rows, four threads a lane ----

// A lane's threads (TPL consecutive ones of a warp): this thread's quarter
// q, and the mask for their shuffles.
template <int TPL>
struct Quad {
  int q;
  unsigned mask;
  __device__ Quad() : q(threadIdx.x % TPL),
                      mask(((1u << TPL) - 1u) << ((threadIdx.x & 31) & ~(TPL - 1))) {}
  template <typename T>
  __device__ __forceinline__ T sum(T v) const {
#pragma unroll
    for (int o = 1; o < TPL; o <<= 1) v += __shfl_xor_sync(mask, v, o);
    return v;
  }
};

// This thread's pairs (2p, 2p+1), p = q, q + TPL, ..., of a lane's bucket
// row into the lane's column col of a tile of `batch` columns, the pair at
// int4 [p][col]: 16-byte copies where the row is 16-byte aligned (D even),
// else 8-byte ones.
template <int TPL>
static __device__ __forceinline__ void row_to_tile(int4* tile, int batch, int col,
                                                   const int2* row, int d, int q) {
  for (int p = q; 2 * p < d; p += TPL) {
    int4* dst = tile + p * batch + col;
    if ((d & 1) == 0) {
      const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(row + 2 * p)
                   : "memory");
    } else {
      for (int h = 0; h < 2 && 2 * p + h < d; ++h) {
        const unsigned a = (unsigned)__cvta_generic_to_shared(reinterpret_cast<int2*>(dst) + h);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(a), "l"(row + 2 * p + h)
                     : "memory");
      }
    }
  }
}

// (p, j) after (pb, jb) in (position, slot) order.
static __device__ __forceinline__ bool after(int p, int j, int pb, int jb) {
  return p > pb || (p == pb && j > jb);
}

// The slot of the rank-th oldest entry (rank < d) of the lane's insert row
// in (position, slot) order: rank + 1 passes, each the least entry after
// the last one picked (each thread its pairs, then the lane's least).
template <int TPL>
static __device__ int insert_slot(const int4* col, int batch, int d, int rank,
                                  const Quad<TPL>& quad) {
  int P = INT_MIN, J = -1;
  for (int round = 0; round <= rank; ++round) {
    int bp = INT_MAX, bj = d;
    for (int p = quad.q; 2 * p < d; p += TPL) {
      const int4 v = col[p * batch];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = h ? v.z : v.x, j = 2 * p + h;
        const bool better = j < d && after(e, j, P, J) && (e < bp || (e == bp && j < bj));
        bp = better ? e : bp;
        bj = better ? j : bj;
      }
    }
#pragma unroll
    for (int o = 1; o < TPL; o <<= 1) {
      const int op = __shfl_xor_sync(quad.mask, bp, o), oj = __shfl_xor_sync(quad.mask, bj, o);
      const bool better = op < bp || (op == bp && oj < bj);
      bp = better ? op : bp;
      bj = better ? oj : bj;
    }
    P = bp;
    J = bj;
  }
  return J;
}

// The grid of a launch of S lanes, tpl threads a lane, over at most
// max_ctas CTAs (a cluster above one; at least 32 threads a CTA, at most
// 1024: more CTAs where they need them).
static inline ScanGrid quad_grid(int S, int tpl, int max_ctas) {
  const int n = S * tpl;
  const int ctas = max(min(max_ctas, n / 32), max(scan_grid(n).ctas, 1));
  return ScanGrid{ctas, ((n + ctas - 1) / ctas + 31) / 32 * 32};
}

// Lanes of a warp whose `rows` tiles are in flight together: the most
// whose tiles fit the CTA's shared memory beside its static arrays.
static inline int tile_batch(int threads, int tpl, int d, int rows) {
  const size_t per_lane = (size_t)rows * ((d + 1) / 2) * sizeof(int4);
  int b = 32 / tpl;
  while (b > 1 && (size_t)(threads / 32) * b * per_lane > CPX_POS_SMEM_MAX) b /= 2;
  return b;
}
