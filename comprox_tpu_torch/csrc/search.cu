// KS: the ROLZ search scan of the greedy (-f0) encode; KSx: the search scan
// of mode X under CPX_X_FINDER=scan.  One kernel template; X selects KSx.
//
// KS replaces comprox_tpu/codec/block.py::_search_body (1333-1388, R branch)
// with _rolz_best_match (939-1056), run under lax.scan by _search_and_parse
// (1630-1635).  Per step and lane: read the context's bucket row, score
// every entry by its 4-byte prefix cache, take the top-k by (score,
// recency), probe each to `probe` bytes, extend the winner to the full
// window, cap; then the shared position-driven bucket insert.
//
// KSx replaces the X branch (1351-1383) and the X inserts of _post_step
// (623-639): three candidates a lane a step — the best entry of the bucket
// of the position's own next 8 bytes (x_hash8), the best entry of the
// bucket of its preceding context (mode R's key, a second table), each
// without the entries at or after the position (masked before the top-k),
// and the entry of a 2^16-slot cache keyed by the next 6 bytes (xshort,
// read before any lane's scatter-max insert of the step).  Then two
// lane-ranked bucket inserts: position pos-7 under its own 8 bytes, and
// position pos-3 under its context.  Output: six grids (length, src, len2,
// cand, len3, src3), the price DP's three (len, src) candidates.
//
// Bound on the H100: a cluster of CTAs walks T dependent steps (the bucket
// inserts are ordered by lane across the whole block), so the kernel is
// latency bound — a step's round trips, its per-lane row scans and its
// barriers — not bandwidth bound: a step moves about S * (D * 8 * 2 +
// 32 * top_k + window) bytes (KSx: four rows and three windows).  The
// design is K5's (rank.cu):
// - Every row key of a step is known when it starts, from input bytes
//   alone: the search row's (KS: the context ctx4; KSx also x_hash8 of the
//   lane's own next 8 bytes) and the insert rows' (ctx4bn, the older
//   register shifted; KSx's content key of position pos-7 from ctx4bn and
//   ctx4n).  So the lanes post their insert keys (lane_rank's filter), one
//   barrier makes them visible together with step t-1's stores, and every
//   row of the step (KS two, KSx four, and KSx's near-match cache word) is
//   copied at once by cp.async into the lane's column of tiles in shared
//   memory, entry-pair-major ([D/2][lanes] of int4), read back with no bank
//   conflict.  The insert slot is the rank-th oldest slot of the copied
//   insert row, which was read before any write of this step
//   (bucket_slot's rule): one round trip for the rows and two barriers a
//   step, the second split around the probes (arrive, probes, wait).  The
//   lane's next 32 bytes are loaded a step ahead.
// - The lanes of a hot context share one insert row and take its rank-th
//   oldest slot, rank + 1 rounds each, and the slowest lane sets the step;
//   so each thread packs its entries once into 32-bit keys and a round is
//   a compare, a select and a minimum an entry.
// - Four threads a lane (a quad; one above 2048 lanes).  Each scores its
//   quarter of a row and keeps its own top-k of packed (score, position,
//   slot) keys, sized to top_k (4 or 8); the quad merges them by k rounds
//   of a maximum over shuffles.  The fill and the candidates' recency
//   ranks are quad sums over a second pass.
// - The candidates whose 4-byte cache matched are probed one or two a
//   thread (top_k <= 4, 8), their 32-byte windows in flight together (a
//   probe above 32 bytes takes prefix_len); the first longest in top-k
//   order wins and is extended by the quad's prefix_len, 64 bytes a
//   thread: the 250-byte window in one round.
// - The launch is split over KS_CTAS CTAs (a cluster; 256 threads a CTA at
//   S = 512), each on an SM of its own, so that a step's scans run on that
//   many SMs.
#include "rolz_search.cuh"

namespace {

#define KS_CTAS 8  // CTAs of a launch of at most 1024 lanes' threads: K5_CTAS
#define KS_TPL 4       // threads a lane up to 2048 lanes; one above
#define KS_TOPK_MAX 8  // top_k <= 8 (the CLI's -m maps to 1..8; block.py::search_scan checks it)
#define X_INSERT_LATE 7  // KSx: the content-keyed entry of position q, at step q + 7
// the most pairs of a row a quad's thread holds (D <= CPX_MAX_DEPTH)
#define KS_PAIRS ((CPX_MAX_DEPTH / 2 + KS_TPL - 1) / KS_TPL)

// An instrumented build (-DCPX_KS_PROF, which the main path's build does
// not use; benchmarks/phases.py) stamps the SM clock at the end of each
// phase (ppm_r.cuh::PhaseClock) on thread 0 and on the launch's last
// thread: one stamp set for both kernels, each its own counters.
#define KS_PHASES 11
#ifdef CPX_KS_PROF
__device__ unsigned long long ks_prof[2 * KS_PHASES];
__device__ unsigned long long ksx_prof[2 * KS_PHASES];
#define KS_STAMP(k) clk_.mark(k);
#else
#define KS_STAMP(k)
#endif

// The bucket of a position's own next 8 bytes (block.py::x_hash8).
static __device__ __forceinline__ uint32_t x_hash8(uint32_t nx4, uint32_t fol4, int bits) {
  uint32_t v = (nx4 * 0x9E3779B1u) ^ (fol4 * 0x85EBCA77u);
  return (v >> (32 - bits)) & ((1u << bits) - 1u);
}

// The near-match cache's slot of a position's next 6 bytes (block.py::x_hash6).
static __device__ __forceinline__ uint32_t x_hash6(uint64_t own) {
  uint32_t h = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) h = (h * 123456791u) ^ (uint32_t)((own >> (8 * j)) & 0xFFu);
  return (h ^ (h >> 15)) & 0xFFFFu;
}

// An entry's rank key, (score + 2) << 40 | position << 8 | slot: ordered
// like the JAX rank key score*D + (D-1-recency), unique per slot.  The
// score is the matching low bytes of the 4-byte prefix cache (4: all),
// -1 for an empty slot and for an entry at or after `limit` (KSx: the
// lane's position; a distance cannot name it).
static __device__ __forceinline__ unsigned long long entry_key(int p, uint32_t y, int j,
                                                               uint32_t own, int limit) {
  const unsigned sc = (unsigned)__clz(__brev(y ^ own)) >> 3;
  const unsigned s2 = p > 0 && p - 1 < limit ? sc + 2u : 1u;
  return ((unsigned long long)s2 << 40) | ((unsigned long long)(unsigned)p << 8) | (unsigned)j;
}

// A key into a descending list of K, if it beats the last.
template <int K>
static __device__ __forceinline__ void topk_insert(unsigned long long (&top)[K],
                                                   unsigned long long key) {
  if (key <= top[K - 1]) return;
#pragma unroll
  for (int u = K - 1; u > 0; --u)
    top[u] = key > top[u - 1] ? top[u - 1] : (key > top[u] ? key : top[u]);
  top[0] = key > top[0] ? key : top[0];
}

// The candidate k of a list (k the same on every thread of the unrolled
// loops that call it: selects, no local memory).
template <typename V, int K>
static __device__ __forceinline__ V pick(const V (&a)[K], int k) {
  V v = 0;
#pragma unroll
  for (int u = 0; u < K; ++u) v = u == k ? a[u] : v;
  return v;
}

static __device__ __forceinline__ int key_src(unsigned long long key) {
  return (int)((key >> 8) & 0x7FFFFFFFu) - 1;
}

// The lane's search row in its tile column: each of the quad's threads
// its pairs into its own top K, then K rounds of the quad's maximum, each
// taken off its owner's list -> the top k_top keys, descending, on every
// thread of the quad (0 past k_top).  Returns the row's fill.
template <int TPL, int K>
static __device__ int scan_top(const int4* col, int batch, int d, uint32_t own, int limit,
                               int k_top, const Quad<TPL>& quad,
                               unsigned long long (&cand)[K]) {
  unsigned long long mine[K];
#pragma unroll
  for (int u = 0; u < K; ++u) mine[u] = 0;  // below every key
  int fill = 0;
  for (int p = quad.q; 2 * p < d; p += TPL) {
    const int4 v = col[p * batch];
    topk_insert(mine, entry_key(v.x, (uint32_t)v.y, 2 * p, own, limit));
    fill += v.x > 0;
    if (2 * p + 1 < d) {
      topk_insert(mine, entry_key(v.z, (uint32_t)v.w, 2 * p + 1, own, limit));
      fill += v.z > 0;
    }
  }
#pragma unroll
  for (int r = 0; r < K; ++r) {
    cand[r] = 0;
    if (r >= k_top) continue;  // the same on the quad's threads
    unsigned long long m = mine[0];
#pragma unroll
    for (int o = 1; o < TPL; o <<= 1) {
      const unsigned long long v = __shfl_xor_sync(quad.mask, m, o);
      m = v > m ? v : m;
    }
    cand[r] = m;
    const bool won = mine[0] == m;  // keys are unique: one owner
#pragma unroll
    for (int u = 0; u < K - 1; ++u) mine[u] = won ? mine[u + 1] : mine[u];
    mine[K - 1] = won ? 0 : mine[K - 1];
  }
  return quad.sum(fill);
}

// Each candidate's recency rank in the row (the entries after it in
// (position, slot) order), on every thread of the quad.
template <int TPL, int K>
static __device__ void cand_recency(const int4* col, int batch, int d, int k_top,
                                    const unsigned long long (&cand)[K], const Quad<TPL>& quad,
                                    int (&rec)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) rec[k] = 0;
  for (int p = quad.q; 2 * p < d; p += TPL) {
    const int4 v = col[p * batch];
    const bool odd = 2 * p + 1 < d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k >= k_top) break;
      const int P = (int)(unsigned)(cand[k] >> 8), J = (int)(cand[k] & 0xFFu);
      rec[k] += after(v.x, 2 * p, P, J) + (odd && after(v.z, 2 * p + 1, P, J));
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < k_top) rec[k] = quad.sum(rec[k]);
}

// The common prefix (up to probe <= 32) of the lane's next 32 bytes cw
// (zero past its row) and the block's bytes at sb >= 0 (zero past the
// block): five aligned loads, four 8-byte compares.
static __device__ __forceinline__ int probe32(const uint8_t* inp, long long cap, long long sb,
                                              const uint64_t (&cw)[4], int probe) {
  const uint64_t* w = reinterpret_cast<const uint64_t*>(inp);
  const long long k = sb >> 3, nw = cap >> 3;
  const int sh = (int)(sb & 7) * 8;
  uint64_t a[5];
#pragma unroll
  for (int u = 0; u < 5; ++u) a[u] = __ldg(w + min(k + u, nw - 1));
  int len = probe;
#pragma unroll
  for (int u = 3; u >= 0; --u) {
    const uint64_t diff = bytes8(a[u], a[u + 1], sh, cap - (sb + 8 * u)) ^ cw[u];
    if (diff) len = 8 * u + ((__ffsll((long long)diff) - 1) >> 3);
  }
  return min(len, probe);
}

// The first longest of the k_top candidates (the argmax in top-k order),
// each whose 4-byte cache matched probed to c.probe bytes, candidate k on
// the quad's thread k % TPL: (length, k) on every thread of the quad.
template <int TPL, int K>
static __device__ int2 probe_best(const uint8_t* inp, const Cfg& c, int li, int t,
                                  const uint64_t (&cw)[4], const unsigned long long (&cand)[K],
                                  int k_top, const Quad<TPL>& quad) {
  const long long cap = (long long)c.S * c.T;
  unsigned best = 0;
#pragma unroll
  for (int u = 0; u < (K + TPL - 1) / TPL; ++u) {
    const int k = quad.q + u * TPL;
    const unsigned long long key = pick(cand, k);
    int len = 0;
    if (k < k_top && (int)(key >> 40) == 6) {  // score 4
      const int src = key_src(key);
      len = c.probe <= 32 ? probe32(inp, cap, max(src, 0), cw, c.probe)
                          : prefix_len(inp, c, li, t, src, c.probe);
    }
    if (k < k_top) best = max(best, ((unsigned)len << 4) | (unsigned)(15 - k));
  }
#pragma unroll
  for (int o = 1; o < TPL; o <<= 1) best = max(best, __shfl_xor_sync(quad.mask, best, o));
  return make_int2((int)(best >> 4), 15 - (int)(best & 15u));
}

// The slot of the rank-th oldest entry (rank < d) of the lane's insert row
// in (position, slot) order, with each of the thread's entries packed once
// into a 32-bit key position << 7 | slot (positions below 2^25; a larger
// block takes insert_slot's rounds): rank + 1 rounds, each the least key at or
// above the last pick + 1 (a compare, a select and a minimum an entry),
// then the quad's least.  E: the most pairs a thread holds.
template <int TPL, int E>
static __device__ int insert_slot32(const int4* col, int batch, int d, int rank,
                                    const Quad<TPL>& quad) {
  unsigned key[2 * E];
#pragma unroll
  for (int u = 0; u < E; ++u) {
    const int p = quad.q + u * TPL;
    const int4 v = 2 * p < d ? col[p * batch] : make_int4(0, 0, 0, 0);
    key[2 * u] = 2 * p < d ? ((unsigned)v.x << 7) | (unsigned)(2 * p) : ~0u;
    key[2 * u + 1] = 2 * p + 1 < d ? ((unsigned)v.z << 7) | (unsigned)(2 * p + 1) : ~0u;
  }
  unsigned lo = 0, best = 0;
  for (int round = 0; round <= rank; ++round) {
    best = ~0u;
#pragma unroll
    for (int e = 0; e < 2 * E; ++e) best = min(best, key[e] >= lo ? key[e] : ~0u);
#pragma unroll
    for (int o = 1; o < TPL; o <<= 1) best = min(best, __shfl_xor_sync(quad.mask, best, o));
    lo = best + 1;
  }
  return (int)(best & 127u);
}

template <int MAXT, bool CL, int TPL, int K, bool X>
__global__ void __launch_bounds__(MAXT, 1) search_kernel(Cfg c, const uint8_t* __restrict__ inp,
                                                      int* __restrict__ tab0,
                                                      int* __restrict__ tab1,
                                                      int* __restrict__ xshort,
                                                      int* __restrict__ out, int batch) {
  constexpr int R = X ? 2 : 1;  // tables searched, each also inserted into
  __shared__ __align__(16) int keys[R][MAXT / TPL];  // this CTA's lanes' insert keys
  __shared__ unsigned keyf[2][KEYF_N];                // their filter, by step parity
  __shared__ int near[X ? MAXT / TPL : 1];            // KSx: each lane's cache word
  extern __shared__ __align__(16) int dyn[];          // the warps' row tiles
  const Quad<TPL> quad;
  const int li = gtid() / TPL, wl = (threadIdx.x & 31) / TPL, cl = threadIdx.x / TPL;
  const bool alive = li < c.S, lead = quad.q == 0;
  const int d = c.rolz_depth, dq = (d + 1) / 2, k_top = min(c.top_k, d);
  const long long cap = (long long)c.S * c.T;
  const bool packed = cap < (1LL << 25);  // positions fit insert_slot32's keys
  const size_t plane = (size_t)c.T * c.S;
  int* const tabs[2] = {tab0, tab1};
  const unsigned salt[2] = {SALT_INS, SALT_INS2};
  // this warp's tiles, [dq][batch] int4 each: the R search rows, then the
  // R insert rows
  int4* const tiles = reinterpret_cast<int4*>(dyn) + (size_t)(threadIdx.x >> 5) * 2 * R * dq * batch;
  uint32_t ctx4 = 0, ctx4b = 0;
  // the lane's next 32 bytes, zero past its row; nx: the next step's
  uint64_t cw[4], nx[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    cw[u] = alive ? load8(inp, cap, (long long)li * c.T + 8 * u, (long long)(li + 1) * c.T) : 0;
  keyf_init(keyf[0]);
  keyf_init(keyf[1]);
#ifdef CPX_KS_PROF
  __shared__ unsigned long long prof_[2 * KS_PHASES];
  PhaseClock<KS_PHASES> clk_;
  clk_.start(prof_);
#endif
  group_sync<CL>();

  for (int t = 0; t < c.T; ++t) {
    const int pos = li * c.T + t;
    const bool active = alive && pos < c.n;
    const size_t o = (size_t)t * c.S + li;
    const long long cur = (long long)li * c.T + t, row_end = (long long)(li + 1) * c.T;
    // every key of the step, from bytes already known
    const uint32_t own = (uint32_t)cw[0];
    const uint32_t ctx4bn = active ? (ctx4b << 8) | (ctx4 >> 24) : ctx4b;
    const uint32_t ctx4n = active ? (ctx4 << 8) | (own & 0xFFu) : ctx4;
    const uint32_t rctx = rolz_hash3(rolz_key(ctx4, c.rolz_ctx_bytes), c.rolz_bits);
    const int ctx_key = (int)rolz_hash3(rolz_key(ctx4bn, c.rolz_ctx_bytes), c.rolz_bits);
    uint32_t rs[R], h6 = 0;
    int ins[R];
    if constexpr (X) {
      rs[0] = x_hash8(own, (uint32_t)(cw[0] >> 32), c.rolz_bits);
      rs[1] = rctx;
      // position q = pos-7 under its own 8 bytes: q..q+3 = byteswap(ctx4bn)
      ins[0] = active && t >= 10
                   ? (int)x_hash8(byteswap32(ctx4bn), byteswap32(ctx4n), c.rolz_bits) : -1;
      // position q = pos-3 under its context, by mode R's rule undecimated
      ins[1] = active && t >= (c.rolz_ctx_bytes == 4 ? 7 : 6) ? ctx_key : -1;
      h6 = x_hash6(cw[0]);
    } else {
      rs[0] = rctx;
      ins[0] = insert_here(c, active, t, pos) ? ctx_key : -1;
    }
    unsigned* const filt = keyf[t & 1];
#pragma unroll
    for (int r = 0; r < R; ++r) key_post<TPL>(keys[r], filt, lead ? ins[r] : -1, salt[r]);
    KS_STAMP(0)
    group_sync<CL>();  // the keys posted; step t-1's stores visible
    KS_STAMP(1)
    // the next step's bytes, in flight with this step's rows
#pragma unroll
    for (int u = 0; u < 4; ++u) nx[u] = alive ? load8(inp, cap, cur + 1 + 8 * u, row_end) : 0;

    unsigned long long cand[R][K];
    int rec[K], fill = 0, rank[R], slot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rank[r] = d;
      slot[r] = -1;
    }
    for (int b0 = 0; b0 < 32 / TPL; b0 += batch) {
      // this batch of the warp's lanes: every row of each in flight
      const bool in_batch = wl >= b0 && wl < b0 + batch;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int2* const rows = reinterpret_cast<const int2*>(tabs[r]);
        if (in_batch && alive)
          row_to_tile<TPL>(tiles + (size_t)r * dq * batch, batch, wl - b0,
                           rows + (size_t)rs[r] * d, d, quad.q);
        if (in_batch && ins[r] >= 0)
          row_to_tile<TPL>(tiles + (size_t)(R + r) * dq * batch, batch, wl - b0,
                           rows + (size_t)ins[r] * d, d, quad.q);
      }
      if constexpr (X) {
        if (b0 == 0 && alive && lead) {
          const unsigned a = (unsigned)__cvta_generic_to_shared(near + cl);
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(xshort + h6)
                       : "memory");
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      if (b0 == 0) {
        // the insert ranks while the rows fly
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int rk = __shfl_sync(
              0xffffffffu,
              lane_rank<CL, TPL>(keys[r], filt, lead ? ins[r] : -1, salt[r], d),
              (threadIdx.x & 31) & ~(TPL - 1));
          rank[r] = ins[r] >= 0 ? rk : d;
        }
      }
      KS_STAMP(2)
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncwarp();  // the lane's other threads' copies landed too
      KS_STAMP(3)
      const int col = wl % batch;
      if (in_batch && alive) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int4* const scol = tiles + (size_t)r * dq * batch + col;
          const int f = scan_top<TPL, K>(scol, batch, d, own, X ? pos : INT_MAX, k_top, quad,
                                         cand[r]);
          if (!X) {
            fill = f;
            cand_recency<TPL, K>(scol, batch, d, k_top, cand[r], quad, rec);
          }
        }
      }
      KS_STAMP(4)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int4* const icol = tiles + (size_t)(R + r) * dq * batch + col;
        if (in_batch && rank[r] < d) {
          if constexpr (TPL > 1)
            slot[r] = packed ? insert_slot32<TPL, KS_PAIRS>(icol, batch, d, rank[r], quad)
                             : insert_slot<TPL>(icol, batch, d, rank[r], quad);
          else
            slot[r] = insert_slot<TPL>(icol, batch, d, rank[r], quad);
        }
      }
      KS_STAMP(5)
      __syncwarp();  // the tiles are free for the next batch
    }
    // every row of the step read: the barrier before the stores, whose
    // wait comes after the probes, the windows and the grids, which read
    // and write nothing another thread writes or reads this step
    group_arrive<CL>();

    if (alive) {
      const bool live = active && t >= 7;
      int2 pb[R];
#pragma unroll
      for (int r = 0; r < R; ++r) pb[r] = probe_best<TPL, K>(inp, c, li, t, cw, cand[r], k_top, quad);
      KS_STAMP(6)
      int len[R], src[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        src[r] = key_src(pick(cand[r], pb[r].y));
        len[r] = pb[r].x;
        if (len[r] >= c.probe)
          len[r] = prefix_len<TPL>(inp, c, li, t, src[r], c.window, quad.q, quad.mask);
        len[r] = min(len[r], len_cap_at(c, li, t));
      }
      int near_c = 0, len2 = 0;
      if constexpr (X) {
        // the near-match cache, as the step found it
        near_c = near[cl] - 1;
        if (near_c >= 0 && near_c < pos && live)
          len2 = prefix_len<TPL>(inp, c, li, t, near_c, c.window, quad.q, quad.mask);
        len2 = min(len2, len_cap_at(c, li, t));  // below 0 past the block
      }
      KS_STAMP(7)
      // the lane's grids, its threads a plane in turn
      constexpr int NG = X ? 6 : 4;
      for (int g = quad.q; g < NG; g += TPL) {
        int v;
        if constexpr (X) {
          const int r = g < 4 ? 0 : 1;
          const int sr = r ? src[1] : src[0], lr = r ? len[1] : len[0];
          v = g == 2   ? len2
              : g == 3 ? near_c
              : (g & 1) ? sr
                        : (sr >= 0 && sr < pos && live ? lr : 0);
        } else {
          v = g == 0 ? (live ? len[0] : 0) : g == 1 ? src[0] : g == 2 ? pick(rec, pb[0].y) : fill;
        }
        out[(size_t)g * plane + o] = v;
      }
      KS_STAMP(8)
    }
    group_wait<CL>();
    KS_STAMP(9)
    if (lead) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (slot[r] >= 0) {
          if (X && r == 0)
            bucket_store(tabs[r], c, (uint32_t)ins[r], slot[r], pos, byteswap32(ctx4bn),
                         X_INSERT_LATE);
          else
            bucket_store(tabs[r], c, (uint32_t)ins[r], slot[r], pos, byteswap32(ctx4n));
        }
        key_clear(filt, ins[r], salt[r]);
      }
      if (X && active) atomicMax(&xshort[h6], pos + 1);
    }
    ctx4 = ctx4n;
    ctx4b = ctx4bn;
#pragma unroll
    for (int u = 0; u < 4; ++u) cw[u] = nx[u];
    KS_STAMP(10)
  }
#ifdef CPX_KS_PROF
  clk_.flush(X ? ksx_prof : ks_prof);
#endif
  if (CL) group_sync<CL>();  // no CTA leaves while another may read its keys
}

// The launch's threads a lane: KS_TPL up to 2048 lanes, else one.
static int ks_tpl(int S) { return S <= 2048 ? KS_TPL : 1; }

// The kernel arm whose CTA holds g.threads (launch bounds: its registers
// fit the CTA).  A cluster's CTAs each take an SM of their own (a CTA asks
// for more than half of one's shared memory).
template <bool CL, int TPL, int K, bool X>
static int ks_arm(const ScanGrid& g, void* stream, const Cfg& c, const uint8_t* inp, int* t0,
                  int* t1, int* xs, int* out) {
  constexpr int R = X ? 2 : 1;
  const int batch = tile_batch(g.threads, TPL, c.rolz_depth, 2 * R);
  size_t smem = (size_t)(g.threads / 32) * batch * 2 * R * ((c.rolz_depth + 1) / 2) * sizeof(int4);
  if (CL) smem = max(smem, (size_t)CPX_SMEM_MAX / 2 + 4096);
#define KS_ARM(T)                                                                            \
  if (g.threads <= T)                                                                        \
    return launch_scan(search_kernel<T, CL, TPL, K, X>, g, smem, stream, c, inp, t0, t1, xs, \
                       out, batch);
  if constexpr (TPL > 1) KS_ARM(256)
  if constexpr (CL && TPL > 1) KS_ARM(512)
  if constexpr (CL) KS_ARM(CPX_MAX_LANES)
#undef KS_ARM
  return (int)cudaErrorInvalidValue;
}

template <int K, bool X>
static int ks_launch_k(const Cfg& c, void* stream, const uint8_t* inp, int* t0, int* t1, int* xs,
                       int* out) {
  const int tpl = ks_tpl(c.S);
  const ScanGrid g = quad_grid(c.S, tpl, KS_CTAS);
  if (tpl == 1) return ks_arm<true, 1, K, X>(g, stream, c, inp, t0, t1, xs, out);
  return g.ctas > 1 ? ks_arm<true, KS_TPL, K, X>(g, stream, c, inp, t0, t1, xs, out)
                    : ks_arm<false, KS_TPL, K, X>(g, stream, c, inp, t0, t1, xs, out);
}

template <bool X>
static int ks_launch(const int* cfg, const void* inp, void* t0, void* t1, void* xs, void* out,
                     void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.top_k < 1 || c.top_k > KS_TOPK_MAX || c.rolz_depth > CPX_MAX_DEPTH)
    return (int)cudaErrorInvalidValue;
  const uint8_t* in = (const uint8_t*)inp;
  return c.top_k <= 4
             ? ks_launch_k<4, X>(c, stream, in, (int*)t0, (int*)t1, (int*)xs, (int*)out)
             : ks_launch_k<8, X>(c, stream, in, (int*)t0, (int*)t1, (int*)xs, (int*)out);
}

}  // namespace

// Mode R: the bucket table [2^bits, D, 2] (updated in place) -> out [4, T, S].
extern "C" int cpx_ks_launch(const int* cfg, const void* inp, void* rolz, void* out,
                             void* stream) {
  return ks_launch<false>(cfg, inp, rolz, nullptr, nullptr, out, stream);
}

// Mode X: the content-keyed and the context-keyed bucket table
// [2^bits, D, 2], the cache xshort [2^16] (all updated in place) ->
// out [6, T, S].
extern "C" int cpx_ksx_launch(const int* cfg, const void* inp, void* ent_x, void* ent_c,
                              void* xshort, void* out, void* stream) {
  return ks_launch<true>(cfg, inp, ent_x, ent_c, xshort, out, stream);
}

#ifdef CPX_KS_PROF
// The instrumented build's phase sums (2 * KS_PHASES counters of SM
// cycles: thread 0's, then the launch's last thread's, summed over every
// launch since the last call), KS's or KSx's: copied into out, then set
// to 0.
extern "C" int cpx_ks_prof_read(void* out) { return prof_read(out, ks_prof, sizeof(ks_prof)); }
extern "C" int cpx_ksx_prof_read(void* out) {
  return prof_read(out, ksx_prof, sizeof(ksx_prof));
}
#endif
