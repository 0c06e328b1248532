// K5: the rank scan of the flexible-parse encode.
//
// Replaces comprox_tpu/codec/block.py::_rolz_rank_body (1188-1252), run
// under lax.scan by _rolz_rank_scan (1265-1283).  Per step and lane: read
// the context's bucket row; for each of the finder's proposals (K4), is
// its source in the row and at which recency rank; one bucket candidate of
// its own, the entry with the best (prefix-cache score, recency), compared
// against the lane's upcoming bytes over the whole window; then the shared
// position-driven bucket insert.
//
// Bound on the H100: one cluster of CTAs walks T dependent steps (the
// bucket insert is ordered by lane across the whole block), so the kernel
// is latency bound — a step's global-memory round trips, its per-lane row
// scans and its barriers — not bandwidth bound: a step moves about
// S * (D * 8 * 2 + 8 * n_cands + window) bytes.  The design:
// - Both rows of a lane are known at step start: the search row (context
//   ctx4) and the insert row (ctx4bn, the older register shifted, which
//   does not depend on this step's byte), and both are read as step t-1
//   left them.  So the lanes post their insert keys first (lane_rank's
//   filter, ppm_r.cuh), one barrier makes them visible together with step
//   t-1's stores, and then every row of the step is read at once: two
//   barriers a step, one round trip for all rows.
// - Each lane has four threads (a quad; one above 2048 lanes, where the
//   CTAs would pass 1024 threads).  They copy the lane's two rows by
//   cp.async (16 bytes, two entries, a copy; thread q the pairs q, q + 4,
//   ...) into the lane's column of two tiles in shared memory,
//   entry-pair-major ([D/2][B] of int4, the B lanes of its warp), read
//   back with no bank conflict.  Each thread scans its pairs as two
//   independent chains (even and odd slots) and the quad merges by
//   shuffles: the fill, each proposal's equal and greater counts (with c
//   entries equal to the wanted position and G above it, the ranks of
//   those c entries are G, G+1, ..., G+c-1, so their sum — what the JAX
//   code computes, duplicates and the empty-slot case included — is
//   c*G + c*(c-1)/2: no recency matrix), and the entry with the largest
//   (prefix-cache score, position, slot) as a 32-bit key kept by max and
//   selects (no branch an entry); a second pass gives that entry's
//   recency, rank + 1 passes the rank-th oldest entry of the insert row.
// - The launch is split over K5_CTAS CTAs (a cluster), each on an SM of
//   its own, so that a step's scans run on that many SMs.
// - The window compare runs only where the candidate's 4-byte cache
//   matched; each of the quad's threads compares 64 bytes with all its
//   loads in flight, so a window of up to 256 bytes is one round trip.
#include "rolz_search.cuh"

namespace {

#define K5_MAX_CANDS 7  // block.py::MAX_CANDS
// CTAs of a launch of at most 1024 lanes (above 1, a cluster): fixed by
// the measurement of benchmarks/phases.py (`split`), which builds a
// variant at each count.
#ifndef K5_CTAS
#define K5_CTAS 8
#endif
// Threads a lane up to 2048 lanes (a quad: each scans a quarter of the
// lane's rows and compares a quarter of its window); one above.
#define K5_TPL 4

// An instrumented build (-DCPX_K5_PROF, which the main path's build does
// not use; benchmarks/phases.py) stamps the SM clock at the end of each of
// K5's phases (ppm_r.cuh::PhaseClock), and takes the slowest thread's
// time in each phase between the two barriers (SlowestClock).
#define K5_PHASES 10
#ifdef CPX_K5_PROF
__device__ unsigned long long k5_prof[3 * K5_PHASES];
#define K5_STAMP(k) clk_.mark(k); slow_.mark(k);
#else
#define K5_STAMP(k)
#endif

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

// The lane's search row: the fill, each proposal's equal and greater
// counts, and the entry with the largest (prefix score, position, slot) —
// the JAX rank key score*D + (D-1-recency), unique per slot: the positions
// are below 2^28 (cpx_k5_launch) and an empty entry (position 0, score -1)
// holds its slot in the position's place, so key = (score + 2) << 28 |
// position orders the entries like that triple but for the slot of equal
// keys, the later slot winning; then that entry's recency rank.  The
// same on the lane's threads.
struct SearchScan {
  int fill, rec, eq[K5_MAX_CANDS], gt[K5_MAX_CANDS];
  unsigned best;
  int slot;
};

static __device__ __forceinline__ unsigned entry_key(int p, uint32_t y, int j, uint32_t own) {
  // matching low bytes of the 4-byte cache: ctz / 8, 4 where all match
  const unsigned sc = (unsigned)__clz(__brev(y ^ own)) >> 3;
  return p > 0 ? ((sc + 2u) << 28) | (unsigned)p : (1u << 28) | (unsigned)j;
}

template <int TPL>
static __device__ SearchScan scan_search(const int4* col, int batch, int d, int n_c,
                                         uint32_t own, const int (&want)[K5_MAX_CANDS],
                                         const Quad<TPL>& quad) {
  SearchScan r{};
  // this thread's pairs, the even and the odd entries as two chains
  int fill_o = 0, eq_o[K5_MAX_CANDS] = {}, gt_o[K5_MAX_CANDS] = {};
  unsigned best_o = 0;
  int slot_o = 0;
#pragma unroll 2
  for (int p = quad.q; 2 * p < d; p += TPL) {
    const int4 v = col[p * batch];
    const int j = 2 * p;
    const unsigned ke = entry_key(v.x, (uint32_t)v.y, j, own);
    r.slot = ke >= r.best ? j : r.slot;
    r.best = max(r.best, ke);
    r.fill += v.x > 0;
    const bool odd = j + 1 < d;
    const unsigned ko = odd ? entry_key(v.z, (uint32_t)v.w, j + 1, own) : 0u;
    slot_o = ko >= best_o && odd ? j + 1 : slot_o;
    best_o = max(best_o, ko);
    fill_o += odd && v.z > 0;
#pragma unroll
    for (int k = 0; k < K5_MAX_CANDS; ++k) {
      if (k >= n_c) break;
      r.eq[k] += v.x == want[k];
      r.gt[k] += v.x > want[k];
      eq_o[k] += odd && v.z == want[k];
      gt_o[k] += odd && v.z > want[k];
    }
  }
  // the chains and the lane's threads merged: the larger key, the later
  // slot on a tie
  bool take = best_o > r.best || (best_o == r.best && slot_o > r.slot);
  r.best = take ? best_o : r.best;
  r.slot = take ? slot_o : r.slot;
#pragma unroll
  for (int o = 1; o < TPL; o <<= 1) {
    const unsigned b = __shfl_xor_sync(quad.mask, r.best, o);
    const int sl = __shfl_xor_sync(quad.mask, r.slot, o);
    take = b > r.best || (b == r.best && sl > r.slot);
    r.best = take ? b : r.best;
    r.slot = take ? sl : r.slot;
  }
  r.fill = quad.sum(r.fill + fill_o);
#pragma unroll
  for (int k = 0; k < K5_MAX_CANDS; ++k) {
    if (k >= n_c) break;
    r.eq[k] = quad.sum(r.eq[k] + eq_o[k]);
    r.gt[k] = quad.sum(r.gt[k] + gt_o[k]);
  }
  const int pb = r.best >> 28 == 1 ? 0 : (int)(r.best & 0x0FFFFFFFu);
  int rec = 0;
#pragma unroll 2
  for (int p = quad.q; 2 * p < d; p += TPL) {
    const int4 v = col[p * batch];
    rec += after(v.x, 2 * p, pb, r.slot);
    rec += 2 * p + 1 < d && after(v.z, 2 * p + 1, pb, r.slot);
  }
  r.rec = quad.sum(rec);
  return r;
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

template <int MAXT, bool CL, int TPL>
__global__ void __launch_bounds__(MAXT) k5_kernel(Cfg c, const uint8_t* __restrict__ inp,
                          const int* __restrict__ props, int* __restrict__ rolz,
                          int* __restrict__ out, int batch) {
  __shared__ __align__(16) int keys[MAXT / TPL];  // this CTA's lanes' insert keys
  __shared__ unsigned keyf[2][KEYF_N];       // their filter, by step parity
  extern __shared__ __align__(16) int dyn[];  // the warps' row tiles
  const Quad<TPL> quad;
  const int li = gtid() / TPL, wl = (threadIdx.x & 31) / TPL;  // lane, its column
  const bool alive = li < c.S, lead = quad.q == 0;
  const int d = c.rolz_depth, dq = (d + 1) / 2;
  const int n_c = c.n_cands;
  const int len_cap = min(c.window, c.min_len + LEN_W - 1);
  const size_t plane = (size_t)c.T * c.S;
  // this warp's search tile, then its insert tile, [dq][batch] int4 each
  int4* const stile = reinterpret_cast<int4*>(dyn) + (size_t)(threadIdx.x >> 5) * 2 * dq * batch;
  int4* const itile = stile + (size_t)dq * batch;
  uint32_t ctx4 = 0, ctx4b = 0;
  keyf_init(keyf[0]);
  keyf_init(keyf[1]);
#ifdef CPX_K5_PROF
  __shared__ unsigned long long prof_[3 * K5_PHASES];
  __shared__ unsigned prof_max_[K5_PHASES];
  PhaseClock<K5_PHASES> clk_;
  SlowestClock<K5_PHASES> slow_;
  clk_.start(prof_);
  slow_.start(prof_ + 2 * K5_PHASES, prof_max_);
#endif
  group_sync<CL>();

  for (int t = 0; t < c.T; ++t) {
    const int pos = li * c.T + t;
    const bool active = alive && pos < c.n;
    const size_t o = (size_t)t * c.S + li;
    const long long cur = (long long)li * c.T + t, row_end = (long long)(li + 1) * c.T;
    uint32_t own = 0;
    int prop_len[K5_MAX_CANDS], want[K5_MAX_CANDS];
#pragma unroll
    for (int k = 0; k < K5_MAX_CANDS; ++k) prop_len[k] = want[k] = 0;
    if (alive) {
      own = (uint32_t)load8(inp, (long long)c.S * c.T, cur, row_end);
#pragma unroll
      for (int k = 0; k < K5_MAX_CANDS; ++k) {
        if (k >= n_c) break;
        prop_len[k] = props[(size_t)(2 * k) * plane + o];
        want[k] = props[(size_t)(2 * k + 1) * plane + o] + 1;
      }
    }
    // both rows are known now: the insert key comes from the older
    // register (position pos-3's context), not from this step's byte
    const uint32_t ctx4bn = active ? (ctx4b << 8) | (ctx4 >> 24) : ctx4b;
    const int ins_key = insert_here(c, active, t, pos)
                            ? (int)rolz_hash3(rolz_key(ctx4bn, c.rolz_ctx_bytes), c.rolz_bits)
                            : -1;
    const uint32_t rs = rolz_hash3(rolz_key(ctx4, c.rolz_ctx_bytes), c.rolz_bits);
    unsigned* const filt = keyf[t & 1];
    key_post<TPL>(keys, filt, lead ? ins_key : -1, SALT_INS);
    K5_STAMP(0)
    group_sync<CL>();  // the keys posted; step t-1's stores visible
    K5_STAMP(1)

    SearchScan mine{};
    int slot = -1, rank = d;
    const int2* const rows = reinterpret_cast<const int2*>(rolz);
    for (int b0 = 0; b0 < 32 / TPL; b0 += batch) {
      // this batch of the warp's lanes: both rows of each in flight
      const bool in_batch = wl >= b0 && wl < b0 + batch;
      if (in_batch && alive)
        row_to_tile<TPL>(stile, batch, wl - b0, rows + (size_t)rs * d, d, quad.q);
      if (in_batch && ins_key >= 0)
        row_to_tile<TPL>(itile, batch, wl - b0, rows + (size_t)ins_key * d, d, quad.q);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      if (b0 == 0) {
        // the insert ranks while the rows fly
        const int r = __shfl_sync(0xffffffffu,
                                  lane_rank<CL, TPL>(keys, filt, lead ? ins_key : -1, SALT_INS, d),
                                  (threadIdx.x & 31) & ~(TPL - 1));
        rank = ins_key >= 0 ? r : d;
      }
      K5_STAMP(2)
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncwarp();  // the lane's other threads' copies landed too
      K5_STAMP(3)
      const int4* const scol = stile + wl % batch;
      if (in_batch && alive) mine = scan_search<TPL>(scol, batch, d, n_c, own, want, quad);
      K5_STAMP(4)
      if (in_batch && rank < d) slot = insert_slot<TPL>(itile + wl % batch, batch, d, rank, quad);
      K5_STAMP(5)
      __syncwarp();  // the tiles are free for the next batch
    }
    // every row of the step read: the barrier before the stores, whose
    // wait comes after the window compare and the grids, which read and
    // write nothing another thread writes or reads this step
#ifdef CPX_K5_PROF
    slow_.publish(2, 5);
#endif
    group_arrive<CL>();

    if (alive) {
      const bool live = active && t >= 7;
      const int sc_b = (int)(mine.best >> 28) - 2;
      const int src_b = (sc_b < 0 ? 0 : (int)(mine.best & 0x0FFFFFFFu)) - 1;
      int len_b = 0;
      if (sc_b == 4 && live) {
        const int cap = max(min(min(c.T - t, c.n - pos), len_cap), 0);
        len_b = min(prefix_len<TPL>(inp, c, li, t, src_b, c.window, quad.q, quad.mask), cap);
      }
      K5_STAMP(6)
      // the lane's grids, its threads a plane in turn
      for (int g = quad.q; g < 3 * n_c + 4; g += TPL) {
        const int k = g / 3, f = g % 3;
        int v;
        if (k == n_c) {
          v = f == 0 ? len_b : f == 1 ? src_b : mine.rec;
        } else if (g == 3 * n_c + 3) {
          v = mine.fill;
        } else {
          int eq = 0, gt = 0, pl = 0, wk = 0;
#pragma unroll
          for (int u = 0; u < K5_MAX_CANDS; ++u)
            if (u == k) {
              eq = mine.eq[u];
              gt = mine.gt[u];
              pl = prop_len[u];
              wk = want[u];
            }
          v = f == 0 ? (eq > 0 && live && pl > 0 ? pl : 0)
              : f == 1 ? wk - 1
                       : eq * gt + eq * (eq - 1) / 2;
        }
        out[(size_t)g * plane + o] = v;
      }
    }
    K5_STAMP(7)
    group_wait<CL>();
    K5_STAMP(8)
#ifdef CPX_K5_PROF
    slow_.collect(2, 5);
#endif
    // the byte is used only now: its load flew through the step
    const uint32_t ctx4n = active ? (ctx4 << 8) | (own & 0xFFu) : ctx4;
    if (lead && slot >= 0) bucket_store(rolz, c, (uint32_t)ins_key, slot, pos, byteswap32(ctx4n));
    if (lead) key_clear(filt, ins_key, SALT_INS);
    ctx4 = ctx4n;
    ctx4b = ctx4bn;
    K5_STAMP(9)
  }
#ifdef CPX_K5_PROF
  clk_.flush(k5_prof);
  slow_.flush(k5_prof + 2 * K5_PHASES);
#endif
  if (CL) group_sync<CL>();  // no CTA leaves while another may read its keys
}

// The launch's threads a lane: K5_TPL up to 2048 lanes, else one.
static int k5_tpl(int S) { return S <= 2048 ? K5_TPL : 1; }

// The launch's grid: the lanes' threads over K5_CTAS CTAs (a cluster; at
// least 32 threads a CTA, at most 1024: more CTAs where they need them).
static ScanGrid k5_grid(int S) {
  const int n = S * k5_tpl(S);
  const int ctas = max(min(K5_CTAS, n / 32), max(scan_grid(n).ctas, 1));
  return ScanGrid{ctas, ((n + ctas - 1) / ctas + 31) / 32 * 32};
}

// Lanes of a warp whose rows are in flight together: the most whose two
// tiles fit the CTA's shared memory beside its static arrays.
static int k5_batch(int threads, int tpl, int d) {
  const size_t per_lane = (size_t)2 * ((d + 1) / 2) * sizeof(int4);
  int b = 32 / tpl;
  while (b > 1 && (size_t)(threads / 32) * b * per_lane > CPX_POS_SMEM_MAX) b /= 2;
  return b;
}

// The kernel arm whose CTA holds g.threads: its registers fit the CTA
// (launch bounds).  A cluster's CTAs each take an SM of their own (a CTA
// asks for more than half of one's shared memory): the split is there to
// spread the lanes' scans over SMs.
template <bool CL, int TPL>
static int k5_launch_arm(const ScanGrid& g, void* stream, const Cfg& c, const uint8_t* inp,
                         const int* props, int* rolz, int* out) {
  const int batch = k5_batch(g.threads, TPL, c.rolz_depth);
  size_t smem = (size_t)(g.threads / 32) * batch * 2 * ((c.rolz_depth + 1) / 2) * sizeof(int4);
  if (CL) smem = max(smem, (size_t)CPX_SMEM_MAX / 2 + 4096);
#define K5_ARM(T)                                                                      \
  if (g.threads <= T)                                                                  \
    return launch_scan(k5_kernel<T, CL, TPL>, g, smem, stream, c, inp, props, rolz, out, \
                       batch);
  if constexpr (CL && TPL > 1) {
    K5_ARM(128)
    K5_ARM(256)
    K5_ARM(512)
  }
  if constexpr (!CL) K5_ARM(128)
  if constexpr (CL) K5_ARM(CPX_MAX_LANES)
#undef K5_ARM
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int cpx_k5_launch(const int* cfg, const void* inp, const void* props,
                             void* rolz, void* out, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.n_cands < 1 || c.n_cands > K5_MAX_CANDS) return (int)cudaErrorInvalidValue;
  if ((long long)c.S * c.T >= (1LL << 28)) return (int)cudaErrorInvalidValue;  // SearchScan
  const ScanGrid g = k5_grid(c.S);
  const uint8_t* in = (const uint8_t*)inp;
  const int* pr = (const int*)props;
  if (k5_tpl(c.S) == 1)
    return k5_launch_arm<true, 1>(g, stream, c, in, pr, (int*)rolz, (int*)out);
  return g.ctas > 1 ? k5_launch_arm<true, K5_TPL>(g, stream, c, in, pr, (int*)rolz, (int*)out)
                    : k5_launch_arm<false, K5_TPL>(g, stream, c, in, pr, (int*)rolz, (int*)out);
}

#ifdef CPX_K5_PROF
// The instrumented build's phase sums (3 * K5_PHASES counters of SM
// cycles: thread 0's, the last thread's, then the slowest thread's in each
// phase between the barriers, summed over every launch since the last
// call): copied into out, then set to 0.
extern "C" int cpx_k5_prof_read(void* out) {
  return prof_read(out, k5_prof, sizeof(k5_prof));
}
#endif
