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
//
// The chain arm (crz -C, cpx_k5c_launch; block.py:1233-1240 and the
// ment0 of _rolz_rank_scan, 1265-1271) is the same kernel (CHAIN) with a
// window offset woff = N: bucket positions are absolute in the [prev | cur]
// window of 2N bytes (`win`, the previous block's bytes then this one's),
// so each proposal is shifted by +N where it is read (block.py:1591-1594),
// the bucket candidate's bytes come from the window, a source in the
// previous block (src < N) may not run past its end, and each insert
// lands at pos + N; the insert decimation stays on the block's own pos.
// CHAIN is a template flag, so that the unchained arm (woff = 0, the
// block's own bytes) compiles to the code it had before the chain arm.
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

// The lane's search row: the fill, each proposal's equal and greater
// counts, and the entry with the largest (prefix score, position, slot) —
// the JAX rank key score*D + (D-1-recency), unique per slot: the positions
// are below 2^28 (cpx_k5_launch, cpx_k5c_launch) and an empty entry (position 0, score -1)
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

template <int MAXT, bool CL, int TPL, bool CHAIN>
__global__ void __launch_bounds__(MAXT) k5_kernel(Cfg c, const uint8_t* __restrict__ inp,
                          const int* __restrict__ props, int* __restrict__ rolz,
                          int* __restrict__ out, int batch,
                          const uint8_t* __restrict__ win, const int* __restrict__ bn) {
  // block blockIdx.y of the launch (the chain arm takes one): its n,
  // bytes, proposals, bucket table and grids
  blk_n(c, bn);
  inp = at_blk(inp, (long long)c.S * c.T);
  props = at_blk(props, 2LL * c.n_cands * c.S * c.T);
  rolz = at_blk(rolz, 2LL * c.rolz_depth << c.rolz_bits);
  out = at_blk(out, (3LL * (c.n_cands + 1) + 1) * c.S * c.T);
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
  const int woff = CHAIN ? c.S * c.T : 0;  // the window's offset of this block
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
        want[k] = props[(size_t)(2 * k + 1) * plane + o] + 1 + woff;
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
        int cap = min(min(c.T - t, c.n - pos), len_cap);
        // a source in the previous block stops at its end (woff - src_b > 0)
        if (CHAIN && src_b < woff) cap = min(cap, woff - src_b);
        len_b = min(prefix_len<TPL>(inp, c, li, t, src_b, c.window, quad.q, quad.mask,
                                    CHAIN ? win : nullptr, 2LL * woff),
                    max(cap, 0));
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
    if (lead && slot >= 0)
      bucket_store(rolz, c, (uint32_t)ins_key, slot, pos + woff, byteswap32(ctx4n));
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

// The launch's grid: the lanes' threads over K5_CTAS CTAs (a cluster).
static ScanGrid k5_grid(int S) { return quad_grid(S, k5_tpl(S), K5_CTAS); }

// The kernel arm whose CTA holds g.threads: its registers fit the CTA
// (launch bounds).  A cluster's CTAs each take an SM of their own (a CTA
// asks for more than half of one's shared memory): the split is there to
// spread the lanes' scans over SMs.  With `clusters` set, the arm is not
// launched: *clusters is how many of its clusters the card holds at once.
template <bool CL, int TPL, bool CHAIN>
static int k5_launch_arm(const ScanGrid& g, void* stream, const Cfg& c, const uint8_t* inp,
                         const int* props, int* rolz, int* out, const uint8_t* win,
                         const int* bn, int* clusters) {
  const int batch = tile_batch(g.threads, TPL, c.rolz_depth, 2);
  size_t smem = (size_t)(g.threads / 32) * batch * 2 * ((c.rolz_depth + 1) / 2) * sizeof(int4);
  if (CL) smem = max(smem, (size_t)CPX_SMEM_MAX / 2 + 4096);
#define K5_ARM(T)                                                                           \
  if (g.threads <= T)                                                                       \
    return clusters ? scan_max_clusters(k5_kernel<T, CL, TPL, CHAIN>, g, smem, clusters)    \
                    : launch_scan(k5_kernel<T, CL, TPL, CHAIN>, g, smem, stream, c, inp,    \
                                  props, rolz, out, batch, win, bn);
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

// Every entry (CHAIN: win holds the [prev | cur] window's 2N bytes,
// 8-byte aligned; one block).  G blocks (the block axis): inp [G, S, T],
// props [G, 2 * n_cands, T, S], rolz [G, 2^bits, D, 2], out [G, 3 *
// (n_cands + 1) + 1, T, S], bn [G] (null: one block).
template <bool CHAIN>
static int k5_launch(const int* cfg, int G, const int* bn, const void* inp, const void* win,
                     const void* props, void* rolz, void* out, void* stream,
                     int* clusters = nullptr) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.n_cands < 1 || c.n_cands > K5_MAX_CANDS) return (int)cudaErrorInvalidValue;
  const long long n_win = (long long)(CHAIN ? 2 : 1) * c.S * c.T;
  if (n_win >= (1LL << 28)) return (int)cudaErrorInvalidValue;  // SearchScan's positions
  if (CHAIN && G != 1) return (int)cudaErrorInvalidValue;
  ScanGrid g = k5_grid(c.S);
  g.blocks = G;
  const uint8_t* in = (const uint8_t*)inp;
  const uint8_t* w = (const uint8_t*)win;
  const int* pr = (const int*)props;
  int* const r = (int*)rolz;
  int* const o = (int*)out;
  if (k5_tpl(c.S) == 1)
    return k5_launch_arm<true, 1, CHAIN>(g, stream, c, in, pr, r, o, w, bn, clusters);
  return g.ctas > 1
             ? k5_launch_arm<true, K5_TPL, CHAIN>(g, stream, c, in, pr, r, o, w, bn, clusters)
             : k5_launch_arm<false, K5_TPL, CHAIN>(g, stream, c, in, pr, r, o, w, bn, clusters);
}

}  // namespace

extern "C" int cpx_k5_launch(const int* cfg, int G, const void* bn, const void* inp,
                             const void* props, void* rolz, void* out, void* stream) {
  return k5_launch<false>(cfg, G, (const int*)bn, inp, nullptr, props, rolz, out, stream);
}

// The chain arm: win is the [prev | cur] window, 2N bytes; proposals,
// bucket positions and sources are window-absolute (+N).
extern "C" int cpx_k5c_launch(const int* cfg, const void* inp, const void* win,
                              const void* props, void* rolz, void* out, void* stream) {
  return k5_launch<true>(cfg, 1, nullptr, inp, win, props, rolz, out, stream);
}

// K5's clusters on the card at once for blocks of this cfg (each block a
// cluster of k5_grid's CTAs): blocks past it run in later waves.
extern "C" int cpx_k5_max_clusters(const int* cfg, int* clusters) {
  return k5_launch<false>(cfg, 1, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, clusters);
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
