// K6: the backward price DP of the flexible-parse encode, modes R, F and X.
//
// Replaces comprox_tpu/codec/block.py::_parse_body (1414-1477) with
// _cand_min_cost (1391-1411), run under a reversed lax.scan by
// _search_and_parse (1596-1600, mode R) and by codec/fast.py::
// _fast_find_matches (265-276, mode F: the non-R branch 1435-1450 without
// a repeat pair; 1645 and 1652-1654, mode X: the same branch, the second
// time with the repeat pair 1446-1455).  One kernel, an entry per mode:
// mode R prices a candidate (len, src, recency index) by its recency bucket
// and passes the bucket fill through; mode F prices a candidate (len, src)
// by the distance bucket floor(log2(pos - src)) and writes index 0; mode X
// is mode F's entry with its own prices, and its second run takes the
// repeat pair (len_rep, prev) of K11 as two more grids: a candidate at the
// distance prev costs the repeat price, and the repeat candidate (len_rep,
// pos - prev) is tried last, so that it wins a tie.  Per lane, from the last step to the
// first: cost[t] = min(literal price + cost[t+1], over the candidates and
// every admissible length l of price + cost[t+l]); the decision at t is
// the literal, or the candidate and length that reach the minimum.  Ties:
// the longest l within a candidate, a match over the literal, a later
// candidate over an earlier one; a candidate with no admissible length
// never wins.  Costs saturate at 2^22 - 1.
//
// Bound on the H100: lanes are independent and the T steps of a lane are
// dependent, so the kernel is bound by the time of one step times T, not
// by bytes (it reads 3 * n_cands + 1 and writes 4 int32 per position) or
// by operations.  What this design does about it:
//  - one set of prefix minima a step, shared by every candidate.  A
//    candidate's price is the same at each of its lengths, so its best
//    (cost, l) over l in [lo, L] (L = min(len, window)) is its price plus
//    the minimum of cost[t+lo .. t+L], the longest l on a tie; or, where
//    that reaches 2^22 - 1, every length saturates and the longest, L,
//    wins the tie.  The minima are kept as a ring of 256 keys a lane,
//    cost * 512 + (u & 511) for the argmin u of cost[t+lo .. u], eight in
//    each thread's registers: a step enters the one new cost at the
//    window's start (its slot takes the new key, every other slot keeps
//    its key where that cost is <= the new one: the later u wins a tie)
//    and stores the ring to shared memory, where each candidate reads its
//    one key at t + L.  A candidate costs a read and a few compares, in a
//    thread of its own; one warp minimum of (cost, candidate) picks the
//    best, the later candidate on a tie;
//  - the candidates taken off the lane's chain: step t's candidates need
//    cost[t+lo ..] only, so the candidates of four steps (KG = 4, where
//    lo >= 4; one step where lo is less) are priced together before the
//    step above them is decided: four minima sets advanced and stored, one
//    warp sync, four lookups and four warp minima in flight.  A step is
//    then only its literal compare, match where the best candidate <=
//    literal + cost[t+1]: a sequential <= over (literal, candidates in
//    order) takes the last candidate that reaches the minimum, the literal
//    only when none does;
//  - the inputs loaded ahead: a CTA's four lanes share tiles of 32 steps
//    of every grid in dynamic shared memory, filled by cp.async a tile
//    ahead of their use, one pair of CTA barriers a tile; the decisions
//    leave through a tile of their own, 16 bytes a row;
//  - the lanes spread over the card: a warp a lane, four a CTA, so S = 512
//    runs 128 CTAs, about a warp per SM scheduler.
// Measured (NVIDIA H100 80GB HBM3, PERF.md): ~0.17 us a step at S = 512,
// the serial floor (16,384 literal compares of ~4 dependent operations)
// ~0.17 ms a launch.
#include "ppm_r.cuh"

namespace {

#define K6_W 4          // lanes (warps) a CTA
#define K6_D 32         // steps a tile of the inputs
#define K6_NB 3         // tiles in the ring: this one, the next, one landing
#define K6_MAX_CANDS 8  // the finder's proposals (<= 7) and the bucket's (or the repeat one)
#define K6_PLANE (K6_D * K6_W + 1)  // a grid's cells in a tile, one word against bank conflicts
#define K6_GROUP 4      // steps priced together, where the window starts that far on
#define P_INF (1 << 22)
#define K6_NONE 0x7fffffff  // a candidate with no admissible length: never the minimum
static_assert(K6_D % K6_GROUP == 0, "a group of steps lies in one tile");
static_assert((K6_W * 32) % (K6_D * K6_W) == 0, "a thread copies one cell of a tile's grids");

// An instrumented build (-DCPX_K6_PROF, which the main path's build does
// not have; benchmarks/phases.py k6stamps) stamps the SM clock at the end
// of each phase of a group of steps on one observer, thread 0 of the
// launch's first CTA, and sums each phase's cycles over the groups into
// k6_prof, which cpx_k6_prof_read copies out and clears.
#define K6_PHASES 6
#ifdef CPX_K6_PROF
__device__ unsigned long long k6_prof[K6_PHASES];
#define K6_STAMP(k)                                               \
  do {                                                            \
    if (prof_obs) {                                               \
      const long long now_ = prof_clock();                        \
      prof_sum[k] += (unsigned long long)(now_ - prof_t);         \
      prof_t = now_;                                              \
    }                                                             \
  } while (0)
#else
#define K6_STAMP(k)
#endif

// Dynamic shared memory, in ints: each lane's prefix minima of a group's
// steps [K6_W][KG][256] and costs by t & 255 [K6_W][256], the decision
// tiles [2][3][K6_PLANE] (len, src, idx), and the input tiles [K6_NB]
// [n_grids][K6_PLANE].
template <int KG>
__host__ __device__ constexpr int k6_fixed_ints() {
  return K6_W * KG * 256 + K6_W * 256 + 2 * 3 * K6_PLANE;
}

// One step's candidates: the warp's minimum key (cost * 16 + 15 - k, or
// K6_NONE), and in candidate k's thread its own (l, src, idx).
struct K6Cand {
  int key, l, src, idx;
};

template <bool FAST, int KG>
__global__ void __launch_bounds__(K6_W * 32, 4) k6_kernel(
    Cfg c, const int* __restrict__ cands, const int* __restrict__ rep,
    int* __restrict__ dec, const int* __restrict__ bn) {
  extern __shared__ __align__(16) int k6_smem[];
  const unsigned full = 0xffffffffu;
  // grids: the candidates' (and mode R's fill), then the repeat pair
  const int n_cg = FAST ? 2 * c.n_cands : 3 * (c.n_cands + 1) + 1;
  const bool has_rep = FAST && rep != nullptr;
  const int n_grids = n_cg + (has_rep ? 2 : 0);
  int(*const sm_q)[KG][256] = reinterpret_cast<int(*)[KG][256]>(k6_smem);
  int(*const sm_cost)[256] = reinterpret_cast<int(*)[256]>(k6_smem + K6_W * KG * 256);
  int(*const sm_out)[3][K6_PLANE] =
      reinterpret_cast<int(*)[3][K6_PLANE]>(k6_smem + K6_W * (KG + 1) * 256);
  int* const sm_in = k6_smem + k6_fixed_ints<KG>();  // [K6_NB][n_grids][K6_PLANE]
  const int slot_ints = n_grids * K6_PLANE;
  const int n_out = FAST ? 3 : 4;
  const int n_ct = FAST ? c.n_cands + (has_rep ? 1 : 0) : c.n_cands + 1;
  // block blockIdx.y of the launch: its n, candidates, repeat pair and
  // decisions
  blk_n(c, bn);
  cands = at_blk(cands, (long long)n_cg * c.S * c.T);
  rep = at_blk(rep, 2LL * c.S * c.T);
  dec = at_blk(dec, (long long)n_out * c.S * c.T);
  const size_t plane = (size_t)c.T * c.S;
  const int T = c.T, S = c.S;
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int lane0 = blockIdx.x * K6_W, lane = lane0 + warp;
  const bool live = lane < S;  // the whole warp; it still takes every barrier
  const int n_tiles = (T + K6_D - 1) / K6_D;
  const int lo = max(c.min_len, 1);
  const int lo_q = min(lo, c.window);  // where the prefix minima start
#ifdef CPX_K6_PROF
  const bool prof_obs = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;
  unsigned long long prof_sum[K6_PHASES] = {};
  long long prof_t = prof_clock();
#endif

  // Tile i holds steps T - 1 - K6_D * i - s, s = 0 .. K6_D - 1; a thread
  // copies (and writes out) one cell (s, w) of every gstep-th grid.
  constexpr int cells = K6_D * K6_W, gstep = K6_W * 32 / cells;
  const int cell0 = threadIdx.x % cells, g0 = threadIdx.x / cells;
  const int cs = cell0 / K6_W, cw = cell0 % K6_W;
  auto fetch = [&](int i) {
    const int t = T - 1 - i * K6_D - cs, ln = lane0 + cw;
    if (i < n_tiles && t >= 0 && ln < S) {
      const unsigned d0 = (unsigned)__cvta_generic_to_shared(
          sm_in + (i % K6_NB) * slot_ints + g0 * K6_PLANE + cell0);
      constexpr unsigned dstep = gstep * K6_PLANE * sizeof(int);
      const size_t at = (size_t)t * S + ln;
      const int* src = cands + g0 * plane + at;
      unsigned d = d0;
      int g = g0;
      for (; g < n_cg; g += gstep, src += gstep * plane, d += dstep)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
                     : "memory");
      if (has_rep) {  // the repeat pair, grids n_cg and n_cg + 1
        for (src = rep + (g - n_cg) * plane + at; g < n_cg + 2;
             g += gstep, src += gstep * plane, d += dstep)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
                       : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // one group a tile
  };
  auto landed = [] {  // every tile issued but the newest K6_NB - 3
    asm volatile("cp.async.wait_group %0;\n" ::"n"(K6_NB - 3) : "memory");
  };
  // the decisions of tile i out, and mode R's fill from its input tile
  auto flush = [&](int i) {
    const int t = T - 1 - i * K6_D - cs, ln = lane0 + cw;
    if (t >= 0 && ln < S) {
      const int* src = &sm_out[i & 1][0][cell0];
      int* dst = dec + (size_t)t * S + ln;
      for (int g = g0; g < 3; g += gstep) dst[g * plane] = src[g * K6_PLANE];
      if (!FAST && g0 == 0)
        dst[3 * plane] = sm_in[(i % K6_NB) * slot_ints + (n_cg - 1) * K6_PLANE + cell0];
    }
  };
  // this warp's cell of step t in the input tile's grid 0 (the grids
  // K6_PLANE apart, the steps below t K6_W on), and in the decision tile's
  auto in_row = [&](int t) -> const int* {
    const unsigned r = (unsigned)(T - 1 - t);
    return sm_in + (r / K6_D) % K6_NB * slot_ints + (r % K6_D) * K6_W + warp;
  };
  auto out_row = [&](int t) -> int* {
    const unsigned r = (unsigned)(T - 1 - t);
    return &sm_out[(r / K6_D) & 1][0][(r % K6_D) * K6_W + warp];
  };

  // The prefix minima of step x (window start a = x + lo_q): slot s (thread
  // s / 8, register s % 8) holds, for the u in [a, a + 255] with u = s
  // (mod 256), the key cost * 512 + (u* & 511) of the minimum of cost[a ..
  // u] and its argmin u*, the largest on a tie.  Start: step T, every cost
  // past the block 0.
  int q[8];
  {
    const int a = T + lo_q;
#pragma unroll
    for (int m = 0; m < 8; ++m) q[m] = (a + ((8 * j + m - a) & 255)) & 511;
  }
  int* const cost_ring = sm_cost[warp];
  int cost_next = 0;  // cost[t + 1]; 0 past the block

  // Candidate j's grids in a tile (thread j < n_ct; the others read grid
  // 0 and price nothing): its length, its source (the repeat candidate:
  // the distance prev) and mode R's index; the repeat pair's prev.
  const bool is_rep = has_rep && j == c.n_cands;
  const int per = FAST ? 2 : 3;
  const int jc = j < n_ct ? j : 0;
  const int o_len = (is_rep ? n_cg : per * jc) * K6_PLANE;
  const int o_src = (is_rep ? n_cg + 1 : per * jc + 1) * K6_PLANE;
  const int o_idx = (FAST ? 0 : 3 * jc + 2) * K6_PLANE;
  const int o_prev = (has_rep ? n_cg + 1 : 0) * K6_PLANE;

  // Steps x0 .. x0 - KG + 1 priced (one tile holds them): for each, the
  // minima from those of the step above (the cost at the new window start
  // u_n = x + lo_q enters: its slot takes the new key; every other slot
  // keeps its key where its cost is <= the new one), stored; then every
  // candidate of each step against them, a thread a candidate, and one
  // warp minimum a step.  Steps below 0 are priced on whatever their
  // cells hold: no step at or above 0 is decided after them.
  K6Cand cand[KG];
  auto price_group = [&](int x0) {
    int c_n[KG];
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const int u_n = x0 - k + lo_q;
      c_n[k] = u_n >= T ? 0 : cost_ring[u_n & 255];
    }
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const int u_n = x0 - k + lo_q;
      // keys are below 2^31: unsigned, the bound of a saturated cost fits
      const unsigned lim = (unsigned)(c_n[k] + 1) << 9;
      const int key_n = (c_n[k] << 9) | (u_n & 511);
      const int s_n = u_n & 255;
      const int fresh = (s_n >> 3) == j ? (s_n & 7) : 8;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        q[m] = (m != fresh && (unsigned)q[m] < lim) ? q[m] : key_n;
      int4* const qs = reinterpret_cast<int4*>(&sm_q[warp][k][8 * j]);
      qs[0] = make_int4(q[0], q[1], q[2], q[3]);
      qs[1] = make_int4(q[4], q[5], q[6], q[7]);
    }
    __syncwarp();
    K6_STAMP(1);
    const int* const row0 = in_row(x0);
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const int x = x0 - k;
      const int* const row = row0 + k * K6_W;
      const int pos = lane * T + x;
      const int lx = row[o_len], s_raw = row[o_src];
      const int ix = FAST ? 0 : row[o_idx];
      const int prev = has_rep ? row[o_prev] : 0;
      const int sx = is_rep ? pos - s_raw : s_raw;
      int pr;
      if (FAST) {  // the repeat price without a branch: no thread diverges
        const int d = max(pos - sx, 1);
        const bool at_rep = is_rep | (has_rep & (d == prev));
        pr = at_rep ? c.p_rep : c.p_rm + c.p_ri * dist_bucket(d);
      } else {
        pr = c.p_rm + c.p_ri * rec_bucket(ix);
      }
      const int L = min(lx, c.window);
      const int qk = sm_q[warp][k][(x + L) & 255];
      const int v = (qk >> 9) + pr;
      const bool sat = v >= P_INF - 1;  // every length saturates: the longest wins
      cand[k].l = sat ? L : (((qk & 511) - x) & 511);
      cand[k].key = L >= lo && j < n_ct ? (sat ? P_INF - 1 : v) * 16 + (15 - j) : K6_NONE;
      cand[k].src = sx;
      cand[k].idx = ix;
    }
    K6_STAMP(2);
#pragma unroll
    for (int k = 0; k < KG; ++k) cand[k].key = __reduce_min_sync(full, cand[k].key);
    K6_STAMP(3);
  };

  for (int k = 0; k < K6_NB - 1; ++k) fetch(k);
  landed();
  __syncthreads();
  // steps T - 1 .. T - KG priced ahead (their windows start past the
  // block: lo_q >= KG)
  if (live) price_group(T - 1);
  for (int i = 0; i < n_tiles; ++i) {
    if (i > 0) {
      landed();  // tiles i and i + 1
      __syncthreads();
      flush(i - 1);
      __syncthreads();  // tile i - 1's input slot read: free for the fetch
    }
    fetch(i + K6_NB - 1);  // into tile i - 1's slot
    K6_STAMP(5);
    if (!live) continue;
    const int t_hi = T - 1 - i * K6_D;
    for (int t0 = t_hi; t0 > t_hi - K6_D && t0 >= 0; t0 -= KG) {
      // The literal compares of steps t0 .. t0 - KG + 1 against their
      // candidates' best, each decision into the tile and cost[t] into the
      // ring: match where the best candidate <= literal + cost[t+1] (a
      // sequential <= over the literal and the candidates in order takes
      // the last candidate that reaches the minimum, the literal only when
      // none does).  A step below 0 writes cells no flush reads.
      int* const o0 = out_row(t0);
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        const int t = t0 - k;
        const K6Cand& e = cand[k];
        const int lit = c.p_lit + cost_next;
        const int best = e.key >> 4;  // K6_NONE: above any literal cost
        const bool match = best <= lit;
        const bool active = lane * T + t < c.n;
        const int cost_t = active ? min(min(lit, best), P_INF - 1) : 0;
        const int win = 15 - (e.key & 15);
        int* const o = o0 + k * K6_W;
        if (j == (match ? win : 0)) {
          o[0] = match && active ? e.l : 0;
          o[K6_PLANE] = match ? e.src : 0;
          o[2 * K6_PLANE] = match ? e.idx : 0;
        }
        cost_ring[t & 255] = cost_t;  // every thread: the one value
        cost_next = cost_t;
      }
      __syncwarp();  // cost[t0 ..] in the ring
      K6_STAMP(0);
      // the next group, t0 - KG .. t0 - 2 KG + 1: its windows start at or
      // above t0 - 2 KG + 1 + lo_q >= t0 - KG + 1, all decided
      price_group(t0 - KG);
      K6_STAMP(4);
    }
  }
  __syncthreads();
  flush(n_tiles - 1);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#ifdef CPX_K6_PROF
  if (prof_obs)
    for (int k = 0; k < K6_PHASES; ++k) atomicAdd(&k6_prof[k], prof_sum[k]);
#endif
}

template <bool FAST, int KG>
int k6_launch_kg(const Cfg& c, int G, const int* bn, const int* cands, const int* rep,
                 int* dec, cudaStream_t stream) {
  const int n_cg = FAST ? 2 * c.n_cands : 3 * (c.n_cands + 1) + 1;
  const int n_grids = n_cg + (rep != nullptr ? 2 : 0);
  const size_t bytes = (k6_fixed_ints<KG>() + (size_t)K6_NB * n_grids * K6_PLANE) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(k6_kernel<FAST, KG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 blocks((c.S + K6_W - 1) / K6_W, G);
  k6_kernel<FAST, KG><<<blocks, K6_W * 32, bytes, stream>>>(c, cands, rep, dec, bn);
  return (int)cudaGetLastError();
}

template <bool FAST>
int k6_launch(const Cfg& c, int G, const int* bn, const int* cands, const int* rep, int* dec,
              cudaStream_t stream) {
  const int lo_q = min(max(c.min_len, 1), c.window);
  // a group of KG steps is priced before the step above it is decided: its
  // windows must start KG steps on (lo_q >= KG)
  if (lo_q >= K6_GROUP) return k6_launch_kg<FAST, K6_GROUP>(c, G, bn, cands, rep, dec, stream);
  return k6_launch_kg<FAST, 1>(c, G, bn, cands, rep, dec, stream);
}

// The geometry and the prices the kernel takes: a price below 2^20 keeps
// every key of a cost below 2^22 (and a literal's cost below K6_NONE / 16)
// in 31 bits.
bool k6_config_ok(const Cfg& c, int G) {
  const int lim = 1 << 20;
  return c.window >= 1 && c.window <= 256 && c.S >= 1 && c.T >= 1 && G >= 1 && G <= 65535 &&
         c.p_lit >= 0 && c.p_lit < lim && c.p_rm >= 0 && c.p_rm < lim && c.p_ri >= 0 &&
         c.p_ri < lim && c.p_rep >= 0 && c.p_rep < lim;
}

}  // namespace

// G blocks (the block axis): every grid [G, ...] and bn [G] (null: one
// block).  Mode R: cands [3 * (n_cands + 1) + 1, T, S] -> dec [4, T, S].
extern "C" int cpx_k6_launch(const int* cfg, int G, const void* bn,
                             const void* cands, void* dec,
                             void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.n_cands < 0 || c.n_cands + 1 > K6_MAX_CANDS || !k6_config_ok(c, G))
    return (int)cudaErrorInvalidValue;
  return k6_launch<false>(c, G, (const int*)bn, (const int*)cands, nullptr, (int*)dec,
                          (cudaStream_t)stream);
}

// Modes F and X: cands [2 * n_cands, T, S] -> dec [3, T, S]; the prices in
// p_lit (literal), p_rm (match) and p_ri (per distance bucket).
extern "C" int cpx_k6f_launch(const int* cfg, int G, const void* bn,
                              const void* cands, void* dec,
                              void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.n_cands < 1 || c.n_cands > K6_MAX_CANDS || !k6_config_ok(c, G))
    return (int)cudaErrorInvalidValue;
  return k6_launch<true>(c, G, (const int*)bn, (const int*)cands, nullptr, (int*)dec,
                         (cudaStream_t)stream);
}

// Mode X with the repeat pair: as cpx_k6f_launch, and rep [2, T, S]
// (len_rep, prev) with the repeat price in p_rep.
extern "C" int cpx_k6x_launch(const int* cfg, int G, const void* bn,
                              const void* cands, const void* rep,
                              void* dec, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.n_cands < 1 || c.n_cands + 1 > K6_MAX_CANDS || !rep || !k6_config_ok(c, G))
    return (int)cudaErrorInvalidValue;
  return k6_launch<true>(c, G, (const int*)bn, (const int*)cands, (const int*)rep,
                         (int*)dec, (cudaStream_t)stream);
}

#ifdef CPX_K6_PROF
// The instrumented build's phase cycles (K6_PHASES counters), then cleared.
extern "C" int cpx_k6_prof_read(void* out) { return prof_read(out, k6_prof, sizeof(k6_prof)); }
#endif
