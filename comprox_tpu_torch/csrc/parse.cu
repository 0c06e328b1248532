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
// dependent, so the kernel is bound by the latency of one step times T,
// not by bytes (it reads 3 * n_cands + 1 and writes 4 int32 per position)
// or by operations.  The design spreads the lanes over the card, one warp
// per lane (S = 512 gives 512 warps on 132 SMs); the lane's cost window
// (cost[t+1 .. t+window], window <= 256) is a ring of 256 ints in shared
// memory, so a step shifts nothing; the minimum over the lengths is eight
// keys per thread and one warp reduction per candidate, taken only for
// candidates long enough to be admissible (most are not); the step's
// inputs are loaded one grid per thread, a step ahead of their use.
#include "ppm_r.cuh"

namespace {

#define K6_WARPS 4
#define K6_MAX_CANDS 8  // the finder's proposals (<= 7) and the bucket's
#define P_INF (1 << 22)

template <bool FAST>
__global__ void __launch_bounds__(K6_WARPS * 32) k6_kernel(
    Cfg c, const int* __restrict__ cands, const int* __restrict__ rep,
    int* __restrict__ dec, const int* __restrict__ bn) {
  // block blockIdx.y of the launch: its n, candidates, repeat pair and
  // decisions
  const int n_grids = FAST ? 2 * c.n_cands : 3 * (c.n_cands + 1) + 1;
  blk_n(c, bn);
  cands = at_blk(cands, (long long)n_grids * c.S * c.T);
  rep = at_blk(rep, 2LL * c.S * c.T);
  dec = at_blk(dec, (FAST ? 3LL : 4LL) * c.S * c.T);
  __shared__ int ring_all[K6_WARPS][256];
  const unsigned full = 0xffffffffu;
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int lane = blockIdx.x * K6_WARPS + warp;
  if (lane >= c.S) return;  // the whole warp: no CTA barrier below
  int* const ring = ring_all[warp];
  for (int u = j; u < 256; u += 32) ring[u] = 0;  // cost past the block: 0
  __syncwarp();
  const int per = FAST ? 2 : 3;  // grids per candidate
  const int n_c = FAST ? c.n_cands : c.n_cands + 1;
  const int n_in = FAST ? 2 * n_c : 3 * n_c + 1;
  const size_t plane = (size_t)c.T * c.S;
  const int lo = max(c.min_len, 1);
  // thread j loads grid j of cands; the two after them the repeat pair
  const bool has_rep = FAST && rep != nullptr;
  const int* const mine =
      (has_rep && j >= n_in ? rep + (size_t)min(j - n_in, 1) * plane
                            : cands + (size_t)min(j, n_in - 1) * plane) + lane;
  int nxt = mine[(size_t)(c.T - 1) * c.S];
  for (int t = c.T - 1; t >= 0; --t) {
    const int in = nxt;
    if (t > 0) nxt = mine[(size_t)(t - 1) * c.S];
    int cwv[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int offs = j + 32 * m;
      cwv[m] = offs < c.window ? ring[(t + 1 + offs) & 255] : 0;
    }
    int best_cost = c.p_lit + __shfl_sync(full, cwv[0], 0);
    int best_len = 0, best_src = 0, best_idx = 0;
    const int pos = lane * c.T + t;
    const int prev = has_rep ? __shfl_sync(full, in, n_in + 1) : 0;
#pragma unroll
    for (int k = 0; k <= K6_MAX_CANDS; ++k) {
      // candidates 0 .. n_c - 1, then (k == n_c) the repeat candidate
      if (k > n_c || (k == n_c && !has_rep)) break;
      const bool is_rep = k == n_c;
      const int lx = min(__shfl_sync(full, in, is_rep ? n_in : per * k), c.window);
      if (lx < lo) continue;  // no admissible length: cost 2^22, never wins
      const int sx = is_rep ? pos - prev : __shfl_sync(full, in, per * k + 1);
      int ix = 0, price;
      if (FAST) {
        const int d = max(pos - sx, 1);
        price = c.p_rm + c.p_ri * dist_bucket(d);
        if (has_rep && (is_rep || d == prev)) price = c.p_rep;
      } else {
        ix = __shfl_sync(full, in, 3 * k + 2);
        price = c.p_rm + c.p_ri * rec_bucket(ix);
      }
      int key = P_INF * 256;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int offs = j + 32 * m;
        if (offs + 1 >= lo && offs + 1 <= lx)
          key = min(key, min(cwv[m] + price, P_INF - 1) * 256 + (255 - offs));
      }
      key = __reduce_min_sync(full, key);
      const int cost_m = key >> 8, l_m = 256 - (key & 255);
      if (cost_m <= best_cost) {
        best_len = l_m;
        best_src = sx;
        best_idx = ix;
        best_cost = cost_m;
      }
    }
    const bool active = pos < c.n;
    best_cost = active ? min(best_cost, P_INF - 1) : 0;
    if (!active) best_len = 0;
    const int fill = __shfl_sync(full, in, n_in - 1);
    __syncwarp();  // every thread has read its window entries
    if (j == 0) {
      ring[t & 255] = best_cost;
      const size_t o = (size_t)t * c.S + lane;
      dec[o] = best_len;
      dec[plane + o] = best_src;
      dec[2 * plane + o] = best_idx;
      if (!FAST) dec[3 * plane + o] = fill;
    }
    __syncwarp();
  }
}

}  // namespace

// G blocks (the block axis): every grid [G, ...] and bn [G] (null: one
// block).  Mode R: cands [3 * (n_cands + 1) + 1, T, S] -> dec [4, T, S].
extern "C" int cpx_k6_launch(const int* cfg, int G, const void* bn,
                             const void* cands, void* dec,
                             void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.n_cands + 1 > K6_MAX_CANDS || c.window > 256 || G < 1 || G > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((c.S + K6_WARPS - 1) / K6_WARPS, G);
  k6_kernel<false><<<blocks, K6_WARPS * 32, 0, (cudaStream_t)stream>>>(
      c, (const int*)cands, nullptr, (int*)dec, (const int*)bn);
  return (int)cudaGetLastError();
}

// Modes F and X: cands [2 * n_cands, T, S] -> dec [3, T, S]; the prices in
// p_lit (literal), p_rm (match) and p_ri (per distance bucket).
extern "C" int cpx_k6f_launch(const int* cfg, int G, const void* bn,
                              const void* cands, void* dec,
                              void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.n_cands < 1 || c.n_cands > K6_MAX_CANDS || c.window > 256 || G < 1 || G > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((c.S + K6_WARPS - 1) / K6_WARPS, G);
  k6_kernel<true><<<blocks, K6_WARPS * 32, 0, (cudaStream_t)stream>>>(
      c, (const int*)cands, nullptr, (int*)dec, (const int*)bn);
  return (int)cudaGetLastError();
}

// Mode X with the repeat pair: as cpx_k6f_launch, and rep [2, T, S]
// (len_rep, prev) with the repeat price in p_rep.
extern "C" int cpx_k6x_launch(const int* cfg, int G, const void* bn,
                              const void* cands, const void* rep,
                              void* dec, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.n_cands < 1 || c.n_cands + 1 > K6_MAX_CANDS || c.window > 256 || !rep || G < 1 ||
      G > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((c.S + K6_WARPS - 1) / K6_WARPS, G);
  k6_kernel<true><<<blocks, K6_WARPS * 32, 0, (cudaStream_t)stream>>>(
      c, (const int*)cands, (const int*)rep, (int*)dec, (const int*)bn);
  return (int)cudaGetLastError();
}
