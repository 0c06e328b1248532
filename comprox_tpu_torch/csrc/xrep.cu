// K11: the repeat-distance pass of mode X's flexible parse.
//
// Replaces comprox_tpu/codec/block.py::_sim_prev_dist (1507-1526) and
// _rep_lengths (1529-1559).  Given the first parse's decisions (take, src),
// per lane:
//   forward   prev[t] = the distance the lane holds BEFORE position t when
//             the modeling scan executes the decisions: a decision starts
//             a copy only outside a running copy, and then sets the
//             distance max(pos - src, 1); the distance starts at 1;
//   backward  len_rep[t] = the length of the match at distance prev[t]: 0
//             unless eq[t] (the byte at pos equals the byte prev[t] back,
//             that source is in the block and at an earlier step of its
//             lane (the decoder's lanes run in lock-step), and pos < n);
//             else 1 plus len_rep[t + 1] where prev[t + 1] == prev[t] (a
//             run restarts where the expected distance changes; past the
//             last step the distance counts as 1); capped at min(T - t,
//             n - pos, the length cap).
//
// Bound on the H100: only the forward walk is serial (whether a decision
// starts a copy depends on the copy before it), a few operations a step;
// eq[t] does not depend on the walk, and the backward recurrence is a
// segmented suffix count.  The bytes (2 int32 and a byte read, 2 int32
// written per position) are ~0.04 ms of a full-width block.  The design: a
// CTA of 32 lanes and 32 warps.
//  - forward: warp 0, a thread a lane, reads its lanes' (take, src) from
//    tiles of 32 steps x 32 lanes that cp.async fills three tiles ahead
//    (rows of 128 bytes, 16 bytes a copy), and writes prev a row of 32
//    lanes a step;
//  - backward: the 32 warps over tiles of 32 steps from the top, a warp a
//    lane and a thread a step.  The tile's prev rows (the next tile's
//    loaded ahead, into registers) go through a 32 x 32 transpose in shared
//    memory; then each thread's eq reads its byte and the byte prev back,
//    32 consecutive bytes a warp where prev holds over the tile.  (Loading
//    the bytes a tile ahead as well measured slower on the H100.)  A step
//    continues the run of the step after it where eq and the distance
//    holds: one ballot, and each thread's run ends at the first step at or
//    above its own that does not continue (the run from the tile above,
//    carried in a register, where none does).  The capped lengths leave
//    through the transpose, a row of 32 lanes a store.
#include "ppm_r.cuh"

namespace {

#define K11_L 32   // lanes a CTA, and warps
#define K11_TF 32  // steps a tile of the forward walk
#define K11_NB 4   // tiles in its ring: this one, three landing

// An instrumented build (-DCPX_K11_PROF; benchmarks/phases.py k6stamps)
// sums the SM cycles of the forward walk and of the backward count on
// thread 0 of the launch's first CTA into k11_prof.
#define K11_PHASES 2
#ifdef CPX_K11_PROF
__device__ unsigned long long k11_prof[K11_PHASES];
#endif

__global__ void __launch_bounds__(K11_L * 32) k11_kernel(
    Cfg c, const uint8_t* __restrict__ inp, const int* __restrict__ dec, int* out,
    const int* __restrict__ bn, int dec_grids) {
  // block blockIdx.y of the launch: its n, bytes, decisions and grids
  blk_n(c, bn);
  inp = at_blk(inp, (long long)c.S * c.T);
  dec = at_blk(dec, (long long)dec_grids * c.S * c.T);
  out = at_blk(out, 2LL * c.S * c.T);
  __shared__ __align__(16) int ring[K11_NB][2][K11_TF][K11_L];
  __shared__ int tp[32][33];     // prev, [step][lane]
  __shared__ int to[32][33];     // len_rep, [step][lane]
  const unsigned full = 0xffffffffu;
  const size_t plane = (size_t)c.T * c.S;
  const int T = c.T, S = c.S;
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int lane0 = blockIdx.x * K11_L;
  int* const len_rep = out;
  int* const prev_g = out + plane;
#ifdef CPX_K11_PROF
  const bool prof_obs = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;
  long long prof_t = prof_clock();
#endif

  if (warp == 0) {  // the forward walk, lane lane0 + j
    const int lane = lane0 + j;
    const bool live = lane < S;
    const int nf = (T + K11_TF - 1) / K11_TF;
    // tile f: rows of 32 lanes (128 bytes) of take and src, steps f * K11_TF
    // on; a thread copies 16 bytes (4 lanes, chunk j % 8) of 2 * K11_TF / 4
    // rows (S is a multiple of 8: a chunk's lanes are all in the block or
    // all past it)
    const int chunk = j % 8, lane_c = lane0 + 4 * chunk;
    auto fetch = [&](int f) {
      if (f < nf && lane_c < S) {
        for (int rg = j / 8; rg < 2 * K11_TF; rg += 4) {
          const int s = rg >> 1, g = rg & 1, t = f * K11_TF + s;
          if (t < T) {
            const unsigned d =
                (unsigned)__cvta_generic_to_shared(&ring[f % K11_NB][g][s][4 * chunk]);
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                         "l"(dec + g * plane + (size_t)t * S + lane_c)
                         : "memory");
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // one group a tile
    };
    for (int f = 0; f < K11_NB - 1; ++f) fetch(f);
    const int base = lane * T;
    int* out_p = prev_g + lane;  // prev[t][lane], a row of S on a step
    int rem = 0, prev = 1;
    for (int f = 0; f < nf; ++f) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(K11_NB - 2) : "memory");  // tile f
      __syncwarp();  // every thread's copies of tile f seen; tile f - 1 read
      fetch(f + K11_NB - 1);  // into tile f - 1's slot
      const int(*const tk)[K11_L] = ring[f % K11_NB][0];
      const int(*const sr)[K11_L] = ring[f % K11_NB][1];
      const int steps = min(K11_TF, T - f * K11_TF);
#pragma unroll 16
      for (int s = 0; s < steps; ++s) {
        const int t = f * K11_TF + s;
        const int take = tk[s][j], src = sr[s][j];
        if (live) *out_p = prev;
        out_p += S;
        const bool start = rem == 0 && take > 0;
        if (start) prev = max(base + t - src, 1);
        rem = rem > 0 ? rem - 1 : (start ? take - 1 : 0);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();  // prev, written by warp 0, is visible to the CTA
#ifdef CPX_K11_PROF
  if (prof_obs) {
    const long long now = prof_clock();
    atomicAdd(&k11_prof[0], (unsigned long long)(now - prof_t));
    prof_t = now;
  }
#endif

  // backward: warp `warp` takes lane lane0 + warp, thread j step t0 + j,
  // over tiles of 32 steps from the top
  const int lane = lane0 + warp;
  const bool live = lane < S;
  const int len_cap = min(c.window, c.min_len + LEN_W - 1);
  const int nt = (T + 31) / 32;
  // row t0 + warp of the CTA's prev (1 past the block or its lanes: the
  // distance past the last step)
  auto prev_row = [&](int t0) {
    const int t = t0 + warp, ln = lane0 + j;
    return t < T && ln < S ? __ldcg(prev_g + (size_t)t * S + ln) : 1;
  };
  int pre = prev_row((nt - 1) * 32);
  int carry_rl = 0, carry_prev = 1;  // the step above the tile's last
  for (int i = nt - 1; i >= 0; --i) {
    const int t0 = i * 32;
    tp[warp][j] = pre;
    __syncthreads();
    if (i > 0) pre = prev_row(t0 - 32);  // the next tile's, while this one runs
    const int t = t0 + j;
    const int prev_t = tp[j][warp];
    const int prev_up = __shfl_down_sync(full, prev_t, 1);
    const int prev_nx = j == 31 ? carry_prev : prev_up;
    const int pos = lane * T + t;
    const int src_rep = pos - prev_t;
    const bool eq = live && t < T && pos < c.n && src_rep >= 0 && src_rep % T < t &&
                    inp[pos] == inp[src_rep];
    // a step continues the run above it where eq holds and the distance
    // stays; its run ends at the first step at or above it that does not
    // continue, or runs on into the tile above (carry_rl)
    const unsigned F = __ballot_sync(full, eq);
    const unsigned C = __ballot_sync(full, eq && prev_nx == prev_t);
    const unsigned stop = ~C & (full << j);  // steps at or above t that end a run
    int rl;
    if (stop) {
      const int e = __ffs(stop) - 1;
      rl = (e - j) + ((F >> e) & 1);
    } else {
      rl = (32 - j) + carry_rl;
    }
    carry_rl = __shfl_sync(full, rl, 0);
    carry_prev = __shfl_sync(full, prev_t, 0);
    to[j][warp] = min(rl, max(min(min(T - t, c.n - pos), len_cap), 0));
    __syncthreads();
    const int tt = t0 + warp, ln = lane0 + j;
    if (tt < T && ln < S) len_rep[(size_t)tt * S + ln] = to[warp][j];
  }
#ifdef CPX_K11_PROF
  if (prof_obs) atomicAdd(&k11_prof[1], (unsigned long long)(prof_clock() - prof_t));
#endif
}

}  // namespace

// inp [S, T] u8; dec [dec_grids >= 2, T, S] (take, src); out [2, T, S]
// (len_rep, prev).  G blocks (the block axis): each [G, ...] and bn [G]
// (null: one block).
extern "C" int cpx_k11_launch(const int* cfg, int G, const void* bn, int dec_grids,
                              const void* inp, const void* dec, void* out, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (dec_grids < 2 || c.S < 1 || c.T < 1 || G < 1 || G > 65535)
    return (int)cudaErrorInvalidValue;
  k11_kernel<<<dim3((c.S + K11_L - 1) / K11_L, G), K11_L * 32, 0, (cudaStream_t)stream>>>(
      c, (const uint8_t*)inp, (const int*)dec, (int*)out, (const int*)bn, dec_grids);
  return (int)cudaGetLastError();
}

#ifdef CPX_K11_PROF
// The instrumented build's cycles of the two walks, then cleared.
extern "C" int cpx_k11_prof_read(void* out) { return prof_read(out, k11_prof, sizeof(k11_prof)); }
#endif
