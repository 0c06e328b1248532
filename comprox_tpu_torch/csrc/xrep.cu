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
//             unless the byte at pos equals the byte prev[t] back, that
//             source is in the block and at an earlier step of its lane
//             (the decoder's lanes run in lock-step), and pos < n; else 1
//             plus len_rep[t + 1] where prev[t + 1] == prev[t] (a run
//             restarts where the expected distance changes; past the last
//             step the distance counts as 1); capped at min(T - t, n - pos,
//             the length cap).
// The JAX code gathers both byte grids whole and scans them reversed; here
// each lane walks its own row once forward and once backward.
//
// Bound on the H100: per lane two dependent walks of T steps with almost
// no arithmetic, so latency times 2 T bounds it, not the bytes (it reads
// 2 int32 and 2 bytes and writes 2 int32 per position).  Lanes are
// independent: one thread per lane, a warp per CTA, so that S = 512 lanes
// spread over 16 SMs and a warp's loads of one step are one coalesced row.
#include "ppm_r.cuh"

namespace {

__global__ void k11_kernel(Cfg c, const uint8_t* __restrict__ inp,
                           const int* __restrict__ dec, int* __restrict__ out,
                           const int* __restrict__ bn, int dec_grids) {
  // block blockIdx.y of the launch: its n, bytes, decisions and grids
  blk_n(c, bn);
  inp = at_blk(inp, (long long)c.S * c.T);
  dec = at_blk(dec, (long long)dec_grids * c.S * c.T);
  out = at_blk(out, 2LL * c.S * c.T);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= c.S) return;
  const size_t plane = (size_t)c.T * c.S;
  const int* const take = dec + lane;
  const int* const src = dec + plane + lane;
  int* const len_rep = out + lane;
  int* const prev_arr = out + plane + lane;
  const int base = lane * c.T;
  const int len_cap = min(c.window, c.min_len + LEN_W - 1);
  int rem = 0, prev = 1;
  for (int t = 0; t < c.T; ++t) {
    const size_t o = (size_t)t * c.S;
    const int tk = take[o], sr = src[o];
    prev_arr[o] = prev;
    const bool start = rem == 0 && tk > 0;
    if (start) prev = max(base + t - sr, 1);
    rem = rem > 0 ? rem - 1 : (start ? tk - 1 : 0);
  }
  int rl = 0, prev_next = 1;
  for (int t = c.T - 1; t >= 0; --t) {
    const size_t o = (size_t)t * c.S;
    const int pos = base + t;
    const int prev_t = prev_arr[o];
    const int src_rep = pos - prev_t;
    const bool eq = pos < c.n && src_rep >= 0 && src_rep % c.T < t &&
                    inp[pos] == inp[src_rep];
    rl = eq ? 1 + (prev_next == prev_t ? rl : 0) : 0;
    prev_next = prev_t;
    len_rep[o] = min(rl, max(min(min(c.T - t, c.n - pos), len_cap), 0));
  }
}

}  // namespace

// inp [S, T] u8; dec [dec_grids >= 2, T, S] (take, src); out [2, T, S]
// (len_rep, prev).  G blocks (the block axis): each [G, ...] and bn [G]
// (null: one block).
extern "C" int cpx_k11_launch(const int* cfg, int G, const void* bn, int dec_grids,
                              const void* inp, const void* dec, void* out, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (dec_grids < 2 || G < 1 || G > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  k11_kernel<<<dim3((c.S + threads - 1) / threads, G), threads, 0, (cudaStream_t)stream>>>(
      c, (const uint8_t*)inp, (const int*)dec, (int*)out, (const int*)bn, dec_grids);
  return (int)cudaGetLastError();
}
