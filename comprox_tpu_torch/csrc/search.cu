// KS: the ROLZ search scan of the greedy (-f0) encode.
//
// Replaces comprox_tpu/codec/block.py::_search_body (1333-1388) with
// _rolz_best_match (939-1056), run under lax.scan by _search_and_parse
// (1630-1635).  Per step and lane: read the context's bucket row, score
// every entry by its 4-byte prefix cache, take the top-k by (score,
// recency), probe each to `probe` bytes, extend the winner to the full
// window, cap; then the shared position-driven bucket insert.
//
// Bound on the H100: one CTA walks T dependent steps, so the kernel is
// latency bound (global-memory round trips of the bucket rows and the
// byte windows, and the barriers), not bandwidth bound: a step touches
// ~S*(D*8 + 4*probe + window) bytes.  The design keeps every lane's work
// in one thread and the tables in global memory (L2 holds the hot rows);
// top-k is one pass over the row keeping a sorted list of k (score,
// position, slot) in registers, instead of the JAX O(D^2) rank matrix;
// byte windows are compared 8 bytes per pair of aligned loads instead of
// one dependent byte load at a time; insert rows are read by whole warps
// into a shared-memory copy per lane.
#include "rolz_search.cuh"

namespace {

// top_k <= 8 (the CLI's -m maps to 1..8; block.py::search_scan checks it)
#define KS_TOPK_MAX 8

template <int MAXT>
__global__ void __launch_bounds__(MAXT) ks_kernel(Cfg c, const uint8_t* __restrict__ inp,
                          int* __restrict__ rolz, int* __restrict__ out,
                          int* __restrict__ gpos, bool pos_in_smem) {
  __shared__ __align__(16) int keys[CPX_MAX_LANES];
  extern __shared__ int spos[];
  const int i = threadIdx.x;
  const bool alive = i < c.S;
  const int d = c.rolz_depth;
  const int k_top = min(c.top_k, d);
  const int len_cap = min(c.window, c.min_len + LEN_W - 1);
  uint32_t ctx4 = 0, ctx4b = 0;
  // the lanes' copies of bucket rows (the search row, then the insert row)
  // and the search row's prefix scores
  int* const posbuf = pos_in_smem ? spos : gpos;
  const int pitch = pos_pitch(d);
  int* const pos_row = posbuf + (size_t)i * pitch;
  int8_t* const scorebuf = reinterpret_cast<int8_t*>(posbuf + (size_t)c.S * pitch);
  const int8_t* const score_row = scorebuf + (size_t)i * pitch;

  for (int t = 0; t < c.T; ++t) {
    const int pos = i * c.T + t;
    const bool active = alive && pos < c.n;
    int byte = 0, ins_key = -1;
    uint32_t ctx4n = ctx4, ctx4bn = ctx4b;
    // this lane's next bytes: block[cur..row_end), zero past its row
    const long long cur = (long long)i * c.T + t, row_end = (long long)(i + 1) * c.T;
    uint32_t own = 0;
    if (alive) own = (uint32_t)load8(inp, (long long)c.S * c.T, cur, row_end);
    const int fill = warp_load_scored_rows(
        rolz, d, alive, rolz_hash3(rolz_key(ctx4, c.rolz_ctx_bytes), c.rolz_bits),
        own, posbuf, scorebuf, pitch);
    if (alive) {
      byte = (int)(own & 0xFFu);
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
#pragma unroll
      for (int u = 0; u < 4; ++u)
        cw[u] = c.probe <= 32 ? load8(inp, cap_n, cur + 8 * u, row_end) : 0;
      int best_len = -1, best_src = 0, best_rec = 0;
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
        if (len_k > best_len) {  // first maximum wins (argmax)
          best_len = len_k;
          best_src = src_k;
          best_rec = recency_rank(pos_row, d, slot);
        }
      }
      int length = best_len;
      if (length >= c.probe)
        length = prefix_len(inp, c, i, t, best_src, c.window);
      int cap = min(min(c.T - t, c.n - pos), len_cap);
      length = min(length, cap);
      if (!(active && t >= 7)) length = 0;
      size_t o = (size_t)t * c.S + i, plane = (size_t)c.T * c.S;
      out[o] = length;
      out[plane + o] = best_src;
      out[2 * plane + o] = best_rec;
      out[3 * plane + o] = fill;

      if (active) {
        ctx4n = (ctx4 << 8) | (uint32_t)byte;
        ctx4bn = (ctx4b << 8) | (ctx4 >> 24);
      }
      if (insert_here(c, active, t, pos))
        ins_key = (int)rolz_hash3(rolz_key(ctx4bn, c.rolz_ctx_bytes), c.rolz_bits);
    }
    keys[i] = ins_key;
    __syncthreads();
    int slot = bucket_slot(rolz, c, keys, ins_key, posbuf, pitch);
    __syncthreads();
    if (slot >= 0) bucket_store(rolz, c, (uint32_t)ins_key, slot, pos, byteswap32(ctx4n));
    ctx4 = ctx4n;
    ctx4b = ctx4bn;
    __syncthreads();
  }
}

}  // namespace

extern "C" int cpx_ks_launch(const int* cfg, const void* inp, void* rolz,
                             void* out, void* gpos, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  int threads = (c.S + 31) / 32 * 32;
  size_t smem = pos_smem_bytes(c, 1);
  auto kernel = threads <= 512 ? ks_kernel<512> : ks_kernel<CPX_MAX_LANES>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      c, (const uint8_t*)inp, (int*)rolz, (int*)out, (int*)gpos, smem > 0);
  return (int)cudaGetLastError();
}
