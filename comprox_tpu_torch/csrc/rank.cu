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
// Bound on the H100: as KS, one CTA (or cluster) walks T dependent steps (the bucket
// insert is ordered by lane across the whole block), so the kernel is
// latency bound — a step's global-memory round trips (bucket row, window
// bytes, insert row) and its barriers — not bandwidth bound: a step moves
// about S * (D * 8 + 8 * n_cands + window) bytes.  The design keeps one
// thread per lane and the table in global memory (L2 holds the hot rows).
// Membership and rank of all proposals come from ONE pass over the row:
// with c entries equal to the wanted position and G entries above it, the
// ranks of those c entries are G, G+1, ..., G+c-1, so their sum (what the
// JAX code computes, duplicates and the empty-slot case included) is
// c*G + c*(c-1)/2 — no recency matrix.  The same pass finds the bucket
// candidate as the maximum of a packed (score, position, slot) key.  The
// window compare runs only where the candidate's 4-byte cache matched,
// 8 bytes per pair of aligned loads.
#include "rolz_search.cuh"

namespace {

#define K5_MAX_CANDS 7  // block.py::MAX_CANDS

template <int MAXT, bool CL>
__global__ void __launch_bounds__(MAXT) k5_kernel(Cfg c, const uint8_t* __restrict__ inp,
                          const int* __restrict__ props, int* __restrict__ rolz,
                          int* __restrict__ out, int* __restrict__ gpos,
                          bool pos_in_smem) {
  __shared__ __align__(16) int keys[CPX_MAX_LANES];  // this CTA's lanes'
  extern __shared__ int spos[];
  const int i = gtid();
  const bool alive = i < c.S;
  const int d = c.rolz_depth;
  const int n_c = c.n_cands;
  const int len_cap = min(c.window, c.min_len + LEN_W - 1);
  const size_t plane = (size_t)c.T * c.S;
  uint32_t ctx4 = 0, ctx4b = 0;
  const int pitch = pos_pitch(d);
  const PosBufs pb = pos_bufs<CL>(c, spos, gpos, pos_in_smem, pitch);
  int* const posbuf = pb.pos;
  const int* const pos_row = posbuf + (size_t)threadIdx.x * pitch;
  int8_t* const scorebuf = pb.score;
  const int8_t* const score_row = scorebuf + (size_t)threadIdx.x * pitch;

  for (int t = 0; t < c.T; ++t) {
    const int pos = i * c.T + t;
    const bool active = alive && pos < c.n;
    const size_t o = (size_t)t * c.S + i;
    int byte = 0, ins_key = -1;
    uint32_t ctx4n = ctx4, ctx4bn = ctx4b;
    const long long cur = (long long)i * c.T + t, row_end = (long long)(i + 1) * c.T;
    uint32_t own = 0;
    int prop_len[K5_MAX_CANDS], want[K5_MAX_CANDS];
    if (alive) {
      own = (uint32_t)load8(inp, (long long)c.S * c.T, cur, row_end);
      // the proposals' loads fly while the warp reads the bucket rows
#pragma unroll
      for (int k = 0; k < K5_MAX_CANDS; ++k) {
        if (k >= n_c) break;
        prop_len[k] = props[(size_t)(2 * k) * plane + o];
        want[k] = props[(size_t)(2 * k + 1) * plane + o] + 1;
      }
    }
    const int fill = warp_load_scored_rows(
        rolz, d, alive, rolz_hash3(rolz_key(ctx4, c.rolz_ctx_bytes), c.rolz_bits),
        own, posbuf, scorebuf, pitch);
    if (alive) {
      byte = (int)(own & 0xFFu);
      int eq[K5_MAX_CANDS], gt[K5_MAX_CANDS];
#pragma unroll
      for (int k = 0; k < K5_MAX_CANDS; ++k) eq[k] = gt[k] = 0;
      // the entry with the largest (score, position, slot): the JAX rank
      // key score*D + (D-1-recency), unique per slot
      unsigned long long best = 0;
      for (int s = 0; s < d; ++s) {
        const int pv = pos_row[s];
        const unsigned long long key =
            ((unsigned long long)(score_row[s] + 2) << 40) |
            ((unsigned long long)(unsigned)pv << 8) | (unsigned)s;
        best = key > best ? key : best;
#pragma unroll
        for (int k = 0; k < K5_MAX_CANDS; ++k) {
          if (k >= n_c) break;
          eq[k] += pv == want[k];
          gt[k] += pv > want[k];
        }
      }
      const bool live = active && t >= 7;
#pragma unroll
      for (int k = 0; k < K5_MAX_CANDS; ++k) {
        if (k >= n_c) break;
        const bool valid = eq[k] > 0 && live && prop_len[k] > 0;
        out[(size_t)(3 * k) * plane + o] = valid ? prop_len[k] : 0;
        out[(size_t)(3 * k + 1) * plane + o] = want[k] - 1;
        out[(size_t)(3 * k + 2) * plane + o] =
            eq[k] * gt[k] + eq[k] * (eq[k] - 1) / 2;
      }
      const int sc_b = (int)(best >> 40) - 2, slot_b = (int)(best & 0xFFu);
      const int src_b = (int)((best >> 8) & 0xFFFFFFFFu) - 1;
      int len_b = 0;
      if (sc_b == 4 && live) {
        const int cap = max(min(min(c.T - t, c.n - pos), len_cap), 0);
        len_b = min(prefix_len(inp, c, i, t, src_b, c.window), cap);
      }
      out[(size_t)(3 * n_c) * plane + o] = len_b;
      out[(size_t)(3 * n_c + 1) * plane + o] = src_b;
      out[(size_t)(3 * n_c + 2) * plane + o] = recency_rank(pos_row, d, slot_b);
      out[(size_t)(3 * n_c + 3) * plane + o] = fill;

      if (active) {
        ctx4n = (ctx4 << 8) | (uint32_t)byte;
        ctx4bn = (ctx4b << 8) | (ctx4 >> 24);
      }
      if (insert_here(c, active, t, pos))
        ins_key = (int)rolz_hash3(rolz_key(ctx4bn, c.rolz_ctx_bytes), c.rolz_bits);
    }
    keys[threadIdx.x] = ins_key;
    group_sync<CL>();
    int slot = bucket_slot<CL>(rolz, c, keys, ins_key, posbuf, pitch);
    group_sync<CL>();
    if (slot >= 0) bucket_store(rolz, c, (uint32_t)ins_key, slot, pos, byteswap32(ctx4n));
    ctx4 = ctx4n;
    ctx4b = ctx4bn;
    group_sync<CL>();
  }
}

}  // namespace

extern "C" int cpx_k5_launch(const int* cfg, const void* inp, const void* props,
                             void* rolz, void* out, void* gpos, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.n_cands < 1 || c.n_cands > K5_MAX_CANDS) return (int)cudaErrorInvalidValue;
  const ScanGrid g = scan_grid(c.S);
  size_t smem = pos_smem_bytes(c, 1);
  auto kernel = g.ctas > 1 ? k5_kernel<CPX_MAX_LANES, true>
              : g.threads <= 512 ? k5_kernel<512, false> : k5_kernel<CPX_MAX_LANES, false>;
  return launch_scan(kernel, g, smem, stream, c, (const uint8_t*)inp, (const int*)props,
                     (int*)rolz, (int*)out, (int*)gpos, smem > 0);
}
