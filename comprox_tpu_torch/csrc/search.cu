// KS: the ROLZ search scan of the greedy (-f0) encode; KSx: the search scan
// of mode X under CPX_X_FINDER=scan.
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
// read before its own scatter-max insert, a barrier apart).  Then two
// lane-ranked bucket inserts: position pos-7 under its own 8 bytes, and
// position pos-3 under its context.  Output: six grids (length, src, len2,
// cand, len3, src3), the price DP's three (len, src) candidates.
//
// Bound on the H100: one CTA (above 1024 lanes one cluster of CTAs, as
// ppm_r.cuh sets out) walks T dependent steps, so the kernel is
// latency bound (global-memory round trips of the bucket rows and the
// byte windows, and the barriers), not bandwidth bound: a step touches
// ~S*(D*8 + 4*probe + window) bytes (KSx: twice the rows, three windows).
// The design keeps every lane's work
// in one thread and the tables in global memory (L2 holds the hot rows);
// top-k is one pass over the row keeping a sorted list of k (score,
// position, slot) in registers, instead of the JAX O(D^2) rank matrix;
// byte windows are compared 8 bytes per pair of aligned loads instead of
// one dependent byte load at a time; insert rows are read by whole warps
// into a shared-memory copy per lane.  KSx runs its two bucket searches
// and its two inserts one after the other through the same per-lane row
// copies.
#include "rolz_search.cuh"

namespace {

template <int MAXT, bool CL>
__global__ void __launch_bounds__(MAXT) ks_kernel(Cfg c, const uint8_t* __restrict__ inp,
                          int* __restrict__ rolz, int* __restrict__ out,
                          int* __restrict__ gpos, bool pos_in_smem) {
  __shared__ __align__(16) int keys[CPX_MAX_LANES];  // this CTA's lanes'
  extern __shared__ int spos[];
  const int i = gtid();
  const bool alive = i < c.S;
  const int d = c.rolz_depth;
  uint32_t ctx4 = 0, ctx4b = 0;
  // the lanes' copies of bucket rows (the search row, then the insert row)
  // and the search row's prefix scores
  const int pitch = pos_pitch(d);
  const PosBufs pb = pos_bufs<CL>(c, spos, gpos, pos_in_smem, pitch);
  int* const posbuf = pb.pos;
  int* const pos_row = posbuf + (size_t)threadIdx.x * pitch;
  int8_t* const scorebuf = pb.score;
  const int8_t* const score_row = scorebuf + (size_t)threadIdx.x * pitch;

  for (int t = 0; t < c.T; ++t) {
    const int pos = i * c.T + t;
    const bool active = alive && pos < c.n;
    int byte = 0, ins_key = -1;
    uint32_t ctx4n = ctx4, ctx4bn = ctx4b;
    // this lane's next bytes: block[cur..row_end), zero past its row
    const long long cur = (long long)i * c.T + t, row_end = (long long)(i + 1) * c.T;
    uint64_t own = 0;
    if (alive) own = load8(inp, (long long)c.S * c.T, cur, row_end);
    const int fill = warp_load_scored_rows(
        rolz, d, alive, rolz_hash3(rolz_key(ctx4, c.rolz_ctx_bytes), c.rolz_bits),
        (uint32_t)own, posbuf, scorebuf, pitch);
    if (alive) {
      byte = (int)(own & 0xFFu);
      const BestMatch m = rolz_best(inp, c, i, t, pos_row, score_row, own);
      size_t o = (size_t)t * c.S + i, plane = (size_t)c.T * c.S;
      out[o] = (active && t >= 7) ? m.length : 0;
      out[plane + o] = m.src;
      out[2 * plane + o] = recency_rank(pos_row, d, m.slot);
      out[3 * plane + o] = fill;

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

#define X_INSERT_LATE 7  // the content-keyed entry of position q: at step q + 7

template <int MAXT, bool CL>
__global__ void __launch_bounds__(MAXT) ksx_kernel(Cfg c, const uint8_t* __restrict__ inp,
                           int* __restrict__ ent_x, int* __restrict__ ent_c,
                           int* __restrict__ xshort, int* __restrict__ out,
                           int* __restrict__ gpos, bool pos_in_smem) {
  __shared__ __align__(16) int keys_x[CPX_MAX_LANES];
  __shared__ __align__(16) int keys_c[CPX_MAX_LANES];
  extern __shared__ int spos[];
  const int i = gtid();
  const bool alive = i < c.S;
  const int d = c.rolz_depth;
  uint32_t ctx4 = 0, ctx4b = 0;
  const int pitch = pos_pitch(d);
  const PosBufs pb = pos_bufs<CL>(c, spos, gpos, pos_in_smem, pitch);
  int* const posbuf = pb.pos;
  const int* const pos_row = posbuf + (size_t)threadIdx.x * pitch;
  int8_t* const scorebuf = pb.score;
  const int8_t* const score_row = scorebuf + (size_t)threadIdx.x * pitch;
  const size_t plane = (size_t)c.T * c.S;

  for (int t = 0; t < c.T; ++t) {
    const int pos = i * c.T + t;
    const bool active = alive && pos < c.n;
    const bool ok_here = active && t >= 7;
    int key_x = -1, key_c = -1;
    uint32_t ctx4n = ctx4, ctx4bn = ctx4b, h6 = 0;
    const long long cur = (long long)i * c.T + t, row_end = (long long)(i + 1) * c.T;
    uint64_t own = 0;
    if (alive) own = load8(inp, (long long)c.S * c.T, cur, row_end);
    const size_t o = (size_t)t * c.S + i;

    // the content-keyed bucket, then the context-keyed one: entries at or
    // after pos are masked before the top-k
    warp_load_scored_rows(ent_x, d, alive,
                          x_hash8((uint32_t)own, (uint32_t)(own >> 32), c.rolz_bits),
                          (uint32_t)own, posbuf, scorebuf, pitch, pos);
    __syncwarp();
    if (alive) {
      const BestMatch m = rolz_best(inp, c, i, t, pos_row, score_row, own);
      out[o] = (m.src >= 0 && m.src < pos && ok_here) ? m.length : 0;
      out[plane + o] = m.src;
    }
    __syncwarp();
    warp_load_scored_rows(ent_c, d, alive,
                          rolz_hash3(rolz_key(ctx4, c.rolz_ctx_bytes), c.rolz_bits),
                          (uint32_t)own, posbuf, scorebuf, pitch, pos);
    __syncwarp();
    if (alive) {
      const BestMatch m = rolz_best(inp, c, i, t, pos_row, score_row, own);
      out[4 * plane + o] = (m.src >= 0 && m.src < pos && ok_here) ? m.length : 0;
      out[5 * plane + o] = m.src;

      // the near-match cache, read as the step found it
      h6 = x_hash6(own);
      const int cand = xshort[h6] - 1;
      int len2 = 0;
      if (cand >= 0 && cand < pos && ok_here) len2 = prefix_len(inp, c, i, t, cand, c.window);
      out[2 * plane + o] = min(len2, len_cap_at(c, i, t));  // below 0 past the block
      out[3 * plane + o] = cand;

      if (active) {
        ctx4n = (ctx4 << 8) | (uint32_t)(own & 0xFFu);
        ctx4bn = (ctx4b << 8) | (ctx4 >> 24);
        // position q = pos-7 under its own 8 bytes: q..q+3 = byteswap(ctx4bn)
        if (t >= 10)
          key_x = (int)x_hash8(byteswap32(ctx4bn), byteswap32(ctx4n), c.rolz_bits);
        // position q = pos-3 under its context, by mode R's rule undecimated
        if (t >= (c.rolz_ctx_bytes == 4 ? 7 : 6))
          key_c = (int)rolz_hash3(rolz_key(ctx4bn, c.rolz_ctx_bytes), c.rolz_bits);
      }
    }
    keys_x[threadIdx.x] = key_x;
    keys_c[threadIdx.x] = key_c;
    group_sync<CL>();  // every lane has read the cache and both search rows
    if (active) atomicMax(&xshort[h6], pos + 1);
    const int slot_x = bucket_slot<CL>(ent_x, c, keys_x, key_x, posbuf, pitch);
    __syncwarp();
    const int slot_c = bucket_slot<CL>(ent_c, c, keys_c, key_c, posbuf, pitch);
    group_sync<CL>();
    if (slot_x >= 0)
      bucket_store(ent_x, c, (uint32_t)key_x, slot_x, pos, byteswap32(ctx4bn), X_INSERT_LATE);
    if (slot_c >= 0) bucket_store(ent_c, c, (uint32_t)key_c, slot_c, pos, byteswap32(ctx4n));
    ctx4 = ctx4n;
    ctx4b = ctx4bn;
    group_sync<CL>();
  }
}

}  // namespace

extern "C" int cpx_ks_launch(const int* cfg, const void* inp, void* rolz,
                             void* out, void* gpos, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  const ScanGrid g = scan_grid(c.S);
  size_t smem = pos_smem_bytes(c, 1);
  auto kernel = g.ctas > 1 ? ks_kernel<CPX_MAX_LANES, true>
              : g.threads <= 512 ? ks_kernel<512, false> : ks_kernel<CPX_MAX_LANES, false>;
  return launch_scan(kernel, g, smem, stream, c, (const uint8_t*)inp, (int*)rolz,
                     (int*)out, (int*)gpos, smem > 0);
}

// Mode X: the content-keyed and the context-keyed bucket table
// [2^bits, D, 2], the cache xshort [2^16] (all updated in place) ->
// out [6, T, S].
extern "C" int cpx_ksx_launch(const int* cfg, const void* inp, void* ent_x,
                              void* ent_c, void* xshort, void* out, void* gpos,
                              void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  const ScanGrid g = scan_grid(c.S);
  size_t smem = pos_smem_bytes(c, 1);
  auto kernel = g.ctas > 1 ? ksx_kernel<CPX_MAX_LANES, true>
              : g.threads <= 512 ? ksx_kernel<512, false> : ksx_kernel<CPX_MAX_LANES, false>;
  return launch_scan(kernel, g, smem, stream, c, (const uint8_t*)inp, (int*)ent_x,
                     (int*)ent_c, (int*)xshort, (int*)out, (int*)gpos, smem > 0);
}
