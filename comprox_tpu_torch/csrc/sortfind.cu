// K4: the whole-block sort finder of the flexible-parse encode, with an
// entry for mode R (K4) and one for mode X (K4x).
//
// Replaces comprox_tpu/codec/block.py::sort_candidates (809-936) in the
// configurations _search_and_parse uses for mode R (1586-1590) and for mode
// X (1616-1618), with its helpers _bytes_eq_count (798), _rev_runmin (764)
// and _diag_run_len (777).
// For every position of the block: key = Knuth hash of the context bytes
// before it; positions sorted by (key, position); the 2 * probe sort
// neighbours with the same key are the chain; each chain entry that the
// decoder could use (an earlier step of its lane, an inserted position) is
// probed to 8 bytes; the n_cands best by (prefix, nearness in the chain)
// are extended to the window; the result is capped to the lane's row.
// Mode X's entry keys a position by a hash of its own next six bytes (the
// key of the fast profile's finder, f2find.cu), walks the chain backward
// only (fwd_chain = 0) and counts every position as inserted (rolz_dec =
// 1); a chain no longer than n_cands is taken whole, in chain order.  Its
// sources are written at every position, usable or not: the price DP
// passes them through.
//
// Bound on the H100: bytes.  The function reads N bytes and writes
// 2 * n_cands int32 per position; the work between is the sort (four
// passes, each reading and writing 8 bytes per position) and the probes
// (two 8-byte gathers per usable chain entry).  The block itself (8 MiB at
// the main path's geometry) stays in the 50 MB L2, so the gathers do not
// go to device memory.  Kernels, in launch order:
//   k4_keys     one thread per position: the key;
//   the stable LSD radix sort of (key, position) of sortlib.cuh
//               (rs_hist, rs_plan, rs_pass, rs_finish), shared with the
//               mode-F finder; its entry point cpx_radix_sort_launch is
//               here;
//   k4_find     one thread per sort rank: the chain is the ranks r-k and
//               r+k with an equal key, read from the sorted arrays (the
//               JAX [N, 2 * probe] candidate array is never stored); the
//               top n_cands as a sorted list in registers; extension
//               8 bytes per compare, stopped at the first difference;
//   finder_final (sortlib.cuh)  one thread per output element: diagonal-run
//               recovery, the cap, and the [T, S] layout the rank scan
//               reads.
#include "sortlib.cuh"

namespace {

#define K4_INSERT_LATE 3  // block.py::_INSERT_LATE

template <bool CONTENT>
__global__ void k4_keys(Cfg c, const uint64_t* __restrict__ bytes,
                        uint32_t* __restrict__ key) {
  const long long big = (long long)c.S * c.T;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= big) return;
  const int cb = c.rolz_ctx_bytes;
  uint32_t k = 0xFFFFFFFFu;
  if (CONTENT) {
    if (i < c.n) {
      const uint64_t w = load_u64(bytes, i);
      k = ((uint32_t)w * 0x9E3779B1u) ^
          (((uint32_t)(w >> 32) & 0xFFFFu) * 0x85EBCA77u);
    }
  } else if (i >= cb && i < c.n) {
    uint32_t w = (uint32_t)load_u64(bytes, i - cb);
    if (cb == 3) w &= 0xFFFFFFu;
    k = w * 2654435761u;
  }
  key[i] = k;
}

// Whether the decoder could use source cand at step t_of of its lane: an
// earlier step, and a position the (decimated) bucket insert takes.
__device__ __forceinline__ bool usable(const Cfg& c, int cand, int t_of) {
  if (cand < 0 || cand % c.T >= t_of) return false;
  return c.rolz_dec <= 1 || (cand + K4_INSERT_LATE) % c.rolz_dec == 0;
}

__global__ void k4_find(Cfg c, const uint64_t* __restrict__ bytes,
                        const uint32_t* __restrict__ hs, const int* __restrict__ ps,
                        int* __restrict__ cand_out, int* __restrict__ lw_out) {
  const int big = c.S * c.T;
  const long long rr = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (rr >= big) return;
  const int r = (int)rr;
  const int i = ps[r];
  const uint32_t key = hs[r];
  const int t_of = i % c.T;
  const int n_c = c.n_cands;
  const int chain_b = max(c.r_probe, n_c), chain = chain_b + c.fwd_chain;
  const bool select = chain > n_c;  // else the chain is taken whole, in order
  const uint64_t own = load_u64(bytes, i);
  // the n_c largest of score = plen * chain + (chain - 1 - e), e the chain
  // index: distinct, so a sorted list of (score + chain) << 32 | cand + 1
  unsigned long long top[FIND_MAX_CANDS];
#pragma unroll
  for (int u = 0; u < FIND_MAX_CANDS; ++u) top[u] = 0;
  for (int e = 0; e < chain; ++e) {
    const int q = e < chain_b ? r - (e + 1) : r + (e - chain_b + 1);
    const int cand = (q >= 0 && q < big && hs[q] == key) ? ps[q] : -1;
    int plen = select ? -1 : 0;
    if (select && usable(c, cand, t_of)) plen = eq_bytes(load_u64(bytes, cand) ^ own);
    const int score = plen * chain + (chain - 1 - e);
    const unsigned long long k =
        ((unsigned long long)(score + chain + 1) << 32) | (unsigned)(cand + 1);
#pragma unroll
    for (int u = FIND_MAX_CANDS - 1; u > 0; --u)
      top[u] = k > top[u - 1] ? top[u - 1] : (k > top[u] ? k : top[u]);
    top[0] = k > top[0] ? k : top[0];
  }
  const int ext8 = (c.sort_ext + 3) / 4 * 4;  // bytes the word extension compares
  const uint8_t* const b8 = reinterpret_cast<const uint8_t*>(bytes);
#pragma unroll
  for (int u = 0; u < FIND_MAX_CANDS; ++u) {
    if (u >= n_c) break;
    const int cand = (int)(unsigned)(top[u] & 0xFFFFFFFFu) - 1;
    const bool ok = usable(c, cand, t_of);
    int len = 0, flags = 0;
    if (ok) {
      len = match_len(bytes, cand, i, ext8);
      flags = FIND_OK | (b8[cand] == b8[i] ? FIND_EQ1 : 0);
    }
    cand_out[(size_t)u * big + i] = cand;
    lw_out[(size_t)u * big + i] = len | flags;
  }
}

}  // namespace

// The keys, into key[0 .. N).
template <bool CONTENT>
static int keys_launch(const int* cfg, const void* bytes, void* key, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  const int big = c.S * c.T;
  k4_keys<CONTENT><<<(big + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      c, (const uint64_t*)bytes, (uint32_t*)key);
  return (int)cudaGetLastError();
}

extern "C" int cpx_k4_keys_launch(const int* cfg, const void* bytes, void* key,
                                  void* stream) {
  return keys_launch<false>(cfg, bytes, key, stream);
}

// Mode X: keys of the position's own six bytes.
extern "C" int cpx_k4x_keys_launch(const int* cfg, const void* bytes, void* key,
                                   void* stream) {
  return keys_launch<true>(cfg, bytes, key, stream);
}

// The shared sort (sortlib.cuh), for K4, K4x and K7: key and pos are [2, n]
// int32 arrays, key's first half the keys; on return the first halves hold
// the sorted keys and positions.  scratch: block.py::_sort_stage's size.
extern "C" int cpx_radix_sort_launch(int n, void* key, void* pos, void* scratch,
                                     void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  return radix_sort_pairs((uint32_t*)key, (int*)pos, (int*)scratch, n,
                          (cudaStream_t)stream);
}

extern "C" int cpx_k4_find_launch(const int* cfg, const void* bytes,
                                  const void* hs, const void* ps, void* cand,
                                  void* lw, void* out, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.n_cands < 1 || c.n_cands > FIND_MAX_CANDS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int big = c.S * c.T;
  k4_find<<<(big + 255) / 256, 256, 0, st>>>(
      c, (const uint64_t*)bytes, (const uint32_t*)hs, (const int*)ps,
      (int*)cand, (int*)lw);
  finder_final<<<(big + 255) / 256, 256, 0, st>>>(
      c.S, c.T, c.n, c.n_cands, min(c.window, c.min_len + LEN_W - 1), 1,
      (const int*)cand, (const int*)lw, (int*)out);
  return (int)cudaGetLastError();
}

// Mode X: the same stages under its configuration (r_probe = the backward
// chain, fwd_chain = 0, rolz_dec = 1).
extern "C" int cpx_k4x_find_launch(const int* cfg, const void* bytes,
                                   const void* hs, const void* ps, void* cand,
                                   void* lw, void* out, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.fwd_chain != 0 || c.rolz_dec != 1) return (int)cudaErrorInvalidValue;
  return cpx_k4_find_launch(cfg, bytes, hs, ps, cand, lw, out, stream);
}
