// K4: the whole-block sort finder of the flexible-parse encode.
//
// Replaces comprox_tpu/codec/block.py::sort_candidates (809-936) in the
// configuration _search_and_parse uses for mode R (1586-1590), with its
// helpers _bytes_eq_count (798), _rev_runmin (764) and _diag_run_len (777).
// For every position of the block: key = Knuth hash of the context bytes
// before it; positions sorted by (key, position); the 2 * probe sort
// neighbours with the same key are the chain; each chain entry that the
// decoder could use (an earlier step of its lane, an inserted position) is
// probed to 8 bytes; the n_cands best by (prefix, nearness in the chain)
// are extended to the window; the result is capped to the lane's row.
//
// Bound on the H100: bytes.  The function reads N bytes and writes
// 2 * n_cands int32 per position; the work between is the sort (four
// passes, each reading and writing 8 bytes per position) and the probes
// (two 8-byte gathers per usable chain entry).  The block itself (8 MiB at
// the main path's geometry) stays in the 50 MB L2, so the gathers do not
// go to device memory.  Kernels, in launch order:
//   k4_keys     one thread per position: the key and the identity order;
//   k4_hist, k4_scan, k4_scatter   an LSD radix sort of (key, position),
//               8 bits a pass, stable, written here: a warp counts the
//               digits of its tile of 2048 keys; one CTA takes the
//               exclusive sum over (digit, tile); the warp then places its
//               tile 32 keys at a time, ranking equal digits inside the
//               warp with __match_any_sync, so equal keys keep their
//               position order — jax.lax.sort(is_stable=True)'s result;
//   k4_find     one thread per sort rank: the chain is the ranks r-k and
//               r+k with an equal key, read from the sorted arrays (the
//               JAX [N, 2 * probe] candidate array is never stored); the
//               top n_cands as a sorted list in registers; extension
//               8 bytes per compare, stopped at the first difference;
//   k4_final    one thread per output element: diagonal-run recovery (a
//               forward walk of at most cap + 1 positions, taken only where
//               the extension fell short of the cap — after the cap it
//               equals the JAX reverse running minimum), the cap, and the
//               [T, S] layout the rank scan reads.
#include "ppm_r.cuh"

namespace {

#define K4_TILE 2048  // keys per warp and pass (block.py::K4_TILE)
#define K4_WARPS 4
#define K4_MAX_CANDS 7
#define K4_INSERT_LATE 3  // block.py::_INSERT_LATE
#define K4_OK (1 << 17)
#define K4_EQ1 (1 << 16)

// The 8 bytes at byte offset j of an 8-byte aligned buffer, little-endian;
// the buffer's zero tail covers the second word.
__device__ __forceinline__ uint64_t load_u64(const uint64_t* w, long long j) {
  const long long k = j >> 3;
  const int sh = (int)(j & 7) * 8;
  const uint64_t lo = w[k];
  return sh ? (lo >> sh) | (w[k + 1] << (64 - sh)) : lo;
}

// Leading equal bytes of two 8-byte little-endian windows: 0..8.
__device__ __forceinline__ int eq_bytes(uint64_t x) {
  return x ? (__ffsll((long long)x) - 1) >> 3 : 8;
}

__global__ void k4_keys(Cfg c, const uint64_t* __restrict__ bytes,
                        uint32_t* __restrict__ key, int* __restrict__ pos) {
  const long long big = (long long)c.S * c.T;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= big) return;
  const int cb = c.rolz_ctx_bytes;
  uint32_t k = 0xFFFFFFFFu;
  if (i >= cb && i < c.n) {
    uint32_t w = (uint32_t)load_u64(bytes, i - cb);
    if (cb == 3) w &= 0xFFFFFFu;
    k = w * 2654435761u;
  }
  key[i] = k;
  pos[i] = (int)i;
}

__global__ void __launch_bounds__(K4_WARPS * 32) k4_hist(
    const uint32_t* __restrict__ key, int big, int tiles, int shift,
    int* __restrict__ hist) {
  __shared__ int cnt_all[K4_WARPS][256];
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int tile = blockIdx.x * K4_WARPS + warp;
  int* const cnt = cnt_all[warp];
  for (int u = j; u < 256; u += 32) cnt[u] = 0;
  __syncwarp();
  if (tile >= tiles) return;
  const int base = tile * K4_TILE;
  for (int e = j; e < K4_TILE; e += 32)
    if (base + e < big) atomicAdd(&cnt[(key[base + e] >> shift) & 0xFFu], 1);
  __syncwarp();
  for (int u = j; u < 256; u += 32) hist[(size_t)u * tiles + tile] = cnt[u];
}

// In-place exclusive sum over hist[0 .. total), one CTA of 1024 threads.
__global__ void __launch_bounds__(1024) k4_scan(int* __restrict__ hist, int total) {
  __shared__ int part[1024];
  const int tid = threadIdx.x;
  const int chunk = (total + 1023) / 1024;
  const int b = min(tid * chunk, total), e = min(b + chunk, total);
  int s = 0;
  for (int k = b; k < e; ++k) s += hist[k];
  part[tid] = s;
  __syncthreads();
  for (int off = 1; off < 1024; off <<= 1) {
    const int v = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int run = part[tid] - s;
  for (int k = b; k < e; ++k) {
    const int v = hist[k];
    hist[k] = run;
    run += v;
  }
}

__global__ void __launch_bounds__(K4_WARPS * 32) k4_scatter(
    const uint32_t* __restrict__ key, const int* __restrict__ pos, int big,
    int tiles, int shift, const int* __restrict__ hist,
    uint32_t* __restrict__ key_out, int* __restrict__ pos_out) {
  __shared__ int off_all[K4_WARPS][256];
  const unsigned full = 0xffffffffu;
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int tile = blockIdx.x * K4_WARPS + warp;
  if (tile >= tiles) return;  // the whole warp
  int* const off = off_all[warp];
  for (int u = j; u < 256; u += 32) off[u] = hist[(size_t)u * tiles + tile];
  __syncwarp();
  const int base = tile * K4_TILE;
  for (int e = j; e < K4_TILE; e += 32) {
    const bool valid = base + e < big;
    const uint32_t k = valid ? key[base + e] : 0;
    const int p = valid ? pos[base + e] : 0;
    // threads past the end form a group of their own (digit 256)
    const int digit = valid ? (int)((k >> shift) & 0xFFu) : 256;
    const unsigned same = __match_any_sync(full, digit);
    const int rank = __popc(same & ((1u << j) - 1u));
    int dst = 0;
    if (valid) dst = off[digit] + rank;
    __syncwarp();
    if (valid && rank == 0) off[digit] += __popc(same);
    __syncwarp();
    if (valid) {
      key_out[dst] = k;
      pos_out[dst] = p;
    }
  }
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
  const int chain_b = max(c.r_probe, n_c), chain = chain_b + c.r_probe;
  const uint64_t own = load_u64(bytes, i);
  // the n_c largest of score = plen * chain + (chain - 1 - e), e the chain
  // index: distinct, so a sorted list of (score + chain) << 32 | cand + 1
  unsigned long long top[K4_MAX_CANDS];
#pragma unroll
  for (int u = 0; u < K4_MAX_CANDS; ++u) top[u] = 0;
  for (int e = 0; e < chain; ++e) {
    const int q = e < chain_b ? r - (e + 1) : r + (e - chain_b + 1);
    const int cand = (q >= 0 && q < big && hs[q] == key) ? ps[q] : -1;
    int plen = -1;
    if (usable(c, cand, t_of)) plen = eq_bytes(load_u64(bytes, cand) ^ own);
    const int score = plen * chain + (chain - 1 - e);
    const unsigned long long k =
        ((unsigned long long)(score + chain + 1) << 32) | (unsigned)(cand + 1);
#pragma unroll
    for (int u = K4_MAX_CANDS - 1; u > 0; --u)
      top[u] = k > top[u - 1] ? top[u - 1] : (k > top[u] ? k : top[u]);
    top[0] = k > top[0] ? k : top[0];
  }
  const int ext8 = (c.sort_ext + 3) / 4 * 4;  // bytes the word extension compares
  const uint8_t* const b8 = reinterpret_cast<const uint8_t*>(bytes);
#pragma unroll
  for (int u = 0; u < K4_MAX_CANDS; ++u) {
    if (u >= n_c) break;
    const int cand = (int)(unsigned)(top[u] & 0xFFFFFFFFu) - 1;
    const bool ok = usable(c, cand, t_of);
    int len = 0, flags = 0;
    if (ok) {
      for (; len < ext8; len += 8) {
        const uint64_t x = load_u64(bytes, (long long)cand + len) ^
                           load_u64(bytes, (long long)i + len);
        if (x) {
          len += eq_bytes(x);
          break;
        }
      }
      len = min(len, ext8);
      flags = K4_OK | (b8[cand] == b8[i] ? K4_EQ1 : 0);
    }
    cand_out[(size_t)u * big + i] = cand;
    lw_out[(size_t)u * big + i] = len | flags;
  }
}

__global__ void k4_final(Cfg c, const int* __restrict__ cand_in,
                         const int* __restrict__ lw_in, int* __restrict__ out) {
  const int big = c.S * c.T;
  const long long oo = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (oo >= big) return;
  const int t = (int)(oo / c.S), lane = (int)(oo % c.S);
  const int i = lane * c.T + t;
  const int cap = max(min(min(c.T - t, c.n - i),
                          min(c.window, c.min_len + LEN_W - 1)), 0);
  for (int u = 0; u < c.n_cands; ++u) {
    const int* const cand = cand_in + (size_t)u * big;
    const int* const lw = lw_in + (size_t)u * big;
    const int v = lw[i];
    int len = v & 0xFFFF;
    if ((v & K4_OK) && len < cap) {
      // the run of positions from i whose candidates stay on one diagonal
      // and whose first bytes match, plus a matching byte where it ends
      int jj = i, run = cap;
      while (jj - i < cap) {
        const bool eq1 = lw[jj] & K4_EQ1;
        if (!(eq1 && jj + 1 < big && cand[jj + 1] == cand[jj] + 1)) {
          run = jj - i + (eq1 ? 1 : 0);
          break;
        }
        ++jj;
      }
      len = max(len, run);
    }
    out[(size_t)(2 * u) * big + oo] = (v & K4_OK) ? min(len, cap) : 0;
    out[(size_t)(2 * u + 1) * big + oo] = cand[i];
  }
}

}  // namespace

// Keys and the radix sort: on return key[0 .. N) and pos[0 .. N) (the
// first halves of the [2, N] arrays) hold the sorted order.  hist has
// 256 * ceil(N / K4_TILE) ints.
extern "C" int cpx_k4_sort_launch(const int* cfg, const void* bytes, void* key,
                                  void* pos, void* hist, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  cudaStream_t st = (cudaStream_t)stream;
  const int big = c.S * c.T;
  const int tiles = (big + K4_TILE - 1) / K4_TILE;
  uint32_t* k[2] = {(uint32_t*)key, (uint32_t*)key + big};
  int* p[2] = {(int*)pos, (int*)pos + big};
  k4_keys<<<(big + 255) / 256, 256, 0, st>>>(c, (const uint64_t*)bytes, k[0], p[0]);
  const int grid = (tiles + K4_WARPS - 1) / K4_WARPS;
  for (int pass = 0; pass < 4; ++pass) {
    const int a = pass & 1, b = a ^ 1, shift = 8 * pass;
    k4_hist<<<grid, K4_WARPS * 32, 0, st>>>(k[a], big, tiles, shift, (int*)hist);
    k4_scan<<<1, 1024, 0, st>>>((int*)hist, 256 * tiles);
    k4_scatter<<<grid, K4_WARPS * 32, 0, st>>>(k[a], p[a], big, tiles, shift,
                                              (const int*)hist, k[b], p[b]);
  }
  return (int)cudaGetLastError();
}

extern "C" int cpx_k4_find_launch(const int* cfg, const void* bytes,
                                  const void* hs, const void* ps, void* cand,
                                  void* lw, void* out, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.n_cands < 1 || c.n_cands > K4_MAX_CANDS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int big = c.S * c.T;
  k4_find<<<(big + 255) / 256, 256, 0, st>>>(
      c, (const uint64_t*)bytes, (const uint32_t*)hs, (const int*)ps,
      (int*)cand, (int*)lw);
  k4_final<<<(big + 255) / 256, 256, 0, st>>>(c, (const int*)cand,
                                              (const int*)lw, (int*)out);
  return (int)cudaGetLastError();
}
