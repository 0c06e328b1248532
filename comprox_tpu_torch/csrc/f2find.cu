// K7: the sort finder of the fast profile (mode F).
//
// Replaces comprox_tpu/codec/fast.py::_f2_find (178-246) with
// block.py::_bytes_eq_count (798) and _diag_run_len (777).  For every
// position of the block: key = a hash of its next 6 bytes (0xFFFFFFFF past
// n); positions sorted by (key, position); the n_cands previous entries of
// the same key are the candidates, nearest first — all earlier positions,
// which is the only causality the host-executed LZ copies need; each is
// compared byte for byte up to 4 * (EXTW - 1) bytes; runs of positions
// whose candidates advance with them recover longer matches (zeros,
// periodic content); the length is capped at the lane's end, at n and at
// the window.  The source is written at every position, usable or not.
//
// Bound on the H100: bytes.  The function reads N bytes and writes
// 2 * n_cands int32 per position; between lie the sort (four passes of 8
// bytes read and written per position) and two 64-byte gathers per
// candidate that hit the 50 MB L2, where the 8 MiB block stays.  JAX's
// [N/4, 16] row table and its shift pair are its way to an unaligned
// 64-byte read and have no counterpart: the kernel reads the padded block
// at any byte offset.  JAX's second sort (back to position order) is a
// scatter here.  Kernels, in launch order:
//   k7_keys      one thread per position: the key;
//   the stable LSD radix sort of sortlib.cuh (sortfind.cu's entry
//                cpx_radix_sort_launch), shared with the mode-R finder;
//   k7_find      one thread per sort rank r: the entries r-1 .. r-n_cands
//                with an equal key, each extended 8 bytes a compare and
//                scattered to position ps[r];
//   finder_final (sortlib.cuh) one thread per output element: diagonal
//                runs, the cap, the [T, S] layout the price DP reads.
#include "sortlib.cuh"

namespace {

__global__ void k7_keys(Cfg c, const uint64_t* __restrict__ bytes,
                        uint32_t* __restrict__ key) {
  const long long big = (long long)c.S * c.T;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= big) return;
  uint32_t k = 0xFFFFFFFFu;
  if (i < c.n) {
    const uint64_t w = load_u64(bytes, i);
    k = ((uint32_t)w * 0x9E3779B1u) ^
        (((uint32_t)(w >> 32) & 0xFFFFu) * 0x85EBCA77u);
  }
  key[i] = k;
}

__global__ void k7_find(Cfg c, const uint64_t* __restrict__ bytes,
                        const uint32_t* __restrict__ hs, const int* __restrict__ ps,
                        int* __restrict__ cand_out, int* __restrict__ lw_out) {
  const int big = c.S * c.T;
  const long long rr = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (rr >= big) return;
  const int r = (int)rr;
  const int i = ps[r];
  const uint32_t key = hs[r];
  const uint8_t* const b8 = reinterpret_cast<const uint8_t*>(bytes);
  for (int u = 0; u < c.n_cands; ++u) {
    const int q = r - (u + 1);
    const int cand = (q >= 0 && hs[q] == key) ? ps[q] : -1;
    int lw = 0;
    if (cand >= 0 && i < c.n)
      lw = match_len(bytes, cand, i, c.sort_ext) | FIND_OK |
           (b8[cand] == b8[i] ? FIND_EQ1 : 0);
    cand_out[(size_t)u * big + i] = cand;
    lw_out[(size_t)u * big + i] = lw;
  }
}

}  // namespace

// The keys, into key[0 .. N).
extern "C" int cpx_k7_keys_launch(const int* cfg, const void* bytes, void* key,
                                  void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  const int big = c.S * c.T;
  k7_keys<<<(big + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      c, (const uint64_t*)bytes, (uint32_t*)key);
  return (int)cudaGetLastError();
}

// bytes: the block with a zero tail of sort_ext + 20 bytes, to a multiple of
// 8.  cand, lw: [n_cands, N] scratch.  out: [2 * n_cands, T, S].
extern "C" int cpx_k7_find_launch(const int* cfg, const void* bytes,
                                  const void* hs, const void* ps, void* cand,
                                  void* lw, void* out, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.n_cands < 1 || c.n_cands > FIND_MAX_CANDS || c.sort_ext >= FIND_EQ1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int big = c.S * c.T;
  k7_find<<<(big + 255) / 256, 256, 0, st>>>(
      c, (const uint64_t*)bytes, (const uint32_t*)hs, (const int*)ps,
      (int*)cand, (int*)lw);
  finder_final<<<(big + 255) / 256, 256, 0, st>>>(
      c.S, c.T, c.n, c.n_cands, c.window, c.diag_tail, (const int*)cand,
      (const int*)lw, (int*)out);
  return (int)cudaGetLastError();
}
