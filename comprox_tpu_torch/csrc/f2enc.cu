// K9: the static rANS encoder of the fast profile (mode F).
//
// Replaces the second half of comprox_tpu/codec/fast.py::_encode_fast
// (460-516) with normalize_freqs (370), _uniform_cf (396) and
// _rev_window_write (405).  From the tokens' (sym, xtr, bits): the
// histogram of the n_tok symbols; static frequencies that sum to exactly
// M = 2^15 (counts halve, never to 0, until their total fits 15 bits; scale
// to M rounding down; the drift goes to the first largest); then the tokens
// S at a time from the last step to the first, each as three events in the
// order XTR2, XTR1, SYM (rANS is last in, first out), every lane putting
// its event into its own 32-bit state and emitting at most one u16 word;
// the stream is the words in the decoder's read order (steps ascending;
// SYM, XTR1, XTR2; lanes ascending), the reverse of the order they are
// emitted in.
//
// That backward pass is K3's function (rans.cu): a put x' = (x / f) 2^15 +
// c + x % f after the word x & 0xFFFF where x >> 17 >= f, from RANS_L, the
// identity event (0, M) where a token or an event is absent; and the
// stream's order is the one K3b compacts K3's words into.  The lanes are
// independent; only the stream's order couples them.  So K9 is a token
// pass on the adaptive path's kernels, all enqueued by cpx_k9_launch under
// one entry:
//   k9_hist    the symbols' histogram (shared counters a CTA, a few
//              thousand tokens a CTA);
//   k9_norm    one CTA: the exact normalisation, and each symbol's
//              cumulative frequency (a CTA scan);
//   k9_events  a thread a (step, lane) cell, token t S + l: K3's event grid
//              ev [T', 9, S], (c, f, flag) for slot 0 SYM, 1 XTR1 (the low
//              min(bits, 15) bits), 2 XTR2 (the rest), flag 0 where the
//              event is absent (past n_tok, or 0 bits), T' = ceil(n_tok / S);
//   K3         k3_kernel<3> over the T' steps: the states, each event's
//              emission flag and word (its slots from 2 down, so XTR2,
//              XTR1, SYM, as the encoder must put them);
//   K3p        the flags bit-packed;
//   K3b        the flagged words compacted in (step, slot, lane) order:
//              the stream in the decoder's order.
// Bound on the H100: T' dependent steps of three puts a lane (K3's chain);
// the bytes (12 per token read, 2 per word written) are far below that.
// The token's words must be what K8 writes: xtr below 2^bits.
#include "ppm_r.cuh"
#include "f2scan.cuh"

// rans.cu's entries (one shared library)
extern "C" int cpx_k3_launch(int G, int S, int T, int n_slots, const void* ev,
                             void* states, void* emit, void* words, void* stream);
extern "C" int cpx_k3p_launch(int n_out, const void* emit, void* packed, void* stream);
extern "C" int cpx_k3b_launch(int G, int S, int rows, const void* mask, const void* words,
                              void* parts, void* n_words, void* stream_out, void* stream);

namespace {

#define W_SYM 581
#define K9_EV_THREADS 256
#define K9_HIST_PER 4096  // tokens a CTA of the histogram

__global__ void k9_hist(int n_tok, const int* __restrict__ sym,
                        int* __restrict__ hist) {
  __shared__ int h[W_SYM];
  for (int u = threadIdx.x; u < W_SYM; u += blockDim.x) h[u] = 0;
  __syncthreads();
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n_tok;
       k += gridDim.x * blockDim.x) {
    const int s = sym[k];
    if (s >= 0 && s < W_SYM) atomicAdd(&h[s], 1);
  }
  __syncthreads();
  for (int u = threadIdx.x; u < W_SYM; u += blockDim.x)
    if (h[u]) atomicAdd(&hist[u], h[u]);
}

// The sum of v over the CTA; acc is a shared int this call owns.
__device__ int cta_sum(int v, int* acc) {
  __syncthreads();
  if (threadIdx.x == 0) *acc = 0;
  __syncthreads();
  if (v) atomicAdd(acc, v);
  __syncthreads();
  return *acc;
}

// hist [581] -> freq [581] and cum [581], cum[j] the sum of freq[0 .. j).
__global__ void __launch_bounds__(1024) k9_norm(const int* __restrict__ hist,
                                                int* __restrict__ freq,
                                                int* __restrict__ cum) {
  __shared__ int acc, best;
  __shared__ CountLast wsum[32];
  const int j = threadIdx.x;
  int h = j < W_SYM ? max(hist[j], 0) : 0;
  int total = cta_sum(h, &acc);
  while (total >= (1 << 15)) {
    h = h > 0 ? max(h >> 1, 1) : 0;
    total = cta_sum(h, &acc);
  }
  const int n2 = max(total, 1);
  int s = h > 0 ? max(1, (h << M_BITS) / n2) : 0;  // h < 2^15: no overflow
  const int drift = (int)RANS_M - cta_sum(s, &acc);
  // the first largest: the largest key s << 10 | 1023 - j
  if (j == 0) best = 0;
  __syncthreads();
  if (j < W_SYM) atomicMax(&best, (s << 10) | (1023 - j));
  __syncthreads();
  if (j == 1023 - (best & 1023)) s += drift;
  CountLast all;
  const int below = cta_excl_scan(CountLast{s, 0}, wsum, all).cnt;
  if (j < W_SYM) {
    freq[j] = s;
    cum[j] = below;
  }
}

// Token k = t S + l at step t, lane l: ev[t][3 e + (0, 1, 2)][l] = (c, f,
// flag) of its event e (0 SYM, 1 XTR1, 2 XTR2).
__global__ void __launch_bounds__(K9_EV_THREADS) k9_events(
    int S, int n_tok, long long cells, const int* __restrict__ sym,
    const int* __restrict__ xtr, const int* __restrict__ tbits,
    const int* __restrict__ freq, const int* __restrict__ cum, int* __restrict__ ev) {
  const long long k = (long long)blockIdx.x * K9_EV_THREADS + threadIdx.x;
  if (k >= cells) return;
  const bool act = k < n_tok;
  const int sy = act ? min(max(sym[k], 0), W_SYM - 1) : 0;
  const uint32_t xt = act ? (uint32_t)xtr[k] : 0u;
  const int tb = act ? tbits[k] : 0;
  const int b1 = min(max(tb, 0), M_BITS);
  const int b2 = min(max(tb - min(tb, M_BITS), 0), M_BITS);
  const uint32_t f1 = 1u << (M_BITS - b1), f2 = 1u << (M_BITS - b2);
  const long long t = k / S, l = k - t * S;
  int* const e = ev + t * 9 * S + l;
  e[0] = act ? cum[sy] : 0;
  e[S] = act ? freq[sy] : 0;
  e[2 * S] = act;
  e[3 * S] = b1 > 0 ? (int)((xt & (RANS_M - 1u)) * f1) : 0;
  e[4 * S] = (int)f1;
  e[5 * S] = b1 > 0;
  e[6 * S] = b2 > 0 ? (int)((xt >> M_BITS) * f2) : 0;
  e[7 * S] = (int)f2;
  e[8 * S] = b2 > 0;
}

// No token: every state stays RANS_L and no word is written.
__global__ void k9_no_tokens(int S, long long* __restrict__ states, int* __restrict__ n_words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < S) states[i] = (long long)RANS_L;
  if (i == 0) *n_words = 0;
}

}  // namespace

// sym, xtr, tbits: int32, at least n_tok each; 8 <= S <= 8192 lanes, a
// multiple of 8.  hist [2, 581] ints, the first row zero (the second
// takes the cumulative frequencies); with T' = ceil(n_tok / S) and rows =
// 3 T': ev [T', 9, S] int32, emit [T', 3, S] u8, words [T', 3, S] int32,
// packed [T', 3, S / 8] u8, parts [cpx_k3b_tiles(S, rows) + 1] 8-byte
// scratch; out: freq [581], states [S] int64, n_words [1], stream_out
// [rows * S] int16 (its first n_words the stream, in the decoder's order).
extern "C" int cpx_k9_launch(int S, int n_tok, const void* sym, const void* xtr,
                             const void* tbits, void* hist, void* freq, void* states,
                             void* ev, void* emit, void* words, void* packed, void* parts,
                             void* n_words, void* stream_out, void* stream) {
  if (S < 8 || S % 8 || S > CPX_MAX_LPT * CPX_MAX_LANES || n_tok < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* const cum = (int*)hist + W_SYM;
  if (n_tok > 0) {
    // K9_HIST_PER tokens a CTA, at most two CTAs an SM: each CTA adds its
    // 581 counters to the global ones once
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int blocks = min((n_tok + K9_HIST_PER - 1) / K9_HIST_PER, 2 * sms);
    k9_hist<<<blocks, 256, 0, st>>>(n_tok, (const int*)sym, (int*)hist);
  }
  k9_norm<<<1, 1024, 0, st>>>((const int*)hist, (int*)freq, cum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int steps = (n_tok + S - 1) / S;
  if (steps == 0) {
    k9_no_tokens<<<(S + 255) / 256, 256, 0, st>>>(S, (long long*)states, (int*)n_words);
    return (int)cudaGetLastError();
  }
  const long long cells = (long long)steps * S;
  k9_events<<<(unsigned)((cells + K9_EV_THREADS - 1) / K9_EV_THREADS), K9_EV_THREADS, 0,
              st>>>(S, n_tok, cells, (const int*)sym, (const int*)xtr, (const int*)tbits,
                    (const int*)freq, cum, (int*)ev);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int rc = cpx_k3_launch(1, S, steps, 3, ev, states, emit, words, stream);
  if (rc != 0) return rc;
  rc = cpx_k3p_launch((int)(cells * 3 / 8), emit, packed, stream);
  if (rc != 0) return rc;
  return cpx_k3b_launch(1, S, 3 * steps, packed, words, parts, n_words, stream_out, stream);
}
