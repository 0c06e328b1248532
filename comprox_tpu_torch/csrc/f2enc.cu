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
// its event into its own 32-bit state and emitting at most one u16 word.
// The words of one slot go to the output in descending lane order — the
// reverse of the decoder's ascending reads — so the output reversed is the
// stream.  JAX writes them with a transposed one-hot float product; here a
// lane's place is a ballot and a 32-entry prefix, and nothing goes through
// a float unit.
//
// Bound on the H100: ceil(n_tok / S) dependent steps of three puts (a
// 32-bit division each) and three CTA-wide prefix counts; the bytes (12 per
// token read, 2 per word written) are far below that.  One CTA of one
// thread per lane, like the adaptive encoder's scans; the table (581 pairs)
// sits in shared memory.
#include "ppm_r.cuh"

namespace {

#define W_SYM 581

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

__global__ void __launch_bounds__(1024) k9_norm(const int* __restrict__ hist,
                                                int* __restrict__ freq) {
  __shared__ int acc, best;
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
  if (j < W_SYM) freq[j] = s;
}

__global__ void __launch_bounds__(CPX_MAX_LANES) k9_encode(
    int S, int n_tok, const int* __restrict__ sym, const int* __restrict__ xtr,
    const int* __restrict__ tbits, const int* __restrict__ freq,
    long long* __restrict__ states, int* __restrict__ buf,
    int* __restrict__ n_words) {
  __shared__ int cum_s[W_SYM], frq_s[W_SYM];
  __shared__ int wtot[3][32];
  const int i = threadIdx.x;
  const bool alive = i < S;
  for (int u = i; u < W_SYM; u += blockDim.x) frq_s[u] = freq[u];
  __syncthreads();
  if (i == 0) {
    int run = 0;
    for (int u = 0; u < W_SYM; ++u) {
      cum_s[u] = run;
      run += frq_s[u];
    }
  }
  __syncthreads();
  uint32_t x = RANS_L;
  int cur = 0;
  for (int t = (n_tok + S - 1) / S - 1; t >= 0; --t) {
    const int k = t * S + i;
    const bool act = alive && k < n_tok;
    const int sy = act ? min(max(sym[k], 0), W_SYM - 1) : 0;
    const uint32_t xt = act ? (uint32_t)xtr[k] : 0u;
    const int tb = act ? tbits[k] : 0;
    const int b1 = min(max(min(tb, M_BITS), 0), M_BITS);
    const int b2 = min(max(tb - min(tb, M_BITS), 0), M_BITS);
    uint32_t c[3], f[3];
    // XTR2, XTR1: uniform events of b bits; SYM: the table's (cum, freq)
    f[0] = 1u << (M_BITS - b2);
    c[0] = b2 > 0 ? (xt >> M_BITS) * f[0] : 0u;
    f[1] = 1u << (M_BITS - b1);
    c[1] = b1 > 0 ? (xt & (RANS_M - 1u)) * f[1] : 0u;
    c[2] = act ? (uint32_t)cum_s[sy] : 0u;
    f[2] = act ? (uint32_t)frq_s[sy] : RANS_M;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const bool emit = alive && (x >> (32 - M_BITS)) >= f[s];
      const uint32_t word = x & 0xFFFFu;
      const int inw = cta_excl_prefix_a(emit, wtot[s]);
      __syncthreads();
      int total;
      const int ex = cta_excl_prefix_b(inw, wtot[s], total);
      // the emitting lanes above this one write first
      if (emit) {
        buf[cur + (total - 1 - ex)] = (int)word;
        x >>= 16;
      }
      cur += total;
      if (alive) x = ((x / f[s]) << M_BITS) + c[s] + (x % f[s]);
    }
  }
  if (alive) states[i] = (long long)x;
  if (i == 0) *n_words = cur;
}

}  // namespace

// sym, xtr, tbits: int32, at least n_tok each.  hist [581] must be zero.
// buf holds at least N + 3 * S + 16 ints (fast.py::_max_words).
extern "C" int cpx_k9_launch(int S, int n_tok, const void* sym, const void* xtr,
                             const void* tbits, void* hist, void* freq,
                             void* states, void* buf, void* n_words,
                             void* stream) {
  if (S < 1 || S > CPX_MAX_LANES || n_tok < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_tok > 0) {
    const int blocks = min((n_tok + 255) / 256, 1024);
    k9_hist<<<blocks, 256, 0, st>>>(n_tok, (const int*)sym, (int*)hist);
  }
  k9_norm<<<1, 1024, 0, st>>>((const int*)hist, (int*)freq);
  k9_encode<<<1, (S + 31) / 32 * 32, 0, st>>>(
      S, n_tok, (const int*)sym, (const int*)xtr, (const int*)tbits,
      (const int*)freq, (long long*)states, (int*)buf, (int*)n_words);
  return (int)cudaGetLastError();
}
