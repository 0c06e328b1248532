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
// token read, 2 per word written) are far below that.  One CTA, one thread
// per lane up to 1024 lanes, like the adaptive encoder's scans, and above
// that 2, 4 or 8 lanes a thread (up to 8192), each slot of lanes its own
// prefix count; the table (581 pairs) sits in shared memory.
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

// The (cum, freq) of event s of a token (0: XTR2, 1: XTR1, 2: SYM).
__device__ __forceinline__ void k9_event(int s, bool act, int sy, uint32_t xt, int tb,
                                         const int* cum_s, const int* frq_s,
                                         uint32_t& c, uint32_t& f) {
  const int b1 = min(max(min(tb, M_BITS), 0), M_BITS);
  const int b2 = min(max(tb - min(tb, M_BITS), 0), M_BITS);
  if (s == 0) {
    f = 1u << (M_BITS - b2);
    c = b2 > 0 ? (xt >> M_BITS) * f : 0u;
  } else if (s == 1) {
    f = 1u << (M_BITS - b1);
    c = b1 > 0 ? (xt & (RANS_M - 1u)) * f : 0u;
  } else {
    c = act ? (uint32_t)cum_s[sy] : 0u;
    f = act ? (uint32_t)frq_s[sy] : RANS_M;
  }
}

// LPT lanes a thread: lane threadIdx.x + r * blockDim.x in its slot r, so
// each slot is a run of consecutive lanes in thread order and a block of
// up to LPT * 1024 lanes fits one CTA.
template <int LPT>
__global__ void __launch_bounds__(CPX_MAX_LANES) k9_encode(
    int S, int n_tok, const int* __restrict__ sym, const int* __restrict__ xtr,
    const int* __restrict__ tbits, const int* __restrict__ freq,
    long long* __restrict__ states, int* __restrict__ buf,
    int* __restrict__ n_words) {
  __shared__ int cum_s[W_SYM], frq_s[W_SYM];
  __shared__ int wtot[2][32];
  const int nt = blockDim.x;
  for (int u = threadIdx.x; u < W_SYM; u += nt) frq_s[u] = freq[u];
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int u = 0; u < W_SYM; ++u) {
      cum_s[u] = run;
      run += frq_s[u];
    }
  }
  __syncthreads();
  uint32_t x[LPT];
#pragma unroll
  for (int r = 0; r < LPT; ++r) x[r] = RANS_L;
  int cur = 0, ph = 0;
  for (int t = (n_tok + S - 1) / S - 1; t >= 0; --t) {
    int sy[LPT], tb[LPT];
    uint32_t xt[LPT];
#pragma unroll
    for (int r = 0; r < LPT; ++r) {
      const int i = threadIdx.x + r * nt, k = t * S + i;
      const bool act = i < S && k < n_tok;
      sy[r] = act ? min(max(sym[k], 0), W_SYM - 1) : -1;  // -1: no token
      xt[r] = act ? (uint32_t)xtr[k] : 0u;
      tb[r] = act ? tbits[k] : 0;
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      // the emitting lanes above this one write first: the slots from the
      // highest lanes down, each in descending lane order
#pragma unroll
      for (int r = LPT - 1; r >= 0; --r) {
        const bool alive = threadIdx.x + r * nt < S;
        uint32_t c, f;
        k9_event(s, sy[r] >= 0, max(sy[r], 0), xt[r], tb[r], cum_s, frq_s, c, f);
        const bool emit = alive && (x[r] >> (32 - M_BITS)) >= f;
        const uint32_t word = x[r] & 0xFFFFu;
        const int inw = cta_excl_prefix_a(emit, wtot[ph]);
        __syncthreads();
        int total;
        const int ex = cta_excl_prefix_b(inw, wtot[ph], total);
        ph ^= 1;  // the next prefix writes the other scratch, a barrier later
        if (emit) {
          buf[cur + (total - 1 - ex)] = (int)word;
          x[r] >>= 16;
        }
        cur += total;
        if (alive) x[r] = ((x[r] / f) << M_BITS) + c + (x[r] % f);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < LPT; ++r)
    if (threadIdx.x + r * nt < S) states[threadIdx.x + r * nt] = (long long)x[r];
  if (threadIdx.x == 0) *n_words = cur;
}

}  // namespace

// sym, xtr, tbits: int32, at least n_tok each; S <= 8192 lanes.  hist [581] must be zero.
// buf holds at least N + 3 * S + 16 ints (fast.py::_max_words).
extern "C" int cpx_k9_launch(int S, int n_tok, const void* sym, const void* xtr,
                             const void* tbits, void* hist, void* freq,
                             void* states, void* buf, void* n_words,
                             void* stream) {
  if (S < 1 || S > CPX_MAX_LPT * CPX_MAX_LANES || n_tok < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_tok > 0) {
    const int blocks = min((n_tok + 255) / 256, 1024);
    k9_hist<<<blocks, 256, 0, st>>>(n_tok, (const int*)sym, (int*)hist);
  }
  k9_norm<<<1, 1024, 0, st>>>((const int*)hist, (int*)freq);
  const int lpt = lanes_per_thread(S);
  auto kernel = lpt == 1 ? k9_encode<1> : lpt == 2 ? k9_encode<2>
              : lpt == 4 ? k9_encode<4> : k9_encode<8>;
  kernel<<<1, lpt == 1 ? (S + 31) / 32 * 32 : CPX_MAX_LANES, 0, st>>>(
      S, n_tok, (const int*)sym, (const int*)xtr, (const int*)tbits,
      (const int*)freq, (long long*)states, (int*)buf, (int*)n_words);
  return (int)cudaGetLastError();
}
