// K10: the static rANS decoder of the fast profile (mode F).
//
// Replaces comprox_tpu/codec/fast.py::_build_dec_table (524),
// _fast_decode_scan (538-603) and _token_plane (606-639).  From the static
// table, the final states and the stream: the slot table (for each of the
// M = 2^15 slots its symbol, cumulated frequency and frequency); then
// ceil(n_tok / S) steps of one token per lane: the symbol by one table row
// at x & (M - 1), then the token's up to two uniform events, each advance
// followed by a word read in ascending lane order; then one u32 per token —
// a literal byte, or dist << 8 | len - min_len with every repeat distance
// replaced by the last explicit one before it.  The LZ copies stay on the
// host (utils/native.py::f2_execute), as in the JAX package.
//
// Bound on the H100: the loop is ceil(n_tok / S) dependent steps, each a
// table row read and three advances with a CTA-wide prefix count; the bytes
// (2 per word read, 4 per token written, the 256 KB table and 8 per token
// of scratch) are far below that.  One CTA, one thread per lane up to 1024
// lanes and 2, 4 or 8 lanes a thread above that (as K9); the word reads as
// in the adaptive decoder (a ballot and a 32-entry prefix instead of JAX's one-hot [S, S]
// product, the window start clamped like lax.dynamic_slice).  The plane is
// elementwise but for the distance fill, a prefix scan (f2scan.cuh) over
// the n_tok tokens; JAX's N-slot grids, zero past n_tok, have no counterpart.
#include "ppm_r.cuh"
#include "f2scan.cuh"

namespace {

#define W_SYM 581
#define L_DIRECT 8
#define L_BUCKETS 13
#define DB_REPEAT 24

__global__ void __launch_bounds__(256) k10_table(const int* __restrict__ freq,
                                                 int* __restrict__ dtab) {
  __shared__ int cum[W_SYM + 1];
  if (threadIdx.x == 0) {
    int run = 0;
    for (int u = 0; u < W_SYM; ++u) {
      cum[u] = run;
      run += freq[u];
    }
    cum[W_SYM] = run;
  }
  __syncthreads();
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= (int)RANS_M) return;
  // sym = (number of cum[u] <= slot, u < W_SYM) - 1; cum[0] = 0 <= slot
  int lo = 0, hi = W_SYM;  // cum[lo] <= slot, and cum[hi] > slot or hi = W_SYM
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= slot) lo = mid; else hi = mid;
  }
  dtab[2 * slot] = lo | (cum[lo] << 10);
  dtab[2 * slot + 1] = cum[lo + 1] - cum[lo];
}

struct TokenBits {
  bool is_m;
  int db, lb, len_bits, dist_bits;
};

__device__ __forceinline__ TokenBits token_bits(bool act, int sym) {
  TokenBits b;
  b.is_m = act && sym >= 256;
  const int mc = b.is_m ? sym - 256 : 0;
  b.db = mc / L_BUCKETS;
  b.lb = mc % L_BUCKETS;
  b.len_bits = b.lb >= L_DIRECT ? b.lb - 5 : 0;
  b.dist_bits = (b.is_m && b.db < DB_REPEAT) ? b.db : 0;
  return b;
}

// LPT lanes a thread, as K9: lane threadIdx.x + r * blockDim.x in slot r.
// Every event of a step reads its words from one window, whose start is
// the event's first word clamped like lax.dynamic_slice; the slots read it
// in ascending lane order.
template <int LPT>
__global__ void __launch_bounds__(CPX_MAX_LANES) k10_decode(
    int S, int n_tok, int stream_len, const int* __restrict__ stream,
    const int* __restrict__ dtab, long long* __restrict__ states,
    int* __restrict__ sym_g, int* __restrict__ xtr_g, int* __restrict__ used) {
  __shared__ int wtot[2][32];
  const int nt = blockDim.x;
  uint32_t x[LPT];
#pragma unroll
  for (int r = 0; r < LPT; ++r) {
    const int i = threadIdx.x + r * nt;
    x[r] = i < S ? (uint32_t)states[i] : RANS_L;
  }
  int base = 0, ph = 0;
  const int last_start = stream_len - S;  // the window's start is clamped

  for (int t = 0; t < (n_tok + S - 1) / S; ++t) {
    int sym[LPT], e0[LPT], e1[LPT], b1[LPT], b2[LPT];
    bool act[LPT];
    uint32_t v[LPT][3];
#pragma unroll
    for (int r = 0; r < LPT; ++r) {
      const int i = threadIdx.x + r * nt;
      act[r] = i < S && t * S + i < n_tok;
      const uint32_t slot = x[r] & (RANS_M - 1u);
      e0[r] = dtab[2 * slot];
      e1[r] = dtab[2 * slot + 1];
      sym[r] = e0[r] & 1023;
      const TokenBits tb = token_bits(act[r], sym[r]);
      const int tbits = tb.is_m ? tb.len_bits + tb.dist_bits : 0;
      b1[r] = min(tbits, M_BITS);
      b2[r] = tbits - b1[r];
      v[r][0] = v[r][1] = v[r][2] = 0u;
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int st = max(0, min(base, last_start));
      int off = 0;  // words the slots below this one read in this event
#pragma unroll
      for (int r = 0; r < LPT; ++r) {
        const bool alive = threadIdx.x + r * nt < S;
        // slot 0: the symbol; slots 1, 2: uniform events of b1, b2 bits
        uint32_t c = 0u, f = RANS_M;
        if (s == 0) {
          if (act[r]) {
            c = (uint32_t)(e0[r] >> 10);
            f = (uint32_t)e1[r];
          }
        } else {
          const int b = s == 1 ? b1[r] : b2[r];
          if (b > 0) {
            f = 1u << (M_BITS - b);
            v[r][s] = (x[r] & (RANS_M - 1u)) / f;
            c = v[r][s] * f;
          }
        }
        const uint32_t xt = dec_advance(x[r], c, f);
        const bool need = alive && xt < RANS_L;
        const int inw = cta_excl_prefix_a(need, wtot[ph]);
        __syncthreads();
        int total;
        const int ex = cta_excl_prefix_b(inw, wtot[ph], total);
        ph ^= 1;  // the next prefix writes the other scratch, a barrier later
        x[r] = need ? (xt << 16) | ((uint32_t)stream[st + off + ex] & 0xFFFFu) : xt;
        off += total;
      }
      base += off;
    }
#pragma unroll
    for (int r = 0; r < LPT; ++r) {
      const int k = t * S + threadIdx.x + r * nt;
      if (act[r]) {
        sym_g[k] = sym[r];
        xtr_g[k] = (int)(v[r][1] | (v[r][2] << M_BITS));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < LPT; ++r)
    if (threadIdx.x + r * nt < S) states[threadIdx.x + r * nt] = (long long)x[r];
  if (threadIdx.x == 0) *used = base;
}

// The explicit distance of token k, 0 for a literal, a repeat or past n_tok.
__device__ __forceinline__ int explicit_dist(int k, int n_tok, const int* sym_g,
                                             const int* xtr_g) {
  if (k >= n_tok) return 0;
  const TokenBits tb = token_bits(true, sym_g[k]);
  if (!tb.is_m || tb.db >= DB_REPEAT) return 0;
  const int dmant = (int)((uint32_t)xtr_g[k] >> tb.len_bits);
  return max((1 << min(tb.db, 23)) + dmant, 0);
}

__global__ void __launch_bounds__(SCAN_THREADS) k10_reduce(
    int n_tok, const int* __restrict__ sym_g, const int* __restrict__ xtr_g,
    CountLast* __restrict__ parts) {
  __shared__ CountLast wsum[32];
  const int base = blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_PER;
  CountLast v{0, 0};
  for (int k = 0; k < SCAN_PER; ++k)
    v = combine(v, CountLast{0, explicit_dist(base + k, n_tok, sym_g, xtr_g)});
  CountLast total;
  cta_excl_scan(v, wsum, total);
  if (threadIdx.x == 0) parts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(SCAN_THREADS) k10_plane(
    int n_tok, const int* __restrict__ sym_g, const int* __restrict__ xtr_g,
    const CountLast* __restrict__ parts, int* __restrict__ plane) {
  __shared__ CountLast wsum[32];
  const int base = blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_PER;
  int dist_e[SCAN_PER];
  CountLast v{0, 0};
#pragma unroll
  for (int k = 0; k < SCAN_PER; ++k) {
    dist_e[k] = explicit_dist(base + k, n_tok, sym_g, xtr_g);
    v = combine(v, CountLast{0, dist_e[k]});
  }
  CountLast total;
  CountLast run = combine(parts[blockIdx.x], cta_excl_scan(v, wsum, total));
#pragma unroll
  for (int k = 0; k < SCAN_PER; ++k) {
    const int i = base + k;
    if (i >= n_tok) break;
    run = combine(run, CountLast{0, dist_e[k]});  // the last explicit one <= i
    const int sym = sym_g[i];
    const TokenBits tb = token_bits(true, sym);
    uint32_t out = (uint32_t)sym;
    if (tb.is_m) {
      const uint32_t xtr = (uint32_t)xtr_g[i];
      const int len_mant = (int)(xtr & ((1u << tb.len_bits) - 1u));
      int v_len = tb.lb;
      if (tb.lb >= L_DIRECT) v_len = (1 << min(max(tb.lb - 5, 0), 7)) + len_mant;
      v_len = min(max(v_len, 0), 255);
      const int dist = tb.db == DB_REPEAT ? max(run.last, 1) : dist_e[k];
      out = ((uint32_t)min(max(dist, 1), (1 << 24) - 1) << 8) | (uint32_t)v_len;
    }
    plane[i] = (int)out;
  }
}

}  // namespace

// freq [581]; states [S] int64, updated in place; stream [stream_len] int32
// (u16 words, stream_len >= S), S <= 8192 lanes; dtab [M, 2] scratch; grids [2, n_tok]
// scratch (sym, xtr); parts [tiles(n_tok) + 1, 2] scratch; plane [n_tok];
// used [1].
extern "C" int cpx_k10_launch(int S, int n_tok, int stream_len, const void* freq,
                              void* states, const void* stream, void* dtab,
                              void* grids, void* parts, void* plane, void* used,
                              void* cuda_stream) {
  if (S < 1 || S > CPX_MAX_LPT * CPX_MAX_LANES || n_tok < 0 || stream_len < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  int* const g = (int*)grids;
  const int tiles = (n_tok + SCAN_TILE - 1) / SCAN_TILE;
  k10_table<<<(int)RANS_M / 256, 256, 0, st>>>((const int*)freq, (int*)dtab);
  const int lpt = lanes_per_thread(S);
  auto decode = lpt == 1 ? k10_decode<1> : lpt == 2 ? k10_decode<2>
              : lpt == 4 ? k10_decode<4> : k10_decode<8>;
  decode<<<1, lpt == 1 ? (S + 31) / 32 * 32 : CPX_MAX_LANES, 0, st>>>(
      S, n_tok, stream_len, (const int*)stream, (const int*)dtab,
      (long long*)states, g, g + n_tok, (int*)used);
  if (tiles > 0) {
    k10_reduce<<<tiles, SCAN_THREADS, 0, st>>>(n_tok, g, g + n_tok,
                                               (CountLast*)parts);
    scan_parts<<<1, 1024, 0, st>>>((CountLast*)parts, tiles);
    k10_plane<<<tiles, SCAN_THREADS, 0, st>>>(n_tok, g, g + n_tok,
                                              (const CountLast*)parts, (int*)plane);
  }
  return (int)cudaGetLastError();
}
