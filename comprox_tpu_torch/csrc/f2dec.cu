// K10: the static rANS decoder of the fast profile (mode F).
//
// Replaces comprox_tpu/codec/fast.py::_build_dec_table (524),
// _fast_decode_scan (538-603) and _token_plane (606-639).  From the static
// table, the final states and the stream: ceil(n_tok / S) steps of one
// token per lane: the symbol by the slot table at x & (M - 1), then the
// token's up to two uniform events, each advance followed by a word read
// in ascending lane order; then one u32 per token — a literal byte, or
// dist << 8 | len - min_len with every repeat distance replaced by the
// last explicit one before it.  The LZ copies stay on the host
// (utils/native.py::f2_execute), as in the JAX package.
//
// Bound on the H100: the loop is ceil(n_tok / S) dependent steps of three
// advances, each with a CTA-wide prefix count (the words a lane reads
// depend on every lower lane's need), so its latency a step, not bytes or
// operations, bounds it; with every lane of the CTA in it, each event's
// per-warp work (ballots, the barrier, the prefix) is issued by every warp.
// One CTA of one lane a thread (adjacent lanes a thread as K9's above 1024
// lanes, up to eight), the prefix a ballot a lane slot and one barrier an
// event for all of them (cta_excl_prefix_b), a uniform event's quotient a
// shift, its shifts from a table a symbol.  Nothing of the loop's
// dependent chain goes to device memory: the prologue builds the slot
// table in shared memory (each of the M slots' symbol as a u16, each
// symbol's cum | freq << 16), and the stream comes through a ring of
// K10_RING words in shared memory that cp.async keeps filled ahead of the
// read cursor.  An event reads at most S words from its window start st
// (the event's first word clamped like lax.dynamic_slice: st = max(0,
// min(base, stream_len - S))), so a step reads below base + 3S; after each
// step the ring is refilled up to the last event's st + K10_RING (every
// word below that st was read before the event's barrier), which covers
// the next step's reads while K10_RING >= 4S, and the copies of a step's
// words are waited for just before its first barrier.  The clamped window
// is the stream's last S words, which stay in the ring once copied.  The
// plane is elementwise but for the distance fill, a prefix scan
// (f2scan.cuh) over the n_tok tokens; JAX's N-slot grids, zero past n_tok,
// have no counterpart.
#include "ppm_r.cuh"
#include "f2scan.cuh"

namespace {

#define W_SYM 581
#define L_DIRECT 8
#define L_BUCKETS 13
#define DB_REPEAT 24

#define K10_RING 32768  // words of the stream ring (fast.py::K10_RING), a power of two
// dynamic shared memory: the ring, the slot table, the symbols' (cum,
// freq), the cumulated frequencies and the symbols' shifts
#define K10_SMEM (K10_RING * 4 + (int)RANS_M * 2 + W_SYM * 4 + (W_SYM + 1) * 4 + \
                  (W_SYM + 1) / 2 * 4)

static __device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

static __device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Copy stream words [lo, hi) into their ring slots as one group: whole
// aligned runs of four words 16 bytes a copy (the stream 16-byte aligned),
// the ragged ends a word a copy.
static __device__ __forceinline__ void ring_fill(int* ring, const int* stream, int lo,
                                                 int hi) {
  const int a = min((lo + 3) & ~3, hi), b = max(hi & ~3, a);
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int w = a + 4 * tid; w < b; w += 4 * nt)
    cp_async16(ring + (w & (K10_RING - 1)), stream + w);
  if (tid < a - lo) cp_async4(ring + ((lo + tid) & (K10_RING - 1)), stream + lo + tid);
  if (tid < hi - b) cp_async4(ring + ((b + tid) & (K10_RING - 1)), stream + b + tid);
  cp_async_commit();
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

// An active token of symbol sym: its uniform events' shifts, sh1 | sh2 <<
// 8 (f = 2^sh; an event of 0 bits has sh = M_BITS and leaves x as it is).
__device__ __forceinline__ uint16_t token_shifts(int sym) {
  const TokenBits tb = token_bits(true, sym);
  const int tbits = tb.is_m ? tb.len_bits + tb.dist_bits : 0;
  const int b1 = min(tbits, M_BITS);
  return (uint16_t)((M_BITS - b1) | ((M_BITS - (tbits - b1)) << 8));
}

// The slot table in shared memory (fast.py::_build_dec_table): cf[u] =
// cum[u] | freq[u] << 16, shx[u] = the shifts of symbol u's two uniform
// events (token_shifts) and, for every slot s, sym[s] = the last u with
// cum[u] <= s (the number of cum[u] <= s, less one).  A warp takes a run
// of slots 32 at a time, a lane finding its first slot's symbol by a
// binary search over cum and then stepping it forward.  Ends with a
// barrier.
static __device__ void build_slot_table(const int* __restrict__ freq, int* cum,
                                        uint32_t* cf, uint16_t* sym, uint16_t* shx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  if (warp == 0) {
    // cum by warp 0: a run of ceil(W / 32) symbols a lane
    const int per = (W_SYM + 31) / 32, b = lane * per, e = min(b + per, W_SYM);
    int sum = 0;
    for (int u = b; u < e; ++u) sum += freq[u];
    int inc = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += o;
    }
    int run = inc - sum;
    for (int u = b; u < e; ++u) {
      const int f = freq[u];
      cum[u] = run;
      cf[u] = (uint32_t)run | ((uint32_t)f << 16);
      shx[u] = token_shifts(u);
      run += f;
    }
    if (lane == 31) cum[W_SYM] = run;
  }
  __syncthreads();
  const int span = ((int)RANS_M / nwarps + 31) / 32 * 32;  // slots a warp
  const int s0 = warp * span, s1 = min(s0 + span, (int)RANS_M);
  if (s0 + lane < s1) {
    int lo = 0, hi = W_SYM;  // cum[lo] <= s, and cum[hi] > s or hi = W
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid] <= s0 + lane) lo = mid; else hi = mid;
    }
    for (int s = s0 + lane; s < s1; s += 32) {
      while (lo + 1 < W_SYM && cum[lo + 1] <= s) ++lo;
      sym[s] = (uint16_t)lo;
    }
  }
  __syncthreads();
}

// LPT adjacent lanes a thread: lane threadIdx.x * LPT + r in slot r.  Every
// event of a step reads its words from one window, whose start is the
// event's first word clamped like lax.dynamic_slice; the lanes read it in
// ascending lane order, all of a CTA's lanes in one prefix round (a ballot
// a slot, one barrier).
template <int LPT>
__global__ void __launch_bounds__(CPX_MAX_LANES) k10_decode(
    int S, int n_tok, int stream_len, const int* __restrict__ freq,
    const int* __restrict__ stream, long long* __restrict__ states,
    int* __restrict__ sym_g, int* __restrict__ xtr_g, int* __restrict__ used) {
  extern __shared__ __align__(16) unsigned char k10_smem[];
  int* const ring = reinterpret_cast<int*>(k10_smem);
  uint16_t* const symtab = reinterpret_cast<uint16_t*>(ring + K10_RING);
  uint32_t* const cf = reinterpret_cast<uint32_t*>(symtab + RANS_M);
  int* const cum = reinterpret_cast<int*>(cf + W_SYM);
  uint16_t* const shx = reinterpret_cast<uint16_t*>(cum + W_SYM + 1);
  __shared__ int wtot[2][32];
  const unsigned full = 0xffffffffu;
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;  // the warp's lower threads
  const int i0 = threadIdx.x * LPT;  // this thread's first lane
  // the ring's first K10_RING words in flight while the table is built
  int fill = min(K10_RING, stream_len);
  ring_fill(ring, stream, 0, fill);
  build_slot_table(freq, cum, cf, symtab, shx);
  uint32_t x[LPT];
#pragma unroll
  for (int r = 0; r < LPT; ++r) x[r] = i0 + r < S ? (uint32_t)states[i0 + r] : RANS_L;
  // at most one refill is in flight (a refill waits for the one before);
  // the words below `landed` are in the ring, seen by every thread after
  // the next barrier
  int landed = 0;
  int base = 0, ph = 0;
  const int last_start = stream_len - S;  // the window's start is clamped
  const int steps = (n_tok + S - 1) / S;
  // a step's symbols, looked up at the end of the step before: each lane's
  // symbol and its (cum, freq), and each uniform event's shift (f = 2^sh;
  // b = 0 bits: sh = M_BITS, x unchanged)
  int sym[LPT];
  uint32_t cfs[LPT], shs[LPT];
  auto lookup = [&](int t) {
    const int live = min(S, n_tok - t * S);  // the lanes with a token this step
#pragma unroll
    for (int r = 0; r < LPT; ++r) {
      const bool act = i0 + r < live;
      sym[r] = symtab[x[r] & (RANS_M - 1u)];
      cfs[r] = act ? cf[sym[r]] : RANS_M << 16;                  // (0, M) past n_tok
      shs[r] = act ? shx[sym[r]] : M_BITS | (M_BITS << 8);  // x as it is
    }
  };
  lookup(0);
  for (int t = 0; t < steps; ++t) {
    // this step reads below min(base + 3S, stream_len): the refills up to
    // the oldest one that reaches that far must have landed (the step's
    // first barrier then shows them to every thread)
    if (min(base + 3 * S, stream_len) > landed) {
      cp_async_wait_all();
      landed = fill;
    }
    uint32_t v[LPT][3];
    int st = 0;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      st = max(0, min(base, last_start));
      uint32_t xt[LPT];
      bool rd[LPT];
      int inw = 0, warp_words = 0;  // words of the warp's lower threads, and all its
#pragma unroll
      for (int r = 0; r < LPT; ++r) {
        if (s == 0) {
          xt[r] = dec_advance(x[r], cfs[r] & 0xFFFFu, cfs[r] >> 16);
        } else {
          const int k = (shs[r] >> (s == 1 ? 0 : 8)) & 0xFF;
          v[r][s] = (x[r] & (RANS_M - 1u)) >> k;
          xt[r] = ((x[r] >> M_BITS) << k) | (x[r] & ((1u << k) - 1u));
        }
        rd[r] = i0 + r < S && xt[r] < RANS_L;
        const unsigned bal = __ballot_sync(full, rd[r]);
        inw += __popc(bal & below);
        warp_words += __popc(bal);
      }
      if ((threadIdx.x & 31) == 0) wtot[ph][threadIdx.x >> 5] = warp_words;
      __syncthreads();
      int total;
      int w = st + cta_excl_prefix_b(inw, wtot[ph], total);
      ph ^= 1;  // the next prefix writes the other scratch, a barrier later
#pragma unroll
      for (int r = 0; r < LPT; ++r) {
        x[r] = rd[r] ? (xt[r] << 16) | ((uint32_t)ring[w & (K10_RING - 1)] & 0xFFFFu) : xt[r];
        w += rd[r];
      }
      base += total;
    }
    // the step's tokens; then the next step's lookup, whose shared reads
    // overlap the refill and the stores
    int sym_out[LPT];
#pragma unroll
    for (int r = 0; r < LPT; ++r) sym_out[r] = sym[r];
    if (t + 1 < steps) lookup(t + 1);
    // every word below the last event's st was read before its barrier:
    // their slots take the words up to st + K10_RING, once the ring holds
    // less than half a ring beyond what the next step may read (st + 4S)
    if (fill < min(st + 4 * S + K10_RING / 2, stream_len)) {
      const int to = min(st + K10_RING, stream_len);
      cp_async_wait_all();  // the refill before this one
      landed = fill;
      ring_fill(ring, stream, fill, to);
      fill = to;
    }
#pragma unroll
    for (int r = 0; r < LPT; ++r) {
      const int k = t * S + i0 + r;
      if (i0 + r < S && k < n_tok) {
        sym_g[k] = sym_out[r];
        xtr_g[k] = (int)(v[r][1] | (v[r][2] << M_BITS));
      }
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int r = 0; r < LPT; ++r)
    if (i0 + r < S) states[i0 + r] = (long long)x[r];
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

// freq [581] (summing to M); states [S] int64, updated in place; stream
// [stream_len] int32 (u16 words, stream_len >= S), S <= 8192 lanes; grids
// [2, n_tok] scratch (sym, xtr); parts [tiles(n_tok) + 1, 2] scratch;
// plane [n_tok]; used [1].
extern "C" int cpx_k10_launch(int S, int n_tok, int stream_len, const void* freq,
                              void* states, const void* stream, void* grids,
                              void* parts, void* plane, void* used,
                              void* cuda_stream) {
  if (S < 1 || S > CPX_MAX_LPT * CPX_MAX_LANES || n_tok < 0 || stream_len < S)
    return (int)cudaErrorInvalidValue;
  // a step reads below base + 3S, the refill reaches the last event's
  // start + K10_RING, at most S past base: the ring holds 4S words
  if (4 * S > K10_RING) return (int)cudaErrorInvalidConfiguration;
  if ((uintptr_t)stream % 16) return (int)cudaErrorMisalignedAddress;  // 16-byte copies
  cudaStream_t st = (cudaStream_t)cuda_stream;
  int* const g = (int*)grids;
  const int tiles = (n_tok + SCAN_TILE - 1) / SCAN_TILE;
  const int lpt = lanes_per_thread(S);
  auto decode = lpt == 1 ? k10_decode<1> : lpt == 2 ? k10_decode<2>
              : lpt == 4 ? k10_decode<4> : k10_decode<8>;
  const cudaError_t err =
      cudaFuncSetAttribute(decode, cudaFuncAttributeMaxDynamicSharedMemorySize, K10_SMEM);
  if (err != cudaSuccess) return (int)err;
  decode<<<1, ((S + lpt - 1) / lpt + 31) / 32 * 32, K10_SMEM, st>>>(
      S, n_tok, stream_len, (const int*)freq, (const int*)stream,
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
