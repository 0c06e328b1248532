// K3: the backward rANS scan of encode.
//
// Replaces the rans_body scan of comprox_tpu/codec/block.py::_encode_passes
// (1945-1962): from the last step to the first, and within a step over the
// slots from the last to the first (C, B, A; mode X: E, D, C, B, A), every
// lane puts its (c, f) event (the identity event where inactive) and emits
// at most one u16 word.
//
// Bound on the H100: lanes are independent, so the whole scan is one
// dependent chain of n_slots * T puts per lane; it reads ev once and writes
// emit/words once (~17 bytes per slot, step and lane), ~0.13 ms of bytes
// for a crz block (T=16384, S=512), while the chain is six dependent
// operations a put (compare, select, multiply-high, multiply-add, compare,
// add).  No event depends on the state x: every (c, f, flag) of the scan
// is in ev before it starts.  So the design keeps the chain fed and short
// (4.0 ms for a crz block, 5.6 ms for crx, against 36.0 and 54.5 for one
// thread a lane that loaded each event when it put it):
//   - a lane's events of the next K3_RING_D steps are in flight at once,
//     through a ring in shared memory filled by cp.async (each thread
//     copies its own lane's 3 * n_slots words of a step, coalesced across
//     the warp, one commit group a step, empty past the first step): a
//     step's events are waited for, not fetched; c, f and the flag are
//     loaded unconditionally and selected after;
//   - the next step's events are read from the ring and prepared (the
//     identity event selected, the reciprocal below) while this step's
//     puts run: nothing but the state's own chain is left in a step;
//   - the quotient x / f comes from a reciprocal m = (2^32 - 1) / f,
//     computed from f alone (off the chain), as umulhi(x, m) and one exact
//     correction: with m = (2^32 - 1 - s) / f, 0 <= s < f, x * m / 2^32 =
//     x / f - x (1 + s) / (f 2^32) lies in (x/f - 1, x/f] for every x <
//     2^32, so the estimate is q or q - 1; and the put's new state
//     (q << 15) + c + (x - q f) is x + c + q (M - f), one multiply-add,
//     plus M - f where the estimate was one short; the emission test x >=
//     f 2^17 is one compare with a bound made from f;
//   - K3_LANES lanes a CTA (one warp), so a block of S=512 lanes runs on 16
//     SMs with one warp each.
// The writes stay coalesced across a warp's lanes.  Neither the ring's
// depth (8 to 32 steps) nor the lanes a CTA (32 to 128) moves the time,
// and a second warp that prepares the events for the coding warp gained
// 1.6-7%: what is left is the chain's own latency, ~50 ns a put.
//
// K3p, the emission mask's bit-pack (block.py:1965-1969), follows K3 on
// every adaptive encode: emit [T, n_slots, S] bytes (0 or 1) -> [T,
// n_slots, S/8] bytes, bit k of byte j the flag of lane 8j + k (the order
// np.unpackbits(..., bitorder="little") reads back, 2256-2260).  A thread
// packs one byte from one 8-byte load: the eight flags are bits 0, 8, ..,
// 56 of the word, and one multiply by 2^56 + 2^49 + .. + 2^7 gathers bit
// 8k into bit 56 + k, every partial product at a bit of its own (no
// carry).  Bound: bytes, 9/8 of the mask.
//
// K3b, the stream compaction, follows K3p on every adaptive encode: the
// compaction of block.py::_pack_payload (2256-2268), on the card, so that
// the host copies the word count, the states and the stream, not K3's
// words and mask.  The words whose flag is set, in (step, slot, lane)
// order (the decoder's read order), their low 16 bits: K3p's mask [rows,
// S/8] (rows = T * n_slots) and K3's words [rows, S] -> n_words and the
// stream [rows * S] int16 (the first n_words written).  Three launches, the
// tile scan of f2scan.cuh (K8's and K10's): k3b_count counts each tile of
// K3B_TILE rows (a warp a row at a time, a ballot of 32 lanes' flags and a
// popc); scan_parts_cta turns each block's tile counts into exclusive
// offsets and its total into n_words; k3b_scatter counts again, scans the
// warps' rows in the tile, and writes each flagged word at its row's
// offset + its rank in the row (the popc of the lower lanes' flags),
// reading only the words it writes.  Bound: bytes, the mask read once and
// the flagged words read and written once.
#include "ppm_r.cuh"
#include "f2scan.cuh"

#ifndef K3_LANES
#define K3_LANES 32  // lanes a CTA
#endif
#ifndef K3_RING_D
#define K3_RING_D 16  // steps of events in flight a lane
#endif
#if K3_RING_D & (K3_RING_D - 1)
#error "K3_RING_D must be a power of two"
#endif

#define K3B_WARPS 8
#define K3B_ROWS 8                          // rows a warp, one after another
#define K3B_TILE (K3B_WARPS * K3B_ROWS)     // rows a CTA

namespace {

// The ring of K3: [K3_RING_D][3 * n_slots][K3_LANES] ints.
constexpr size_t k3_ring_bytes(int n_slots) {
  return (size_t)K3_RING_D * 3 * n_slots * K3_LANES * sizeof(int);
}

// A step's events, ready for the chain: per slot the cumulative c, the
// frequency f (the identity event (0, M) where the flag is clear), the
// reciprocal m = (2^32 - 1) / f, the largest state that emits no word, lim
// = min(f 2^17 - 1, 2^32 - 1), and cmpl = M - f (mod 2^32).
template <int NS>
struct K3Step {
  uint32_t c[NS], f[NS], m[NS], lim[NS], cmpl[NS];
};

// The events of a step from its ring slot (this lane's column).
template <int NS>
static __device__ __forceinline__ K3Step<NS> k3_step(const int* slot) {
  K3Step<NS> s;
#pragma unroll
  for (int si = 0; si < NS; ++si) {
    const int* e = slot + 3 * si * K3_LANES;
    const bool act = e[2 * K3_LANES] != 0;
    const uint32_t f = act ? max((uint32_t)e[K3_LANES] & 0xFFFFu, 1u) : RANS_M;
    s.c[si] = act ? (uint32_t)e[0] & 0xFFFFu : 0u;
    s.f[si] = f;
    s.m[si] = 0xFFFFFFFFu / f;
    s.lim[si] = (uint32_t)min(((unsigned long long)f << (32 - M_BITS)) - 1ull,
                              0xFFFFFFFFull);
    s.cmpl[si] = RANS_M - f;
  }
  return s;
}

template <int NS>
__global__ void __launch_bounds__(K3_LANES) k3_kernel(int S, int T, const int* __restrict__ ev,
                                                      long long* __restrict__ states,
                                                      uint8_t* __restrict__ emit,
                                                      int* __restrict__ words) {
  constexpr int R = 3 * NS;  // event rows a step
  extern __shared__ int ring[];
  const int j = threadIdx.x, i = blockIdx.x * K3_LANES + j;
  if (i >= S) return;
  // block blockIdx.y of the launch: its events, states and outputs
  const long long cells = (long long)T * NS * S;
  ev = at_blk(ev, 3 * cells);
  states = at_blk(states, S);
  emit = at_blk(emit, cells);
  words = at_blk(words, cells);
  int* const mine = ring + j;
  auto slot = [&](int t) { return mine + (t & (K3_RING_D - 1)) * R * K3_LANES; };
  // step t's events of lane i into its slot; one commit group either way,
  // so that wait_group K3_RING_D - 1 means "the oldest landed"
  auto fetch = [&](int t) {
    if (t >= 0) {
      const int* src = ev + (size_t)t * R * S + i;
      int* dst = slot(t);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst + r * K3_LANES);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                     "l"(src + (size_t)r * S)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto landed = [] {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(K3_RING_D - 1) : "memory");
  };
#pragma unroll 1
  for (int k = 0; k < K3_RING_D; ++k) fetch(T - 1 - k);
  landed();
  K3Step<NS> cur = k3_step<NS>(slot(T - 1));
  // the slot's words are in registers: re-arm it K3_RING_D steps on
  fetch(T - 1 - K3_RING_D);
  uint32_t x = RANS_L;
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    // step t - 1's events (at t = 0 a slot read for nothing), prepared
    // while step t's puts run
    landed();
    const K3Step<NS> nxt = k3_step<NS>(slot(t - 1));
    fetch(t - 1 - K3_RING_D);
#pragma unroll
    for (int si = NS - 1; si >= 0; --si) {
      const size_t o = ((size_t)t * NS + si) * S + i;
      const bool em = x > cur.lim[si];
      emit[o] = em;
      words[o] = (int)(x & 0xFFFFu);
      const uint32_t xs = em ? x >> 16 : x;
      // x' = (q << M_BITS) + c + (xs - q f) = xs + c + q cmpl, q = xs / f:
      // q from the reciprocal is the quotient or one less
      const uint32_t q = __umulhi(xs, cur.m[si]);
      const uint32_t rem = xs - q * cur.f[si];
      x = xs + cur.c[si] + q * cur.cmpl[si];
      if (rem >= cur.f[si]) x += cur.cmpl[si];
    }
    cur = nxt;
  }
  states[i] = (long long)x;
}

__global__ void k3p_kernel(int n_out, const uint64_t* __restrict__ emit,
                           uint8_t* __restrict__ packed) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_out) return;
  const uint64_t flags = emit[j] & 0x0101010101010101ull;
  packed[j] = (uint8_t)((flags * 0x0102040810204080ull) >> 56);
}

// The flag of lane l of a row's packed mask.
static __device__ __forceinline__ bool k3b_flag(const uint8_t* __restrict__ row, int l) {
  return (row[l >> 3] >> (l & 7)) & 1;
}

// A warp's flagged words of its rows [r0, r1): their count (every lane).
static __device__ int k3b_warp_count(const uint8_t* __restrict__ mask, int S, int r0, int r1) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int r = r0; r < r1; ++r) {
    const uint8_t* row = mask + (size_t)r * (S >> 3);
    for (int l0 = 0; l0 < S; l0 += 32) {
      const int l = l0 + lane;
      n += __popc(__ballot_sync(full, l < S && k3b_flag(row, l)));
    }
  }
  return n;
}

// The rows of tile blockIdx.x of block blockIdx.y: [r0, r1) of this warp.
static __device__ __forceinline__ void k3b_rows(int rows, int& r0, int& r1) {
  const int warp = threadIdx.x >> 5;
  r0 = min(blockIdx.x * K3B_TILE + warp * K3B_ROWS, rows);
  r1 = min(r0 + K3B_ROWS, rows);
}

__global__ void __launch_bounds__(K3B_WARPS * 32) k3b_count(int S, int rows, int tiles,
                                                            const uint8_t* __restrict__ mask,
                                                            CountLast* __restrict__ parts) {
  __shared__ int wsum[K3B_WARPS];
  mask = at_blk(mask, (long long)rows * (S >> 3));
  parts = at_blk(parts, tiles + 1);
  int r0, r1;
  k3b_rows(rows, r0, r1);
  const int n = k3b_warp_count(mask, S, r0, r1);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < K3B_WARPS; ++w) s += wsum[w];
    parts[blockIdx.x] = CountLast{s, 0};
  }
}

// One CTA of 1024 threads a block: its tiles' exclusive offsets, and its
// word count.
__global__ void __launch_bounds__(1024) k3b_scan(int tiles, CountLast* __restrict__ parts,
                                                 int* __restrict__ n_words) {
  const CountLast total = scan_parts_cta(parts + (size_t)blockIdx.x * (tiles + 1), tiles);
  if (threadIdx.x == 0) n_words[blockIdx.x] = total.cnt;
}

__global__ void __launch_bounds__(K3B_WARPS * 32) k3b_scatter(
    int S, int rows, int tiles, const uint8_t* __restrict__ mask,
    const int* __restrict__ words, const CountLast* __restrict__ parts,
    int16_t* __restrict__ stream) {
  __shared__ int wsum[K3B_WARPS];
  const unsigned full = 0xffffffffu;
  const long long cells = (long long)rows * S;
  mask = at_blk(mask, cells >> 3);
  words = at_blk(words, cells);
  stream = at_blk(stream, cells);
  parts = at_blk(parts, tiles + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int r0, r1;
  k3b_rows(rows, r0, r1);
  const int n = k3b_warp_count(mask, S, r0, r1);
  if (lane == 0) wsum[warp] = n;
  __syncthreads();
  int base = parts[blockIdx.x].cnt;
  for (int w = 0; w < warp; ++w) base += wsum[w];
  const unsigned below = (1u << lane) - 1u;
  for (int r = r0; r < r1; ++r) {
    const uint8_t* row = mask + (size_t)r * (S >> 3);
    for (int l0 = 0; l0 < S; l0 += 32) {
      const int l = l0 + lane;
      const bool on = l < S && k3b_flag(row, l);
      const unsigned b = __ballot_sync(full, on);
      if (on) stream[base + __popc(b & below)] = (int16_t)words[(size_t)r * S + l];
      base += __popc(b);
    }
  }
}

template <int NS>
int k3_launch(int G, int S, int T, const void* ev, void* states, void* emit, void* words,
              cudaStream_t st) {
  const size_t smem = k3_ring_bytes(NS);
  cudaError_t err = cudaFuncSetAttribute(k3_kernel<NS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((S + K3_LANES - 1) / K3_LANES, G);
  k3_kernel<NS><<<blocks, K3_LANES, smem, st>>>(S, T, (const int*)ev, (long long*)states,
                                                (uint8_t*)emit, (int*)words);
  return (int)cudaGetLastError();
}

}  // namespace

// emit: n_out * 8 flag bytes (8-byte aligned) -> packed: n_out bytes (G
// blocks' masks at once: S is a multiple of 8, so the flat pack is each
// block's).
extern "C" int cpx_k3p_launch(int n_out, const void* emit, void* packed, void* stream) {
  if (n_out < 1 || ((uintptr_t)emit & 7)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  k3p_kernel<<<(n_out + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      n_out, (const uint64_t*)emit, (uint8_t*)packed);
  return (int)cudaGetLastError();
}

// ev [T, 3 * n_slots, S] -> states [S], emit and words [T, n_slots, S]
// (n_slots 3 or 5); G blocks (the block axis): each [G, ...], grid (S /
// K3_LANES, G).
extern "C" int cpx_k3_launch(int G, int S, int T, int n_slots, const void* ev,
                             void* states, void* emit, void* words,
                             void* stream) {
  if (G < 1 || G > 65535 || S < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_slots == 3) return k3_launch<3>(G, S, T, ev, states, emit, words, st);
  if (n_slots == 5) return k3_launch<5>(G, S, T, ev, states, emit, words, st);
  return (int)cudaErrorInvalidValue;
}

// mask [G, rows, S/8] u8 and words [G, rows, S] int32 -> n_words [G] int32
// and stream [G, rows * S] int16, each block's first n_words its stream;
// parts [G, tiles + 1] scratch (tiles = ceil(rows / K3B_TILE)).
extern "C" int cpx_k3b_launch(int G, int S, int rows, const void* mask, const void* words,
                              void* parts, void* n_words, void* stream_out,
                              void* stream) {
  if (G < 1 || G > 65535 || S < 8 || S % 8 || rows < 1 ||
      (long long)rows * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (rows + K3B_TILE - 1) / K3B_TILE;
  const dim3 grid(tiles, G);
  k3b_count<<<grid, K3B_WARPS * 32, 0, st>>>(S, rows, tiles, (const uint8_t*)mask,
                                             (CountLast*)parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3b_scan<<<G, 1024, 0, st>>>(tiles, (CountLast*)parts, (int*)n_words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3b_scatter<<<grid, K3B_WARPS * 32, 0, st>>>(S, rows, tiles, (const uint8_t*)mask,
                                               (const int*)words, (const CountLast*)parts,
                                               (int16_t*)stream_out);
  return (int)cudaGetLastError();
}

// The K3b scratch's tiles for `rows` rows (the wrapper sizes parts by it).
extern "C" int cpx_k3b_tiles(int rows) { return (rows + K3B_TILE - 1) / K3B_TILE; }
