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
// stream [rows * S] int16 (the first n_words written).  S is a multiple of
// 8, so a block's mask is one flat bit string in stream order (bit r S + l
// is row r, lane l, the flag of words_flat[r S + l]) and the compaction
// is a flat one: tiles need not follow rows.  One pass over the mask:
// k3b_clear zeroes the look-back words and the tickets, then k3b_pass, a
// CTA a tile of K3B_THREADS x 128 flags (each thread one 16-byte load of
// the mask; block b's segment starts at b rows S / 8 bytes, which need
// not be 16-byte aligned, so a piece it covers only in part, its head or
// tail, is read a byte at a time, zeros outside it), takes a ticket (its
// tile, in the order CTAs start, so that none waits on a tile whose CTA
// has not started), counts its flags by popc and a CTA scan, takes the
// tile's offset from a decoupled look-back over the earlier tiles' words
// (a word carries its flag and its value together, as K8's; one warp
// reads 32 K3B_LOOK of them a round), and writes its flagged words,
// reading only those: each thread its own where a warp's threads hold
// few, else a warp a mask word at a time, coalesced; K3B_BATCH loads in
// flight.  The block's last tile writes n_words.  Bound: bytes, the mask
// read once and the flagged words read and written once.
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

#define K3B_THREADS 256  // a tile: a thread a 16-byte piece of the mask (128 flags)
#define K3B_AGG 1ull      // a look-back word's flags: the tile's count,
#define K3B_INCL 2ull     // or its inclusive prefix
#define K3B_BATCH 8       // flagged words (or mask words) a thread has in flight at once
#define K3B_LOOK 4        // look-back words a thread reads a round

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

// look: a block's [tiles] look-back words, (flag << 32) | value, then its
// ticket counter; zeroed by k3b_clear.
__global__ void k3b_clear(unsigned long long* __restrict__ look, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) look[i] = 0ull;
}

static __device__ __forceinline__ unsigned long long k3b_load(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

static __device__ __forceinline__ void k3b_store(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// The flagged words before tile `tile` (> 0) of this block, by one warp:
// lane i reads the words of the tiles j - (K3B_LOOK i + r), r < K3B_LOOK,
// all in flight, then waits for each to be published; the nearest
// inclusive prefix ends the walk (the tiles up to it summed), else all
// 32 K3B_LOOK counts are summed and the walk goes on as many tiles down.
// One warp polls (a CTA of pollers slowed the walk on the card: more
// traffic on the same few lines), a few words a lane so that a walk
// takes few rounds while a wave's tiles publish their counts at once.
static __device__ int k3b_look_back(const unsigned long long* __restrict__ look, int tile) {
  const unsigned full = 0xffffffffu;
  constexpr int window = K3B_LOOK * 32;
  const int d0 = K3B_LOOK * (threadIdx.x & 31);  // this lane's first distance
  int excl = 0;
  for (int j = tile - 1;; j -= window) {
    unsigned long long v[K3B_LOOK];
#pragma unroll
    for (int r = 0; r < K3B_LOOK; ++r)  // before tile 0: a prefix of 0
      v[r] = j - d0 - r >= 0 ? k3b_load(look + j - d0 - r) : K3B_INCL << 32;
#pragma unroll
    for (int r = 0; r < K3B_LOOK; ++r)
      while ((v[r] >> 32) == 0ull) v[r] = k3b_load(look + j - d0 - r);
    int near = window;  // the least distance of an inclusive prefix
#pragma unroll
    for (int r = K3B_LOOK - 1; r >= 0; --r)
      if ((v[r] >> 32) == K3B_INCL) near = d0 + r;
    const int last = (int)__reduce_min_sync(full, (unsigned)near);
    int val = 0;
#pragma unroll
    for (int r = 0; r < K3B_LOOK; ++r)
      if (d0 + r <= last) val += (int)(uint32_t)v[r];
    excl += (int)__reduce_add_sync(full, (unsigned)val);
    if (last < window) return excl;
  }
}

__global__ void __launch_bounds__(K3B_THREADS) k3b_pass(
    int S, int rows, int tiles, const uint8_t* __restrict__ mask,
    const int* __restrict__ words, unsigned long long* __restrict__ look,
    int* __restrict__ n_words, int16_t* __restrict__ stream) {
  __shared__ CountLast wsum[32];
  __shared__ int s_ticket, s_excl;
  const long long cells = (long long)rows * S, nb = cells >> 3;
  mask = at_blk(mask, nb);
  words = at_blk(words, cells);
  stream = at_blk(stream, cells);
  look = at_blk(look, (long long)tiles + 1);
  if (threadIdx.x == 0)
    s_ticket = (int)atomicAdd(reinterpret_cast<unsigned*>(look + tiles), 1u);
  __syncthreads();
  const int tile = s_ticket;
  // this thread's 16-byte piece: piece c of those that cover the block's
  // segment [s0, s1), counted from the 16-byte boundary at or below s0
  const long long s0 = (long long)(uintptr_t)mask, s1 = s0 + nb;
  const long long at = (s0 & ~15ll) + 16ll * ((long long)tile * K3B_THREADS + threadIdx.x);
  uint32_t f[4] = {0u, 0u, 0u, 0u};
  if (at >= s0 && at + 16 <= s1) {
    const uint4 v = *reinterpret_cast<const uint4*>((uintptr_t)at);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else if (at < s1 && at + 16 > s0) {  // the segment's unaligned head or tail
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (at + b >= s0 && at + b < s1)
        f[b >> 2] |= (uint32_t)*reinterpret_cast<const uint8_t*>((uintptr_t)(at + b))
                     << (8 * (b & 3));
  }
  CountLast total;
  const int ex = cta_excl_scan(
      CountLast{__popc(f[0]) + __popc(f[1]) + __popc(f[2]) + __popc(f[3]), 0}, wsum,
      total).cnt;
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      k3b_store(look + tile, ((tile == 0 ? K3B_INCL : K3B_AGG) << 32) | (uint32_t)total.cnt);
    const int excl = tile == 0 ? 0 : k3b_look_back(look, tile);
    if (threadIdx.x == 0) {
      if (tile > 0) k3b_store(look + tile, (K3B_INCL << 32) | (uint32_t)(excl + total.cnt));
      if (tile == tiles - 1) n_words[blockIdx.y] = excl + total.cnt;
      s_excl = excl;
    }
  }
  __syncthreads();
  const int excl = s_excl;
  // The flagged words.  A warp whose threads hold at most K3B_BATCH each
  // has each thread write its own, its loads all in flight before the
  // first store: flag i of the piece (bit i of lo, i - 64 of hi) is the
  // flag of words_flat[bit0 + i].  A denser warp takes its nonzero mask
  // words K3B_BATCH at a time, a word's 32 flags across the lanes (word w
  // of lane src covers words_flat[bit0 + 128 (src - lane) + 32 w + i]), so
  // that each load and store is coalesced.
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int o = excl + ex;
  const long long bit0 = (at - s0) * 8;
  const int cnt = __popc(f[0]) + __popc(f[1]) + __popc(f[2]) + __popc(f[3]);
  if (__reduce_max_sync(full, (unsigned)cnt) <= K3B_BATCH) {
    unsigned long long lo = f[0] | (unsigned long long)f[1] << 32,
                       hi = f[2] | (unsigned long long)f[3] << 32;
    int pos[K3B_BATCH], v[K3B_BATCH];
#pragma unroll
    for (int u = 0; u < K3B_BATCH; ++u) {
      pos[u] = lo ? __ffsll(lo) - 1 : hi ? 63 + __ffsll(hi) : -1;
      if (lo) lo &= lo - 1;
      else hi &= hi - 1;
    }
#pragma unroll
    for (int u = 0; u < K3B_BATCH; ++u)
      if (pos[u] >= 0) v[u] = words[bit0 + pos[u]];
#pragma unroll
    for (int u = 0; u < K3B_BATCH; ++u)
      if (pos[u] >= 0) stream[o + u] = (int16_t)v[u];
    return;
  }
  const unsigned below = (1u << lane) - 1u;
  int ob = o;  // the first place of word w's words
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    for (unsigned nz = __ballot_sync(full, f[w] != 0u); nz;) {
      uint32_t wd[K3B_BATCH];
      int at_[K3B_BATCH], v[K3B_BATCH];
#pragma unroll
      for (int u = 0; u < K3B_BATCH; ++u) {
        const int src = nz ? __ffs(nz) - 1 : lane;
        wd[u] = __shfl_sync(full, nz ? f[w] : 0u, src);
        at_[u] = __shfl_sync(full, ob, src);
        if (wd[u] >> lane & 1u) v[u] = words[bit0 + 128ll * (src - lane) + 32 * w + lane];
        nz &= nz - 1u;
      }
#pragma unroll
      for (int u = 0; u < K3B_BATCH; ++u)
        if (wd[u] >> lane & 1u) stream[at_[u] + __popc(wd[u] & below)] = (int16_t)v[u];
    }
    ob += __popc(f[w]);
  }
}

// The tiles of a block of `rows` rows of S lanes: its mask's 16-byte
// pieces, wherever the segment starts, K3B_THREADS a tile.
static long long k3b_tile_count(int S, int rows) {
  const long long pieces = (long long)rows * S / 8 / 16 + 2;
  return (pieces + K3B_THREADS - 1) / K3B_THREADS;
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
// parts [G, tiles + 1] 8-byte scratch (tiles = cpx_k3b_tiles(S, rows)),
// zeroed here.
extern "C" int cpx_k3b_launch(int G, int S, int rows, const void* mask, const void* words,
                              void* parts, void* n_words, void* stream_out,
                              void* stream) {
  if (G < 1 || G > 65535 || S < 8 || S % 8 || rows < 1 ||
      (long long)rows * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (int)k3b_tile_count(S, rows);
  const long long look = (long long)G * (tiles + 1);
  k3b_clear<<<(unsigned)((look + 255) / 256), 256, 0, st>>>((unsigned long long*)parts, look);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3b_pass<<<dim3(tiles, G), K3B_THREADS, 0, st>>>(
      S, rows, tiles, (const uint8_t*)mask, (const int*)words, (unsigned long long*)parts,
      (int*)n_words, (int16_t*)stream_out);
  return (int)cudaGetLastError();
}

// The K3b scratch's tiles for `rows` rows of S lanes (the wrapper sizes
// parts by it).
extern "C" int cpx_k3b_tiles(int S, int rows) { return (int)k3b_tile_count(S, rows); }
