// K4: the whole-block sort finder of the flexible-parse encode, with an
// entry for mode R (K4), one for mode X (K4x) and one for mode F (K7).
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
// Mode X's entry keys a position by a hash of its own next six bytes,
// walks the chain backward only (fwd_chain = 0) and counts every position
// as inserted (rolz_dec = 1); a chain no longer than n_cands is taken
// whole, in chain order.  Its sources are written at every position,
// usable or not: the price DP passes them through.
// Mode F's entry (K7) replaces comprox_tpu/codec/fast.py::_f2_find
// (178-246): mode X's keys and stages with the n_cands nearest earlier
// ranks of the key as the chain, every earlier position usable (ANY: the
// host-run LZ copies need no more causality than that), the cap the
// window, and the diagonal runs with or without the byte where a run ends
// (CPX_F_DIAG_TAIL; TAIL).
//
// Bound on the H100: bytes.  The function reads N bytes and writes
// 2 * n_cands int32 per position; the work between is the sort (four
// passes, each reading and writing 8 bytes per position), the probes and
// the winners' extensions.  The block itself (8 MiB at the main path's
// geometry) stays in the 50 MB L2.  Kernels, in launch order:
//   k4_keys     one thread per position: the key;
//   the stable LSD radix sort of (key, position) of sortlib.cuh
//               (rs_hist, rs_plan, rs_pass, rs_finish), shared with the
//               mode-F finder; its entry point cpx_radix_sort_launch is
//               here;
//   k4_find     a CTA per K4_TILE consecutive sort ranks, a thread a rank.
//               Neighbouring ranks share all but one of their chain
//               entries, so the CTA stages, once, the ranks of its tile
//               and its halo (chain_b before, fwd_chain after) in shared
//               memory: each one's key, position, the 8 bytes at that
//               position (the one gather a staged rank) and the step from
//               which it is usable (its step in the lane where the bucket
//               insert takes it, else T).  A thread probes its chain from
//               shared memory alone and keeps an n_cands-deep list of
//               scores (n_cands a template argument).  It writes its
//               position's n_cands (cand, len | flags) pairs as one record
//               of 32 bytes (64 above four pairs), so the scattered write
//               is whole sectors; a winner whose 8-byte probe matched
//               whole is marked K4_EXT, its length still 8;
//   k4_heads    a thread a position, the records in order: a marked
//               winner at i with cand is, d steps up (d the insert
//               decimation, so that the pair is usable there too), the
//               match at i + d with cand + d, d bytes shorter; where that
//               pair is a usable winner at i + d in the final stage's
//               chunk of i, the final stage takes the length from it.  The
//               others, the heads (about a quarter of K4's marked
//               winners and an eighth of K4x's on the 8 MiB goldens), are
//               listed in shared memory and
//               extended from byte 8 by the CTA's first threads, one
//               position a thread, its winners together (the own bytes
//               read once a step);
//   k4_final    a thread a lane and a chunk of steps, from the chunk's top
//               step down: reads the lane's records one after another and
//               writes the [2 * n_cands, T, S] grids (len, src per
//               candidate), a row of 32 lanes a warp store.  A marked
//               winner left takes min(d + its link's length, ext8), the
//               link d steps up being done.  Where the word extension
//               reaches the length cap (sort_ext >= min(window, min_len +
//               255), decided on the host: the default) the diagonal-run
//               recovery cannot lengthen a match (a run along a diagonal
//               is at most the match the extension measured, and the
//               extension measured up to the cap), so the length is the
//               extension's, capped.  Below that the run is a backward
//               recurrence along the row, run(t) = 1 + run(t + 1) while
//               the first byte matches and the candidate continues the
//               diagonal; a run never needs to reach more than the cap
//               ahead, so a chunk's recurrence starts len_cap steps above
//               it, and chunks run in parallel.
#include "sortlib.cuh"

namespace {

#define K4_INSERT_LATE 3  // block.py::_INSERT_LATE
#define K4_TILE 256       // sort ranks a find CTA (block.py::K4_FIND_TILE)
// shared memory a staged rank takes: the prefix, the key, the position
// and the step it is usable from (block.py::K4_STAGE_BYTES)
#define K4_STAGE_BYTES 20
#define K4_SMEM_MAX (48 * 1024)  // a CTA's dynamic shared memory (block.py)
#define K4_EXT (1 << 18)         // lw flag: the probe matched 8 bytes; extend
#define K4_FINAL_THREADS 128     // lanes a final CTA: a thread each
#define K4_CHUNK 64              // steps a final thread with no walk
#define K4_WALK_CHUNK 512        // steps a final thread of the scan arm

// (cand, len | flags) pairs of a position's record: block.py::k4_record_ints
template <int NC>
struct Rec {
  static constexpr int PAIRS = NC <= 4 ? 4 : 8;
  static constexpr int VECS = PAIRS / 2;  // int4 a record
};

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

// The block's bytes from byte offset p on, 8 at a time: one aligned word
// a step, the word before kept.
struct Bytes8 {
  const uint64_t* w;
  int sh;
  uint64_t lo;
  __device__ __forceinline__ void start(const uint64_t* b, long long p) {
    w = b + (p >> 3);
    sh = (int)(p & 7) * 8;
    lo = *w;
  }
  __device__ __forceinline__ uint64_t next() {
    const uint64_t hi = *++w;
    const uint64_t v = sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
    lo = hi;
    return v;
  }
};

// The winners in `todo` (their first 8 bytes match) extended from byte 8
// to at most ext8, 8 bytes a step, all of them together: the own bytes of
// a step read once for all.
template <int NC>
__device__ __forceinline__ void extend(const uint64_t* bytes, int i, const int (&cand)[NC],
                                       int (&lw)[NC], unsigned todo, int ext8) {
  Bytes8 mine, src[NC];
  mine.start(bytes, (long long)i + 8);
#pragma unroll
  for (int u = 0; u < NC; ++u)
    if (todo >> u & 1) src[u].start(bytes, (long long)cand[u] + 8);
  for (int len = 8; todo && len < ext8; len += 8) {
    const uint64_t o = mine.next();
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      if (!(todo >> u & 1)) continue;
      const uint64_t x = src[u].next() ^ o;
      if (x) {
        lw[u] = (lw[u] & ~(0xFFFF | K4_EXT)) | min(len + eq_bytes(x), ext8);
        todo &= ~(1u << u);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < NC; ++u)
    if (todo >> u & 1) lw[u] = (lw[u] & ~(0xFFFF | K4_EXT)) | ext8;
}

template <int NC>
__device__ __forceinline__ void rec_load(const int4* at, int (&v)[2 * Rec<NC>::PAIRS]) {
#pragma unroll
  for (int j = 0; j < Rec<NC>::VECS; ++j) {
    const int4 w = at[j];
    v[4 * j] = w.x;
    v[4 * j + 1] = w.y;
    v[4 * j + 2] = w.z;
    v[4 * j + 3] = w.w;
  }
}

// Whether a marked winner at step t takes its length from the pair d
// steps up in the final stage: that step is in t's chunk (done before t).
__device__ __forceinline__ bool from_above(int t, int T, int d, int chunk) {
  return d > 0 && t + d < min((t / chunk + 1) * chunk, T);
}

// The pair (i + d, cand + d) in record r, where it is a usable winner: its
// lw, else 0.
template <int NC>
__device__ __forceinline__ int pair_up(const int (&r)[2 * Rec<NC>::PAIRS], int cand_d) {
  int lw = 0;
#pragma unroll
  for (int w = 0; w < NC; ++w)
    if (r[2 * w] == cand_d && (r[2 * w + 1] & FIND_OK)) lw = r[2 * w + 1];
  return lw;
}

// The chain entry e of the thread whose own rank is staged at s0.
__device__ __forceinline__ int chain_slot(int s0, int e, int chain_b) {
  return e < chain_b ? s0 - 1 - e : s0 + 1 + e - chain_b;
}

template <int NC, bool ANY>
__global__ void __launch_bounds__(K4_TILE) k4_find(
    Cfg c, const uint64_t* __restrict__ bytes, const uint32_t* __restrict__ hs,
    const int* __restrict__ ps, int4* __restrict__ rec) {
  extern __shared__ __align__(16) unsigned char k4_smem[];
  const int big = c.S * c.T;
  const int chain_b = max(c.r_probe, NC), chain = chain_b + c.fwd_chain;
  const int W = K4_TILE + chain;
  uint64_t* const s_pre = reinterpret_cast<uint64_t*>(k4_smem);
  uint32_t* const s_key = reinterpret_cast<uint32_t*>(s_pre + W);
  int* const s_pos = reinterpret_cast<int*>(s_key + W);
  int* const s_from = s_pos + W;  // usable at steps above this
  const int r0 = blockIdx.x * K4_TILE;
  for (int s = threadIdx.x; s < W; s += K4_TILE) {
    const int q = r0 - chain_b + s;
    int pos = -1, from = c.T;
    uint32_t key = 0;
    uint64_t pre = 0;
    if (q >= 0 && q < big) {
      pos = ps[q];
      key = hs[q];
      pre = load_u64(bytes, pos);
      if (ANY) from = -1;
      else if (c.rolz_dec <= 1 || (pos + K4_INSERT_LATE) % c.rolz_dec == 0) from = pos % c.T;
    }
    s_pre[s] = pre;
    s_key[s] = key;
    s_pos[s] = pos;
    s_from[s] = from;
  }
  __syncthreads();
  const bool alive = r0 + (int)threadIdx.x < big;
  const int s0 = threadIdx.x + chain_b;
  const uint32_t key = s_key[s0];
  const int i = s_pos[s0];
  const uint64_t own = s_pre[s0];
  // ANY (mode F): every earlier position counts, at every position of the block
  const int t_of = ANY ? (i < c.n ? 0 : -1) : i % c.T;
  // score = plen * chain + (chain - 1 - e), plen -1 where the entry is not
  // usable: distinct through e, so the list holds scores alone, descending
  const bool select = chain > NC;  // else the chain is taken whole, in order
  int top[NC];
  if (select) {
#pragma unroll
    for (int u = 0; u < NC; ++u) top[u] = INT_MIN;
    for (int e = 0; e < chain; ++e) {
      const int q = chain_slot(s0, e, chain_b);
      const bool ok = s_pos[q] >= 0 && s_key[q] == key && s_from[q] < t_of;
      int v = (ok ? eq_bytes(s_pre[q] ^ own) : -1) * chain + (chain - 1 - e);
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        const int hi = max(top[u], v);
        v = min(top[u], v);
        top[u] = hi;
      }
    }
  }
  if (!alive) return;
  const int ext8 = (c.sort_ext + 3) / 4 * 4;  // bytes the word extension compares
  int cand[NC], lw[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    const int e = select ? chain - 1 - (top[u] + chain) % chain : u;
    const int q = chain_slot(s0, e, chain_b);
    const bool match = s_pos[q] >= 0 && s_key[q] == key;
    cand[u] = match ? s_pos[q] : -1;
    lw[u] = 0;
    if (match && s_from[q] < t_of) {
      const uint64_t x = s_pre[q] ^ own;
      const int len = eq_bytes(x);
      lw[u] = min(len, ext8) | FIND_OK | ((x & 0xFF) == 0 ? FIND_EQ1 : 0) |
              (len == 8 && ext8 > 8 ? K4_EXT : 0);
    }
  }
  int v[2 * Rec<NC>::PAIRS];
#pragma unroll
  for (int u = 0; u < Rec<NC>::PAIRS; ++u) {
    v[2 * u] = u < NC ? cand[u] : 0;
    v[2 * u + 1] = u < NC ? lw[u] : 0;
  }
  int4* const dst = rec + (size_t)i * Rec<NC>::VECS;
#pragma unroll
  for (int j = 0; j < Rec<NC>::VECS; ++j)
    dst[j] = make_int4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}

// The marked winners that the final stage cannot take from the pair d
// steps up (no such usable winner there, or that step in another chunk),
// extended from byte 8.  A CTA a tile of positions: a thread a position
// finds its heads, the CTA lists its positions with heads in shared
// memory, and its first threads extend them, one position each.
template <int NC>
__global__ void __launch_bounds__(K4_TILE) k4_heads(int S, int T, int ext8, int d, int chunk,
                                                    const uint64_t* __restrict__ bytes,
                                                    int4* __restrict__ rec) {
  __shared__ int warp_n[K4_TILE / 32];
  __shared__ int2 list[K4_TILE];  // (position, slots)
  const long long i = (long long)blockIdx.x * K4_TILE + threadIdx.x;
  unsigned heads = 0;
  if (i < (long long)S * T) {
    int v[2 * Rec<NC>::PAIRS], up[2 * Rec<NC>::PAIRS];
    rec_load<NC>(rec + i * Rec<NC>::VECS, v);
#pragma unroll
    for (int u = 0; u < NC; ++u)
      if (v[2 * u + 1] & K4_EXT) heads |= 1u << u;
    if (heads && from_above((int)(i % T), T, d, chunk)) {
      rec_load<NC>(rec + (i + d) * Rec<NC>::VECS, up);
#pragma unroll
      for (int u = 0; u < NC; ++u)
        if (pair_up<NC>(up, v[2 * u] + d)) heads &= ~(1u << u);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(0xffffffffu, heads != 0);
  if (lane == 0) warp_n[warp] = __popc(b);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < K4_TILE / 32; ++w) {
    before += w < warp ? warp_n[w] : 0;
    total += warp_n[w];
  }
  if (heads) list[before + __popc(b & ((1u << lane) - 1))] = make_int2((int)i, (int)heads);
  __syncthreads();
  if ((int)threadIdx.x >= total) return;
  const int2 q = list[threadIdx.x];
  int4* const at = rec + (size_t)q.x * Rec<NC>::VECS;
  int v[2 * Rec<NC>::PAIRS];
  rec_load<NC>(at, v);
  int cand[NC], lw[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    cand[u] = v[2 * u];
    lw[u] = v[2 * u + 1];
  }
  extend(bytes, q.x, cand, lw, (unsigned)q.y, ext8);
#pragma unroll
  for (int u = 0; u < NC; ++u)
    if ((unsigned)q.y >> u & 1) reinterpret_cast<int*>(at)[2 * u + 1] = lw[u];
}

// The records in position order -> out [2 * NC, T, S].  A thread a lane
// and a chunk of steps, from the chunk's top step down (a warp: 32 lanes,
// each out store a row of 32 lanes).  A winner still marked takes
// min(d + the length of the pair (i + d, cand + d), ext8): its first d
// bytes match, and that pair, a usable winner d steps up in the chunk
// (k4_heads left the mark only there), is done.  WALK: the diagonal run
// of each slot, run(t) = eq1(t) and cand(t + 1) == cand(t) + 1 ? 1 +
// run(t + 1) : eq1(t), from `top`, len_cap steps above the chunk (the
// steps there are read, not written); without TAIL (mode F's
// CPX_F_DIAG_TAIL=0) the byte where the diagonal ends is not counted:
// run(t) = eq1(t) and cand(t + 1) == cand(t) + 1 ? 1 + run(t + 1) : 0.
template <int NC, bool WALK, bool TAIL = true>
__global__ void __launch_bounds__(K4_FINAL_THREADS) k4_final(
    int S, int T, int n, int len_cap, int ext8, int d, int chunk,
    const int4* __restrict__ rec, int* __restrict__ out) {
  const int lane = blockIdx.x * K4_FINAL_THREADS + threadIdx.x;
  if (lane >= S) return;
  const int c0 = blockIdx.y * chunk, c1 = min(c0 + chunk, T);
  const int top = WALK ? min(c1 + len_cap, T) : c1;
  const int4* const row = rec + (size_t)lane * T * Rec<NC>::VECS;
  // the records one and two steps up (d <= 2), lengths done; WALK: runs
  int up1[2 * Rec<NC>::PAIRS], up2[2 * Rec<NC>::PAIRS], run[NC];
#pragma unroll
  for (int k = 0; k < 2 * Rec<NC>::PAIRS; ++k) up1[k] = up2[k] = k & 1 ? 0 : INT_MIN;
#pragma unroll
  for (int u = 0; u < NC; ++u) run[u] = 0;
  if (WALK && !TAIL && top == T && lane + 1 < S) {
    // without the tail the lane's last step needs its diagonal into the
    // next lane's first step (JAX's runs are over the flat block); a run
    // that goes on there is longer than any cap in this lane
    rec_load<NC>(row + (size_t)T * Rec<NC>::VECS, up1);
#pragma unroll
    for (int k = 1; k < 2 * Rec<NC>::PAIRS; k += 2) up1[k] = 0;
  }
  int v[2 * Rec<NC>::PAIRS];
  rec_load<NC>(row + (size_t)(top - 1) * Rec<NC>::VECS, v);
  for (int t = top - 1; t >= c0; --t) {
    int nxt[2 * Rec<NC>::PAIRS];
    if (t > c0) rec_load<NC>(row + (size_t)(t - 1) * Rec<NC>::VECS, nxt);
    const int i = lane * T + t;
    const int cap = max(min(min(T - t, n - i), len_cap), 0);
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      const int cand = v[2 * u];
      int lw = v[2 * u + 1];
      if (t < c1 && (lw & K4_EXT)) {  // k4_heads left the mark: the link is there
        const int above = d == 1 ? pair_up<NC>(up1, cand + d) : pair_up<NC>(up2, cand + d);
        lw = (lw & ~(0xFFFF | K4_EXT)) | min(d + (above & 0xFFFF), ext8);
        v[2 * u + 1] = lw;
      }
      int len = lw & 0xFFFF;
      if (WALK) {
        const bool eq1 = lw & FIND_EQ1;
        const bool diag = up1[2 * u] == cand + 1;
        run[u] = eq1 ? (diag ? run[u] + 1 : TAIL) : 0;
        len = max(len, run[u]);
      }
      if (t < c1) {
        out[((size_t)(2 * u) * T + t) * S + lane] = (lw & FIND_OK) ? min(len, cap) : 0;
        out[((size_t)(2 * u + 1) * T + t) * S + lane] = cand;
      }
    }
#pragma unroll
    for (int k = 0; k < 2 * Rec<NC>::PAIRS; ++k) {
      up2[k] = up1[k];
      up1[k] = v[k];
      v[k] = nxt[k];
    }
  }
}

// What the entries set apart: the length cap, the diagonal step d of the
// links (0: none), whether a diagonal run counts the byte where it ends.
struct Arm {
  int len_cap, d;
  bool tail;
};

template <int NC, bool ANY>
int find_launch(const Cfg& c, const Arm& a, const uint64_t* bytes, const uint32_t* hs,
                const int* ps, int4* rec, int* out, cudaStream_t st) {
  const int big = c.S * c.T;
  const int chain = max(c.r_probe, NC) + c.fwd_chain;
  const size_t smem = (size_t)(K4_TILE + chain) * K4_STAGE_BYTES;
  if (smem > K4_SMEM_MAX) return (int)cudaErrorInvalidValue;
  k4_find<NC, ANY><<<(big + K4_TILE - 1) / K4_TILE, K4_TILE, smem, st>>>(c, bytes, hs, ps, rec);
  const bool walk = c.sort_ext < a.len_cap;
  const int chunk = walk ? K4_WALK_CHUNK : K4_CHUNK;
  const int ext8 = (c.sort_ext + 3) / 4 * 4;
  if (ext8 > 8)  // else no winner is marked
    k4_heads<NC><<<(big + K4_TILE - 1) / K4_TILE, K4_TILE, 0, st>>>(c.S, c.T, ext8, a.d, chunk,
                                                                     bytes, rec);
  const dim3 grid((c.S + K4_FINAL_THREADS - 1) / K4_FINAL_THREADS, (c.T + chunk - 1) / chunk);
  auto kern = !walk ? &k4_final<NC, false> : a.tail ? &k4_final<NC, true, true>
                                                    : &k4_final<NC, true, false>;
  kern<<<grid, K4_FINAL_THREADS, 0, st>>>(c.S, c.T, c.n, a.len_cap, ext8, a.d, chunk, rec, out);
  return (int)cudaGetLastError();
}

template <bool ANY>
int find_arms(const Cfg& c, const Arm& a, const void* bytes, const void* hs, const void* ps,
              void* rec, void* out, void* stream) {
  const uint64_t* b = (const uint64_t*)bytes;
  const uint32_t* h = (const uint32_t*)hs;
  const int* p = (const int*)ps;
  int4* r = (int4*)rec;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (c.n_cands) {
    case 1: return find_launch<1, ANY>(c, a, b, h, p, r, o, st);
    case 2: return find_launch<2, ANY>(c, a, b, h, p, r, o, st);
    case 3: return find_launch<3, ANY>(c, a, b, h, p, r, o, st);
    case 4: return find_launch<4, ANY>(c, a, b, h, p, r, o, st);
    case 5: return find_launch<5, ANY>(c, a, b, h, p, r, o, st);
    case 6: return find_launch<6, ANY>(c, a, b, h, p, r, o, st);
    case 7: return find_launch<7, ANY>(c, a, b, h, p, r, o, st);
    default: return (int)cudaErrorInvalidValue;
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

// Mode F (K7): the same key as mode X's.
extern "C" int cpx_k7_keys_launch(const int* cfg, const void* bytes, void* key,
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

// The find, the heads' extension and the final stage: hs, ps the sorted
// keys and positions; rec [N, 8] int32 (n_cands above 4: [N, 16]), the
// records; out [2 * n_cands, T, S].  Refuses a staged window above
// K4_SMEM_MAX (block.py raises first, naming the knob).
extern "C" int cpx_k4_find_launch(const int* cfg, const void* bytes,
                                  const void* hs, const void* ps, void* rec,
                                  void* out, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  // the pair d steps up on a diagonal is usable there too where the bucket
  // insert takes every d-th position
  const Arm a{min(c.window, c.min_len + LEN_W - 1), c.rolz_dec <= 2 ? max(c.rolz_dec, 1) : 0,
              true};
  return find_arms<false>(c, a, bytes, hs, ps, rec, out, stream);
}

// Mode X: the same stages under its configuration (r_probe = the backward
// chain, fwd_chain = 0, rolz_dec = 1).
extern "C" int cpx_k4x_find_launch(const int* cfg, const void* bytes,
                                   const void* hs, const void* ps, void* rec,
                                   void* out, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.fwd_chain != 0 || c.rolz_dec != 1) return (int)cudaErrorInvalidValue;
  return cpx_k4_find_launch(cfg, bytes, hs, ps, rec, out, stream);
}

// K7, mode F's finder (cfg: fast.py::_cfg): K4x's keys (cpx_k7_keys_launch)
// and stages with the n_cands nearest earlier ranks of the key as the
// chain, taken whole, every one usable (ANY); the cap min(T - t, n - i,
// window); links one step up (every position is inserted); a diagonal run
// counts its last byte where diag_tail is set; sort_ext = 4 * (EXTW - 1).
extern "C" int cpx_k7_find_launch(const int* cfg, const void* bytes,
                                  const void* hs, const void* ps, void* rec,
                                  void* out, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  if (c.sort_ext >= FIND_EQ1) return (int)cudaErrorInvalidValue;
  c.r_probe = 0;
  c.fwd_chain = 0;
  const Arm a{c.window, 1, c.diag_tail != 0};
  return find_arms<true>(c, a, bytes, hs, ps, rec, out, stream);
}
