// K13c: mode P's LZP candidates of a whole block at once, for crp's encode.
//
// Replaces, for the encoder, the per-step candidate of
// comprox_tpu/codec/block.py::_encode_model_body's P arm (1714-1723):
// _lzp_candidate (362-403), _match_window_len (1059-1068) and the three
// scatter-max inserts of _post_step (662-676).  In encode those depend on
// the input alone: an insert's guards and keys are fixed by its position
// and the bytes before it, and a scatter-max does not depend on order, so
// what a table holds when step t reads it is the largest value inserted
// under that key at a step < t (and the table's initial value).  The
// modeling scan (K13e, model.cu) then reads one int32 a lane and step from
// the grid this pass writes, and neither reads nor inserts into a table.
// The decoder, which has not got the bytes yet, keeps its step-by-step
// candidate (K13d, decode.cu).
//
// The insert of step s of lane i maps the lane's registers after byte s,
// which are step t = s + 1's registers, to position i*T + t (stored + 1).
// So every reader (t, i) that can find a candidate in a table has an
// insert of its own at t - 1 under the same key: one element (t, i) a
// table holds both.  Elements in step-major order, lanes descending inside
// a step (e = t*S + S-1-i), sorted stably by key, give each key's elements
// in (step, lane descending) order; within one step the values grow with
// the lane, so a step's first element there is its largest, and the
// inclusive prefix max at any element of step t is the largest value of
// the steps <= t: the table as the reader at t sees it, its own insert of
// step t - 1 included (the candidate check src % T < t then rejects every
// value of step t - 1, as the step walk does).  An element with no insert
// (t below the table's first step, or past the block) has the value 0,
// which no max sees, and a reader the checks ignore.  Kernels, in launch
// order:
//   k13c_keys     a CTA a tile of 32 lanes x 32 steps, a warp a lane and a
//                 thread a step (the 8 bytes before it: each load the
//                 warp's 32 consecutive bytes); the three tables' keys go
//                 through shared memory to element order, a step's 32
//                 lanes one 128-byte store a table;
//   then, a table at a time (t8, t4, t2):
//   k13c_any      whether the table has a slot set (else no initial value
//                 is read);
//   the stable LSD radix sort of sortlib.cuh over the table's N keys (its
//                 23, 20 and 16 bits: three, three and two passes), left in
//                 the half its last pass wrote (no copy back);
//   k13c_segmax   one pass over the sorted pairs, a CTA a tile of 4096 (the
//                 tiles taken from a counter, in order): the tile's
//                 segmented (by key) max, published as a look-back word;
//                 the value the segment brings into the tile from the words
//                 of the tiles before it (decoupled look-back, stopped at
//                 the first tile where the key starts); each element's
//                 inclusive max with its slot's initial value, scattered to
//                 cand in element order where the reader's check can take
//                 it (src % T < t: cand is zeroed first); each key's last
//                 element writes the slot's final value.  Every initial
//                 value is read before the tile's look-back word is
//                 published, and a key's last element is written only after
//                 the look-back has seen every earlier tile of the key
//                 publish: no slot is read after it is written;
//   k13c_check    a CTA a tile of 32 lanes x 32 steps: the three values in
//                 through shared memory, then a warp a lane and a thread a
//                 step (the registers' bytes are consecutive across the
//                 warp): the checks (ppm_r.cuh::lzp_fetch, lzp_check); the
//                 window compare only at a head: where the first bytes
//                 match and the candidate one step up is src + 1, the match
//                 is that one's plus a byte, capped at the window, so a
//                 link takes its head's length plus the steps between (a
//                 ballot and a shuffle); the heads compare by the whole
//                 warp, 256 bytes a round, 8 a thread, four heads' loads
//                 issued together (rolz_search.cuh::prefix_len's result;
//                 eight heads of the warp's four lanes together measured
//                 slower);
//                 the [T, S] grid out through shared memory, a step's 32
//                 lanes one store.
//
// Bound on the H100: bytes.  The function reads the block (N bytes) and
// writes the grid (4 N bytes) and the tables' slots it changes.  This
// design moves, a position: 12 bytes of keys out and 12 of zeros into
// cand, per table 8 bytes in and out a radix pass (eight passes in all)
// and 4 for the histogram, 8 bytes of sorted pairs into the segmented max
// and up to 4 scattered out, 12 bytes of values into the checks and 4 of
// grid out: about 215 bytes, 1.8 GB at N = 8 Mi (~0.54 ms at 3.35 TB/s),
// against the function's 48 MB.  The scatter's 4-byte writes land in
// whole sectors only by chance.
#include "rolz_search.cuh"
#include "sortlib.cuh"

namespace {

#define LZC_TILE 4096  // sorted keys a segmax CTA (the sort's tile)
#define LZC_THREADS 256
#define LZC_ITEMS (LZC_TILE / LZC_THREADS)
#define LZC_SIDE 32  // lanes and steps of a keys or check CTA's tile
#define LZC_TABS 3   // t8, t4, t2 (cand's and key's table order)
// a tile's look-back word: its own (head, max) or the inclusive max
#define LZC_INC (1u << 31)   // the max of its key's elements up to the tile's end
#define LZC_AGG (1u << 30)   // the tile's own max since the last key start in it
#define LZC_HEAD (1u << 29)  // with LZC_AGG: a key starts inside the tile
#define LZC_VAL ((1u << 29) - 1u)
#define LZC_NOKEY 0xFFFFFFFFu  // past the N sorted keys (keys are < 2^23)
#define LZC_BEFORE 0xFFFFFFFEu  // before the first sorted key

// The lane's registers before step t (block.py::_post_step's ctx4, ctx4b
// after bytes t-8 .. t-1; zero before the lane's first byte).  Valid for a
// position inside the block, where every earlier step of the lane was.
static __device__ __forceinline__ void regs_at(const uint8_t* inp, int T, int i, int t,
                                               uint32_t& ctx4, uint32_t& ctx4b) {
  const uint8_t* row = inp + (size_t)i * T;
  uint32_t a = 0, b = 0;
#pragma unroll
  for (int k = 8; k >= 1; --k) {
    const uint32_t by = t - k >= 0 ? row[t - k] : 0u;
    b = (b << 8) | (a >> 24);
    a = (a << 8) | by;
  }
  ctx4 = a;
  ctx4b = b;
}

// Element e of position (t, i): lanes descending inside a step.
static __device__ __forceinline__ size_t elem_of(const Cfg& c, int t, int i) {
  return (size_t)t * c.S + (c.S - 1 - i);
}

// Table u's [2, N] sort halves start at u * key_stride(N) (a multiple of 4
// words: the sort's histogram reads its keys 16 bytes at a time).
static __host__ __device__ __forceinline__ size_t key_stride(size_t N) {
  return 2 * ((N + 3) & ~(size_t)3);
}

__global__ void __launch_bounds__(LZC_THREADS) k13c_keys(Cfg c, const uint8_t* __restrict__ inp,
                                                         uint32_t* __restrict__ key) {
  __shared__ uint32_t sk[LZC_TABS][LZC_SIDE][LZC_SIDE + 1];  // [table][step][lane]
  const size_t N = (size_t)c.S * c.T;
  const int i0 = blockIdx.x * LZC_SIDE, t0 = blockIdx.y * LZC_SIDE;
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int r = w; r < LZC_SIDE; r += LZC_THREADS / 32) {
    if (i0 + r < c.S && t0 + l < c.T) {
      uint32_t ctx4, ctx4b;
      regs_at(inp, c.T, i0 + r, t0 + l, ctx4, ctx4b);
      sk[0][l][r] = lzp_hash8(ctx4, ctx4b);
      sk[1][l][r] = lzp_hash4(ctx4);
      sk[2][l][r] = ctx4 & 0xFFFFu;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < LZC_SIDE * LZC_SIDE; k += LZC_THREADS) {
    const int tl = k / LZC_SIDE, r = LZC_SIDE - 1 - k % LZC_SIDE;  // e ascending in k
    if (i0 + r >= c.S || t0 + tl >= c.T) continue;
    const size_t e = elem_of(c, t0 + tl, i0 + r);
#pragma unroll
    for (int u = 0; u < LZC_TABS; ++u) key[key_stride(N) * u + e] = sk[u][tl][r];
  }
}

// The segmented max (segments: runs of one key), as a (flag, value) pair:
// f, a segment starts inside; v, the largest value since the last start.
struct Seg {
  int f, v;
};

static __device__ __forceinline__ Seg seg_join(Seg a, Seg b) {
  return {a.f | b.f, b.f ? b.v : max(a.v, b.v)};
}

// The exclusive scan of each thread's pair over the CTA in thread order,
// and the CTA's total.  Values are >= 0, so {0, 0} is the identity.
static __device__ Seg cta_excl_seg(Seg x, Seg& total) {
  __shared__ int wf[LZC_THREADS / 32], wv[LZC_THREADS / 32];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Seg y{__shfl_up_sync(full, inc.f, off), __shfl_up_sync(full, inc.v, off)};
    if (lane >= off) inc = seg_join(y, inc);
  }
  Seg ex{__shfl_up_sync(full, inc.f, 1), __shfl_up_sync(full, inc.v, 1)};
  if (lane == 0) ex = Seg{0, 0};
  if (lane == 31) {
    wf[warp] = inc.f;
    wv[warp] = inc.v;
  }
  __syncthreads();
  Seg before{0, 0}, all{0, 0};
  for (int w = 0; w < LZC_THREADS / 32; ++w) {
    const Seg s{wf[w], wv[w]};
    if (w < warp) before = seg_join(before, s);
    all = seg_join(all, s);
  }
  total = all;
  return seg_join(before, ex);
}

// Element e's step and position; whether table u has its insert and its
// reader: t at or above the table's first step, the position inside the
// block.
struct Elem {
  int t, pos;
  bool live;
};

static __device__ __forceinline__ Elem elem_at(const Cfg& c, int u, int e) {
  const int t = e / c.S, i = c.S - 1 - (e - t * c.S);
  const int pos = i * c.T + t;
  return {t, pos, t >= (u == 0 ? 8 : u == 1 ? 4 : 2) && pos < c.n};
}

static __device__ __forceinline__ uint32_t lb_load(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

static __device__ __forceinline__ void lb_store(uint32_t* p, uint32_t v) {
  __threadfence();
  *reinterpret_cast<volatile uint32_t*>(p) = v;
}

// Whether any slot of a table is set: look's flag word (zeroed) becomes 1.
__global__ void k13c_any(const int4* __restrict__ table, int n4, uint32_t* __restrict__ flag) {
  bool any = false;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n4; j += gridDim.x * blockDim.x) {
    const int4 v = table[j];
    any |= (v.x | v.y | v.z | v.w) != 0;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) *flag = 1u;
}

// Table u's segmented max over its sorted (key, element) pairs (key and
// pos the sort's [2, N] arrays, the pairs in the half rs names): cand [N]
// in element order (zeroed; a value is written only where the reader's
// check can take it: an earlier step of its lane, src % T < t), the
// table's final slots.  look: a word a tile, the tile counter, the flag
// that the table had a slot set (k13c_any); zeroed.
__global__ void __launch_bounds__(LZC_THREADS) k13c_segmax(
    Cfg c, int u, const uint32_t* __restrict__ key, const int* __restrict__ pos,
    const int* __restrict__ rs, int* __restrict__ table, int* __restrict__ cand,
    uint32_t* __restrict__ look) {
  __shared__ int s_tile, s_carry;
  __shared__ uint32_t s_first[LZC_THREADS], s_last[LZC_THREADS];
  const int N = c.S * c.T, tiles = (N + LZC_TILE - 1) / LZC_TILE;
  if (threadIdx.x == 0) s_tile = atomicAdd(reinterpret_cast<int*>(look + tiles), 1);
  const int half = rs_sorted_half(rs);  // -1: one key, the identity order
  key += half > 0 ? N : 0;
  pos += half > 0 ? N : 0;
  const bool filled = look[tiles + 1] != 0;  // else every initial value is 0
  __syncthreads();
  const int tile = s_tile;
  const int r0 = tile * LZC_TILE + threadIdx.x * LZC_ITEMS;
  uint32_t k[LZC_ITEMS];
  int e[LZC_ITEMS];
  if (half < 0) {
#pragma unroll
    for (int j = 0; j < LZC_ITEMS; ++j) {
      k[j] = r0 + j < N ? key[r0 + j] : LZC_NOKEY;
      e[j] = r0 + j;
    }
  } else if ((half == 0 || N % 4 == 0) && r0 + LZC_ITEMS <= N) {  // 16-byte aligned
    const uint4* kv = reinterpret_cast<const uint4*>(key + r0);
    const int4* pv = reinterpret_cast<const int4*>(pos + r0);
#pragma unroll
    for (int j = 0; j < LZC_ITEMS / 4; ++j) {
      const uint4 a = kv[j];
      const int4 b = pv[j];
      k[4 * j] = a.x, k[4 * j + 1] = a.y, k[4 * j + 2] = a.z, k[4 * j + 3] = a.w;
      e[4 * j] = b.x, e[4 * j + 1] = b.y, e[4 * j + 2] = b.z, e[4 * j + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < LZC_ITEMS; ++j) {
      k[j] = r0 + j < N ? key[r0 + j] : LZC_NOKEY;
      e[j] = r0 + j < N ? pos[r0 + j] : 0;
    }
  }
  s_first[threadIdx.x] = k[0];
  s_last[threadIdx.x] = k[LZC_ITEMS - 1];
  __syncthreads();
  const uint32_t prev = threadIdx.x > 0 ? s_last[threadIdx.x - 1]
                        : r0 > 0        ? key[r0 - 1]
                                        : LZC_BEFORE;
  const uint32_t next = threadIdx.x + 1 < LZC_THREADS ? s_first[threadIdx.x + 1]
                        : r0 + LZC_ITEMS < N          ? key[r0 + LZC_ITEMS]
                                                      : LZC_NOKEY;
  // the heads, the values and each item's slot's initial value (read at
  // the thread's first item and at every head, all before the publish)
  unsigned heads = 0;
  int v[LZC_ITEMS], init[LZC_ITEMS];
  Seg mine{0, 0};
#pragma unroll
  for (int j = 0; j < LZC_ITEMS; ++j) {
    const bool live = k[j] != LZC_NOKEY;
    const bool h = k[j] != (j ? k[j > 0 ? j - 1 : 0] : prev);
    heads |= (unsigned)h << j;
    const Elem el = elem_at(c, u, e[j]);
    v[j] = live && el.live ? el.pos + 1 : 0;
    init[j] = !(live && filled) ? 0 : (j == 0 || h) ? table[k[j]] : init[j > 0 ? j - 1 : 0];
    mine = seg_join(mine, Seg{h, v[j]});
  }
  Seg total;
  const Seg before = cta_excl_seg(mine, total);
  if (threadIdx.x == 0) {
    // every read of an initial value is behind the barrier in cta_excl_seg
    Seg acc{0, 0};  // the tiles before this one, in order, back to a key start
    if (tile == 0) {
      lb_store(look, LZC_INC | (uint32_t)total.v);
    } else {
      lb_store(look + tile, LZC_AGG | (total.f ? LZC_HEAD : 0u) | (uint32_t)total.v);
      for (int j = tile - 1; j >= 0; --j) {
        uint32_t wd;
        do {
          wd = lb_load(look + j);
        } while (!(wd & (LZC_AGG | LZC_INC)));
        const Seg d{(wd & (LZC_INC | LZC_HEAD)) ? 1 : 0, (int)(wd & LZC_VAL)};
        acc = seg_join(d, acc);
        if (d.f) break;
      }
      lb_store(look + tile, LZC_INC | (uint32_t)seg_join(Seg{1, acc.v}, total).v);
    }
    s_carry = acc.v;
  }
  __syncthreads();
  Seg run = seg_join(Seg{0, s_carry}, before);
#pragma unroll
  for (int j = 0; j < LZC_ITEMS; ++j) {
    run = seg_join(run, Seg{(int)(heads >> j & 1), v[j]});
    if (k[j] == LZC_NOKEY) continue;
    const int val = max(run.v, init[j]);
    const Elem el = elem_at(c, u, e[j]);
    if (val > 0 && el.live && (val - 1) % c.T < el.t) cand[e[j]] = val;
    const bool last = k[j] != (j + 1 < LZC_ITEMS ? k[min(j + 1, LZC_ITEMS - 1)] : next);
    if (last && run.v > init[j]) table[k[j]] = run.v;
  }
}

// 8 bytes of the block at byte p, those at or past `limit` zeroed (words
// clamped into the block, as rolz_search.cuh::prefix_len reads them).
static __device__ __forceinline__ uint64_t bytes_at(const uint64_t* w, long long nw, long long p,
                                                    long long limit) {
  const long long k = p >> 3;
  return bytes8(__ldg(w + min(k, nw - 1)), __ldg(w + min(k + 1, nw - 1)), (int)(p & 7) * 8,
                limit - p);
}

// The window compare of up to four heads of a warp at once, a round of 256
// bytes a head, the warp's 32 threads 8 bytes each (rolz_search.cuh::
// prefix_len of each head's lane bytes from step t0 + head, zero past the
// row, against the block at its source, zero past the block): the own and
// the source bytes of a round are each 256 consecutive bytes, and the
// loads of the heads are issued together.  Sets m on each head's thread.
static __device__ __forceinline__ void warp_prefix(const uint8_t* inp, const Cfg& c, int i,
                                                   int t0, int src, unsigned heads, int& m) {
  const unsigned full = 0xffffffffu;
  const int l = threadIdx.x & 31;
  const uint64_t* w = reinterpret_cast<const uint64_t*>(inp);
  const long long cap = (long long)c.S * c.T, nw = cap >> 3;
  const long long row = (long long)i * c.T, row_end = row + c.T;
  while (heads) {
    int hl[4];
    uint64_t x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      hl[k] = heads ? __ffs(heads) - 1 : -1;
      heads &= heads - 1;
    }
    for (int base = 0; base < c.window; base += 256) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int hs = __shfl_sync(full, src, hl[k] & 31);
        const long long a = row + t0 + (hl[k] & 31) + base + 8 * l, b = (long long)hs + base + 8 * l;
        x[k] = hl[k] >= 0 ? bytes_at(w, nw, a, row_end) ^ bytes_at(w, nw, b, cap) : 0;
      }
      bool more = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (hl[k] < 0) continue;
        const unsigned d = __ballot_sync(full, x[k] != 0 && base + 8 * l < c.window);
        const int q = __ffs(d) - 1;
        const uint64_t xq = __shfl_sync(full, x[k], q & 31);
        if (d) {
          if (l == hl[k]) m = min(base + 8 * q + eq_bytes(xq), c.window);
          hl[k] = -1;  // done
        } else if (base + 256 >= c.window) {
          if (l == hl[k]) m = c.window;
        } else {
          more = true;
        }
      }
      if (!more) break;
    }
  }
}

// The 32 x 32 positions of a tile: the three values in (element order),
// the checks a warp a lane and a thread a step, the grid out ([T, S]).
__global__ void __launch_bounds__(LZC_THREADS) k13c_check(Cfg c, const uint8_t* __restrict__ inp,
                                                          const int* __restrict__ cand,
                                                          int* __restrict__ grid) {
  __shared__ int sc[LZC_TABS][LZC_SIDE][LZC_SIDE + 1];  // [table][step][lane]
  __shared__ int so[LZC_SIDE][LZC_SIDE + 1];            // [step][lane]
  const size_t N = (size_t)c.S * c.T;
  const int i0 = blockIdx.x * LZC_SIDE, t0 = blockIdx.y * LZC_SIDE;
  for (int k = threadIdx.x; k < LZC_SIDE * LZC_SIDE; k += LZC_THREADS) {
    const int tl = k / LZC_SIDE, r = LZC_SIDE - 1 - k % LZC_SIDE;
    if (i0 + r >= c.S || t0 + tl >= c.T) continue;
    const size_t e = elem_of(c, t0 + tl, i0 + r);
#pragma unroll
    for (int u = 0; u < LZC_TABS; ++u) sc[u][tl][r] = cand[N * u + e];
  }
  __syncthreads();
  const unsigned full = 0xffffffffu;
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5, t = t0 + l;
  for (int r = w; r < LZC_SIDE; r += LZC_THREADS / 32) {
    const int i = i0 + r;
    int src = 0;
    bool ok = false;
    if (i < c.S && t < c.T && i * c.T + t < c.n) {
      uint32_t ctx4, ctx4b;
      regs_at(inp, c.T, i, t, ctx4, ctx4b);
      const LzpSlots sl{sc[0][l][r] - 1, sc[1][l][r] - 1, sc[2][l][r] - 1};
      ok = lzp_check(c, t, ctx4, ctx4b, lzp_fetch(c, inp, t, sl), src);
    }
    // the window compare from the step above: where the first bytes are
    // equal and the candidate one step up is src + 1, the match is that
    // one's plus a byte (capped at the window); only the rest (the heads)
    // compare, and a link's length is its head's plus the steps between
    const bool eq = ok && inp[(size_t)i * c.T + t] == inp[src];
    const int src_up = __shfl_down_sync(full, src, 1);
    const bool ok_up = __shfl_down_sync(full, ok, 1);
    const bool link = eq && ok_up && l < 31 && src_up == src + 1;
    const unsigned links = __ballot_sync(full, link);
    int m = 0;
    warp_prefix(inp, c, i, t0, src, __ballot_sync(full, eq && !link), m);
    const int h = l + __ffs(~(links >> l)) - 1;  // the head: the first step up with no link
    const int mh = __shfl_sync(full, m, h);
    if (link) m = min(c.window, h - l + mh);
    int out = 0;
    if (ok) {
      int length = min(m, len_cap_at(c, i, t));
      if (length < c.min_len) length = 0;  // too short: a literal
      out = LZP_GRID_OK | length;
    }
    so[l][r] = out;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < LZC_SIDE * LZC_SIDE; k += LZC_THREADS) {
    const int tl = k / LZC_SIDE, r = k % LZC_SIDE;
    if (i0 + r < c.S && t0 + tl < c.T) grid[(size_t)(t0 + tl) * c.S + i0 + r] = so[tl][r];
  }
}

}  // namespace

// inp [S, T] uint8 (8-byte aligned); lzp2/4/8 updated in place to the
// block's final tables; grid [T, S] int32.  Scratch: key [3 * key_stride(N)]
// int32 (a table's sort halves each), pos [2, N] int32, rs (sortlib.cuh's, for
// N keys), cand [3, N] int32, look [3 * (tiles + 2)] int32 with tiles =
// ceil(N / 4096) + 2) (block.py::lzp_candidates sizes them).
extern "C" int cpx_k13c_launch(const int* cfg, const void* inp, void* lzp2, void* lzp4,
                               void* lzp8, void* grid, void* key, void* pos, void* rs,
                               void* cand, void* look, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  const int N = c.S * c.T;
  if (N < 1 || N > (1 << 28)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)inp;
  const int tiles = (N + LZC_TILE - 1) / LZC_TILE;
  int* const tabs[LZC_TABS] = {(int*)lzp8, (int*)lzp4, (int*)lzp2};
  const int slots[LZC_TABS] = {1 << LZP8_BITS, 1 << LZP4_BITS, 1 << 16};
  const dim3 sq((c.S + LZC_SIDE - 1) / LZC_SIDE, (c.T + LZC_SIDE - 1) / LZC_SIDE);
  cudaMemsetAsync(look, 0, (size_t)LZC_TABS * (tiles + 2) * sizeof(int), st);
  cudaMemsetAsync(cand, 0, (size_t)LZC_TABS * N * sizeof(int), st);
  k13c_keys<<<sq, LZC_THREADS, 0, st>>>(c, in, (uint32_t*)key);
  for (int u = 0; u < LZC_TABS; ++u) {
    uint32_t* const k = (uint32_t*)key + key_stride(N) * u;
    uint32_t* const lk = (uint32_t*)look + (size_t)(tiles + 2) * u;
    k13c_any<<<min(slots[u] / 4 / 256, 264), 256, 0, st>>>((const int4*)tabs[u], slots[u] / 4,
                                                         lk + tiles + 1);
    const int err = radix_sort_pairs(k, (int*)pos, (int*)rs, N, st, false);
    if (err) return err;
    k13c_segmax<<<tiles, LZC_THREADS, 0, st>>>(c, u, k, (const int*)pos, (const int*)rs,
                                                tabs[u], (int*)cand + (size_t)N * u, lk);
  }
  k13c_check<<<sq, LZC_THREADS, 0, st>>>(c, in, (const int*)cand, (int*)grid);
  return (int)cudaGetLastError();
}
