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
// a step (e = t*S + S-1-i), sorted stably by a 24-bit key (the three
// tables' slots side by side), give each key's elements in (step, lane
// descending) order; within one step the values grow with the lane, so a
// step's first element there is its largest, and the inclusive prefix max
// at any element of step t is the largest value of the steps <= t: the
// table as the reader at t sees it, its own insert of step t - 1 included
// (the candidate check src % T < t then rejects every value of step t - 1,
// as the step walk does).  Kernels, in launch order:
//   k13c_keys     an element a thread: its three keys (a sentinel where the
//                 table has no reader and no insert: t below the table's
//                 first step, or past the block);
//   the stable LSD radix sort of sortlib.cuh (three passes: the top digit
//                 of a 24-bit key is constant and skipped);
//   k13c_tile_agg a tile of 4096 sorted keys a CTA: the tile's segmented
//                 (by key) max;
//   k13c_tile_scan one CTA: the value each tile starts its first segment
//                 with;
//   k13c_resolve  the segmented prefix max of every sorted element, with
//                 the table's initial value of its key: the value the
//                 element's reader finds (cand, element order);
//   k13c_store    the tables' final values, from each key's last element;
//   k13c_check    a position a thread: the three values' checks
//                 (ppm_r.cuh::lzp_fetch, lzp_check), the window compare
//                 (rolz_search.cuh::prefix_len) and the [T, S] grid.
//
// Bound on the H100: bytes.  The function reads the block (N bytes) and
// writes the grid (4 N bytes) and the tables' slots it changes; between,
// the sort moves 8 bytes a key and pass over 3 N keys, and each window
// compare reads up to 2 * window bytes of the block, which stays in the
// 50 MB L2 at the main path's 8 MiB.
#include "rolz_search.cuh"
#include "sortlib.cuh"

namespace {

#define LZC_T8 0                                          // key of t8's slot s: s
#define LZC_T4 (1 << LZP8_BITS)                           // t4's: LZC_T4 + s
#define LZC_T2 ((1 << LZP8_BITS) + (1 << LZP4_BITS))      // t2's: LZC_T2 + s
#define LZC_NONE ((1u << 24) - 1u)                        // no reader, no insert
#define LZC_TILE 4096                                     // sorted keys a CTA
#define LZC_THREADS 256
#define LZC_ITEMS (LZC_TILE / LZC_THREADS)

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

// Element e of a table: step t, lane i (lanes descending inside a step).
static __device__ __forceinline__ void elem_at(int e, int S, int& t, int& i) {
  t = e / S;
  i = S - 1 - (e - t * S);
}

__global__ void k13c_keys(Cfg c, const uint8_t* __restrict__ inp, uint32_t* __restrict__ key) {
  const int N = c.S * c.T;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  int t, i;
  elem_at(e, c.S, t, i);
  uint32_t k8 = LZC_NONE, k4 = LZC_NONE, k2 = LZC_NONE;
  if (i * c.T + t < c.n && t >= 2) {
    uint32_t ctx4, ctx4b;
    regs_at(inp, c.T, i, t, ctx4, ctx4b);
    k2 = LZC_T2 + (ctx4 & 0xFFFFu);
    if (t >= 4) k4 = LZC_T4 + lzp_hash4(ctx4);
    if (t >= 8) k8 = LZC_T8 + lzp_hash8(ctx4, ctx4b);
  }
  key[e] = k8;
  key[N + e] = k4;
  key[2 * N + e] = k2;
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
template <int THREADS>
static __device__ Seg cta_excl_seg(Seg x, Seg& total) {
  __shared__ int wf[THREADS / 32], wv[THREADS / 32];
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
  for (int w = 0; w < THREADS / 32; ++w) {
    const Seg s{wf[w], wv[w]};
    if (w < warp) before = seg_join(before, s);
    all = seg_join(all, s);
  }
  __syncthreads();  // wf, wv free again
  total = all;
  return seg_join(before, ex);
}

// A sorted element's value: its insert's (position of step t, + 1), 0 for
// the sentinel.
static __device__ __forceinline__ int elem_value(const Cfg& c, uint32_t k, int x, int N) {
  if (k == LZC_NONE) return 0;
  int t, i;
  elem_at(x % N, c.S, t, i);
  return i * c.T + t + 1;
}

// This thread's items of its tile: keys, heads (a key's first element) and
// values; past n3 the sentinel.
struct Items {
  uint32_t k[LZC_ITEMS];
  int v[LZC_ITEMS];
  bool h[LZC_ITEMS];
};

static __device__ __forceinline__ Items load_items(const Cfg& c, const uint32_t* key,
                                                   const int* pos, int n3, int N) {
  Items it;
  const int r0 = blockIdx.x * LZC_TILE + threadIdx.x * LZC_ITEMS;
  uint32_t prev = r0 > 0 && r0 - 1 < n3 ? key[r0 - 1] : 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < LZC_ITEMS; ++j) {
    const int r = r0 + j;
    const uint32_t k = r < n3 ? key[r] : LZC_NONE;
    it.k[j] = k;
    it.v[j] = r < n3 ? elem_value(c, k, pos[r], N) : 0;
    it.h[j] = k != prev;
    prev = k;
  }
  return it;
}

__global__ void __launch_bounds__(LZC_THREADS) k13c_tile_agg(Cfg c, const uint32_t* __restrict__ key,
                                                            const int* __restrict__ pos, int n3,
                                                            int* __restrict__ agg) {
  const Items it = load_items(c, key, pos, n3, c.S * c.T);
  Seg mine{0, 0};
#pragma unroll
  for (int j = 0; j < LZC_ITEMS; ++j) mine = seg_join(mine, Seg{it.h[j], it.v[j]});
  Seg total;
  cta_excl_seg<LZC_THREADS>(mine, total);
  if (threadIdx.x == 0) {
    agg[2 * blockIdx.x] = total.f;
    agg[2 * blockIdx.x + 1] = total.v;
  }
}

// One CTA of 1024 threads, each a run of consecutive tiles: carry[k] (at
// agg + 2 * tiles) is the value the segment running into tile k has.
__global__ void __launch_bounds__(1024) k13c_tile_scan(int* __restrict__ agg, int tiles) {
  const int per = (tiles + 1023) / 1024;
  const int k0 = threadIdx.x * per, k1 = min(k0 + per, tiles);
  Seg mine{0, 0};
  for (int k = k0; k < k1; ++k) mine = seg_join(mine, Seg{agg[2 * k], agg[2 * k + 1]});
  Seg total;
  Seg run = cta_excl_seg<1024>(mine, total);
  for (int k = k0; k < k1; ++k) {
    agg[2 * tiles + k] = run.v;
    run = seg_join(run, Seg{agg[2 * k], agg[2 * k + 1]});
  }
}

// The value of its key's table slot the element's reader finds: the
// segmented prefix max (with the carry into the tile) and the slot's
// initial value; cand in element order (table-major), 0 for the sentinel.
__global__ void __launch_bounds__(LZC_THREADS) k13c_resolve(
    Cfg c, const uint32_t* __restrict__ key, const int* __restrict__ pos, int n3,
    const int* __restrict__ agg, Lzp z, int* __restrict__ cand) {
  const int N = c.S * c.T, tiles = (n3 + LZC_TILE - 1) / LZC_TILE;
  const Items it = load_items(c, key, pos, n3, N);
  Seg mine{0, 0};
#pragma unroll
  for (int j = 0; j < LZC_ITEMS; ++j) mine = seg_join(mine, Seg{it.h[j], it.v[j]});
  Seg total;
  Seg run = seg_join(Seg{0, agg[2 * tiles + blockIdx.x]}, cta_excl_seg<LZC_THREADS>(mine, total));
  const int r0 = blockIdx.x * LZC_TILE + threadIdx.x * LZC_ITEMS;
#pragma unroll
  for (int j = 0; j < LZC_ITEMS; ++j) {
    run = seg_join(run, Seg{it.h[j], it.v[j]});
    const uint32_t k = it.k[j];
    if (r0 + j >= n3) continue;
    int v = 0;
    if (k != LZC_NONE)
      v = max(run.v, k < LZC_T4 ? z.t8[k - LZC_T8] : k < LZC_T2 ? z.t4[k - LZC_T4] : z.t2[k - LZC_T2]);
    cand[pos[r0 + j]] = v;
  }
}

// Each key's last element holds the largest value inserted under it: the
// slot's final value (a scatter-max of the block's inserts).
__global__ void k13c_store(const uint32_t* __restrict__ key, const int* __restrict__ pos, int n3,
                           const int* __restrict__ cand, Lzp z) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n3) return;
  const uint32_t k = key[r];
  if (k == LZC_NONE || (r + 1 < n3 && key[r + 1] == k)) return;
  const int v = cand[pos[r]];
  if (k < LZC_T4) z.t8[k - LZC_T8] = v;
  else if (k < LZC_T2) z.t4[k - LZC_T4] = v;
  else z.t2[k - LZC_T2] = v;
}

// A position a thread: the step walk's candidate (lzp_check on the three
// values the reader finds), its length against the lane's next window
// bytes, capped, and 0 under min_len; grid[t, i] = length | LZP_GRID_OK if
// a table has a candidate (0 past the block).
__global__ void k13c_check(Cfg c, const uint8_t* __restrict__ inp, const int* __restrict__ cand,
                           int* __restrict__ grid) {
  const int N = c.S * c.T;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= N) return;
  const int t = g / c.S, i = g - t * c.S;
  int out = 0;
  if (i * c.T + t < c.n) {
    const int e = t * c.S + (c.S - 1 - i);
    uint32_t ctx4, ctx4b;
    regs_at(inp, c.T, i, t, ctx4, ctx4b);
    const LzpSlots sl{cand[e] - 1, cand[N + e] - 1, cand[2 * N + e] - 1};
    int src = 0;
    if (lzp_check(c, t, ctx4, ctx4b, lzp_fetch(c, inp, t, sl), src)) {
      int length = min(prefix_len(inp, c, i, t, src, c.window), len_cap_at(c, i, t));
      if (length < c.min_len) length = 0;  // too short: a literal
      out = LZP_GRID_OK | length;
    }
  }
  grid[g] = out;
}

}  // namespace

// inp [S, T] uint8 (8-byte aligned); lzp2/4/8 updated in place to the
// block's final tables; grid [T, S] int32.  Scratch: key and pos [2, 3N]
// int32, rs (sortlib.cuh's, for 3N keys), cand [3N] int32, agg [3 *
// tiles] int32 with tiles = ceil(3N / 4096) (block.py::lzp_candidates
// sizes them).
extern "C" int cpx_k13c_launch(const int* cfg, const void* inp, void* lzp2, void* lzp4,
                               void* lzp8, void* grid, void* key, void* pos, void* rs,
                               void* cand, void* agg, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  const int N = c.S * c.T, n3 = 3 * N;
  if (N < 1 || N > (1 << 28)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Lzp z{(int*)lzp2, (int*)lzp4, (int*)lzp8};
  const uint8_t* in = (const uint8_t*)inp;
  k13c_keys<<<(N + 255) / 256, 256, 0, st>>>(c, in, (uint32_t*)key);
  int err = radix_sort_pairs((uint32_t*)key, (int*)pos, (int*)rs, n3, st);
  if (err) return err;
  const int tiles = (n3 + LZC_TILE - 1) / LZC_TILE;
  k13c_tile_agg<<<tiles, LZC_THREADS, 0, st>>>(c, (const uint32_t*)key, (const int*)pos, n3,
                                               (int*)agg);
  k13c_tile_scan<<<1, 1024, 0, st>>>((int*)agg, tiles);
  k13c_resolve<<<tiles, LZC_THREADS, 0, st>>>(c, (const uint32_t*)key, (const int*)pos, n3,
                                              (const int*)agg, z, (int*)cand);
  k13c_store<<<(n3 + 255) / 256, 256, 0, st>>>((const uint32_t*)key, (const int*)pos, n3,
                                               (const int*)cand, z);
  k13c_check<<<(N + 255) / 256, 256, 0, st>>>(c, in, (const int*)cand, (int*)grid);
  return (int)cudaGetLastError();
}
