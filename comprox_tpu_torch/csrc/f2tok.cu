// K8: the tokenizer of the fast profile (mode F).
//
// Replaces comprox_tpu/codec/fast.py::_replay_body (287-305) under its scan,
// _tokenize (308-340) with _last_nonzero_fill (140), and _token_events
// (343-367).  From the parse decisions (take, src per step and lane) to the
// tokens in position order: a token starts where a lane is not inside a
// match; a match whose distance equals the previous match's (in position
// order over the whole block, lanes included) is a repeat; each token gets
// its symbol, its extra bits and their count, at the slot "token starts
// before it".  JAX reaches that order by a stable sort on the one-bit key
// "not a start", which also lines the other positions up behind the tokens;
// nothing reads those, so the kernel writes the n_tok tokens and no more.
//
// Bound on the H100: bytes (the block, the decisions and 12 per token
// written).  The replay is the one sequential part: a lane's next token
// start depends on the match taken at this one (nxt(t) = t + max(take, 1)),
// S chains of T dependent steps.  No thread walks a whole chain: a lane's
// T steps are cut into chunks of K8_C steps, and each chunk first computes
// its exit map, for every step t of the chunk the offset into the next
// chunk at which a walk that reaches t leaves it (a backward recurrence:
// exit(t) = nxt(t) - C past the chunk's end, else exit(nxt(t))).  Chunk c's
// true entry is chunk c - 1's map at its own true entry (chunk 0 enters at
// 0): a chain of one lookup a chunk, published through a decoupled
// look-back in chunk order (CTAs take tickets, so that none waits on a
// chunk whose CTA has not started).  Then each chunk walks once from its
// true entry, within the chunk, writing the takes of its starts in order
// (a chunk's token list: its positions are the entry plus the prefix sums
// of max(take, 1)) and the (starts, last match distance) pair of the scan.
// take <= 256 (the window's cap, block.py:113), so an exit offset is below
// 256 and a byte holds it; a larger take is refused.  The emit reads the
// lists whole and the decisions' src only at the matches: a token costs
// one scattered read, not one a position or two a token.
// Kernels:
//   k8_replay_clear   zeroes the look-back words, the ticket and the flag;
//   k8_replay_chunks  a CTA per 32 lanes x one chunk (a ticket each): the
//                     take tile staged in shared memory, coalesced across
//                     lanes; a thread a lane: the exit map, the look-back,
//                     the walk, compacting the starts' takes in place in
//                     the tile; the lists written a lane's run at a time;
//                     the chunk's pair;
//   scan_parts        (f2scan.cuh) exclusive prefixes over the chunks, in
//                     position order, and n_tok;
//   k8_emit           a warp a chunk, a token a thread at a time: the
//                     positions from the list by a warp scan, the src of
//                     each match and the byte; scans the chunk's tokens
//                     from its prefix, marks repeats and writes each
//                     token's (sym, xtr, bits), 32 consecutive slots at a
//                     time.
#include "ppm_r.cuh"
#include "f2scan.cuh"

namespace {

#define L_DIRECT 8
#define L_BUCKETS 13
#define DB_REPEAT 24

#define K8_C 512        // steps a chunk (fast.py::K8_CHUNK)
#define K8_LANES 32     // lanes a CTA of the replay
#define K8_THREADS 256  // the replay's threads: a warp a sub-chunk
#define K8_SUB 64       // steps a sub-chunk of the exit maps (K8_C / (K8_THREADS / 32))
#define K8_TAKE_MAX 256 // the window's cap: exit offsets fit a byte
#define K8_DONE 0x10000u  // a look-back word's flag, beside its entry offset
#define K8_EMIT_WARPS 8

// dynamic shared memory of the replay: the take tile [C][32] u16 (after
// the walk each lane's column holds its starts' takes), the exit maps
// [C][32] u8
#define K8_SMEM (K8_C * K8_LANES * 3)

static __device__ __forceinline__ uint32_t lb_load(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

// A look-back word carries its flag and its value together, so no fence
// orders it after other writes.
static __device__ __forceinline__ void lb_store(uint32_t* p, uint32_t v) {
  *reinterpret_cast<volatile uint32_t*>(p) = v;
}

// look: [nch * S] words (chunk c's exit of lane l at c * S + l: chunk c +
// 1's entry), then the ticket counter and the error flag; zeroed by
// k8_replay_clear.  list: [S * nch, C] u16, row l * nch + c: chunk c of
// lane l's starts' takes in position order, its first parts[..].cnt
// entries written.  parts[l * nch + c]: chunk c of lane l's (starts,
// last match distance or 0).
__global__ void k8_replay_clear(uint32_t* __restrict__ look, int words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < words) look[i] = 0u;
}

__global__ void __launch_bounds__(K8_THREADS, 4) k8_replay_chunks(
    int S, int T, int n, const int* __restrict__ take, const int* __restrict__ src,
    uint16_t* __restrict__ list, CountLast* __restrict__ parts,
    uint32_t* __restrict__ look) {
  extern __shared__ __align__(16) unsigned char k8_smem[];
  uint16_t* const tk_s = reinterpret_cast<uint16_t*>(k8_smem);    // [t][lane]
  uint8_t* const ex_s = k8_smem + K8_C * K8_LANES * 2;              // [t][lane]
  __shared__ int s_ticket, cnt_s[K8_LANES];
  const int nch = (T + K8_C - 1) / K8_C, groups = (S + K8_LANES - 1) / K8_LANES;
  if (threadIdx.x == 0) s_ticket = atomicAdd(reinterpret_cast<int*>(look + (size_t)nch * S), 1);
  __syncthreads();
  const int c = s_ticket / groups, g = s_ticket - c * groups;  // chunk-major
  const int cbase = c * K8_C, Lc = min(K8_C, T - cbase);
  const int lane0 = g * K8_LANES;

  // the chunk's take tile, a row of 32 lanes (128 bytes) eight threads at
  // a time, four lanes (16 bytes) a thread, every row of the thread in
  // flight at once (where S is a multiple of 4; else a lane a load)
  bool bad = false;
  {
    constexpr int rows = K8_THREADS / 8;
    const int q = threadIdx.x & 7, lane = lane0 + 4 * q;
    const bool quad = (S & 3) == 0 && lane + 4 <= S;
    constexpr int batch = 8;  // rows a thread in flight
    for (int k0 = 0; k0 < K8_C / rows; k0 += batch) {
      int4 v[batch];
#pragma unroll
      for (int k = 0; k < batch; ++k) {
        const int r = (threadIdx.x >> 3) + (k0 + k) * rows;
        const int* src_ = take + (size_t)(cbase + r) * S + lane;
        v[k] = make_int4(0, 0, 0, 0);
        if (r < Lc) {
          if (quad) {
            v[k] = *reinterpret_cast<const int4*>(src_);
          } else {
            v[k].x = lane < S ? src_[0] : 0;
            v[k].y = lane + 1 < S ? src_[1] : 0;
            v[k].z = lane + 2 < S ? src_[2] : 0;
            v[k].w = lane + 3 < S ? src_[3] : 0;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < batch; ++k) {
        const int r = (threadIdx.x >> 3) + (k0 + k) * rows;
        bad |= max(max((unsigned)v[k].x, (unsigned)v[k].y),
                   max((unsigned)v[k].z, (unsigned)v[k].w)) > (unsigned)K8_TAKE_MAX;
        if (r < Lc)
          *reinterpret_cast<uint2*>(tk_s + r * K8_LANES + 4 * q) = make_uint2(
              ((unsigned)v[k].x & 0xFFFFu) | ((unsigned)v[k].y << 16),
              ((unsigned)v[k].z & 0xFFFFu) | ((unsigned)v[k].w << 16));
      }
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) look[(size_t)nch * S + 1] = 1u;

  // the exit maps, first of each sub-chunk of K8_SUB steps (a warp each, a
  // thread a lane: the offset past the sub-chunk's end of a walk that
  // reaches t), then composed from the last sub-chunk back, all threads
  // at once, into the chunk's (the offset into the next chunk)
  {
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    const int lo = w * K8_SUB, hi = min(lo + K8_SUB, Lc);
    for (int t = hi - 1; t >= lo; --t) {
      const int nx = t + max((int)tk_s[t * K8_LANES + l], 1);
      ex_s[t * K8_LANES + l] = (uint8_t)(nx >= hi ? nx - hi : ex_s[nx * K8_LANES + l]);
    }
  }
  __syncthreads();
  for (int w = (Lc - 1) / K8_SUB - 1; w >= 0; --w) {  // the last one's is the chunk's
    const int lo = w * K8_SUB, hi = lo + K8_SUB;
    for (int k = threadIdx.x; k < K8_SUB * K8_LANES; k += K8_THREADS) {
      const int i = lo * K8_LANES + k;  // step lo + k / 32, lane k % 32
      const int at = hi + ex_s[i];
      ex_s[i] = (uint8_t)(at >= Lc ? at - Lc : ex_s[at * K8_LANES + (k & 31)]);
    }
    __syncthreads();
  }

  if (threadIdx.x < K8_LANES) {
    const int l = threadIdx.x, lane = lane0 + l;
    int cnt = 0;
    if (lane < S) {
      // the true entry, then this chunk's exit for the next one
      int e = 0;
      if (c > 0) {
        const uint32_t* w = look + (size_t)(c - 1) * S + lane;
        uint32_t v;
        while (!((v = lb_load(w)) & K8_DONE)) {
        }
        e = (int)(v & 0xFFFFu);
      }
      if (c + 1 < nch)
        lb_store(look + (size_t)c * S + lane,
                 K8_DONE | (uint32_t)(e >= Lc ? e - Lc : ex_s[e * K8_LANES + l]));
      // the walk: the starts within the chunk from its true entry, up to
      // the block's end; the k-th start's take goes to row k of the
      // column, which the walk has read (k <= its position)
      const int nl = min(max(n - lane * T - cbase, 0), Lc);
      int lastm = -1;
      for (int t = e; t < nl;) {
        const int tk = tk_s[t * K8_LANES + l];
        tk_s[cnt * K8_LANES + l] = (uint16_t)tk;
        ++cnt;
        if (tk > 0) lastm = t;
        t += max(tk, 1);
      }
      const int pos = lane * T + cbase + lastm;
      parts[(size_t)lane * nch + c] = CountLast{
          cnt, lastm < 0 ? 0 : max(pos - src[(size_t)(cbase + lastm) * S + lane], 1)};
    }
    cnt_s[l] = cnt;
  }
  __syncthreads();
  // the lists: a warp a lane at a time, a thread an entry
  for (int l = threadIdx.x >> 5; l < K8_LANES; l += K8_THREADS / 32) {
    uint16_t* const row = list + ((size_t)(lane0 + l) * nch + c) * K8_C;
    for (int k = threadIdx.x & 31; k < cnt_s[l]; k += 32) row[k] = tk_s[k * K8_LANES + l];
  }
}

// Token (packed event e0, distance) -> (sym, xtr, bits): fast.py::
// _token_events for an active token.
__device__ __forceinline__ void token_event(int e0, int dist, int min_len,
                                            int& sym, int& xtr, int& tbits) {
  const bool is_m = (e0 >> 8) & 1, rep = (e0 >> 9) & 1;
  if (!is_m) {
    sym = e0 & 0xFF;
    xtr = 0;
    tbits = 0;
    return;
  }
  const int v = min(max((e0 >> 10) - min_len, 0), 255);
  int lb = v, len_bits = 0, len_mant = 0;
  if (v >= L_DIRECT) {
    len_bits = 3 + (v >= 16) + (v >= 32) + (v >= 64) + (v >= 128);
    lb = 5 + len_bits;
    len_mant = v - (1 << len_bits);
  }
  const int db = rep ? DB_REPEAT : min(31 - __clz(max(dist, 1)), 24);
  const int kd = min(db, 23);
  const int dist_bits = rep ? 0 : kd;
  const int dist_mant = rep ? 0 : dist - (1 << kd);
  sym = 256 + db * L_BUCKETS + lb;
  xtr = (int)((uint32_t)len_mant | ((uint32_t)dist_mant << len_bits));
  tbits = len_bits + dist_bits;
}

// A warp a chunk (position order: q = lane * nch + c), a token a thread
// at a time.  parts: the chunks' exclusive prefixes (parts[q + 1] - parts[q]:
// the chunk's tokens); look: the chunks' entries (the replay's).
__global__ void __launch_bounds__(K8_EMIT_WARPS * 32) k8_emit(
    int S, int T, int min_len, const uint8_t* __restrict__ inp,
    const uint16_t* __restrict__ list, const int* __restrict__ src,
    const uint32_t* __restrict__ look, const CountLast* __restrict__ parts,
    int* __restrict__ sym_out, int* __restrict__ xtr_out, int* __restrict__ tbits_out) {
  const unsigned full = 0xffffffffu;
  const int nch = (T + K8_C - 1) / K8_C;
  const int q = blockIdx.x * K8_EMIT_WARPS + (threadIdx.x >> 5);
  if (q >= S * nch) return;  // the whole warp
  const int lane = q / nch, c = q - lane * nch, l = threadIdx.x & 31;
  const int cbase = c * K8_C;
  CountLast run = parts[q];
  const int ntok = parts[q + 1].cnt - run.cnt;
  // the position of the chunk's next token: its entry at first
  int at = c == 0 ? 0 : (int)(look[(size_t)(c - 1) * S + lane] & 0xFFFFu);
  const uint16_t* const row = list + (size_t)q * K8_C;
  const uint8_t* const bytes = inp + (size_t)lane * T + cbase;
  for (int k0 = 0; k0 < ntok; k0 += 32) {
    const bool live = k0 + l < ntok;
    const int len = live ? row[k0 + l] : 0;
    const int step = live ? max(len, 1) : 0;
    int inc = step;  // the warp's inclusive sum of the steps
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(full, inc, off);
      if (l >= off) inc += o;
    }
    const int t = at + inc - step;  // this token's step in the chunk
    at += __shfl_sync(full, inc, 31);
    const int pos = lane * T + cbase + t;
    const int s_ = len > 0 ? src[(size_t)(cbase + t) * S + lane] : 0;
    const int byte = live ? bytes[t] : 0;
    const int dist = len > 0 ? max(pos - s_, 1) : 0;
    // the warp's exclusive (starts, last distance) from the chunk's
    CountLast in{live, dist};
    for (int off = 1; off < 32; off <<= 1) {
      const CountLast o{__shfl_up_sync(full, in.cnt, off), __shfl_up_sync(full, in.last, off)};
      if (l >= off) in = combine(o, in);
    }
    CountLast ex{__shfl_up_sync(full, in.cnt, 1), __shfl_up_sync(full, in.last, 1)};
    if (l == 0) ex = CountLast{0, 0};
    const CountLast before = combine(run, ex);
    if (live) {
      const bool is_m = len > 0;
      const bool rep = is_m && dist == max(before.last, 1);
      const int e0 = byte | (is_m ? (1 << 8) | (rep ? 1 << 9 : 0) | (len << 10) : 0);
      int sym, xtr, tbits;
      token_event(e0, dist, min_len, sym, xtr, tbits);
      sym_out[before.cnt] = sym;
      xtr_out[before.cnt] = xtr;
      tbits_out[before.cnt] = tbits;
    }
    run = combine(run, CountLast{__shfl_sync(full, in.cnt, 31), __shfl_sync(full, in.last, 31)});
  }
}

}  // namespace

// inp [S, T] u8; dec [>= 2, T, S] (take, src; take <= 256); list [S *
// nch * K8_C] u16 scratch; parts [S * nch + 1, 2] scratch, parts[S *
// nch][0] = n_tok on return; look [nch * S + 2] u32 scratch, look[nch * S
// + 1] = 1 on return where a take was above 256; ev [3, N] (sym, xtr,
// bits), of which the first n_tok of each row are written.  nch =
// ceil(T / K8_C).
extern "C" int cpx_k8_launch(const int* cfg, const void* inp, const void* dec,
                             void* list, void* parts, void* look, void* ev,
                             void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  cudaStream_t st = (cudaStream_t)stream;
  const size_t big = (size_t)c.S * c.T;
  const int nch = (c.T + K8_C - 1) / K8_C;
  const int chunks = c.S * nch;
  const int groups = (c.S + K8_LANES - 1) / K8_LANES;
  int* const out = (int*)ev;
  k8_replay_clear<<<(chunks + 2 + 255) / 256, 256, 0, st>>>((uint32_t*)look, chunks + 2);
  cudaError_t err = cudaFuncSetAttribute(k8_replay_chunks,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, K8_SMEM);
  if (err != cudaSuccess) return (int)err;
  k8_replay_chunks<<<groups * nch, K8_THREADS, K8_SMEM, st>>>(
      c.S, c.T, c.n, (const int*)dec, (const int*)dec + big, (uint16_t*)list,
      (CountLast*)parts, (uint32_t*)look);
  scan_parts<<<1, 1024, 0, st>>>((CountLast*)parts, chunks);
  k8_emit<<<(chunks + K8_EMIT_WARPS - 1) / K8_EMIT_WARPS, K8_EMIT_WARPS * 32, 0, st>>>(
      c.S, c.T, c.min_len, (const uint8_t*)inp, (const uint16_t*)list,
      (const int*)dec + big, (const uint32_t*)look, (const CountLast*)parts, out,
      out + big, out + 2 * big);
  return (int)cudaGetLastError();
}
