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
// Bound on the H100: the replay is S independent chains of T dependent
// steps (a lane's next token start depends on the match taken at this one),
// so it is bound by a step's latency times T; the rest is bound by bytes
// (the block, the start flags and the decision grids read twice, 12 per
// token written).  The grids are [T, S] and the positions run lane by lane,
// so a tile reads them with a stride of S: whole sectors for single words,
// served by the L2, where the tiles of neighbouring lanes run together.
// Kernels:
//   k8_replay   one thread per lane: the rem chain, reading take coalesced
//               across lanes, writing one start flag per position;
//   k8_reduce   one CTA per tile of 2048 positions: reduces (starts, last
//               distance);
//   scan_parts  (f2scan.cuh) exclusive prefixes over the tiles, and n_tok;
//   k8_emit     one CTA per tile: scans the tile from its prefix, marks
//               repeats and writes each token's (sym, xtr, bits).
#include "ppm_r.cuh"
#include "f2scan.cuh"

namespace {

#define L_DIRECT 8
#define L_BUCKETS 13
#define DB_REPEAT 24

__global__ void k8_replay(int S, int T, int n, const int* __restrict__ take,
                          uint8_t* __restrict__ start) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  int rem = 0;
  uint8_t* const row = start + (size_t)lane * T;
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const int tk = take[(size_t)t * S + lane];
    const bool st = (lane * T + t < n) && rem == 0;
    rem = (st && tk > 0) ? tk - 1 : max(rem - 1, 0);
    row[t] = st;
  }
}

// Position i as a scan element: (1 if it starts a token, its match distance
// or 0), and the match length in len (0 for a literal).
__device__ __forceinline__ CountLast position_event(int S, int T, int i,
                                                    const uint8_t* start,
                                                    const int* dec, int& len) {
  len = 0;
  if (!start[i]) return CountLast{0, 0};
  const size_t o = (size_t)(i % T) * S + i / T;
  len = dec[o];
  return CountLast{1, len > 0 ? max(i - dec[(size_t)S * T + o], 1) : 0};
}

__global__ void __launch_bounds__(SCAN_THREADS) k8_reduce(
    int S, int T, const uint8_t* __restrict__ start, const int* __restrict__ dec,
    CountLast* __restrict__ parts) {
  __shared__ CountLast wsum[32];
  const int big = S * T;
  const int base = blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_PER;
  CountLast v{0, 0};
  for (int k = 0; k < SCAN_PER; ++k) {
    if (base + k >= big) break;
    int len;
    v = combine(v, position_event(S, T, base + k, start, dec, len));
  }
  CountLast total;
  cta_excl_scan(v, wsum, total);
  if (threadIdx.x == 0) parts[blockIdx.x] = total;
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

__global__ void __launch_bounds__(SCAN_THREADS) k8_emit(
    int S, int T, int min_len, const uint8_t* __restrict__ inp,
    const uint8_t* __restrict__ start, const int* __restrict__ dec,
    const CountLast* __restrict__ parts, int* __restrict__ sym_out,
    int* __restrict__ xtr_out, int* __restrict__ tbits_out) {
  __shared__ CountLast wsum[32];
  const int big = S * T;
  const int base = blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_PER;
  CountLast e[SCAN_PER];
  int len[SCAN_PER];
  CountLast v{0, 0};
#pragma unroll
  for (int k = 0; k < SCAN_PER; ++k) {
    len[k] = 0;
    e[k] = base + k < big ? position_event(S, T, base + k, start, dec, len[k])
                          : CountLast{0, 0};
    v = combine(v, e[k]);
  }
  CountLast total;
  CountLast run = combine(parts[blockIdx.x], cta_excl_scan(v, wsum, total));
#pragma unroll
  for (int k = 0; k < SCAN_PER; ++k) {
    // run: the starts before this position, and the last match distance
    // before it
    if (e[k].cnt) {
      const int dist = e[k].last;
      const bool is_m = len[k] > 0;
      const bool rep = is_m && dist == max(run.last, 1);
      const int e0 = (int)inp[base + k] |
                     (is_m ? (1 << 8) | (rep ? 1 << 9 : 0) | (len[k] << 10) : 0);
      int sym, xtr, tbits;
      token_event(e0, dist, min_len, sym, xtr, tbits);
      sym_out[run.cnt] = sym;
      xtr_out[run.cnt] = xtr;
      tbits_out[run.cnt] = tbits;
      run = combine(run, e[k]);
    }
  }
}

}  // namespace

// inp [S, T] u8; dec [>= 2, T, S] (take, src); start [N] u8 scratch; parts
// [tiles + 1, 2] scratch, parts[tiles][0] = n_tok on return; ev [3, N] (sym,
// xtr, bits), of which the first n_tok of each row are written.
extern "C" int cpx_k8_launch(const int* cfg, const void* inp, const void* dec,
                             void* start, void* parts, void* ev, void* stream) {
  Cfg c;
  memcpy(&c, cfg, sizeof(Cfg));
  cudaStream_t st = (cudaStream_t)stream;
  const int big = c.S * c.T;
  const int tiles = (big + SCAN_TILE - 1) / SCAN_TILE;
  int* const out = (int*)ev;
  k8_replay<<<(c.S + 127) / 128, 128, 0, st>>>(c.S, c.T, c.n, (const int*)dec,
                                               (uint8_t*)start);
  k8_reduce<<<tiles, SCAN_THREADS, 0, st>>>(c.S, c.T, (const uint8_t*)start,
                                            (const int*)dec, (CountLast*)parts);
  scan_parts<<<1, 1024, 0, st>>>((CountLast*)parts, tiles);
  k8_emit<<<tiles, SCAN_THREADS, 0, st>>>(
      c.S, c.T, c.min_len, (const uint8_t*)inp, (const uint8_t*)start,
      (const int*)dec, (const CountLast*)parts, out, out + big,
      out + 2 * (size_t)big);
  return (int)cudaGetLastError();
}
