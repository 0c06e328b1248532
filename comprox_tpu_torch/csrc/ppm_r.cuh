// Model code of modes R, X and P shared by the search (KS, KSx), rank (K5),
// modeling (K2, K12e, K13e) and decode (K1, K12d, K13d) kernels: one set of
// __device__ functions for encode and decode, so the table evolution is the
// same on both sides (the JAX package's rule that encode and decode share
// their model read/update functions).  Mode X's parts (the distance-bucket
// row, the mantissa table, the hit-only APM) and mode P's (the hit-only APM
// keyed by the LZP candidate, the three LZP tables) are chosen by a
// template parameter.
//
// Counterpart of comprox_tpu/models/{tables,ppm}.py (the subset of modes R,
// X and P, default knobs) and of the ROLZ and LZP helpers of
// comprox_tpu/codec/block.py.  Integer
// semantics follow the JAX code exactly: int32 tables and model arithmetic
// (floor division and arithmetic shifts), uint32 rANS states and context
// registers.  No value ever goes through a floating-point unit.
//
// Execution model of the three scan kernels: one CTA per block, one thread
// per lane, the step loop inside the kernel.  Every step has read phases
// and update phases separated by __syncthreads(): each read of step t sees
// the tables after step t-1, each update of step t is computed from step
// t's reads (the semantics of one lax.scan step).  Threads past the lane
// count ("dead" lanes) join every barrier and do no lane work.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <cooperative_groups.h>

#define CPX_MAX_LANES 1024
// The fast profile's rANS decoder (K10) runs up to CPX_MAX_LPT lanes a
// thread: lanes_per_thread(S), a power of two, so S <= 8192; its encoder
// (K9) takes the same lanes, so that the card decodes what it writes.
#define CPX_MAX_LPT 8
static inline int lanes_per_thread(int S) {
  int lpt = 1;
  while (lpt < CPX_MAX_LPT && lpt * CPX_MAX_LANES < S) lpt <<= 1;
  return lpt;
}

// ---- one CTA, or one cluster of CTAs --------------------------------------
// The step scans (K2 and its X and P entries, K1, K12d/K13d; K5, KS and
// KSx take four threads a lane, rolz_search.cuh::quad_grid) run one thread
// per lane: one CTA up to CPX_MAX_LANES lanes, and above
// that one thread-block cluster of up to CPX_MAX_CLUSTER CTAs, which is
// the launch's whole grid; lane blockIdx.x * blockDim.x + threadIdx.x.
// The shared models live in CTA 0's shared memory, which the other CTAs
// reach through distributed shared memory; each CTA keeps its own lanes'
// election keys, prefix scratch and bucket-row copies, and the lane-order
// scans read every CTA's in rank order.  Barriers span the cluster.  CL
// selects the cluster form at compile time, so the one-CTA kernels are the
// ones they were.
#define CPX_MAX_CLUSTER 8

struct ScanGrid {
  int ctas, threads;
  int blocks = 1;  // the block axis: independent blocks of one launch
};

static inline ScanGrid scan_grid(int S) {
  const int ctas = (S + CPX_MAX_LANES - 1) / CPX_MAX_LANES;
  return {ctas, ((S + ctas - 1) / ctas + 31) / 32 * 32};
}

// A step scan's launch configuration on grid g: a cluster of all its CTAs
// where there are several; g.blocks such groups side by side on the grid's
// y axis, one a block (see "the block axis" below).
static inline cudaLaunchConfig_t scan_config(ScanGrid g, size_t smem, void* stream,
                                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.ctas, g.blocks);
  cfg.blockDim = dim3(g.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.ctas > 1 ? 1 : 0;
  return cfg;
}

// Launch a step scan on grid g.
template <typename... P, typename... A>
static int launch_scan(void (*kernel)(P...), ScanGrid g, size_t smem,
                       void* stream, A... args) {
  if (g.ctas < 1 || g.ctas > CPX_MAX_CLUSTER || g.blocks < 1 || g.blocks > 65535)
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = scan_config(g, smem, stream, attr);
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The clusters (groups of g.ctas CTAs; one CTA where g.ctas is 1) of this
// kernel on grid g that the card holds at once: blocks past that number
// wait for a free slot.
template <typename... P>
static int scan_max_clusters(void (*kernel)(P...), ScanGrid g, size_t smem, int* clusters) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = scan_config(g, smem, nullptr, attr);
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (void*)kernel, &cfg);
}

// This thread's index and the thread count over its block's CTAs (the
// cluster).
static __device__ __forceinline__ int gtid() { return blockIdx.x * blockDim.x + threadIdx.x; }
static __device__ __forceinline__ int gthreads() { return gridDim.x * blockDim.x; }

// ---- the block axis --------------------------------------------------------
// A launch may code G independent blocks (the JAX package's vmap over
// blocks, comprox_tpu/parallel/mesh.py::_encode_blocks_vmap and
// _decode_blocks_vmap): block b is blockIdx.y.  A step scan's grid is
// (ctas, G) with clusters of (ctas, 1, 1), so blockIdx.x is still the CTA's
// rank in its block's cluster, and nothing is shared between blocks.  Each
// kernel rebases its per-block pointers once, at entry, by b times the
// block's stride, in 64 bits (a crx block's ev grid alone is 126 Mi ints),
// and takes the block's own n from bn[b]; bn is null for one block, whose
// n is the cfg's.
static __device__ __forceinline__ long long blk() { return (long long)blockIdx.y; }

template <typename T>
static __device__ __forceinline__ T* at_blk(T* p, long long stride) {
  return p == nullptr ? p : p + blk() * stride;
}

template <bool CL>
static __device__ __forceinline__ void group_sync() {
  if (CL) cooperative_groups::this_cluster().sync();
  else __syncthreads();
}

// ---- phase stamps of an instrumented build --------------------------------
// The SM clock, read where the code puts it: a volatile read with a memory
// clobber, which the compiler keeps on its side of every barrier (a plain
// clock64() may be hoisted above the barrier it follows, and the wait is
// then charged to the next phase).
static __device__ __forceinline__ long long prof_clock() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// A step scan built with its -DCPX_<K>_PROF (K5, K2; K1 has its own
// K1_STAMP) stamps prof_clock() at the end of each of its N phases on two
// observers, thread 0 of CTA 0 and the launch's last thread (in a cluster,
// the CTA that reads the most other CTAs' keys), and sums each phase's
// cycles over the steps in its CTA's shared memory: sums[obs * N + k].
// flush adds them to a __device__ array of 2 * N counters that the
// kernel's prof_read entry copies out (benchmarks/phases.py).  The main
// path's build has no stamps.
template <int N>
struct PhaseClock {
  unsigned long long* sums;  // shared [2 * N]
  long long stamp;
  int obs;  // 0, 1, or -1 on every other thread

  __device__ void start(unsigned long long* shared_sums) {
    sums = shared_sums;
    obs = blockIdx.y != 0                                                   ? -1
          : blockIdx.x == 0 && threadIdx.x == 0                             ? 0
          : blockIdx.x == gridDim.x - 1 && threadIdx.x == blockDim.x - 1 ? 1
                                                                           : -1;
    if (obs >= 0)
      for (int k = 0; k < N; ++k) sums[obs * N + k] = 0;
    stamp = prof_clock();
  }
  __device__ __forceinline__ void mark(int k) {
    if (obs < 0) return;
    const long long now = prof_clock();
    sums[obs * N + k] += (unsigned long long)(now - stamp);
    stamp = now;
  }
  __device__ void flush(unsigned long long* dst) {
    if (obs >= 0)
      for (int k = 0; k < N; ++k) atomicAdd(&dst[obs * N + k], sums[obs * N + k]);
  }
};

// Beside a PhaseClock, the slowest thread of CTA 0 in each phase between
// two barriers: every thread times its own phases (mark), publishes them
// before the closing barrier (a shared maximum per phase, this step's),
// and after it thread 0 adds the maxima to the sums and clears them.
template <int N>
struct SlowestClock {
  unsigned long long* sums;  // shared [N]: the sums over the steps
  unsigned* step_max;        // shared [N]: this step's maxima
  long long stamp;
  unsigned dur[N];

  __device__ void start(unsigned long long* shared_sums, unsigned* shared_max) {
    sums = shared_sums;
    step_max = shared_max;
    if (threadIdx.x == 0)
      for (int k = 0; k < N; ++k) sums[k] = step_max[k] = 0;
    for (int k = 0; k < N; ++k) dur[k] = 0;
    stamp = prof_clock();
  }
  __device__ __forceinline__ void mark(int k) {
    const long long now = prof_clock();
    dur[k] = (unsigned)(now - stamp);
    stamp = now;
  }
  __device__ void publish(int lo, int hi) {  // before the barrier
    if (blockIdx.x == 0 && blockIdx.y == 0)
      for (int k = lo; k <= hi; ++k) atomicMax(&step_max[k], dur[k]);
  }
  __device__ void collect(int lo, int hi) {  // after it
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
      for (int k = lo; k <= hi; ++k) {
        sums[k] += step_max[k];
        step_max[k] = 0;
      }
  }
  __device__ void flush(unsigned long long* dst) {
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
      for (int k = 0; k < N; ++k) atomicAdd(&dst[k], sums[k]);
  }
};

// Copy an instrumented kernel's phase sums (the __device__ array sym of
// `bytes`, at most 64 counters) out, then set them to 0.
static inline int prof_read(void* out, const void* sym, size_t bytes) {
  static const unsigned long long zero[64] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, sym, bytes);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(sym, zero, bytes);
  return (int)e;
}

// A barrier in two halves: arrive, then, after work that needs no other
// thread's, wait.  In a cluster, barrier.cluster's arrive, relaxed (no
// write before it has to be seen after it, only the reads before it must
// be done), and wait; in one CTA the wait is the whole barrier.
template <bool CL>
static __device__ __forceinline__ void group_arrive() {
  if (CL) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

template <bool CL>
static __device__ __forceinline__ void group_wait() {
  if (CL) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  else __syncthreads();
}

// The same shared-memory variable in CTA r of the cluster.
template <bool CL, typename T>
static __device__ __forceinline__ T* at_rank(T* p, int r) {
  return CL ? cooperative_groups::this_cluster().map_shared_rank(p, (unsigned)r) : p;
}
#define CPX_MAX_DEPTH 80  // rolz_depth <= IDX_W
#define O2_W 260
#define SYM_HIT 256
#define SYM_ESC 257
#define SYM_MATCH 258
#define SYM_HIT2 259
#define O1_N 256
#define LEN_W 256
#define IDX_W 80
#define N_SHARED_CTX 4
#define SSE_NCTX 20
#define SSE_HCTX 6
#define SSE_K (SSE_NCTX * 33)
#define SSE_HK (SSE_HCTX * 33)
#define SSE_XCTX 48
#define SSE_XK (SSE_XCTX * 33)
#define SSE_PCTX 24
#define SSE_PK (SSE_PCTX * 33)
#define LZP4_BITS 20  // mode P: slots of the table keyed by the last 4 bytes
#define LZP8_BITS 23  // and by the last 8
// The block mode a kernel is built for (template parameter MODE).
#define MODE_R 0
#define MODE_X 1
#define MODE_P 2
#define DST_W 32
#define SYM_DST_REPEAT 24  // slot-B symbol "the previous distance again"
#define MANT_N 16          // mantissa table: MANT_N rows of MANT_N counts
#define SSE_LO 16
#define SSE_HI 65520
#define SSE_RATE_SH 5
#define M_BITS 15
#define RANS_M (1u << M_BITS)
#define RANS_L (1u << 16)

// Block geometry and model knobs, filled from a host int32 array in field
// order (comprox_tpu_torch/codec/block.py::_cfg_array builds it).  From
// n_cands to p_rep: encoder-only knobs of the flexible parse: proposals per
// position, chain depth backward, word-extension bytes, the parse prices
// (literal, match, per recency bucket in mode R or per distance bucket in
// modes F and X), whether a diagonal run counts the matching byte at its
// end, the chain depth forward, and mode X's repeat-distance price.  Then
// mode X's model knobs.
struct Cfg {
  int S, T, n, min_len, window, o3_bits, rolz_bits, rolz_depth,
      rolz_ctx_bytes, rolz_dec, top_k, probe, match, use_sse, inc2, cap2,
      inc1, cap1, len_inc, len_cap, idx_inc, idx_cap, stream_len,
      n_cands, r_probe, sort_ext, p_lit, p_rm, p_ri, diag_tail, fwd_chain,
      p_rep, dst_inc, dst_cap, mant_inc, mant_cap;
};

// Block b's n (the block axis; bn null: the cfg's).
static __device__ __forceinline__ void blk_n(Cfg& c, const int* bn) {
  if (bn != nullptr) c.n = bn[blockIdx.y];
}

static __constant__ int kSseThr[33] = {
    22,    36,    60,    98,    162,   267,   439,   720,   1179,
    1921,  3108,  4971,  7812,  11955, 17625, 24743, 32768, 40793,
    47911, 53581, 57724, 60565, 62428, 63615, 64357, 64816, 65097,
    65269, 65374, 65438, 65476, 65500, 65514};

static __device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

static __device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// a / b for a >= 0, b > 0 (where floordiv's sign fix-up cannot apply): the
// unsigned division, fewer instructions than the signed one.
static __device__ __forceinline__ int udiv(int a, int b) {
  return (int)((unsigned)a / (unsigned)b);
}

// ---------------------------------------------------------------- rANS ----
static __device__ __forceinline__ void norm_cf(int cum, int frq, int tot,
                                        uint32_t& c, uint32_t& f) {
  uint32_t uc = (uint32_t)cum, uf = (uint32_t)frq, ut = (uint32_t)tot;
  uint32_t c1 = (uc << M_BITS) / ut;
  uint32_t c2 = ((uc + uf) << M_BITS) / ut;
  c = c1;
  f = c2 - c1;
}

static __device__ __forceinline__ uint32_t dec_target(uint32_t x, int tot) {
  uint32_t slot = x & (RANS_M - 1), ut = (uint32_t)tot;
  return (slot * ut + ut - 1u) >> M_BITS;
}

static __device__ __forceinline__ uint32_t dec_advance(uint32_t x, uint32_t c,
                                                uint32_t f) {
  return f * (x >> M_BITS) + (x & (RANS_M - 1)) - c;
}

// ---------------------------------------------------------- ROLZ helpers --
static __device__ __forceinline__ uint32_t rolz_hash3(uint32_t key, int bits) {
  uint32_t v = key * 2654435761u;
  return (v >> (32 - bits)) & ((1u << bits) - 1u);
}

static __device__ __forceinline__ uint32_t rolz_key(uint32_t ctx4, int ctx_bytes) {
  return ctx_bytes == 3 ? (ctx4 & 0xFFFFFFu) : ctx4;
}

static __device__ __forceinline__ uint32_t byteswap32(uint32_t v) {
  return ((v & 0xFFu) << 24) | ((v & 0xFF00u) << 8) | ((v >> 8) & 0xFF00u) |
         (v >> 24);
}

static __device__ __forceinline__ int rec_bucket(int idx) {
  return (idx >= 1) + (idx >= 4) + (idx >= 16);
}

// floor(log2(dist)) for dist >= 1, at most 24 (block.py::_dist_bucket).
static __device__ __forceinline__ int dist_bucket(int dist) {
  return min(31 - __clz(max(dist, 1)), 24);
}

static __device__ __forceinline__ int fill_bucket(int fill) {
  return clampi(floordiv(fill - 1, 16), 0, 3);
}

// (pos, slot) order: entry a is newer than entry b.  Positions strictly
// increase with time; equal positions (empties) order by slot id.
static __device__ __forceinline__ bool newer(int pa, int sa, int pb, int sb) {
  return pa > pb || (pa == pb && sa > sb);
}

// Recency rank of slot s: how many entries of the row are newer.
static __device__ __forceinline__ int recency_rank(const int* pos, int d, int s) {
  int r = 0, ps = pos[s];
  for (int j = 0; j < d; ++j) r += newer(pos[j], j, ps, s);
  return r;
}

// The k-th slot in newest-first (or oldest-first) order: k + 1 passes of
// selecting the next entry after the last pick.
static __device__ int select_kth(const int* pos, int d, int k, bool newest_first) {
  int ps = 0, ss = -1;
  for (int pass = 0; pass <= k; ++pass) {
    int bp = 0, bs = -1;
    for (int j = 0; j < d; ++j) {
      int pj = pos[j];
      if (ss >= 0 && (newest_first ? !newer(ps, ss, pj, j)
                                   : !newer(pj, j, ps, ss)))
        continue;  // picked already
      if (bs < 0 || (newest_first ? newer(pj, j, bp, bs) : newer(bp, bs, pj, j))) {
        bp = pj;
        bs = j;
      }
    }
    ps = bp;
    ss = bs;
  }
  return ss;
}

// The slot whose recency rank is r (r-th newest), or -1 if r is outside
// [0, d).  Rank and age (d-1-rank) index one total order from its two
// ends: select from the nearer end.
static __device__ int slot_of_rank(const int* pos, int d, int r) {
  if (r < 0 || r >= d) return -1;
  return 2 * r < d ? select_kth(pos, d, r, true)
                   : select_kth(pos, d, d - 1 - r, false);
}

// ------------------------------------------------------------ o2 / SSE ----
static __device__ __forceinline__ int halve1(int x, bool sticky) {
  x = max(x, 0);
  return sticky ? (x + 1) >> 1 : x >> 1;
}

static __device__ __forceinline__ bool o2_sticky(int k) { return k >= SYM_HIT; }

// x after h (0..3) read-time halving rounds.  Written as three guarded
// steps: nvcc 12.8 did not finish compiling the loop form `for (j < h)`
// once inlined into the SSE read.
static __device__ __forceinline__ int halve_n(int x, int h, bool sticky) {
  if (h > 0) x = halve1(x, sticky);
  if (h > 1) x = halve1(x, sticky);
  if (h > 2) x = halve1(x, sticky);
  return x;
}

// Sum of row(k) for k < n.
template <typename RowFn>
static __device__ int sum_prefix(RowFn row, int n) {
  int s = 0;
  for (int k = 0; k < n; ++k) s += row(k);
  return s;
}

struct ApmPt {
  int flat, w, ti, tip1;
};

// The APM thresholds, read from constant memory (where the index is the
// same on the warp's threads: one broadcast) or from a copy in shared
// memory (where each thread reads its own).
struct ThrConst {
  static constexpr bool kLut = false;
  __device__ __forceinline__ int operator()(int i) const { return kSseThr[i]; }
};
struct ThrShared {
  static constexpr bool kLut = false;
  const int* p;
  __device__ __forceinline__ int operator()(int i) const { return p[i]; }
};
// Or the APM's bucket and weight of every p16 the reads pass (a 12-bit
// probability << 4) at once: a table of APM_LUT_N entries (i << 8 | w) in
// shared memory, filled by apm_lut_fill from the thresholds.
#define APM_LUT_N 4096
struct ThrLut {
  static constexpr bool kLut = true;
  const int* p;
};

// The bucket i (how many of kSseThr[1..31] are <= p16; they increase) and
// the weight w of p16 within it.
template <typename Thr>
static __device__ __forceinline__ void apm_bucket(int p16, Thr thr, int& i, int& w) {
  i = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (i + step <= 31 && p16 >= thr(i + step)) i += step;
  int thr_i = thr(i);
  int span_i = max(thr(i + 1) - thr_i, 1);
  // floordiv((p16 - thr_i) * 64, span_i) clipped to [0, 64]: a negative
  // quotient clips to 0 either way
  w = p16 < thr_i ? 0 : min(udiv((p16 - thr_i) * 64, span_i), 64);
}

// Fill a ThrLut's table (the CTA's threads; a barrier before its use).
static __device__ void apm_lut_fill(int* lut) {
  for (int p12 = threadIdx.x; p12 < APM_LUT_N; p12 += blockDim.x) {
    int i, w;
    apm_bucket(p12 << 4, ThrConst{}, i, w);
    lut[p12] = (i << 8) | w;
  }
}

template <typename Thr = ThrConst>
static __device__ int apm_read(const int* tab, int k, int ctx, int p16, ApmPt& st,
                               Thr thr = Thr{}) {
  int i;
  if constexpr (Thr::kLut) {
    const int e = thr.p[p16 >> 4];  // every p16 passed is a multiple of 16
    i = e >> 8;
    st.w = e & 0xFF;
  } else {
    apm_bucket(p16, thr, i, st.w);
  }
  st.flat = ctx * 33 + i;
  st.ti = (st.flat >= 0 && st.flat < k) ? tab[st.flat] : 0;
  st.tip1 = (st.flat + 1 >= 0 && st.flat + 1 < k) ? tab[st.flat + 1] : 0;
  return ((64 - st.w) * st.ti + st.w * st.tip1) >> 6;
}

static __device__ void apm_add(int* tab, int k, const ApmPt& st, bool outcome) {
  int h = outcome ? (1 << 16) : 0;
  int d_i = ((64 - st.w) * (h - st.ti)) >> (6 + SSE_RATE_SH);
  int d_ip1 = (st.w * (h - st.tip1)) >> (6 + SSE_RATE_SH);
  if (st.flat >= 0 && st.flat < k) atomicAdd(&tab[st.flat], d_i);
  if (st.flat + 1 >= 0 && st.flat + 1 < k) atomicAdd(&tab[st.flat + 1], d_ip1);
}

struct SseState {
  ApmPt m, h;
  bool act_h;
};

// The hit APM alone (ppm._hit_reshape; table tab of k entries, context
// hctx): rewrites the HIT frequency, returns the new sum.
template <typename Thr = ThrConst>
static __device__ int hit_reshape(int& f_hit, int tot, const int* tab, int k,
                                  int hctx, int conf, SseState& st, Thr thr = Thr{}) {
  // the HIT slot and the rest of the total are never negative: plain
  // quotients are the JAX floor divisions
  int f_h0 = f_hit;
  int tot_h = max(tot, 1);
  int p16h = clampi(udiv(f_h0 * 4096, tot_h), 1, 4095) << 4;
  int ph = apm_read(tab, k, hctx, p16h, st.h, thr);
  int ph12 = clampi(ph >> 4, 1, 4095);
  int f_h_new = udiv(ph12 * (tot_h - f_h0), 4096 - ph12);
  f_h_new = min(max(f_h_new, 1), f_h0 + max(32768 - tot_h, 0));
  st.act_h = conf > 0;
  f_hit = st.act_h ? f_h_new : f_h0;
  return tot - f_h0 + f_hit;
}

// Mode X's hit APM context: conf class x order-1 byte class.
static __device__ __forceinline__ int sse_x_ctx(int conf, int p1) {
  return (clampi(conf, 1, 3) - 1) * 16 + clampi(p1, 0, 255) / 16;
}

// Mode P's: conf class x "the lane has an LZP candidate" x order-1 byte class.
static __device__ __forceinline__ int sse_p_ctx(int conf, bool avail, int p1) {
  return ((clampi(conf, 1, 3) - 1) * 2 + (avail ? 1 : 0)) * 4 + clampi(p1, 0, 255) / 64;
}

// Entries of the hit-only APM of a mode that has one.
#define HIT_APM_K(MODE) ((MODE) == MODE_X ? SSE_XK : SSE_PK)

// The SSE stage on the A distribution (hit APM, then match APM): rewrites
// the HIT and MATCH frequencies of a rowmod whose sum is tot; returns the
// new sum.
template <typename Thr = ThrConst>
static __device__ int sse_reshape(int& f_hit, int& f_match, int f_hit2, int tot,
                                  const int* sse, const int* sse_h, int fill,
                                  int conf, SseState& st, Thr thr = Thr{}) {
  int hctx = (clampi(conf, 1, 3) - 1) * 2 + (fill > 0 ? 1 : 0);
  int tot0 = hit_reshape(f_hit, tot, sse_h, SSE_HK, hctx, conf, st, thr);
  int fh = f_hit;

  int f_m = f_match;
  int rest = max(tot0 - fh - f_hit2, 1);
  int p16 = clampi(floordiv(f_m * 4096, rest), 1, 4095) << 4;
  int fillc = fill > 0 ? 1 + clampi(floordiv(fill - 1, 16), 0, 3) : 0;
  int mctx = fillc * 4 + clampi(conf, 0, 3);
  int ps = apm_read(sse, SSE_K, mctx, p16, st.m, thr);
  int ps12 = clampi(ps >> 4, 1, 4095);
  int f_new = floordiv(ps12 * (rest - f_m), 4096 - ps12);
  f_new = min(max(f_new, 1), f_m + max(32768 - tot0, 0));
  f_match = f_new;
  return tot0 - f_m + f_new;
}

// v[m] for an m < N, without indexing a register array.
template <int N>
static __device__ __forceinline__ int pick(const int (&v)[N], int m) {
  int r = 0;
#pragma unroll
  for (int u = 0; u < N; ++u) r = u == m ? v[u] : r;
  return r;
}

// The A and B events code two lanes at a time, one a half-warp: a
// half-warp holds a row's byte slots 0..255 as w[j] = slot 16 * hl + j
// (hl: the thread in its half), sixteen consecutive slots a thread (four
// 16-byte shared-memory loads), so that a row's prefix sums take one
// 16-wide scan of the threads' totals.  Every shuffle and reduction below
// is executed by the whole warp (the halves' values differ, their code
// path does not).
#define HALF 16
#define SLOTS_T 16

// This thread's sixteen slots of its half's row in shared memory.
static __device__ __forceinline__ void load16(const int* row, int (&v)[SLOTS_T]) {
  const int4* r4 = reinterpret_cast<const int4*>(row) + 4 * (threadIdx.x & (HALF - 1));
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 a = r4[q];
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

// The sum of v over this thread's half-warp.
static __device__ __forceinline__ int half_sum(int v) {
  const unsigned full = 0xffffffffu;
  const bool hi = threadIdx.x & HALF;
  const int lo_s = __reduce_add_sync(full, hi ? 0 : v);
  const int hi_s = __reduce_add_sync(full, hi ? v : 0);
  return hi ? hi_s : lo_s;
}

// Exclusive prefix of the slots before this thread's sixteen (base) and
// the total of the half's 256, from the sum of this thread's (mine).
static __device__ __forceinline__ int scan16_sum(int mine, int& total) {
  const unsigned full = 0xffffffffu;
  const int hl = threadIdx.x & (HALF - 1);
  int incl = mine;
#pragma unroll
  for (int off = 1; off < HALF; off <<= 1) {
    const int y = __shfl_up_sync(full, incl, off, HALF);
    if (hl >= off) incl += y;
  }
  total = __shfl_sync(full, incl, HALF - 1, HALF);
  return incl - mine;
}

// How many of the half's 256 byte slots' exclusive cumulative counts are
// <= tgt (the JAX find_symbol's count: zero or negative slots make it
// differ from a search for the first prefix above tgt).  base from
// scan16_sum.
static __device__ __forceinline__ int count_le16(const int (&w)[SLOTS_T], int base, int tgt) {
  int c = base, cnt = 0;
#pragma unroll
  for (int j = 0; j < SLOTS_T; ++j) {
    cnt += c <= tgt;
    c += w[j];
  }
  return half_sum(cnt);
}

// (cum, freq) of the half's byte slot sym (0..255).  base from scan16_sum.
static __device__ __forceinline__ void cum_frq16(const int (&w)[SLOTS_T], int base, int sym,
                                                 int& c, int& f) {
  const unsigned full = 0xffffffffu;
  const int j0 = sym & (SLOTS_T - 1);
  const int owner = (threadIdx.x & HALF) + sym / SLOTS_T;
  int part = base;
#pragma unroll
  for (int j = 0; j < SLOTS_T; ++j) part += j < j0 ? w[j] : 0;
  c = __shfl_sync(full, part, owner);
  f = __shfl_sync(full, pick(w, j0), owner);
}

// ---- rows in flight: a per-warp ring of shared-memory slots -------------
// The A event reads an o2 row (1040 B) and the B event an o1 row (1024 B)
// for each lane that codes one; a warp walks its lanes two at a time, a
// half-warp a row.  Issued one after another those reads cost a round
// trip each (~0.44-0.7 us on the H100; the tables are larger than its 50
// MB L2).  So the rows go through a ring of CPX_RING_D slots a warp in
// dynamic shared memory, filled by cp.async (16 bytes a thread and copy,
// the whole warp a row, coalesced): ring_start puts the rows of the first
// CPX_RING_D lanes in flight as soon as the caller knows the lanes and
// their rows; ring_take waits for the rows of lanes k and k+1 while the
// rows of the next CPX_RING_D - 2 lanes stay in flight; ring_release
// re-arms the two slots with the rows CPX_RING_D lanes ahead once every
// thread of the warp has read them.  One commit group a row (an empty one
// where no lane is left), so wait_group CPX_RING_D - 2 always means "rows
// k and k+1 landed".  At depth 0 the rows are issued when they are taken
// (one round trip a pair of rows).
#ifndef CPX_RING_D
#define CPX_RING_D 4
#endif
#if CPX_RING_D % 2
#error "CPX_RING_D must be even: the events take two rows at a time"
#endif
#define RING_SLOTS (CPX_RING_D > 0 ? CPX_RING_D : 2)
#define RING_SLOT_INTS O2_W  // the wider of the two rows, 16-byte aligned

// Dynamic shared memory of the rings of a CTA of `threads` threads.
static __host__ __device__ __forceinline__ size_t ring_bytes(int threads) {
  return (size_t)(threads / 32) * RING_SLOTS * RING_SLOT_INTS * sizeof(int);
}

struct RowRing {
  int* slots;      // this warp's RING_SLOTS slots
  const int* tab;  // rows of `width` ints (a multiple of 4, 16-byte aligned)
  int width;
  unsigned issue;  // the lanes whose row is not yet issued (warp-uniform)
  int issued, taken;
};

// Issue the row (its index row_of on each lane) of the next lane not yet
// issued into slot `issued` mod SLOTS (the ring's rows); commit a group
// either way.
template <int SLOTS = RING_SLOTS>
static __device__ __forceinline__ void ring_next(RowRing& r, int row_of) {
  const unsigned full = 0xffffffffu;
  if (r.issue) {
    const int l = __ffs(r.issue) - 1;
    r.issue &= r.issue - 1;
    const int* row = r.tab + (size_t)__shfl_sync(full, row_of, l) * r.width;
    int* slot = r.slots + (r.issued % SLOTS) * RING_SLOT_INTS;
    for (int c = threadIdx.x & 31; c < r.width / 4; c += 32) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(slot + 4 * c);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(row + 4 * c)
                   : "memory");
    }
  }
  ++r.issued;
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The warp's ring over table tab for its lanes with want set (row row_of
// of tab each), the first CPX_RING_D rows in flight.  dyn: the CTA's
// rings (ring_bytes; warp_slots a warp, more than RING_SLOTS where a
// deeper ring shares the warp's region: ring4_start).  Call with the warp
// converged, after the warp's previous ring has been taken whole.
static __device__ RowRing ring_start(int* dyn, const int* tab, int width, bool want,
                                     int row_of, int warp_slots = RING_SLOTS) {
  RowRing r{dyn + (threadIdx.x >> 5) * warp_slots * RING_SLOT_INTS, tab, width,
            __ballot_sync(0xffffffffu, want), 0, 0};
#pragma unroll
  for (int k = 0; k < CPX_RING_D; ++k) ring_next(r, row_of);
  return r;
}

// The next two lanes' rows (lanes in ascending order; the second is an
// empty group where there is none), landed and visible to the whole warp:
// the first's slot, the second's right after it.
static __device__ __forceinline__ int* ring_take(RowRing& r, int row_of) {
  if (CPX_RING_D == 0) {
    ring_next(r, row_of);
    ring_next(r, row_of);
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(CPX_RING_D > 0 ? CPX_RING_D - 2 : 0)
               : "memory");
  __syncwarp();
  return r.slots + (r.taken % RING_SLOTS) * RING_SLOT_INTS;
}

// After every thread has read the rows ring_take gave: re-arm their slots.
static __device__ __forceinline__ void ring_release(RowRing& r, int row_of) {
  __syncwarp();
  r.taken += 2;
  if (CPX_RING_D > 0) {
    ring_next(r, row_of);
    ring_next(r, row_of);
  }
}

// The A event of one lane: its distribution's total, the halving rounds
// of its o2 row (for the winner's table write), the coded symbol with its
// raw (cum, freq), the byte's frequency (encode) and the SSE state; for an
// escape, the o1 exclusion the B event reads off the same row: bit j of
// ex[m] set where slot 32*m + j is still present after the h halvings.
struct AEvent {
  int tot, h, sym, c, f, fbyte;
  SseState sse;
  unsigned ex[O1_N / 32];
  int sp[4], bytes_tot;  // encode: HIT, ESC, MATCH, HIT2 and the byte slots' sum before SSE
};

// Encode's SSE stage, each coded lane its own after the A event's rounds:
// HIT and MATCH reshaped, the total, and a special symbol's (cum, freq)
// from them (mine.bytes_tot and mine.sp from the rounds).
template <int MODE>
static __device__ __forceinline__ void enc_sse_stage(const Cfg& cfg, AEvent& mine, int fill,
                                                     int conf, const int* sse,
                                                     const int* sse_h, const int* sse_thr) {
  const ThrShared thr{sse_thr};
  int hit = mine.sp[0], match = mine.sp[2];
  if (MODE != MODE_R) {
    if (cfg.use_sse)
      mine.tot = hit_reshape(hit, mine.tot, sse_h, HIT_APM_K(MODE), fill, conf, mine.sse, thr);
  } else if (cfg.use_sse) {
    mine.tot = sse_reshape(hit, match, mine.sp[3], mine.tot, sse, sse_h, fill, conf,
                           mine.sse, thr);
  }
  if (mine.sym >= O1_N) {
    const int spw[4] = {hit, mine.sp[1], match, mine.sp[3]};
    int cum = mine.bytes_tot, frq = spw[0];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cum += q < mine.sym - SYM_HIT ? spw[q] : 0;
      frq = q == mine.sym - SYM_HIT ? spw[q] : frq;
    }
    mine.c = cum;
    mine.f = frq;
  }
}

// The A event of every lane of the warp with want set (ppm.read_o2 with
// the SSE stage, then decode's slot search or encode's lookup of the known
// symbol), two lanes at a time, each coded by a half-warp from its o2 row
// in the ring (ring_start over o2 with the same want and ctx2): the row
// sums and cumulative counts by half-warp reductions and scans.  Decode
// (DECODE) finds count(cums <= target) - 1, clipped, for the lane's rANS
// state x; encode takes the symbol from the lane's byte and match flag
// (the JAX rule of block.py::_encode_model_body).  Modes X and P have the
// hit APM only: its table is passed as sse_h and its context (sse_x_ctx,
// sse_p_ctx) as fill.  Encode knows its symbol before the SSE stage, which
// only reshapes HIT and MATCH and the total: the pairs' rounds skip it, and
// each coded lane runs it once for itself after the rounds (every lane of
// the warp at once, the thresholds from the shared copy sse_thr), where
// decode, which needs the reshaped total to find its symbol, runs it in
// each round (modes X and P: its bucket and weight from the table
// apm_lut, which decode in those modes must pass).  The rounds are bound by the
// instructions they issue (one CTA, four warps a scheduler), so each
// slot passes through as few as it can: the predicted byte's slot is
// zeroed in the ring's copy, the halving passes run only where a row
// halves, and decode counts and finds its symbol's cum and freq in one
// pass.  Call with the warp converged.
template <bool DECODE, int MODE = MODE_R>
static __device__ AEvent warp_a_event(const Cfg& cfg, RowRing& ring, bool want,
                                      int ctx2, int pred, int conf, int fill,
                                      const int* sse, const int* sse_h, uint32_t x,
                                      int byte, bool is_match,
                                      const int* sse_thr = nullptr,
                                      const int* apm_lut = nullptr) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, hl = lane & (HALF - 1), half = lane & HALF;
  AEvent mine{};
  unsigned todo = __ballot_sync(full, want);
  while (todo) {
    // lanes l0 and l1 (if any) in ascending order, one a half-warp; the
    // upper half repeats the lower's lane where there is no second
    const int l0 = __ffs(todo) - 1;
    todo &= todo - 1;
    const int l1 = todo ? __ffs(todo) - 1 : -1;
    todo &= todo - 1;
    const bool two = l1 >= 0, upper = half && two;
    const int src = upper ? l1 : l0;
    const int pr = __shfl_sync(full, pred, src);
    int* row = ring_take(ring, ctx2) + (upper ? RING_SLOT_INTS : 0);
    // slots 256..259 (HIT, ESC, MATCH, HIT2) and the predicted byte's, by
    // broadcast loads; then the predicted byte's slot is zeroed in the
    // ring's copy of the row, so that the byte slots the thread loads are
    // the distribution's (ppm.read_o2's rowmod) with no select a slot
    const int4 sp = reinterpret_cast<const int4*>(row)[O1_N / 4];
    const int praw = row[pr];
    __syncwarp();
    if (hl == 0) row[pr] = 0;
    __syncwarp();
    int v[SLOTS_T];
    load16(row, v);
    ring_release(ring, ctx2);
    // the row sum (the byte slots over the half, the predicted byte's and
    // the sticky slots on every thread); a round halves while the sum is
    // over the cap, at most three rounds.  Halving is rare: the sums after
    // 1-3 rounds are formed, and the slots halved, only where one of the
    // warp's two rows is over the cap.
    int tsum = 0;
#pragma unroll
    for (int j = 0; j < SLOTS_T; ++j) tsum += v[j];
    const int s0 = half_sum(tsum) + praw + sp.x + sp.y + sp.z + sp.w;
    int h = 0, sum = s0;
    const bool halving = __any_sync(full, s0 > cfg.cap2);
    if (halving) {
      int s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
      for (int j = 0; j < SLOTS_T; ++j) {
        int y = halve1(v[j], false);
        s1 += y;
        y = halve1(y, false);
        s2 += y;
        s3 += halve1(y, false);
      }
      s1 = half_sum(s1);
      s2 = half_sum(s2);
      s3 = half_sum(s3);
      const int spv[5] = {sp.x, sp.y, sp.z, sp.w, praw};
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        int y = halve1(spv[q], q < 4);
        s1 += y;
        y = halve1(y, q < 4);
        s2 += y;
        s3 += halve1(y, q < 4);
      }
      if (sum > cfg.cap2) { h = 1; sum = s1; }
      if (h == 1 && sum > cfg.cap2) { h = 2; sum = s2; }
      if (h == 2 && sum > cfg.cap2) { h = 3; sum = s3; }
      tsum = 0;
#pragma unroll
      for (int j = 0; j < SLOTS_T; ++j) {
        v[j] = halve_n(v[j], h, false);
        tsum += v[j];
      }
    }
    // HIT, ESC, MATCH, HIT2 and the predicted byte's slot after h rounds
    int hit = sp.x, esc0 = sp.y, match = sp.z, hit2 = sp.w, prh = praw;
    if (halving) {
      hit = halve_n(hit, h, true);
      esc0 = halve_n(esc0, h, true);
      match = halve_n(match, h, true);
      hit2 = halve_n(hit2, h, true);
      prh = halve_n(prh, h, false);
    }
    const int esc = max(esc0, 1);
    const bool pred_in = prh > 0;
    sum += esc - esc0 - prh;
    SseState st{};
    if (!DECODE) {
      // encode: the SSE stage after the rounds
    } else if (MODE != MODE_R) {
      if (cfg.use_sse) {
        const int hctx = __shfl_sync(full, fill, src), cf = __shfl_sync(full, conf, src);
        sum = hit_reshape(hit, sum, sse_h, HIT_APM_K(MODE), hctx, cf, st, ThrLut{apm_lut});
      }
    } else if (cfg.use_sse)
      sum = sse_reshape(hit, match, hit2, sum, sse, sse_h, __shfl_sync(full, fill, src),
                        __shfl_sync(full, conf, src), st);
    // the distribution (ppm.read_o2's rowmod) is now v: the byte slots, h
    // halving rounds and the predicted byte's slot zeroed, then HIT, ESC,
    // MATCH, HIT2 as the read set them
    const int (&w)[SLOTS_T] = v;
    int bytes_tot;
    const int base = scan16_sum(tsum, bytes_tot);
    const int spw[4] = {hit, esc, match, hit2};
    int sym, fbyte = 0, cum, frq;
    if (DECODE) {
      // count(cums <= tgt), and the (cum, freq) of the last slot counted:
      // the byte slots are never negative, so the counted slots are a
      // prefix of the row and the symbol is the last of them
      const int tgt = (int)dec_target(__shfl_sync(full, x, src), max(sum, 1));
      int cnt = 0, c = base, clast = 0, flast = 0;
#pragma unroll
      for (int j = 0; j < SLOTS_T; ++j) {
        const bool le = c <= tgt;
        cnt += le;
        clast = le ? c : clast;
        flast = le ? w[j] : flast;
        c += w[j];
      }
      cnt = half_sum(cnt);
      c = bytes_tot;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        cnt += c <= tgt;
        c += spw[q];
      }
      sym = clampi(cnt - 1, 0, O2_W - 1);
      const int owner = half + min(sym, O1_N - 1) / SLOTS_T;
      cum = __shfl_sync(full, clast, owner);
      frq = __shfl_sync(full, flast, owner);
    } else {
      const int bt = __shfl_sync(full, byte, src);
      fbyte = __shfl_sync(full, pick(w, bt & (SLOTS_T - 1)), half + bt / SLOTS_T);
      sym = __shfl_sync(full, (int)is_match, src) ? SYM_MATCH
            : bt == pr                             ? SYM_HIT
            : fbyte > 0                            ? bt
                                                   : SYM_ESC;
      cum_frq16(w, base, min(sym, O1_N - 1), cum, frq);
    }
    if (DECODE && sym >= O1_N) {
      cum = bytes_tot;
      frq = spw[0];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        cum += q < sym - SYM_HIT ? spw[q] : 0;
        frq = q == sym - SYM_HIT ? spw[q] : frq;
      }
    }
    // each coded lane takes its half's results
    const int from = two && lane == l1 ? HALF : 0;
    const bool coded = lane == l0 || (two && lane == l1);
    AEvent r;
    r.tot = __shfl_sync(full, sum, from);
    r.h = __shfl_sync(full, h, from);
    r.sym = __shfl_sync(full, sym, from);
    r.c = __shfl_sync(full, cum, from);
    r.f = __shfl_sync(full, frq, from);
    r.fbyte = __shfl_sync(full, fbyte, from);
    if (DECODE) {
      if (MODE == MODE_R) {  // the match APM: mode R's only
        r.sse.m.flat = __shfl_sync(full, st.m.flat, from);
        r.sse.m.w = __shfl_sync(full, st.m.w, from);
        r.sse.m.ti = __shfl_sync(full, st.m.ti, from);
        r.sse.m.tip1 = __shfl_sync(full, st.m.tip1, from);
      } else {
        r.sse.m = ApmPt{};
      }
      r.sse.h.flat = __shfl_sync(full, st.h.flat, from);
      r.sse.h.w = __shfl_sync(full, st.h.w, from);
      r.sse.h.ti = __shfl_sync(full, st.h.ti, from);
      r.sse.h.tip1 = __shfl_sync(full, st.h.tip1, from);
      r.sse.act_h = __shfl_sync(full, (int)st.act_h, from);
    } else {
      r.sp[0] = __shfl_sync(full, hit, from);
      r.sp[1] = __shfl_sync(full, esc, from);
      r.sp[2] = __shfl_sync(full, match, from);
      r.sp[3] = __shfl_sync(full, hit2, from);
      r.bytes_tot = __shfl_sync(full, bytes_tot, from);
    }
    if (coded) {
      mine.tot = r.tot;
      mine.h = r.h;
      mine.sym = r.sym;
      mine.c = r.c;
      mine.f = r.f;
      mine.fbyte = r.fbyte;
      if (DECODE) {
        mine.sse = r.sse;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) mine.sp[q] = r.sp[q];
        mine.bytes_tot = r.bytes_tot;
      }
    }
    if (__any_sync(full, sym == SYM_ESC)) {
      // the byte slots still present after h halvings, as 8 words of 32
      // (bit b of word m: slot 32 * m + b): each thread's 16 bits,
      // gathered two threads to a word
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < SLOTS_T; ++j) bits |= (unsigned)(w[j] > 0) << j;
      if (hl == pr / SLOTS_T) bits |= (unsigned)pred_in << (pr & (SLOTS_T - 1));
      unsigned word = bits << (SLOTS_T * (hl & 1));
      word |= __shfl_xor_sync(full, word, 1);
#pragma unroll
      for (int m = 0; m < O1_N / 32; ++m) {
        const unsigned e = __shfl_sync(full, word, from + 2 * m);
        if (coded) mine.ex[m] = e;
      }
    }
  }
  if (!DECODE && want) enc_sse_stage<MODE>(cfg, mine, fill, conf, sse, sse_h, sse_thr);
  return mine;
}

// ---- encode's A event, four lanes a round ---------------------------------
// Encode knows its symbol, so a round of the A event counts nothing and its
// cost is mostly fixed (the ring's take and release, the predicted slot's
// zeroing, the reductions, handing the results over); the 512-thread arm of
// the modeling scan (K2, K12e, K13e) codes four lanes a round, a quarter-warp
// of 8 threads each with 32 slots a thread, from a ring of RING4_D rows a
// warp.  Each thread keeps no slot in registers: it sums its 32 slots
// (eight 16-byte loads, rotated by its index so that the quarter's loads
// hit eight different bank groups), then the symbol's cum is the sum of
// the whole threads below the symbol's 32-slot chunk and of that chunk's
// slots below it (one 16-byte load a thread), and an escape's exclusion
// mask is each thread's 32 slots again, one word a thread.  A quarter's
// first thread writes its lane's results, and each of its threads its
// mask word, into the lane's row of the warp's result rows (ares), which
// every coded lane reads once after the rounds.  The L1 cache takes what
// shared memory leaves of the SM's 256 KB, and the scan's global reads
// lose more to a smaller L1 than the rounds gain from rows in flight, so
// the ring holds a round's four rows, and the CTA fits a 132 KB carve-out
// (PERF.md, PR 10: 5, 6 and 8 rows measured slower).  The B event's ring
// (ring_start) shares the warp's region, which holds RING4_W rows: four,
// or RING_SLOTS where a build's CPX_RING_D is deeper.  The 1024-thread and
// cluster arms keep two lanes a round (warp_a_event).
#define QUARTER 8
#define RING4_D 4           // the A event's rows a warp: the round's four
#define RING4_W (RING4_D > RING_SLOTS ? RING4_D : RING_SLOTS)
#define ARES_N 8            // a lane's results, ints; then its 8 mask words
#define ARES_S 17           // a lane's row (an odd stride: no bank conflict)

// Dynamic shared memory of the four-lane arm: the warps' rings, then their
// result rows.
static __host__ __device__ __forceinline__ size_t ring4_bytes(int threads) {
  return (size_t)(threads / 32) * (RING4_W * RING_SLOT_INTS + 32 * ARES_S) * sizeof(int);
}

// This warp's result rows, after the CTA's rings.
static __device__ __forceinline__ int* ares_of(int* dyn) {
  return dyn + (blockDim.x >> 5) * RING4_W * RING_SLOT_INTS + (threadIdx.x >> 5) * 32 * ARES_S;
}

// The warp's ring of RING4_D rows (ring_start's, four rows a take) at the
// start of its region of RING4_W rows.
static __device__ RowRing ring4_start(int* dyn, const int* tab, int width, bool want,
                                      int row_of) {
  RowRing r{dyn + (threadIdx.x >> 5) * RING4_W * RING_SLOT_INTS, tab, width,
            __ballot_sync(0xffffffffu, want), 0, 0};
#pragma unroll
  for (int k = 0; k < RING4_D; ++k) ring_next<RING4_D>(r, row_of);
  return r;
}

// The next four lanes' rows, landed (empty groups where no lane is left):
// the slot of the k-th of them.
static __device__ __forceinline__ int* ring4_take(RowRing& r, int k) {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING4_D - 4) : "memory");
  __syncwarp();
  return r.slots + ((r.taken + k) % RING4_D) * RING_SLOT_INTS;
}

static __device__ __forceinline__ void ring4_release(RowRing& r, int row_of) {
  __syncwarp();
  r.taken += 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) ring_next<RING4_D>(r, row_of);
}

// The sum of v over this thread's quarter-warp.
static __device__ __forceinline__ int quarter_sum(int v) {
  const unsigned full = 0xffffffffu;
  v += __shfl_xor_sync(full, v, 1);
  v += __shfl_xor_sync(full, v, 2);
  v += __shfl_xor_sync(full, v, 4);
  return v;
}

// warp_a_event<false, MODE> four lanes a round (ring: ring4_start over o2
// with the same want and ctx2; ares: ares_of(dyn)).  The same results.
// Call with the warp converged.
template <int MODE>
static __device__ AEvent warp_a_event4(const Cfg& cfg, RowRing& ring, int* ares, bool want,
                                       int ctx2, int pred, int conf, int fill,
                                       const int* sse, const int* sse_h, int byte,
                                       bool is_match, const int* sse_thr) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, ql = lane & (QUARTER - 1), q = lane >> 3;
  AEvent mine{};
  unsigned todo = __ballot_sync(full, want);
  while (todo) {
    // up to four lanes in ascending order, one a quarter; a quarter
    // without one repeats the first quarter's lane and row, and writes
    // nothing
    int l0 = -1, lq = -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1;
      if (k == 0) l0 = l;
      if (k == q) lq = l;
    }
    const bool real = lq >= 0;
    const int src = real ? lq : l0;
    const int pr = __shfl_sync(full, pred, src);
    int* row = ring4_take(ring, real ? q : 0);
    // HIT, ESC, MATCH, HIT2 and the predicted byte's slot; then that slot
    // is zeroed in the ring's copy (warp_a_event's rowmod)
    const int4 sp = reinterpret_cast<const int4*>(row)[O1_N / 4];
    const int praw = row[pr];
    __syncwarp();
    if (ql == 0) row[pr] = 0;
    __syncwarp();
    const int4* r4 = reinterpret_cast<const int4*>(row) + 8 * ql;  // slots 32 ql ..
    int tsum = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int4 a = r4[(k + ql) & 7];
      tsum += a.x + a.y + a.z + a.w;
    }
    const int s0 = quarter_sum(tsum) + praw + sp.x + sp.y + sp.z + sp.w;
    int h = 0, sum = s0, th = tsum;  // th: this thread's slots after h rounds
    const bool halving = __any_sync(full, s0 > cfg.cap2);
    if (halving) {
      int t1 = 0, t2 = 0, t3 = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int4 a = r4[(k + ql) & 7];
        const int v4[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int y = halve1(v4[j], false);
          t1 += y;
          y = halve1(y, false);
          t2 += y;
          t3 += halve1(y, false);
        }
      }
      int s1 = quarter_sum(t1), s2 = quarter_sum(t2), s3 = quarter_sum(t3);
      const int spv[5] = {sp.x, sp.y, sp.z, sp.w, praw};
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        int y = halve1(spv[k], k < 4);
        s1 += y;
        y = halve1(y, k < 4);
        s2 += y;
        s3 += halve1(y, k < 4);
      }
      if (sum > cfg.cap2) { h = 1; sum = s1; th = t1; }
      if (h == 1 && sum > cfg.cap2) { h = 2; sum = s2; th = t2; }
      if (h == 2 && sum > cfg.cap2) { h = 3; sum = s3; th = t3; }
    }
    int hit = sp.x, esc0 = sp.y, match = sp.z, hit2 = sp.w, prh = praw;
    if (halving) {
      hit = halve_n(hit, h, true);
      esc0 = halve_n(esc0, h, true);
      match = halve_n(match, h, true);
      hit2 = halve_n(hit2, h, true);
      prh = halve_n(prh, h, false);
    }
    const int esc = max(esc0, 1);
    sum += esc - esc0 - prh;
    // the symbol (the JAX rule of block.py::_encode_model_body) and its
    // cum: the slots below min(sym, 256), the byte slots' total for a
    // special symbol
    const int bt = __shfl_sync(full, byte, src);
    int fb = row[bt];
    if (halving) fb = halve_n(fb, h, false);
    const int sym = __shfl_sync(full, (int)is_match, src) ? SYM_MATCH
                    : bt == pr                             ? SYM_HIT
                    : fb > 0                               ? bt
                                                           : SYM_ESC;
    const int lim = min(sym, O1_N), cq = lim >> 5;
    int part = ql < cq ? th : 0;
    if (cq < O1_N / 32) {
      const int4 a = reinterpret_cast<const int4*>(row)[8 * cq + ql];
      const int v4[4] = {a.x, a.y, a.z, a.w}, base = 32 * cq + 4 * ql;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part += base + j < lim ? (halving ? halve_n(v4[j], h, false) : v4[j]) : 0;
    }
    const int cum = quarter_sum(part);
    int* const res = ares + max(lq, 0) * ARES_S;
    if (real && ql == 0) {
      res[0] = sum; res[1] = sym | h << 16; res[2] = cum; res[3] = fb;
      res[4] = hit; res[5] = esc; res[6] = match; res[7] = hit2;
    }
    if (real && sym == SYM_ESC) {
      // the byte slots still present after h halvings: this thread's 32
      // are word ql of the mask (bit b: slot 32 ql + b)
      unsigned bits = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = (k + ql) & 7;
        const int4 a = r4[c];
        const int v4[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bits |= (unsigned)((halving ? halve_n(v4[j], h, false) : v4[j]) > 0) << (4 * c + j);
      }
      if (ql == pr / 32) bits |= (unsigned)(prh > 0) << (pr & 31);
      res[ARES_N + ql] = bits;
    }
    ring4_release(ring, ctx2);
  }
  __syncwarp();
  if (want) {  // this lane's results, from the quarter that coded it
    const int* o = ares + lane * ARES_S;
    mine.tot = o[0];
    mine.sym = o[1] & 0xFFFF;
    mine.h = o[1] >> 16;
    mine.c = o[2];
    mine.bytes_tot = o[2];
    mine.f = o[3];
    mine.fbyte = o[3];
#pragma unroll
    for (int k = 0; k < 4; ++k) mine.sp[k] = o[4 + k];
    if (mine.sym == SYM_ESC) {
#pragma unroll
      for (int m = 0; m < O1_N / 32; ++m) mine.ex[m] = o[ARES_N + m];
    }
    enc_sse_stage<MODE>(cfg, mine, fill, conf, sse, sse_h, sse_thr);
  }
  return mine;
}

// ---- symbol lookup in a row (exclusive prefix sums, int32) ----
// (cum, frq) of a known symbol; 0 outside the row.
template <typename RowFn>
static __device__ void cum_frq_of(RowFn row, int w, int sym, int& c, int& f) {
  if (sym < 0 || sym >= w) { c = 0; f = 0; return; }
  c = sum_prefix(row, sym);
  f = row(sym);
}

// The o1 part of the B event (ppm.read_o1_excl) for every escaping lane
// of the warp (want): the o1 row under the lane's p1, weighted 8f-7,
// excluding the predicted bytes and every byte present in its o2 row
// after the A event's h halving rounds — the A event's mask ex, read off
// the same o2 row (no write of the step lies between the two events);
// then decode's slot search for the lane's state x, or encode's lookup of
// the lane's byte.  Two lanes at a time, a half-warp each, from their o1
// rows in the ring (ring_start over o1 with the same want and p1).  Call
// with the warp converged.  Returns (tot, sym, cum, freq) on each lane.
struct O1Event {
  int tot, sym, c, f;
};

template <bool DECODE>
static __device__ O1Event warp_o1_event(RowRing& ring, bool want, int p1,
                                        const unsigned (&ex)[O1_N / 32], int pred,
                                        int pred2, bool valid2, uint32_t x,
                                        int byte) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, hl = lane & (HALF - 1), half = lane & HALF;
  O1Event mine{};
  unsigned todo = __ballot_sync(full, want);
  while (todo) {
    const int l0 = __ffs(todo) - 1;
    todo &= todo - 1;
    const int l1 = todo ? __ffs(todo) - 1 : -1;
    todo &= todo - 1;
    const bool two = l1 >= 0, upper = half && two;
    const int src = upper ? l1 : l0;
    const int pr = __shfl_sync(full, pred, src);
    const int pr2 = __shfl_sync(full, valid2 ? pred2 : -1, src);
    const int* row = ring_take(ring, p1) + (upper ? RING_SLOT_INTS : 0);
    int a[SLOTS_T];
    load16(row, a);
    ring_release(ring, p1);
    // this thread's 16 bits of the lane's o2 exclusion (word hl / 2)
    unsigned word = 0;
#pragma unroll
    for (int m = 0; m < O1_N / 32; ++m) {
      const unsigned e = __shfl_sync(full, ex[m], src);
      word = m == hl / 2 ? e : word;
    }
    const unsigned bits = word >> (SLOTS_T * (hl & 1));
    int w[SLOTS_T], tsum = 0;
#pragma unroll
    for (int j = 0; j < SLOTS_T; ++j) {
      const int k = SLOTS_T * hl + j;
      const bool excl = k == pr || k == pr2 || ((bits >> j) & 1u);
      w[j] = excl ? 0 : a[j] * 8 - 7;
      tsum += w[j];
    }
    int tot;
    const int base = scan16_sum(tsum, tot);
    int sym;
    if (DECODE) {
      const int tgt = (int)dec_target(__shfl_sync(full, x, src), max(tot, 1));
      sym = clampi(count_le16(w, base, tgt) - 1, 0, O1_N - 1);
    } else {
      sym = __shfl_sync(full, byte, src);
    }
    int cum, frq;
    cum_frq16(w, base, sym, cum, frq);
    const int from = two && lane == l1 ? HALF : 0;
    const O1Event r{__shfl_sync(full, tot, from), __shfl_sync(full, sym, from),
                    __shfl_sync(full, cum, from), __shfl_sync(full, frq, from)};
    if (lane == l0 || (two && lane == l1)) mine = r;
  }
  return mine;
}

// (cum, freq) of symbol sym in the shared row base + off (w <= 256
// entries) for every lane of the warp with want set (0, 0 for a symbol
// outside the row), the whole warp one lane at a time: thread j sums the
// row's entries j, j + 32, ... below sym and one reduction gives the cum,
// where a lane alone would walk up to 255 entries.  Call with the warp
// converged.
static __device__ void warp_cum_frq(bool want, const int* base, int w, int off, int sym,
                                    int& c, int& f) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  unsigned todo = __ballot_sync(full, want);
  while (todo) {
    const int l = __ffs(todo) - 1;
    todo &= todo - 1;
    const int s = __shfl_sync(full, sym, l);
    const int* row = base + __shfl_sync(full, off, l);
    if (s < 0 || s >= w) {
      if (lane == l) c = f = 0;
      continue;
    }
    int part = 0;
#pragma unroll
    for (int q = 0; q < LEN_W / 32; ++q) {
      const int k = lane + 32 * q;
      if (k < s) part += row[k];
    }
    const int cum = __reduce_add_sync(full, part);
    if (lane == l) {
      c = cum;
      f = row[s];
    }
  }
}

// Decode's symbol search in a shared row of W entries (the JAX
// find_symbol's rule: count(cums <= tgt) - 1, clipped, not a search for
// the first prefix above tgt: zero slots change the count; and the
// symbol's raw cum and freq) for every lane of the warp with want set, the
// lane's row at rows + off and its target tgt: two lanes at a time, a
// half-warp each, where a lane alone would walk up to W + W - 1 entries.
// Thread hl of a half holds the row's W / 16 consecutive entries from
// hl * W / 16; one 16-wide scan of their sums gives the cums, a half
// reduction the count, two shuffles the cum and freq.  rows + off must be
// aligned to the entries a thread loads (16 bytes at W = 256).  Call with
// the warp converged; a lane without want gets 0, 0, 0.
template <int W>
static __device__ int warp_find_symbol(bool want, const int* rows, int off, int tgt,
                                       int& c, int& f) {
  constexpr int K = W / HALF;
  static_assert(W % HALF == 0, "a row of whole thread runs");
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, hl = lane & (HALF - 1), half = lane & HALF;
  int sym = 0;
  c = f = 0;
  unsigned todo = __ballot_sync(full, want);
  while (todo) {
    const int l0 = __ffs(todo) - 1;
    todo &= todo - 1;
    const int l1 = todo ? __ffs(todo) - 1 : -1;
    todo &= todo - 1;
    const bool two = l1 >= 0, upper = half && two;
    const int src = upper ? l1 : l0;
    const int* row = rows + __shfl_sync(full, off, src) + hl * K;
    const int tg = __shfl_sync(full, tgt, src);
    int v[K];
    if (K % 4 == 0) {
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const int4 a = reinterpret_cast<const int4*>(row)[q];
        v[4 * q] = a.x;
        v[4 * q + 1] = a.y;
        v[4 * q + 2] = a.z;
        v[4 * q + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = row[j];
    }
    int mine = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) mine += v[j];
    int incl = mine;
#pragma unroll
    for (int o = 1; o < HALF; o <<= 1) {
      const int y = __shfl_up_sync(full, incl, o, HALF);
      if (hl >= o) incl += y;
    }
    const int base = incl - mine;
    int cnt = 0, cu = base;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      cnt += cu <= tg;
      cu += v[j];
    }
    const int s = clampi(half_sum(cnt) - 1, 0, W - 1);
    const int j0 = s % K;
    int part = base;
#pragma unroll
    for (int j = 0; j < K; ++j) part += j < j0 ? v[j] : 0;
    const int cs = __shfl_sync(full, part, half + s / K);
    const int fs = __shfl_sync(full, pick(v, j0), half + s / K);
    const int from = two && lane == l1 ? HALF : 0;
    const int rs = __shfl_sync(full, s, from);
    const int rc = __shfl_sync(full, cs, from);
    const int rf = __shfl_sync(full, fs, from);
    if (lane == l0 || (two && lane == l1)) {
      sym = rs;
      c = rc;
      f = rf;
    }
  }
  return sym;
}

struct PlainRow {
  const int* p;
  __device__ int operator()(int k) const { return p[k]; }
};

// ------------------------------------------------------ shared updates ----
static __device__ __forceinline__ int o3_nc(int cf) {
  return (cf > 1) + (cf > 2) + (cf > 4) + (cf > 8);
}

// The winner's o2 rescale write: apply the same h halving rounds the read
// applied (rows0 is still the step-start row: winners are unique per row
// and no lane adds before the next barrier).
static __device__ void o2_write_halved(int* o2row, int h) {
  if (h == 0) return;
  for (int k = 0; k < O2_W; ++k) o2row[k] = halve_n(o2row[k], h, o2_sticky(k));
}

// Number of the first n keys equal to k.  keys is a 16-byte aligned
// shared array: four keys per broadcast load.
static __device__ __forceinline__ int count_same(const int* keys, int n, int k) {
  const int4* k4 = reinterpret_cast<const int4*>(keys);
  int r = 0, j = 0;
  for (; j + 4 <= n; j += 4) {
    int4 v = k4[j >> 2];
    r += (v.x == k) + (v.y == k) + (v.z == k) + (v.w == k);
  }
  for (; j < n; ++j) r += keys[j] == k;
  return r;
}

// ---- lane-order ranks: how many lower lanes have this lane's key ---------
// The elections (the o2 and o3 winners: the lowest lane of each key) and
// the bucket insert (a lane's rank among the lanes inserting into its
// bucket) count, for each lane, the lower lanes (lower CTAs, then lower
// warps, then lower lanes of its warp) with the same key.  Each CTA keeps
// its lanes' keys (by threadIdx.x) and a filter of KEYF_N words: word h
// has bit w set where warp w of the CTA posted a key that hashes to h.  A
// lane counts its own warp by __match_any_sync and scans only the lower
// warps whose bit is set in its key's word (a false hit costs one scan of
// a warp's keys, never a wrong count): O(S/32 + 1), not a scan of every
// lower lane.  Several elections may share one filter with different
// salts.  The phases: key_post by every lane, a barrier, lane_rank, a
// barrier, key_clear (the filter is all zero again).
#define KEYF_BITS 9
#define KEYF_N (1 << KEYF_BITS)
#define SALT_O2 0u
#define SALT_O3 1u
#define SALT_INS 2u
#define SALT_INS2 3u

static __device__ __forceinline__ int keyf_slot(int key, unsigned salt) {
  uint32_t h = (uint32_t)key * 2654435761u + salt * 0x61C88647u;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  return (int)(h >> (32 - KEYF_BITS));
}

// This lane's key (-1: none) into keys[] and its warp's bit.  With TPL
// threads a lane (K5), the first of them posts: keys[threadIdx.x / TPL].
template <int TPL = 1>
static __device__ __forceinline__ void key_post(int* keys, unsigned* filt, int key,
                                                unsigned salt) {
  if (threadIdx.x % TPL == 0) keys[threadIdx.x / TPL] = key;
  if (key >= 0) atomicOr(&filt[keyf_slot(key, salt)], 1u << (threadIdx.x >> 5));
}

// Number of the N keys at keys (16-byte aligned) equal to k: N / 4
// loads, all in flight together (a scan of another CTA's keys is one
// round trip).
template <int N>
static __device__ __forceinline__ int count_same_n(const int* keys, int k) {
  const int4* k4 = reinterpret_cast<const int4*>(keys);
  int4 v[N / 4];
#pragma unroll
  for (int j = 0; j < N / 4; ++j) v[j] = k4[j];
  int r = 0;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) r += (v[j].x == k) + (v[j].y == k) + (v[j].z == k) + (v[j].w == k);
  return r;
}

// After the barrier that follows every lane's last lane_rank on filt.
static __device__ __forceinline__ void key_clear(unsigned* filt, int key, unsigned salt) {
  if (key >= 0) filt[keyf_slot(key, salt)] = 0;
}

// The number of lower lanes whose key is this lane's (key >= 0), counted
// at least up to `limit` (the count stops growing once it reaches it).
// Every thread of the warp calls it (it takes __match_any_sync), after a
// barrier that follows every key_post<TPL> of the launch; with CL the lower
// CTAs' keys and filters count first.  With TPL threads a lane only the
// first posts a key (the others pass -1).
template <bool CL = false, int TPL = 1>
static __device__ int lane_rank(const int* keys, const unsigned* filt, int key,
                                unsigned salt, int limit) {
  constexpr int KPW = 32 / TPL;  // keys a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned same = __match_any_sync(0xffffffffu, key);
  int r = __popc(same & ((1u << lane) - 1u));
  if (key < 0) return 0;
  const int h = keyf_slot(key, salt);
  const int me = CL ? (int)blockIdx.x : 0;
  // every CTA's word at once (with CL, reads of the others' shared memory)
  unsigned words[CL ? CPX_MAX_CLUSTER : 1];
#pragma unroll
  for (int b = 0; b < (CL ? CPX_MAX_CLUSTER : 1); ++b)
    words[b] = b <= me ? at_rank<CL>(filt, b)[h] : 0u;
#pragma unroll
  for (int b = 0; b < (CL ? CPX_MAX_CLUSTER : 1); ++b) {
    if (b > me || r >= limit) break;
    unsigned m = words[b];
    if (b == me) m &= (1u << warp) - 1u;
    const int* kb = at_rank<CL>(keys, b);
    while (m && r < limit) {
      const int w = __ffs(m) - 1;
      m &= m - 1;
      // another CTA's keys (one round trip), or this CTA's (one at a time)
      r += CL && b != me ? count_same_n<KPW>(kb + KPW * w, key)
                         : count_same(kb + KPW * w, KPW, key);
    }
  }
  return r;
}

// Is this lane the lowest with its key among the keyed lanes (key >= 0)?
// Every thread of the warp calls it.
template <bool CL = false>
static __device__ __forceinline__ bool is_winner(const int* keys, const unsigned* filt,
                                                 int key, unsigned salt) {
  const int r = lane_rank<CL>(keys, filt, key, salt, 1);
  return key >= 0 && r == 0;
}

// Halve (in place) every o1 row whose maintained sum is over the cap and
// refresh that sum.  o1sum[] lives in shared memory.  Warp-cooperative.
static __device__ void o1_rescale(int* o1, int* o1sum, int cap1) {
  const unsigned full = 0xffffffffu;
  int warp = gtid() >> 5, lane = threadIdx.x & 31;
  int nwarps = gthreads() >> 5;
  // the warp's rows warp, warp + nwarps, ...: 32 of their sums checked at
  // once (one read a thread), then the rows over the cap halved in turn
  for (int first = warp; first < O1_N; first += 32 * nwarps) {
    const int mine = first + nwarps * lane;
    unsigned due = __ballot_sync(full, mine < O1_N && o1sum[mine] > cap1);
    while (due) {
      const int row = first + nwarps * (__ffs(due) - 1);
      due &= due - 1;
      int s = 0;
      for (int k = lane; k < O1_N; k += 32) {
        int v = (o1[row * O1_N + k] + 1) >> 1;
        o1[row * O1_N + k] = v;
        s += v;
      }
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(full, s, off);
      __syncwarp();
      if (lane == 0) o1sum[row] = s;
    }
  }
}

// The rescale of the dense shared models (len, idx; mode X's distance
// row): each of n_rows rows of w entries whose flag is hot and whose sum
// is over the cap is halved, up to three rounds, and its sum refreshed;
// a warp a row (row r on the launch's warp first_warp + r, modulo the
// warps).  upd_add keeps every row's sum current, so a row that is not
// halved is not read at all.
static __device__ void rescale_rows(int* rows, int w, int n_rows, const int* hot, int cap,
                                    int* sums, int first_warp) {
  const int lane = threadIdx.x & 31, nwarps = gthreads() >> 5;
  for (int r = ((gtid() >> 5) - first_warp % nwarps + nwarps) % nwarps; r < n_rows;
       r += nwarps) {
    if (!hot[r] || sums[r] <= cap) continue;
    int* row = rows + r * w;
    int s = sums[r];
    for (int round = 0; round < 3 && s > cap; ++round) {
      int part = 0;
      for (int k = lane; k < w; k += 32) {
        const int v = (row[k] + 1) >> 1;
        row[k] = v;
        part += v;
      }
      s = __reduce_add_sync(0xffffffffu, part);
    }
    if (lane == 0) sums[r] = s;
  }
}

// The sums of n_rows rows of w entries of a table in device memory, a
// warp a row (the launch's warps in turn): the maintained sums' start.
static __device__ void row_sums(const int* rows, int w, int n_rows, int* sums) {
  const int lane = threadIdx.x & 31, nwarps = gthreads() >> 5;
  for (int r = gtid() >> 5; r < n_rows; r += nwarps) {
    int part = 0;
    for (int k = lane; k < w; k += 32) part += rows[r * w + k];
    part = __reduce_add_sync(0xffffffffu, part);
    if (lane == 0) sums[r] = part;
  }
}

// Exclusive lane-order prefix of a per-lane flag across the CTA (with CL,
// the cluster).  Call by every thread; wtot is the CTA's shared [32]
// scratch, which this call owns until the next barrier after it.  Returns
// the exclusive prefix, sets total.
static __device__ __forceinline__ int cta_excl_prefix_a(bool flag, int* wtot) {
  unsigned b = __ballot_sync(0xffffffffu, flag);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) wtot[warp] = __popc(b);
  return __popc(b & ((1u << lane) - 1u));
}

template <bool CL = false>
static __device__ __forceinline__ int cta_excl_prefix_b(int in_warp, const int* wtot,
                                                 int& total) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5, me = blockIdx.x;
  if (!CL) {
    // one CTA: each thread reads one warp's count, two reductions sum them
    // (every thread of the warp calls this)
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int v = lane < nwarps ? wtot[lane] : 0;
    total = __reduce_add_sync(full, v);
    return __reduce_add_sync(full, lane < warp ? v : 0) + in_warp;
  }
  int before = 0, tot = 0;
  for (int b = 0; b < (CL ? (int)gridDim.x : 1); ++b) {
    const int* w = at_rank<CL>(wtot, b);
    for (int k = 0; k < nwarps; ++k) {
      const int v = w[k];
      before += (b < me || (b == me && k < warp)) ? v : 0;
      tot += v;
    }
  }
  total = tot;
  return before + in_warp;
}

// ROLZ bucket insert, last phase: the entry for position q = pos-late.
static __device__ __forceinline__ void bucket_store(int* rolz, const Cfg& cfg,
                                             uint32_t rctx, int slot, int pos,
                                             uint32_t nx4, int late = 3) {
  int* e = rolz + ((size_t)rctx * cfg.rolz_depth + slot) * 2;
  e[0] = pos - late + 1;
  e[1] = (int)nx4;
}

// Whether a lane inserts at this step (both sides: position-driven).
static __device__ __forceinline__ bool insert_here(const Cfg& cfg, bool active, int t,
                                            int pos) {
  bool ins = active && (t >= (cfg.rolz_ctx_bytes == 4 ? 7 : 6));
  if (cfg.rolz_dec > 1) ins = ins && (pos % cfg.rolz_dec == 0);
  return ins;
}

// ------------------------------------------------------------ LZP (mode P) --
// Three tables shared by the lanes (block.py::_init_carry): position + 1 of
// the byte that last followed the lane's last 2 bytes (exact index), last 4
// and last 8 bytes (hashed); 0 = empty.
struct Lzp {
  int* t2;  // [2^16]
  int* t4;  // [2^LZP4_BITS]
  int* t8;  // [2^LZP8_BITS]
};

// Block b's LZP tables (the block axis).
static __device__ __forceinline__ Lzp lzp_at(Lzp z) {
  return Lzp{at_blk(z.t2, 1LL << 16), at_blk(z.t4, 1LL << LZP4_BITS),
             at_blk(z.t8, 1LL << LZP8_BITS)};
}

static __device__ __forceinline__ uint32_t lzp_hash4(uint32_t ctx4) {
  return ((ctx4 * 2654435761u) >> 12) & ((1u << LZP4_BITS) - 1u);
}

static __device__ __forceinline__ uint32_t lzp_hash8(uint32_t ctx4, uint32_t ctx4b) {
  return (((ctx4 * 2654435761u) ^ (ctx4b * 0xC2B2AE3Du)) >> 10) & ((1u << LZP8_BITS) - 1u);
}

// Block bytes at .. at + 3 packed like a context register (the last byte in
// the low bits).
static __device__ __forceinline__ uint32_t hist_word(const uint8_t* hist, int at) {
  return ((uint32_t)hist[at] << 24) | ((uint32_t)hist[at + 1] << 16) |
         ((uint32_t)hist[at + 2] << 8) | (uint32_t)hist[at + 3];
}

// The lane's match source at step t (block.py::_lzp_candidate): the t8
// entry if it lies at an earlier step of its lane and the 8 bytes before it
// are the lane's last 8 (ctx4b, ctx4), else the t4 entry under the same
// rule with 4 bytes, else the t2 entry.  A source within k bytes of its
// lane's head cannot be verified from bytes the decoder has and is taken as
// it is.  hist is the block: the input on encode, the decoded bytes on
// decode (steps < t only are read).  Every use of a source is behind
// src >= 0: C's % truncates where JAX's floors.  lzp_check returns ok;
// src is set either way (the t2 entry, maybe -1, where nothing is ok).
// In three parts: the three table reads (which a scan may issue before
// the step, once the last inserts are behind a barrier; K13c takes the
// values from its sorted inserts instead), the loads of the bytes the
// checks compare, then the checks.
struct LzpSlots {
  int s8, s4, s2;
};

static __device__ __forceinline__ LzpSlots lzp_slots(const Lzp& z, uint32_t ctx4,
                                                     uint32_t ctx4b) {
  return {z.t8[lzp_hash8(ctx4, ctx4b)] - 1, z.t4[lzp_hash4(ctx4)] - 1,
          z.t2[ctx4 & 0xFFFFu] - 1};
}

// The checks in two halves too: the bytes before the t8 and t4 sources
// that the checks compare (lzp_fetch: loads that a scan may issue a phase
// before it needs them), then the checks themselves (lzp_check).
struct LzpPending {
  LzpSlots sl;
  uint32_t h8a, h8b, h4;  // the 4 and 8 bytes before s8, the 4 before s4
};

static __device__ __forceinline__ LzpPending lzp_fetch(const Cfg& c, const uint8_t* hist,
                                                       int t, LzpSlots sl) {
  LzpPending pd{sl, 0u, 0u, 0u};
  if (sl.s8 >= 0 && t >= 8 && sl.s8 % c.T < t && sl.s8 % c.T >= 8) {
    pd.h8a = hist_word(hist, sl.s8 - 4);
    pd.h8b = hist_word(hist, sl.s8 - 8);
  }
  if (sl.s4 >= 0 && t >= 4 && sl.s4 % c.T < t && sl.s4 % c.T >= 4)
    pd.h4 = hist_word(hist, sl.s4 - 4);
  return pd;
}

static __device__ bool lzp_check(const Cfg& c, int t, uint32_t ctx4, uint32_t ctx4b,
                                 const LzpPending& pd, int& src) {
  const int s8 = pd.sl.s8, s4 = pd.sl.s4, s2 = pd.sl.s2;
  bool ok8 = s8 >= 0 && t >= 8 && s8 % c.T < t;
  if (ok8 && s8 % c.T >= 8) ok8 = pd.h8a == ctx4 && pd.h8b == ctx4b;
  bool ok4 = s4 >= 0 && t >= 4 && s4 % c.T < t;
  if (ok4 && s4 % c.T >= 4) ok4 = pd.h4 == ctx4;
  const bool ok2 = s2 >= 0 && t >= 2 && s2 % c.T < t;
  src = ok8 ? s8 : ok4 ? s4 : s2;
  return ok8 || ok4 || ok2;
}

// Encode finds every step's candidate before its modeling scan (K13c,
// lzpcand.cu): the grid holds, per step and lane, the candidate's match
// length (0 where it is under min_len) and LZP_GRID_OK where there is one.
#define LZP_GRID_OK (1 << 16)

// End of a step (block.py::_post_step, mode P): the contexts of position
// pos + 1 (the registers after this step's byte) map to it.  A scatter-max:
// of the lanes that hit one slot the highest position stays, whatever the
// order.  Call after every read of the step, before a barrier.
static __device__ __forceinline__ void lzp_insert(const Cfg& c, const Lzp& z, bool active,
                                           int t, int pos, uint32_t ctx4n,
                                           uint32_t ctx4bn) {
  if (!(active && t >= 1 && t != c.T - 1 && pos + 1 < c.n)) return;
  atomicMax(&z.t2[ctx4n & 0xFFFFu], pos + 2);
  if (t >= 3) atomicMax(&z.t4[lzp_hash4(ctx4n)], pos + 2);
  if (t >= 7) atomicMax(&z.t8[lzp_hash8(ctx4n, ctx4bn)], pos + 2);
}

// The decode scan K1 keeps each lane's copy of a bucket row's positions in
// an [S, D+1] array: lane i's at pos + i * (D+1).  The
// odd pitch keeps both a warp's stores of one row and the lanes' scans of
// their own rows free of shared-memory bank conflicts.  The array is in
// dynamic shared memory up to this size, else in a global scratch array;
// in a cluster each CTA keeps its own lanes' rows (lanes = its threads).
#define CPX_POS_SMEM_MAX (200 * 1024)
#define CPX_SMEM_MAX 232448  // shared memory a CTA can use on the H100 (227 KB)

static __host__ __device__ __forceinline__ int pos_pitch(int d) { return d + 1; }

static inline size_t pos_smem_bytes(const Cfg& c) {
  const ScanGrid g = scan_grid(c.S);
  const int lanes = g.ctas > 1 ? g.threads : c.S;
  size_t need = (size_t)pos_pitch(c.rolz_depth) * lanes * sizeof(int);
  return need <= CPX_POS_SMEM_MAX ? need : 0;
}

// The base of a CTA's position rows: in shared memory the CTA's own array,
// in the global scratch the rows of its lanes.
static __device__ __forceinline__ int* pos_bufs(int* spos, int* gpos, bool in_smem, int pitch) {
  return in_smem ? spos : gpos + (size_t)blockIdx.x * blockDim.x * pitch;
}

// Copy bucket rows into the lanes' position arrays, a warp at a time: for
// each lane of the warp with want set, the whole warp reads row rctx with
// consecutive entries on consecutive threads (coalesced), eight rows in
// flight, and stores the positions into that lane's array.  Returns the
// lane's fill (the used slots of its row).  Call with the warp converged;
// d <= CPX_MAX_DEPTH (three entries a thread).
static __device__ int warp_load_rows(const int* rolz, int d, bool want,
                                     uint32_t rctx, int* pos, int pitch) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, wbase = threadIdx.x & ~31;
  const unsigned wanted = __ballot_sync(full, want);
  int fill = 0;
  for (int g = 0; g < 32; g += 8) {
    if (!((wanted >> g) & 0xFFu)) continue;
    int v[8][3];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      uint32_t r = __shfl_sync(full, rctx, g + u);
      bool w = (wanted >> (g + u)) & 1u;
      const int* row = rolz + (size_t)r * d * 2;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        int j = lane + 32 * m;
        v[u][m] = (w && j < d) ? row[2 * j] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (!((wanted >> (g + u)) & 1u)) continue;
      int* dst = pos + (size_t)(wbase + g + u) * pitch;
      int cnt = 0;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        int j = lane + 32 * m;
        if (j < d) {
          dst[j] = v[u][m];
          cnt += v[u][m] > 0;
        }
      }
      cnt = __reduce_add_sync(full, cnt);
      if (lane == g + u) fill = cnt;
    }
  }
  return fill;
}

// For each querying lane, the slot of its row (in pos) whose recency rank
// is k, or -1 if k is outside [0, d).  A lane whose k is within one of
// either end of the order selects alone (at most two passes over its
// row); the other queries are answered one at a time by the whole warp:
// every thread ranks slots of that row (broadcast shared-memory reads)
// and a ballot finds the one of rank k, so a query costs the same for
// any k.  Call with the warp converged.
static __device__ int warp_slot_of_rank(const int* pos, int pitch, int d,
                                        bool query, int k) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, wbase = threadIdx.x & ~31;
  const bool in_range = query && k >= 0 && k < d;
  const bool near_end = in_range && min(k, d - 1 - k) <= 1;
  int result = near_end ? slot_of_rank(pos + (size_t)threadIdx.x * pitch, d, k) : -1;
  unsigned todo = __ballot_sync(full, in_range && !near_end);
  while (todo) {
    const int l = __ffs(todo) - 1;
    todo &= todo - 1;
    const int kl = __shfl_sync(full, k, l);
    const int* row = pos + (size_t)(wbase + l) * pitch;
    int found = -1;
    for (int base = 0; base < d && found < 0; base += 32) {
      int s = base + lane;
      unsigned hit = __ballot_sync(full, s < d && recency_rank(row, d, s) == kl);
      if (hit) found = base + __ffs(hit) - 1;
    }
    if (lane == l) result = found;
  }
  return result;
}

// The insert slot of every inserting lane (ins_key >= 0), -1 elsewhere:
// the lane's rank among same-bucket inserters (lower lanes first) picks
// the rank-th oldest slot of the old bucket row, read before any write of
// this step.  Call with the warp converged, after every CTA's lanes have
// posted their ins_key (key_post on keys and filt with salt) and a barrier.
template <bool CL = false>
static __device__ int bucket_slot(const int* rolz, const Cfg& c, const int* keys,
                                  const unsigned* filt, unsigned salt, int ins_key,
                                  int* pos, int pitch) {
  const int d = c.rolz_depth;
  const int r = lane_rank<CL>(keys, filt, ins_key, salt, d);
  const int rank = ins_key >= 0 ? r : d;
  bool ins = rank < d;
  warp_load_rows(rolz, d, ins, (uint32_t)ins_key, pos, pitch);
  // the rank-th oldest is the (d-1-rank)-th newest
  return warp_slot_of_rank(pos, pitch, d, ins, d - 1 - rank);
}

// ------------------------------------------- modeling-scan shared state ----
// Shared memory of the modeling (K2, K12e) and decode (K1, K12d) scans:
// election keys, the small dense models (len, idx, the two APMs; mode X's
// distance-bucket row, mantissa table and hit APM; mode P's hit APM, which
// takes the place of mode X's) and the o1 row sums.  In a cluster every CTA
// has one: its keys and wtot serve its own lanes, and the models of CTA 0
// serve all.
struct SmemModel {
  __align__(16) int key_o2[CPX_MAX_LANES];   // ctx2 of lanes that rescaled their o2 row
  __align__(16) int key_o3[CPX_MAX_LANES];   // h3 of lanes that update the o3 predictor
  __align__(16) int key_ins[CPX_MAX_LANES];  // bucket of lanes that insert (decode only)
  unsigned keyf[KEYF_N];  // the elections' filter (lane_rank), the three keys salted apart
  int o1sum[O1_N];
  __align__(16) int len[N_SHARED_CTX * LEN_W];  // rows read 16 bytes at a time
  int idx[N_SHARED_CTX * IDX_W];
  int len_sum[N_SHARED_CTX], idx_sum[N_SHARED_CTX];
  int hot_len[N_SHARED_CTX], hot_idx[N_SHARED_CTX];
  int sse[SSE_K];
  int sse_h[SSE_HK];
  __align__(16) int dst[DST_W];
  int dst_sum, hot_dst;
  // a hot row over its cap: the step's rescale of the idx (or distance)
  // rows, of the len rows, is due
  int due_idx, due_len;
  int mant[MANT_N * MANT_N];
  int mant_sum[MANT_N];  // the mantissa rows' sums, kept by upd_add
  int sse_x[SSE_XK];  // the hit-only APM: mode X's, or mode P's SSE_PK entries
  int wtot[5][32];  // one lane-order prefix scratch per rANS slot
};

struct Tables {
  int* o2;
  int* o1;
  int* o3;
  int* len;
  int* idx;
  int* sse;
  int* sse_h;
  int* dst;    // mode X only, as mant
  int* mant;
  int* sse_x;  // the hit-only APM: sse_x in mode X, sse_p in mode P
};

// The election filter of this CTA (own), all zero; before the first
// barrier of the launch.
static __device__ void keyf_init(unsigned* filt) {
  for (int k = threadIdx.x; k < KEYF_N; k += blockDim.x) filt[k] = 0;
}

// Block b's tables (the block axis): each table's block stride is its size.
template <int MODE = MODE_R>
static __device__ __forceinline__ Tables tables_at(Tables tb, const Cfg& c) {
  tb.o2 = at_blk(tb.o2, (long long)(1 << 16) * O2_W);
  tb.o1 = at_blk(tb.o1, (long long)O1_N * O1_N);
  tb.o3 = at_blk(tb.o3, 1LL << c.o3_bits);
  tb.len = at_blk(tb.len, (long long)N_SHARED_CTX * LEN_W);
  tb.idx = at_blk(tb.idx, (long long)N_SHARED_CTX * IDX_W);
  tb.sse = at_blk(tb.sse, (long long)SSE_K);
  tb.sse_h = at_blk(tb.sse_h, (long long)SSE_HK);
  tb.dst = at_blk(tb.dst, (long long)DST_W);
  tb.mant = at_blk(tb.mant, (long long)MANT_N * MANT_N);
  tb.sse_x = at_blk(tb.sse_x, (long long)HIT_APM_K(MODE));
  return tb;
}

template <int MODE = MODE_R>
static __device__ void model_load(SmemModel& sm, const Tables& tb) {
  if (MODE == MODE_X) {
    for (int k = gtid(); k < DST_W; k += gthreads()) sm.dst[k] = tb.dst[k];
    for (int k = gtid(); k < MANT_N * MANT_N; k += gthreads()) sm.mant[k] = tb.mant[k];
    if (gtid() == 0) sm.hot_dst = 0;
  }
  if (MODE != MODE_R)
    for (int k = gtid(); k < HIT_APM_K(MODE); k += gthreads()) sm.sse_x[k] = tb.sse_x[k];
  for (int k = gtid(); k < N_SHARED_CTX * LEN_W; k += gthreads()) sm.len[k] = tb.len[k];
  for (int k = gtid(); k < N_SHARED_CTX * IDX_W; k += gthreads()) sm.idx[k] = tb.idx[k];
  if (MODE != MODE_P) {  // mode P passes neither
    for (int k = gtid(); k < SSE_K; k += gthreads()) sm.sse[k] = tb.sse[k];
    for (int k = gtid(); k < SSE_HK; k += gthreads()) sm.sse_h[k] = tb.sse_h[k];
  }
  for (int k = gtid(); k < N_SHARED_CTX; k += gthreads()) {
    sm.hot_len[k] = 0;
    sm.hot_idx[k] = 0;
  }
  if (gtid() == 0) sm.due_idx = sm.due_len = 0;
  row_sums(tb.len, LEN_W, N_SHARED_CTX, sm.len_sum);
  row_sums(tb.idx, IDX_W, N_SHARED_CTX, sm.idx_sum);
  if (MODE == MODE_X) {
    row_sums(tb.dst, DST_W, 1, &sm.dst_sum);
    row_sums(tb.mant, MANT_N, MANT_N, sm.mant_sum);
  }
  int warp = gtid() >> 5, lane = threadIdx.x & 31, nwarps = gthreads() >> 5;
  for (int row = warp; row < O1_N; row += nwarps) {
    int s = 0;
    for (int k = lane; k < O1_N; k += 32) s += tb.o1[row * O1_N + k];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) sm.o1sum[row] = s;
  }
}

template <int MODE = MODE_R>
static __device__ void model_store(const SmemModel& sm, const Tables& tb) {
  if (MODE == MODE_X) {
    for (int k = gtid(); k < DST_W; k += gthreads()) tb.dst[k] = sm.dst[k];
    for (int k = gtid(); k < MANT_N * MANT_N; k += gthreads()) tb.mant[k] = sm.mant[k];
  }
  if (MODE != MODE_R)
    for (int k = gtid(); k < HIT_APM_K(MODE); k += gthreads()) tb.sse_x[k] = sm.sse_x[k];
  for (int k = gtid(); k < N_SHARED_CTX * LEN_W; k += gthreads()) tb.len[k] = sm.len[k];
  for (int k = gtid(); k < N_SHARED_CTX * IDX_W; k += gthreads()) tb.idx[k] = sm.idx[k];
  if (MODE != MODE_P) {
    for (int k = gtid(); k < SSE_K; k += gthreads()) tb.sse[k] = sm.sse[k];
    for (int k = gtid(); k < SSE_HK; k += gthreads()) tb.sse_h[k] = sm.sse_h[k];
  }
}

// A match lane marks the dense row it reads this step hot; where that row
// is over its cap already, the step's rescale of those rows is due (*due,
// which every thread reads after the next barrier, before any rescale can
// change a sum, to decide whether the rescale and its barrier run at all).
static __device__ __forceinline__ void mark_hot(int* hot, const int* sum, int cap, int* due) {
  *hot = 1;
  if (*sum > cap) *due = 1;
}

// Rescale the idx rows that a match lane reads this step (warps 0-3).
static __device__ void idx_rescale(const Cfg& c, SmemModel& sm) {
  rescale_rows(sm.idx, IDX_W, N_SHARED_CTX, sm.hot_idx, c.idx_cap, sm.idx_sum, 0);
}

// Rescale the len rows that a match lane reads this step (warps 4-7).
static __device__ void len_rescale(const Cfg& c, SmemModel& sm) {
  rescale_rows(sm.len, LEN_W, N_SHARED_CTX, sm.hot_len, c.len_cap, sm.len_sum,
               N_SHARED_CTX);
}

// Rescale mode X's distance-bucket row if a match lane reads it this step
// (warp 8, beside the len rows' warps).
static __device__ void dst_rescale(const Cfg& c, SmemModel& sm) {
  rescale_rows(sm.dst, DST_W, 1, &sm.hot_dst, c.dst_cap, &sm.dst_sum, 2 * N_SHARED_CTX);
}

// How a distance bucket k splits its k mantissa bits over the slots D and E
// (block.py::_mant_events_enc): for k in [5, 16] D codes the top 4 bits
// through row k - 5 of the mantissa table and E the other k - 4 uniformly;
// else D carries k - 12 uniform bits (k > 16 only) and E min(k, 12).
struct MantSplit {
  bool adaptive;
  int b_hi, b_lo, b_e;
};

static __device__ __forceinline__ MantSplit mant_split(int k, bool has_extra) {
  MantSplit m;
  m.adaptive = has_extra && k >= 5 && k <= 16;
  m.b_hi = k > 16 ? k - 12 : 0;
  m.b_lo = min(k, 12);
  m.b_e = m.adaptive ? k - 4 : m.b_lo;
  return m;
}

// One lane's step, as the model updates need it (ppm.apply_updates,
// sse_update and, in mode X, _mant_update arguments).
struct Upd {
  bool coding, is_lit, is_hit, is_esc, is_match, adaptive;
  int ctx2, sym_a, byte, f_byte, p1, h3, pred, conf, raw;
  int sym_len, sym_idx, len_ctx, idx_ctx, halvings;
  int sym_dst, mant_row, mant_sym;
  SseState sse;
};

// The lane's election keys, posted to its CTA's arrays and filter (own).
static __device__ __forceinline__ void upd_keys(SmemModel& own, bool alive, const Upd& u) {
  key_post(own.key_o2, own.keyf, (alive && u.coding && u.halvings > 0) ? u.ctx2 : -1, SALT_O2);
  const bool o3_upd = alive && (u.is_hit || u.is_lit || u.is_esc);
  key_post(own.key_o3, own.keyf, o3_upd ? u.h3 : -1, SALT_O3);
}

// Store phase (a barrier after upd_keys): the winners' o2 rescale write
// and o3 predictor write.  Nothing else touches these words before the
// next barrier.  Every thread calls it (the elections take warp votes);
// a dead lane has no key and wins nothing.
template <bool CL = false>
static __device__ void upd_store(const Tables& tb, const SmemModel& own, const Upd& u) {
  const bool win_o2 = is_winner<CL>(own.key_o2, own.keyf, own.key_o2[threadIdx.x], SALT_O2);
  const bool win_o3 = is_winner<CL>(own.key_o3, own.keyf, own.key_o3[threadIdx.x], SALT_O3);
  if (win_o2) o2_write_halved(tb.o2 + (size_t)u.ctx2 * O2_W, u.halvings);
  if (win_o3) {
    int nc = o3_nc(u.conf);
    int new_pred = (u.is_hit || nc > 0) ? u.pred : u.byte;
    int new_conf = u.is_hit ? min(u.conf + 1, 15) : max(nc, 1);
    tb.o3[u.h3] = (new_conf << 8) | new_pred;
  }
}

// Add phase (after the store barrier): every additive update; first this
// lane's election keys leave the filter of its CTA (own).  In modes X and
// P a match bumps idx[0][0] too (JAX passes a zero index symbol).
template <int MODE = MODE_R>
static __device__ void upd_add(const Cfg& c, const Tables& tb, SmemModel& sm,
                               SmemModel& own, const Upd& u) {
  key_clear(own.keyf, own.key_o2[threadIdx.x], SALT_O2);
  key_clear(own.keyf, own.key_o3[threadIdx.x], SALT_O3);
  if (!u.coding) return;
  int* row = tb.o2 + (size_t)u.ctx2 * O2_W;
  if (u.sym_a >= 0 && u.sym_a < O2_W) atomicAdd(&row[u.sym_a], c.inc2);
  if (u.is_esc && u.byte >= 0 && u.byte < O2_W) atomicAdd(&row[u.byte], c.inc2);
  if (u.is_lit && u.f_byte == c.inc2) atomicAdd(&row[SYM_ESC], -c.inc2);
  if (u.is_esc && u.byte >= 0 && u.byte < O1_N) {
    atomicAdd(&tb.o1[u.p1 * O1_N + u.byte], c.inc1);
    atomicAdd(&sm.o1sum[u.p1], c.inc1);
  }
  if (u.is_match) {
    int lc = clampi(u.len_ctx, 0, N_SHARED_CTX - 1);
    int ic = clampi(u.idx_ctx, 0, N_SHARED_CTX - 1);
    // each add to a dense shared row adds to its sum too
    if (u.sym_len >= 0 && u.sym_len < LEN_W) {
      atomicAdd(&sm.len[lc * LEN_W + u.sym_len], c.len_inc);
      atomicAdd(&sm.len_sum[lc], c.len_inc);
    }
    if (u.sym_idx >= 0 && u.sym_idx < IDX_W) {
      atomicAdd(&sm.idx[ic * IDX_W + u.sym_idx], c.idx_inc);
      atomicAdd(&sm.idx_sum[ic], c.idx_inc);
    }
    if (MODE == MODE_X && u.sym_dst >= 0 && u.sym_dst < DST_W) {
      atomicAdd(&sm.dst[u.sym_dst], c.dst_inc);
      atomicAdd(&sm.dst_sum, c.dst_inc);
    }
  }
  if (MODE == MODE_X && u.adaptive && u.mant_sym >= 0 && u.mant_sym < MANT_N) {
    atomicAdd(&sm.mant[u.mant_row * MANT_N + u.mant_sym], c.mant_inc);
    atomicAdd(&sm.mant_sum[u.mant_row], c.mant_inc);
  }
  if (MODE != MODE_R) {
    if (c.use_sse && u.sse.act_h) apm_add(sm.sse_x, HIT_APM_K(MODE), u.sse.h, u.is_hit);
  } else if (c.use_sse) {
    apm_add(sm.sse, SSE_K, u.sse.m, u.is_match);
    if (u.sse.act_h) apm_add(sm.sse_h, SSE_HK, u.sse.h, u.is_hit);
  }
}

// Last phase of a step: clip the APMs, clear the hot-row flags; mode X:
// halve each mantissa row whose kept sum is over the cap (every step,
// whoever added) and refresh that sum.
template <int MODE = MODE_R>
static __device__ void upd_finish(SmemModel& sm, int mant_cap = 0) {
  if (gtid() == 0) sm.due_idx = sm.due_len = 0;
  if (MODE != MODE_R) {
    for (int k = gtid(); k < HIT_APM_K(MODE); k += gthreads()) sm.sse_x[k] = clampi(sm.sse_x[k], SSE_LO, SSE_HI);
    if (gtid() < N_SHARED_CTX) sm.hot_len[gtid()] = 0;
  }
  if (MODE == MODE_X) {
    if (gtid() == N_SHARED_CTX) sm.hot_dst = 0;
    for (int r = gtid(); r < MANT_N; r += gthreads()) {
      if (sm.mant_sum[r] <= mant_cap) continue;
      int* row = sm.mant + r * MANT_N;
      int s = 0;
      for (int k = 0; k < MANT_N; ++k) {
        const int v = (row[k] + 1) >> 1;
        row[k] = v;
        s += v;
      }
      sm.mant_sum[r] = s;
    }
  }
  if (MODE == MODE_R) {
    for (int k = gtid(); k < SSE_K; k += gthreads()) sm.sse[k] = clampi(sm.sse[k], SSE_LO, SSE_HI);
    for (int k = gtid(); k < SSE_HK; k += gthreads()) sm.sse_h[k] = clampi(sm.sse_h[k], SSE_LO, SSE_HI);
    if (gtid() < N_SHARED_CTX) {
      sm.hot_len[gtid()] = 0;
      sm.hot_idx[gtid()] = 0;
    }
  }
}

// Per-lane contexts at step start (block.py::_common_reads).
struct Ctx {
  int pos, p1, ctx2, h3, pred, conf, pred2, conf2, raw;
  bool active, coding, copying;
};

// The slot of the o3 predictor table under context register ctx4.
static __device__ __forceinline__ int o3_slot(const Cfg& c, uint32_t ctx4) {
  const int ctx3 = (int)(ctx4 & 0xFFFFFFu);
  return (ctx3 ^ (ctx3 >> 2)) & ((1 << c.o3_bits) - 1);
}

// The contexts with the lane's o3 entry raw already read (0 for a dead
// lane).
static __device__ __forceinline__ Ctx contexts(const Cfg& c, int i, int t, uint32_t ctx4,
                                               int copy_rem, bool alive, int raw) {
  Ctx x;
  x.pos = i * c.T + t;
  x.active = alive && x.pos < c.n;
  x.coding = x.active && copy_rem == 0;
  x.copying = x.active && copy_rem > 0;
  x.p1 = (int)(ctx4 & 0xFFu);
  int p2 = (int)((ctx4 >> 8) & 0xFFu);
  x.ctx2 = (p2 << 8) | x.p1;
  x.h3 = o3_slot(c, ctx4);
  x.raw = raw;
  x.pred = x.raw & 0xFF;
  x.conf = clampi((x.raw >> 8) & 0xF, 0, 15);
  x.pred2 = (x.raw >> 12) & 0xFF;
  x.conf2 = clampi((x.raw >> 20) & 0xF, 0, 15);
  return x;
}

static __device__ __forceinline__ Ctx common_reads(const Cfg& c, const Tables& tb,
                                            int i, int t, uint32_t ctx4,
                                            int copy_rem, bool alive) {
  return contexts(c, i, t, ctx4, copy_rem, alive, alive ? tb.o3[o3_slot(c, ctx4)] : 0);
}
