// The nine Pallas probes of benchmarks/pallas_probe.py and pallas_probe2.py
// as Hopper kernels: seven bodies (comprox_tpu_torch/benchmarks/probes.py
// holds the wrappers, the plain versions and the timing).
//
// The probes ask what the codec's step scans pay on this card for one
// random row or element of a table, for a row read issued only after the
// one before it, for a step that waits on the step before it, and for a
// one-hot product on the tensor cores in place of a gather.  No probe table
// fits in a CTA's shared memory (227 KB; the smallest is 256 KiB), so
// P1, P1b, P3, P4, P6, P7 and P8 read tables that stay in the 50 MB L2
// after the first call, and P5 and P9 a 64 MiB table in device memory.
// Every bound is under a few microseconds (bytes over 3.35 TB/s: the index,
// the rows read once, the output written once; P8: its bf16 operations over
// 989 TFLOP/s); a launch costs about as much, so launch overhead and load
// latency, not bandwidth, are what these kernels measure.  Every index is
// in [0, rows) (elements: [0, n)), as the plain versions require; no kernel
// checks it.
//
// Three bodies use what Hopper added.  P3's row loop is the copy engine's:
// one thread a CTA issues its rows as bulk copies (cp.async.bulk) that
// complete on one mbarrier, and stores them with one bulk copy.  P5's and
// P9's ring is too, spread over CTAs: one thread a CTA keeps DEPTH bulk
// copies in flight, a slot and its mbarrier each.  P8's one-hot product is
// a warpgroup product (wgmma.mma_async, sm_90a) with the one-hot A built in
// registers and B in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------- P1, P6
// Replaces pallas_probe.py::probe_vmem_gather (kernel :51, pallas_call :56)
// and pallas_probe2.py::probe_taa (kernel :45, pallas_call :51): out[k, :] =
// table[idx[k], :].  Bound by load latency: the index, then the row, two
// dependent L2 round trips behind a launch (the bytes take 0.157-0.319 us).
//
// pr_row_gather maps the output flat, as n = S * words words of 16 bytes
// (VEC: a width that is a multiple of 4, table and out 16-byte aligned) or
// of 4 bytes: CTA b's thread t owns the words g = b * GATHER_THREADS *
// GATHER_WPT + i * GATHER_THREADS + t, i < GATHER_WPT, each word j = g %
// words of row k = g / words.  A thread loads its rows' indices (the
// threads of a row share the address), then all its words, then stores
// them: no thread loops over a row, so no store stands between two loads,
// and a row of 260 int32 costs what a row of 128 does.  GATHER_THREADS and
// GATHER_WPT by a sweep on the card (PERF.md).
constexpr int GATHER_THREADS = 256;
constexpr int GATHER_WPT = 1;

template <bool VEC>
__global__ void __launch_bounds__(GATHER_THREADS)
    pr_row_gather(const int* __restrict__ table, const int* __restrict__ idx,
                  int* __restrict__ out, int words, int n) {
  using W = typename std::conditional<VEC, int4, int>::type;
  const W* src = reinterpret_cast<const W*>(table);
  W* dst = reinterpret_cast<W*>(out);
  const int g0 = blockIdx.x * (GATHER_THREADS * GATHER_WPT) + threadIdx.x;
  size_t at[GATHER_WPT];
#pragma unroll
  for (int i = 0; i < GATHER_WPT; ++i) {
    const int g = g0 + i * GATHER_THREADS, k = g / words;
    at[i] = g < n ? (size_t)idx[k] * words + (g - k * words) : 0;
  }
  W v[GATHER_WPT];
#pragma unroll
  for (int i = 0; i < GATHER_WPT; ++i)
    if (g0 + i * GATHER_THREADS < n) v[i] = src[at[i]];
#pragma unroll
  for (int i = 0; i < GATHER_WPT; ++i)
    if (g0 + i * GATHER_THREADS < n) dst[g0 + i * GATHER_THREADS] = v[i];
}

// P1's second arm (P1t): each thread copies a whole row (uncoalesced), to
// time the difference.
__global__ void pr_row_thread(const int* __restrict__ table,
                              const int* __restrict__ idx, int* __restrict__ out,
                              int width, int S, bool vec) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= S) return;
  const size_t r = idx[k];
  if (vec) {
    const int4* src = reinterpret_cast<const int4*>(table + r * width);
    int4* dst = reinterpret_cast<int4*>(out + (size_t)k * width);
    for (int j = 0; j < width / 4; ++j) dst[j] = src[j];
  } else {
    for (int j = 0; j < width; ++j) out[(size_t)k * width + j] = table[r * width + j];
  }
}

// ---------------------------------------------------------------- P1b, P7
// Replaces pallas_probe.py::probe_vmem_gather_1d (kernel :85, pallas_call
// :97) and pallas_probe2.py::probe_elem (kernel :85, pallas_call :100): the
// o3 pattern, out[k] = flat[idx[k]].  The TPU took the row idx >> 7 and
// picked the column by a masked sum; here a thread reads its element (one
// 32-byte sector), bound by one dependent load's latency.
__global__ void pr_elem_gather(const int* __restrict__ flat,
                               const int* __restrict__ idx,
                               int* __restrict__ out, int n, int S) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < S) out[k] = flat[idx[k]];
}

// ---------------------------------------------------------------- P3
// Replaces pallas_probe.py::probe_dynslice_loop (kernel :155, pallas_call
// :164): S row reads issued one after another, the index in scalar memory.
// The function is bound by its bytes (0.314 us at 512 rows of [8192x256]);
// the loop of dynamic slices carried over as it is, by the serial issue of
// a row: one row in flight on one SM.
//
// pr_row_bulk (the probe's headline arm) hands each row to the copy engine:
// BULK_R consecutive output rows a CTA, one thread a CTA.  The thread reads
// its BULK_R indices (loads issued together), arms one mbarrier with the
// rows' bytes (arrive.expect_tx), issues the BULK_R row copies
// (cp.async.bulk, global -> shared, each completing its bytes on the
// barrier) back to back, so no copy waits on the one before, waits on the
// barrier's first phase (parity 0), and stores the CTA's rows, which are
// contiguous in out, with one bulk copy (shared -> global, a bulk group)
// that it waits to have been read before the CTA exits.  The last CTA takes
// the S % BULK_R rows left.  What bounds it is the launch and three
// dependent round trips a CTA (index, rows, store), as index_select's two.  Rows of a multiple of 16 bytes, 16-byte
// aligned table and out (the wrapper refuses anything else).  BULK_R = 2
// was the fastest of 1 to 16 in a sweep on the card (PERF.md): more rows a
// CTA wait longer on one barrier, one row a CTA gains nothing.
constexpr int BULK_R = 2;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// waits until the phase of `parity` of the mbarrier at `bar` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__global__ void __launch_bounds__(1) pr_row_bulk(const int* __restrict__ table,
                                                 const int* __restrict__ idx,
                                                 int* __restrict__ out, int width,
                                                 int S) {
  extern __shared__ __align__(128) int rows_s[];  // [min(BULK_R, S)][width]
  __shared__ __align__(8) unsigned long long bar;
  const int k0 = blockIdx.x * BULK_R, n = min(BULK_R, S - k0);
  const unsigned row_bytes = (unsigned)width * 4u, b = smem_u32(&bar);
  int r[BULK_R];
#pragma unroll
  for (int j = 0; j < BULK_R; ++j) r[j] = j < n ? idx[k0 + j] : 0;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(n * row_bytes)
               : "memory");
#pragma unroll
  for (int j = 0; j < BULK_R; ++j)
    if (j < n)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(rows_s) + j * row_bytes),
          "l"(table + (size_t)r[j] * width), "r"(row_bytes), "r"(b)
          : "memory");
  mbar_wait(b, 0);
  // the rows were written by the async proxy and are read by it: the fence
  // orders the store after the barrier's wait
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   out + (size_t)k0 * width),
               "r"(smem_u32(rows_s)), "r"(n * row_bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// P3's second arm, the TPU's loop as it was: one warp walks
// the rows in order and the loop is not unrolled, so each row waits for its
// index load and its row load: the serial-issue floor, about two L2
// latencies a row, measured beside the copy engine's.
__global__ void pr_row_loop(const int* __restrict__ table,
                            const int* __restrict__ idx, int* __restrict__ out,
                            int rows, int width, int S, bool vec) {
  const int lane = threadIdx.x;
#pragma unroll 1
  for (int k = 0; k < S; ++k) {
    const size_t r = idx[k];
    if (vec) {
      const int4* src = reinterpret_cast<const int4*>(table + r * width);
      int4* dst = reinterpret_cast<int4*>(out + (size_t)k * width);
      for (int j = lane; j < width / 4; j += 32) dst[j] = src[j];
    } else {
      for (int j = lane; j < width; j += 32)
        out[(size_t)k * width + j] = table[r * width + j];
    }
  }
}

// ---------------------------------------------------------------- P4
// Replaces pallas_probe.py::probe_persistent_steps (kernel :191,
// pallas_call :204; its run_scan arm :211): T dependent steps per lane,
// s += table[int(s) & (rows - 1), 0], the state f32 from zero, int()
// truncating toward zero (F2I.TRUNC, as XLA's astype and torch's
// .to(int32)).  The TPU read the row by a one-hot dot; the value is the
// same (the table holds small integers, exact in f32).  Bound by the chain:
// each step waits on the step before it (the operations take 0.012 us).
//
// pr_steps stages column 0 of the table in the CTA's shared memory first
// (rows x 4 B, 8 KB at the probe's [2048x128]): a thread a row, 4-byte
// cp.async copies all in flight together, one wait and one barrier.  Each
// lane then runs its T steps from there, every step a shared-memory load,
// FADD, F2I, AND and the next address, where a load from the table would
// pay an L2 round trip a step (the column's 2048 lines, 512 B apart,
// overflow the L1).
// STEPS_LANES lanes a CTA, each CTA staging its own copy, by a sweep on the
// card (PERF.md).  A column above STEPS_SMEM_MAX bytes (58,112 rows) does
// not fit a CTA: the launcher refuses it.  pr_step is one step a launch,
// for the launch-per-step arm (directly, or replayed from a CUDA graph).
constexpr int STEPS_LANES = 128;
constexpr int STEPS_SMEM_MAX = 232448;  // a CTA's shared memory on sm_90

__global__ void __launch_bounds__(STEPS_LANES)
    pr_steps(const float* __restrict__ table, float* __restrict__ out, int rows,
             int width, int S, int T) {
  extern __shared__ float col[];  // [rows]: column 0
  for (int r = threadIdx.x; r < rows; r += STEPS_LANES)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(col + r)),
                 "l"(table + (size_t)r * width)
                 : "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int k = blockIdx.x * STEPS_LANES + threadIdx.x;
  if (k >= S) return;
  const int mask = rows - 1;
  float s = 0.f;
#pragma unroll 4
  for (int t = 0; t < T; ++t) s += col[(int)s & mask];
  out[k] = s;
}

// No probe: an empty kernel, the launch floor the probes' times stand on.
__global__ void pr_empty() {}

__global__ void pr_step(const float* __restrict__ table, float* __restrict__ state,
                        int rows, int width, int S) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < S) state[k] += table[(size_t)((int)state[k] & (rows - 1)) * width];
}

// ---------------------------------------------------------------- P5, P9
// Replaces pallas_probe.py::probe_dma_depth (kernel :247, pallas_call :272)
// and pallas_probe2.py::probe_dma (kernel :174, pallas_call :203): out[k, :] =
// table[idx[k], :], rows of a 64 MiB table in device memory through a ring
// of DEPTH copies in flight, each slot completing on its own mbarrier (the
// TPU kernels' scratch.at[k % depth] and sems.at[k % depth]).  Bound by the
// device memory's latency: the bytes take 0.314 us (512 rows of 1 KB), one
// round trip about as long, a launch longer.
//
// pr_row_ring spreads the rows over CTAs and hands each to the copy engine:
// CTA b takes the output rows [b RING_R, b RING_R + n), n = min(RING_R,
// S - b RING_R) (the last CTA what is left), so ceil(S / RING_R) CTAs keep
// their rings in flight at once.  The CTA stages its n indices in shared
// memory (the TPU's scalar prefetch: the index loads issued together, before
// any row), thread 0 initialises min(DEPTH, RING_R, S) barriers, and thread
// 0 alone then runs the ring:
// - row k goes to slot k % DEPTH as one bulk copy (cp.async.bulk, global ->
//   shared) that completes its bytes on the slot's barrier, armed first
//   with arrive.expect_tx of the row's bytes; rows 0 .. DEPTH - 1 are
//   issued back to back;
// - row k waits on its slot's barrier at parity (k / DEPTH) & 1: each reuse
//   of a slot completes one more phase;
// - row k leaves the slot by a bulk store (shared -> global, one bulk group
//   a row) after fence.proxy.async;
// - the slot of row j = k - RING_LAG takes row j + DEPTH once the store of
//   row j has read it (wait_group.read RING_LAG: every store but the last
//   RING_LAG has read its slot), so the refill lags the store instead of
//   waiting on the store just issued, and DEPTH - RING_LAG - 1 rows stay in
//   flight ahead of the one waited on.  The JAX kernels start row k + depth
//   into the slot before reading it; here no copy overwrites a slot that a
//   store has still to read.
// Thread 0 waits for its stores to have read their slots before it exits.
// RING_R = 2 by a sweep on the card (PERF.md): 1 and 2 rows a CTA tie, each
// more row a CTA costs (4: +0.2 us, 8: +0.5, 128: +18), and a bulk store
// beats the CTA's threads storing the row wherever the ring wraps.  At
// RING_R <= DEPTH no slot is reused, so depth 16 and 32 do the same work;
// the refills serve any RING_R above 16.  Rows of a multiple of 16 bytes,
// 16-byte aligned table and out (the wrapper refuses anything else).
constexpr int RING_R = 2;
constexpr int RING_LAG = 4;
static_assert(RING_LAG < 16, "a refill must come before the wait on its row");

// the ring's slots in a CTA: no CTA has more rows than RING_R, or than S
__host__ __device__ __forceinline__ int ring_slots(int depth, int S) {
  const int n = RING_R < S ? RING_R : S;
  return depth < n ? depth : n;
}

template <int DEPTH>
__global__ void __launch_bounds__(32) pr_row_ring(const int* __restrict__ table,
                                                  const int* __restrict__ idx,
                                                  int* __restrict__ out, int width,
                                                  int S) {
  // [slots][width] rows, [slots] barriers, [min(RING_R, S)] indices
  extern __shared__ __align__(128) unsigned char ring_smem[];
  const int k0 = blockIdx.x * RING_R, n = min(RING_R, S - k0);
  const int slots = ring_slots(DEPTH, S);
  const unsigned row_bytes = (unsigned)width * 4u;
  int* rid = reinterpret_cast<int*>(ring_smem + (size_t)slots * (row_bytes + 8));
  for (int j = threadIdx.x; j < n; j += blockDim.x) rid[j] = idx[k0 + j];
  const unsigned ring = smem_u32(ring_smem), bars = ring + slots * row_bytes;
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8 * s)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  auto issue = [&](int k) {  // row k into slot k % DEPTH
    const unsigned slot = k % DEPTH, b = bars + 8 * slot;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"(row_bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(ring + slot * row_bytes),
        "l"(table + (size_t)rid[k] * width), "r"(row_bytes), "r"(b)
        : "memory");
  };
  for (int k = 0; k < min(DEPTH, n); ++k) issue(k);
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const unsigned slot = k % DEPTH;
    mbar_wait(bars + 8 * slot, (k / DEPTH) & 1);
    // the row was written by the async proxy and is read by it: the fence
    // orders the store after the barrier's wait
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     out + (size_t)(k0 + k) * width),
                 "r"(ring + slot * row_bytes), "r"(row_bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    const int j = k - RING_LAG;  // the row whose slot takes row j + DEPTH
    if (j >= 0 && j + DEPTH < n) {
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(RING_LAG) : "memory");
      issue(j + DEPTH);
    }
  }
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- P8
// Replaces pallas_probe2.py::probe_kernel_onehot (kernel :130, pallas_call
// :142): out = onehot(idx) [S, rows] (bf16, built in the kernel) times the
// f32 table cast to bf16, accumulated in f32 on the tensor cores.  With one
// 1 a row, a finite table and f32 sums of that one product and zeros, the
// result is exactly bf16(table)[idx].  Bound by its 2 * S * rows * width
// bf16 operations (3.26 us at 8192 x 384 over 989 TFLOP/s); the kernel also
// reads the whole f32 table (12.6 MB from L2), which bf16(table)[idx] does
// not need.
//
// pr_onehot_wgmma, on wgmma.mma_async m64n64k16 (sm_90a):
// - A CTA holds all S <= 512 output rows of one 64-column slice: two
//   warpgroups, four m64 tiles each, 4 x 32 f32 accumulators a thread.  So
//   each table element is read by one CTA only.
// - The table's rows are split into K ranges of `per` 64-row chunks, so
//   that slices x ranges fill the SMs (6 x 22 = 132 at width 384); the last
//   range may be shorter.  Dense: every chunk of a range goes through the
//   tensor cores, whether an index falls in it or not.
// - A (the one-hot) comes from registers, in wgmma's register layout
//   (thread t of a quad, register q: row g + 8 (q & 1), columns 2t, 2t + 1,
//   + 8 (q >> 1) of the k16 step; the lower column in the low half).  A
//   thread's eight output rows (m-tile mt, rows g and g + 8 of its warp's
//   16) have their 1 in its registers iff the index's offset r in the range
//   has (r >> 1) & 3 == t; then in chunk r >> 6, step (r >> 4) & 3,
//   register half (r >> 3) & 1, bf16 half r & 1.  So each row's key r >> 3
//   (or -1) is computed once, and a chunk's A register is one compare and
//   one select.
// - B: each chunk's f32 rows are copied by cp.async (16 B a copy) into a
//   ring of three stages, two chunks ahead of the product; all threads then
//   convert a chunk (__floats2bfloat162_rn: round to nearest even, as
//   __float2bfloat16 and XLA's convert) into one of two bf16 tiles in the
//   no-swizzle K-major layout that the descriptor names: 8 x 8 core
//   matrices of 128 contiguous bytes (8 n rows of 8 k), the next 8 k at
//   OH_LBO, the next 8 n at OH_SBO, a k16 step every OH_KSTEP bytes.
// - A group of products an m-tile, up to four groups in flight in each
//   warpgroup: an m-tile's A registers are built while the three groups
//   before it run, and chunk c + 1 is converted while chunk c's last three
//   run; two barriers a chunk.  What bounds it on the card (PERF.md): alone,
//   the products run at about the peak rate (32 cycles an m64n64k16, 0.55
//   us a chunk); with the A registers' selects and the f32 table's reads
//   from L2 and their conversion, ~1 us a chunk, plus ~4 us of launch,
//   first chunk and epilogue.
// - Epilogue: row m's one nonzero product lies in the range that holds
//   idx[m], so in each slice exactly one CTA writes row m (no atomics, no
//   second pass): the thread that holds accumulator rows g and g + 8 (f32
//   registers 4j + 2h, 4j + 2h + 1 = columns 8j + 2t, + 1 of row g + 8h)
//   stores them where its range holds the row's index.
constexpr int OH_N = 64;                    // columns a CTA: wgmma's N
constexpr int OH_KC = 64;                   // table rows a chunk: four k16 steps
constexpr int OH_WG = 2;                    // warpgroups a CTA
constexpr int OH_MT = 4;                    // m64 tiles a warpgroup
constexpr int OH_S = 64 * OH_MT * OH_WG;    // output rows a CTA holds: 512
constexpr int OH_STAGES = 3;                // f32 chunks staged
constexpr int OH_LBO = 128, OH_SBO = 256;   // B's core matrices: next 8 k, next 8 n
constexpr int OH_KSTEP = 16 * OH_N * 2;     // bytes of B a k16 step
constexpr int OH_B_BYTES = OH_KC * OH_N * 2;
constexpr int OH_F_BYTES = OH_KC * OH_N * 4;
constexpr int OH_SMEM = 2 * OH_B_BYTES + OH_STAGES * OH_F_BYTES;  // 64 KB

// the byte of B's element (k, n) in a chunk's tile
__device__ __forceinline__ int oh_b_off(int k, int n) {
  return (k >> 4) * OH_KSTEP + (n >> 3) * OH_SBO + ((k >> 3) & 1) * OH_LBO +
         (n & 7) * 16 + (k & 7) * 2;
}

// wgmma's shared-memory descriptor of a k16 step's B: the start address, the
// leading (k) and stride (n) byte offsets, in 16-byte units; base offset 0,
// layout 0 (no swizzle)
__device__ __forceinline__ unsigned long long oh_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         (unsigned long long)(OH_LBO >> 4) << 16 |
         (unsigned long long)(OH_SBO >> 4) << 32;
}

// d[64 x 64] += a[64 x 16] (bf16, registers) * b[16 x 64] (bf16, shared)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const unsigned (&a)[4],
                                          unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// keeps the accumulators in their registers across the asynchronous products,
// and the A registers written before the fence that precedes them
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void pin(unsigned (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// One m-tile's products for chunk c of the CTA's range as one group: its A
// registers (the group of this m-tile before it has completed), then its
// four k16 steps on the B tile at `tile` (a shared address).  Then waits
// until at most three groups of the warpgroup are in flight.
__device__ __forceinline__ void oh_group(float (&acc)[32], unsigned (&a)[4][4],
                                         const int (&kq)[2], const unsigned (&val)[2],
                                         int c, unsigned tile) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[s][q] = kq[q & 1] == 8 * c + 2 * s + (q >> 1) ? val[q & 1] : 0u;
    pin(a[s]);
  }
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_n64(acc, a[s], oh_desc(tile + s * OH_KSTEP));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 3;\n" ::: "memory");
}

__global__ void __launch_bounds__(128 * OH_WG, 1) pr_onehot_wgmma(
    const float* __restrict__ table, const int* __restrict__ idx,
    float* __restrict__ out, int rows, int width, int S, int per) {
  extern __shared__ __align__(128) unsigned char oh_smem[];
  unsigned char* b_s = oh_smem;  // [2][OH_B_BYTES]
  float* f_s = reinterpret_cast<float*>(oh_smem + 2 * OH_B_BYTES);  // [STAGES][KC][N]
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int n0 = blockIdx.x * OH_N;
  const int klo = blockIdx.y * per * OH_KC, khi = min(klo + per * OH_KC, rows);
  const int nc = (khi - klo) / OH_KC;
  // This thread's eight rows, each once: r, its index's offset in the
  // range; kq = r >> 3 (chunk << 3 | register slot 2 step + (q >> 1)) where
  // its 1 lies in this thread's registers, else -1; val, bf16 1.0 in the
  // register's low or high half; own, bit 2 mt + h where the range holds it.
  int kq[OH_MT][2];
  unsigned val[OH_MT][2], own = 0;
#pragma unroll
  for (int mt = 0; mt < OH_MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wg * OH_MT + mt) * 64 + warp * 16 + g + 8 * h;
      const int r = (m < S ? idx[m] : -1) - klo;
      const bool in = (unsigned)r < (unsigned)(khi - klo);
      own |= (unsigned)in << (2 * mt + h);
      kq[mt][h] = in && ((r >> 1) & 3) == t ? r >> 3 : -1;
      val[mt][h] = 0x3F80u << ((r & 1) << 4);
    }
  auto load = [&](int c) {  // chunk c's f32 rows into its stage
    if (c < nc) {
      const float* src = table + (size_t)(klo + c * OH_KC) * width + n0;
      float* dst = f_s + (c % OH_STAGES) * OH_KC * OH_N;
#pragma unroll
      for (int i = 0; i < OH_KC * OH_N / 4 / (128 * OH_WG); ++i) {
        const int e = tid + 128 * OH_WG * i, k = e / (OH_N / 4), q = 4 * (e % (OH_N / 4));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_u32(dst + k * OH_N + q)),
                     "l"(src + (size_t)k * width + q)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto convert = [&](int c) {  // chunk c's stage -> bf16 tile c & 1
    const float* src = f_s + (c % OH_STAGES) * OH_KC * OH_N;
    unsigned char* dst = b_s + (c & 1) * OH_B_BYTES;
#pragma unroll
    for (int i = 0; i < OH_KC / 8 * OH_N / (128 * OH_WG); ++i) {
      const int e = tid + 128 * OH_WG * i, n = e % OH_N, k = 8 * (e / OH_N);
      unsigned w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            src[(k + 2 * j) * OH_N + n], src[(k + 2 * j + 1) * OH_N + n]);
        w[j] = *reinterpret_cast<const unsigned*>(&v);
      }
      *reinterpret_cast<uint4*>(dst + oh_b_off(k, n)) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    // the tile is written by threads and read by the tensor cores (the
    // async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  float acc[OH_MT][32];
#pragma unroll
  for (int mt = 0; mt < OH_MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;
  load(0);
  load(1);
  load(2);
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  __syncthreads();
  convert(0);
  __syncthreads();
  const unsigned b_addr = smem_u32(b_s);
  unsigned a[OH_MT][4][4];  // [m-tile][k16 step][register]
  // no instruction but a product touches the accumulators from here to the
  // last wait (ptxas serializes the products otherwise)
#pragma unroll
  for (int mt = 0; mt < OH_MT; ++mt) pin(acc[mt]);
  // A group an m-tile, up to four in flight: an m-tile's A registers are
  // built while the three groups before it run, and chunk c + 1 is
  // converted while chunk c's last three do.
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
#pragma unroll
    for (int mt = 0; mt < OH_MT; ++mt)
      oh_group(acc[mt], a[mt], kq[mt], val[mt], c, b_addr + (c & 1) * OH_B_BYTES);
    if (c + 1 < nc) {
      // chunk c - 1's groups are done in this warpgroup, so tile (c + 1) & 1
      // is free once both warpgroups pass the barrier; chunk c + 1 landed
      // (c + 2 may still be in flight)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
      convert(c + 1);
      load(c + 3);  // into chunk c's stage, converted before the last barrier
      __syncthreads();  // tile (c + 1) & 1 written by all
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int mt = 0; mt < OH_MT; ++mt) pin(acc[mt]);
#pragma unroll
  for (int mt = 0; mt < OH_MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!(own >> (2 * mt + h) & 1)) continue;  // another range's row
      const int m = (wg * OH_MT + mt) * 64 + warp * 16 + g + 8 * h;
      float* o = out + (size_t)m * width + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < OH_N / 8; ++j)
        *reinterpret_cast<float2*>(o + 8 * j) =
            make_float2(acc[mt][4 * j + 2 * h], acc[mt][4 * j + 2 * h + 1]);
    }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// table [rows, width] i32, idx [S] i32, out [S, width] i32; arm 0: the
// output flat, a word a thread (pr_row_gather), arm 1: a thread a row.
extern "C" int cpx_pr_row_gather_launch(const void* table, const void* idx,
                                        void* out, int rows, int width, int S,
                                        int arm, void* stream) {
  if (rows < 1 || width < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const bool vec = width % 4 == 0 && aligned16(table) && aligned16(out);
  if (arm == 1) {
    pr_row_thread<<<(S + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const int*)table, (const int*)idx, (int*)out, width, S, vec);
    return (int)cudaGetLastError();
  }
  const int words = vec ? width / 4 : width;
  const long long n = (long long)S * words, per = GATHER_THREADS * GATHER_WPT;
  if (n > INT_MAX - per) return (int)cudaErrorInvalidValue;
  auto kernel = vec ? pr_row_gather<true> : pr_row_gather<false>;
  kernel<<<(int)((n + per - 1) / per), GATHER_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)table, (const int*)idx, (int*)out, words, (int)n);
  return (int)cudaGetLastError();
}

// flat [n] i32, idx [S] i32, out [S] i32.
extern "C" int cpx_pr_elem_gather_launch(const void* flat, const void* idx,
                                         void* out, int n, int S, void* stream) {
  if (n < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  pr_elem_gather<<<(S + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const int*)flat, (const int*)idx, (int*)out, n, S);
  return (int)cudaGetLastError();
}

// The shared memory of a CTA of P3's bulk copies, min(BULK_R, S) rows of
// `width` int32 (saturated at INT_MAX): what the wrapper checks.
extern "C" int cpx_pr_row_bulk_smem(int width, int S) {
  const long long smem = (long long)(S < BULK_R ? S : BULK_R) * width * 4;
  return smem < INT_MAX ? (int)smem : INT_MAX;
}

// table [rows, width] i32, idx [S] i32, out [S, width] i32; BULK_R rows a
// CTA by bulk copies: width a multiple of 4, table and out 16-byte aligned,
// min(BULK_R, S) rows within 48 KB.
extern "C" int cpx_pr_row_bulk_launch(const void* table, const void* idx,
                                      void* out, int rows, int width, int S,
                                      void* stream) {
  const int smem = cpx_pr_row_bulk_smem(width, S);
  if (rows < 1 || S < 1 || width < 4 || width % 4 || smem > 48 * 1024 ||
      !aligned16(table) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  pr_row_bulk<<<(S + BULK_R - 1) / BULK_R, 1, smem, (cudaStream_t)stream>>>(
      (const int*)table, (const int*)idx, (int*)out, width, S);
  return (int)cudaGetLastError();
}

// table [rows, width] i32, idx [S] i32, out [S, width] i32; one warp.
extern "C" int cpx_pr_row_loop_launch(const void* table, const void* idx,
                                      void* out, int rows, int width, int S,
                                      void* stream) {
  if (rows < 1 || width < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const bool vec = width % 4 == 0 && aligned16(table) && aligned16(out);
  pr_row_loop<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const int*)table, (const int*)idx, (int*)out, rows, width, S, vec);
  return (int)cudaGetLastError();
}

static int lane_blocks(int S, int* threads) {
  *threads = S < 1024 ? (S + 31) / 32 * 32 : 1024;
  return (S + *threads - 1) / *threads;
}

// table [rows, width] f32, out [S] f32: T steps from zero in one launch;
// column 0 (rows x 4 B) within STEPS_SMEM_MAX.
extern "C" int cpx_pr_steps_launch(const void* table, void* out, int rows,
                                   int width, int S, int T, void* stream) {
  if (rows < 1 || width < 1 || S < 1 || T < 0 || rows > STEPS_SMEM_MAX / 4)
    return (int)cudaErrorInvalidValue;
  const int smem = rows * 4;
  if (smem > 48 * 1024) {
    // above 48 KB only once the kernel's limit is raised, once a device
    static bool raised[64];
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!raised[dev]) {
      err = cudaFuncSetAttribute(pr_steps, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 STEPS_SMEM_MAX);
      if (err != cudaSuccess) return (int)err;
      raised[dev] = true;
    }
  }
  pr_steps<<<(S + STEPS_LANES - 1) / STEPS_LANES, STEPS_LANES, smem,
             (cudaStream_t)stream>>>((const float*)table, (float*)out, rows, width, S, T);
  return (int)cudaGetLastError();
}

// table [rows, width] f32, state [S] f32 (one step, in place).
extern "C" int cpx_pr_step_launch(const void* table, void* state, int rows,
                                  int width, int S, void* stream) {
  if (rows < 1 || width < 1 || S < 1) return (int)cudaErrorInvalidValue;
  int threads;
  const int blocks = lane_blocks(S, &threads);
  pr_step<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (float*)state, rows, width, S);
  return (int)cudaGetLastError();
}

// One CTA of 32 threads that does nothing.
extern "C" int cpx_pr_empty_launch(void* stream) {
  pr_empty<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The shared memory of a CTA of P5's and P9's ring, at depth 16 or 32:
// min(depth, RING_R, S) rows of `width` int32 and their barriers, and the
// CTA's min(RING_R, S) indices (saturated at INT_MAX): what the wrapper
// checks.
extern "C" int cpx_pr_row_ring_smem(int width, int S, int depth) {
  const int slots = ring_slots(depth, S), n = RING_R < S ? RING_R : S;
  const long long smem = (long long)slots * ((long long)width * 4 + 8) + 4LL * n;
  return smem < INT_MAX ? (int)smem : INT_MAX;
}

// table [rows, width] i32, idx [S] i32, out [S, width] i32; depth 16 or 32;
// width a multiple of 4 up to 4096, table and out 16-byte aligned, a CTA's
// ring and indices within 48 KB.
extern "C" int cpx_pr_row_ring_launch(const void* table, const void* idx,
                                      void* out, int rows, int width, int S,
                                      int depth, void* stream) {
  if (rows < 1 || S < 1 || width < 4 || width % 4 || width > 4096 ||
      (depth != 16 && depth != 32) || !aligned16(table) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const int smem = cpx_pr_row_ring_smem(width, S, depth);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = depth == 16 ? pr_row_ring<16> : pr_row_ring<32>;
  kernel<<<(S + RING_R - 1) / RING_R, 32, smem, (cudaStream_t)stream>>>(
      (const int*)table, (const int*)idx, (int*)out, width, S);
  return (int)cudaGetLastError();
}

// table [rows, width] f32, idx [S] i32 (in [0, rows)), out [S, width] f32;
// rows and width multiples of 64, S in [1, 512], a 16-byte aligned table.
// The grid: width / 64 column slices x the K ranges, each range `per`
// chunks, so that the grid fills the card's SMs.
extern "C" int cpx_pr_onehot_wgmma_launch(const void* table, const void* idx,
                                          void* out, int rows, int width, int S,
                                          void* stream) {
  if (rows < OH_KC || width < OH_N || rows % OH_KC || width % OH_N || S < 1 ||
      S > OH_S || !aligned16(table) || ((uintptr_t)out & 7))
    return (int)cudaErrorInvalidValue;
  // a device's SM count, read once with the shared-memory attribute set
  static int sms_of[64];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms_of[dev]) {
    int sms;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(pr_onehot_wgmma,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, OH_SMEM);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev] = sms;
  }
  const int sms = sms_of[dev];
  const int chunks = rows / OH_KC, fit = sms / (width / OH_N);
  const int want = fit > 1 ? fit : 1;
  const int per = (chunks + want - 1) / want, ranges = (chunks + per - 1) / per;
  pr_onehot_wgmma<<<dim3(width / OH_N, ranges), 128 * OH_WG, OH_SMEM,
                    (cudaStream_t)stream>>>((const float*)table, (const int*)idx,
                                            (float*)out, rows, width, S, per);
  return (int)cudaGetLastError();
}
