// The nine Pallas probes of benchmarks/pallas_probe.py and pallas_probe2.py
// as Hopper kernels: six bodies (comprox_tpu_torch/benchmarks/probes.py
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- P1, P6
// Replaces pallas_probe.py::probe_vmem_gather (kernel :51, pallas_call :56)
// and pallas_probe2.py::probe_taa (kernel :45, pallas_call :51): out[k, :] =
// table[idx[k], :].  Bound by load latency (one dependent index load, then
// the row): WARP_PER_ROW puts one warp on a row, 16-byte loads across its
// lanes where the width allows, so a row of 128 int32 is one coalesced
// request; the other arm gives each thread a whole row (uncoalesced), to
// time the difference.
template <bool WARP_PER_ROW>
__global__ void pr_row_gather(const int* __restrict__ table,
                              const int* __restrict__ idx, int* __restrict__ out,
                              int rows, int width, int S, bool vec) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = WARP_PER_ROW ? g >> 5 : g;
  if (k >= S) return;
  const int first = WARP_PER_ROW ? (threadIdx.x & 31) : 0;
  const int step = WARP_PER_ROW ? 32 : 1;
  const size_t r = idx[k];
  if (vec) {
    const int4* src = reinterpret_cast<const int4*>(table + r * width);
    int4* dst = reinterpret_cast<int4*>(out + (size_t)k * width);
    for (int j = first; j < width / 4; j += step) dst[j] = src[j];
  } else {
    for (int j = first; j < width; j += step)
      out[(size_t)k * width + j] = table[r * width + j];
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
// One warp walks the rows in order and the loop is not unrolled, so each
// row waits for its index load and its row load: the serial-issue floor,
// about two L2 latencies a row.
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
// s += table[int(s) & (rows - 1), 0], the state f32 from zero.  The TPU
// read the row by a one-hot dot; the value is the same (the table holds
// small integers, exact in f32).  pr_steps keeps all T steps in one
// persistent CTA (each step one dependent L2 load); pr_step is one step a
// launch, for the launch-per-step arm (directly, or replayed from a CUDA
// graph).
__global__ void pr_steps(const float* __restrict__ table, float* __restrict__ out,
                         int rows, int width, int S, int T) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= S) return;
  float s = 0.f;
#pragma unroll 1
  for (int t = 0; t < T; ++t) s += table[(size_t)((int)s & (rows - 1)) * width];
  out[k] = s;
}

__global__ void pr_step(const float* __restrict__ table, float* __restrict__ state,
                        int rows, int width, int S) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < S) state[k] += table[(size_t)((int)state[k] & (rows - 1)) * width];
}

// ---------------------------------------------------------------- P5, P9
// Replaces pallas_probe.py::probe_dma_depth (kernel :247, pallas_call :272)
// and pallas_probe2.py::probe_dma (kernel :174, pallas_call :203): rows of
// a 64 MiB table in device memory through a ring of DEPTH copies in flight.
// One CTA; thread j owns the 16-byte chunk j of every row, so each thread
// runs its own ring of cp.async copies, one commit group a row (empty past
// the last row, so that wait_group DEPTH - 1 always means "row k landed").
// A thread reads slot k % DEPTH into a register and stores it to out
// before it starts row k + DEPTH into that slot, so no copy overwrites a
// slot that is still to be read (the JAX kernels start that copy first).
// Bound by DEPTH rows in flight against the device-memory latency; the
// indices are staged in shared memory first (the TPU's scalar prefetch).
template <int DEPTH>
__global__ void pr_row_ring(const int* __restrict__ table,
                            const int* __restrict__ idx, int* __restrict__ out,
                            int rows, int width, int S) {
  extern __shared__ __align__(16) int smem[];
  int4* ring = reinterpret_cast<int4*>(smem);  // [DEPTH][width / 4]
  int* rid = smem + DEPTH * width;              // [S]
  const int j = threadIdx.x, chunks = width / 4;
  for (int k = j; k < S; k += blockDim.x) rid[k] = idx[k];
  __syncthreads();
  auto start = [&](int k) {
    if (k < S) {
      const unsigned slot = (unsigned)__cvta_generic_to_shared(
          ring + (k % DEPTH) * chunks + j);
      const int4* src =
          reinterpret_cast<const int4*>(table + (size_t)rid[k] * width) + j;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(slot),
                   "l"(src)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int k = 0; k < DEPTH; ++k) start(k);
  int4* dst = reinterpret_cast<int4*>(out) + j;
#pragma unroll 1
  for (int k = 0; k < S; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(DEPTH - 1) : "memory");
    dst[(size_t)k * chunks] = ring[(k % DEPTH) * chunks + j];
    start(k + DEPTH);
  }
}

// ---------------------------------------------------------------- P8
// Replaces pallas_probe2.py::probe_kernel_onehot (kernel :130, pallas_call
// :142): out = onehot(idx) [S, rows] (bf16, built in the kernel) times the
// f32 table cast to bf16, accumulated in f32 on the tensor cores.  With
// one 1 a row the result is exactly bf16(table)[idx].  A CTA of four warps
// owns a 64 x 64 output block and walks K = rows in chunks of 64: it builds
// the one-hot A chunk from the staged indices and converts the B chunk
// f32 -> bf16 (__float2bfloat16: round to nearest even, as XLA's convert)
// into shared memory, then each warp runs wmma 16x16x16 bf16 products for
// its 16 rows.  The function is bound by its 2 * S * rows * width bf16
// operations (3.26 us at 8192 x 384); the kernel also reads the whole f32
// table (12.6 MB, which bf16(table)[idx] does not need), every CTA its 64
// columns of it from L2, each thread's 32 loads of a chunk issued together.
constexpr int OH_BLK = 64;

__global__ void __launch_bounds__(128) pr_onehot_mma(
    const float* __restrict__ table, const int* __restrict__ idx,
    float* __restrict__ out, int rows, int width) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 a_s[OH_BLK * OH_BLK];
  __shared__ __align__(32) __nv_bfloat16 b_s[OH_BLK * OH_BLK];
  __shared__ int id_s[OH_BLK];
  const int row0 = blockIdx.x * OH_BLK, col0 = blockIdx.y * OH_BLK;
  const int tid = threadIdx.x, warp = tid >> 5;
  if (tid < OH_BLK) id_s[tid] = idx[row0 + tid];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[OH_BLK / 16];
  for (int c = 0; c < OH_BLK / 16; ++c) wmma::fill_fragment(acc[c], 0.f);
  const __nv_bfloat16 one = __float2bfloat16(1.f), zero = __float2bfloat16(0.f);
  constexpr int PER = OH_BLK * OH_BLK / 128;  // elements a thread stages
  for (int k0 = 0; k0 < rows; k0 += OH_BLK) {
    float v[PER];  // all of a thread's loads in flight before any is used
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + 128 * i;
      v[i] = table[(size_t)(k0 + e / OH_BLK) * width + col0 + e % OH_BLK];
    }
    __syncthreads();  // the chunk before is consumed (and id_s is written)
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + 128 * i;
      a_s[e] = id_s[e / OH_BLK] == k0 + e % OH_BLK ? one : zero;
      b_s[e] = __float2bfloat16(v[i]);
    }
    __syncthreads();
    for (int kk = 0; kk < OH_BLK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_s + warp * 16 * OH_BLK + kk, OH_BLK);
      for (int c = 0; c < OH_BLK / 16; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, b_s + kk * OH_BLK + c * 16, OH_BLK);
        wmma::mma_sync(acc[c], a, b, acc[c]);
      }
    }
  }
  for (int c = 0; c < OH_BLK / 16; ++c)
    wmma::store_matrix_sync(
        out + (size_t)(row0 + warp * 16) * width + col0 + c * 16, acc[c], width,
        wmma::mem_row_major);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// table [rows, width] i32, idx [S] i32, out [S, width] i32; arm 0: a warp a
// row, arm 1: a thread a row.
extern "C" int cpx_pr_row_gather_launch(const void* table, const void* idx,
                                        void* out, int rows, int width, int S,
                                        int arm, void* stream) {
  if (rows < 1 || width < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const bool vec = width % 4 == 0 && aligned16(table) && aligned16(out);
  const int threads = 128;
  const long long work = arm == 0 ? 32LL * S : S;
  const int blocks = (int)((work + threads - 1) / threads);
  auto kernel = arm == 0 ? pr_row_gather<true> : pr_row_gather<false>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)table, (const int*)idx, (int*)out, rows, width, S, vec);
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

// table [rows, width] f32, out [S] f32: T steps from zero in one launch.
extern "C" int cpx_pr_steps_launch(const void* table, void* out, int rows,
                                   int width, int S, int T, void* stream) {
  if (rows < 1 || width < 1 || S < 1 || T < 0) return (int)cudaErrorInvalidValue;
  int threads;
  const int blocks = lane_blocks(S, &threads);
  pr_steps<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (float*)out, rows, width, S, T);
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

// Shared memory of pr_row_ring: the ring and the staged indices.
static int ring_smem(int width, int S, int depth) {
  return (depth * width + S) * (int)sizeof(int);
}

// table [rows, width] i32, idx [S] i32, out [S, width] i32; depth 16 or 32;
// width a multiple of 4 up to 4096, 16-byte aligned, the ring and the
// indices within 48 KB.
extern "C" int cpx_pr_row_ring_launch(const void* table, const void* idx,
                                      void* out, int rows, int width, int S,
                                      int depth, void* stream) {
  const int smem = ring_smem(width, S, depth);
  if (rows < 1 || S < 1 || width < 4 || width % 4 || width > 4096 ||
      smem > 48 * 1024 || !aligned16(table) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  auto kernel = depth == 16 ? pr_row_ring<16> : depth == 32 ? pr_row_ring<32> : nullptr;
  if (!kernel) return (int)cudaErrorInvalidValue;
  kernel<<<1, width / 4, smem, (cudaStream_t)stream>>>(
      (const int*)table, (const int*)idx, (int*)out, rows, width, S);
  return (int)cudaGetLastError();
}

// table [rows, width] f32, idx [S] i32 (in [0, rows)), out [S, width] f32;
// S, rows and width multiples of 64.
extern "C" int cpx_pr_onehot_mma_launch(const void* table, const void* idx,
                                        void* out, int rows, int width, int S,
                                        void* stream) {
  if (rows < OH_BLK || S < OH_BLK || width < OH_BLK || rows % OH_BLK ||
      S % OH_BLK || width % OH_BLK)
    return (int)cudaErrorInvalidValue;
  pr_onehot_mma<<<dim3(S / OH_BLK, width / OH_BLK), 128, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, (float*)out, rows, width);
  return (int)cudaGetLastError();
}
