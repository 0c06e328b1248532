// KCR: the chain mode's bucket-table remap (crz -C).
//
// Replaces comprox_tpu/codec/block.py::_remap_chain_ment (1255-1262), which
// both sides run at every chained block boundary (1271, 1925, 2225): the
// carried bucket table's positions are absolute in the [prev | cur] window
// of 2N bytes, so one block later each entry's position q becomes
// max(q - N, 0): the entries of the block just coded land in the previous
// block's region [1, N], anything older dies (0 = empty) and its 4-byte
// prefix cache is cleared.
//
// Bound on the H100: elementwise, one read and one write of the table
// ([2^bits, D, 2] int32: 134 MB each way at the main geometry), so memory
// bandwidth bounds it.  A thread remaps one (position, prefix) pair with an
// 8-byte load and store, coalesced across the warp; out may be in.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void kcr_kernel(int n, int cap, const int2* in, int2* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int2 e = in[i];
  const int pos = max(e.x - cap, 0);
  out[i] = make_int2(pos, pos > 0 ? e.y : 0);
}

}  // namespace

// in, out: n (position, prefix) pairs; cap = N, the block's capacity.
extern "C" int cpx_kcr_launch(int n, int cap, const void* in, void* out, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  kcr_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      n, cap, (const int2*)in, (int2*)out);
  return (int)cudaGetLastError();
}
