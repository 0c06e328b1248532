// K3: the backward rANS scan of encode.
//
// Replaces the rans_body scan of comprox_tpu/codec/block.py::_encode_passes
// (1945-1969): from the last step to the first, and within a step over the
// slots from the last to the first (C, B, A; mode X: E, D, C, B, A), every
// lane puts its (c, f) event (the identity event where inactive) and emits
// at most one u16 word.  The compaction of the emitted words into the
// (step, slot, lane) stream stays on the host, as in the JAX package
// (_pack_payload).
//
// Bound on the H100: lanes are independent, so the whole scan is one
// dependent chain of n_slots * T puts per lane: a 32-bit division per put
// on the critical path.  It reads ev once and writes emit/words once (~17
// bytes per slot, step and lane), coalesced across the lanes of a warp.
// The design gives each lane its own thread and spreads the lanes over
// 128-thread CTAs; one block of S=512 lanes fills only 4 SMs.
#include "ppm_r.cuh"

namespace {

__global__ void k3_kernel(int S, int T, int n_slots, const int* __restrict__ ev,
                          long long* __restrict__ states,
                          uint8_t* __restrict__ emit, int* __restrict__ words) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  uint32_t x = RANS_L;
  for (int t = T - 1; t >= 0; --t) {
    for (int si = n_slots - 1; si >= 0; --si) {
      const int* e = ev + ((size_t)t * 3 * n_slots + 3 * si) * S + i;
      uint32_t c = 0, f = RANS_M;
      if (e[2 * S]) {
        c = (uint32_t)e[0] & 0xFFFFu;
        f = max((uint32_t)e[S] & 0xFFFFu, 1u);
      }
      bool em = (x >> (32 - M_BITS)) >= f;
      size_t o = ((size_t)t * n_slots + si) * S + i;
      emit[o] = em;
      words[o] = (int)(x & 0xFFFFu);
      if (em) x >>= 16;
      x = ((x / f) << M_BITS) + c + (x % f);
    }
  }
  states[i] = (long long)x;
}

}  // namespace

// ev [T, 3 * n_slots, S] -> states [S], emit and words [T, n_slots, S].
extern "C" int cpx_k3_launch(int S, int T, int n_slots, const void* ev,
                             void* states, void* emit, void* words,
                             void* stream) {
  if (n_slots < 1) return (int)cudaErrorInvalidValue;
  int threads = 128;
  int blocks = (S + threads - 1) / threads;
  k3_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      S, T, n_slots, (const int*)ev, (long long*)states, (uint8_t*)emit,
      (int*)words);
  return (int)cudaGetLastError();
}
