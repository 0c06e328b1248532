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
//
// K3p, the emission mask's bit-pack (block.py:1965-1969), follows K3 on
// every adaptive encode: emit [T, n_slots, S] bytes (0 or 1) -> [T,
// n_slots, S/8] bytes, bit k of byte j the flag of lane 8j + k (the order
// np.unpackbits(..., bitorder="little") reads back, 2256-2260), so the
// host copies an eighth of the mask.  A thread packs one byte from one
// 8-byte load: the eight flags are bits 0, 8, .., 56 of the word, and one
// multiply by 2^56 + 2^49 + .. + 2^7 gathers bit 8k into bit 56 + k, every
// partial product at a bit of its own (no carry).  Bound: bytes, 9/8 of
// the mask.
#include "ppm_r.cuh"

namespace {

__global__ void k3_kernel(int S, int T, int n_slots, const int* __restrict__ ev,
                          long long* __restrict__ states,
                          uint8_t* __restrict__ emit, int* __restrict__ words) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  // block blockIdx.y of the launch: its events, states and outputs
  const long long cells = (long long)T * n_slots * S;
  ev = at_blk(ev, 3 * cells);
  states = at_blk(states, S);
  emit = at_blk(emit, cells);
  words = at_blk(words, cells);
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

__global__ void k3p_kernel(int n_out, const uint64_t* __restrict__ emit,
                           uint8_t* __restrict__ packed) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_out) return;
  const uint64_t flags = emit[j] & 0x0101010101010101ull;
  packed[j] = (uint8_t)((flags * 0x0102040810204080ull) >> 56);
}

}  // namespace

// emit: n_out * 8 flag bytes (8-byte aligned) -> packed: n_out bytes (G
// blocks' masks at once: S is a multiple of 8, so the flat pack is each
// block's).
extern "C" int cpx_k3p_launch(int n_out, const void* emit, void* packed, void* stream) {
  if (n_out < 1 || ((uintptr_t)emit & 7)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  k3p_kernel<<<(n_out + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      n_out, (const uint64_t*)emit, (uint8_t*)packed);
  return (int)cudaGetLastError();
}

// ev [T, 3 * n_slots, S] -> states [S], emit and words [T, n_slots, S];
// G blocks (the block axis): each [G, ...], a thread a lane of each block.
extern "C" int cpx_k3_launch(int G, int S, int T, int n_slots, const void* ev,
                             void* states, void* emit, void* words,
                             void* stream) {
  if (n_slots < 1 || G < 1 || G > 65535) return (int)cudaErrorInvalidValue;
  int threads = 128;
  const dim3 blocks((S + threads - 1) / threads, G);
  k3_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      S, T, n_slots, (const int*)ev, (long long*)states, (uint8_t*)emit,
      (int*)words);
  return (int)cudaGetLastError();
}
