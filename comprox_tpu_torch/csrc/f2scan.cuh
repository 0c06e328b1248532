// Prefix scans over the whole block, shared by the mode-F tokenizer (K8,
// f2tok.cu) and decoder (K10, f2dec.cu); the CTA scan also by the stream
// compaction of every adaptive encode (K3b, rans.cu; its counts only) and
// by K9's normalisation (f2enc.cu).
//
// One scan carries two values per position: a count (how many token starts
// lie before it) and "the last nonzero value before it" (the previous match
// distance).  Both are associative, so a scan over N positions is three
// launches: every CTA reduces its tile of SCAN_TILE positions to one pair;
// one CTA turns the tile pairs into exclusive prefixes (scan_parts); every
// CTA scans its tile again from its prefix and uses the result.  This is
// what JAX's Hillis-Steele doubling passes (fast.py::_flat_excl_cumsum,
// _last_nonzero_fill) and its one-bit stable sort compute.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define SCAN_THREADS 256
#define SCAN_PER 8  // consecutive positions per thread
#define SCAN_TILE (SCAN_THREADS * SCAN_PER)  // fast.py::SCAN_TILE

struct CountLast {
  int cnt, last;
};

// a's positions come before b's
static __device__ __forceinline__ CountLast combine(CountLast a, CountLast b) {
  return CountLast{a.cnt + b.cnt, b.last ? b.last : a.last};
}

// Exclusive prefix, in thread order, of every thread's v across the CTA.
// Call by every thread (whole warps, up to 1024 threads); wsum is a shared
// [32] scratch this call owns until the next barrier after it.  total =
// all threads' v combined.
static __device__ CountLast cta_excl_scan(CountLast v, CountLast* wsum,
                                          CountLast& total) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  CountLast inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const CountLast o{__shfl_up_sync(full, inc.cnt, off),
                      __shfl_up_sync(full, inc.last, off)};
    if (lane >= off) inc = combine(o, inc);
  }
  if (lane == 31) wsum[warp] = inc;
  CountLast ex{__shfl_up_sync(full, inc.cnt, 1), __shfl_up_sync(full, inc.last, 1)};
  if (lane == 0) ex = CountLast{0, 0};
  __syncthreads();
  // every warp scans the warp sums, lane k holding warp k's
  CountLast ws = lane < nwarps ? wsum[lane] : CountLast{0, 0};
  for (int off = 1; off < 32; off <<= 1) {
    const CountLast o{__shfl_up_sync(full, ws.cnt, off),
                      __shfl_up_sync(full, ws.last, off)};
    if (lane >= off) ws = combine(o, ws);
  }
  total = CountLast{__shfl_sync(full, ws.cnt, nwarps - 1),
                    __shfl_sync(full, ws.last, nwarps - 1)};
  const int from = warp > 0 ? warp - 1 : 0;
  CountLast before{__shfl_sync(full, ws.cnt, from), __shfl_sync(full, ws.last, from)};
  if (warp == 0) before = CountLast{0, 0};
  return combine(before, ex);
}

// In place: parts[0 .. n) -> their exclusive prefixes, parts[n] = the
// total; one CTA of 1024 threads.
// The parts pass through shared memory SCAN_PARTS_TILE at a time, read and
// written coalesced (a thread's loads of a tile all issued before the
// first is stored), each thread scanning SCAN_PARTS_TILE / 1024
// consecutive ones.
#define SCAN_PARTS_TILE 4096
static __global__ void __launch_bounds__(1024) scan_parts(CountLast* __restrict__ parts,
                                                          int n) {
  __shared__ CountLast tile[SCAN_PARTS_TILE];
  __shared__ CountLast wsum[32];
  constexpr int per = SCAN_PARTS_TILE / 1024;
  const int tid = threadIdx.x;
  CountLast carry{0, 0};
  for (int b = 0; b < n; b += SCAN_PARTS_TILE) {
    const int m = min(SCAN_PARTS_TILE, n - b);
    CountLast in[per];
#pragma unroll
    for (int j = 0; j < per; ++j)
      if (tid + j * 1024 < m) in[j] = parts[b + tid + j * 1024];
#pragma unroll
    for (int j = 0; j < per; ++j)
      if (tid + j * 1024 < m) tile[tid + j * 1024] = in[j];
    __syncthreads();
    CountLast s{0, 0};
#pragma unroll
    for (int j = 0; j < per; ++j)
      if (per * tid + j < m) s = combine(s, tile[per * tid + j]);
    CountLast total;
    CountLast run = combine(carry, cta_excl_scan(s, wsum, total));
#pragma unroll
    for (int j = 0; j < per; ++j) {
      if (per * tid + j < m) {
        const CountLast v = tile[per * tid + j];
        tile[per * tid + j] = run;
        run = combine(run, v);
      }
    }
    carry = combine(carry, total);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < per; ++j)
      if (tid + j * 1024 < m) parts[b + tid + j * 1024] = tile[tid + j * 1024];
    __syncthreads();  // the tile and wsum are the next round's
  }
  if (tid == 0) parts[n] = carry;
}
