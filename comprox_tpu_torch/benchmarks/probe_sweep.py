"""The sweep that fixes P1's and P6's threads a CTA and words a thread
(``csrc/probes.cu``'s ``GATHER_THREADS``, ``GATHER_WPT``) and P4's lanes a
CTA (``STEPS_LANES``) on the card.

Each configuration is ``probes.cu`` with those three constants replaced,
compiled by ``nvcc`` on its own into ``build/probe_sweep/`` (all builds
started together) and loaded with ``ctypes``.  Its gather launcher is
timed at P1's and P6's shapes ([8192x256], [512x260], [2048x128],
[8192x128], [65536x128], [65536x8]; S = 512) and its steps launcher at
P4's ([2048x128], S = 512, T = 512), by :func:`probes.timeit`, each
configuration in turn, in two rounds (forward, then back); every result
must equal its plain version; ``index_select`` at each gather shape is
timed in each round beside them.

Then P4's chain alone: ``pr_steps``' loop (the same source line, column 0
staged in shared memory) with ``clock64()`` read around a lane's T steps,
at one lane, one warp, and the lanes a CTA of the sweep, the SM cycles a
step of each lane printed as their mean and maximum.  One lane alone gives
the step's dependent latency (LDS, FADD, F2I, LOP3, LEA in the SASS), so
512 of them over the SM clock is the chain's floor.  On the card::

    python -m comprox_tpu_torch.benchmarks.probe_sweep
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from comprox_tpu_torch.benchmarks import probes
from comprox_tpu_torch.codec.block import _stream_ptr
from comprox_tpu_torch.utils import build

SWEEP_DIR = Path(__file__).resolve().parents[2] / "build" / "probe_sweep"
# (GATHER_THREADS, GATHER_WPT, STEPS_LANES)
GATHER = [(t, w, 128) for t in (64, 128, 256, 512, 1024) for w in (1, 2)]
STEPS = [(256, 1, lanes) for lanes in (32, 64, 128, 256, 512)]
# (CTAs, lanes a CTA) of the chain's clock
CHAIN = [(1, 1), (1, 32), (4, 128), (2, 256), (1, 512)]
CHAIN_SRC = r"""
#include <cuda_runtime.h>
__global__ void chain_clock(const float* __restrict__ table, int rows, int width, int T,
                            long long* __restrict__ cycles, float* __restrict__ out) {
  extern __shared__ float col[];
  for (int r = threadIdx.x; r < rows; r += blockDim.x) col[r] = table[(size_t)r * width];
  __syncthreads();
  const int mask = rows - 1, k = blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.f;
  const long long t0 = clock64();
#pragma unroll 4
  for (int t = 0; t < T; ++t) s += col[(int)s & mask];
  out[k] = s;
  cycles[k] = clock64() - t0;
}
extern "C" int chain_clock_launch(const void* table, int rows, int width, int T,
                                  void* cycles, void* out, int ctas, int lanes) {
  chain_clock<<<ctas, lanes, rows * 4>>>((const float*)table, rows, width, T,
                                         (long long*)cycles, (float*)out);
  return (int)cudaDeviceSynchronize();
}
"""
GATHER_SHAPES = [(8192, 256), (512, 260), (2048, 128), (8192, 128), (65536, 128),
                 (65536, 8)]


def _tag(cfg) -> str:
    return "t{}_w{}_l{}".format(*cfg)


def _source(cfg) -> str:
    src = (build.CSRC / "probes.cu").read_text()
    for name, v in zip(("GATHER_THREADS", "GATHER_WPT", "STEPS_LANES"), cfg):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {v};", src)
        if n != 1:
            raise RuntimeError(f"probes.cu: constexpr int {name} not found once")
    return src


def build_all(configs) -> dict:
    """{config: its loaded library}, every nvcc started together."""
    procs = []
    for cfg in configs:
        d = SWEEP_DIR / _tag(cfg)
        d.mkdir(parents=True, exist_ok=True)
        (d / "probes.cu").write_text(_source(cfg))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "probes.cu")]
        procs.append((cfg, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    libs = {}
    try:
        for cfg, proc in procs:
            _, err = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {_tag(cfg)}:\n{err}")
            lib = ctypes.CDLL(str(SWEEP_DIR / _tag(cfg) / "lib.so"))
            for name in ("cpx_pr_row_gather_launch", "cpx_pr_steps_launch"):
                getattr(lib, name).argtypes = build._SIGNATURES[name]
                getattr(lib, name).restype = ctypes.c_int
            libs[cfg] = lib
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs


def build_chain():
    """The chain's clock kernel, built on its own."""
    d = SWEEP_DIR / "chain"
    d.mkdir(parents=True, exist_ok=True)
    (d / "chain.cu").write_text(CHAIN_SRC)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
                    str(d / "chain.cu")], check=True, timeout=build.NVCC_TIMEOUT_S)
    lib = ctypes.CDLL(str(d / "lib.so"))
    lib.chain_clock_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    lib.chain_clock_launch.restype = ctypes.c_int
    return lib


def chain(lib, table) -> dict:
    """{(CTAs, lanes a CTA): (mean, max) SM cycles a step of a lane}; each
    lane's state must equal ``steps_plain``'s."""
    res = {}
    for ctas, lanes in CHAIN:
        n = ctas * lanes
        cycles = torch.empty(n, dtype=torch.int64, device="cuda")
        out = torch.empty(n, dtype=torch.float32, device="cuda")
        for _ in range(2):  # the second run's clocks
            build.check(lib.chain_clock_launch(table.data_ptr(), *table.shape, probes.STEPS,
                                               cycles.data_ptr(), out.data_ptr(), ctas,
                                               lanes), "chain_clock")
        if not torch.equal(out, probes.steps_plain(table, n, probes.STEPS)):
            raise AssertionError(f"chain {ctas}x{lanes}: != steps_plain")
        per = cycles.double() / probes.STEPS
        res[(ctas, lanes)] = (per.mean().item(), per.max().item())
        print(f"chain {ctas} CTA(s) x {lanes} lanes: {res[(ctas, lanes)][0]:.2f} mean, "
              f"{res[(ctas, lanes)][1]:.2f} max cycles a step", flush=True)
    return res


def _gather_inputs(rows, width):
    rng = probes._rng(0, f"sweep{rows}x{width}")
    table = probes._on("cuda", rng.integers(0, 24576, (rows, width)).astype(np.int32))
    idx = probes._on("cuda", rng.integers(0, rows, probes.S, dtype=np.int32))
    return table, idx


def _gather(lib, table, idx):
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=torch.int32, device="cuda")
    build.check(lib.cpx_pr_row_gather_launch(table.data_ptr(), idx.data_ptr(),
                                             out.data_ptr(), *table.shape, idx.shape[0],
                                             0, _stream_ptr()), "gather")
    return out


def _steps(lib, table):
    out = torch.empty(probes.S, dtype=torch.float32, device="cuda")
    build.check(lib.cpx_pr_steps_launch(table.data_ptr(), out.data_ptr(), *table.shape,
                                        probes.S, probes.STEPS, _stream_ptr()), "steps")
    return out


def run() -> dict:
    """{(kernel, config or "index_select", shape): [us of each round]}."""
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep runs on a CUDA card; none found")
    libs = build_all(sorted(set(GATHER + STEPS)))
    chain_lib = build_chain()
    gather_in = {shape: _gather_inputs(*shape) for shape in GATHER_SHAPES}
    p4 = probes._on("cuda", probes._rng(0, "p4").integers(0, 255, (2048, 128))
                    .astype(np.float32))
    p4_want = probes.steps_plain(p4, probes.S, probes.STEPS)
    times: dict = {}
    for order in (GATHER, GATHER[::-1]):
        for shape, (table, idx) in gather_in.items():
            t = probes.timeit(lambda: torch.index_select(table, 0, idx))
            times.setdefault(("gather", "index_select", shape), []).append(t * 1e6)
        for cfg in order:
            for shape, (table, idx) in gather_in.items():
                lib = libs[cfg]
                if not torch.equal(_gather(lib, table, idx), table[idx.long()]):
                    raise AssertionError(f"gather {_tag(cfg)} {shape}: != table[idx]")
                t = probes.timeit(lambda: _gather(lib, table, idx))
                times.setdefault(("gather", cfg, shape), []).append(t * 1e6)
    for order in (STEPS, STEPS[::-1]):
        for cfg in order:
            lib = libs[cfg]
            if not torch.equal(_steps(lib, p4), p4_want):
                raise AssertionError(f"steps {_tag(cfg)}: != steps_plain")
            t = probes.timeit(lambda: _steps(lib, p4))
            times.setdefault(("steps", cfg, (2048, 128)), []).append(t * 1e6)
    for (kernel, cfg, shape), us in times.items():
        what = cfg if cfg == "index_select" else (
            f"threads {cfg[0]} words {cfg[1]}" if kernel == "gather" else f"lanes {cfg[2]}")
        print(f"{kernel} {what} [{shape[0]}x{shape[1]}]: "
              + " / ".join(f"{u:.3f}" for u in us) + " us", flush=True)
    chain(chain_lib, p4)
    return times


def main(argv) -> int:
    if torch.cuda.is_available():
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
