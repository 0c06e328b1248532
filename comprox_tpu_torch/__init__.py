"""comprox_tpu_torch — the PyTorch and CUDA port of comprox_tpu.

A second package beside :mod:`comprox_tpu`, which stays the reference: for
the same input it writes the same archive, block payloads and intermediate
grids.  Device code is hand-written CUDA for Hopper (``csrc/``), built at
first use by :mod:`comprox_tpu_torch.utils.build`; every kernel has a plain
PyTorch version beside it, which the CPU tests compare with the JAX package.

Ported: the four codecs, unchained and one block at a time, encode and
decode — ``crz`` (mode R, flexible parse or ``-f0``), ``crx`` (mode X),
``crp`` (mode P, the command line's default codec) and ``crf`` (mode F,
the fast profile) — with ``short_depth=0``.  ROADMAP.md lists what is
still to port (chain modes, several blocks per launch, several devices).
``benchmarks/probes.py`` holds the nine Pallas probes of the JAX
package's ``benchmarks/`` as CUDA kernels (``csrc/probes.cu``); nothing of
the codec imports it.

Layout mirrors the JAX package: ops/ (rANS), models/ (tables, PPM),
codec/ (block, container, dictionary), cli/, utils/ (kernel build, host
helper build), csrc/ (CUDA kernels and the host helpers' C source).
The port imports nothing of comprox_tpu: it keeps its own copies of the
host-only modules it needs (ops/rans_scalar.py, ops/filters.py,
codec/dictionary.py, utils/native.py with csrc/native.c).
"""
