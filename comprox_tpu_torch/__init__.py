"""comprox_tpu_torch — the PyTorch and CUDA port of comprox_tpu.

A second package beside :mod:`comprox_tpu`, which stays the reference: for
the same input it writes the same archive, block payloads and intermediate
grids.  Device code is hand-written CUDA for Hopper (``csrc/``), built at
first use by :mod:`comprox_tpu_torch.utils.build`; every kernel has a plain
PyTorch version beside it, which the CPU tests compare with the JAX package.

Ported so far: codec R (``crz``), unchained: encode with the flexible
parse (the default) or the greedy parse (``-f0``), and decode of every
unchained mode-R archive with ``short_depth=0``.  ROADMAP.md lists what is
still to port.

Layout mirrors the JAX package: ops/ (rANS), models/ (tables, PPM),
codec/ (block, container, dictionary), cli/, utils/ (kernel build, host
helper build), csrc/ (CUDA kernels and the host helpers' C source).
The port imports nothing of comprox_tpu: it keeps its own copies of the
host-only modules it needs (ops/rans_scalar.py, ops/filters.py,
codec/dictionary.py, utils/native.py with csrc/native.c).
"""
