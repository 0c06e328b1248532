"""Build and load the port's CUDA kernels.

At first use, every ``comprox_tpu_torch/csrc/*.cu`` is compiled by ``nvcc``
for ``sm_90a`` (one ``nvcc`` per source, all started together) and linked
into one shared library with a plain C interface, under ``build/kernels/``
at the repository root, named by a hash of the sources (an unchanged tree
reuses its build).  The library is loaded with
``ctypes``.  Each C entry point returns ``cudaGetLastError()`` after its
launch; :func:`check` raises on anything but 0.

Nothing here runs at import: the CPU tests import every module, and the
machines without a card have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]
NVCC_TIMEOUT_S = 600  # a whole build takes well under a minute

_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argument types (pointers, the stream and ints)
_SIGNATURES = {
    "cpx_ks_launch": [_P] * 6,
    "cpx_k4_sort_launch": [_P] * 6,
    "cpx_k4_find_launch": [_P] * 8,
    "cpx_k5_launch": [_P] * 7,
    "cpx_k6_launch": [_P] * 4,
    "cpx_k6f_launch": [_P] * 4,
    "cpx_k7_sort_launch": [_P] * 6,
    "cpx_k7_find_launch": [_P] * 8,
    "cpx_k8_launch": [_P] * 7,
    "cpx_k9_launch": [_I] * 2 + [_P] * 9,
    "cpx_k10_launch": [_I] * 3 + [_P] * 9,
    "cpx_k2_launch": [_P] * 12,
    "cpx_k3_launch": [_I, _I, _I, _P, _P, _P, _P, _P],
    "cpx_k1_launch": [_P] * 15,
    "cpx_k4x_sort_launch": [_P] * 6,
    "cpx_k4x_find_launch": [_P] * 8,
    "cpx_k6x_launch": [_P] * 5,
    "cpx_k11_launch": [_P] * 5,
    "cpx_k12e_launch": [_P] * 15,
    "cpx_k12d_launch": [_P] * 16,
    "cpx_ksx_launch": [_P] * 8,
    "cpx_k13e_launch": [_P] * 13,
    "cpx_k13d_launch": [_P] * 15,
    # the probes (benchmarks/probes.py)
    "cpx_pr_row_gather_launch": [_P] * 3 + [_I] * 4 + [_P],
    "cpx_pr_elem_gather_launch": [_P] * 3 + [_I] * 2 + [_P],
    "cpx_pr_row_loop_launch": [_P] * 3 + [_I] * 3 + [_P],
    "cpx_pr_steps_launch": [_P] * 2 + [_I] * 4 + [_P],
    "cpx_pr_step_launch": [_P] * 2 + [_I] * 3 + [_P],
    "cpx_pr_row_ring_launch": [_P] * 3 + [_I] * 4 + [_P],
    "cpx_pr_onehot_mma_launch": [_P] * 3 + [_I] * 3 + [_P],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return BUILD_DIR / f"libcpx_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this source tree has no build yet."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    try:
        for src, proc in procs:
            _, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{err}")
            elif verbose:
                print(err)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        r = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
