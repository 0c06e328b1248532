"""Build and load the port's CUDA kernels.

At first use, every ``comprox_tpu_torch/csrc/*.cu`` is compiled by ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, under
``build/kernels/`` at the repository root, named by a hash of the sources
(an unchanged tree reuses its build).  The library is loaded with
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
    "-shared", "-Xcompiler", "-fPIC",
]
NVCC_TIMEOUT_S = 600  # a whole build takes well under a minute

_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argument types (pointers, the stream and ints)
_SIGNATURES = {
    "cpx_ks_launch": [_P] * 6,
    "cpx_k2_launch": [_P] * 12,
    "cpx_k3_launch": [_I, _I, _P, _P, _P, _P, _P],
    "cpx_k1_launch": [_P] * 15,
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
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=NVCC_TIMEOUT_S)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    if verbose:
        print(r.stderr)
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
