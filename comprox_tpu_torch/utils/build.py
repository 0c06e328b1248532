"""Build and load the port's CUDA kernels.

At first use, every ``comprox_tpu_torch/csrc/*.cu`` is compiled by ``nvcc``
for ``sm_90a`` (one ``nvcc`` per source, all started together) and linked
into one shared library with a plain C interface, under ``build/kernels/``
at the repository root, named by a hash of the sources (an unchanged tree
reuses its build).  The library is loaded with
``ctypes``.  Each C entry point returns ``cudaGetLastError()`` after its
launch; :func:`check` raises on anything but 0.

An instrumented variant (extra ``-D`` flags, a subset of the sources, e.g.
the per-phase clock stamps of ``benchmarks/phases.py``) builds beside the
main library under its own hash; :func:`variant` makes :func:`lib` return
it for the calls inside its ``with`` block, with the main library's entry
points standing in for those of the sources it leaves out.  The main path
never builds one.

Nothing here runs at import: the CPU tests import every module, and the
machines without a card have no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]
NVCC_TIMEOUT_S = 600  # a whole build takes well under a minute

# (extra nvcc flags, sources or None for all) -> loaded library
_libs: dict = {}
_LIBS_LOCK = threading.Lock()  # a mesh's host threads may ask at once
_VARIANT: tuple = ((), None)
_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argument types (pointers, the stream and ints)
_SIGNATURES = {
    "cpx_ks_launch": [_P] * 5,
    "cpx_k4_keys_launch": [_P] * 4,
    "cpx_radix_sort_launch": [_I] + [_P] * 4,
    "cpx_k4_find_launch": [_P] * 7,
    "cpx_k5_launch": [_P, _I] + [_P] * 6,
    "cpx_k5c_launch": [_P] * 7,
    "cpx_k5_max_clusters": [_P] * 2,
    "cpx_k6_launch": [_P, _I] + [_P] * 4,
    "cpx_k6f_launch": [_P, _I] + [_P] * 4,
    "cpx_k7_keys_launch": [_P] * 4,
    "cpx_k7_find_launch": [_P] * 7,
    "cpx_k8_launch": [_P] * 8,
    "cpx_k9_launch": [_I] * 2 + [_P] * 14,
    "cpx_k10_launch": [_I] * 3 + [_P] * 8,
    "cpx_k2_launch": [_P, _I] + [_P] * 12,
    "cpx_k3_launch": [_I] * 4 + [_P] * 5,
    "cpx_k1_launch": [_P, _I] + [_P] * 15,
    "cpx_k1c_launch": [_P] * 15,
    "cpx_kcr_launch": [_I, _I, _P, _P, _P],
    "cpx_k3p_launch": [_I, _P, _P, _P],
    "cpx_k3b_launch": [_I] * 3 + [_P] * 6,
    "cpx_k3b_tiles": [_I, _I],
    "cpx_k4x_keys_launch": [_P] * 4,
    "cpx_k4x_find_launch": [_P] * 7,
    "cpx_k6x_launch": [_P, _I] + [_P] * 5,
    "cpx_k11_launch": [_P, _I, _P, _I] + [_P] * 4,
    "cpx_k12e_launch": [_P, _I] + [_P] * 15,
    "cpx_k12d_launch": [_P, _I] + [_P] * 16,
    "cpx_ksx_launch": [_P] * 7,
    "cpx_k13c_launch": [_P] * 12,
    "cpx_k13e_launch": [_P, _I] + [_P] * 11,
    "cpx_k13d_launch": [_P, _I] + [_P] * 15,
    # the probes (benchmarks/probes.py)
    "cpx_pr_row_gather_launch": [_P] * 3 + [_I] * 4 + [_P],
    "cpx_pr_elem_gather_launch": [_P] * 3 + [_I] * 2 + [_P],
    "cpx_pr_row_bulk_smem": [_I] * 2,
    "cpx_pr_row_bulk_launch": [_P] * 3 + [_I] * 3 + [_P],
    "cpx_pr_row_loop_launch": [_P] * 3 + [_I] * 3 + [_P],
    "cpx_pr_steps_launch": [_P] * 2 + [_I] * 4 + [_P],
    "cpx_pr_step_launch": [_P] * 2 + [_I] * 3 + [_P],
    "cpx_pr_empty_launch": [_P],
    "cpx_pr_row_ring_smem": [_I] * 3,
    "cpx_pr_row_ring_launch": [_P] * 3 + [_I] * 4 + [_P],
    "cpx_pr_onehot_wgmma_launch": [_P] * 3 + [_I] * 3 + [_P],
    # only in the instrumented builds (-DCPX_K1_PROF and -DCPX_K12D_PROF of
    # decode.cu, -DCPX_K5_PROF of rank.cu, -DCPX_K2_PROF of model.cu)
    "cpx_k1_prof_read": [_P],
    "cpx_k12d_prof_read": [_P],
    "cpx_k13d_prof_read": [_P],
    "cpx_k5_prof_read": [_P],
    "cpx_k2_prof_read": [_P],
    "cpx_k12e_prof_read": [_P],
    "cpx_k13e_prof_read": [_P],
    "cpx_k6_prof_read": [_P],  # -DCPX_K6_PROF of parse.cu
    "cpx_k11_prof_read": [_P],  # -DCPX_K11_PROF of xrep.cu
    "cpx_ks_prof_read": [_P],  # -DCPX_KS_PROF of search.cu
    "cpx_ksx_prof_read": [_P],  # -DCPX_KSX_PROF of search.cu
}
_INSTRUMENTED = {"cpx_k1_prof_read", "cpx_k12d_prof_read", "cpx_k13d_prof_read",
                 "cpx_k5_prof_read", "cpx_k2_prof_read", "cpx_k12e_prof_read",
                 "cpx_k13e_prof_read", "cpx_k6_prof_read",
                 "cpx_k11_prof_read", "cpx_ks_prof_read", "cpx_ksx_prof_read"}


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


def library_path(defines=(), only=None) -> Path:
    """The library of this source tree (with ``defines`` and built from the
    ``.cu`` files named in ``only``: an instrumented variant)."""
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    if defines or only:
        h.update(repr((tuple(defines), only and tuple(only))).encode())
    return BUILD_DIR / f"libcpx_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False, defines=(), only=None) -> Path:
    """Compile the kernels if this source tree has no build yet."""
    return build_many([(defines, only)], verbose)[0]


def build_many(specs, verbose: bool = False) -> list:
    """Build the libraries of ``specs`` [(defines, only), ...] that do not
    exist yet, every ``nvcc`` of all of them started together."""
    jobs = []  # (library, tmp, objects, [(source, process)])
    procs = []
    try:
        for defines, only in specs:
            so = library_path(defines, only)
            if so.exists():
                jobs.append((so, None, [], []))
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            tag = f"{so.stem}.{os.getpid()}"
            objs, mine = [], []
            for src in sorted(CSRC.glob("*.cu")):
                if only is not None and src.name not in only:
                    continue
                obj = BUILD_DIR / f"{tag}.{src.stem}.o"
                cmd = [nvcc, *NVCC_FLAGS, *defines, "-c", "-o", str(obj), str(src)]
                if verbose:
                    cmd += ["-Xptxas", "-v"]
                objs.append(obj)
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
                mine.append((src, proc))
                procs.append(proc)
            jobs.append((so, so.with_suffix(f".{os.getpid()}.tmp"), objs, mine))
        for so, tmp, objs, mine in jobs:
            if tmp is None:
                continue
            failed = []
            try:
                for src, proc in mine:
                    _, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
                    if proc.returncode != 0:
                        failed.append(f"{src.name} ({proc.returncode}):\n{err}")
                    elif verbose:
                        print(f"{so.name} {src.name}:\n{err}")
                if failed:
                    raise RuntimeError("nvcc failed: " + "\n".join(failed))
                r = subprocess.run(
                    [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                    capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
                if r.returncode != 0:
                    raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stderr}")
            finally:
                for obj in objs:
                    obj.unlink(missing_ok=True)
            os.replace(tmp, so)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [so for so, _, _, _ in jobs]


@contextlib.contextmanager
def variant(*defines, only=None):
    """Inside the block, :func:`lib` returns the library built with the
    extra nvcc flags ``defines`` from the ``.cu`` files in ``only``."""
    global _VARIANT
    old, _VARIANT = _VARIANT, (tuple(defines), only and tuple(only))
    try:
        yield
    finally:
        _VARIANT = old


class _Overlay:
    """A variant built from some of the sources; the entry points it lacks
    are the main library's."""

    def __init__(self, variant_lib, main_lib):
        self._variant, self._main = variant_lib, main_lib

    def __getattr__(self, name):
        fn = getattr(self._variant, name, None)
        return fn if fn is not None else getattr(self._main, name)


def _load(defines, only) -> ctypes.CDLL:
    handle = ctypes.CDLL(str(build(defines=defines, only=only)))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name, None)
        if fn is None:
            if name in _INSTRUMENTED or only is not None:
                continue
            raise RuntimeError(f"{name} missing from the kernel library")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def lib():
    """The loaded kernel library (built on first call), or inside
    :func:`variant` the variant's."""
    key = _VARIANT
    if key not in _libs:
        with _LIBS_LOCK:
            if key not in _libs:
                defines, only = key
                handle = _load(defines, only)
                if only is not None:
                    main = ((), None)
                    if main not in _libs:
                        _libs[main] = _load(*main)
                    handle = _Overlay(handle, _libs[main])
                _libs[key] = handle
    return _libs[key]


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
