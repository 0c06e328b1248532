"""Host helper library of the port, built at first use (ctypes).

Compiles ``comprox_tpu_torch/csrc/native.c`` with ``cc`` into
``build/native/`` at the repository root (git-ignored), named by a hash of
the source, and exposes typed wrappers.  These are host loops (the E8/E9
filter transform, the dictionary stage and mode F's LZ copy walk), not
kernels.  Every wrapper
has a byte-identical pure-Python path, so the port also runs on a machine
without a C compiler; the tests hold both paths to the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "native.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _build() -> Optional[ctypes.CDLL]:
    try:
        src = _SRC.read_bytes()
    except OSError:
        return None
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = BUILD_DIR / f"libcpx_native_{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["cc", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (subprocess.SubprocessError, OSError):
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.e8e9_transform.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.e8e9_transform.restype = None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if not _lib_tried:
        _lib_tried = True
        _lib = _build()
    return _lib


def e8e9_transform(
    buf: np.ndarray, vbase: int, vsize: int, encode: bool
) -> None:
    """In-place E8/E9 rel32<->abs32 transform (see native.c)."""
    assert buf.dtype == np.uint8 and buf.flags.c_contiguous
    lib = get_lib()
    en_de = 0 if encode else 1
    if lib is not None:
        lib.e8e9_transform(
            buf.ctypes.data, buf.size, vbase, vsize, en_de
        )
        return
    _e8e9_python(buf, vbase, vsize, en_de)


def _e8e9_python(buf: np.ndarray, vbase: int, vsize: int, en_de: int) -> None:
    i, n = 0, buf.size
    if n < 9:
        return
    mem = memoryview(buf)
    while i < n - 8:
        if (mem[i] & 0xFE) == 0xE8:
            i += 1
            op = int.from_bytes(mem[i : i + 4], "little", signed=True)
            here = vbase + i
            if en_de == 0:
                if -here <= op < vsize - here:
                    op = (op + here + 2**31) % 2**32 - 2**31
                elif 0 < op < vsize:
                    op = op - vsize
            else:
                if op < 0:
                    if op + here >= 0:
                        op = (op + vsize + 2**31) % 2**32 - 2**31
                elif op < vsize:
                    op = (op - here + 2**31) % 2**32 - 2**31
            mem[i : i + 4] = op.to_bytes(4, "little", signed=True)
            i += 4
        else:
            i += 1


def f2_execute(tok: np.ndarray, min_len: int, n: int) -> Optional[np.ndarray]:
    """Materialize mode-F output bytes from the decoded token plane
    (native.c f2_execute): values < 256 are literal bytes, values >= 256
    are matches (dist << 8) | (len - min_len).  ``n`` is the expected
    output size; returns None (raising is the caller's job) when the token
    stream is malformed or does not produce exactly n bytes."""
    assert tok.dtype == np.uint32 and tok.flags.c_contiguous
    lib = get_lib()
    if lib is None:
        return _f2_execute_python(tok, min_len, n)
    if not getattr(lib, "_f2_setup", False):
        lib.f2_execute.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.f2_execute.restype = ctypes.c_int64
        lib._f2_setup = True
    out = np.empty(n, np.uint8)
    got = lib.f2_execute(tok.ctypes.data, tok.size, min_len, out.ctypes.data, n)
    return out if got == n else None


def _f2_execute_python(tok: np.ndarray, min_len: int, n: int) -> Optional[np.ndarray]:
    """The same walk without a C compiler, with the same fail-clean rule."""
    out = np.empty(n, np.uint8)
    o = 0
    for v in tok.tolist():
        if v < 256:
            if o >= n:
                return None
            out[o] = v
            o += 1
        else:
            length, dist = (v & 255) + min_len, v >> 8
            src = o - dist
            if src < 0 or o + length > n:
                return None
            for j in range(length):
                out[o + j] = out[src + j]
            o += length
    return out if o == n else None


def _setup_dict(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_dict_setup", False):
        return
    lib.dict_encode_c.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.dict_encode_c.restype = ctypes.c_int64
    lib.dict_decode_c.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p,
    ]
    lib.dict_decode_c.restype = ctypes.c_int64
    lib._dict_setup = True


def dict_encode_c(inp, words, woff, codes, coff, space_mode, cap_byte,
                  esc_map, slots):
    """Raw ctypes shim for native.c dict_encode_c; returns the coded
    bytes or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    _setup_dict(lib)
    out = np.empty(2 * inp.size + 4, np.uint8)
    n = lib.dict_encode_c(
        inp.ctypes.data, inp.size, words.ctypes.data, woff.ctypes.data,
        woff.size - 1, codes.ctypes.data, coff.ctypes.data,
        int(space_mode), int(cap_byte), esc_map.ctypes.data,
        slots.ctypes.data, slots.size, out.ctypes.data,
    )
    return out[:n].copy()


def dict_count_c(sample: np.ndarray, space_mode: bool, fold_mode: bool):
    """Tokenize + count unique words natively (native.c dict_count_c).
    Returns (arena bytes, lens int32[], counts int64[]) in first-occurrence
    order, or None when the library is unavailable or capacity was hit
    (caller falls back to the Python regex/Counter pass)."""
    lib = get_lib()
    if lib is None:
        return None
    if not getattr(lib, "_count_setup", False):
        lib.dict_count_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.dict_count_c.restype = ctypes.c_int64
        lib._count_setup = True
    n = sample.size
    # tokens are >= 2 bytes, so unique entries <= n/2; bound the entry
    # arrays at 4M (32 MB counts temp) — a 16 MiB text sample measures
    # ~200-400k unique tokens, so the cap is generous headroom
    max_entries = int(min(n // 2 + 1, 4 << 20))
    arena = np.empty(n, np.uint8)
    lens = np.empty(max_entries, np.int32)
    counts = np.empty(max_entries, np.int64)
    ne = lib.dict_count_c(
        sample.ctypes.data, n, int(space_mode), int(fold_mode),
        arena.ctypes.data, arena.size, lens.ctypes.data,
        counts.ctypes.data, max_entries,
    )
    if ne < 0:
        return None
    return arena, lens[:ne], counts[:ne]


def dict_decode_c(inp, words, woff, one_map, two_map, lead_idx, cap_byte):
    """Raw ctypes shim for native.c dict_decode_c (size pass + fill
    pass); returns the expanded bytes or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    _setup_dict(lib)
    size = lib.dict_decode_c(
        inp.ctypes.data, inp.size, words.ctypes.data, woff.ctypes.data,
        one_map.ctypes.data, two_map.ctypes.data, lead_idx.ctypes.data,
        int(cap_byte), None,
    )
    out = np.empty(size, np.uint8)
    lib.dict_decode_c(
        inp.ctypes.data, inp.size, words.ctypes.data, woff.ctypes.data,
        one_map.ctypes.data, two_map.ctypes.data, lead_idx.ctypes.data,
        int(cap_byte), out.ctypes.data,
    )
    return out
