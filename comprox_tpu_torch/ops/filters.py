"""Reversible content filters: x86 (ELF/PE) call-target and BMP pixel
transforms.

Capability parity with the reference filter stage (the reference's
cr-filter.c, filter_x86_elf.c, filter_x86_pe.c, filter_bmp.c), with one
robustness improvement: instead of re-detecting content on decode (which can
silently mismatch if a transform fabricates a header-like byte pattern), the
encoder records the applied span list in the block and the decoder inverts
exactly those spans.  Detection is therefore an encoder-only policy.

The BMP pixel transform is pure vector arithmetic (color decorrelation
R-=G, B-=G then row delta then column delta, filter_bmp.c:57-147) done with
numpy slicing host-side — it is O(n) elementwise and runs at memory speed.
The x86 E8/E9 transform has a sequential operand-skip dependency and runs
in the native C runtime (csrc/native.c) with a Python fallback.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List

import numpy as np

from comprox_tpu_torch.utils import native

FT_X86 = 1
FT_BMP = 2


@dataclass(frozen=True)
class FilterSpan:
    kind: int
    off: int
    length: int
    # x86: vsize (image span); BMP: packed geometry
    arg1: int
    arg2: int  # BMP: row_size | (bpp << 24); x86: unused

    def pack(self) -> bytes:
        return struct.pack(
            "<BIIII", self.kind, self.off, self.length, self.arg1, self.arg2
        )

    @staticmethod
    def unpack(b: bytes) -> "FilterSpan":
        kind, off, length, a1, a2 = struct.unpack("<BIIII", b)
        return FilterSpan(kind, off, length, a1, a2)


SPAN_BYTES = 17


# --------------------------------------------------------------------------
# detection (encoder-only policy)
# --------------------------------------------------------------------------


def _detect_elf(data: np.ndarray) -> List[FilterSpan]:
    """32/64-bit x86 ELF images: apply E8/E9 over the file span (the
    reference gates on EM_386 only, filter_x86_elf.c:57-58; we also accept
    EM_X86_64=62 since rel32 call/jmp are identical there)."""
    spans = []
    hits = _find(data, b"\x7fELF")
    for h in hits:
        if h + 20 > data.size:
            continue
        machine = int(data[h + 18]) | (int(data[h + 19]) << 8)
        if machine not in (3, 62):  # EM_386, EM_X86_64
            continue
        length = min(data.size - h, 1 << 27)
        spans.append(FilterSpan(FT_X86, h, length, length, 0))
    return spans


def _detect_pe(data: np.ndarray) -> List[FilterSpan]:
    """MZ/PE i386/amd64: size bounded by the section table's raw data sum
    (shape of filter_x86_pe.c:75-126)."""
    spans = []
    for h in _find(data, b"MZ"):
        if h + 0x40 > data.size:
            continue
        e_lfanew = int.from_bytes(data[h + 0x3C : h + 0x40].tobytes(), "little")
        pe = h + e_lfanew
        if e_lfanew < 0x40 or pe + 24 > data.size:
            continue
        if data[pe : pe + 4].tobytes() != b"PE\x00\x00":
            continue
        machine = int.from_bytes(data[pe + 4 : pe + 6].tobytes(), "little")
        if machine not in (0x014C, 0x8664):
            continue
        nsect = int.from_bytes(data[pe + 6 : pe + 8].tobytes(), "little")
        opt = int.from_bytes(data[pe + 20 : pe + 22].tobytes(), "little")
        sect = pe + 24 + opt
        total = 0
        ok = 0 < nsect < 96
        for s in range(nsect if ok else 0):
            row = sect + 40 * s
            if row + 40 > data.size:
                ok = False
                break
            total += int.from_bytes(
                data[row + 16 : row + 20].tobytes(), "little"
            )
        if not ok or total == 0:
            continue
        length = min(data.size - h, total + 4096)
        spans.append(FilterSpan(FT_X86, h, length, length, 0))
    return spans


def _detect_bmp(data: np.ndarray) -> List[FilterSpan]:
    """Uncompressed 24/32-bpp BMPs (sanity checks per filter_bmp.c:163-179)."""
    spans = []
    for h in _find(data, b"BM"):
        if h + 54 > data.size:
            continue
        hdr = data[h : h + 54].tobytes()
        (
            _sig,
            fsize,
            _r1,
            _r2,
            dataoff,
            hsize,
            width,
            height,
            _planes,
            bpp,
            compression,
        ) = struct.unpack("<HIHHIIiihHI", hdr[:34])
        if hsize != 40 or compression != 0 or bpp not in (24, 32):
            continue
        if not (0 < width < 1 << 16 and 0 < abs(height) < 1 << 16):
            continue
        row_size = (width * (bpp // 8) + 3) & ~3
        pix = h + dataoff
        if dataoff < 54 or pix >= data.size:
            continue
        avail = data.size - pix
        want = row_size * abs(height)
        length = min(avail, want)
        full_rows = length // row_size
        if full_rows < 2:
            continue
        spans.append(
            FilterSpan(
                FT_BMP,
                pix,
                full_rows * row_size,
                width,
                row_size | (bpp << 24),
            )
        )
    return spans


def _find(data: np.ndarray, pat: bytes) -> List[int]:
    if data.size < len(pat):
        return []
    mask = data[: data.size - len(pat) + 1] == pat[0]
    for k in range(1, len(pat)):
        mask &= data[k : data.size - len(pat) + 1 + k] == pat[k]
    return [int(i) for i in np.flatnonzero(mask)[:64]]


def detect_spans(data: np.ndarray) -> List[FilterSpan]:
    """Non-overlapping filterable spans in offset order (first wins)."""
    spans = sorted(
        _detect_elf(data) + _detect_pe(data) + _detect_bmp(data),
        key=lambda s: s.off,
    )
    out: List[FilterSpan] = []
    end = 0
    for s in spans:
        if s.off >= end:
            out.append(s)
            end = s.off + s.length
    return out[:255]


# --------------------------------------------------------------------------
# transforms
# --------------------------------------------------------------------------


def _bmp_apply(seg: np.ndarray, width: int, row_size: int, bpp: int,
               encode: bool) -> None:
    """In-place reversible pixel transform (filter_bmp.c:57-147)."""
    nrows = seg.size // row_size
    px = seg[: nrows * row_size].reshape(nrows, row_size)
    ch = bpp // 8
    pix = px[:, : width * ch].reshape(nrows, width, ch)
    if encode:
        pix[:, :, 0] -= pix[:, :, 1]  # B -= G  (BGR order on disk)
        pix[:, :, 2] -= pix[:, :, 1]  # R -= G
        pix[:, 1:, :] -= pix[:, :-1, :].copy()  # row delta
        pix[1:, :, :] -= pix[:-1, :, :].copy()  # column delta
    else:
        # exact inverses in reverse order; mod-256 cumsum inverts the delta
        pix[:, :, :] = np.cumsum(pix, axis=0, dtype=np.uint64).astype(np.uint8)
        pix[:, :, :] = np.cumsum(pix, axis=1, dtype=np.uint64).astype(np.uint8)
        pix[:, :, 0] += pix[:, :, 1]
        pix[:, :, 2] += pix[:, :, 1]


def apply_spans(
    data: np.ndarray, spans: List[FilterSpan], encode: bool
) -> np.ndarray:
    """Apply (encode) or invert (decode) the span transforms; returns a new
    array, input untouched."""
    out = data.copy()
    for s in spans:
        seg = out[s.off : s.off + s.length]
        if s.kind == FT_X86:
            native.e8e9_transform(seg, 0, s.arg1, encode)
        elif s.kind == FT_BMP:
            row_size = s.arg2 & 0xFFFFFF
            bpp = s.arg2 >> 24
            _bmp_apply(seg, s.arg1, row_size, bpp, encode)
    return out


def pack_spans(spans: List[FilterSpan]) -> bytes:
    return bytes([len(spans)]) + b"".join(s.pack() for s in spans)


def unpack_spans(blob: bytes) -> tuple[List[FilterSpan], int]:
    if not blob:
        raise ValueError("corrupt block: empty filter-span prefix")
    n = blob[0]
    if 1 + n * SPAN_BYTES > len(blob):
        raise ValueError("corrupt block: truncated filter-span list")
    spans = []
    off = 1
    for _ in range(n):
        spans.append(FilterSpan.unpack(blob[off : off + SPAN_BYTES]))
        off += SPAN_BYTES
    return spans, off
