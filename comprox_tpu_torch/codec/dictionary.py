"""Static word-dictionary pre-pass (the reference's cr-dicpick/cr-diccode
stage, re-designed for vectorized decode).

The reference builds a <=25000-word dictionary in a whole-file pass
(cr-dicpick.c:164-236), substitutes words with 1-2 byte codes chosen from
per-block rare bytes plus a case/punctuation escape byte (cr-diccode.c:
160-221), and front-codes the dictionary text (cr-dicpick.c:261-346).

Our scheme keeps the capability but chooses a code space whose *decode is
position-independent*, so expansion never needs a sequential scan:

  * 1-byte codes: byte values with zero occurrences in the whole file
    (cost-free — no escapes needed);
  * 2-byte codes: N_LEADS rare "lead" bytes; a lead is followed by a code
    byte cb, where cb is never a lead value — therefore every lead
    occurrence in the coded stream starts a real 2-byte code;
  * literal occurrences of lead j escape as (lead_0, 255-j).

Tokens are ``[A-Za-z]{2,20}`` with an optional trailing space, so the
overwhelmingly common "word + space" unit codes as one symbol (the
reference instead folds trailing punctuation into its escape byte,
cr-diccode.c:313-335).  Word selection is by total savings
count*(len-codelen), greedy.  The dictionary blob is LCP front-coded like
the reference.
"""

from __future__ import annotations

import re
import struct
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

import os as _os

# Measured on doc-text (BASELINE.md corpus): on SMALL inputs (~1 MiB)
# only the cost-free 1-byte codes help — 2-byte codes and trailing-space
# tokens hurt the downstream ROLZ+PPM stage.  On LARGE inputs (8 MiB+)
# the full 2-byte code space AND space-tokens win clearly (0.482 -> 0.442
# bpb).  Aggressiveness therefore adapts to input size; env knobs
# override for sweeps.
_RE_PLAIN = re.compile(rb"[A-Za-z]{2,20}")
_RE_SPACE = re.compile(rb"[A-Za-z]{2,20} ?")
WORD_RE = _RE_PLAIN  # default for standalone calls; build sets per-dict
BIG_INPUT = 2 * 1048576
MIN_COUNT = 6  # reference keeps words with count > 5 (cr-dicpick.c:219)
N_LEADS = int(_os.environ.get("CPX_DICT_LEADS", "4"))
_W2_ENV = _os.environ.get("CPX_DICT_W2")
_SPACE_ENV = _os.environ.get("CPX_DICT_SPACE")
_CAP_ENV = _os.environ.get("CPX_DICT_CAP", "1")


@dataclass
class WordDict:
    one_codes: List[int]  # byte values for 1-byte codes
    words1: List[bytes]  # words for one_codes (same order)
    leads: List[int]  # lead byte values (first carries the escapes)
    words2: List[bytes]  # words for 2-byte codes
    space: bool = False  # encode-side tokenizer choice (not serialized)
    cap_byte: int = -1  # capitalization mark (-1 = disabled): CAP + code
    # decodes as the word with its first letter uppercased — one dictionary
    # entry serves both "the" and "The" (the reference's case-inversion
    # escape variants, cr-diccode.c:160-171,313-335)
    enc_map: Dict[bytes, bytes] = field(default_factory=dict, repr=False)

    def _n_esc(self) -> int:
        return len(self.leads) + (1 if self.cap_byte >= 0 else 0)

    def _cbs(self) -> List[int]:
        """Code-byte values: everything except lead values; the first
        _n_esc() values from the top (255, 254, ...) are reserved on
        lead_0 for lead/cap-literal escapes."""
        return [cb for cb in range(256) if cb not in set(self.leads)]

    def two_codes(self) -> List[Tuple[int, int]]:
        cbs = self._cbs()
        esc_reserved = set(range(256 - self._n_esc(), 256))
        codes = []
        for li, lead in enumerate(self.leads):
            for cb in cbs:
                if li == 0 and cb in esc_reserved:
                    continue
                codes.append((lead, cb))
        return codes

    def esc_code(self, j: int) -> Tuple[int, int]:
        """Escape for a literal occurrence of lead j (or, at j ==
        len(leads), of the cap mark)."""
        return (self.leads[0], 255 - j)

    def build_maps(self) -> None:
        self.enc_map = {}
        for b, w in zip(self.one_codes, self.words1):
            self.enc_map[w] = bytes([b])
        for (lead, cb), w in zip(self.two_codes(), self.words2):
            self.enc_map[w] = bytes([lead, cb])


def fold_token(w: bytes) -> Optional[bytes]:
    """Lowercased form of a capitalized token ("The " -> "the "), or None
    when the token is not a fold candidate (already lowercase, ALLCAPS,
    CamelCase...).  Decode inverts by uppercasing the first letter, so a
    candidate must be exactly first-upper + rest-lower."""
    if not (65 <= w[0] <= 90):
        return None
    rest = w[1:].rstrip(b" ")
    if rest and not rest.islower():
        return None
    return bytes([w[0] + 32]) + w[1:]


def build_dictionary(data: np.ndarray, max_words2: Optional[int] = None
                     ) -> Optional[WordDict]:
    """Whole-file pass #1 (the dicpick analogue).  Returns None when a
    dictionary can't pay for itself (binary data, tiny files)."""
    n_raw = data.size
    if n_raw < 4096:
        return None
    big = n_raw >= BIG_INPUT
    space = big if _SPACE_ENV is None else _SPACE_ENV == "1"
    use_cap = _CAP_ENV != "0"
    word_re = _RE_SPACE if space else _RE_PLAIN
    # chunked bincount: one bulk astype is faster than the uint8 path but
    # materializes an 8x temp; 16 MiB chunks keep the speed with a
    # bounded temp.
    hist = np.zeros(256, np.int64)
    for i in range(0, n_raw, 1 << 24):
        hist += np.bincount(
            data[i : i + (1 << 24)].astype(np.intp), minlength=256
        )
    # word counting runs on a deterministic strided SAMPLE above the cap
    # (the reference streams this pass, cr-dicpick.c:149-216; we bound it
    # instead): 64 evenly-spaced chunks, counts rescaled to file size so
    # MIN_COUNT and the savings ranking keep their absolute meaning.
    # Default 16 MiB: inputs at or below the flagship block sizes are
    # counted exactly (bench-comparable ratios); 100 MiB / 1 GiB scale
    # runs get a bounded pass (measured +0.76% dict-output size at 8 MiB
    # when sampling half the input; the final-ratio effect is smaller).
    cap_mb = float(_os.environ.get("CPX_DICT_SAMPLE_MB", "16"))
    cap_n = int(cap_mb * 1048576)
    if 0 < cap_n < n_raw:
        n_chunks = 64
        ck = max(cap_n // n_chunks, 4096)
        stride = n_raw // n_chunks
        parts = [
            data[i * stride : i * stride + ck].tobytes()
            for i in range(n_chunks)
        ]
        sample_b = b"\n".join(parts)
        sample_arr = np.frombuffer(sample_b, np.uint8)
        scale = n_raw / max(len(sample_b), 1)
    else:
        sample_b = None  # materialized lazily for the Python fallback
        sample_arr = np.ascontiguousarray(data)
        scale = 1.0
    # the tokenize+count pass is the slowest host stage of a dict-on
    # encode as regex+Counter: run it natively
    # (csrc/native.c dict_count_c — identical tokenizer to dict_encode_c;
    # folding at count time equals the Python count-raw-then-fold-unique
    # merge, and tokens come back in first-occurrence order of the folded
    # key so the downstream stable savings sorts tie-break identically).
    # The regex/Counter path stays as the no-toolchain fallback.
    nc = None
    try:
        from comprox_tpu_torch.utils import native as _nat

        nc = _nat.dict_count_c(sample_arr, space, use_cap)
    except Exception:
        nc = None
    if nc is not None:
        arena, lens, counts = nc
        if scale != 1.0:
            # int(c * scale): float64 multiply then truncate toward zero —
            # exactly the Python fallback's arithmetic
            counts = np.trunc(counts.astype(np.float64) * scale).astype(
                np.int64
            )
        offs = np.zeros(lens.size + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        ab = arena[: int(offs[-1])].tobytes()
        keep = np.flatnonzero(counts >= MIN_COUNT)
        cand = [(ab[offs[k] : offs[k + 1]], int(counts[k])) for k in keep]
    else:
        if sample_b is None:
            sample_b = sample_arr.tobytes()
        if use_cap:
            # case folding: "The" counts toward "the" (the reference's
            # case-inversion escape, cr-diccode.c:313-335); coded as CAP +
            # code.  Count raw tokens first (C-speed Counter), then fold
            # the UNIQUE tokens only and merge — identical counts, ~30x
            # fewer fold_token calls
            raw_cnt = Counter(word_re.findall(sample_b))
            cnt: Counter = Counter()
            for w, c in raw_cnt.items():
                cnt[fold_token(w) or w] += c
        else:
            cnt = Counter(word_re.findall(sample_b))
        if scale != 1.0:
            cnt = Counter({w: int(c * scale) for w, c in cnt.items()})
        cand = [(w, c) for w, c in cnt.items() if c >= MIN_COUNT]
    if not cand:
        return None
    cmap = dict(cand)
    # rare leads for 2-byte codes: cheapest nonzero bytes not already free
    order = np.argsort(hist + (hist == 0) * (1 << 30))
    leads = [int(b) for b in order[:N_LEADS]]
    cap_byte = int(order[N_LEADS]) if use_cap else -1
    lead_cost = int(hist[leads].sum())  # each literal escape costs +1B
    if use_cap:
        lead_cost += int(hist[cap_byte])
    # 1-byte codes come from zero-occurrence bytes, EXCLUDING any that the
    # lead/cap selection grabbed (possible when the input has fewer than
    # N_LEADS+1 distinct byte values) — overlap would make decode ambiguous
    taken = set(leads) | {cap_byte}
    unused = [
        int(b) for b in np.flatnonzero(hist == 0) if int(b) not in taken
    ]
    by_savings1 = sorted(cand, key=lambda kv: -kv[1] * (len(kv[0]) - 1))
    words1 = [w for w, c in by_savings1[: len(unused)]]
    rest = [(w, c) for w, c in by_savings1[len(unused):] if len(w) >= 3]
    by_savings2 = sorted(rest, key=lambda kv: -kv[1] * (len(kv[0]) - 2))
    d = WordDict(one_codes=unused[: len(words1)], words1=words1,
                 leads=leads, words2=[], space=space, cap_byte=cap_byte)
    if max_words2 is None:
        if _W2_ENV is not None:
            max_words2 = int(_W2_ENV) if int(_W2_ENV) >= 0 else None
        elif not big:
            max_words2 = 0  # small inputs: 1-byte codes only
    n2cap = len(d.two_codes()) if max_words2 is None else max_words2
    d.words2 = [w for w, c in by_savings2[:n2cap]]
    total_savings = (
        sum(cmap[w] * (len(w) - 1) for w in d.words1)
        + sum(cmap[w] * (len(w) - 2) for w in d.words2)
        - lead_cost
    )
    if total_savings < n_raw // 64:  # not worth the stage
        return None
    d.build_maps()
    return d


def _native_enc_tables(d: WordDict):
    """Marshal the encode map for csrc/native.c (cached on the dict)."""
    t = getattr(d, "_nat_enc", None)
    if t is not None:
        return t
    items = list(d.enc_map.items())
    words = b"".join(w for w, _ in items)
    woff = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(w) for w, _ in items], out=woff[1:])
    codes = b"".join(c for _, c in items)
    coff = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(c) for _, c in items], out=coff[1:])
    esc = np.zeros((256, 3), np.uint8)
    esc[:, 0] = 1
    esc[:, 1] = np.arange(256)
    for j, lead in enumerate(d.leads):
        esc[lead] = (2,) + d.esc_code(j)
    if d.cap_byte >= 0:
        esc[d.cap_byte] = (2,) + d.esc_code(len(d.leads))
    nslots = 1
    while nslots < 2 * max(len(items), 1):
        nslots *= 2
    t = (
        np.frombuffer(words, np.uint8), woff,
        np.frombuffer(codes, np.uint8), coff, esc.reshape(-1),
        np.zeros(nslots, np.int32),
    )
    d._nat_enc = t
    return t


def _native_dec_tables(d: WordDict):
    """Marshal the decode tables for csrc/native.c (cached on the dict)."""
    t = getattr(d, "_nat_dec", None)
    if t is not None:
        return t
    words: List[bytes] = []
    one_map = np.zeros(256, np.int32)
    for cb, w in zip(d.one_codes, d.words1):
        one_map[cb] = len(words) + 1
        words.append(w)
    lead_idx = np.full(256, 255, np.uint8)
    for j, lead in enumerate(d.leads):
        lead_idx[lead] = j
    two_map = np.zeros(len(d.leads) * 256, np.int32)
    for (lead, cb), w in zip(d.two_codes(), d.words2):
        two_map[int(lead_idx[lead]) * 256 + cb] = len(words) + 1
        words.append(w)
    for j, lead in enumerate(d.leads):  # literal escapes
        el, ec = d.esc_code(j)
        two_map[int(lead_idx[el]) * 256 + ec] = len(words) + 1
        words.append(bytes([lead]))
    if d.cap_byte >= 0:
        el, ec = d.esc_code(len(d.leads))
        two_map[int(lead_idx[el]) * 256 + ec] = len(words) + 1
        words.append(bytes([d.cap_byte]))
    cat = b"".join(words)
    woff = np.zeros(len(words) + 1, np.int64)
    np.cumsum([len(w) for w in words], out=woff[1:])
    t = (np.frombuffer(cat, np.uint8), woff, one_map, two_map, lead_idx)
    d._nat_dec = t
    return t


_NO_NATIVE = _os.environ.get("CPX_NO_NATIVE") == "1"


def dict_encode(data: np.ndarray, d: WordDict) -> np.ndarray:
    """Substitute words; escape literal lead/cap bytes.  Per-block pass #2.

    Runs the native loop (csrc/native.c dict_encode_c — the analogue of the
    reference's threaded substitution stage, cr-diccode.c:142-221) when the
    runtime library is available; the Python path below is the executable
    specification and produces byte-identical output (tested)."""
    if not _NO_NATIVE and data.size:
        from comprox_tpu_torch.utils import native as _nat

        words, woff, codes, coff, esc, slots = _native_enc_tables(d)
        out = _nat.dict_encode_c(
            np.ascontiguousarray(data), words, woff, codes, coff,
            d.space, d.cap_byte, esc, slots,
        )
        if out is not None:
            return out
    return _dict_encode_py(data, d)


def _dict_encode_py(data: np.ndarray, d: WordDict) -> np.ndarray:
    raw = data.tobytes()
    esc = {
        lead: bytes(d.esc_code(j)) for j, lead in enumerate(d.leads)
    }
    if d.cap_byte >= 0:
        esc[d.cap_byte] = bytes(d.esc_code(len(d.leads)))
    cap = bytes([d.cap_byte]) if d.cap_byte >= 0 else None
    out = []
    pos = 0
    enc_map = d.enc_map
    word_re = _RE_SPACE if d.space else _RE_PLAIN
    for m in word_re.finditer(raw):
        start = m.start()
        if start > pos:
            out.append(_escape(raw[pos:start], esc))
        w = m.group(0)
        code = enc_map.get(w)
        if code is None and cap is not None:
            folded = fold_token(w)
            fcode = enc_map.get(folded) if folded is not None else None
            if fcode is not None:
                code = cap + fcode
        # unsubstituted words may still contain a lead-valued letter byte
        out.append(code if code is not None else _escape(w, esc))
        pos = m.end()
    out.append(_escape(raw[pos:], esc))
    return np.frombuffer(b"".join(out), np.uint8).copy()


def _escape(seg: bytes, esc: Dict[int, bytes]) -> bytes:
    if not any(bytes([b]) in seg for b in esc):  # fast path
        return seg
    return b"".join(esc.get(b, bytes([b])) for b in seg)


def _cap_first(w: bytes) -> bytes:
    if w and 97 <= w[0] <= 122:
        return bytes([w[0] - 32]) + w[1:]
    return w


def dict_decode(data: np.ndarray, d: WordDict) -> np.ndarray:
    """Expansion via the native loop (csrc/native.c dict_decode_c) when
    available; Python fallback below is the executable spec."""
    if not _NO_NATIVE and data.size:
        from comprox_tpu_torch.utils import native as _nat

        words, woff, one_map, two_map, lead_idx = _native_dec_tables(d)
        out = _nat.dict_decode_c(
            np.ascontiguousarray(data), words, woff, one_map, two_map,
            lead_idx, d.cap_byte,
        )
        if out is not None:
            return out
    return _dict_decode_py(data, d)


def _dict_decode_py(data: np.ndarray, d: WordDict) -> np.ndarray:
    """Expansion: every lead/cap byte starts a real code by construction
    (cb values never collide with leads), so no sequential re-scan is
    needed — a hybrid loop over code occurrences with bulk copies between
    them."""
    n = data.size
    if n == 0:
        return data
    one_map: Dict[int, bytes] = {
        b: w for b, w in zip(d.one_codes, d.words1)
    }
    two_words: Dict[Tuple[int, int], bytes] = {
        code: w for code, w in zip(d.two_codes(), d.words2)
    }
    for j, lead in enumerate(d.leads):
        two_words[d.esc_code(j)] = bytes([lead])
    if d.cap_byte >= 0:
        two_words[d.esc_code(len(d.leads))] = bytes([d.cap_byte])
    out: List[bytes] = []
    raw = data.tobytes()
    lead_set = set(d.leads)
    scan = list(d.leads) + list(d.one_codes)
    if d.cap_byte >= 0:
        scan.append(d.cap_byte)
    hits = np.flatnonzero(np.isin(data, np.array(scan, np.uint8)))
    prev = 0
    for i in hits:
        i = int(i)
        if i < prev:
            continue  # was a cb consumed by a preceding lead/cap
        out.append(raw[prev:i])
        b = int(data[i])
        capped = d.cap_byte >= 0 and b == d.cap_byte
        if capped:
            i += 1
            b = int(data[i]) if i < n else -1
        if b in lead_set:
            cb = int(data[i + 1]) if i + 1 < n else 0
            w = two_words.get((b, cb), b"")
            prev = i + 2
        elif b in one_map:
            w = one_map[b]
            prev = i + 1
        else:  # cap mark at end of block / before a non-code byte
            # (unreachable from our encoder — cap literals are escaped —
            # but fail soft: drop only the mark, keep the following byte)
            w = b""
            prev = i
        out.append(_cap_first(w) if capped else w)
    out.append(raw[prev:])
    return np.frombuffer(b"".join(out), np.uint8).copy()


# --------------------------------------------------------------------------
# blob entropy coding — the reference lz-encodes its dictionary with the
# codec itself (src/main.c:163-164); ours rode LCP-front-coded but raw
# until round 3 (tens of KB of plain text per archive).  The blob is a
# one-shot host-side object, so it gets a scalar adaptive order-1 model
# over the shared rANS spec (ops/rans_scalar.py) instead of a device
# compile: same entropy family as the block codec, zero geometry cost.
# --------------------------------------------------------------------------

_BLOB_INC = 32  # swept 16..64 on the bench-corpus blob: flat within 1%,
# shallow optimum at 32 (5810 of 11079 B = 47.6% shrink)


def _blob_update(freq: np.ndarray, tot: np.ndarray, ctx: int, b: int) -> None:
    """Shared model update (encode and decode replay identically)."""
    freq[ctx, b] += _BLOB_INC
    tot[ctx] += _BLOB_INC
    if tot[ctx] > (1 << 15) - _BLOB_INC:
        row = (freq[ctx] + 1) >> 1  # halve, keep >= 1
        freq[ctx] = row
        tot[ctx] = int(row.sum())


def blob_encode(raw: bytes) -> bytes:
    """Adaptive order-1 + scalar rANS over the packed dictionary bytes."""
    from comprox_tpu_torch.ops.rans_scalar import RansEncoder

    freq = np.ones((256, 256), np.int32)
    tot = np.full(256, 256, np.int32)
    ctx = 0
    events = []
    for b in raw:
        row = freq[ctx]
        events.append((int(row[:b].sum()), int(row[b]), int(tot[ctx])))
        _blob_update(freq, tot, ctx, b)
        ctx = b
    enc = RansEncoder()
    for c, f, t in reversed(events):
        enc.put(c, f, t)
    state, words = enc.finish()
    return struct.pack("<I", state) + np.array(words, "<u2").tobytes()


def blob_decode(coded: bytes, raw_len: int) -> bytes:
    """Inverse of blob_encode; raises ValueError on any corruption (the
    container's fail-clean contract — backed by the rANS drain check and
    the container's CRC over the RAW blob)."""
    from comprox_tpu_torch.ops.rans_scalar import (
        RANS_L,
        RansDecoder,
        decode_target,
    )

    if len(coded) < 4 or len(coded) % 2 != 0:
        raise ValueError("corrupt dictionary blob: bad coded length")
    (state,) = struct.unpack("<I", coded[:4])
    words = np.frombuffer(coded[4:], "<u2").tolist()
    dec = RansDecoder(state, words)
    freq = np.ones((256, 256), np.int32)
    tot = np.full(256, 256, np.int32)
    ctx = 0
    out = bytearray()
    try:
        for _ in range(raw_len):
            row = freq[ctx]
            t = decode_target(dec.slot(), int(tot[ctx]))
            cs = np.cumsum(row)
            b = int(np.searchsorted(cs, t, side="right"))
            cum = int(cs[b - 1]) if b else 0
            dec.advance(cum, int(row[b]), int(tot[ctx]))
            out.append(b)
            _blob_update(freq, tot, ctx, b)
            ctx = b
    except (IndexError, AssertionError) as e:
        raise ValueError(f"corrupt dictionary blob: {e!r}") from e
    if dec.x != RANS_L or dec.pos != len(words):
        raise ValueError("corrupt dictionary blob: rANS drain check failed")
    return bytes(out)


# --------------------------------------------------------------------------
# blob (de)serialization — LCP front-coding like cr-dicpick.c:261-346
# --------------------------------------------------------------------------


def pack_dict(d: WordDict) -> bytes:
    def front_code(words: List[bytes]) -> bytes:
        out = [struct.pack("<H", len(words))]
        prev = b""
        for w in words:
            lcp = 0
            while lcp < min(len(prev), len(w), 255) and prev[lcp] == w[lcp]:
                lcp += 1
            out.append(bytes([lcp, len(w) - lcp]) + w[lcp:])
            prev = w
        return b"".join(out)

    # cap_byte rides the blob as value+1 (0 = disabled) — forgetting a
    # format-relevant field here silently corrupts decode (same bug class
    # as the container-header omission, see test_container.py)
    head = struct.pack("<BHH", len(d.leads), len(d.one_codes),
                       d.cap_byte + 1)
    return (
        head
        + bytes(d.leads)
        + bytes(d.one_codes)
        + front_code(d.words1)
        + front_code(d.words2)
    )


def unpack_dict(blob: bytes) -> WordDict:
    """Parse a dictionary blob, validating structure so adversarial blobs
    fail with ValueError instead of IndexError/KeyError downstream (the
    container's fail-clean contract)."""
    if len(blob) < 5:
        raise ValueError("corrupt dictionary blob: too short")
    n_leads, n1, cap1 = struct.unpack("<BHH", blob[:5])
    if cap1 > 256:
        raise ValueError("corrupt dictionary blob: bad cap byte")
    off = 5
    if off + n_leads + n1 > len(blob):
        raise ValueError("corrupt dictionary blob: truncated code tables")
    leads = list(blob[off : off + n_leads])
    off += n_leads
    one_codes = list(blob[off : off + n1])
    off += n1

    def read_words(off):
        if off + 2 > len(blob):
            raise ValueError("corrupt dictionary blob: truncated word count")
        (k,) = struct.unpack("<H", blob[off : off + 2])
        off += 2
        words, prev = [], b""
        for _ in range(k):
            if off + 2 > len(blob):
                raise ValueError("corrupt dictionary blob: truncated word")
            lcp, slen = blob[off], blob[off + 1]
            off += 2
            if off + slen > len(blob) or lcp > len(prev):
                raise ValueError("corrupt dictionary blob: bad front-coding")
            w = prev[:lcp] + blob[off : off + slen]
            off += slen
            words.append(w)
            prev = w
        return words, off

    words1, off = read_words(off)
    words2, off = read_words(off)
    if len(words1) != n1:
        raise ValueError(
            "corrupt dictionary blob: one-byte code/word count mismatch"
        )
    cap_byte = cap1 - 1
    if len(set(leads)) != n_leads or set(leads) & set(one_codes):
        raise ValueError("corrupt dictionary blob: overlapping code bytes")
    if cap_byte >= 0 and cap_byte in set(leads) | set(one_codes):
        raise ValueError("corrupt dictionary blob: cap byte collides")
    d = WordDict(one_codes, words1, leads, words2, cap_byte=cap_byte)
    if len(words2) > len(d.two_codes()):
        raise ValueError("corrupt dictionary blob: two-byte code overflow")
    d.build_maps()
    return d
