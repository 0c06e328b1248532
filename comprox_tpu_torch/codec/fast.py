"""Block codec, mode F: the fast profile — LZ77 tokens + per-block static rANS.

Counterpart of :mod:`comprox_tpu.codec.fast` ("F2"), same names, same bytes.
Encode is whole-block passes: the sort finder (K7: for every position the
two nearest earlier positions with the same 6-byte hash, each with its
match length), the backward price DP shared with mode R (K6, with this
profile's prices), the tokenizer (K8: a per-lane replay of the decisions
to token starts, repeat-distance detection and compaction in position
order, one (sym, xtr, bits) triple per token) and the static rANS encoder
(K9: histogram, normalisation to sum exactly M, and a backward pass over
``ceil(n_tok / S)`` steps of three events per lane, K3's scan on a grid of
the tokens' events, whose flagged words K3b compacts into the stream).
Decode is the static rANS decoder (K10: slot table, the forward loop, one
u32 per token with the repeat distances resolved); the LZ copies run on
the host (``utils/native.f2_execute``), then the content CRC.  Under
``CPX_F_FINDER=scan`` (the JAX package's ratio-sweep route) the decisions
are mode X's instead (``block.x_decisions``: K4x, or KSx under
``CPX_X_FINDER=scan``; K6 at mode X's prices, K11, K6 with the repeat
pair), under mode X's knobs; K8, K9 and K10 as on the default route.

Alphabet: sym = literal byte (0..255) | 256 + dist_bucket * 13 + len_bucket
(distance buckets 0..23 = floor(log2 d), 24 = the previous distance; length
buckets: v = len - min_len, v < 8 direct, else 5 + floor(log2 v)).  The
length and distance mantissas concatenate into one bit string carried by
up to two table-free uniform events (XTR1 <= 15 bits, XTR2 the rest).

Payload: ``n_words, n_tok, crc32`` (u32), the static table (581 x u16),
the final states (S x u32), the stream (n_words x u16).

Each pass has a plain PyTorch version and a CUDA kernel; a wrapper takes
the plain version for CPU tensors and the kernel for CUDA tensors, never
one for the other.
"""

from __future__ import annotations

import dataclasses
import os as _os
import zlib

import numpy as np
import torch

from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec.block import (
    MASK32,
    BlockParams,
    _bytes_eq_count,
    _diag_run_len,
    _dispatch,
    _dist_bucket,
    _expect,
    _greedy_decisions_dist,
    _launch,
    _mul32,
    _stream_ptr,
    _to_i32,
)
from comprox_tpu_torch.ops import rans
from comprox_tpu_torch.ops.rans_scalar import M, M_BITS, RANS_L
from comprox_tpu_torch.utils import build, native

_i32 = torch.int32
_i64 = torch.int64

# Encoder knobs, read at import like the JAX package's (fast.py::_F_FINDER,
# _F_CANDS, _F_PRICES, _EXTW, _F_DIAG_TAIL, CPX_F_ENC_WIN).  The finder:
# 'sort' (K7 and K6 at this profile's prices) or 'scan' (mode X's finder
# and parse, under mode X's knobs; the JAX package's ratio-sweep route)
_F_FINDERS = ("sort", "scan")
_F_FINDER = _os.environ.get("CPX_F_FINDER", "sort")
_F_CANDS = int(_os.environ.get("CPX_F_CANDS", "2"))  # candidates per position
# parse prices in fifths of a bit: literal, match, per distance bucket (the
# F parse has no repeat candidate, so CPX_F_PARSE_REP has nothing to price)
_F_PRICES = tuple(
    int(_os.environ.get(k, d))
    for k, d in (
        ("CPX_F_PARSE_LIT", "28"),
        ("CPX_F_PARSE_M", "45"),
        ("CPX_F_PARSE_K", "6"),
    )
)
_EXTW = int(_os.environ.get("CPX_F_EXTW", "16"))  # word extension: 4*(EXTW-1) bytes
_F_DIAG_TAIL = _os.environ.get("CPX_F_DIAG_TAIL", "0") == "1"
_F_ENC_WIN = int(_os.environ.get("CPX_F_ENC_WIN", "0"))

L_DIRECT = 8  # len buckets 0..7 code v directly
L_BUCKETS = 13  # 8 direct + log buckets for v in [8, 250]
DB_REPEAT = 24  # distance bucket "== previous distance"
W_SYM = 256 + 25 * L_BUCKETS  # 581
N_SLOTS = 3  # SYM, XTR1, XTR2
_TAB_BYTES = 2 * W_SYM
MAX_CANDS = 7  # candidates the kernels keep per position
SCAN_TILE = 2048  # positions per CTA of the prefix scans (csrc/f2scan.cuh)
K8_CHUNK = 512  # steps of a lane a chunk of K8's replay (csrc/f2tok.cu: K8_C)
K8_TAKE_MAX = 256  # the longest take K8 takes: the window's cap
K10_RING = 32768  # words of K10's stream ring (csrc/f2dec.cu: K10_RING)


def check_supported(p: BlockParams) -> None:
    """Raise for a mode-F configuration or knob the port does not have."""
    blk.check_supported(p)
    if p.mode != "F":
        raise ValueError(f"the fast profile codes mode F blocks, not {p.mode!r}")
    if _F_FINDER not in _F_FINDERS:
        raise NotImplementedError(
            f"CPX_F_FINDER={_F_FINDER!r} is not a finder of comprox_tpu_torch "
            f"(only {' or '.join(repr(f) for f in _F_FINDERS)})"
        )
    if _F_ENC_WIN:
        raise NotImplementedError(
            f"CPX_F_ENC_WIN={_F_ENC_WIN}: the narrow stream-write window is a "
            "TPU cost strategy that never changes the bytes; the port has "
            "only the default 0 (ROADMAP.md item 17)"
        )
    if _F_FINDER == "scan":  # mode X's finder and parse: its knobs, not F's
        blk.check_x_finder()
        return
    if not 1 <= _F_CANDS <= MAX_CANDS:
        raise NotImplementedError(
            f"CPX_F_CANDS={_F_CANDS}: the port keeps 1..{MAX_CANDS} candidates"
        )
    if not 2 <= _EXTW <= 64:
        raise NotImplementedError(
            f"CPX_F_EXTW={_EXTW}: the port compares 2..64 words per candidate"
        )
    lit, p_m, p_k = _F_PRICES
    if min(_F_PRICES) < 0 or max(lit, p_m + 24 * p_k) >= 1 << 20:
        raise NotImplementedError(
            "CPX_F_PARSE_LIT/M/K must be non-negative prices below 2^20"
        )


def _cfg(p: BlockParams, n: int, stream_len: int = 0) -> np.ndarray:
    """The kernels' configuration struct with mode F's encoder knobs."""
    return blk._cfg_array(
        p, n, stream_len, n_cands=_F_CANDS, sort_ext=4 * (_EXTW - 1),
        p_lit=_F_PRICES[0], p_rm=_F_PRICES[1], p_ri=_F_PRICES[2],
        diag_tail=int(_F_DIAG_TAIL),
    )


def _len_code(v):
    """v = len - min_len in [0, 255] -> (bucket, extra bits, mantissa)."""
    k = 3 + (v >= 16).to(v.dtype) + (v >= 32).to(v.dtype) + (
        v >= 64).to(v.dtype) + (v >= 128).to(v.dtype)
    direct = v < L_DIRECT
    lb = torch.where(direct, v, 5 + k)
    bits = torch.where(direct, 0, k)
    mant = torch.where(direct, 0, v - (torch.ones_like(v) << k))
    return lb, bits, mant


def _len_decode(lb, mant):
    k = (lb - 5).clamp(0, 7)
    return torch.where(lb < L_DIRECT, lb, (torch.ones_like(lb) << k) + mant)


def _last_nonzero_fill(e):
    """[N] -> at each i the last positive value at an index <= i (0 if none)."""
    idx = torch.arange(e.shape[0], device=e.device)
    last = torch.cummax(torch.where(e > 0, idx, -1), dim=0).values
    return torch.where(last >= 0, e[last.clamp_min(0)], 0)


# --------------------------------------------------------------------------
# K7: the sort finder
# --------------------------------------------------------------------------


def pad_block(p: BlockParams, inp):
    """The block's bytes in position order with the finder's zero tail
    (4 * EXTW + 16 bytes, and up to the next multiple of 8): uint8."""
    return blk.pad_block(p, inp, 4 * _EXTW)


def sort_keys_plain(p: BlockParams, bytes_pad, n: int):
    """The finder's key of every position: a hash of its next 6 bytes
    (mod 2^32); 0xFFFFFFFF past n.  int64 [N] in [0, 2^32)."""
    big = p.capacity
    b = bytes_pad[: big + 6].to(_i64)
    w = b[:big] | (b[1 : big + 1] << 8) | (b[2 : big + 2] << 16) | (b[3 : big + 3] << 24)
    w45 = b[4 : big + 4] | (b[5 : big + 5] << 8)
    h = _mul32(w, 0x9E3779B1) ^ _mul32(w45, 0x85EBCA77)
    idx = torch.arange(big, device=bytes_pad.device)
    return torch.where(idx < n, h, MASK32)


def f2_find_plain(p: BlockParams, inp, n: int):
    """Plain K7: ``[2 * n_cands, T, S]`` int32 grids (len_0, src_0, len_1,
    ...) — for every position the n_cands nearest earlier positions with the
    same 6-byte hash, each with its match length: up to 4 * (EXTW - 1) bytes
    compared directly, longer where positions and candidates advance
    together (the diagonal run), capped at the lane's end, at n and at the
    window (fast.py::_f2_find)."""
    dev = inp.device
    big, steps, n_c = p.capacity, p.steps, _F_CANDS
    bi = pad_block(p, inp).to(_i64)
    nw = big + 4 * _EXTW + 12
    w_all = bi[:nw] | (bi[1 : nw + 1] << 8) | (bi[2 : nw + 2] << 16) | (bi[3 : nw + 3] << 24)
    idx = torch.arange(big, device=dev)
    valid = idx < n
    hs, ps = torch.sort(sort_keys_plain(p, bi, n), stable=True)
    cap = torch.minimum(steps - idx % steps, n - idx).clamp(max=p.window).clamp_min(0)
    out = []
    for k in range(1, n_c + 1):
        cand = torch.full((big,), -1, dtype=_i64, device=dev)
        cand[ps[k:]] = torch.where(hs[k:] == hs[:-k], ps[:-k], -1)
        ok = (cand >= 0) & valid
        safe = cand.clamp(0, big - 1)
        length = torch.zeros(big, dtype=_i64, device=dev)
        alive = ok
        for j in range(0, 4 * (_EXTW - 1), 4):
            x = w_all[safe + j] ^ w_all[j : j + big]
            length = length + torch.where(alive, _bytes_eq_count(x), 0)
            alive = alive & (x == 0)
        eq1 = (bi[:big] == bi[safe]) & ok
        diag = torch.cat([cand[1:] == cand[:-1] + 1,
                          torch.zeros(1, dtype=torch.bool, device=dev)])
        length = torch.maximum(length, _diag_run_len(eq1, diag, _F_DIAG_TAIL))
        out += [torch.minimum(torch.where(ok, length, 0), cap), cand]
    grids = torch.stack(out).to(_i32).view(2 * n_c, p.lanes, steps)
    return grids.transpose(1, 2).contiguous()


def sort_positions(p: BlockParams, bytes_pad, n: int, with_passes=False):
    """First stage of K7 on its own (keys, then the shared radix sort), for
    a comparison with a library sort: ``(hs, ps)`` int64, the keys
    ascending and the positions in (key, position) order (with
    ``with_passes`` also the radix passes run).  The main path goes
    through :func:`f2_find`, which counts its launch beside the sort's."""
    return blk.sort_positions(p, bytes_pad, n, keys=sort_keys_plain,
                              tag="k7", cfg=_cfg(p, n), ext=4 * _EXTW,
                              with_passes=with_passes)


def f2_find(p: BlockParams, inp, n: int):
    """K7 — the sort finder of the fast profile.

    Replaces comprox_tpu/codec/fast.py::_f2_find (178-246) with
    block.py::_bytes_eq_count (798), _diag_run_len (777) and _rev_runmin
    (764).  Kernels: mode F's entries of csrc/sortfind.cu, K4x's stages
    under mode F's configuration (keys, the radix sort of csrc/sortlib.cuh,
    the find from a staged window of sort ranks with every earlier position
    usable, the heads' extension, the final stage with links one step up
    and the diagonal runs where the extension falls short of the window).
    ``inp`` [S, T] uint8 -> [2 * n_cands, T, S] int32 (len, src per
    candidate).
    """
    if _dispatch(inp) == "cpu":
        return f2_find_plain(p, inp, n)
    _expect(inp, "inp", torch.uint8, (p.lanes, p.steps))
    bytes_pad = pad_block(p, inp)
    blk._check_finder(p, bytes_pad, 4 * _EXTW)
    big, dev, n_c = p.capacity, inp.device, _F_CANDS
    rec = torch.empty((big, blk.k4_record_ints(n_c)), dtype=_i32, device=dev)
    out = torch.empty((2 * n_c, p.steps, p.lanes), dtype=_i32, device=dev)
    cfg = _cfg(p, n)

    def stages():
        err, hs, ps, _ = blk._sort_stage("k7", cfg, big, bytes_pad)
        return err or build.lib().cpx_k7_find_launch(
            cfg.ctypes.data, bytes_pad.data_ptr(), hs.data_ptr(),
            ps.data_ptr(), rec.data_ptr(), out.data_ptr(), _stream_ptr())

    _launch("K7", stages)
    return out


def _search_params(p: BlockParams) -> BlockParams:
    """Mode F's parameters in mode X, for mode X's finder and parse
    (fast.py::_search_params)."""
    return dataclasses.replace(p, mode="X")


def _fast_find_matches(p: BlockParams, inp, n: int):
    """Candidates + parse -> the decision grids ``dec [>= 2, T, S]`` int32
    (take, src) (fast.py::_fast_find_matches).  Under ``CPX_F_FINDER=scan``
    they are mode X's decisions on the block (``block.x_decisions``: K4x or,
    under ``CPX_X_FINDER=scan``, KSx; K6 and K11 at mode X's prices), K7 and
    this profile's prices play no part."""
    if _F_FINDER == "scan":
        return blk.x_decisions(_search_params(p), inp, n)
    cands = f2_find(p, inp, n)
    if p.flexible:
        return blk.parse_scan(p, n, cands, prices=_F_PRICES, n_c=_F_CANDS)
    take, src = _greedy_decisions_dist(p, cands)
    return torch.stack([take, src]).contiguous()


# --------------------------------------------------------------------------
# K8: the tokenizer
# --------------------------------------------------------------------------


def _token_events(p: BlockParams, toks, n_tok: int):
    """Flat token arrays -> per-token (sym, xtr, bits), zero beyond n_tok
    (fast.py::_token_events)."""
    e0, dist = toks[:, 0].to(_i64), toks[:, 1].to(_i64)
    active = torch.arange(e0.shape[0], device=toks.device) < n_tok
    byte = e0 & 0xFF
    is_m = active & (((e0 >> 8) & 1) != 0)
    rep = ((e0 >> 9) & 1) != 0
    v = ((e0 >> 10) - p.min_len).clamp(0, 255)
    lb, len_bits, len_mant = _len_code(v)
    db = torch.where(rep, DB_REPEAT, _dist_bucket(dist.clamp_min(1)))
    explicit = is_m & ~rep
    kd = db.clamp(0, 23)
    dist_bits = torch.where(explicit, kd, 0)
    dist_mant = torch.where(explicit, dist - (torch.ones_like(dist) << kd), 0)
    sym = torch.where(active, torch.where(is_m, 256 + db * L_BUCKETS + lb, byte), 0)
    len_bits = torch.where(is_m, len_bits, 0)
    xtr = (torch.where(is_m, len_mant, 0) | (dist_mant << len_bits)) & MASK32
    tbits = torch.where(is_m, len_bits + dist_bits, 0)
    return sym.to(_i32), _to_i32(xtr), tbits.to(_i32)


def tokenize_plain(p: BlockParams, inp, n: int, dec):
    """Plain K8: ``(toks [N, 2] int32, n_tok, sym, xtr, tbits [N] int32)``.

    Replays the decisions lane by lane (a match of ``take`` bytes covers the
    next ``take - 1`` steps), marks a match whose distance equals the last
    match's before it in position order as a repeat, and moves the token
    starts to the front in position order, the other positions behind them
    (``toks[:, 0]`` = byte | is_match << 8 | repeat << 9 | len << 10,
    ``toks[:, 1]`` = distance); then one (sym, xtr, bits) per token
    (fast.py::_replay_body, _tokenize, _token_events)."""
    dev = inp.device
    take, src = dec[0], dec[1]
    lanes = torch.arange(p.lanes, device=dev)
    active = (lanes[None, :] * p.steps
              + torch.arange(p.steps, device=dev)[:, None]) < n
    start = torch.empty((p.steps, p.lanes), dtype=torch.bool, device=dev)
    rem = torch.zeros(p.lanes, dtype=_i32, device=dev)
    for t in range(p.steps):
        st = active[t] & (rem == 0)
        rem = torch.where(st & (take[t] > 0), take[t] - 1, (rem - 1).clamp_min(0))
        start[t] = st

    def flat(v):  # [T, S] -> [N] position order (pos = lane * T + t)
        return v.T.reshape(-1)

    startf = flat(start)
    takef = flat(take).to(_i64)
    is_m = startf & (takef > 0)
    pos = torch.arange(p.capacity, device=dev)
    dist = torch.where(is_m, (pos - flat(src)).clamp_min(1), 0)
    length = torch.where(is_m, takef, 0)
    n_tok = int(startf.sum())
    eprev = torch.cat([dist.new_zeros(1), dist[:-1]])
    prev = _last_nonzero_fill(eprev).clamp_min(1)
    rep = is_m & (dist == prev)
    e0 = (inp.reshape(-1).to(_i64) | (is_m.to(_i64) << 8)
          | (rep.to(_i64) << 9) | (length << 10))
    order = torch.cat([torch.nonzero(startf)[:, 0], torch.nonzero(~startf)[:, 0]])
    toks = torch.stack([e0[order], dist[order]], dim=-1).to(_i32)
    return (toks, n_tok) + _token_events(p, toks, n_tok)


def _scan_tiles(size: int) -> int:
    return -(-size // SCAN_TILE)


def tokenize(p: BlockParams, inp, n: int, dec):
    """K8 — the tokenizer of the fast profile.

    Replaces comprox_tpu/codec/fast.py::_replay_body (287-305) under its
    scan, _tokenize (308-340) with _last_nonzero_fill (140) and
    _token_events (343-367).  Kernels: csrc/f2tok.cu (the replay in chunks
    of ``K8_CHUNK`` steps: each chunk's exit map, the chunks' true entries
    through a look-back in chunk order, a walk a chunk writing its starts'
    takes in order, its token list, and the chunk's scan pair; the pairs'
    prefix scan; the emit, a warp a chunk, writing each token to its
    slot).  ``inp`` [S, T] uint8, ``dec`` [>= 2, T, S] int32 (take <=
    ``K8_TAKE_MAX``, src; 16-byte aligned on the card) -> (n_tok, sym,
    xtr, tbits [n_tok] int32): the tokens only.  JAX's flat
    token arrays, with the other positions moved behind the tokens, stand
    in for a compaction there and are kept by the plain version alone.
    """
    if _dispatch(inp, dec) == "cpu":
        _, n_tok, sym, xtr, tbits = tokenize_plain(p, inp, n, dec)
        return n_tok, sym[:n_tok], xtr[:n_tok], tbits[:n_tok]
    _expect(inp, "inp", torch.uint8, (p.lanes, p.steps))
    if dec.dim() != 3 or dec.shape[0] < 2:
        raise ValueError("dec: expected [>= 2, T, S]")
    _expect(dec, "dec", _i32, (dec.shape[0], p.steps, p.lanes))
    if dec.data_ptr() % 16:
        raise ValueError("dec must be 16-byte aligned (K8 reads the takes 16 bytes at a time)")
    big, dev = p.capacity, inp.device
    chunks = p.lanes * -(-p.steps // K8_CHUNK)
    lists = torch.empty(chunks * K8_CHUNK, dtype=torch.int16, device=dev)
    parts = torch.empty((chunks + 1, 2), dtype=_i32, device=dev)
    look = torch.empty(chunks + 2, dtype=_i32, device=dev)
    ev = torch.empty((3, big), dtype=_i32, device=dev)  # n_tok <= N slots
    cfg = _cfg(p, n)  # kept alive across the call that reads it
    _launch("K8", build.lib().cpx_k8_launch, cfg.ctypes.data,
            inp.data_ptr(), dec.data_ptr(), lists.data_ptr(), parts.data_ptr(),
            look.data_ptr(), ev.data_ptr(), _stream_ptr())
    n_tok, too_long = torch.stack((parts[-1, 0], look[-1])).tolist()
    if too_long:
        raise ValueError(f"dec: a take above {K8_TAKE_MAX}, the window's cap")
    return n_tok, ev[0, :n_tok], ev[1, :n_tok], ev[2, :n_tok]


# --------------------------------------------------------------------------
# K9: the static rANS encoder
# --------------------------------------------------------------------------


def normalize_freqs(h):
    """[W] raw counts -> [W] static frequencies summing exactly to M, with
    f > 0 iff h > 0: counts halve (never to 0) until their total fits 15
    bits, scale to M rounding down, and the drift lands on the first largest
    (fast.py::normalize_freqs).  Valid for any W < M."""
    h = h.to(_i64).clamp_min(0)
    while int(h.sum()) >= 1 << 15:
        h = torch.where(h > 0, (h >> 1).clamp_min(1), 0)
    n2 = max(int(h.sum()), 1)
    s = torch.where(h > 0, torch.div(h * M, n2, rounding_mode="floor").clamp_min(1), 0)
    imax = int(torch.nonzero(s == s.max())[0, 0])  # the first maximum
    s[imax] += M - int(s.sum())
    return s.to(_i32)


def _uniform_cf(tbits, val):
    """Table-free uniform event of ``tbits`` bits (0 bits = the identity)."""
    b = tbits.clamp(0, M_BITS)
    f = torch.ones_like(b) << (M_BITS - b)
    return rans.select_cf(b > 0, (val * f) & MASK32, f)


def encode_scan_plain(p: BlockParams, sym, xtr, tbits, n_tok: int):
    """Plain K9: ``(freq [581] int32, states [S] int64, stream [n_words]
    int32)`` — the static table of the first n_tok symbols, and the u16
    words in the decoder's read order: tokens go S at a time from the last
    step to the first, each as the events XTR2, XTR1, SYM, every lane
    emitting at most one word an event; the stream is the words in the
    reverse of that order, steps ascending, then SYM, XTR1, XTR2, then lanes
    ascending (fast.py::_encode_fast, 460-516, whose buffer holds them
    emitted first)."""
    dev, s = sym.device, p.lanes
    hist = torch.bincount(sym[:n_tok].to(_i64), minlength=W_SYM)
    freq = normalize_freqs(hist)
    cums = torch.cumsum(freq.to(_i64), 0) - freq
    t_tok = -(-n_tok // s)
    x = rans.init_states(s, dev)
    out = []
    k_all = torch.arange(s, device=dev)
    for t in range(t_tok - 1, -1, -1):
        k = t * s + k_all
        act = k < n_tok
        k = k.clamp_max(sym.shape[0] - 1)
        sy = torch.where(act, sym[k].to(_i64), 0)
        xt = torch.where(act, xtr[k].to(_i64) & MASK32, 0)
        tb_ = torch.where(act, tbits[k].to(_i64), 0)
        b1 = tb_.clamp_max(M_BITS)
        c1, f1 = _uniform_cf(b1, xt & (M - 1))
        c2, f2 = _uniform_cf(tb_ - b1, xt >> M_BITS)
        ca, fa = rans.select_cf(act, cums[sy], freq[sy].to(_i64))
        for c, f in ((c2, f2), (c1, f1), (ca, fa)):
            x, emit, word = rans.enc_put(x, c, f)
            out.append(word.flip(0)[emit.flip(0)])
    words = torch.cat(out) if out else torch.zeros(0, dtype=_i64, device=dev)
    return freq, x, words.flip(0).to(_i32)


def encode_scan(p: BlockParams, sym, xtr, tbits, n_tok: int):
    """K9 — the static rANS encoder of the fast profile.

    Replaces the second half of comprox_tpu/codec/fast.py::_encode_fast
    (460-516) with normalize_freqs (370), _uniform_cf (396) and
    _rev_window_write (405).  Kernels, one entry: csrc/f2enc.cu (the
    histogram, the normalisation, the token pass writing K3's event grid,
    slots SYM, XTR1, XTR2), then K3, K3p and K3b (csrc/rans.cu): the
    backward scan a thread a lane, the flags packed, the flagged words
    compacted in (step, slot, lane) order.
    ``sym, xtr, tbits`` [>= n_tok] int32 from K8 (xtr below 2^tbits) ->
    (freq [581] int32, states [S] int64, stream [n_words] int32 in the
    decoder's order).
    """
    freq, states, n_words, stream = _encode_scan(p, sym, xtr, tbits, n_tok)
    if stream.device.type == "cpu":
        return freq, states, stream
    return freq, states, stream[: int(n_words.item())].to(_i32) & 0xFFFF


def _encode_scan(p: BlockParams, sym, xtr, tbits, n_tok: int):
    """:func:`encode_scan` without the read of the word count: ``(freq,
    states, n_words, stream)``; on the card n_words is a [1] int32 tensor
    and stream K3b's whole int16 buffer, its first n_words the words (the
    pipelined block API copies the count with the states); on the CPU the
    plain version's count and words."""
    if _dispatch(sym, xtr, tbits) == "cpu":
        freq, states, words = encode_scan_plain(p, sym, xtr, tbits, n_tok)
        return freq, states, words.numel(), words
    blk._check_kernel_geometry(p)
    if not 0 <= n_tok <= min(sym.shape[0], p.capacity):
        raise ValueError(f"n_tok {n_tok} for {sym.shape[0]} slots, "
                         f"capacity {p.capacity}")
    for name, v in (("sym", sym), ("xtr", xtr), ("tbits", tbits)):
        _expect(v, name, _i32, sym.shape[:1])
    dev, s, lib = sym.device, p.lanes, build.lib()
    steps = -(-n_tok // s)
    rows = N_SLOTS * steps
    hist = torch.zeros((2, W_SYM), dtype=_i32, device=dev)  # counts, then cum
    freq = torch.empty(W_SYM, dtype=_i32, device=dev)
    states = torch.empty(s, dtype=_i64, device=dev)
    ev = torch.empty((steps, 3 * N_SLOTS, s), dtype=_i32, device=dev)
    emit = torch.empty((steps, N_SLOTS, s), dtype=torch.uint8, device=dev)
    words = torch.empty((steps, N_SLOTS, s), dtype=_i32, device=dev)
    packed = torch.empty((steps, N_SLOTS, s // 8), dtype=torch.uint8, device=dev)
    parts = torch.empty((lib.cpx_k3b_tiles(s, rows) + 1, 2), dtype=_i32, device=dev)
    n_words = torch.zeros(1, dtype=_i32, device=dev)
    stream = torch.empty(rows * s, dtype=torch.int16, device=dev)
    _launch("K9", lib.cpx_k9_launch, s, n_tok,
            sym.data_ptr(), xtr.data_ptr(), tbits.data_ptr(), hist.data_ptr(),
            freq.data_ptr(), states.data_ptr(), ev.data_ptr(), emit.data_ptr(),
            words.data_ptr(), packed.data_ptr(), parts.data_ptr(), n_words.data_ptr(),
            stream.data_ptr(), _stream_ptr())
    return freq, states, n_words, stream


# --------------------------------------------------------------------------
# K10: the static rANS decoder
# --------------------------------------------------------------------------


def _build_dec_table(freq):
    """[W] static freqs (sum == M) -> [M, 2] int32 slot table:
    row = (sym | cum << 10, frq) (fast.py::_build_dec_table)."""
    f = freq.to(_i64)
    cums = torch.cumsum(f, 0) - f
    slots = torch.arange(M, device=freq.device)
    sym = torch.searchsorted(cums, slots, right=True) - 1
    return torch.stack([sym | (cums[sym] << 10), f[sym]], dim=-1).to(_i32)


def _token_plane(p: BlockParams, sym, xtr, n_tok: int):
    """Decoded (sym, xtr) -> one u32 per token (int32 bits): a literal byte
    (< 256), or dist << 8 | len - min_len, every repeat distance replaced by
    the last explicit one before it (fast.py::_token_plane)."""
    sym, xtr = sym.to(_i64), xtr.to(_i64) & MASK32
    active = torch.arange(sym.shape[0], device=sym.device) < n_tok
    is_m = active & (sym >= 256)
    mc = torch.where(is_m, sym - 256, 0)
    db = torch.div(mc, L_BUCKETS, rounding_mode="floor")
    lb = mc % L_BUCKETS
    len_bits = torch.where(lb >= L_DIRECT, lb - 5, 0)
    len_mant = xtr & ((torch.ones_like(xtr) << len_bits) - 1)
    v = _len_decode(lb, len_mant).clamp(0, 255)
    dmant = _to_i32(xtr >> len_bits).to(_i64)
    dist_e = torch.where(is_m & (db < DB_REPEAT),
                         (torch.ones_like(db) << db.clamp(0, 23)) + dmant, 0)
    fill = _last_nonzero_fill(dist_e).clamp_min(1)
    dist = torch.where(is_m & (db == DB_REPEAT), fill, dist_e)
    plane = torch.where(is_m, (dist.clamp(1, (1 << 24) - 1) << 8) | v,
                        torch.where(active, sym, 0))
    return _to_i32(plane)


def decode_scan_plain(p: BlockParams, freq, states, stream, n_tok: int):
    """Plain K10: ``(states [S] int64, words_used, plane [N] int32)`` — one
    token per lane and step: the symbol by the slot table, then its up to
    two uniform events, every advance followed by a lane-ordered word read
    (fast.py::_fast_decode_scan, _token_plane)."""
    dev, s = states.device, p.lanes
    dtab = _build_dec_table(freq).to(_i64)
    sym_g = torch.zeros(p.capacity, dtype=_i64, device=dev)
    xtr_g = torch.zeros(p.capacity, dtype=_i64, device=dev)
    x, base = states.to(_i64), 0
    lanes = torch.arange(s, device=dev)

    def advance(x, base, cx, fx):
        x_tmp, need = rans.dec_advance(x, cx, fx)
        w, used = rans.stream_window_read(stream, base, need)
        return rans.dec_renorm(x_tmp, need, w), base + used

    for t in range(-(-n_tok // s)):
        act = t * s + lanes < n_tok
        e = dtab[rans.dec_slot(x)]
        sym = e[:, 0] & 1023
        c, f = rans.select_cf(act, e[:, 0] >> 10, e[:, 1])
        x, base = advance(x, base, c, f)
        is_m = act & (sym >= 256)
        mc = torch.where(is_m, sym - 256, 0)
        db = torch.div(mc, L_BUCKETS, rounding_mode="floor")
        lb = mc % L_BUCKETS
        len_bits = torch.where(lb >= L_DIRECT, lb - 5, 0)
        dist_bits = torch.where(is_m & (db < DB_REPEAT), db, 0)
        tb_ = torch.where(is_m, len_bits + dist_bits, 0)
        vals = []
        b1 = tb_.clamp_max(M_BITS)
        for b in (b1, tb_ - b1):
            fu = torch.ones_like(b) << (M_BITS - b)
            v = torch.where(b > 0, torch.div(rans.dec_slot(x), fu, rounding_mode="floor"), 0)
            cu, fx = rans.select_cf(b > 0, (v * fu) & MASK32, fu)
            x, base = advance(x, base, cu, fx)
            vals.append(v)
        k = (t * s + lanes)[act]
        sym_g[k] = sym[act]
        xtr_g[k] = ((vals[0] | (vals[1] << M_BITS)) & MASK32)[act]
    return x, base, _token_plane(p, sym_g, xtr_g, n_tok)


def decode_scan(p: BlockParams, freq, states, stream, n_tok: int):
    """K10 — the static rANS decoder of the fast profile.

    Replaces comprox_tpu/codec/fast.py::_build_dec_table (524),
    _fast_decode_scan (538-603) and _token_plane (606-639).  Kernels:
    csrc/f2dec.cu (the decode loop in one CTA, its slot table
    built in shared memory and the stream read through a ring of
    ``K10_RING`` words there; the token plane with its forward scan in three
    launches).  ``freq`` [581] int32 (summing to M), ``states`` [S] int64,
    ``stream`` [>= S] int32 (u16 words; 16-byte aligned on the card) ->
    (states [S] int64, words_used, plane [n_tok] int32): the tokens only,
    where the plain version keeps JAX's N slots.
    """
    x, used, plane = _decode_scan(p, freq, states, stream, n_tok)
    if states.device.type == "cuda":
        used = int(used.item())
    return x, used, plane


def _decode_scan(p: BlockParams, freq, states, stream, n_tok: int):
    """:func:`decode_scan` without the read of the words used: on the card
    that count stays a [1] int32 tensor (the pipelined block API copies it
    with the states)."""
    if _dispatch(freq, states, stream) == "cpu":
        x, used, plane = decode_scan_plain(p, freq, states, stream, n_tok)
        return x, used, plane[:n_tok]
    blk._check_kernel_geometry(p)
    _expect(freq, "freq", _i32, (W_SYM,))
    _expect(states, "states", _i64, (p.lanes,))
    if stream.dtype != _i32 or stream.dim() != 1 or stream.shape[0] < p.lanes:
        raise ValueError("stream: expected a 1-D int32 tensor of >= S words")
    _expect(stream, "stream", _i32, stream.shape)
    if not 0 <= n_tok <= p.capacity:
        raise ValueError(f"n_tok {n_tok} for capacity {p.capacity}")
    if stream.data_ptr() % 16:
        raise ValueError("stream must be 16-byte aligned (K10 copies 16 bytes at a time)")
    dev = states.device
    x = states.clone()
    grids = torch.empty((2, n_tok), dtype=_i32, device=dev)
    parts = torch.empty((_scan_tiles(n_tok) + 1, 2), dtype=_i32, device=dev)
    plane = torch.empty(n_tok, dtype=_i32, device=dev)
    used = torch.zeros(1, dtype=_i32, device=dev)
    _launch("K10", build.lib().cpx_k10_launch, p.lanes, n_tok,
            stream.shape[0], freq.data_ptr(), x.data_ptr(), stream.data_ptr(),
            grids.data_ptr(), parts.data_ptr(),
            plane.data_ptr(), used.data_ptr(), _stream_ptr())
    return x, used, plane


# --------------------------------------------------------------------------
# Host-facing block API
# --------------------------------------------------------------------------


def _max_words(p: BlockParams) -> int:
    # <= 1 word per event; a literal is 1 event, a match 3 events per >= 4
    # bytes, so n_words <= capacity; + a window for the decoder's last reads
    return p.capacity + 3 * p.lanes + 16


def encode_passes(p: BlockParams, inp, n: int):
    """K7, K6 (or the greedy decisions), K8, K9 on one [S, T] block tensor:
    ``(freq, states, stream, n_tok)``, the stream in the decoder's order."""
    dec = _fast_find_matches(p, inp, n)
    n_tok, sym, xtr, tbits = tokenize(p, inp, n, dec)
    freq, states, words = encode_scan(p, sym, xtr, tbits, n_tok)
    return freq, states, words, n_tok


def encode_block_fast_start(data: np.ndarray, p: BlockParams, device):
    """Enqueue a block's encode on ``device`` (K7, K6, K8, K9) and return its
    handle for :func:`encode_block_fast_finish` (fast.py::
    encode_block_fast_start).  The content CRC is computed here.  One read
    waits for the device: K8's token count, which sizes K9's grid (JAX
    sizes it at capacity), so this start waits for its own K7 and K8; K9's
    word count and the states are copied without waiting."""
    check_supported(p)
    n = int(data.size)
    inp, pin = blk._block_tensor(data, p, device)
    # the content CRC is this profile's corruption detector: a flipped
    # mantissa bit decodes to a valid stream with wrong bytes
    crc = zlib.crc32(data.tobytes()) & 0xFFFFFFFF
    dec = _fast_find_matches(p, inp, n)
    n_tok, sym, xtr, tbits = tokenize(p, inp, n, dec)
    freq, states, n_words, stream = _encode_scan(p, sym, xtr, tbits, n_tok)
    if isinstance(n_words, torch.Tensor):
        n_words = blk._host_copy(n_words)
    return (crc, n_tok, blk._host_copy(freq), blk._host_copy(states), n_words,
            stream, blk._mark(device), pin)


def encode_block_fast_finish(started) -> bytes:
    """Wait for the block's event, fetch its stream's first n_words and
    pack the payload (fast.py::encode_block_fast_finish)."""
    crc, n_tok, freq, states, n_words, stream, event, _ = started
    blk._wait(event)
    nw = int(n_words)
    words = blk._fetch(stream[:nw], event).numpy()
    return (
        np.array([nw, n_tok, crc], np.uint32).tobytes()
        + freq.numpy().astype("<u2").tobytes()
        + states.numpy().astype("<u4").tobytes()
        + words.astype("<u2").tobytes()
    )


def encode_block_fast(data: np.ndarray, p: BlockParams, device) -> bytes:
    """Encode up to p.capacity bytes on ``device``; returns the payload."""
    return encode_block_fast_finish(encode_block_fast_start(data, p, device))


def _unpack_payload(payload: bytes, n: int, p: BlockParams):
    """Payload -> ``(n_words, n_tok, crc, freq int32 [581], states uint32
    [S], stream int32 [max_words])``, with every check of the payload's
    shape (fast.py::decode_block_fast_start, 731-752, same texts)."""
    if n <= 0 or n > p.capacity:
        raise ValueError(f"corrupt block: bad raw size {n}")
    need = 12 + _TAB_BYTES + 4 * p.lanes
    if len(payload) < need:
        raise ValueError("corrupt block: truncated fast-block payload")
    n_words, n_tok, crc_want = (int(v) for v in np.frombuffer(payload[:12], "<u4"))
    off = 12
    freq = np.frombuffer(payload[off : off + _TAB_BYTES], "<u2").astype(np.int32)
    off += _TAB_BYTES
    if int(freq.sum()) != M:
        raise ValueError("corrupt block: static table sum != M")
    if not 0 < n_tok <= p.capacity:
        raise ValueError("corrupt block: bad token count")
    states = np.frombuffer(payload[off : off + 4 * p.lanes], "<u4")
    off += 4 * p.lanes
    words = np.frombuffer(payload[off : off + 2 * n_words], "<u2")
    if words.size != n_words or n_words > _max_words(p):
        raise ValueError("corrupt block: truncated stream")
    stream = np.zeros(_max_words(p), np.int32)
    stream[:n_words] = words
    return n_words, n_tok, crc_want, freq, states, stream


def decode_block_fast_start(payload: bytes, n: int, p: BlockParams, device):
    """Unpack a payload and enqueue K10 on ``device``; returns the handle for
    :func:`decode_block_fast_finish`, reading nothing back.  Every check of
    the payload's shape raises here, before anything is enqueued
    (fast.py::decode_block_fast_start)."""
    check_supported(p)
    n_words, n_tok, crc_want, freq, states, stream = _unpack_payload(payload, n, p)
    freq_t, pin_f = blk._staged(freq, device)
    states_t, pin_s = blk._staged(states.astype(np.int64), device)
    stream_t, pin_w = blk._staged(stream, device)
    x, used, plane = _decode_scan(p, freq_t, states_t, stream_t, n_tok)
    if isinstance(used, torch.Tensor):
        used = blk._host_copy(used)
    return (n, p.min_len, n_words, n_tok, crc_want, blk._host_copy(x), used, plane,
            blk._mark(device), (pin_f, pin_s, pin_w))


def _tokens_finish(started) -> np.ndarray:
    """Wait for the block's event, check that the states drained and every
    word was read, then fetch the token plane's first n_tok entries."""
    _, _, n_words, n_tok, _, x, used, plane, event, _ = started
    blk._wait(event)
    drained = bool((np.asarray(x) == RANS_L).all())
    used = int(used)
    if used != n_words or not drained:
        raise ValueError(
            f"corrupt block: states drained={drained} words {used}/{n_words}"
        )
    return np.ascontiguousarray(blk._fetch(plane[:n_tok], event).numpy().view(np.uint32))


def decode_block_fast_finish(started) -> np.ndarray:
    """The block's n bytes: the drain check, the token plane, the LZ copies
    on the host and the content CRC (fast.py::decode_block_fast_finish)."""
    n, min_len, _, _, crc_want = started[:5]
    res = native.f2_execute(_tokens_finish(started), min_len, n)
    if res is None:
        raise ValueError("corrupt block: token stream over/underruns")
    if (zlib.crc32(res.tobytes()) & 0xFFFFFFFF) != crc_want:
        raise ValueError("corrupt block: content CRC mismatch")
    return res


def decode_tokens(payload: bytes, n: int, p: BlockParams, device) -> np.ndarray:
    """Payload -> the token plane's first n_tok entries (uint32) on the host:
    the checks, K10, then the drain check."""
    return _tokens_finish(decode_block_fast_start(payload, n, p, device))


def decode_block_fast(payload: bytes, n: int, p: BlockParams, device) -> np.ndarray:
    """Decode a mode-F payload back to its n raw bytes on ``device``.  Every
    check of the payload's shape raises before anything runs on the device."""
    return decode_block_fast_finish(decode_block_fast_start(payload, n, p, device))


# ---- the grouped APIs (the container's -g for mode F, which has no block
# axis): a group's blocks in turn with one block in flight
# (fast.py::encode_blocks_fast, decode_blocks_fast)


def encode_blocks_fast(blocks: list, p: BlockParams, group: int, device) -> list:
    """The payloads of ``blocks``, block i+1 started before block i is
    finished."""
    out, pending = [], None
    for data in blocks:
        started = encode_block_fast_start(data, p, device)
        if pending is not None:
            out.append(encode_block_fast_finish(pending))
        pending = started
    if pending is not None:
        out.append(encode_block_fast_finish(pending))
    return out


def decode_blocks_fast(payloads: list, ns: list, p: BlockParams, group: int,
                       device) -> np.ndarray:
    """The blocks' bytes, concatenated, block i+1 started before block i is
    finished."""
    pieces, pending = [], None
    for payload, n in zip(payloads, ns):
        started = decode_block_fast_start(payload, n, p, device)
        if pending is not None:
            pieces.append(decode_block_fast_finish(pending))
        pending = started
    if pending is not None:
        pieces.append(decode_block_fast_finish(pending))
    return np.concatenate(pieces) if pieces else np.zeros(0, np.uint8)
