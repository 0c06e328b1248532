"""Block codec, modes R, X and P: S lock-step lanes over one block — ROLZ,
LZ77 or LZP matches + PPM + rANS.  (Mode F, the static-table fast profile,
is :mod:`comprox_tpu_torch.codec.fast`; it shares this module's parameters,
launch accounting and price DP.)

Counterpart of :mod:`comprox_tpu.codec.block` (modes R, X and P,
``short_depth=0``, unchained): a block of n bytes is cut into S contiguous lanes of T steps,
``position(lane, step) = lane * T + step``, and all lanes advance one byte
per step through shared model and bucket tables.  The payload layout, the
table evolution and every intermediate grid are the JAX package's.

Encode has two parses.  The flexible parse (the default) runs the
whole-block sort finder (K4: up to four context-keyed proposals per
position), the rank scan (K5: each proposal checked against the evolving
bucket table, plus one cache-scored bucket candidate) and the backward
price DP (K6: literal against any admissible truncation of the five
candidates).  The greedy parse (``-f0``) runs the search scan (KS: one
ROLZ candidate per position) and ``_greedy_decisions`` (two elementwise
ops).  Either way the modeling scan (K2) turns the decisions into
normalised rANS events and the backward rANS scan (K3) emits the words.
Decode is one scan (K1).

Mode X (the ``crx`` codec) codes a match as a distance: bucket
floor(log2(dist)) or "the previous distance again" in slot B, the length in
slot C and the distance's mantissa bits in two more slots D and E, five
rANS events a step.  Its flexible parse runs the sort finder keyed by the
position's own next six bytes (K4x: three causal earlier occurrences), the
price DP with distance prices (K6, X entry), the repeat-distance pass (K11:
the distance each lane would hold at each position under that parse, and
the match length at that distance) and the DP again with the repeat
candidate; ``-f0`` takes the longest candidate greedily.  The modeling scan
(K12e), the rANS scan (K3 at five slots) and the decode scan (K12d, which
keeps no match table) follow.  Under ``CPX_X_FINDER=scan`` the candidates
come from the per-step search scan instead (KSx: two bucket tables, keyed
by the next eight bytes and by the preceding context, and a 6-byte-hash
cache; three candidates a position); ``CPX_R_FINDER=scan`` sends mode R's
KS candidate through the price DP.

Mode P (the ``crp`` codec) is LZP: a match has no coded source.  Three
tables shared by the lanes map the hash of the last 8, 4 and 2 bytes to
the position that followed them last; both sides read the same candidate
before each byte, so a match is the A symbol plus its length.  Encode is
one modeling scan (K13e: candidate, match length against the window, A/B/C
events with the hit APM keyed by the candidate's availability) and K3 at
three slots; decode is one scan (K13d).  There is no search or parse pass.

Each pass has a plain PyTorch version and a
CUDA kernel; the wrapper picks the plain version for a CPU tensor and the
kernel for a CUDA tensor, and raises for anything else.  There is no
fallback between the two.
"""

from __future__ import annotations

import os as _os
from dataclasses import dataclass

import numpy as np
import torch

from comprox_tpu_torch.ops.rans_scalar import M, RANS_L
from comprox_tpu_torch.models import ppm
from comprox_tpu_torch.models import tables as tb
from comprox_tpu_torch.ops import rans
from comprox_tpu_torch.utils import build

_i32 = torch.int32
_i64 = torch.int64
MASK32 = rans.MASK32
_PACK_TAIL = 66  # zero words after the block (block.py::_pack_words)


@dataclass(frozen=True)
class BlockParams:
    """The JAX package's BlockParams: same fields, defaults and checks."""

    lanes: int = 256
    steps: int = 4096
    mode: str = "P"
    match: bool = True
    min_len: int = 4
    window: int = 250
    o3_bits: int = 22
    rolz_bits: int = 18
    rolz_depth: int = 64
    rolz_ctx_bytes: int = 3
    rolz_dec: int = 1
    short_depth: int = 0
    top_k: int = 4
    lazy_top_k: int = 4
    probe: int = 32
    flexible: bool = True
    chain_match: bool = False

    def __post_init__(self):
        if self.lanes % 8 or self.lanes < 8:
            raise ValueError("lanes must be a positive multiple of 8")
        if self.window > 256:
            raise ValueError("window must be <= 256")
        if (
            self.mode == "R"
            and self.short_depth
            and self.lanes * self.steps > (1 << 24)
        ):
            raise ValueError(
                "ROLZ short-match table requires block capacity <= 16 MiB "
                "(set short_depth=0 for larger blocks)"
            )
        if self.mode == "R" and self.short_depth not in (0, 8, 16):
            raise ValueError("short_depth must be 0, 8 or 16")
        if self.rolz_dec not in (1, 2, 4):
            raise ValueError("rolz_dec must be 1, 2 or 4")
        if self.mode == "R" and self.rolz_depth + self.short_depth > ppm.IDX_W:
            raise ValueError(
                f"rolz_depth + short_depth must be <= {ppm.IDX_W}"
            )
        if self.chain_match and (
            self.mode != "R"
            or not self.match
            or not self.flexible
            or self.short_depth
        ):
            raise ValueError(
                "chain_match requires mode R with the match layer, "
                "flexible parse and short_depth=0"
            )
        if self.mode in ("X", "F") and self.lanes * self.steps > (1 << 24):
            raise ValueError(
                "mode 'X' block capacity is capped at 16 MiB "
                f"(got {self.lanes * self.steps})"
            )

    @property
    def capacity(self) -> int:
        return self.lanes * self.steps

    @property
    def stream_fallback_words(self) -> int:
        return self.capacity // 2 + 16

    @property
    def stream_pad(self) -> int:
        return self.stream_fallback_words + self.n_slots * self.lanes

    @property
    def n_slots(self) -> int:
        return 5 if self.mode == "X" else 3

    @property
    def stream_pad_max(self) -> int:
        return self.n_slots * self.capacity + 16 + self.n_slots * self.lanes


# Encoder and read-strategy knobs of the JAX package, read at import like
# JAX's: the finders take either value of _FINDERS; the port implements the
# others at their default only, and any other value raises.
_ENV_DEFAULTS = {
    "CPX_R_FINDER": "sort",
    "CPX_X_FINDER": "sort",
    "CPX_SHORT_EXTRA": "2",
    "CPX_STREAM_READ": "auto",
    "CPX_DEBUG_EVT": "",
}
# the candidate source of modes R and X: the whole-block sort finder, or the
# per-step search scan (KS / KSx)
_FINDERS = ("sort", "scan")
_ENV_CHOICES = {"CPX_R_FINDER": _FINDERS, "CPX_X_FINDER": _FINDERS}
_ENV = {k: _os.environ.get(k, v) for k, v in _ENV_DEFAULTS.items()}

# Encoder-only knobs of the flexible parse, read at import like JAX's
# (block.py::_R_CANDS, _R_PROBE, _SORT_EXT, _P_LIT_R, _P_RM, _P_RI).
_R_CANDS = int(_os.environ.get("CPX_R_CANDS", "4"))  # proposals per position
_R_PROBE = int(_os.environ.get("CPX_R_PROBE", "16"))  # chain depth, each way
_SORT_EXT = int(_os.environ.get("CPX_SORT_EXT", "250"))  # word extension, bytes
# parse prices in fifths of a bit: literal, match, per idx recency bucket
_P_LIT_R = int(_os.environ.get("CPX_PARSE_LIT_R", "14"))
_P_RM = int(_os.environ.get("CPX_PARSE_RM", "50"))
_P_RI = int(_os.environ.get("CPX_PARSE_RI", "6"))
# mode X: literal, match, per distance bucket, repeat-distance match
_P_LIT_X = int(_os.environ.get("CPX_PARSE_LIT_X", "10"))
_P_XM = int(_os.environ.get("CPX_PARSE_XM", "65"))
_P_XK = int(_os.environ.get("CPX_PARSE_XK", "6"))
_P_XREP = int(_os.environ.get("CPX_PARSE_XREP", "45"))
SYM_DST_REPEAT = 24  # slot-B symbol "the previous distance again"
_P_INF = 1 << 22  # cost-to-go ceiling of the price DP (key packing: * 256)
_INSERT_LATE = 3  # a bucket entry for position q is inserted at step q + 3
_X_INSERT_LATE = 7  # KSx's content-keyed entry: at step q + 7
LZP4_BITS = 20  # mode P: the table keyed by the last 4 bytes
LZP8_BITS = 23  # and by the last 8
MAX_CANDS = 7  # proposals the kernels keep per position (plus the bucket's)


def x_finder_knobs() -> tuple:
    """Mode X's finder knobs ``(candidates, probed chain entries)``, read at
    call time like the JAX package's (CPX_X_CANDS, CPX_X_PROBE)."""
    return (int(_os.environ.get("CPX_X_CANDS", "3")),
            int(_os.environ.get("CPX_X_PROBE", "16")))


def x_prices() -> tuple:
    return (_P_LIT_X, _P_XM, _P_XK, _P_XREP)


def check_supported(p: BlockParams) -> None:
    """Raise for a block configuration or knob the port does not have."""
    ppm.check_knobs()
    for k, default in _ENV_DEFAULTS.items():
        allowed = _ENV_CHOICES.get(k, (default,))
        if _ENV[k] not in allowed:
            raise NotImplementedError(
                f"{k}={_ENV[k]!r} is not ported to comprox_tpu_torch "
                f"(only {' or '.join(repr(a) for a in allowed)})"
            )
    if p.mode not in ("R", "F", "X", "P"):
        raise NotImplementedError(
            f"mode {p.mode!r} is not a block mode of comprox_tpu_torch: "
            "R (crz), F (crf), X (crx) and P (crp) are"
        )
    if p.mode == "X":
        if ppm.SSE_X != 1:
            raise NotImplementedError(
                f"CPX_SSE_X={ppm.SSE_X} is not ported to comprox_tpu_torch "
                "(mode X codes with its hit APM on); see ROADMAP.md item 17"
            )
        if _os.environ.get("CPX_X_CTXCAND", "0") == "1":
            raise NotImplementedError(
                "CPX_X_CTXCAND=1 (context-keyed candidates in mode X) is not "
                "ported (ROADMAP.md item 17)"
            )
        n_c, probe = x_finder_knobs()
        if not 1 <= n_c <= MAX_CANDS:
            raise NotImplementedError(
                f"CPX_X_CANDS={n_c}: the port keeps 1..{MAX_CANDS} candidates"
            )
        if not 0 <= probe <= 64:
            raise NotImplementedError(
                f"CPX_X_PROBE={probe}: the port probes 0..64 chain entries"
            )
        if min(_P_LIT_X, _P_XM, _P_XK, _P_XREP) < 0 or max(
                _P_LIT_X, _P_XM + 24 * _P_XK, _P_XREP) >= 1 << 20:
            raise NotImplementedError(
                "CPX_PARSE_LIT_X/XM/XK/XREP must be non-negative prices "
                "below 2^20"
            )
    if p.short_depth:
        raise NotImplementedError(
            "short_depth > 0 is not ported (ROADMAP.md item 17)"
        )
    if p.chain_match:
        raise NotImplementedError(
            "chain_match (crz -C) is not yet ported (ROADMAP.md item 11)"
        )
    if not 1 <= _R_CANDS <= MAX_CANDS:
        raise NotImplementedError(
            f"CPX_R_CANDS={_R_CANDS}: the port keeps 1..{MAX_CANDS} proposals"
        )
    if not 1 <= _R_PROBE <= 64:
        raise NotImplementedError(
            f"CPX_R_PROBE={_R_PROBE}: the port probes 1..64 chain entries"
        )
    if _SORT_EXT < 1:
        raise NotImplementedError(f"CPX_SORT_EXT={_SORT_EXT} must be positive")
    if min(_P_LIT_R, _P_RM, _P_RI) < 0 or max(_P_LIT_R, _P_RM + 3 * _P_RI) >= 1 << 20:
        raise NotImplementedError(
            "CPX_PARSE_LIT_R/RM/RI must be non-negative prices below 2^20"
        )


# --------------------------------------------------------------------------
# u32 helpers: uint32 values live in int64 tensors masked to 32 bits
# --------------------------------------------------------------------------


def _mul32(a, c: int):
    """(a * c) mod 2^32 for a in [0, 2^32), without int64 overflow."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def _to_i32(v):
    """int64 in [0, 2^32) -> int32 with the same bits."""
    v = v & MASK32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(_i32)


def _byteswap32(v):
    return (
        ((v & 0xFF) << 24) | ((v & 0xFF00) << 8)
        | ((v >> 8) & 0xFF00) | (v >> 24)
    ) & MASK32


def rolz_hash3(key3, bits: int):
    """Context key -> ROLZ bucket (multiplicative hash, top ``bits``)."""
    v = _mul32(key3.to(_i64) & MASK32, 2654435761)
    return (v >> (32 - bits)) & ((1 << bits) - 1)


def lzp_hash4(ctx4):
    """Last 4 bytes -> slot of mode P's ``lzp4`` table."""
    return (_mul32(ctx4 & MASK32, 2654435761) >> 12) & ((1 << LZP4_BITS) - 1)


def lzp_hash8(ctx4, ctx4b):
    """Last 8 bytes (two packed words, one odd multiplier each) -> slot of
    mode P's ``lzp8`` table."""
    v = _mul32(ctx4 & MASK32, 2654435761) ^ _mul32(ctx4b & MASK32, 0xC2B2AE3D)
    return (v >> 10) & ((1 << LZP8_BITS) - 1)


def x_hash8(nx4, fol4, bits: int):
    """A position's next 8 bytes (two little-endian words) -> bucket of
    KSx's content-keyed table."""
    v = _mul32(nx4 & MASK32, 0x9E3779B1) ^ _mul32(fol4 & MASK32, 0x85EBCA77)
    return (v >> (32 - bits)) & ((1 << bits) - 1)


def x_hash6(win):
    """[S, >= 6] byte window -> slot of KSx's 2^16-entry near-match cache."""
    h = torch.zeros(win.shape[0], dtype=_i64, device=win.device)
    for j in range(6):
        h = _mul32(h, 123456791) ^ win[:, j].to(_i64)
    return (h ^ (h >> 15)) & 0xFFFF


def _rolz_key(ctx4, p: BlockParams):
    return ctx4 & (0xFFFFFF if p.rolz_ctx_bytes == 3 else MASK32)


def _rolz_ctx(c, p: BlockParams):
    return rolz_hash3(_rolz_key(c["ctx4"], p), p.rolz_bits)


def _dist_bucket(dist):
    """floor(log2(dist)) by integer compares, at most 24."""
    k = torch.zeros_like(dist)
    for j in range(1, 25):
        k = k + (dist >= (1 << j)).to(dist.dtype)
    return k


def _rec_bucket(sym_idx):
    """len-model context: recency bucket of the index (0 / 1-3 / 4-15 / 16+)."""
    return (sym_idx >= 1).to(_i32) + (sym_idx >= 4).to(_i32) + (
        sym_idx >= 16
    ).to(_i32)


def _fill_bucket(fill):
    """idx-model context: bucket fill quartile."""
    return torch.div(fill - 1, 16, rounding_mode="floor").clamp(0, 3)


def _len_cap(p: BlockParams) -> int:
    """The longest match the format codes: the window, or the length model."""
    return min(p.window, p.min_len + ppm.LEN_W - 1)


def _recency_ranks(cand_pos):
    """[S, D] bucket positions -> recency rank of every slot (how many
    entries are newer; equal positions order by slot id)."""
    d = cand_pos.shape[1]
    pi = cand_pos[:, :, None]
    pj = cand_pos[:, None, :]
    slot = torch.arange(d, device=cand_pos.device)
    newer = (pj > pi) | ((pj == pi) & (slot[None, None, :] > slot[None, :, None]))
    return newer.sum(dim=2, dtype=_i32)


def _rolz_src_of_rows(ent_rows, rec_idx):
    """Entry position (minus 1) whose recency rank is the coded index; -1
    when no slot has that rank."""
    pos = ent_rows[..., 0]
    sel = _recency_ranks(pos) == rec_idx[:, None]
    return torch.where(sel, pos, 0).sum(dim=1, dtype=_i32) - 1


def rolz_from_numpy(a, device):
    """The JAX bucket table ``rolz_ent`` [2^bits, D, 2] -> a port tensor
    (a copy: the port updates it in place)."""
    return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)


def rolz_to_numpy(t) -> np.ndarray:
    return t.cpu().numpy()


def _init_rolz(p: BlockParams, device):
    return torch.zeros(
        (1 << p.rolz_bits, p.rolz_depth, 2), dtype=_i32, device=device
    )


def _init_xsearch(p: BlockParams, device):
    """KSx's three encoder-private tables: the content-keyed and the
    context-keyed bucket table, and the near-match cache ``xshort``."""
    return (_init_rolz(p, device), _init_rolz(p, device),
            torch.zeros(1 << 16, dtype=_i32, device=device))


LZP_KEYS = ("lzp2", "lzp4", "lzp8")


def _init_lzp(p: BlockParams, device):
    """Mode P's three shared tables (position + 1 per slot, 0 = empty)."""
    sizes = (1 << 16, 1 << LZP4_BITS, 1 << LZP8_BITS)
    return {k: torch.zeros(n, dtype=_i32, device=device)
            for k, n in zip(LZP_KEYS, sizes)}


def lzp_from_numpy(d: dict, device) -> dict:
    """The JAX carry's ``lzp2/4/8`` -> port tensors (copies: the port
    updates them in place)."""
    return {k: torch.from_numpy(np.array(d[k], dtype=np.int32)).to(device)
            for k in LZP_KEYS}


def lzp_to_numpy(lzp: dict) -> dict:
    return {k: lzp[k].cpu().numpy() for k in LZP_KEYS}


def _lzp_candidate(c, lzp, t: int, p: BlockParams, hist_flat):
    """Mode P's match source, the same on both sides: the ``lzp8`` entry
    where it is causal (an earlier step of its lane) and its 8 preceding
    bytes equal the lane's last 8, else ``lzp4``'s under the same rule with
    4 bytes, else the exact ``lzp2`` entry.  A source too near its lane's
    head to be verified from decoded bytes is taken unverified.
    ``hist_flat`` is the block's bytes: the input on encode, the decoded
    buffer on decode.  ``(src, ok)``
    (block.py::_lzp_candidate)."""
    ctx4, ctx4b = c["ctx4"], c["ctx4b"]
    dev = ctx4.device
    src8 = lzp["lzp8"][lzp_hash8(ctx4, ctx4b)].to(_i64) - 1
    src4 = lzp["lzp4"][lzp_hash4(ctx4)].to(_i64) - 1
    src2 = lzp["lzp2"][ctx4 & 0xFFFF].to(_i64) - 1
    offs = torch.arange(8, device=dev)
    # byte pos - 8 + offs: 0..3 from ctx4b, 4..7 from ctx4, newest lowest
    packed = torch.where(offs[None, :] < 4, ctx4b[:, None], ctx4[:, None])
    want = (packed >> (((7 - offs) * 8) % 32)[None, :]) & 0xFF

    def verified(src, k, t_min):
        ok = (src >= 0) & (src % p.steps < t) & (t >= t_min)
        verifiable = ok & (src % p.steps >= k)
        idx = ((src - k).clamp_min(0)[:, None] + offs[None, :k]).clamp(
            0, hist_flat.shape[0] - 1)
        eq = (hist_flat[idx].to(_i64) == want[:, 8 - k:]).all(dim=1)
        return ok & (eq | ~verifiable)

    ok8, ok4 = verified(src8, 8, 8), verified(src4, 4, 4)
    ok2 = (src2 >= 0) & (src2 % p.steps < t) & (t >= 2)
    return torch.where(ok8, src8, torch.where(ok4, src4, src2)), ok8 | ok4 | ok2


def _init_carry(p: BlockParams, device):
    z = torch.zeros(p.lanes, dtype=_i64, device=device)
    c = {"ctx4": z, "ctx4b": z.clone(), "copy_rem": z.clone(),
         "copy_src": z.clone()}
    if p.mode == "X":
        c["prev_dist"] = torch.ones_like(z)
    return c


def _common_reads(c, t, n, p: BlockParams, tables):
    """Per-step contexts shared by the modeling scan and decode."""
    dev = c["ctx4"].device
    lanes = torch.arange(p.lanes, device=dev)
    pos = lanes * p.steps + t
    active = pos < n
    coding = active & (c["copy_rem"] == 0)
    copying = active & (c["copy_rem"] > 0)
    ctx4 = c["ctx4"]
    p1 = ctx4 & 0xFF
    p2 = (ctx4 >> 8) & 0xFF
    ctx2 = (p2 << 8) | p1
    ctx3 = ctx4 & 0xFFFFFF
    h3 = ppm.o3_hash(ctx3, tables["o3"].numel())
    pred, conf, pred2, conf2, raw = ppm.o3_read(tables, h3)
    return (lanes, pos, active, coding, copying, p1, ctx2, h3, pred, conf,
            pred2, conf2, raw)


def _bucket_insert(rolz, p: BlockParams, rctx, ins, pos, nx4,
                   late: int = _INSERT_LATE):
    """Insert (q+1, prefix) for q = pos-late into each bucket's oldest slot,
    IN PLACE; lanes inserting into one bucket in one step take consecutive
    oldest slots in lane order."""
    s = rctx.shape[0]
    lower = torch.ones((s, s), dtype=torch.bool, device=rctx.device).tril(-1)
    same = (rctx[:, None] == rctx[None, :]) & ins[None, :]
    rank = (same & lower).sum(dim=1)
    ins = ins & (rank < p.rolz_depth)
    old = rolz[rctx]
    age = (p.rolz_depth - 1) - _recency_ranks(old[..., 0])
    slot_ids = torch.arange(p.rolz_depth, device=rctx.device)
    slot = torch.where(age == rank[:, None], slot_ids, 0).sum(dim=1)
    r, sl = rctx[ins], slot[ins]
    rolz[r, sl, 0] = (pos - late + 1)[ins].to(_i32)
    rolz[r, sl, 1] = _to_i32(nx4[ins])


def _post_step(c, t, p: BlockParams, pos, active, byte, is_match, src,
               sym_len, rolz=None, dist=None, xsearch=None, lzp=None, n=None):
    """End-of-step state: copy state, context registers, mode X's previous
    distance (``dist`` given) and, where the caller keeps the bucket table,
    the insert of position pos-3.  KSx (``xsearch``) inserts position pos-7
    under its own next 8 bytes and position pos-3 under its context; mode P
    (``lzp`` and the block length ``n``) maps the contexts of position
    pos+1 to it, the highest position winning a slot."""
    ctx4, ctx4b = c["ctx4"], c["ctx4b"]
    c["copy_rem"] = torch.where(
        is_match, sym_len + (p.min_len - 1), (c["copy_rem"] - 1).clamp_min(0)
    ).to(_i64)
    c["copy_src"] = torch.where(is_match, src + 1, c["copy_src"] + 1).to(_i64)
    ctx4n = torch.where(active, ((ctx4 << 8) | byte.to(_i64)) & MASK32, ctx4)
    ctx4bn = torch.where(active, ((ctx4b << 8) | (ctx4 >> 24)) & MASK32, ctx4b)
    c["ctx4"], c["ctx4b"] = ctx4n, ctx4bn
    if dist is not None:
        c["prev_dist"] = torch.where(is_match, dist, c["prev_dist"])
    if rolz is not None:
        ins = active & (t >= (7 if p.rolz_ctx_bytes == 4 else 6))
        if p.rolz_dec > 1:
            ins = ins & (pos % p.rolz_dec == 0)
        rctx = rolz_hash3(_rolz_key(ctx4bn, p), p.rolz_bits)
        _bucket_insert(rolz, p, rctx, ins, pos, _byteswap32(ctx4n))
    if xsearch is not None:
        nx4q = _byteswap32(ctx4bn)  # bytes q..q+3 of q = pos-7
        _bucket_insert(xsearch[0], p,
                       x_hash8(nx4q, _byteswap32(ctx4n), p.rolz_bits),
                       active & (t >= 10), pos, nx4q, late=_X_INSERT_LATE)
        _bucket_insert(xsearch[1], p,
                       rolz_hash3(_rolz_key(ctx4bn, p), p.rolz_bits),
                       active & (t >= (7 if p.rolz_ctx_bytes == 4 else 6)),
                       pos, _byteswap32(ctx4n))
    if lzp is not None:
        ins2 = active & (t >= 1) & (t != p.steps - 1) & (pos + 1 < n)
        ins4 = ins2 & (t >= 3)
        val = (pos + 2).to(_i32)
        for key, ins, slot in (
                ("lzp2", ins2, ctx4n & 0xFFFF), ("lzp4", ins4, lzp_hash4(ctx4n)),
                ("lzp8", ins4 & (t >= 7), lzp_hash8(ctx4n, ctx4bn))):
            lzp[key].scatter_reduce_(0, slot[ins], val[ins], "amax",
                                     include_self=True)


def _pack_words(inp_flat):
    """[n] u8 -> [n/4 + tail] little-endian u32 words (int64 tensor)."""
    pad = (-inp_flat.shape[0]) % 4 + 4 * _PACK_TAIL
    b = torch.cat([inp_flat, inp_flat.new_zeros(pad)]).to(_i64).view(-1, 4)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def _gather_windows(inp_w32, src, width: int):
    """[S, width] byte windows of the word-packed block at per-lane ``src``
    (negative src reads from 0).  Windows may run into the next lane's
    bytes and into the zero tail."""
    nw = width // 4 + 2
    base = src.clamp_min(0).to(_i64)
    idx = (base >> 2)[:, None] + torch.arange(nw, device=src.device)
    words = inp_w32[idx.clamp(0, inp_w32.shape[0] - 1)]
    by = torch.stack(
        [words & 0xFF, (words >> 8) & 0xFF, (words >> 16) & 0xFF,
         (words >> 24) & 0xFF], dim=-1,
    ).reshape(src.shape[0], nw * 4)
    cols = (base & 3)[:, None] + torch.arange(width, device=src.device)
    return torch.gather(by, 1, cols).to(_i32)


def _prefix_len(cur_win, cand):
    """Common-prefix length per lane (positions before the first mismatch)."""
    neq = (cand != cur_win).to(_i32)
    return (torch.cumsum(neq, dim=-1) == 0).sum(dim=-1, dtype=_i32)


def _cur_windows(inp, t: int, width: int):
    """[S, width] upcoming bytes of each lane's own row, zero past T."""
    s, steps = inp.shape
    pad = inp.new_zeros((s, width))
    return torch.cat([inp[:, t:], pad], dim=1)[:, :width].to(_i32)


def _cache_scores(ent, cur_win):
    """[S, D] leading bytes (0..4) of each bucket entry's 4-byte prefix
    cache that equal the lane's next bytes; -1 for an empty slot."""
    nx = cur_win[:, :4].to(_i64)
    own = nx[:, 0] | (nx[:, 1] << 8) | (nx[:, 2] << 16) | (nx[:, 3] << 24)
    diff = (ent[..., 1].to(_i64) & MASK32) ^ own[:, None]
    score = (
        ((diff & 0xFF) == 0).to(_i32) + ((diff & 0xFFFF) == 0).to(_i32)
        + ((diff & 0xFFFFFF) == 0).to(_i32) + (diff == 0).to(_i32)
    )
    return torch.where(ent[..., 0] > 0, score, -1)


def _rolz_best_match(c, rolz, pos, t, n, p: BlockParams, inp_w32, cur_win,
                     x_keyed: bool = False, mask_fwd: bool = False):
    """Encoder-side candidate search at pos: score every bucket entry by
    its 4-byte prefix cache, probe the top-k to ``probe`` bytes, extend the
    winner to the full window, cap.  ``(length, src, rec_idx, fill)``.
    ``x_keyed`` reads the bucket of the position's own next 8 bytes, not of
    its context; ``mask_fwd`` (KSx, both tables) drops the entries at or
    after pos before the top-k: a distance cannot name them."""
    if x_keyed:
        nx = cur_win[:, :8].to(_i64)
        rctx = x_hash8(
            nx[:, 0] | (nx[:, 1] << 8) | (nx[:, 2] << 16) | (nx[:, 3] << 24),
            nx[:, 4] | (nx[:, 5] << 8) | (nx[:, 6] << 16) | (nx[:, 7] << 24),
            p.rolz_bits)
    else:
        rctx = _rolz_ctx(c, p)
    ent = rolz[rctx]
    cand_pos = ent[..., 0]
    score = _cache_scores(ent, cur_win)
    if mask_fwd:
        score = torch.where(cand_pos - 1 < pos[:, None], score, -1)
    rec = _recency_ranks(cand_pos)
    fill = (cand_pos > 0).sum(dim=1, dtype=_i32)
    d = p.rolz_depth
    rank_key = score * d + (d - 1 - rec)
    k_top = min(p.top_k, d)
    top_slots = torch.topk(rank_key, k_top, dim=1).indices
    lens, srcs, recs = [], [], []
    for k in range(k_top):
        sl = top_slots[:, k : k + 1]
        src_k = torch.gather(cand_pos, 1, sl)[:, 0] - 1
        sc_k = torch.gather(score, 1, sl)[:, 0]
        cand = _gather_windows(inp_w32, src_k, p.probe)
        len_k = _prefix_len(cur_win[:, : p.probe], cand)
        lens.append(torch.where(sc_k == 4, len_k, 0))
        srcs.append(src_k)
        recs.append(torch.gather(rec, 1, sl)[:, 0])
    lens_m = torch.stack(lens, 1)
    pick = torch.argmax(lens_m, dim=1, keepdim=True)  # first maximum
    length = torch.gather(lens_m, 1, pick)[:, 0]
    src = torch.gather(torch.stack(srcs, 1), 1, pick)[:, 0]
    sym_idx = torch.gather(torch.stack(recs, 1), 1, pick)[:, 0]
    cand = _gather_windows(inp_w32, src, p.window)
    full = _prefix_len(cur_win[:, : p.window], cand)
    length = torch.where(length >= p.probe, full, length)
    return torch.minimum(length, _cap_at(p, pos, t, n)), src, sym_idx, fill


# --------------------------------------------------------------------------
# KS: the search scan (greedy parse)
# --------------------------------------------------------------------------


def _cap_at(p: BlockParams, pos, t: int, n: int):
    """The longest match that may start at pos: to the end of the lane, of
    the block and of what the format codes (below 0 past the block)."""
    return torch.clamp(n - pos, max=min(p.steps - t, _len_cap(p))).to(_i32)


def _match_window_len(inp_w32, pos, src, t: int, n: int, p: BlockParams,
                      cur_win):
    """Length of the one candidate at ``src`` against the lane's next
    ``window`` bytes, capped (block.py::_match_window_len)."""
    cand = _gather_windows(inp_w32, src, p.window)
    length = _prefix_len(cur_win[:, : p.window], cand)
    return torch.minimum(length, _cap_at(p, pos, t, n))


def _search_step_x(p: BlockParams, inp_w32, n, c, xsearch, t, pos, active,
                   cur_win):
    """One KSx step before the inserts: the six grids' rows (length, src,
    len2, cand, len3, src3) — the best entry of the content-keyed bucket, the
    near-match cache's entry, the best entry of the context-keyed bucket —
    and the cache's update, IN PLACE (block.py::_search_body, X branch)."""
    ent_x, ent_c, xshort = xsearch

    def bucket(table, x_keyed):
        length, src, _, _ = _rolz_best_match(
            c, table, pos, t, n, p, inp_w32, cur_win, x_keyed, mask_fwd=True)
        ok = (src >= 0) & (src < pos) & active & (t >= 7)
        return torch.where(ok, length, 0), src

    length, src = bucket(ent_x, True)
    len3, src3 = bucket(ent_c, False)
    h6 = x_hash6(cur_win)
    cand = xshort[h6] - 1
    ok2 = (cand >= 0) & (cand < pos) & active & (t >= 7)
    full = _prefix_len(cur_win[:, : p.window],
                       _gather_windows(inp_w32, cand.clamp_min(0), p.window))
    # the cap is below 0 past the block's end, and stays so in the grid
    len2 = torch.minimum(torch.where(ok2, full, 0), _cap_at(p, pos, t, n))
    xshort.scatter_reduce_(0, h6[active], (pos + 1).to(_i32)[active], "amax",
                           include_self=True)
    return length, src, len2, cand, len3, src3


def search_scan_plain(p: BlockParams, inp, n: int, rolz):
    """Plain KS: ``[4, T, S]`` int32 grids (length, src, rec_idx, fill);
    ``rolz`` evolves IN PLACE (block.py::_search_body, R branch).  Plain
    KSx (mode X; ``rolz`` is the three tables of :func:`_init_xsearch`):
    ``[6, T, S]`` (length, src, len2, cand, len3, src3), K6's three (len,
    src) candidates."""
    dev = inp.device
    c = _init_carry(p, dev)
    inp_w32 = _pack_words(inp.reshape(-1))
    x_mode = p.mode == "X"
    out = torch.empty((6 if x_mode else 4, p.steps, p.lanes), dtype=_i32,
                      device=dev)
    width = p.window + 1
    for t in range(p.steps):
        pos = torch.arange(p.lanes, device=dev) * p.steps + t
        active = pos < n
        cur_win = _cur_windows(inp, t, width)
        zero = torch.zeros_like(pos)
        if x_mode:
            for k, g in enumerate(_search_step_x(
                    p, inp_w32, n, c, rolz, t, pos, active, cur_win)):
                out[k, t] = g
            _post_step(c, t, p, pos, active, cur_win[:, 0], zero.bool(), zero,
                       zero, xsearch=rolz)
            continue
        length, src, sym_idx, fill = _rolz_best_match(
            c, rolz, pos, t, n, p, inp_w32, cur_win
        )
        out[0, t] = torch.where(active & (t >= 7), length, 0)
        out[1, t] = src
        out[2, t] = sym_idx
        out[3, t] = fill
        _post_step(c, t, p, pos, active, cur_win[:, 0], zero.bool(), zero,
                   zero, rolz)
    return out


def _greedy_decisions(p: BlockParams, length, src, accept=None):
    """Greedy accept-longest with a one-step lazy check over the whole
    [T, S] grid (block.py::_greedy_decisions): ``(take, src)``.  ``accept``
    is the least length taken (default ``min_len``, the R branch)."""
    len_next = torch.cat([length[1:], torch.zeros_like(length[:1])], dim=0)
    do = (length >= (p.min_len if accept is None else accept)) & (
        len_next <= length + 1)
    return torch.where(do, length, 0), src


def _greedy_decisions_dist(p: BlockParams, cands):
    """The mode-X branch of block.py::_greedy_decisions on ``[2 * n_c, T, S]``
    (len, src) grids: the longest candidate (ties to the earlier, nearer
    one), accepted from ``max(min_len, 2 + 3k/4)`` bytes on, k the distance
    bucket of its source."""
    l1, s1 = cands[0], cands[1]
    for i in range(1, cands.shape[0] // 2):
        use = cands[2 * i] > l1
        l1 = torch.where(use, cands[2 * i], l1)
        s1 = torch.where(use, cands[2 * i + 1], s1)
    dev = cands.device
    pos = (torch.arange(p.lanes, device=dev)[None, :] * p.steps
           + torch.arange(p.steps, device=dev)[:, None])
    k = _dist_bucket((pos - s1).clamp_min(1))
    accept = (2 + torch.div(3 * k, 4, rounding_mode="floor")).clamp_min(p.min_len)
    return _greedy_decisions(p, l1, s1, accept)


# --------------------------------------------------------------------------
# K4: the whole-block sort finder (flexible parse)
# --------------------------------------------------------------------------


def _bytes_eq_count(x):
    """Leading equal bytes of a xor'd little-endian word: 0..4."""
    return torch.where(
        x == 0, 4,
        ((x & 0xFF) == 0).to(_i64) + ((x & 0xFFFF) == 0).to(_i64)
        + ((x & 0xFFFFFF) == 0).to(_i64),
    )


def _rev_runmin(m, inf: int):
    """Reverse running minimum by Hillis-Steele doubling."""
    n, k = m.shape[0], 1
    while k < n:
        m = torch.minimum(m, torch.cat([m[k:], m.new_full((k,), inf)]))
        k <<= 1
    return m


def _diag_run_len(eq1, diag, with_tail: bool = True):
    """Per-position run length of eq1 along the candidate diagonal, plus
    (``with_tail``) one for a last byte that matches where the diagonal
    ends."""
    n = eq1.shape[0]
    idx = torch.arange(n, device=eq1.device)
    nf = _rev_runmin(torch.where(eq1 & diag, n + 1, idx), n + 1)
    if not with_tail:
        return nf.clamp_max(n) - idx
    tail = torch.where(nf < n, eq1[nf.clamp_max(n - 1)].to(_i64), 0)
    return nf.clamp_max(n) - idx + tail


def sort_ext(p: BlockParams) -> int:
    """Bytes of the finder's word extension (a multiple of 4 is compared)."""
    return min(_SORT_EXT, p.window)


def pad_block_len(p: BlockParams, ext=None) -> int:
    pad = (sort_ext(p) if ext is None else ext) + 16
    return p.capacity + pad + (-(p.capacity + pad)) % 8


def pad_block(p: BlockParams, inp, ext=None):
    """The block's bytes in position order with a sort finder's zero tail
    (ext + 16 bytes, and up to the next multiple of 8; ext defaults to
    K4's): uint8."""
    return torch.cat([inp.reshape(-1),
                      inp.new_zeros(pad_block_len(p, ext) - p.capacity)])


def sort_keys_plain(p: BlockParams, bytes_pad, n: int, content: bool = False):
    """The finder's key of every position: the Knuth hash (mod 2^32) of the
    rolz_ctx_bytes bytes before it; 0xFFFFFFFF where there is no such
    context or the position is past n.  ``content`` (mode X) keys a
    position by its own next six bytes instead (the two-multiplier hash of
    the fast profile's finder).  int64 [N] in [0, 2^32)."""
    big, cb = p.capacity, p.rolz_ctx_bytes
    b = bytes_pad[: big + 6].to(_i64)
    w = b[:big] | (b[1 : big + 1] << 8) | (b[2 : big + 2] << 16) | (b[3 : big + 3] << 24)
    if content:
        w45 = b[4 : big + 4] | (b[5 : big + 5] << 8)
        h = _mul32(w, 0x9E3779B1) ^ _mul32(w45, 0x85EBCA77)
        idx = torch.arange(big, device=bytes_pad.device)
        return torch.where(idx < n, h, MASK32)
    wp = torch.cat([w.new_zeros(cb), w[: big - cb]])
    if cb == 3:
        wp = wp & 0xFFFFFF
    idx = torch.arange(big, device=bytes_pad.device)
    return torch.where((idx >= cb) & (idx < n), _mul32(wp, 2654435761), MASK32)


def _finder_config(p: BlockParams, content: bool) -> tuple:
    """``(n_cands, chain entries earlier in sort order, later in sort
    order, insert decimation)`` of the sort finder: mode R's
    configuration, or (``content``) mode X's."""
    if content:
        n_c, probe = x_finder_knobs()
        return n_c, max(probe, n_c), 0, 1
    return _R_CANDS, max(_R_PROBE, _R_CANDS), _R_PROBE, p.rolz_dec


def sort_candidates_plain(p: BlockParams, inp, n: int, content: bool = False):
    """Plain K4: ``[2 * n_cands, T, S]`` int32 grids (len_0, src_0, len_1,
    ...) — for every position the n_cands best of the 2 * probe nearest
    positions in (key, position) sort order with the same preceding
    context, each with its match length (block.py::sort_candidates, the R
    configuration: keyed by the context bytes, decode-causal, decimated
    like the bucket inserts).  ``content`` is the X configuration (K4x):
    keyed by the position's own six bytes, the chain runs backward only
    and every position counts as inserted; a chain no longer than n_cands
    is taken whole, in chain order."""
    dev = inp.device
    big, steps = p.capacity, p.steps
    n_c, chain_b, fwd, dec = _finder_config(p, content)
    chain = chain_b + fwd
    ext = sort_ext(p)
    bi = pad_block(p, inp).to(_i64)
    nw = big + ext + 12
    w_all = bi[:nw] | (bi[1 : nw + 1] << 8) | (bi[2 : nw + 2] << 16) | (bi[3 : nw + 3] << 24)
    idx = torch.arange(big, device=dev)
    h = sort_keys_plain(p, bi, n, content)
    hs, ps = torch.sort(h, stable=True)
    rows = torch.full((big, chain), -1, dtype=_i64, device=dev)
    for k in range(1, chain_b + 1):  # earlier in sort order
        same = hs[k:] == hs[:-k]
        rows[ps[k:], k - 1] = torch.where(same, ps[:-k], -1)
    for k in range(1, fwd + 1):  # later in sort order
        same = hs[:-k] == hs[k:]
        rows[ps[:-k], chain_b + k - 1] = torch.where(same, ps[k:], -1)
    t_of = idx % steps

    def causal(cand):
        ok = (cand >= 0) & ((cand % steps) < t_of)
        if dec > 1:
            ok = ok & ((cand + _INSERT_LATE) % dec == 0)
        return ok

    if chain > n_c:
        own0, own1 = w_all[:big], w_all[4 : 4 + big]
        score = torch.empty((big, chain), dtype=_i64, device=dev)
        for k in range(chain):
            cand = rows[:, k]
            safe = cand.clamp(0, big - 1)
            m0 = _bytes_eq_count(w_all[safe] ^ own0)
            m1 = _bytes_eq_count(w_all[safe + 4] ^ own1)
            plen = torch.where(causal(cand), m0 + torch.where(m0 == 4, m1, 0), -1)
            score[:, k] = plen * chain + (chain - 1 - k)
        top = torch.topk(score, n_c, dim=1).indices  # scores are distinct
        rows = torch.gather(rows, 1, top)
    cap = torch.minimum(steps - t_of, n - idx).clamp(
        max=_len_cap(p)).clamp_min(0)
    out = []
    for k in range(n_c):
        cand = rows[:, k]
        ok = causal(cand)
        safe = cand.clamp(0, big - 1)
        length = torch.zeros(big, dtype=_i64, device=dev)
        alive = ok
        for j in range(0, ext, 4):
            x = w_all[safe + j] ^ w_all[j : j + big]
            length = length + torch.where(alive, _bytes_eq_count(x), 0)
            alive = alive & (x == 0)
        eq1 = (bi[:big] == bi[safe]) & ok
        diag = torch.cat([cand[1:] == cand[:-1] + 1,
                          torch.zeros(1, dtype=torch.bool, device=dev)])
        length = torch.maximum(length, _diag_run_len(eq1, diag))
        out += [torch.minimum(torch.where(ok, length, 0), cap), cand]
    grids = torch.stack(out).to(_i32).view(2 * n_c, p.lanes, steps)
    return grids.transpose(1, 2).contiguous()


# --------------------------------------------------------------------------
# K5: the rank scan (flexible parse)
# --------------------------------------------------------------------------


def rank_scan_plain(p: BlockParams, inp, n: int, props, rolz):
    """Plain K5: ``[3 * (n_c + 1) + 1, T, S]`` int32 grids — (len, src,
    recency index) of every proposal, its length zeroed unless the evolving
    bucket of the position's context holds the source, then of one
    cache-scored bucket candidate, then the bucket fill.  ``props`` is K4's
    ``[2 * n_c, T, S]``; ``rolz`` evolves IN PLACE
    (block.py::_rolz_rank_body)."""
    dev = inp.device
    n_c = props.shape[0] // 2
    c = _init_carry(p, dev)
    inp_w32 = _pack_words(inp.reshape(-1))
    out = torch.empty((3 * (n_c + 1) + 1, p.steps, p.lanes), dtype=_i32,
                      device=dev)
    len_cap = _len_cap(p)
    d = p.rolz_depth
    for t in range(p.steps):
        pos = torch.arange(p.lanes, device=dev) * p.steps + t
        active = pos < n
        cur_win = _cur_windows(inp, t, p.window + 1)
        ent = rolz[_rolz_ctx(c, p)]
        ent_pos = ent[..., 0]
        rec = _recency_ranks(ent_pos)
        for k in range(n_c):
            l_k, s_k = props[2 * k, t], props[2 * k + 1, t]
            present = ent_pos == (s_k + 1)[:, None]
            valid = present.any(dim=1) & active & (t >= 7) & (l_k > 0)
            out[3 * k, t] = torch.where(valid, l_k, 0)
            out[3 * k + 1, t] = s_k
            out[3 * k + 2, t] = torch.where(present, rec, 0).sum(dim=1)
        score = _cache_scores(ent, cur_win)
        slot = torch.argmax(score * d + (d - 1 - rec), dim=1, keepdim=True)
        src_b = torch.gather(ent_pos, 1, slot)[:, 0] - 1
        sc_b = torch.gather(score, 1, slot)[:, 0]
        cand_w = _gather_windows(inp_w32, src_b.clamp_min(0), p.window)
        len_b = _prefix_len(cur_win[:, : p.window], cand_w)
        cap = torch.clamp(n - pos, max=min(p.steps - t, len_cap)).clamp_min(0)
        valid_b = (sc_b == 4) & active & (t >= 7)
        out[3 * n_c, t] = torch.where(valid_b, torch.minimum(len_b, cap), 0)
        out[3 * n_c + 1, t] = src_b
        out[3 * n_c + 2, t] = torch.gather(rec, 1, slot)[:, 0]
        out[3 * n_c + 3, t] = (ent_pos > 0).sum(dim=1)
        zero = torch.zeros_like(pos)
        _post_step(c, t, p, pos, active, cur_win[:, 0], zero.bool(), zero,
                   zero, rolz)
    return out


# --------------------------------------------------------------------------
# K11: the repeat-distance pass (flexible parse, mode X)
# --------------------------------------------------------------------------


def rep_scan_plain(p: BlockParams, inp, n: int, dec):
    """Plain K11: ``[2, T, S]`` int32 grids (len_rep, prev).  ``prev`` is the
    distance each lane would hold BEFORE each position when the modeling
    scan executes the decisions ``dec`` (take, src): decisions inside a
    running copy are skipped (block.py::_sim_prev_dist).  ``len_rep`` is
    the length of the match at that distance: the run of positions whose
    byte equals the byte ``prev`` back, whose source lies at an earlier
    step of its lane and whose expected ``prev`` stays the same, capped
    (block.py::_rep_lengths)."""
    dev = inp.device
    steps, lanes = p.steps, p.lanes
    take, src = dec[0].to(_i64), dec[1].to(_i64)
    base = torch.arange(lanes, device=dev) * steps
    out = torch.empty((2, steps, lanes), dtype=_i32, device=dev)
    rem = torch.zeros(lanes, dtype=_i64, device=dev)
    prev = torch.ones(lanes, dtype=_i64, device=dev)
    for t in range(steps):
        out[1, t] = prev
        start = (rem == 0) & (take[t] > 0)
        prev = torch.where(start, (base + t - src[t]).clamp_min(1), prev)
        rem = torch.where(rem > 0, rem - 1, torch.where(start, take[t] - 1, 0))
    flat = inp.reshape(-1).to(_i64)
    rl = torch.zeros(lanes, dtype=_i64, device=dev)
    prev_next = torch.ones(lanes, dtype=_i64, device=dev)
    for t in range(steps - 1, -1, -1):
        pos = base + t
        prev_t = out[1, t].to(_i64)
        src_rep = pos - prev_t
        back = flat[src_rep.clamp(0, flat.shape[0] - 1)]
        eq = ((flat[pos] == back) & (src_rep >= 0)
              & (src_rep % steps < t) & (pos < n))
        rl = torch.where(eq, 1 + torch.where(prev_next == prev_t, rl, 0), 0)
        prev_next = prev_t
        cap = torch.clamp(n - pos, max=min(steps - t, _len_cap(p))).clamp_min(0)
        out[0, t] = torch.minimum(rl, cap)
    return out


# --------------------------------------------------------------------------
# K6: the backward price DP (flexible parse)
# --------------------------------------------------------------------------


def _cand_min_cost(p: BlockParams, cw, length, price):
    """min over l in [min_len, length] of price + cost[t + l] with the
    achieving l, ties to the longest l; ``cw[:, j]`` holds cost[t + 1 + j].
    Real costs saturate below _P_INF; no admissible l gives _P_INF."""
    offs = torch.arange(cw.shape[1], device=cw.device)[None, :]
    mask = (offs + 1 >= p.min_len) & (offs + 1 <= length[:, None])
    cost = (cw + price[:, None]).clamp_max(_P_INF - 1)
    key = torch.where(mask, cost * 256 + (255 - offs), _P_INF * 256)
    best = key.min(dim=1).values
    return best // 256, 256 - best % 256


def parse_scan_plain(p: BlockParams, n: int, cands, prices=None, n_c=None,
                     rep=None):
    """Plain K6: per lane, backward over the steps, the cheaper of a literal
    and any admissible truncation of a candidate, priced against the
    cost-to-go of the next ``window`` steps (block.py::_parse_body under the
    reversed scan).

    Mode R (``prices`` None): ``cands`` is K5's ``[3 * n_c + 1, T, S]`` grids
    (len, src, recency index per candidate, then the fill, which is passed
    through) -> ``dec [4, T, S]`` int32 (take, src, recency index, fill).

    Mode F (``prices`` = (literal, match, per distance bucket), ``n_c``
    candidates): ``cands`` is the fast finder's ``[2 * n_c, T, S]`` (len,
    src); a match costs ``match + bucket * floor(log2(pos - src))`` ->
    ``dec [3, T, S]`` int32 (take, src, zeros).

    Mode X: as mode F with its own prices (literal, match, per distance
    bucket, repeat) and, on its second run, ``rep`` = K11's ``[2, T, S]``
    (len_rep, prev): a candidate at the distance ``prev`` costs the repeat
    price, and the repeat candidate (len_rep, pos - prev) is tried last, so
    that it wins a tie."""
    dev = cands.device
    fast = prices is not None
    if fast:
        per, (lit, p_m, p_k) = 2, prices[:3]
        if rep is not None:
            p_rep, rg = prices[3], rep.to(_i64)
    else:
        per, lit, n_c = 3, _P_LIT_R, (cands.shape[0] - 1) // 3
    cg = cands.to(_i64)
    dec = torch.zeros((3 if fast else 4, p.steps, p.lanes), dtype=_i32,
                      device=dev)
    if not fast:
        dec[3] = cands[3 * n_c]
    cw = torch.zeros((p.lanes, p.window), dtype=_i64, device=dev)
    lanes = torch.arange(p.lanes, device=dev)
    for t in range(p.steps - 1, -1, -1):
        pos = lanes * p.steps + t
        active = pos < n
        best_cost = lit + cw[:, 0]
        best_len = torch.zeros_like(best_cost)
        best_src, best_idx = best_len, best_len
        tries = []
        for k in range(n_c):
            lx, sx = cg[per * k, t], cg[per * k + 1, t]
            if fast:
                ix = torch.zeros_like(lx)
                d = (pos - sx).clamp_min(1)
                price = p_m + p_k * _dist_bucket(d)
                if rep is not None:
                    price = torch.where(d == rg[1, t], p_rep, price)
            else:
                ix = cg[3 * k + 2, t]
                price = _P_RM + _P_RI * _rec_bucket(ix)
            tries.append((lx, sx, ix, price))
        if rep is not None:
            tries.append((rg[0, t], pos - rg[1, t], torch.zeros_like(pos),
                          torch.full_like(pos, p_rep)))
        for lx, sx, ix, price in tries:
            cost_m, l_m = _cand_min_cost(p, cw, lx, price)
            better = (cost_m <= best_cost) & (cost_m < _P_INF)
            best_len = torch.where(better, l_m, best_len)
            best_src = torch.where(better, sx, best_src)
            best_idx = torch.where(better, ix, best_idx)
            best_cost = torch.minimum(best_cost, cost_m)
        best_cost = torch.where(active, best_cost.clamp_max(_P_INF - 1), 0)
        dec[0, t] = torch.where(active, best_len, 0)
        dec[1, t] = best_src
        dec[2, t] = best_idx
        cw = torch.cat([best_cost[:, None], cw[:, :-1]], dim=1)
    return dec


# --------------------------------------------------------------------------
# Mode X: the distance mantissa (slots D and E).  For buckets k in [5, 16]
# slot D codes the top 4 mantissa bits through the adaptive [16, 16] table
# ``mant`` (row k - 5) and slot E the other k - 4 bits uniformly; the other
# buckets split their k bits uniformly into a high part (k - 12 bits, k > 16
# only) and a low part.  A uniform b-bit value v is the event
# (v << (15 - b), 1 << (15 - b)).
# --------------------------------------------------------------------------


def _mant_read(tables, mctx):
    rows = tables["mant"][mctx.long()]
    return rows, tb.exclusive_cumsum(rows), tb.row_total(rows)


def _mant_update(tables, mctx, sym, act):
    """Every adaptive lane adds MANT_INC to its (row, symbol), IN PLACE;
    then each row whose sum is over MANT_CAP is halved."""
    tab = tables["mant"]
    m = act & (sym >= 0) & (sym < 16)
    flat = (mctx * 16 + sym)[m].long()
    tab.view(-1).index_add_(
        0, flat, torch.full(flat.shape, ppm.MANT_INC, dtype=_i32,
                            device=tab.device))
    need = tab.sum(dim=1, keepdim=True, dtype=_i32) > ppm.MANT_CAP
    tab.copy_(torch.where(need, (tab + 1) >> 1, tab))


def _mant_split(k_dist, has_extra):
    """``(adaptive, mctx, b_hi, b_lo, b_e)`` of a distance bucket: both
    sides derive the D/E layout from the bucket alone."""
    adaptive = has_extra & (k_dist >= 5) & (k_dist <= 16)
    mctx = (k_dist - 5).clamp(0, 11)
    b_hi = torch.where(k_dist > 16, k_dist - 12, 0)
    b_lo = k_dist.clamp_max(12)
    b_e = torch.where(adaptive, k_dist - 4, b_lo)
    return adaptive, mctx, b_hi, b_lo, b_e


def _mant_events_enc(tables, dist, k_dist, has_extra):
    """Encode side: ``(cd, fd, act_d, ce, fe, act_e)`` and the table update
    (block.py::_mant_events_enc)."""
    one = torch.ones_like(dist)
    e = dist - (one << k_dist)
    adaptive, mctx, b_hi, b_lo, b_e = _mant_split(k_dist, has_extra)
    top4 = (e >> (k_dist - 4).clamp_min(0)) & 15
    rows, cums, tot = _mant_read(tables, mctx)
    cm_raw, fm_raw = tb.cum_frq_of(rows, cums, top4)
    cm, fm = rans.norm_cf(cm_raw, fm_raw.clamp_min(1), tot.clamp_min(1))
    fd_u = one << (15 - b_hi)
    act_d = has_extra & (adaptive | (b_hi > 0))
    cd = torch.where(adaptive, cm, (e >> b_lo) * fd_u)
    fd = torch.where(adaptive, fm, fd_u)
    cd, fd = rans.select_cf(act_d, cd, fd)
    act_e = has_extra & (b_e > 0)
    fe = one << (15 - b_e)
    ce, fe = rans.select_cf(act_e, (e & ((one << b_e) - 1)) * fe, fe)
    _mant_update(tables, mctx, top4, adaptive)
    return cd & 0xFFFF, fd & 0xFFFF, act_d, ce & 0xFFFF, fe & 0xFFFF, act_e


def _sse_hitx(p: BlockParams, conf, p1, lzp_ok=None):
    """The hit-only APM of modes X and P: (table key, contexts), else None.
    Mode P's is keyed by whether the lane has a candidate (``lzp_ok``; None
    with the match layer off, which then has no APM)."""
    if p.mode == "X" and ppm.SSE_X:
        return ("sse_x", ppm.sse_x_ctx_of(conf, p1))
    if p.mode == "P" and ppm.SSE_P and lzp_ok is not None:
        return ("sse_p", ppm.sse_p_ctx_of(conf, lzp_ok, p1))
    return None


# --------------------------------------------------------------------------
# K2 / K12e / K13e: the modeling scan
# --------------------------------------------------------------------------


def _model_step(p: BlockParams, inp, n, c, tables, t, dec_t, lzp=None,
                inp_w32=None):
    (lanes, pos, active, coding, copying, p1, ctx2, h3, pred, conf,
     pred2, conf2, raw) = _common_reads(c, t, n, p, tables)
    valid2 = conf2 > 0
    byte = inp[:, t].to(_i64)
    x_mode, p_mode = p.mode == "X", p.mode == "P"
    lzp_ok = None
    if p_mode:
        # no parse: the shared tables name the one candidate; it is coded
        # where it is long enough
        src = length = sym_idx = fill = torch.zeros_like(pos)
        do_match = torch.zeros_like(coding)
        if lzp is not None:
            src, lzp_ok = _lzp_candidate(c, lzp, t, p, inp.reshape(-1))
            length = _match_window_len(
                inp_w32, pos, src, t, n, p,
                _cur_windows(inp, t, p.window)).to(_i64)
            do_match = coding & lzp_ok & (length >= p.min_len)
    elif x_mode:
        length, src = dec_t[0].to(_i64), dec_t[1].to(_i64)
        sym_idx = fill = torch.zeros_like(length)
        do_match = coding & (length > 0)
    else:
        length, src, sym_idx, fill = (g.to(_i64) for g in dec_t)
        do_match = coding & (length > 0)
    sse_hitx = _sse_hitx(p, conf, p1, lzp_ok)
    rows2, rowmod, cums_a, tot_a, o2_hd, sse_st = ppm.read_o2(
        tables, ctx2, pred, coding, conf,
        sse_fill=fill if (p.match and p.mode == "R") else None,
        sse_hitx=sse_hitx,
    )
    f_byte = torch.gather(rowmod, 1, byte[:, None])[:, 0]
    sym_a = torch.where(
        do_match, ppm.SYM_MATCH,
        torch.where(byte == pred, ppm.SYM_HIT,
                    torch.where(f_byte > 0, byte, ppm.SYM_ESC)),
    )
    ca_raw, fa_raw = tb.cum_frq_of(rowmod, cums_a, sym_a)
    ca, fa = rans.norm_cf(ca_raw, fa_raw.clamp_min(1), tot_a.clamp_min(1))
    ca, fa = rans.select_cf(coding, ca, fa)
    is_esc = coding & (sym_a == ppm.SYM_ESC)
    is_match = coding & (sym_a == ppm.SYM_MATCH)

    rows1, wmod, cums1, tot1 = ppm.read_o1_excl(
        tables, p1, rows2, pred, pred2, valid2
    )
    c1_raw, f1_raw = tb.cum_frq_of(wmod, cums1, byte)
    if x_mode:
        # B of a match lane: the distance bucket, or "the previous distance"
        dist = torch.where(do_match, (pos - src).clamp_min(1), 1)
        k_dist = _dist_bucket(dist)
        idx_ctx = torch.zeros_like(k_dist)
        len_ctx = torch.div(k_dist, 6, rounding_mode="floor").clamp(0, 3)
        repeat = is_match & (dist == c["prev_dist"])
        sym_dst = torch.where(repeat, SYM_DST_REPEAT, k_dist)
        rows_i, cums_i, tot_i = ppm.read_dst(tables, is_match)
        ci_raw, fi_raw = tb.cum_frq_of(rows_i, cums_i, sym_dst)
    elif not p_mode:
        idx_ctx = _fill_bucket(fill)
        len_ctx = _rec_bucket(sym_idx)
        rows_i, cums_i, tot_i = ppm.read_idx(tables, is_match, idx_ctx)
        ci_raw, fi_raw = tb.cum_frq_of(rows_i, cums_i, sym_idx)
    if p_mode:  # a match has no source to code: B is the escape only
        idx_ctx = len_ctx = torch.zeros_like(pos)
        cb_raw, fb_raw, tot_b, act_b = c1_raw, f1_raw, tot1, is_esc
    else:
        cb_raw = torch.where(is_esc, c1_raw, ci_raw)
        fb_raw = torch.where(is_esc, f1_raw, fi_raw)
        tot_b = torch.where(is_esc, tot1, tot_i)
        act_b = is_esc | is_match
    cb, fb = rans.norm_cf(cb_raw, fb_raw.clamp_min(1), tot_b.clamp_min(1))
    cb, fb = rans.select_cf(act_b, cb, fb)

    sym_len = (length - p.min_len).clamp(0, ppm.LEN_W - 1)
    rows_l, cums_l, tot_l = ppm.read_len(tables, is_match, len_ctx)
    cl_raw, fl_raw = tb.cum_frq_of(rows_l, cums_l, sym_len)
    cc, fc = rans.norm_cf(cl_raw, fl_raw.clamp_min(1), tot_l.clamp_min(1))
    cc, fc = rans.select_cf(is_match, cc, fc)

    ppm.apply_updates(
        tables, coding, ctx2, sym_a, byte, f_byte, p1, h3, pred, conf,
        sym_len, sym_idx, o2_hd, len_ctx, idx_ctx, raw,
        sym_dst=sym_dst if x_mode else None,
    )
    is_hit = coding & (sym_a == ppm.SYM_HIT)
    if sse_hitx is not None:
        ppm.sse_update_hit(tables, sse_hitx[0], sse_st, coding, is_hit)
    elif sse_st is not None:
        ppm.sse_update(tables, sse_st, coding, is_match, is_hit)
    out = [ca, fa, coding.to(_i64), cb, fb, act_b.to(_i64),
           cc, fc, is_match.to(_i64)]
    if x_mode:
        # D/E read the step-start mantissa table (no update above touches it)
        cd, fd, act_d, ce, fe, act_e = _mant_events_enc(
            tables, dist, k_dist, is_match & ~repeat)
        out += [cd, fd, act_d.to(_i64), ce, fe, act_e.to(_i64)]
    # the modeling scan reads its decisions from the parse, never a match
    # table, so it keeps none and does no insert (the bytes are the same)
    _post_step(c, t, p, pos, active, byte, is_match, src, sym_len,
               dist=dist if x_mode else None, lzp=lzp, n=n)
    return torch.stack(out).to(_i32)


def model_scan_plain(p: BlockParams, inp, n: int, dec, tables, lzp=None):
    """Plain K2 / K12e / K13e: ``ev [T, 3 * n_slots, S]`` int32 — (c, f,
    active) for slots A, B, C (mode X: and D, E); ``tables`` and mode P's
    ``lzp`` evolve IN PLACE (block.py::_encode_model_body)."""
    c = _init_carry(p, inp.device)
    ev = torch.empty((p.steps, 3 * p.n_slots, p.lanes), dtype=_i32,
                     device=inp.device)
    inp_w32 = None if lzp is None else _pack_words(inp.reshape(-1))
    for t in range(p.steps):
        ev[t] = _model_step(p, inp, n, c, tables, t,
                            None if dec is None else dec[:, t], lzp, inp_w32)
    return ev


# --------------------------------------------------------------------------
# K3: the backward rANS scan
# --------------------------------------------------------------------------


def rans_scan_plain(p: BlockParams, ev):
    """Plain K3: ``(states [S] int64, emit [T, n_slots, S] bool, words
    [T, n_slots, S] int32)``, the slots of a step from the last to the first
    (the rans_body scan of block.py::_encode_passes)."""
    steps, rows, s = ev.shape
    n_slots = rows // 3
    x = rans.init_states(s, ev.device)
    emit = torch.empty((steps, n_slots, s), dtype=torch.bool, device=ev.device)
    words = torch.empty((steps, n_slots, s), dtype=_i32, device=ev.device)
    for t in range(steps - 1, -1, -1):
        for si in range(n_slots - 1, -1, -1):
            cx = ev[t, 3 * si].to(_i64) & 0xFFFF
            fx = (ev[t, 3 * si + 1].to(_i64) & 0xFFFF).clamp_min(1)
            cv, fv = rans.select_cf(ev[t, 3 * si + 2] != 0, cx, fx)
            x, emit[t, si], wd = rans.enc_put(x, cv, fv)
            words[t, si] = wd.to(_i32)
    return x, emit, words


# --------------------------------------------------------------------------
# K1: the decode scan
# --------------------------------------------------------------------------


def _decode_step(p: BlockParams, stream, n, c, tables, rolz, x, base, out, t,
                 lzp=None):
    (lanes, pos, active, coding, copying, p1, ctx2, h3, pred, conf,
     pred2, conf2, raw) = _common_reads(c, t, n, p, tables)
    valid2 = conf2 > 0
    step_off = 0

    def advance(x, off, cx, fx):
        x_tmp, need = rans.dec_advance(x, cx, fx)
        w, used = rans.stream_window_read(stream, base + off, need)
        return rans.dec_renorm(x_tmp, need, w), off + used

    x_mode, p_mode = p.mode == "X", p.mode == "P"
    lzp_ok = None
    if x_mode:  # distances are coded: the decoder keeps no match table
        fill = torch.zeros_like(pos)
    elif p_mode:
        # the candidate comes before the A event (its APM is keyed by it),
        # from the bytes of earlier steps: this step's column is not written
        fill = lzp_src = torch.zeros_like(pos)
        if lzp is not None:
            lzp_src, lzp_ok = _lzp_candidate(c, lzp, t, p, out.view(-1))
    else:
        rolz_rows = rolz[_rolz_ctx(c, p)]
        fill = (rolz_rows[..., 0] > 0).sum(dim=1, dtype=_i32)
    sse_hitx = _sse_hitx(p, conf, p1, lzp_ok)
    rows2, rowmod, cums_a, tot_a, o2_hd, sse_st = ppm.read_o2(
        tables, ctx2, pred, coding, conf,
        sse_fill=fill if (p.match and p.mode == "R") else None,
        sse_hitx=sse_hitx,
    )
    tgt = rans.dec_target(rans.dec_slot(x), tot_a.clamp_min(1))
    sym_a, ca_raw, fa_raw = tb.find_symbol(rowmod, cums_a, tgt)
    ca, fa = rans.norm_cf(ca_raw, fa_raw.clamp_min(1), tot_a.clamp_min(1))
    x, step_off = advance(x, step_off, *rans.select_cf(coding, ca, fa))
    is_hit = coding & (sym_a == ppm.SYM_HIT)
    is_esc = coding & (sym_a == ppm.SYM_ESC)
    is_match = coding & (sym_a == ppm.SYM_MATCH)
    is_lit = coding & (sym_a < 256)

    rows1, wmod, cums1, tot1 = ppm.read_o1_excl(
        tables, p1, rows2, pred, pred2, valid2
    )
    slot_b = rans.dec_slot(x)
    sym1, c1_raw, f1_raw = tb.find_symbol(
        wmod, cums1, rans.dec_target(slot_b, tot1.clamp_min(1))
    )
    if x_mode:
        rows_i, cums_i, tot_i = ppm.read_dst(tables, is_match)
        sym_dst, ci_raw, fi_raw = tb.find_symbol(
            rows_i, cums_i, rans.dec_target(slot_b, tot_i.clamp_min(1))
        )
        sym_dst = sym_dst.to(_i64)
        sym_idx = idx_ctx = torch.zeros_like(sym_dst)
        k_pre = torch.where(sym_dst == SYM_DST_REPEAT,
                            _dist_bucket(c["prev_dist"]), sym_dst).clamp(0, 24)
        len_ctx = torch.div(k_pre, 6, rounding_mode="floor").clamp(0, 3)
    elif not p_mode:
        idx_ctx = _fill_bucket(fill)
        rows_i, cums_i, tot_i = ppm.read_idx(tables, is_match, idx_ctx)
        sym_idx, ci_raw, fi_raw = tb.find_symbol(
            rows_i, cums_i, rans.dec_target(slot_b, tot_i.clamp_min(1))
        )
        len_ctx = _rec_bucket(sym_idx)
    if p_mode:  # B is the escape only
        sym_idx = idx_ctx = len_ctx = torch.zeros_like(pos)
        cb_raw, fb_raw, tot_b, act_b = c1_raw, f1_raw, tot1, is_esc
    else:
        cb_raw = torch.where(is_esc, c1_raw, ci_raw)
        fb_raw = torch.where(is_esc, f1_raw, fi_raw)
        tot_b = torch.where(is_esc, tot1, tot_i)
        act_b = is_esc | is_match
    cb, fb = rans.norm_cf(cb_raw, fb_raw.clamp_min(1), tot_b.clamp_min(1))
    x, step_off = advance(x, step_off, *rans.select_cf(act_b, cb, fb))

    rows_l, cums_l, tot_l = ppm.read_len(tables, is_match, len_ctx)
    sym_l, cl_raw, fl_raw = tb.find_symbol(
        rows_l, cums_l, rans.dec_target(rans.dec_slot(x), tot_l.clamp_min(1))
    )
    cc, fc = rans.norm_cf(cl_raw, fl_raw.clamp_min(1), tot_l.clamp_min(1))
    x, step_off = advance(x, step_off, *rans.select_cf(is_match, cc, fc))

    if x_mode:
        # D, E: the distance's mantissa; a lane that codes no match reads
        # nothing, whatever its (masked) bucket says
        repeat = is_match & (sym_dst == SYM_DST_REPEAT)
        k_dist = torch.where(repeat, 0, sym_dst).clamp(0, 24)
        has_extra = is_match & ~repeat
        adaptive, mctx, b_hi, b_lo, b_e = _mant_split(k_dist, has_extra)
        rows_m, cums_m, tot_m = _mant_read(tables, mctx)
        slot_d = rans.dec_slot(x)
        sym_m, cm_raw, fm_raw = tb.find_symbol(
            rows_m, cums_m, rans.dec_target(slot_d, tot_m.clamp_min(1))
        )
        cm, fm = rans.norm_cf(cm_raw, fm_raw.clamp_min(1), tot_m.clamp_min(1))
        one = torch.ones_like(k_dist)
        fd = one << (15 - b_hi)
        act_d = has_extra & (adaptive | (b_hi > 0))
        e_hi = torch.where(has_extra & (b_hi > 0),
                           torch.div(slot_d, fd, rounding_mode="floor"), 0)
        x, step_off = advance(x, step_off, *rans.select_cf(
            act_d, torch.where(adaptive, cm, e_hi * fd),
            torch.where(adaptive, fm, fd)))
        act_e = has_extra & (b_e > 0)
        fe = one << (15 - b_e)
        e_lo = torch.where(
            act_e, torch.div(rans.dec_slot(x), fe, rounding_mode="floor"), 0)
        x, step_off = advance(x, step_off,
                              *rans.select_cf(act_e, e_lo * fe, fe))
        sym_m = torch.where(adaptive, sym_m.to(_i64), 0)
        mant = torch.where(adaptive,
                           (sym_m << (k_dist - 4).clamp_min(0)) + e_lo,
                           (e_hi << b_lo) + e_lo)
        dist = torch.where(repeat, c["prev_dist"], (one << k_dist) + mant)
        src = pos - dist
    elif p_mode:
        src = lzp_src
    else:
        src = _rolz_src_of_rows(rolz_rows, sym_idx).to(_i64)
    out_flat = out.view(-1)
    gsrc = torch.where(is_match, src, c["copy_src"]).clamp(
        0, out_flat.shape[0] - 1
    )
    copied = out_flat[gsrc].to(_i64)
    byte = torch.where(is_lit, sym_a.to(_i64), 0)
    byte = torch.where(is_hit, pred.to(_i64), byte)
    byte = torch.where(is_esc, sym1.to(_i64), byte)
    byte = torch.where(is_match | copying, copied, byte).clamp(0, 255)
    f_byte = torch.where(is_lit, fa_raw, 0)
    sym_len = torch.where(is_match, sym_l, 0)

    ppm.apply_updates(
        tables, coding, ctx2, sym_a, byte, f_byte, p1, h3, pred, conf,
        sym_len, sym_idx, o2_hd, len_ctx, idx_ctx, raw,
        sym_dst=sym_dst if x_mode else None,
    )
    if x_mode:
        _mant_update(tables, mctx, sym_m, adaptive)
    if sse_hitx is not None:
        ppm.sse_update_hit(tables, sse_hitx[0], sse_st, coding, is_hit)
    elif sse_st is not None:
        ppm.sse_update(tables, sse_st, coding, is_match, is_hit)
    _post_step(c, t, p, pos, active, byte, is_match, src, sym_len, rolz,
               dist=dist if x_mode else None, lzp=lzp, n=n)
    out[:, t] = torch.where(active, byte, 0).to(torch.uint8)
    return x, base + step_off


def decode_scan_plain(p: BlockParams, states, stream, n: int, tables,
                      rolz=None, lzp=None):
    """Plain K1 / K12d / K13d: ``(states, words_used, out [S, T] uint8)``;
    ``tables`` and the mode's match tables (mode R: ``rolz``; mode P with
    the match layer: ``lzp``; mode X: none) evolve IN PLACE
    (block.py::_decode_scan/_decode_body)."""
    c = _init_carry(p, states.device)
    out = torch.zeros((p.lanes, p.steps), dtype=torch.uint8,
                      device=states.device)
    x, base = states.to(_i64), 0
    for t in range(p.steps):
        x, base = _decode_step(p, stream, n, c, tables, rolz, x, base, out, t,
                               lzp)
    return x, base, out


# --------------------------------------------------------------------------
# Kernel wrappers: plain version for a CPU tensor, the CUDA kernel for a
# CUDA tensor, an error for anything else.
# --------------------------------------------------------------------------

# Launches per kernel; each wrapper adds one where it launches its kernel,
# and records a pair of CUDA events around the launch (device time).
LAUNCHES = {"KS": 0, "K4": 0, "K5": 0, "K6": 0, "K2": 0, "K3": 0, "K1": 0,
            "K7": 0, "K8": 0, "K9": 0, "K10": 0,
            "K4x": 0, "K11": 0, "K12e": 0, "K12d": 0,
            "KSx": 0, "K13e": 0, "K13d": 0, "SORT": 0}
_EVENTS: dict = {k: [] for k in LAUNCHES}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        _EVENTS[k].clear()


def kernel_ms() -> dict:
    """Device milliseconds per kernel since the last reset (synchronises)."""
    torch.cuda.synchronize()
    return {k: sum(a.elapsed_time(b) for a, b in ev) for k, ev in _EVENTS.items()}


def _launch(name: str, fn, *args) -> None:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    LAUNCHES[name] += 1
    err = fn(*args)
    end.record()
    _EVENTS[name].append((start, end))
    build.check(err, name)


# ints in csrc/ppm_r.cuh::Cfg, in field order
_CFG_NAMES = (
    "S", "T", "n", "min_len", "window", "o3_bits", "rolz_bits", "rolz_depth",
    "rolz_ctx_bytes", "rolz_dec", "top_k", "probe", "match", "use_sse",
    "inc2", "cap2", "inc1", "cap1", "len_inc", "len_cap", "idx_inc",
    "idx_cap", "stream_len", "n_cands", "r_probe", "sort_ext", "p_lit",
    "p_rm", "p_ri", "diag_tail", "fwd_chain", "p_rep", "dst_inc", "dst_cap",
    "mant_inc", "mant_cap",
)
_CFG_FIELDS = len(_CFG_NAMES)


def _use_sse(p: BlockParams) -> bool:
    """Whether the A event goes through the mode's APM stage."""
    if p.mode == "X":
        return bool(ppm.SSE_X)
    return p.match and bool(ppm.SSE_P if p.mode == "P" else ppm.SSE)


def _cfg_array(p: BlockParams, n: int, stream_len: int = 0, **finder) -> np.ndarray:
    """The kernels' configuration struct.  ``finder`` overrides the encoder
    knobs (mode F has its own candidates, extension, prices and
    diagonal-tail rule, mode X its own finder configuration and prices)."""
    cfg = dict(
        S=p.lanes, T=p.steps, n=n, min_len=p.min_len, window=p.window,
        o3_bits=p.o3_bits, rolz_bits=p.rolz_bits, rolz_depth=p.rolz_depth,
        rolz_ctx_bytes=p.rolz_ctx_bytes, rolz_dec=p.rolz_dec, top_k=p.top_k,
        probe=p.probe, match=int(p.match),
        use_sse=int(_use_sse(p)),
        inc2=ppm.INC2, cap2=ppm.CAP2, inc1=ppm.INC1, cap1=ppm.CAP1,
        len_inc=ppm.LEN_INC, len_cap=ppm.LEN_CAP, idx_inc=ppm.IDX_INC,
        idx_cap=ppm.IDX_CAP, stream_len=stream_len, n_cands=_R_CANDS,
        r_probe=_R_PROBE, sort_ext=sort_ext(p), p_lit=_P_LIT_R, p_rm=_P_RM,
        p_ri=_P_RI, diag_tail=1, fwd_chain=_R_PROBE, p_rep=0,
        dst_inc=ppm.DST_INC, dst_cap=ppm.DST_CAP, mant_inc=ppm.MANT_INC,
        mant_cap=ppm.MANT_CAP,
    )
    cfg.update(finder)
    return np.array([cfg[k] for k in _CFG_NAMES], np.int32)


def _dispatch(*tensors) -> str:
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"tensors on {x.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _expect(x, name, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# The step scans run one thread per lane: one CTA up to 1024 lanes, above
# that a thread-block cluster of up to eight CTAs; K9 and K10 up to eight
# lanes a thread in one CTA (csrc/ppm_r.cuh: CPX_MAX_CLUSTER, CPX_MAX_LPT).
KERNEL_MAX_LANES = 8192


def _check_kernel_geometry(p: BlockParams):
    if p.lanes > KERNEL_MAX_LANES:
        raise NotImplementedError(
            f"the CUDA kernels take up to eight CTAs' threads of lanes, a "
            f"thread a lane (K9, K10: eight lanes a thread in one CTA): "
            f"lanes <= {KERNEL_MAX_LANES} (got {p.lanes})"
        )


def _expect_tables(p: BlockParams, tables):
    _expect(tables["o2"], "o2", _i32, (ppm.O2_NCTX, ppm.O2_W))
    _expect(tables["o1"], "o1", _i32, (ppm.O1_NCTX, ppm.O1_NCTX))
    _expect(tables["o3"], "o3", _i32, (1 << p.o3_bits,))
    _expect(tables["len"], "len", _i32, (ppm.N_SHARED_CTX, ppm.LEN_W))
    _expect(tables["idx"], "idx", _i32, (ppm.N_SHARED_CTX, ppm.IDX_W))
    if p.mode == "P":
        _expect(tables["sse_p"], "sse_p", _i32, (ppm.SSE_PCTX * 33,))
        return
    _expect(tables["sse"], "sse", _i32, (ppm.SSE_NCTX * 33,))
    _expect(tables["sse_h"], "sse_h", _i32, (ppm.SSE_HCTX * 33,))
    if p.mode == "X":
        _expect(tables["dst"], "dst", _i32, (ppm.DST_W,))
        _expect(tables["mant"], "mant", _i32, (16, 16))
        _expect(tables["sse_x"], "sse_x", _i32, (ppm.SSE_XCTX * 33,))


def _stream_ptr():
    return torch.cuda.current_stream().cuda_stream


def _pos_scratch(p: BlockParams, device):
    """Scratch of the bucket-reading kernels (KS, K1) for each lane's copy
    of a bucket row ([S, D+1] positions, then KS's [S, D+1] byte scores),
    used where it does not fit in shared memory
    (csrc/ppm_r.cuh::pos_smem_bytes)."""
    return torch.empty((2, p.lanes, p.rolz_depth + 1), dtype=_i32, device=device)


def _table_ptrs(tables, mode: str = "R"):
    keys = ("o2", "o1", "o3", "len", "idx")
    keys += ("sse_p",) if mode == "P" else ("sse", "sse_h")
    if mode == "X":
        keys += ("dst", "mant", "sse_x")
    return [tables[k].data_ptr() for k in keys]


def _lzp_ptrs(p: BlockParams, lzp):
    """Mode P's three table pointers for a kernel (null with the match
    layer off, which has no tables), after the shape checks."""
    if p.match != (lzp is not None):
        raise ValueError("mode P takes its LZP tables with the match layer, "
                         "and none without")
    if lzp is None:
        return [None, None, None]
    for k, size in zip(LZP_KEYS, (1 << 16, 1 << LZP4_BITS, 1 << LZP8_BITS)):
        _expect(lzp[k], k, _i32, (size,))
    return [lzp[k].data_ptr() for k in LZP_KEYS]


def search_scan(p: BlockParams, inp, n: int, rolz):
    """KS — the ROLZ search scan of the greedy parse; KSx — the search scan
    of mode X (``CPX_X_FINDER=scan``).

    Replaces comprox_tpu/codec/block.py::_search_body (1333-1388) with
    _rolz_best_match (939-1056) under _search_and_parse's scan
    (1630-1635); KSx its X branch (1351-1383) with the X inserts of
    _post_step (623-639).  Kernels: csrc/search.cu (one thread per lane: one
    CTA, or a cluster of CTAs above 1024 lanes; latency bound; see the
    source note).  ``inp`` [S, T] uint8,
    ``rolz`` [2^bits, D, 2] int32 (updated in place) -> [4, T, S] int32.
    Mode X: ``rolz`` is the three tables of :func:`_init_xsearch` (two
    bucket tables, ``xshort`` [2^16]; updated in place) -> [6, T, S] int32
    (length, src, len2, cand, len3, src3).
    """
    x_mode = p.mode == "X"
    tabs = tuple(rolz) if x_mode else (rolz,)
    if len(tabs) != (3 if x_mode else 1):
        raise ValueError("mode X searches two bucket tables and xshort")
    if _dispatch(inp, *tabs) == "cpu":
        return search_scan_plain(p, inp, n, rolz)
    _check_kernel_geometry(p)
    if p.top_k > 8:
        raise NotImplementedError(
            f"the search kernel keeps at most 8 candidates (top_k={p.top_k})"
        )
    _expect(inp, "inp", torch.uint8, (p.lanes, p.steps))
    for tab in tabs[:2]:
        _expect(tab, "rolz", _i32, (1 << p.rolz_bits, p.rolz_depth, 2))
    if x_mode:
        _expect(tabs[2], "xshort", _i32, (1 << 16,))
    if inp.data_ptr() % 8 or any(tab.data_ptr() % 8 for tab in tabs[:2]):
        raise ValueError("inp and rolz must be 8-byte aligned (64-bit loads)")
    out = torch.empty((6 if x_mode else 4, p.steps, p.lanes), dtype=_i32,
                      device=inp.device)
    cfg = _cfg_array(p, n)
    lib = build.lib()
    _launch(*(("KSx", lib.cpx_ksx_launch) if x_mode
              else ("KS", lib.cpx_ks_launch)), cfg.ctypes.data,
            inp.data_ptr(), *(tab.data_ptr() for tab in tabs), out.data_ptr(),
            _pos_scratch(p, inp.device).data_ptr(), _stream_ptr())
    return out


# csrc/sortlib.cuh: keys a CTA and radix pass (RS_TILE), the scratch's
# header (RS_HDR) and passes (RS_PASSES), and where it counts the passes run
K4_TILE = 4096
RS_HDR, RS_PASSES, RS_RUNS = 1040, 4, 1032


def radix_passes_plain(keys) -> int:
    """Passes the shared radix sort runs on these keys: one per 8-bit digit
    that is not the same for every key."""
    return sum(int(((keys >> (8 * q)) & 0xFF).unique().numel() > 1)
               for q in range(RS_PASSES))


def _radix_sort(key, pos, n: int):
    """The shared stable radix sort (csrc/sortlib.cuh) of the keys in
    ``key[0]`` ([2, n] int32 tensors): on return ``key[0]``, ``pos[0]``
    hold the sorted keys and their positions.  Counted under SORT.
    Returns the passes run, a device int32 scalar."""
    scratch = torch.empty(RS_HDR + RS_PASSES * 256 * -(-n // K4_TILE),
                          dtype=_i32, device=key.device)
    _launch("SORT", build.lib().cpx_radix_sort_launch, n, key.data_ptr(),
            pos.data_ptr(), scratch.data_ptr(), _stream_ptr())
    return scratch[RS_RUNS]


def radix_sort(keys):
    """SORT — the stable radix sort shared by K4, K4x and K7, on its own:
    ``keys`` int64 [N] in [0, 2^32) -> ``(hs, ps, passes)``: the keys in
    ascending order, the positions in (key, position) order (int64) and
    the 8-bit passes it ran (constant digits are skipped).

    Replaces the ``jax.lax.sort((h, idx), num_keys=1, is_stable=True)`` of
    comprox_tpu/codec/block.py:854 and fast.py:198.  Kernel:
    csrc/sortlib.cuh; its plain version is ``torch.sort(stable=True)``.
    """
    if keys.dim() != 1 or keys.dtype != _i64 or not 0 < keys.numel() < 1 << 30:
        raise ValueError("keys: expected int64 [N], 0 < N < 2^30")
    if _dispatch(keys) == "cpu":
        return (*torch.sort(keys, stable=True), radix_passes_plain(keys))
    n = keys.numel()
    key = torch.empty((2, n), dtype=_i32, device=keys.device)
    key[0] = torch.where(keys >= 1 << 31, keys - (1 << 32), keys).to(_i32)
    pos = torch.empty_like(key)
    passes = _radix_sort(key, pos, n)
    return key[0].to(_i64) & MASK32, pos[0].to(_i64), int(passes.item())


def _sort_stage(tag: str, cfg, big: int, bytes_pad):
    """The key kernel of a sort finder (``tag``: k4, k4x or k7) and the
    shared radix sort: ``(err, hs, ps, passes)`` — int32 [N] (hs holds the
    uint32 keys' bits) and the passes run (device int32)."""
    dev = bytes_pad.device
    keys = torch.empty((2, big), dtype=_i32, device=dev)
    poss = torch.empty((2, big), dtype=_i32, device=dev)
    err = getattr(build.lib(), f"cpx_{tag}_keys_launch")(
        cfg.ctypes.data, bytes_pad.data_ptr(), keys.data_ptr(), _stream_ptr())
    passes = _radix_sort(keys, poss, big) if not err else None
    return err, keys[0], poss[0], passes


def _check_finder(p: BlockParams, bytes_pad, ext=None):
    if p.capacity >= 1 << 30:
        raise NotImplementedError("the sort finder takes blocks below 1 GiB")
    _expect(bytes_pad, "bytes_pad", torch.uint8, (pad_block_len(p, ext),))
    if bytes_pad.data_ptr() % 8:
        raise ValueError("bytes_pad must be 8-byte aligned (64-bit loads)")


def sort_positions(p: BlockParams, bytes_pad, n: int, keys=sort_keys_plain,
                   tag="k4", cfg=None, ext=None, with_passes=False):
    """First stage of a sort finder on its own (its keys, then the shared
    radix sort), for a comparison with a library sort: ``(hs, ps)`` — the
    keys in ascending order (int64 in [0, 2^32)) and the positions in
    (key, position) order; with ``with_passes`` also the radix passes run.
    K4's by default; K4x and K7 pass their keys, their tag, their
    configuration and (K7) their padding.  The main path goes through
    :func:`sort_candidates` (or codec/fast.py::f2_find), which counts
    its own launch beside the sort's."""
    if _dispatch(bytes_pad) == "cpu":
        hs, ps = torch.sort(keys(p, bytes_pad, n), stable=True)
        return (hs, ps, radix_passes_plain(hs)) if with_passes else (hs, ps)
    _check_finder(p, bytes_pad, ext)
    cfg = _cfg_array(p, n) if cfg is None else cfg  # alive across the call
    err, hs, ps, passes = _sort_stage(tag, cfg, p.capacity, bytes_pad)
    build.check(err, f"cpx_{tag}_keys_launch")
    out = hs.to(_i64) & MASK32, ps.to(_i64)
    return (*out, int(passes.item())) if with_passes else out


def finder_cfg(p: BlockParams, n: int, content: bool = False) -> np.ndarray:
    """The sort finder's configuration struct: mode R's, or mode X's
    (``content``: keys of the position's own bytes, no forward chain, no
    decimation)."""
    if not content:
        return _cfg_array(p, n)
    n_c, chain_b, fwd, dec = _finder_config(p, True)
    return _cfg_array(p, n, n_cands=n_c, r_probe=chain_b, fwd_chain=fwd,
                      rolz_dec=dec)


def sort_candidates(p: BlockParams, inp, n: int, content: bool = False):
    """K4 — the whole-block sort finder of the flexible parse; K4x
    (``content``) — its content-keyed entry for mode X.

    Replaces comprox_tpu/codec/block.py::sort_candidates (809-936) in the
    configuration _search_and_parse calls it with for mode R (1586-1590)
    or for mode X (1616-1618: ``ctx_bytes=0``, ``n_cands=3``,
    ``probe_from=16``).  Kernels: csrc/sortfind.cu (key build, a radix sort
    of (key, position), neighbour probe + select + extend, diagonal runs +
    cap; an entry per mode).  ``inp`` [S, T] uint8 -> [2 * n_cands, T, S]
    int32 (len, src per proposal).
    """
    if _dispatch(inp) == "cpu":
        return sort_candidates_plain(p, inp, n, content)
    _expect(inp, "inp", torch.uint8, (p.lanes, p.steps))
    bytes_pad = pad_block(p, inp)
    _check_finder(p, bytes_pad)
    big, dev = p.capacity, inp.device
    n_c = _finder_config(p, content)[0]
    cand = torch.empty((n_c, big), dtype=_i32, device=dev)
    lw = torch.empty((n_c, big), dtype=_i32, device=dev)
    out = torch.empty((2 * n_c, p.steps, p.lanes), dtype=_i32, device=dev)
    cfg = finder_cfg(p, n, content)
    name = "K4x" if content else "K4"
    tag = name.lower()

    def stages():
        err, hs, ps, _ = _sort_stage(tag, cfg, big, bytes_pad)
        return err or getattr(build.lib(), f"cpx_{tag}_find_launch")(
            cfg.ctypes.data, bytes_pad.data_ptr(), hs.data_ptr(),
            ps.data_ptr(), cand.data_ptr(), lw.data_ptr(), out.data_ptr(),
            _stream_ptr())

    _launch(name, stages)
    return out


def rep_scan(p: BlockParams, inp, n: int, dec):
    """K11 — the repeat-distance pass of mode X's flexible parse.

    Replaces comprox_tpu/codec/block.py::_sim_prev_dist (1507-1526) and
    _rep_lengths (1529-1559).  Kernel: csrc/xrep.cu (one thread per lane:
    a forward walk, then a backward walk).  ``inp`` [S, T] uint8, ``dec``
    [>= 2, T, S] int32 (take, src of the first parse) -> [2, T, S] int32
    (len_rep, prev).
    """
    if _dispatch(inp, dec) == "cpu":
        return rep_scan_plain(p, inp, n, dec)
    _expect(inp, "inp", torch.uint8, (p.lanes, p.steps))
    _expect(dec, "dec", _i32, (dec.shape[0], p.steps, p.lanes))
    if dec.shape[0] < 2:
        raise ValueError("dec: expected the (take, src) grids")
    out = torch.empty((2, p.steps, p.lanes), dtype=_i32, device=inp.device)
    cfg = _cfg_array(p, n)
    _launch("K11", build.lib().cpx_k11_launch, cfg.ctypes.data,
            inp.data_ptr(), dec.data_ptr(), out.data_ptr(), _stream_ptr())
    return out


def rank_scan(p: BlockParams, inp, n: int, props, rolz):
    """K5 — the rank scan of the flexible parse.

    Replaces comprox_tpu/codec/block.py::_rolz_rank_body (1188-1252) under
    _rolz_rank_scan (1265-1283).  Kernel: csrc/rank.cu (one thread per
    lane, as KS).  ``props`` [2 * n_c, T, S] int32 from K4;
    ``rolz`` [2^bits, D, 2] int32 (updated in place) ->
    [3 * (n_c + 1) + 1, T, S] int32.
    """
    if _dispatch(inp, props, rolz) == "cpu":
        return rank_scan_plain(p, inp, n, props, rolz)
    _check_kernel_geometry(p)
    _expect(inp, "inp", torch.uint8, (p.lanes, p.steps))
    _expect(props, "props", _i32, (2 * _R_CANDS, p.steps, p.lanes))
    _expect(rolz, "rolz", _i32, (1 << p.rolz_bits, p.rolz_depth, 2))
    if inp.data_ptr() % 8 or rolz.data_ptr() % 8:
        raise ValueError("inp and rolz must be 8-byte aligned (64-bit loads)")
    out = torch.empty((3 * (_R_CANDS + 1) + 1, p.steps, p.lanes), dtype=_i32,
                      device=inp.device)
    cfg = _cfg_array(p, n)
    _launch("K5", build.lib().cpx_k5_launch, cfg.ctypes.data,
            inp.data_ptr(), props.data_ptr(), rolz.data_ptr(), out.data_ptr(),
            _stream_ptr())
    return out


def parse_scan(p: BlockParams, n: int, cands, prices=None, n_c=None, rep=None):
    """K6 — the backward price DP of the flexible parse.

    Replaces comprox_tpu/codec/block.py::_parse_body (1414-1477) with
    _cand_min_cost (1391-1411) under the reversed scan of
    _search_and_parse (1596-1600, mode R) or of codec/fast.py::
    _fast_find_matches (265-276, mode F: the non-R branch 1435-1450 with
    the fast profile's prices).  Kernel: csrc/parse.cu (one warp per lane,
    all SMs; one source, an entry per mode).  Mode R: ``cands``
    [3 * (n_c + 1) + 1, T, S] int32 from K5 (or KS's [4, T, S]: its one
    candidate and the fill, ``CPX_R_FINDER=scan``) -> dec [4, T, S] int32
    (take, src, recency index, fill).  Mode F (``prices`` and ``n_c`` given):
    ``cands`` [2 * n_c, T, S] int32 from K7 -> dec [3, T, S] (take, src, 0).
    Mode X (the non-R branch with X's four prices; its second run with the
    repeat pair, 1436-1455): ``cands`` from K4x and ``rep`` [2, T, S] int32
    (len_rep, prev) from K11, or None -> dec [3, T, S].
    """
    if rep is not None and len(prices) < 4:
        raise ValueError("the repeat pair needs the repeat price")
    if _dispatch(cands, *([] if rep is None else [rep])) == "cpu":
        return parse_scan_plain(p, n, cands, prices, n_c, rep)
    if prices is None:
        n_r = (cands.shape[0] - 1) // 3  # candidates, the bucket's included
        if not 1 <= n_r <= MAX_CANDS + 1:
            raise ValueError("cands: expected 3 grids a candidate and the fill")
        _expect(cands, "cands", _i32, (3 * n_r + 1, p.steps, p.lanes))
        dec = torch.empty((4, p.steps, p.lanes), dtype=_i32, device=cands.device)
        cfg = _cfg_array(p, n, n_cands=n_r - 1)
        entry = build.lib().cpx_k6_launch
    else:
        _expect(cands, "cands", _i32, (2 * n_c, p.steps, p.lanes))
        dec = torch.empty((3, p.steps, p.lanes), dtype=_i32, device=cands.device)
        cfg = _cfg_array(p, n, n_cands=n_c, p_lit=prices[0], p_rm=prices[1],
                         p_ri=prices[2],
                         p_rep=prices[3] if len(prices) > 3 else 0)
        entry = build.lib().cpx_k6f_launch
    if rep is not None:
        _expect(rep, "rep", _i32, (2, p.steps, p.lanes))
        _launch("K6", build.lib().cpx_k6x_launch, cfg.ctypes.data,
                cands.data_ptr(), rep.data_ptr(), dec.data_ptr(),
                _stream_ptr())
        return dec
    _launch("K6", entry, cfg.ctypes.data, cands.data_ptr(), dec.data_ptr(),
            _stream_ptr())
    return dec


def model_scan(p: BlockParams, inp, n: int, dec, tables, lzp=None):
    """K2 — the forward modeling scan of encode; K12e — its mode-X entry;
    K13e — its mode-P entry.

    Replaces comprox_tpu/codec/block.py::_encode_model_body (1677-1895)
    under _encode_passes (1898-1941); K13e its P arm (1714-1723) with
    _lzp_candidate (362-403), _match_window_len (1059-1068) and the LZP
    inserts of _post_step (662-676).  Kernel: csrc/model.cu (an entry per
    mode).  Mode R: ``dec`` [4, T, S] int32 (take, src, rec_idx, fill) ->
    ev [T, 9, S] int32.  Mode X: ``dec`` [2, T, S] int32 (take, src) -> ev
    [T, 15, S].  Mode P: no ``dec`` (None); ``lzp`` the three tables of
    :func:`_init_lzp`, or None with the match layer off -> ev [T, 9, S].
    ``tables`` and ``lzp`` evolve in place.
    """
    p_mode = p.mode == "P"
    if p_mode != (dec is None):
        raise ValueError("mode P has no parse decisions; modes R and X do")
    group = [inp, tables["o2"]] + ([] if p_mode else [dec]) + (
        [] if lzp is None else [lzp[k] for k in LZP_KEYS])
    if _dispatch(*group) == "cpu":
        return model_scan_plain(p, inp, n, dec, tables, lzp)
    _check_kernel_geometry(p)
    _expect(inp, "inp", torch.uint8, (p.lanes, p.steps))
    _expect_tables(p, tables)
    ev = torch.empty((p.steps, 3 * p.n_slots, p.lanes), dtype=_i32,
                     device=inp.device)
    cfg = _cfg_array(p, n)
    lib = build.lib()
    if p_mode:
        if inp.data_ptr() % 8:
            raise ValueError("inp must be 8-byte aligned (64-bit loads)")
        _launch("K13e", lib.cpx_k13e_launch, cfg.ctypes.data, inp.data_ptr(),
                *_table_ptrs(tables, "P"), *_lzp_ptrs(p, lzp), ev.data_ptr(),
                _stream_ptr())
        return ev
    x_mode = p.mode == "X"
    _expect(dec, "dec", _i32, (2 if x_mode else 4, p.steps, p.lanes))
    _launch(*(("K12e", lib.cpx_k12e_launch) if x_mode
              else ("K2", lib.cpx_k2_launch)), cfg.ctypes.data,
            inp.data_ptr(), dec.data_ptr(), *_table_ptrs(tables, p.mode),
            ev.data_ptr(), _stream_ptr())
    return ev


def rans_scan(p: BlockParams, ev):
    """K3 — the backward rANS scan of encode.

    Replaces the rans_body scan of comprox_tpu/codec/block.py::
    _encode_passes (1945-1969).  Kernel: csrc/rans.cu (one thread per
    lane).  ev [T, 3 * n_slots, S] int32 (n_slots = 3, or 5 in mode X) ->
    (states [S] int64, emit [T, n_slots, S] bool, words [T, n_slots, S]
    int32).
    """
    if _dispatch(ev) == "cpu":
        return rans_scan_plain(p, ev)
    n_slots = p.n_slots
    _expect(ev, "ev", _i32, (p.steps, 3 * n_slots, p.lanes))
    dev = ev.device
    states = torch.empty(p.lanes, dtype=_i64, device=dev)
    emit = torch.empty((p.steps, n_slots, p.lanes), dtype=torch.uint8,
                       device=dev)
    words = torch.empty((p.steps, n_slots, p.lanes), dtype=_i32, device=dev)
    _launch("K3", build.lib().cpx_k3_launch, p.lanes, p.steps, n_slots,
            ev.data_ptr(), states.data_ptr(), emit.data_ptr(),
            words.data_ptr(), _stream_ptr())
    return states, emit.bool(), words


def decode_scan(p: BlockParams, states, stream, n: int, tables, rolz=None,
                lzp=None):
    """K1 — the fused decode scan of mode R; K12d — its mode-X entry; K13d —
    its mode-P entry.

    Replaces comprox_tpu/codec/block.py::_decode_scan (2218-2248) and
    _decode_body (1980-2215; K13d its P arms 2016-2021 and 2164-2167 with
    _lzp_candidate and the LZP inserts).  Kernel: csrc/decode.cu (an entry
    per mode).  ``states`` [S] int64, ``stream`` [pad] int32 (u16 words);
    ``tables`` and the mode's match tables evolve in place: mode R takes
    its bucket table ``rolz``, mode P (with the match layer) the three
    tables ``lzp`` of :func:`_init_lzp`, mode X none -> (states,
    words_used, out [S, T] uint8).
    """
    x_mode, p_mode = p.mode == "X", p.mode == "P"
    if (p.mode == "R") != (rolz is not None):
        raise ValueError("mode R decodes with a bucket table, modes X and P "
                         "without")
    if lzp is not None and not p_mode:
        raise ValueError("only mode P decodes with LZP tables")
    if _dispatch(states, stream, tables["o2"],
                 *([] if rolz is None else [rolz]),
                 *([] if lzp is None else [lzp[k] for k in LZP_KEYS])) == "cpu":
        return decode_scan_plain(p, states, stream, n, tables, rolz, lzp)
    _check_kernel_geometry(p)
    _expect(states, "states", _i64, (p.lanes,))
    if stream.dtype != _i32 or stream.dim() != 1 or stream.shape[0] < p.lanes:
        raise ValueError("stream: expected a 1-D int32 tensor of >= S words")
    _expect(stream, "stream", _i32, stream.shape)
    _expect_tables(p, tables)
    dev = states.device
    x = states.clone()
    out = torch.zeros((p.lanes, p.steps), dtype=torch.uint8, device=dev)
    used = torch.zeros(1, dtype=_i64, device=dev)
    cfg = _cfg_array(p, n, stream.shape[0])
    if x_mode:
        _launch("K12d", build.lib().cpx_k12d_launch, cfg.ctypes.data,
                stream.data_ptr(), x.data_ptr(), *_table_ptrs(tables, "X"),
                out.data_ptr(), used.data_ptr(), _stream_ptr())
        return x, int(used.item()), out
    if p_mode:
        _launch("K13d", build.lib().cpx_k13d_launch, cfg.ctypes.data,
                stream.data_ptr(), x.data_ptr(), *_table_ptrs(tables, "P"),
                *_lzp_ptrs(p, lzp), out.data_ptr(), used.data_ptr(),
                _stream_ptr())
        return x, int(used.item()), out
    _expect(rolz, "rolz", _i32, (1 << p.rolz_bits, p.rolz_depth, 2))
    _launch("K1", build.lib().cpx_k1_launch, cfg.ctypes.data,
            stream.data_ptr(), x.data_ptr(), *_table_ptrs(tables),
            rolz.data_ptr(), out.data_ptr(), used.data_ptr(),
            _pos_scratch(p, dev).data_ptr(), _stream_ptr())
    return x, int(used.item()), out


# --------------------------------------------------------------------------
# Host-facing block API
# --------------------------------------------------------------------------


def _pack_payload(states, emit, words) -> bytes:
    emit_np = emit.cpu().numpy().astype(bool)  # [T, n_slots, S]: decode order
    stream = words.cpu().numpy()[emit_np]  # C-order compaction
    header = np.array([stream.size], np.uint32)
    return (
        header.tobytes()
        + states.cpu().numpy().astype("<u4").tobytes()
        + stream.astype("<u2").tobytes()
    )


def _unpack_payload(payload: bytes, p: BlockParams):
    n_words = int(np.frombuffer(payload[:4], "<u4")[0])
    off = 4
    states = np.frombuffer(payload[off : off + 4 * p.lanes], "<u4").copy()
    off += 4 * p.lanes
    stream = np.frombuffer(payload[off : off + 2 * n_words], "<u2").copy()
    pad = (
        p.stream_pad
        if n_words <= p.stream_fallback_words
        else p.stream_pad_max
    )
    stream_padded = np.zeros(pad, np.uint16)
    stream_padded[:n_words] = stream
    return n_words, states, stream_padded


def _check_drain(x, base, n_words):
    drained = bool((np.asarray(x) == RANS_L).all())
    if int(base) != n_words or not drained:
        raise ValueError(
            f"corrupt block: consumed {int(base)}/{n_words} words, "
            f"states drained={drained}"
        )


def encode_passes(p: BlockParams, inp, n: int):
    """The parse (mode R, flexible: K4, K5, K6; greedy: KS and two
    elementwise ops; ``CPX_R_FINDER=scan``, flexible: KS and K6 on its one
    candidate.  Mode X, flexible: K4x, K6, K11, K6; greedy: K4x and the
    elementwise choice; ``CPX_X_FINDER=scan``: KSx in K4x's place.  Mode P:
    none), then the modeling scan and K3, on one [S, T] block tensor.
    Returns ``(states, emit, words, ev, tables)``."""
    dev = inp.device
    lzp = None
    if p.mode == "P":
        dec = None
        lzp = _init_lzp(p, dev) if p.match else None
    elif p.mode == "X":
        dec = torch.zeros((2, p.steps, p.lanes), dtype=_i32, device=dev)
        if p.match:
            if _ENV["CPX_X_FINDER"] == "scan":
                cands = search_scan(p, inp, n, _init_xsearch(p, dev))
            else:
                cands = sort_candidates(p, inp, n, content=True)
            if p.flexible:
                n_c = cands.shape[0] // 2
                first = parse_scan(p, n, cands, x_prices(), n_c)
                rep = rep_scan(p, inp, n, first)
                dec = parse_scan(p, n, cands, x_prices(), n_c, rep)[:2]
            else:
                dec = torch.stack(_greedy_decisions_dist(p, cands))
    elif p.match and p.flexible and _ENV["CPX_R_FINDER"] == "sort":
        props = sort_candidates(p, inp, n)
        cands = rank_scan(p, inp, n, props, _init_rolz(p, dev))
        dec = parse_scan(p, n, cands)
    elif p.match:
        grids = search_scan(p, inp, n, _init_rolz(p, dev))
        if p.flexible:  # the one candidate through the price DP
            take, src = parse_scan(p, n, grids)[0], grids[1]
        else:
            take, src = _greedy_decisions(p, grids[0], grids[1])
        dec = torch.stack([take, src, grids[2], grids[3]]).contiguous()
    else:
        dec = torch.zeros((4, p.steps, p.lanes), dtype=_i32, device=dev)
    tables = ppm.init_tables(p.match, p.o3_bits, dev)
    ev = model_scan(p, inp, n, dec, tables, lzp)
    states, emit, words = rans_scan(p, ev)
    return states, emit, words, ev, tables


def encode_block(data: np.ndarray, p: BlockParams, device) -> bytes:
    """Encode up to p.capacity bytes on ``device``; returns the payload."""
    check_supported(p)
    n = int(data.size)
    if not 0 < n <= p.capacity:
        raise ValueError(f"block of {n} bytes for capacity {p.capacity}")
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    buf.reshape(-1)[:n] = data
    inp = torch.from_numpy(buf).to(device)
    states, emit, words, _, _ = encode_passes(p, inp, n)
    return _pack_payload(states, emit, words)


def decode_block(payload: bytes, n: int, p: BlockParams, device) -> np.ndarray:
    """Decode a block payload back to its n raw bytes on ``device``."""
    check_supported(p)
    n_words, states, stream_padded = _unpack_payload(payload, p)
    x, used, out = decode_scan(
        p,
        torch.from_numpy(states.astype(np.int64)).to(device),
        torch.from_numpy(stream_padded.astype(np.int32)).to(device),
        n,
        ppm.init_tables(p.match, p.o3_bits, device),
        _init_rolz(p, device) if p.mode == "R" else None,
        _init_lzp(p, device) if p.mode == "P" and p.match else None,
    )
    _check_drain(x.cpu().numpy(), used, n_words)
    return out.cpu().numpy().reshape(-1)[:n]
