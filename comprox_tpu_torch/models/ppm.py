"""Batched PPM compound model (o1 + o2 + o3 predictor) on torch tensors.

Counterpart of :mod:`comprox_tpu.models.ppm`, the subset of modes R, X and
P at the default knobs: the o2/o1/o3 tables, the shared len/idx models and
mode X's distance-bucket model, mode R's match and hit APMs (SSE), the
hit-only APMs of modes X and P and the default branch of
``apply_updates``.  The
symbol space, constants and arithmetic are the JAX package's; the stream
format therefore is too, and ``format_fingerprint`` gives the same value.

Tables are a plain dict of tensors that the functions here update IN
PLACE (the JAX versions return a new dict).  Shapes follow the JAX
package except ``o3``, which is kept flat ``[2^o3_bits]``
(``tables_from_numpy``/``tables_to_numpy`` convert).

The same ``CPX_*`` environment variables are read at import.  Knobs that
select code paths the port does not implement are checked by
:func:`check_knobs`, which every entry point calls: a non-default value
raises instead of silently writing other bytes than the JAX package.
"""

from __future__ import annotations

import os as _os
import zlib

import numpy as np
import torch

from comprox_tpu_torch.models import tables as tb

_i32 = torch.int32

# --- symbol space -----------------------------------------------------------
O2_W = 260
SYM_HIT = 256
SYM_ESC = 257
SYM_MATCH = 258
SYM_HIT2 = 259


def _env(name, default):
    return int(_os.environ.get("CPX_" + name, default))


INC2 = _env("INC2", 16)
CAP2 = _env("CAP2", 24576)
INC1 = _env("INC1", 1)
CAP1 = _env("CAP1", 3500)
LEN_INC = _env("LEN_INC", 16)
LEN_CAP = 24576
IDX_INC = _env("IDX_INC", 16)
IDX_CAP = 24576
DST_INC = _env("DST_INC", 16)
DST_CAP = 24576
DST_W = 32
MANT_INC = _env("MANT_INC", 24)
MANT_CAP = _env("MANT_CAP", 8192)
N_SHARED_CTX = 4
IDX_W = 80
O2_NCTX = 1 << 16
O1_NCTX = 256
O3_SIZE = 1 << 22
LEN_W = 256
CONF_BOOST = _env("CONF_BOOST", 0)
FORMAT_REV = 8
O2_MAXCAP = _env("O2_MAXCAP", 0)
O2_EE = _env("O2_EE", 0)
O3_GROUPS = _env("O3_GROUPS", 1)
O3_GROUPUPD = _env("O3_GROUPUPD", 0)
O3_2WAY = _env("O3_2WAY", 0)
SSE = _env("SSE", 1)
SSE_MCTX = _env("SSE_MCTX", 1)
SSE_HIT = _env("SSE_HIT", 1)
SSE_NCTX = 20 if SSE_MCTX else 5
SSE_HCTX = 6
SSE_X = _env("SSE_X", 1)
SSE_XCTX = 48
SSE_P = _env("SSE_P", 1)
SSE_PCTX = 24
SSE_RATE_SH = 5
SSE_LO, SSE_HI = 16, 65520
_SSE_THR = (
    22, 36, 60, 98, 162, 267, 439, 720, 1179, 1921, 3108, 4971, 7812,
    11955, 17625, 24743, 32768, 40793, 47911, 53581, 57724, 60565,
    62428, 63615, 64357, 64816, 65097, 65269, 65374, 65438, 65476,
    65500, 65514,
)
_SSE_SPAN = tuple(b - a for a, b in zip(_SSE_THR, _SSE_THR[1:]))

# knobs whose non-default values select code the port does not have
_UNPORTED_KNOBS = {
    "O3_2WAY": 0, "O3_GROUPS": 1, "O3_GROUPUPD": 0, "O2_MAXCAP": 0,
    "O2_EE": 0, "CONF_BOOST": 0, "SSE": 1, "SSE_MCTX": 1, "SSE_HIT": 1,
}


def check_knobs() -> None:
    """Raise for a model knob whose non-default value is not ported."""
    g = globals()
    for name, default in _UNPORTED_KNOBS.items():
        if g[name] != default:
            raise NotImplementedError(
                f"CPX_{name}={g[name]} is not ported to comprox_tpu_torch "
                f"(only the default {default}); see ROADMAP.md item 17"
            )


def format_fingerprint() -> int:
    """CRC32 of every format-relevant model constant (same tuple, same
    order as the JAX package: the container header carries it)."""
    knobs = (
        INC2, CAP2, INC1, CAP1, LEN_INC, LEN_CAP, IDX_INC, IDX_CAP,
        DST_INC, DST_CAP, DST_W, MANT_INC, MANT_CAP, N_SHARED_CTX,
        IDX_W, LEN_W, O2_W, CONF_BOOST, FORMAT_REV,
        O2_MAXCAP, O2_EE, O3_GROUPS, O3_GROUPUPD, O3_2WAY,
        SSE, SSE_NCTX, SSE_RATE_SH, SSE_MCTX, SSE_HIT, SSE_HCTX,
        SSE_X, SSE_XCTX, SSE_P, SSE_PCTX,
    )
    return zlib.crc32(repr(knobs).encode()) & 0xFFFFFFFF


def _sticky2(device):
    m = torch.zeros(O2_W, dtype=torch.bool, device=device)
    m[[SYM_HIT, SYM_ESC, SYM_MATCH, SYM_HIT2]] = True
    return m


def _apm_init(n_ctx: int, device):
    row = torch.tensor(_SSE_THR, dtype=_i32).clamp(SSE_LO, SSE_HI)
    if torch.device(device).type == "cuda":
        # from pinned memory: a pageable upload would wait for every kernel
        # queued before it (a block in flight)
        row = row.pin_memory().to(device, non_blocking=True)
    return row.to(device).repeat(n_ctx)


def init_sse(device):
    return _apm_init(SSE_NCTX, device)


def init_sse_hit(device):
    return _apm_init(SSE_HCTX, device)


def init_tables(match_enabled: bool, o3_bits: int, device) -> dict:
    """Fresh model state for one block."""
    check_knobs()
    # built by comparisons: writing a Python number into a CUDA tensor
    # (o2_row[k] = INC2) copies it from pageable memory and waits for every
    # kernel queued before it (a block in flight)
    slot = torch.arange(O2_W, device=device)
    seeded = (slot == SYM_HIT) | (slot == SYM_ESC)
    if match_enabled:
        seeded |= slot == SYM_MATCH
    o2_row = torch.where(seeded, INC2, 0).to(_i32)

    def ones(*shape):
        return torch.ones(shape, dtype=_i32, device=device)

    return {
        "o2": o2_row.repeat(O2_NCTX, 1),
        "o1": ones(O1_NCTX, O1_NCTX),
        "o3": torch.zeros(1 << o3_bits, dtype=_i32, device=device),
        "len": ones(N_SHARED_CTX, LEN_W),
        "idx": ones(N_SHARED_CTX, IDX_W),
        "dst": ones(DST_W),
        "mant": ones(16, 16),
        "sse": init_sse(device),
        "sse_h": init_sse_hit(device),
        "sse_x": _apm_init(SSE_XCTX, device),
        "sse_p": _apm_init(SSE_PCTX, device),
    }


def tables_from_numpy(d: dict, device) -> dict:
    """The JAX package's table dict (as numpy arrays) -> the port's dict
    (copies: the port updates its tables in place)."""
    out = {}
    for k, v in d.items():
        v = torch.from_numpy(np.array(v, dtype=np.int32))
        out[k] = (v.reshape(-1) if k == "o3" else v).to(device)
    return out


def tables_to_numpy(t: dict) -> dict:
    """The port's dict -> the JAX package's layout, as numpy arrays."""
    out = {}
    for k, v in t.items():
        v = v.cpu().numpy()
        out[k] = v.reshape(-1, 128) if k == "o3" else v
    return out


def o3_hash(ctx3, o3_size: int):
    """Order-3 context hash."""
    return (ctx3 ^ (ctx3 >> 2)) & (o3_size - 1)


def o3_read(t, h3):
    """``(pred, conf, pred2, conf2, raw)`` for each lane's o3 entry."""
    raw = t["o3"][h3.long()]
    pred = raw & 0xFF
    conf = ((raw >> 8) & 0xF).clamp(0, 15)
    pred2 = (raw >> 12) & 0xFF
    conf2 = ((raw >> 20) & 0xF).clamp(0, 15)
    return pred, conf, pred2, conf2, raw


def _o2_rescale(rows0):
    return tb.rescale_read(rows0, CAP2, _sticky2(rows0.device))


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def read_o2(t, ctx2, pred, coding, conf=None, sse_fill=None, sse_hitx=None):
    """The A event's distribution: gather, rescale, exclude the predicted
    byte, then mode R's SSE reshape where ``sse_fill`` is given, or the
    hit-only reshape where ``sse_hitx`` = (table key, contexts) is (modes X
    and P; the state then feeds :func:`sse_update_hit`).

    Returns ``(rows, rowmod, cums, tot, halve_delta, sse_state)``;
    ``halve_delta`` holds the rescale as row deltas on the winner lanes,
    for :func:`apply_updates`.  Does not modify ``t``.
    """
    rows0 = t["o2"][ctx2.long()]
    rows, did = _o2_rescale(rows0)
    winners = tb.elect_winners(ctx2, did & coding)
    halve_delta = torch.where(winners[:, None], rows - rows0, 0)
    rows = rows.clone()
    rows[:, SYM_ESC] = rows[:, SYM_ESC].clamp_min(1)
    slot_ids = torch.arange(O2_W, device=rows.device)
    rowmod = torch.where(slot_ids == pred[:, None], 0, rows)
    sse_state = None
    if sse_fill is not None:
        rowmod, sse_state = _sse_reshape(t, rowmod, sse_fill, conf)
    elif sse_hitx is not None:
        key, hctx = sse_hitx
        rowmod, sse_state = _hit_reshape(t[key], hctx, rowmod, conf)
    cums = tb.exclusive_cumsum(rowmod)
    return rows, rowmod, cums, tb.row_total(rowmod), halve_delta, sse_state


def read_o1_excl(t, p1, o2_rows, pred, pred2, valid2):
    """Order-1 weighted distribution (8f-7) excluding the predicted byte
    and every byte present in the o2 row.  Halves every o1 row whose sum
    is over the cap, IN PLACE, before the read.  Returns
    ``(rows, wmod, cums, tot)``."""
    o1 = t["o1"]
    need = o1.sum(dim=1, dtype=_i32) > CAP1
    o1.copy_(torch.where(need[:, None], (o1 + 1) >> 1, o1))
    rows = o1[p1.long()]
    w = rows * 8 - 7
    slot_ids = torch.arange(O1_NCTX, device=rows.device)
    excluded = (
        (o2_rows[:, :256] > 0)
        | (slot_ids == pred[:, None])
        | ((slot_ids == pred2[:, None]) & valid2[:, None])
    )
    wmod = torch.where(excluded, 0, w)
    return rows, wmod, tb.exclusive_cumsum(wmod), tb.row_total(wmod)


def read_len(t, match_mask, ctx):
    return _read_shared_ctx(t, match_mask, "len", LEN_CAP, ctx)


def read_idx(t, match_mask, ctx):
    return _read_shared_ctx(t, match_mask, "idx", IDX_CAP, ctx)


def read_dst(t, match_mask):
    """Mode X's distance-bucket model (one shared row of DST_W counts),
    halved IN PLACE when a match lane reads it over its cap.  Returns
    ``(rows, cums, tots)`` per lane."""
    tab = t["dst"]
    hot = bool(match_mask.any())
    for _ in range(tb.HALVE_ROUNDS):
        if hot and int(tab.sum()) > DST_CAP:
            tab.copy_((tab + 1) >> 1)
    s = match_mask.shape[0]
    cums = tb.exclusive_cumsum(tab[None, :])
    return (tab[None, :].expand(s, -1), cums.expand(s, -1),
            tab.sum(dtype=_i32).expand(s))


def _read_shared_ctx(t, mask, key, cap, ctx):
    """Dense shared model with a tiny context: a row is halved (IN PLACE)
    when a participating lane reads it over its cap.  Returns
    ``(rows, cums, tots)`` per lane."""
    tab = t[key]
    n_ctx = tab.shape[0]
    ctx = ctx.clamp(0, n_ctx - 1).long()
    hot = torch.zeros(n_ctx, dtype=torch.bool, device=tab.device)
    hot[ctx[mask]] = True
    for _ in range(tb.HALVE_ROUNDS):
        need = hot & (tab.sum(dim=1, dtype=_i32) > cap)
        tab.copy_(torch.where(need[:, None], (tab + 1) >> 1, tab))
    cums_tab = tb.exclusive_cumsum(tab)
    return tab[ctx], cums_tab[ctx], tab.sum(dim=1, dtype=_i32)[ctx]


# --------------------------------------------------------------------------
# SSE / APM on the A event (match mass keyed on bucket fill x o3 conf,
# hit mass keyed on conf class x match availability).  Dense tables,
# identical integer arithmetic on both sides.
# --------------------------------------------------------------------------


def sse_ctx_of(fill, conf):
    fillc = torch.where(fill > 0, 1 + _floordiv(fill - 1, 16).clamp(0, 3), 0)
    return (fillc * 4 + conf.clamp(0, 3)).to(_i32)


def sse_hit_ctx_of(conf, fill):
    return ((conf.clamp(1, 3) - 1) * 2 + (fill > 0).to(_i32)).to(_i32)


def sse_x_ctx_of(conf, p1):
    """Mode X's hit APM context: conf class x order-1 byte class."""
    return ((conf.clamp(1, 3) - 1) * 16 + _floordiv(p1.clamp(0, 255), 16)).to(_i32)


def sse_p_ctx_of(conf, avail, p1):
    """Mode P's hit APM context: conf class x LZP candidate availability x
    order-1 byte class."""
    return (((conf.clamp(1, 3) - 1) * 2 + avail.to(_i32)) * 4
            + _floordiv(p1.clamp(0, 255), 64)).to(_i32)


def _apm_read(sse_flat, ctx, p16):
    """Stretch-quantise p16 to (bin i, weight w) and interpolate the two
    table points: ``(p_sse16, flat, w, t_i, t_ip1)``."""
    dev = p16.device
    thr = torch.tensor(_SSE_THR, dtype=_i32, device=dev)
    span = torch.tensor(_SSE_SPAN, dtype=_i32, device=dev)
    i = (p16[:, None] >= thr[None, 1:32]).sum(dim=1, dtype=_i32)
    thr_i = thr[i.long()]
    span_i = span[i.long()].clamp_min(1)
    w = _floordiv((p16 - thr_i) * 64, span_i).clamp(0, 64)
    flat = ctx * 33 + i
    k = sse_flat.shape[0]

    def at(j):
        ok = (j >= 0) & (j < k)
        return torch.where(ok, sse_flat[torch.where(ok, j, 0).long()], 0)

    t_i, t_ip1 = at(flat), at(flat + 1)
    p_sse = ((64 - w) * t_i + w * t_ip1) >> 6
    return p_sse, flat, w, t_i, t_ip1


def _apm_add(tab, flat, w, t_i, t_ip1, outcome, active):
    """Add the APM deltas (computed from the step-start values) of every
    active lane to ``tab`` IN PLACE, then clip the whole table."""
    h = outcome.to(_i32) << 16
    d_i = ((64 - w) * (h - t_i)) >> (6 + SSE_RATE_SH)
    d_ip1 = (w * (h - t_ip1)) >> (6 + SSE_RATE_SH)
    k = tab.shape[0]
    for j, d in ((flat, d_i), (flat + 1, d_ip1)):
        m = active & (j >= 0) & (j < k)
        tab.index_add_(0, j[m].long(), d[m].to(_i32))
    tab.clamp_(SSE_LO, SSE_HI)


def _hit_reshape(sse_flat, hctx, rowmod, conf):
    f_h0 = rowmod[:, SYM_HIT]
    tot_h = tb.row_total(rowmod).clamp_min(1)
    p16h = _floordiv(f_h0 * 4096, tot_h).clamp(1, 4095) << 4
    ph, flat_h, w_h, ti_h, tip1_h = _apm_read(sse_flat, hctx, p16h)
    ph12 = (ph >> 4).clamp(1, 4095)
    f_h_new = _floordiv(ph12 * (tot_h - f_h0), 4096 - ph12)
    hi = f_h0 + (32768 - tot_h).clamp_min(0)
    f_h_new = torch.minimum(f_h_new.clamp_min(1), hi)
    act_h = conf > 0
    rowmod = rowmod.clone()
    rowmod[:, SYM_HIT] = torch.where(act_h, f_h_new, f_h0)
    return rowmod, (flat_h, w_h, ti_h, tip1_h, act_h)


def _sse_reshape(t, rowmod, fill, conf):
    """Reshape the HIT slot (hit APM) and then the MATCH slot (match APM)
    of ``rowmod``; the state feeds :func:`sse_update`."""
    rowmod, hit_state = _hit_reshape(
        t["sse_h"], sse_hit_ctx_of(conf, fill), rowmod, conf
    )
    f_m = rowmod[:, SYM_MATCH]
    f_h = rowmod[:, SYM_HIT]
    f_h2 = rowmod[:, SYM_HIT2]
    tot0 = tb.row_total(rowmod)
    rest = (tot0 - f_h - f_h2).clamp_min(1)
    p16 = _floordiv(f_m * 4096, rest).clamp(1, 4095) << 4
    p_sse, flat, w, t_i, t_ip1 = _apm_read(
        t["sse"], sse_ctx_of(fill, conf), p16
    )
    ps12 = (p_sse >> 4).clamp(1, 4095)
    f_new = _floordiv(ps12 * (rest - f_m), 4096 - ps12)
    hi = f_m + (32768 - tot0).clamp_min(0)
    rowmod[:, SYM_MATCH] = torch.minimum(f_new.clamp_min(1), hi)
    return rowmod, (flat, w, t_i, t_ip1, hit_state)


def sse_update(t, state, coding, is_match, is_hit):
    """APM updates toward the observed flags, IN PLACE."""
    flat, w, t_i, t_ip1, (flat_h, w_h, ti_h, tip1_h, act_h) = state
    _apm_add(t["sse"], flat, w, t_i, t_ip1, is_match, coding)
    _apm_add(t["sse_h"], flat_h, w_h, ti_h, tip1_h, is_hit, coding & act_h)


def sse_update_hit(t, key, state, coding, is_hit):
    """Hit-only APM update toward the observed hit flag (modes X and P),
    IN PLACE."""
    flat_h, w_h, ti_h, tip1_h, act_h = state
    _apm_add(t[key], flat_h, w_h, ti_h, tip1_h, is_hit, coding & act_h)


def _nc(cf):
    return (
        (cf > 1).to(_i32) + (cf > 2).to(_i32)
        + (cf > 4).to(_i32) + (cf > 8).to(_i32)
    )


def _bump(tab, sym, mask, inc, ctx=None):
    w = tab.shape[-1]
    m = mask & (sym >= 0) & (sym < w)
    if tab.dim() == 1:  # one shared row (dst)
        flat = sym[m].long()
    else:
        flat = (ctx.clamp(0, tab.shape[0] - 1) * w + sym)[m].long()
    tab.view(-1).index_add_(
        0, flat, torch.full(flat.shape, inc, dtype=_i32, device=tab.device)
    )


def apply_updates(t, coding, ctx2, sym_a, byte, old_f_byte, p1, h3, pred,
                  conf, sym_len, sym_idx, o2_halve_delta, len_ctx, idx_ctx,
                  o3_raw, sym_dst=None):
    """All model updates of one step, after the events are coded, IN
    PLACE: the o2 row delta (rescale + increments + escape elimination),
    the o1 and len/idx (mode X: len/dst, ``sym_dst`` given) count bumps,
    and the winner-only o3 write."""
    is_lit = coding & (sym_a < 256)
    is_hit = coding & (sym_a == SYM_HIT)
    is_esc = coding & (sym_a == SYM_ESC)
    is_match = coding & (sym_a == SYM_MATCH)
    dev = ctx2.device

    # o2: rescale delta (winner lanes) + coded symbol + escaped literal
    # + escape elimination, all summed per row (order-free integer adds)
    eliminate = is_lit & (old_f_byte == INC2)
    slot_ids = torch.arange(O2_W, device=dev)
    delta = torch.where(
        (slot_ids == sym_a[:, None]) & coding[:, None], INC2, 0
    )
    delta = delta + torch.where(
        (slot_ids == byte[:, None]) & is_esc[:, None], INC2, 0
    )
    delta = delta + torch.where(
        (slot_ids == SYM_ESC) & eliminate[:, None], -INC2, 0
    )
    delta = delta + o2_halve_delta
    t["o2"].index_add_(0, ctx2.long(), delta.to(_i32))

    # o1: the escaped literal under its order-1 context
    m = is_esc & (byte >= 0) & (byte < O1_NCTX)
    flat = (p1 * O1_NCTX + byte)[m].long()
    t["o1"].view(-1).index_add_(
        0, flat, torch.full(flat.shape, INC1, dtype=_i32, device=dev)
    )

    _bump(t["len"], sym_len, is_match, LEN_INC, len_ctx)
    _bump(t["idx"], sym_idx, is_match, IDX_INC, idx_ctx)
    if sym_dst is not None:  # mode X (its zero idx symbol is bumped too)
        _bump(t["dst"], sym_dst, is_match, DST_INC)

    # o3: hit strengthens, miss decays / replaces; the minimum lane per
    # entry writes (a delta equal to desired - current is an exact set)
    o3_upd = is_hit | is_lit | is_esc
    nc = _nc(conf)
    new_pred = torch.where(is_hit | (nc > 0), pred, byte)
    new_conf = torch.where(is_hit, (conf + 1).clamp_max(15), nc.clamp_min(1))
    packed = ((new_conf << 8) | new_pred).to(_i32)
    winners = tb.elect_winners(h3, o3_upd)
    o3 = t["o3"]
    o3.index_add_(0, h3[winners].long(), (packed - o3_raw)[winners])
