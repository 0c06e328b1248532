"""The port's table primitives and PPM model against the JAX package.

Random table states (numpy, fixed seeds) go to both packages: rows over
their caps, negative escape slots, o3 entries with the upper (2-way) bits
set, and lanes that collide on one context.  Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu.models import ppm as jppm
from comprox_tpu.models import tables as jtb
from comprox_tpu_torch.models import ppm
from comprox_tpu_torch.models import tables as tb

# the plain versions run many tiny ops: more intra-op threads would only
# contend with the other test workers
torch.set_num_threads(1)

O3_BITS = 14
S = 32


def _np(x):
    return np.asarray(x)


def _t(a, dtype=np.int64):
    return torch.from_numpy(np.asarray(a, dtype))


def random_tables(rng):
    """A JAX-layout table dict (numpy) in a random but reachable-looking
    state: the rows the lanes below read are randomised."""
    t = {k: _np(v).copy() for k, v in jppm.init_tables(True, O3_BITS).items()}
    return t


def randomise_rows(rng, t, ctx2s, p1s):
    for j, c in enumerate(np.unique(ctx2s)):
        hi = (50, 300, 1000)[j % 3]  # under the cap, over it, far over
        row = rng.integers(0, hi, 260).astype(np.int32)
        row[257] = rng.integers(-48, 64)  # escape slot driven negative
        row[rng.random(260) < 0.3] = 0  # zero slots change find_symbol
        t["o2"][c] = row
    for p in np.unique(p1s):
        t["o1"][p] = rng.integers(1, 28, 256)
    t["o3"] = rng.integers(0, 1 << 12, t["o3"].shape).astype(np.int32)
    upper = rng.random(t["o3"].shape) < 0.1
    t["o3"][upper] |= (rng.integers(0, 1 << 12, upper.sum()) << 12).astype(
        np.int32
    )
    t["len"] = rng.integers(1, (120, 250)[rng.integers(0, 2)], (4, 256)).astype(np.int32)
    t["idx"] = rng.integers(1, 700, (4, 80)).astype(np.int32)
    t["sse"] = rng.integers(16, 65521, t["sse"].shape).astype(np.int32)
    t["sse_h"] = rng.integers(16, 65521, t["sse_h"].shape).astype(np.int32)
    return t


def lanes(rng):
    """Per-lane inputs; contexts from a small pool so lanes collide."""
    pool2 = rng.integers(0, 1 << 16, 6)
    ctx2 = pool2[rng.integers(0, 6, S)]
    p1 = ctx2 & 0xFF
    h3 = rng.integers(0, 1 << O3_BITS, 5)[rng.integers(0, 5, S)]
    return {
        "ctx2": ctx2, "p1": p1, "h3": h3,
        "pred": rng.integers(0, 256, S), "conf": rng.integers(0, 16, S),
        "pred2": rng.integers(0, 256, S), "valid2": rng.random(S) < 0.3,
        "coding": rng.random(S) < 0.8, "fill": rng.integers(0, 65, S),
    }


def both(t_np):
    jt = {k: jnp.asarray(v) for k, v in t_np.items()}
    pt = ppm.tables_from_numpy(t_np, "cpu")
    return jt, pt


def assert_tables_equal(jt, pt):
    pn = ppm.tables_to_numpy(pt)
    for k, v in jt.items():
        np.testing.assert_array_equal(pn[k], _np(v), err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_primitives(seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-20, 400, (S, 260)).astype(np.int32)
    rows[rng.random((S, 260)) < 0.3] = 0
    sticky = rng.random(260) < 0.1
    np.testing.assert_array_equal(
        tb.halve_rows(_t(rows, np.int32), _t(sticky, bool)).numpy(),
        _np(jtb.halve_rows(jnp.asarray(rows), jnp.asarray(sticky))),
    )
    r, did = tb.rescale_read(_t(rows, np.int32), 24576, _t(sticky, bool))
    jr, jdid = jtb.rescale_read(jnp.asarray(rows), 24576, jnp.asarray(sticky))
    np.testing.assert_array_equal(r.numpy(), _np(jr))
    np.testing.assert_array_equal(did.numpy(), _np(jdid))
    rows = np.abs(rows)
    cums = tb.exclusive_cumsum(_t(rows, np.int32))
    np.testing.assert_array_equal(
        cums.numpy(), _np(jtb.exclusive_cumsum(jnp.asarray(rows)))
    )
    np.testing.assert_array_equal(
        tb.row_total(_t(rows, np.int32)).numpy(),
        _np(jtb.row_total(jnp.asarray(rows))),
    )
    tgt = rng.integers(0, rows.sum(1))
    sym, c, f = tb.find_symbol(_t(rows, np.int32), cums, _t(tgt))
    js, jc, jf = jtb.find_symbol(
        jnp.asarray(rows), jtb.exclusive_cumsum(jnp.asarray(rows)),
        jnp.asarray(tgt, jnp.int32),
    )
    for a, b in ((sym, js), (c, jc), (f, jf)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    syms = rng.integers(-3, 265, S)
    c, f = tb.cum_frq_of(_t(rows, np.int32), cums, _t(syms))
    jc, jf = jtb.cum_frq_of(
        jnp.asarray(rows), jtb.exclusive_cumsum(jnp.asarray(rows)),
        jnp.asarray(syms, jnp.int32),
    )
    np.testing.assert_array_equal(c.numpy(), _np(jc))
    np.testing.assert_array_equal(f.numpy(), _np(jf))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_elect_winners_collisions(seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 5, S)
    mask = rng.random(S) < 0.7
    np.testing.assert_array_equal(
        tb.elect_winners(_t(idx), _t(mask, bool)).numpy(),
        _np(jtb.elect_winners(jnp.asarray(idx, jnp.int32), jnp.asarray(mask))),
    )


def test_init_tables_and_fingerprint():
    for match in (True, False):
        assert_tables_equal(
            jppm.init_tables(match, O3_BITS),
            ppm.init_tables(match, O3_BITS, "cpu"),
        )
    assert ppm.format_fingerprint() == jppm.format_fingerprint()


def test_tables_numpy_roundtrip():
    t_np = random_tables(np.random.default_rng(0))
    back = ppm.tables_to_numpy(ppm.tables_from_numpy(t_np, "cpu"))
    for k in t_np:
        np.testing.assert_array_equal(back[k], t_np[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_o3_hash_and_read(seed):
    rng = np.random.default_rng(seed)
    t_np = randomise_rows(rng, random_tables(rng), [0], [0])
    jt, pt = both(t_np)
    ctx3 = rng.integers(0, 1 << 24, S)
    h3 = ppm.o3_hash(_t(ctx3), 1 << O3_BITS)
    jh3 = jppm.o3_hash(jnp.asarray(ctx3, jnp.int32), 1 << O3_BITS)
    np.testing.assert_array_equal(h3.numpy(), _np(jh3))
    for a, b in zip(ppm.o3_read(pt, h3), jppm.o3_read(jt, jh3)):
        np.testing.assert_array_equal(a.numpy(), _np(b))


def _read_o2_both(rng, t_np, ln, sse=True):
    jt, pt = both(t_np)
    j = jppm.read_o2(
        jt, jnp.asarray(ln["ctx2"], jnp.int32), jnp.asarray(ln["pred"], jnp.int32),
        jnp.asarray(ln["coding"]), jnp.asarray(ln["conf"], jnp.int32),
        jnp.asarray(ln["pred2"], jnp.int32), jnp.asarray(ln["valid2"]),
        sse_fill=jnp.asarray(ln["fill"], jnp.int32) if sse else None,
    )
    p = ppm.read_o2(
        pt, _t(ln["ctx2"]), _t(ln["pred"], np.int32), _t(ln["coding"], bool),
        _t(ln["conf"], np.int32),
        sse_fill=_t(ln["fill"], np.int32) if sse else None,
    )
    return jt, pt, j, p


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_read_o2_with_sse(seed):
    rng = np.random.default_rng(seed)
    ln = lanes(rng)
    t_np = randomise_rows(rng, random_tables(rng), ln["ctx2"], ln["p1"])
    _, _, j, p = _read_o2_both(rng, t_np, ln)
    _, jrows, jrowmod, jcums, jtot, jhd, jst = j
    rows, rowmod, cums, tot, hd, st = p
    for a, b in ((rows, jrows), (rowmod, jrowmod), (cums, jcums),
                 (tot, jtot), (hd, jhd)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    flat, w, ti, tip1, hit = st
    jflat, jw, jti, jtip1, jhit = jst
    for a, b in zip((flat, w, ti, tip1) + hit, (jflat, jw, jti, jtip1) + jhit):
        np.testing.assert_array_equal(a.numpy(), _np(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_read_o1_excl(seed):
    rng = np.random.default_rng(seed)
    ln = lanes(rng)
    t_np = randomise_rows(rng, random_tables(rng), ln["ctx2"], ln["p1"])
    jt, pt, j, p = _read_o2_both(rng, t_np, ln, sse=False)
    jt2, jr, jw, jc, jtot = jppm.read_o1_excl(
        jt, jnp.asarray(ln["p1"], jnp.int32), j[1],
        jnp.asarray(ln["pred"], jnp.int32), jnp.asarray(ln["coding"]),
        jnp.asarray(ln["pred2"], jnp.int32), jnp.asarray(ln["valid2"]),
    )
    r, w, c, tot = ppm.read_o1_excl(
        pt, _t(ln["p1"]), p[0], _t(ln["pred"], np.int32),
        _t(ln["pred2"], np.int32), _t(ln["valid2"], bool),
    )
    for a, b in ((r, jr), (w, jw), (c, jc), (tot, jtot)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_array_equal(pt["o1"].numpy(), _np(jt2["o1"]))


@pytest.mark.parametrize("key", ["len", "idx"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_read_shared_ctx(key, seed):
    rng = np.random.default_rng(seed)
    t_np = randomise_rows(rng, random_tables(rng), [0], [0])
    t_np[key][rng.integers(0, 4)] *= 3  # one row far over its cap
    jt, pt = both(t_np)
    mask = rng.random(S) < 0.4
    ctx = rng.integers(0, 4, S)
    jfn = jppm.read_len if key == "len" else jppm.read_idx
    pfn = ppm.read_len if key == "len" else ppm.read_idx
    jt2, jrows, jcums, jtots = jfn(jt, jnp.asarray(mask), jnp.asarray(ctx, jnp.int32))
    rows, cums, tots = pfn(pt, _t(mask, bool), _t(ctx, np.int32))
    for a, b in ((rows, jrows), (cums, jcums), (tots, jtots)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_array_equal(pt[key].numpy(), _np(jt2[key]))


@pytest.mark.parametrize("seed", [0, 1])
def test_sse_contexts_and_apm(seed):
    rng = np.random.default_rng(seed)
    fill = rng.integers(0, 65, S)
    conf = rng.integers(0, 16, S)
    np.testing.assert_array_equal(
        ppm.sse_ctx_of(_t(fill, np.int32), _t(conf, np.int32)).numpy(),
        _np(jppm.sse_ctx_of(jnp.asarray(fill, jnp.int32), jnp.asarray(conf, jnp.int32))),
    )
    np.testing.assert_array_equal(
        ppm.sse_hit_ctx_of(_t(conf, np.int32), _t(fill, np.int32)).numpy(),
        _np(jppm.sse_hit_ctx_of(jnp.asarray(conf, jnp.int32), jnp.asarray(fill, jnp.int32))),
    )
    tab = rng.integers(16, 65521, ppm.SSE_NCTX * 33).astype(np.int32)
    ctx = rng.integers(0, ppm.SSE_NCTX, S)
    p16 = rng.integers(1, 4096, S) << 4
    got = ppm._apm_read(_t(tab, np.int32), _t(ctx, np.int32), _t(p16, np.int32))
    want = jppm._apm_read(jnp.asarray(tab), ppm.SSE_NCTX,
                          jnp.asarray(ctx, jnp.int32), jnp.asarray(p16, jnp.int32))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    outcome = rng.random(S) < 0.5
    active = rng.random(S) < 0.7
    ptab = _t(tab.copy(), np.int32)
    ppm._apm_add(ptab, *got[1:], _t(outcome, bool), _t(active, bool))
    jd = jppm._apm_delta(ppm.SSE_NCTX, *want[1:], jnp.asarray(outcome),
                         jnp.asarray(active))
    np.testing.assert_array_equal(
        ptab.numpy(), np.clip(tab + _np(jd), ppm.SSE_LO, ppm.SSE_HI)
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_apply_updates_and_sse_update(seed):
    """One whole step of model updates on colliding lanes: every table
    after apply_updates + sse_update equals the JAX package's."""
    rng = np.random.default_rng(seed)
    ln = lanes(rng)
    t_np = randomise_rows(rng, random_tables(rng), ln["ctx2"], ln["p1"])
    jt, pt, j, p = _read_o2_both(rng, t_np, ln)
    jh3 = jnp.asarray(ln["h3"], jnp.int32)
    pred, conf, pred2, conf2, raw = ppm.o3_read(pt, _t(ln["h3"]))
    jpred, jconf, jpred2, jconf2, jraw = jppm.o3_read(jt, jh3)
    kind = rng.integers(0, 4, S)
    byte = rng.integers(0, 256, S)
    sym_a = np.where(kind == 0, ppm.SYM_HIT, np.where(
        kind == 1, ppm.SYM_ESC, np.where(kind == 2, ppm.SYM_MATCH, byte)))
    byte = np.where(kind == 0, pred.numpy(), byte)
    old_f = np.where(rng.random(S) < 0.5, ppm.INC2, rng.integers(0, 40, S))
    sym_len = rng.integers(0, 256, S)
    sym_idx = rng.integers(0, 64, S)
    len_ctx = rng.integers(0, 4, S)
    idx_ctx = rng.integers(0, 4, S)
    coding = ln["coding"]
    ji = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    jt2 = jppm.apply_updates(
        jt, jnp.asarray(coding), ji(ln["ctx2"]), ji(sym_a), ji(byte),
        ji(old_f), ji(ln["p1"]), jh3, jpred, jconf, ji(sym_len), ji(sym_idx),
        None, o2_halve_delta=j[5], len_ctx=ji(len_ctx), idx_ctx=ji(idx_ctx),
        o3_raw=jraw, pred2=jpred2, conf2=jconf2,
    )
    is_match = coding & (sym_a == ppm.SYM_MATCH)
    is_hit = coding & (sym_a == ppm.SYM_HIT)
    jt2 = jppm.sse_update(jt2, j[6], jnp.asarray(coding),
                          jnp.asarray(is_match), is_hit=jnp.asarray(is_hit))
    ppm.apply_updates(
        pt, _t(coding, bool), _t(ln["ctx2"]), _t(sym_a), _t(byte), _t(old_f),
        _t(ln["p1"]), _t(ln["h3"]), pred, conf, _t(sym_len), _t(sym_idx),
        p[4], _t(len_ctx), _t(idx_ctx), raw,
    )
    ppm.sse_update(pt, p[5], _t(coding, bool), _t(is_match, bool),
                   _t(is_hit, bool))
    assert_tables_equal(jt2, pt)


@pytest.mark.parametrize(
    "knob,value",
    [("O3_2WAY", 1), ("O3_GROUPS", 2), ("O3_GROUPUPD", 1), ("O2_MAXCAP", 4),
     ("O2_EE", 1), ("CONF_BOOST", 1), ("SSE", 0), ("SSE_MCTX", 0),
     ("SSE_HIT", 0)],
)
def test_unported_knobs_raise(monkeypatch, knob, value):
    monkeypatch.setattr(ppm, knob, value)
    with pytest.raises(NotImplementedError, match=f"CPX_{knob}"):
        ppm.init_tables(True, O3_BITS, "cpu")


# --------------------------------------------------------------------------
# Mode X: the distance-bucket row, the hit-only APM, the mantissa table
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_read_dst(seed):
    """The shared distance-bucket row: halved (up to three rounds) only
    when a match lane reads it over DST_CAP."""
    rng = np.random.default_rng(seed)
    t_np = random_tables(rng)
    t_np["dst"] = rng.integers(1, (400, 2000, 9000, 60000)[seed], 32).astype(np.int32)
    jt, pt = both(t_np)
    mask = (rng.random(S) < 0.3) if seed != 1 else np.zeros(S, bool)
    jt2, jrows, jcums, jtots = jppm.read_dst(jt, jnp.asarray(mask))
    rows, cums, tots = ppm.read_dst(pt, _t(mask, bool))
    for a, b in ((rows, jrows), (cums, jcums), (tots, jtots)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_array_equal(pt["dst"].numpy(), _np(jt2["dst"]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_read_o2_with_hit_only_sse_and_update(seed):
    """read_o2 with mode X's hit-only APM (48 contexts on ``sse_x``: no
    match-flag reshape), then apply_updates with the distance symbol and
    sse_update_hit: every table equals the JAX package's."""
    rng = np.random.default_rng(seed)
    ln = lanes(rng)
    t_np = randomise_rows(rng, random_tables(rng), ln["ctx2"], ln["p1"])
    t_np["sse_x"] = rng.integers(16, 65521, t_np["sse_x"].shape).astype(np.int32)
    jt, pt = both(t_np)
    ji = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    jctx = jppm.sse_x_ctx_of(ji(ln["conf"]), ji(ln["p1"]))
    pctx = ppm.sse_x_ctx_of(_t(ln["conf"], np.int32), _t(ln["p1"], np.int32))
    np.testing.assert_array_equal(pctx.numpy(), _np(jctx))
    assert int(pctx.max()) < ppm.SSE_XCTX
    j = jppm.read_o2(
        jt, ji(ln["ctx2"]), ji(ln["pred"]), jnp.asarray(ln["coding"]),
        ji(ln["conf"]), ji(ln["pred2"]), jnp.asarray(ln["valid2"]),
        sse_hitx=("sse_x", jppm.SSE_XCTX, jctx))
    p = ppm.read_o2(
        pt, _t(ln["ctx2"]), _t(ln["pred"], np.int32), _t(ln["coding"], bool),
        _t(ln["conf"], np.int32), sse_hitx=("sse_x", pctx))
    for a, b in zip(p[:5], j[1:6]):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    for a, b in zip(p[5], j[6]):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    # the match slot is not reshaped in mode X
    np.testing.assert_array_equal(p[1][:, ppm.SYM_MATCH].numpy(),
                                  p[0][:, ppm.SYM_MATCH].numpy())

    jh3 = ji(ln["h3"])
    pred, conf, pred2, conf2, raw = ppm.o3_read(pt, _t(ln["h3"]))
    jpred, jconf, jpred2, jconf2, jraw = jppm.o3_read(jt, jh3)
    kind = rng.integers(0, 4, S)
    byte = rng.integers(0, 256, S)
    sym_a = np.where(kind == 0, ppm.SYM_HIT, np.where(
        kind == 1, ppm.SYM_ESC, np.where(kind == 2, ppm.SYM_MATCH, byte)))
    old_f = np.where(rng.random(S) < 0.5, ppm.INC2, rng.integers(0, 40, S))
    sym_len = rng.integers(0, 256, S)
    sym_dst = rng.integers(0, 34, S)  # past the row: dropped
    len_ctx = rng.integers(0, 4, S)
    zero = np.zeros(S, np.int64)
    coding = ln["coding"]
    is_hit = coding & (sym_a == ppm.SYM_HIT)
    jt2 = jppm.apply_updates(
        jt, jnp.asarray(coding), ji(ln["ctx2"]), ji(sym_a), ji(byte),
        ji(old_f), ji(ln["p1"]), jh3, jpred, jconf, ji(sym_len), ji(zero),
        ji(sym_dst), o2_halve_delta=j[5], len_ctx=ji(len_ctx), idx_ctx=ji(zero),
        o3_raw=jraw, pred2=jpred2, conf2=jconf2)
    jt2 = jppm.sse_update_hit(jt2, "sse_x", jppm.SSE_XCTX, j[6],
                              jnp.asarray(coding), jnp.asarray(is_hit))
    ppm.apply_updates(
        pt, _t(coding, bool), _t(ln["ctx2"]), _t(sym_a), _t(byte), _t(old_f),
        _t(ln["p1"]), _t(ln["h3"]), pred, conf, _t(sym_len), _t(zero),
        p[4], _t(len_ctx), _t(zero), raw, sym_dst=_t(sym_dst))
    ppm.sse_update_hit(pt, "sse_x", p[5], _t(coding, bool), _t(is_hit, bool))
    assert_tables_equal(jt2, pt)
    assert not np.array_equal(_np(jt2["dst"]), t_np["dst"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mantissa_read_update_and_events(seed):
    """The adaptive mantissa table: the row read, the D/E events of the
    encoder for every bucket 0..24, and the update (all adaptive lanes add,
    then a row over MANT_CAP is halved) — summed by integers here, by an
    exact one-hot product in the JAX package."""
    from comprox_tpu.codec import block as jblk
    from comprox_tpu_torch.codec import block as blk

    rng = np.random.default_rng(seed)
    s = 64
    t_np = random_tables(rng)
    t_np["mant"] = rng.integers(1, (30, 600, 1100, 3000)[seed], (16, 16)).astype(np.int32)
    jt, pt = both(t_np)
    k = rng.integers(0, 25, s)
    k[:25] = np.arange(25)
    dist = (1 << k) + (rng.integers(0, 1 << 24, s) & ((1 << k) - 1))
    has_extra = rng.random(s) < 0.8
    has_extra[:25] = True
    ji = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    np.testing.assert_array_equal(blk._dist_bucket(_t(dist)).numpy(), k)
    mctx = np.clip(k - 5, 0, 11)
    joh, jrows, jcums, jtot = jblk._mant_read(jt, ji(mctx))
    rows, cums, tot = blk._mant_read(pt, _t(mctx))
    for a, b in ((rows, jrows), (cums, jcums), (tot, jtot)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    jout = jblk._mant_events_enc(jt, ji(dist), ji(k), jnp.asarray(has_extra))
    out = blk._mant_events_enc(pt, _t(dist), _t(k), _t(has_extra, bool))
    for a, b in zip(out, jout[:6]):
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      _np(b).astype(np.int64))
    np.testing.assert_array_equal(pt["mant"].numpy(), _np(jout[6]["mant"]))
    assert_tables_equal(jout[6], pt)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_read_o2_with_mode_p_hit_sse_and_update(seed):
    """Mode P's hit-only APM: ``sse_p_ctx_of`` (conf class x candidate
    availability x p1 class, 24 contexts), read_o2 on ``sse_p``, then
    apply_updates with the zero index symbol a match carries (JAX bumps
    idx[0][0]) and sse_update_hit: every table equals the JAX package's."""
    rng = np.random.default_rng(seed)
    ln = lanes(rng)
    t_np = randomise_rows(rng, random_tables(rng), ln["ctx2"], ln["p1"])
    t_np["sse_p"] = rng.integers(16, 65521, t_np["sse_p"].shape).astype(np.int32)
    jt, pt = both(t_np)
    ji = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    avail = rng.random(S) < 0.5
    jctx = jppm.sse_p_ctx_of(ji(ln["conf"]), jnp.asarray(avail), ji(ln["p1"]))
    pctx = ppm.sse_p_ctx_of(_t(ln["conf"], np.int32), _t(avail, bool),
                            _t(ln["p1"], np.int32))
    np.testing.assert_array_equal(pctx.numpy(), _np(jctx))
    assert 0 <= int(pctx.min()) and int(pctx.max()) < ppm.SSE_PCTX == jppm.SSE_PCTX
    j = jppm.read_o2(
        jt, ji(ln["ctx2"]), ji(ln["pred"]), jnp.asarray(ln["coding"]),
        ji(ln["conf"]), ji(ln["pred2"]), jnp.asarray(ln["valid2"]),
        sse_hitx=("sse_p", jppm.SSE_PCTX, jctx))
    p = ppm.read_o2(
        pt, _t(ln["ctx2"]), _t(ln["pred"], np.int32), _t(ln["coding"], bool),
        _t(ln["conf"], np.int32), sse_hitx=("sse_p", pctx))
    for a, b in zip(p[:5], j[1:6]):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    for a, b in zip(p[5], j[6]):
        np.testing.assert_array_equal(a.numpy(), _np(b))

    jh3 = ji(ln["h3"])
    pred, conf, pred2, conf2, raw = ppm.o3_read(pt, _t(ln["h3"]))
    jpred, jconf, jpred2, jconf2, jraw = jppm.o3_read(jt, jh3)
    kind = rng.integers(0, 4, S)
    byte = rng.integers(0, 256, S)
    sym_a = np.where(kind == 0, ppm.SYM_HIT, np.where(
        kind == 1, ppm.SYM_ESC, np.where(kind == 2, ppm.SYM_MATCH, byte)))
    old_f = np.where(rng.random(S) < 0.5, ppm.INC2, rng.integers(0, 40, S))
    sym_len = rng.integers(0, 256, S)
    zero = np.zeros(S, np.int64)
    coding = ln["coding"]
    is_hit = coding & (sym_a == ppm.SYM_HIT)
    jt2 = jppm.apply_updates(
        jt, jnp.asarray(coding), ji(ln["ctx2"]), ji(sym_a), ji(byte),
        ji(old_f), ji(ln["p1"]), jh3, jpred, jconf, ji(sym_len), ji(zero),
        None, o2_halve_delta=j[5], len_ctx=ji(zero), idx_ctx=ji(zero),
        o3_raw=jraw, pred2=jpred2, conf2=jconf2)
    jt2 = jppm.sse_update_hit(jt2, "sse_p", jppm.SSE_PCTX, j[6],
                              jnp.asarray(coding), jnp.asarray(is_hit))
    ppm.apply_updates(
        pt, _t(coding, bool), _t(ln["ctx2"]), _t(sym_a), _t(byte), _t(old_f),
        _t(ln["p1"]), _t(ln["h3"]), pred, conf, _t(sym_len), _t(zero),
        p[4], _t(zero), _t(zero), raw)
    ppm.sse_update_hit(pt, "sse_p", p[5], _t(coding, bool), _t(is_hit, bool))
    assert_tables_equal(jt2, pt)
    if (coding & (sym_a == ppm.SYM_MATCH)).any():
        assert _np(jt2["idx"])[0, 0] > t_np["idx"][0, 0], "a match bumps idx[0][0]"
    assert not np.array_equal(_np(jt2["sse_p"]), t_np["sse_p"])
