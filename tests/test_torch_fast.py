"""Mode F, the fast profile: the port's plain passes (K7 finder, K8
tokenizer, K9 static-rANS encode, K10 static-rANS decode) and its block
codec against the JAX package's ``codec/fast.py`` on the same bytes, exactly
(tolerance 0 on every output array: the codec is integer arithmetic).  Each
pass is fed the JAX output of the pass before it; the block tests chain
them.  K6's mode-F entry is in ``test_torch_parse.py``, the container in
``test_torch_container.py``.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu.codec import block as jblk
from comprox_tpu.codec import fast as jfast
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec import fast as tfast
from comprox_tpu_torch.utils import native

from test_fast import corpus

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GEOMETRIES = {
    # tests/test_fast.py::SMALL_F
    "small": dict(lanes=8, steps=512, mode="F", min_len=6, window=64),
    # the main path's lane count at a small T
    "wide": dict(lanes=512, steps=32, mode="F", min_len=6, window=250),
}
# (corpus, geometry, bytes short of a full block)
CASES = [
    ("text", "small", 0), ("zeros", "small", 0), ("period7", "small", 0),
    ("random", "small", 0), ("lowent", "small", 0), ("text", "small", 1001),
    ("period7", "small", 4096 - 100), ("text", "small", 4096 - 7),
    ("text", "small", 4096 - 2), ("text", "small", 4096 - 1),
    ("text", "wide", 0), ("zeros", "wide", 3000), ("lowent", "wide", 77),
]


def fast_corpus(name, n, seed=1):
    if name == "lowent":  # low entropy: four byte values, skewed
        rng = np.random.default_rng(seed)
        return rng.choice(np.array([97, 98, 99, 10], np.uint8), n,
                          p=[0.7, 0.15, 0.1, 0.05])
    return corpus(name, n, seed=seed)


def params(geo):
    kw = GEOMETRIES[geo]
    return jblk.BlockParams(**kw), blk.BlockParams(**kw)


def block_buf(name, pj, short):
    n = pj.capacity - short
    buf = np.zeros((pj.lanes, pj.steps), np.uint8)
    buf.reshape(-1)[:n] = fast_corpus(name, n)
    return buf, n


def grid(pj, v):
    """[N] position order -> the port's [T, S] layout."""
    return np.asarray(v).reshape(pj.lanes, pj.steps).T


@functools.partial(jax.jit, static_argnums=0)
def jax_find(p, inp, n):
    return jfast._f2_find(p, inp.reshape(-1), n)


@functools.partial(jax.jit, static_argnums=0)
def jax_parse_f(p, n, outs):
    """The reversed scan of _parse_body as _fast_find_matches runs it."""
    parse = functools.partial(
        jblk._parse_body, jfast._search_params(p), n, n_c=len(outs) // 2,
        prices=jfast._F_PRICES)
    ts = jnp.arange(p.steps, dtype=jnp.int32)
    _, dec = jax.lax.scan(parse, jnp.zeros((p.lanes, p.window), jnp.int32),
                          (ts,) + tuple(outs), reverse=True)
    return dec


@functools.partial(jax.jit, static_argnums=0)
def jax_tokens(p, inp, n, take, src):
    ts = jnp.arange(p.steps, dtype=jnp.int32)
    body = functools.partial(jfast._replay_body, p, inp, n)
    _, ev = jax.lax.scan(body, (jnp.zeros((p.lanes,), jnp.int32),), (ts, take, src))
    toks, n_tok = jfast._tokenize(p, ev, n)
    return (toks, n_tok) + jfast._token_events(p, toks, n_tok)


@functools.lru_cache(maxsize=None)
def jax_stages(name, geo, short):
    """Every intermediate of the JAX encode of one case, as numpy."""
    pj, _ = params(geo)
    buf, n = block_buf(name, pj, short)
    inp, nj = jnp.asarray(buf), jnp.int32(n)
    cands = jax_find(pj, inp, nj)
    cgrid = np.stack([grid(pj, g) for l, s in cands for g in (l, s)])
    take, src, idx = jax_parse_f(pj, nj, tuple(jnp.asarray(g) for g in cgrid))
    toks, n_tok, sym, xtr, tbits, active = jax_tokens(pj, inp, nj, take, src)
    freq, x, words, n_words, n_tok2, _ = jfast._encode_fast(pj, inp, nj, pj.lanes)
    assert int(n_tok) == int(n_tok2)
    return dict(
        buf=buf, n=n, cands=cgrid,
        dec=np.stack([np.asarray(take), np.asarray(src), np.asarray(idx)]),
        toks=np.asarray(toks), n_tok=int(n_tok), sym=np.asarray(sym),
        xtr=np.asarray(xtr), tbits=np.asarray(tbits), active=np.asarray(active),
        freq=np.asarray(freq), states=np.asarray(x),
        words=np.asarray(words)[: int(n_words)], n_words=int(n_words))


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


@pytest.mark.parametrize("name,geo,short", CASES)
def test_f2_find_equals_jax(name, geo, short):
    """len and src of both candidates at every position, usable or not."""
    pj, pt = params(geo)
    st = jax_stages(name, geo, short)
    got = tfast.f2_find(pt, torch.from_numpy(st["buf"]), st["n"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), st["cands"])
    if name != "random" and st["n"] > 100:
        assert (st["cands"][0] >= pt.min_len).any(), "the case must have matches"


@pytest.mark.parametrize("name,geo,short", CASES)
def test_parse_scan_f_equals_jax_on_the_finders_candidates(name, geo, short):
    """K6's mode-F entry on the JAX finder's candidates: the decisions of the
    reversed ``_parse_body`` scan that ``_fast_find_matches`` runs."""
    pj, pt = params(geo)
    st = jax_stages(name, geo, short)
    got = blk.parse_scan(pt, st["n"], t32(st["cands"]), prices=tfast._F_PRICES,
                         n_c=tfast._F_CANDS)
    np.testing.assert_array_equal(got.numpy(), st["dec"])
    if name != "random" and st["n"] > 100:
        assert (st["dec"][0] >= pt.min_len).any(), "the case must take matches"


def test_sort_keys_are_the_six_byte_hash():
    pj, pt = params("small")
    buf, n = block_buf("text", pj, 9)
    bytes_pad = tfast.pad_block(pt, torch.from_numpy(buf))
    assert bytes_pad.numel() == blk.pad_block_len(pt, 4 * tfast._EXTW)
    assert bytes_pad.numel() % 8 == 0
    keys = tfast.sort_keys_plain(pt, bytes_pad, n).numpy()
    flat = np.concatenate([buf.reshape(-1), np.zeros(8, np.uint8)]).astype(np.uint64)
    for i in (0, 5, n - 1):
        w = sum(int(flat[i + j]) << (8 * j) for j in range(4))
        w45 = int(flat[i + 4]) | int(flat[i + 5]) << 8
        want = (w * 0x9E3779B1 % (1 << 32)) ^ (w45 * 0x85EBCA77 % (1 << 32))
        assert keys[i] == want
    assert (keys[n:] == 0xFFFFFFFF).all()
    hs, ps = tfast.sort_positions(pt, bytes_pad, n)
    order = np.lexsort((np.arange(keys.size), keys))
    np.testing.assert_array_equal(ps.numpy(), order)
    np.testing.assert_array_equal(hs.numpy(), keys[order])


def test_row_gather_never_clamps():
    """fast.py:224 clamps the candidate's row to R - 1; a candidate is below
    N, so its row is below ceil(N / 4) + 3 = R at every block size, also
    where N is not a multiple of 4 — the port needs no counterpart."""
    for big in (4096, 16384, 4090, 4091, 1 << 23):
        pad = 4 * tfast._EXTW + 16
        rows = -(-(big + pad - 4) // 4) - tfast._EXTW  # len(w_all[::4]) - EXTW
        assert (big - 1) >> 2 < rows


@pytest.mark.parametrize("tail", [False, True])
def test_short_extension_needs_the_diagonal_runs(monkeypatch, tail):
    """With two words per candidate the diagonal-run recovery supplies the
    long lengths, with and without the run's last byte (CPX_F_DIAG_TAIL)."""
    for mod in (jfast, tfast):
        monkeypatch.setattr(mod, "_EXTW", 2)
        monkeypatch.setattr(mod, "_F_DIAG_TAIL", tail)
    pj, pt = params("small")
    buf, n = block_buf("period7", pj, 10)
    ref = jfast._f2_find(pj, jnp.asarray(buf.reshape(-1)), jnp.int32(n))  # untraced
    ref = np.stack([grid(pj, g) for l, s in ref for g in (l, s)])
    assert ref[0].max() > 12
    got = tfast.f2_find(pt, torch.from_numpy(buf), n).numpy()
    np.testing.assert_array_equal(got, ref)


def test_block_payload_with_the_diagonal_tail(monkeypatch):
    """CPX_F_DIAG_TAIL=1 end to end: lengths grow by at most one byte and the
    payload is still JAX's (a geometry no other test traces under jit)."""
    kw = dict(lanes=8, steps=256, mode="F", min_len=6, window=64)
    pj, pt = jblk.BlockParams(**kw), blk.BlockParams(**kw)
    buf, n = block_buf("period7", pj, 33)
    data = buf.reshape(-1)[:n].copy()
    inp = torch.from_numpy(buf)
    without = tfast.f2_find(pt, inp, n)
    for mod in (jfast, tfast):
        monkeypatch.setattr(mod, "_EXTW", 3)
        monkeypatch.setattr(mod, "_F_DIAG_TAIL", True)
    monkeypatch.setattr(tfast, "_EXTW", 16)
    assert (tfast.f2_find(pt, inp, n)[0::2] - without[0::2]).abs().max() <= 1
    monkeypatch.setattr(tfast, "_EXTW", 3)
    ref = jfast.encode_block_fast(data, pj)
    assert tfast.encode_block_fast(data, pt, "cpu") == ref
    np.testing.assert_array_equal(tfast.decode_block_fast(ref, n, pt, "cpu"), data)


def test_diag_run_len_without_tail():
    rng = np.random.default_rng(3)
    eq1 = rng.random(300) < 0.8
    diag = rng.random(300) < 0.8
    diag[-1] = False
    for tail in (False, True):
        np.testing.assert_array_equal(
            blk._diag_run_len(torch.from_numpy(eq1), torch.from_numpy(diag), tail).numpy(),
            np.asarray(jblk._diag_run_len(jnp.asarray(eq1), jnp.asarray(diag), tail)))


@pytest.mark.parametrize("name,geo,short", CASES)
def test_tokenize_equals_jax(name, geo, short):
    """Replay + tokenize + events on the JAX decisions: the token arrays over
    all N slots (the non-starts behind the tokens too), n_tok, and every
    token's (sym, xtr, bits); the wrapper hands on the n_tok tokens alone."""
    pj, pt = params(geo)
    st = jax_stages(name, geo, short)
    args = (pt, torch.from_numpy(st["buf"]), st["n"], t32(st["dec"]))
    toks, n_tok, sym, xtr, tbits = tfast.tokenize_plain(*args)
    assert n_tok == st["n_tok"]
    got = tfast.tokenize(*args)
    assert got[0] == n_tok
    for a, b in zip(got[1:], (sym, xtr, tbits)):
        assert a.shape == (n_tok,) and torch.equal(a, b[:n_tok])
    np.testing.assert_array_equal(toks.numpy(), st["toks"])
    np.testing.assert_array_equal(sym.numpy(), st["sym"])
    np.testing.assert_array_equal(xtr.numpy().view(np.uint32), st["xtr"])
    np.testing.assert_array_equal(tbits.numpy(), st["tbits"])
    assert st["active"].sum() == n_tok
    if name in ("zeros", "period7") and st["n"] > 1000:
        assert (st["sym"] >= 256 + tfast.DB_REPEAT * tfast.L_BUCKETS).any(), \
            "the case must code repeat distances"


def test_len_code_roundtrip_equals_jax():
    v = np.arange(256, dtype=np.int32)
    lb, bits, mant = (np.asarray(a) for a in jfast._len_code(jnp.asarray(v)))
    glb, gbits, gmant = tfast._len_code(torch.from_numpy(v).long())
    np.testing.assert_array_equal(glb.numpy(), lb)
    np.testing.assert_array_equal(gbits.numpy(), bits)
    np.testing.assert_array_equal(gmant.numpy(), mant)
    np.testing.assert_array_equal(tfast._len_decode(glb, gmant).numpy(), v)
    assert lb.max() == tfast.L_BUCKETS - 1


def test_last_nonzero_fill_equals_jax():
    rng = np.random.default_rng(4)
    e = rng.integers(0, 50, 500).astype(np.int32)
    e[rng.random(500) < 0.7] = 0
    e[:5] = 0
    np.testing.assert_array_equal(
        tfast._last_nonzero_fill(torch.from_numpy(e)).numpy(),
        np.asarray(jfast._last_nonzero_fill(jnp.asarray(e))))


@pytest.mark.parametrize("which", range(6))
def test_normalize_freqs_equals_jax(which):
    h = (
        np.array([5, 0, 3, 1], np.int32),
        np.ones(282, np.int32),
        np.concatenate([[10**7], np.ones(281, np.int32)]).astype(np.int32),
        np.zeros(256, np.int32),  # absent class: the mass lands on symbol 0
        np.array([7, 9, 9, 2, 9], np.int32),  # the drift goes to the FIRST largest
        np.random.default_rng(5).integers(0, 1 << 20, 581).astype(np.int32),
    )[which]
    ref = np.asarray(jfast.normalize_freqs(jnp.asarray(h), h.size))
    got = tfast.normalize_freqs(torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == tfast.M and ((got > 0) | (h == 0)).all()


@pytest.mark.parametrize("name,geo,short", CASES)
def test_encode_scan_equals_jax(name, geo, short):
    """K9 on the JAX tokens: the static table, the final states, the words
    in the decoder's order (``_encode_fast``'s buffer prefix, which holds
    them in emission order, reversed) and their count."""
    pj, pt = params(geo)
    st = jax_stages(name, geo, short)
    freq, states, words = tfast.encode_scan(
        pt, t32(st["sym"]), t32(st["xtr"].view(np.int32)), t32(st["tbits"]),
        st["n_tok"])
    np.testing.assert_array_equal(freq.numpy(), st["freq"])
    np.testing.assert_array_equal(states.numpy(), st["states"])
    assert words.numel() == st["n_words"]
    np.testing.assert_array_equal(words.numpy(), st["words"][::-1])


@pytest.mark.parametrize("name,geo,short", CASES)
def test_decode_scan_equals_jax(name, geo, short):
    """K10 on the JAX stream: the slot table, the drained states, the words
    consumed and the token plane over all N slots; the wrapper hands on the
    n_tok tokens alone."""
    pj, pt = params(geo)
    st = jax_stages(name, geo, short)
    stream = np.zeros(jfast._max_words(pj), np.uint16)
    stream[: st["n_words"]] = st["words"][::-1]
    x, base, plane = jfast._fast_decode_scan(
        pj, jnp.asarray(st["freq"]), jnp.asarray(st["states"]),
        jnp.asarray(stream), jnp.int32(st["n_tok"]))
    np.testing.assert_array_equal(
        tfast._build_dec_table(t32(st["freq"])).numpy(),
        np.asarray(jfast._build_dec_table(jnp.asarray(st["freq"]))))
    args = (pt, t32(st["freq"]), torch.from_numpy(st["states"].astype(np.int64)),
            t32(stream), st["n_tok"])
    gx, gbase, gplane = tfast.decode_scan_plain(*args)
    wx, wbase, wplane = tfast.decode_scan(*args)
    assert wbase == gbase and torch.equal(wx, gx)
    assert wplane.shape == (st["n_tok"],)
    assert torch.equal(wplane, gplane[: st["n_tok"]])
    assert gbase == int(base) == st["n_words"]
    np.testing.assert_array_equal(gx.numpy(), np.asarray(x))
    assert (gx.numpy() == tfast.RANS_L).all()
    np.testing.assert_array_equal(gplane.numpy().view(np.uint32), np.asarray(plane))


@pytest.mark.parametrize("flexible", [True, False])
@pytest.mark.parametrize("name,geo,short", CASES)
def test_block_payload_equals_jax_and_cross_decodes(name, geo, short, flexible):
    """encode_block_fast's payload == JAX's, under the flexible parse and
    the greedy one (crf -f0); each package decodes the other's payload."""
    kw = dict(GEOMETRIES[geo], flexible=flexible)
    pj, pt = jblk.BlockParams(**kw), blk.BlockParams(**kw)
    buf, n = block_buf(name, pj, short)
    data = buf.reshape(-1)[:n].copy()
    ref = jfast.encode_block_fast(data, pj)
    got = tfast.encode_block_fast(data, pt, "cpu")
    assert got == ref
    np.testing.assert_array_equal(tfast.decode_block_fast(ref, n, pt, "cpu"), data)
    np.testing.assert_array_equal(jfast.decode_block_fast(got, n, pj), data)


def test_greedy_decisions_equal_jax():
    pj, pt = params("small")
    st = jax_stages("text", "small", 0)
    outs = tuple(jnp.asarray(g) for g in st["cands"])
    take, src = jblk._greedy_decisions(jfast._search_params(pj), jnp.int32(st["n"]), outs)
    gt, gs = blk._greedy_decisions_dist(pt, t32(st["cands"]))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(take))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(src))
    assert (np.asarray(take) > 0).any()
    d = torch.from_numpy(np.array([1, 2, 3, 4, 1023, 1024, (1 << 24) - 1, 1 << 24]))
    np.testing.assert_array_equal(
        blk._dist_bucket(d).numpy(), np.asarray(jblk._dist_bucket(jnp.asarray(d.numpy()))))


def _payload(seed=5):
    _, pt = params("small")
    data = corpus("text", pt.capacity, seed=seed)
    return pt, data, tfast.encode_block_fast(data, pt, "cpu")


def _no_launch(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a validation must raise before the decode pass")
    monkeypatch.setattr(tfast, "decode_scan", boom)


@pytest.mark.parametrize("fault", ["raw_size_0", "raw_size_big", "short",
                                   "table_sum", "n_tok_0", "n_tok_big",
                                   "stream_short", "stream_long"])
def test_payload_validation_raises_before_the_decode_pass(monkeypatch, fault):
    """Each check of fast.py:731-752, with JAX's message."""
    pt, data, payload = _payload()
    _no_launch(monkeypatch)
    n = data.size
    hdr = np.frombuffer(payload[:12], "<u4").copy()
    if fault == "raw_size_0":
        n, match = 0, "bad raw size"
    elif fault == "raw_size_big":
        n, match = pt.capacity + 1, "bad raw size"
    elif fault == "short":
        payload, match = payload[: 12 + 2 * tfast.W_SYM + 4 * pt.lanes - 1], "truncated fast-block"
    elif fault == "table_sum":
        mut = bytearray(payload)
        mut[12 + 2 * ord("e")] ^= 1
        payload, match = bytes(mut), "static table sum != M"
    elif fault in ("n_tok_0", "n_tok_big"):
        hdr[1] = 0 if fault == "n_tok_0" else pt.capacity + 1
        payload, match = hdr.tobytes() + payload[12:], "bad token count"
    elif fault == "stream_short":
        payload, match = payload[:-2], "truncated stream"
    else:
        hdr[0] = tfast._max_words(pt) + 1
        payload = hdr.tobytes() + payload[12:] + b"\0" * (2 * int(hdr[0]))
        match = "truncated stream"
    with pytest.raises(ValueError, match=match):
        tfast.decode_block_fast(payload, n, pt, "cpu")
    if n == data.size:  # the JAX package raises the same text
        pj, _ = params("small")
        with pytest.raises(ValueError, match=match):
            jfast.decode_block_fast(payload, n, pj)


def test_corrupt_stream_fails_the_drain_crc_or_executor():
    pt, data, payload = _payload()
    off = 12 + 2 * tfast.W_SYM + 4 * pt.lanes
    hdr = np.frombuffer(payload[:12], "<u4").copy()
    hdr[2] ^= 1  # the stored CRC: everything decodes, the bytes "differ"
    with pytest.raises(ValueError, match="content CRC mismatch"):
        tfast.decode_block_fast(hdr.tobytes() + payload[12:], data.size, pt, "cpu")
    mut = bytearray(payload)
    mut[off - 1] ^= 0x40  # a final state: the scan does not drain
    with pytest.raises(ValueError, match="states drained=False"):
        tfast.decode_block_fast(bytes(mut), data.size, pt, "cpu")
    hdr = np.frombuffer(payload[:12], "<u4").copy()
    hdr[1] -= 1  # one token fewer: words are left over or bytes are missing
    with pytest.raises(ValueError, match="corrupt block"):
        tfast.decode_block_fast(hdr.tobytes() + payload[12:], data.size, pt, "cpu")


def test_fuzzed_payload_fails_clean():
    """tests/test_fast.py's rule: a flipped bit raises ValueError or leaves
    the bytes right; the port and JAX agree on which."""
    pt, data, payload = _payload()
    pj, _ = params("small")
    rng = np.random.default_rng(9)
    raised = 0
    for _ in range(12):
        mut = bytearray(payload)
        mut[int(rng.integers(0, len(mut)))] ^= 1 << int(rng.integers(0, 8))
        try:
            out = tfast.decode_block_fast(bytes(mut), data.size, pt, "cpu")
        except ValueError as e:
            raised += 1
            with pytest.raises(ValueError) as ref:
                jfast.decode_block_fast(bytes(mut), data.size, pj)
            assert str(ref.value) == str(e)
            continue
        assert out.tobytes() == data.tobytes()
    assert raised


def _random_plane(rng, n_tok):
    """A valid token plane (every source inside the output so far) and the
    number of bytes it writes at min_len 6."""
    tok, size = [], 0
    for _ in range(n_tok):
        if size and rng.random() < 0.3:
            v = int(rng.integers(0, 20))
            tok.append((int(rng.integers(1, min(size, 40) + 1)) << 8) | v)
            size += v + 6
        else:
            tok.append(int(rng.integers(0, 256)))
            size += 1
    return np.array(tok, np.uint32), size


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f2_execute_native_and_python_agree(seed):
    """The C walk and the pure-Python walk write the same bytes and fail
    clean (None) on the same streams: source underrun, output overrun, a
    wrong total."""
    if native.get_lib() is None:
        pytest.skip("no C compiler: only the Python walk exists here")
    rng = np.random.default_rng(seed)
    tok, size = _random_plane(rng, 400)
    cases = [(tok, size), (tok, size - 1), (tok, size + 1),
             (np.concatenate([np.array([(5 << 8) | 1], np.uint32), tok]), size + 7)]
    for t, n in cases:
        t = np.ascontiguousarray(t)
        a, b = native.f2_execute(t, 6, n), native._f2_execute_python(t, 6, n)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert native.f2_execute(np.ascontiguousarray(tok), 6, size) is not None
    # an overlapping copy replicates: dist 1, len 6 + 3 after one literal
    rep = native.f2_execute(np.array([66, (1 << 8) | 3], np.uint32), 6, 10)
    assert rep.tobytes() == b"B" * 10


def test_python_walk_is_what_a_machine_without_cc_runs(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    pt, data, payload = _payload(seed=6)
    np.testing.assert_array_equal(
        tfast.decode_block_fast(payload, data.size, pt, "cpu"), data)


@pytest.mark.parametrize("env,match", [
    ({"CPX_F_FINDER": "chain"}, "CPX_F_FINDER='chain'"),
    ({"CPX_F_ENC_WIN": "128"}, "CPX_F_ENC_WIN"),
    ({"CPX_F_CANDS": "0"}, "CPX_F_CANDS"),
    ({"CPX_F_CANDS": "9"}, "CPX_F_CANDS"),
    ({"CPX_F_EXTW": "1"}, "CPX_F_EXTW"),
    ({"CPX_F_PARSE_LIT": "-1"}, "CPX_F_PARSE"),
    ({"CPX_F_PARSE_K": "99999999"}, "CPX_F_PARSE"),
])
def test_rejected_knobs_raise_in_a_fresh_interpreter(env, match):
    code = (
        "import numpy as np\n"
        "from comprox_tpu_torch.codec import fast, block\n"
        "p = block.BlockParams(lanes=8, steps=64, mode='F', min_len=6, window=32)\n"
        "try:\n"
        "    fast.encode_block_fast(np.zeros(100, np.uint8), p, 'cpu')\n"
        "except NotImplementedError as e:\n"
        "    print('refused:', e)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1", **env))
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("refused:") and match in r.stdout, r.stdout


def test_mode_and_codec_mismatch_raise():
    _, pt = params("small")
    with pytest.raises(ValueError, match="mode F"):
        tfast.encode_block_fast(np.zeros(10, np.uint8),
                                blk.BlockParams(lanes=8, steps=64, mode="R"), "cpu")
    with pytest.raises(ValueError, match="block of 0 bytes"):
        tfast.encode_block_fast(np.zeros(0, np.uint8), pt, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tfast.f2_find(pt, torch.zeros((8, 512), dtype=torch.uint8, device="meta"), 1)
