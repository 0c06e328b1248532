"""The port's mode-X block codec (the ``crx`` LZ77 codec) against the JAX
package, pass by pass and as a whole.

Each kernel-holding pass runs in its plain PyTorch version here (CPU
tensors) and is held to the JAX function on the same seeded input, at
S=8/T=64 (window 32) and S=512/T=32.  Tolerance 0 everywhere: every grid,
every table, every byte must be equal.

- K4x (content-keyed sort finder) vs ``sort_candidates(n_cands=3,
  probe_from=16)``, lengths and sources at every position;
- K11 (repeat-distance pass) vs ``_sim_prev_dist`` and ``_rep_lengths``, on
  the first parse's decisions and on random decisions;
- K6's X entry vs the reversed scan of ``_parse_body``, without and with the
  repeat pair, on the finder's and on random candidates;
- the greedy choice vs ``_greedy_decisions``;
- K12e (modeling scan) vs the event grids and tables of ``_encode_passes``,
  fed the JAX decisions; one step from a JAX mid-block state;
- K3 at five slots vs the states, emission mask and words;
- K12d (decode scan) on JAX payloads: bytes, states, words used, tables;
- ``encode_block`` / ``decode_block`` vs the JAX payload, both ways.

The CUDA kernels are held to these plain versions by test_torch_kernels.py,
on a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu.codec import block as jblk
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.models import ppm

from test_block import corpus

torch.set_num_threads(1)

SMALL = dict(lanes=8, steps=64, mode="X", min_len=6, window=32, o3_bits=14,
             rolz_bits=10, rolz_depth=16)
WIDE = dict(SMALL, lanes=512, steps=32, window=250, rolz_ctx_bytes=4)
GEO = {"small": SMALL, "wide": WIDE}
# (content, geometry, bytes short of the capacity)
CASES = [("text", "small", 0), ("zeros", "small", 0), ("period7", "small", 3),
         ("random", "small", 0), ("lowentropy", "small", 37),
         ("text", "small", 505), ("text", "small", 510), ("text", "small", 511),
         ("text", "wide", 100), ("period7", "wide", 0), ("lowentropy", "wide", 7)]
PRICES = (jblk._P_LIT_X, jblk._P_XM, jblk._P_XK, jblk._P_XREP)


def params(geo, **kw):
    kw = dict(GEO[geo] if isinstance(geo, str) else geo, **kw)
    return jblk.BlockParams(**kw), blk.BlockParams(**kw)


def block_buf(name, p, short, seed=1):
    n = p.capacity - short
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    buf.reshape(-1)[:n] = corpus(name, n, seed=seed)
    return buf, n


def grid(p, v):
    """A JAX [N] position-order array as a [T, S] numpy grid."""
    return np.asarray(v).reshape(p.lanes, p.steps).T


def jax_cands(pj, buf, n, n_cands=3, probe_from=16):
    """[2 * n_cands, T, S] (len, src) grids of the JAX finder."""
    out = jblk.sort_candidates(pj, jnp.asarray(buf.reshape(-1)), jnp.int32(n),
                               n_cands=n_cands, probe_from=probe_from)
    return np.stack([grid(pj, g) for pair in out for g in pair]).astype(np.int32)


@functools.partial(jax.jit, static_argnums=(0, 3))
def jax_parse(p, n, xs, n_c=3):
    ts = jnp.arange(p.steps, dtype=jnp.int32)
    cw0 = jnp.zeros((p.lanes, p.window), jnp.int32)
    body = functools.partial(jblk._parse_body, p, n, n_c=n_c)
    _, (take, src, _) = jax.lax.scan(body, cw0, (ts,) + tuple(xs), reverse=True)
    return take, src


def jax_rep(pj, buf, n, take, src):
    ts = jnp.arange(pj.steps, dtype=jnp.int32)
    prev = jblk._sim_prev_dist(pj, ts, jnp.asarray(take), jnp.asarray(src))
    lrep = jblk._rep_lengths(pj, jnp.asarray(buf.reshape(-1)), jnp.int32(n), ts, prev)
    return np.stack([np.asarray(lrep), np.asarray(prev)]).astype(np.int32)


@functools.partial(jax.jit, static_argnums=0)
def jax_decisions(p, inp, n):
    inp_flat = inp.reshape(-1)
    inp_pad = jnp.pad(inp, ((0, 0), (0, p.window + 1)))
    return jblk._search_and_parse(p, inp_pad, inp_flat,
                                  jblk._pack_words(inp_flat), n)


# ---------------------------------------------------------------- K4x ------


@pytest.mark.parametrize("name,geo,short", CASES)
def test_sort_candidates_content_equals_jax(name, geo, short):
    """Tolerance 0, lengths and sources at every position (a source is
    passed through by the parse even where the length is 0)."""
    pj, pt = params(geo)
    buf, n = block_buf(name, pj, short)
    got = blk.sort_candidates(pt, torch.from_numpy(buf), n, content=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_cands(pj, buf, n))
    if name not in ("random",) and n > 64:
        assert (got[0] >= pt.min_len).any(), "the case must find matches"


@pytest.mark.parametrize("n_cands,probe", [(2, 4), (3, 0), (5, 3), (7, 64)])
def test_sort_candidates_content_other_knobs(monkeypatch, n_cands, probe):
    """CPX_X_CANDS / CPX_X_PROBE are read at call time; a chain no longer
    than n_cands is taken whole, without the probe (tolerance 0)."""
    monkeypatch.setenv("CPX_X_CANDS", str(n_cands))
    monkeypatch.setenv("CPX_X_PROBE", str(probe))
    pj, pt = params("small")
    buf, n = block_buf("text", pj, 5, seed=3)
    got = blk.sort_candidates(pt, torch.from_numpy(buf), n, content=True)
    np.testing.assert_array_equal(
        got.numpy(), jax_cands(pj, buf, n, n_cands, probe))


def test_sort_keys_content_equal_jax_hash():
    pj, pt = params("small")
    buf, n = block_buf("text", pj, 9)
    keys = blk.sort_keys_plain(pt, blk.pad_block(pt, torch.from_numpy(buf)), n, True)
    b = np.concatenate([buf.reshape(-1), np.zeros(8, np.uint8)]).astype(np.uint32)
    big = pt.capacity
    w = b[:big] | (b[1:big + 1] << 8) | (b[2:big + 2] << 16) | (b[3:big + 3] << 24)
    w45 = b[4:big + 4] | (b[5:big + 5] << 8)
    ref = (w * np.uint32(0x9E3779B1)) ^ (w45 * np.uint32(0x85EBCA77))
    ref = np.where(np.arange(big) < n, ref, np.uint32(0xFFFFFFFF))
    np.testing.assert_array_equal(keys.numpy(), ref.astype(np.int64))


# ---------------------------------------------------------------- K11 ------


@pytest.mark.parametrize("name,geo,short", CASES)
def test_rep_scan_equals_jax_on_first_parse(name, geo, short):
    pj, pt = params(geo)
    buf, n = block_buf(name, pj, short)
    c = jax_cands(pj, buf, n)
    take, src = jax_parse(pj, jnp.int32(n), tuple(jnp.asarray(g) for g in c))
    dec = torch.from_numpy(np.stack([np.asarray(take), np.asarray(src)]))
    got = blk.rep_scan(pt, torch.from_numpy(buf), n, dec)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), jax_rep(pj, buf, n, np.asarray(take), np.asarray(src)))


@pytest.mark.parametrize("geo", ["small", "wide"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rep_scan_equals_jax_on_random_decisions(geo, seed):
    """Decisions no parse would make: sources after the position (distance
    clamps to 1), distances beyond the lane's own steps and beyond the
    block's start (a negative source), overlapping takes — on bytes with
    long equal runs (tolerance 0)."""
    pj, pt = params(geo)
    rng = np.random.default_rng(seed)
    buf, n = block_buf(("lowentropy", "zeros", "period7")[seed], pj, 5 * seed)
    shape = (pj.steps, pj.lanes)
    take = rng.integers(1, 12, shape).astype(np.int32)
    take[rng.random(shape) < 0.7] = 0
    pos = (np.arange(pj.lanes)[None, :] * pj.steps + np.arange(pj.steps)[:, None])
    src = (pos - rng.integers(-3, 3 * pj.steps, shape)).astype(np.int32)
    got = blk.rep_scan(pt, torch.from_numpy(buf), n,
                       torch.from_numpy(np.stack([take, src])))
    ref = jax_rep(pj, buf, n, take, src)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[1] > pj.steps).any()
    if seed < 2:  # a period-7 run seldom meets a random distance
        assert (ref[0] > 0).any()


# ------------------------------------------------------------- K6 (X) ------


@pytest.mark.parametrize("with_rep", [False, True])
@pytest.mark.parametrize("name,geo,short", CASES)
def test_parse_scan_x_equals_jax(name, geo, short, with_rep):
    pj, pt = params(geo)
    buf, n = block_buf(name, pj, short)
    c = jax_cands(pj, buf, n)
    xs = tuple(jnp.asarray(g) for g in c)
    take, src = jax_parse(pj, jnp.int32(n), xs)
    rep = None
    if with_rep:
        rep = jax_rep(pj, buf, n, np.asarray(take), np.asarray(src))
        take, src = jax_parse(pj, jnp.int32(n), xs + tuple(jnp.asarray(g) for g in rep))
        rep = torch.from_numpy(rep)
    got = blk.parse_scan(pt, n, torch.from_numpy(c), PRICES, 3, rep)
    assert got.dtype == torch.int32 and got.shape[0] == 3
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(take))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(src))
    assert not got[2].any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_parse_x_tie_rules_on_random_candidates(seed):
    """Dense random candidates and repeat pairs: equal lengths and prices,
    candidates at the repeat distance, a repeat candidate of length 0 with
    a negative source, previous distances beyond the position."""
    pj, pt = params("small")
    rng = np.random.default_rng(seed)
    shape = (pt.steps, pt.lanes)
    pos = (np.arange(pt.lanes)[None, :] * pt.steps + np.arange(pt.steps)[:, None])
    g = np.zeros((6, *shape), np.int32)
    for k in range(3):
        g[2 * k] = rng.integers(0, pt.window + 3, shape)
        g[2 * k][rng.random(shape) < 0.4] = 0
        g[2 * k + 1] = pos - rng.integers(-1, 700, shape)
    rep = np.stack([rng.integers(0, pt.window + 1, shape),
                    rng.integers(1, 700, shape)]).astype(np.int32)
    rep[0][rng.random(shape) < 0.5] = 0
    same = rng.random(shape) < 0.3  # a normal candidate at the repeat distance
    g[1] = np.where(same, pos - rep[1], g[1])
    if seed % 2:
        g[2], g[4] = g[0], g[0]
    n = pt.capacity - 3 * seed
    xs = tuple(jnp.asarray(x) for x in g) + tuple(jnp.asarray(x) for x in rep)
    take, src = jax_parse(pj, jnp.int32(n), xs)
    got = blk.parse_scan(pt, n, torch.from_numpy(g), PRICES, 3, torch.from_numpy(rep))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(take))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(src))


@pytest.mark.parametrize("name,geo,short", CASES)
def test_greedy_decisions_x_equal_jax(name, geo, short):
    pj, pt = params(geo, flexible=False)
    buf, n = block_buf(name, pj, short)
    c = jax_cands(pj, buf, n)
    jt, js = jblk._greedy_decisions(pj, n, tuple(jnp.asarray(g) for g in c))
    take, src = blk._greedy_decisions_dist(pt, torch.from_numpy(c))
    np.testing.assert_array_equal(take.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(src.numpy(), np.asarray(js))


# ------------------------------------------------- K12e, K3, K12d, block ---


def check_block(name, geo, short, flexible=True, seed=1):
    """The decisions, K12e, K3 (five slots), the payload and K12d of the
    port against JAX on one block (tolerance 0)."""
    pj, pt = params(geo, flexible=flexible)
    buf, n = block_buf(name, pj, short, seed)
    data = buf.reshape(-1)[:n].copy()
    inp_j, inp_t = jnp.asarray(buf), torch.from_numpy(buf)

    _, jtake, jsrc = jax_decisions(pj, inp_j, jnp.int32(n))
    dec = torch.from_numpy(np.stack([np.asarray(jtake), np.asarray(jsrc)]).astype(np.int32))

    # K12e on the JAX decisions
    x_j, emit_j, words_j, ev_j, tables_j = jblk._encode_passes(pj, inp_j, jnp.int32(n))
    tables = ppm.init_tables(True, pt.o3_bits, "cpu")
    ev = blk.model_scan(pt, inp_t, n, dec, tables)
    ev_ref = np.stack([np.asarray(g).astype(np.int32) for g in ev_j[:15]], axis=1)
    assert ev.shape == (pt.steps, 15, pt.lanes)
    np.testing.assert_array_equal(ev.numpy(), ev_ref)
    for k, v in ppm.tables_to_numpy(tables).items():
        np.testing.assert_array_equal(v, np.asarray(tables_j[k]), err_msg=k)

    # K3 at five slots on the JAX event grids
    x, emit, words = blk.rans_scan(pt, torch.from_numpy(ev_ref))
    emit_ref = np.unpackbits(np.asarray(emit_j), axis=-1, bitorder="little")
    assert emit.shape == (pt.steps, 5, pt.lanes)
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_j).astype(np.int64))
    np.testing.assert_array_equal(emit.numpy(), emit_ref.astype(bool))
    np.testing.assert_array_equal(words.numpy(), np.asarray(words_j).astype(np.int32))
    payload_j = jblk._pack_payload(x_j, emit_j, words_j)
    assert blk._pack_payload(x, blk.pack_emit(pt, emit), words) == payload_j
    assert blk.encode_block(data, pt, "cpu") == payload_j

    # K12d on the JAX payload
    n_words, states, stream = blk._unpack_payload(payload_j, pt)
    assert pt.stream_pad == pt.capacity // 2 + 16 + 5 * pt.lanes  # five slots
    assert stream.size in (pt.stream_pad, pt.stream_pad_max)
    xj, basej, outj, tabj = jblk._decode_scan(
        pj, jnp.asarray(states), jnp.asarray(stream), jnp.int32(n))
    tables = ppm.init_tables(True, pt.o3_bits, "cpu")
    xd, used, out = blk.decode_scan(
        pt, torch.from_numpy(states.astype(np.int64)),
        torch.from_numpy(stream.astype(np.int32)), n, tables)
    np.testing.assert_array_equal(out.numpy().reshape(-1)[:n], data)
    np.testing.assert_array_equal(out.numpy(), np.asarray(outj))
    np.testing.assert_array_equal(xd.numpy(), np.asarray(xj).astype(np.int64))
    assert used == int(basej) == n_words
    for k, v in ppm.tables_to_numpy(tables).items():
        np.testing.assert_array_equal(v, np.asarray(tabj[k]), err_msg=k)
    np.testing.assert_array_equal(blk.decode_block(payload_j, n, pt, "cpu"), data)
    np.testing.assert_array_equal(jblk.decode_block(payload_j, n, pj), data)
    return jtake


@pytest.mark.parametrize("name,geo,short", CASES)
def test_passes_flexible(name, geo, short):
    take = check_block(name, geo, short)
    if name != "random" and short < 500:
        assert (np.asarray(take) > 0).any(), "the case must code matches"


@pytest.mark.parametrize(
    "name,geo,short",
    [("text", "small", 0), ("zeros", "small", 0), ("period7", "small", 3),
     ("lowentropy", "small", 37), ("text", "small", 510), ("text", "wide", 100)])
def test_passes_greedy(name, geo, short):
    check_block(name, geo, short, flexible=False)


def test_flexible_decisions_equal_jax():
    """K4x -> K6 -> K11 -> K6 chained in the port against
    ``_search_and_parse``; the second parse must use the repeat candidate."""
    pj, pt = params("wide")
    buf, n = block_buf("text", pj, 9, seed=9)
    inp = torch.from_numpy(buf)
    cands = blk.sort_candidates(pt, inp, n, content=True)
    first = blk.parse_scan(pt, n, cands, blk.x_prices(), 3)
    rep = blk.rep_scan(pt, inp, n, first)
    dec = blk.parse_scan(pt, n, cands, blk.x_prices(), 3, rep)
    _, take, src = jax_decisions(pj, jnp.asarray(buf), jnp.int32(n))
    np.testing.assert_array_equal(dec[0].numpy(), np.asarray(take))
    np.testing.assert_array_equal(dec[1].numpy(), np.asarray(src))
    assert int((dec[0] > 0).sum()) > 100
    assert not torch.equal(first[:2], dec[:2]), "the repeat pair must matter"


def test_match_layer_off_roundtrip():
    pj, pt = params("small", match=False)
    data = corpus("text", 300, seed=4)
    payload = jblk.encode_block(data, pj)
    assert blk.encode_block(data, pt, "cpu") == payload
    np.testing.assert_array_equal(blk.decode_block(payload, data.size, pt, "cpu"), data)


def test_model_step_from_jax_mid_block_state():
    """Run K steps of the JAX modeling scan, carry its tables and registers
    across (``tables_from_numpy``), run step K on both sides: the events and
    every table (``dst``, ``mant``, ``sse_x`` included) must be equal."""
    pj, pt = params("small")
    buf, n = block_buf("text", pj, 0, seed=6)
    inp_j = jnp.asarray(buf)
    ts, take, src = jax_decisions(pj, inp_j, jnp.int32(n))
    inp_flat = inp_j.reshape(-1)
    inp_pad = jnp.pad(inp_j, ((0, 0), (0, pj.window + 1)))
    body = functools.partial(jblk._encode_model_body, pj, inp_pad, inp_flat,
                             jblk._pack_words(inp_flat), jnp.int32(n))
    k = 40
    c, _ = jax.lax.scan(body, jblk._init_carry(pj, enc_side=True),
                        (ts[:k], take[:k], src[:k]))
    assert int(np.asarray(c["tables"]["mant"]).sum()) > 256, "mant must have moved"
    c2, out = body(c, (ts[k], take[k], src[k]))
    carry = {key: torch.from_numpy(np.asarray(c[key]).astype(np.int64))
             for key in ("ctx4", "ctx4b", "copy_rem", "copy_src", "prev_dist")}
    tables = ppm.tables_from_numpy(
        {key: np.asarray(v) for key, v in c["tables"].items()}, "cpu")
    dec_t = torch.from_numpy(np.stack([np.asarray(take[k]), np.asarray(src[k])]))
    ev = blk._model_step(pt, torch.from_numpy(buf), n, carry, tables, k, dec_t)
    ref = np.stack([np.asarray(g).astype(np.int32) for g in out[:15]])
    np.testing.assert_array_equal(ev.numpy(), ref)
    for key, v in ppm.tables_to_numpy(tables).items():
        np.testing.assert_array_equal(v, np.asarray(c2["tables"][key]), err_msg=key)
    for key, v in carry.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(c2[key]).astype(np.int64))


def test_flipped_payload_bit_fails_drain():
    pj, pt = params("small")
    data = corpus("text", 512, seed=6)
    payload = bytearray(jblk.encode_block(data, pj))
    payload[4 + 4 * pt.lanes + 10] ^= 0x10
    with pytest.raises(ValueError, match="corrupt block"):
        blk.decode_block(bytes(payload), data.size, pt, "cpu")


def test_decodes_garbage_like_jax():
    """A random stream: the masked lanes' garbage (distance buckets past 24,
    sources before the block) must leave both decoders in the same state."""
    pj, pt = params("small")
    rng = np.random.default_rng(0)
    n = pt.capacity
    states = rng.integers(1 << 16, 1 << 32, pt.lanes, dtype=np.int64)
    stream = rng.integers(0, 1 << 16, pt.stream_pad, dtype=np.int64)
    xj, basej, outj, tabj = jblk._decode_scan(
        pj, jnp.asarray(states.astype(np.uint32)),
        jnp.asarray(stream.astype(np.uint16)), jnp.int32(n))
    tables = ppm.init_tables(True, pt.o3_bits, "cpu")
    xd, used, out = blk.decode_scan(
        pt, torch.from_numpy(states), torch.from_numpy(stream.astype(np.int32)),
        n, tables)
    np.testing.assert_array_equal(out.numpy(), np.asarray(outj))
    np.testing.assert_array_equal(xd.numpy(), np.asarray(xj).astype(np.int64))
    assert used == int(basej)
    for k, v in ppm.tables_to_numpy(tables).items():
        np.testing.assert_array_equal(v, np.asarray(tabj[k]), err_msg=k)


# ------------------------------------------------------------- knobs -------


def test_encode_at_other_finder_knobs(monkeypatch):
    """CPX_X_CANDS=2, CPX_X_PROBE=4 (read at call time in both packages), on
    a geometry no other test has traced under jit: the JAX payload."""
    monkeypatch.setenv("CPX_X_CANDS", "2")
    monkeypatch.setenv("CPX_X_PROBE", "4")
    pj, pt = params("small", o3_bits=12)
    data = corpus("text", pj.capacity, seed=10)
    payload = jblk.encode_block(data, pj)
    assert blk.encode_block(data, pt, "cpu") == payload
    monkeypatch.undo()
    assert blk.encode_block(data, pt, "cpu") != payload, "the knobs must matter"
    np.testing.assert_array_equal(blk.decode_block(payload, data.size, pt, "cpu"), data)


def test_encode_at_other_prices(monkeypatch):
    """CPX_PARSE_LIT_X/XM/XK/XREP bind at import in both packages: both
    module values are set, on a geometry no other test has traced."""
    for name, value in (("_P_LIT_X", 14), ("_P_XM", 40), ("_P_XK", 3), ("_P_XREP", 20)):
        monkeypatch.setattr(jblk, name, value)
        monkeypatch.setattr(blk, name, value)
    pj, pt = params("small", o3_bits=11)
    data = corpus("text", pj.capacity, seed=11)
    payload = jblk.encode_block(data, pj)
    assert blk.encode_block(data, pt, "cpu") == payload
    monkeypatch.undo()
    assert blk.encode_block(data, pt, "cpu") != payload, "the prices must matter"


@pytest.mark.parametrize(
    "env,value,match",
    [("CPX_X_CTXCAND", "1", "item 17"), ("CPX_X_CANDS", "0", "CPX_X_CANDS"),
     ("CPX_X_CANDS", "8", "CPX_X_CANDS"), ("CPX_X_PROBE", "65", "CPX_X_PROBE"),
     ("CPX_X_PROBE", "-1", "CPX_X_PROBE")])
def test_unported_x_env_raises(monkeypatch, env, value, match):
    monkeypatch.setenv(env, value)
    with pytest.raises(NotImplementedError, match=match):
        blk.encode_block(corpus("text", 100), blk.BlockParams(**SMALL), "cpu")


def test_x_finder_scan_raises_naming_its_item(monkeypatch):
    """The scan finder is ported (test_torch_xscan.py holds it to JAX): it
    encodes, and only a finder that does not exist raises, naming the knob."""
    data = corpus("text", 100)
    monkeypatch.setitem(blk._ENV, "CPX_X_FINDER", "scan")
    payload = blk.encode_block(data, blk.BlockParams(**SMALL), "cpu")
    np.testing.assert_array_equal(
        blk.decode_block(payload, data.size, blk.BlockParams(**SMALL), "cpu"), data)
    monkeypatch.setitem(blk._ENV, "CPX_X_FINDER", "chain")
    with pytest.raises(NotImplementedError, match="CPX_X_FINDER.*'sort' or 'scan'"):
        blk.encode_block(data, blk.BlockParams(**SMALL), "cpu")


def test_sse_x_off_raises_in_mode_x_only(monkeypatch):
    monkeypatch.setattr(ppm, "SSE_X", 0)
    with pytest.raises(NotImplementedError, match="CPX_SSE_X"):
        blk.decode_block(b"", 1, blk.BlockParams(**SMALL), "cpu")
    blk.check_supported(blk.BlockParams(**dict(SMALL, mode="R", min_len=5)))


@pytest.mark.parametrize("name,value", [("_P_XM", -1), ("_P_XK", 1 << 20)])
def test_x_prices_out_of_range_raise(monkeypatch, name, value):
    monkeypatch.setattr(blk, name, value)
    with pytest.raises(NotImplementedError, match="CPX_PARSE"):
        blk.encode_block(corpus("text", 100), blk.BlockParams(**SMALL), "cpu")


def test_mode_x_block_is_capped_at_16_mib():
    with pytest.raises(ValueError, match="16 MiB"):
        blk.BlockParams(lanes=512, steps=(1 << 15) + 8, mode="X")


def test_decode_scan_checks_the_bucket_table_argument():
    pt = blk.BlockParams(**SMALL)
    st = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="bucket table"):
        blk.decode_scan(pt, st, torch.zeros(64, dtype=torch.int32), 1,
                        ppm.init_tables(True, 14, "cpu"), blk._init_rolz(pt, "cpu"))
