"""The port's mode-R block codec against the JAX package, pass by pass.

Each kernel-holding pass runs in its plain PyTorch version here (CPU
tensors) and is held to the JAX pass on the same input, exactly:

- KS (search scan) + greedy parse vs ``_search_body``'s scan and
  ``_search_and_parse`` with ``flexible=False``;
- K2 (modeling scan) vs the event grids of ``_encode_passes``, fed the
  JAX parse decisions;
- K3 (backward rANS scan) vs the states, emission mask and words of
  ``_encode_passes``, fed the JAX event grids; the payload vs
  ``encode_block``;
- K1 (decode scan) decodes JAX payloads, and its final tables equal the
  JAX decoder's;
- the flexible parse as a whole (K4, K5, K6, then K2 and K3; each pass has
  its own file: test_torch_sortfind.py, test_torch_rank.py,
  test_torch_parse.py): ``encode_block(flexible=True)`` vs the JAX payload,
  at the default encoder knobs and at ``CPX_R_PROBE=32``.

The CUDA kernels themselves are held to these plain versions by
test_torch_kernels.py, on a card.
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

# the plain versions run many tiny ops: more intra-op threads would only
# contend with the other test workers
torch.set_num_threads(1)

SMALL = dict(lanes=8, steps=64, mode="R", min_len=5, window=32, o3_bits=14,
             rolz_bits=10, rolz_depth=16, flexible=False)
# the main path's ROLZ knobs (4 context bytes, insert decimation 2) at
# S=512 with small tables
WIDE = dict(SMALL, lanes=512, steps=32, rolz_ctx_bytes=4, rolz_dec=2)


def params(**kw):
    return jblk.BlockParams(**kw), blk.BlockParams(**kw)


@functools.partial(jax.jit, static_argnums=0)
def _jax_search(p, inp, n):
    """The JAX search scan: raw grids and the final bucket table."""
    inp_w32 = jblk._pack_words(inp.reshape(-1))
    inp_pad = jnp.pad(inp, ((0, 0), (0, p.window + 1)))
    body = functools.partial(jblk._search_body, p, inp_pad, inp_w32, n)
    c, outs = jax.lax.scan(
        body, jblk._init_carry(p, enc_side=True, search=True),
        jnp.arange(p.steps, dtype=jnp.int32),
    )
    return outs, c["rolz_ent"]


@functools.partial(jax.jit, static_argnums=0)
def _jax_search_and_parse(p, inp, n):
    inp_flat = inp.reshape(-1)
    inp_pad = jnp.pad(inp, ((0, 0), (0, p.window + 1)))
    return jblk._search_and_parse(p, inp_pad, inp_flat,
                                  jblk._pack_words(inp_flat), n)


def block_buf(data, p):
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    buf.reshape(-1)[: data.size] = data
    return buf


def check_block(data, kw, parse=False):
    """Every pass of the port against JAX on one block; returns the JAX
    payload."""
    pj, pt = params(**kw)
    n = int(data.size)
    buf = block_buf(data, pj)
    inp_j, inp_t = jnp.asarray(buf), torch.from_numpy(buf)

    # KS + greedy parse
    outs, rolz_j = _jax_search(pj, inp_j, jnp.int32(n))
    rolz_t = blk._init_rolz(pt, "cpu")
    grids = blk.search_scan(pt, inp_t, n, rolz_t)
    np.testing.assert_array_equal(grids.numpy(), np.stack([np.asarray(o) for o in outs]))
    np.testing.assert_array_equal(blk.rolz_to_numpy(rolz_t), np.asarray(rolz_j))
    take, src = blk._greedy_decisions(pt, grids[0], grids[1])
    jtake, jsrc = jblk._greedy_decisions(pj, n, outs)
    np.testing.assert_array_equal(take.numpy(), np.asarray(jtake))
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    if parse:
        _, ptake, psrc, pidx, pfill = _jax_search_and_parse(pj, inp_j, jnp.int32(n))
        for a, b in ((take, ptake), (src, psrc), (grids[2], pidx), (grids[3], pfill)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    # K2 on the JAX decisions
    x_j, emit_j, words_j, ev_j, tables_j = jblk._encode_passes(pj, inp_j, jnp.int32(n))
    dec = torch.from_numpy(np.stack(
        [np.asarray(jtake), np.asarray(jsrc), np.asarray(outs[2]),
         np.asarray(outs[3])]).astype(np.int32))
    tables = ppm.init_tables(True, pt.o3_bits, "cpu")
    ev = blk.model_scan(pt, inp_t, n, dec, tables)
    ev_ref = np.stack([np.asarray(g).astype(np.int32) for g in ev_j[:9]], axis=1)
    np.testing.assert_array_equal(ev.numpy(), ev_ref)
    tj = {k: np.asarray(v) for k, v in tables_j.items()}
    for k, v in ppm.tables_to_numpy(tables).items():
        np.testing.assert_array_equal(v, tj[k], err_msg=k)

    # K3 on the JAX event grids
    x, emit, words = blk.rans_scan(pt, torch.from_numpy(ev_ref))
    emit_ref = np.unpackbits(np.asarray(emit_j), axis=-1, bitorder="little")
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_j).astype(np.int64))
    np.testing.assert_array_equal(emit.numpy(), emit_ref.astype(bool))
    np.testing.assert_array_equal(words.numpy(), np.asarray(words_j).astype(np.int32))
    payload_j = jblk._pack_payload(x_j, emit_j, words_j)
    assert blk._pack_payload(x, blk.pack_emit(pt, emit), words) == payload_j
    assert blk.encode_block(data, pt, "cpu") == payload_j

    # K1 on the JAX payload
    n_words, states, stream = blk._unpack_payload(payload_j, pt)
    xj, basej, outj, tabj = jblk._decode_scan(
        pj, jnp.asarray(states), jnp.asarray(stream), jnp.int32(n))
    tables = ppm.init_tables(True, pt.o3_bits, "cpu")
    rolz_d = blk._init_rolz(pt, "cpu")
    xd, used, out = blk.decode_scan(
        pt, torch.from_numpy(states.astype(np.int64)),
        torch.from_numpy(stream.astype(np.int32)), n, tables, rolz_d)
    np.testing.assert_array_equal(out.numpy().reshape(-1)[:n], data)
    np.testing.assert_array_equal(out.numpy(), np.asarray(outj))
    np.testing.assert_array_equal(xd.numpy(), np.asarray(xj).astype(np.int64))
    assert used == int(basej) == n_words
    for k, v in ppm.tables_to_numpy(tables).items():
        np.testing.assert_array_equal(v, np.asarray(tabj[k]), err_msg=k)
    # the decoder replays the search pass's bucket evolution
    np.testing.assert_array_equal(blk.rolz_to_numpy(rolz_d), np.asarray(rolz_j))
    return payload_j


@pytest.mark.parametrize(
    "name", ["text", "random", "zeros", "period7", "lowentropy"]
)
def test_passes_full_block(name):
    check_block(corpus(name, 512, seed=1), SMALL, parse=name == "text")


@pytest.mark.parametrize("n", [1, 7, 65, 511])
def test_passes_partial_block(n):
    check_block(corpus("text", n, seed=2), SMALL)


def test_passes_512_lanes():
    pj, _ = params(**WIDE)
    check_block(corpus("text", pj.capacity - 100, seed=3), WIDE, parse=True)


def test_match_layer_off_roundtrip():
    kw = dict(SMALL, match=False)
    pj, pt = params(**kw)
    data = corpus("text", 300, seed=4)
    payload = jblk.encode_block(data, pj)
    assert blk.encode_block(data, pt, "cpu") == payload
    np.testing.assert_array_equal(blk.decode_block(payload, data.size, pt, "cpu"), data)


def test_decodes_flexible_parse_payload():
    """Decode does not depend on the parse: the port decodes archives the
    JAX package wrote with its default (flexible) parse."""
    kw = dict(SMALL, flexible=True)
    pj, pt = params(**kw)
    data = corpus("text", 512, seed=5)
    payload = jblk.encode_block(data, pj)
    np.testing.assert_array_equal(blk.decode_block(payload, data.size, pt, "cpu"), data)


def test_flipped_payload_bit_fails_drain():
    pj, pt = params(**SMALL)
    data = corpus("text", 512, seed=6)
    payload = bytearray(check_block_payload(data, pj))
    payload[4 + 4 * pt.lanes + 10] ^= 0x10  # a bit of the word stream
    with pytest.raises(ValueError, match="corrupt block"):
        blk.decode_block(bytes(payload), data.size, pt, "cpu")


def check_block_payload(data, pj):
    x, emit, words, _, _ = jblk._encode_passes(
        pj, jnp.asarray(block_buf(data, pj)), jnp.int32(data.size))
    return jblk._pack_payload(x, emit, words)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rolz_helpers(seed):
    rng = np.random.default_rng(seed)
    s, d = 32, 16
    key = rng.integers(0, 1 << 32, s, dtype=np.int64)
    for bits in (10, 18):
        np.testing.assert_array_equal(
            blk.rolz_hash3(torch.from_numpy(key), bits).numpy(),
            np.asarray(jblk.rolz_hash3(jnp.asarray(key.astype(np.uint32)), bits)),
        )
    pos = rng.integers(0, 40, (s, d)).astype(np.int32)
    pos[rng.random((s, d)) < 0.3] = 0  # empties tie on position 0
    np.testing.assert_array_equal(
        blk._recency_ranks(torch.from_numpy(pos)).numpy(),
        np.asarray(jblk._recency_ranks(jnp.asarray(pos))),
    )
    ent = np.stack([pos, rng.integers(0, 1 << 30, (s, d))], -1).astype(np.int32)
    rec = rng.integers(-1, d + 2, s)
    np.testing.assert_array_equal(
        blk._rolz_src_of_rows(torch.from_numpy(ent), torch.from_numpy(rec)).numpy(),
        np.asarray(jblk._rolz_src_of_rows(jnp.asarray(ent), jnp.asarray(rec, jnp.int32))),
    )
    fill = rng.integers(0, d + 1, s)
    np.testing.assert_array_equal(
        blk._fill_bucket(torch.from_numpy(fill)).numpy(),
        np.asarray(jblk._fill_bucket(jnp.asarray(fill, jnp.int32))),
    )
    np.testing.assert_array_equal(
        blk._rec_bucket(torch.from_numpy(rec)).numpy(),
        np.asarray(jblk._rec_bucket(jnp.asarray(rec, jnp.int32))),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_insert_collisions(seed):
    """Lanes inserting into one bucket take consecutive oldest slots in
    lane order, on a random table with empties and full rows."""
    rng = np.random.default_rng(seed)
    pj, pt = params(**SMALL)
    tab = rng.integers(0, 3000, (1 << pj.rolz_bits, pj.rolz_depth, 2)).astype(np.int32)
    tab[..., 0][rng.random(tab.shape[:2]) < 0.3] = 0
    s = pj.lanes
    rctx = rng.integers(0, 4, s)  # heavy collisions
    ins = rng.random(s) < 0.8
    pos = rng.integers(3000, 9000, s)
    nx4 = rng.integers(0, 1 << 32, s, dtype=np.int64)
    c = {"rolz_ent": jnp.asarray(tab)}
    c = jblk._bucket_insert(c, pj, jnp.asarray(rctx, jnp.int32), jnp.asarray(ins),
                            jnp.asarray(pos, jnp.int32), jnp.asarray(nx4.astype(np.uint32)))
    t = blk.rolz_from_numpy(tab, "cpu")
    blk._bucket_insert(t, pt, torch.from_numpy(rctx), torch.from_numpy(ins),
                       torch.from_numpy(pos), torch.from_numpy(nx4))
    np.testing.assert_array_equal(blk.rolz_to_numpy(t), np.asarray(c["rolz_ent"]))


@pytest.mark.parametrize("width", [5, 32, 250])
def test_windows_and_prefix(width):
    rng = np.random.default_rng(width)
    flat = rng.integers(0, 3, 1000).astype(np.uint8)  # long common prefixes
    w_j = jblk._pack_words(jnp.asarray(flat))
    w_t = blk._pack_words(torch.from_numpy(flat))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j).astype(np.int64))
    src = rng.integers(-2, 1000, 16)
    win_t = blk._gather_windows(w_t, torch.from_numpy(src), width)
    win_j = jblk._gather_windows(w_j, jnp.asarray(src, jnp.int32), width)
    np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_j))
    cur = np.asarray(win_j)[::-1].copy()
    np.testing.assert_array_equal(
        blk._prefix_len(torch.from_numpy(cur), win_t).numpy(),
        np.asarray(jblk._prefix_len(jnp.asarray(cur), win_j)),
    )


def test_unsupported_configurations_raise(monkeypatch):
    data = corpus("text", 100, seed=0)
    # mode X is ported: the JAX payload, and it decodes (test_torch_xmode.py
    # holds every pass)
    kx = dict(SMALL, mode="X", min_len=6, flexible=True)
    payload = blk.encode_block(data, blk.BlockParams(**kx), "cpu")
    assert payload == jblk.encode_block(data, jblk.BlockParams(**kx))
    np.testing.assert_array_equal(
        blk.decode_block(payload, data.size, blk.BlockParams(**kx), "cpu"), data)
    # mode P is ported too (test_torch_pmode.py holds every pass)
    kp = dict(SMALL, mode="P", min_len=4)
    payload = blk.encode_block(data, blk.BlockParams(**kp), "cpu")
    assert payload == jblk.encode_block(data, jblk.BlockParams(**kp))
    np.testing.assert_array_equal(
        blk.decode_block(payload, data.size, blk.BlockParams(**kp), "cpu"), data)
    with pytest.raises(NotImplementedError, match="mode 'Q'"):
        blk.encode_block(data, blk.BlockParams(**dict(SMALL, mode="Q")), "cpu")
    with pytest.raises(NotImplementedError, match="short_depth"):
        blk.decode_block(b"", 1, blk.BlockParams(**dict(SMALL, short_depth=8)), "cpu")
    # chain_match is ported (test_torch_chain.py): a block of it needs the
    # carried state, which the one-block coders do not have
    pcm = blk.BlockParams(**dict(SMALL, flexible=True, chain_match=True))
    with pytest.raises(ValueError, match="encode_block_chained"):
        blk.encode_block(data, pcm, "cpu")
    with pytest.raises(ValueError, match="decode_block_chained"):
        blk.decode_block(b"", 1, pcm, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        blk.rans_scan(blk.BlockParams(**SMALL),
                      torch.empty((64, 9, 8), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize(
    "knob", ["CPX_R_FINDER", "CPX_SHORT_EXTRA", "CPX_STREAM_READ", "CPX_DEBUG_EVT",
             "CPX_X_FINDER"]
)
def test_unported_encoder_knobs_raise(monkeypatch, knob):
    # the finders take 'sort' or 'scan' (test_torch_xscan.py); nothing else
    monkeypatch.setitem(blk._ENV, knob, "1" if knob == "CPX_DEBUG_EVT" else "chain")
    with pytest.raises(NotImplementedError, match=knob):
        blk.encode_block(corpus("text", 100), blk.BlockParams(**SMALL), "cpu")


FLEX = dict(SMALL, flexible=True)
FLEX_WIDE = dict(WIDE, flexible=True)


@pytest.mark.parametrize(
    "name,kw,short",
    [("text", FLEX, 0), ("zeros", FLEX, 0), ("period7", FLEX, 11),
     ("random", FLEX, 0), ("lowentropy", FLEX, 37),
     ("text", dict(FLEX, rolz_ctx_bytes=4, rolz_dec=2), 5),
     ("text", FLEX_WIDE, 100), ("period7", FLEX_WIDE, 0)],
)
def test_flexible_encode_equals_jax(name, kw, short):
    """encode_block with the flexible parse writes the JAX payload, and
    both packages decode it."""
    pj, pt = params(**kw)
    data = corpus(name, pj.capacity - short, seed=8)
    payload = jblk.encode_block(data, pj)
    assert blk.encode_block(data, pt, "cpu") == payload
    np.testing.assert_array_equal(blk.decode_block(payload, data.size, pt, "cpu"), data)
    np.testing.assert_array_equal(jblk.decode_block(payload, data.size, pj), data)


def test_flexible_decisions_equal_jax():
    """The parse decisions (take, src, recency index, fill) that the
    modeling scan is fed, against _search_and_parse."""
    pj, pt = params(**FLEX_WIDE)
    data = corpus("text", pj.capacity - 9, seed=9)
    buf = block_buf(data, pj)
    inp = torch.from_numpy(buf)
    n = int(data.size)
    cands = blk.rank_scan(pt, inp, n, blk.sort_candidates(pt, inp, n),
                          blk._init_rolz(pt, "cpu"))
    dec = blk.parse_scan(pt, n, cands)
    _, take, src, idx, fill = _jax_search_and_parse(pj, jnp.asarray(buf), jnp.int32(n))
    for a, b in zip(dec, (take, src, idx, fill)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int((dec[0] > 0).sum()) > 100


@pytest.mark.parametrize("knob,value", [("_R_PROBE", 32), ("_R_CANDS", 2)])
def test_flexible_encode_at_other_knobs(monkeypatch, knob, value):
    """CPX_R_PROBE=32 (a deeper chain) and CPX_R_CANDS=2: the knobs bind at
    import in both packages, so both module values are set here, on a
    geometry that no other test has traced under jit."""
    monkeypatch.setattr(jblk, knob, value)
    monkeypatch.setattr(blk, knob, value)
    kw = dict(FLEX_WIDE, o3_bits=12 if knob == "_R_PROBE" else 11)
    pj, pt = params(**kw)
    data = corpus("text", pj.capacity, seed=10)
    inp = torch.from_numpy(block_buf(data, pj))
    payload = jblk.encode_block(data, pj)
    assert blk.encode_block(data, pt, "cpu") == payload
    props = blk.sort_candidates(pt, inp, data.size)
    assert props.shape[0] == 2 * getattr(blk, "_R_CANDS")
    monkeypatch.undo()
    default = blk.sort_candidates(pt, inp, data.size)
    assert props.shape != default.shape or not torch.equal(props, default), \
        "the knob must change the finder's proposals"
    np.testing.assert_array_equal(blk.decode_block(payload, data.size, pt, "cpu"), data)
    np.testing.assert_array_equal(jblk.decode_block(payload, data.size, pj), data)


@pytest.mark.parametrize(
    "knob,value",
    [("_R_CANDS", 0), ("_R_CANDS", 8), ("_R_PROBE", 0), ("_R_PROBE", 65),
     ("_SORT_EXT", 0), ("_P_RM", -1)],
)
def test_flexible_knobs_out_of_range_raise(monkeypatch, knob, value):
    monkeypatch.setattr(blk, knob, value)
    with pytest.raises(NotImplementedError, match="CPX_"):
        blk.encode_block(corpus("text", 100), blk.BlockParams(**FLEX), "cpu")


@pytest.mark.parametrize("t", [0, 5, 40, 63])
def test_match_window_len_equals_jax(t):
    """Mode P's one-candidate length: the prefix against the window at src
    (sources before the block, in other lanes, at the block's end), capped by
    the lane's end, the block's end and the longest coded length."""
    kw = dict(SMALL, mode="P", min_len=4)
    pj, pt = jblk.BlockParams(**kw), blk.BlockParams(**kw)
    rng = np.random.default_rng(t)
    n = pj.capacity - 9
    buf = np.zeros((pj.lanes, pj.steps), np.uint8)
    buf.reshape(-1)[:n] = corpus("lowentropy", n, seed=t)
    pos = np.arange(pj.lanes) * pj.steps + t
    src = rng.integers(-2, pj.capacity, pj.lanes).astype(np.int32)
    src[:2] = [pos[0] - 1, pj.capacity - 3]
    inp_j = jnp.asarray(buf)
    cur_j = jnp.pad(inp_j, ((0, 0), (0, pj.window + 1)))[:, t:t + pj.window + 1].astype(jnp.int32)
    ref = jblk._match_window_len(jblk._pack_words(inp_j.reshape(-1)), jnp.asarray(pos),
                                 jnp.asarray(src), jnp.int32(t), jnp.int32(n), pj, cur_j)
    inp_t = torch.from_numpy(buf)
    got = blk._match_window_len(
        blk._pack_words(inp_t.reshape(-1)), torch.from_numpy(pos),
        torch.from_numpy(src.astype(np.int64)), t, n, pt,
        blk._cur_windows(inp_t, t, pt.window + 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
