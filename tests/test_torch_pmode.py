"""The port's mode-P block codec (the ``crp`` LZP codec) against the JAX
package, piece by piece and as a whole.

The kernel-holding passes run in their plain PyTorch versions here (CPU
tensors) and are held to the JAX functions on the same seeded input, at
S=8/T=64 (window 32) and S=512/T=32.  Tolerance 0 everywhere: every grid,
every table (the PPM tables, ``sse_p`` and ``lzp2/4/8``), every byte.

- ``lzp_hash4`` / ``lzp_hash8`` on random words;
- ``_lzp_candidate`` on hand-made tables (empty, colliding entries, sources
  at a lane's head that cannot be verified, steps below 8) and on the tables
  of a real block;
- K13e (modeling scan) vs the scan of ``_encode_model_body``: event grids,
  tables, the three LZP tables; one step from a JAX mid-block state;
- K3 at three slots on the JAX events; the payload;
- K13d (decode scan) on JAX payloads: bytes, states, words used, tables;
  one step from a JAX mid-block state; a random stream;
- ``encode_block`` / ``decode_block`` vs the JAX payload, both ways, with
  the match layer off as well.

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
from comprox_tpu.models import ppm as jppm
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.models import ppm

from test_block import corpus

torch.set_num_threads(1)

SMALL = dict(lanes=8, steps=64, mode="P", min_len=4, window=32, o3_bits=14)
WIDE = dict(SMALL, lanes=512, steps=32, window=250)
GEO = {"small": SMALL, "wide": WIDE}
# (content, geometry, bytes short of the capacity)
CASES = [("text", "small", 0), ("zeros", "small", 0), ("period3", "small", 3),
         ("random", "small", 0), ("lowentropy", "small", 37),
         ("text", "small", 505), ("text", "small", 510), ("text", "small", 511),
         ("text", "wide", 100), ("period3", "wide", 0), ("lowentropy", "wide", 7),
         ("zeros", "wide", 1)]
CARRY_KEYS = ("ctx4", "ctx4b", "copy_rem", "copy_src")


def params(geo, **kw):
    kw = dict(GEO[geo] if isinstance(geo, str) else geo, **kw)
    return jblk.BlockParams(**kw), blk.BlockParams(**kw)


def content(name, n, seed=1):
    if name == "period3":
        pat = np.random.default_rng(seed).integers(0, 256, 3, dtype=np.uint8)
        return np.tile(pat, n // 3 + 1)[:n]
    return corpus(name, n, seed=seed)


def block_buf(name, p, short, seed=1):
    n = p.capacity - short
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    buf.reshape(-1)[:n] = content(name, n, seed)
    return buf, n


def model_body(p, inp, n):
    inp_flat = inp.reshape(-1)
    inp_pad = jnp.pad(inp, ((0, 0), (0, p.window + 1)))
    return functools.partial(jblk._encode_model_body, p, inp_pad, inp_flat,
                             jblk._pack_words(inp_flat), n)


@functools.partial(jax.jit, static_argnums=(0, 3))
def jax_model_scan(p, inp, n, steps=None):
    """The modeling scan of ``_encode_passes`` with its carry (the LZP
    tables are not among ``_encode_passes``' results)."""
    ts = jnp.arange(p.steps if steps is None else steps, dtype=jnp.int32)
    return jax.lax.scan(model_body(p, inp, n),
                        jblk._init_carry(p, enc_side=True), ts)


@functools.partial(jax.jit, static_argnums=(0, 4))
def jax_decode_scan(p, states, stream, n, steps=None):
    """``_decode_scan`` with its carry."""
    carry = (jblk._init_carry(p, enc_side=False), states, jnp.uint32(0),
             jnp.zeros((p.lanes, p.steps), jnp.uint8))
    ts = jnp.arange(p.steps if steps is None else steps, dtype=jnp.int32)
    out, _ = jax.lax.scan(
        functools.partial(jblk._decode_body, p, stream, n), carry, ts)
    return out


def assert_tables_equal(tables, lzp, c):
    """The port's PPM and LZP tables against a JAX carry."""
    for k, v in ppm.tables_to_numpy(tables).items():
        np.testing.assert_array_equal(v, np.asarray(c["tables"][k]), err_msg=k)
    if lzp is not None:
        for k, v in blk.lzp_to_numpy(lzp).items():
            np.testing.assert_array_equal(v, np.asarray(c[k]), err_msg=k)


def carry_to_torch(c):
    return {k: torch.from_numpy(np.asarray(c[k]).astype(np.int64))
            for k in CARRY_KEYS}


# -------------------------------------------------------------- hashes -----


def test_lzp_hashes_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    a[:4] = [0, 0xFFFFFFFF, 0x20202020, 0x80000000]
    b[:4] = [0, 0xFFFFFFFF, 0x20202020, 1]
    ta = torch.from_numpy(a.astype(np.int64))
    tb_ = torch.from_numpy(b.astype(np.int64))
    h4 = np.asarray(jblk.lzp_hash4(jnp.asarray(a)))
    h8 = np.asarray(jblk.lzp_hash8(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(blk.lzp_hash4(ta).numpy(), h4)
    np.testing.assert_array_equal(blk.lzp_hash8(ta, tb_).numpy(), h8)
    assert h4.max() < 1 << blk.LZP4_BITS and h8.max() < 1 << blk.LZP8_BITS
    assert (blk.LZP4_BITS, blk.LZP8_BITS) == (jblk.LZP4_BITS, jblk.LZP8_BITS)


# ----------------------------------------------------------- candidate -----


def _candidate_both(pj, pt, ctx4, ctx4b, lzp_np, t, hist):
    cj = {"ctx4": jnp.asarray(ctx4), "ctx4b": jnp.asarray(ctx4b),
          **{k: jnp.asarray(v) for k, v in lzp_np.items()}}
    src_j, ok_j = jblk._lzp_candidate(cj, jnp.int32(t), pj, jnp.asarray(hist))
    ct = {"ctx4": torch.from_numpy(ctx4.astype(np.int64)),
          "ctx4b": torch.from_numpy(ctx4b.astype(np.int64))}
    src, ok = blk._lzp_candidate(ct, blk.lzp_from_numpy(lzp_np, "cpu"), t, pt,
                                 torch.from_numpy(hist))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(src.numpy(), np.asarray(src_j))
    return np.asarray(src_j), np.asarray(ok_j)


def _registers(buf, t):
    """ctx4 / ctx4b of every lane before step t (t >= 8)."""
    b = buf.astype(np.uint32)
    ctx4 = (b[:, t - 4] << 24) | (b[:, t - 3] << 16) | (b[:, t - 2] << 8) | b[:, t - 1]
    ctx4b = (b[:, t - 8] << 24) | (b[:, t - 7] << 16) | (b[:, t - 6] << 8) | b[:, t - 5]
    return ctx4, ctx4b


@pytest.mark.parametrize("kind", ["empty", "true", "colliding", "head", "forward"])
@pytest.mark.parametrize("t", [1, 3, 7, 8, 20])
def test_lzp_candidate_on_hand_made_tables(kind, t):
    """Each table slot of each lane is set by hand: to nothing, to a source
    whose preceding bytes are the lane's (verified), to one whose bytes
    differ (a hash collision: rejected), to one within k bytes of its lane's
    head (taken unverified), to one at a later step (not causal)."""
    pj, pt = params("small")
    rng = np.random.default_rng(t)
    buf = np.tile(np.frombuffer(b"abcdefgh", np.uint8), (8, 8)).copy()
    buf[4:] = rng.integers(0, 256, (4, 64), dtype=np.uint8)
    if t >= 8:
        ctx4, ctx4b = _registers(buf, t)
    else:
        ctx4 = rng.integers(0, 1 << 32, 8, dtype=np.uint64).astype(np.uint32)
        ctx4b = rng.integers(0, 1 << 32, 8, dtype=np.uint64).astype(np.uint32)
    lzp = {"lzp2": np.zeros(1 << 16, np.int32),
           "lzp4": np.zeros(1 << jblk.LZP4_BITS, np.int32),
           "lzp8": np.zeros(1 << jblk.LZP8_BITS, np.int32)}
    lane_base = np.arange(8) * 64
    src = {"empty": None,
           "true": np.roll(lane_base, 1) + (t % 8) + 8,   # same phase, other lane
           "colliding": np.roll(lane_base, 1) + ((t + 3) % 8) + 8,
           "head": np.roll(lane_base, 1) + min(t - 1, 2),
           "forward": np.roll(lane_base, 1) + t + 5}[kind]
    if src is not None:
        h8 = np.asarray(jblk.lzp_hash8(jnp.asarray(ctx4), jnp.asarray(ctx4b)))
        h4 = np.asarray(jblk.lzp_hash4(jnp.asarray(ctx4)))
        lzp["lzp8"][h8] = src + 1
        lzp["lzp4"][h4] = src + 1
        if kind != "colliding":  # the exact 2-byte index is never verified
            lzp["lzp2"][ctx4 & 0xFFFF] = src + 1
    got_src, ok = _candidate_both(pj, pt, ctx4, ctx4b, lzp, t, buf.reshape(-1))
    if kind == "empty" or kind == "forward":
        assert not ok.any()
    if kind == "true" and t >= 16:  # the source's step, t % 8 + 8, is earlier
        assert ok[1:4].all(), "a verified source must be taken"
    if kind == "colliding" and t >= 16:
        assert not ok[1:4].any(), "a source after other bytes must be rejected"
    if kind == "head" and t >= 2:
        assert ok.any(), "a source at a lane's head is taken unverified"


@pytest.mark.parametrize("geo", ["small", "wide"])
def test_lzp_candidate_on_a_real_block_with_damaged_tables(geo):
    """The tables a real block leaves after K steps, then with random slots
    overwritten by random positions: collisions on every path."""
    pj, pt = params(geo)
    buf, n = block_buf("text", pj, 5, seed=3)
    k = pj.steps // 2
    c, _ = jax_model_scan(pj, jnp.asarray(buf), jnp.int32(n), k)
    ctx4, ctx4b = np.asarray(c["ctx4"]), np.asarray(c["ctx4b"])
    lzp = {key: np.asarray(c[key]).copy() for key in blk.LZP_KEYS}
    _, ok = _candidate_both(pj, pt, ctx4, ctx4b, lzp, k, buf.reshape(-1))
    assert ok.any()
    rng = np.random.default_rng(1)
    for key in blk.LZP_KEYS:
        used = np.flatnonzero(lzp[key])
        hit = rng.choice(used, used.size // 2, replace=False)
        lzp[key][hit] = rng.integers(1, n + 1, hit.size)
    _candidate_both(pj, pt, ctx4, ctx4b, lzp, k, buf.reshape(-1))


# ------------------------------------------------- K13e, K3, K13d, block ---


def check_block(name, geo, short, seed=1, **kw):
    """K13e, K3 (three slots), the payload and K13d of the port against JAX
    on one block (tolerance 0)."""
    pj, pt = params(geo, **kw)
    buf, n = block_buf(name, pj, short, seed)
    data = buf.reshape(-1)[:n].copy()
    inp_j, inp_t = jnp.asarray(buf), torch.from_numpy(buf)

    # K13e
    c_j, ev_j = jax_model_scan(pj, inp_j, jnp.int32(n))
    tables = ppm.init_tables(pt.match, pt.o3_bits, "cpu")
    lzp = blk._init_lzp(pt, "cpu") if pt.match else None
    ev = blk.model_scan(pt, inp_t, n, None, tables, lzp)
    ev_ref = np.stack([np.asarray(g).astype(np.int32) for g in ev_j[:9]], axis=1)
    assert ev.shape == (pt.steps, 9, pt.lanes) and ev.dtype == torch.int32
    np.testing.assert_array_equal(ev.numpy(), ev_ref)
    assert_tables_equal(tables, lzp, c_j)

    # K3 on the JAX event grids; the payload
    x_j, emit_j, words_j, _, tables_j = jblk._encode_passes(pj, inp_j, jnp.int32(n))
    x, emit, words = blk.rans_scan(pt, torch.from_numpy(ev_ref))
    emit_ref = np.unpackbits(np.asarray(emit_j), axis=-1, bitorder="little")
    assert emit.shape == (pt.steps, 3, pt.lanes)
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_j).astype(np.int64))
    np.testing.assert_array_equal(emit.numpy(), emit_ref.astype(bool))
    np.testing.assert_array_equal(words.numpy(), np.asarray(words_j).astype(np.int32))
    payload_j = jblk._pack_payload(x_j, emit_j, words_j)
    assert blk._pack_payload(x, blk.pack_emit(pt, emit), words) == payload_j
    assert blk.encode_block(data, pt, "cpu") == payload_j

    # K13d on the JAX payload
    n_words, states, stream = blk._unpack_payload(payload_j, pt)
    assert pt.stream_pad == pt.capacity // 2 + 16 + 3 * pt.lanes
    c_d, xj, basej, outj = jax_decode_scan(
        pj, jnp.asarray(states), jnp.asarray(stream), jnp.int32(n))
    tables = ppm.init_tables(pt.match, pt.o3_bits, "cpu")
    lzp = blk._init_lzp(pt, "cpu") if pt.match else None
    xd, used, out = blk.decode_scan(
        pt, torch.from_numpy(states.astype(np.int64)),
        torch.from_numpy(stream.astype(np.int32)), n, tables, None, lzp)
    np.testing.assert_array_equal(out.numpy().reshape(-1)[:n], data)
    np.testing.assert_array_equal(out.numpy(), np.asarray(outj))
    np.testing.assert_array_equal(xd.numpy(), np.asarray(xj).astype(np.int64))
    assert used == int(basej) == n_words
    assert_tables_equal(tables, lzp, c_d)
    np.testing.assert_array_equal(blk.decode_block(payload_j, n, pt, "cpu"), data)
    np.testing.assert_array_equal(jblk.decode_block(payload_j, n, pj), data)
    return ev_ref


@pytest.mark.parametrize("name,geo,short", CASES)
def test_passes(name, geo, short):
    ev = check_block(name, geo, short)
    # on equal bytes every lane maps one slot to the highest lane's next
    # position, a later step for every reader: mode P finds nothing there
    if name not in ("random", "zeros") and short < 500:
        assert ev[:, 8].any(), "the case must code matches"


@pytest.mark.parametrize("name,geo,short",
                         [("text", "small", 0), ("text", "small", 511),
                          ("lowentropy", "wide", 7)])
def test_passes_match_layer_off(name, geo, short):
    """``match=False`` rides the container header: no tables, no candidate,
    no APM (tolerance 0 against JAX, which keeps its tables and never reads
    them into a symbol)."""
    ev = check_block(name, geo, short, match=False)
    assert not ev[:, 8].any()


def test_one_byte_block():
    pj, pt = params("small")
    data = np.array([65], np.uint8)
    payload = jblk.encode_block(data, pj)
    assert blk.encode_block(data, pt, "cpu") == payload
    np.testing.assert_array_equal(blk.decode_block(payload, 1, pt, "cpu"), data)


@pytest.mark.parametrize("n", [2, 7, 63, 64, 65, 100])
def test_partial_blocks_equal_jax(n):
    pj, pt = params("small")
    data = corpus("text", n, seed=2)
    payload = jblk.encode_block(data, pj)
    assert blk.encode_block(data, pt, "cpu") == payload
    np.testing.assert_array_equal(blk.decode_block(payload, n, pt, "cpu"), data)


def test_model_step_from_jax_mid_block_state():
    """K steps of the JAX modeling scan, its tables, LZP tables and registers
    carried across (``tables_from_numpy``, ``lzp_from_numpy``), then step K
    on both sides: events, every table, the registers."""
    pj, pt = params("small")
    buf, n = block_buf("text", pj, 0, seed=6)
    inp_j = jnp.asarray(buf)
    k = 40
    c, _ = jax_model_scan(pj, inp_j, jnp.int32(n), k)
    assert int((np.asarray(c["lzp8"]) > 0).sum()) > 50, "lzp8 must have entries"
    c2, out = model_body(pj, inp_j, jnp.int32(n))(c, jnp.int32(k))
    carry = carry_to_torch(c)
    tables = ppm.tables_from_numpy(
        {key: np.asarray(v) for key, v in c["tables"].items()}, "cpu")
    lzp = blk.lzp_from_numpy({key: np.asarray(c[key]) for key in blk.LZP_KEYS}, "cpu")
    inp_t = torch.from_numpy(buf)
    ev = blk._model_step(pt, inp_t, n, carry, tables, k, None, lzp,
                         blk._pack_words(inp_t.reshape(-1)))
    ref = np.stack([np.asarray(g).astype(np.int32) for g in out[:9]])
    np.testing.assert_array_equal(ev.numpy(), ref)
    assert_tables_equal(tables, lzp, c2)
    for key, v in carry.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(c2[key]).astype(np.int64))


def test_decode_step_from_jax_mid_block_state():
    pj, pt = params("small")
    buf, n = block_buf("text", pj, 9, seed=7)
    data = buf.reshape(-1)[:n].copy()
    payload = jblk.encode_block(data, pj)
    n_words, states, stream = blk._unpack_payload(payload, pt)
    k = 33
    args = (pj, jnp.asarray(states), jnp.asarray(stream), jnp.int32(n))
    c, xj, basej, outj = jax_decode_scan(*args, k)
    (c2, x2, base2, out2), _ = jblk._decode_body(
        pj, jnp.asarray(stream), jnp.int32(n), (c, xj, basej, outj), jnp.int32(k))
    carry = carry_to_torch(c)
    tables = ppm.tables_from_numpy(
        {key: np.asarray(v) for key, v in c["tables"].items()}, "cpu")
    lzp = blk.lzp_from_numpy({key: np.asarray(c[key]) for key in blk.LZP_KEYS}, "cpu")
    out = torch.from_numpy(np.asarray(outj).copy())
    x, base = blk._decode_step(
        pt, torch.from_numpy(stream.astype(np.int32)), n, carry, tables, None,
        torch.from_numpy(np.asarray(xj).astype(np.int64)), int(basej), out, k, lzp)
    np.testing.assert_array_equal(out.numpy(), np.asarray(out2))
    np.testing.assert_array_equal(x.numpy(), np.asarray(x2).astype(np.int64))
    assert int(base) == int(base2)
    assert_tables_equal(tables, lzp, c2)
    for key, v in carry.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(c2[key]).astype(np.int64))


def test_decodes_garbage_like_jax():
    """A random stream: matches without a candidate, sources of -1, copies
    that run over other lanes — both decoders must end in the same state."""
    pj, pt = params("small")
    rng = np.random.default_rng(0)
    n = pt.capacity
    states = rng.integers(1 << 16, 1 << 32, pt.lanes, dtype=np.int64)
    stream = rng.integers(0, 1 << 16, pt.stream_pad, dtype=np.int64)
    c, xj, basej, outj = jax_decode_scan(
        pj, jnp.asarray(states.astype(np.uint32)),
        jnp.asarray(stream.astype(np.uint16)), jnp.int32(n))
    tables = ppm.init_tables(True, pt.o3_bits, "cpu")
    lzp = blk._init_lzp(pt, "cpu")
    xd, used, out = blk.decode_scan(
        pt, torch.from_numpy(states), torch.from_numpy(stream.astype(np.int32)),
        n, tables, None, lzp)
    np.testing.assert_array_equal(out.numpy(), np.asarray(outj))
    np.testing.assert_array_equal(xd.numpy(), np.asarray(xj).astype(np.int64))
    assert used == int(basej)
    assert_tables_equal(tables, lzp, c)


def test_flipped_payload_bit_fails_drain():
    pj, pt = params("small")
    data = corpus("text", 512, seed=6)
    payload = bytearray(jblk.encode_block(data, pj))
    payload[4 + 4 * pt.lanes + 10] ^= 0x10
    with pytest.raises(ValueError, match="corrupt block"):
        blk.decode_block(bytes(payload), data.size, pt, "cpu")


def test_parse_switches_change_nothing_in_mode_p():
    """``flexible`` and ``top_k`` (the CLI's -f0 and -m) have no pass to act
    on: the payload stays the JAX one."""
    pj, pt = params("small")
    data = corpus("text", pj.capacity, seed=12)
    payload = jblk.encode_block(data, pj)
    for kw in (dict(flexible=False), dict(top_k=1), dict(rolz_ctx_bytes=4)):
        assert blk.encode_block(data, blk.BlockParams(**dict(SMALL, **kw)), "cpu") == payload


# ------------------------------------------------------------- knobs -------


def test_sse_p_off_equals_jax(monkeypatch):
    """CPX_SSE_P binds at import in both packages and selects no new code
    (the A event without an APM): both module values are set, on a geometry
    no other test traces."""
    monkeypatch.setattr(jppm, "SSE_P", 0)
    monkeypatch.setattr(ppm, "SSE_P", 0)
    pj, pt = params("small", o3_bits=12)
    data = corpus("text", pj.capacity, seed=10)
    payload = jblk.encode_block(data, pj)
    assert blk.encode_block(data, pt, "cpu") == payload
    np.testing.assert_array_equal(blk.decode_block(payload, data.size, pt, "cpu"), data)
    monkeypatch.undo()
    assert blk.encode_block(data, pt, "cpu") != payload, "the APM must matter"


def test_table_arguments_are_checked():
    pt = blk.BlockParams(**SMALL)
    st = torch.zeros(8, dtype=torch.int64)
    tables = ppm.init_tables(True, 14, "cpu")
    with pytest.raises(ValueError, match="bucket table"):
        blk.decode_scan(pt, st, torch.zeros(64, dtype=torch.int32), 1, tables,
                        blk._init_rolz(blk.BlockParams(lanes=8, steps=64, mode="R",
                                                       rolz_bits=10, rolz_depth=16), "cpu"))
    pr = blk.BlockParams(lanes=8, steps=64, mode="X", min_len=6, window=32,
                         o3_bits=14, rolz_bits=10, rolz_depth=16)
    with pytest.raises(ValueError, match="only mode P"):
        blk.decode_scan(pr, st, torch.zeros(64, dtype=torch.int32), 1, tables,
                        None, blk._init_lzp(pt, "cpu"))
    with pytest.raises(ValueError, match="no parse decisions"):
        blk.model_scan(pt, torch.zeros((8, 64), dtype=torch.uint8), 1,
                       torch.zeros((4, 64, 8), dtype=torch.int32), tables)
