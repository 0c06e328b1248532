"""Chain modes of the port against the JAX package, exactly (tolerance 0).

``-c`` carries the PPM tables across blocks; ``-C`` (crz) also the bucket
table and the previous block's bytes.  At S=8 and T of 64-128, a few
blocks, as tests/test_container.py runs the JAX package's own chain tests:

- whole archives byte for byte for crz ``-c``, crz ``-C``, crx ``-c`` and
  crp ``-c``, each decoded by the other package;
- a block stored raw in mid-chain leaves the state as it was, on both
  sides;
- the plain versions of the slice's kernels against the JAX code they
  replace: KCR against ``_remap_chain_ment``, K3p against the packed mask
  of ``_encode_passes``, K5's chain arm against ``_rolz_rank_scan`` with
  ``ment0`` (and its final table against ``_encode_passes``' ``ment1``),
  K1's chain arm against ``_decode_scan`` with ``tables0, ment0, prev``,
  each seeded with the state one JAX block leaves;
- the refusals.

The CUDA kernels are held to these plain versions by the ``cuda`` tests of
test_torch_kernels.py.
"""

import dataclasses
import functools
import io
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu.codec import block as jblk
from comprox_tpu.codec import container as jcon
from comprox_tpu_torch.cli import main as cli
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec import container as con
from comprox_tpu_torch.models import ppm

from test_block import corpus

# the plain versions run many tiny ops: more intra-op threads would only
# contend with the other test workers
torch.set_num_threads(1)

# tests/test_container.py::params_for at T=64 (flexible parse, the default)
GEO = dict(lanes=8, steps=64, min_len=5, o3_bits=12, rolz_bits=10,
           rolz_depth=16)


def cps(codec: bytes, chain_match: bool = False, **kw):
    kw = dict(GEO, mode=codec.decode(), chain_match=chain_match, **kw)
    return (jcon.ContainerParams(codec=codec, block=jblk.BlockParams(**kw)),
            con.ContainerParams(codec=codec, block=blk.BlockParams(**kw)))


def word_salad(n: int, seed: int = 11) -> np.ndarray:
    """Words that repeat across block boundaries, little within one
    (test_container.py::test_chain_match_roundtrip_and_gain)."""
    rng = np.random.default_rng(seed)
    words = [b"alpha ", b"bravo ", b"charlie ", b"delta ", b"echo ",
             b"foxtrot ", b"golf ", b"hotel ", b"india ", b"juliet "]
    base = b"".join(words[int(i)] for i in rng.integers(0, len(words), 120))
    return np.frombuffer((base * (n // len(base) + 1))[:n], np.uint8).copy()


def jax_encode(cp, data, **kw) -> bytes:
    buf = io.BytesIO()
    jcon.encode_stream(data, buf, cp, **kw)
    return buf.getvalue()


def port_encode(cp, data, **kw) -> bytes:
    buf = io.BytesIO()
    con.encode_stream(data, buf, cp, "cpu", **kw)
    return buf.getvalue()


def port_decode(arc: bytes) -> bytes:
    out = io.BytesIO()
    con.decode_stream(io.BytesIO(arc), out, "cpu")
    return out.getvalue()


def jax_decode(arc: bytes) -> bytes:
    out = io.BytesIO()
    jcon.decode_stream(io.BytesIO(arc), out)
    return out.getvalue()


def block_flags(arc: bytes) -> list:
    """Each block's flags byte, in order."""
    f = io.BytesIO(arc)
    _, flags = con.read_header(f)
    if flags & con.F_DICT:
        blob_len, clen, _ = np.frombuffer(f.read(12), "<u4")
        f.read(int(clen) or int(blob_len))
    out = []
    while True:
        raw_n, blen, bflags, _ = struct.unpack(con.BLKHDR, f.read(con.BLKHDR_LEN))
        if raw_n == 0:
            return out
        f.read(blen)
        out.append(bflags)


@pytest.mark.parametrize("codec,chain_match,dictionary", [
    (b"R", False, True),
    (b"R", True, False),
    (b"X", False, False),
    (b"P", False, True),
])
def test_chained_archive_equals_jax(codec, chain_match, dictionary):
    """crz -c, crz -C, crx -c, crp -c: the same archive as JAX's (four whole
    blocks and a short one), each package decoding the other's."""
    jcp, tcp = cps(codec, chain_match)
    cap = tcp.block.capacity
    data = word_salad(3 * cap + 77)
    want = jax_encode(jcp, data, dictionary=dictionary, chain=True)
    got = port_encode(tcp, data, dictionary=dictionary, chain=True)
    flags = con.read_header(io.BytesIO(got))[1]
    assert flags & con.F_CHAIN
    assert bool(flags & con.F_CHAIN_MATCH) == chain_match
    assert got == want
    assert port_decode(want) == data.tobytes()
    assert jax_decode(got) == data.tobytes()


@pytest.mark.parametrize("chain_match", [False, True])
def test_stored_block_mid_chain_leaves_the_state(chain_match):
    """A random block between text blocks is stored raw: the blocks after
    it code from the state before it, on both sides (the JAX package's
    test_chain_*_stored_block_mid_chain)."""
    jcp, tcp = cps(b"R", chain_match)
    cap = tcp.block.capacity
    text = word_salad(cap, seed=7)
    rand = np.random.default_rng(7).integers(0, 256, cap, dtype=np.uint8)
    data = np.concatenate([text, rand, text, text[: cap // 2]])
    want = jax_encode(jcp, data, dictionary=False, chain=True)
    got = port_encode(tcp, data, dictionary=False, chain=True)
    assert [f & con.BF_STORED for f in block_flags(got)] == [0, con.BF_STORED, 0, 0]
    assert got == want
    assert port_decode(want) == data.tobytes()


# ---- the kernels' plain versions against the JAX code they replace --------

CM = dict(GEO, mode="R", chain_match=True)


def chain_params(**kw):
    kw = dict(CM, **kw)
    return jblk.BlockParams(**kw), blk.BlockParams(**kw)


def test_kcr_plain_equals_remap_chain_ment():
    pj, pt = chain_params()
    rng = np.random.default_rng(3)
    n = pt.capacity
    ment = np.stack([
        rng.integers(0, 2 * n + 1, (1 << pt.rolz_bits, pt.rolz_depth)),
        rng.integers(-(1 << 31), 1 << 31, (1 << pt.rolz_bits, pt.rolz_depth)),
    ], axis=-1).astype(np.int32)
    ment[0, :4, 0] = [0, n, n + 1, 2 * n]  # the boundaries
    want = np.asarray(jblk._remap_chain_ment(pj, jnp.asarray(ment)))
    got = blk.remap_chain_ment(pt, torch.from_numpy(ment))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    assert (want[..., 0] > 0).any() and (want[..., 0] == 0).any()


@functools.lru_cache(maxsize=None)
def chained_pair(steps: int = 64):
    """Two blocks of one chain coded by JAX (-C): the first block's state
    (numpy), the second block's input and JAX's encode and decode of it."""
    pj, pt = chain_params(steps=steps)
    n = pj.capacity
    data = word_salad(2 * n - 21, seed=5)
    st0 = jblk.init_chain_tables(pj)
    _, st1 = jblk.encode_block_chained(data[:n], pj, st0)
    st1 = jax.tree_util.tree_map(np.asarray, st1)
    n2 = data.size - n
    buf = np.zeros((pj.lanes, pj.steps), np.uint8)
    buf.reshape(-1)[:n2] = data[n:]
    enc = jax.tree_util.tree_map(np.asarray, jblk._encode_passes(
        pj, jnp.asarray(buf), jnp.int32(n2), st1["tables"], st1["ment"],
        st1["prev"]))
    payload = jblk._pack_payload(enc[0], enc[1], enc[2])
    n_words, states, stream = jblk._unpack_payload(payload, pj)
    dec = jax.tree_util.tree_map(np.asarray, jblk._decode_scan(
        pj, jnp.asarray(states), jnp.asarray(stream), jnp.int32(n2),
        st1["tables"], st1["ment"], st1["prev"]))
    return st1, buf, n2, enc, (payload, n_words, states, stream), dec


def test_chain_state_converts_both_ways():
    st1 = chained_pair()[0]
    st = blk.chain_state_from_numpy(st1, "cpu")
    assert st["prev"].dtype == torch.uint8 and st["ment"].dtype == torch.int32
    back = blk.chain_state_to_numpy(st)
    for k in ("ment", "prev"):
        np.testing.assert_array_equal(back[k], st1[k])
    for k, v in back["tables"].items():
        np.testing.assert_array_equal(v, st1["tables"][k], err_msg=k)
    assert (st1["ment"][..., 0] > 0).any() and st1["prev"].any()


def test_k5_chain_arm_equals_jax():
    """K5's chain arm on JAX's K4 proposals of the second block, shifted +N
    as _search_and_parse shifts them, from the remapped carried table."""
    from test_torch_sortfind import jax_props, props_grid

    st1, buf, n, enc, _, _ = chained_pair()
    pj, pt = chain_params()
    raw = jax_props(pj, jnp.asarray(buf), jnp.int32(n))
    props = [(l, s + pj.capacity) for l, s in raw]
    inp_flat = jnp.asarray(buf).reshape(-1)
    outs, fill = jblk._rolz_rank_scan(
        pj, jnp.pad(jnp.asarray(buf), ((0, 0), (0, pj.window + 1))),
        jblk._pack_words(jnp.concatenate([jnp.asarray(st1["prev"]).reshape(-1),
                                          inp_flat])),
        jnp.int32(n), props, jnp.asarray(st1["ment"]))
    want = np.stack([np.asarray(o) for o in outs] + [np.asarray(fill)])
    grid = torch.from_numpy(props_grid(pj, raw))  # K4's, block-local
    st = blk.chain_state_from_numpy(st1, "cpu")
    ment = blk.remap_chain_ment(pt, st["ment"])
    got = blk.rank_scan(pt, torch.from_numpy(buf), n, grid, ment, st["prev"])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[1::3][:-1] >= pj.capacity - 1).all()  # window-absolute sources
    # K5 is encode's only pass with bucket inserts: its final table is the
    # one JAX's modeling scan returns
    np.testing.assert_array_equal(blk.rolz_to_numpy(ment), enc[5])


def test_encode_passes_chained_equals_jax():
    """The chained encode passes on the port's plain versions: states, the
    bit-packed mask (K3p), the words, the tables and the bucket table."""
    st1, buf, n, enc, (payload, *_), _ = chained_pair()
    pj, pt = chain_params()
    st = blk.chain_state_from_numpy(st1, "cpu")
    states, emit_packed, words, ev, tables, ment = blk.encode_passes(
        pt, torch.from_numpy(buf), n, st["tables"], st["ment"], st["prev"])
    np.testing.assert_array_equal(states.numpy(), enc[0].astype(np.int64))
    assert emit_packed.dtype == torch.uint8
    np.testing.assert_array_equal(emit_packed.numpy(), enc[1])
    np.testing.assert_array_equal(words.numpy(), enc[2].astype(np.int32))
    for k, v in ppm.tables_to_numpy(tables).items():
        np.testing.assert_array_equal(v, enc[4][k], err_msg=k)
    np.testing.assert_array_equal(blk.rolz_to_numpy(ment), enc[5])
    assert blk._pack_payload(states, emit_packed, words) == payload
    # the carried state was not changed
    np.testing.assert_array_equal(blk.rolz_to_numpy(st["ment"]), st1["ment"])


@pytest.mark.parametrize("n_slots,lanes", [(3, 8), (5, 16), (3, 512)])
def test_k3p_plain_equals_jax_pack(n_slots, lanes):
    """K3p's plain version is JAX's bit-pack (block.py:1965-1969) bit for
    bit, and np.unpackbits(bitorder="little") reads it back."""
    rng = np.random.default_rng(n_slots * lanes)
    emit = rng.integers(0, 2, (33, n_slots, lanes)).astype(bool)
    eb = jnp.asarray(emit).astype(jnp.uint8).reshape(33, n_slots, lanes // 8, 8)
    want = np.asarray(jnp.sum(eb << jnp.arange(8, dtype=jnp.uint8), axis=-1)
                      .astype(jnp.uint8))
    p = blk.BlockParams(lanes=lanes, steps=33, mode="X" if n_slots == 5 else "R")
    got = blk.pack_emit(p, torch.from_numpy(emit))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.unpackbits(got.numpy(), axis=-1, bitorder="little").astype(bool), emit)


def test_k1_chain_arm_equals_jax():
    """K1's chain arm on JAX's payload of the second block: the states, the
    words used, out[1], the tables and the final bucket table."""
    st1, _, n, _, (_, n_words, states, stream), dec = chained_pair()
    pj, pt = chain_params()
    st = blk.chain_state_from_numpy(st1, "cpu")
    rolz = blk.remap_chain_ment(pt, st["ment"])
    x, used, out = blk.decode_scan(
        pt, torch.from_numpy(states.astype(np.int64)),
        torch.from_numpy(stream.astype(np.int32)), n, st["tables"], rolz,
        prev=st["prev"])
    np.testing.assert_array_equal(x.numpy(), dec[0].astype(np.int64))
    assert used == int(dec[1]) == n_words
    np.testing.assert_array_equal(out.numpy(), dec[2])
    for k, v in ppm.tables_to_numpy(st["tables"]).items():
        np.testing.assert_array_equal(v, dec[3][k], err_msg=k)
    np.testing.assert_array_equal(blk.rolz_to_numpy(rolz), dec[4])
    blk._check_drain(x.numpy(), used, n_words)


def test_block_chained_api_carries_the_state():
    """encode_block_chained / decode_block_chained: the JAX block's state1
    seeds the port's next block, whose payload and state1 are JAX's."""
    st1, buf, n, enc, (payload, *_), dec = chained_pair()
    pj, pt = chain_params()
    data = buf.reshape(-1)[:n]
    st = blk.chain_state_from_numpy(st1, "cpu")
    got, st2 = blk.encode_block_chained(data, pt, st, "cpu")
    assert got == payload
    np.testing.assert_array_equal(blk.rolz_to_numpy(st2["ment"]), enc[5])
    np.testing.assert_array_equal(st2["prev"].numpy(), buf)
    raw, st3 = blk.decode_block_chained(payload, n, pt, st, "cpu")
    np.testing.assert_array_equal(raw, data)
    back = blk.chain_state_to_numpy(st3)
    np.testing.assert_array_equal(back["ment"], dec[4])
    np.testing.assert_array_equal(back["prev"], dec[2])
    for k, v in back["tables"].items():
        np.testing.assert_array_equal(v, dec[3][k], err_msg=k)
    # state0 is the caller's: neither call changed it
    np.testing.assert_array_equal(blk.chain_state_to_numpy(st)["ment"], st1["ment"])
    for k, v in ppm.tables_to_numpy(st["tables"]).items():
        np.testing.assert_array_equal(v, st1["tables"][k], err_msg=k)


# ---- refusals --------------------------------------------------------------


def test_chain_refuses_the_static_profile():
    """crf has no adaptive models to carry: both packages refuse."""
    data = np.zeros(100, np.uint8)
    kw = dict(lanes=8, steps=128, mode="F", min_len=6, o3_bits=12,
              rolz_bits=10, rolz_depth=16)
    for pkg, args in ((jcon, ()), (con, ("cpu",))):
        fcp = pkg.ContainerParams(codec=b"F", block=(
            jblk if pkg is jcon else blk).BlockParams(**kw))
        with pytest.raises(ValueError, match="adaptive-model codec"):
            pkg.encode_stream(data, io.BytesIO(), fcp, *args, chain=True)


def test_chain_match_needs_chain():
    jcp, tcp = cps(b"R", True)
    data = np.zeros(100, np.uint8)
    with pytest.raises(ValueError, match="chain_match requires chain mode"):
        jcon.encode_stream(data, io.BytesIO(), jcp)
    with pytest.raises(ValueError, match="chain_match requires chain mode"):
        con.encode_stream(data, io.BytesIO(), tcp, "cpu")


@pytest.mark.parametrize("kw", [dict(mode="X"), dict(mode="P"),
                                dict(mode="R", flexible=False),
                                dict(mode="R", match=False)])
def test_chain_match_block_params_refusals(kw):
    """chain_match is mode R with the match layer and the flexible parse:
    -C under crx, crp or -f0 is refused by both packages' BlockParams."""
    kw = dict(GEO, chain_match=True, **kw)
    for mod in (jblk, blk):
        with pytest.raises(ValueError, match="chain_match requires mode R"):
            mod.BlockParams(**kw)


@pytest.mark.parametrize("argv", [["crx", "-C"], ["crp", "-C"], ["crz", "-f0", "-C"]])
def test_cli_chain_match_refusals(argv, tmp_path):
    src = tmp_path / "a"
    src.write_bytes(b"x" * 100)
    with pytest.raises(ValueError, match="chain_match requires mode R"):
        cli.run(argv[0], ["e", str(src), str(tmp_path / "b")] + argv[1:], device="cpu")


def test_chain_match_refuses_the_scan_finder(monkeypatch):
    """-C takes its candidates from the sort finder only: under
    CPX_R_FINDER=scan both packages refuse to encode (a geometry no other
    test traces, so that JAX traces it here)."""
    monkeypatch.setattr(jblk, "_R_FINDER", "scan")
    monkeypatch.setitem(blk._ENV, "CPX_R_FINDER", "scan")
    jcp, tcp = cps(b"R", True, steps=72)
    data = word_salad(100)
    with pytest.raises(ValueError, match="only the sort finder"):
        jcon.encode_stream(data, io.BytesIO(), jcp, chain=True)
    with pytest.raises(ValueError, match="only the sort finder"):
        con.encode_stream(data, io.BytesIO(), tcp, "cpu", chain=True)


@pytest.mark.parametrize("spec", ["0", "1", "2"])
def test_chain_spec_knob(spec, monkeypatch):
    """CPX_CHAIN_SPEC picks a schedule of the same bytes: "1" the
    speculative one, "0" the sequential one, in both packages; the port
    refuses any other value."""
    monkeypatch.setenv("CPX_CHAIN_SPEC", spec)
    jcp, tcp = cps(b"R")
    data = word_salad(2 * tcp.block.capacity + 5)
    if spec == "2":
        with pytest.raises(NotImplementedError, match="CPX_CHAIN_SPEC"):
            port_encode(tcp, data, dictionary=False, chain=True)
        return
    assert port_encode(tcp, data, dictionary=False, chain=True) == jax_encode(
        jcp, data, dictionary=False, chain=True)


def test_header_chain_flags_read_back():
    """read_header sets chain_match from F_CHAIN_MATCH, and keeps refusing
    F_CHAIN_MATCH without F_CHAIN."""
    jcp, _ = cps(b"R", True)
    for flags, ok in ((con.F_CHAIN, True), (con.F_CHAIN | con.F_CHAIN_MATCH, True),
                      (con.F_CHAIN_MATCH, False)):
        f = io.BytesIO()
        jcon.write_header(f, jcp if flags & con.F_CHAIN_MATCH else
                          dataclasses.replace(jcp, block=dataclasses.replace(
                              jcp.block, chain_match=False)), flags=flags)
        f.seek(0)
        if not ok:
            with pytest.raises(ValueError, match="F_CHAIN_MATCH without F_CHAIN"):
                con.read_header(f)
            continue
        cp, got = con.read_header(f)
        assert got == flags
        assert cp.block.chain_match == bool(flags & con.F_CHAIN_MATCH)
