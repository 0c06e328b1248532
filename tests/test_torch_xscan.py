"""The per-step search route of the port (``CPX_X_FINDER=scan``, the KSx
pass; ``CPX_R_FINDER=scan`` for mode R) against the JAX package.

KSx runs in its plain PyTorch version here (CPU tensors) and is held to the
scan of ``_search_body`` on the same seeded input at S=8/T=64 and
S=512/T=32: the six grids (length, src, len2, cand, len3, src3) and the
three encoder tables (the content-keyed and the context-keyed bucket table,
``xshort``), tolerance 0.  Whole payloads under the scan finder, flexible
and greedy, equal the JAX package's and decode.

``_X_FINDER`` / ``_R_FINDER`` bind at import in both packages and JAX's
``_encode_passes`` is jitted with only the block parameters static: a test
that flips a finder sets both modules' values and uses a geometry that no
other test traces.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu.codec import block as jblk
from comprox_tpu_torch.codec import block as blk

from test_block import corpus

torch.set_num_threads(1)

SMALL = dict(lanes=8, steps=64, mode="X", min_len=6, window=32, o3_bits=14,
             rolz_bits=10, rolz_depth=16)
WIDE = dict(SMALL, lanes=512, steps=32, window=250, rolz_ctx_bytes=4)
GEO = {"small": SMALL, "wide": WIDE}
CASES = [("text", "small", 0), ("zeros", "small", 0), ("period7", "small", 3),
         ("random", "small", 0), ("lowentropy", "small", 37),
         ("text", "small", 505), ("text", "small", 511),
         ("text", "wide", 100), ("period7", "wide", 0), ("lowentropy", "wide", 7)]


def params(geo, **kw):
    kw = dict(GEO[geo] if isinstance(geo, str) else geo, **kw)
    return jblk.BlockParams(**kw), blk.BlockParams(**kw)


def block_buf(name, p, short, seed=1):
    n = p.capacity - short
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    buf.reshape(-1)[:n] = corpus(name, n, seed=seed)
    return buf, n


@functools.partial(jax.jit, static_argnums=0)
def jax_search_scan(p, inp, n):
    """The scan of ``_search_and_parse``'s else-branch, with its carry."""
    inp_flat = inp.reshape(-1)
    inp_pad = jnp.pad(inp, ((0, 0), (0, p.window + 1)))
    body = functools.partial(jblk._search_body, p, inp_pad,
                             jblk._pack_words(inp_flat), n)
    return jax.lax.scan(body, jblk._init_carry(p, enc_side=True, search=True),
                        jnp.arange(p.steps, dtype=jnp.int32))


def finder(monkeypatch, knob, value):
    monkeypatch.setattr(jblk, "_" + knob, value)
    monkeypatch.setitem(blk._ENV, "CPX_" + knob, value)


# ---------------------------------------------------------------- KSx ------


def test_content_hashes_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 32, 2048, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 2048, dtype=np.uint64).astype(np.uint32)
    a[:3], b[:3] = [0, 0x20202020, 0xFFFFFFFF], [0, 0x20202020, 0xFFFFFFFF]
    for bits in (10, 18):
        np.testing.assert_array_equal(
            blk.x_hash8(torch.from_numpy(a.astype(np.int64)),
                        torch.from_numpy(b.astype(np.int64)), bits).numpy(),
            np.asarray(jblk.x_hash8(jnp.asarray(a), jnp.asarray(b), bits)))
    win = rng.integers(0, 256, (512, 9), dtype=np.uint8)
    np.testing.assert_array_equal(
        blk.x_hash6(torch.from_numpy(win.astype(np.int32))).numpy(),
        np.asarray(jblk.x_hash6(jnp.asarray(win.astype(np.int32)))))


@pytest.mark.parametrize("name,geo,short", CASES)
def test_search_scan_x_equals_jax(name, geo, short):
    """The six grids at every position (inactive lanes and lengths below 0
    past the block's end included) and the three tables after the block."""
    pj, pt = params(geo)
    buf, n = block_buf(name, pj, short)
    c, outs = jax_search_scan(pj, jnp.asarray(buf), jnp.int32(n))
    tabs = blk._init_xsearch(pt, "cpu")
    got = blk.search_scan(pt, torch.from_numpy(buf), n, tabs)
    assert got.dtype == torch.int32 and got.shape == (6, pt.steps, pt.lanes)
    for k, name_k in enumerate(("length", "src", "len2", "cand", "len3", "src3")):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(outs[k]),
                                      err_msg=name_k)
    for tab, key in zip(tabs, ("rolz_ent", "xctx_ent", "xshort")):
        np.testing.assert_array_equal(blk.rolz_to_numpy(tab), np.asarray(c[key]),
                                      err_msg=key)
    if name not in ("random",) and n > 64:
        assert (got[0] > 0).any() or (got[2] > 0).any() or (got[4] > 0).any()


@pytest.mark.parametrize("kw", [dict(top_k=1), dict(top_k=8, probe=8),
                                dict(rolz_depth=8, rolz_bits=6)])
def test_search_scan_x_other_search_knobs(kw):
    """A shallow and a deep top-k, a short probe, crowded buckets."""
    pj, pt = params("small", **kw)
    buf, n = block_buf("text", pj, 9, seed=5)
    c, outs = jax_search_scan(pj, jnp.asarray(buf), jnp.int32(n))
    tabs = blk._init_xsearch(pt, "cpu")
    got = blk.search_scan(pt, torch.from_numpy(buf), n, tabs)
    np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(g) for g in outs]))
    for tab, key in zip(tabs, ("rolz_ent", "xctx_ent", "xshort")):
        np.testing.assert_array_equal(blk.rolz_to_numpy(tab), np.asarray(c[key]))


def test_search_scan_checks_its_tables():
    _, pt = params("small")
    with pytest.raises(ValueError, match="two bucket tables"):
        blk.search_scan(pt, torch.zeros((8, 64), dtype=torch.uint8), 1,
                        blk._init_xsearch(pt, "cpu")[:2])


# ------------------------------------------------- payloads, scan route ----


@pytest.mark.parametrize("flexible", [True, False])
@pytest.mark.parametrize("name,geo,short",
                         [("text", "small", 0), ("period7", "small", 3),
                          ("lowentropy", "small", 37), ("text", "small", 510),
                          ("text", "wide", 100)])
def test_scan_route_payload_equals_jax(monkeypatch, name, geo, short, flexible):
    finder(monkeypatch, "X_FINDER", "scan")
    pj, pt = params(geo, o3_bits=13, flexible=flexible)  # traced here only
    data = corpus(name, pj.capacity - short, seed=8)
    payload = jblk.encode_block(data, pj)
    assert blk.encode_block(data, pt, "cpu") == payload
    np.testing.assert_array_equal(blk.decode_block(payload, data.size, pt, "cpu"), data)
    np.testing.assert_array_equal(jblk.decode_block(payload, data.size, pj), data)


def test_scan_route_differs_from_sort_route(monkeypatch):
    _, pt = params("wide", o3_bits=13)
    data = corpus("text", pt.capacity - 100, seed=8)
    sort_payload = blk.encode_block(data, pt, "cpu")
    monkeypatch.setitem(blk._ENV, "CPX_X_FINDER", "scan")
    scan_payload = blk.encode_block(data, pt, "cpu")
    assert scan_payload != sort_payload, "the finder must matter"
    np.testing.assert_array_equal(
        blk.decode_block(scan_payload, data.size, pt, "cpu"), data)


# -------------------------------------------------- mode R, scan + DP ------

SMALL_R = dict(lanes=8, steps=64, mode="R", min_len=5, window=32, o3_bits=13,
               rolz_bits=10, rolz_depth=16)
WIDE_R = dict(SMALL_R, lanes=512, steps=32, window=250, rolz_ctx_bytes=4,
              rolz_dec=2)


@pytest.mark.parametrize("name,kw,short",
                         [("text", SMALL_R, 0), ("period7", SMALL_R, 11),
                          ("lowentropy", SMALL_R, 37), ("zeros", SMALL_R, 0),
                          ("text", WIDE_R, 100)])
def test_r_finder_scan_flexible_equals_jax(monkeypatch, name, kw, short):
    """``CPX_R_FINDER=scan`` with the flexible parse: KS's one candidate goes
    through the price DP (K6 with one candidate); the JAX payload."""
    finder(monkeypatch, "R_FINDER", "scan")
    pj, pt = jblk.BlockParams(**kw), blk.BlockParams(**kw)
    data = corpus(name, pj.capacity - short, seed=8)
    payload = jblk.encode_block(data, pj)
    assert blk.encode_block(data, pt, "cpu") == payload
    np.testing.assert_array_equal(blk.decode_block(payload, data.size, pt, "cpu"), data)


def test_r_finder_scan_differs_from_sort(monkeypatch):
    pt = blk.BlockParams(**WIDE_R)
    data = corpus("text", pt.capacity - 100, seed=8)
    sort_payload = blk.encode_block(data, pt, "cpu")
    monkeypatch.setitem(blk._ENV, "CPX_R_FINDER", "scan")
    assert blk.encode_block(data, pt, "cpu") != sort_payload


@pytest.mark.parametrize("knob", ["CPX_X_FINDER", "CPX_R_FINDER"])
def test_unknown_finder_raises(monkeypatch, knob):
    monkeypatch.setitem(blk._ENV, knob, "chain")
    with pytest.raises(NotImplementedError, match=knob + ".*'sort' or 'scan'"):
        blk.encode_block(corpus("text", 100), blk.BlockParams(**SMALL), "cpu")
