"""K4, the sort finder of the flexible parse: the port's plain version
against the JAX package's ``sort_candidates`` in the configuration mode R
uses, on the same bytes, exactly (tolerance 0: integer arithmetic).

Also holds the helpers the K5 and K6 tests share: the corpora, the
geometries and the jitted JAX passes.
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

SMALL = dict(lanes=8, steps=64, mode="R", min_len=5, window=32, o3_bits=14,
             rolz_bits=10, rolz_depth=16)
GEOMETRIES = {
    "ctx3_dec1": SMALL,
    "ctx4_dec2": dict(SMALL, rolz_ctx_bytes=4, rolz_dec=2),
    "ctx3_dec2": dict(SMALL, rolz_dec=2),
    "ctx4_dec1": dict(SMALL, rolz_ctx_bytes=4),
    # the main path's ROLZ knobs at S=512, with small tables
    "wide": dict(SMALL, lanes=512, steps=32, rolz_ctx_bytes=4, rolz_dec=2),
}
# (corpus, geometry, bytes short of a full block)
CASES = [
    (name, geo, short)
    for name in ("text", "zeros", "period3", "random")
    for geo, short in (("ctx3_dec1", 0), ("ctx4_dec2", 37), ("ctx3_dec2", 0),
                       ("ctx4_dec1", 201))
] + [("text", "wide", 100), ("period3", "wide", 0), ("zeros", "wide", 3000)]


def flex_corpus(name, n, seed=1):
    if name == "period3":
        pat = np.random.default_rng(seed).integers(0, 256, 3, dtype=np.uint8)
        return np.tile(pat, n // 3 + 1)[:n]
    return corpus(name, n, seed=seed)


def params(geo):
    kw = GEOMETRIES[geo]
    return jblk.BlockParams(**kw), blk.BlockParams(**kw)


def block_buf(name, pj, short):
    n = pj.capacity - short
    buf = np.zeros((pj.lanes, pj.steps), np.uint8)
    buf.reshape(-1)[:n] = flex_corpus(name, n)
    return buf, n


@functools.partial(jax.jit, static_argnums=0)
def jax_props(p, inp, n):
    """JAX K4 as _search_and_parse calls it: [(len [N], src [N])]."""
    return jblk.sort_candidates(
        p, inp.reshape(-1), n, n_cands=jblk._R_CANDS,
        probe_from=jblk._R_PROBE, ctx_bytes=p.rolz_ctx_bytes,
        insert_dec=p.rolz_dec, fwd_chain=jblk._R_PROBE)


@functools.partial(jax.jit, static_argnums=0)
def jax_rank(p, inp, n, props):
    """JAX K5: (outs: 3 * (n_c + 1) grids [T, S], fill [T, S])."""
    inp_pad = jnp.pad(inp, ((0, 0), (0, p.window + 1)))
    return jblk._rolz_rank_scan(
        p, inp_pad, jblk._pack_words(inp.reshape(-1)), n, props)


@functools.partial(jax.jit, static_argnums=0)
def jax_parse(p, n, outs):
    """JAX K6: the reversed scan of _parse_body -> (take, src, idx)."""
    parse = functools.partial(jblk._parse_body, p, n, n_c=len(outs) // 3)
    ts = jnp.arange(p.steps, dtype=jnp.int32)
    _, dec = jax.lax.scan(parse, jnp.zeros((p.lanes, p.window), jnp.int32),
                          (ts,) + tuple(outs), reverse=True)
    return dec


def props_grid(pj, props):
    """The JAX proposals in the port's [2 * n_c, T, S] layout."""
    return np.stack([np.asarray(g).reshape(pj.lanes, pj.steps).T
                     for l, s in props for g in (l, s)])


def props_from_grid(pj, grid):
    flat = [jnp.asarray(np.ascontiguousarray(g.T).reshape(-1)) for g in grid]
    return [(flat[2 * k], flat[2 * k + 1]) for k in range(len(flat) // 2)]


@pytest.mark.parametrize("name,geo,short", CASES)
def test_sort_candidates_equals_jax(name, geo, short):
    pj, pt = params(geo)
    buf, n = block_buf(name, pj, short)
    ref = props_grid(pj, jax_props(pj, jnp.asarray(buf), jnp.int32(n)))
    got = blk.sort_candidates(pt, torch.from_numpy(buf), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if name != "random":
        assert (ref[0] > 0).any(), "the case must have matches"


@pytest.mark.parametrize("name,geo,short", CASES[:8])
def test_sort_positions_is_the_stable_sort(name, geo, short):
    """(key, position) order: keys ascending, equal keys by position; the
    invalid positions (no context, or past n) carry 0xFFFFFFFF."""
    pj, pt = params(geo)
    buf, n = block_buf(name, pj, short)
    bytes_pad = blk.pad_block(pt, torch.from_numpy(buf))
    assert bytes_pad.numel() == blk.pad_block_len(pt) and bytes_pad.numel() % 8 == 0
    hs, ps = blk.sort_positions(pt, bytes_pad, n)
    keys = blk.sort_keys_plain(pt, bytes_pad, n).numpy()
    flat = buf.reshape(-1).astype(np.uint64)
    cb = pt.rolz_ctx_bytes
    for i in (cb, cb + 1, n - 1):
        ctx = sum(int(flat[i - cb + j]) << (8 * j) for j in range(cb))
        assert keys[i] == ctx * 2654435761 % (1 << 32)
    assert (keys[:cb] == 0xFFFFFFFF).all() and (keys[n:] == 0xFFFFFFFF).all()
    order = np.lexsort((np.arange(keys.size), keys))
    np.testing.assert_array_equal(ps.numpy(), order)
    np.testing.assert_array_equal(hs.numpy(), keys[order])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_finder_helpers(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, 64, dtype=np.int64)
    x[::4] &= 0xFFFFFF00
    x[1::4] &= 0xFF000000
    x[2::8] = 0
    np.testing.assert_array_equal(
        blk._bytes_eq_count(torch.from_numpy(x)).numpy(),
        np.asarray(jblk._bytes_eq_count(jnp.asarray(x.astype(np.uint32)))))
    eq1 = rng.random(300) < 0.8
    diag = rng.random(300) < 0.8
    diag[-1] = False
    np.testing.assert_array_equal(
        blk._diag_run_len(torch.from_numpy(eq1), torch.from_numpy(diag)).numpy(),
        np.asarray(jblk._diag_run_len(jnp.asarray(eq1), jnp.asarray(diag))))


def test_short_extension_needs_the_diagonal_runs(monkeypatch):
    """With the word extension cut to 8 bytes the diagonal-run recovery
    supplies the long lengths: still JAX's grids."""
    monkeypatch.setattr(jblk, "_SORT_EXT", 8)
    monkeypatch.setattr(blk, "_SORT_EXT", 8)
    kw = dict(SMALL, o3_bits=13)  # a geometry no other test has traced
    pj, pt = jblk.BlockParams(**kw), blk.BlockParams(**kw)
    buf, n = block_buf("period3", pj, 10)
    props = jblk.sort_candidates(
        pj, jnp.asarray(buf.reshape(-1)), jnp.int32(n), n_cands=4,
        probe_from=16, ctx_bytes=3, insert_dec=1, fwd_chain=16)
    ref = props_grid(pj, props)
    assert ref[0].max() > 12
    np.testing.assert_array_equal(
        blk.sort_candidates(pt, torch.from_numpy(buf), n).numpy(), ref)
