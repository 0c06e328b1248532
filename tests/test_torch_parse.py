"""K6, the backward price DP of the flexible parse: the port's plain
version against the JAX package's reversed scan of ``_parse_body``,
exactly — once on the JAX rank scan's candidates, once chained after the
port's own finder and rank scan (then also against the decisions of
``_search_and_parse``).  Then the mode-F entry (two (len, src) candidates
priced by their distance bucket, the fast profile's prices) against the
non-R branch of ``_parse_body``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu.codec import block as jblk
from comprox_tpu.codec import fast as jfast
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec import fast as tfast

from test_torch_block import _jax_search_and_parse
from test_torch_sortfind import (CASES, block_buf, jax_parse, jax_props,
                                 jax_rank, params)

torch.set_num_threads(1)


@pytest.mark.parametrize("feed", ["jax_candidates", "chained"])
@pytest.mark.parametrize("name,geo,short", CASES)
def test_parse_scan_equals_jax(name, geo, short, feed):
    pj, pt = params(geo)
    buf, n = block_buf(name, pj, short)
    inp_j = jnp.asarray(buf)
    props = jax_props(pj, inp_j, jnp.int32(n))
    outs, fill = jax_rank(pj, inp_j, jnp.int32(n), props)
    take, src, idx = jax_parse(pj, jnp.int32(n), outs)
    ref = np.stack([np.asarray(g) for g in (take, src, idx, fill)])
    if feed == "chained":
        inp = torch.from_numpy(buf)
        cands = blk.rank_scan(pt, inp, n, blk.sort_candidates(pt, inp, n),
                              blk._init_rolz(pt, "cpu"))
        _, t2, s2, i2, f2 = _jax_search_and_parse(pj, inp_j, jnp.int32(n))
        for a, b in zip(ref, (t2, s2, i2, f2)):
            np.testing.assert_array_equal(a, np.asarray(b))
    else:
        cands = torch.from_numpy(
            np.stack([np.asarray(o) for o in outs] + [np.asarray(fill)]))
    got = blk.parse_scan(pt, n, cands)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if name != "random":
        assert (ref[0] >= pt.min_len).any(), "the case must take matches"


def _random_cands(rng, pt, max_len):
    g = np.zeros((16, pt.steps, pt.lanes), np.int32)
    for k in range(5):
        g[3 * k] = rng.integers(0, max_len + 1, g[0].shape)
        g[3 * k][rng.random(g[0].shape) < 0.5] = 0
        g[3 * k + 1] = rng.integers(-1, pt.capacity, g[0].shape)
        g[3 * k + 2] = rng.integers(0, 40, g[0].shape)
    g[15] = rng.integers(0, 17, g[0].shape)
    return g


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_parse_tie_rules_on_random_candidates(seed):
    """Dense random candidates (equal lengths, equal prices, short and
    over-long lengths) hit the three tie rules: longest length within a
    candidate, match over literal, later candidate over earlier."""
    pj, pt = params("ctx3_dec1")
    rng = np.random.default_rng(seed)
    g = _random_cands(rng, pt, pt.window)
    if seed % 2:  # the same candidate five times: every compare is a tie
        for k in range(1, 5):
            g[3 * k], g[3 * k + 2] = g[0], g[2]
    n = pt.capacity - 3 * seed
    take, src, idx = jax_parse(pj, jnp.int32(n), tuple(jnp.asarray(x) for x in g[:15]))
    got = blk.parse_scan(pt, n, torch.from_numpy(g))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(take))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(src))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got[3].numpy(), g[15])
    if seed % 2:
        taken = got[0].numpy() > 0
        np.testing.assert_array_equal(got[1].numpy()[taken], g[13][taken])


def test_parse_cost_saturates_and_no_candidate_never_wins(monkeypatch):
    """With the literal price inflated the cost-to-go reaches the ceiling
    2^22 - 1: positions with no admissible candidate still take the
    literal, and the decisions stay JAX's."""
    monkeypatch.setattr(jblk, "_P_LIT_R", 300000)
    monkeypatch.setattr(blk, "_P_LIT_R", 300000)
    kw = dict(lanes=8, steps=64, mode="R", min_len=5, window=32, o3_bits=12,
              rolz_bits=10, rolz_depth=16)  # a geometry traced nowhere else
    pj, pt = jblk.BlockParams(**kw), blk.BlockParams(**kw)
    rng = np.random.default_rng(7)
    g = _random_cands(rng, pt, 12)
    g[0:15:3][:, rng.random(g[0].shape) < 0.7] = 0
    n = pt.capacity
    parse = jblk._parse_body  # untraced: the patched price binds now
    cw = jnp.zeros((pt.lanes, pt.window), jnp.int32)
    ref = np.zeros((3, pt.steps, pt.lanes), np.int32)
    for t in range(pt.steps - 1, -1, -1):
        xs = (jnp.int32(t),) + tuple(jnp.asarray(x[t]) for x in g[:15])
        cw, dec = parse(pj, jnp.int32(n), cw, xs, n_c=5)
        ref[:, t] = np.stack([np.asarray(d) for d in dec])
    assert int(np.asarray(cw).max()) == blk._P_INF - 1
    got = blk.parse_scan(pt, n, torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got[:3], ref)
    none = (g[0:15:3] < pt.min_len).all(axis=0)
    assert none.any() and (got[0][none] == 0).all()


F_SMALL = dict(lanes=8, steps=64, mode="F", min_len=6, window=32)


def _jax_parse_f(pj, n, g, n_c, prices):
    """The non-R branch of _parse_body, step by step (untraced, so that
    patched prices bind): (take, src, idx) [3, T, S]."""
    px = jfast._search_params(pj)
    cw = jnp.zeros((pj.lanes, pj.window), jnp.int32)
    ref = np.zeros((3, pj.steps, pj.lanes), np.int32)
    for t in range(pj.steps - 1, -1, -1):
        xs = (jnp.int32(t),) + tuple(jnp.asarray(x[t]) for x in g)
        cw, dec = jblk._parse_body(px, jnp.int32(n), cw, xs, n_c=n_c, prices=prices)
        ref[:, t] = np.stack([np.asarray(d) for d in dec])
    return ref, np.asarray(cw)


def _random_cands_f(rng, pt, n_c, max_len):
    g = np.zeros((2 * n_c, pt.steps, pt.lanes), np.int32)
    for k in range(n_c):
        g[2 * k] = rng.integers(0, max_len + 1, g[0].shape)
        g[2 * k][rng.random(g[0].shape) < 0.5] = 0
        g[2 * k + 1] = rng.integers(-1, pt.capacity, g[0].shape)
    return g


@pytest.mark.parametrize("seed,n_c", [(0, 2), (1, 2), (2, 1), (3, 4)])
def test_parse_f_entry_on_random_candidates(seed, n_c):
    """Dense random (len, src) candidates, sources before and after the
    position and -1: the distance-bucket price and the three tie rules; the
    index output is 0 and xs carries no repeat pair."""
    pj, pt = jblk.BlockParams(**F_SMALL), blk.BlockParams(**F_SMALL)
    rng = np.random.default_rng(seed)
    g = _random_cands_f(rng, pt, n_c, pt.window)
    if seed % 2:  # the same candidate twice: every compare is a tie
        g[2], g[3] = g[0], g[1]
    n = pt.capacity - 5 * seed
    assert tfast._F_PRICES == jfast._F_PRICES[:3]  # JAX's fourth prices no F candidate
    ref, _ = _jax_parse_f(pj, n, g, n_c, jfast._F_PRICES)
    got = blk.parse_scan(pt, n, torch.from_numpy(g), prices=tfast._F_PRICES, n_c=n_c)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, pt.steps, pt.lanes)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[2] == 0).all() and (ref[0] >= pt.min_len).any()


def test_parse_f_prices_and_saturation():
    """Other prices than the defaults, a literal price that drives the
    cost-to-go to its ceiling 2^22 - 1, and min_len from the parameters."""
    kw = dict(F_SMALL, min_len=4)
    pj, pt = jblk.BlockParams(**kw), blk.BlockParams(**kw)
    rng = np.random.default_rng(11)
    g = _random_cands_f(rng, pt, 2, 12)
    g[0:4:2][:, rng.random(g[0].shape) < 0.7] = 0
    prices = (300000, 45, 9, 30)
    ref, cw = _jax_parse_f(pj, pt.capacity, g, 2, prices)
    assert int(cw.max()) == blk._P_INF - 1
    got = blk.parse_scan(pt, pt.capacity, torch.from_numpy(g), prices=prices, n_c=2)
    np.testing.assert_array_equal(got.numpy(), ref)
    taken = ref[0][ref[0] > 0]
    assert taken.size and taken.min() >= 4
    none = (g[0:4:2] < pt.min_len).all(axis=0)
    assert none.any() and (got[0].numpy()[none] == 0).all()


def test_parse_r_entry_is_unchanged_by_the_f_entry():
    """The same candidates through the R entry still give four grids with
    the recency index and the fill passed through."""
    pj, pt = params("ctx3_dec1")
    g = _random_cands(np.random.default_rng(5), pt, pt.window)
    got = blk.parse_scan(pt, pt.capacity, torch.from_numpy(g))
    assert tuple(got.shape) == (4, pt.steps, pt.lanes)
    take, src, idx = jax_parse(pj, jnp.int32(pt.capacity),
                               tuple(jnp.asarray(x) for x in g[:15]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got[3].numpy(), g[15])
