"""K6, the backward price DP of the flexible parse: the port's plain
version against the JAX package's reversed scan of ``_parse_body``,
exactly — once on the JAX rank scan's candidates, once chained after the
port's own finder and rank scan (then also against the decisions of
``_search_and_parse``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu.codec import block as jblk
from comprox_tpu_torch.codec import block as blk

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
