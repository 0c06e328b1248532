"""K5, the rank scan of the flexible parse: the port's plain version
against the JAX package's ``_rolz_rank_scan``, exactly — once on the JAX
finder's proposals, once chained after the port's own finder."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu_torch.codec import block as blk

from test_torch_block import _jax_search
from test_torch_sortfind import (CASES, block_buf, jax_props, jax_rank, params,
                                 props_grid)

torch.set_num_threads(1)


def jax_cands(pj, buf, n, props):
    outs, fill = jax_rank(pj, jnp.asarray(buf), jnp.int32(n), props)
    return np.stack([np.asarray(o) for o in outs] + [np.asarray(fill)])


@pytest.mark.parametrize("feed", ["jax_proposals", "chained"])
@pytest.mark.parametrize("name,geo,short", CASES)
def test_rank_scan_equals_jax(name, geo, short, feed):
    pj, pt = params(geo)
    buf, n = block_buf(name, pj, short)
    props = jax_props(pj, jnp.asarray(buf), jnp.int32(n))
    ref = jax_cands(pj, buf, n, props)
    inp = torch.from_numpy(buf)
    if feed == "chained":
        grid = blk.sort_candidates(pt, inp, n)
    else:
        grid = torch.from_numpy(props_grid(pj, props))
    rolz = blk._init_rolz(pt, "cpu")
    got = blk.rank_scan(pt, inp, n, grid, rolz)
    assert got.dtype == torch.int32 and got.shape[0] == 3 * 5 + 1
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name,geo,short", CASES[:4] + CASES[-3:-2])
def test_rank_scan_leaves_the_search_scans_table(name, geo, short):
    """The bucket table evolves by position only: after the rank scan it is
    the table the JAX search scan ends with (and the decoder replays)."""
    pj, pt = params(geo)
    buf, n = block_buf(name, pj, short)
    _, rolz_j = _jax_search(pj, jnp.asarray(buf), jnp.int32(n))
    inp = torch.from_numpy(buf)
    rolz = blk._init_rolz(pt, "cpu")
    blk.rank_scan(pt, inp, n, blk.sort_candidates(pt, inp, n), rolz)
    np.testing.assert_array_equal(blk.rolz_to_numpy(rolz), np.asarray(rolz_j))


@pytest.mark.parametrize("seed", [0, 1])
def test_rank_is_a_sum_over_equal_positions(seed):
    """A proposal with no source (src = -1) matches every empty slot: the
    rank grid holds the sum of their recency ranks, as JAX's does, and a
    zeroed length passes its src through."""
    pj, pt = params("ctx3_dec1")
    rng = np.random.default_rng(seed)
    buf, n = block_buf("text", pj, 0)
    grid = rng.integers(-1, 40, (8, pt.steps, pt.lanes)).astype(np.int32)
    grid[0::2] = rng.integers(0, 9, (4, pt.steps, pt.lanes))
    grid[1] = -1
    flat = [jnp.asarray(np.ascontiguousarray(g.T).reshape(-1)) for g in grid]
    props = [(flat[2 * k], flat[2 * k + 1]) for k in range(4)]
    ref = jax_cands(pj, buf, n, props)
    got = blk.rank_scan(pt, torch.from_numpy(buf), n, torch.from_numpy(grid),
                        blk._init_rolz(pt, "cpu"))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[2].max() > pt.rolz_depth, "summed ranks of the empty slots"
    np.testing.assert_array_equal(got[1::3][:4].numpy(), grid[1::2])
