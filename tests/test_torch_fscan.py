"""Mode F under ``CPX_F_FINDER=scan``: the decisions come from mode X's
finder and parse (the JAX package's ``fast._fast_find_matches`` calls
``block._search_and_parse`` with the block's parameters in mode X), under
mode X's knobs: the X finder (``CPX_X_FINDER``: the sort finder K4x or the
search scan KSx), K6 at mode X's prices, K11 and K6 again with the repeat
pair (``-f0``: the longest candidate).  The port's decision grids and
payloads against the JAX package's on the same bytes, tolerance 0, at
S=8/T=64 and S=512/T=32, each block 17 bytes short of its capacity: the
grids in every case, the payloads in half of them (each geometry, X finder
and parse in one); the payload decodes under both packages.

Both packages read the finder knobs at import, and JAX's jit caches key on
the block parameters alone: each case sets the module attributes and
clears JAX's caches before and after, so that no trace of the sort route
answers for the scan route.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu.codec import block as jblk
from comprox_tpu.codec import fast as jfast
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec import fast as tfast

from test_fast import corpus

torch.set_num_threads(1)

GEOMETRIES = {
    "S8": dict(lanes=8, steps=64, mode="F", min_len=6, window=64),
    "S512": dict(lanes=512, steps=32, mode="F", min_len=6, window=250),
}
SHORT = 17  # bytes short of a full block


@pytest.fixture
def scan_route(monkeypatch):
    """``set(x_finder)``: both packages under CPX_F_FINDER=scan and that
    CPX_X_FINDER, JAX's caches cleared; cleared again at the end."""

    def set_(x_finder):
        monkeypatch.setattr(jfast, "_F_FINDER", "scan")
        monkeypatch.setattr(tfast, "_F_FINDER", "scan")
        monkeypatch.setattr(jblk, "_X_FINDER", x_finder)
        monkeypatch.setitem(blk._ENV, "CPX_X_FINDER", x_finder)
        jax.clear_caches()

    yield set_
    jax.clear_caches()


@functools.partial(jax.jit, static_argnums=0)
def jax_decisions(p, inp_flat, n):
    _, take, src = jfast._fast_find_matches(p, inp_flat, n)[:3]
    return take, src


def block_of(geo, flexible, seed=5):
    kw = dict(GEOMETRIES[geo], flexible=flexible)
    pj, pt = jblk.BlockParams(**kw), blk.BlockParams(**kw)
    data = corpus("text", pj.capacity - SHORT, seed=seed)
    buf = np.zeros(pj.capacity, np.uint8)
    buf[: data.size] = data
    return pj, pt, data, buf


# the payloads of half the cases (JAX's encode is a trace of its own), so
# that each geometry, X finder and parse has one
PAYLOAD_CASES = {("S8", "sort", True), ("S8", "scan", False), ("S512", "scan", True),
                 ("S512", "sort", False)}


@pytest.mark.parametrize("flexible", [True, False], ids=["flex", "f0"])
@pytest.mark.parametrize("x_finder", ["sort", "scan"])
@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_scan_route_decisions_and_payload_match_jax(geo, x_finder, flexible, scan_route):
    scan_route(x_finder)
    pj, pt, data, buf = block_of(geo, flexible)
    n = data.size
    take, src = jax_decisions(pj, jnp.asarray(buf), jnp.int32(n))
    inp = torch.from_numpy(buf.reshape(pt.lanes, pt.steps))
    dec = tfast._fast_find_matches(pt, inp, n)
    np.testing.assert_array_equal(dec[0].numpy(), np.asarray(take))
    np.testing.assert_array_equal(dec[1].numpy(), np.asarray(src))
    # the route is mode X's: the same grids as mode X's decisions on the block
    px = tfast._search_params(pt)
    assert torch.equal(dec, blk.x_decisions(px, inp, n))
    assert int((dec[0] > 0).sum()) > 0  # the block has matches
    got = tfast.encode_block_fast(data, pt, "cpu")
    np.testing.assert_array_equal(tfast.decode_block_fast(got, n, pt, "cpu"), data)
    if (geo, x_finder, flexible) not in PAYLOAD_CASES:
        return
    want = jfast.encode_block_fast(data, pj)
    assert got == want
    np.testing.assert_array_equal(jfast.decode_block_fast(want, n, pj), data)


def test_scan_route_differs_from_the_sort_route(scan_route):
    """The knob takes effect: at S=8/T=64 the scan route's payload is not
    the sort route's (the archives of the two routes differ)."""
    _, pt, data, _ = block_of("S8", True)
    sort_payload = tfast.encode_block_fast(data, pt, "cpu")
    scan_route("sort")
    scan_payload = tfast.encode_block_fast(data, pt, "cpu")
    assert scan_payload != sort_payload
    np.testing.assert_array_equal(tfast.decode_block_fast(scan_payload, data.size, pt, "cpu"),
                                  data)


def test_scan_route_takes_mode_x_knobs_not_mode_f_ones(scan_route, monkeypatch):
    """Under the scan route mode F's finder knobs play no part (a value the
    sort route refuses is not read) and mode X's are checked."""
    scan_route("sort")
    _, pt, data, _ = block_of("S8", True)
    base = tfast.encode_block_fast(data, pt, "cpu")
    monkeypatch.setattr(tfast, "_F_CANDS", 99)
    monkeypatch.setattr(tfast, "_F_PRICES", (1, 2, 3))
    assert tfast.encode_block_fast(data, pt, "cpu") == base
    monkeypatch.setenv("CPX_X_CANDS", "9")
    with pytest.raises(NotImplementedError, match="CPX_X_CANDS"):
        tfast.encode_block_fast(data, pt, "cpu")
    monkeypatch.setenv("CPX_X_CANDS", "3")
    monkeypatch.setenv("CPX_X_CTXCAND", "1")
    with pytest.raises(NotImplementedError, match="CPX_X_CTXCAND"):
        tfast.encode_block_fast(data, pt, "cpu")
