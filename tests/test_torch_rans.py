"""The port's rANS primitives against the scalar oracle and the JAX package.

Inputs come from numpy with a fixed seed and go to both sides; every
comparison is exact (the coder is integer arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu.ops import rans as jrans
from comprox_tpu.ops import rans_scalar as rs
from comprox_tpu_torch.ops import rans

# the plain versions run many tiny ops: more intra-op threads would only
# contend with the other test workers
torch.set_num_threads(1)

S = 64


def _events(rng, n):
    tot = rng.integers(1, rs.M + 1, n)
    frq = np.array([rng.integers(1, t + 1) for t in tot])
    cum = np.array([rng.integers(0, t - f + 1) for t, f in zip(tot, frq)])
    return cum, frq, tot


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _states(rng, n):
    return rng.integers(rs.RANS_L, 1 << 32, n, dtype=np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_norm_cf_matches_scalar_and_jax(seed):
    rng = np.random.default_rng(seed)
    cum, frq, tot = _events(rng, S)
    c, f = rans.norm_cf(_t(cum), _t(frq), _t(tot))
    jc, jf = jrans.norm_cf(jnp.asarray(cum), jnp.asarray(frq), jnp.asarray(tot))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    for i in range(S):
        assert (int(c[i]), int(f[i])) == rs.norm_cf(int(cum[i]), int(frq[i]),
                                                    int(tot[i]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_enc_put_matches_scalar_and_jax(seed):
    rng = np.random.default_rng(seed)
    cum, frq, tot = _events(rng, S)
    c, f = rans.norm_cf(_t(cum), _t(frq), _t(tot))
    x = _states(rng, S)
    # states must lie in [2f, f << 17) before a put, as the encoder keeps them
    x = np.maximum(x, 2 * f.numpy())
    xn, emit, word = rans.enc_put(_t(x), c, f)
    jx, jemit, jword = jrans.enc_put(
        jnp.asarray(x, jnp.uint32), jnp.asarray(c.numpy(), jnp.uint32),
        jnp.asarray(f.numpy(), jnp.uint32),
    )
    np.testing.assert_array_equal(xn.numpy(), np.asarray(jx).astype(np.int64))
    np.testing.assert_array_equal(emit.numpy(), np.asarray(jemit))
    np.testing.assert_array_equal(
        word.numpy()[emit.numpy()], np.asarray(jword)[np.asarray(jemit)]
    )
    for i in range(S):
        enc = rs.RansEncoder()
        enc.x = int(x[i])
        enc.put_normalized(int(c[i]), int(f[i]))
        assert enc.x == int(xn[i])
        assert bool(enc._rev_words) == bool(emit[i])


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_primitives_match_jax(seed):
    rng = np.random.default_rng(seed)
    cum, frq, tot = _events(rng, S)
    x = _states(rng, S)
    c, f = rans.norm_cf(_t(cum), _t(frq), _t(tot))
    ju = lambda a: jnp.asarray(np.asarray(a), jnp.uint32)  # noqa: E731
    slot = rans.dec_slot(_t(x))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jrans.dec_slot(ju(x))))
    tgt = rans.dec_target(slot, _t(tot))
    np.testing.assert_array_equal(
        tgt.numpy(), np.asarray(jrans.dec_target(ju(slot), ju(tot)))
    )
    for i in range(S):
        assert int(tgt[i]) == rs.decode_target(int(slot[i]), int(tot[i]))
    xt, need = rans.dec_advance(_t(x), c, f)
    jxt, jneed = jrans.dec_advance(ju(x), ju(c), ju(f))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(jxt).astype(np.int64))
    np.testing.assert_array_equal(need.numpy(), np.asarray(jneed))
    word = rng.integers(0, 1 << 16, S)
    xr = rans.dec_renorm(xt, need, _t(word))
    jxr = jrans.dec_renorm(jxt, jneed, jnp.asarray(word, jnp.uint16))
    np.testing.assert_array_equal(xr.numpy(), np.asarray(jxr).astype(np.int64))


def test_identity_select_and_init():
    c, f = rans.identity_cf((5,), "cpu")
    assert c.tolist() == [0] * 5 and f.tolist() == [rs.M] * 5
    act = torch.tensor([True, False, True, False, True])
    sc, sf = rans.select_cf(act, torch.full((5,), 7), torch.full((5,), 9))
    assert sc.tolist() == [7, 0, 7, 0, 7]
    assert sf.tolist() == [9, rs.M, 9, rs.M, 9]
    assert rans.init_states(8, "cpu").tolist() == [rs.RANS_L] * 8
    # the identity event is a no-op on any state
    x = _t(_states(np.random.default_rng(3), 5))
    xn, emit, _ = rans.enc_put(x, *rans.identity_cf((5,), "cpu"))
    assert torch.equal(xn, x) and not emit.any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("lanes", [8, 64, 512])
def test_stream_window_read_matches_jax(seed, lanes):
    """Lane-ordered word reads, with the start near the stream tail where
    the JAX dynamic_slice clamps it."""
    rng = np.random.default_rng(seed)
    length = 3 * lanes + 16
    stream = rng.integers(0, 1 << 16, length).astype(np.uint16)
    need = rng.random(lanes) < rng.random()
    for start in (0, 5, length - lanes, length - lanes + 3, length - 1):
        w, used = rans.stream_window_read(
            torch.from_numpy(stream.astype(np.int32)), start,
            torch.from_numpy(need),
        )
        win = jnp.asarray(stream)[
            min(start, length - lanes) : min(start, length - lanes) + lanes
        ]
        jw, joff = jrans.stream_window_read(
            win, jnp.asarray(need), jnp.uint32(0)
        )
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        assert used == int(joff) == int(need.sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_lane_stream_roundtrip_against_scalar(seed):
    """Encode one lane's events with the port (backward), decode them with
    the scalar decoder: the streams are the oracle's."""
    rng = np.random.default_rng(seed)
    events = [tuple(map(int, e)) for e in zip(*_events(rng, 200))]
    x = rans.init_states(1, "cpu")
    words = []
    for cum, frq, tot in reversed(events):
        c, f = rans.norm_cf(_t([cum]), _t([frq]), _t([tot]))
        x, emit, word = rans.enc_put(x, c, f)
        if bool(emit[0]):
            words.append(int(word[0]))
    state, oracle_words = rs.encode_symbols(events)
    assert int(x[0]) == state
    assert words[::-1] == oracle_words
