"""K3b (the payload's stream compaction) and K3's quotient against the JAX
package, on the CPU.

- ``compact_stream_plain`` and the port's ``_pack_payload`` (K3b, then
  ``_payload_bytes``) against JAX's ``_pack_payload`` on masks and words
  made from a numpy seed, at three and five slots, S=8/T=64 and
  S=512/T=32, an all-silent and an all-emitting row among them; exactly.
- The block axis: G = 4 blocks of different n through the batched
  compaction, each block's payload JAX's.
- Payloads of JAX's own ``_encode_passes`` (modes R and X, S=8/T=64).
- K3's put: csrc/rans.cu divides x by f through the reciprocal m =
  (2^32 - 1) / f, as umulhi(x, m) and one correction, and tests the
  emission against a bound made from f; a numpy mirror of that put against
  the reference put (x >> 17 >= f, x // f, x % f) for every f in [1,
  2^15].

The CUDA kernels are held to these plain versions by
test_torch_kernels.py, on a card.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu.codec import block as jblk
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.ops.rans_scalar import M
from comprox_tpu_torch.utils import build

from test_block import corpus

torch.set_num_threads(1)

U32 = np.uint64(0xFFFFFFFF)


def mask_words(rng, steps, n_slots, lanes):
    """K3's outputs as numpy: states [S] int64, emit [T, n_slots, S] bool
    (one row silent, one emitting on every lane), words int32 (u16
    values), and K3p's bit-pack of emit."""
    emit = rng.random((steps, n_slots, lanes)) < 0.3
    emit[0, 0] = False
    emit[steps // 2, n_slots - 1] = True
    words = rng.integers(0, 1 << 16, (steps, n_slots, lanes)).astype(np.int32)
    states = rng.integers(1 << 16, 1 << 32, lanes).astype(np.int64)
    packed = blk.pack_emit_plain(torch.from_numpy(emit)).numpy()
    return states, emit, words, packed


@pytest.mark.parametrize("n_slots", [3, 5])
@pytest.mark.parametrize("lanes,steps", [(8, 64), (512, 32)])
def test_compaction_and_payload_equal_jax(n_slots, lanes, steps):
    rng = np.random.default_rng(lanes * 10 + n_slots)
    states, emit, words, packed = mask_words(rng, steps, n_slots, lanes)
    want = jblk._pack_payload(states, packed, words)
    nw, stream = blk.compact_stream_plain(torch.from_numpy(packed), torch.from_numpy(words))
    assert nw.dtype == torch.int32 and nw.shape == ()
    assert stream.dtype == torch.int16 and stream.shape == (steps * n_slots * lanes,)
    assert int(nw) == int(emit.sum())
    np.testing.assert_array_equal(stream[: int(nw)].numpy().view(np.uint16),
                                  words[emit].astype(np.uint16))
    assert not stream[int(nw):].any()
    st, pk, wd = (torch.from_numpy(a) for a in (states, packed, words))
    assert blk._payload_bytes(st, nw, stream) == want
    assert blk._payload_bytes(st, int(nw), stream) == want
    assert blk._pack_payload(st, pk, wd) == want


def test_block_axis_compaction_equals_jax():
    """G = 4 blocks of different n (one full, one of 300 bytes, two short
    by 17 and 101 bytes) through the batched encode and the batched
    compaction: each block's count, stream segment and payload are its
    own, JAX's ``_pack_payload`` of its K3 outputs."""
    p = blk.BlockParams(lanes=8, steps=64, mode="R", min_len=5, window=32,
                        o3_bits=14, rolz_bits=10, rolz_depth=16, flexible=False)
    cap = p.capacity
    ns = [cap, 300, cap - 17, cap - 101]
    buf = np.zeros((4, p.lanes, p.steps), np.uint8)
    for b, n in enumerate(ns):
        buf[b].reshape(-1)[:n] = corpus("text", n, seed=b)
    n_t = torch.tensor(ns, dtype=torch.int32)
    states, packed, words = blk.encode_passes_blocks(p, torch.from_numpy(buf), n_t)
    nw, streams = blk.compact_stream(packed, words)
    assert nw.shape == (4,) and streams.shape == (4, p.steps * 3 * p.lanes)
    assert len(set(nw.tolist())) == 4
    for b in range(4):
        one_nw, one = blk.compact_stream(packed[b], words[b])
        assert int(one_nw) == int(nw[b])
        assert torch.equal(streams[b], one)
        want = jblk._pack_payload(states[b].numpy(), packed[b].numpy(), words[b].numpy())
        assert blk._payload_bytes(states[b], nw[b], streams[b]) == want


@pytest.mark.parametrize("mode", ["R", "X"])
def test_payload_of_jax_encode_passes(mode):
    """JAX's own encode of a block (S=8, T=64): the port's compaction of
    its states, mask and words writes JAX's payload, and so does the
    port's whole encode."""
    kw = dict(R=dict(min_len=5), X=dict(min_len=6))[mode]
    p = dict(lanes=8, steps=64, mode=mode, window=32, o3_bits=14, rolz_bits=10,
             rolz_depth=16, flexible=False, **kw)
    pj, pt = jblk.BlockParams(**p), blk.BlockParams(**p)
    n = pt.capacity - 37
    buf = np.zeros((pt.lanes, pt.steps), np.uint8)
    buf.reshape(-1)[:n] = corpus("text", n, seed=3)
    x, emit, words, _, _ = jblk._encode_passes(pj, jnp.asarray(buf), jnp.int32(n))
    want = jblk._pack_payload(x, emit, words)
    x, emit, words = (torch.from_numpy(np.asarray(a).astype(t)) for a, t in (
        (x, np.int64), (emit, np.uint8), (words, np.int32)))
    assert emit.shape == (64, pt.n_slots, 1)
    nw, stream = blk.compact_stream(emit, words)
    assert blk._payload_bytes(x, nw, stream) == want
    assert blk.encode_block(buf.reshape(-1)[:n], pt, "cpu") == want


def put(x, c, f):
    """csrc/rans.cu's put of (c, f) on the state x (uint64 arrays holding
    u32 values): emit where x > lim = min(f 2^17 - 1, 2^32 - 1); xs = x >>
    16 where it emits; q = umulhi(xs, m) with m = (2^32 - 1) / f; the new
    state xs + c + q (M - f), plus M - f where xs - q f >= f (mod 2^32).
    Returns (emit, q corrected, the new state)."""
    mod = np.uint64(1 << 32)
    lim = np.minimum((f << np.uint64(17)) - np.uint64(1), U32)
    em = x > lim
    xs = np.where(em, x >> np.uint64(16), x)
    q = (xs * (U32 // f)) >> np.uint64(32)
    cmpl = (np.uint64(M) - f) % mod
    fix = (xs - q * f) >= f
    new = (xs + c + q * cmpl + np.where(fix, cmpl, np.uint64(0))) % mod
    return em, q + fix, new


def test_k3_put_is_exact():
    """The kernel's put against block.py's (rans.enc_put: (x >> 17) >= f,
    x // f, x % f) for every f in [1, 2^15] and a 16-bit f above it, at x
    in 0, 1, f - 1, f, f + 1, 2^32 - 2, 2^32 - 1, the largest x after an
    emission's shift and a seeded sample; c at 0 and M - f."""
    fs = np.concatenate([np.arange(1, M + 1), [M + 1, 0xFFFF]]).astype(np.uint64)
    f = fs[:, None]
    rng = np.random.default_rng(13)
    x = np.concatenate([
        np.zeros_like(f), np.ones_like(f), f - np.uint64(1), f, f + np.uint64(1),
        np.full_like(f, U32), np.full_like(f, U32 - np.uint64(1)),
        np.minimum((f << np.uint64(17)) - np.uint64(1), U32),
        rng.integers(0, 1 << 32, (f.size, 24), dtype=np.uint64)], axis=1)
    for c in (np.zeros_like(f), (np.uint64(M) - np.minimum(f, np.uint64(M))) % np.uint64(M)):
        em, q, new = put(x, c, f)
        want_em = (x >> np.uint64(17)) >= f
        xs = np.where(want_em, x >> np.uint64(16), x)
        np.testing.assert_array_equal(em, want_em)
        np.testing.assert_array_equal(q, xs // f)
        want = (((xs // f) << np.uint64(15)) + c + xs % f) % np.uint64(1 << 32)
        np.testing.assert_array_equal(new, want)
    # the formula the mirror stands for is the kernel's
    src = (build.CSRC / "rans.cu").read_text()
    for line in ("s.m[si] = 0xFFFFFFFFu / f;",
                 "s.lim[si] = (uint32_t)min(((unsigned long long)f << (32 - M_BITS)) - 1ull,",
                 "s.cmpl[si] = RANS_M - f;",
                 "const bool em = x > cur.lim[si];",
                 "const uint32_t xs = em ? x >> 16 : x;",
                 "const uint32_t q = __umulhi(xs, cur.m[si]);",
                 "const uint32_t rem = xs - q * cur.f[si];",
                 "x = xs + cur.c[si] + q * cur.cmpl[si];",
                 "if (rem >= cur.f[si]) x += cur.cmpl[si];"):
        assert line in src, line


def test_k3b_wrapper_takes_the_plain_version_only_on_the_cpu():
    rng = np.random.default_rng(2)
    _, _, words, packed = mask_words(rng, 16, 3, 8)
    nw, stream = blk.compact_stream(torch.from_numpy(packed), torch.from_numpy(words))
    want = blk.compact_stream_plain(torch.from_numpy(packed), torch.from_numpy(words))
    assert torch.equal(nw, want[0]) and torch.equal(stream, want[1])
    with pytest.raises(ValueError, match="tensors on"):
        blk.compact_stream(torch.from_numpy(packed), torch.from_numpy(words).to("meta"))
