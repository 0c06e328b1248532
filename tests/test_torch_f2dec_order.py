"""K10's kernel order (``csrc/f2dec.cu``) mirrored in numpy against JAX.

The kernel builds the slot table in shared memory (each symbol's cum |
freq << 16 from one warp's scan; each slot's symbol by a warp taking a run
of slots 32 at a time, a lane's first symbol by a binary search over cum,
then stepped forward), and reads the stream through a ring of
``K10_RING`` words that ``cp.async`` refills up to the last event's
window start + the ring's size once it holds less than half a ring beyond
what the next step may read, after waiting for the refill before it (one
in flight at most); before a step's first barrier each thread waits for
the refills where the step may read past what has landed.
``mirror_slot_table`` and ``mirror_decode`` do the same in numpy, the ring
at a few times S so that it wraps many times, checking at every read that
the slot holds the word read and that its refill was waited for, and at
every refill that the slot it takes was read for the last time.  Their
results must equal JAX's ``_build_dec_table`` and ``_fast_decode_scan``
exactly, also on a stream cut to its ``n_words`` words, where the last
windows clamp.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from comprox_tpu.codec import fast as jfast
from comprox_tpu_torch.codec import fast as tfast

from test_torch_fast import CASES, jax_stages, params

M, M_BITS, RANS_L = tfast.M, tfast.M_BITS, int(tfast.RANS_L)
W = tfast.W_SYM


def kernel_warps(S):
    """k10_decode's warps at S lanes: one lane a thread, or adjacent lanes
    a thread as ppm_r.cuh::lanes_per_thread gives them above 1024 lanes a
    CTA."""
    lpt = 1
    while lpt < 8 and lpt * 1024 < S:
        lpt *= 2
    return -(-(-(-S // lpt)) // 32)


def mirror_slot_table(freq, nwarps):
    """build_slot_table at ``nwarps`` warps: (cf [W] = cum | freq << 16,
    sym [M])."""
    freq = np.asarray(freq, np.int64)
    per = -(-W // 32)
    cum = np.zeros(W + 1, np.int64)
    sums = [int(freq[l * per : min((l + 1) * per, W)].sum()) for l in range(32)]
    for lane in range(32):  # warp 0: a run of symbols a lane, its scan
        run = sum(sums[:lane])
        for u in range(lane * per, min((lane + 1) * per, W)):
            cum[u] = run
            run += int(freq[u])
        if lane == 31:
            cum[W] = run
    cf = cum[:W] | (freq << 16)
    sym = np.full(M, -1, np.int64)
    span = -(-(M // nwarps) // 32) * 32
    for w in range(nwarps):
        s0, s1 = w * span, min(w * span + span, M)
        for lane in range(32):
            if s0 + lane >= s1:
                continue
            lo, hi = 0, W  # cum[lo] <= s, and cum[hi] > s or hi = W
            while hi - lo > 1:
                mid = (lo + hi) >> 1
                if cum[mid] <= s0 + lane:
                    lo = mid
                else:
                    hi = mid
            for s in range(s0 + lane, s1, 32):
                while lo + 1 < W and cum[lo + 1] <= s:
                    lo += 1
                sym[s] = lo
    assert (sym >= 0).all()
    return cf, sym


def mirror_decode(S, freq, states, stream, n_tok, ring_words):
    """k10_decode in numpy with its ring of ``ring_words`` words: (states,
    words used, sym, xtr [n_tok]).  Every read is checked against the
    ring's slot and its refill's wait."""
    stream = np.asarray(stream, np.int64)
    L = stream.shape[0]
    assert L >= S and 4 * S <= ring_words and ring_words & (ring_words - 1) == 0
    cf, symtab = mirror_slot_table(freq, kernel_warps(S))
    slot_word = np.full(ring_words, -1, np.int64)  # the word each slot holds
    slot_group = np.zeros(ring_words, np.int64)  # the refill that wrote it
    done = 0  # refills waited for: those numbered < done

    def refill(lo, hi, group, dead):
        for w in range(lo, hi):
            old = slot_word[w & (ring_words - 1)]
            assert old < dead  # read for the last time before that barrier
            slot_word[w & (ring_words - 1)] = w
            slot_group[w & (ring_words - 1)] = group

    fill = min(ring_words, L)
    refill(0, fill, 0, 0)
    groups, landed = 1, 0  # the words below `landed` are in the ring
    x = np.asarray(states, np.int64).copy()
    base = 0
    last_start = L - S
    sym_g = np.zeros(n_tok, np.int64)
    xtr_g = np.zeros(n_tok, np.int64)
    lanes = np.arange(S)
    for t in range(-(-n_tok // S)):
        if min(base + 3 * S, L) > landed:  # wait for every refill
            done, landed = groups, fill
        act = t * S + lanes < n_tok
        sym = symtab[x & (M - 1)]
        cfs = cf[sym]
        is_m = act & (sym >= 256)
        mc = np.where(is_m, sym - 256, 0)
        db, lb = mc // 13, mc % 13
        len_bits = np.where(lb >= 8, lb - 5, 0)
        dist_bits = np.where(is_m & (db < 24), db, 0)
        tbits = np.where(is_m, len_bits + dist_bits, 0)
        b1 = np.minimum(tbits, M_BITS)
        vals = [np.zeros(S, np.int64), np.zeros(S, np.int64)]
        for s in range(3):
            st = max(0, min(base, last_start))
            if s == 0:
                c = np.where(act, cfs & 0xFFFF, 0)
                f = np.where(act, cfs >> 16, M)
            else:  # a uniform event: f = 2^k, its quotient a shift
                k = M_BITS - (b1 if s == 1 else tbits - b1)
                vals[s - 1] = (x & (M - 1)) >> k
            xt = (f * (x >> M_BITS) + (x & (M - 1)) - c if s == 0
                  else ((x >> M_BITS) << k) | (x & ((1 << k) - 1)))
            read = xt < RANS_L
            ex = np.cumsum(read) - read
            for i in np.nonzero(read)[0]:
                w = st + ex[i]
                k = w & (ring_words - 1)
                assert slot_word[k] == w and slot_group[k] < done
                xt[i] = (xt[i] << 16) | (int(stream[w]) & 0xFFFF)
            x = xt
            base += int(read.sum())
        if fill < min(st + 4 * S + ring_words // 2, L):  # half a ring behind
            to = min(st + ring_words, L)
            done, landed = groups, fill  # the refill before this one
            refill(fill, to, groups, st)
            groups += 1
            fill = to
        k = t * S + lanes[act]
        sym_g[k] = sym[act]
        xtr_g[k] = (vals[0] | (vals[1] << M_BITS))[act] & 0xFFFFFFFF
    return x, base, sym_g, xtr_g


@functools.partial(jax.jit, static_argnums=0)
def jax_plane(p, sym, xtr, n_tok):
    return jfast._token_plane(p, sym, xtr, n_tok)


def check_decode(pj, st, stream, ring_words):
    """The mirror against JAX's _fast_decode_scan on one stream."""
    S, n_tok = pj.lanes, st["n_tok"]
    x, base, plane = jfast._fast_decode_scan(
        pj, jnp.asarray(st["freq"]), jnp.asarray(st["states"]),
        jnp.asarray(stream), jnp.int32(n_tok))
    mx, mbase, msym, mxtr = mirror_decode(
        S, st["freq"], st["states"], stream, n_tok, ring_words)
    sym = np.zeros(pj.capacity, np.int32)
    xtr = np.zeros(pj.capacity, np.uint32)
    sym[:n_tok] = msym
    xtr[:n_tok] = mxtr
    mplane = jax_plane(pj, jnp.asarray(sym), jnp.asarray(xtr), jnp.int32(n_tok))
    np.testing.assert_array_equal(mx, np.asarray(x).astype(np.int64))
    assert mbase == int(base)
    np.testing.assert_array_equal(np.asarray(mplane), np.asarray(plane))
    return mbase


@functools.lru_cache(maxsize=None)
def far_stages(geo):
    """Half a block of random bytes, then runs of 40 bytes each copied from
    its own place at least a quarter block back: explicit distances of 11
    or more bits beside long lengths, so that tokens carry more than 15
    extra bits and the second uniform event reads words (no CASES stream
    has one).  The JAX encode's freq, states, words and n_tok."""
    pj, _ = params(geo)
    rng = np.random.default_rng(5)
    n = pj.capacity
    buf = rng.integers(0, 256, n, dtype=np.uint8)
    for at in range(n // 2, n - 40, 40):
        src = int(rng.integers(0, at - n // 4))
        buf[at : at + 40] = buf[src : src + 40]
    buf = buf.reshape(pj.lanes, pj.steps)
    freq, x, words, n_words, n_tok, _ = jfast._encode_fast(
        pj, jnp.asarray(buf), jnp.int32(pj.capacity), pj.lanes)
    return dict(freq=np.asarray(freq), states=np.asarray(x), n_tok=int(n_tok),
                n_words=int(n_words), words=np.asarray(words)[: int(n_words)])


@pytest.mark.parametrize("geo", ["small", "wide"])
def test_ring_decode_equals_jax_on_far_matches(geo):
    """Far matches: the second uniform event reads words, so the last
    event of a step moves base past its window's start; the ring at 4S,
    the stream padded and cut to n_words."""
    pj, _ = params(geo)
    st = far_stages(geo)
    _, _, sym, _ = mirror_decode(pj.lanes, st["freq"], st["states"],
                                 np.pad(st["words"][::-1], (0, 3 * pj.lanes)),
                                 st["n_tok"], 4 * pj.lanes)
    mc = np.where(sym >= 256, sym - 256, 0)
    db, lb = mc // 13, mc % 13
    tbits = np.where(sym >= 256, np.where(lb >= 8, lb - 5, 0) + np.where(db < 24, db, 0), 0)
    assert (tbits > 15).sum() > 10
    stream = np.zeros(jfast._max_words(pj), np.uint16)
    stream[: st["n_words"]] = st["words"][::-1]
    assert check_decode(pj, st, stream, 4 * pj.lanes) == st["n_words"]
    check_decode(pj, st, np.ascontiguousarray(st["words"][::-1]), 4 * pj.lanes)


@pytest.mark.parametrize("nwarps", [1, 3, 16, 32])
@pytest.mark.parametrize("name,geo,short", CASES[:4] + CASES[-3:])
def test_slot_table_equals_jax(name, geo, short, nwarps):
    """The shared slot table at 1, 3, 16 and 32 warps on the cases' static
    tables: each slot's symbol, cum and freq as _build_dec_table's row."""
    freq = jax_stages(name, geo, short)["freq"]
    row = np.asarray(jfast._build_dec_table(jnp.asarray(freq)))
    cf, sym = mirror_slot_table(freq, nwarps)
    np.testing.assert_array_equal(sym, row[:, 0] & 1023)
    np.testing.assert_array_equal(cf[sym] & 0xFFFF, row[:, 0] >> 10)
    np.testing.assert_array_equal(cf[sym] >> 16, row[:, 1])


@pytest.mark.parametrize("kind", ["one", "first_zero", "last_zero", "sparse", "flat"])
def test_slot_table_equals_jax_on_edge_tables(kind):
    """One symbol with every slot, the first or the last symbol absent,
    a few symbols among zeros, every symbol at least once."""
    rng = np.random.default_rng(len(kind))
    freq = np.zeros(W, np.int64)
    if kind == "one":
        freq[300] = M
    elif kind == "sparse":
        idx = rng.choice(W, 7, replace=False)
        freq[idx] = rng.multinomial(M - 7, np.ones(7) / 7) + 1
    else:
        freq[:] = rng.multinomial(M - W, np.ones(W) / W) + 1
        if kind != "flat":
            drop = 0 if kind == "first_zero" else W - 1
            freq[(drop + 1) % W] += freq[drop]
            freq[drop] = 0
    assert freq.sum() == M
    row = np.asarray(jfast._build_dec_table(jnp.asarray(freq.astype(np.int32))))
    for nwarps in (3, 16):
        cf, sym = mirror_slot_table(freq, nwarps)
        np.testing.assert_array_equal(sym, row[:, 0] & 1023)
        np.testing.assert_array_equal(cf[sym] & 0xFFFF, row[:, 0] >> 10)
        np.testing.assert_array_equal(cf[sym] >> 16, row[:, 1])


@pytest.mark.parametrize("ring", [4, 16])
@pytest.mark.parametrize("name,geo,short", CASES)
def test_ring_decode_equals_jax(name, geo, short, ring):
    """The ring at 4S and 16S words on each case's stream, zero-padded to
    ``_max_words`` as the decoder pads it."""
    pj, _ = params(geo)
    st = jax_stages(name, geo, short)
    stream = np.zeros(jfast._max_words(pj), np.uint16)
    stream[: st["n_words"]] = st["words"][::-1]
    assert check_decode(pj, st, stream, ring * pj.lanes) == st["n_words"]


@pytest.mark.parametrize("name,geo,short", [c for c in CASES if c[1] == "small"][:5])
def test_ring_decode_equals_jax_on_a_clamped_stream(name, geo, short):
    """The stream cut to its n_words words: the last steps' windows clamp
    to the stream's last S words, which the ring keeps."""
    pj, _ = params(geo)
    st = jax_stages(name, geo, short)
    stream = np.ascontiguousarray(st["words"][::-1][: max(st["n_words"], pj.lanes)])
    check_decode(pj, st, stream, 4 * pj.lanes)
