"""K8's kernel order (``csrc/f2tok.cu``) mirrored in numpy against JAX.

The kernel replays the parse decisions in chunks of ``K8_CHUNK`` steps of a
lane: each chunk's exit map (for every step, the offset into the next
chunk at which a walk through that step leaves it; built per sub-chunk of
an eighth of the chunk, then composed from the last back), the chunks' true
entries composed in chunk order (the look-back), one walk a chunk from its
true entry compacting its starts' takes in order into the chunk's token
list (in place in the take tile) with the chunk's (starts, last match
distance) pair, the pairs' exclusive scan in position order, and the
emit, a warp a chunk and a token a thread, 32 at a time, each token's
position the entry plus a scan of ``max(take, 1)``.  ``mirror_k8`` does the same in numpy, at a small
chunk so that a few steps have every edge (entries past a chunk, takes
over several chunks, a block that ends inside a lane), and its start grid
and tokens must equal JAX's ``_replay_body`` scan, ``_tokenize`` and
``_token_events`` exactly.
"""

import functools
import re
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from comprox_tpu.codec import block as jblk
from comprox_tpu.codec import fast as jfast
from comprox_tpu_torch.codec import fast as tfast
from comprox_tpu_torch.utils import build

from test_torch_fast import CASES, block_buf, jax_find, jax_parse_f, params

# the emit's warp: 32 threads
WARP = 32
SUBS = 8  # the replay's warps: sub-chunks of its exit maps


def _combine(a, b):
    """f2scan.cuh::combine: a's positions come before b's."""
    return (a[0] + b[0], b[1] if b[1] else a[1])


def exit_map(tk, sub):
    """A chunk's exit map [Lc, S] as the replay computes it: each
    sub-chunk's of ``sub`` steps (the offset past the sub-chunk's end of a
    walk that reaches t), then composed from the last sub-chunk back into
    the chunk's (the offset into the next chunk); equal to the chunk's
    backward recurrence, each offset a byte."""
    Lc, S = tk.shape
    lanes = np.arange(S)
    step = np.maximum(tk, 1)
    ex = np.zeros((Lc, S), np.int64)
    for lo in range(0, Lc, sub):  # the warps, each its sub-chunk
        hi = min(lo + sub, Lc)
        for t in range(hi - 1, lo - 1, -1):
            nx = t + step[t]
            ex[t] = np.where(nx >= hi, nx - hi, ex[np.minimum(nx, hi - 1), lanes])
    assert (ex < 256).all()
    for lo in range((Lc - 1) // sub * sub - sub, -1, -sub):  # the last one's is the chunk's
        at = lo + sub + ex[lo : lo + sub]
        ex[lo : lo + sub] = np.where(at >= Lc, at - Lc,
                                     ex[np.minimum(at, Lc - 1), lanes[None, :]])
    direct = np.zeros((Lc, S), np.int64)
    for t in range(Lc - 1, -1, -1):
        nx = t + step[t]
        direct[t] = np.where(nx >= Lc, nx - Lc, direct[np.minimum(nx, Lc - 1), lanes])
    np.testing.assert_array_equal(ex, direct)
    assert (ex < 256).all()  # a byte holds every exit offset
    return ex


def mirror_k8(take, src, inp, n, chunk, min_len):
    """K8 on decisions ``take``, ``src`` [T, S] and the block ``inp`` [S, T]
    in the kernel's order, chunks of ``chunk`` steps: ``(start [T, S] bool
    from the emitted positions, n_tok, sym, xtr, tbits [n_tok])``."""
    T, S = take.shape
    take = take.astype(np.int64)
    src = src.astype(np.int64)
    assert (take >= 0).all() and (take <= tfast.K8_TAKE_MAX).all()
    nch = -(-T // chunk)
    lanes = np.arange(S)
    lists = [[None] * nch for _ in range(S)]  # each chunk's starts' takes
    entries = np.zeros((S, nch), np.int64)  # each chunk's true entry
    pairs = np.zeros((S, nch, 2), np.int64)
    entry = np.zeros(S, np.int64)  # chunk 0 enters at 0
    for c in range(nch):  # the look-back's order: chunk c waits on c - 1
        cbase, Lc = c * chunk, min(chunk, T - c * chunk)
        tk = take[cbase : cbase + Lc]
        ex = exit_map(tk, max(chunk // SUBS, 1))
        e = entry
        entries[:, c] = e
        entry = np.where(e >= Lc, e - Lc, ex[np.minimum(e, Lc - 1), lanes])
        # the walk from the true entry, up to the block's end, each lane's
        # column of the tile taking its starts' takes in order, in place
        nl = np.clip(n - lanes * T - cbase, 0, Lc)
        for lane in range(S):
            col = tk[:, lane].copy()
            t, k, lastm = int(e[lane]), 0, -1
            while t < nl[lane]:
                assert k <= t  # the row it takes was read
                v = int(col[t])
                col[k] = v
                k += 1
                if v > 0:
                    lastm = t
                t += max(v, 1)
            lists[lane][c] = col[:k].copy()
            pairs[lane, c, 0] = k
            if lastm >= 0:
                pos = lane * T + cbase + lastm
                pairs[lane, c, 1] = max(pos - int(src[cbase + lastm, lane]), 1)
    # scan_parts: the chunks' exclusive prefixes in position order
    flat = pairs.reshape(-1, 2)
    excl, run = [], (0, 0)
    for q in range(flat.shape[0]):
        excl.append(run)
        run = _combine(run, tuple(flat[q]))
    excl.append(run)
    n_tok = run[0]
    # the emit: a warp a chunk, a token a thread, 32 at a time
    toks = [None] * n_tok
    start = np.zeros((T, S), bool)
    for q in range(S * nch):
        lane, c = divmod(q, nch)
        cbase = c * chunk
        ntok = excl[q + 1][0] - excl[q][0]
        takes = lists[lane][c]
        assert ntok == takes.size
        run, at = excl[q], int(entries[lane, c])
        for k0 in range(0, ntok, WARP):
            ln = takes[k0 : k0 + WARP].astype(np.int64)
            steps = np.maximum(ln, 1)
            ts = at + np.cumsum(steps) - steps  # the warp's scan of the steps
            at += int(steps.sum())
            for t, l_ in zip(ts.tolist(), ln.tolist()):
                start[cbase + t, lane] = True
                d = max(lane * T + cbase + t - int(src[cbase + t, lane]), 1) if l_ else 0
                rep = l_ > 0 and d == max(run[1], 1)
                e0 = int(inp[lane, cbase + t]) | ((1 << 8) | (rep << 9) | (l_ << 10) if l_ else 0)
                toks[run[0]] = (e0, d)
                run = _combine(run, (1, d))
    return start, n_tok, _token_events(np.array(toks, np.int64).reshape(-1, 2), min_len)


def _token_events(toks, min_len):
    """f2tok.cu::token_event on every token: (sym, xtr, tbits)."""
    e0, dist = toks[:, 0], toks[:, 1]
    is_m = (e0 >> 8) & 1 == 1
    rep = (e0 >> 9) & 1 == 1
    v = np.clip((e0 >> 10) - min_len, 0, 255)
    k = 3 + (v >= 16) + (v >= 32) + (v >= 64) + (v >= 128)
    lb = np.where(v >= 8, 5 + k, v)
    len_bits = np.where(v >= 8, k, 0)
    len_mant = np.where(v >= 8, v - (1 << k), 0)
    log2 = np.floor(np.log2(np.maximum(dist, 1))).astype(np.int64)
    db = np.where(rep, 24, np.minimum(log2, 24))
    kd = np.minimum(db, 23)
    dist_bits = np.where(rep, 0, kd)
    dist_mant = np.where(rep, 0, dist - (1 << kd))
    sym = np.where(is_m, 256 + db * 13 + lb, e0 & 0xFF)
    xtr = np.where(is_m, (len_mant | (dist_mant << len_bits)) & 0xFFFFFFFF, 0)
    tbits = np.where(is_m, len_bits + dist_bits, 0)
    return sym, xtr.astype(np.uint32).view(np.int32), tbits


@functools.partial(jax.jit, static_argnums=0)
def jax_replay(p, inp, n, take, src):
    """JAX's start grid [T, S] and its tokens (fast.py::_replay_body under
    its scan, _tokenize, _token_events)."""
    ts = jnp.arange(p.steps, dtype=jnp.int32)
    body = functools.partial(jfast._replay_body, p, inp, n)
    _, ev = jax.lax.scan(body, (jnp.zeros((p.lanes,), jnp.int32),), (ts, take, src))
    toks, n_tok = jfast._tokenize(p, ev, n)
    return (ev[0], n_tok) + jfast._token_events(p, toks, n_tok)[:3]


def jax_reference(pj, inp, n, take, src):
    """JAX's start grid, token count and (sym, xtr, tbits) of the tokens."""
    start, n_tok, sym, xtr, tbits = jax_replay(
        pj, jnp.asarray(inp), jnp.int32(n), jnp.asarray(take), jnp.asarray(src))
    k = int(n_tok)
    return (np.asarray(start), k, np.asarray(sym)[:k],
            np.asarray(xtr).view(np.int32)[:k], np.asarray(tbits)[:k])


def check(pj, inp, n, take, src, chunk):
    start, n_tok, (sym, xtr, tbits) = mirror_k8(take, src, inp, n, chunk, pj.min_len)
    jstart, jn, jsym, jxtr, jtbits = jax_reference(pj, inp, n, take, src)
    np.testing.assert_array_equal(start, jstart)
    assert n_tok == jn
    np.testing.assert_array_equal(sym, jsym)
    np.testing.assert_array_equal(xtr, jxtr)
    np.testing.assert_array_equal(tbits, jtbits)
    return n_tok


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("name,geo,short", CASES)
def test_k8_order_equals_jax_on_the_parse_decisions(name, geo, short, chunk):
    """The mirror on each case's JAX finder and parse decisions."""
    pj, _ = params(geo)
    buf, n = block_buf(name, pj, short)
    inp, nj = jnp.asarray(buf), jnp.int32(n)
    cands = jax_find(pj, inp, nj)
    cgrid = tuple(jnp.asarray(np.asarray(g).reshape(pj.lanes, pj.steps).T)
                  for l, s in cands for g in (l, s))
    take, src, _ = jax_parse_f(pj, nj, cgrid)
    check(pj, buf, n, np.asarray(take), np.asarray(src), chunk)


TINY = dict(lanes=8, steps=64, mode="F", min_len=6, window=64)
WIDE = dict(lanes=512, steps=32, mode="F", min_len=6, window=250)


def _synthetic(kind, p, rng):
    """Decisions [T, S] (take, src) of one kind; src a distance back from
    a small set, so that repeats are common."""
    T, S = p.steps, p.lanes
    t = np.arange(T)[:, None]
    left = T - t  # steps to the lane's end, this one included
    if kind == "two":
        take = np.full((T, S), 2)
    elif kind == "cap":  # every take at the kernel's cap, far past the lane
        take = np.full((T, S), tfast.K8_TAKE_MAX)
    elif kind == "window":
        take = np.full((T, S), p.window)
    elif kind == "literals":  # long literal runs, a match now and then
        take = np.where(rng.random((T, S)) < 0.05, rng.integers(2, 40, (T, S)), 0)
    elif kind == "to_end":  # takes that end on the lane's last step
        take = np.where(rng.random((T, S)) < 0.3, left, rng.integers(0, 4, (T, S)))
    elif kind == "long":  # 250, crossing every chunk boundary
        take = np.full((T, S), 250)
    else:  # random in [0, 250], capped at the lane's end
        take = np.minimum(rng.integers(0, 251, (T, S)), left)
    take = np.minimum(take, tfast.K8_TAKE_MAX)
    pos = np.arange(S)[None, :] * T + t
    src = pos - rng.choice(np.array([1, 3, 7, 100, 5000]), (T, S))
    return take.astype(np.int32), src.astype(np.int32)


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("short", [0, 37, 64 * 3 + 5])
@pytest.mark.parametrize("kind", ["two", "cap", "window", "literals", "to_end",
                                  "long", "random"])
def test_k8_order_equals_jax_on_synthetic_decisions(kind, short, chunk):
    """The mirror on synthetic decisions at S=8, T=64: take 2 everywhere,
    every take at the cap or the window, literal runs, takes ending on a
    lane's last step, takes of 250 and random ones; the block full, ending
    inside the last lane, and ending four lanes early."""
    pj = jblk.BlockParams(**TINY)
    rng = np.random.default_rng(zlib.crc32(f"{kind} {short}".encode()))
    take, src = _synthetic(kind, pj, rng)
    inp = rng.integers(0, 256, (pj.lanes, pj.steps), dtype=np.uint8)
    n = pj.capacity - short
    assert check(pj, inp, n, take, src, chunk) > 0


@pytest.mark.parametrize("kind", ["two", "long", "random"])
def test_k8_order_equals_jax_at_the_main_lane_count(kind):
    """S=512, T=32 at the kernel's chunk (one chunk a lane, T < K8_CHUNK)
    and at 16 steps, the block ending inside a lane."""
    pj = jblk.BlockParams(**WIDE)
    rng = np.random.default_rng(len(kind))
    take, src = _synthetic(kind, pj, rng)
    inp = rng.integers(0, 256, (pj.lanes, pj.steps), dtype=np.uint8)
    n = pj.capacity - 1003
    for chunk in (tfast.K8_CHUNK, 16):
        check(pj, inp, n, take, src, chunk)


def test_kernel_constants_and_shared_memory():
    """The chunk, the take cap and the ring are one number on both sides,
    and each kernel's shared memory fits a CTA of the H100 (227 KB)."""
    tok = (build.CSRC / "f2tok.cu").read_text()
    dec = (build.CSRC / "f2dec.cu").read_text()

    def define(src, name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))

    assert define(tok, "K8_C") == tfast.K8_CHUNK
    assert define(tok, "K8_TAKE_MAX") == tfast.K8_TAKE_MAX == 256
    c, lanes = define(tok, "K8_C"), define(tok, "K8_LANES")
    assert lanes == WARP and c * lanes * 3 <= 232448
    assert define(tok, "K8_SUB") * SUBS == c == define(tok, "K8_SUB") * (
        define(tok, "K8_THREADS") // WARP)
    ring = define(dec, "K10_RING")
    assert ring == tfast.K10_RING and ring & (ring - 1) == 0
    assert 4 * 8192 <= ring  # the refill's reach covers a step at S = 8192
    assert ring * 4 + tfast.M * 2 + tfast.W_SYM * 8 + 4 <= 232448 - 256
