"""K13c's kernel order (csrc/lzpcand.cu) mirrored in numpy and held to the
JAX package's own candidate (``_lzp_candidate`` and ``_match_window_len`` on
the modeling scan's carry, step by step), exactly (tolerance 0).

The mirror does what the kernels do, in their order: ``mirror_keys`` builds
each position's registers from the 8 bytes before it (zero before the
lane's first byte, whatever n is) and writes the three tables' keys in
element order (e = t * S + S-1-i), a tile of 32 lanes x 32 steps at a time;
then a table at a time, the stable sort and ``mirror_segmax``: tiles of
``TILE`` sorted pairs, ``ITEMS`` a thread, each element's value (its
insert's position + 1, 0 where it has none), each thread's initial values
read at its first item and at every key start (where the table had a
slot set), the tile's (head, max)
word, the carry from the words of the tiles before it (the look-back, both
as it stops at the first tile where the key starts and as it stops at the
tile before's inclusive word), the inclusive max with the initial value
scattered to element order where the reader's check can take it (an
earlier step of its lane; zero elsewhere), and each key's last element
writing the slot where it grew; ``mirror_check`` reads the three values a position back, does
the checks, a warp a lane and a thread a step, compares the window only at
the heads (where the candidate one step up does not continue the match)
and gives a link its head's length plus the steps between, into the [T, S]
grid.

Inputs made to break it: an all-zero block (one key a table over every
tile), period-3 content, text, blocks that end inside their last lane, and
tables that do not start empty; at S=8/T=64 and S=512/T=32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu.codec import block as jblk
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.utils import build

from test_block import corpus

torch.set_num_threads(1)

TILE = 64   # sorted pairs a segmax CTA in the mirror (the kernel: 4096)
ITEMS = 16  # pairs a thread (the kernel's too)
SIDE = 32   # lanes and steps of a keys or check tile (the kernel's too)
T_MIN = (8, 4, 2)  # the first step with an insert, tables t8, t4, t2
TABLES = ("lzp8", "lzp4", "lzp2")  # the kernel's table order
GEO = {"s8t64": dict(lanes=8, steps=64, mode="P", min_len=4, window=32, o3_bits=14),
       "s512t32": dict(lanes=512, steps=32, mode="P", min_len=4, window=250, o3_bits=14)}
# (content, geometry, bytes short of a full block, tables start filled)
CASES = [("zeros", "s8t64", 0, False), ("period3", "s8t64", 0, False),
         ("text", "s8t64", 77, False), ("text", "s8t64", 5, True),
         ("zeros", "s8t64", 13, True), ("zeros", "s512t32", 0, False),
         ("period3", "s512t32", 3000, True), ("text", "s512t32", 100, False)]


def block_buf(name, p, short, seed=3):
    n = p.capacity - short
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    if name == "period3":
        pat = np.random.default_rng(seed).integers(0, 256, 3, dtype=np.uint8)
        data = np.tile(pat, n // 3 + 1)[:n]
    else:
        data = corpus(name, n, seed=seed)
    buf.reshape(-1)[:n] = data
    return buf, n


def start_tables(p, buf, filled, seed=11):
    """Empty tables, or tables holding positions at slots the block's
    contexts hit (so that the initial values take part in the max)."""
    sizes = {"lzp2": 1 << 16, "lzp4": 1 << blk.LZP4_BITS, "lzp8": 1 << blk.LZP8_BITS}
    init = {k: np.zeros(v, np.int32) for k, v in sizes.items()}
    if filled:
        rng = np.random.default_rng(seed)
        keys = mirror_keys(p, buf)
        for u, name in enumerate(TABLES):
            slots = np.unique(keys[u])
            hit = rng.choice(slots, min(5, slots.size), replace=False)
            init[name][hit] = rng.integers(1, p.capacity + 1, hit.size)
    return init


@functools.partial(jax.jit, static_argnums=0)
def _jax_step(p, c, inp, n, t):
    """JAX's candidate of every lane at step t from the carry c, as the
    modeling scan computes it, (ok, length), and the carry after the step."""
    inp_flat = inp.reshape(-1)
    inp_pad = jnp.pad(inp, ((0, 0), (0, p.window + 1)))
    w32 = jblk._pack_words(inp_flat)
    pos = jnp.arange(p.lanes, dtype=jnp.int32) * p.steps + t
    cur_win = jax.lax.dynamic_slice(inp_pad, (0, t), (p.lanes, p.window + 1)).astype(jnp.int32)
    src, ok = jblk._lzp_candidate(c, t, p, inp_flat)
    length = jblk._match_window_len(w32, pos, src, t, n, p, cur_win)
    c, _ = jblk._encode_model_body(p, inp_pad, inp_flat, w32, n, c, t)
    return ok, length, c


def jax_walk(geo, buf, n, init):
    """The JAX modeling scan step by step from tables ``init``: the grid of
    its candidates before each step and the tables at the end."""
    p = jblk.BlockParams(**GEO[geo])
    inp = jnp.asarray(buf)
    c = dict(jblk._init_carry(p, enc_side=True))
    c.update({k: jnp.asarray(v) for k, v in init.items()})
    pos = np.arange(p.lanes) * p.steps
    rows = []
    for t in range(p.steps):
        ok, length, c = _jax_step(p, c, inp, jnp.int32(n), jnp.int32(t))
        ok, length = np.asarray(ok), np.asarray(length)
        length = np.where(ok & (length >= p.min_len), length, 0)
        rows.append(np.where(pos + t < n, np.where(ok, blk.LZP_GRID_OK, 0) | length, 0))
    return np.stack(rows).astype(np.int64), {k: np.asarray(c[k]) for k in TABLES}


def registers(buf, i, t):
    """regs_at: (ctx4, ctx4b) of lane i before step t from its bytes."""
    a = b = 0
    for k in range(8, 0, -1):
        by = int(buf[i, t - k]) if t - k >= 0 else 0
        b = ((b << 8) | (a >> 24)) & 0xFFFFFFFF
        a = ((a << 8) | by) & 0xFFFFFFFF
    return a, b


def hash_keys(ctx4, ctx4b):
    """ppm_r.cuh's lzp_hash8, lzp_hash4 and the t2 slot."""
    m = 0xFFFFFFFF
    h8 = (((ctx4 * 2654435761) & m) ^ ((ctx4b * 0xC2B2AE3D) & m)) >> 10
    h4 = ((ctx4 * 2654435761) & m) >> 12
    return (h8 & ((1 << blk.LZP8_BITS) - 1), h4 & ((1 << blk.LZP4_BITS) - 1), ctx4 & 0xFFFF)


def elem(p, t, i):
    return t * p.lanes + (p.lanes - 1 - i)


def mirror_keys(p, buf):
    """k13c_keys: [3, N] keys in element order, a 32 x 32 tile at a time."""
    S, T = p.lanes, p.steps
    key = np.full((3, S * T), -1, np.int64)
    for i0 in range(0, S, SIDE):
        for t0 in range(0, T, SIDE):
            for i in range(i0, min(i0 + SIDE, S)):
                for t in range(t0, min(t0 + SIDE, T)):
                    key[:, elem(p, t, i)] = hash_keys(*registers(buf, i, t))
    assert (key >= 0).all()
    return key


def elem_value(p, n, u, e):
    t, i = e // p.lanes, p.lanes - 1 - e % p.lanes
    pos = i * p.steps + t
    return pos + 1 if t >= T_MIN[u] and pos < n else 0


def join(a, b):
    """The segmented max's (flag, value) pairs: a, then b."""
    return (a[0] | b[0], b[1] if b[0] else max(a[1], b[1]))


def mirror_segmax(p, n, u, sk, se, table):
    """k13c_segmax of table u over its sorted (key, element) pairs: the
    values in element order; ``table`` updated in place."""
    N = sk.size
    tiles = -(-N // TILE)
    cand = np.zeros(N, np.int64)  # zeroed by the launch
    words = []  # each tile's own (head, max): AGG
    inc = []    # each tile's inclusive max: INC
    table0 = table.copy()
    filled = bool(table0.any())
    for tile in range(tiles):
        r = np.arange(tile * TILE, min((tile + 1) * TILE, N))
        k, e = sk[r], se[r]
        prev = np.r_[sk[r[0] - 1] if r[0] > 0 else -2, k[:-1]]
        head = k != prev
        v = np.array([elem_value(p, n, u, x) for x in e])
        # each thread's initial values: read at its first item and at heads,
        # from the table before any write of this pass; 0 where the table
        # had no slot set (k13c_any's flag)
        init = np.zeros_like(v)
        for j in range(r.size):
            first = j % ITEMS == 0
            if filled:
                init[j] = table0[k[j]] if first or head[j] else init[j - 1]
        total = (0, 0)
        for j in range(r.size):
            total = join(total, (int(head[j]), int(v[j])))
        words.append(total)
        # the look-back over the AGG words alone, to the first key start ...
        acc = (0, 0)
        for j in range(tile - 1, -1, -1):
            acc = join(words[j], acc)
            if words[j][0]:
                break
        # ... equals the one that stops at the tile before's INC word
        if tile:
            assert acc[1] == inc[tile - 1], "the look-back's two stops disagree"
        inc.append(join((1, acc[1]), total)[1])
        run = (0, acc[1])
        nxt = np.r_[k[1:], sk[r[-1] + 1] if r[-1] + 1 < N else -1]
        for j in range(r.size):
            run = join(run, (int(head[j]), int(v[j])))
            val = max(run[1], init[j])
            t = e[j] // p.lanes
            if val > 0 and elem_value(p, n, u, e[j]) and (val - 1) % p.steps < t:
                cand[e[j]] = val  # a value the reader's check can take
            if k[j] != nxt[j] and run[1] > init[j]:
                table[k[j]] = run[1]
    return cand


def lzp_check(p, buf, t, ctx4, ctx4b, s8, s4, s2):
    """ppm_r.cuh::lzp_fetch + lzp_check: (ok, src)."""
    flat = buf.reshape(-1)
    T = p.steps

    def word(at):
        return (int(flat[at]) << 24) | (int(flat[at + 1]) << 16) | (int(flat[at + 2]) << 8) \
            | int(flat[at + 3])

    ok8 = s8 >= 0 and t >= 8 and s8 % T < t
    if ok8 and s8 % T >= 8:
        ok8 = word(s8 - 4) == ctx4 and word(s8 - 8) == ctx4b
    ok4 = s4 >= 0 and t >= 4 and s4 % T < t
    if ok4 and s4 % T >= 4:
        ok4 = word(s4 - 4) == ctx4
    ok2 = s2 >= 0 and t >= 2 and s2 % T < t
    return ok8 or ok4 or ok2, s8 if ok8 else s4 if ok4 else s2


def prefix(p, buf, i, t, src):
    """rolz_search.cuh::prefix_len at the window: the lane's bytes (zero past
    its row) against the block's at src (zero past the block)."""
    flat = buf.reshape(-1).astype(np.int64)
    w = p.window
    own = np.zeros(w, np.int64)
    take = min(w, p.steps - t)
    own[:take] = flat[i * p.steps + t: i * p.steps + t + take]
    srcb = np.zeros(w, np.int64)
    take = min(w, flat.size - src)
    srcb[:take] = flat[src: src + take]
    return int(np.cumprod(own == srcb).sum())


def mirror_check(p, buf, n, cand):
    """k13c_check: the grid [T, S]; a warp a lane and 32 steps, a thread a
    step: the checks, then the window compares of the heads only, a link
    (first bytes equal, the candidate one step up src + 1, inside the warp)
    taking min(window, its head's + the steps between)."""
    S, T = p.lanes, p.steps
    flat = buf.reshape(-1)
    grid = np.zeros((T, S), np.int64)
    for i0 in range(0, S, SIDE):
        for t0 in range(0, T, SIDE):
            for i in range(i0, min(i0 + SIDE, S)):
                ok = np.zeros(SIDE, bool)
                src = np.zeros(SIDE, np.int64)
                for l in range(SIDE):
                    t = t0 + l
                    if t < T and i * T + t < n:
                        e = elem(p, t, i)
                        ok[l], src[l] = lzp_check(p, buf, t, *registers(buf, i, t),
                                                  *(int(cand[u][e]) - 1 for u in range(3)))
                eq = np.array([ok[l] and flat[i * T + t0 + l] == flat[src[l]]
                               for l in range(SIDE)])
                link = np.array([eq[l] and l < SIDE - 1 and ok[l + 1] and src[l + 1] == src[l] + 1
                                 for l in range(SIDE)])
                m = np.zeros(SIDE, np.int64)
                for l in range(SIDE):
                    if eq[l] and not link[l]:
                        m[l] = prefix(p, buf, i, t0 + l, src[l])
                for l in range(SIDE):
                    if link[l]:
                        h = l + int(np.argmin(link[l:]))  # the first step up with no link
                        m[l] = min(p.window, h - l + m[h])
                        assert m[l] == prefix(p, buf, i, t0 + l, src[l])
                    if ok[l]:
                        t = t0 + l
                        cap = min(T - t, n - (i * T + t), p.window,
                                  p.min_len + blk.ppm.LEN_W - 1)
                        length = min(m[l], cap)
                        grid[t, i] = blk.LZP_GRID_OK | (length if length >= p.min_len else 0)
    return grid


def mirror(p, buf, n, init):
    """The kernels in their order: (grid, final tables)."""
    key = mirror_keys(p, buf)
    tables = {k: v.astype(np.int64).copy() for k, v in init.items()}
    cand = []
    for u, name in enumerate(TABLES):
        order = np.argsort(key[u], kind="stable")
        cand.append(mirror_segmax(p, n, u, key[u][order], order, tables[name]))
    return mirror_check(p, buf, n, cand), tables


@pytest.mark.parametrize("name,geo,short,filled", CASES)
def test_mirror_equals_jax(name, geo, short, filled):
    p = blk.BlockParams(**GEO[geo])
    buf, n = block_buf(name, p, short)
    init = start_tables(p, buf, filled)
    want, tables = jax_walk(geo, buf, n, init)
    got, got_tables = mirror(p, buf, n, init)
    np.testing.assert_array_equal(got, want)
    for k in TABLES:
        np.testing.assert_array_equal(got_tables[k], tables[k], err_msg=k)
    ok = (want & blk.LZP_GRID_OK) != 0
    if name != "zeros":  # all zeros: each step's candidate is the step just before
        assert ok.any() and (want[ok] & 0xFFFF).max() >= p.min_len, "the case finds matches"
    if filled:
        assert any((init[k] != tables[k]).any() and (init[k] != 0).any() for k in TABLES)


def test_one_key_spans_every_tile():
    """All zeros at S=512/T=32: each table's keys are one key past its first
    steps, so the look-back runs back over tiles without a key start."""
    p = blk.BlockParams(**GEO["s512t32"])
    buf, _ = block_buf("zeros", p, 0)
    key = mirror_keys(p, buf)
    for u in range(3):
        assert np.unique(key[u][elem(p, T_MIN[u], 0):]).size == 1
        assert key[u].size > 4 * TILE


def test_kernel_constants_and_scratch():
    """lzpcand.cu's tile, items and side are the mirror's and block.py's;
    K13c's scratch at the main path's N = 8 Mi stays under its old 0.54 GB."""
    src = (build.CSRC / "lzpcand.cu").read_text()
    assert f"#define LZC_SIDE {SIDE} " in src
    assert "#define LZC_ITEMS (LZC_TILE / LZC_THREADS)" in src
    assert "#define LZC_THREADS 256" in src and 4096 // 256 == ITEMS
    # look: a word a tile, the tile counter and k13c_any's flag, a table
    assert "(size_t)LZC_TABS * (tiles + 2)" in src
    assert "3 * (tiles + 2)" in (build.CSRC.parent / "codec" / "block.py").read_text()
    big = 512 * 16384
    tiles = -(-big // blk.K4_TILE)
    scratch = 4 * (3 * blk.k13c_key_stride(big) + 2 * big
                   + blk.RS_HDR + blk.RS_PASSES * 256 * tiles + 3 * big + 3 * (tiles + 2))
    assert scratch < 0.54e9
    assert blk.k13c_key_stride(5) == 16 and blk.k13c_key_stride(8) == 16
