"""Mode P's whole-block candidate pass (K13c, ``block.lzp_candidates``)
against the JAX package and against the method its kernel uses.

- The plain version's grid row at every step equals JAX's own
  ``_lzp_candidate`` + ``_match_window_len`` on the carry the JAX modeling
  scan has after that many steps, and its final tables equal the scan's,
  at S=8/T=64 and S=512/T=32 on the text corpus (``lzp8`` has entries).
- The kernel's formulation (csrc/lzpcand.cu), written here in numpy: the
  inserts as elements (step, lane descending), sorted stably by key, a
  segmented prefix max, the tables' initial values — equals the step walk
  of the inserts on inputs made to break it: one slot for every lane in a
  step, colliding keys, steps below 8, a block that ends inside its last
  lane, tables that do not start empty.

Tolerance 0 everywhere.  The kernel itself is held to the plain version
on a card (tests/test_torch_scans.py).
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

GEO = {"small": dict(lanes=8, steps=64, mode="P", min_len=4, window=32, o3_bits=14),
       "wide": dict(lanes=512, steps=32, mode="P", min_len=4, window=250, o3_bits=14)}


def _text_block(p, short, seed=3):
    n = p.capacity - short
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    buf.reshape(-1)[:n] = corpus("text", n, seed=seed)
    return buf, n


@functools.partial(jax.jit, static_argnums=0)
def _jax_candidate_row(p, c, inp, n, t):
    """JAX's candidate of every lane at step t from the carry c, as the
    modeling scan computes it: (src, ok, length)."""
    inp_flat = inp.reshape(-1)
    inp_pad = jnp.pad(inp, ((0, 0), (0, p.window + 1)))
    pos = jnp.arange(p.lanes, dtype=jnp.int32) * p.steps + t
    cur_win = jax.lax.dynamic_slice(inp_pad, (0, t), (p.lanes, p.window + 1)).astype(jnp.int32)
    src, ok = jblk._lzp_candidate(c, t, p, inp_flat)
    length = jblk._match_window_len(jblk._pack_words(inp_flat), pos, src, t, n, p, cur_win)
    return src, ok, length


def _jax_walk(p, buf, n):
    """The JAX modeling scan one step at a time: the grid rows of JAX's own
    candidate before each step, and the carry at the end."""
    inp = jnp.asarray(buf)
    inp_flat = inp.reshape(-1)
    body = jax.jit(functools.partial(
        jblk._encode_model_body, p, jnp.pad(inp, ((0, 0), (0, p.window + 1))),
        inp_flat, jblk._pack_words(inp_flat), jnp.int32(n)))
    c = jblk._init_carry(p, enc_side=True)
    pos = np.arange(p.lanes) * p.steps
    rows = []
    for t in range(p.steps):
        _, ok, length = (np.asarray(v) for v in
                         _jax_candidate_row(p, c, inp, jnp.int32(n), jnp.int32(t)))
        length = np.where(ok & (length >= p.min_len), length, 0)
        rows.append(np.where(pos + t < n, np.where(ok, blk.LZP_GRID_OK, 0) | length, 0))
        c, _ = body(c, jnp.int32(t))
    return np.stack(rows).astype(np.int32), c


@pytest.mark.parametrize("geo,short", [("small", 0), ("small", 77), ("wide", 100)])
def test_grid_rows_and_tables_equal_jax(geo, short):
    p = blk.BlockParams(**GEO[geo])
    pj = jblk.BlockParams(**GEO[geo])
    buf, n = _text_block(p, short)
    want, c = _jax_walk(pj, buf, n)
    lzp = blk._init_lzp(p, "cpu")
    grid = blk.lzp_candidates(p, torch.from_numpy(buf), n, lzp)
    assert grid.shape == (p.steps, p.lanes) and grid.dtype == torch.int32
    np.testing.assert_array_equal(grid.numpy(), want)
    for k, v in blk.lzp_to_numpy(lzp).items():
        np.testing.assert_array_equal(v, np.asarray(c[k]), err_msg=k)
    assert int((np.asarray(c["lzp8"]) > 0).sum()) > 50, "lzp8 has entries"
    ok = (want & blk.LZP_GRID_OK) != 0
    assert ok.any() and (want[ok] & 0xFFFF).max() >= p.min_len, "the case finds matches"


def test_grid_feeds_the_modeling_scan_unchanged():
    """The modeling scan's plain version reads its candidates step by step
    (the definition the CPU tests hold against JAX); on the same block it
    codes a match exactly where the grid has a length."""
    p = blk.BlockParams(**GEO["small"])
    buf, n = _text_block(p, 9)
    from comprox_tpu_torch.models import ppm

    inp = torch.from_numpy(buf)
    ev = blk.model_scan_plain(p, inp, n, None, ppm.init_tables(True, p.o3_bits, "cpu"),
                              blk._init_lzp(p, "cpu"))
    grid = blk.lzp_candidates_plain(p, inp, n, blk._init_lzp(p, "cpu"))
    matched = ev[:, 8].bool()
    coding = ev[:, 2].bool()
    has_len = (grid & 0xFFFF) > 0
    assert torch.equal(matched, coding & has_len)
    assert matched.any()


# ---- the kernel's method in numpy, against the step walk of the inserts ----

T_MIN = (8, 4, 2)  # the first step whose reader each table serves (lzp8, lzp4, lzp2)


def _registers(buf, n):
    """ctx4, ctx4b of every (step, lane) before the step: [T, S] int64."""
    s, steps = buf.shape
    ctx4 = np.zeros((steps, s), np.int64)
    ctx4b = np.zeros((steps, s), np.int64)
    a = np.zeros(s, np.int64)
    b = np.zeros(s, np.int64)
    for t in range(steps):
        ctx4[t], ctx4b[t] = a, b
        active = np.arange(s) * steps + t < n
        b = np.where(active, ((b << 8) | (a >> 24)) & 0xFFFFFFFF, b)
        a = np.where(active, ((a << 8) | buf[:, t]) & 0xFFFFFFFF, a)
    return ctx4, ctx4b


def _slots(ctx4, ctx4b):
    """Each table's slot of each (step, lane) under these registers."""
    c4, c4b = torch.from_numpy(ctx4), torch.from_numpy(ctx4b)
    return (blk.lzp_hash8(c4, c4b).numpy(), blk.lzp_hash4(c4).numpy(), ctx4 & 0xFFFF)


def _sorted_method(buf, n, init):
    """csrc/lzpcand.cu in numpy: for each table, the value its reader at
    (t, i) finds ([T, S], 0 where the table has none) and the final table."""
    s, steps = buf.shape
    slots = _slots(*_registers(buf, n))
    t_of = np.repeat(np.arange(steps), s)           # element e = t * S + (S-1-i)
    i_of = np.tile(np.arange(s)[::-1], steps)
    seen, final = [], []
    for k, key in enumerate(blk.LZP_KEYS[::-1]):     # lzp8, lzp4, lzp2
        valid = (i_of * steps + t_of < n) & (t_of >= T_MIN[k])
        slot = slots[k][t_of, i_of]
        value = i_of * steps + t_of + 1
        order = np.argsort(np.where(valid, slot, -1), kind="stable")
        order = order[valid[order]]
        sk, sv = slot[order], value[order]
        run = np.empty_like(sv)
        for r in range(sv.size):  # the segmented inclusive prefix max
            head = r == 0 or sk[r] != sk[r - 1]
            run[r] = sv[r] if head else max(run[r - 1], sv[r])
        got = np.zeros(steps * s, np.int64)
        got[order] = np.maximum(run, init[key][sk])
        grid = np.zeros((steps, s), np.int64)
        grid[t_of, i_of] = got
        seen.append(grid)
        table = init[key].astype(np.int64).copy()
        last = np.r_[sk[1:] != sk[:-1], True] if sk.size else np.zeros(0, bool)
        table[sk[last]] = np.maximum(table[sk[last]], run[last])
        final.append(table)
    return seen, final


def _step_walk(buf, n, init):
    """The reads and inserts in step order (the scatter-max of
    block._post_step, which the plain version and JAX do)."""
    s, steps = buf.shape
    p = blk.BlockParams(lanes=s, steps=steps, mode="P", min_len=4, window=32)
    slots = _slots(*_registers(buf, n))
    lzp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    seen = [np.zeros((steps, s), np.int64) for _ in range(3)]
    c = blk._init_carry(p, "cpu")
    pos = torch.arange(s, dtype=torch.int64) * steps
    zero = torch.zeros(s, dtype=torch.int64)
    for t in range(steps):
        for k, key in enumerate(blk.LZP_KEYS[::-1]):
            valid = (pos.numpy() + t < n) & (t >= T_MIN[k])
            seen[k][t] = np.where(valid, lzp[key].numpy()[slots[k][t]], 0)
        blk._post_step(c, t, p, pos + t, pos + t < n, torch.from_numpy(buf[:, t]),
                       zero.bool(), zero, zero, lzp=lzp, n=n)
    return seen, [lzp[k].numpy() for k in blk.LZP_KEYS[::-1]]


def _adversarial(name, s, steps, seed=5):
    rng = np.random.default_rng(seed)
    if name == "zeros":          # every lane's slot is one slot, every step
        return np.zeros((s, steps), np.uint8)
    if name == "period2":        # two keys a table, lanes in step with each other
        return np.tile(np.array([7, 200], np.uint8), (s, steps // 2 + 1))[:, :steps].copy()
    if name == "pairs":          # few byte pairs: lzp2's exact slots collide across lanes
        return rng.choice(np.array([1, 2, 3], np.uint8), (s, steps))
    return corpus("text", s * steps, seed=seed).reshape(s, steps)


CASES = [("zeros", 64, 16, 0, False), ("period2", 16, 20, 3, False),
         ("pairs", 32, 24, 37, False), ("text", 8, 12, 5, False),
         ("text", 16, 20, 16 * 20 - 3 * 20 - 7, True), ("pairs", 8, 40, 1, True)]


@pytest.mark.parametrize("name,s,steps,short,filled", CASES)
def test_sorted_inserts_equal_the_step_walk(name, s, steps, short, filled):
    """Every (table, step, lane) value a reader finds, and every final
    table, the same both ways; ``filled`` starts from tables that hold
    random positions (the initial values take part in the max)."""
    buf = _adversarial(name, s, steps)
    n = s * steps - short
    rng = np.random.default_rng(s + steps)
    sizes = {"lzp2": 1 << 16, "lzp4": 1 << blk.LZP4_BITS, "lzp8": 1 << blk.LZP8_BITS}
    init = {k: np.zeros(v, np.int32) for k, v in sizes.items()}
    if filled:
        slots = _slots(*_registers(buf, n))
        for k, key in enumerate(blk.LZP_KEYS[::-1]):
            hit = rng.choice(np.unique(slots[k]), 3, replace=False)
            init[key][hit] = rng.integers(1, n + 1, 3)
    seen_w, final_w = _step_walk(buf, n, init)
    seen_m, final_m = _sorted_method(buf, n, init)
    for k in range(3):
        np.testing.assert_array_equal(seen_m[k], seen_w[k], err_msg=f"table {k} reads")
        np.testing.assert_array_equal(final_m[k], final_w[k], err_msg=f"table {k} final")
    # the cases reach what they are for
    if name == "zeros":
        assert (seen_w[2][2:] > 0).all(), "every lane reads the one slot"
    assert any((v > 0).any() for v in seen_w)
