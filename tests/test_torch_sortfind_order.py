"""K4's and K4x's kernel order (csrc/sortfind.cu) mirrored in torch and held
to the JAX package's ``sort_candidates``, exactly (tolerance 0).

The mirror does what the kernels do, in their order: ``mirror_find`` takes
the sort ranks in tiles (of ``FIND_TILE`` ranks here, so that S=8, T=64
has every edge: ranks near 0 and N - 1, a halo at each tile's ends), stages
each tile's ranks and its halo (key, position, the 8 bytes at the
position, the step from which it is usable), probes each rank's chain from
the staged window alone into an n_cands-deep list of scores, extends the
winners whose 8-byte probe matched whole from byte 8 on, and writes a
record of 32 bytes (64 above four candidates) a position.
``mirror_final`` takes each lane in chunks of ``FINAL_CHUNK`` steps, from
the chunk's top step down, and writes the [2 * n_cands, T, S] grids: the
extension capped where it reaches the cap, or else the diagonal runs as a
backward recurrence that starts the length cap above the chunk.

Runs on the CASES of test_torch_sortfind.py in modes R and X, and at
``CPX_SORT_EXT=8``, ``CPX_X_CANDS=5`` and ``CPX_R_PROBE=4``.  Also: the
property the final stage's default arm rests on, shown on JAX's own
function, and the size of the find's staged window for every knob value.
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

from test_torch_sortfind import CASES, block_buf, params, props_grid

torch.set_num_threads(1)

FIND_TILE = 16  # sort ranks a find CTA in the mirror (the kernel: 256)
FINAL_CHUNK = 16  # steps a final thread in the mirror (the kernel: 64, 512)
FIND_OK, FIND_EQ1 = 1 << 17, 1 << 16  # csrc/sortlib.cuh's lw flags
K4_EXT = 1 << 18  # sortfind.cu's: the probe matched 8 bytes, extend
INT_MIN = -(1 << 31)
_i64 = torch.int64


def prefixes(b, m: int):
    """[m, 8]: the 8 bytes at each of the first m positions of the padded
    block (the kernel's 8-byte load)."""
    return torch.stack([b[k: k + m] for k in range(8)], dim=1)


def lead_eq(a, b):
    """Leading equal bytes of two [..., w] rows of bytes."""
    return torch.cumprod((a == b).to(_i64), dim=-1).sum(-1)


def mirror_find(pt, bytes_pad, n: int, content: bool, tile: int = FIND_TILE):
    """k4_find: the records [N, k4_record_ints(n_cands)] in position order."""
    big, T = pt.capacity, pt.steps
    n_c, chain_b, fwd, dec = blk._finder_config(pt, content)
    chain = chain_b + fwd
    b = bytes_pad.to(_i64)
    hs, ps = torch.sort(blk.sort_keys_plain(pt, bytes_pad, n, content), stable=True)
    tiles = -(-big // tile)
    # the staged window of each tile: ranks r0 - chain_b .. r0 + tile + fwd
    q = (torch.arange(tiles)[:, None] * tile - chain_b
         + torch.arange(tile + chain)[None, :])
    valid = (q >= 0) & (q < big)
    s_key = torch.where(valid, hs[q.clamp(0, big - 1)], 0)
    s_pos = torch.where(valid, ps[q.clamp(0, big - 1)], -1)
    s_pre = torch.where(valid[..., None], prefixes(b, big)[s_pos.clamp_min(0)], 0)
    ins = (s_pos + blk._INSERT_LATE) % dec == 0 if dec > 1 else valid
    s_from = torch.where(valid & ins, s_pos % T, T)

    def staged(x, slot):  # each thread's staged x at its own slot
        if x.dim() == 3:
            return torch.gather(x, 1, slot[..., None].expand(-1, -1, 8))
        return torch.gather(x, 1, slot)

    k = torch.arange(tile)
    s0 = (k + chain_b).expand(tiles, tile)
    alive = (torch.arange(tiles)[:, None] * tile + k) < big
    key, i, own = staged(s_key, s0), staged(s_pos, s0), staged(s_pre, s0)
    t_of = i % T
    select = chain > n_c
    if select:
        top = torch.full((tiles, tile, n_c), INT_MIN, dtype=_i64)
        for e in range(chain):
            slot = s0 - 1 - e if e < chain_b else s0 + 1 + e - chain_b
            ok = ((staged(s_pos, slot) >= 0) & (staged(s_key, slot) == key)
                  & (staged(s_from, slot) < t_of))
            v = (torch.where(ok, lead_eq(staged(s_pre, slot), own), -1) * chain
                 + (chain - 1 - e))
            for u in range(n_c):  # the sorted list, descending
                hi = torch.maximum(top[..., u], v)
                v = torch.minimum(top[..., u], v)
                top[..., u] = hi
    ext8 = (blk.sort_ext(pt) + 3) // 4 * 4
    rec = torch.zeros((big, blk.k4_record_ints(n_c)), dtype=_i64)
    for u in range(n_c):
        e = chain - 1 - (top[..., u] + chain) % chain if select else torch.full_like(s0, u)
        slot = torch.where(e < chain_b, s0 - 1 - e, s0 + 1 + e - chain_b)
        pos_q = staged(s_pos, slot)
        match = (pos_q >= 0) & (staged(s_key, slot) == key)
        cand = torch.where(match, pos_q, -1)
        ok = match & (staged(s_from, slot) < t_of)
        pre_q = staged(s_pre, slot)
        plen = lead_eq(pre_q, own)
        eq1 = torch.where(pre_q[..., 0] == own[..., 0], FIND_EQ1, 0)
        ext = torch.where((plen == 8) & (ext8 > 8), K4_EXT, 0)
        lw = torch.where(ok, plen.clamp_max(ext8) | FIND_OK | eq1 | ext, 0)
        rec[i[alive], 2 * u] = cand[alive]
        rec[i[alive], 2 * u + 1] = lw[alive]
    return rec


def extension(b, cand, i, ext8: int):
    """The match length of cand at i, whose first 8 bytes match: bytes
    compared from byte 8 on, at most ext8."""
    reach = torch.arange(ext8 - 8)
    return 8 + lead_eq(b[cand.clamp_min(0)[..., None] + 8 + reach],
                       b[i.clamp_min(0)[..., None] + 8 + reach])


def diagonal_step(pt, content: bool) -> int:
    """d: the pair d steps up on a diagonal is usable where the insert
    takes every d-th position."""
    dec = blk._finder_config(pt, content)[3]
    return dec if dec <= 2 else 0


def pair_up(rec_up, cand_d, n_c: int):
    """The lw of the usable winner cand_d among the records ``rec_up``
    (per row), else 0."""
    out = torch.zeros_like(cand_d)
    for w in range(n_c):
        c, lw = rec_up[..., 2 * w: 2 * w + 1], rec_up[..., 2 * w + 1: 2 * w + 2]
        out = torch.where((c == cand_d) & ((lw & FIND_OK) != 0), lw, out)
    return out


def link_up(rec_up, cand, inside, d: int, n_c: int):
    """A marked winner's link, where ``inside`` (step t + d below the top of
    t's chunk): the lw of the usable winner cand + d in the record d steps
    up, ``rec_up``; 0 where there is none."""
    if not d:
        return torch.zeros_like(cand)
    return torch.where(torch.as_tensor(inside), pair_up(rec_up, cand + d, n_c), 0)


def mirror_heads(pt, bytes_pad, rec, content: bool, chunk: int = FINAL_CHUNK):
    """k4_heads: the marked winners with no link in their chunk, extended
    (in place)."""
    S, T = pt.lanes, pt.steps
    n_c = blk._finder_config(pt, content)[0]
    d = diagonal_step(pt, content)
    ext8 = (blk.sort_ext(pt) + 3) // 4 * 4
    i = torch.arange(S * T)
    t = i % T
    c1 = torch.clamp((t // chunk + 1) * chunk, max=T)
    cand, lw = rec[:, 0: 2 * n_c: 2], rec[:, 1: 2 * n_c: 2]
    linked = link_up(rec[(i + d).clamp_max(S * T - 1)], cand, (t + d < c1)[:, None], d, n_c)
    heads = ((lw & K4_EXT) != 0) & (linked == 0)
    if heads.any():
        length = extension(bytes_pad.to(_i64), cand, i[:, None], ext8)
        lw[...] = torch.where(heads, (lw & ~(0xFFFF | K4_EXT)) | length, lw)
    return rec


def mirror_final(pt, bytes_pad, rec, n: int, content: bool, walk: bool,
                 chunk: int = FINAL_CHUNK):
    """k4_final: the records -> [2 * n_c, T, S] (len, src per candidate),
    a lane and a chunk of steps at a time from the chunk's top step down;
    a marked winner takes min(d + its link's length, ext8)."""
    S, T = pt.lanes, pt.steps
    n_c = blk._finder_config(pt, content)[0]
    d = diagonal_step(pt, content)
    len_cap = blk._len_cap(pt)
    ext8 = (blk.sort_ext(pt) + 3) // 4 * 4
    r = rec.view(S, T, -1).clone()
    out_len = torch.zeros((S, T, n_c), dtype=_i64)
    lanes = torch.arange(S)[:, None]
    for c0 in range(0, T, chunk):
        c1 = min(c0 + chunk, T)
        top = min(c1 + len_cap, T) if walk else c1
        up = torch.full((S, n_c), INT_MIN, dtype=_i64)  # the step above's candidate
        run = torch.zeros((S, n_c), dtype=_i64)
        for t in range(top - 1, c0 - 1, -1):
            cand, lw = r[:, t, 0: 2 * n_c: 2], r[:, t, 1: 2 * n_c: 2]
            i = lanes * T + t
            marked = (lw & K4_EXT) != 0
            if t < c1 and marked.any():
                found = link_up(r[:, min(t + d, T - 1)], cand, t + d < c1, d, n_c)
                length = torch.where(found != 0, (d + (found & 0xFFFF)).clamp_max(ext8),
                                     extension(bytes_pad.to(_i64), cand, i, ext8))
                lw[...] = torch.where(marked, (lw & ~(0xFFFF | K4_EXT)) | length, lw)
            length = lw & 0xFFFF
            if walk:
                eq1 = (lw & FIND_EQ1) != 0
                run = torch.where(eq1, torch.where(up == cand + 1, run + 1, 1), 0)
                up = cand.clone()
                length = torch.maximum(length, run)
            if t < c1:
                cap = torch.minimum(torch.tensor(T - t), n - i).clamp(0, len_cap)
                out_len[:, t] = torch.where((lw & FIND_OK) != 0,
                                            torch.minimum(length, cap), 0)
    cands = r[..., 0: 2 * n_c: 2]
    grids = torch.stack([g for u in range(n_c) for g in (out_len[..., u], cands[..., u])])
    return grids.transpose(1, 2).numpy()


@functools.partial(jax.jit, static_argnums=(0, 3, 4, 5, 6))
def jax_props(p, inp, n, content, n_cands, probe, ext):
    """JAX's sort_candidates as mode R (or X: ``content``) calls it."""
    if content:
        return jblk.sort_candidates(p, inp.reshape(-1), n, n_cands=n_cands,
                                    probe_from=probe, ext=ext)
    return jblk.sort_candidates(
        p, inp.reshape(-1), n, n_cands=n_cands, probe_from=probe, ext=ext,
        ctx_bytes=p.rolz_ctx_bytes, insert_dec=p.rolz_dec, fwd_chain=probe)


def jax_grid(pj, buf, n, content):
    """JAX's grids under the port's current knobs."""
    n_c, probe = blk.x_finder_knobs() if content else (blk._R_CANDS, blk._R_PROBE)
    props = jax_props(pj, jnp.asarray(buf), jnp.int32(n), content, n_c, probe,
                      blk._SORT_EXT)
    return props_grid(pj, props)


def check_mirror(name, geo, short, content):
    """The mirror's grids equal JAX's: by the arm the kernel takes, and
    where the extension reaches the cap by both arms."""
    pj, pt = params(geo)
    buf, n = block_buf(name, pj, short)
    ref = jax_grid(pj, buf, n, content)
    bytes_pad = blk.pad_block(pt, torch.from_numpy(buf))
    n_c = blk._finder_config(pt, content)[0]
    rec = mirror_find(pt, bytes_pad, n, content)
    assert rec.shape == (pt.capacity, blk.k4_record_ints(n_c))
    assert (rec[:, 2 * n_c:] == 0).all()
    mirror_heads(pt, bytes_pad, rec, content)
    walk = blk.sort_ext(pt) < blk._len_cap(pt)
    np.testing.assert_array_equal(mirror_final(pt, bytes_pad, rec, n, content, walk), ref)
    if not walk:
        np.testing.assert_array_equal(
            mirror_final(pt, bytes_pad, rec, n, content, True), ref)
    return ref


@pytest.mark.parametrize("content", [False, True], ids=["R", "X"])
@pytest.mark.parametrize("name,geo,short", CASES)
def test_mirror_equals_jax(name, geo, short, content):
    ref = check_mirror(name, geo, short, content)
    if name != "random":
        assert (ref[0] > 0).any(), "the case must have matches"


KNOB_CASES = [("text", "ctx4_dec2", 37), ("zeros", "ctx3_dec1", 0),
              ("period3", "ctx4_dec1", 201), ("random", "ctx3_dec2", 0),
              ("text", "wide", 100)]


@pytest.mark.parametrize("name,geo,short", KNOB_CASES)
@pytest.mark.parametrize("knob", ["ext8 R", "ext8 X", "xcands5", "rprobe4"])
def test_mirror_under_knobs(monkeypatch, knob, name, geo, short):
    """CPX_SORT_EXT=8 (the scan arm), CPX_X_CANDS=5 (64-byte records) and
    CPX_R_PROBE=4 (a short chain, a small halo)."""
    if knob.startswith("ext8"):
        monkeypatch.setattr(blk, "_SORT_EXT", 8)
    elif knob == "xcands5":
        monkeypatch.setenv("CPX_X_CANDS", "5")
    else:
        monkeypatch.setattr(blk, "_R_PROBE", 4)
    check_mirror(name, geo, short, content=knob.endswith("X") or knob == "xcands5")


def _no_diag_grid(pj, buf, n, content, ext):
    """JAX's sort_candidates with _diag_run_len's term dropped (called
    untraced, so that the patched helper is the one it finds)."""
    zero = lambda eq1, diag, with_tail=True: jnp.zeros(eq1.shape, jnp.int32)
    saved = jblk._diag_run_len
    jblk._diag_run_len = zero
    try:
        return props_grid(pj, jax_props.__wrapped__(
            pj, jnp.asarray(buf), jnp.int32(n), content, *(
                blk.x_finder_knobs() if content else (blk._R_CANDS, blk._R_PROBE)), ext))
    finally:
        jblk._diag_run_len = saved


@pytest.mark.parametrize("content", [False, True], ids=["R", "X"])
@pytest.mark.parametrize("name", ["text", "zeros", "period3", "random"])
def test_jax_diag_runs_change_nothing_where_the_extension_reaches_the_cap(
        monkeypatch, name, content):
    """On JAX's own function: where sort_ext >= the length cap, the grids
    are the same without the diagonal-run term (k4_final's default arm);
    at CPX_SORT_EXT=8 they are not."""
    pj, pt = params("ctx3_dec1")
    buf, n = block_buf(name, pj, 37)
    assert blk.sort_ext(pt) >= blk._len_cap(pt)
    np.testing.assert_array_equal(_no_diag_grid(pj, buf, n, content, blk._SORT_EXT),
                                  jax_grid(pj, buf, n, content))
    if name in ("zeros", "period3"):
        monkeypatch.setattr(blk, "_SORT_EXT", 8)
        assert blk.sort_ext(pt) < blk._len_cap(pt)
        assert (_no_diag_grid(pj, buf, n, content, 8)
                != jax_grid(pj, buf, n, content)).any()


@pytest.mark.parametrize("content", [False, True], ids=["R", "X"])
def test_find_window_fits_for_every_knob_value(monkeypatch, content):
    """The staged window (a tile of sort ranks and the chain's halo) at
    every probe depth and candidate count the port accepts fits a CTA's
    shared memory; one that would not raises, naming the knob."""
    p = blk.BlockParams(lanes=8, steps=64, mode="X" if content else "R")
    probes = range(0, 65) if content else range(1, 65)
    for n_c in range(1, blk.MAX_CANDS + 1):
        for probe in probes:
            if content:
                monkeypatch.setenv("CPX_X_CANDS", str(n_c))
                monkeypatch.setenv("CPX_X_PROBE", str(probe))
            else:
                monkeypatch.setattr(blk, "_R_CANDS", n_c)
                monkeypatch.setattr(blk, "_R_PROBE", probe)
            chain = max(probe, n_c) + (0 if content else probe)
            size = blk.k4_find_smem(p, content)
            assert size == (blk.K4_FIND_TILE + chain) * blk.K4_STAGE_BYTES
            assert size <= blk.K4_SMEM_MAX
            blk._check_find_window(p, content)
    knob = "CPX_X_PROBE" if content else "CPX_R_PROBE"
    if content:
        monkeypatch.setenv(knob, "4000")
    else:
        monkeypatch.setattr(blk, "_R_PROBE", 4000)
    with pytest.raises(NotImplementedError, match=knob):
        blk._check_find_window(p, content)


def test_find_constants_match_the_kernel_source():
    """block.py's copies of the find's tile, staged bytes and shared-memory
    limit are sortfind.cu's."""
    src = (build.CSRC / "sortfind.cu").read_text()
    assert f"#define K4_TILE {blk.K4_FIND_TILE} " in src
    assert f"#define K4_STAGE_BYTES {blk.K4_STAGE_BYTES}\n" in src
    assert f"#define K4_SMEM_MAX ({blk.K4_SMEM_MAX // 1024} * 1024)" in src
