"""K7's kernel order (mode F's entries of csrc/sortfind.cu) mirrored in numpy
and held to the JAX package's ``fast._f2_find``, exactly (tolerance 0).

The mirror does what the kernels do, in their order: the keys (the
position's own six bytes, K4x's hash) and the stable sort; ``mirror_find``
takes the sort ranks in tiles (of ``FIND_TILE`` ranks here, so that S=8,
T=64 has every edge), stages each tile's ranks and the n_cands ranks before
it (key, position, the 8 bytes at the position), takes the n_cands nearest
earlier ranks whole as the candidates (a candidate of another key is -1),
every one usable inside the block, and writes a record a position with its
(cand, len | flags) pairs, marking a winner whose 8-byte probe matched whole;
``mirror_heads`` extends from byte 8 the marked winners whose pair one step
up (i + 1, cand + 1) is no usable winner in the final stage's chunk;
``mirror_final`` takes each lane in chunks of ``FINAL_CHUNK`` steps from the
chunk's top step down: a marked winner left takes min(1 + its link's
length, ext), and where the extension falls short of the window the
diagonal run of each slot is a backward recurrence started the window
above the chunk, with or without the byte where it ends
(``CPX_F_DIAG_TAIL``).

Inputs made to break it: an all-zero block (one key over every tile, runs
to the cap), period-3 content, runs across the chunks, blocks that end
inside their last lane, and the knobs ``CPX_F_CANDS`` 1 and 7 (records of
32 and 64 bytes), a small ``CPX_F_EXTW`` (the walk arm) and
``CPX_F_DIAG_TAIL=1``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu.codec import block as jblk
from comprox_tpu.codec import fast as jfast
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec import fast as tfast
from comprox_tpu_torch.utils import build

from test_fast import corpus

torch.set_num_threads(1)

FIND_TILE = 16  # sort ranks a find CTA in the mirror (the kernel: 256)
FINAL_CHUNK = 16  # steps a final thread in the mirror (the kernel: 64, 512)
FIND_OK, FIND_EQ1 = 1 << 17, 1 << 16  # csrc/sortlib.cuh's lw flags
K4_EXT = 1 << 18  # sortfind.cu's: the probe matched 8 bytes, extend
INT_MIN = -(1 << 31)

GEOMETRIES = {
    # window < T: the walk starts inside the lane; ext 60 >= window: no walk
    "s8t64": dict(lanes=8, steps=64, mode="F", min_len=6, window=24),
    # the main path's lanes and window at a small T
    "s512t32": dict(lanes=512, steps=32, mode="F", min_len=6, window=250),
}
# (corpus, geometry, bytes short of a full block)
CASES = [
    ("zeros", "s8t64", 0), ("period3", "s8t64", 0), ("text", "s8t64", 0),
    ("random", "s8t64", 0), ("text", "s8t64", 37), ("zeros", "s8t64", 61),
    ("period3", "s8t64", 5), ("zeros", "s512t32", 0), ("period3", "s512t32", 3000),
    ("text", "s512t32", 7),
]


def f_corpus(name, n, seed=1):
    if name == "period3":
        pat = np.random.default_rng(seed).integers(0, 256, 3, dtype=np.uint8)
        return np.tile(pat, n // 3 + 1)[:n]
    return corpus(name, n, seed=seed)


def params(geo):
    kw = GEOMETRIES[geo]
    return jblk.BlockParams(**kw), blk.BlockParams(**kw)


def block_buf(name, pj, short):
    n = pj.capacity - short
    buf = np.zeros((pj.lanes, pj.steps), np.uint8)
    buf.reshape(-1)[:n] = f_corpus(name, n)
    return buf, n


def jax_grid(pj, buf, n):
    """JAX's [2 * n_cands, T, S] grids under the current knobs (untraced, so
    that a patched knob is the one it reads)."""
    outs = jfast._f2_find(pj, jnp.asarray(buf.reshape(-1)), jnp.int32(n))
    return np.stack([np.asarray(g).reshape(pj.lanes, pj.steps).T
                     for l, s in outs for g in (l, s)])


def lead_eq(a, b):
    """Leading equal bytes of two [..., w] rows of bytes."""
    return np.cumprod(a == b, axis=-1).sum(-1)


def ext_bytes() -> int:
    """The word extension's bytes: 4 * (EXTW - 1)."""
    return 4 * (tfast._EXTW - 1)


def mirror_find(pt, b, n: int, tile: int = FIND_TILE):
    """Keys, sort and k4_find's mode-F arm: the records [N, ints]."""
    big, n_c = pt.capacity, tfast._F_CANDS
    keys = tfast.sort_keys_plain(pt, torch.from_numpy(b), n).numpy()
    order = np.argsort(keys, kind="stable")
    hs, ps = keys[order], order
    ext = ext_bytes()
    pre = np.stack([b[k: k + big] for k in range(8)], axis=1).astype(np.int64)
    rec = np.zeros((big, blk.k4_record_ints(n_c)), np.int64)
    for r0 in range(0, big, tile):
        # the staged window: ranks r0 - n_c .. r0 + tile
        q = np.arange(r0 - n_c, min(r0 + tile, big))
        ok_q = q >= 0
        s_key = np.where(ok_q, hs[q.clip(0)], 0)
        s_pos = np.where(ok_q, ps[q.clip(0)], -1)
        s_pre = np.where(ok_q[:, None], pre[s_pos.clip(0)], 0)
        for s0 in range(n_c, len(q)):
            i = s_pos[s0]
            for u in range(n_c):
                sl = s0 - 1 - u
                match = s_pos[sl] >= 0 and s_key[sl] == s_key[s0]
                cand = s_pos[sl] if match else -1
                lw = 0
                if match and i < n:
                    plen = int(lead_eq(s_pre[sl], s_pre[s0]))
                    lw = (min(plen, ext) | FIND_OK
                          | (FIND_EQ1 if s_pre[sl][0] == s_pre[s0][0] else 0)
                          | (K4_EXT if plen == 8 and ext > 8 else 0))
                rec[i, 2 * u], rec[i, 2 * u + 1] = cand, lw
    return rec


def extension(b, cand, i, ext: int):
    """The match length at (i, cand), whose first 8 bytes match: bytes
    compared from byte 8 on, at most ext."""
    reach = np.arange(ext - 8)
    return 8 + int(lead_eq(b[cand + 8 + reach], b[i + 8 + reach]))


def link(rec_up, cand, n_c: int):
    """The lw of the usable winner cand + 1 in the record one step up, else
    0."""
    for w in range(n_c):
        if rec_up[2 * w] == cand + 1 and rec_up[2 * w + 1] & FIND_OK:
            return int(rec_up[2 * w + 1])
    return 0


def walks(pt) -> bool:
    """The final stage's arm: the diagonal runs where the extension falls
    short of the length cap, the window."""
    return ext_bytes() < pt.window


def mirror_heads(pt, b, rec, chunk: int = FINAL_CHUNK):
    """k4_heads: the marked winners with no link in their chunk, extended
    from byte 8 (in place)."""
    T, n_c, ext = pt.steps, tfast._F_CANDS, ext_bytes()
    for i in range(pt.capacity):
        t = i % T
        inside = t + 1 < min((t // chunk + 1) * chunk, T)
        for u in range(n_c):
            cand, lw = rec[i, 2 * u], rec[i, 2 * u + 1]
            if lw & K4_EXT and not (inside and link(rec[i + 1], cand, n_c)):
                rec[i, 2 * u + 1] = (lw & ~(0xFFFF | K4_EXT)) | extension(b, cand, i, ext)
    return rec


def mirror_final(pt, rec, n: int, walk: bool, tail: bool, chunk: int = FINAL_CHUNK):
    """k4_final's mode-F arms: the records -> [2 * n_c, T, S]."""
    S, T, n_c, ext = pt.lanes, pt.steps, tfast._F_CANDS, ext_bytes()
    len_cap = pt.window
    r = rec.reshape(S, T, -1).copy()
    out = np.zeros((2 * n_c, T, S), np.int64)
    for lane in range(S):
        for c0 in range(0, T, chunk):
            c1 = min(c0 + chunk, T)
            top = min(c1 + len_cap, T) if walk else c1
            up = np.full(n_c, INT_MIN, np.int64)
            if walk and not tail and top == T and lane + 1 < S:
                # the diagonal runs on into the next lane: without the tail
                # the lane's last step needs it (JAX's runs are flat)
                up = r[lane + 1, 0, 0: 2 * n_c: 2].copy()
            run = np.zeros(n_c, np.int64)
            for t in range(top - 1, c0 - 1, -1):
                i = lane * T + t
                cap = max(min(T - t, n - i, len_cap), 0)
                for u in range(n_c):
                    cand, lw = r[lane, t, 2 * u], r[lane, t, 2 * u + 1]
                    if t < c1 and lw & K4_EXT:
                        above = link(r[lane, t + 1], cand, n_c)
                        lw = (lw & ~(0xFFFF | K4_EXT)) | min(1 + (above & 0xFFFF), ext)
                        r[lane, t, 2 * u + 1] = lw
                    length = lw & 0xFFFF
                    if walk:
                        eq1 = bool(lw & FIND_EQ1)
                        diag = up[u] == cand + 1
                        run[u] = (run[u] + 1 if diag else int(tail)) if eq1 else 0
                        length = max(length, run[u])
                        up[u] = cand
                    if t < c1:
                        out[2 * u, t, lane] = min(length, cap) if lw & FIND_OK else 0
                        out[2 * u + 1, t, lane] = cand
    return out


def check_mirror(name, geo, short):
    """The mirror's grids equal JAX's by the arm the kernel takes, and by
    the walk arm too where the extension reaches the window."""
    pj, pt = params(geo)
    buf, n = block_buf(name, pj, short)
    ref = jax_grid(pj, buf, n)
    b = tfast.pad_block(pt, torch.from_numpy(buf)).numpy().astype(np.int64)
    assert b.size == blk.pad_block_len(pt, 4 * tfast._EXTW)
    rec = mirror_find(pt, b, n)
    assert (rec[:, 2 * tfast._F_CANDS:] == 0).all()
    if ext_bytes() > 8:
        mirror_heads(pt, b, rec)
    else:
        assert not (rec[:, 1::2] & K4_EXT).any()
    tail = bool(tfast._F_DIAG_TAIL)
    np.testing.assert_array_equal(mirror_final(pt, rec, n, walks(pt), tail), ref)
    if not walks(pt):
        np.testing.assert_array_equal(mirror_final(pt, rec, n, True, tail), ref)
    return ref


@pytest.mark.parametrize("name,geo,short", CASES)
def test_mirror_equals_jax(name, geo, short):
    ref = check_mirror(name, geo, short)
    if name != "random":
        assert (ref[0] > 0).any(), "the case must have matches"


KNOB_CASES = [("zeros", "s8t64", 0), ("period3", "s8t64", 9), ("text", "s8t64", 3),
              ("period3", "s512t32", 100)]


@pytest.mark.parametrize("name,geo,short", KNOB_CASES)
@pytest.mark.parametrize("knob", ["cands1", "cands7", "extw2", "extw3 tail", "tail"])
def test_mirror_under_knobs(monkeypatch, knob, name, geo, short):
    """CPX_F_CANDS 1 and 7, CPX_F_EXTW 2 and 3 (4 and 8 bytes: the walk arm,
    no or few marks) and CPX_F_DIAG_TAIL=1, in both packages."""
    for mod in (jfast, tfast):
        if knob.startswith("cands"):
            monkeypatch.setattr(mod, "_F_CANDS", int(knob[5:]))
        if knob.startswith("extw"):
            monkeypatch.setattr(mod, "_EXTW", int(knob[4]))
        if knob.endswith("tail"):
            monkeypatch.setattr(mod, "_F_DIAG_TAIL", True)
    ref = check_mirror(name, geo, short)
    if knob.startswith("extw") and name != "text":
        assert ref[0].max() > ext_bytes(), "the diagonal runs must lengthen a match"


@pytest.mark.parametrize("extw", [16, 64])
def test_walk_arm_follows_the_extension(monkeypatch, extw):
    """The final stage walks only where the extension falls short of the
    window: at the defaults (60 bytes against the main path's 250) it does;
    at CPX_F_EXTW=64 (252 bytes) it does not, and the mirror's walk arm
    gives the same grids there."""
    monkeypatch.setattr(tfast, "_EXTW", extw)
    monkeypatch.setattr(jfast, "_EXTW", extw)
    assert walks(params("s512t32")[1]) == (extw == 16)
    check_mirror("period3", "s512t32", 11)


def test_finder_final_is_gone():
    """K7 runs on sortfind.cu's stages: no source keeps the forward diagonal
    walk (finder_final) or a finder of its own for mode F."""
    srcs = {p.name: p.read_text() for p in build._sources()}
    assert "f2find.cu" not in srcs
    assert not any("finder_final" in s for s in srcs.values())
    sf = srcs["sortfind.cu"]
    for entry in ("cpx_k7_keys_launch", "cpx_k7_find_launch"):
        assert f'extern "C" int {entry}(' in sf
    assert "find_arms<true>" in sf.split('extern "C" int cpx_k7_find_launch')[1]
