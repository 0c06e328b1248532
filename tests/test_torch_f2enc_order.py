"""The order of K9's token pass and of K3b's one-pass compaction mirrored on
the CPU (``comprox_tpu_torch/csrc/f2enc.cu``, ``csrc/rans.cu``), and held
exactly (tolerance 0) to the plain versions and to JAX.

K9 is a token pass on the adaptive path's kernels: ``k9_norm`` (the exact
normalisation and each symbol's cumulative frequency), ``k9_events`` (a
(step, lane) cell a thread, token t S + l: K3's event grid [T', 9, S],
(c, f, flag) for slot 0 SYM, 1 XTR1, 2 XTR2, flag 0 where the event is
absent), K3's scan, K3p's pack and K3b's compaction.  The mirror writes
the grid by the kernels' own arithmetic and runs the plain K3 and K3p on
it, then the K3b mirror; the result must be ``encode_scan_plain``'s, and
at S=8/T=64 and S=512/T=32 JAX's ``_encode_fast`` (its buffer reversed:
it holds the words in emission order).

K3b's mirror replays its schedule in numpy: a block's mask is one flat bit
string; tiles of ``K3B_THREADS`` threads, each a 16-byte piece counted
from the 16-byte boundary at or below the block's segment, whose start
need not be aligned (the pieces the segment covers only in part read a
byte at a time, and memory around the segments holds other bytes);
tickets in the order CTAs start; each tile's word published as its
aggregate and then as its inclusive prefix, and a look-back by a warp,
``K3B_LOOK`` words a lane, over the words of earlier tickets, under
three schedules (each tile done before the next starts, random
interleaving, every aggregate published before any look-back); then the
writes, a thread's flagged words in order where its warp's threads hold
few, else a mask word at a time across the warp's lanes.  It must equal
``compact_stream_plain``.

Three faults seeded in the mirror must fail the checks: XTR1 and XTR2
swapped, a look-back that counts a tile's aggregate twice (its window
moved one tile short), and a span one flag short at a block's
boundary (the segment's last flag dropped where its tail piece is read a
byte at a time).
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu.codec import block as jblk
from comprox_tpu.codec import fast as jfast
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec import fast as tfast
from comprox_tpu_torch.ops.rans_scalar import M, M_BITS, RANS_L
from comprox_tpu_torch.utils import build

torch.set_num_threads(1)

RANS_SRC = (build.CSRC / "rans.cu").read_text()
F2ENC_SRC = (build.CSRC / "f2enc.cu").read_text()
def define(name):
    return int(re.search(rf"#define {name} (\d+)", RANS_SRC).group(1))


K3B_THREADS, K3B_BATCH, K3B_LOOK = define("K3B_THREADS"), define("K3B_BATCH"), define("K3B_LOOK")
W = tfast.W_SYM
AGG, INCL = 1, 2  # a look-back word's flags


# ---- K9 ---------------------------------------------------------------------


def k9_norm(hist):
    """``k9_norm``: (freq, cum) of the raw counts, int64."""
    h = np.maximum(hist.astype(np.int64), 0)
    while h.sum() >= 1 << 15:
        h = np.where(h > 0, np.maximum(h >> 1, 1), 0)
    n2 = max(int(h.sum()), 1)
    s = np.where(h > 0, np.maximum(1, (h << M_BITS) // n2), 0)
    drift = M - int(s.sum())
    j = np.arange(W)
    best = int(((s << 10) | (1023 - j)).max())  # the first largest
    s[1023 - (best & 1023)] += drift
    return s, np.concatenate([[0], np.cumsum(s)[:-1]])


def k9_events(S, n_tok, sym, xtr, tbits, freq, cum, fault=""):
    """``k9_events``: the grid [T', 9, S] int32 of tokens ``sym, xtr, tbits``
    (numpy int32)."""
    steps = -(-n_tok // S)
    k = np.arange(steps * S)
    act = k < n_tok
    kk = np.minimum(k, max(n_tok - 1, 0))
    sy = np.where(act, np.clip(sym[kk], 0, W - 1), 0)
    xt = np.where(act, xtr[kk].view(np.uint32).astype(np.int64), 0)
    tb = np.where(act, tbits[kk], 0).astype(np.int64)
    b1 = np.clip(tb, 0, M_BITS)
    b2 = np.clip(tb - np.minimum(tb, M_BITS), 0, M_BITS)
    f1, f2 = 1 << (M_BITS - b1), 1 << (M_BITS - b2)
    mask32 = (1 << 32) - 1
    slots = [
        (np.where(act, cum[sy], 0), np.where(act, freq[sy], 0), act),
        (np.where(b1 > 0, ((xt & (M - 1)) * f1) & mask32, 0), f1, b1 > 0),
        (np.where(b2 > 0, ((xt >> M_BITS) * f2) & mask32, 0), f2, b2 > 0),
    ]
    if fault == "swap":
        slots[1], slots[2] = slots[2], slots[1]
    rows = [r for c, f, fl in slots for r in (c, f, fl.astype(np.int64))]
    ev = np.stack(rows).reshape(9, steps, S).transpose(1, 0, 2)
    return torch.from_numpy(ev.astype(np.uint32).view(np.int32).copy())


def k9_mirror(p, sym, xtr, tbits, n_tok, fault=""):
    """K9 by the kernels' order: (freq, states, stream) as
    ``encode_scan_plain`` returns them."""
    s = sym[:n_tok]
    hist = np.bincount(s[(s >= 0) & (s < W)], minlength=W)
    freq, cum = k9_norm(hist)
    if n_tok == 0:
        return freq, np.full(p.lanes, RANS_L), np.zeros(0, np.int64)
    ev = k9_events(p.lanes, n_tok, sym, xtr, tbits, freq, cum, fault)
    states, emit, words = blk.rans_scan_plain(p, ev)
    packed = blk.pack_emit_plain(emit)
    nw, stream = k3b_mirror(packed.numpy().reshape(1, -1, p.lanes // 8),
                            words.numpy().reshape(1, -1, p.lanes))
    return freq, states.numpy(), stream[0, : nw[0]].astype(np.int64) & 0xFFFF


def k8_tokens(rng, n_tok, literal=False):
    """Tokens shaped as K8 writes them: literals, or matches whose extra
    bits are what their symbol says (len_bits + dist_bits: 0 to 30, so one,
    both or no XTR event), the value below 2^bits."""
    m = max(n_tok, 1)
    is_m = np.zeros(m, bool) if literal else rng.random(m) < 0.6
    db, lb = rng.integers(0, 25, m), rng.integers(0, tfast.L_BUCKETS, m)
    sym = np.where(is_m, 256 + db * tfast.L_BUCKETS + lb, rng.integers(0, 256, m))
    bits = (np.where(lb >= tfast.L_DIRECT, lb - 5, 0)
            + np.where(db == tfast.DB_REPEAT, 0, db))
    tbits = np.where(is_m, bits, 0)
    xtr = rng.integers(0, 1 << 62, m, dtype=np.uint64) & (
        (np.uint64(1) << tbits.astype(np.uint64)) - np.uint64(1))
    return (sym.astype(np.int32), xtr.astype(np.uint32).view(np.int32),
            tbits.astype(np.int32))


GEOS = {8: 64, 72: 16, 512: 32}  # lanes: steps


def k9_case(lanes, kind):
    p = blk.BlockParams(lanes=lanes, steps=GEOS[lanes], mode="F", min_len=6, window=64)
    n_tok = dict(none=0, one=1, under_s=lanes - 3, ragged=5 * lanes + 3,
                 full=p.capacity, literals=3 * lanes + 5)[kind]
    rng = np.random.default_rng([lanes, len(kind)])
    return p, n_tok, k8_tokens(rng, n_tok, kind == "literals")


def k9_matches_plain(p, n_tok, toks, fault=""):
    want = tfast.encode_scan_plain(p, *(torch.from_numpy(t) for t in toks), n_tok)
    got = k9_mirror(p, *toks, n_tok, fault)
    return all(np.array_equal(np.asarray(g), w.numpy()) for g, w in zip(got, want))


K9_KINDS = ("none", "one", "under_s", "ragged", "full", "literals")


@pytest.mark.parametrize("kind", K9_KINDS)
@pytest.mark.parametrize("lanes", sorted(GEOS))
def test_k9_mirror_equals_the_plain_version(lanes, kind):
    p, n_tok, toks = k9_case(lanes, kind)
    assert k9_matches_plain(p, n_tok, toks)
    if kind in ("full", "ragged"):  # both XTR events occur, and events without bits
        tb = toks[2][:n_tok]
        assert (tb > 15).any() and (tb == 0).any()


@functools.lru_cache(maxsize=None)
def jax_block(lanes, steps):
    """A text block at (lanes, steps), the port's plain tokens of it, and
    JAX's ``_encode_fast`` of it."""
    from test_fast import corpus

    kw = dict(lanes=lanes, steps=steps, mode="F", min_len=6, window=64 if lanes == 8 else 250)
    pj, pt = jblk.BlockParams(**kw), blk.BlockParams(**kw)
    n = pt.capacity - 37
    buf = np.zeros((lanes, steps), np.uint8)
    buf.reshape(-1)[:n] = corpus("text", n, seed=3)
    inp = torch.from_numpy(buf)
    _, n_tok, sym, xtr, tbits = tfast.tokenize_plain(
        pt, inp, n, tfast._fast_find_matches(pt, inp, n))
    freq, x, words, n_words, n_tok_j, _ = jfast._encode_fast(
        pj, jnp.asarray(buf), jnp.int32(n), pj.lanes)
    assert int(n_tok_j) == n_tok
    jax_out = (np.asarray(freq), np.asarray(x), np.asarray(words)[: int(n_words)])
    return pt, n_tok, tuple(t.numpy() for t in (sym, xtr, tbits)), jax_out


@pytest.mark.parametrize("lanes,steps", [(8, 64), (512, 32)])
def test_k9_mirror_equals_jax(lanes, steps):
    """The mirror on the port's tokens of a text block against JAX's whole
    encode: the table, the states, the stream (JAX's buffer reversed) and
    its count."""
    p, n_tok, toks, (freq, x, buf) = jax_block(lanes, steps)
    got_freq, got_x, stream = k9_mirror(p, *toks, n_tok)
    np.testing.assert_array_equal(got_freq, freq)
    np.testing.assert_array_equal(got_x, x.astype(np.int64))
    assert stream.size == buf.size > 0
    np.testing.assert_array_equal(stream, buf[::-1].astype(np.int64))


# ---- K3b --------------------------------------------------------------------


def tile_count(S, rows, threads=K3B_THREADS):
    """``k3b_tile_count``: the 16-byte pieces a block's segment can touch,
    ``threads`` a tile."""
    return (rows * S // 8 // 16 + 2 + threads - 1) // threads


def look_back(agg, width, schedule, rng, fault=""):
    """The tiles' exclusive prefixes by the kernel's protocol, replayed under
    ``schedule``.  Tickets go out in start order; a started tile publishes
    its aggregate (tile 0 its inclusive prefix) and then looks back
    ``width`` (its warp's lanes times ``K3B_LOOK``) wide: the tile at
    distance i + 1 below is read, and waited for while unpublished; the
    nearest inclusive prefix ends the walk (the tiles up to it summed),
    else all are summed and the walk moves ``width`` tiles down."""
    n = len(agg)
    word = [None] * n
    excl = [None] * n
    walks = {}  # tile -> [j, sum so far]
    started = 0

    def start():
        nonlocal started
        t = started
        started += 1
        word[t] = (INCL if t == 0 else AGG, agg[t])
        if t == 0:
            excl[0] = 0
        else:
            walks[t] = [t - 1, 0]

    def step(t):
        """One round of tile t's walk; False where a word it reads is unpublished."""
        j, acc = walks[t]
        ks = [j - i for i in range(width)]
        if any(k >= 0 and word[k] is None for k in ks):
            return False
        vals = [word[k] if k >= 0 else (INCL, 0) for k in ks]
        incl = [i for i, v in enumerate(vals) if v[0] == INCL]
        last = incl[0] if incl else width - 1
        acc += sum(v[1] for v in vals[: last + 1])
        if incl:
            excl[t] = acc
            word[t] = (INCL, acc + agg[t])
            del walks[t]
        else:
            walks[t] = [j - width + (fault == "twice"), acc]
        return True

    if schedule == "in_order":
        for _ in range(n):
            start()
            while started - 1 in walks:
                assert step(started - 1)
    elif schedule == "aggs_first":
        while started < n:
            start()
        for t in rng.permutation(list(walks)):
            while t in walks:
                assert step(t)
    else:  # shuffled: any enabled action next
        while started < n or walks:
            acts = (["start"] if started < n else []) + list(walks)
            a = acts[rng.integers(len(acts))]
            if a == "start":
                start()
            else:
                step(a)  # a blocked walk just spins
    assert all(e is not None for e in excl)
    return excl


def k3b_mirror(packed, words, offset=0, threads=K3B_THREADS, schedule="shuffled",
               seed=0, fault=""):
    """K3b's pass on G blocks: ``packed`` [G, rows, S/8] uint8 and ``words``
    [G, rows, S] int32 -> (n_words [G], stream [G, rows S] int32 of the low
    16 bits; n_words -1 where a word would land past the block's
    stream).  The masks lie back to back from ``offset`` bytes past a
    16-byte boundary, between bytes that are no block's.  A warp whose
    threads hold at most ``K3B_BATCH`` flags each writes a thread's words in
    order; a denser warp a mask word at a time, lane i taking flag i of
    lane s's word w: words_flat[bit0_i + 128 (s - i) + 32 w + i] to the
    word's first place plus the set flags below lane i."""
    rng = np.random.default_rng(seed)
    G, rows, S8 = packed.shape
    S, nb = 8 * S8, rows * S8
    mem = rng.integers(0, 256, offset + G * nb + 64).astype(np.uint8)
    mem[offset: offset + G * nb] = packed.reshape(-1)
    tiles = tile_count(S, rows, threads)
    n_words = np.zeros(G, np.int64)
    stream = np.zeros((G, rows * S), np.int64)
    for b in range(G):
        s0 = offset + b * nb
        s1, a0 = s0 + nb, s0 & ~15
        wild = False
        flat = words[b].reshape(-1).astype(np.int64)
        at = a0 + 16 * np.arange(tiles * threads)  # each thread's piece
        addr = at[:, None] + np.arange(16)
        inside = (addr >= s0) & (addr < s1)
        full = (at >= s0) & (at + 16 <= s1)
        part = ~full & inside.any(axis=1)  # read a byte at a time
        byt = np.where(full[:, None] | (part[:, None] & inside),
                       mem[np.minimum(addr, mem.size - 1)], 0).astype(np.uint8)
        if fault == "short":
            byt[part[:, None] & (addr == s1 - 1)] &= 0x7F
        bits = np.unpackbits(byt, axis=1, bitorder="little").astype(np.int64)  # piece flag i
        cnt = bits.sum(axis=1).reshape(tiles, threads)
        excl = look_back(cnt.sum(axis=1).tolist(), 32 * K3B_LOOK, schedule, rng, fault)
        bit0 = (at - s0) * 8  # each thread's first flag
        for t in range(tiles):
            ex = np.concatenate([[0], np.cumsum(cnt[t])[:-1]])  # the CTA scan
            o = excl[t] + ex
            src, dst = [], []  # the words' flat indices and their places
            for w0 in range(0, threads, 32):  # a warp
                lanes = np.arange(w0, min(w0 + 32, threads))
                c = t * threads + lanes
                if cnt[t, lanes].max() <= K3B_BATCH:  # each thread its own, in order
                    ks, ps = np.nonzero(bits[c])
                    src.append(bit0[c][ks] + ps)
                    dst.append(o[lanes][ks] + (np.cumsum(bits[c], axis=1) - 1)[ks, ps])
                    continue
                # a mask word at a time across the lanes: flag i of word w
                # of lane s, read by lane i
                for w in range(4):
                    wd = bits[c, 32 * w: 32 * w + 32]
                    ob = o[lanes] + bits[c, : 32 * w].sum(axis=1)
                    ks, i = np.nonzero(wd)
                    lane_bit0 = (a0 + 16 * (t * threads + w0 + i) - s0) * 8
                    src.append(lane_bit0 + 128 * (lanes[ks] - (w0 + i)) + 32 * w + i)
                    dst.append(ob[ks] + (np.cumsum(wd, axis=1) - 1)[ks, i])
            if not src:
                continue
            pos, out = np.concatenate(src), np.concatenate(dst)
            assert (pos >= 0).all() and (pos < rows * S).all()
            inside = out < rows * S  # a write past the block's stream: a fault
            stream[b, out[inside]] = flat[pos[inside]] & 0xFFFF
            wild |= not inside.all()
        n_words[b] = -1 if wild else excl[-1] + cnt[-1].sum()
    return n_words, stream


def mask_words(rng, G, steps, n_slots, lanes, kinds):
    """G blocks' K3p masks and K3's words, block b all silent, all emitting
    or of flag density ``kinds[b]``."""
    emit = np.stack([np.zeros((steps, n_slots, lanes), bool) if k == "silent"
                     else np.ones((steps, n_slots, lanes), bool) if k == "all"
                     else rng.random((steps, n_slots, lanes)) < k for k in kinds])
    words = rng.integers(0, 1 << 16, (G, steps, n_slots, lanes)).astype(np.int32)
    packed = np.stack([blk.pack_emit_plain(torch.from_numpy(e)).numpy() for e in emit])
    return packed, words


def k3b_matches_plain(packed, words, **kw):
    G, steps, n_slots, s8 = packed.shape
    nw, stream = k3b_mirror(packed.reshape(G, -1, s8), words.reshape(G, steps * n_slots, -1),
                            **kw)
    for b in range(G):
        want_nw, want = blk.compact_stream_plain(torch.from_numpy(packed[b]),
                                                 torch.from_numpy(words[b]))
        want = want.numpy().astype(np.int64) & 0xFFFF
        if nw[b] != int(want_nw) or not np.array_equal(stream[b, : nw[b]], want[: nw[b]]):
            return False
    return True


# (lanes, steps, slots, kinds of the G blocks, offset of the first mask)
K3B_CASES = [
    (8, 37, 3, (0.3,), 0),
    (8, 37, 5, ("all", 0.3, "silent", 0.05), 3),
    (72, 11, 3, (0.3, "all", 0.1, "all"), 7),
    (72, 1, 5, ("all", "all", 0.5, "silent"), 15),
    (512, 19, 3, (0.0085, "all", "silent", 0.3), 0),
    (512, 9, 5, (0.1, 0.3), 9),
]
SCHEDULES = ("in_order", "shuffled", "aggs_first")


def k3b_case(case):
    lanes, steps, n_slots, kinds, offset = case
    rng = np.random.default_rng([lanes, steps, n_slots, len(kinds)])
    return mask_words(rng, len(kinds), steps, n_slots, lanes, kinds), offset


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("threads", [K3B_THREADS, 1])
@pytest.mark.parametrize("case", K3B_CASES, ids=str)
def test_k3b_mirror_equals_the_plain_version(case, threads, schedule):
    """The source's tile, and tiles of one thread, so that small blocks
    have hundreds of tiles and the walks cross windows."""
    (packed, words), offset = k3b_case(case)
    assert k3b_matches_plain(packed, words, offset=offset, threads=threads,
                             schedule=schedule, seed=len(schedule))


def test_k3b_mirror_takes_many_tiles_and_long_walks():
    """Five tiles of the source's size and hundreds of one-thread
    tiles, every aggregate published before any look-back: walks that cross
    several windows before an inclusive prefix."""
    rng = np.random.default_rng(11)
    packed, words = mask_words(rng, 2, 91, 3, 512, (0.05, "all"))
    assert tile_count(512, 91 * 3) == 5
    for threads in (K3B_THREADS, 1):
        assert k3b_matches_plain(packed, words, offset=5, threads=threads,
                                 schedule="aggs_first", seed=threads)


# ---- seeded faults ----------------------------------------------------------


def k9_fault_cases():
    return [k9_case(lanes, kind) for lanes in sorted(GEOS) for kind in K9_KINDS]


def k3b_fault_cases():
    return [(k3b_case(c), threads, schedule) for c in K3B_CASES
            for threads in (K3B_THREADS, 1) for schedule in SCHEDULES]


def test_seeded_faults_fail_the_checks():
    """Each seeded fault fails these many of the mirrors' cases.  The swapped
    XTR events: the 9 K9 cases with a token of more than 15 extra bits
    (where a token has only XTR1, the swap puts the identity first, which
    moves nothing).  The look-back counting a tile twice: the 2 cases whose
    walks cross a window of 32 ``K3B_LOOK`` tiles with no inclusive prefix
    in it (one-thread tiles at S = 512, every aggregate published first).  The short span:
    the 24 cases with a block whose last flag is set in a tail piece read a
    byte at a time."""
    k9 = k9_fault_cases()
    swapped = sum(not k9_matches_plain(*c, fault="swap") for c in k9)
    k3b = k3b_fault_cases()
    counts = {}
    for fault in ("twice", "short"):
        counts[fault] = sum(
            not k3b_matches_plain(packed, words, offset=offset, threads=threads,
                                  schedule=schedule, seed=len(schedule), fault=fault)
            for ((packed, words), offset), threads, schedule in k3b)
    assert (len(k9), swapped) == (18, 9)
    assert len(k3b) == 36 and counts == {"twice": 2, "short": 24}, counts


def test_mirror_matches_the_kernel_source():
    """The lines of the kernels whose order the mirror writes down."""
    for line in ("e[0] = act ? cum[sy] : 0;",
                 "e[3 * S] = b1 > 0 ? (int)((xt & (RANS_M - 1u)) * f1) : 0;",
                 "e[6 * S] = b2 > 0 ? (int)((xt >> M_BITS) * f2) : 0;",
                 "const int b2 = min(max(tb - min(tb, M_BITS), 0), M_BITS);",
                 "int rc = cpx_k3_launch(1, S, steps, 3, ev, states, emit, words, stream);",
                 "return cpx_k3b_launch(1, S, 3 * steps, packed, words, parts, n_words, "
                 "stream_out, stream);"):
        assert line in F2ENC_SRC, line
    for line in ("const long long pieces = (long long)rows * S / 8 / 16 + 2;",
                 "const long long at = (s0 & ~15ll) + 16ll * ((long long)tile * K3B_THREADS "
                 "+ threadIdx.x);",
                 "for (int j = tile - 1;; j -= window) {",
                 "v[r] = j - d0 - r >= 0 ? k3b_load(look + j - d0 - r) : K3B_INCL << 32;",
                 "const int d0 = K3B_LOOK * (threadIdx.x & 31);  // this lane's first distance",
                 "if ((v[r] >> 32) == K3B_INCL) near = d0 + r;",
                 "if (d0 + r <= last) val += (int)(uint32_t)v[r];",
                 "if (__reduce_max_sync(full, (unsigned)cnt) <= K3B_BATCH) {",
                 "pos[u] = lo ? __ffsll(lo) - 1 : hi ? 63 + __ffsll(hi) : -1;",
                 "if (pos[u] >= 0) v[u] = words[bit0 + pos[u]];",
                 "if (pos[u] >= 0) stream[o + u] = (int16_t)v[u];",
                 "if (wd[u] >> lane & 1u) v[u] = words[bit0 + 128ll * (src - lane) + 32 * w + lane];",
                 "if (wd[u] >> lane & 1u) stream[at_[u] + __popc(wd[u] & below)] = (int16_t)v[u];"):
        assert line in RANS_SRC, line
    # K3 puts the slots from the last down: XTR2, XTR1, SYM
    assert "for (int si = NS - 1; si >= 0; --si) {" in RANS_SRC
