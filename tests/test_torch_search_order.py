"""KS's and KSx's kernel order (csrc/search.cu) mirrored in torch and held
to the port's plain ``search_scan_plain`` and to the JAX package's
``_search_body`` scan, exactly (tolerance 0).

The mirror does what the kernel does, in its order, each step:
- every key first: the search rows' (KS: ctx4's bucket; KSx: also x_hash8
  of the lane's own next 8 bytes), the insert rows' (ctx4bn's bucket; KSx
  also position pos-7's content bucket, from ctx4bn and ctx4n) and KSx's
  near-match slot (x_hash6);
- one read of every row and of the cache word, all as step t-1 left them:
  the insert rows are read before any write of the step;
- the insert ranks (lower lanes with the same key, counted up to D);
- a lane's four threads (``TPL``; one above 2048 lanes) take the row's
  pairs q, q + 4, ... and keep each its own top K (4, or 8 above a top_k of
  4) of the keys (score + 2) << 40 | position << 8 | slot, KSx's entries
  at or after the position scored -1 (``mask_fwd``); the quad merges them
  by k_top rounds of the maximum of the threads' heads, the owner's head
  taken off; the fill and each candidate's recency are sums over the
  threads;
- the insert slot: the insert row's entries packed into position << 7 |
  slot, rank + 1 rounds, each the least key above the last pick over the
  quad;
- the probes, candidate k on thread k % TPL (score 4 only), the first
  longest by the maximum of (length << 4 | 15 - k); the winner extended
  over the window, thread q its bytes 64 q .., the first difference the
  least; the cap;
- the stores: each slot written (KSx's content entry of position pos-7,
  ``X_INSERT_LATE``), then KSx's cache maximum.

Cases: S=8/T=64 and S=512/T=32, modes R and X, text, an all-zero block
(one hot bucket: every lane's inserts in one row, ranks past D), period 7,
random bytes, ragged n, top_k 1, 4 and 8, probe 16, 32 and 48.
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

_i64 = torch.int64
MASK32 = 0xFFFFFFFF
LEN_W = 256  # csrc/ppm_r.cuh
X_INSERT_LATE = 7  # search.cu's

SMALL = dict(lanes=8, steps=64, min_len=5, window=32, o3_bits=13, rolz_bits=8,
             rolz_depth=16)
WIDE = dict(SMALL, lanes=512, steps=32, window=250, rolz_bits=10, rolz_ctx_bytes=4)
GEO = {"small": SMALL, "wide": WIDE}


def tpl_of(lanes: int) -> int:
    """Threads a lane (search.cu's ks_tpl)."""
    return 4 if lanes <= 2048 else 1


def k_list(top_k: int) -> int:
    """The length of a thread's own top list (search.cu's K)."""
    return 4 if top_k <= 4 else 8


def after(e, j, P, J):
    """(e, j) after (P, J) in (position, slot) order."""
    return (e > P) | ((e == P) & (j > J))


def first_diff(a, b, width: int):
    """The common prefix of two [S, >= width] byte rows, up to width."""
    ne = (a[:, :width] != b[:, :width]).to(_i64)
    return torch.where(ne.any(1), ne.argmax(1), width)


class Mirror:
    """The kernel's step on the CPU, lanes vectorised."""

    def __init__(self, p, inp, n: int):
        self.p, self.n = p, n
        self.S, self.T, self.d = p.lanes, p.steps, p.rolz_depth
        self.tpl, self.K = tpl_of(p.lanes), k_list(p.top_k)
        self.k_top = min(p.top_k, self.d)
        self.cap = p.capacity
        self.flat = torch.cat([inp.reshape(-1).to(_i64),
                               torch.zeros(512, dtype=_i64)])
        self.lane = torch.arange(self.S)
        slot = torch.arange(self.d)
        self.slot = slot
        self.owner = (slot // 2) % self.tpl  # the thread of each slot's pair

    def own_bytes(self, t: int, width: int):
        """[S, width] the lanes' next bytes, zero past each lane's row."""
        cur = self.lane * self.T + t
        idx = cur[:, None] + torch.arange(width)
        return torch.where(idx < (self.lane[:, None] + 1) * self.T,
                           self.flat[idx.clamp(max=self.flat.numel() - 1)], 0)

    def cand_bytes(self, src, width: int):
        """[S, width] the block's bytes at src (>= 0), zero past the block."""
        idx = src.clamp_min(0)[:, None] + torch.arange(width)
        return torch.where(idx < self.cap, self.flat[idx.clamp(max=self.flat.numel() - 1)], 0)

    def keys(self, row, own4, limit):
        """[S, D] each entry's rank key (search.cu::entry_key)."""
        e, y = row[..., 0].to(_i64), row[..., 1].to(_i64) & MASK32
        diff = y ^ own4[:, None]
        zero_bytes = torch.stack([(diff >> (8 * k)) & 0xFF == 0 for k in range(4)], -1)
        sc = torch.cumprod(zero_bytes.to(_i64), -1).sum(-1)  # trailing zero bytes
        s2 = torch.where((e > 0) & (e - 1 < limit[:, None]), sc + 2, 1)
        return (s2 << 40) | ((e & MASK32) << 8) | self.slot

    def top_k(self, keys):
        """scan_top: each thread's top K, then k_top rounds of the quad's
        maximum -> ([S, k_top] keys, descending)."""
        lists = []
        for q in range(self.tpl):
            mine = torch.where(self.owner == q, keys, 0)
            lists.append(torch.sort(mine, dim=1, descending=True).values[:, : self.K])
        lists = torch.stack(lists, 1)  # [S, TPL, K]
        lists = torch.cat([lists, torch.zeros_like(lists[..., :1])], -1)
        head = torch.zeros((self.S, self.tpl), dtype=_i64)
        cand = []
        for _ in range(self.k_top):
            heads = torch.gather(lists, 2, head[..., None])[..., 0]
            m = heads.max(1).values
            cand.append(m)
            head = head + (heads == m[:, None]).to(_i64)  # the owner's head taken off
        return torch.stack(cand, 1)

    def thread_sums(self, flags):
        """A per-slot count summed over each thread's slots, then the quad."""
        return sum((flags & (self.owner == q)).sum(1) for q in range(self.tpl))

    def recency(self, row, cand):
        e = row[..., 0].to(_i64)
        P, J = (cand >> 8) & MASK32, cand & 0xFF
        P = torch.where(P >= 1 << 31, P - (1 << 32), P)
        return torch.stack([self.thread_sums(after(e, self.slot, P[:, k, None], J[:, k, None]))
                            for k in range(cand.shape[1])], 1)

    def insert_slot(self, row, rank):
        """insert_slot32: each entry packed once into position << 7 | slot;
        rank + 1 rounds, each the least key at or above the last pick + 1,
        per thread its slots, then the quad's least."""
        key = (row[..., 0].to(_i64) << 7) | self.slot
        none = 1 << 32
        lo = torch.zeros(self.S, dtype=_i64)
        best = torch.full((self.S,), none, dtype=_i64)
        for rnd in range(int(rank.max().item()) + 1 if rank.numel() else 0):
            live = rank >= rnd
            per = torch.stack([torch.where((self.owner == q) & (key >= lo[:, None]), key, none)
                               .min(1).values for q in range(self.tpl)], 1)
            m = per.min(1).values
            best = torch.where(live, m, best)
            lo = torch.where(live, m + 1, lo)
        return torch.where(best < none, best & 127, -1)

    def probe_best(self, cand, t: int):
        """(length, k): candidate k on thread k % TPL, the quad's maximum of
        length << 4 | 15 - k."""
        p = self.p
        own = self.own_bytes(t, max(p.probe, 32))
        per = torch.zeros((self.S, self.tpl), dtype=_i64)
        for k in range(cand.shape[1]):
            key = cand[:, k]
            src = ((key >> 8) & 0x7FFFFFFF) - 1
            ln = first_diff(own, self.cand_bytes(src, own.shape[1]), p.probe)
            ln = torch.where(key >> 40 == 6, ln, 0)
            q = k % self.tpl
            per[:, q] = torch.maximum(per[:, q], (ln << 4) | (15 - k))
        best = per.max(1).values
        return best >> 4, 15 - (best & 15)

    def window_len(self, src, t: int):
        """prefix_len<TPL>: 64 bytes a thread and round (thread q bytes
        64 q .. of a round), the first difference the least."""
        w = self.p.window
        span = -(-w // 64) * 64
        own, cb = self.own_bytes(t, span), self.cand_bytes(src, span)
        firsts = []
        for lo in range(0, w, 64):
            hi = min(lo + 64, w)
            ne = own[:, lo:hi] != cb[:, lo:hi]
            firsts.append(torch.where(ne.any(1), lo + ne.to(_i64).argmax(1), w))
        return torch.stack(firsts, 1).min(1).values

    def len_cap(self, t: int):
        p = self.p
        pos = self.lane * self.T + t
        return torch.clamp(self.n - pos, max=min(self.T - t, min(p.window, p.min_len + LEN_W - 1)))

    def run(self, tables):
        """The grids [4 or 6, T, S]; the tables evolve in place."""
        p, S, d = self.p, self.S, self.d
        x = p.mode == "X"
        tabs = list(tables[:2]) if x else [tables]
        ctx4 = torch.zeros(S, dtype=_i64)
        ctx4b = torch.zeros(S, dtype=_i64)
        out = torch.zeros((6 if x else 4, self.T, S), dtype=torch.int32)
        rolz_bits, rkey = p.rolz_bits, functools.partial(blk._rolz_key, p=p)
        for t in range(self.T):
            pos = self.lane * self.T + t
            active = pos < self.n
            own8 = self.own_bytes(t, 8)
            own4 = own8[:, 0] | (own8[:, 1] << 8) | (own8[:, 2] << 16) | (own8[:, 3] << 24)
            fol4 = own8[:, 4] | (own8[:, 5] << 8) | (own8[:, 6] << 16) | (own8[:, 7] << 24)
            ctx4bn = torch.where(active, ((ctx4b << 8) | (ctx4 >> 24)) & MASK32, ctx4b)
            ctx4n = torch.where(active, ((ctx4 << 8) | own8[:, 0]) & MASK32, ctx4)
            rctx = blk.rolz_hash3(rkey(ctx4), rolz_bits)
            ctx_key = blk.rolz_hash3(rkey(ctx4bn), rolz_bits)
            if x:
                rs = [blk.x_hash8(own4, fol4, rolz_bits), rctx]
                ins = [torch.where(active & (t >= 10), blk.x_hash8(
                    blk._byteswap32(ctx4bn), blk._byteswap32(ctx4n), rolz_bits), -1),
                       torch.where(active & (t >= (7 if p.rolz_ctx_bytes == 4 else 6)),
                                   ctx_key, -1)]
                h6 = blk.x_hash6(own8)
                limit = pos
            else:
                rs = [rctx]
                ins_here = active & (t >= (7 if p.rolz_ctx_bytes == 4 else 6))
                if p.rolz_dec > 1:
                    ins_here = ins_here & (pos % p.rolz_dec == 0)
                ins = [torch.where(ins_here, ctx_key, -1)]
                limit = torch.full((S,), (1 << 31) - 1, dtype=_i64)
            # one read of every row and the cache word, as step t-1 left them
            srow = [tab[r.long()].clone() for tab, r in zip(tabs, rs)]
            irow = [tab[i.clamp_min(0).long()].clone() for tab, i in zip(tabs, ins)]
            near = tables[2][h6.long()].to(_i64) - 1 if x else None
            # the insert ranks: lower lanes with the same key, up to D
            ranks = []
            for i in ins:
                lower = torch.ones((S, S), dtype=torch.bool).tril(-1)
                same = (i[:, None] == i[None, :]) & (i[None, :] >= 0) & lower
                ranks.append(torch.where(i >= 0, same.sum(1).clamp(max=d), d))
            # the scans
            cands = [self.top_k(self.keys(row, own4, limit)) for row in srow]
            slots = [torch.where(rk < d, self.insert_slot(row, torch.where(rk < d, rk, -1)), -1)
                     for row, rk in zip(irow, ranks)]
            live = active & (t >= 7)
            lens, srcs, wins = [], [], []
            for cand in cands:
                ln, k = self.probe_best(cand, t)
                wins.append(k)
                key = torch.gather(cand, 1, k[:, None])[:, 0]
                src = ((key >> 8) & 0x7FFFFFFF) - 1
                ln = torch.where(ln >= p.probe, self.window_len(src, t), ln)
                lens.append(torch.minimum(ln, self.len_cap(t)))
                srcs.append(src)
            if x:
                ok2 = (near >= 0) & (near < pos) & live
                len2 = torch.where(ok2, self.window_len(near, t), 0)
                len2 = torch.minimum(len2, self.len_cap(t))
                rows_out = []
                for ln, src in zip(lens, srcs):
                    rows_out.append((torch.where((src >= 0) & (src < pos) & live, ln, 0), src))
                grids = (rows_out[0][0], rows_out[0][1], len2, near,
                         rows_out[1][0], rows_out[1][1])
            else:
                rec = torch.gather(self.recency(srow[0], cands[0]), 1, wins[0][:, None])[:, 0]
                fill = self.thread_sums(srow[0][..., 0] > 0)
                grids = (torch.where(live, lens[0], 0), srcs[0], rec, fill)
            for g, v in enumerate(grids):
                out[g, t] = v.to(torch.int32)
            # the stores, then KSx's cache maximum
            for r, (tab, i, sl) in enumerate(zip(tabs, ins, slots)):
                w = sl >= 0
                late = X_INSERT_LATE if x and r == 0 else 3
                val = blk._byteswap32(ctx4bn if x and r == 0 else ctx4n)
                tab[i[w].long(), sl[w].long(), 0] = (pos - late + 1)[w].to(torch.int32)
                tab[i[w].long(), sl[w].long(), 1] = blk._to_i32(val[w])
            if x:
                tables[2].scatter_reduce_(0, h6[active].long(), (pos + 1)[active].to(torch.int32),
                                          "amax", include_self=True)
            ctx4, ctx4b = ctx4n, ctx4bn
        return out


def params(mode, geo, **kw):
    kw = dict(GEO[geo], mode=mode, flexible=False, **kw)
    if mode == "R" and geo == "wide":
        kw["rolz_dec"] = 2
    return jblk.BlockParams(**kw), blk.BlockParams(**kw)


def block_buf(name, p, short, seed=3):
    n = p.capacity - short
    buf = np.zeros((p.lanes, p.steps), np.uint8)
    buf.reshape(-1)[:n] = corpus(name, n, seed=seed) if name != "zeros" else 0
    return buf, n


@functools.partial(jax.jit, static_argnums=0)
def jax_search_scan(p, inp, n):
    """The scan of ``_search_and_parse``'s else-branch, with its carry."""
    inp_pad = jnp.pad(inp, ((0, 0), (0, p.window + 1)))
    body = functools.partial(jblk._search_body, p, inp_pad,
                             jblk._pack_words(inp.reshape(-1)), n)
    return jax.lax.scan(body, jblk._init_carry(p, enc_side=True, search=True),
                        jnp.arange(p.steps, dtype=jnp.int32))


def check(mode, geo, name, short, with_jax=True, **kw):
    pj, pt = params(mode, geo, **kw)
    buf, n = block_buf(name, pj, short)
    inp = torch.from_numpy(buf)
    init = blk._init_rolz if mode == "R" else blk._init_xsearch
    tm, tp = init(pt, "cpu"), init(pt, "cpu")
    got = Mirror(pt, inp, n).run(tm)
    want = blk.search_scan_plain(pt, inp, n, tp)
    assert torch.equal(got, want)
    pairs = [(tm, tp)] if mode == "R" else list(zip(tm, tp))
    assert all(torch.equal(a, b) for a, b in pairs)
    if with_jax:
        c, outs = jax_search_scan(pj, jnp.asarray(buf), jnp.int32(n))
        np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(g) for g in outs]))
        keys = ("rolz_ent",) if mode == "R" else ("rolz_ent", "xctx_ent", "xshort")
        for tab, key in zip([tm] if mode == "R" else tm, keys):
            np.testing.assert_array_equal(blk.rolz_to_numpy(tab), np.asarray(c[key]))
    return got


CASES = [("text", "small", 0), ("zeros", "small", 0), ("period7", "small", 5),
         ("random", "small", 0), ("text", "small", 300), ("text", "wide", 100),
         ("zeros", "wide", 0), ("period7", "wide", 7)]


@pytest.mark.parametrize("name,geo,short", CASES)
@pytest.mark.parametrize("mode", ["R", "X"])
def test_mirror_equals_plain_and_jax(mode, name, geo, short):
    got = check(mode, geo, name, short)
    if name == "text":
        assert (got[0] > 0).any()


KNOBS = [dict(top_k=1), dict(top_k=4, probe=16), dict(top_k=8), dict(top_k=8, probe=48),
         dict(top_k=2, probe=48)]


@pytest.mark.parametrize("kw", KNOBS, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("mode", ["R", "X"])
def test_mirror_under_search_knobs(mode, kw):
    """top_k 1, 2, 4 and 8 (a thread's list of 4 or 8), probe 16, 32 and 48
    (probe32's path and prefix_len's)."""
    check(mode, "small", "text", 9, **dict(kw, window=64))


@pytest.mark.parametrize("mode", ["R", "X"])
def test_mirror_at_wide_knobs(mode):
    """S=512 with a deep top-k and a long probe, against the plain version."""
    check(mode, "wide", "text", 100, with_jax=False, top_k=8, probe=48)


def test_hot_bucket_ranks_pass_the_depth():
    """An all-zero block puts every lane's insert in one row a step: the
    lanes past the D-th take no slot, and the row stays full."""
    _, pt = params("R", "wide")
    m = Mirror(pt, torch.zeros((pt.lanes, pt.steps), dtype=torch.uint8), pt.capacity)
    rolz = blk._init_rolz(pt, "cpu")
    m.run(rolz)
    used = (rolz[..., 0] > 0).sum(1)
    assert used.max() == pt.rolz_depth and (used > 0).sum() <= 2


def test_mirror_constants_match_the_kernel_source():
    src = (build.CSRC / "search.cu").read_text()
    assert "#define KS_TPL 4" in src and "#define X_INSERT_LATE 7" in src
    assert "return S <= 2048 ? KS_TPL : 1;" in src
    assert "c.top_k <= 4" in src and "ks_launch_k<4, X>" in src
    assert blk._X_INSERT_LATE == X_INSERT_LATE
    assert f"#define LEN_W {LEN_W}" in (build.CSRC / "ppm_r.cuh").read_text()
