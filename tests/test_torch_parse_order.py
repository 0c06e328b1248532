"""The order of work of the card's K6 and K11 (``csrc/parse.cu``,
``csrc/xrep.cu``), mirrored in PyTorch and held to the JAX package exactly.

The mirrors live here, in the test, and on no path of the port: they
compute what the kernels compute, in the kernels' order, so that the
reordering itself is checked on the CPU, where no kernel runs.

- K6's mirror (``parse_order``): per lane, the prefix minima of the cost
  window as a ring of 256 keys ``cost * 512 + (u & 511)``, the new cost
  entering at the window's start each step; a candidate's part is one
  lookup at ``t + min(len, window)`` plus its price, or (2^22 - 1,
  ``min(len, window)``) where that saturates; the candidates' best (the
  later one on a tie) of a group of four steps is computed before the step
  above the group is decided (one step at a time where the window starts
  less than four steps on), and each step itself is the literal compare,
  done last.
- K11's mirror (``rep_order``): the forward walk, the equality grid as
  one elementwise pass, and the backward run lengths as a segmented count
  in tiles of 32 steps from the top (the kernel's two ballots and a
  first-set-bit), the run carried from the tile above.

The references: ``_parse_body`` step by step under the reversed order of
the scan (untraced, so that a patched literal price binds), and
``_sim_prev_dist`` / ``_rep_lengths``.  S=8/T=64 and S=512/T=32; inputs
from seeded numpy; tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comprox_tpu.codec import block as jblk
from comprox_tpu_torch.codec import block as blk

from test_block import corpus

torch.set_num_threads(1)

P_INF = 1 << 22
NONE = 0x7FFFFFFF  # the key of a candidate with no admissible length
_L = torch.int64

SMALL = dict(lanes=8, steps=64, min_len=6, window=32, o3_bits=14, rolz_bits=10,
             rolz_depth=16)
WIDE = dict(SMALL, lanes=512, steps=32, window=250, rolz_ctx_bytes=4)
GEO = {"small": SMALL, "wide": WIDE}
X_PRICES = (jblk._P_LIT_X, jblk._P_XM, jblk._P_XK, jblk._P_XREP)
F_PRICES = (36, 40, 9)


def params(geo, mode, **kw):
    kw = {**GEO[geo], "mode": mode, **({"min_len": 5} if mode == "R" else {}), **kw}
    return jblk.BlockParams(**kw), blk.BlockParams(**kw)


# ------------------------------------------------------------ mirrors ------


def parse_order(p, n, cands, prices=None, n_c=None, rep=None, group=4):
    """K6 in the card kernel's order: the prefix-minimum ring, a lookup a
    candidate, the candidates of a group of ``group`` steps priced before
    the step above them is decided (one step where the window starts less
    than ``group`` steps on), the literal compared last.  The arguments and
    the result are ``blk.parse_scan``'s."""
    S, T, W = p.lanes, p.steps, p.window
    fast = prices is not None
    g = cands.to(_L)
    if fast:
        lit, p_m, p_k = prices[:3]
        p_rep = prices[3] if len(prices) > 3 else 0
        rg = None if rep is None else rep.to(_L)
        n_ct = n_c + (rep is not None)
    else:
        lit, p_m, p_k, p_rep = blk._P_LIT_R, blk._P_RM, blk._P_RI, 0
        n_c = (g.shape[0] - 1) // 3
        n_ct = n_c
    lo = max(p.min_len, 1)
    lo_q = min(lo, W)  # where the prefix minima start
    kg = group if lo_q >= group else 1
    lanes = torch.arange(S)
    slots = torch.arange(256)
    a = T + lo_q  # step T: every cost past the block is 0
    st = {"q": ((a + ((slots - a) & 255)) & 511).expand(S, 256).clone(),
          "ring": torch.zeros((S, 256), dtype=_L),
          "next": torch.zeros(S, dtype=_L)}
    dec = torch.zeros((3 if fast else 4, T, S), dtype=torch.int32)

    def advance(x):
        """The minima of step x from those of step x + 1."""
        u_n = x + lo_q
        c_n = torch.zeros(S, dtype=_L) if u_n >= T else st["ring"][:, u_n & 255]
        keep = (st["q"] < ((c_n + 1) << 9)[:, None]) & (slots != (u_n & 255))[None, :]
        st["q"] = torch.where(keep, st["q"], ((c_n << 9) | (u_n & 511))[:, None])

    def price(x, q):
        """Step x's candidates against its minima ``q``: the warp's minimum
        key and each candidate's (l, src, idx)."""
        pos = lanes * T + x
        keys, ls, srcs, idxs = [], [], [], []
        for k in range(n_ct):
            ix = torch.zeros(S, dtype=_L)
            if not fast:
                lx, sx, ix = g[3 * k, x], g[3 * k + 1, x], g[3 * k + 2, x]
                pr = p_m + p_k * blk._rec_bucket(ix).to(_L)
            elif k < n_c:
                lx, sx = g[2 * k, x], g[2 * k + 1, x]
                d = (pos - sx).clamp_min(1)
                pr = p_m + p_k * blk._dist_bucket(d)
                if rg is not None:
                    pr = torch.where(d == rg[1, x], p_rep, pr)
            else:  # the repeat candidate
                lx, sx = rg[0, x], pos - rg[1, x]
                pr = torch.full_like(pos, p_rep)
            L = lx.clamp_max(W)
            qk = q.gather(1, ((x + L) & 255)[:, None])[:, 0]
            v = (qk >> 9) + pr
            sat = v >= P_INF - 1
            ok = L >= lo
            keys.append(torch.where(ok, torch.where(sat, P_INF - 1, v) * 16 + 15 - k, NONE))
            ls.append(torch.where(sat, L, ((qk & 511) - x) & 511))
            srcs.append(sx)
            idxs.append(ix)
        return (torch.stack(keys).min(dim=0).values, torch.stack(ls),
                torch.stack(srcs), torch.stack(idxs))

    def price_group(x0):
        """Steps x0 .. x0 - kg + 1: each one's minima, then its candidates."""
        qs = []
        for k in range(kg):
            advance(x0 - k)
            qs.append(st["q"])
        return [price(x0 - k, qs[k]) if x0 - k >= 0 else None for k in range(kg)]

    def decide(t, cand):
        key, ls, srcs, idxs = cand
        lit_c = lit + st["next"]
        best = key >> 4
        match = best <= lit_c
        active = lanes * T + t < n
        cost_t = torch.where(active, torch.minimum(torch.minimum(lit_c, best),
                                                   torch.tensor(P_INF - 1)), 0)
        win = (15 - (key & 15))[None, :]
        dec[0, t] = torch.where(match & active, ls.gather(0, win)[0], 0)
        dec[1, t] = torch.where(match, srcs.gather(0, win)[0], 0)
        dec[2, t] = torch.where(match, idxs.gather(0, win)[0], 0)
        if not fast:
            dec[3, t] = g[3 * n_c, t]  # the fill, passed through
        st["ring"][:, t & 255] = cost_t
        st["next"] = cost_t

    cands_k = price_group(T - 1)  # windows past the block: lo_q >= kg
    for t0 in range(T - 1, -1, -kg):
        for k in range(kg):
            if t0 - k >= 0:
                decide(t0 - k, cands_k[k])
        cands_k = price_group(t0 - kg)
    return dec


def rep_order(p, inp, n, dec):
    """K11 in the card kernel's order: the forward walk, the eq grid in one
    elementwise pass, the run lengths in tiles of 32 steps from the top
    (ballots of eq and of "continues", the first step at or above that
    ends a run).  The arguments and the result are ``blk.rep_scan``'s."""
    S, T = p.lanes, p.steps
    take, src = dec[0].to(_L), dec[1].to(_L)
    lanes = torch.arange(S)
    prev = torch.empty((T, S), dtype=_L)
    rem, dist = torch.zeros(S, dtype=_L), torch.ones(S, dtype=_L)
    for t in range(T):
        prev[t] = dist
        start = (rem == 0) & (take[t] > 0)
        dist = torch.where(start, (lanes * T + t - src[t]).clamp_min(1), dist)
        rem = torch.where(rem > 0, rem - 1, torch.where(start, take[t] - 1, 0))
    flat = inp.reshape(-1).to(_L)
    ts = torch.arange(T)[:, None]
    pos = lanes[None, :] * T + ts
    src_rep = pos - prev
    eq = ((pos < n) & (src_rep >= 0) & (src_rep % T < ts)
          & (flat[pos] == flat[src_rep.clamp(0, flat.numel() - 1)]))
    nt = (T + 31) // 32
    pad = nt * 32 - T
    eq_p = torch.cat([eq, torch.zeros((pad, S), dtype=torch.bool)])
    prev_p = torch.cat([prev, torch.ones((pad, S), dtype=_L)])
    bits = 1 << torch.arange(32, dtype=_L)[:, None]
    js = torch.arange(32, dtype=_L)[:, None]
    rl = torch.zeros((nt * 32, S), dtype=_L)
    carry_rl, carry_prev = torch.zeros(S, dtype=_L), torch.ones(S, dtype=_L)
    for i in range(nt - 1, -1, -1):
        e_t, p_t = eq_p[32 * i: 32 * i + 32], prev_p[32 * i: 32 * i + 32]
        p_nx = torch.cat([p_t[1:], carry_prev[None]])
        F = (e_t.to(_L) * bits).sum(dim=0)
        C = ((e_t & (p_nx == p_t)).to(_L) * bits).sum(dim=0)
        stop = ~C[None, :] & ((0xFFFFFFFF << js) & 0xFFFFFFFF)
        low = stop & -stop
        e = torch.log2(low.clamp_min(1).double()).to(_L)  # the first set bit
        r = torch.where(stop != 0, (e - js) + ((F[None, :] >> e) & 1),
                        (32 - js) + carry_rl[None, :])
        rl[32 * i: 32 * i + 32] = r
        carry_rl, carry_prev = r[0], p_t[0]
    cap = torch.clamp(n - pos, max=torch.tensor(T) - ts)
    cap = cap.clamp_max(min(p.window, p.min_len + 256 - 1)).clamp_min(0)
    return torch.stack([torch.minimum(rl[:T], cap), prev]).to(torch.int32)


# --------------------------------------------------------- references ------


def jax_parse(pj, n, g, n_c, prices=None, rep=None):
    """``_parse_body`` under the reversed order of the scan, step by step
    (untraced: a patched literal price binds): (take, src, idx)."""
    cw = jnp.zeros((pj.lanes, pj.window), jnp.int32)
    per = 3 if pj.mode == "R" else 2
    ref = np.zeros((3, pj.steps, pj.lanes), np.int32)
    for t in range(pj.steps - 1, -1, -1):
        xs = (jnp.int32(t),) + tuple(jnp.asarray(x[t]) for x in g[:per * n_c])
        if rep is not None:
            xs += (jnp.asarray(rep[0][t]), jnp.asarray(rep[1][t]))
        cw, dec = jblk._parse_body(pj, jnp.int32(n), cw, xs, n_c=n_c, prices=prices)
        ref[:, t] = np.stack([np.asarray(d) for d in dec])
    return ref, np.asarray(cw)


def jax_rep(pj, buf, n, take, src):
    ts = jnp.arange(pj.steps, dtype=jnp.int32)
    prev = jblk._sim_prev_dist(pj, ts, jnp.asarray(take), jnp.asarray(src))
    lrep = jblk._rep_lengths(pj, jnp.asarray(buf.reshape(-1)), jnp.int32(n), ts, prev)
    return np.stack([np.asarray(lrep), np.asarray(prev)]).astype(np.int32)


# -------------------------------------------------------------- inputs -----


def pos_grid(p):
    return np.arange(p.lanes)[None, :] * p.steps + np.arange(p.steps)[:, None]


def cands_r(rng, p, n_c, max_len, ties=False):
    """Mode R grids (len, src, idx per candidate, then the fill)."""
    shape = (p.steps, p.lanes)
    g = np.zeros((3 * n_c + 1, *shape), np.int32)
    for k in range(n_c):
        g[3 * k] = rng.integers(0, max_len + 1, shape)
        g[3 * k][rng.random(shape) < 0.4] = 0
        g[3 * k + 1] = rng.integers(-1, p.capacity, shape)
        g[3 * k + 2] = rng.integers(0, 40, shape)
    g[3 * n_c] = rng.integers(0, 17, shape)
    if ties:  # every candidate alike: every compare between them is a tie
        for k in range(1, n_c):
            g[3 * k], g[3 * k + 2] = g[0], g[2]
    return g


def cands_x(rng, p, n_c, max_len, ties=False):
    """Modes F and X grids (len, src per candidate), sources before and
    after the position and -1."""
    shape = (p.steps, p.lanes)
    g = np.zeros((2 * n_c, *shape), np.int32)
    for k in range(n_c):
        g[2 * k] = rng.integers(0, max_len + 1, shape)
        g[2 * k][rng.random(shape) < 0.4] = 0
        g[2 * k + 1] = pos_grid(p) - rng.integers(-1, 700, shape)
    if ties:
        for k in range(1, n_c):
            g[2 * k], g[2 * k + 1] = g[0], g[1]
    return g


def rep_pair(rng, p, g, max_len):
    shape = (p.steps, p.lanes)
    rep = np.stack([rng.integers(0, max_len + 1, shape),
                    rng.integers(1, 700, shape)]).astype(np.int32)
    rep[0][rng.random(shape) < 0.4] = 0
    same = rng.random(shape) < 0.3  # a normal candidate at the repeat distance
    g[1] = np.where(same, pos_grid(p) - rep[1], g[1])
    return rep


def check_parse(pj, pt, n, g, n_c, prices=None, rep=None, group=4):
    # JAX's non-R branch takes four prices; the fourth prices no F candidate
    jp = None if prices is None else tuple(prices) + (0,) * (4 - len(prices))
    ref, cw = jax_parse(pj, n, g, n_c, jp, rep)
    got = parse_order(pt, n, torch.from_numpy(g), prices, n_c,
                      None if rep is None else torch.from_numpy(rep), group)
    np.testing.assert_array_equal(got[:3].numpy(), ref)
    if prices is None:
        np.testing.assert_array_equal(got[3].numpy(), g[3 * n_c])
    return ref, cw


# --------------------------------------------------------------- K6 --------

ARMS = ["R", "F", "X", "Xrep"]


def arm_inputs(arm, rng, pt, max_len, ties=False):
    """(grids, candidates, prices, repeat pair) of an arm."""
    if arm == "R":
        return cands_r(rng, pt, 5, max_len, ties), 5, None, None
    n_c = 2 if arm == "F" else 3
    g = cands_x(rng, pt, n_c, max_len, ties)
    prices = F_PRICES if arm == "F" else X_PRICES
    rep = rep_pair(rng, pt, g, max_len) if arm == "Xrep" else None
    return g, n_c, prices, rep


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("geo", ["small", "wide"])
@pytest.mark.parametrize("arm", ARMS)
def test_parse_order_equals_jax_on_random_candidates(arm, geo, group):
    """Dense candidates, lengths past the window, sources after the
    position and -1; the last positions past n; groups of four steps
    priced together and one at a time."""
    pj, pt = params(geo, "R" if arm == "R" else "X")
    rng = np.random.default_rng(ARMS.index(arm) + 10 * group)
    g, n_c, prices, rep = arm_inputs(arm, rng, pt, pt.window + 3)
    ref, _ = check_parse(pj, pt, pt.capacity - 37, g, n_c, prices, rep, group)
    assert (ref[0] >= pt.min_len).any() and (ref[0] == 0).any()


@pytest.mark.parametrize("geo", ["small", "wide"])
@pytest.mark.parametrize("arm", ARMS)
def test_parse_order_all_ties(arm, geo):
    """Every candidate alike, and every length at the window (all costs of
    a window equal in a run of matches): each compare is a tie, settled
    by the later candidate and the longest length."""
    pj, pt = params(geo, "R" if arm == "R" else "X")
    rng = np.random.default_rng(3)
    g, n_c, prices, rep = arm_inputs(arm, rng, pt, pt.window, ties=True)
    per = 3 if arm == "R" else 2
    g[0:per * n_c:per] = np.where(g[0:per * n_c:per] > 0, pt.window, 0)
    if rep is not None:
        rep[0] = np.where(rep[0] > 0, pt.window, 0)
    ref, _ = check_parse(pj, pt, pt.capacity, g, n_c, prices, rep)
    taken = ref[0] > 0
    assert taken.any()
    if rep is None:  # the last candidate wins every tie between them
        np.testing.assert_array_equal(ref[1][taken], g[per * (n_c - 1) + 1][taken])


@pytest.mark.parametrize("arm", ARMS)
def test_parse_order_saturates(arm, monkeypatch):
    """A literal price that drives the cost-to-go to its ceiling 2^22 - 1
    (the prices of test_parse_f_prices_and_saturation): the saturated arm
    takes the longest admissible length; no admissible length never wins."""
    monkeypatch.setattr(jblk, "_P_LIT_R", 300000)
    monkeypatch.setattr(blk, "_P_LIT_R", 300000)
    pj, pt = params("small", "R" if arm == "R" else "X", min_len=4)
    rng = np.random.default_rng(11)
    g, n_c, prices, rep = arm_inputs(arm, rng, pt, 12)
    per = 3 if arm == "R" else 2
    g[0:per * n_c:per][:, rng.random(g[0].shape) < 0.7] = 0
    if rep is not None:
        rep[0][rng.random(g[0].shape) < 0.9] = 0
    if prices is not None:
        prices = (300000, 45, 9, 30)[:len(prices)]
    ref, cw = check_parse(pj, pt, pt.capacity, g, n_c, prices, rep)
    assert int(cw.max()) == P_INF - 1
    none = (g[0:per * n_c:per] < pt.min_len).all(axis=0)
    if rep is not None:
        none &= rep[0] < pt.min_len
    assert none.any() and (ref[0][none] == 0).all()


@pytest.mark.parametrize("min_len", [1, 4, 6])
@pytest.mark.parametrize("arm", ARMS)
def test_parse_order_min_len(arm, min_len):
    """min_len 1 prices a step's candidates one step ahead, against the
    cost just written (the literal's own chain); 4 and 6 in groups of four
    steps, before the step above the group is decided."""
    pj, pt = params("small", "R" if arm == "R" else "X", min_len=min_len)
    rng = np.random.default_rng(20 + min_len)
    g, n_c, prices, rep = arm_inputs(arm, rng, pt, pt.window + 2)
    ref, _ = check_parse(pj, pt, pt.capacity - 5, g, n_c, prices, rep)
    assert (ref[0] > 0).any() and (ref[0][ref[0] > 0] >= min_len).all()


@pytest.mark.parametrize("geo", ["small", "wide"])
@pytest.mark.parametrize("short", [1, 300])
def test_parse_order_short_block(geo, short):
    """n < S * T: positions past n take no match and cost 0."""
    pj, pt = params(geo, "R")
    rng = np.random.default_rng(short)
    g = cands_r(rng, pt, 5, pt.window)
    n = pt.capacity - short
    ref, _ = check_parse(pj, pt, n, g, 5)
    past = pos_grid(pt) >= n
    assert past.any() and (ref[0][past] == 0).all() and (ref[0][~past] > 0).any()


# --------------------------------------------------------------- K11 -------


@pytest.mark.parametrize("geo", ["small", "wide"])
@pytest.mark.parametrize("name,short", [("text", 0), ("zeros", 3), ("period7", 100),
                                        ("lowentropy", 0)])
def test_rep_order_equals_jax_on_a_parse(name, geo, short):
    """On the decisions of K6's mirror over random candidates (tolerance 0)."""
    pj, pt = params(geo, "X")
    n = pt.capacity - short
    buf = np.zeros((pt.lanes, pt.steps), np.uint8)
    buf.reshape(-1)[:n] = corpus(name, n, seed=4)
    rng = np.random.default_rng(5)
    g = cands_x(rng, pt, 3, pt.window)
    dec = parse_order(pt, n, torch.from_numpy(g), X_PRICES, 3)
    got = rep_order(pt, torch.from_numpy(buf), n, dec)
    np.testing.assert_array_equal(
        got.numpy(), jax_rep(pj, buf, n, dec[0].numpy(), dec[1].numpy()))


@pytest.mark.parametrize("geo", ["small", "wide"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rep_order_restarts_mid_run(geo, seed):
    """Bytes where every causal distance matches (zeros) or many do
    (period 7, low entropy) and decisions that start copies at changing
    distances inside runs: a run restarts where prev changes, past the
    last step the distance counts as 1, runs cross the 32-step tiles."""
    pj, pt = params(geo, "X")
    rng = np.random.default_rng(seed)
    n = pt.capacity - 7 * seed
    buf = np.zeros((pt.lanes, pt.steps), np.uint8)
    buf.reshape(-1)[:n] = corpus(("zeros", "period7", "lowentropy")[seed], n, seed=seed)
    shape = (pt.steps, pt.lanes)
    take = rng.integers(1, 9, shape).astype(np.int32)
    take[rng.random(shape) < 0.6] = 0
    dist = rng.choice(np.array([1, 7, 14, 3, pt.steps + 1, 2 * pt.steps]), shape)
    src = (pos_grid(pt) - dist + (rng.random(shape) < 0.05) * 5 * pt.steps).astype(np.int32)
    got = rep_order(pt, torch.from_numpy(buf), n, torch.from_numpy(np.stack([take, src])))
    ref = jax_rep(pj, buf, n, take, src)
    np.testing.assert_array_equal(got.numpy(), ref)
    changes = (ref[1][1:] != ref[1][:-1]) & (ref[0][:-1] > 0)
    assert (ref[0] > 0).any() and changes.any()
    if seed == 0 and pt.steps > 32:
        assert (ref[0][31] > 1).any(), "a run must cross a tile"


# ------------------------------------------------------- timing tools ------


@pytest.mark.parametrize("mode", ["R", "X", "F"])
def test_times_logs_each_launch_of_the_parse(mode):
    """``phases times`` pairs each K6 and K11 launch of an encode with its
    row (mode X: the first K6, K11, the second K6) and its work; the block
    API's entries are its own again afterwards."""
    from comprox_tpu_torch.benchmarks import phases
    from comprox_tpu_torch.codec import fast

    kw = dict(R=dict(mode="R", min_len=5, window=32, rolz_bits=10, rolz_depth=16,
                     rolz_ctx_bytes=4, rolz_dec=2),
              X=dict(mode="X", min_len=6, window=32, rolz_ctx_bytes=4),
              F=dict(mode="F", min_len=5, window=32))[mode]
    p = blk.BlockParams(lanes=8, steps=64, o3_bits=12, flexible=True, **kw)
    data = np.frombuffer((b"the cat sat on the mat; " * 40)[: p.capacity - 5], np.uint8)
    saved = (blk.parse_scan, blk.rep_scan)
    log = []
    with phases._parse_launches(log):
        if mode == "F":
            fast.encode_block_fast(data, p, "cpu")
        else:
            blk.encode_block(data, p, "cpu")
    want = {"R": ["K6 (R)"], "X": ["K6 (X) 1", "K11", "K6 (X) 2"], "F": ["K6 (F)"]}[mode]
    assert [row for row, _, _ in log] == want
    assert all(b > 0 and o > 0 for _, b, o in log)
    assert (blk.parse_scan, blk.rep_scan) == saved


def _defines(src):
    import re

    return {k: int(v) for k, v in re.findall(r"#define (K\w+) (\d+)\b", src)}


def test_kernel_tiles_fit_in_shared_memory():
    """K6's dynamic shared memory (its groups' minima, the cost ring, the
    decision tiles and K6_NB input tiles of every grid) fits a CTA at the
    most candidates the entries take, and four CTAs an SM (a warp a
    scheduler at -g4) at the default paths' counts; K11's static tiles fit
    the 48 KB a CTA has without opting in."""
    from comprox_tpu_torch.utils import build

    d = _defines((build.CSRC / "parse.cu").read_text())
    W, D, NB, KG = d["K6_W"], d["K6_D"], d["K6_NB"], d["K6_GROUP"]
    plane = D * W + 1

    def k6_bytes(n_grids):
        return 4 * (W * KG * 256 + W * 256 + 2 * 3 * plane + NB * n_grids * plane)

    assert k6_bytes(3 * d["K6_MAX_CANDS"] + 1) <= 227 * 1024
    r_grids = 3 * (blk._R_CANDS + 1) + 1
    x_grids = 2 * blk._finder_config(blk.BlockParams(lanes=8, steps=64, mode="X", min_len=6,
                                                     window=32), True)[0] + 2
    assert 4 * (k6_bytes(max(r_grids, x_grids)) + 1024) <= 228 * 1024
    k = _defines((build.CSRC / "xrep.cu").read_text())
    k11 = 4 * (k["K11_NB"] * 2 * k["K11_TF"] * k["K11_L"] + 2 * 32 * 33)
    assert k11 <= 48 * 1024
