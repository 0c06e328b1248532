"""The step scans redesigned for the H100 — the rank scan K5 and the
modeling scan K2 with the lane-order ranks, row sums and C event they
share with K1, KS, KSx, K12e, K13e, K12d, K13d; the tableless decode scan
K12d / K13d with its warp symbol searches and stream windows, and K1's
searches — against their plain PyTorch versions at tolerance 0, and their
phase instrument.

This file imports no JAX, so that the ``cuda``-marked tests also run on a
card's machine without it:

    python -m pytest tests/test_torch_scans.py -m cuda -q --noconftest

The ``cuda`` tests skip where there is no card.
"""

import re
import types

import numpy as np
import pytest
import torch

from comprox_tpu_torch.benchmarks import phases
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.models import ppm
from comprox_tpu_torch.utils import build

torch.set_num_threads(1)

# the main path's lanes and knobs, small tables, a short block
FLEX = dict(lanes=512, steps=32, mode="R", min_len=5, window=32, o3_bits=14,
            rolz_bits=10, rolz_depth=16, flexible=True, rolz_ctx_bytes=4,
            rolz_dec=2)


@pytest.mark.parametrize("kernel", sorted(phases.PHASES))
def test_phase_names_match_the_stamps(kernel):
    """Each instrumented kernel's phase names (benchmarks/phases.py) are
    one a stamp of its source, stamps 0 .. N-1, and its build has the
    entry that reads them.  The two modes of the tableless decode scan
    (K12d, K13d) read their names from the one stamp set of the template
    (K12D), the three of the modeling scan (K2, K12e, K13e) from K2's, and
    each has its own entry and counters, built into its variant."""
    src, names, observers = phases.PHASES[kernel]
    text = (build.CSRC / src).read_text()
    tag = phases.STAMP_SET.get(kernel, kernel)
    n = int(re.search(rf"#define {tag}_PHASES (\d+)", text).group(1))
    stamps = sorted({int(k) for k in re.findall(rf"{tag}_STAMP\((\d+)\)", text)})
    assert len(names) == n and stamps == list(range(n))
    assert f"cpx_{kernel.lower()}_prof_read" in build._INSTRUMENTED
    assert f'extern "C" int cpx_{kernel.lower()}_prof_read' in text
    assert f"-DCPX_{tag}_PROF" in text
    assert observers in (1, 2, 3)
    if tag != kernel:
        assert f"{kernel.lower()}_prof[" in text
    if kernel in phases.DECODE_KERNELS:
        assert all(f"-DCPX_{t}_PROF" in phases.defines(0) for t in (tag, "K1"))
    else:
        assert kernel in phases.ENCODE_KERNELS and src in phases.ENCODE_SOURCES
        assert f"-DCPX_{tag}_PROF" in phases.ENCODE_DEFINES


def test_variant_takes_missing_entry_points_from_the_main_library():
    """A variant built from some of the sources answers for its own entry
    points; the main library's stand in for the rest."""
    variant = types.SimpleNamespace(cpx_k5_launch="variant")
    main = types.SimpleNamespace(cpx_k5_launch="main", cpx_k4_keys_launch="main")
    lib = build._Overlay(variant, main)
    assert lib.cpx_k5_launch == "variant"
    assert lib.cpx_k4_keys_launch == "main"
    with pytest.raises(AttributeError):
        lib.cpx_missing_launch


def test_phase_variants_are_built_from_their_sources():
    specs = phases.variant_specs((0, 4))
    assert specs[:2] == [(phases.defines(0), ("decode.cu",)),
                         (phases.defines(4), ("decode.cu",))]
    assert specs[2] == (("-DCPX_K5_PROF", "-DCPX_K2_PROF", "-DCPX_KS_PROF"),
                        ("rank.cu", "model.cu", "search.cu"))
    assert phases.variant_specs((), encode=False) == []
    keys = {build.library_path(*s) for s in specs}
    assert len(keys) == 3 and build.library_path() not in keys
    # the tableless scan's stamps are built into the decode variant
    assert set(phases.DECODE_KERNELS) == {"K1", "K12d", "K13d"}
    assert all(phases.PHASES[k][0] == "decode.cu" for k in phases.DECODE_KERNELS)


@pytest.mark.parametrize("mode", ["R", "X", "F"])
def test_bounds_log_every_other_kernel_of_the_encode(mode):
    """``phases bounds`` sees every launch of the kernels that are not step
    scans through their block API entries: a small block's encode (the
    plain versions on the CPU; the card runs the same entries) logs each
    one's bytes and operations under its row, and the entries are the
    module's own again afterwards."""
    from comprox_tpu_torch.codec import fast

    kw = dict(R=dict(mode="R", min_len=5, window=32, rolz_bits=10, rolz_depth=16,
                     rolz_ctx_bytes=4, rolz_dec=2),
              X=dict(mode="X", min_len=6, window=32, rolz_ctx_bytes=4),
              F=dict(mode="F", min_len=5, window=32))[mode]
    p = blk.BlockParams(lanes=8, steps=64, o3_bits=12, flexible=True, **kw)
    data = np.frombuffer((b"the cat sat on the mat; " * 40)[: p.capacity - 5], np.uint8)
    saved = {n: getattr(blk, n) for n in ("sort_candidates", "parse_scan", "_radix_sort")}
    log = {}
    with phases._bounds_of_entries(log):
        if mode == "F":
            fast.encode_block_fast(data, p, "cpu")
        else:
            blk.encode_block(data, p, "cpu")
    # (the sort's entry is its launcher, which only the card's finders call)
    want = dict(R={"K4", "K6 (R)", "K3", "K3p", "K3b"},
                X={"K4x", "K6 (X)", "K11", "K3 (5 slots)", "K3p (5 slots)",
                   "K3b (5 slots)"},
                F={"K7", "K6 (F)", "K8", "K9"})[mode]
    assert set(log) == want
    assert all(b > 0 and o > 0 for b, o in log.values())
    assert all(getattr(blk, n) is f for n, f in saved.items())


def test_every_kernel_has_one_work_model():
    """Each kernel the block API counts has its work in
    ``benchmarks/work.py``, which ``chip_smoke.py``'s cells and ``phases``
    (``times``, ``bounds``) both count with: a step scan by ``scan_ops``,
    every other kernel by the work function of the entry that launches it
    (K4x through K4's).  chip_smoke.py states no model of its own."""
    from comprox_tpu_torch.benchmarks import work

    assert set(work.SCAN_KERNELS).isdisjoint(phases.BOUND_ENTRIES)
    assert set(blk.LAUNCHES) == set(work.SCAN_KERNELS) | set(phases.BOUND_ENTRIES) | {"K4x"}
    assert all(rule.__module__ == work.__name__ for _, _, rule in phases.BOUND_ENTRIES.values())
    smoke = (build.CSRC.parents[1] / "chip_smoke.py").read_text()
    assert "PEAK_OPS_PER_S" not in smoke and "def _bound" not in smoke
    p = blk.BlockParams(lanes=8, steps=64, mode="R", min_len=5, window=32,
                        rolz_bits=10, rolz_depth=16)
    cands = torch.zeros(3 * blk._R_CANDS + 2, 64, 8, dtype=torch.int32)
    assert all(work.scan_ops(k, p, cands) >= p.capacity for k in work.SCAN_KERNELS)
    assert work.bound(3_350_000, 0) == (pytest.approx(1e-3, rel=1e-12), "bytes")
    assert work.bound(0, 67_000_000) == (pytest.approx(1e-3, rel=1e-12), "operations")


def test_apm_table_is_the_reads_bucket_and_weight():
    """The hit APM's bucket table of the tableless decode scan
    (csrc/ppm_r.cuh::apm_lut_fill: the binary search of the thresholds and
    the weight by an unsigned quotient, clipped) gives, for every p16 the
    reads pass (a 12-bit probability << 4), the bin and weight of
    models/ppm.py::_apm_read."""
    src = (build.CSRC / "ppm_r.cuh").read_text()
    n = int(re.search(r"#define APM_LUT_N (\d+)", src).group(1))
    thr = [int(v) for v in re.search(r"kSseThr\[33\] = \{([^}]*)\}", src).group(1).split(",")]
    assert tuple(thr) == ppm._SSE_THR

    def bucket(p16):  # apm_bucket with ThrConst
        i = 0
        for step in (16, 8, 4, 2, 1):
            if i + step <= 31 and p16 >= thr[i + step]:
                i += step
        span = max(thr[i + 1] - thr[i], 1)
        w = 0 if p16 < thr[i] else min((p16 - thr[i]) * 64 // span, 64)
        return i, w

    p16 = torch.arange(1, n, dtype=torch.int32) << 4
    _, flat, w, _, _ = ppm._apm_read(torch.zeros(33, dtype=torch.int32),
                                     torch.zeros_like(p16), p16)
    assert [bucket(int(v)) for v in p16] == list(zip(flat.tolist(), w.tolist()))
    assert n == 4096 and int(p16[-1]) >> 4 == n - 1


def _keyf_slot(key: int, salt: int, bits: int = 9) -> int:
    """csrc/ppm_r.cuh::keyf_slot in uint32 arithmetic."""
    m = 0xFFFFFFFF
    h = (key * 2654435761 + salt * 0x61C88647) & m
    h ^= h >> 15
    h = (h * 0x2C1B3C6D) & m
    return h >> (32 - bits)


def _lane_rank_model(keys, ctas: int, salt: int = 2):
    """The filter scheme of csrc/ppm_r.cuh::lane_rank over a launch of
    ``ctas`` CTAs: each CTA's filter words hold the warps that posted a
    key hashing there; a lane counts its own warp's lower lanes, then the
    keys of the lower warps whose bit its word has."""
    s = len(keys)
    per = s // ctas
    filt = [dict() for _ in range(ctas)]
    for i, k in enumerate(keys):
        if k >= 0:
            b, w = divmod(i, per)
            h = _keyf_slot(k, salt)
            filt[b][h] = filt[b].get(h, 0) | 1 << (w // 32)
    ranks = []
    for i, k in enumerate(keys):
        if k < 0:
            ranks.append(0)
            continue
        me, t = divmod(i, per)
        warp = t // 32
        r = sum(keys[me * per + warp * 32 + j] == k for j in range(t % 32))
        for b in range(me + 1):
            m = filt[b].get(_keyf_slot(k, salt), 0)
            if b == me:
                m &= (1 << warp) - 1
            for w in range(32):
                if m >> w & 1:
                    r += sum(keys[b * per + 32 * w + j] == k for j in range(32))
        ranks.append(r)
    return ranks


@pytest.mark.parametrize("ctas", [1, 2, 4])
def test_lane_rank_filter_counts_every_lower_lane(ctas):
    """The filter only skips lower warps that cannot hold the key: the
    rank equals the plain count of lower lanes with the same key (what
    block.py::_bucket_insert's ``same & lower`` sums), with many keys
    sharing filter words, a few hot keys and lanes without a key."""
    rng = np.random.default_rng(ctas)
    keys = rng.integers(0, 1 << 18, 1024)
    keys[rng.random(1024) < 0.3] = rng.integers(0, 4, 1024)[:1]
    keys[rng.random(1024) < 0.2] = -1
    keys = keys.tolist()
    want = [0 if k < 0 else keys[:i].count(k) for i, k in enumerate(keys)]
    assert _lane_rank_model(keys, ctas) == want
    words = {_keyf_slot(k, 2) for k in keys if k >= 0}
    assert len(words) < len({k for k in keys if k >= 0}), "words are shared"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ (sm_90a)")
    return torch.device("cuda")


def _rank_pair(p, inp, n, props, dev):
    rk, rp = blk._init_rolz(p, dev), blk._init_rolz(p, dev)
    blk.reset_launch_counts()
    got = blk.rank_scan(p, inp, n, props, rk)
    assert blk.LAUNCHES["K5"] == 1
    want = blk.rank_scan_plain(p, inp, n, props, rp)
    assert torch.equal(got, want)
    assert torch.equal(rk, rp)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_k5_on_adversarial_proposals(cuda_device, seed):
    """K5 against its plain version on proposals no finder writes: sources
    of -1 (they match every empty slot, so the summed ranks pass D) and
    sources repeated across proposals, at S=512 with a 3-byte context and
    every position inserting."""
    p = blk.BlockParams(**dict(FLEX, rolz_ctx_bytes=3, rolz_dec=1))
    n = p.capacity - 40
    rng = np.random.default_rng(seed)
    buf = rng.integers(97, 101, p.capacity).astype(np.uint8)
    grid = rng.integers(-1, 40, (8, p.steps, p.lanes)).astype(np.int32)
    grid[0::2] = rng.integers(0, 9, (4, p.steps, p.lanes))
    grid[1] = -1
    inp = torch.from_numpy(buf.reshape(p.lanes, p.steps)).to(cuda_device)
    want = _rank_pair(p, inp, n, torch.from_numpy(grid).to(cuda_device), cuda_device)
    assert int(want[2].max()) > p.rolz_depth


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zeros", "period2", "text"])
def test_k5_same_bucket_storm_at_full_depth(cuda_device, name):
    """Every lane inserting into one bucket (zeros; two buckets for period
    2): insert ranks reach D = 64 and beyond, so the rank-th oldest slot
    comes from every entry's age, not from rounds of a minimum; on the
    finder's own proposals."""
    p = blk.BlockParams(**dict(FLEX, rolz_depth=64, steps=64))
    n = p.capacity - 7
    buf = np.zeros(p.capacity, np.uint8)
    if name == "period2":
        buf[:] = np.tile(np.array([3, 250], np.uint8), p.capacity // 2)
    elif name == "text":
        rng = np.random.default_rng(3)
        buf[:] = rng.choice(np.frombuffer(b"the cat sat on a mat ", np.uint8), p.capacity)
    inp = torch.from_numpy(buf.reshape(p.lanes, p.steps)).to(cuda_device)
    props = blk.sort_candidates_plain(p, inp, n)
    _rank_pair(p, inp, n, props, cuda_device)


def _periodic(p, seed):
    """Each lane repeats a pattern of its own (period 5..60): matches up to
    the window, many of them at once."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(p.lanes):
        pat = rng.integers(0, 256, rng.integers(5, 61)).astype(np.uint8)
        rows.append(np.resize(pat, p.steps))
    return np.stack(rows)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [32, 250])
def test_k2_with_many_match_lanes_and_long_lengths(cuda_device, window):
    """K2 against its plain version where many lanes code a match in one
    step and len symbols reach the window (245 at 250): the warp's C event,
    the maintained len and idx row sums and their rescale, the elections.
    Its decisions come from the plain rank scan and price DP."""
    p = blk.BlockParams(**dict(FLEX, window=window, steps=256))
    n = p.capacity - 11
    inp = torch.from_numpy(_periodic(p, window)).to(cuda_device)
    props = blk.sort_candidates_plain(p, inp, n)
    cands = blk.rank_scan_plain(p, inp, n, props, blk._init_rolz(p, cuda_device))
    dec = blk.parse_scan_plain(p, n, cands)
    tk = ppm.init_tables(True, p.o3_bits, cuda_device)
    tp = ppm.init_tables(True, p.o3_bits, cuda_device)
    blk.reset_launch_counts()
    ev = blk.model_scan(p, inp, n, dec, tk)
    assert blk.LAUNCHES["K2"] == 1
    want = blk.model_scan_plain(p, inp, n, dec, tp)
    assert torch.equal(ev, want)
    assert all(torch.equal(tk[k], tp[k]) for k in tk)
    matches = want[:, 8].sum(dim=1)
    assert int(matches.max()) >= 8, "several match lanes code in one step"
    if window == 250:
        assert int(dec[0].max()) >= 200, "long len symbols"


# ---- the tableless decode scan (K12d, K13d) redesigned, and K1's searches

X_LONG = dict(lanes=512, steps=256, mode="X", min_len=6, window=250, o3_bits=14,
              rolz_ctx_bytes=4)
P_LONG = dict(lanes=512, steps=256, mode="P", min_len=4, window=250, o3_bits=14)


def _text_periods(p, seed):
    """Each lane repeats a segment (60..250 bytes) of one text of six
    words: LZP candidates that verify (mode P finds none in the random
    bytes of ``_periodic``), many at once, copies up to the window."""
    rng = np.random.default_rng(seed)
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over "]
    base = np.frombuffer(b"".join(words[k] for k in rng.integers(0, 6, 1024)), np.uint8)
    return np.stack([np.resize(base[rng.integers(0, 3000):][:rng.integers(60, 251)],
                               p.steps) for _ in range(p.lanes)])


def _longest_copy(ev) -> int:
    """The longest run of steps in which a lane coded nothing (slot A idle):
    its copy after a match, the length symbol's reach."""
    idle = (ev[:, 2] == 0).cpu().numpy()
    best = 0
    for lane in idle.T:
        run = 0
        for v in lane:
            run = run + 1 if v else 0
            best = max(best, run)
    return best


def _decode_pair(p, states, stream, n, dev, rolz=False):
    """The decode kernel and its plain version on the same payload from
    fresh tables: (states, words used, out) and every table equal (mode P:
    the LZP tables too, mode R: the bucket table).  Returns the kernel's
    (states, words used, out)."""
    def fresh():
        return (ppm.init_tables(True, p.o3_bits, dev),
                blk._init_lzp(p, dev) if p.mode == "P" else None,
                blk._init_rolz(p, dev) if rolz else None)

    (tk, zk, rk), (tp, zp, rp) = fresh(), fresh()
    kernel = {"R": "K1", "X": "K12d", "P": "K13d"}[p.mode]
    blk.reset_launch_counts()
    xk, uk, ok = blk.decode_scan(p, states, stream, n, tk, rk, zk)
    assert blk.LAUNCHES[kernel] == 1
    xp, up, op = blk.decode_scan_plain(p, states, stream, n, tp, rp, zp)
    assert uk == up
    assert torch.equal(xk, xp) and torch.equal(ok, op)
    assert all(torch.equal(tk[k], tp[k]) for k in tk)
    if zk is not None:
        assert all(torch.equal(zk[k], zp[k]) for k in zk)
    if rk is not None:
        assert torch.equal(rk, rp)
    return xk, uk, ok


def _decode_payload(p, ev, n, inp, dev, rolz=False):
    """ev through the plain rANS scan into a payload, decoded by the kernel
    and its plain version (``_decode_pair``) back to the block."""
    want = blk.rans_scan_plain(p, ev)
    payload = blk._pack_payload(want[0], blk.pack_emit(p, want[1]), want[2])
    n_words, states, stream = blk._unpack_payload(payload, p)
    st = torch.from_numpy(states.astype(np.int64)).to(dev)
    sw = torch.from_numpy(stream.astype(np.int32)).to(dev)
    _, used, out = _decode_pair(p, st, sw, n, dev, rolz)
    assert used == n_words
    assert np.array_equal(out.cpu().numpy().reshape(-1)[:n],
                          inp.cpu().numpy().reshape(-1)[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["X", "P"])
def test_tableless_decode_with_many_match_lanes_and_long_lengths(cuda_device, mode):
    """K12d and K13d against their plain versions where many lanes code a
    match in one step and copies reach the window (250): the warps'
    searches of the len row (C) and, in mode X, of the distance row (B)
    and the mantissa rows under their kept sums (D); the stream windows;
    mode P's candidate read in the step before."""
    p = blk.BlockParams(**(X_LONG if mode == "X" else P_LONG))
    n = p.capacity - 11
    buf = (_periodic if mode == "X" else _text_periods)(p, 250)
    buf.reshape(-1)[n:] = 0  # a block's bytes past n are zero, as the codec pads them
    inp = torch.from_numpy(buf).to(cuda_device)
    tables = ppm.init_tables(True, p.o3_bits, cuda_device)
    if mode == "X":
        cands = blk.sort_candidates_plain(p, inp, n, True)
        kw = dict(prices=blk.x_prices(), n_c=cands.shape[0] // 2)
        first = blk.parse_scan_plain(p, n, cands, **kw)
        rep = blk.rep_scan_plain(p, inp, n, first)
        dec = blk.parse_scan_plain(p, n, cands, rep=rep, **kw)[:2].contiguous()
        ev = blk.model_scan_plain(p, inp, n, dec, tables)
        assert int(tables["mant"].sum(dim=1).max()) > 16, "the mantissa rows adapt"
    else:
        ev = blk.model_scan_plain(p, inp, n, None, tables, blk._init_lzp(p, cuda_device))
    assert int(ev[:, 8].sum(dim=1).max()) >= 8, "several match lanes code in one step"
    assert _longest_copy(ev) >= 200, "long copies"
    _decode_payload(p, ev, n, inp, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["X", "P"])
@pytest.mark.parametrize("lanes,shift", [(512, 0), (512, 1), (1032, 0)])
def test_tableless_decode_of_a_random_stream_to_its_tail(cuda_device, mode, lanes, shift):
    """A random stream of a few steps' words (not a whole number of 16-byte
    pieces) under random states: every slot's renorm takes words, the
    windows run into the stream's tail, where StreamRead's clamp holds
    every read; at S=512 in one CTA (the shared-memory window; shifted by
    a word the stream is not 16-byte aligned and the kernel reads it
    without one) and at S=1032 as a cluster of two CTAs."""
    p = blk.BlockParams(lanes=lanes, steps=48, mode=mode, window=250, o3_bits=14,
                        min_len=6 if mode == "X" else 4,
                        **({"rolz_ctx_bytes": 4} if mode == "X" else {}))
    rng = np.random.default_rng(lanes + shift)
    st = torch.from_numpy(rng.integers(1 << 16, 1 << 32, p.lanes, dtype=np.int64)).to(cuda_device)
    words = 2 * lanes + 5
    sw = torch.from_numpy(rng.integers(0, 1 << 16, words + shift).astype(np.int32)).to(cuda_device)
    sw = sw[shift:]
    assert (sw.data_ptr() % 16 == 0) == (shift == 0)
    _, used, _ = _decode_pair(p, st, sw, p.capacity, cuda_device)
    assert used > words - lanes, "the last steps' windows start at the clamped tail"


@pytest.mark.cuda
def test_k1_with_many_match_lanes_and_long_lengths(cuda_device):
    """K1 against its plain version on the crz analogue of the tableless
    test: many match lanes a step and lengths up to the window (250), for
    the warp's searches of the index row (B) and the len row (C)."""
    p = blk.BlockParams(**dict(FLEX, window=250, steps=256))
    n = p.capacity - 11
    buf = _periodic(p, 250)
    buf.reshape(-1)[n:] = 0
    inp = torch.from_numpy(buf).to(cuda_device)
    props = blk.sort_candidates_plain(p, inp, n)
    cands = blk.rank_scan_plain(p, inp, n, props, blk._init_rolz(p, cuda_device))
    dec = blk.parse_scan_plain(p, n, cands)
    ev = blk.model_scan_plain(p, inp, n, dec, ppm.init_tables(True, p.o3_bits, cuda_device))
    assert int(ev[:, 8].sum(dim=1).max()) >= 8
    assert int(dec[0].max()) >= 200
    _decode_payload(p, ev, n, inp, cuda_device, rolz=True)


# ---- crp and crx encode's modeling scan redesigned: the candidate pass K13c,
# ---- four lanes a round in the A event (K2, K12e, K13e at 512 threads)


def _adversarial_block(name, lanes, steps, seed=5):
    """Blocks made to break the candidate pass: one slot for every lane in
    a step (zeros), two keys in lock step (period2), few byte pairs
    (colliding lzp2 slots), a word text."""
    rng = np.random.default_rng(seed)
    if name == "zeros":
        return np.zeros((lanes, steps), np.uint8)
    if name == "period2":
        return np.tile(np.array([7, 200], np.uint8), (lanes, steps // 2 + 1))[:, :steps].copy()
    if name == "pairs":
        return rng.choice(np.array([1, 2, 3], np.uint8), (lanes, steps))
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over "]
    base = np.frombuffer(b"".join(words[k] for k in rng.integers(0, 6, lanes * steps)),
                         np.uint8)
    return base[: lanes * steps].reshape(lanes, steps).copy()


@pytest.mark.cuda
@pytest.mark.parametrize("name,lanes,steps,short,filled", [
    ("zeros", 64, 16, 0, False), ("period2", 16, 24, 3, False),
    ("pairs", 32, 24, 37, False), ("text", 8, 12, 5, False),
    ("text", 16, 24, 16 * 24 - 3 * 24 - 7, True), ("text", 512, 256, 11, False),
    ("periods", 512, 256, 0, True)])
def test_k13c_matches_its_plain_version(cuda_device, name, lanes, steps, short, filled):
    """K13c's grid and final tables against the step walk of its plain
    version (tolerance 0), on blocks that break a sort of the inserts if it
    is wrong: every lane in one slot in a step, colliding slots, steps below
    8, a block ending inside its last lane; ``filled`` starts from tables
    holding random positions."""
    p = blk.BlockParams(lanes=lanes, steps=steps, mode="P", min_len=4,
                        window=250 if lanes == 512 else 32)
    n = p.capacity - short
    buf = (_text_periods(p, 7) if name == "periods"
           else _adversarial_block(name, lanes, steps))
    buf.reshape(-1)[n:] = 0
    zk, zp = blk._init_lzp(p, cuda_device), blk._init_lzp(p, cuda_device)
    if filled:
        rng = np.random.default_rng(lanes)
        for k in blk.LZP_KEYS:
            hit = torch.from_numpy(rng.integers(0, zk[k].numel(), 64))
            val = torch.from_numpy(rng.integers(1, n + 1, 64).astype(np.int32))
            zk[k][hit.to(cuda_device)] = val.to(cuda_device)
            zp[k][hit.to(cuda_device)] = val.to(cuda_device)
    inp = torch.from_numpy(buf).to(cuda_device)
    blk.reset_launch_counts()
    got = blk.lzp_candidates(p, inp, n, zk)
    assert blk.LAUNCHES["K13c"] == 1
    want = blk.lzp_candidates_plain(p, inp, n, zp)
    assert torch.equal(got, want)
    assert all(torch.equal(zk[k], zp[k]) for k in blk.LZP_KEYS)
    if name in ("text", "periods"):
        assert bool(((want & 0xFFFF) > 0).any()), "the block has matches"


def _model_pair(p, inp, n, dec, dev, kernel):
    """The modeling scan on the card and its plain version from fresh
    tables: events and every table (mode P: the LZP tables) equal."""
    tk = ppm.init_tables(True, p.o3_bits, dev)
    tp = ppm.init_tables(True, p.o3_bits, dev)
    zk = blk._init_lzp(p, dev) if p.mode == "P" else None
    zp = blk._init_lzp(p, dev) if p.mode == "P" else None
    blk.reset_launch_counts()
    ev = blk.model_scan(p, inp, n, dec, tk, zk)
    assert blk.LAUNCHES[kernel] == 1
    if p.mode == "P":
        assert blk.LAUNCHES["K13c"] == 1
    want = blk.model_scan_plain(p, inp, n, dec, tp, zp)
    assert torch.equal(ev, want)
    assert all(torch.equal(tk[k], tp[k]) for k in tk)
    if zk is not None:
        assert all(torch.equal(zk[k], zp[k]) for k in zk)
    return want, tp


def _x_decisions(p, inp, n):
    cands = blk.sort_candidates_plain(p, inp, n, True)
    kw = dict(prices=blk.x_prices(), n_c=cands.shape[0] // 2)
    first = blk.parse_scan_plain(p, n, cands, **kw)
    rep = blk.rep_scan_plain(p, inp, n, first)
    return blk.parse_scan_plain(p, n, cands, rep=rep, **kw)[:2].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["P", "X"])
@pytest.mark.parametrize("window", [32, 250])
def test_k13e_k12e_with_many_match_lanes_and_long_lengths(cuda_device, mode, window):
    """K13c + K13e and K12e against the plain modeling scan where many lanes
    code a match in one step and lengths reach the window: the grid's
    candidates read in place of the tables, the four-lane A event's symbols
    and exclusion masks, the C event."""
    p = blk.BlockParams(**dict(X_LONG if mode == "X" else P_LONG, window=window))
    n = p.capacity - 11
    buf = (_periodic if mode == "X" else _text_periods)(p, window)
    buf.reshape(-1)[n:] = 0
    inp = torch.from_numpy(buf).to(cuda_device)
    dec = _x_decisions(p, inp, n) if mode == "X" else None
    ev, _ = _model_pair(p, inp, n, dec, cuda_device, "K12e" if mode == "X" else "K13e")
    assert int(ev[:, 8].sum(dim=1).max()) >= 8, "several match lanes code in one step"
    if window == 250:
        assert _longest_copy(ev) >= 200, "long copies"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["R", "X", "P"])
@pytest.mark.parametrize("lanes", [512, 1024, 72])
def test_modeling_scans_with_rows_over_their_cap(cuda_device, mode, lanes):
    """Few contexts coded by every lane: o2 rows pass cap2 and halve, so the
    halving pass of the A event runs, four lanes a round at S=512 and S=72
    (a last warp short of lanes), two at S=1024 (the 1024-thread arm)."""
    kw = dict(R=dict(FLEX, window=32), X=dict(X_LONG, window=32),
              P=dict(P_LONG, window=32))[mode]
    p = blk.BlockParams(**dict(kw, lanes=lanes, steps=128))
    n = p.capacity - 5
    rng = np.random.default_rng(lanes)
    buf = rng.choice(np.arange(4, dtype=np.uint8), (p.lanes, p.steps), p=[0.85, 0.1, 0.04, 0.01])
    buf.reshape(-1)[n:] = 0
    inp = torch.from_numpy(buf).to(cuda_device)
    if mode == "R":
        props = blk.sort_candidates_plain(p, inp, n)
        cands = blk.rank_scan_plain(p, inp, n, props, blk._init_rolz(p, cuda_device))
        dec = blk.parse_scan_plain(p, n, cands)
    else:
        dec = _x_decisions(p, inp, n) if mode == "X" else None
    _, tables = _model_pair(p, inp, n, dec, cuda_device,
                            {"R": "K2", "X": "K12e", "P": "K13e"}[mode])
    # a row that halved keeps at most cap2 after its write; the hottest rows
    # sit near the cap
    assert int(tables["o2"].sum(dim=1).max()) > ppm.CAP2 // 2, "rows reached the cap"
