"""The step scans redesigned for the H100 — the rank scan K5 and the
modeling scan K2 with the lane-order ranks, row sums and C event they
share with K1, KS, KSx, K12e, K13e, K12d, K13d — against their plain
PyTorch versions at tolerance 0, and their phase instrument.

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
    entry that reads them."""
    src, names, observers = phases.PHASES[kernel]
    text = (build.CSRC / src).read_text()
    n = int(re.search(rf"#define {kernel}_PHASES (\d+)", text).group(1))
    stamps = sorted({int(k) for k in re.findall(rf"{kernel}_STAMP\((\d+)\)", text)})
    assert len(names) == n and stamps == list(range(n))
    assert f"cpx_{kernel.lower()}_prof_read" in build._INSTRUMENTED
    assert f"-DCPX_{kernel}_PROF" in text
    assert observers in (1, 2, 3)


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
    assert specs[2] == (("-DCPX_K5_PROF", "-DCPX_K2_PROF"), ("rank.cu", "model.cu"))
    assert phases.variant_specs((), encode=False) == []
    keys = {build.library_path(*s) for s in specs}
    assert len(keys) == 3 and build.library_path() not in keys


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
