"""The CUDA kernels against their plain PyTorch versions, and the build.

This file imports no JAX, so that the ``cuda``-marked tests also run on a
card's machine without it (``tests/conftest.py`` imports JAX, hence
``--noconftest`` there):

    python -m pytest tests/test_torch_kernels.py -m cuda -q --noconftest

The ``cuda`` tests skip where there is no card.  The others check, on any
machine, what the kernels' callers rely on: the C configuration layout,
the build cache key, and that a missing ``nvcc`` is an error.
"""

import hashlib
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from comprox_tpu_torch.benchmarks import sort_keys
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec import container as con
from comprox_tpu_torch.codec import fast as tfast
from comprox_tpu_torch.models import ppm
from comprox_tpu_torch.utils import build

# the plain versions run many tiny ops: more intra-op threads would only
# contend with the other test workers
torch.set_num_threads(1)

# the main path's ROLZ knobs at S=512, with small tables
WIDE = dict(lanes=512, steps=32, mode="R", min_len=5, window=32, o3_bits=14,
            rolz_bits=10, rolz_depth=16, flexible=False, rolz_ctx_bytes=4,
            rolz_dec=2)


GOLDEN = Path(__file__).resolve().parent / "data"
GOLDEN_META = json.loads((GOLDEN / "torch_golden.json").read_text())
CRZ_GOLDENS = sorted(n for n in GOLDEN_META if n.startswith("crz_"))

def text(n, seed):
    rng = np.random.default_rng(seed)
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over "]
    buf = b"".join(words[rng.integers(0, len(words))] for _ in range(n))
    return np.frombuffer(buf[:n], np.uint8)


def test_cfg_layout_matches_the_c_struct():
    """_cfg_array fills csrc/ppm_r.cuh::Cfg field by field, in order."""
    src = (build.CSRC / "ppm_r.cuh").read_text()
    body = re.search(r"struct Cfg \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"\b(\w+)\s*[,;]", body.replace("int ", ""))
    assert len(fields) == blk._CFG_FIELDS
    p = blk.BlockParams(**WIDE)
    cfg = blk._cfg_array(p, 1234, 99)
    by_name = dict(zip(fields, cfg.tolist()))
    assert by_name["S"] == p.lanes and by_name["T"] == p.steps
    assert by_name["n"] == 1234 and by_name["stream_len"] == 99
    assert by_name["rolz_dec"] == 2 and by_name["probe"] == p.probe
    assert by_name["use_sse"] == 1 and by_name["cap1"] == ppm.CAP1
    assert by_name["n_cands"] == blk._R_CANDS and by_name["r_probe"] == blk._R_PROBE
    assert by_name["sort_ext"] == min(blk._SORT_EXT, p.window)
    assert (by_name["p_lit"], by_name["p_rm"], by_name["p_ri"]) == (
        blk._P_LIT_R, blk._P_RM, blk._P_RI)


def test_x_cfg_carries_the_mode_x_knobs(monkeypatch):
    """The mode-X entries read their finder configuration (no forward chain,
    no decimation), the repeat price and the distance and mantissa model
    knobs from the same struct; the slot count follows the mode."""
    p = blk.BlockParams(lanes=512, steps=32, mode="X", min_len=6, window=250,
                        rolz_ctx_bytes=4, rolz_dec=2)
    by_name = dict(zip(blk._CFG_NAMES, blk.finder_cfg(p, 777, True).tolist()))
    assert (by_name["n_cands"], by_name["r_probe"], by_name["fwd_chain"],
            by_name["rolz_dec"]) == (3, 16, 0, 1)
    assert by_name["use_sse"] == ppm.SSE_X == 1
    assert (by_name["dst_inc"], by_name["dst_cap"], by_name["mant_inc"],
            by_name["mant_cap"]) == (ppm.DST_INC, ppm.DST_CAP, ppm.MANT_INC, ppm.MANT_CAP)
    monkeypatch.setenv("CPX_X_CANDS", "5")
    monkeypatch.setenv("CPX_X_PROBE", "2")
    by_name = dict(zip(blk._CFG_NAMES, blk.finder_cfg(p, 777, True).tolist()))
    assert (by_name["n_cands"], by_name["r_probe"]) == (5, 5)
    r = dict(zip(blk._CFG_NAMES, blk.finder_cfg(p, 777).tolist()))
    assert (r["fwd_chain"], r["rolz_dec"], r["p_rep"]) == (blk._R_PROBE, 2, 0)
    assert p.n_slots == 5 and blk.BlockParams(**WIDE).n_slots == 3
    src = (build.CSRC / "ppm_r.cuh").read_text()
    for name, value in (("DST_W", ppm.DST_W), ("SSE_XCTX", ppm.SSE_XCTX),
                        ("SYM_DST_REPEAT", blk.SYM_DST_REPEAT), ("MANT_N", 16)):
        assert int(re.search(rf"#define {name} (\d+)", src).group(1)) == value


def test_fast_cfg_carries_the_mode_f_knobs():
    """fast._cfg overrides the encoder fields of Cfg with mode F's knobs and
    leaves the geometry alone."""
    p = blk.BlockParams(lanes=512, steps=32, mode="F", min_len=6, window=250)
    by_name = dict(zip(blk._CFG_NAMES, tfast._cfg(p, 777, 5).tolist()))
    assert (by_name["S"], by_name["T"], by_name["n"]) == (512, 32, 777)
    assert by_name["min_len"] == 6 and by_name["stream_len"] == 5
    assert by_name["n_cands"] == tfast._F_CANDS == 2
    assert by_name["sort_ext"] == 4 * (tfast._EXTW - 1) == 60
    assert (by_name["p_lit"], by_name["p_rm"], by_name["p_ri"]) == tfast._F_PRICES[:3]
    assert by_name["diag_tail"] == 0
    assert dict(zip(blk._CFG_NAMES, blk._cfg_array(p, 1).tolist()))["diag_tail"] == 1


def test_kernel_sources_and_launch_table():
    """Every kernel of the launch table has its source, the shared headers
    are part of the build's key, and the scan and sort tiles are one
    number on both sides."""
    assert set(blk.LAUNCHES) == {"KS", "K1", "K2", "K3", "K4", "K5", "K6", "K7",
                                 "K8", "K9", "K10", "K4x", "K11", "K12e", "K12d",
                                 "KSx", "K13c", "K13e", "K13d", "SORT", "K3p",
                                 "KCR", "K5ch", "K1ch", "K3b"}
    assert set(blk._EVENTS) == set(blk.LAUNCHES)
    names = {p.name for p in build._sources()}
    assert {"search.cu", "decode.cu", "model.cu", "rans.cu", "sortfind.cu",
            "rank.cu", "parse.cu", "f2tok.cu", "f2enc.cu",
            "f2dec.cu", "xrep.cu", "lzpcand.cu", "chain.cu", "sortlib.cuh",
            "f2scan.cuh", "ppm_r.cuh"} <= names
    scan = (build.CSRC / "f2scan.cuh").read_text()
    threads = int(re.search(r"#define SCAN_THREADS (\d+)", scan).group(1))
    per = int(re.search(r"#define SCAN_PER (\d+)", scan).group(1))
    assert threads * per == tfast.SCAN_TILE
    sort = (build.CSRC / "sortlib.cuh").read_text()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", sort).group(1))

    assert define("RS_THREADS") * define("RS_ITEMS") == blk.K4_TILE
    assert "#define RS_TILE (RS_THREADS * RS_ITEMS)" in sort
    assert (define("RS_HDR"), define("RS_PASSES")) == (blk.RS_HDR, blk.RS_PASSES)
    assert define("RS_CTR") + 2 * define("RS_PASSES") == blk.RS_RUNS < blk.RS_HDR
    # one radix sort for the finders and K13c: its kernels live in
    # sortlib.cuh alone, no user has a copy, and the finders' entry point
    # and K13c's launch it
    srcs = {p.name: p.read_text() for p in build._sources()}
    for name, src in srcs.items():
        if name != "sortlib.cuh":
            assert not re.search(r"void[^(]*\brs_(hist|plan|pass|finish)\(", src), name
    for name in ("sortfind.cu", "lzpcand.cu"):
        assert "__match_any_sync" not in srcs[name]
    assert [n for n, src in srcs.items() if "radix_sort_pairs(" in src] == [
        "lzpcand.cu", "sortfind.cu", "sortlib.cuh"]
    assert "radix_sort_pairs(" in srcs["sortfind.cu"].split(
        'extern "C" int cpx_radix_sort_launch')[1]
    assert "radix_sort_pairs(" in srcs["lzpcand.cu"].split(
        'extern "C" int cpx_k13c_launch')[1]
    # K13c's tiles of sorted keys are the sort's (block.lzp_candidates sizes both)
    assert int(re.search(r"#define LZC_TILE (\d+)", srcs["lzpcand.cu"]).group(1)) == blk.K4_TILE
    blk.reset_launch_counts()
    assert not any(blk.LAUNCHES.values())


def _smem_model_bytes(src):
    """sizeof(SmemModel) from csrc/ppm_r.cuh: its int arrays and scalars."""
    consts = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)\b", src)}
    consts.update(SSE_K=consts["SSE_NCTX"] * 33, SSE_HK=consts["SSE_HCTX"] * 33,
                  SSE_XK=consts["SSE_XCTX"] * 33)
    body = re.search(r"struct SmemModel \{(.*?)\n\};", src, re.S).group(1)
    n = 0
    for decl in re.findall(r"^\s*(?:__align__\(16\) )?int ([^;]+);", body, re.M):
        for item in decl.split(","):
            dims = re.findall(r"\[([^\]]+)\]", item)
            size = 1
            for dim in dims:
                size *= eval(dim, {}, consts)  # products of the header's constants
            n += size
    return 4 * n


def test_row_ring_fits_beside_the_bucket_rows():
    """At the main path's geometry (S=512, rolz_depth 64) K1 keeps its
    lanes' bucket-row copies in shared memory beside the warps' row rings
    and the static SmemModel, within the H100's 227 KB a CTA; the rings
    alone fit at 1024 threads (csrc/decode.cu::cpx_k1_launch)."""
    src = (build.CSRC / "ppm_r.cuh").read_text()
    depth = int(re.search(r"#define CPX_RING_D (\d+)", src).group(1))
    smem_max = int(re.search(r"#define CPX_SMEM_MAX (\d+)", src).group(1))
    assert smem_max == 227 * 1024 and depth >= 2
    model = _smem_model_bytes(src)
    assert 25_000 < model < 40_000

    def ring(threads):
        return threads // 32 * depth * ppm.O2_W * 4

    p = blk.BlockParams(lanes=512, steps=16384, mode="R", min_len=5, window=250,
                        rolz_ctx_bytes=4, rolz_dec=2)
    assert p.rolz_depth == 64
    pos = (p.rolz_depth + 1) * p.lanes * 4
    assert ring(512) + pos + model + 256 <= smem_max
    assert ring(1024) + model + 256 <= smem_max


def test_four_lane_rings_fit_beside_the_model():
    """The modeling scan's 512-thread arm (K2, K12e, K13e) codes four lanes
    a round of its A event (csrc/ppm_r.cuh::warp_a_event4): a ring of
    RING4_D rows a warp, in a region the B event's ring shares (RING4_W
    rows: RING4_D, or CPX_RING_D's slots where deeper), and a result row a
    lane (its results and mask words, an odd stride) in dynamic shared
    memory, beside the static SmemModel and the APM thresholds, in the
    instrumented build too.  At the default depth the CTA fits a 132 KB
    carve-out of the SM's 256 KB (the L1 cache keeps 124 KB; 1 KB a CTA is
    the system's); at every even depth up to 8 (benchmarks/ring_depth.py)
    it fits the H100's 227 KB a CTA."""
    src = (build.CSRC / "ppm_r.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)\b", src)}
    d4, stride, depth = consts["RING4_D"], consts["ARES_S"], consts["CPX_RING_D"]
    assert d4 == 4 and stride % 2 == 1 and stride >= consts["ARES_N"] + 256 // 32
    model = _smem_model_bytes(src)

    def four(threads, ring_d):
        rows = max(d4, ring_d if ring_d > 0 else 2)
        return threads // 32 * (rows * ppm.O2_W + 32 * stride) * 4

    thr, prof, reserved = 33 * 4, 2 * 10 * 8, 1024
    assert four(512, depth) + model + thr + prof + reserved <= 132 * 1024
    for ring_d in range(0, 9, 2):
        assert four(512, ring_d) + model + thr + prof <= consts["CPX_SMEM_MAX"]


def test_stream_windows_fit_beside_the_row_rings():
    """The tableless decode scan (K12d, K13d) in one CTA keeps two windows
    of a step's stream words (n_slots * S from a 16-byte aligned start)
    beside the warps' row rings, its hit APM's bucket table and the static
    SmemModel, within the H100's 227 KB a CTA, at 512 and at 1024 threads
    in both modes (csrc/decode.cu::tableless_launch; a cluster reads the
    stream)."""
    src = (build.CSRC / "ppm_r.cuh").read_text()
    dec = (build.CSRC / "decode.cu").read_text()
    depth = int(re.search(r"#define CPX_RING_D (\d+)", src).group(1))
    smem_max = int(re.search(r"#define CPX_SMEM_MAX (\d+)", src).group(1))
    model = _smem_model_bytes(src)
    assert "return (n_slots * c.S + 4 + 3) & ~3;" in dec
    assert ("ring + 2 * sizeof(int) * win_n + lut + sizeof(SmemModel) + 256 > CPX_SMEM_MAX"
            in dec)
    lut = 4 * int(re.search(r"#define APM_LUT_N (\d+)", src).group(1))
    assert lut == 4 * 4096

    def window_ints(lanes, mode):
        n_slots = blk.BlockParams(lanes=lanes, steps=16, mode=mode).n_slots
        return (n_slots * lanes + 4 + 3) & ~3

    for mode, slots in (("X", 5), ("P", 3)):
        assert window_ints(512, mode) == slots * 512 + 4
        assert window_ints(72, mode) % 4 == 0 and window_ints(72, mode) >= slots * 72 + 3
        for lanes in (512, 1024):
            ring = lanes // 32 * depth * ppm.O2_W * 4
            assert ring + 2 * 4 * window_ints(lanes, mode) + lut + model + 256 <= smem_max


def test_row_events_have_one_read_path():
    """The A and B events are defined once (csrc/ppm_r.cuh) and every step
    scan that codes events (K1, K12d/K13d, K2/K12e/K13e) reads their rows
    through the same ring; no caller reads an o1 or o2 row on its own."""
    srcs = {p.name: p.read_text() for p in build._sources()}
    for fn in ("warp_a_event", "warp_o1_event"):
        defs = [n for n, src in srcs.items()
                if re.search(rf"static __device__ \w+ {fn}\(", src)]
        assert defs == ["ppm_r.cuh"], fn
    calls = {n: len(re.findall(r"warp_a_event<[^>]*>\(\s*c, ring,", src))
             for n, src in srcs.items()}
    assert {n: k for n, k in calls.items() if k} == {"decode.cu": 2, "model.cu": 1}
    for name in ("decode.cu", "model.cu"):
        assert len(re.findall(r"warp_o1_event<\w+>\(ring,", srcs[name])) == calls[name]
        assert srcs[name].count("ring_start(dyn, tb.o2, O2_W,") == calls[name]
        assert srcs[name].count("ring_start(dyn, tb.o1, O1_N,") == calls[name]
    assert "* O2_W;" not in srcs["ppm_r.cuh"].split("struct RowRing")[1].split(
        "struct PlainRow")[0]
    # encode's four-lane arm: its own A event over its own ring, the same B
    defs = [n for n, src in srcs.items()
            if re.search(r"static __device__ \w+ warp_a_event4\(", src)]
    assert defs == ["ppm_r.cuh"]
    assert len(re.findall(r"warp_a_event4<\w+>\(c, ring,", srcs["model.cu"])) == 1
    assert srcs["model.cu"].count("ring4_start(dyn, tb.o2, O2_W,") == 1


@pytest.mark.parametrize("name", [n for n in sort_keys.SETS if n != "random_8Mi"])
def test_radix_sort_plain_route_and_passes(name):
    """On a CPU tensor the shared sort is torch.sort(stable=True); the
    passes it reports are the digits that are not the same for every key
    (those the kernel runs)."""
    keys = sort_keys.keys(name)
    blk.reset_launch_counts()
    hs, ps, passes = blk.radix_sort(keys)
    hp, pp = torch.sort(keys, stable=True)
    assert torch.equal(hs, hp) and torch.equal(ps, pp)
    want = {"all_equal": 0, "one_key": 0, "two_values": 4, "low_8_bits": 1,
            "low_16_bits": 2, "high_byte_only": 1}.get(name, 4)
    assert passes == want == blk.radix_passes_plain(keys)
    assert not any(blk.LAUNCHES.values())
    with pytest.raises(ValueError, match="int64"):
        blk.radix_sort(keys.to(torch.int32))


def test_build_variant_has_its_own_library():
    """An instrumented variant (extra defines, a subset of the sources) is
    keyed apart from the main library, and lib() returns it only inside
    build.variant."""
    main = build.library_path()
    var = build.library_path(("-DCPX_K1_PROF",), ("decode.cu",))
    assert var != main and var.parent == main.parent
    assert build._VARIANT == ((), None)
    with build.variant("-DCPX_K1_PROF", only=("decode.cu",)):
        assert build._VARIANT == (("-DCPX_K1_PROF",), ("decode.cu",))
    assert build._VARIANT == ((), None)
    assert "cpx_k1_prof_read" in build._INSTRUMENTED


def test_build_cache_key_and_entry_points():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path == build.library_path()
    assert path.name.startswith("libcpx_kernels_")
    names = set(re.findall(r'extern "C" int (\w+)\(', "".join(
        p.read_text() for p in build.CSRC.glob("*.cu"))))
    assert names == set(build._SIGNATURES)


def test_entry_point_arity_matches_signatures():
    """The ctypes argument lists have one entry per C parameter."""
    src = "".join(p.read_text() for p in build.CSRC.glob("*.cu"))
    for name, argtypes in build._SIGNATURES.items():
        params = re.search(rf'extern "C" int {name}\((.*?)\)', src, re.S)
        assert params.group(1).count(",") + 1 == len(argtypes), name


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sort_keys.SETS)
def test_radix_sort_matches_torch_sort(cuda_device, name):
    """The shared radix sort (csrc/sortlib.cuh) against torch.sort(stable=
    True) at tolerance 0, keys and positions, on adversarial key sets:
    constant digits are skipped (passes), ties keep their order across
    tiles, and a ragged last tile is handled."""
    keys = sort_keys.keys(name)
    blk.reset_launch_counts()
    hs, ps, passes = blk.radix_sort(keys.to(cuda_device))
    assert blk.LAUNCHES["SORT"] == 1
    hp, pp = torch.sort(keys, stable=True)
    assert torch.equal(hs.cpu(), hp) and torch.equal(ps.cpu(), pp)
    assert passes == blk.radix_passes_plain(keys)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CRZ_GOLDENS)
def test_k1_decodes_the_crz_goldens(cuda_device, name):
    """K1 decodes every committed crz archive of the JAX package on the
    card (1 MiB and 8 MiB, flexible and -f0, the -F ELF corpus, S=2048 as
    a cluster of two CTAs, chained; its chain arm K1ch under -C) to its
    corpus' SHA-256."""
    m = GOLDEN_META[name]
    blk.reset_launch_counts()
    out = io.BytesIO()
    con.decode_stream(io.BytesIO((GOLDEN / name).read_bytes()), out, "cuda")
    assert blk.LAUNCHES["K1ch" if "_chainm_" in name else "K1"] >= 1
    assert hashlib.sha256(out.getvalue()).hexdigest() == m["input_sha256"]


@pytest.mark.cuda
def test_k1_phase_build_decodes_like_the_main_build(cuda_device):
    """The instrumented K1 (benchmarks/phases.py) at ring depth 0 and at
    the build's depth decodes the 1 MiB crz golden to its corpus, and its
    phases account for the launch's cycles."""
    from comprox_tpu_torch.benchmarks import phases

    name = "crz_flex_1MiB_S512.cpx"
    res = phases.run(GOLDEN / name, ("K1",), (0, phases.default_depth()))["K1"]
    for r in res:
        assert r["sha256"] == GOLDEN_META[name]["input_sha256"]
        assert all(c > 0 for c in r["cycles"][0]) and abs(sum(r["share"][0]) - 1) < 1e-9
    assert build._VARIANT == ((), None)


@pytest.mark.cuda
def test_k12d_k13d_phase_build_decodes_like_the_main_build(cuda_device):
    """The instrumented tableless decode scan (benchmarks/phases.py, its
    stamps in the decode variant) at ring depth 0 and at the build's depth
    decodes the 1 MiB crx and crp goldens to their corpora, each mode's
    counters filled by its own launches, and each observer's phases
    account for its cycles."""
    from comprox_tpu_torch.benchmarks import phases

    names = {"K12d": "crx_flex_1MiB_S512.cpx", "K13d": "crp_1MiB_S512.cpx"}
    res = phases.run(GOLDEN / "crz_flex_1MiB_S512.cpx", ("K12d", "K13d"),
                     (0, phases.default_depth()),
                     archives={k: GOLDEN / v for k, v in names.items()})
    for k, name in names.items():
        assert len(res[k]) == 2
        for r in res[k]:
            assert r["sha256"] == GOLDEN_META[name]["input_sha256"]
            assert len(r["cycles"]) == 2 and len(r["cycles"][0]) == len(phases.TABLELESS)
            assert abs(sum(r["share"][0]) - 1) < 1e-9
            assert all(sum(r["cycles"][o]) > 0 for o in range(2))
            assert r["cycles"][0][2] > 0, "the A event"
    assert build._VARIANT == ((), None)


@pytest.mark.cuda
def test_k5_k2_phase_build_encodes_like_the_main_build(cuda_device):
    """The instrumented K5 and K2 (benchmarks/phases.py, one variant build
    of rank.cu and model.cu beside the main library) re-encode the 1 MiB
    crz golden's corpus to the golden archive's bytes, and each observer's
    phases account for its cycles."""
    from comprox_tpu_torch.benchmarks import phases

    name = "crz_flex_1MiB_S512.cpx"
    res = phases.run(GOLDEN / name, ("K5", "K2"))
    for k in ("K5", "K2"):
        (r,) = res[k]
        assert r["sha256"] == GOLDEN_META[name]["archive_sha256"]
        obs = phases.PHASES[k][2]
        assert len(r["cycles"]) == obs and len(r["cycles"][0]) == len(phases.PHASES[k][1])
        assert abs(sum(r["share"][0]) - 1) < 1e-9
        assert all(sum(r["cycles"][o]) > 0 for o in range(obs))
    assert build._VARIANT == ((), None)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["KS", "K2", "K3", "K1"])
def test_kernel_matches_plain(cuda_device, kernel):
    p = blk.BlockParams(**WIDE)
    n = p.capacity - 100
    buf = np.zeros(p.capacity, np.uint8)
    buf[:n] = text(n, seed=7)
    inp = torch.from_numpy(buf.reshape(p.lanes, p.steps)).to(cuda_device)

    def fresh():
        return (ppm.init_tables(True, p.o3_bits, cuda_device),
                blk._init_rolz(p, cuda_device))

    rk = fresh()[1]
    grids = blk.search_scan(p, inp, n, rk)
    if kernel == "KS":
        rp = fresh()[1]
        assert torch.equal(grids, blk.search_scan_plain(p, inp, n, rp))
        assert torch.equal(rk, rp)
        return
    take, src = blk._greedy_decisions(p, grids[0], grids[1])
    dec = torch.stack([take, src, grids[2], grids[3]]).contiguous()
    tk, tp = fresh()[0], fresh()[0]
    ev = blk.model_scan(p, inp, n, dec, tk)
    if kernel == "K2":
        assert torch.equal(ev, blk.model_scan_plain(p, inp, n, dec, tp))
        assert all(torch.equal(tk[k], tp[k]) for k in tk)
        return
    got = blk.rans_scan(p, ev)
    if kernel == "K3":
        want = blk.rans_scan_plain(p, ev)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
    payload = blk._pack_payload(got[0], blk.pack_emit(p, got[1]), got[2])
    n_words, states, stream = blk._unpack_payload(payload, p)
    st = torch.from_numpy(states.astype(np.int64)).to(cuda_device)
    sw = torch.from_numpy(stream.astype(np.int32)).to(cuda_device)
    (tk, rk), (tp, rp) = fresh(), fresh()
    xk, uk, ok = blk.decode_scan(p, st, sw, n, tk, rk)
    xp, up, op = blk.decode_scan_plain(p, st, sw, n, tp, rp)
    assert uk == up == n_words
    assert torch.equal(xk, xp) and torch.equal(ok, op)
    assert torch.equal(rk, rp) and all(torch.equal(tk[k], tp[k]) for k in tk)
    assert np.array_equal(ok.cpu().numpy().reshape(-1)[:n], buf[:n])


def _flex_inputs(name, p, n):
    buf = np.zeros(p.capacity, np.uint8)
    if name == "text":
        buf[:n] = text(n, seed=11)
    elif name == "period3":
        buf[:n] = np.tile(np.array([7, 200, 31], np.uint8), n // 3 + 1)[:n]
    elif name == "random":
        buf[:n] = np.random.default_rng(5).integers(0, 256, n, dtype=np.uint8)
    return buf  # "zeros": all zero


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["text", "zeros", "period3", "random"])
@pytest.mark.parametrize("kernel", ["K4", "K5", "K6"])
def test_flexible_kernel_matches_plain(cuda_device, kernel, name):
    """K4, K5, K6 against their plain versions, each fed the plain
    version's output of the pass before it."""
    p = blk.BlockParams(**dict(WIDE, flexible=True))
    n = p.capacity - 100
    inp = torch.from_numpy(
        _flex_inputs(name, p, n).reshape(p.lanes, p.steps)).to(cuda_device)
    props = blk.sort_candidates_plain(p, inp, n)
    if kernel == "K4":
        bytes_pad = blk.pad_block(p, inp)
        hs, ps = blk.sort_positions(p, bytes_pad, n)
        hp, pp = torch.sort(blk.sort_keys_plain(p, bytes_pad, n), stable=True)
        assert torch.equal(hs, hp) and torch.equal(ps, pp)
        assert torch.equal(blk.sort_candidates(p, inp, n), props)
        return
    rk, rp = blk._init_rolz(p, cuda_device), blk._init_rolz(p, cuda_device)
    cands = blk.rank_scan_plain(p, inp, n, props, rp)
    if kernel == "K5":
        assert torch.equal(blk.rank_scan(p, inp, n, props, rk), cands)
        assert torch.equal(rk, rp)
        return
    assert torch.equal(blk.parse_scan(p, n, cands), blk.parse_scan_plain(p, n, cands))


@pytest.mark.cuda
def test_flexible_block_roundtrip_on_card(cuda_device):
    p = blk.BlockParams(**dict(WIDE, lanes=64, steps=64, flexible=True))
    data = text(p.capacity - 7, seed=8)
    before = dict(blk.LAUNCHES)
    payload = blk.encode_block(data, p, cuda_device)
    assert all(blk.LAUNCHES[k] == before[k] + 1 for k in ("K4", "K5", "K6"))
    assert blk.LAUNCHES["KS"] == before["KS"]
    assert payload == blk.encode_block(data, p, "cpu")
    np.testing.assert_array_equal(
        blk.decode_block(payload, data.size, p, cuda_device), data)


@pytest.mark.cuda
@pytest.mark.parametrize("flexible", [False, True])
def test_wide_block_keeps_positions_in_global_scratch(cuda_device, flexible):
    """S=1024, D=64: the [S, D+1] position array (260 KB) is over the shared
    memory budget, so K1 uses the global scratch array (KS and K5 copy their
    rows into shared tiles, a batch of a warp's lanes at a time)."""
    p = blk.BlockParams(**dict(WIDE, lanes=1024, steps=16, rolz_depth=64,
                               flexible=flexible))
    data = text(p.capacity - 5, seed=9)
    payload = blk.encode_block(data, p, cuda_device)
    assert payload == blk.encode_block(data, p, "cpu")
    np.testing.assert_array_equal(
        blk.decode_block(payload, data.size, p, cuda_device), data)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1032, 2048, 8192])
@pytest.mark.parametrize("codec,flexible,finder", [
    ("crz", True, "sort"), ("crz", False, "sort"), ("crx", True, "sort"),
    ("crx", False, "scan"), ("crp", True, "sort")])
def test_step_scans_take_a_cluster(cuda_device, monkeypatch, codec, flexible,
                                   finder, lanes):
    """Above 1024 lanes the step scans (KS, K5, K2, K1; KSx, K12e, K12d;
    K13e, K13d) run as one cluster of CTAs: the block's payload equals the
    plain versions' and decodes on the card."""
    from comprox_tpu_torch.cli.main import make_params

    monkeypatch.setitem(blk._ENV, "CPX_X_FINDER", finder)
    p = make_params(codec, {"lanes": lanes, "block_mb": lanes * 32 / 2 ** 20,
                            "flexible": flexible}).block
    data = text(p.capacity - 13, seed=lanes)
    payload = blk.encode_block(data, p, cuda_device)
    assert payload == blk.encode_block(data, p, "cpu")
    np.testing.assert_array_equal(
        blk.decode_block(payload, data.size, p, cuda_device), data)


@pytest.mark.cuda
@pytest.mark.parametrize("flexible", [False, True])
def test_cluster_keeps_positions_in_global_scratch(cuda_device, flexible):
    """S=2048, D=64: each CTA's [1024, D+1] position rows (266 KB) are over
    the shared memory budget, so the cluster's K1 uses the global scratch
    array, each CTA its own lanes' rows (KS and K5: smaller batches of
    their row tiles)."""
    p = blk.BlockParams(**dict(WIDE, lanes=2048, steps=16, rolz_depth=64,
                               flexible=flexible))
    data = text(p.capacity - 5, seed=10)
    payload = blk.encode_block(data, p, cuda_device)
    assert payload == blk.encode_block(data, p, "cpu")
    np.testing.assert_array_equal(
        blk.decode_block(payload, data.size, p, cuda_device), data)


@pytest.mark.cuda
def test_block_roundtrip_on_card(cuda_device):
    p = blk.BlockParams(**dict(WIDE, lanes=64, steps=64))
    data = text(p.capacity - 7, seed=8)
    payload = blk.encode_block(data, p, cuda_device)
    assert payload == blk.encode_block(data, p, "cpu")
    np.testing.assert_array_equal(
        blk.decode_block(payload, data.size, p, cuda_device), data)


# ---- mode F: K7, K6's F entry, K8, K9, K10

FAST_WIDE = dict(lanes=512, steps=64, mode="F", min_len=6, window=250)


def _fast_inputs(name, p, n):
    buf = np.zeros(p.capacity, np.uint8)
    if name == "text":
        buf[:n] = text(n, seed=13)
    elif name == "period7":
        buf[:n] = np.tile(np.array([7, 200, 31, 4, 4, 90, 1], np.uint8), n // 7 + 1)[:n]
    elif name == "random":
        buf[:n] = np.random.default_rng(6).integers(0, 256, n, dtype=np.uint8)
    return buf  # "zeros": all zero


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["text", "zeros", "period7", "random"])
@pytest.mark.parametrize("kernel", ["K7", "K6F", "K8", "K9", "K10"])
def test_fast_kernel_matches_plain(cuda_device, kernel, name):
    """K7, K6's F entry, K8, K9, K10 against their plain versions, each fed
    the plain version's output of the pass before it."""
    p = blk.BlockParams(**FAST_WIDE)
    n = p.capacity - 100
    inp = torch.from_numpy(
        _fast_inputs(name, p, n).reshape(p.lanes, p.steps)).to(cuda_device)
    cands = tfast.f2_find_plain(p, inp, n)
    if kernel == "K7":
        bytes_pad = tfast.pad_block(p, inp)
        hs, ps = tfast.sort_positions(p, bytes_pad, n)
        hp, pp = torch.sort(tfast.sort_keys_plain(p, bytes_pad, n), stable=True)
        assert torch.equal(hs, hp) and torch.equal(ps, pp)
        assert torch.equal(tfast.f2_find(p, inp, n), cands)
        return
    kw = dict(prices=tfast._F_PRICES, n_c=tfast._F_CANDS)
    dec = blk.parse_scan_plain(p, n, cands, **kw)
    if kernel == "K6F":
        assert torch.equal(blk.parse_scan(p, n, cands, **kw), dec)
        return
    toks, n_tok, sym, xtr, tbits = tfast.tokenize_plain(p, inp, n, dec)
    if kernel == "K8":
        got = tfast.tokenize(p, inp, n, dec)
        assert got[0] == n_tok
        assert all(torch.equal(a, b[:n_tok]) for a, b in
                   zip(got[1:], (sym, xtr, tbits)))
        return
    freq, states, words = tfast.encode_scan_plain(p, sym, xtr, tbits, n_tok)
    if kernel == "K9":
        got = tfast.encode_scan(p, sym, xtr, tbits, n_tok)
        assert all(torch.equal(a, b) for a, b in zip(got, (freq, states, words)))
        return
    stream = torch.zeros(tfast._max_words(p), dtype=torch.int32, device=cuda_device)
    stream[: words.numel()] = words
    xk, uk, plk = tfast.decode_scan(p, freq, states, stream, n_tok)
    xp, up, plp = tfast.decode_scan_plain(p, freq, states, stream, n_tok)
    assert uk == up == words.numel()
    assert torch.equal(xk, xp) and torch.equal(plk, plp[:n_tok])


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1032, 2048, 4096, 8192])
@pytest.mark.parametrize("name", ["text", "random"])
def test_fast_rans_kernels_take_wide_blocks(cuda_device, name, lanes):
    """K9 and K10 above 1024 lanes (2, 4 or 8 lanes a thread) against their
    plain versions."""
    p = blk.BlockParams(**dict(FAST_WIDE, lanes=lanes, steps=16))
    n = p.capacity - 100
    inp = torch.from_numpy(
        _fast_inputs(name, p, n).reshape(p.lanes, p.steps)).to(cuda_device)
    dec = blk.parse_scan_plain(p, n, tfast.f2_find_plain(p, inp, n),
                               prices=tfast._F_PRICES, n_c=tfast._F_CANDS)
    _, n_tok, sym, xtr, tbits = tfast.tokenize_plain(p, inp, n, dec)
    freq, states, words = tfast.encode_scan_plain(p, sym, xtr, tbits, n_tok)
    got = tfast.encode_scan(p, sym, xtr, tbits, n_tok)
    assert all(torch.equal(a, b) for a, b in zip(got, (freq, states, words)))
    stream = torch.zeros(tfast._max_words(p), dtype=torch.int32, device=cuda_device)
    stream[: words.numel()] = words
    xk, uk, plk = tfast.decode_scan(p, freq, states, stream, n_tok)
    xp, up, plp = tfast.decode_scan_plain(p, freq, states, stream, n_tok)
    assert uk == up == words.numel()
    assert torch.equal(xk, xp) and torch.equal(plk, plp[:n_tok])


def _k9_tokens(rng, n_tok, literal=False):
    """K8-shaped tokens: literals, or matches whose extra bits are what
    their symbol says (len_bits + dist_bits, up to 30: both XTR events),
    the value below 2^bits; ``(sym, xtr, tbits)`` int32 [max(n_tok, 1)]."""
    m = max(n_tok, 1)
    is_m = np.zeros(m, bool) if literal else rng.random(m) < 0.6
    db, lb = rng.integers(0, 25, m), rng.integers(0, tfast.L_BUCKETS, m)
    sym = np.where(is_m, 256 + db * tfast.L_BUCKETS + lb, rng.integers(0, 256, m))
    bits = np.where(lb >= tfast.L_DIRECT, lb - 5, 0) + np.where(db == tfast.DB_REPEAT, 0, db)
    tbits = np.where(is_m, bits, 0)
    xtr = rng.integers(0, 1 << 62, m, dtype=np.uint64) & ((np.uint64(1) << tbits.astype(np.uint64))
                                                         - np.uint64(1))
    return [torch.from_numpy(a) for a in (sym.astype(np.int32), xtr.astype(np.uint32).view(
        np.int32), tbits.astype(np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "one", "under_s", "ragged", "full", "literals"])
@pytest.mark.parametrize("lanes", [8, 72, 512])
def test_k9_matches_plain_at_any_token_count(cuda_device, lanes, kind):
    """K9 (the token pass, K3's scan, K3p and K3b under one launch) against
    its plain version on K8-shaped tokens: no token, one, fewer than S, a
    ragged last step, every cell, all literals; a warp not full at S = 8
    and 72.  One ``K9`` launch a call; K10 decodes the stream as it comes
    and drains every state."""
    p = blk.BlockParams(**dict(FAST_WIDE, lanes=lanes, steps=32))
    n_tok = dict(none=0, one=1, under_s=lanes - 3, ragged=5 * lanes + 3, full=p.capacity,
                 literals=7 * lanes + 1)[kind]
    rng = np.random.default_rng([lanes, len(kind)])
    sym, xtr, tbits = (t.to(cuda_device) for t in _k9_tokens(rng, n_tok, kind == "literals"))
    want = tfast.encode_scan_plain(p, sym, xtr, tbits, n_tok)
    before = blk.LAUNCHES["K9"]
    got = tfast.encode_scan(p, sym, xtr, tbits, n_tok)
    assert blk.LAUNCHES["K9"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    freq, states, words = got
    if n_tok == 0:
        assert words.numel() == 0 and int(freq[0]) == tfast.M
        assert bool((states == tfast.RANS_L).all())
        return
    stream = torch.zeros(max(tfast._max_words(p), words.numel() + 3 * lanes + 16),
                         dtype=torch.int32, device=cuda_device)
    stream[: words.numel()] = words
    xk, uk, plk = tfast.decode_scan(p, freq, states, stream, n_tok)
    xp, up, plp = tfast.decode_scan_plain(p, freq, states, stream, n_tok)
    assert uk == up == words.numel() and bool((xk == tfast.RANS_L).all())
    assert torch.equal(xk, xp) and torch.equal(plk, plp[:n_tok])


def _k8_synthetic(kind, p, rng):
    """Decisions [2, T, S] int32 (take, src) of one kind (as
    tests/test_torch_f2tok_order.py's)."""
    T, S = p.steps, p.lanes
    t = np.arange(T)[:, None]
    left = T - t
    if kind == "two":
        take = np.full((T, S), 2)
    elif kind == "cap":
        take = np.full((T, S), tfast.K8_TAKE_MAX)
    elif kind == "long":
        take = np.full((T, S), 250)
    elif kind == "literals":
        take = np.where(rng.random((T, S)) < 0.05, rng.integers(2, 40, (T, S)), 0)
    elif kind == "to_end":
        take = np.where(rng.random((T, S)) < 0.3, left, rng.integers(0, 4, (T, S)))
    else:
        take = np.minimum(rng.integers(0, 251, (T, S)), left)
    pos = np.arange(S)[None, :] * T + t
    src = pos - rng.choice(np.array([1, 3, 7, 100, 5000]), (T, S))
    return np.stack([np.minimum(take, tfast.K8_TAKE_MAX), src]).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("geo", [(512, 2048, 1003), (72, 1100, 1200), (2048, 8, 5)])
@pytest.mark.parametrize("kind", ["two", "cap", "long", "literals", "to_end", "random"])
def test_k8_chunks_match_plain_on_synthetic_decisions(cuda_device, kind, geo):
    """K8's chunked replay against its plain version on synthetic decisions:
    four chunks a lane at S=512, a ragged last chunk and lanes that are no
    multiple of 32 at S=72, T=1100, one short chunk at S=2048, T=8; each
    block ends inside a lane."""
    lanes, steps, short = geo
    p = blk.BlockParams(**dict(FAST_WIDE, lanes=lanes, steps=steps))
    rng = np.random.default_rng(len(kind) + lanes)
    dec = torch.from_numpy(_k8_synthetic(kind, p, rng)).to(cuda_device)
    inp = torch.from_numpy(
        rng.integers(0, 256, (p.lanes, p.steps), dtype=np.uint8)).to(cuda_device)
    n = p.capacity - short
    _, n_tok, sym, xtr, tbits = tfast.tokenize_plain(p, inp, n, dec)
    got = tfast.tokenize(p, inp, n, dec)
    assert got[0] == n_tok
    assert all(torch.equal(a, b[:n_tok]) for a, b in zip(got[1:], (sym, xtr, tbits)))


@pytest.mark.cuda
def test_k8_refuses_a_take_above_the_window_cap(cuda_device):
    p = blk.BlockParams(**FAST_WIDE)
    dec = torch.zeros((2, p.steps, p.lanes), dtype=torch.int32, device=cuda_device)
    dec[0, 5, 3] = tfast.K8_TAKE_MAX + 1
    inp = torch.zeros((p.lanes, p.steps), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="above 256"):
        tfast.tokenize(p, inp, p.capacity, dec)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [512, 8192])
@pytest.mark.parametrize("name", ["text", "random"])
def test_k10_ring_serves_a_clamped_window(cuda_device, name, lanes):
    """K10 on a stream cut to its n_words words (at least S), so that the
    last steps' windows clamp to the stream's last S words: the states,
    words used and plane of the plain version, whatever they are."""
    p = blk.BlockParams(**dict(FAST_WIDE, lanes=lanes, steps=64 if lanes == 512 else 16))
    n = p.capacity - 100
    inp = torch.from_numpy(
        _fast_inputs(name, p, n).reshape(p.lanes, p.steps)).to(cuda_device)
    dec = blk.parse_scan(p, n, tfast.f2_find(p, inp, n),
                         prices=tfast._F_PRICES, n_c=tfast._F_CANDS)
    n_tok, sym, xtr, tbits = tfast.tokenize(p, inp, n, dec)
    freq, states, words = tfast.encode_scan(p, sym, xtr, tbits, n_tok)
    for size in (max(words.numel(), p.lanes), tfast._max_words(p)):
        stream = torch.zeros(size, dtype=torch.int32, device=cuda_device)
        stream[: words.numel()] = words
        xk, uk, plk = tfast.decode_scan(p, freq, states, stream, n_tok)
        xp, up, plp = tfast.decode_scan_plain(p, freq, states, stream, n_tok)
        assert uk == up and torch.equal(xk, xp) and torch.equal(plk, plp[:n_tok])


@pytest.mark.cuda
@pytest.mark.parametrize("flexible", [True, False])
def test_fast_block_roundtrip_on_card(cuda_device, flexible):
    p = blk.BlockParams(**dict(FAST_WIDE, lanes=72, flexible=flexible))
    data = text(p.capacity - 7, seed=8)
    before = dict(blk.LAUNCHES)
    payload = tfast.encode_block_fast(data, p, cuda_device)
    assert all(blk.LAUNCHES[k] == before[k] + 1 for k in ("K7", "K8", "K9"))
    assert blk.LAUNCHES["K6"] == before["K6"] + int(flexible)
    assert payload == tfast.encode_block_fast(data, p, "cpu")
    np.testing.assert_array_equal(
        tfast.decode_block_fast(payload, data.size, p, cuda_device), data)
    assert blk.LAUNCHES["K10"] == before["K10"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("name", ["period7", "zeros", "text"])
def test_fast_finder_knobs_on_card(cuda_device, monkeypatch, name, tail):
    """K7 with a two-word extension, where the diagonal runs carry the long
    lengths, with and without the run's last byte, and with four candidates."""
    monkeypatch.setattr(tfast, "_EXTW", 2)
    monkeypatch.setattr(tfast, "_F_DIAG_TAIL", tail)
    monkeypatch.setattr(tfast, "_F_CANDS", 4)
    p = blk.BlockParams(**FAST_WIDE)
    n = p.capacity - 321
    inp = torch.from_numpy(
        _fast_inputs(name, p, n).reshape(p.lanes, p.steps)).to(cuda_device)
    want = tfast.f2_find_plain(p, inp, n)
    assert torch.equal(tfast.f2_find(p, inp, n), want)
    if name != "text":
        assert int(want[0].max()) > 8
    kw = dict(prices=tfast._F_PRICES, n_c=4)
    assert torch.equal(blk.parse_scan(p, n, want, **kw),
                       blk.parse_scan_plain(p, n, want, **kw))


# ---- mode X: K4x, K6's X entry, K11, K12e, K3 at five slots, K12d

X_WIDE = dict(lanes=512, steps=64, mode="X", min_len=6, window=250, o3_bits=14,
              rolz_ctx_bytes=4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["text", "zeros", "period7", "random"])
@pytest.mark.parametrize("kernel", ["K4x", "K6X", "K11", "K6Xrep", "K12e", "K3",
                                    "K12d"])
def test_x_kernel_matches_plain(cuda_device, kernel, name):
    """Each mode-X kernel against its plain version (every output grid and
    every table equal), fed the plain version's output of the pass before."""
    p = blk.BlockParams(**X_WIDE)
    n = p.capacity - 100
    inp = torch.from_numpy(
        _fast_inputs(name, p, n).reshape(p.lanes, p.steps)).to(cuda_device)
    cands = blk.sort_candidates_plain(p, inp, n, True)
    if kernel == "K4x":
        bytes_pad = blk.pad_block(p, inp)
        cfg = blk.finder_cfg(p, n, True)
        hs, ps = blk.sort_positions(p, bytes_pad, n, tag="k4x", cfg=cfg)
        hp, pp = torch.sort(blk.sort_keys_plain(p, bytes_pad, n, True), stable=True)
        assert torch.equal(hs, hp) and torch.equal(ps, pp)
        assert torch.equal(blk.sort_candidates(p, inp, n, content=True), cands)
        return
    kw = dict(prices=blk.x_prices(), n_c=cands.shape[0] // 2)
    first = blk.parse_scan_plain(p, n, cands, **kw)
    if kernel == "K6X":
        assert torch.equal(blk.parse_scan(p, n, cands, **kw), first)
        return
    rep = blk.rep_scan_plain(p, inp, n, first)
    if kernel == "K11":
        assert torch.equal(blk.rep_scan(p, inp, n, first), rep)
        return
    dec = blk.parse_scan_plain(p, n, cands, rep=rep, **kw)
    if kernel == "K6Xrep":
        assert torch.equal(blk.parse_scan(p, n, cands, rep=rep, **kw), dec)
        return
    dec = dec[:2].contiguous()

    def fresh():
        return ppm.init_tables(True, p.o3_bits, cuda_device)

    tk, tp = fresh(), fresh()
    ev = blk.model_scan_plain(p, inp, n, dec, tp)
    if kernel == "K12e":
        assert torch.equal(blk.model_scan(p, inp, n, dec, tk), ev)
        assert all(torch.equal(tk[k], tp[k]) for k in tk)
        return
    want = blk.rans_scan_plain(p, ev)
    if kernel == "K3":
        got = blk.rans_scan(p, ev)
        assert got[1].shape == (p.steps, 5, p.lanes)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
    payload = blk._pack_payload(want[0], blk.pack_emit(p, want[1]), want[2])
    n_words, states, stream = blk._unpack_payload(payload, p)
    st = torch.from_numpy(states.astype(np.int64)).to(cuda_device)
    sw = torch.from_numpy(stream.astype(np.int32)).to(cuda_device)
    tk, tp = fresh(), fresh()
    xk, uk, ok = blk.decode_scan(p, st, sw, n, tk)
    xp, up, op = blk.decode_scan_plain(p, st, sw, n, tp)
    assert uk == up == n_words
    assert torch.equal(xk, xp) and torch.equal(ok, op)
    assert all(torch.equal(tk[k], tp[k]) for k in tk)
    assert np.array_equal(ok.cpu().numpy().reshape(-1)[:n],
                          inp.cpu().numpy().reshape(-1)[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_x_decode_kernel_on_garbage_matches_plain(cuda_device, seed):
    """A random stream drives distance buckets past 24 and sources before
    the block: the kernel must leave the state the plain version leaves."""
    p = blk.BlockParams(**dict(X_WIDE, lanes=64))
    rng = np.random.default_rng(seed)
    st = torch.from_numpy(rng.integers(1 << 16, 1 << 32, p.lanes, dtype=np.int64)).to(cuda_device)
    sw = torch.from_numpy(rng.integers(0, 1 << 16, p.stream_pad).astype(np.int32)).to(cuda_device)
    tk = ppm.init_tables(True, p.o3_bits, cuda_device)
    tp = ppm.init_tables(True, p.o3_bits, cuda_device)
    xk, uk, ok = blk.decode_scan(p, st, sw, p.capacity, tk)
    xp, up, op = blk.decode_scan_plain(p, st, sw, p.capacity, tp)
    assert uk == up and torch.equal(xk, xp) and torch.equal(ok, op)
    assert all(torch.equal(tk[k], tp[k]) for k in tk)


@pytest.mark.cuda
@pytest.mark.parametrize("flexible", [True, False])
@pytest.mark.parametrize("lanes", [8, 72, 1024])
def test_x_block_roundtrip_on_card(cuda_device, flexible, lanes):
    p = blk.BlockParams(**dict(X_WIDE, lanes=lanes, steps=32, flexible=flexible))
    data = text(p.capacity - 7, seed=8)
    before = dict(blk.LAUNCHES)
    payload = blk.encode_block(data, p, cuda_device)
    assert all(blk.LAUNCHES[k] == before[k] + 1 for k in ("K4x", "K12e", "K3"))
    assert blk.LAUNCHES["K6"] == before["K6"] + 2 * int(flexible)
    assert blk.LAUNCHES["K11"] == before["K11"] + int(flexible)
    assert payload == blk.encode_block(data, p, "cpu")
    np.testing.assert_array_equal(
        blk.decode_block(payload, data.size, p, cuda_device), data)
    assert blk.LAUNCHES["K12d"] == before["K12d"] + 1
    assert blk.LAUNCHES["K1"] == before["K1"]


@pytest.mark.cuda
@pytest.mark.parametrize("n_cands,probe", [(2, 4), (3, 0), (7, 64)])
def test_x_finder_knobs_on_card(cuda_device, monkeypatch, n_cands, probe):
    monkeypatch.setenv("CPX_X_CANDS", str(n_cands))
    monkeypatch.setenv("CPX_X_PROBE", str(probe))
    p = blk.BlockParams(**X_WIDE)
    n = p.capacity - 321
    inp = torch.from_numpy(
        _fast_inputs("text", p, n).reshape(p.lanes, p.steps)).to(cuda_device)
    want = blk.sort_candidates_plain(p, inp, n, True)
    assert want.shape[0] == 2 * n_cands
    assert torch.equal(blk.sort_candidates(p, inp, n, content=True), want)
    kw = dict(prices=blk.x_prices(), n_c=n_cands)
    first = blk.parse_scan_plain(p, n, want, **kw)
    rep = blk.rep_scan_plain(p, inp, n, first)
    assert torch.equal(blk.parse_scan(p, n, want, rep=rep, **kw),
                       blk.parse_scan_plain(p, n, want, rep=rep, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("knob", ["ext8 R", "ext8 X", "rprobe4", "rcands7", "xcands5"])
def test_k4_final_arms_and_knobs_on_card(cuda_device, monkeypatch, knob):
    """K4 and K4x against their plain versions where the final stage scans
    the diagonal runs (CPX_SORT_EXT=8: chunks of 512 steps, each scanned
    from the length cap above it), with a short chain (a small halo), and
    with 64-byte records (above four candidates)."""
    content = knob in ("ext8 X", "xcands5")
    if knob.startswith("ext8"):
        monkeypatch.setattr(blk, "_SORT_EXT", 8)
    elif knob == "rprobe4":
        monkeypatch.setattr(blk, "_R_PROBE", 4)
    elif knob == "rcands7":
        monkeypatch.setattr(blk, "_R_CANDS", 7)
    else:
        monkeypatch.setenv("CPX_X_CANDS", "5")
    # undecimated inserts and periodic bytes: long diagonal runs
    geo = X_WIDE if content else dict(WIDE, flexible=True, rolz_dec=1)
    p = blk.BlockParams(**dict(geo, lanes=64, steps=2048))
    n = p.capacity - 77
    make = _fast_inputs if content else _flex_inputs
    name = {"ext8 R": "period3", "ext8 X": "period7"}.get(knob, "text")
    inp = torch.from_numpy(make(name, p, n).reshape(p.lanes, p.steps)).to(cuda_device)
    want = blk.sort_candidates_plain(p, inp, n, content)
    assert torch.equal(blk.sort_candidates(p, inp, n, content), want)


# ---- mode P: K13e, K3 at three slots, K13d; mode X's scan finder: KSx


def test_p_cfg_and_constants_follow_the_python_side(monkeypatch):
    """Mode P's kernels read their APM switch from the same struct, and the
    header's LZP constants are the module's."""
    p = blk.BlockParams(lanes=512, steps=32, mode="P", min_len=4, window=250)
    by_name = dict(zip(blk._CFG_NAMES, blk._cfg_array(p, 777).tolist()))
    assert by_name["use_sse"] == ppm.SSE_P == 1 and by_name["match"] == 1
    off = blk.BlockParams(lanes=512, steps=32, mode="P", match=False)
    assert dict(zip(blk._CFG_NAMES, blk._cfg_array(off, 1).tolist()))["use_sse"] == 0
    monkeypatch.setattr(ppm, "SSE_P", 0)
    assert dict(zip(blk._CFG_NAMES, blk._cfg_array(p, 1).tolist()))["use_sse"] == 0
    src = (build.CSRC / "ppm_r.cuh").read_text()
    for name, value in (("LZP4_BITS", blk.LZP4_BITS), ("LZP8_BITS", blk.LZP8_BITS),
                        ("SSE_PCTX", ppm.SSE_PCTX)):
        assert int(re.search(rf"#define {name} (\d+)", src).group(1)) == value
    assert p.n_slots == 3
    assert [t.numel() for t in blk._init_lzp(p, "cpu").values()] == [1 << 16, 1 << 20, 1 << 23]
    with pytest.raises(ValueError, match="LZP tables"):
        blk._lzp_ptrs(p, None)
    with pytest.raises(ValueError, match="LZP tables"):
        blk._lzp_ptrs(off, blk._init_lzp(p, "cpu"))


P_WIDE = dict(lanes=512, steps=64, mode="P", min_len=4, window=250, o3_bits=14)


@pytest.mark.cuda
@pytest.mark.parametrize("match", [True, False])
@pytest.mark.parametrize("name", ["text", "zeros", "period7", "random"])
@pytest.mark.parametrize("kernel", ["K13e", "K3", "K13d"])
def test_p_kernel_matches_plain(cuda_device, kernel, name, match):
    """Each mode-P kernel against its plain version: every event grid, every
    PPM table and the three LZP tables equal; with the match layer off too."""
    p = blk.BlockParams(**dict(P_WIDE, match=match))
    n = p.capacity - 100
    inp = torch.from_numpy(
        _fast_inputs(name, p, n).reshape(p.lanes, p.steps)).to(cuda_device)

    def fresh():
        return (ppm.init_tables(match, p.o3_bits, cuda_device),
                blk._init_lzp(p, cuda_device) if match else None)

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)

    (tk, zk), (tp, zp) = fresh(), fresh()
    ev = blk.model_scan_plain(p, inp, n, None, tp, zp)
    if kernel == "K13e":
        assert torch.equal(blk.model_scan(p, inp, n, None, tk, zk), ev)
        assert same(tk, tp) and (not match or same(zk, zp))
        return
    want = blk.rans_scan_plain(p, ev)
    if kernel == "K3":
        assert all(torch.equal(a, b) for a, b in zip(blk.rans_scan(p, ev), want))
        return
    payload = blk._pack_payload(want[0], blk.pack_emit(p, want[1]), want[2])
    n_words, states, stream = blk._unpack_payload(payload, p)
    st = torch.from_numpy(states.astype(np.int64)).to(cuda_device)
    sw = torch.from_numpy(stream.astype(np.int32)).to(cuda_device)
    (tk, zk), (tp, zp) = fresh(), fresh()
    xk, uk, ok = blk.decode_scan(p, st, sw, n, tk, None, zk)
    xp, up, op = blk.decode_scan_plain(p, st, sw, n, tp, None, zp)
    assert uk == up == n_words
    assert torch.equal(xk, xp) and torch.equal(ok, op)
    assert same(tk, tp) and (not match or same(zk, zp))
    assert np.array_equal(ok.cpu().numpy().reshape(-1)[:n],
                          inp.cpu().numpy().reshape(-1)[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_p_decode_kernel_on_garbage_matches_plain(cuda_device, seed):
    """A random stream: matches where there is no candidate (source -1)."""
    p = blk.BlockParams(**dict(P_WIDE, lanes=64))
    rng = np.random.default_rng(seed)
    st = torch.from_numpy(rng.integers(1 << 16, 1 << 32, p.lanes, dtype=np.int64)).to(cuda_device)
    sw = torch.from_numpy(rng.integers(0, 1 << 16, p.stream_pad).astype(np.int32)).to(cuda_device)
    tk, tp = (ppm.init_tables(True, p.o3_bits, cuda_device) for _ in range(2))
    zk, zp = (blk._init_lzp(p, cuda_device) for _ in range(2))
    xk, uk, ok = blk.decode_scan(p, st, sw, p.capacity, tk, None, zk)
    xp, up, op = blk.decode_scan_plain(p, st, sw, p.capacity, tp, None, zp)
    assert uk == up and torch.equal(xk, xp) and torch.equal(ok, op)
    assert all(torch.equal(tk[k], tp[k]) for k in tk)
    assert all(torch.equal(zk[k], zp[k]) for k in zk)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8, 72, 1024])
def test_p_block_roundtrip_on_card(cuda_device, lanes):
    p = blk.BlockParams(**dict(P_WIDE, lanes=lanes, steps=32))
    data = text(p.capacity - 7, seed=8)
    before = dict(blk.LAUNCHES)
    payload = blk.encode_block(data, p, cuda_device)
    assert all(blk.LAUNCHES[k] == before[k] + 1 for k in ("K13e", "K3"))
    assert payload == blk.encode_block(data, p, "cpu")
    np.testing.assert_array_equal(
        blk.decode_block(payload, data.size, p, cuda_device), data)
    assert blk.LAUNCHES["K13d"] == before["K13d"] + 1
    assert blk.LAUNCHES["K12d"] == before["K12d"]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"top_k": 1}, {"top_k": 8, "probe": 8},
                                {"lanes": 1024, "steps": 16, "rolz_depth": 64,
                                 "rolz_bits": 12}])
@pytest.mark.parametrize("name", ["text", "zeros", "period7", "random"])
def test_x_search_kernel_matches_plain(cuda_device, name, kw):
    """KSx against its plain version: the six grids, both bucket tables and
    the near-match cache; also at S=1024, D=64 (four row tiles a lane:
    smaller batches of a warp's lanes)."""
    p = blk.BlockParams(**{**X_WIDE, "rolz_bits": 10, "rolz_depth": 16, **kw})
    n = p.capacity - 100
    inp = torch.from_numpy(
        _fast_inputs(name, p, n).reshape(p.lanes, p.steps)).to(cuda_device)
    tk, tp = blk._init_xsearch(p, cuda_device), blk._init_xsearch(p, cuda_device)
    want = blk.search_scan_plain(p, inp, n, tp)
    assert torch.equal(blk.search_scan(p, inp, n, tk), want)
    assert all(torch.equal(a, b) for a, b in zip(tk, tp))


# The search scans at the main path's depth (D = 64, window 250): S=512 at
# T=2048 (every bucket row filled), a ragged S=72, the cluster's widest
# four-thread arm (S=2048) and one thread a lane (S=4096), top_k 1 and 8,
# a 48-byte probe (prefix_len's path) and an all-zero block (one hot
# bucket); the block 100 bytes short.
SEARCH_CASES = {
    "S512_T2048": dict(lanes=512, steps=2048),
    "ragged_S72": dict(lanes=72, steps=96),
    "S2048": dict(lanes=2048, steps=32),
    "S4096": dict(lanes=4096, steps=16),
    "top_k1": dict(lanes=512, steps=64, top_k=1),
    "top_k8": dict(lanes=512, steps=64, top_k=8),
    "probe48": dict(lanes=512, steps=64, probe=48),
    "zeros": dict(lanes=512, steps=256),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
@pytest.mark.parametrize("mode", ["R", "X"])
def test_search_kernels_match_plain_at_depth_64(cuda_device, mode, case):
    """KS and KSx against their plain versions at tolerance 0: every grid
    and every table after the launch (KS's bucket table; KSx's two bucket
    tables and the near-match cache)."""
    base = (dict(WIDE, min_len=5, window=250) if mode == "R"
            else dict(X_WIDE, rolz_dec=1))
    kw = dict(SEARCH_CASES[case])
    p = blk.BlockParams(**dict(base, rolz_bits=12, rolz_depth=64, flexible=False, **kw))
    n = p.capacity - 100
    buf = np.zeros(p.capacity, np.uint8)
    if case != "zeros":
        buf[:n] = text(n, seed=p.lanes + p.steps)
    inp = torch.from_numpy(buf.reshape(p.lanes, p.steps)).to(cuda_device)
    init = blk._init_rolz if mode == "R" else blk._init_xsearch
    tk, tp = init(p, cuda_device), init(p, cuda_device)
    before = blk.LAUNCHES["KS" if mode == "R" else "KSx"]
    got = blk.search_scan(p, inp, n, tk)
    assert blk.LAUNCHES["KS" if mode == "R" else "KSx"] == before + 1
    assert torch.equal(got, blk.search_scan_plain(p, inp, n, tp))
    pairs = [(tk, tp)] if mode == "R" else list(zip(tk, tp))
    assert all(torch.equal(a, b) for a, b in pairs)


@pytest.mark.cuda
@pytest.mark.parametrize("flexible", [True, False])
@pytest.mark.parametrize("mode", ["X", "R"])
def test_scan_finder_block_roundtrip_on_card(cuda_device, monkeypatch, mode, flexible):
    """CPX_X_FINDER=scan (KSx in K4x's place) and CPX_R_FINDER=scan (KS, then
    K6 on its one candidate): the plain versions' payload, and it decodes."""
    monkeypatch.setitem(blk._ENV, f"CPX_{mode}_FINDER", "scan")
    base = X_WIDE if mode == "X" else WIDE
    p = blk.BlockParams(**dict(base, lanes=72, steps=32, flexible=flexible,
                               rolz_bits=10, rolz_depth=16))
    data = text(p.capacity - 7, seed=8)
    before = dict(blk.LAUNCHES)
    payload = blk.encode_block(data, p, cuda_device)
    assert blk.LAUNCHES["KSx" if mode == "X" else "KS"] == before["KSx" if mode == "X" else "KS"] + 1
    assert blk.LAUNCHES["K4x"] == before["K4x"] and blk.LAUNCHES["K4"] == before["K4"]
    assert blk.LAUNCHES["K6"] == before["K6"] + (2 if mode == "X" else 1) * int(flexible)
    assert payload == blk.encode_block(data, p, "cpu")
    np.testing.assert_array_equal(
        blk.decode_block(payload, data.size, p, cuda_device), data)


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["p1", "p1b", "p3", "p4", "p5", "p6", "p7", "p8", "p9"])
def test_probe_kernels_match_plain(cuda_device, key):
    """Each probe kernel against its plain version at its own geometries
    (S=512), tolerance 0 (P8: against bf16(table)[idx]); each launch is
    counted under its case's key: the probe's name for its headline arm,
    P1t, P3w, P4s and P5w for P1's thread a row, P3's one warp, P4's launch
    a step and P1's flat gather on P5's rows."""
    from comprox_tpu_torch.benchmarks import probes

    for case in probes.PROBES[key](cuda_device, probes.S, seed=3):
        before = dict(probes.LAUNCHES)
        got = case.kernel()
        assert probes.LAUNCHES[case.counter] > before[case.counter], case.label
        assert all(probes.LAUNCHES[k] == n for k, n in before.items()
                   if k != case.counter), case.label
        want = case.plain()
        assert got.dtype == want.dtype and torch.equal(got, want), case.label


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["P1", "P6"])
@pytest.mark.parametrize("width,offset", [(1, 0), (3, 0), (8, 0), (260, 0), (8, 1), (260, 1)])
def test_row_gather_takes_ragged_and_unaligned_rows(cuda_device, key, width, offset):
    """P1's and P6's flat gather against its plain version, tolerance 0, at
    S = 104 (the last CTA ragged), widths 1, 3, 8 and 260, and a table 4
    bytes past 16-byte alignment (offset 1: the 4-byte word arm); each
    launch counted under the probe's key."""
    from comprox_tpu_torch.benchmarks import probes

    rng = np.random.default_rng([width, offset])
    base = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, 300 * width + offset,
                                         dtype=np.int32)).to(cuda_device)
    table = base[offset:].view(300, width)
    assert (table.data_ptr() % 16 != 0) == bool(offset)
    idx = torch.from_numpy(rng.integers(0, 300, 104, dtype=np.int32)).to(cuda_device)
    fn = probes.probe_vmem_gather if key == "P1" else probes.probe_taa
    before = dict(probes.LAUNCHES)
    got = fn(table, idx)
    torch.cuda.synchronize()
    assert probes.LAUNCHES[key] == before[key] + 1
    assert all(probes.LAUNCHES[k] == n for k, n in before.items() if k != key)
    assert torch.equal(got, probes.row_gather_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width,lanes,steps", [(2048, 128, 512, 512), (1000, 3, 104, 64),
                                                    (58112, 1, 512, 64)])
def test_p4_steps_take_signed_tables(cuda_device, rows, width, lanes, steps):
    """P4's persistent arm on a table of negative and fractional values
    (quarters; row 0's -2.75 takes every chain below zero at its first
    step, where truncation and floor differ), tolerance 0: the probe's
    shape, a ragged last CTA with rows not a power of two, and the most
    rows a CTA's shared memory stages; each launch counted under P4."""
    from comprox_tpu_torch.benchmarks import probes

    rng = np.random.default_rng(rows)
    values = rng.integers(-600, 600, (rows, width)) / 4
    values[0, 0] = -2.75
    table = torch.from_numpy(values.astype(np.float32)).to(cuda_device)
    before = probes.LAUNCHES["P4"]
    got = probes.probe_persistent_steps(table, lanes, steps)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["P4"] == before + 1
    want = probes.steps_plain(table, lanes, steps)
    assert tuple(got.shape) == (lanes, 1) and torch.equal(got[:, 0], want)
    assert bool((probes.steps_plain(table, lanes, 1) == -2.75).all())


@pytest.mark.cuda
def test_p4_refuses_a_column_above_shared_memory(cuda_device):
    from comprox_tpu_torch.benchmarks import probes

    table = torch.zeros((probes.STEPS_MAX_ROWS + 1, 1), device=cuda_device)
    before = probes.LAUNCHES["P4"]
    with pytest.raises(ValueError, match=f"at most {probes.STEPS_MAX_ROWS} rows"):
        probes.probe_persistent_steps(table, 512, 8)
    assert probes.LAUNCHES["P4"] == before
    # the launcher refuses it too
    out = torch.empty(512, device=cuda_device)
    assert build.lib().cpx_pr_steps_launch(table.data_ptr(), out.data_ptr(), *table.shape,
                                           512, 8, torch.cuda.current_stream().cuda_stream) != 0


@pytest.mark.cuda
def test_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    from comprox_tpu_torch.benchmarks import probes

    idx = torch.zeros(512, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 64"):
        probes.probe_kernel_onehot(torch.zeros((100, 384), device=cuda_device), idx)
    # P5's and P9's ring: a CTA holds a few rows (probes.cu's RING_R), so
    # even the widest row (4096) fits its 48 KB, and the width, the depth
    # and the table's alignment are what it refuses; rows of width 1024 at
    # depth 32, more than 32 slots of them would hold in 48 KB, it takes
    assert build.lib().cpx_pr_row_ring_smem(4096, 512, 32) <= 48 * 1024
    wide = torch.arange(64 * 1024, dtype=torch.int32, device=cuda_device).view(64, 1024)
    ring_idx = torch.randint(0, 64, (512,), dtype=torch.int32, device=cuda_device)
    assert torch.equal(probes.probe_dma_depth(wide, ring_idx, 32), wide[ring_idx.long()])
    i32_ring = torch.zeros(8 * 4104, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="up to 4096, and a CTA's ring and indices within 48 KB"):
        probes.probe_dma_depth(i32_ring[:8 * 4100].view(8, 4100), idx, 32)
    with pytest.raises(ValueError, match="multiple of 4"):
        probes.probe_dma(i32_ring[:8 * 6].view(8, 6), idx)
    with pytest.raises(ValueError, match="16-byte aligned"):
        probes.probe_dma(i32_ring[1:1 + 8 * 64].view(8, 64), idx)
    with pytest.raises(ValueError, match="depth 16 or 32"):
        probes.probe_dma_depth(i32_ring[:8 * 64].view(8, 64), idx, 8)
    with pytest.raises(ValueError, match="int32"):
        probes.probe_vmem_gather(torch.zeros((64, 8), device=cuda_device), idx)
    # P8: more rows than a CTA's accumulators hold, a table off 16 bytes
    f32 = torch.zeros(64 * 65, device=cuda_device)
    with pytest.raises(ValueError, match="1 to 512 output rows"):
        probes.probe_kernel_onehot(torch.zeros((64, 64), device=cuda_device),
                                   torch.zeros(513, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="16-byte aligned"):
        probes.probe_kernel_onehot(f32[1:1 + 64 * 64].view(64, 64), idx)
    # P3's bulk copies: rows not a multiple of 16 bytes, a table off 16
    # bytes, more rows a CTA than 48 KB; an unknown arm
    i32 = torch.zeros(64 * 65, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        probes.probe_dynslice_loop(i32[:64 * 6].view(64, 6), idx)
    with pytest.raises(ValueError, match="16-byte aligned"):
        probes.probe_dynslice_loop(i32[1:1 + 64 * 64].view(64, 64), idx)
    cta_rows = build.lib().cpx_pr_row_bulk_smem(1, 512) // 4
    with pytest.raises(ValueError, match="48 KB"):  # just over, a CTA's rows
        probes.probe_dynslice_loop(torch.zeros((8, 12 * 1024 // cta_rows + 4),
                                               dtype=torch.int32, device=cuda_device), idx)
    with pytest.raises(ValueError, match="'bulk' or 'warp'"):
        probes.probe_dynslice_loop(i32.view(65, 64), idx, "ring")
    # what the one warp takes, the bulk copies refuse
    got = probes.probe_dynslice_loop(i32[:64 * 6].view(64, 6), idx, "warp")
    assert torch.equal(got, i32[:64 * 6].view(64, 6)[idx.long()])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [512, 500, 5, 1])
def test_p3_bulk_copies_take_a_ragged_last_cta(cuda_device, S):
    """S a multiple of the rows a CTA, not one, and below it."""
    from comprox_tpu_torch.benchmarks import probes

    rng = np.random.default_rng(S)
    table = torch.from_numpy(rng.integers(0, 1 << 30, (1000, 256), dtype=np.int32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, 1000, S, dtype=np.int32)).to(cuda_device)
    before = probes.LAUNCHES["P3"]
    got = probes.probe_dynslice_loop(table, idx)
    assert probes.LAUNCHES["P3"] == before + 1
    assert torch.equal(got, table[idx.long()])


def _widest_ring_width(S: int, depth: int) -> int:
    """The widest row (a multiple of 4, at most 4096) whose CTA ring the
    ring launcher takes at S rows and this depth."""
    lib = build.lib()
    return max(w for w in range(4, 4097, 4)
               if lib.cpx_pr_row_ring_smem(w, S, depth) <= 48 * 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [16, 32])
@pytest.mark.parametrize("S,width", [(512, 256), (509, 256), (5, 256), (1, 256),
                                     (512, 4), (512, "widest"), (7, "widest")])
def test_p5_p9_ring_takes_ragged_ctas_and_every_width(cuda_device, S, width, depth):
    """P5's and P9's ring against table[idx], tolerance 0: the probe's S, a
    ragged last CTA (509 rows), fewer rows than the depth, one row; the
    smallest row (width 4) and the widest the launcher takes; repeated
    indices and rows 0 and rows - 1.  P9 is the depth-16 ring."""
    from comprox_tpu_torch.benchmarks import probes

    if width == "widest":
        width = _widest_ring_width(S, depth)
    rows = 1000
    rng = np.random.default_rng([S, width, depth])
    table = torch.from_numpy(rng.integers(0, 1 << 30, (rows, width), dtype=np.int32))
    idx = rng.integers(0, rows, S)
    idx[0], idx[-1] = rows - 1, 0
    idx[3:9] = idx[2] if S > 2 else idx[3:9]
    table = table.to(cuda_device)
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda_device)
    arms = [("P5", lambda: probes.probe_dma_depth(table, idx, depth))]
    if depth == 16:
        arms.append(("P9", lambda: probes.probe_dma(table, idx)))
    for name, call in arms:
        before = dict(probes.LAUNCHES)
        got = call()
        assert probes.LAUNCHES[name] == before[name] + 1
        assert all(probes.LAUNCHES[k] == n for k, n in before.items() if k != name)
        assert torch.equal(got, table[idx.long()]), name


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width,S,kind", [
    (8192, 384, 512, "one range"), (8192, 384, 512, "range edges"),
    (4096, 384, 512, "range edges"), (4096, 384, 512, "repeated"),
    (64 * 23, 384, 512, "random"), (64 * 23, 128, 512, "random"),
    (4096, 64, 512, "random"), (4096, 384, 100, "random"), (64, 64, 1, "random")])
def test_onehot_wgmma_edges_match_plain(cuda_device, rows, width, S, kind):
    """P8's kernel at the CPU mirror's edges (tests/test_torch_probes_order.py):
    all indices in one K range, every range's first and last row with 0 and
    rows - 1, repeated indices, a ragged last range, other widths, S below
    512; equal to bf16(table)[idx], tolerance 0."""
    from comprox_tpu_torch.benchmarks import probes

    rng = np.random.default_rng([rows, width, S])
    table = torch.from_numpy(rng.integers(0, 24576, (rows, width)).astype(np.float32))
    chunks = rows // 64
    want = max(1, torch.cuda.get_device_properties(0).multi_processor_count // (width // 64))
    per = -(-chunks // want)
    span = per * 64
    if kind == "one range":
        idx = rng.integers(min(3 * span, rows - span), min(4 * span, rows), S)
    elif kind == "range edges":
        firsts = np.arange(0, rows, span)
        idx = np.resize(np.concatenate([[0, rows - 1], firsts,
                                        np.minimum(firsts + span, rows) - 1]), S)
    elif kind == "repeated":
        idx = np.resize(rng.integers(0, rows, 5), S)
    else:
        idx = rng.integers(0, rows, S)
        idx[0], idx[-1] = 0, rows - 1
    table, idx = table.to(cuda_device), torch.from_numpy(idx.astype(np.int32)).to(cuda_device)
    before = probes.LAUNCHES["P8"]
    got = probes.probe_kernel_onehot(table, idx)
    assert probes.LAUNCHES["P8"] == before + 1
    assert torch.equal(got, probes.onehot_bf16_plain(table, idx))


def test_wide_block_runs_on_the_cpu_and_is_refused_on_a_card(monkeypatch):
    """A block of more lanes than a CTA has threads codes on the CPU (the
    plain versions, no launch); on a CUDA tensor a block of more lanes than
    a cluster of eight CTAs has threads is refused before any launch, by
    the step scans and by K9."""
    p = blk.BlockParams(**dict(WIDE, lanes=2048, steps=4))
    blk.reset_launch_counts()
    data = text(p.capacity - 9, seed=4)
    payload = blk.encode_block(data, p, "cpu")
    np.testing.assert_array_equal(blk.decode_block(payload, data.size, p, "cpu"), data)
    assert not any(blk.LAUNCHES.values())
    monkeypatch.setattr(blk, "_dispatch", lambda *t: "cuda")
    monkeypatch.setattr(tfast, "_dispatch", lambda *t: "cuda")
    p = blk.BlockParams(**dict(WIDE, lanes=16384, steps=4))
    with pytest.raises(NotImplementedError, match="lanes <= 8192"):
        blk.model_scan(p, torch.zeros((p.lanes, p.steps), dtype=torch.uint8), 8,
                       torch.zeros((4, p.steps, p.lanes), dtype=torch.int32),
                       ppm.init_tables(True, 10, "cpu"))
    pf = blk.BlockParams(**dict(FAST_WIDE, lanes=16384, steps=4))
    z = torch.zeros(pf.capacity, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="lanes <= 8192"):
        tfast.encode_scan(pf, z, z, z, 0)
    assert not any(blk.LAUNCHES.values())


# ---- chain mode v2 (crz -C): KCR, K3p and the chain arms of K5 and K1 ------

CHAIN = dict(WIDE, flexible=True, chain_match=True)


def _chain_block(p, dev, seed):
    """The chain state after one block of text coded on the card, and the
    next block: ``(state1, inp [S, T] on dev, n)``."""
    n = p.capacity - 50
    data = text(p.capacity + n, seed)
    _, st = blk.encode_block_chained(data[: p.capacity], p,
                                     blk.init_chain_tables(p, dev), dev)
    buf = np.zeros(p.capacity, np.uint8)
    buf[:n] = data[p.capacity:]
    return st, torch.from_numpy(buf.reshape(p.lanes, p.steps)).to(dev), n


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["KCR", "K5ch", "K1ch"])
def test_chain_kernel_matches_plain(cuda_device, kernel):
    """Each chain kernel against its plain version, from the state one
    block on the card leaves (tolerance 0 on every grid and table)."""
    p = blk.BlockParams(**CHAIN)
    st, inp, n = _chain_block(p, cuda_device, 13)
    before = dict(blk.LAUNCHES)
    if kernel == "KCR":
        rng = np.random.default_rng(2)
        rand = torch.from_numpy(rng.integers(
            0, 2 * p.capacity + 1, st["ment"].shape, dtype=np.int32)).to(cuda_device)
        for ment in (st["ment"], rand):
            want = blk.remap_chain_ment_plain(p, ment)
            assert torch.equal(blk.remap_chain_ment(p, ment), want)
            assert (want[..., 0] > 0).any()
        assert blk.LAUNCHES["KCR"] == before["KCR"] + 2
        return
    ment = blk.remap_chain_ment_plain(p, st["ment"])
    if kernel == "K5ch":
        props = blk.sort_candidates_plain(p, inp, n)
        rk, rp = ment.clone(), ment.clone()
        got = blk.rank_scan(p, inp, n, props, rk, st["prev"])
        assert blk.LAUNCHES["K5ch"] == before["K5ch"] + 1
        assert blk.LAUNCHES["K5"] == before["K5"]
        want = blk.rank_scan_plain(p, inp, n, props, rp, st["prev"])
        assert torch.equal(got, want) and torch.equal(rk, rp)
        assert (want[1::3][:-1] >= p.capacity - 1).all()  # window-absolute
        return
    payload, _ = blk.encode_block_chained(
        inp.cpu().numpy().reshape(-1)[:n], p, st, cuda_device)
    n_words, states, stream = blk._unpack_payload(payload, p)
    x0 = torch.from_numpy(states.astype(np.int64)).to(cuda_device)
    sw = torch.from_numpy(stream.astype(np.int32)).to(cuda_device)
    tk = {k: v.clone() for k, v in st["tables"].items()}
    tp = {k: v.clone() for k, v in st["tables"].items()}
    rk, rp = ment.clone(), ment.clone()
    xk, uk, ok = blk.decode_scan(p, x0, sw, n, tk, rk, prev=st["prev"])
    assert blk.LAUNCHES["K1ch"] == before["K1ch"] + 1
    xp, up, op = blk.decode_scan_plain(p, x0, sw, n, tp, rp, prev=st["prev"])
    assert uk == up == n_words
    assert torch.equal(xk, xp) and torch.equal(ok, op) and torch.equal(rk, rp)
    assert all(torch.equal(tk[k], tp[k]) for k in tk)
    assert torch.equal(ok, inp)


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [3, 5])
@pytest.mark.parametrize("lanes", [8, 512, 2056])
def test_k3p_matches_plain(cuda_device, n_slots, lanes):
    p = blk.BlockParams(lanes=lanes, steps=37, mode="X" if n_slots == 5 else "R")
    rng = np.random.default_rng(lanes)
    emit = torch.from_numpy(rng.integers(0, 2, (37, n_slots, lanes)).astype(bool))
    got = blk.pack_emit(p, emit.to(cuda_device))
    assert got.shape == (37, n_slots, lanes // 8)
    assert torch.equal(got.cpu(), blk.pack_emit_plain(emit))


def _events(rng, steps, n_slots, lanes):
    """Random K3 events [T, 3 * n_slots, S]: c and f over all 16 bits, the
    flag on about three lanes in four."""
    ev = rng.integers(0, 1 << 16, (steps, 3 * n_slots, lanes)).astype(np.int32)
    ev[:, 2::3] = rng.random((steps, n_slots, lanes)) < 0.75
    return torch.from_numpy(ev)


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [3, 5])
@pytest.mark.parametrize("lanes,steps", [(8, 5), (512, 37), (2056, 37)])
def test_k3_matches_plain(cuda_device, n_slots, lanes, steps):
    """The redesigned K3 (the events' ring, the reciprocal quotient, a warp
    a CTA) on random events: fewer steps than the ring holds, lanes not a
    multiple of a CTA's."""
    p = blk.BlockParams(lanes=lanes, steps=steps, mode="X" if n_slots == 5 else "R")
    ev = _events(np.random.default_rng(lanes + steps), steps, n_slots, lanes)
    want = blk.rans_scan_plain(p, ev)
    got = blk.rans_scan(p, ev.to(cuda_device))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def _mask_words(rng, steps, n_slots, lanes):
    """A random K3p mask (one row all silent, one all emitting) and words."""
    emit = rng.random((steps, n_slots, lanes)) < 0.3
    emit[0, 0] = False
    emit[-1, -1] = True
    words = rng.integers(0, 1 << 16, (steps, n_slots, lanes)).astype(np.int32)
    return blk.pack_emit_plain(torch.from_numpy(emit)), torch.from_numpy(words)


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [3, 5])
@pytest.mark.parametrize("lanes", [8, 512, 2056])
def test_k3b_matches_plain(cuda_device, n_slots, lanes):
    packed, words = _mask_words(np.random.default_rng(lanes), 37, n_slots, lanes)
    nw_p, stream_p = blk.compact_stream_plain(packed, words)
    before = blk.LAUNCHES["K3b"]
    nw, stream = blk.compact_stream(packed.to(cuda_device), words.to(cuda_device))
    assert blk.LAUNCHES["K3b"] == before + 1
    assert nw.shape == () and stream.shape == (37 * n_slots * lanes,)
    assert int(nw) == int(nw_p) > 0
    assert torch.equal(stream[: int(nw)].cpu(), stream_p[: int(nw)])


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [3, 5])
def test_k3b_block_axis_matches_one_block_launches(cuda_device, n_slots):
    """G = 4 blocks of different word counts in one launch: each block's
    count and stream segment are its one-block launch's."""
    rng = np.random.default_rng(n_slots)
    blocks = [_mask_words(rng, 64, n_slots, 512) for _ in range(4)]
    blocks[1][0].zero_()  # a block that emits nothing
    packed = torch.stack([b[0] for b in blocks]).to(cuda_device)
    words = torch.stack([b[1] for b in blocks]).to(cuda_device)
    nw, streams = blk.compact_stream(packed, words)
    assert nw.shape == (4,)
    assert nw[1] == 0 and len(set(nw.tolist())) == 4
    for b in range(4):
        one_nw, one = blk.compact_stream(packed[b], words[b])
        assert int(one_nw) == int(nw[b])
        assert torch.equal(streams[b, : int(nw[b])], one[: int(one_nw)])


def _flat_mask_words(rng, G, steps, n_slots, lanes, kinds):
    """G blocks' K3p masks and words, block b all silent, all emitting or
    random (``kinds[b]``: "silent", "all" or a flag density)."""
    emit = np.stack([np.zeros((steps, n_slots, lanes), bool) if k == "silent"
                     else np.ones((steps, n_slots, lanes), bool) if k == "all"
                     else rng.random((steps, n_slots, lanes)) < k for k in kinds])
    words = rng.integers(0, 1 << 16, (G, steps, n_slots, lanes)).astype(np.int32)
    packed = torch.stack([blk.pack_emit_plain(torch.from_numpy(e)) for e in emit])
    return packed, torch.from_numpy(words)


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [3, 5])
@pytest.mark.parametrize("lanes,steps", [(8, 37), (72, 11), (72, 1)])
def test_k3b_takes_unaligned_segments(cuda_device, n_slots, lanes, steps):
    """K3b at S = 8 and 72 with odd T: a block's mask segment is T n_slots
    S / 8 bytes, no multiple of 16, so on the block axis each block after
    the first starts unaligned, and so does a one-block launch on such a
    block's view.  Blocks all silent, all emitting and random; each against
    the plain version, one ``K3b`` launch a call."""
    kinds = ["all", "silent", 0.3, "all", 0.05]
    packed, words = _flat_mask_words(np.random.default_rng([lanes, steps, n_slots]),
                                     len(kinds), steps, n_slots, lanes, kinds)
    assert (packed[0].numel() % 16) != 0
    packed, words = packed.to(cuda_device), words.to(cuda_device)
    before = blk.LAUNCHES["K3b"]
    nw, streams = blk.compact_stream(packed, words)
    assert blk.LAUNCHES["K3b"] == before + 1
    for b, kind in enumerate(kinds):
        want_nw, want = blk.compact_stream_plain(packed[b], words[b])
        assert int(nw[b]) == int(want_nw)
        assert (int(nw[b]) == 0) == (kind == "silent")
        assert (int(nw[b]) == words[b].numel()) == (kind == "all")
        assert torch.equal(streams[b, : int(nw[b])], want[: int(want_nw)])
        one_nw, one = blk.compact_stream(packed[b], words[b])
        assert int(one_nw) == int(want_nw) and torch.equal(one[: int(one_nw)],
                                                           want[: int(want_nw)])
    assert blk.LAUNCHES["K3b"] == before + 1 + len(kinds)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 3])
def test_k3b_at_crz_width_and_beyond_one_wave(cuda_device, G):
    """K3b on crz's full-width grid (T = 16384, three slots, S = 512: 49,152
    rows, 769 tiles a block) at crz's density and, on the block axis, three
    such blocks (2,307 tiles: more than the card holds at once, so tiles
    wait on tiles of an earlier wave), each against the plain version."""
    steps, n_slots, lanes = 16384, 3, 512
    kinds = [0.0085, "all", 0.3][:G]
    emit = torch.stack([torch.ones((steps, n_slots, lanes), dtype=torch.bool,
                                   device=cuda_device) if k == "all" else
                        torch.rand((steps, n_slots, lanes), generator=torch.Generator(
                            device=cuda_device).manual_seed(G), device=cuda_device) < k
                        for k in kinds])
    words = torch.randint(0, 1 << 16, (G, steps, n_slots, lanes), dtype=torch.int32,
                          device=cuda_device)
    packed = torch.stack([blk.pack_emit_plain(e) for e in emit])
    del emit
    nw, streams = blk.compact_stream(packed if G > 1 else packed[0],
                                     words if G > 1 else words[0])
    nw, streams = nw.reshape(G), streams.reshape(G, -1)
    for b in range(G):
        want_nw, want = blk.compact_stream_plain(packed[b], words[b])
        assert int(nw[b]) == int(want_nw) > 0
        assert torch.equal(streams[b, : int(nw[b])], want[: int(want_nw)])


@pytest.mark.cuda
@pytest.mark.parametrize("codec,flags", [("crz", ["-c"]), ("crz", ["-C"]),
                                         ("crx", ["-c"]), ("crp", ["-c"])])
def test_chained_archive_on_card_equals_cpu(cuda_device, tmp_path, codec, flags):
    """The CLI's chained archives, four blocks of S=64 and T=64: the card
    writes the plain versions' bytes and decodes them."""
    from comprox_tpu_torch.cli import main as cli

    data = text(4 * 4096 - 300, seed=21)
    src = tmp_path / "in"
    data.tofile(src)
    argv = [*flags, "-b0.00390625", "-l64", "-q"]
    before = dict(blk.LAUNCHES)
    cli.run(codec, ["e", str(src), str(tmp_path / "card"), *argv], device=cuda_device)
    cli.run(codec, ["e", str(src), str(tmp_path / "cpu"), *argv], device="cpu")
    assert (tmp_path / "card").read_bytes() == (tmp_path / "cpu").read_bytes()
    cli.run(codec, ["d", str(tmp_path / "card"), str(tmp_path / "out"), "-q"],
            device=cuda_device)
    assert (tmp_path / "out").read_bytes() == data.tobytes()
    used = {k for k in blk.LAUNCHES if blk.LAUNCHES[k] > before[k]}
    assert "K3p" in used
    assert {"KCR", "K5ch", "K1ch"} <= used if "-C" in flags else not (
        {"KCR", "K5ch", "K1ch"} & used)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["R", "R-f0", "X", "P", "R-S2048", "X-S2048", "P-S2048"])
def test_block_axis_matches_one_block_launches(cuda_device, mode):
    """One batched launch a pass over G = 3 blocks gives each block what its
    one-block launches give it: the encode passes' states, packed mask and
    words, then the decode scan's states, word counts and bytes.  The
    blocks' word counts differ by thousands (the first is short), so a
    stream window that clamped against the whole [G, W] buffer and not the
    block's own row would read another block's words.  At S=2048 each
    block's scans run as a cluster of CTAs, G clusters a launch."""
    kw = {"R": {}, "R-f0": {"flexible": False}, "X": {"mode": "X", "min_len": 6},
          "P": {"mode": "P", "min_len": 4, "rolz_ctx_bytes": 3, "rolz_dec": 1}}[mode.replace("-S2048", "")]
    if mode.endswith("-S2048"):
        kw = dict(kw, lanes=2048, steps=16)
    p = blk.BlockParams(**dict(dict(WIDE, steps=64, window=250, flexible=True), **kw))
    G, cap = 3, p.capacity
    ns = [300, cap, cap - 1003]
    data = text(3 * cap, seed=12)
    buf = np.zeros((G, p.lanes, p.steps), np.uint8)
    for b, n in enumerate(ns):
        buf[b].reshape(-1)[:n] = data[b * cap : b * cap + n]
    inp = torch.from_numpy(buf).to(cuda_device)
    n = torch.tensor(ns, dtype=torch.int32, device=cuda_device)
    blk.reset_launch_counts()
    states, packed, words = blk.encode_passes_blocks(p, inp, n)
    scan = {"R": "K5" if p.flexible else "KS", "X": "K12e", "P": "K13e"}[p.mode]
    assert blk.LAUNCHES["K3"] == blk.LAUNCHES["K3p"] == 1
    assert blk.LAUNCHES[scan] == (1 if scan != "KS" else G)
    payloads = []
    for b in range(G):
        one = blk.encode_passes(p, inp[b], ns[b])
        for got, want in zip((states[b], packed[b], words[b]), one[:3]):
            assert torch.equal(got, want)
        payloads.append(blk._pack_payload(states[b], packed[b], words[b]))
    words_n = [blk._unpack_payload(pl, p)[0] for pl in payloads]
    assert max(words_n) - min(words_n) > 1000
    st = torch.stack([torch.from_numpy(blk._unpack_payload(pl, p)[1].astype(np.int64))
                      for pl in payloads]).to(cuda_device)
    streams = torch.zeros((G, p.stream_pad), dtype=torch.int32)
    for b, pl in enumerate(payloads):
        nw, _, stream = blk._unpack_payload(pl, p)
        streams[b, :nw] = torch.from_numpy(stream[:nw].astype(np.int32))
    streams = streams.to(cuda_device)
    blk.reset_launch_counts()
    x, used, out = blk.decode_scan_blocks(p, st, streams, n)
    assert blk.LAUNCHES[{"R": "K1", "X": "K12d", "P": "K13d"}[p.mode]] == 1
    assert used.tolist() == words_n
    assert (x == blk.RANS_L).all()
    for b in range(G):
        assert torch.equal(out[b].reshape(-1)[: ns[b]], inp[b].reshape(-1)[: ns[b]])
        assert blk.decode_block(payloads[b], ns[b], p, "cuda").tobytes() == \
            out[b].reshape(-1)[: ns[b]].cpu().numpy().tobytes()
