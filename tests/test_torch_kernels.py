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
                                 "KSx", "K13e", "K13d", "SORT"}
    assert set(blk._EVENTS) == set(blk.LAUNCHES)
    names = {p.name for p in build._sources()}
    assert {"search.cu", "decode.cu", "model.cu", "rans.cu", "sortfind.cu",
            "rank.cu", "parse.cu", "f2find.cu", "f2tok.cu", "f2enc.cu",
            "f2dec.cu", "xrep.cu", "sortlib.cuh", "f2scan.cuh", "ppm_r.cuh"} <= names
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
    # one radix sort for both finders: its kernels live in sortlib.cuh
    # alone, neither finder has a copy, and one entry point launches it
    srcs = {p.name: p.read_text() for p in build._sources()}
    for name, src in srcs.items():
        if name != "sortlib.cuh":
            assert not re.search(r"void[^(]*\brs_(hist|plan|pass|finish)\(", src), name
    for name in ("sortfind.cu", "f2find.cu"):
        assert "__match_any_sync" not in srcs[name]
    assert [n for n, src in srcs.items() if "radix_sort_pairs(" in src] == [
        "sortfind.cu", "sortlib.cuh"]
    assert "radix_sort_pairs(" in srcs["sortfind.cu"].split(
        'extern "C" int cpx_radix_sort_launch')[1]
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
    card (1 MiB and 8 MiB, flexible and -f0, the -F ELF corpus, and S=2048
    as a cluster of two CTAs) to its corpus' SHA-256."""
    m = GOLDEN_META[name]
    blk.reset_launch_counts()
    out = io.BytesIO()
    con.decode_stream(io.BytesIO((GOLDEN / name).read_bytes()), out, "cuda")
    assert blk.LAUNCHES["K1"] >= 1
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
    n_words, states, stream = blk._unpack_payload(blk._pack_payload(*got), p)
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
    memory budget, so KS (or K5) and K1 use the global scratch array."""
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
    """S=2048, D=64: each CTA's [1024, D+1] position rows (333 KB with KS's
    scores) are over the shared memory budget, so the cluster's KS (or K5)
    and K1 use the global scratch array, each CTA its own lanes' rows."""
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
    stream[: words.numel()] = words.flip(0)
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
    stream[: words.numel()] = words.flip(0)
    xk, uk, plk = tfast.decode_scan(p, freq, states, stream, n_tok)
    xp, up, plp = tfast.decode_scan_plain(p, freq, states, stream, n_tok)
    assert uk == up == words.numel()
    assert torch.equal(xk, xp) and torch.equal(plk, plp[:n_tok])


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
    n_words, states, stream = blk._unpack_payload(blk._pack_payload(*want), p)
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
    n_words, states, stream = blk._unpack_payload(blk._pack_payload(*want), p)
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
    the near-match cache; also with the row copies in global scratch."""
    p = blk.BlockParams(**{**X_WIDE, "rolz_bits": 10, "rolz_depth": 16, **kw})
    n = p.capacity - 100
    inp = torch.from_numpy(
        _fast_inputs(name, p, n).reshape(p.lanes, p.steps)).to(cuda_device)
    tk, tp = blk._init_xsearch(p, cuda_device), blk._init_xsearch(p, cuda_device)
    want = blk.search_scan_plain(p, inp, n, tp)
    assert torch.equal(blk.search_scan(p, inp, n, tk), want)
    assert all(torch.equal(a, b) for a, b in zip(tk, tp))


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
    counted under the probe's name."""
    from comprox_tpu_torch.benchmarks import probes

    for case in probes.PROBES[key](cuda_device, probes.S, seed=3):
        before = probes.LAUNCHES[case.probe]
        got = case.kernel()
        assert probes.LAUNCHES[case.probe] > before, case.label
        want = case.plain()
        assert got.dtype == want.dtype and torch.equal(got, want), case.label


@pytest.mark.cuda
def test_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    from comprox_tpu_torch.benchmarks import probes

    idx = torch.zeros(512, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 64"):
        probes.probe_kernel_onehot(torch.zeros((100, 384), device=cuda_device), idx)
    with pytest.raises(ValueError, match="48 KB"):
        probes.probe_dma_depth(torch.zeros((64, 1024), dtype=torch.int32,
                                           device=cuda_device), idx, 32)
    with pytest.raises(ValueError, match="int32"):
        probes.probe_vmem_gather(torch.zeros((64, 8), device=cuda_device), idx)


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
