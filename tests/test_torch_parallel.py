"""Block batching (``-g``) of the port against the JAX package's.

The port's ``parallel/mesh.py`` list APIs, the container's group arms and
the CLI's ``-g`` write and read the JAX package's bytes on the CPU (S=8,
T=32, as tests/test_parallel.py): five blocks, a group of four and a group
of one, each block of another n, the last 17 bytes.  The block axis of every
pass (``codec/block.py``) runs its plain loop here: it must give each block
what the one-block path gives it alone.  The committed ``-g4`` goldens are
checked by their metadata and digests; the card decodes them (chip_smoke).
"""

import ctypes
import hashlib
import io
import json
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from comprox_tpu.codec import block as jblk
from comprox_tpu.codec import container as jcon
from comprox_tpu.parallel import mesh as jmesh
from comprox_tpu_torch.cli import main as cli
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec import container as con
from comprox_tpu_torch.parallel import mesh as pmesh
from comprox_tpu_torch.utils import build

from test_block import corpus

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BASE = dict(lanes=8, steps=32, mode="R", min_len=5, window=32, o3_bits=12,
            rolz_bits=10, rolz_depth=16)
# the scan finders bind at import and JAX's scans are jitted on the block
# parameters alone: their cases take a geometry no sort-finder case traces
CASES = {
    "R": ({}, None),
    "R-f0": ({"flexible": False}, None),
    "X": ({"mode": "X", "min_len": 6}, None),
    "X-scan": ({"mode": "X", "min_len": 6, "steps": 40}, ("X_FINDER", "scan")),
    "P": ({"mode": "P", "min_len": 4}, None),
}


def params(case, monkeypatch=None):
    kw, knob = CASES[case]
    if knob is not None:
        monkeypatch.setattr(jblk, "_" + knob[0], knob[1])
        monkeypatch.setitem(blk._ENV, "CPX_" + knob[0], knob[1])
    kw = dict(BASE, **kw)
    return jblk.BlockParams(**kw), blk.BlockParams(**kw)


def five_blocks(cap, seed=3):
    """A group of four blocks of different n, then one of 17 bytes."""
    data = corpus("text", 5 * cap, seed=seed)
    sizes = [cap, cap - 7, cap - 40, cap - 3, 17]
    return [data[i * cap : i * cap + n] for i, n in enumerate(sizes)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_blocks_list_and_decode_blocks_match_jax(case, monkeypatch):
    jp, pp = params(case, monkeypatch)
    blocks = five_blocks(jp.capacity)
    want = jmesh.encode_blocks_list(blocks, jp, group=4)
    got = pmesh.encode_blocks_list(blocks, pp, group=4, device="cpu")
    assert got == want
    assert got == [blk.encode_block(b, pp, "cpu") for b in blocks]
    ns = [b.size for b in blocks]
    out = pmesh.decode_blocks(got, ns, pp, group=4, device="cpu")
    np.testing.assert_array_equal(out, jmesh.decode_blocks(want, ns, jp, group=4))
    np.testing.assert_array_equal(out, np.concatenate(blocks))


def _payloads():
    jp, pp = params("R")
    blocks = five_blocks(jp.capacity)[:3]
    return jp, pp, blocks, pmesh.encode_blocks_list(blocks, pp, group=4, device="cpu")


@pytest.mark.parametrize("fault", ["stream_pad", "drain"])
def test_decode_blocks_errors_match_jax(fault):
    """A stream over ``stream_pad`` words and a block whose states do not
    drain raise JAX's errors."""
    jp, pp, blocks, payloads = _payloads()
    bad = bytearray(payloads[1])
    if fault == "stream_pad":
        bad[:4] = np.array([pp.stream_pad + 1], "<u4").tobytes()
        match = "corrupt block: stream exceeds geometry bound"
    else:
        bad[4 + 4 * pp.lanes + 3] ^= 0x5A  # a stream word
        match = "corrupt block 1"
    payloads[1] = bytes(bad)
    ns = [b.size for b in blocks]
    with pytest.raises(ValueError, match=match):
        jmesh.decode_blocks(payloads, ns, jp, group=4)
    with pytest.raises(ValueError, match=match):
        pmesh.decode_blocks(payloads, ns, pp, group=4, device="cpu")


def test_mesh_is_refused():
    """``mesh=`` is ported (``tests/test_torch_mesh.py`` holds it to JAX):
    a mesh of two CPU entries gives the group's payloads and bytes; only a
    mesh that cannot exist is refused: a CUDA mesh without a card, an empty
    one, a device type the port does not run on."""
    _, pp, blocks, payloads = _payloads()
    mesh = pmesh.make_mesh(devices=["cpu", "cpu"])
    assert pmesh.encode_blocks_list(blocks, pp, mesh=mesh) == payloads
    ns = [b.size for b in blocks]
    np.testing.assert_array_equal(pmesh.decode_blocks(payloads, ns, pp, mesh=mesh),
                                  np.concatenate(blocks))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.make_mesh(devices=["cuda:0"])
    with pytest.raises(ValueError, match="at least one device"):
        pmesh.make_mesh(devices=[])
    with pytest.raises(ValueError, match="unsupported device"):
        pmesh.make_mesh(devices=["meta"])


CODECS = {"R": dict(BASE), "X": dict(BASE, mode="X", min_len=6),
          "P": dict(BASE, mode="P", min_len=4),
          "F": dict(BASE, mode="F", min_len=6, steps=64)}


def cps(codec):
    kw = CODECS[codec]
    return (jcon.ContainerParams(codec=codec.encode(), block=jblk.BlockParams(**kw)),
            con.ContainerParams(codec=codec.encode(), block=blk.BlockParams(**kw)))


def stream_input(cap, filters):
    """Five blocks and 17 bytes of text; with ``filters`` an x86 span in
    the second block (E8 calls the filter rewrites)."""
    data = bytearray(corpus("text", 5 * cap + 17, seed=9).tobytes())
    if filters:
        rng = np.random.default_rng(9)
        span = bytearray(rng.integers(0, 256, 160, dtype=np.uint8).tobytes())
        span[:4] = b"\x7fELF"
        span[18:20] = (62).to_bytes(2, "little")
        for i in range(64, len(span) - 5, 23):
            span[i] = 0xE8
        data[cap + 10 : cap + 170] = span
    return np.frombuffer(bytes(data), np.uint8)


@pytest.mark.parametrize("filters", [False, True], ids=["dict", "filters"])
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_encode_stream_group_matches_jax(codec, filters):
    """``group=4`` archives, with the dictionary (and the content filters),
    equal JAX's and the sequential path's, and decode under ``group=4``."""
    jcp, pcp = cps(codec)
    data = stream_input(jcp.block.capacity, filters)
    want, got, seq = io.BytesIO(), io.BytesIO(), io.BytesIO()
    jcon.encode_stream(data, want, jcp, filters=filters, group=4)
    con.encode_stream(data, got, pcp, "cpu", filters=filters, group=4)
    con.encode_stream(data, seq, pcp, "cpu", filters=filters)
    assert got.getvalue() == want.getvalue() == seq.getvalue()
    out = io.BytesIO()
    con.decode_stream(io.BytesIO(want.getvalue()), out, "cpu", group=4)
    assert out.getvalue() == data.tobytes()


def test_decode_stream_group_of_a_chained_archive_goes_one_block_at_a_time():
    jcp, pcp = cps("R")
    data = stream_input(jcp.block.capacity, False)
    arc = io.BytesIO()
    jcon.encode_stream(data, arc, jcp, chain=True)
    out = io.BytesIO()
    assert con.decode_stream(io.BytesIO(arc.getvalue()), out, "cpu", group=4) == data.size
    assert out.getvalue() == data.tobytes()


def test_chain_with_group_is_refused_as_jax_refuses_it():
    jcp, pcp = cps("R")
    data = stream_input(jcp.block.capacity, False)
    with pytest.raises(ValueError) as want:
        jcon.encode_stream(data, io.BytesIO(), jcp, chain=True, group=2)
    with pytest.raises(ValueError) as got:
        con.encode_stream(data, io.BytesIO(), pcp, "cpu", chain=True, group=2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("where", ["block 0", "block 2", "block 4"])
def test_corrupt_payload_under_group_raises_like_jax(where):
    """A payload whose stream is damaged (its CRC made good) fails in both
    packages' group decode with the same exception and message."""
    jcp, pcp = cps("R")
    data = stream_input(jcp.block.capacity, False)
    buf = io.BytesIO()
    jcon.encode_stream(data, buf, jcp, dictionary=False, group=4)
    arc = bytearray(buf.getvalue())
    off = jcon.HEADER_LEN
    for _ in range(int(where[-1])):  # skip to the block's header
        off += jcon.BLKHDR_LEN + int(np.frombuffer(arc[off + 4 : off + 8], "<u4")[0])
    raw_n, blen, bflags, _ = jcon.struct.unpack(jcon.BLKHDR, bytes(arc[off : off + jcon.BLKHDR_LEN]))
    body = off + jcon.BLKHDR_LEN
    arc[body + 4 + 4 * jcp.block.lanes + 1] ^= 0x3C
    crc = jcon.zlib.crc32(bytes(arc[body : body + blen])) & 0xFFFFFFFF
    arc[off : off + jcon.BLKHDR_LEN] = jcon.struct.pack(jcon.BLKHDR, raw_n, blen, bflags, crc)
    errors = []
    for decode in (lambda f, o: jcon.decode_stream(f, o, group=4),
                   lambda f, o: con.decode_stream(f, o, "cpu", group=4)):
        with pytest.raises(Exception) as e:
            decode(io.BytesIO(bytes(arc)), io.BytesIO())
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]
    assert errors[0][1].startswith("corrupt block")


def test_group_decode_error_ends_the_prefetch():
    """An error in the caller's loop (here a wrong payload CRC in block 4's
    header, while the worker decodes its group) ends the worker before
    decode_stream raises."""
    _, pcp = cps("R")
    data = stream_input(pcp.block.capacity, False)
    buf = io.BytesIO()
    con.encode_stream(data, buf, pcp, "cpu", dictionary=False)
    arc = bytearray(buf.getvalue())
    off = con.HEADER_LEN
    for _ in range(4):
        off += con.BLKHDR_LEN + int(np.frombuffer(arc[off + 4 : off + 8], "<u4")[0])
    arc[off + 9] ^= 0x3C  # the CRC field (BLKHDR: raw_n, len, flags, CRC)
    before = set(threading.enumerate())
    with pytest.raises(ValueError, match="block payload CRC mismatch"):
        con.decode_stream(io.BytesIO(bytes(arc)), io.BytesIO(), "cpu", group=4)
    assert [t for t in threading.enumerate() if t not in before] == []


# each arm of the block axis in its plain loop (the CPU's) against the
# one-block path on each block alone
AXIS = {
    "R": {}, "R-f0": {"flexible": False}, "R-scan": {"flexible": True},
    "X": {"mode": "X", "min_len": 6}, "X-f0": {"mode": "X", "min_len": 6, "flexible": False},
    "X-scan": {"mode": "X", "min_len": 6}, "P": {"mode": "P", "min_len": 4},
}


@pytest.mark.parametrize("case", sorted(AXIS))
def test_block_axis_plain_loop_equals_the_one_block_path(case, monkeypatch):
    if case.endswith("-scan"):
        monkeypatch.setitem(blk._ENV, "CPX_%s_FINDER" % case[0], "scan")
    p = blk.BlockParams(**dict(BASE, **AXIS[case]))
    blocks = five_blocks(p.capacity, seed=5)[1:]
    buf = np.zeros((len(blocks), p.lanes, p.steps), np.uint8)
    for i, b in enumerate(blocks):
        buf[i].reshape(-1)[: b.size] = b
    inp = torch.from_numpy(buf)
    n = torch.tensor([b.size for b in blocks], dtype=torch.int32)
    axis = blk.encode_passes_blocks(p, inp, n)  # every wrapper's plain loop
    for b, x in enumerate(blocks):
        one = blk.encode_passes(p, inp[b], x.size)  # the one-block path
        for a, o in zip(axis, one[:3]):
            assert torch.equal(a[b], o)
        assert blk._pack_payload(*(t[b] for t in axis)) == blk.encode_block(x, p, "cpu")
    states = torch.stack([t.to(torch.int64) for t in axis[0]])
    streams = torch.zeros((len(blocks), p.stream_pad), dtype=torch.int32)
    for b in range(len(blocks)):
        nw, _, stream = blk._unpack_payload(blk._pack_payload(*(t[b] for t in axis)), p)
        streams[b, :nw] = torch.from_numpy(stream[:nw].astype(np.int32))
    x1, used1, out1 = blk.decode_scan_blocks(p, states, streams, n)
    for b, x in enumerate(blocks):
        fresh = (blk.init_tables_blocks(p, "cpu"),
                 blk._init_rolz(p, "cpu") if p.mode == "R" else None,
                 blk._init_lzp(p, "cpu") if p.mode == "P" else None)
        x2, used2, out2 = blk.decode_scan(p, states[b], streams[b], x.size, *fresh)
        assert torch.equal(x1[b], x2) and int(used1[b]) == int(used2)
        assert torch.equal(out1[b], out2)
    assert torch.equal(out1, inp)
    assert (x1 == blk.RANS_L).all()


def test_block_axis_tables_evolve_per_block():
    """The tables of a batched scan end as each block's scan alone leaves
    them (the plain loop writes through each block's view)."""
    p = blk.BlockParams(**BASE)
    blocks = five_blocks(p.capacity, seed=7)[2:]
    buf = np.zeros((len(blocks), p.lanes, p.steps), np.uint8)
    for i, b in enumerate(blocks):
        buf[i].reshape(-1)[: b.size] = b
    inp = torch.from_numpy(buf)
    n = torch.tensor([b.size for b in blocks], dtype=torch.int32)
    dec = blk.parse_scan(p, n, blk.rank_scan(p, inp, n, blk.sort_candidates(p, inp, n),
                                             blk._init_rolz(p, "cpu", len(blocks))))
    tables = blk.init_tables_blocks(p, "cpu", len(blocks))
    ev = blk.model_scan(p, inp, n, dec, tables)
    for b, x in enumerate(blocks):
        alone = blk.init_tables_blocks(p, "cpu")
        assert torch.equal(ev[b], blk.model_scan(p, inp[b], x.size, dec[b], alone))
        for k in alone:
            assert torch.equal(tables[k][b], alone[k]), k


def test_entry_point_int_params_are_c_int():
    """Every C parameter declared int is a ctypes int in the signatures
    (the block count G among them), every other one a pointer."""
    src = "".join(p.read_text() for p in build.CSRC.glob("*.cu"))
    for name, argtypes in build._SIGNATURES.items():
        params_ = re.search(rf'extern "C" int {name}\((.*?)\)', src, re.S).group(1)
        for param, t in zip((x.strip() for x in params_.split(",")), argtypes):
            is_int = re.fullmatch(r"(const )?int \w+", param) is not None
            assert is_int == (t is ctypes.c_int), (name, param)


# --------------------------------------------------------------------------
# the -g4 goldens and the CLI
# --------------------------------------------------------------------------

G4 = {"crz_g4_flex_8MiB_S512.cpx": "R", "crx_g4_flex_8MiB_S512.cpx": "X",
      "crp_g4_8MiB_S512.cpx": "P", "crf_g4_flex_8MiB_S512.cpx": "F"}


@pytest.mark.parametrize("name", sorted(G4))
def test_group_golden_metadata(name):
    """The committed ``-g4 -b2`` JAX archives: four blocks of T=4096 of the
    8 MiB corpus, their digests as recorded."""
    meta = json.loads((ROOT / "tests/data/torch_golden.json").read_text())
    m = meta[name]
    assert m["argv"] == f"{name[:3]} e -g4 -b2 -l512"
    assert m["input_sha256"] == meta["crz_f0_8MiB_S512.cpx"]["input_sha256"]
    arc = (ROOT / "tests/data" / name).read_bytes()
    assert hashlib.sha256(arc).hexdigest() == m["archive_sha256"]
    assert len(arc) == m["archive_bytes"]
    cp, flags = con.read_header(io.BytesIO(arc))
    assert (cp.block.mode, cp.block.lanes, cp.block.steps) == (G4[name], 512, 4096)
    assert not flags & con.F_CHAIN


@pytest.mark.parametrize("codec", ["crz", "crx", "crp", "crf"])
def test_cli_group_switch(codec, tmp_path):
    """``-g3`` parses as JAX's ``-g`` does and its archive is ``-g1``'s."""
    data = corpus("text", 1000, seed=21)
    (tmp_path / "a").write_bytes(data.tobytes())
    assert cli.parse_args([codec, "e", "a", "b", "-g3"])[4]["group"] == 3
    assert cli.parse_args([codec, "e", "a", "b", "-g"])[4]["group"] == 1
    assert cli.parse_args([codec, "e", "a", "b", "-g0"])[4]["group"] == 1
    for g in ("-g3", "-g1"):
        cli.run(codec, ["e", str(tmp_path / "a"), str(tmp_path / g), "-b0.0002",
                        "-l8", "-q", g], device="cpu")
    assert (tmp_path / "-g3").read_bytes() == (tmp_path / "-g1").read_bytes()
    cli.run(codec, ["d", str(tmp_path / "-g3"), str(tmp_path / "c"), "-q", "-g3"],
            device="cpu")
    assert (tmp_path / "c").read_bytes() == data.tobytes()


def test_chip_smoke_names_every_batched_arm():
    """chip_smoke's kernels line has a ``(blocks)`` row for each batched arm,
    replacing the vmap line of mesh.py beside the kernel's own, and its
    build report reads each step scan's arm from the mangled names."""
    import chip_smoke

    rows = {name: repl for name, _, repl in chip_smoke.KERNELS if name.endswith(" (blocks)")}
    assert set(rows) == {f"{k} (blocks)" for k in (
        "K5", "K6", "K2", "K3", "K3p", "K3b", "K1", "K11", "K6 (X)", "K12e",
        "K3 (5 slots)", "K3p (5 slots)", "K3b (5 slots)", "K12d", "K13e", "K13d")}
    for name, repl in rows.items():
        side = "73" if name.split()[0] in ("K1", "K12d", "K13d") else "62"
        assert repl.startswith(f"comprox_tpu/parallel/mesh.py:{side}; comprox_tpu/"), name
    ns = "_ZN41_GLOBAL__N__8c840077_9_decode_cu_7dad24cb"
    assert chip_smoke._arm_name(ns + "11k12d_kernelILi512ELi1ELb0ELb1EEEv3CfgPKi") == \
        "k12d_kernel<MAXT=512, MODE=X, CL=0, BLK=1>"
    assert chip_smoke._arm_name(ns + "9k1_kernelILi512ELb0EEEv3Cfg") == "k1_kernel<MAXT=512, CL=0>"
    assert chip_smoke._arm_name(ns + "10k11_kernelE3CfgPKh") == "k11_kernel"
    assert chip_smoke._arm_name(ns + "9k13c_keysE3Cfg") == "k13c_keys"
    assert chip_smoke._arm_name(ns + "7k4_keysE3Cfg") is None
    rans = "_ZN39_GLOBAL__N__1f2b3c4d_7_rans_cu_5e6f7a8b"
    assert chip_smoke._arm_name(rans + "9k3_kernelILi5EEEviiPKiPxPhPi") == "k3_kernel<NS=5>"
    assert chip_smoke._arm_name(rans + "8k3b_passEiiiPKhPKiPyPiPs") == "k3b_pass"
