"""The port's crz, crf and crx containers and CLI against the JAX package:
each codec as a whole.  Archives must be byte-identical and decode across
packages."""

import io
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from comprox_tpu.cli import main as jcli
from comprox_tpu.codec import block as jblk
from comprox_tpu.codec import container as jcon
from comprox_tpu.parallel import mesh as jmesh
from comprox_tpu_torch.cli import main as cli
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec import container as con

from test_block import corpus

# the plain versions run many tiny ops: more intra-op threads would only
# contend with the other test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(lanes=8, steps=64, mode="R", min_len=5, window=32, o3_bits=14,
             rolz_bits=10, rolz_depth=16, flexible=False)


def cps():
    return (jcon.ContainerParams(codec=b"R", block=jblk.BlockParams(**SMALL)),
            con.ContainerParams(codec=b"R", block=blk.BlockParams(**SMALL)))


def elf_blob(rng, n):
    """An x86-64 ELF header followed by call/jmp-rich bytes (a filter span)."""
    b = bytearray(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    b[:4] = b"\x7fELF"
    b[18:20] = (62).to_bytes(2, "little")
    for i in range(64, n - 5, 23):
        b[i] = 0xE8
    return bytes(b)


def sample(kind):
    rng = np.random.default_rng(11)
    text = corpus("text", 1400, seed=11).tobytes()
    if kind == "stored":  # a random middle block falls back to stored
        raw = text[:512] + rng.integers(0, 256, 512, dtype=np.uint8).tobytes() + text[:300]
    elif kind == "elf":
        raw = text[:700] + elf_blob(rng, 500) + text[:200]
    else:
        raw = text
    return np.frombuffer(raw, np.uint8)


def jax_encode(data, **kw):
    cp, _ = cps()
    buf = io.BytesIO()
    jcon.encode_stream(data, buf, cp, **kw)
    return buf.getvalue()


def port_encode(data, **kw):
    _, cp = cps()
    buf = io.BytesIO()
    con.encode_stream(data, buf, cp, "cpu", **kw)
    return buf.getvalue()


def cross_decode(arc, data):
    out = io.BytesIO()
    con.decode_stream(io.BytesIO(arc), out, "cpu")
    assert out.getvalue() == data.tobytes()
    out = io.BytesIO()
    jcon.decode_stream(io.BytesIO(arc), out)
    assert out.getvalue() == data.tobytes()


@pytest.mark.parametrize(
    "kind,kw",
    [
        ("text", {}),
        ("text", {"dictionary": False}),
        ("elf", {"filters": True}),
        ("elf", {"filters": False}),
        ("text", {"precomp_only": True}),
        ("stored", {}),
    ],
)
def test_archive_equals_jax(kind, kw):
    data = sample(kind)
    arc = port_encode(data, **kw)
    assert arc == jax_encode(data, **kw)
    cross_decode(arc, data)
    if kind == "stored":
        assert arc.count(data[512:1024].tobytes()) == 1  # stored verbatim


def test_filter_span_applied():
    data = sample("elf")
    blob = data[700:1200]
    from comprox_tpu_torch.ops import filters as flt

    assert flt.detect_spans(blob), "the sample must exercise the x86 filter"
    assert port_encode(data, filters=True) != port_encode(data, filters=False)


def test_make_params_matches_jax():
    for opts in (
        {"lanes": 512, "block_mb": 8, "flexible": False},
        {"lanes": 512, "block_mb": 1, "flexible": False},
        {"lanes": 256, "block_mb": 16, "flexible": True, "depth": 70},
        {"lanes": 8, "block_mb": 0.0005, "flexible": False, "window": 200},
    ):
        mine = cli.make_params("crz", opts)
        ref = jcli.make_params("crz", dict(opts))
        assert mine.codec == ref.codec
        assert asdict(mine.block) == asdict(ref.block)


def test_cli_subprocess_imports_no_jax(tmp_path):
    """crz e/d through the port's library API in a fresh interpreter: the
    port never imports JAX; the archive decodes under the JAX package."""
    src = tmp_path / "in.bin"
    sample("text").tofile(src)
    script = textwrap.dedent(f"""
        import sys
        import comprox_tpu_torch.cli.main as m
        a = [{str(src)!r}, {str(tmp_path / 'a.crz')!r}]
        m.run("crz", ["e", *a, "-f0", "-b0.0005", "-l8", "-q"], device="cpu")
        m.run("crz", ["d", a[1], {str(tmp_path / 'out.bin')!r}, "-q"],
              device="cpu")
        print("jax" in sys.modules or "comprox_tpu" in sys.modules)
    """)
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                       env=dict(os.environ, OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"
    assert (tmp_path / "out.bin").read_bytes() == src.read_bytes()
    out = io.BytesIO()
    jcon.decode_stream(io.BytesIO((tmp_path / "a.crz").read_bytes()), out)
    assert out.getvalue() == src.read_bytes()


def test_chained_archives_and_other_codecs_raise():
    """Chained headers of the adaptive codecs are read (one with no block
    decodes to nothing); a chained crf header is refused: crf has no
    adaptive models to carry, and no encoder writes one."""
    for codec, flags, exc in (
        (b"R", jcon.F_CHAIN, None),
        (b"R", jcon.F_CHAIN | jcon.F_CHAIN_MATCH, None),
        (b"X", jcon.F_CHAIN, None),
        (b"P", jcon.F_CHAIN, None),
        (b"F", jcon.F_CHAIN, ValueError),
    ):
        f = io.BytesIO()
        mode = {b"R": "R", b"X": "X", b"F": "F"}.get(codec, "P")
        jcon.write_header(
            f, jcon.ContainerParams(codec=codec, block=jblk.BlockParams(**dict(
                SMALL, mode=mode, flexible=True,
                chain_match=bool(flags & jcon.F_CHAIN_MATCH)))), flags=flags)
        f.write(b"\0" * 13)
        if exc is None:
            assert con.decode_stream(io.BytesIO(f.getvalue()), io.BytesIO(), "cpu") == 0
            continue
        with pytest.raises(exc, match="adaptive-model codec"):
            con.decode_stream(io.BytesIO(f.getvalue()), io.BytesIO(), "cpu")
    # codecs X and P are ported: an unchained header with no block decodes
    # to nothing
    for codec in (b"X", b"P"):
        f = io.BytesIO()
        jcon.write_header(f, jcon.ContainerParams(
            codec=codec, block=jblk.BlockParams(**dict(SMALL, mode=codec.decode()))))
        f.write(b"\0" * 13)
        assert con.decode_stream(io.BytesIO(f.getvalue()), io.BytesIO(), "cpu") == 0


# Every switch is ported: -c and -C (chain modes), -g (block batching) and
# -j (blocks over devices; on the CPU a mesh of the one device): an accepted
# command line codes a short input at a small geometry and JAX decodes the
# archive (under -g and -j it equals JAX's archive of the same command line,
# -j's over JAX's whole virtual mesh), a refused one (chain mode with -g or
# -j, -C outside crz, -c/-C in crf) raises the JAX package's error.
_CHAIN_OK = "chained"
_GROUP_OK = "grouped"
_JOBS_OK = "over devices"


@pytest.mark.parametrize(
    "argv,expect",
    [
        (["crz", "e", "a", "b", "-f0", "-c"], _CHAIN_OK),
        (["crz", "e", "a", "b", "-f0", "-C"], ValueError),
        (["crz", "e", "a", "b", "-f0", "-j"], _JOBS_OK),
        (["crz", "e", "a", "b", "-f0", "-g2"], _GROUP_OK),
        (["crz", "e", "a", "b", "-c"], _CHAIN_OK),
        (["crx", "e", "a", "b", "-c"], _CHAIN_OK),
        (["crp", "e", "a", "b", "-f0", "-c"], _CHAIN_OK),
        (["crf", "e", "a", "b", "-c"], ValueError),
        (["crf", "e", "a", "b", "-C"], ValueError),
        (["crf", "e", "a", "b", "-g2"], _GROUP_OK),
        (["crf", "e", "a", "b", "-j"], _JOBS_OK),
        (["crx", "e", "a", "b", "-C"], ValueError),
        (["crx", "e", "a", "b", "-j"], _JOBS_OK),
        (["crx", "e", "a", "b", "-g2"], _GROUP_OK),
        (["crp", "e", "a", "b", "-g2"], _GROUP_OK),
        (["crz", "e", "a", "b", "-g2", "-c"], ValueError),
        (["crz", "e", "a", "b", "-c", "-j"], ValueError),
    ],
)
def test_cli_unported_switches_raise(argv, expect, tmp_path):
    data = corpus("text", 300, seed=4)
    (tmp_path / "a").write_bytes(data.tobytes())
    argv = [str(tmp_path / a) if a in ("a", "b") else a for a in argv]
    if expect is NotImplementedError:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cli.run(argv[0], argv[1:], device="cpu")
        return
    if expect is ValueError:
        with pytest.raises(ValueError, match="chain"):
            cli.run(argv[0], argv[1:], device="cpu")
        return
    cli.run(argv[0], argv[1:] + ["-b0.0001", "-l8", "-q"], device="cpu")
    arc = (tmp_path / "b").read_bytes()
    if expect == _JOBS_OK:
        assert cli.parse_args(argv)[4]["jobs"] == jcli.parse_args(argv)[4]["jobs"] == -1
    if expect in (_GROUP_OK, _JOBS_OK):
        _, _, _, _, opts = jcli.parse_args(argv + ["-b0.0001", "-l8", "-q"])
        want = io.BytesIO()
        jcon.encode_stream(data, want, jcli.make_params(argv[0], opts),
                           group=opts["group"],
                           mesh=jmesh.make_mesh() if opts["jobs"] else None)
        assert arc == want.getvalue()
    else:
        assert con.read_header(io.BytesIO(arc))[1] & con.F_CHAIN
    out = io.BytesIO()
    jcon.decode_stream(io.BytesIO(arc), out)
    assert out.getvalue() == data.tobytes()


def test_cli_needs_a_card_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run("crz", ["d", str(tmp_path / "a"), str(tmp_path / "b")], "cuda")


# the chained goldens: crz -c, crz -C, crx -c, crp -c at -b2 on the 8 MiB
# corpus, and crz -C -b8 on the 8 MiB text and ELF corpora end to end
CHAINED = {"crz_chain_flex_8MiB_S512.cpx", "crz_chainm_flex_8MiB_S512.cpx",
           "crx_chain_flex_8MiB_S512.cpx", "crp_chain_8MiB_S512.cpx",
           "crz_chainm_textelf_flex_16MiB_S512.cpx"}
# the unchained -g4 -b2 goldens (four blocks of the 8 MiB corpus), one a codec
GROUPED = {"crz_g4_flex_8MiB_S512.cpx", "crx_g4_flex_8MiB_S512.cpx",
           "crp_g4_8MiB_S512.cpx", "crf_g4_flex_8MiB_S512.cpx"}
# crf under CPX_F_FINDER=scan (mode X's finder and parse), the X finder sort
# (1 and 8 MiB) and scan (1 MiB)
F_SCAN = {"crf_scan_flex_1MiB_S512.cpx", "crf_scan_flex_8MiB_S512.cpx",
          "crf_xscan_flex_1MiB_S512.cpx"}


def test_golden_fixture_metadata():
    """The committed JAX archives carry the digests chip_smoke.py checks."""
    meta = json.loads((ROOT / "tests/data/torch_golden.json").read_text())
    assert set(meta) == {f"crz_{parse}_{mb}MiB_S512.cpx"
                         for parse in ("f0", "flex") for mb in (1, 8)} | {
        f"crf_flex_{mb}MiB_S512.cpx" for mb in (1, 8)} | {
        "crx_flex_1MiB_S512.cpx", "crx_f0_1MiB_S512.cpx", "crx_flex_8MiB_S512.cpx"} | {
        f"crp_{mb}MiB_S512.cpx" for mb in (1, 8)} | {
        n for n in meta if n.startswith("crx_scan_")} | {
        f"{c}_elfF_flex_{size}.cpx" for c in ("crx", "crz")
        for size in ("256KiB_S512", "8MiB_S256")} | {
        f"{c}_words_flex_32KiB_S2048.cpx" for c in ("crz", "crx", "crf")} | {
        "crp_words_32KiB_S2048.cpx"} | CHAINED | GROUPED | F_SCAN
    for name in F_SCAN:
        env = "CPX_F_FINDER=scan " + ("CPX_X_FINDER=scan " if "_xscan_" in name else "")
        assert meta[name]["argv"] == env + "crf e -b%s -l512" % name.split("_")[3][0]
    assert {"crx_scan_flex_1MiB_S512.cpx", "crx_scan_f0_1MiB_S512.cpx"} <= set(meta)
    assert meta["crx_scan_flex_1MiB_S512.cpx"]["argv"].startswith("CPX_X_FINDER=scan ")
    assert (meta["crx_f0_1MiB_S512.cpx"]["input_sha256"]
            == meta["crz_f0_1MiB_S512.cpx"]["input_sha256"])
    for mb in (1, 8):  # every archive of one size codes the same bytes
        for other in ("crz_flex", "crf_flex", "crx_flex", "crp", "crf_scan_flex"):
            assert (meta[f"{other}_{mb}MiB_S512.cpx"]["input_sha256"]
                    == meta[f"crz_f0_{mb}MiB_S512.cpx"]["input_sha256"])
    for name in CHAINED:  # the 8 MiB corpus in four blocks, or 16 MiB in two
        m = meta[name]
        assert m["argv"].endswith("-b8 -l512" if "_16MiB_" in name else "-b2 -l512")
        if "_8MiB_" in name:
            assert m["input_sha256"] == meta["crz_f0_8MiB_S512.cpx"]["input_sha256"]
    import hashlib

    for name, m in meta.items():
        arc = (ROOT / "tests/data" / name).read_bytes()
        assert hashlib.sha256(arc).hexdigest() == m["archive_sha256"]
        assert len(arc) == m["archive_bytes"]
        cp, flags = con.read_header(io.BytesIO(arc))
        assert cp.block.lanes == int(name.rsplit("_S", 1)[1][:-4])
        assert bool(flags & con.F_CHAIN) == (name in CHAINED)
        assert bool(flags & con.F_CHAIN_MATCH) == ("_chainm_" in name)
        assert cp.block.mode == {"crz": "R", "crf": "F", "crx": "X", "crp": "P"}[name[:3]]


FLEX = dict(SMALL, flexible=True)


def flex_cps(**kw):
    kw = dict(FLEX, **kw)
    return (jcon.ContainerParams(codec=b"R", block=jblk.BlockParams(**kw)),
            con.ContainerParams(codec=b"R", block=blk.BlockParams(**kw)))


@pytest.mark.parametrize(
    "kind,kw",
    [
        ("text", {}),
        ("text", {"dictionary": False}),
        ("elf", {"filters": True}),
        ("stored", {}),
    ],
)
def test_flexible_archive_equals_jax(kind, kw):
    """The whole archive of the default (flexible) parse, several blocks,
    dictionary and filter stages through the port's own copies."""
    data = sample(kind)
    cpj, cpt = flex_cps()
    ref, got = io.BytesIO(), io.BytesIO()
    jcon.encode_stream(data, ref, cpj, **kw)
    con.encode_stream(data, got, cpt, "cpu", **kw)
    assert got.getvalue() == ref.getvalue()
    cross_decode(got.getvalue(), data)


def test_flexible_cli_archive_equals_jax(tmp_path):
    """crz e without -f0 through both command lines: the same file; each
    package decodes it."""
    src = tmp_path / "in.bin"
    sample("text").tofile(src)
    args = ["-b0.0005", "-l8", "-q"]
    cli.run("crz", ["e", str(src), str(tmp_path / "port.crz"), *args], device="cpu")
    jcli.run("crz", ["e", str(src), str(tmp_path / "jax.crz"), *args])
    arc = (tmp_path / "port.crz").read_bytes()
    assert arc == (tmp_path / "jax.crz").read_bytes()
    cp, _ = con.read_header(io.BytesIO(arc))
    assert cp.block.lanes == 8 and cp.block.steps == 65
    cli.run("crz", ["d", str(tmp_path / "jax.crz"), str(tmp_path / "out.bin"), "-q"],
            device="cpu")
    assert (tmp_path / "out.bin").read_bytes() == src.read_bytes()
    cross_decode(arc, sample("text"))
    # -f0 still selects the greedy parse: another archive
    cli.run("crz", ["e", str(src), str(tmp_path / "f0.crz"), "-f0", *args], device="cpu")
    assert (tmp_path / "f0.crz").read_bytes() != arc


def test_host_stages_are_the_ports_own_copies():
    """The dictionary and filter modules the container uses are the port's,
    and give the JAX package's results on the same bytes."""
    from comprox_tpu.codec import dictionary as jdic
    from comprox_tpu.ops import filters as jflt
    from comprox_tpu_torch.codec import dictionary as dic
    from comprox_tpu_torch.ops import filters as flt

    assert con.dic is dic and con.flt is flt
    assert dic.__name__.startswith("comprox_tpu_torch.")
    data = np.frombuffer(corpus("text", 6000, seed=3).tobytes()
                         + b" Capital Words AND lower words " * 40, np.uint8)
    d, dj = dic.build_dictionary(data), jdic.build_dictionary(data)
    assert d is not None and dic.pack_dict(d) == jdic.pack_dict(dj)
    enc = dic.dict_encode(data, d)
    np.testing.assert_array_equal(enc, jdic.dict_encode(data, dj))
    np.testing.assert_array_equal(dic.dict_decode(enc, d), data)
    blob = dic.pack_dict(d)
    assert dic.blob_encode(blob) == jdic.blob_encode(blob)
    assert dic.blob_decode(dic.blob_encode(blob), len(blob)) == blob
    elf = np.frombuffer(elf_blob(np.random.default_rng(2), 4096), np.uint8)
    spans = flt.detect_spans(elf)
    assert spans and flt.pack_spans(spans) == jflt.pack_spans(jflt.detect_spans(elf))
    fwd = flt.apply_spans(elf, spans, encode=True)
    np.testing.assert_array_equal(fwd, jflt.apply_spans(elf, spans, encode=True))
    np.testing.assert_array_equal(flt.apply_spans(fwd, spans, encode=False), elf)


def test_native_and_python_host_paths_agree(tmp_path, monkeypatch):
    """The C loops (built into build/native/ from the port's csrc/native.c)
    and the Python paths give the same bytes: E8/E9 transform, dictionary
    count, substitution and expansion."""
    from comprox_tpu_torch.codec import dictionary as dic
    from comprox_tpu_torch.utils import native

    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C compiler: only the Python paths exist here")
    assert native.BUILD_DIR == ROOT / "build" / "native"
    assert list(native.BUILD_DIR.glob("libcpx_native_*.so"))
    rng = np.random.default_rng(5)
    elf = np.frombuffer(elf_blob(rng, 3000), np.uint8)
    for en_de in (0, 1):
        a, b = elf.copy(), elf.copy()
        native._e8e9_python(a, 0, a.size, en_de)
        lib.e8e9_transform(b.ctypes.data, b.size, 0, b.size, en_de)
        np.testing.assert_array_equal(a, b)
    base = corpus("text", 40000, seed=11).tobytes()
    extra = (b" The quick Brown fox THE the ThE " * 20
             + bytes(rng.integers(0, 256, 2000, dtype=np.uint8)))
    data = np.frombuffer(base + extra, np.uint8).copy()
    d = dic.build_dictionary(data, max_words2=4096)
    assert d is not None and len(d.words2) > 0
    for part in (data, data[:777], data[-3001:]):
        enc = dic.dict_encode(part, d)
        np.testing.assert_array_equal(enc, dic._dict_encode_py(part, d))
        np.testing.assert_array_equal(dic.dict_decode(enc, d), dic._dict_decode_py(enc, d))
        np.testing.assert_array_equal(dic.dict_decode(enc, d), part)
    # the count pass: with the library switched off the same dictionary
    monkeypatch.setattr(native, "get_lib", lambda: None)
    d_py = dic.build_dictionary(data, max_words2=4096)
    assert dic.pack_dict(d_py) == dic.pack_dict(d)


# ---- crf: the fast profile behind the same container

FAST = dict(lanes=8, steps=128, mode="F", min_len=6, window=64)


def fast_cps(**kw):
    kw = dict(FAST, **kw)
    return (jcon.ContainerParams(codec=b"F", block=jblk.BlockParams(**kw)),
            con.ContainerParams(codec=b"F", block=blk.BlockParams(**kw)))


@pytest.mark.parametrize(
    "kind,kw,block",
    [
        ("text", {}, {}),
        ("text", {"dictionary": False}, {}),
        ("elf", {"filters": True}, {}),
        ("text", {"precomp_only": True}, {}),
        ("text", {}, {"flexible": False}),
        ("stored", {}, {"steps": 64}),
    ],
)
def test_crf_archive_equals_jax(kind, kw, block):
    """The whole crf archive, several blocks: with and without dictionary,
    -F, -p, the greedy parse (-f0) and the stored-block fallback on random
    bytes; each package decodes it."""
    data = sample(kind)
    cpj, cpt = fast_cps(**block)
    ref, got = io.BytesIO(), io.BytesIO()
    jcon.encode_stream(data, ref, cpj, **kw)
    con.encode_stream(data, got, cpt, "cpu", **kw)
    arc = got.getvalue()
    assert arc == ref.getvalue()
    cross_decode(arc, data)
    cp, _ = con.read_header(io.BytesIO(arc))
    assert cp.codec == b"F" and cp.block.mode == "F"
    if kind == "stored":
        assert arc.count(data[512:1024].tobytes()) == 1  # stored verbatim


def test_crf_make_params_matches_jax():
    for opts in (
        {"lanes": 512, "block_mb": 8},
        {"lanes": 512, "block_mb": 1, "flexible": False},
        {"lanes": 256, "block_mb": 64, "depth": 70},  # capped at 16 MiB
        {"lanes": 8, "block_mb": 0.001, "window": 200},
    ):
        mine = cli.make_params("crf", opts)
        ref = jcli.make_params("crf", dict(opts))
        assert mine.codec == ref.codec == b"F"
        assert asdict(mine.block) == asdict(ref.block)
    bp = cli.make_params("crf", {"lanes": 512, "block_mb": 8}).block
    assert (bp.mode, bp.steps, bp.min_len, bp.window) == ("F", 16384, 6, 250)
    assert (bp.rolz_ctx_bytes, bp.rolz_dec) == (3, 1)
    assert cli.make_params("crf", {"lanes": 256, "block_mb": 64}).block.capacity == 1 << 24


def test_crf_cli_archive_equals_jax(tmp_path):
    """crf e / crf d through both command lines: the same file both ways,
    with and without -f0."""
    src = tmp_path / "in.bin"
    sample("text").tofile(src)
    for flags in ([], ["-f0"]):
        args = [*flags, "-b0.001", "-l8", "-q"]
        cli.run("crf", ["e", str(src), str(tmp_path / "port.crf"), *args], device="cpu")
        jcli.run("crf", ["e", str(src), str(tmp_path / "jax.crf"), *args])
        arc = (tmp_path / "port.crf").read_bytes()
        assert arc == (tmp_path / "jax.crf").read_bytes()
        cli.run("crf", ["d", str(tmp_path / "jax.crf"), str(tmp_path / "out.bin"), "-q"],
                device="cpu")
        assert (tmp_path / "out.bin").read_bytes() == src.read_bytes()
        cross_decode(arc, sample("text"))


def test_codec_and_mode_must_agree():
    with pytest.raises(ValueError, match="codes mode"):
        con.encode_stream(sample("text"), io.BytesIO(), con.ContainerParams(
            codec=b"F", block=blk.BlockParams(**SMALL)), "cpu")
    with pytest.raises(ValueError, match="codes mode"):
        con.encode_stream(sample("text"), io.BytesIO(), con.ContainerParams(
            codec=b"R", block=blk.BlockParams(**FAST)), "cpu")
    assert cli.make_params("crp", {"lanes": 8, "block_mb": 1}).codec == b"P"
    with pytest.raises(ValueError, match="unknown codec"):
        cli.make_params("crq", {"lanes": 8, "block_mb": 1})
    with pytest.raises(ValueError, match="codes mode"):
        con.encode_stream(sample("text"), io.BytesIO(), con.ContainerParams(
            codec=b"P", block=blk.BlockParams(**SMALL)), "cpu")
    with pytest.raises(ValueError, match="codes mode"):
        con.encode_stream(sample("text"), io.BytesIO(), con.ContainerParams(
            codec=b"X", block=blk.BlockParams(**SMALL)), "cpu")
    assert cli.make_params("crx", {"lanes": 8, "block_mb": 1}).codec == b"X"


def test_crf_golden_1mib_decodes_to_the_committed_corpus():
    """The committed JAX crf archive (S=512, T=2048) through the port's plain
    passes: the bytes the crz archives decode to."""
    import hashlib

    meta = json.loads((ROOT / "tests/data/torch_golden.json").read_text())
    m = meta["crf_flex_1MiB_S512.cpx"]
    out = io.BytesIO()
    con.decode_stream(
        io.BytesIO((ROOT / "tests/data/crf_flex_1MiB_S512.cpx").read_bytes()), out, "cpu")
    assert len(out.getvalue()) == m["input_bytes"]
    assert hashlib.sha256(out.getvalue()).hexdigest() == m["input_sha256"]


# --------------------------------------------------------------------------
# crx: the LZ77 codec (mode X)
# --------------------------------------------------------------------------

XMODE = dict(lanes=8, steps=64, mode="X", min_len=6, window=32, o3_bits=14,
             rolz_bits=10, rolz_depth=16)


def x_cps(**kw):
    p = dict(XMODE, **kw)
    return (jcon.ContainerParams(codec=b"X", block=jblk.BlockParams(**p)),
            con.ContainerParams(codec=b"X", block=blk.BlockParams(**p)))


@pytest.mark.parametrize("flexible", [True, False])
@pytest.mark.parametrize(
    "kind,kw",
    [
        ("text", {}),
        ("text", {"dictionary": False}),
        ("elf", {"filters": True}),
        ("text", {"precomp_only": True}),
        ("stored", {}),
    ],
)
def test_crx_archive_equals_jax(kind, kw, flexible):
    """Whole crx archives byte for byte (flexible and ``-f0``; dictionary,
    ``-F``, ``-p``, a stored block), decoded by both packages."""
    data = sample(kind)
    jcp, pcp = x_cps(flexible=flexible)
    ref, got = io.BytesIO(), io.BytesIO()
    jcon.encode_stream(data, ref, jcp, **kw)
    con.encode_stream(data, got, pcp, "cpu", **kw)
    assert got.getvalue() == ref.getvalue()
    cross_decode(got.getvalue(), data)
    if kind == "stored":
        assert got.getvalue().count(data[512:1024].tobytes()) == 1


def test_crx_make_params_matches_jax():
    for opts in (
        {"lanes": 512, "block_mb": 8, "flexible": True},
        {"lanes": 512, "block_mb": 1, "flexible": False},
        {"lanes": 256, "block_mb": 64, "flexible": True, "depth": 70},  # 16 MiB cap
        {"lanes": 8, "block_mb": 0.0005, "flexible": False, "window": 200},
    ):
        mine = cli.make_params("crx", opts)
        ref = jcli.make_params("crx", dict(opts))
        assert mine.codec == ref.codec == b"X"
        assert asdict(mine.block) == asdict(ref.block)
    assert cli.make_params("crx", {"lanes": 256, "block_mb": 64}).block.capacity == 1 << 24


def test_crx_cli_archive_equals_jax(tmp_path):
    src = tmp_path / "in.bin"
    sample("elf").tofile(src)
    for flags in ([], ["-f0"], ["-F"], ["-p"], ["-m70"]):
        args = [*flags, "-b0.0005", "-l8", "-q"]
        cli.run("crx", ["e", str(src), str(tmp_path / "port.crx"), *args], device="cpu")
        jcli.run("crx", ["e", str(src), str(tmp_path / "jax.crx"), *args])
        arc = (tmp_path / "port.crx").read_bytes()
        assert arc == (tmp_path / "jax.crx").read_bytes(), flags
        cli.run("crx", ["d", str(tmp_path / "jax.crx"), str(tmp_path / "out.bin"), "-q"],
                device="cpu")
        assert (tmp_path / "out.bin").read_bytes() == src.read_bytes()
        cross_decode(arc, sample("elf"))


@pytest.mark.parametrize("cut", [12, 20, 40, 200, -3])
def test_crx_truncated_archive_raises(cut):
    data = sample("text")
    _, pcp = x_cps()
    buf = io.BytesIO()
    con.encode_stream(data, buf, pcp, "cpu")
    with pytest.raises(ValueError, match="truncated|short"):
        con.decode_stream(io.BytesIO(buf.getvalue()[:cut]), io.BytesIO(), "cpu")


@pytest.mark.parametrize("where", ["header", "payload", "stream"])
def test_crx_corrupt_archive_raises(where):
    data = sample("text")
    _, pcp = x_cps()
    buf = io.BytesIO()
    con.encode_stream(data, buf, pcp, "cpu", dictionary=False)
    arc = bytearray(buf.getvalue())
    if where == "header":
        arc[10] ^= 1
        match = "header CRC"
    elif where == "payload":
        arc[con.HEADER_LEN + con.BLKHDR_LEN + 60] ^= 0x10
        match = "payload CRC"
    else:  # a flipped stream bit under a repaired CRC: the states do not drain
        import struct
        import zlib

        off = con.HEADER_LEN
        raw_n, blen, bflags, _ = struct.unpack(con.BLKHDR, arc[off:off + con.BLKHDR_LEN])
        body = off + con.BLKHDR_LEN
        arc[body + 4 + 4 * 8 + 10] ^= 0x10
        arc[off:body] = struct.pack(con.BLKHDR, raw_n, blen, bflags,
                                    zlib.crc32(bytes(arc[body:body + blen])) & 0xFFFFFFFF)
        match = "corrupt block"
    with pytest.raises(ValueError, match=match):
        con.decode_stream(io.BytesIO(bytes(arc)), io.BytesIO(), "cpu")


# ---- crp: the LZP codec behind the same container

PMODE = dict(lanes=8, steps=64, mode="P", min_len=4, window=32, o3_bits=14)


def p_cps(**kw):
    kw = dict(PMODE, **kw)
    return (jcon.ContainerParams(codec=b"P", block=jblk.BlockParams(**kw)),
            con.ContainerParams(codec=b"P", block=blk.BlockParams(**kw)))


@pytest.mark.parametrize(
    "kind,kw,block",
    [
        ("text", {}, {}),
        ("text", {"dictionary": False}, {}),
        ("elf", {"filters": True}, {}),
        ("text", {"precomp_only": True}, {}),
        ("text", {}, {"match": False}),
        ("stored", {}, {}),
    ],
)
def test_crp_archive_equals_jax(kind, kw, block):
    """The whole crp archive, several blocks: with and without dictionary,
    -F, -p, the match layer off (it rides the header) and the stored-block
    fallback; each package decodes it."""
    data = sample(kind)
    cpj, cpt = p_cps(**block)
    ref, got = io.BytesIO(), io.BytesIO()
    jcon.encode_stream(data, ref, cpj, **kw)
    con.encode_stream(data, got, cpt, "cpu", **kw)
    arc = got.getvalue()
    assert arc == ref.getvalue()
    cross_decode(arc, data)
    cp, _ = con.read_header(io.BytesIO(arc))
    assert cp.codec == b"P" and cp.block.mode == "P"
    assert cp.block.match == block.get("match", True)


def test_crp_make_params_matches_jax():
    for opts in (
        {"lanes": 512, "block_mb": 8},
        {"lanes": 512, "block_mb": 1, "flexible": False},
        {"lanes": 256, "block_mb": 64, "depth": 70},  # no 16 MiB cap in mode P
        {"lanes": 8, "block_mb": 0.001, "window": 200},
    ):
        mine = cli.make_params("crp", opts)
        ref = jcli.make_params("crp", dict(opts))
        assert mine.codec == ref.codec == b"P"
        assert asdict(mine.block) == asdict(ref.block)
    bp = cli.make_params("crp", {"lanes": 512, "block_mb": 8}).block
    assert (bp.mode, bp.steps, bp.min_len, bp.window) == ("P", 16384, 4, 250)
    assert (bp.rolz_ctx_bytes, bp.rolz_dec, bp.n_slots) == (3, 1, 3)
    assert cli.make_params("crp", {"lanes": 256, "block_mb": 64}).block.capacity == 1 << 26


def test_crp_cli_archive_equals_jax(tmp_path):
    """crp e / crp d through both command lines: the same file both ways;
    -f0 and -m are accepted and change nothing but the header-free params."""
    src = tmp_path / "in.bin"
    sample("text").tofile(src)
    arcs = []
    for flags in ([], ["-f0"], ["-m10"], ["-F"]):
        args = ["-b0.0005", "-l8", "-q", *flags]
        cli.run("crp", ["e", str(src), str(tmp_path / "port.crp"), *args], device="cpu")
        jcli.run("crp", ["e", str(src), str(tmp_path / "jax.crp"), *args])
        arc = (tmp_path / "port.crp").read_bytes()
        assert arc == (tmp_path / "jax.crp").read_bytes()
        arcs.append(arc)
        cli.run("crp", ["d", str(tmp_path / "jax.crp"), str(tmp_path / "out.bin"), "-q"],
                device="cpu")
        assert (tmp_path / "out.bin").read_bytes() == src.read_bytes()
        cross_decode(arc, sample("text"))
    assert arcs[0] == arcs[1] == arcs[2], "mode P has no parse to switch"


def test_cli_without_a_codec_name_writes_crp(tmp_path, monkeypatch):
    """With no codec name first, both command lines are crp's: the same
    archive, codec byte P."""
    src = tmp_path / "in.bin"
    sample("text").tofile(src)
    args = ["-b0.0005", "-l8", "-q"]
    assert cli.main(["e", str(src), str(tmp_path / "port.cpx"), *args], "cpu") == 0
    monkeypatch.setattr(sys, "argv", ["comprox", "e", str(src),
                                      str(tmp_path / "jax.cpx"), *args])
    assert jcli.main() == 0
    arc = (tmp_path / "port.cpx").read_bytes()
    assert arc == (tmp_path / "jax.cpx").read_bytes()
    assert con.read_header(io.BytesIO(arc))[0].codec == b"P"


@pytest.mark.parametrize("where", ["header", "payload", "stream"])
def test_crp_corrupt_archive_raises(where):
    data = sample("text")
    _, cpt = p_cps()
    f = io.BytesIO()
    con.encode_stream(data, f, cpt, "cpu", dictionary=False)
    arc = bytearray(f.getvalue())
    at = {"header": 10, "payload": con.HEADER_LEN + con.BLKHDR_LEN + 40,
          "stream": len(arc) - 30}[where]
    arc[at] ^= 0x40
    with pytest.raises(ValueError):
        con.decode_stream(io.BytesIO(bytes(arc)), io.BytesIO(), "cpu")
