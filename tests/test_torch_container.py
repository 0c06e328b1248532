"""The port's crz container and CLI against the JAX package: the slice as a
whole.  Archives must be byte-identical and decode across packages."""

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
    from comprox_tpu.ops import filters as flt

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
        print("jax" in sys.modules)
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
    for codec, flags, exc in (
        (b"R", jcon.F_CHAIN, NotImplementedError),
        (b"R", jcon.F_CHAIN | jcon.F_CHAIN_MATCH, NotImplementedError),
        (b"X", 0, NotImplementedError),
        (b"P", 0, NotImplementedError),
        (b"F", 0, NotImplementedError),
    ):
        f = io.BytesIO()
        mode = {b"R": "R", b"X": "X", b"F": "F"}.get(codec, "P")
        jcon.write_header(
            f, jcon.ContainerParams(codec=codec, block=jblk.BlockParams(
                **dict(SMALL, mode=mode))), flags=flags)
        f.write(b"\0" * 13)
        with pytest.raises(exc, match="not yet ported"):
            con.decode_stream(io.BytesIO(f.getvalue()), io.BytesIO(), "cpu")


@pytest.mark.parametrize(
    "argv",
    [
        ["crz", "e", "a", "b", "-f0", "-c"],
        ["crz", "e", "a", "b", "-f0", "-C"],
        ["crz", "e", "a", "b", "-f0", "-j"],
        ["crz", "e", "a", "b", "-f0", "-g2"],
        ["crz", "e", "a", "b"],
        ["crx", "e", "a", "b", "-f0"],
        ["crp", "e", "a", "b", "-f0"],
        ["crf", "e", "a", "b", "-f0"],
    ],
)
def test_cli_unported_switches_raise(argv, tmp_path):
    (tmp_path / "a").write_bytes(b"x" * 100)
    argv = [str(tmp_path / a) if a in ("a", "b") else a for a in argv]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.run(argv[0], argv[1:], device="cpu")


def test_cli_needs_a_card_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run("crz", ["d", str(tmp_path / "a"), str(tmp_path / "b")], "cuda")


def test_golden_fixture_metadata():
    """The committed JAX archives carry the digests chip_smoke.py checks."""
    meta = json.loads((ROOT / "tests/data/torch_golden.json").read_text())
    assert "crz_f0_1MiB_S512.cpx" in meta
    import hashlib

    for name, m in meta.items():
        arc = (ROOT / "tests/data" / name).read_bytes()
        assert hashlib.sha256(arc).hexdigest() == m["archive_sha256"]
        assert len(arc) == m["archive_bytes"]
        cp, flags = con.read_header(io.BytesIO(arc))
        assert cp.block.lanes == 512 and not flags & (con.F_CHAIN | con.F_CHAIN_MATCH)
