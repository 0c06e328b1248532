"""The pipelined container (one block in flight, the chained encode's
speculation), the block codec's start/finish pairs, encode_block_stats and
utils/profiling.py of the port against the JAX package.

Every encode here has four or more blocks of S=8 lanes and T=64 steps
(mode F: T=512, so that its 1 KiB table leaves a block worth coding) and a
ragged tail.  The archives of the pipelined
schedule must be the JAX package's and those of the port's sequential
schedule (``encode_fn``, the one-block codec), and must decode back."""

import io
import re

import numpy as np
import pytest
import torch

from comprox_tpu.codec import block as jblk
from comprox_tpu.codec import container as jcon
from comprox_tpu.utils import profiling as jprof
from comprox_tpu_torch.cli import main as cli
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec import container as con
from comprox_tpu_torch.utils import profiling as prof

from test_block import corpus

# the plain versions run many tiny ops: more intra-op threads would only
# contend with the other test workers
torch.set_num_threads(1)

GEO = dict(lanes=8, steps=64, window=32, o3_bits=14)
MODES = {
    "crz": dict(GEO, mode="R", min_len=5, rolz_bits=10, rolz_depth=16),
    "crx": dict(GEO, mode="X", min_len=6),
    "crp": dict(GEO, mode="P", min_len=4),
    "crf": dict(GEO, mode="F", min_len=6, steps=512),
}
CAP = GEO["lanes"] * GEO["steps"]
N_BLOCKS = 3  # whole blocks before the ragged tail


def cap(codec: str) -> int:
    return MODES[codec]["lanes"] * MODES[codec]["steps"]


def cps(codec: str, **kw):
    kw = dict(MODES[codec], **kw)
    byte = cli.CODEC_BYTE[codec]
    return (jcon.ContainerParams(codec=byte, block=jblk.BlockParams(**kw)),
            con.ContainerParams(codec=byte, block=blk.BlockParams(**kw)))


def text(n: int = N_BLOCKS * CAP + 197, seed: int = 5) -> np.ndarray:
    return corpus("text", n, seed=seed)


def blocks_of(codec: str) -> np.ndarray:
    """N_BLOCKS whole blocks of the codec's geometry and a ragged tail of
    3/8 of a block and 5 bytes."""
    return text(N_BLOCKS * cap(codec) + cap(codec) * 3 // 8 + 5)


def jax_archive(jcp, data, **kw) -> bytes:
    buf = io.BytesIO()
    jcon.encode_stream(data, buf, jcp, **kw)
    return buf.getvalue()


def port_archive(tcp, data, **kw) -> bytes:
    buf = io.BytesIO()
    con.encode_stream(data, buf, tcp, "cpu", **kw)
    return buf.getvalue()


def port_decode(arc: bytes, **kw) -> bytes:
    out = io.BytesIO()
    con.decode_stream(io.BytesIO(arc), out, "cpu", **kw)
    return out.getvalue()


@pytest.mark.parametrize("codec", ["crz", "crx", "crp", "crf"])
def test_pipelined_archive_is_jax_and_sequential(codec):
    jcp, tcp = cps(codec)
    data = blocks_of(codec)
    arc = port_archive(tcp, data)
    assert not _stored_flags(arc) & con.BF_STORED  # every block coded
    assert arc == jax_archive(jcp, data)
    assert arc == port_archive(tcp, data, encode_fn=con._block_encoder(tcp.block, "cpu"))
    assert port_decode(arc) == data.tobytes()


def _logged(monkeypatch, log, names):
    """Wrap the container's start and finish functions ``names`` so that
    each call is logged as (kind, block index)."""
    handles = []
    for kind, name in names:
        fn = getattr(con, name)

        def wrapped(*a, _fn=fn, _kind=kind, **k):
            if _kind == "start":
                handles.append(_fn(*a, **k))
                log.append(("start", len(handles) - 1))
                return handles[-1]
            log.append(("finish", next(i for i, h in enumerate(handles) if h is a[0])))
            return _fn(*a, **k)

        monkeypatch.setattr(con, name, wrapped)


def _check_one_in_flight(log, n):
    starts = [i for k, i in log if k == "start"]
    finishes = [i for k, i in log if k == "finish"]
    assert starts == list(range(n)) and finishes == list(range(n))
    where = {e: j for j, e in enumerate(log)}
    for i in range(n - 1):
        assert where["start", i + 1] < where["finish", i]
    open_ = [sum(1 if k == "start" else -1 for k, _ in log[:j + 1]) for j in range(len(log))]
    assert max(open_) == 2  # one block in flight beside the one finishing
    assert log[-1] == ("finish", n - 1)  # the tail is drained


@pytest.mark.parametrize("codec", ["crp", "crf"])
def test_schedule_keeps_one_block_in_flight(codec, monkeypatch):
    _, tcp = cps(codec)
    data = blocks_of(codec)
    n = -(-data.size // cap(codec))
    f = "_fast" if codec == "crf" else ""
    log = []
    _logged(monkeypatch, log, [("start", f"encode_block{f}_start"),
                               ("finish", f"encode_block{f}_finish")])
    arc = port_archive(tcp, data, dictionary=False)
    assert not _stored_flags(arc) & con.BF_STORED
    _check_one_in_flight(log, n)
    log.clear()
    _logged(monkeypatch, log, [("start", f"decode_block{f}_start"),
                               ("finish", f"decode_block{f}_finish")])
    assert port_decode(arc) == data.tobytes()
    _check_one_in_flight(log, n)


def _block_flags(arc: bytes) -> list:
    f = io.BytesIO(arc)
    if con.read_header(f)[1] & con.F_DICT:  # skip the dictionary blob
        blob_len, clen, _ = con.struct.unpack("<III", f.read(12))
        f.read(clen or blob_len)
    flags = []
    while True:
        raw_n, blen, bflags, _ = con.struct.unpack(con.BLKHDR, f.read(con.BLKHDR_LEN))
        if raw_n == 0:
            return flags
        flags.append(bflags)
        f.read(blen)


def _stored_flags(arc: bytes) -> int:
    """The blocks' flags or'ed together."""
    out = 0
    for f in _block_flags(arc):
        out |= f
    return out


def stored_middle() -> np.ndarray:
    """Three blocks and a ragged tail, block 2 seeded random bytes (stored
    raw)."""
    rng = np.random.default_rng(23)
    return np.concatenate([text(2 * CAP, 3), rng.integers(0, 256, CAP, dtype=np.uint8),
                           text(CAP - 101, 4)])


@pytest.mark.parametrize("chain_match", [False, True])
def test_chained_speculation_redoes_the_block_after_a_stored_one(chain_match, monkeypatch):
    jcp, tcp = cps("crz", chain_match=chain_match)
    data = stored_middle()
    want = jax_archive(jcp, data, dictionary=False, chain=True)
    arcs, starts = {}, {}
    real = con.encode_block_chained_start
    for spec in ("1", "0"):
        monkeypatch.setenv("CPX_CHAIN_SPEC", spec)
        seen = []

        def start(data_blk, *a, **k):
            seen.append(data_blk.tobytes())
            return real(data_blk, *a, **k)

        monkeypatch.setattr(con, "encode_block_chained_start", start)
        arcs[spec] = port_archive(tcp, data, dictionary=False, chain=True)
        starts[spec] = [sum(s == data[i * CAP:(i + 1) * CAP].tobytes() for s in seen)
                        for i in range(-(-data.size // CAP))]
    assert arcs["1"] == want and arcs["0"] == want
    flags = _block_flags(want)
    assert flags[2] & con.BF_STORED and not any(f & con.BF_STORED for i, f in enumerate(flags)
                                                 if i != 2)
    assert starts["1"] == [1, 1, 1, 2]  # block 3 again, from the committed state
    assert starts["0"] == [1] * 4
    assert port_decode(want) == data.tobytes()


@pytest.mark.parametrize("where", ["stream", "crc"])
def test_corrupt_block_2_raises_what_jax_raises(where):
    jcp, _ = cps("crz")
    data = text()
    arc = bytearray(jax_archive(jcp, data, dictionary=False))
    off = con.HEADER_LEN
    for _ in range(2):  # skip to block 2's header
        off += con.BLKHDR_LEN + int(np.frombuffer(arc[off + 4:off + 8], "<u4")[0])
    raw_n, blen, bflags, _ = con.struct.unpack(con.BLKHDR, bytes(arc[off:off + con.BLKHDR_LEN]))
    body = off + con.BLKHDR_LEN
    arc[body + 4 + 4 * GEO["lanes"] + 3] ^= 0x5A
    if where == "stream":  # the CRC made good: the scan does not drain
        crc = con.zlib.crc32(bytes(arc[body:body + blen])) & 0xFFFFFFFF
        arc[off:body] = con.struct.pack(con.BLKHDR, raw_n, blen, bflags, crc)
    errors = []
    for decode in (lambda f, o: jcon.decode_stream(f, o),
                   lambda f, o: con.decode_stream(f, o, "cpu")):
        with pytest.raises(ValueError) as e:
            decode(io.BytesIO(bytes(arc)), io.BytesIO())
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith("corrupt")


@pytest.mark.parametrize("mode", ["R", "X", "P"])
def test_encode_block_stats_is_jax(mode):
    codec = {"R": "crz", "X": "crx", "P": "crp"}[mode]
    jcp, tcp = cps(codec)
    data = text(CAP - 37, 8)
    want = jblk.encode_block_stats(data, jcp.block)
    got = blk.encode_block_stats(data, tcp.block, "cpu")
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, int):
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k
    payload = blk.encode_block(data, tcp.block, "cpu")
    assert got["stream_words"] == int(np.frombuffer(payload[:4], "<u4")[0])


def test_progress_writes_jax_text(capsys):
    for meter in (jprof.Progress(), prof.Progress()):
        for done in (0, 10, 11, 50, 99, 100, 100):
            meter.update(done, 100)
        meter.update(3, 0)
    err = capsys.readouterr().err
    half = len(err) // 2
    assert err[:half] == err[half:] and err[:half].endswith("100%\n")
    prof.Progress(enabled=False).update(5, 10)
    assert capsys.readouterr().err == ""


def test_stage_timers_report_is_jax_format():
    timers = [jprof.StageTimers(), prof.StageTimers()]
    for t in timers:
        t.totals.update(encode=1.25, fetch=0.5)
        t.counts.update(encode=3, fetch=1)
    outs = []
    for t in timers:
        buf = io.StringIO()
        t.report(out=buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    t = prof.StageTimers(device="cpu")
    with t.stage("a"):
        torch.ones(4).sum()
    with t.stage("a", sync=False):
        pass
    assert t.counts == {"a": 2} and t.totals["a"] >= 0


def test_device_trace_writes_a_trace(tmp_path):
    with prof.device_trace(str(tmp_path / "tr")):
        torch.arange(64).sum()
    files = list((tmp_path / "tr").iterdir())
    assert len(files) == 1 and '"traceEvents"' in files[0].read_text()
    with prof.device_trace(None):
        pass
    with prof.device_trace(""):
        pass


@pytest.mark.parametrize("quiet", [False, True])
def test_cli_encode_shows_the_meter_unless_quiet(quiet, tmp_path, capsys):
    src = tmp_path / "in.bin"
    text(300).tofile(src)
    args = ["e", str(src), str(tmp_path / "out.crz"), "-b0.0005", "-l8"]
    assert cli.run("crz", args + (["-q"] if quiet else []), device="cpu") == 0
    err = capsys.readouterr().err
    assert bool(re.search(r"\r100%\n", err)) != quiet
    assert cli.run("crz", ["d", str(tmp_path / "out.crz"), str(tmp_path / "back")],
                   device="cpu") == 0
    assert "%" not in capsys.readouterr().err  # decode has no meter
    assert (tmp_path / "back").read_bytes() == src.read_bytes()
