"""Blocks over a mesh of devices (``mesh=``, ``-j``) against the JAX
package's sharded forms on its virtual CPU mesh (``tests/conftest.py``
gives 8 devices).

The port's meshes here are several entries of ``torch.device("cpu")``, a
host thread an entry, each coding its contiguous rows through the plain
versions of the passes (on a card: one batched launch a pass a device).
The payloads, the decoded bytes, the errors and the archives must be
JAX's, byte for byte, at S=8, T=32: five blocks of R, X and P (a block
count that is no multiple of 2 or 3, an uneven tail), a list of blocks a
group a mesh, a corrupt payload, whole archives under ``mesh=`` (mode F
around the mesh), chain mode refused, and ``-j`` parsed.
"""

import io

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
from comprox_tpu_torch.parallel import mesh as pmesh

from test_block import corpus

torch.set_num_threads(1)

BASE = dict(lanes=8, steps=32, mode="R", min_len=5, window=32, o3_bits=12,
            rolz_bits=10, rolz_depth=16)
MODES = {"R": {}, "X": {"mode": "X", "min_len": 6}, "P": {"mode": "P", "min_len": 4}}


def params(mode):
    kw = dict(BASE, **MODES[mode])
    return jblk.BlockParams(**kw), blk.BlockParams(**kw)


def cpu_mesh(k):
    return pmesh.make_mesh(devices=[torch.device("cpu")] * k)


def five_blocks_less_40(cap, seed=3):
    return corpus("text", 5 * cap - 40, seed=seed)


def test_mesh_class_and_make_mesh():
    m = cpu_mesh(3)
    assert m.size == 3 and m.devices == (torch.device("cpu"),) * 3
    assert pmesh.make_mesh(2, devices=["cpu"] * 3).size == 2
    assert pmesh._shard_rows(5, 3) == [(0, 2), (2, 4), (4, 5)]
    assert pmesh._shard_rows(5, 2) == [(0, 3), (3, 5)]
    assert pmesh._shard_rows(1, 3) == [(0, 1), (1, 1), (1, 1)]
    assert pmesh._shard_rows(5, 2, per=4) == [(0, 4), (4, 5)]


@pytest.mark.parametrize("mode,k", [("R", 2), ("R", 3), ("X", 3), ("P", 2)])
def test_encode_blocks_matches_jax(mode, k):
    """encode_blocks / decode_blocks over a mesh of k: JAX's payloads (the
    blocks padded to a multiple of k, device d its contiguous rows) and
    bytes; the payloads are also the one-block path's."""
    jp, pp = params(mode)
    data = five_blocks_less_40(jp.capacity)
    want = jmesh.encode_blocks(data, jp, jmesh.make_mesh(k))
    got = pmesh.encode_blocks(data, pp, cpu_mesh(k))
    assert got == want
    cap = pp.capacity
    assert got[-1] == blk.encode_block(data[4 * cap :], pp, "cpu")
    ns = [min(cap, data.size - b * cap) for b in range(len(got))]
    np.testing.assert_array_equal(pmesh.decode_blocks(got, ns, pp, mesh=cpu_mesh(k)), data)


def test_encode_blocks_of_an_empty_file_matches_jax():
    jp, pp = params("R")
    empty = np.zeros(0, np.uint8)
    assert pmesh.encode_blocks(empty, pp, cpu_mesh(2)) == \
        jmesh.encode_blocks(empty, jp, jmesh.make_mesh(2))


def test_encode_blocks_list_over_a_mesh_matches_jax():
    """A list of blocks of different n, a group of mesh.size (3) at a time,
    one block a device; then the payloads decoded over a mesh of 2."""
    jp, pp = params("R")
    data = corpus("text", 5 * jp.capacity, seed=8)
    sizes = [jp.capacity, jp.capacity - 7, 17, jp.capacity - 3, 40]
    blocks = [data[i * jp.capacity : i * jp.capacity + n] for i, n in enumerate(sizes)]
    want = jmesh.encode_blocks_list(blocks, jp, mesh=jmesh.make_mesh(3))
    got = pmesh.encode_blocks_list(blocks, pp, mesh=cpu_mesh(3))
    assert got == want
    out = pmesh.decode_blocks(got, sizes, pp, mesh=cpu_mesh(2))
    np.testing.assert_array_equal(out, np.concatenate(blocks))


@pytest.mark.parametrize("fault", ["stream_pad", "drain"])
def test_corrupt_payload_over_a_mesh_raises_like_jax(fault):
    jp, pp = params("R")
    data = five_blocks_less_40(jp.capacity, seed=4)
    payloads = pmesh.encode_blocks(data, pp, cpu_mesh(2))
    bad = bytearray(payloads[3])
    if fault == "stream_pad":
        bad[:4] = np.array([pp.stream_pad + 1], "<u4").tobytes()
        match = "corrupt block: stream exceeds geometry bound"
    else:
        bad[4 + 4 * pp.lanes + 3] ^= 0x5A  # a stream word of block 3
        match = "corrupt block 3"
    payloads[3] = bytes(bad)
    ns = [min(pp.capacity, data.size - b * pp.capacity) for b in range(5)]
    with pytest.raises(ValueError, match=match):
        jmesh.decode_blocks(payloads, ns, jp, jmesh.make_mesh(2))
    with pytest.raises(ValueError, match=match):
        pmesh.decode_blocks(payloads, ns, pp, mesh=cpu_mesh(2))


def test_a_failing_device_ends_every_thread_and_raises():
    """An error on one device's thread reaches the caller once the other
    threads have ended (the first in device order)."""
    seen = []

    def fn(dev, part):
        seen.append(part)
        if part in (1, 2):
            raise ValueError(f"shard {part}")
        return part

    with pytest.raises(ValueError, match="shard 1"):
        pmesh._on_mesh(cpu_mesh(3), fn, [0, 1, 2])
    assert sorted(seen) == [0, 1, 2]


CODECS = {"R": dict(BASE), "X": dict(BASE, mode="X", min_len=6),
          "P": dict(BASE, mode="P", min_len=4),
          "F": dict(BASE, mode="F", min_len=6, steps=64)}


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_encode_stream_over_a_mesh_matches_jax(codec):
    """``encode_stream(mesh=)`` writes JAX's ``mesh=make_mesh(4)`` archive
    (mode F around the mesh), and ``decode_stream(mesh=)`` gives the input
    back, a window of mesh.size blocks at a time (mode F one block at a
    time)."""
    kw = CODECS[codec]
    jcp = jcon.ContainerParams(codec=codec.encode(), block=jblk.BlockParams(**kw))
    pcp = con.ContainerParams(codec=codec.encode(), block=blk.BlockParams(**kw))
    data = corpus("text", 5 * jcp.block.capacity + 17, seed=9)
    want, got = io.BytesIO(), io.BytesIO()
    jcon.encode_stream(data, want, jcp, mesh=jmesh.make_mesh(4))
    con.encode_stream(data, got, pcp, "cpu", mesh=cpu_mesh(4))
    assert got.getvalue() == want.getvalue()
    for k in (4, 3):
        out = io.BytesIO()
        assert con.decode_stream(io.BytesIO(got.getvalue()), out, "cpu",
                                 mesh=cpu_mesh(k)) == data.size
        assert out.getvalue() == data.tobytes()


def test_mesh_overrides_group_and_codes_its_size(monkeypatch):
    """On encode a mesh sets the group to mesh.size whatever ``group``
    says."""
    calls = []
    real = pmesh.encode_blocks_list

    def spy(blocks, p, mesh=None, group=0, device="cuda"):
        calls.append((len(blocks), mesh.size if mesh else None))
        return real(blocks, p, mesh=mesh, group=group, device=device)

    monkeypatch.setattr(con, "encode_blocks_list", spy)
    pcp = con.ContainerParams(codec=b"R", block=blk.BlockParams(**BASE))
    data = corpus("text", 5 * pcp.block.capacity + 17, seed=10)
    buf, seq = io.BytesIO(), io.BytesIO()
    con.encode_stream(data, buf, pcp, "cpu", mesh=cpu_mesh(2), group=4)
    con.encode_stream(data, seq, pcp, "cpu")
    assert buf.getvalue() == seq.getvalue()
    assert calls == [(2, 2), (2, 2), (2, 2)]


def test_chain_mode_with_a_mesh_is_refused_as_jax_refuses_it():
    jcp = jcon.ContainerParams(codec=b"R", block=jblk.BlockParams(**BASE))
    pcp = con.ContainerParams(codec=b"R", block=blk.BlockParams(**BASE))
    data = corpus("text", 3 * pcp.block.capacity, seed=2)
    with pytest.raises(ValueError) as want:
        jcon.encode_stream(data, io.BytesIO(), jcp, chain=True, mesh=jmesh.make_mesh(2))
    with pytest.raises(ValueError) as got:
        con.encode_stream(data, io.BytesIO(), pcp, "cpu", chain=True, mesh=cpu_mesh(2))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("switch,jobs", [("-j", -1), ("-j2", 2), ("-j0", -1), ("-j8", 8)])
def test_jobs_switch_parses_as_jax(switch, jobs):
    argv = ["crz", "e", "a", "b", switch]
    assert cli.parse_args(argv)[4]["jobs"] == jcli.parse_args(argv)[4]["jobs"] == jobs
    assert cli.parse_args(["crz", "e", "a", "b"])[4]["jobs"] == 0


def test_jobs_mesh_of_a_run():
    """``-j[n]`` on the CPU is a mesh of the one device; on a CUDA device
    without a card it raises; no ``-j`` is no mesh."""
    assert cli.jobs_mesh(0, "cpu") is None
    assert cli.jobs_mesh(-1, "cpu").devices == (torch.device("cpu"),)
    assert cli.jobs_mesh(2, "cpu").size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.jobs_mesh(-1, "cuda")


def test_cli_jobs_round_trip(tmp_path):
    """``crx e -j2`` and ``d -j2`` on the CPU: -g1's archive, the input back."""
    data = corpus("text", 700, seed=21)
    (tmp_path / "a").write_bytes(data.tobytes())
    for sw in ("-j2", "-g1"):
        cli.run("crx", ["e", str(tmp_path / "a"), str(tmp_path / sw), "-b0.0002",
                        "-l8", "-q", sw], device="cpu")
    assert (tmp_path / "-j2").read_bytes() == (tmp_path / "-g1").read_bytes()
    cli.run("crx", ["d", str(tmp_path / "-j2"), str(tmp_path / "c"), "-q", "-j2"],
            device="cpu")
    assert (tmp_path / "c").read_bytes() == data.tobytes()
