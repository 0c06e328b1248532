"""Blocks over processes: two ``torch.distributed`` processes (gloo) of the
port's worker, ``python -m comprox_tpu_torch.parallel.dryrun``, on the CPU,
against the JAX package's one-process encode.

The input and block parameters are ``tests/_dist_worker.py``'s (S=8, T=64,
mode R, four blocks less 17 bytes).  Each rank encodes the file over its
rows, gathers every payload in file order, decodes the payloads over its
rows and gathers the file back; both must return JAX's payloads
(``encode_block`` a block) and the input.  A corrupt payload (flipped by
the test's own wrapper of ``decode_file_distributed`` in each rank) makes
both ranks raise the same error, neither waiting for ever.  Each process has a
timeout of its own and a free port of its own.
"""

import dataclasses
import functools
import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from comprox_tpu.codec.block import encode_block
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.parallel import distributed as D
from comprox_tpu_torch.parallel import dryrun
from comprox_tpu_torch.parallel import mesh as pmesh

from _dist_worker import corpus_and_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120

# the worker with a stream byte of payload {block} flipped before the decode
CORRUPTING_WORKER = """
import sys
from comprox_tpu_torch.parallel import distributed as D, dryrun

decode = D.decode_file_distributed

def corrupt_then_decode(payloads, ns, p, mesh):
    bad = bytearray(payloads[{block}])
    bad[4 + 4 * p.lanes + 1] ^= 0x3C
    payloads[{block}] = bytes(bad)
    return decode(payloads, ns, p, mesh)

D.decode_file_distributed = corrupt_then_decode
sys.exit(dryrun.worker())
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_params():
    """The worker's corpus and the JAX and port BlockParams of it."""
    data, jp = corpus_and_params()
    return data, jp, blk.BlockParams(**dataclasses.asdict(jp))


def run_ranks(tmp_path, world=2, corrupt=None):
    """The worker's ranks, started together (with ``corrupt`` a block: the
    corrupting worker); returns each rank's record."""
    data, _, pp = port_params()
    src = tmp_path / "in.bin"
    data.tofile(src)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    entry = (["-m", "comprox_tpu_torch.parallel.dryrun"] if corrupt is None
             else ["-c", CORRUPTING_WORKER.format(block=corrupt)])
    procs = [subprocess.Popen(
        [sys.executable, *entry, "--rank", str(r), "--world", str(world), "--port", str(port),
         "--device", "cpu", "--input", str(src), "--out", str(tmp_path),
         "--params", json.dumps(dataclasses.asdict(pp))],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    recs = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=TIMEOUT_S)
            path = tmp_path / f"rank{r}.json"
            assert path.exists(), f"rank {r} wrote nothing (rc {p.returncode}):\n{err[-3000:]}"
            recs.append((p.returncode, json.loads(path.read_text())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return recs


@functools.lru_cache(maxsize=None)
def jax_payloads_sha256() -> str:
    data, jp, _ = port_params()
    cap = jp.capacity
    nblk = -(-data.size // cap)
    return hashlib.sha256(b"".join(
        encode_block(data[b * cap : (b + 1) * cap], jp) for b in range(nblk))).hexdigest()


def test_two_ranks_encode_and_decode_like_one_process(tmp_path):
    recs = run_ranks(tmp_path)
    want = jax_payloads_sha256()
    for r, (rc, rec) in enumerate(recs):
        assert rec["error"] is None and rc == 0, rec
        assert rec["rank"] == r and rec["world"] == 2 and rec["blocks"] == 4
        assert rec["payloads_sha256"] == want
        assert rec["decoded_ok"]


def test_a_corrupt_payload_raises_on_both_ranks(tmp_path):
    """Block 2 is rank 1's: rank 1 finds it does not drain, and rank 0,
    whose blocks decode, raises the same error instead of waiting."""
    recs = run_ranks(tmp_path, corrupt=2)
    for rc, rec in recs:
        assert rc == 1
        assert rec["error"] == "ValueError: corrupt block 2", rec
        assert rec["payloads_sha256"] == jax_payloads_sha256()


def test_world_size_one_is_encode_blocks():
    """No process group: the distributed forms are the mesh's, byte for
    byte, and gather nothing."""
    data, _, pp = port_params()
    mesh = pmesh.make_mesh(devices=["cpu", "cpu"])
    assert D.process_count() == 1 and D.process_index() == 0
    D.initialize(num_processes=1)  # nothing for one process
    got = D.encode_file_distributed(data, pp, mesh)
    assert got == pmesh.encode_blocks(data, pp, mesh)
    assert hashlib.sha256(b"".join(got)).hexdigest() == jax_payloads_sha256()
    ns = [min(pp.capacity, data.size - b * pp.capacity) for b in range(len(got))]
    np.testing.assert_array_equal(D.decode_file_distributed(got, ns, pp, mesh), data)


def test_pad_blocks_and_one_process_gather_are_jax_s():
    data, _, pp = port_params()
    buf, ns, nblk = D._pad_blocks(data, pp, 3)
    assert buf.shape == (6, pp.lanes, pp.steps) and nblk == 4
    assert ns.tolist() == [512, 512, 512, 512 - 17, 0, 0]
    assert D._allgather_payloads([b"a", b"bc"], np.array([4, 5]), 3) == [b"a", b"bc"]


def test_dryrun_multichip_on_a_cpu_mesh(capsys):
    p = blk.BlockParams(lanes=8, steps=64, mode="R", min_len=5, o3_bits=12,
                        rolz_bits=10, rolz_depth=16, rolz_ctx_bytes=4, rolz_dec=2)
    payloads = dryrun.dryrun_multichip(2, "cpu", p=p)
    assert len(payloads) == 2
    assert capsys.readouterr().out.startswith(
        "dryrun_multichip: 2 devices, 2 blocks, 735 bytes round-tripped bit-exact")
    assert dryrun.dryrun_data(blk.BlockParams(**dryrun.DRYRUN_PARAMS), 2).size == \
        2 * 512 * 2048 - 1313


def test_dryrun_needs_its_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(AssertionError, match="need 2 devices, have 0"):
        dryrun.dryrun_multichip(2)
