"""The multi-device dry run, and a worker of the multi-process run.

:func:`dryrun_multichip` codes a file of one block a device over a mesh
and decodes it, at the production table geometry by default (S=512, 1 MiB
blocks, 2^18 x 64 bucket entries, 2^22 o3 entries, 4-byte contexts, insert
decimation 2; an uneven tail block), and asserts a bit-exact round trip and
the payloads of one device coding the blocks one at a time
(the JAX package's ``__graft_entry__.py::dryrun_multichip``).

Run as a module it is one rank of a multi-process run over
``torch.distributed`` (gloo): it reads ``--input``, encodes it with
:func:`~comprox_tpu_torch.parallel.distributed.encode_file_distributed`,
decodes the payloads with ``decode_file_distributed`` and writes what it
got to ``<out>/rank<r>.json``: the payloads' SHA-256, whether the decode
equals the input, walls, peak card memory, or the error it raised.  Two
ranks on the CPU::

    python -m comprox_tpu_torch.parallel.dryrun --rank 0 --world 2 \\
        --port 29511 --device cpu --input in.bin --out outdir &
    python -m comprox_tpu_torch.parallel.dryrun --rank 1 --world 2 \\
        --port 29511 --device cpu --input in.bin --out outdir

(on a card ``--device cuda:0``; ``--params`` takes the block parameters
as JSON, the dry run's geometry by default).  Exit status 0 when the rank
decoded the input bit-exact, 1 otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from comprox_tpu_torch.codec.block import BlockParams
from comprox_tpu_torch.parallel.mesh import (
    decode_blocks,
    encode_blocks,
    encode_blocks_list,
    make_mesh,
)

# the dry run's production table geometry (mode R, 1 MiB blocks at S=512)
DRYRUN_PARAMS = dict(lanes=512, steps=2048, mode="R", min_len=5, o3_bits=22,
                     rolz_bits=18, rolz_depth=64, rolz_ctx_bytes=4, rolz_dec=2)
TAIL_SHORT = 1313  # the last block's bytes short of a full one


def dryrun_data(p: BlockParams, n_blocks: int) -> np.ndarray:
    """``n_blocks`` blocks of text from seed 1, the last ``TAIL_SHORT`` bytes
    short (modulo the capacity, for small test geometries)."""
    rng = np.random.default_rng(1)
    return rng.choice(
        np.frombuffer(b"abcabc the fox jumps \n", np.uint8),
        p.capacity * n_blocks - TAIL_SHORT % p.capacity,
    ).astype(np.uint8)


def dryrun_multichip(n_devices: int, device_type: str = "cuda", p: BlockParams = None) -> list:
    """Encode and decode one block a device over a mesh of ``n_devices``
    (CUDA devices; with ``device_type="cpu"`` that many CPU entries), the
    tail block uneven; asserts the round trip bit-exact and the payloads
    equal to ``encode_blocks_list(group=1)``'s on the mesh's first device.
    Returns the payloads."""
    p = BlockParams(**DRYRUN_PARAMS) if p is None else p
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        assert have >= n_devices, f"need {n_devices} devices, have {have}"
        mesh = make_mesh(n_devices)
    else:
        mesh = make_mesh(devices=[torch.device(device_type)] * n_devices)
    data = dryrun_data(p, n_devices)
    payloads = encode_blocks(data, p, mesh)
    cap = p.capacity
    ns = [min(cap, data.size - b * cap) for b in range(len(payloads))]
    out = decode_blocks(payloads, ns, p, mesh=mesh)
    assert out.size == data.size and (out == data).all(), "round trip failed"
    one = encode_blocks_list([data[b * cap : (b + 1) * cap] for b in range(len(ns))],
                             p, group=1, device=mesh.devices[0])
    assert one == payloads, "the mesh's payloads differ from one device's"
    print(f"dryrun_multichip: {n_devices} devices, {len(payloads)} blocks, "
          f"{data.size} bytes round-tripped bit-exact")
    return payloads


def worker(argv=None) -> int:
    """One rank of a multi-process encode and decode (see the module
    docstring); returns the exit status."""
    ap = argparse.ArgumentParser(prog="python -m comprox_tpu_torch.parallel.dryrun")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--input", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--params", default=json.dumps(DRYRUN_PARAMS),
                    help="BlockParams fields as JSON")
    args = ap.parse_args(argv)
    from comprox_tpu_torch.parallel import distributed as D

    device = torch.device(args.device)
    p = BlockParams(**json.loads(args.params))
    data = np.fromfile(args.input, np.uint8)
    rec = {"rank": args.rank, "world": args.world, "device": str(device),
           "params": dataclasses.asdict(p), "error": None}
    D.initialize(coordinator=f"127.0.0.1:{args.port}", num_processes=args.world,
                 process_id=args.rank)
    try:
        assert D.process_count() == args.world, "distributed bring-up failed"
        mesh = D.global_mesh(device)
        on_card = device.type == "cuda"
        if on_card:
            torch.cuda.set_device(device)
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        payloads = D.encode_file_distributed(data, p, mesh)
        rec["encode_s"] = time.perf_counter() - t0
        rec["blocks"] = len(payloads)
        rec["payloads_sha256"] = hashlib.sha256(b"".join(payloads)).hexdigest()
        ns = [min(p.capacity, data.size - b * p.capacity) for b in range(len(payloads))]
        t0 = time.perf_counter()
        out = D.decode_file_distributed(payloads, ns, p, mesh)
        rec["decode_s"] = time.perf_counter() - t0
        rec["decoded_ok"] = bool(out.size == data.size and (out == data).all())
        if on_card:
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    except Exception as e:  # recorded for the caller, which checks every rank
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        if D._group() is not None:
            D._group().destroy_process_group()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"rank{args.rank}.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0 if rec.get("decoded_ok") else 1


if __name__ == "__main__":
    sys.exit(worker())
