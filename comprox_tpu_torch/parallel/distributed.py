"""Blocks over processes: ``torch.distributed`` and a mesh a process.

Counterpart of :mod:`comprox_tpu.parallel.distributed`, with the same names,
environment and payload bytes:

- :func:`initialize` brings up a process group when more than one process
  runs (``CPX_NUM_PROCESSES``, ``CPX_COORDINATOR``, ``CPX_PROCESS_ID``, the
  JAX package's variables and defaults);
- the blocks, padded to a multiple of (processes x local devices), split
  over the processes in contiguous ranges, process q the rows ``[q * per,
  (q + 1) * per)``, which it splits over its local mesh
  (:mod:`comprox_tpu_torch.parallel.mesh`);
- the payloads (decode: the decoded blocks) come back to every process in
  file order by an ordered gather: sizes, then order keys, then one padded
  u8 buffer.

The collectives carry host bytes and run over ``gloo``: the payloads are on
the host already (the JAX package gathers numpy arrays too), and NCCL
refuses two ranks on one device.  A rank that fails (a corrupt block, say)
does not leave the others waiting in a gather: every rank first gathers
each rank's status, and then every rank raises the same error.

One process (no process group) is :func:`~comprox_tpu_torch.parallel.mesh.
encode_blocks` / ``decode_blocks`` over the local mesh, byte for byte.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from comprox_tpu_torch.codec.block import check_supported
from comprox_tpu_torch.ops.rans_scalar import RANS_L
from comprox_tpu_torch.parallel.mesh import (
    Mesh,
    _decode_blocks_sharded,
    _encode_blocks_sharded,
    _parse_payloads,
    decode_blocks,
    make_mesh,
)


def initialize(coordinator=None, num_processes=None, process_id=None) -> None:
    """Bring up the process group (gloo) when more than one process runs;
    nothing for one.  The arguments default from ``CPX_NUM_PROCESSES`` (1),
    ``CPX_COORDINATOR`` (``localhost:12321``) and ``CPX_PROCESS_ID`` (0), so
    launchers only set the environment."""
    num = num_processes or int(os.environ.get("CPX_NUM_PROCESSES", "1"))
    if num <= 1:
        return
    import torch.distributed as dist

    addr = coordinator or os.environ.get("CPX_COORDINATOR", "localhost:12321")
    rank = (process_id if process_id is not None
            else int(os.environ.get("CPX_PROCESS_ID", "0")))
    dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=num,
                            rank=rank)


def _group():
    """``torch.distributed`` when a process group is up, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_count() -> int:
    dist = _group()
    return dist.get_world_size() if dist else 1


def process_index() -> int:
    dist = _group()
    return dist.get_rank() if dist else 0


def default_device() -> torch.device:
    """This process's device: ``cuda:{local rank % device count}`` (the
    local rank from ``LOCAL_RANK``, else the rank)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass the rank's device")
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local % torch.cuda.device_count())


def global_mesh(device=None) -> Mesh:
    """This process's part of the data-parallel mesh: its device (default
    :func:`default_device`).  With the other processes' parts it spans every
    rank; the block split counts processes x ``mesh.size`` devices."""
    return make_mesh(devices=[default_device() if device is None else device])


def _pad_blocks(data: np.ndarray, p, ndev: int):
    """Split ``data`` into p.capacity blocks, padded to a multiple of the
    global device count.  Returns (buf [B, S, T] u8, ns [B] i32, nblk)."""
    cap = p.capacity
    nblk = max(1, -(-data.size // cap))
    nblk_pad = -(-nblk // ndev) * ndev
    buf = np.zeros((nblk_pad, p.lanes, p.steps), np.uint8)
    ns = np.zeros((nblk_pad,), np.int32)
    for b in range(nblk):
        chunk = data[b * cap : (b + 1) * cap]
        buf[b].reshape(-1)[: chunk.size] = chunk
        ns[b] = chunk.size
    return buf, ns, nblk


def _raise_on_any(err) -> None:
    """Gather every rank's status (None or its error) and raise on every
    rank the error of the first rank that failed: a ValueError stays one,
    anything else becomes a RuntimeError naming the rank.  One process:
    re-raise ``err``."""
    dist = _group()
    if dist is None:
        if err is not None:
            raise err
        return
    mine = None if err is None else (type(err).__name__, str(err))
    status = [None] * dist.get_world_size()
    dist.all_gather_object(status, mine)
    for rank, st in enumerate(status):
        if st is not None:
            kind, msg = st
            exc = (ValueError(msg) if kind == "ValueError"
                   else RuntimeError(f"rank {rank}: {kind}: {msg}"))
            raise exc from err


def _allgather_payloads(local_payloads: list, order_key: np.ndarray, slots: int) -> list:
    """Ordered gather of variable-size payloads to every process.

    ``order_key[i]`` is the global block index of local payload i; every
    process passes at most ``slots`` of them (its rows; the padding is not
    coded, so a process may hold fewer).  Sizes all-gather first, then the
    keys; the bytes ride one padded u8 all-gather."""
    dist = _group()
    if dist is None:
        return list(local_payloads)
    nproc = dist.get_world_size()
    sizes = torch.zeros(slots, dtype=torch.int64)
    keys = torch.full((slots,), -1, dtype=torch.int64)
    sizes[: len(local_payloads)] = torch.tensor([len(b) for b in local_payloads],
                                                dtype=torch.int64)
    keys[: len(local_payloads)] = torch.from_numpy(np.asarray(order_key, np.int64))
    all_sizes = [torch.empty_like(sizes) for _ in range(nproc)]
    dist.all_gather(all_sizes, sizes)
    all_keys = [torch.empty_like(keys) for _ in range(nproc)]
    dist.all_gather(all_keys, keys)
    width = max(1, int(torch.stack(all_sizes).max()))
    buf = np.zeros((slots, width), np.uint8)
    for i, b in enumerate(local_payloads):
        buf[i, : len(b)] = np.frombuffer(b, np.uint8)
    mine = torch.from_numpy(buf)
    all_bufs = [torch.empty_like(mine) for _ in range(nproc)]
    dist.all_gather(all_bufs, mine)
    out: dict = {}
    for pi in range(nproc):
        for li in range(slots):
            k = int(all_keys[pi][li])
            if k >= 0:
                out[k] = all_bufs[pi][li, : int(all_sizes[pi][li])].numpy().tobytes()
    return [out[k] for k in sorted(out)]


def encode_file_distributed(data: np.ndarray, p, mesh: Mesh = None) -> list:
    """Whole-file encode over every process's mesh.

    Every process holds the input (a shared file system); process q codes
    its rows over its local mesh, and every process returns the same
    file-ordered payload list, so any of them can write the archive."""
    check_supported(p)
    mesh = mesh or global_mesh()
    nproc, q = process_count(), process_index()
    buf, ns, nblk = _pad_blocks(data, p, nproc * mesh.size)
    per = buf.shape[0] // nproc
    lo, hi = q * per, min((q + 1) * per, nblk)
    err, local = None, []
    try:
        if hi > lo:
            local = _encode_blocks_sharded(p, mesh, buf[lo:hi], ns[lo:hi],
                                           per // mesh.size)
    except Exception as e:  # every rank learns of it before the gather
        err = e
    _raise_on_any(err)
    payloads = _allgather_payloads(local, np.arange(lo, max(lo, hi)), per)
    return payloads[:nblk]


def decode_file_distributed(payloads: list, ns: list, p, mesh: Mesh = None) -> np.ndarray:
    """Decode independent block payloads over every process's mesh; every
    process returns the whole file's bytes (the decoded blocks gathered in
    order).  A payload over the geometry bound raises on every process
    before any collective (each parses all of them, as in the JAX package);
    a block that does not drain raises the same error on every process."""
    mesh = mesh or global_mesh()
    nproc, q = process_count(), process_index()
    if nproc == 1:
        return decode_blocks(payloads, ns, p, mesh=mesh)
    check_supported(p)
    ndev = nproc * mesh.size
    nblk = len(payloads)
    per = -(-max(nblk, 1) // ndev) * ndev // nproc
    states, streams, n_arr, n_words = _parse_payloads(payloads, ns, p)
    lo, hi = q * per, min((q + 1) * per, nblk)
    err, local = None, []
    try:
        if hi > lo:
            x, base, out = _decode_blocks_sharded(
                p, mesh, states[lo:hi], streams[lo:hi], n_arr[lo:hi], per // mesh.size)
            for i, b in enumerate(range(lo, hi)):
                if int(base[i]) != n_words[b] or not (x[i] == RANS_L).all():
                    raise ValueError(f"corrupt block {b}")
                local.append(out[i].reshape(-1)[: ns[b]].tobytes())
    except Exception as e:  # every rank learns of it before the gather
        err = e
    _raise_on_any(err)
    pieces = _allgather_payloads(local, np.arange(lo, max(lo, hi)), per)
    return (np.frombuffer(b"".join(pieces[:nblk]), np.uint8).copy()
            if pieces else np.zeros(0, np.uint8))
