"""Blocks over devices: block batching on one card (the CLI's ``-g``) and
blocks sharded over a mesh of devices (``-j``, ``mesh=``).

Counterpart of :mod:`comprox_tpu.parallel.mesh`, with the same names,
arguments, errors and payload bytes: every block's payload is the one
:func:`comprox_tpu_torch.codec.block.encode_block` writes for it alone,
because each block has tables of its own.

- ``_encode_blocks_vmap`` / ``_decode_blocks_vmap``: G blocks through the
  passes at once on one device (the JAX package's vmap over blocks); on
  the card each pass is one launch over the group (a CTA or a cluster of
  CTAs a block: ``codec/block.py``'s block axis).
- :class:`Mesh`, :func:`make_mesh`: an ordered tuple of devices on one
  data-parallel axis ``dp`` (JAX's 1-D ``Mesh``).
- ``_encode_blocks_sharded`` / ``_decode_blocks_sharded``: JAX's
  ``shard_map`` of the vmapped passes over ``P("dp")``: device d takes the
  contiguous rows ``[d * per, (d + 1) * per)`` and codes them in one batched
  launch a pass, a host thread a device (under ``torch.cuda.device``), all
  at once.
- :func:`encode_blocks`, :func:`encode_blocks_list`, :func:`decode_blocks`:
  a file, a list of blocks, a list of payloads, over a mesh or ``group`` at
  a time on one device.

JAX fixes the shapes under jit, so it pads a group or a shard to its size
with blocks of n = 0 and codes them; the port launches only the real
blocks, which changes no byte.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from comprox_tpu_torch.codec.block import (
    BlockParams,
    _payload_bytes,
    check_supported,
    compact_stream,
    decode_scan_blocks,
    encode_passes_blocks,
)
from comprox_tpu_torch.ops.rans_scalar import RANS_L


class Mesh:
    """An ordered tuple of devices on one data-parallel axis ``dp``
    (``.devices``, ``.size``).  CUDA devices carry their index; a CUDA
    device on a machine without one (or past its count) raises.  Several
    entries of ``torch.device("cpu")`` stand in for a mesh of devices on
    the CPU, as the JAX package's virtual CPU devices do."""

    def __init__(self, devices):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "a CUDA mesh needs a CUDA device; none found")
                idx = torch.cuda.current_device() if d.index is None else d.index
                if idx >= torch.cuda.device_count():
                    raise ValueError(f"no device {d}: {torch.cuda.device_count()} "
                                     "CUDA device(s)")
                d = torch.device("cuda", idx)
            elif d.type != "cpu":
                raise ValueError(f"unsupported device {d}")
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({', '.join(map(str, self.devices))})"


def make_mesh(n_devices=None, devices=None) -> Mesh:
    """The first ``n_devices`` of ``devices`` (default: every CUDA device,
    as JAX takes ``jax.devices()[:n]``) on one ``dp`` axis.  Without a card
    and without ``devices`` it raises: nothing falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (a CPU mesh takes "
                               "devices=[torch.device('cpu'), ...])")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices)


def _on_mesh(mesh: Mesh, fn, parts: list) -> list:
    """``fn(device, part)`` for each device of the mesh and its part, all at
    once: a host thread a device (a mesh of one too), each under
    ``torch.cuda.device`` on a card.  Returns the results in device order;
    the first exception in device order is raised once every thread has
    ended."""

    def run(dev, part):
        if dev.type != "cuda":
            return fn(dev, part)
        with torch.cuda.device(dev):
            return fn(dev, part)

    with ThreadPoolExecutor(max_workers=mesh.size) as pool:
        futs = [pool.submit(run, d, part) for d, part in zip(mesh.devices, parts)]
        return [f.result() for f in futs]


def _shard_rows(count: int, ndev: int, per=None) -> list:
    """Each device's rows ``(lo, hi)`` of ``count`` real rows under JAX's
    ``P("dp")``: device d the contiguous ``[d * per, (d + 1) * per)``, where
    ``per`` is the rows a device of the padded count (default
    ``ceil(count / ndev)``), cut at ``count``: the padding is never coded."""
    per = -(-count // ndev) if per is None else per
    return [(min(d * per, count), min((d + 1) * per, count)) for d in range(ndev)]


def _encode_blocks_vmap(p: BlockParams, inp, n):
    """inp: [G, S, T] u8, n: [G] int32 -> per-block (states [G, S], emit
    bit-pack [G, T, n_slots, S/8], words [G, T, n_slots, S]), G blocks
    coded by one launch a pass."""
    return encode_passes_blocks(p, inp, n)


def _decode_blocks_vmap(p: BlockParams, states, streams, n):
    """states: [G, S] int64, streams: [G, W] int32, n: [G] int32 -> (x [G,
    S], words used [G], out [G, S, T] u8)."""
    return decode_scan_blocks(p, states, streams, n)


def _encode_rows(p: BlockParams, device, buf: np.ndarray, ns: np.ndarray) -> list:
    """The payloads of the blocks ``buf`` [G, S, T] (each zero past its n in
    ``ns``) coded together on ``device``: one launch a pass, K3b over the
    group; the host copies G word counts, G x S states and each block's
    stream, not the words or the mask."""
    states, emit_packed, words = _encode_blocks_vmap(
        p, torch.from_numpy(buf).to(device), torch.from_numpy(ns).to(device))
    n_words, streams = compact_stream(emit_packed, words)
    del emit_packed, words
    states = states.cpu()
    return [_payload_bytes(states[i], nw, streams[i])
            for i, nw in enumerate(n_words.tolist())]


def _decode_rows(p: BlockParams, device, states, streams, n) -> tuple:
    """(x, words used, out) of the payloads' rows decoded together on
    ``device``, as numpy arrays."""
    return tuple(t.cpu().numpy() for t in _decode_blocks_vmap(
        p,
        torch.from_numpy(states.astype(np.int64)).to(device),
        torch.from_numpy(streams.astype(np.int32)).to(device),
        torch.from_numpy(n).to(device),
    ))


def _encode_blocks_sharded(p: BlockParams, mesh: Mesh, inp: np.ndarray, n: np.ndarray,
                           per=None) -> list:
    """inp: [B, S, T] u8, n: [B] int32, the real blocks of a batch that JAX
    pads to a multiple of the mesh -> their payloads in row order.  Device
    d codes its rows (``per`` a device; by default the padded count's) in
    one batched launch a pass."""
    parts = _shard_rows(inp.shape[0], mesh.size, per)

    def shard(dev, rows):
        lo, hi = rows
        return _encode_rows(p, dev, inp[lo:hi], n[lo:hi]) if hi > lo else []

    return [pl for out in _on_mesh(mesh, shard, parts) for pl in out]


def _decode_blocks_sharded(p: BlockParams, mesh: Mesh, states, streams, n,
                           per=None) -> tuple:
    """states: [B, S] u32, streams: [B, W] u16, n: [B] int32, the real rows
    -> (x [B, S], words used [B], out [B, S, T] u8) as numpy, device d
    decoding its rows in one batched launch a pass."""
    parts = _shard_rows(states.shape[0], mesh.size, per)

    def shard(dev, rows):
        lo, hi = rows
        return (_decode_rows(p, dev, states[lo:hi], streams[lo:hi], n[lo:hi])
                if hi > lo else None)

    outs = [o for o in _on_mesh(mesh, shard, parts) if o is not None]
    return tuple(np.concatenate(a) for a in zip(*outs))


def _block_rows(blocks: list, p: BlockParams) -> tuple:
    """The blocks zero-padded into ``[len(blocks), S, T]`` u8, and their n."""
    buf = np.zeros((len(blocks), p.lanes, p.steps), np.uint8)
    ns = np.zeros((len(blocks),), np.int32)
    for i, blk in enumerate(blocks):
        if blk.size > p.capacity:
            raise ValueError(f"block of {blk.size} bytes for capacity {p.capacity}")
        buf[i].reshape(-1)[: blk.size] = blk
        ns[i] = blk.size
    return buf, ns


def encode_blocks(data: np.ndarray, p: BlockParams, mesh: Mesh) -> list:
    """Encode a file's blocks over the mesh; returns the per-block payloads
    in file order (those of sequential ``encode_block`` calls).  Device d
    codes the contiguous rows ``[d * B / ndev, (d + 1) * B / ndev)`` of the
    blocks padded to a multiple of the mesh, all in one batched launch a
    pass: memory grows with the file, as in the JAX package."""
    check_supported(p)
    cap = p.capacity
    nblk = max(1, -(-data.size // cap))
    blocks = [data[b * cap : (b + 1) * cap] for b in range(nblk)]
    return _encode_blocks_sharded(p, mesh, *_block_rows(blocks, p))


def encode_blocks_list(
    blocks: list,
    p: BlockParams,
    mesh: Mesh = None,
    group: int = 0,
    device="cuda",
) -> list:
    """Encode an explicit list of (variable-size) blocks in groups; the
    payloads are those of per-block
    :func:`~comprox_tpu_torch.codec.block.encode_block` calls.  With
    ``mesh`` each group of ``mesh.size`` blocks goes one block a device;
    otherwise ``group`` blocks at a time on ``device``.

    Card memory a block, from the allocations of the encode passes (crz at
    S=512, T=16384, N = S * T = 8 Mi positions; not capped, as in the JAX
    package, where G is not either): the event grid ``ev`` [T, 9, S] int32
    302 MB, ``words`` [T, 3, S] int32 101 MB, ``emit`` 25 MB, the o2 table
    68 MB, o3 17 MB, the bucket table 134 MB, K4's proposals [8, T, S] and
    K5's candidate grids [16, T, S] int32, 268 and 537 MB, the decisions
    [4, T, S] 134 MB: about 1.6 GB a block live at once at most, the
    grids freed pass by pass; K3b's stream, the worst case [T * 3 * S]
    int16, 50 MB (crx 84 MB), beside the words.  crx has five slots (``ev`` 503 MB); crp's
    K13c takes 0.54 GB of scratch a block, looped, each block's pass
    reusing the one before's.
    """
    check_supported(p)
    gsize = mesh.size if mesh is not None else max(group, 1)
    out: list = []
    for g in range(0, len(blocks), gsize):
        buf, ns = _block_rows(blocks[g : g + gsize], p)
        if mesh is not None:
            out += _encode_blocks_sharded(p, mesh, buf, ns, per=1)
        else:
            out += _encode_rows(p, device, buf, ns)
    return out


def _parse_payloads(payloads: list, ns: list, p: BlockParams) -> tuple:
    """The payloads' (states [B, S] u32, streams [B, stream_pad] u16, n [B]
    int32, word counts [B]); a stream longer than ``p.stream_pad`` words is
    refused (the one-block path takes up to ``p.stream_pad_max``)."""
    nblk = len(payloads)
    states = np.full((nblk, p.lanes), RANS_L, np.uint32)
    streams = np.zeros((nblk, p.stream_pad), np.uint16)
    n_arr = np.zeros((nblk,), np.int32)
    n_words = np.zeros((nblk,), np.int64)
    for b, payload in enumerate(payloads):
        nw = int(np.frombuffer(payload[:4], "<u4")[0])
        if nw > p.stream_pad:
            raise ValueError(
                "corrupt block: stream exceeds geometry bound"
            )
        off = 4
        states[b] = np.frombuffer(payload[off : off + 4 * p.lanes], "<u4")
        off += 4 * p.lanes
        streams[b, :nw] = np.frombuffer(payload[off : off + 2 * nw], "<u2")
        n_arr[b] = ns[b]
        n_words[b] = nw
    return states, streams, n_arr, n_words


def decode_blocks(
    payloads: list,
    ns: list,
    p: BlockParams,
    mesh: Mesh = None,
    group: int = 0,
    device="cuda",
) -> np.ndarray:
    """Decode independent block payloads in file order: over ``mesh`` (device
    d the contiguous rows ``[d * B / ndev, (d + 1) * B / ndev)`` of the
    blocks padded to a multiple of the mesh), or all of them on ``device``;
    one batched launch a pass a device.  Returns their bytes end to end.  A
    payload whose stream is longer than ``p.stream_pad`` words is refused,
    and a block whose states do not drain is corrupt."""
    check_supported(p)
    nblk = len(payloads)
    if nblk == 0:
        return np.zeros(0, np.uint8)
    states, streams, n_arr, n_words = _parse_payloads(payloads, ns, p)
    if mesh is not None:
        x, base, out = _decode_blocks_sharded(p, mesh, states, streams, n_arr)
    else:
        x, base, out = _decode_rows(p, device, states, streams, n_arr)
    for b in range(nblk):
        if int(base[b]) != n_words[b] or not (x[b] == RANS_L).all():
            raise ValueError(f"corrupt block {b}")
    pieces = [out[b].reshape(-1)[: ns[b]] for b in range(nblk)]
    return np.concatenate(pieces)
