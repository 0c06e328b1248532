"""Block batching on one card: G independent blocks coded by one launch a
pass (the CLI's ``-g``).

Counterpart of the single-device half of :mod:`comprox_tpu.parallel.mesh`:
``_encode_blocks_vmap`` and ``_decode_blocks_vmap`` (the JAX package's vmap
of ``_encode_passes`` and ``_decode_scan`` over a leading block axis) and
the list APIs above them, ``encode_blocks_list`` and ``decode_blocks``, with
the same names, arguments, errors and payload bytes: every block's payload
is the one :func:`comprox_tpu_torch.codec.block.encode_block` writes for it
alone, because each block has tables of its own.

On the card each pass is one launch over the group (a CTA or a cluster of
CTAs a block: ``codec/block.py``'s block axis); the JAX package pads a
group to ``group`` blocks of n = 0 because jit fixes the shapes, and the
port launches only the group's real blocks, which changes no byte.  The
sharded forms (``mesh=``, ``-j``) are ROADMAP item 15b.
"""

from __future__ import annotations

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


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "comprox_tpu_torch codes blocks on one card: sharding blocks over "
            "devices (mesh=, -j) is not ported (ROADMAP item 15b)"
        )


def _encode_blocks_vmap(p: BlockParams, inp, n):
    """inp: [G, S, T] u8, n: [G] int32 -> per-block (states [G, S], emit
    bit-pack [G, T, n_slots, S/8], words [G, T, n_slots, S]), G blocks
    coded by one launch a pass."""
    return encode_passes_blocks(p, inp, n)


def _decode_blocks_vmap(p: BlockParams, states, streams, n):
    """states: [G, S] int64, streams: [G, W] int32, n: [G] int32 -> (x [G,
    S], words used [G], out [G, S, T] u8)."""
    return decode_scan_blocks(p, states, streams, n)


def encode_blocks_list(
    blocks: list,
    p: BlockParams,
    mesh=None,
    group: int = 0,
    device="cuda",
) -> list:
    """Encode an explicit list of (variable-size) blocks ``group`` at a
    time on ``device``; the payloads are those of per-block
    :func:`~comprox_tpu_torch.codec.block.encode_block` calls.

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
    _no_mesh(mesh)
    check_supported(p)
    gsize = max(group, 1)
    out: list = []
    for g in range(0, len(blocks), gsize):
        grp = blocks[g : g + gsize]
        buf = np.zeros((len(grp), p.lanes, p.steps), np.uint8)
        ns = np.zeros((len(grp),), np.int32)
        for i, blk in enumerate(grp):
            if blk.size > p.capacity:
                raise ValueError(f"block of {blk.size} bytes for capacity {p.capacity}")
            buf[i].reshape(-1)[: blk.size] = blk
            ns[i] = blk.size
        states, emit_packed, words = _encode_blocks_vmap(
            p, torch.from_numpy(buf).to(device), torch.from_numpy(ns).to(device))
        # K3b over the group: the host copies G word counts, G x S states
        # and each block's stream, not the words or the mask
        n_words, streams = compact_stream(emit_packed, words)
        del emit_packed, words
        states = states.cpu()
        for i, nw in enumerate(n_words.tolist()):
            out.append(_payload_bytes(states[i], nw, streams[i]))
    return out


def decode_blocks(
    payloads: list,
    ns: list,
    p: BlockParams,
    mesh=None,
    group: int = 0,
    device="cuda",
) -> np.ndarray:
    """Decode independent block payloads in file order on ``device``, all
    of them in one batched launch a pass; returns their bytes end to end.
    A payload whose stream is longer than ``p.stream_pad`` words is
    refused (the one-block path takes up to ``p.stream_pad_max``), and a
    block whose states do not drain is corrupt."""
    _no_mesh(mesh)
    check_supported(p)
    nblk = len(payloads)
    if nblk == 0:
        return np.zeros(0, np.uint8)
    states = np.zeros((nblk, p.lanes), np.uint32)
    states[:, :] = RANS_L
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
    x, base, out = (t.cpu().numpy() for t in _decode_blocks_vmap(
        p,
        torch.from_numpy(states.astype(np.int64)).to(device),
        torch.from_numpy(streams.astype(np.int32)).to(device),
        torch.from_numpy(n_arr).to(device),
    ))
    for b in range(nblk):
        if int(base[b]) != n_words[b] or not (x[b] == RANS_L).all():
            raise ValueError(f"corrupt block {b}")
    pieces = [out[b].reshape(-1)[: ns[b]] for b in range(nblk)]
    return np.concatenate(pieces)
