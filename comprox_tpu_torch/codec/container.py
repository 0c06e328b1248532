"""Container format and stream coder, codecs R (crz), F (crf), X (crx) and
P (crp), unchained or chained.

Counterpart of :mod:`comprox_tpu.codec.container`: the same bytes for the
same input (magic ``CPXTPU02``, header with CRC and the model-knob
fingerprint, optional dictionary blob, filter spans, per-block headers
with CRC, the stored-block fallback, the zero sentinel).  The dictionary
and filter stages are the port's own copies of the JAX package's host
modules (codec/dictionary.py, ops/filters.py).

The schedule is the JAX package's.  A file of several blocks is coded
with one block in flight: block i+1's ``start`` (codec/block.py,
codec/fast.py: the kernels enqueued, nothing read back) comes before
block i's ``finish`` (its event waited on, its result fetched, packed and
written), so the card codes block i+1 while the host finishes block i;
decode the same way.  The next block's filters and dictionary
substitution run on a worker thread meanwhile.

Chain mode (``F_CHAIN``: the PPM models carry across blocks) and chain
mode v2 (``F_CHAIN_MATCH``, crz: the bucket table and the previous block's
bytes too): a block stored raw leaves the chain state as it was, on both
sides.  Encode speculates (``CPX_CHAIN_SPEC=1``, the default): block i+1
starts from block i's state1 before block i's payload is known, and starts
again from the committed state when block i is stored raw; under ``0``
each block is finished before the next starts (the sequential control).
Decode needs no speculation (a stored block is known from its header).

Block batching (``group`` > 1, the CLI's ``-g``): unchained blocks go
through the codec ``group`` at a time (:mod:`comprox_tpu_torch.parallel.
mesh`; mode F, which has no block axis, through its one-in-flight loop),
with the same bytes as one at a time.  Decode prescans the block headers
and decodes group g + 1 on a worker thread while the caller writes group
g.  Chained archives decode one block at a time whatever ``group`` says.
A ``mesh`` (the CLI's ``-j``) sets the group to ``mesh.size`` blocks, one
a device, and overrides ``group``; mode F goes around it (encode
``group=mesh.size`` on ``device``, decode one block at a time), and chain
mode refuses it.

``encode_fn`` and ``decode_fn`` (a block's bytes -> its payload; a
payload and its n -> the bytes) replace the pipelined codec, as in the
JAX package: the one-block codec given there runs the sequential
schedule.  Chain mode refuses ``encode_fn``; chained decode ignores
``decode_fn``.
"""

from __future__ import annotations

import itertools
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import BinaryIO, Callable, Optional

import numpy as np

from comprox_tpu_torch.codec import dictionary as dic
from comprox_tpu_torch.ops import filters as flt
from comprox_tpu_torch.codec.block import (
    BlockParams,
    decode_block,
    decode_block_chained_start,
    decode_block_finish,
    decode_block_start,
    encode_block,
    encode_block_chained_finish,
    encode_block_chained_start,
    encode_block_finish,
    encode_block_start,
    init_chain_tables,
)
from comprox_tpu_torch.codec.fast import (
    decode_block_fast,
    decode_block_fast_finish,
    decode_block_fast_start,
    decode_blocks_fast,
    encode_block_fast,
    encode_block_fast_finish,
    encode_block_fast_start,
    encode_blocks_fast,
)
from comprox_tpu_torch.models.ppm import format_fingerprint
from comprox_tpu_torch.parallel.mesh import decode_blocks, encode_blocks_list

MAGIC = b"CPXTPU02"
_OLD_MAGICS = (b"CPXTPU01",)
BF_STORED = 1
BF_FILTERED = 2
BF_DICT = 4
F_DICT = 1
F_FILTER = 2
F_CHAIN = 4
F_CHAIN_MATCH = 8
_HDR_FMT = "<BHIBBBBBBBBI"
HEADER_LEN = 8 + 1 + struct.calcsize(_HDR_FMT) + 4
BLKHDR = "<IIBI"  # raw_n, payload len, flags, payload CRC32
BLKHDR_LEN = struct.calcsize(BLKHDR)


@dataclass(frozen=True)
class ContainerParams:
    codec: bytes = b"R"
    block: BlockParams = field(default_factory=lambda: BlockParams(mode="R"))


_CODEC_MODE = {b"R": "R", b"F": "F", b"X": "X", b"P": "P"}


def _codec_mode(codec: bytes) -> str:
    """The block mode a codec byte stands for; raises for an unknown one."""
    if codec not in _CODEC_MODE:
        raise ValueError(
            f"unknown codec byte {codec!r}: R (crz), F (crf), X (crx) and "
            "P (crp) are the codecs"
        )
    return _CODEC_MODE[codec]


def _check_codec(cp: ContainerParams) -> None:
    mode = _codec_mode(cp.codec)
    if cp.block.mode != mode:
        raise ValueError(
            f"codec {cp.codec!r} codes mode {mode!r} blocks, "
            f"not {cp.block.mode!r}"
        )


def _block_encoder(bp: BlockParams, device):
    """Per-mode block encoder (the static-table fast profile has its own
    passes; see codec/fast.py)."""
    fn = encode_block_fast if bp.mode == "F" else encode_block
    return lambda blk: fn(blk, bp, device)


def _block_decoder(bp: BlockParams, device):
    fn = decode_block_fast if bp.mode == "F" else decode_block
    return lambda payload, n: fn(payload, n, bp, device)


def _block_encoder_async(bp: BlockParams, device):
    """``(start, finish)`` of the pipelined path: ``start`` enqueues a
    block's kernels and returns at once, ``finish`` waits for that block,
    fetches and packs its payload (container.py::_block_encoder_async)."""
    if bp.mode == "F":
        return (lambda blk: encode_block_fast_start(blk, bp, device),
                encode_block_fast_finish)
    return lambda blk: encode_block_start(blk, bp, device), encode_block_finish


def _block_decoder_async(bp: BlockParams, device):
    """``(start, finish)`` of the pipelined decode
    (container.py::_block_decoder_async)."""
    if bp.mode == "F":
        return (lambda payload, n: decode_block_fast_start(payload, n, bp, device),
                decode_block_fast_finish)
    return (lambda payload, n: decode_block_start(payload, n, bp, device),
            decode_block_finish)


def write_header(f: BinaryIO, cp: ContainerParams, flags: int = 0) -> None:
    b = cp.block
    body = cp.codec + struct.pack(
        _HDR_FMT, flags, b.lanes, b.steps, b.o3_bits, b.min_len,
        1 if b.match else 0, b.rolz_bits, b.rolz_depth, b.rolz_ctx_bytes,
        b.short_depth, b.rolz_dec, format_fingerprint(),
    )
    f.write(MAGIC + body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF))


def read_header(f: BinaryIO) -> tuple[ContainerParams, int]:
    magic = f.read(8)
    if magic != MAGIC:
        if magic in _OLD_MAGICS:
            raise ValueError(
                f"incompatible archive version {magic!r}: this build reads "
                f"{MAGIC!r} archives (the stream format changed)"
            )
        raise ValueError(f"bad magic {magic!r}: not a comprox_tpu archive")
    body = f.read(1 + struct.calcsize(_HDR_FMT))
    crc_raw = f.read(4)
    if len(body) < 1 + struct.calcsize(_HDR_FMT) or len(crc_raw) < 4:
        raise ValueError("truncated archive: short container header")
    if struct.unpack("<I", crc_raw)[0] != zlib.crc32(body) & 0xFFFFFFFF:
        raise ValueError("corrupt archive: container header CRC mismatch")
    codec = body[:1]
    (
        flags, lanes, steps, o3_bits, min_len, match, rolz_bits,
        rolz_depth, rolz_ctx_bytes, short_depth, rolz_dec, knobs_crc,
    ) = struct.unpack(_HDR_FMT, body[1:])
    if knobs_crc != format_fingerprint():
        raise ValueError(
            "archive was encoded with different model constants "
            "(CPX_* env knobs); decode in a matching environment"
        )
    if (flags & F_CHAIN_MATCH) and not (flags & F_CHAIN):
        raise ValueError("corrupt archive: F_CHAIN_MATCH without F_CHAIN")
    bp = BlockParams(
        lanes=lanes, steps=steps, mode=_codec_mode(codec), match=bool(match),
        min_len=min_len, o3_bits=o3_bits, rolz_bits=rolz_bits,
        rolz_depth=rolz_depth, rolz_ctx_bytes=rolz_ctx_bytes,
        short_depth=short_depth, rolz_dec=rolz_dec,
        chain_match=bool(flags & F_CHAIN_MATCH),
    )
    return ContainerParams(codec=codec, block=bp), flags


def encode_stream(
    src: np.ndarray,
    dst: BinaryIO,
    cp: ContainerParams,
    device,
    filters: bool = False,
    dictionary: bool = True,
    precomp_only: bool = False,
    progress: Optional[Callable[[int, int], None]] = None,
    chain: bool = False,
    group: int = 1,
    encode_fn: Optional[Callable] = None,
    mesh=None,
) -> int:
    """Encode ``src`` into ``dst`` on ``device``; returns the archive size.

    The same bytes as ``comprox_tpu.codec.container.encode_stream`` with
    the same arguments.  One block at a time (``group`` 1, no ``mesh``, no
    ``encode_fn``) runs the pipelined schedule, one block in flight;
    ``group`` > 1 codes that many blocks a launch; ``mesh`` codes groups of
    ``mesh.size`` blocks, one a device (mode F: ``mesh.size`` at a time on
    ``device``); ``encode_fn`` codes each block by itself.  ``precomp_only`` runs just the dictionary stage and
    stores the substituted bytes.  ``chain`` carries the PPM models across
    blocks (under the block parameters' ``chain_match`` also the bucket
    table and the previous block's bytes); a block stored raw leaves the
    chain state as it was.  The next group's filters and dictionary
    substitution run on a worker thread while the current group is coded.
    """
    _check_codec(cp)
    if precomp_only:
        filters = False  # stored blocks carry no filter-span metadata
        chain = False  # nothing is modelled
    if chain:
        if mesh is not None or group > 1:
            raise ValueError(
                "chain mode carries model state across blocks — "
                "incompatible with mesh/group block parallelism"
            )
        if cp.block.mode == "F" or encode_fn is not None:
            raise ValueError(
                "chain mode requires an adaptive-model codec (R/X/P)"
            )
        spec = os.environ.get("CPX_CHAIN_SPEC", "1")
        if spec not in ("0", "1"):
            raise NotImplementedError(
                f"CPX_CHAIN_SPEC={spec!r} is not ported to comprox_tpu_torch "
                "(only '0' or '1', which code the same bytes)"
            )
    if cp.block.chain_match and not chain:
        raise ValueError("chain_match requires chain mode (encode chain=True)")
    wd = dic.build_dictionary(src) if dictionary else None
    flags = (
        (F_FILTER if filters else 0)
        | (F_DICT if wd else 0)
        | (F_CHAIN if chain else 0)
        | (F_CHAIN_MATCH if (chain and cp.block.chain_match) else 0)
    )
    write_header(dst, cp, flags=flags)
    written = HEADER_LEN
    if wd is not None:
        blob = dic.pack_dict(wd)
        coded = dic.blob_encode(blob)
        crc = zlib.crc32(blob) & 0xFFFFFFFF
        if len(coded) < len(blob):
            dst.write(struct.pack("<III", len(blob), len(coded), crc) + coded)
            written += 12 + len(coded)
        else:
            dst.write(struct.pack("<III", len(blob), 0, crc) + blob)
            written += 12 + len(blob)

    cap = cp.block.capacity

    def stage(raw_blk):
        blk, prefix, bflags = raw_blk, b"", 0
        if filters:
            spans = flt.detect_spans(blk)
            if spans:
                blk = flt.apply_spans(blk, spans, encode=True)
                prefix = flt.pack_spans(spans)
                bflags |= BF_FILTERED
        if wd is not None:
            sub = dic.dict_encode(blk, wd)
            if sub.size < blk.size and sub.size <= cap:
                blk = sub
                prefix += struct.pack("<I", sub.size)
                bflags |= BF_DICT
        return raw_blk, blk, prefix, bflags

    def stage_group(raws):
        return [stage(raw) for raw in raws]

    total, done = src.size, 0
    state = init_chain_tables(cp.block, device) if chain else None

    def write_group(staged, payloads):
        """Write the blocks; True iff the last one written advanced the
        chain state (was not stored raw): the speculative schedule checks
        its guess on this flag."""
        nonlocal written, done, state
        advanced = False
        for (raw_blk, blk, prefix, bflags), coded in zip(staged, payloads):
            advanced = False
            if chain:
                coded, state1 = coded
            payload = prefix + coded
            if len(payload) >= raw_blk.size:  # stored fallback
                payload, bflags = raw_blk.tobytes(), BF_STORED
            elif chain:
                state = state1  # the models advance past the block
                advanced = True
            dst.write(struct.pack(BLKHDR, raw_blk.size, len(payload), bflags,
                                  zlib.crc32(payload) & 0xFFFFFFFF))
            dst.write(payload)
            written += BLKHDR_LEN + len(payload)
            done += raw_blk.size
            if progress:
                progress(done, total)
        return advanced

    group_n = mesh.size if mesh is not None else max(int(group), 1)
    # one block in flight: block i+1's start comes before block i's finish
    pipelined = (not precomp_only and not chain and encode_fn is None
                 and mesh is None and group_n == 1)
    if pipelined:
        enc_start, enc_finish = _block_encoder_async(cp.block, device)
    pending = None  # (staged, [handles]) awaiting finish
    pending_c = None  # chained: (staged, handle, state1)
    spec_state = state  # the speculative chain head
    blocks_it = (src[off : off + cap] for off in range(0, src.size, cap))
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        nxt = list(itertools.islice(blocks_it, group_n))
        fut = pool.submit(stage_group, nxt) if nxt else None
        while fut is not None:
            staged = fut.result()
            nxt = list(itertools.islice(blocks_it, group_n))
            fut = pool.submit(stage_group, nxt) if nxt else None
            blks = [blk for _, blk, _, _ in staged]
            if precomp_only:
                for raw_blk, blk, prefix, bflags in staged:
                    body = prefix + blk.tobytes()
                    dst.write(struct.pack(BLKHDR, raw_blk.size, len(body),
                                          bflags | BF_STORED,
                                          zlib.crc32(body) & 0xFFFFFFFF))
                    dst.write(body)
                    written += BLKHDR_LEN + len(body)
                continue
            if pipelined:
                handles = [enc_start(blk) for blk in blks]
                if pending is not None:
                    write_group(pending[0], [enc_finish(h) for h in pending[1]])
                pending = (staged, handles)
                continue
            if chain:
                # Speculation: start this block from the previous block's
                # state1 (kernels still queued; the stream orders them)
                # before the previous payload is known.  Only a stored
                # fallback falsifies the guess; the block then starts again
                # from the committed state, which write_group kept.
                # CPX_CHAIN_SPEC=0 finishes each block before the next.
                if os.environ.get("CPX_CHAIN_SPEC", "1") == "0":
                    if pending_c is not None:
                        st_p, h_p, s1_p = pending_c
                        write_group(st_p, [(encode_block_chained_finish(h_p), s1_p)])
                        pending_c = None
                    spec_state = state
                handle, state1 = encode_block_chained_start(
                    blks[0], cp.block, spec_state, device)
                if pending_c is not None:
                    st_p, h_p, s1_p = pending_c
                    if not write_group(st_p, [(encode_block_chained_finish(h_p), s1_p)]):
                        handle, state1 = encode_block_chained_start(
                            blks[0], cp.block, state, device)
                spec_state = state1
                pending_c = (staged, handle, state1)
                continue
            if encode_fn is not None:
                payloads = [encode_fn(blk) for blk in blks]
            elif cp.block.mode == "F":  # no block axis: one block in flight
                payloads = encode_blocks_fast(blks, cp.block, group_n, device)
            else:
                payloads = encode_blocks_list(blks, cp.block, mesh=mesh,
                                              group=group_n, device=device)
            write_group(staged, payloads)
        if pending is not None:  # drain the pipelined tail block
            write_group(pending[0], [enc_finish(h) for h in pending[1]])
        if pending_c is not None:  # drain the chained tail block
            st_p, h_p, s1_p = pending_c
            write_group(st_p, [(encode_block_chained_finish(h_p), s1_p)])
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    dst.write(struct.pack(BLKHDR, 0, 0, 0, 0))
    return written + BLKHDR_LEN


def decode_stream(
    src: BinaryIO,
    dst: BinaryIO,
    device,
    progress: Optional[Callable[[int, int], None]] = None,
    group: int = 1,
    decode_fn: Optional[Callable] = None,
    mesh=None,
) -> int:
    """Decode a codec-R, codec-F, codec-X or codec-P archive, unchained or
    chained, on ``device``; returns the raw byte count.  A stored block
    never touches the chain state.  The blocks decode with one in flight
    (chained ones too: the next block starts from the state1 of the one
    before).  With ``group`` > 1 or a ``mesh`` and no ``decode_fn`` an
    unchained archive's coded blocks decode ``group`` (``mesh.size``, one a
    device) at a time (a prescan of the block headers, then
    :func:`_make_mesh_decode_fn`); a mode-F archive under a mesh decodes
    one block at a time, as in the JAX package; ``decode_fn`` decodes each
    block by itself; a chained archive ignores all three."""
    cp, flags = read_header(src)
    chained = bool(flags & F_CHAIN)
    if chained and cp.block.mode == "F":
        raise ValueError("corrupt archive: chain mode requires an "
                         "adaptive-model codec (R/X/P), not F")
    state = init_chain_tables(cp.block, device) if chained else None
    wd = None
    if flags & F_DICT:
        hdr = src.read(12)
        if len(hdr) < 12:
            raise ValueError("truncated archive: short dictionary header")
        blob_len, clen, crc = struct.unpack("<III", hdr)
        blob = dic.blob_decode(src.read(clen), blob_len) if clen else src.read(blob_len)
        if len(blob) != blob_len or zlib.crc32(blob) & 0xFFFFFFFF != crc:
            raise ValueError("corrupt archive: dictionary blob CRC mismatch")
        wd = dic.unpack_dict(blob)
    close = None
    if ((mesh is not None or group > 1) and decode_fn is None and not chained
            and (cp.block.mode != "F" or mesh is None)):
        # the prescan starts at the first block header (after the blob)
        batched = _make_mesh_decode_fn(src, cp, mesh, group, device)
        if batched is not None:
            decode_fn, close = batched
    if chained:
        decode_fn = None  # the carried state forces one block at a time
    dec_start = dec_finish = None
    if decode_fn is None and not chained:
        dec_start, dec_finish = _block_decoder_async(cp.block, device)
    elif chained:
        dec_finish = decode_block_finish
    total = 0
    # (started handle or None, bytes or None, dictionary-coded, spans, raw_n).
    # With one block in flight, block i+1's payload CRC (checked when it is
    # read, before its start) runs before block i's drain and size checks in
    # finish_item: corruption in block i can surface as block i+1's error
    # first.  Both raise ValueError and stop the decode; no wrong bytes are
    # written (container.py::decode_stream).
    pending = None

    def finish_item(item):
        nonlocal total
        started, out, dicted, spans, raw_n = item
        if started is not None:
            out = dec_finish(started)
        if dicted:
            out = dic.dict_decode(out, wd)
        if out.size != raw_n:
            raise ValueError(
                f"corrupt block: decoded {out.size} bytes, header says {raw_n}"
            )
        if spans:
            out = flt.apply_spans(out, spans, encode=False)
        dst.write(out.tobytes())
        total += raw_n
        if progress:
            progress(total, total)

    try:
        while True:
            hdr = src.read(BLKHDR_LEN)
            if len(hdr) < BLKHDR_LEN:
                raise ValueError("truncated archive: missing block header")
            raw_n, blen, bflags, crc = struct.unpack(BLKHDR, hdr)
            if raw_n == 0:
                break
            payload = src.read(blen)
            if len(payload) < blen:
                raise ValueError("truncated archive: short block payload")
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                raise ValueError("corrupt archive: block payload CRC mismatch")
            if bflags & BF_DICT and wd is None:
                raise ValueError(
                    "corrupt archive: block flagged dictionary-coded but the "
                    "header carries no dictionary"
                )
            spans = []
            if bflags & BF_FILTERED and not bflags & BF_STORED:
                spans, off = flt.unpack_spans(payload)
                payload = payload[off:]
            if bflags & BF_STORED:
                if bflags & BF_DICT:  # precomp-only block: expand the dictionary
                    out = dic.dict_decode(np.frombuffer(payload[4:], np.uint8), wd)
                else:
                    out = np.frombuffer(payload, np.uint8)
                item = (None, out, False, spans, raw_n)
            else:
                n_dec = raw_n
                if bflags & BF_DICT:
                    if len(payload) < 4:
                        raise ValueError("corrupt block: missing dict-size prefix")
                    (n_dec,) = struct.unpack("<I", payload[:4])
                    payload = payload[4:]
                dicted = bool(bflags & BF_DICT)
                if chained:
                    started, state = decode_block_chained_start(
                        payload, n_dec, cp.block, state, device)
                    item = (started, None, dicted, spans, raw_n)
                elif dec_start is not None:
                    item = (dec_start(payload, n_dec), None, dicted, spans, raw_n)
                else:
                    item = (None, decode_fn(payload, n_dec), dicted, spans, raw_n)
            if pending is not None:
                finish_item(pending)
                pending = None
            if item[0] is not None:
                pending = item  # keep the started block in flight
            else:
                finish_item(item)
        if pending is not None:
            finish_item(pending)
    finally:
        if close is not None:
            close()
    return total


def _make_mesh_decode_fn(src: BinaryIO, cp: ContainerParams, mesh, group: int,
                         device):
    """Prescan the rest of the archive (``src`` seeks back to where it
    was) and decode its coded blocks ``group`` at a time (over ``mesh``:
    ``mesh.size``, one a device) as the caller
    asks for them, group g + 1 on a worker thread while the caller
    post-processes group g; returns ``(decode_fn, close)``: decode_fn serves
    the blocks in order, close ends the worker, whether or not every block
    was served (None when no block is coded).  Exceptions of the worker reach
    the caller through ``fut.result()``
    (comprox_tpu/codec/container.py::_make_mesh_decode_fn)."""
    start = src.tell()
    jobs = []  # (payload after its prefixes, n to decode)
    while True:
        hdr = src.read(BLKHDR_LEN)
        if len(hdr) < BLKHDR_LEN:
            break
        raw_n, blen, bflags, _crc = struct.unpack(BLKHDR, hdr)
        if raw_n == 0:
            break
        payload = src.read(blen)
        if bflags & BF_STORED:
            continue
        if bflags & BF_FILTERED:
            _spans, off = flt.unpack_spans(payload)
            payload = payload[off:]
        n_dec = raw_n
        if bflags & BF_DICT:
            if len(payload) < 4:
                raise ValueError("corrupt block: missing dict-size prefix")
            (n_dec,) = struct.unpack("<I", payload[:4])
            payload = payload[4:]
        jobs.append((payload, n_dec))
    src.seek(start)
    if not jobs:
        return None
    group = mesh.size if mesh is not None else max(group, 1)

    def dec(grp):
        payloads, ns = [p for p, _ in grp], [n for _, n in grp]
        if cp.block.mode == "F":  # no block axis: one block in flight
            return decode_blocks_fast(payloads, ns, cp.block, group, device)
        return decode_blocks(payloads, ns, cp.block, mesh=mesh, group=group,
                             device=device)

    pool = ThreadPoolExecutor(max_workers=1)

    def results():
        fut = pool.submit(dec, jobs[0:group])
        for g in range(0, len(jobs), group):
            outs = fut.result()
            if g + group < len(jobs):
                fut = pool.submit(dec, jobs[g + group : g + 2 * group])
            off = 0
            for _, n in jobs[g : g + group]:
                yield outs[off : off + n]
                off += n

    it = results()

    def decode_fn(payload, n):
        out = next(it)
        if out.size != n:
            raise ValueError(f"corrupt block: decoded {out.size} bytes, expected {n}")
        return out

    def close():  # ends the prefetch: no group is decoded after it returns
        it.close()
        pool.shutdown(wait=True, cancel_futures=True)

    return decode_fn, close
