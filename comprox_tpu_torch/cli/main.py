"""Command-line frontend of the PyTorch port — the ``crz``, ``crf``, ``crx`` and
``crp`` codecs.

Counterpart of :mod:`comprox_tpu.cli.main`: the same switches, defaults
and ``make_params``, so an archive written here is the one the JAX
package writes for the same command line.  Supported: ``crz e|d`` (mode
R: ROLZ + PPM + adaptive rANS), ``crf e|d`` (mode F: the fast profile,
LZ77 tokens + static rANS), ``crx e|d`` (mode X: LZ77 distances + PPM +
adaptive rANS) and ``crp e|d`` (mode P: LZP + PPM + adaptive rANS) with
``-b -l -F -p -q -m -c -C -g -j``; encode uses the flexible parse unless ``-f0``
asks for the greedy one (``crp`` has no parse: ``-f0`` and ``-m`` are
accepted and change nothing).  ``-c`` (crz, crx, crp) carries the adaptive
models across blocks; ``-C`` (crz, flexible parse) also the bucket table
and the previous block's bytes, so a match may reach into the block
before.  Decode reads the chain flags from the archive.  ``-g<n>`` codes
n unchained blocks at a time on the card (one launch a pass for the
group; the same bytes as ``-g1``).  ``-j`` codes unchained blocks
data-parallel over every CUDA device, ``-j<n>`` over the first
min(n, device count), a block a device (:mod:`comprox_tpu_torch.parallel.
mesh`; the same bytes as ``-g1``); chain mode refuses it.  Nothing switches
silently to another format.

    python -m comprox_tpu_torch.cli.main crz e in out -b8 -l512
    python -m comprox_tpu_torch.cli.main crz d out in.copy
    python -m comprox_tpu_torch.cli.main crz e in out -b8 -l512 -C
    python -m comprox_tpu_torch.cli.main crf e in out -b8 -l512
    python -m comprox_tpu_torch.cli.main crx e in out -b8 -l512 -c
    python -m comprox_tpu_torch.cli.main crp e in out -b8 -l512
    python -m comprox_tpu_torch.cli.main crz e in out -b8 -l512 -g4
    python -m comprox_tpu_torch.cli.main crz e in out -b8 -l512 -j

The command line runs on the first CUDA device and fails without one; the
library call :func:`run` takes the device explicitly.  With no codec name
first, the command line is ``crp``'s, as the JAX package's is.  On the card
a block takes up to 8192 lanes (``-l``): above 1024 the step scans run as
one cluster of CTAs, and crf's rANS loops at several lanes a thread.
"""

from __future__ import annotations

import io
import sys
import time

import numpy as np

from comprox_tpu_torch.codec.block import BlockParams
from comprox_tpu_torch.codec.container import (
    ContainerParams,
    decode_stream,
    encode_stream,
)
from comprox_tpu_torch.utils.profiling import Progress

USAGE = """\
usage: {prog} e|d <input> <output> [switches]   ('-' = stdin/stdout)
switches:
  -b<n>  block size in MB (default 16)
  -l<n>  lanes per block (default 256)
  -F     enable content filters
  -p     dictionary precompress only
  -q     quiet mode
  -j[n]  code blocks data-parallel over n (default: all) devices
  -g<n>  batch n blocks per launch (block batching on one card: one
         launch a pass codes n blocks, a CTA or cluster a block)
  -m<n>  match search depth (default 40 -> top-4 bucket candidates)
  -f0    greedy+lazy parsing instead of flexible parsing
  -c     chain mode: carry the adaptive models across blocks
  -C     chain mode v2 (crz): also carry the bucket table and the
         previous block's bytes
"""

CODEC_BYTE = {"crp": b"P", "crx": b"X", "crz": b"R", "crf": b"F"}


def parse_args(argv):
    prog = argv[0] if argv else "crp"
    args = [a for a in argv[1:] if a == "-" or not a.startswith("-")]
    switches = [a for a in argv[1:] if a != "-" and a.startswith("-")]
    opts = {"block_mb": 16, "lanes": 256, "filters": False, "quiet": False,
            "precomp": False, "window": 250, "depth": 40, "flexible": True,
            "chain": False, "chain_match": False, "group": 1, "jobs": 0}
    for s in switches:
        if s == "-c":
            opts["chain"] = True
        elif s == "-C":
            opts["chain"] = opts["chain_match"] = True
        elif s.startswith("-b"):
            opts["block_mb"] = float(s[2:])
        elif s.startswith("-l"):
            opts["lanes"] = int(s[2:])
        elif s == "-F":
            opts["filters"] = True
        elif s == "-p":
            opts["precomp"] = True
        elif s == "-q":
            opts["quiet"] = True
        elif s.startswith("-g"):
            opts["group"] = max(1, int(s[2:] or "1"))
        elif s.startswith("-j"):  # -j: every device (-1), -j<n>: n of them
            opts["jobs"] = int(s[2:] or "0") or -1
        elif s.startswith("-f"):
            opts["flexible"] = s[2:] != "0"
        elif s.startswith("-m"):
            opts["depth"] = max(1, int(s[2:] or "40"))
        else:
            raise SystemExit(USAGE.format(prog=prog))
    if len(args) != 3 or args[0] not in ("e", "d"):
        raise SystemExit(USAGE.format(prog=prog))
    return prog, args[0], args[1], args[2], opts


_MODE = {"crz": "R", "crf": "F", "crx": "X", "crp": "P"}


def make_params(codec_name: str, opts) -> ContainerParams:
    """The JAX package's make_params: the same BlockParams per codec."""
    if codec_name not in _MODE:
        raise ValueError(
            f"unknown codec {codec_name!r}: crz, crf, crx and crp are the codecs"
        )
    mode = _MODE[codec_name]
    lanes = opts["lanes"]
    cap = int(opts["block_mb"] * 1048576)
    if mode in ("X", "F"):  # the distance code space caps a block at 16 MiB
        cap = min(cap, 1 << 24)
    bp = BlockParams(
        lanes=lanes,
        steps=max(1, cap // lanes),
        mode=mode,
        min_len={"P": 4, "R": 5, "X": 6, "F": 6}[mode],
        window=opts.get("window", 250),
        top_k=max(1, min(8, round(opts.get("depth", 40) / 10))),
        flexible=opts.get("flexible", True),
        rolz_ctx_bytes=4 if (mode in ("R", "X") and cap >= 4 * 1048576) else 3,
        rolz_dec=2 if mode == "R" else 1,
        short_depth=0,
        chain_match=opts.get("chain_match", False),
    )
    return ContainerParams(codec=CODEC_BYTE[codec_name], block=bp)


def log(quiet, msg):
    if not quiet:
        print(msg, file=sys.stderr)


def jobs_mesh(jobs: int, device):
    """The mesh of ``-j[n]`` (``jobs``: -1 for every device, else n) for a
    run on ``device``, or None without ``-j``: on a card the first
    min(n, device count) CUDA devices; on the CPU the one device."""
    if not jobs:
        return None
    import torch

    from comprox_tpu_torch.parallel.mesh import make_mesh

    if torch.device(device).type != "cuda":
        return make_mesh(devices=[device])
    nd = torch.cuda.device_count()
    return make_mesh(None if jobs < 0 else min(jobs, nd))


def run(codec_name: str, argv, device) -> int:
    """Run one ``crz``, ``crf``, ``crx`` or ``crp`` ``e|d`` command line on
    ``device``."""
    import torch

    prog, mode, inp, outp, opts = parse_args([codec_name] + list(argv))
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("comprox_tpu_torch runs on a CUDA device; none found")
    quiet = opts["quiet"]
    meter = Progress(enabled=not quiet)
    mesh = jobs_mesh(opts["jobs"], device)
    t0 = time.time()
    if mode == "e":
        cp = make_params(codec_name, opts)
        data = (
            np.frombuffer(sys.stdin.buffer.read(), np.uint8)
            if inp == "-" else np.fromfile(inp, np.uint8)
        )
        f = sys.stdout.buffer if outp == "-" else open(outp, "wb")
        try:
            csize = encode_stream(
                data, f, cp, device, filters=opts["filters"],
                precomp_only=opts["precomp"], chain=opts["chain"],
                group=opts["group"], mesh=mesh, progress=meter.update,
            )
        finally:
            if outp != "-":
                f.close()
        dt = max(time.time() - t0, 1e-9)
        log(quiet, f"encode-speed: {data.size / dt / 1e6:.2f} MB/s")
        log(quiet, f"cost-time:    {dt:.3f} s")
        if data.size:
            log(quiet, f"compress-ratio: {csize / data.size:.4f}")
            log(quiet, f"bits-per-byte:  {csize * 8 / data.size:.3f}")
    else:
        if codec_name not in _MODE:
            make_params(codec_name, opts)  # raises: no such codec
        # seekable input: -g prescans the block headers, then seeks back
        f = open(inp, "rb") if inp != "-" else io.BytesIO(sys.stdin.buffer.read())
        g = sys.stdout.buffer if outp == "-" else open(outp, "wb")
        try:
            total = decode_stream(f, g, device, group=opts["group"], mesh=mesh)
        finally:
            if inp != "-":
                f.close()
            if outp != "-":
                g.close()
        dt = max(time.time() - t0, 1e-9)
        log(quiet, f"decode-speed: {total / dt / 1e6:.2f} MB/s")
        log(quiet, f"cost-time:    {dt:.3f} s")
    return 0


def main(argv=None, device="cuda") -> int:
    """The command line (``sys.argv`` by default) on ``device``; with no
    codec name first it is ``crp``'s."""
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in CODEC_BYTE:
        return run(argv[0], argv[1:], device)
    return run("crp", argv, device)


if __name__ == "__main__":
    raise SystemExit(main())
