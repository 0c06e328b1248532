"""K1's time by phase on the card, from an instrumented build.

The crz decode scan K1 (``csrc/decode.cu``) runs T dependent steps of
twelve phases, most of them ended by a CTA-wide barrier.  A build of
``decode.cu`` with ``-DCPX_K1_PROF`` (a variant beside the main library;
the main path never builds it) stamps ``clock64()`` on thread 0 at the end
of each phase and sums each phase's SM cycles over the steps.  A phase
that ends at a barrier is the time until the slowest warp got there; the
three without one (contexts, bucket rows, C event) are thread 0's own.

This module builds that variant at a row-ring depth (``CPX_RING_D`` of
``csrc/ppm_r.cuh``: the rows of the A and B events in flight a warp; 0
issues the rows of a pair of lanes when they are read, with nothing in
flight ahead), decodes a crz archive on the card through the port's decoder,
checks the bytes against ``tests/data/torch_golden.json`` and reports
each phase's share of the cycles and its microseconds a step (the share
times K1's CUDA-event time over the steps).  On the card::

    python -m comprox_tpu_torch.benchmarks.k1_phases [archive] [depth ...]

(default: the 8 MiB flexible crz golden, depths 0 and the build's default).
"""

from __future__ import annotations

import hashlib
import io
import json
import re
import sys
from pathlib import Path

import numpy as np

from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec.container import decode_stream, read_header
from comprox_tpu_torch.utils import build

PHASES = (
    "o1 rescale", "contexts, o2 rows issued", "bucket rows", "A event",
    "A renorm, keys, idx rescale", "B event", "B renorm, len rescale",
    "C event", "byte resolve", "bucket insert", "stores", "adds, finish",
)
GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "data"
ARCHIVE = GOLDEN / "crz_flex_8MiB_S512.cpx"


def default_depth() -> int:
    src = (build.CSRC / "ppm_r.cuh").read_text()
    return int(re.search(r"#define CPX_RING_D (\d+)", src).group(1))


def defines(depth: int) -> tuple:
    return ("-DCPX_K1_PROF", f"-DCPX_RING_D={depth}")


def build_variants(depths, verbose: bool = False) -> list:
    """The instrumented decode.cu at each depth (nvcc all at once)."""
    return build.build_many([(defines(d), ("decode.cu",)) for d in depths], verbose)


def breakdown(archive: bytes, depth: int) -> dict:
    """Decode ``archive`` (a crz archive) on the card through the
    instrumented K1 at ``depth``: ``{"depth", "k1_ms", "steps", "cycles",
    "share", "us_per_step", "sha256"}`` (per phase, in PHASES order)."""
    cp, _ = read_header(io.BytesIO(archive))
    with build.variant(*defines(depth), only=("decode.cu",)):
        lib = build.lib()
        cyc = np.zeros(len(PHASES), np.uint64)
        build.check(lib.cpx_k1_prof_read(cyc.ctypes.data), "cpx_k1_prof_read")
        blk.reset_launch_counts()
        out = io.BytesIO()
        decode_stream(io.BytesIO(archive), out, "cuda")
        k1_ms = blk.kernel_ms()["K1"]
        steps = blk.LAUNCHES["K1"] * cp.block.steps
        build.check(lib.cpx_k1_prof_read(cyc.ctypes.data), "cpx_k1_prof_read")
    if not steps:
        raise AssertionError("the archive's decode launched no K1")
    share = cyc / max(int(cyc.sum()), 1)
    return dict(depth=depth, k1_ms=k1_ms, steps=steps,
                cycles=[int(c) for c in cyc], share=share.tolist(),
                us_per_step=(share * k1_ms * 1e3 / steps).tolist(),
                sha256=hashlib.sha256(out.getvalue()).hexdigest())


def table(results) -> str:
    """The phases as rows, one (share, us/step) column pair per result."""
    head = "phase".ljust(30) + "".join(
        f"  depth {r['depth']}: share, us/step" for r in results)
    rows = [head]
    for k, name in enumerate(PHASES):
        rows.append(name.ljust(30) + "".join(
            f"  {r['share'][k] * 100:13.1f}% {r['us_per_step'][k]:8.2f}"
            for r in results))
    rows.append("K1".ljust(30) + "".join(
        f"  {r['k1_ms']:11.3f} ms {r['k1_ms'] * 1e3 / r['steps']:6.2f}" for r in results))
    return "\n".join(rows)


def run(archive_path=ARCHIVE, depths=None, verbose=False) -> list:
    """Build the variants, decode with each, check the bytes, print the
    table; returns the results."""
    depths = (0, default_depth()) if depths is None else tuple(depths)
    archive_path = Path(archive_path)
    want = json.loads((GOLDEN / "torch_golden.json").read_text()).get(archive_path.name)
    archive = archive_path.read_bytes()
    build_variants(depths, verbose)
    results = [breakdown(archive, d) for d in depths]
    for r in results:
        if want is not None and r["sha256"] != want["input_sha256"]:
            raise AssertionError(f"depth {r['depth']}: decoded bytes differ")
    print(f"K1 by phase, {archive_path.name} ({results[0]['steps']} steps; "
          f"clock64 on thread 0 of the instrumented build):")
    print(table(results))
    return results


if __name__ == "__main__":
    args = sys.argv[1:]
    arc = args.pop(0) if args and not args[0].isdigit() else ARCHIVE
    run(arc, [int(a) for a in args] or None)
