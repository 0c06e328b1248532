"""The row ring's depth against the six kernels that read through it.

The A and B events of the step scans (``csrc/ppm_r.cuh``: K1, K12d, K13d
decode; K2, K12e, K13e encode) read their o2 and o1 rows through a
per-warp ring of ``CPX_RING_D`` shared-memory slots (but for the A event
of encode's 512-thread arm, which takes its rows from a ring of four,
``RING4_D``, four lanes a round).  This module builds
the whole kernel library at each depth asked for (a variant beside the
main library; every nvcc started together), then, for each depth in the
order given, decodes the 8 MiB crz, crx and crp goldens on the card and
encodes their corpora again, checks every archive's SHA-256 against
``tests/data/torch_golden.json`` and prints the six kernels' CUDA-event
milliseconds.  Give each depth twice, in turns, to see the spread::

    python -m comprox_tpu_torch.benchmarks.ring_depth 2 4 4 2
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np

from comprox_tpu_torch.cli.main import make_params, parse_args
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec.container import decode_stream, encode_stream
from comprox_tpu_torch.utils import build

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "data"
ARCHIVES = ("crz_flex_8MiB_S512.cpx", "crx_flex_8MiB_S512.cpx", "crp_8MiB_S512.cpx")
KERNELS = ("K1", "K2", "K12d", "K12e", "K13d", "K13e")


def run_depth(depth: int) -> dict:
    """The six kernels' ms at ``depth`` (decode and encode of each golden)."""
    meta = json.loads((GOLDEN / "torch_golden.json").read_text())
    ms = {}
    with build.variant(f"-DCPX_RING_D={depth}"):
        for name in ARCHIVES:
            blk.reset_launch_counts()
            out = io.BytesIO()
            decode_stream(io.BytesIO((GOLDEN / name).read_bytes()), out, "cuda")
            ms.update({k: v for k, v in blk.kernel_ms().items() if k in KERNELS and v})
            codec, _, _, _, opts = parse_args(meta[name]["argv"].split() + ["in", "out"])
            blk.reset_launch_counts()
            buf = io.BytesIO()
            encode_stream(np.frombuffer(out.getvalue(), np.uint8), buf,
                          make_params(codec, opts), "cuda", filters=opts["filters"])
            if hashlib.sha256(buf.getvalue()).hexdigest() != meta[name]["archive_sha256"]:
                raise AssertionError(f"{name}: depth {depth} wrote other bytes")
            ms.update({k: v for k, v in blk.kernel_ms().items() if k in KERNELS and v})
    return ms


def main(depths) -> None:
    build.build_many([((f"-DCPX_RING_D={d}",), None) for d in sorted(set(depths))])
    for d in depths:
        ms = run_depth(d)
        print(f"depth {d}: " + ", ".join(f"{k} {ms[k]:.3f} ms" for k in KERNELS),
              flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [2, 4, 4, 2])
