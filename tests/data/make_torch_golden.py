"""Write the golden crz archives that the PyTorch port must reproduce.

Runs the JAX package (on the CPU) over ``bench.build_corpus`` and writes,
next to this script:

- ``crz_f0_1MiB_S512.cpx``: the archive of ``build_corpus(1 MiB)`` under
  ``make_params("crz", {"lanes": 512, "block_mb": 1, "flexible": False})``
  (``crz e -f0 -b1 -l512``, dictionary on);
- with ``--mb 8`` also ``crz_f0_8MiB_S512.cpx``, the same at
  ``block_mb=8`` (one block of S=512 lanes, T=16384 steps);
- ``torch_golden.json``: per archive, the SHA-256 and size of the input
  corpus and of the archive.

The archives carry their input: decoding one recovers the exact corpus,
so a machine whose ``build_corpus`` yields other bytes can still check
the port against them.

Usage::

    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py [--mb 1] [--mb 8]
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))


def archive_name(mb: int) -> str:
    return f"crz_f0_{mb}MiB_S512.cpx"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, action="append",
                    help="corpus and block size in MiB (repeatable)")
    args = ap.parse_args()
    sizes = args.mb or [1]

    from bench import build_corpus
    from comprox_tpu.cli.main import make_params
    from comprox_tpu.codec.container import decode_stream, encode_stream

    meta_path = HERE / "torch_golden.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    for mb in sizes:
        data = build_corpus(mb << 20)
        cp = make_params(
            "crz", {"lanes": 512, "block_mb": mb, "flexible": False}
        )
        t0 = time.time()
        buf = io.BytesIO()
        encode_stream(data, buf, cp)
        t_enc = time.time() - t0
        arc = buf.getvalue()
        t0 = time.time()
        out = io.BytesIO()
        decode_stream(io.BytesIO(arc), out)
        t_dec = time.time() - t0
        if out.getvalue() != data.tobytes():
            raise SystemExit(f"{mb} MiB: JAX round trip failed")
        (HERE / archive_name(mb)).write_bytes(arc)
        meta[archive_name(mb)] = {
            "argv": f"crz e -f0 -b{mb} -l512",
            "input_bytes": int(data.size),
            "input_sha256": hashlib.sha256(data.tobytes()).hexdigest(),
            "archive_bytes": len(arc),
            "archive_sha256": hashlib.sha256(arc).hexdigest(),
        }
        print(f"{mb} MiB: {len(arc)} B, {len(arc) * 8 / data.size:.4f} bpb, "
              f"JAX CPU encode {t_enc:.1f} s, decode {t_dec:.1f} s")
    meta_path.write_text(json.dumps(meta, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
