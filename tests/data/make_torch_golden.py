"""Write the golden crz, crf, crx and crp archives that the PyTorch port must reproduce.

Runs the JAX package (on the CPU) and writes, next to this script, for each
corpus size (``--mb``, default 1):

- ``crz_f0_<mb>MiB_S512.cpx``: the archive under ``make_params("crz",
  {"lanes": 512, "block_mb": mb, "flexible": False})`` (``crz e -f0 -b<mb>
  -l512``, the greedy parse, dictionary on);
- ``crz_flex_<mb>MiB_S512.cpx``: the same with ``flexible: True`` (``crz e
  -b<mb> -l512``, the default flexible parse at the default encoder knobs);
- ``torch_golden.json``: per archive, the SHA-256 and size of the input
  corpus and of the archive.

With ``--codec crf`` it writes ``crf_flex_<mb>MiB_S512.cpx`` instead: the
fast profile under ``make_params("crf", {"lanes": 512, "block_mb": mb})``
(``crf e -b<mb> -l512``, the flexible parse at the default encoder knobs),
on the same corpus.  With ``--codec crx`` it writes ``crx_f0_...`` and
``crx_flex_...`` (the LZ77 codec, mode X, under ``make_params("crx", ...)``;
``--parse`` picks one of the two), again on the crz archive's corpus; with
``--finder scan`` the candidates come from the per-step search scan
(``CPX_X_FINDER=scan``, set here before the JAX package is imported) and
the archives are named ``crx_scan_f0_...`` and ``crx_scan_flex_...``.  With
``--codec crp`` it writes ``crp_<mb>MiB_S512.cpx`` (the LZP codec, mode P,
which has no parse: one archive per size).

At 8 MiB an archive is one block of S=512 lanes and T=16384 steps.

The corpus is the bytes of the committed ``-f0`` archive of that size
(decoded here), so that every archive of one size codes the same bytes on
whatever machine this runs: ``bench.build_corpus`` reads the machine's own
files and differs between machines.  ``--rebuild-corpus`` takes
``build_corpus`` instead and rewrites both archives of the size.

The archives carry their input: decoding one recovers the exact corpus.

Usage::

    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --mb 1 --mb 8
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --mb 8 --parse flex
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --codec crf --mb 1 --mb 8
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --codec crx --mb 1
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --codec crx --mb 8 --parse flex
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --codec crx --finder scan --mb 1 --parse flex
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --codec crp --mb 1 --mb 8
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))

PARSES = {"f0": False, "flex": True}  # archive tag -> BlockParams.flexible


def archive_name(mb: int, parse: str = "f0", codec: str = "crz",
                 finder: str = "sort") -> str:
    if codec == "crp":  # no parse pass: one archive per size
        return f"crp_{mb}MiB_S512.cpx"
    tag = codec if finder == "sort" else f"{codec}_{finder}"
    return f"{tag}_{parse}_{mb}MiB_S512.cpx"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, action="append",
                    help="corpus and block size in MiB (repeatable)")
    ap.add_argument("--parse", choices=sorted(PARSES), action="append",
                    help="which archives to write (default: both)")
    ap.add_argument("--codec", choices=("crz", "crf", "crx", "crp"),
                    default="crz",
                    help="crf and crp write one archive per size")
    ap.add_argument("--finder", choices=("sort", "scan"), default="sort",
                    help="crx only: the candidate source (CPX_X_FINDER)")
    ap.add_argument("--rebuild-corpus", action="store_true",
                    help="take bench.build_corpus, not the committed bytes")
    args = ap.parse_args()
    sizes = args.mb or [1]
    if args.finder != "sort":
        if args.codec != "crx":
            raise SystemExit("--finder applies to --codec crx")
        os.environ["CPX_X_FINDER"] = args.finder  # read at import

    from comprox_tpu.cli.main import make_params
    from comprox_tpu.codec.container import decode_stream, encode_stream

    meta_path = HERE / "torch_golden.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    for mb in sizes:
        seed_arc = HERE / archive_name(mb)
        parses = args.parse or sorted(PARSES)
        if args.codec != "crz":
            if args.rebuild_corpus or not seed_arc.exists():
                raise SystemExit(f"{args.codec} codes the corpus of the "
                                 f"committed crz archive {seed_arc.name}: "
                                 "write that first")
            if args.codec in ("crf", "crp"):
                parses = ["flex"]
        if args.rebuild_corpus or not seed_arc.exists():
            from bench import build_corpus

            data = build_corpus(mb << 20)
            parses = sorted(PARSES)
        else:
            out = io.BytesIO()
            decode_stream(io.BytesIO(seed_arc.read_bytes()), out)
            data = np.frombuffer(out.getvalue(), np.uint8)
        for parse in parses:
            cp = make_params(
                args.codec,
                {"lanes": 512, "block_mb": mb, "flexible": PARSES[parse]},
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
                raise SystemExit(f"{mb} MiB {parse}: JAX round trip failed")
            name = archive_name(mb, parse, args.codec, args.finder)
            (HERE / name).write_bytes(arc)
            flag = "" if PARSES[parse] else "-f0 "
            env = "" if args.finder == "sort" else f"CPX_X_FINDER={args.finder} "
            meta[name] = {
                "argv": f"{env}{args.codec} e {flag}-b{mb} -l512",
                "input_bytes": int(data.size),
                "input_sha256": hashlib.sha256(data.tobytes()).hexdigest(),
                "archive_bytes": len(arc),
                "archive_sha256": hashlib.sha256(arc).hexdigest(),
            }
            print(f"{name}: {len(arc)} B, {len(arc) * 8 / data.size:.4f} "
                  f"bpb, JAX CPU encode {t_enc:.1f} s, decode {t_dec:.1f} s",
                  flush=True)
            meta_path.write_text(
                json.dumps(meta, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
