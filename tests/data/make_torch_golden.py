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
``--codec crf``, ``--finder scan`` sets ``CPX_F_FINDER=scan`` (mode F's
decisions from mode X's finder and parse, the X finder ``sort``; archives
``crf_scan_...``) and ``--finder xscan`` sets ``CPX_X_FINDER=scan`` as
well (archives ``crf_xscan_...``).  With
``--codec crp`` it writes ``crp_<mb>MiB_S512.cpx`` (the LZP codec, mode P,
which has no parse: one archive per size).

At 8 MiB an archive is one block of S=512 lanes and T=16384 steps.

The corpus is the bytes of the committed ``-f0`` archive of that size
(decoded here), so that every archive of one size codes the same bytes on
whatever machine this runs: ``bench.build_corpus`` reads the machine's own
files and differs between machines.  ``--rebuild-corpus`` takes
``build_corpus`` instead and rewrites both archives of the size.

The archives carry their input: decoding one recovers the exact corpus.

Sizes below 1 MiB (``--kib``) take the first bytes of the 1 MiB corpus.
``--lanes`` sets S (default 512) and ``--steps`` T, which makes the block
S * T bytes and the corpus several blocks.  ``--corpus words`` codes
:func:`words_corpus` (words of a 16-word vocabulary drawn from a seed): at
``--lanes 2048 --steps 8 --kib 32`` it gives two blocks of a geometry no
CUDA kernel takes, named ``<codec>_words_<parse>_32KiB_S2048.cpx``, each
coded (the corpus' text would not code below its size there: each block's
payload carries S 4-byte states).  ``--corpus elf`` codes the x86-64 ELF corpus
instead (:func:`elf_corpus`: the ELF files of ``/usr/bin``, then of
``/usr/lib/x86_64-linux-gnu``, each directory in name order, concatenated
and cut to 8 MiB; the recipe of BASELINE.md's binary table), and
``--filters`` turns the content filters on (``-F``); the archives are then
named ``<codec>_elfF_<parse>_<size>_S512.cpx`` and their entry records the
8 MiB corpus' md5.

``--chain c`` codes in chain mode (``-c``: the PPM models carry across
blocks) and ``--chain C`` in chain mode v2 (``-C``, crz only: the bucket
table and the previous block's bytes carry too); the archives are named
``<codec>_chain_...`` and ``<codec>_chainm_...``.  ``--group G`` codes G
blocks at a time (``-g<G>``: the JAX package's block batching, whose bytes
equal the one-block path's); the archives are named ``<codec>_g<G>_...``.  ``--corpus textelf`` is
the 8 MiB text corpus followed by the 8 MiB ELF corpus, both decoded from
committed archives (``crz_flex_8MiB_S512.cpx``, ``crz_elfF_flex_8MiB_S256.cpx``),
so that it is the same 16 MiB on every machine (``--mb 16``).

Usage::

    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --mb 1 --mb 8
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --mb 8 --parse flex
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --codec crf --mb 1 --mb 8
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --codec crx --mb 1
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --codec crx --mb 8 --parse flex
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --codec crx --finder scan --mb 1 --parse flex
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --codec crp --mb 1 --mb 8
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --codec crf --finder scan --mb 1 --mb 8
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --codec crf --finder xscan --mb 1
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --codec crf --corpus words --kib 32 --lanes 2048 --steps 8
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --codec crx --corpus elf --filters --kib 256 --parse flex
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --chain C --mb 8 --steps 4096 --parse flex
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --chain C --corpus textelf --mb 16 --steps 16384 --parse flex
    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py --group 4 --mb 8 --steps 4096 --parse flex
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
ELF_DIRS = ("/usr/bin", "/usr/lib/x86_64-linux-gnu")
ELF_BYTES = 8 << 20


def size_tag(size: int) -> str:
    return f"{size >> 20}MiB" if size % (1 << 20) == 0 else f"{size >> 10}KiB"


CHAINS = {"": "", "c": "_chain", "C": "_chainm"}  # --chain -> name tag
TEXTELF_SEEDS = ("crz_flex_8MiB_S512.cpx", "crz_elfF_flex_8MiB_S256.cpx")


def archive_name(mb: int, parse: str = "f0", codec: str = "crz",
                 finder: str = "sort", size: int = 0, lanes: int = 512,
                 corpus: str = "text", chain: str = "",
                 group: int = 1) -> str:
    """The golden's file name; ``size`` (bytes) overrides ``mb``."""
    tail = f"{size_tag(size or mb << 20)}_S{lanes}.cpx"
    tag = codec if finder == "sort" else f"{codec}_{finder}"
    tag += CHAINS[chain]
    tag += f"_g{group}" if group > 1 else ""
    tag += {"text": "", "elf": "_elfF", "words": "_words",
            "textelf": "_textelf"}[corpus]
    if codec == "crp":  # no parse pass: one archive per size
        return f"{tag}_{tail}"
    return f"{tag}_{parse}_{tail}"


WORDS = (b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over ", b"lazy ",
         b"dog ", b"and ", b"runs ", b"far ", b"away ", b"from ", b"its ",
         b"old ", b"home ")


def words_corpus(size: int, seed: int = 2048) -> np.ndarray:
    """``size`` bytes of words drawn uniformly from ``WORDS``."""
    rng = np.random.default_rng(seed)
    buf = b"".join(WORDS[i] for i in rng.integers(0, len(WORDS), size))
    return np.frombuffer(buf[:size], np.uint8)


def elf_corpus() -> np.ndarray:
    """The 8 MiB x86-64 ELF corpus: every regular file (not a symbolic
    link) of ``ELF_DIRS`` that starts with the ELF magic, directory by
    directory in name order, concatenated and cut to ``ELF_BYTES``."""
    buf = bytearray()
    for d in ELF_DIRS:
        for name in sorted(os.listdir(d)):
            path = os.path.join(d, name)
            if os.path.islink(path) or not os.path.isfile(path):
                continue
            with open(path, "rb") as f:
                if f.read(4) != b"\x7fELF":
                    continue
                f.seek(0)
                buf += f.read()
            if len(buf) >= ELF_BYTES:
                return np.frombuffer(bytes(buf[:ELF_BYTES]), np.uint8)
    raise SystemExit(f"the ELF files of {ELF_DIRS} hold {len(buf)} B, "
                     f"fewer than {ELF_BYTES}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, action="append",
                    help="corpus and block size in MiB (repeatable)")
    ap.add_argument("--kib", type=int, action="append",
                    help="corpus size in KiB below 1 MiB (repeatable)")
    ap.add_argument("--lanes", type=int, default=512, help="S")
    ap.add_argument("--steps", type=int,
                    help="T: a block of S * T bytes (default: the corpus)")
    ap.add_argument("--parse", choices=sorted(PARSES), action="append",
                    help="which archives to write (default: both)")
    ap.add_argument("--codec", choices=("crz", "crf", "crx", "crp"),
                    default="crz",
                    help="crf and crp write one archive per size")
    ap.add_argument("--finder", choices=("sort", "scan", "xscan"), default="sort",
                    help="crx: the candidate source (CPX_X_FINDER); crf: scan "
                         "sets CPX_F_FINDER=scan, xscan also CPX_X_FINDER=scan")
    ap.add_argument("--corpus", choices=("text", "elf", "words", "textelf"),
                    default="text",
                    help="the committed text corpus, the x86-64 ELF build, "
                         "words from a seed, or the 8 MiB text and ELF "
                         "corpora of two committed archives end to end")
    ap.add_argument("--chain", choices=("c", "C"), default="",
                    help="chain mode (-c), or chain mode v2 (-C, crz only)")
    ap.add_argument("--group", type=int, default=1,
                    help="blocks coded at a time (-g<G>)")
    ap.add_argument("--filters", action="store_true",
                    help="content filters on (-F); --corpus elf only")
    ap.add_argument("--rebuild-corpus", action="store_true",
                    help="take bench.build_corpus, not the committed bytes")
    args = ap.parse_args()
    sizes = [mb << 20 for mb in args.mb or []] + [k << 10 for k in args.kib or []]
    sizes = sizes or [1 << 20]
    # the finder knobs are read at import: set before the JAX package loads
    env_knobs = {}
    if args.finder != "sort":
        if args.codec == "crx" and args.finder == "scan":
            env_knobs = {"CPX_X_FINDER": "scan"}
        elif args.codec == "crf":
            env_knobs = {"CPX_F_FINDER": "scan"}
            if args.finder == "xscan":
                env_knobs["CPX_X_FINDER"] = "scan"
        else:
            raise SystemExit("--finder scan applies to crx and crf, xscan to crf")
        os.environ.update(env_knobs)
    if args.filters != (args.corpus == "elf"):
        raise SystemExit("--filters goes with --corpus elf")
    if args.chain == "C" and args.codec != "crz":
        raise SystemExit("--chain C is crz's")
    if args.chain and args.group > 1:
        raise SystemExit("--chain and --group exclude each other")
    if args.corpus == "textelf" and sizes != [16 << 20]:
        raise SystemExit("--corpus textelf is 16 MiB: --mb 16")

    from comprox_tpu.cli.main import make_params
    from comprox_tpu.codec.container import decode_stream, encode_stream

    meta_path = HERE / "torch_golden.json"
    elf = elf_corpus() if args.corpus == "elf" else None

    def decoded(name):
        out = io.BytesIO()
        decode_stream(io.BytesIO((HERE / name).read_bytes()), out)
        return np.frombuffer(out.getvalue(), np.uint8)
    for size in sizes:
        mb = max(size >> 20, 1)
        seed_arc = HERE / archive_name(mb)
        parses = args.parse or sorted(PARSES)
        if args.codec in ("crf", "crp"):
            parses = ["flex"]
        if elf is not None:
            data = elf[:size]
        elif args.corpus == "words":
            data = words_corpus(size)
        elif args.corpus == "textelf":
            data = np.concatenate([decoded(a) for a in TEXTELF_SEEDS])
        elif args.rebuild_corpus or not seed_arc.exists():
            if args.codec != "crz" or size % (1 << 20):
                raise SystemExit(f"{args.codec} codes the corpus of the "
                                 f"committed crz archive {seed_arc.name}: "
                                 "write that first")
            from bench import build_corpus

            data = build_corpus(size)
            parses = sorted(PARSES)
        else:
            data = decoded(seed_arc.name)[:size]
        block_mb = (args.lanes * args.steps / 1048576 if args.steps
                    else size / 1048576)
        for parse in parses:
            cp = make_params(
                args.codec,
                {"lanes": args.lanes, "block_mb": block_mb,
                 "flexible": PARSES[parse], "chain_match": args.chain == "C"},
            )
            t0 = time.time()
            buf = io.BytesIO()
            encode_stream(data, buf, cp, filters=args.filters,
                          chain=bool(args.chain), group=args.group)
            t_enc = time.time() - t0
            arc = buf.getvalue()
            t0 = time.time()
            out = io.BytesIO()
            decode_stream(io.BytesIO(arc), out, group=args.group)
            t_dec = time.time() - t0
            if out.getvalue() != data.tobytes():
                raise SystemExit(f"{size} B {parse}: JAX round trip failed")
            name = archive_name(mb, parse, args.codec, args.finder, size,
                                args.lanes, args.corpus, args.chain,
                                args.group)
            (HERE / name).write_bytes(arc)
            flag = "" if PARSES[parse] else "-f0 "
            flag += "-F " if args.filters else ""
            flag += f"-{args.chain} " if args.chain else ""
            flag += f"-g{args.group} " if args.group > 1 else ""
            env = "".join(f"{k}={v} " for k, v in env_knobs.items())
            # read again: another run may have added entries meanwhile
            meta = (json.loads(meta_path.read_text())
                    if meta_path.exists() else {})
            meta[name] = {
                "argv": f"{env}{args.codec} e {flag}-b{block_mb:g} -l{args.lanes}",
                "input_bytes": int(data.size),
                "input_sha256": hashlib.sha256(data.tobytes()).hexdigest(),
                "archive_bytes": len(arc),
                "archive_sha256": hashlib.sha256(arc).hexdigest(),
            }
            if elf is not None:
                meta[name]["corpus_md5"] = hashlib.md5(elf.tobytes()).hexdigest()
            print(f"{name}: {len(arc)} B, {len(arc) * 8 / data.size:.4f} "
                  f"bpb, JAX CPU encode {t_enc:.1f} s, decode {t_dec:.1f} s",
                  flush=True)
            meta_path.write_text(
                json.dumps(meta, indent=1, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
