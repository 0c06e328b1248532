"""Full-width encode walls on the card, one tree against another.

Each of the 8 MiB crz, crx, crp and crf goldens (``tests/data``, flexible
parse, S=512, T=16384), then crz's ``-f0`` golden (KS) and crx's under
``CPX_X_FINDER=scan`` (KSx), is decoded on the card and its corpus encoded
again through ``container.encode_stream`` under the golden's command line
(a finder knob in it set for the encode),
``reps`` times after one warm-up encode; each encode's wall is read by the
host clock between two device synchronisations (the garbage collector
run before it and off during it), and its kernels' device
time is the sum of the CUDA events the wrappers record around their
launches.  A line a codec: the walls, the MB/s of the best, the kernels'
ms, the host share (1 - kernel ms / wall: the time the card waits on the
host) and the ms of K4, K4x, K7, K8, K9, K13c, K3, K3p, K3b, K6 (both
launches of crx summed), K11, KS and KSx where the tree has them, and the
peak ``max_memory_allocated``; the archive is checked against the golden's
SHA-256 (``tests/data/torch_golden.json``).  Then the crz, crx and crp
``-g4`` encodes of the 29 MiB + 777 B input of ``chip_smoke.py``'s ``-g4``
cell (the 16 MiB chain golden's text and ELF corpora, each rotated by 4
MiB, the last cut to 5 MiB + 777 B: four distinct blocks), a line each
with the archive's SHA-256 (which both trees must write alike).  Last, the
same input through ``-g1`` (one block at a time: the pipelined schedule
where the tree has one, else the sequential) for crz, crx, crp and crf, a
line for its encode (the archive's SHA-256 beside: the ``-g4`` archive's)
and one for its decode (checked against the input), each with its walls,
kernel ms, host share and peak.

    python comprox_tpu_torch/benchmarks/walls.py TREE [TREE ...]

times each tree in a process of its own, in the order given (``parent
final final parent`` compares two versions within one call); a TREE is the
root of a checkout whose ``comprox_tpu_torch`` is imported.  The trees'
kernels are built first, all at once.
"""

from __future__ import annotations

import gc
import hashlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ARCHIVES = ("crz_flex_8MiB_S512.cpx", "crx_flex_8MiB_S512.cpx", "crp_8MiB_S512.cpx",
            "crf_flex_8MiB_S512.cpx", "crz_f0_8MiB_S512.cpx", "crx_scan_flex_8MiB_S512.cpx")
GROUP_SOURCE = "crz_chainm_textelf_flex_16MiB_S512.cpx"  # 8 MiB text, 8 MiB ELF
PASSES = ("K4", "K4x", "K7", "K8", "K9", "K13c", "K3", "K3p", "K3b", "K6", "K11", "KS",
          "KSx")
GROUPED = ("crz", "crx", "crp")  # -g4 codes a launch a group (crf loops its blocks)
ONE_AT_A_TIME = ("crz", "crx", "crp", "crf")  # -g1 on the four-block input


def group_corpus(text_elf):
    """chip_smoke's ``-g4`` input: text, ELF, each rotated by 4 MiB, the
    last cut to 5 MiB + 777 bytes."""
    import numpy as np

    half = text_elf.size // 2
    text, elf = text_elf[:half], text_elf[half:]
    rot = [np.concatenate([x[4 << 20:], x[:4 << 20]]) for x in (text, elf)]
    return np.concatenate([text, elf, rot[0], rot[1][: (5 << 20) + 777]])


def one(tree: Path, reps: int = 3) -> list:
    """Time the encodes with ``tree``'s package; prints a JSON line
    a codec and returns them."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from comprox_tpu_torch.cli.main import make_params, parse_args
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.codec.container import decode_stream, encode_stream

    golden = tree / "tests" / "data"
    meta = json.loads((golden / "torch_golden.json").read_text())

    def decoded(name):
        raw = io.BytesIO()
        decode_stream(io.BytesIO((golden / name).read_bytes()), raw, "cuda")
        if hashlib.sha256(raw.getvalue()).hexdigest() != meta[name]["input_sha256"]:
            raise AssertionError(f"{name}: decoded bytes differ")
        return np.frombuffer(raw.getvalue(), np.uint8)

    def encodes(corpus, cp, opts, group=1, env=None):
        """reps timed encodes after a warm-up, with the finder knobs ``env``
        set: (walls, kernel ms, each pass's ms, peak bytes, the archive)."""
        walls, kern, passes, peak = [], [], {k: [] for k in PASSES}, 0
        old = {k: blk._ENV[k] for k in env or {}}
        blk._ENV.update(env or {})
        for rep in range(reps + 1):
            buf = io.BytesIO()
            blk.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            gc.collect()
            gc.disable()  # no collection pause inside a timed encode
            t0 = time.perf_counter()
            encode_stream(corpus, buf, cp, "cuda", filters=opts["filters"], group=group)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            gc.enable()
            ms = blk.kernel_ms()
            if rep:  # the first is the warm-up
                walls.append(wall)
                kern.append(sum(ms.values()))
                for k in PASSES:
                    passes[k].append(ms.get(k))
                peak = max(peak, torch.cuda.max_memory_allocated())
        blk._ENV.update(old)
        return walls, kern, passes, peak, buf.getvalue()

    def decodes(arc):
        """reps timed decodes after a warm-up: (walls, kernel ms, peak bytes,
        the bytes)."""
        walls, kern, peak = [], [], 0
        for rep in range(reps + 1):
            out = io.BytesIO()
            blk.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            gc.collect()
            gc.disable()
            t0 = time.perf_counter()
            decode_stream(io.BytesIO(arc), out, "cuda")
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            gc.enable()
            if rep:
                walls.append(wall)
                kern.append(sum(blk.kernel_ms().values()))
                peak = max(peak, torch.cuda.max_memory_allocated())
        return walls, kern, peak, out.getvalue()

    def row(codec, name, corpus, walls, kern, passes, **more):
        best = min(range(reps), key=walls.__getitem__)
        r = dict(tree=str(tree), codec=codec, archive=name, walls_ms=walls,
                 mb_s=corpus.size / 1e6 / (walls[best] / 1e3), kernel_ms=kern,
                 host_share=[1 - k / w for k, w in zip(kern, walls)],
                 **{f"{k.lower()}_ms": v for k, v in passes.items()}, **more)
        print(json.dumps(r), flush=True)
        return r

    rows, params = [], {}
    for name in ARCHIVES:
        want = meta[name]
        argv = want["argv"].split()
        env = dict(a.split("=") for a in argv if "=" in a)
        codec, _, _, _, opts = parse_args([a for a in argv if "=" not in a] + ["in", "out"])
        cp = make_params(codec, opts)
        params.setdefault(codec, (cp, opts))
        corpus = decoded(name)
        walls, kern, passes, peak, arc = encodes(corpus, cp, opts, env=env)
        if hashlib.sha256(arc).hexdigest() != want["archive_sha256"]:
            raise AssertionError(f"{name}: the archive differs from the golden")
        rows.append(row(codec, name, corpus, walls, kern, passes, peak_gib=peak / 2**30))
    corpus = group_corpus(decoded(GROUP_SOURCE))
    for codec, (cp, opts) in params.items():
        if codec not in GROUPED:
            continue
        walls, kern, passes, peak, arc = encodes(corpus, cp, opts, group=4)
        rows.append(row(codec, f"-g4, {corpus.size} B", corpus, walls, kern, passes,
                        peak_gib=peak / 2**30, sha256=hashlib.sha256(arc).hexdigest()))
    for codec in ONE_AT_A_TIME:
        cp, opts = params[codec]
        walls, kern, passes, peak, arc = encodes(corpus, cp, opts, group=1)
        rows.append(row(codec, f"-g1 encode, {corpus.size} B", corpus, walls, kern, passes,
                        peak_gib=peak / 2**30, sha256=hashlib.sha256(arc).hexdigest()))
        walls, kern, peak, raw = decodes(arc)
        if raw != corpus.tobytes():
            raise AssertionError(f"{codec} -g1: the decode differs from the input")
        rows.append(row(codec, f"-g1 decode, {corpus.size} B", corpus, walls, kern, {},
                        peak_gib=peak / 2**30))
    return rows


def main(trees) -> int:
    trees = [Path(t).resolve() for t in trees]
    here = Path(__file__).resolve()
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from comprox_tpu_torch.utils import build; build.lib()", str(t)])
        for t in dict.fromkeys(trees)]
    if any(b.wait() for b in builds):
        raise SystemExit("a tree's kernels did not build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for t in trees:
        subprocess.run([sys.executable, str(here), "--one", str(t)], check=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one(Path(sys.argv[2]))
    else:
        raise SystemExit(main(sys.argv[1:]))
