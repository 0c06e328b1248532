"""Full-width encode walls on the card, one tree against another.

Each of the 8 MiB crz, crx and crp goldens (``tests/data``, flexible
parse, S=512, T=16384) is decoded on the card and its corpus encoded again
through ``container.encode_stream`` under the golden's command line,
``reps`` times after one warm-up encode; each encode's wall is read by the
host clock between two device synchronisations, and its kernels' device
time is the sum of the CUDA events the wrappers record around their
launches.  A line a codec: the walls, the MB/s of the best, the kernels'
ms, the host share (1 - kernel ms / wall: the time the card waits on the
host) and K3p's ms where the tree has K3p; the archive is checked against
the golden's SHA-256 (``tests/data/torch_golden.json``).

    python comprox_tpu_torch/benchmarks/walls.py TREE [TREE ...]

times each tree in a process of its own, in the order given (``parent
final final parent`` compares two versions within one call); a TREE is the
root of a checkout whose ``comprox_tpu_torch`` is imported.  The trees'
kernels are built first, all at once.
"""

from __future__ import annotations

import hashlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ARCHIVES = ("crz_flex_8MiB_S512.cpx", "crx_flex_8MiB_S512.cpx", "crp_8MiB_S512.cpx")


def one(tree: Path, reps: int = 3) -> list:
    """Time the three encodes with ``tree``'s package; prints a JSON line
    a codec and returns them."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from comprox_tpu_torch.cli.main import make_params, parse_args
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.codec.container import decode_stream, encode_stream

    golden = tree / "tests" / "data"
    meta = json.loads((golden / "torch_golden.json").read_text())
    rows = []
    for name in ARCHIVES:
        want = meta[name]
        codec, _, _, _, opts = parse_args(want["argv"].split() + ["in", "out"])
        cp = make_params(codec, opts)
        raw = io.BytesIO()
        decode_stream(io.BytesIO((golden / name).read_bytes()), raw, "cuda")
        corpus = np.frombuffer(raw.getvalue(), np.uint8)
        if hashlib.sha256(corpus.tobytes()).hexdigest() != want["input_sha256"]:
            raise AssertionError(f"{name}: decoded bytes differ")
        walls, kern, k3p = [], [], []
        for rep in range(reps + 1):
            buf = io.BytesIO()
            blk.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            encode_stream(corpus, buf, cp, "cuda", filters=opts["filters"])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if hashlib.sha256(buf.getvalue()).hexdigest() != want["archive_sha256"]:
                raise AssertionError(f"{name}: the archive differs from the golden")
            ms = blk.kernel_ms()
            if rep:  # the first is the warm-up
                walls.append(wall)
                kern.append(sum(ms.values()))
                k3p.append(ms.get("K3p"))
        best = min(range(reps), key=walls.__getitem__)
        row = dict(tree=str(tree), codec=codec, archive=name, walls_ms=walls,
                   mb_s=corpus.size / 1e6 / (walls[best] / 1e3),
                   kernel_ms=kern, host_share=[1 - k / w for k, w in zip(kern, walls)],
                   k3p_ms=k3p)
        print(json.dumps(row), flush=True)
        rows.append(row)
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
