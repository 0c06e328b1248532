#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (comprox_tpu_torch) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit and
no result line:

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit.
2. build: compiles the four kernels (``comprox_tpu_torch/csrc``) with nvcc.
3. golden: decodes the committed JAX-package archives
   (``tests/data/torch_golden.json``: ``bench.build_corpus`` of 1 MiB and
   8 MiB under ``crz e -f0 -l512``) on the card and checks the decoded
   bytes' SHA-256; re-encodes the 1 MiB corpus with the port and checks
   that the archive's SHA-256 equals the JAX package's.  The decoded
   corpora are the inputs of the next phases, so every machine runs the
   same bytes.
4. kernels: each of KS, K2, K3, K1 against its plain PyTorch version on
   the card, at S=512 lanes, full-size tables, T=256 steps, on corpus
   bytes; every output and table must be equal (tolerance 0: the codec is
   integer arithmetic).
5. full width, the main path: ``crz e -f0 -b8 -l512`` then ``crz d``
   through ``comprox_tpu_torch.cli.main`` on the 8 MiB corpus, one block
   of S=512 and T=16384.  The archive's SHA-256 must equal the JAX
   package's and the round trip must be bit-exact; prints MB/s, bpb and
   the kernel times, and fails if a kernel was not launched.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data"
WORK = ROOT / "build" / "smoke"
MAIN_ARCHIVE = "crz_f0_8MiB_S512.cpx"  # crz e -f0 -b8 -l512
KERNEL_STEPS = 256

KERNELS = [
    # name, source, the JAX scan it replaces (file:line)
    ("KS", "comprox_tpu_torch/csrc/search.cu",
     "comprox_tpu/codec/block.py:1333"),
    ("K2", "comprox_tpu_torch/csrc/model.cu",
     "comprox_tpu/codec/block.py:1677"),
    ("K3", "comprox_tpu_torch/csrc/rans.cu",
     "comprox_tpu/codec/block.py:1945"),
    ("K1", "comprox_tpu_torch/csrc/decode.cu",
     "comprox_tpu/codec/block.py:1980"),
]


def sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def max_err(pairs) -> int:
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


class Phases:
    def __init__(self):
        self.n = 0

    def run(self, name, fn, *args):
        self.n += 1
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {self.n} {name}: {time.perf_counter() - t0:.3f} s",
              flush=True)
        return out


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")


def phase_build():
    from comprox_tpu_torch.utils import build

    print(f"kernels: {build.build(verbose=True)}")
    build.lib()


def phase_golden():
    """Decode the JAX archives on the card; re-encode the 1 MiB one.
    Returns {archive name: decoded corpus bytes}."""
    import numpy as np

    from comprox_tpu_torch.cli.main import make_params
    from comprox_tpu_torch.codec.container import decode_stream, encode_stream

    meta = json.loads((GOLDEN / "torch_golden.json").read_text())
    corpora = {}
    for name, m in sorted(meta.items()):
        arc = (GOLDEN / name).read_bytes()
        if sha256(arc) != m["archive_sha256"]:
            raise AssertionError(f"{name}: fixture does not match its digest")
        out = io.BytesIO()
        t0 = time.perf_counter()
        decode_stream(io.BytesIO(arc), out, "cuda")
        t_dec = time.perf_counter() - t0
        raw = out.getvalue()
        if len(raw) != m["input_bytes"] or sha256(raw) != m["input_sha256"]:
            raise AssertionError(f"{name}: decoded bytes differ from the input")
        print(f"{name}: JAX archive decoded on the card ({t_dec:.2f} s)")
        corpora[name] = np.frombuffer(raw, np.uint8)
    name = "crz_f0_1MiB_S512.cpx"
    cp = make_params("crz", {"lanes": 512, "block_mb": 1, "flexible": False})
    buf = io.BytesIO()
    t0 = time.perf_counter()
    encode_stream(corpora[name], buf, cp, "cuda")
    t_enc = time.perf_counter() - t0
    got = buf.getvalue()
    if sha256(got) != meta[name]["archive_sha256"]:
        raise AssertionError(f"{name}: port archive differs from JAX's")
    print(f"{name}: port archive {len(got)} B, sha256 == JAX golden "
          f"({t_enc:.2f} s)")
    return corpora


def _tables_pairs(ta, tb_):
    return [(ta[k], tb_[k]) for k in ta]


def phase_kernels(corpus):
    """Each kernel against its plain version on the card."""
    import numpy as np
    import torch

    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.models import ppm

    dev = "cuda"
    p = blk.BlockParams(lanes=512, steps=KERNEL_STEPS, mode="R", min_len=5,
                        window=250, rolz_ctx_bytes=4, rolz_dec=2,
                        flexible=False)
    n = p.capacity
    data = corpus[:n]
    inp = torch.from_numpy(data.reshape(p.lanes, p.steps).copy()).to(dev)
    reps = 3
    res = {}

    def timed_plain(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def kernel_ms(name, make_args, fn):
        blk.reset_launch_counts()
        arg_sets = [make_args() for _ in range(reps)]
        for a in arg_sets:
            fn(*a)
        ms = blk.kernel_ms()[name] / reps
        if blk.LAUNCHES[name] != reps:
            raise AssertionError(f"{name}: {blk.LAUNCHES[name]} launches")
        return ms

    def rolz0():
        return blk._init_rolz(p, dev)

    def tables0():
        return ppm.init_tables(True, p.o3_bits, dev)

    # KS
    rk, rp = rolz0(), rolz0()
    blk.reset_launch_counts()
    gk = blk.search_scan(p, inp, n, rk)
    if blk.LAUNCHES["KS"] != 1:
        raise AssertionError("KS did not launch")
    gp, plain_ms = timed_plain(blk.search_scan_plain, p, inp, n, rp)
    err = max_err([(gk, gp), (rk, rp)])
    ms = kernel_ms("KS", lambda: (p, inp, n, rolz0()), blk.search_scan)
    res["KS"] = (err, ms, plain_ms)

    # K2, on the kernel's search grids through the greedy parse
    take, src = blk._greedy_decisions(p, gk[0], gk[1])
    dec = torch.stack([take, src, gk[2], gk[3]]).contiguous()
    tk, tp = tables0(), tables0()
    evk = blk.model_scan(p, inp, n, dec, tk)
    evp, plain_ms = timed_plain(blk.model_scan_plain, p, inp, n, dec, tp)
    err = max_err([(evk, evp)] + _tables_pairs(tk, tp))
    ms = kernel_ms("K2", lambda: (p, inp, n, dec, tables0()), blk.model_scan)
    res["K2"] = (err, ms, plain_ms)

    # K3
    sk, ek, wk = blk.rans_scan(p, evk)
    (sp, ep, wp), plain_ms = timed_plain(blk.rans_scan_plain, p, evk)
    err = max_err([(sk, sp), (ek, ep), (wk, wp)])
    ms = kernel_ms("K3", lambda: (p, evk), blk.rans_scan)
    res["K3"] = (err, ms, plain_ms)

    # K1, on the payload the kernels wrote
    payload = blk._pack_payload(sk, ek, wk)
    n_words, st, stream = blk._unpack_payload(payload, p)
    st_t = torch.from_numpy(st.astype(np.int64)).to(dev)
    stream_t = torch.from_numpy(stream.astype(np.int32)).to(dev)
    tk, tp, rk, rp = tables0(), tables0(), rolz0(), rolz0()
    xk, uk, ok = blk.decode_scan(p, st_t, stream_t, n, tk, rk)
    (xp, up, op), plain_ms = timed_plain(
        blk.decode_scan_plain, p, st_t, stream_t, n, tp, rp)
    if uk != up:
        raise AssertionError(f"K1 words used {uk} vs plain {up}")
    err = max_err([(xk, xp), (ok, op), (rk, rp)] + _tables_pairs(tk, tp))
    blk._check_drain(xk.cpu().numpy(), uk, n_words)
    if not np.array_equal(ok.cpu().numpy().reshape(-1), data):
        raise AssertionError("K1 did not decode the block")
    ms = kernel_ms(
        "K1", lambda: (p, st_t, stream_t, n, tables0(), rolz0()),
        blk.decode_scan)
    res["K1"] = (err, ms, plain_ms)

    for name, (err, ms, plain_ms) in res.items():
        print(f"{name}: max_abs_err {err} (tolerance 0)  kernel {ms:.3f} ms "
              f"({ms * 1e3 / p.steps:.1f} us/step)  plain {plain_ms:.3f} ms "
              f"({plain_ms * 1e3 / p.steps:.1f} us/step)  "
              f"[S={p.lanes} T={p.steps} full tables]")
        if err != 0:
            raise AssertionError(f"{name}: kernel != plain (max err {err})")
    return res


def phase_full_width(corpus):
    """The main path: crz e -f0 -b8 -l512 and crz d through the CLI."""
    import numpy as np

    from comprox_tpu_torch.cli import main as cli
    from comprox_tpu_torch.codec import block as blk

    want = json.loads((GOLDEN / "torch_golden.json").read_text())[MAIN_ARCHIVE]
    WORK.mkdir(parents=True, exist_ok=True)
    n = corpus.size
    src, arc, dst = WORK / "corpus8.bin", WORK / "corpus8.crz", WORK / "out8.bin"
    corpus.tofile(src)
    blk.reset_launch_counts()
    t0 = time.perf_counter()
    cli.run("crz", ["e", str(src), str(arc), "-f0", "-b8", "-l512", "-q"],
            device="cuda")
    t_enc = time.perf_counter() - t0
    ms_enc = blk.kernel_ms()
    t0 = time.perf_counter()
    cli.run("crz", ["d", str(arc), str(dst), "-q"], device="cuda")
    t_dec = time.perf_counter() - t0
    ms_all = blk.kernel_ms()
    launches = dict(blk.LAUNCHES)
    got = arc.read_bytes()
    if sha256(got) != want["archive_sha256"]:
        raise AssertionError("8 MiB archive differs from the JAX package's")
    if not np.array_equal(np.fromfile(dst, np.uint8), corpus):
        raise AssertionError("8 MiB round trip is not bit-exact")
    print(f"full width: {n} B, S=512, T=16384, one block; archive "
          f"{len(got)} B == JAX golden, {len(got) * 8 / n:.4f} bpb; round "
          f"trip bit-exact")
    print(f"encode {n / t_enc / 1e6:.3f} MB/s ({t_enc:.3f} s wall); "
          f"decode {n / t_dec / 1e6:.3f} MB/s ({t_dec:.3f} s wall)")
    print("kernel time (CUDA events): " + ", ".join(
        f"{k} {ms_all[k]:.1f} ms" for k in ms_all)
        + f"; encode kernels {sum(ms_enc.values()):.1f} ms, decode "
        f"{ms_all['K1'] - ms_enc['K1']:.1f} ms")
    for name, cnt in launches.items():
        if cnt < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    for p in (src, arc, dst):
        p.unlink()
    return launches


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    ph = Phases()
    ph.run("device", phase_device)
    ph.run("build", phase_build)
    corpora = ph.run("golden", phase_golden)
    res = ph.run("kernels", phase_kernels, corpora[MAIN_ARCHIVE])
    launches = ph.run("full width", phase_full_width, corpora[MAIN_ARCHIVE])
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    import torch

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": repl,
         "launches": launches[name], "max_abs_err": res[name][0],
         "ms": res[name][1], "plain_ms": res[name][2]}
        for name, source, repl in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
