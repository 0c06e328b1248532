#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (comprox_tpu_torch) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit and
no result line:

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit.
2. build: compiles the kernels (``comprox_tpu_torch/csrc``: thirteen
   sources, eighteen codec kernels counting the entries of modes X and P,
   the shared radix sort and the six probe kernels) with nvcc, one process
   per source, and beside them the instrumented builds of
   ``benchmarks/phases.py`` (two of ``decode.cu``, K1's phase stamps at
   row-ring depth 0 and at the build's depth; one of ``rank.cu`` and
   ``model.cu``, K5's and K2's), all started together.
3. golden: decodes the committed JAX-package archives
   (``tests/data/torch_golden.json``: one 1 MiB and one 8 MiB corpus, each
   under ``crz e -l512`` with the flexible parse and with ``-f0``, under
   ``crf e -l512``, under ``crx e -l512`` (the 1 MiB one also with ``-f0``;
   both sizes also under ``CPX_X_FINDER=scan``) and under ``crp e -l512``;
   the x86-64 ELF corpus at 256 KiB and 8 MiB under ``crx e -F`` and ``crz
   e -F``; a 32 KiB corpus of words under each codec at ``-l2048`` with
   T=8, two blocks) on the card and checks the decoded bytes' SHA-256;
   re-encodes each corpus that no full-width phase below codes, under its
   archive's command line, and checks that each archive's SHA-256 equals
   the JAX package's; each decode and encode must launch kernels.  The
   S=2048 archives run the step scans as clusters of two CTAs and crf's
   K9/K10 at two lanes a thread.
   The decoded corpora are the inputs of the next phases, so every machine
   runs the same bytes.
4. kernels, mode R: each of KS, K4, K5, K6, K2, K3, K1 against its plain
   PyTorch version on the card, at S=512 lanes, full-size tables, T=256
   steps, on corpus bytes (K4 also at the main path's N = 8 Mi positions,
   where its sort stage is timed beside ``torch.sort`` on the same keys);
   every output and table must be equal (tolerance 0: the codec is integer
   arithmetic).  Computes each kernel's bound from these inputs.
5. sort: the radix sort shared by K4, K4x and K7 (``csrc/sortlib.cuh``)
   against ``torch.sort(stable=True)`` on the adversarial key sets of
   ``benchmarks/sort_keys.py`` (keys and positions, tolerance 0; the
   passes it ran against the digits that vary), then on K4's keys of the
   8 MiB corpus (the main path's N = 8 Mi), timed beside ``torch.sort`` on
   int64 and int32 keys.
6. kernels, mode F: K7 and K8 against their plain versions at the full
   N = 8 Mi (S=512, T=16384) on the 8 MiB corpus, K9 and K10 on the first
   S * 256 tokens of that block, K6's mode-F entry at T=256; tolerance 0.
   Beside K7's sort stage, K8's scans and K9's histogram it times the one
   PyTorch call for the same function (``torch.sort``, ``torch.cumsum``,
   ``torch.bincount``), which the port never uses.
7. kernels, mode X: K4x at N = 8 Mi (its sort stage beside ``torch.sort``)
   and at T=256; K6's X entry (both launches: without and with the repeat
   pair), K11, K12e, K3 at five slots and K12d chained at S=512, full
   tables, T=256, each against its plain version; tolerance 0 on every
   output grid and every table.  KSx (the scan finder's search) the same
   way: six grids, both bucket tables and the near-match cache.
8. kernels, mode P: K13e, K3 and K13d chained at S=512, T=256, full-size
   LZP tables, each against its plain version; tolerance 0 on every grid,
   every PPM table, ``sse_p`` and ``lzp2/4/8``.
9. probes: the nine Pallas probes of the JAX package's ``benchmarks/`` as
   the port runs them (``comprox_tpu_torch/benchmarks/probes.py``, kernels
   in ``csrc/probes.cu``): each at each of its own geometries (S=512)
   against its plain version, tolerance 0 (P8 against ``bf16(table)[idx]``;
   its error against the f32 gather is printed), timed beside the plain
   version, one PyTorch call for the same function and the bound; one line
   a geometry, as ``python -m comprox_tpu_torch.benchmarks.probes`` prints
   them.  The kernels line carries each probe's last geometry (P1: its warp
   arm; P4: its persistent arm) and the launches of the whole phase.
10. full width, the crp path: ``crp e -b8 -l512`` then ``crp d`` through the
   CLI; archive SHA-256 == the JAX golden; fails if K13e, K3 or K13d was
   not launched.
11. full width, the crx path under the scan finder: ``crx e -b8 -l512`` with
   ``CPX_X_FINDER=scan``; archive SHA-256 == the JAX golden written under
   that knob; fails if KSx, K6, K11, K12e, K3 or K12d was not launched, or
   if K4x was.
12. full width, the crx path: ``crx e -b8 -l512`` then ``crx d`` through the
   CLI on the 8 MiB corpus; archive SHA-256 == the JAX golden, round trip
   bit-exact; fails if K4x, K11, K6, K12e, K3, K12d or the sort was not
   launched.
13. full width, the flexible crz path: ``crz e -b8 -l512`` then ``crz d``
   through ``comprox_tpu_torch.cli.main`` on the 8 MiB corpus, one block of
   S=512 and T=16384.  The archive's SHA-256 must equal the JAX package's
   and the round trip must be bit-exact; prints MB/s, bpb and the kernel
   times, and fails if K4, K5, K6, K2, K3, K1 or the sort was not
   launched.
14. the step scans by phase: the same archive decoded through K1's two
   instrumented builds of phase 2, at ring depth 0 (the o2 or o1 rows of a
   pair of lanes issued when they are read, nothing in flight ahead) and
   at the build's depth, and its corpus encoded again through K5's and
   K2's (the archive's SHA-256 == the JAX golden); each phase's share of
   the kernel's cycles and its microseconds a step (K5, K2: on thread 0
   and on the CTA's last thread).
15. full width, the greedy crz path: the same with ``-f0``; fails if KS, K2,
   K3 or K1 was not launched.
16. full width, the crf path: ``crf e -b8 -l512`` then ``crf d`` the same
   way; fails if K7, K6, K8, K9, K10 or the sort was not launched.  Then the host's
   share of that path, stage by stage (dictionary, block encode and decode,
   the LZ copy walk, the CRC).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
MAIN_ARCHIVE = "crz_flex_8MiB_S512.cpx"  # crz e -b8 -l512
GREEDY_ARCHIVE = "crz_f0_8MiB_S512.cpx"  # crz e -f0 -b8 -l512
FAST_ARCHIVE = "crf_flex_8MiB_S512.cpx"  # crf e -b8 -l512
X_ARCHIVE = "crx_flex_8MiB_S512.cpx"  # crx e -b8 -l512
XSCAN_ARCHIVE = "crx_scan_flex_8MiB_S512.cpx"  # CPX_X_FINDER=scan crx e -b8 -l512
P_ARCHIVE = "crp_8MiB_S512.cpx"  # crp e -b8 -l512
FULL_WIDTH_ARCHIVES = (MAIN_ARCHIVE, GREEDY_ARCHIVE, FAST_ARCHIVE, X_ARCHIVE,
                       XSCAN_ARCHIVE, P_ARCHIVE)  # re-encoded by phases 9-14
KERNEL_STEPS = 256
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, and the float32 rate outside the tensor cores, taken for the
# kernels' 32-bit integer operations (the data sheet has no integer row)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

PROBES_CU = "comprox_tpu_torch/csrc/probes.cu"
KERNELS = [
    # name, source, the JAX scan it replaces (file:line)
    ("KS", "comprox_tpu_torch/csrc/search.cu",
     "comprox_tpu/codec/block.py:1333"),
    ("K4", "comprox_tpu_torch/csrc/sortfind.cu",
     "comprox_tpu/codec/block.py:809"),
    ("K5", "comprox_tpu_torch/csrc/rank.cu",
     "comprox_tpu/codec/block.py:1188"),
    ("K6", "comprox_tpu_torch/csrc/parse.cu",
     "comprox_tpu/codec/block.py:1414"),
    ("K2", "comprox_tpu_torch/csrc/model.cu",
     "comprox_tpu/codec/block.py:1677"),
    ("K3", "comprox_tpu_torch/csrc/rans.cu",
     "comprox_tpu/codec/block.py:1945"),
    ("K1", "comprox_tpu_torch/csrc/decode.cu",
     "comprox_tpu/codec/block.py:1980"),
    ("K7", "comprox_tpu_torch/csrc/f2find.cu",
     "comprox_tpu/codec/fast.py:178"),
    ("K8", "comprox_tpu_torch/csrc/f2tok.cu",
     "comprox_tpu/codec/fast.py:287"),
    ("K9", "comprox_tpu_torch/csrc/f2enc.cu",
     "comprox_tpu/codec/fast.py:446"),
    ("K10", "comprox_tpu_torch/csrc/f2dec.cu",
     "comprox_tpu/codec/fast.py:538"),
    # mode X (crx): entries of the sources above, and K11's own
    ("K4x", "comprox_tpu_torch/csrc/sortfind.cu",
     "comprox_tpu/codec/block.py:809"),
    ("K11", "comprox_tpu_torch/csrc/xrep.cu",
     "comprox_tpu/codec/block.py:1507"),
    ("K6 (X)", "comprox_tpu_torch/csrc/parse.cu",
     "comprox_tpu/codec/block.py:1414"),
    ("K12e", "comprox_tpu_torch/csrc/model.cu",
     "comprox_tpu/codec/block.py:1677"),
    ("K3 (5 slots)", "comprox_tpu_torch/csrc/rans.cu",
     "comprox_tpu/codec/block.py:1945"),
    ("K12d", "comprox_tpu_torch/csrc/decode.cu",
     "comprox_tpu/codec/block.py:1980"),
    # mode X's scan finder, and mode P (crp)
    ("KSx", "comprox_tpu_torch/csrc/search.cu",
     "comprox_tpu/codec/block.py:1333"),
    ("K13e", "comprox_tpu_torch/csrc/model.cu",
     "comprox_tpu/codec/block.py:1677"),
    ("K13d", "comprox_tpu_torch/csrc/decode.cu",
     "comprox_tpu/codec/block.py:1980"),
    # the stable radix sort of K4, K4x and K7 (their lax.sort)
    ("SORT", "comprox_tpu_torch/csrc/sortlib.cuh",
     "comprox_tpu/codec/block.py:854"),
    # the Pallas probes of benchmarks/ (their pl.pallas_call lines)
    ("P1", PROBES_CU, "benchmarks/pallas_probe.py:56"),
    ("P1b", PROBES_CU, "benchmarks/pallas_probe.py:97"),
    ("P3", PROBES_CU, "benchmarks/pallas_probe.py:164"),
    ("P4", PROBES_CU, "benchmarks/pallas_probe.py:204"),
    ("P5", PROBES_CU, "benchmarks/pallas_probe.py:272"),
    ("P6", PROBES_CU, "benchmarks/pallas_probe2.py:51"),
    ("P7", PROBES_CU, "benchmarks/pallas_probe2.py:100"),
    ("P8", PROBES_CU, "benchmarks/pallas_probe2.py:142"),
    ("P9", PROBES_CU, "benchmarks/pallas_probe2.py:203"),
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


@contextlib.contextmanager
def finder_knob(knob, value):
    """The port's finder knob (read from the environment at import) set to
    ``value`` for the block."""
    from comprox_tpu_torch.codec import block as blk

    old, blk._ENV[knob] = blk._ENV[knob], value
    try:
        yield
    finally:
        blk._ENV[knob] = old


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
    return smi


def phase_build():
    from comprox_tpu_torch.benchmarks import phases
    from comprox_tpu_torch.utils import build

    depths = (0, phases.default_depth())
    libs = build.build_many([((), None)] + phases.variant_specs(depths), verbose=True)
    print(f"kernels: {libs[0]}; K1's instrumented builds (ring depth "
          f"{depths[0]}, {depths[1]}): {', '.join(p.name for p in libs[1:3])}; "
          f"K5's and K2's: {libs[3].name}")
    build.lib()


def _check_launched(name, step, bp):
    """Fails if ``step`` launched no kernel.  For a block of more lanes than
    a CTA has threads (the step scans run as a cluster), prints each
    kernel's device microseconds per step of a block."""
    from comprox_tpu_torch.codec import block as blk

    if not any(blk.LAUNCHES.values()):
        raise AssertionError(f"{name}: {step} launched no kernel")
    if bp.lanes > 1024:
        ms = blk.kernel_ms()
        per = {k: round(ms[k] * 1e3 / (n * bp.steps), 1)
               for k, n in blk.LAUNCHES.items() if n}
        print(f"{name}: {step}, S={bp.lanes}, device us per step: {json.dumps(per)}")


def phase_golden():
    """Decode the JAX archives on the card; re-encode each corpus that no
    full-width phase codes, under its archive's command line.  Returns
    {archive name: decoded corpus bytes}."""
    import numpy as np

    from comprox_tpu_torch.cli.main import make_params, parse_args
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.codec.container import decode_stream, encode_stream

    meta = json.loads((GOLDEN / "torch_golden.json").read_text())
    corpora = {}
    for name, m in sorted(meta.items()):
        arc = (GOLDEN / name).read_bytes()
        if sha256(arc) != m["archive_sha256"]:
            raise AssertionError(f"{name}: fixture does not match its digest")
        argv = m["argv"].split()  # [KNOB=value] codec e [switches]
        env = dict(a.split("=") for a in argv if "=" in a)
        codec, _, _, _, opts = parse_args(
            [a for a in argv if "=" not in a] + ["in", "out"])
        cp = make_params(codec, opts)
        blk.reset_launch_counts()
        out = io.BytesIO()
        t0 = time.perf_counter()
        decode_stream(io.BytesIO(arc), out, "cuda")
        t_dec = time.perf_counter() - t0
        raw = out.getvalue()
        if len(raw) != m["input_bytes"] or sha256(raw) != m["input_sha256"]:
            raise AssertionError(f"{name}: decoded bytes differ from the input")
        _check_launched(name, "decode", cp.block)
        print(f"{name}: JAX archive decoded on the card ({t_dec:.2f} s)")
        corpora[name] = np.frombuffer(raw, np.uint8)
        if name in FULL_WIDTH_ARCHIVES:
            continue
        buf = io.BytesIO()
        blk.reset_launch_counts()
        t0 = time.perf_counter()
        with finder_knob("CPX_X_FINDER", env.get("CPX_X_FINDER", "sort")):
            encode_stream(corpora[name], buf, cp, "cuda", filters=opts["filters"])
        t_enc = time.perf_counter() - t0
        _check_launched(name, "encode", cp.block)
        got = buf.getvalue()
        if sha256(got) != m["archive_sha256"]:
            raise AssertionError(f"{name}: port archive differs from JAX's")
        print(f"{name}: port archive {len(got)} B ({m['argv']}), sha256 == JAX "
              f"golden ({t_enc:.2f} s)")
    return corpora


def _tables_pairs(ta, tb_):
    return [(ta[k], tb_[k]) for k in ta]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _touched_bytes(final, init) -> int:
    """Bytes of a table updated in place that this run's data needed: the
    rows that differ from the initial table, read once and written once."""
    f = final.reshape(final.shape[0], -1)
    rows = int((f != init.reshape(f.shape)).any(dim=1).sum())
    return 2 * rows * f.shape[1] * final.element_size()


def _bound(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate."""
    t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _timed_plain(fn, *args):
    """One run of a plain version on the card: (result, host-clock ms)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _kernel_ms(name, make_args, fn, reps=3):
    """Mean CUDA-event time of ``reps`` launches through the wrapper."""
    from comprox_tpu_torch.codec import block as blk

    blk.reset_launch_counts()
    arg_sets = [make_args() for _ in range(reps)]
    for a in arg_sets:
        fn(*a)
    ms = blk.kernel_ms()[name] / reps
    if blk.LAUNCHES[name] != reps:
        raise AssertionError(f"{name}: {blk.LAUNCHES[name]} launches")
    return ms


def _event_ms(fn, reps=3):
    import torch

    fn()  # warm up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _record(res, name, err, ms, plain_ms, nbytes, ops, library_ms=None):
    bound_ms, bound_by = _bound(nbytes, ops)
    res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=library_ms)


def phase_kernels(corpus):
    """Each kernel against its plain version on the card.  Returns
    {name: dict(max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms)}.

    The bound counts each input read once and each output written once (of
    a table updated in place: the rows this run changed, both ways), and a
    model of the 32-bit operations the function needs on these inputs,
    stated beside each kernel below; the scans' T dependent steps are what
    keeps them far from it."""
    import numpy as np
    import torch

    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.models import ppm

    dev = "cuda"
    p = blk.BlockParams(lanes=512, steps=KERNEL_STEPS, mode="R", min_len=5,
                        window=250, rolz_ctx_bytes=4, rolz_dec=2)
    n = p.capacity
    big, d = p.capacity, p.rolz_depth
    data = corpus[:n]
    inp = torch.from_numpy(data.reshape(p.lanes, p.steps).copy()).to(dev)
    res = {}
    def rolz0():
        return blk._init_rolz(p, dev)

    def tables0():
        return ppm.init_tables(True, p.o3_bits, dev)

    def record(*args, **kw):
        _record(res, *args, **kw)

    # KS.  Operations: per position, D entries scored and ranked (6 each),
    # top_k probes of `probe` bytes and one window, 8 bytes a compare.
    rk, rp = rolz0(), rolz0()
    blk.reset_launch_counts()
    gk = blk.search_scan(p, inp, n, rk)
    if blk.LAUNCHES["KS"] != 1:
        raise AssertionError("KS did not launch")
    gp, plain_ms = _timed_plain(blk.search_scan_plain, p, inp, n, rp)
    err = max_err([(gk, gp), (rk, rp)])
    ms = _kernel_ms("KS", lambda: (p, inp, n, rolz0()), blk.search_scan)
    record("KS", err, ms, plain_ms,
           _nbytes(inp, gk) + _touched_bytes(rk, rolz0()),
           big * (6 * d + p.top_k * p.probe // 8 + p.window // 8))

    # K4 at this window.  Operations: four radix passes (digit, count,
    # place), 2 * probe chain entries a position (key compare, usable,
    # 8-byte probe: 4), and the extension of each proposal, 8 bytes a
    # compare (from the lengths found).
    propk = blk.sort_candidates(p, inp, n)
    propp, plain_ms = _timed_plain(blk.sort_candidates_plain, p, inp, n)
    err = max_err([(propk, propp)])
    ms = _kernel_ms("K4", lambda: (p, inp, n), blk.sort_candidates)

    def k4_ops(props, size):
        ext = int((props[0::2].long() // 8 + 1).sum())
        return size * (4 * 3 + 2 * blk._R_PROBE * 4) + 2 * ext

    record("K4", err, ms, plain_ms, _nbytes(inp, propk), k4_ops(propk, big))
    k4_small = dict(res["K4"])

    # K5, on the finder's proposals.  Operations: per position, D entries
    # (score 4, membership of n_cands proposals 2 each, best entry 2), and
    # the window compare where the cache matched (from the lengths found).
    rk, rp = rolz0(), rolz0()
    ck = blk.rank_scan(p, inp, n, propk, rk)
    cp, plain_ms = _timed_plain(blk.rank_scan_plain, p, inp, n, propk, rp)
    err = max_err([(ck, cp), (rk, rp)])
    ms = _kernel_ms("K5", lambda: (p, inp, n, propk, rolz0()), blk.rank_scan)
    n_c = blk._R_CANDS
    record("K5", err, ms, plain_ms,
           _nbytes(inp, propk, ck) + _touched_bytes(rk, rolz0()),
           big * d * (6 + 2 * n_c) + 2 * int((ck[3 * n_c].long() // 8 + 1).sum()))

    # K6, on the rank scan's candidates.  Operations: per position the
    # literal (4), and per candidate each admissible length (add, clamp,
    # key, min: 4).
    dk = blk.parse_scan(p, n, ck)
    dp, plain_ms = _timed_plain(blk.parse_scan_plain, p, n, ck)
    err = max_err([(dk, dp)])
    ms = _kernel_ms("K6", lambda: (p, n, ck), blk.parse_scan)
    lens = ck[0 : 3 * (n_c + 1) : 3].long()
    record("K6", err, ms, plain_ms, _nbytes(ck, dk),
           4 * big + 4 * int((lens - p.min_len + 1).clamp_min(0).sum()))

    # K2, on the flexible parse's decisions.  Operations: per position the
    # o2 row (260 slots: read, adjust, sum: 3) and the side models (64).
    tk, tp = tables0(), tables0()
    evk = blk.model_scan(p, inp, n, dk, tk)
    evp, plain_ms = _timed_plain(blk.model_scan_plain, p, inp, n, dk, tp)
    err = max_err([(evk, evp)] + _tables_pairs(tk, tp))
    ms = _kernel_ms("K2", lambda: (p, inp, n, dk, tables0()), blk.model_scan)
    t0_ = tables0()
    tab_bytes = sum(_touched_bytes(tk[k], t0_[k]) for k in tk)
    record("K2", err, ms, plain_ms, _nbytes(inp, dk, evk) + tab_bytes,
           big * (3 * 260 + 64))

    # K3.  Operations: three events a position, 8 each.
    sk, ek, wk = blk.rans_scan(p, evk)
    (sp, ep, wp), plain_ms = _timed_plain(blk.rans_scan_plain, p, evk)
    err = max_err([(sk, sp), (ek, ep), (wk, wp)])
    ms = _kernel_ms("K3", lambda: (p, evk), blk.rans_scan)
    record("K3", err, ms, plain_ms, _nbytes(evk, sk, wk) + ek.numel(),
           big * 3 * 8)

    # K1, on the payload the kernels wrote.  Operations: as K2 plus the
    # bucket row (D entries, 4 each).  Bytes: the words the stream holds.
    payload = blk._pack_payload(sk, ek, wk)
    n_words, st, stream = blk._unpack_payload(payload, p)
    st_t = torch.from_numpy(st.astype(np.int64)).to(dev)
    stream_t = torch.from_numpy(stream.astype(np.int32)).to(dev)
    tk, tp, rk, rp = tables0(), tables0(), rolz0(), rolz0()
    xk, uk, ok = blk.decode_scan(p, st_t, stream_t, n, tk, rk)
    (xp, up, op), plain_ms = _timed_plain(
        blk.decode_scan_plain, p, st_t, stream_t, n, tp, rp)
    if uk != up:
        raise AssertionError(f"K1 words used {uk} vs plain {up}")
    err = max_err([(xk, xp), (ok, op), (rk, rp)] + _tables_pairs(tk, tp))
    blk._check_drain(xk.cpu().numpy(), uk, n_words)
    if not np.array_equal(ok.cpu().numpy().reshape(-1), data):
        raise AssertionError("K1 did not decode the block")
    ms = _kernel_ms(
        "K1", lambda: (p, st_t, stream_t, n, tables0(), rolz0()),
        blk.decode_scan)
    tab_bytes = sum(_touched_bytes(tk[k], t0_[k]) for k in tk)
    record("K1", err, ms, plain_ms,
           4 * n_words + _nbytes(st_t, ok) + tab_bytes
           + _touched_bytes(rk, rolz0()), big * (3 * 260 + 64 + 4 * d))

    for name, r in res.items():
        print(f"{name}: max_abs_err {r['max_abs_err']} (tolerance 0)  kernel "
              f"{r['ms']:.3f} ms ({r['ms'] * 1e3 / p.steps:.1f} us/step)  "
              f"plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  [S={p.lanes} T={p.steps} full tables]")

    # K4 at the main path's size: the whole 8 MiB corpus as one block, with
    # its sort stage beside torch.sort (stable) on the same keys.
    pf = blk.BlockParams(lanes=512, steps=corpus.size // 512, mode="R",
                         min_len=5, window=250, rolz_ctx_bytes=4, rolz_dec=2)
    nf = pf.capacity
    inpf = torch.from_numpy(corpus[:nf].reshape(pf.lanes, pf.steps).copy()).to(dev)
    propk = blk.sort_candidates(pf, inpf, nf)
    propp, plain_ms = _timed_plain(blk.sort_candidates_plain, pf, inpf, nf)
    err = max_err([(propk, propp)])
    del propp
    ms = _kernel_ms("K4", lambda: (pf, inpf, nf), blk.sort_candidates)
    bytes_pad = blk.pad_block(pf, inpf)
    keys = blk.sort_keys_plain(pf, bytes_pad, nf)
    hs, ps, passes = blk.sort_positions(pf, bytes_pad, nf, with_passes=True)
    hp, pp = torch.sort(keys, stable=True)
    err = max(err, max_err([(hs, hp), (ps, pp)]))
    sort_ms = _event_ms(lambda: blk.sort_positions(pf, bytes_pad, nf))
    lib_ms = _event_ms(lambda: torch.sort(keys, stable=True))
    lib32_ms = _event_ms(lambda: torch.sort(keys.to(torch.int32), stable=True))
    record("K4", max(err, k4_small["max_abs_err"]), ms, plain_ms,
           _nbytes(inpf, propk), k4_ops(propk, nf), library_ms=lib_ms)
    r = res["K4"]
    print(f"K4 at N={nf} (S=512 T={pf.steps}): max_abs_err {err}  kernel "
          f"{ms:.3f} ms  plain {plain_ms:.3f} ms  bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}); its sort stage (keys + {passes} radix passes) "
          f"{sort_ms:.3f} ms, torch.sort(stable) of the same keys as int64 "
          f"{lib_ms:.3f} ms, as int32 bit patterns {lib32_ms:.3f} ms; at "
          f"T={KERNEL_STEPS}: kernel {k4_small['ms']:.3f} ms, plain "
          f"{k4_small['plain_ms']:.3f} ms")
    for name, r in res.items():
        if r["max_abs_err"] != 0:
            raise AssertionError(
                f"{name}: kernel != plain (max err {r['max_abs_err']})")
    return res


def phase_sort(corpus):
    """The shared radix sort against torch.sort(stable=True) on the
    adversarial key sets and on K4's keys of the 8 MiB corpus; returns its
    record for the kernels line (timed on those keys, the main path's)."""
    import torch

    from comprox_tpu_torch.benchmarks import sort_keys
    from comprox_tpu_torch.codec import block as blk

    dev = "cuda"
    err = 0
    for name in sort_keys.SETS:
        keys = sort_keys.keys(name).to(dev)
        hs, ps, passes = blk.radix_sort(keys)
        hp, pp = torch.sort(keys, stable=True)
        e = max_err([(hs, hp), (ps, pp)])
        want = blk.radix_passes_plain(keys)
        if passes != want:
            raise AssertionError(f"sort {name}: {passes} passes, digits that vary {want}")
        print(f"sort {name}: N={keys.numel()} max_abs_err {e} (tolerance 0) "
              f"passes {passes}")
        err = max(err, e)
    pf = blk.BlockParams(lanes=512, steps=corpus.size // 512, mode="R",
                         min_len=5, window=250, rolz_ctx_bytes=4, rolz_dec=2)
    n = pf.capacity
    inp = torch.from_numpy(corpus[:n].reshape(pf.lanes, pf.steps).copy()).to(dev)
    keys = blk.sort_keys_plain(pf, blk.pad_block(pf, inp), n)
    k32 = torch.where(keys >= 1 << 31, keys - (1 << 32), keys).to(torch.int32)
    key = torch.empty((2, n), dtype=torch.int32, device=dev)
    pos = torch.empty_like(key)
    reps = 5
    key[0].copy_(k32)
    blk._radix_sort(key, pos, n)  # warm-up
    blk.reset_launch_counts()
    for _ in range(reps):
        key[0].copy_(k32)  # the input again: each launch sorts K4's keys
        passes = blk._radix_sort(key, pos, n)
    ms = blk.kernel_ms()["SORT"] / reps
    (hp, pp), plain_ms = _timed_plain(lambda: torch.sort(keys, stable=True))
    err = max(err, max_err([(key[0].long() & 0xFFFFFFFF, hp), (pos[0], pp)]))
    lib_ms = _event_ms(lambda: torch.sort(keys, stable=True))
    lib32_ms = _event_ms(lambda: torch.sort(k32, stable=True))
    passes = int(passes.item())
    # Bytes: the keys read once, the keys and positions (int32) written
    # once.  Operations: a digit, a rank and a place a key and pass.  The
    # design's own floor, each pass reading and writing 8 bytes a key and
    # the histograms reading the keys once, is printed beside it.
    res = {}
    _record(res, "SORT", err, ms, plain_ms, 12 * n, 3 * passes * n, library_ms=lib_ms)
    r = res["SORT"]
    floor_ms = (16 * passes + 4) * n / PEAK_BYTES_PER_S * 1e3
    print(f"sort of K4's keys, N={n}: max_abs_err {err}  kernel {ms:.3f} ms "
          f"({passes} passes)  plain (torch.sort, host clock) {plain_ms:.3f} ms  "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {passes} passes of "
          f"this design {floor_ms:.4f} ms); torch.sort(stable) of the same keys "
          f"as int64 {lib_ms:.3f} ms, as int32 bit patterns {lib32_ms:.3f} ms; "
          f"kernel / torch.sort {ms / lib_ms:.2f}")
    if err != 0:
        raise AssertionError(f"SORT: kernel != torch.sort (max err {err})")
    return res


def phase_scan_phases():
    """The step scans by phase: the 8 MiB flexible crz archive decoded
    through K1's two instrumented builds of phase 2 (ring depth 0 and the
    build's depth), its corpus encoded through K5's and K2's."""
    from comprox_tpu_torch.benchmarks import phases

    phases.run(GOLDEN / MAIN_ARCHIVE, ("K1", "K5", "K2"), (0, phases.default_depth()))


def phase_kernels_fast(corpus):
    """The mode-F kernels against their plain versions on the card, on the
    whole 8 MiB corpus as one block (S=512, T=16384, n = N).  Returns the
    same per-kernel dicts as phase_kernels for K7-K10, and K6's F entry
    under "K6F"."""
    import numpy as np
    import torch

    from comprox_tpu_torch.cli.main import make_params
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.codec import fast

    dev = "cuda"
    p = make_params("crf", {"lanes": 512, "block_mb": 8}).block
    big = n = p.capacity
    if corpus.size != big:
        raise AssertionError(f"corpus of {corpus.size} B for a block of {big}")
    inp = torch.from_numpy(corpus.reshape(p.lanes, p.steps).copy()).to(dev)
    n_c, ext = fast._F_CANDS, 4 * (fast._EXTW - 1)
    res = {}

    # K7 at N = 8 Mi.  Operations: four radix passes (digit, count, place),
    # per candidate the key compare and the scatter (4), and its extension,
    # 8 bytes a compare (from the lengths found, at most ext).
    ck = fast.f2_find(p, inp, n)
    cp, plain_ms = _timed_plain(fast.f2_find_plain, p, inp, n)
    err = max_err([(ck, cp)])
    del cp
    ms = _kernel_ms("K7", lambda: (p, inp, n), fast.f2_find)
    bytes_pad = fast.pad_block(p, inp)
    keys = fast.sort_keys_plain(p, bytes_pad, n)
    hs, ps, passes = fast.sort_positions(p, bytes_pad, n, with_passes=True)
    hp, pp = torch.sort(keys, stable=True)
    err = max(err, max_err([(hs, hp), (ps, pp)]))
    del hs, ps, hp, pp
    sort_ms = _event_ms(lambda: fast.sort_positions(p, bytes_pad, n))
    lib_ms = _event_ms(lambda: torch.sort(keys, stable=True))
    del keys
    ext_ops = int((ck[0::2].long().clamp_max(ext) // 8 + 1).sum())
    _record(res, "K7", err, ms, plain_ms, _nbytes(inp, ck),
            big * (4 * 3 + 4 * n_c) + 2 * ext_ops, library_ms=lib_ms)
    print(f"K7 at N={big}: max_abs_err {err}  kernel {ms:.3f} ms  plain "
          f"{plain_ms:.3f} ms  bound {res['K7']['bound_ms']:.4f} ms "
          f"({res['K7']['bound_by']}); its sort stage (keys + {passes} radix "
          f"passes) {sort_ms:.3f} ms, torch.sort(stable) of the same keys "
          f"(int64) {lib_ms:.3f} ms")

    # K6, F entry, at T=256 on the finder's candidates of the first S * 256
    # bytes.  Operations: as the R entry (literal 4, each admissible length 4).
    ps_ = blk.BlockParams(lanes=p.lanes, steps=KERNEL_STEPS, mode="F",
                          min_len=p.min_len, window=p.window)
    ns = ps_.capacity
    inps = torch.from_numpy(corpus[:ns].reshape(ps_.lanes, ps_.steps).copy()).to(dev)
    cs = fast.f2_find(ps_, inps, ns)
    kw = dict(prices=fast._F_PRICES, n_c=n_c)
    dk = blk.parse_scan(ps_, ns, cs, **kw)
    dp, plain_ms = _timed_plain(lambda: blk.parse_scan_plain(ps_, ns, cs, **kw))
    err = max_err([(dk, dp)])
    ms = _kernel_ms("K6", lambda: (ps_, ns, cs), lambda *a: blk.parse_scan(*a, **kw))
    # Bytes: the candidates read, (take, src) written (the F entry's third
    # grid is all zero and nothing reads it).
    _record(res, "K6F", err, ms, plain_ms, _nbytes(cs, dk[:2]),
            4 * ns + 4 * int((cs[0::2].long() - ps_.min_len + 1).clamp_min(0).sum()))
    r = res["K6F"]
    print(f"K6, F entry at T={KERNEL_STEPS}: max_abs_err {err}  kernel {ms:.3f} ms "
          f"({ms * 1e3 / KERNEL_STEPS:.1f} us/step)  plain {plain_ms:.3f} ms  bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']})")

    # K8 at N = 8 Mi on the kernel parse's decisions (the plain parse takes
    # ~3 ms a step).  Operations: per position the replay (4), the event
    # (10), one scan of two values (4) and the token's code (20 a token).
    # Bytes: the block and (take, src) read, 12 a token written.  The plain
    # version also lines the other positions up behind the tokens, as JAX
    # does; the kernel's n_tok tokens are held against its first n_tok.
    dec = blk.parse_scan(p, n, ck, **kw)
    n_tok, sym, xtr, tbits = fast.tokenize(p, inp, n, dec)
    tp, plain_ms = _timed_plain(fast.tokenize_plain, p, inp, n, dec)
    if n_tok != tp[1]:
        raise AssertionError(f"K8 n_tok {n_tok} vs plain {tp[1]}")
    err = max_err([(a, b[:n_tok]) for a, b in zip((sym, xtr, tbits), tp[2:])])
    del tp
    ms = _kernel_ms("K8", lambda: (p, inp, n, dec), fast.tokenize)
    starts = (dec[0].reshape(-1) > 0).to(torch.int32)  # an [N] int32 for the library scan
    lib_ms = _event_ms(lambda: torch.cumsum(starts, 0))
    _record(res, "K8", err, ms, plain_ms, _nbytes(inp, dec[:2]) + 12 * n_tok,
            big * 18 + n_tok * 20, library_ms=lib_ms)
    print(f"K8 at N={big}: {n_tok} tokens; max_abs_err {err}  kernel {ms:.3f} ms  "
          f"plain {plain_ms:.3f} ms  bound {res['K8']['bound_ms']:.4f} ms "
          f"({res['K8']['bound_by']}); one torch.cumsum over N int32 {lib_ms:.3f} ms "
          f"(the kernel's scan carries a count and a last nonzero value)")

    # K9 on the first S * 256 tokens.  Operations: three events a token, 8
    # each, and the histogram (2).  Bytes: 12 a token read, the table and
    # the states written, 2 a word written.
    cut = min(n_tok, p.lanes * KERNEL_STEPS)
    ek = fast.encode_scan(p, sym, xtr, tbits, cut)
    ep, plain_ms = _timed_plain(fast.encode_scan_plain, p, sym, xtr, tbits, cut)
    err = max_err(list(zip(ek, ep)))
    ms = _kernel_ms("K9", lambda: (p, sym, xtr, tbits, cut), fast.encode_scan)
    full_ms = _kernel_ms("K9", lambda: (p, sym, xtr, tbits, n_tok), fast.encode_scan)
    sym64 = sym[:cut].long()
    lib_ms = _event_ms(lambda: torch.bincount(sym64, minlength=fast.W_SYM))
    freq, states, words = ek
    _record(res, "K9", err, ms, plain_ms,
            12 * cut + _nbytes(freq, states) + 2 * words.numel(),
            cut * (3 * 8 + 2), library_ms=lib_ms)
    print(f"K9 on {cut} tokens ({-(-cut // p.lanes)} steps): max_abs_err {err}  "
          f"kernel {ms:.3f} ms ({ms * 1e3 / -(-cut // p.lanes):.2f} us/step)  plain "
          f"{plain_ms:.3f} ms  bound {res['K9']['bound_ms']:.4f} ms "
          f"({res['K9']['bound_by']}); torch.bincount of the same symbols "
          f"{lib_ms:.3f} ms (the histogram alone); on all {n_tok} tokens: "
          f"kernel {full_ms:.3f} ms")

    # K10 on the stream K9 wrote.  Operations: three events a token, 8
    # each, the slot table (M * 10) and the plane (10 a token).  Bytes: 2 a
    # word read, the table and the states, 4 a token written.  The plain
    # version's plane has JAX's N slots; the kernel's n_tok are its first.
    stream = torch.zeros(fast._max_words(p), dtype=torch.int32, device=dev)
    stream[: words.numel()] = words.flip(0)
    xk, uk, plk = fast.decode_scan(p, freq, states, stream, cut)
    (xp, up, plp), plain_ms = _timed_plain(
        fast.decode_scan_plain, p, freq, states, stream, cut)
    if not uk == up == words.numel():
        raise AssertionError(f"K10 words used {uk} vs plain {up} of {words.numel()}")
    if not bool((xk == fast.RANS_L).all()):
        raise AssertionError("K10 did not drain the states")
    err = max_err([(xk, xp), (plk, plp[:cut])])
    ms = _kernel_ms("K10", lambda: (p, freq, states, stream, cut), fast.decode_scan)
    _record(res, "K10", err, ms, plain_ms,
            2 * words.numel() + _nbytes(freq, states) + 4 * cut,
            cut * 3 * 8 + fast.M * 10 + cut * 10)
    print(f"K10 on {cut} tokens: max_abs_err {err}  kernel {ms:.3f} ms "
          f"({ms * 1e3 / -(-cut // p.lanes):.2f} us/step)  plain {plain_ms:.3f} ms  "
          f"bound {res['K10']['bound_ms']:.4f} ms ({res['K10']['bound_by']})")
    for name, r in res.items():
        if r["max_abs_err"] != 0:
            raise AssertionError(
                f"{name}: kernel != plain (max err {r['max_abs_err']})")
    return res


def phase_kernels_x(corpus):
    """The mode-X kernels against their plain versions on the card.  Returns
    the same per-kernel dicts as phase_kernels for K4x, K11, "K6 (X)" (both
    launches together), K12e, "K3 (5 slots)" and K12d."""
    import numpy as np
    import torch

    from comprox_tpu_torch.cli.main import make_params
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.models import ppm

    dev = "cuda"
    pf = make_params("crx", {"lanes": 512, "block_mb": 8}).block
    p = blk.BlockParams(lanes=512, steps=KERNEL_STEPS, mode="X",
                        min_len=pf.min_len, window=pf.window,
                        rolz_ctx_bytes=pf.rolz_ctx_bytes)
    big = n = p.capacity
    data = corpus[:n]
    inp = torch.from_numpy(data.reshape(p.lanes, p.steps).copy()).to(dev)
    n_c, chain_b, _, _ = blk._finder_config(p, True)
    prices = blk.x_prices()
    res = {}

    def tables0():
        return ppm.init_tables(True, p.o3_bits, dev)

    def k4x_ops(props, size):
        ext = int((props[0::2].long() // 8 + 1).sum())
        return size * (4 * 3 + chain_b * 4) + 2 * ext

    # K4x at this window.  Operations: as K4 with its chain of chain_b
    # entries (backward only).
    ck = blk.sort_candidates(p, inp, n, content=True)
    cp, plain_ms = _timed_plain(blk.sort_candidates_plain, p, inp, n, True)
    err = max_err([(ck, cp)])
    ms = _kernel_ms("K4x", lambda: (p, inp, n, True), blk.sort_candidates)
    _record(res, "K4x", err, ms, plain_ms, _nbytes(inp, ck), k4x_ops(ck, big))
    k4x_small = dict(res["K4x"])

    # KSx, the scan finder's search.  Operations: per position two bucket
    # rows (D entries scored and ranked, 6 each; top_k probes and one
    # window, 8 bytes a compare) and the near-match cache (hash 12, one
    # window).  Bytes: the block read, six grids written, the rows of the
    # three tables that changed.
    def xsearch0():
        return blk._init_xsearch(p, dev)

    xk, xp = xsearch0(), xsearch0()
    blk.reset_launch_counts()
    gk = blk.search_scan(p, inp, n, xk)
    if blk.LAUNCHES["KSx"] != 1:
        raise AssertionError("KSx did not launch")
    gp, plain_ms = _timed_plain(blk.search_scan_plain, p, inp, n, xp)
    err = max_err([(gk, gp)] + list(zip(xk, xp)))
    ms = _kernel_ms("KSx", lambda: (p, inp, n, xsearch0()), blk.search_scan)
    d = p.rolz_depth
    _record(res, "KSx", err, ms, plain_ms,
            _nbytes(inp, gk) + sum(_touched_bytes(a, b) for a, b in zip(xk, xsearch0())),
            big * (2 * (6 * d + p.top_k * p.probe // 8 + p.window // 8)
                   + 12 + p.window // 8))
    del xk, xp

    # K6, X entry, first launch (three distance-priced candidates).
    # Operations: the literal (4) and each admissible length (4), as K6.
    kw = dict(prices=prices, n_c=n_c)
    d1k = blk.parse_scan(p, n, ck, **kw)
    d1p, plain1 = _timed_plain(lambda: blk.parse_scan_plain(p, n, ck, **kw))
    err1 = max_err([(d1k, d1p)])
    ms1 = _kernel_ms("K6", lambda: (p, n, ck), lambda *a: blk.parse_scan(*a, **kw))

    # K11 on the first parse.  Operations: twelve a position (two walks).
    # Bytes: (take, src) and the block read, (len_rep, prev) written.
    rk = blk.rep_scan(p, inp, n, d1k)
    rp, plain_ms = _timed_plain(blk.rep_scan_plain, p, inp, n, d1k)
    err = max_err([(rk, rp)])
    ms = _kernel_ms("K11", lambda: (p, inp, n, d1k), blk.rep_scan)
    _record(res, "K11", err, ms, plain_ms, _nbytes(inp, d1k[:2], rk), 12 * big)

    # K6, X entry, second launch (with the repeat pair, tried last).
    d2k = blk.parse_scan(p, n, ck, rep=rk, **kw)
    d2p, plain2 = _timed_plain(lambda: blk.parse_scan_plain(p, n, ck, rep=rk, **kw))
    err2 = max_err([(d2k, d2p)])
    ms2 = _kernel_ms("K6", lambda: (p, n, ck),
                     lambda *a: blk.parse_scan(*a, rep=rk, **kw))
    adm = int((ck[0::2].long() - p.min_len + 1).clamp_min(0).sum())
    adm_rep = int((rk[0].long() - p.min_len + 1).clamp_min(0).sum())
    _record(res, "K6 (X)", max(err1, err2), ms1 + ms2, plain1 + plain2,
            2 * _nbytes(ck, d1k[:2]) + _nbytes(rk),
            2 * (4 * big + 4 * adm) + 4 * adm_rep)
    print(f"K6, X entry at T={KERNEL_STEPS}: without the repeat pair {ms1:.3f} ms "
          f"(plain {plain1:.3f}), with it {ms2:.3f} ms (plain {plain2:.3f}); "
          f"max_abs_err {err1}, {err2}")

    # K12e on the second parse's decisions.  Operations: as K2.
    dec = d2k[:2]
    tk, tp = tables0(), tables0()
    evk = blk.model_scan(p, inp, n, dec, tk)
    evp, plain_ms = _timed_plain(blk.model_scan_plain, p, inp, n, dec, tp)
    err = max_err([(evk, evp)] + _tables_pairs(tk, tp))
    ms = _kernel_ms("K12e", lambda: (p, inp, n, dec, tables0()), blk.model_scan)
    t0_ = tables0()
    tab_bytes = sum(_touched_bytes(tk[k], t0_[k]) for k in tk)
    _record(res, "K12e", err, ms, plain_ms, _nbytes(inp, dec, evk) + tab_bytes,
            big * (3 * 260 + 64))

    # K3 at five slots.  Operations: five events a position, 8 each.
    sk, ek, wk = blk.rans_scan(p, evk)
    (sp, ep, wp), plain_ms = _timed_plain(blk.rans_scan_plain, p, evk)
    err = max_err([(sk, sp), (ek, ep), (wk, wp)])
    ms = _kernel_ms("K3", lambda: (p, evk), blk.rans_scan)
    _record(res, "K3 (5 slots)", err, ms, plain_ms,
            _nbytes(evk, sk, wk) + ek.numel(), big * 5 * 8)

    # K12d on the payload the kernels wrote.  Operations: as K12e.
    payload = blk._pack_payload(sk, ek, wk)
    n_words, st, stream = blk._unpack_payload(payload, p)
    st_t = torch.from_numpy(st.astype(np.int64)).to(dev)
    stream_t = torch.from_numpy(stream.astype(np.int32)).to(dev)
    tk, tp = tables0(), tables0()
    xk, uk, ok = blk.decode_scan(p, st_t, stream_t, n, tk)
    (xp, up, op), plain_ms = _timed_plain(
        blk.decode_scan_plain, p, st_t, stream_t, n, tp)
    if uk != up:
        raise AssertionError(f"K12d words used {uk} vs plain {up}")
    err = max_err([(xk, xp), (ok, op)] + _tables_pairs(tk, tp))
    blk._check_drain(xk.cpu().numpy(), uk, n_words)
    if not np.array_equal(ok.cpu().numpy().reshape(-1), data):
        raise AssertionError("K12d did not decode the block")
    ms = _kernel_ms("K12d", lambda: (p, st_t, stream_t, n, tables0()),
                    blk.decode_scan)
    tab_bytes = sum(_touched_bytes(tk[k], t0_[k]) for k in tk)
    _record(res, "K12d", err, ms, plain_ms,
            4 * n_words + _nbytes(st_t, ok) + tab_bytes, big * (3 * 260 + 64))

    for name, r in res.items():
        print(f"{name}: max_abs_err {r['max_abs_err']} (tolerance 0)  kernel "
              f"{r['ms']:.3f} ms ({r['ms'] * 1e3 / p.steps:.1f} us/step)  "
              f"plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  [mode X, S={p.lanes} T={p.steps} full tables]")

    # K4x at the main path's size, its sort stage beside torch.sort.
    nf = pf.capacity
    inpf = torch.from_numpy(corpus[:nf].reshape(pf.lanes, pf.steps).copy()).to(dev)
    propk = blk.sort_candidates(pf, inpf, nf, content=True)
    propp, plain_ms = _timed_plain(blk.sort_candidates_plain, pf, inpf, nf, True)
    err = max_err([(propk, propp)])
    del propp
    ms = _kernel_ms("K4x", lambda: (pf, inpf, nf, True), blk.sort_candidates)
    bytes_pad = blk.pad_block(pf, inpf)
    keys = blk.sort_keys_plain(pf, bytes_pad, nf, True)
    cfg = blk.finder_cfg(pf, nf, True)

    def sort_stage(with_passes=False):
        return blk.sort_positions(pf, bytes_pad, nf, tag="k4x", cfg=cfg,
                                  with_passes=with_passes)

    hs, ps, passes = sort_stage(True)
    hp, pp = torch.sort(keys, stable=True)
    err = max(err, max_err([(hs, hp), (ps, pp)]))
    del hs, ps, hp, pp
    sort_ms = _event_ms(sort_stage)
    lib_ms = _event_ms(lambda: torch.sort(keys, stable=True))
    _record(res, "K4x", max(err, k4x_small["max_abs_err"]), ms, plain_ms,
            _nbytes(inpf, propk), k4x_ops(propk, nf), library_ms=lib_ms)
    r = res["K4x"]
    print(f"K4x at N={nf} (S=512 T={pf.steps}): max_abs_err {err}  kernel "
          f"{ms:.3f} ms  plain {plain_ms:.3f} ms  bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}); its sort stage (keys + {passes} radix passes) "
          f"{sort_ms:.3f} ms, torch.sort(stable) of the same keys (int64) "
          f"{lib_ms:.3f} ms; at "
          f"T={KERNEL_STEPS}: kernel {k4x_small['ms']:.3f} ms, plain "
          f"{k4x_small['plain_ms']:.3f} ms")
    for name, r in res.items():
        if r["max_abs_err"] != 0:
            raise AssertionError(
                f"{name}: kernel != plain (max err {r['max_abs_err']})")
    return res


def phase_kernels_p(corpus):
    """The mode-P kernels against their plain versions on the card: K13e,
    K3 (three slots, counted under K3) and K13d chained at S=512, T=256 with
    the full-size LZP tables.  Returns the per-kernel dicts of K13e, K13d."""
    import numpy as np
    import torch

    from comprox_tpu_torch.cli.main import make_params
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.models import ppm

    dev = "cuda"
    pf = make_params("crp", {"lanes": 512, "block_mb": 8}).block
    p = blk.BlockParams(lanes=512, steps=KERNEL_STEPS, mode="P",
                        min_len=pf.min_len, window=pf.window)
    big = n = p.capacity
    data = corpus[:n]
    inp = torch.from_numpy(data.reshape(p.lanes, p.steps).copy()).to(dev)
    res = {}

    def tables0():
        return ppm.init_tables(True, p.o3_bits, dev)

    def lzp0():
        return blk._init_lzp(p, dev)

    def touched(tk, zk):
        t0_, z0_ = tables0(), lzp0()
        return (sum(_touched_bytes(tk[k], t0_[k]) for k in tk)
                + sum(_touched_bytes(zk[k], z0_[k]) for k in zk))

    # K13e.  Operations: per position the o2 row (260 slots: read, adjust,
    # sum: 3), the side models (64) and the candidate (three hashes and
    # table reads, the verify: 16; one window compare, 8 bytes at a time).
    # Bytes: the block read, nine event grids written, the table rows and
    # LZP slots this run changed.
    ops = big * (3 * 260 + 64 + 16 + p.window // 8)
    tk, tp, zk, zp = tables0(), tables0(), lzp0(), lzp0()
    blk.reset_launch_counts()
    evk = blk.model_scan(p, inp, n, None, tk, zk)
    if blk.LAUNCHES["K13e"] != 1:
        raise AssertionError("K13e did not launch")
    evp, plain_ms = _timed_plain(blk.model_scan_plain, p, inp, n, None, tp, zp)
    err = max_err([(evk, evp)] + _tables_pairs(tk, tp) + _tables_pairs(zk, zp))
    ms = _kernel_ms("K13e", lambda: (p, inp, n, None, tables0(), lzp0()),
                    blk.model_scan)
    _record(res, "K13e", err, ms, plain_ms, _nbytes(inp, evk) + touched(tk, zk), ops)
    n_match = int(evk[:, 8].sum())
    if n_match == 0:
        raise AssertionError("K13e coded no match on corpus bytes")

    # K3 at three slots on K13e's events (the kernel mode R's phase holds).
    sk, ek, wk = blk.rans_scan(p, evk)
    sp, ep, wp = blk.rans_scan_plain(p, evk)
    if max_err([(sk, sp), (ek, ep), (wk, wp)]) != 0:
        raise AssertionError("K3 != plain on mode P's events")

    # K13d on the payload the kernels wrote.  Operations: as K13e without
    # the window compare.  Bytes: the words the stream holds.
    payload = blk._pack_payload(sk, ek, wk)
    n_words, st, stream = blk._unpack_payload(payload, p)
    st_t = torch.from_numpy(st.astype(np.int64)).to(dev)
    stream_t = torch.from_numpy(stream.astype(np.int32)).to(dev)
    tk, tp, zk, zp = tables0(), tables0(), lzp0(), lzp0()
    xk, uk, ok = blk.decode_scan(p, st_t, stream_t, n, tk, None, zk)
    (xp, up, op), plain_ms = _timed_plain(
        blk.decode_scan_plain, p, st_t, stream_t, n, tp, None, zp)
    if uk != up:
        raise AssertionError(f"K13d words used {uk} vs plain {up}")
    err = max_err([(xk, xp), (ok, op)] + _tables_pairs(tk, tp) + _tables_pairs(zk, zp))
    blk._check_drain(xk.cpu().numpy(), uk, n_words)
    if not np.array_equal(ok.cpu().numpy().reshape(-1), data):
        raise AssertionError("K13d did not decode the block")
    ms = _kernel_ms("K13d", lambda: (p, st_t, stream_t, n, tables0(), None, lzp0()),
                    blk.decode_scan)
    _record(res, "K13d", err, ms, plain_ms,
            4 * n_words + _nbytes(st_t, ok) + touched(tk, zk),
            big * (3 * 260 + 64 + 16))
    for name, r in res.items():
        print(f"{name}: max_abs_err {r['max_abs_err']} (tolerance 0)  kernel "
              f"{r['ms']:.3f} ms ({r['ms'] * 1e3 / p.steps:.1f} us/step)  "
              f"plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  [mode P, S={p.lanes} T={p.steps} full tables, "
              f"{n_match} matches]")
        if r["max_abs_err"] != 0:
            raise AssertionError(
                f"{name}: kernel != plain (max err {r['max_abs_err']})")
    return res


def phase_probes():
    """The nine probes at their own geometries, each kernel against its
    plain version (tolerance 0).  Returns ({name: record of its last
    geometry}, {name: launches in this phase})."""
    from comprox_tpu_torch.benchmarks import probes

    probes.reset_launch_counts()
    recs = probes.run()
    launches = dict(probes.LAUNCHES)
    res = {}
    for r in recs:
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{r['label']}: kernel != plain "
                                 f"(max err {r['max_abs_err']})")
        if r["probe"] in launches and not (
                "a thread a row" in r["label"] or "one launch a step" in r["label"]):
            res[r["probe"]] = dict(
                max_abs_err=r["max_abs_err"], ms=r["us"] / 1e3,
                plain_ms=r["plain_us"] / 1e3, bound_ms=r["bound_us"] / 1e3,
                bound_by=r["bound_by"],
                library_ms=None if r["library_us"] is None else r["library_us"] / 1e3)
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} was not launched by the probes")
    print("probe launches: " + json.dumps(launches))
    return res, launches


def phase_full_width(corpus, codec, archive, flags, needed, finder="sort"):
    """One path through the CLI: <codec> e [flags] -b8 -l512 and <codec> d
    (mode X's candidates from ``finder``).  The launch counts are set to 0
    just before and read just after."""
    import numpy as np

    from comprox_tpu_torch.cli import main as cli
    from comprox_tpu_torch.codec import block as blk

    want = json.loads((GOLDEN / "torch_golden.json").read_text())[archive]
    WORK.mkdir(parents=True, exist_ok=True)
    n = corpus.size
    src, arc, dst = WORK / "corpus8.bin", WORK / f"corpus8.{codec}", WORK / "out8.bin"
    corpus.tofile(src)
    blk.reset_launch_counts()
    t0 = time.perf_counter()
    with finder_knob("CPX_X_FINDER", finder):
        cli.run(codec, ["e", str(src), str(arc), *flags, "-b8", "-l512", "-q"],
                device="cuda")
    t_enc = time.perf_counter() - t0
    ms_enc = blk.kernel_ms()
    t0 = time.perf_counter()
    cli.run(codec, ["d", str(arc), str(dst), "-q"], device="cuda")
    t_dec = time.perf_counter() - t0
    ms_all = blk.kernel_ms()
    launches = dict(blk.LAUNCHES)
    got = arc.read_bytes()
    if sha256(got) != want["archive_sha256"]:
        raise AssertionError(
            f"8 MiB archive ({want['argv']}) differs from the JAX package's")
    if not np.array_equal(np.fromfile(dst, np.uint8), corpus):
        raise AssertionError("8 MiB round trip is not bit-exact")
    print(f"{want['argv']}: {n} B, S=512, T=16384, one block; archive "
          f"{len(got)} B == JAX golden, {len(got) * 8 / n:.4f} bpb; round "
          f"trip bit-exact")
    print(f"encode {n / t_enc / 1e6:.3f} MB/s ({t_enc:.3f} s wall); "
          f"decode {n / t_dec / 1e6:.3f} MB/s ({t_dec:.3f} s wall)")
    print("kernel time (CUDA events): " + ", ".join(
        f"{k} {ms_all[k]:.3f} ms" for k in ms_all if launches[k])
        + f"; encode kernels {sum(ms_enc.values()):.3f} ms, decode "
        f"{sum(ms_all.values()) - sum(ms_enc.values()):.3f} ms")
    print("launches: " + json.dumps(launches))
    for name in needed:
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on this path")
    for p in (src, arc, dst):
        p.unlink()
    return launches


def phase_fast_host_split(corpus):
    """Where the crf wall time goes on the host: the stages of ``crf e`` and
    ``crf d`` on the 8 MiB corpus, each called once more on its own and
    timed by the host clock (the block codec's calls end in a device
    synchronisation)."""
    import zlib

    import numpy as np
    import torch

    from comprox_tpu_torch.cli.main import make_params
    from comprox_tpu_torch.codec import block as blk
    from comprox_tpu_torch.codec import dictionary as dic
    from comprox_tpu_torch.codec import fast
    from comprox_tpu_torch.utils import native

    p = make_params("crf", {"lanes": 512, "block_mb": 8}).block

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    wd, t_build = timed(dic.build_dictionary, corpus)
    sub, t_sub = timed(dic.dict_encode, corpus, wd)
    blk.reset_launch_counts()
    payload, t_enc = timed(fast.encode_block_fast, sub, p, "cuda")
    k_enc = sum(blk.kernel_ms().values())
    _, t_crc = timed(zlib.crc32, sub.tobytes())
    blk.reset_launch_counts()
    out, t_dec = timed(fast.decode_block_fast, payload, sub.size, p, "cuda")
    k_dec = sum(blk.kernel_ms().values())
    if not np.array_equal(out, sub):
        raise AssertionError("crf block round trip is not bit-exact")
    tok, t_tok = timed(fast.decode_tokens, payload, sub.size, p, "cuda")
    res, t_exec = timed(native.f2_execute, tok, p.min_len, sub.size)
    if res is None or not np.array_equal(res, sub):
        raise AssertionError("f2_execute did not rebuild the block")
    _, t_undict = timed(dic.dict_decode, sub, wd)
    print(f"crf host split, 8 MiB corpus -> {sub.size} B after the dictionary, "
          f"{tok.size} tokens, payload {len(payload)} B (host clock, ms): "
          f"dictionary build {t_build:.1f}, dictionary encode {t_sub:.1f}, "
          f"block encode {t_enc:.1f} (kernels {k_enc:.3f}), content CRC "
          f"{t_crc:.1f}; block decode {t_dec:.1f} (kernel {k_dec:.3f}; unpack, "
          f"K10 and the token plane to the host {t_tok:.1f}, f2_execute "
          f"{t_exec:.1f}, CRC as above), dictionary decode {t_undict:.1f}")


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    ph = Phases()
    smi = ph.run("device", phase_device)
    ph.run("build", phase_build)
    corpora = ph.run("golden", phase_golden)
    res = ph.run("kernels, mode R", phase_kernels, corpora[MAIN_ARCHIVE])
    res.update(ph.run("sort", phase_sort, corpora[MAIN_ARCHIVE]))
    res_f = ph.run("kernels, mode F", phase_kernels_fast, corpora[FAST_ARCHIVE])
    k6f = res_f.pop("K6F")
    res.update(res_f)
    res["K6"]["max_abs_err"] = max(res["K6"]["max_abs_err"], k6f["max_abs_err"])
    res.update(ph.run("kernels, mode X", phase_kernels_x, corpora[X_ARCHIVE]))
    res.update(ph.run("kernels, mode P", phase_kernels_p, corpora[P_ARCHIVE]))
    res_probes, probe_launches = ph.run("probes", phase_probes)
    res.update(res_probes)
    crp = ph.run(
        "full width, crp", phase_full_width, corpora[P_ARCHIVE], "crp",
        P_ARCHIVE, [], ("K13e", "K3", "K13d"))
    xscan = ph.run(
        "full width, crx under the scan finder", phase_full_width,
        corpora[XSCAN_ARCHIVE], "crx", XSCAN_ARCHIVE, [],
        ("KSx", "K6", "K11", "K12e", "K3", "K12d"), "scan")
    if xscan["K4x"]:
        raise AssertionError("the scan finder's path launched K4x")
    crx = ph.run(
        "full width, crx", phase_full_width, corpora[X_ARCHIVE], "crx",
        X_ARCHIVE, [], ("K4x", "K11", "K6", "K12e", "K3", "K12d", "SORT"))
    launches = ph.run(
        "full width, crz flexible parse", phase_full_width, corpora[MAIN_ARCHIVE],
        "crz", MAIN_ARCHIVE, [], ("K4", "K5", "K6", "K2", "K3", "K1", "SORT"))
    ph.run("step scans by phase", phase_scan_phases)
    greedy = ph.run(
        "full width, crz greedy parse", phase_full_width, corpora[GREEDY_ARCHIVE],
        "crz", GREEDY_ARCHIVE, ["-f0"], ("KS", "K2", "K3", "K1"))
    launches["KS"] = greedy["KS"]
    fast = ph.run(
        "full width, crf", phase_full_width, corpora[FAST_ARCHIVE], "crf",
        FAST_ARCHIVE, [], ("K7", "K6", "K8", "K9", "K10", "SORT"))
    for name in ("K7", "K8", "K9", "K10"):
        launches[name] = fast[name]
    for name in ("K4x", "K11", "K12e", "K12d"):
        launches[name] = crx[name]
    launches["KSx"] = xscan["KSx"]
    launches["K13e"], launches["K13d"] = crp["K13e"], crp["K13d"]
    launches["K6 (X)"], launches["K3 (5 slots)"] = crx["K6"], crx["K3"]
    launches["SORT"] += crx["SORT"] + fast["SORT"]  # one in each of K4, K4x, K7
    launches.update(probe_launches)
    ph.run("crf host split", phase_fast_host_split, corpora[FAST_ARCHIVE])
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "comprox_tpu")]
    if bad:
        raise AssertionError(f"the port imported {bad}")
    import torch

    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": repl,
         "launches": launches[name], **res[name]}
        for name, source, repl in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
