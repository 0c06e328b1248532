"""The step scans' time by phase on the card, from instrumented builds.

These step scans have an instrumented build: the decode scans K1 (crz,
``csrc/decode.cu``, ``-DCPX_K1_PROF``) and K12d / K13d (the tableless scan
of crx and crp, the same source, ``-DCPX_K12D_PROF``; both in one variant
of ``decode.cu``), the rank scan K5 (``csrc/rank.cu``, ``-DCPX_K5_PROF``),
the modeling scan K2 and its X and P entries (``csrc/model.cu``,
``-DCPX_K2_PROF``) and the search scans KS and KSx (``csrc/search.cu``,
``-DCPX_KS_PROF``; the encode variant builds all three sources).  Each
walks T dependent steps of phases, most of them ended by a barrier; the
instrumented build (a variant beside the main library, built from that
source alone; the main path never builds one) reads the SM clock at the
end of each phase and sums each phase's cycles over the steps.  K1 stamps
on thread 0; K5, K2, K12d, K13d, KS and KSx on thread 0 and on the
launch's last thread (in K5's and the search scans' clusters, of the CTA
that reads the most other CTAs' keys), one column each.  K5 also sums,
for each phase from its keys
barrier to the insert slot, the slowest thread of CTA 0 in each step (a
third column: how much of the wait at the row barrier CTA 0's stragglers
explain).  A phase that ends at a barrier is the time until the slowest
warp got there; the others are the observer's own.  Every column is
scaled to microseconds by thread 0's cycles a step against the kernel's
CUDA-event time.

This module builds the variants (the decode scans at each row-ring depth
asked for: ``CPX_RING_D`` of ``csrc/ppm_r.cuh``, the rows of the A and B
events in flight a warp, 0 issuing a pair of rows when they are read; K5
and K2 together, at the build's depth), decodes a crz archive through
K1's and encodes its corpus again through K5's and K2's, decodes the crx
and crp goldens through K12d's and K13d's, checks the decoded bytes and
the archive against ``tests/data/torch_golden.json``, and reports each
phase's share of the cycles and its microseconds a step (the share times
the kernel's CUDA-event time over the steps).  On the card::

    python -m comprox_tpu_torch.benchmarks.phases [archive] [K1|K5|K2|K12e|K13e|K12d|K13d|KS|KSx ...] [depth ...]
    python -m comprox_tpu_torch.benchmarks.phases split [ctas ...]
    python -m comprox_tpu_torch.benchmarks.phases times
    python -m comprox_tpu_torch.benchmarks.phases bounds
    python -m comprox_tpu_torch.benchmarks.phases k4stages [K4|K4x|K7|K13c|K8|K10|K9|K3b ...]
    python -m comprox_tpu_torch.benchmarks.phases k3 [LANESxDEPTH ...]
    python -m comprox_tpu_torch.benchmarks.phases k3b
    python -m comprox_tpu_torch.benchmarks.phases k6fit
    python -m comprox_tpu_torch.benchmarks.phases k6stamps

(default: the 8 MiB flexible crz golden for K1, K5 and K2, the 8 MiB crx
and crp goldens for K12d and K13d, the 8 MiB crz ``-f0`` and crx
scan-finder goldens' corpora for KS and KSx; K1, K5 and K2; each decode scan at
depths 0 and the build's default).  ``split`` times K5 on that golden's
encode with its 512 lanes split over each number of CTAs given (a cluster
above one; default 1 2 4 8 8 4 2 1), a variant build of ``csrc/rank.cu``
each.
``times`` prints the full-width time of every step scan (K1, K5, K2, KS,
K12d, K12e, KSx, K13d, K13e) in the main build, from the decode and the
encode of the 8 MiB goldens, and its bound at that width, and the same of
each launch of the flexible parse's passes: K6 (R) on crz, K6 (X) 1, K11
and K6 (X) 2 on crx, K6 (F) on crf; run it in two trees in turns to
compare them (``PYTHONPATH=<tree> python <this file> times`` times another
tree's package with this file); it ends with ``k4stages``' lines.
``k4stages`` prints the device ms of each stage of K4, K4x and K7 (keys,
the sort, the find, the heads' extension, the final stage), of K13c
(keys, the sort, the segmented max, the tables' store, the checks), of K8
(the replay, the chunks' reduce, the parts' scan, the emit; on the block's
K7 and K6 decisions), of K10 (the slot table, the decode loop, the
plane's reduce, parts and plane; on the block's own K9 stream), of K9
(the histogram, the normalisation, the one-CTA loop of the older design,
the token pass, K3's scan, K3p's pack and K3b's compaction; on the
block's K8 tokens) and of K3b (the older design's count, scan and
scatter, the look-back words' clear and the one pass; on K3's words and
K3p's mask of the crz golden's encode), from a ``torch.profiler`` trace,
and of the whole launch, on the 8 MiB crz, crx, crf and crp goldens'
blocks (default: all eight); each stage list names both designs'
kernels, so that one file times either tree.  ``bounds``
prints the full-width bound of every other kernel (the sort, K4, K4x, K7, K3, K3p, K3b, K6, K8-K11, K13c,
KCR) from the launches of the 8 MiB crz, crx, crf and crp goldens' decode
and encode.  ``k3`` times K3 on the 8 MiB crz, crx and crp goldens'
encodes at each ``LANESxDEPTH`` given (lanes a CTA, steps of events in
flight a lane; default 32x16 64x16 128x16 32x8 32x32 32x16), a variant
build of ``csrc/rans.cu`` each.  ``k3b`` times K3b's stages on random
masks of S = 512 lanes at several sizes and flag densities (``K3B_SWEEP``:
crz's full width and its density, all silent, all emitting, K9's mask on
the crf golden), through ``compact_stream`` alone, so that it times
either tree.  ``k6fit`` times K6 at full width on the
8 MiB goldens' own candidates at several candidate counts (mode R: 2, 3,
5 and 8 candidates, the ``CPX_R_CANDS`` of 1, 2, 4 and 7 with the
bucket's; mode X: 1, 3 and 5, without and with the repeat pair) and fits
microseconds a step to the count (a + b k), and times K11; it uses only
entry points that every tree has, so that it times another tree's kernels
too.  ``k6stamps`` builds ``parse.cu`` and ``xrep.cu`` with
``-DCPX_K6_PROF -DCPX_K11_PROF`` beside the main library and prints K6's
SM cycles a step by phase and K11's by walk on the same inputs.
"""

from __future__ import annotations

import contextlib
import hashlib
import inspect
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from comprox_tpu_torch.benchmarks import work
from comprox_tpu_torch.cli.main import make_params, parse_args
from comprox_tpu_torch.codec import block as blk
from comprox_tpu_torch.codec.container import decode_stream, encode_stream, read_header
from comprox_tpu_torch.utils import build

# kernel -> (source, its phases in stamp order, observers)
PHASES = {
    "K1": ("decode.cu", (
        "o1 rescale", "contexts, o2 rows issued", "bucket rows", "A event",
        "A renorm, keys, idx rescale", "B event", "B renorm, len rescale",
        "C event", "byte resolve", "bucket insert", "stores", "adds, finish",
    ), 1),
    "K5": ("rank.cu", (
        "contexts, proposal loads, keys posted", "keys barrier",
        "rows issued, insert rank", "rows landed", "search scan", "insert slot",
        "window compare", "output stores", "row barrier", "store",
    ), 3),
}
# the modeling scan's stamps (model.cu, K2_STAMP), one set for its three
# modes: R (K2), X (K12e) and P (K13e: its dec loads are K13c's candidate
# grid, and it has no idx rows to rescale)
MODELING = (
    "o1 rescale", "contexts, dec loads", "A event", "B event", "keys barrier",
    "idx/len rescale", "C event, ev stores", "elections, table stores", "adds",
    "finish",
)
PHASES.update({k: ("model.cu", MODELING, 2) for k in ("K2", "K12e", "K13e")})
# the tableless decode scan's stamps (decode.cu, K12D_STAMP), one set for
# its two modes: X (K12d) and P (K13d, whose D and E phase is empty)
TABLELESS = (
    "o1 rescale", "contexts, o2 rows issued, LZP candidate", "A event",
    "A renorm, keys, dst rescale", "B event, B renorm", "len rescale",
    "C event, C renorm", "D, E (X)", "byte resolve", "stores", "adds, finish",
)
PHASES.update({"K12d": ("decode.cu", TABLELESS, 2), "K13d": ("decode.cu", TABLELESS, 2)})
# the search scans' stamps (search.cu, KS_STAMP), one set for KS and KSx
# (KSx: both tables' rows, searches and inserts in each phase, and its
# near-match window with the extensions)
SEARCH = (
    "contexts, keys posted", "keys barrier", "rows issued, insert ranks", "rows landed",
    "top-k, fill, recency", "insert slots", "probes", "extensions, near-match window",
    "grids", "row barrier", "stores",
)
PHASES.update({k: ("search.cu", SEARCH, 2) for k in ("KS", "KSx")})
# a kernel's stamp set in its source, where it is not named for the kernel
STAMP_SET = {"K12d": "K12D", "K13d": "K12D", "K12e": "K2", "K13e": "K2", "KSx": "KS"}
DECODE_KERNELS = ("K1", "K12d", "K13d")  # the kernels of decode.cu's variant
# one variant of rank.cu + model.cu + search.cu
ENCODE_KERNELS = ("K5", "K2", "K12e", "K13e", "KS", "KSx")
GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "data"
ARCHIVE = GOLDEN / "crz_flex_8MiB_S512.cpx"
# the archive each crx and crp kernel codes by default (decoded, and for
# K12e and K13e its corpus encoded again)
OWN_ARCHIVES = {"K12d": GOLDEN / "crx_flex_8MiB_S512.cpx",
                "K13d": GOLDEN / "crp_8MiB_S512.cpx",
                "K12e": GOLDEN / "crx_flex_8MiB_S512.cpx",
                "K13e": GOLDEN / "crp_8MiB_S512.cpx",
                "KS": GOLDEN / "crz_f0_8MiB_S512.cpx",
                "KSx": GOLDEN / "crx_scan_flex_8MiB_S512.cpx"}


def default_depth() -> int:
    src = (build.CSRC / "ppm_r.cuh").read_text()
    return int(re.search(r"#define CPX_RING_D (\d+)", src).group(1))


def defines(depth: int) -> tuple:
    """The instrumented build of ``decode.cu`` (K1's stamps and the
    tableless scan's, K12d and K13d) at row-ring depth ``depth``."""
    return ("-DCPX_K1_PROF", "-DCPX_K12D_PROF", f"-DCPX_RING_D={depth}")


ENCODE_DEFINES = tuple(dict.fromkeys(f"-DCPX_{STAMP_SET.get(k, k)}_PROF"
                                     for k in ENCODE_KERNELS))
ENCODE_SOURCES = tuple(dict.fromkeys(PHASES[k][0] for k in ENCODE_KERNELS))


def variant_specs(depths=(), encode: bool = True) -> list:
    """``build.build_many`` specs: the decode scans' variant (K1, K12d,
    K13d) at each depth, then (with ``encode``) K5's and K2's."""
    return [(defines(d), ("decode.cu",)) for d in depths] + (
        [(ENCODE_DEFINES, ENCODE_SOURCES)] if encode else [])


def _read(lib, kernel: str) -> np.ndarray:
    _, names, obs = PHASES[kernel]
    cyc = np.zeros(obs * len(names), np.uint64)
    fn = f"cpx_{kernel.lower()}_prof_read"
    build.check(getattr(lib, fn)(cyc.ctypes.data), fn)
    return cyc.reshape(obs, len(names))


def _result(kernel: str, cyc: np.ndarray, ms: float, steps: int, **kw) -> dict:
    if not steps:
        raise AssertionError(f"the run launched no {kernel}")
    share = cyc / max(int(cyc[0].sum()), 1)  # of thread 0's cycles, the whole step
    return dict(kernel=kernel, ms=ms, steps=steps,
                cycles=cyc.astype(np.int64).tolist(), share=share.tolist(),
                us_per_step=(share * ms * 1e3 / steps).tolist(), **kw)


def decode_breakdown(archive: bytes, depth: int, kernel: str = "K1") -> dict:
    """Decode ``archive`` (crz for K1, crx for K12d, crp for K13d) on the
    card through the instrumented ``kernel`` at ``depth``: its result,
    with the decoded bytes' ``sha256`` and the ``depth``."""
    cp, _ = read_header(io.BytesIO(archive))
    with build.variant(*defines(depth), only=("decode.cu",)):
        lib = build.lib()
        _read(lib, kernel)
        blk.reset_launch_counts()
        out = io.BytesIO()
        decode_stream(io.BytesIO(archive), out, "cuda")
        ms = blk.kernel_ms()[kernel]
        steps = blk.LAUNCHES[kernel] * cp.block.steps
        cyc = _read(lib, kernel)
    return _result(kernel, cyc, ms, steps, depth=depth,
                   sha256=hashlib.sha256(out.getvalue()).hexdigest())


def encode_breakdown(corpus: np.ndarray, argv: str, kernels=("K5", "K2")) -> list:
    """Encode ``corpus`` on the card under the command line ``argv`` (crz
    for K5 and K2, crx for K12e, crp for K13e) through the instrumented
    ``kernels``: their results, each with the archive's ``sha256``."""
    env = dict(a.split("=") for a in argv.split() if "=" in a)
    codec, _, _, _, opts = parse_args([a for a in argv.split() if "=" not in a]
                                      + ["in", "out"])
    cp = make_params(codec, opts)
    old = {k: blk._ENV[k] for k in env}
    with build.variant(*ENCODE_DEFINES, only=ENCODE_SOURCES):
        lib = build.lib()
        for k in kernels:
            _read(lib, k)
        blk.reset_launch_counts()
        buf = io.BytesIO()
        blk._ENV.update(env)
        try:
            encode_stream(corpus, buf, cp, "cuda", filters=opts["filters"])
        finally:
            blk._ENV.update(old)
        ms = blk.kernel_ms()
        cyc = {k: _read(lib, k) for k in kernels}
    sha = hashlib.sha256(buf.getvalue()).hexdigest()
    return [_result(k, cyc[k], ms[k], blk.LAUNCHES[k] * cp.block.steps, sha256=sha)
            for k in kernels]


def split(ctas=(1, 2, 4, 8), archive_path=ARCHIVE) -> dict:
    """K5's CUDA-event ms on the crz encode of ``archive_path``'s corpus
    with a launch of at most 1024 lanes split over each number of CTAs in
    ``ctas`` (a cluster above 1; ``K5_CTAS`` of ``csrc/rank.cu``, a variant
    build each), in the order given; each archive checked against the
    golden.  Returns {ctas: [ms, ...]}."""
    archive_path = Path(archive_path)
    want = json.loads((GOLDEN / "torch_golden.json").read_text())[archive_path.name]
    codec, _, _, _, opts = parse_args(want["argv"].split() + ["in", "out"])
    cp = make_params(codec, opts)
    build.build_many([((), None)] + [((f"-DK5_CTAS={n}",), ("rank.cu",))
                                     for n in sorted(set(ctas))])
    raw = io.BytesIO()
    decode_stream(io.BytesIO(archive_path.read_bytes()), raw, "cuda")
    corpus = np.frombuffer(raw.getvalue(), np.uint8)
    out = {}
    for n in ctas:
        with build.variant(f"-DK5_CTAS={n}", only=("rank.cu",)):
            blk.reset_launch_counts()
            buf = io.BytesIO()
            encode_stream(corpus, buf, cp, "cuda", filters=opts["filters"])
            ms = blk.kernel_ms()["K5"]
        if hashlib.sha256(buf.getvalue()).hexdigest() != want["archive_sha256"]:
            raise AssertionError(f"K5 over {n} CTAs wrote other bytes")
        out.setdefault(n, []).append(ms)
        print(f"K5 over {n} CTA(s): {ms:.3f} ms", flush=True)
    return out


K3_ARCHIVES = ("crz_flex_8MiB_S512.cpx", "crx_flex_8MiB_S512.cpx", "crp_8MiB_S512.cpx")


def k3(configs=((32, 16), (64, 16), (128, 16), (32, 8), (32, 32), (32, 16))) -> dict:
    """K3's CUDA-event ms on the encodes of the ``K3_ARCHIVES`` goldens'
    corpora with each (lanes a CTA, steps in flight a lane) of
    ``configs`` (``K3_LANES``, ``K3_RING_D`` of ``csrc/rans.cu``, a variant
    build each), in the order given; each archive checked against the
    golden.  Returns {(lanes, depth): {archive: [ms, ...]}}."""
    meta = json.loads((GOLDEN / "torch_golden.json").read_text())

    def spec(lanes, depth):
        return (f"-DK3_LANES={lanes}", f"-DK3_RING_D={depth}"), ("rans.cu",)

    build.build_many([((), None)] + [spec(*c) for c in dict.fromkeys(configs)])
    corpora = {}
    for name in K3_ARCHIVES:
        raw = io.BytesIO()
        decode_stream(io.BytesIO((GOLDEN / name).read_bytes()), raw, "cuda")
        corpora[name] = np.frombuffer(raw.getvalue(), np.uint8)
    out = {}
    for c in configs:
        defines, only = spec(*c)
        for name in K3_ARCHIVES:
            codec, _, _, _, opts = parse_args(meta[name]["argv"].split() + ["in", "out"])
            buf = io.BytesIO()
            with build.variant(*defines, only=only):
                blk.reset_launch_counts()
                encode_stream(corpora[name], buf, make_params(codec, opts), "cuda",
                              filters=opts["filters"])
                ms = blk.kernel_ms()["K3"]
            if hashlib.sha256(buf.getvalue()).hexdigest() != meta[name]["archive_sha256"]:
                raise AssertionError(f"K3 at {c}: {name} differs from the golden")
            out.setdefault(c, {}).setdefault(name, []).append(ms)
        print(f"K3, {c[0]} lanes a CTA, {c[1]} steps in flight: " + ", ".join(
            f"{n.split('_')[0]} {v[-1]:.3f} ms" for n, v in out[c].items()), flush=True)
    return out


def _launch_ms(fn, name: str) -> float:
    """The mean device ms of ``K6_REPS`` launches of ``name`` by ``fn``
    after a warm-up."""
    fn()
    blk.reset_launch_counts()
    for _ in range(K6_REPS):
        fn()
    ms = _event_ms(name)
    if len(ms) != K6_REPS:
        raise AssertionError(f"{name}: {len(ms)} launches, {K6_REPS} expected")
    return sum(ms) / K6_REPS


def _golden_block(name: str):
    """The block parameters of a one-block 8 MiB golden and its decoded
    corpus as the [S, T] block on the card."""
    want = json.loads((GOLDEN / "torch_golden.json").read_text())[name]
    codec, _, _, _, opts = parse_args(want["argv"].split() + ["in", "out"])
    p = make_params(codec, opts).block
    raw = io.BytesIO()
    decode_stream(io.BytesIO((GOLDEN / name).read_bytes()), raw, "cuda")
    data = np.frombuffer(raw.getvalue(), np.uint8)
    if data.size != p.capacity:
        raise AssertionError(f"{name}: {data.size} bytes, not one full block")
    return p, torch.from_numpy(data.reshape(p.lanes, p.steps).copy()).cuda()


def _fit(points) -> tuple:
    """(a, b) of the least-squares line us = a + b k through (k, us)."""
    k = np.array([x for x, _ in points], float)
    us = np.array([y for _, y in points], float)
    b, a = np.polyfit(k, us, 1)
    return float(a), float(b)


# K6's candidate counts of ``k6fit``: mode R's CPX_R_CANDS of 1, 2, 4, 7
# with the bucket's; mode X's CPX_X_CANDS of 1, 3, 5 (the repeat candidate
# one more); and the launches a time is the mean of
K6_FIT_R = (2, 3, 5, 8)
K6_FIT_X = (1, 3, 5)
K6_REPS = 3


def _k6_inputs() -> dict:
    """K6's full-width inputs from the 8 MiB goldens' own passes: mode R's
    (block, n, K5's grids: four proposals and the bucket's, and the fill)
    and mode X's (block, n, K4x's grids at ``CPX_X_CANDS`` = 5, its
    prices, the block, the first parse of three and K11's repeat pair on
    it)."""
    import os

    out = {}
    p, inp = _golden_block("crz_flex_8MiB_S512.cpx")
    n = p.capacity
    out["R"] = (p, n, blk.rank_scan(p, inp, n, blk.sort_candidates(p, inp, n),
                                    blk._init_rolz(p, "cuda")))
    p, inp = _golden_block("crx_flex_8MiB_S512.cpx")
    n = p.capacity
    old = os.environ.get("CPX_X_CANDS")
    os.environ["CPX_X_CANDS"] = str(max(K6_FIT_X))
    try:
        cx = blk.sort_candidates(p, inp, n, content=True)
    finally:
        if old is None:
            del os.environ["CPX_X_CANDS"]
        else:
            os.environ["CPX_X_CANDS"] = old
    prices = blk.x_prices()
    first = blk.parse_scan(p, n, cx[:6].contiguous(), prices, 3)
    out["X"] = (p, n, cx, prices, inp, first, blk.rep_scan(p, inp, n, first))
    return out


def _k6_launches(inputs) -> dict:
    """{(mode, candidates): a function that launches K6 once on them}: mode
    R on K5's five candidates taken in order, repeated past five; mode X
    on the first n_c of K4x's, without and with the repeat pair."""
    out = {}
    p, n, ck = inputs["R"]
    trip = ck[:-1].reshape(-1, 3, p.steps, p.lanes)
    for nr in K6_FIT_R:
        idx = [k % trip.shape[0] for k in range(nr)]
        cands = torch.cat([trip[idx].reshape(3 * nr, p.steps, p.lanes), ck[-1:]]).contiguous()
        out[("R", nr)] = (lambda p=p, n=n, c=cands: blk.parse_scan(p, n, c))
    p, n, cx, prices, _, _, rep = inputs["X"]
    for nc in K6_FIT_X:
        cands = cx[:2 * nc].contiguous()
        out[("X", nc)] = (lambda p=p, n=n, c=cands, k=nc: blk.parse_scan(p, n, c, prices, k))
        out[("X rep", nc + 1)] = (
            lambda p=p, n=n, c=cands, k=nc: blk.parse_scan(p, n, c, prices, k, rep))
    return out


def k6fit() -> dict:
    """K6's full-width CUDA-event ms (mean of ``K6_REPS`` launches)
    against its candidate count (``_k6_launches``) on the 8 MiB crz and crx
    goldens' own candidates, and K11's on the first parse of three.  Prints
    each time and microseconds a step and the line a + b k of each mode;
    returns {(mode, count): ms}, K11's ms and the fits."""
    inputs = _k6_inputs()
    T = inputs["R"][0].steps
    out = {key: _launch_ms(fn, "K6") for key, fn in _k6_launches(inputs).items()}
    p, n, _, _, inp, first, _ = inputs["X"]
    k11 = _launch_ms(lambda: blk.rep_scan(p, inp, n, first), "K11")
    us = {k: v * 1e3 / T for k, v in out.items()}
    for (mode, k), ms in out.items():
        print(f"K6 ({mode}), {k} candidates: {ms:.3f} ms, {us[(mode, k)]:.4f} us a step",
              flush=True)
    print(f"K11 on the first parse: {k11:.3f} ms", flush=True)
    fits = {m: _fit([(k, v) for (mode, k), v in us.items() if mode.startswith(m)])
            for m in ("R", "X")}
    for m, (a, b) in fits.items():
        print(f"K6 ({m}) fit: {a:.4f} + {b:.4f} k us a step", flush=True)
    return {"ms": out, "k11_ms": k11, "fits": fits}


# K6's and K11's instrumented build (-DCPX_K6_PROF of parse.cu,
# -DCPX_K11_PROF of xrep.cu): K6's phases of a group of steps and K11's two
# walks, stamped on thread 0 of the launch's first CTA
K6_PHASES = ("literal compares, ring sync", "minima advanced and stored, warp sync",
             "candidates priced", "warp minima", "loop", "tile: wait, barrier, flush, fetch")
K11_PHASES = ("forward walk", "backward count")
K6_DEFINES = ("-DCPX_K6_PROF", "-DCPX_K11_PROF")
K6_SOURCES = ("parse.cu", "xrep.cu")


K6_STAMPED = (("R", 5), ("X", 3), ("X rep", 4))  # the launches k6stamps takes apart


def k6stamps() -> dict:
    """K6's cycles a step by phase on the full-width inputs ``K6_STAMPED`` of
    ``_k6_launches``, and K11's cycles by walk on the first parse of three,
    from the instrumented build (a variant of parse.cu and xrep.cu beside
    the main library; the main path never builds it), each beside the main
    build's CUDA-event ms (K6: and the instrumented build's).  Prints a
    line a key; returns {key: (cycles a step by phase, main ms, its ms)}
    and "K11": (cycles of each walk, ms, None)."""
    build.build_many([((), None), (K6_DEFINES, K6_SOURCES)])
    inputs = _k6_inputs()
    T = inputs["R"][0].steps  # both goldens' blocks
    launches = _k6_launches(inputs)
    out = {}
    for key in K6_STAMPED:
        fn = launches[key]
        ms = _launch_ms(fn, "K6")
        with build.variant(*K6_DEFINES, only=K6_SOURCES):
            lib = build.lib()
            cyc = np.zeros(len(K6_PHASES), np.uint64)
            build.check(lib.cpx_k6_prof_read(cyc.ctypes.data), "cpx_k6_prof_read")
            fn()
            torch.cuda.synchronize()
            build.check(lib.cpx_k6_prof_read(cyc.ctypes.data), "cpx_k6_prof_read")
            ms_i = _launch_ms(fn, "K6")
        per = (cyc.astype(np.float64) / T).tolist()
        out[key] = (per, ms, ms_i)
        print(f"K6 ({key[0]}, {key[1]} candidates): main {ms:.3f} ms, instrumented "
              f"{ms_i:.3f} ms; thread 0's cycles a step by phase: " + ", ".join(
                  f"{name} {c:.1f}" for name, c in zip(K6_PHASES, per))
              + f"; in all {sum(per):.1f}", flush=True)
    p, n, _, _, inp, first, _ = inputs["X"]
    ms = _launch_ms(lambda: blk.rep_scan(p, inp, n, first), "K11")
    with build.variant(*K6_DEFINES, only=K6_SOURCES):
        lib = build.lib()
        cyc = np.zeros(len(K11_PHASES), np.uint64)
        build.check(lib.cpx_k11_prof_read(cyc.ctypes.data), "cpx_k11_prof_read")
        blk.rep_scan(p, inp, n, first)
        torch.cuda.synchronize()
        build.check(lib.cpx_k11_prof_read(cyc.ctypes.data), "cpx_k11_prof_read")
    out["K11"] = (cyc.tolist(), ms, None)
    print(f"K11: main {ms:.3f} ms; thread 0's cycles: " + ", ".join(
        f"{name} {int(c)}" for name, c in zip(K11_PHASES, cyc)), flush=True)
    return out


# the full-width goldens and the step scans each one's decode and encode time
TIMED = (
    ("crz_flex_8MiB_S512.cpx", ("K1", "K5", "K2")),
    ("crz_f0_8MiB_S512.cpx", ("KS",)),
    ("crx_flex_8MiB_S512.cpx", ("K12d", "K12e")),
    ("crx_scan_flex_8MiB_S512.cpx", ("KSx",)),
    ("crp_8MiB_S512.cpx", ("K13d", "K13e")),
    ("crz_chainm_textelf_flex_16MiB_S512.cpx", ("K1ch", "K5ch")),
    ("crf_flex_8MiB_S512.cpx", ()),  # its K6 (F): PARSE_TIMED
)
# the other kernels ``times`` times beside the scans (their bounds: ``bounds``)
TIMED_PASSES = {"crp_8MiB_S512.cpx": ("K13c",),
                "crz_chainm_textelf_flex_16MiB_S512.cpx": ("KCR", "K3p")}
# the goldens whose encode ``times`` also times the flexible parse's passes
# on, a line a launch (its row: ``_parse_row``)
PARSE_TIMED = ("crz_flex_8MiB_S512.cpx", "crx_flex_8MiB_S512.cpx",
               "crf_flex_8MiB_S512.cpx")


# The sort finders' and K13c's stages by the kernels each launches, a name
# fragment each (a kernel counts under the first stage that names it; the
# sort's memset of its scratch is the sort's).  Each list names the
# kernels of the trees before and after a redesign, so that one file times
# both: K4's heads' extension (k4_heads, k4_ext) is new with its own final
# stage k4_final, which was sortlib.cuh's finder_final before; K7 took
# K4x's keys, find, heads and final kernels in place of k7_keys, k7_find
# and finder_final; K13c's one-pass segmented max (k13c_segmax) took the
# place of k13c_tile_agg, k13c_tile_scan, k13c_resolve and k13c_store.
SORT_STAGE = ("sort", ("rs_", "Memset"))
K4_STAGES = (("keys", ("k4_keys",)), SORT_STAGE,
             ("find", ("k4_find",)), ("heads", ("k4_heads", "k4_ext")),
             ("final", ("k4_final", "finder_final")))
K7_STAGES = (("keys", ("k7_keys", "k4_keys")), SORT_STAGE,
             ("find", ("k7_find", "k4_find")), ("heads", ("k4_heads",)),
             ("final", ("finder_final", "k4_final")))
K13C_STAGES = (("keys", ("k13c_keys",)), SORT_STAGE,
               ("segmax", ("k13c_tile_agg", "k13c_tile_scan", "k13c_resolve",
                           "k13c_segmax")),
               ("store", ("k13c_store",)), ("check", ("k13c_check",)))
# K8's replay was one kernel, k8_replay, a thread a lane; its chunked
# replay (k8_replay_clear, which zeroes the look-back words, then
# k8_replay_chunks) also writes the chunks' pairs that k8_reduce computed
# before.  K10's slot table (k10_table) moved into k10_decode's prologue.
K8_STAGES = (("replay", ("k8_replay",)), ("reduce", ("k8_reduce",)),
             ("parts", ("scan_parts",)), ("emit", ("k8_emit",)))
K10_STAGES = (("table", ("k10_table",)), ("decode", ("k10_decode",)),
              ("reduce", ("k10_reduce",)), ("parts", ("scan_parts",)),
              ("plane", ("k10_plane",)))
# K9 was k9_hist, k9_norm and one loop in one CTA, k9_encode; it is now the
# histogram, the normalisation, the token pass writing K3's event grid,
# then K3's scan, K3p and K3b.  K3b was three kernels (k3b_count, k3b_scan,
# k3b_scatter); it is now k3b_clear, which zeroes the look-back words,
# and one pass, k3b_pass.
K9_STAGES = (("hist", ("k9_hist",)), ("norm", ("k9_norm",)), ("encode", ("k9_encode",)),
             ("events", ("k9_events",)), ("scan", ("k3_kernel",)), ("pack", ("k3p_kernel",)),
             ("compact", ("k3b_",)))
K3B_STAGES = (("count", ("k3b_count",)), ("scan", ("k3b_scan",)),
              ("scatter", ("k3b_scatter",)), ("clear", ("k3b_clear",)),
              ("pass", ("k3b_pass",)))


def _fresh_lzp(p, inp, n, reps: int):
    """``reps`` sets of empty mode-P tables, one a launch."""
    return [blk._init_lzp(p, "cuda") for _ in range(reps)]


def _k7(p, inp, n):
    from comprox_tpu_torch.codec import fast
    fast.f2_find(p, inp, n)


def _k8_decisions(p, inp, n, reps: int):
    """K8's input on this block: K7's candidates and K6's decisions (the
    kernels), read by every launch."""
    from comprox_tpu_torch.codec import fast
    return fast._fast_find_matches(p, inp, n)


def _k10_stream(p, inp, n, reps: int):
    """K10's input on this block: the block's payload (the kernels), its
    table, states and stream zero-padded to ``_max_words``, as
    ``decode_tokens`` reads them; and the token count."""
    from comprox_tpu_torch.codec import fast
    payload = fast.encode_block_fast(inp.reshape(-1)[:n].cpu().numpy(), p, inp.device)
    _, n_tok, _, freq, states, stream = fast._unpack_payload(payload, n, p)
    dev = inp.device
    return (torch.from_numpy(freq).to(dev), torch.from_numpy(states.astype(np.int64)).to(dev),
            torch.from_numpy(stream).to(dev), n_tok)


def _k9_tokens(p, inp, n, reps: int):
    """K9's input on this block: K8's tokens of its K7 and K6 decisions
    (the kernels), read by every launch."""
    from comprox_tpu_torch.codec import fast
    return fast.tokenize(p, inp, n, fast._fast_find_matches(p, inp, n))


def _k9(p, st):
    from comprox_tpu_torch.codec import fast
    n_tok, sym, xtr, tbits = st
    fast.encode_scan(p, sym, xtr, tbits, n_tok)


def _k3b_grids(p, inp, n, reps: int):
    """K3b's input on this block: K3p's mask and K3's words of its encode
    (the kernels), read by every launch."""
    return blk.encode_passes(p, inp, n)[1:3]


def _k8(p, inp, n, dec):
    from comprox_tpu_torch.codec import fast
    fast.tokenize(p, inp, n, dec)


def _k10(p, st):
    from comprox_tpu_torch.codec import fast
    freq, states, stream, n_tok = st
    fast.decode_scan(p, freq, states, stream, n_tok)


# kernel -> (the golden whose block it is timed on, its stages, a launch
# of it on (p, inp, n, launch index, the state), the state's maker on
# (p, inp, n, launches) or None); each launch goes through an entry of the
# block API that every tree has
STAGED = {
    "K4": ("crz_flex_8MiB_S512.cpx", K4_STAGES,
           lambda p, inp, n, j, st: blk.sort_candidates(p, inp, n, False), None),
    "K4x": ("crx_flex_8MiB_S512.cpx", K4_STAGES,
            lambda p, inp, n, j, st: blk.sort_candidates(p, inp, n, True), None),
    "K7": ("crf_flex_8MiB_S512.cpx", K7_STAGES,
           lambda p, inp, n, j, st: _k7(p, inp, n), None),
    "K13c": ("crp_8MiB_S512.cpx", K13C_STAGES,
             lambda p, inp, n, j, st: blk.lzp_candidates(p, inp, n, st[j]), _fresh_lzp),
    "K8": ("crf_flex_8MiB_S512.cpx", K8_STAGES,
           lambda p, inp, n, j, st: _k8(p, inp, n, st), _k8_decisions),
    "K10": ("crf_flex_8MiB_S512.cpx", K10_STAGES,
            lambda p, inp, n, j, st: _k10(p, st), _k10_stream),
    "K9": ("crf_flex_8MiB_S512.cpx", K9_STAGES,
           lambda p, inp, n, j, st: _k9(p, st), _k9_tokens),
    "K3b": ("crz_flex_8MiB_S512.cpx", K3B_STAGES,
            lambda p, inp, n, j, st: blk.compact_stream(*st), _k3b_grids),
}
K4_GOLDENS = tuple(STAGED)


def kernel_stages(name: str, p, inp, n, reps: int = 3) -> dict:
    """The device ms of each stage of ``name`` (a key of ``STAGED``) on
    this block, a mean of ``reps`` launches after a warm-up: {stage: ms
    from the kernels' names in a ``torch.profiler`` trace (None where the
    trace holds no device time), "full": the wrapper's CUDA events}.
    K13c starts every launch from empty tables."""
    _, stages, launch, state = STAGED[name]
    st = state(p, inp, n, 1 + 2 * reps) if state else None
    launch(p, inp, n, 0, st)
    out = _stage_ms(stages, lambda j: launch(p, inp, n, 1 + j, st), reps)
    blk.reset_launch_counts()
    for j in range(reps):
        launch(p, inp, n, 1 + reps + j, st)
    out["full"] = blk.kernel_ms()[name] / reps
    return out


def _stage_ms(stages, launch, reps: int) -> dict:
    """{stage: the device ms of its kernels (by name, in a ``torch.profiler``
    trace of ``launch(j)`` for j < reps) a launch, None where the trace
    holds no device time}."""
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for j in range(reps):
            launch(j)
        torch.cuda.synchronize()
    us = dict.fromkeys((s for s, _ in stages), 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for stage, frags in stages:
            if any(f in e.name for f in frags):
                us[stage] += e.time_range.elapsed_us()
                break
    seen = any(us.values())
    return {s: v / reps / 1e3 if seen else None for s, v in us.items()}


# K3b's sweep: (rows of 512 lanes, flag density); crz's full width is
# 49,152 rows at ~0.85% (~213 K words), crf's K9 on the 8 MiB golden 2,667
# rows at ~27%
K3B_SWEEP = ((49152, 0.0), (49152, 0.0085), (49152, 0.27), (49152, 1.0),
             (12288, 0.0085), (98304, 0.0085), (2667, 0.27), (2667, 0.0))


def k3b_sweep(cases=K3B_SWEEP, reps: int = 5) -> list:
    """K3b's stages (``K3B_STAGES``, device ms from a ``torch.profiler``
    trace) on random masks and words of S = 512 lanes, one slot a row, at
    each (rows, density) of ``cases``: how its time goes with the mask's
    size and the share of flagged words.  Uses only ``compact_stream``, so
    it times any tree's K3b (``PYTHONPATH=<tree> python <this file> k3b``)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for rows, density in cases:
        emit = torch.rand((rows, 1, 512), generator=gen, device="cuda") < density
        packed = blk.pack_emit_plain(emit)
        words = torch.randint(0, 1 << 16, (rows, 1, 512), generator=gen, dtype=torch.int32,
                              device="cuda")
        nw = int(blk.compact_stream(packed, words)[0])
        st = _stage_ms(K3B_STAGES, lambda j: blk.compact_stream(packed, words), reps)
        print(k4_stage_line(f"K3b, {rows} rows, {nw} words", st), flush=True)
        out.append((rows, density, nw, st))
    return out


def k4_stages(p, inp, n, content: bool = False, reps: int = 3) -> dict:
    """K4's (K4x's: ``content``) stages: ``kernel_stages``."""
    return kernel_stages("K4x" if content else "K4", p, inp, n, reps)


def k4_stage_line(name: str, st: dict) -> str:
    return f"{name} stages, ms: " + ", ".join(
        f"{k} {'not measured' if v is None else f'{v:.3f}'}" for k, v in st.items())


def k4_stages_goldens(names=K4_GOLDENS) -> dict:
    """The stages (``kernel_stages``) of K4, K4x, K7, K13c, K8, K10, K9 and
    K3b at full width on the 8 MiB crz, crx, crf and crp goldens' blocks; prints a
    line each; returns {"K4 keys": ms, ...}."""
    out = {}
    for name in names:
        p, inp = _golden_block(STAGED[name][0])
        st = kernel_stages(name, p, inp, p.capacity)
        print(k4_stage_line(name, st), flush=True)
        out.update({f"{name} {k}": v for k, v in st.items()})
    return out


# the decode scan's entry: the block API's (a tree without the pipelined
# block API calls the public one)
SCAN_ENTRIES = ("search_scan", "rank_scan", "model_scan",
                "_decode_scan" if hasattr(blk, "_decode_scan") else "decode_scan")


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


@contextlib.contextmanager
def _bytes_of_scans(log: dict):
    """Inside the block, each step scan entry of the block API logs, under
    the kernel it launched, the bytes its function must move: each tensor
    argument it leaves as it was read once, each one it updates in place
    (a table) by the rows it changed, read and written once, and each
    result written once; and its modelled operations (``work.scan_ops``).
    Where the entry runs a whole-block pass before its scan (mode P's K13c,
    ``lzp_candidates``, whose own bound ``bounds`` counts), the scan reads
    the pass's result once and not the tables the pass took."""
    saved = {n: getattr(blk, n) for n in (*SCAN_ENTRIES, "lzp_candidates")}
    passes = []  # (the tables K13c took, its grid), within the current entry

    def lzp_pass(*args, **kw):
        grid = saved["lzp_candidates"](*args, **kw)
        bound = inspect.signature(saved["lzp_candidates"]).bind(*args, **kw)
        passes.append((bound.arguments["lzp"], grid))
        return grid

    def wrap(fn):
        def entry(p, *args, **kw):
            before = dict(blk.LAUNCHES)
            passes.clear()
            ins = [t for a in (*args, *kw.values()) for t in _tensors(a)]
            snaps = [t.clone() for t in ins]
            out = fn(p, *args, **kw)
            taken = {id(t) for lzp, _ in passes for t in _tensors(lzp)}
            nbytes = sum(t.numel() * t.element_size()
                         for t in _tensors([out, [grid for _, grid in passes]]))
            for t, old in zip(ins, snaps):
                if id(t) in taken:
                    continue
                rows = t.reshape(t.shape[0], -1)
                changed = int((rows != old.reshape(rows.shape)).any(dim=1).sum())
                nbytes += (2 * changed * rows.shape[1] * t.element_size() if changed
                           else t.numel() * t.element_size())
            for k, v in blk.LAUNCHES.items():
                if v > before[k] and k in work.SCAN_KERNELS:  # summed over blocks
                    old = log.get(k, (0, 0))
                    log[k] = (old[0] + nbytes, old[1] + work.scan_ops(k, p, out))
            return out
        return entry

    blk.lzp_candidates = lzp_pass
    for n in SCAN_ENTRIES:
        setattr(blk, n, wrap(saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(blk, n, fn)


def _parse_row(p, rep) -> str:
    """K6's row by the block's mode (mode X's second launch takes the
    repeat pair)."""
    if p.mode == "X":
        return "K6 (X) 2" if rep is not None else "K6 (X) 1"
    return f"K6 ({p.mode})"


@contextlib.contextmanager
def _parse_launches(log: list):
    """Inside the block, each launch of K6 (``parse_scan``) and K11
    (``rep_scan``) appends (row, bytes, operations) to ``log``, in launch
    order (``work.k6``, ``work.k11``)."""
    saved = {n: getattr(blk, n) for n in ("parse_scan", "rep_scan")}

    def k6(p, n, cands, prices=None, n_c=None, rep=None):
        out = saved["parse_scan"](p, n, cands, prices, n_c, rep)
        log.append((_parse_row(p, rep), *work.k6(p, n, cands, prices, n_c, rep, out=out)))
        return out

    def k11(p, inp, n, dec):
        out = saved["rep_scan"](p, inp, n, dec)
        log.append(("K11", *work.k11(p, inp, n, dec, out=out)))
        return out

    blk.parse_scan, blk.rep_scan = k6, k11
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(blk, n, fn)


def _event_ms(name: str) -> list:
    """The device ms of each launch of ``name`` since the last reset."""
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in blk._EVENTS[name]]


def times(timed=TIMED) -> dict:
    """Every step scan's CUDA-event ms at full width, in the main build,
    and its bound at that width (``work.bound`` of the launch's bytes and
    ``work.scan_ops``): each golden of ``timed``
    decoded on the card and its corpus encoded again under its command
    line (a knob in it set for the encode), the decoded bytes and the
    archive checked against the golden; K13c's ms beside crp's scans.
    Prints a line (two); returns {kernel: (ms, bound_ms, bound_by)}."""
    meta = json.loads((GOLDEN / "torch_golden.json").read_text())
    out, passes, parse = {}, {}, {}
    for name, kernels in timed:
        moved = {}
        want = meta[name]
        argv = want["argv"].split()
        env = dict(a.split("=") for a in argv if "=" in a)
        codec, _, _, _, opts = parse_args([a for a in argv if "=" not in a] + ["in", "out"])
        blk.reset_launch_counts()
        raw = io.BytesIO()
        with _bytes_of_scans(moved):
            decode_stream(io.BytesIO((GOLDEN / name).read_bytes()), raw, "cuda")
        ms = blk.kernel_ms()
        if hashlib.sha256(raw.getvalue()).hexdigest() != want["input_sha256"]:
            raise AssertionError(f"{name}: decoded bytes differ")
        old = {k: blk._ENV[k] for k in env}
        blk._ENV.update(env)
        launched = []
        try:
            blk.reset_launch_counts()
            buf = io.BytesIO()
            with _bytes_of_scans(moved), _parse_launches(launched):
                encode_stream(np.frombuffer(raw.getvalue(), np.uint8), buf,
                              make_params(codec, opts), "cuda", filters=opts["filters"],
                              chain=opts["chain"])
            ms.update({k: v for k, v in blk.kernel_ms().items() if v})
            each = {k: iter(_event_ms(k)) for k in ("K6", "K11")}
        finally:
            blk._ENV.update(old)
        if hashlib.sha256(buf.getvalue()).hexdigest() != want["archive_sha256"]:
            raise AssertionError(f"{name}: the archive differs from the golden")
        out.update({k: (ms[k], *work.bound(*moved[k])) for k in kernels})
        passes.update({k: ms[k] for k in TIMED_PASSES.get(name, ())})
        if name in PARSE_TIMED:
            for row, nbytes, ops in launched:
                parse[row] = (next(each["K11" if row == "K11" else "K6"]),
                              *work.bound(nbytes, ops))
    print("step scans, ms: " + ", ".join(f"{k} {v[0]:.3f}" for k, v in out.items()),
          flush=True)
    if parse:
        print("the flexible parse's launches, ms (bound ms): " + ", ".join(
            f"{k} {v[0]:.3f} ({v[1]:.4f} {v[2]})" for k, v in parse.items()), flush=True)
        out.update(parse)
    if passes:
        print("beside them, ms: " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()),
              flush=True)
    print("full-width bounds, ms: " + ", ".join(
        f"{k} {v[1]:.4f} ({v[2]})" for k, v in out.items()), flush=True)
    out.update({k: (v, None, None) for k, v in k4_stages_goldens().items()})
    return out


# The other kernels' full-width bounds: each is launched by an entry of
# the block API, whose arguments and result give its work (``work``).
# kernel -> (module, entry, its work function)
BOUND_ENTRIES = {
    "SORT": ("block", "_radix_sort", work.sort),
    "K4": ("block", "sort_candidates", work.k4),
    "K6": ("block", "parse_scan", work.k6),
    "K3": ("block", "rans_scan", work.k3),
    "K3p": ("block", "pack_emit", work.k3p),
    "K3b": ("block", "compact_stream", work.k3b),
    "KCR": ("block", "remap_chain_ment", work.kcr),
    "K11": ("block", "rep_scan", work.k11),
    "K13c": ("block", "lzp_candidates", work.k13c),
    "K7": ("fast", "f2_find", work.k7),
    "K8": ("fast", "tokenize", work.k8),
    # the cores the block API's start calls (a tree without them: the
    # public entries, which call nothing else)
    "K9": ("fast", "_encode_scan", work.k9),
    "K10": ("fast", "_decode_scan", work.k10),
}
# the kernel's row name by block mode, where one entry serves several
BOUND_ROWS = {("K4", "X"): "K4x", ("K6", "R"): "K6 (R)", ("K6", "X"): "K6 (X)",
              ("K6", "F"): "K6 (F)", ("K3", "X"): "K3 (5 slots)",
              ("K3p", "X"): "K3p (5 slots)", ("K3b", "X"): "K3b (5 slots)"}


@contextlib.contextmanager
def _bounds_of_entries(log: dict):
    """Inside the block, each entry of ``BOUND_ENTRIES`` adds its launch's
    (bytes, operations) to log[row] (row: the kernel, by the block's mode
    where one entry serves several; SORT by the mode of the last block, K3b,
    which takes no block parameters, by that of K3 before it)."""
    from comprox_tpu_torch.codec import fast

    mods = {"block": blk, "fast": fast}
    entries = {k: (mod, name if hasattr(mods[mod], name) else name.lstrip("_"), rule)
               for k, (mod, name, rule) in BOUND_ENTRIES.items()}
    saved = {(mod, name): getattr(mods[mod], name) for mod, name, _ in entries.values()}
    mode = [None]

    def wrap(kernel, fn, rule):
        def entry(*args, **kw):
            if args and isinstance(args[0], blk.BlockParams):
                mode[0] = args[0].mode
            out = fn(*args, **kw)
            row = (f"SORT ({mode[0]})" if kernel == "SORT"
                   else BOUND_ROWS.get((kernel, mode[0]), kernel))
            nbytes, ops = rule(*args, **kw, out=out)
            old = log.get(row, (0, 0))
            log[row] = (old[0] + int(nbytes), old[1] + int(ops))
            return out
        return entry

    for kernel, (mod, name, rule) in entries.items():
        setattr(mods[mod], name, wrap(kernel, saved[(mod, name)], rule))
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mods[mod], name, fn)


def bounds(names=("crz_flex_8MiB_S512.cpx", "crx_flex_8MiB_S512.cpx",
                  "crf_flex_8MiB_S512.cpx", "crp_8MiB_S512.cpx",
                  "crz_chainm_textelf_flex_16MiB_S512.cpx")) -> dict:
    """The full-width bound of every kernel that is not a step scan (the
    sort, K4, K4x, K7, K3, K3p, K3b, K6, K8-K11, K13c, KCR): each golden of ``names``
    decoded on the card and its corpus encoded again under its command
    line (the archive checked against the golden), each launch's bytes and
    modelled operations summed over the path.  Prints a line; returns {row:
    (bound_ms, bound_by, bytes, operations)}."""
    meta = json.loads((GOLDEN / "torch_golden.json").read_text())
    log = {}
    for name in names:
        want = meta[name]
        codec, _, _, _, opts = parse_args(want["argv"].split() + ["in", "out"])
        raw, buf = io.BytesIO(), io.BytesIO()
        with _bounds_of_entries(log):
            decode_stream(io.BytesIO((GOLDEN / name).read_bytes()), raw, "cuda")
            encode_stream(np.frombuffer(raw.getvalue(), np.uint8), buf,
                          make_params(codec, opts), "cuda", filters=opts["filters"],
                          chain=opts["chain"])
        if hashlib.sha256(buf.getvalue()).hexdigest() != want["archive_sha256"]:
            raise AssertionError(f"{name}: the archive differs from the golden")
    out = {row: work.bound(nbytes, ops) + (nbytes, ops)
           for row, (nbytes, ops) in log.items()}
    print("full-width bounds of the other kernels, ms: " + ", ".join(
        f"{k} {v[0]:.4f} ({v[1]}; {v[2]} B, {v[3]} ops)" for k, v in sorted(out.items())),
        flush=True)
    return out


def table(results) -> str:
    """One kernel's phases as rows, a (share, us/step) column pair per
    result and observer."""
    kernel = results[0]["kernel"]
    names = PHASES[kernel][1]
    cols = []
    for r in results:
        tag = f"depth {r['depth']}" if "depth" in r else kernel
        for o in range(len(r["share"])):
            who = ("", ", last thread", ", slowest")[o]
            cols.append((r, o, f"{tag}{who}: share, us/step"))
    rows = ["phase".ljust(36) + "".join(f"  {c[2]}" for c in cols)]
    for k, name in enumerate(names):
        rows.append(name.ljust(36) + "".join(
            f"  {r['share'][o][k] * 100:{len(h) - 10}.1f}% {r['us_per_step'][o][k]:8.2f}"
            for r, o, h in cols))
    rows.append(kernel.ljust(36) + "".join(
        f"  {r['ms']:{len(h) - 10}.3f} ms {r['ms'] * 1e3 / r['steps']:6.2f}"
        for r, o, h in cols))
    rows.append("observer's cycles a step".ljust(36) + "".join(
        f"  {sum(r['cycles'][o]) / r['steps']:{len(h) - 1}.0f}" for r, o, h in cols))
    return "\n".join(rows)


def run(archive_path=ARCHIVE, kernels=("K1", "K5", "K2"), depths=None,
        verbose=False, archives=None) -> dict:
    """Build the variants, run each kernel's breakdown, check the bytes,
    print one table a kernel; returns {kernel: [results]}.  K1, K5 and K2
    code ``archive_path`` (crz); K12d, K13d, K12e and K13e their archive of
    ``archives`` (default ``OWN_ARCHIVES``): K12d and K13d decode it, K12e
    and K13e encode its corpus again; each decode scan runs at every
    depth."""
    depths = (0, default_depth()) if depths is None else tuple(depths)
    archive_path = Path(archive_path)
    meta = json.loads((GOLDEN / "torch_golden.json").read_text())
    paths = {k: archive_path for k in PHASES}
    paths.update(OWN_ARCHIVES)
    paths.update({k: Path(v) for k, v in (archives or {}).items()})
    encode = [k for k in ENCODE_KERNELS if k in kernels]
    decode = [k for k in DECODE_KERNELS if k in kernels]
    build.build_many([((), None)] + variant_specs(
        depths if decode else (), bool(encode)), verbose)
    out = {}
    for k in decode:
        out[k] = [decode_breakdown(paths[k].read_bytes(), d, k) for d in depths]
        for r in out[k]:
            if r["sha256"] != meta[paths[k].name]["input_sha256"]:
                raise AssertionError(f"{k} at depth {r['depth']}: decoded bytes differ")
    for path in dict.fromkeys(paths[k] for k in encode):
        want = meta[path.name]
        raw = io.BytesIO()
        decode_stream(io.BytesIO(path.read_bytes()), raw, "cuda")
        if hashlib.sha256(raw.getvalue()).hexdigest() != want["input_sha256"]:
            raise AssertionError(f"{path.name}: decoded bytes differ")
        mine = tuple(k for k in encode if paths[k] == path)
        res = encode_breakdown(np.frombuffer(raw.getvalue(), np.uint8), want["argv"], mine)
        if res[0]["sha256"] != want["archive_sha256"]:
            raise AssertionError(f"the instrumented {', '.join(mine)} wrote other bytes")
        out.update({r["kernel"]: [r] for r in res})
    for k, results in out.items():
        print(f"{k} by phase, {paths[k].name} ({results[0]['steps']} steps; "
              f"clock64 in the instrumented build of {PHASES[k][0]}):")
        print(table(results))
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["split"]:
        split([int(a) for a in args[1:]] or (1, 2, 4, 8, 8, 4, 2, 1))
        sys.exit(0)
    if args[:1] == ["times"]:
        times()
        sys.exit(0)
    if args[:1] == ["bounds"]:
        bounds()
        sys.exit(0)
    if args[:1] == ["k4stages"]:
        k4_stages_goldens(tuple(args[1:]) or K4_GOLDENS)
        sys.exit(0)
    if args[:1] == ["k3b"]:
        k3b_sweep()
        sys.exit(0)
    if args[:1] == ["k6fit"]:
        k6fit()
        sys.exit(0)
    if args[:1] == ["k6stamps"]:
        k6stamps()
        sys.exit(0)
    if args[:1] == ["k3"]:
        configs = [tuple(int(v) for v in a.split("x")) for a in args[1:]]
        k3(*([configs] if configs else []))
        sys.exit(0)
    arc = args.pop(0) if args and not args[0].isdigit() and args[0] not in PHASES else ARCHIVE
    ks = tuple(a for a in args if a in PHASES) or ("K1", "K5", "K2")
    run(arc, ks, [int(a) for a in args if a.isdigit()] or None)
