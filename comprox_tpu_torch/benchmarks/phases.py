"""The step scans' time by phase on the card, from instrumented builds.

Three step scans of the crz path have an instrumented build: the decode
scan K1 (``csrc/decode.cu``, ``-DCPX_K1_PROF``), the rank scan K5
(``csrc/rank.cu``, ``-DCPX_K5_PROF``) and the modeling scan K2
(``csrc/model.cu``, ``-DCPX_K2_PROF``).  Each walks T dependent steps of
phases, most of them ended by a barrier; the instrumented build (a variant
beside the main library, built from that source alone; the main path never
builds one) reads the SM clock at the end of each phase and sums each
phase's cycles over the steps.  K1 stamps on thread 0; K5 and K2 on
thread 0 and on the launch's last thread (in K5's cluster, of the CTA that
reads the most other CTAs' keys), one column each.  K5 also sums, for each
phase from its keys barrier to the insert slot, the slowest thread of CTA
0 in each step (a third column: how much of the wait at the row barrier
CTA 0's stragglers explain).  A phase that ends at a barrier is the time
until the slowest warp got there; the others are the observer's own.
Every column is scaled to microseconds by thread 0's cycles a step
against the kernel's CUDA-event time.

This module builds the variants (K1 at each row-ring depth asked for:
``CPX_RING_D`` of ``csrc/ppm_r.cuh``, the rows of the A and B events in
flight a warp, 0 issuing a pair of rows when they are read; K5 and K2
together, at the build's depth), decodes a crz archive through K1's and
encodes its corpus again through K5's and K2's, checks the decoded bytes
and the archive against ``tests/data/torch_golden.json``, and reports each
phase's share of the cycles and its microseconds a step (the share times
the kernel's CUDA-event time over the steps).  On the card::

    python -m comprox_tpu_torch.benchmarks.phases [archive] [K1|K5|K2 ...] [depth ...]
    python -m comprox_tpu_torch.benchmarks.phases split [ctas ...]
    python -m comprox_tpu_torch.benchmarks.phases times

(default: the 8 MiB flexible crz golden, all three kernels, K1 at depths 0
and the build's default).  ``split`` times K5 on that golden's encode with
its 512 lanes split over each number of CTAs given (a cluster above one;
default 1 2 4 8 8 4 2 1), a variant build of ``csrc/rank.cu`` each.
``times`` prints the full-width time of every step scan (K1, K5, K2, KS,
K12d, K12e, KSx, K13d, K13e) in the main build, from the decode and the
encode of the 8 MiB goldens, and its bound at that width; run it in two
trees in turns to compare them.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

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
    "K2": ("model.cu", (
        "o1 rescale", "contexts, dec loads", "A event", "B event",
        "keys barrier", "idx/len rescale", "C event, ev stores",
        "elections, table stores", "adds", "finish",
    ), 2),
}
ENCODE_KERNELS = ("K5", "K2")  # one variant, one encode
GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "data"
ARCHIVE = GOLDEN / "crz_flex_8MiB_S512.cpx"


def default_depth() -> int:
    src = (build.CSRC / "ppm_r.cuh").read_text()
    return int(re.search(r"#define CPX_RING_D (\d+)", src).group(1))


def defines(depth: int) -> tuple:
    """K1's instrumented build at row-ring depth ``depth``."""
    return ("-DCPX_K1_PROF", f"-DCPX_RING_D={depth}")


ENCODE_DEFINES = tuple(f"-DCPX_{k}_PROF" for k in ENCODE_KERNELS)
ENCODE_SOURCES = tuple(PHASES[k][0] for k in ENCODE_KERNELS)


def variant_specs(depths=(), encode: bool = True) -> list:
    """``build.build_many`` specs: K1's variant at each depth, then (with
    ``encode``) K5's and K2's."""
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


def decode_breakdown(archive: bytes, depth: int) -> dict:
    """Decode ``archive`` (a crz archive) on the card through the
    instrumented K1 at ``depth``: K1's result, with the decoded bytes'
    ``sha256`` and the ``depth``."""
    cp, _ = read_header(io.BytesIO(archive))
    with build.variant(*defines(depth), only=("decode.cu",)):
        lib = build.lib()
        _read(lib, "K1")
        blk.reset_launch_counts()
        out = io.BytesIO()
        decode_stream(io.BytesIO(archive), out, "cuda")
        ms = blk.kernel_ms()["K1"]
        steps = blk.LAUNCHES["K1"] * cp.block.steps
        cyc = _read(lib, "K1")
    return _result("K1", cyc, ms, steps, depth=depth,
                   sha256=hashlib.sha256(out.getvalue()).hexdigest())


def encode_breakdown(corpus: np.ndarray, argv: str) -> list:
    """Encode ``corpus`` on the card under the crz command line ``argv``
    through the instrumented K5 and K2: their results, each with the
    archive's ``sha256``."""
    codec, _, _, _, opts = parse_args(argv.split() + ["in", "out"])
    cp = make_params(codec, opts)
    with build.variant(*ENCODE_DEFINES, only=ENCODE_SOURCES):
        lib = build.lib()
        for k in ENCODE_KERNELS:
            _read(lib, k)
        blk.reset_launch_counts()
        buf = io.BytesIO()
        encode_stream(corpus, buf, cp, "cuda", filters=opts["filters"])
        ms = blk.kernel_ms()
        cyc = {k: _read(lib, k) for k in ENCODE_KERNELS}
    sha = hashlib.sha256(buf.getvalue()).hexdigest()
    return [_result(k, cyc[k], ms[k], blk.LAUNCHES[k] * cp.block.steps, sha256=sha)
            for k in ENCODE_KERNELS]


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


# the full-width goldens and the step scans each one's decode and encode time
TIMED = (
    ("crz_flex_8MiB_S512.cpx", ("K1", "K5", "K2")),
    ("crz_f0_8MiB_S512.cpx", ("KS",)),
    ("crx_flex_8MiB_S512.cpx", ("K12d", "K12e")),
    ("crx_scan_flex_8MiB_S512.cpx", ("KSx",)),
    ("crp_8MiB_S512.cpx", ("K13d", "K13e")),
)


# the card's published peaks (NVIDIA H100 SXM data sheet, as chip_smoke.py):
# device memory rate, and the float32 rate outside the tensor cores, taken
# for the scans' 32-bit integer operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# a stated model of each step scan's 32-bit operations a position (the
# kernel cells' models of chip_smoke.py): the row entries scored and
# compared, the o2 row read, adjusted and summed, the side models
OPS_PER_POSITION = {
    "KS": lambda p: 6 * p.rolz_depth + p.top_k * p.probe // 8 + p.window // 8,
    "KSx": lambda p: 12 * p.rolz_depth + 3 * p.window // 8,
    "K5": lambda p: p.rolz_depth * (6 + 2 * blk._R_CANDS),
    "K2": lambda p: 3 * 260 + 64,
    "K12e": lambda p: 3 * 260 + 64,
    "K13e": lambda p: 3 * 260 + 64,
    "K1": lambda p: 3 * 260 + 64 + 4 * p.rolz_depth,
    "K12d": lambda p: 3 * 260 + 64,
    "K13d": lambda p: 3 * 260 + 64,
}
SCAN_ENTRIES = ("search_scan", "rank_scan", "model_scan", "decode_scan")


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
    result written once; and its block's parameters."""
    saved = {n: getattr(blk, n) for n in SCAN_ENTRIES}

    def wrap(fn):
        def entry(p, *args, **kw):
            before = dict(blk.LAUNCHES)
            ins = [t for a in (*args, *kw.values()) for t in _tensors(a)]
            snaps = [t.clone() for t in ins]
            out = fn(p, *args, **kw)
            nbytes = sum(t.numel() * t.element_size() for t in _tensors(out))
            for t, old in zip(ins, snaps):
                rows = t.reshape(t.shape[0], -1)
                changed = int((rows != old.reshape(rows.shape)).any(dim=1).sum())
                nbytes += (2 * changed * rows.shape[1] * t.element_size() if changed
                           else t.numel() * t.element_size())
            for k, v in blk.LAUNCHES.items():
                if v > before[k]:
                    log[k] = (nbytes, p)
            return out
        return entry

    for n in SCAN_ENTRIES:
        setattr(blk, n, wrap(saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(blk, n, fn)


def full_bound(kernel: str, nbytes: int, p) -> tuple:
    """(bound_ms, bound_by) of a full-width launch: the larger of its bytes
    over the memory rate and its modelled operations over the peak rate."""
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = p.capacity * OPS_PER_POSITION[kernel](p) / PEAK_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def times(timed=TIMED) -> dict:
    """Every step scan's CUDA-event ms at full width, in the main build,
    and its bound at that width (``full_bound``): each golden of ``timed``
    decoded on the card and its corpus encoded again under its command
    line (a knob in it set for the encode), the decoded bytes and the
    archive checked against the golden.  Prints a line; returns {kernel:
    (ms, bound_ms, bound_by)}."""
    meta = json.loads((GOLDEN / "torch_golden.json").read_text())
    out = {}
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
        try:
            blk.reset_launch_counts()
            buf = io.BytesIO()
            with _bytes_of_scans(moved):
                encode_stream(np.frombuffer(raw.getvalue(), np.uint8), buf,
                              make_params(codec, opts), "cuda", filters=opts["filters"])
            ms.update({k: v for k, v in blk.kernel_ms().items() if v})
        finally:
            blk._ENV.update(old)
        if hashlib.sha256(buf.getvalue()).hexdigest() != want["archive_sha256"]:
            raise AssertionError(f"{name}: the archive differs from the golden")
        out.update({k: (ms[k], *full_bound(k, *moved[k])) for k in kernels})
    print("step scans, ms: " + ", ".join(f"{k} {v[0]:.3f}" for k, v in out.items()),
          flush=True)
    print("full-width bounds, ms: " + ", ".join(
        f"{k} {v[1]:.4f} ({v[2]})" for k, v in out.items()), flush=True)
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
        verbose=False) -> dict:
    """Build the variants, run each kernel's breakdown, check the bytes,
    print one table a kernel; returns {kernel: [results]}."""
    depths = (0, default_depth()) if depths is None else tuple(depths)
    archive_path = Path(archive_path)
    want = json.loads((GOLDEN / "torch_golden.json").read_text())[archive_path.name]
    archive = archive_path.read_bytes()
    encode = [k for k in ENCODE_KERNELS if k in kernels]
    build.build_many([((), None)] + variant_specs(
        depths if "K1" in kernels else (), bool(encode)), verbose)
    out = {}
    if "K1" in kernels:
        out["K1"] = [decode_breakdown(archive, d) for d in depths]
        for r in out["K1"]:
            if r["sha256"] != want["input_sha256"]:
                raise AssertionError(f"K1 at depth {r['depth']}: decoded bytes differ")
    if encode:
        raw = io.BytesIO()
        decode_stream(io.BytesIO(archive), raw, "cuda")
        if hashlib.sha256(raw.getvalue()).hexdigest() != want["input_sha256"]:
            raise AssertionError("decoded bytes differ")
        res = encode_breakdown(np.frombuffer(raw.getvalue(), np.uint8), want["argv"])
        if res[0]["sha256"] != want["archive_sha256"]:
            raise AssertionError("the instrumented K5 and K2 wrote other bytes")
        out.update({r["kernel"]: [r] for r in res if r["kernel"] in encode})
    for k, results in out.items():
        print(f"{k} by phase, {archive_path.name} ({results[0]['steps']} steps; "
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
    arc = args.pop(0) if args and not args[0].isdigit() and args[0] not in PHASES else ARCHIVE
    ks = tuple(a for a in args if a in PHASES) or ("K1", "K5", "K2")
    run(arc, ks, [int(a) for a in args if a.isdigit()] or None)
