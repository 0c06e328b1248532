"""The nine Pallas probes of the JAX package's ``benchmarks/`` on the H100.

Each probe asks what one primitive of the codec's step scans costs on the
card: a random row or element of a table, row reads issued one after
another, a step that waits on the step before it, a one-hot product on the
tensor cores in place of a gather.  The kernels are ``csrc/probes.cu``;
each public function below takes tensors and returns the result: the
kernel for CUDA tensors, the plain PyTorch version for CPU tensors, and
an error for anything else.  Every index lies in [0, rows) (an element
index in [0, rows * width)): the plain versions raise outside it and the
kernels do not check it.  Names are the JAX package's:

=====  =================================  ==========================================
probe  function                           JAX function (``pallas_call`` line)
=====  =================================  ==========================================
p1     :func:`probe_vmem_gather`          ``benchmarks/pallas_probe.py:45`` (:56)
p1b    :func:`probe_vmem_gather_1d`       ``pallas_probe.py:78`` (:97)
p2     :func:`probe_onehot_matmul`        ``pallas_probe.py:120`` (plain XLA: no kernel)
p3     :func:`probe_dynslice_loop`        ``pallas_probe.py:150`` (:164)
p4     :func:`probe_persistent_steps`     ``pallas_probe.py:185`` (:204; ``run_scan`` :211)
p5     :func:`probe_dma_depth`            ``pallas_probe.py:238`` (:272)
p6     :func:`probe_taa`                  ``benchmarks/pallas_probe2.py:37`` (:51)
p7     :func:`probe_elem`                 ``pallas_probe2.py:74`` (:100)
p8     :func:`probe_kernel_onehot`        ``pallas_probe2.py:122`` (:142)
p9     :func:`probe_dma`                  ``pallas_probe2.py:165`` (:203)
=====  =================================  ==========================================

P5 and P9 return ``table[idx]``, the check the JAX probes print; their JAX
kernels start the copy of row k + depth into the slot of row k before
reading that slot, so what they return depends on when the copy lands.

``PROBES`` maps each probe to the cases of its own geometries (S = 512
lanes, the JAX probes' shapes and input recipes, numpy from a seed).  On the
card::

    python -m comprox_tpu_torch.benchmarks.probes [p1 p1b ...]

prints one line per case in the JAX probes' words: microseconds per call
(CUDA events, the mean of 20 calls after 3 warm-ups, as JAX's ``timeit``;
the calls wait behind a sleep kernel, so the events time the card's work
and the launch gaps between calls, not Python's issue of them, except in
P4's arm of one launch a step from the host; a probe named twice is run
twice, in the order named, for turns),
nanoseconds per row where JAX printed them, ``exact=`` (the kernel equals
its plain version), the plain version's time, the time of one PyTorch call
for the same function (``library=``, never used here) and the least time
the card could take (``bound=``), after one line of the launch floor (an
empty kernel by the same timing, no probe).  ``... probes --trace p4``
prints instead each headline case's kernels by name and device time, from
a ``torch.profiler`` trace (:func:`trace`).  ``LAUNCHES`` counts each
probe's kernel launches, each probe's headline arm under its name and the
other arms apart: P1's thread a row under ``P1t``, P3's one warp under
``P3w``, P4's launch a step (from the host or a CUDA graph) under ``P4s``
and P1's flat gather on P5's rows under ``P5w``.  P5 and P9 flush the L2
cache before each timed call: their table stands for one in device
memory.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from comprox_tpu_torch.codec.block import _dispatch, _expect, _stream_ptr
from comprox_tpu_torch.utils import build

S = 512  # lanes: the indices of one step
STEPS = 512  # P4's dependent steps
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory,
# float32 outside the tensor cores (taken for 32-bit integer operations
# too), dense bf16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
L2_FLUSH_BYTES = 96 << 20  # twice the 50 MB L2
ONEHOT_MAX_S = 512  # P8's output rows a CTA holds (probes.cu's OH_S)
STEPS_MAX_ROWS = 232448 // 4  # P4's column in a CTA (probes.cu's STEPS_SMEM_MAX)

LAUNCHES = {k: 0 for k in ("P1", "P1t", "P1b", "P3", "P3w", "P4", "P4s", "P5",
                           "P5w", "P6", "P7", "P8", "P9")}
_i32, _f32 = torch.int32, torch.float32


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(name: str, entry: str, *args) -> None:
    LAUNCHES[name] += 1
    build.check(getattr(build.lib(), entry)(*args, _stream_ptr()), entry)


def _expect_rows(table, idx, dtype=_i32):
    _expect(table, "table", dtype, table.shape)
    if table.dim() != 2:
        raise ValueError("table: expected [rows, width]")
    _expect(idx, "idx", _i32, idx.shape[:1])


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def row_gather_plain(table, idx):
    """P1, P3, P5, P6, P9: ``table[idx]``."""
    return table[idx.long()]


def elem_gather_plain(table, idx):
    """P1b, P7: ``flat[idx]`` as [S, 1]."""
    return table.reshape(-1)[idx.long()].unsqueeze(1)


def steps_plain(table, lanes: int, steps: int):
    """P4: ``steps`` dependent steps ``s += table[int(s) & (rows - 1), 0]``
    of ``lanes`` f32 states from zero -> [lanes] f32."""
    s = torch.zeros(lanes, dtype=_f32, device=table.device)
    for _ in range(steps):
        s = s + table[(s.to(_i32) & (table.shape[0] - 1)).long(), 0]
    return s


def onehot_bf16_plain(table, idx):
    """P8: ``bf16(table)[idx]`` in f32, which the one-hot bf16 product
    equals exactly (one 1 a row, f32 accumulation)."""
    return table.bfloat16()[idx.long()].float()


# --------------------------------------------------------------------------
# The probes
# --------------------------------------------------------------------------


def _row_gather(name, table, idx, arm="flat"):
    if _dispatch(table, idx) == "cpu":
        return row_gather_plain(table, idx)
    if arm not in ("flat", "thread"):
        raise ValueError(f"arm {arm!r}: 'flat' or 'thread'")
    _expect_rows(table, idx)
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=_i32, device=idx.device)
    _launch(name, "cpx_pr_row_gather_launch", table.data_ptr(), idx.data_ptr(),
            out.data_ptr(), *table.shape, idx.shape[0], int(arm == "thread"))
    return out


def probe_vmem_gather(table, idx, arm="flat"):
    """P1: ``table[idx]`` ([rows, width] int32, [S] int32 -> [S, width]);
    ``arm`` "flat" (the output flat, a 16-byte word a thread where the
    width and alignment allow, else a 4-byte word: probes.cu's
    ``pr_row_gather``) or "thread" (a thread a row, counted under
    ``P1t``)."""
    return _row_gather("P1t" if arm == "thread" else "P1", table, idx, arm)


def probe_taa(table, idx):
    """P6: the row gather written as ``take_along_axis``; P1's kernel."""
    return _row_gather("P6", table, idx)


def _elem_gather(name, table, idx):
    if _dispatch(table, idx) == "cpu":
        return elem_gather_plain(table, idx)
    _expect_rows(table, idx)
    out = torch.empty((idx.shape[0], 1), dtype=_i32, device=idx.device)
    _launch(name, "cpx_pr_elem_gather_launch", table.data_ptr(), idx.data_ptr(),
            out.data_ptr(), table.numel(), idx.shape[0])
    return out


def probe_vmem_gather_1d(table, idx):
    """P1b: the o3 element gather ``flat[idx]`` ([rows, 128] int32, [S]
    int32 -> [S, 1])."""
    return _elem_gather("P1b", table, idx)


def probe_elem(table, idx):
    """P7: the o3 element gather, row then column; P1b's kernel."""
    return _elem_gather("P7", table, idx)


def probe_dynslice_loop(table, idx, arm="bulk"):
    """P3: ``table[idx]`` by S row reads ([rows, width] int32, [S] int32 ->
    [S, width]).  Arm "bulk": a few rows a CTA (probes.cu's ``BULK_R``),
    each a bulk copy of the copy engine, stored with one more (a width that
    is a multiple of 4, a 16-byte aligned table, a CTA's rows within 48 KB);
    "warp": one warp reading the rows one after another, counted under
    ``P3w``."""
    if arm not in ("bulk", "warp"):
        raise ValueError(f"arm {arm!r}: 'bulk' or 'warp'")
    if _dispatch(table, idx) == "cpu":
        return row_gather_plain(table, idx)
    _expect_rows(table, idx)
    rows, width = table.shape
    S = idx.shape[0]
    out = torch.empty((S, width), dtype=_i32, device=idx.device)
    if arm == "warp":
        _launch("P3w", "cpx_pr_row_loop_launch", table.data_ptr(), idx.data_ptr(),
                out.data_ptr(), rows, width, S)
        return out
    smem = build.lib().cpx_pr_row_bulk_smem(width, S)
    if width % 4 or table.data_ptr() % 16 or smem > 48 * 1024:
        raise ValueError(
            f"the bulk-copy arm takes rows of a multiple of 16 bytes, a "
            f"16-byte aligned table and a CTA's rows within 48 KB (width "
            f"{width}, table at {table.data_ptr() % 16} past 16 bytes: "
            f"{smem} B)")
    _launch("P3", "cpx_pr_row_bulk_launch", table.data_ptr(), idx.data_ptr(),
            out.data_ptr(), rows, width, S)
    return out


class _StepGraph:
    """P4's launch-per-step arm captured once in a CUDA graph (the state
    reset and ``steps`` launches); each call replays it."""

    def __init__(self, table, lanes: int, steps: int):
        self.state = torch.empty(lanes, dtype=_f32, device=table.device)
        self.steps = steps
        lib = build.lib()  # loaded before the capture
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.state.zero_()
            for _ in range(steps):
                build.check(lib.cpx_pr_step_launch(
                    table.data_ptr(), self.state.data_ptr(), *table.shape,
                    lanes, _stream_ptr()), "cpx_pr_step_launch")

    def __call__(self):
        LAUNCHES["P4s"] += self.steps
        self.graph.replay()
        return self.state.clone()


def probe_persistent_steps(table, lanes: int = S, steps: int = STEPS,
                           arm="persistent"):
    """P4: ``steps`` dependent steps of ``lanes`` f32 states, ``s +=
    table[int(s) & (rows - 1), 0]`` from zero ([rows, width] f32).  Arm
    "persistent" (one launch, JAX's ``run_pallas``; on the card each CTA
    stages column 0 in its shared memory, so at most ``STEPS_MAX_ROWS``
    rows) -> [lanes, 1]; "launch"
    (one launch a step) and "graph" (the same launches replayed from a CUDA
    graph), JAX's ``run_scan`` -> [lanes], counted under ``P4s``."""
    if arm not in ("persistent", "launch", "graph"):
        raise ValueError(f"arm {arm!r}: 'persistent', 'launch' or 'graph'")
    if _dispatch(table) == "cpu":
        s = steps_plain(table, lanes, steps)
        return s.unsqueeze(1) if arm == "persistent" else s
    _expect(table, "table", _f32, table.shape)
    if table.dim() != 2:
        raise ValueError("table: expected [rows, width]")
    if arm == "graph":
        return _StepGraph(table, lanes, steps)()
    if arm == "persistent":
        if table.shape[0] > STEPS_MAX_ROWS:
            raise ValueError(
                f"the persistent arm stages column 0 in a CTA's shared memory: "
                f"at most {STEPS_MAX_ROWS} rows ({table.shape[0]} given)")
        s = torch.empty(lanes, dtype=_f32, device=table.device)  # every lane written
        _launch("P4", "cpx_pr_steps_launch", table.data_ptr(), s.data_ptr(),
                *table.shape, lanes, steps)
        return s.unsqueeze(1)
    s = torch.zeros(lanes, dtype=_f32, device=table.device)  # updated in place
    for _ in range(steps):
        _launch("P4s", "cpx_pr_step_launch", table.data_ptr(), s.data_ptr(),
                *table.shape, lanes)
    return s


def _row_ring(name, table, idx, depth):
    if _dispatch(table, idx) == "cpu":
        return row_gather_plain(table, idx)
    _expect_rows(table, idx)
    rows, width = table.shape
    S = idx.shape[0]
    if depth not in (16, 32):
        raise ValueError(f"depth {depth}: the ring kernel takes depth 16 or 32")
    smem = build.lib().cpx_pr_row_ring_smem(width, S, depth)
    if width % 4 or not 4 <= width <= 4096 or smem > 48 * 1024 or table.data_ptr() % 16:
        raise ValueError(
            f"the ring kernel takes a 16-byte aligned table of a width that is "
            f"a multiple of 4 up to 4096, and a CTA's ring and indices within "
            f"48 KB (width {width}, table at {table.data_ptr() % 16} past 16 "
            f"bytes, depth {depth}: {smem} B)")
    out = torch.empty((S, width), dtype=_i32, device=idx.device)
    _launch(name, "cpx_pr_row_ring_launch", table.data_ptr(), idx.data_ptr(),
            out.data_ptr(), rows, width, S, depth)
    return out


def probe_dma_depth(table, idx, depth=16):
    """P5: ``table[idx]`` through a ring of ``depth`` (16 or 32) row copies
    in flight ([rows, width] int32, [S] int32 -> [S, width]).  On the card
    the rows are spread over CTAs, a few a CTA (probes.cu's ``RING_R``),
    each CTA's rows through its own ring of bulk copies, a slot and its
    barrier each (a width that is a multiple of 4 up to 4096, a 16-byte
    aligned table, a CTA's ring within 48 KB).  A CTA with no more rows than
    ``depth`` never reuses a slot: then depth 16 and 32 do the same work."""
    return _row_ring("P5", table, idx, depth)


def probe_dma(table, idx):
    """P9: P5 at depth 16 (the same kernel)."""
    return _row_ring("P9", table, idx, 16)


def probe_kernel_onehot(table, idx):
    """P8: ``onehot(idx) @ bf16(table)`` with f32 accumulation on the tensor
    cores ([rows, width] f32, [S] int32 -> [S, width] f32), which equals
    ``bf16(table)[idx]`` for a finite table: a table with an Inf or NaN is
    not P8's input (its products with the one-hot's zeros are NaN).  On the
    card rows and width are multiples of 64, S at most 512 (the rows a CTA
    holds) and the table 16-byte aligned."""
    if _dispatch(table, idx) == "cpu":
        return onehot_bf16_plain(table, idx)
    _expect_rows(table, idx, _f32)
    rows, width = table.shape
    S = idx.shape[0]
    if rows % 64 or width % 64 or not rows or not width:
        raise ValueError(f"rows {rows} and width {width} must be multiples of 64")
    if not 1 <= S <= ONEHOT_MAX_S:
        raise ValueError(f"S {S}: the kernel holds 1 to {ONEHOT_MAX_S} output "
                         "rows a CTA")
    if table.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned")
    out = torch.empty((S, width), dtype=_f32, device=idx.device)
    _launch("P8", "cpx_pr_onehot_wgmma_launch", table.data_ptr(), idx.data_ptr(),
            out.data_ptr(), rows, width, S)
    return out


@contextlib.contextmanager
def _full_f32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def probe_onehot_matmul(table, idx, bf16=False):
    """P2: ``onehot(idx) @ table`` by ``torch.matmul`` (no kernel of the
    port, as JAX left it to XLA): in full f32 (TF32 off: JAX's HIGHEST) or
    with bf16 operands, f32 out."""
    rows = table.shape[0]
    oh = idx.long()[:, None] == torch.arange(rows, device=idx.device)[None, :]
    if bf16:
        return torch.matmul(oh.bfloat16(), table.bfloat16()).float()
    with _full_f32():
        return torch.matmul(oh.float(), table)


# --------------------------------------------------------------------------
# Cases: each probe at its own geometries, and their measurement
# --------------------------------------------------------------------------


@dataclass
class Case:
    """One geometry of one probe: ``kernel`` and ``plain`` take no
    arguments (the inputs are bound) and return the result."""

    probe: str  # the probe: its LAUNCHES key, or "P2" (no kernel)
    label: str  # the JAX probe's words
    kernel: Callable
    plain: Callable
    library: Optional[Callable]
    nbytes: int  # each input read once, each output written once
    ops: int = 0
    ops_rate: float = PEAK_OPS_PER_S
    rows: int = 0  # > 0: also print ns per row over this many rows
    cold: bool = False  # flush the L2 cache before each timed call
    with_host: bool = False  # time the host's issue of the calls too
    reference: Optional[Callable] = None  # P8: the f32 gather
    # may stand for the probe: chip_smoke's kernels line takes its last such
    headline: bool = True
    counter: str = ""  # the LAUNCHES key its kernel counts under, if not probe

    def __post_init__(self):
        self.counter = self.counter or self.probe

    def bound(self):
        """(seconds, "bytes" or "operations"): the larger of the bytes over
        the memory rate and the operations over their peak rate."""
        t_b, t_o = self.nbytes / PEAK_BYTES_PER_S, self.ops / self.ops_rate
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _rng(seed, key):
    return np.random.default_rng([seed, sum(map(ord, key))])


def _on(device, a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _gather(probe, label, fn, table, idx, elem=False, **kw):
    """The case of a gather probe: its plain version, the PyTorch call for
    the same function (``take`` of elements, ``index_select`` of rows) and
    the bytes (the index, the elements or rows read, the output)."""
    n = idx.numel()
    if elem:
        plain, i64 = elem_gather_plain, idx.long()
        library, nbytes = (lambda: torch.take(table, i64)), 12 * n
    else:
        plain = row_gather_plain
        library = lambda: torch.index_select(table, 0, idx)  # noqa: E731
        nbytes = 4 * n + 2 * 4 * n * table.shape[1]
    return Case(probe, label, lambda: fn(table, idx), lambda: plain(table, idx),
                library, nbytes, **kw)


def cases_p1(device, lanes=S, seed=0):
    out = []
    for rows, width in [(2048, 128), (8192, 128), (8192, 256), (65536, 8)]:
        rng = _rng(seed, f"p1{rows}x{width}")
        table = _on(device, np.arange(rows * width, dtype=np.int32).reshape(rows, width))
        idx = _on(device, rng.integers(0, rows, lanes, dtype=np.int32))
        for arm, words in (("flat", "a word a thread"), ("thread", "a thread a row")):
            out.append(_gather(
                "P1", f"P1 take[{rows}x{width}] -> [{lanes},{width}], {words}",
                functools.partial(probe_vmem_gather, arm=arm), table, idx,
                headline=arm == "flat", counter="P1" if arm == "flat" else "P1t"))
    return out


def cases_p1b(device, lanes=S, seed=0):
    out = []
    for bits in (16, 18, 20):
        rows = 1 << (bits - 7)
        table = _on(device, np.arange(rows * 128, dtype=np.int32).reshape(rows, 128))
        idx = _rng(seed, f"p1b{bits}").integers(0, rows * 128, lanes, dtype=np.int32)
        out.append(_gather("P1b", f"P1b o3-gather 2^{bits}", probe_vmem_gather_1d,
                           table, _on(device, idx), elem=True))
    return out


def cases_p2(device, lanes=S, seed=0):
    """P2 times ``torch.matmul`` for both precisions; the "kernel" is the
    f32 product, held against the gather, and the library call the bf16
    product (P8's yardstick)."""
    out = []
    for rows, width in [(2048, 128), (4096, 260), (8192, 260), (16384, 260)]:
        rng = _rng(seed, f"p2{rows}x{width}")
        table = _on(device, rng.integers(0, 24576, (rows, width)).astype(np.float32))
        idx = _on(device, rng.integers(0, rows, lanes, dtype=np.int32))
        out.append(Case(
            "P2", f"P2 onehot [{lanes},{rows}]@[{rows},{width}]: HIGHEST",
            lambda t=table, i=idx: probe_onehot_matmul(t, i),
            lambda t=table, i=idx: t[i.long()],
            lambda t=table, i=idx: probe_onehot_matmul(t, i, bf16=True),
            4 * lanes + 4 * rows * width + 4 * lanes * width,
            2 * lanes * rows * width))
    return out


def cases_p3(device, lanes=S, seed=0):
    """The bulk-copy arm (the headline) and one warp reading rows in order."""
    rows, width = 8192, 256
    table = _on(device, np.arange(rows * width, dtype=np.int32).reshape(rows, width))
    idx = _on(device, _rng(seed, "p3").integers(0, rows, lanes, dtype=np.int32))
    return [_gather("P3", f"P3 dynslice loop {lanes}x[{width}] ({words})",
                    functools.partial(probe_dynslice_loop, arm=arm), table, idx,
                    rows=lanes, headline=arm == "bulk", counter=counter)
            for arm, words, counter in (("bulk", "bulk copies", "P3"),
                                        ("warp", "one warp, rows in order", "P3w"))]


def cases_p4(device, lanes=S, seed=0, steps=STEPS):
    rows = 2048
    table = _on(device, _rng(seed, "p4").integers(0, 255, (rows, 128)).astype(np.float32))
    # bytes: the table entries this run's states visit, the states written;
    # operations: convert, mask and add a step
    st, seen = torch.zeros(lanes, dtype=_f32, device=table.device), []
    for _ in range(steps):
        seen.append((st.to(_i32) & (rows - 1)).long())
        st = st + table[seen[-1], 0]
    nbytes = 4 * int(torch.unique(torch.stack(seen)).numel()) + 4 * lanes
    graph = []

    def replay():  # captured at the first (warm-up) call
        if not graph:
            graph.append(_StepGraph(table, lanes, steps))
        return graph[0]()

    def plain():
        return steps_plain(table, lanes, steps)

    on_card = torch.device(device).type == "cuda"
    out = []
    for arm, words in (("persistent", f"persistent {steps} steps"),
                       ("launch", f"{steps} steps, one launch a step from the host"),
                       ("graph", f"{steps} steps, one launch a step, CUDA graph")):
        out.append(Case(
            "P4", f"P4 {words}",
            replay if arm == "graph" and on_card else
            (lambda a=arm: probe_persistent_steps(table, lanes, steps, a)),
            (lambda: plain().unsqueeze(1)) if arm == "persistent" else plain,
            None, nbytes, 3 * lanes * steps, rows=steps,
            with_host=arm == "launch", headline=arm == "persistent",
            counter="P4" if arm == "persistent" else "P4s"))
    return out


def _dma_table(device):
    rows, width = 1 << 16, 256  # 64 MiB: above the 50 MB L2
    return _on(device, np.repeat(np.arange(rows, dtype=np.int32)[:, None], width, 1))


def cases_p5(device, lanes=S, seed=0):
    """The ring at depth 16 and 32 (the headlines), and P1's flat gather
    on the same cold rows, counted under ``P5w``."""
    table = _dma_table(device)
    idx = _on(device, _rng(seed, "p5").integers(0, table.shape[0], lanes, dtype=np.int32))
    return [_gather("P5", f"P5 HBM row-DMA depth={depth}",
                    functools.partial(probe_dma_depth, depth=depth), table, idx,
                    rows=lanes, cold=True) for depth in (16, 32)] + [
        _gather("P5", "P5 HBM rows, P1's flat gather",
                functools.partial(_row_gather, "P5w"), table, idx, rows=lanes,
                cold=True, headline=False, counter="P5w")]


def cases_p6(device, lanes=S, seed=0):
    out = []
    for rows, width in [(2048, 128), (8192, 128), (8192, 256), (512, 260),
                        (65536, 128)]:
        rng = _rng(seed, f"p6{rows}x{width}")
        table = _on(device, rng.integers(0, 24576, (rows, width)).astype(np.int32))
        idx = _on(device, rng.integers(0, rows, lanes, dtype=np.int32))
        out.append(_gather("P6", f"P6 taa [{rows}x{width}]", probe_taa, table, idx))
    return out


def cases_p7(device, lanes=S, seed=0):
    out = []
    for bits in (16, 18, 20, 22):
        rows = 1 << (bits - 7)
        rng = _rng(seed, f"p7{bits}")
        table = _on(device, rng.integers(0, 1 << 12, (rows, 128)).astype(np.int32))
        idx = _on(device, rng.integers(0, rows * 128, lanes, dtype=np.int32))
        out.append(_gather("P7", f"P7 o3-elem 2^{bits}", probe_elem, table, idx,
                           elem=True))
    return out


def cases_p8(device, lanes=S, seed=0):
    out = []
    for rows in (4096, 8192):
        width = 384  # JAX's 260 padded to 3 x 128
        rng = _rng(seed, f"p8{rows}")
        table = _on(device, rng.integers(0, 24576, (rows, width)).astype(np.float32))
        idx = _on(device, rng.integers(0, rows, lanes, dtype=np.int32))
        oh = (idx.long()[:, None] == torch.arange(rows, device=idx.device)).bfloat16()
        tb = table.bfloat16()
        out.append(Case(
            "P8", f"P8 kernel onehot [{rows}x{width}]",
            lambda t=table, i=idx: probe_kernel_onehot(t, i),
            lambda t=table, i=idx: onehot_bf16_plain(t, i),
            lambda a=oh, b=tb: torch.matmul(a, b),
            4 * lanes + 2 * 4 * lanes * width,  # bf16(table)[idx]: the rows it needs
            2 * lanes * rows * width, PEAK_BF16_PER_S,
            reference=lambda t=table, i=idx: t[i.long()]))
    return out


def cases_p9(device, lanes=S, seed=0):
    table = _dma_table(device)
    idx = _on(device, _rng(seed, "p9").integers(0, table.shape[0], lanes, dtype=np.int32))
    return [_gather("P9", "P9 HBM DMA depth=16", probe_dma, table, idx, rows=lanes,
                    cold=True)]


PROBES = {"p1": cases_p1, "p1b": cases_p1b, "p2": cases_p2, "p3": cases_p3,
          "p4": cases_p4, "p5": cases_p5, "p6": cases_p6, "p7": cases_p7,
          "p8": cases_p8, "p9": cases_p9}


def max_abs_err(a, b) -> float:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


_CARD: dict = {}  # the L2 flush buffer, the sleep kernel's cycles a second


def _sleep_hz() -> float:
    """Cycles a second of ``torch.cuda._sleep`` on this card."""
    if "hz" not in _CARD:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(1000)
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        torch.cuda.synchronize()
        _CARD["hz"] = 10 ** 7 / (a.elapsed_time(b) / 1e3)
    return _CARD["hz"]


def _hold(seconds: float) -> None:
    """Keep the card busy for ``seconds``, so that what the host enqueues
    meanwhile runs back to back after it."""
    torch.cuda._sleep(int(seconds * _sleep_hz()) + 1)


def timeit(fn, n=20, warmup=3, cold=False, with_host=False) -> float:
    """Seconds per call on the card: CUDA events around ``n`` calls after
    ``warmup`` calls, queued behind a sleep kernel so that the events time
    the card's work and not the host's enqueue (``with_host``: the calls as
    the host issues them).  With ``cold``, events around each call, after
    writing ``L2_FLUSH_BYTES`` so that the call finds nothing of its inputs
    in L2."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes are timed on a CUDA card; none found")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0 + 50e-6  # one call's enqueue, and slack
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * n)]
    if cold:
        buf = _CARD.get("flush")
        if buf is None:
            buf = _CARD["flush"] = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                               device="cuda")
        for k in range(n):
            _hold(2 * host)
            buf.fill_(k & 0xFF)
            ev[2 * k].record()
            fn()
            ev[2 * k + 1].record()
        torch.cuda.synchronize()
        return sum(ev[2 * k].elapsed_time(ev[2 * k + 1]) for k in range(n)) / n / 1e3
    if not with_host:
        _hold(2 * n * host)
    ev[0].record()
    for _ in range(n):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / n / 1e3


def measure(case: Case) -> dict:
    """Run ``case`` on the card: kernel against plain (max abs err), the
    times of kernel, plain version and library call, the bound.  Returns
    the record and prints its line.  The comparison's launches are counted
    too: the caller reads ``LAUNCHES`` around the whole run."""
    got = case.kernel()
    err = max_abs_err(got, case.plain())
    kw = dict(cold=case.cold, with_host=case.with_host)
    t = timeit(case.kernel, **kw)
    t_plain = timeit(case.plain, **kw)
    t_lib = timeit(case.library, **kw) if case.library else None
    bound, by = case.bound()
    line = f"{case.label}: {t * 1e6:.3f} us"
    if case.rows:
        line += f" ({t / case.rows * 1e9:.0f} ns/{'step' if case.probe == 'P4' else 'row'})"
    line += f" exact={err == 0}"
    if case.reference is not None:
        line += f" (f32 gather: max abs err {max_abs_err(got, case.reference()):g})"
    line += f" plain={t_plain * 1e6:.3f}"
    if t_lib is not None:
        line += f" library={t_lib * 1e6:.3f}"
    print(line + f" bound={bound * 1e6:.3f} ({by})", flush=True)
    return dict(probe=case.probe, label=case.label, us=t * 1e6,
                plain_us=t_plain * 1e6,
                library_us=None if t_lib is None else t_lib * 1e6,
                bound_us=bound * 1e6, bound_by=by, max_abs_err=err,
                headline=case.headline)


def launch_floor() -> float:
    """Seconds a call of an empty kernel (one CTA of 32 threads) by
    :func:`timeit`: the floor every probe's time stands on.  A yardstick,
    not a probe: no ``LAUNCHES`` key counts it."""
    lib = build.lib()
    return timeit(lambda: build.check(lib.cpx_pr_empty_launch(_stream_ptr()),
                                      "cpx_pr_empty_launch"))


def run(names=None) -> list:
    """Measure the named probes (all by default) on the card: their records.
    The launch floor's line comes first."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA card; none found")
    print(f"launch floor (an empty kernel): {launch_floor() * 1e6:.3f} us", flush=True)
    return [measure(case) for name in names or PROBES for case in PROBES[name]("cuda")]


def trace(names, reps: int = 20) -> dict:
    """{label: {kernel name: device us a call}} of the named probes'
    headline cases, from the kernels' names in a ``torch.profiler`` trace
    of ``reps`` calls after 3 warm-ups.  The cases come from the probes
    module of the tree on ``sys.path``, so this file traces another tree's
    wrappers too: ``cd TREE && PYTHONPATH=$PWD python
    REPO/comprox_tpu_torch/benchmarks/probes.py --trace p4``."""
    from comprox_tpu_torch.benchmarks import probes as tree

    out = {}
    for name in names:
        for case in tree.PROBES[name]("cuda"):
            if not case.headline:
                continue
            for _ in range(3):
                case.kernel()
            torch.cuda.synchronize()
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            with prof:
                for _ in range(reps):
                    case.kernel()
                torch.cuda.synchronize()
            us: dict = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us() / reps
            out[case.label] = us
            kernels = "; ".join(f"{k} {v:.3f} us" for k, v in us.items())
            print(f"{case.label} (trace): {kernels or 'no device time'}", flush=True)
    return out


def main(argv) -> int:
    tracing = argv[:1] == ["--trace"]
    names = argv[tracing:] or list(PROBES)
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        raise SystemExit(f"unknown probe(s) {unknown}: {' '.join(PROBES)}")
    if torch.cuda.is_available():
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    if tracing:
        trace(names)
    else:
        run(names)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
