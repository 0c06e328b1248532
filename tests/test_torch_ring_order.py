"""The order of P5's and P9's ring kernel (``comprox_tpu_torch/csrc/probes.cu``:
``pr_row_ring``) mirrored in torch on the CPU, and held to the probes'
plain version exactly (tolerance 0).

The mirror writes down, by the kernel's own arithmetic, what thread 0 of
each CTA does: CTA b takes the output rows [b R, b R + n), n = min(R, S -
b R); row k goes to slot k % DEPTH by a copy, waits on the slot's barrier
at parity (k / DEPTH) & 1, leaves by a store (one bulk group), and the
slot of row j = k - LAG takes row j + DEPTH after ``wait_group.read LAG``.
A replay then runs that program against a model of the CTA's shared
memory: each slot's contents, each barrier's completed phases (a wait at
parity p returns once the phase of parity p has completed, as
``mbarrier.try_wait.parity``), and the bulk groups, each of which reads its
slot only when a ``wait_group.read`` makes it.  Two timings bracket the
card's: copies that land at once, and copies that land only when a wait
needs them.  The checks:

- every output row is copied and stored exactly once, and the stores
  rebuild ``table[idx]``;
- no slot is refilled before the store of its last row has read it;
- each wait uses the parity of the phase its row's copy completes, and
  returns with that row in the slot.

The source's R (``RING_R``) never reuses a slot at depth 16 or 32, so the
schedule is also replayed at rows a CTA above the depth, where the ring
wraps.  Two faults seeded in the mirror, a refill one row early and a
parity off by one, must fail the checks.  No JAX here: the plain version
is the JAX probes' result (``tests/test_torch_probes.py`` holds it to JAX).
"""

import re
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch

from comprox_tpu_torch.benchmarks import probes
from comprox_tpu_torch.utils import build

torch.set_num_threads(1)

SRC = (build.CSRC / "probes.cu").read_text()
RING_R = int(re.search(r"constexpr int RING_R = (\d+);", SRC).group(1))
RING_LAG = int(re.search(r"constexpr int RING_LAG = (\d+);", SRC).group(1))
DEPTHS = (16, 32)
WRAP_R = (48, 128)  # rows a CTA at which the ring wraps at both depths


def ring_slots(depth: int, S: int, R: int) -> int:
    """probes.cu's ``ring_slots``: the slots a CTA's shared memory holds."""
    return min(depth, min(R, S))


def ctas(S: int, R: int):
    """The grid: (first row, rows) of each CTA."""
    return [(b * R, min(R, S - b * R)) for b in range((S + R - 1) // R)]


def program(n: int, depth: int, lag: int, fault: str = ""):
    """Thread 0's operations for a CTA of n rows, in the kernel's order:
    ("copy", k, slot), ("wait", k, slot, parity), ("store", k, slot),
    ("read", pending) for ``cp.async.bulk.wait_group.read pending``.
    ``fault``: "early" refills the slot of the row one after the one the
    wait has freed; "parity" waits at the other parity."""
    ops = []

    def issue(k):
        ops.append(("copy", k, k % depth))

    for k in range(min(depth, n)):
        issue(k)
    for k in range(n):
        parity = (k // depth) & 1
        if fault == "parity":
            parity ^= 1
        ops.append(("wait", k, k % depth, parity))
        ops.append(("store", k, k % depth))
        j = k - lag + (1 if fault == "early" else 0)
        if j >= 0 and j + depth < n:
            ops.append(("read", lag))
            issue(j + depth)
    ops.append(("read", 0))
    return ops


@dataclass
class Replay:
    out: torch.Tensor
    copies: torch.Tensor  # of each output row
    stores: torch.Tensor
    faults: list = field(default_factory=list)  # hazards and bad waits seen

    def ok(self, table, idx) -> bool:
        return (not self.faults and bool((self.copies == 1).all())
                and bool((self.stores == 1).all())
                and torch.equal(self.out, probes.row_gather_plain(table, idx)))


def replay(table, idx, depth, R, lag=RING_LAG, fault="", eager=True) -> Replay:
    """Run every CTA's program against the model of its shared memory.
    ``eager``: a copy lands when issued; else only when a wait needs it."""
    S, width = idx.shape[0], table.shape[1]
    res = Replay(torch.full((S, width), -1, dtype=table.dtype),
                 torch.zeros(S, dtype=torch.int64), torch.zeros(S, dtype=torch.int64))
    for k0, n in ctas(S, R):
        slots = ring_slots(depth, S, R)
        data = [None] * slots  # the row index a slot holds, once landed
        pending = [None] * slots  # the row whose copy is in flight
        phases = [0] * slots  # completed phases of each barrier
        uses = [0] * slots  # copies issued into each slot
        use_of = {}  # row -> its copy's use of its slot
        groups = []  # bulk stores: [row, slot, read yet, the row it read]
        last_store = {}  # slot -> its last store's group

        def land(s):
            data[s], pending[s] = pending[s], None
            phases[s] += 1

        def read_groups(keep):
            for g in groups[:max(len(groups) - keep, 0)]:
                if not g[2]:
                    g[2], g[3] = True, data[g[1]]

        for op in program(n, depth, lag, fault):
            if op[0] == "copy":
                _, k, s = op
                if s >= slots:
                    res.faults.append(f"row {k0 + k}: slot {s} beyond the {slots} held")
                    continue
                g = last_store.get(s)
                if g is not None and not g[2]:
                    res.faults.append(f"row {k0 + k}: slot {s} refilled before the "
                                      f"store of row {k0 + g[0]} read it")
                if pending[s] is not None:
                    res.faults.append(f"row {k0 + k}: slot {s} still in flight")
                pending[s], use_of[k] = k, uses[s]
                uses[s] += 1
                res.copies[k0 + k] += 1
                if eager:
                    land(s)
            elif op[0] == "wait":
                _, k, s, parity = op
                if parity != use_of.get(k, -1) & 1:
                    res.faults.append(f"row {k0 + k}: wait at parity {parity}, its "
                                      f"copy completes phase {use_of.get(k)}")
                # try_wait.parity p returns once the phase of parity p is done
                while (phases[s] & 1) == parity:
                    if pending[s] is None:
                        res.faults.append(f"row {k0 + k}: the wait never returns")
                        break
                    land(s)
                if data[s] != k:
                    res.faults.append(f"row {k0 + k}: the wait returned with row "
                                      f"{data[s]} in slot {s}")
            elif op[0] == "store":
                _, k, s = op
                groups.append([k, s, False, None])
                last_store[s] = groups[-1]
                res.stores[k0 + k] += 1
            else:
                read_groups(op[1])
        if any(p is not None for p in pending):
            res.faults.append(f"CTA at row {k0}: a copy never stored")
        for k, _, _, got in groups:
            if got is not None:
                res.out[k0 + k] = table[int(idx[k0 + got])]
    return res


def inputs(S, rows=1000, width=8, seed=0):
    rng = np.random.default_rng([S, rows, width, seed])
    table = torch.from_numpy(rng.integers(0, 1 << 30, (rows, width), dtype=np.int32))
    idx = rng.integers(0, rows, S)
    idx[0], idx[-1] = rows - 1, 0
    if S > 9:
        idx[3:9] = idx[2]  # repeated rows
    return table, torch.from_numpy(idx.astype(np.int32))


# S: the probe's 512, ragged last CTAs, fewer rows than the depth, one row
SIZES = (512, 509, 13, 1)
CASES = [(S, depth, R) for R in (RING_R,) + WRAP_R for depth in DEPTHS for S in SIZES]


@pytest.mark.parametrize("eager", [True, False], ids=["copies land at once", "copies land late"])
@pytest.mark.parametrize("S,depth,R", CASES)
def test_ring_schedule_rebuilds_the_rows(S, depth, R, eager):
    table, idx = inputs(S)
    res = replay(table, idx, depth, R, eager=eager)
    assert not res.faults, res.faults[:3]
    assert bool((res.copies == 1).all()) and bool((res.stores == 1).all())
    assert torch.equal(res.out, probes.row_gather_plain(table, idx))
    assert torch.equal(res.out, table[idx.long()])


def wraps(S, depth, R) -> bool:
    """A CTA of this grid reuses a slot."""
    return max(n for _, n in ctas(S, R)) > depth


def test_seeded_faults_fail_the_checks():
    """A refill one row early fails every case whose ring wraps (at the
    source's R none does); a parity off by one fails every case; both
    under either timing.  The counts stand in PERF.md."""
    wrapping = [c for c in CASES if wraps(*c)]
    assert not any(wraps(S, depth, RING_R) for S in SIZES for depth in DEPTHS)
    assert len(CASES) == 24 and len(wrapping) == 8
    for eager in (True, False):
        for fault, should in (("early", wrapping), ("parity", CASES)):
            failed = []
            for S, depth, R in CASES:
                table, idx = inputs(S)
                res = replay(table, idx, depth, R, fault=fault, eager=eager)
                if not res.ok(table, idx):
                    failed.append((S, depth, R))
                    assert res.faults, (fault, S, depth, R)
            assert failed == should, (fault, eager)


def test_early_refill_overwrites_a_row_before_its_store_reads_it():
    """With copies that land at once, the early refill's data check fails
    too: a store reads the slot after the next row has landed in it."""
    table, idx = inputs(512)
    res = replay(table, idx, 16, 128, fault="early", eager=True)
    assert not torch.equal(res.out, table[idx.long()])
    assert any("refilled before the store" in f for f in res.faults)


def test_late_copies_expose_a_wrong_parity():
    """With copies that land late, a wait at the wrong parity returns
    before its row has landed (and at once, the first use of a slot)."""
    table, idx = inputs(5)
    res = replay(table, idx, 16, RING_R, fault="parity", eager=False)
    assert any("returned with row None" in f for f in res.faults)
    assert not torch.equal(res.out, table[idx.long()])


def test_the_lag_keeps_rows_in_flight():
    """The refill lags the store by LAG rows, so at row k the ring holds
    DEPTH - LAG - 1 copies issued ahead of the one waited on (in steady
    state), and a lag of DEPTH or more would wait on a row never issued."""
    for depth in DEPTHS:
        ops = program(128, depth, RING_LAG)
        ahead, issued = [], set()
        for op in ops:
            if op[0] == "copy":
                issued.add(op[1])
            elif op[0] == "wait":
                assert op[1] in issued
                ahead.append(sum(1 for j in issued if j > op[1]))
        assert max(ahead[RING_LAG:128 - depth]) == depth - RING_LAG - 1
        assert min(ahead[RING_LAG:128 - depth]) == depth - RING_LAG - 1
        table, idx = inputs(256)
        res = replay(table, idx, depth, 128, lag=depth)
        assert any("never returns" in f for f in res.faults)


def test_mirror_matches_the_kernel_source():
    """The mirror's arithmetic is the kernel's: the slot, the parity, the
    refilled row, the read wait, the slots and the shared memory a CTA."""
    body = SRC[SRC.index("__global__ void __launch_bounds__(32) pr_row_ring"):]
    body = body[:body.index("\n}\n")]
    for text in ("const int k0 = blockIdx.x * RING_R, n = min(RING_R, S - k0);",
                 "const unsigned slot = k % DEPTH",
                 "mbar_wait(bars + 8 * slot, (k / DEPTH) & 1);",
                 "const int j = k - RING_LAG;",
                 "if (j >= 0 && j + DEPTH < n) {",
                 '"cp.async.bulk.wait_group.read %0;\\n" ::"n"(RING_LAG)',
                 "issue(j + DEPTH);",
                 "for (int k = 0; k < min(DEPTH, n); ++k) issue(k);",
                 '"cp.async.bulk.wait_group.read 0;\\n"',
                 "mbarrier.arrive.expect_tx"):
        assert text in body, text
    assert "const int n = RING_R < S ? RING_R : S;\n  return depth < n ? depth : n;" in SRC
    assert ("(long long)slots * ((long long)width * 4 + 8) + 4LL * n" in SRC)
    assert 1 <= RING_R and RING_LAG < min(DEPTHS)


def test_ring_launch_grid_and_slots():
    """ceil(S / R) CTAs, the last ragged; a CTA's slots fit its rows."""
    for S in SIZES:
        grid = ctas(S, RING_R)
        assert len(grid) == -(-S // RING_R)
        assert sum(n for _, n in grid) == S and grid[-1][0] + grid[-1][1] == S
        for depth in DEPTHS:
            assert ring_slots(depth, S, RING_R) == min(depth, RING_R, S)
    assert ctas(509, 2)[-1] == (508, 1)
