"""The order of P1's and P6's row gather and of P4's dependent steps
(``comprox_tpu_torch/csrc/probes.cu``: ``pr_row_gather``, ``pr_steps``)
mirrored in torch on the CPU, and held to the probes' plain versions
exactly (tolerance 0).

P1, P6: the kernel maps the output flat, as n = S * words words of 16
bytes (a width that is a multiple of 4 and 16-byte aligned pointers) or
of 4 bytes.  CTA b's thread t owns the words g = b * THREADS * WPT + i *
THREADS + t (i < WPT), each word j = g % words of row k = g / words, read
from word j of row idx[k].  The mirror runs that grid and checks that it
covers every output word exactly once and rebuilds ``table[idx]``.

P4: each CTA of LANES lanes first stages column 0 of the table in its
shared memory, a thread a row (rows t, t + LANES, ...), then each lane
runs its steps from the staged column, ``s += col[int(s) & (rows - 1)]``
in f32, ``int()`` truncating toward zero.  The mirror stages, checks that
every row is staged exactly once, runs the chains and must equal
``steps_plain``.

Five faults seeded in the mirrors must each fail a check: a word off by
one at a row's end, the last CTA's tail dropped, column 1 staged in place
of column 0, a mask of ``rows`` in place of ``rows - 1``, floor in place
of truncation.  No JAX here: the plain versions are the JAX probes'
results (``tests/test_torch_probes.py`` holds them to JAX).
"""

import re

import numpy as np
import pytest
import torch

from comprox_tpu_torch.benchmarks import probes
from comprox_tpu_torch.utils import build

torch.set_num_threads(1)

SRC = (build.CSRC / "probes.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


GATHER_THREADS = _constant("GATHER_THREADS")
GATHER_WPT = _constant("GATHER_WPT")
STEPS_LANES = _constant("STEPS_LANES")
STEPS_SMEM_MAX = _constant("STEPS_SMEM_MAX")


# ------------------------------------------------------------------ P1, P6


def gather_grid(S, width, vec, threads=GATHER_THREADS, wpt=GATHER_WPT, fault=""):
    """(words a row, n, and g, k, j of every word a thread of the grid
    stores).  ``fault``: "row_end" leaves each row's last word unstored,
    "tail" launches floor(n / (threads * wpt)) CTAs in place of the
    ceiling."""
    words = width // 4 if vec else width
    n = S * words
    per = threads * wpt
    blocks = n // per if fault == "tail" else -(-n // per)
    b = torch.arange(blocks)[:, None, None]
    i = torch.arange(wpt)[None, :, None]
    t = torch.arange(threads)[None, None, :]
    g = (b * per + i * threads + t).reshape(-1)
    g = g[g < n]
    k = g // words
    j = g - k * words
    if fault == "row_end":
        keep = j < words - 1
        g, k, j = g[keep], k[keep], j[keep]
    return words, n, g, k, j


def gather_mirror(table, idx, vec, **kw):
    """(the output the grid stores, -1 where it stores nothing; the
    stores of each output word)."""
    rows, width = table.shape
    S = idx.shape[0]
    words, n, g, k, j = gather_grid(S, width, vec, **kw)
    w = 4 if vec else 1  # int32 a word
    src = table.reshape(rows * words, w)
    out = torch.full((n, w), -1, dtype=table.dtype)
    out[g] = src[idx.long()[k] * words + j]
    return out.reshape(S, width), torch.bincount(g, minlength=n)


def gather_ok(table, idx, vec, **kw) -> bool:
    out, stores = gather_mirror(table, idx, vec, **kw)
    return bool((stores == 1).all()) and torch.equal(
        out, probes.row_gather_plain(table, idx))


def gather_inputs(S, rows, width, seed=0):
    rng = np.random.default_rng([S, rows, width, seed])
    table = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (rows, width),
                                          dtype=np.int32))
    idx = rng.integers(0, rows, S)
    idx[0], idx[-1] = rows - 1, 0
    if S > 9:
        idx[3:9] = idx[2]  # repeated rows
    return table, torch.from_numpy(idx.astype(np.int32))


# the JAX geometries of P1 and P6 (S = 512), then ragged ones: S = 104,
# widths 1, 3, 8, 260
P1 = [(512, 2048, 128), (512, 8192, 128), (512, 8192, 256), (512, 65536, 8)]
P6 = [(512, 2048, 128), (512, 8192, 128), (512, 8192, 256), (512, 512, 260),
      (512, 65536, 128)]
RAGGED = [(104, 300, 1), (104, 300, 3), (104, 300, 8), (104, 300, 260)]
GATHER_CASES = sorted(set(P1 + P6)) + RAGGED


def vec_arm(width: int, aligned: bool) -> bool:
    """The launcher's choice: 16-byte words where the width is a multiple
    of 4 and table and out are 16-byte aligned."""
    return width % 4 == 0 and aligned


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned table"])
@pytest.mark.parametrize("S,rows,width", GATHER_CASES)
def test_gather_grid_rebuilds_the_rows(S, rows, width, aligned):
    """Every output word stored exactly once, ``table[idx]`` rebuilt, in
    the 16-byte word arm and (a table off 16 bytes, or a width not a
    multiple of 4) the 4-byte word arm."""
    table, idx = gather_inputs(S, rows, width)
    vec = vec_arm(width, aligned)
    out, stores = gather_mirror(table, idx, vec)
    assert bool((stores == 1).all())
    assert torch.equal(out, probes.row_gather_plain(table, idx))
    assert torch.equal(out, table[idx.long()])


def test_gather_grid_at_the_probe_shapes():
    """One word a thread at the 16-byte arm: [512x260] is 33,280 words,
    [8192x256] 32,768, width 128 16,384, width 8 1,024; the CTAs."""
    per = GATHER_THREADS * GATHER_WPT
    for (S, rows, width), words in zip(
            [(512, 512, 260), (512, 8192, 256), (512, 2048, 128), (512, 65536, 8)],
            [33280, 32768, 16384, 1024]):
        w, n, g, _, _ = gather_grid(S, width, True)
        assert n == words == g.numel() and w == width // 4
        assert torch.equal(g.sort().values, torch.arange(n))
    assert -(-33280 // per) * per >= 33280


def test_gather_seeded_faults_fail_the_checks():
    """A word off by one at a row's end fails every case; the last CTA's
    tail dropped fails every case whose words are not a multiple of a
    CTA's (every ragged case; at the probe shapes none)."""
    per = GATHER_THREADS * GATHER_WPT
    ragged = [c for c in GATHER_CASES
              if gather_grid(c[0], c[2], vec_arm(c[2], True))[1] % per]
    assert ragged == RAGGED
    for fault, should in (("row_end", GATHER_CASES), ("tail", ragged)):
        failed = []
        for S, rows, width in GATHER_CASES:
            table, idx = gather_inputs(S, rows, width)
            if not gather_ok(table, idx, vec_arm(width, True), fault=fault):
                failed.append((S, rows, width))
        assert failed == should, fault


def test_gather_kernel_loads_before_it_stores():
    """The mirror's arithmetic is the kernel's: the flat map, the index
    and word address, the guard, the grid; and in the body every load
    comes before the first store."""
    body = SRC[SRC.index("pr_row_gather(const int* __restrict__ table"):]
    body = body[:body.index("\n}\n")]
    for text in ("const int g0 = blockIdx.x * (GATHER_THREADS * GATHER_WPT) + threadIdx.x;",
                 "const int g = g0 + i * GATHER_THREADS, k = g / words;",
                 "at[i] = g < n ? (size_t)idx[k] * words + (g - k * words) : 0;",
                 "if (g0 + i * GATHER_THREADS < n) v[i] = src[at[i]];",
                 "if (g0 + i * GATHER_THREADS < n) dst[g0 + i * GATHER_THREADS] = v[i];"):
        assert text in body, text
    assert body.index("idx[k]") < body.index("src[at[i]]") < body.index("dst[")
    assert body.count("dst[") == 1 and "for (int j" not in body
    launch = SRC[SRC.index('extern "C" int cpx_pr_row_gather_launch'):]
    launch = launch[:launch.index("\n}\n")]
    for text in ("const bool vec = width % 4 == 0 && aligned16(table) && aligned16(out);",
                 "const int words = vec ? width / 4 : width;",
                 "per = GATHER_THREADS * GATHER_WPT;",
                 "kernel<<<(int)((n + per - 1) / per), GATHER_THREADS, 0,"):
        assert text in launch, text


# ------------------------------------------------------------------ P4


def _trunc(s):
    return s.to(torch.int32)


def _floor(s):
    return torch.floor(s).to(torch.int32)


def steps_mirror(table, lanes, steps, lanes_cta=STEPS_LANES, fault=""):
    """The lanes' final states by the kernel's order: each CTA stages
    column 0 (``fault`` "column": column 1) a thread a row, then runs its
    lanes' chains from the staged column with the mask rows - 1 ("mask":
    rows) and truncation ("floor": floor).  Raises IndexError where a
    chain reads past the staged column."""
    rows, width = table.shape
    c = 1 if fault == "column" else 0
    mask = rows if fault == "mask" else rows - 1
    to_int = _floor if fault == "floor" else _trunc
    flat = table.reshape(-1)
    out = torch.full((lanes,), float("nan"), dtype=torch.float32)
    for b in range(-(-lanes // lanes_cta)):
        col = torch.full((rows,), float("nan"), dtype=torch.float32)
        # thread t stages rows t, t + lanes_cta, ...
        staged = torch.cat([torch.arange(t, rows, lanes_cta) for t in range(lanes_cta)])
        assert bool((torch.bincount(staged, minlength=rows) == 1).all())
        col[staged] = flat[staged * width + c]
        k = torch.arange(b * lanes_cta, min((b + 1) * lanes_cta, lanes))
        s = torch.zeros(k.numel(), dtype=torch.float32)
        for _ in range(steps):
            at = (to_int(s) & mask).long()
            if bool((at >= rows).any()):
                raise IndexError(f"a read at row {int(at.max())} of {rows}")
            s = s + col[at]
        out[k] = s
    return out


def steps_ok(table, lanes, steps, **kw) -> bool:
    try:
        got = steps_mirror(table, lanes, steps, **kw)
    except IndexError:
        return False
    return torch.equal(got, probes.steps_plain(table, lanes, steps))


def p4_table(seed=0):
    """P4's table, as ``cases_p4`` makes it: [2048x128] integers in [0, 255)."""
    return torch.from_numpy(probes._rng(seed, "p4").integers(0, 255, (2048, 128))
                            .astype(np.float32))


def signed_table(rows=2048, width=128, seed=1):
    """Negative and fractional values (quarters, exact in f32), so that
    the states go below zero, where truncation and floor differ."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.integers(-600, 600, (rows, width)) / 4)
                            .astype(np.float32))


# (name, table, lanes, steps): the probe's, the signed table at the
# probe's shape, a ragged last CTA and rows not a power of two
STEPS_CASES = [("probe", p4_table, 512, 512), ("signed", signed_table, 512, 512),
               ("ragged", lambda: signed_table(1000, 3, 2), 104, 64)]


@pytest.mark.parametrize("name,make,lanes,steps", STEPS_CASES,
                         ids=[c[0] for c in STEPS_CASES])
def test_steps_from_the_staged_column_equal_the_plain_version(name, make, lanes, steps):
    table = make()
    assert torch.equal(steps_mirror(table, lanes, steps),
                       probes.steps_plain(table, lanes, steps))


def test_signed_states_go_below_zero():
    """The signed table takes states below zero, where the floor fault
    reads other rows."""
    table = signed_table()
    s, low = torch.zeros(512), torch.zeros(512)
    for _ in range(512):
        s = s + table[(_trunc(s) & 2047).long(), 0]
        low = torch.minimum(low, s)
    assert bool((low < -1).any()) and bool((s != s.round()).any())


def test_steps_seeded_faults_fail_the_checks():
    """Column 1 staged, a mask of rows and floor for truncation each fail;
    floor fails the signed cases and not the probe's (its states never go
    below zero, where the two differ)."""
    for fault, should in (("column", ["probe", "signed", "ragged"]),
                          ("mask", ["probe", "signed", "ragged"]),
                          ("floor", ["signed", "ragged"])):
        failed = [name for name, make, lanes, steps in STEPS_CASES
                  if not steps_ok(make(), lanes, steps, fault=fault)]
        assert failed == should, fault


@pytest.mark.parametrize("lanes_cta", [32, 512])
def test_steps_take_any_lanes_a_cta(lanes_cta):
    """The result does not depend on how many lanes a CTA holds."""
    table = signed_table()
    assert torch.equal(steps_mirror(table, 512, 128, lanes_cta),
                       probes.steps_plain(table, 512, 128))


def test_steps_kernel_matches_the_mirror():
    """The mirror's arithmetic is the kernel's: the staging loop (a thread
    a row, 4-byte copies, one wait and one barrier), the lane, the step,
    the grid, and the rows the wrapper takes (column 0 within a CTA's
    shared memory)."""
    body = SRC[SRC.index("pr_steps(const float* __restrict__ table"):]
    body = body[:body.index("\n}\n")]
    for text in ("for (int r = threadIdx.x; r < rows; r += STEPS_LANES)",
                 "cp.async.ca.shared.global [%0], [%1], 4;",
                 '"l"(table + (size_t)r * width)',
                 "cp.async.wait_all;",
                 "__syncthreads();",
                 "const int k = blockIdx.x * STEPS_LANES + threadIdx.x;",
                 "const int mask = rows - 1;",
                 "for (int t = 0; t < T; ++t) s += col[(int)s & mask];",
                 "out[k] = s;"):
        assert text in body, text
    assert body.index("cp.async.wait_all") < body.index("__syncthreads") < body.index("s += col")
    assert "table[" not in body[body.index("__syncthreads"):]
    assert "pr_steps<<<(S + STEPS_LANES - 1) / STEPS_LANES, STEPS_LANES, smem," in SRC
    assert "rows > STEPS_SMEM_MAX / 4" in SRC and "const int smem = rows * 4;" in SRC
    assert probes.STEPS_MAX_ROWS == STEPS_SMEM_MAX // 4 == 58112
    assert STEPS_SMEM_MAX == 227 * 1024


def test_mirror_constants_match_the_kernel_source():
    """Lanes a CTA, threads a CTA and words a thread are the source's
    constants (no build define), within a CTA's limits."""
    assert 1 <= GATHER_WPT <= 8 and GATHER_THREADS % 32 == 0
    assert 32 <= GATHER_THREADS <= 1024 and 32 <= STEPS_LANES <= 1024
    assert STEPS_LANES % 32 == 0
    assert "__launch_bounds__(GATHER_THREADS)" in SRC
    assert "__launch_bounds__(STEPS_LANES)" in SRC
    assert "#define PR_" not in SRC and "#ifndef PR_" not in SRC


def test_p4_wrapper_on_the_cpu():
    """On the CPU the wrapper is the plain version, whatever the rows;
    the persistent arm's output is [lanes, 1]."""
    table = signed_table(rows=probes.STEPS_MAX_ROWS + 1, width=1)
    got = probes.probe_persistent_steps(table, 8, 16)
    assert tuple(got.shape) == (8, 1)
    assert torch.equal(got[:, 0], probes.steps_plain(table, 8, 16))
