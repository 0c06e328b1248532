"""The order of P3's and P8's kernels (``comprox_tpu_torch/csrc/probes.cu``:
``pr_row_bulk``, ``pr_onehot_wgmma``) mirrored in torch on the CPU, and
held to the probes' plain versions exactly (tolerance 0).

P3, the row loop as bulk copies: CTA b takes the output rows [b R, b R +
n), n = min(R, S - b R), copies each of them (row idx[k] of the table) and
stores the n rows with one copy.  The mirror checks that the copies and
the stores cover [0, S) exactly once and rebuild ``table[idx]``.

P8, the one-hot product on ``wgmma``: the mirror builds what the kernel
builds, by the kernel's arithmetic, and reads it back by the PTX ISA's
layouts, which are written here on their own:
- the A registers of each thread (its eight rows' indices against each
  64-row chunk), unpacked by the ISA's m64nNk16 A fragment map;
- B's shared-memory tile as the conversion writes it (``oh_b_off``), read
  by the ISA's no-swizzle K-major layout that the descriptor names (core
  matrices of 8 x 16 bytes, LBO to the next 8 k, SBO to the next 8 n);
- the K ranges of the grid (``per`` chunks a range, the last shorter)
  and, in each, the f32 products of its chunks;
- the accumulators by the ISA's D fragment map, stored by the owner rule:
  a row goes out from the one range that holds its index.

Cases: rows 4096 and 8192 at width 384 (the probe's), all indices in one
range, indices on every range's first and last row with 0 and rows - 1,
repeated indices, a ragged last range, another width, S below 512.
No JAX here: the plain versions are the JAX probes' results
(``tests/test_torch_probes.py`` holds them to JAX).
"""

import re

import numpy as np
import pytest
import torch

from comprox_tpu_torch.benchmarks import probes
from comprox_tpu_torch.utils import build

torch.set_num_threads(1)

SRC = (build.CSRC / "probes.cu").read_text()


def const(name: str) -> int:
    m = re.search(rf"\b{name} = (\d+)", SRC)
    assert m, name
    return int(m.group(1))


BULK_R = int(re.search(r"constexpr int BULK_R = (\d+);", SRC).group(1))
OH_N, OH_KC, OH_WG, OH_MT = (const(k) for k in ("OH_N", "OH_KC", "OH_WG", "OH_MT"))
OH_LBO, OH_SBO = const("OH_LBO"), const("OH_SBO")
OH_S = 64 * OH_MT * OH_WG
OH_KSTEP = 16 * OH_N * 2
THREADS = 128 * OH_WG
SMS = 132  # the H100's SMs, which the launcher reads from the card
ONE = 0x3F80  # bf16 1.0


# --------------------------------------------------------------------------
# P3
# --------------------------------------------------------------------------


def bulk_ctas(S: int, R: int):
    """pr_row_bulk's grid: (first row, rows) of each CTA."""
    return [(b * R, min(R, S - b * R)) for b in range((S + R - 1) // R)]


def bulk_mirror(table, idx, R):
    """The rows each CTA copies and its one store; returns (out, copies of
    each output row, stores covering it)."""
    S = idx.shape[0]
    out = torch.full((S, table.shape[1]), -1, dtype=table.dtype)
    copied = torch.zeros(S, dtype=torch.int64)
    stored = torch.zeros(S, dtype=torch.int64)
    for k0, n in bulk_ctas(S, R):
        assert 1 <= n <= min(R, S)  # fits the CTA's shared rows
        rows_s = torch.stack([table[int(idx[k0 + j])] for j in range(n)])
        copied[k0:k0 + n] += 1
        out[k0:k0 + n] = rows_s  # the one store: n contiguous rows
        stored[k0:k0 + n] += 1
    return out, copied, stored


@pytest.mark.parametrize("R", sorted({1, 2, 4, 8, 16, BULK_R}))
@pytest.mark.parametrize("S", [512, 500, 5, 1])
def test_bulk_rows_cover_the_output_once(S, R):
    """S a multiple of R, not one (a ragged last CTA), and S < R."""
    rng = np.random.default_rng([S, R])
    table = torch.from_numpy(rng.integers(0, 1 << 30, (300, 8), dtype=np.int32))
    idx = torch.from_numpy(rng.integers(0, 300, S, dtype=np.int32))
    out, copied, stored = bulk_mirror(table, idx, R)
    assert torch.equal(copied, torch.ones(S, dtype=torch.int64))
    assert torch.equal(stored, torch.ones(S, dtype=torch.int64))
    assert torch.equal(out, probes.row_gather_plain(table, idx))
    assert len(bulk_ctas(S, R)) == -(-S // R)


# --------------------------------------------------------------------------
# P8: the PTX ISA's layouts
# --------------------------------------------------------------------------


def _lanes():
    tid = torch.arange(128)
    warp, lane = tid // 32, tid % 32
    return warp, lane // 4, lane % 4


def isa_a_map():
    """wgmma m64nNk16's A in registers (bf16): thread tid's register q, half
    e (0 low) -> (row, column) of the 64 x 16 tile; [128, 4, 2] each."""
    warp, g, t = (v[:, None, None] for v in _lanes())
    q, e = torch.arange(4)[None, :, None], torch.arange(2)[None, None, :]
    return 16 * warp + g + 8 * (q % 2), 2 * t + e + 8 * (q // 2)


def isa_d_map():
    """wgmma m64nNk16's f32 accumulators: thread tid's register i -> (row,
    column) of the 64 x N tile; [128, N / 2] each."""
    warp, g, t = (v[:, None] for v in _lanes())
    i = torch.arange(OH_N // 2)[None, :]
    return 16 * warp + g + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * t + i % 2


def isa_b_byte(start, k, n):
    """The byte of B's (k, n) in the no-swizzle K-major layout that a
    descriptor (start, LBO, SBO) names, for k < 16."""
    return start + (n // 8) * OH_SBO + (k // 8) * OH_LBO + (n % 8) * 16 + (k % 8) * 2


# --------------------------------------------------------------------------
# P8: the kernel's arithmetic
# --------------------------------------------------------------------------


def oh_b_off(k, n):
    return ((k >> 4) * OH_KSTEP + (n >> 3) * OH_SBO + ((k >> 3) & 1) * OH_LBO
            + (n & 7) * 16 + (k & 7) * 2)


def oh_ranges(rows: int, width: int, sms: int = SMS):
    """The launcher's (chunks a range, ranges)."""
    chunks = rows // OH_KC
    want = max(1, sms // (width // OH_N))
    per = -(-chunks // want)
    return per, -(-chunks // per)


def thread_rows():
    """Output row of thread tid's (m-tile mt, half h): [THREADS, MT, 2]."""
    tid = torch.arange(THREADS)[:, None, None]
    wg, warp, g = tid // 128, (tid // 32) % 4, (tid % 32) // 4
    mt, h = torch.arange(OH_MT)[None, :, None], torch.arange(2)[None, None, :]
    return (wg * OH_MT + mt) * 64 + warp * 16 + g + 8 * h


def row_keys(ids, klo, khi):
    """What a thread computes once for its rows (ids [THREADS, MT, 2], -1
    past S) in the range [klo, khi): kq = r >> 3 (chunk << 3 | register
    slot) where the row's 1 is in its registers, else -1; val, bf16 1.0 in
    the low or high half; own, the range holds the row's index."""
    t = (torch.arange(THREADS) % 4)[:, None, None]
    r = ids - klo
    own = (r >= 0) & (r < khi - klo)
    kq = torch.where(own & (((r >> 1) & 3) == t), r >> 3, torch.full_like(r, -1))
    return kq, ONE << ((r & 1) << 4), own


def a_registers(kq, val, c):
    """The A registers a thread builds for chunk c of its range:
    [THREADS, MT, 4 steps, 4 registers] (uint32 in int64)."""
    q = torch.arange(4)
    kq_q, val_q = kq[..., None, q & 1], val[..., None, q & 1]  # [T, MT, 1, 4]
    s = torch.arange(4)[:, None]
    return torch.where(kq_q == 8 * c + 2 * s + (q >> 1), val_q, torch.zeros_like(val_q))


def b_tile_source():
    """For each bf16 of a chunk's shared tile, the (k, n) of the f32 stage
    that the conversion wrote there; -1 where none did."""
    src = torch.full((OH_KC * OH_N,), -1, dtype=torch.int64)
    e = torch.arange(OH_KC // 8 * OH_N)
    n, k = e % OH_N, 8 * (e // OH_N)
    for j in range(8):  # the uint4 at oh_b_off(k, n): k + j in halfword j
        half = oh_b_off(k, n) // 2 + j
        assert (src[half] == -1).all(), "a halfword written twice"
        src[half] = (k + j) * OH_N + n
    return src


def wgmma_b_operand():
    """For each k16 step s and (k, n) of its 16 x N operand, the element
    (k, n) of the stage that the descriptor reads: [4, 16, N]."""
    src = b_tile_source()
    s = torch.arange(4)[:, None, None]
    k = torch.arange(16)[None, :, None]
    n = torch.arange(OH_N)[None, None, :]
    return src[isa_b_byte(s * OH_KSTEP, k, n) // 2]


def onehot_mirror(table, idx, sms: int = SMS):
    """pr_onehot_wgmma's result by the kernel's order; also the count of
    writes of each output element."""
    rows, width = table.shape
    S = idx.shape[0]
    assert S <= OH_S and rows % OH_KC == 0 and width % OH_N == 0
    tb = table.bfloat16().float()
    trow = thread_rows()
    ids = torch.where(trow < S, idx.long()[trow.clamp(max=S - 1)], torch.full_like(trow, -1))
    # A: every range's chunks' registers, unpacked by the ISA's map
    per, ranges = oh_ranges(rows, width, sms)
    a_row, a_col = isa_a_map()
    a = torch.zeros((OH_S, rows))
    written = torch.zeros((OH_S, rows), dtype=torch.int64)
    tid = torch.arange(THREADS)
    wg = (tid // 128)[:, None, None, None, None]
    mt = torch.arange(OH_MT)[None, :, None, None, None]
    s = torch.arange(4)[None, None, :, None, None]
    e = torch.arange(2)[None, None, None, None, :]
    r_in = a_row[tid % 128][:, None, None, :, :]
    c_in = a_col[tid % 128][:, None, None, :, :]
    keys = []
    for y in range(ranges):
        klo, khi = y * per * OH_KC, min((y + 1) * per * OH_KC, rows)
        keys.append(row_keys(ids, klo, khi))
        for c in range((khi - klo) // OH_KC):
            regs = a_registers(*keys[-1][:2], c)[..., None]
            bits = (regs >> (16 * e)) & 0xFFFF
            assert ((bits == 0) | (bits == ONE)).all()
            m = (wg * OH_MT + mt) * 64 + r_in
            col = klo + OH_KC * c + 16 * s + c_in
            m, col, bits = torch.broadcast_tensors(m, col, bits)
            a.index_put_((m.reshape(-1), col.reshape(-1)), (bits == ONE).float().reshape(-1))
            written.index_put_((m.reshape(-1), col.reshape(-1)),
                               torch.ones(m.numel(), dtype=torch.int64), accumulate=True)
    assert (written == 1).all(), "an A element in no register or in two"
    onehot = torch.zeros((OH_S, rows))
    onehot[torch.arange(S), idx.long()] = 1
    assert torch.equal(a, onehot)
    # B: each chunk's tile as converted, read back by the descriptor
    op = wgmma_b_operand()  # [4, 16, N]
    stage = tb.reshape(rows // OH_KC, OH_KC, width // OH_N, OH_N).permute(0, 2, 1, 3)
    stage = stage.reshape(rows // OH_KC, width // OH_N, OH_KC * OH_N)
    b = stage[:, :, op.reshape(-1)].reshape(rows // OH_KC, width // OH_N, OH_KC, OH_N)
    b = b.permute(0, 2, 1, 3).reshape(rows, width)
    # the ranges' products, their accumulators and the owner-write epilogue
    d_row, d_col = isa_d_map()
    out = torch.full((S, width), float("nan"))
    count = torch.zeros((S, width), dtype=torch.int64)
    tid = torch.arange(THREADS)
    t = (tid % 4)[:, None, None, None]
    h = torch.arange(2)[None, None, :, None]
    j = torch.arange(OH_N // 8)[None, None, None, :]
    for y in range(ranges):
        klo, khi = y * per * OH_KC, min((y + 1) * per * OH_KC, rows)
        d = a[:, klo:khi] @ b[klo:khi]  # [OH_S, width]: f32 sums
        own = keys[y][2]  # [THREADS, MT, 2]
        for x in range(width // OH_N):
            tile = d[:, x * OH_N:(x + 1) * OH_N].reshape(OH_WG * OH_MT, 64, OH_N)
            acc = tile[(tid // 128)[:, None, None] * OH_MT + torch.arange(OH_MT)[None, :, None],
                       d_row[tid % 128][:, None, :], d_col[tid % 128][:, None, :]]
            for ev in range(2):  # [THREADS, MT, N/2] -> registers 4j + 2h + e
                val = acc[:, :, None, :].expand(-1, -1, 2, -1).gather(
                    3, (4 * j + 2 * h + ev).expand(THREADS, OH_MT, 2, -1))
                mrow = trow[..., None].expand_as(val)
                mcol = (x * OH_N + 8 * j + 2 * t + ev).expand_as(val)
                keep = own[..., None].expand_as(val)
                out[mrow[keep], mcol[keep]] = val[keep]
                count.index_put_((mrow[keep], mcol[keep]),
                                 torch.ones(int(keep.sum()), dtype=torch.int64),
                                 accumulate=True)
    return out, count


def run_case(table, idx, sms=SMS):
    out, count = onehot_mirror(table, idx, sms)
    assert (count == 1).all(), "an output element written by no CTA or by two"
    want = probes.onehot_bf16_plain(table, idx)
    assert probes.max_abs_err(out, want) == 0


def _table(rows, width, seed):
    rng = np.random.default_rng([rows, width, seed])
    return torch.from_numpy(rng.integers(0, 24576, (rows, width)).astype(np.float32))


def _idx(name, rows, S, rng):
    per, ranges = oh_ranges(rows, 384)
    span = per * OH_KC
    if name == "random":
        return rng.integers(0, rows, S)
    if name == "one range":
        return rng.integers(3 * span, 4 * span, S)
    if name == "range edges":
        firsts = np.arange(ranges) * span
        lasts = np.minimum(firsts + span, rows) - 1
        edges = np.concatenate([[0, rows - 1], firsts, lasts])
        return np.resize(edges, S)
    if name == "repeated":
        return np.resize(rng.integers(0, rows, 5), S)
    raise KeyError(name)


CASES = [(rows, name) for rows in (4096, 8192)
         for name in ("random", "one range", "range edges", "repeated")]


@pytest.mark.parametrize("rows,name", CASES)
def test_onehot_mirror_equals_plain(rows, name):
    rng = np.random.default_rng(rows)
    idx = torch.from_numpy(_idx(name, rows, OH_S, rng).astype(np.int32))
    run_case(_table(rows, 384, 1), idx)


@pytest.mark.parametrize("rows,width,S", [(64 * 23, 384, 512), (64 * 23, 128, 512),
                                          (4096, 64, 512), (4096, 384, 100),
                                          (64, 64, 1)])
def test_onehot_mirror_ragged_and_short(rows, width, S):
    """A last range shorter than the others (23 chunks over ranges of 2 at
    width 384), one range a chunk (width 128), one slice, S below 512,
    the smallest table."""
    rng = np.random.default_rng([rows, width, S])
    idx = torch.from_numpy(rng.integers(0, rows, S).astype(np.int32))
    idx[0], idx[-1] = 0, rows - 1
    run_case(_table(rows, width, 2), idx)


def test_isa_fragment_maps_are_bijections():
    r, c = isa_a_map()
    assert sorted((16 * r + c).reshape(-1).tolist()) == list(range(64 * 16))
    r, c = isa_d_map()
    assert sorted((OH_N * r + c).reshape(-1).tolist()) == list(range(64 * OH_N))


def test_b_tile_is_a_bijection_read_back_whole():
    """The conversion writes every bf16 of the tile once, and the
    descriptor's k16 steps read each stage element (k, n) at k = 16 s + k16."""
    src = b_tile_source()
    assert sorted(src.tolist()) == list(range(OH_KC * OH_N))
    op = wgmma_b_operand()
    k = 16 * torch.arange(4)[:, None, None] + torch.arange(16)[None, :, None]
    n = torch.arange(OH_N)[None, None, :]
    assert torch.equal(op, k * OH_N + n)
    k, n = torch.meshgrid(torch.arange(OH_KC), torch.arange(OH_N), indexing="ij")
    assert (oh_b_off(k, n) % 2 == 0).all() and (oh_b_off(k[::8], n[::8]) % 16 == 0).all()


def test_a_registers_are_the_onehot():
    """Each row's 1 lies in exactly one register half of one thread (of the
    four that hold the row) in the chunk that holds its index, none
    elsewhere; a row outside the range has none."""
    ids = thread_rows() * 7 % 300  # row m's index: 7 m mod 300
    kq, val, own = row_keys(ids, 64, 320)
    ones = 0
    for c in range(4):
        regs = a_registers(kq, val, c)
        halves = torch.stack([regs & 0xFFFF, regs >> 16], -1)
        assert ((halves == 0) | (halves == ONE)).all()
        ones += int((halves == ONE).sum())
    assert ones == int(own[:, :, :].sum()) // 4 == int(((ids >= 64) & (ids < 320)).sum()) // 4


@pytest.mark.parametrize("rows,ctas", [(4096, 132), (8192, 132)])
def test_ranges_cover_the_table_once(rows, ctas):
    """The probe's geometries fill the 132 SMs (6 slices x 22 ranges); the
    ranges cover every chunk once, none empty, the last one shorter."""
    per, ranges = oh_ranges(rows, 384)
    assert (384 // OH_N) * ranges == ctas
    chunks = [c for y in range(ranges)
              for c in range(y * per, min((y + 1) * per, rows // OH_KC))]
    assert chunks == list(range(rows // OH_KC))
    last = rows // OH_KC - (ranges - 1) * per
    assert 1 <= last < per


def test_mirror_constants_match_the_kernel_source():
    assert OH_S == probes.ONEHOT_MAX_S == 512
    assert "(long long)(S < BULK_R ? S : BULK_R) * width * 4;" in SRC
    assert "constexpr int OH_S = 64 * OH_MT * OH_WG;" in SRC
    assert "constexpr int OH_KSTEP = 16 * OH_N * 2;" in SRC
    assert "const int k0 = blockIdx.x * BULK_R, n = min(BULK_R, S - k0);" in SRC
    assert "(S + BULK_R - 1) / BULK_R" in SRC
    assert "const int per = (chunks + want - 1) / want, ranges = (chunks + per - 1) / per;" in SRC
    assert "const int r = (m < S ? idx[m] : -1) - klo;" in SRC
    assert "const bool in = (unsigned)r < (unsigned)(khi - klo);" in SRC
    assert "kq[mt][h] = in && ((r >> 1) & 3) == t ? r >> 3 : -1;" in SRC
    assert "val[mt][h] = 0x3F80u << ((r & 1) << 4);" in SRC
    assert "a[s][q] = kq[q & 1] == 8 * c + 2 * s + (q >> 1) ? val[q & 1] : 0u;" in SRC
    assert "if (!(own >> (2 * mt + h) & 1)) continue;" in SRC
    assert "make_float2(acc[mt][4 * j + 2 * h], acc[mt][4 * j + 2 * h + 1])" in SRC
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in SRC and OH_N == 64
    assert "(n >> 3) * OH_SBO + ((k >> 3) & 1) * OH_LBO" in SRC
    assert "wmma::" not in SRC and "<mma.h>" not in SRC


def test_p3_arms_on_the_cpu():
    """Both arms are the plain version on the CPU; an unknown arm raises."""
    table = torch.arange(64 * 8, dtype=torch.int32).reshape(64, 8)
    idx = torch.tensor([5, 0, 63, 5], dtype=torch.int32)
    for arm in ("bulk", "warp"):
        assert torch.equal(probes.probe_dynslice_loop(table, idx, arm), table[idx.long()])
    with pytest.raises(ValueError, match="'bulk' or 'warp'"):
        probes.probe_dynslice_loop(table, idx, "ring")


def test_p3_arms_count_under_their_own_keys():
    """The bulk-copy arm is P3's headline and counts under P3; the one-warp
    arm counts apart, under P3w, so P3's launches are the headline's."""
    cases = probes.cases_p3("cpu", 16, seed=0)
    assert [(c.probe, c.counter, c.headline) for c in cases] == [
        ("P3", "P3", True), ("P3", "P3w", False)]
    assert all(c.counter in probes.LAUNCHES for c in cases)
    # every other probe: the headline arms under the probe's name, the
    # others apart (P1's thread a row, P4's launch a step, P5's flat gather)
    apart = {"p1": ["P1", "P1t"] * 4, "p4": ["P4", "P4s", "P4s"],
             "p5": ["P5", "P5", "P5w"]}
    for name, make in probes.PROBES.items():
        if name != "p3":
            cases = make("cpu", 16, seed=0)
            counters = [c.counter for c in cases]
            assert counters == apart.get(name, [c.probe for c in cases]), name
