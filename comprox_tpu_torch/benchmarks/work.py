"""Each kernel's work at one launch, and the least time the card could take
for it.

A kernel's work is the bytes its function must move (each input read once,
each output written once) and a stated model of the 32-bit operations it
does on these inputs (where they depend on the data, what this launch's
data needs).  The bound is the larger of the bytes over the card's memory
rate and the operations over its peak rate.  ``chip_smoke.py``'s kernel
cells and ``benchmarks/phases.py`` (``times``, ``bounds``) both count
through this module, so that the two bound columns share one model.

The functions of the kernels that are not step scans take the arguments
of the block API entry that launches the kernel and its result ``out``,
and return (bytes, operations).  The step scans' bytes include the rows of
their tables that a launch changed, which each caller counts its own way;
``scan_ops`` gives their operations.
"""

from __future__ import annotations

from comprox_tpu_torch.codec import block as blk

# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, and the float32 rate outside the tensor cores, taken for the
# kernels' 32-bit integer operations (the data sheet has no integer row)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def bound(nbytes: int, ops: int) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate, and which one it is."""
    t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _adm(lens, min_len) -> int:
    """The admissible lengths of candidates of these lengths."""
    return int((lens.long() - min_len + 1).clamp_min(0).sum())


def _ext(lens, cap=None) -> int:
    """8-byte compares of extensions to these lengths."""
    lens = lens.long() if cap is None else lens.long().clamp_max(cap)
    return int((lens // 8 + 1).sum())


def sort(key, pos, n, *, out) -> tuple:
    """The shared radix sort (``block._radix_sort``; ``out`` its passes):
    the keys read, keys and positions written; a digit, a rank and a place
    a key and pass."""
    return 12 * n, 3 * int(out) * n


def k4(p, inp, n, content=False, *, out) -> tuple:
    """K4, K4x (``block.sort_candidates``): four radix passes (digit,
    count, place: 3 each), the probe chain (key compare, usable, 8-byte
    probe: 4 an entry), and each proposal's extension, 8 bytes a compare."""
    chain = blk._finder_config(p, True)[1] if content else 2 * blk._R_PROBE
    return nbytes(inp, out), p.capacity * (4 * 3 + chain * 4) + 2 * _ext(out[0::2])


def k6(p, n, cands, prices=None, n_c=None, rep=None, *, out) -> tuple:
    """K6 (``block.parse_scan``): per position the literal (4), and per
    candidate each admissible length (add, clamp, key, min: 4).  Mode R
    writes three grids; the other modes two, read the repeat pair where
    they have one and price its lengths too."""
    if p.mode == "R":
        lens = cands[0: 3 * (blk._R_CANDS + 1): 3]
        return nbytes(cands, out), 4 * p.capacity + 4 * _adm(lens, p.min_len)
    ops = 4 * p.capacity + 4 * _adm(cands[0::2], p.min_len)
    if rep is None:
        return nbytes(cands, out[:2]), ops
    return nbytes(cands, out[:2], rep), ops + 4 * _adm(rep[0], p.min_len)


def k3(p, ev, *, out) -> tuple:
    """K3 (``block.rans_scan``): the events read, the states and words
    written and a byte a flag; an event 8 a slot and position."""
    states, emit, words = out
    return nbytes(ev, states, words) + emit.numel(), p.capacity * p.n_slots * 8


def k3p(p, emit, *, out) -> tuple:
    """K3p (``block.pack_emit``): a byte a flag read, a byte written per
    eight; a mask, a multiply and a shift a packed byte."""
    return nbytes(emit, out), 3 * out.numel()


def k3b(emit_packed, words, *, out) -> tuple:
    """K3b (``block.compact_stream``; ``out`` (n_words, stream)): the mask
    read once, and of the words only the flagged ones, which the function
    needs (the rest need not be read), read once and written as 2 bytes
    each, and the counts; a flag test a lane, a rank, an address and a
    store a flagged word."""
    n_words = out[0]
    total = int(n_words.sum())
    return (nbytes(emit_packed, n_words) + (4 + 2) * total,
            words.numel() + 3 * total)


def kcr(p, ment, *, out) -> tuple:
    """KCR (``block.remap_chain_ment``): the table read and written once;
    a subtract, a max, a compare and a select an entry."""
    return nbytes(ment, out), 4 * (ment.numel() // 2)


def k11(p, inp, n, dec, *, out) -> tuple:
    """K11 (``block.rep_scan``): the block and (take, src) read, (len_rep,
    prev) written; twelve a position (two walks)."""
    return nbytes(inp, dec[:2], out), 12 * p.capacity


def k13c(p, inp, n, lzp, *, out) -> tuple:
    """K13c (``block.lzp_candidates``; ``out`` the grid): the block read,
    the grid written, and of the three tables the slots the block inserts
    into, read and written once (4 bytes each way); per key (three a
    position) the key (8) and three radix passes (3 each), the segmented
    max (4); per position the registers (16), the checks (16) and the
    window compare of each candidate the grid holds, 8 bytes a compare."""
    slots = sum(int((lzp[k] != 0).sum()) for k in blk.LZP_KEYS)
    ok = (out & blk.LZP_GRID_OK) != 0
    compares = int(((out & (blk.LZP_GRID_OK - 1)).long() // 8 + 1)[ok].sum())
    return (nbytes(inp, out) + 8 * slots,
            3 * p.capacity * (8 + 3 * 3 + 4) + p.capacity * 32 + compares)


def k7(p, inp, n, *, out) -> tuple:
    """K7 (``fast.f2_find``): four radix passes (3 each), per candidate the
    key compare and the scatter (4), and its extension, 8 bytes a compare
    (at most the fast profile's extension)."""
    from comprox_tpu_torch.codec import fast

    return (nbytes(inp, out),
            p.capacity * (4 * 3 + 4 * fast._F_CANDS)
            + 2 * _ext(out[0::2], 4 * (fast._EXTW - 1)))


def k8(p, inp, n, dec, *, out) -> tuple:
    """K8 (``fast.tokenize``; ``out`` = (n_tok, sym, xtr, tbits)): the take
    of each of the n positions read (4 bytes), a match's src (one 32-byte
    sector: the matches lie a lane apart in the [T, S] grid) and a token's
    byte, 12 bytes a token written; per position the replay (4), the event
    (10) and one scan of two values (4), and the token's code (20 a
    token)."""
    n_tok, sym = out[0], out[1]
    n_match = int((sym[:n_tok] >= 256).sum())
    return 4 * n + 32 * n_match + 13 * n_tok, p.capacity * 18 + n_tok * 20


def k9(p, sym, xtr, tbits, n_tok, *, out) -> tuple:
    """K9 (``fast._encode_scan``: ``out[2]`` the word count; or
    ``fast.encode_scan``: ``out[2]`` the words): 12 bytes a token read, the
    table and the states written, 2 a word; three events a token (8 each)
    and the histogram (2)."""
    freq, states, words = out[:3]
    n_words = int(words) if len(out) == 4 else words.numel()
    return 12 * n_tok + nbytes(freq, states) + 2 * n_words, n_tok * (3 * 8 + 2)


def k10(p, freq, states, stream, n_tok, *, out) -> tuple:
    """K10 (``fast._decode_scan``; ``out[1]`` the words used): 2 bytes a
    word read, the table and the states, 4 a token written; three events a
    token (8 each), the slot table (M * 10) and the plane (10 a token)."""
    from comprox_tpu_torch.ops.rans_scalar import M

    return (2 * int(out[1]) + nbytes(freq, states) + 4 * n_tok,
            n_tok * (3 * 8 + 10) + M * 10)


SCAN_KERNELS = ("KS", "KSx", "K5", "K5ch", "K2", "K12e", "K13e", "K1", "K1ch",
                "K12d", "K13d")


def scan_ops(kernel: str, p, out=None) -> int:
    """A step scan's modelled operations at one launch on block ``p``: per
    position the row entries scored and compared, the o2 row (260 slots:
    read, adjust, sum: 3) and the side models (64); K5 also each match
    found's window compare, 8 bytes at a time (from its result ``out``).
    The chain arms K5ch and K1ch count as K5 and K1."""
    kernel = {"K5ch": "K5", "K1ch": "K1"}.get(kernel, kernel)
    d, win8 = p.rolz_depth, p.window // 8
    search = 6 * d + p.top_k * p.probe // 8 + win8
    per_position = {
        "KS": search,
        "KSx": 2 * search + 12 + win8,  # two bucket rows, the near-match cache
        "K5": d * (6 + 2 * blk._R_CANDS),
        "K2": 3 * 260 + 64,
        "K12e": 3 * 260 + 64,
        "K13e": 3 * 260 + 64,  # the candidate from K13c's grid
        "K1": 3 * 260 + 64 + 4 * d,  # the bucket row
        "K12d": 3 * 260 + 64,
        "K13d": 3 * 260 + 64 + 16,
    }[kernel]
    ops = p.capacity * per_position
    if kernel == "K5":
        ops += 2 * _ext(out[3 * blk._R_CANDS])
    return ops
