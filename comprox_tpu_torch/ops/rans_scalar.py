"""Scalar rANS oracle — the bit-exact specification of the entropy coder.

This module is the executable spec for the lane-interleaved vectorized coder
in :mod:`comprox_tpu_torch.ops.rans` (the port's own copy of the JAX
package's ``ops/rans_scalar.py``).  It is intentionally written as slow,
obvious Python integer code; the vectorized coder and the kernels are
differentially tested against it.

Design notes (vs the reference's carry-correct byte range coder,
cr-rangecoder.c:44-104):

The reference coder renormalizes one *byte* at a time and needs carry
propagation through an unbounded run of 0xFF cache bytes — a data-dependent,
variable-length emission that is hostile to lock-step SIMD lanes.  We instead
use streaming rANS (range asymmetric numeral system) with

  * 32-bit state ``x`` kept in the interval [2^16, 2^32),
  * 16-bit renormalization words, and
  * all coding distributions normalized at query time to a power-of-two
    total ``M = 2^M_BITS``.

With these choices every symbol emits (encode) or consumes (decode) **at most
one** u16 word, with no carries — the property that lets hundreds of lanes
advance in lock-step on the VPU.

Adaptive models keep *raw* integer frequency tables with arbitrary totals
``tot <= M`` (they rescale to maintain that invariant).  A raw triple
(cum, frq, tot) is mapped to the M-scale by

    c' = (cum        << M_BITS) // tot
    f' = ((cum+frq) << M_BITS) // tot - c'

which is monotone and, because ``tot <= M``, guarantees ``f' >= 1`` for every
``frq >= 1``.  The decoder never materializes the normalized table: from a
slot ``s = x & (M-1)`` it computes the raw-domain target

    T = (s*tot + tot - 1) >> M_BITS

and runs the ordinary raw cumulative-frequency search (the same search the
reference does in cr-model.c:98-115), because  c'(C) <= s  ⇔  C <= T  exactly
for any raw cumulative value C.

Interval correctness (M = 2^15, renorm base 2^16, state in [2^16, 2^32)):
pre-encode the state must lie in [2*f', f' << 17); the encoder renormalizes
while ``x >= f' << 17`` (at most once, since one shift brings x < 2^16
<= f' << 17), and post-shift ``x >= 2*f'`` holds because pre-shift
``x >= f' << 17``.  Symmetrically the decoder reads at most one word.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

M_BITS = 15
M = 1 << M_BITS  # 32768: every model must keep tot <= M
RANS_L = 1 << 16  # lower bound of the state interval [L, L << 16)
MASK_M = M - 1
MASK16 = 0xFFFF
U32 = 0xFFFFFFFF


def norm_cf(cum: int, frq: int, tot: int) -> Tuple[int, int]:
    """Map a raw (cum, frq, tot) triple to the M-scaled (c', f')."""
    assert 0 < tot <= M, tot
    assert 0 < frq and 0 <= cum and cum + frq <= tot, (cum, frq, tot)
    c1 = (cum << M_BITS) // tot
    c2 = ((cum + frq) << M_BITS) // tot
    return c1, c2 - c1


def decode_target(slot: int, tot: int) -> int:
    """Largest raw cumulative value C with norm-cum(C) <= slot.

    The decoder searches its raw frequency table for the symbol s with
    ``cum_s <= T < cum_s + frq_s`` — identical in shape to the reference's
    ``range_decoder_decode_cum`` + table search (cr-rangecoder.c:101-104).
    """
    return (slot * tot + tot - 1) >> M_BITS


class RansEncoder:
    """LIFO rANS encoder: feed symbols in *reverse* order, then ``finish``.

    Emitted u16 words come out in reverse stream order; ``finish`` reverses
    them so the decoder can read forward.
    """

    def __init__(self) -> None:
        self.x = RANS_L
        self._rev_words: List[int] = []

    def put(self, cum: int, frq: int, tot: int) -> None:
        c, f = norm_cf(cum, frq, tot)
        self.put_normalized(c, f)

    def put_normalized(self, c: int, f: int) -> None:
        assert f >= 1
        x = self.x
        if x >= (f << (32 - M_BITS)):  # renormalize: emit exactly one word
            self._rev_words.append(x & MASK16)
            x >>= 16
        self.x = ((x // f) << M_BITS) + c + (x % f)
        assert RANS_L <= self.x <= U32

    def finish(self) -> Tuple[int, List[int]]:
        """Return (final_state, forward-order word list)."""
        return self.x, self._rev_words[::-1]


class RansDecoder:
    """Forward rANS decoder over a u16 word list plus the encoder state."""

    def __init__(self, state: int, words: Sequence[int]) -> None:
        self.x = state
        self.words = list(words)
        self.pos = 0

    def slot(self) -> int:
        return self.x & MASK_M

    def advance(self, cum: int, frq: int, tot: int) -> None:
        c, f = norm_cf(cum, frq, tot)
        self.advance_normalized(c, f)

    def advance_normalized(self, c: int, f: int) -> None:
        x = self.x
        x = f * (x >> M_BITS) + (x & MASK_M) - c
        if x < RANS_L:  # renormalize: read exactly one word
            x = (x << 16) | self.words[self.pos]
            self.pos += 1
        self.x = x

    def assert_drained(self) -> None:
        assert self.x == RANS_L, self.x
        assert self.pos == len(self.words), (self.pos, len(self.words))


def encode_symbols(events: Sequence[Tuple[int, int, int]]) -> Tuple[int, List[int]]:
    """Encode a forward-order list of raw (cum, frq, tot) events."""
    enc = RansEncoder()
    for cum, frq, tot in reversed(events):
        enc.put(cum, frq, tot)
    return enc.finish()


def decode_with_tables(
    state: int, words: Sequence[int], freq_rows: Sequence[Sequence[int]]
) -> List[int]:
    """Decode one symbol per row of raw frequency tables (test helper)."""
    dec = RansDecoder(state, words)
    out = []
    for row in freq_rows:
        tot = sum(row)
        t = decode_target(dec.slot(), tot)
        cum = 0
        sym = 0
        while cum + row[sym] <= t:
            cum += row[sym]
            sym += 1
        dec.advance(cum, row[sym], tot)
        out.append(sym)
    dec.assert_drained()
    return out
