"""Lane-interleaved rANS primitives on torch tensors.

Counterpart of :mod:`comprox_tpu.ops.rans`: the same streaming rANS with a
32-bit state, 16-bit words and M = 2^15 totals, vectorised over S lanes.
The scalar specification stays :mod:`comprox_tpu.ops.rans_scalar`, which
imports no JAX and is reused here for its constants.

Unsigned 32-bit values (states, words, normalised events) are held in
int64 tensors masked to 32 bits: torch on the CPU has no ``//``, ``%``,
``>>`` or comparisons for uint32.  The CUDA kernels use ``uint32_t``.
"""

from __future__ import annotations

import torch

from comprox_tpu_torch.ops.rans_scalar import M, M_BITS, MASK16, MASK_M, RANS_L

MASK32 = 0xFFFFFFFF
_i64 = torch.int64


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(_i64) & MASK32


def identity_cf(shape, device):
    """The no-op coding event ``(0, M)`` for masked lanes."""
    return (
        torch.zeros(shape, dtype=_i64, device=device),
        torch.full(shape, M, dtype=_i64, device=device),
    )


def norm_cf(cum, frq, tot):
    """Raw ``(cum, frq, tot)`` -> M-scaled ``(c, f)`` (uint32 arithmetic)."""
    cum, frq, tot = _u32(cum), _u32(frq), _u32(tot)
    c1 = ((cum << M_BITS) & MASK32) // tot
    c2 = (((cum + frq) & MASK32) << M_BITS & MASK32) // tot
    return c1, (c2 - c1) & MASK32


def select_cf(active, c, f):
    """Replace ``(c, f)`` by the identity event on inactive lanes."""
    return (
        torch.where(active, _u32(c), 0),
        torch.where(active, _u32(f), M),
    )


def enc_put(x, c, f):
    """One backward-encode step for every lane: ``(state, emit, word)``."""
    x, c, f = _u32(x), _u32(c), _u32(f)
    emit = (x >> (32 - M_BITS)) >= f
    word = x & MASK16
    x = torch.where(emit, x >> 16, x)
    x = ((((x // f) << M_BITS) & MASK32) + c + x % f) & MASK32
    return x, emit, word


def dec_slot(x):
    return _u32(x) & MASK_M


def dec_target(slot, tot):
    """Raw-domain cumulative-search target for a decoded slot."""
    slot, tot = _u32(slot), _u32(tot)
    return ((slot * tot + tot - 1) & MASK32) >> M_BITS


def dec_advance(x, c, f):
    """State advance without renormalisation: ``(x_tmp, need_word)``."""
    x, c, f = _u32(x), _u32(c), _u32(f)
    x = (f * (x >> M_BITS) + (x & MASK_M) - c) & MASK32
    return x, x < RANS_L


def dec_renorm(x_tmp, need, word):
    """Feed one u16 word into every lane flagged by ``need``."""
    fed = ((x_tmp << 16) | _u32(word)) & MASK32
    return torch.where(need, fed, x_tmp)


def stream_window_read(stream, start, need):
    """Lane-ordered word read: ``(words, used)``.

    Lane i's word is ``stream[start' + excl(need)[i]]``, where excl is the
    exclusive prefix count of ``need`` in lane order and ``start'`` is
    ``start`` clamped so that an S-word window fits in the stream (the
    JAX decoder slices that window with ``lax.dynamic_slice``, which
    clamps its start; the stream is padded so that a valid stream never
    reaches the clamp).  Lanes without ``need`` read 0.  ``used`` is the
    number of words read.
    """
    s = need.shape[0]
    start = int(start)
    if start >= 1 << 31:  # the JAX start is cast to int32
        start = 0
    start = max(0, min(start, stream.shape[0] - s))
    inc = need.to(_i64)
    excl = torch.cumsum(inc, 0) - inc
    words = stream[start + excl].to(_i64) & MASK16
    return torch.where(need, words, 0), int(inc.sum())


def init_states(n_lanes: int, device):
    return torch.full((n_lanes,), RANS_L, dtype=_i64, device=device)


__all__ = [
    "M", "M_BITS", "MASK16", "MASK32", "MASK_M", "RANS_L",
    "identity_cf", "norm_cf", "select_cf", "enc_put", "dec_slot",
    "dec_target", "dec_advance", "dec_renorm", "stream_window_read",
    "init_states",
]
