"""Batched adaptive frequency-table primitives on torch tensors.

Counterpart of :mod:`comprox_tpu.models.tables`; the collision rules are
the same (additive updates commute, rows rescale when read over their
cap, non-additive writes go to the minimum lane).  Everything is integer
arithmetic: the JAX package routes some of these sums through exact f32
matmuls, the port never does.
"""

from __future__ import annotations

import torch

HALVE_ROUNDS = 3


def halve_rows(rows, sticky_mask):
    """One halving pass: ceil-halving on ``sticky_mask`` slots, floor
    elsewhere; negative slots clamp to 0 first."""
    rows = rows.clamp_min(0)
    return torch.where(sticky_mask, (rows + 1) >> 1, rows >> 1)


def rescale_read(rows, cap: int, sticky_mask):
    """Read-time rescaling: ``(rows', did_halve)``."""
    did = torch.zeros(rows.shape[:-1], dtype=torch.bool, device=rows.device)
    for _ in range(HALVE_ROUNDS):
        need = row_total(rows) > cap
        did = did | need
        rows = torch.where(need[..., None], halve_rows(rows, sticky_mask), rows)
    return rows, did


def elect_winners(idx, mask):
    """One lane per distinct ``idx`` among ``mask``: the minimum lane wins."""
    s = idx.shape[0]
    lower = torch.ones((s, s), dtype=torch.bool, device=idx.device).tril(-1)
    dup = (idx[:, None] == idx[None, :]) & mask[None, :] & lower
    return mask & ~dup.any(dim=1)


def exclusive_cumsum(rows):
    """Exclusive prefix sum along the last axis (integer, exact)."""
    return torch.cumsum(rows, dim=-1, dtype=rows.dtype) - rows


def row_total(rows):
    return rows.sum(dim=-1, dtype=rows.dtype)


def cum_frq_of(rows, cums, sym):
    """``(cum, frq)`` of a known symbol per lane; 0 for a symbol outside
    the row (the JAX one-hot select gives 0 there too)."""
    w = rows.shape[-1]
    ok = (sym >= 0) & (sym < w)
    idx = torch.where(ok, sym, 0).to(torch.int64)[..., None]
    c = torch.gather(cums, -1, idx)[..., 0]
    f = torch.gather(rows, -1, idx)[..., 0]
    return torch.where(ok, c, 0), torch.where(ok, f, 0)


def find_symbol(rows, cums, target):
    """``count(cums <= target) - 1``, clipped to the row: the raw-domain
    decode search.  Not a search for the first symbol: with zero or
    negative slots the count is what the format defines."""
    le = (cums <= target[..., None]).sum(dim=-1, dtype=torch.int32)
    sym = (le - 1).clamp(0, rows.shape[-1] - 1)
    c, f = cum_frq_of(rows, cums, sym)
    return sym, c, f
