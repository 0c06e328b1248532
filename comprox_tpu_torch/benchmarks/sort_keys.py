"""Adversarial key sets for the shared radix sort (``csrc/sortlib.cuh``).

Each set stresses one part of the design: every digit constant (all passes
skipped), a few digits constant (some skipped), ties across tiles (two
values, sorted and reverse-sorted runs), a tile cut short (fewer keys than
a tile, or not a multiple of it), and the main path's size (8 Mi random
keys).  ``keys(name)`` makes a set from a seed with numpy: int64 keys in
[0, 2^32), the form ``codec.block.radix_sort`` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from comprox_tpu_torch.codec.block import K4_TILE as TILE  # keys a sort tile

SETS = ("all_equal", "two_values", "sorted", "reverse", "low_8_bits",
        "low_16_bits", "high_byte_only", "one_key", "below_a_tile",
        "not_a_tile_multiple", "random_8Mi")


def keys(name: str, seed: int = 17):
    rng = np.random.default_rng(seed)
    m = 1 << 32
    make = {
        "all_equal": lambda: np.full(100_000, 0xC0FFEE),
        "two_values": lambda: rng.integers(0, 2, 300_001) * 0xDEADBEEF,
        "sorted": lambda: np.sort(rng.integers(0, m, 200_000)),
        "reverse": lambda: np.sort(rng.integers(0, m, 200_000))[::-1],
        "low_8_bits": lambda: rng.integers(0, 1 << 8, 123_457),
        "low_16_bits": lambda: rng.integers(0, 1 << 16, 1 << 20),
        "high_byte_only": lambda: rng.integers(0, 256, 50_000) << 24,
        "one_key": lambda: np.array([7]),
        "below_a_tile": lambda: rng.integers(0, m, TILE - 1),
        "not_a_tile_multiple": lambda: rng.integers(0, m, 7 * TILE + 3),
        "random_8Mi": lambda: rng.integers(0, m, 8 << 20),
    }[name]
    return torch.from_numpy(np.ascontiguousarray(make(), dtype=np.int64))
