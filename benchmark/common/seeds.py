"""Seeds of a run's parts, each drawn from ``--seed`` and its part's name."""

from __future__ import annotations

import zlib

import numpy as np


def part(seed: int, name: str) -> int:
    """A 63-bit seed for ``name``'s draws: the same ``seed`` gives the same."""
    entropy = [int(seed) % 2**64, zlib.crc32(name.encode())]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]) & (2**63 - 1)
