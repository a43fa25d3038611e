"""A sample of the window's outputs drawn from the seed while the window
runs, so that a run keeps only the outputs the check will read."""
from __future__ import annotations

import numpy as np


class Reservoir:
    """A uniform sample of ``size`` of the items offered, however many
    come (Algorithm R), drawn from ``rng``: the same seed and the same
    number of offers pick the same items."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng = int(size), rng
        self.seen = 0
        self._kept = {}              # slot -> (offer index, item)

    def wants(self) -> int | None:
        """Draw for the next offer: the slot it takes, or None if it is
        not kept.  Call once an offer, then ``keep`` what it asks for."""
        n, self.seen = self.seen, self.seen + 1
        if n < self.size:
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < self.size else None

    def keep(self, slot: int, item) -> None:
        self._kept[slot] = (self.seen - 1, item)

    def items(self) -> list:
        """The kept items in the order they were offered."""
        return [item for _i, item in sorted(self._kept.values(), key=lambda t: t[0])]
