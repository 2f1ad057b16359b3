"""Prompt traffic for one client in a closed loop, batch 1: prompt
lengths spread log-uniformly over [``len_min``, ``len_max``] and rounded
up to a multiple of ``round_to`` (the flash kernel's tile), token ids
Zipf-distributed over the vocabulary (``zipf_s``).

The set of lengths is the same for every seed: a grid of ``grid``
lengths at the log-uniform quantiles (i + 1/2) / grid, sent round after
round, each round in an order drawn from the seed.  The seed changes the
order and the tokens, not the work.
"""
from __future__ import annotations

import math

import numpy as np

from perfbench.traffic.packed_docs import draw_ids, zipf_table


def length_grid(params: dict) -> list[int]:
    lo, hi, n = params["len_min"], params["len_max"], params["grid"]
    r = params["round_to"]
    out = []
    for i in range(n):
        x = math.exp(math.log(lo) + (i + 0.5) / n * math.log(hi / lo))
        out.append(int(math.ceil(x / r) * r))
    return out


class Stream:
    def __init__(self, params: dict, seed: int, vocab: int):
        self.rng = np.random.default_rng(
            np.random.SeedSequence([int(seed) & (2 ** 64 - 1), 0x9B]))
        self.grid = length_grid(params)
        self.cdf = zipf_table(vocab, params["zipf_s"])
        self.order: list[int] = []

    def next(self) -> np.ndarray:
        """The next prompt: int64 token ids [length] (numpy)."""
        if not self.order:
            self.order = list(self.rng.permutation(self.grid))
        n = int(self.order.pop())
        return draw_ids(self.rng, self.cdf, n)
