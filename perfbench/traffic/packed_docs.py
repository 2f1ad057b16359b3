"""Training traffic: documents of heavy-tailed length, packed back to
back into rows of ``seq + 1`` tokens (an end-of-document id between
documents, no attention mask at their edges), ``batch`` rows a rank a
step.  Parameters (the workload's ``params``): ``batch``, ``seq``,
``doc_len_min`` / ``doc_len_max`` / ``doc_len_alpha`` (a Pareto tail
cut at the maximum), ``zipf_s`` (token ids Zipf-distributed over the
vocabulary), ``eos_id``.

Every rank draws the one stream of the seed and takes its own rows of
each step's ``world * batch``, so the rows of all ranks and all steps
differ.  The work a step does does not depend on the seed: every row is
``seq`` tokens long.
"""
from __future__ import annotations

import numpy as np


def zipf_table(vocab: int, s: float) -> np.ndarray:
    """The cumulative distribution of Zipf(s) ranks over ``vocab`` ids."""
    w = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** s
    return np.cumsum(w) / w.sum()


def draw_ids(rng, cdf: np.ndarray, n: int) -> np.ndarray:
    """``n`` token ids: Zipf ranks 1.. mapped to ids 1..vocab-1 (id 0 is
    left to the end-of-document mark)."""
    ids = np.searchsorted(cdf, rng.random(n)) + 1
    return np.minimum(ids, cdf.size - 1).astype(np.int64)


class Stream:
    def __init__(self, params: dict, seed: int, vocab: int, *, rank: int = 0,
                 world: int = 1):
        self.p, self.rank, self.world = params, rank, world
        self.rng = np.random.default_rng(
            np.random.SeedSequence([int(seed) & (2 ** 64 - 1), 0x7A]))
        self.cdf = zipf_table(vocab, params["zipf_s"])
        self.buf = np.zeros(0, np.int64)

    def _doc(self) -> np.ndarray:
        p = self.p
        n = int(min(p["doc_len_max"],
                    p["doc_len_min"] * (1 + self.rng.pareto(
                        p["doc_len_alpha"]))))
        ids = draw_ids(self.rng, self.cdf, n)
        return np.concatenate([ids, [p["eos_id"]]]).astype(np.int64)

    def next(self) -> dict:
        """The next step's rows of this rank: ``tokens`` and ``labels``
        [batch, seq] int64 (numpy), labels the tokens shifted by one."""
        B, S = self.p["batch"], self.p["seq"]
        need = self.world * B * (S + 1)
        parts = [self.buf]
        have = self.buf.size
        while have < need:
            d = self._doc()
            parts.append(d)
            have += d.size
        flat = np.concatenate(parts)
        self.buf = flat[need:]
        rows = flat[:need].reshape(self.world * B, S + 1)
        mine = rows[self.rank * B:(self.rank + 1) * B]
        return {"tokens": np.ascontiguousarray(mine[:, :-1]),
                "labels": np.ascontiguousarray(mine[:, 1:])}
