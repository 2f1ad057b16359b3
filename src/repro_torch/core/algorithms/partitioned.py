"""Partitioned communication (paper §2.3, MPIPCL) — the schedule builders.

MPIPCL channelizes a point-to-point message: one match at init, then the
buffer moves as P independently-committed *partitions*, letting transfer
of ready partitions overlap with production/consumption of the rest
("early-bird" communication).  On the unified IR a partitioned transfer
is a ``CommSchedule`` of P rounds, one chunk each, so the tuner can time
the partition-count tradeoff like any other schedule.

Only the builders live here; the runtime forms (chunked point-to-point
with a consumer, collective matmuls, bucketed gradient sums) come with
a later slice of the port.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np

from repro_torch.core.schedule import CommSchedule, make_round
from repro_torch.core.topology import Topology


def _shift_perm(n: int, shift: int = 1) -> list[tuple[int, int]]:
    return [(i, (i + shift) % n) for i in range(n)]


def partitioned_schedule(nranks: int, perm: Sequence[tuple[int, int]],
                         partitions: int = 1) -> CommSchedule:
    """A partitioned point-to-point transfer as a ``CommSchedule``.

    The working buffer has ``2 * partitions`` slots per rank: rows
    ``[0, P)`` hold the outgoing chunks, rows ``[P, 2P)`` receive.
    Round ``i`` ships chunk ``i`` along ``perm`` — MPIPCL's P
    independently-committed partitions, expressed in the same IR the
    dense and neighborhood collectives compile to.
    """
    P = int(partitions)
    if P < 1:
        raise ValueError(
            f"partitioned_schedule: partitions must be >= 1, got "
            f"{partitions}")
    edges = tuple((int(s), int(d)) for s, d in perm)
    rounds = []
    for i in range(P):
        send = {s: [i] for s, _ in edges}
        recv = {d: [P + i] for _, d in edges}
        rounds.append(make_round(nranks, edges, send, recv))
    return CommSchedule(
        nranks=nranks, num_slots=2 * P, rounds=tuple(rounds),
        name=f"partitioned.shift[p{P}]", out_slots=P,
        out_offsets=np.full(nranks, P, np.int64))


def _chunked_shift(topo: Topology, partitions: int) -> CommSchedule:
    return partitioned_schedule(topo.nranks, _shift_perm(topo.nranks),
                                partitions)


ALGORITHMS = {
    f"p{p}": functools.partial(_chunked_shift, partitions=p)
    for p in (1, 2, 4, 8)
}
