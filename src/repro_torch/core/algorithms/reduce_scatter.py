"""Reduce-scatter schedules: ring | recursive_halving | hierarchical.

Buffer convention: ``num_blocks == nranks``; every rank starts with its
full local contribution (all N blocks); rank ``r`` ends owning the fully
reduced block ``r`` (other slots hold stale partials).
"""
from __future__ import annotations

from repro_torch.core.schedule import (CommRound, CommSchedule, NotApplicable,
                                 make_round)
from repro_torch.core.topology import Topology
from repro_torch.core.algorithms.allgather import parallel_fuse


def _ring_rs_rounds(nranks: int, members: list[int],
                    owned: list[list[int]]) -> list[CommRound]:
    """Ring reduce-scatter among ``members``: member i ends owning the
    fully reduced block set ``owned[i]``.  M-1 rounds; round t member i
    sends the traveling partial of set owned[(i - t - 1) % M] to i+1."""
    m = len(members)
    rounds = []
    for t in range(m - 1):
        edges, send, recv = [], {}, {}
        for i, r in enumerate(members):
            nxt = members[(i + 1) % m]
            s = owned[(i - t - 1) % m]
            edges.append((r, nxt))
            send[r] = s
            recv[nxt] = s
        rounds.append(make_round(nranks, edges, send, recv, reduce=True))
    return rounds


def _halving_rounds(nranks: int, members: list[int],
                    owned: list[list[int]]) -> list[CommRound]:
    """Recursive halving among 2^k members; member i ends owning owned[i].

    Round over offsets M/2, M/4, ..., 1: partner i^off; each member sends
    the half of its active sets belonging to the partner's side."""
    m = len(members)
    if m & (m - 1):
        raise NotApplicable("recursive halving needs power-of-2 members")
    active = {i: set(range(m)) for i in range(m)}  # set indices, not blocks
    rounds = []
    off = m // 2
    while off >= 1:
        edges, send, recv = [], {}, {}
        for i, r in enumerate(members):
            j = i ^ off
            p = members[j]
            edges.append((r, p))
            mine = {s for s in active[i] if (s & off) == (i & off)}
            theirs = sorted(active[i] - mine)
            blocks = [b for s in theirs for b in owned[s]]
            send[r] = blocks
            recv[p] = blocks
            active[i] = mine
        rounds.append(make_round(nranks, edges, send, recv, reduce=True))
        off //= 2
    return rounds


def ring(topo: Topology) -> CommSchedule:
    n = topo.nranks
    rounds = _ring_rs_rounds(n, list(range(n)), [[r] for r in range(n)])
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(rounds),
                    name="reduce_scatter.ring")


def recursive_halving(topo: Topology) -> CommSchedule:
    n = topo.nranks
    rounds = _halving_rounds(n, list(range(n)), [[r] for r in range(n)])
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(rounds),
                    name="reduce_scatter.recursive_halving")


def hierarchical(topo: Topology, intra: str = "ring",
                 inter: str = "ring") -> CommSchedule:
    """Locality-aware 2-stage reduce-scatter.

    A) intra-pod RS: local rank l reduces stripe S_l = {(q, l) for all q}
       over its pod (ICI only);
    B) inter-pod RS among same-l ranks over the Q stripe blocks, ending
       with rank (p, l) owning block (p, l) = its own rank id (DCN,
       1/R of the vector per rank — balanced and minimal).
    """
    n, R, Q = topo.nranks, topo.ranks_per_pod, topo.npods
    if Q == 1:
        return ring(topo) if intra == "ring" else recursive_halving(topo)
    sub = {"ring": _ring_rs_rounds, "recursive_halving": _halving_rounds}
    rounds: list[CommRound] = []
    groups_a = []
    for p in range(Q):
        members = list(topo.pod_ranks(p))
        owned = [[topo.rank(q, topo.local(r)) for q in range(Q)]
                 for r in members]
        groups_a.append(sub[intra](n, members, owned))
    rounds += parallel_fuse(groups_a, n)
    groups_b = []
    for l in range(R):
        members = [topo.rank(q, l) for q in range(Q)]
        owned = [[topo.rank(q, l)] for q in range(Q)]
        groups_b.append(sub[inter](n, members, owned))
    rounds += parallel_fuse(groups_b, n)
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(rounds),
                    name=f"reduce_scatter.hierarchical[{intra}+{inter}]")


ALGORITHMS = {
    "ring": ring,
    "recursive_halving": recursive_halving,
    "hierarchical": hierarchical,
}
