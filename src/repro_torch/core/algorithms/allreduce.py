"""Allreduce schedules: ring_rs_ag | recursive_halving_doubling | hierarchical.

Buffer convention: ``num_blocks == nranks`` (the vector is pre-chunked
into N blocks); every rank starts with its full local contribution and
ends with every block fully reduced.

All variants are bandwidth-optimal (2 * V * (N-1)/N bytes per rank); they
differ in round count and in *which link class* the rounds cross — the
hierarchical variant confines all but 2*(Q-1) single-block rounds to the
pod (ICI), the paper's node-aware allreduce story.
"""
from __future__ import annotations

from repro_torch.core.schedule import CommRound, CommSchedule
from repro_torch.core.topology import Topology
from repro_torch.core.algorithms import allgather as ag
from repro_torch.core.algorithms import reduce_scatter as rs
from repro_torch.core.algorithms.allgather import parallel_fuse


def ring_rs_ag(topo: Topology) -> CommSchedule:
    n = topo.nranks
    members = list(range(n))
    singles = [[r] for r in range(n)]
    rounds = (rs._ring_rs_rounds(n, members, singles)
              + ag._ring_rounds(n, members, singles))
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(rounds),
                    name="allreduce.ring_rs_ag")


def recursive_halving_doubling(topo: Topology) -> CommSchedule:
    n = topo.nranks
    members = list(range(n))
    singles = [[r] for r in range(n)]
    rounds = (rs._halving_rounds(n, members, singles)
              + ag._recursive_doubling_rounds(n, members, singles))
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(rounds),
                    name="allreduce.recursive_halving_doubling")


def hierarchical(topo: Topology, intra: str = "ring",
                 inter: str = "ring") -> CommSchedule:
    """4-stage node-aware allreduce:
    A) intra-pod reduce-scatter of stripes   (ICI)
    B) inter-pod reduce-scatter (1 block)    (DCN, minimal + balanced)
    C) inter-pod allgather of stripe blocks  (DCN)
    D) intra-pod allgather of stripes        (ICI)
    """
    n, R, Q = topo.nranks, topo.ranks_per_pod, topo.npods
    if Q == 1:
        return ring_rs_ag(topo)
    rs_sub = {"ring": rs._ring_rs_rounds,
              "recursive_halving": rs._halving_rounds}[intra]
    rounds: list[CommRound] = []
    # A
    groups = []
    for p in range(Q):
        members = list(topo.pod_ranks(p))
        owned = [[topo.rank(q, topo.local(r)) for q in range(Q)]
                 for r in members]
        groups.append(rs_sub(n, members, owned))
    rounds += parallel_fuse(groups, n)
    # B
    groups = []
    for l in range(R):
        members = [topo.rank(q, l) for q in range(Q)]
        owned = [[topo.rank(q, l)] for q in range(Q)]
        groups.append(rs._ring_rs_rounds(n, members, owned))
    rounds += parallel_fuse(groups, n)
    # C
    groups = []
    for l in range(R):
        members = [topo.rank(q, l) for q in range(Q)]
        owned = [[topo.rank(q, l)] for q in range(Q)]
        groups.append(ag._ring_rounds(n, members, owned))
    rounds += parallel_fuse(groups, n)
    # D
    groups = []
    for p in range(Q):
        members = list(topo.pod_ranks(p))
        owned = [[topo.rank(q, topo.local(r)) for q in range(Q)]
                 for r in members]
        groups.append(ag._ring_rounds(n, members, owned))
    rounds += parallel_fuse(groups, n)
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(rounds),
                    name=f"allreduce.hierarchical[{intra}+{inter}]")


def hierarchical_rh(topo: Topology) -> CommSchedule:
    """Locality-aware variant with recursive-halving intra-pod stages
    (log rounds on ICI; needs power-of-two ranks per pod)."""
    return hierarchical(topo, intra="recursive_halving")


ALGORITHMS = {
    "ring_rs_ag": ring_rs_ag,
    "recursive_halving_doubling": recursive_halving_doubling,
    "hierarchical": hierarchical,
    "hierarchical_rh": hierarchical_rh,
}
