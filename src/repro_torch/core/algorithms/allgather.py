"""Allgather schedules: ring | bruck | recursive_doubling | hierarchical.

Buffer convention: ``num_blocks == nranks``; rank ``r`` initially owns
block ``r`` (other slots are garbage/zero); afterwards every rank owns
every block.

``hierarchical`` is the two-level adaptation of the locality-aware Bruck
allgather (Bienz et al. [2] — paper §2.1): gather inside the pod over ICI,
cross the DCN exactly once per block in ``ranks_per_pod``-wide stripes,
then redistribute inside the pod.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.schedule import (CommRound, CommSchedule, NotApplicable,
                                 make_round)
from repro_torch.core.topology import Topology


# ---------------------------------------------------------------------------
# generic sub-builders over an ordered member list with arbitrary ownership
# ---------------------------------------------------------------------------


def _ring_rounds(nranks: int, members: list[int],
                 owned: list[list[int]]) -> list[CommRound]:
    """Ring allgather among ``members``; members[i] starts owning blocks
    ``owned[i]`` (equal sizes); after M-1 rounds each member owns the union.
    """
    m = len(members)
    rounds = []
    for t in range(m - 1):
        edges, send, recv = [], {}, {}
        for i, r in enumerate(members):
            nxt = members[(i + 1) % m]
            edges.append((r, nxt))
            send[r] = owned[(i - t) % m]
            recv[nxt] = owned[(i - t) % m]
        rounds.append(make_round(nranks, edges, send, recv))
    return rounds


def _bruck_rounds(nranks: int, members: list[int],
                  owned: list[list[int]]) -> list[CommRound]:
    """Dissemination (Bruck) allgather among ``members``: ceil(log2 M)
    rounds; round t, member i sends every set it has to member i - 2^t."""
    m = len(members)
    rounds = []
    t = 0
    while (1 << t) < m:
        off = 1 << t
        cnt = min(off, m - off)  # sets transferred this round
        edges, send, recv = [], {}, {}
        for i, r in enumerate(members):
            dst = members[(i - off) % m]
            edges.append((r, dst))
            blocks = [b for j in range(cnt) for b in owned[(i + j) % m]]
            send[r] = blocks
            recv[dst] = blocks
        rounds.append(make_round(nranks, edges, send, recv))
        t += 1
    return rounds


def _recursive_doubling_rounds(nranks: int, members: list[int],
                               owned: list[list[int]]) -> list[CommRound]:
    m = len(members)
    if m & (m - 1):
        raise NotApplicable("recursive doubling needs power-of-2 members")
    rounds = []
    t = 0
    while (1 << t) < m:
        off = 1 << t
        edges, send, recv = [], {}, {}
        for i, r in enumerate(members):
            j = i ^ off
            p = members[j]
            edges.append((r, p))
            base = (i >> t) << t  # start of my aligned group of size 2^t
            blocks = [b for q in range(base, base + off) for b in owned[q]]
            send[r] = blocks
            recv[p] = blocks
        rounds.append(make_round(nranks, edges, send, recv))
        t += 1
    return rounds


_SUB = {"ring": _ring_rounds, "bruck": _bruck_rounds,
        "recursive_doubling": _recursive_doubling_rounds}


# ---------------------------------------------------------------------------
# round fusion: disjoint groups (pods / stripes) run their stages in parallel
# ---------------------------------------------------------------------------


def _disjoint(a: CommRound, b: CommRound) -> bool:
    sa = {s for s, _ in a.perm} | {d for _, d in a.perm}
    sb = {s for s, _ in b.perm} | {d for _, d in b.perm}
    return not (sa & sb)


def _fuse(a: CommRound, b: CommRound, nranks: int) -> CommRound:
    assert a.reduce == b.reduce
    k = max(a.k, b.k)

    def pad(x):
        if x.shape[1] == k:
            return x
        out = np.full((x.shape[0], k), -1, np.int32)
        out[:, : x.shape[1]] = x
        return out

    sa, ra = pad(a.gather_idx), pad(a.scatter_idx)
    sb, rb = pad(b.gather_idx), pad(b.scatter_idx)
    mask_b = np.zeros(nranks, bool)
    for s, d in b.perm:
        mask_b[s] = True
        mask_b[d] = True
    gather = np.where(mask_b[:, None], sb, sa)
    scatter = np.where(mask_b[:, None], rb, ra)
    return CommRound(perm=a.perm + b.perm, gather_idx=gather,
                     scatter_idx=scatter, reduce=a.reduce)


def parallel_fuse(groups: list[list[CommRound]], nranks: int) -> list[CommRound]:
    """Zip same-index rounds of rank-disjoint groups into single rounds."""
    groups = [g for g in groups if g]
    if not groups:
        return []
    depth = max(len(g) for g in groups)
    out = []
    for i in range(depth):
        stage = [g[i] for g in groups if i < len(g)]
        fused = stage[0]
        for rnd in stage[1:]:
            assert _disjoint(fused, rnd), "parallel groups must be disjoint"
            fused = _fuse(fused, rnd, nranks)
        out.append(fused)
    return out


# ---------------------------------------------------------------------------
# public builders
# ---------------------------------------------------------------------------


def _flat(topo: Topology, kind: str) -> CommSchedule:
    n = topo.nranks
    rounds = _SUB[kind](n, list(range(n)), [[r] for r in range(n)])
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(rounds),
                    name=f"allgather.{kind}")


def ring(topo: Topology) -> CommSchedule:
    return _flat(topo, "ring")


def bruck(topo: Topology) -> CommSchedule:
    return _flat(topo, "bruck")


def recursive_doubling(topo: Topology) -> CommSchedule:
    return _flat(topo, "recursive_doubling")


def hierarchical(topo: Topology, intra: str = "bruck",
                 inter: str = "bruck") -> CommSchedule:
    """Locality-aware 3-stage allgather.

    A) intra-pod allgather of the pod's own blocks         (ICI only)
    B) striped inter-pod allgather: local rank l moves the
       blocks of local index l between pods                (the only DCN)
    C) intra-pod allgather of the received remote stripes  (ICI only)

    Every block crosses the DCN exactly once per remote pod, and DCN
    traffic is balanced across all ranks of the pod (stripes) — the win of
    the locality-aware Bruck algorithm over flat log-step schedules whose
    top rounds ship half the buffer across the slow links.
    """
    n, R, Q = topo.nranks, topo.ranks_per_pod, topo.npods
    if Q == 1:
        return _flat(topo, intra)
    rounds: list[CommRound] = []
    # A: per-pod allgather of local blocks (pods in parallel)
    groups_a = []
    for p in range(Q):
        members = list(topo.pod_ranks(p))
        groups_a.append(_SUB[intra](n, members, [[r] for r in members]))
    rounds += parallel_fuse(groups_a, n)
    # B: per-local-index allgather across pods (stripes in parallel)
    groups_b = []
    for l in range(R):
        members = [topo.rank(q, l) for q in range(Q)]
        groups_b.append(_SUB[inter](n, members, [[r] for r in members]))
    rounds += parallel_fuse(groups_b, n)
    # C: per-pod allgather of remote stripes: local rank l now owns
    # {(q, l) for q != p}; redistribute so everyone owns everything.
    groups_c = []
    for p in range(Q):
        members = list(topo.pod_ranks(p))
        owned = [[topo.rank(q, topo.local(r)) for q in range(Q) if q != p]
                 for r in members]
        groups_c.append(_SUB[intra](n, members, owned))
    rounds += parallel_fuse(groups_c, n)
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(rounds),
                    name=f"allgather.hierarchical[{intra}+{inter}]")


def hierarchical_ring(topo: Topology) -> CommSchedule:
    """Locality-aware variant with ring sub-stages (fewest messages per
    round; better when per-round payload is bandwidth-bound)."""
    return hierarchical(topo, intra="ring", inter="ring")


ALGORITHMS = {
    "ring": ring,
    "bruck": bruck,
    "recursive_doubling": recursive_doubling,
    "hierarchical": hierarchical,
    "hierarchical_ring": hierarchical_ring,
}
