"""Alltoall schedules: pairwise | bruck | hierarchical (+ v-variant costing).

Buffer convention: ``num_blocks == nranks``.
  input : slot ``d`` on rank ``r`` holds the data  r -> d
  output: slot ``s`` on rank ``r`` holds the data  s -> r

``hierarchical`` is the two-level adaptation of the collective-optimized
alltoall of Namugwanya et al. [12] (paper §2.1): aggregate everything
headed to a remote pod inside the source pod first (ICI), ship one
R-block bundle per (pod-pair, local-rank) over the DCN, then the bundles
arrive pre-sorted.  DCN message count per pod-pair drops from R^2 to R.

Builders for pairwise/hierarchical simulate content ownership rank-by-rank
and emit block tables, so correctness is by construction (verified against
the numpy oracle in tests); bruck uses the classic fixed-slot argument
with local pre/post rotations.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.schedule import CommRound, CommSchedule, make_round
from repro_torch.core.topology import Topology

# content id for "data s -> d" with N ranks: s * N + d


def _content(s: int, d: int, n: int) -> int:
    return s * n + d


class OwnershipSim:
    """Rank-by-rank content-ownership simulator emitting block-table rounds.

    Tracks, per rank, a ``content-id -> slot`` map (content ``s*n+d`` is
    the data ``s -> d``); each ``round`` moves listed contents between
    ranks, landing receives in the slots the receiver's own sends
    vacated — so schedules built this way are correct by construction
    and in-place (no separate recv region).  Used by ``hierarchical``
    (2-level) and by the multi-axis ``staged`` builder (staged.py).
    """

    def __init__(self, n: int):
        self.n = n
        # where[r]: content-id -> slot; start: slot d holds r -> d.
        self.where = [{_content(r, d, n): d for d in range(n)}
                      for r in range(n)]
        self.rounds: list[CommRound] = []

    def round(self, edges_payload) -> None:
        """edges_payload: list of (src, dst, [content ids]).  Receiver
        stores incoming contents into the slots its own sends vacated."""
        n, where = self.n, self.where
        # each rank may send and receive at most once per round: the
        # vacated-slot reuse below hands every edge into dst the same
        # slots (and make_round would drop duplicate rows) — a
        # multi-in-degree round would corrupt the table silently
        srcs = [s for s, _, _ in edges_payload]
        dsts = [d for _, d, _ in edges_payload]
        assert len(set(srcs)) == len(srcs), "duplicate src in round"
        assert len(set(dsts)) == len(dsts), "duplicate dst in round"
        edges, send, recv = [], {}, {}
        vacated = {r: [] for r in range(n)}
        for s, d, contents in edges_payload:
            slots = [where[s][c] for c in contents]
            vacated[s] += slots
        for s, d, contents in edges_payload:
            edges.append((s, d))
            send[s] = [where[s][c] for c in contents]
            tgt_slots = vacated[d][: len(contents)]
            assert len(tgt_slots) == len(contents), (
                "receiver must vacate as many slots as it receives")
            recv[d] = tgt_slots
            for c in contents:
                del where[s][c]
        # apply receives after all sends are resolved
        for s, d, contents in edges_payload:
            for c, slot in zip(contents, recv[d]):
                where[d][c] = slot
        self.rounds.append(make_round(n, edges, send, recv))

    def post(self) -> np.ndarray:
        """local_post table: out slot s <- current slot of content s->r."""
        n = self.n
        post = np.zeros((n, n), np.int32)
        for r in range(n):
            for s in range(n):
                post[r, s] = self.where[r][_content(s, r, n)]
        return post


def pairwise(topo: Topology) -> CommSchedule:
    """N-1 rounds; round t: rank r sends r -> (r+t) data, receives from
    (r-t).  One block per message; self block never moves.

    Uses split send/recv regions (blocks [0,n) read-only input, [n,2n)
    receive landing zone) exactly like MPI's sendbuf/recvbuf pair — an
    in-place variant is impossible for general N (slot (r+t) is clobbered
    by the round-(n-t) receive before round t sends it)."""
    n = topo.nranks
    rounds = []
    for t in range(1, n):
        edges, send, recv = [], {}, {}
        for r in range(n):
            dst = (r + t) % n
            src = (r - t) % n
            edges.append((r, dst))
            send[r] = [dst]        # input region: slot d = data r->d
            recv[r] = [n + src]    # recv region: slot n+s = data s->r
        rounds.append(make_round(n, edges, send, recv))
    post = np.zeros((n, 2 * n), np.int32)
    for r in range(n):
        for s in range(n):
            post[r, s] = r if s == r else n + s
        for j in range(n, 2 * n):
            post[r, j] = j
    return CommSchedule(nranks=n, num_slots=2 * n, rounds=tuple(rounds),
                    name="alltoall.pairwise", local_post=post, out_slots=n)


def bruck(topo: Topology) -> CommSchedule:
    """log2(N) rounds of N/2 blocks.  Slot v travels a total distance of
    exactly v (one hop per set bit), so after local_pre places data r->d
    at slot (d-r) mod N, every value lands on its destination; local_post
    restores source order."""
    n = topo.nranks
    pre = np.zeros((n, n), np.int32)
    post = np.zeros((n, n), np.int32)
    for r in range(n):
        for v in range(n):
            pre[r, v] = (r + v) % n          # new slot v <- old slot r+v
        for s in range(n):
            post[r, s] = (r - s) % n         # out slot s <- slot r-s
    rounds = []
    t = 0
    while (1 << t) < n:
        off = 1 << t
        slots = [v for v in range(n) if v & off]
        edges, send, recv = [], {}, {}
        for r in range(n):
            edges.append((r, (r + off) % n))
            send[r] = slots
            recv[(r + off) % n] = slots
        rounds.append(make_round(n, edges, send, recv))
        t += 1
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(rounds),
                    name="alltoall.bruck", local_pre=pre, local_post=post)


def hierarchical(topo: Topology) -> CommSchedule:
    """Two-stage locality-aware alltoall (ownership-simulated tables).

    Stage 1 (intra-pod, pairwise): (p,l) hands (p,l') every block destined
    to local index l' of ANY pod — Q blocks per message.
    Stage 2 (inter-pod, pairwise over pods): (p,l) ships to (p+u,l) the
    R-block bundle {(src=(p,*) -> dst=(p+u,l))} — one DCN message per
    (pod-pair, local rank).
    """
    n, R, Q = topo.nranks, topo.ranks_per_pod, topo.npods
    if Q == 1:
        return pairwise(topo)
    sim = OwnershipSim(n)
    # Stage 1: intra-pod pairwise, bundles of Q (one block per dest pod)
    for t in range(1, R):
        edges_payload = []
        for p in range(Q):
            for l in range(R):
                src = topo.rank(p, l)
                dst = topo.rank(p, (l + t) % R)
                contents = [_content(src, topo.rank(q, (l + t) % R), n)
                            for q in range(Q)]
                edges_payload.append((src, dst, contents))
        sim.round(edges_payload)
    # Stage 2: inter-pod pairwise, bundles of R (pre-sorted per dest rank)
    for u in range(1, Q):
        edges_payload = []
        for p in range(Q):
            for l in range(R):
                src = topo.rank(p, l)
                dstp = (p + u) % Q
                dst = topo.rank(dstp, l)
                contents = [_content(topo.rank(p, ls), dst, n)
                            for ls in range(R)]
                edges_payload.append((src, dst, contents))
        sim.round(edges_payload)
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(sim.rounds),
                    name="alltoall.hierarchical", local_post=sim.post())


# ---------------------------------------------------------------------------
# alltoallv accounting (execution pads to the max block; costs use counts)
# ---------------------------------------------------------------------------


def alltoallv_bytes(kind: str, counts: np.ndarray, topo: Topology,
                    elem_bytes: int = 1) -> dict:
    """Exact per-link-class traffic for an alltoallv with byte matrix
    ``counts[src, dst]`` under each schedule family.

    pairwise:      data s->d crosses its own (s, d) link once.
    hierarchical:  s->d travels s ->(intra) agg ->(DCN) ->(arrived).
    Returns {"ici": bytes, "dcn": bytes, "msgs_ici": int, "msgs_dcn": int}.
    """
    n = topo.nranks
    out = {"ici": 0, "dcn": 0, "msgs_ici": 0, "msgs_dcn": 0}

    def add(src, dst, nbytes):
        key = "ici" if topo.is_local(src, dst) else "dcn"
        out[key] += int(nbytes) * elem_bytes
        out["msgs_" + key] += 1 if nbytes > 0 else 0

    if kind == "pairwise":
        for s in range(n):
            for d in range(n):
                if s != d:
                    add(s, d, counts[s, d])
    elif kind == "hierarchical":
        R, Q = topo.ranks_per_pod, topo.npods
        for p in range(Q):
            for l in range(R):
                src = topo.rank(p, l)
                # stage 1: to each intra-pod peer, its Q-dest bundle
                for l2 in range(R):
                    if l2 == l:
                        continue
                    nb = sum(counts[src, topo.rank(q, l2)] for q in range(Q))
                    add(src, topo.rank(p, l2), nb)
                # stage 2: one bundle per remote pod
                for q in range(Q):
                    if q == p:
                        continue
                    nb = sum(counts[topo.rank(p, ls), topo.rank(q, l)]
                             for ls in range(R))
                    add(src, topo.rank(q, l), nb)
    else:
        raise ValueError(kind)
    return out


ALGORITHMS = {
    "pairwise": pairwise,
    "bruck": bruck,
    "hierarchical": hierarchical,
}
