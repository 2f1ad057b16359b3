"""Hierarchy-staged schedule builders over the full ``Topology`` stack.

The ``hierarchical`` builders hard-code one pod/local split (2 levels).
These builders generalize the same staging to *every* level of a
multi-level ``Topology`` (DCN over N-D torus axes) through one generic
axis-decomposition engine:

  * **reduce-scatter stages** run innermost -> outermost: at level
    ``l`` the ranks that differ only in their level-``l`` coordinate
    partition their live block set by the *block's* level-``l``
    coordinate, so by the time a stage crosses a slow outer link every
    rank ships exactly the fully-pre-reduced blocks that belong on the
    other side — the outermost (DCN) stage moves single blocks.
  * **allgather stages** run outermost -> innermost: the slow links
    move each rank's own block once (stripe exchange), and the fast
    inner torus axes fan the received stripes out with ever larger
    bundles.  DCN bytes match the 2-level locality-aware Bruck minimum
    (each block crosses once per remote pod) with fewer total rounds.
  * **alltoall stages** process one axis at a time (innermost first)
    via content-ownership simulation: every rank bundles all blocks
    whose destination differs at that axis and ships one message per
    axis peer — locality-aware intermediate aggregation that cuts
    level-``l`` message counts from one-per-(src, dst) pair to
    ``size_l - 1`` per rank.

Both phase families share one ownership formula: at the stage for
level ``l``, a rank owns exactly the blocks whose coordinates match its
own at every level ``>= l``.  On a 1-level topology the builders
degenerate to the flat ring/pairwise schedules; on the canonical
2-level hierarchy the allreduce/reduce-scatter stagings reproduce the
``hierarchical`` builders round-for-round (see test_hierarchical.py).
"""
from __future__ import annotations

from repro_torch.core.schedule import CommRound, CommSchedule
from repro_torch.core.topology import Topology
from repro_torch.core.algorithms import allgather as ag
from repro_torch.core.algorithms import reduce_scatter as rs
from repro_torch.core.algorithms.allgather import parallel_fuse
from repro_torch.core.algorithms.alltoall import OwnershipSim


def _coords_table(topo: Topology) -> list[tuple[int, ...]]:
    """coords(r) for every rank, computed once per builder — the stage
    loops below index it O(n^2) times per level."""
    return [topo.coords(r) for r in range(topo.nranks)]


def level_groups(topo: Topology, lvl: int,
                 coords: list | None = None) -> list[list[int]]:
    """Rank groups that differ only in the level-``lvl`` coordinate,
    each ordered by that coordinate (rank order within a group)."""
    coords = coords if coords is not None else _coords_table(topo)
    groups: dict[tuple, list[int]] = {}
    for r in range(topo.nranks):
        c = coords[r]
        groups.setdefault(c[:lvl] + c[lvl + 1:], []).append(r)
    return [sorted(g) for g in groups.values()]


def _owned_blocks(topo: Topology, rank: int, lvl: int,
                  coords: list | None = None) -> list[int]:
    """Blocks whose coordinates match ``rank``'s at every level >= lvl.

    This is the per-stage ownership set of the staged decomposition:
    the union over a level-``lvl`` group is the set matching at levels
    > ``lvl`` (what each member holds entering an RS stage / owns
    leaving an AG stage), and fixing every level collapses it to the
    rank's own block.
    """
    coords = coords if coords is not None else _coords_table(topo)
    tail = coords[rank][lvl:]
    return [b for b in range(topo.nranks) if coords[b][lvl:] == tail]


def _rs_stages(topo: Topology) -> list[CommRound]:
    """Reduce-scatter staged innermost -> outermost (ring sub-stages)."""
    n = topo.nranks
    coords = _coords_table(topo)
    rounds: list[CommRound] = []
    for lvl in reversed(range(len(topo.levels))):
        groups = []
        for members in level_groups(topo, lvl, coords):
            owned = [_owned_blocks(topo, r, lvl, coords) for r in members]
            groups.append(rs._ring_rs_rounds(n, members, owned))
        rounds += parallel_fuse(groups, n)
    return rounds


def _ag_stages(topo: Topology) -> list[CommRound]:
    """Allgather staged outermost -> innermost (ring sub-stages)."""
    n = topo.nranks
    coords = _coords_table(topo)
    rounds: list[CommRound] = []
    for lvl in range(len(topo.levels)):
        groups = []
        for members in level_groups(topo, lvl, coords):
            owned = [_owned_blocks(topo, r, lvl, coords) for r in members]
            groups.append(ag._ring_rounds(n, members, owned))
        rounds += parallel_fuse(groups, n)
    return rounds


def allgather_staged(topo: Topology) -> CommSchedule:
    """Stripe-staged allgather: cross each level once, slowest first
    with single own blocks, then widen on the faster inner axes."""
    n = topo.nranks
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(_ag_stages(topo)),
                        name="allgather.staged")


def reduce_scatter_staged(topo: Topology) -> CommSchedule:
    """Per-axis reduce-scatter: partition by block coordinate level by
    level so outer links only carry pre-reduced blocks."""
    n = topo.nranks
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(_rs_stages(topo)),
                        name="reduce_scatter.staged")


def allreduce_staged(topo: Topology) -> CommSchedule:
    """Staged allreduce: reduce-scatter down the level stack (innermost
    axis first), then allgather back up — the k-level generalization of
    the 4-stage node-aware allreduce."""
    n = topo.nranks
    rounds = _rs_stages(topo) + _ag_stages(topo)
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(rounds),
                        name="allreduce.staged")


def alltoall_staged(topo: Topology) -> CommSchedule:
    """Axis-staged alltoall (ownership-simulated, in-place).

    Invariant: once the levels in a processed set D are done, the data
    ``s -> d`` sits on the rank whose coordinates match ``d`` on D and
    ``s`` elsewhere.  Processing level ``l`` is a pairwise exchange
    inside each level-``l`` group where offset-``t`` messages bundle
    every held block destined to the peer's level-``l`` coordinate
    (``n / size_l`` blocks per message).  Innermost-first ordering
    aggregates within the pod before a single bundled DCN stage —
    level-``l`` messages drop to ``size_l - 1`` per rank.
    """
    n = topo.nranks
    sim = OwnershipSim(n)
    coords = _coords_table(topo)
    for lvl in reversed(range(len(topo.levels))):
        size = topo.levels[lvl].size
        for t in range(1, size):
            edges_payload = []
            for r in range(n):
                c = list(coords[r])
                c[lvl] = (c[lvl] + t) % size
                dst = topo.rank_of(c)
                contents = [cid for cid in sim.where[r]
                            if coords[cid % n][lvl] == c[lvl]]
                edges_payload.append((r, dst, contents))
            sim.round(edges_payload)
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(sim.rounds),
                        name="alltoall.staged", local_post=sim.post())


def serialized_pod_allgather(topo: Topology) -> CommSchedule:
    """Deliberately NAIVE staged allgather: each pod's intra-pod ring
    stage emitted back-to-back instead of ``parallel_fuse``'d — the
    rank-disjoint per-pod stages a careless staged builder serializes.
    NOT registered: this is the reference foil for the persistent
    executor's fusion pass (core.executor), which must recover the
    parallel form (``npods * (R-1)`` rounds -> ``R-1``).  Shared by
    tests/test_executor.py, tests/device_scripts/check_executor.py and
    benchmarks/bench_transport.py so the corpus entry and its expected
    round counts live in one place."""
    n = topo.nranks
    rounds: list[CommRound] = []
    for p in range(topo.npods):
        members = list(topo.pod_ranks(p))
        rounds += ag._ring_rounds(n, members, [[r] for r in members])
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(rounds),
                        name="allgather.staged_naive")


def _bruck_ag_rounds(n: int, members: list[int]) -> list[CommRound]:
    """Bruck-style allgather inside one rank group: log-step bundled
    shifts with *growing* message widths (1, 2, 4, ... blocks), blocks
    stored in-place at their own slot ids.  The width-staggered foil to
    the equal-width ring sub-stages of ``ag._ring_rounds``."""
    from repro_torch.core.schedule import make_round

    R = len(members)
    rounds: list[CommRound] = []
    d = 1
    while d < R:
        cnt = min(d, R - d)
        edges, send, recv = [], {}, {}
        for i in range(R):
            blocks = [members[(i + t) % R] for t in range(cnt)]
            src, dst = members[i], members[(i - d) % R]
            edges.append((src, dst))
            send[src] = blocks
            recv[dst] = blocks            # land at their own slot ids
        rounds.append(make_round(n, edges, send, recv))
        d *= 2
    return rounds


def staggered_pod_allgather(topo: Topology) -> CommSchedule:
    """Deliberately WIDTH-STAGGERED naive staged allgather: even pods
    run the equal-width ring stage, odd pods a Bruck log-step stage
    whose bundles double in width — so the rank-disjoint per-pod
    stages, serialized back-to-back, can only *partially* re-fuse under
    the topology-free equal-padded-width rule (the wide Bruck rounds
    find no equal-width partner).  The cost-model-armed pass
    (``core.executor._compact_armed``) overlaps them fully via
    unequal-width whole-round merges priced by ``topo.round_time``.
    NOT registered: like ``serialized_pod_allgather`` this is a corpus
    foil, shared by tests/test_executor.py, tests/test_schedule_fuzz.py
    and benchmarks/bench_transport.py."""
    n = topo.nranks
    rounds: list[CommRound] = []
    for p in range(topo.npods):
        members = list(topo.pod_ranks(p))
        if p % 2 == 0:
            rounds += ag._ring_rounds(n, members, [[r] for r in members])
        else:
            rounds += _bruck_ag_rounds(n, members)
    return CommSchedule(nranks=n, num_slots=n, rounds=tuple(rounds),
                        name="allgather.staged_staggered")


# Registered per family by repro_torch.core.algorithms.REGISTRY (registering
# here would cycle: this module imports the family modules' sub-stage
# builders).
ALGORITHMS = {
    "allgather": allgather_staged,
    "allreduce": allreduce_staged,
    "reduce_scatter": reduce_scatter_staged,
    "alltoall": alltoall_staged,
}
