"""Persistent neighborhood-collective plans (paper §2.2), PyTorch port.

MPI Advance's persistent neighborhood collectives hoist all setup of a
sparse exchange (``MPI_Dist_graph_create_adjacent`` +
``MPIX_Neighbor_alltoallv_init``) into a one-time *plan*, then add a
locality-aware extension: user-supplied unique indices let the library
ship each value across a node boundary once, no matter how many ranks on
the far side need it, and aggregate many small inter-node messages into
one per node pair.

The plan is compiled on the host, in numpy, to the same unified
gather-permute-scatter IR the dense collectives use (``CommRound`` /
``CommSchedule``, see schedule.py) and executed by the shared transports
(``SimTransport``, ``DistTransport``, ``KernelTransport``) — there are
no neighbor-specific executors.  Only the execution touches tensors.
Two build modes:

  * ``aggregate=False`` — standard: one message per graph edge, rounds
    formed by greedy edge coloring (each round is a partial permutation).
  * ``aggregate=True``  — locality-aware: 3 phases.
      A) intra-pod: each source forwards, per remote pod q, the *unique*
         values any rank of q needs to a designated local aggregator
         (striped across the pod by q),
      B) inter-pod: one aggregated DCN message per (src pod, dst pod)
         carried between the stripe aggregators,
      C) intra-pod: the receiving aggregator fans values out to final
         destinations (duplication happens on fast intra-pod links only).
    Intra-pod graph edges bypass the aggregators (direct, colored).
  * ``aggregate=None``  — select per policy (fixed / model / tuned, see
    selector.select_neighbor).

Both modes land received values in an identical recv layout (segments
ordered by source rank), so they are drop-in interchangeable — the
paper's Listing 3 -> Listing 4 replacement.

Working buffer layout per rank (rows of width ``feat``):
    [0, n_local)                local send values (input)
    [n_local, recv_off)         staging region (aggregators only)
    [recv_off, recv_off+n_recv) final recv segments (output)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.schedule import CommRound, CommSchedule
from repro_torch.core.topology import Topology
from repro_torch.core.transport import SimTransport

ELEM_BYTES = 4   # accounting default: float32 rows


# ---------------------------------------------------------------------------
# communication graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CommGraph:
    """Sparse exchange: ``edges[(src, dst)]`` = indices into src's local
    value array that dst needs (duplicates allowed across dsts — that is
    exactly what locality-aware aggregation exploits)."""

    nranks: int
    local_sizes: tuple[int, ...]                    # values owned per rank
    edges: dict[tuple[int, int], np.ndarray]

    def __post_init__(self):
        for (s, d), idx in self.edges.items():
            assert 0 <= s < self.nranks and 0 <= d < self.nranks
            assert s != d, "self-edges are local copies, not messages"
            assert len(idx) > 0
            assert idx.max() < self.local_sizes[s]

    def recv_layout(self, rank: int) -> list[tuple[int, np.ndarray]]:
        """Deterministic recv segment order: ascending source rank."""
        return [(s, self.edges[(s, d)])
                for (s, d) in sorted(self.edges) if d == rank]

    def n_recv(self, rank: int) -> int:
        return sum(len(ix) for _, ix in self.recv_layout(rank))

    def total_values(self) -> int:
        """Total value rows the exchange moves (standard-plan volume)."""
        return sum(len(idx) for idx in self.edges.values())

    @staticmethod
    def random(nranks: int, n_local: int, degree: int, rng,
               dup_frac: float = 0.5) -> "CommGraph":
        """Random sparse graph; ``dup_frac`` controls how often the same
        source value is requested by several destinations (the dedupe
        opportunity)."""
        edges: dict[tuple[int, int], np.ndarray] = {}
        for s in range(nranks):
            dsts = rng.permutation(nranks - 1)[:degree]
            dsts = [int(d) if d < s else int(d) + 1 for d in dsts]
            pool = rng.integers(0, n_local, max(1, int(n_local * dup_frac)))
            for d in dsts:
                k = int(rng.integers(1, n_local + 1))
                use_pool = rng.random(k) < dup_frac
                idx = np.where(use_pool,
                               pool[rng.integers(0, len(pool), k)],
                               rng.integers(0, n_local, k))
                edges[(s, d)] = idx.astype(np.int64)
        return CommGraph(nranks=nranks, local_sizes=(n_local,) * nranks,
                         edges=edges)


# ---------------------------------------------------------------------------
# the compiled plan (a CommSchedule plus graph metadata)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NeighborPlan:
    """A compiled persistent neighborhood alltoallv.

    Since the IR unification this is a thin wrapper: ``schedule`` is an
    ordinary ``CommSchedule`` (executable by any Transport, timeable by
    the tuner) and the plan only adds the graph/recv-layout metadata the
    API wrappers need.
    """

    graph: CommGraph
    topo: Topology
    schedule: CommSchedule
    recv_offsets: tuple[int, ...]  # per rank, start of recv region
    recv_sizes: tuple[int, ...]
    name: str = "neighbor"

    @property
    def rounds(self) -> tuple[CommRound, ...]:
        return self.schedule.rounds

    @property
    def buf_rows(self) -> int:        # working rows (excl. scratch)
        return self.schedule.num_slots

    @property
    def num_rounds(self) -> int:
        return self.schedule.num_rounds

    @property
    def num_compiled_rounds(self) -> int:
        """Round count after persistent-executor compilation, armed
        with this plan's topology.  The greedy edge coloring already
        packs rounds tightly, so the topology-free drain pass usually
        leaves the count unchanged; the cost-model-armed pass can
        additionally delete a round by splitting its edges across
        earlier rounds when ``topo.round_time`` proves it free."""
        from repro_torch.core import executor
        return executor.get_executor(self.schedule,
                                     topo=self.topo).rounds_after

    # -- accounting (paper claim: aggregation cuts DCN bytes/messages) ----
    def traffic(self, elem_bytes: int = 1) -> dict:
        return self.schedule.traffic(self.topo, elem_bytes)

    def modeled_time(self, elem_bytes: int = ELEM_BYTES) -> float:
        """alpha-beta time of the exchange with ``elem_bytes``-wide rows."""
        return self.schedule.modeled_time(self.topo, elem_bytes)

    def makespan(self, elem_bytes: int = ELEM_BYTES) -> float:
        """Makespan of the armed executor's packed plan (executor pass
        3): rounds on disjoint topology levels overlap, so a plan whose
        compiled rounds alternate DCN and intra-pod hops is priced below
        the serial ``modeled_time`` — never above it (pointwise)."""
        from repro_torch.core import executor
        return executor.get_executor(self.schedule,
                                     topo=self.topo).makespan(elem_bytes)


# ---------------------------------------------------------------------------
# plan building
# ---------------------------------------------------------------------------


def _edge_color(edges: list[tuple[int, int]]) -> list[list[int]]:
    """Greedy edge coloring: returns rounds as lists of edge indices such
    that within a round every src sends <=1 and every dst receives <=1."""
    src_busy: list[set[int]] = []
    dst_busy: list[set[int]] = []
    rounds: list[list[int]] = []
    # longest-first gives better packing; stable order for determinism
    order = sorted(range(len(edges)), key=lambda i: edges[i])
    for i in order:
        s, d = edges[i]
        for c in range(len(rounds) + 1):
            if c == len(rounds):
                rounds.append([])
                src_busy.append(set())
                dst_busy.append(set())
            if s not in src_busy[c] and d not in dst_busy[c]:
                rounds[c].append(i)
                src_busy[c].add(s)
                dst_busy[c].add(d)
                break
    return rounds


def _mk_round(nranks: int, items: list[tuple[int, int, np.ndarray, np.ndarray]]
              ) -> CommRound:
    """items: (src, dst, gather_rows, scatter_rows) with equal lengths."""
    w = max(1, max(len(g) for _, _, g, _ in items))
    gi = np.full((nranks, w), -1, np.int64)
    si = np.full((nranks, w), -1, np.int64)
    pay = np.zeros(nranks, np.int64)
    perm = []
    for s, d, g, t in items:
        assert len(g) == len(t)
        perm.append((s, d))
        gi[s, : len(g)] = g
        si[d, : len(t)] = t
        pay[s] = len(g)
    return CommRound(perm=tuple(perm), gather_idx=gi, scatter_idx=si,
                     payload=pay)


def build_plan(graph: CommGraph, topo: Topology, *,
               aggregate: bool | None = False,
               policy: str | None = None,
               elem_bytes: int = ELEM_BYTES) -> NeighborPlan:
    """Compile ``graph`` into a persistent plan on the unified IR.

    ``aggregate=None`` resolves the standard-vs-locality-aware choice
    through the selection policy ladder (``policy=None`` uses the
    process default; ``"tuned"`` reads ``tuner.autotune``'s persisted
    winner for this topology and exchange volume).
    """
    n = graph.nranks
    assert topo.nranks == n
    if aggregate is None:
        from repro_torch.core import selector
        mode = selector.resolve_neighbor_mode(
            graph, topo, policy=policy, elem_bytes=elem_bytes)
        if mode is None:
            return model_argmin_plan(graph, topo, elem_bytes=elem_bytes)
        aggregate = mode == "locality_aware"
    # final recv layout (identical across modes)
    recv_off = [0] * n
    recv_size = [graph.n_recv(r) for r in range(n)]
    seg_start: dict[tuple[int, int], int] = {}   # (src, dst) -> recv row
    stage_need = [0] * n

    if not aggregate or topo.npods == 1:
        buf0 = max(graph.local_sizes)
        for r in range(n):
            recv_off[r] = buf0
        for r in range(n):
            pos = recv_off[r]
            for s, idx in graph.recv_layout(r):
                seg_start[(s, r)] = pos
                pos += len(idx)
        edge_list = sorted(graph.edges)
        items_by_round = _edge_color(edge_list)
        rounds = []
        for edge_ids in items_by_round:
            items = []
            for i in edge_ids:
                s, d = edge_list[i]
                idx = graph.edges[(s, d)]
                tgt = seg_start[(s, d)] + np.arange(len(idx))
                items.append((s, d, idx.astype(np.int64), tgt))
            rounds.append(_mk_round(n, items))
        buf_rows = buf0 + max(recv_size, default=0)
        sched = CommSchedule(
            nranks=n, num_slots=buf_rows, rounds=tuple(rounds),
            name="neighbor.standard",
            out_slots=max(recv_size, default=0),
            out_offsets=np.asarray(recv_off, np.int64))
        return NeighborPlan(graph=graph, topo=topo, schedule=sched,
                            recv_offsets=tuple(recv_off),
                            recv_sizes=tuple(recv_size),
                            name="neighbor.standard")

    # ---------------- locality-aware aggregated (3 phases) ----------------
    R, Q = topo.ranks_per_pod, topo.npods

    def agg_out(p: int, q: int) -> int:
        """Aggregator in pod p for traffic headed to pod q (striped)."""
        return topo.rank(p, q % R)

    def agg_in(q: int, p: int) -> int:
        """Aggregator in pod q for traffic arriving from pod p."""
        return topo.rank(q, p % R)

    # unique values per (src rank, dst pod):  U[(s, q)] = sorted unique idx
    U: dict[tuple[int, int], np.ndarray] = {}
    for (s, d), idx in sorted(graph.edges.items()):
        q = topo.pod(d)
        if q == topo.pod(s):
            continue
        key = (s, q)
        U[key] = (np.unique(np.concatenate([U[key], idx]))
                  if key in U else np.unique(idx))

    # staging layout on each aggregator:
    #   out-stage: values collected from own pod (phase A lands here),
    #   in-stage:  values arrived over DCN (phase B lands here).
    # stage_pos[(owner_rank, src_rank, q_or_p, local_idx)] -> staging row
    out_stage_pos: dict[tuple[int, int, int], np.ndarray] = {}
    in_stage_pos: dict[tuple[int, int, int], np.ndarray] = {}
    for (s, q), uniq in sorted(U.items()):
        a = agg_out(topo.pod(s), q)
        base = max(graph.local_sizes) + stage_need[a]
        out_stage_pos[(a, s, q)] = base + np.arange(len(uniq))
        stage_need[a] += len(uniq)
    for (s, q), uniq in sorted(U.items()):
        b = agg_in(q, topo.pod(s))
        base = max(graph.local_sizes) + stage_need[b]
        in_stage_pos[(b, s, q)] = base + np.arange(len(uniq))
        stage_need[b] += len(uniq)

    buf0 = max(graph.local_sizes)
    stage_cap = max(stage_need, default=0)
    for r in range(n):
        recv_off[r] = buf0 + stage_cap
    for r in range(n):
        pos = recv_off[r]
        for s, idx in graph.recv_layout(r):
            seg_start[(s, r)] = pos
            pos += len(idx)

    # Phase A: src s -> aggregator a(pod(s), q), payload U[(s, q)].
    # When s is its own aggregator the staging rows are filled by folding
    # the copy into phase B's gather (gather directly from the value rows).
    phase_a_edges = []   # (s, a, gather_rows, scatter_rows)
    for (s, q), uniq in sorted(U.items()):
        a = agg_out(topo.pod(s), q)
        if a == s:
            continue
        phase_a_edges.append((s, a, uniq.astype(np.int64),
                              out_stage_pos[(a, s, q)]))
    # Phase B: a(p, q) -> agg_in(q, p); bundle = all (s in pod p) segments.
    phase_b_edges = []
    for p in range(Q):
        for q in range(Q):
            if p == q:
                continue
            a, b = agg_out(p, q), agg_in(q, p)
            g_rows, t_rows = [], []
            for s in topo.pod_ranks(p):
                if (s, q) not in U:
                    continue
                uniq = U[(s, q)]
                if s == a:   # folded local copy: gather from value rows
                    g_rows.append(uniq.astype(np.int64))
                else:
                    g_rows.append(out_stage_pos[(a, s, q)])
                t_rows.append(in_stage_pos[(b, s, q)])
            if not g_rows:
                continue
            phase_b_edges.append((a, b, np.concatenate(g_rows),
                                  np.concatenate(t_rows)))
    # Phase C: agg_in(q, p) -> each dst d in pod q: the (src s) segment
    # values d needs, gathered from in-stage rows (duplication on ICI).
    phase_c_edges = []
    for (s, d), idx in sorted(graph.edges.items()):
        q, p = topo.pod(d), topo.pod(s)
        if q == p:
            continue
        b = agg_in(q, p)
        uniq = U[(s, q)]
        lookup = {int(v): int(r) for v, r in
                  zip(uniq, in_stage_pos[(b, s, q)])}
        g = np.array([lookup[int(v)] for v in idx], np.int64)
        t = seg_start[(s, d)] + np.arange(len(idx))
        phase_c_edges.append((b, d, g, t))
    # intra-pod direct edges (any phase; run them with phase A coloring)
    for (s, d), idx in sorted(graph.edges.items()):
        if topo.pod(s) != topo.pod(d):
            continue
        t = seg_start[(s, d)] + np.arange(len(idx))
        phase_a_edges.append((s, d, idx.astype(np.int64), t))

    rounds: list[CommRound] = []
    for phase in (phase_a_edges, phase_b_edges, phase_c_edges):
        # split self-edges (local copies) from real messages
        msgs = [(s, d, g, t) for (s, d, g, t) in phase if s != d]
        selfs = [(s, d, g, t) for (s, d, g, t) in phase if s == d]
        colored = _edge_color([(s, d) for s, d, _, _ in msgs])
        for edge_ids in colored:
            rounds.append(_mk_round(n, [msgs[i] for i in edge_ids]))
        # Local copies cost nothing on the wire: one fused round of (r, r)
        # self-permutations (a rank's own payload, never on a link); merge multiple
        # self-edges per rank into a single gather/scatter row.
        if selfs:
            merged: dict[int, tuple[list, list]] = {}
            for s, _, g, t in selfs:
                merged.setdefault(s, ([], []))
                merged[s][0].append(g)
                merged[s][1].append(t)
            items = [(r, r, np.concatenate(gs), np.concatenate(ts))
                     for r, (gs, ts) in sorted(merged.items())]
            rounds.append(_mk_round(n, items))

    buf_rows = buf0 + stage_cap + max(recv_size, default=0)
    sched = CommSchedule(
        nranks=n, num_slots=buf_rows, rounds=tuple(rounds),
        name="neighbor.locality_aware",
        out_slots=max(recv_size, default=0),
        out_offsets=np.asarray(recv_off, np.int64))
    return NeighborPlan(graph=graph, topo=topo, schedule=sched,
                        recv_offsets=tuple(recv_off),
                        recv_sizes=tuple(recv_size),
                        name="neighbor.locality_aware")


def model_argmin_plan(graph: CommGraph, topo: Topology, *,
                      elem_bytes: int = ELEM_BYTES) -> NeighborPlan:
    """Model-policy fallback: build both modes once, keep the one with
    the lower alpha-beta time (the single implementation behind both
    ``build_plan(aggregate=None)`` and ``selector.select_neighbor``)."""
    plans = [build_plan(graph, topo, aggregate=agg,
                        elem_bytes=elem_bytes)
             for agg in (False, True)]   # standard first: wins ties
    return min(plans,
               key=lambda p: p.schedule.modeled_time(topo, elem_bytes))


# ---------------------------------------------------------------------------
# execution — thin wrappers over the shared transports
# ---------------------------------------------------------------------------


def run_sim(plan: NeighborPlan, values: Sequence[np.ndarray]) -> list[np.ndarray]:
    """numpy oracle executor: ``values[r]`` = rank r's [n_local_r, feat]
    send values; returns per-rank recv arrays [n_recv_r, feat].
    Delegates to the shared ``SimTransport``."""
    n = plan.graph.nranks
    feat = values[0].shape[1:]
    buf = np.zeros((n, plan.buf_rows) + feat, values[0].dtype)
    for r in range(n):
        buf[r, : values[r].shape[0]] = values[r]
    out = SimTransport(n, topo=plan.topo).run(plan.schedule, buf)
    return [out[r, plan.recv_offsets[r]: plan.recv_offsets[r]
                + plan.recv_sizes[r]] for r in range(n)]


def run_dist(plan: NeighborPlan, local_values: torch.Tensor, group=None,
             *, transport: str = "dist") -> torch.Tensor:
    """Group executor: called by every rank of ``group`` (a
    ``ProcessGroup``; ``None`` = the default group) with its own
    [n_local_max, feat] value rows; returns [n_recv_max, feat] (rows
    beyond this rank's recv_size are zeros).  ``transport="dist"`` runs
    one ``batch_isend_irecv`` per compiled round (``DistTransport``);
    ``"kernel"`` gathers the buffers and runs the whole schedule as one
    kernel (``KernelTransport``)."""
    import torch.distributed as dist

    from repro_torch.core.transport import DistTransport, KernelTransport

    if transport not in ("dist", "kernel"):
        raise ValueError(f"unknown transport {transport!r}; expected "
                         f"dist | kernel")
    n = plan.graph.nranks
    feat = tuple(local_values.shape[1:])
    buf = local_values.new_zeros((plan.buf_rows,) + feat)
    buf[: local_values.shape[0]] = local_values
    cls = KernelTransport if transport == "kernel" else DistTransport
    out = cls(n, group, topo=plan.topo).run(plan.schedule, buf)
    off = plan.recv_offsets[dist.get_rank(group)]
    return out[off: off + max(plan.recv_sizes)]
