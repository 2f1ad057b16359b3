"""Persistent-executor compilation of ``CommSchedule``s.

MPI Advance's core performance move is hoisting all collective setup
into one-time persistent initialization (MPI-4 persistent collectives)
so the steady-state path pays only for data movement.  The plan layer
already does the algorithmic half at build time; this module does the
*execution* half: a ``CommSchedule`` is lowered once to a
``CompiledExec`` and cached process-wide, so repeated execution —
training steps, tuner timing loops, bit-exactness sweeps — never
re-derives tables, re-uploads constants, or re-runs Python shape logic.

The compile pass (all steps skipped with ``optimize=False`` or
``REPRO_EXEC_OPTIMIZE=0``):

  1. **local_pre fold** — a bijective pre-permutation (Bruck rotation)
     is composed into every round's gather/scatter tables and into
     ``local_post``, eliding one whole-buffer gather per execution.
  2. **Round fusion** — each non-reduce round merges, whole, into the
     earliest earlier round where the ``schedule.can_fuse`` legality
     rule holds (disjoint src/dst sets, no scatter->gather aliasing
     across the gap) AND the padded message widths match (a
     profitability condition on top of legality: unequal widths would
     pad the narrower round's messages on the wire): one exchange round
     disappears per merge, a direct cut of the alpha term, and the
     merged round's max-priced time is ``max(a, b)`` — never slower
     under the alpha-beta model.  Reduce rounds are barriers —
     accumulation order is preserved bit-for-bit.
  3. **Topology-armed fusion + reordering** (only with a ``topo=``) —
     a second compaction over the already-fused rounds, armed with the
     alpha-beta ``Topology`` cost model.  Per-edge hazard lower bounds
     form the src/dst interference DAG; rounds are then greedily packed
     into earlier antichains (concurrent rounds priced by max link
     time) through two pointwise-cost-safe moves:
       * whole-round merge into ONE earlier round with *any* widths —
         the merged round carries ``payload`` so every edge keeps its
         pre-merge priced width, per-port times are unchanged, and the
         merged round costs ``max(a, b)`` at every message size;
       * all-or-nothing multi-target split: every edge of a round
         migrates to some earlier round — at most one target round (the
         primary) may raise its max, every other target must already
         hold an edge whose (alpha, priced-bytes*beta) dominates the
         arrival — so the total increase is bounded by the deleted
         round's time at every message size.
     Both moves are provably never slower than the topology-free pass
     for every slot size (not just the probed one); see _compact_armed.
  4. **Dead-slot elision** — message positions whose scatter target is
     ``-1`` (dropped on arrival) and edges that deliver nothing are
     removed from the execution tables (accounting still reads the
     original schedule).
  5. **Scratch-zero elision** — the per-round scratch-row re-zeroing of
     the historical lowering is dropped: every scratch read is masked,
     so the zeroing was dead work.
  6. **Baked tables + masks** — per-round index tables AND the
     gather/scatter masks (plus scratch-safe indices) are materialized
     once as numpy; the kernel transport packs them once more into
     int32 device tables (``core.kernel_lowering``).

Every transport routes through here (``transport.SimTransport``,
``DistTransport`` and ``KernelTransport`` are thin lookups).  The
executor cache is keyed by (schedule fingerprint, optimize flag,
validation flag, topology fingerprint) — per-geometry compilations
never collide.

``run_sim`` executes a numpy buffer of any dtype numpy holds; a torch
tensor runs through ``kernel_lowering.schedule_exec_plain`` instead.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.core.schedule import (CommRound, CommSchedule, ComputeEvent,  # noqa: F401 (can_fuse/ComputeEvent re-exported: executor is their consumer-facing home)
                                 can_fuse, can_split, split_round,
                                 validate_schedules_enabled)
from repro_torch.core.topology import Topology


def optimize_enabled() -> bool:
    """True unless ``REPRO_EXEC_OPTIMIZE`` disables the peephole passes
    (escape hatch; the unoptimized executor mirrors the historical
    round-by-round lowering and is the fused path's reference)."""
    v = os.environ.get("REPRO_EXEC_OPTIMIZE", "1").strip().lower()
    return v not in ("", "0", "false", "off", "no")


# ---------------------------------------------------------------------------
# edge extraction + compaction (the fusion pass)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Edge:
    """One (src -> dst) message: aligned gather/scatter position vectors
    (position j of the wire payload reads ``gather[j]`` on src and lands
    at ``scatter[j]`` on dst; -1 gathers send zeros).

    ``price_slots`` is the slot count the alpha-beta model charges this
    edge in its *source* round (the round's padded width for dense
    block tables, the per-source ``payload`` count for ragged rounds)
    — the topology-armed pass must preserve it through merges so
    per-port times never move.

    ``orig`` is the index of the *original* (pre-compaction) round the
    edge came from; buckets carry the min over their members so the
    makespan pass can resolve ``ComputeEvent.after_round`` anchors —
    compaction only moves edges earlier, so every final round holding
    content from original rounds <= i has ``min(orig) <= i``."""

    src: int
    dst: int
    gather: np.ndarray           # int, [k_e]
    scatter: np.ndarray          # int, [k_e]; all >= 0 after compression
    has_payload: bool
    price_slots: int = 0
    orig: int = 0

    @property
    def reads(self) -> set:
        return set(int(b) for b in self.gather[self.gather >= 0])

    @property
    def writes(self) -> set:
        return set(int(b) for b in self.scatter[self.scatter >= 0])


def _round_edges(rnd: CommRound, compress: bool, orig: int = 0
                 ) -> list[_Edge]:
    out = []
    for s, d in rnd.perm:
        g = np.asarray(rnd.gather_idx[s], np.int64)
        t = np.asarray(rnd.scatter_idx[d], np.int64)
        if compress:
            keep = t >= 0            # dropped-on-arrival slots are dead
            g, t = g[keep], t[keep]
            if not len(t):           # message delivers nothing: elide
                continue
        if rnd.payload is not None:
            # trimming can only drop dead (dropped-on-arrival) wire
            # slots, so the priced count never grows past the original
            price = min(int(rnd.payload[s]), int((g >= 0).sum()))
        else:
            # dense block tables: the model charges every edge the
            # round's full padded width (padding ships zeros)
            price = rnd.k
        out.append(_Edge(int(s), int(d), g, t,
                         rnd.payload is not None, price, orig))
    return out


class _Bucket:
    """One output round under construction: matching + dataflow state."""

    def __init__(self, reduce: bool):
        self.reduce = reduce
        self.edges: list[_Edge] = []
        self.srcs: set[int] = set()
        self.dsts: set[int] = set()
        self.reads: dict[int, set] = {}    # rank -> rows gathered
        self.writes: dict[int, set] = {}   # rank -> rows scattered

    def add(self, e: _Edge) -> None:
        self.edges.append(e)
        self.srcs.add(e.src)
        self.dsts.add(e.dst)
        self.reads.setdefault(e.src, set()).update(e.reads)
        self.writes.setdefault(e.dst, set()).update(e.writes)

    def remove(self, e: _Edge) -> None:
        """Roll back a tentative placement.  Exact because the matching
        invariant makes e the only edge with src ``e.src`` (sole
        contributor to ``reads[e.src]``) and dst ``e.dst`` (sole
        contributor to ``writes[e.dst]``) in this bucket."""
        self.edges.remove(e)
        self.srcs.discard(e.src)
        self.dsts.discard(e.dst)
        self.reads.pop(e.src, None)
        self.writes.pop(e.dst, None)


def _edge_lo(buckets: list[_Bucket], barrier: int, base_i: int,
             e: _Edge) -> int:
    """Earliest bucket in ``[0, base_i)`` that edge ``e`` may legally
    join — the per-edge hazard lower bound both compaction passes share
    (their union over a round's edges is the src/dst interference DAG):

      * RAW / WAW — a bucket writing rows ``e`` gathers, or rows ``e``
        scatters (``e``'s writes must still land last), forces strictly
        later placement;
      * WAR — a bucket gathering rows ``e`` scatters allows same-round
        placement (fused rounds gather before they scatter);
      * ``barrier`` — nothing crosses the latest reduce round.
    """
    lo = barrier
    for bi in range(base_i):
        b = buckets[bi]
        if (b.writes.get(e.src, _EMPTY) & e.reads
                or b.writes.get(e.dst, _EMPTY) & e.writes):
            lo = max(lo, bi + 1)          # RAW / WAW
        elif b.reads.get(e.dst, _EMPTY) & e.writes:
            lo = max(lo, bi)              # WAR (same-round ok)
    return lo


def _compact(rounds: tuple[CommRound, ...], compress: bool
             ) -> tuple[list[_Bucket], int]:
    """Fuse whole rounds into earlier ones (the fusion pass).

    Each non-reduce round merges — whole, into ONE earlier round —
    when the ``can_fuse`` legality rule holds against that target and
    no intermediate round creates a data hazard.  Whole-round
    single-target merging is the shape that is *provably cost-safe*
    without a topology: src/dst sets stay disjoint, so the merged
    round's per-port costs are the union of the two rounds' and its
    max-priced time is ``max(a, b) <= a + b`` — one alpha strictly
    saved, no beta added.  (Per-edge redistribution was measurably
    harmful: splitting edges that overlapped in one round across
    several can raise several rounds' maxima; an early draft did this
    and regressed real neighbor plans by >25% modeled time.)  Equal
    message width is also required — merging a k=1 round into a k=4
    round would pad the k=1 messages to 4 slots on the wire.

    Legality of merging round j into candidate c (``schedule.can_fuse``
    plus the non-adjacency condition):
      * neither round reduces; reduce rounds are barriers (float
        accumulation order is preserved bit-for-bit);
      * matching — no rank may send or receive in both rounds;
      * RAW/WAW — no round in [c, j) writes rows that j's edges gather,
        and no round in [c, j) writes rows that j's edges scatter
        (j's writes must still land last);
      * WAR — rounds in (c, j) must not gather rows j's edges scatter
        (round c itself may: fused rounds gather before scattering);
      * equal padded width k.
    Returns (buckets, count of edges in fused rounds).
    """
    buckets: list[_Bucket] = []
    barrier = 0
    migrated = 0
    for orig, rnd in enumerate(rounds):
        edges = _round_edges(rnd, compress, orig)
        base = _Bucket(rnd.reduce)
        buckets.append(base)
        for e in edges:
            base.add(e)
        if rnd.reduce:
            barrier = len(buckets)
            continue
        if not edges:
            continue
        base_i = len(buckets) - 1
        # hazard lower bound: the earliest round this whole round may
        # merge into without reordering a read/write pair
        lo = max(_edge_lo(buckets, barrier, base_i, e) for e in edges)
        width = max(len(e.gather) for e in edges)
        for bi in range(lo, base_i):
            b = buckets[bi]
            if b.reduce or not b.edges:
                continue
            if max(len(e.gather) for e in b.edges) != width:
                continue
            if any(e.src in b.srcs or e.dst in b.dsts for e in edges):
                continue
            for e in edges:                        # commit the merge
                base.remove(e)
                b.add(e)
            migrated += len(edges)
            break
    return [b for b in buckets if b.edges], migrated


_EMPTY: frozenset = frozenset()


# ---------------------------------------------------------------------------
# topology-armed compaction (multi-target fusion + antichain packing)
# ---------------------------------------------------------------------------


_REF_SLOT_BYTES = 1024.0     # nominal slot size for greedy *ordering* only
                             # (acceptance tests below are size-independent)


def _edge_link(topo: Topology, e: _Edge):
    """Link model of the edge's wire hop; None for free on-chip copies."""
    return None if e.src == e.dst else topo.link(e.src, e.dst)


def _edge_nominal_time(topo: Topology, e: _Edge) -> float:
    lm = _edge_link(topo, e)
    return 0.0 if lm is None else lm.time(e.price_slots * _REF_SLOT_BYTES)


def _has_dominator(topo: Topology, bucket: _Bucket, e: _Edge) -> bool:
    """True when some edge already in ``bucket`` upper-bounds ``e``'s
    link time at EVERY slot size: alpha_f >= alpha_e and
    slots_f*beta_f >= slots_e*beta_e.  Then max-pricing cannot move, so
    landing ``e`` there is free regardless of message size."""
    lm_e = _edge_link(topo, e)
    if lm_e is None:
        return True                      # on-chip copy: costs nothing
    load_e = e.price_slots * lm_e.beta
    for f in bucket.edges:
        lm_f = _edge_link(topo, f)
        if lm_f is None:
            continue
        if lm_f.alpha >= lm_e.alpha and f.price_slots * lm_f.beta >= load_e:
            return True
    return False


def _intra_round_hazard(edges: list[_Edge]) -> bool:
    """True when one edge of a round scatters rows another edge of the
    SAME round gathers (on one rank).  In-round semantics read pre-round
    state, so such edges may only ever execute concurrently — splitting
    them across different rounds would reorder the write before the
    read.  Rounds with this shape are merge-whole-or-stay."""
    for e1 in edges:
        for e2 in edges:
            if e1 is not e2 and e1.dst == e2.src and e1.writes & e2.reads:
                return True
    return False


def _bucket_orig_lo(bucket: _Bucket) -> int:
    """Earliest original-round index whose content this bucket holds
    (min composes through stacked passes: pass 2 consumes pass 1's
    rebuilt rounds with their per-round ``orig_lo`` fed back in)."""
    return min((e.orig for e in bucket.edges), default=0)


def _compact_armed(rounds: tuple[CommRound, ...], topo: Topology,
                   compress: bool, origs: tuple[int, ...] | None = None
                   ) -> tuple[list[_Bucket], int, int]:
    """Cost-model-armed compaction (run AFTER the topology-free pass).

    The per-edge hazard lower bounds below are exactly the src/dst
    interference DAG of ``can_fuse``-style legality (reduce rounds are
    barriers; RAW/WAW force strictly-later placement; WAR allows
    same-round placement because fused rounds gather before they
    scatter).  Rounds are processed in order and greedily packed into
    the earliest legal antichain — an existing concurrent round priced
    by the max over its links — via two moves, each *pointwise*
    cost-safe (no slower at ANY slot size, not merely at a probe size;
    this is what makes running the armed pass on top of the topology-
    free pass provably never worse than that pass):

      * **whole-round merge** (subsumes the equal-width single-target
        rule): all edges of round j land in one earlier bucket c.
        Legality makes src/dst sets disjoint, and every rank sends at
        most once per round, so each (src, level) injection port
        carries exactly one message — ports of c and j never collide
        and the merged round's time is max(c, j) <= c + j for every
        slot size.  Unequal widths are priced exactly by carrying each
        edge's original width through ``payload`` (see _rebuild_round).
      * **all-or-nothing multi-target split**: every edge of round j
        migrates to SOME earlier bucket; at most one receiving bucket
        (the primary) may raise its max — its increase is bounded by
        round j's own time — and every other receiving bucket must
        already hold a dominating edge (``_has_dominator``), leaving
        its max untouched at every size.  Deleting round j then pays
        for the primary's bounded increase: total time never rises.
        Partial migrations are rolled back whole (the PR 4 lesson:
        redistributing edges without deleting a round only inflates
        other rounds' maxima).

    Returns (buckets, whole-round merges, edges moved by splits).
    """
    buckets: list[_Bucket] = []
    barrier = 0
    merged_rounds = 0
    split_edges = 0
    for i, rnd in enumerate(rounds):
        edges = _round_edges(rnd, compress,
                             i if origs is None else origs[i])
        base = _Bucket(rnd.reduce)
        buckets.append(base)
        for e in edges:
            base.add(e)
        if rnd.reduce:
            barrier = len(buckets)
            continue
        if not edges:
            continue
        base_i = len(buckets) - 1
        # -- move 1: whole-round merge, any widths ----------------------
        lo_all = max(_edge_lo(buckets, barrier, base_i, e) for e in edges)
        merged = False
        for bi in range(lo_all, base_i):
            b = buckets[bi]
            if b.reduce or not b.edges:
                continue
            if any(e.src in b.srcs or e.dst in b.dsts for e in edges):
                continue
            for e in edges:
                base.remove(e)
                b.add(e)
            merged_rounds += 1
            merged = True
            break
        if merged:
            continue
        # -- move 2: all-or-nothing multi-target split ------------------
        if len(edges) < 2 or _intra_round_hazard(edges):
            continue
        placed: list[tuple[_Edge, _Bucket]] = []
        primary: _Bucket | None = None
        ok = True
        # heaviest edges first: the critical edge claims the primary
        # slot, lighter edges then only need dominated (free) homes
        for e in sorted(edges, key=lambda e: -_edge_nominal_time(topo, e)):
            # recomputed per edge: siblings already placed count
            lo = _edge_lo(buckets, barrier, base_i, e)
            home = None
            fallback = None
            for bi in range(lo, base_i):
                b = buckets[bi]
                if b.reduce or not b.edges:
                    continue
                if e.src in b.srcs or e.dst in b.dsts:
                    continue
                if b is primary or _has_dominator(topo, b, e):
                    home = b
                    break
                if fallback is None:
                    fallback = b
            if home is None and primary is None and fallback is not None:
                home = primary = fallback
            if home is None:
                ok = False
                break
            base.remove(e)
            home.add(e)
            placed.append((e, home))
        if ok:
            split_edges += len(placed)
        else:                              # roll the whole round back
            for e, b in placed:
                b.remove(e)
                base.add(e)
    return [b for b in buckets if b.edges], merged_rounds, split_edges


def _rebuild_round(bucket: _Bucket, nranks: int, *,
                   priced: bool = False) -> CommRound:
    """Materialize a bucket as a CommRound.

    With ``priced=True`` (the topology-armed pass) a round whose edges
    carry unequal priced widths gets a ``payload`` so ``modeled_time``
    keeps charging every edge its pre-merge width — unequal-width
    merges must not let padding reprice (or silently discount) edges.
    """
    k = max((len(e.gather) for e in bucket.edges), default=0)
    k = max(k, 1)
    gi = np.full((nranks, k), -1, np.int64)
    si = np.full((nranks, k), -1, np.int64)
    perm = []
    payload = None
    if any(e.has_payload for e in bucket.edges) or (
            priced and any(e.price_slots != k for e in bucket.edges)):
        payload = np.zeros(nranks, np.int64)
    for e in bucket.edges:
        perm.append((e.src, e.dst))
        gi[e.src, : len(e.gather)] = e.gather
        si[e.dst, : len(e.scatter)] = e.scatter
        if payload is not None:
            # priced (armed) rebuilds carry each edge's pre-merge width
            # verbatim; the historical rebuild recomputes the live
            # count but clamps by the original priced width — a fuzzed
            # round whose payload undercuts its live gather count must
            # not get silently repriced upward
            payload[e.src] = (e.price_slots if priced
                              else min(e.price_slots,
                                       int((e.gather >= 0).sum())))
    return CommRound(perm=tuple(perm), gather_idx=gi, scatter_idx=si,
                     reduce=bucket.reduce, payload=payload)


# ---------------------------------------------------------------------------
# makespan model + pipelined pass (pass 3; pricing/planning only)
# ---------------------------------------------------------------------------


_PIPELINE_PROBE_BYTES = (1.0, 4096.0, float(1 << 20))
# alpha-, mixed-, beta-dominated probe sizes for the tail-split rollback
# check (same values the conformance fuzzer probes); the packing moves
# themselves are size-independent, only the split needs the probes as
# defense in depth on top of the per-port alpha precondition.


def _round_level_times(topo: Topology, rnd: CommRound,
                       slot_nbytes: float) -> dict[int, float]:
    """Per-topology-level occupancy of one round: the same per-(src,
    level) injection-port accounting as ``Topology.round_time`` but
    grouped by level instead of collapsed to one max — the channels of
    the makespan model.  ``max(out.values())`` equals ``round_time``
    exactly, so singleton groups reproduce the serial model."""
    if rnd.payload is None:
        per_edge = [float(rnd.k) * slot_nbytes] * len(rnd.perm)
    else:
        per_edge = [rnd.edge_slots(s) * slot_nbytes for s, _ in rnd.perm]
    per_port: dict[tuple[int, int], tuple[int, float]] = {}
    for (s, d), b in zip(rnd.perm, per_edge):
        if s == d:
            continue
        key = (s, topo.link_level(s, d))
        n, tot = per_port.get(key, (0, 0.0))
        per_port[key] = (n + 1, tot + b)
    out: dict[int, float] = {}
    for (s, lvl), (n, tot) in per_port.items():
        t = topo.levels[lvl].link.time(tot, nmsgs=n)
        if t > out.get(lvl, 0.0):
            out[lvl] = t
    return out


def _round_chans(topo: Topology, rnd: CommRound) -> frozenset[int]:
    """Topology levels (channels) a round occupies — size-independent."""
    return frozenset(topo.link_level(s, d)
                     for s, d in rnd.perm if s != d)


def _rounds_commute(a: CommRound, b: CommRound) -> bool:
    """True when executing a and b in either order (or concurrently)
    is bit-identical: neither reduces and no rank sees a RAW, WAR, or
    WAW pair between them.  The makespan packer may co-schedule only
    commuting rounds (events never constrain rounds: they are pure
    readers of a buffer snapshot)."""
    if a.reduce or b.reduce:
        return False
    for r in (a.src_set | a.dst_set) & (b.src_set | b.dst_set):
        if a.writes(r) & (b.reads(r) | b.writes(r)):
            return False
        if a.reads(r) & b.writes(r):
            return False
    return True


# a _pack item is ("r", CommRound) or ("e", seconds, dep_item_index);
# an event's dep is the item index of the round it waits on (-1 = none).


def _pack(items: list[tuple], topo: Topology) -> list[list[tuple]]:
    """Greedy makespan packing: assign items, in order, to concurrency
    groups.  A group runs its members concurrently across channels
    (topology levels + one compute channel) and groups serialize, so

        makespan = sum over groups of
                   max(sum of member event seconds,
                       max over levels of sum of member round times).

    Every placement is *pointwise* cost-safe by construction: a group's
    duration is ``max_c sum d_(j,c) <= sum_j max_c d_(j,c)``, so any
    legal packing's makespan is <= the serial sum (armed modeled_time +
    total event seconds) at every slot size.  Placement rules:

      * a round lands in the earliest group after every round it does
        not commute with (and after the latest reduce barrier), and
        only joins a group whose rounds occupy disjoint channels — the
        DCN/ICI interleave; channel overlap would serialize inside the
        group's sum and hide real occupancy, so it opens a new group;
      * a reduce round is a barrier: its own group, nothing crosses;
      * an event lands in the earliest group strictly after its dep
        round's group (events on one consumer core serialize by
        summing inside a group — co-resident rounds still overlap).
    """
    groups: list[list[tuple]] = []
    chans: list[set[int]] = []          # per group: levels occupied
    has_reduce: list[bool] = []
    group_of: dict[int, int] = {}
    barrier = 0
    for j, it in enumerate(items):
        if it[0] == "r":
            rnd = it[1]
            lo = barrier
            for i in range(j):
                if (items[i][0] == "r"
                        and not _rounds_commute(items[i][1], rnd)):
                    lo = max(lo, group_of[i] + 1)
            if rnd.reduce:
                group_of[j] = len(groups)
                groups.append([it])
                chans.append(set(_round_chans(topo, rnd)))
                has_reduce.append(True)
                barrier = len(groups)
                continue
            rc = _round_chans(topo, rnd)
            g = None
            for gi in range(lo, len(groups)):
                if not has_reduce[gi] and not (chans[gi] & rc):
                    g = gi
                    break
            if g is None:
                g = len(groups)
                groups.append([])
                chans.append(set())
                has_reduce.append(False)
            groups[g].append(it)
            chans[g] |= rc
            group_of[j] = g
        else:
            dep = it[2]
            lo = barrier
            if dep >= 0:
                lo = max(lo, group_of[dep] + 1)
            if lo >= len(groups):
                groups.append([])
                chans.append(set())
                has_reduce.append(False)
            group_of[j] = lo
            groups[lo].append(it)
    return groups


def _groups_makespan(groups: list[list[tuple]], topo: Topology,
                     slot_nbytes: float) -> float:
    total = 0.0
    for grp in groups:
        per_lvl: dict[int, float] = {}
        ev_s = 0.0
        for it in grp:
            if it[0] == "r":
                for lvl, t in _round_level_times(topo, it[1],
                                                 slot_nbytes).items():
                    per_lvl[lvl] = per_lvl.get(lvl, 0.0) + t
            else:
                ev_s += it[1]
        total += max([ev_s] + list(per_lvl.values()))
    return total


# ---------------------------------------------------------------------------
# local_pre fold
# ---------------------------------------------------------------------------


def _bijective_rows(table: np.ndarray, num_slots: int) -> bool:
    if table.shape[1] != num_slots:
        return False
    want = np.arange(num_slots)
    return all(np.array_equal(np.sort(table[r]), want)
               for r in range(table.shape[0]))


def _fold_pre(schedule: CommSchedule):
    """Compose a bijective ``local_pre`` into every round table and the
    final ``local_post`` (relabel-through): logical slot ``i`` of the
    pre-permuted buffer lives at physical slot ``pre[r, i]``, so every
    index is rewritten through ``pre`` and the pre-gather disappears.
    Returns (rounds, local_post, folded?)."""
    pre = schedule.local_pre
    if pre is None or not _bijective_rows(np.asarray(pre),
                                          schedule.num_slots):
        return schedule.rounds, schedule.local_post, False
    pre = np.asarray(pre, np.int64)
    rounds = []
    for rnd in schedule.rounds:
        gi = rnd.gather_idx.copy().astype(np.int64)
        si = rnd.scatter_idx.copy().astype(np.int64)
        for r in range(schedule.nranks):
            gmask = gi[r] >= 0
            gi[r, gmask] = pre[r, gi[r, gmask]]
            smask = si[r] >= 0
            si[r, smask] = pre[r, si[r, smask]]
        rounds.append(CommRound(perm=rnd.perm, gather_idx=gi,
                                scatter_idx=si, reduce=rnd.reduce,
                                payload=rnd.payload))
    if schedule.local_post is None:
        post = pre
    else:
        old = np.asarray(schedule.local_post, np.int64)
        post = np.stack([pre[r, old[r]]
                         for r in range(schedule.nranks)])
    return tuple(rounds), post, True


# ---------------------------------------------------------------------------
# the compiled executor
# ---------------------------------------------------------------------------


class _ExecRound:
    """One compiled round: full per-rank tables (point-to-point) plus dense
    per-edge tables (vectorized simulator), baked once."""

    def __init__(self, rnd: CommRound, num_slots: int):
        self.perm = rnd.perm
        self.reduce = rnd.reduce
        self.k = rnd.k
        self.num_slots = num_slots
        self.gather_idx = np.asarray(rnd.gather_idx, np.int32)
        self.scatter_idx = np.asarray(rnd.scatter_idx, np.int32)
        # vectorized-sim tables: one fancy-indexed gather/permute/scatter
        # per round; -1 entries are routed via the scratch row num_slots.
        self.src = np.asarray([s for s, _ in rnd.perm], np.int64)
        self.dst = np.asarray([d for _, d in rnd.perm], np.int64)
        g = self.gather_idx[self.src].astype(np.int64)      # [m, k]
        t = self.scatter_idx[self.dst].astype(np.int64)
        self.g_mask = g >= 0
        self.t_mask = t >= 0
        self.g_safe = np.where(self.g_mask, g, num_slots)
        self.t_safe = np.where(self.t_mask, t, num_slots)
        # duplicate live targets on one rank (only possible with schedule
        # validation off) force unbuffered accumulation for reduce rounds
        self.dup_targets = rnd.reduce and any(
            len(np.unique(row[m])) != int(m.sum())
            for row, m in zip(t, self.t_mask))
        # rank -> index of the edge it sends / receives on (-1: none);
        # the point-to-point transport looks its own edges up here
        n = self.gather_idx.shape[0]
        self.send_edge = np.full(n, -1, np.int64)
        self.recv_edge = np.full(n, -1, np.int64)
        self.send_edge[self.src] = np.arange(len(self.src))
        self.recv_edge[self.dst] = np.arange(len(self.dst))


class CompiledExec:
    """A ``CommSchedule`` lowered for repeated execution.

    With a ``topo`` the compile pass is *armed* with the alpha-beta
    cost model: after the topology-free fusion, ``_compact_armed``
    multi-target-fuses and reorders the surviving rounds (each move
    pointwise cost-safe, so the armed result is never slower than the
    topology-free pass at any message size — the topology-free result
    is the armed pass's input and its fallback: when no armed move
    applies, the rounds pass through bit-identical).

    ``run_sim`` is the simulator's steady-state entry point; the
    point-to-point and kernel transports execute the *same* compiled
    rounds (``_rounds``), so the bit-exactness contract between the
    transports is preserved by construction.  ``sim_runs`` counts
    simulator executions.
    """

    def __init__(self, schedule: CommSchedule, optimize: bool,
                 topo: Topology | None = None):
        self.schedule = schedule
        self.optimize = optimize
        self.topo = topo
        self.nranks = schedule.nranks
        self.num_slots = schedule.num_slots
        self.rounds_before = schedule.num_rounds
        self.sim_runs = 0
        self.armed_merged_rounds = 0
        self.armed_split_edges = 0
        if optimize:
            rounds, post, self.pre_folded = _fold_pre(schedule)
            folded = CommSchedule(
                nranks=schedule.nranks, num_slots=schedule.num_slots,
                rounds=rounds, name=schedule.name,
                slot_bytes=schedule.slot_bytes,
                local_pre=None if self.pre_folded else schedule.local_pre,
                local_post=post, out_slots=schedule.out_slots,
                out_offsets=schedule.out_offsets)
            buckets, self.migrated_edges = _compact(folded.rounds,
                                                    compress=True)
            compiled_rounds = tuple(_rebuild_round(b, self.nranks)
                                    for b in buckets)
            self.rounds_after_unarmed = len(compiled_rounds)
            origs = tuple(_bucket_orig_lo(b) for b in buckets)
            if topo is not None:
                # armed pass runs ON the topology-free output, so every
                # pointwise-safe move keeps it <= that pass, which is
                # itself <= the unoptimized schedule
                (abuckets, self.armed_merged_rounds,
                 self.armed_split_edges) = _compact_armed(
                     compiled_rounds, topo, compress=True, origs=origs)
                compiled_rounds = tuple(
                    _rebuild_round(b, self.nranks, priced=True)
                    for b in abuckets)
                origs = tuple(_bucket_orig_lo(b) for b in abuckets)
            self._origs = origs
            self.local_pre = folded.local_pre
            self.local_post = post
        else:
            self.pre_folded = False
            self.migrated_edges = 0
            compiled_rounds = schedule.rounds
            self.rounds_after_unarmed = len(compiled_rounds)
            self._origs = tuple(range(len(compiled_rounds)))
            self.local_pre = schedule.local_pre
            self.local_post = schedule.local_post
        self.compiled_schedule = CommSchedule(
            nranks=schedule.nranks, num_slots=schedule.num_slots,
            rounds=compiled_rounds,
            name=schedule.name + ("+fused" if optimize else "+compiled"),
            slot_bytes=schedule.slot_bytes, local_pre=self.local_pre,
            local_post=self.local_post, out_slots=schedule.out_slots,
            out_offsets=schedule.out_offsets)
        self.rounds_after = len(compiled_rounds)
        self._rounds = tuple(_ExecRound(r, self.num_slots)
                             for r in compiled_rounds)
        # pass 3: makespan planning (pricing only; never touches the
        # executed rounds, so every modeled_time/bit-exactness contract
        # above is untouched by construction)
        self._groups: list[list[tuple]] | None = None
        self.pipelined_schedule: CommSchedule | None = None
        self.pipeline_tail_parts = 0
        if optimize and topo is not None:
            self._build_pipeline(compiled_rounds)
        self._pre = (None if self.local_pre is None
                     else np.asarray(self.local_pre, np.int64))
        self._post = (None if self.local_post is None
                      else np.asarray(self.local_post, np.int64))

    # -- pass 3: makespan planning + tail-chunk pipelining ----------------
    def _event_deps(self, nrounds: int) -> list[int]:
        """Resolve each ComputeEvent's ``after_round`` anchor (an index
        into the ORIGINAL schedule) onto the compiled rounds: the event
        depends on the LAST compiled round holding content from original
        rounds <= anchor.  Compaction only moves edges earlier and
        buckets carry ``min(orig)``, so ``origs[f] <= anchor`` holds
        exactly for the compiled prefix the anchor's data lives in."""
        deps = []
        for ev in self.schedule.compute_events:
            a = (ev.after_round if ev.after_round >= 0
                 else self.rounds_before - 1)
            dep = -1
            for f in range(nrounds):
                if self._origs[f] <= a:
                    dep = f
            deps.append(dep)
        return deps

    def _build_pipeline(self, compiled_rounds: tuple[CommRound, ...]):
        """The pipelined pass: pack the armed rounds + registered
        compute events into a makespan plan, then try ONE structural
        move — split the tail round into chunks so slices of a
        splittable tail event overlap chunk transfers (the MPIPCL
        partitioned-communication shape).  The split commits only when
        (a) ``can_split`` legality holds, (b) every injection port's
        alpha is <= the per-slice compute (the size-independent
        pointwise-safety precondition: extra alphas hide behind
        compute), and (c) the packed makespan is no worse at every
        probe size — whole-move rollback otherwise (the PR 4 lesson)."""
        events = self.schedule.compute_events
        topo = self.topo
        R = len(compiled_rounds)
        deps = self._event_deps(R)
        base_items: list[tuple] = [("r", r) for r in compiled_rounds]
        for ev, dep in zip(events, deps):
            base_items.append(("e", float(ev.seconds), dep))
        groups = _pack(base_items, topo)
        self._groups = groups
        if R == 0:
            return
        # tail-split candidate: first splittable event anchored on the
        # final compiled round with real compute behind it
        cand = next((i for i, (ev, dep) in enumerate(zip(events, deps))
                     if ev.splittable and dep == R - 1
                     and ev.seconds > 0.0), None)
        if cand is None:
            return
        ev = events[cand]
        tail = compiled_rounds[-1]
        pref = [ev.parts] if ev.parts >= 2 else []
        parts = None
        for p in pref + [8, 4, 2]:
            if not can_split(tail, p):
                continue
            slice_s = ev.seconds / p
            ports = {(s, topo.link_level(s, d))
                     for s, d in tail.perm if s != d}
            if all(topo.levels[lvl].link.alpha <= slice_s
                   for _, lvl in ports):
                parts = p
                break
        if parts is None:
            return
        chunks = split_round(tail, parts)
        split_items: list[tuple] = [("r", r)
                                    for r in compiled_rounds[:-1]]
        c0 = len(split_items)
        split_items.extend(("r", c) for c in chunks)
        for i, (e2, dep) in enumerate(zip(events, deps)):
            if i == cand:
                split_items.extend(
                    ("e", e2.seconds / parts, c0 + ci)
                    for ci in range(parts))
            else:
                d2 = dep if dep < R - 1 else c0 + parts - 1
                split_items.append(("e", float(e2.seconds), d2))
        sgroups = _pack(split_items, topo)
        for s in _PIPELINE_PROBE_BYTES:
            if (_groups_makespan(sgroups, topo, s)
                    > _groups_makespan(groups, topo, s) * (1 + 1e-9)):
                return                     # whole-move rollback
        self._groups = sgroups
        self.pipeline_tail_parts = parts
        # execution artifact: chunks run sequentially, which is
        # bit-identical to the unsplit round (can_split forbids
        # chunk-crossing RAW; live scatter targets are distinct, so
        # chunk writes are disjoint).  Events are model-only and their
        # anchors index the original rounds, so they are dropped here.
        self.pipelined_schedule = CommSchedule(
            nranks=self.nranks, num_slots=self.num_slots,
            rounds=compiled_rounds[:-1] + chunks,
            name=self.schedule.name + "+pipelined",
            slot_bytes=self.schedule.slot_bytes,
            local_pre=self.local_pre, local_post=self.local_post,
            out_slots=self.schedule.out_slots,
            out_offsets=self.schedule.out_offsets)

    def makespan(self, slot_nbytes: float) -> float:
        """Modeled completion time of the packed plan (pass 3): groups
        serialize, members of a group overlap across channels (topology
        levels + the consumer-compute channel).  Pointwise <= the armed
        serial ``modeled_time`` plus total registered event seconds, at
        every slot size — the pipelined arm of the guideline chain."""
        if self._groups is None:
            raise RuntimeError(
                "makespan requires a topology-armed optimized executor "
                "(compile with optimize=True and a topo)")
        return _groups_makespan(self._groups, self.topo, slot_nbytes)

    def chunked_makespan(self, slot_nbytes: float, parts: int,
                         compute_s: float) -> float:
        """Software-pipeline model of ROW-chunked execution — the shape
        ``transport.run_chunked`` + a ``consume`` callback lowers to
        (MPIPCL partitioned communication over the row axis): the whole
        compiled schedule runs once per chunk at ``1/parts`` of the
        bytes, and chunk ``i``'s transfer overlaps chunk ``i-1``'s
        consumer compute.  Complements ``makespan`` (slot-granularity
        tail splitting): row chunking applies to ANY schedule, including
        k=1 rounds the IR-level ``split_round`` must refuse.  Callers
        (the tuner) must compare against ``parts=1`` and keep the min —
        per-chunk alphas are not free and small messages lose."""
        if self._groups is None:
            raise RuntimeError(
                "chunked_makespan requires a topology-armed optimized "
                "executor (compile with optimize=True and a topo)")
        serial = self.compiled_schedule.modeled_time(self.topo,
                                                     slot_nbytes)
        if parts <= 1:
            return serial + compute_s
        c = self.compiled_schedule.modeled_time(
            self.topo, slot_nbytes / float(parts))
        e = compute_s / float(parts)
        return c + (parts - 1) * max(c, e) + e

    # -- simulator backend (vectorized; no per-rank/per-slot Python loops)
    def run_sim(self, buf):
        """Execute the compiled rounds on a numpy global buffer
        [nranks, num_slots, *slot]."""
        self.sim_runs += 1
        n = self.nranks
        assert buf.shape[0] == n and buf.shape[1] == self.num_slots, (
            buf.shape, n, self.num_slots)
        rows = np.arange(n)[:, None]
        if self._pre is not None:
            buf = buf[rows, self._pre]
        # one scratch row per rank absorbs -1 routes
        work = np.concatenate(
            [buf, np.zeros((n, 1) + buf.shape[2:], buf.dtype)], axis=1)
        # masking is done with in-place boolean assignment, NOT np.where
        # (np.where with an extension-dtype array and a python scalar is
        # unsafe on numpy 2.0.x)
        for rnd in self._rounds:
            payload = work[rnd.src[:, None], rnd.g_safe]     # [m, k, ...]
            payload[~rnd.g_mask] = 0
            if rnd.reduce:
                # live targets are distinct per dst (schedule invariant),
                # so buffered fancy-index accumulation is exact; -1 slots
                # collapse onto the scratch row, which is never read
                payload[~rnd.t_mask] = 0
                idx = (rnd.dst[:, None], rnd.t_safe)
                if rnd.dup_targets:
                    np.add.at(work, idx, payload)
                else:
                    work[idx] = work[idx] + payload
            else:
                work[rnd.dst[:, None], rnd.t_safe] = payload
        out = work[:, : self.num_slots]
        if self._post is not None:
            out = out[rows, self._post]
        return np.ascontiguousarray(out)

    # -- reporting --------------------------------------------------------
    def stats(self) -> dict:
        return {
            "name": self.schedule.name,
            "fingerprint": self.schedule.fingerprint(),
            "optimize": self.optimize,
            "topology": (None if self.topo is None
                         else self.topo.fingerprint()),
            "rounds_before": self.rounds_before,
            "rounds_after_unarmed": self.rounds_after_unarmed,
            "rounds_after": self.rounds_after,
            "migrated_edges": self.migrated_edges,
            "armed_merged_rounds": self.armed_merged_rounds,
            "armed_split_edges": self.armed_split_edges,
            "pipeline_groups": (None if self._groups is None
                                else len(self._groups)),
            "pipeline_packed_rounds": (
                None if self._groups is None
                else sum(1 for g in self._groups for it in g
                         if it[0] == "r")),
            "pipeline_tail_parts": self.pipeline_tail_parts,
            "pre_folded": self.pre_folded,
            "sim_runs": self.sim_runs,
        }


# ---------------------------------------------------------------------------
# process-level executor cache (the "persistent" in persistent executor)
# ---------------------------------------------------------------------------


_CACHE: dict[tuple, CompiledExec] = {}
_HITS = {"hits": 0, "misses": 0}


def compile_schedule(schedule: CommSchedule, *,
                     optimize: bool | None = None,
                     topo: Topology | None = None) -> CompiledExec:
    """Lower ``schedule`` to a fresh ``CompiledExec`` (uncached entry;
    use ``get_executor`` for the shared process-level cache).  With a
    ``topo`` the optimization pass is armed with its alpha-beta cost
    model (multi-target fusion + round reordering); without one, only
    the topology-free single-target whole-round rule runs."""
    if optimize is None:
        optimize = optimize_enabled()
    return CompiledExec(schedule, bool(optimize), topo)


def get_executor(schedule: CommSchedule, *,
                 optimize: bool | None = None,
                 topo: Topology | None = None) -> CompiledExec:
    """The persistent-init entry: compile once per (schedule content,
    optimize flag, validation flag, topology geometry), then reuse
    forever.

    Keyed by ``CommSchedule.fingerprint()`` — two independently built
    schedules with identical tables share one executor (and its baked
    device tables).  ``REPRO_VALIDATE_SCHEDULES`` is part
    of the key because the compiled rounds are themselves CommRounds:
    flipping validation on must not hand back tables built unchecked.
    The topology's geometry-bearing ``fingerprint()`` joins the key so
    per-geometry armed compilations never collide — the same schedule
    compiled for two link geometries (or with no topology at all) gets
    distinct executors with identical numerics.
    """
    if optimize is None:
        optimize = optimize_enabled()
    key = (schedule.fingerprint(), bool(optimize),
           validate_schedules_enabled(),
           None if topo is None else topo.fingerprint())
    ex = _CACHE.get(key)
    if ex is not None:
        _HITS["hits"] += 1
        return ex
    _HITS["misses"] += 1
    ex = CompiledExec(schedule, bool(optimize), topo)
    _CACHE[key] = ex
    return ex


def clear_cache() -> None:
    """Drop every compiled executor (tests; after env-flag flips)."""
    _CACHE.clear()
    _HITS["hits"] = _HITS["misses"] = 0


def invalidate_topology(fingerprint: str | None) -> int:
    """Scoped eviction: drop only the executors armed with the given
    topology fingerprint, returning how many were dropped.

    This is the drift-healing counterpart of ``clear_cache``: when a
    probe pass moves a link model, only the geometry that changed is
    stale — executors armed with other geometries (and the topology-free
    ones, key slot ``None``) keep their baked tables.
    Pass ``None`` to evict the topology-free entries instead.
    """
    # a snapshot of the keys: a healing daemon's thread evicts while the
    # serving thread may be inserting
    doomed = [k for k in tuple(_CACHE) if k[3] == fingerprint]
    return sum(_CACHE.pop(k, None) is not None for k in doomed)


def cache_stats() -> dict:
    """Aggregate cache + per-executor stats for telemetry/benchmarks."""
    return {
        "size": len(_CACHE),
        "hits": _HITS["hits"],
        "misses": _HITS["misses"],
        "executors": [ex.stats() for ex in _CACHE.values()],
    }
