"""The unified gather-permute-scatter IR — the "persistent plan" core.

MPI Advance hoists all collective setup into a one-time initialization
(persistent collectives, MPI-4) and writes every optimization — dense
collectives, neighborhood collectives, partitioned transfers — against
one point-to-point substrate.  Here every algorithm compiles — once,
in Python, at plan time — to a ``CommSchedule``: a list of
``CommRound``s, each

  * per-rank **gather** indices (which rows of the local working buffer
    are packed into the outgoing message; -1 pads with zeros),
  * a static partial **permutation** of (src, dst) rank pairs,
  * per-rank **scatter** indices (where received slots land; -1 drops),
  * an optional ``reduce`` flag (received slots accumulate instead of
    overwrite).

Dense collectives (allgather/allreduce/reduce_scatter/alltoall — block
tables), neighborhood alltoallv plans (row tables), and partitioned
transfers (chunk tables) all lower to the same IR and are executed by
the same backends (see transport.py):

  * ``SimTransport``    — numpy rank-by-rank simulator; exact message/
                          byte accounting against a ``Topology``.
  * ``DistTransport``   — ``torch.distributed`` point-to-point: one
                          ``batch_isend_irecv`` per compiled round.
  * ``KernelTransport`` — the whole compiled schedule as one CUDA kernel
                          on the gathered global buffer.

Buffers are *slot-indexed*: shape ``[num_slots, slot...]`` per rank.
Rounds move whole slots; ragged (v-variant) payloads are padded to the
max slot and true element counts are carried per round (``payload``)
for accounting.

Invariant validation is O(nranks^2) python per round; it is gated by
the ``REPRO_VALIDATE_SCHEDULES`` env var (off by default so large-mesh
plan builds stay cheap; the test suite turns it on via conftest.py).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Sequence

import numpy as np

from repro_torch.core.topology import Topology


def validate_schedules_enabled() -> bool:
    """True when CommRound invariants should be checked at build time."""
    v = os.environ.get("REPRO_VALIDATE_SCHEDULES", "0").strip().lower()
    return v not in ("", "0", "false", "off", "no")


class NotApplicable(AssertionError):
    """An algorithm builder cannot serve this topology (e.g. a
    power-of-2-only variant on 12 ranks).  Subclasses AssertionError so
    historical ``except AssertionError`` call sites keep working, while
    coverage-critical loops (CI smoke, the bit-exactness sweep) can
    catch *only* this and let genuine invariant violations fail loud."""


@dataclasses.dataclass(frozen=True)
class ComputeEvent:
    """An opaque costed block of consumer compute attached to a schedule.

    MPIPCL's partitioned communication exists so chunk transfers overlap
    with the compute that produces/consumes them; a ``ComputeEvent`` is
    how a consumer registers that compute with the executor's makespan
    model (core.executor pass 3) without the IR knowing what it is.

    Events are *modeling artifacts*: execution ignores them entirely
    (bit-exactness is untouched); only ``CompiledExec.makespan`` and the
    pipelined pass read them.  An event is a pure consumer — it reads a
    snapshot of the buffer after ``after_round`` and writes nothing, so
    it never constrains round motion, only its own placement.

    after_round: index into the *original* schedule's rounds the event
                 waits on (-1 = after the last round).
    splittable:  the compute can run as equal slices over chunks of its
                 input — the precondition for the tail-chunk overlap
                 move (each slice then waits only for its chunk).
    parts:       preferred slice count when splittable (0 = let the
                 executor choose).
    """

    name: str
    seconds: float
    after_round: int = -1
    splittable: bool = False
    parts: int = 0

    def __post_init__(self):
        if self.seconds < 0:
            raise ValueError(
                f"ComputeEvent {self.name!r}: seconds must be >= 0, "
                f"got {self.seconds}")
        if self.after_round < -1:
            raise ValueError(
                f"ComputeEvent {self.name!r}: after_round must be >= -1, "
                f"got {self.after_round}")
        if self.parts < 0:
            raise ValueError(
                f"ComputeEvent {self.name!r}: parts must be >= 0, "
                f"got {self.parts}")


@dataclasses.dataclass(frozen=True)
class CommRound:
    """One communication round of the unified IR.

    perm:        static list of (src, dst) rank pairs (a partial matching
                 in rank space — each src sends once, each dst receives
                 once; (r, r) self-pairs are legal and model on-chip
                 copies that never touch the wire).
    gather_idx:  int array [nranks, k]; row r = working-buffer rows rank r
                 packs into its outgoing message (-1 entries send zeros).
    scatter_idx: int array [nranks, k]; row r = landing rows for what
                 rank r receives (-1 entries are dropped).
    reduce:      if True received slots are added into the buffer,
                 otherwise they overwrite.
    payload:     optional int array [nranks]; true (unpadded) slot counts
                 per source, for ragged accounting.  Execution always
                 moves k padded slots.
    """

    perm: tuple[tuple[int, int], ...]
    gather_idx: np.ndarray
    scatter_idx: np.ndarray
    reduce: bool = False
    payload: np.ndarray | None = None

    def __post_init__(self):
        if not validate_schedules_enabled():
            return
        assert self.gather_idx.shape == self.scatter_idx.shape
        srcs = [s for s, _ in self.perm]
        dsts = [d for _, d in self.perm]
        assert len(set(srcs)) == len(srcs), "duplicate src in perm"
        assert len(set(dsts)) == len(dsts), "duplicate dst in perm"
        # Non-destination ranks must carry an all -1 scatter row, so that
        # the numpy simulator and the point-to-point executor agree
        # bit-for-bit (non-destinations receive zeros; the -1 row routes
        # those zeros to the scratch slot instead of clobbering real
        # slots).
        dst_set = set(dsts)
        for r in range(self.scatter_idx.shape[0]):
            if r not in dst_set:
                assert (self.scatter_idx[r] < 0).all(), (
                    f"rank {r} is not a destination this round but has a "
                    f"live scatter row {self.scatter_idx[r]}")
        # A destination's live scatter slots must be distinct (scatter
        # safety: .at[].set with duplicate targets is order-dependent).
        for _, d in self.perm:
            live = self.scatter_idx[d][self.scatter_idx[d] >= 0]
            assert len(set(live.tolist())) == len(live), (
                f"rank {d} has duplicate scatter slots {live}")

    @property
    def k(self) -> int:
        return self.gather_idx.shape[1]

    # historical aliases (block-table vocabulary of the dense stack)
    width = k

    @property
    def send_blocks(self) -> np.ndarray:
        return self.gather_idx

    @property
    def recv_blocks(self) -> np.ndarray:
        return self.scatter_idx

    def edge_slots(self, src: int) -> int:
        """True slots ``src`` ships this round (payload-aware)."""
        if self.payload is not None:
            return int(self.payload[src])
        return int((self.gather_idx[src] >= 0).sum())

    # -- fusion-legality metadata (consumed by core.executor) --------------
    @property
    def src_set(self) -> frozenset[int]:
        return frozenset(s for s, _ in self.perm)

    @property
    def dst_set(self) -> frozenset[int]:
        return frozenset(d for _, d in self.perm)

    def reads(self, rank: int) -> frozenset[int]:
        """Buffer rows rank reads this round (its gather sources, when it
        is a source; empty otherwise)."""
        if rank not in self.src_set:
            return frozenset()
        row = self.gather_idx[rank]
        return frozenset(int(b) for b in row[row >= 0])

    def writes(self, rank: int) -> frozenset[int]:
        """Buffer rows rank overwrites/accumulates this round (its live
        scatter targets, when it is a destination; empty otherwise)."""
        if rank not in self.dst_set:
            return frozenset()
        row = self.scatter_idx[rank]
        return frozenset(int(b) for b in row[row >= 0])


def can_fuse(a: CommRound, b: CommRound) -> bool:
    """True when consecutive rounds ``a`` then ``b`` may execute as one
    point-to-point round with identical semantics.

    Legality (the executor's whole-round peephole; the edge-granular
    compaction in core.executor generalizes it):
      * neither round reduces — a fused round has one accumulate flag,
        and merging around an accumulation reorders float adds;
      * the merged perm must stay a partial matching: no rank may be a
        src in both rounds, or a dst in both rounds;
      * no read-after-write hazard: in the fused round every gather
        reads pre-round state, so rows ``a`` scatters into on some rank
        must not alias rows ``b`` gathers from that rank.
    (Write-after-read needs no check: fused execution gathers before it
    scatters, exactly like the unfused order ``a``-reads-then-writes,
    ``b``-reads-then-writes for disjoint src/dst sets.)
    """
    if a.reduce or b.reduce:
        return False
    if a.src_set & b.src_set or a.dst_set & b.dst_set:
        return False
    for r in a.dst_set & b.src_set:
        if a.writes(r) & b.reads(r):
            return False
    return True


def can_split(rnd: CommRound, parts: int) -> bool:
    """True when ``rnd`` may be partitioned into ``parts`` sequential
    chunk rounds with identical semantics (MPIPCL partitioning on the
    unified IR).

    Legality:
      * ``parts >= 2`` and the round is not a reduce (chunked
        accumulation would reorder float adds relative to concurrent
        delivery);
      * dense tables only (``payload is None``) with ``k % parts == 0``
        — equal chunks are what keeps the chunked alpha-beta time
        provably bounded at every slot size (ceil splits introduce
        size-dependent remainder terms);
      * no scatter->gather aliasing anywhere in the round, INCLUDING a
        single edge whose own writes alias its own reads: in the
        original round every gather reads pre-round state, but chunk i
        scatters before chunk i+1 gathers, so any aliasing would
        reorder a write before a read.
    (Write-after-write needs no check: live scatter targets are
    distinct per destination — a schedule invariant — so chunks write
    disjoint rows.)
    """
    if parts < 2 or rnd.reduce or rnd.payload is not None:
        return False
    if rnd.k % parts:
        return False
    for s1, d1 in rnd.perm:
        for s2, _ in rnd.perm:
            if d1 == s2 and rnd.writes(d1) & rnd.reads(s2):
                return False
    return True


def split_round(rnd: CommRound, parts: int) -> tuple[CommRound, ...]:
    """Partition ``rnd`` into ``parts`` chunk rounds; chunk ``i``
    carries the position-contiguous slice ``[i*k/parts, (i+1)*k/parts)``
    of every edge's gather/scatter vectors.  Executing the chunks in
    order is bit-identical to the original round (``can_split`` is the
    precondition); per port the chunk sequence costs
    ``parts * alpha + k * slot_bytes * beta`` — the alpha-beta price of
    MPIPCL's independently-committed partitions.
    """
    assert can_split(rnd, parts), (rnd.k, parts, rnd.reduce)
    kc = rnd.k // parts
    out = []
    for i in range(parts):
        sl = slice(i * kc, (i + 1) * kc)
        out.append(CommRound(perm=rnd.perm,
                             gather_idx=np.ascontiguousarray(
                                 rnd.gather_idx[:, sl]),
                             scatter_idx=np.ascontiguousarray(
                                 rnd.scatter_idx[:, sl])))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class CommSchedule:
    """A compiled communication pattern: rounds + buffer geometry.

    num_slots:   leading axis of the working buffer (excl. the scratch
                 slot transports append internally).
    slot_bytes:  optional per-slot true byte counts [num_slots] for
                 ragged payloads (accounting only; execution is padded).
    local_pre:   optional [nranks, num_slots] slot permutation applied
                 before round 0 (new_buf[s] = buf[local_pre[r, s]]); free
                 — a local shuffle, no messages (Bruck rotation phase).
    local_post:  same, applied after the last round.
    out_slots:   number of slots that constitute the result after
                 local_post (schedules with separate send/recv regions
                 set this < num_slots, like MPI send/recv buffer pairs).
    out_offsets: optional per-rank [nranks] start row of the result
                 region (neighborhood plans land recv segments mid-
                 buffer; dense collectives leave this None = row 0).
    compute_events: optional ``ComputeEvent`` list — opaque costed
                 consumer-compute barriers the executor's makespan
                 model prices and overlaps; execution ignores them.
    """

    nranks: int
    num_slots: int
    rounds: tuple[CommRound, ...]
    name: str = "schedule"
    slot_bytes: np.ndarray | None = None
    local_pre: np.ndarray | None = None
    local_post: np.ndarray | None = None
    out_slots: int | None = None
    out_offsets: np.ndarray | None = None
    compute_events: tuple[ComputeEvent, ...] = ()

    def __post_init__(self):
        if not isinstance(self.compute_events, tuple):
            object.__setattr__(self, "compute_events",
                               tuple(self.compute_events))
        if not validate_schedules_enabled():
            return
        for ev in self.compute_events:
            assert isinstance(ev, ComputeEvent), ev
            assert ev.after_round < len(self.rounds), (
                f"event {ev.name!r} anchored after round {ev.after_round} "
                f"but the schedule has {len(self.rounds)} rounds")

    @property
    def result_slots(self) -> int:
        return self.num_slots if self.out_slots is None else self.out_slots

    def out_offset(self, rank: int) -> int:
        return 0 if self.out_offsets is None else int(self.out_offsets[rank])

    # historical aliases (block vocabulary of the dense stack)
    @property
    def num_blocks(self) -> int:
        return self.num_slots

    @property
    def result_blocks(self) -> int:
        return self.result_slots

    @property
    def block_bytes(self) -> np.ndarray | None:
        return self.slot_bytes

    # -- accounting (validates the paper's message/byte-count claims) ------
    def _edges(self, topo: Topology | None, local: bool | None):
        """Live wire edges (src, dst, true_slots); self-pairs and empty
        payloads never hit the wire and are excluded."""
        for rnd in self.rounds:
            for s, d in rnd.perm:
                if s == d:
                    continue
                slots = rnd.edge_slots(s)
                if slots == 0:
                    continue
                if topo is not None and local is not None:
                    if topo.is_local(s, d) != local:
                        continue
                yield rnd, s, d, slots

    def message_count(self, topo: Topology | None = None,
                      local: bool | None = None) -> int:
        """Total point-to-point messages; filter by link class if asked."""
        return sum(1 for _ in self._edges(topo, local))

    def byte_count(self, elem_bytes: int, topo: Topology | None = None,
                   local: bool | None = None) -> int:
        """Total bytes moved (true counts if slot_bytes/payload set).

        ``slot_bytes`` is authoritative whenever it is set: the per-slot
        true byte widths are summed over the live gather entries of each
        edge (truncated to the round's ``payload`` count when both are
        present — the first ``payload[src]`` live entries are the real
        slots, the rest is padding).  Only slots with no recorded width
        fall back to ``slots * elem_bytes``.
        """
        total = 0
        for rnd, s, d, slots in self._edges(topo, local):
            if self.slot_bytes is not None:
                live = rnd.gather_idx[s][rnd.gather_idx[s] >= 0]
                if rnd.payload is not None:
                    live = live[: slots]
                total += int(sum(int(self.slot_bytes[b]) for b in live))
            else:
                total += slots * elem_bytes
        return total

    def traffic(self, topo: Topology, elem_bytes: int = 1) -> dict:
        """Per-link-class bytes and message counts (the paper's
        aggregation claims: locality-aware plans cut DCN bytes/msgs)."""
        out = {"ici": 0, "dcn": 0, "msgs_ici": 0, "msgs_dcn": 0}
        for rnd, s, d, slots in self._edges(topo, None):
            key = "ici" if topo.is_local(s, d) else "dcn"
            out[key] += slots * elem_bytes
            out["msgs_" + key] += 1
        return out

    def modeled_time(self, topo: Topology, slot_nbytes: int) -> float:
        """alpha-beta model: rounds serialize, edges within a round
        overlap.  Rounds without ``payload`` move k padded slots per
        edge (dense block tables); payload-bearing rounds (ragged
        neighbor exchanges) use true per-source counts."""
        total = 0.0
        for rnd in self.rounds:
            if rnd.payload is None:
                total += topo.round_time(rnd.perm, slot_nbytes * rnd.k)
            else:
                per_edge = [rnd.edge_slots(s) * slot_nbytes
                            for s, _ in rnd.perm]
                total += topo.round_time(rnd.perm, per_edge)
        return total

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    # -- identity -----------------------------------------------------------
    def fingerprint(self) -> str:
        """Content hash of everything execution-relevant (tables, perms,
        flags, geometry) — the executor-cache key, the CommSchedule
        analogue of ``Topology.fingerprint``.  Two independently built
        schedules with identical tables share one fingerprint (and one
        compiled executor); the display ``name`` is excluded.
        """
        memo = getattr(self, "_fingerprint", None)
        if memo is not None:
            return memo
        h = hashlib.sha1()

        def feed(tag: str, arr) -> None:
            h.update(tag.encode())
            if arr is None:
                h.update(b"\x00")
                return
            a = np.ascontiguousarray(arr)
            h.update(str(a.dtype).encode() + str(a.shape).encode())
            h.update(a.tobytes())

        h.update(f"n{self.nranks}:s{self.num_slots}:o{self.out_slots}"
                 .encode())
        feed("slot_bytes", self.slot_bytes)
        feed("pre", self.local_pre)
        feed("post", self.local_post)
        feed("out_offsets", self.out_offsets)
        for rnd in self.rounds:
            h.update(b"R" + (b"+" if rnd.reduce else b"-"))
            feed("perm", np.asarray(rnd.perm, np.int64).reshape(-1, 2)
                 if rnd.perm else np.zeros((0, 2), np.int64))
            feed("g", rnd.gather_idx)
            feed("s", rnd.scatter_idx)
            feed("p", rnd.payload)
        for ev in self.compute_events:
            # events change what the makespan pass produces (groups,
            # tail split), so they are identity-bearing for the
            # executor cache even though execution ignores them
            h.update(f"E{ev.name}|{ev.seconds!r}|{ev.after_round}|"
                     f"{int(ev.splittable)}|{ev.parts}".encode())
        fp = h.hexdigest()
        # memo on the frozen instance (plain attribute, not a field:
        # equality/repr are unaffected and the hash is deterministic)
        object.__setattr__(self, "_fingerprint", fp)
        return fp


# Back-compat aliases: the pre-unification dense stack exported these.
Round = CommRound
Schedule = CommSchedule


def add_canary_slot(schedule: CommSchedule) -> CommSchedule:
    """Derive a schedule with one extra *canary* slot row that no round
    reads, writes, or permutes — it rides through the transports'
    staging buffers untouched.

    Self-verifying execution (``core.resilient``) fills the canary row
    with a seeded pattern before the run and compares it bitwise after:
    buffer-wide data-plane corruption (a stray DMA, a flipped page, an
    injected chaos fault) that lands on the canary is detected in one
    O(slot) pass, without a second execution.  The transform is pure
    geometry: round tables are unchanged (they index slots
    ``< num_slots``, still valid), ``local_pre``/``local_post`` are
    extended with the identity on the canary row, and the result region
    (``out_slots``/``out_offsets``) is pinned to the original
    schedule's, so stripping the canary row recovers the original
    output exactly.  The canary row index is the ORIGINAL
    ``num_slots``; the transports' scratch row moves up by one.
    """
    def extend(perm):
        if perm is None:
            return None
        col = np.full((schedule.nranks, 1), schedule.num_slots,
                      dtype=perm.dtype)
        return np.concatenate([perm, col], axis=1)

    return CommSchedule(
        nranks=schedule.nranks,
        num_slots=schedule.num_slots + 1,
        rounds=schedule.rounds,
        name=schedule.name + "+canary",
        slot_bytes=None if schedule.slot_bytes is None
        else np.concatenate([schedule.slot_bytes, [0]]),
        local_pre=extend(schedule.local_pre),
        local_post=extend(schedule.local_post),
        out_slots=schedule.result_slots,
        out_offsets=schedule.out_offsets,
        compute_events=schedule.compute_events)


def make_round(nranks: int,
               edges: Sequence[tuple[int, int]],
               send_blocks: dict[int, Sequence[int]],
               recv_blocks: dict[int, Sequence[int]],
               reduce: bool = False) -> CommRound:
    """Build a CommRound from per-rank slot lists (ragged -> padded -1)."""
    k = max((len(v) for v in send_blocks.values()), default=0)
    k = max(k, max((len(v) for v in recv_blocks.values()), default=0))
    k = max(k, 1)
    sb = np.full((nranks, k), -1, dtype=np.int32)
    rb = np.full((nranks, k), -1, dtype=np.int32)
    for r, blocks in send_blocks.items():
        sb[r, : len(blocks)] = blocks
    for r, blocks in recv_blocks.items():
        rb[r, : len(blocks)] = blocks
    return CommRound(perm=tuple((int(s), int(d)) for s, d in edges),
                     gather_idx=sb, scatter_idx=rb, reduce=reduce)
