"""Elastic scaling: survive mesh-shape changes without a restart.

Two paths live here:

  * **Elastic restore** (the original path): checkpoints store trees of
    tensors free of any placement, so a run can *restart* onto a
    different number of ranks; ``remesh_plan`` recomputes the data
    decomposition and validates divisibility.

  * **Elastic re-derivation** (the no-restart path): on rank loss
    mid-run, ``shrink_topology`` rebuilds the surviving ``Topology``
    (dropping whole coordinate slices when the loss is geometric — a
    dead pod, a dead torus row — else flattening to the survivor set),
    ``rank_remap`` renumbers survivors densely, and
    ``ElasticScheduleSet.shrink`` re-derives every registered
    ``CommSchedule`` for the shrunk topology, warms the armed
    executors, and evicts the stale geometry's compiled-executor cache
    entries — swapped in place under the running ``FaultTolerantLoop``
    (``on_rank_loss``), no process restart.  The re-derived schedules
    are the same builders run on the shrunk topology, so they are
    bit-exact with a fresh build on that topology (asserted in tests
    and the ``fleet`` benchmark section).

``RankLossSignal`` is the latch between whatever detects the loss (a
heartbeat monitor, the scheduler, a test) and the loop that reacts.
"""
from __future__ import annotations

import dataclasses
import threading

from repro_torch.core.topology import TopoLevel, Topology


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_devices: int
    new_devices: int
    global_batch: int
    per_device_batch: int
    num_data_shards: int

    @property
    def scale(self) -> float:
        return self.new_devices / self.old_devices


def remesh_plan(*, global_batch: int, old_devices: int, new_devices: int,
                data_axis_size: int) -> RemeshPlan:
    """Keep the global batch invariant; redistribute rows.

    data_axis_size = the number of data-parallel ranks after the change.
    """
    if global_batch % data_axis_size:
        raise ValueError(
            f"global_batch {global_batch} not divisible by new data axis "
            f"{data_axis_size}; elastic restore would change the "
            f"trajectory")
    return RemeshPlan(
        old_devices=old_devices, new_devices=new_devices,
        global_batch=global_batch,
        per_device_batch=global_batch // data_axis_size,
        num_data_shards=data_axis_size)


# ---------------------------------------------------------------------------
# rank loss -> shrunk topology
# ---------------------------------------------------------------------------


class RankLossSignal:
    """Latches lost-rank notices (heartbeat monitor, scheduler, tests).

    ``trigger(ranks)`` accumulates; ``take()`` returns the deduplicated
    sorted list and clears the latch (None when nothing is pending) —
    the poll the ``FaultTolerantLoop`` makes once per step.  Thread-safe
    so a heartbeat thread can trigger while the loop steps.
    """

    def __init__(self):
        self._lost: set[int] = set()
        self._lock = threading.Lock()

    def trigger(self, ranks) -> None:
        ranks = [int(r) for r in (ranks if hasattr(ranks, "__iter__")
                                  else (ranks,))]
        with self._lock:
            self._lost.update(ranks)

    @property
    def pending(self) -> bool:
        return bool(self._lost)

    def take(self) -> list[int] | None:
        with self._lock:
            if not self._lost:
                return None
            out = sorted(self._lost)
            self._lost.clear()
            return out


def shrink_topology(topo: Topology, lost_ranks) -> Topology:
    """The surviving ``Topology`` after ``lost_ranks`` drop.

    When the loss is whole coordinate slices of one level (a dead pod
    at the DCN level, a dead row of a torus axis), that level shrinks
    in place and every other level — names, sizes, link models, DCN
    flags, including measured ``lm[]`` coefficients — is preserved, so
    staged builders keep their hierarchy.  A level shrunk to size 1 is
    dropped (it no longer routes anything).  Any other loss shape
    flattens to a single level of survivors over the innermost link
    class — the conservative geometry that is always correct.
    """
    lost = sorted({int(r) for r in lost_ranks})
    if not lost:
        raise ValueError("lost_ranks is empty; nothing to shrink")
    bad = [r for r in lost if r < 0 or r >= topo.nranks]
    if bad:
        raise ValueError(f"lost ranks {bad} out of range for "
                         f"nranks={topo.nranks}")
    if len(lost) >= topo.nranks:
        raise ValueError("all ranks lost; no surviving topology")
    lost_set = set(lost)
    for i, lv in enumerate(topo.levels):
        if lv.size < 2:
            continue
        coords_lost = {topo.coords(r)[i] for r in lost}
        if len(coords_lost) >= lv.size:
            continue
        slice_ranks = {r for r in range(topo.nranks)
                       if topo.coords(r)[i] in coords_lost}
        if slice_ranks != lost_set:
            continue
        new_size = lv.size - len(coords_lost)
        levels = []
        for j, l2 in enumerate(topo.levels):
            if j == i:
                if new_size == 1 and len(topo.levels) > 1:
                    continue
                levels.append(TopoLevel(l2.name, new_size, l2.link,
                                        l2.dcn))
            else:
                levels.append(l2)
        return Topology.from_levels(levels)
    inner = topo.levels[-1]
    return Topology.from_levels(
        [TopoLevel(inner.name, topo.nranks - len(lost), inner.link,
                   dcn=False)])


def rank_remap(topo: Topology, lost_ranks) -> dict[int, int]:
    """Dense renumbering of survivors: old rank -> new rank.

    Survivors keep their relative (row-major) order, which for
    whole-slice removal means the new rank's coordinates are the old
    ones with the shrunk axis renumbered — checkpoint shards and data
    shards move by this map, nothing is reshuffled.
    """
    lost = {int(r) for r in lost_ranks}
    return {old: new for new, old in enumerate(
        r for r in range(topo.nranks) if r not in lost)}


# ---------------------------------------------------------------------------
# in-place schedule re-derivation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ElasticSwapReport:
    """What one ``ElasticScheduleSet.shrink`` did (benchmark/telemetry
    record: the ``fleet`` section counts ``rederived``)."""

    lost_ranks: tuple
    old_fingerprint: str
    new_fingerprint: str
    rederived: tuple              # schedule names rebuilt
    refit: tuple                  # names whose algorithm changed
    invalidated: int              # stale compiled executors evicted
    generation: int
    remap: dict


class ElasticScheduleSet:
    """Named staged ``CommSchedule``s that survive rank loss in place.

    entries: name -> (collective, algorithm) — the plans a training or
    serving loop holds (grad-sync allreduce, MoE alltoall, ...).  Each
    is built from the live ``algorithms.REGISTRY`` against the current
    topology and warmed through the armed executor cache, exactly like
    ``api._schedule`` does.  ``shrink(lost)`` is the elastic swap: new
    topology, every schedule re-derived by the same builders (so the
    result is bit-exact with a fresh build on that topology), stale
    executors evicted — the running loop keeps the same object and
    never restarts.  An algorithm the shrunk topology cannot express
    (``NotApplicable`` — e.g. a power-of-2-only variant after dropping
    to 6 ranks) falls back down the selector's fixed preference ladder
    and is reported in ``refit``.
    """

    def __init__(self, topo: Topology, entries: dict, *,
                 warm: bool = True):
        self.topo = topo
        self.entries = {name: (coll, algo)
                        for name, (coll, algo) in entries.items()}
        self.generation = 0
        self.schedules: dict = {}
        self.executors: dict = {}
        self._warm = warm
        self._build()

    def _build(self) -> list[str]:
        from repro_torch.core import executor
        from repro_torch.core.algorithms import REGISTRY
        from repro_torch.core.schedule import NotApplicable
        from repro_torch.core.selector import _FIXED

        refit = []
        schedules, executors = {}, {}
        for name, (coll, algo) in self.entries.items():
            try:
                sched = REGISTRY[coll][algo](self.topo)
            except NotApplicable:
                ladder = [a for a in _FIXED.get(coll, ()) if a != algo]
                ladder += [a for a in REGISTRY[coll]
                           if a != algo and a not in ladder]
                for cand in ladder:
                    try:
                        sched = REGISTRY[coll][cand](self.topo)
                    except NotApplicable:
                        continue
                    self.entries[name] = (coll, cand)
                    refit.append(name)
                    break
                else:
                    raise
            schedules[name] = sched
            if self._warm:
                executors[name] = executor.get_executor(sched,
                                                        topo=self.topo)
        self.schedules = schedules
        self.executors = executors
        return refit

    def schedule_for(self, name):
        return self.schedules[name]

    def executor_for(self, name):
        return self.executors[name]

    def shrink(self, lost_ranks) -> ElasticSwapReport:
        from repro_torch.core import executor

        lost = tuple(sorted({int(r) for r in lost_ranks}))
        old = self.topo
        old_fp = old.fingerprint()
        new_topo = shrink_topology(old, lost)
        remap = rank_remap(old, lost)
        self.topo = new_topo
        refit = self._build()
        invalidated = executor.invalidate_topology(old_fp)
        self.generation += 1
        return ElasticSwapReport(
            lost_ranks=lost, old_fingerprint=old_fp,
            new_fingerprint=new_topo.fingerprint(),
            rederived=tuple(sorted(self.schedules)),
            refit=tuple(sorted(refit)),
            invalidated=invalidated, generation=self.generation,
            remap=remap)
