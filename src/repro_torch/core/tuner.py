"""Algorithm selection by price (the paper's §2.1 future work), partial.

This module holds what the port's selection paths need today: the chunk
count of ``mpix_alltoall_overlap``'s auto mode (``select_overlap_chunks``)
priced by the alpha-beta model of the compiled schedules, and the
modeled price of the recovery ladder's verification
(``verify_overhead_s``).  The measured tables (``tune``/``autotune``,
the persisted ``TunedTable`` and the "tuned" policy that reads it) are
ported with the tuning slice; until then ``policy="tuned"`` raises
``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.core.schedule import NotApplicable
from repro_torch.core.topology import Topology

# chunk counts the pipelined alltoall may take
_OVERLAP_PARTS = (1, 2, 4, 8)


def _modeled(sched, topo: Topology, nbytes: int) -> float:
    """alpha-beta model of what would actually execute: the *compiled*
    schedule (post fusion, cost-model-armed with ``topo``)."""
    from repro_torch.core import executor

    block = max(1, nbytes // max(1, sched.num_blocks))
    return executor.get_executor(
        sched, topo=topo).compiled_schedule.modeled_time(topo, block)


def _candidates(collective: str, topo: Topology) -> dict:
    """Buildable schedules for one collective on this topology."""
    from repro_torch.core.algorithms import REGISTRY

    out = {}
    for name, builder in REGISTRY[collective].items():
        try:
            out[name] = builder(topo)
        except NotApplicable:            # e.g. power-of-2-only variants
            continue
    return out


def select_overlap_chunks(topo: Topology, nbytes: int, compute_s: float,
                          *, policy: str | None = None) -> int:
    """Chunk count for ``mpix_alltoall_overlap``'s auto mode.

    "fixed" always returns 1 (unpipelined — the paper-default ladder
    rung); "tuned" raises until the tuner is ported; anything else
    prices the software pipeline with the CALLER's ``compute_s`` through
    ``chunked_makespan`` of the model's cheapest alltoall and returns the
    argmin over p in {1, 2, 4, 8} (ties to the smallest — never pipeline
    for free)."""
    if policy == "fixed":
        return 1
    if policy == "tuned":
        raise NotImplementedError(
            "select_overlap_chunks(policy='tuned') needs the empirical "
            "tuner, which is ported with the tuning slice")
    from repro_torch.core import executor

    cands = _candidates("alltoall", topo)
    name = min(cands, key=lambda a: _modeled(cands[a], topo, int(nbytes)))
    sched = cands[name]
    block = max(1, int(nbytes) // max(1, sched.num_blocks))
    ex = executor.get_executor(sched, topo=topo)
    return min(_OVERLAP_PARTS,
               key=lambda p: (ex.chunked_makespan(block, p, compute_s), p))


def verify_overhead_s(schedule, topo: Topology, *, slot_nbytes: int,
                      verify: str = "canary") -> float:
    """Modeled cost of ``core.resilient``'s per-run integrity check, so
    resilience is priced like any other knob.  A model, not a time
    measured on a card: it uses the topology module's ``HBM_BW`` model
    default (which fingerprint parity with the reference needs).

    "canary" is verification WITHOUT a second execution: one pass over
    the result region plus the canary row — ``(result_slots + 1) *
    slot_nbytes`` bytes at ``HBM_BW``.  "full" adds one trusted
    reference execution of the schedule (alpha-beta modeled) plus a
    second result-region pass for the bitwise compare.  "off" is free.
    """
    from repro_torch.core.topology import HBM_BW
    if verify == "off":
        return 0.0
    scan = (schedule.result_slots + 1) * max(1, int(slot_nbytes)) / HBM_BW
    if verify == "canary":
        return scan
    if verify == "full":
        return (schedule.modeled_time(topo, slot_nbytes) + 2 * scan)
    raise ValueError(f"unknown verify mode {verify!r}; "
                     f"expected off/canary/full")
