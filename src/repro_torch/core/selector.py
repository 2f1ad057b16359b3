"""Default algorithm selection (paper §2.1).

MPI Advance currently ships a fixed default per collective and lists a
"more sophisticated selection process" as future work.  We implement all
three rungs of that ladder:

  * ``select(..., policy="fixed")``   — the paper-faithful static default.
  * ``select(..., policy="model")``   — alpha-beta-model-driven argmin over
    every registered schedule (the future-work selector), using the exact
    per-round link accounting of ``Schedule.modeled_time``.
  * ``select(..., policy="tuned")``   — empirical per-size-bucket
    winners from the tuner, which this port does not have yet: the
    policy raises ``NotImplementedError`` until the tuner slice lands.

The selection is made at trace time (static shapes), so it costs nothing
at run time — the chosen schedule is baked into the compiled program,
exactly like a persistent MPI Advance collective.
"""
from __future__ import annotations

import functools

from repro_torch.core.schedule import NotApplicable
from repro_torch.core.topology import Topology

# Paper-faithful fixed defaults: log-step algorithms for small payloads
# would need runtime dispatch; statically we default to the
# bandwidth-optimal variant per collective, hierarchical when multi-pod.
_FIXED = {
    "allgather": ("ring", "hierarchical"),
    "allreduce": ("ring_rs_ag", "hierarchical"),
    "reduce_scatter": ("ring", "hierarchical"),
    "alltoall": ("pairwise", "hierarchical"),
}

# Below this many bytes per rank, latency dominates: prefer log-step.
_SMALL = 64 * 1024
_LOG_STEP = {
    "allgather": "bruck",
    "allreduce": "recursive_halving_doubling",
    "reduce_scatter": "recursive_halving",
    "alltoall": "bruck",
}


POLICIES = ("fixed", "model", "tuned")

# The two build modes of a neighborhood exchange (plan.build_plan).
NEIGHBOR = "neighbor_alltoallv"
NEIGHBOR_MODES = ("standard", "locality_aware")


def select(collective: str, topo: Topology, nbytes: int,
           policy: str = "model", tuned_table=None) -> str:
    if policy not in POLICIES:
        raise ValueError(f"unknown selection policy {policy!r}; "
                         f"expected one of {POLICIES}")
    if policy == "fixed":
        flat, hier = _FIXED[collective]
        if len(topo.levels) >= 3 and topo.npods > 1:
            # 3+ levels (DCN over a multi-axis torus): the 2-level
            # hierarchical builders see only the pod/local split; the
            # staged builders exploit every axis.  Single-pod tori stay
            # on the flat default — with no slow level to avoid, staged
            # store-and-forward only adds bytes.
            return "staged"
        return hier if topo.npods > 1 else flat
    if policy == "tuned":
        raise NotImplementedError(
            "select(policy='tuned') needs the empirical tuner, which is "
            "ported with the tuner/plan slice")
    return _model_select(collective, topo, int(nbytes))


def resolve_neighbor_mode(graph, topo: Topology, *,
                          policy: str | None = None, tuned_table=None,
                          elem_bytes: int = 4) -> str | None:
    """Cheap half of the neighbor mode choice: resolve from the policy
    alone, WITHOUT compiling any plan.  Returns None when the decision
    needs the alpha-beta model comparison of both compiled plans (the
    caller — ``build_plan`` — already has to build the winner, so it
    builds both and compares, instead of this layer compiling and
    discarding them).  The "tuned" policy raises until the tuner is
    ported."""
    if policy is None:
        from repro_torch.core import api  # local: avoid import cycle
        policy = api.get_default_policy()
    if policy not in POLICIES:
        raise ValueError(f"unknown selection policy {policy!r}; "
                         f"expected one of {POLICIES}")
    if topo.npods == 1:
        return "standard"            # both modes compile identically
    if policy == "fixed":
        return "locality_aware"
    if policy == "tuned":
        raise NotImplementedError(
            "the 'tuned' neighbor mode needs the empirical tuner, which "
            "is ported with the tuning slice")
    return None


def select_neighbor(graph, topo: Topology, *, policy: str | None = None,
                    tuned_table=None, elem_bytes: int = 4) -> str:
    """Standard-vs-locality-aware choice for a neighborhood exchange.

    Same policy ladder as ``select``: "fixed" is the paper default
    (aggregate whenever the topology is multi-pod), "model" compares the
    alpha-beta times of both compiled plans.  ``policy=None`` uses the
    process-wide default policy.
    """
    mode = resolve_neighbor_mode(graph, topo, policy=policy,
                                 tuned_table=tuned_table,
                                 elem_bytes=elem_bytes)
    if mode is not None:
        return mode
    from repro_torch.core.plan import model_argmin_plan
    plan = model_argmin_plan(graph, topo, elem_bytes=elem_bytes)
    return ("locality_aware" if plan.name.endswith("locality_aware")
            else "standard")


def _executed_time(sched, topo: Topology, nbytes: int) -> float:
    """alpha-beta time of what would actually run: the *compiled*
    schedule (post executor fusion, cost-model-armed with ``topo`` —
    the same executor the mpix_* transports look up), matching
    ``tuner._modeled`` so the model policy and the tuned tables price
    the same rounds."""
    from repro_torch.core import executor  # local: avoid import cycle

    block_nbytes = max(1, nbytes // max(1, sched.num_blocks))
    return executor.get_executor(
        sched, topo=topo).compiled_schedule.modeled_time(topo, block_nbytes)


@functools.lru_cache(maxsize=None)
def _model_select(collective: str, topo: Topology, nbytes: int) -> str:
    # local: avoid import cycle
    from repro_torch.core.algorithms import REGISTRY

    best_name, best_t = None, float("inf")
    for name, builder in REGISTRY[collective].items():
        try:
            sched = builder(topo)
        except NotApplicable:   # e.g. power-of-2-only algorithms
            continue
        t = _executed_time(sched, topo, nbytes)
        if t < best_t:
            best_name, best_t = name, t
    assert best_name is not None
    return best_name


def modeled_times(collective: str, topo: Topology, nbytes: int) -> dict:
    """All candidates' modeled times (for benchmarks / reports)."""
    from repro_torch.core.algorithms import REGISTRY

    out = {}
    for name, builder in REGISTRY[collective].items():
        try:
            sched = builder(topo)
        except NotApplicable:
            continue
        out[name] = _executed_time(sched, topo, nbytes)
    return out
