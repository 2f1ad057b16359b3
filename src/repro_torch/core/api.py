"""MPIX-style user API (paper Listings 2/4): drop-in collectives with a
publicly selectable ``algorithm=`` argument, over ``torch.distributed``.

    y = mpix_allreduce(x, group)                           # default select
    y = mpix_allreduce(x, group, algorithm="hierarchical", topo=topo)
    y = mpix_allgather(x, group, algorithm="bruck", transport="kernel")

Every rank of ``group`` (a ``ProcessGroup``; ``None`` = the default
group) calls with its local tensor; the group rank is the schedule rank.
The topology comes from ``topo=`` or, by default, from the group size
(one pod).  ``algorithm="xla"`` is the system-MPI rung: the native
``torch.distributed`` collective.  Every other name routes to a
persistent ``CommSchedule`` executed by a transport:

  * ``transport="dist"``   — one ``batch_isend_irecv`` per compiled round;
  * ``transport="kernel"`` — one ``all_gather`` and the whole schedule as
    one CUDA kernel (its plain version on CPU tensors).

Schedules are built once per (collective, algorithm, topology) and
cached, and execute through the process-level compiled-executor cache
(``core.executor``).  ``executor_cache_stats()`` /
``clear_executor_cache()`` expose that layer.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import selector
from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.topology import Topology, flat_topology
from repro_torch.core.transport import (DistTransport, KernelTransport,
                                        _all_gather)

# plan cache: (collective, algorithm, topo) -> CommSchedule; a dict so
# ``invalidate_topology`` can evict one geometry
_SCHEDULES: dict = {}


def _schedule(collective: str, algorithm: str, topo: Topology):
    key = (collective, algorithm, topo)
    sched = _SCHEDULES.get(key)
    if sched is None:
        sched = REGISTRY[collective][algorithm](topo)
        # warm the persistent-executor cache at plan time (MPI-4
        # persistent init): the armed fusion/reordering pass runs once
        from repro_torch.core import executor
        executor.get_executor(sched, topo=topo)
        _SCHEDULES[key] = sched
    return sched


def invalidate_topology(topo: Topology | str) -> dict:
    """Scoped cache eviction for one geometry: drop the cached plans
    built against ``topo`` (a ``Topology`` or its fingerprint string)
    and the compiled executors armed with its fingerprint.  Returns
    ``{"plans": n, "executors": m}`` eviction counts."""
    from repro_torch.core import executor
    fp = topo if isinstance(topo, str) else topo.fingerprint()
    doomed = [k for k in _SCHEDULES if k[2].fingerprint() == fp]
    for k in doomed:
        del _SCHEDULES[k]
    return {"plans": len(doomed),
            "executors": executor.invalidate_topology(fp)}


def executor_cache_stats() -> dict:
    """Compiled-executor cache telemetry: size, hit/miss counts, and per
    executor (rounds before/after fusion, run counters)."""
    from repro_torch.core import executor
    return executor.cache_stats()


def clear_executor_cache() -> None:
    """Drop every compiled executor (tests; after env-flag flips)."""
    from repro_torch.core import executor
    executor.clear_cache()


# Selection policy used when algorithm="auto" and no per-call ``policy=``
# is given: "fixed" (paper defaults) or "model" (alpha-beta argmin);
# "tuned" raises until the tuner is ported.
_DEFAULT_POLICY = "model"


def set_default_policy(policy: str) -> None:
    """Set the process-wide selection policy for algorithm="auto"."""
    if policy not in selector.POLICIES:
        raise ValueError(f"unknown selection policy {policy!r}; "
                         f"expected one of {selector.POLICIES}")
    global _DEFAULT_POLICY
    _DEFAULT_POLICY = policy


def get_default_policy() -> str:
    return _DEFAULT_POLICY


# Transport substrates selectable per call.  "auto" (the tuner's
# transport policy cell) is a known name that raises until the tuner is
# ported.
TRANSPORTS = ("dist", "kernel", "auto")


def _check_call(transport: str, resilience) -> None:
    """Name and option checks — run before any group resolution, so a
    typo'd transport fails loudly even outside a process group."""
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; "
                         f"expected one of {TRANSPORTS}")
    if transport == "auto":
        raise NotImplementedError(
            "transport='auto' needs the tuner's transport policy, which "
            "is ported with the tuner slice")
    if resilience is not None:
        raise NotImplementedError(
            "resilience= needs the recovery ladder, which is ported with "
            "the resilience slice")


def _group_topology(group, topo: Topology | None) -> tuple[int, Topology]:
    """(this rank, topology) for ``group``; the default topology is one
    pod of the group's size."""
    n = dist.get_world_size(group)
    topo = topo or flat_topology(n)
    if topo.nranks != n:
        raise ValueError(f"topology has {topo.nranks} ranks but the group "
                         f"has {n}")
    return dist.get_rank(group), topo


def _transport(kind: str, topo: Topology, group):
    cls = KernelTransport if kind == "kernel" else DistTransport
    return cls(topo.nranks, group, topo=topo)


def _algorithm(collective: str, algorithm: str, policy, topo: Topology,
               nbytes: int) -> str:
    if algorithm == "auto":
        algorithm = selector.select(collective, topo, nbytes,
                                    policy=policy or _DEFAULT_POLICY)
    return algorithm


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    flat = x.reshape(-1)
    rem = (-flat.numel()) % mult
    if rem:
        flat = torch.cat([flat, flat.new_zeros(rem)])
    return flat


# ---------------------------------------------------------------------------


def mpix_allgather(x: torch.Tensor, group=None, *, algorithm: str = "auto",
                   policy: str | None = None, topo: Topology | None = None,
                   transport: str = "dist",
                   resilience=None) -> torch.Tensor:
    """Tiled allgather of the local shard along its leading dim."""
    _check_call(transport, resilience)
    rank, topo = _group_topology(group, topo)
    n = topo.nranks
    algo = _algorithm("allgather", algorithm, policy, topo,
                      x.numel() * x.element_size())
    if algo == "xla":
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather(out, x, group)
        return out
    sched = _schedule("allgather", algo, topo)
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[rank] = x
    out = _transport(transport, topo, group).run(sched, buf)
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))


def mpix_allreduce(x: torch.Tensor, group=None, *, algorithm: str = "auto",
                   policy: str | None = None, topo: Topology | None = None,
                   transport: str = "dist",
                   resilience=None) -> torch.Tensor:
    """Sum of ``x`` over the group, on every rank."""
    _check_call(transport, resilience)
    _, topo = _group_topology(group, topo)
    n = topo.nranks
    algo = _algorithm("allreduce", algorithm, policy, topo,
                      x.numel() * x.element_size())
    if algo == "xla":
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out
    sched = _schedule("allreduce", algo, topo)
    flat = _pad_to(x, n)
    out = _transport(transport, topo, group).run(sched, flat.reshape(n, -1))
    return out.reshape(-1)[: x.numel()].reshape(x.shape)


def mpix_reduce_scatter(x: torch.Tensor, group=None, *,
                        algorithm: str = "auto", policy: str | None = None,
                        topo: Topology | None = None,
                        transport: str = "dist",
                        resilience=None) -> torch.Tensor:
    """Reduce over the group; scatter over the leading dim (must
    divide by the rank count)."""
    _check_call(transport, resilience)
    rank, topo = _group_topology(group, topo)
    n = topo.nranks
    if x.shape[0] % n:
        raise ValueError(
            f"mpix_reduce_scatter: leading dim {x.shape[0]} of input "
            f"shape {tuple(x.shape)} must be divisible by nranks={n} "
            f"(one scatter block per rank)")
    algo = _algorithm("reduce_scatter", algorithm, policy, topo,
                      x.numel() * x.element_size())
    if algo == "xla":
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        fn = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        fn(out, x.contiguous(), group=group)
        return out
    sched = _schedule("reduce_scatter", algo, topo)
    blocks = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    out = _transport(transport, topo, group).run(sched, blocks)
    return out[rank]


def mpix_alltoall(x: torch.Tensor, group=None, *, algorithm: str = "auto",
                  policy: str | None = None, topo: Topology | None = None,
                  transport: str = "dist",
                  resilience=None) -> torch.Tensor:
    """Alltoall over the leading dim: in block d = data for rank d;
    out block s = data from rank s.  Leading dim must divide by nranks."""
    _check_call(transport, resilience)
    _, topo = _group_topology(group, topo)
    n = topo.nranks
    if x.shape[0] % n:
        raise ValueError(
            f"mpix_alltoall: leading dim {x.shape[0]} of input shape "
            f"{tuple(x.shape)} must be divisible by nranks={n} "
            f"(one block per destination rank)")
    algo = _algorithm("alltoall", algorithm, policy, topo,
                      x.numel() * x.element_size())
    if algo == "xla":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out
    sched = _schedule("alltoall", algo, topo)
    blocks = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    if sched.num_blocks > n:          # schedules with a separate recv region
        pad = blocks.new_zeros((sched.num_blocks - n,)
                               + tuple(blocks.shape[1:]))
        blocks = torch.cat([blocks, pad], 0)
    out = _transport(transport, topo, group).run(sched, blocks)
    return out[: sched.result_blocks].reshape(x.shape)


# ---------------------------------------------------------------------------
# compute-fused terminal rounds
# ---------------------------------------------------------------------------


def mpix_allreduce_rmsnorm(x: torch.Tensor, group, scale: torch.Tensor, *,
                           eps: float = 1e-6, gemma_style: bool = False,
                           algorithm: str = "auto",
                           policy: str | None = None,
                           topo: Topology | None = None,
                           transport: str = "kernel",
                           resilience=None) -> torch.Tensor:
    """Allreduce ``x`` over the group, then rmsnorm the result — with the
    reduction's terminal round fused INTO the rmsnorm kernel.

    On the kernel transport the partial activations are combined with
    one ``all_gather`` and summed inside the fused kernel
    (``kernels.rmsnorm.rmsnorm_allreduce``): the reduced tensor never
    reaches device memory.  ``x`` is [..., d] with rmsnorm over the last
    dim; the sum is in f32 whatever the dtype, so results match
    allreduce+rmsnorm to float tolerance, not bitwise.  On "dist" it is
    ``mpix_allreduce`` followed by the plain rmsnorm kernel."""
    _check_call(transport, resilience)
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    _, topo = _group_topology(group, topo)
    if transport == "kernel":
        parts = x.new_empty((topo.nranks,) + tuple(x.shape))
        _all_gather(parts.view((-1,) + tuple(x.shape[1:])), x, group)
        return rms_ops.rmsnorm_allreduce(parts, scale, eps, gemma_style)
    y = mpix_allreduce(x, group, algorithm=algorithm, policy=policy,
                       topo=topo, transport="dist")
    return rms_ops.rmsnorm(y, scale, eps, gemma_style)


__all__ = [
    "mpix_allgather", "mpix_allreduce", "mpix_reduce_scatter",
    "mpix_alltoall", "mpix_allreduce_rmsnorm",
    "set_default_policy", "get_default_policy", "executor_cache_stats",
    "clear_executor_cache", "invalidate_topology", "TRANSPORTS",
]
