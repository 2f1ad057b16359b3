"""MPIX-style user API (paper Listings 2/4): drop-in collectives with a
publicly selectable ``algorithm=`` argument, over ``torch.distributed``.

    y = mpix_allreduce(x, group)                           # default select
    y = mpix_allreduce(x, group, algorithm="hierarchical", topo=topo)
    y = mpix_allgather(x, group, algorithm="bruck", transport="kernel")
    plan = make_neighbor_plan(graph, topo)                 # once, on the host
    y = mpix_neighbor_alltoallv(x, group, plan)

Every rank of ``group`` (a ``ProcessGroup``; ``None`` = the default
group) calls with its local tensor; the group rank is the schedule rank.
The topology comes from ``topo=`` or, by default, from the group size
(one pod).  ``algorithm="xla"`` is the system-MPI rung: the native
``torch.distributed`` collective.  Every other name routes to a
persistent ``CommSchedule`` executed by a transport:

  * ``transport="dist"``   — one ``batch_isend_irecv`` per compiled round;
  * ``transport="kernel"`` — one ``all_gather`` and the whole schedule as
    one CUDA kernel (its plain version on CPU tensors);
  * ``transport="auto"``   — the tuner's ``transport`` cell prices the
    two per size bucket (``tuner.select_transport``).

Schedules are built once per (collective, algorithm, topology) and
cached, and execute through the process-level compiled-executor cache
(``core.executor``).  ``executor_cache_stats()`` /
``clear_executor_cache()`` expose that layer.

``resilience=`` arms the recovery ladder on every collective (see
``_execute``); ``set_chaos(plan)`` wraps every transport the API builds
with a seeded ``core.chaos.FaultPlan`` (tests), and
``take_degradations()`` drains the reports of calls that needed the
ladder.  ``ensure_tuned(topo)`` loads (tuning once if missing) the
empirical table behind ``policy="tuned"`` and makes it the default.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.core import chaos as _chaos
from repro_torch.core import selector
from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.resilient import (Attempt, DegradationReport,
                                        UnrecoverableError,
                                        resolve_resilience)
from repro_torch.core.schedule import NotApplicable
from repro_torch.core.topology import Topology, flat_topology
from repro_torch.core.transport import (DistTransport, KernelTransport,
                                        TransportError, _all_gather)

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
    """Scoped cache eviction for one geometry (drift heal / elastic
    swap): drop the cached plans built against ``topo`` (a ``Topology``
    or its fingerprint string), the compiled executors armed with its
    fingerprint and their lowered kernel executors (whose tables live
    on the card).  Plans and executors for every other geometry are
    untouched.  Returns ``{"plans": n, "executors": m}`` eviction
    counts."""
    from repro_torch.core import executor, kernel_lowering
    fp = topo if isinstance(topo, str) else topo.fingerprint()
    doomed = [k for k in tuple(_SCHEDULES) if k[2].fingerprint() == fp]
    plans = sum(_SCHEDULES.pop(k, None) is not None for k in doomed)
    kernel_lowering.invalidate_topology(fp)
    return {"plans": plans,
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
# is given: "fixed" (paper defaults), "model" (alpha-beta argmin) or
# "tuned" (persisted empirical table; see repro_torch.core.tuner).
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


def ensure_tuned(topo: Topology, *, path=None, heal: bool = True,
                 set_policy: bool = True, **tune_kwargs):
    """Init-time entry for ``policy="tuned"`` (persistent-MPI style).

    Loads (tuning once if missing) the empirical table for ``topo``'s
    substrate; with ``heal=True`` any performance-guideline violation in
    a cached table triggers a scoped re-measure of only the offending
    (collective, size-bucket) cells and persists a bumped generation —
    see ``tuner.ensure_table``.  With ``set_policy=True`` the process
    default policy flips to "tuned", so every later ``algorithm="auto"``
    collective resolves from the (healed) table.  Returns the table.
    """
    from repro_torch.core import tuner  # local: avoid import cycle
    table = tuner.ensure_table(topo, path=path, heal=heal, **tune_kwargs)
    if set_policy:
        set_default_policy("tuned")
    return table


# Transport substrates selectable per call: "dist" (one exchange per
# compiled round), "kernel" (the whole schedule as one kernel launch),
# or "auto" (the tuner's ``transport`` policy cell prices the two per
# size bucket).
TRANSPORTS = ("dist", "kernel", "auto")


def _check_call(transport: str, resilience) -> None:
    """Name and option checks — run before any group resolution, so a
    typo'd transport or resilience option fails loudly even outside a
    process group."""
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; "
                         f"expected one of {TRANSPORTS}")
    resolve_resilience(resilience)


def _resolve_transport(transport: str, topo: Topology, nbytes: int,
                       policy: str | None = None) -> str:
    """A concrete substrate for ``transport`` ("auto": the tuner's
    choice for this topology and payload under the policy)."""
    if transport == "auto":
        from repro_torch.core import tuner  # local: avoid import cycle
        transport = tuner.select_transport(
            topo, nbytes, policy=policy or _DEFAULT_POLICY)
    return transport


def _group_topology(group, topo: Topology | None) -> tuple[int, Topology]:
    """(this rank, topology) for ``group``; the default topology is one
    pod of the group's size."""
    n = dist.get_world_size(group)
    topo = topo or flat_topology(n)
    if topo.nranks != n:
        raise ValueError(f"topology has {topo.nranks} ranks but the group "
                         f"has {n}")
    return dist.get_rank(group), topo


# Process-wide chaos plan (``core.chaos.FaultPlan``): when set, every
# transport the api constructs is wrapped so seeded faults fire on the
# real mpix_* execution paths.  Test-only; None in production.
_CHAOS_PLAN = None


def set_chaos(plan) -> None:
    """Install (or clear, with None) the process-wide fault plan; all
    subsequently constructed mpix_* transports are chaos-wrapped."""
    global _CHAOS_PLAN
    _CHAOS_PLAN = plan


def get_chaos():
    return _CHAOS_PLAN


def _transport(kind: str, topo: Topology, group):
    cls = KernelTransport if kind == "kernel" else DistTransport
    return _chaos.wrap(cls(topo.nranks, group, topo=topo), _CHAOS_PLAN)


# Degradation telemetry: every mpix_* call that needed the recovery
# ladder appends its DegradationReport here, so a degraded run is
# visible, not silent.
_DEGRADATIONS: list = []


def last_degradation():
    """The most recent DegradationReport (None when nothing degraded)."""
    return _DEGRADATIONS[-1] if _DEGRADATIONS else None


def take_degradations() -> list:
    """Drain and return all accumulated DegradationReports."""
    out = list(_DEGRADATIONS)
    _DEGRADATIONS.clear()
    return out


def _execute(collective: str, run, *, algorithm: str, transport: str,
             resilience, topo: Topology, nbytes: int, policy=None,
             xla_ok: bool = True):
    """Shared execution path of every mpix_* collective.

    ``run(kind, algo)`` closes over the collective's buffers and does
    one full attempt on transport ``kind`` ("dist"/"kernel", or the
    native collective when ``algo == "xla"``); ``transport="auto"`` is
    resolved here, per call, from ``topo`` and ``nbytes``.  Without
    ``resilience`` this is a zero-overhead passthrough.  With it, the recovery ladder
    runs: detected faults — a raised ``TransportError`` (a failed dist
    round, an injected chaos failure), a ``NotApplicable`` refit miss,
    or a wall-clock deadline overrun — are retried with exponential
    backoff, degraded to the other of the dist/kernel transports,
    refitted down the selector's algorithm ladder, and finally routed
    to the native ``torch.distributed`` collective (``algorithm="xla"``,
    the system-MPI rung) before a typed ``UnrecoverableError`` is
    raised.  A failure of the CUDA kernel itself is not a
    ``TransportError`` and propagates.

    This layer keeps the reference's semantics: it recovers *detected*
    faults only (``verify`` is not applied here); silent corruption is
    caught by the host-level ``ResilientExec`` (core.resilient).  Every
    rank of the group walks the ladder on its own; seeded chaos fires
    alike on every rank, so they walk it alike.
    """
    opts = resolve_resilience(resilience)
    if algorithm == "xla":
        return run("xla", "xla")
    transport = _resolve_transport(transport, topo, nbytes, policy)
    if opts is None:
        return run(transport, algorithm)

    report = DegradationReport(schedule=f"{collective}.{algorithm}",
                               verify="off")

    def finish(out, rung):
        report.recovered_with = rung
        if report.degraded:
            _DEGRADATIONS.append(report)
        return out

    kinds = [transport] + [k for k in ("dist", "kernel") if k != transport]
    for k in kinds:
        delay = opts.backoff_s
        for attempt in range(opts.max_retries + 1):
            t0 = time.perf_counter()
            try:
                out = run(k, algorithm)
            except TransportError as e:
                report.attempts.append(Attempt(
                    rung=k, algorithm=algorithm, attempt=attempt,
                    outcome="fault", detail=str(e),
                    seconds=time.perf_counter() - t0))
                time.sleep(delay)
                delay *= opts.backoff_mult
                continue
            if isinstance(out, torch.Tensor) and out.device.type == "cuda":
                torch.cuda.synchronize(out.device)
            dt = time.perf_counter() - t0
            if opts.deadline_s is not None and dt > opts.deadline_s:
                report.attempts.append(Attempt(
                    rung=k, algorithm=algorithm, attempt=attempt,
                    outcome="timeout", seconds=dt,
                    detail=f"{dt:.4f}s > deadline {opts.deadline_s:.4f}s"))
                time.sleep(delay)
                delay *= opts.backoff_mult
                continue
            report.attempts.append(Attempt(
                rung=k, algorithm=algorithm, attempt=attempt,
                outcome="ok", seconds=dt))
            return finish(out, k)
    if opts.refit:
        ladder = [a for a in selector._FIXED.get(collective, ())
                  if a != algorithm]
        ladder += [a for a in REGISTRY.get(collective, {})
                   if a != algorithm and a not in ladder]
        for cand in ladder:
            try:
                out = run(kinds[0], cand)
            except (TransportError, NotApplicable) as e:
                report.attempts.append(Attempt(
                    rung="refit", algorithm=cand, attempt=0,
                    outcome="fault" if isinstance(e, TransportError)
                    else "skipped", detail=str(e) or type(e).__name__))
                continue
            report.attempts.append(Attempt(
                rung="refit", algorithm=cand, attempt=0, outcome="ok"))
            report.refit_algorithm = cand
            return finish(out, kinds[0])
    if xla_ok:
        try:
            out = run("xla", "xla")
        except Exception as e:  # the native collective is a best-effort end
            report.attempts.append(Attempt(
                rung="xla", algorithm="xla", attempt=0,
                outcome="fault", detail=str(e)))
        else:
            report.attempts.append(Attempt(
                rung="xla", algorithm="xla", attempt=0, outcome="ok"))
            report.refit_algorithm = "xla"
            return finish(out, "xla")
    raise UnrecoverableError(
        f"{collective} could not be recovered on any transport or "
        f"algorithm", report)


def _algorithm(collective: str, algorithm: str, policy, topo: Topology,
               nbytes: int) -> str:
    if algorithm == "auto":
        algorithm = selector.select(collective, topo, nbytes,
                                    policy=policy or _DEFAULT_POLICY)
    return algorithm


def resolve_schedule(collective: str, algorithm: str, topo: Topology,
                     nbytes: int, *, policy: str | None = None):
    """(algorithm, schedule) that ``mpix_<collective>`` runs for a call of
    ``nbytes`` bytes a rank on ``topo``: ``"auto"`` resolved by the
    selector under ``policy`` (the process default when None), the
    schedule from the API's cache; None for ``"xla"``, the native
    collective.  For callers that execute the schedule themselves, e.g.
    on a global buffer through ``KernelTransport.run_global``."""
    algorithm = _algorithm(collective, algorithm, policy, topo, nbytes)
    if algorithm == "xla":
        return algorithm, None
    return algorithm, _schedule(collective, algorithm, topo)


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
    nbytes = x.numel() * x.element_size()

    def run(kind, algo):
        if algo == "xla":
            out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
            _all_gather(out, x, group)
            return out
        sched = _schedule("allgather", algo, topo)
        buf = x.new_zeros((n,) + tuple(x.shape))
        buf[rank] = x
        out = _transport(kind, topo, group).run(sched, buf)
        return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))

    return _execute("allgather", run,
                    algorithm=_algorithm("allgather", algorithm, policy,
                                         topo, nbytes),
                    transport=transport, resilience=resilience,
                    topo=topo, nbytes=nbytes, policy=policy)


def mpix_allreduce(x: torch.Tensor, group=None, *, algorithm: str = "auto",
                   policy: str | None = None, topo: Topology | None = None,
                   transport: str = "dist",
                   resilience=None) -> torch.Tensor:
    """Sum of ``x`` over the group, on every rank."""
    _check_call(transport, resilience)
    _, topo = _group_topology(group, topo)
    n = topo.nranks
    nbytes = x.numel() * x.element_size()

    def run(kind, algo):
        if algo == "xla":
            out = x.clone()
            dist.all_reduce(out, group=group)
            return out
        sched = _schedule("allreduce", algo, topo)
        flat = _pad_to(x, n)
        out = _transport(kind, topo, group).run(sched, flat.reshape(n, -1))
        return out.reshape(-1)[: x.numel()].reshape(x.shape)

    return _execute("allreduce", run,
                    algorithm=_algorithm("allreduce", algorithm, policy,
                                         topo, nbytes),
                    transport=transport, resilience=resilience,
                    topo=topo, nbytes=nbytes, policy=policy)


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
    nbytes = x.numel() * x.element_size()

    def run(kind, algo):
        if algo == "xla":
            out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
            fn = getattr(dist, "reduce_scatter_single", None) or \
                dist.reduce_scatter_tensor
            fn(out, x.contiguous(), group=group)
            return out
        sched = _schedule("reduce_scatter", algo, topo)
        blocks = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
        out = _transport(kind, topo, group).run(sched, blocks)
        return out[rank]

    return _execute("reduce_scatter", run,
                    algorithm=_algorithm("reduce_scatter", algorithm, policy,
                                         topo, nbytes),
                    transport=transport, resilience=resilience,
                    topo=topo, nbytes=nbytes, policy=policy)


def _alltoall_blocks(x: torch.Tensor, sched, n: int, rows: int):
    """[n, rows, ...] blocks, with a zeroed receive region appended for
    schedules that have one, as the schedules expect."""
    blocks = x.reshape((n, rows) + tuple(x.shape[1:]))
    if sched.num_blocks > n:          # schedules with a separate recv region
        pad = blocks.new_zeros((sched.num_blocks - n,)
                               + tuple(blocks.shape[1:]))
        blocks = torch.cat([blocks, pad], 0)
    return blocks


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
    nbytes = x.numel() * x.element_size()

    def run(kind, algo):
        if algo == "xla":
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x.contiguous(), group=group)
            return out
        sched = _schedule("alltoall", algo, topo)
        blocks = _alltoall_blocks(x, sched, n, x.shape[0] // n)
        out = _transport(kind, topo, group).run(sched, blocks)
        return out[: sched.result_blocks].reshape(x.shape)

    return _execute("alltoall", run,
                    algorithm=_algorithm("alltoall", algorithm, policy,
                                         topo, nbytes),
                    transport=transport, resilience=resilience,
                    topo=topo, nbytes=nbytes, policy=policy)


def mpix_alltoall_overlap(x: torch.Tensor, group, consume, init, *,
                          chunks: int = 0, compute_s: float = 0.0,
                          algorithm: str = "auto",
                          policy: str | None = None,
                          topo: Topology | None = None,
                          transport: str = "dist", resilience=None):
    """Partitioned (pipelined) alltoall: the exchange runs in row
    chunks and each chunk's output is folded through
    ``consume(carry, out_chunk, i) -> carry`` as soon as it lands, so a
    consumer can start on chunk ``i`` before the later chunks arrive
    (MPIPCL early-bird receive on the MoE dispatch path).

    ``out_chunk`` is the alltoall of the matching row slice of every
    block: shape [(n * rows/chunks), ...] with the usual alltoall block
    order.  ``chunks=0`` lets the model pick (``tuner.
    select_overlap_chunks`` prices the pipeline against ``compute_s``
    seconds of consumer compute); ``chunks=1`` is one ``mpix_alltoall``
    and one ``consume`` call.  Explicit ``chunks>1`` must divide the
    per-block row count.  ``resilience=`` arms the recovery ladder on
    the whole pipelined exchange."""
    _check_call(transport, resilience)
    _, topo = _group_topology(group, topo)
    n = topo.nranks
    nbytes = x.numel() * x.element_size()
    if x.shape[0] % n:
        raise ValueError(
            f"mpix_alltoall_overlap: leading dim {x.shape[0]} of input "
            f"shape {tuple(x.shape)} must be divisible by nranks={n} "
            f"(one block per destination rank)")
    if chunks < 0:
        raise ValueError(
            f"mpix_alltoall_overlap: chunks must be >= 0, got {chunks}")
    rows = x.shape[0] // n
    if chunks == 0:
        from repro_torch.core import tuner  # local: avoid import cycle
        chunks = tuner.select_overlap_chunks(
            topo, nbytes, compute_s, policy=policy or _DEFAULT_POLICY)
        while rows % chunks:          # auto-picked: clamp to a divisor
            chunks -= 1
    elif chunks > 1 and rows % chunks:
        raise ValueError(
            f"mpix_alltoall_overlap: per-block row count {rows} must "
            f"be divisible by chunks={chunks}")
    if chunks <= 1:
        return consume(init, mpix_alltoall(x, group, algorithm=algorithm,
                                           policy=policy, topo=topo,
                                           transport=transport,
                                           resilience=resilience), 0)
    rc = rows // chunks
    tail = tuple(x.shape[1:])

    def run(kind, algo):
        if algo == "xla":
            blocks = x.reshape((n, chunks, rc) + tail)
            carry = init
            for i in range(chunks):
                xi = blocks[:, i].reshape((n * rc,) + tail).contiguous()
                out = torch.empty_like(xi)
                dist.all_to_all_single(out, xi, group=group)
                carry = consume(carry, out, i)
            return carry
        sched = _schedule("alltoall", algo, topo)
        blocks = _alltoall_blocks(x, sched, n, rows)

        def fold(carry, out_c, i):
            return consume(carry, out_c[: sched.result_blocks]
                           .reshape((n * rc,) + tail), i)

        return _transport(kind, topo, group).run_chunked(
            sched, blocks, chunks=chunks, consume=fold, init=init)

    return _execute("alltoall", run,
                    algorithm=_algorithm("alltoall", algorithm, policy,
                                         topo, nbytes),
                    transport=transport, resilience=resilience,
                    topo=topo, nbytes=nbytes, policy=policy)


# ---------------------------------------------------------------------------
# neighborhood collectives (paper §2.2, Listing 3/4)
# ---------------------------------------------------------------------------


def make_neighbor_plan(graph, topo: Topology, *,
                       aggregate: bool | None = None,
                       policy: str | None = None,
                       elem_bytes: int | None = None):
    """Compile a persistent neighborhood-alltoallv plan (on the host,
    once).  ``aggregate=None`` resolves standard-vs-locality-aware via
    the selection policy ladder (process default when ``policy=None``).
    ``elem_bytes`` is the byte width of one value row (feat * itemsize)
    — it anchors the model comparison, so pass it whenever rows are
    wider than one float32."""
    from repro_torch.core.plan import ELEM_BYTES, build_plan
    return build_plan(graph, topo, aggregate=aggregate,
                      policy=policy or _DEFAULT_POLICY,
                      elem_bytes=ELEM_BYTES if elem_bytes is None
                      else elem_bytes)


def mpix_neighbor_alltoallv(x: torch.Tensor, group, plan, *,
                            transport: str = "dist",
                            resilience=None) -> torch.Tensor:
    """Execute a compiled ``NeighborPlan`` on every rank of ``group``.

    ``x`` is this rank's [n_local_max, feat] value rows; returns
    [n_recv_max, feat] (rows past this rank's recv size are zeros).
    Under ``resilience=`` the ladder walks the transports; a neighbor
    plan has no native collective to end on."""
    _check_call(transport, resilience)
    from repro_torch.core.plan import run_dist
    _group_topology(group, plan.topo)

    def run(kind, algo):
        return run_dist(plan, x, group, transport=kind)

    return _execute("neighbor_alltoallv", run, algorithm=plan.name,
                    transport=transport, resilience=resilience,
                    topo=plan.topo, nbytes=x.numel() * x.element_size(),
                    xla_ok=False)


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
    ``mpix_allreduce`` followed by the plain rmsnorm kernel.  Under
    ``resilience=`` a ``TransportError`` of the fused path degrades it
    to ``mpix_allreduce`` (resilient itself) then rmsnorm, with a
    report."""
    _check_call(transport, resilience)
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    _, topo = _group_topology(group, topo)
    transport = _resolve_transport(
        transport, topo, x.numel() * x.element_size(), policy)
    if transport == "kernel":
        try:
            parts = x.new_empty((topo.nranks,) + tuple(x.shape))
            _all_gather(parts.view((-1,) + tuple(x.shape[1:])), x, group)
            return rms_ops.rmsnorm_allreduce(parts, scale, eps, gemma_style)
        except TransportError as e:
            if resolve_resilience(resilience) is None:
                raise
            # degrade the fused kernel to allreduce-then-normalize and
            # surface the decision
            report = DegradationReport(
                schedule="allreduce_rmsnorm.fused", verify="off")
            report.attempts.append(Attempt(
                rung="kernel", algorithm="fused", attempt=0,
                outcome="fault", detail=str(e)))
            report.recovered_with = "dist"
            _DEGRADATIONS.append(report)
    y = mpix_allreduce(x, group, algorithm=algorithm, policy=policy,
                       topo=topo, transport="dist", resilience=resilience)
    return rms_ops.rmsnorm(y, scale, eps, gemma_style)


__all__ = [
    "mpix_allgather", "mpix_allreduce", "mpix_reduce_scatter",
    "mpix_alltoall", "mpix_alltoall_overlap", "mpix_allreduce_rmsnorm",
    "mpix_neighbor_alltoallv", "make_neighbor_plan",
    "set_default_policy", "get_default_policy", "ensure_tuned",
    "executor_cache_stats",
    "clear_executor_cache", "invalidate_topology", "TRANSPORTS",
    "set_chaos", "get_chaos", "last_degradation", "take_degradations",
    "UnrecoverableError", "DegradationReport",
]
