"""Empirical autotuned algorithm selection (the paper's §2.1 future work).

MPI Advance ships one fixed default per collective and names a "more
sophisticated selection process" as future work.  This module is that
process, done the way the collective-tuning literature (Hunold's
performance-guideline verification; the Wickramasinghe–Lumsdaine survey)
says it must be done: *measured*, per (collective, topology, size
bucket), with the resulting table checked against classic performance
guidelines and persisted for reuse.

Pipeline:

  1. ``tune(topo)`` times every registered ``Schedule`` on a live
     substrate — wall clock around a synchronized call, min over
     repeats, after one warm-up — or, when none can run ``topo``,
     prices it with the alpha-beta ``Schedule.modeled_time`` so a table
     always exists.  The substrates:

       * ``"dist"``   — every rank of a ``torch.distributed`` group of
         ``topo.nranks`` ranks (the default group) runs the ``mpix_*``
         collective on ``DistTransport``: gloo on the host, NCCL across
         cards.  The native collective (``algorithm="xla"``, the
         "system MPI" rung) is measured beside the schedules.  Every
         sample is reduced with ``all_reduce(MAX)`` before any argmin,
         so every rank holds the same table, bit for bit.
       * ``"kernel"`` — one card runs the whole schedule as one launch
         of the transport kernel (``KernelTransport.run_global``) on
         the global ``[nranks, slots, slot_elems]`` f32 buffer the API
         would build.  A CPU tensor would time the kernel's plain
         version, so without a card this substrate is not measurable.

     ``substrate=None`` picks "dist" when such a group exists, else
     "kernel" when a card does, else the model.
  2. ``verify_guidelines`` checks the table against self-consistency
     guidelines (allreduce <= reduce_scatter + allgather; per-algorithm
     monotonicity in message size; specialized <= generic on multi-pod
     topologies) and records violations *in* the table — a violated
     guideline is a finding about the substrate, not an error.
  3. ``save_table``/``load_table`` persist winners as JSON keyed by a
     substrate fingerprint (device kind, nranks, ranks_per_pod), so
     ``selector.select(..., policy="tuned")`` is a pure lookup.  The
     device kind names the substrate: ``cpu`` for a gloo group, the
     card's name for an NCCL group, the card's name and ``.kernel`` for
     the one-card kernel, ``model`` for model-priced tables — so no two
     of them share a key.  Model fingerprints are the reference
     package's, byte for byte.

Cache location: ``$REPRO_TORCH_TUNER_CACHE`` or
``~/.cache/repro_torch/tuned_collectives.json`` (never the reference
package's file: the two name their transports differently).

Caveat (multi-process): the winner is resolved from the local cache
file at call time.  All processes of one job must see the same cache
file (shared filesystem, or ship the table with the job) — otherwise
two processes can pick different algorithms for the same collective
and hang.  Tune once (every rank of a tuning group holds the same
table), distribute it, then launch.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

# the neighbor vocabulary is shared with the selection layer (one source)
from repro_torch.core.schedule import NotApplicable
from repro_torch.core.selector import NEIGHBOR, NEIGHBOR_MODES
from repro_torch.core.topology import Topology

COLLECTIVES = ("allgather", "allreduce", "reduce_scatter", "alltoall")
# non-dense paths tuned through the generic CommSchedule timer
PARTITIONED = "partitioned"
# pipelined compute-comm overlap (row-chunked alltoall + consumer
# compute, priced by the executor's makespan model)
OVERLAP = "overlap"
_OVERLAP_PARTS = (1, 2, 4, 8)
# transport substrate choice per size bucket: one batch_isend_irecv per
# compiled round ("dist") vs one all_gather and the whole schedule as
# one launch of the transport kernel ("kernel", core.kernel_lowering)
TRANSPORT = "transport"
_TRANSPORT_CHOICES = ("dist", "kernel")
# one collective/kernel dispatch worth of host-side overhead (s) — the
# per-round alpha the single-kernel lowering amortizes away.  A model
# default shared with the reference package, not a figure of any card.
_LAUNCH_S = 5e-6
DEFAULT_SIZES = (1 << 10, 1 << 14, 1 << 18, 1 << 22)   # bytes per rank
_ELEM = 4               # measurement payloads are float32
SUBSTRATES = ("dist", "kernel")


def default_cache_path() -> Path:
    env = os.environ.get("REPRO_TORCH_TUNER_CACHE")
    if env:
        return Path(env).expanduser()
    return Path("~/.cache/repro_torch/tuned_collectives.json").expanduser()


def size_bucket(nbytes: int) -> int:
    """log2 size bucket: bucket b covers (2**(b-1), 2**b] bytes.

    Degenerate 0/1-byte payloads clamp to bucket 0; negative sizes are
    a caller bug (a byte count can never be negative) and raise."""
    if nbytes < 0:
        raise ValueError(
            f"size_bucket: payload size must be >= 0 bytes, got {nbytes}")
    return max(0, int(max(1, nbytes) - 1).bit_length())


# ---------------------------------------------------------------------------
# substrates
# ---------------------------------------------------------------------------


def _world(topo: Topology):
    """The default process group when it spans ``topo.nranks`` ranks."""
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == topo.nranks):
        return dist.group.WORLD
    return None


def measurable_substrate(topo: Topology,
                         substrate: str | None = None) -> str | None:
    """The substrate ``tune`` would measure ``topo`` on, or None (the
    model).  ``substrate=None`` picks "dist" when the default group has
    ``topo.nranks`` ranks, else "kernel" when a card exists; a named
    substrate that cannot run here gives None.  (``force_model=True``
    is how a caller asks for the model.)"""
    if substrate not in (None,) + SUBSTRATES:
        raise ValueError(f"unknown substrate {substrate!r}; expected one "
                         f"of {SUBSTRATES}")
    if substrate in (None, "dist") and _world(topo) is not None:
        return "dist"
    if substrate in (None, "kernel") and torch.cuda.is_available():
        return "kernel"
    return None


def _device_kind(substrate: str) -> str:
    if substrate == "kernel":
        return f"{torch.cuda.get_device_name()}.kernel"
    if dist.get_backend() == "nccl":
        return torch.cuda.get_device_name()
    return "cpu"


def substrate_fingerprint(topo: Topology, *, force_model: bool = False,
                          substrate: str | None = None) -> str:
    """Fingerprint of what ``tune`` would measure on right now."""
    sub = None if force_model else measurable_substrate(topo, substrate)
    return topo.fingerprint("model" if sub is None else _device_kind(sub))


# ---------------------------------------------------------------------------
# table
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TunedTable:
    """Per-(collective, size-bucket) winners for one substrate.

    entries[collective][str(bucket)] = {
        "best": name, "nbytes": probed_size, "times": {name: seconds}}

    ``generation`` counts heal passes: every scoped re-measurement of
    guideline-violating cells (``retune_cells``) bumps it, so consumers
    can tell a freshly tuned table (0) from one that has been repaired.
    """

    fingerprint: str
    source: str                       # "measured" | "model"
    entries: dict
    violations: list = dataclasses.field(default_factory=list)
    generation: int = 0

    def lookup(self, collective: str, nbytes: int) -> str | None:
        """Winner for the bucket nearest to ``nbytes`` (None if absent)."""
        per = self.entries.get(collective)
        if not per:
            return None
        want = size_bucket(nbytes)
        bucket = min(per, key=lambda b: abs(int(b) - want))
        return per[bucket]["best"]

    def time_of(self, collective: str, nbytes: int,
                algorithm: str) -> float | None:
        per = self.entries.get(collective)
        if not per:
            return None
        want = size_bucket(nbytes)
        bucket = min(per, key=lambda b: abs(int(b) - want))
        return per[bucket]["times"].get(algorithm)

    def to_dict(self) -> dict:
        return {"fingerprint": self.fingerprint, "source": self.source,
                "entries": self.entries, "violations": self.violations,
                "generation": self.generation}

    @classmethod
    def from_dict(cls, d: dict) -> "TunedTable":
        return cls(fingerprint=d["fingerprint"], source=d["source"],
                   entries=d["entries"],
                   violations=list(d.get("violations", [])),
                   generation=int(d.get("generation", 0)))


def save_table(table: TunedTable, path: str | Path | None = None) -> Path:
    """Merge ``table`` into the fingerprint-keyed JSON cache file."""
    path = Path(path) if path is not None else default_cache_path()
    blob = {}
    if path.exists():
        try:
            blob = json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            blob = {}
    blob[table.fingerprint] = table.to_dict()
    path.parent.mkdir(parents=True, exist_ok=True)
    # pid-unique tmp + atomic replace guards against torn writes and
    # cross-process tmp collisions (concurrent writers still last-win
    # on the whole file — it is a cache, re-tuning is always safe)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(json.dumps(blob, indent=1, sort_keys=True))
    tmp.replace(path)
    _CACHE[table.fingerprint] = table
    return path


def load_table(fingerprint: str,
               path: str | Path | None = None) -> TunedTable | None:
    cached = _CACHE.get(fingerprint)
    if cached is not None:
        return None if cached is _MISS else cached
    path = Path(path) if path is not None else default_cache_path()
    blob = None
    if path.exists():
        try:
            blob = json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            blob = None
    if blob is None or fingerprint not in blob:
        # negative-cache the miss: tuned-policy selection on an untuned
        # substrate must not re-read the file per collective per call
        _CACHE[fingerprint] = _MISS
        return None
    table = TunedTable.from_dict(blob[fingerprint])
    _CACHE[fingerprint] = table
    return table


_MISS = object()
_CACHE: dict[str, object] = {}


def clear_cache() -> None:
    """Drop the in-process table cache (tests; after cache-file edits)."""
    _CACHE.clear()


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


class MeasurementTimeout(RuntimeError):
    """A timed execution overran its cooperative deadline (a hung
    round, an injected chaos stall).  Typed so probe/tuning callers can
    keep prior measurements and record the skip instead of wedging.
    On a group every rank raises it together, or none does."""


def _sync(substrate: str, group) -> None:
    if substrate == "kernel" or dist.get_backend(group) == "nccl":
        torch.cuda.synchronize()


def _agree(value: float, substrate: str, group) -> float:
    """The group's largest ``value`` (on "kernel", ``value``): what
    every rank then decides on is the same float, bit for bit."""
    if substrate != "dist":
        return value
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def _timed(fn, *, substrate: str, group, repeats: int, check) -> float:
    """Min over ``repeats`` of the wall clock around one synchronized
    ``fn()`` after one warm-up; each sample agreed over the group."""
    fn()                                   # build + warm the caches
    _sync(substrate, group)
    check("warmup")
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(substrate, group)
        best = min(best, _agree(time.perf_counter() - t0, substrate,
                                group))
        check("repeat")
    return best


def _deadline_check(what: str, deadline_s: float | None, substrate: str,
                    group):
    """The cooperative deadline: at each check point the overrun flag is
    agreed over the group, so every rank raises ``MeasurementTimeout``
    at the same point, or none does (a rank leaving alone would leave
    its peers blocked in the next exchange)."""
    if deadline_s is not None and deadline_s <= 0:
        raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
    start = time.perf_counter()

    def check(stage: str) -> None:
        if deadline_s is None:
            return
        dt = time.perf_counter() - start
        if _agree(float(dt > deadline_s), substrate, group):
            raise MeasurementTimeout(
                f"{what}: {stage} at {dt:.3f}s exceeded deadline "
                f"{deadline_s:.3f}s")
    return check


def _resolve(topo: Topology, substrate: str | None):
    """(substrate, group) for a measurement; raises when none can run."""
    sub = measurable_substrate(topo, substrate)
    if sub is None:
        raise RuntimeError(
            f"cannot measure {topo.nranks} ranks on substrate "
            f"{substrate or 'auto'}: need a process group of "
            f"{topo.nranks} ranks (dist) or a CUDA device (kernel)")
    return sub, (_world(topo) if sub == "dist" else None)


def _probe_spec(collective: str, topo: Topology, nbytes: int):
    """(local_rows, out_is_sharded) for a ~nbytes-per-rank payload."""
    n = topo.nranks
    elems = max(1, nbytes // _ELEM)
    if collective in ("allgather", "allreduce"):
        return elems, False
    # reduce_scatter / alltoall need a leading dim divisible by nranks
    return n * max(1, elems // n), True


def _slot_elems(collective: str, topo: Topology, rows: int) -> int:
    """Width of one slot of the buffer the ``mpix_*`` API builds for a
    ``rows``-float local payload (allgather: the payload; allreduce:
    padded to ``nranks`` slots; reduce_scatter/alltoall: one block)."""
    n = topo.nranks
    if collective == "allgather":
        return rows
    if collective == "allreduce":
        return -(-rows // n)
    return rows // n


def _measure(collective: str, algorithm: str, topo: Topology, nbytes: int,
             repeats: int, *, substrate: str | None = None) -> float:
    """Wall clock of one collective on a live substrate: the ``mpix_*``
    call on every rank of the group ("dist"), or its schedule on the
    API's global buffer as one kernel launch ("kernel")."""
    from repro_torch.core import api

    sub, group = _resolve(topo, substrate)
    rows, _ = _probe_spec(collective, topo, nbytes)
    if sub == "kernel":
        if algorithm == "xla":
            raise ValueError("the native collective needs a group "
                             "(substrate 'dist')")
        return measure_schedule(
            api._schedule(collective, algorithm, topo), topo,
            slot_elems=_slot_elems(collective, topo, rows), repeats=repeats,
            substrate="kernel")
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    x = torch.ones((rows,), dtype=torch.float32, device=dev)
    fn = getattr(api, f"mpix_{collective}")
    return _timed(lambda: fn(x, group, algorithm=algorithm, topo=topo,
                             transport="dist"),
                  substrate=sub, group=group, repeats=repeats,
                  check=lambda stage: None)


def _modeled(sched, topo: Topology, nbytes: int) -> float:
    """alpha-beta model of what would actually execute: the *compiled*
    schedule (post fusion, cost-model-armed with ``topo``), so
    model-source tables reward the same round-count cuts the measured
    path enjoys."""
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


def _compiled_rounds(sched, topo: Topology | None = None) -> dict:
    """Round counts through the persistent-executor compile pass
    (topology-armed when ``topo`` is given, matching the executor the
    measurement path looks up) — recorded next to every timing so the
    table shows *what executed*."""
    from repro_torch.core import executor

    ex = executor.get_executor(sched, topo=topo)
    return {"before": ex.rounds_before, "after": ex.rounds_after}


def _time_cell(collective: str, candidates: dict, topo: Topology,
               nbytes: int, *, measured: bool, repeats: int,
               include_xla: bool, substrate: str | None = None) -> dict:
    """Time every candidate for one (collective, size) cell.  The
    native collective joins the measured cell on "dist" only."""
    times: dict = {}
    rounds: dict = {}
    for name, sched in candidates.items():
        if measured:
            times[name] = _measure(collective, name, topo, int(nbytes),
                                   repeats, substrate=substrate)
        else:
            times[name] = _modeled(sched, topo, int(nbytes))
        rounds[name] = _compiled_rounds(sched, topo)
    if measured and include_xla and substrate == "dist":
        # the substrate's own collective — MPI Advance's "system MPI"
        times["xla"] = _measure(collective, "xla", topo, int(nbytes),
                                repeats, substrate=substrate)
    assert times, (collective, nbytes)
    return {"best": min(times, key=times.get), "nbytes": int(nbytes),
            "times": {k: float(v) for k, v in times.items()},
            "rounds": rounds}


# ---------------------------------------------------------------------------
# generic CommSchedule timing (any path: dense, neighbor, partitioned)
# ---------------------------------------------------------------------------


def measure_schedule(schedule, topo: Topology, *, slot_elems: int = 1,
                     repeats: int = 3, fill=None,
                     deadline_s: float | None = None,
                     substrate: str | None = None) -> float:
    """Wall clock of one ``CommSchedule`` on a live substrate: every rank
    of the default group runs its row on ``DistTransport`` ("dist"), or
    one card runs the global buffer as one launch of the transport
    kernel ("kernel").  Raises ``RuntimeError`` when neither can run.

    Works for every schedule the IR can express — dense block tables,
    neighborhood plans, partitioned transfers — which is what lets one
    tuner cover every path.  ``slot_elems`` is the float32 width of one
    buffer slot; ``fill`` optionally seeds the buffers
    (``[nranks * num_slots, ...]`` or ``[nranks, num_slots, ...]``).

    ``deadline_s`` bounds the WHOLE measurement (build + warm-up +
    repeats) cooperatively: overrun raises ``MeasurementTimeout`` at
    the next completion point instead of returning a poisoned sample —
    on a group, on every rank at the same point.
    """
    from repro_torch.core.transport import DistTransport, KernelTransport

    n = topo.nranks
    sub, group = _resolve(topo, substrate)
    check = _deadline_check(f"measure_schedule({schedule.name})",
                            deadline_s, sub, group)
    dev = "cuda" if sub == "kernel" or dist.get_backend(group) == "nccl" \
        else "cpu"
    if fill is None:
        g = torch.ones((n, schedule.num_slots, slot_elems),
                       dtype=torch.float32, device=dev)
    else:
        g = torch.as_tensor(fill).to(dev)
        g = g.reshape((n, schedule.num_slots) + tuple(g.shape[1:])
                      if g.shape[0] == n * schedule.num_slots
                      else tuple(g.shape))
    if sub == "kernel":
        tr = KernelTransport(n, topo=topo)
        fn = lambda: tr.run_global(schedule, g)          # noqa: E731
    else:
        tr = DistTransport(n, group, topo=topo)
        local = g[dist.get_rank(group)].contiguous()
        fn = lambda: tr.run(schedule, local)             # noqa: E731
    return _timed(fn, substrate=sub, group=group, repeats=repeats,
                  check=check)


def schedule_time(schedule, topo: Topology, *, slot_nbytes: int,
                  repeats: int = 3, force_model: bool = False,
                  substrate: str | None = None) -> float:
    """Time any CommSchedule: measured on a live substrate when one can
    run ``topo`` (which executes through the compiled/fused path),
    alpha-beta model of the *compiled* schedule otherwise — both
    branches price the same rounds."""
    sub = None if force_model else measurable_substrate(topo, substrate)
    if sub is not None:
        return measure_schedule(
            schedule, topo, slot_elems=max(1, slot_nbytes // _ELEM),
            repeats=repeats, substrate=sub)
    from repro_torch.core import executor
    return executor.get_executor(
        schedule, topo=topo).compiled_schedule.modeled_time(
            topo, slot_nbytes)


def verify_overhead_s(schedule, topo: Topology, *, slot_nbytes: int,
                      verify: str = "canary") -> float:
    """Modeled cost of ``core.resilient``'s per-run integrity check, so
    resilience is priced like any other knob the tuner owns.  A model,
    not a time measured on a card: it uses the topology module's
    ``HBM_BW`` model default (which fingerprint parity with the
    reference needs).

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


def tune(topo: Topology, *, collectives=COLLECTIVES, sizes=DEFAULT_SIZES,
         repeats: int = 3, include_xla: bool = True,
         force_model: bool = False, tol: float = 1.10,
         substrate: str | None = None) -> TunedTable:
    """Time every candidate per (collective, size bucket); return the table.

    Measures wall clock on ``substrate`` (``None``: see
    ``measurable_substrate``) when it can run ``topo``, else falls back
    to the alpha-beta model (and records ``source="model"`` so the
    fingerprint can never collide with a measured table).
    """
    sub = None if force_model else measurable_substrate(topo, substrate)
    entries: dict = {}
    for coll in collectives:
        candidates = _candidates(coll, topo)
        per: dict = {}
        for nbytes in sizes:
            per[str(size_bucket(int(nbytes)))] = _time_cell(
                coll, candidates, topo, int(nbytes),
                measured=sub is not None, repeats=repeats,
                include_xla=include_xla, substrate=sub)
        entries[coll] = per
    table = TunedTable(
        fingerprint=substrate_fingerprint(topo, force_model=force_model,
                                          substrate=substrate),
        source="measured" if sub is not None else "model",
        entries=entries)
    table.violations = verify_guidelines(table, topo, tol=tol)
    return table


# ---------------------------------------------------------------------------
# neighbor + partitioned paths (generic CommSchedule timing)
# ---------------------------------------------------------------------------


def tune_neighbor(topo: Topology, *, sizes=DEFAULT_SIZES, repeats: int = 3,
                  force_model: bool = False, graph=None, n_local: int = 8,
                  dup_frac: float = 0.5,
                  substrate: str | None = None) -> dict:
    """Per-size-bucket winners for the standard-vs-locality-aware choice.

    Times both compiled plans of a representative sparse exchange
    (seeded ``CommGraph.random`` unless ``graph`` is given) through the
    shared transports; buckets key on the exchange's total standard-plan
    byte volume, which is what ``selector.select_neighbor`` looks up.
    Returns the ``entries[NEIGHBOR]`` dict.
    """
    from repro_torch.core.plan import CommGraph, build_plan

    n = topo.nranks
    if graph is None:
        rng = np.random.default_rng(0)
        graph = CommGraph.random(n, n_local=n_local,
                                 degree=min(n - 1, 4), rng=rng,
                                 dup_frac=dup_frac)
    total_rows = graph.total_values()
    plans = {mode: build_plan(graph, topo,
                              aggregate=mode == "locality_aware")
             for mode in NEIGHBOR_MODES}
    per: dict = {}
    for nbytes in sizes:
        # max(1, ...) guards degenerate exchanges (a 1-rank topology's
        # random graph has no edges -> zero value rows)
        slot_nbytes = _ELEM * max(1, int(nbytes) // max(1, total_rows * _ELEM))
        times = {
            mode: schedule_time(plan.schedule, topo,
                                slot_nbytes=slot_nbytes, repeats=repeats,
                                force_model=force_model, substrate=substrate)
            for mode, plan in plans.items()
        }
        # key on the requested probe size (like every other path) so two
        # sizes never collapse into one bucket when slot_nbytes floors
        # on a large graph; "nbytes" records the actual probed volume
        per[str(size_bucket(int(nbytes)))] = {
            "best": min(times, key=times.get),
            "nbytes": total_rows * slot_nbytes,
            "times": {k: float(v) for k, v in times.items()},
            "rounds": {mode: _compiled_rounds(plan.schedule, topo)
                       for mode, plan in plans.items()},
        }
    return per


def tune_partitioned(topo: Topology, *, sizes=DEFAULT_SIZES,
                     repeats: int = 3, force_model: bool = False,
                     substrate: str | None = None) -> dict:
    """Per-size-bucket winners for the MPIPCL partition-count choice
    (REGISTRY["partitioned"]: p1/p2/p4/p8 chunked shifts)."""
    from repro_torch.core.algorithms import REGISTRY

    per: dict = {}
    for nbytes in sizes:
        times: dict = {}
        rounds: dict = {}
        for name, builder in REGISTRY[PARTITIONED].items():
            sched = builder(topo)
            chunks = sched.result_slots
            slot_nbytes = max(1, int(nbytes) // chunks)
            times[name] = schedule_time(
                sched, topo, slot_nbytes=slot_nbytes, repeats=repeats,
                force_model=force_model, substrate=substrate)
            rounds[name] = _compiled_rounds(sched, topo)
        per[str(size_bucket(int(nbytes)))] = {
            "best": min(times, key=times.get),
            "nbytes": int(nbytes),
            "times": {k: float(v) for k, v in times.items()},
            "rounds": rounds,
        }
    return per


def tune_overlap(topo: Topology, *, sizes=DEFAULT_SIZES,
                 repeats: int = 3, force_model: bool = False,
                 compute_ratio: float = 1.0,
                 substrate: str | None = None) -> dict:
    """Per-size-bucket chunk counts for pipelined alltoall + consumer
    compute (``mpix_alltoall_overlap``): each candidate pK prices the
    row-chunked software pipeline via the armed executor's
    ``chunked_makespan`` — per-chunk transfer overlapping the previous
    chunk's compute slice — against ``compute_ratio`` * the serial
    transfer time of consumer compute.  p1 is the unpipelined serial
    baseline and wins ties, so the committed choice can never lose to
    it (the ``pipelined <= armed`` guideline below re-verifies this on
    every load).  Pricing is purely the makespan model — overlap is a
    scheduling property a wall clock around the exchange alone cannot
    observe — so ``repeats``/``force_model``/``substrate`` are accepted
    only for signature uniformity with the other tune_* entries."""
    del repeats, force_model, substrate
    from repro_torch.core import executor

    cands = _candidates("alltoall", topo)
    per: dict = {}
    for nbytes in sizes:
        name = min(cands,
                   key=lambda a: _modeled(cands[a], topo, int(nbytes)))
        sched = cands[name]
        block = max(1, int(nbytes) // max(1, sched.num_blocks))
        ex = executor.get_executor(sched, topo=topo)
        compute_s = (ex.compiled_schedule.modeled_time(topo, block)
                     * compute_ratio)
        times = {f"p{p}": float(ex.chunked_makespan(block, p, compute_s))
                 for p in _OVERLAP_PARTS}
        best = min(times, key=lambda k: (times[k], int(k[1:])))
        per[str(size_bucket(int(nbytes)))] = {
            "best": best,
            "nbytes": int(nbytes),
            "times": times,
            "schedule": name,
            "compute_s": float(compute_s),
        }
    return per


def _transport_times(topo: Topology, nbytes: int) -> dict:
    """Model both substrates for one payload size, on the MoE hot path's
    collective (alltoall — the same representative ``tune_overlap``
    prices).

    dist: armed modeled transfer time + one launch per compiled round.
    kernel: one all_gather of the full per-rank buffer (the bandwidth
    cost of replicated execution: block = nbytes, not nbytes/n) + one
    collective launch + one kernel launch.  The crossover is real:
    alpha-dominated small buckets amortize R launches into 2,
    beta-dominated large ones pay the n× gather."""
    from repro_torch.core import executor

    cands = _candidates("alltoall", topo)
    name = min(cands, key=lambda a: _modeled(cands[a], topo, int(nbytes)))
    sched = cands[name]
    ex = executor.get_executor(sched, topo=topo)
    block = max(1, int(nbytes) // max(1, sched.num_blocks))
    t_dist = (ex.compiled_schedule.modeled_time(topo, block)
              + ex.rounds_after * _LAUNCH_S)
    ag = _candidates("allgather", topo)
    t_gather = min(_modeled(ag[a], topo, int(nbytes) * topo.nranks)
                   for a in ag)
    t_kernel = t_gather + 2 * _LAUNCH_S
    return {"schedule": name, "rounds": int(ex.rounds_after),
            "times": {"dist": float(t_dist), "kernel": float(t_kernel)}}


def _transport_best(times: dict) -> str:
    # ties go to dist (never pay the n× gather for free)
    return min(_TRANSPORT_CHOICES, key=lambda k: (times[k], k != "dist"))


def tune_transport(topo: Topology, *, sizes=DEFAULT_SIZES,
                   repeats: int = 3, force_model: bool = False,
                   substrate: str | None = None) -> dict:
    """Per-size-bucket transport winners (``transport="auto"`` in the
    mpix_* API).  Pricing is purely the alpha-beta + launch model: the
    two transports run on different substrates (a group of ranks, one
    card), so no one wall clock times both — ``repeats``/
    ``force_model``/``substrate`` are accepted only for signature
    uniformity with the other tune_* entries."""
    del repeats, force_model, substrate
    per: dict = {}
    for nbytes in sizes:
        cell = _transport_times(topo, int(nbytes))
        times = cell["times"]
        per[str(size_bucket(int(nbytes)))] = {
            "best": _transport_best(times),
            "nbytes": int(nbytes),
            "times": times,
            "schedule": cell["schedule"],
            "rounds": cell["rounds"],
        }
    return per


def _load_for(topo: Topology, path) -> TunedTable | None:
    """The persisted table for this substrate, else the model's."""
    for fp in (substrate_fingerprint(topo), topo.fingerprint("model")):
        table = load_table(fp, path=path)
        if table is not None:
            return table
    return None


def select_transport(topo: Topology, nbytes: int, *,
                     policy: str | None = None,
                     table: TunedTable | None = None,
                     path: str | Path | None = None) -> str:
    """Substrate for ``transport="auto"``: "dist" or "kernel".

    policy "fixed" always returns "dist" (the pre-device-side default);
    "tuned" reads the persisted ``TRANSPORT`` winner (falling back to
    the model when no table/section exists); anything else prices both
    substrates with the launch-aware model."""
    if policy == "fixed":
        return "dist"
    if policy == "tuned":
        if table is None:
            table = _load_for(topo, path)
        if table is not None:
            name = table.lookup(TRANSPORT, int(nbytes))
            if name in _TRANSPORT_CHOICES:
                return name
        # no table / no TRANSPORT section: fall through to model pricing
    return _transport_best(_transport_times(topo, int(nbytes))["times"])


def select_overlap_chunks(topo: Topology, nbytes: int, compute_s: float,
                          *, policy: str | None = None,
                          table: TunedTable | None = None,
                          path: str | Path | None = None) -> int:
    """Chunk count for ``mpix_alltoall_overlap``'s auto mode.

    policy "tuned" reads the persisted ``OVERLAP`` winner for this
    substrate (falling back to model pricing when no table exists);
    "fixed" always returns 1 (unpipelined — the paper-default ladder
    rung); anything else prices the software pipeline with the CALLER's
    ``compute_s`` through ``chunked_makespan`` and returns the argmin
    over p in {1, 2, 4, 8} (ties to the smallest — never pipeline for
    free)."""
    if policy == "fixed":
        return 1
    if policy == "tuned":
        if table is None:
            table = _load_for(topo, path)
        if table is not None:
            name = table.lookup(OVERLAP, int(nbytes))
            if (isinstance(name, str) and len(name) > 1
                    and name[0] == "p" and name[1:].isdigit()):
                return max(1, int(name[1:]))
        # no table / no OVERLAP section: fall through to model pricing
    from repro_torch.core import executor

    cands = _candidates("alltoall", topo)
    name = min(cands, key=lambda a: _modeled(cands[a], topo, int(nbytes)))
    sched = cands[name]
    block = max(1, int(nbytes) // max(1, sched.num_blocks))
    ex = executor.get_executor(sched, topo=topo)
    return min(_OVERLAP_PARTS,
               key=lambda p: (ex.chunked_makespan(block, p, compute_s), p))


def autotune(topo: Topology, *, path: str | Path | None = None,
             sizes=DEFAULT_SIZES, repeats: int = 3,
             force_model: bool = False, tol: float = 1.10,
             include_xla: bool = True,
             substrate: str | None = None) -> TunedTable:
    """Tune every path — dense collectives, the neighborhood
    standard-vs-locality-aware crossover, partitioned chunk counts,
    overlap chunking and the transport choice — into one persisted
    table for this substrate.

    This is the one-stop entry the launchers call: after it returns,
    ``policy="tuned"`` resolves every mpix_* collective *and*
    ``build_plan(..., aggregate=None)`` from the table's winners.
    """
    kw = dict(sizes=sizes, repeats=repeats, force_model=force_model,
              substrate=substrate)
    table = tune(topo, include_xla=include_xla, tol=tol, **kw)
    table.entries[NEIGHBOR] = tune_neighbor(topo, **kw)
    table.entries[PARTITIONED] = tune_partitioned(topo, **kw)
    table.entries[OVERLAP] = tune_overlap(topo, **kw)
    table.entries[TRANSPORT] = tune_transport(topo, **kw)
    table.violations = verify_guidelines(table, topo, tol=tol)
    save_table(table, path=path)
    return table


# ---------------------------------------------------------------------------
# performance guidelines (Hunold-style self-consistency checks)
# ---------------------------------------------------------------------------


def _guideline_findings(table: TunedTable, topo: Topology | None = None,
                        *, tol: float = 1.10) -> list:
    """Guideline check core: list of (message, offending-cells) pairs.

    A cell is a ``(collective, bucket)`` key into ``table.entries`` —
    the unit the auto-retune loop re-measures (``retune_cells``).
    """
    out: list = []
    e = table.entries

    def best(coll, bucket):
        rec = e.get(coll, {}).get(bucket)
        return rec["times"][rec["best"]] if rec else None

    # composition: allreduce <= reduce_scatter + allgather, per bucket
    shared = (set(e.get("allreduce", {}))
              & set(e.get("reduce_scatter", {}))
              & set(e.get("allgather", {})))
    for b in sorted(shared, key=int):
        ar, rs, ag = (best("allreduce", b), best("reduce_scatter", b),
                      best("allgather", b))
        if ar is not None and ar > tol * (rs + ag):
            out.append((
                f"allreduce>rs+ag @bucket {b}: {ar:.3e} > "
                f"{rs:.3e}+{ag:.3e} (guideline: composed implementation "
                f"bounds the specialized one)",
                (("allreduce", b), ("reduce_scatter", b),
                 ("allgather", b))))

    # monotonicity in message size, per (collective, algorithm)
    for coll, per in e.items():
        buckets = sorted(per, key=int)
        for lo, hi in zip(buckets, buckets[1:]):
            for name, t_lo in per[lo]["times"].items():
                t_hi = per[hi]["times"].get(name)
                if t_hi is not None and t_lo > tol * t_hi:
                    out.append((
                        f"{coll}.{name} non-monotone: bucket {lo} "
                        f"({t_lo:.3e}s) > bucket {hi} ({t_hi:.3e}s)",
                        ((coll, lo), (coll, hi))))

    # specialized <= generic on multi-pod substrates (largest bucket):
    # the 2-level hierarchical variant on any multi-pod topology, and
    # the fully level-aware staged variant on 3+-level hierarchies.
    if topo is not None and topo.npods > 1:
        from repro_torch.core.selector import _FIXED
        specialized = ["hierarchical"]
        if len(topo.levels) >= 3:
            specialized.append("staged")
        for coll, per in e.items():
            if not per or coll not in _FIXED:
                continue
            b = max(per, key=int)
            times = per[b]["times"]
            flat_default = _FIXED[coll][0]
            for name in specialized:
                if (name in times and flat_default in times
                        and times[name] > tol * times[flat_default]):
                    out.append((
                        f"{coll}.{name} slower than flat "
                        f"{flat_default} @bucket {b} on multi-pod topo "
                        f"({times[name]:.3e} > "
                        f"{times[flat_default]:.3e})",
                        ((coll, b),)))

    # neighbor: aggregate <= standard on multi-pod (largest bucket)
    if topo is not None and topo.npods > 1 and e.get(NEIGHBOR):
        per = e[NEIGHBOR]
        b = max(per, key=int)
        times = per[b]["times"]
        if ("locality_aware" in times and "standard" in times
                and times["locality_aware"] > tol * times["standard"]):
            out.append((
                f"{NEIGHBOR}.locality_aware slower than standard "
                f"@bucket {b} on multi-pod topo "
                f"({times['locality_aware']:.3e} > "
                f"{times['standard']:.3e})",
                ((NEIGHBOR, b),)))

    # overlap: the committed pipelined plan never loses to the serial
    # p1 baseline (pipelined <= armed, the new rung of the chain; pK
    # entries MAY exceed p1 — alpha-dominated sizes lose to chunking
    # and the selection simply keeps p1, which is not a violation)
    for b, rec in sorted(e.get(OVERLAP, {}).items(),
                         key=lambda kv: int(kv[0])):
        t_best = rec["times"].get(rec["best"])
        t_p1 = rec["times"].get("p1")
        if (t_best is not None and t_p1 is not None
                and t_best > tol * t_p1):
            out.append((
                f"{OVERLAP}.{rec['best']} slower than unpipelined p1 "
                f"@bucket {b} ({t_best:.3e} > {t_p1:.3e}) (guideline: "
                f"pipelined <= armed serial)",
                ((OVERLAP, b),)))
    return out


def verify_guidelines(table: TunedTable, topo: Topology | None = None,
                      *, tol: float = 1.10) -> list:
    """Return human-readable violations of classic performance guidelines.

    Checked (each with ``tol`` relative slack):
      * composition:   allreduce(s) <= reduce_scatter(s) + allgather(s)
      * monotonicity:  per algorithm, time never decreases with size
      * specialized <= generic: on multi-pod topologies the
        locality-aware ``hierarchical`` variant (and, on 3+-level
        hierarchies, the ``staged`` variant) should not lose to the
        flat default for the largest probed bucket
      * neighbor aggregation: on multi-pod topologies the
        locality-aware plan should not lose to the standard plan for
        the largest probed bucket (aggregate <= standard)
      * overlap: per bucket, the committed pipelined chunk count never
        loses to the unpipelined p1 baseline (pipelined <= armed)
    """
    return [msg for msg, _ in _guideline_findings(table, topo, tol=tol)]


def violation_cells(table: TunedTable, topo: Topology | None = None,
                    *, tol: float = 1.10) -> list:
    """Unique (collective, bucket) cells implicated in any guideline
    violation, in finding order — the auto-retune work list."""
    cells, seen = [], set()
    for _, cs in _guideline_findings(table, topo, tol=tol):
        for cell in cs:
            if cell not in seen:
                seen.add(cell)
                cells.append(cell)
    return cells


# ---------------------------------------------------------------------------
# selection entry point (used by selector.select(policy="tuned"))
# ---------------------------------------------------------------------------


def tuned_select(collective: str, topo: Topology, nbytes: int,
                 table: TunedTable | None = None,
                 path: str | Path | None = None) -> str | None:
    """Winner from the persisted table, or None when no table applies.

    Tries the measured-substrate fingerprint first, then the model
    fingerprint.  The winner is validated against the live registry (a
    stale table naming a removed algorithm is ignored).
    """
    if table is None:
        table = _load_for(topo, path)
    if table is None:
        return None
    name = table.lookup(collective, nbytes)
    if name is None or name == "xla":
        return name
    if collective == NEIGHBOR:
        return name if name in NEIGHBOR_MODES else None
    # registry-membership check only: the fingerprint guarantees the
    # table's topology matches the query, so the winner built for it at
    # tuning time — only a renamed/removed algorithm can be stale here
    from repro_torch.core.algorithms import REGISTRY
    if name not in REGISTRY.get(collective, {}):
        return None
    return name


def stale_cells(table: TunedTable, topo: Topology) -> list:
    """Cells missing a currently-registered candidate: the table was
    tuned before that algorithm landed (or before a neighbor mode /
    partition count was added), so its winners never saw the newcomer.
    These join the heal work list alongside guideline violations.

    Cost discipline: the registry name diff runs first, and only names
    absent from a cell are test-built — a name that raises
    ``NotApplicable`` on this topology (pow2-only variants on odd rank
    counts) is permanently inapplicable, not stale.  A healthy table
    never constructs a full candidate set here."""
    from repro_torch.core.algorithms import REGISTRY

    out = []
    for coll, per in table.entries.items():
        if coll in COLLECTIVES:
            registered = set(REGISTRY[coll])
            buildable: dict = {}          # name -> builds on this topo?
            for bucket, rec in per.items():
                stale = False
                for name in registered - set(rec["times"]):
                    if name not in buildable:
                        try:
                            REGISTRY[coll][name](topo)
                            buildable[name] = True
                        except NotApplicable:
                            buildable[name] = False
                    stale = stale or buildable[name]
                if stale:
                    out.append((coll, bucket))
            continue
        if coll == NEIGHBOR:
            want = set(NEIGHBOR_MODES)
        elif coll == PARTITIONED:
            want = set(REGISTRY[PARTITIONED])
        elif coll == OVERLAP:
            want = {f"p{p}" for p in _OVERLAP_PARTS}
        elif coll == TRANSPORT:
            want = set(_TRANSPORT_CHOICES)
        else:
            continue
        for bucket, rec in per.items():
            if want - set(rec["times"]):
                out.append((coll, bucket))
    return out


def _cell_differs(fresh: dict, rec: dict, tol: float) -> bool:
    """Selection-meaningful difference between two timings of one cell:
    a different winner, a different candidate set, or any timing moved
    by more than the guideline slack ``tol`` (so measurement noise on a
    live substrate does not count a re-confirmed cell as changed)."""
    if fresh["best"] != rec["best"]:
        return True
    if set(fresh["times"]) != set(rec["times"]):
        return True
    for name, t in fresh["times"].items():
        old = rec["times"][name]
        if t > old * tol or old > t * tol:
            return True
    return False


_PATHS = {NEIGHBOR: tune_neighbor, PARTITIONED: tune_partitioned,
          OVERLAP: tune_overlap, TRANSPORT: tune_transport}


def _model_cell(coll: str, topo: Topology, nbytes: int) -> dict | None:
    """Model-priced timing of one (collective, size) cell under ``topo``
    — the cheap probe ``drift_cells`` uses to ask "would this cell's
    selection change under the new links?" without re-measuring."""
    if coll in COLLECTIVES:
        return _time_cell(coll, _candidates(coll, topo), topo, nbytes,
                          measured=False, repeats=1, include_xla=False)
    if coll not in _PATHS:
        return None
    tuned = _PATHS[coll](topo, sizes=(nbytes,), repeats=1, force_model=True)
    return next(iter(tuned.values()))


def drift_cells(table: TunedTable, old_topo: Topology, new_topo: Topology,
                *, tol: float = 1.10) -> list:
    """Cells of ``table`` whose selection the link-model drift from
    ``old_topo`` to ``new_topo`` could plausibly move — the scoped
    re-measurement work list for the online healing daemon.

    Every cell is priced TWICE through the alpha-beta model (cheap —
    the executors are cached), once per geometry, and included iff the
    two pricings differ selection-meaningfully (``_cell_differs``: best
    flipped, candidate set changed, or any timing beyond ``tol``).
    Comparing model-vs-model isolates the drift's effect: comparing a
    fresh model pricing against a recorded *measured* timing would flag
    every cell on every tick.  A beta-only DCN degradation therefore
    leaves alpha-dominated small buckets (and DCN-free collectives) off
    the list entirely — the "no full re-tune" guarantee.
    """
    out = []
    for coll, per in table.entries.items():
        for bucket, rec in sorted(per.items(), key=lambda kv: int(kv[0])):
            nbytes = int(rec["nbytes"])
            old_cell = _model_cell(coll, old_topo, nbytes)
            new_cell = _model_cell(coll, new_topo, nbytes)
            if old_cell is None or new_cell is None:
                continue
            if _cell_differs(new_cell, old_cell, tol):
                out.append((coll, bucket))
    return out


def retune_cells(table: TunedTable, topo: Topology, cells,
                 *, repeats: int = 3, force_model: bool = False,
                 include_xla: bool = True, tol: float = 1.10,
                 substrate: str | None = None) -> list:
    """Scoped auto-retune: re-measure ONLY the given (collective,
    bucket) cells of ``table`` in place, at each cell's recorded probe
    size; untouched cells keep their timings.  Re-verifies the
    guidelines and returns the cells whose entries meaningfully changed
    (see ``_cell_differs``); ``generation`` is bumped iff any did — so
    a violation the substrate genuinely exhibits, re-confirmed within
    noise on every heal, is recorded as a finding without inflating the
    generation or churning the persisted file.

    This is the Hunold loop's repair step: a guideline violation is a
    finding about *specific* table cells (stale after a driver update,
    a noisy measurement, a topology drift), so healing re-measures those
    cells instead of throwing away the whole table.
    """
    sub = None if force_model else measurable_substrate(topo, substrate)
    dense_candidates: dict = {}       # full sets, built once per coll
    retuned: list = []
    for coll, bucket in cells:
        rec = table.entries.get(coll, {}).get(bucket)
        if rec is None:
            continue
        nbytes = int(rec["nbytes"])
        if coll in COLLECTIVES:
            if coll not in dense_candidates:
                dense_candidates[coll] = _candidates(coll, topo)
            fresh = _time_cell(coll, dense_candidates[coll], topo, nbytes,
                               measured=sub is not None, repeats=repeats,
                               include_xla=include_xla, substrate=sub)
        elif coll in _PATHS:
            fresh = next(iter(_PATHS[coll](
                topo, sizes=(nbytes,), repeats=repeats,
                force_model=force_model, substrate=substrate).values()))
        else:
            continue
        if _cell_differs(fresh, rec, tol):
            table.entries[coll][bucket] = fresh
            retuned.append((coll, bucket))
    if retuned:
        table.generation += 1
    table.violations = verify_guidelines(table, topo, tol=tol)
    return retuned


def heal_table(table: TunedTable, topo: Topology, *,
               path: str | Path | None = None, repeats: int = 3,
               force_model: bool = False, include_xla: bool = True,
               tol: float = 1.10, substrate: str | None = None) -> list:
    """Verify-and-repair one loaded table: re-measure only the
    guideline-violating cells plus any cells missing a currently
    registered candidate (``stale_cells`` — tables tuned before a new
    algorithm landed), persisting iff something meaningfully changed.
    Returns the changed cells.  Shared by ``ensure_table`` and the
    launchers' ``--autotune`` reuse path."""
    cells = violation_cells(table, topo, tol=tol)
    seen = set(cells)
    cells += [c for c in stale_cells(table, topo) if c not in seen]
    if not cells:
        return []
    changed = retune_cells(table, topo, cells, repeats=repeats,
                           force_model=force_model,
                           include_xla=include_xla, tol=tol,
                           substrate=substrate)
    if changed:
        save_table(table, path=path)
    return changed


def ensure_table(topo: Topology, *, path: str | Path | None = None,
                 heal: bool = True, collectives=COLLECTIVES,
                 sizes=DEFAULT_SIZES, repeats: int = 3,
                 include_xla: bool = True, force_model: bool = False,
                 tol: float = 1.10,
                 substrate: str | None = None) -> TunedTable:
    """Load the table for the current substrate, tuning once if missing.

    With ``heal=True`` (default) a loaded table is re-verified against
    the performance guidelines (plus candidate coverage); any violation
    triggers ``retune_cells`` on only the offending (collective,
    size-bucket) cells — never a full re-tune — and the healed table is
    persisted with a bumped ``generation``.
    """
    fp = substrate_fingerprint(topo, force_model=force_model,
                               substrate=substrate)
    table = load_table(fp, path=path)
    if table is None:
        table = tune(topo, collectives=collectives, sizes=sizes,
                     repeats=repeats, include_xla=include_xla,
                     force_model=force_model, tol=tol, substrate=substrate)
        save_table(table, path=path)
        return table
    if heal:
        heal_table(table, topo, path=path, repeats=repeats,
                   force_model=force_model, include_xla=include_xla,
                   tol=tol, substrate=substrate)
    return table


# ---------------------------------------------------------------------------
# CLI: PYTHONPATH=src python -m repro_torch.core.tuner --nranks 8 \
#          --ranks-per-pod 4 [--substrate kernel | --model]
# ---------------------------------------------------------------------------


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="tune collective algorithm selection for one topology "
                    "(on the card's transport kernel when one exists, "
                    "else priced by the alpha-beta model)")
    ap.add_argument("--nranks", type=int, default=8)
    ap.add_argument("--ranks-per-pod", type=int, default=None)
    ap.add_argument("--sizes", default=None,
                    help="comma list of per-rank byte counts")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--substrate", default=None, choices=("kernel",),
                    help="what to measure on (default: the card's "
                         "transport kernel when there is a card, else "
                         "the model)")
    ap.add_argument("--model", action="store_true",
                    help="force the alpha-beta model (no device needed)")
    ap.add_argument("--dense-only", action="store_true",
                    help="skip the neighbor/partitioned paths")
    ap.add_argument("--out", default=None, help="cache file to write")
    args = ap.parse_args(argv)

    topo = Topology(nranks=args.nranks,
                    ranks_per_pod=args.ranks_per_pod or args.nranks)
    sizes = (tuple(int(s) for s in args.sizes.split(","))
             if args.sizes else DEFAULT_SIZES)
    kw = dict(sizes=sizes, repeats=args.repeats, force_model=args.model,
              substrate=args.substrate)
    t0 = time.perf_counter()
    if args.dense_only:
        table = tune(topo, **kw)
        path = save_table(table, path=args.out)
    else:
        table = autotune(topo, path=args.out, **kw)
        path = default_cache_path() if args.out is None else Path(args.out)
    dt = time.perf_counter() - t0
    print(f"fingerprint {table.fingerprint} ({table.source}, "
          f"generation {table.generation}) -> {path} ({dt:.2f} s)")
    for coll, per in table.entries.items():
        for b in sorted(per, key=int):
            rec = per[b]
            print(f"  {coll:15s} bucket {b:>3s} ({rec['nbytes']:>9d}B) "
                  f"-> {rec['best']:28s} "
                  f"{rec['times'][rec['best']] * 1e6:10.1f} us")
    for v in table.violations:
        print(f"  GUIDELINE VIOLATION: {v}")
    if not table.violations:
        print("  all performance guidelines hold")
    return table


if __name__ == "__main__":
    main()
