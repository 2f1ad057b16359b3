"""Wire-measured link models: probe the fabric, not the datasheet.

The tuned tables and the armed/pipelined executor passes price rounds
with the per-level alpha-beta ``LinkModel``s carried by ``Topology`` —
which, until this module, were the ICI/DCN *datasheet constants*
whenever the host could not measure (and even measured tables kept the
model constants inside the executor's cost passes).  The collective-
tuning literature is unambiguous that this is the gap: offline-tuned
tables go stale the moment the fabric degrades (Wickramasinghe &
Lumsdaine's survey names online re-measurement as the open problem;
Hunold's guideline verification gives the repair loop a trigger).

This module is the measurement pass:

  * ``pingpong_schedule`` / ``injection_schedule`` — tiny probe
    ``CommSchedule``s per topology level, built from the same
    ``make_round`` IR every collective uses, so probes execute through
    the existing transports (``DistTransport`` on a group of
    ``topo.nranks`` ranks, alpha-beta pricing otherwise) and measure
    exactly the path real rounds take.
  * ``fit_link_model`` — least-squares (alpha, beta) from (nbytes,
    seconds) samples, rejecting non-finite/negative fits at the source.
  * ``probe_links`` — run the probes over a size sweep per level and
    fit one ``LinkModel`` per level; ``measured_topology`` rebuilds the
    ``Topology`` around the fitted links, so ``fingerprint()`` emits
    the ``lm[...]`` override section and every tuned table / executor
    cache entry derived from it is keyed by *measured* geometry.
  * ``drifted_levels`` — noise-tolerant drift detection between two
    probe passes (the ratio rule ``tuner._cell_differs`` uses), the
    trigger for the online healing daemon (runtime.tuning_daemon).

Timers are injectable: ``timer(level, nbytes) -> seconds`` for one
one-way single-message transfer.  ``wire_timer`` measures through
``DistTransport`` on the group (gloo on the host, NCCL across cards);
``model_timer`` prices the same probe schedules from the alpha-beta
model (optionally through a fault injector that degrades specific
levels — the deterministic substrate for drift tests and the healing
leg).  One card holds no wire: there the probe pass prices with the
model and says so in its ``source``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math
from typing import Callable, Mapping, Sequence

import time

from repro_torch.core.schedule import CommSchedule, make_round
from repro_torch.core.topology import LinkModel, TopoLevel, Topology

# Per-rank probe payloads: one alpha-dominated size and one
# beta-dominated size pin both coefficients of the postal model.
DEFAULT_PROBE_SIZES = (1 << 10, 1 << 20)
_ELEM = 4                        # probe payloads are float32

Timer = Callable[[int, int], float]


# ---------------------------------------------------------------------------
# probe schedules (the unified IR; executed by the shared transports)
# ---------------------------------------------------------------------------


def _level_peer(topo: Topology, level: int, step: int = 1) -> int:
    """Rank differing from rank 0 only at ``level`` (coordinate =
    ``step``) — the canonical single-link partner for that level."""
    coords = [0] * len(topo.levels)
    coords[level] = step
    return topo.rank_of(coords)


def pingpong_schedule(topo: Topology, level: int) -> CommSchedule:
    """Two-round RTT probe across one link of ``level``: rank 0 sends
    slot 0 to its level peer, the peer sends it back.  Half the
    schedule time is one one-way single-message transfer — the classic
    ping-pong microbenchmark, expressed in the collective IR so it
    executes through the exact transport path real rounds take."""
    if not 0 <= level < len(topo.levels):
        raise ValueError(f"level {level} out of range for "
                         f"{len(topo.levels)} levels")
    if topo.levels[level].size < 2:
        raise ValueError(
            f"level {topo.levels[level].name!r} has size "
            f"{topo.levels[level].size}; nothing to probe")
    peer = _level_peer(topo, level)
    n = topo.nranks
    out = make_round(n, [(0, peer)], {0: [0]}, {peer: [0]})
    back = make_round(n, [(peer, 0)], {peer: [0]}, {0: [0]})
    return CommSchedule(
        nranks=n, num_slots=1, rounds=(out, back),
        name=f"probe_pingpong_{topo.levels[level].name}")


def injection_schedule(topo: Topology, level: int,
                       fanout: int = 4) -> CommSchedule:
    """Injection-rate probe: rank 0 ships slot 0 to ``fanout`` distinct
    level peers in consecutive rounds, serializing ``fanout`` messages
    on its injection port.  Each round is one one-way transfer, so the
    schedule contributes ``fanout`` per-message observations to the fit
    (alpha shows up ``fanout`` times — the robust way to pin latency
    without a sub-microsecond clock)."""
    if topo.levels[level].size < 2:
        raise ValueError(
            f"level {topo.levels[level].name!r} has size "
            f"{topo.levels[level].size}; nothing to probe")
    fanout = min(int(fanout), topo.levels[level].size - 1)
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    n = topo.nranks
    rounds = []
    for i in range(fanout):
        peer = _level_peer(topo, level, step=i + 1)
        rounds.append(make_round(n, [(0, peer)], {0: [0]}, {peer: [0]}))
    return CommSchedule(
        nranks=n, num_slots=1, rounds=tuple(rounds),
        name=f"probe_injection_{topo.levels[level].name}_f{fanout}")


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------


def fit_link_model(samples: Sequence[tuple[float, float]]) -> LinkModel:
    """Least-squares ``(alpha, beta)`` from ``(nbytes, seconds)``
    one-way single-message observations.

    Probe data feeds persisted fingerprints and every cost model
    downstream, so a degenerate fit fails loud instead of propagating:
    fewer than two distinct sizes, non-finite inputs, or a fitted
    coefficient that is negative or non-finite (a clock that ran
    backwards, an overflowed sample) all raise ``ValueError`` — and
    ``LinkModel.__post_init__`` independently enforces the same
    invariant for models constructed anywhere else.
    """
    if len(samples) < 2:
        raise ValueError(f"need >= 2 probe samples, got {len(samples)}")
    xs = [float(s) for s, _ in samples]
    ys = [float(t) for _, t in samples]
    if not all(math.isfinite(v) for v in xs + ys):
        raise ValueError(f"non-finite probe samples: {samples!r}")
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    if sxx == 0:
        raise ValueError(
            f"probe sizes must span >= 2 distinct values, got {xs!r}")
    beta = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    alpha = my - beta * mx
    if not (math.isfinite(alpha) and math.isfinite(beta)):
        raise ValueError(f"non-finite fit alpha={alpha!r} beta={beta!r}")
    if alpha < 0 or beta < 0:
        raise ValueError(
            f"negative fit alpha={alpha:.3e} beta={beta:.3e} from "
            f"{samples!r} (noise larger than the signal; widen the "
            f"size sweep or raise repeats)")
    return LinkModel(alpha=alpha, beta=beta)


# ---------------------------------------------------------------------------
# timers
# ---------------------------------------------------------------------------


def model_timer(topo: Topology, fault=None) -> Timer:
    """Deterministic alpha-beta timer: prices the probe's one-way
    transfer from the level's link model, optionally through a fault
    injector (any object with ``apply(level_index, link) -> LinkModel``
    — see ``runtime.fault.LinkFault``).  This is the substrate for
    drift tests: degrade a level in the injector and the probe pass
    observes exactly that degradation, nothing else."""
    def timer(level: int, nbytes: int) -> float:
        link = topo.levels[level].link
        if fault is not None:
            link = fault.apply(level, link)
        return link.time(float(nbytes))
    return timer


def wire_timer(topo: Topology, *, repeats: int = 3) -> Timer:
    """Wall-clock timer: executes the ping-pong probe schedule through
    ``DistTransport`` on the default group (``tuner.measure_schedule``
    on "dist": every sample agreed over the group) and returns half the
    best-of-``repeats`` RTT.  Requires a group of ``topo.nranks`` ranks.

    Called by every rank alike.  ``timer(level, nbytes, deadline_s=t)``
    bounds the call cooperatively: the overrun is agreed over the
    group, so every rank raises ``tuner.MeasurementTimeout`` together
    and the group stays usable (``probe_links`` passes its per-level
    deadline this way instead of abandoning a thread mid-exchange)."""
    from repro_torch.core.tuner import measure_schedule

    scheds: dict[int, CommSchedule] = {}

    def timer(level: int, nbytes: int,
              deadline_s: float | None = None) -> float:
        if level not in scheds:
            scheds[level] = pingpong_schedule(topo, level)
        rtt = measure_schedule(
            scheds[level], topo,
            slot_elems=max(1, int(nbytes) // _ELEM), repeats=repeats,
            deadline_s=deadline_s, substrate="dist")
        return rtt / 2.0
    timer.cooperative = True
    return timer


def wire_available(topo: Topology) -> bool:
    """True when the default process group has ``topo.nranks`` ranks:
    only a group puts a wire between ranks."""
    from repro_torch.core.tuner import _world
    return _world(topo) is not None


class ProbeTimeout(RuntimeError):
    """One level's probe overran its deadline (a hung link, an injected
    chaos stall).  ``probe_links`` converts this into a recorded skip —
    the level keeps its prior link model — so a wedged wire can never
    wedge the tuning daemon with it."""


def _with_deadline(fn, deadline_s: float | None, what: str):
    """Run ``fn()`` with a hard wall-clock bound: the call executes on a
    worker thread and ``TimeoutError`` at the deadline becomes a typed
    ``ProbeTimeout`` — the caller regains control even while the probe
    is still blocked inside the substrate.  The abandoned worker is
    detached (``shutdown(wait=False)``); a probe that eventually
    returns finishes quietly on a dead-end thread.  For host timers
    only: on a group an abandoned exchange would leave the group
    unusable, so the wire timer takes the cooperative deadline
    (``_cooperative``)."""
    if deadline_s is None:
        return fn()
    if deadline_s <= 0:
        raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="repro-probe")
    fut = pool.submit(fn)
    try:
        return fut.result(timeout=deadline_s)
    except concurrent.futures.TimeoutError:
        raise ProbeTimeout(
            f"{what} exceeded deadline {deadline_s:.3f}s") from None
    finally:
        pool.shutdown(wait=False)


def _cooperative(observe, timer, deadline_s: float | None, what: str):
    """``observe(timed)`` with ``timed(level, nbytes)`` passing each wire
    measurement what is left of the level's deadline: the overrun is
    agreed over the group (``tuner.measure_schedule``), so every rank
    raises ``ProbeTimeout`` at the same sample, or none does."""
    from repro_torch.core.tuner import MeasurementTimeout

    if deadline_s is not None and deadline_s <= 0:
        raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
    start = time.perf_counter()

    def timed(level: int, nbytes: int) -> float:
        left = None
        if deadline_s is not None:
            # never skip a call locally: the agreed check inside decides
            left = max(1e-9, deadline_s - (time.perf_counter() - start))
        return timer(level, nbytes, deadline_s=left)

    try:
        return observe(timed)
    except MeasurementTimeout:
        raise ProbeTimeout(
            f"{what} exceeded deadline {deadline_s:.3f}s") from None


# ---------------------------------------------------------------------------
# the probe pass
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProbeResult:
    """One measurement pass over every probeable level.

    models:  level index -> fitted ``LinkModel`` (levels that could not
             be probed — size 1, or a rejected fit under
             ``strict=False`` — keep their prior link and are absent).
    samples: level index -> tuple of (nbytes, seconds) observations.
    source:  "wire" (measured on the group), "model" (priced) or
             "custom" (the caller's timer).
    skipped: level indices left on their prior link, with the reason.
    """

    models: Mapping[int, LinkModel]
    samples: Mapping[int, tuple]
    source: str
    skipped: Mapping[int, str] = dataclasses.field(default_factory=dict)


def probe_links(topo: Topology, *, sizes=DEFAULT_PROBE_SIZES,
                repeats: int = 3, fanout: int = 2,
                timer: Timer | None = None,
                strict: bool = False,
                deadline_s: float | None = None) -> ProbeResult:
    """Probe every topology level and fit a ``LinkModel`` per level.

    Per level: one ping-pong observation per probe size, plus
    ``fanout`` injection-normalized observations at the smallest size
    (each round of the injection schedule is one more one-way sample).
    ``timer`` defaults to the wire timer when the default group has
    ``topo.nranks`` ranks, else the deterministic model timer —
    mirroring the measured-vs-model split the tuner already makes.

    ``strict=False`` (the launcher default) keeps a level's prior link
    when its fit is rejected (noisy host clocks can produce a negative
    alpha on a short sweep) and records the reason in ``skipped``;
    ``strict=True`` re-raises — the mode tests use to assert rejection.

    ``deadline_s`` bounds each LEVEL's whole observation sweep: a
    host timer runs on a worker thread (``_with_deadline``); the wire
    timer takes the agreed cooperative deadline (``_cooperative``), so
    every rank skips the same level and the group stays usable.  A
    level that overruns keeps its prior link and the timeout is
    recorded in ``skipped`` — under ``strict=True`` it re-raises like a
    rejected fit.  Without it a single wedged link would hang
    ``TuningDaemon.tick`` (and any serving loop that calls it) forever.
    """
    if timer is None:
        source = "wire" if wire_available(topo) else "model"
        timer = (wire_timer(topo, repeats=repeats) if source == "wire"
                 else model_timer(topo))
    else:
        source = "custom"
    sizes = tuple(int(s) for s in sizes)
    if len(set(sizes)) < 2:
        raise ValueError(f"need >= 2 distinct probe sizes, got {sizes!r}")
    models: dict[int, LinkModel] = {}
    samples: dict[int, tuple] = {}
    skipped: dict[int, str] = {}
    for i, lv in enumerate(topo.levels):
        if lv.size < 2:
            skipped[i] = "size-1 level (no link to probe)"
            continue

        def observe(timed, i=i, lv=lv):
            obs = [(float(s), timed(i, s)) for s in sizes]
            # injection rounds at the smallest size: fanout more
            # observations of the same one-way transfer (alpha-weighted)
            eff_fanout = min(int(fanout), lv.size - 1)
            obs += [(float(min(sizes)), timed(i, min(sizes)))
                    for _ in range(max(0, eff_fanout - 1))]
            return obs

        what = f"probe of level {lv.name!r}"
        try:
            if getattr(timer, "cooperative", False):
                obs = _cooperative(observe, timer, deadline_s, what)
            else:
                obs = _with_deadline(lambda: observe(timer), deadline_s,
                                     what)
        except ProbeTimeout as e:
            if strict:
                raise
            skipped[i] = f"{e} (kept prior link)"
            continue
        samples[i] = tuple(obs)
        try:
            models[i] = fit_link_model(obs)
        except ValueError as e:
            if strict:
                raise
            skipped[i] = str(e)
    return ProbeResult(models=models, samples=samples, source=source,
                       skipped=skipped)


def measured_topology(topo: Topology, probe: ProbeResult | None = None,
                      **probe_kwargs) -> Topology:
    """Rebuild ``topo`` with probed link models substituted per level.

    Names, sizes, and DCN flags are untouched — only the alpha-beta
    coefficients change — so the geometry stays identical while
    ``fingerprint()`` now emits the ``lm[...]`` override section for
    every measured level: tuned tables and executor-cache entries
    become keyed by measured geometry, which is the whole point.
    """
    if probe is None:
        probe = probe_links(topo, **probe_kwargs)
    levels = tuple(
        TopoLevel(lv.name, lv.size, probe.models.get(i, lv.link), lv.dcn)
        for i, lv in enumerate(topo.levels))
    return Topology(nranks=topo.nranks, ranks_per_pod=topo.ranks_per_pod,
                    levels=levels)


# ---------------------------------------------------------------------------
# drift detection (the healing daemon's trigger)
# ---------------------------------------------------------------------------


def _coeff_drifted(fresh: float, rec: float, tol: float) -> bool:
    """The ``tuner._cell_differs`` ratio rule applied to one link
    coefficient: drifted iff it moved beyond the relative slack in
    either direction.  Coefficients at exactly 0 only match 0."""
    if fresh == rec:
        return False
    if fresh == 0 or rec == 0:
        return True
    return fresh > rec * tol or rec > fresh * tol


def drifted_levels(old: Topology, new: Topology, *,
                   tol: float = 1.25) -> list[int]:
    """Level indices whose link model moved beyond the noise tolerance
    between two probe passes (alpha or beta, ratio rule).  A geometry
    change (different level structure) is not drift — that is a remesh
    and raises so callers never silently compare unlike hierarchies."""
    if [(lv.name, lv.size, lv.dcn) for lv in old.levels] != \
            [(lv.name, lv.size, lv.dcn) for lv in new.levels]:
        raise ValueError(
            f"geometry changed ({old.fingerprint()} -> "
            f"{new.fingerprint()}); use the elastic remesh path, "
            f"not drift healing")
    out = []
    for i, (a, b) in enumerate(zip(old.levels, new.levels)):
        if (_coeff_drifted(b.link.alpha, a.link.alpha, tol)
                or _coeff_drifted(b.link.beta, a.link.beta, tol)):
            out.append(i)
    return out
