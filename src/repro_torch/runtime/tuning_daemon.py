"""Online tuner daemon: re-probe, detect drift, heal — scoped.

The offline story (tuner.autotune at launch) leaves the gap every
offline-tuned MPI leaves open: the fabric the table was measured on is
not the fabric an hours-long run finishes on.  A congested DCN, a
flapping optical link, a straggling host — all shift the real
alpha/beta away from what the tuned winners and the armed executor
passes were priced with.

``TuningDaemon`` closes the loop between steps (or from a background
thread):

  1. **re-probe** the fabric through ``core.linkprobe`` (the same
     timer — wire or model+fault — every tick, so what it observes is
     the fabric, not probe variance);
  2. **detect drift** per level with the noise-tolerant ratio rule
     (``drifted_levels``, same tolerance shape as the tuner's
     ``_cell_differs``) — a re-confirmed fabric is a no-op tick;
  3. **heal scoped**: ``tuner.drift_cells`` model-prices every table
     cell under old and new links and lists only the cells whose
     selection could move; ``tuner.retune_cells`` re-measures exactly
     those (generation bump), never the whole table;
  4. **swap keys**: the table rebases onto the new measured
     fingerprint, the stale geometry's compiled executors and cached
     api plans are evicted (``invalidate_topology`` — scoped, the
     executor cache keys already carry ``topo.fingerprint()``), and
     ``TuningDaemon.topo`` becomes the new measured topology that
     subsequent collectives arm against.

Every tick returns a ``DriftReport`` so callers (and the ``fleet``
benchmark section) can assert the heal really was scoped: cells
re-measured vs total, executors evicted, generation.
"""
from __future__ import annotations

import dataclasses
import threading

from repro_torch.core import linkprobe
from repro_torch.core.topology import Topology


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One daemon tick's outcome (telemetry + test/benchmark record)."""

    step: int
    drifted_levels: tuple         # level indices past tolerance
    affected_cells: tuple         # (collective, bucket) heal work list
    retuned_cells: tuple          # subset that meaningfully changed
    total_cells: int              # table size the scope is judged against
    invalidated: dict             # {"plans": n, "executors": m} evicted
    generation: int               # table generation after the tick
    old_fingerprint: str
    new_fingerprint: str
    stragglers: tuple = ()        # flagged hosts, when a monitor is wired
    probe_skipped: tuple = ()     # (level, reason) levels kept on prior
                                  # links (probe deadline hit, bad fit)

    @property
    def healed(self) -> bool:
        return bool(self.drifted_levels)


class TuningDaemon:
    """Between-step (or background) drift healer for one topology.

    The daemon owns the *measured* topology: construction runs one
    probe pass and rebuilds ``topo`` around the fitted link models, so
    the tuned table it ensures is keyed by measured geometry from the
    first step.  ``tick(step)`` re-probes every ``probe_every`` steps;
    ``start(interval_s)``/``stop()`` run the same pass from a daemon
    thread for serving loops that never yield.

    ``timer`` is the probe clock: ``None`` picks wire measurement on a
    group of ``topo.nranks`` ranks (model pricing otherwise); tests and
    the healing leg inject ``linkprobe.model_timer(topo,
    fault=LinkFault(...))`` so drift is deterministic.  ``substrate``
    names what the table's cells are measured on (``tuner.tune``).
    ``monitor`` (a ``StragglerMonitor``) is rebalanced on every tick
    and its flagged hosts ride along in the report — slow-host healing
    and slow-link healing share a heartbeat.
    """

    def __init__(self, topo: Topology, *, path=None,
                 probe_every: int = 1, drift_tol: float = 1.25,
                 cell_tol: float = 1.10, sizes=linkprobe.DEFAULT_PROBE_SIZES,
                 repeats: int = 3, timer=None, force_model: bool = False,
                 include_xla: bool = True, monitor=None, table=None,
                 probe_deadline_s: float | None = None,
                 substrate: str | None = None):
        from repro_torch.core import tuner

        if probe_every < 1:
            raise ValueError(f"probe_every must be >= 1, got {probe_every}")
        self.path = path
        self.probe_every = int(probe_every)
        self.drift_tol = float(drift_tol)
        self.cell_tol = float(cell_tol)
        self.sizes = tuple(sizes)
        self.repeats = int(repeats)
        self.force_model = bool(force_model)
        self.include_xla = bool(include_xla)
        self.substrate = substrate
        self.monitor = monitor
        self._timer = timer
        # per-level probe wall-clock bound: a hung wire becomes a
        # recorded skip (level keeps its prior link) instead of a
        # wedged daemon thread — see linkprobe.probe_links(deadline_s=)
        self.probe_deadline_s = probe_deadline_s
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()
        self.reports: list[DriftReport] = []
        # baseline probe: measured geometry from step 0
        probe = linkprobe.probe_links(topo, sizes=self.sizes,
                                      repeats=self.repeats, timer=timer,
                                      deadline_s=probe_deadline_s)
        self.topo = linkprobe.measured_topology(topo, probe)
        if table is None:
            table = tuner.ensure_table(
                self.topo, path=self.path, repeats=self.repeats,
                include_xla=self.include_xla,
                force_model=self.force_model, tol=self.cell_tol,
                substrate=substrate)
        self.table = table

    # -- the heartbeat ----------------------------------------------------
    def tick(self, step: int = 0) -> DriftReport | None:
        """Probe-and-heal when ``step`` lands on the probe cadence
        (always on step 0 cadence arithmetic: every ``probe_every``-th
        call).  Returns the tick's report, or None on off-cadence
        steps."""
        if step % self.probe_every:
            return None
        return self.probe_and_heal(step=step)

    def probe_and_heal(self, step: int = 0) -> DriftReport:
        """One full pass: probe, compare, heal if drifted, swap keys."""
        from repro_torch.core import api, tuner

        with self._lock:
            stragglers: tuple = ()
            if self.monitor is not None:
                self.monitor.rebalance()
                stragglers = tuple(self.monitor.stragglers())
            probe = linkprobe.probe_links(
                self.topo, sizes=self.sizes, repeats=self.repeats,
                timer=self._timer, deadline_s=self.probe_deadline_s)
            probe_skipped = tuple(sorted(probe.skipped.items()))
            new_topo = linkprobe.measured_topology(self.topo, probe)
            drifted = tuple(linkprobe.drifted_levels(
                self.topo, new_topo, tol=self.drift_tol))
            total = sum(len(per) for per in self.table.entries.values())
            if not drifted:
                report = DriftReport(
                    step=step, drifted_levels=(), affected_cells=(),
                    retuned_cells=(), total_cells=total,
                    invalidated={"plans": 0, "executors": 0},
                    generation=self.table.generation,
                    old_fingerprint=self.topo.fingerprint(),
                    new_fingerprint=self.topo.fingerprint(),
                    stragglers=stragglers, probe_skipped=probe_skipped)
                self.reports.append(report)
                return report
            old_topo = self.topo
            old_fp = old_topo.fingerprint()
            cells = tuner.drift_cells(self.table, old_topo, new_topo,
                                      tol=self.cell_tol)
            # rebase the table onto the new measured geometry, then
            # re-measure ONLY the affected cells under it
            self.table.fingerprint = tuner.substrate_fingerprint(
                new_topo, force_model=self.force_model,
                substrate=self.substrate)
            retuned = tuner.retune_cells(
                self.table, new_topo, cells, repeats=self.repeats,
                force_model=self.force_model,
                include_xla=self.include_xla, tol=self.cell_tol,
                substrate=self.substrate)
            tuner.save_table(self.table, path=self.path)
            # evict the stale geometry AFTER repricing: retune_cells
            # built the new topology's executors, which stay warm
            invalidated = api.invalidate_topology(old_topo)
            self.topo = new_topo
            report = DriftReport(
                step=step, drifted_levels=drifted,
                affected_cells=tuple(cells), retuned_cells=tuple(retuned),
                total_cells=total, invalidated=invalidated,
                generation=self.table.generation,
                old_fingerprint=old_fp,
                new_fingerprint=new_topo.fingerprint(),
                stragglers=stragglers, probe_skipped=probe_skipped)
            self.reports.append(report)
            return report

    # -- background mode --------------------------------------------------
    def start(self, interval_s: float = 30.0) -> None:
        """Run ``probe_and_heal`` every ``interval_s`` seconds from a
        daemon thread until ``stop()`` (serving loops that never yield
        between steps)."""
        if self._thread is not None:
            raise RuntimeError("daemon already started")
        self._stop.clear()

        def loop():
            tick = 0
            while not self._stop.wait(interval_s):
                tick += 1
                self.probe_and_heal(step=tick)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="repro-tuning-daemon")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
