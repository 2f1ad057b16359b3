"""Fault handling for long runs: preemption-aware checkpoint/restart.

At 1000+ nodes the mean time between node failures is minutes-to-hours;
the contract implemented here is the standard production one:

  * periodic async checkpoints (every ``ckpt_every`` steps),
  * a preemption signal (SIGTERM/SIGINT on most schedulers) triggers
    one final synchronous checkpoint before exit — at most one
    committed checkpoint per step, even when preemption lands exactly
    on a periodic checkpoint boundary,
  * on (re)start, training resumes from the newest committed step —
    combined with the step-addressable data pipeline this makes any
    crash exactly-once-recoverable: no data is skipped or repeated,
  * restart may happen on a *different* number of ranks (elastic
    restore — leaves come back on the device the caller names),
  * a latched rank-loss notice (``runtime.elastic.RankLossSignal``)
    triggers an in-place elastic swap instead of an exit: checkpoint,
    hand the surviving-rank list to ``on_rank_loss``, and keep stepping
    with whatever state/step_fn the handler returns — no restart.

``LinkFault`` is the deterministic degraded-fabric injector the drift
tests and the healing leg use: it scales specific topology levels'
alpha/beta inside ``core.linkprobe.model_timer`` so a probe pass
observes exactly the injected degradation and nothing else.
"""
from __future__ import annotations

import dataclasses
import math
import signal
import warnings
from typing import Callable

from repro_torch.checkpoint import AsyncCheckpointer, CheckpointCorruptError, \
    committed_steps, restore_checkpoint
from repro_torch.core.topology import LinkModel


class PreemptionSignal:
    """Latches SIGTERM/SIGINT preemption notices (or test calls).

    ``install_handlers=True`` installs the latch on BOTH signals —
    cluster schedulers deliver SIGTERM, interactive runs deliver SIGINT
    — and *chains* any previously installed callable handler instead of
    clobbering it, so a metrics flusher or profiler hook registered
    before the loop still runs.  The default SIGINT handler (which
    raises ``KeyboardInterrupt``) is deliberately not chained: the
    latch exists precisely to replace the abort with a final
    checkpoint.  ``uninstall()`` restores whatever was displaced.
    """

    _SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, install_handlers: bool = False):
        self._hit = False
        self._prev: dict = {}
        if install_handlers:
            self.install()

    def install(self) -> None:
        for sig in self._SIGNALS:
            if sig in self._prev:       # idempotent: never chain self
                continue
            prev = signal.getsignal(sig)
            self._prev[sig] = prev
            signal.signal(sig, self._make_handler(prev))

    def _make_handler(self, prev):
        def handler(signum, frame):
            self.trigger()
            if callable(prev) and prev is not signal.default_int_handler:
                prev(signum, frame)
        return handler

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def trigger(self):
        self._hit = True

    @property
    def preempted(self) -> bool:
        return self._hit


@dataclasses.dataclass
class LinkFault:
    """Multiplicative per-level link degradation (test injector).

    ``degrade(level, alpha_scale=, beta_scale=)`` arms the fault;
    ``apply(level, link)`` is the hook ``linkprobe.model_timer`` calls
    per probe — it returns the degraded ``LinkModel`` for armed levels
    and the original otherwise.  Scaling alpha and beta independently
    matters: a congested DCN shows up as a beta (bandwidth) collapse
    with latency intact, which is exactly the drift shape that must
    heal *only* the beta-dominated table cells.

    ``apply``/``clear`` are the shared link-injector protocol: any
    object with this pair plugs into ``linkprobe.model_timer`` —
    ``core.chaos.FaultPlan`` implements the same pair so a chaos
    campaign's hang events degrade the modeled fabric a probe pass
    observes, through the exact same hook.
    """

    scales: dict = dataclasses.field(default_factory=dict)

    def degrade(self, level: int, *, alpha_scale: float = 1.0,
                beta_scale: float = 1.0) -> None:
        # mirror LinkModel.__post_init__: finite and non-negative, so a
        # NaN/inf scale is rejected here instead of poisoning every
        # modeled probe time downstream
        for name, s in (("alpha_scale", alpha_scale),
                        ("beta_scale", beta_scale)):
            if not math.isfinite(s) or s < 0:
                raise ValueError(
                    f"{name} must be finite and >= 0, got {s}")
        self.scales[int(level)] = (float(alpha_scale), float(beta_scale))

    def clear(self, level: int | None = None) -> None:
        if level is None:
            self.scales.clear()
        else:
            self.scales.pop(int(level), None)

    def apply(self, level: int, link: LinkModel) -> LinkModel:
        sa, sb = self.scales.get(int(level), (1.0, 1.0))
        if sa == 1.0 and sb == 1.0:
            return link
        return LinkModel(alpha=link.alpha * sa, beta=link.beta * sb)


class FaultTolerantLoop:
    """Drives ``step_fn(state, step) -> state`` with checkpoint/restart.

    step_fn must be pure w.r.t. (state, step); the data pipeline is
    addressed by ``step`` inside it.  ``state`` is a tree of tensors
    (nested dict / list / tuple; see ``repro_torch.checkpoint``).

    ``rank_loss`` (a ``runtime.elastic.RankLossSignal``-shaped latch
    with ``take() -> list | None``) plus ``on_rank_loss(state, step,
    lost_ranks)`` wire the elastic path: when ranks drop mid-run the
    loop checkpoints, lets the handler re-derive schedules for the
    shrunk topology (``runtime.elastic.ElasticScheduleSet.shrink``),
    and continues with the returned ``(state, step_fn)`` — the step
    counter and data pipeline never reset.
    """

    def __init__(self, ckpt_dir, *, ckpt_every: int = 100,
                 preemption: PreemptionSignal | None = None,
                 num_shards: int = 1,
                 rank_loss=None,
                 on_rank_loss: Callable | None = None,
                 on_degraded: Callable | None = None):
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.preemption = preemption or PreemptionSignal()
        self.ckpt = AsyncCheckpointer(ckpt_dir, num_shards=num_shards)
        self.rank_loss = rank_loss
        self.on_rank_loss = on_rank_loss
        self.on_degraded = on_degraded
        # DegradationReports drained from api.take_degradations() per
        # step — the loop-level record of every recovered fault
        self.degradations: list = []

    def resume_or_init(self, init_state):
        """Resume from the newest *intact* checkpoint.

        A corrupt committed step (truncated shard, flipped bytes —
        ``CheckpointCorruptError``) is skipped with a warning and the
        walk continues to the next-newest committed step; only when
        every committed checkpoint is corrupt (or none exists) does the
        loop fall back to ``(init_state, 0)``."""
        for step in committed_steps(self.ckpt_dir):
            try:
                tree, meta = restore_checkpoint(self.ckpt_dir, init_state,
                                                step=step)
            except CheckpointCorruptError as e:
                warnings.warn(
                    f"skipping corrupt checkpoint step {step}: {e}",
                    RuntimeWarning, stacklevel=2)
                continue
            return tree, meta.get("next_step", step + 1)
        return init_state, 0

    def _drain_degradations(self, step: int) -> None:
        from repro_torch.core import api

        reports = api.take_degradations()
        if not reports:
            return
        self.degradations.extend(reports)
        if self.on_degraded is not None:
            for rep in reports:
                self.on_degraded(step, rep)

    def run(self, state, step_fn: Callable, *, start_step: int,
            num_steps: int, on_step=None):
        step = start_step
        end = start_step + num_steps
        # step of the newest checkpoint this run committed/enqueued —
        # the guard against double-saving one step when preemption (or
        # the final save) lands on a periodic checkpoint boundary
        saved = None
        while step < end:
            state = step_fn(state, step)
            step += 1
            self._drain_degradations(step)
            if on_step is not None:
                on_step(step, state)
            if step % self.ckpt_every == 0:
                self.ckpt.save(step, state, meta={"next_step": step})
                saved = step
            if self.preemption.preempted:
                self.ckpt.wait()
                if saved != step:
                    self.ckpt.save(step, state,
                                   meta={"next_step": step,
                                         "preempted": True})
                    self.ckpt.wait()
                return state, step
            lost = (self.rank_loss.take()
                    if self.rank_loss is not None else None)
            if lost:
                # persist the pre-swap state, then re-derive in place
                self.ckpt.wait()
                if saved != step:
                    self.ckpt.save(step, state,
                                   meta={"next_step": step,
                                         "lost_ranks": sorted(lost)})
                    self.ckpt.wait()
                    saved = step
                if self.on_rank_loss is not None:
                    res = self.on_rank_loss(state, step, sorted(lost))
                    if res is not None:
                        state, new_fn = res
                        if new_fn is not None:
                            step_fn = new_fn
        self.ckpt.wait()
        if saved != end:
            self.ckpt.save(end, state, meta={"next_step": end})
            self.ckpt.wait()
        return state, step
