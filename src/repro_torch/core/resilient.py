"""Self-verifying, self-healing execution of compiled schedules (PyTorch
port).

The defense half of the chaos story (``core.chaos`` is the attack
half): ``ResilientExec`` runs a schedule through the recovery ladder

    verify -> retry/backoff -> transport fallback -> algorithm refit
           -> typed ``UnrecoverableError``

so a misbehaving substrate degrades a collective to a slower-but-
correct path instead of wedging the loop or silently returning wrong
data.  Under any seeded fault campaign the recovered output is
**bitwise identical** to the fault-free run, or a typed error is
raised — never a silent mismatch.

Integrity checking (the ``verify=`` knob):

  * ``"off"``    — no checks; faults must be *detected* (raised
    ``TransportError``, deadline overrun) to trigger recovery.
  * ``"canary"`` — one O(result) pass, NO second execution: a canary
    slot row (``schedule.add_canary_slot``) seeded with a deterministic
    pattern rides through the transport and is compared bitwise after
    the run; the input buffer is re-checked against a clone of it; and
    (finite inputs) the result region is scanned for non-finite values.
  * ``"full"``   — additionally compares the result region bitwise
    against ONE numpy ``SimTransport.run_reference`` execution of the
    original schedule (computed once per call, shared across retries).
    ``tuner.verify_overhead_s`` models both modes.

Every verdict compares raw bits (integer views of the tensors), so NaN
payloads and -0.0 are never misjudged; on a CUDA buffer the checks run
on the device.

The rungs are ``RUNGS = ("kernel", "dist", "sim", "reference")``: the
reference package's ``pallas`` is ``kernel`` (the whole schedule as one
CUDA kernel), its ``shardmap`` is ``dist`` (``torch.distributed``
point-to-point over a process group of ``nranks`` ranks, skipped with a
recorded reason when there is none), ``sim`` and ``reference`` are the
numpy rungs and run on a host copy.  Only a ``TransportError`` (or a
deadline overrun, or a failed verdict) moves the ladder: a failure of
the CUDA kernel itself (a build error, a launch error, an illegal
address) propagates, so a broken kernel is never served quietly by a
slower rung.  Algorithm refit walks the selector's fixed ladder, then
the registry.  Every decision lands in a ``DegradationReport``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from repro_torch.core.schedule import (CommSchedule, NotApplicable,
                                       add_canary_slot)
from repro_torch.core.topology import Topology
from repro_torch.core.transport import (DistTransport, KernelTransport,
                                        SimTransport, TransportError)

VERIFY_MODES = ("off", "canary", "full")
RUNGS = ("kernel", "dist", "sim", "reference")

_INTS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@dataclasses.dataclass(frozen=True)
class ResilienceOptions:
    """Knobs of the recovery ladder (``resilience=`` everywhere).

    verify:       "off" | "canary" | "full" (see module docstring).
    max_retries:  extra attempts per rung after the first.
    backoff_s:    first retry delay; each retry multiplies by
                  ``backoff_mult`` (exponential backoff).
    deadline_s:   per-attempt wall-clock bound; an attempt past it is
                  a timeout fault even if the result arrived (None =
                  no deadline).
    ladder:       transport rungs, tried in order.
    refit:        when every rung fails, walk the selector's algorithm
                  ladder (requires the collective name to be known).
    """

    verify: str = "canary"
    max_retries: int = 2
    backoff_s: float = 1e-3
    backoff_mult: float = 2.0
    deadline_s: float | None = None
    ladder: tuple = RUNGS
    refit: bool = True

    def __post_init__(self):
        if self.verify not in VERIFY_MODES:
            raise ValueError(f"verify must be one of {VERIFY_MODES}, "
                             f"got {self.verify!r}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if not (np.isfinite(self.backoff_s) and self.backoff_s >= 0):
            raise ValueError(f"backoff_s must be finite >= 0, "
                             f"got {self.backoff_s}")
        if not (np.isfinite(self.backoff_mult) and self.backoff_mult >= 1):
            raise ValueError(f"backoff_mult must be finite >= 1, "
                             f"got {self.backoff_mult}")
        if self.deadline_s is not None and not (
                np.isfinite(self.deadline_s) and self.deadline_s > 0):
            raise ValueError(f"deadline_s must be finite > 0 or None, "
                             f"got {self.deadline_s}")
        object.__setattr__(self, "ladder", tuple(self.ladder))
        if not self.ladder:
            raise ValueError("ladder must name at least one rung")
        for rung in self.ladder:
            if rung not in RUNGS:
                raise ValueError(f"unknown ladder rung {rung!r}; "
                                 f"expected rungs from {RUNGS}")


def resolve_resilience(resilience) -> ResilienceOptions | None:
    """Normalize the public ``resilience=`` argument: None/False = off
    entirely (zero overhead), True = defaults, a verify-mode string, a
    dict of option overrides, or a ``ResilienceOptions``."""
    if resilience is None or resilience is False:
        return None
    if resilience is True:
        return ResilienceOptions()
    if isinstance(resilience, ResilienceOptions):
        return resilience
    if isinstance(resilience, str):
        if resilience not in VERIFY_MODES:
            raise ValueError(
                f"unknown resilience preset {resilience!r}; expected a "
                f"verify mode from {VERIFY_MODES}, a ResilienceOptions, "
                f"or a dict of its fields")
        return ResilienceOptions(verify=resilience)
    if isinstance(resilience, dict):
        return ResilienceOptions(**resilience)
    raise ValueError(f"cannot interpret resilience={resilience!r}")


@dataclasses.dataclass(frozen=True)
class Attempt:
    """One ladder step (telemetry row of the DegradationReport)."""

    rung: str                     # transport rung (or "refit")
    algorithm: str                # schedule/algorithm attempted
    attempt: int                  # 0-based retry index within the rung
    outcome: str                  # ok|fault|timeout|corrupt|skipped
    detail: str = ""
    seconds: float = 0.0


@dataclasses.dataclass
class DegradationReport:
    """What the ladder did for one call: every attempt, every checksum
    verdict, where (if anywhere) recovery landed."""

    schedule: str
    verify: str
    attempts: list = dataclasses.field(default_factory=list)
    verdicts: list = dataclasses.field(default_factory=list)
    recovered_with: str | None = None    # rung that produced the output
    refit_algorithm: str | None = None   # set when the refit rung won

    @property
    def degraded(self) -> bool:
        """True when the call did not succeed first-try on the first
        available rung."""
        return (self.refit_algorithm is not None
                or any(a.outcome not in ("ok", "skipped")
                       for a in self.attempts))

    @property
    def retries(self) -> int:
        return sum(1 for a in self.attempts
                   if a.outcome in ("fault", "timeout", "corrupt"))

    def summary(self) -> str:
        path = " -> ".join(f"{a.rung}[{a.outcome}]" for a in self.attempts)
        return (f"{self.schedule}: {path}; recovered_with="
                f"{self.recovered_with} refit={self.refit_algorithm}")


class UnrecoverableError(RuntimeError):
    """Every rung and every refit candidate failed; the attached
    ``report`` records the full ladder walk."""

    def __init__(self, msg: str, report: DegradationReport):
        super().__init__(msg + " | " + report.summary())
        self.report = report


def canary_pattern(schedule: CommSchedule, dtype, slot_shape):
    """Deterministic per-rank canary rows [nranks, 1, *slot] — seeded by
    the schedule fingerprint so replays and reports agree.  The values
    are integers 1-99 (exact in bf16).  A numpy dtype gives a numpy
    array, a torch dtype a CPU tensor."""
    digest = hashlib.sha1(
        ("canary:" + schedule.fingerprint()).encode()).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
    shape = (schedule.nranks, 1) + tuple(slot_shape)
    vals = rng.integers(1, 100, size=shape)
    if isinstance(dtype, torch.dtype):
        if dtype.is_floating_point:
            vals = vals.astype(np.float64)
        return torch.from_numpy(vals).to(dtype)
    dt = np.dtype(dtype)
    if not np.issubdtype(dt, np.integer):
        vals = vals.astype(np.float64)
    return np.asarray(vals).astype(dt)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Raw bits as integers of the element's width."""
    return t.contiguous().view(_INTS[t.element_size()])


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(_bits(a), _bits(b)))


def _copy_only(schedule: CommSchedule) -> bool:
    return not any(r.reduce for r in schedule.rounds)


def _to_host(schedule: CommSchedule, t: torch.Tensor) -> np.ndarray:
    """A host numpy copy for the numpy rungs.  bf16 has no numpy dtype
    here: a schedule that only copies moves its raw bits unchanged, one
    with a reduce round cannot run on the numpy rungs."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        if not _copy_only(schedule):
            raise TypeError(f"{schedule.name}: the numpy rungs cannot add "
                            f"bfloat16; run it on the kernel or dist rung")
        return t.view(torch.int16).numpy().copy()
    return t.numpy().copy()


def _from_host(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def _sync(t) -> None:
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class ResilientExec:
    """The recovery-ladder engine for one compiled schedule.

    ``run(gbuf)`` takes a global [nranks, num_slots, *slot] buffer (the
    SimTransport / ``run_global`` calling convention): a numpy array
    (returned as numpy) or a tensor on any device (returned as a tensor
    on that device), and returns ``(output, DegradationReport)``.

    ``transports`` optionally overrides rung construction with
    ready-made transport instances — the chaos tests inject
    ``chaos.wrap``-ped rungs there; anything not overridden is built
    clean.  ``group`` is the process group the ``dist`` rung runs over
    (every rank calls with the same buffer).  ``collective`` /
    ``algorithm`` name the plan for the refit rung (omit them and refit
    is skipped).  ``stats`` accumulates host seconds of the checks
    (``verify_s``: canary and input preparation, verdicts and the full
    reference) and of the rung calls (``call_s``).
    """

    def __init__(self, schedule: CommSchedule, topo: Topology | None = None,
                 *, options: ResilienceOptions | None = None,
                 collective: str | None = None,
                 algorithm: str | None = None,
                 transports: dict | None = None, group=None):
        self.schedule = schedule
        self.topo = topo
        self.options = options or ResilienceOptions()
        self.collective = collective
        self.algorithm = algorithm
        self.transports = dict(transports or {})
        self.group = group
        self._canary: CommSchedule | None = None
        # canary rows on the device, per (schedule, dtype, slot, device):
        # the numpy draw of a DDP bucket's row costs tens of host ms
        self._patterns: dict = {}
        self.stats = {"verify_s": 0.0, "call_s": 0.0}

    # -- rung plumbing ----------------------------------------------------
    def _transport(self, rung: str):
        tr = self.transports.get(rung)
        if tr is not None:
            return tr
        n = self.schedule.nranks
        if rung == "kernel":
            return KernelTransport(n, topo=self.topo)
        if rung == "dist":
            return DistTransport(n, self.group, topo=self.topo)
        return SimTransport(n, topo=self.topo)     # sim | reference

    def _rung_unavailable(self, rung: str) -> str | None:
        if rung != "dist" or "dist" in self.transports:
            return None
        import torch.distributed as dist
        n = self.schedule.nranks
        if not dist.is_initialized():
            return f"needs a process group of {n} ranks, have none"
        have = dist.get_world_size(self.group)
        if have != n:
            return f"needs a process group of {n} ranks, have {have}"
        return None

    def _call(self, rung: str, schedule: CommSchedule, buf: torch.Tensor):
        tr = self._transport(rung)
        if rung in ("kernel", "dist"):
            out = tr.run_global(schedule, buf)
        else:
            host = _to_host(schedule, buf)
            out = (tr.run_reference(schedule, host) if rung == "reference"
                   else tr.run(schedule, host))
            out = _from_host(np.asarray(out), buf)
        # an asynchronous launch is not done when it returns: the
        # deadline clock reads after the device finished
        _sync(out)
        return out

    # -- verification -----------------------------------------------------
    @staticmethod
    def _result_region(schedule: CommSchedule, out):
        """[nranks, result_slots, *slot]: a view where every rank's
        region starts at the same slot, else a stacked copy."""
        rows = schedule.result_slots
        offs = [schedule.out_offset(r) for r in range(schedule.nranks)]
        if len(set(offs)) == 1:
            return out[:, offs[0]: offs[0] + rows]
        parts = [out[r, o: o + rows] for r, o in enumerate(offs)]
        if isinstance(out, torch.Tensor):
            return torch.stack(parts)
        return np.stack(parts)

    def _pattern(self, schedule: CommSchedule, buf: torch.Tensor):
        key = (schedule.fingerprint(), buf.dtype, tuple(buf.shape[2:]),
               buf.device)
        pattern = self._patterns.get(key)
        if pattern is None:
            pattern = self._patterns[key] = canary_pattern(
                schedule, buf.dtype, buf.shape[2:]).to(buf.device)
        return pattern

    def _verify(self, report, schedule, out, *, pattern, in_copy, buf,
                in_finite, reference) -> bool:
        """All verdicts are bitwise (integer views) so NaN-vs-NaN and
        negative-zero cases are never misjudged; ``schedule`` is the
        ORIGINAL (canary-free) schedule whose geometry defines the
        result region and the canary row index."""
        opts = self.options
        ok = True
        if pattern is not None:
            got = out[:, schedule.num_slots: schedule.num_slots + 1]
            canary_ok = _same_bits(got, pattern)
            report.verdicts.append(("canary", canary_ok))
            ok &= canary_ok
        if in_copy is not None:
            input_ok = _same_bits(buf, in_copy)
            report.verdicts.append(("input-checksum", input_ok))
            ok &= input_ok
        res = self._result_region(schedule, out)
        if in_finite and res.is_floating_point():
            finite_ok = bool(torch.isfinite(res).all())
            report.verdicts.append(("finite", finite_ok))
            ok &= finite_ok
        if opts.verify == "full":
            ref_ok = _same_bits(res, reference)
            report.verdicts.append(("reference", ref_ok))
            ok &= ref_ok
        return ok

    # -- the ladder -------------------------------------------------------
    def run(self, buf):
        """Execute with the full recovery ladder; returns
        ``(output, DegradationReport)`` or raises a typed
        ``UnrecoverableError``."""
        as_numpy = isinstance(buf, np.ndarray)
        t = torch.from_numpy(buf) if as_numpy else buf
        out, report = self._run(t)
        return (out.numpy() if as_numpy else out), report

    def _run(self, buf: torch.Tensor):
        opts = self.options
        report = DegradationReport(schedule=self.schedule.name,
                                   verify=opts.verify)
        out = self._run_ladder(buf, report, self.schedule,
                               self.algorithm or self.schedule.name)
        if out is not None:
            return out, report
        # every rung failed -> algorithm refit (the selector's ladder)
        if opts.refit and self.collective is not None \
                and self.topo is not None:
            from repro_torch.core.algorithms import REGISTRY
            from repro_torch.core.selector import _FIXED
            coll = self.collective
            ladder = [a for a in _FIXED.get(coll, ())
                      if a != self.algorithm]
            ladder += [a for a in REGISTRY.get(coll, {})
                       if a != self.algorithm and a not in ladder]
            for cand in ladder:
                try:
                    cand_sched = REGISTRY[coll][cand](self.topo)
                except NotApplicable as e:
                    report.attempts.append(Attempt(
                        rung="refit", algorithm=cand, attempt=0,
                        outcome="skipped", detail=str(e) or "NotApplicable"))
                    continue
                child = ResilientExec(
                    cand_sched, self.topo, options=opts,
                    collective=None, algorithm=cand,
                    transports=self.transports, group=self.group)
                child_report = DegradationReport(
                    schedule=cand_sched.name, verify=opts.verify)
                out = child._run_ladder(buf, child_report, cand_sched, cand)
                for k in self.stats:
                    self.stats[k] += child.stats[k]
                report.attempts.extend(child_report.attempts)
                report.verdicts.extend(child_report.verdicts)
                if out is not None:
                    report.refit_algorithm = cand
                    report.recovered_with = child_report.recovered_with
                    return out, report
        raise UnrecoverableError(
            "collective could not be recovered on any transport rung "
            "or refit algorithm", report)

    def _run_ladder(self, buf, report, schedule, algorithm):
        """Walk the transport rungs for ONE schedule; returns the
        verified output (canary stripped) or None when every rung is
        exhausted."""
        opts = self.options
        t0 = time.perf_counter()
        pattern = in_copy = None
        xsched, xbuf = schedule, buf
        if opts.verify != "off":
            if schedule is self.schedule:
                if self._canary is None:
                    self._canary = add_canary_slot(schedule)
                xsched = self._canary
            else:
                xsched = add_canary_slot(schedule)
            pattern = self._pattern(schedule, buf)
            xbuf = torch.cat([buf, pattern], dim=1)
            in_copy = xbuf.clone()
        in_finite = (bool(torch.isfinite(buf).all())
                     if buf.is_floating_point() else False)
        reference = None
        if opts.verify == "full":
            ref = SimTransport(schedule.nranks, topo=self.topo)
            host = ref.run_reference(schedule, _to_host(schedule, buf))
            reference = self._result_region(schedule, _from_host(host, buf))
        _sync(xbuf)
        self.stats["verify_s"] += time.perf_counter() - t0
        return self._walk(report, schedule, xsched, xbuf, algorithm,
                          pattern=pattern, in_copy=in_copy,
                          in_finite=in_finite, reference=reference)

    def _walk(self, report, schedule, xsched, xbuf, algorithm, *,
              pattern, in_copy, in_finite, reference):
        opts = self.options
        for rung in opts.ladder:
            reason = self._rung_unavailable(rung)
            if reason is not None:
                report.attempts.append(Attempt(
                    rung=rung, algorithm=algorithm, attempt=0,
                    outcome="skipped", detail=reason))
                continue
            delay = opts.backoff_s
            for attempt in range(opts.max_retries + 1):
                t0 = time.perf_counter()
                try:
                    out = self._call(rung, xsched, xbuf)
                except TransportError as e:
                    report.attempts.append(Attempt(
                        rung=rung, algorithm=algorithm, attempt=attempt,
                        outcome="fault", detail=str(e),
                        seconds=time.perf_counter() - t0))
                    time.sleep(delay)
                    delay *= opts.backoff_mult
                    continue
                dt = time.perf_counter() - t0
                self.stats["call_s"] += dt
                if opts.deadline_s is not None and dt > opts.deadline_s:
                    report.attempts.append(Attempt(
                        rung=rung, algorithm=algorithm, attempt=attempt,
                        outcome="timeout",
                        detail=f"{dt:.4f}s > deadline "
                               f"{opts.deadline_s:.4f}s", seconds=dt))
                    time.sleep(delay)
                    delay *= opts.backoff_mult
                    continue
                t1 = time.perf_counter()
                ok = self._verify(report, schedule, out, pattern=pattern,
                                  in_copy=in_copy, buf=xbuf,
                                  in_finite=in_finite, reference=reference)
                self.stats["verify_s"] += time.perf_counter() - t1
                if ok:
                    report.attempts.append(Attempt(
                        rung=rung, algorithm=algorithm, attempt=attempt,
                        outcome="ok", seconds=dt))
                    report.recovered_with = rung
                    return (out[:, :schedule.num_slots]
                            if pattern is not None else out)
                report.attempts.append(Attempt(
                    rung=rung, algorithm=algorithm, attempt=attempt,
                    outcome="corrupt", detail="integrity check failed",
                    seconds=dt))
                time.sleep(delay)
                delay *= opts.backoff_mult
        return None


def run_resilient(schedule: CommSchedule, buf, *,
                  topo: Topology | None = None,
                  resilience=True, collective: str | None = None,
                  algorithm: str | None = None,
                  transports: dict | None = None, group=None):
    """One-shot convenience: build a ``ResilientExec`` and run it."""
    opts = resolve_resilience(resilience) or ResilienceOptions()
    ex = ResilientExec(schedule, topo, options=opts,
                       collective=collective, algorithm=algorithm,
                       transports=transports, group=group)
    return ex.run(buf)
