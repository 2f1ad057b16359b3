"""Deterministic data-plane fault injection for any transport (PyTorch
port).

The attack half of verified execution (``core.resilient`` is the
defense): a seeded, reproducible chaos injector that wraps any
transport — ``SimTransport``, ``DistTransport``, ``KernelTransport`` —
and fires faults at round granularity.

Fault taxonomy (one campaign each, or ``"mixed"``):

  * ``"corrupt"`` — a slot row of the output buffer is corrupted
    (``mode="nan"`` sprays NaN; ``mode="bitflip"`` flips one high
    exponent bit of every element — silent without verification);
  * ``"fail"``    — the round raises ``TransportError`` (a failed
    launch / dropped exchange — detected, retryable);
  * ``"hang"``    — the run is delayed past a deadline (``delay_s``
    injected before execution; the result itself is correct but
    *late*).

Determinism: fault placement (round, rank, slot) is drawn from a numpy
rng keyed by a sha1 of ``(seed, campaign, schedule.fingerprint())``, so
the same seeds replay the same failures — and, the fingerprints being
the reference package's, the same placements as the reference.
``times`` bounds how many consecutive executions of one schedule fault
(transient faults clear and a retry succeeds); ``times=None`` is a
persistent fault the ladder must degrade around.

``FaultPlan`` also implements the duck-typed *injector protocol*
(``apply(level, link) -> LinkModel`` plus ``clear()``): a hang campaign
inflates a probed link's alpha, other campaigns leave links untouched.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from repro_torch.core.schedule import CommSchedule
from repro_torch.core.topology import LinkModel
from repro_torch.core.transport import TransportError

CAMPAIGNS = ("corrupt", "fail", "hang", "mixed")
CORRUPT_MODES = ("nan", "bitflip")

# the signed integer of each width: the flipped bit (nbits - 2) fits in
# every one of them, so the bits come out as an unsigned view's would
_TORCH_INTS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_NP_UINTS = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault, fully placed (replayable record)."""

    kind: str                     # "corrupt" | "fail" | "hang"
    round_idx: int                # round the fault is attributed to
    rank: int = 0                 # corrupt: whose buffer row
    slot: int = 0                 # corrupt: which slot row
    mode: str = "nan"             # corrupt: "nan" | "bitflip"
    delay_s: float = 0.0          # hang: injected stall


def _bad_row(row, mode: str):
    """The corrupted copy of one slot row (numpy array or tensor)."""
    if isinstance(row, torch.Tensor):
        if mode == "nan" and row.is_floating_point():
            return torch.full_like(row, float("nan"))
        # flip a high exponent bit of every element: a large, visible,
        # bit-deterministic perturbation for any fixed-width dtype
        nbits = row.element_size() * 8
        ints = row.contiguous().view(_TORCH_INTS[row.element_size()])
        return (ints ^ (1 << (nbits - 2))).view(row.dtype)
    if mode == "nan" and np.issubdtype(row.dtype, np.floating):
        return np.full_like(row, np.nan)
    nbits = row.dtype.itemsize * 8
    uint = _NP_UINTS[row.dtype.itemsize]
    w = np.ascontiguousarray(row).view(uint)
    return (w ^ uint(1 << (nbits - 2))).view(row.dtype)


def _corrupt(buf, ev: FaultEvent):
    """Deterministically corrupt slot row (rank, slot) of a global
    [nranks, num_slots, *slot] buffer.  Acts on a numpy array (the sim
    and reference rungs) or a tensor on any device (the kernel and dist
    rungs) and returns a corrupted copy of the same kind."""
    out = buf.clone() if isinstance(buf, torch.Tensor) else np.array(buf)
    out[ev.rank, ev.slot] = _bad_row(out[ev.rank, ev.slot], ev.mode)
    return out


def _corrupt_local(buf: torch.Tensor, ev: FaultEvent, rank: int):
    """The same fault on one rank's local [num_slots, *slot] buffer: only
    the rank the event names has its row corrupted."""
    if rank != ev.rank:
        return buf
    out = buf.clone()
    out[ev.slot] = _bad_row(out[ev.slot], ev.mode)
    return out


class FaultPlan:
    """Seeded, deterministic fault plan: wraps transports via ``wrap``.

    seed/campaign: the replay key.  ``times``: how many consecutive
    executions of each schedule fault before the plan goes quiet for it
    (``None`` = every execution, a persistent fault).  ``max_faults``:
    events injected per faulting execution.  ``match``: optionally
    restrict the plan to schedules whose fingerprint or name equals /
    prefixes this string (lets a test fault only the primary algorithm
    so the refit rung is reachable).
    """

    def __init__(self, seed: int, campaign: str, *, times: int | None = 1,
                 max_faults: int = 1, mode: str | None = None,
                 delay_s: float = 0.05, alpha_scale: float = 200.0,
                 match: str | None = None):
        if campaign not in CAMPAIGNS:
            raise ValueError(f"unknown chaos campaign {campaign!r}; "
                             f"expected one of {CAMPAIGNS}")
        if mode is not None and mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corruption mode {mode!r}; "
                             f"expected one of {CORRUPT_MODES}")
        if times is not None and times < 0:
            raise ValueError(f"times must be >= 0 or None, got {times}")
        if max_faults < 1:
            raise ValueError(f"max_faults must be >= 1, got {max_faults}")
        if not (np.isfinite(delay_s) and delay_s >= 0):
            raise ValueError(f"delay_s must be finite >= 0, got {delay_s}")
        self.seed = int(seed)
        self.campaign = campaign
        self.times = times
        self.max_faults = int(max_faults)
        self.mode = mode
        self.delay_s = float(delay_s)
        self.alpha_scale = float(alpha_scale)
        self.match = match
        self._fired: dict[str, int] = {}

    # -- deterministic placement ------------------------------------------
    def _rng(self, schedule: CommSchedule) -> np.random.Generator:
        key = f"{self.seed}:{self.campaign}:{schedule.fingerprint()}"
        digest = hashlib.sha1(key.encode()).digest()
        return np.random.default_rng(int.from_bytes(digest[:8], "little"))

    def events_for(self, schedule: CommSchedule) -> tuple[FaultEvent, ...]:
        """The exact faults this plan injects into one execution of
        ``schedule`` — a pure function of (seed, campaign, schedule),
        independent of firing state, so reports and tests can replay."""
        rng = self._rng(schedule)
        nrounds = max(1, schedule.num_rounds)
        events = []
        for _ in range(self.max_faults):
            kind = (self.campaign if self.campaign != "mixed"
                    else ("corrupt", "fail", "hang")[rng.integers(3)])
            mode = self.mode or ("nan", "bitflip")[rng.integers(2)]
            events.append(FaultEvent(
                kind=kind,
                round_idx=int(rng.integers(nrounds)),
                rank=int(rng.integers(schedule.nranks)),
                # any slot row, canary rows included — the memory-spray
                # model verification must stand up to
                slot=int(rng.integers(max(1, schedule.num_slots))),
                mode=mode,
                delay_s=self.delay_s if kind == "hang" else 0.0))
        return tuple(events)

    def _matches(self, schedule: CommSchedule) -> bool:
        if self.match is None:
            return True
        return (schedule.fingerprint().startswith(self.match)
                or schedule.name.startswith(self.match))

    def take(self, schedule: CommSchedule) -> tuple[FaultEvent, ...]:
        """Events to inject for the NEXT execution of ``schedule``
        (advances the transient-fault counter; empty once ``times``
        executions have faulted)."""
        if not self._matches(schedule):
            return ()
        fp = schedule.fingerprint()
        fired = self._fired.get(fp, 0)
        if self.times is not None and fired >= self.times:
            return ()
        self._fired[fp] = fired + 1
        return self.events_for(schedule)

    def reset(self) -> None:
        """Rewind the transient-fault counters (replay a campaign)."""
        self._fired.clear()

    # -- duck-typed injector protocol --------------------------------------
    def apply(self, level: int, link: LinkModel) -> LinkModel:
        """A hang campaign is visible to a link probe as inflated
        latency; data-plane campaigns don't move the link model."""
        if self.campaign == "hang":
            return LinkModel(alpha=link.alpha * self.alpha_scale,
                             beta=link.beta)
        return link

    def clear(self) -> None:
        self.reset()


class ChaosTransport:
    """A transport wrapped with a ``FaultPlan``.

    Delegates everything to the inner transport; ``run`` /
    ``run_global`` / ``run_reference`` consult the plan first and
    inject: hang -> host stall before execution, fail ->
    ``TransportError`` (round-attributed), corrupt -> deterministic
    slot corruption of the produced buffer.  ``run`` of a group
    transport (``DistTransport``, ``KernelTransport``) returns one
    rank's local buffer, so only the rank the event names is
    corrupted.  ``run_chunked`` reaches the inner transport's own chunk
    loop, which re-enters the inner ``run``: no fault fires there.
    """

    def __init__(self, inner, plan: FaultPlan):
        self.inner = inner
        self.plan = plan

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _execute(self, schedule, buf, call, corrupt=_corrupt):
        events = self.plan.take(schedule)
        for ev in events:
            if ev.kind == "hang":
                time.sleep(ev.delay_s)
            elif ev.kind == "fail":
                raise TransportError(
                    f"chaos[seed={self.plan.seed}]: injected failure in "
                    f"round {ev.round_idx} of {schedule.name}",
                    transport=type(self.inner).__name__,
                    round_idx=ev.round_idx)
        out = call(buf)
        for ev in events:
            if ev.kind == "corrupt":
                out = corrupt(out, ev)
        return out

    def run(self, schedule, buf):
        corrupt = _corrupt
        group = getattr(self.inner, "group", False)
        if group is not False:            # a rank's local buffer
            import torch.distributed as dist
            rank = dist.get_rank(group)

            def corrupt(out, ev):
                return _corrupt_local(out, ev, rank)
        return self._execute(schedule, buf,
                             lambda b: self.inner.run(schedule, b), corrupt)

    def run_global(self, schedule, gbuf, **kw):
        return self._execute(
            schedule, gbuf,
            lambda b: self.inner.run_global(schedule, b, **kw))

    def run_reference(self, schedule, buf):
        return self._execute(
            schedule, buf,
            lambda b: self.inner.run_reference(schedule, b))


def wrap(transport, plan: FaultPlan | None):
    """Wrap ``transport`` with ``plan`` (None = passthrough)."""
    return transport if plan is None else ChaosTransport(transport, plan)
