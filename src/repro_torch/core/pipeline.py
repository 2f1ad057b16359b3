"""Pipeline parallelism over a process group (the multi-pod strategy).

The pod boundary is a natural pipeline cut: the inter-pod link carries
only the activations of one microbatch per tick (tiny against a
gradient allreduce).  ``gpipe`` is a GPipe schedule in which every rank
of the group is one stage running the same program; activations advance
with one point-to-point shift per tick (``batch_isend_irecv``).  The
shift is an ``autograd.Function`` whose backward is the reverse shift
(as the transpose of the reference's ``ppermute`` is), so one forward
definition yields the full forward + backward pipeline.

The schedule runs T = M + S - 1 ticks for M microbatches over S stages
(the classic GPipe bubble of (S-1)/(M+S-1)); stage s computes
microbatch m at tick t = m + s.  Inputs are consumed on stage 0,
outputs collected on stage S-1 (and shipped back to stage 0 if
``return_to_first``).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _exchange(send, send_to, recv_like, recv_from, group):
    """One batch of at most one send and one receive (group ranks; None
    skips a side)."""
    g = group if group is not None else dist.group.WORLD
    ops, out = [], None
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              dist.get_global_rank(g, send_to), group))
    if recv_from is not None:
        out = torch.empty_like(recv_like)
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(g, recv_from), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Shift(torch.autograd.Function):
    """Stage i sends to stage i + 1 (mod S) and receives from i - 1;
    the gradient takes the reverse shift."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return _exchange(y, (r + 1) % n, y, (r - 1) % n, group)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return _exchange(g, (r - 1) % n, g, (r + 1) % n, ctx.group), None


class _ToFirst(torch.autograd.Function):
    """The last stage's tensor to stage 0 (zeros elsewhere); the
    gradient goes back from stage 0 to the last stage."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        got = _exchange(y, 0 if r == n - 1 else None, y,
                        n - 1 if r == 0 else None, group)
        return got if got is not None else torch.zeros_like(y)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        got = _exchange(g, n - 1 if r == 0 else None, g,
                        0 if r == n - 1 else None, ctx.group)
        return (got if got is not None else torch.zeros_like(g)), None


class _Anchor(torch.autograd.Function):
    """``out`` unchanged, with ``ts`` made part of its graph (zero
    gradient), so that every rank runs every shift's backward, in the
    same order, whatever its own outputs depend on."""

    @staticmethod
    def forward(ctx, out, *ts):
        ctx.like = [(t.shape, t.dtype, t.device) for t in ts]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *[torch.zeros(s, dtype=d, device=v)
                     for s, d, v in ctx.like])


def gpipe(stage_fn: Callable, params, x_ubatches: torch.Tensor, group, *,
          return_to_first: bool = False) -> torch.Tensor:
    """Run ``stage_fn(params, x) -> y`` (y shaped like x) as an S-stage
    pipeline over ``group``, every rank of which calls it.

      params:      this stage's parameters.
      x_ubatches:  [M, ub, ...] microbatch stream; only stage 0's copy is
                   read (other stages may pass zeros).
    Returns [M, ub, ...] outputs, valid on the last stage (or stage 0 if
    ``return_to_first``); other stages get zeros."""
    S = dist.get_world_size(group) if group is not None or \
        dist.is_initialized() else 1
    stage = dist.get_rank(group) if S > 1 else 0
    M = x_ubatches.shape[0]
    T = M + S - 1
    first = torch.tensor(stage == 0, device=x_ubatches.device)

    state = torch.zeros_like(x_ubatches[0])          # activation in flight
    banked: dict = {}
    shifted = []
    for t in range(T):
        # stage 0 ingests microbatch t while it still has fresh ones
        state = torch.where(first, x_ubatches[min(t, M - 1)], state)
        y = stage_fn(params, state)
        # the last stage banks microbatch m = t - (S - 1) when in range
        m_out = t - (S - 1)
        if stage == S - 1 and m_out >= 0:
            banked[m_out] = y
        # advance the wavefront (the wrap S-1 -> 0 carries what stage 0
        # overwrites with its next ingest)
        state = _Shift.apply(y, group) if S > 1 else y
        shifted.append(state)
    zeros = torch.zeros_like(x_ubatches[0])
    ybuf = torch.stack([banked.get(m, zeros) for m in range(M)])
    if S > 1:
        ybuf = _Anchor.apply(ybuf, *shifted)
        if return_to_first:
            ybuf = _ToFirst.apply(ybuf, group)
    return ybuf


def stage_params_spec(n_layers: int, n_stages: int) -> list[range]:
    """Contiguous layer ranges per stage (remainder to the last stages)."""
    base, rem = divmod(n_layers, n_stages)
    out, start = [], 0
    for s in range(n_stages):
        k = base + (1 if s >= n_stages - rem else 0)
        out.append(range(start, start + k))
        start += k
    assert start == n_layers
    return out


# ---------------------------------------------------------------------------
# the makespan model's view of the GPipe schedule (the shared compute
# events IR)
# ---------------------------------------------------------------------------


def gpipe_compute_events(n_microbatches: int, n_stages: int,
                         stage_seconds: float) -> tuple:
    """The pipeline's per-tick compute as executor ``ComputeEvent``s:
    tick ``t`` of the T = M + S - 1 wavefront is one opaque costed
    block of ``stage_seconds`` anchored after shift round ``t``, the
    vocabulary MoE dispatch and the grad-sync overlap register their
    consumer compute with, so the makespan model prices GPipe like any
    other pipelined schedule."""
    from repro_torch.core.schedule import ComputeEvent

    T = n_microbatches + n_stages - 1
    return tuple(ComputeEvent(f"tick{t}", float(stage_seconds),
                              after_round=t) for t in range(T))


def gpipe_wavefront_schedule(n_microbatches: int, n_stages: int,
                             stage_seconds: float):
    """The GPipe wavefront as a ``CommSchedule`` + compute events.

    One ring-shift round per tick (the shift advancing the activation in
    flight) with a ``ComputeEvent`` per tick for the stage compute.
    Consecutive shifts reuse the same slot (RAW), so no compaction pass
    may fuse them: the armed executor's makespan reproduces the classic
    pipeline cost ``shift + sum(max(shift, compute)) + compute`` instead
    of the serial sum, without GPipe-specific pricing code."""
    from repro_torch.core.schedule import CommSchedule, make_round

    M, S = int(n_microbatches), int(n_stages)
    if M < 1 or S < 1:
        raise ValueError(
            f"gpipe_wavefront_schedule: need n_microbatches >= 1 and "
            f"n_stages >= 1, got {n_microbatches}, {n_stages}")
    T = M + S - 1
    edges = tuple((i, (i + 1) % S) for i in range(S))
    send = {s: [0] for s, _ in edges}
    recv = {d: [0] for _, d in edges}
    rounds = tuple(make_round(S, edges, send, recv) for _ in range(T))
    return CommSchedule(
        nranks=S, num_slots=1, rounds=rounds,
        name=f"gpipe.wavefront[m{M}.s{S}]",
        compute_events=gpipe_compute_events(M, S, stage_seconds))
