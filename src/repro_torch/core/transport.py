"""Transport backends that execute a ``CommSchedule`` (see schedule.py).

MPI Advance writes every collective algorithm once, against MPI point-to-
point primitives, and runs it on any substrate.  We keep the same split:
one IR (``CommSchedule``: gather tables -> static permutation -> scatter
tables), three executors:

  * ``SimTransport``    — numpy, rank-by-rank.  Bit-exact execution of a
                          schedule for N simulated ranks on zero devices;
                          ``run_reference`` is the semantic oracle.
  * ``DistTransport``   — ``torch.distributed`` point-to-point: each
                          compiled round is one ``batch_isend_irecv`` on
                          the rank's local buffer (NCCL across cards,
                          gloo on the host).
  * ``KernelTransport`` — the WHOLE compiled schedule as ONE CUDA kernel
                          (core.kernel_lowering) on the global buffer:
                          one ``all_gather`` and one launch instead of
                          one exchange per round.

Buffers are slot-indexed: ``[num_slots, *slot]`` per rank, or
``[nranks, num_slots, *slot]`` globally.  Semantics shared by all three:
a rank that is not a destination in a round receives nothing and keeps
its rows, gather index -1 sends zeros, scatter index -1 drops, and
``reduce=True`` adds one received slot at a time, in (edge, position)
order.  Every ``run`` is a thin lookup into the cached ``CompiledExec``
(core.executor).
"""
from __future__ import annotations

import abc

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import executor
from repro_torch.core.schedule import CommRound, CommSchedule
from repro_torch.core.topology import Topology


class TransportError(RuntimeError):
    """A substrate failed to execute a round/schedule (a failed kernel
    launch, a dropped exchange).  Typed so a recovery ladder can tell a
    *transport* failure — retryable, degradable to another substrate —
    from a programming error, which must stay loud.

    ``transport`` names the substrate, ``round_idx`` the failing round
    (-1 when the failure is not round-attributable)."""

    def __init__(self, msg: str, *, transport: str = "?",
                 round_idx: int = -1):
        super().__init__(msg)
        self.transport = transport
        self.round_idx = round_idx


class Transport(abc.ABC):
    """Executes schedules for a fixed rank count.

    An optional ``topo`` arms the persistent-executor compile pass with
    the alpha-beta cost model (see core.executor); the executor cache
    keys on the topology fingerprint.
    """

    nranks: int
    topo: Topology | None

    @abc.abstractmethod
    def run(self, schedule: CommSchedule, buf):
        """Execute ``schedule`` on a slot-indexed buffer and return it."""


def _split_rows(buf, chunks: int, name: str) -> int:
    """Validate a row-chunked call and return the rows per chunk."""
    if chunks <= 0:
        raise ValueError(f"{name}: chunks must be >= 1, got {chunks}")
    rows = buf.shape[1]
    if rows % chunks:
        raise ValueError(f"{name}: row count {rows} is not divisible by "
                         f"chunks={chunks}")
    return rows // chunks


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``all_gather_into_tensor`` (under its newer name where the
    installed torch has it)."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x.contiguous(), group=group)


# ---------------------------------------------------------------------------
# numpy simulator
# ---------------------------------------------------------------------------


class SimTransport(Transport):
    """Rank-by-rank numpy execution: ``buf`` is [nranks, num_slots, *slot].

    Exact semantics match DistTransport:
      * a rank that is not a destination in a round receives zeros,
      * gather index -1 sends zeros,
      * scatter index -1 drops the received slot,
      * ``reduce=True`` accumulates (+=) instead of overwriting,
      * (r, r) self-pairs deliver the rank's own payload (on-chip copy).
    """

    def __init__(self, nranks: int, topo: Topology | None = None):
        self.nranks = nranks
        self.topo = topo

    def run(self, schedule: CommSchedule, buf):
        """Compiled-path execution: one vectorized gather/permute/scatter
        per round through the cached ``CompiledExec``."""
        assert buf.shape[0] == self.nranks, (buf.shape, self.nranks)
        assert buf.shape[1] == schedule.num_slots
        return executor.get_executor(schedule, topo=self.topo).run_sim(buf)

    def run_chunked(self, schedule: CommSchedule, buf: np.ndarray, *,
                    chunks: int, consume=None, init=None):
        """Row-chunked (partitioned) execution: split the slot row axis
        (axis 2 of [nranks, num_slots, rows, ...]) into ``chunks`` equal
        pieces, run the full schedule per piece, and fold each piece's
        output through ``consume(carry, out, i)`` as soon as it lands.
        With ``consume=None`` the outputs are reassembled, bit-identical
        to ``run`` (schedules never mix rows)."""
        assert buf.ndim >= 3, buf.shape
        rc = _split_rows(buf[0], chunks, "run_chunked")
        carry = init
        outs = []
        for i in range(chunks):
            piece = np.ascontiguousarray(buf[:, :, i * rc:(i + 1) * rc])
            out = self.run(schedule, piece)
            if consume is None:
                outs.append(out)
            else:
                carry = consume(carry, out, i)
        if consume is None:
            return np.concatenate(outs, axis=2)
        return carry

    def run_reference(self, schedule: CommSchedule,
                      buf: np.ndarray) -> np.ndarray:
        """The original rank-by-rank loop — kept as the semantic oracle
        the compiled/fused path is tested bit-exact against."""
        assert buf.shape[0] == self.nranks, (buf.shape, self.nranks)
        assert buf.shape[1] == schedule.num_slots
        buf = buf.copy()
        if schedule.local_pre is not None:
            buf = np.stack([buf[r, schedule.local_pre[r]]
                            for r in range(self.nranks)])
        for rnd in schedule.rounds:
            buf = self._round(rnd, buf)
        if schedule.local_post is not None:
            buf = np.stack([buf[r, schedule.local_post[r]]
                            for r in range(self.nranks)])
        return buf

    def _round(self, rnd: CommRound, buf: np.ndarray) -> np.ndarray:
        slot_shape = buf.shape[2:]
        # Everyone starts this round receiving zeros.
        inbox = np.zeros((self.nranks, rnd.k) + slot_shape, buf.dtype)
        for src, dst in rnd.perm:
            gather = rnd.gather_idx[src]
            payload = np.zeros((rnd.k,) + slot_shape, buf.dtype)
            valid = gather >= 0
            payload[valid] = buf[src, gather[valid]]
            inbox[dst] = payload
        out = buf.copy()
        dst_set = {d for _, d in rnd.perm}
        for r in range(self.nranks):
            if r not in dst_set:
                continue
            scatter = rnd.scatter_idx[r]
            for slot in range(rnd.k):
                tgt = scatter[slot]
                if tgt < 0:
                    continue
                if rnd.reduce:
                    out[r, tgt] = out[r, tgt] + inbox[r, slot]
                else:
                    out[r, tgt] = inbox[r, slot]
        return out


# ---------------------------------------------------------------------------
# torch.distributed point-to-point substrate
# ---------------------------------------------------------------------------


class DistTransport(Transport):
    """Executes schedules with ``torch.distributed`` point-to-point.

    ``run`` is called by every rank of ``group`` (``None`` = the default
    group) with its *local* buffer [num_slots, *slot]; the group rank is
    the schedule rank.  Each compiled round is one
    ``batch_isend_irecv``: a source gathers its payload from the
    pre-round state and sends it, a destination receives and lands it
    one (edge, position) at a time — ``work[t] = work[t] + inbox[j]``
    on reduce rounds, masked zero payloads included.  No ``index_add_``:
    on CUDA it does not keep that order.
    """

    def __init__(self, nranks: int, group=None,
                 topo: Topology | None = None):
        self.nranks = nranks
        self.group = group
        self.topo = topo

    def _rank(self) -> int:
        n = dist.get_world_size(self.group)
        if n != self.nranks:
            raise ValueError(f"DistTransport for {self.nranks} ranks run "
                             f"on a group of {n}")
        return dist.get_rank(self.group)

    def _peer(self, r: int) -> int:
        group = self.group if self.group is not None else dist.group.WORLD
        return dist.get_global_rank(group, r)

    def run(self, schedule: CommSchedule, buf: torch.Tensor) -> torch.Tensor:
        assert buf.shape[0] == schedule.num_slots, (buf.shape,
                                                    schedule.num_slots)
        r = self._rank()
        ex = executor.get_executor(schedule, topo=self.topo)
        dev = buf.device
        if ex._pre is not None:
            work = buf[torch.from_numpy(ex._pre[r]).to(dev)]
        else:
            work = buf.clone()
        for q, rnd in enumerate(ex._rounds):
            self._round(rnd, work, r, q)
        if ex._post is not None:
            work = work[torch.from_numpy(ex._post[r]).to(dev)]
        return work

    def _round(self, rnd, work: torch.Tensor, r: int, q: int) -> None:
        se, re = int(rnd.send_edge[r]), int(rnd.recv_edge[r])
        ops = []
        payload = inbox = None
        if se >= 0:
            mask = rnd.g_mask[se]
            idx = torch.from_numpy(np.where(mask, rnd.g_safe[se], 0))
            payload = work[idx.to(work.device)]
            payload[torch.from_numpy(~mask).to(work.device)] = 0
            dst = int(rnd.dst[se])
            if dst != r:
                ops.append(dist.P2POp(dist.isend, payload, self._peer(dst),
                                      self.group))
        if re >= 0:
            src = int(rnd.src[re])
            if src == r:
                inbox = payload                    # on-chip self-copy
            else:
                inbox = work.new_empty((rnd.k,) + tuple(work.shape[1:]))
                ops.append(dist.P2POp(dist.irecv, inbox, self._peer(src),
                                      self.group))
        if ops:
            try:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            except RuntimeError as e:
                raise TransportError(f"round {q}: {e}", transport="dist",
                                     round_idx=q) from e
        if re < 0:
            return                                 # not a destination
        for j in range(rnd.k):
            if not rnd.t_mask[re, j]:
                continue                           # dropped on arrival
            t = int(rnd.t_safe[re, j])
            if rnd.reduce:
                work[t] = work[t] + inbox[j]
            else:
                work[t] = inbox[j]

    def run_chunked(self, schedule: CommSchedule, buf: torch.Tensor, *,
                    chunks: int, consume=None, init=None):
        """Row-chunked execution of the local buffer [num_slots, rows,
        ...]: the full schedule runs once per row piece and each piece's
        output is folded through ``consume(carry, out, i)``; with
        ``consume=None`` the pieces reassemble to exactly ``run``'s
        result."""
        rc = _split_rows(buf, chunks, "run_chunked")
        carry = init
        outs = []
        for i in range(chunks):
            out = self.run(schedule, buf[:, i * rc:(i + 1) * rc].contiguous())
            if consume is None:
                outs.append(out)
            else:
                carry = consume(carry, out, i)
        return torch.cat(outs, dim=1) if consume is None else carry

    def run_global(self, schedule: CommSchedule,
                   gbuf: torch.Tensor) -> torch.Tensor:
        """The ``SimTransport`` calling convention over the group: every
        rank passes the same global [nranks, num_slots, *slot] buffer,
        runs its own row, and gets the gathered global result."""
        assert gbuf.shape[0] == self.nranks, (gbuf.shape, self.nranks)
        local = self.run(schedule, gbuf[self._rank()].contiguous())
        out = local.new_empty((self.nranks,) + tuple(local.shape))
        _all_gather(out.view((-1,) + tuple(local.shape[1:])), local,
                    self.group)
        return out


# ---------------------------------------------------------------------------
# device-side kernel substrate
# ---------------------------------------------------------------------------


class KernelTransport(Transport):
    """Device-side execution: the WHOLE compiled schedule as ONE CUDA
    kernel (core.kernel_lowering) instead of one exchange per round.

    Used standalone (``run_global``, the SimTransport calling
    convention), or by every rank of ``group`` (``run``): the local
    buffers are combined with one ``all_gather``, every rank runs the
    kernel on the replicated global buffer (deterministic, so all ranks
    agree bit-for-bit), and each keeps its own row.  That trades
    bandwidth (the gather ships n x the data) for launches (one
    collective and one kernel instead of R exchanges).  A CPU tensor
    runs the kernel's plain PyTorch version.
    """

    def __init__(self, nranks: int, group=None,
                 topo: Topology | None = None):
        self.nranks = nranks
        self.group = group
        self.topo = topo

    def run_global(self, schedule: CommSchedule, gbuf: torch.Tensor, *,
                   chunks: int = 1) -> torch.Tensor:
        """Execute on a global [nranks, num_slots, *slot] buffer — one
        kernel launch; ``chunks > 1`` splits the slot row axis across the
        launch's grid (bit-identical)."""
        from repro_torch.core.kernel_lowering import get_kernel_exec
        assert gbuf.shape[0] == self.nranks, (gbuf.shape, self.nranks)
        assert gbuf.shape[1] == schedule.num_slots
        return get_kernel_exec(schedule, topo=self.topo).run(
            gbuf, chunks=chunks)

    def _gather(self, buf: torch.Tensor) -> torch.Tensor:
        n = dist.get_world_size(self.group)
        if n != self.nranks:
            raise ValueError(f"KernelTransport for {self.nranks} ranks run "
                             f"on a group of {n}")
        gbuf = buf.new_empty((n,) + tuple(buf.shape))
        _all_gather(gbuf.view((-1,) + tuple(buf.shape[1:])), buf,
                    self.group)
        return gbuf

    def run(self, schedule: CommSchedule, buf: torch.Tensor) -> torch.Tensor:
        """Called by every rank of the group with its *local* buffer
        [num_slots, *slot]; returns the local result."""
        out = self.run_global(schedule, self._gather(buf))
        return out[dist.get_rank(self.group)]

    def run_chunked(self, schedule: CommSchedule, buf: torch.Tensor, *,
                    chunks: int, consume=None, init=None):
        """Row-chunked execution of the local buffer.  With
        ``consume=None`` the chunking collapses into the kernel's grid
        (one gather, one launch, same result as ``run``); with a
        consumer each row piece runs gather + kernel and is folded
        through ``consume(carry, out, i)``."""
        rc = _split_rows(buf, chunks, "run_chunked")
        if consume is None:
            out = self.run_global(schedule, self._gather(buf), chunks=chunks)
            return out[dist.get_rank(self.group)]
        carry = init
        for i in range(chunks):
            carry = consume(carry, self.run(
                schedule, buf[:, i * rc:(i + 1) * rc].contiguous()), i)
        return carry
