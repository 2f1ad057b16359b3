"""Partitioned communication (paper §2.3, MPIPCL) over a process group.

MPIPCL channelizes a point-to-point message: one match at init, then the
buffer moves as P independently-committed *partitions*, letting transfer
of ready partitions overlap with production/consumption of the rest
("early-bird" communication).  On the unified IR a partitioned transfer
is a ``CommSchedule`` of P rounds, one chunk each
(``partitioned_schedule``), so it runs on any transport and the tuner
can time the partition-count tradeoff like any other schedule.

The runtime forms take a ``ProcessGroup`` (``None`` = the default
group), as the port's API does; every rank of the group calls them with
its local tensors:

  * ``partitioned_ppermute``  — the raw primitive: chunked point-to-point
    (one ``batch_isend_irecv`` per partition) with a per-partition
    consumer (receive-side early-bird);
  * ``allgather_matmul``      — ring allgather where every arriving
    shard is multiplied while the next one is in flight;
  * ``matmul_reduce_scatter`` — each output chunk's partial product is
    shipped as soon as it is computed, while the next is produced
    (early-bird send);
  * ``bucketed_psum``         — a gradient tree reduced in independent
    flat buckets, one ``all_reduce`` each (DDP bucketing).

The products are plain ``torch.matmul``s.
"""
from __future__ import annotations

import functools
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.schedule import CommSchedule, make_round
from repro_torch.core.topology import Topology


def _shift_perm(n: int, shift: int = 1) -> list[tuple[int, int]]:
    return [(i, (i + shift) % n) for i in range(n)]


def partitioned_schedule(nranks: int, perm: Sequence[tuple[int, int]],
                         partitions: int = 1) -> CommSchedule:
    """A partitioned point-to-point transfer as a ``CommSchedule``.

    The working buffer has ``2 * partitions`` slots per rank: rows
    ``[0, P)`` hold the outgoing chunks, rows ``[P, 2P)`` receive.
    Round ``i`` ships chunk ``i`` along ``perm`` — MPIPCL's P
    independently-committed partitions, expressed in the same IR the
    dense and neighborhood collectives compile to.
    """
    P = int(partitions)
    if P < 1:
        raise ValueError(
            f"partitioned_schedule: partitions must be >= 1, got "
            f"{partitions}")
    edges = tuple((int(s), int(d)) for s, d in perm)
    rounds = []
    for i in range(P):
        send = {s: [i] for s, _ in edges}
        recv = {d: [P + i] for _, d in edges}
        rounds.append(make_round(nranks, edges, send, recv))
    return CommSchedule(
        nranks=nranks, num_slots=2 * P, rounds=tuple(rounds),
        name=f"partitioned.shift[p{P}]", out_slots=P,
        out_offsets=np.full(nranks, P, np.int64))


def _chunked_shift(topo: Topology, partitions: int) -> CommSchedule:
    return partitioned_schedule(topo.nranks, _shift_perm(topo.nranks),
                                partitions)


ALGORITHMS = {
    f"p{p}": functools.partial(_chunked_shift, partitions=p)
    for p in (1, 2, 4, 8)
}


# ---------------------------------------------------------------------------
# point-to-point over the group
# ---------------------------------------------------------------------------


def _peers(group, perm) -> tuple[int, int, int | None, int | None]:
    """(this rank, group size, where it sends, whence it receives)."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    dst = next((int(d) for s, d in perm if int(s) == rank), None)
    src = next((int(s) for s, d in perm if int(d) == rank), None)
    return rank, n, dst, src


def _global(group, r: int) -> int:
    return dist.get_global_rank(group if group is not None
                                else dist.group.WORLD, r)


def _start(x: torch.Tensor, group, perm):
    """Post one ``ppermute`` of ``x`` along ``perm``: returns a finisher
    that waits and gives what this rank received (zeros where no edge
    lands on it, its own ``x`` on a self edge)."""
    rank, _, dst, src = _peers(group, perm)
    x = x.contiguous()
    ops = []
    if dst is not None and dst != rank:
        ops.append(dist.P2POp(dist.isend, x, _global(group, dst), group))
    if src is None:
        inbox = torch.zeros_like(x)
    elif src == rank:
        inbox = x.clone()
    else:
        inbox = torch.empty_like(x)
        ops.append(dist.P2POp(dist.irecv, inbox, _global(group, src), group))
    reqs = dist.batch_isend_irecv(ops) if ops else []

    def finish() -> torch.Tensor:
        for req in reqs:
            req.wait()
        return inbox

    return finish


def _shift_perm(n: int, shift: int = 1) -> list[tuple[int, int]]:
    return [(i, (i + shift) % n) for i in range(n)]


def partitioned_ppermute(x: torch.Tensor, group, perm, partitions: int,
                         consume: Callable | None = None, init=None,
                         via: str = "p2p"):
    """Send ``x`` along ``perm`` (pairs of group ranks) in
    ``partitions`` chunks of its leading dim.

    Without ``consume``: returns the fully received buffer — identical
    to one monolithic exchange (the 1-partition case *is* the
    monolithic transfer).  ``via="p2p"`` posts one ``batch_isend_irecv``
    per partition; ``via="schedule"`` runs ``partitioned_schedule`` on
    ``DistTransport`` instead (identical result; the tuner can time it
    like any collective).  A rank no edge lands on receives zeros.

    With ``consume(carry, chunk) -> carry``: receive-side early-bird —
    each arriving partition is folded into ``carry`` as it lands, while
    the next partition's exchange is already posted.
    """
    if partitions <= 0:
        raise ValueError(
            f"partitioned_ppermute: partitions must be >= 1, got "
            f"{partitions}")
    if x.shape[0] % partitions:
        raise ValueError(
            f"partitioned_ppermute: leading dim {x.shape[0]} of input "
            f"shape {tuple(x.shape)} must be divisible by "
            f"partitions={partitions}")
    if via not in ("p2p", "schedule"):
        raise ValueError(f"partitioned_ppermute: unknown via {via!r}; "
                         f"expected p2p | schedule")
    chunks = x.reshape((partitions, x.shape[0] // partitions)
                       + tuple(x.shape[1:]))
    if consume is None and via == "schedule":
        from repro_torch.core.transport import DistTransport
        n = dist.get_world_size(group)
        sched = partitioned_schedule(n, perm, partitions)
        buf = torch.cat([chunks, torch.zeros_like(chunks)], 0)
        out = DistTransport(n, group).run(sched, buf)
        return out[partitions:].reshape(x.shape)
    pending = _start(chunks[0], group, perm)
    carry, outs = init, []
    for i in range(partitions):
        arrived = pending()
        if i + 1 < partitions:                 # next partition in flight
            pending = _start(chunks[i + 1], group, perm)
        if consume is None:
            outs.append(arrived)
        else:
            carry = consume(carry, arrived)
    if consume is None:
        return torch.stack(outs).reshape(x.shape)
    return carry


# ---------------------------------------------------------------------------
# receive-side overlap: allgather-matmul (collective matmul)
# ---------------------------------------------------------------------------


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def _chunked_matmul(x: torch.Tensor, w: torch.Tensor,
                    parts: int) -> torch.Tensor:
    if parts <= 1 or x.shape[0] % parts:
        return _dot(x, w)
    return torch.cat([_dot(c, w) for c in x.chunk(parts)], 0)


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, group=None, *,
                     partitions_per_rank: int = 1) -> torch.Tensor:
    """``all_gather(x) @ w`` as a ring pipeline: each ring step's
    arriving shard is multiplied while the next shard is in flight.

    x: [m_local, k] (this rank's shard of the row dimension)
    w: [k, n] (the same on every rank)
    returns [m_local * group size, n] — the layout of the unfused op.
    """
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    m_local = x.shape[0]
    out = x.new_zeros((n, m_local, w.shape[1]),
                      dtype=torch.promote_types(x.dtype, w.dtype))
    # ring: at step t this rank holds the shard of rank (rank + t) mod n
    perm = _shift_perm(n, -1 % n)              # pass shards backwards
    buf = x.contiguous()
    for t in range(n):
        pending = _start(buf, group, perm) if t + 1 < n else None
        out[(rank + t) % n] = _chunked_matmul(buf, w, partitions_per_rank)
        if pending is not None:
            buf = pending()
    return out.reshape(n * m_local, w.shape[1])


# ---------------------------------------------------------------------------
# send-side overlap: matmul-reduce-scatter
# ---------------------------------------------------------------------------


def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor,
                          group=None) -> torch.Tensor:
    """``reduce_scatter(x @ w)`` as a ring pipeline: the partial of the
    output chunk for rank r+t is computed at step t and enters the
    reduction ring while the next chunk's partial is being produced
    (early-bird send).

    x: [m, k_local]  w: [k_local, n]   (k contracted over the group)
    returns this rank's [m / group size, n] reduced scatter shard.
    """
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    m = x.shape[0]
    if m % n:
        raise ValueError(
            f"matmul_reduce_scatter: leading dim {m} of input shape "
            f"{tuple(x.shape)} must be divisible by the group size {n}")
    xs = x.reshape(n, m // n, x.shape[1])
    perm = _shift_perm(n, 1)
    acc = x.new_zeros((m // n, w.shape[1]),
                      dtype=torch.promote_types(x.dtype, w.dtype))
    # the travelling accumulator of chunk c starts at rank c+1 and visits
    # the ring in +1 order, so rank r adds chunk (r - t) at step t, then
    # its own chunk last
    mine = _dot(xs[(rank - 1) % n], w)
    for t in range(1, n):
        pending = _start(acc + mine, group, perm)
        mine = _dot(xs[(rank - t - 1) % n], w)   # next, while in flight
        acc = pending()
    return acc + mine


# ---------------------------------------------------------------------------
# gradient bucketing (partitioned allreduce over a tree of tensors)
# ---------------------------------------------------------------------------


def _flatten(tree) -> list:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _flatten(v)]
    return [tree]


def _unflatten(tree, leaves):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def bucketed_psum(tree, group=None, *, buckets: int = 4):
    """Sum a dict / list / tuple of tensors over the group in
    ``buckets`` independent flat buckets, one ``dist.all_reduce`` each.

    Equal to summing each tensor over the group; the point is schedule
    freedom: each bucket's reduction is an independent collective that
    can overlap with the compute producing later buckets' inputs.
    Dict leaves are taken in sorted key order, as the reference's tree
    flattening does.
    """
    if buckets < 1:
        raise ValueError(f"bucketed_psum: buckets must be >= 1, got "
                         f"{buckets}")
    leaves = _flatten(tree)
    if not leaves:
        return tree
    dtype = functools.reduce(torch.promote_types, [l.dtype for l in leaves])
    flat = torch.cat([l.reshape(-1).to(dtype) for l in leaves])
    total = flat.numel()
    per = -(-total // buckets)
    flat = torch.cat([flat, flat.new_zeros(per * buckets - total)])
    parts = flat.reshape(buckets, per)
    for i in range(buckets):
        dist.all_reduce(parts[i], group=group)
    out, off = [], 0
    for l in leaves:
        out.append(flat[off: off + l.numel()].reshape(l.shape).to(l.dtype))
        off += l.numel()
    return _unflatten(tree, iter(out))
