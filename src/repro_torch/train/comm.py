"""The collective seam of the sharded and data-parallel steps.

Every collective the train step (both DP modes), the sharded storage
(``train.shard``), the expert-parallel dispatch and the mesh decode
issue goes through the functions here.  A ``group`` is either a process
group (``launch.mesh.Mesh.group``: the native ``torch.distributed``
collective or the ``mpix_*`` call runs) or an ``AxesGroup``
(``launch.mesh.MeshLayout.group``: no process behind it; the call is
recorded and returns a tensor of the result's shape, empty on the
``meta`` device).  The dry-run runs the real steps on a layout of the
production mesh and reads the record.

Each call appends ``(kind, group size, result bytes, wire bytes)`` to
the record of its group (an ``AxesGroup``'s log) or, inside
``recording()``, to the returned list for process groups too, so a run
on live ranks can be held to the dry-run's record.  ``kind`` is the
reference's name ("all-gather", "all-reduce", "reduce-scatter",
"all-to-all", "collective-permute"), with ``mpix-`` before it for an
``mpix_*`` call.  Wire bytes of a native collective take the reference
dry-run's per-device factors on the result bytes R and group size G:
all-gather (G-1)/G R, all-reduce 2 (G-1)/G R, reduce-scatter (G-1) R,
all-to-all (G-1)/G R, permute R; an ``mpix_*`` call on a schedule
algorithm counts its compiled schedule's own bytes (``byte_count``)
over the ranks.  A group of one rank issues nothing and records nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

_LOGS: list = []


@dataclasses.dataclass(frozen=True)
class AxesGroup:
    """A group of a ``MeshLayout``: its axes, size, this rank's index in
    it, and the record its calls append to."""
    axes: tuple
    size: int
    index: int
    log: list = dataclasses.field(compare=False, repr=False)


@contextlib.contextmanager
def recording():
    """Record the calls on process groups too (the list it yields)."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def size(group) -> int:
    if isinstance(group, AxesGroup):
        return group.size
    return dist.get_world_size(group)


def rank(group) -> int:
    if isinstance(group, AxesGroup):
        return group.index
    return dist.get_rank(group)


_WIRE = {"all-gather": lambda r, g: r * (g - 1) / g,
         "all-reduce": lambda r, g: 2 * r * (g - 1) / g,
         "reduce-scatter": lambda r, g: r * (g - 1),
         "all-to-all": lambda r, g: r * (g - 1) / g,
         "collective-permute": lambda r, g: float(r)}


def _record(group, kind: str, out: torch.Tensor, wire=None) -> None:
    n = size(group)
    nbytes = out.numel() * out.element_size()
    if wire is None:
        wire = _WIRE[kind](nbytes, n)
    entry = (kind, n, nbytes, float(wire))
    if isinstance(group, AxesGroup):
        group.log.append(entry)
    for log in _LOGS:
        log.append(entry)


def _meta_like(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.empty(shape, dtype=x.dtype, device=x.device)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's blocks concatenated along ``dim`` in group-rank
    order."""
    n = size(group)
    if n == 1:
        return x
    shape = list(x.shape)
    shape[dim] *= n
    if isinstance(group, AxesGroup):
        out = _meta_like(x, shape)
    else:
        src = x.movedim(dim, 0).contiguous()
        buf = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        fn = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        fn(buf, src, group=group)
        out = buf.movedim(0, dim)
    _record(group, "all-gather", out)
    return out


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over the group, cut along ``dim``: this rank's block."""
    n = size(group)
    if n == 1:
        return x
    shape = list(x.shape)
    if shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {n} ranks")
    shape[dim] //= n
    if isinstance(group, AxesGroup):
        out = _meta_like(x, shape)
    else:
        src = x.movedim(dim, 0).contiguous()
        buf = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        fn = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        fn(buf, src, group=group)
        out = buf.movedim(0, dim)
    _record(group, "reduce-scatter", out)
    return out


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: the group's sum (``op="max"``: maximum) of ``x``."""
    if size(group) == 1:
        return x
    if isinstance(group, AxesGroup):
        out = _meta_like(x, x.shape)
    else:
        out = x.detach().clone()
        dist.all_reduce(out, op=(dist.ReduceOp.MAX if op == "max"
                                 else dist.ReduceOp.SUM), group=group)
    _record(group, "all-reduce", out)
    return out


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of group rank r - 1 (a ring permute)."""
    n = size(group)
    if n == 1:
        return x
    if isinstance(group, AxesGroup):
        out = _meta_like(x, x.shape)
    else:
        r = dist.get_rank(group)
        g = group if group is not None else dist.group.WORLD
        out = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.contiguous(),
                       dist.get_global_rank(g, (r + 1) % n), group),
            dist.P2POp(dist.irecv, out,
                       dist.get_global_rank(g, (r - 1) % n), group)])
        for q in reqs:
            q.wait()
    _record(group, "collective-permute", out)
    return out


_NATIVE = {"allgather": "all-gather", "allreduce": "all-reduce",
           "reduce_scatter": "reduce-scatter", "alltoall": "all-to-all"}


def mpix(collective: str, x: torch.Tensor, group, **kw) -> torch.Tensor:
    """``mpix_<collective>(x, group, **kw)`` (allgather, allreduce,
    reduce_scatter, alltoall)."""
    from repro_torch.core import api
    n = size(group)
    if isinstance(group, AxesGroup):
        shape = list(x.shape)
        if collective == "allgather":
            shape[0] *= n
        elif collective == "reduce_scatter":
            shape[0] //= n
        out = _meta_like(x, shape)
    else:
        out = getattr(api, f"mpix_{collective}")(x, group, **kw)
    if n == 1:
        return out
    algo = kw.get("algorithm", "auto")
    topo = kw.get("topo")
    nbytes = x.numel() * x.element_size()
    if algo != "xla":
        from repro_torch.core.topology import flat_topology
        topo = topo or flat_topology(n)
        algo = api._algorithm(collective, algo, kw.get("policy"), topo,
                              nbytes)
    if algo == "xla":
        _record(group, _NATIVE[collective], out)
    else:
        sched = api._schedule(collective, algo, topo)
        slot = {"allgather": nbytes,
                "allreduce": -(-x.numel() // n) * x.element_size(),
                "reduce_scatter": nbytes // n,
                "alltoall": nbytes // n}[collective]
        _record(group, "mpix-" + _NATIVE[collective], out,
                wire=sched.byte_count(slot) / n)
    return out
