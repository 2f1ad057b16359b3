"""The collective seam of the sharded and data-parallel steps.

Every collective the train step (both DP modes), the sharded storage
(``train.shard``), the expert-parallel dispatch and the mesh decode
issue goes through the functions here.  A ``group`` is either a process
group (``launch.mesh.Mesh.group``: the native ``torch.distributed``
collective or the ``mpix_*`` call runs) or an ``AxesGroup``
(``launch.mesh.MeshLayout.group``: no process behind it; the call is
recorded and returns a tensor of the result's shape).  The dry-run runs
the real steps on a layout of the production mesh and reads the record.
On the ``meta`` device the result is empty; on a real device (a card
timing one rank's compute, ``chip_smoke.py`` phase (M)) it is a finite,
deterministic stand-in, as if every rank of the group held this rank's
tensor: an all-gather tiles the block, an all-reduce sums n copies (the
max is the tensor itself), a reduce-scatter returns n times this rank's
block, an all-to-all this rank's own rows (tiled to as many as it
receives), and a permute the tensor itself.  Such values are for timing only.

Each call appends ``(kind, group size, result bytes, wire bytes, axes,
what)`` to the record of its group (an ``AxesGroup``'s log) or, inside
``recording()``, to the returned list for process groups too, so a run
on live ranks can be held to the dry-run's record.  ``axes`` are the
mesh axes of the group (``name_group``; None for a group no mesh
named); ``what`` is ``"param"`` for a parameter block's all-gather,
``"state"`` for a decode state's, else ``""`` (activations).  ``kind`` is the
reference's name ("all-gather", "all-reduce", "reduce-scatter",
"all-to-all", "collective-permute"), with ``mpix-`` before it for an
``mpix_*`` call.  Wire bytes of a native collective take the reference
dry-run's per-device factors on the result bytes R and group size G:
all-gather (G-1)/G R, all-reduce 2 (G-1)/G R, reduce-scatter (G-1) R,
all-to-all (G-1)/G R, permute R; an ``mpix_*`` call on a schedule
algorithm counts its compiled schedule's own bytes (``byte_count``)
over the ranks.  A group of one rank issues nothing and records nothing.

``gather_seq`` is the differentiable all-gather of the sequence-split
step (``train.shard.SeqSplit``): its backward is the reduce-scatter of
the gradient, each rank's block summed over the group.
``seq_to_tokens`` / ``tokens_to_seq`` turn a [B, S/n, ...] sequence
block into the rank's slice of the B S tokens in row order (what each
model rank takes when it holds the whole batch) and back: one uneven
all-to-all each, each the other's gradient.  In a remat region of the
split step (``remat_contexts``) these three keep their results for the
recompute, which takes them back instead of issuing them again (memory
for wire bytes: the region's gathered k/v live until its backward).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.distributed as dist

_LOGS: list = []
_AXES: dict = {}


def name_group(group, axes) -> None:
    """Record that process group ``group`` runs over mesh ``axes``."""
    _AXES[id(group)] = (group, tuple(axes))


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


def _axes_of(group):
    if isinstance(group, AxesGroup):
        return group.axes
    named = _AXES.get(id(group))
    return named[1] if named is not None and named[0] is group else None


def _record(group, kind: str, out: torch.Tensor, wire=None,
            what: str = "") -> None:
    n = size(group)
    nbytes = out.numel() * out.element_size()
    if wire is None:
        wire = _WIRE[kind](nbytes, n)
    entry = (kind, n, nbytes, float(wire), _axes_of(group), what)
    if isinstance(group, AxesGroup):
        group.log.append(entry)
    for log in _LOGS:
        log.append(entry)


def _stand_in(x: torch.Tensor, kind: str, group, dim: int = 0,
              rows: int | None = None):
    """The result of a layout's collective: empty on ``meta``, else the
    stand-in of the module docstring (``rows``: an all-to-all's)."""
    n = group.size
    if kind == "all-gather":
        shape = list(x.shape)
        shape[dim] *= n
        if x.device.type == "meta":
            return torch.empty(shape, dtype=x.dtype, device=x.device)
        return torch.cat([x] * n, dim=dim)
    if kind == "reduce-scatter":
        shape = list(x.shape)
        shape[dim] //= n
        if x.device.type == "meta":
            return torch.empty(shape, dtype=x.dtype, device=x.device)
        return x.narrow(dim, group.index * shape[dim], shape[dim]) * n
    if kind == "all-to-all":
        rows = x.shape[0] if rows is None else rows
        shape = (rows,) + tuple(x.shape[1:])
        if x.device.type == "meta":
            return torch.empty(shape, dtype=x.dtype, device=x.device)
        return torch.cat([x] * -(-rows // x.shape[0]))[:rows]
    if x.device.type == "meta":
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if kind in ("all-reduce", "all-reduce-max"):
        return x.clone() if kind == "all-reduce-max" else x * n
    return x.clone()


def all_gather(x: torch.Tensor, group, dim: int = 0,
               what: str = "") -> torch.Tensor:
    """The group's blocks concatenated along ``dim`` in group-rank
    order (``what``: see the module docstring)."""
    n = size(group)
    if n == 1:
        return x
    shape = list(x.shape)
    shape[dim] *= n
    if isinstance(group, AxesGroup):
        out = _stand_in(x, "all-gather", group, dim)
    else:
        src = x.movedim(dim, 0).contiguous()
        buf = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        fn = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        fn(buf, src, group=group)
        out = buf.movedim(0, dim)
    _record(group, "all-gather", out, what=what)
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
        out = _stand_in(x, "reduce-scatter", group, dim)
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
        out = _stand_in(x, "all-reduce-max" if op == "max" else
                        "all-reduce", group)
    else:
        out = x.detach().clone()
        dist.all_reduce(out, op=(dist.ReduceOp.MAX if op == "max"
                                 else dist.ReduceOp.SUM), group=group)
    _record(group, "all-reduce", out)
    return out


def all_to_all(x: torch.Tensor, group, send=None,
               recv=None) -> torch.Tensor:
    """Block r of ``x`` (of n along dim 0, or ``send[r]`` rows) goes to
    group rank r; the result's block r (``recv[r]`` rows) comes from
    group rank r.  Wire bytes are the rows sent to other ranks."""
    n = size(group)
    if n == 1:
        return x
    x = x.contiguous()
    row = x[:1].numel() * x.element_size()
    if send is None:
        send = recv = [x.shape[0] // n] * n
    if isinstance(group, AxesGroup):
        out = _stand_in(x, "all-to-all", group, rows=sum(recv))
    else:
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x, recv, send, group=group)
    _record(group, "all-to-all", out,
            wire=(sum(send) - send[rank(group)]) * row)
    return out


@functools.lru_cache(maxsize=64)
def _token_plan(B: int, s: int, n: int, r: int):
    """Model rank r's sequence block (rows [r s, (r + 1) s) of B rows)
    against its slice [r T, (r + 1) T) of the B n s flattened tokens
    (T = B s): the block's tokens in the order it sends them, the rows
    it sends each rank, the slice position of each token it receives
    (in the order received), the rows it receives from each rank."""
    T = B * s

    def flat(m):
        return (torch.arange(B)[:, None] * (n * s) + m * s
                + torch.arange(s)).reshape(-1)
    dest = flat(r) // T
    order = torch.argsort(dest, stable=True)
    got = [f[f // T == r] for f in map(flat, range(n))]
    return (order, torch.bincount(dest, minlength=n).tolist(),
            torch.cat(got) - r * T, [len(g) for g in got])


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(len(perm))
    return inv


def _relayout(x: torch.Tensor, group, B: int, s: int,
              to_tokens: bool) -> torch.Tensor:
    order, send, pos, recv = _token_plan(B, s, size(group), rank(group))
    tail = tuple(x.shape[(2 if to_tokens else 1):])
    if to_tokens:                   # [B, s, ...] -> [B s, ...]
        got = all_to_all(x.reshape((B * s,) + tail)[order.to(x.device)],
                         group, send, recv)
        return got[_inverse(pos).to(x.device)]
    got = all_to_all(x[pos.to(x.device)], group, recv, send)
    return got[_inverse(order).to(x.device)].reshape((B, s) + tail)


class _Relayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, B, s, to_tokens):
        ctx.args = (group, B, s, not to_tokens)
        return _relayout(x, group, B, s, to_tokens)

    @staticmethod
    def backward(ctx, g):
        return _relayout(g, *ctx.args), None, None, None, None


def seq_to_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's sequence block [B, S/n, ...] of a batch whose other
    blocks the group's other ranks hold -> its slice [r T, (r + 1) T)
    of the B S tokens in row order, [T, ...] (T = B S / n; one uneven
    all-to-all; differentiable)."""
    if size(group) == 1:
        return x.reshape((-1,) + tuple(x.shape[2:]))
    B, s = x.shape[:2]
    return _kept(_Relayout, x, (group, B, s, True),
                 lambda g: _relayout(g, group, B, s, False))


def tokens_to_seq(x: torch.Tensor, group, B: int) -> torch.Tensor:
    """The inverse of ``seq_to_tokens`` for a batch of B rows."""
    if size(group) == 1:
        return x.reshape((B, -1) + tuple(x.shape[1:]))
    s = x.shape[0] // B
    return _kept(_Relayout, x, (group, B, s, False),
                 lambda g: _relayout(g, group, B, s, True))


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of group rank r - 1 (a ring permute)."""
    n = size(group)
    if n == 1:
        return x
    if isinstance(group, AxesGroup):
        out = _stand_in(x, "collective-permute", group)
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
        out = _stand_in(x, {"allgather": "all-gather",
                            "reduce_scatter": "reduce-scatter",
                            "allreduce": "all-reduce",
                            "alltoall": "all-to-all"}[collective], group)
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


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.group, ctx.dim), None, None


def gather_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The group's blocks of a sequence concatenated along ``dim``
    (differentiable: the gradient of a block is the group's sum of the
    gradients of its rows, a reduce-scatter)."""
    if size(group) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _kept(_GatherSeq, x, (group, dim),
                     lambda g: reduce_scatter(g.contiguous(), group, dim))
    return all_gather(x.contiguous(), group, dim)


_KEEP: list = []


class _Again(torch.autograd.Function):
    """A kept result in place of its collective; the gradient is the
    collective's own."""

    @staticmethod
    def forward(ctx, x, kept, grad):
        ctx.grad = grad
        return kept.detach()

    @staticmethod
    def backward(ctx, g):
        return ctx.grad(g), None, None


def _kept(fn, x, args, grad):
    """``fn.apply(x, *args)``, unless a remat region's recompute has its
    result from the first pass (``remat_contexts``)."""
    if _KEEP:
        mode, kept = _KEEP[-1]
        if mode == "again":
            return _Again.apply(x, kept.pop(0), grad)
        out = fn.apply(x, *args)
        kept.append(out.detach())
        return out
    return fn.apply(x, *args)


def remat_contexts():
    """``torch.utils.checkpoint``'s ``context_fn`` for a region of the
    sequence-split step: its activation collectives over the model axis
    (``gather_seq``, ``seq_to_tokens`` / ``tokens_to_seq``) keep their
    results in the first pass, and the recompute takes them back instead
    of issuing the collectives again.  Parameter gathers run again, so a
    region keeps no weight."""
    kept: list = []

    @contextlib.contextmanager
    def mode(name):
        _KEEP.append((name, kept))
        try:
            yield
        finally:
            _KEEP.pop()
    return mode("first"), mode("again")
