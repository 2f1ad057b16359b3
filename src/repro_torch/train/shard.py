"""Sharded storage: each rank holds only its block of every parameter
(and of whatever follows a parameter's spec: the AdamW moments, the
error-feedback residual, a decode cache), as ``train.sharding``'s spec
cuts it over *every* axis it names.  A rank's stored bytes are then
exactly the share the spec gives.

A parameter is gathered where it is used: ``sharded_model`` builds a
model view whose top-level tensors (embedding, head, final norm) are
gathered once per call and whose layers are gathered one at a time by
``models.model`` when it runs them (inside each period's remat region:
a parameter's full value lives while its layer runs, and again in the
recompute).  The gather is an autograd function: forward all-gathers
the block along each cut dim; backward turns the full gradient into the
block's gradient, summed over the plan's sum axes: a reduce-scatter
along each cut dim whose axes are all summed, an all-reduce over the
summed axes no such cut names, then a plain slice over the remaining
cut dims (a gradient that already agrees there).

Compute on the model axis takes two forms:
  * training and prefill split the *sequence* (``SeqSplit``, the
    reference's ``attn_logits`` / ``residual`` hints): each model rank
    runs its contiguous S/n rows with the gathered weights, so a
    weight's gradient on a model rank is a partial sum over its rows
    and the plans sum over ``model`` as well as the data axes;
  * decode keeps every block cut over ``model`` where it is stored
    (``Resident``): a weight cut on its output dim multiplies its
    column block and the product's few rows are all-gathered over
    ``model``; only the data axes gather parameters.
Under ``moe_mode="mpix_ep"`` an expert stack's block over the EP axes
stays where it is stored (``keep``); its gradient is already whole over
those axes (the alltoall brought every EP rank's tokens to it).

Every collective goes through ``train.comm``; on a ``MeshLayout`` (no
process group) the calls are recorded instead of run.
"""
from __future__ import annotations

import dataclasses
import types

import torch

from repro_torch.train import comm
from repro_torch.train.sharding import data_axes, entry_axes, spec_axes


class ShardPlan:
    """How one tensor of ``spec`` lies on ``mesh``: its cut dims (each
    with the axes of size > 1 it is cut over) and this rank's block.

    ``keep``: axes whose cuts stay where they are stored (a cut that
    names one of them is not gathered; its gradient is already the
    block's).  ``sum_axes``: the axes a gradient is summed over (default
    the data axes; the sequence split adds ``model``), less ``keep``."""

    def __init__(self, spec, mesh, *, keep=(), sum_axes=None,
                 what: str = "param"):
        self.mesh, self.what = mesh, what   # ``what``: see ``train.comm``
        self.spec = tuple(spec)
        self.cuts, self.kept = [], []
        for dim, e in enumerate(self.spec):
            axes = tuple(a for a in entry_axes(e) if mesh.shape[a] > 1)
            if axes:
                (self.kept if set(axes) & set(keep) else
                 self.cuts).append((dim, axes))
        if sum_axes is None:
            sum_axes = data_axes(mesh)
        self.d_axes = tuple(a for a in mesh.axis_names if a in sum_axes
                            and a not in keep and mesh.shape[a] > 1)
        named = set(spec_axes(self.spec))
        # the rank that counts this block once in a global sum
        self.owner = all(mesh.coords[a] == 0 for a in mesh.axis_names
                         if a not in named)

    def groups(self) -> list:
        """Every group the plan's collectives use (to create them in one
        order on every rank)."""
        out = [axes for _, axes in self.cuts + self.kept]
        if self.d_axes:
            out.append(self.d_axes)
            out.append(self._rest())
        return [g for g in out if g]

    @property
    def trivial(self) -> bool:
        return not self.cuts and not self.d_axes

    def _narrow(self, t, dim, axes):
        n = self.mesh.axis_size(axes)
        blk = t.shape[dim] // n
        return t.narrow(dim, self.mesh.axis_index(axes) * blk, blk)

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full tensor (a copy)."""
        t = full
        for dim, axes in sorted(self.cuts + self.kept):
            t = self._narrow(t, dim, axes)
        return t.contiguous().clone() if self.cuts or self.kept else t

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The tensor over every rank's blocks (collective): whole but
        for the kept cuts."""
        t = block
        for dim, axes in self.cuts:
            t = comm.all_gather(t, self.mesh.group(axes), dim, self.what)
        return t

    def _summed(self) -> list:
        """The cuts whose axes are all summed: reduce-scattered."""
        return [(d, a) for d, a in self.cuts if set(a) <= set(self.d_axes)]

    def _rest(self) -> tuple:
        covered = {a for _, axes in self._summed() for a in axes}
        return tuple(a for a in self.d_axes if a not in covered)

    def grad(self, g: torch.Tensor) -> torch.Tensor:
        """The block's gradient from this rank's gradient of the gathered
        tensor: summed over the sum axes, cut to the block."""
        mesh = self.mesh
        summed = self._summed()
        for dim, axes in summed:
            g = comm.reduce_scatter(g, mesh.group(axes), dim)
        rest = self._rest()
        if rest:
            g = comm.all_reduce(g, mesh.group(rest))
        for dim, axes in self.cuts:
            if (dim, axes) not in summed:
                g = self._narrow(g, dim, axes)
        return g.contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, plan):
        ctx.plan = plan
        return plan.gather(block) if plan.cuts else block.view_as(block)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.grad(g), None


def gather_param(block: torch.Tensor, plan: ShardPlan) -> torch.Tensor:
    """The full parameter for use (differentiable: see ``_Gather``)."""
    if plan.trivial:
        return block
    if torch.is_grad_enabled() and block.requires_grad:
        return _Gather.apply(block, plan)
    return plan.gather(block)


def plans_for(specs: dict, mesh, *, keep=None, sum_axes=None) -> dict:
    """``{name: ShardPlan}``; every group the plans use is created here,
    in one order on every rank.  ``keep(name, spec)`` gives a plan's kept
    axes (default none); ``sum_axes`` its gradient's."""
    plans = {k: ShardPlan(s, mesh, keep=keep(k, s) if keep else (),
                          sum_axes=sum_axes) for k, s in specs.items()}
    seen = set()
    for p in plans.values():
        for axes in p.groups():
            if axes not in seen:
                seen.add(axes)
                mesh.group(axes)
    return plans


def _tree(flat: dict):
    root: dict = {}
    for k, v in flat.items():
        node = root
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return root


def _ns(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_ns(node[k]) for k in sorted(node, key=int)]
    return types.SimpleNamespace(**{k: _ns(v) for k, v in node.items()})


class Resident:
    """A parameter block that stays where it is stored over the axes
    ``group`` names (decode): ``block`` (gathered over the other axes),
    cut along ``dim`` of the full ``shape`` into ``n`` blocks, this rank's
    the ``index``-th.  The model functions reach it through
    ``models.common.linear`` / ``lookup`` / ``channelwise``; every
    collective they issue moves activations, never the block."""

    resident = True

    def __init__(self, block, dim: int, shape, group):
        self.block, self.dim, self.group = block, dim, group
        self.shape = torch.Size(shape)
        self.n, self.index = comm.size(group), comm.rank(group)

    @property
    def ndim(self) -> int:
        return self.block.ndim

    @property
    def T(self) -> "Resident":
        s = self.shape
        return Resident(self.block.T, 1 - self.dim, (s[1], s[0]), self.group)

    def with_block(self, block) -> "Resident":
        return Resident(block, self.dim, self.shape, self.group)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """An output of this block's share of the work, gathered over the
        group along ``dim``."""
        return comm.all_gather(x.contiguous(), self.group, dim)

    def _last(self, what: str) -> None:
        if self.dim != self.ndim - 1:
            raise ValueError(f"{what}: the block is cut on dim {self.dim} "
                             f"of {tuple(self.shape)}, not the last")

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ full``: the column block's product, its output columns
        all-gathered over the group."""
        self._last("matmul")
        return comm.all_gather(x @ self.block, self.group,
                               x.ndim - 1).contiguous()

    def lookup(self, idx: torch.Tensor) -> torch.Tensor:
        """``full[idx]`` of a table cut on its rows: each rank looks up the
        rows it holds (zeros elsewhere), summed over the group (one
        nonzero term: exact)."""
        if self.dim != 0:
            raise ValueError("lookup: the table is not cut on its rows")
        blk = self.block.shape[0]
        local = idx.long() - self.index * blk
        hit = (local >= 0) & (local < blk)
        rows = self.block[torch.where(hit, local, 0)]
        rows = torch.where(hit[..., None], rows, 0)
        return comm.all_reduce(rows, self.group)

    def channelwise(self, fn, *xs):
        """``fn(full, *xs)`` for an op elementwise on the last dim (the
        block's cut): ``fn`` on the block and the matching channels of
        each ``x``; every output's channels all-gathered."""
        self._last("channelwise")
        blk = self.block.shape[-1]
        lo = self.index * blk
        out = fn(self.block, *(x[..., lo:lo + blk] for x in xs))
        one = not isinstance(out, tuple)
        outs = tuple(comm.all_gather(o.contiguous(), self.group, o.ndim - 1)
                     for o in ((out,) if one else out))
        return outs[0] if one else outs


def hold(block, plan: ShardPlan):
    """A plan's gathered block, wrapped as ``Resident`` when a cut is
    kept (one kept cut at most)."""
    t = plan.gather(block)
    if not plan.kept:
        return t
    (dim, axes), = plan.kept
    shape = list(t.shape)
    shape[dim] *= plan.mesh.axis_size(axes)
    return Resident(t, dim, shape, plan.mesh.group(axes))


class ShardedLayer:
    """One layer's blocks; ``gather()`` is the layer with full tensors
    (an attribute tree as ``models.blocks`` reads it), or with
    ``Resident`` blocks where the plans keep a cut (decode)."""

    def __init__(self, blocks: dict, plans: dict, resident: bool = False):
        self.blocks, self.plans, self.resident = blocks, plans, resident

    def gather(self):
        get = hold if self.resident else gather_param
        return _ns(_tree({k: get(v, self.plans[k])
                          for k, v in self.blocks.items()}))


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """The sequence split over the model axis (training and prefill):
    model rank ``index`` of ``n`` (``group``) runs rows [index S/n,
    (index + 1) S/n) of a sequence of S.  The model functions take it as
    ``split``; ``key_pos`` is set by ``models.model.forward``: the mask
    positions of the whole sequence, which its attention keys carry."""
    group: object
    n: int
    index: int
    key_pos: object = None

    def applies(self, S: int) -> bool:
        return S % self.n == 0

    def start(self, S_local: int) -> int:
        return self.index * S_local

    def cut(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's rows of a whole sequence (a view)."""
        blk = x.shape[dim] // self.n
        return x.narrow(dim, self.index * blk, blk)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence from every rank's rows (differentiable)."""
        return comm.gather_seq(x, self.group, dim)

    def remat_contexts(self):
        """A remat region's ``context_fn``: its recompute reuses the
        results of its activation collectives over the group
        (``comm.remat_contexts``)."""
        return comm.remat_contexts()

    def own(self, fn, x: torch.Tensor):
        """``fn`` on the gathered rows, this rank's rows of its output (a
        recurrent mixer: exact; costs what the unsplit sublayer does)."""
        return self.cut(fn(self.gather(x)))


def seq_split(mesh):
    """The ``SeqSplit`` of this rank of ``mesh``, or None (no ``model``
    axis of more than one rank)."""
    n = mesh.shape.get("model", 1)
    if n < 2:
        return None
    return SeqSplit(mesh.group("model"), n, mesh.axis_index("model"))


def sharded_model(cfg, blocks: dict, plans: dict, *, resident=False):
    """A model view over this rank's blocks (names of
    ``Model.state_dict()``): what ``models.model.forward`` /
    ``decode_step`` / ``lm_loss`` take in place of a ``Model``.  With
    ``resident`` every kept cut stays where it is stored (``Resident``,
    decode)."""
    layers: dict = {}
    enc_layers: dict = {}
    top: dict = {}
    for k, v in blocks.items():
        parts = k.split(".")
        if parts[0] == "layers":
            layers.setdefault(int(parts[1]), {})[
                ".".join(parts[2:])] = (v, plans[k])
        elif parts[:2] == ["encoder", "layers"]:
            enc_layers.setdefault(int(parts[2]), {})[
                ".".join(parts[3:])] = (v, plans[k])
        else:
            top[k] = (hold if resident else gather_param)(v, plans[k])

    def lazy(d):
        return [ShardedLayer({n: b for n, (b, _) in d[i].items()},
                             {n: p for n, (_, p) in d[i].items()},
                             resident)
                for i in sorted(d)]

    view = _ns(_tree(top))
    view.layers = lazy(layers)
    if enc_layers:
        view.encoder.layers = lazy(enc_layers)
    return view


def _walk(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, s, fn) for v, s in zip(tree, specs)]
    if not isinstance(tree, torch.Tensor) or specs is None:
        return tree
    return fn(tree, specs)


def cut_tree(tree, specs, mesh):
    """This rank's blocks of a tree of full tensors (a train state, a
    cache), ``specs`` a tree of the same layout (``state_specs``,
    ``cache_specs``); non-tensor leaves pass through."""
    return _walk(tree, specs, lambda t, s: ShardPlan(s, mesh).cut(t))


def gather_tree(tree, specs, mesh):
    """The full tensors from every rank's blocks (collective: every rank
    calls it), e.g. for a checkpoint or a check."""
    return _walk(tree, specs, lambda t, s: ShardPlan(s, mesh).gather(t))


def zeros_tree(tree, specs, mesh, *, device=None):
    """Zeros of this rank's block shapes (``tree`` gives the full shapes
    and dtypes, on any device): a fresh sharded cache without building
    the full one."""
    from repro_torch.train.sharding import shard_shape
    return _walk(tree, specs, lambda t, s: torch.zeros(
        shard_shape(t.shape, s, mesh), dtype=t.dtype,
        device=device if device is not None else t.device))
