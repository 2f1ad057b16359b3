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
block's gradient -- a reduce-scatter over the data axes where one dim
is cut over data axes alone (then an all-reduce over the data axes it
does not name), else an all-reduce over the data axes, then a plain
slice over the remaining cut dims.  The model axis carries no tensor
parallelism in the port (every model rank computes the same rows with
the same full weights, so its gradients agree and a slice is exact):
its cut is storage only.

Every collective goes through ``train.comm``; on a ``MeshLayout`` (no
process group) the calls are recorded instead of run.
"""
from __future__ import annotations

import types

import torch

from repro_torch.train import comm
from repro_torch.train.sharding import data_axes, entry_axes, spec_axes


class ShardPlan:
    """How one tensor of ``spec`` lies on ``mesh``: its cut dims (each
    with the axes of size > 1 it is cut over) and this rank's block."""

    def __init__(self, spec, mesh):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.cuts = []
        for dim, e in enumerate(self.spec):
            axes = tuple(a for a in entry_axes(e) if mesh.shape[a] > 1)
            if axes:
                self.cuts.append((dim, axes))
        self.d_axes = tuple(a for a in data_axes(mesh) if mesh.shape[a] > 1)
        named = set(spec_axes(self.spec))
        # the rank that counts this block once in a global sum
        self.owner = all(mesh.coords[a] == 0 for a in mesh.axis_names
                         if a not in named)

    def groups(self) -> list:
        """Every group the plan's collectives use (to create them in one
        order on every rank)."""
        out = [axes for _, axes in self.cuts]
        if self.d_axes:
            out.append(self.d_axes)
            out += [tuple(a for a in self.d_axes if a not in axes)
                    for _, axes in self.cuts]
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
        for dim, axes in self.cuts:
            t = self._narrow(t, dim, axes)
        return t.contiguous().clone() if self.cuts else t

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block (collective)."""
        t = block
        for dim, axes in self.cuts:
            t = comm.all_gather(t, self.mesh.group(axes), dim)
        return t

    def grad(self, g: torch.Tensor) -> torch.Tensor:
        """The block's gradient from this rank's gradient of the full
        tensor: summed over the data axes, cut to the block."""
        mesh, done = self.mesh, None
        dcuts = [(d, a) for d, a in self.cuts if set(a) & set(self.d_axes)]
        if len(dcuts) == 1 and set(dcuts[0][1]) <= set(self.d_axes):
            done, axes = dcuts[0]
            g = comm.reduce_scatter(g, mesh.group(axes), done)
            rest = tuple(a for a in self.d_axes if a not in axes)
            if rest:
                g = comm.all_reduce(g, mesh.group(rest))
        elif self.d_axes:
            g = comm.all_reduce(g, mesh.group(self.d_axes))
        for dim, axes in self.cuts:
            if dim != done:
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


def plans_for(specs: dict, mesh) -> dict:
    """``{name: ShardPlan}``; every group the plans use is created here,
    in one order on every rank."""
    plans = {k: ShardPlan(s, mesh) for k, s in specs.items()}
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


class ShardedLayer:
    """One layer's blocks; ``gather()`` is the layer with full tensors
    (an attribute tree as ``models.blocks`` reads it)."""

    def __init__(self, blocks: dict, plans: dict):
        self.blocks, self.plans = blocks, plans

    def gather(self):
        return _ns(_tree({k: gather_param(v, self.plans[k])
                          for k, v in self.blocks.items()}))


def sharded_model(cfg, blocks: dict, plans: dict):
    """A model view over this rank's blocks (names of
    ``Model.state_dict()``): what ``models.model.forward`` /
    ``decode_step`` / ``lm_loss`` take in place of a ``Model``."""
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
            top[k] = gather_param(v, plans[k])

    def lazy(d):
        return [ShardedLayer({n: b for n, (b, _) in d[i].items()},
                             {n: p for n, (_, p) in d[i].items()})
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
