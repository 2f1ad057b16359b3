"""Train-step factory: wires the model zoo, the optimizer and the MPIX
communication layer into one step per (arch, mesh, options).

Two DP modes (the paper's layering made operational):
  * ``fsdp``     — the native collectives: the "system MPI" substrate.
                   ``make_train_step`` keeps every parameter whole on
                   every rank and sums the gradients with
                   ``dist.all_reduce`` (the one-device step's result);
                   ``sharded_train_step`` stores each rank's block of
                   every parameter and both moments (``state_specs``)
                   and gathers a layer's parameters where it runs
                   (``train.shard``): required for the 100B+ archs.
  * ``explicit`` — parameters replicated over the data axes; gradients
                   synchronized by *our* collectives with a selectable
                   algorithm + bucketing + optional inter-pod int8
                   compression, or reduce-scatter / clip / allgather.
                   The paper-faithful path.

MoE modes: ``dense`` (every expert on every token), ``dropless`` (the
capacity gather dispatch) or ``mpix_ep`` (the expert-parallel alltoall
through ``repro_torch.core``).

The state is a dict of tensors, as the reference's is a tree:
``params`` (parameter name -> tensor, the names of
``Model.state_dict()``), ``opt`` (``mu`` / ``nu`` f32 dicts of the same
names, ``count``), ``step`` and, with compression, ``ef_residual``.
``step(state, batch) -> (new state, metrics)`` leaves its input state
as it was.  ``mesh`` is a ``launch.mesh.Mesh`` or None (one device, no
process group).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import model as M
from repro_torch.models import moe as moe_mod
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.train import comm, shard, sharding, sync
from repro_torch.train.moe_dispatch import EPOptions, make_moe_dispatch
from repro_torch.train.sharding import data_axes


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    dp_mode: str = "fsdp"              # "fsdp" | "explicit"
    dp_algorithm: str = "xla"          # explicit mode collective
    grad_buckets: int = 1
    compress_dcn: bool = False         # explicit + a mesh with pods only
    moe_mode: str = "dropless"         # "dense" | "dropless" | "mpix_ep"
    ep_alltoall: str = "xla"
    ep_capacity: float = 1.25
    ep_policy: str | None = None       # selection policy for EP "auto"
                                       # collectives (None = the process
                                       # default set by the launcher)
    ep_overlap_chunks: int | None = None   # EPOptions.overlap_chunks
    ep_transport: str = "dist"         # EP collective substrate:
                                       # "dist" | "kernel" | "auto"
    dp_transport: str = "dist"         # explicit-mode grad-sync
                                       # substrate (same choices)
    overlap_grad_chunks: int = 0       # explicit mode: > 0 pipelines the
                                       # grad sync as reduce-scatter /
                                       # clip-on-shards / allgather in
                                       # this many chunks (0 = off)
    resilience: object = None          # the API's recovery ladder for
                                       # the EP dispatch and the explicit
                                       # grad sync (None/False off)
    remat: bool = True
    use_kernel: bool = False           # the flash / wkv6 / scan kernels
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    weight_decay: float = 0.1


def _loss_fn(cfg, opts: TrainOptions, moe_dispatch, reduction="mean",
             split=None):
    def loss(model, batch):
        kw = {}
        if cfg.encoder is not None:
            kw["encoder_frames"] = batch["encoder_frames"]
        if cfg.vision_prefix:
            kw["vision_embeds"] = batch["vision_embeds"]
        return M.lm_loss(model, cfg, batch["tokens"], batch["labels"],
                         use_kernel=opts.use_kernel, remat=opts.remat,
                         moe_dispatch=moe_dispatch, reduction=reduction,
                         split=split, **kw)
    return loss


def init_train_state(generator: torch.Generator, cfg,
                     opts: TrainOptions | None = None, *,
                     device=None) -> dict:
    """Fresh weights (``models.model.init_params`` drawn from
    ``generator``, on ``device``), zero moments, step 0."""
    model = M.init_params(cfg, generator=generator, device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    dev = next(iter(params.values())).device
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if opts is not None and opts.compress_dcn:
        state["ef_residual"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                               device=dev)
                                for k, p in params.items()}
    return state


def _moe_dispatch(cfg, mesh, opts: TrainOptions):
    if cfg.moe is None or opts.moe_mode == "dense":
        return None
    if opts.moe_mode == "mpix_ep":
        if mesh is None:
            raise ValueError("moe_mode='mpix_ep' needs a mesh with a "
                             "'model' axis")
        return make_moe_dispatch(
            mesh, EPOptions(alltoall=opts.ep_alltoall,
                            capacity_factor=opts.ep_capacity,
                            policy=opts.ep_policy,
                            overlap_chunks=opts.ep_overlap_chunks,
                            transport=opts.ep_transport,
                            resilience=opts.resilience),
            cfg.mlp_act)
    if opts.moe_mode == "dropless":
        def dropless(p, c, x, split=None):
            # under a sequence split the capacity is the data rank's
            # whole rows': the dispatch runs on the gathered rows
            def run(xs):
                return moe_mod.forward_dropless(p, c, xs, cfg.mlp_act)
            return run(x) if split is None else split.own(run, x)
        return dropless
    raise ValueError(f"unknown moe_mode {opts.moe_mode!r}")


def make_train_step(cfg, mesh, opts: TrainOptions) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``; metrics are
    f32 scalars ``loss``, ``grad_norm`` (before clipping) and ``lr``.
    On a mesh every rank calls the step with its own batch rows (the
    data axes' shard; the same rows on every model rank)."""
    if opts.dp_mode not in ("fsdp", "explicit"):
        raise ValueError(f"unknown dp_mode {opts.dp_mode!r}")
    moe_dispatch = _moe_dispatch(cfg, mesh, opts)

    def opt_apply(state, grads, gnorm=None):
        lr = cosine_schedule(state["step"], peak_lr=opts.peak_lr,
                             warmup_steps=opts.warmup_steps,
                             total_steps=opts.total_steps)
        if gnorm is None:
            grads, gnorm = clip_by_global_norm(grads, opts.max_grad_norm)
        params, opt = adamw_update(state["params"], grads, state["opt"],
                                   lr=lr, weight_decay=opts.weight_decay)
        return params, opt, gnorm, lr

    def value_and_grad(loss, state, batch):
        model = M.from_state(cfg, state["params"])      # no copy
        out = loss(model, batch)
        val = out[0] if isinstance(out, tuple) else out
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(val, list(named.values()),
                                    allow_unused=True)
        # a parameter off the gradient's path (a router bias, which only
        # biases the choice) gets zeros, as the reference's grad gives
        by_name = {k: torch.zeros_like(named[k]) if g is None else g
                   for k, g in zip(named, grads)}
        return out, {k: by_name[k] for k in state["params"]}

    def finish(state, params, opt, metrics):
        new = dict(state, params=params, opt=opt, step=state["step"] + 1)
        return new, metrics

    d_axes = data_axes(mesh) if mesh is not None else ()
    n_data = mesh.axis_size(d_axes) if d_axes else 1
    sum_loss = _loss_fn(cfg, opts, moe_dispatch, reduction="sum_count")

    if opts.dp_mode == "fsdp" and n_data == 1:
        loss = _loss_fn(cfg, opts, moe_dispatch)

        def step(state, batch):
            lval, grads = value_and_grad(loss, state, batch)
            params, opt, gnorm, lr = opt_apply(state, grads)
            return finish(state, params, opt, {
                "loss": lval.detach(), "grad_norm": gnorm, "lr": lr})
        return step

    if not d_axes:
        raise ValueError("explicit DP needs a mesh with data axes")
    d_group, d_topo = mesh.group(d_axes), mesh.topology(d_axes)
    compressed = (opts.dp_mode == "explicit" and opts.compress_dcn
                  and "pod" in mesh.axis_names)
    if compressed:
        pod_group, data_group = mesh.group("pod"), mesh.group("data")
        data_topo = mesh.topology("data")
    # pipelined grad sync (reduce-scatter / clip-on-shards / allgather);
    # compression owns the inter-pod hop, so the two exclude each other
    overlap = (opts.dp_mode == "explicit" and opts.overlap_grad_chunks > 0
               and not compressed)

    # Per-rank losses are SUMS over live tokens; ranks exchange
    # (grad-sum, token-count) so that the combined update is the exact
    # global-mean gradient even under uneven label masking.
    def step(state, batch):
        (lsum, cnt), grads = value_and_grad(sum_loss, state, batch)
        lsum = lsum.detach().clone()
        cnt_g = comm.all_reduce(cnt, d_group)
        denom = torch.clamp(cnt_g, min=1).to(torch.float32)
        gnorm, residual = None, state.get("ef_residual")
        if opts.dp_mode == "fsdp":
            grads = sync.dp_allreduce(grads, d_group, denom=denom)
        elif compressed:
            grads, residual = sync.dp_allreduce_compressed(
                grads, residual, data_group=data_group,
                pod_group=pod_group, intra_algorithm=opts.dp_algorithm,
                denom=denom, resilience=opts.resilience,
                data_topo=data_topo)
        elif overlap:
            grads, gnorm = sync.dp_allreduce_overlap(
                grads, d_group, algorithm=opts.dp_algorithm,
                chunks=opts.overlap_grad_chunks, denom=denom,
                max_norm=opts.max_grad_norm, transport=opts.dp_transport,
                resilience=opts.resilience, topo=d_topo)
        else:
            grads = sync.dp_allreduce(
                grads, d_group, algorithm=opts.dp_algorithm,
                buckets=opts.grad_buckets, denom=denom,
                transport=opts.dp_transport, resilience=opts.resilience,
                topo=d_topo)
        lval = comm.all_reduce(lsum, d_group) / denom
        params, opt, gnorm, lr = opt_apply(state, grads, gnorm=gnorm)
        new, metrics = finish(state, params, opt, {
            "loss": lval, "grad_norm": gnorm, "lr": lr})
        if residual is not None:
            new["ef_residual"] = residual
        return new, metrics

    return step


def state_specs(state: dict, cfg, mesh, opts: TrainOptions) -> dict:
    """The spec tree of the train state under the chosen mode (the
    layout of ``state``; see ``train.sharding``): explicit mode
    replicates everything; fsdp cuts ``params``, ``opt.mu``, ``opt.nu``
    and ``ef_residual`` by ``param_specs``."""
    def whole(tree):
        return {k: (None,) * v.ndim for k, v in tree.items()}
    if opts.dp_mode == "explicit":
        pspecs = whole(state["params"])
    else:
        pspecs = sharding.param_specs(state["params"], cfg, mesh)
    out = {"params": pspecs,
           "opt": {"mu": pspecs, "nu": pspecs, "count": ()},
           "step": ()}
    if "ef_residual" in state:
        out["ef_residual"] = pspecs
    return out


def sharded_train_step(cfg, mesh, opts: TrainOptions, state: dict,
                       batch_spec_tree):
    """The counterpart of the reference's ``jit_train_step``: returns
    ``(step, sspec)``, ``sspec = state_specs(...)``.  ``state`` gives
    the full shapes (tensors on any device, ``meta`` included); the step
    takes and returns this rank's sharded state (``shard.cut_tree(state,
    sspec, mesh)``; ``shard.gather_tree`` rebuilds the full one) and its
    rows of the batch, as ``batch_spec_tree`` (a tree of batch specs,
    e.g. ``sharding.batch_specs(mesh)`` a leaf) cuts them: rows over the
    data axes.

    fsdp: between steps each rank stores only its block of every
    parameter and of both moments.  Each layer's parameters are
    gathered where it runs (inside its remat region) and the gradient
    comes back as the block's, summed over the data axes
    (``train.shard``).  Per-rank losses are sums over live tokens;
    ranks sum (loss, live count) over the data axes.  The clip sees the
    global norm: each block's squares once, from the rank that owns it
    (its coordinate 0 on every axis its spec does not name), summed
    over the mesh.  AdamW then updates the blocks.

    Compute on the model axis: where the mesh's ``model`` axis has more
    than one rank and the batch's S divides it, the step splits the
    sequence (``shard.SeqSplit``): each model rank runs its S/n rows
    (attention gathers k/v over ``model``, the recurrent mixers run on
    the gathered rows and keep their own), so the blocks' gradients are
    summed over ``model`` as well as the data axes (a reduce-scatter
    where the cut allows) and so are (loss, live count).  Otherwise every
    model rank computes the same rows (storage only).  With
    ``moe_mode="mpix_ep"`` each expert stack's block over the EP axes
    stays where it is stored (gathered over ``data`` only) and is the
    dispatch's local experts; under the split a rank's rows are its
    token slice.  Explicit mode: ``make_train_step``, everything
    replicated.  Every collective goes through ``train.comm``, so on a
    ``MeshLayout`` the step runs without ranks and records them."""
    sspec = state_specs(state, cfg, mesh, opts)
    specs = (batch_spec_tree.values() if isinstance(batch_spec_tree, dict)
             else [batch_spec_tree])
    for spec in specs:
        if sharding.spec_axes(spec[:1]) != data_axes(mesh) \
                or sharding.spec_axes(spec[1:]):
            raise ValueError(f"batch spec {spec}: rows go over the data "
                             f"axes {data_axes(mesh)}, nothing else")
    if opts.dp_mode == "explicit":
        return make_train_step(cfg, mesh, opts), sspec
    if opts.dp_mode != "fsdp":
        raise ValueError(f"unknown dp_mode {opts.dp_mode!r}")
    keep = None
    if opts.moe_mode == "mpix_ep" and cfg.moe is not None:
        from repro_torch.train.moe_dispatch import ep_axes_for
        ep = ep_axes_for(cfg.moe, mesh)
        keep = (lambda k, s: ep if k.rsplit(".", 1)[-1] in
                ("w_gate", "w_up", "w_down") and ".moe." in k
                and ".shared." not in k else ())
    d_axes = data_axes(mesh)
    split = shard.seq_split(mesh)
    # (plans, group of the loss sums) without and with the split; every
    # group is created here, in one order on every rank
    modes = {False: (shard.plans_for(sspec["params"], mesh, keep=keep),
                     mesh.group(d_axes) if d_axes else None)}
    if split is not None:
        s_axes = d_axes + ("model",)
        modes[True] = (shard.plans_for(sspec["params"], mesh, keep=keep,
                                       sum_axes=s_axes), mesh.group(s_axes))
    world = mesh.group(mesh.axis_names)
    moe_dispatch = _moe_dispatch(cfg, mesh, opts)
    losses = {on: _loss_fn(cfg, opts, moe_dispatch, reduction="sum_count",
                           split=split if on else None) for on in modes}

    def _sum(x, group):
        return x if group is None else comm.all_reduce(x, group)

    def step(state, batch):
        on = split is not None and split.applies(batch["tokens"].shape[1])
        plans, d_group = modes[on]
        blocks = {k: v.detach().requires_grad_(True)
                  for k, v in state["params"].items()}
        lsum, cnt = losses[on](shard.sharded_model(cfg, blocks, plans),
                               batch)
        gs = torch.autograd.grad(lsum, list(blocks.values()),
                                 allow_unused=True)
        cnt_g = _sum(cnt, d_group)
        denom = torch.clamp(cnt_g, min=1).to(torch.float32)
        grads = {k: (torch.zeros_like(blocks[k]) if g is None else
                     (g.float() / denom).to(g.dtype))
                 for k, g in zip(blocks, gs)}
        sq = torch.zeros((), dtype=torch.float32, device=lsum.device)
        for k, g in grads.items():
            if plans[k].owner:
                sq = sq + torch.sum(torch.square(g.float()))
        gnorm = torch.sqrt(_sum(sq, world))
        scale = torch.clamp(opts.max_grad_norm / (gnorm + 1e-9), max=1.0)
        grads = {k: (g.float() * scale).to(g.dtype)
                 for k, g in grads.items()}
        lr = cosine_schedule(state["step"], peak_lr=opts.peak_lr,
                             warmup_steps=opts.warmup_steps,
                             total_steps=opts.total_steps)
        params, opt = adamw_update(state["params"], grads, state["opt"],
                                   lr=lr, weight_decay=opts.weight_decay)
        lval = _sum(lsum.detach(), d_group) / denom
        new = dict(state, params=params, opt=opt, step=state["step"] + 1)
        return new, {"loss": lval, "grad_norm": gnorm, "lr": lr}

    return step, sspec
