"""Serving steps: batched prefill + decode on a cache (the KV cache of
attention layers, the O(1) recurrent state of rwkv and mamba layers).

The steps are plain functions over the port's ``Model`` on one device;
with ``ServeOptions.ep_options`` the prefill's MoE layers take the
expert-parallel dispatch over a mesh of ranks (``train.moe_dispatch``).
Decode samples greedily (argmax), like the reference's step.

``mesh_decode_step`` decodes on a mesh of ranks, each storing its share
of the parameters (``train.shard``) and of the cache
(``train.sharding.cache_specs``).  A parameter block cut over ``model``
stays where it is stored (``train.shard.Resident``): it is gathered
over the data axes only, a weight cut on its output dim multiplies its
column block and the product's few rows are all-gathered over
``model`` (``models.common.linear``), the embedding looks up the rows it
holds, an elementwise parameter mixes its channels, an expert stack
runs its experts; parameters without a ``model`` cut are gathered as
the layer runs.  The cache layouts:
  * normal layout (decode_32k) -- batch rows over the data axes (each
    rank decodes its own rows), the KV / latent sequence over ``model``;
  * ``long_context`` (long_500k, batch 1) -- every rank decodes the same
    tokens and the KV sequence is cut over every axis (the data axes
    when it does not divide; MLA latents over the data axes).
An attention layer over a sequence-cut cache computes, on each rank, the
scores of its own positions (the mask from global positions), and the
ranks combine them exactly by log-sum-exp: the group's max, then the
sums of the exponentials and of their products with v (three
all-reduces of O(heads) and O(heads x head_dim) values a row); no rank
gathers the cache.  The rank holding position ``len`` writes the new
k/v (latent) row.  Recurrent states cut over ``model``: rwkv's ``s``
(whole heads) stays where it is stored and runs its heads' recurrence
there; mamba's ``h`` and ``conv`` are gathered for the step, then cut
again.  An MoE layer whose rows are cut over the data axes gathers the
layer's input rows of the data group; each rank routes on the gathered
router logits, runs its resident experts on the whole batch (so the
capacity and the drops are the one-device decode's), the outputs are
summed over the expert axes, and it keeps its own rows.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Callable

import torch

from repro_torch.models import model as M
from repro_torch.models.attention import NEG_INF
from repro_torch.train import comm, shard, sharding
from repro_torch.train.moe_dispatch import EPOptions, make_moe_dispatch


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    use_kernel: bool = False
    long_context: bool = False       # the sequence-cut cache layout of
                                     # batch-1 decode (mesh_decode_step)
    ep_options: EPOptions | None = None
    # explicit expert-parallel dispatch for MoE archs during prefill
    # (None = the dense dispatch).  With overlap_chunks set, the
    # dispatch alltoall runs in capacity chunks.
    resilience: object = None
    # chaos-resilient dispatch collectives: overrides ep_options'
    # resilience when both are set (the serve knob wins, so launchers
    # can arm verification without rebuilding EPOptions)


def _check(opts: ServeOptions) -> None:
    from repro_torch.core.resilient import resolve_resilience
    resolve_resilience(opts.resilience)     # a bad option fails here


def init_serve_cache(cfg, batch: int, max_len: int, *, device=None,
                     dtype=torch.bfloat16):
    """The decode cache of every layer: k/v in ``dtype``; for rwkv the
    state ``s`` in f32 and the token-shift carries in ``dtype``; for
    mamba the state ``h`` in f32 and the conv window in bf16."""
    return M.init_cache(cfg, batch, max_len, device=device, dtype=dtype)


def make_prefill_step(cfg, opts: ServeOptions, mesh=None) -> Callable:
    """(params, tokens [B, S], *, vision_embeds=None, encoder_frames=None)
    -> logits [B, S, V]: the full-sequence forward used for prompt
    processing, taking what the reference's batch dict carries beside
    the tokens (an encoder-decoder's frames, a VLM's patch embeddings);
    with ``opts.use_kernel`` each causal attention and MLA layer runs the
    flash kernel, each rwkv layer the wkv6 kernel and each mamba layer
    the selective-scan kernel.  MoE layers take the dense dispatch, or
    with ``opts.ep_options`` the expert-parallel dispatch over ``mesh``
    (a ``launch.mesh.Mesh`` with a ``"model"`` axis; every rank calls the
    step with the same tokens)."""
    _check(opts)
    moe_dispatch = None
    if opts.ep_options is not None and cfg.moe is not None:
        if mesh is None:
            raise ValueError("ep_options: the expert-parallel dispatch "
                             "needs a mesh")
        ep_opts = opts.ep_options
        if opts.resilience is not None:
            ep_opts = dataclasses.replace(ep_opts,
                                          resilience=opts.resilience)
        moe_dispatch = make_moe_dispatch(mesh, ep_opts, cfg.mlp_act)

    @torch.no_grad()
    def prefill(params, tokens, *, vision_embeds=None, encoder_frames=None):
        return M.forward(params, cfg, tokens, vision_embeds=vision_embeds,
                         encoder_frames=encoder_frames,
                         use_kernel=opts.use_kernel,
                         moe_dispatch=moe_dispatch)

    return prefill


def make_decode_step(cfg, opts: ServeOptions) -> Callable:
    """(params, cache, tokens [B, 1][, cross_src]) -> (next_tokens [B, 1],
    cache', logits [B, V]).  ``cross_src`` is the precomputed encoder
    output (``models.model.encode``), required for an encoder-decoder.
    The step's logits come back too, so a caller can check them without
    a second forward.  MoE layers take the capacity dispatch (factor 2),
    which drops a (token, slot) pair once its expert's bucket is full."""
    _check(opts)

    @torch.no_grad()
    def decode(params, cache, tokens, cross_src=None):
        logits, cache = M.decode_step(params, cfg, cache, tokens,
                                      cross_src=cross_src)
        last = logits[:, -1]
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        return nxt[:, None], cache, last

    return decode


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A layer's cache block of a sequence cut over ``group``: global
    position ``start`` is its row 0."""
    start: int
    group: object

    def attend(self, logits, mask, v):
        """The exact softmax over the whole sequence from each rank's
        scores ``logits`` [B, H, q, S_loc] (f32), ``mask`` [B, q, S_loc]
        and values ``v`` [B, S_loc, H, D]: -> [B, q, H, D] in v's
        dtype.  Every position t holds a live key, so the max is
        finite."""
        logits = torch.where(mask[:, None], logits, NEG_INF)
        m = comm.all_reduce(logits.amax(-1, keepdim=True), self.group,
                            op="max")
        e = torch.exp(logits - m)
        den = comm.all_reduce(e.sum(-1, keepdim=True), self.group)
        num = comm.all_reduce(
            torch.einsum("bhqk,bkhd->bqhd", e, v.float()), self.group)
        return (num / den.permute(0, 2, 1, 3)).to(v.dtype)


_SEQ_LEAVES = ("k", "v", "ckv", "kr")


_RESIDENT_STATES = ("s",)     # rwkv: whole heads run where they are


def _layer_plans(spec_layer: dict, mesh):
    """(the seq axes of the layer's KV / latent cache, {(sub, leaf):
    ShardPlan} of its other leaves' non-row cuts; a resident state's
    plan keeps its ``model`` cut)."""
    seq, rec = (), {}
    for sub, leaves in spec_layer.items():
        for leaf, spec in leaves.items():
            if spec is None:
                continue
            if leaf in _SEQ_LEAVES:
                seq = tuple(a for a in sharding.entry_axes(spec[1])
                            if mesh.shape[a] > 1)
            else:
                plan = shard.ShardPlan(
                    (None,) + tuple(spec[1:]), mesh, what="state",
                    keep=("model",) if leaf in _RESIDENT_STATES else ())
                if plan.cuts or plan.kept:
                    rec[(sub, leaf)] = plan
    return seq, rec


def _rows_dispatch(cfg, mesh, d_axes):
    """Decode's capacity dispatch (factor 2) over the batch rows of the
    data group (none: the rank's rows are the batch): every rank runs it
    on the gathered rows and keeps its own.  Expert stacks held as
    blocks (``Resident``) run the block's experts, routed on the
    gathered logits over the whole layer's capacity, and the outputs are
    summed over the block's axes; the shared experts are added once."""
    from repro_torch.models import mlp
    from repro_torch.models import moe as moe_mod
    group = mesh.group(d_axes) if d_axes else None

    def dispatch(p, cfg_moe, h):
        rows = h.shape[0]
        whole = (comm.all_gather(h.contiguous(), group) if group is not None
                 else h)
        wg = p.w_gate
        if getattr(wg, "resident", False):
            E_loc = wg.block.shape[0]
            lo = wg.index * E_loc
            held = types.SimpleNamespace(
                **{k: getattr(p, k) for k in ("router", "router_bias")
                   if hasattr(p, k)},
                w_gate=wg.block, w_up=p.w_up.block, w_down=p.w_down.block)
            part = dataclasses.replace(cfg_moe, held=(lo, lo + E_loc),
                                       n_shared=0)
            out = comm.all_reduce(moe_mod.forward_dropless(
                held, part, whole, cfg.mlp_act, capacity_factor=2.0),
                wg.group)
            if cfg_moe.n_shared:
                out = out + mlp.forward(p.shared, whole, cfg.mlp_act)
        else:
            out = moe_mod.forward_dropless(p, cfg_moe, whole, cfg.mlp_act,
                                           capacity_factor=2.0)
        if group is None:
            return out
        r0 = mesh.axis_index(d_axes) * rows
        return out[r0:r0 + rows]
    return dispatch


def mesh_decode_step(cfg, mesh, opts: ServeOptions, params, cache):
    """The counterpart of the reference's ``jit_decode_step``: returns
    ``(step, (pspec, cspec))``.  ``params`` (a ``Model`` or its state
    dict) and ``cache`` (``init_serve_cache`` at the global batch and
    length) give the full shapes, on any device (``meta`` included).
    ``step(blocks, cache_blocks, tokens[, cross_src]) -> (next_tokens,
    cache_blocks', logits)`` takes this rank's parameter blocks
    (``shard.cut_tree(params, pspec, mesh)``), its cache blocks
    (``shard.cut_tree(cache, cspec, mesh)``, or ``shard.zeros_tree``)
    and its tokens: its rows over the data axes (``cross_src`` too), or
    with ``opts.long_context`` every row.  ``mesh`` is a
    ``launch.mesh.Mesh`` (every rank calls the step) or a ``MeshLayout``
    (collectives recorded; the dry-run)."""
    _check(opts)
    if not isinstance(params, dict):
        params = params.state_dict()
    pspec = sharding.param_specs(params, cfg, mesh)
    cspec = sharding.cache_specs(cache, cfg, mesh,
                                 long_context=opts.long_context)
    plans = shard.plans_for(pspec, mesh, keep=lambda k, s: ("model",))
    per_layer = [_layer_plans(ls, mesh) for ls in cspec["layers"]]
    moe_dispatch = None
    d_axes = tuple(a for a in sharding.data_axes(mesh) if mesh.shape[a] > 1)
    if cfg.moe is not None:
        moe_dispatch = _rows_dispatch(
            cfg, mesh, () if opts.long_context else d_axes)
    for seq_axes, rec in per_layer:           # groups in one order
        if seq_axes:
            mesh.group(seq_axes)
        for plan in rec.values():
            for axes in plan.groups():
                mesh.group(axes)

    @torch.no_grad()
    def step(blocks, cache, tokens, cross_src=None):
        view = shard.sharded_model(cfg, blocks, plans, resident=True)
        seqs, full = [], []
        for lc, (seq_axes, rec) in zip(cache["layers"], per_layer):
            lc = {k: dict(v) for k, v in lc.items()}
            for (sub, leaf), plan in rec.items():
                lc[sub][leaf] = shard.hold(lc[sub][leaf], plan)
            start = 0
            if seq_axes:
                blk = next(lc[s][leaf] for s in lc for leaf in lc[s]
                           if leaf in _SEQ_LEAVES)
                start = mesh.axis_index(seq_axes) * blk.shape[1]
            seqs.append(SeqShard(start, mesh.group(seq_axes))
                        if seq_axes else None)
            full.append(lc)
        logits, new = M.decode_step(view, cfg, {"layers": full}, tokens,
                                    cross_src=cross_src, seqs=seqs,
                                    moe_dispatch=moe_dispatch)
        for lc, (_, rec) in zip(new["layers"], per_layer):
            for (sub, leaf), plan in rec.items():
                t = lc[sub][leaf]
                lc[sub][leaf] = t.block if plan.kept else plan.cut(t)
        last = logits[:, -1]
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        return nxt[:, None], new, last

    return step, (pspec, cspec)
