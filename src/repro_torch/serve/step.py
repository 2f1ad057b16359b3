"""Serving steps: batched prefill + decode on a cache (the KV cache of
attention layers, the O(1) recurrent state of rwkv and mamba layers).

The steps are plain functions over the port's ``Model`` on one device;
with ``ServeOptions.ep_options`` the prefill's MoE layers take the
expert-parallel dispatch over a mesh of ranks (``train.moe_dispatch``).
Decode samples greedily (argmax), like the reference's step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import model as M
from repro_torch.train.moe_dispatch import EPOptions, make_moe_dispatch


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    use_kernel: bool = False
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
