"""Serving steps: batched prefill + decode on a cache (the KV cache of
attention layers, the O(1) recurrent state of rwkv and mamba layers).

One device, no mesh and no jit: the steps are plain functions over the
port's ``Model``.  Decode samples greedily (argmax), like the
reference's step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import model as M


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    use_kernel: bool = False
    # the explicit expert-parallel dispatch waits for the training
    # slice (ROADMAP.md Queue 1 item 8); anything but None raises
    ep_options: object = None
    # chaos-resilient dispatch collectives: as in the reference, only the
    # expert-parallel dispatch takes it; these one-device steps run no
    # collective
    resilience: object = None


def _check(opts: ServeOptions) -> None:
    if opts.ep_options is not None:
        raise NotImplementedError(
            "ep_options: the expert-parallel dispatch is not yet ported "
            "(ROADMAP.md Queue 1 item 8)")
    from repro_torch.core.resilient import resolve_resilience
    resolve_resilience(opts.resilience)     # a bad option fails here


def init_serve_cache(cfg, batch: int, max_len: int, *, device=None,
                     dtype=torch.bfloat16):
    """The decode cache of every layer: k/v in ``dtype``; for rwkv the
    state ``s`` in f32 and the token-shift carries in ``dtype``; for
    mamba the state ``h`` in f32 and the conv window in bf16."""
    return M.init_cache(cfg, batch, max_len, device=device, dtype=dtype)


def make_prefill_step(cfg, opts: ServeOptions) -> Callable:
    """(params, tokens [B, S], *, vision_embeds=None, encoder_frames=None)
    -> logits [B, S, V]: the full-sequence forward used for prompt
    processing, taking what the reference's batch dict carries beside
    the tokens (an encoder-decoder's frames, a VLM's patch embeddings);
    with ``opts.use_kernel`` each causal attention and MLA layer runs the
    flash kernel, each rwkv layer the wkv6 kernel and each mamba layer
    the selective-scan kernel.  MoE layers take the dense dispatch."""
    _check(opts)

    @torch.no_grad()
    def prefill(params, tokens, *, vision_embeds=None, encoder_frames=None):
        return M.forward(params, cfg, tokens, vision_embeds=vision_embeds,
                         encoder_frames=encoder_frames,
                         use_kernel=opts.use_kernel)

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
