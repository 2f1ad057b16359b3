"""Residual block assembly: (norm -> mixer -> [norm] -> residual) +
[norm -> cross-attention -> residual] + (norm -> ff -> [norm] ->
residual).

Mixers ``attn``, ``mla``, ``rwkv``, ``mamba``; feed-forwards ``mlp``,
``cmix``, ``moe``; the cross-attention sublayer (whisper's decoder)
attends to ``cross_src``, the encoder output.  The MoE prefill takes the
dense dispatch and decode the capacity dispatch (factor 2), as in the
reference.

Under a sequence split (``split``, ``train.shard.SeqSplit``) a block
runs this model rank's rows: each mixer gathers what it needs over the
model axis (see each mixer), the norms, projections and feed-forwards
run on the rank's rows alone.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models import attention, mamba, mla, mlp, moe, rwkv
from repro_torch.models.common import rmsnorm
from repro_torch.models.config import BlockSpec, ModelConfig


def cross_config(cfg: ModelConfig):
    """The cross-attention sublayer's config: the decoder's heads,
    keys from the encoder output, every key live."""
    return dataclasses.replace(cfg.attn, cross=True, causal=False)


def _norm_param(cfg: ModelConfig, d: int, device) -> nn.Parameter:
    # gemma parameterizes rmsnorm as (1 + w) with w ~ 0; others as w ~ 1
    fill = torch.zeros if cfg.gemma_norm else torch.ones
    return nn.Parameter(fill(d, dtype=torch.bfloat16, device=device))


class Block(nn.Module):
    """One layer: ``norm_mixer``, the mixer (``attn``, ``mla``, ``rwkv``
    or ``mamba``), ``norm_cross`` and ``cross`` (with a cross-attention
    sublayer), ``norm_mixer_post`` (with post-block norms), ``norm_ff``,
    the feed-forward (``mlp``, ``cmix`` or ``moe``), ``norm_ff_post``.
    With a ``generator`` the weights take the reference's init
    distributions; without one they are left uninitialised."""

    def __init__(self, spec: BlockSpec, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        d = cfg.d_model
        self.norm_mixer = _norm_param(cfg, d, device)
        if spec.mixer == "attn":
            self.attn = (attention.Attention(cfg.attn, d, device=device)
                         if generator is None else
                         attention.init(cfg.attn, d, generator=generator,
                                        device=device))
        elif spec.mixer == "mla":
            self.mla = (mla.MLA(cfg.mla, d, device=device)
                        if generator is None else
                        mla.init(cfg.mla, d, generator=generator,
                                 device=device))
        elif spec.mixer == "rwkv":
            self.rwkv = (rwkv.TimeMix(cfg.rwkv, d, device=device)
                         if generator is None else
                         rwkv.init(cfg.rwkv, d, generator=generator,
                                   device=device))
        elif spec.mixer == "mamba":
            self.mamba = (mamba.Mamba(cfg.mamba, d, device=device)
                          if generator is None else
                          mamba.init(cfg.mamba, d, generator=generator,
                                     device=device))
        if spec.cross:
            self.norm_cross = _norm_param(cfg, d, device)
            ccfg = cross_config(cfg)
            self.cross = (attention.Attention(ccfg, d, device=device)
                          if generator is None else
                          attention.init(ccfg, d, generator=generator,
                                         device=device))
        if cfg.post_block_norm:
            self.norm_mixer_post = _norm_param(cfg, d, device)
        if spec.ff != "none":
            self.norm_ff = _norm_param(cfg, d, device)
            if cfg.post_block_norm:
                self.norm_ff_post = _norm_param(cfg, d, device)
        if spec.ff == "mlp":
            self.mlp = (mlp.MLP(d, cfg.d_ff, cfg.gated_mlp, device=device)
                        if generator is None else
                        mlp.init(d, cfg.d_ff, cfg.gated_mlp,
                                 generator=generator, device=device))
        elif spec.ff == "cmix":
            self.cmix = (rwkv.ChannelMix(d, cfg.d_ff, device=device)
                         if generator is None else
                         rwkv.channel_mix_init(d, cfg.d_ff,
                                               generator=generator,
                                               device=device))
        elif spec.ff == "moe":
            self.moe = (moe.MoE(cfg.moe, d, device=device)
                        if generator is None else
                        moe.init(cfg.moe, d, generator=generator,
                                 device=device))


def _norm(cfg: ModelConfig, x, w):
    return rmsnorm(x, w, cfg.norm_eps, gemma_style=cfg.gemma_norm)


def _ff(p: Block, spec: BlockSpec, cfg: ModelConfig, x, cache=None,
        moe_dispatch=None, split=None):
    """The feed-forward sublayer; with ``cache`` (decode) the channel
    mix reads and updates its token-shift carry ``cache["cmix"]`` and the
    MoE takes the capacity dispatch.  An MoE takes ``moe_dispatch(p.moe,
    cfg.moe, h)`` when given (the capacity or expert-parallel dispatch of
    training; in decode, the capacity dispatch over a mesh's rows), else
    the dense dispatch (full sequence) or the capacity dispatch
    (decode).  Under ``split`` a dispatch that takes ``split`` gets it."""
    if spec.ff == "none":
        return x
    h = _norm(cfg, x, p.norm_ff)
    if spec.ff == "mlp":
        h = mlp.forward(p.mlp, h, cfg.mlp_act)
    elif spec.ff == "moe" and moe_dispatch is not None:
        h = (moe_dispatch(p.moe, cfg.moe, h) if split is None else
             moe_dispatch(p.moe, cfg.moe, h, split=split))
    elif spec.ff == "moe" and cache is None:
        h = moe.forward(p.moe, cfg.moe, h, cfg.mlp_act)
    elif spec.ff == "moe":
        # capacity dispatch: dense-dispatch FLOPs scale with E, absurd
        # for one-token decode
        h = moe.forward_dropless(p.moe, cfg.moe, h, cfg.mlp_act,
                                 capacity_factor=2.0)
    elif cache is None:
        h = rwkv.channel_mix(p.cmix, h, split=split)
    else:
        h, cache["cmix"] = rwkv.decode_channel_mix(p.cmix, h, cache["cmix"])
    if cfg.post_block_norm:
        h = _norm(cfg, h, p.norm_ff_post)
    return x + h


def _cross(p: Block, spec: BlockSpec, cfg: ModelConfig, x, cross_src):
    """The cross-attention sublayer, where the block has one."""
    if not spec.cross:
        return x
    if cross_src is None:
        raise ValueError("a cross-attention block needs cross_src (the "
                         "encoder output)")
    h = _norm(cfg, x, p.norm_cross)
    pos = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.int32,
                      device=x.device)          # unused: no rope
    return x + attention.forward(p.cross, cross_config(cfg), h,
                                 positions=pos, kv_src=cross_src,
                                 eps=cfg.norm_eps)


def forward(p: Block, spec: BlockSpec, cfg: ModelConfig, x, *, positions,
            cross_src=None, use_kernel=False, moe_dispatch=None,
            split=None):
    """Full-sequence block; x [B, S, d] (under ``split`` this model
    rank's rows, ``positions`` theirs).  ``moe_dispatch`` replaces an
    MoE layer's dense dispatch (see ``_ff``)."""
    h = _norm(cfg, x, p.norm_mixer)
    if spec.mixer == "attn":
        h = attention.forward(p.attn, cfg.attn, h, positions=positions,
                              window=spec.window, eps=cfg.norm_eps,
                              use_kernel=use_kernel, split=split)
    elif spec.mixer == "mla":
        h = mla.forward(p.mla, cfg.mla, h, positions=positions,
                        eps=cfg.norm_eps, use_kernel=use_kernel, split=split)
    elif spec.mixer == "rwkv":
        h = rwkv.time_mix(p.rwkv, cfg.rwkv, h, use_kernel=use_kernel,
                          split=split)
    elif spec.mixer == "mamba":
        h = mamba.forward(p.mamba, cfg.mamba, h, eps=cfg.norm_eps,
                          use_kernel=use_kernel, split=split)
    else:
        h = torch.zeros_like(h)
    if cfg.post_block_norm:
        h = _norm(cfg, h, p.norm_mixer_post)
    return _ff(p, spec, cfg, _cross(p, spec, cfg, x + h, cross_src),
               moe_dispatch=moe_dispatch, split=split)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(spec: BlockSpec, cfg: ModelConfig, batch: int, max_len: int,
               *, device=None, dtype=torch.bfloat16) -> dict:
    """The layer's decode cache: ``attn`` (k/v in ``dtype``), ``mla``
    (the latent ``ckv`` and rope key ``kr`` in ``dtype``), the ``rwkv``
    state (``s`` f32, carries in ``dtype``) or the ``mamba``
    state (``h`` f32, the conv window in bf16, as the reference keeps
    it) and, for a channel mix, its own carry ``cmix["x_cm"]`` in
    ``dtype``, as the reference keeps ``cache["rwkv"]`` and
    ``cache["cmix"]`` apart."""
    c = {}
    if spec.mixer == "attn":
        c["attn"] = attention.init_cache(cfg.attn, batch, max_len,
                                         device=device, dtype=dtype)
    elif spec.mixer == "mla":
        c["mla"] = mla.init_cache(cfg.mla, batch, max_len, device=device,
                                  dtype=dtype)
    elif spec.mixer == "rwkv":
        c["rwkv"] = rwkv.init_state(cfg.rwkv, batch, cfg.d_model,
                                    device=device, dtype=dtype)
    elif spec.mixer == "mamba":
        c["mamba"] = mamba.init_state(cfg.mamba, batch, cfg.d_model,
                                      device=device)
    if spec.ff == "cmix":
        c["cmix"] = {"x_cm": torch.zeros((batch, cfg.d_model),
                                         device=device, dtype=dtype)}
    return c


def decode(p: Block, spec: BlockSpec, cfg: ModelConfig, x, cache: dict, *,
           cross_src=None, seq=None, moe_dispatch=None):
    """One-token decode; x [B, 1, d].  ``seq``: the layer's cache is a
    block of a sequence cut over ranks (``attention.decode_step``);
    ``moe_dispatch`` replaces the capacity dispatch (see ``_ff``)."""
    h = _norm(cfg, x, p.norm_mixer)
    if spec.mixer == "attn":
        h, cache["attn"] = attention.decode_step(
            p.attn, cfg.attn, h, cache["attn"], window=spec.window,
            eps=cfg.norm_eps, seq=seq)
    elif spec.mixer == "mla":
        h, cache["mla"] = mla.decode_step(p.mla, cfg.mla, h, cache["mla"],
                                          eps=cfg.norm_eps, seq=seq)
    elif spec.mixer == "rwkv":
        h, cache["rwkv"] = rwkv.decode_time_mix(p.rwkv, cfg.rwkv, h,
                                                cache["rwkv"])
    elif spec.mixer == "mamba":
        h, cache["mamba"] = mamba.decode_step(p.mamba, cfg.mamba, h,
                                              cache["mamba"],
                                              eps=cfg.norm_eps)
    else:
        h = torch.zeros_like(h)
    if cfg.post_block_norm:
        h = _norm(cfg, h, p.norm_mixer_post)
    return _ff(p, spec, cfg, _cross(p, spec, cfg, x + h, cross_src),
               cache, moe_dispatch), cache
