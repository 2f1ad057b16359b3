"""Residual block assembly: (norm -> mixer -> [norm] -> residual) +
(norm -> ff -> [norm] -> residual).

The port runs the ``attn``, ``rwkv`` and ``mamba`` mixers and the
``mlp``, ``cmix`` and ``moe`` feed-forwards; the others raise
``NotImplementedError`` until their modules are ported (ROADMAP.md).
The MoE prefill takes the dense dispatch and decode the capacity
dispatch (factor 2), as in the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention, mamba, mlp, moe, rwkv
from repro_torch.models.common import rmsnorm
from repro_torch.models.config import BlockSpec, ModelConfig

_NOT_PORTED = {
    "mla": "the MLA mixer (deepseek-v3; ROADMAP.md Queue 1 item 10)",
    "cross": "cross-attention (whisper; ROADMAP.md Queue 1 item 10)",
}


def check_supported(spec: BlockSpec) -> None:
    for part in (spec.mixer, spec.ff, "cross" if spec.cross else None):
        if part in _NOT_PORTED:
            raise NotImplementedError(f"{_NOT_PORTED[part]} is not yet "
                                      f"ported to repro_torch")


def _norm_param(cfg: ModelConfig, d: int, device) -> nn.Parameter:
    # gemma parameterizes rmsnorm as (1 + w) with w ~ 0; others as w ~ 1
    fill = torch.zeros if cfg.gemma_norm else torch.ones
    return nn.Parameter(fill(d, dtype=torch.bfloat16, device=device))


class Block(nn.Module):
    """One layer: ``norm_mixer``, the mixer (``attn``, ``rwkv`` or
    ``mamba``), ``norm_mixer_post`` (with post-block norms), ``norm_ff``,
    the feed-forward (``mlp``, ``cmix`` or ``moe``), ``norm_ff_post``.
    With a ``generator`` the weights take the reference's init
    distributions; without one they are left uninitialised."""

    def __init__(self, spec: BlockSpec, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_supported(spec)
        d = cfg.d_model
        self.norm_mixer = _norm_param(cfg, d, device)
        if spec.mixer == "attn":
            self.attn = (attention.Attention(cfg.attn, d, device=device)
                         if generator is None else
                         attention.init(cfg.attn, d, generator=generator,
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


def _ff(p: Block, spec: BlockSpec, cfg: ModelConfig, x, cache=None):
    """The feed-forward sublayer; with ``cache`` (decode) the channel
    mix reads and updates its token-shift carry ``cache["cmix"]`` and the
    MoE takes the capacity dispatch."""
    if spec.ff == "none":
        return x
    h = _norm(cfg, x, p.norm_ff)
    if spec.ff == "mlp":
        h = mlp.forward(p.mlp, h, cfg.mlp_act)
    elif spec.ff == "moe" and cache is None:
        h = moe.forward(p.moe, cfg.moe, h, cfg.mlp_act)
    elif spec.ff == "moe":
        # capacity dispatch: dense-dispatch FLOPs scale with E, absurd
        # for one-token decode
        h = moe.forward_dropless(p.moe, cfg.moe, h, cfg.mlp_act,
                                 capacity_factor=2.0)
    elif cache is None:
        h = rwkv.channel_mix(p.cmix, h)
    else:
        h, cache["cmix"] = rwkv.decode_channel_mix(p.cmix, h, cache["cmix"])
    if cfg.post_block_norm:
        h = _norm(cfg, h, p.norm_ff_post)
    return x + h


def forward(p: Block, spec: BlockSpec, cfg: ModelConfig, x, *, positions,
            use_kernel=False):
    """Full-sequence block; x [B, S, d]."""
    h = _norm(cfg, x, p.norm_mixer)
    if spec.mixer == "attn":
        h = attention.forward(p.attn, cfg.attn, h, positions=positions,
                              window=spec.window, eps=cfg.norm_eps,
                              use_kernel=use_kernel)
    elif spec.mixer == "rwkv":
        h = rwkv.time_mix(p.rwkv, cfg.rwkv, h, use_kernel=use_kernel)
    elif spec.mixer == "mamba":
        h = mamba.forward(p.mamba, cfg.mamba, h, eps=cfg.norm_eps,
                          use_kernel=use_kernel)
    else:
        h = torch.zeros_like(h)
    if cfg.post_block_norm:
        h = _norm(cfg, h, p.norm_mixer_post)
    return _ff(p, spec, cfg, x + h)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(spec: BlockSpec, cfg: ModelConfig, batch: int, max_len: int,
               *, device=None, dtype=torch.bfloat16) -> dict:
    """The layer's decode cache: ``attn`` (k/v in ``dtype``), the
    ``rwkv`` state (``s`` f32, carries in ``dtype``) or the ``mamba``
    state (``h`` f32, the conv window in bf16, as the reference keeps
    it) and, for a channel mix, its own carry ``cmix["x_cm"]`` in
    ``dtype``, as the reference keeps ``cache["rwkv"]`` and
    ``cache["cmix"]`` apart."""
    check_supported(spec)
    c = {}
    if spec.mixer == "attn":
        c["attn"] = attention.init_cache(cfg.attn, batch, max_len,
                                         device=device, dtype=dtype)
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


def decode(p: Block, spec: BlockSpec, cfg: ModelConfig, x, cache: dict):
    """One-token decode; x [B, 1, d]."""
    h = _norm(cfg, x, p.norm_mixer)
    if spec.mixer == "attn":
        h, cache["attn"] = attention.decode_step(
            p.attn, cfg.attn, h, cache["attn"], window=spec.window,
            eps=cfg.norm_eps)
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
    return _ff(p, spec, cfg, x + h, cache), cache
