"""RWKV-6 (Finch): data-dependent-decay linear attention (arXiv:2404.05892).

Time mix (wkv6) per head of size N:
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
with per-channel decay w_t = exp(-exp(w0 + lora_w(x))).

The full-sequence recurrence runs the hand-written wkv6 kernel
(``repro_torch.kernels.wkv6``) when ``use_kernel``, else the plain
per-step loop ``wkv_scan``.  Decode carries S as an O(1) state and runs
one plain step per token, as the reference does.

The roundings follow the reference: ``mu`` (f32) is rounded to the
activation dtype before the token-shift mix; the decay is computed in
f32 from the bf16 LoRA product; the SiLU gate and the channel mix's
sigmoid run op by op in the activation dtype; the group norm takes the
population variance with eps 1e-5 on the f32 wkv output.

Under a sequence split (``split``) the time mix runs on the model
group's gathered rows and keeps this rank's (exact; the recurrence is
not carried from rank to rank); the channel mix takes its token shift
from the gathered rows and runs its products on its own.  Decode on a
mesh: the products are column blocks (``models.common.linear``), ``mu``
mixes the rank's channels (``channelwise``), and a state ``s`` held as
a block of whole heads (``train.shard.Resident``) runs the recurrence of
those heads where it is stored.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.models.common import channelwise, dense_init_, linear
from repro_torch.models.config import RWKVConfig
from repro_torch.models.mlp import silu


class TimeMix(nn.Module):
    """Parameters as in the reference: ``wr``/``wk``/``wv``/``wg``/``wo``
    [d, d] and the decay LoRA ``w_lora_a`` [d, L] / ``w_lora_b`` [L, d]
    in bf16; ``w0`` [d] (-6), ``mu`` [5, d] (streams r, k, v, w, g),
    ``u`` [d], ``ln_w`` [d] (1) and ``ln_b`` [d] (0) in f32.  The
    reference's ``mix_lora`` size has no parameters there, nor here."""

    def __init__(self, cfg: RWKVConfig, d_model: int, *, device=None):
        super().__init__()
        if d_model % cfg.head_dim:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"head_dim {cfg.head_dim}")
        bf = dict(device=device, dtype=torch.bfloat16)
        f32 = dict(device=device, dtype=torch.float32)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name,
                    nn.Parameter(torch.empty(d_model, d_model, **bf)))
        self.w_lora_a = nn.Parameter(torch.empty(d_model, cfg.decay_lora,
                                                 **bf))
        self.w_lora_b = nn.Parameter(torch.empty(cfg.decay_lora, d_model,
                                                 **bf))
        self.w0 = nn.Parameter(torch.full((d_model,), -6.0, **f32))
        self.mu = nn.Parameter(torch.empty(5, d_model, **f32))
        self.u = nn.Parameter(torch.empty(d_model, **f32))
        self.ln_w = nn.Parameter(torch.ones(d_model, **f32))
        self.ln_b = nn.Parameter(torch.zeros(d_model, **f32))


class ChannelMix(nn.Module):
    """Parameters ``wr`` [d, d], ``wk`` [d, d_ff], ``wv`` [d_ff, d] in
    bf16 and ``mu`` [2, d] (streams k, r) in f32."""

    def __init__(self, d_model: int, d_ff: int, *, device=None):
        super().__init__()
        bf = dict(device=device, dtype=torch.bfloat16)
        self.wr = nn.Parameter(torch.empty(d_model, d_model, **bf))
        self.wk = nn.Parameter(torch.empty(d_model, d_ff, **bf))
        self.wv = nn.Parameter(torch.empty(d_ff, d_model, **bf))
        self.mu = nn.Parameter(torch.empty(2, d_model, device=device,
                                           dtype=torch.float32))


def init(cfg: RWKVConfig, d_model: int, *, generator: torch.Generator,
         device=None) -> TimeMix:
    """The reference's distributions: projections normal * fan_in^-1/2,
    ``w_lora_b`` normal * 0.01, ``mu`` uniform [0, 1), ``u`` normal *
    0.1."""
    p = TimeMix(cfg, d_model, device=device)
    for w in (p.wr, p.wk, p.wv, p.wg, p.wo, p.w_lora_a):
        dense_init_(w, generator)
    dense_init_(p.w_lora_b, generator, scale=0.01)
    with torch.no_grad():
        p.mu.copy_(torch.rand(p.mu.shape, generator=generator,
                              device=p.mu.device))
        p.u.copy_(torch.randn(p.u.shape, generator=generator,
                              device=p.u.device) * 0.1)
    return p


def channel_mix_init(d_model: int, d_ff: int, *,
                     generator: torch.Generator, device=None) -> ChannelMix:
    p = ChannelMix(d_model, d_ff, device=device)
    for w in (p.wr, p.wk, p.wv):
        dense_init_(w, generator)
    with torch.no_grad():
        p.mu.copy_(torch.rand(p.mu.shape, generator=generator,
                              device=p.mu.device))
    return p


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) op by op in x's dtype, as the reference rounds
    ``jax.nn.sigmoid`` in bf16 (``torch.sigmoid`` rounds once)."""
    return 1 / (1 + torch.exp(-x))


def _token_shift(x, last=None):
    """shifted[t] = x[t-1]; position 0 gets ``last`` (decode carry) or 0."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


# the plain recurrence, under the reference's name: (r, k, v, w [B, T, H,
# N], u [H, N], s0) -> y [B, T, H, N], final state [B, H, N, N], both f32
wkv_scan = wkv6_ref


def _mix(mu, x, xx):
    """The token-shift mix of each stream: [n_streams, ..., d]."""
    mu = mu.to(x.dtype)
    return torch.stack([x + xx * mu[i] for i in range(mu.shape[0])])


def _mix_streams(p: TimeMix, cfg: RWKVConfig, x, shifted):
    xr, xk, xv, xw, xg = channelwise(_mix, p.mu, x, shifted - x)
    H, N = x.shape[-1] // cfg.head_dim, cfg.head_dim
    shp = x.shape[:-1] + (H, N)
    r = linear(xr, p.wr).reshape(shp)
    k = linear(xk, p.wk).reshape(shp)
    v = linear(xv, p.wv).reshape(shp)
    g = silu(linear(xg, p.wg))
    w = torch.exp(-torch.exp(
        p.w0.float() + linear(linear(xw, p.w_lora_a), p.w_lora_b).float()))
    return r, k, v, w.reshape(shp), g


def _group_norm(y, p: TimeMix, eps=1e-5):
    """Per-head layernorm of the wkv output (population variance)."""
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + eps)
    return y.reshape(y.shape[:-2] + (-1,)) * p.ln_w + p.ln_b


def time_mix(p: TimeMix, cfg: RWKVConfig, x, *, use_kernel=False,
             split=None):
    """Full-sequence time mix: x [B, T, d] -> [B, T, d]; ``split``: x
    holds this model rank's rows (module docstring)."""
    if split is not None:
        return split.own(lambda xs: time_mix(p, cfg, xs,
                                             use_kernel=use_kernel), x)
    d = x.shape[-1]
    H, N = d // cfg.head_dim, cfg.head_dim
    r, k, v, w, g = _mix_streams(p, cfg, x, _token_shift(x))
    u = p.u.reshape(H, N)
    if use_kernel:
        y = wkv_ops.wkv6(r, k, v, w, u)
    else:
        y, _ = wkv_scan(r, k, v, w, u)
    y = _group_norm(y, p).to(x.dtype) * g
    return linear(y, p.wo)


def channel_mix(p: ChannelMix, x, last=None, split=None):
    """The channel mix; ``split``: x holds this model rank's rows, the
    token shift comes from the gathered rows."""
    if split is None:
        shifted = _token_shift(x, last)
    else:
        shifted = split.cut(_token_shift(split.gather(x)))
    xk, xr = channelwise(_mix, p.mu, x, shifted - x)
    r = sigmoid(linear(xr, p.wr))
    k = torch.relu(linear(xk, p.wk)).square()
    return r * linear(k, p.wv)


# ---------------------------------------------------------------------------
# decode (O(1) state)
# ---------------------------------------------------------------------------


def init_state(cfg: RWKVConfig, batch: int, d_model: int, *, device=None,
               dtype=torch.bfloat16) -> dict:
    """The decode state: ``s`` [batch, H, N, N] always f32; the
    token-shift carries ``x_tm``/``x_cm`` [batch, d_model] in ``dtype``.
    The reference keeps the carries in bf16 whatever the weights' dtype;
    here they take the weights' dtype (the serving path passes it), which
    equals the reference in bf16 and keeps an f32 model f32 end to end."""
    H, N = d_model // cfg.head_dim, cfg.head_dim
    zeros = dict(device=device, dtype=dtype)
    return {"s": torch.zeros((batch, H, N, N), device=device,
                             dtype=torch.float32),
            "x_tm": torch.zeros((batch, d_model), **zeros),
            "x_cm": torch.zeros((batch, d_model), **zeros)}


def decode_time_mix(p: TimeMix, cfg: RWKVConfig, x, state: dict):
    """x [B, 1, d]; one plain recurrence step on the O(1) state."""
    d = x.shape[-1]
    H, N = d // cfg.head_dim, cfg.head_dim
    r, k, v, w, g = _mix_streams(p, cfg, x, state["x_tm"][:, None])
    s0, u = state["s"], p.u.reshape(H, N)
    if getattr(s0, "resident", False):
        # the state holds whole heads [h0, h0 + Hb): their recurrence
        # runs here, and their outputs are gathered over the group
        Hb = s0.block.shape[1]
        hs = slice(s0.index * Hb, (s0.index + 1) * Hb)
        y, s = wkv_scan(r[:, :, hs], k[:, :, hs], v[:, :, hs], w[:, :, hs],
                        u[hs], s0=s0.block)
        y = s0.all_gather(y, 2)
        s = s0.with_block(s)
    else:
        y, s = wkv_scan(r, k, v, w, u, s0=s0)
    y = _group_norm(y, p).to(x.dtype) * g
    state = dict(state, s=s, x_tm=x[:, 0].to(state["x_tm"].dtype))
    return linear(y, p.wo), state


def decode_channel_mix(p: ChannelMix, x, state: dict):
    y = channel_mix(p, x, last=state["x_cm"].to(x.dtype))
    return y, dict(state, x_cm=x[:, 0].to(state["x_cm"].dtype))
