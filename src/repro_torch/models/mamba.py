"""Mamba-1 selective SSM (Jamba's attention-free mixer).

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t        (per channel)
    y_t = C_t . h_t + D * x_t
with input-dependent dt, B, C (the selectivity).  The full-sequence
recurrence runs the hand-written selective-scan kernel
(``repro_torch.kernels.mamba_scan``) when ``use_kernel``, else the plain
per-step scan.  Decode carries (conv window, h) as an O(1) state and runs
one plain step per token, as the reference does.

The roundings follow the reference: the depthwise conv is a sum of K
products in the activation dtype, each product and partial sum rounded
(``F.conv1d`` would round once); SiLU runs op by op; softplus is
``logaddexp(x, 0)`` in f32, as ``jax.nn.softplus`` computes it;
``A = -exp(A_log)`` in f32.  The kernel path rounds dt to bf16 and hands
the scan B and C in the activation dtype; the plain path and the decode
step keep all three in f32, so even in f32 the two paths differ by dt's
bf16 rounding, as in the reference.  The decode state keeps the conv
window in bf16 whatever the weights' dtype, as the reference does.

Under a sequence split (``split``) the layer runs on the model group's
gathered rows and keeps this rank's (exact: the conv window and the
scan see the whole sequence; the state is not carried from rank to
rank).  Decode on a mesh: the products are column blocks
(``models.common.linear``; ``w_in``'s fused x|z output is gathered
whole before it is split), the depthwise conv runs on ``conv_w``'s
channels and the state update on ``A_log``'s block of the state dim
(``channelwise``), with the state itself gathered for the step.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
from repro_torch.models.common import (channelwise, dense_init_, linear,
                                       rmsnorm)
from repro_torch.models.config import MambaConfig
from repro_torch.models.mlp import silu

# steps per rematerialised chunk of the plain scan under autograd (the
# reference's chunk-remat: h is kept only at chunk boundaries)
REMAT_CHUNK = 64


def dt_rank(cfg: MambaConfig, d_model: int) -> int:
    return cfg.dt_rank or -(-d_model // 16)


class Mamba(nn.Module):
    """Parameters as in the reference: ``w_in`` [d, 2 Di], ``conv_w``
    [K, Di], ``conv_b`` [Di], ``w_x`` [Di, R + 2 S], ``w_dt`` [R, Di],
    ``w_out`` [Di, d] and the inner norms ``dt_norm`` [R], ``b_norm`` /
    ``c_norm`` [S] in bf16; ``dt_bias`` [Di], ``A_log`` [Di, S] and ``D``
    [Di] in f32."""

    def __init__(self, cfg: MambaConfig, d_model: int, *, device=None):
        super().__init__()
        Di, S, R = cfg.expand * d_model, cfg.d_state, dt_rank(cfg, d_model)
        bf = dict(device=device, dtype=torch.bfloat16)
        f32 = dict(device=device, dtype=torch.float32)
        self.w_in = nn.Parameter(torch.empty(d_model, 2 * Di, **bf))
        self.conv_w = nn.Parameter(torch.empty(cfg.d_conv, Di, **bf))
        self.conv_b = nn.Parameter(torch.zeros(Di, **bf))
        self.w_x = nn.Parameter(torch.empty(Di, R + 2 * S, **bf))
        self.w_dt = nn.Parameter(torch.empty(R, Di, **bf))
        self.dt_bias = nn.Parameter(torch.empty(Di, **f32))
        self.A_log = nn.Parameter(torch.empty(Di, S, **f32))
        self.D = nn.Parameter(torch.ones(Di, **f32))
        self.dt_norm = nn.Parameter(torch.ones(R, **bf))
        self.b_norm = nn.Parameter(torch.ones(S, **bf))
        self.c_norm = nn.Parameter(torch.ones(S, **bf))
        self.w_out = nn.Parameter(torch.empty(Di, d_model, **bf))


def init(cfg: MambaConfig, d_model: int, *, generator: torch.Generator,
         device=None) -> Mamba:
    """The reference's distributions: projections normal * fan_in^-1/2,
    ``conv_w`` normal * 0.5, ``w_dt`` normal * R^-1/2, ``dt_bias`` the
    inverse softplus of exp(uniform(log 1e-3, log 1e-1)), ``A_log`` =
    log(1..S) on every channel, ``D`` = 1."""
    p = Mamba(cfg, d_model, device=device)
    R = p.w_dt.shape[0]
    for w in (p.w_in, p.w_x, p.w_out):
        dense_init_(w, generator)
    dense_init_(p.conv_w, generator, scale=0.5)
    dense_init_(p.w_dt, generator, scale=R ** -0.5)
    with torch.no_grad():
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand(p.dt_bias.shape, generator=generator,
                       device=p.dt_bias.device) * (hi - lo) + lo
        p.dt_bias.copy_(torch.log(torch.expm1(torch.exp(u))))
        S = p.A_log.shape[1]
        p.A_log.copy_(torch.log(torch.arange(
            1, S + 1, dtype=torch.float32, device=p.A_log.device)))
    return p


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)`` as ``jax.nn.softplus`` computes it: max(x, 0)
    + log1p(exp(-|x|)) (``F.softplus`` switches to x above 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _conv(x, w, b, carry=None):
    """Depthwise causal conv1d; x [B,T,Di], w [K,Di].  ``carry`` is the
    last K-1 inputs from the previous segment (decode).  A Python sum of
    K products in x's dtype, as the reference rounds it."""
    K = w.shape[0]
    pad = (x.new_zeros((x.shape[0], K - 1, x.shape[2])) if carry is None
           else carry)
    xp = torch.cat([pad, x], dim=1)
    T = x.shape[1]
    out = sum(xp[:, i: i + T] * w[i] for i in range(K))
    return silu(out + b), xp[:, -(K - 1):]


def _scan_inputs(p: Mamba, cfg: MambaConfig, proj, eps):
    """dt (f32, after softplus), B and C (rmsnormed, in proj's dtype)
    from the x projection [..., R + 2 S]."""
    R, S = p.w_dt.shape[0], cfg.d_state
    dt = rmsnorm(proj[..., :R], p.dt_norm, eps)
    Bc = rmsnorm(proj[..., R: R + S], p.b_norm, eps)
    Cc = rmsnorm(proj[..., R + S:], p.c_norm, eps)
    dt = softplus(linear(dt, p.w_dt).float() + p.dt_bias)
    return dt, Bc, Cc




def _plain_scan(xc, dt, Bc, Cc, A, D):
    """The plain recurrence (f32 dt, B, C).  Under autograd the steps
    run in chunks of REMAT_CHUNK that are recomputed in the backward, so
    only the chunk boundaries' h is kept (the reference's chunk-remat)."""
    if not torch.is_grad_enabled():
        return selective_scan_ref(xc, dt, Bc, Cc, A, D)[0]
    T = xc.shape[1]
    h, ys = None, []
    for t0 in range(0, T, REMAT_CHUNK):
        sl = slice(t0, t0 + REMAT_CHUNK)
        y, h = checkpoint(selective_scan_ref, xc[:, sl], dt[:, sl],
                          Bc[:, sl], Cc[:, sl], A, D, h, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1)


def forward(p: Mamba, cfg: MambaConfig, x, *, eps=1e-6, use_kernel=False,
            split=None):
    """x: [B, T, d] -> [B, T, d] (full sequence); ``split``: x holds this
    model rank's rows (module docstring)."""
    if split is not None:
        return split.own(lambda xs: forward(p, cfg, xs, eps=eps,
                                            use_kernel=use_kernel), x)
    xc, z = linear(x, p.w_in).chunk(2, dim=-1)
    xc, _ = _conv(xc, p.conv_w, p.conv_b)
    dt, Bc, Cc = _scan_inputs(p, cfg, linear(xc, p.w_x), eps)
    A = -torch.exp(p.A_log)
    if use_kernel:
        # the hand-written selective scan: the [Di, S] state and the
        # per-step temporaries stay on the SM; xc/dt/B/C stream once
        y = scan_ops.selective_scan(xc, dt.to(torch.bfloat16), Bc, Cc, A,
                                    p.D)
    else:
        y = _plain_scan(xc, dt, Bc.float(), Cc.float(), A, p.D)
    y = (y * silu(z.float())).to(x.dtype)
    return linear(y, p.w_out)


# ---------------------------------------------------------------------------
# decode (O(1) state)
# ---------------------------------------------------------------------------


def init_state(cfg: MambaConfig, batch: int, d_model: int, *,
               device=None) -> dict:
    """``h`` [batch, Di, S] f32 and the conv window ``conv`` [batch, K-1,
    Di] in bf16 (the reference's dtype, whatever the weights')."""
    Di = cfg.expand * d_model
    return {"h": torch.zeros((batch, Di, cfg.d_state), device=device,
                             dtype=torch.float32),
            "conv": torch.zeros((batch, cfg.d_conv - 1, Di), device=device,
                                dtype=torch.bfloat16)}


def decode_step(p: Mamba, cfg: MambaConfig, x, state: dict, eps=1e-6):
    """x: [B, 1, d]; one plain recurrence step on the O(1) state."""
    xc, z = linear(x, p.w_in).chunk(2, dim=-1)
    xc, conv_carry = channelwise(
        lambda w, xc, carry, b: _conv(xc, w, b, carry=carry), p.conv_w, xc,
        state["conv"].to(xc.dtype), p.conv_b)
    dt, Bc, Cc = _scan_inputs(p, cfg, linear(xc, p.w_x), eps)
    dt, xf = dt[:, 0, :, None], xc.float()[:, 0, :, None]

    def update(A_log, h, Bs):
        # dA h + dt x B on a block of the state dim
        return torch.exp(dt * -torch.exp(A_log)) * h + (dt * xf) * Bs

    h = channelwise(update, p.A_log, state["h"], Bc.float()[:, 0, None, :])
    y = torch.einsum("bds,bs->bd", h, Cc.float()[:, 0])[:, None]
    y = y + xc.float() * p.D
    y = (y * silu(z.float())).to(x.dtype)
    return linear(y, p.w_out), {"h": h,
                                "conv": conv_carry.to(torch.bfloat16)}
