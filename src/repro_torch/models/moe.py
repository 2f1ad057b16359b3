"""Mixture-of-experts feed-forward.

Routing follows the arch configs: softmax top-k (jamba) or sigmoid
scores whose top-k is picked on ``scores + router_bias`` and weighted by
the unbiased scores (deepseek-v3, moonshot), normalized and scaled by
``route_scale``; plus optional shared experts, one gated MLP of width
``d_expert * n_shared`` that sees every token (deepseek: 1 shared + 256
routed; moonshot: 2 + 64).

Two compute paths, as in the reference:
  * ``forward`` — dense dispatch: every held expert multiplies every
    token, weighted by its routing weight (zero where not routed).
    Exact; the prefill path.  The tokens go through in chunks of
    ``DENSE_CHUNK`` rows, which bounds the [tokens, experts, d_expert]
    intermediates (at jamba's widths, 8 held experts and 1024 rows, 403
    MB each in bf16).
  * ``forward_dropless`` — capacity-bounded gather dispatch: (token,
    slot) pairs are bucketed per expert in row-major order, at most C per
    expert; overflow drops.  The decode path.

A layer may hold only experts [lo, hi) of ``cfg.n_experts``
(``MoEConfig.held``), as one rank of an expert-parallel group does: it
routes over all experts, computes only its own experts' part of the
result and adds nothing for the others (their ranks would; on one card
the layer runs without the exchange).  The capacity is that of the
whole layer.  The shared experts are added only by the share that holds
expert 0 (``lo == 0``), so that summing the ranks' parts counts them
once.  ``aux_loss`` is the reference's Switch-style load-balance
loss over the router's probabilities and choices.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import mlp
from repro_torch.models.common import dense_init_, linear
from repro_torch.models.config import MoEConfig

DENSE_CHUNK = 1024          # token rows per dense-dispatch chunk


class MoE(nn.Module):
    """Parameters ``router`` [d, E] f32 (all ``n_experts``), the held
    experts' stacks ``w_gate`` / ``w_up`` [E_held, d, f] and ``w_down``
    [E_held, f, d] in bf16; with sigmoid routing ``router_bias`` [E] f32;
    with shared experts ``shared`` (an ``mlp.MLP`` of width f *
    ``n_shared``), held whole by every share."""

    def __init__(self, cfg: MoEConfig, d_model: int, *, device=None):
        super().__init__()
        lo, hi = cfg.held_range()
        E, f = cfg.n_experts, cfg.d_expert
        bf = dict(device=device, dtype=torch.bfloat16)
        self.router = nn.Parameter(torch.empty(d_model, E, device=device,
                                               dtype=torch.float32))
        self.w_gate = nn.Parameter(torch.empty(hi - lo, d_model, f, **bf))
        self.w_up = nn.Parameter(torch.empty(hi - lo, d_model, f, **bf))
        self.w_down = nn.Parameter(torch.empty(hi - lo, f, d_model, **bf))
        if cfg.router == "sigmoid":
            self.router_bias = nn.Parameter(torch.zeros(
                E, device=device, dtype=torch.float32))
        if cfg.n_shared:
            self.shared = mlp.MLP(d_model, f * cfg.n_shared, device=device)


def init(cfg: MoEConfig, d_model: int, *, generator: torch.Generator,
         device=None) -> MoE:
    """The reference's distributions: the router normal * d^-1/2 drawn in
    bf16 and kept in f32; each expert stack normal * E^-1/2, the
    reference's fan-in of a stacked [E, ...] tensor, with E the published
    ``n_experts`` even when fewer are held; ``router_bias`` zeros; the
    shared MLP normal * fan_in^-1/2."""
    p = MoE(cfg, d_model, device=device)
    with torch.no_grad():
        r = torch.empty(p.router.shape, device=p.router.device,
                        dtype=torch.bfloat16)
        p.router.copy_(dense_init_(r, generator, scale=d_model ** -0.5))
    for w in (p.w_gate, p.w_up, p.w_down):
        dense_init_(w, generator, fan_in=cfg.n_experts)
    if cfg.n_shared:
        for w in p.shared.parameters():
            dense_init_(w, generator)
    return p


def route(p: MoE, cfg: MoEConfig, x):
    """x: [T, d] -> (weights [T, k] in x's dtype, idx [T, k], probs
    [T, E]); the router product and the scores in f32.  Sigmoid routing
    selects on ``scores + router_bias`` (the bias only biases the
    choice) and gathers the weights from the unbiased scores."""
    logits = linear(x.float(), p.router)
    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + p.router_bias
    else:
        scores = sel = torch.softmax(logits, dim=-1)
    idx = torch.topk(sel, cfg.top_k, dim=-1).indices
    w = torch.gather(scores, -1, idx)
    if cfg.norm_topk:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return (w * cfg.route_scale).to(x.dtype), idx, scores


def _held_experts(p: MoE, be, act):
    """The held experts on their rows: be [E_held, rows, d] ->
    [E_held, rows, d]."""
    h = mlp.ACT[act](torch.matmul(be, p.w_gate)) * torch.matmul(be, p.w_up)
    return torch.matmul(h, p.w_down)


def _add_shared(p: MoE, cfg: MoEConfig, out, xt, act, lo: int):
    """``out`` plus the shared experts' part, added by the share that
    holds expert 0 only."""
    if cfg.n_shared and lo == 0:
        out = out + mlp.forward(p.shared, xt, act)
    return out


def forward(p: MoE, cfg: MoEConfig, x, act: str = "silu"):
    """Dense-dispatch MoE: x [B, S, d] -> [B, S, d]."""
    B, S, d = x.shape
    lo, hi = cfg.held_range()
    xt = x.reshape(-1, d)
    w, idx, _ = route(p, cfg, xt)
    # combine weights [T, E]: the routing weight where routed, else 0
    cw = torch.zeros((xt.shape[0], cfg.n_experts), dtype=x.dtype,
                     device=x.device).scatter_(1, idx, w)[:, lo:hi]
    out = torch.empty_like(xt)
    for r0 in range(0, xt.shape[0], DENSE_CHUNK):
        rows = slice(r0, r0 + DENSE_CHUNK)
        y = _held_experts(p, xt[None, rows], act)       # [E_held, r, d]
        out[rows] = torch.einsum("etd,te->td", y, cw[rows])
    return _add_shared(p, cfg, out, xt, act, lo).reshape(B, S, d)


def forward_dropless(p: MoE, cfg: MoEConfig, x, act: str = "silu",
                     capacity_factor: float = 1.25):
    """Capacity-bounded gather dispatch: (token, slot) pairs are bucketed
    per expert in row-major order (static capacity C = int(T k / E *
    factor), at least 1, over the layer's E experts); overflow drops."""
    B, S, d = x.shape
    lo, hi = cfg.held_range()
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    w, idx, _ = route(p, cfg, xt)
    E, K = cfg.n_experts, cfg.top_k
    C = max(1, int(T * K / E * capacity_factor))
    flat_e = idx.reshape(-1)                                 # [T*K]
    # position of each (token, slot) within its expert bucket
    onehot = torch.nn.functional.one_hot(flat_e, E)          # [T*K, E]
    pos = torch.cumsum(onehot, dim=0) - 1
    pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]        # [T*K]
    keep = (pos < C) & (flat_e >= lo) & (flat_e < hi)
    n = (hi - lo) * C                                        # held slots
    dest = torch.where(keep, (flat_e - lo) * C + pos, n)     # drop slot
    buckets = xt.new_zeros((n + 1, d))
    buckets[dest] = torch.repeat_interleave(xt, K, dim=0)
    ye = _held_experts(p, buckets[:n].reshape(hi - lo, C, d), act)
    flat_y = torch.cat([ye.reshape(n, d), xt.new_zeros((1, d))])
    out = torch.einsum("tkd,tk->td", flat_y[dest].reshape(T, K, d), w)
    return _add_shared(p, cfg, out, xt, act, lo).reshape(B, S, d)


def aux_loss(cfg: MoEConfig, probs, idx):
    """Switch-style load-balance loss over the router probs [T, E] and
    choices idx [T, k]: E * sum_e(routed fraction_e * mean prob_e)."""
    E = cfg.n_experts
    load = torch.nn.functional.one_hot(idx, E).float().sum((0, 1)) \
        / idx.shape[0]
    return E * torch.sum(load * probs.mean(0))
