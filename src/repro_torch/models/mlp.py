"""Gated MLP (SwiGLU / GeGLU)."""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.common import dense_init_, linear


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), the sigmoid written 1 / (1 + exp(-x)) with every
    op in x's dtype: bit for bit what the reference computes in bf16.
    ``F.silu`` rounds once from f32 and differs from it in 4 of 10
    bf16 outputs by an ulp, which moves a few smoke-size logits past
    the model tolerance."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU op by op in x's dtype, as ``jax.nn.gelu(x,
    approximate=True)`` computes it (``F.gelu`` rounds once from f32)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x))))
    return x * cdf


ACT = {"silu": silu, "gelu": gelu_tanh}


class MLP(nn.Module):
    """Parameters ``w_gate`` / ``w_up`` [d_model, d_ff] and ``w_down``
    [d_ff, d_model], applied as ``x @ w`` like the reference."""

    def __init__(self, d_model: int, d_ff: int, gated: bool = True, *,
                 device=None, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if gated:
            self.w_gate = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.w_up = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.w_down = nn.Parameter(torch.empty(d_ff, d_model, **kw))


def init(d_model: int, d_ff: int, gated: bool = True, *,
         generator: torch.Generator, device=None) -> MLP:
    p = MLP(d_model, d_ff, gated, device=device)
    for w in p.parameters():
        dense_init_(w, generator)
    return p


def forward(p: MLP, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    if hasattr(p, "w_gate"):
        return linear(ACT[act](linear(x, p.w_gate)) * linear(x, p.w_up),
                      p.w_down)
    return linear(ACT[act](linear(x, p.w_up)), p.w_down)
