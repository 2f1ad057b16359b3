"""Plain-torch oracle for the fused rmsnorm kernels (the reference's
``kernels/rmsnorm/ref.py``); the custom backward recomputes through it."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                gemma_style: bool = False) -> torch.Tensor:
    # two separate widenings of x, as the reference writes it: autograd
    # then rounds each branch's gradient to x's dtype before summing
    var = torch.mean(torch.square(x.float()), -1, keepdim=True)
    y = x.float() * torch.rsqrt(var + eps)
    w = (1.0 + scale.float()) if gemma_style else scale.float()
    return (y * w).to(x.dtype)
