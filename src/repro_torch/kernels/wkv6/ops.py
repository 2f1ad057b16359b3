"""Public wrapper for the wkv6 kernel ([B, T, H, N] layout).

The backward recomputes through the plain reference ``wkv6_ref`` (the
reference's ``custom_vjp`` becomes a ``torch.autograd.Function``); there
is no backward kernel, as the reference has none.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv6.kernel import wkv6_bthn
from repro_torch.kernels.wkv6.ref import wkv6_ref


class _Wkv6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return wkv6_bthn(r, k, v, w, u)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            return torch.autograd.grad(wkv6_ref(*leaves)[0], leaves, g)


def wkv6(r, k, v, w, u, block_t=64):
    """r, k, v, w [B, T, H, N]; u [H, N] -> y [B, T, H, N] float32.

    ``block_t`` is kept for the reference's signature; the kernel needs
    no time tiling, so any T >= 1 runs."""
    del block_t
    return _Wkv6.apply(r, k, v, w, u)
