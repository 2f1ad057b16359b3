"""Public wrapper for the selective-scan kernel ([B, T, Di] layout).

The backward recomputes through the plain reference
``selective_scan_ref`` (the reference's ``custom_vjp`` becomes a
``torch.autograd.Function``); there is no backward kernel, as the
reference has none.  The reference's ``REPRO_KERNEL_SURROGATE`` stand-in
serves its CPU dry-run, which is not ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan.kernel import selective_scan_bdt
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xc, dt, Bc, Cc, A, D):
        ctx.save_for_backward(xc, dt, Bc, Cc, A, D)
        return selective_scan_bdt(xc, dt, Bc, Cc, A, D)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            return torch.autograd.grad(selective_scan_ref(*leaves)[0],
                                       leaves, g, allow_unused=True)


def selective_scan(xc, dt, Bc, Cc, A, D, block_t=64):
    """xc, dt [B, T, Di]; Bc, Cc [B, T, S]; A [Di, S]; D [Di] -> y
    [B, T, Di] float32.

    ``block_t`` is kept for the reference's signature; the kernel needs
    no time tiling, so any T >= 1 runs."""
    del block_t
    return _Scan.apply(xc, dt, Bc, Cc, A, D)
