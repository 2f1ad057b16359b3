"""Public wrappers for the fused rmsnorm kernels: any leading shape, and
a backward that recomputes through the reference math (the reference's
``custom_vjp`` becomes a ``torch.autograd.Function``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_2d, rmsnorm_reduce_2d
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm_allreduce_ref(parts: torch.Tensor, scale: torch.Tensor, *,
                          eps: float = 1e-6,
                          gemma_style: bool = False) -> torch.Tensor:
    """Oracle for the fused epilogue: f32 sum over the partials axis,
    rounded to the parts' dtype, then the rmsnorm reference."""
    red = parts.float().sum(0).to(parts.dtype)
    return rmsnorm_ref(red, scale, eps=eps, gemma_style=gemma_style)


def _recompute_grads(fn, inputs, g):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, g)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps, gemma_style):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.gemma_style = eps, gemma_style
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        return rmsnorm_2d(flat, scale, eps=eps,
                          gemma_style=gemma_style).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        gx, gs = _recompute_grads(
            lambda x, s: rmsnorm_ref(x, s, eps=ctx.eps,
                                     gemma_style=ctx.gemma_style),
            ctx.saved_tensors, g)
        return gx, gs, None, None


class _RMSNormAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, parts, scale, eps, gemma_style):
        ctx.save_for_backward(parts, scale)
        ctx.eps, ctx.gemma_style = eps, gemma_style
        P, d = parts.shape[0], parts.shape[-1]
        flat = parts.reshape(P, -1, d).contiguous()
        out = rmsnorm_reduce_2d(flat, scale, eps=eps,
                                gemma_style=gemma_style)
        return out.reshape(parts.shape[1:])

    @staticmethod
    def backward(ctx, g):
        gp, gs = _recompute_grads(
            lambda p, s: rmsnorm_allreduce_ref(p, s, eps=ctx.eps,
                                               gemma_style=ctx.gemma_style),
            ctx.saved_tensors, g)
        return gp, gs, None, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            gemma_style: bool = False) -> torch.Tensor:
    """Fused rmsnorm over the last dim of ``x`` (any leading shape)."""
    return _RMSNorm.apply(x, scale, eps, gemma_style)


def rmsnorm_allreduce(parts: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6,
                      gemma_style: bool = False) -> torch.Tensor:
    """Fused allreduce->rmsnorm: ``parts`` [P, ..., d] are the per-rank
    partial activations (e.g. one ``all_gather`` of a tensor-parallel
    output); returns rmsnorm(sum over P) of shape [..., d] without ever
    writing the reduced tensor to device memory — the collective's
    terminal reduce round runs as the kernel's epilogue."""
    return _RMSNormAllreduce.apply(parts, scale, eps, gemma_style)
