"""Pieces both references share: the norm, the products in float32 or
in emulated fp8 (the control), the learning-rate schedule and AdamW as
the configuration states them."""
from __future__ import annotations

import math

import torch


def exact_f32() -> None:
    """Float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * w


def silu(x):
    return x * torch.sigmoid(x)


def mm_f32(x, w):
    return x @ w


E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def to_fp8(x, fmt=torch.float8_e4m3fn, top=E4M3_MAX):
    """``x`` rounded to fp8 under one scale for the whole tensor (its
    largest magnitude to the format's largest), back in float32."""
    scale = top / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(fmt).to(torch.float32) / scale


class _Fp8MatMul(torch.autograd.Function):
    """x @ w with both operands in e4m3 and, in the backward, the
    incoming gradient in e5m2: the usual fp8 training recipe."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = to_fp8(x), to_fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = to_fp8(g, torch.float8_e5m2, E5M2_MAX)
        gx = gq @ wq.transpose(-1, -2)
        gw = (xq.reshape(-1, xq.shape[-1]).transpose(0, 1)
              @ gq.reshape(-1, gq.shape[-1]))
        return gx, gw.reshape(wq.shape)


def mm_fp8(x, w):
    return _Fp8MatMul.apply(x, w)


class _Fp8Round(torch.autograd.Function):
    """An activation stored in e4m3; its gradient in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return to_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return to_fp8(g, torch.float8_e5m2, E5M2_MAX)


def keep_f32(x):
    return x


def keep_fp8(x):
    return _Fp8Round.apply(x)


# precision -> (the product, the rounding of an activation the program
# keeps in its working type between operations)
PRODUCTS = {"f32": mm_f32, "fp8": mm_fp8}
STORES = {"f32": keep_f32, "fp8": keep_fp8}


def cosine_lr(step: int, *, peak_lr, warmup_steps, total_steps,
              min_ratio=0.1) -> float:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``min_ratio``
    of it at ``total_steps``."""
    if step < warmup_steps:
        return peak_lr * step / max(warmup_steps, 1)
    frac = min(max((step - warmup_steps) / max(total_steps - warmup_steps,
                                               1), 0.0), 1.0)
    return peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                      * (1 + math.cos(math.pi * frac)))


@torch.no_grad()
def adamw(params: dict, grads: dict, mu: dict, nu: dict, count: int, *,
          lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          store=None) -> None:
    """One AdamW step in place, in float32: bias corrections divide the
    moments, the decay joins the step before the rate multiplies it.
    With ``store`` (a dtype) the new weights are rounded to it, as a
    configuration that keeps its weights in that type stores them."""
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    for k, p in params.items():
        g = grads[k]
        mu[k].mul_(b1).add_((1 - b1) * g)
        nu[k].mul_(b2).add_((1 - b2) * g * g)
        step = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
        p.sub_(lr * (step + weight_decay * p))
        if store is not None:
            p.copy_(p.to(store))
