"""Plain PyTorch oracle for the selective-scan kernel: the O(T)
recurrence, step by step as the reference's ``selective_scan_ref``."""
from __future__ import annotations

import torch


def selective_scan_ref(xc, dt, Bc, Cc, A, D, h0=None):
    """xc, dt [B,T,Di]; Bc, Cc [B,T,S]; A [Di,S]; D [Di] -> y [B,T,Di]
    (f32), final h [B,Di,S] (f32).

    One step per token, in f32 from ``h0`` (or zeros):
    ``h = exp(dt_t A) h + (dt_t x_t) (x) B_t``, ``y_t = h . C_t + D x_t``.
    ``dt_t x_t`` is taken in the inputs' dtype before it is widened (a
    bf16 product when both are bf16), as the reference rounds it."""
    B_, T, Di = xc.shape
    S = Bc.shape[-1]
    h = (torch.zeros((B_, Di, S), dtype=torch.float32, device=xc.device)
         if h0 is None else h0.float())
    # the per-step operands, widened once (the same values per step)
    dtf = dt.float()
    dtx = (dt * xc).float()
    Bf, Cf = Bc.float(), Cc.float()
    Dx = D * xc.float()
    y = torch.empty((B_, T, Di), dtype=torch.float32, device=xc.device)
    for t in range(T):
        dA = torch.exp(dtf[:, t, :, None] * A)
        h = dA * h + dtx[:, t, :, None] * Bf[:, t, None, :]
        y[:, t] = torch.einsum("bds,bs->bd", h, Cf[:, t]) + Dx[:, t]
    return y, h
