"""CPU twin of the selective-scan kernel's tiling and order of adds.

``selective_scan_tiles`` runs the plan that ``scan_plan`` (or the caller)
gives, as ``csrc/mamba_scan.cu`` runs it, rounding to f32 where the
kernel rounds: the inputs widened to f32 and zero-filled past T and Di
to whole tiles (KT steps, 32 C channels); dt x an f32 product; dA =
2^(dt * (A log2 e)), both products in f32, with results below 2^-126
flushed to 0 (``ex2.approx.ftz``); h = fma(dA, h, (dt x) B_s) per state;
each of the W state-warps' partial y its first state's h C, then
fma(h_s, C_s, partial) over its S / W states in ascending order; then
each y the partials added in w order, then D x (an f32 product) added
last.  The fused multiply-adds round once (``fma32``), as the kernel's
``fmaf`` does.  The one step that is not the kernel's is the exp: the
twin's ``exp2`` is correctly rounded, the kernel's ``ex2.approx`` is
not, so the two agree bit for bit where every exp is exact (A = 0: every
decay 1) and to rounding elsewhere.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.mamba_scan.kernel import ScanPlan, scan_plan

LOG2E = 1.4426950408889634
FTZ_MIN = 2.0 ** -126          # the smallest normal f32


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for f32 tensors, rounded once to f32, as ``fmaf``.

    The product of two f32 values is exact in f64; the sum is taken in
    f64 with its error (TwoSum) and rounded to odd, which makes the last
    rounding to f32 the one correct rounding."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    inexact_even = (err != 0) & ((bits & 1) == 0)
    away = (err > 0) == (s > 0)               # the exact sum lies further out
    bits = torch.where(inexact_even, bits + torch.where(away, 1, -1), bits)
    return bits.view(torch.float64).float()


def _padded(t: torch.Tensor, T: int, width: int) -> torch.Tensor:
    """[B, T', n] widened to f32 and zero-padded to [B, T, width]."""
    out = t.new_zeros((t.shape[0], T, width), dtype=torch.float32)
    out[:, :t.shape[1], :t.shape[2]] = t.float()
    return out


def partials(xc, dt, Bc, Cc, A, plan: ScanPlan | None = None):
    """The state-warps' partial y ``[W, B, T', Di']`` and x ``[B, T',
    Di']`` (f32, padded to whole tiles), as the epilogue reads them."""
    B_, T, Di = xc.shape
    S = Bc.shape[-1]
    plan = plan or scan_plan(B_, Di, S)
    W, KT, CH = plan.warps, plan.steps, 32 * plan.groups
    SW = S // W
    Tp = math.ceil(T / KT) * KT
    Dp = math.ceil(Di / CH) * CH
    x, d = _padded(xc, Tp, Dp), _padded(dt, Tp, Dp)
    b, c = _padded(Bc, Tp, S), _padded(Cc, Tp, S)
    A2 = A.new_zeros((Dp, S), dtype=torch.float32)
    A2[:Di] = A.float() * torch.tensor(LOG2E, dtype=torch.float32)
    h = x.new_zeros((B_, Dp, S))
    part = x.new_empty((W, B_, Tp, Dp))
    for t in range(Tp):
        dv = d[:, t]
        dx = dv * x[:, t]
        dA = torch.exp2(dv[..., None] * A2)
        dA = torch.where(dA < FTZ_MIN, torch.zeros_like(dA), dA)
        h = fma32(dA, h, dx[..., None] * b[:, t, None, :])
        hw = h.view(B_, Dp, W, SW)
        cw = c[:, t].view(B_, 1, W, SW)
        p = hw[..., 0] * cw[..., 0]
        for j in range(1, SW):
            p = fma32(hw[..., j], cw[..., j], p)
        part[:, :, t] = p.permute(2, 0, 1)
    return part, x


def selective_scan_tiles(xc, dt, Bc, Cc, A, D,
                         plan: ScanPlan | None = None) -> torch.Tensor:
    """xc, dt [B, T, Di]; Bc, Cc [B, T, S]; A [Di, S]; D [Di] -> y
    [B, T, Di] float32, in the kernel's tiling and order of adds."""
    B_, T, Di = xc.shape
    part, x = partials(xc, dt, Bc, Cc, A, plan)
    Dd = D.new_zeros((x.shape[-1],), dtype=torch.float32)
    Dd[:Di] = D.float()
    y = part[0]
    for w in range(1, part.shape[0]):
        y = y + part[w]
    y = y + Dd * x
    return y[:, :T, :Di].contiguous()
