"""Plain PyTorch oracle for the wkv6 kernel: the O(T) recurrence."""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, s0=None):
    """r,k,v,w [B,T,H,N]; u [H,N] -> y [B,T,H,N] (f32), final S
    [B,H,N,N] (f32).

    One step per token, in f32:
    ``y_t = r_t . (S + u (x) k_t v_t^T)``, then
    ``S = diag(w_t) S + k_t v_t^T``, starting from ``s0`` (or zeros)."""
    B, T, H, N = r.shape
    s = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    r, k, v, w = (t.float() for t in (r, k, v, w))
    uu = u.float()[..., :, None]                           # [H, N, 1]
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # [B, H, N, N]
        y[:, t] = torch.einsum("bhn,bhnm->bhm", r[:, t], s + uu * kv)
        s = w[:, t, :, :, None] * s + kv
    return y, s
