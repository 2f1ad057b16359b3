"""Plain PyTorch oracles for the flash-attention kernels."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  scale=None, q_start=0):
    """q [B,Sq,H,D], k/v [B,Sk,K,D] (GQA: H multiple of K) -> [B,Sq,H,D].

    f32 logits, the softcap before the mask, masked logits -1e30, f32
    softmax and f32 weighted sum, one cast to q's dtype.  Query row t
    sits at position ``q_start + t`` of the keys' sequence (the masks):
    rows [q_start, q_start + Sq) of the whole call on all Sk queries."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    if H != K:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = q_start + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def gathered_attention_ref(q, k, v, q_rows, *, causal=True, window=None,
                           softcap=None, scale=None, q_start=0):
    """Oracle for the gather-prologue kernel: an explicit gather of the
    token-order q rows ``q_rows`` [B, Sq] (an index outside [0, Sq), the
    dispatch's -1, gives a zero row), then ``attention_ref``; the output
    rows of such indices are exact zeros."""
    B, Sq, H, D = q.shape
    live = (q_rows >= 0) & (q_rows < Sq)                    # [B, Sq]
    safe = torch.where(live, q_rows, 0).long()
    qg = torch.gather(q, 1, safe[:, :, None, None].expand(B, Sq, H, D))
    qg = torch.where(live[..., None, None], qg, 0)
    out = attention_ref(qg, k, v, causal=causal, window=window,
                        softcap=softcap, scale=scale, q_start=q_start)
    return torch.where(live[..., None, None], out, 0)
