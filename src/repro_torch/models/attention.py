"""Multi-head attention: GQA/MQA, sliding window, logit softcap, qk_norm,
M-RoPE, cross-attention, KV-cache decode.

The causal prefill core routes through ``repro_torch.kernels.attention.ops``
(the hand-written flash kernel) when ``use_kernel``; everything around
it (projections, rope, cache, the decode step's attention) is plain
PyTorch.  As in the reference, cross-attention (whisper's decoder: keys
and values from the encoder output, no rope, every key live) and
non-causal self-attention (whisper's encoder) always run the plain
core.  With M-RoPE (qwen2-vl) ``positions`` is [3, B, S] (time, height,
width streams); the prefill masks with the time stream.

Under a sequence split (``split``, ``train.shard.SeqSplit``) ``x`` and
``positions`` are this model rank's rows: k and v are all-gathered over
the model axis along the sequence (a reduce-scatter in the backward) and
the rank attends its query rows at their global positions (the flash
kernel's ``q_start``).  Every product goes through
``models.common.linear`` (a column block on a mesh's decode).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models.common import (apply_mrope, apply_rope, attn_mask,
                                       dense_init_, linear, rmsnorm,
                                       softcap)
from repro_torch.models.config import AttnConfig

NEG_INF = -1e30


class Attention(nn.Module):
    """Parameters ``wq`` [d, H*D], ``wk`` / ``wv`` [d, K*D], ``wo``
    [H*D, d] and, with ``qk_norm``, ``q_norm`` / ``k_norm`` [D]."""

    def __init__(self, cfg: AttnConfig, d_model: int, *, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.wq = nn.Parameter(torch.empty(d_model, H * D, **kw))
        self.wk = nn.Parameter(torch.empty(d_model, K * D, **kw))
        self.wv = nn.Parameter(torch.empty(d_model, K * D, **kw))
        self.wo = nn.Parameter(torch.empty(H * D, d_model, **kw))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(D, **kw))
            self.k_norm = nn.Parameter(torch.ones(D, **kw))


def init(cfg: AttnConfig, d_model: int, *, generator: torch.Generator,
         device=None) -> Attention:
    p = Attention(cfg, d_model, device=device)
    for w in (p.wq, p.wk, p.wv, p.wo):
        dense_init_(w, generator)
    return p


def _project_qkv(p: Attention, cfg: AttnConfig, x, kv_src=None, *,
                 positions, eps=1e-6):
    """Returns q [B,Sq,H,D], k,v [B,Sk,K,D] with rope + qk_norm applied;
    k and v come from ``kv_src`` when given (cross-attention)."""
    B, S, _ = x.shape
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv_in = x if kv_src is None else kv_src
    Sk = kv_in.shape[1]
    q = linear(x, p.wq).reshape(B, S, H, D)
    k = linear(kv_in, p.wk).reshape(B, Sk, K, D)
    v = linear(kv_in, p.wv).reshape(B, Sk, K, D)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, eps)
        k = rmsnorm(k, p.k_norm, eps)
    if not cfg.cross and cfg.use_rope:    # cross-attn keys carry no rope
        if cfg.mrope_sections is not None:
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def core_attention(q, k, v, mask, *, cap=None, scale=None):
    """Plain core; [B,S,H,D] layout, ``mask`` [B, Sq, Sk] (True =
    attend).  The weights are rounded to v's dtype before the weighted
    sum, as in the reference."""
    H, K = q.shape[2], k.shape[2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if H != K:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if cap is not None:
        logits = softcap(logits, cap)
    logits = torch.where(mask[:, None] if mask.ndim == 3 else mask,
                         logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


CHUNK_THRESHOLD = 8192     # beyond this, q is processed in chunks
CHUNK_Q = 2048
# ... and so are calls whose [B, H, S, S] f32 scores would hold more
# elements than this (jamba's 64 heads at S = 8192: 17 GB), in chunks of
# at most CHUNK_SCORES / 4 score elements
CHUNK_SCORES = 1 << 30


def _chunk_rows(B: int, H: int, Sk: int) -> int:
    return max(1, min(CHUNK_Q, (CHUNK_SCORES // 4) // (B * H * Sk)))


def _chunked_core(q, k, v, mpos, *, causal, window, cap, scale=None,
                  chunk=CHUNK_Q):
    """Q-chunked plain attention: full [chunk, Sk] score rows per step,
    so peak memory is O(B*H*chunk*Sk) instead of O(B*H*S^2).  Rows of
    the padded last chunk (position -1) are masked and dropped."""
    B, S, H, D = q.shape
    nq = -(-S // chunk)
    pad = nq * chunk - S
    mpos = torch.broadcast_to(mpos, (B, mpos.shape[-1]))
    if pad:
        q = torch.cat([q, q.new_zeros((B, pad) + q.shape[2:])], dim=1)
        mpos = torch.cat([mpos, mpos.new_full((B, pad), -1)], dim=-1)
    kpos = torch.arange(k.shape[1], device=q.device).expand(B, k.shape[1])
    outs = []
    for c in range(nq):
        qc = q[:, c * chunk:(c + 1) * chunk]
        qpc = mpos[:, c * chunk:(c + 1) * chunk]
        m = attn_mask(qpc, kpos, causal=causal, window=window)
        m &= (qpc >= 0)[..., None]
        outs.append(core_attention(qc, k, v, m, cap=cap, scale=scale))
    return torch.cat(outs, dim=1)[:, :S]


def forward(p: Attention, cfg: AttnConfig, x, *, positions, window=None,
            kv_src=None, eps=1e-6, use_kernel=False, split=None):
    """Full-sequence attention (prefill); with ``cfg.cross`` the keys
    and values come from ``kv_src`` [B, Sk, d].  ``split``: ``x`` holds
    this model rank's rows of the sequence (see the module docstring)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, kv_src, positions=positions, eps=eps)
    win = window if window is not None else cfg.window
    # M-RoPE carries 3 position streams; masking uses the time stream
    mpos = positions[0] if cfg.mrope_sections is not None else positions
    kpos, q_start = mpos, 0
    if split is not None and not cfg.cross:
        k, v = split.gather(k), split.gather(v)
        kpos, q_start = split.key_pos, split.start(S)
    Sk = k.shape[1]
    if cfg.cross:
        mask = torch.ones((B, S, Sk), dtype=torch.bool, device=x.device)
        out = core_attention(q, k, v, mask, cap=cfg.softcap)
    elif use_kernel and cfg.causal:
        out = attn_ops.flash_attention(q, k, v, causal=True, window=win,
                                       softcap=cfg.softcap, q_start=q_start)
    elif S > CHUNK_THRESHOLD or B * cfg.n_heads * S * Sk > CHUNK_SCORES:
        out = _chunked_core(q, k, v, mpos, causal=cfg.causal,
                            window=win, cap=cfg.softcap,
                            chunk=_chunk_rows(B, cfg.n_heads, Sk))
    else:
        mask = attn_mask(mpos, kpos, causal=cfg.causal, window=win)
        mask = torch.broadcast_to(mask, (B,) + mask.shape[-2:])
        out = core_attention(q, k, v, mask, cap=cfg.softcap)
    return linear(out.reshape(B, S, -1), p.wo)


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: AttnConfig, batch: int, max_len: int, *, device=None,
               dtype=torch.bfloat16) -> dict:
    K, D = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, K, D), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, K, D), dtype=dtype,
                             device=device),
            "len": 0}


def decode_step(p: Attention, cfg: AttnConfig, x, cache: dict, *,
                window=None, eps=1e-6, seq=None):
    """One-token decode: x [B, 1, d]; returns (y [B, 1, d], cache').

    The new k/v row is written into the cache in place (the reference
    returns a new cache array); ``cache["len"]`` is a host int.  With
    ``seq`` (``serve.step.SeqShard``) the cache holds positions
    [seq.start, seq.start + S) of a sequence cut over ranks: the rank
    that holds position ``len`` writes it, and ``seq.attend`` combines
    the ranks' partial softmaxes (the mask from global positions)."""
    B = x.shape[0]
    t = cache["len"]
    positions = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections is not None:
        positions = positions[None].expand(3, B, 1)
    q, k, v = _project_qkv(p, cfg, x, positions=positions, eps=eps)
    ck, cv = cache["k"], cache["v"]
    start = 0 if seq is None else seq.start
    S = ck.shape[1]
    if 0 <= t - start < S:
        ck[:, t - start] = k[:, 0]
        cv[:, t - start] = v[:, 0]
    kpos = start + torch.arange(S, device=x.device)[None, :]
    win = window if window is not None else cfg.window
    mask = kpos <= t
    if win is not None:
        mask &= kpos > t - win
    mask = torch.broadcast_to(mask[:, None, :], (B, 1, S))
    if seq is None:
        out = core_attention(q, ck, cv, mask, cap=cfg.softcap)
    else:
        kk, vv = ck, cv
        if cfg.n_heads != cfg.n_kv_heads:
            g = cfg.n_heads // cfg.n_kv_heads
            kk = kk.repeat_interleave(g, dim=2)
            vv = vv.repeat_interleave(g, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              kk.float()) * q.shape[-1] ** -0.5
        if cfg.softcap is not None:
            logits = softcap(logits, cfg.softcap)
        out = seq.attend(logits, mask, vv)
    y = linear(out.reshape(B, 1, -1), p.wo)
    return y, {"k": ck, "v": cv, "len": t + 1}
