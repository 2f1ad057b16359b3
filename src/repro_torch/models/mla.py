"""Multi-head latent attention (DeepSeek-V2/V3).

Queries and KV are projected through low-rank bottlenecks; the rope part
of the key is shared across heads (computed from the input, not the
latent).  The decode cache holds only the compressed latent ``ckv`` and
the rope key ``kr``: kv_lora_rank + qk_rope_head_dim values a token
instead of 2 H head_dim, which is the point of MLA.

The prefill with ``use_kernel`` runs the flash kernel on up-projected
heads, as the reference does: q = [q_nope, q_rope], k = [k_nope, k_rope
repeated over the heads] (materialised by ``torch.cat``, so every
stride is positive and the kernel's Hopper body takes it), v zero-padded
from ``v_head_dim`` to the qk head dim, scale qk_head_dim^-1/2, and the
output cut back to ``v_head_dim``.  The padding costs the kernel a third
more P V work at deepseek's widths (192 against 128 columns).  Without
the kernel the plain ``_attend`` runs (``_plain_core``), on q in chunks
where the [B, H, S, S] f32 scores would pass ``attention.CHUNK_SCORES``
elements (128 heads at 8192 tokens: 34 GB); rows are independent, so
chunking changes memory, not results.  Both cores return the heads
[B, S, H, v_head_dim]; ``forward`` and ``decode_step`` apply ``wo``.

Under a sequence split (``split``) the rank projects its own rows, the
latents ``ckv`` and ``k_rope`` are all-gathered over the model axis
along the sequence (a reduce-scatter in the backward), every rank
up-projects the whole sequence's latents and attends its query rows at
their global positions.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models import attention
from repro_torch.models.common import (apply_rope, dense_init_, linear,
                                       rmsnorm)
from repro_torch.models.config import MLAConfig


class MLA(nn.Module):
    """Parameters ``w_dq`` [d, q_lora], ``q_norm`` [q_lora], ``w_uq``
    [q_lora, H (nope + rope)], ``w_dkv`` [d, kv_lora], ``kv_norm``
    [kv_lora], ``w_uk`` [kv_lora, H nope], ``w_uv`` [kv_lora, H v],
    ``w_kr`` [d, rope] and ``wo`` [H v, d], applied as ``x @ w``."""

    def __init__(self, cfg: MLAConfig, d_model: int, *, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        H = cfg.n_heads
        kw = dict(device=device, dtype=dtype)

        def w(*shape):
            return nn.Parameter(torch.empty(*shape, **kw))
        self.w_dq = w(d_model, cfg.q_lora_rank)
        self.q_norm = nn.Parameter(torch.ones(cfg.q_lora_rank, **kw))
        self.w_uq = w(cfg.q_lora_rank, H * cfg.qk_head_dim)
        self.w_dkv = w(d_model, cfg.kv_lora_rank)
        self.kv_norm = nn.Parameter(torch.ones(cfg.kv_lora_rank, **kw))
        self.w_uk = w(cfg.kv_lora_rank, H * cfg.qk_nope_head_dim)
        self.w_uv = w(cfg.kv_lora_rank, H * cfg.v_head_dim)
        self.w_kr = w(d_model, cfg.qk_rope_head_dim)
        self.wo = w(H * cfg.v_head_dim, d_model)


def init(cfg: MLAConfig, d_model: int, *, generator: torch.Generator,
         device=None) -> MLA:
    p = MLA(cfg, d_model, device=device)
    for w in (p.w_dq, p.w_uq, p.w_dkv, p.w_uk, p.w_uv, p.w_kr, p.wo):
        dense_init_(w, generator)
    return p


def _latents(p: MLA, cfg: MLAConfig, x, positions, eps):
    """(q_nope [B,S,H,nope], q_rope [B,S,H,rope], ckv [B,S,kv_lora],
    k_rope [B,S,1,rope]), rope applied."""
    B, S, _ = x.shape
    H = cfg.n_heads
    q = linear(rmsnorm(linear(x, p.w_dq), p.q_norm, eps), p.w_uq)
    q = q.reshape(B, S, H, cfg.qk_head_dim)
    q_nope, q_rope = torch.split(
        q, [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = rmsnorm(linear(x, p.w_dkv), p.kv_norm, eps)
    k_rope = apply_rope(linear(x, p.w_kr)[:, :, None, :], positions,
                        cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope


def _up(p: MLA, cfg: MLAConfig, ckv):
    """The latent up-projected: (k_nope [B,Sk,H,nope], v [B,Sk,H,v])."""
    B, Sk, _ = ckv.shape
    H = cfg.n_heads
    return (linear(ckv, p.w_uk).reshape(B, Sk, H, cfg.qk_nope_head_dim),
            linear(ckv, p.w_uv).reshape(B, Sk, H, cfg.v_head_dim))


def _attend(p: MLA, cfg: MLAConfig, q_nope, q_rope, ckv, k_rope, mask,
            kv=None):
    """The plain core on the latents: scores in f32 (the nope and rope
    products summed, then scaled), ``mask`` [B, Sq, Sk] (True = attend),
    the weights rounded to v's dtype: -> the heads [B, Sq, H, v], before
    ``wo``."""
    k_nope, v = _up(p, cfg, ckv) if kv is None else kv
    scale = cfg.qk_head_dim ** -0.5
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
              + torch.einsum("bqhd,bkod->bhqk", q_rope.float(),
                             k_rope.float())) * scale
    logits = torch.where(mask[:, None], logits, attention.NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def _kernel_core(p: MLA, cfg: MLAConfig, q_nope, q_rope, ckv, k_rope,
                 q_start=0):
    """The flash kernel on up-projected heads: -> [B, Sq, H, v_head_dim]
    (query row t at position ``q_start + t`` of the latents' keys)."""
    B, Sq, H, _ = q_nope.shape
    S = ckv.shape[1]
    k_nope, v = _up(p, cfg, ckv)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, cfg.qk_rope_head_dim)],
                  -1)
    vp = torch.cat([v, v.new_zeros((B, S, H, q.shape[-1] - v.shape[-1]))],
                   -1)
    out = attn_ops.flash_attention(q, k, vp, True, None, None,
                                   cfg.qk_head_dim ** -0.5, q_start=q_start)
    return out[..., :cfg.v_head_dim]


def _plain_core(p: MLA, cfg: MLAConfig, q_nope, q_rope, ckv, k_rope,
                q_start=0):
    """The plain ``_attend`` under the causal mask, q in row chunks where
    the [B, H, Sq, S] f32 scores would pass ``attention.CHUNK_SCORES``
    elements: -> [B, Sq, H, v_head_dim]."""
    B, Sq, H, _ = q_nope.shape
    S = ckv.shape[1]
    kpos = torch.arange(S, device=q_nope.device)
    qpos = kpos[q_start:q_start + Sq]
    if Sq <= attention.CHUNK_THRESHOLD and B * H * Sq * S <= \
            attention.CHUNK_SCORES:
        mask = (kpos[None, :] <= qpos[:, None]).expand(B, Sq, S)
        return _attend(p, cfg, q_nope, q_rope, ckv, k_rope, mask)
    c = attention._chunk_rows(B, H, S)
    kv = _up(p, cfg, ckv)
    outs = []
    for q0 in range(0, Sq, c):
        qc = qpos[q0:q0 + c]
        mask = (kpos[None, :] <= qc[:, None]).expand(B, len(qc), S)
        outs.append(_attend(p, cfg, q_nope[:, q0:q0 + c],
                            q_rope[:, q0:q0 + c], ckv, k_rope, mask, kv=kv))
    return torch.cat(outs, dim=1)


def forward(p: MLA, cfg: MLAConfig, x, *, positions, eps=1e-6,
            use_kernel=False, split=None):
    """Full-sequence causal MLA (prefill): x [B, S, d] -> [B, S, d];
    ``split``: ``x`` holds this model rank's rows (module docstring)."""
    B, S, _ = x.shape
    q_nope, q_rope, ckv, k_rope = _latents(p, cfg, x, positions, eps)
    q_start = 0
    if split is not None:
        ckv, k_rope = split.gather(ckv), split.gather(k_rope)
        q_start = split.start(S)
    core = _kernel_core if use_kernel else _plain_core
    out = core(p, cfg, q_nope, q_rope, ckv, k_rope, q_start)
    return linear(out.reshape(B, S, -1), p.wo)


# ---------------------------------------------------------------------------
# decode with the latent cache
# ---------------------------------------------------------------------------


def init_cache(cfg: MLAConfig, batch: int, max_len: int, *, device=None,
               dtype=torch.bfloat16) -> dict:
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros((batch, max_len, 1, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device),
            "len": 0}


def decode_step(p: MLA, cfg: MLAConfig, x, cache: dict, *, eps=1e-6,
                seq=None):
    """One-token decode: x [B, 1, d]; returns (y [B, 1, d], cache').
    The new latent row is written into the cache in place; the cached
    latents are up-projected each step, as in the reference.  With
    ``seq`` the latents hold a block of a sequence cut over ranks (see
    ``attention.decode_step``)."""
    B = x.shape[0]
    t = cache["len"]
    positions = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q_nope, q_rope, ckv, k_rope = _latents(p, cfg, x, positions, eps)
    c2, r2 = cache["ckv"], cache["kr"]
    start = 0 if seq is None else seq.start
    S = c2.shape[1]
    if 0 <= t - start < S:
        c2[:, t - start] = ckv[:, 0]
        r2[:, t - start] = k_rope[:, 0]
    mask = (start + torch.arange(S, device=x.device) <= t)[None, None, :]
    mask = mask.expand(B, 1, S)
    if seq is None:
        y = _attend(p, cfg, q_nope, q_rope, c2, r2, mask)
    else:
        k_nope, v = _up(p, cfg, c2)
        logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(),
                               k_nope.float())
                  + torch.einsum("bqhd,bkod->bhqk", q_rope.float(),
                                 r2.float())) * cfg.qk_head_dim ** -0.5
        y = seq.attend(logits, mask, v)
    return linear(y.reshape(B, 1, -1), p.wo), {"ckv": c2, "kr": r2,
                                               "len": t + 1}
