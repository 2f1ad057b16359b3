"""Shared model primitives: norms, softcap, rotary embeddings, masks,
init.

The numerics follow the reference package: norms reduce in f32 and cast
back to the input dtype once, rotary frequencies are computed in float64
by numpy and then rounded to f32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
            gemma_style: bool = False) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, -1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = (1.0 + scale.float()) if gemma_style else scale.float()
    return (y * w).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=64)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """``rope_freqs`` rounded to f32, copied to ``device`` once (a copy
    from host memory per call would wait for the device each layer)."""
    return torch.from_numpy(rope_freqs(head_dim, theta).astype(np.float32)
                            ).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, float(theta), x.device)           # [D/2]
    ang = positions[..., None].float() * freqs                  # [..., S, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=64)
def _mrope_streams(sections: tuple[int, ...], half: int,
                   device: torch.device) -> torch.Tensor:
    """For each of the ``half`` rotary frequencies, the position stream
    (0 = time, 1 = height, 2 = width) whose section holds it."""
    sec = np.concatenate([[0], np.cumsum(np.asarray(sections))])
    if sec[-1] != half:
        raise ValueError(f"M-RoPE sections {sections} do not cover the "
                         f"{half} rotary frequencies")
    which = np.zeros(half, np.int64)
    for i in range(len(sections)):
        which[sec[i]: sec[i + 1]] = i
    return torch.from_numpy(which).to(device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: three position streams (t, h, w) rotate
    disjoint sections of the frequencies.  x: [..., S, H, D];
    positions3: [3, ..., S].  Computed in f32, cast back once."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, float(theta), x.device)           # [D/2]
    which = _mrope_streams(tuple(int(s) for s in sections), d // 2,
                           x.device)
    p = torch.movedim(positions3, 0, -1).float()                # [..., S, 3]
    ang = p[..., which] * freqs                                 # [..., S, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# parameters held as blocks (decode on a mesh: ``train.shard.Resident``)
# ---------------------------------------------------------------------------


def _resident(w) -> bool:
    return getattr(w, "resident", False)


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w``.  A weight held where it is stored as a column block
    (``train.shard.Resident``, decode on a mesh) multiplies its block and
    gathers the product's output columns: the one rule every block
    function's products follow."""
    return w.matmul(x) if _resident(w) else x @ w


def lookup(table, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (rows of an embedding); a table held as a block of
    rows looks up its rows and sums the group's (see ``Resident``)."""
    return table.lookup(idx) if _resident(table) else table[idx]


def channelwise(fn, w, *xs):
    """``fn(w, *xs)`` for an op elementwise along the last dim of ``w``
    and of every ``x``; a ``w`` held as a block of that dim runs ``fn`` on
    its channels and gathers the outputs' channels."""
    return w.channelwise(fn, *xs) if _resident(w) else fn(w, *xs)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


def attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal=True,
              window=None) -> torch.Tensor:
    """Boolean [..., Sq, Sk] mask; True = attend.  ``window`` counts how
    far back attention reaches (gemma2 local layers)."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k <= q
    if window is not None:
        m &= k > q - window
    return m


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                scale: float | None = None, *,
                fan_in: int | None = None) -> torch.Tensor:
    """Fill ``w`` in place with normal * fan_in^-1/2 (or ``scale``),
    drawn in f32 from ``generator`` on ``w``'s device and rounded to
    ``w``'s dtype (bf16 in the models).  ``fan_in`` defaults to
    ``w.shape[0]``, as the reference's ``dense_init`` takes it; a
    stacked tensor that holds only some of the reference's rows (a
    device's share of the experts) passes the reference's count, so the
    share draws at the published scale."""
    if fan_in is None:
        fan_in = w.shape[0] if w.ndim >= 2 else 1
    s = scale if scale is not None else fan_in ** -0.5
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                            dtype=torch.float32) * s)
    return w
