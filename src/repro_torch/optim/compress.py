"""Gradient compression: int8 block quantization with error feedback.

Used by the compressed DP sync (``train.sync.dp_allreduce_compressed``):
gradients are quantized to int8 (per-block absmax scale) before crossing
the inter-pod hop; the quantization residual is fed back into the next
step's gradient so the bias cancels over time (the EF-SGD argument).
"""
from __future__ import annotations

import torch

BLOCK = 256


def compress_int8(x: torch.Tensor):
    """x [..] -> (q int8 [nblocks, BLOCK], scale f32 [nblocks]) over the
    flattened, zero-padded blocks; rounds half to even (``torch.round``,
    as ``jnp.round``)."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 \
        + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype):
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def ef_compress_tree(grads: dict, residual: dict | None):
    """Error feedback then compression, leaf by leaf: -> ({name: (q,
    scale)}, new residual {name: f32})."""
    comp, new_res = {}, {}
    for k, g in grads.items():
        # + 0.0 without a residual, as the reference adds it (-0.0 -> 0.0)
        x = g.float() + (residual[k] if residual is not None else 0.0)
        q, s = compress_int8(x)
        comp[k] = (q, s)
        new_res[k] = x - decompress_int8(q, s, g.shape, torch.float32)
    return comp, new_res
