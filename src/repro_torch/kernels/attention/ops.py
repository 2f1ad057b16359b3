"""Public wrapper for the flash-attention kernels.

``flash_attention`` keeps the reference op's signature and contract (Sq
and Sk multiples of the block, else ``ValueError``); the backward
recomputes through the plain reference (the reference's ``custom_vjp``
becomes a ``torch.autograd.Function``), so gradients are exact up to
dtype rounding.  The ``q_rows`` gather joins the differentiated graph,
so d/dq is the scatter-add of the gathered rows' gradients.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.kernel import flash_attention_bshd
from repro_torch.kernels.attention.ref import (  # noqa: F401
    attention_ref, gathered_attention_ref)


def _recompute_grads(fn, inputs, g):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, g)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_start):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale, q_start=q_start)
        return flash_attention_bshd(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        grads = _recompute_grads(
            lambda q, k, v: attention_ref(q, k, v, **ctx.kw),
            ctx.saved_tensors, g)
        return (*grads, None, None, None, None, None)


class _FlashGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_rows, causal, window, softcap, scale,
                q_start):
        ctx.save_for_backward(q, k, v, q_rows)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale, q_start=q_start)
        return flash_attention_bshd(q, k, v, q_rows=q_rows, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_rows = ctx.saved_tensors
        grads = _recompute_grads(
            lambda q_, k_, v_: gathered_attention_ref(q_, k_, v_, q_rows,
                                                      **ctx.kw),
            (q, k, v), g)
        return (*grads, None, None, None, None, None, None)


def flash_attention(q, k, v, causal=True, window=None, softcap=None,
                    scale=None, block_q=128, block_k=128, q_rows=None,
                    q_start=0):
    """q [B,Sq,H,D], k/v [B,Sk,K,D] -> [B,Sq,H,D] (flash kernel).

    ``q_rows`` ([Sq] or [B, Sq] int) fuses a dispatch-gather prologue
    into the kernel: output row t attends with token-order q row
    ``q_rows[..., t]`` (``-1`` -> zero output row), so the permuted q of
    an alltoall-style dispatch never materializes in device memory.
    Causal / window positions are output-order, output row t at
    position ``q_start + t`` of the keys: a block of rows of a longer
    query sequence (a model rank's rows of a sequence cut over ranks)
    gives the same rows as the whole call.  ``block_q`` /
    ``block_k`` keep the reference's contract: Sq and Sk must be
    multiples of ``min(block, S)``."""
    Sq, Sk = q.shape[1], k.shape[1]
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if bq < 1 or bk < 1 or Sq % bq or Sk % bk:
        raise ValueError(f"flash_attention: Sq {Sq} / Sk {Sk} are not "
                         f"multiples of the blocks ({bq}, {bk})")
    if q_rows is None:
        return _Flash.apply(q, k, v, causal, window, softcap, scale,
                            q_start)
    if q_rows.ndim == 1:
        q_rows = q_rows[None].expand(q.shape[0], Sq)
    return _FlashGather.apply(q, k, v, q_rows, causal, window, softcap,
                              scale, q_start)
