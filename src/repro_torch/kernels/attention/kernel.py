"""Flash-attention kernels (``csrc/flash_attention.cu``) and their plain
version.

``flash_attention_bshd`` takes the model's ``[B, S, H, D]`` layout
directly (the kernel reads q, k and v through their strides, so there
is no transpose to ``[B*H, S, D]``): online softmax over kv tiles with
an f32 accumulator, GQA (kv head = q head // group), causal and window
masks and a tanh logit softcap.  With ``q_rows`` it runs the
dispatch-gather prologue: output row t attends with token-order q row
``q_rows[b, t]``, and an index outside [0, Sq) gives an exact zero row.
bf16 inputs with a head dim that is a multiple of 8 and 16-byte aligned
rows run on the Hopper body (wgmma on the tensor cores, k/v tiles
through a TMA ring, the attention weights rounded to bf16 for the P.V
product); f32, and other bf16 shapes, on the CUDA cores in f32.  Each
launch counts in ``cuda.FLASH_BODIES`` under the body that ran it.
``tile_classes`` gives the kv tiles the Hopper body visits for each q
tile, and which of them take no mask.  ``q_start`` places query row t at
position ``q_start + t`` of the keys (a block of a longer query
sequence: one model rank's rows of a sequence cut over ranks); the
masks and the causal tile skipping read positions.

The wrapper takes the plain PyTorch version only for a CPU tensor; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch import cuda
from repro_torch.kernels.attention.ref import (attention_ref,
                                               gathered_attention_ref)

MAX_HEAD_DIM = 256        # the f32 tiles fill shared memory here
WGMMA_BQ = 128            # the Hopper body's query rows per CTA


def wgmma_bk(head_dim: int) -> int:
    """Keys per kv tile of the Hopper body at this head dim."""
    return 64 if head_dim > 128 else 128


def tile_classes(Sq: int, Sk: int, bq: int, bk: int, causal: bool,
                 window: int | None,
                 q_start: int = 0) -> list[tuple[int, int, int, int]]:
    """Per q tile of ``bq`` rows, ``(j_lo, j_hi, i_lo, i_hi)``: the kernel
    visits kv tiles ``j_lo <= j < j_hi`` of ``bk`` keys, and the interior
    ones ``i_lo <= j < i_hi`` hold only live scores, so they take no
    mask; the others it visits are edge tiles.  A tile it skips holds
    only masked scores.  A q tile with a row that has no live key
    (``window`` set and ``t >= Sk + window - 1``) visits every kv tile.
    Mirrors ``kv_range`` in ``csrc/flash_attention.cu`` line for line."""
    out = []
    for t0 in range(0, Sq, bq):
        q_last = q_start + min(t0 + bq, Sq) - 1
        q0 = q_start + t0
        k_lo, k_hi = 0, Sk
        dead_row = window is not None and (window < 1
                                           or q_last >= Sk + window - 1)
        if not dead_row:
            if causal:
                k_hi = min(k_hi, q_last + 1)
            if window is not None:
                k_lo = max(0, q0 - window + 1)
        j_lo = k_lo // bk
        j_hi = (k_hi + bk - 1) // bk
        i_lo = j_lo
        i_hi = min(j_hi, Sk // bk)
        if causal:
            i_hi = min(i_hi, (q0 + 1) // bk)
        if window is not None:
            lo = q_last - window + 1
            if lo > 0:
                i_lo = min(max(i_lo, (lo + bk - 1) // bk), j_hi)
        if i_hi < i_lo:
            i_hi = i_lo
        out.append((j_lo, j_hi, i_lo, i_hi))
    return out


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          softcap=None, scale=None, q_rows=None,
                          q_start=0):
    """Plain version of both kernels (the reference math)."""
    if q_rows is None:
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale, q_start=q_start)
    return gathered_attention_ref(q, k, v, q_rows, causal=causal,
                                  window=window, softcap=softcap,
                                  scale=scale, q_start=q_start)


def _check(q, k, v, q_rows, softcap) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be [B, S, H, D]")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {k.shape[2]} kv heads")
    if k.shape[1] < 1:
        raise ValueError("flash_attention: no keys")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v dtypes differ")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap {softcap} <= 0")
    if q_rows is not None and tuple(q_rows.shape) != (B, Sq):
        raise ValueError(f"flash_attention: q_rows {tuple(q_rows.shape)} "
                         f"!= {(B, Sq)}")


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         softcap: float | None = None,
                         scale: float | None = None,
                         q_rows: torch.Tensor | None = None,
                         q_start: int = 0) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Sk,K,D] -> [B,Sq,H,D] in q's dtype; with
    ``q_rows`` [B, Sq] the gather prologue; q row t at position
    ``q_start + t``."""
    _check(q, k, v, q_rows, softcap)
    if q_start < 0:
        raise ValueError(f"flash_attention: q_start {q_start} < 0")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     q_rows=q_rows, q_start=q_start)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    code = cuda.dtype_code(q.dtype)
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} > {MAX_HEAD_DIM}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    scale = float(D ** -0.5 if scale is None else scale)
    cap = 0.0 if softcap is None else float(softcap)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    tail = (B, Sq, Sk, H, K, D, scale, cap, int(causal),
            int(window is not None), int(window or 0), int(q_start),
            torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        lib = cuda.library()
        if q_rows is None:
            err = lib.repro_flash_attention(code, *args, out.data_ptr(),
                                            *strides, *tail)
            name = "flash_attention"
        else:
            rows = q_rows.to(device=q.device, dtype=torch.int32).contiguous()
            err = lib.repro_flash_attention_gather(
                code, *args, rows.data_ptr(), out.data_ptr(), *strides,
                *tail)
            name = "flash_attention_gather"
    cuda.check(err, name)
    cuda.LAUNCHES[name] += 1
    wgmma = lib.repro_flash_attention_body(code, *args, out.data_ptr(),
                                           *strides, *tail[:6])
    cuda.FLASH_BODIES["wgmma" if wgmma else "cuda_cores"] += 1
    return out
