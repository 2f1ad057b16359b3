"""The wkv6 kernel (``csrc/wkv6.cu``) and its plain version.

``wkv6_bthn`` takes the model's ``[B, T, H, N]`` layout directly (the
kernel reads r, k, v and w through their strides, so there is no
transpose to ``[B*H, T, N]``) and runs the RWKV-6 recurrence from a zero
state: ``y_t = r_t . (S + u (x) k_t v_t^T)``, then ``S = diag(w_t) S +
k_t v_t^T``, in f32, the [N, N] state held in registers.  r/k/v (one
dtype), w and u are each read in their own dtype, f32 or bf16 (on the CPU
too; anything else raises ``TypeError``); y comes back in f32.  Any
T >= 1 runs; N is one of ``HEAD_DIMS``.

The wrapper takes the plain PyTorch version only for a CPU tensor; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch import cuda
from repro_torch.kernels.wkv6.ref import wkv6_ref

HEAD_DIMS = (8, 16, 32, 64, 128)       # the kernel's instantiations


def wkv6_plain(r, k, v, w, u):
    """Plain version of the kernel (the reference math): y only."""
    return wkv6_ref(r, k, v, w, u)[0]


def _check(r, k, v, w, u) -> None:
    if r.ndim != 4:
        raise ValueError(f"wkv6: r must be [B, T, H, N], got "
                         f"{tuple(r.shape)}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"wkv6: {name} {tuple(t.shape)} != r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != tuple(r.shape[2:]):
        raise ValueError(f"wkv6: u {tuple(u.shape)} != [H, N] "
                         f"{tuple(r.shape[2:])}")
    for t in (r, w, u):
        cuda.dtype_code(t.dtype)        # f32 or bf16, else TypeError
    if not r.dtype == k.dtype == v.dtype:
        raise TypeError(f"wkv6: r, k, v dtypes differ ({r.dtype}, "
                        f"{k.dtype}, {v.dtype})")


def wkv6_bthn(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r, k, v, w [B, T, H, N]; u [H, N] -> y [B, T, H, N] float32."""
    _check(r, k, v, w, u)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    if any(t.device != r.device for t in (k, v, w, u)):
        raise ValueError("wkv6: inputs on different devices")
    B, T, H, N = r.shape
    if N not in HEAD_DIMS:
        raise ValueError(f"wkv6: head size {N} not in {HEAD_DIMS}")
    if B > 65535 or H > 65535:
        raise ValueError(f"wkv6: B {B} / H {H} exceed the grid (65535)")
    r, k, v, w = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (r, k, v, w))
    u = u.contiguous()
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    if y.numel() == 0:
        return y
    ins = (r, k, v, w, u)
    codes = [cuda.dtype_code(t.dtype) for t in (r, w, u)]
    strides = [s for t in ins[:4] for s in t.stride()[:3]]
    with torch.cuda.device(r.device):
        err = cuda.library().repro_wkv6(
            *codes, *(t.data_ptr() for t in ins), y.data_ptr(), *strides,
            B, T, H, N, torch.cuda.current_stream(r.device).cuda_stream)
    cuda.check(err, "wkv6")
    cuda.LAUNCHES["wkv6"] += 1
    return y
