"""Row rmsnorm kernels (``csrc/rmsnorm.cu``) and their plain versions.

``rmsnorm_reduce_2d`` is the fused allreduce epilogue: ``parts [P, R, d]``
are summed in f32 and normalised in one kernel, so the reduced tensor
never reaches device memory (P reads and one write per row, against
P reads + 1 write + 1 read + 1 write for reduce-then-normalise).
``rmsnorm_2d`` is the same kernel with one partial.  Both compute, per
row, ``x * rsqrt(mean x^2 + eps) * w`` with ``w = scale`` (or
``1 + scale`` for gemma-style) in f32 and store once in the input dtype.

Each wrapper takes the plain PyTorch version only for a CPU tensor; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch import cuda

SMEM_MAX = 232448          # bytes of shared memory one CTA may use (H100)


def _normalize_plain(x32: torch.Tensor, scale: torch.Tensor, eps: float,
                     gemma_style: bool, dtype) -> torch.Tensor:
    var = torch.mean(x32 * x32, -1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = scale.float()
    if gemma_style:
        w = 1.0 + w
    return (y * w).to(dtype)


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                  gemma_style: bool = False) -> torch.Tensor:
    """Plain version of the rmsnorm kernel: x [R, d], scale [d]."""
    return _normalize_plain(x.float(), scale, eps, gemma_style, x.dtype)


def rmsnorm_reduce_plain(parts: torch.Tensor, scale: torch.Tensor, *,
                         eps: float = 1e-6,
                         gemma_style: bool = False) -> torch.Tensor:
    """Plain version of the fused epilogue: parts [P, R, d] summed in
    f32 in p order, then normalised."""
    acc = parts[0].float()
    for p in range(1, parts.shape[0]):
        acc = acc + parts[p].float()
    return _normalize_plain(acc, scale, eps, gemma_style, parts.dtype)


def _threads(d: int) -> int:
    return min(256, -(-d // 32) * 32)


def _check(x: torch.Tensor, scale: torch.Tensor, d: int,
           name: str) -> tuple[int, int, torch.Tensor]:
    """The C entries' dtype codes for x and the scale, and the scale on
    x's device (the kernel widens it to f32 itself)."""
    code, scode = cuda.dtype_code(x.dtype), cuda.dtype_code(scale.dtype)
    if scale.shape != (d,):
        raise ValueError(f"{name}: scale shape {tuple(scale.shape)} != "
                         f"({d},)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if (d + 32) * 4 > SMEM_MAX:
        raise ValueError(f"{name}: row width {d} exceeds what one CTA "
                         f"holds in shared memory")
    return code, scode, scale.to(x.device).contiguous()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def rmsnorm_2d(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
               gemma_style: bool = False) -> torch.Tensor:
    """x [R, d], scale [d] -> [R, d] in x's dtype."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps, gemma_style=gemma_style)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_2d: unsupported device {x.device}")
    R, d = x.shape
    code, scode, w = _check(x, scale, d, "rmsnorm_2d")
    out = torch.empty_like(x)
    if R:
        with torch.cuda.device(x.device):
            err = cuda.library().repro_rmsnorm(
                code, scode, x.data_ptr(), w.data_ptr(), out.data_ptr(), R, d,
                float(eps), int(gemma_style), _threads(d), _stream(x))
        cuda.check(err, "rmsnorm")
        cuda.LAUNCHES["rmsnorm"] += 1
    return out


def rmsnorm_reduce_2d(parts: torch.Tensor, scale: torch.Tensor, *,
                      eps: float = 1e-6,
                      gemma_style: bool = False) -> torch.Tensor:
    """parts [P, R, d], scale [d] -> [R, d] in parts' dtype."""
    if parts.device.type == "cpu":
        return rmsnorm_reduce_plain(parts, scale, eps=eps,
                                    gemma_style=gemma_style)
    if parts.device.type != "cuda":
        raise ValueError(f"rmsnorm_reduce_2d: unsupported device "
                         f"{parts.device}")
    P, R, d = parts.shape
    code, scode, w = _check(parts, scale, d, "rmsnorm_reduce_2d")
    out = parts.new_empty((R, d))
    if R and P:
        with torch.cuda.device(parts.device):
            err = cuda.library().repro_rmsnorm_reduce(
                code, scode, parts.data_ptr(), w.data_ptr(), out.data_ptr(),
                P, R, d, float(eps), int(gemma_style), _threads(d),
                _stream(parts))
        cuda.check(err, "rmsnorm_reduce")
        cuda.LAUNCHES["rmsnorm_reduce"] += 1
    return out
