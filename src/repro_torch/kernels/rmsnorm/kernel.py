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

import functools

import torch

from repro_torch import cuda

SMEM_MAX = 232448          # bytes of shared memory one CTA may use (H100)
VEC_BYTES = 16             # the vector body's loads and stores
MAX_VPT = 4                # vectors a thread holds (csrc kMaxVpt)
MAX_THREADS = 512          # the vector body's CTA size at most (kMaxThreads)


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


def _vector_tiling(nvec: int) -> tuple[int, int]:
    """(vectors a thread, threads a CTA) for a row of ``nvec`` vectors:
    an exact fit (every thread holds the same count, whole warps) when
    one exists, most vectors a thread first; else up to MAX_VPT vectors
    a thread and whole warps that cover the row."""
    for vpt in range(MAX_VPT, 0, -1):
        threads, rem = divmod(nvec, vpt)
        if not rem and threads % 32 == 0 and threads <= MAX_THREADS:
            return vpt, threads
    vpt = min(MAX_VPT, -(-nvec // 128))
    return vpt, -(-nvec // (32 * vpt)) * 32


@functools.lru_cache(maxsize=1024)
def rmsnorm_body(d: int, dtype: torch.dtype, offset: int
                 ) -> tuple[str, int, int]:
    """The body that runs a row of ``d`` values of ``dtype`` whose input
    (or output) lies ``offset`` bytes past a 16-byte boundary:
    ``("vector", vectors a thread, threads)`` when the row is whole
    16-byte vectors on 16-byte boundaries and fits MAX_VPT x MAX_THREADS
    vectors, else ``("scalar", 0, threads)``.  ``csrc/rmsnorm.cu``
    re-checks the vector body's conditions and refuses a launch that
    breaks them."""
    per = VEC_BYTES // dtype.itemsize
    nvec = d // per
    if (d % per == 0 and offset % VEC_BYTES == 0
            and 0 < nvec <= MAX_VPT * MAX_THREADS):
        return ("vector", *_vector_tiling(nvec))
    return "scalar", 0, min(256, -(-d // 32) * 32)


def _launch(entry: str, parts: torch.Tensor, scale: torch.Tensor,
            out: torch.Tensor, P: int, R: int, d: int, eps: float,
            gemma_style: bool) -> None:
    """Check the operands and run one launch of ``entry`` (P partials;
    ``repro_rmsnorm`` takes no P).  The lean path: no device context
    when ``parts`` is on the current device, no scale copy when it is
    already there and contiguous, one ctypes call."""
    code, scode = cuda.dtype_code(parts.dtype), cuda.dtype_code(scale.dtype)
    if scale.shape != (d,):
        raise ValueError(f"{entry}: scale shape {tuple(scale.shape)} != "
                         f"({d},)")
    if not parts.is_contiguous():
        raise ValueError(f"{entry}: input must be contiguous")
    if scale.device != parts.device or not scale.is_contiguous():
        scale = scale.to(parts.device).contiguous()
    body, vpt, threads = rmsnorm_body(
        d, parts.dtype, (parts.data_ptr() | out.data_ptr()) % VEC_BYTES)
    if body == "scalar" and (d + 32) * 4 > SMEM_MAX:
        raise ValueError(f"{entry}: row width {d} exceeds what one CTA "
                         f"holds in shared memory")
    if not (R and P):
        return
    index = parts.get_device()
    args = ((code, scode, parts.data_ptr(), scale.data_ptr(),
             out.data_ptr()) + ((P,) if entry == "rmsnorm_reduce" else ())
            + (R, d, float(eps), int(gemma_style), vpt, threads,
               cuda.stream_handle(index)))
    fn = getattr(cuda.library(), "repro_" + entry)
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    cuda.check(err, entry)
    cuda.LAUNCHES[entry] += 1
    cuda.RMSNORM_BODIES[body] += 1


def rmsnorm_2d(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
               gemma_style: bool = False) -> torch.Tensor:
    """x [R, d], scale [d] -> [R, d] in x's dtype."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps, gemma_style=gemma_style)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_2d: unsupported device {x.device}")
    R, d = x.shape
    out = torch.empty_like(x)
    _launch("rmsnorm", x, scale, out, 1, R, d, eps, gemma_style)
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
    out = parts.new_empty((R, d))
    _launch("rmsnorm_reduce", parts, scale, out, P, R, d, eps, gemma_style)
    return out
