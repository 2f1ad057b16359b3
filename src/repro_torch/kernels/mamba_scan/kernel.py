"""The selective-scan kernel (``csrc/mamba_scan.cu``) and its plain
version.

``selective_scan_bdt`` runs the Mamba-1 recurrence from a zero state:
``h = exp(dt_t A) h + (dt_t x_t) (x) B_t``, ``y_t = h . C_t + D x_t``,
in f32, each channel's [S] state held in the registers of ``lanes``
threads.  xc and dt are each read in their own dtype, f32 or bf16, B and
C in xc's, all through their ``[B, T, .]`` strides; A and D are f32 (on
the CPU too; anything else raises ``TypeError``); y comes back in f32.
Any T >= 1 runs; S is one of ``STATE_SIZES``.

The wrapper takes the plain PyTorch version only for a CPU tensor; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch import cuda
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

STATE_SIZES = (4, 8, 16)       # the kernel's instantiations
FILL_THREADS = 1 << 16         # threads that hide a step's latency


def lanes(B: int, Di: int, S: int) -> int:
    """Threads per channel (1, 2 or 4, at most S): the fewest that give
    about FILL_THREADS threads in all (4 at B 1 and Di 16384)."""
    n = 1
    while n < min(4, S) and B * Di * n * 2 <= FILL_THREADS:
        n *= 2
    return n


def selective_scan_plain(xc, dt, Bc, Cc, A, D):
    """Plain version of the kernel: the reference math on the inputs
    widened to f32 first, as the kernel (and the reference's Pallas
    kernel) widens them, so dt * x is an f32 product; y only.  (The
    oracle ``selective_scan_ref`` takes dt * x in the inputs' dtype, a
    bf16 product when both are bf16, as the reference's oracle does.)"""
    return selective_scan_ref(xc.float(), dt.float(), Bc.float(),
                              Cc.float(), A, D)[0]


def _check(xc, dt, Bc, Cc, A, D) -> None:
    if xc.ndim != 3:
        raise ValueError(f"mamba_scan: xc must be [B, T, Di], got "
                         f"{tuple(xc.shape)}")
    B_, T, Di = xc.shape
    if dt.shape != xc.shape:
        raise ValueError(f"mamba_scan: dt {tuple(dt.shape)} != xc "
                         f"{tuple(xc.shape)}")
    if Bc.ndim != 3 or Bc.shape[:2] != (B_, T) or Cc.shape != Bc.shape:
        raise ValueError(f"mamba_scan: B {tuple(Bc.shape)} and C "
                         f"{tuple(Cc.shape)} must be [B, T, S] with "
                         f"[B, T] = {[B_, T]}")
    S = Bc.shape[-1]
    if tuple(A.shape) != (Di, S) or tuple(D.shape) != (Di,):
        raise ValueError(f"mamba_scan: A {tuple(A.shape)} / D "
                         f"{tuple(D.shape)} != [Di, S] / [Di] "
                         f"{[Di, S]} / {[Di]}")
    for t in (xc, dt):
        cuda.dtype_code(t.dtype)        # f32 or bf16, else TypeError
    if not Bc.dtype == Cc.dtype == xc.dtype:
        raise TypeError(f"mamba_scan: B and C dtypes ({Bc.dtype}, "
                        f"{Cc.dtype}) differ from xc's {xc.dtype}")
    for name, t in (("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"mamba_scan: {name} dtype {t.dtype}, expected "
                            f"float32")


def selective_scan_bdt(xc: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                       Cc: torch.Tensor, A: torch.Tensor,
                       D: torch.Tensor) -> torch.Tensor:
    """xc, dt [B, T, Di]; Bc, Cc [B, T, S]; A [Di, S]; D [Di] -> y
    [B, T, Di] float32."""
    _check(xc, dt, Bc, Cc, A, D)
    if xc.device.type == "cpu":
        return selective_scan_plain(xc, dt, Bc, Cc, A, D)
    if xc.device.type != "cuda":
        raise ValueError(f"mamba_scan: unsupported device {xc.device}")
    if any(t.device != xc.device for t in (dt, Bc, Cc, A, D)):
        raise ValueError("mamba_scan: inputs on different devices")
    B_, T, Di = xc.shape
    S = Bc.shape[-1]
    if S not in STATE_SIZES:
        raise ValueError(f"mamba_scan: state size {S} not in {STATE_SIZES}")
    if B_ > 65535:
        raise ValueError(f"mamba_scan: B {B_} exceeds the grid (65535)")
    xc, dt, Bc, Cc = (t if t.stride(-1) == 1 else t.contiguous()
                      for t in (xc, dt, Bc, Cc))
    A, D = A.contiguous(), D.contiguous()
    y = torch.empty((B_, T, Di), dtype=torch.float32, device=xc.device)
    if y.numel() == 0:
        return y
    codes = [cuda.dtype_code(t.dtype) for t in (xc, dt)]
    strides = [s for t in (xc, dt, Bc, Cc) for s in t.stride()[:2]]
    with torch.cuda.device(xc.device):
        err = cuda.library().repro_mamba_scan(
            *codes, *(t.data_ptr() for t in (xc, dt, Bc, Cc, A, D)),
            y.data_ptr(), *strides, B_, T, Di, S, lanes(B_, Di, S),
            torch.cuda.current_stream(xc.device).cuda_stream)
    cuda.check(err, "mamba_scan")
    cuda.LAUNCHES["mamba_scan"] += 1
    return y
