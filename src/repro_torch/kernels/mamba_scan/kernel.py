"""The selective-scan kernel (``csrc/mamba_scan.cu``) and its plain
version.

``selective_scan_bdt`` runs the Mamba-1 recurrence from a zero state:
``h = exp(dt_t A) h + (dt_t x_t) (x) B_t``, ``y_t = h . C_t + D x_t``,
in f32: one channel per lane, the S states of 32 channels split over W
warps, tiles of KT steps staged in a shared-memory ring by a producer
warp, y summed once per tile by an epilogue warp (``scan_plan`` picks
W, the 32-channel groups per CTA and KT; the library, from its own
layout, the stages of the ring).  xc and dt are
each read in their own dtype, f32 or bf16, B and C in xc's, all
through their ``[B, T, .]`` strides; A and D are f32 (on the CPU too;
anything else raises ``TypeError``); y comes back in f32.  Any T >= 1
runs; S is one of ``STATE_SIZES``.

The wrapper takes the plain PyTorch version only for a CPU tensor; on a
CUDA tensor it launches the kernel or raises.  ``tiles.py`` holds the
CPU twin of the kernel's tiling and order of adds.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch import cuda
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

STATE_SIZES = (4, 8, 16)       # the kernel's instantiations
STATES_PER_THREAD = 4          # W = S / 4 state-warps per 32 lanes
H100_SMS = 132                 # scan_plan's SMs where no card is asked
TMA_ALIGN = 16                 # bytes: TMA boxes need this of base, strides


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """One launch's tiling: ``warps`` (W) state-warps per 32 channels,
    ``groups`` (C) groups of 32 channels per CTA, ``steps`` (KT) steps
    a tile."""
    warps: int
    groups: int
    steps: int = 32


# the last launch's plan, stages, CTAs per SM and loads (TMA boxes or
# plain loads, per input)
LAST_LAUNCH: dict = {}


def scan_plan(B: int, Di: int, S: int, sms: int = H100_SMS) -> ScanPlan:
    """W = S / 4 (four states a thread); two groups of 32 channels a CTA
    where that still gives each of ``sms`` SMs a CTA, else one; 32 steps
    a tile."""
    groups = 2 if B * -(-Di // 64) >= sms else 1
    return ScanPlan(S // STATES_PER_THREAD, groups)


@functools.lru_cache(maxsize=None)
def ring_fit(index: int, x_dtype: torch.dtype, dt_dtype: torch.dtype,
             S: int, plan: ScanPlan) -> tuple[int, int]:
    """(stages, CTAs per SM) of ``plan``'s kernel on card ``index``: the
    most stages, of 4, 3 and 2, that keep the CTAs per SM that 2 give
    (the library's ``repro_mamba_scan_fit``)."""
    stages, ctas = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        cuda.check(cuda.library().repro_mamba_scan_fit(
            cuda.dtype_code(x_dtype), cuda.dtype_code(dt_dtype), S,
            plan.warps, plan.groups, plan.steps, ctypes.addressof(stages),
            ctypes.addressof(ctas)), "mamba_scan fit")
    return stages.value, ctas.value


def tma_ok(t: torch.Tensor) -> bool:
    """Whether the kernel may read ``t`` ([B, T, Di], last dim contiguous)
    with TMA boxes: a 16-byte-aligned base, (b, t) strides that are
    whole 16-byte multiples and do not overlap rows."""
    B_, T, Di = t.shape
    e = t.element_size()
    sb, st = t.stride()[:2]
    if t.data_ptr() % TMA_ALIGN or (st * e) % TMA_ALIGN or st < Di:
        return False
    return B_ == 1 or ((sb * e) % TMA_ALIGN == 0 and sb >= st * T)


def selective_scan_plain(xc, dt, Bc, Cc, A, D):
    """Plain version of the kernel: the reference math on the inputs
    widened to f32 first, as the kernel (and the reference's Pallas
    kernel) widens them, so dt * x is an f32 product; y only.  (The
    oracle ``selective_scan_ref`` takes dt * x in the inputs' dtype, a
    bf16 product when both are bf16, as the reference's oracle does.)"""
    return selective_scan_ref(xc.float(), dt.float(), Bc.float(),
                              Cc.float(), A, D)[0]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
                       Cc: torch.Tensor, A: torch.Tensor, D: torch.Tensor
                       ) -> torch.Tensor:
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
    index = xc.get_device()
    plan = scan_plan(B_, Di, S, _sms(index))
    stages, ctas = ring_fit(index, xc.dtype, dt.dtype, S, plan)
    xc, dt, Bc, Cc = (t if t.stride(-1) == 1 else t.contiguous()
                      for t in (xc, dt, Bc, Cc))
    A, D = A.contiguous(), D.contiguous()
    y = torch.empty((B_, T, Di), dtype=torch.float32, device=xc.device)
    if y.numel() == 0:
        return y
    codes = [cuda.dtype_code(t.dtype) for t in (xc, dt)]
    strides = [s for t in (xc, dt, Bc, Cc) for s in t.stride()[:2]]
    tma = int(tma_ok(xc)) | int(tma_ok(dt)) << 1
    args = (*codes, *(t.data_ptr() for t in (xc, dt, Bc, Cc, A, D)),
            y.data_ptr(), *strides, B_, T, Di, S, plan.warps, plan.groups,
            plan.steps, stages, tma, cuda.stream_handle(index))
    if index == torch.cuda.current_device():
        err = cuda.library().repro_mamba_scan(*args)
    else:
        with torch.cuda.device(index):
            err = cuda.library().repro_mamba_scan(*args)
    cuda.check(err, "mamba_scan")
    cuda.LAUNCHES["mamba_scan"] += 1
    LAST_LAUNCH.update(plan=plan, stages=stages, ctas_per_sm=ctas, loads={
        "xc": "tma" if tma & 1 else "plain",
        "dt": "tma" if tma & 2 else "plain"})
    return y
