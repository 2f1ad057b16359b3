"""The wkv6 kernel (``csrc/wkv6.cu``) and its plain version.

``wkv6_bthn`` takes the model's ``[B, T, H, N]`` layout directly (the
kernel reads r, k, v and w through their strides, so there is no
transpose to ``[B*H, T, N]``) and runs the RWKV-6 recurrence from a zero
state: ``y_t = r_t . (S + u (x) k_t v_t^T)``, then ``S = diag(w_t) S +
k_t v_t^T``, in f32, the [N, N] state held in registers.  r/k/v (one
dtype), w and u are each read in their own dtype, f32 or bf16 (on the CPU
too; anything else raises ``TypeError``); y comes back in f32.  Any
T >= 1 runs; N is one of ``HEAD_DIMS``.

On the card one call is a chunk-parallel scan (``csrc/wkv6.cu``): T is
cut into chunks of ``wkv6_chunk`` steps; each chunk's local state and
decay product are computed from zero (phase 1), carried over the chunks
in order (phase 2), and each chunk reruns its steps from its carried-in
state to write y (phase 3).  ``wkv6_chunked_plain`` is the same three
phases in PyTorch.

The wrapper takes the plain PyTorch version only for a CPU tensor; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch import cuda
from repro_torch.kernels.wkv6.ref import wkv6_ref

HEAD_DIMS = (8, 16, 32, 64, 128)       # the kernel's instantiations
CARRY_THREADS = 256                    # phase 2 (kCarryThreads)
CHUNKS = (64, 128, 256)                # the chunk lengths wkv6_chunk picks
# phase 3's CTAs resident on an H100: 132 SMs x 6 (64 threads at 161
# registers, head size 64)
FILL_CTAS = 132 * 6

# what the last kernel call ran: chunk length, chunks, each phase's grid
# (None when it did not run) and the scratch bytes
LAST_LAUNCH: dict = {}


def wkv6_plain(r, k, v, w, u):
    """Plain version of the kernel (the reference math): y only."""
    return wkv6_ref(r, k, v, w, u)[0]


def wkv6_chunked_plain(r, k, v, w, u, chunk: int) -> torch.Tensor:
    """Plain version of the kernel's chunk-parallel scan, in its order of
    operations: (1) every chunk but the last from a zero state, walked
    from its last step back as ``S_loc += (k_t P_t) v_t^T`` with P_t the
    product of the later steps' decays, keeping S_loc and the chunk's
    decay product D;
    (2) the carry over chunks, ``S_in(c + 1) = D(c) S_in(c) + S_loc(c)``;
    (3) every chunk's steps again from ``S_in(c)``, writing
    ``y_t = r_t . S + v_t (r_t . (u * k_t))``.  Equal to ``wkv6_plain``
    up to rounding; y only."""
    B, T, H, N = r.shape
    C = int(chunk)
    NC = -(-T // C)
    pad = NC * C - T
    r, k, v, w = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
                  .reshape(B, NC, C, H, N) for t in (r, k, v, w))
    # (1) local states and decay products of chunks 0 .. NC - 2, from the
    # last step back: S_loc = sum_t (k_t P_t) v_t^T, P_t the product of
    # the later steps' decays, D the product of all
    s_loc = r.new_zeros((B, NC - 1, H, N, N))
    dec = r.new_ones((B, NC - 1, H, N))
    for t in reversed(range(C)):
        kp = k[:, :-1, t] * dec
        s_loc = s_loc + kp[..., :, None] * v[:, :-1, t, :, None, :]
        dec = dec * w[:, :-1, t]
    # (2) the carry, in chunk order
    s_in = [r.new_zeros((B, H, N, N))]
    for c in range(NC - 1):
        s_in.append(dec[:, c, :, :, None] * s_in[-1] + s_loc[:, c])
    s = torch.stack(s_in, 1)                               # [B, NC, H, N, N]
    # (3) every chunk from its carried-in state; the bonus term as the
    # kernel takes it, v_t times the row sum of r_t u k_t
    uf = u.float()
    y = r.new_empty((B, NC, C, H, N))
    for t in range(C):
        rt, kt, vt = r[:, :, t], k[:, :, t], v[:, :, t]
        ruk = (rt * uf * kt).sum(-1, keepdim=True)
        y[:, :, t] = torch.einsum("bchn,bchnm->bchm", rt, s) + vt * ruk
        s = w[:, :, t, :, :, None] * s + kt[..., :, None] * vt[..., None, :]
    return y.reshape(B, NC * C, H, N)[:, :T]


CTA_THREADS = 64                       # phases 1 and 3 (csrc kThreads)
# csrc Shape<N>: threads sharing a column group, columns in a group
SHAPES = {8: (8, 1), 16: (4, 1), 32: (2, 1), 64: (4, 4), 128: (8, 4)}


def column_groups(N: int) -> int:
    """CTAs a head's columns take in phases 1 and 3 (csrc Tiling<N>)."""
    split, cpt = SHAPES[N]
    return N // (CTA_THREADS // split * cpt)


def wkv6_chunk(B: int, T: int, H: int, N: int) -> int:
    """The chunk length the kernel runs: the longest of CHUNKS whose
    phase-3 grid, B H ceil(T / C) column groups, still fills the card
    (FILL_CTAS), else the shortest; T itself when T fits one chunk
    (phase 3 alone, from a zero state).  Longer chunks carry less
    scratch and run fewer phase-1 steps; at rwkv6-3b's layer (B 1,
    T 8192, H 40) C = 256 took 0.4987 ms, 128 0.5136 ms, 64 0.5548 ms
    and 512 (under one wave) 0.5478 ms (``kernel_turns.py``; NVIDIA H100
    80GB HBM3, 700.00 W)."""
    if T <= CHUNKS[0]:
        return T
    per_chunk = B * H * column_groups(N)
    for C in reversed(CHUNKS):
        if -(-T // C) * per_chunk >= FILL_CTAS:
            return C
    return CHUNKS[0]


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
              w: torch.Tensor, u: torch.Tensor, *,
              chunk: int | None = None) -> torch.Tensor:
    """r, k, v, w [B, T, H, N]; u [H, N] -> y [B, T, H, N] float32.
    ``chunk`` overrides ``wkv6_chunk``'s length on the card."""
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
    C = wkv6_chunk(B, T, H, N) if chunk is None else int(chunk)
    if C < 1:
        raise ValueError(f"wkv6: chunk {C} < 1")
    NC = -(-T // C)
    # phase 1's local states, carried in place by phase 2; decay products
    states = torch.empty((B, H, NC - 1, N, N) if NC > 1 else (0,),
                         dtype=torch.float32, device=r.device)
    dec = torch.empty((B, H, NC - 1, N) if NC > 1 else (0,),
                      dtype=torch.float32, device=r.device)
    ins = (r, k, v, w, u)
    codes = [cuda.dtype_code(t.dtype) for t in (r, w, u)]
    strides = [s for t in ins[:4] for s in t.stride()[:3]]
    with torch.cuda.device(r.device):
        err = cuda.library().repro_wkv6(
            *codes, *(t.data_ptr() for t in ins), y.data_ptr(),
            states.data_ptr() if NC > 1 else None,
            dec.data_ptr() if NC > 1 else None, *strides, B, T, H, N, C,
            torch.cuda.current_stream(r.device).cuda_stream)
    cuda.check(err, "wkv6")
    cuda.LAUNCHES["wkv6"] += 1
    G = column_groups(N)
    items = B * H * N * N
    LAST_LAUNCH.update(
        chunk=C, chunks=NC,
        grids={"state": (G * (NC - 1), H, B) if NC > 1 else None,
               "carry": (-(-items // CARRY_THREADS),) if NC > 2 else None,
               "out": (G * NC, H, B)},
        scratch_bytes=states.numel() * 4 + dec.numel() * 4)
    return y
