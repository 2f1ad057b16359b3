"""Weights drawn from the seed, on the device, group by group.

Each group of ``layout.groups`` is drawn from a ``torch.Generator`` of
its own, seeded from (seed, group index), in at most two calls: one
normal fill of a flat buffer for the group's bf16 leaves and one for its
f32 leaves.  The leaves are views of those buffers, scaled in place.  So
one group can be drawn again alone, bit for bit, which lets the plain
reference rebuild the weights layer by layer once the program's copy is
freed.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import layout

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def group_seed(seed: int, index: int) -> int:
    """A 63-bit seed for group ``index`` of the run seeded ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), 0x57, index])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def draw_group(leaves, seed: int, index: int, device) -> dict:
    """The leaves of one group as tensors on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(group_seed(seed, index))
    out = {}
    for dt in ("bfloat16", "float32"):
        mine = [lf for lf in leaves if lf.dtype == dt]
        n = sum(math.prod(lf.shape) for lf in mine)
        if not n:
            continue
        flat = torch.randn(n, generator=g, device=device, dtype=_DTYPES[dt])
        off = 0
        for lf in mine:
            size = math.prod(lf.shape)
            t = flat[off: off + size].view(lf.shape)
            off += size
            _finish(t, lf)
            out[lf.name] = t
    return out


@torch.no_grad()
def _finish(t, lf) -> None:
    if lf.init == "normal":
        t.mul_(lf.std)
    elif lf.init == "norm":
        t.mul_(0.05).add_(1.0)
    elif lf.init == "ones":
        t.fill_(1.0)
    elif lf.init == "a_log":
        S = t.shape[-1]
        t.copy_(torch.log(torch.arange(1, S + 1, dtype=torch.float32,
                                       device=t.device)).expand_as(t))
    elif lf.init == "dt_bias":
        lo, hi = math.log(1e-3), math.log(1e-1)
        step = torch.exp(lo + (hi - lo) * torch.sigmoid(1.7 * t))
        t.copy_(torch.log(torch.expm1(step)))
    else:
        raise ValueError(f"unknown init {lf.init!r} of {lf.name}")


def make(cfg: dict, seed: int, device) -> dict:
    """Every weight of the configuration (name -> tensor)."""
    out = {}
    for i, (_, leaves) in enumerate(layout.groups(cfg)):
        out.update(draw_group(leaves, seed, i, device))
    return out


def make_group(cfg: dict, seed: int, name: str, device) -> dict:
    """The weights of the one group called ``name`` (``top`` or
    ``layers.{i}``), the same bits as ``make`` gives them."""
    for i, (gname, leaves) in enumerate(layout.groups(cfg)):
        if gname == name:
            return draw_group(leaves, seed, i, device)
    raise KeyError(name)
