"""Assigned input shapes and (arch x shape) cell applicability."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: only the SSM and the hybrid
# run it; the 8 pure-full-attention archs skip (see DESIGN.md §5).
LONG_OK = {"rwkv6-3b", "jamba-1.5-large-398b"}


def runnable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_OK
    return True


def cells():
    """All 40 assigned cells with a runnable flag."""
    from repro_torch.configs import ARCHS
    return [(a, s, runnable(a, s)) for a in ARCHS for s in SHAPES]
