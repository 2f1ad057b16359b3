"""Operations and bytes of the work a cell asks for, from the
configuration and the shapes its traffic gives: the numerators of the
MFU and the rooflines.  Whatever implements the work, these counts stay.

Model FLOPs count each matrix product once (2 per multiply-add) and
attention's causal score and value products over the live (query, key)
pairs; no recompute, no padding, no work a dispatch spends on tokens an
expert does not take.  The kernel bounds follow ``chip_smoke.py``:
each input byte read once and each output byte written once, the larger
of bytes over the memory's rate and operations over the units' rate.
"""
from __future__ import annotations

import math

from perfbench import layout
from perfbench.roofline import peaks


def causal_pairs(S: int) -> int:
    """Live (query, key) pairs of a causal sequence of S."""
    return S * (S + 1) // 2


def _matmul_params(cfg: dict) -> dict:
    """Parameters that multiply a token, by part: ``layers`` (each
    layer's projections; MoE counts its ``top_k`` routed experts and its
    router), ``experts_all`` (every expert, for the dense dispatch),
    ``head`` and ``embed``."""
    z = layout.dims(cfg)
    n, dense_moe = 0, 0
    for _, leaves in layout.groups(cfg)[1:]:
        for lf in leaves:
            if len(lf.shape) < 2 or lf.name.endswith(("conv_w", "A_log")):
                continue
            size = math.prod(lf.shape)
            if ".moe.w_" in lf.name:
                dense_moe += size
                size = size * z["top_k"] // z["E"]
            n += size
    return {"layers": n, "experts_all": dense_moe,
            "head": z["d"] * z["V"], "embed": z["d"] * z["V"]}


def attention_layers(cfg: dict) -> int:
    return sum(m == "attn" for m, _ in layout.layer_kinds(cfg))


def train_flops(cfg: dict, rows: int, S: int) -> float:
    """Model FLOPs of one training step over ``rows`` sequences of S:
    6 x the parameters a token (the tied embedding counted once, as the
    head) x tokens, plus 12 x the causal pairs x heads x head dim of
    every attention layer (score and value products, forward and
    backward)."""
    z = layout.dims(cfg)
    p = _matmul_params(cfg)
    per_token = p["layers"] + p["head"]
    attn = 12 * attention_layers(cfg) * z["H"] * z["D"] * causal_pairs(S)
    return 6.0 * per_token * rows * S + float(attn) * rows


def prefill_flops(cfg: dict, S: int) -> float:
    """Model FLOPs of one prompt of S tokens: 2 x the active parameters a
    token (``top_k`` routed experts, not the dense dispatch's all) x S,
    the causal attention products (4 x pairs x heads x head dim a
    layer), and the head once, for the first token."""
    z = layout.dims(cfg)
    p = _matmul_params(cfg)
    attn = 4 * attention_layers(cfg) * z["H"] * z["D"] * causal_pairs(S)
    return 2.0 * p["layers"] * S + float(attn) + 2.0 * p["head"]


def flash_bound_s(B: int, S: int, H: int, K: int, D: int,
                  elem: int = 2) -> float:
    """Least time of one causal flash forward call: q and out [B, S, H,
    D], k and v [B, S, K, D] in ``elem``-byte words, 4 D H B pairs
    operations at the bf16 tensor-core rate."""
    ops = 4 * D * H * B * causal_pairs(S)
    nbytes = elem * B * S * D * (2 * H + 2 * K)
    return max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)


def scan_bound_s(B: int, T: int, Di: int, S: int) -> float:
    """Least time of one selective-scan call as the port hands it its
    inputs: xc, dt, B, C in bf16, A [Di, S] and D [Di] in f32, y in f32;
    6 f32 operations and one exp an update (B T Di S updates), the exps
    at 16 a clock an SM at the boost clock."""
    updates = B * T * Di * S
    nbytes = (2 * 2 * B * T * Di + 2 * 2 * B * T * S + 4 * Di * S + 4 * Di
              + 4 * B * T * Di)
    t_exp = updates / (peaks.SMS * peaks.SFU_EXPS_PER_CLOCK_PER_SM
                       * peaks.BOOST_CLOCK_HZ)
    return max(nbytes / peaks.HBM_BYTES, 6 * updates / peaks.F32_FLOPS,
               t_exp)
