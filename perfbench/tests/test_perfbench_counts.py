"""The counts the MFU and the rooflines divide, against values worked
by hand and against the port's dry-run."""
import math

import pytest
import torch

from perfbench import harness, layout
from perfbench.roofline import counts, peaks
from perfbench.tests import smoke


def test_causal_pairs():
    assert counts.causal_pairs(1) == 1 and counts.causal_pairs(4) == 10
    assert counts.causal_pairs(2048) == 2_098_176


def test_smollm_train_flops_by_hand():
    cfg = harness.config("smollm-360m")
    d, f, V, L, H, K, D = 960, 2560, 49152, 32, 15, 5, 64
    per_layer = d * H * D * 2 + d * K * D * 2 + 3 * d * f
    params = L * per_layer + V * d            # the tied head, once
    attn = 12 * L * H * D * (2048 * 2049 // 2)
    want = 6 * params * 8 * 2048 + 8 * attn
    assert counts.train_flops(cfg, 8, 2048) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(4.175e13, rel=1e-3)


def test_jamba_prefill_flops_by_hand():
    cfg = harness.config("jamba2-mini")
    d, f, V, E, k = 4096, 14336, 65536, 16, 2
    Di, S, R = 8192, 16, 256
    mamba = d * 2 * Di + Di * (R + 2 * S) + R * Di + Di * d
    attn = d * 4096 * 2 + d * 1024 * 2
    mlp = 3 * d * f
    moe = d * E + k * 3 * d * f
    per_token = 14 * mamba + 2 * attn + 8 * mlp + 8 * moe
    T = 8192
    want = 2 * per_token * T + 4 * 2 * 32 * 128 * (T * (T + 1) // 2) \
        + 2 * d * V
    assert counts.prefill_flops(cfg, T) == pytest.approx(want, rel=1e-12)


def test_flash_and_scan_bounds_by_hand():
    # the train step's call: q/out [8, 2048, 15, 64], k/v 5 heads, bf16
    ops = 4 * 64 * 15 * 8 * 2_098_176
    assert counts.flash_bound_s(8, 2048, 15, 5, 64) == pytest.approx(
        ops / peaks.BF16_FLOPS)
    assert counts.flash_bound_s(8, 2048, 15, 5, 64) * 1e3 == pytest.approx(
        0.0651, abs=1e-4)
    # a jamba2-mini layer's scan at 8192 tokens: bound by its exps
    upd = 8192 * 8192 * 16
    t_exp = upd / (132 * 16 * 1.98e9)
    assert counts.scan_bound_s(1, 8192, 8192, 16) == pytest.approx(t_exp)
    nbytes = 2 * 2 * 8192 * 8192 + 2 * 2 * 8192 * 16 + 4 * 8192 * 16 \
        + 4 * 8192 + 4 * 8192 * 8192
    assert nbytes / peaks.HBM_BYTES < t_exp


def test_train_count_against_the_dry_run_less_its_recompute():
    """The dry-run counts every FLOP the step runs on ``meta``
    (FlopCounterMode): with remat off nothing is recomputed, and the
    plain core scores every (query, key) pair, so the benchmark's count
    with full pairs in place of causal ones must equal it."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshLayout
    from perfbench import program
    cfg = smoke.small_config("smollm-360m")
    mcfg = program.port_config(cfg)
    B, S = 2, 32
    ins = {"tokens": torch.zeros((B, S), dtype=torch.int32, device="meta"),
           "labels": torch.zeros((B, S), dtype=torch.int32, device="meta")}
    res = dryrun.analyse_cell(mcfg, "train", ins, MeshLayout((1, 1),
                              ("data", "model")),
                              train_overrides={"remat": False})
    z = layout.dims(cfg)
    full = counts.train_flops(cfg, B, S) + B * 12 * z["L"] * z["H"] * z[
        "D"] * (S * S - counts.causal_pairs(S))
    assert res["flops_per_device"] == pytest.approx(full, rel=0.01)


def test_mfu_reader_by_hand():
    cfg = harness.config("smollm-360m")
    wl = harness.workload("smollm-360m.train")
    run = harness.Run(cell="smollm-360m.train", cfg=cfg, wl=wl, chips=1,
                      window_s=10.0, steps=4)
    run.trace = harness.Trace([("k", 0.0, 1.0)], [], 10.0)
    mfu = harness.load_file(harness.BENCH / "metrics" / "train_mfu.py")
    want = 100 * 4 * counts.train_flops(cfg, 8, 2048) / (10 * 989.4e12)
    assert mfu.read(run) == pytest.approx(want)
    assert math.isclose(want, 1.688, rel_tol=1e-3)
