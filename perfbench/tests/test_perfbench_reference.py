"""The plain reference against the port's plain path at small sizes on
the CPU, in float32: a forward, a train step, a Jamba prefill, and the
explicit-DP step on 4 gloo ranks."""
import dataclasses

import pytest
import torch

from perfbench import layout, program, weights
from perfbench.reference import check, jamba, llama
from perfbench.tests import smoke

SEED = 2 ** 35 + 99


def _f32(cfg):
    return {k: v.float() for k, v in weights.make(cfg, SEED, "cpu").items()}


def _tokens(cfg, B, S, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg["vocab_size"], (B, S), generator=g)


def test_llama_logits_match_the_port():
    from repro_torch.models import model as M
    cfg = smoke.small_config("smollm-360m")
    P = _f32(cfg)
    x = _tokens(cfg, 2, 48)
    mcfg = program.port_config(cfg)
    port = M.forward(M.from_state(mcfg, P), mcfg, x)
    ref = llama.logits(P, layout.dims(cfg), x)
    assert torch.allclose(port, ref, atol=2e-5, rtol=1e-4)


def test_llama_train_steps_match_the_port():
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import TrainOptions, make_train_step
    cfg = smoke.small_config("smollm-360m")
    mcfg = program.port_config(cfg)
    opts = {"peak_lr": 1e-3, "warmup_steps": 0, "total_steps": 100,
            "max_grad_norm": 1.0, "weight_decay": 0.1}
    step = make_train_step(mcfg, None, TrainOptions(
        dp_mode="fsdp", remat=False, use_kernel=False, **opts))
    P = _f32(cfg)
    state = {"params": dict(P), "opt": adamw_init(P),
             "step": torch.zeros((), dtype=torch.int32)}
    batches = [{"tokens": _tokens(cfg, 2, 32, i),
                "labels": _tokens(cfg, 2, 32, 10 + i)} for i in range(3)]
    prog = {"losses": []}
    for i, b in enumerate(batches):
        state, m = step(state, b)
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["grad_norm"] = float(m["grad_norm"])
            prog["grad_norms"] = {k: float(v.norm()) / 0.1 for k, v in
                                  state["opt"]["mu"].items()}
    prog["change_norms"] = {k: float((state["params"][k] - P[k]).norm())
                            for k in P}
    ref = llama.train_steps({k: v.clone() for k, v in P.items()},
                            layout.dims(cfg), batches, opts)
    nums = check.train_numbers(prog, ref)
    assert nums["loss_gap"] < 1e-5 and nums["grad_norm_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-3 and nums["grad_shape_gap"] < 1e-4
    assert nums["change_gap"] < 1e-3


def test_jamba_prefill_matches_the_port():
    from repro_torch.models import model as M
    cfg = smoke.small_config("jamba2-mini")
    mcfg = program.port_config(cfg)
    P = _f32(cfg)
    xs = [_tokens(cfg, 1, n, n)[0] for n in (40, 97)]
    got = {}

    def load(name):
        return {k: v for k, v in P.items()
                if (k.startswith(name + ".") if name != "top"
                    else not k.startswith("layers."))}

    jamba.prefill(load, layout.dims(cfg), layout.layer_kinds(cfg), xs,
                  lambda j, lg: got.__setitem__(j, lg))
    model = M.from_state(mcfg, P)
    for j, x in enumerate(xs):
        port = M.forward(model, mcfg, x[None])[0]
        scale = port.abs().max()
        assert (port - got[j]).abs().max() < 1e-4 * scale


def test_jamba_chunked_scan_is_the_recurrence():
    """The reference's chunked float64 recurrence against the step by
    step one, with decays strong enough to halve chunks."""
    g = torch.Generator().manual_seed(3)
    T, Di, S = 150, 6, 4
    x = torch.randn(T, Di, generator=g)
    dt = torch.rand(T, Di, generator=g) * 3
    Bm, Cm = torch.randn(T, S, generator=g), torch.randn(T, S, generator=g)
    A = -torch.rand(Di, S, generator=g) * 16
    Dv = torch.randn(Di, generator=g)
    h = torch.zeros(Di, S, dtype=torch.float64)
    ys = []
    for t in range(T):
        h = torch.exp(dt[t, :, None].double() * A) * h \
            + (dt[t] * x[t]).double()[:, None] * Bm[t].double()[None]
        ys.append(h @ Cm[t].double() + Dv.double() * x[t].double())
    want = torch.stack(ys).float()
    got = jamba.selective_scan(x, dt, Bm, Cm, A, Dv)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_explicit_dp_step_on_four_gloo_ranks():
    """The 4-rank cell at the small size on gloo: the gradients after
    mpix_allreduce against the reference's mean over the four ranks'
    batches."""
    out = smoke.run_cpu_ranks("smollm-360m.train-dp4", 4)
    n = out["notes"]
    for k, c in out["checks"].items():
        n[k] = c["value"]
    assert n["grad_gap_median"] < 1e-2 and n["loss1_gap"] < 1e-3
