"""The port's train step (``repro_torch.train.step``) and its model hooks
(``lm_loss``, ``remat``, ``moe_dispatch``, ``moe.aux_loss``) against the
JAX package's, on one device, starting both from one state
(``convert.train_state_from_jax``).

Tolerances:

- ``lm_loss`` in float32: ``rtol 1e-5`` (reduction order only);
- remat against no remat: float32 bitwise (the recompute is the same
  computation); bfloat16 rel-L2 2e-2, the reference's bound
  (tests/test_train_step.py:52);
- one fsdp step in float32: loss and ``grad_norm`` ``rtol 1e-5``, ``lr``
  ``rtol 3e-7`` (one ulp of ``cos``), every updated parameter within
  ``1e-5 + 1e-5 |p|`` of the reference's (1% of the step's lr of 1e-3:
  AdamW divides by ``sqrt(nu)``, so where a gradient is tiny a
  reduction-order difference moves the normalized step by a share of
  lr), every moment within rel-L2 1e-4 per leaf (the gradients differ
  in reduction order, and ``nu``'s squares double the relative error);
- the same step in bfloat16: rel-L2 2e-2 per leaf (parameters, ``mu``;
  ``nu``, of squares, 4e-2) and ``rtol 2e-2`` for loss and
  ``grad_norm``;
- dense against dropless MoE (no drops): ``atol 2e-2, rtol 1e-2``, the
  reference's (tests/test_train_step.py:56);
- moonshot's dropless step against the reference's, float32: loss and
  ``grad_norm`` ``rtol 1e-4``, moments as the fsdp step, parameters
  within ``5e-5 + 1e-5 |p|`` (5% of lr: the routed experts' gradients
  are sums over fewer tokens, so more of them are tiny);
- ``aux_loss``: ``rtol 1e-6``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import compat
from repro import configs as jconfigs
from repro.data import DataPipeline as JPipe, PipelineConfig as JCfg
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.train.step import (TrainOptions as JOpts,
                              init_train_state as jinit,
                              make_train_step as jmake)

from repro_torch import configs
from repro_torch.convert import (params_from_jax, tensor_from_numpy,
                                 train_state_from_jax)
from repro_torch.data import DataPipeline, PipelineConfig
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.train.step import (TrainOptions, init_train_state,
                                    make_train_step)

STEP_KW = dict(remat=False, peak_lr=1e-3, warmup_steps=1, total_steps=100)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f32_tree(t):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, t)


def _np(t):
    return jax.tree.map(np.asarray, t)


def _batch(vocab, B=4, S=16, seed=3):
    jb = JPipe(JCfg(vocab_size=vocab, seq_len=S, global_batch=B,
                    seed=seed)).batch(0)
    return jb, {k: tensor_from_numpy(np.asarray(v)) for k, v in jb.items()}


def _rel(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)


def _f32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-14b"])
def test_lm_loss_against_reference(arch):
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = _f32_tree(JM.init_params(jax.random.key(0), jcfg))
    model = M.from_state(cfg, params_from_jax(_np(jp)))
    jb, tb = _batch(cfg.vocab_size)
    labels = tb["labels"].clone()
    labels[0, :5] = -100                  # uneven masking across rows
    jl = jnp.asarray(labels.numpy())
    want = float(JM.lm_loss(jp, jcfg, jb["tokens"], jl))
    ws, wc = JM.lm_loss(jp, jcfg, jb["tokens"], jl, reduction="sum_count")
    with torch.no_grad():
        got = M.lm_loss(model, cfg, tb["tokens"], labels)
        gs, gc = M.lm_loss(model, cfg, tb["tokens"], labels,
                           reduction="sum_count")
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    np.testing.assert_allclose(float(gs), float(ws), rtol=1e-5)
    assert int(gc) == int(wc) == int((labels >= 0).sum())


def _grads(model, cfg, tokens, labels, **kw):
    params = [p for p in model.parameters()]
    loss = M.lm_loss(model, cfg, tokens, labels, **kw)
    return torch.autograd.grad(loss, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_matches_no_remat(dtype):
    cfg = configs.get_smoke("qwen3-14b")
    model = M.init_params(cfg, generator=torch.Generator().manual_seed(0))
    if dtype == "float32":
        model = model.float()
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    labels = torch.roll(toks, -1, 1)
    a = _grads(model, cfg, toks, labels)
    b = _grads(model, cfg, toks, labels, remat=True)
    if dtype == "float32":
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    else:
        fa = torch.cat([x.float().ravel() for x in a])
        fb = torch.cat([x.float().ravel() for x in b])
        assert float((fa - fb).norm() / fa.norm()) < 2e-2


def _check_state(got, want, dtype, p_atol=1e-5):
    want = train_state_from_jax(_np(want))
    for k in want["params"]:
        a, b = _f32(got["params"][k]), _f32(want["params"][k])
        assert got["params"][k].dtype == want["params"][k].dtype
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=p_atol,
                                       err_msg=k)
        else:
            assert _rel(a, b) < 2e-2, k
        for part in ("mu", "nu"):
            a, b = _f32(got["opt"][part][k]), _f32(want["opt"][part][k])
            tol = 1e-4 if dtype == "float32" else (
                2e-2 if part == "mu" else 4e-2)
            assert _rel(a, b) < tol, (part, k, _rel(a, b))
    assert int(got["opt"]["count"]) == int(want["opt"]["count"])
    assert int(got["step"]) == int(want["step"])


def _one_step(arch, dtype, step0=3, **kw):
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    okw = dict(STEP_KW, **kw)
    st = jinit(jax.random.key(0), jcfg, JOpts(**okw))
    st["step"] = jnp.int32(step0)           # past the warmup: lr > 0
    if dtype == "float32":
        st = _f32_tree(st)
    jb, tb = _batch(cfg.vocab_size)
    mesh1 = compat.make_mesh((1, 1), ("data", "model"))
    jnew, jm = jax.jit(jmake(jcfg, mesh1, JOpts(**okw)))(st, jb)
    tstate = train_state_from_jax(_np(st))
    before = {k: v.clone() for k, v in tstate["params"].items()}
    tnew, tm = make_train_step(cfg, None, TrainOptions(**okw))(tstate, tb)
    for k, v in before.items():           # the input state is untouched
        assert torch.equal(tstate["params"][k], v)
    return jnew, jm, tnew, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fsdp_step_against_reference(dtype):
    jnew, jm, tnew, tm = _one_step("smollm-360m", dtype)
    rt = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=rt)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=rt)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=3e-7)
    _check_state(tnew, jnew, dtype)


def test_moonshot_dropless_step_against_reference():
    jnew, jm, tnew, tm = _one_step("moonshot-v1-16b-a3b", "float32",
                                   moe_mode="dropless")
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    _check_state(tnew, jnew, "float32", p_atol=5e-5)


def test_loss_decreases_smollm():
    """The reference's rule (tests/test_train_step.py:21) on the port's
    own init, data and step."""
    cfg = configs.get_smoke("smollm-360m")
    opts = TrainOptions(dp_mode="fsdp", remat=False, peak_lr=3e-3,
                        warmup_steps=2, total_steps=40)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, opts)
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                       seq_len=32, global_batch=4))
    step = make_train_step(cfg, None, opts)
    losses = []
    for i in range(12):
        state, m = step(state, pipe.batch(i))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.2, losses
    assert int(state["step"]) == 12 and int(state["opt"]["count"]) == 12


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "jamba-1.5-large-398b"])
def test_moe_dense_vs_dropless(arch):
    cfg = configs.get_smoke(arch)
    mcfg = cfg.moe
    p = moe.init(mcfg, cfg.d_model, generator=torch.Generator().manual_seed(0))
    p = p.float()
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.3
    with torch.no_grad():
        dense = moe.forward(p, mcfg, x, cfg.mlp_act)
        dropless = moe.forward_dropless(p, mcfg, x, cfg.mlp_act,
                                        capacity_factor=float(
                                            mcfg.n_experts))
    np.testing.assert_allclose(dense.numpy(), dropless.numpy(), atol=2e-2,
                               rtol=1e-2)


def test_moe_train_step_runs():
    cfg = configs.get_smoke("moonshot-v1-16b-a3b")
    opts = TrainOptions(dp_mode="fsdp", moe_mode="dropless", remat=True,
                        total_steps=10)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, opts)
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                       seq_len=16, global_batch=2))
    state, m = make_train_step(cfg, None, opts)(state, pipe.batch(0))
    assert np.isfinite(float(m["loss"]))
    assert int(state["step"]) == 1


def test_aux_loss_against_reference():
    jcfg = jconfigs.get_smoke("moonshot-v1-16b-a3b").moe
    cfg = configs.get_smoke("moonshot-v1-16b-a3b").moe
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((40, cfg.n_experts)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, -1)[:, :cfg.top_k].astype(np.int32)
    want = float(jmoe.aux_loss(jcfg, jnp.asarray(probs), jnp.asarray(idx)))
    got = moe.aux_loss(cfg, torch.from_numpy(probs),
                       torch.from_numpy(idx).long())
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert np.isfinite(want) and want > 0
