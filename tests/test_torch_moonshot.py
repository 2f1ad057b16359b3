"""The port's moonshot-v1-16b-a3b (sigmoid routing with a selection bias,
``route_scale`` and ``norm_topk``; two shared experts; attention blocks)
against the JAX package's.

The layer tests take the reference's seeded ``moe.init`` at the smoke
config's MoE widths, with a random ``router_bias`` (the init's zeros
would hide whether the bias only biases the selection); the model tests
take the reference's seeded ``init_params`` through
``convert.params_from_jax``.  Tolerances: float32 ``atol = rtol = 1e-4``
(the MoE layer ``1e-5``); bfloat16 and decode the model tolerance,
``atol 0.15, rtol 0.05``, against the reference compiled with XLA's
excess precision off (tests/torch_arch_helpers.py).
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import moe as jmoe

from repro_torch import configs
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import MoEConfig
from repro_torch.serve import ServeOptions, make_prefill_step

from torch_arch_helpers import (F32_TOL, MODEL_TOL, decode_vs_reference,
                                f32, pair, strict, tokens)

ARCH = "moonshot-v1-16b-a3b"
MOE_F32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _layer(dtype="float32", held=None):
    """(jax cfg, jax params, port cfg, port layer) of the smoke config's
    MoE at d_model 64, with a random router bias."""
    jcfg = jconfigs.get_smoke(ARCH).moe
    d = jconfigs.get_smoke(ARCH).d_model
    jp = jmoe.init(jax.random.key(3), jcfg, d)
    jp["router_bias"] = jnp.asarray(
        np.random.default_rng(7).normal(size=jcfg.n_experts) * 0.05,
        jnp.float32)
    if dtype == "float32":
        jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    cfg = MoEConfig(**dataclasses.asdict(jcfg), held=held)
    lo, hi = cfg.held_range()
    layer = moe.MoE(cfg, d, device="meta")
    state = {}
    for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        name = ".".join(p.key for p in k)
        a = np.asarray(v)
        state[name] = tensor_from_numpy(
            a[lo:hi] if name in ("w_gate", "w_up", "w_down") else a)
    layer.load_state_dict(state, assign=True)
    return jcfg, jp, cfg, layer.requires_grad_(False)


def _x(shape, dtype, seed):
    a = np.random.default_rng(seed).normal(size=shape + (64,))
    return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                    else np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_sigmoid_vs_reference(dtype):
    """Top-k on scores + bias, weights from the unbiased scores,
    normalized and scaled; the router product and sigmoid in f32 for
    bf16 inputs too (the reference rounds no bf16 sigmoid here)."""
    jcfg, jp, cfg, layer = _layer(dtype)
    x = _x((48,), dtype, 1)
    jw, jidx, jprobs = jmoe.route(jp, jcfg, jnp.asarray(x))
    w, idx, probs = moe.route(layer, cfg, tensor_from_numpy(x))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert probs.dtype == torch.float32 and str(w.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(f32(probs), f32(jprobs), **MOE_F32)
    np.testing.assert_allclose(f32(w), f32(jw), **(
        MOE_F32 if dtype == "float32" else dict(atol=0, rtol=0)))
    # the bias moved the choice: top-k of the unbiased scores differs
    plain = torch.topk(probs, cfg.top_k, dim=-1).indices
    assert not torch.equal(plain.sort(-1).values, idx.sort(-1).values)
    # the weights of each token sum to route_scale
    np.testing.assert_allclose(f32(w).sum(-1), cfg.route_scale,
                               rtol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["forward", "forward_dropless"])
def test_moe_with_shared_experts_vs_reference(path, dtype):
    """Both dispatches with the shared experts; the dense one in chunks
    of 8 rows here, so the chunking is crossed."""
    jcfg, jp, cfg, layer = _layer(dtype)
    x = _x((3, 7), dtype, 2)
    kw = {} if path == "forward" else {"capacity_factor": 1.25}
    ref = strict(lambda p, a: getattr(jmoe, path)(p, jcfg, a, "silu", **kw),
                 jp, jnp.asarray(x))
    want = ref(jp, jnp.asarray(x))
    chunk = moe.DENSE_CHUNK
    try:
        moe.DENSE_CHUNK = 8
        got = getattr(moe, path)(layer, cfg, tensor_from_numpy(x), **kw)
    finally:
        moe.DENSE_CHUNK = chunk
    assert got.shape == (3, 7, 64)
    np.testing.assert_allclose(f32(got), f32(want), **(
        MOE_F32 if dtype == "float32" else MODEL_TOL))


@pytest.mark.parametrize("path,factor", [("forward", None),
                                         ("forward_dropless", 2.0)])
def test_held_shares_count_the_shared_experts_once(path, factor):
    """Experts [0, 4) and [4, 8): each share routes over all 8 and adds
    its own experts' part (the reference with the other experts' w_down
    zeroed); only the share holding expert 0 adds the shared experts,
    so the two add up to the whole layer."""
    jcfg, jp, cfg, whole = _layer()
    x = _x((2, 5), "float32", 4)
    kw = {} if factor is None else {"capacity_factor": factor}
    shared = f32(moe.mlp.forward(whole.shared,
                                 torch.from_numpy(x.reshape(-1, 64))))
    outs = []
    for lo, hi in ((0, 4), (4, 8)):
        hcfg, share = _layer(held=(lo, hi))[2:]
        assert share.shared.w_up.shape == whole.shared.w_up.shape
        got = getattr(moe, path)(share, hcfg, torch.from_numpy(x), **kw)
        down = np.array(jp["w_down"])
        down[:lo] = 0
        down[hi:] = 0
        want = f32(getattr(jmoe, path)(dict(jp, w_down=jnp.asarray(down)),
                                       jcfg, jnp.asarray(x), **kw))
        if lo:
            want = want - shared.reshape(want.shape)
        np.testing.assert_allclose(f32(got), want, **MOE_F32,
                                   err_msg=f"experts [{lo}, {hi})")
        outs.append(got)
    np.testing.assert_allclose(
        f32(outs[0] + outs[1]),
        f32(getattr(moe, path)(whole, cfg, torch.from_numpy(x), **kw)),
        **MOE_F32)


def test_init_draws_bias_zeros_and_shared_width():
    cfg = configs.get_smoke(ARCH).moe
    p = moe.init(cfg, 64, generator=torch.Generator().manual_seed(0))
    p.requires_grad_(False)
    assert p.router_bias.dtype == torch.float32
    assert not p.router_bias.any() and p.router_bias.shape == (8,)
    assert p.shared.w_gate.shape == (64, 48 * 2)
    assert p.shared.w_down.shape == (96, 64)
    assert float(p.shared.w_up.float().std()) == pytest.approx(
        64 ** -0.5, rel=0.1)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward_logits_vs_reference_f32():
    jcfg, jp, cfg, model = pair(ARCH, "float32")
    toks = tokens(cfg, (2, 16), 1)
    for use_kernel in (False, True):
        want = JM.forward(jp, jcfg, jnp.asarray(toks), use_kernel=use_kernel)
        got = make_prefill_step(cfg, ServeOptions(use_kernel=use_kernel))(
            model, torch.from_numpy(toks).long())
        assert got.dtype == torch.float32
        np.testing.assert_allclose(f32(got), f32(want), **F32_TOL,
                                   err_msg=f"use_kernel={use_kernel}")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_vs_reference_bf16(use_kernel):
    jcfg, jp, cfg, model = pair(ARCH, "bfloat16")
    toks = jnp.asarray(tokens(cfg, (2, 16), 1))
    ref = strict(lambda p, t: JM.forward(p, jcfg, t, use_kernel=use_kernel),
                 jp, toks)
    got = make_prefill_step(cfg, ServeOptions(use_kernel=use_kernel))(
        model, torch.from_numpy(np.array(toks)).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(ref(jp, toks)), **MODEL_TOL)


def test_teacher_forced_decode_vs_reference():
    """Batch 2: the smoke config's 8 experts, top-3, give capacity C =
    int(2 * 3 / 8 * 2) = 1 at decode, where both packages drop alike."""
    cache, _ = decode_vs_reference(ARCH)
    assert cache["layers"][0]["attn"]["len"] == 15


def test_launcher_generate_f32_matches_kernel_prefill():
    """With f32 weights, the launcher's teacher-forced decode logits at
    batch 1 (no capacity drop: C = int(3 / 8 * 2) = 1 and one token)
    against the kernel prefill's, at the model tolerance."""
    cfg = configs.get_smoke(ARCH)
    g = torch.Generator().manual_seed(0)
    state = M.init_params(cfg, generator=g).state_dict()
    model = M.from_state(cfg, {k: t.float() for k, t in state.items()})
    prompts = torch.randint(2, cfg.vocab_size, (1, 12), generator=g)
    out, logits = launcher.generate(model, cfg, prompts, 5)
    assert out.shape == (1, 5) and logits.dtype == torch.float32
    pre = make_prefill_step(cfg, ServeOptions(use_kernel=True))(model,
                                                                prompts)
    np.testing.assert_allclose(logits[:, :12].numpy(), pre.numpy(),
                               **MODEL_TOL)


def test_launcher_main_runs_on_cpu(capsys):
    out = launcher.main(["--arch", ARCH, "--smoke", "--batch", "2",
                         "--prompt-len", "4", "--gen", "3", "--device",
                         "cpu"])
    assert out.shape == (2, 3)
    assert "generated (2, 3) on cpu" in capsys.readouterr().out


def test_param_counts_and_state_names():
    """28,051,051,456 parameters in both packages; the reference's tree
    maps onto the port's names with ``router_bias`` f32 and the shared
    experts in bf16."""
    assert configs.get_config(ARCH).param_count() == 28_051_051_456
    assert jconfigs.get_config(ARCH).param_count() == 28_051_051_456
    jp = jax.tree.map(np.asarray, JM.init_params(
        jax.random.key(0), jconfigs.get_smoke(ARCH)))
    state = params_from_jax(jp)
    skeleton = M.Model(configs.get_smoke(ARCH), device="meta").state_dict()
    assert sorted(state) == sorted(skeleton)
    for name, t in state.items():
        assert t.dtype == skeleton[name].dtype, name
    assert state["layers.1.moe.router_bias"].dtype == torch.float32
    assert state["layers.1.moe.shared.w_gate"].shape == (64, 96)
    assert "layers.0.moe.router" not in state           # layer 0 is dense
