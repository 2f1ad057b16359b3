"""The port's deepseek-v3-671b (multi-head latent attention, its latent
decode cache, sigmoid routing with one shared expert, the one-card cut)
against the JAX package's.

The MLA tests take the reference's seeded ``mla.init`` at the smoke
config's widths (d_model 64, 4 heads, nope 16 + rope 8, v 16, q/kv
ranks 24/16); the model tests take the reference's seeded
``init_params`` through ``convert.params_from_jax``.  Tolerances:
float32 ``atol = rtol = 1e-4``; bfloat16 and decode the model
tolerance, ``atol 0.15, rtol 0.05``, against the reference compiled
with XLA's excess precision off (tests/torch_arch_helpers.py).  The
kernel path (``use_kernel``) runs the flash kernel's plain version
here, held against the reference's Pallas kernel in interpret mode.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import mla as jmla
from repro.models import model as JM

from repro_torch import configs
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.launch import serve as launcher
from repro_torch.models import attention, mla
from repro_torch.models import model as M
from repro_torch.serve import (ServeOptions, init_serve_cache,
                               make_prefill_step)

from torch_arch_helpers import (F32_TOL, MODEL_TOL, decode_vs_reference,
                                f32, normal, pair, strict, tokens)

ARCH = "deepseek-v3-671b"
D_MODEL = 64


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _layer(dtype="float32"):
    """(cfg, jax params, port layer) of the smoke config's MLA."""
    cfg = jconfigs.get_smoke(ARCH).mla
    jp = jmla.init(jax.random.key(5), cfg, D_MODEL)
    if dtype == "float32":
        jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    layer = mla.MLA(configs.get_smoke(ARCH).mla, D_MODEL, device="meta")
    layer.load_state_dict({k: tensor_from_numpy(np.asarray(v))
                           for k, v in jp.items()}, assign=True)
    return cfg, jp, layer.requires_grad_(False)


def layer_cfg():
    """The port's MLA config of the smoke model."""
    return configs.get_smoke(ARCH).mla


def _x(B, S, dtype="float32", seed=1):
    a = normal((B, S, D_MODEL), seed)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mla_forward_vs_reference_f32(use_kernel):
    cfg, jp, layer = _layer()
    x = _x(2, 16)
    pos = np.arange(16, dtype=np.int32)[None]
    want = jmla.forward(jp, cfg, jnp.asarray(x), positions=jnp.asarray(pos),
                        use_kernel=use_kernel)
    got = mla.forward(layer, layer_cfg(), torch.from_numpy(x),
                      positions=torch.from_numpy(pos), use_kernel=use_kernel)
    assert got.shape == (2, 16, D_MODEL)
    np.testing.assert_allclose(f32(got), f32(want), **F32_TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mla_forward_vs_reference_bf16(use_kernel):
    cfg, jp, layer = _layer("bfloat16")
    x = jnp.asarray(_x(2, 16, "bfloat16"))
    pos = jnp.arange(16, dtype=jnp.int32)[None]
    ref = strict(lambda p, a: jmla.forward(p, cfg, a, positions=pos,
                                           use_kernel=use_kernel), jp, x)
    got = mla.forward(layer, layer_cfg(), tensor_from_numpy(np.array(x)),
                      positions=torch.from_numpy(np.array(pos)),
                      use_kernel=use_kernel)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(ref(jp, x)), **MODEL_TOL)


def test_mla_kernel_inputs(monkeypatch):
    """The kernel path hands the flash op q = [q_nope, q_rope], k with
    k_rope repeated over the heads and every stride positive (the Hopper
    body refuses a zero stride), v zero-padded to the qk head dim and
    the qk head dim's scale; the output is cut back to v_head_dim."""
    cfg = layer_cfg()
    _, _, layer = _layer()
    seen = []
    real = attn_ops.flash_attention

    def spy(q, k, v, *args, **kw):
        seen.append((q, k, v, args))
        return real(q, k, v, *args, **kw)
    monkeypatch.setattr(attn_ops, "flash_attention", spy)
    mla.forward(layer, cfg, torch.from_numpy(_x(2, 16)),
                positions=torch.arange(16, dtype=torch.int32)[None],
                use_kernel=True)
    (q, k, v, args), = seen
    D = cfg.qk_head_dim
    assert q.shape == k.shape == v.shape == (2, 16, cfg.n_heads, D)
    assert all(s > 0 for t in (q, k, v) for s in t.stride())
    assert not v[..., cfg.v_head_dim:].any()
    assert args == (True, None, None, D ** -0.5)
    # the rope part of k is one head's, repeated
    kr = k[..., cfg.qk_nope_head_dim:]
    assert torch.equal(kr, kr[:, :, :1].expand_as(kr))


def test_mla_plain_chunks_large_score_blocks(monkeypatch):
    """Past CHUNK_SCORES score elements the plain path runs q in chunks
    with the one-shot result (deepseek's 128 heads at 8192 tokens would
    hold 34 GB of f32 scores)."""
    cfg = layer_cfg()
    _, _, layer = _layer()
    x = torch.from_numpy(_x(2, 24))
    pos = torch.arange(24, dtype=torch.int32)[None]
    full = mla.forward(layer, cfg, x, positions=pos)
    monkeypatch.setattr(attention, "CHUNK_SCORES", 4000)
    assert attention._chunk_rows(2, cfg.n_heads, 24) == 5
    got = mla.forward(layer, cfg, x, positions=pos)
    np.testing.assert_allclose(f32(got), f32(full), atol=1e-6, rtol=1e-6)


def test_mla_decode_step_and_latent_cache_vs_reference():
    """Step by step in f32: the outputs and the cache rows (the latent
    ``ckv`` and rope key ``kr``, nothing up-projected) equal the
    reference's."""
    cfg, jp, layer = _layer()
    B, T = 2, 9
    x = _x(B, T, seed=3)
    jc = jmla.init_cache(cfg, B, T)
    jc = jax.tree.map(lambda a: a.astype(jnp.float32)
                      if a.dtype == jnp.bfloat16 else a, jc)
    c = mla.init_cache(layer_cfg(), B, T, dtype=torch.float32)
    assert sorted(c) == ["ckv", "kr", "len"]
    assert c["ckv"].shape == (B, T, cfg.kv_lora_rank)
    assert c["kr"].shape == (B, T, 1, cfg.qk_rope_head_dim)
    for t in range(T):
        jy, jc = jmla.decode_step(jp, cfg, jnp.asarray(x[:, t:t + 1]), jc)
        y, c = mla.decode_step(layer, layer_cfg(),
                               torch.from_numpy(x[:, t:t + 1]), c)
        np.testing.assert_allclose(f32(y), f32(jy), **F32_TOL,
                                   err_msg=f"step {t}")
    assert c["len"] == T
    np.testing.assert_allclose(f32(c["ckv"]), f32(jc["ckv"]), **F32_TOL)
    np.testing.assert_allclose(f32(c["kr"]), f32(jc["kr"]), **F32_TOL)
    # the last step's output equals the prefill's last row
    pre = mla.forward(layer, layer_cfg(), torch.from_numpy(x),
                      positions=torch.arange(T, dtype=torch.int32)[None])
    np.testing.assert_allclose(f32(y[:, 0]), f32(pre[:, -1]), **F32_TOL)


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
    cache, jcache = decode_vs_reference(ARCH)
    assert sorted(cache["layers"][0]) == ["mla"]
    assert cache["layers"][0]["mla"]["len"] == 15
    np.testing.assert_allclose(
        f32(cache["layers"][0]["mla"]["ckv"]),
        f32(jcache["prefix"][0]["mla"]["ckv"]), **MODEL_TOL)


def test_serve_cache_takes_the_weights_dtype():
    cfg = configs.get_smoke(ARCH)
    for dtype in (torch.bfloat16, torch.float32):
        cache = init_serve_cache(cfg, 3, 7, dtype=dtype)
        for lc in cache["layers"]:
            assert sorted(lc) == ["mla"]
            assert lc["mla"]["ckv"].dtype == lc["mla"]["kr"].dtype == dtype


def test_launcher_generate_f32_matches_kernel_prefill():
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


@pytest.mark.parametrize("size", [[], ["--one-card"]])
def test_launcher_main(size, capsys, monkeypatch):
    """At smoke size on the CPU; ``--one-card`` is accepted (its model
    is built on the meta device here: 8.38 GB does not belong on a test
    host) and picks the cut."""
    if size:
        built = []

        class Built(Exception):
            pass

        def init_params(cfg, **kw):
            built.append(cfg)
            raise Built
        monkeypatch.setattr(launcher.M, "init_params", init_params)
        with pytest.raises(Built):
            launcher.main(["--arch", ARCH, "--device", "cpu", *size])
        assert built == [configs.get_one_card(ARCH)]
        return
    out = launcher.main(["--arch", ARCH, "--smoke", "--batch", "2",
                         "--prompt-len", "4", "--gen", "3", "--device",
                         "cpu"])
    assert out.shape == (2, 3)
    assert "generated (2, 3) on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# parameters and the one-card cut
# ---------------------------------------------------------------------------


def test_param_counts():
    """The whole model counts 671,026,419,200 parameters in both
    packages; the one-card cut (layers 0-3, 8 of 256 experts)
    4,189,134,080: 8.38 GB in bf16."""
    assert configs.get_config(ARCH).param_count() == 671_026_419_200
    assert jconfigs.get_config(ARCH).param_count() == 671_026_419_200
    assert configs.get_one_card(ARCH).param_count() == 4_189_134_080


def test_one_card_cut_keeps_the_published_widths():
    full, cut = configs.get_config(ARCH), configs.get_one_card(ARCH)
    assert cut.n_periods == 1 and cut.moe.held == (0, 8)
    assert cut.blocks() == full.blocks()[:4]
    assert [(s.mixer, s.ff) for s in cut.blocks()] == \
        [("mla", "mlp")] * 3 + [("mla", "moe")]
    assert dataclasses.replace(cut.moe, held=None) == full.moe
    assert dataclasses.replace(cut, name=full.name, n_periods=58,
                               moe=full.moe) == full
    m = M.Model(cut, device="meta")
    layer = m.layers[3]
    assert layer.moe.w_gate.shape == (8, 7168, 2048)
    assert layer.moe.router.shape == (7168, 256)
    assert layer.moe.router_bias.shape == (256,)
    assert layer.moe.shared.w_gate.shape == (7168, 2048)
    assert layer.mla.w_uq.shape == (1536, 128 * 192)
    assert layer.mla.w_uv.shape == (512, 128 * 128)


def test_params_from_jax_held_cuts_only_the_routed_experts():
    """With ``held`` the MoE layers keep only those experts' stacks; the
    router, its bias and the shared expert stay whole; the model runs
    and its share adds only those experts' part."""
    jcfg = jconfigs.get_smoke(ARCH)
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    cfg = configs.get_smoke(ARCH)
    state = params_from_jax(jp)
    held = params_from_jax(jp, held=(2, 5))
    skeleton = M.Model(cfg, device="meta").state_dict()
    assert sorted(state) == sorted(held) == sorted(skeleton)
    for name, t in state.items():
        assert t.dtype == skeleton[name].dtype, name
    for i in (1, 2):
        pre = f"layers.{i}.moe."
        for k in ("w_gate", "w_up", "w_down"):
            a = jp["periods"]["b0"]["moe"][k][i - 1]
            assert np.array_equal(f32(held[pre + k]),
                                  a[2:5].astype(np.float32)), (i, k)
        for k in ("router", "router_bias", "shared.w_gate", "shared.w_up",
                  "shared.w_down"):
            assert torch.equal(held[pre + k], state[pre + k]), (i, k)
    hcfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            held=(2, 5)))
    whole = M.from_state(cfg, state)
    share = M.from_state(hcfg, held)
    toks = torch.from_numpy(tokens(cfg, (1, 8), 2)).long()
    a = make_prefill_step(cfg, ServeOptions())(whole, toks)
    b = make_prefill_step(hcfg, ServeOptions())(share, toks)
    assert bool(torch.isfinite(b).all())
    assert not torch.allclose(a.float(), b.float(), **MODEL_TOL)
