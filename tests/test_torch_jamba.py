"""The port's jamba-1.5-large-398b (mamba + attention + MoE blocks, the
O(1)-state decode, serving, the one-card cut) against the JAX package's.

The smoke config gets the reference's seeded ``init_params`` weights
through ``convert.params_from_jax``, so both packages run the same
numbers.  Tolerances:

- float32 (both trees cast to f32): ``atol = rtol = 1e-4``, reduction
  order only;
- bfloat16: the reference's model tolerance, ``atol 0.15, rtol 0.05``
  (tests/test_kernels.py:159), against the reference compiled with XLA's
  excess precision off (see tests/test_torch_model.py);
- teacher-forced decode in bf16, step by step at the model tolerance,
  both fed the reference's tokens;
- the port's own f32 decode against its kernel prefill: the model
  tolerance, since the two differ by dt's bf16 rounding on the kernel
  path and the decode state's bf16 conv window, as the reference's do.

The smoke config's 4 experts give capacity C = batch at decode, so the
capacity dispatch drops nothing here (tests/test_torch_moe.py checks a
dropping case).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import model as JM

from repro_torch import configs, cuda
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launcher
from repro_torch.models import model as M
from repro_torch.serve import (ServeOptions, init_serve_cache,
                               make_decode_step, make_prefill_step)

ARCH = "jamba-1.5-large-398b"
MODEL_TOL = dict(atol=0.15, rtol=0.05)
F32_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _strict(fn, *args):
    """``fn`` compiled with every bf16 op rounded to bf16."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _pair(dtype):
    """(jax cfg, jax params, port cfg, port model) with equal weights."""
    jcfg = jconfigs.get_smoke(ARCH)
    jp = JM.init_params(jax.random.key(0), jcfg)
    if dtype == "float32":
        jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    cfg = configs.get_smoke(ARCH)
    model = M.from_state(cfg, params_from_jax(jax.tree.map(np.asarray, jp)))
    return jcfg, jp, cfg, model


def test_forward_logits_vs_reference_f32():
    jcfg, jp, cfg, model = _pair("float32")
    toks = _tokens(cfg, (2, 16), 1)
    for use_kernel in (False, True):
        want = np.asarray(JM.forward(jp, jcfg, jnp.asarray(toks),
                                     use_kernel=use_kernel), np.float32)
        got = make_prefill_step(cfg, ServeOptions(use_kernel=use_kernel))(
            model, torch.from_numpy(toks).long())
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL,
                                   err_msg=f"use_kernel={use_kernel}")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_vs_reference_bf16(use_kernel):
    jcfg, jp, cfg, model = _pair("bfloat16")
    toks = jnp.asarray(_tokens(cfg, (2, 16), 1))
    ref = _strict(lambda p, t: JM.forward(p, jcfg, t, use_kernel=use_kernel),
                  jp, toks)
    want = np.asarray(ref(jp, toks), np.float32)
    got = make_prefill_step(cfg, ServeOptions(use_kernel=use_kernel))(
        model, torch.from_numpy(np.array(toks)).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **MODEL_TOL)


def test_teacher_forced_decode_vs_reference():
    jcfg, jp, cfg, model = _pair("bfloat16")
    B, P, G = 2, 10, 6
    prompts = _tokens(cfg, (B, P), 4)
    jcache = JM.init_cache(jcfg, B, P + G)
    jstep = _strict(lambda p, c, t: JM.decode_step(p, jcfg, c, t), jp,
                    jcache, jnp.asarray(prompts[:, :1]))
    cache = init_serve_cache(cfg, B, P + G)
    decode = make_decode_step(cfg, ServeOptions())
    tok = prompts[:, :1]
    for i in range(P + G - 1):
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(tok))
        nxt, cache, logits = decode(model, cache,
                                    torch.from_numpy(tok.copy()).long())
        want = np.asarray(jlogits[:, -1], np.float32)
        np.testing.assert_allclose(logits.float().numpy(), want,
                                   **MODEL_TOL, err_msg=f"step {i}")
        assert nxt.shape == (B, 1) and nxt.dtype == torch.int32
        tok = (prompts[:, i + 1: i + 2] if i + 1 < P else
               np.asarray(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None])
    # the last mamba layer's state against the reference's
    h = cache["layers"][-1]["mamba"]["h"]
    jh = np.asarray(jcache["periods"]["b7"]["mamba"]["h"][-1], np.float32)
    assert h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), jh, **MODEL_TOL)


def test_serve_cache_layout():
    """Mamba layers carry ``h`` f32 and the conv window in bf16 whatever
    the weights' dtype; the attention layer its k/v in the weights'."""
    cfg = configs.get_smoke(ARCH)
    Di = cfg.mamba.expand * cfg.d_model
    for dtype in (torch.bfloat16, torch.float32):
        cache = init_serve_cache(cfg, 3, 9, dtype=dtype)
        for spec, lc in zip(cfg.blocks(), cache["layers"]):
            if spec.mixer == "attn":
                assert sorted(lc) == ["attn"]
                continue
            assert sorted(lc) == ["mamba"]
            assert lc["mamba"]["h"].shape == (3, Di, cfg.mamba.d_state)
            assert lc["mamba"]["h"].dtype == torch.float32
            assert lc["mamba"]["conv"].shape == (3, cfg.mamba.d_conv - 1, Di)
            assert lc["mamba"]["conv"].dtype == torch.bfloat16


def test_launcher_generate_f32_matches_kernel_prefill():
    """With f32 weights, the launcher's teacher-forced decode logits at
    batch 1 against the kernel path's prefill, at the model tolerance."""
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


def test_launcher_one_card_needs_a_cut():
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "rwkv6-3b", "--one-card", "--device",
                       "cpu"])


def test_cpu_serving_counts_no_launches():
    cfg = configs.get_smoke(ARCH)
    model = M.init_params(cfg, generator=torch.Generator().manual_seed(1))
    before = dict(cuda.LAUNCHES)
    make_prefill_step(cfg, ServeOptions(use_kernel=True))(
        model, torch.zeros(1, 16, dtype=torch.long))
    assert cuda.LAUNCHES == before


# ---------------------------------------------------------------------------
# parameters and the one-card cut
# ---------------------------------------------------------------------------


def test_param_counts():
    """The whole model counts 398,555,145,696 parameters in both
    packages; the one-card cut (one period, 8 of 16 experts) counts
    25,910,996,704."""
    assert configs.get_config(ARCH).param_count() == 398_555_145_696
    assert jconfigs.get_config(ARCH).param_count() == 398_555_145_696
    assert configs.get_one_card(ARCH).param_count() == 25_910_996_704


def test_one_card_cut_keeps_the_published_widths():
    full, cut = configs.get_config(ARCH), configs.get_one_card(ARCH)
    assert cut.n_periods == 1 and cut.moe.held == (0, 8)
    assert cut.blocks() == full.blocks()[:8]
    assert dataclasses.replace(cut.moe, held=None) == full.moe
    assert dataclasses.replace(cut, name=full.name, n_periods=9,
                               moe=full.moe) == full
    m = M.Model(cut, device="meta")
    assert m.layers[1].moe.w_gate.shape == (8, 8192, 24576)
    assert m.layers[1].moe.router.shape == (8192, 16)


def test_params_from_jax_names_dtypes_and_held_share():
    """The reference's tree maps onto the port's names with its values
    and dtypes (bf16 projections, f32 router/dt_bias/A_log/D); with
    ``held`` each MoE layer keeps only those experts' stacks."""
    jcfg = jconfigs.get_smoke(ARCH)
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    cfg = configs.get_smoke(ARCH)
    state = params_from_jax(jp)
    skeleton = M.Model(cfg, device="meta").state_dict()
    assert sorted(state) == sorted(skeleton)
    f32 = {"router", "dt_bias", "A_log", "D"}
    for name, t in state.items():
        want = (torch.float32 if name.split(".")[-1] in f32
                else torch.bfloat16)
        assert t.dtype == want == skeleton[name].dtype, name
        assert t.shape == skeleton[name].shape, name
    hcfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            held=(1, 3)))
    held = params_from_jax(jp, held=(1, 3))
    model = M.from_state(hcfg, held).requires_grad_(False)
    for i in (1, 3, 5, 7):
        for k in ("w_gate", "w_up", "w_down"):
            a = jp["periods"][f"b{i}"]["moe"][k][0]
            assert np.array_equal(
                model.layers[i].moe.get_parameter(k).float().numpy(),
                a[1:3].astype(np.float32)), (i, k)
        assert torch.equal(held[f"layers.{i}.moe.router"],
                           state[f"layers.{i}.moe.router"])


def test_held_share_model_runs_and_differs_from_whole():
    """A model holding experts [0, 2) of the smoke config's 4 adds only
    their part: its logits differ from the whole model's."""
    jcfg = jconfigs.get_smoke(ARCH)
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    cfg = configs.get_smoke(ARCH)
    hcfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            held=(0, 2)))
    whole = M.from_state(cfg, params_from_jax(jp))
    share = M.from_state(hcfg, params_from_jax(jp, held=(0, 2)))
    toks = torch.from_numpy(_tokens(cfg, (1, 8), 2)).long()
    a = make_prefill_step(cfg, ServeOptions())(whole, toks)
    b = make_prefill_step(hcfg, ServeOptions())(share, toks)
    assert a.shape == b.shape and bool(torch.isfinite(b).all())
    assert not torch.allclose(a.float(), b.float(), **MODEL_TOL)


def test_plain_attention_chunks_large_score_blocks(monkeypatch):
    """A plain prefill whose [B, H, S, S] scores would pass CHUNK_SCORES
    elements (jamba's 64 heads at 8192 tokens: 17 GB in f32) runs q in
    chunks of at most CHUNK_SCORES / 4 score elements, with the one-shot
    result."""
    from repro_torch.models import attention
    cfg = configs.get_smoke(ARCH)
    model = M.init_params(cfg, generator=torch.Generator().manual_seed(2))
    p = model.layers[4].attn
    p32 = attention.Attention(cfg.attn, cfg.d_model)
    p32.load_state_dict({k: t.float() for k, t in p.state_dict().items()},
                        assign=True)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32))
    pos = torch.arange(24, dtype=torch.int32)[None]
    with torch.no_grad():
        full = attention.forward(p32, cfg.attn, x, positions=pos)
        chunks = []
        real = attention._chunked_core
        monkeypatch.setattr(attention, "_chunked_core", lambda *a, **kw: (
            chunks.append(kw["chunk"]) or real(*a, **kw)))
        monkeypatch.setattr(attention, "CHUNK_SCORES", 4000)
        got = attention.forward(p32, cfg.attn, x, positions=pos)
    assert chunks == [1000 // (2 * cfg.attn.n_heads * 24)]
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-6,
                               rtol=1e-6)
