"""The port's rwkv6-3b (time mix, channel mix, blocks, O(1)-state decode,
serving) against the JAX package's.

The smoke config gets the reference's seeded ``init_params`` weights
through ``convert.params_from_jax`` (bf16 projections, f32 ``w0``,
``mu``, ``u``, ``ln_w``, ``ln_b``), so both packages run the same
numbers.  Tolerances:

- float32 (both trees cast to f32): ``atol = rtol = 1e-4``, reduction
  order only;
- bfloat16: the reference's model tolerance, ``atol 0.15, rtol 0.05``
  (tests/test_kernels.py:159), against the reference compiled with XLA's
  excess precision off (see tests/test_torch_model.py);
- teacher-forced decode in bf16, step by step at the model tolerance,
  both fed the reference's tokens.  The reference keeps the token-shift
  carries in bf16 whatever the weights' dtype; the port's take the
  weights' dtype, which is the same thing in bf16.

The port's kernel path (``use_kernel``) reaches the wkv6 kernel's plain
version on the CPU and is held against the reference's kernel path (its
Pallas kernel in interpret mode).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import rwkv as jrwkv

from repro_torch import configs, cuda
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models import model as M
from repro_torch.models import rwkv
from repro_torch.serve import (ServeOptions, init_serve_cache,
                               make_decode_step, make_prefill_step)

ARCH = "rwkv6-3b"
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


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _layer0(jp, model):
    """Layer 0's time-mix and channel-mix parameters in both packages."""
    jl = jax.tree.map(lambda a: a[0], jp["periods"]["b0"])
    return jl, model.layers[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_time_mix_vs_reference(dtype, use_kernel):
    jcfg, jp, cfg, model = _pair(dtype)
    jl, layer = _layer0(jp, model)
    x = np.random.default_rng(1).normal(size=(2, 16, cfg.d_model))
    x = jnp.asarray(x, dtype)
    ref = _strict(lambda p, a: jrwkv.time_mix(p, jcfg.rwkv, a,
                                              use_kernel=use_kernel),
                  jl["rwkv"], x)
    want = ref(jl["rwkv"], x)
    with torch.no_grad():
        got = rwkv.time_mix(layer.rwkv, cfg.rwkv,
                            tensor_from_numpy(np.asarray(x)),
                            use_kernel=use_kernel)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = F32_TOL if dtype == "float32" else MODEL_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_vs_reference(dtype):
    jcfg, jp, cfg, model = _pair(dtype)
    jl, layer = _layer0(jp, model)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(2, 16, cfg.d_model)), dtype)
    last = jnp.asarray(rng.normal(size=(2, cfg.d_model)), dtype)
    ref = _strict(lambda p, a, b: jrwkv.channel_mix(p, a, b), jl["cmix"], x,
                  last)
    want = ref(jl["cmix"], x, last)
    with torch.no_grad():
        got = rwkv.channel_mix(layer.cmix, tensor_from_numpy(np.asarray(x)),
                               tensor_from_numpy(np.asarray(last)))
    tol = F32_TOL if dtype == "float32" else MODEL_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_decode_time_mix_state_vs_reference():
    """Three f32 decode steps of one layer: output, wkv state and carry
    (the reference's state with an f32 carry, as the port keeps it for
    f32 weights)."""
    jcfg, jp, cfg, model = _pair("float32")
    jl, layer = _layer0(jp, model)
    jstate = dict(jrwkv.init_state(jcfg.rwkv, 2, cfg.d_model))
    jstate["x_tm"] = jstate["x_tm"].astype(jnp.float32)
    state = rwkv.init_state(cfg.rwkv, 2, cfg.d_model, dtype=torch.float32)
    rng = np.random.default_rng(3)
    for _ in range(3):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, jstate = jrwkv.decode_time_mix(jl["rwkv"], jcfg.rwkv,
                                             jnp.asarray(x), jstate)
        with torch.no_grad():
            got, state = rwkv.decode_time_mix(layer.rwkv, cfg.rwkv,
                                              torch.from_numpy(x), state)
        np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
        for key in ("s", "x_tm"):
            np.testing.assert_allclose(_f32(state[key]), _f32(jstate[key]),
                                       **F32_TOL, err_msg=key)
    assert state["s"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the model and the serving path
# ---------------------------------------------------------------------------


def test_forward_logits_vs_reference_f32():
    jcfg, jp, cfg, model = _pair("float32")
    toks = _tokens(cfg, (2, 16), 1)
    want = np.asarray(JM.forward(jp, jcfg, jnp.asarray(toks)), np.float32)
    for use_kernel in (False, True):
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
    # the wkv state against the reference's, the last layer
    s = cache["layers"][-1]["rwkv"]["s"]
    js = np.asarray(jcache["periods"]["b0"]["rwkv"]["s"][-1], np.float32)
    assert s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), js, **MODEL_TOL)


def test_serve_cache_layout():
    """Per layer ``rwkv`` (s f32, carries in the weights' dtype) and a
    separate ``cmix`` carry, as the reference's cache."""
    cfg = configs.get_smoke(ARCH)
    H, N = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    for dtype in (torch.bfloat16, torch.float32):
        cache = init_serve_cache(cfg, 3, 9, dtype=dtype)
        assert len(cache["layers"]) == cfg.n_layers
        for lc in cache["layers"]:
            assert sorted(lc) == ["cmix", "rwkv"]
            assert lc["rwkv"]["s"].shape == (3, H, N, N)
            assert lc["rwkv"]["s"].dtype == torch.float32
            for c in (lc["rwkv"]["x_tm"], lc["rwkv"]["x_cm"],
                      lc["cmix"]["x_cm"]):
                assert c.shape == (3, cfg.d_model) and c.dtype == dtype


def test_launcher_generate_matches_prefill():
    """bf16: the launcher's teacher-forced decode logits at the prompt
    positions equal the plain prefill's bit for bit (the one-step
    recurrence and the loop over T are the same ops on the same values),
    and the first generated token is the prefill's choice."""
    cfg = configs.get_smoke(ARCH)
    g = torch.Generator().manual_seed(0)
    model = M.init_params(cfg, generator=g)
    prompts = torch.randint(2, cfg.vocab_size, (2, 12), generator=g)
    out, logits = launcher.generate(model, cfg, prompts, 5)
    assert out.shape == (2, 5) and logits.shape == (2, 16, cfg.vocab_size)
    pre = make_prefill_step(cfg, ServeOptions())(model, prompts)
    assert torch.equal(logits[:, :12], pre)
    assert torch.equal(out[:, 0], pre[:, -1].argmax(-1).int())


def test_launcher_generate_f32_matches_kernel_prefill():
    """With f32 weights the carries are f32 too, and the launcher's
    teacher-forced decode logits equal the kernel path's prefill within
    1e-4."""
    cfg = configs.get_smoke(ARCH)
    g = torch.Generator().manual_seed(0)
    state = M.init_params(cfg, generator=g).state_dict()
    model = M.from_state(cfg, {k: t.float() for k, t in state.items()})
    prompts = torch.randint(2, cfg.vocab_size, (2, 12), generator=g)
    _, logits = launcher.generate(model, cfg, prompts, 5)
    assert logits.dtype == torch.float32
    pre = make_prefill_step(cfg, ServeOptions(use_kernel=True))(model,
                                                                prompts)
    np.testing.assert_allclose(logits[:, :12].numpy(), pre.numpy(),
                               **F32_TOL)


def test_launcher_main_runs_on_cpu(capsys):
    out = launcher.main(["--arch", ARCH, "--smoke", "--batch", "2",
                         "--prompt-len", "4", "--gen", "3", "--device",
                         "cpu"])
    assert out.shape == (2, 3)
    assert "generated (2, 3) on cpu" in capsys.readouterr().out


def test_cpu_serving_counts_no_launches():
    cfg = configs.get_smoke(ARCH)
    model = M.init_params(cfg, generator=torch.Generator().manual_seed(1))
    before = dict(cuda.LAUNCHES)
    make_prefill_step(cfg, ServeOptions(use_kernel=True))(
        model, torch.zeros(1, 16, dtype=torch.long))
    assert cuda.LAUNCHES == before


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def test_params_from_jax_names_and_dtypes():
    """The reference's tree maps onto the port's names (``layers.{i}.
    rwkv.wr``, ``layers.{i}.cmix.mu``, ...) with its values and dtypes:
    bf16 projections and norms, f32 w0/mu/u/ln_w/ln_b."""
    jcfg = jconfigs.get_smoke(ARCH)
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    state = params_from_jax(jp)
    cfg = configs.get_smoke(ARCH)
    skeleton = M.Model(cfg, device="meta").state_dict()
    assert sorted(state) == sorted(skeleton)
    f32 = {"w0", "mu", "u", "ln_w", "ln_b"}
    for name, t in state.items():
        want = (torch.float32 if name.split(".")[-1] in f32
                and ".rwkv." in name or name.endswith("cmix.mu")
                else torch.bfloat16)
        assert t.dtype == want == skeleton[name].dtype, name
        assert t.shape == skeleton[name].shape, name
    for i in range(cfg.n_layers):
        for mod, leaf in (("rwkv", "wr"), ("rwkv", "u"), ("cmix", "mu")):
            a = jp["periods"]["b0"][mod][leaf][i]
            t = state[f"layers.{i}.{mod}.{leaf}"]
            assert np.array_equal(_f32(t), a.astype(np.float32))


def test_param_count_and_init_distributions():
    """rwkv6-3b counts 3,073,395,200 parameters in both packages; the
    port's own init takes the reference's dtypes and distributions."""
    assert configs.get_config(ARCH).param_count() == 3_073_395_200
    assert jconfigs.get_config(ARCH).param_count() == 3_073_395_200
    cfg = configs.get_smoke(ARCH)
    m = M.init_params(cfg, generator=torch.Generator().manual_seed(0))
    p, c = (t.requires_grad_(False) for t in (m.layers[0].rwkv,
                                            m.layers[0].cmix))
    assert p.wr.dtype == p.w_lora_b.dtype == c.wk.dtype == torch.bfloat16
    assert (p.w0 == -6).all() and p.w0.dtype == torch.float32
    assert (p.ln_w == 1).all() and not p.ln_b.any()
    for mu in (p.mu, c.mu):
        assert mu.dtype == torch.float32
        assert float(mu.min()) >= 0 and float(mu.max()) < 1
    assert float(p.u.std()) == pytest.approx(0.1, rel=0.3)
    assert float(p.w_lora_b.float().std()) == pytest.approx(0.01, rel=0.3)
    assert float(p.wr.float().std()) == pytest.approx(cfg.d_model ** -0.5,
                                                      rel=0.1)
    m2 = M.init_params(cfg, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(t, m2.state_dict()[k])
               for k, t in m.state_dict().items())
