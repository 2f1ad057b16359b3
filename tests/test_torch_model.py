"""The port's dense models and serving path against the JAX package's.

Each of the four dense smoke configs gets the reference's seeded
``init_params`` weights through ``convert.params_from_jax``, so both
packages run the same numbers.  Tolerances:

- forward logits with both trees cast to float32: ``atol = rtol =
  1e-4`` (reduction order only; a logic fault shows far above it);
- forward logits in bfloat16: ``atol 0.15, rtol 0.05``, the reference's
  model tolerance (tests/test_kernels.py:161); the two frameworks round
  some bf16 products to the other neighbour;
- teacher-forced decode logits in bfloat16 (the reference's KV cache is
  bf16): the same model tolerance, step by step, both packages fed the
  reference's tokens so a near-tie argmax cannot split the sequences.

In bfloat16 the reference is compiled with XLA's excess precision off
(``_strict``), so every bf16 op rounds to bf16 as the code declares, as
the port's ops do.  With the default, XLA keeps some fused
intermediates in f32 (the periods' ``lax.scan`` body is compiled): on
the smollm smoke config that default build differs from the strict one
by more than the model tolerance on 9 logits, while the port's logits
equal the strict build's bit for bit.  The port's kernel path is held
against the reference's (its Pallas kernel in interpret mode), the
plain path against the plain path; on the CPU the port's kernel path
reaches the flash kernel's plain version.
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
from repro_torch.models import attention
from repro_torch.models import model as M
from repro_torch.serve import (ServeOptions, init_serve_cache,
                               make_decode_step, make_prefill_step)

ARCHS = ["gemma2-2b", "gemma-2b", "qwen3-14b", "smollm-360m"]
MODEL_TOL = dict(atol=0.15, rtol=0.05)


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
    """``fn`` compiled with every bf16 op rounded to bf16 (XLA's
    excess precision off)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _pair(arch, dtype):
    """(jax cfg, jax params, port cfg, port model) with equal weights."""
    jcfg = jconfigs.get_smoke(arch)
    jp = JM.init_params(jax.random.key(0), jcfg)
    if dtype == "float32":
        jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    cfg = configs.get_smoke(arch)
    model = M.from_state(cfg, params_from_jax(jax.tree.map(np.asarray, jp)))
    return jcfg, jp, cfg, model


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_vs_reference_f32(arch):
    jcfg, jp, cfg, model = _pair(arch, "float32")
    toks = _tokens(cfg, (2, 16), 1)
    want = np.asarray(JM.forward(jp, jcfg, jnp.asarray(toks)), np.float32)
    for use_kernel in (False, True):
        got = make_prefill_step(cfg, ServeOptions(use_kernel=use_kernel))(
            model, torch.from_numpy(toks).long())
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4,
                                   err_msg=f"use_kernel={use_kernel}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_vs_reference_bf16(arch, use_kernel):
    """Each path against the reference's same path (use_kernel=True:
    its Pallas kernel in interpret mode)."""
    jcfg, jp, cfg, model = _pair(arch, "bfloat16")
    toks = jnp.asarray(_tokens(cfg, (2, 16), 1))
    ref = _strict(lambda p, t: JM.forward(p, jcfg, t, use_kernel=use_kernel),
                  jp, toks)
    want = np.asarray(ref(jp, toks), np.float32)
    got = make_prefill_step(cfg, ServeOptions(use_kernel=use_kernel))(
        model, torch.from_numpy(np.array(toks)).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **MODEL_TOL)


def test_chunked_core_matches_full_mask():
    """The plain path past CHUNK_THRESHOLD (q in chunks) equals the
    one-shot masked core."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 40, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 40, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 40, 2, 8)).astype(np.float32))
    pos = torch.arange(40, dtype=torch.int32)[None]
    from repro_torch.models.common import attn_mask
    mask = attn_mask(pos, pos, causal=True, window=7).expand(2, 40, 40)
    full = attention.core_attention(q, k, v, mask, cap=20.0)
    chunked = attention._chunked_core(q, k, v, pos, causal=True, window=7,
                                      cap=20.0, chunk=16)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_vs_reference(arch):
    jcfg, jp, cfg, model = _pair(arch, "bfloat16")
    B, P, G = 2, 10, 6        # past the gemma2 smoke window of 8
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
        # both fed the reference's next token
        tok = (prompts[:, i + 1: i + 2] if i + 1 < P else
               np.asarray(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None])
    assert cache["layers"][0]["attn"]["len"] == P + G - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_generate_matches_prefill(arch):
    """The launcher's loop: teacher-forced decode logits at the prompt
    positions equal the plain prefill's bit for bit (the same ops on
    the same bf16 values), past the gemma2 smoke window of 8."""
    cfg = configs.get_smoke(arch)
    g = torch.Generator().manual_seed(0)
    model = M.init_params(cfg, generator=g)
    prompts = torch.randint(2, cfg.vocab_size, (2, 12), generator=g)
    out, logits = launcher.generate(model, cfg, prompts, 5)
    assert out.shape == (2, 5) and logits.shape == (2, 16, cfg.vocab_size)
    pre = make_prefill_step(cfg, ServeOptions())(model, prompts)
    assert torch.equal(logits[:, :12], pre)
    # the first generated token is the prefill's greedy choice
    assert torch.equal(out[:, 0], pre[:, -1].argmax(-1).int())


def test_launcher_generate_f32_matches_kernel_prefill():
    """With f32 weights the KV cache is f32 too, and the launcher's
    teacher-forced decode logits equal the kernel path's prefill within
    1e-4 (the f32 core and the kernel's f32 online softmax)."""
    cfg = configs.get_smoke("gemma2-2b")
    g = torch.Generator().manual_seed(0)
    state = M.init_params(cfg, generator=g).state_dict()
    model = M.from_state(cfg, {k: t.float() for k, t in state.items()})
    prompts = torch.randint(2, cfg.vocab_size, (2, 12), generator=g)
    _, logits = launcher.generate(model, cfg, prompts, 5)
    assert logits.dtype == torch.float32
    pre = make_prefill_step(cfg, ServeOptions(use_kernel=True))(model,
                                                                prompts)
    np.testing.assert_allclose(logits[:, :12].numpy(), pre.numpy(),
                               atol=1e-4, rtol=1e-4)


def test_launcher_main_runs_on_cpu(capsys):
    out = launcher.main(["--arch", "qwen3-14b", "--smoke", "--batch", "2",
                         "--prompt-len", "4", "--gen", "3", "--device",
                         "cpu"])
    assert out.shape == (2, 3)
    assert "generated (2, 3) on cpu" in capsys.readouterr().out


def test_init_params_distributions_and_param_count():
    """The port's own init: the reference's distributions and parameter
    count (full-size counts on the meta device)."""
    for arch in ARCHS:
        assert configs.get_config(arch).param_count() == \
            jconfigs.get_config(arch).param_count(), arch
    cfg = configs.get_smoke("gemma2-2b")
    g = torch.Generator().manual_seed(0)
    m = M.init_params(cfg, generator=g)
    sd = m.state_dict()
    assert all(t.dtype == torch.bfloat16 for t in sd.values())
    assert float(sd["embed"].float().std()) == pytest.approx(1.0, rel=0.05)
    wq = sd["layers.0.attn.wq"].float()
    assert float(wq.std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.1)
    assert not sd["final_norm"].any()                 # gemma: (1 + 0)
    assert sorted(sd) == sorted(params_from_jax(jax.tree.map(
        np.asarray, JM.init_params(jax.random.key(0),
                                   jconfigs.get_smoke("gemma2-2b")))))
    # same seed, same weights
    m2 = M.init_params(cfg, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], t) for k, t in m2.state_dict().items())


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------


ARCH = ["--arch", "smollm-360m", "--smoke", "--device", "cpu"]


@pytest.mark.parametrize("flags", [["--gen", "0"], ["--gen", "-3"],
                                   ["--prompt-len", "0"], ["--batch", "0"]])
def test_launcher_degenerate_sizes_rejected(flags, capsys):
    with pytest.raises(SystemExit) as ei:
        launcher.main(ARCH + flags)
    assert ei.value.code == 2
    assert "must be >= 1" in capsys.readouterr().err


def test_launcher_cuda_without_card_fails_loudly(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        launcher.main(["--arch", "smollm-360m", "--smoke"])


def test_unknown_arch_raises_key_error():
    """Every arch of the reference's registry is ported; a name outside
    it still raises."""
    assert configs.ARCHS == list(jconfigs.ARCHS)
    for get in (configs.get_config, configs.get_smoke,
                configs.get_one_card):
        with pytest.raises(KeyError, match="unknown arch"):
            get("no-such-arch")
    with pytest.raises(KeyError, match="no one-card cut"):
        configs.get_one_card("smollm-360m")


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_param_count_equals_reference(arch):
    """The port's model on the meta device counts what the reference's
    ``count_params`` does, for every arch at its published size."""
    from repro.models.model import count_params as jcount
    assert M.count_params(configs.get_config(arch)) == \
        jcount(jconfigs.get_config(arch))


def test_shape_cells_equal_reference():
    from repro.configs import shapes as jshapes
    from repro_torch.configs import shapes
    assert shapes.cells() == jshapes.cells()
    assert shapes.LONG_OK == jshapes.LONG_OK
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}


def test_ep_options_raise_and_resilience_is_accepted():
    """``ep_options`` is accepted: a model without MoE layers has nothing
    to dispatch, an MoE prefill without a mesh raises (the dispatch
    runs over a mesh of ranks: tests/test_torch_train_dist.py), and
    decode keeps the capacity dispatch, as in the reference;
    ``resilience`` is accepted and a bad option still fails; a state
    that does not fit the model is refused."""
    from repro_torch.train.moe_dispatch import EPOptions
    cfg = configs.get_smoke("qwen3-14b")
    opts = ServeOptions(ep_options=EPOptions())
    make_prefill_step(cfg, opts)
    make_decode_step(cfg, opts)
    moe_cfg = configs.get_smoke("moonshot-v1-16b-a3b")
    with pytest.raises(ValueError, match="needs a mesh"):
        make_prefill_step(moe_cfg, opts)
    make_decode_step(moe_cfg, opts)
    make_prefill_step(cfg, ServeOptions(resilience="canary"))
    make_decode_step(cfg, ServeOptions(resilience="canary"))
    with pytest.raises(ValueError, match="resilience preset"):
        make_decode_step(cfg, ServeOptions(resilience="sideways"))
    with pytest.raises(ValueError, match="does not fit"):
        M.from_state(cfg, {"embed": torch.zeros(1)})


def test_cpu_serving_counts_no_launches():
    cfg = configs.get_smoke("gemma2-2b")
    model = M.init_params(cfg, generator=torch.Generator().manual_seed(1))
    before = dict(cuda.LAUNCHES)
    make_prefill_step(cfg, ServeOptions(use_kernel=True))(
        model, torch.zeros(1, 16, dtype=torch.long))
    assert cuda.LAUNCHES == before
