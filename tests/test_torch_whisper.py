"""The port's whisper-small (the encoder stack over precomputed frames,
cross-attention to its output in every decoder block, plain GELU MLPs)
against the JAX package's.

The model tests take the reference's seeded ``init_params`` (encoder
included) through ``convert.params_from_jax``; frames are seeded numpy
normals.  Tolerances: float32 ``atol = rtol = 1e-4``; bfloat16 and
decode the model tolerance, ``atol 0.15, rtol 0.05``, against the
reference compiled with XLA's excess precision off
(tests/torch_arch_helpers.py).
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import model as JM

from repro_torch import configs
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models import attention, blocks
from repro_torch.models import model as M
from repro_torch.serve import (ServeOptions, init_serve_cache,
                               make_decode_step, make_prefill_step)

from torch_arch_helpers import (F32_TOL, MODEL_TOL, decode_vs_reference,
                                f32, normal, pair, strict, tokens)

ARCH = "whisper-small"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(cfg, B, seed, dtype=np.float32):
    return normal((B, cfg.encoder.n_frames, cfg.encoder.d_model),
                  seed).astype(dtype)


def test_cross_attention_vs_reference():
    """Queries from the decoder, keys and values from the encoder
    output, no rope (the positions do not matter), every key live."""
    jcfg = jconfigs.get_smoke(ARCH)
    jp = JM.init_params(jax.random.key(0), jcfg)["periods"]["b0"]["cross"]
    jp = jax.tree.map(lambda a: a[0].astype(jnp.float32), jp)
    cfg = configs.get_smoke(ARCH)
    ccfg = blocks.cross_config(cfg)
    assert ccfg.cross and not ccfg.causal
    layer = attention.Attention(ccfg, cfg.d_model, device="meta")
    layer.load_state_dict({k: tensor_from_numpy(np.asarray(v))
                           for k, v in jp.items()}, assign=True)
    x = normal((2, 7, cfg.d_model), 1)
    src = normal((2, cfg.encoder.n_frames, cfg.d_model), 2)
    jccfg = dataclasses.replace(jcfg.attn, cross=True, causal=False)
    want = jattn.forward(jp, jccfg, jnp.asarray(x),
                         positions=jnp.zeros((2, 7), jnp.int32),
                         kv_src=jnp.asarray(src))
    outs = []
    for pos in (torch.zeros(2, 7, dtype=torch.int32),
                torch.arange(7, dtype=torch.int32)[None] + 50):
        outs.append(attention.forward(layer, ccfg, torch.from_numpy(x),
                                      positions=pos,
                                      kv_src=torch.from_numpy(src),
                                      use_kernel=True))
    np.testing.assert_allclose(f32(outs[0]), f32(want), **F32_TOL)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_vs_reference(dtype):
    jcfg, jp, cfg, model = pair(ARCH, dtype)
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    fr = _frames(cfg, 2, 3, npdt)
    ref = strict(lambda p, f: JM.encode(p, jcfg, f), jp, jnp.asarray(fr))
    got = M.encode(model, cfg, tensor_from_numpy(fr))
    assert got.shape == fr.shape and str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(f32(got), f32(ref(jp, jnp.asarray(fr))),
                               **(F32_TOL if dtype == "float32"
                                  else MODEL_TOL))


def test_forward_with_frames_vs_reference_f32():
    jcfg, jp, cfg, model = pair(ARCH, "float32")
    toks = tokens(cfg, (2, 16), 1)
    fr = _frames(cfg, 2, 3)
    for use_kernel in (False, True):
        want = JM.forward(jp, jcfg, jnp.asarray(toks),
                          encoder_frames=jnp.asarray(fr),
                          use_kernel=use_kernel)
        got = make_prefill_step(cfg, ServeOptions(use_kernel=use_kernel))(
            model, torch.from_numpy(toks).long(),
            encoder_frames=torch.from_numpy(fr))
        np.testing.assert_allclose(f32(got), f32(want), **F32_TOL,
                                   err_msg=f"use_kernel={use_kernel}")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_with_frames_vs_reference_bf16(use_kernel):
    jcfg, jp, cfg, model = pair(ARCH, "bfloat16")
    toks = jnp.asarray(tokens(cfg, (2, 16), 1))
    fr = jnp.asarray(_frames(cfg, 2, 3, ml_dtypes.bfloat16))
    ref = strict(lambda p, t, f: JM.forward(p, jcfg, t, encoder_frames=f,
                                            use_kernel=use_kernel),
                 jp, toks, fr)
    got = make_prefill_step(cfg, ServeOptions(use_kernel=use_kernel))(
        model, torch.from_numpy(np.array(toks)).long(),
        encoder_frames=tensor_from_numpy(np.array(fr)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(ref(jp, toks, fr)),
                               **MODEL_TOL)


def test_teacher_forced_decode_vs_reference():
    cfg = configs.get_smoke(ARCH)
    cache, _ = decode_vs_reference(
        ARCH, frames=_frames(cfg, 2, 5, ml_dtypes.bfloat16))
    assert sorted(cache["layers"][0]) == ["attn"]        # no cross cache


def test_an_encoder_decoder_needs_its_frames():
    cfg = configs.get_smoke(ARCH)
    model = M.init_params(cfg, generator=torch.Generator().manual_seed(0))
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="encoder_frames"):
        make_prefill_step(cfg, ServeOptions())(model, toks)
    decode = make_decode_step(cfg, ServeOptions())
    with pytest.raises(ValueError, match="cross_src"):
        decode(model, init_serve_cache(cfg, 1, 4), toks[:, :1])
    with pytest.raises(ValueError, match="cross_src"):
        blocks.forward(model.layers[0], cfg.blocks()[0], cfg,
                       torch.zeros(1, 4, cfg.d_model, dtype=torch.bfloat16),
                       positions=torch.arange(4)[None])


def test_launcher_generate_f32_matches_kernel_prefill():
    """The launcher's loop with the encoder output passed to every step
    against the kernel prefill over the same frames, in f32."""
    cfg = configs.get_smoke(ARCH)
    g = torch.Generator().manual_seed(0)
    state = M.init_params(cfg, generator=g).state_dict()
    model = M.from_state(cfg, {k: t.float() for k, t in state.items()})
    prompts = torch.randint(2, cfg.vocab_size, (2, 12), generator=g)
    fr = torch.from_numpy(_frames(cfg, 2, 6))
    cross = M.encode(model, cfg, fr)
    out, logits = launcher.generate(model, cfg, prompts, 5, cross_src=cross)
    assert out.shape == (2, 5) and logits.dtype == torch.float32
    pre = make_prefill_step(cfg, ServeOptions(use_kernel=True))(
        model, prompts, encoder_frames=fr)
    np.testing.assert_allclose(logits[:, :12].numpy(), pre.numpy(),
                               **F32_TOL)


def test_launcher_main_runs_on_cpu(capsys):
    out = launcher.main(["--arch", ARCH, "--smoke", "--batch", "2",
                         "--prompt-len", "4", "--gen", "3", "--device",
                         "cpu"])
    assert out.shape == (2, 3)
    assert "generated (2, 3) on cpu" in capsys.readouterr().out


def test_param_count_and_encoder_state_names():
    """238,060,800 parameters in both packages, the encoder's included;
    the reference's ``encoder`` tree maps onto ``encoder.layers.{i}`` and
    ``encoder.final_norm``, the cross sublayer onto ``norm_cross`` and
    ``cross.*``."""
    assert configs.get_config(ARCH).param_count() == 238_060_800
    assert jconfigs.get_config(ARCH).param_count() == 238_060_800
    jcfg = jconfigs.get_smoke(ARCH)
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    state = params_from_jax(jp)
    skeleton = M.Model(configs.get_smoke(ARCH), device="meta").state_dict()
    assert sorted(state) == sorted(skeleton)
    assert "encoder.final_norm" in state
    assert "encoder.layers.1.mlp.w_up" in state
    assert "encoder.layers.0.mlp.w_gate" not in state    # plain GELU MLP
    assert "layers.1.cross.wk" in state and "layers.1.norm_cross" in state
    assert np.array_equal(
        f32(state["encoder.layers.1.attn.wq"]),
        jp["encoder"]["layers"][1]["attn"]["wq"].astype(np.float32))
