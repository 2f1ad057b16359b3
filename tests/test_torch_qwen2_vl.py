"""The port's qwen2-vl-7b (M-RoPE: three position streams rotating
disjoint frequency sections; precomputed patch embeddings in the leading
rows; GQA attention blocks) against the JAX package's.

M-RoPE is fed three distinct position streams throughout: the default
positions make all three equal, which would hide a section mix-up.  The
model tests take the reference's seeded ``init_params`` through
``convert.params_from_jax``.  Tolerances: float32 ``atol = rtol =
1e-4`` (M-RoPE itself ``1e-6``: the same f32 ops); bfloat16 and decode
the model tolerance, ``atol 0.15, rtol 0.05``, against the reference
compiled with XLA's excess precision off (tests/torch_arch_helpers.py).
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import model as JM

from repro_torch import configs
from repro_torch.convert import tensor_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models import attention
from repro_torch.models import model as M
from repro_torch.models.common import apply_mrope
from repro_torch.serve import ServeOptions, make_prefill_step

from torch_arch_helpers import (F32_TOL, MODEL_TOL, decode_vs_reference,
                                f32, normal, pair, strict, tokens)

ARCH = "qwen2-vl-7b"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _streams(B, S, seed):
    """Three distinct position streams [3, B, S]: time ascending, height
    and width drawn apart from it and from each other."""
    rng = np.random.default_rng(seed)
    t = np.broadcast_to(np.arange(S), (B, S))
    h = rng.integers(0, 3 * S, (B, S))
    w = rng.integers(0, 5 * S, (B, S))
    pos = np.stack([t, h, w]).astype(np.int32)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    return pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections,D", [((2, 3, 3), 16),
                                        ((16, 24, 24), 128)])
def test_apply_mrope_vs_reference(sections, D, dtype):
    x = normal((2, 12, 3, D), 1)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    pos = _streams(2, 12, 2)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                               sections)
    got = apply_mrope(tensor_from_numpy(x), torch.from_numpy(pos), 1e6,
                      sections)
    assert str(got.dtype) == f"torch.{dtype}"
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-6, rtol=1e-6)
    else:
        # one rounding of the same f32 values: equal or one ulp apart
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-2,
                                   rtol=1e-2)


def test_each_section_rotates_with_its_own_stream():
    """Moving only the height stream changes only the height section's
    frequencies (both halves of the rotated pairs), and so on."""
    sections, D = (2, 3, 3), 16
    x = torch.from_numpy(normal((1, 6, 2, D), 3))
    pos = torch.from_numpy(_streams(1, 6, 4))
    base = apply_mrope(x, pos, 1e6, sections)
    lo = 0
    for s, n in enumerate(sections):
        moved = pos.clone()
        moved[s] += 7
        diff = (apply_mrope(x, moved, 1e6, sections) - base).abs() > 1e-6
        cols = diff.any(0).any(0).any(0).nonzero()[:, 0].tolist()
        want = list(range(lo, lo + n)) + list(range(D // 2 + lo,
                                                    D // 2 + lo + n))
        assert cols == want, (s, cols)
        lo += n


def test_mrope_rejects_sections_that_miss_the_frequencies():
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.zeros(1, 2, 1, 16), torch.zeros(3, 1, 2), 1e4,
                    (2, 3, 2))


def _attn_pair(dtype="float32"):
    jcfg = jconfigs.get_smoke(ARCH)
    jp = JM.init_params(jax.random.key(0), jcfg)["periods"]["b0"]["attn"]
    jp = jax.tree.map(lambda a: a[0], jp)
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    cfg = configs.get_smoke(ARCH)
    layer = attention.Attention(cfg.attn, cfg.d_model, device="meta")
    layer.load_state_dict({k: tensor_from_numpy(np.asarray(v))
                           for k, v in jp.items()}, assign=True)
    return jcfg, jp, cfg, layer.requires_grad_(False)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_with_three_streams_vs_reference(use_kernel):
    """Prefill attention at distinct streams: rope from all three, the
    causal mask from the time stream."""
    jcfg, jp, cfg, layer = _attn_pair()
    x = normal((2, 16, cfg.d_model), 5)
    pos = _streams(2, 16, 6)
    want = jattn.forward(jp, jcfg.attn, jnp.asarray(x),
                         positions=jnp.asarray(pos), use_kernel=use_kernel)
    got = attention.forward(layer, cfg.attn, torch.from_numpy(x),
                            positions=torch.from_numpy(pos),
                            use_kernel=use_kernel)
    np.testing.assert_allclose(f32(got), f32(want), **F32_TOL)


def test_attention_decode_broadcasts_t_to_the_three_streams():
    jcfg, jp, cfg, layer = _attn_pair()
    B, T = 2, 6
    x = normal((B, T, cfg.d_model), 7)
    jc = jax.tree.map(lambda a: a.astype(jnp.float32)
                      if a.dtype == jnp.bfloat16 else a,
                      jattn.init_cache(jcfg.attn, B, T))
    c = attention.init_cache(cfg.attn, B, T, dtype=torch.float32)
    for t in range(T):
        jy, jc = jattn.decode_step(jp, jcfg.attn, jnp.asarray(x[:, t:t + 1]),
                                   jc)
        y, c = attention.decode_step(layer, cfg.attn,
                                     torch.from_numpy(x[:, t:t + 1]), c)
        np.testing.assert_allclose(f32(y), f32(jy), **F32_TOL,
                                   err_msg=f"step {t}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _vision(cfg, B, seed, dtype=np.float32):
    return normal((B, cfg.vision_prefix, cfg.d_model), seed).astype(dtype)


def test_embed_tokens_puts_the_patches_in_the_leading_rows():
    _, _, cfg, model = pair(ARCH, "bfloat16")
    toks = torch.from_numpy(tokens(cfg, (2, 12), 1)).long()
    vis = torch.from_numpy(_vision(cfg, 2, 2))
    x = M.embed_tokens(model, cfg, toks, vis)
    assert x.dtype == torch.bfloat16
    assert torch.equal(x[:, :cfg.vision_prefix], vis.bfloat16())
    assert torch.equal(x[:, cfg.vision_prefix:],
                       model.embed[toks[:, cfg.vision_prefix:]])
    assert torch.equal(M.embed_tokens(model, cfg, toks), model.embed[toks])


@pytest.mark.parametrize("streams", ["default", "distinct"])
def test_forward_with_vision_embeds_vs_reference_f32(streams):
    jcfg, jp, cfg, model = pair(ARCH, "float32")
    toks = tokens(cfg, (2, 16), 1)
    vis = _vision(cfg, 2, 3)
    kw, jkw = {}, {}
    if streams == "distinct":
        pos = _streams(2, 16, 4)
        kw["positions"] = torch.from_numpy(pos)
        jkw["positions"] = jnp.asarray(pos)
    for use_kernel in (False, True):
        want = JM.forward(jp, jcfg, jnp.asarray(toks),
                          vision_embeds=jnp.asarray(vis),
                          use_kernel=use_kernel, **jkw)
        got = M.forward(model, cfg, torch.from_numpy(toks).long(),
                        vision_embeds=torch.from_numpy(vis),
                        use_kernel=use_kernel, **kw)
        np.testing.assert_allclose(f32(got), f32(want), **F32_TOL,
                                   err_msg=f"use_kernel={use_kernel}")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_with_vision_embeds_vs_reference_bf16(use_kernel):
    jcfg, jp, cfg, model = pair(ARCH, "bfloat16")
    toks = jnp.asarray(tokens(cfg, (2, 16), 1))
    vis = jnp.asarray(_vision(cfg, 2, 3, ml_dtypes.bfloat16))
    ref = strict(lambda p, t, v: JM.forward(p, jcfg, t, vision_embeds=v,
                                            use_kernel=use_kernel),
                 jp, toks, vis)
    got = make_prefill_step(cfg, ServeOptions(use_kernel=use_kernel))(
        model, torch.from_numpy(np.array(toks)).long(),
        vision_embeds=tensor_from_numpy(np.array(vis)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(ref(jp, toks, vis)),
                               **MODEL_TOL)


def test_default_positions_are_three_equal_streams():
    cfg = configs.get_smoke(ARCH)
    pos = M.positions_for(cfg, 5)
    assert pos.shape == (3, 1, 5)
    assert all(torch.equal(pos[i, 0], torch.arange(5, dtype=torch.int32))
               for i in range(3))
    assert M.positions_for(configs.get_smoke("qwen3-14b"), 5).shape == (1, 5)


def test_teacher_forced_decode_vs_reference():
    """Text-only, as the reference's decode step takes no vision input."""
    cache, _ = decode_vs_reference(ARCH)
    assert cache["layers"][-1]["attn"]["len"] == 15


def test_launcher_generate_f32_matches_kernel_prefill():
    cfg = configs.get_smoke(ARCH)
    g = torch.Generator().manual_seed(0)
    state = M.init_params(cfg, generator=g).state_dict()
    model = M.from_state(cfg, {k: t.float() for k, t in state.items()})
    prompts = torch.randint(2, cfg.vocab_size, (2, 12), generator=g)
    out, logits = launcher.generate(model, cfg, prompts, 5)
    assert out.shape == (2, 5) and logits.dtype == torch.float32
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


def test_param_count():
    assert configs.get_config(ARCH).param_count() == 7_615_487_488
    assert jconfigs.get_config(ARCH).param_count() == 7_615_487_488
