"""Shared pieces of the arch tests (tests/test_torch_{moonshot,mla,
qwen2_vl,whisper}.py): the port's smoke model with the reference's
seeded weights, the strict reference build, and the teacher-forced
decode comparison.

Tolerances: float32 ``atol = rtol = 1e-4`` (reduction order only);
bfloat16 and decode the reference's model tolerance, ``atol 0.15, rtol
0.05`` (tests/test_kernels.py:161), against the reference compiled with
XLA's excess precision off (see tests/test_torch_model.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import model as JM

from repro_torch import configs
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.models import model as M
from repro_torch.serve import (ServeOptions, init_serve_cache,
                               make_decode_step)

MODEL_TOL = dict(atol=0.15, rtol=0.05)
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def normal(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def strict(fn, *args):
    """``fn`` compiled with every bf16 op rounded to bf16 (XLA's excess
    precision off)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def pair(arch, dtype):
    """(jax cfg, jax params, port cfg, port model) with equal weights."""
    jcfg = jconfigs.get_smoke(arch)
    jp = JM.init_params(jax.random.key(0), jcfg)
    if dtype == "float32":
        jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    cfg = configs.get_smoke(arch)
    model = M.from_state(cfg, params_from_jax(jax.tree.map(np.asarray, jp)))
    return jcfg, jp, cfg, model.requires_grad_(False)


def decode_vs_reference(arch, *, B=2, P=10, G=6, frames=None):
    """Teacher-forced bf16 decode, step by step at the model tolerance,
    both packages fed the reference's tokens.  For an encoder-decoder
    the reference encodes ``frames`` and both packages' steps read that
    one encoder output: the encoders are held apart
    (tests/test_torch_whisper.py), and their outputs differ by a bf16 ulp
    in places (two roundings of one value), which a decode step's
    logits carry up to about 0.2 at the smoke size.  Returns the two
    final caches (port, reference)."""
    jcfg, jp, cfg, model = pair(arch, "bfloat16")
    prompts = tokens(cfg, (B, P), 4)
    jcache = JM.init_cache(jcfg, B, P + G)
    jcross = cross = None
    jargs = (jp, jcache, jnp.asarray(prompts[:, :1]))
    if frames is not None:
        jf = jnp.asarray(frames)
        jcross = strict(lambda p, f: JM.encode(p, jcfg, f), jp, jf)(jp, jf)
        cross = tensor_from_numpy(np.asarray(jcross))
        jstep = strict(lambda p, c, t, s: JM.decode_step(p, jcfg, c, t,
                                                         cross_src=s),
                       *jargs, jcross)
    else:
        jstep = strict(lambda p, c, t: JM.decode_step(p, jcfg, c, t), *jargs)
    cache = init_serve_cache(cfg, B, P + G)
    decode = make_decode_step(cfg, ServeOptions())
    tok = prompts[:, :1]
    for i in range(P + G - 1):
        a = (jp, jcache, jnp.asarray(tok))
        jlogits, jcache = jstep(*a) if jcross is None else jstep(*a, jcross)
        nxt, cache, logits = decode(model, cache,
                                    torch.from_numpy(tok.copy()).long(),
                                    cross)
        np.testing.assert_allclose(f32(logits), f32(jlogits[:, -1]),
                                   **MODEL_TOL, err_msg=f"step {i}")
        assert nxt.shape == (B, 1) and nxt.dtype == torch.int32
        tok = (prompts[:, i + 1: i + 2] if i + 1 < P else
               np.asarray(jnp.argmax(jlogits[:, -1], -1), np.int32)[:, None])
    return cache, jcache
