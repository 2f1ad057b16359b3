"""The port's mamba mixer (conv, scan inputs, both scan paths, O(1)-state
decode) against the JAX package's.

Layer 0 of the jamba smoke config gets the reference's seeded
``init_params`` weights through ``convert.params_from_jax`` (bf16
projections, conv and inner norms; f32 ``dt_bias``, ``A_log``, ``D``).
Tolerances:

- float32 (both trees cast to f32): ``atol = rtol = 1e-4``, reduction
  order only;
- bfloat16: the reference's model tolerance, ``atol 0.15, rtol 0.05``
  (tests/test_kernels.py:159), against the reference compiled with XLA's
  excess precision off (see tests/test_torch_model.py);
- the depthwise conv in bf16: bit for bit (a sum of K bf16 products,
  each op rounded, on both sides).

Each path is held against the reference's same path: the kernel path
(dt rounded to bf16, the reference's Pallas kernel in interpret mode,
the port's kernel's plain version on the CPU) and the plain scan (dt, B,
C in f32).
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import mamba as jmamba
from repro.models import model as JM

from repro_torch import configs
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.models import mamba
from repro_torch.models import model as M

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


def _strict(fn, *args):
    """``fn`` compiled with every bf16 op rounded to bf16."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _layer0(dtype):
    """(jax mamba cfg, jax layer-0 mamba params, port cfg, port module)
    with equal weights."""
    jcfg = jconfigs.get_smoke(ARCH)
    jp = JM.init_params(jax.random.key(0), jcfg)
    if dtype == "float32":
        jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    cfg = configs.get_smoke(ARCH)
    model = M.from_state(cfg, params_from_jax(jax.tree.map(np.asarray, jp)))
    jl = jax.tree.map(lambda a: a[0], jp["periods"]["b0"]["mamba"])
    return jcfg.mamba, jl, cfg, model.layers[0].mamba


def _x(cfg, shape, dtype, seed):
    a = np.random.default_rng(seed).normal(size=shape + (cfg.d_model,))
    return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                    else np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_forward_vs_reference(dtype, use_kernel):
    jmc, jl, cfg, layer = _layer0(dtype)
    x = _x(cfg, (2, 16), dtype, 1)
    ref = _strict(lambda p, a: jmamba.forward(p, jmc, a, eps=cfg.norm_eps,
                                              use_kernel=use_kernel),
                  jl, jnp.asarray(x))
    want = ref(jl, jnp.asarray(x))
    with torch.no_grad():
        got = mamba.forward(layer, cfg.mamba, tensor_from_numpy(x),
                            eps=cfg.norm_eps, use_kernel=use_kernel)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = F32_TOL if dtype == "float32" else MODEL_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_mamba_paths_differ_by_dt_rounding_only():
    """In f32 the kernel path rounds dt to bf16 and the plain path does
    not (the reference's two paths do the same): the two agree to the
    model tolerance but not bit for bit."""
    _, _, cfg, layer = _layer0("float32")
    x = tensor_from_numpy(_x(cfg, (2, 16), "float32", 2))
    with torch.no_grad():
        a = mamba.forward(layer, cfg.mamba, x, use_kernel=True)
        b = mamba.forward(layer, cfg.mamba, x, use_kernel=False)
    np.testing.assert_allclose(_f32(a), _f32(b), **MODEL_TOL)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("carry", [False, True])
def test_conv_bit_for_bit_bf16(carry):
    """The depthwise conv in bf16: each product and partial sum rounded,
    as the reference's Python sum does (F.conv1d rounds once)."""
    rng = np.random.default_rng(3)
    bf = ml_dtypes.bfloat16
    x = rng.normal(size=(2, 9, 24)).astype(bf)
    w = (rng.normal(size=(4, 24)) * 0.5).astype(bf)
    b = (rng.normal(size=(24,)) * 0.1).astype(bf)
    c = rng.normal(size=(2, 3, 24)).astype(bf) if carry else None
    ref = _strict(lambda *a: jmamba._conv(*a), *(jnp.asarray(t) for t in
                                                 (x, w, b, c) if t is not None))
    want_y, want_c = ref(*(jnp.asarray(t) for t in (x, w, b, c)
                           if t is not None))
    got_y, got_c = mamba._conv(*(tensor_from_numpy(t) if t is not None
                                 else None for t in (x, w, b, c)))
    assert got_y.dtype == torch.bfloat16
    assert np.array_equal(_f32(got_y), _f32(want_y))
    assert np.array_equal(_f32(got_c), _f32(want_c))


def test_softplus_matches_jax():
    x = np.linspace(-40, 40, 1001).astype(np.float32)
    np.testing.assert_allclose(
        mamba.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_vs_reference(dtype):
    """Five decode steps of one layer: output, h and the conv window,
    which stays bf16 on both sides whatever the weights' dtype."""
    jmc, jl, cfg, layer = _layer0(dtype)
    jstate = jmamba.init_state(jmc, 2, cfg.d_model)
    state = mamba.init_state(cfg.mamba, 2, cfg.d_model)
    jstep = _strict(lambda p, a, s: jmamba.decode_step(p, jmc, a, s,
                                                       eps=cfg.norm_eps),
                    jl, jnp.asarray(_x(cfg, (2, 1), dtype, 0)), jstate)
    tol = F32_TOL if dtype == "float32" else MODEL_TOL
    for i in range(5):
        x = _x(cfg, (2, 1), dtype, 10 + i)
        want, jstate = jstep(jl, jnp.asarray(x), jstate)
        with torch.no_grad():
            got, state = mamba.decode_step(layer, cfg.mamba,
                                           tensor_from_numpy(x), state,
                                           eps=cfg.norm_eps)
        np.testing.assert_allclose(_f32(got), _f32(want), **tol,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(_f32(state["h"]), _f32(jstate["h"]),
                                   **tol, err_msg=f"h, step {i}")
        assert state["conv"].dtype == torch.bfloat16
        assert state["h"].dtype == torch.float32
        np.testing.assert_allclose(_f32(state["conv"]),
                                   _f32(jstate["conv"]), **tol)


def test_decode_steps_follow_the_plain_forward():
    """Decode over a sequence, token by token from a zero state, gives
    the plain forward's outputs (bf16 weights: both round the same ops;
    the conv window is bf16 as the activations are)."""
    _, _, cfg, layer = _layer0("bfloat16")
    x = tensor_from_numpy(_x(cfg, (2, 12), "bfloat16", 4))
    state = mamba.init_state(cfg.mamba, 2, cfg.d_model)
    outs = []
    with torch.no_grad():
        for t in range(12):
            y, state = mamba.decode_step(layer, cfg.mamba, x[:, t:t + 1],
                                         state)
            outs.append(y)
        full = mamba.forward(layer, cfg.mamba, x)
    np.testing.assert_allclose(_f32(torch.cat(outs, 1)), _f32(full),
                               **MODEL_TOL)


def test_plain_scan_remat_grad_matches_unchunked():
    """Under autograd the plain scan runs in rematerialised chunks; its
    gradient equals the unchunked recurrence's."""
    _, _, cfg, layer = _layer0("float32")
    x = tensor_from_numpy(_x(cfg, (1, 150), "float32", 5))
    xa = x.clone().requires_grad_()
    mamba.forward(layer, cfg.mamba, xa).square().sum().backward()
    chunk = mamba.REMAT_CHUNK
    try:
        mamba.REMAT_CHUNK = 10 ** 6
        xb = x.clone().requires_grad_()
        mamba.forward(layer, cfg.mamba, xb).square().sum().backward()
    finally:
        mamba.REMAT_CHUNK = chunk
    np.testing.assert_allclose(_f32(xa.grad), _f32(xb.grad), rtol=1e-5,
                               atol=1e-6)


def test_init_distributions():
    """The port's own init takes the reference's dtypes and
    distributions."""
    cfg = configs.get_smoke(ARCH)
    p = mamba.init(cfg.mamba, cfg.d_model,
                   generator=torch.Generator().manual_seed(0))
    p.requires_grad_(False)
    Di, S = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    assert p.w_in.dtype == p.conv_w.dtype == p.w_out.dtype == torch.bfloat16
    assert p.A_log.dtype == p.D.dtype == p.dt_bias.dtype == torch.float32
    A = -torch.exp(p.A_log)
    assert torch.allclose(A, -torch.arange(1, S + 1.0).expand(Di, S))
    assert bool((p.D == 1).all()) and not p.conv_b.any()
    dt = torch.nn.functional.softplus(p.dt_bias)
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001
    assert float(p.conv_w.float().std()) == pytest.approx(0.5, rel=0.15)
    assert float(p.w_in.float().std()) == pytest.approx(
        cfg.d_model ** -0.5, rel=0.1)
