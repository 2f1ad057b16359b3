"""The port's MoE feed-forward (routing, dense dispatch, capacity
dispatch, the held share of the experts) against the JAX package's.

The layer gets the reference's seeded ``moe.init`` weights; a share that
holds experts [lo, hi) gets their rows of the stacked ``w_gate`` /
``w_up`` / ``w_down`` and the whole router.  Tolerances:

- float32: ``atol = rtol = 1e-5`` (reduction order only; the outputs are
  of order 1-10 at these widths);
- bfloat16: the reference's model tolerance, ``atol 0.15, rtol 0.05``,
  against the reference compiled with XLA's excess precision off;
- the share against the reference with the other experts' ``w_down``
  zeroed, and the two shares' sum against the whole layer: float32,
  ``1e-5``.

The capacity dispatch is checked where it drops: 16 experts, top-2, 4
tokens and factor 2 give C = int(4 * 2 / 16 * 2) = 1, so any two
(token, slot) pairs that pick one expert keep only the first.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import moe as jmoe
from repro.models.config import MoEConfig as JMoEConfig

from repro_torch.convert import tensor_from_numpy
from repro_torch.models import moe
from repro_torch.models.common import dense_init_
from repro_torch.models.config import MoEConfig

F32 = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=0.15, rtol=0.05)
D_MODEL = 32
CONFIGS = {
    "jamba": dict(n_experts=16, top_k=2, d_expert=24),
    "top-3, scaled": dict(n_experts=8, top_k=3, d_expert=16,
                          route_scale=2.5),
}


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


def _pair(name, dtype="float32", held=None, seed=0):
    """(jax cfg, jax params, port cfg, port layer holding ``held``)."""
    jcfg = JMoEConfig(**CONFIGS[name])
    jp = jmoe.init(jax.random.key(seed), jcfg, D_MODEL)
    if dtype == "float32":
        jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    return jcfg, jp, *_port(jcfg, jp, held)


def _port(jcfg, jp, held):
    cfg = MoEConfig(**dataclasses.asdict(jcfg), held=held)
    lo, hi = cfg.held_range()
    layer = moe.MoE(cfg, D_MODEL, device="meta")
    state = {}
    for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        name = ".".join(p.key for p in k)
        a = np.asarray(v)
        state[name] = tensor_from_numpy(a[lo:hi] if name in (
            "w_gate", "w_up", "w_down") else a)
    layer.load_state_dict(state, assign=True)
    return cfg, layer.requires_grad_(False)


def _x(shape, dtype, seed):
    a = np.random.default_rng(seed).normal(size=shape + (D_MODEL,))
    return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                    else np.float32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_route_vs_reference(name):
    jcfg, jp, cfg, layer = _pair(name)
    x = _x((40,), "float32", 1)
    jw, jidx, jprobs = jmoe.route(jp, jcfg, jnp.asarray(x))
    w, idx, probs = moe.route(layer, cfg, torch.from_numpy(x))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_f32(w), _f32(jw), **F32)
    np.testing.assert_allclose(_f32(probs), _f32(jprobs), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("path", ["forward", "forward_dropless"])
def test_moe_vs_reference(path, name, dtype):
    """Both dispatches of the whole layer; the dense one in chunks of 8
    rows here, so the chunking is crossed."""
    jcfg, jp, cfg, layer = _pair(name, dtype)
    x = _x((3, 7), dtype, 2)
    kw = {} if path == "forward" else {"capacity_factor": 1.25}
    ref = _strict(lambda p, a: getattr(jmoe, path)(p, jcfg, a, **kw), jp,
                  jnp.asarray(x))
    want = ref(jp, jnp.asarray(x))
    chunk = moe.DENSE_CHUNK
    try:
        moe.DENSE_CHUNK = 8
        got = getattr(moe, path)(layer, cfg, tensor_from_numpy(x), **kw)
    finally:
        moe.DENSE_CHUNK = chunk
    assert str(got.dtype) == f"torch.{dtype}" and got.shape == (3, 7, D_MODEL)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(F32 if dtype == "float32" else MODEL_TOL))


def _drops(cfg, layer, x, factor):
    """(token, slot) pairs the capacity dispatch drops."""
    _, idx, _ = moe.route(layer, cfg, x.reshape(-1, D_MODEL))
    C = max(1, int(idx.shape[0] * cfg.top_k / cfg.n_experts * factor))
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    return int((counts - C).clamp_min(0).sum())


def test_capacity_dispatch_drops_vs_reference():
    """Batch 4, one token each, 16 experts at factor 2 (decode's): C = 1,
    and these tokens collide, so pairs drop, in the reference as here."""
    jcfg, jp, cfg, layer = _pair("jamba")
    x = _x((4, 1), "float32", 3)
    assert _drops(cfg, layer, torch.from_numpy(x), 2.0) > 0
    want = jmoe.forward_dropless(jp, jcfg, jnp.asarray(x),
                                 capacity_factor=2.0)
    got = moe.forward_dropless(layer, cfg, torch.from_numpy(x),
                               capacity_factor=2.0)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)
    dense = jmoe.forward(jp, jcfg, jnp.asarray(x))
    assert not np.allclose(_f32(got), _f32(dense), **F32)


def _zero_down_outside(jp, lo, hi):
    down = np.array(jp["w_down"])
    down[:lo] = 0
    down[hi:] = 0
    return dict(jp, w_down=jnp.asarray(down))


@pytest.mark.parametrize("path,factor", [("forward", None),
                                         ("forward_dropless", 2.0),
                                         ("forward_dropless", 0.5)])
def test_shares_add_up_to_the_whole_layer(path, factor):
    """Experts [0, 8) and [8, 16) each equal the reference with the other
    experts' w_down zeroed (it routes over all 16 and adds only its
    own), and the two shares add up to the whole layer.  The capacity
    dispatch buckets over all 16 experts on either share, so a pair
    dropped in the whole layer drops in its share too (factor 0.5 drops
    many here)."""
    jcfg, jp, cfg, whole = _pair("jamba")
    x = torch.from_numpy(_x((4, 1) if factor == 2.0 else (3, 6),
                            "float32", 4))
    kw = {} if factor is None else {"capacity_factor": factor}
    if factor is not None:
        assert _drops(cfg, whole, x, factor) > 0
    outs = []
    for lo, hi in ((0, 8), (8, 16)):
        hcfg, share = _port(jcfg, jp, (lo, hi))
        assert share.w_gate.shape[0] == share.w_down.shape[0] == hi - lo
        got = getattr(moe, path)(share, hcfg, x, **kw)
        want = getattr(jmoe, path)(_zero_down_outside(jp, lo, hi), jcfg,
                                   jnp.asarray(x.numpy()), **kw)
        np.testing.assert_allclose(_f32(got), _f32(want), **F32,
                                   err_msg=f"experts [{lo}, {hi})")
        outs.append(got)
    np.testing.assert_allclose(_f32(outs[0] + outs[1]),
                               _f32(getattr(moe, path)(whole, cfg, x, **kw)),
                               **F32)


def test_held_init_draws_at_the_published_scale():
    """A share of 8 of 16 experts draws its stacks with std 16^-1/2, the
    reference's fan-in of the whole [16, ...] stack, not 8^-1/2; the
    router keeps all 16 columns, bf16 values in f32."""
    cfg = MoEConfig(n_experts=16, top_k=2, d_expert=96, held=(8, 16))
    p = moe.init(cfg, 64, generator=torch.Generator().manual_seed(0))
    p.requires_grad_(False)
    assert p.w_gate.shape == (8, 64, 96) and p.w_down.shape == (8, 96, 64)
    for w in (p.w_gate, p.w_up, p.w_down):
        assert float(w.float().std()) == pytest.approx(0.25, rel=0.02)
    assert p.router.shape == (64, 16) and p.router.dtype == torch.float32
    assert torch.equal(p.router, p.router.bfloat16().float())
    assert float(p.router.std()) == pytest.approx(64 ** -0.5, rel=0.1)
    # the reference's own stacks, drawn whole
    jp = jmoe.init(jax.random.key(0), JMoEConfig(16, 2, 96), 64)
    for k in ("w_gate", "w_up", "w_down"):
        assert float(np.asarray(jp[k], np.float32).std()) == pytest.approx(
            0.25, rel=0.02)


def test_dense_init_fan_in():
    """``fan_in`` overrides the leading dim as the scale's count."""
    w = torch.empty(8, 256, 64)
    dense_init_(w, torch.Generator().manual_seed(0), fan_in=16)
    assert float(w.std()) == pytest.approx(0.25, rel=0.02)
    dense_init_(w, torch.Generator().manual_seed(0))
    assert float(w.std()) == pytest.approx(8 ** -0.5, rel=0.02)


@pytest.mark.parametrize("held", [(0, 0), (4, 17), (-1, 2)])
def test_held_range_rejects_bad_ranges(held):
    with pytest.raises(ValueError, match="held experts"):
        moe.MoE(MoEConfig(16, 2, 8, held=held), 8, device="meta")
