"""The port's rmsnorm kernels against the JAX package's Pallas kernels.

``rmsnorm`` and the fused allreduce epilogue ``rmsnorm_allreduce`` are
compared, forward and backward, with the reference's
``kernels.rmsnorm.ops`` run in Pallas interpret mode on the CPU (the
port runs the kernels' plain versions there).  Inputs come from a numpy
seed.  Tolerances: float32 ``rtol = atol = 1e-5`` (the mean and the
P-sum are reduced in another order); bfloat16 within one bf16 ulp (both
round one f32 result).  The CUDA kernels are held against their plain
versions in tests/test_torch_cuda.py.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.rmsnorm import ops as jops

from repro_torch import cuda
from repro_torch.convert import scale_from_numpy, tensor_from_numpy
from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm.kernel import (rmsnorm_2d, rmsnorm_plain,
                                                rmsnorm_reduce_2d,
                                                rmsnorm_reduce_plain)

EPS = 1e-6
CASES = [(dt, gemma) for dt in ("float32", "bfloat16")
         for gemma in (False, True)]
IDS = [f"{dt}-{'gemma' if g else 'plain'}" for dt, g in CASES]


def _np(dtype, a):
    return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)


def _from_jax(x):
    return tensor_from_numpy(np.asarray(x))


def _ordered(bits):
    b = bits.astype(np.int32)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def _close(got: torch.Tensor, want: torch.Tensor, dtype: str, what: str):
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=what)
        return
    assert got.dtype == want.dtype == torch.bfloat16, what
    g = got.detach().contiguous().view(torch.int16).numpy().view(np.uint16)
    w = want.contiguous().view(torch.int16).numpy().view(np.uint16)
    ulps = np.abs(_ordered(g) - _ordered(w))
    assert ulps.max() <= 1, (what, int(ulps.max()))


@pytest.mark.parametrize("dtype,gemma", CASES, ids=IDS)
def test_rmsnorm_forward_and_grad_vs_reference(dtype, gemma):
    rng = np.random.default_rng(1)
    x = _np(dtype, rng.standard_normal((2, 8, 64)))
    scale = _np(dtype, 0.5 + 0.1 * rng.standard_normal(64))
    g = _np(dtype, rng.standard_normal(x.shape))
    y_j, vjp = jax.vjp(lambda a, s: jops.rmsnorm(a, s, EPS, gemma),
                       jnp.asarray(x), jnp.asarray(scale))
    gx_j, gs_j = vjp(jnp.asarray(g))

    xt = tensor_from_numpy(x).requires_grad_()
    st = scale_from_numpy(scale).requires_grad_()
    y = ops.rmsnorm(xt, st, EPS, gemma)
    y.backward(tensor_from_numpy(g))
    _close(y, _from_jax(y_j), dtype, "forward")
    _close(xt.grad, _from_jax(gx_j), dtype, "d x")
    _close(st.grad, _from_jax(gs_j), dtype, "d scale")


@pytest.mark.parametrize("dtype,gemma", CASES, ids=IDS)
def test_rmsnorm_allreduce_forward_and_grad_vs_reference(dtype, gemma):
    rng = np.random.default_rng(2)
    parts = _np(dtype, rng.standard_normal((4, 2, 8, 64)))
    scale = _np(dtype, 0.5 + 0.1 * rng.standard_normal(64))
    g = _np(dtype, rng.standard_normal(parts.shape[1:]))
    y_j, vjp = jax.vjp(
        lambda p, s: jops.rmsnorm_allreduce(p, s, EPS, gemma),
        jnp.asarray(parts), jnp.asarray(scale))
    gp_j, gs_j = vjp(jnp.asarray(g))

    pt = tensor_from_numpy(parts).requires_grad_()
    st = scale_from_numpy(scale).requires_grad_()
    y = ops.rmsnorm_allreduce(pt, st, EPS, gemma)
    y.backward(tensor_from_numpy(g))
    _close(y, _from_jax(y_j), dtype, "forward")
    _close(pt.grad, _from_jax(gp_j), dtype, "d parts")
    _close(st.grad, _from_jax(gs_j), dtype, "d scale")
    # the oracle: f32 sum rounded to the dtype, then the reference norm
    ref_j = jops.rmsnorm_allreduce_ref(jnp.asarray(parts), jnp.asarray(scale),
                                       eps=EPS, gemma_style=gemma)
    ref = ops.rmsnorm_allreduce_ref(tensor_from_numpy(parts),
                                    scale_from_numpy(scale), eps=EPS,
                                    gemma_style=gemma)
    _close(ref, _from_jax(ref_j), dtype, "oracle")


def test_cpu_wrappers_run_plain_versions_without_counting():
    rng = np.random.default_rng(3)
    parts = torch.from_numpy(rng.standard_normal((3, 5, 32))
                             .astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    before = dict(cuda.LAUNCHES)
    assert torch.equal(rmsnorm_reduce_2d(parts, scale),
                       rmsnorm_reduce_plain(parts, scale))
    assert torch.equal(rmsnorm_2d(parts[0], scale, gemma_style=True),
                       rmsnorm_plain(parts[0], scale, gemma_style=True))
    assert cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="device"):
        rmsnorm_2d(parts[0].to("meta"), scale.to("meta"))
