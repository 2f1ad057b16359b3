"""The port's wkv6 op against the JAX package's.

The reference's ``kernels.wkv6.ops.wkv6`` runs its Pallas kernel in
interpret mode on the CPU; the port's wrappers run the kernel's plain
version there.  Inputs come from a numpy seed, w as exp(-exp(normal)) in
(0, 1) as the reference's own sweep draws it.  Tolerances are the
reference's kernel tolerances (tests/test_kernels.py): ``2e-5`` when the
inputs are float32, ``2e-2`` when they are bfloat16 (either side of one
rounding of an f32 result); gradients in float32 within ``1e-4``.  With
the model's mixed dtypes (bf16 r/k/v, f32 w and u) both sides widen the
same values to f32 and compute in f32, so the float32 tolerance holds.
The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.wkv6 import ops as jops
from repro.kernels.wkv6.ref import wkv6_ref as jwkv6_ref

from repro_torch import cuda
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.wkv6 import ops
from repro_torch.kernels.wkv6.kernel import wkv6_bthn, wkv6_plain
from repro_torch.kernels.wkv6.ref import wkv6_ref

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
# the reference's sweep (tests/test_kernels.py:82-84): B, T, H, N, block_t
SWEEP = [(1, 16, 1, 8, 8), (2, 64, 3, 16, 16), (1, 128, 2, 32, 64),
         (2, 48, 4, 8, 16)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cast(a, dtype):
    return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                    else np.float32)


def _inputs(rng, B, T, H, N, rkv="float32", wdt="float32"):
    """numpy r, k, v in ``rkv``, w in ``wdt``, u f32."""
    r, k, v = (_cast(rng.normal(size=(B, T, H, N)), rkv) for _ in range(3))
    w = _cast(np.exp(-np.exp(rng.normal(size=(B, T, H, N))
                             .astype(np.float32))), wdt)
    u = rng.normal(size=(H, N)).astype(np.float32)
    return r, k, v, w, u


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _torch(*arrays):
    return [tensor_from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,N,bt", SWEEP)
def test_wkv6_sweep_vs_reference(B, T, H, N, bt, dtype):
    """The op and the kernel wrapper against the reference's op (its
    Pallas kernel in interpret mode)."""
    rng = np.random.default_rng(T + H + N)
    args = _inputs(rng, B, T, H, N, dtype, dtype)
    want = jops.wkv6(*(jnp.asarray(a) for a in args), bt)
    tol = F32 if dtype == "float32" else BF16
    for fn in (lambda *a: ops.wkv6(*a, bt), wkv6_bthn):
        got = fn(*_torch(*args))
        assert got.dtype == torch.float32 and got.shape == (B, T, H, N)
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_wkv6_model_mixed_dtypes_vs_reference():
    """bf16 r/k/v with f32 w and u, as the model calls it
    (models/rwkv.py), at the model's head size 64."""
    rng = np.random.default_rng(1)
    args = _inputs(rng, 2, 64, 2, 64, "bfloat16", "float32")
    want = jops.wkv6(*(jnp.asarray(a) for a in args), 32)
    got = ops.wkv6(*_torch(*args))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)


@pytest.mark.parametrize("T", [1, 50])
def test_wkv6_any_length_vs_reference_oracle(T):
    """T need not be a multiple of the reference's block_t (its kernel
    asserts that; the function does not): held against its oracle."""
    rng = np.random.default_rng(T)
    args = _inputs(rng, 2, T, 3, 16)
    want, _ = jwkv6_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(_f32(ops.wkv6(*_torch(*args))), _f32(want),
                               **F32)


def test_wkv6_ref_state_vs_reference():
    """The oracle from a given state: y and the final state."""
    rng = np.random.default_rng(2)
    args = _inputs(rng, 2, 24, 3, 16)
    s0 = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
    want_y, want_s = jwkv6_ref(*(jnp.asarray(a) for a in args),
                               s0=jnp.asarray(s0))
    y, s = wkv6_ref(*_torch(*args), s0=torch.from_numpy(s0))
    assert y.dtype == s.dtype == torch.float32 and s.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(_f32(y), _f32(want_y), **F32)
    np.testing.assert_allclose(_f32(s), _f32(want_s), **F32)
    # the plain version is the oracle's y from a zero state
    y0, _ = wkv6_ref(*_torch(*args))
    assert torch.equal(wkv6_plain(*_torch(*args)), y0)


def test_wkv6_grad_vs_reference():
    """f32 gradients of all five inputs (the backward recomputes through
    the oracle, as the reference's custom_vjp does)."""
    rng = np.random.default_rng(3)
    args = _inputs(rng, 1, 16, 2, 8)
    g = rng.normal(size=args[0].shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jops.wkv6(*a, 8),
                     *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    ops.wkv6(*ts, 8).backward(torch.from_numpy(g))
    for t, w, name in zip(ts, want, "rkvwu"):
        np.testing.assert_allclose(_f32(t.grad), _f32(w), atol=1e-4,
                                   rtol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["ndim", "k shape", "u shape", "float16",
                                  "int", "u float64", "r/k/v differ"])
def test_wkv6_rejects_bad_inputs(case):
    r, k, v, w, u = _torch(*_inputs(np.random.default_rng(4), 1, 8, 2, 8))
    err = ValueError
    if case == "ndim":
        r = r[0]
    elif case == "k shape":
        k = k[:, :4]
    elif case == "u shape":
        u = u[:, :4]
    elif case == "float16":
        r, err = r.half(), TypeError
    elif case == "int":
        v, err = v.int(), TypeError
    elif case == "r/k/v differ":
        k, err = k.bfloat16(), TypeError
    else:
        u, err = u.double(), TypeError
    for fn in (wkv6_bthn, ops.wkv6):
        with pytest.raises(err, match="wkv6|dtype"):
            fn(r, k, v, w, u)


def test_wkv6_cpu_counts_no_launch():
    args = _torch(*_inputs(np.random.default_rng(5), 1, 8, 2, 8))
    before = dict(cuda.LAUNCHES)
    ops.wkv6(*args)
    wkv6_bthn(*args)
    assert cuda.LAUNCHES == before and "wkv6" in before
