"""The port's selective-scan op against the JAX package's.

The reference's ``kernels.mamba_scan.ops.selective_scan`` runs its
Pallas kernel in interpret mode on the CPU; the port's wrappers run the
kernel's plain version there.  Inputs come from a numpy seed as the
reference's own sweep draws them (tests/test_kernels.py:172-184): xc, B,
C normal, dt = 0.1 |normal|, A = -exp(normal), D normal.  Tolerances are
the reference's kernel tolerances: ``2e-5`` when the inputs are float32,
``2e-2`` when they are bfloat16 (the reference's oracle rounds dt * x to
bf16, its kernel does not); gradients in float32 within ``1e-4``.  With
the f32 model's mix (bf16 dt, f32 xc, B, C) both sides widen the same
values and compute in f32, so the float32 tolerance holds.  The CUDA
kernel is held against the plain version in tests/test_torch_cuda.py.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.mamba_scan import ops as jops
from repro.kernels.mamba_scan.ref import selective_scan_ref as jscan_ref

from repro_torch import cuda
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.kernel import (selective_scan_bdt,
                                                   selective_scan_plain)
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
# the reference's sweep (tests/test_kernels.py:172-173): B, T, Di, S, bt
SWEEP = [(1, 16, 8, 4, 8), (2, 64, 32, 8, 16), (1, 128, 64, 16, 64),
         (2, 48, 24, 8, 16)]


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


def _inputs(rng, B, T, Di, S, x="float32", dt="float32"):
    """numpy xc, dt, B, C, A, D: xc, B and C in ``x``, dt in ``dt``, A and
    D f32."""
    xc = _cast(rng.normal(size=(B, T, Di)), x)
    dtv = _cast(np.abs(rng.normal(size=(B, T, Di))) * 0.1, dt)
    bm = _cast(rng.normal(size=(B, T, S)), x)
    cm = _cast(rng.normal(size=(B, T, S)), x)
    A = -np.exp(rng.normal(size=(Di, S)).astype(np.float32))
    D = rng.normal(size=(Di,)).astype(np.float32)
    return xc, dtv, bm, cm, A, D


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _torch(*arrays):
    return [tensor_from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,Di,S,bt", SWEEP)
def test_scan_sweep_vs_reference(B, T, Di, S, bt, dtype):
    """The op, the kernel wrapper and the plain version against the
    reference's op (its Pallas kernel in interpret mode)."""
    rng = np.random.default_rng(T + Di + S)
    args = _inputs(rng, B, T, Di, S, dtype, dtype)
    want = jops.selective_scan(*(jnp.asarray(a) for a in args), bt)
    tol = F32 if dtype == "float32" else BF16
    for fn in (lambda *a: ops.selective_scan(*a, bt), selective_scan_bdt,
               selective_scan_plain):
        got = fn(*_torch(*args))
        assert got.dtype == torch.float32 and got.shape == (B, T, Di)
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_scan_model_mixed_dtypes_vs_reference():
    """bf16 dt with f32 xc, B and C, as the f32 model calls it
    (models/mamba.py), at the model's state size 16."""
    rng = np.random.default_rng(1)
    args = _inputs(rng, 2, 64, 48, 16, "float32", "bfloat16")
    want = jops.selective_scan(*(jnp.asarray(a) for a in args), 32)
    got = ops.selective_scan(*_torch(*args))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)


@pytest.mark.parametrize("T", [1, 50, 100])
def test_scan_any_length_vs_reference_oracle(T):
    """T need not be a multiple of the reference's block_t (its kernel
    asserts that; the function does not): held against its oracle."""
    rng = np.random.default_rng(T)
    args = _inputs(rng, 2, T, 24, 8)
    want, _ = jscan_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(_f32(ops.selective_scan(*_torch(*args))),
                               _f32(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_ref_state_vs_reference(dtype):
    """The oracle from a given state: y and the final state h."""
    rng = np.random.default_rng(2)
    args = _inputs(rng, 2, 24, 16, 8, dtype, dtype)
    h0 = rng.normal(size=(2, 16, 8)).astype(np.float32)
    want_y, want_h = jscan_ref(*(jnp.asarray(a) for a in args),
                               h0=jnp.asarray(h0))
    y, h = selective_scan_ref(*_torch(*args), h0=torch.from_numpy(h0))
    assert y.dtype == h.dtype == torch.float32 and h.shape == (2, 16, 8)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_f32(y), _f32(want_y), **tol)
    np.testing.assert_allclose(_f32(h), _f32(want_h), **tol)
    # the plain version is the oracle's y from a zero state on the
    # inputs widened to f32 (the kernel's dt * x is an f32 product)
    xc, dt, bm, cm, A, D = _torch(*args)
    y0, _ = selective_scan_ref(xc.float(), dt.float(), bm.float(),
                               cm.float(), A, D)
    assert torch.equal(selective_scan_plain(xc, dt, bm, cm, A, D), y0)


def test_scan_grad_vs_reference():
    """f32 gradients of all six inputs (the backward recomputes through
    the oracle, as the reference's custom_vjp does)."""
    rng = np.random.default_rng(3)
    args = _inputs(rng, 1, 16, 8, 4)
    g = rng.normal(size=args[0].shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jops.selective_scan(*a, 8),
                     *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    ops.selective_scan(*ts, 8).backward(torch.from_numpy(g))
    for t, w, name in zip(ts, want, ("xc", "dt", "B", "C", "A", "D")):
        np.testing.assert_allclose(_f32(t.grad), _f32(w), atol=1e-4,
                                   rtol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["ndim", "dt shape", "C shape", "A shape",
                                  "float16", "int", "A bfloat16",
                                  "B/C differ", "B/C not xc's"])
def test_scan_rejects_bad_inputs(case):
    xc, dt, bm, cm, A, D = _torch(*_inputs(np.random.default_rng(4), 1, 8,
                                           4, 4))
    err = ValueError
    if case == "ndim":
        xc = xc[0]
    elif case == "dt shape":
        dt = dt[:, :4]
    elif case == "C shape":
        cm = cm[..., :2]
    elif case == "A shape":
        A = A[:2]
    elif case == "float16":
        xc, err = xc.half(), TypeError
    elif case == "int":
        dt, err = dt.int(), TypeError
    elif case == "A bfloat16":
        A, err = A.bfloat16(), TypeError
    elif case == "B/C differ":
        cm, err = cm.bfloat16(), TypeError
    else:
        bm, cm, err = bm.bfloat16(), cm.bfloat16(), TypeError
    for fn in (selective_scan_bdt, ops.selective_scan):
        with pytest.raises(err, match="mamba_scan|dtype"):
            fn(xc, dt, bm, cm, A, D)


def test_scan_cpu_counts_no_launch():
    args = _torch(*_inputs(np.random.default_rng(5), 1, 8, 4, 4))
    before = dict(cuda.LAUNCHES)
    ops.selective_scan(*args)
    selective_scan_bdt(*args)
    assert cuda.LAUNCHES == before and "mamba_scan" in before
