"""The port's flash-attention op against the JAX package's.

The reference's ``kernels.attention.ops.flash_attention`` runs its
Pallas kernels in interpret mode on the CPU; the port's wrappers run
the kernels' plain version there.  Inputs come from a numpy seed.
Tolerances are the reference's own kernel tolerances
(tests/test_kernels.py): ``atol = rtol = 3e-5`` in float32 (another
reduction and tile order of the online softmax), ``2e-2`` in bfloat16
(one rounding of an f32 result that may fall either side), gradients
in float32 within ``1e-5``.  The CUDA kernels are held against the
plain version in tests/test_torch_cuda.py.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.attention import ops as jops
from repro.kernels.attention.ref import attention_ref as jattention_ref

from repro_torch import cuda
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.kernel import (flash_attention_bshd,
                                                  flash_attention_plain)

F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(dtype, a):
    return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                    else np.float32)


def _qkv(rng, dtype, B, Sq, Sk, H, K, D):
    return (_np(dtype, rng.normal(size=(B, Sq, H, D))),
            _np(dtype, rng.normal(size=(B, Sk, K, D))),
            _np(dtype, rng.normal(size=(B, Sk, K, D))))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


SWEEP = [(1, 32, 1, 1, 16, 16, 16),       # minimal
         (2, 64, 4, 2, 32, 32, 32),       # GQA 2:1
         (1, 128, 8, 1, 64, 64, 32),      # MQA, rectangular blocks
         (2, 96, 6, 3, 32, 32, 48)]       # non-pow2 heads/blocks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,D,bq,bk", SWEEP)
def test_flash_attention_sweep_vs_reference(B, S, H, K, D, bq, bk, dtype):
    rng = np.random.default_rng(S + H + D)
    q, k, v = _qkv(rng, dtype, B, S, S, H, K, D)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), True, None, None, None, bq,
                                bk)
    got = ops.flash_attention(tensor_from_numpy(q), tensor_from_numpy(k),
                              tensor_from_numpy(v), True, None, None, None,
                              bq, bk)
    assert got.dtype == tensor_from_numpy(q).dtype
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("window,softcap,causal",
                         [(16, None, True), (None, 30.0, True),
                          (8, 50.0, True), (None, None, False),
                          (8, 50.0, False)])
def test_flash_attention_variants_vs_reference(window, softcap, causal):
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, "float32", 2, 64, 64, 4, 2, 32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, window, softcap,
                                None, 32, 32)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal, window, softcap,
                              None, 32, 32)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)


def test_flash_attention_grad_matches_reference():
    import jax
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, "float32", 1, 32, 32, 2, 1, 16)
    g = rng.normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jops.flash_attention(
        a, b, c, True, 8, 30.0, None, 16, 16), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ops.flash_attention(*ts, True, 8, 30.0, None, 16, 16).backward(
        torch.from_numpy(g))
    for t, w, name in zip(ts, want, "qkv"):
        np.testing.assert_allclose(_f32(t.grad), _f32(w), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_prologue_vs_reference(dtype):
    B, S, H, K, D = 2, 64, 4, 2, 32
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, dtype, B, S, S, H, K, D)
    rows = np.stack([rng.permutation(S) for _ in range(B)]).astype(np.int32)
    rows[:, ::8] = -1                               # 1/8 dropped slots
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = jops.gathered_attention_ref(jq, jk, jv, jnp.asarray(rows),
                                       causal=True, window=16, softcap=50.0)
    jkern = jops.flash_attention(jq, jk, jv, True, 16, 50.0, None, 32, 32,
                                 q_rows=jnp.asarray(rows))
    got = ops.flash_attention(tensor_from_numpy(q), tensor_from_numpy(k),
                              tensor_from_numpy(v), True, 16, 50.0, None,
                              32, 32, q_rows=torch.from_numpy(rows))
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    np.testing.assert_allclose(_f32(got), _f32(jkern), **tol)
    assert np.all(_f32(got)[rows < 0] == 0)         # dead rows exact 0
    # the port's oracle is the reference's oracle
    mine = ops.gathered_attention_ref(
        tensor_from_numpy(q), tensor_from_numpy(k), tensor_from_numpy(v),
        torch.from_numpy(rows), causal=True, window=16, softcap=50.0)
    np.testing.assert_allclose(_f32(mine), _f32(want), **tol)


def test_gather_prologue_grad_and_1d_rows():
    import jax
    B, S, H, K, D = 2, 32, 2, 1, 16
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, "float32", B, S, S, H, K, D)
    rows = rng.permutation(S).astype(np.int32)
    rows[::5] = -1
    f = lambda a: jnp.sum(jnp.square(jops.flash_attention(
        a, jnp.asarray(k), jnp.asarray(v), causal=True,
        q_rows=jnp.asarray(rows))))
    want = jax.grad(f)(jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_()
    out = ops.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                              causal=True, q_rows=torch.from_numpy(rows))
    out.square().sum().backward()
    np.testing.assert_allclose(_f32(qt.grad), _f32(want), atol=1e-5,
                               rtol=1e-5)


def test_fully_masked_rows_match_reference():
    """A window with Sq >= Sk + window leaves rows with no live key; the
    reference weighs every masked key equally there (not 0)."""
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, "float32", 1, 64, 16, 2, 2, 16)
    want = jattention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, window=4)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), True, 4, None, None, 16,
                              16)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)


def test_block_contract_and_input_errors():
    z = torch.zeros(1, 48, 2, 16)
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(z, z, z, True, None, None, None, 32, 32)
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention_bshd(torch.zeros(1, 32, 3, 16), z[:, :32],
                             z[:, :32])
    with pytest.raises(ValueError, match="softcap"):
        flash_attention_bshd(z, z, z, softcap=0.0)
    with pytest.raises(ValueError, match="q_rows"):
        flash_attention_bshd(z, z, z, q_rows=torch.zeros(1, 3,
                                                         dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        flash_attention_bshd(z.to("meta"), z.to("meta"), z.to("meta"))


def test_cpu_wrapper_runs_plain_version_without_counting():
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(rng, "float32", 1, 32, 32, 4, 2, 16))
    rows = torch.from_numpy(rng.permutation(32).astype(np.int32))[None]
    before = dict(cuda.LAUNCHES)
    assert torch.equal(flash_attention_bshd(q, k, v, window=8, softcap=20.0),
                       flash_attention_plain(q, k, v, window=8, softcap=20.0))
    assert torch.equal(flash_attention_bshd(q, k, v, q_rows=rows),
                       flash_attention_plain(q, k, v, q_rows=rows))
    assert cuda.LAUNCHES == before
