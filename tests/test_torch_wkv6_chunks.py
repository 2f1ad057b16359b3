"""The wkv6 kernel's chunk-parallel scan and the rmsnorm kernel's body
choice, held on the CPU.

``wkv6_chunked_plain`` (``kernels/wkv6/kernel.py``) is the three phases
of ``csrc/wkv6.cu`` in PyTorch: each chunk's local state and decay
product from zero, the carry over chunks, each chunk rerun from its
carried-in state.  It is held against the JAX package's plain scan
``repro.kernels.wkv6.ref.wkv6_ref`` on numpy inputs from a seed, at the
reference's f32 kernel tolerance ``2e-5`` (the chunked form differs from
the serial recurrence only by rounding each chunk's decay product as one
product), over chunk edges (T below, at and past a chunk, many chunks),
decay extremes (``w = exp(-exp(x))`` with x up to +5, which is exactly 0
in f32; exact 0 and exact 1; a chunk whose decays are all 0) and a
hypothesis sweep over (T, C).  With bf16 r/k/v both sides widen the same
values to f32, so the f32 tolerance holds there too.

``rmsnorm_body`` (``kernels/rmsnorm/kernel.py``) decides which body of
``csrc/rmsnorm.cu`` runs a row; the kernel re-checks it.  Held here: the
main-path widths take the vector body, rows that are no whole 16-byte
vector or lie off a 16-byte boundary or are too wide take the scalar
body, and the vector body's tiling covers every vector of a row once.
"""
import ml_dtypes
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.wkv6.ref import wkv6_ref as jwkv6_ref

from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.rmsnorm.kernel import (MAX_THREADS, MAX_VPT,
                                                rmsnorm_body)
from repro_torch.kernels.wkv6.kernel import (CHUNKS, FILL_CTAS,
                                             column_groups,
                                             wkv6_chunk,
                                             wkv6_chunked_plain)

F32 = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(rng, B, T, H, N, rkv="float32", x_hi=None):
    """numpy r, k, v (in ``rkv``), w = exp(-exp(x)) f32 with x normal,
    or uniform in [-3, x_hi] when given; u f32."""
    cast = ml_dtypes.bfloat16 if rkv == "bfloat16" else np.float32
    r, k, v = (rng.normal(size=(B, T, H, N)).astype(cast) for _ in range(3))
    x = (rng.normal(size=(B, T, H, N)) if x_hi is None
         else rng.uniform(-3.0, x_hi, size=(B, T, H, N)))
    w = np.exp(-np.exp(x.astype(np.float32)))
    u = rng.normal(size=(H, N)).astype(np.float32)
    return r, k, v, w, u


def _check(args, chunk):
    want, _ = jwkv6_ref(*(jnp.asarray(a) for a in args))
    got = wkv6_chunked_plain(*(tensor_from_numpy(a) for a in args), chunk)
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


EDGES = [(C, T) for C in (8, 16, 64)
         for T in (1, C - 1, C, C + 1, 3 * C, 200)]


@pytest.mark.parametrize("C,T", EDGES, ids=[f"C{C}-T{T}" for C, T in EDGES])
def test_chunked_plain_matches_reference_at_chunk_edges(C, T):
    """B = 2, so that the batch offsets of the scratch are exercised."""
    rng = np.random.default_rng(1000 * C + T)
    _check(_inputs(rng, 2, T, 2, 8), C)


@pytest.mark.parametrize("C", [8, 16, 64])
@pytest.mark.parametrize("rkv", ["float32", "bfloat16"])
def test_chunked_plain_decay_extremes(C, rkv):
    """w = exp(-exp(x)) with x up to +5 (0 in f32 past x ~ 4.6), whole
    channels of exact 0 and exact 1, and a whole chunk of zero decays
    (its product D is exactly 0 and nothing turns NaN)."""
    rng = np.random.default_rng(7 + C)
    B, T, H, N = 2, 5 * C + 3, 2, 16
    r, k, v, w, u = _inputs(rng, B, T, H, N, rkv, x_hi=5.0)
    w[..., 0] = 0.0
    w[..., 1] = 1.0
    w[:, C:2 * C] = 0.0                  # chunk 1: every decay 0
    w[1, 3 * C:4 * C, 1] = 0.0           # chunk 3 of one batch row, one head
    assert (np.exp(-np.exp(np.float32(5.0))) == 0.0)
    got = wkv6_chunked_plain(*(tensor_from_numpy(a) for a in (r, k, v, w, u)),
                             C)
    assert bool(torch.isfinite(got).all())
    _check((r, k, v, w, u), C)


@settings(max_examples=25, deadline=None)
@given(T=st.integers(1, 160), C=st.integers(1, 72), seed=st.integers(0, 99))
def test_chunked_plain_hypothesis(T, C, seed):
    rng = np.random.default_rng(seed)
    _check(_inputs(rng, 1, T, 2, 8), C)


def test_chunk_rule():
    """One chunk (phase 3 alone) while T fits the shortest chunk; past
    it a length from CHUNKS, the longest whose phase-3 grid still fills
    the card; rwkv6-3b's prefill layer runs at 256."""
    assert wkv6_chunk(1, 8192, 40, 64) == 256
    for T in (1, 16, 32, CHUNKS[0]):
        assert wkv6_chunk(4, T, 40, 64) == T
    for B, T, H, N in [(1, 8192, 40, 64), (2, 200, 40, 64), (1, 70, 4, 128),
                       (1, 1 << 16, 40, 64), (64, 4096, 40, 64)]:
        C = wkv6_chunk(B, T, H, N)
        assert C in CHUNKS
        fills = [c for c in CHUNKS
                 if -(-T // c) * B * H * column_groups(N) >= FILL_CTAS]
        assert C == (max(fills) if fills else CHUNKS[0])


@pytest.mark.parametrize("N,groups", [(8, 1), (16, 1), (32, 1), (64, 1),
                                      (128, 4)])
def test_column_groups_mirror_the_tiling(N, groups):
    """csrc Tiling<N>: 64-thread CTAs of SPLIT threads a column group of
    CPT columns; a head of 64 fits one CTA."""
    assert column_groups(N) == groups


# ---------------------------------------------------------------------------
# the rmsnorm kernel's body choice
# ---------------------------------------------------------------------------

BODIES = [
    # (d, dtype, byte offset, body): the main-path widths first
    (5120, torch.bfloat16, 0, "vector"),
    (2304, torch.bfloat16, 0, "vector"),
    (2304, torch.float32, 0, "vector"),      # 576 vectors of 4
    (5120, torch.float32, 0, "vector"),
    (8, torch.bfloat16, 0, "vector"),        # one vector
    (100, torch.float32, 0, "vector"),       # 25 vectors, no exact fit
    (16384, torch.bfloat16, 0, "vector"),    # 2048 vectors: 4 x 512
    (100, torch.bfloat16, 0, "scalar"),      # no whole vector
    (5120, torch.bfloat16, 8, "scalar"),     # 8 bytes off
    (5120, torch.bfloat16, 2, "scalar"),     # an odd element offset
    (2304, torch.float32, 4, "scalar"),
    (16384, torch.float32, 0, "scalar"),     # 4096 vectors: too wide
    (40000, torch.bfloat16, 0, "scalar"),
]


def _cover(nvec, vpt, threads):
    """The vectors the kernel's threads load: i * threads + tid."""
    seen = [i * threads + t for i in range(vpt) for t in range(threads)]
    return sorted(v for v in seen if v < nvec)


@pytest.mark.parametrize("d,dtype,offset,body", BODIES,
                         ids=[f"{d}-{str(dt)[6:]}-off{o}"
                              for d, dt, o, _ in BODIES])
def test_rmsnorm_body_choice(d, dtype, offset, body):
    got, vpt, threads = rmsnorm_body(d, dtype, offset)
    assert got == body
    if body == "vector":
        nvec = d * dtype.itemsize // 16
        assert 1 <= vpt <= MAX_VPT and threads % 32 == 0
        assert 32 <= threads <= MAX_THREADS
        assert _cover(nvec, vpt, threads) == list(range(nvec))
    else:
        assert vpt == 0 and threads == min(256, -(-d // 32) * 32)


def test_rmsnorm_main_path_tilings():
    """The main path's rows: exact fits, every thread holding the same
    count of vectors (5 warps at d = 5120 bf16, 3 at d = 2304)."""
    assert rmsnorm_body(5120, torch.bfloat16, 0) == ("vector", 4, 160)
    assert rmsnorm_body(2304, torch.bfloat16, 0) == ("vector", 3, 96)


@settings(max_examples=200, deadline=None)
@given(d=st.integers(1, 20000), bf16=st.booleans(),
       offset=st.sampled_from([0, 2, 4, 8, 12]))
def test_rmsnorm_body_hypothesis(d, bf16, offset):
    dtype = torch.bfloat16 if bf16 else torch.float32
    per = 16 // dtype.itemsize
    body, vpt, threads = rmsnorm_body(d, dtype, offset)
    fits = d % per == 0 and offset == 0 and d // per <= MAX_VPT * MAX_THREADS
    assert body == ("vector" if fits else "scalar")
    if fits:
        nvec = d // per
        assert threads % 32 == 0 and 32 <= threads <= MAX_THREADS
        assert 1 <= vpt <= MAX_VPT
        assert vpt * threads >= nvec > (vpt - 1) * threads
