"""The CPU twin of the selective-scan kernel's tiling against the JAX
package's scan, and the wrapper's plan.

``selective_scan_tiles`` runs ``scan_plan``'s tiling and the kernel's
order of adds (each state-warp's states in ascending order, the W
partials in w order, D x last, the T and Di tails zero-filled to whole
tiles), its fused multiply-adds rounded once (``fma32``, held here
against exact rational arithmetic).  Inputs come from a numpy seed as the reference's own sweep
draws them (tests/test_kernels.py:172-184).  It is held against the
reference's oracle ``selective_scan_ref`` and its Pallas kernel in
interpret mode (``block_t`` = T, or 40 at T = 200), within the
reference's kernel tolerances: ``2e-5`` with float32 inputs, ``2e-2``
with bfloat16 ones (the oracle rounds dt * x to bf16; the twin, as the
kernel, takes it in f32).  The plan's cases replace the old kernel's
``lanes`` cases: jamba-1.5-large's layer (B 1, Di 16384), larger B,
small Di, f32 inputs and each state size.
"""
from fractions import Fraction

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.mamba_scan import ops as jops
from repro.kernels.mamba_scan.ref import selective_scan_ref as jscan_ref

from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.mamba_scan.kernel import (ScanPlan, scan_plan,
                                                   selective_scan_plain,
                                                   tma_ok)
from repro_torch.kernels.mamba_scan.tiles import fma32, selective_scan_tiles

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
KT = scan_plan(1, 24, 16).steps             # the plan's steps a tile


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(rng, B, T, Di, S, dtype):
    def cast(a):
        return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                        else np.float32)
    xc = cast(rng.normal(size=(B, T, Di)))
    dt = cast(np.abs(rng.normal(size=(B, T, Di))) * 0.1)
    bm = cast(rng.normal(size=(B, T, S)))
    cm = cast(rng.normal(size=(B, T, S)))
    A = -np.exp(rng.normal(size=(Di, S)).astype(np.float32))
    D = rng.normal(size=(Di,)).astype(np.float32)
    return xc, dt, bm, cm, A, D


def _f32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [4, 8, 16])
@pytest.mark.parametrize("Di", [24, 130, 300])
@pytest.mark.parametrize("T", [1, KT - 1, KT + 1, 200])
def test_tiles_vs_reference(T, Di, S, dtype):
    """The twin at the T and Di tails, each state size, f32 and bf16,
    against the reference's oracle and its Pallas kernel."""
    rng = np.random.default_rng(T * 1000 + Di + S)
    args = _inputs(rng, 2, T, Di, S, dtype)
    got = selective_scan_tiles(*(tensor_from_numpy(a) for a in args))
    assert got.dtype == torch.float32 and got.shape == (2, T, Di)
    jargs = [jnp.asarray(a) for a in args]
    want, _ = jscan_ref(*jargs)
    np.testing.assert_allclose(got.numpy(), _f32(want), **TOL[dtype])
    pallas = jops.selective_scan(*jargs, T if T < 200 else 40)
    np.testing.assert_allclose(got.numpy(), _f32(pallas), **TOL[dtype])


@pytest.mark.parametrize("plan", [ScanPlan(4, 1), ScanPlan(4, 2),
                                  ScanPlan(2, 1), ScanPlan(2, 2),
                                  ScanPlan(1, 1), ScanPlan(1, 2)])
def test_tiles_other_plans_vs_plain(plan):
    """Each tiling the library holds (W = S / 4, one or two groups of 32
    channels) gives the plain version's y (f32): the tiles, the channel
    groups and the W partials change only the order of the f32 adds."""
    S = 4 * plan.warps
    rng = np.random.default_rng(plan.warps * 10 + plan.groups)
    args = [tensor_from_numpy(a)
            for a in _inputs(rng, 2, 70, 130, S, "float32")]
    np.testing.assert_allclose(selective_scan_tiles(*args, plan=plan),
                               selective_scan_plain(*args), **TOL["float32"])


def test_tiles_flush_to_zero_within_tolerance():
    """dt A below -126 ln 2 on half the states: the kernel's ex2.ftz
    flushes those decays to exactly 0, the plain version keeps
    subnormals; y agrees within the f32 tolerance."""
    rng = np.random.default_rng(7)
    xc, dt, bm, cm, A, D = _inputs(rng, 1, 40, 24, 16, "float32")
    dt = np.full_like(dt, 2.0)
    A[:, ::2] = -45.0                       # dt A = -90 < -87.3
    args = [tensor_from_numpy(a) for a in (xc, dt, bm, cm, A, D)]
    np.testing.assert_allclose(selective_scan_tiles(*args),
                               selective_scan_plain(*args), **TOL["float32"])


@pytest.mark.parametrize("B,Di,S,want", [
    (1, 16384, 16, ScanPlan(4, 2)),     # jamba's layer
    (4, 16384, 16, ScanPlan(4, 2)),
    (1, 8192, 16, ScanPlan(4, 1)),      # 128 CTAs of 64
    (2, 8192, 16, ScanPlan(4, 2)),
    (1, 8448, 16, ScanPlan(4, 2)),      # 132 CTAs of 64: one a SM
    (1, 8384, 16, ScanPlan(4, 1)),      # 131 CTAs of 64
    (1, 300, 16, ScanPlan(4, 1)),
    (1, 24, 4, ScanPlan(1, 1)),
    (2, 130, 8, ScanPlan(2, 1)),
    (8, 4096, 8, ScanPlan(2, 2)),
])
def test_scan_plan(B, Di, S, want):
    """W = S / 4; two groups of 32 channels a CTA once that still gives
    each of the 132 SMs a CTA; 32 steps a tile."""
    assert scan_plan(B, Di, S) == want
    assert want.steps == 32


def test_scan_plan_counts_the_cards_sms():
    """The SM count is the card's: twice the SMs, one group a CTA."""
    assert scan_plan(1, 16384, 16, sms=264) == ScanPlan(4, 1)
    assert scan_plan(1, 16384, 16, sms=256) == ScanPlan(4, 2)


def _f32_nearest(q: Fraction) -> np.float32:
    """The f32 nearest ``q``, ties to even, from exact rationals."""
    r = np.float32(float(q))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - q),
                                     int(np.array(v).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """fma32 gives the exact a * b + c rounded once to f32: random
    triples over wide exponents, and one whose f64 sum falls on an f32
    midpoint (rounding the f64 sum to f32 there would go the wrong way)."""
    rng = np.random.default_rng(31)
    n = 4000
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(
        np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(
        np.float32)
    c = (rng.standard_normal(n) * 2.0 ** rng.integers(-40, 40, n)).astype(
        np.float32)
    a = np.append(a, np.float32(1 + 2.0 ** -16))
    b = np.append(b, np.float32(2.0 ** -24 * (1 - 2.0 ** -16)))
    c = np.append(c, np.float32(1 + 2.0 ** -23))
    got = fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_f32_nearest(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[-1] == np.float32(1 + 2.0 ** -23)
    naive = np.float32(np.float64(a[-1]) * np.float64(b[-1])
                       + np.float64(c[-1]))
    assert naive != got[-1]


def test_tma_ok():
    """TMA boxes need a 16-byte-aligned base and (b, t) strides."""
    x = torch.zeros((2, 8, 64), dtype=torch.bfloat16)
    assert tma_ok(x)
    wide = torch.zeros((2, 8, 130), dtype=torch.bfloat16)
    assert not tma_ok(wide[..., 1:65])      # base off 16 bytes
    assert not tma_ok(torch.zeros((2, 8, 300), dtype=torch.bfloat16))
    assert tma_ok(torch.zeros((2, 8, 300), dtype=torch.float32))
    assert tma_ok(torch.zeros((2, 8, 136), dtype=torch.bfloat16)[..., :64])
