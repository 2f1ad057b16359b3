"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels
are built by nvcc on first use) and skips without one.  This file
imports torch and the port only, so it also runs on a machine without
JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: the transport kernel is bitwise (f32 and bf16) against
``schedule_exec_plain`` and, in f32, against the numpy oracle
``run_reference``; the rmsnorm kernels are within 1e-5 (f32) or one
bf16 ulp of their plain versions (the f32 mean is reduced in another
order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import cuda
from repro_torch.core import executor, kernel_lowering
from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.kernel_lowering import (get_kernel_exec,
                                              schedule_exec_plain)
from repro_torch.core.schedule import CommRound, CommSchedule, NotApplicable
from repro_torch.core.topology import Topology, flat_topology, torus_topology
from repro_torch.core.transport import SimTransport
from repro_torch.kernels.rmsnorm.kernel import (rmsnorm_2d, rmsnorm_plain,
                                                rmsnorm_reduce_2d,
                                                rmsnorm_reduce_plain)

pytestmark = pytest.mark.cuda

TOPOS = (flat_topology(8), Topology(8, 4), torus_topology(2, 2, 2),
         torus_topology(2, 4, 2))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    executor.clear_cache()
    kernel_lowering.clear_cache()
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _float_buf(rng, shape):
    buf = rng.standard_normal(shape).astype(np.float32)
    buf.reshape(-1)[::7] = -0.0
    return buf


def test_transport_kernel_bitwise(cuda_device):
    """Every REGISTRY schedule: one launch per run, bitwise equal to the
    plain version (f32, bf16) and to run_reference (f32), chunks=2
    bit-identical.  Slots [4, 33] leave a ragged tile edge."""
    rng = np.random.default_rng(0)
    seen = 0
    for topo in TOPOS:
        for coll, algos in REGISTRY.items():
            for name, builder in algos.items():
                try:
                    sched = builder(topo)
                except NotApplicable:
                    continue
                label = f"{topo.fingerprint()} {coll}.{name}"
                buf = _float_buf(rng, (topo.nranks, sched.num_slots, 4, 33))
                want = SimTransport(topo.nranks).run_reference(sched, buf)
                kex = get_kernel_exec(sched, topo=topo)
                for dtype in (torch.float32, torch.bfloat16):
                    g = torch.from_numpy(buf).to(cuda_device, dtype)
                    before = kex.launches
                    got = kex.run(g)
                    torch.cuda.synchronize()
                    assert kex.launches == before + 1, label
                    plain = schedule_exec_plain(kex.ex, g)
                    assert torch.equal(_bits(got), _bits(plain)), label
                    assert torch.equal(_bits(kex.run(g, chunks=2)),
                                       _bits(got)), label
                    if dtype == torch.float32:
                        assert got.cpu().numpy().tobytes() == \
                            want.tobytes(), label
                seen += 1
    assert seen >= 80


def test_transport_kernel_masked_gather_adds_zero(cuda_device):
    """-0.0 in a live target plus a masked (zero) gather gives +0.0."""
    gi = np.array([[-1, 0], [-1, -1]], np.int32)
    si = np.array([[-1, -1], [0, 1]], np.int32)
    rnd = CommRound(perm=((0, 1),), gather_idx=gi, scatter_idx=si,
                    reduce=True)
    sched = CommSchedule(nranks=2, num_slots=2, rounds=(rnd,), name="z")
    buf = np.array([[[1.5], [2.0]], [[-0.0], [-0.0]]], np.float32)
    want = SimTransport(2).run_reference(sched, buf)
    got = get_kernel_exec(sched).run(torch.from_numpy(buf).to(cuda_device))
    assert got.cpu().numpy().tobytes() == want.tobytes()


def test_transport_kernel_rejects_what_it_cannot_run(cuda_device):
    sched = REGISTRY["allgather"]["ring"](flat_topology(8))
    kex = get_kernel_exec(sched)
    with pytest.raises(TypeError, match="dtype"):
        kex.run(torch.zeros(8, 8, 4, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        kex.run(torch.zeros(8, 8, 4, 2, device=cuda_device)[..., 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gemma", [False, True])
def test_rmsnorm_kernels_match_plain_versions(cuda_device, dtype, gemma):
    rng = np.random.default_rng(4)
    parts = torch.from_numpy(rng.standard_normal((8, 64, 5120))
                             .astype(np.float32)).to(cuda_device, dtype)
    scale32 = torch.from_numpy(rng.standard_normal(5120).astype(np.float32)
                               ).to(cuda_device)
    # the kernel reads the scale in its own dtype, f32 or bf16
    for got_fn, plain_fn, args, name in (
            (fn, plain, (x, scale32.to(sdt)), name)
            for sdt in (torch.float32, torch.bfloat16)
            for fn, plain, x, name in (
                (rmsnorm_reduce_2d, rmsnorm_reduce_plain, parts,
                 "rmsnorm_reduce"),
                (rmsnorm_2d, rmsnorm_plain, parts[0], "rmsnorm"))):
        n0 = cuda.LAUNCHES[name]
        got = got_fn(*args, gemma_style=gemma)
        assert cuda.LAUNCHES[name] == n0 + 1
        want = plain_fn(*args, gemma_style=gemma)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs()
                                                 .clamp_min(1e-30))) - 7)
            assert bool(((got.float() - want.float()).abs() <= ulp).all())
