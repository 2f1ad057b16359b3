"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels
are built by nvcc on first use) and skips without one.  This file
imports torch and the port only, so it also runs on a machine without
JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: the transport kernel is bitwise (f32 and bf16) against
``schedule_exec_plain`` and, in f32, against the numpy oracle
``run_reference``, on its ragged path (slots [4, 33]: bf16 rows, and
every row at chunks=2, are no whole 16 B) and its aligned TMA path
(slots [4, 64], a ring of buffers that wraps, repeated targets), and
its global-memory body (forced on REGISTRY and neighbor schedules)
bitwise against the plain version and the shared body, on its 16-byte
and its scalar path (tails, rows and buffers off 16 bytes), and its
gather body (forced on every copy-only REGISTRY schedule, neighbor and
KV plans, hand-made plans with +0 landings and repeated targets, and
taken by a KV plan too tall for shared memory) bitwise against its
plain version, ``schedule_exec_plain`` and the global body, on its bulk
and its ragged path, at chunks 1, 2 and 4; the rmsnorm kernels are within 1e-5 (f32) or one
bf16 ulp of their plain versions (the f32 mean is reduced in another
order); the flash-attention kernels are within the reference's kernel
tolerances of their plain version, ``3e-5`` in f32 and ``2e-2`` in bf16
(another tile order of the online softmax; in bf16 the Hopper wgmma
body also rounds the attention weights to bf16; the new tests also
assert which body ran: wgmma for aligned bf16, the CUDA-core body for
bf16 off 16-byte alignment), and the gather kernel's dead rows are
exact zeros; the wkv6 kernel is within the reference's
kernel tolerances of its plain version, ``2e-5`` with f32 inputs and
``2e-2`` with bf16 ones (another order of the f32 sums over the head,
and, across chunks, each chunk's decay product rounded as one product);
so is the selective-scan kernel (another order of the f32 sum over the
states, fused multiply-adds, ex2.approx.ftz on dt * A log2 e, which
flushes decays below 2^-126 to 0), against its plain version and its
CPU twin.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import cuda
from repro_torch.core import executor, kernel_lowering
from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.kernel_lowering import (get_kernel_exec,
                                              schedule_exec_gather_plain,
                                              schedule_exec_plain)
from repro_torch.core.schedule import CommRound, CommSchedule, NotApplicable
from repro_torch.core.topology import Topology, flat_topology, torus_topology
from repro_torch.core.transport import SimTransport
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.kernel import (flash_attention_bshd,
                                                  flash_attention_plain)
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.kernel import (rmsnorm_2d, rmsnorm_body,
                                                rmsnorm_plain,
                                                rmsnorm_reduce_2d,
                                                rmsnorm_reduce_plain)
from repro_torch.kernels.mamba_scan import kernel as scan_kernel
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.kernel import (selective_scan_bdt,
                                                   selective_scan_plain)
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
from repro_torch.kernels.mamba_scan import tiles as scan_tiles
from repro_torch.kernels.mamba_scan.tiles import selective_scan_tiles
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6 import kernel as wkv_kernel
from repro_torch.kernels.wkv6.kernel import wkv6_bthn, wkv6_plain
from repro_torch.kernels.wkv6.ref import wkv6_ref

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


def _registry(topo):
    for coll, algos in REGISTRY.items():
        for name, builder in algos.items():
            try:
                yield f"{topo.fingerprint()} {coll}.{name}", builder(topo)
            except NotApplicable:
                continue


def test_transport_kernel_aligned_sweep(cuda_device):
    """Every REGISTRY schedule at slots [4, 64] (rows of 256 B in f32, 128
    B in bf16) through the aligned TMA path, hazard rounds, pre and post
    included: bitwise equal to the plain version (f32, bf16) and to
    run_reference (f32), chunks 2 and 4 bit-identical to chunks 1."""
    rng = np.random.default_rng(3)
    seen = 0
    for topo in TOPOS:
        for label, sched in _registry(topo):
            buf = _float_buf(rng, (topo.nranks, sched.num_slots, 4, 64))
            want = SimTransport(topo.nranks).run_reference(sched, buf)
            kex = get_kernel_exec(sched, topo=topo)
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.from_numpy(buf).to(cuda_device, dtype)
                got = kex.run(g)
                torch.cuda.synchronize()
                assert kex.last_launch["path"] == "aligned TMA", label
                plain = schedule_exec_plain(kex.ex, g)
                assert torch.equal(_bits(got), _bits(plain)), label
                for chunks in (2, 4):
                    assert torch.equal(_bits(kex.run(g, chunks=chunks)),
                                       _bits(got)), (label, chunks)
                if dtype == torch.float32:
                    assert got.cpu().numpy().tobytes() == want.tobytes(), \
                        label
            seen += 1
    assert seen >= 80


@pytest.mark.parametrize("coll,algo,dtype", [
    ("allreduce", "ring_rs_ag", torch.float32),
    ("alltoall", "pairwise", torch.bfloat16),
])
def test_transport_kernel_buffer_ring_wraps(cuda_device, coll, algo, dtype):
    """More column tiles than the persistent grid has CTAs: each CTA's
    ring of buffers wraps several times, and the result stays bitwise."""
    topo = flat_topology(8)
    sched = REGISTRY[coll][algo](topo)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    g = torch.randn((8, sched.num_slots, 1 << 18), generator=gen,
                    device=cuda_device, dtype=dtype)
    kex = get_kernel_exec(sched, topo=topo)
    got = kex.run(g)
    torch.cuda.synchronize()
    info = kex.last_launch
    items = -(-g.shape[-1] // info["tile"])
    assert info["path"] == "aligned TMA"
    # every CTA takes items enough to go round its ring twice or more
    assert items >= 2 * info["grid"] * info["buffers"], info
    assert torch.equal(_bits(got), _bits(schedule_exec_plain(kex.ex, g)))


@pytest.mark.parametrize("reduce", [True, False])
@pytest.mark.parametrize("width", [64, 33])
def test_transport_kernel_repeated_targets(cuda_device, monkeypatch, reduce,
                                           width):
    """A round that lands two positions on one row (validation off) runs
    ordered, through the stage: reduce adds in (edge, position) order and
    the last set wins, bitwise against the numpy oracle, on the aligned
    (64 columns) and the ragged (33) path."""
    monkeypatch.setenv("REPRO_VALIDATE_SCHEDULES", "0")
    gi = np.array([[0, 1], [0, 1]], np.int32)
    si = np.array([[1, 1], [0, 0]], np.int32)
    rnd = CommRound(perm=((0, 1), (1, 0)), gather_idx=gi, scatter_idx=si,
                    reduce=reduce)
    sched = CommSchedule(nranks=2, num_slots=2, rounds=(rnd,), name="dup")
    rng = np.random.default_rng(6)
    buf = (rng.standard_normal((2, 2, width)) * np.array(
        [[[1e8], [1.0]], [[-1e8], [3.0]]])).astype(np.float32)
    want = SimTransport(2).run_reference(sched, buf)
    kex = get_kernel_exec(sched, optimize=False)
    assert kex.tables["ordered"].all()
    got = kex.run(torch.from_numpy(buf).to(cuda_device))
    torch.cuda.synchronize()
    assert kex.last_launch["path"] == ("aligned TMA" if width == 64
                                       else "ragged")
    assert got.cpu().numpy().tobytes() == want.tobytes()


def test_transport_kernel_rejects_what_it_cannot_run(cuda_device):
    sched = REGISTRY["allgather"]["ring"](flat_topology(8))
    kex = get_kernel_exec(sched)
    with pytest.raises(TypeError, match="dtype"):
        kex.run(torch.zeros(8, 8, 4, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        kex.run(torch.zeros(8, 8, 4, 2, device=cuda_device)[..., 0])


# ---- the global-memory body ---------------------------------------------


def _off16(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts 4 bytes past a
    16-byte boundary (a row the 16-byte path cannot take)."""
    flat = torch.empty(t.numel() * t.element_size() + 4, dtype=torch.uint8,
                       device=t.device)
    view = flat[4:].view(t.dtype).view(t.shape)
    view.copy_(t)
    return view


def _both_bodies(kex, g, label, chunks=(1, 2)):
    """The global body bitwise against the plain version and the shared
    body (where the schedule fits it), at each chunk count."""
    from repro_torch import cuda as _cuda
    plain = schedule_exec_plain(kex.ex, g)
    before = _cuda.TRANSPORT_BODIES["global"]
    got = kex.run(g, _body="global")
    torch.cuda.synchronize()
    assert kex.last_launch["body"] == "global", label
    assert _cuda.TRANSPORT_BODIES["global"] == before + 1, label
    assert torch.equal(_bits(got), _bits(plain)), label
    for c in chunks[1:]:
        if g.shape[2] % c == 0:
            assert torch.equal(_bits(kex.run(g, chunks=c, _body="global")),
                               _bits(got)), (label, c)
    try:
        shared = kex.run(g, _body="shared")
    except ValueError:                  # too tall for shared memory
        return got
    assert kex.last_launch["body"] == "shared", label
    assert torch.equal(_bits(shared), _bits(got)), label
    return got


@pytest.mark.parametrize("slot", [(4, 33), (4, 64), (3, 5)])
def test_transport_global_body_registry(cuda_device, slot):
    """Every REGISTRY schedule (hazard rounds, pre and post) forced onto
    the global body: bitwise against the plain version and the shared
    body (f32, bf16) and run_reference (f32).  [4, 64] takes the 16-byte
    path in both dtypes, [4, 33] in f32 (528 B a row, 16-byte units that
    leave a tile's ragged edge); bf16 [4, 33] and [3, 5] take the scalar
    path."""
    rng = np.random.default_rng(5)
    seen = 0
    for topo in TOPOS:
        for label, sched in _registry(topo):
            buf = _float_buf(rng, (topo.nranks, sched.num_slots) + slot)
            want = SimTransport(topo.nranks).run_reference(sched, buf)
            kex = get_kernel_exec(sched, topo=topo)
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.from_numpy(buf).to(cuda_device, dtype)
                got = _both_bodies(kex, g, label)
                kex.run(g, _body="global")
                whole = np.prod(slot) * g.element_size() % 16 == 0
                assert kex.last_launch["path"] == (
                    "16-byte" if whole else "scalar"), label
                if dtype == torch.float32:
                    assert got.cpu().numpy().tobytes() == want.tobytes(), \
                        label
            seen += 1
    assert seen >= 80


def test_transport_global_body_off_16_bytes(cuda_device):
    """Aligned row lengths in a buffer that starts off 16 bytes: the
    scalar path, bitwise against the aligned run."""
    topo = Topology(8, 4)
    for label, sched in _registry(topo):
        rng = np.random.default_rng(2)
        buf = _float_buf(rng, (8, sched.num_slots, 4, 64))
        kex = get_kernel_exec(sched, topo=topo)
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.from_numpy(buf).to(cuda_device, dtype)
            want = kex.run(g, _body="global")
            got = kex.run(_off16(g), _body="global")
            torch.cuda.synchronize()
            assert kex.last_launch["path"] == "scalar", label
            assert torch.equal(_bits(got), _bits(want)), label


@pytest.mark.parametrize("aggregate", [False, True])
def test_transport_global_body_neighbor_plans(cuda_device, aggregate):
    """Neighbor plans (partial permutations, the fused (r, r) self-copy
    rounds, per-rank recv offsets) on the four topologies, f32 and bf16
    with negative zeros: both bodies bitwise equal to each other, to the
    plain version and to SimTransport.run."""
    from repro_torch.core.plan import CommGraph, build_plan
    topos = [Topology(8, 8), Topology(8, 4), Topology(16, 4),
             Topology(12, 3)]
    for i, topo in enumerate(topos):
        n = topo.nranks
        rng = np.random.default_rng(40 + i)
        graph = CommGraph.random(n, n_local=24, degree=min(n - 1, 6),
                                 rng=rng, dup_frac=0.7)
        plan = build_plan(graph, topo, aggregate=aggregate)
        label = f"{topo.fingerprint()} {plan.name}"
        for slot in ((2, 64), (3, 7)):
            buf = _float_buf(rng, (n, plan.buf_rows) + slot)
            want = SimTransport(n, topo=topo).run(plan.schedule, buf)
            kex = get_kernel_exec(plan.schedule, topo=topo)
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.from_numpy(buf).to(cuda_device, dtype)
                got = _both_bodies(kex, g, (label, slot))
                if dtype == torch.float32:
                    assert got.cpu().numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("reduce", [True, False])
@pytest.mark.parametrize("width", [64, 33])
def test_transport_global_body_repeated_targets(cuda_device, monkeypatch,
                                                reduce, width):
    """Ordered rounds on the global body: reduce adds in (edge,
    position) order and the last set wins."""
    monkeypatch.setenv("REPRO_VALIDATE_SCHEDULES", "0")
    gi = np.array([[0, 1], [0, 1]], np.int32)
    si = np.array([[1, 1], [0, 0]], np.int32)
    rnd = CommRound(perm=((0, 1), (1, 0)), gather_idx=gi, scatter_idx=si,
                    reduce=reduce)
    sched = CommSchedule(nranks=2, num_slots=2, rounds=(rnd,), name="dup")
    rng = np.random.default_rng(6)
    buf = (rng.standard_normal((2, 2, width)) * np.array(
        [[[1e8], [1.0]], [[-1e8], [3.0]]])).astype(np.float32)
    want = SimTransport(2).run_reference(sched, buf)
    kex = get_kernel_exec(sched, optimize=False)
    assert kex.tables["ordered"].all()
    got = kex.run(torch.from_numpy(buf).to(cuda_device), _body="global")
    torch.cuda.synchronize()
    assert got.cpu().numpy().tobytes() == want.tobytes()


def test_transport_tall_kv_plan_takes_the_gather_body(cuda_device):
    """A KV transfer plan of 256 blocks a rank (over 1,700 rows, no
    reduce round): the wrapper picks the gather body by itself, one
    launch, bitwise against the plain version and the gather oracle; a
    small engine trace on the card verifies every batch."""
    from repro_torch import cuda as _cuda
    from repro_torch.core import kvtransfer
    from repro_torch.serve.engine import ContinuousBatchingEngine, \
        EngineConfig
    from repro_torch.serve.traffic import poisson_workload, run_workload
    topo = Topology(8, 4)
    rng = np.random.default_rng(0)
    moves, used = [], set()
    while len(moves) < 600:
        s, d = int(rng.integers(4)), 4 + int(rng.integers(4))
        row, dr = int(rng.integers(256)), int(rng.integers(256))
        if (d, dr) not in used:
            used.add((d, dr))
            moves.append(kvtransfer.BlockMove(s, row, d, dr))
    moves += [kvtransfer.BlockMove(0, 3, d, 255 - d) for d in range(4, 8)
              if (d, 255 - d) not in used]
    for agg in (False, True):
        tp = kvtransfer.build_transfer_plan(
            moves, topo, blocks_per_rank=256, aggregate=agg,
            block_bytes=16 * 256 * 4)
        assert 8 * tp.schedule.num_slots > 1700
        pool = torch.randn(8, 256, 16, 256, device=cuda_device)
        pool.view(-1)[::7] = -0.0
        n0 = _cuda.LAUNCHES["schedule_exec"]
        res = kvtransfer.run_transfer(tp, pool, transport="kernel")
        assert _cuda.LAUNCHES["schedule_exec"] == n0 + 1
        kex = get_kernel_exec(tp.schedule, topo=topo)
        assert kex.last_launch["body"] == "gather"
        assert kvtransfer.verify_bitwise(tp, pool, res)
        g = pool.new_zeros((8, tp.schedule.num_slots, 16, 256))
        g[:, :256] = pool
        assert torch.equal(_bits(kex.run(g)),
                           _bits(schedule_exec_plain(kex.ex, g)))
    eng = ContinuousBatchingEngine(EngineConfig(
        blocks_per_rank=256, block_tokens=16, block_feat=64,
        transport="kernel", device="cuda"))
    m = run_workload(eng, poisson_workload(
        0, arrival_rate=6.0, tenants=3, n_requests=12, mean_prompt=512,
        max_prompt=2048))
    assert m["completed"] == 12


# ---- the gather body -----------------------------------------------------


def _gather_body(kex, g, label, chunks=(1, 2, 4)):
    """The gather body forced at each chunk count the slot allows: one
    launch a run and the ``gather`` counter up by one, the segment and
    ring the kernel reports those ``pick_tile`` names, bitwise equal to
    its plain version, to ``schedule_exec_plain`` and to the global
    body."""
    plain = schedule_exec_gather_plain(kex.ex, g)
    assert torch.equal(_bits(plain), _bits(schedule_exec_plain(kex.ex, g))), \
        label
    glob = kex.run(g, _body="global")
    got = None
    for c in chunks:
        if g.shape[2] % c:
            continue
        before, n0 = cuda.TRANSPORT_BODIES["gather"], kex.launches
        got = kex.run(g, chunks=c, _body="gather")
        torch.cuda.synchronize()
        assert kex.last_launch["body"] == "gather", label
        assert (kex.last_launch["tile"], kex.last_launch["buffers"]) == (
            kernel_lowering.GATHER_SEG_BYTES, kernel_lowering.GATHER_BUFS)
        assert cuda.TRANSPORT_BODIES["gather"] == before + 1, label
        assert kex.launches == n0 + 1, label
        assert torch.equal(_bits(got), _bits(plain)), (label, c)
        assert torch.equal(_bits(got), _bits(glob)), (label, c)
    return got


def _bulk(g) -> bool:
    return (g[0, 0].numel() * g.element_size() % 16 == 0
            and g.data_ptr() % 16 == 0)


@pytest.mark.parametrize("slot", [(4, 64), (4, 33), (3, 5)])
def test_transport_gather_body_registry(cuda_device, slot):
    """Every copy-only REGISTRY schedule forced onto the gather body, f32
    and bf16 with negative zeros: bitwise against its plain version,
    ``schedule_exec_plain``, the global body and (f32) run_reference.
    [4, 64] takes the bulk path in both dtypes, [4, 33] in f32 (528 B a
    row); bf16 [4, 33] and [3, 5] the ragged path."""
    rng = np.random.default_rng(8)
    seen = 0
    for topo in TOPOS:
        for label, sched in _registry(topo):
            kex = get_kernel_exec(sched, topo=topo)
            if not kex.tables["copy_only"]:
                continue
            buf = _float_buf(rng, (topo.nranks, sched.num_slots) + slot)
            want = SimTransport(topo.nranks).run_reference(sched, buf)
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.from_numpy(buf).to(cuda_device, dtype)
                got = _gather_body(kex, g, label)
                assert kex.last_launch["path"] == (
                    "bulk" if _bulk(g) else "ragged"), label
                if dtype == torch.float32:
                    assert got.cpu().numpy().tobytes() == want.tobytes(), \
                        label
            seen += 1
    assert seen >= 50


@pytest.mark.parametrize("aggregate", [False, True])
def test_transport_gather_body_neighbor_plans(cuda_device, aggregate):
    """Neighbor plans on the four topologies at slots [2, 64] (bulk) and
    [3, 7] (ragged), f32 and bf16 with negative zeros: the gather body
    bitwise against its plain version, the global body and
    SimTransport.run."""
    from repro_torch.core.plan import CommGraph, build_plan
    topos = [Topology(8, 8), Topology(8, 4), Topology(16, 4),
             Topology(12, 3)]
    for i, topo in enumerate(topos):
        n = topo.nranks
        rng = np.random.default_rng(60 + i)
        graph = CommGraph.random(n, n_local=24, degree=min(n - 1, 6),
                                 rng=rng, dup_frac=0.7)
        plan = build_plan(graph, topo, aggregate=aggregate)
        kex = get_kernel_exec(plan.schedule, topo=topo)
        assert kex.tables["copy_only"]
        for slot in ((2, 64), (3, 7)):
            buf = _float_buf(rng, (n, plan.buf_rows) + slot)
            want = SimTransport(n, topo=topo).run(plan.schedule, buf)
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.from_numpy(buf).to(cuda_device, dtype)
                got = _gather_body(kex, g, (topo.fingerprint(), slot))
                assert kex.last_launch["path"] == (
                    "bulk" if slot == (2, 64) else "ragged")
                if dtype == torch.float32:
                    assert got.cpu().numpy().tobytes() == want.tobytes()


def _kv_moves(rng, blocks, count):
    from repro_torch.core import kvtransfer
    moves, used = [], set()
    while len(moves) < count:
        s, d = int(rng.integers(4)), 4 + int(rng.integers(4))
        row, dr = int(rng.integers(blocks)), int(rng.integers(blocks))
        if (d, dr) not in used:
            used.add((d, dr))
            moves.append(kvtransfer.BlockMove(s, row, d, dr))
    return moves


@pytest.mark.parametrize("block,dtype", [((16, 64), torch.float32),
                                         ((16, 256), torch.bfloat16),
                                         ((16, 2048), torch.float32)])
def test_transport_gather_body_kv_plan_1024_blocks(cuda_device, block,
                                                   dtype):
    """A KV plan at 1024 blocks a rank (thousands of rows, several
    rounds): the wrapper takes the gather body by itself, and forced at
    chunks 1/2/4 it is bitwise against its plain version, the global
    body and the gather oracle.  Blocks of 4 KiB and 8 KiB (several rows
    an item) and 128 KiB (a row over several segments)."""
    from repro_torch.core import kvtransfer
    topo = Topology(8, 4)
    moves = _kv_moves(np.random.default_rng(11), 1024, 2400)
    moves += [kvtransfer.BlockMove(0, 5, d, 1023 - d) for d in range(4, 8)
              if all((m.dst, m.dst_row) != (d, 1023 - d) for m in moves)]
    elem = torch.tensor([], dtype=dtype).element_size()
    tp = kvtransfer.build_transfer_plan(
        moves, topo, blocks_per_rank=1024,
        block_bytes=int(np.prod(block)) * elem)
    kex = get_kernel_exec(tp.schedule, topo=topo)
    pool = torch.randn((8, 1024) + block, device=cuda_device).to(dtype)
    pool.view(-1)[::7] = -0.0
    g = pool.new_zeros((8, tp.schedule.num_slots) + block)
    g[:, :1024] = pool
    n0 = cuda.TRANSPORT_BODIES["gather"]
    auto = kex.run(g)
    torch.cuda.synchronize()
    assert cuda.TRANSPORT_BODIES["gather"] == n0 + 1
    assert kex.last_launch["path"] == "bulk"
    got = _gather_body(kex, g, tp.schedule.name)
    assert torch.equal(_bits(auto), _bits(got))
    res = kvtransfer.run_transfer(tp, pool, transport="kernel")
    assert kvtransfer.verify_bitwise(tp, pool, res)


def test_transport_gather_body_off_16_bytes(cuda_device):
    """Aligned row lengths in buffers that start off 16 bytes: the
    ragged path (4-byte units in f32, 2-byte in bf16), bitwise against
    the bulk path on the aligned copy."""
    topo = Topology(8, 4)
    rng = np.random.default_rng(9)
    for label, sched in _registry(topo):
        kex = get_kernel_exec(sched, topo=topo)
        if not kex.tables["copy_only"]:
            continue
        buf = _float_buf(rng, (8, sched.num_slots, 4, 64))
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.from_numpy(buf).to(cuda_device, dtype)
            want = kex.run(g, _body="gather")
            assert kex.last_launch["path"] == "bulk", label
            got = _gather_body(kex, _off16(g), label)
            assert kex.last_launch["path"] == "ragged", label
            assert torch.equal(_bits(got), _bits(want)), label


@pytest.mark.parametrize("width", [64, 33])
def test_transport_gather_body_zero_rows_and_repeated_targets(
        cuda_device, monkeypatch, width):
    """A masked gather lands all-zero bytes (a -0.0 target turns +0.0),
    and at a repeated target the last landing wins, on the bulk (64) and
    the ragged (33) path, against run_reference."""
    monkeypatch.setenv("REPRO_VALIDATE_SCHEDULES", "0")
    masked = CommSchedule(nranks=2, num_slots=2, rounds=(CommRound(
        perm=((0, 1),), gather_idx=np.array([[-1, 0], [-1, -1]], np.int32),
        scatter_idx=np.array([[-1, -1], [0, 1]], np.int32),
        reduce=False),), name="masked")
    dup = CommSchedule(nranks=2, num_slots=2, rounds=(CommRound(
        perm=((0, 1), (1, 0)), gather_idx=np.array([[0, 1], [0, 1]],
                                                    np.int32),
        scatter_idx=np.array([[1, 1], [0, 0]], np.int32),
        reduce=False),), name="dup")
    rng = np.random.default_rng(10)
    for sched in (masked, dup):
        buf = _float_buf(rng, (2, 2, 4, width))
        buf[1] = -0.0
        want = SimTransport(2).run_reference(sched, buf)
        kex = get_kernel_exec(sched, optimize=False)
        assert kernel_lowering.gather_tables(kex.ex)["zero_rows"] == (
            sched.name == "masked")
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.from_numpy(buf).to(cuda_device, dtype)
            got = _gather_body(kex, g, sched.name)
            assert kex.last_launch["path"] == ("bulk" if _bulk(g)
                                               else "ragged")
            if dtype == torch.float32:
                assert got.cpu().numpy().tobytes() == want.tobytes()


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


def _ulp_close(got, want):
    """Within one bf16 ulp of ``want`` (f32: 1e-5)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs()
                                         .clamp_min(1e-30))) - 7)
    assert bool(((got.float() - want.float()).abs() <= ulp).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 100, 2304, 5120, 16384])
@pytest.mark.parametrize("P", [1, 2, 3, 8])
def test_rmsnorm_kernel_bodies(cuda_device, dtype, d, P):
    """Every width, P and dtype on the body ``rmsnorm_body`` names (each
    launch counted by body), R = 1 and R = 37 rows, aligned and at an
    odd element offset (which must take the scalar body)."""
    rng = np.random.default_rng(d + P)
    scale = torch.from_numpy(rng.standard_normal(d).astype(np.float32)
                             ).to(cuda_device)
    for R in (1, 37):
        flat = torch.from_numpy(rng.standard_normal(P * R * d + 1)
                                .astype(np.float32)).to(cuda_device, dtype)
        for off in (0, 1):
            parts = flat[off:off + P * R * d].view(P, R, d)
            want_body = rmsnorm_body(d, dtype, parts.data_ptr() % 16)[0]
            if off:
                assert want_body == "scalar"
            before = dict(cuda.RMSNORM_BODIES)
            if P == 1:
                got = rmsnorm_2d(parts[0], scale, gemma_style=True)
                want = rmsnorm_plain(parts[0], scale, gemma_style=True)
            else:
                got = rmsnorm_reduce_2d(parts, scale)
                want = rmsnorm_reduce_plain(parts, scale)
            torch.cuda.synchronize()
            assert cuda.RMSNORM_BODIES[want_body] == before[want_body] + 1
            _ulp_close(got, want)


def test_rmsnorm_bf16_at_8_bytes_takes_the_scalar_body(cuda_device):
    """A bf16 row 8 bytes past a 16-byte boundary is whole vectors of
    width but must not take the 16-byte path."""
    rng = np.random.default_rng(9)
    flat = torch.from_numpy(rng.standard_normal(4 * 5120 + 4)
                            .astype(np.float32)).to(cuda_device,
                                                    torch.bfloat16)
    x = flat[4:].view(4, 5120)
    assert x.data_ptr() % 16 == 8
    scale = torch.ones(5120, device=cuda_device)
    n0 = cuda.RMSNORM_BODIES["scalar"]
    _ulp_close(rmsnorm_2d(x, scale), rmsnorm_plain(x, scale))
    assert cuda.RMSNORM_BODIES["scalar"] == n0 + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_fast_path_equals_autograd_path(cuda_device, dtype):
    """The no-grad call (straight to the 2-D wrapper) and the autograd
    call give the same bits, for both ops, at a 3-D input."""
    rng = np.random.default_rng(10)
    parts = torch.from_numpy(rng.standard_normal((8, 2, 33, 2304))
                             .astype(np.float32)).to(cuda_device, dtype)
    scale = torch.from_numpy(rng.standard_normal(2304).astype(np.float32)
                             ).to(cuda_device, dtype)
    for op, x in ((rms_ops.rmsnorm, parts[0]),
                  (rms_ops.rmsnorm_allreduce, parts)):
        with torch.no_grad():
            fast = op(x, scale, 1e-6, True)
        slow = op(x.clone().requires_grad_(), scale, 1e-6, True)
        assert slow.requires_grad and not fast.requires_grad
        assert torch.equal(_bits(fast), _bits(slow.detach()))
        slow.float().sum().backward()


ATTN_VARIANTS = [dict(causal=True), dict(causal=True, window=48),
                 dict(causal=True, softcap=50.0),
                 dict(causal=True, window=48, softcap=30.0),
                 dict(causal=False), dict(causal=False, window=40)]
ATTN_TOL = {torch.float32: dict(atol=3e-5, rtol=3e-5),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _attn_inputs(rng, device, dtype, B, Sq, Sk, H, K, D):
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(device, dtype)
            for shape in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H,K", [(64, 2, 2), (128, 8, 4), (256, 8, 1),
                                   (20, 6, 2)])
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, D, H, K):
    """Head dims 64/128/256 (and 20: bf16 on the CUDA-core body), GQA
    groups 1/2/8/3, every mask/softcap variant; 160 rows leave a ragged
    tile."""
    rng = np.random.default_rng(D + H)
    q, k, v = _attn_inputs(rng, cuda_device, dtype, 2, 160, 160, H, K, D)
    for kw in ATTN_VARIANTS:
        n0 = cuda.LAUNCHES["flash_attention"]
        got = flash_attention_bshd(q, k, v, **kw)
        torch.cuda.synchronize()
        assert cuda.LAUNCHES["flash_attention"] == n0 + 1
        want = flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(got, want, **ATTN_TOL[dtype],
                                   msg=lambda m: f"{kw}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gather_kernel_matches_plain(cuda_device, dtype):
    B, S, H, K, D = 2, 256, 8, 4, 128
    rng = np.random.default_rng(11)
    q, k, v = _attn_inputs(rng, cuda_device, dtype, B, S, S, H, K, D)
    rows = np.stack([rng.permutation(S) for _ in range(B)]).astype(np.int32)
    rows[:, ::8] = -1
    rows_t = torch.from_numpy(rows).to(cuda_device)
    for kw in ATTN_VARIANTS:
        n0 = cuda.LAUNCHES["flash_attention_gather"]
        got = flash_attention_bshd(q, k, v, q_rows=rows_t, **kw)
        torch.cuda.synchronize()
        assert cuda.LAUNCHES["flash_attention_gather"] == n0 + 1
        want = flash_attention_plain(q, k, v, q_rows=rows_t, **kw)
        torch.testing.assert_close(got, want, **ATTN_TOL[dtype])
        assert not got[torch.from_numpy(rows < 0)].any()


def _on_body(body, fn):
    """``fn()``, asserting that it ran one flash launch on ``body``."""
    n0 = cuda.FLASH_BODIES[body]
    out = fn()
    torch.cuda.synchronize()
    assert cuda.FLASH_BODIES[body] == n0 + 1, dict(cuda.FLASH_BODIES)
    return out


def test_flash_attention_kernel_fully_masked_rows(cuda_device):
    """Rows with no live key (Sq >= Sk + window) weigh every key equally,
    as the reference does."""
    rng = np.random.default_rng(12)
    q, k, v = _attn_inputs(rng, cuda_device, torch.float32, 1, 200, 40, 2,
                           1, 64)
    for causal in (True, False):
        got = flash_attention_bshd(q, k, v, causal=causal, window=8)
        want = flash_attention_plain(q, k, v, causal=causal, window=8)
        torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


def test_flash_attention_kernel_fully_masked_rows_bf16(cuda_device):
    """The same on the Hopper body (Sk = 40 is one ragged kv tile)."""
    rng = np.random.default_rng(12)
    q, k, v = _attn_inputs(rng, cuda_device, torch.bfloat16, 1, 200, 40, 2,
                           1, 64)
    for causal in (True, False):
        got = _on_body("wgmma", lambda: flash_attention_bshd(
            q, k, v, causal=causal, window=8))
        want = flash_attention_plain(q, k, v, causal=causal, window=8)
        torch.testing.assert_close(got, want, **ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("K", [8, 4, 1])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_wgmma_long(cuda_device, D, K):
    """bf16 at 1024 rows on the Hopper body: 8 q tiles of 128, enough kv
    tiles to wrap the stage ring and to reach interior (unmasked) tiles,
    GQA groups 1/2/8, every mask/softcap variant."""
    rng = np.random.default_rng(D + K)
    q, k, v = _attn_inputs(rng, cuda_device, torch.bfloat16, 1, 1024, 1024,
                           8, K, D)
    for kw in ATTN_VARIANTS + [dict(causal=True, window=300)]:
        got = _on_body("wgmma", lambda: flash_attention_bshd(q, k, v, **kw))
        want = flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(got, want, **ATTN_TOL[torch.bfloat16],
                                   msg=lambda m: f"{kw}: {m}")


@pytest.mark.parametrize("Sq,Sk,D", [(1024, 700, 128), (500, 1024, 256),
                                     (300, 1024, 40), (1024, 333, 96),
                                     (400, 500, 136)])
def test_flash_attention_wgmma_ragged(cuda_device, Sq, Sk, D):
    """Sq != Sk, ragged last tiles, and head dims padded to 64/128/256
    (the tensor maps' out-of-bounds zero fill, whole boxes past D at
    136)."""
    rng = np.random.default_rng(Sq + Sk + D)
    q, k, v = _attn_inputs(rng, cuda_device, torch.bfloat16, 2, Sq, Sk, 4,
                           2, D)
    for kw in ATTN_VARIANTS:
        got = _on_body("wgmma", lambda: flash_attention_bshd(q, k, v, **kw))
        want = flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(got, want, **ATTN_TOL[torch.bfloat16],
                                   msg=lambda m: f"{kw}: {m}")


@pytest.mark.parametrize("D,H,K,pad_v", [(192, 128, 128, 64),
                                         (64, 12, 12, 0), (128, 28, 4, 0)])
def test_flash_attention_wgmma_model_shapes(cuda_device, D, H, K, pad_v):
    """The shapes the remaining archs give the kernel, bf16, each call on
    the Hopper body: MLA's head dim 192 (three whole 64-column boxes in
    the 256-wide tiles) with v's last ``pad_v`` columns zero, as
    deepseek-v3 pads v from 128; whisper's decoder (12 heads of 64);
    qwen2-vl's GQA group 7 (28 q heads over 4 kv heads).  The output's
    padded columns stay exact zeros."""
    rng = np.random.default_rng(D + H + K)
    q, k, v = _attn_inputs(rng, cuda_device, torch.bfloat16, 1, 256, 256, H,
                           K, D)
    if pad_v:
        v[..., D - pad_v:] = 0
    variants = [dict(causal=True), dict(causal=True, scale=D ** -0.5),
                dict(causal=False)]
    for kw in variants:
        got = _on_body("wgmma", lambda: flash_attention_bshd(q, k, v, **kw))
        want = flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(got, want, **ATTN_TOL[torch.bfloat16],
                                   msg=lambda m: f"{kw}: {m}")
        if pad_v:
            assert not got[..., D - pad_v:].any()


def test_flash_attention_mla_call_on_the_wgmma_body(cuda_device):
    """``models.mla``'s kernel path at deepseek's head widths (nope 128,
    rope 64, v 128) on up-projected heads: k_rope repeated over the
    heads by ``torch.cat`` (an ``expand`` view's zero head stride would
    send it to the CUDA-core body), one launch on the wgmma body, within
    2e-2 of the plain ``_attend`` core."""
    from repro_torch.models import mla
    from repro_torch.models.config import MLAConfig
    cfg = MLAConfig(q_lora_rank=64, kv_lora_rank=64, qk_nope_head_dim=128,
                    qk_rope_head_dim=64, v_head_dim=128, n_heads=8)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    layer = mla.init(cfg, 256, generator=g, device=cuda_device)
    x = torch.randn((1, 256, 256), generator=g, device=cuda_device,
                    dtype=torch.float32).to(torch.bfloat16)
    pos = torch.arange(256, device=cuda_device)[None]
    with torch.no_grad():
        lat = mla._latents(layer, cfg, x, pos, 1e-6)
        got = _on_body("wgmma", lambda: mla._kernel_core(layer, cfg, *lat))
        S = 256
        want = mla._attend(layer, cfg, *lat, torch.ones(
            (S, S), dtype=torch.bool, device=cuda_device).tril()[None])
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


def test_flash_attention_wgmma_gather_long(cuda_device):
    """The gather prologue on the Hopper body at 1024 rows, 1/8 of them
    dead (exact zeros)."""
    B, S, H, K, D = 2, 1024, 8, 4, 256
    rng = np.random.default_rng(14)
    q, k, v = _attn_inputs(rng, cuda_device, torch.bfloat16, B, S, S, H, K,
                           D)
    rows = np.stack([rng.permutation(S) for _ in range(B)]).astype(np.int32)
    rows[:, ::8] = -1
    rows[0, 5] = S + 3                          # outside [0, Sq): dead too
    rows_t = torch.from_numpy(rows).to(cuda_device)
    for kw in ATTN_VARIANTS:
        got = _on_body("wgmma", lambda: flash_attention_bshd(
            q, k, v, q_rows=rows_t, **kw))
        want = flash_attention_plain(q, k, v, q_rows=rows_t, **kw)
        torch.testing.assert_close(got, want, **ATTN_TOL[torch.bfloat16])
        dead = torch.from_numpy((rows < 0) | (rows >= S))
        assert not got[dead].any()


def test_flash_attention_misaligned_bf16_runs_on_cuda_cores(cuda_device):
    """bf16 rows off 16-byte alignment cannot be described to the TMA:
    the same call runs on the CUDA-core body, and matches."""
    rng = np.random.default_rng(15)
    q, k, v = _attn_inputs(rng, cuda_device, torch.bfloat16, 1, 256, 256, 4,
                           2, 128)

    def shifted(t):                             # storage 2 bytes past 16
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        u = buf[1:].view(t.shape)
        u.copy_(t)
        return u
    qs, ks, vs = (shifted(t) for t in (q, k, v))
    for kw in (dict(causal=True), dict(causal=True, window=48,
                                       softcap=30.0)):
        got = _on_body("cuda_cores",
                       lambda: flash_attention_bshd(qs, ks, vs, **kw))
        want = flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(got, want, **ATTN_TOL[torch.bfloat16])


def test_flash_attention_op_grad_and_errors(cuda_device):
    rng = np.random.default_rng(13)
    q, k, v = _attn_inputs(rng, cuda_device, torch.float32, 1, 128, 128, 4,
                           2, 64)
    qg = q.clone().requires_grad_()
    attn_ops.flash_attention(qg, k, v, True, 32, 50.0).sum().backward()
    qr = q.clone().requires_grad_()
    attn_ops.attention_ref(qr, k, v, causal=True, window=32,
                           softcap=50.0).sum().backward()
    torch.testing.assert_close(qg.grad, qr.grad, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros(1, 64, 1, 320, device=cuda_device)
        flash_attention_bshd(z, z, z)
    with pytest.raises(TypeError, match="dtype"):
        z = torch.zeros(1, 64, 1, 64, device=cuda_device,
                        dtype=torch.float16)
        flash_attention_bshd(z, z, z)


WKV_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _wkv_inputs(rng, device, B, T, H, N, rkv, wdt):
    r, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, N))
                                .astype(np.float32)).to(device, rkv)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.from_numpy(
        rng.standard_normal((B, T, H, N)).astype(np.float32)))).to(device,
                                                                   wdt)
    u = torch.from_numpy(rng.standard_normal((H, N)).astype(np.float32)
                         ).to(device)
    return r, k, v, w, u


@pytest.mark.parametrize("rkv,wdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("B,T,H,N", [(1, 16, 1, 8), (2, 64, 3, 16),
                                     (1, 128, 2, 32), (2, 48, 4, 8),
                                     (1, 200, 40, 64), (2, 33, 2, 128)])
def test_wkv6_kernel_matches_plain(cuda_device, rkv, wdt, B, T, H, N):
    """The reference's sweep shapes, the model's head size 64 at 40
    heads and a T that is no multiple of 64; f32, bf16 and the model's
    mix (bf16 r/k/v, f32 w)."""
    rng = np.random.default_rng(T + H + N)
    args = _wkv_inputs(rng, cuda_device, B, T, H, N, rkv, wdt)
    n0 = cuda.LAUNCHES["wkv6"]
    got = wkv6_bthn(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["wkv6"] == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (B, T, H, N)
    torch.testing.assert_close(got, wkv6_plain(*args),
                               **WKV_TOL[torch.float32 if rkv == wdt ==
                                         torch.float32 else torch.bfloat16])


def test_wkv6_kernel_reads_strides(cuda_device):
    """r/k/v as views of one [B, T, H, 3N] projection (the head stride is
    3N) give what their contiguous copies give, bit for bit."""
    rng = np.random.default_rng(21)
    B, T, H, N = 2, 70, 4, 64
    rkv = torch.from_numpy(rng.standard_normal((B, T, H, 3 * N))
                           .astype(np.float32)).to(cuda_device)
    r, k, v = rkv[..., :N], rkv[..., N:2 * N], rkv[..., 2 * N:]
    _, _, _, w, u = _wkv_inputs(rng, cuda_device, B, T, H, N,
                                torch.float32, torch.float32)
    got = wkv6_bthn(r, k, v, w, u)
    want = wkv6_bthn(r.contiguous(), k.contiguous(), v.contiguous(), w, u)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, wkv6_plain(r, k, v, w, u),
                               **WKV_TOL[torch.float32])


# (B, T, chunk): T below, at and one past a chunk, a multiple of it, the
# launcher's and the sweep's short T, T = 200, and rwkv6-3b's 8192 at
# the chunk the wrapper picks (None) and at the shortest it may pick
WKV_CHUNK_EDGES = [(2, 15, 16), (2, 16, 16), (2, 17, 16), (2, 64, 16),
                   (2, 200, 16), (2, 200, None), (2, 32, None),
                   (2, 16, None), (2, 8192, None), (2, 8192, 64),
                   (2, 1000, 128)]


@pytest.mark.parametrize("B,T,chunk", WKV_CHUNK_EDGES)
def test_wkv6_kernel_chunk_edges(cuda_device, B, T, chunk):
    """The chunk-parallel scan at its edges, in f32 at 2e-5 and in the
    model's mix at 2e-2; the phases that ran match the chunk count."""
    H, N = (40, 64) if T == 8192 else (3, 64)
    rng = np.random.default_rng(T + (chunk or 0))
    for rkv, wdt in ((torch.float32, torch.float32),
                     (torch.bfloat16, torch.float32)):
        args = _wkv_inputs(rng, cuda_device, B, T, H, N, rkv, wdt)
        n0 = cuda.LAUNCHES["wkv6"]
        got = wkv6_bthn(*args, chunk=chunk)
        torch.cuda.synchronize()
        assert cuda.LAUNCHES["wkv6"] == n0 + 1
        run = wkv_kernel.LAST_LAUNCH
        C = chunk or wkv_kernel.wkv6_chunk(B, T, H, N)
        assert run["chunk"] == C and run["chunks"] == -(-T // C)
        assert (run["grids"]["state"] is None) == (T <= C)
        assert (run["grids"]["carry"] is None) == (T <= 2 * C)
        torch.testing.assert_close(
            got, wkv6_plain(*args),
            **WKV_TOL[torch.float32 if rkv == torch.float32
                      else torch.bfloat16])


@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("rkv", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_decay_extremes(cuda_device, chunk, rkv):
    """w = exp(-exp(x)) with x up to +5 (exactly 0 in f32 past ~4.6),
    channels of exact 0 and exact 1, a whole chunk of zero decays in
    every head and one more in one head of one batch row: finite, and
    within the tolerance of the plain version."""
    rng = np.random.default_rng(30 + chunk)
    B, T, H, N = 2, 5 * chunk + 3, 3, 64
    r, k, v, _, u = _wkv_inputs(rng, cuda_device, B, T, H, N, rkv,
                                torch.float32)
    x = torch.from_numpy(rng.uniform(-3.0, 5.0, (B, T, H, N))
                         .astype(np.float32)).to(cuda_device)
    w = torch.exp(-torch.exp(x))
    w[..., 0] = 0.0
    w[..., 1] = 1.0
    w[:, chunk:2 * chunk] = 0.0
    w[1, 3 * chunk:4 * chunk, 2] = 0.0
    got = wkv6_bthn(r, k, v, w, u, chunk=chunk)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, wkv6_plain(r, k, v, w, u),
                               **WKV_TOL[rkv])


def test_wkv6_kernel_reads_strides_in_every_phase(cuda_device):
    """Views of one projection against their copies, bit for bit, with
    three phases running (T = 70 at chunk 16: five chunks)."""
    rng = np.random.default_rng(23)
    B, T, H, N = 2, 70, 4, 64
    rkv = torch.from_numpy(rng.standard_normal((B, T, H, 3 * N))
                           .astype(np.float32)).to(cuda_device)
    r, k, v = rkv[..., :N], rkv[..., N:2 * N], rkv[..., 2 * N:]
    _, _, _, w, u = _wkv_inputs(rng, cuda_device, B, T, H, N,
                                torch.float32, torch.float32)
    w_view = torch.cat([w, w], -1)[..., :N]
    got = wkv6_bthn(r, k, v, w_view, u, chunk=16)
    assert wkv_kernel.LAST_LAUNCH["grids"]["carry"] is not None
    want = wkv6_bthn(r.contiguous(), k.contiguous(), v.contiguous(), w, u,
                     chunk=16)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, wkv6_plain(r, k, v, w, u),
                               **WKV_TOL[torch.float32])


def test_wkv6_op_grad_and_errors(cuda_device):
    rng = np.random.default_rng(22)
    args = _wkv_inputs(rng, cuda_device, 1, 32, 2, 16, torch.float32,
                       torch.float32)
    rg = args[0].clone().requires_grad_()
    wkv_ops.wkv6(rg, *args[1:]).sum().backward()
    rr = args[0].clone().requires_grad_()
    wkv6_ref(rr, *args[1:])[0].sum().backward()
    torch.testing.assert_close(rg.grad, rr.grad, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="head size"):
        wkv6_bthn(*_wkv_inputs(rng, cuda_device, 1, 8, 1, 12, torch.float32,
                               torch.float32))
    with pytest.raises(TypeError, match="dtype"):
        wkv6_bthn(*_wkv_inputs(rng, cuda_device, 1, 8, 1, 16, torch.float16,
                               torch.float32))


SCAN_TOL = WKV_TOL


def _scan_inputs(rng, device, B, T, Di, S, x=torch.float32, dt=torch.float32):
    """As the reference's sweep draws them: xc, B, C normal (in ``x``), dt
    = 0.1 |normal| (in ``dt``), A = -exp(normal), D normal."""
    def t(shape, dtype, f=lambda a: a):
        return torch.from_numpy(f(rng.standard_normal(shape)).astype(
            np.float32)).to(device, dtype)
    return (t((B, T, Di), x), t((B, T, Di), dt, lambda a: np.abs(a) * 0.1),
            t((B, T, S), x), t((B, T, S), x),
            t((Di, S), torch.float32, lambda a: -np.exp(a)),
            t((Di,), torch.float32))


@pytest.mark.parametrize("x,dt", [(torch.float32, torch.float32),
                                  (torch.bfloat16, torch.bfloat16),
                                  (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("B,T,Di,S", [(1, 16, 8, 4), (2, 64, 32, 8),
                                      (1, 128, 64, 16), (2, 48, 24, 8),
                                      (1, 200, 300, 16), (2, 33, 130, 4),
                                      (3, 1, 16, 8), (4, 40, 16384, 16),
                                      (2, 24, 16384, 8), (2, 1, 24, 16),
                                      (1, 31, 130, 8), (2, 33, 300, 4),
                                      (1, 31, 24, 16), (1, 33, 8192, 16)])
def test_mamba_scan_kernel_matches_plain(cuda_device, x, dt, B, T, Di, S):
    """The reference's sweep shapes; T of 1 and one below and above the
    plan's 32-step tile; Di of 24, 130 and 300 (no multiple of a CTA's
    channels; bf16 rows of 260 and 600 bytes, which TMA cannot take);
    S of 4, 8 and 16; one and two groups of 32 channels a CTA; f32,
    bf16 and the f32 model's mix (bf16 dt)."""
    rng = np.random.default_rng(T + Di + S)
    args = _scan_inputs(rng, cuda_device, B, T, Di, S, x, dt)
    n0 = cuda.LAUNCHES["mamba_scan"]
    got = selective_scan_bdt(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["mamba_scan"] == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (B, T, Di)
    torch.testing.assert_close(got, selective_scan_plain(*args),
                               **SCAN_TOL[torch.float32 if x == dt ==
                                          torch.float32 else torch.bfloat16])


# (xc, dt) dtypes -> the ring's stages at S 16 with two groups a CTA: as
# many as keep two CTAs on an SM
SCAN_STAGES = {(torch.bfloat16, torch.bfloat16): 4,
               (torch.float32, torch.bfloat16): 3,
               (torch.float32, torch.float32): 2}


@pytest.mark.parametrize("x,dt", list(SCAN_STAGES))
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("S", [4, 8, 16])
def test_mamba_scan_every_plan(cuda_device, S, groups, x, dt):
    """Every tiling the library holds (W = S / 4, one or two groups of 32
    channels a CTA), reached through the shapes that ``scan_plan`` maps
    to it, at T and Di tails, in each dtype pair; the stage counts that
    the dtypes give at S 16."""
    Di = 200 if groups == 1 else 64 * 66 + 7      # 2 x 67 CTAs of 64
    rng = np.random.default_rng(S * 10 + groups)
    args = _scan_inputs(rng, cuda_device, 2, 2 * 32 + 3, Di, S, x, dt)
    got = selective_scan_bdt(*args)
    launch = scan_kernel.LAST_LAUNCH
    assert launch["plan"] == scan_kernel.ScanPlan(S // 4, groups)
    assert 2 <= launch["stages"] <= 4 and launch["ctas_per_sm"] >= 1
    if S == 16 and groups == 2:
        assert launch["stages"] == SCAN_STAGES[x, dt]
        assert launch["ctas_per_sm"] == 2
    torch.testing.assert_close(got, selective_scan_plain(*args),
                               **SCAN_TOL[torch.float32 if x == dt ==
                                          torch.float32 else torch.bfloat16])


def test_mamba_scan_plain_loads_path(cuda_device):
    """xc and dt off 16-byte alignment (views one element into a wider
    row) take the producer's plain loads, not TMA boxes, and agree with
    their contiguous copies bit for bit."""
    rng = np.random.default_rng(27)
    B, T, Di, S = 2, 75, 192, 16
    xd = torch.from_numpy(rng.standard_normal((B, T, 2 * Di + 1)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    xc = xd[..., 1:Di + 1]
    wide = torch.zeros((B, T, Di + 1), device=cuda_device,
                       dtype=torch.bfloat16)
    wide[..., 1:] = xd[..., Di + 1:].abs() * 0.1
    dt = wide[..., 1:]
    assert not scan_kernel.tma_ok(xc) and not scan_kernel.tma_ok(dt)
    *_, bm, cm, A, D = _scan_inputs(rng, cuda_device, B, T, Di, S,
                                    torch.bfloat16, torch.bfloat16)
    got = selective_scan_bdt(xc, dt, bm, cm, A, D)
    assert scan_kernel.LAST_LAUNCH["loads"] == {"xc": "plain",
                                                "dt": "plain"}
    want = selective_scan_bdt(xc.contiguous(), dt.contiguous(), bm, cm, A,
                              D)
    assert scan_kernel.LAST_LAUNCH["loads"] == {"xc": "tma", "dt": "tma"}
    assert torch.equal(got, want)
    torch.testing.assert_close(got, selective_scan_plain(xc, dt, bm, cm, A,
                                                         D),
                               **SCAN_TOL[torch.bfloat16])


def test_mamba_scan_flush_to_zero(cuda_device):
    """dt A below -126 ln 2 on half the states: ex2.approx.ftz gives
    exactly 0 there, the plain version a subnormal; within 2e-5."""
    rng = np.random.default_rng(28)
    xc, dt, bm, cm, A, D = _scan_inputs(rng, cuda_device, 1, 64, 256, 16)
    dt = torch.full_like(dt, 2.0)
    A = A.clone()
    A[:, ::2] = -45.0                       # dt A = -90 < -87.3
    torch.testing.assert_close(selective_scan_bdt(xc, dt, bm, cm, A, D),
                               selective_scan_plain(xc, dt, bm, cm, A, D),
                               **SCAN_TOL[torch.float32])


def test_mamba_scan_kernel_matches_twin(cuda_device):
    """The kernel against its CPU twin (the same tiling and order of
    adds, each fused multiply-add rounded once), in f32.  With A = 0
    every decay is exactly 1 and no exp rounds, so the two agree bit for
    bit, and on these inputs the W partials added in reverse, or D x
    added first, would not.  With A drawn, the kernel's ex2.approx and
    the twin's exp2 part them by rounding only."""
    rng = np.random.default_rng(29)
    args = _scan_inputs(rng, cuda_device, 2, 70, 130, 16)
    xc, dt, bm, cm, A, D = (t.cpu() for t in args)
    zero = (xc, dt, bm, cm, torch.zeros_like(A), D)
    got = selective_scan_bdt(*(t.to(cuda_device) for t in zero)).cpu()
    assert torch.equal(got, selective_scan_tiles(*zero))
    part, x = scan_tiles.partials(*zero[:5])
    dx = torch.zeros(x.shape[-1])
    dx[:D.shape[0]] = D
    dx = dx * x
    rev = part[-1]
    for w in range(part.shape[0] - 2, -1, -1):
        rev = rev + part[w]
    first = dx + part[0]
    for w in range(1, part.shape[0]):
        first = first + part[w]
    for other in (rev + dx, first):
        assert not torch.equal(got, other[:, :70, :130])
    got = selective_scan_bdt(*args).cpu()
    torch.testing.assert_close(got, selective_scan_tiles(xc, dt, bm, cm, A,
                                                         D),
                               atol=2e-5, rtol=2e-5)


def test_mamba_scan_kernel_reads_strides(cuda_device):
    """xc and dt as views of one [B, T, 2 Di] tensor, B and C as views of
    one [B, T, R + 2 S] projection, give what their contiguous copies
    give, bit for bit."""
    rng = np.random.default_rng(23)
    B, T, Di, S = 2, 70, 96, 16
    xd = torch.from_numpy(rng.standard_normal((B, T, 2 * Di)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    xc, dt = xd[..., :Di], xd[..., Di:].abs() * 0.1
    proj = torch.from_numpy(rng.standard_normal((B, T, 8 + 2 * S)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    bm, cm = proj[..., 8:8 + S], proj[..., 8 + S:]
    *_, A, D = _scan_inputs(rng, cuda_device, B, T, Di, S)
    got = selective_scan_bdt(xc, dt, bm, cm, A, D)
    want = selective_scan_bdt(xc.contiguous(), dt, bm.contiguous(),
                              cm.contiguous(), A, D)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, selective_scan_plain(xc, dt, bm, cm, A,
                                                         D),
                               **SCAN_TOL[torch.bfloat16])


def test_mamba_scan_op_grad_and_errors(cuda_device):
    rng = np.random.default_rng(24)
    args = _scan_inputs(rng, cuda_device, 1, 32, 16, 8)
    xg = args[0].clone().requires_grad_()
    scan_ops.selective_scan(xg, *args[1:]).sum().backward()
    xr = args[0].clone().requires_grad_()
    selective_scan_ref(xr, *args[1:])[0].sum().backward()
    torch.testing.assert_close(xg.grad, xr.grad, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="state size"):
        selective_scan_bdt(*_scan_inputs(rng, cuda_device, 1, 8, 16, 12))
    with pytest.raises(TypeError, match="dtype"):
        selective_scan_bdt(*_scan_inputs(rng, cuda_device, 1, 8, 16, 8,
                                         x=torch.float16))


def test_mamba_scan_failed_launch_raises(cuda_device, monkeypatch):
    """A launch the CUDA runtime refuses raises; nothing falls back to
    the plain version and nothing is counted."""
    class Refusing:
        def repro_mamba_scan(self, *args):
            return 1                       # cudaErrorInvalidValue

    args = _scan_inputs(np.random.default_rng(25), cuda_device, 1, 8, 16, 8)
    monkeypatch.setattr(cuda, "library", lambda: Refusing())
    n0 = cuda.LAUNCHES["mamba_scan"]
    with pytest.raises(RuntimeError, match="mamba_scan: cudaError_t 1"):
        scan_ops.selective_scan(*args)
    assert cuda.LAUNCHES["mamba_scan"] == n0


def test_failed_build_raises(cuda_device, monkeypatch, tmp_path):
    """A source nvcc refuses makes the first launch raise (no library is
    loaded, nothing falls back)."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(cuda, "CSRC", src)
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda, "_LIB", None)
    args = _scan_inputs(np.random.default_rng(26), cuda_device, 1, 8, 16, 8)
    with pytest.raises(RuntimeError, match="nvcc failed for broken.cu"):
        scan_ops.selective_scan(*args)
    assert cuda._LIB is None
