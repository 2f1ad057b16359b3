"""The port's transports against the reference oracle, bit for bit.

``SimTransport.run_reference`` of the JAX package is the oracle.  The
port's vectorized simulator (``CompiledExec.run_sim``) and the plain
PyTorch version of the transport kernel (``schedule_exec_plain``, what
``KernelTransport`` runs on a CPU tensor) must reproduce it exactly for
every REGISTRY schedule, in float32 and bfloat16.  Inputs are random
floats (so add order matters) with negative zeros sprinkled in, and a
hand-built round pins the ``x + 0`` adds of masked gathers (they turn
-0.0 into +0.0); bfloat16 is compared by raw bits.  The CUDA kernel
itself is held against the plain version in tests/test_torch_cuda.py.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import executor as jexecutor
from repro.core import pallas_lowering as jpallas
from repro.core.algorithms import REGISTRY as JREGISTRY
from repro.core.schedule import NotApplicable as JNotApplicable
from repro.core.topology import Topology as JTopology
from repro.core.topology import flat_topology as jflat
from repro.core.topology import torus_topology as jtorus
from repro.core.transport import PallasTransport as JPallasTransport
from repro.core.transport import SimTransport as JSimTransport

from repro_torch import cuda
from repro_torch.core import executor, kernel_lowering
from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.kernel_lowering import (KernelExec, get_kernel_exec,
                                              pick_tile, schedule_exec_plain)
from repro_torch.core.schedule import CommRound, CommSchedule
from repro_torch.core.topology import Topology, flat_topology, torus_topology
from repro_torch.core.transport import KernelTransport, SimTransport

TOPOS = {
    "flat8": (jflat(8), flat_topology(8)),
    "2pod": (JTopology(8, 4), Topology(8, 4)),
    "3lvl": (jtorus(2, 2, 2), torus_topology(2, 2, 2)),
    "3lvl16": (jtorus(2, 4, 2), torus_topology(2, 4, 2)),
}


@pytest.fixture(autouse=True)
def _fresh_caches():
    executor.clear_cache()
    kernel_lowering.clear_cache()
    yield
    executor.clear_cache()
    kernel_lowering.clear_cache()


def _schedules(topo_name):
    jt, pt = TOPOS[topo_name]
    out = []
    for coll, algos in JREGISTRY.items():
        for name, builder in algos.items():
            try:
                js = builder(jt)
            except JNotApplicable:
                continue
            out.append((f"{coll}.{name}", js, REGISTRY[coll][name](pt)))
    return out


def _float_buf(rng, shape):
    """Random floats with some negative zeros."""
    buf = rng.standard_normal(shape).astype(np.float32)
    buf.reshape(-1)[::7] = -0.0
    return buf


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bits(x):
    """Raw bits as a numpy uint array (torch or numpy input)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    if x.dtype == ml_dtypes.bfloat16:
        return x.view(np.uint16)
    return x.view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topo_name", list(TOPOS))
def test_sim_and_plain_kernel_bitwise_vs_reference(topo_name, dtype):
    jt, pt = TOPOS[topo_name]
    n = pt.nranks
    rng = np.random.default_rng(11)
    ref = JSimTransport(n)
    seen = 0
    for label, js, ps in _schedules(topo_name):
        buf = _float_buf(rng, (n, js.num_slots, 3, 5))
        if dtype == "bfloat16":
            buf = buf.astype(ml_dtypes.bfloat16)
        want = _bits(ref.run_reference(js, buf))
        tbuf = _to_torch(buf)
        ex = executor.get_executor(ps, topo=pt)
        got_sim = ex.run_sim(buf)
        np.testing.assert_array_equal(_bits(got_sim), want, err_msg=label)
        got_plain = schedule_exec_plain(ex, tbuf)
        np.testing.assert_array_equal(_bits(got_plain), want, err_msg=label)
        got_tr = KernelTransport(n, topo=pt).run_global(ps, tbuf)
        np.testing.assert_array_equal(_bits(got_tr), want, err_msg=label)
        seen += 1
    assert seen >= 15


@pytest.mark.parametrize("topo_name,coll,algo,dtype", [
    ("flat8", "allgather", "bruck", "float32"),
    ("2pod", "reduce_scatter", "hierarchical", "bfloat16"),
])
def test_plain_kernel_matches_pallas_interpret(topo_name, coll, algo, dtype):
    """The reference's single-kernel Pallas transport (interpret mode on
    the CPU) and the port's kernel plain version agree bitwise."""
    jt, pt = TOPOS[topo_name]
    js, ps = JREGISTRY[coll][algo](jt), REGISTRY[coll][algo](pt)
    rng = np.random.default_rng(5)
    buf = _float_buf(rng, (pt.nranks, js.num_slots, 2, 3))
    if dtype == "bfloat16":
        buf = buf.astype(ml_dtypes.bfloat16)
    try:
        want = np.asarray(JPallasTransport(jt.nranks, topo=jt)
                          .run_global(js, buf))
    finally:
        jpallas.clear_cache()
        jexecutor.clear_cache()
    got = KernelTransport(pt.nranks, topo=pt).run_global(ps, _to_torch(buf))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_chunks_bit_identical():
    jt, pt = TOPOS["2pod"]
    sched = REGISTRY["alltoall"]["hierarchical"](pt)
    rng = np.random.default_rng(2)
    buf = torch.from_numpy(_float_buf(rng, (8, sched.num_slots, 8, 3)))
    kex = get_kernel_exec(sched, topo=pt)
    base = kex.run(buf)
    for chunks in (2, 4, 8):
        assert torch.equal(kex.run(buf, chunks=chunks).view(torch.int32),
                           base.view(torch.int32)), chunks
        got = SimTransport(8, topo=pt).run_chunked(sched, buf.numpy(),
                                                   chunks=chunks)
        np.testing.assert_array_equal(_bits(got), _bits(base))
    with pytest.raises(ValueError, match="chunks"):
        kex.run(buf, chunks=3)
    with pytest.raises(ValueError, match="chunks"):
        SimTransport(8).run_chunked(sched, buf.numpy(), chunks=3)


def test_launch_counter_counts_kernel_launches_only():
    """On a CPU tensor the wrapper runs the plain version and no kernel
    launch is counted.  One lowered executor per cache key; a 14-round
    schedule is one object with R > 1."""
    pt = flat_topology(8)
    sched = REGISTRY["allreduce"]["ring_rs_ag"](pt)
    kex = get_kernel_exec(sched, topo=pt)
    assert isinstance(kex, KernelExec) and kex.rounds > 1
    assert get_kernel_exec(sched, topo=pt) is kex
    before = dict(cuda.LAUNCHES)
    buf = torch.randn(8, sched.num_slots, 4)
    for _ in range(3):
        got = KernelTransport(8, topo=pt).run_global(sched, buf)
        assert torch.equal(got, schedule_exec_plain(kex.ex, buf))
    assert kex.launches == 0
    assert cuda.LAUNCHES == before
    # executor cache cleared -> a fresh lowering
    executor.clear_cache()
    assert get_kernel_exec(sched, topo=pt) is not kex


def test_kernel_wrapper_rejects_what_it_cannot_run():
    pt = flat_topology(8)
    sched = REGISTRY["allgather"]["ring"](pt)
    kex = get_kernel_exec(sched, topo=pt)
    with pytest.raises(ValueError, match="num_slots"):
        kex.run(torch.zeros(4, sched.num_slots, 2))
    with pytest.raises(ValueError, match="chunks"):
        kex.run(torch.zeros(8, sched.num_slots, 2), chunks=0)
    with pytest.raises(ValueError, match="device"):
        kex.run(torch.zeros(8, sched.num_slots, 2, device="meta"))
    # a schedule no CTA's shared memory can hold takes the global body;
    # forcing the shared body on it names the schedule
    assert pick_tile(4096, 64, 4, 1 << 20, "huge") == ("global", 32, 0)
    with pytest.raises(ValueError, match="huge"):
        pick_tile(4096, 64, 4, 1 << 20, "huge", body="shared")
    # (body, columns, buffers): the widest tile of rows >= 256 B whose two
    # buffers fit a third of an SM, with as many buffers as fit there
    assert pick_tile(64, 8, 4, 132, "x") == ("shared", 128, 2)  # ragged
    assert pick_tile(64, 8, 4, 1 << 20, "x") == ("shared", 128, 2)
    assert pick_tile(64, 0, 2, 1 << 20, "x") == ("shared", 256, 2)  # bf16
    assert pick_tile(64, 0, 2, 20, "x") == ("shared", 64, 4)  # 128 B rows
    # else rows of 256 B in one CTA per SM; else rows of 128 B
    assert pick_tile(256, 0, 4, 1 << 20, "x") == ("shared", 64, 3)
    assert pick_tile(512, 0, 2, 1 << 20, "x") == ("shared", 64, 3)
    assert pick_tile(64, 0, 2, 20, "x", body="global") == ("global", 64, 0)


def test_duplicate_reduce_targets_accumulate_in_edge_order(monkeypatch):
    """With validation off a reduce round may land two positions on one
    row; every backend accumulates them one at a time in (edge,
    position) order, as np.add.at does."""
    monkeypatch.setenv("REPRO_VALIDATE_SCHEDULES", "0")
    gi = np.array([[0, 1], [0, 1]], np.int32)
    si = np.array([[1, 1], [0, 0]], np.int32)
    rnd = CommRound(perm=((0, 1), (1, 0)), gather_idx=gi, scatter_idx=si,
                    reduce=True)
    sched = CommSchedule(nranks=2, num_slots=2, rounds=(rnd,), name="dup")
    ex = executor.get_executor(sched, optimize=False)
    assert ex._rounds[0].dup_targets
    buf = np.array([[[1e8], [1.0]], [[-1e8], [3.0]]], np.float32)
    buf = buf.astype(ml_dtypes.bfloat16)
    want = _bits(JSimTransport(2).run_reference(
        _jax_twin(sched), buf))
    np.testing.assert_array_equal(_bits(ex.run_sim(buf)), want)
    np.testing.assert_array_equal(
        _bits(schedule_exec_plain(ex, _to_torch(buf))), want)


def test_masked_gather_adds_zero_into_live_target():
    """A reduce round whose gather is masked (-1) but whose landing slot
    is live still adds the zero: -0.0 + 0.0 = +0.0 in the reference, so
    skipping the add would leave -0.0 and break bitwise parity."""
    gi = np.array([[-1, 0], [-1, -1]], np.int32)
    si = np.array([[-1, -1], [0, 1]], np.int32)
    rnd = CommRound(perm=((0, 1),), gather_idx=gi, scatter_idx=si,
                    reduce=True)
    sched = CommSchedule(nranks=2, num_slots=2, rounds=(rnd,), name="z")
    buf = np.array([[[1.5], [2.0]], [[-0.0], [-0.0]]], np.float32)
    want = JSimTransport(2).run_reference(_jax_twin(sched), buf)
    assert not np.signbit(want[1, 0, 0])
    for optimize in (False, True):
        ex = executor.get_executor(sched, optimize=optimize)
        np.testing.assert_array_equal(_bits(ex.run_sim(buf)), _bits(want))
        np.testing.assert_array_equal(
            _bits(schedule_exec_plain(ex, torch.from_numpy(buf))),
            _bits(want))


def _jax_twin(sched):
    from repro.core.schedule import CommRound as JRound
    from repro.core.schedule import CommSchedule as JSchedule
    return JSchedule(
        nranks=sched.nranks, num_slots=sched.num_slots, name=sched.name,
        rounds=tuple(JRound(perm=r.perm, gather_idx=r.gather_idx,
                            scatter_idx=r.scatter_idx, reduce=r.reduce)
                     for r in sched.rounds))
