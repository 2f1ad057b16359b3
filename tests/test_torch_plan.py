"""The port's neighborhood-collective plans, held against the reference.

The same seeded ``CommGraph`` goes through ``repro.core.plan`` and
``repro_torch.core.plan``: the plans must agree on everything the IR
exposes (schedule fingerprint, round counts before and after the
topology-armed executor, recv layout, traffic, modeled time), the numpy
executor (``run_sim``) must agree bit for bit, and the port's kernel
transport — its plain version here on the CPU — must equal the
reference's rank-by-rank oracle, and on three small plans the
reference's Pallas kernel in interpret mode.  Buffers are random floats
with negative zeros in float32 and bfloat16 (compared by raw bits), and
every row outside the value rows holds random data too, so a row the
kernel wrongly treats as dead shows.  Also the body choice of the
transport kernel for plans too tall for shared memory.
"""
import os
import sys

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan as jplan
from repro.core import selector as jselector
from repro.core.topology import Topology as JTopology
from repro.core.transport import PallasTransport as JPallasTransport
from repro.core.transport import SimTransport as JSimTransport

from repro_torch.core import executor, kernel_lowering
from repro_torch.core import plan as tplan
from repro_torch.core import selector as tselector
from repro_torch.core.kernel_lowering import get_kernel_exec, pick_tile
from repro_torch.core.topology import Topology

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)

# the reference test's sweep (tests/test_neighbor_plan.py): every n in
# 2-16 with every ranks_per_pod that divides it
SHAPES = [(n, rpp) for n in range(2, 17) for rpp in range(1, n + 1)
          if n % rpp == 0]
# four topologies (one pod, two and four pods of 4, four pods of 3), at a
# larger graph
TOPOS = [(8, 8), (8, 4), (16, 4), (12, 3)]


@pytest.fixture(autouse=True)
def _fresh_caches():
    executor.clear_cache()
    kernel_lowering.clear_cache()
    yield
    executor.clear_cache()
    kernel_lowering.clear_cache()


def _graphs(n, seed, n_local=8, degree=None, dup_frac=0.5):
    """The same random graph from both packages (one seed each)."""
    deg = degree or min(n - 1, 4)
    jg = jplan.CommGraph.random(n, n_local=n_local, degree=deg,
                                rng=np.random.default_rng(seed),
                                dup_frac=dup_frac)
    tg = tplan.CommGraph.random(n, n_local=n_local, degree=deg,
                                rng=np.random.default_rng(seed),
                                dup_frac=dup_frac)
    return jg, tg


def _same_graph(jg, tg):
    assert jg.nranks == tg.nranks and jg.local_sizes == tg.local_sizes
    assert sorted(jg.edges) == sorted(tg.edges)
    for k in jg.edges:
        assert jg.edges[k].dtype == tg.edges[k].dtype
        assert np.array_equal(jg.edges[k], tg.edges[k])


def _same_plan(jp, tp, label):
    assert jp.name == tp.name, label
    assert jp.schedule.fingerprint() == tp.schedule.fingerprint(), label
    assert jp.num_rounds == tp.num_rounds, label
    assert jp.num_compiled_rounds == tp.num_compiled_rounds, label
    assert jp.recv_offsets == tp.recv_offsets, label
    assert jp.recv_sizes == tp.recv_sizes, label
    assert jp.buf_rows == tp.buf_rows, label
    for eb in (1, 4, 4096):
        assert jp.traffic(eb) == tp.traffic(eb), label
        assert jp.modeled_time(eb) == tp.modeled_time(eb), label
        assert jp.makespan(eb) == tp.makespan(eb), label


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.ascontiguousarray(x)
    return x.view(np.uint16 if x.dtype == ml_dtypes.bfloat16 else np.uint32)


def _float_rows(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::5] = -0.0
    return x.astype(dtype)


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(x)


@pytest.mark.parametrize("mode", [False, True, None])
@pytest.mark.parametrize("n,rpp", SHAPES)
def test_plan_matches_reference_on_the_sweep(n, rpp, mode):
    """Both build modes and the model's pick (``aggregate=None``) on
    every shape of the reference's sweep: the same plan, and run_sim bit
    for bit in f32 and bf16."""
    seed = 1000 * n + rpp
    jg, tg = _graphs(n, seed)
    _same_graph(jg, tg)
    jt, tt = JTopology(n, rpp), Topology(n, rpp)
    jp = jplan.build_plan(jg, jt, aggregate=mode, policy="model")
    tp = tplan.build_plan(tg, tt, aggregate=mode, policy="model")
    label = (n, rpp, mode)
    _same_plan(jp, tp, label)
    if mode is None:
        mp = tplan.model_argmin_plan(tg, tt)
        assert mp.schedule.fingerprint() == tp.schedule.fingerprint()
    rng = np.random.default_rng(seed)
    for dtype in (np.float32, ml_dtypes.bfloat16):
        vals = [_float_rows(rng, (8, 3), dtype) for _ in range(n)]
        want = jplan.run_sim(jp, vals)
        got = tplan.run_sim(tp, vals)
        for r in range(n):
            assert _bits(want[r]).tobytes() == _bits(got[r]).tobytes(), \
                (label, r, dtype)


@pytest.mark.parametrize("aggregate", [False, True])
@pytest.mark.parametrize("n,rpp", TOPOS)
def test_kernel_transport_matches_run_reference(n, rpp, aggregate):
    """The four topologies at a larger, duplicate-heavy graph: the same
    plan, and ``KernelTransport.run_global`` (the kernel's plain version
    on a CPU tensor) bitwise equal to the reference's ``run_reference``
    on a buffer whose every row holds random floats."""
    from repro.core.transport import SimTransport as JSim
    from repro_torch.core.transport import KernelTransport

    jg, tg = _graphs(n, 7 * n + rpp, n_local=16, degree=min(n - 1, 6),
                     dup_frac=0.7)
    jt, tt = JTopology(n, rpp), Topology(n, rpp)
    jp = jplan.build_plan(jg, jt, aggregate=aggregate)
    tp = tplan.build_plan(tg, tt, aggregate=aggregate)
    _same_plan(jp, tp, (n, rpp, aggregate))
    rng = np.random.default_rng(n * rpp)
    for dtype in (np.float32, ml_dtypes.bfloat16):
        gbuf = _float_rows(rng, (n, tp.buf_rows, 2, 3), dtype)
        want = JSim(n).run_reference(jp.schedule, gbuf)
        got = KernelTransport(n, topo=tt).run_global(tp.schedule,
                                                     _torch(gbuf))
        assert _bits(want).tobytes() == _bits(got).tobytes(), dtype
        # the padding rows past each rank's recv size keep the input
        for r in range(n):
            end = tp.recv_offsets[r] + tp.recv_sizes[r]
            assert _bits(got[r, end:]).tobytes() == \
                _bits(gbuf[r, end:]).tobytes()


@pytest.mark.parametrize("n,rpp,aggregate", [(4, 2, True), (6, 3, True),
                                             (5, 5, False)])
def test_kernel_transport_matches_reference_pallas_kernel(n, rpp, aggregate):
    """Three small plans: the port's kernel transport (plain version)
    bitwise equal to the reference's Pallas kernel in interpret mode, as
    the reference's own transport tests run it."""
    from repro_torch.core.transport import KernelTransport

    jg, tg = _graphs(n, 31 * n + rpp, n_local=6)
    jt, tt = JTopology(n, rpp), Topology(n, rpp)
    jp = jplan.build_plan(jg, jt, aggregate=aggregate)
    tp = tplan.build_plan(tg, tt, aggregate=aggregate)
    _same_plan(jp, tp, (n, rpp, aggregate))
    rng = np.random.default_rng(n)
    gbuf = _float_rows(rng, (n, tp.buf_rows, 2), np.float32)
    want = np.asarray(JPallasTransport(n, topo=jt).run_global(jp.schedule,
                                                              gbuf))
    got = KernelTransport(n, topo=tt).run_global(tp.schedule, _torch(gbuf))
    assert _bits(want).tobytes() == _bits(got).tobytes()
    assert want.tobytes() == JSimTransport(n).run_reference(
        jp.schedule, gbuf).tobytes()


@pytest.mark.parametrize("policy", ["fixed", "model"])
@pytest.mark.parametrize("n,rpp", TOPOS + [(6, 2), (9, 3), (4, 4)])
def test_select_neighbor_matches_reference(n, rpp, policy):
    for seed, dup in ((0, 0.0), (1, 0.5), (2, 0.95)):
        jg, tg = _graphs(n, seed + 17 * n, n_local=12, dup_frac=dup)
        jt, tt = JTopology(n, rpp), Topology(n, rpp)
        for eb in (4, 1024, 131072):
            want = jselector.select_neighbor(jg, jt, policy=policy,
                                             elem_bytes=eb)
            got = tselector.select_neighbor(tg, tt, policy=policy,
                                            elem_bytes=eb)
            assert want == got, (seed, eb)


def test_select_neighbor_tuned_raises_until_the_tuner(tmp_path,
                                                       monkeypatch):
    """The tuner is ported: the tuned mode no longer raises.  With no
    persisted table it is the model's choice, as the reference's; one
    pod needs no table (both modes compile identically)."""
    from repro.core import tuner as jtuner
    from repro_torch.core import tuner as ttuner

    monkeypatch.setenv("REPRO_TUNER_CACHE", str(tmp_path / "j.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE", str(tmp_path / "t.json"))
    ttuner.clear_cache()
    jtuner.clear_cache()
    jg, tg = _graphs(8, 0)
    got = tselector.select_neighbor(tg, Topology(8, 4), policy="tuned")
    assert got == tselector.select_neighbor(tg, Topology(8, 4),
                                            policy="model")
    assert got == jselector.select_neighbor(jg, JTopology(8, 4),
                                            policy="tuned")
    assert tselector.select_neighbor(tg, Topology(8, 8),
                                     policy="tuned") == "standard"
    ttuner.clear_cache()
    jtuner.clear_cache()


def test_plan_build_is_deterministic():
    """The same graph in, the same rounds out: two builds (and a graph
    whose edge dict is filled in another order) give one fingerprint."""
    _, tg = _graphs(12, 5, n_local=10, degree=7, dup_frac=0.8)
    shuffled = tplan.CommGraph(
        nranks=tg.nranks, local_sizes=tg.local_sizes,
        edges=dict(reversed(list(tg.edges.items()))))
    topo = Topology(12, 4)
    for agg in (False, True):
        fps = {tplan.build_plan(g, topo, aggregate=agg)
               .schedule.fingerprint() for g in (tg, tg, shuffled)}
        assert len(fps) == 1, agg


# the transport kernel's body choice -------------------------------------

# (tile, buffers) the shared body took for chip_smoke.py's TRANSPORT_CASES
# before the global body existed
SHARED_PLANS = {"allreduce 25 MiB/rank f32, flat 8 (DDP bucket)": (128, 2),
                "allreduce 25 MiB/rank f32, torus(2,4,2) 16 ranks": (64, 3),
                "alltoall MoE dispatch 8x[512,2048] bf16/rank, flat 8":
                (128, 2)}


def test_tall_plans_take_the_global_body():
    """The KV plan of the serving trace at 1024 blocks a rank (14,008
    rows of [16, 2048] f32) cannot fit shared memory: the gather body,
    since it has no reduce round; a plan that tall with a reduce round
    takes the global body.  Every main-path collective of the card smoke
    keeps the shared body with the same tiling as before."""
    assert pick_tile(14008, 0, 4, 16 * 2048, "kv", 40000,
                     copy_only=True) == ("gather", 32768, 4)
    assert pick_tile(3504, 0, 4, 16 * 2048, "kv", 10000,
                     copy_only=True)[0] == "gather"
    assert pick_tile(14008, 0, 4, 16 * 2048, "kv", 40000) == \
        ("global", 32, 0)
    assert pick_tile(3504, 0, 4, 16 * 2048, "kv", 10000)[0] == "global"
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.core.algorithms import REGISTRY

    assert sorted(SHARED_PLANS) == sorted(c[0] for c in cs.TRANSPORT_CASES)
    for label, tspec, coll, algo, slot, dtname in cs.TRANSPORT_CASES:
        topo = cs._topology(tspec)
        n = topo.nranks
        if coll == "allreduce":
            slot = (25 * cs.MIB // 4 // n,)
        elem = 4 if dtname == "float32" else 2
        sched = REGISTRY[coll][algo](topo)
        t = get_kernel_exec(sched, topo=topo).tables
        got = pick_tile(n * sched.num_slots, t["stage_rows"], elem,
                        int(np.prod(slot)), sched.name, len(t["tab"]),
                        copy_only=t["copy_only"])
        assert got == ("shared",) + SHARED_PLANS[label], label


def test_kv_plan_rows_exceed_shared_memory():
    """A real transfer plan of the engine at 256 blocks a rank already
    has more rows than the shared body can hold at 128-byte rows: it
    takes the gather body (no reduce round), or the global body where
    forced."""
    from repro_torch.core import kvtransfer

    topo = Topology(8, 4)
    rng = np.random.default_rng(0)
    moves, used = [], set()
    while len(moves) < 300:
        s, d = int(rng.integers(4)), 4 + int(rng.integers(4))
        row, dr = int(rng.integers(256)), int(rng.integers(256))
        if (d, dr) not in used:
            used.add((d, dr))
            moves.append(kvtransfer.BlockMove(s, row, d, dr))
    tp = kvtransfer.build_transfer_plan(moves, topo, blocks_per_rank=256,
                                        block_bytes=16 * 2048 * 4)
    ns = 8 * tp.schedule.num_slots
    assert ns > 1700
    t = get_kernel_exec(tp.schedule, topo=topo).tables
    assert t["copy_only"]
    assert pick_tile(ns, t["stage_rows"], 4, 16 * 2048, "kv",
                     len(t["tab"]), copy_only=t["copy_only"])[0] == "gather"
    assert pick_tile(ns, t["stage_rows"], 4, 16 * 2048, "kv",
                     len(t["tab"]), copy_only=t["copy_only"],
                     body="global")[0] == "global"
    # as tall with a reduce round: the global body
    assert pick_tile(ns, t["stage_rows"], 4, 16 * 2048, "kv",
                     len(t["tab"]))[0] == "global"
    with pytest.raises(ValueError, match="shared memory"):
        pick_tile(ns, t["stage_rows"], 4, 16 * 2048, "kv", len(t["tab"]),
                  body="shared")
