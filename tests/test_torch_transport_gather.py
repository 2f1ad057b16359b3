"""The transport kernel's gather body, on the host: the composed row map
and the table the kernel walks (``kernel_lowering._compose`` and
``_gather_table``), its plain version, and the body choice.

A schedule with no reduce round (copy-only) composes into one map, the
input row each output row holds (-1 where a masked gather lands +0).
Here it must equal the port's ``SimTransport`` run on row ids + 1 (0
read as -1) for every copy-only REGISTRY schedule on the card smoke's
four topologies, neighbor plans in both modes, random KV-transfer plans
at 256 blocks a rank, and two hand-made plans: a masked landing, and a
repeated target with schedule validation off (the last landing wins).
The gather body's plain version must equal, bit for bit,
``schedule_exec_plain``, the port's ``SimTransport.run`` and the JAX
package's ``SimTransport.run_reference`` on random floats with negative
zeros, in float32 and bfloat16 (compared by raw bits).  The kernel
itself is held against the plain version on a card in
tests/test_torch_cuda.py.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import kvtransfer as jkv
from repro.core import plan as jplan
from repro.core.schedule import CommRound as JCommRound
from repro.core.schedule import CommSchedule as JCommSchedule
from repro.core.topology import Topology as JTopology
from repro.core.transport import SimTransport as JSimTransport

from repro_torch.core import executor, kernel_lowering, kvtransfer
from repro_torch.core import plan as tplan
from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.kernel_lowering import (GATHER_BUFS, GATHER_SEG_BYTES,
                                              floor_rows, gather_tables,
                                              get_kernel_exec, pick_tile,
                                              schedule_exec_gather_plain,
                                              schedule_exec_plain)
from repro_torch.core.schedule import CommRound, CommSchedule
from repro_torch.core.topology import Topology
from repro_torch.core.transport import SimTransport
from test_torch_transport import (TOPOS, _bits, _float_buf, _schedules,
                                  _to_torch)

NEIGHBOR_TOPOS = [(8, 8), (8, 4), (16, 4), (12, 3)]


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    # the hand-made repeated-target plan needs validation off
    monkeypatch.setenv("REPRO_VALIDATE_SCHEDULES", "0")
    executor.clear_cache()
    kernel_lowering.clear_cache()
    yield
    executor.clear_cache()
    kernel_lowering.clear_cache()


def _kv_moves(seed, blocks, count, mk):
    rng = np.random.default_rng(seed)
    moves, used = [], set()
    while len(moves) < count:
        s, d = int(rng.integers(4)), 4 + int(rng.integers(4))
        row, dr = int(rng.integers(blocks)), int(rng.integers(blocks))
        if (d, dr) not in used:
            used.add((d, dr))
            moves.append(mk(s, row, d, dr))
    return moves


def _hand(kind, CR, CS):
    """A masked landing (rank 1's slot 0 takes +0), or a repeated target
    (rank 1's slot 1 takes rank 0's slots 0 then 1)."""
    if kind == "masked":
        rnd = CR(perm=((0, 1),),
                 gather_idx=np.array([[-1, 0], [-1, -1]], np.int32),
                 scatter_idx=np.array([[-1, -1], [0, 1]], np.int32),
                 reduce=False)
    else:
        rnd = CR(perm=((0, 1), (1, 0)),
                 gather_idx=np.array([[0, 1], [0, 1]], np.int32),
                 scatter_idx=np.array([[1, 1], [0, 0]], np.int32),
                 reduce=False)
    return CS(nranks=2, num_slots=2, rounds=(rnd,), name=kind)


def _case(cid):
    """(port schedule, port topology or None, the JAX package's schedule,
    nranks, optimize) for a case id."""
    kind, *rest = cid.split(":")
    if kind == "registry":
        topo_name, name = rest
        jt, pt = TOPOS[topo_name]
        js, ps = next((js, ps) for n, js, ps in _schedules(topo_name)
                      if n == name)
        return ps, pt, js, pt.nranks, None
    if kind == "neighbor":
        n, rpp, agg = int(rest[0]), int(rest[1]), rest[2] == "agg"
        graphs = [mod.CommGraph.random(
            n, n_local=24, degree=min(n - 1, 6),
            rng=np.random.default_rng(100 * n + rpp), dup_frac=0.7)
            for mod in (jplan, tplan)]
        jp = jplan.build_plan(graphs[0], JTopology(n, rpp), aggregate=agg)
        topo = Topology(n, rpp)
        tp = tplan.build_plan(graphs[1], topo, aggregate=agg)
        return tp.schedule, topo, jp.schedule, n, None
    if kind == "kv":
        seed, agg = int(rest[0]), rest[1] == "agg"
        topo = Topology(8, 4)
        tp = kvtransfer.build_transfer_plan(
            _kv_moves(seed, 256, 300 + 300 * seed, kvtransfer.BlockMove),
            topo, blocks_per_rank=256, aggregate=agg, block_bytes=4096)
        jtp = jkv.build_transfer_plan(
            _kv_moves(seed, 256, 300 + 300 * seed, jkv.BlockMove),
            JTopology(8, 4), blocks_per_rank=256, aggregate=agg,
            block_bytes=4096)
        return tp.schedule, topo, jtp.schedule, 8, None
    return (_hand(kind, CommRound, CommSchedule), None,
            _hand(kind, JCommRound, JCommSchedule), 2, False)


CASES = ([f"registry:{t}:{name}" for t in TOPOS
          for name, _, ps in _schedules(t)
          if not any(r.reduce for r in ps.rounds)]
         + [f"neighbor:{n}:{rpp}:{mode}" for n, rpp in NEIGHBOR_TOPOS
            for mode in ("std", "agg")]
         + [f"kv:{seed}:{mode}" for seed in (0, 1) for mode in ("std", "agg")]
         + ["masked", "dup"])


def _kex(cid):
    sched, topo, jsched, n, optimize = _case(cid)
    kex = get_kernel_exec(sched, topo=topo, optimize=optimize)
    assert kex.tables["copy_only"], cid
    return kex, sched, topo, jsched, n


def test_every_kind_of_case_is_covered():
    kinds = [c.split(":")[0] for c in CASES]
    assert kinds.count("registry") >= 50
    assert kinds.count("neighbor") == 8 and kinds.count("kv") == 4


@pytest.mark.parametrize("cid", CASES)
def test_composed_map_equals_sim_on_row_ids(cid):
    kex, sched, topo, _, n = _kex(cid)
    ids = np.arange(1, n * sched.num_slots + 1, dtype=np.int64).reshape(
        n, sched.num_slots, 1)
    want = SimTransport(n, topo=topo).run(sched, ids).reshape(-1) - 1
    t = gather_tables(kex.ex)
    assert np.array_equal(t["src_of"], want), cid
    if cid == "masked":
        assert t["zero_rows"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cid", CASES)
def test_gather_plain_bitwise(cid, dtype):
    """The gather body's plain version = ``schedule_exec_plain`` = the
    port's ``SimTransport.run`` = the JAX package's ``run_reference``."""
    import ml_dtypes
    kex, sched, topo, jsched, n = _kex(cid)
    rng = np.random.default_rng(zlib.crc32(cid.encode()))
    buf = _float_buf(rng, (n, sched.num_slots, 2, 3))
    if dtype == "bfloat16":
        buf = buf.astype(ml_dtypes.bfloat16)
    want = _bits(JSimTransport(n).run_reference(jsched, buf))
    g = _to_torch(buf)
    got = schedule_exec_gather_plain(kex.ex, g)
    assert np.array_equal(_bits(got), want), cid
    assert np.array_equal(_bits(schedule_exec_plain(kex.ex, g)), want), cid
    # the schedule only copies, so the simulator moves the raw bits
    assert np.array_equal(SimTransport(n, topo=topo).run(sched, _bits(buf)),
                          want), cid


@pytest.mark.parametrize("cid", CASES)
def test_gather_table_lists_every_output_row_once(cid):
    """The CSR: distinct sources ascending, every output row exactly once
    (under its source, or among the +0 rows), and the design floor's
    read rows are the distinct sources."""
    kex, sched, _, _, n = _kex(cid)
    t = gather_tables(kex.ex)
    ns, nsrc, nzero = n * sched.num_slots, t["gather_rows"], t["zero_rows"]
    gtab = t["gather_tab"]
    assert gtab.dtype == np.int32 and len(gtab) == 2 * nsrc + 1 + ns
    srcs, offs = gtab[:nsrc], gtab[nsrc:2 * nsrc + 1]
    dsts = gtab[2 * nsrc + 1:2 * nsrc + 1 + ns - nzero]
    zeros = gtab[2 * nsrc + 1 + ns - nzero:]
    assert (np.diff(srcs) > 0).all() and offs[0] == 0
    assert (np.diff(offs) > 0).all() and offs[-1] == ns - nzero
    assert np.array_equal(np.sort(np.concatenate([dsts, zeros])),
                          np.arange(ns))
    src_of = t["src_of"]
    assert np.array_equal(src_of[dsts], np.repeat(srcs, np.diff(offs)))
    assert (src_of[zeros] == -1).all() and len(zeros) == nzero
    assert nsrc == len(np.unique(src_of[src_of >= 0])) <= t["nlive"]
    assert floor_rows(kex.ex, "gather") == nsrc + ns


def test_pick_tile_sends_tall_copy_only_plans_to_the_gather_body():
    """The KV batches of the card smoke's trace (14,008 and 3,504 rows of
    [16, 2048] f32): the gather body when copy-only, the global body
    with a reduce round; a plan the shared body holds keeps its tiling
    either way."""
    for ns in (14008, 3504):
        assert pick_tile(ns, 0, 4, 16 * 2048, "kv", 40000,
                         copy_only=True) == ("gather", GATHER_SEG_BYTES,
                                             GATHER_BUFS)
        assert pick_tile(ns, 0, 4, 16 * 2048, "kv", 40000) == \
            ("global", 32, 0)
        assert pick_tile(ns, 0, 4, 16 * 2048, "kv", 40000, copy_only=True,
                         body="global") == ("global", 32, 0)
    for args in ((64, 0, 4, 1 << 20, "x"), (512, 0, 2, 1 << 20, "x")):
        assert pick_tile(*args, copy_only=True) == pick_tile(*args)
        assert pick_tile(*args, copy_only=True, body="gather")[0] == "gather"
    with pytest.raises(ValueError, match="'ar' has a reduce round"):
        pick_tile(14008, 0, 4, 16 * 2048, "ar", body="gather")


def test_forcing_the_gather_body_on_a_reduce_plan_raises():
    topo = TOPOS["flat8"][1]
    sched = REGISTRY["allreduce"]["ring_rs_ag"](topo)
    kex = get_kernel_exec(sched, topo=topo)
    assert not kex.tables["copy_only"] and "gather_tab" not in kex.tables
    with pytest.raises(ValueError, match=f"'{sched.name}' has a reduce"):
        gather_tables(kex.ex)
    g = torch.zeros((8, sched.num_slots, 4))
    with pytest.raises(ValueError, match=f"'{sched.name}' has a reduce"):
        kex.run(g, _body="gather")
    with pytest.raises(ValueError, match=f"'{sched.name}' has a reduce"):
        schedule_exec_gather_plain(kex.ex, g)


def test_cpu_run_takes_the_plain_version_of_the_chosen_body(monkeypatch):
    """A tall copy-only plan on a CPU tensor runs the gather body's plain
    version (``schedule_exec_plain`` is never called), bitwise equal to
    it; a forced body takes its own plain version."""
    topo = Topology(8, 4)
    tp = kvtransfer.build_transfer_plan(
        _kv_moves(3, 256, 600, kvtransfer.BlockMove), topo,
        blocks_per_rank=256, aggregate=True, block_bytes=128)
    kex = get_kernel_exec(tp.schedule, topo=topo)
    g = _to_torch(_float_buf(np.random.default_rng(3),
                             (8, tp.schedule.num_slots, 2, 16)))
    want = schedule_exec_plain(kex.ex, g)
    assert kex.plan(4, 32)[0] == "gather"

    def refuse(*args):
        raise AssertionError("schedule_exec_plain on the gather body")

    monkeypatch.setattr(kernel_lowering, "schedule_exec_plain", refuse)
    assert torch.equal(kex.run(g).view(torch.int32), want.view(torch.int32))
    assert torch.equal(kex.run(g, chunks=2).view(torch.int32),
                       want.view(torch.int32))
    with pytest.raises(AssertionError, match="gather body"):
        kex.run(g, _body="global")


def test_gather_tables_are_built_only_for_the_gather_body():
    """The composed map and the gather table are built the first time
    the gather body runs, never for a copy-only plan that the shared
    body holds (the main-path alltoall) or when another body is forced."""
    topo = TOPOS["flat8"][1]
    sched = REGISTRY["alltoall"]["pairwise"](topo)
    kex = get_kernel_exec(sched, topo=topo)
    assert kex.tables["copy_only"]
    g = _to_torch(_float_buf(np.random.default_rng(4),
                             (8, sched.num_slots, 2, 16)))
    want = schedule_exec_plain(kex.ex, g)
    assert kex.plan(4, 32)[0] == "shared"
    kex.run(g)
    kex.run(g, _body="global")
    assert "gather_tab" not in kex.tables
    got = kex.run(g, _body="gather")
    assert "gather_tab" in kex.tables
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
