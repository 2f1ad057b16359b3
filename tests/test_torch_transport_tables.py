"""The transport kernel's host tables (``kernel_lowering._pack_tables``).

The kernel lands straight from its buffer in *direct* rounds (no landing
row is also a gather row), lands every pair at once unless the round is
*ordered* (a landing row repeats), never loads a row whose first access
is a ``set`` landing (the ``load`` mask), and copies rows in and out as
TMA boxes of 2^k consecutive rows.  Here: the flags on the main-path
schedules and on the sweep's odd rounds, the boxes against the row maps,
and the dead rows: every row the ``load`` mask clears is poisoned with
NaN, and the port's plain version must still equal, bitwise, the JAX
package's Pallas transport (interpret mode) on the clean buffer.  The
plain version starts unloaded rows as NaN too, so a read of one would
show.  The sweep is split over this file and
``test_torch_transport_dead_rows*.py`` so that the test workers share
the interpret-mode compiles.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import executor as jexecutor
from repro.core import pallas_lowering as jpallas
from repro.core.algorithms import REGISTRY as JREGISTRY
from repro.core.schedule import NotApplicable as JNotApplicable
from repro.core.transport import PallasTransport as JPallasTransport
from repro.core.transport import SimTransport as JSimTransport

from repro_torch.core import executor, kernel_lowering
from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.kernel_lowering import (MAX_BOX_ROWS,
                                              schedule_exec_plain, tables)
from repro_torch.core.schedule import CommRound, CommSchedule, NotApplicable
from repro_torch.core.transport import KernelTransport
from test_torch_transport import (TOPOS, _bits, _float_buf, _jax_twin,
                                  _to_torch)


@pytest.fixture(autouse=True)
def _fresh_caches():
    executor.clear_cache()
    kernel_lowering.clear_cache()
    yield
    executor.clear_cache()
    kernel_lowering.clear_cache()


def dead_row_cases(topo_names, dtypes=("float32", "bfloat16")):
    """(topology, collective, algorithm, dtype) for every REGISTRY
    schedule the topologies admit."""
    cases = []
    for topo_name in topo_names:
        jt, _ = TOPOS[topo_name]
        for coll, algos in JREGISTRY.items():
            for name, builder in algos.items():
                try:
                    builder(jt)
                except JNotApplicable:
                    continue
                cases += [pytest.param(topo_name, coll, name, dtype,
                                       id=f"{topo_name}-{coll}.{name}-{dtype}")
                          for dtype in dtypes]
    return cases


def check_dead_rows_never_read(topo_name, coll, algo, dtype):
    jt, pt = TOPOS[topo_name]
    js, ps = JREGISTRY[coll][algo](jt), REGISTRY[coll][algo](pt)
    n, s = pt.nranks, ps.num_slots
    buf = _float_buf(np.random.default_rng(7), (n, s, 2, 3))
    if dtype == "bfloat16":
        buf = buf.astype(ml_dtypes.bfloat16)
    try:
        want = np.asarray(JPallasTransport(n, topo=jt).run_global(js, buf))
    finally:
        jpallas.clear_cache()
        jexecutor.clear_cache()
    tabs = tables(executor.get_executor(ps, topo=pt))
    # input rows that feed no loaded work row
    dead = np.setdiff1d(np.arange(n * s), tabs["src_row"][tabs["load"]])
    assert len(dead) == n * s - tabs["nlive"]
    poisoned = buf.copy()
    poisoned.reshape(n * s, -1)[dead] = np.nan
    got = KernelTransport(n, topo=pt).run_global(ps, _to_torch(poisoned))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("topo_name,coll,algo,dtype",
                         dead_row_cases(["flat8", "2pod"]))
def test_dead_rows_never_read(topo_name, coll, algo, dtype):
    check_dead_rows_never_read(topo_name, coll, algo, dtype)


@pytest.mark.parametrize("topo_name,coll,algo,dead", [
    ("flat8", "allreduce", "ring_rs_ag", 0),
    ("3lvl16", "allreduce", "staged", 0),
    ("flat8", "alltoall", "pairwise", 56),
])
def test_main_path_rounds_are_direct_and_unordered(topo_name, coll, algo,
                                                   dead):
    """The three main-path schedules: every round lands straight from the
    buffer, all at once, with no stage; the pairwise alltoall's receive
    region is first touched by set landings in 56 of its 128 rows."""
    _, pt = TOPOS[topo_name]
    tabs = tables(executor.get_executor(REGISTRY[coll][algo](pt), topo=pt))
    assert tabs["direct"].all() and not tabs["ordered"].any()
    assert tabs["stage_rows"] == 0
    assert len(tabs["load"]) - tabs["nlive"] == dead


def test_hazard_rounds_are_flagged():
    """A round that both gathers from and lands on some row is not
    direct, and sizes the stage; across the four topologies that is 48
    of the 601 compiled rounds, and no round repeats a landing row."""
    rounds = hazards = 0
    for _, pt in TOPOS.values():
        for coll, algos in REGISTRY.items():
            for name, builder in algos.items():
                try:
                    sched = builder(pt)
                except NotApplicable:
                    continue
                ex = executor.get_executor(sched, topo=pt)
                tabs = tables(ex)
                s = ex.num_slots
                staged = 0
                for q, rnd in enumerate(ex._rounds):
                    gathers = {int(rnd.src[e]) * s + int(rnd.g_safe[e, j])
                               for e, j in zip(*np.nonzero(rnd.g_mask))}
                    lands = [int(rnd.dst[e]) * s + int(rnd.t_safe[e, j])
                             for e, j in zip(*np.nonzero(rnd.t_mask))]
                    hazard = bool(gathers & set(lands))
                    assert tabs["direct"][q] == (not hazard), (name, q)
                    assert tabs["ordered"][q] == (len(set(lands))
                                                  != len(lands))
                    if hazard:
                        staged = max(staged, len(lands))
                    hazards += hazard
                    rounds += 1
                assert tabs["stage_rows"] == staged, name
                assert not tabs["ordered"].any(), name
    assert (hazards, rounds) == (48, 601)


@pytest.mark.parametrize("reduce", [True, False])
def test_repeated_targets_are_ordered(monkeypatch, reduce):
    """With validation off a round may land two positions on one row: the
    round is ordered (and here a hazard too), reduce adds accumulate in
    (edge, position) order and, for a set, the last landing wins."""
    monkeypatch.setenv("REPRO_VALIDATE_SCHEDULES", "0")
    gi = np.array([[0, 1], [0, 1]], np.int32)
    si = np.array([[1, 1], [0, 0]], np.int32)
    rnd = CommRound(perm=((0, 1), (1, 0)), gather_idx=gi, scatter_idx=si,
                    reduce=reduce)
    sched = CommSchedule(nranks=2, num_slots=2, rounds=(rnd,), name="dup")
    ex = executor.get_executor(sched, optimize=False)
    tabs = tables(ex)
    assert tabs["ordered"].tolist() == [True]
    assert tabs["direct"].tolist() == [False] and tabs["stage_rows"] == 4
    buf = np.array([[[1e8], [1.0]], [[-1e8], [3.0]]], np.float32)
    buf = buf.astype(ml_dtypes.bfloat16)
    want = _bits(JSimTransport(2).run_reference(_jax_twin(sched), buf))
    np.testing.assert_array_equal(
        _bits(schedule_exec_plain(ex, _to_torch(buf))), want)


@pytest.mark.parametrize("topo_name", list(TOPOS))
def test_boxes_copy_each_row_once(topo_name):
    """The stage-in boxes load every live row once from its source row
    and nothing else; the drain boxes write every output row once from
    its post row; each box is 2^k rows, k within the encoded classes."""
    _, pt = TOPOS[topo_name]
    for coll, algos in REGISTRY.items():
        for name, builder in algos.items():
            try:
                sched = builder(pt)
            except NotApplicable:
                continue
            tabs = tables(executor.get_executor(sched, topo=pt))
            ns = len(tabs["load"])
            for boxes, classes, want in (
                    (tabs["loads"], tabs["load_classes"],
                     {(i, int(tabs["src_row"][i])) for i in range(ns)
                      if tabs["load"][i]}),
                    (tabs["stores"], tabs["store_classes"],
                     {(i, int(tabs["post_row"][i])) for i in range(ns)})):
                got = [(t + r, f + r) for t, f, k in boxes
                       for r in range(1 << k)]
                assert len(got) == len(set(got)) == len(want), name
                assert set(got) == want, name
                assert all(1 << k <= MAX_BOX_ROWS and classes >> k & 1
                           for _, _, k in boxes), name
