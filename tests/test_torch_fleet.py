"""Fleet-scale tuning in the port, end to end: probe -> drift heal ->
elastic swap, held against the reference package on the same inputs.

The cases of the reference's ``tests/test_fleet.py`` on the port (each
daemon report and elastic swap compared with the reference's where the
reference computes the same thing), and the ``fleet`` section of
``BENCH_transport.json`` reproduced exactly by the port's counterpart of
``benchmarks/bench_transport.py``'s ``bench_fleet``, run in a fresh
process with cold caches (the eviction counts depend on what the
process built before).
"""
import json
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from repro.core import api as japi
from repro.core import executor as jexecutor
from repro.core import tuner as jtuner
from repro.core import topology as jtopo
from repro.core.linkprobe import model_timer as jmodel_timer
from repro.runtime.elastic import ElasticScheduleSet as JElastic
from repro.runtime.fault import LinkFault as JLinkFault
from repro.runtime.tuning_daemon import TuningDaemon as JDaemon

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.core import api, executor, kernel_lowering, tuner
from repro_torch.core import topology as ttopo
from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.linkprobe import model_timer
from repro_torch.core.topology import (DCN_LINK, ICI_LINK, TopoLevel,
                                       Topology, flat_topology)
from repro_torch.runtime.elastic import (ElasticScheduleSet, RankLossSignal,
                                         rank_remap, shrink_topology)
from repro_torch.runtime.fault import FaultTolerantLoop, LinkFault
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.tuning_daemon import TuningDaemon

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


@pytest.fixture(autouse=True)
def _fresh_caches():
    for mod in (executor, kernel_lowering, tuner, jexecutor, jtuner):
        mod.clear_cache()
    api._SCHEDULES.clear()
    japi._SCHEDULES.clear()
    yield
    for mod in (executor, kernel_lowering, tuner, jexecutor, jtuner):
        mod.clear_cache()
    api._SCHEDULES.clear()
    japi._SCHEDULES.clear()


def _base(mod=ttopo):
    return mod.Topology.from_levels([
        mod.TopoLevel("dcn", 2, mod.DCN_LINK, dcn=True),
        mod.TopoLevel("ici", 4, mod.ICI_LINK)])


def _daemon(tmp_path, fault=None, **kw):
    base = _base()
    return TuningDaemon(
        base, path=tmp_path / "tuned.json", force_model=True,
        timer=model_timer(base, fault=fault), repeats=1, **kw)


def _jdaemon(tmp_path, fault=None, **kw):
    base = _base(jtopo)
    return JDaemon(base, path=tmp_path / "jtuned.json", force_model=True,
                   timer=jmodel_timer(base, fault=fault), repeats=1, **kw)


def _report(r):
    """A DriftReport's fields, the transport names mapped."""
    cells = lambda cs: tuple(tuple(c) for c in cs)        # noqa: E731
    return (r.step, r.drifted_levels, cells(r.affected_cells),
            cells(r.retuned_cells), r.total_cells, r.invalidated,
            r.generation, r.old_fingerprint, r.new_fingerprint,
            r.stragglers, r.probe_skipped)


def _state(x=0.0):
    return {"x": torch.tensor(x, dtype=torch.float32)}


def _inc(st, s):
    return {"x": st["x"] + 1.0}


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------


def test_daemon_tables_key_on_measured_geometry(tmp_path):
    d = _daemon(tmp_path)
    jd = _jdaemon(tmp_path)
    assert ":lm[" in d.topo.fingerprint()
    assert d.topo.fingerprint() == jd.topo.fingerprint()
    assert d.table.fingerprint == tuner.substrate_fingerprint(
        d.topo, force_model=True) == jd.table.fingerprint


def test_no_drift_tick_is_a_noop(tmp_path):
    d = _daemon(tmp_path)
    gen0 = d.table.generation
    report = d.tick(0)
    assert report is not None and not report.healed
    assert report.retuned_cells == () and report.affected_cells == ()
    assert report.invalidated == {"plans": 0, "executors": 0}
    assert report.generation == gen0
    assert report.old_fingerprint == report.new_fingerprint
    assert _report(report) == _report(_jdaemon(tmp_path).tick(0))


def test_tick_respects_probe_cadence(tmp_path):
    d = _daemon(tmp_path, probe_every=3)
    assert d.tick(1) is None and d.tick(2) is None
    assert d.tick(3) is not None
    with pytest.raises(ValueError, match="probe_every"):
        TuningDaemon(_base(), probe_every=0)


def test_dcn_drift_heals_scoped_not_full(tmp_path):
    fault, jfault = LinkFault(), JLinkFault()
    d, jd = _daemon(tmp_path, fault=fault), _jdaemon(tmp_path, fault=jfault)
    old_fp = d.topo.fingerprint()
    api._schedule("allgather", "hierarchical", d.topo)
    japi._schedule("allgather", "hierarchical", jd.topo)

    fault.degrade(0, beta_scale=16.0)
    jfault.degrade(0, beta_scale=16.0)
    report = d.probe_and_heal(step=7)
    assert _report(report) == _report(jd.probe_and_heal(step=7))

    assert report.healed and report.drifted_levels == (0,)
    assert report.old_fingerprint == old_fp
    assert report.new_fingerprint == d.topo.fingerprint() != old_fp
    assert 0 < len(report.affected_cells) < report.total_cells
    assert 0 < len(report.retuned_cells) <= len(report.affected_cells)
    assert report.generation == 1
    assert report.invalidated["plans"] >= 1
    assert report.invalidated["executors"] >= 1
    assert not any(k[3] == old_fp for k in executor._CACHE)
    assert not any(k[3] == old_fp for k in kernel_lowering._CACHE)
    assert d.table.fingerprint == tuner.substrate_fingerprint(
        d.topo, force_model=True)
    assert d.table.to_dict() == jd.table.to_dict()
    report2 = d.probe_and_heal(step=8)
    assert not report2.healed and report2.generation == 1


def test_healed_topology_reprices_armed_executors(tmp_path):
    fault = LinkFault()
    d = _daemon(tmp_path, fault=fault)
    before = REGISTRY["allgather"]["hierarchical"](d.topo)
    t_before = before.modeled_time(d.topo, float(1 << 20))
    fault.degrade(0, beta_scale=16.0)
    d.probe_and_heal(step=1)
    after = REGISTRY["allgather"]["hierarchical"](d.topo)
    t_after = after.modeled_time(d.topo, float(1 << 20))
    assert t_after > 4.0 * t_before
    ex = executor.get_executor(after, topo=d.topo)
    assert ex is executor.get_executor(after, topo=d.topo)  # warm


def test_daemon_shares_heartbeat_with_straggler_monitor(tmp_path):
    mon = StragglerMonitor(num_hosts=4, threshold=1.5, window=4)
    for _ in range(4):
        for h in range(3):
            mon.record(h, 1.0)
        mon.record(3, 10.0)
    d = _daemon(tmp_path, monitor=mon)
    report = d.probe_and_heal(step=0)
    assert report.stragglers == (3,)
    assert mon.assignment[3] == []      # rebalanced on the same tick


def test_daemon_background_thread_probes(tmp_path):
    d = _daemon(tmp_path)
    d.start(interval_s=0.01)
    with pytest.raises(RuntimeError, match="already started"):
        d.start(interval_s=0.01)
    deadline = time.time() + 5.0
    while not d.reports and time.time() < deadline:
        time.sleep(0.01)
    d.stop()
    assert d.reports and not d.reports[0].healed
    d.stop()                            # idempotent


# ---------------------------------------------------------------------------
# shrink_topology / rank_remap
# ---------------------------------------------------------------------------


def _shape(t):
    return [(l.name, l.size, l.dcn, l.link.alpha, l.link.beta)
            for l in t.levels]


@pytest.mark.parametrize("case", ["middle_pod", "single_pod",
                                  "inner_slice", "irregular"])
def test_shrink_equals_reference(case):
    from repro.runtime import elastic as jel
    from repro_torch.runtime import elastic as tel

    def topo(mod):
        if case == "middle_pod":
            return mod.Topology.from_levels([
                mod.TopoLevel("dcn", 3, mod.DCN_LINK, dcn=True),
                mod.TopoLevel("ici", 4, mod.ICI_LINK)])
        return _base(mod)

    t, j = topo(ttopo), topo(jtopo)
    lost = {"middle_pod": range(4, 8), "single_pod": [0, 1, 2, 3],
            "inner_slice": [r for r in range(8) if t.coords(r)[1] == 2],
            "irregular": [1, 6]}[case]
    got, want = tel.shrink_topology(t, lost), jel.shrink_topology(j, lost)
    assert _shape(got) == _shape(want)
    assert got.fingerprint() == want.fingerprint()
    assert tel.rank_remap(t, lost) == jel.rank_remap(j, lost)
    expect = {"middle_pod": [("dcn", 2), ("ici", 4)],
              "single_pod": [("ici", 4)],
              "inner_slice": [("dcn", 2), ("ici", 3)],
              "irregular": [("ici", 6)]}[case]
    assert [(l.name, l.size) for l in got.levels] == expect


def test_shrink_whole_pod_preserves_hierarchy():
    topo = Topology.from_levels([
        TopoLevel("dcn", 3, DCN_LINK, dcn=True),
        TopoLevel("ici", 4, ICI_LINK)])
    new = shrink_topology(topo, range(4, 8))
    assert new.levels[0].dcn and new.levels[0].link == DCN_LINK
    assert rank_remap(topo, range(4, 8)) == {
        0: 0, 1: 1, 2: 2, 3: 3, 8: 4, 9: 5, 10: 6, 11: 7}


def test_shrink_irregular_loss_flattens():
    new = shrink_topology(_base(), [1, 6])
    assert new.levels[0].link == ICI_LINK and not new.levels[0].dcn
    assert rank_remap(_base(), [1, 6])[7] == 5


@pytest.mark.parametrize("lost,msg", [
    ([], "empty"), ([9], "out of range"), ([-1], "out of range"),
    (list(range(8)), "all ranks"),
])
def test_shrink_rejects_bad_losses(lost, msg):
    with pytest.raises(ValueError, match=msg):
        shrink_topology(_base(), lost)


def test_rank_loss_signal_latches_and_clears():
    sig = RankLossSignal()
    assert sig.take() is None and not sig.pending
    sig.trigger(3)
    sig.trigger([1, 3, 2])
    assert sig.pending
    assert sig.take() == [1, 2, 3]
    assert sig.take() is None


# ---------------------------------------------------------------------------
# elastic re-derivation
# ---------------------------------------------------------------------------

_ENTRIES = {"grad_sync": ("allreduce", "ring_rs_ag"),
            "ep_dispatch": ("alltoall", "pairwise")}


def _swap(r):
    return (r.lost_ranks, r.old_fingerprint, r.new_fingerprint,
            r.rederived, r.refit, r.invalidated, r.generation, r.remap)


def test_elastic_swap_is_bit_exact_with_fresh_build():
    topo = _base()
    es = ElasticScheduleSet(topo, _ENTRIES)
    jes = JElastic(_base(jtopo), _ENTRIES)
    old_fp = topo.fingerprint()
    report = es.shrink([0, 1, 2, 3])
    assert _swap(report) == _swap(jes.shrink([0, 1, 2, 3]))
    assert report.lost_ranks == (0, 1, 2, 3)
    assert report.old_fingerprint == old_fp and es.topo.nranks == 4
    assert report.rederived == ("ep_dispatch", "grad_sync")
    assert report.refit == () and report.generation == 1
    assert report.invalidated >= 2
    assert report.remap == {4: 0, 5: 1, 6: 2, 7: 3}
    for name, (coll, algo) in _ENTRIES.items():
        fresh = REGISTRY[coll][algo](es.topo)
        assert es.schedule_for(name).fingerprint() == fresh.fingerprint()
        assert es.schedule_for(name).fingerprint() == \
            jes.schedule_for(name).fingerprint()
        assert es.executor_for(name) is executor.get_executor(
            fresh, topo=es.topo)
    assert not any(k[3] == old_fp for k in executor._CACHE)


def test_elastic_swap_refits_inapplicable_algorithms():
    es = ElasticScheduleSet(flat_topology(8),
                            {"ag": ("allgather", "recursive_doubling")})
    jes = JElastic(jtopo.flat_topology(8),
                   {"ag": ("allgather", "recursive_doubling")})
    report = es.shrink([2, 5])
    assert _swap(report) == _swap(jes.shrink([2, 5]))
    assert report.refit == ("ag",)
    coll, algo = es.entries["ag"]
    assert coll == "allgather" and algo != "recursive_doubling"
    assert es.schedule_for("ag").fingerprint() == \
        REGISTRY[coll][algo](es.topo).fingerprint()


def test_rank_loss_swaps_schedules_without_restart(tmp_path):
    topo = _base()
    es = ElasticScheduleSet(topo, _ENTRIES)
    sig = RankLossSignal()
    swaps = []

    def on_rank_loss(state, step, lost):
        swaps.append((step, tuple(lost), es.shrink(lost)))
        return None

    loop = FaultTolerantLoop(tmp_path, ckpt_every=100, rank_loss=sig,
                             on_rank_loss=on_rank_loss)
    state, done = loop.run(
        _state(), _inc, start_step=0, num_steps=6,
        on_step=lambda step, st: sig.trigger([4, 5, 6, 7])
        if step == 3 else None)

    assert done == 6 and float(state["x"]) == 6.0
    assert len(swaps) == 1
    step, lost, report = swaps[0]
    assert step == 3 and lost == (4, 5, 6, 7)
    assert es.topo.nranks == 4 and report.generation == 1
    tree, meta = restore_checkpoint(tmp_path, _state(), step=3)
    assert meta["lost_ranks"] == [4, 5, 6, 7]
    assert float(tree["x"]) == 3.0
    for name, (coll, algo) in _ENTRIES.items():
        assert es.schedule_for(name).fingerprint() == \
            REGISTRY[coll][algo](es.topo).fingerprint()


def test_fleet_end_to_end_drift_then_shrink(tmp_path):
    fault = LinkFault()
    d = _daemon(tmp_path, fault=fault)
    es = ElasticScheduleSet(d.topo, _ENTRIES)
    sig = RankLossSignal()
    events = []

    def on_step(step, state):
        if step == 2:
            fault.degrade(0, beta_scale=16.0)
        report = d.tick(step)
        if report is not None and report.healed:
            events.append(("healed", step, report))
        if step == 4:
            sig.trigger([0, 1, 2, 3])

    def on_rank_loss(state, step, lost):
        events.append(("shrunk", step, es.shrink(lost)))
        return None

    loop = FaultTolerantLoop(tmp_path, ckpt_every=100, rank_loss=sig,
                             on_rank_loss=on_rank_loss)
    state, done = loop.run(_state(), _inc, start_step=0, num_steps=6,
                           on_step=on_step)
    assert done == 6 and float(state["x"]) == 6.0
    assert [e[0] for e in events] == ["healed", "shrunk"]
    _, heal_step, heal = events[0]
    assert heal_step == 2 and heal.drifted_levels == (0,)
    assert 0 < len(heal.affected_cells) < heal.total_cells
    _, shrink_step, swap = events[1]
    assert shrink_step == 4 and es.topo.nranks == 4
    for name, (coll, algo) in _ENTRIES.items():
        assert es.schedule_for(name).fingerprint() == \
            REGISTRY[coll][algo](es.topo).fingerprint()


# ---------------------------------------------------------------------------
# BENCH_transport.json's fleet section, exactly
# ---------------------------------------------------------------------------


def bench_fleet() -> dict:
    """The port's counterpart of ``benchmarks/bench_transport.py``'s
    ``bench_fleet``: a DCN beta x16 collapse healed by a model-timed
    ``TuningDaemon``, then pod 0 lost under an ``ElasticScheduleSet``."""
    import tempfile
    from pathlib import Path

    base = _base()
    fault = LinkFault()
    with tempfile.TemporaryDirectory() as td:
        daemon = TuningDaemon(
            base, path=Path(td) / "tuned.json", force_model=True,
            timer=model_timer(base, fault=fault), repeats=1)
        fault.degrade(0, beta_scale=16.0)
        report = daemon.probe_and_heal(step=1)
    heal = {
        "drifted_levels": list(report.drifted_levels),
        "cells_total": report.total_cells,
        "cells_affected": len(report.affected_cells),
        "cells_retuned": len(report.retuned_cells),
        "generation": report.generation,
        "invalidated": report.invalidated,
        "scoped": bool(
            0 < len(report.affected_cells) < report.total_cells),
    }
    schedules = ElasticScheduleSet(daemon.topo, _ENTRIES)
    swap = schedules.shrink([0, 1, 2, 3])
    bit_exact = all(
        schedules.schedule_for(name).fingerprint()
        == REGISTRY[coll][algo](schedules.topo).fingerprint()
        for name, (coll, algo) in schedules.entries.items())
    elastic = {
        "lost_ranks": list(swap.lost_ranks),
        "old_fingerprint": swap.old_fingerprint,
        "new_fingerprint": swap.new_fingerprint,
        "rederived": len(swap.rederived),
        "invalidated": swap.invalidated,
        "generation": swap.generation,
        "bit_exact": bool(bit_exact),
    }
    return {"heal": heal, "elastic": elastic}


def test_fleet_section_of_bench_transport_exactly():
    code = ("import json, sys; sys.path.insert(0, 'tests'); "
            "import test_torch_fleet as f; print(json.dumps(f.bench_fleet()))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    with open(os.path.join(ROOT, "BENCH_transport.json")) as f:
        want = json.load(f)["fleet"]
    assert got == want
    assert got["heal"]["cells_affected"] == 12
    assert got["heal"]["cells_total"] == 16
    assert got["heal"]["invalidated"] == {"plans": 0, "executors": 17}
    assert got["elastic"]["invalidated"] == 17
    assert got["elastic"]["rederived"] == 2 and got["elastic"]["bit_exact"]
