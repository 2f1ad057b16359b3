"""The port's runtime (repro_torch.runtime): the cases of the reference's
``tests/test_runtime_recovery.py`` and ``tests/test_runtime_exec.py``,
each held against the reference package on the same inputs, and the
``FaultTolerantLoop`` draining the degradation reports of a seeded
chaos campaign run through the ``mpix_*`` recovery ladder.

  * a straggler that recovers reclaims its home data shard; the
    monitor's assignments equal the reference's on the same samples;
  * ``PreemptionSignal(install_handlers=True)`` latches SIGTERM and
    SIGINT, chains a prior callable handler, never chains the default
    SIGINT handler, and uninstalls cleanly;
  * one committed checkpoint per step, whether preemption lands on a
    periodic boundary or not;
  * a slow link changes the model (makespan) but never the math, and a
    preempted loop whose step runs the committed pipelined schedule
    resumes to the bit-identical final state.
"""
import dataclasses
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import executor as jexecutor
from repro.core import topology as jtopo
from repro.core.algorithms import REGISTRY as JREGISTRY
from repro.core.schedule import ComputeEvent as JComputeEvent
from repro.runtime.straggler import StragglerMonitor as JStragglerMonitor

from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.core import api, executor
from repro_torch.core import topology as ttopo
from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.chaos import FaultPlan
from repro_torch.core.schedule import ComputeEvent
from repro_torch.core.transport import SimTransport
from repro_torch.runtime.fault import FaultTolerantLoop, PreemptionSignal
from repro_torch.runtime.straggler import StragglerMonitor


@pytest.fixture(autouse=True)
def _fresh_executor_cache():
    executor.clear_cache()
    yield
    executor.clear_cache()


# ---------------------------------------------------------------------------
# straggler recovery (both packages on the same samples)
# ---------------------------------------------------------------------------


class _Both:
    """The port's and the reference's monitors fed alike."""

    def __init__(self, **kw):
        self.t, self.j = StragglerMonitor(**kw), JStragglerMonitor(**kw)

    def feed(self, host, t, n=16):
        for _ in range(n):
            self.t.record(host, t)
            self.j.record(host, t)

    def set_assignment(self, a):
        self.t.assignment = {k: list(v) for k, v in a.items()}
        self.j.assignment = {k: list(v) for k, v in a.items()}

    def stragglers(self):
        got = self.t.stragglers()
        assert got == self.j.stragglers()
        return got

    def rebalance(self):
        got = self.t.rebalance()
        assert got == self.j.rebalance()
        return got


def test_recovered_straggler_reclaims_home_shard():
    mon = _Both(num_hosts=4, threshold=1.5, window=8)
    for h in range(3):
        mon.feed(h, 1.0, n=8)
    mon.feed(3, 10.0, n=8)
    assign = mon.rebalance()
    assert mon.stragglers() == [3]
    assert assign[3] == []
    donor = next(h for h, s in assign.items() if 3 in s)
    mon.feed(3, 1.0, n=8)
    assert mon.stragglers() == []
    assign = mon.rebalance()
    assert assign[3] == [3]
    assert 3 not in assign[donor]
    assert sorted(s for shards in assign.values()
                  for s in shards) == [0, 1, 2, 3]


def test_recovery_runs_even_with_no_current_stragglers():
    mon = _Both(num_hosts=3, threshold=1.5, window=4)
    mon.set_assignment({0: [0, 2], 1: [1], 2: []})
    for h in range(3):
        mon.feed(h, 1.0, n=4)
    assert mon.stragglers() == []
    assert mon.rebalance() == {0: [0], 1: [1], 2: [2]}


def test_unknown_host_stays_evicted():
    mon = _Both(num_hosts=3, threshold=1.5, window=4)
    mon.set_assignment({0: [0, 2], 1: [1], 2: []})
    mon.feed(0, 1.0, n=4)
    mon.feed(1, 1.0, n=4)
    assign = mon.rebalance()
    assert assign[2] == [] and 2 in assign[0]


def test_still_slow_host_stays_evicted():
    mon = _Both(num_hosts=4, threshold=1.5, window=8)
    for h in range(3):
        mon.feed(h, 1.0, n=8)
    mon.feed(3, 10.0, n=8)
    mon.rebalance()
    mon.feed(3, 10.0, n=8)
    assert mon.rebalance()[3] == []


# ---------------------------------------------------------------------------
# preemption signal handlers
# ---------------------------------------------------------------------------


@pytest.fixture
def _restore_signals():
    prev = {sig: signal.getsignal(sig)
            for sig in (signal.SIGTERM, signal.SIGINT)}
    yield
    for sig, h in prev.items():
        signal.signal(sig, h)


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT])
def test_install_handlers_latches_both_signals(_restore_signals, sig):
    ps = PreemptionSignal(install_handlers=True)
    try:
        assert not ps.preempted
        signal.raise_signal(sig)
        assert ps.preempted
    finally:
        ps.uninstall()


def test_prior_callable_handler_is_chained(_restore_signals):
    hits = []
    signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    ps = PreemptionSignal(install_handlers=True)
    try:
        signal.raise_signal(signal.SIGTERM)
        assert ps.preempted
        assert hits == [signal.SIGTERM]
    finally:
        ps.uninstall()


def test_default_sigint_handler_is_not_chained(_restore_signals):
    signal.signal(signal.SIGINT, signal.default_int_handler)
    ps = PreemptionSignal(install_handlers=True)
    try:
        signal.raise_signal(signal.SIGINT)   # must NOT raise
        assert ps.preempted
    finally:
        ps.uninstall()


def test_install_is_idempotent_and_uninstall_restores(_restore_signals):
    def prior(s, f):
        pass

    signal.signal(signal.SIGTERM, prior)
    ps = PreemptionSignal(install_handlers=True)
    try:
        installed = signal.getsignal(signal.SIGTERM)
        ps.install()
        assert signal.getsignal(signal.SIGTERM) is installed
    finally:
        ps.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prior


# ---------------------------------------------------------------------------
# one committed checkpoint per step
# ---------------------------------------------------------------------------


def _counting_loop(tmp_path, **kw):
    loop = FaultTolerantLoop(tmp_path, **kw)
    counts, metas = {}, {}
    orig = loop.ckpt.save

    def spy(step, tree, meta=None):
        counts[step] = counts.get(step, 0) + 1
        metas[step] = meta
        orig(step, tree, meta=meta)

    loop.ckpt.save = spy
    return loop, counts, metas


def _state():
    return {"x": torch.tensor(0.0)}


def _step_fn(state, step):
    return {"x": state["x"] + 1.0}


def test_preemption_on_ckpt_boundary_saves_once(tmp_path):
    loop, counts, metas = _counting_loop(tmp_path, ckpt_every=3)
    sig = loop.preemption
    state, stopped = loop.run(
        _state(), _step_fn, start_step=0, num_steps=10,
        on_step=lambda step, st: sig.trigger() if step == 3 else None)
    assert stopped == 3
    assert counts == {3: 1}, counts
    assert latest_step(tmp_path) == 3
    tree, meta = restore_checkpoint(tmp_path, _state())
    assert meta["next_step"] == 3 and float(tree["x"]) == 3.0


def test_preemption_off_boundary_saves_final_checkpoint(tmp_path):
    loop, counts, metas = _counting_loop(tmp_path, ckpt_every=3)
    sig = loop.preemption
    _, stopped = loop.run(
        _state(), _step_fn, start_step=0, num_steps=10,
        on_step=lambda step, st: sig.trigger() if step == 2 else None)
    assert stopped == 2
    assert counts == {2: 1}
    assert metas[2]["preempted"] is True


def test_final_step_on_ckpt_boundary_saves_once(tmp_path):
    loop, counts, metas = _counting_loop(tmp_path, ckpt_every=3)
    _, done = loop.run(_state(), _step_fn, start_step=0, num_steps=6)
    assert done == 6
    assert counts == {3: 1, 6: 1}, counts
    assert latest_step(tmp_path) == 6


def test_async_save_copies_host_leaves(tmp_path):
    """The loop may update its state in place once ``save`` returns:
    the checkpoint holds the values at the save."""
    loop = FaultTolerantLoop(tmp_path)
    state = {"w": torch.arange(4.0)}
    loop.ckpt.save(1, state, meta={"next_step": 1})
    state["w"].add_(100.0)
    loop.ckpt.wait()
    tree, _ = restore_checkpoint(tmp_path, state, step=1)
    assert torch.equal(tree["w"], torch.arange(4.0))


# ---------------------------------------------------------------------------
# the loop drains the recovery ladder's reports
# ---------------------------------------------------------------------------


def test_loop_drains_a_seeded_chaos_campaigns_degradations(tmp_path):
    """Each step runs an armed ``mpix_allreduce`` under a seeded
    transient-failure campaign; the loop drains every step's reports
    (``api.take_degradations``) into ``loop.degradations`` and hands
    each to ``on_degraded``.  The steps' results are the fault-free
    ones, bit for bit."""
    import torch.distributed as dist

    from repro_torch.core.topology import flat_topology

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    seen = []
    try:
        group = dist.group.WORLD
        topo = flat_topology(1)
        algos = ("ring_rs_ag", "recursive_halving_doubling")

        def step_fn(state, step):
            plan = FaultPlan(step, "fail", times=1) if step % 2 == 0 \
                else None
            api.set_chaos(plan)
            try:
                y = api.mpix_allreduce(
                    state["x"], group, algorithm=algos[step % 2],
                    topo=topo, resilience={"verify": "off",
                                           "backoff_s": 1e-4})
            finally:
                api.set_chaos(None)
            return {"x": y * 0.5 + float(step)}

        api.take_degradations()
        loop = FaultTolerantLoop(tmp_path / "ckpt", ckpt_every=100,
                                 on_degraded=lambda s, r: seen.append(s))
        init = {"x": torch.linspace(-1.0, 1.0, 6)}
        final, done = loop.run(init, step_fn, start_step=0, num_steps=6)
    finally:
        dist.destroy_process_group()
    assert done == 6
    # steps 0, 2, 4 faulted once and recovered on their second attempt
    assert seen == [1, 3, 5]
    keys = [[(a.rung, a.attempt, a.outcome) for a in r.attempts]
            for r in loop.degradations]
    assert keys == [[("dist", 0, "fault"), ("dist", 1, "ok")]] * 3
    assert all(r.recovered_with == "dist" and r.degraded
               for r in loop.degradations)
    assert api.take_degradations() == []
    want = init["x"]
    for step in range(6):
        want = want * 0.5 + float(step)
    assert torch.equal(final["x"], want)


# ---------------------------------------------------------------------------
# runtime x pipelined executor (both packages on the same topologies)
# ---------------------------------------------------------------------------


def _two_pod(mod, dcn_beta_scale: float):
    slow = mod.LinkModel(alpha=mod.DCN_LINK.alpha,
                         beta=mod.DCN_LINK.beta * dcn_beta_scale)
    return mod.Topology.from_levels([
        mod.TopoLevel("dcn", 2, slow, dcn=True),
        mod.TopoLevel("ici", 4, mod.ICI_LINK)])


def _armed(topo, *, port=True, splittable=True):
    reg, ev_cls, ex_mod = ((REGISTRY, ComputeEvent, executor) if port
                           else (JREGISTRY, JComputeEvent, jexecutor))
    base = reg["allgather"]["hierarchical"](topo)
    ev = ev_cls("mlp", base.modeled_time(topo, 4096.0), after_round=-1,
                splittable=splittable, parts=4)
    sched = dataclasses.replace(base, compute_events=(ev,))
    return sched, ex_mod.get_executor(sched, topo=topo)


def test_slow_link_degrades_makespan_monotonically():
    slot = float(1 << 20)
    mks = []
    for scale in (1.0, 4.0, 16.0):
        topo = _two_pod(ttopo, scale)
        sched, ex = _armed(topo)
        _, jex = _armed(_two_pod(jtopo, scale), port=False)
        mks.append(ex.makespan(slot))
        assert mks[-1] == jex.makespan(slot)
        ev_s = sum(e.seconds for e in sched.compute_events)
        assert mks[-1] <= (ex.compiled_schedule.modeled_time(
            topo, slot) + ev_s) * (1 + 1e-9)
    assert mks[0] < mks[1] < mks[2], mks


def test_slow_link_never_changes_the_math():
    rng = np.random.default_rng(0)
    base_sched, _ = _armed(_two_pod(ttopo, 1.0))
    buf = rng.standard_normal((8, base_sched.num_slots, 2)).astype(
        np.float32)
    buf.reshape(-1)[::5] = -0.0
    tr = SimTransport(8)
    want = tr.run_reference(base_sched, buf)
    for scale in (4.0, 16.0):
        sched, ex = _armed(_two_pod(ttopo, scale))
        _, jex = _armed(_two_pod(jtopo, scale), port=False)
        got = ex.run_sim(buf)
        assert got.tobytes() == want.tobytes()
        assert got.tobytes() == np.asarray(jex.run_sim(buf)).tobytes()
        if ex.pipelined_schedule is not None:
            assert tr.run_reference(ex.pipelined_schedule,
                                    buf).tobytes() == want.tobytes()


def test_straggler_monitor_flags_slow_pod_host():
    slot = float(1 << 20)
    _, fast_ex = _armed(_two_pod(ttopo, 1.0))
    _, slow_ex = _armed(_two_pod(ttopo, 16.0))
    t_fast, t_slow = fast_ex.makespan(slot), slow_ex.makespan(slot)
    assert t_slow > 1.5 * t_fast
    mon = _Both(num_hosts=4, threshold=1.5)
    for step in range(6):
        for h in range(3):
            mon.feed(h, t_fast * (1 + 0.01 * step), n=1)
        mon.feed(3, t_slow, n=1)
    assert mon.stragglers() == [3]
    assign = mon.rebalance()
    assert assign[3] == [] and sorted(
        s for shards in assign.values() for s in shards) == [0, 1, 2, 3]


def test_fault_resume_pipelined_step_bit_exact(tmp_path):
    topo = _two_pod(ttopo, 1.0)
    sched, ex = _armed(topo)
    assert ex.pipeline_tail_parts >= 2
    pipelined = ex.pipelined_schedule
    tr = SimTransport(8)
    rng = np.random.default_rng(1)
    init = {"buf": torch.from_numpy(rng.normal(
        size=(8, sched.num_slots, 2)).astype(np.float32))}

    def step_fn(state, step):
        out = tr.run_reference(pipelined, state["buf"].numpy())
        return {"buf": torch.from_numpy(
            (0.5 * out + float(step)).astype(np.float32))}

    ref = dict(init)
    for s in range(6):
        ref = step_fn(ref, s)

    loop = FaultTolerantLoop(tmp_path, ckpt_every=100)
    sig = loop.preemption
    state, stopped = loop.run(
        init, step_fn, start_step=0, num_steps=6,
        on_step=lambda step, st: sig.trigger() if step == 3 else None)
    assert stopped == 3

    loop2 = FaultTolerantLoop(tmp_path, ckpt_every=100,
                              preemption=PreemptionSignal())
    state2, start = loop2.resume_or_init(init)
    assert start == 3
    final, done = loop2.run(state2, step_fn, start_step=start,
                            num_steps=6 - start)
    assert done == 6
    assert torch.equal(final["buf"].view(torch.int32),
                       ref["buf"].view(torch.int32))
