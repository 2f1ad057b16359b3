"""The port's chaos injection and recovery ladder, held against the
reference package on the same inputs.

Fault placement is a sha1 of (seed, campaign, schedule fingerprint), so
the port's ``FaultPlan`` must place every fault where the reference's
does, on every REGISTRY schedule and on its canary'd schedule.  The
ladder's reports must then agree field for field (rung names mapped:
the reference's ``pallas`` is the port's ``kernel``, its ``shardmap``
the port's ``dist``), and every recovered output must equal the
reference's and the fault-free oracle bit for bit.  Inputs are the
reference's integer buffers and random floats with negative zeros.  The
``kernel`` rung runs the transport kernel's plain version here.  The
``chaos`` section of ``BENCH_transport.json`` is reproduced exactly.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import chaos as jchaos
from repro.core import resilient as jres
from repro.core import tuner as jtuner
from repro.core.algorithms import REGISTRY as JREGISTRY
from repro.core.schedule import NotApplicable as JNotApplicable
from repro.core.schedule import add_canary_slot as jadd_canary
from repro.core.topology import flat_topology as jflat
from repro.core.transport import PallasTransport as JPallasTransport
from repro.core.transport import SimTransport as JSimTransport

from repro_torch.convert import schedule_from_numpy, schedule_to_numpy
from repro_torch.core import chaos, tuner
from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.chaos import ChaosTransport, FaultPlan
from repro_torch.core.resilient import (RUNGS, ResilienceOptions,
                                        ResilientExec, UnrecoverableError,
                                        canary_pattern, resolve_resilience,
                                        run_resilient)
from repro_torch.core.schedule import NotApplicable, add_canary_slot
from repro_torch.core.topology import flat_topology
from repro_torch.core.transport import (KernelTransport, SimTransport,
                                        TransportError)

sys.path.insert(0, os.path.dirname(__file__))

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
TOPO, JTOPO = flat_topology(4), jflat(4)
CASES = [("allgather", "ring"), ("allreduce", "ring_rs_ag"),
         ("reduce_scatter", "ring"), ("alltoall", "pairwise")]
CAMPAIGNS = ["corrupt", "fail", "hang", "mixed"]
# the reference package's names of the port's rungs
REFERENCE_RUNGS = {"kernel": "pallas", "dist": "shardmap"}


def _pair(coll, alg, n=4):
    """(reference schedule, port schedule) of one REGISTRY entry."""
    return (JREGISTRY[coll][alg](jflat(n)),
            REGISTRY[coll][alg](flat_topology(n)))


def _gbuf(sched, seed=0, width=3, data="ints"):
    """The reference tests' integer buffer, or random floats with
    negative zeros."""
    rng = np.random.default_rng(seed)
    shape = (sched.nranks, sched.num_slots, width)
    if data == "ints":
        return rng.integers(-8, 8, shape).astype(np.float32)
    buf = rng.standard_normal(shape).astype(np.float32)
    buf.reshape(-1)[::7] = -0.0
    return buf


def _region(sched, out):
    out = np.asarray(out)
    rows = sched.result_slots
    return np.stack([out[r, sched.out_offset(r):
                         sched.out_offset(r) + rows]
                     for r in range(sched.nranks)])


def _oracle(jsched, buf):
    return _region(jsched,
                   JSimTransport(jsched.nranks).run_reference(jsched, buf))


def _key(rep, rename=None):
    """A report's comparable fields (attempt seconds and free-text
    details aside), rung names mapped through ``rename``."""
    rename = rename or {}
    r = lambda x: rename.get(x, x)
    return ([(r(a.rung), a.algorithm, a.attempt, a.outcome)
             for a in rep.attempts],
            [(k, bool(v)) for k, v in rep.verdicts],
            r(rep.recovered_with), rep.refit_algorithm, rep.schedule,
            rep.verify, rep.degraded, rep.retries)


def _both(jsched, psched, buf, *, options, jtransports, ptransports,
          topo=True, **kw):
    """Run the reference's and the port's ResilientExec on the same
    buffer; returns ((out, report) reference, (out, report) port)."""
    jex = jres.ResilientExec(
        jsched, JTOPO if topo else None,
        options=jres.ResilienceOptions(**options),
        transports=jtransports, **kw)
    pex = ResilientExec(psched, TOPO if topo else None,
                        options=ResilienceOptions(**options),
                        transports=ptransports, **kw)
    return jex.run(buf.copy()), pex.run(buf.copy())


# ---------------------------------------------------------------------------
# fault placement: equal to the reference's on every schedule
# ---------------------------------------------------------------------------


PLACEMENT_CASES = [(n, coll, alg) for n in (4, 8)
                   for coll in REGISTRY for alg in REGISTRY[coll]]


@pytest.mark.parametrize("n,coll,alg", PLACEMENT_CASES)
def test_events_for_equal_reference(n, coll, alg):
    try:
        jsched = JREGISTRY[coll][alg](jflat(n))
    except JNotApplicable:
        with pytest.raises(NotApplicable):
            REGISTRY[coll][alg](flat_topology(n))
        return
    psched = REGISTRY[coll][alg](flat_topology(n))
    jcan, pcan = jadd_canary(jsched), add_canary_slot(psched)
    assert pcan.fingerprint() == jcan.fingerprint()
    assert (pcan.num_slots, pcan.name) == (jcan.num_slots, jcan.name)
    for js, ps in ((jsched, psched), (jcan, pcan)):
        assert ps.fingerprint() == js.fingerprint()
        for campaign in CAMPAIGNS:
            for seed in range(5):
                kw = dict(max_faults=3, delay_s=0.01)
                want = jchaos.FaultPlan(seed, campaign, **kw).events_for(js)
                got = FaultPlan(seed, campaign, **kw).events_for(ps)
                assert [tuple(vars(e).values()) for e in got] == \
                    [tuple(vars(e).values()) for e in want], \
                    (coll, alg, campaign, seed)


# ---------------------------------------------------------------------------
# FaultPlan: validation, firing state, corruption
# ---------------------------------------------------------------------------


def _error(fn, *a, **kw) -> str:
    with pytest.raises(ValueError) as ei:
        fn(*a, **kw)
    return str(ei.value)


@pytest.mark.parametrize("kw", [
    dict(campaign="melt"), dict(campaign="corrupt", mode="gamma-ray"),
    dict(campaign="corrupt", times=-1), dict(campaign="corrupt",
                                             max_faults=0),
    dict(campaign="hang", delay_s=float("nan"))])
def test_fault_plan_validation(kw):
    assert _error(FaultPlan, 0, **kw) == _error(jchaos.FaultPlan, 0, **kw)


def test_fault_plan_deterministic_placement():
    _, sched = _pair("allgather", "ring")
    for campaign in chaos.CAMPAIGNS:
        a = FaultPlan(7, campaign, max_faults=3).events_for(sched)
        b = FaultPlan(7, campaign, max_faults=3).events_for(sched)
        assert a == b
        for ev in a:
            assert 0 <= ev.round_idx < sched.num_rounds
            assert 0 <= ev.rank < sched.nranks
            assert 0 <= ev.slot < sched.num_slots
    assert (FaultPlan(7, "corrupt").events_for(sched)
            != FaultPlan(8, "corrupt").events_for(sched))
    _, other = _pair("alltoall", "pairwise")
    assert (FaultPlan(7, "corrupt").events_for(sched)
            != FaultPlan(7, "corrupt").events_for(other))


def test_fault_plan_transient_counter_and_reset():
    _, sched = _pair("allgather", "ring")
    plan = FaultPlan(3, "fail", times=2)
    assert plan.take(sched) and plan.take(sched)
    assert plan.take(sched) == ()          # exhausted after ``times``
    plan.reset()
    assert plan.take(sched)                # replays after reset
    scoped = FaultPlan(3, "fail", match="no-such-schedule")
    assert scoped.take(sched) == ()        # match filter gates firing
    assert FaultPlan(3, "fail", match=sched.name).take(sched)
    assert FaultPlan(3, "fail", match=sched.fingerprint()[:12]).take(sched)


def test_fault_plan_injector_protocol():
    from repro_torch.core.topology import LinkModel
    link = LinkModel(alpha=1e-6, beta=2e-11)
    hang = FaultPlan(0, "hang", alpha_scale=200.0)
    assert hang.apply(0, link) == LinkModel(alpha=1e-6 * 200.0, beta=2e-11)
    assert FaultPlan(0, "corrupt").apply(1, link) is link
    _, sched = _pair("allgather", "ring")
    hang.take(sched)
    hang.clear()
    assert hang._fired == {}


def test_chaos_transport_fail_is_typed_and_attributed():
    jsched, sched = _pair("allgather", "ring")
    buf = _gbuf(sched)
    tr = chaos.wrap(SimTransport(4), FaultPlan(1, "fail"))
    assert isinstance(tr, ChaosTransport)
    with pytest.raises(TransportError) as ei:
        tr.run(sched, buf)
    with pytest.raises(Exception) as ej:
        jchaos.wrap(JSimTransport(4), jchaos.FaultPlan(1, "fail")).run(
            jsched, buf)
    assert str(ei.value) == str(ej.value)
    assert ei.value.transport == "SimTransport"
    assert ei.value.round_idx == FaultPlan(1, "fail").events_for(
        sched)[0].round_idx == ej.value.round_idx
    # transient: the second execution is clean and bit-exact
    out = tr.run(sched, buf)
    assert _region(sched, out).tobytes() == _oracle(jsched, buf).tobytes()
    # delegation: everything else reaches the inner transport
    assert tr.nranks == 4


def test_chaos_wrap_none_is_passthrough():
    tr = SimTransport(4)
    assert chaos.wrap(tr, None) is tr


@pytest.mark.parametrize("mode", ["nan", "bitflip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_corrupt_matches_reference(mode, dtype):
    """``_corrupt`` on a numpy array and on a tensor gives the reference's
    bits (bf16 flips bit 14, as the reference's uint16 view does).  In
    bf16 the reference's XLA build hands back a canonical NaN where the
    flipped bits spell a NaN; there the port keeps the flipped bits, and
    both must be NaN."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((4, 6, 5)).astype(np.float32)
    a.reshape(-1)[::5] = -0.0
    ev = jchaos.FaultEvent(kind="corrupt", round_idx=0, rank=2, slot=3,
                           mode=mode)
    pev = chaos.FaultEvent(kind="corrupt", round_idx=0, rank=2, slot=3,
                           mode=mode)
    if dtype == "int32":
        a = (a * 100).astype(np.int32)
    jdt = {"bfloat16": jnp.bfloat16}.get(dtype, dtype)
    want = np.asarray(jchaos._corrupt(jnp.asarray(a, jdt), ev))
    if dtype == "bfloat16":
        want_bits = want.view(np.uint16).view(np.int16).copy()
        t = torch.from_numpy(a).to(torch.bfloat16)
        got = chaos._corrupt(t, pev)
        nan = np.isnan(want.astype(np.float32))
        assert np.array_equal(nan, torch.isnan(got).numpy())
        assert np.array_equal(got.view(torch.int16).numpy()[~nan],
                              want_bits[~nan])
        if mode == "bitflip":
            flipped = t.view(torch.int16) ^ (1 << 14)
            assert torch.equal(got.view(torch.int16)[2, 3], flipped[2, 3])
        assert torch.equal(t, torch.from_numpy(a).to(torch.bfloat16))
        return
    got_np = chaos._corrupt(a, pev)
    assert isinstance(got_np, np.ndarray)
    assert got_np.tobytes() == want.astype(a.dtype).tobytes()
    got_t = chaos._corrupt(torch.from_numpy(a), pev)
    assert isinstance(got_t, torch.Tensor)
    assert got_t.numpy().tobytes() == want.astype(a.dtype).tobytes()
    # a copy: the input is untouched
    assert a.tobytes() == np.asarray(a).tobytes()


# ---------------------------------------------------------------------------
# ResilienceOptions / resolve_resilience / canary
# ---------------------------------------------------------------------------


def test_resolve_resilience_forms():
    assert resolve_resilience(None) is None
    assert resolve_resilience(False) is None
    assert resolve_resilience(True) == ResilienceOptions()
    assert ResilienceOptions().ladder == RUNGS == (
        "kernel", "dist", "sim", "reference")
    assert resolve_resilience("full").verify == "full"
    assert resolve_resilience({"max_retries": 5}).max_retries == 5
    opts = ResilienceOptions(verify="off")
    assert resolve_resilience(opts) is opts
    for bad in ("sideways", 3.14):
        assert _error(resolve_resilience, bad) == \
            _error(jres.resolve_resilience, bad)


@pytest.mark.parametrize("kw", [
    dict(verify="sometimes"), dict(max_retries=-1),
    dict(backoff_s=float("inf")), dict(backoff_mult=0.5),
    dict(deadline_s=0.0), dict(ladder=())])
def test_resilience_options_validation(kw):
    assert _error(ResilienceOptions, **kw) == \
        _error(jres.ResilienceOptions, **kw)


def test_resilience_options_rejects_unknown_rung():
    with pytest.raises(ValueError, match="unknown ladder rung 'warp'"):
        ResilienceOptions(ladder=("warp",))
    with pytest.raises(ValueError):
        ResilienceOptions(ladder=("pallas",))      # the reference's name


def test_canary_pattern_equals_reference():
    jsched, sched = _pair("allgather", "ring")
    for dt in (np.float32, np.int32):
        a = canary_pattern(sched, dt, (3,))
        assert a.shape == (4, 1, 3) and a.dtype == dt
        assert a.tobytes() == jres.canary_pattern(jsched, dt, (3,)).tobytes()
        assert (a != 0).all()
    t = canary_pattern(sched, torch.bfloat16, (3,))
    assert t.dtype == torch.bfloat16
    assert torch.equal(t.float(), torch.from_numpy(
        canary_pattern(sched, np.float32, (3,))))   # exact in bf16


# ---------------------------------------------------------------------------
# the metamorphic core, through both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data", ["ints", "floats"])
@pytest.mark.parametrize("campaign", CAMPAIGNS)
@pytest.mark.parametrize("coll,alg", CASES)
def test_campaign_recovers_bitwise(coll, alg, campaign, data):
    jsched, sched = _pair(coll, alg)
    buf = _gbuf(sched, data=data)
    want = _oracle(jsched, buf)
    for seed in range(3):
        opts = dict(verify="full", ladder=("sim", "reference"),
                    backoff_s=1e-4)
        (jout, jrep), (out, rep) = _both(
            jsched, sched, buf, options=opts,
            jtransports={"sim": jchaos.wrap(
                JSimTransport(4), jchaos.FaultPlan(seed, campaign,
                                                   delay_s=0.005))},
            ptransports={"sim": chaos.wrap(
                SimTransport(4), FaultPlan(seed, campaign, delay_s=0.005))})
        assert isinstance(out, np.ndarray)
        assert _region(sched, out).tobytes() == want.tobytes()
        assert np.asarray(out).tobytes() == np.asarray(jout).tobytes()
        assert _key(rep) == _key(jrep), (seed, rep.summary(),
                                         jrep.summary())


@pytest.mark.parametrize("data", ["ints", "floats"])
@pytest.mark.parametrize("campaign", CAMPAIGNS)
@pytest.mark.parametrize("coll,alg", CASES)
def test_campaign_on_the_kernel_rung(coll, alg, campaign, data):
    """The kernel rung (its plain version here) chaos-wrapped: the
    report equals the reference's with its sim rung wrapped (kernel
    read as sim), and the output is bitwise the oracle's."""
    jsched, sched = _pair(coll, alg)
    buf = _gbuf(sched, data=data)
    want = _oracle(jsched, buf)
    for seed in range(3):
        jex = jres.ResilientExec(
            jsched, JTOPO, options=jres.ResilienceOptions(
                verify="full", ladder=("sim", "reference"), backoff_s=1e-4),
            transports={"sim": jchaos.wrap(JSimTransport(4), jchaos.FaultPlan(
                seed, campaign, delay_s=0.005))})
        jout, jrep = jex.run(buf.copy())
        ex = ResilientExec(
            sched, TOPO, options=ResilienceOptions(
                verify="full", ladder=("kernel", "reference"),
                backoff_s=1e-4),
            transports={"kernel": chaos.wrap(
                KernelTransport(4, topo=TOPO),
                FaultPlan(seed, campaign, delay_s=0.005))})
        out, rep = ex.run(torch.from_numpy(buf.copy()))
        assert isinstance(out, torch.Tensor)
        assert _region(sched, out.numpy()).tobytes() == want.tobytes()
        assert _key(rep, {"kernel": "sim"}) == _key(jrep), (
            seed, rep.summary(), jrep.summary())


@pytest.mark.parametrize("coll,alg", CASES)
def test_kernel_rung_matches_reference_pallas_rung(coll, alg):
    """The port's kernel rung against the reference's pallas rung (its
    Pallas kernel in interpret mode), both chaos-wrapped: reports equal
    with ``pallas`` read as ``kernel``."""
    jsched, sched = _pair(coll, alg)
    buf = _gbuf(sched, data="floats")
    for campaign in CAMPAIGNS:
        opts = dict(verify="full", ladder=("pallas", "reference"),
                    backoff_s=1e-4)
        jex = jres.ResilientExec(
            jsched, JTOPO, options=jres.ResilienceOptions(**opts),
            transports={"pallas": jchaos.wrap(
                JPallasTransport(4, topo=JTOPO),
                jchaos.FaultPlan(1, campaign, delay_s=0.005))})
        jout, jrep = jex.run(buf.copy())
        opts["ladder"] = ("kernel", "reference")
        ex = ResilientExec(
            sched, TOPO, options=ResilienceOptions(**opts),
            transports={"kernel": chaos.wrap(
                KernelTransport(4, topo=TOPO),
                FaultPlan(1, campaign, delay_s=0.005))})
        out, rep = ex.run(buf.copy())
        assert out.tobytes() == np.asarray(jout).tobytes()
        assert _key(rep, REFERENCE_RUNGS) == _key(jrep), (
            campaign, rep.summary(), jrep.summary())


# ---------------------------------------------------------------------------
# the ladder's other walks, through both packages
# ---------------------------------------------------------------------------


def test_persistent_fault_walks_to_clean_reference_rung():
    jsched, sched = _pair("allgather", "ring")
    buf = _gbuf(sched, data="floats")
    opts = dict(verify="canary", max_retries=1,
                ladder=("sim", "reference"), backoff_s=1e-4)
    (jout, jrep), (out, rep) = _both(
        jsched, sched, buf, options=opts,
        jtransports={"sim": jchaos.wrap(
            JSimTransport(4), jchaos.FaultPlan(0, "fail", times=None))},
        ptransports={"sim": chaos.wrap(
            SimTransport(4), FaultPlan(0, "fail", times=None))})
    assert rep.recovered_with == "reference"
    assert rep.degraded and rep.retries >= 2
    assert _key(rep) == _key(jrep)
    assert _region(sched, out).tobytes() == _oracle(jsched, buf).tobytes()


def test_everything_faulted_raises_unrecoverable():
    jsched, sched = _pair("allgather", "ring")
    buf = _gbuf(sched)
    opts = dict(verify="off", max_retries=1, ladder=("sim", "reference"),
                backoff_s=1e-4)
    jw = jchaos.wrap(JSimTransport(4), jchaos.FaultPlan(0, "fail",
                                                        times=None))
    pw = chaos.wrap(SimTransport(4), FaultPlan(0, "fail", times=None))
    with pytest.raises(jres.UnrecoverableError) as ej:
        jres.ResilientExec(jsched, None,
                           options=jres.ResilienceOptions(**opts),
                           transports={"sim": jw, "reference": jw}).run(buf)
    with pytest.raises(UnrecoverableError) as ei:
        ResilientExec(sched, None, options=ResilienceOptions(**opts),
                      transports={"sim": pw, "reference": pw}).run(buf)
    rep = ei.value.report
    assert rep.recovered_with is None
    assert all(a.outcome == "fault" for a in rep.attempts)
    assert len(rep.attempts) == 4          # 2 rungs x (1 + 1 retry)
    assert _key(rep) == _key(ej.value.report)
    assert str(ei.value) == str(ej.value)


def test_refit_walks_algorithm_ladder_bitwise():
    jsched, sched = _pair("allgather", "ring")
    buf = _gbuf(sched, data="floats")
    opts = dict(verify="full", max_retries=0, ladder=("sim",),
                backoff_s=1e-4)
    (jout, jrep), (out, rep) = _both(
        jsched, sched, buf, options=opts,
        jtransports={"sim": jchaos.wrap(JSimTransport(4), jchaos.FaultPlan(
            0, "fail", times=None, match=jsched.name))},
        ptransports={"sim": chaos.wrap(SimTransport(4), FaultPlan(
            0, "fail", times=None, match=sched.name))},
        collective="allgather", algorithm="ring")
    assert rep.refit_algorithm is not None
    assert _key(rep) == _key(jrep)
    refit = REGISTRY["allgather"][rep.refit_algorithm](TOPO)
    assert _region(refit, out).tobytes() == _oracle(jsched, buf).tobytes()
    assert out.tobytes() == np.asarray(jout).tobytes()


def _seed_where(sched, xsched, pred):
    return next(s for s in range(500)
                if pred(FaultPlan(s, "corrupt", mode="bitflip").events_for(
                    xsched)[0]))


def test_canary_catches_canary_row_corruption():
    jsched, sched = _pair("allgather", "ring")
    xsched = add_canary_slot(sched)
    seed = _seed_where(sched, xsched, lambda ev: ev.slot == sched.num_slots)
    buf = _gbuf(sched, data="floats")
    opts = dict(verify="canary", ladder=("sim", "reference"), backoff_s=1e-4)
    (jout, jrep), (out, rep) = _both(
        jsched, sched, buf, options=opts,
        jtransports={"sim": jchaos.wrap(JSimTransport(4), jchaos.FaultPlan(
            seed, "corrupt", mode="bitflip"))},
        ptransports={"sim": chaos.wrap(SimTransport(4), FaultPlan(
            seed, "corrupt", mode="bitflip"))})
    assert ("canary", False) in rep.verdicts
    assert any(a.outcome == "corrupt" for a in rep.attempts)
    assert _key(rep) == _key(jrep)
    assert _region(sched, out).tobytes() == _oracle(jsched, buf).tobytes()


def test_full_verify_catches_result_region_bitflip():
    jsched, sched = _pair("allgather", "ring")
    xsched = add_canary_slot(sched)

    def in_result(ev):
        lo = sched.out_offset(ev.rank)
        return lo <= ev.slot < lo + sched.result_slots

    seed = _seed_where(sched, xsched, in_result)
    # values of magnitude >= 2: the flipped exponent bit keeps every
    # one finite, so only the reference compare can see it
    buf = (_gbuf(sched, data="floats") + 4.0).astype(np.float32)
    opts = dict(verify="full", ladder=("sim", "reference"), backoff_s=1e-4)
    (jout, jrep), (out, rep) = _both(
        jsched, sched, buf, options=opts,
        jtransports={"sim": jchaos.wrap(JSimTransport(4), jchaos.FaultPlan(
            seed, "corrupt", mode="bitflip"))},
        ptransports={"sim": chaos.wrap(SimTransport(4), FaultPlan(
            seed, "corrupt", mode="bitflip"))})
    assert ("reference", False) in rep.verdicts
    assert _key(rep) == _key(jrep)
    assert _region(sched, out).tobytes() == _oracle(jsched, buf).tobytes()


@pytest.mark.parametrize("rung", ["sim", "kernel"])
def test_hang_with_deadline_times_out_then_recovers(rung):
    jsched, sched = _pair("allgather", "ring")
    buf = _gbuf(sched)
    inner = SimTransport(4) if rung == "sim" else KernelTransport(4,
                                                                  topo=TOPO)
    opts = dict(verify="off", deadline_s=0.15, backoff_s=1e-4)
    jout, jrep = jres.ResilientExec(
        jsched, JTOPO, options=jres.ResilienceOptions(**opts,
                                                      ladder=("sim",)),
        transports={"sim": jchaos.wrap(JSimTransport(4), jchaos.FaultPlan(
            0, "hang", delay_s=0.2))}).run(buf.copy())
    out, rep = ResilientExec(
        sched, TOPO, options=ResilienceOptions(**opts, ladder=(rung,)),
        transports={rung: chaos.wrap(inner, FaultPlan(
            0, "hang", delay_s=0.2))}).run(buf.copy())
    assert rep.attempts[0].outcome == "timeout"
    assert rep.attempts[-1].outcome == "ok"
    assert _key(rep, {"kernel": "sim"}) == _key(jrep)
    assert _region(sched, out).tobytes() == _oracle(jsched, buf).tobytes()


def test_run_resilient_convenience_and_clean_path_not_degraded():
    jsched, sched = _pair("allreduce", "ring_rs_ag")
    buf = _gbuf(sched, data="floats")
    res = {"verify": "full", "ladder": ("sim", "reference")}
    jout, jrep = jres.run_resilient(jsched, buf.copy(), topo=JTOPO,
                                    resilience=res)
    out, rep = run_resilient(sched, buf.copy(), topo=TOPO, resilience=res)
    assert not rep.degraded and rep.retries == 0
    assert rep.recovered_with == "sim"
    assert _key(rep) == _key(jrep)
    assert out.tobytes() == np.asarray(jout).tobytes()


def test_default_ladder_skips_dist_without_a_group():
    """Without a process group the dist rung is skipped with a recorded
    reason, as the reference skips shardmap without devices; the clean
    kernel rung then serves.  Reports equal with rungs mapped."""
    jsched, sched = _pair("alltoall", "pairwise")
    buf = _gbuf(sched, data="floats")
    jex = jres.ResilientExec(jsched, JTOPO, options=jres.ResilienceOptions(
        verify="canary", ladder=("shardmap", "sim")))
    jout, jrep = jex.run(buf.copy())
    ex = ResilientExec(sched, TOPO, options=ResilienceOptions(
        verify="canary", ladder=("dist", "kernel")))
    out, rep = ex.run(buf.copy())
    assert rep.attempts[0].outcome == "skipped"
    assert "process group of 4 ranks" in rep.attempts[0].detail
    assert rep.recovered_with == "kernel" and not rep.degraded
    assert _key(rep, {"dist": "shardmap", "kernel": "sim"}) == _key(jrep)
    assert out.tobytes() == np.asarray(jout).tobytes()
    out, rep = ResilientExec(sched, TOPO).run(torch.from_numpy(buf.copy()))
    assert [a.rung for a in rep.attempts] == ["kernel"]


# ---------------------------------------------------------------------------
# a failure of the kernel itself is never a rung change
# ---------------------------------------------------------------------------


class _Counting:
    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def run(self, schedule, buf):
        self.calls += 1
        return self.inner.run(schedule, buf)

    def run_reference(self, schedule, buf):
        self.calls += 1
        return self.inner.run_reference(schedule, buf)


class _BrokenKernel:
    """A kernel rung whose launch fails as a CUDA kernel's does: a
    ``RuntimeError`` that is not a ``TransportError``."""

    def __init__(self):
        self.calls = 0

    def run_global(self, schedule, gbuf):
        self.calls += 1
        raise RuntimeError("schedule_exec: cudaError_t 700 from the launch")


@pytest.mark.parametrize("verify", ["off", "canary", "full"])
def test_kernel_runtime_error_propagates_without_fallback(verify):
    _, sched = _pair("allreduce", "ring_rs_ag")
    broken = _BrokenKernel()
    sim, ref = _Counting(SimTransport(4)), _Counting(SimTransport(4))
    ex = ResilientExec(sched, TOPO, options=ResilienceOptions(
        verify=verify, ladder=("kernel", "sim", "reference")),
        collective="allreduce", algorithm="ring_rs_ag",
        transports={"kernel": broken, "sim": sim, "reference": ref})
    with pytest.raises(RuntimeError, match="cudaError_t 700") as ei:
        ex.run(torch.from_numpy(_gbuf(sched, data="floats")))
    assert not isinstance(ei.value, (TransportError, UnrecoverableError))
    assert broken.calls == 1 and sim.calls == 0 and ref.calls == 0


def test_transport_error_of_the_kernel_rung_moves_the_ladder():
    """The control: the same rung failing with a ``TransportError``
    falls through to sim."""
    _, sched = _pair("allreduce", "ring_rs_ag")
    sim = _Counting(SimTransport(4))
    ex = ResilientExec(sched, TOPO, options=ResilienceOptions(
        verify="canary", max_retries=0, ladder=("kernel", "sim"),
        backoff_s=1e-4),
        transports={"kernel": chaos.wrap(KernelTransport(4, topo=TOPO),
                                         FaultPlan(0, "fail", times=None)),
                    "sim": sim})
    buf = _gbuf(sched, data="floats")
    out, rep = ex.run(buf)
    assert rep.recovered_with == "sim" and sim.calls == 1
    assert out.tobytes() == SimTransport(4).run(sched, buf).tobytes()


# ---------------------------------------------------------------------------
# tensors in, tensors out; bf16 on the host rungs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rung", ["kernel", "sim", "reference"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_buffers_on_every_rung(rung, dtype):
    """A tensor comes back a tensor of its dtype, bitwise the plain
    kernel's output; bf16 crosses to the numpy rungs as raw bits on a
    schedule that only copies, and is refused on one that adds."""
    _, sched = _pair("alltoall", "pairwise")
    g = torch.from_numpy(_gbuf(sched, data="floats")).to(dtype)
    want = KernelTransport(4, topo=TOPO).run_global(sched, g)
    out, rep = ResilientExec(sched, TOPO, options=ResilienceOptions(
        verify="full", ladder=(rung,))).run(g)
    assert out.dtype == dtype and rep.recovered_with == rung
    assert torch.equal(out.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))
    _, red = _pair("allreduce", "ring_rs_ag")
    g = torch.from_numpy(_gbuf(red)).to(dtype)
    if dtype == torch.bfloat16 and rung != "kernel":
        with pytest.raises(TypeError, match="cannot add bfloat16"):
            ResilientExec(red, TOPO, options=ResilienceOptions(
                verify="off", ladder=(rung,))).run(g)
    else:
        out, _ = ResilientExec(red, TOPO, options=ResilienceOptions(
            verify="canary", ladder=(rung,))).run(g)
        assert torch.equal(out, KernelTransport(4, topo=TOPO).run_global(
            red, g))


def test_stats_count_verification_and_calls():
    _, sched = _pair("allreduce", "ring_rs_ag")
    ex = ResilientExec(sched, TOPO, options=ResilienceOptions(
        verify="full", ladder=("kernel",)))
    ex.run(torch.from_numpy(_gbuf(sched)))
    assert ex.stats["verify_s"] > 0 and ex.stats["call_s"] > 0


# ---------------------------------------------------------------------------
# fuzzed schedules (tests/test_schedule_fuzz.py's chaos oracle)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(25))
def test_fuzzed_chaos_recovery_matches_reference(seed):
    """``check_chaos_recovery``'s draw, run through both packages: the
    same typed error, or the same report and the same bits."""
    from test_schedule_fuzz import rand_schedule, rand_topology

    rng = np.random.default_rng(seed)
    topo = rand_topology(rng)
    jsched = rand_schedule(rng, topo.nranks)
    sched = schedule_from_numpy(schedule_to_numpy(jsched))
    assert sched.fingerprint() == jsched.fingerprint()
    n = jsched.nranks
    buf = rng.integers(-8, 8, (n, jsched.num_slots, 2)).astype(np.float32)
    want = _oracle(jsched, buf)
    campaign = CAMPAIGNS[int(rng.integers(4))]
    persistent = rng.random() < 0.25
    kw = dict(times=None if persistent else int(rng.integers(1, 3)),
              max_faults=int(rng.integers(1, 3)), delay_s=0.002)
    pseed = int(rng.integers(2 ** 31))
    jplan, plan = (jchaos.FaultPlan(pseed, campaign, **kw),
                   FaultPlan(pseed, campaign, **kw))
    jtr = {"sim": jchaos.wrap(JSimTransport(n), jplan)}
    ptr = {"sim": chaos.wrap(SimTransport(n), plan)}
    if persistent and rng.random() < 0.5:
        jtr["reference"] = jchaos.wrap(JSimTransport(n), jplan)
        ptr["reference"] = chaos.wrap(SimTransport(n), plan)
    opts = dict(verify="full", max_retries=1, ladder=("sim", "reference"),
                backoff_s=1e-5)
    try:
        jout, jrep = jres.ResilientExec(
            jsched, None, options=jres.ResilienceOptions(**opts),
            transports=jtr).run(buf.copy())
    except jres.UnrecoverableError as e:
        with pytest.raises(UnrecoverableError) as ei:
            ResilientExec(sched, None, options=ResilienceOptions(**opts),
                          transports=ptr).run(buf.copy())
        assert ei.value.report.recovered_with is None
        assert _key(ei.value.report) == _key(e.report)
        return
    out, rep = ResilientExec(sched, None, options=ResilienceOptions(**opts),
                             transports=ptr).run(buf.copy())
    assert _region(sched, out).tobytes() == want.tobytes(), rep.summary()
    assert out.tobytes() == np.asarray(jout).tobytes()
    assert _key(rep) == _key(jrep), (rep.summary(), jrep.summary())


# ---------------------------------------------------------------------------
# verification pricing and BENCH_transport.json's chaos section
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coll,alg", CASES)
def test_verify_overhead_equals_reference(coll, alg):
    jsched, sched = _pair(coll, alg)
    for nbytes in (1, 4096, 1 << 20):
        for verify in ("off", "canary", "full"):
            assert tuner.verify_overhead_s(
                sched, TOPO, slot_nbytes=nbytes, verify=verify) == \
                jtuner.verify_overhead_s(jsched, JTOPO, slot_nbytes=nbytes,
                                         verify=verify)
    with pytest.raises(ValueError, match="paranoid"):
        tuner.verify_overhead_s(sched, TOPO, slot_nbytes=4096,
                                verify="paranoid")


FEAT = 4     # benchmarks/bench_transport.py's slot width


def _bench_chaos() -> dict:
    """benchmarks/bench_transport.py's ``bench_chaos``, on the port."""
    topo = flat_topology(8)
    sched = REGISTRY["allgather"]["ring"](topo)
    rng = np.random.default_rng(0)
    buf = rng.integers(-8, 8, (8, sched.num_slots, FEAT)).astype(np.float32)
    want = _region(sched, SimTransport(8).run_reference(sched, buf))
    campaigns = {}
    for campaign in CAMPAIGNS:
        ok, max_attempts, retries = True, 0, 0
        for seed in range(5):
            plan = FaultPlan(seed, campaign, delay_s=0.002)
            ex = ResilientExec(
                sched, topo,
                options=ResilienceOptions(verify="full",
                                          ladder=("sim", "reference"),
                                          backoff_s=1e-5),
                transports={"sim": chaos.wrap(SimTransport(8), plan)})
            out, rep = ex.run(buf)
            ok &= _region(sched, out).tobytes() == want.tobytes()
            max_attempts = max(max_attempts, len(rep.attempts))
            retries += rep.retries
        campaigns[campaign] = {"recovered_bitwise": bool(ok),
                               "max_attempts": max_attempts,
                               "retries": retries}
    wrapped = chaos.wrap(SimTransport(8), FaultPlan(0, "fail", times=None))
    opts = ResilienceOptions(verify="off", max_retries=1,
                             ladder=("sim", "reference"), backoff_s=1e-5)
    bound = len(opts.ladder) * (opts.max_retries + 1)
    with pytest.raises(UnrecoverableError) as ei:
        ResilientExec(sched, None, options=opts,
                      transports={"sim": wrapped,
                                  "reference": wrapped}).run(buf)
    att = len(ei.value.report.attempts)
    unrec = {"typed": True, "attempts": att, "bounded": att == bound}
    slot_nbytes = 1 << 20
    t_coll = sched.modeled_time(topo, slot_nbytes)
    price = {v: tuner.verify_overhead_s(sched, topo, slot_nbytes=slot_nbytes,
                                        verify=v)
             for v in ("off", "canary", "full")}
    pricing = {"modeled_collective_s": t_coll, "off_s": price["off"],
               "canary_s": price["canary"], "full_s": price["full"],
               "canary_frac": round(price["canary"] / t_coll, 6),
               "full_frac": round(price["full"] / t_coll, 6)}
    return {"campaigns": campaigns, "unrecoverable": unrec,
            "verify_pricing": pricing}


def test_bench_chaos_section_reproduced():
    with open(os.path.join(ROOT, "BENCH_transport.json")) as f:
        want = json.load(f)["chaos"]
    got = _bench_chaos()
    for campaign, row in want["campaigns"].items():
        row = {k: v for k, v in row.items() if k != "walltime_s"}
        assert got["campaigns"][campaign] == row, campaign
    assert [(c, r["retries"], r["max_attempts"])
            for c, r in got["campaigns"].items()] == [
        ("corrupt", 5, 2), ("fail", 5, 2), ("hang", 0, 1), ("mixed", 1, 2)]
    assert got["unrecoverable"] == want["unrecoverable"]
    assert got["unrecoverable"]["attempts"] == 4
    assert got["verify_pricing"] == want["verify_pricing"]
    assert got["verify_pricing"]["canary_frac"] == 0.07492
    assert got["verify_pricing"]["full_frac"] == 1.149841
