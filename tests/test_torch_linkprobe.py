"""The port's link probes (repro_torch.core.linkprobe), held against the
reference's (repro.core.linkprobe): the cases of the reference's
``tests/test_linkprobe.py``, each run on both packages on the same
inputs.  Probe schedules must have equal fingerprints, model probes
must recover the same ``LinkModel`` floats, and measured fingerprints
and drifted levels must be equal.  (The wire timer runs on a group:
``tests/test_torch_tuner_dist.py``.)
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # dev extra not installed: seeded fallback
    from _hypothesis_stub import given, settings, st

from repro.core import linkprobe as jlp
from repro.core import topology as jtopo
from repro.runtime.fault import LinkFault as JLinkFault

from repro_torch.core import linkprobe as lp
from repro_torch.core import topology as ttopo
from repro_torch.core.linkprobe import (
    DEFAULT_PROBE_SIZES, drifted_levels, fit_link_model,
    injection_schedule, measured_topology, model_timer, pingpong_schedule,
    probe_links)
from repro_torch.core.topology import (DCN_LINK, ICI_LINK, LinkModel,
                                       TopoLevel, Topology, torus_topology)
from repro_torch.core.transport import SimTransport
from repro_torch.runtime.fault import LinkFault


def _two_pod(mod):
    return mod.Topology.from_levels([
        mod.TopoLevel("dcn", 2, mod.DCN_LINK, dcn=True),
        mod.TopoLevel("ici", 4, mod.ICI_LINK)])


TOPO, JTOPO = _two_pod(ttopo), _two_pod(jtopo)


def _links(res):
    return {i: (m.alpha, m.beta) for i, m in res.models.items()}


# ---------------------------------------------------------------------------
# LinkModel validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha,beta", [
    (float("nan"), 1e-10), (1e-6, float("nan")),
    (float("inf"), 1e-10), (1e-6, float("inf")),
    (-1e-6, 1e-10), (1e-6, -1e-10),
    ("1e-6", 1e-10), (1e-6, None), (True, 1e-10),
])
def test_link_model_rejects_bad_coefficients(alpha, beta):
    for mod in (ttopo, jtopo):
        with pytest.raises(ValueError):
            mod.LinkModel(alpha=alpha, beta=beta)


def test_link_model_coerces_to_float():
    lm = LinkModel(alpha=1, beta=0)
    assert isinstance(lm.alpha, float) and isinstance(lm.beta, float)
    assert lm.time(1024.0) == 1.0 == jtopo.LinkModel(alpha=1, beta=0).time(
        1024.0)


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------


def test_fit_recovers_exact_model():
    link = LinkModel(alpha=7e-6, beta=3e-11)
    samples = [(float(s), link.time(float(s)))
               for s in (1 << 10, 1 << 16, 1 << 20)]
    fit = fit_link_model(samples)
    want = jlp.fit_link_model(samples)
    assert (fit.alpha, fit.beta) == (want.alpha, want.beta)
    assert math.isclose(fit.alpha, link.alpha, rel_tol=1e-9)
    assert math.isclose(fit.beta, link.beta, rel_tol=1e-9)


@pytest.mark.parametrize("samples,msg", [
    ([(1024.0, 1e-5)], ">= 2 probe samples"),
    ([(1024.0, 1e-5), (1024.0, 2e-5)], "distinct values"),
    ([(1024.0, float("nan")), (2048.0, 1e-5)], "non-finite probe"),
    ([(float("inf"), 1e-5), (2048.0, 1e-5)], "non-finite probe"),
    ([(1024.0, 1e-3), (1 << 20, 1e-5)], "negative fit"),
    ([(100.0, 1.0), (200.0, 3.0)], "negative fit"),
])
def test_fit_rejects_degenerate_data(samples, msg):
    for fit in (fit_link_model, jlp.fit_link_model):
        with pytest.raises(ValueError, match=msg):
            fit(samples)


# ---------------------------------------------------------------------------
# probe schedules are legal IR, equal to the reference's
# ---------------------------------------------------------------------------


def test_pingpong_schedule_shape_and_semantics():
    sched = pingpong_schedule(TOPO, 0)
    assert sched.num_slots == 1 and len(sched.rounds) == 2
    for level in (0, 1):
        assert pingpong_schedule(TOPO, level).fingerprint() == \
            jlp.pingpong_schedule(JTOPO, level).fingerprint()
    buf = np.arange(8, dtype=np.float32).reshape(8, 1, 1)
    out = SimTransport(8).run(sched, buf)
    assert out[0, 0, 0] == buf[0, 0, 0]


def test_pingpong_rejects_unprobeable_levels():
    with pytest.raises(ValueError, match="out of range"):
        pingpong_schedule(TOPO, 5)
    one = Topology.from_levels([TopoLevel("solo", 1, ICI_LINK),
                                TopoLevel("ici", 4, ICI_LINK)])
    with pytest.raises(ValueError, match="nothing to probe"):
        pingpong_schedule(one, 0)


def test_injection_schedule_serializes_distinct_peers():
    sched = injection_schedule(TOPO, 1, fanout=4)
    assert len(sched.rounds) == 3        # clamped to level size - 1
    for level, fanout in ((0, 1), (1, 2), (1, 4)):
        assert injection_schedule(TOPO, level, fanout).fingerprint() == \
            jlp.injection_schedule(JTOPO, level, fanout).fingerprint()
    dsts = [d for r in sched.rounds for _, d in r.perm]
    assert len(set(dsts)) == len(dsts)
    for d in dsts:
        c = TOPO.coords(d)
        assert c[0] == 0 and c[1] != 0


# ---------------------------------------------------------------------------
# the probe pass + measured fingerprints
# ---------------------------------------------------------------------------


def test_model_probe_recovers_link_models_exactly():
    res = probe_links(TOPO, timer=model_timer(TOPO))
    want = jlp.probe_links(JTOPO, timer=jlp.model_timer(JTOPO))
    assert res.source == "custom" and not res.skipped
    assert _links(res) == _links(want)
    assert res.samples == want.samples
    for i, lv in enumerate(TOPO.levels):
        assert math.isclose(res.models[i].alpha, lv.link.alpha,
                            rel_tol=1e-6)
        assert math.isclose(res.models[i].beta, lv.link.beta,
                            rel_tol=1e-6)


def test_default_probe_without_a_group_prices_with_the_model():
    """No group of topo.nranks ranks: no wire, the model timer, and the
    result says so (the reference's host-device fallback)."""
    assert not lp.wire_available(TOPO)
    res = probe_links(TOPO)
    assert res.source == "model"
    assert _links(res) == _links(
        jlp.probe_links(JTOPO, timer=jlp.model_timer(JTOPO)))


def test_measured_topology_keys_by_lm_section():
    meas = measured_topology(TOPO, timer=model_timer(TOPO))
    fp = meas.fingerprint()
    assert ":lm[" in fp
    assert fp == jlp.measured_topology(
        JTOPO, timer=jlp.model_timer(JTOPO)).fingerprint()
    assert Topology.from_fingerprint(fp) == meas
    assert [(l.name, l.size, l.dcn) for l in meas.levels] == \
           [(l.name, l.size, l.dcn) for l in TOPO.levels]
    assert meas.fingerprint() != TOPO.fingerprint()


def test_size1_levels_are_skipped_not_fatal():
    t = Topology.from_levels([TopoLevel("solo", 1, DCN_LINK, dcn=True),
                              TopoLevel("ici", 4, ICI_LINK)])
    res = probe_links(t, timer=model_timer(t))
    assert 0 in res.skipped and 0 not in res.models
    assert measured_topology(t, res).levels[0].link == DCN_LINK


def test_rejected_fit_skips_level_unless_strict():
    def broken(level, nbytes):
        return float("nan") if level == 0 else \
            model_timer(TOPO)(level, nbytes)

    res = probe_links(TOPO, timer=broken)
    assert 0 in res.skipped and 1 in res.models
    with pytest.raises(ValueError, match="non-finite"):
        probe_links(TOPO, timer=broken, strict=True)


def test_hung_host_timer_is_a_recorded_skip():
    """A host timer that never returns in time: the thread form of the
    deadline records the level as skipped (strict: ProbeTimeout)."""
    import time

    def slow(level, nbytes):
        if level == 0:
            time.sleep(0.5)
        return model_timer(TOPO)(level, nbytes)

    res = probe_links(TOPO, timer=slow, deadline_s=0.05)
    assert 0 in res.skipped and "deadline" in res.skipped[0]
    assert 1 in res.models
    with pytest.raises(lp.ProbeTimeout):
        probe_links(TOPO, timer=slow, deadline_s=0.05, strict=True)
    with pytest.raises(ValueError, match="deadline_s"):
        probe_links(TOPO, timer=slow, deadline_s=0.0)


def test_probe_needs_two_distinct_sizes():
    with pytest.raises(ValueError, match="distinct probe sizes"):
        probe_links(TOPO, sizes=(1024, 1024), timer=model_timer(TOPO))


def test_fault_injection_is_observed_per_level():
    fault, jfault = LinkFault(), JLinkFault()
    for f in (fault, jfault):
        f.degrade(0, beta_scale=16.0)
    res = probe_links(TOPO, timer=model_timer(TOPO, fault=fault))
    want = jlp.probe_links(JTOPO, timer=jlp.model_timer(JTOPO, fault=jfault))
    assert _links(res) == _links(want)
    assert math.isclose(res.models[0].beta, DCN_LINK.beta * 16.0,
                        rel_tol=1e-6)
    assert math.isclose(res.models[0].alpha, DCN_LINK.alpha, rel_tol=1e-6)
    assert math.isclose(res.models[1].beta, ICI_LINK.beta, rel_tol=1e-6)


# ---------------------------------------------------------------------------
# drift detection
# ---------------------------------------------------------------------------


def test_drifted_levels_ratio_rule():
    def meas(mod, lpm, topo, **scales):
        f = (LinkFault if mod is lp else JLinkFault)()
        for level, kw in scales.items():
            f.degrade(int(level[1:]), **kw)
        return lpm.measured_topology(topo, timer=lpm.model_timer(
            topo, fault=f))

    cases = [{}, {"l0": dict(beta_scale=1.1)},
             {"l0": dict(beta_scale=16.0)}, {"l1": dict(alpha_scale=3.0)}]
    base = meas(lp, lp, TOPO)
    jbase = meas(jlp, jlp, JTOPO)
    got = []
    for sc in cases:
        t, j = meas(lp, lp, TOPO, **sc), meas(jlp, jlp, JTOPO, **sc)
        assert t.fingerprint() == j.fingerprint()
        for a, b, ja, jb in ((base, t, jbase, j), (t, base, j, jbase)):
            d = drifted_levels(a, b, tol=1.25)
            assert d == jlp.drifted_levels(ja, jb, tol=1.25)
            got.append(d)
    assert got == [[], [], [], [], [0], [0], [1], [1]]


def test_drift_refuses_geometry_changes():
    with pytest.raises(ValueError, match="elastic remesh"):
        drifted_levels(TOPO, torus_topology(2, 2, 2))


_ALPHAS = (1e-6, 2.5e-6, 1e-5, 3.3e-5)
_BETAS = (1 / 25e9, 1 / 50e9, 1 / 12.5e9, 7.7e-11)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31))
def test_measured_fingerprint_roundtrip_random_levels(seed):
    """Random level stacks, probed through a model timer on both
    packages: equal measured fingerprints that round-trip under every
    device-kind sanitization."""
    def stack(mod):
        rng = np.random.default_rng(seed)
        lvls = []
        for i in range(int(rng.integers(1, 5))):
            link = mod.LinkModel(alpha=float(_ALPHAS[rng.integers(4)]),
                                 beta=float(_BETAS[rng.integers(4)]))
            lvls.append(mod.TopoLevel(f"ax{i}", int(rng.integers(1, 5)),
                                      link, dcn=bool(rng.integers(0, 2))))
        return mod.Topology.from_levels(sorted(lvls, key=lambda l: not l.dcn))

    topo, jt = stack(ttopo), stack(jtopo)
    meas = measured_topology(topo, timer=model_timer(topo))
    jmeas = jlp.measured_topology(jt, timer=jlp.model_timer(jt))
    for kind in ("model", "cpu", "TPU v5e", "NVIDIA H100 80GB HBM3.kernel"):
        fp = meas.fingerprint(kind)
        assert fp == jmeas.fingerprint(kind)
        back = Topology.from_fingerprint(fp)
        assert back == meas and back.fingerprint(kind) == fp
        assert " " not in fp
    for i, lv in enumerate(topo.levels):
        if lv.size >= 2:
            got = meas.levels[i].link
            assert math.isclose(got.alpha, lv.link.alpha, rel_tol=1e-6)
            assert math.isclose(got.beta, lv.link.beta, rel_tol=1e-6)


def test_default_probe_sizes_span_alpha_and_beta():
    assert DEFAULT_PROBE_SIZES == jlp.DEFAULT_PROBE_SIZES
    lo, hi = min(DEFAULT_PROBE_SIZES), max(DEFAULT_PROBE_SIZES)
    assert ICI_LINK.alpha > ICI_LINK.beta * lo    # small: alpha-dominated
    assert DCN_LINK.beta * hi > DCN_LINK.alpha    # large: beta-dominated
