"""The PyTorch port's IR layer against the JAX reference package.

Topology and schedule fingerprints, compiled-executor statistics,
algorithm selection and the numpy schedule conversion must agree with
``repro`` exactly: they are pure functions of the same tables.  Inputs
are built by both packages' own builders from the same arguments.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import executor as jexecutor
from repro.core import selector as jselector
from repro.core.algorithms import REGISTRY as JREGISTRY
from repro.core.schedule import NotApplicable as JNotApplicable
from repro.core.topology import Topology as JTopology
from repro.core.topology import TopoLevel as JTopoLevel
from repro.core.topology import LinkModel as JLinkModel
from repro.core.topology import flat_topology as jflat
from repro.core.topology import torus_topology as jtorus

from repro_torch.convert import schedule_from_numpy, schedule_to_numpy
from repro_torch.core import executor, selector
from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.schedule import NotApplicable
from repro_torch.core.topology import (LinkModel, TopoLevel, Topology,
                                       flat_topology, torus_topology)

# (reference topology, port topology) pairs
TOPOS = {
    "flat8": (jflat(8), flat_topology(8)),
    "2pod": (JTopology(8, 4), Topology(8, 4)),
    "3lvl": (jtorus(2, 2, 2), torus_topology(2, 2, 2)),
    "3lvl16": (jtorus(2, 4, 2), torus_topology(2, 4, 2)),
}
STATS = ("rounds_before", "rounds_after_unarmed", "rounds_after",
         "migrated_edges", "armed_merged_rounds", "armed_split_edges",
         "pre_folded", "pipeline_groups", "pipeline_tail_parts")


@pytest.fixture(autouse=True)
def _fresh_caches():
    executor.clear_cache()
    jexecutor.clear_cache()
    yield
    executor.clear_cache()
    jexecutor.clear_cache()


def _pairs(jtopo, ptopo):
    """(label, reference schedule, port schedule) for every REGISTRY
    entry that applies; NotApplicable must agree across packages."""
    assert list(JREGISTRY) == list(REGISTRY)
    out = []
    for coll, algos in JREGISTRY.items():
        assert list(algos) == list(REGISTRY[coll]), coll
        for name, builder in algos.items():
            try:
                js = builder(jtopo)
            except JNotApplicable:
                with pytest.raises(NotApplicable):
                    REGISTRY[coll][name](ptopo)
                continue
            out.append((f"{coll}.{name}", js, REGISTRY[coll][name](ptopo)))
    return out


@pytest.mark.parametrize("topo_name", list(TOPOS))
def test_topology_fingerprint_equal_and_roundtrips(topo_name):
    jt, pt = TOPOS[topo_name]
    assert pt.fingerprint() == jt.fingerprint()
    assert pt.fingerprint("cpu") == jt.fingerprint("cpu")
    assert Topology.from_fingerprint(pt.fingerprint()) == pt
    assert [pt.link_level(s, d) for s in range(pt.nranks)
            for d in range(pt.nranks)] == [
        jt.link_level(s, d) for s in range(jt.nranks)
        for d in range(jt.nranks)]


def test_custom_link_model_fingerprint_lm_section():
    """A non-default link model emits the lm[...] section identically."""
    jt = JTopology.from_levels([
        JTopoLevel("dcn", 2, JLinkModel(3e-6, 1 / 7e9), dcn=True),
        JTopoLevel("torus_y", 2), JTopoLevel("torus_x", 2,
                                             JLinkModel(2e-7, 1 / 9e10))])
    pt = Topology.from_levels([
        TopoLevel("dcn", 2, LinkModel(3e-6, 1 / 7e9), dcn=True),
        TopoLevel("torus_y", 2), TopoLevel("torus_x", 2,
                                           LinkModel(2e-7, 1 / 9e10))])
    assert "lm[" in pt.fingerprint()
    assert pt.fingerprint() == jt.fingerprint()
    assert Topology.from_fingerprint(pt.fingerprint()) == pt


@pytest.mark.parametrize("topo_name", list(TOPOS))
def test_schedule_fingerprints_and_executor_stats_equal(topo_name):
    jt, pt = TOPOS[topo_name]
    pairs = _pairs(jt, pt)
    assert len(pairs) >= 15
    for label, js, ps in pairs:
        assert ps.fingerprint() == js.fingerprint(), label
        assert ps.num_rounds == js.num_rounds, label
        assert ps.message_count(pt) == js.message_count(jt), label
        assert ps.byte_count(4, pt) == js.byte_count(4, jt), label
        jex = jexecutor.get_executor(js, topo=jt)
        pex = executor.get_executor(ps, topo=pt)
        jstats, pstats = jex.stats(), pex.stats()
        for key in STATS:
            assert pstats[key] == jstats[key], (label, key)
        assert (pex.compiled_schedule.fingerprint()
                == jex.compiled_schedule.fingerprint()), label
        for slot in (1.0, 4096.0, float(1 << 20)):
            assert pex.makespan(slot) == jex.makespan(slot), label
            assert (pex.chunked_makespan(slot, 4, 1e-4)
                    == jex.chunked_makespan(slot, 4, 1e-4)), label


@pytest.mark.parametrize("topo_name", ["2pod", "3lvl", "3lvl16"])
def test_staggered_pod_allgather_corpus_foil_equal(topo_name):
    """The width-staggered corpus foil (not in REGISTRY): same
    fingerprint and the same armed-pass round cuts in both packages."""
    from repro.core.algorithms import staged as jstaged
    from repro_torch.core.algorithms import staged
    jt, pt = TOPOS[topo_name]
    js, ps = jstaged.staggered_pod_allgather(jt), \
        staged.staggered_pod_allgather(pt)
    assert ps.fingerprint() == js.fingerprint()
    jstats = jexecutor.get_executor(js, topo=jt).stats()
    pstats = executor.get_executor(ps, topo=pt).stats()
    for key in STATS:
        assert pstats[key] == jstats[key], key


def test_flat12_power_of_two_builders_not_applicable():
    """On 12 ranks the power-of-two builders raise NotApplicable in both
    packages, and the rest still agree bitwise on fingerprints."""
    jt, pt = jflat(12), flat_topology(12)
    pairs = _pairs(jt, pt)
    skipped = sum(len(a) for a in REGISTRY.values()) - len(pairs)
    assert skipped >= 3
    for label, js, ps in pairs:
        assert ps.fingerprint() == js.fingerprint(), label


@pytest.mark.parametrize("policy", ["fixed", "model"])
@pytest.mark.parametrize("topo_name", ["flat8", "2pod", "3lvl16"])
def test_selector_matches_reference_per_size_bucket(policy, topo_name):
    jt, pt = TOPOS[topo_name]
    for coll in ("allgather", "allreduce", "reduce_scatter", "alltoall"):
        for nbytes in (256, 64 * 1024, 1 << 20, 64 << 20):
            assert (selector.select(coll, pt, nbytes, policy=policy)
                    == jselector.select(coll, jt, nbytes, policy=policy)), (
                coll, nbytes)


def test_selector_tuned_and_neighbor_raise_until_ported(tmp_path,
                                                         monkeypatch):
    """The tuner is ported: "tuned" no longer raises.  With no persisted
    table it falls back to the model's choice, for the dense collectives
    and for the neighbor mode of a multi-pod topology (the tables
    themselves: tests/test_torch_tuner.py); an unknown policy still
    raises."""
    from repro_torch.core import tuner
    from repro_torch.core.plan import CommGraph
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE", str(tmp_path / "t.json"))
    tuner.clear_cache()
    assert selector.select("allreduce", flat_topology(8), 1024,
                           policy="tuned") == selector.select(
        "allreduce", flat_topology(8), 1024, policy="model")
    graph = CommGraph.random(8, n_local=4, degree=3,
                             rng=np.random.default_rng(0))
    assert selector.select_neighbor(graph, Topology(8, 4), policy="tuned") \
        == selector.select_neighbor(graph, Topology(8, 4), policy="model")
    tuner.clear_cache()
    with pytest.raises(ValueError, match="policy"):
        selector.select("allreduce", flat_topology(8), 1024, policy="nope")


def test_schedule_from_numpy_roundtrips():
    """A reference schedule crosses as plain arrays and keeps its
    fingerprint and its semantics; the port's own schedules round-trip
    too, and a mutated table changes the fingerprint."""
    jt, pt = TOPOS["2pod"]
    for label, js, ps in _pairs(jt, pt):
        d = schedule_to_numpy(js)
        conv = schedule_from_numpy(d)
        assert conv.fingerprint() == js.fingerprint(), label
        assert schedule_from_numpy(schedule_to_numpy(conv)).fingerprint() \
            == ps.fingerprint(), label
        rng = np.random.default_rng(3)
        buf = rng.standard_normal((8, conv.num_slots, 3)).astype(np.float32)
        a = executor.get_executor(conv, topo=pt).run_sim(buf)
        b = executor.get_executor(ps, topo=pt).run_sim(buf)
        assert a.tobytes() == b.tobytes(), label
    # a mutation that changes a value (not a no-op modulo num_slots)
    js = JREGISTRY["allgather"]["ring"](jt)
    d = schedule_to_numpy(js)
    g = d["rounds"][0]["gather_idx"].copy()
    row = int(np.flatnonzero((g >= 0).any(axis=1))[0])
    col = int(np.flatnonzero(g[row] >= 0)[0])
    g[row, col] = (g[row, col] + 1) % js.num_slots
    d["rounds"][0]["gather_idx"] = g
    assert schedule_from_numpy(d).fingerprint() != js.fingerprint()
    with pytest.raises(ValueError, match="lacks"):
        schedule_from_numpy({"nranks": 8, "num_slots": 8,
                             "rounds": [{"perm": [(0, 1)]}]})


def test_port_imports_no_jax_no_reference_no_ml_dtypes():
    """Importing the port and every module under it, in a fresh
    interpreter, leaves jax, the reference package and ml_dtypes out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 61, mods\n"
        "assert {'repro_torch.core.plan', 'repro_torch.core.tuner', "
        "'repro_torch.core.kvtransfer', 'repro_torch.serve.engine', "
        "'repro_torch.serve.traffic'} <= set(mods), mods\n"
        "bad = [k for k in sys.modules if k in ('jax', 'repro', 'ml_dtypes')"
        " or k.startswith(('jax.', 'repro.', 'ml_dtypes.'))]\n"
        "print('LEAKED', bad)\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "LEAKED []" in res.stdout, res.stdout
