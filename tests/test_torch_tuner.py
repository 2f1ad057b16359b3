"""The port's empirical selector (repro_torch.core.tuner), held against
the reference's (repro.core.tuner) on the same inputs.

Model-priced tables are deterministic, so the port must reproduce the
reference's exactly: ``to_dict()`` of ``tune``/``autotune`` on three
topologies, every per-path tuner, the guideline findings (including
the violations the reference's tests inject), ``tuned_select`` on
every cell, and the heal loop (stale, drift and violated cells, the
cells re-measured, generations).  The only difference allowed is the
transport names: the reference's "shardmap" is the port's "dist", its
"pallas" the port's "kernel".  Then the cases of the reference's
``tests/test_tuner.py``, each run on both packages.
"""
import copy
import json

import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # dev extra not installed: seeded fallback
    from _hypothesis_stub import given, settings, st

from repro.core import api as japi
from repro.core import selector as jselector
from repro.core import tuner as jtuner
from repro.core import topology as jtopology

from repro_torch.core import api, executor, selector, tuner
from repro_torch.core import topology as ttopology
from repro_torch.core.algorithms import REGISTRY

SIZES = (1 << 10, 1 << 14, 1 << 18, 1 << 22)
_NAMES = {"shardmap": "dist", "pallas": "kernel"}


def _map(d):
    """The reference's table with its transport names in the port's."""
    if isinstance(d, dict):
        return {_NAMES.get(k, k): _map(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_map(x) for x in d]
    return _NAMES.get(d, d) if isinstance(d, str) else d


def _topos(mod):
    """flat 8, two pods of 4, and a 3-level hierarchy (dcn over a 2 x 2
    intra-pod torus), built by ``mod`` (either package's topology)."""
    return {
        "flat8": mod.flat_topology(8),
        "pods8x4": mod.Topology(8, 4),
        "lv3": mod.Topology.from_levels([
            mod.TopoLevel("dcn", 2, mod.DCN_LINK, dcn=True),
            mod.TopoLevel("torus_y", 2, mod.ICI_LINK),
            mod.TopoLevel("torus_x", 2, mod.ICI_LINK)]),
    }


TOPO_NAMES = ("flat8", "pods8x4", "lv3")
JT = _topos(jtopology)
TT = _topos(ttopology)
TOPO = ttopology.Topology(nranks=8, ranks_per_pod=4)
JTOPO = jtopology.Topology(nranks=8, ranks_per_pod=4)


@pytest.fixture(autouse=True)
def _isolate_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNER_CACHE", str(tmp_path / "jcache.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE",
                       str(tmp_path / "cache.json"))
    tuner.clear_cache()
    jtuner.clear_cache()
    yield
    tuner.clear_cache()
    jtuner.clear_cache()


@pytest.fixture(scope="module")
def tables():
    """autotune's model tables of both packages on every topology."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for name in TOPO_NAMES:
            j = jtuner.autotune(JT[name], path=f"{td}/j.json",
                                force_model=True)
            t = tuner.autotune(TT[name], path=f"{td}/t.json",
                               force_model=True)
            out[name] = (j, t)
    return out


@pytest.fixture(scope="module")
def model_table():
    return tuner.tune(TOPO, sizes=SIZES, force_model=True)


# ---------------------------------------------------------------------------
# model tables: exactly the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TOPO_NAMES)
def test_tune_model_table_equals_reference(name):
    j = jtuner.tune(JT[name], force_model=True)
    t = tuner.tune(TT[name], force_model=True)
    assert t.source == "model" and t.fingerprint == j.fingerprint
    assert t.to_dict() == _map(j.to_dict())


@pytest.mark.parametrize("path", ["neighbor", "partitioned", "overlap",
                                  "transport"])
@pytest.mark.parametrize("name", TOPO_NAMES)
def test_path_tuners_equal_reference(name, path):
    fn = f"tune_{path}"
    j = getattr(jtuner, fn)(JT[name], force_model=True)
    t = getattr(tuner, fn)(TT[name], force_model=True)
    assert t == _map(j)


@pytest.mark.parametrize("name", TOPO_NAMES)
def test_autotune_equals_reference_and_persists(name, tables, tmp_path):
    j, t = tables[name]
    assert t.to_dict() == _map(j.to_dict())
    assert set(t.entries) == set(tuner.COLLECTIVES) | {
        tuner.NEIGHBOR, tuner.PARTITIONED, tuner.OVERLAP, tuner.TRANSPORT}
    path = tmp_path / "t.json"
    tuner.save_table(t, path=path)
    tuner.clear_cache()
    back = tuner.load_table(t.fingerprint, path=path)
    assert back.to_dict() == t.to_dict()


@pytest.mark.parametrize("name", TOPO_NAMES)
def test_guideline_findings_equal_reference(name, tables):
    j, t = tables[name]
    jf = jtuner._guideline_findings(j, JT[name])
    tf = tuner._guideline_findings(t, TT[name])
    assert tf == [(m, tuple(c)) for m, c in jf]
    assert tuner.violation_cells(t, TT[name]) == jtuner.violation_cells(
        j, JT[name])


@pytest.mark.parametrize("name", TOPO_NAMES)
def test_tuned_select_every_cell_equals_reference(name, tables):
    j, t = tables[name]
    for coll, per in t.entries.items():
        for rec in per.values():
            for nbytes in (rec["nbytes"], rec["nbytes"] + 1, 1):
                got = tuner.tuned_select(coll, TT[name], nbytes, table=t)
                want = jtuner.tuned_select(coll, JT[name], nbytes, table=j)
                assert got == _map(want), (coll, nbytes)


@pytest.mark.parametrize("policy", ["fixed", "model", "tuned"])
@pytest.mark.parametrize("name", TOPO_NAMES)
def test_select_transport_and_overlap_equal_reference(name, policy, tables):
    j, t = tables[name]
    for nbytes in (1, 1 << 10, 3 << 14, 1 << 22, 1 << 26):
        kw = dict(policy=policy)
        assert tuner.select_transport(TT[name], nbytes, table=t, **kw) \
            == _map(jtuner.select_transport(JT[name], nbytes, table=j, **kw))
        for compute_s in (0.0, 1e-5, 1e-3):
            assert tuner.select_overlap_chunks(
                TT[name], nbytes, compute_s, table=t, **kw) == \
                jtuner.select_overlap_chunks(
                    JT[name], nbytes, compute_s, table=j, **kw)


@pytest.mark.parametrize("name", TOPO_NAMES)
def test_select_tuned_reads_persisted_table_as_reference(name, tables):
    """selector.select / select_neighbor under policy="tuned" from the
    persisted table (no table passed) choose what the reference does."""
    from repro.core.plan import CommGraph as JGraph
    from repro_torch.core.plan import CommGraph
    import numpy as np

    j, t = tables[name]
    jtuner.save_table(j)
    tuner.save_table(t)
    jtuner.clear_cache()
    tuner.clear_cache()
    for coll in tuner.COLLECTIVES:
        for nbytes in SIZES:
            assert selector.select(coll, TT[name], nbytes, policy="tuned") \
                == jselector.select(coll, JT[name], nbytes, policy="tuned")
    for seed in range(3):
        tg = CommGraph.random(8, n_local=8, degree=4,
                              rng=np.random.default_rng(seed))
        jg = JGraph.random(8, n_local=8, degree=4,
                           rng=np.random.default_rng(seed))
        assert selector.select_neighbor(tg, TT[name], policy="tuned") == \
            jselector.select_neighbor(jg, JT[name], policy="tuned")


@pytest.mark.parametrize("name", TOPO_NAMES)
def test_stale_and_drift_cells_equal_reference(name, tables):
    j, t = copy.deepcopy(tables[name][0]), copy.deepcopy(tables[name][1])
    for table in (j, t):
        for coll in tuner.COLLECTIVES:
            for rec in table.entries[coll].values():
                rec["times"].pop("staged", None)
        table.entries[tuner.NEIGHBOR]["10"]["times"].pop("standard")
    assert tuner.stale_cells(t, TT[name]) == jtuner.stale_cells(j, JT[name])

    def slow(mod, topo):
        lv = topo.levels[0]
        link = mod.LinkModel(alpha=lv.link.alpha * 2,
                             beta=lv.link.beta * 16)
        return mod.Topology.from_levels(
            [mod.TopoLevel(lv.name, lv.size, link, lv.dcn)]
            + list(topo.levels[1:]))

    j, t = tables[name]
    assert tuner.drift_cells(t, TT[name], slow(ttopology, TT[name])) == \
        jtuner.drift_cells(j, JT[name], slow(jtopology, JT[name]))


@pytest.mark.parametrize("name", TOPO_NAMES)
def test_heal_and_retune_equal_reference(name, tables, tmp_path):
    """Corrupt the same cells of both tables; heal_table re-measures the
    same cells, to the same entries, at the same generation."""
    out = []
    for mod, topo, table in ((jtuner, JT[name], tables[name][0]),
                             (tuner, TT[name], tables[name][1])):
        table = copy.deepcopy(table)
        lo = min(table.entries["allgather"], key=int)
        for coll, bucket in (("allgather", lo),
                             (tuner.NEIGHBOR, "22"),
                             (tuner.PARTITIONED, "14")):
            rec = table.entries[coll][bucket]
            rec["times"] = {k: v * 99.0 for k, v in rec["times"].items()}
            rec["best"] = max(rec["times"], key=rec["times"].get)
        cells = mod.violation_cells(table, topo)
        changed = mod.heal_table(table, topo,
                                 path=tmp_path / f"{mod.__name__}.json",
                                 force_model=True)
        again = mod.retune_cells(table, topo, cells, force_model=True)
        out.append((cells, changed, again, table.generation,
                    table.to_dict()))
    (jc, jch, ja, jg, jd), (tc, tch, ta, tg, td) = out
    assert tc == jc and tch == jch and ta == ja == []
    assert tg == jg == 1
    assert td == _map(jd)


@pytest.mark.parametrize("name", TOPO_NAMES)
def test_ensure_table_equals_reference(name, tmp_path):
    jp, tp = tmp_path / "j.json", tmp_path / "t.json"
    j = jtuner.ensure_table(JT[name], path=jp, sizes=(1024, 1 << 20),
                            force_model=True)
    t = tuner.ensure_table(TT[name], path=tp, sizes=(1024, 1 << 20),
                           force_model=True)
    assert t.to_dict() == _map(j.to_dict()) and t.generation == 0
    # a pre-staged table: both heal the same stale cells, generation 1
    for table, path, mod in ((j, jp, jtuner), (t, tp, tuner)):
        for coll in tuner.COLLECTIVES:
            for rec in table.entries[coll].values():
                rec["times"].pop("staged")
                rec["best"] = min(rec["times"], key=rec["times"].get)
        mod.save_table(table, path=path)
        mod.clear_cache()
    jh = jtuner.ensure_table(JT[name], path=jp, sizes=(1024, 1 << 20),
                             force_model=True)
    th = tuner.ensure_table(TT[name], path=tp, sizes=(1024, 1 << 20),
                            force_model=True)
    assert th.generation == jh.generation == 1
    assert th.to_dict() == _map(jh.to_dict())


def test_cache_files_are_separate(tmp_path):
    """The port never reads the reference's cache, nor the reference
    the port's; model fingerprints are the same strings."""
    assert tuner.default_cache_path() == tmp_path / "cache.json"
    assert jtuner.default_cache_path() == tmp_path / "jcache.json"
    tuner.save_table(tuner.tune(TOPO, sizes=(1024,), force_model=True))
    assert not (tmp_path / "jcache.json").exists()
    jtuner.clear_cache()
    assert jtuner.load_table(tuner.substrate_fingerprint(
        TOPO, force_model=True)) is None


def test_substrates_without_a_card_or_group():
    """On this host neither substrate can run: the tuner prices with the
    model, measuring raises, and a named substrate is checked."""
    assert tuner.measurable_substrate(TOPO) is None
    assert tuner.measurable_substrate(TOPO, "kernel") is None
    assert tuner.substrate_fingerprint(TOPO) == TOPO.fingerprint("model")
    t = tuner.tune(TOPO, sizes=(1024,), substrate="kernel")
    assert t.source == "model"
    sched = REGISTRY["allgather"]["ring"](TOPO)
    with pytest.raises(RuntimeError, match="cannot measure"):
        tuner.measure_schedule(sched, TOPO, substrate="kernel")
    for name in ("shardmap", "model"):     # the model: force_model=True
        with pytest.raises(ValueError, match="unknown substrate"):
            tuner.measurable_substrate(TOPO, name)


def test_api_transport_auto_resolves_as_reference(tables):
    """transport="auto" resolves through select_transport; without a
    group the call fails on the group, not on the name."""
    j, t = tables["pods8x4"]
    tuner.save_table(t)
    jtuner.save_table(j)
    for policy in ("fixed", "model", "tuned"):
        for nbytes in (1 << 10, 1 << 22):
            assert api._resolve_transport("auto", TT["pods8x4"], nbytes,
                                          policy) == _map(
                japi._resolve_transport("auto", JT["pods8x4"], nbytes,
                                        policy))
    assert api._resolve_transport("kernel", TOPO, 1, "tuned") == "kernel"
    with pytest.raises(ValueError, match="unknown transport"):
        api._check_call("pallas", None)
    api._check_call("auto", None)


# ---------------------------------------------------------------------------
# the reference's tests/test_tuner.py, on both packages
# ---------------------------------------------------------------------------


def test_size_bucket_boundaries():
    for n in (0, 1, 1024, 1025):
        assert tuner.size_bucket(n) == jtuner.size_bucket(n)
    assert tuner.size_bucket(1) == 0
    assert tuner.size_bucket(1024) == 10
    assert tuner.size_bucket(1025) == 11


def test_size_bucket_exact_powers_of_two():
    for b in range(1, 31):
        for n in (2 ** b - 1, 2 ** b, 2 ** b + 1):
            assert tuner.size_bucket(n) == jtuner.size_bucket(n)
        assert tuner.size_bucket(2 ** b) == b
        assert tuner.size_bucket(2 ** b + 1) == b + 1


def test_size_bucket_degenerate_and_negative():
    assert tuner.size_bucket(0) == tuner.size_bucket(1) == 0
    with pytest.raises(ValueError, match="must be >= 0 bytes, got -1"):
        tuner.size_bucket(-1)
    with pytest.raises(ValueError, match="-4096"):
        tuner.size_bucket(-4096)


@settings(max_examples=30, deadline=None)
@given(a=st.integers(1, 1 << 30), b=st.integers(1, 1 << 30))
def test_size_bucket_monotone(a, b):
    lo, hi = min(a, b), max(a, b)
    assert tuner.size_bucket(lo) <= tuner.size_bucket(hi)
    assert tuner.size_bucket(a) == jtuner.size_bucket(a)


def test_fingerprint_distinguishes_topologies():
    T = ttopology.Topology
    fps = {T(8, 4).fingerprint("cpu"), T(8, 8).fingerprint("cpu"),
           T(16, 4).fingerprint("cpu"),
           T(8, 4).fingerprint("NVIDIA H100 80GB HBM3.kernel")}
    assert len(fps) == 4
    assert T(8, 4).fingerprint("NVIDIA H100 80GB HBM3.kernel") == \
        "NVIDIA_H100_80GB_HBM3.kernel:n8:rpp4"
    assert T(8, 4).fingerprint("TPU v5e") == \
        jtopology.Topology(8, 4).fingerprint("TPU v5e")


def test_table_roundtrip(tmp_path, model_table):
    path = tmp_path / "tuned.json"
    tuner.save_table(model_table, path=path)
    tuner.clear_cache()
    loaded = tuner.load_table(model_table.fingerprint, path=path)
    assert loaded is not None and loaded.source == "model"
    assert loaded.fingerprint == model_table.fingerprint
    assert loaded.entries == model_table.entries
    assert loaded.violations == model_table.violations
    j = jtuner.tune(JTOPO, sizes=SIZES, force_model=True)
    jtuner.save_table(j, path=tmp_path / "j.json")
    assert json.loads(path.read_text()) == _map(
        json.loads((tmp_path / "j.json").read_text()))


def test_save_merges_fingerprints(tmp_path):
    path = tmp_path / "tuned.json"
    t1 = tuner.tune(TOPO, sizes=(1024,), force_model=True)
    t2 = tuner.tune(ttopology.flat_topology(16), sizes=(1024,),
                    force_model=True)
    tuner.save_table(t1, path=path)
    tuner.save_table(t2, path=path)
    tuner.clear_cache()
    assert tuner.load_table(t1.fingerprint, path=path) is not None
    assert tuner.load_table(t2.fingerprint, path=path) is not None


def test_load_missing_and_corrupt(tmp_path):
    assert tuner.load_table("cpu:n8:rpp4", path=tmp_path / "nope.json") \
        is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert tuner.load_table("cpu:n8:rpp4", path=bad) is None


def test_tuned_never_worse_than_fixed(model_table):
    for coll in tuner.COLLECTIVES:
        for nbytes in SIZES:
            fixed = selector.select(coll, TOPO, nbytes, policy="fixed")
            tuned = selector.select(coll, TOPO, nbytes, policy="tuned",
                                    tuned_table=model_table)
            assert tuned == jselector.select(
                coll, JTOPO, nbytes, policy="tuned",
                tuned_table=jtuner.tune(JTOPO, sizes=(nbytes,),
                                        force_model=True))
            t_tuned = model_table.time_of(coll, nbytes, tuned)
            t_fixed = model_table.time_of(coll, nbytes, fixed)
            assert t_fixed is not None, (coll, nbytes, fixed)
            assert t_tuned <= t_fixed, (coll, nbytes, tuned, fixed)


def test_tuned_winners_are_executable(model_table):
    for coll, per in model_table.entries.items():
        for rec in per.values():
            name = rec["best"]
            assert name == "xla" or name in REGISTRY[coll]
            if name != "xla":
                REGISTRY[coll][name](TOPO)   # builds without assertion


def test_lookup_nearest_bucket(model_table):
    per = model_table.entries["allgather"]
    assert model_table.lookup("allgather", 1) == \
        per[min(per, key=int)]["best"]
    assert model_table.lookup("allgather", 1 << 40) == \
        per[max(per, key=int)]["best"]
    assert model_table.lookup("not_a_collective", 1024) is None


@settings(max_examples=30, deadline=None)
@given(nbytes=st.integers(1, 1 << 28),
       coll=st.sampled_from(list(tuner.COLLECTIVES)))
def test_tuned_select_total(model_table, coll, nbytes):
    name = tuner.tuned_select(coll, TOPO, nbytes, table=model_table)
    assert name is not None
    assert name == "xla" or name in REGISTRY[coll]


def test_stale_table_entry_falls_back_to_model(model_table):
    stale = copy.deepcopy(model_table)
    for per in stale.entries.values():
        for rec in per.values():
            rec["best"] = "algorithm_deleted_in_v2"
    got = selector.select("allgather", TOPO, 1024, policy="tuned",
                          tuned_table=stale)
    assert got == selector.select("allgather", TOPO, 1024, policy="model")
    assert got == jselector.select("allgather", JTOPO, 1024, policy="model")


def test_tuned_without_table_matches_model():
    topo = ttopology.Topology(nranks=12, ranks_per_pod=3)   # never tuned
    jtopo = jtopology.Topology(nranks=12, ranks_per_pod=3)
    for coll in tuner.COLLECTIVES:
        got = selector.select(coll, topo, 4096, policy="tuned")
        assert got == selector.select(coll, topo, 4096, policy="model")
        assert got == jselector.select(coll, jtopo, 4096, policy="tuned")


def test_unknown_policy_rejected():
    with pytest.raises(ValueError):
        selector.select("allgather", TOPO, 1024, policy="fastest")
    with pytest.raises(ValueError):
        api.set_default_policy("fastest")


def test_api_default_policy_roundtrip():
    assert api.get_default_policy() == "model"
    try:
        api.set_default_policy("tuned")
        assert api.get_default_policy() == "tuned"
    finally:
        api.set_default_policy("model")


def _synthetic_table(mod, times):
    """One-bucket table with given {coll: {alg: t}} at bucket 10."""
    entries = {coll: {"10": {"best": min(t, key=t.get), "nbytes": 1024,
                             "times": dict(t)}}
               for coll, t in times.items()}
    return mod.TunedTable(fingerprint="test:n8:rpp4", source="model",
                          entries=entries)


_SYNTHETIC = {
    "composition": ({"allreduce": {"ring_rs_ag": 10.0},
                     "reduce_scatter": {"ring": 1.0},
                     "allgather": {"ring": 1.0}}, "allreduce>rs+ag"),
    "specialized": ({"alltoall": {"pairwise": 1.0, "hierarchical": 5.0}},
                    "hierarchical slower"),
    "consistent": ({"allreduce": {"ring_rs_ag": 1.5},
                    "reduce_scatter": {"ring": 1.0},
                    "allgather": {"ring": 1.0},
                    "alltoall": {"pairwise": 1.0, "hierarchical": 0.8}},
                   None),
}


@pytest.mark.parametrize("case", sorted(_SYNTHETIC))
def test_guideline_violations_fire_as_reference(case):
    times, needle = _SYNTHETIC[case]
    got = tuner.verify_guidelines(_synthetic_table(tuner, times), TOPO)
    want = jtuner.verify_guidelines(_synthetic_table(jtuner, times), JTOPO)
    assert got == want
    if needle is None:
        assert got == []
    else:
        assert any(needle in v for v in got), got


def test_guideline_monotonicity_violation_fires():
    out = []
    for mod in (tuner, jtuner):
        t = _synthetic_table(mod, {"allgather": {"ring": 5.0}})
        t.entries["allgather"]["14"] = {"best": "ring", "nbytes": 16384,
                                        "times": {"ring": 1.0}}
        out.append((mod.verify_guidelines(t), mod.violation_cells(t)))
    assert out[0] == out[1]
    assert any("non-monotone" in v for v in out[0][0])
    assert out[0][1] == [("allgather", "10"), ("allgather", "14")]


def test_violation_cells_name_offending_entries():
    times = _SYNTHETIC["composition"][0]
    assert set(tuner.violation_cells(_synthetic_table(tuner, times))) == {
        ("allreduce", "10"), ("reduce_scatter", "10"), ("allgather", "10")}
    assert tuner.violation_cells(_synthetic_table(
        tuner, {"allgather": {"ring": 1.0}})) == []


def _corrupt_cell(path, fp, coll, bucket, factor=99.0):
    blob = json.loads(path.read_text())
    rec = blob[fp]["entries"][coll][bucket]
    rec["times"] = {k: v * factor for k, v in rec["times"].items()}
    rec["best"] = min(rec["times"], key=rec["times"].get)
    path.write_text(json.dumps(blob))
    tuner.clear_cache()


def test_ensure_table_heals_only_violated_cells(tmp_path):
    path = tmp_path / "tuned.json"
    table = tuner.tune(TOPO, sizes=SIZES, force_model=True)
    pristine = copy.deepcopy(table.entries)
    tuner.save_table(table, path=path)
    lo = min(table.entries["allgather"], key=int)
    _corrupt_cell(path, table.fingerprint, "allgather", lo)
    loaded = tuner.load_table(table.fingerprint, path=path)
    cells = tuner.violation_cells(loaded, TOPO)
    assert ("allgather", lo) in cells

    calls = []
    real = tuner._modeled
    tuner._modeled = lambda s, t, nb: calls.append(nb) or real(s, t, nb)
    try:
        healed = tuner.ensure_table(TOPO, path=path, sizes=SIZES,
                                    force_model=True)
    finally:
        tuner._modeled = real
    expected = sum(len(tuner._candidates(coll, TOPO)) for coll, _ in cells)
    assert len(calls) == expected, (len(calls), expected, cells)
    assert healed.entries == pristine
    assert healed.generation == 1
    assert healed.violations == table.violations
    tuner.clear_cache()
    assert tuner.load_table(table.fingerprint, path=path).generation == 1


def test_ensure_table_heal_is_idempotent(tmp_path):
    path = tmp_path / "tuned.json"
    table = tuner.tune(TOPO, sizes=SIZES, force_model=True)
    tuner.save_table(table, path=path)
    for _ in range(3):
        healed = tuner.ensure_table(TOPO, path=path, sizes=SIZES,
                                    force_model=True)
        assert healed.generation == 0
        assert healed.entries == table.entries


def test_ensure_table_tunes_once_when_missing(tmp_path):
    path = tmp_path / "tuned.json"
    t1 = tuner.ensure_table(TOPO, path=path, sizes=(1024,),
                            force_model=True)
    assert t1.generation == 0 and path.exists()
    calls = []
    real = tuner._modeled
    tuner._modeled = lambda s, t, nb: calls.append(nb) or real(s, t, nb)
    try:
        tuner.clear_cache()
        t2 = tuner.ensure_table(TOPO, path=path, sizes=(1024,),
                                force_model=True)
    finally:
        tuner._modeled = real
    assert t2.entries == t1.entries
    assert calls == []


def test_retune_cells_heals_neighbor_and_partitioned(tmp_path):
    table = tuner.autotune(TOPO, path=tmp_path / "tuned.json",
                           force_model=True, sizes=(1 << 14,))
    for coll in (tuner.NEIGHBOR, tuner.PARTITIONED):
        bucket = next(iter(table.entries[coll]))
        good = copy.deepcopy(table.entries[coll][bucket])
        table.entries[coll][bucket]["times"] = {
            k: v * 97.0 for k, v in good["times"].items()}
        changed = tuner.retune_cells(table, TOPO, [(coll, bucket)],
                                     force_model=True)
        assert changed == [(coll, bucket)]
        assert table.entries[coll][bucket] == good, coll
    assert table.generation == 2


def test_heal_measures_newly_registered_algorithms(tmp_path):
    path = tmp_path / "tuned.json"
    table = tuner.tune(TOPO, sizes=(1024,), force_model=True)
    for per in table.entries.values():      # simulate a pre-staged table
        for rec in per.values():
            rec["times"].pop("staged")
            rec["best"] = min(rec["times"], key=rec["times"].get)
    assert tuner.stale_cells(table, TOPO) == [
        (coll, "10") for coll in tuner.COLLECTIVES]
    tuner.save_table(table, path=path)
    tuner.clear_cache()
    healed = tuner.ensure_table(TOPO, path=path, sizes=(1024,),
                                force_model=True)
    assert healed.generation == 1
    for coll in tuner.COLLECTIVES:
        assert "staged" in healed.entries[coll]["10"]["times"], coll
    tuner.clear_cache()
    assert tuner.load_table(table.fingerprint, path=path).generation == 1


def test_cell_differs_tolerates_measurement_noise():
    rec = {"best": "ring", "nbytes": 1024,
           "times": {"ring": 1.0, "bruck": 2.0}}
    cases = [
        ({"best": "ring", "times": {"ring": 1.05, "bruck": 1.95}}, False),
        ({"best": "ring", "times": {"ring": 1.5, "bruck": 2.0}}, True),
        ({"best": "bruck", "times": {"ring": 1.05, "bruck": 0.98}}, True),
        ({"best": "ring", "times": {"ring": 1.0, "bruck": 2.0,
                                    "staged": 3.0}}, True),
    ]
    for fresh, want in cases:
        assert tuner._cell_differs(fresh, rec, tol=1.10) is want
        assert jtuner._cell_differs(fresh, rec, tol=1.10) is want


def test_api_ensure_tuned_sets_policy_and_reuses_table(tmp_path):
    path = tmp_path / "tuned.json"
    try:
        table = api.ensure_tuned(TOPO, path=path, sizes=(1024,),
                                 force_model=True)
        assert api.get_default_policy() == "tuned"
        assert table.fingerprint == tuner.substrate_fingerprint(
            TOPO, force_model=True)
    finally:
        api.set_default_policy("model")
    t2 = api.ensure_tuned(TOPO, path=path, sizes=(1024,),
                          force_model=True, set_policy=False)
    assert api.get_default_policy() == "model"
    assert t2.entries == table.entries


def test_table_generation_roundtrips(tmp_path, model_table):
    path = tmp_path / "tuned.json"
    bumped = copy.deepcopy(model_table)
    bumped.generation = 7
    tuner.save_table(bumped, path=path)
    tuner.clear_cache()
    assert tuner.load_table(bumped.fingerprint, path=path).generation == 7
    legacy = tuner.TunedTable.from_dict(
        {"fingerprint": "cpu:n8:rpp4", "source": "model", "entries": {}})
    assert legacy.generation == 0


# ---------------------------------------------------------------------------
# cache eviction (invalidate_topology) and its thread safety
# ---------------------------------------------------------------------------


def test_invalidate_topology_evicts_kernel_tables():
    """api.invalidate_topology drops the lowered kernel executors of the
    stale geometry too (their tables would pile up on the card), and
    returns the reference's {"plans", "executors"} counts."""
    from repro_torch.core import kernel_lowering

    executor.clear_cache()
    kernel_lowering.clear_cache()
    api._SCHEDULES.clear()
    other = ttopology.flat_topology(8)
    for topo in (TOPO, other):
        sched = api._schedule("allgather", "ring", topo)
        kernel_lowering.get_kernel_exec(sched, topo=topo)
    fp = TOPO.fingerprint()
    assert any(k[3] == fp for k in kernel_lowering._CACHE)
    got = api.invalidate_topology(TOPO)
    assert set(got) == {"plans", "executors"}
    assert got == {"plans": 1, "executors": 1}
    assert not any(k[3] == fp for k in kernel_lowering._CACHE)
    assert any(k[3] == other.fingerprint() for k in kernel_lowering._CACHE)
    from repro.core import executor as jexecutor
    jexecutor.clear_cache()
    japi._SCHEDULES.clear()
    jsched = japi._schedule("allgather", "ring", JTOPO)
    assert jsched.fingerprint() == REGISTRY["allgather"]["ring"](
        TOPO).fingerprint()
    assert japi.invalidate_topology(JTOPO) == got


def test_invalidate_topology_while_another_thread_inserts():
    """executor.invalidate_topology iterates a snapshot of the keys: a
    healing daemon evicting while the serving thread inserts never
    raises "dictionary changed size during iteration".  (The thread
    switch interval is cut to a microsecond so that the insertions land
    inside the eviction's walk over a few thousand keys.)"""
    import sys
    import threading

    executor.clear_cache()
    sched = REGISTRY["alltoall"]["pairwise"](TOPO)
    executor.get_executor(sched, topo=TOPO)
    for i in range(4000):                    # other geometries' entries
        executor._CACHE[("filler", False, True, f"geometry{i}")] = None
    stop = threading.Event()
    errors = []

    def insert():
        for i in range(20000):
            if stop.is_set():
                break
            executor._CACHE[("served", False, True, f"new{i}")] = None

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    th = threading.Thread(target=insert)
    th.start()
    try:
        for i in range(300):
            try:
                executor.invalidate_topology(f"geometry{i}")
            except RuntimeError as e:
                errors.append(e)
    finally:
        stop.set()
        th.join()
        sys.setswitchinterval(interval)
    evicted = not any(k[3] == "geometry0" for k in tuple(executor._CACHE))
    executor.clear_cache()
    assert errors == [] and evicted


# ---------------------------------------------------------------------------
# the launcher's --autotune / --heal-interval
# ---------------------------------------------------------------------------


_SMOKE = ["--arch", "gemma2-2b", "--smoke", "--device", "cpu"]


@pytest.mark.parametrize("flags", [["--autotune"], ["--autotune-full"],
                                   ["--heal-interval", "1"]])
def test_launcher_tuning_without_continuous_refuses(flags):
    from repro_torch.launch import serve as tserve
    with pytest.raises(SystemExit, match="nothing to tune"):
        tserve.main(_SMOKE + flags)


def test_launcher_autotune_then_tuned_policy(tmp_path, capsys,
                                            monkeypatch):
    """--autotune tunes the engine's topology (the model on the CPU),
    persists it, and --select-policy tuned serves from it; a second run
    reuses and heals the table instead of re-tuning.  With --probe-links
    the table is keyed by the probed geometry and the engine's plans
    read that table: a second probed run reuses it too."""
    from repro_torch.core import linkprobe
    from repro_torch.launch import serve as tserve
    argv = _SMOKE + ["--continuous", "--kv-transport", "kernel",
                     "--autotune", "--select-policy", "tuned",
                     "--requests", "8"]
    read = []
    real_load = tuner.load_table

    def load(fp, *a, **kw):
        read.append(fp)
        return real_load(fp, *a, **kw)
    monkeypatch.setattr(tuner, "load_table", load)
    outs = []
    try:
        m = tserve.main(argv)
        outs.append(capsys.readouterr().out)
        for _ in range(2):
            tuner.clear_cache()
            read.clear()
            m2 = tserve.main(argv + ["--probe-links"])
            outs.append(capsys.readouterr().out)
    finally:
        api.set_default_policy("model")
    looked_up = list(read)          # the third run's lookups
    first, second, third = outs
    assert m["completed"] == m["submitted"] == 8 == m2["completed"]
    assert "autotuned model:n8:rpp4 (model)" in first
    fp = TOPO.fingerprint("model")
    table = tuner.load_table(fp)
    assert table is not None and tuner.NEIGHBOR in table.entries
    probed = linkprobe.measured_topology(TOPO).fingerprint("model")
    assert probed != fp
    assert "probed links (model)" in second
    assert f"autotuned {probed} (model)" in second
    assert f"reused {probed} (model" in third
    assert tuner.NEIGHBOR in tuner.load_table(probed).entries
    # the engine's plans looked the probed table up, never the default's
    assert probed in looked_up and fp not in looked_up


def test_launcher_heal_daemon_stops_and_reports(capsys):
    """The launcher's heartbeat (``heal_heartbeat``, run between engine
    ticks): a daemon whose probe sees a DCN beta x16 heals, the engine
    builds its next plans on the healed topology, and the heal count is
    reported; every request is still served bitwise."""
    from repro_torch.core.linkprobe import model_timer
    from repro_torch.launch import serve as tserve
    from repro_torch.runtime import LinkFault, TuningDaemon
    from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                          EngineConfig)
    from repro_torch.serve.traffic import poisson_workload, run_workload

    fault = LinkFault()
    daemon = TuningDaemon(TOPO, force_model=True, repeats=1,
                          timer=model_timer(TOPO, fault=fault))
    eng = ContinuousBatchingEngine(EngineConfig(
        device="cpu", transport="sim", policy="tuned", topo=daemon.topo))
    beat = tserve.heal_heartbeat(daemon, eng, 0.0)
    seen = []

    def on_step(step):
        if step == 3:
            fault.degrade(0, beta_scale=16.0)
        beat(step)
        seen.append(eng.topo.fingerprint())

    m = run_workload(eng, poisson_workload(0, n_requests=6), on_step=on_step)
    assert m["completed"] == m["submitted"] == 6
    healed = [r for r in daemon.reports if r.healed]
    assert len(daemon.reports) == m["steps"] and len(healed) == 1
    assert healed[0].step == 3 and healed[0].drifted_levels == (0,)
    assert eng.topo is daemon.topo
    assert seen[1] == healed[0].old_fingerprint
    assert seen[2:] == [healed[0].new_fingerprint] * (len(seen) - 2)


@pytest.mark.parametrize("transport", ["sim", "reference", "kernel"])
def test_launcher_heal_interval_needs_a_wire(transport):
    """Off a group the link probe prices with the model, which never
    drifts: the launcher refuses a daemon that could never heal."""
    from repro_torch.launch import serve as tserve
    with pytest.raises(SystemExit, match="nothing can drift"):
        tserve.main(_SMOKE + ["--continuous", "--kv-transport", transport,
                              "--heal-interval", "1"])
