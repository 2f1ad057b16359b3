"""The tuner on the ``dist`` substrate: 8 gloo ranks, one spawn
(tests/torch_tuner_worker.py).

  * a measured ``autotune`` at one size: ``source == "measured"``, a
    fingerprint of kind ``cpu``, and a ``to_dict()`` identical on every
    rank (each sample is agreed with ``all_reduce(MAX)``);
  * ``MeasurementTimeout`` with one rank late: raised on every rank at
    the same check point, and a collective still runs afterwards; the
    link probe's deadline likewise skips the same level on every rank
    (``ProbeTimeout`` under ``strict``), and the group survives;
  * a wire-timer probe: the same samples on every rank, fitted to a
    finite, non-negative ``LinkModel``;
  * ``algorithm="auto"`` under ``policy="tuned"`` and
    ``transport="auto"``: every rank resolves the same algorithm, and
    its output is bitwise ``run_sim`` of that schedule (the native
    collective, where the table picked it, to float tolerance);
  * the serving launcher with ``--kv-transport dist --heal-interval``:
    the daemon's heartbeat between engine ticks probes the wire on every
    rank at the same tick, so every rank reports the same passes, heals
    and final topology, and serves every request.
"""
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import executor
from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.topology import Topology

sys.path.insert(0, os.path.dirname(__file__))
import torch_tuner_worker as worker  # noqa: E402

N = 8
TOPO = Topology(N, N // 2)


@pytest.fixture(scope="module")
def run8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tuner_dist")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, N * 2, 3)).astype(np.float32)
    x.reshape(-1)[::7] = -0.0
    inputs = {"x": x}
    torch.multiprocessing.spawn(
        worker.run, args=(N, f"file://{tmp}/rendezvous", inputs, str(tmp)),
        nprocs=N, join=True)
    return inputs, [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                    for r in range(N)]


def test_measured_table_is_identical_on_every_rank(run8):
    _, outs = run8
    t = outs[0]["table"]
    assert outs[0]["substrate"] == "dist"
    assert outs[0]["fingerprint"] == TOPO.fingerprint("cpu")
    assert t["fingerprint"] == "cpu:n8:rpp4" and t["source"] == "measured"
    for o in outs[1:]:
        assert o["table"] == t
    cell = t["entries"]["allreduce"]["10"]
    assert "xla" in cell["times"]              # the native collective
    assert all(math.isfinite(v) and v > 0 for v in cell["times"].values())
    assert set(t["entries"]) >= {"neighbor_alltoallv", "partitioned",
                                 "overlap", "transport"}


def test_measurement_timeout_on_every_rank_and_the_group_survives(run8):
    _, outs = run8
    assert [o["timeout"] for o in outs] == ["warmup"] * N
    want = [float(sum(range(1, N + 1)))] * 4
    for o in outs:
        assert o["alive_after_timeout"] == want


def test_probe_timeout_skips_the_level_on_every_rank(run8):
    _, outs = run8
    for o in outs:
        assert 0 in o["probe_skipped"], o["probe_skipped"]
        assert o["probe_source"] == "wire"
        assert o["probe_strict"] == "ProbeTimeout"
        assert o["alive_after_probe"] == [float(sum(range(1, N + 1)))] * 4
        assert (o["probe_skipped"], o["probe_models"]) == (
            outs[0]["probe_skipped"], outs[0]["probe_models"])


def test_wire_probe_fits_a_finite_non_negative_model(run8):
    _, outs = run8
    o = outs[0]
    assert o["wire_source"] == "wire"
    assert o["wire_models"], o["wire_skipped"]
    for alpha, beta in o["wire_models"].values():
        assert math.isfinite(alpha) and math.isfinite(beta)
        assert alpha >= 0 and beta >= 0
    for other in outs[1:]:
        assert other["wire_samples"] == o["wire_samples"]
        assert other["wire_models"] == o["wire_models"]


def _global(coll, xs, sched):
    """The [n, slots, ...] buffer the API builds on every rank."""
    n = xs.shape[0]
    if coll == "allgather":
        g = np.zeros((n, n) + xs.shape[1:], np.float32)
        for r in range(n):
            g[r, r] = xs[r]
        return g
    if coll == "allreduce":
        flat = xs.reshape(n, -1)
        pad = (-flat.shape[1]) % n
        return np.concatenate([flat, np.zeros((n, pad), np.float32)],
                              1).reshape(n, n, -1)
    blocks = xs.reshape((n, n, -1) + xs.shape[2:])
    if sched.num_blocks > n:
        blocks = np.concatenate([blocks, np.zeros(
            (n, sched.num_blocks - n) + blocks.shape[2:], np.float32)], 1)
    return blocks


def _want(coll, xs, out_sim, r, sched):
    n = xs.shape[0]
    if coll == "allgather":
        return out_sim[r].reshape((n * xs.shape[1],) + xs.shape[2:])
    if coll == "allreduce":
        return out_sim[r].reshape(-1)[: xs[r].size].reshape(xs.shape[1:])
    if coll == "reduce_scatter":
        return out_sim[r][r]
    return out_sim[r][: sched.result_blocks].reshape(xs.shape[1:])


def _native(coll, xs, r):
    n = xs.shape[0]
    if coll == "allgather":
        return xs.reshape((-1,) + xs.shape[2:])
    if coll == "allreduce":
        return xs.sum(0)
    if coll == "reduce_scatter":
        return xs.sum(0).reshape((n, -1) + xs.shape[2:])[r]
    return np.concatenate([xs[s].reshape((n, -1) + xs.shape[2:])[r]
                           for s in range(n)])


@pytest.mark.parametrize("coll", worker.COLLECTIVES)
def test_tuned_auto_collectives_bitwise_run_sim(run8, coll):
    inputs, outs = run8
    xs = inputs["x"]
    algo, transport = outs[0][coll][:2]
    assert transport in ("dist", "kernel")
    for o in outs:
        assert o[coll][:2] == (algo, transport)     # one choice everywhere
    if algo == "xla":
        for r, o in enumerate(outs):
            np.testing.assert_allclose(o[coll][2].numpy(),
                                       _native(coll, xs, r), rtol=1e-6,
                                       atol=1e-6)
        return
    sched = REGISTRY[coll][algo](TOPO)
    out_sim = executor.get_executor(sched, topo=TOPO).run_sim(
        _global(coll, xs, sched))
    for r, o in enumerate(outs):
        got = o[coll][2].numpy()
        want = np.ascontiguousarray(_want(coll, xs, out_sim, r, sched))
        assert got.shape == want.shape
        assert got.view(np.int32).tobytes() == want.view(
            np.int32).tobytes(), (coll, algo, r)


def test_launcher_heal_heartbeat_agrees_on_every_rank(run8):
    _, outs = run8
    first = outs[0]["launcher"]
    assert first["completed"] == first["submitted"] == 4
    # at least one pass between ticks; the engine's plans end on a
    # wire-probed geometry (fitted link models in its fingerprint)
    (line,) = first["daemon"]
    passes = int(line.split("tuner daemon: ")[1].split()[0])
    assert passes >= 1 and ":n8:rpp4:" in line and ":lm[" in line, line
    for o in outs[1:]:
        assert o["launcher"]["completed"] == 4
        assert o["launcher"]["daemon"] == first["daemon"]
