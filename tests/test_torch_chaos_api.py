"""The API's recovery ladder on 8 gloo ranks, with seeded chaos
(tests/device_scripts/check_chaos_api.py's checks, on both of the
port's schedule transports and on every collective).

One ``torch.multiprocessing.spawn`` of 8 gloo ranks
(tests/torch_chaos_worker.py) installs ``FaultPlan``s through
``api.set_chaos``: a transient failure under ``resilience="off"`` is
retried and recovered bitwise with one report; the same failure
without resilience surfaces as a typed ``TransportError``; a persistent
failure walks the other transport and every refit algorithm down to the
native ``torch.distributed`` collective; a hang past a deadline is
recorded as a timeout and recovered.  A failure of the kernel itself (a
``RuntimeError``, not a ``TransportError``) leaves the ladder at once,
and the fused rmsnorm degrades to allreduce-then-rmsnorm only on a
``TransportError``.  Every rank must walk the same ladder.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.algorithms import REGISTRY as JREGISTRY
from repro.core.topology import flat_topology as jflat
from repro.core.transport import SimTransport as JSimTransport

from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.selector import _FIXED

sys.path.insert(0, os.path.dirname(__file__))
import torch_chaos_worker  # noqa: E402

N = 8
COLLS = list(torch_chaos_worker.COLLECTIVES)
TRANSPORTS = ("dist", "kernel")


@pytest.fixture(scope="module")
def run8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_chaos_api")
    rng = np.random.default_rng(0)
    inputs = {
        "x": rng.integers(-8, 8, (N, N * 2, 3)).astype(np.float32),
        "overlap": rng.standard_normal((N, N * 4, 3)).astype(np.float32),
        "rmsnorm_x": rng.standard_normal((N, 4, 16)).astype(np.float32),
        "rmsnorm_scale": (1.0 + 0.1 * rng.standard_normal(16)).astype(
            np.float32)}
    torch.multiprocessing.spawn(
        torch_chaos_worker.run,
        args=(N, f"file://{tmp}/rendezvous", inputs, str(tmp)), nprocs=N,
        join=True)
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(N)]
    return inputs, outs


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same_on_every_rank(outs, key):
    """The reports (or errors) of every rank, which must agree."""
    first = outs[0][key][1] if isinstance(outs[0][key], tuple) else None
    for o in outs[1:]:
        if first is not None:
            assert o[key][1] == first, key
    return first


def _want(coll, inputs, r):
    """The collective's meaning on rank r, from the reference package's
    oracle where a schedule defines it."""
    xs = inputs["x"]
    if coll == "allgather":
        return torch.from_numpy(xs.reshape(N * N * 2, 3))
    if coll == "alltoall":
        return torch.from_numpy(np.concatenate(
            [xs[s].reshape(N, 2, 3)[r] for s in range(N)]))
    total = torch.from_numpy(xs.astype(np.float64).sum(0).astype(
        np.float32))               # integer values: every add order agrees
    return total if coll == "allreduce" else total.reshape(N, 2, 3)[r]


@pytest.mark.parametrize("tr", TRANSPORTS)
@pytest.mark.parametrize("coll", COLLS)
def test_clean_run_is_the_collective(run8, coll, tr):
    inputs, outs = run8
    for r in range(N):
        assert torch.equal(outs[r][tr, coll, "clean"],
                           _want(coll, inputs, r))


@pytest.mark.parametrize("tr", TRANSPORTS)
@pytest.mark.parametrize("coll", COLLS)
def test_transient_fail_recovered_bitwise_with_one_report(run8, coll, tr):
    _, outs = run8
    reps = _same_on_every_rank(outs, (tr, coll, "transient"))
    assert len(reps) == 1
    attempts, recovered, refit, degraded = reps[0]
    assert degraded and refit is None and recovered == tr
    assert attempts[0][0] == tr and attempts[0][3] == "fault"
    assert attempts[-1] == (tr, attempts[0][1], 1, "ok")
    for r in range(N):
        got = outs[r][tr, coll, "transient"][0]
        assert torch.equal(_bits(got), _bits(outs[r][tr, coll, "clean"]))


@pytest.mark.parametrize("tr", TRANSPORTS)
@pytest.mark.parametrize("coll", COLLS)
def test_unarmed_fault_is_a_typed_transport_error(run8, coll, tr):
    _, outs = run8
    for r in range(N):
        assert outs[r][tr, coll, "unarmed"] == ("TransportError", [])


@pytest.mark.parametrize("tr", TRANSPORTS)
@pytest.mark.parametrize("coll", COLLS)
def test_persistent_fail_walks_to_the_native_collective(run8, coll, tr):
    """Both transports (2 attempts each), then every other algorithm of
    the selector's ladder and the registry (faulted, or skipped where a
    builder does not apply to 8 ranks), then the native collective on
    gloo: the collective's value."""
    inputs, outs = run8
    reps = _same_on_every_rank(outs, (tr, coll, "persistent"))
    assert len(reps) == 1
    attempts, recovered, refit, degraded = reps[0]
    assert (recovered, refit, degraded) == ("xla", "xla", True)
    other = [t for t in TRANSPORTS if t != tr][0]
    algo = torch_chaos_worker.COLLECTIVES[coll][1]
    assert [a[:2] for a in attempts[:4]] == [(tr, algo)] * 2 + \
        [(other, algo)] * 2
    ladder = [a for a in _FIXED[coll] if a != algo]
    ladder += [a for a in REGISTRY[coll] if a != algo and a not in ladder]
    assert [a[1] for a in attempts[4:-1]] == ladder
    assert all(a[0] == "refit" and a[3] in ("fault", "skipped")
               for a in attempts[4:-1])
    assert attempts[-1] == ("xla", "xla", 0, "ok")
    for r in range(N):
        assert torch.equal(outs[r][tr, coll, "persistent"][0],
                           _want(coll, inputs, r))


@pytest.mark.parametrize("tr", TRANSPORTS)
def test_hang_past_the_deadline_times_out_then_recovers(run8, tr):
    _, outs = run8
    reps = _same_on_every_rank(outs, (tr, "hang"))
    assert len(reps) == 1
    attempts = reps[0][0]
    assert attempts[0][3] == "timeout" and attempts[-1][3] == "ok"
    for r in range(N):
        assert torch.equal(outs[r][tr, "hang"][0],
                           outs[r][tr, "allgather", "clean"])


def test_overlap_threads_resilience(run8):
    """The pipelined alltoall with and without an armed ladder: the same
    bits on both transports, no report on a clean run."""
    _, outs = run8
    for r in range(N):
        first = outs[r]["overlap"][0]
        for got in outs[r]["overlap"][1:]:
            assert torch.equal(_bits(got), _bits(first))
        assert outs[r]["overlap_reports"] == []


def test_kernel_failure_leaves_the_api_ladder(run8):
    _, outs = run8
    for r in range(N):
        assert outs[r]["kernel_error"] == {"out": ("RuntimeError", []),
                                           "dist_calls": 0}


def test_fused_rmsnorm_degrades_only_on_a_transport_error(run8):
    _, outs = run8
    for r in range(N):
        res = outs[r]["rmsnorm"]
        got, reps = res["degraded"]
        assert reps == [([("kernel", "fused", 0, "fault")], "dist", None,
                         True)]
        assert torch.equal(got, res["dist"])
        torch.testing.assert_close(got, res["fused"], rtol=1e-5, atol=1e-5)
        assert res["unarmed"] == ("TransportError", [])


def test_reference_oracle_agrees_with_the_clean_runs(run8):
    """The clean schedule runs against the reference package's
    ``run_reference`` of the same global buffer (allgather ring)."""
    inputs, outs = run8
    sched = JREGISTRY["allgather"]["ring"](jflat(N))
    buf = np.zeros((N, N, N * 2, 3), np.float32)
    for r in range(N):
        buf[r, r] = inputs["x"][r]
    ref = JSimTransport(N).run_reference(sched, buf)
    for r in range(N):
        for tr in TRANSPORTS:
            assert outs[r][tr, "allgather", "clean"].numpy().tobytes() == \
                ref[r].reshape(-1, 3).tobytes()
