"""The port's neighbor collectives, partitioned alltoall and KV transfers
over a process group, held against the reference.

One ``torch.multiprocessing.spawn`` of 8 gloo ranks (``file://``
rendezvous in ``tmp_path``) runs tests/torch_neighbor_worker.py:
``mpix_neighbor_alltoallv`` in both plan modes over the ``dist`` and
``kernel`` transports (the locality-aware plans carry the fused
``(r, r)`` self-copy rounds), ``mpix_alltoall_overlap`` at chunks 1, 2
and 4 and at the model's pick, and the KV path on the ``dist``
transport.  Each result must be bitwise equal to the reference's numpy
executor on the same inputs (``run_sim``, ``SimTransport.run_chunked``
with the same ``consume``, the gather oracle, the reference engine).
``select_overlap_chunks`` is compared directly.
"""
import os
import sys

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import kvtransfer as jkv
from repro.core import plan as jplan
from repro.core import selector as jselector
from repro.core import tuner as jtuner
from repro.core.algorithms import REGISTRY as JREGISTRY
from repro.core.topology import Topology as JTopology
from repro.core.topology import flat_topology as jflat
from repro.core.topology import torus_topology as jtorus
from repro.core.transport import SimTransport as JSimTransport
from repro.serve.engine import ContinuousBatchingEngine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.traffic import poisson_workload as jworkload
from repro.serve.traffic import run_workload as jrun_workload

from repro_torch.core import api, kvtransfer
from repro_torch.core import plan as tplan
from repro_torch.core import tuner as ttuner
from repro_torch.core.topology import Topology, flat_topology, torus_topology

sys.path.insert(0, os.path.dirname(__file__))
import torch_neighbor_worker as worker  # noqa: E402

N = 8
JTOPOS = {"flat8": jflat(8), "2pod": JTopology(8, 4), "4pod": JTopology(8, 2)}
ROWS, FEAT = 4, 3               # overlap: rows per block, row width


def _bf16(x):
    return x.astype(ml_dtypes.bfloat16)


def _with_neg_zeros(x):
    x.reshape(-1)[::5] = -0.0
    return x


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.ascontiguousarray(x)
    return x.view(np.uint16 if x.dtype == ml_dtypes.bfloat16 else np.uint32)


def _graph_seed(topo_name, agg):
    return 11 * list(JTOPOS).index(topo_name) + int(agg)


@pytest.fixture(scope="module")
def run8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_neighbor")
    rng = np.random.default_rng(11)
    graphs = {}
    for topo_name in JTOPOS:
        for agg in (False, True):
            graphs[(topo_name, agg)] = tplan.CommGraph.random(
                N, n_local=10, degree=5,
                rng=np.random.default_rng(_graph_seed(topo_name, agg)),
                dup_frac=0.7)
    vals = _with_neg_zeros(rng.standard_normal((N, 10, 3)).astype(
        np.float32))
    ovl = _with_neg_zeros(rng.standard_normal((N, N * ROWS, FEAT)).astype(
        np.float32))
    kv_pool = _with_neg_zeros(rng.standard_normal((N, 12, 2, 3)).astype(
        np.float32))
    kv_moves = [kvtransfer.BlockMove(s, r, 4 + (s + r) % 4, r)
                for s in range(4) for r in range(0, 12, 2)]
    kv_moves += [kvtransfer.BlockMove(0, 1, d, 11) for d in range(4, 8)]
    inputs = {
        "graphs": graphs,
        "values": {"float32": vals,
                   "bfloat16": _bf16(vals).view(np.uint16)},
        "overlap": {"float32": ovl, "bfloat16": _bf16(ovl).view(np.uint16)},
        "kv_pool": kv_pool, "kv_moves": kv_moves,
    }
    torch.multiprocessing.spawn(
        worker.run, args=(N, f"file://{tmp}/rendezvous", inputs, str(tmp)),
        nprocs=N, join=True)
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(N)]
    return inputs, outs


def _np_values(inputs, key, dtype):
    a = inputs[key][dtype]
    return a.view(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


@pytest.mark.parametrize("agg", [False, True])
@pytest.mark.parametrize("topo_name", list(JTOPOS))
def test_neighbor_alltoallv_bitwise_vs_reference(run8, topo_name, agg):
    inputs, outs = run8
    jg = jplan.CommGraph.random(
        N, n_local=10, degree=5,
        rng=np.random.default_rng(_graph_seed(topo_name, agg)),
        dup_frac=0.7)
    jp = jplan.build_plan(jg, JTOPOS[topo_name], aggregate=agg)
    for r in range(N):
        assert outs[r][("plan", topo_name, agg)] == jp.schedule.fingerprint()
    if agg and topo_name != "flat8":
        # the fused self-copy round of the locality-aware plans
        assert any(s == d for rnd in jp.rounds for s, d in rnd.perm)
    for dtype in ("float32", "bfloat16"):
        vals = _np_values(inputs, "values", dtype)
        want = jplan.run_sim(jp, [vals[r] for r in range(N)])
        for tr in ("dist", "kernel"):
            for r in range(N):
                got = outs[r][("neighbor", topo_name, agg, dtype, tr)]
                k = jp.recv_sizes[r]
                assert got.shape == (max(jp.recv_sizes), 3)
                np.testing.assert_array_equal(
                    _bits(got[:k]), _bits(want[r]),
                    err_msg=f"{topo_name} agg={agg} {dtype} {tr} rank {r}")
                assert not _bits(got[k:]).any()      # +0.0 past recv size


def _overlap_reference(topo_name, dtype, xs, chunks, algo):
    """Per-rank lists of chunk outputs: the reference schedule run by
    ``SimTransport.run_chunked`` with the same list-append consume."""
    jt = JTOPOS[topo_name]
    if algo == "auto":
        algo = jselector.select("alltoall", jt, xs[0].size * xs.itemsize,
                                policy="model")
    sched = JREGISTRY["alltoall"][algo](jt)
    blocks = xs.reshape(N, N, ROWS, FEAT)
    pad = np.zeros((N, sched.num_slots - N, ROWS, FEAT), xs.dtype)
    buf = np.concatenate([blocks, pad], axis=1)
    rc = ROWS // chunks
    pieces = JSimTransport(N).run_chunked(
        sched, buf, chunks=chunks, init=[],
        consume=lambda c, o, i: c + [o])
    return [[p[r, : sched.result_slots].reshape(N * rc, FEAT)
             for p in pieces] for r in range(N)]


@pytest.mark.parametrize("topo_name", list(JTOPOS))
def test_alltoall_overlap_carry_bitwise_vs_reference(run8, topo_name):
    inputs, outs = run8
    algo = worker.OVERLAP_ALGOS[topo_name]
    for dtype in ("float32", "bfloat16"):
        xs = _np_values(inputs, "overlap", dtype)
        for chunks in worker.OVERLAP_CHUNKS:
            want = _overlap_reference(topo_name, dtype, xs, chunks, algo)
            for tr in ("dist", "kernel"):
                for r in range(N):
                    got = outs[r][("overlap", topo_name, dtype, tr, chunks)]
                    assert len(got) == chunks
                    for i in range(chunks):
                        np.testing.assert_array_equal(
                            _bits(got[i]), _bits(want[r][i]),
                            err_msg=f"{dtype} {tr} chunks={chunks} "
                                    f"rank {r} piece {i}")
    # a numeric fold: the same consume on the reference's pieces
    xs = inputs["overlap"]["float32"]
    want = _overlap_reference(topo_name, "float32", xs, 4, algo)
    for r in range(N):
        carry = np.zeros((N * ROWS // 4, FEAT), np.float32)
        for i, o in enumerate(want[r]):
            carry = carry * np.float32(0.5) + o * np.float32(i + 1)
        np.testing.assert_array_equal(
            _bits(outs[r][("overlap_fold", topo_name)]), _bits(carry))
    # chunks=0: the model's count, clamped to a divisor of the rows
    jt = JTOPOS[topo_name]
    k = jtuner.select_overlap_chunks(jt, xs[0].size * 4, 1e-2,
                                     policy="model")
    while ROWS % k:
        k -= 1
    want = _overlap_reference(topo_name, "float32", xs, k, algo)
    for r in range(N):
        got = outs[r][("overlap_auto", topo_name)]
        assert len(got) == k
        for i in range(k):
            np.testing.assert_array_equal(_bits(got[i]), _bits(want[r][i]))


def test_alltoall_overlap_native_chunks(run8):
    inputs, outs = run8
    xs = inputs["overlap"]["float32"].reshape(N, N, ROWS, FEAT)
    for r in range(N):
        got = outs[r]["overlap_xla"]
        for i in range(2):
            want = xs[:, r, 2 * i: 2 * i + 2].reshape(-1, FEAT)
            np.testing.assert_array_equal(_bits(got[i]), _bits(want))


def test_kv_transfer_over_the_group(run8):
    """One move batch (a shared prefix fanned to every decode rank
    among them) over ``dist`` in both plan modes: bitwise against the
    reference's gather oracle on every rank."""
    inputs, outs = run8
    pool = inputs["kv_pool"]
    jmoves = [jkv.BlockMove(m.src, m.src_row, m.dst, m.dst_row)
              for m in inputs["kv_moves"]]
    want = jkv.gather_oracle(jmoves, pool)
    for agg in (False, True):
        for r in range(N):
            ok, updates = outs[r][("kv", agg)]
            assert ok, (agg, r)
            assert sorted(updates) == sorted(want)
            for d, (rows, vals) in want.items():
                got_rows, got_vals = updates[d]
                assert np.array_equal(got_rows, rows)
                assert got_vals.numpy().tobytes() == vals.tobytes()


def test_engine_over_the_group_matches_reference(run8):
    """The continuous-batching engine with ``transport="dist"`` on 8
    ranks: the same transfer log, metrics and final pool as the
    reference engine on its numpy transport."""
    _, outs = run8
    jeng = JEngine(JEngineConfig(blocks_per_rank=16, block_tokens=4,
                                 block_feat=8))
    jm = jrun_workload(jeng, jworkload(2, arrival_rate=8.0, tenants=2,
                                       n_requests=12, mean_prompt=10,
                                       mean_gen=4, max_prompt=24))
    for r in range(N):
        metrics, log, kv = outs[r]["engine"]
        assert _no_wall(metrics) == _no_wall(jm)
        assert len(log) == len(jeng.transfer_log)
        for got, want in zip(log, jeng.transfer_log):
            for key in ("step", "requests", "blocks", "bytes", "plan",
                        "modeled_s", "dcn_bytes", "ici_bytes"):
                assert got[key] == want[key], key
            assert [tuple(vars(m).values()) for m in got["moves"]] == \
                [tuple(vars(m).values()) for m in want["moves"]]
        assert kv.numpy().tobytes() == jeng.kv.tobytes()


def _no_wall(metrics: dict) -> dict:
    """Engine metrics without the wall-clock fields."""
    return {k: _no_wall(v) if isinstance(v, dict) else v
            for k, v in metrics.items()
            if k not in ("tokens_per_s", "wall_s")}


SIZES = [1 << k for k in range(10, 29, 2)]         # 1 KiB .. 256 MiB
TOPO_PAIRS = [(jflat(8), flat_topology(8)), (JTopology(8, 4), Topology(8, 4)),
              (jtorus(2, 4, 2), torus_topology(2, 4, 2))]


@pytest.mark.parametrize("policy", ["fixed", "model"])
@pytest.mark.parametrize("pair", range(len(TOPO_PAIRS)))
def test_select_overlap_chunks_matches_reference(pair, policy):
    jt, tt = TOPO_PAIRS[pair]
    for nbytes in SIZES:
        for compute_s in (0.0, 1e-4, 1e-2):
            assert ttuner.select_overlap_chunks(
                tt, nbytes, compute_s, policy=policy) == \
                jtuner.select_overlap_chunks(
                    jt, nbytes, compute_s, policy=policy), \
                (nbytes, compute_s)


def test_neighbor_options_raise_before_any_group_use():
    assert not torch.distributed.is_initialized()
    graph = tplan.CommGraph.random(8, n_local=4, degree=2,
                                   rng=np.random.default_rng(0))
    plan = api.make_neighbor_plan(graph, Topology(8, 4))
    x = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="unknown transport"):
        api.mpix_neighbor_alltoallv(x, None, plan, transport="pallas")
    with pytest.raises(ValueError, match="resilience preset"):
        api.mpix_neighbor_alltoallv(x, None, plan, resilience="sideways")
    # transport="auto" and the tuned chunk count are ported: the first
    # reaches the missing group, the second falls back to the model
    # without a table
    with pytest.raises(ValueError, match="process group"):
        api.mpix_alltoall_overlap(x, None, lambda c, o, i: c, None,
                                  transport="auto")
    ttuner.clear_cache()
    assert ttuner.select_overlap_chunks(
        Topology(8, 4), 1024, 0.0, policy="tuned",
        path="/nonexistent/tuned.json") == ttuner.select_overlap_chunks(
            Topology(8, 4), 1024, 0.0, policy="model")
    ttuner.clear_cache()
