"""The port's continuous-batching engine and KV transfer plans, held
against the reference (tests/test_serve_engine.py's cases), with the
recovery ladder on the KV path (``serve.chaos_under_load``).

The pools are tensors on the CPU here; the ``kernel`` transport runs the
transport kernel's plain version.  Every transfer batch is verified by
the engine bitwise (raw bits) against the gather oracle, and the
``serve`` section of ``BENCH_transport.json`` is reproduced by the port
engine and by the reference engine run in-process on the same trace.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import kvtransfer as jkv
from repro.core.topology import Topology as JTopology
from repro.serve.engine import ContinuousBatchingEngine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.traffic import poisson_workload as jworkload
from repro.serve.traffic import run_workload as jrun_workload

from repro_torch.core import kvtransfer
from repro_torch.core.topology import Topology
from repro_torch.serve.engine import (BlockPool, ContinuousBatchingEngine,
                                      DoubleFreeError, EngineConfig,
                                      EngineStall, Request,
                                      TransferVerificationError)
from repro_torch.serve.traffic import poisson_workload, run_workload

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SMALL = dict(prefill_ranks=2, decode_ranks=2, ranks_per_pod=2,
             blocks_per_rank=16, block_tokens=4, block_feat=8)
CPU = dict(device="cpu", transport="sim")
# the serve benchmark's trace (benchmarks/bench_serve.py)
TRACE = dict(arrival_rate=6.0, tenants=3, n_requests=40, mean_prompt=24,
             mean_gen=8)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def _no_wall(metrics: dict) -> dict:
    """Engine metrics without the wall-clock fields."""
    return {k: _no_wall(v) if isinstance(v, dict) else v
            for k, v in metrics.items()
            if k not in ("tokens_per_s", "wall_s")}


# ---------------------------------------------------------------------------
# block pool
# ---------------------------------------------------------------------------


class TestBlockPool:
    def test_alloc_free_roundtrip(self):
        p = BlockPool(8)
        a = p.alloc(3)
        b = p.alloc(5)
        assert sorted(a + b) == list(range(8))
        assert p.available == 0 and p.in_use == 8
        p.free(a)
        p.free(b)
        assert p.available == 8 and p.in_use == 0

    def test_exhaustion_returns_none(self):
        p = BlockPool(4)
        assert p.alloc(5) is None
        a = p.alloc(3)
        assert a is not None and p.alloc(2) is None
        assert p.available == 1

    def test_double_free_raises(self):
        p = BlockPool(4)
        a = p.alloc(2)
        p.free(a)
        with pytest.raises(DoubleFreeError):
            p.free(a)

    def test_free_never_allocated_raises(self):
        p = BlockPool(4)
        p.alloc(1)
        with pytest.raises(DoubleFreeError):
            p.free([3])


# ---------------------------------------------------------------------------
# transfer plans: ragged IR vs the gather oracle
# ---------------------------------------------------------------------------


def _random_moves(rng, blocks_per_rank, n_moves, *, src_ranks, dst_ranks,
                  shared_frac=0.3, mk=kvtransfer.BlockMove):
    """Random valid move batch; ``shared_frac`` makes some source
    blocks fan out to several destinations (the dedupe case)."""
    moves, dst_used = [], set()
    shared = [(int(rng.integers(len(src_ranks))),
               int(rng.integers(blocks_per_rank)))
              for _ in range(max(1, blocks_per_rank // 4))]
    while len(moves) < n_moves:
        if rng.random() < shared_frac:
            si, row = shared[int(rng.integers(len(shared)))]
            s = src_ranks[si]
        else:
            s = src_ranks[int(rng.integers(len(src_ranks)))]
            row = int(rng.integers(blocks_per_rank))
        d = dst_ranks[int(rng.integers(len(dst_ranks)))]
        dr = int(rng.integers(blocks_per_rank))
        if (d, dr) in dst_used:
            continue
        dst_used.add((d, dr))
        moves.append(mk(s, row, d, dr))
    return moves


def _pool(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1)[::7] = -0.0
    return x


class TestTransferPlan:
    @pytest.mark.parametrize("aggregate", [False, True, None])
    @pytest.mark.parametrize("transport", ["sim", "reference", "kernel"])
    def test_bit_exact_vs_oracle(self, aggregate, transport):
        """Three batches a case: the plan equals the reference's, and the
        port's transfer lands bitwise what the reference's oracle says."""
        rng = np.random.default_rng(0)
        topo, jtopo = Topology(8, 4), JTopology(8, 4)
        B = 12
        pool = _pool(rng, (8, B, 3, 2))
        tpool = torch.from_numpy(pool)
        for trial in range(3):
            moves = _random_moves(rng, B, 10 + 5 * trial,
                                  src_ranks=range(4), dst_ranks=range(4, 8))
            tp = kvtransfer.build_transfer_plan(
                moves, topo, blocks_per_rank=B, aggregate=aggregate,
                block_bytes=24)
            jtp = jkv.build_transfer_plan(
                [jkv.BlockMove(*vars(m).values()) for m in moves], jtopo,
                blocks_per_rank=B, aggregate=aggregate, block_bytes=24)
            assert tp.schedule.fingerprint() == jtp.schedule.fingerprint()
            assert tp.traffic() == jtp.traffic()
            assert all(np.array_equal(tp.landing[d], jtp.landing[d])
                       for d in jtp.landing) and \
                sorted(tp.landing) == sorted(jtp.landing)
            res = kvtransfer.run_transfer(tp, tpool, transport=transport)
            assert kvtransfer.verify_bitwise(tp, tpool, res), \
                (aggregate, transport, trial)
            want = jkv.gather_oracle(jtp.moves, pool)
            for d, (rows, vals) in want.items():
                got_rows, got_vals = res.updates[d]
                assert np.array_equal(got_rows, rows)
                assert got_vals.numpy().tobytes() == vals.tobytes()

    def test_landing_mode_independent(self):
        rng = np.random.default_rng(1)
        topo = Topology(8, 4)
        pool = torch.from_numpy(_pool(rng, (8, 8, 2, 2)))
        moves = _random_moves(rng, 8, 12, src_ranks=range(4),
                              dst_ranks=range(4, 8))
        outs = []
        for agg in (False, True):
            tp = kvtransfer.build_transfer_plan(
                moves, topo, blocks_per_rank=8, aggregate=agg,
                block_bytes=16)
            res = kvtransfer.run_transfer(tp, pool, transport="kernel")
            outs.append({d: (r.tobytes(), _bits(v).tobytes())
                         for d, (r, v) in res.updates.items()})
        assert outs[0] == outs[1]

    def test_shared_prefix_dedupe(self):
        topo = Topology(8, 4)
        moves = [kvtransfer.BlockMove(0, r, d, r)
                 for d in range(4, 8) for r in range(4)]
        std = kvtransfer.build_transfer_plan(
            moves, topo, blocks_per_rank=8, aggregate=False, block_bytes=64)
        agg = kvtransfer.build_transfer_plan(
            moves, topo, blocks_per_rank=8, aggregate=True, block_bytes=64)
        assert agg.traffic()["dcn"] < std.traffic()["dcn"]
        assert agg.traffic()["msgs_dcn"] < std.traffic()["msgs_dcn"]

    def test_invalid_moves_rejected(self):
        topo = Topology(4, 2)
        mk = kvtransfer.BlockMove
        with pytest.raises(ValueError, match="empty"):
            kvtransfer.build_transfer_plan([], topo, blocks_per_rank=4)
        with pytest.raises(ValueError, match="one rank"):
            kvtransfer.build_transfer_plan(
                [mk(1, 0, 1, 1)], topo, blocks_per_rank=4)
        with pytest.raises(ValueError, match="outside pool"):
            kvtransfer.build_transfer_plan(
                [mk(0, 7, 2, 0)], topo, blocks_per_rank=4)
        with pytest.raises(ValueError, match="land on dst row"):
            kvtransfer.build_transfer_plan(
                [mk(0, 0, 2, 1), mk(1, 3, 2, 1)], topo, blocks_per_rank=4)

    def test_bad_transport_and_resilience_raise(self):
        topo = Topology(4, 2)
        tp = kvtransfer.build_transfer_plan(
            [kvtransfer.BlockMove(0, 0, 2, 0)], topo, blocks_per_rank=4)
        pool = torch.zeros(4, 4, 2)
        with pytest.raises(ValueError, match="unknown transport"):
            kvtransfer.run_transfer(tp, pool, transport="pallas")
        with pytest.raises(ValueError, match="resilience preset"):
            kvtransfer.run_transfer(tp, pool, resilience="sideways")
        with pytest.raises(ValueError, match="verify must be one of"):
            ContinuousBatchingEngine(EngineConfig(
                **SMALL, **CPU, resilience={"verify": "sometimes"}))
        with pytest.raises(ValueError, match="unknown transport"):
            ContinuousBatchingEngine(EngineConfig(**SMALL, device="cpu",
                                                  transport="shardmap"))

    def test_verify_compares_raw_bits(self):
        """-0.0 where the oracle holds +0.0 is a mismatch."""
        topo = Topology(4, 2)
        tp = kvtransfer.build_transfer_plan(
            [kvtransfer.BlockMove(0, 0, 2, 0)], topo, blocks_per_rank=4)
        pool = torch.zeros(4, 4, 2)
        res = kvtransfer.run_transfer(tp, pool, transport="kernel")
        assert kvtransfer.verify_bitwise(tp, pool, res)
        rows, vals = res.updates[2]
        res.updates[2] = (rows, -vals)
        assert not kvtransfer.verify_bitwise(tp, pool, res)

    @pytest.mark.parametrize("transport", ["sim", "kernel"])
    def test_result_hashes_and_compares_by_identity(self, transport):
        """Two results of the same batch, as the reference's do: each
        hashes, equals itself only, and can be a set member (a generated
        ``__eq__`` over a dict of tensors could not)."""
        topo, jtopo = Topology(4, 2), JTopology(4, 2)
        moves = [kvtransfer.BlockMove(0, 1, 2, 0),
                 kvtransfer.BlockMove(1, 3, 3, 2)]
        pool = _pool(np.random.default_rng(4), (4, 4, 2))
        tp = kvtransfer.build_transfer_plan(moves, topo, blocks_per_rank=4)
        jtp = jkv.build_transfer_plan(
            [jkv.BlockMove(*vars(m).values()) for m in moves], jtopo,
            blocks_per_rank=4)
        for run, plan, buf, via in (
                (kvtransfer.run_transfer, tp, torch.from_numpy(pool),
                 transport),
                (jkv.run_transfer, jtp, pool, "sim")):
            r, r2 = (run(plan, buf, transport=via) for _ in range(2))
            assert hash(r) == hash(r) and hash(r) != hash(r2)
            assert r == r and not (r != r)
            assert r != r2 and not (r == r2)
            assert {r, r2} == {r2, r} and len({r, r, r2}) == 2


# ---------------------------------------------------------------------------
# engine state machine
# ---------------------------------------------------------------------------


class TestEngine:
    @pytest.mark.parametrize("transport", ["sim", "kernel"])
    def test_trace_drains_and_pools_free(self, transport):
        eng = ContinuousBatchingEngine(EngineConfig(
            **SMALL, device="cpu", transport=transport))
        trace = poisson_workload(0, arrival_rate=8.0, tenants=2,
                                 n_requests=24, mean_prompt=10,
                                 mean_gen=5, max_prompt=24)
        m = run_workload(eng, trace)
        assert m["completed"] == m["submitted"] == 24
        assert all(p.in_use == 0 for p in eng.pools.values())
        assert m["tokens"] == sum(r.gen_len for r in eng.done)
        assert m["kv_transfer"]["plans"] >= 1
        assert m["kv_transfer"]["bytes"] > 0
        jeng = JEngine(JEngineConfig(**SMALL))
        jm = jrun_workload(jeng, jworkload(0, arrival_rate=8.0, tenants=2,
                                           n_requests=24, mean_prompt=10,
                                           mean_gen=5, max_prompt=24))
        assert _no_wall(m) == _no_wall(jm)
        assert eng.kv.numpy().tobytes() == jeng.kv.tobytes()

    def test_fifo_admission_no_starvation(self):
        eng = ContinuousBatchingEngine(EngineConfig(**SMALL, **CPU))
        reqs = [Request(rid=0, tenant=0, prompt_len=40, gen_len=4,
                        arrival=0.0)]
        reqs += [Request(rid=i, tenant=1, prompt_len=4, gen_len=2,
                         arrival=0.01 * i) for i in range(1, 16)]
        m = run_workload(eng, reqs, dt=1.0)
        assert m["completed"] == 16
        by_arrival = sorted(eng.done, key=lambda r: (r.arrival, r.rid))
        admitted = [r.admitted_step for r in by_arrival]
        assert admitted == sorted(admitted), admitted

    def test_eviction_on_decode_oom(self):
        cfg = EngineConfig(prefill_ranks=2, decode_ranks=2,
                           ranks_per_pod=2, blocks_per_rank=2,
                           block_tokens=4, block_feat=4, **CPU)
        eng = ContinuousBatchingEngine(cfg)
        reqs = [Request(rid=i, tenant=0, prompt_len=8, gen_len=12,
                        arrival=0.0) for i in range(3)]
        m = run_workload(eng, reqs, dt=1.0)
        assert m["completed"] == 3
        assert m["preemptions"] >= 1
        assert all(p.in_use == 0 for p in eng.pools.values())

    def test_eviction_requeues_in_arrival_order(self):
        cfg = EngineConfig(prefill_ranks=2, decode_ranks=2,
                           ranks_per_pod=2, blocks_per_rank=2,
                           block_tokens=4, block_feat=4, **CPU)
        eng = ContinuousBatchingEngine(cfg)
        for i in range(3):
            eng.submit(Request(rid=i, tenant=0, prompt_len=8,
                               gen_len=12, arrival=float(i)))
        while eng.preemptions == 0 and eng.pending:
            eng.step()
        assert eng.preemptions >= 1
        victims = [r for r in eng.waiting if r.preemptions > 0]
        assert victims, "preempted request must re-enter the queue"
        arrivals = [r.arrival for r in eng.waiting]
        assert arrivals == sorted(arrivals)

    def test_oversized_request_stalls_typed(self):
        cfg = EngineConfig(prefill_ranks=2, decode_ranks=2,
                           ranks_per_pod=2, blocks_per_rank=4,
                           block_tokens=4, block_feat=4, **CPU)
        eng = ContinuousBatchingEngine(cfg)
        eng.submit(Request(rid=0, tenant=0, prompt_len=64, gen_len=4,
                           arrival=0.0))
        with pytest.raises(EngineStall):
            eng.run(max_steps=64)

    def test_transfer_corruption_is_typed(self, monkeypatch):
        real = kvtransfer.run_transfer

        def corrupting(tp, pool, **kw):
            res = real(tp, pool, **kw)
            for d, (rows, vals) in res.updates.items():
                vals = vals.clone()
                vals.view(-1)[0] += 1.0
                res.updates[d] = (rows, vals)
                break
            return res

        monkeypatch.setattr(kvtransfer, "run_transfer", corrupting)
        eng = ContinuousBatchingEngine(EngineConfig(**SMALL, **CPU))
        eng.submit(Request(rid=0, tenant=0, prompt_len=4, gen_len=2,
                           arrival=0.0))
        with pytest.raises(TransferVerificationError):
            eng.run(max_steps=16)

    def test_multi_tenant_metrics(self):
        eng = ContinuousBatchingEngine(EngineConfig(**SMALL, **CPU))
        trace = poisson_workload(3, arrival_rate=6.0, tenants=3,
                                 n_requests=18, max_prompt=24)
        assert len({r.tenant for r in trace}) >= 2
        m = run_workload(eng, trace)
        assert m["completed"] == 18
        assert m["tokens_per_step"] > 0
        assert m["ttft_steps"]["p99"] >= m["ttft_steps"]["p50"] >= 0
        assert m["kv_transfer"]["dcn_bytes"] > 0   # pools cross pods


def test_poisson_workload_matches_reference():
    for seed in (0, 1, 3):
        want = jworkload(seed, **TRACE)
        got = poisson_workload(seed, **TRACE)
        assert [vars(r) for r in got] == [vars(r) for r in want]


# ---------------------------------------------------------------------------
# the serve section of BENCH_transport.json
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["sim", "reference", "kernel"])
def test_serve_benchmark_section_reproduced(transport):
    """Seed 0, 40 requests, 3 tenants, rate 6.0 on the default engine:
    the numbers BENCH_transport.json recorded, and the reference engine
    run in-process on the same trace."""
    with open(os.path.join(ROOT, "BENCH_transport.json")) as f:
        bench = json.load(f)["serve"]
    eng = ContinuousBatchingEngine(EngineConfig(device="cpu",
                                                transport=transport))
    m = run_workload(eng, poisson_workload(0, **TRACE))
    rec = bench["traffic"]
    for key in ("submitted", "completed", "steps", "tokens",
                "tokens_per_step", "preemptions", "ttft_steps"):
        assert m[key] == rec[key], key
    for key in ("plans", "blocks", "bytes", "dcn_bytes", "ici_bytes",
                "plan_names"):
        assert m["kv_transfer"][key] == rec["kv_transfer"][key], key
    assert (m["completed"], m["steps"], m["tokens"]) == (40, 87, 248)
    assert (m["kv_transfer"]["plans"], m["kv_transfer"]["blocks"],
            m["kv_transfer"]["bytes"], m["kv_transfer"]["dcn_bytes"],
            m["kv_transfer"]["ici_bytes"]) == (20, 166, 84992, 84992, 52224)
    assert all(p.in_use == 0 for p in eng.pools.values())
    jeng = JEngine(JEngineConfig())
    jm = jrun_workload(jeng, jworkload(0, **TRACE))
    assert _no_wall(m) == _no_wall(jm)
    assert eng.kv.numpy().tobytes() == jeng.kv.tobytes()
    for got, want in zip(eng.transfer_log, jeng.transfer_log):
        assert [vars(x) for x in got["moves"]] == \
            [vars(x) for x in want["moves"]]
        assert got["plan"] == want["plan"]


def test_serve_benchmark_aggregation_reproduced():
    """Both plan modes on the logged batches, and the shared-prefix
    fan-out: DCN 8,192 -> 2,048 bytes, landed bitwise."""
    with open(os.path.join(ROOT, "BENCH_transport.json")) as f:
        rec = json.load(f)["serve"]["aggregation"]
    eng = ContinuousBatchingEngine(EngineConfig(device="cpu",
                                                transport="sim"))
    run_workload(eng, poisson_workload(0, **TRACE))
    cfg = eng.cfg
    acc = {False: [0, 0], True: [0, 0]}
    for x in eng.transfer_log:
        for mode in (False, True):
            tr = kvtransfer.build_transfer_plan(
                list(x["moves"]), eng.topo,
                blocks_per_rank=cfg.blocks_per_rank, aggregate=mode,
                block_bytes=cfg.block_bytes).traffic()
            acc[mode][0] += tr["dcn"]
            acc[mode][1] += tr["msgs_dcn"]
    assert len(eng.transfer_log) == rec["batches"]
    assert acc[False] == [rec["standard_dcn_bytes"],
                          rec["standard_dcn_msgs"]]
    assert acc[True] == [rec["locality_dcn_bytes"], rec["locality_dcn_msgs"]]
    topo = Topology(8, 4)
    prefix = [kvtransfer.BlockMove(src=0, src_row=r, dst=d, dst_row=r)
              for d in range(4, 8) for r in range(4)]
    pool = torch.from_numpy(np.asarray(np.random.default_rng(8).normal(
        size=(8, cfg.blocks_per_rank, 2, 2)), np.float32))
    dcn = {}
    for mode in (False, True):
        tp = kvtransfer.build_transfer_plan(
            prefix, topo, blocks_per_rank=cfg.blocks_per_rank,
            aggregate=mode, block_bytes=cfg.block_bytes)
        for transport in ("sim", "kernel"):
            res = kvtransfer.run_transfer(tp, pool, transport=transport)
            assert kvtransfer.verify_bitwise(tp, pool, res)
        dcn[mode] = tp.traffic()["dcn"]
    sp = rec["shared_prefix"]
    assert (dcn[False], dcn[True]) == (sp["standard_dcn_bytes"],
                                       sp["locality_dcn_bytes"]) \
        == (8192, 2048)


# ---------------------------------------------------------------------------
# the launcher's continuous path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["kernel", "sim"])
def test_launcher_continuous_matches_reference(transport, capsys):
    """``launch.serve --continuous`` on the CPU: the reference launcher's
    metrics on the same flags (block_feat = head_dim of the config)."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    flags = ["--arch", "gemma2-2b", "--smoke", "--continuous",
             "--arrival-rate", "6", "--tenants", "3", "--requests", "24",
             "--kv-blocks", "16", "--seed", "1"]
    want = jserve.main(flags)
    got = tserve.main(flags + ["--device", "cpu", "--kv-transport",
                               transport])
    assert _no_wall(got) == _no_wall(want)
    assert "24/24 requests" in capsys.readouterr().out


def test_launcher_continuous_rejects_bad_flags():
    from repro_torch.launch import serve as tserve
    base = ["--arch", "gemma2-2b", "--smoke", "--continuous", "--device",
            "cpu"]
    for bad in (["--arrival-rate", "0"], ["--tenants", "0"],
                ["--requests", "0"], ["--kv-blocks", "0"],
                ["--kv-transport", "pallas"], ["--select-policy", "fastest"],
                ["--probe-links"], ["--heal-interval", "-1"]):
        with pytest.raises(SystemExit):
            tserve.main(base + bad)


# ---------------------------------------------------------------------------
# the recovery ladder on the KV path
# ---------------------------------------------------------------------------


def _report_key(rep, rename=None):
    rename = rename or {}
    return ([(rename.get(a.rung, a.rung), a.algorithm, a.attempt, a.outcome)
             for a in rep.attempts], list(rep.verdicts),
            rename.get(rep.recovered_with, rep.recovered_with),
            rep.refit_algorithm, rep.degraded)


@pytest.mark.parametrize("rung", ["sim", "kernel"])
def test_chaos_under_load_reproduced(rung):
    """``serve.chaos_under_load`` of BENCH_transport.json: a corrupt
    campaign armed for the whole trace, every batch verified in full and
    recovered bitwise (the engine's own oracle check); 40 served, 17
    plans, 17 reports, 2 degraded — and each report equal to the
    reference engine's on the same trace (with the plan wrapped round
    the port's kernel rung, kernel read as sim)."""
    from repro.core import chaos as jchaos
    from repro.core.transport import SimTransport as JSimTransport

    from repro_torch.core import chaos
    from repro_torch.core.transport import KernelTransport, SimTransport

    with open(os.path.join(ROOT, "BENCH_transport.json")) as f:
        want = json.load(f)["serve"]["chaos_under_load"]
    jeng = JEngine(JEngineConfig(
        resilience={"verify": "full", "ladder": ("sim", "reference"),
                    "backoff_s": 1e-5}),
        transports={"sim": jchaos.wrap(JSimTransport(8),
                                       jchaos.FaultPlan(0, "corrupt",
                                                        times=1))})
    jm = jrun_workload(jeng, jworkload(1, **TRACE))
    inner = SimTransport(8) if rung == "sim" else KernelTransport(8)
    ladder = ("sim", "reference") if rung == "sim" else \
        ("kernel", "sim", "reference")
    eng = ContinuousBatchingEngine(
        EngineConfig(device="cpu", transport=rung, resilience={
            "verify": "full", "ladder": ladder, "backoff_s": 1e-5}),
        transports={rung: chaos.wrap(inner, chaos.FaultPlan(
            0, "corrupt", times=1))})
    m = run_workload(eng, poisson_workload(1, **TRACE))
    degraded = sum(1 for r in eng.degradations if r.degraded)
    got = {"campaign": "corrupt", "seed": 0, "submitted": m["submitted"],
           "completed": m["completed"], "plans": m["kv_transfer"]["plans"],
           "reports": len(eng.degradations), "degraded_recovered": degraded,
           "recovered_bitwise": True}
    assert got == want
    assert (m["completed"], m["kv_transfer"]["plans"],
            len(eng.degradations), degraded) == (40, 17, 17, 2)
    assert m["degradations"] == 17
    assert _no_wall(m) == _no_wall(jm)
    assert eng.kv.numpy().tobytes() == jeng.kv.tobytes()
    assert [_report_key(r, {"kernel": "sim"}) for r in eng.degradations] \
        == [_report_key(r) for r in jeng.degradations]


def test_run_transfer_carries_its_report():
    from repro_torch.core.resilient import DegradationReport
    topo = Topology(8, 4)
    moves = [kvtransfer.BlockMove(src=s, src_row=r, dst=4 + s, dst_row=r)
             for s in range(4) for r in range(3)]
    tp = kvtransfer.build_transfer_plan(moves, topo, blocks_per_rank=8,
                                        block_bytes=16)
    pool = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, 8, 2, 2)).astype(np.float32))
    res = kvtransfer.run_transfer(tp, pool, transport="kernel")
    assert res.report is None
    res = kvtransfer.run_transfer(tp, pool, transport="kernel",
                                  resilience="canary")
    assert isinstance(res.report, DegradationReport)
    assert res.report.recovered_with == "kernel" and not res.report.degraded
    assert kvtransfer.verify_bitwise(tp, pool, res)
    res = kvtransfer.run_transfer(
        tp, pool, resilience={"verify": "full", "ladder": ("sim",)})
    assert res.report.recovered_with == "sim"
    assert kvtransfer.verify_bitwise(tp, pool, res)


def test_engine_rejects_bad_resilience():
    with pytest.raises(ValueError, match="resilience preset"):
        ContinuousBatchingEngine(EngineConfig(**SMALL, **CPU,
                                              resilience="sideways"))


@pytest.mark.parametrize("transport", ["kernel", "sim"])
def test_launcher_continuous_resilience(transport, capsys):
    """``--continuous --resilience canary`` serves every request, with the
    reference launcher's metrics on the same flags (one report per
    batch)."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    flags = ["--arch", "gemma2-2b", "--smoke", "--continuous",
             "--requests", "12", "--kv-blocks", "16", "--seed", "2",
             "--resilience", "canary"]
    want = jserve.main(flags)
    got = tserve.main(flags + ["--device", "cpu", "--kv-transport",
                               transport])
    assert got["completed"] == got["submitted"] == 12
    assert got["degradations"] == got["kv_transfer"]["plans"] > 0
    assert _no_wall(got) == _no_wall(want)
    out = capsys.readouterr().out
    assert "12/12 requests" in out
    assert f"resilience: {got['degradations']} degradation report(s)" in out


def test_launcher_resilience_without_continuous_exits():
    from repro_torch.launch import serve as tserve
    with pytest.raises(SystemExit, match="nothing to protect"):
        tserve.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
                     "--resilience", "canary"])
