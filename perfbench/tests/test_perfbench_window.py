"""The measured window and the traced tail after it: every rank makes
the same count of calls, and a traced run's result carries its
per-layer metrics and breakdown.  On the CPU at the small size of
``smoke.py``."""
import argparse
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests import smoke


def _counts(rank, world, rendezvous, q):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=rendezvous, rank=rank,
                            world_size=world)
    try:
        args = argparse.Namespace(workload="w", seconds=0.3, trace=0)
        ctx = harness.Ctx(args, {}, {}, torch.device("cpu"), rank, world,
                          stop_group=dist.group.WORLD)
        # the ranks' calls take different times; the counts agree
        n, _ = ctx.measure(lambda: time.sleep(0.002 * (rank + 1)))
        q.put((rank, n))
    finally:
        dist.destroy_process_group()


def test_every_rank_makes_the_same_count():
    import multiprocessing as mp
    q = mp.get_context("spawn").Queue()
    codes = harness.spawn_ranks(_counts, 3, q, timeout=120)
    assert codes == [0, 0, 0]
    got = dict(q.get(timeout=10) for _ in range(3))
    assert len(set(got.values())) == 1 and got[0] > 10, got


def test_one_rank_stops_when_the_time_is_up():
    args = argparse.Namespace(workload="w", seconds=0.2, trace=0)
    ctx = harness.Ctx(args, {}, {}, torch.device("cpu"))
    n, traced = ctx.measure(lambda: time.sleep(0.01))
    assert traced == 0 and 10 <= n <= 30
    assert 0.2 <= ctx.run.window_s < 0.4 and ctx.run.trace is None


@pytest.mark.parametrize("cell, metric", [
    ("smollm-360m.train", "train_mfu"),
    ("jamba2-mini.prefill", "prefill_mfu")])
def test_a_traced_run(cell, metric, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.3)
    monkeypatch.setattr(harness, "NAME_SECONDS", 0.3)
    out = smoke.run_cpu(cell, trace=1)
    assert out["correct"], out["checks"]
    names = {m["name"] for m in harness.metric_entries(
        harness.manifest(), cell, True)}
    assert set(out["metrics"]) <= names and metric in out["metrics"]
    assert out["metrics"][metric]["value"] > 0
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["notes"]["traced_rate_ratio"] > 0
    assert out["checks"] and list(out)[-1] == "checks"


def test_a_traced_run_on_four_ranks():
    out = smoke.run_cpu_ranks("smollm-360m.train-dp4", 4, trace=1)
    assert out["correct"], out["checks"]
    assert out["metrics"]["train_mfu"]["value"] > 0
    assert out["device"]["count"] == 4 and "breakdown" in out
