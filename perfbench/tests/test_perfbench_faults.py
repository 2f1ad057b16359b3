"""A run with the timed path broken underneath comes out not correct,
once for each fault the cell can have; the run as it is comes out
correct.  The harness's look for a card is skipped (the CPU at the
small size of ``smoke.py``); everything else is the run's own."""
import pytest

from perfbench import faults
from perfbench.tests import smoke

TRAIN_FAULTS = ["state_unchanged", "half_batch"]


def _planted(name, monkeypatch):
    return lambda ctx: faults.FAULTS[name](monkeypatch.setattr)


@pytest.mark.parametrize("cell", ["smollm-360m.train", "jamba2-mini.prefill"])
def test_the_run_as_it_is_is_correct(cell):
    out = smoke.run_cpu(cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", TRAIN_FAULTS)
def test_train_faults_are_not_correct(fault, monkeypatch):
    out = smoke.run_cpu("smollm-360m.train",
                        patch=_planted(fault, monkeypatch))
    assert not out["correct"], out["checks"]


def test_altered_token_is_not_correct(monkeypatch):
    out = smoke.run_cpu("jamba2-mini.prefill",
                        patch=_planted("altered_token", monkeypatch))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [None, *TRAIN_FAULTS, "no_exchange"])
def test_four_ranks(fault):
    out = smoke.run_cpu_ranks("smollm-360m.train-dp4", 4,
                              patch=faults.planted(fault) if fault else None)
    assert out["correct"] == (fault is None), out["checks"]


def _one_fails(rank, world, rendezvous):
    import time
    if rank == 1:
        raise SystemExit(5)
    time.sleep(120)


def test_a_failed_rank_ends_the_others():
    import time
    from perfbench import harness
    t0 = time.monotonic()
    codes = harness.spawn_ranks(_one_fails, 3)
    assert codes[1] == 5 and all(c != 0 for c in codes)
    assert time.monotonic() - t0 < 60
