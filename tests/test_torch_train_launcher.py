"""The port's training launcher (``repro_torch.launch.train``) on the
CPU at smoke size.

- ``main`` trains: every loss finite, the mean of the last 3 below the
  mean of the first 3 (the reference's rule, tests/test_train_step.py);
- a 10-step run with checkpoints every 3 steps, stopped after step 6's
  (its later checkpoints removed) and run again with the same command,
  resumes at step 6 with the losses of a straight 10-step run (bitwise:
  the restored state is the saved one, on the same CPU ops), and a
  finished run resumed again does nothing;
- ``--dp-mode explicit`` on a 4-rank gloo group (the ``torchrun``
  environment, tests/torch_train_worker.py): every rank reports the
  same finite losses, equal to the one-process run's within 1e-2 (the
  reference's explicit-DP tolerance, check_train_dist.py);
- ``--device cuda`` without a card exits with an error, not on the CPU;
- the serving launcher's ``--ep-transport`` prefill on a group of one
  rank: the EP prefill's logits, with capacity drops, finite and of the
  dense prefill's shape.
"""
import os
import shutil
import socket
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import committed_steps
from repro_torch.launch import train

sys.path.insert(0, os.path.dirname(__file__))
import torch_train_worker as worker  # noqa: E402

BASE = ["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--batch",
        "4", "--seq", "32", "--log-every", "100"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_loss_decreases():
    run = train.main(BASE + ["--steps", "12"])
    assert len(run.losses) == 12 and np.isfinite(run.losses).all()
    assert np.mean(run.losses[-3:]) < np.mean(run.losses[:3]), run.losses
    assert run.start_step == 0 and run.step_ms == [] \
        and run.peak_bytes is None
    assert len(run.host_ms) == 12


def test_resume_continues_the_same_losses(tmp_path):
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    first = train.main(BASE + ["--steps", "10"] + ck)
    straight = train.main(BASE + ["--steps", "10"])
    assert first.losses == straight.losses
    # stopped after step 6's checkpoint: the later ones never committed
    for s in committed_steps(tmp_path):
        if s > 6:
            shutil.rmtree(tmp_path / f"step_{s:08d}")
    resumed = train.main(BASE + ["--steps", "10"] + ck)
    assert resumed.start_step == 6
    assert resumed.losses == straight.losses[6:]
    again = train.main(BASE + ["--steps", "10"] + ck)
    assert again.start_step == 10 and again.losses == []


def test_explicit_dp_on_four_gloo_ranks(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    argv = BASE + ["--steps", "4", "--dp-mode", "explicit",
                   "--dp-algorithm", "ring_rs_ag", "--grad-buckets", "2",
                   "--batch", "8"]
    torch.multiprocessing.spawn(worker.run_launcher,
                                args=(4, port, argv, str(tmp_path)),
                                nprocs=4, join=True)
    outs = [torch.load(tmp_path / f"launcher{r}.pt") for r in range(4)]
    for o in outs:
        assert o["losses"] == outs[0]["losses"]
    assert np.isfinite(outs[0]["losses"]).all()
    one = train.main(BASE + ["--steps", "4", "--batch", "8"])
    np.testing.assert_allclose(outs[0]["losses"], one.losses, atol=1e-2)


def test_cuda_without_a_card_exits():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main(["--arch", "smollm-360m", "--smoke", "--steps", "1"])


def test_serve_launcher_ep_prefill(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "moonshot-v1-16b-a3b", "--smoke", "--device",
                "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "2",
                "--ep-transport", "kernel", "--ep-alltoall", "pairwise"])
    out = capsys.readouterr().out
    assert "EP prefill (pairwise on kernel, 1 rank(s)): (2, 8, 277)" in out
    with pytest.raises(SystemExit, match="no MoE layers"):
        serve.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                    "--ep-transport", "dist"])
