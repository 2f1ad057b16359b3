"""Sharded fsdp storage (``train.step.sharded_train_step``,
``train.shard``) on 4 gloo ranks ((4, 1) over ``("data", "model")``)
and 8 ((2, 2, 2) over ``("pod", "data", "model")``), one spawn each
(tests/torch_sharded_worker.py), for a dense config and an MoE config
under the ``dropless`` and ``mpix_ep`` dispatches, remat on:

- two sharded steps equal two replicated fsdp steps
  (``make_train_step``, the yardstick) at the tolerance of
  tests/test_torch_train_dist.py::test_fsdp_group_step_equals_one_device:
  loss within 1e-2, every parameter within ``atol 1e-2`` (bf16 state);
  the moments within ``atol 1e-4`` and the global grad norm within
  ``rtol 1e-3`` (the gradient sums round to bf16 on the wire, where the
  replicated sync sums in f32);
- every rank gathers the same parameters, bit for bit;
- each rank stores exactly its spec share of params, ``mu`` and ``nu``,
  before and after the steps, and the configs are wide enough that some
  parameter is cut over each axis of the mesh;
- the collectives the step issued on live ranks are the ones the
  dry-run records for the same step on a ``MeshLayout`` at that rank's
  coordinates (kind, group size, bytes, in order).
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import MeshLayout
from repro_torch.train import sharding
from repro_torch.train.step import TrainOptions, init_train_state, state_specs

sys.path.insert(0, os.path.dirname(__file__))
import torch_sharded_worker as worker  # noqa: E402


def _spawn_all(tmp_path_factory) -> dict:
    """One spawn of 4 ranks and one of 8, running side by side."""
    runs = {}
    for n in (4, 8):
        tmp = tmp_path_factory.mktemp(f"sharded{n}")
        ctx = torch.multiprocessing.start_processes(
            worker.run, args=(n, f"file://{tmp}/rendezvous", str(tmp)),
            nprocs=n, join=False, start_method="spawn")
        runs[n] = (ctx, tmp)
    for ctx, _ in runs.values():
        while not ctx.join():
            pass
    return {n: [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(n)] for n, (_, tmp) in runs.items()}


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    return _spawn_all(tmp_path_factory)


CASES = [(n, c) for n in (4, 8) for c in worker.CASES]


def _layout(n, coords=None):
    shape, axes = worker.MESHES[n]
    return MeshLayout(shape, axes, coords=coords)


def _opts(case):
    return TrainOptions(dp_mode="fsdp", moe_mode=worker.CASES[case][1],
                        ep_capacity=2.0, **worker.STEP_KW)


@pytest.mark.parametrize("n,case", CASES)
def test_sharded_step_equals_replicated(outs, n, case):
    for o in outs[n]:
        r = o[case]
        for a, b in zip(r["loss"], r["ref_loss"]):
            assert abs(a - b) < 1e-2, (a, b)
        np.testing.assert_allclose(r["grad_norm"], r["ref_norm"], rtol=1e-3)
        for k, v in r["ref_params"].items():
            np.testing.assert_allclose(r["params"][k].float().numpy(),
                                       v.float().numpy(), atol=1e-2,
                                       err_msg=k)
            np.testing.assert_allclose(r["mu"][k].numpy(),
                                       r["ref_mu"][k].numpy(), atol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("n,case", CASES)
def test_sharded_step_same_on_every_rank(outs, n, case):
    first = outs[n][0][case]
    for o in outs[n][1:]:
        assert o[case]["loss"] == first["loss"]
        for k, v in first["params"].items():
            assert torch.equal(o[case]["params"][k], v), k


@pytest.mark.parametrize("n,case", CASES)
def test_sharded_step_stores_spec_share(outs, n, case):
    cfg = worker.CASES[case][0]()
    g = torch.Generator()
    full = init_train_state(g, cfg, _opts(case), device="meta")
    total = sum(t.numel() * t.element_size()
                for t in full["params"].values())
    for o in outs[n]:
        mesh = _layout(n, o["coords"])
        pspec = state_specs(full, cfg, mesh, _opts(case))["params"]
        want = {"params": 0, "mu": 0, "nu": 0}
        for k, t in full["params"].items():
            want["params"] += sharding.shard_bytes(
                t.shape, t.element_size(), pspec[k], mesh)
            for m in ("mu", "nu"):
                want[m] += sharding.shard_bytes(t.shape, 4, pspec[k], mesh)
        assert o[case]["stored"] == o[case]["stored_after"] == want
        assert want["params"] < total
    cut = {a for s in pspec.values() for a in sharding.spec_axes(s)}
    assert {a for a, s in mesh.shape.items() if s > 1} <= cut, cut


@pytest.mark.parametrize("n,case", CASES)
def test_dryrun_record_equals_real_collectives(outs, n, case):
    """The dry-run's recorder (``launch.dryrun`` on a ``MeshLayout``, the
    step run on ``meta``) records, call for call, the collectives the
    live step passed to ``torch.distributed`` on rank 0 and rank n-1:
    kind, group size, result bytes and wire bytes."""
    from repro_torch.launch import dryrun
    cfg = worker.CASES[case][0]()
    ins = {k: torch.empty((worker.B, worker.S), dtype=torch.int32,
                          device="meta") for k in ("tokens", "labels")}
    for o in (outs[n][0], outs[n][-1]):
        mesh = _layout(n, o["coords"])
        res = dryrun.analyse_cell(cfg, "train", ins, mesh,
                                  train_overrides=dict(
                                      moe_mode=worker.CASES[case][1],
                                      ep_capacity=2.0, **worker.STEP_KW))
        assert mesh.log == o[case]["log"]
        assert res["collectives"]["count"] == len(o[case]["log"])
        assert res["collectives"]["total"] == pytest.approx(
            sum(e[3] for e in o[case]["log"]), rel=1e-12)
