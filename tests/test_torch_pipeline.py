"""The port's pipeline parallelism (``repro_torch.core.pipeline``)
against the JAX package's and a sequential oracle.

- ``gpipe_wavefront_schedule``: the schedule's fingerprint and the
  armed executor's makespan equal to the reference's (exact);
- ``stage_params_spec``: the reference's properties (contiguous,
  balanced within one layer, the remainder on the last stages);
- ``gpipe`` on one stage (no process group): the per-microbatch map,
  ``atol 1e-6`` (float32, the same ops);
- ``gpipe`` on 4 gloo ranks (tests/torch_pipeline_worker.py): outputs on
  the last stage (or on stage 0 with ``return_to_first``) and every
  stage's weight gradients equal to the sequential 4-layer stack's,
  ``atol 1e-6`` (the same float32 ops; the backward through the reverse
  shifts); the other stages' outputs exact zeros.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except Exception:                                  # pragma: no cover
    sys.path.insert(0, os.path.dirname(__file__))
    from _hypothesis_stub import given, settings, st

from repro.core import executor as jexecutor
from repro.core import pipeline as jpl
from repro.core.topology import flat_topology as jflat

from repro_torch.core import executor, pipeline as pl
from repro_torch.core.topology import flat_topology

sys.path.insert(0, os.path.dirname(__file__))
import torch_pipeline_worker as worker  # noqa: E402

S = 4


@pytest.mark.parametrize("M,n", [(1, 1), (6, 4), (8, 4), (3, 8), (5, 2)])
def test_wavefront_schedule_equals_reference(M, n):
    got = pl.gpipe_wavefront_schedule(M, n, 1e-3)
    want = jpl.gpipe_wavefront_schedule(M, n, 1e-3)
    assert got.name == want.name
    assert got.fingerprint() == want.fingerprint()
    assert len(got.rounds) == len(want.rounds) == M + n - 1
    assert [(e.name, e.seconds, e.after_round) for e in got.compute_events] \
        == [(e.name, e.seconds, e.after_round) for e in want.compute_events]
    slot = float(1 << 16)
    mk = executor.get_executor(got, topo=flat_topology(n)).makespan(slot)
    jmk = jexecutor.get_executor(want, topo=jflat(n)).makespan(slot)
    assert mk == jmk
    with pytest.raises(ValueError):
        pl.gpipe_wavefront_schedule(0, n, 1e-3)
    with pytest.raises(ValueError):
        pl.gpipe_wavefront_schedule(M, 0, 1e-3)


@settings(max_examples=40, deadline=None)
@given(n_layers=st.integers(1, 64), n_stages=st.integers(1, 16))
def test_stage_params_spec_properties(n_layers, n_stages):
    n_stages = min(n_stages, n_layers)
    spans = pl.stage_params_spec(n_layers, n_stages)
    assert spans == jpl.stage_params_spec(n_layers, n_stages)
    assert len(spans) == n_stages
    assert [i for r in spans for i in r] == list(range(n_layers))
    sizes = [len(r) for r in spans]
    assert max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes)


def _inputs(n_stages, M=6):
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    return {"W": t(rng.normal(size=(n_stages, 5, 5)) * 0.5),
            "b": t(rng.normal(size=(n_stages, 5))),
            "x": t(rng.normal(size=(M, 4, 5))),
            "w": t(rng.normal(size=(M, 4, 5)))}


def _sequential(inp, n_stages):
    W = inp["W"].clone().requires_grad_()
    b = inp["b"].clone().requires_grad_()
    h = inp["x"]
    for s in range(n_stages):
        h = torch.tanh(h @ W[s] + b[s])
    gW, gb = torch.autograd.grad((h * inp["w"]).sum(), (W, b))
    return h.detach(), gW, gb


def test_gpipe_single_stage_matches_sequential():
    inp = _inputs(1)
    W = inp["W"][0].clone().requires_grad_()
    b = inp["b"][0].clone().requires_grad_()
    y = pl.gpipe(worker.stage_fn, (W, b), inp["x"], None)
    want, gW, gb = _sequential(inp, 1)
    np.testing.assert_allclose(y.detach().numpy(), want.numpy(), atol=1e-6)
    got = torch.autograd.grad((y * inp["w"]).sum(), (W, b))
    np.testing.assert_allclose(got[0].numpy(), gW[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), gb[0].numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def run4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_gpipe")
    inp = _inputs(S)
    torch.multiprocessing.spawn(
        worker.run, args=(S, f"file://{tmp}/rendezvous", inp, str(tmp)),
        nprocs=S, join=True)
    return inp, [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(S)]


@pytest.mark.parametrize("back", [False, True])
def test_gpipe_four_stages_equal_the_sequential_stack(run4, back):
    inp, outs = run4
    want, gW, gb = _sequential(inp, S)
    holder = 0 if back else S - 1
    for r, o in enumerate(outs):
        got = o[back]
        if r == holder:
            np.testing.assert_allclose(got["y"].numpy(), want.numpy(),
                                       atol=1e-6)
        else:
            assert not got["y"].any()
        np.testing.assert_allclose(got["gW"].numpy(), gW[r].numpy(),
                                   atol=1e-6, err_msg=f"stage {r}")
        np.testing.assert_allclose(got["gb"].numpy(), gb[r].numpy(),
                                   atol=1e-6, err_msg=f"stage {r}")
