"""The port's distributed training paths on 8 gloo ranks, one spawn
(tests/torch_train_worker.py), held to the checks and tolerances of the
reference's tests/device_scripts/check_train_dist.py and
check_overlap.py:

- the expert-parallel MoE dispatch on the (2, 4) ``("data", "model")``
  and (2, 2, 2) ``("pod", "data", "model")`` meshes, alltoall ``xla``,
  ``pairwise`` (on the ``dist`` and ``kernel`` transports) and
  ``hierarchical``, capacity E (nothing drops): equal to the reference's
  dense dispatch on the whole batch within ``atol = rtol = 2e-2``; the
  overlapped dispatch (2 chunks) equal to the monolithic one within
  ``1e-5``; the serving prefill with the EP dispatch equal to the dense
  prefill within ``2e-2``;
- the explicit-DP step (``xla``, ``ring_rs_ag``, ``hierarchical`` on
  the flat mesh; ``xla``, ``hierarchical`` on the pods mesh) equal to
  the one-device step: loss within 1e-2, every parameter within
  ``atol 1e-2`` (bf16 state); the ``dist`` and ``kernel`` transports
  bitwise equal to each other; every rank's parameters bitwise equal;
- bucketed (4 buckets) as the one-device step; the overlapped sync (2
  chunks) against the unpipelined explicit step: loss within 1e-5,
  ``grad_norm`` within ``1e-4 max(1, |g|)``, parameters ``atol 1e-5``;
  the compressed sync finite and within ``atol 5e-2`` of the one-device
  step, with a finite error-feedback residual (in each gradient's
  dtype, as the reference cuts it back);
- the fsdp step on the flat mesh as the one-device step;
- the EP dispatch inside the explicit step (moonshot, float32, capacity
  E) against the one-device dense step: loss ``rtol 1e-4``, parameters
  ``atol 5e-5 + 1e-5 |p|`` (as tests/test_torch_train_step.py's
  moonshot step).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.data import DataPipeline as JPipe, PipelineConfig as JCfg
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.train.step import TrainOptions as JOpts, init_train_state as jinit

from repro_torch import configs
from repro_torch.convert import (params_from_jax, tensor_from_numpy,
                                 train_state_from_jax)
from repro_torch.train import sync
from repro_torch.train.step import TrainOptions, make_train_step

sys.path.insert(0, os.path.dirname(__file__))
import torch_train_worker as worker  # noqa: E402

N = 8
EP_TOL = dict(atol=2e-2, rtol=2e-2)


def _np(t):
    return jax.tree.map(np.asarray, t)


def _batch(vocab, B, S, seed):
    jb = JPipe(JCfg(vocab_size=vocab, seq_len=S, global_batch=B,
                    seed=seed)).batch(0)
    return {k: tensor_from_numpy(np.asarray(v)) for k, v in jb.items()}


@pytest.fixture(scope="module")
def run8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_train_dist")
    # the EP inputs: moonshot's smoke MoE layer (f32), x [4, 8, d]
    jcfg = jconfigs.get_smoke("moonshot-v1-16b-a3b")
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jmoe.init(jax.random.key(0), jcfg.moe, jcfg.d_model))
    x = np.asarray(jax.random.normal(jax.random.key(1),
                                     (4, 8, jcfg.d_model)) * 0.3, np.float32)
    moe_state = {k.removeprefix("layers.0.x."): v for k, v in
                 params_from_jax({"prefix": [{"x": _np(jp)}]}).items()}
    jmp = jax.tree.map(lambda a: a.astype(jnp.float32),
                       JM.init_params(jax.random.key(2), jcfg))
    # the train states: smollm bf16 (as check_train_dist.py), moonshot f32
    scfg = jconfigs.get_smoke("smollm-360m")
    st = jinit(jax.random.key(0), scfg, JOpts(dp_mode="fsdp"))
    mst = jax.tree.map(lambda a: a.astype(jnp.float32)
                       if a.dtype == jnp.bfloat16 else a,
                       jinit(jax.random.key(0), jcfg, JOpts()))
    mst["step"] = jnp.int32(3)
    inputs = {
        "moe": moe_state, "x": torch.from_numpy(x.copy()),
        "moe_model": params_from_jax(_np(jmp)),
        "serve_tokens": torch.from_numpy(np.random.default_rng(3).integers(
            0, jcfg.vocab_size, (4, 16)).astype(np.int32)),
        "state": train_state_from_jax(_np(st)),
        "batch": _batch(scfg.vocab_size, 8, 16, 3),
        "moe_state": train_state_from_jax(_np(mst)),
        "moe_batch": _batch(jcfg.vocab_size, 4, 16, 5),
    }
    want_ep = np.asarray(jmoe.forward(jp, jcfg.moe, jnp.asarray(x),
                                      jcfg.mlp_act), np.float32)
    torch.multiprocessing.spawn(
        worker.run, args=(N, f"file://{tmp}/rendezvous", inputs, str(tmp)),
        nprocs=N, join=True)
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(N)]
    return inputs, want_ep, outs


def _global(outs, key, mesh):
    """The global batch of a per-rank output, from the model-rank-0 copy
    of each data shard."""
    d = tuple(a for a in worker.MESHES[mesh][1] if a in ("pod", "data"))
    rows = {}
    for o in outs:
        c = o["coords"][mesh]
        if c["model"] == 0:
            idx = 0
            for a in d:
                idx = idx * dict(zip(worker.MESHES[mesh][1],
                                     worker.MESHES[mesh][0]))[a] + c[a]
            rows[idx] = o[key]
    return torch.cat([rows[i] for i in sorted(rows)]).numpy()


@pytest.mark.parametrize("mesh", ["flat", "pods"])
@pytest.mark.parametrize("algo,tr", [("xla", "dist"), ("pairwise", "dist"),
                                     ("pairwise", "kernel"),
                                     ("hierarchical", "dist")])
def test_ep_dispatch_equals_dense_oracle(run8, mesh, algo, tr):
    _, want, outs = run8
    got = _global(outs, ("ep", mesh, algo, tr), mesh)
    np.testing.assert_allclose(got, want, **EP_TOL)
    for o in outs:          # every model rank of a shard holds the same
        same = [p for p in outs if p["coords"][mesh]["model"] != 0
                and all(p["coords"][mesh][a] == o["coords"][mesh][a]
                        for a in o["coords"][mesh] if a != "model")]
        for p in same:
            assert torch.equal(p[("ep", mesh, algo, tr)],
                               o[("ep", mesh, algo, tr)])


def test_ep_overlap_equals_monolithic(run8):
    _, _, outs = run8
    for o in outs:
        np.testing.assert_allclose(o[("ep_overlap",)].numpy(),
                                   o[("ep", "flat", "pairwise", "dist")]
                                   .numpy(), atol=1e-5, rtol=1e-5)


def test_serve_prefill_with_ep_dispatch(run8):
    _, _, outs = run8
    for o in outs:
        a, b = o[("serve", "ep_overlap")], o[("serve", "default")]
        assert a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   **EP_TOL)


@pytest.fixture(scope="module")
def one_device(run8):
    inputs = run8[0]
    cfg = configs.get_smoke("smollm-360m")
    new, m = make_train_step(cfg, None, TrainOptions(
        dp_mode="fsdp", **worker.STEP_KW))(inputs["state"], inputs["batch"])
    return float(m["loss"]), new["params"]


def _close(o, ref, *, loss_tol=1e-2, atol=1e-2):
    loss, params = ref
    assert abs(o["loss"] - loss) < loss_tol, (o["loss"], loss)
    for k, v in params.items():
        np.testing.assert_allclose(o["params"][k].float().numpy(),
                                   v.float().numpy(), atol=atol, err_msg=k)


def _same_everywhere(outs, key):
    for o in outs[1:]:
        assert o[key]["loss"] == outs[0][key]["loss"]
        for k, v in outs[0][key]["params"].items():
            assert torch.equal(o[key]["params"][k], v), (key, k)


@pytest.mark.parametrize("mesh,algo", worker.DP_CASES)
def test_explicit_dp_equals_one_device(run8, one_device, mesh, algo):
    _, _, outs = run8
    for tr in ("dist", "kernel"):
        _same_everywhere(outs, ("dp", mesh, algo, tr))
        _close(outs[0][("dp", mesh, algo, tr)], one_device)
    a, b = outs[0][("dp", mesh, algo, "dist")], \
        outs[0][("dp", mesh, algo, "kernel")]
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for k, v in a["params"].items():
        assert torch.equal(v.view(torch.int16), b["params"][k].view(
            torch.int16)), k


def test_bucketed_sync(run8, one_device):
    _, _, outs = run8
    _same_everywhere(outs, ("buckets",))
    _close(outs[0][("buckets",)], one_device)


def test_overlapped_sync_equals_unpipelined(run8):
    _, _, outs = run8
    _same_everywhere(outs, ("overlap",))
    a, b = outs[0][("overlap",)], outs[0][("overlap_base",)]
    assert abs(a["loss"] - b["loss"]) < 1e-5
    assert abs(a["grad_norm"] - b["grad_norm"]) < 1e-4 * max(
        1.0, b["grad_norm"])
    for k, v in b["params"].items():
        np.testing.assert_allclose(a["params"][k].float().numpy(),
                                   v.float().numpy(), atol=1e-5, err_msg=k)


def test_compressed_sync(run8, one_device):
    _, _, outs = run8
    o = outs[0][("compressed",)]
    assert np.isfinite(o["loss"])
    _close(o, one_device, atol=5e-2)
    for k, r in o["residual"].items():
        # cut back to the gradient's dtype, as the reference's _unflatten
        assert torch.isfinite(r).all()
        assert r.dtype == o["params"][k].dtype
    assert any(bool(r.any()) for r in o["residual"].values())


def test_fsdp_group_step_equals_one_device(run8, one_device):
    _, _, outs = run8
    _same_everywhere(outs, ("fsdp",))
    _close(outs[0][("fsdp",)], one_device)


def test_ep_train_step_equals_one_device(run8):
    inputs, _, outs = run8
    cfg = configs.get_smoke("moonshot-v1-16b-a3b")
    new, m = make_train_step(cfg, None, TrainOptions(
        dp_mode="fsdp", moe_mode="dense", **worker.STEP_KW))(
        inputs["moe_state"], inputs["moe_batch"])
    _same_everywhere(outs, ("ep_step",))
    o = outs[0][("ep_step",)]
    np.testing.assert_allclose(o["loss"], float(m["loss"]), rtol=1e-4)
    for k, v in new["params"].items():
        np.testing.assert_allclose(o["params"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=5e-5, err_msg=k)


def test_dp_allreduce_overlap_validation():
    with pytest.raises(ValueError):
        sync.dp_allreduce_overlap({"a": torch.zeros(4)}, None, chunks=0)
    with pytest.raises(ValueError):
        sync.dp_allreduce_overlap({"a": torch.zeros(4)}, None, chunks=-1)
