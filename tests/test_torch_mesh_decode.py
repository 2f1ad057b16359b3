"""Decode on a mesh of ranks (``serve.step.mesh_decode_step``) and the
serving launcher's ``--mesh``, on 4 gloo ranks ((2, 2) over ``("data",
"model")``) and 8 ((2, 2, 2) over ``("pod", "data", "model")``), one
spawn each (tests/torch_mesh_decode_worker.py):

- six decode steps of each config -- a gemma2-style stack (window 4,
  attention and final softcaps, GQA, wide enough that the parameter
  rules cut), deepseek-v3's MLA (with an MLP, and with its MoE layers),
  rwkv6, jamba's mamba + attention -- in
  the normal layout (batch 4: rows over the data axes, KV sequence over
  ``model``) and with ``long_context`` (batch 1, KV sequence over every
  axis): every rank's logits equal the one-device decode's (f32
  weights and cache) of its own rows within ``atol = rtol = 2e-5`` (the
  log-sum-exp combine only reorders sums); the MoE config's against the
  one-device decode of the whole batch (its capacity dispatch runs on
  the data group's rows, so capacity and drops are the whole batch's);
  jamba within ``1e-4``: its
  mamba conv window is kept in bf16 (as the reference keeps it), so an
  f32 reordering that moves a value across a bf16 rounding boundary
  comes back 2^-9 relative (measured 5.5e-5 on the logits);
- each rank stores exactly its spec share of the cache and parameters,
  before and after the steps;
- no KV or latent cache is gathered, and no parameter over ``model``:
  each step's all-gathers are the parameter blocks' over the data axes
  only, the recurrent states' (rwkv's ``s`` of whole heads stays where
  it is stored), the MoE rows of the data group, and activations over
  ``model`` (the column products' outputs);
- ``launch.serve --mesh local`` on 4 ranks gives the one-process
  tokens, and ``--mesh single`` on 4 ranks refuses with a message that
  names the 256 ranks it needs.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import MeshLayout
from repro_torch.models import model as M
from repro_torch.serve.step import (ServeOptions, init_serve_cache,
                                    make_decode_step, mesh_decode_step)
from repro_torch.train import shard, sharding

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_decode_worker as worker  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
TOL_BF16_CARRY = dict(atol=1e-4, rtol=1e-4)       # jamba (see above)


def _spawn_all(tmp_path_factory) -> dict:
    """One spawn of 4 ranks and one of 8, running side by side."""
    runs = {}
    for n in (4, 8):
        tmp = tmp_path_factory.mktemp(f"mesh_decode{n}")
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


@pytest.fixture(scope="module")
def one_device():
    """The one-device decode's logits [B, STEPS, V] of every case, run
    on the rows a mesh rank holds (``rows`` at a time): at f32 a row's
    logits depend on the batch it is decoded in (jamba's bf16 conv
    window rounds the products' last bits apart: 7.7e-4 between batch 1
    and batch 4), so each rank is held to the decode of its own rows."""
    ref = {}
    for name, make in worker.CASES.items():
        cfg = make()
        model = M.from_state(cfg, worker.params_f32(cfg))
        dec = make_decode_step(cfg, ServeOptions())
        for long in (False, True):
            B = worker.batch_for(long)
            toks = worker.tokens(cfg, B)
            for rows in ((1, 2, 4) if not long else (1,)):
                parts = []
                for r0 in range(0, B, rows):
                    cache = init_serve_cache(cfg, rows, worker.MAX_LEN,
                                             dtype=torch.float32)
                    got = []
                    for i in range(worker.STEPS):
                        _, cache, last = dec(model, cache,
                                             toks[r0:r0 + rows, i:i + 1])
                        got.append(last)
                    parts.append(torch.stack(got, 1))
                ref[(name, long, rows)] = torch.cat(parts)
    return ref


def _layout(n, coords):
    shape, axes = worker.MESHES[n]
    return MeshLayout(shape, axes, coords=coords)


CASES = [(n, name, long) for n in (4, 8) for name in worker.CASES
         for long in (False, True)]


@pytest.mark.parametrize("n,name,long", CASES)
def test_mesh_decode_equals_one_device(outs, one_device, n, name, long):
    B = worker.batch_for(long)
    for o in outs[n]:
        mesh = _layout(n, o["coords"])
        got = o[(name, long)]["logits"]
        if not long:
            d = sharding.data_axes(mesh)
            rows = B // mesh.axis_size(d)
            r0 = mesh.axis_index(d) * rows
            whole = B if name == "mla_moe" else rows
            ref = one_device[(name, long, whole)][r0:r0 + rows]
        else:
            ref = one_device[(name, long, 1)]
        tol = TOL_BF16_CARRY if name == "jamba" else TOL
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **tol,
                                   err_msg=f"{name} long={long}")


@pytest.mark.parametrize("n,name,long", CASES)
def test_mesh_decode_stores_spec_share(outs, n, name, long):
    cfg = worker.CASES[name]()
    params = M.Model(cfg, device="meta").state_dict()
    B = worker.batch_for(long)
    full = init_serve_cache(cfg, B, worker.MAX_LEN, device="meta",
                            dtype=torch.float32)
    for o in outs[n]:
        mesh = _layout(n, o["coords"])
        pspec = sharding.param_specs(params, cfg, mesh)
        cspec = sharding.cache_specs(full, cfg, mesh, long_context=long)
        want_c = sum(sharding.shard_bytes(t.shape, 4 if t.dtype ==
                                          torch.float32 else 2, s, mesh)
                     for t, s in zip(sharding.flat_names(full).values(),
                                     sharding.flat_names(cspec).values())
                     if isinstance(t, torch.Tensor))
        want_p = sum(sharding.shard_bytes(params[k].shape, 4, s, mesh)
                     for k, s in pspec.items())
        r = o[(name, long)]
        assert r["stored"] == r["stored_after"] == want_c
        assert r["param_bytes"] == want_p
        assert want_c < sum(t.numel() * t.element_size() for t in
                            sharding.flat_names(full).values()
                            if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("n,name,long", CASES)
def test_mesh_decode_gathers_no_cache(outs, n, name, long):
    """Each step's all-gathers (counted from the plans on a layout):
    the parameter blocks' cuts over the data axes only (a cut over
    ``model`` stays where it is stored), the recurrent states' but
    rwkv's ``s``, the MoE layers' rows of the data group, and over
    ``model`` one activation a product of a kept block (the tied head's
    included) and one a layer whose ``s`` stays (its heads' output);
    nothing more: the KV / latent blocks never move.  Each gather over
    ``model`` (but a state's) holds at most the rank's rows times the
    widest such output, so no cache or parameter block passes as an
    activation.  All-reduces: the log-sum-exp combine's three a
    sequence-cut layer, one for each table looked up where it is
    stored and one for each expert stack run where it is stored."""
    cfg = worker.CASES[name]()
    params = M.Model(cfg, device="meta").state_dict()
    B = worker.batch_for(long)
    full = init_serve_cache(cfg, B, worker.MAX_LEN, device="meta",
                            dtype=torch.float32)
    mesh = _layout(n, None)
    step, (pspec, cspec) = mesh_decode_step(
        cfg, mesh, ServeOptions(long_context=long),
        {k: v.float() for k, v in params.items()}, full)
    plans = shard.plans_for(pspec, mesh, keep=lambda k, s: ("model",))
    n_param = sum(len(p.cuts) for p in plans.values())
    n_kept = sum(len(p.kept) for p in plans.values())
    n_state = n_seq = n_s = 0
    for layer in cspec["layers"]:
        seq = False
        for leaves in layer.values():
            for leaf, spec in leaves.items():
                if spec is None:
                    continue
                if leaf in ("k", "v", "ckv", "kr"):
                    seq |= any(mesh.shape[a] > 1
                               for a in sharding.entry_axes(spec[1]))
                elif leaf == "s":
                    n_s += any("model" in sharding.entry_axes(e)
                               for e in spec)
                else:
                    n_state += len(shard.ShardPlan(
                        (None,) + tuple(spec[1:]), mesh).cuts)
        n_seq += seq
    stack = (lambda k: ".moe.w_" in k and ".shared." not in k)
    kept = {k: params[k].shape[p.kept[0][0]] for k, p in plans.items()
            if p.kept and not stack(k)
            and (k != "embed" or cfg.tie_embeddings)}
    n_act = len(kept) + n_s
    widest = max(list(kept.values()) + [cfg.d_model])
    rows = B if long else B // mesh.axis_size(sharding.data_axes(mesh))
    d_axes = tuple(a for a in sharding.data_axes(mesh) if mesh.shape[a] > 1)
    n_moe = 0 if long else sum(1 for s in cfg.blocks() if s.ff == "moe")
    n_lookup = int(bool(plans["embed"].kept))
    n_experts = sum(1 for k, p in plans.items()
                    if k.endswith("moe.w_gate") and p.kept)
    for o in outs[n]:
        for log in o[(name, long)]["logs"]:
            gathers = [e for e in log if e[0] == "all-gather"]
            params_ = [e for e in gathers if e[5] == "param"]
            assert len(params_) == n_param
            assert all(set(e[4]) <= set(d_axes) for e in params_), params_
            assert sum(e[5] == "state" for e in gathers) == n_state
            acts = [e for e in gathers if e[5] == ""]
            # the MoE layers' rows over the data group, the rest the
            # column products' outputs over model
            assert sum(e[4] == d_axes for e in acts) == n_moe
            assert all(e[4] == d_axes or e[4] == ("model",) for e in acts)
            model = [e for e in gathers if "model" in (e[4] or ())
                     and e[5] != "state"]
            assert len(model) == n_act, (len(model), n_act)
            assert all(e[5] == "" and e[2] <= rows * widest * 4
                       for e in model), model
            kinds = [e[0] for e in log]
            assert kinds.count("all-reduce") == (3 * n_seq + n_lookup
                                                 + n_experts)
    assert n_seq > 0 or name == "rwkv"
    if name == "gemma2":
        assert n_param > 0 and n_kept > 0 and n_act > 0
    if name == "rwkv":
        assert n_s > 0


def test_launcher_mesh_local_equals_one_process(outs):
    want = launch_serve.main(worker.LAUNCH_ARGV)
    got = torch.cat([o["launch"] for o in outs[4]])       # (4, 1): rank r
    assert torch.equal(got, want)                         # holds row r


def test_launcher_mesh_single_refuses(outs):
    for o in outs[4]:
        assert o["refusal"] is not None
        assert "256 ranks" in o["refusal"]
        assert "has 4" in o["refusal"]
