"""Compute on the model axis: the sequence-split train step, decode with
parameter blocks that stay where they are stored, and the flash kernel's
query offset.

One spawn of 4 gloo ranks ((1, 4) over ``("data", "model")``) and one of
8 ((2, 2, 2) over ``("pod", "data", "model")``), side by side
(tests/torch_model_axis_worker.py), for a gemma2-style stack (GQA,
window 4 across the rank boundaries, softcaps), deepseek's MLA with MoE
layers under ``mpix_ep``, rwkv6, jamba's mamba + attention, whisper
(30 encoder frames: they divide a model axis of 2, not one of 4, where
the encoder runs whole on every model rank) and qwen2-vl (M-RoPE, a
vision prefix):

- two steps of the sequence-split step equal two steps of the
  one-device step (``make_train_step`` with no mesh, the whole batch)
  at tests/test_torch_sharded_step.py's tolerances: loss within 1e-2,
  grad norm ``rtol 1e-3``, every parameter ``atol 1e-2`` and ``mu``
  ``atol 1e-4``.  The weights are f32: in bf16 each model rank rounds
  its partial weight gradient (over its S/n rows) where the one-device
  step rounds the whole sum once, which moves the grad norm by
  0.13-0.25% (rwkv6 after the first update); in f32 the two steps'
  losses and grad norms agree to about 1e-7.  The MoE case runs its
  capacity dispatch at a capacity that drops no pair (E / k), so the
  one-device yardstick is the dense dispatch;
- at a capacity that drops pairs (1.0), on 2 rows a data rank, the MoE
  case's split step equals the unsplit step on the same mesh at the
  same tolerances, and drops as many pairs: the dispatch's relayout
  gives each model rank the unsplit step's token slice (half a row on
  (1, 4), a whole row on (2, 2, 2), neither its sequence block), so
  the capacity and the drops are the same;
- each rank's attention ran S/n query rows against the S keys (whisper's
  encoder, where 30 frames do not divide 4, its whole 30);
- the mesh decode equals the one-device decode of the rank's rows at
  tests/test_torch_mesh_decode.py's tolerances (f32: ``2e-5``; jamba's
  bf16 conv window ``1e-4``), and, on 4 ranks, a view in which every
  parameter whose cut dim divides the model axis is a ``Resident`` block
  decodes as the plain model does (``2e-5``): the column products, the
  vocab-cut
  lookup and tied head, rwkv's ``mu`` mix, mamba's conv and ``A_log``
  state update, the router's logits and the expert blocks;
- the decode's record gathers parameters over the data axes only (none
  over ``model``), and under ``mpix_ep`` no expert stack is gathered
  over its EP axes: each rank gathers its EP block over ``data``;
- the launchers with ``--mesh local --model-axis``: ``launch.train`` on
  (2, 2) (bf16, the split fsdp step) gives the one-process run's losses
  within 1e-2 (tests/test_torch_train_launcher.py's tolerance), and
  ``launch.serve`` on (1, 4) the one-process tokens exactly.

tests/test_torch_model_axis_jax.py holds the split forward against the
JAX package's ``forward``.

In this process, without ranks: the flash op's plain version with a
query offset equals rows [q_start, q_start + Sq) of the JAX package's
flash attention (its Pallas kernel in interpret mode) on all Sq keys,
at the reference's kernel tolerances (f32 ``3e-5``, bf16 ``2e-2``);
``tile_classes`` with an offset against a brute-force mask; a layout's
collectives on a real device return the finite stand-ins
``train.comm`` states, and ``gather_seq``'s gradient is the group's sum.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.attention import ops as jops

from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.kernel import tile_classes
from repro_torch.launch.mesh import MeshLayout
from repro_torch.models import model as M
from repro_torch.serve.step import (ServeOptions, init_serve_cache,
                                    make_decode_step)
from repro_torch.train import comm, sharding
from repro_torch.train.moe_dispatch import ep_axes_for
from repro_torch.train.step import make_train_step

sys.path.insert(0, os.path.dirname(__file__))
import torch_model_axis_worker as worker  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
TOL_BF16_CARRY = dict(atol=1e-4, rtol=1e-4)
F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _one_device():
    """Two one-device steps of every case on the whole batch (the MoE
    case on the dense dispatch: at its capacity no pair drops)."""
    ref = {}
    for name, (make, moe_mode, _) in worker.CASES.items():
        cfg = make()
        opts = worker.opts_for(name)
        if moe_mode == "mpix_ep":
            opts = worker.opts_for(name, moe_mode="dense")
        st = worker.train_state(cfg, opts)
        step = make_train_step(cfg, None, opts)
        loss, norm = [], []
        for seed in (1, 2):
            st, m = step(st, worker.batch(name, cfg, seed))
            loss.append(float(m["loss"]))
            norm.append(float(m["grad_norm"]))
        ref[name] = {"loss": loss, "grad_norm": norm, "params":
                     st["params"], "mu": st["opt"]["mu"]}
    return ref


def _one_device_decode():
    """The one-device decode's logits of every case, by rows held."""
    ref = {}
    for name, (make, _, _) in worker.CASES.items():
        cfg = make()
        model = M.from_state(cfg, worker.params_f32(cfg))
        dec = make_decode_step(cfg, ServeOptions())
        toks = worker.dec_tokens(cfg)
        for rows in (1, worker.DEC_B):
            parts = []
            for r0 in range(0, worker.DEC_B, rows):
                cache = init_serve_cache(cfg, rows, worker.DEC_LEN,
                                         dtype=torch.float32)
                cross = worker._cross(cfg, model, r0, rows)
                got = []
                for i in range(worker.DEC_STEPS):
                    _, cache, last = dec(model, cache,
                                         toks[r0:r0 + rows, i:i + 1], cross)
                    got.append(last)
                parts.append(torch.stack(got, 1))
            ref[(name, rows)] = torch.cat(parts)
    return ref


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One spawn of 4 ranks and one of 8, side by side; the one-device
    yardsticks run here while they do."""
    runs = {}
    for n in (4, 8):
        tmp = tmp_path_factory.mktemp(f"model_axis{n}")
        ctx = torch.multiprocessing.start_processes(
            worker.run, args=(n, f"file://{tmp}/rendezvous", str(tmp)),
            nprocs=n, join=False, start_method="spawn")
        runs[n] = (ctx, tmp)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = {"train": _one_device(), "decode": _one_device_decode()}
    finally:
        torch.set_num_threads(n_threads)
    for ctx, _ in runs.values():
        while not ctx.join():
            pass
    return {n: [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(n)] for n, (_, tmp) in runs.items()}, ref


@pytest.fixture(scope="module")
def outs(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def one_device(spawned):
    return spawned[1]["train"]


@pytest.fixture(scope="module")
def one_device_decode(spawned):
    return spawned[1]["decode"]


CASES = [(n, c) for n in (4, 8) for c in worker.CASES]


def _layout(n, coords=None):
    shape, axes = worker.MESHES[n]
    return MeshLayout(shape, axes, coords=coords)


@pytest.mark.parametrize("n,case", CASES)
def test_split_step_equals_one_device(outs, one_device, n, case):
    for o in outs[n]:
        _held(o[case]["train"], one_device[case])


def _held(r, want):
    """Two steps held to two others: loss within 1e-2, grad norm rtol
    1e-3, parameters atol 1e-2, ``mu`` atol 1e-4."""
    for a, b in zip(r["loss"], want["loss"]):
        assert abs(a - b) < 1e-2, (a, b)
    np.testing.assert_allclose(r["grad_norm"], want["grad_norm"], rtol=1e-3)
    for k, v in want["params"].items():
        np.testing.assert_allclose(r["params"][k].float().numpy(),
                                   v.float().numpy(), atol=1e-2, err_msg=k)
        np.testing.assert_allclose(r["mu"][k].numpy(), want["mu"][k].numpy(),
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("n", (4, 8))
def test_split_step_keeps_the_unsplit_drops(outs, n):
    m = worker.MESHES[n][0][-1]
    for o in outs[n]:
        got, want = o["drops"][True], o["drops"][False]
        assert set(got["calls"]) == {(worker.S // m, worker.S)}
        assert set(want["calls"]) == {(worker.S, worker.S)}
        # the capacity binds, and the same pairs drop
        assert got["dropped"] == want["dropped"] > 0
        _held(got, want)


@pytest.mark.parametrize("n,case", CASES)
def test_split_step_same_on_every_rank(outs, n, case):
    first = outs[n][0][case]["train"]
    for o in outs[n][1:]:
        r = o[case]["train"]
        assert r["loss"] == first["loss"]
        for k, v in first["params"].items():
            assert torch.equal(r["params"][k], v), k


@pytest.mark.parametrize("n,case", CASES)
def test_attention_runs_the_ranks_rows(outs, n, case):
    cfg = worker.CASES[case][0]()
    m = worker.MESHES[n][0][-1]
    want = {(worker.S // m, worker.S)}
    if cfg.encoder is not None:
        f = cfg.encoder.n_frames
        want |= {(worker.S // m, f), (f // m, f) if f % m == 0 else (f, f)}
    for o in outs[n]:
        calls = set(o[case]["train"]["calls"])
        if cfg.attn is None and cfg.mla is None:
            assert calls == set()
        else:
            assert calls == want, calls


@pytest.mark.parametrize("n,case", CASES)
def test_mesh_decode_equals_one_device(outs, one_device_decode, n, case):
    tol = TOL_BF16_CARRY if case == "jamba" else TOL
    for o in outs[n]:
        mesh = _layout(n, o["coords"])
        d = sharding.data_axes(mesh)
        rows = worker.DEC_B // mesh.axis_size(d)
        r0 = mesh.axis_index(d) * rows
        whole = worker.DEC_B if case == "mla_moe" else rows
        want = one_device_decode[(case, whole)][r0:r0 + rows]
        np.testing.assert_allclose(o[case]["decode"]["logits"].numpy(),
                                   want.numpy(), **tol, err_msg=case)


@pytest.mark.parametrize("case", worker.CASES)
def test_resident_view_decodes_as_the_model(outs, case):
    for o in outs[4]:
        r = o[case]["resident"]
        assert r["n_resident"] > 0
        tol = TOL_BF16_CARRY if case == "jamba" else TOL
        np.testing.assert_allclose(r["got"].numpy(), r["want"].numpy(),
                                   **tol, err_msg=case)


@pytest.mark.parametrize("n,case", CASES)
def test_decode_gathers_no_parameter_over_model(outs, n, case):
    d_axes = tuple(a for a in sharding.data_axes(_layout(n))
                   if _layout(n).shape[a] > 1)
    for o in outs[n]:
        for log in o[case]["decode"]["logs"]:
            params = [e for e in log if e[0] == "all-gather"
                      and e[5] == "param"]
            assert all(set(e[4]) <= set(d_axes) for e in params), params
            acts = [e for e in log if e[0] == "all-gather" and e[5] == ""]
            assert any(e[4] == ("model",) for e in acts)


@pytest.mark.parametrize("n", (4, 8))
def test_mpix_ep_gathers_no_expert_stack(outs, n):
    cfg = worker.mla_moe_cfg()
    mesh = _layout(n)
    ep = ep_axes_for(cfg.moe, mesh)
    moe = cfg.moe
    stack = moe.n_experts * cfg.d_model * moe.d_expert * 4       # f32
    block = stack // mesh.axis_size(ep)
    for o in outs[n]:
        log = o["mla_moe"]["train"]["log"]
        params = [e for e in log if e[0] == "all-gather" and e[5] == "param"]
        # an expert block is gathered over ``data`` (where it is cut) to
        # the EP block, never over its EP axes to more experts
        assert not any(e[2] in (stack, 2 * block) for e in params)
        got = [e for e in params if e[2] == block]
        if mesh.shape["data"] > 1:
            assert got and all(e[4] == ("data",) for e in got)
        else:
            assert not got


def test_launchers_with_a_model_axis(outs):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    one = launch_train.main(worker.TRAIN_ARGV)
    for o in outs[4]:
        assert o["launch_train"] == outs[4][0]["launch_train"]
        np.testing.assert_allclose(o["launch_train"], one.losses, atol=1e-2)
    want = launch_serve.main(worker.SERVE_ARGV)
    for o in outs[4]:                               # (1, 4): every row
        assert torch.equal(o["launch_serve"], want)


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------


OFFSET_CASES = [
    # (dtype, B, S, H, K, D, n, window, softcap)
    ("float32", 2, 128, 4, 2, 32, 4, None, None),
    ("float32", 1, 128, 4, 1, 16, 4, 20, 30.0),
    ("bfloat16", 2, 128, 4, 2, 32, 2, None, None),
    ("bfloat16", 1, 256, 2, 2, 64, 4, 40, 50.0),
]


@pytest.mark.parametrize("dtype,B,S,H,K,D,n,window,cap", OFFSET_CASES)
def test_offset_flash_equals_jax_rows(dtype, B, S, H, K, D, n, window, cap):
    import ml_dtypes
    rng = np.random.default_rng(S + D + n)
    npd = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    q = rng.normal(size=(B, S, H, D)).astype(npd)
    k = rng.normal(size=(B, S, K, D)).astype(npd)
    v = rng.normal(size=(B, S, K, D)).astype(npd)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, window, cap,
        None, 32, 32), np.float32)
    tol = F32 if dtype == "float32" else BF16
    blk = S // n
    for r in range(n):
        got = ops.flash_attention(
            tensor_from_numpy(q[:, r * blk:(r + 1) * blk]),
            tensor_from_numpy(k), tensor_from_numpy(v), True, window, cap,
            None, 32, 32, q_start=r * blk)
        np.testing.assert_allclose(got.float().numpy(),
                                   want[:, r * blk:(r + 1) * blk], **tol,
                                   err_msg=f"block {r}")


def test_offset_flash_gradient_is_the_rows():
    """The backward's plain recompute takes the offset: the gradients of
    the blocks sum to the whole call's (k, v) and are its rows (q)."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((1, 64, 2, 16), (1, 64, 1, 16), (1, 64, 1, 16)))
    g = torch.from_numpy(rng.normal(size=(1, 64, 2, 16)).astype(np.float32))
    whole = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.flash_attention(*whole, True, 24, 30.0, None, 16, 16).backward(g)
    kv = [t.clone().requires_grad_() for t in (k, v)]
    qs = []
    for r in range(4):
        qb = q[:, 16 * r:16 * (r + 1)].clone().requires_grad_()
        ops.flash_attention(qb, *kv, True, 24, 30.0, None, 16, 16,
                            q_start=16 * r).backward(g[:, 16 * r:16 * (r + 1)])
        qs.append(qb.grad)
    np.testing.assert_allclose(torch.cat(qs, 1).numpy(),
                               whole[0].grad.numpy(), atol=1e-5, rtol=1e-5)
    for a, b in zip(kv, whole[1:]):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("Sq,Sk,q_start,bq,bk,causal,window", [
    (512, 2048, 1536, 128, 128, True, None),
    (512, 2048, 512, 128, 128, True, 300),
    (2048, 8192, 6144, 128, 64, True, 4096),
    (256, 1024, 768, 128, 128, False, 100),
    (100, 400, 300, 64, 64, True, 7),
])
def test_tile_classes_with_offset(Sq, Sk, q_start, bq, bk, causal, window):
    """Per q tile: skipped kv tiles hold only masked scores, the interior
    ones only live scores (by position q_start + t); a tile with a row
    that sees no key visits every kv tile."""
    t = q_start + np.arange(Sq)[:, None]
    u = np.arange(Sk)[None, :]
    live = np.ones((Sq, Sk), dtype=bool)
    if causal:
        live &= u <= t
    if window is not None:
        live &= u > t - window
    nk = -(-Sk // bk)
    for qt, (j_lo, j_hi, i_lo, i_hi) in enumerate(
            tile_classes(Sq, Sk, bq, bk, causal, window, q_start)):
        rows = live[qt * bq:(qt + 1) * bq]
        if not rows.any(axis=1).all():
            assert (j_lo, j_hi) == (0, nk)
        for j in range(nk):
            block = rows[:, j * bk:(j + 1) * bk]
            if not j_lo <= j < j_hi:
                assert not block.any(), (qt, j)
            whole = (j + 1) * bk <= Sk
            assert (i_lo <= j < i_hi) == (whole and bool(block.all())), \
                (qt, j)


def test_layout_stand_ins_are_finite():
    """A layout's collectives on a real device (here the CPU) return the
    stand-ins of ``train.comm``; on ``meta`` they stay empty."""
    mesh = MeshLayout((2, 4), ("data", "model"),
                      coords={"data": 1, "model": 2})
    g = mesh.group("model")
    x = torch.arange(8.0).reshape(2, 4)
    assert torch.equal(comm.all_gather(x, g, 1), torch.cat([x] * 4, 1))
    assert torch.equal(comm.reduce_scatter(x, g, 1), 4 * x[:, 2:3])
    assert torch.equal(comm.all_reduce(x, g), 4 * x)
    assert torch.equal(comm.all_reduce(x, g, op="max"), x)
    assert torch.equal(comm.all_to_all(torch.arange(8.0), g),
                       torch.arange(8.0))
    assert torch.equal(comm.all_to_all(torch.arange(4.0), g, [1, 1, 2, 0],
                                       [2, 2, 1, 1]),
                       torch.tensor([0.0, 1.0, 2.0, 3.0, 0.0, 1.0]))
    y = x.clone().requires_grad_()
    comm.gather_seq(y, g, 1).sum().backward()
    assert torch.equal(y.grad, torch.full_like(x, 4.0))
    kinds = [e[0] for e in mesh.log]
    assert kinds[:6] == ["all-gather", "reduce-scatter", "all-reduce",
                         "all-reduce", "all-to-all", "all-to-all"]
    # wire bytes: the rows sent to the other ranks
    assert [e[3] for e in mesh.log[4:6]] == [24.0, 8.0]
    assert all(e[4] == ("model",) for e in mesh.log)
    meta = comm.all_gather(torch.empty(2, 4, device="meta"), g, 0)
    assert meta.device.type == "meta" and meta.shape == (8, 4)
    for t in (comm.all_gather(x, g), comm.all_reduce(x, g)):
        assert torch.isfinite(t).all()
