"""The port's collective API end to end, held against the reference.

One ``torch.multiprocessing.spawn`` of 8 gloo ranks (``file://``
rendezvous in ``tmp_path``, no port) drives every ``mpix_*`` collective
on flat 8 ranks and on two pods of 4, over the point-to-point
(``dist``) and kernel transports and the native collective (``xla``),
in float32 and bfloat16 (tests/torch_dist_worker.py).  Each schedule
transport's output must be bitwise equal to the reference package's
``SimTransport.run_reference`` of the same global buffer; the native
collectives must be close to it; ``mpix_allreduce_rmsnorm`` must match
the reference's ``rmsnorm_allreduce_ref`` on both legs.  This is the
slice-as-a-whole test: topology, selector, builders, executor,
transports, kernels' plain versions and the API in one run.
"""
import os
import sys

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import selector as jselector
from repro.core.algorithms import REGISTRY as JREGISTRY
from repro.core.topology import Topology as JTopology
from repro.core.topology import flat_topology as jflat
from repro.core.transport import SimTransport as JSimTransport
from repro.kernels.rmsnorm import ops as jops

from repro_torch.core import api

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker  # noqa: E402

N = 8
JTOPOS = {"flat8": jflat(8), "2pod": JTopology(8, 4)}
SHAPES = {"allgather": (2, 3), "allreduce": (5, 3),
          "reduce_scatter": (16, 3), "alltoall": (16, 3)}


@pytest.fixture(scope="module")
def run8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_api")
    rng = np.random.default_rng(7)
    inputs = {c: rng.standard_normal((N,) + s).astype(np.float32)
              for c, s in SHAPES.items()}
    inputs["rmsnorm_x"] = rng.standard_normal((N, 4, 16)).astype(np.float32)
    inputs["rmsnorm_scale"] = (0.5 + 0.1 * rng.standard_normal(16)).astype(
        np.float32)
    inputs["global"] = rng.standard_normal((N, 8, 4, 3)).astype(np.float32)
    torch.multiprocessing.spawn(
        torch_dist_worker.run,
        args=(N, f"file://{tmp}/rendezvous", inputs, str(tmp)), nprocs=N,
        join=True)
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(N)]
    return inputs, outs


def _np_dtype(dtype):
    return ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.ascontiguousarray(x)
    return x.view(np.uint16 if x.dtype == ml_dtypes.bfloat16 else np.uint32)


def _reference(coll, topo_name, dtype, xs):
    """Per-rank expected outputs: the reference schedule (the same
    algorithm the port resolved) run by ``run_reference`` on the global
    buffer the API builds."""
    jt = JTOPOS[topo_name]
    dt = _np_dtype(dtype)
    xs = xs.astype(dt)
    algo = torch_dist_worker.ALGOS[topo_name]
    if algo == "auto":
        algo = jselector.select(coll, jt, xs[0].size * xs.itemsize,
                                policy="model")
    sched = JREGISTRY[coll][algo](jt)
    ref = JSimTransport(N).run_reference
    if coll == "allgather":
        buf = np.zeros((N, N) + xs.shape[1:], dt)
        for r in range(N):
            buf[r, r] = xs[r]
        out = ref(sched, buf)
        return [out[r].reshape((-1,) + xs.shape[2:]) for r in range(N)]
    if coll == "allreduce":
        size = xs[0].size
        chunk = -(-size // N)
        buf = np.zeros((N, N * chunk), dt)
        buf[:, :size] = xs.reshape(N, -1)
        out = ref(sched, buf.reshape(N, N, chunk))
        return [out[r].reshape(-1)[:size].reshape(xs.shape[1:])
                for r in range(N)]
    blocks = xs.reshape((N, N, -1) + xs.shape[2:])
    if coll == "reduce_scatter":
        out = ref(sched, blocks)
        return [out[r][r] for r in range(N)]
    pad = np.zeros((N, sched.num_slots - N) + blocks.shape[2:], dt)
    out = ref(sched, np.concatenate([blocks, pad], axis=1))
    return [out[r][: sched.result_slots].reshape(xs.shape[1:])
            for r in range(N)]


@pytest.mark.parametrize("topo_name", list(JTOPOS))
@pytest.mark.parametrize("coll", list(SHAPES))
def test_mpix_collectives_bitwise_vs_reference(run8, coll, topo_name):
    inputs, outs = run8
    for dtype in ("float32", "bfloat16"):
        want = _reference(coll, topo_name, dtype, inputs[coll])
        for tr in ("dist", "kernel"):
            for r in range(N):
                got = outs[r][(topo_name, coll, dtype, tr)]
                np.testing.assert_array_equal(
                    _bits(got), _bits(want[r]),
                    err_msg=f"{coll} {topo_name} {dtype} {tr} rank {r}")
    want = _reference(coll, topo_name, "float32", inputs[coll])
    for r in range(N):
        got = outs[r][(topo_name, coll, "float32", "xla")]
        np.testing.assert_allclose(got.numpy(), want[r], rtol=1e-5,
                                   atol=1e-5)


def test_mpix_allreduce_rmsnorm_both_legs(run8):
    inputs, outs = run8
    parts = jnp.asarray(inputs["rmsnorm_x"])
    scale = jnp.asarray(inputs["rmsnorm_scale"])
    for gemma in (False, True):
        want = np.asarray(jops.rmsnorm_allreduce_ref(
            parts, scale, eps=1e-6, gemma_style=gemma))
        for tr in ("kernel", "dist"):
            for r in range(N):
                got = outs[r][("rmsnorm", tr, gemma)]
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                           atol=1e-5,
                                           err_msg=f"{tr} gemma={gemma}")


def test_transport_entry_points_over_the_group(run8):
    """DistTransport.run_global is the SimTransport calling convention
    over the group; row-chunked runs of both transports reassemble (or
    fold) to the unchunked result bit for bit."""
    inputs, outs = run8
    sched = JREGISTRY["allreduce"]["ring_rs_ag"](jflat(N))
    want = JSimTransport(N).run_reference(sched, inputs["global"])
    for r in range(N):
        np.testing.assert_array_equal(_bits(outs[r]["dist_run_global"]),
                                      _bits(want))
        for key in ("dist_run_chunked", "kernel_run_chunked"):
            np.testing.assert_array_equal(_bits(outs[r][key]),
                                          _bits(want[r]), err_msg=key)
        pieces = outs[r]["kernel_run_chunked_consume"]
        np.testing.assert_array_equal(
            _bits(torch.cat(pieces, dim=1)), _bits(want[r]))


def test_bad_options_raise_before_any_group_use():
    """No process group exists in this process: a bad transport name,
    a bad resilience= and a mismatched topology all fail on their own
    terms, never on the missing group; transport="auto" is a known name
    now (the tuner resolves it), so it reaches the missing group."""
    assert not torch.distributed.is_initialized()
    x = torch.zeros(8, 2)
    for fn in (api.mpix_allgather, api.mpix_allreduce,
               api.mpix_reduce_scatter, api.mpix_alltoall):
        with pytest.raises(ValueError, match="unknown transport"):
            fn(x, None, transport="shardmap")
        with pytest.raises(ValueError, match="process group"):
            fn(x, None, transport="auto")
        with pytest.raises(ValueError, match="resilience preset"):
            fn(x, None, resilience="sideways")
    with pytest.raises(ValueError, match="unknown transport"):
        api.mpix_allreduce_rmsnorm(x, None, torch.ones(2),
                                   transport="pallas")
    with pytest.raises(ValueError, match="policy"):
        api.set_default_policy("fastest")
    assert api.get_default_policy() == "model"
