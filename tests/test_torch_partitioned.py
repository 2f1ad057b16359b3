"""The port's partitioned runtime forms on 8 gloo ranks, held against the
reference package on the same seeded inputs
(tests/device_scripts/check_partitioned.py's checks).

The port runs in one ``torch.multiprocessing.spawn`` of 8 gloo ranks
(tests/torch_partitioned_worker.py); the reference runs its shard_map
forms in a subprocess with 8 host CPU devices, as its own device
scripts run.  Where nothing is summed the results must be bitwise equal
(``partitioned_ppermute`` for every partition count and both ``via``s,
equal to the monolithic shift and to each other; the layout of
``allgather_matmul``); where a matmul or a sum changes the add order,
within ``rtol`` 1e-5 on random floats and bitwise on integer-valued
inputs.  The 1-partition exchange is one ``batch_isend_irecv``, as the
monolithic transfer is.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.algorithms import partitioned as jpc

from repro_torch.core.algorithms import partitioned as pc

sys.path.insert(0, os.path.dirname(__file__))
import torch_partitioned_worker  # noqa: E402

N = 8
PARTS = torch_partitioned_worker.PARTS
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")

# the reference's forms under shard_map on 8 host devices, on the
# parent's inputs (check_partitioned.py's specs)
REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core.algorithms import partitioned as pc

N = 8
mesh = compat.make_mesh((N,), ("data",))
inp = dict(np.load(sys.argv[1]))
perm = [(i, (i + 1) % N) for i in range(N)]
out = {}


def sm(fn, in_specs, out_specs, *args):
    f = jax.jit(compat.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))
    with compat.set_mesh(mesh):
        return jax.tree.map(np.asarray, f(*args))


for kind in ("float", "int"):
    x = inp[f"x_{kind}"]
    for p in (1, 2, 4, 8):
        for via in ("scan", "schedule"):
            out[f"ppermute_{kind}_{p}_{via}"] = sm(
                lambda v, p=p, via=via: pc.partitioned_ppermute(
                    v, "data", perm, p, via=via), P("data"), P("data"), x)
    out[f"consume_{kind}"] = sm(
        lambda v: pc.partitioned_ppermute(
            v, "data", perm, 4, consume=lambda c, chunk: c + chunk.sum(0),
            init=jnp.zeros(x.shape[1:], jnp.float32)),
        P("data"), P("data"), x)
    for parts in (1, 2):
        out[f"allgather_matmul_{kind}_{parts}"] = sm(
            lambda v, w, parts=parts: pc.allgather_matmul(
                v, w, "data", partitions_per_rank=parts),
            (P("data"), P()), P(), inp[f"xg_{kind}"], inp[f"w_{kind}"])
    out[f"matmul_reduce_scatter_{kind}"] = sm(
        lambda v, w: pc.matmul_reduce_scatter(v, w, "data"),
        (P(None, "data"), P("data")), P("data"), inp[f"xr_{kind}"],
        inp[f"wr_{kind}"])
    tree = {"a": inp[f"a_{kind}"], "b": inp[f"b_{kind}"]}
    got = sm(lambda t: pc.bucketed_psum(t, "data", buckets=3), P("data"),
             P(), tree)
    out[f"bucketed_psum_a_{kind}"] = got["a"]
    out[f"bucketed_psum_b_{kind}"] = got["b"]
np.savez(sys.argv[2], **out)
'''


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    shapes = {"x": (N * 16, 4), "xg": (N * 8, 16), "w": (16, 12),
              "xr": (N * 4, N * 16), "wr": (N * 16, 10), "a": (N, 33),
              "b": (N, 5, 7)}
    inputs = {}
    for name, shape in shapes.items():
        f = rng.standard_normal(shape).astype(np.float32)
        f.reshape(-1)[::9] = -0.0
        inputs[f"{name}_float"] = f
        inputs[f"{name}_int"] = rng.integers(-4, 5, shape).astype(
            np.float32)
    return inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_partitioned")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "inputs.npz"),
         str(tmp / "reference.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        torch.multiprocessing.spawn(
            torch_partitioned_worker.run,
            args=(N, f"file://{tmp}/rendezvous", inputs, str(tmp)),
            nprocs=N, join=True)
    finally:
        log, _ = ref.communicate(timeout=300)
    assert ref.returncode == 0, log[-4000:]
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(N)]
    return inputs, outs, dict(np.load(tmp / "reference.npz"))


def _cat(outs, key):
    return torch.cat([o[key] for o in outs]).numpy()


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("via", ["p2p", "schedule"])
@pytest.mark.parametrize("parts", PARTS)
def test_partitioned_ppermute_bitwise(runs, parts, via, kind):
    """Every partition count and both routes: bitwise the reference's,
    the monolithic shift's and the 1-partition result's."""
    inputs, outs, ref = runs
    got = _cat(outs, ("ppermute", kind, parts, via))
    x = inputs[f"x_{kind}"].reshape(N, 16, 4)
    shift = x[[(i - 1) % N for i in range(N)]].reshape(N * 16, 4)
    assert got.tobytes() == shift.tobytes()
    for jvia in ("scan", "schedule"):
        assert got.tobytes() == ref[f"ppermute_{kind}_{parts}_{jvia}"]\
            .tobytes()
    assert got.tobytes() == _cat(outs, ("ppermute", kind, 1, "p2p"))\
        .tobytes()


@pytest.mark.parametrize("parts", PARTS)
def test_one_exchange_per_partition(runs, parts):
    """The p2p route posts one ``batch_isend_irecv`` per partition (the
    1-partition case is the monolithic transfer's single exchange); the
    schedule route one per compiled round."""
    _, outs, _ = runs
    for o in outs:
        assert o["exchanges", "float", parts, "p2p"] == parts
        assert 1 <= o["exchanges", "float", parts, "schedule"] <= parts


@pytest.mark.parametrize("kind", ["float", "int"])
def test_early_bird_consume(runs, kind):
    inputs, outs, ref = runs
    got = np.stack([o["consume", kind].numpy() for o in outs])
    want = ref[f"consume_{kind}"].reshape(N, 4)
    x = inputs[f"x_{kind}"].reshape(N, 16, 4)
    shift = x[[(i - 1) % N for i in range(N)]]
    if kind == "int":
        assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, shift.sum(1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("parts", [1, 2])
def test_allgather_matmul(runs, parts, kind):
    """On every rank: all_gather(x) @ w in the unfused op's layout —
    bitwise the port's own product of the gathered rows, and the
    reference's to rtol 1e-5 (bitwise on integer values)."""
    inputs, outs, ref = runs
    xg, w = inputs[f"xg_{kind}"], inputs[f"w_{kind}"]
    plain = torch.cat([torch.from_numpy(c) @ torch.from_numpy(w)
                       for c in np.split(xg, N)]).numpy()
    want = ref[f"allgather_matmul_{kind}_{parts}"]
    for o in outs:
        got = o["allgather_matmul", kind, parts].numpy()
        assert got.shape == (N * 8, 12)
        assert got.tobytes() == plain.tobytes()
        if kind == "int":
            assert got.tobytes() == want.tobytes()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["float", "int"])
def test_matmul_reduce_scatter(runs, kind):
    inputs, outs, ref = runs
    got = _cat(outs, ("matmul_reduce_scatter", kind))
    want = ref[f"matmul_reduce_scatter_{kind}"]
    if kind == "int":
        assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        got, inputs[f"xr_{kind}"] @ inputs[f"wr_{kind}"], rtol=1e-4,
        atol=1e-3)


@pytest.mark.parametrize("kind", ["float", "int"])
def test_bucketed_psum(runs, kind):
    """Dict (sorted keys, as the reference's tree) and list trees: the
    per-tensor sums over the group on every rank."""
    inputs, outs, ref = runs
    for o in outs:
        got = o["bucketed_psum", kind]
        assert list(got) == ["a", "b"]
        lst = o["bucketed_psum_list", kind]
        assert isinstance(lst, list) and len(lst) == 2
        for name, t in (("a", got["a"]), ("b", got["b"]), ("a", lst[0]),
                        ("b", lst[1])):
            want = ref[f"bucketed_psum_{name}_{kind}"]
            assert t.shape == want.shape
            if kind == "int":
                assert t.numpy().tobytes() == want.tobytes()
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(
                t.numpy(), inputs[f"{name}_{kind}"].sum(0, keepdims=True),
                rtol=1e-5, atol=1e-5)


def test_matmul_reduce_scatter_validates_rows(runs):
    _, outs, _ = runs
    for o in outs:
        assert "must be divisible by the group size 8" in o["mrs_error"]


def test_partitioned_validation():
    """tests/test_pipelined.py's validation errors, raised before any
    group is touched, with the reference's messages."""
    perm8 = [(i, (i + 1) % 8) for i in range(8)]
    for p in (0, -2):
        with pytest.raises(ValueError) as ei:
            pc.partitioned_schedule(8, perm8, p)
        with pytest.raises(ValueError) as ej:
            jpc.partitioned_schedule(8, perm8, p)
        assert str(ei.value) == str(ej.value)
    x = torch.zeros(12, 4)
    perm = [(i, (i + 1) % 4) for i in range(4)]
    for p in (0, 5):
        with pytest.raises(ValueError) as ei:
            pc.partitioned_ppermute(x, None, perm, p)
        with pytest.raises(ValueError) as ej:
            jpc.partitioned_ppermute(jnp.zeros((12, 4)), "data", perm, p)
        assert str(ei.value) == str(ej.value)
    with pytest.raises(ValueError, match="unknown via"):
        pc.partitioned_ppermute(x, None, perm, 2, via="scan")
    with pytest.raises(ValueError, match="buckets"):
        pc.bucketed_psum([x], None, buckets=0)
    assert pc.bucketed_psum({}, None) == {}
