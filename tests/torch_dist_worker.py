"""One rank of the port's multi-process API test (tests/test_torch_api.py).

Spawned by ``torch.multiprocessing.spawn``: joins an n-rank gloo group
through a ``file://`` rendezvous, drives every ``mpix_*`` collective of
``repro_torch`` on its local inputs, and saves what each call returned
for the parent to compare with the reference package.  Imports torch
and the port only.
"""
import torch
import torch.distributed as dist

from repro_torch.core import api
from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.topology import Topology, flat_topology
from repro_torch.core.transport import DistTransport, KernelTransport

TOPOS = {"flat8": lambda: flat_topology(8), "2pod": lambda: Topology(8, 4)}
# algorithm per topology: the selector's choice on one pod, the
# two-level builders on two pods
ALGOS = {"flat8": "auto", "2pod": "hierarchical"}
COLLECTIVES = {
    "allgather": api.mpix_allgather,
    "allreduce": api.mpix_allreduce,
    "reduce_scatter": api.mpix_reduce_scatter,
    "alltoall": api.mpix_alltoall,
}


def run(rank: int, n: int, init: str, inputs: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    try:
        results = _drive(rank, n, inputs)
    finally:
        dist.destroy_process_group()
    torch.save(results, f"{out_dir}/rank{rank}.pt")


def _local(inputs: dict, key: str, rank: int, dtype) -> torch.Tensor:
    return torch.from_numpy(inputs[key][rank]).to(dtype)


def _drive(rank: int, n: int, inputs: dict) -> dict:
    group = dist.new_group(list(range(n)))
    out = {}
    for topo_name, make in TOPOS.items():
        topo = make()
        for coll, fn in COLLECTIVES.items():
            for dtype in (torch.float32, torch.bfloat16):
                x = _local(inputs, coll, rank, dtype)
                transports = ("dist", "kernel", "xla")
                if dtype == torch.bfloat16:
                    transports = ("dist", "kernel")
                for tr in transports:
                    algo = "xla" if tr == "xla" else ALGOS[topo_name]
                    y = fn(x, group, algorithm=algo, topo=topo,
                           transport="dist" if tr == "xla" else tr)
                    out[(topo_name, coll, str(dtype)[6:], tr)] = y
    # the fused epilogue: both legs, plain and gemma-style
    x = _local(inputs, "rmsnorm_x", rank, torch.float32)
    scale = torch.from_numpy(inputs["rmsnorm_scale"])
    for tr in ("kernel", "dist"):
        for gemma in (False, True):
            out[("rmsnorm", tr, gemma)] = api.mpix_allreduce_rmsnorm(
                x, group, scale, gemma_style=gemma, transport=tr)
    # transport entry points beside the api: the global calling
    # convention and row-chunked runs, for the parent's bitwise checks
    topo = flat_topology(n)
    sched = REGISTRY["allreduce"]["ring_rs_ag"](topo)
    gbuf = torch.from_numpy(inputs["global"])
    out["dist_run_global"] = DistTransport(n, group, topo).run_global(
        sched, gbuf)
    local = gbuf[rank]
    out["dist_run_chunked"] = DistTransport(n, group, topo).run_chunked(
        sched, local, chunks=2)
    out["kernel_run_chunked"] = KernelTransport(n, group, topo).run_chunked(
        sched, local, chunks=2)
    out["kernel_run_chunked_consume"] = KernelTransport(
        n, group, topo).run_chunked(
            sched, local, chunks=2, init=[],
            consume=lambda carry, o, i: carry + [o])
    return out
