"""One rank of the port's neighbor-collective test
(tests/test_torch_neighbor_api.py).

Spawned by ``torch.multiprocessing.spawn``: joins an n-rank gloo group
through a ``file://`` rendezvous and drives ``mpix_neighbor_alltoallv``
(both plan modes, both transports), ``mpix_alltoall_overlap`` (chunks
1/2/4 and the model's pick) and the KV transfer path over the ``dist``
transport (one batch through ``run_transfer``, then a whole engine
trace), saving what each returned for the parent to compare with the
reference package.  Imports torch and the port only.
"""
import torch
import torch.distributed as dist

from repro_torch.core import api, kvtransfer
from repro_torch.core.topology import Topology, flat_topology

TOPOS = {"flat8": lambda: flat_topology(8), "2pod": lambda: Topology(8, 4),
         "4pod": lambda: Topology(8, 2)}
# alltoall algorithm per topology for the overlap runs
OVERLAP_ALGOS = {"flat8": "auto", "2pod": "hierarchical",
                 "4pod": "pairwise"}
OVERLAP_CHUNKS = (1, 2, 4)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def run(rank: int, n: int, init: str, inputs: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    try:
        results = _drive(rank, n, inputs)
    finally:
        dist.destroy_process_group()
    torch.save(results, f"{out_dir}/rank{rank}.pt")


def _tensor(a, dtype: str) -> torch.Tensor:
    """numpy f32 (or bf16 bits as uint16) -> a torch tensor of dtype."""
    if dtype == "bfloat16":
        return torch.from_numpy(a.astype("int16")).view(torch.bfloat16)
    return torch.from_numpy(a)


def _drive(rank: int, n: int, inputs: dict) -> dict:
    group = dist.new_group(list(range(n)))
    out = {}
    for (topo_name, agg), graph in inputs["graphs"].items():
        topo = TOPOS[topo_name]()
        plan = api.make_neighbor_plan(graph, topo, aggregate=agg)
        out[("plan", topo_name, agg)] = plan.schedule.fingerprint()
        for dtype in DTYPES:
            x = _tensor(inputs["values"][dtype][rank], dtype)
            for tr in ("dist", "kernel"):
                out[("neighbor", topo_name, agg, dtype, tr)] = \
                    api.mpix_neighbor_alltoallv(x, group, plan, transport=tr)
    for topo_name, algo in OVERLAP_ALGOS.items():
        topo = TOPOS[topo_name]()
        for dtype in DTYPES:
            x = _tensor(inputs["overlap"][dtype][rank], dtype)
            for tr in ("dist", "kernel"):
                for chunks in OVERLAP_CHUNKS:
                    out[("overlap", topo_name, dtype, tr, chunks)] = \
                        api.mpix_alltoall_overlap(
                            x, group, lambda c, o, i: c + [o], [],
                            chunks=chunks, algorithm=algo, topo=topo,
                            transport=tr)
        # a numeric fold, and the model's chunk count (chunks=0)
        x = _tensor(inputs["overlap"]["float32"][rank], "float32")
        out[("overlap_fold", topo_name)] = api.mpix_alltoall_overlap(
            x, group, lambda c, o, i: c * 0.5 + o * float(i + 1),
            torch.zeros(x.shape[0] // 4, x.shape[1]), chunks=4,
            algorithm=algo, topo=topo)
        out[("overlap_auto", topo_name)] = api.mpix_alltoall_overlap(
            x, group, lambda c, o, i: c + [o], [], chunks=0,
            compute_s=1e-2, algorithm=algo, topo=topo)
    # native all_to_all per chunk
    x = _tensor(inputs["overlap"]["float32"][rank], "float32")
    out["overlap_xla"] = api.mpix_alltoall_overlap(
        x, group, lambda c, o, i: c + [o], [], chunks=2, algorithm="xla")
    # the KV path over the point-to-point transport
    pool = torch.from_numpy(inputs["kv_pool"])
    topo = Topology(8, 4)
    for agg in (False, True):
        tp = kvtransfer.build_transfer_plan(
            inputs["kv_moves"], topo, blocks_per_rank=pool.shape[1],
            aggregate=agg, block_bytes=pool[0, 0].numel() * 4)
        res = kvtransfer.run_transfer(tp, pool, transport="dist",
                                      group=group)
        out[("kv", agg)] = (kvtransfer.verify_bitwise(tp, pool, res),
                            res.updates)
    from repro_torch.serve.engine import ContinuousBatchingEngine, \
        EngineConfig
    from repro_torch.serve.traffic import poisson_workload, run_workload
    eng = ContinuousBatchingEngine(EngineConfig(
        blocks_per_rank=16, block_tokens=4, block_feat=8, transport="dist",
        device="cpu"), group=group)
    metrics = run_workload(eng, poisson_workload(
        2, arrival_rate=8.0, tenants=2, n_requests=12, mean_prompt=10,
        mean_gen=4, max_prompt=24))
    out["engine"] = (metrics, [{k: v for k, v in x.items()
                                if k != "seconds"}
                               for x in eng.transfer_log], eng.kv)
    return out
