"""One rank of the port's partitioned-communication test
(tests/test_torch_partitioned.py).

Spawned by ``torch.multiprocessing.spawn``: joins an n-rank gloo group
through a ``file://`` rendezvous, runs the partitioned runtime forms of
``repro_torch.core.algorithms.partitioned`` on this rank's shard of the
parent's inputs, and saves what each returned (and how many
``batch_isend_irecv`` calls each partition count made) for the parent to
compare with the reference package.  Imports torch and the port only.
"""
import torch
import torch.distributed as dist

from repro_torch.core.algorithms import partitioned as pc

PARTS = (1, 2, 4, 8)


def run(rank: int, n: int, init: str, inputs: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    try:
        results = _drive(rank, n, inputs)
    finally:
        dist.destroy_process_group()
    torch.save(results, f"{out_dir}/rank{rank}.pt")


def _shard(a, rank: int, n: int, axis: int = 0) -> torch.Tensor:
    t = torch.from_numpy(a)
    size = t.shape[axis] // n
    return t.narrow(axis, rank * size, size).contiguous()


def _drive(rank: int, n: int, inputs: dict) -> dict:
    group = dist.new_group(list(range(n)))
    perm = [(i, (i + 1) % n) for i in range(n)]
    out = {}
    calls = {"n": 0}
    real = dist.batch_isend_irecv

    def counting(ops):
        calls["n"] += 1
        return real(ops)

    for kind in ("float", "int"):
        x = _shard(inputs[f"x_{kind}"], rank, n)
        for p in PARTS:
            for via in ("p2p", "schedule"):
                dist.batch_isend_irecv = counting
                calls["n"] = 0
                try:
                    out["ppermute", kind, p, via] = pc.partitioned_ppermute(
                        x, group, perm, p, via=via)
                finally:
                    dist.batch_isend_irecv = real
                out["exchanges", kind, p, via] = calls["n"]
        out["consume", kind] = pc.partitioned_ppermute(
            x, group, perm, 4, consume=lambda c, chunk: c + chunk.sum(0),
            init=torch.zeros(x.shape[1:], dtype=torch.float32))
        xg, w = _shard(inputs[f"xg_{kind}"], rank, n), torch.from_numpy(
            inputs[f"w_{kind}"])
        for parts in (1, 2):
            out["allgather_matmul", kind, parts] = pc.allgather_matmul(
                xg, w, group, partitions_per_rank=parts)
        xr = _shard(inputs[f"xr_{kind}"], rank, n, axis=1)
        wr = _shard(inputs[f"wr_{kind}"], rank, n)
        out["matmul_reduce_scatter", kind] = pc.matmul_reduce_scatter(
            xr, wr, group)
        tree = {"b": _shard(inputs[f"b_{kind}"], rank, n),
                "a": _shard(inputs[f"a_{kind}"], rank, n)}
        out["bucketed_psum", kind] = pc.bucketed_psum(tree, group,
                                                      buckets=3)
        out["bucketed_psum_list", kind] = pc.bucketed_psum(
            [tree["a"], tree["b"]], group, buckets=5)
    # the validation that needs the group size
    try:
        pc.matmul_reduce_scatter(torch.zeros(n + 1, 2), torch.zeros(2, 3),
                                 group)
        out["mrs_error"] = None
    except ValueError as e:
        out["mrs_error"] = str(e)
    return out
