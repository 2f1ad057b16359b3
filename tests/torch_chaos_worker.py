"""One rank of the port's chaos-under-the-API test
(tests/test_torch_chaos_api.py).

Spawned by ``torch.multiprocessing.spawn``: joins an n-rank gloo group
through a ``file://`` rendezvous, drives the ``mpix_*`` recovery ladder
with seeded chaos installed through ``api.set_chaos`` on both schedule
transports, and saves what each call returned (outputs, the reports'
comparable fields, the errors' type names) for the parent to check.
Imports torch and the port only.
"""
import torch
import torch.distributed as dist

from repro_torch.core import api
from repro_torch.core.chaos import FaultPlan
from repro_torch.core.transport import (DistTransport, KernelTransport,
                                        TransportError)
from repro_torch.kernels.rmsnorm import ops as rms_ops

COLLECTIVES = {
    "allgather": (api.mpix_allgather, "ring"),
    "allreduce": (api.mpix_allreduce, "ring_rs_ag"),
    "reduce_scatter": (api.mpix_reduce_scatter, "ring"),
    "alltoall": (api.mpix_alltoall, "pairwise"),
}
QUICK = {"verify": "off", "max_retries": 1, "backoff_s": 1e-4}


def run(rank: int, n: int, init: str, inputs: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    try:
        results = _drive(rank, inputs)
    finally:
        api.set_chaos(None)
        dist.destroy_process_group()
    torch.save(results, f"{out_dir}/rank{rank}.pt")


def _key(rep):
    return ([(a.rung, a.algorithm, a.attempt, a.outcome)
             for a in rep.attempts], rep.recovered_with,
            rep.refit_algorithm, rep.degraded)


def _under(plan, fn, *args, **kw):
    """``fn`` with ``plan`` installed; returns (output or the error's
    type name, the reports it left)."""
    api.take_degradations()
    api.set_chaos(plan)
    try:
        out = fn(*args, **kw)
    except (TransportError, RuntimeError) as e:
        out = type(e).__name__
    finally:
        api.set_chaos(None)
    return out, [_key(r) for r in api.take_degradations()]


def _drive(rank: int, inputs: dict) -> dict:
    group = dist.new_group(list(range(dist.get_world_size())))
    out = {}
    x = torch.from_numpy(inputs["x"][rank])
    for tr in ("dist", "kernel"):
        for coll, (fn, algo) in COLLECTIVES.items():
            kw = dict(algorithm=algo, transport=tr)
            # fault-free, then a transient failure under the armed
            # ladder, then the same without resilience, then a
            # persistent one that walks to the native collective
            out[tr, coll, "clean"] = fn(x, group, **kw)
            out[tr, coll, "transient"] = _under(
                FaultPlan(11, "fail", times=1), fn, x, group,
                resilience="off", **kw)
            out[tr, coll, "unarmed"] = _under(
                FaultPlan(11, "fail", times=1), fn, x, group, **kw)
            out[tr, coll, "persistent"] = _under(
                FaultPlan(11, "fail", times=None), fn, x, group,
                resilience=QUICK, **kw)
        kw = dict(algorithm="ring", transport=tr)
        out[tr, "hang"] = _under(
            FaultPlan(5, "hang", times=1, delay_s=1.0), api.mpix_allgather,
            x, group, resilience={"verify": "off", "deadline_s": 0.5,
                                  "backoff_s": 1e-4}, **kw)
    # the overlapped alltoall threads resilience through its exchange
    xs = torch.from_numpy(inputs["overlap"][rank])

    def cat(carry, o, i):
        return carry + [o]

    out["overlap"] = [torch.cat(api.mpix_alltoall_overlap(
        xs, group, cat, [], chunks=2, algorithm="pairwise", transport=tr,
        resilience=res), 0) for tr in ("dist", "kernel")
        for res in (None, "off")]
    out["overlap_reports"] = [_key(r) for r in api.take_degradations()]
    out["kernel_error"] = _kernel_error(x, group)
    out["rmsnorm"] = _rmsnorm_degrades(inputs, rank, group)
    return out


def _kernel_error(x, group) -> dict:
    """A failure of the kernel itself (not a TransportError) leaves the
    API ladder at once: no other transport, no report."""
    calls = {"dist": 0}
    real_kernel, real_dist = KernelTransport.run_global, DistTransport.run

    def broken(self, schedule, gbuf, **kw):
        raise RuntimeError("schedule_exec: cudaError_t 700 from the launch")

    def counting(self, schedule, buf):
        calls["dist"] += 1
        return real_dist(self, schedule, buf)

    KernelTransport.run_global, DistTransport.run = broken, counting
    try:
        got = _under(None, api.mpix_allgather, x, group, algorithm="ring",
                     transport="kernel", resilience=QUICK)
    finally:
        KernelTransport.run_global, DistTransport.run = real_kernel, real_dist
    return {"out": got, "dist_calls": calls["dist"]}


def _rmsnorm_degrades(inputs, rank, group) -> dict:
    """A TransportError of the fused kernel degrades it to
    allreduce-then-rmsnorm under resilience, with a report; without
    resilience it surfaces."""
    xr = torch.from_numpy(inputs["rmsnorm_x"][rank])
    scale = torch.from_numpy(inputs["rmsnorm_scale"])
    real = rms_ops.rmsnorm_allreduce

    def failing(*a, **kw):
        raise TransportError("fused epilogue lost its partials",
                             transport="kernel")

    res = {"fused": api.mpix_allreduce_rmsnorm(xr, group, scale),
           "dist": api.mpix_allreduce_rmsnorm(xr, group, scale,
                                              transport="dist")}
    rms_ops.rmsnorm_allreduce = failing
    try:
        res["degraded"] = _under(None, api.mpix_allreduce_rmsnorm, xr,
                                 group, scale, resilience="off")
        res["unarmed"] = _under(None, api.mpix_allreduce_rmsnorm, xr,
                                group, scale)
    finally:
        rms_ops.rmsnorm_allreduce = real
    return res
