"""One rank of the port's group tuning test (tests/test_torch_tuner_dist.py).

Spawned by ``torch.multiprocessing.spawn``: joins an n-rank gloo group
through a ``file://`` rendezvous and drives the tuner on the ``dist``
substrate — a measured ``autotune`` at one size, the agreed deadline
of ``measure_schedule`` and of the link probe (one rank made late on
purpose), a wire-timer probe — then ``algorithm="auto"`` collectives
under ``policy="tuned"`` and ``transport="auto"``, and last the serving
launcher on the group with ``--heal-interval`` (the daemon's heartbeat
between engine ticks); saves what each step returned for the parent to
check.  Imports torch and the port only.
"""
import contextlib
import io
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core import api, linkprobe, tuner
from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.topology import Topology

SIZE = 1 << 10
COLLECTIVES = ("allgather", "allreduce", "reduce_scatter", "alltoall")


def run(rank: int, n: int, init: str, inputs: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    os.environ["REPRO_TORCH_TUNER_CACHE"] = f"{out_dir}/cache{rank}.json"
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    try:
        results = _drive(rank, n, inputs)
    finally:
        api.set_default_policy("model")
        dist.destroy_process_group()
    torch.save(results, f"{out_dir}/rank{rank}.pt")


def _late(rank: int, seconds: float):
    """Make rank 0 late once: its first synchronize after a timed call
    sleeps, so only its own clock sees the deadline pass."""
    real = tuner._sync
    state = {"slept": False}

    def sync(substrate, group):
        real(substrate, group)
        if rank == 0 and not state["slept"]:
            state["slept"] = True
            time.sleep(seconds)
    return real, sync


def _alive(group) -> list:
    """A collective after a timeout: the group still runs."""
    x = torch.full((4,), float(dist.get_rank(group) + 1))
    return api.mpix_allreduce(x, group, algorithm="ring_rs_ag").tolist()


def _drive(rank: int, n: int, inputs: dict) -> dict:
    group = dist.group.WORLD
    topo = Topology(n, n // 2)
    out = {"substrate": tuner.measurable_substrate(topo),
           "fingerprint": tuner.substrate_fingerprint(topo)}

    t0 = time.perf_counter()
    table = tuner.autotune(topo, sizes=(SIZE,), repeats=1)
    out["tune_s"] = time.perf_counter() - t0
    out["table"] = table.to_dict()

    # the measurement deadline, overrun by rank 0 only
    sched = REGISTRY["allgather"]["ring"](topo)
    real, late = _late(rank, 1.0)
    tuner._sync = late
    try:
        tuner.measure_schedule(sched, topo, slot_elems=4, repeats=2,
                               deadline_s=0.5)
        out["timeout"] = None
    except tuner.MeasurementTimeout as e:
        out["timeout"] = str(e).split(": ")[1].split(" at ")[0]
    finally:
        tuner._sync = real
    out["alive_after_timeout"] = _alive(group)

    # the probe deadline, overrun by rank 0 only: the level is skipped
    # on every rank, the other levels fit
    real, late = _late(rank, 1.0)
    tuner._sync = late
    try:
        res = linkprobe.probe_links(topo, sizes=(1 << 10, 1 << 16),
                                    repeats=1, deadline_s=0.5)
    finally:
        tuner._sync = real
    out["probe_skipped"] = sorted(res.skipped)
    out["probe_source"] = res.source
    out["probe_models"] = sorted(res.models)
    real, late = _late(rank, 1.0)
    tuner._sync = late
    try:
        linkprobe.probe_links(topo, sizes=(1 << 10, 1 << 16), repeats=1,
                              deadline_s=0.5, strict=True)
        out["probe_strict"] = None
    except linkprobe.ProbeTimeout:
        out["probe_strict"] = "ProbeTimeout"
    finally:
        tuner._sync = real
    out["alive_after_probe"] = _alive(group)

    # a wire probe, fitted
    res = linkprobe.probe_links(topo, sizes=(1 << 10, 1 << 22), repeats=3)
    out["wire_source"] = res.source
    out["wire_samples"] = {i: list(s) for i, s in res.samples.items()}
    out["wire_models"] = {i: (m.alpha, m.beta)
                          for i, m in res.models.items()}
    out["wire_skipped"] = dict(res.skipped)

    # algorithm="auto" under the tuned policy, transport="auto"
    api.set_default_policy("tuned")
    x = torch.from_numpy(inputs["x"][rank])
    for coll in COLLECTIVES:
        fn = getattr(api, f"mpix_{coll}")
        out[coll] = (tuner.tuned_select(coll, topo, x.numel() * 4),
                     tuner.select_transport(topo, x.numel() * 4,
                                            policy="tuned"),
                     fn(x, group, topo=topo, transport="auto"))

    # the launcher on the group, healing between engine ticks: every
    # rank probes the wire at the same tick and ends on the same topology
    from repro_torch.launch import serve as tserve
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        m = tserve.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
                         "--continuous", "--kv-transport", "dist",
                         "--heal-interval", "0.02", "--requests", "4"])
    out["launcher"] = {
        "completed": m["completed"], "submitted": m["submitted"],
        "daemon": [ln for ln in buf.getvalue().splitlines()
                   if ln.startswith("tuner daemon:")],
        "seconds": time.perf_counter() - t0}
    return out
