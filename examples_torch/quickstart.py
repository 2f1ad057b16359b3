"""Quickstart: the MPIX layer in a few lines (paper Listings 1-4).

Shows: (1) drop-in collective replacement with a selectable algorithm,
(2) a persistent locality-aware neighborhood collective, on 8 ranks in
two pods of 4 (``Topology(8, ranks_per_pod=4)``, what the reference's
(2, 4) ``("pod", "data")`` mesh gives).  The lines it prints are those
of ``examples/quickstart.py``.

    PYTHONPATH=src python examples_torch/quickstart.py --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 8 \\
        examples_torch/quickstart.py --transport kernel
    PYTHONPATH=src python examples_torch/quickstart.py        # one card

Two forms:

* the group form: every rank calls ``mpix_allreduce`` and ``run_dist``
  with its own row, over ``--transport dist`` (one exchange per round)
  or ``kernel`` (one all-gather and one launch of the transport
  kernel).  Under ``torchrun`` it takes torchrun's ranks (NCCL, one
  card a rank, or gloo with ``--device cpu``); with ``--device cpu``
  and no torchrun it starts 8 gloo ranks itself.  Rank 0 prints.
* the one-card form (a card and no torchrun: NCCL does not take two
  ranks on one card): the 8 ranks' rows live in one global [8, slots,
  ...] buffer on the card, and each schedule runs through
  ``KernelTransport.run_global``, one launch each.  The schedules and
  ``"auto"`` come from the API's own resolution
  (``core.api.resolve_schedule``); ``"xla"``, the native collective,
  is the sum over the rank axis there, and its line says so.

The default device is ``cuda``; without a card the script exits with
an error, and ``--device cpu`` runs the kernel's plain version.
"""
import argparse
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import api as mpix
from repro_torch.core.plan import CommGraph, build_plan, run_dist
from repro_torch.core.topology import Topology
from repro_torch.core.transport import KernelTransport
from repro_torch.launch.mesh import (ensure_process_group, free_port,
                                     local_device, under_torchrun)

NRANKS, RANKS_PER_POD = 8, 4
ALGORITHMS = ("xla", "ring_rs_ag", "hierarchical", "auto")
ONE_CARD_XLA = "  (one card: the sum over the rank axis)"


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def inputs():
    """(x [8, 4], graph, values [8, 4, 2]) as the reference draws them:
    rank r holds row r of x and ``values[r]``; graph and values come
    from one ``default_rng(0)`` stream."""
    x = np.arange(NRANKS * 4, dtype=np.float32).reshape(NRANKS, 4)
    rng = np.random.default_rng(0)
    graph = CommGraph.random(NRANKS, n_local=4, degree=3, rng=rng,
                             dup_frac=0.8)
    values = np.stack([rng.normal(size=(4, 2)).astype(np.float32)
                       for _ in range(NRANKS)])
    return x, graph, values


def _plan_line(graph, topo):
    plan = build_plan(graph, topo, aggregate=True)      # init once ...
    std = build_plan(graph, topo, aggregate=False)
    line = (f"neighbor plan: DCN bytes {std.traffic()['dcn']} -> "
            f"{plan.traffic()['dcn']} (locality-aware dedupe), "
            f"DCN msgs {std.traffic()['msgs_dcn']} -> "
            f"{plan.traffic()['msgs_dcn']}")
    return plan, line


def _allreduce_line(algo: str, out: np.ndarray) -> str:
    return f"mpix_allreduce[{algo:>13s}] ok -> {out[0][:4]}"


def _sum_check(algo: str, out: np.ndarray, x: np.ndarray) -> None:
    _check(np.allclose(out, x.reshape(NRANKS, 1, -1).sum(0)),
           f"mpix_allreduce[{algo}]: not the sum over the ranks")


def run_group(device: torch.device, transport: str = "dist", x=None,
              values=None) -> dict:
    """The group form: called by every rank of the default process group
    (8 ranks).  Returns this rank's allreduce results ([1, F] each), the
    gathered recv rows [8 * n_recv_max, feat] and, on rank 0, the
    printed lines."""
    dx, graph, dvalues = inputs()
    x = dx if x is None else x
    values = dvalues if values is None else values
    _check(dist.get_world_size() == NRANKS,
           f"the group form needs {NRANKS} ranks, the group has "
           f"{dist.get_world_size()}")
    rank = dist.get_rank()
    topo = Topology(nranks=NRANKS, ranks_per_pod=RANKS_PER_POD)
    lines = []

    def say(line: str) -> None:
        if rank == 0:
            print(line, flush=True)
            lines.append(line)

    # --- Listing 1 -> 2: replace the collective, pick the algorithm ----
    mine = torch.from_numpy(x[rank: rank + 1].copy()).to(device)
    results = {}
    for algo in ALGORITHMS:
        out = mpix.mpix_allreduce(mine, None, algorithm=algo, topo=topo,
                                  transport=transport).cpu().numpy()
        _sum_check(algo, out, x)
        results[algo] = out
        say(_allreduce_line(algo, out))

    # --- Listing 3 -> 4: persistent neighborhood alltoallv -------------
    plan, line = _plan_line(graph, topo)
    say(line)
    recv = run_dist(plan, torch.from_numpy(values[rank].copy()).to(device),
                    None, transport=transport)          # ... execute often
    parts = [torch.empty_like(recv) for _ in range(NRANKS)]
    dist.all_gather(parts, recv)
    recv = torch.cat(parts).cpu().numpy()
    say(f"neighbor exchange ok, recv shape {recv.shape}")
    say("quickstart OK")
    return {"lines": lines, "allreduce": results, "recv": recv}


def run_one_card(device: torch.device, x=None, values=None) -> dict:
    """The one-card form: the 8 ranks' rows in one global buffer, each
    schedule one launch of the transport kernel.  Returns every rank's
    allreduce results ([8, 1, F] each), the resolved algorithms, the
    neighbor exchange's global output and the gathered recv rows, and
    the printed lines."""
    dx, graph, dvalues = inputs()
    x = dx if x is None else x
    values = dvalues if values is None else values
    n = NRANKS
    topo = Topology(nranks=n, ranks_per_pod=RANKS_PER_POD)
    lines = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    # --- Listing 1 -> 2 ------------------------------------------------
    rows = torch.from_numpy(x.copy()).to(device)[:, None]     # [n, 1, F]
    width = rows[0].numel()
    # each rank's flat row padded to a multiple of n and cut into n
    # blocks, as ``mpix_allreduce`` lays it out
    gbuf = F.pad(rows.reshape(n, -1), (0, -width % n)).reshape(n, n, -1)
    nbytes = width * rows.element_size()
    results, resolved = {}, {}
    for algo in ALGORITHMS:
        name, sched = mpix.resolve_schedule("allreduce", algo, topo, nbytes)
        resolved[algo] = name
        if sched is None:
            out = rows.sum(0, keepdim=True).expand_as(rows)
        else:
            out = KernelTransport(n, topo=topo).run_global(sched, gbuf)
            out = out.reshape(n, -1)[:, :width].reshape(rows.shape)
        out = out.cpu().numpy()
        for r in range(n):
            _sum_check(algo, out[r], x)
        results[algo] = out
        say(_allreduce_line(algo, out[0])
            + (ONE_CARD_XLA if sched is None else ""))

    # --- Listing 3 -> 4 ------------------------------------------------
    plan, line = _plan_line(graph, topo)
    say(line)
    vals = torch.from_numpy(values.copy()).to(device)
    nbuf = vals.new_zeros((n, plan.buf_rows) + tuple(vals.shape[2:]))
    nbuf[:, : vals.shape[1]] = vals
    out = KernelTransport(n, topo=plan.topo).run_global(plan.schedule, nbuf)
    m = max(plan.recv_sizes)
    recv = torch.cat([out[r, plan.recv_offsets[r]: plan.recv_offsets[r] + m]
                      for r in range(n)]).cpu().numpy()
    say(f"neighbor exchange ok, recv shape {recv.shape}")
    say("quickstart OK")
    return {"lines": lines, "allreduce": results, "algorithms": resolved,
            "neighbor_out": out.cpu().numpy(), "recv": recv}


def _group_main(device_name: str, transport: str) -> dict:
    device = local_device(device_name)
    created = ensure_process_group(device)
    try:
        return run_group(device, transport)
    finally:
        if created:
            dist.destroy_process_group()


def _spawned_rank(rank: int, port: int, transport: str) -> None:
    """One of the 8 gloo ranks ``main`` starts on the CPU, in torchrun's
    environment."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(NRANKS),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    _group_main("cpu", transport)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="default cuda; cpu runs the kernel's plain "
                         "version on 8 gloo ranks")
    ap.add_argument("--transport", default=None, choices=["dist", "kernel"],
                    help="the group form's transport (default dist); the "
                         "one-card form runs the transport kernel")
    args = ap.parse_args(argv)
    if under_torchrun():
        return _group_main(args.device, args.transport or "dist")
    device = local_device(args.device)
    if device.type == "cpu":
        torch.multiprocessing.start_processes(
            _spawned_rank, args=(free_port(), args.transport or "dist"),
            nprocs=NRANKS, join=True, start_method="spawn")
        return None
    if args.transport == "dist":
        raise SystemExit("--transport dist needs a group of 8 ranks "
                         "(torchrun); the one-card form runs the "
                         "transport kernel")
    return run_one_card(device)


if __name__ == "__main__":
    main()
