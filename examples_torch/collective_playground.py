"""Algorithm playground: compare every registered algorithm for each
collective on a chosen topology — rounds, link traffic, modeled time —
then verify the allgathers bit-exactly against numpy on the
SimTransport and run each through the transport kernel.

    PYTHONPATH=src python examples_torch/collective_playground.py \\
        --device cpu --nranks 64 --ranks-per-pod 16 --bytes 1048576
    PYTHONPATH=src python examples_torch/collective_playground.py  # a card

The table and the numpy check are those of
``examples/collective_playground.py``, line for line.  Each allgather
schedule also runs through ``KernelTransport.run_global`` on
``--device``: one launch of the transport kernel (its plain version on
the CPU) on a global [nranks, blocks, 2] float32 buffer, which must be
bitwise the SimTransport's result on the same buffer.  The default
device is ``cuda``; without a card the script exits with an error.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.core.algorithms import REGISTRY
from repro_torch.core.topology import Topology
from repro_torch.core.transport import KernelTransport, SimTransport
from repro_torch.launch.mesh import local_device


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _kernel_allgather(sched, topo: Topology, buf: np.ndarray,
                      device: torch.device) -> None:
    """One launch of the transport kernel on ``buf`` in float32, bitwise
    the SimTransport on the same values."""
    g = buf.astype(np.float32)
    want = SimTransport(topo.nranks).run(sched, g)
    got = KernelTransport(topo.nranks, topo=topo).run_global(
        sched, torch.from_numpy(g).to(device)).cpu().numpy()
    _check(got.shape == want.shape
           and np.array_equal(got.view(np.uint32), want.view(np.uint32)),
           "the transport kernel's allgather differs from the "
           "SimTransport's")


def run(nranks: int = 64, ranks_per_pod: int = 16, nbytes: int = 1 << 20,
        device: torch.device = torch.device("cuda")) -> dict:
    """Print the table; returns its lines and the allgather schedules run
    through the transport kernel."""
    topo = Topology(nranks=nranks, ranks_per_pod=ranks_per_pod)
    rng = np.random.default_rng(0)
    lines, kernel_runs = [], []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    say(f"topology: {nranks} ranks, {topo.npods} pods")
    say(f"{'collective':<15}{'algorithm':<28}{'rounds':>7}"
        f"{'DCN msgs':>9}{'t_model':>12}")
    for coll, algos in REGISTRY.items():
        for name, builder in algos.items():
            try:
                sched = builder(topo)
            except AssertionError:     # NotApplicable on this topology
                continue
            t = sched.modeled_time(topo, nbytes // max(1, sched.num_blocks))
            say(f"{coll:<15}{name:<28}{sched.num_rounds:>7}"
                f"{sched.message_count(topo, local=False):>9}"
                f"{t*1e6:>10.1f}us")
            # bit-exact verification on the numpy transport
            n = topo.nranks
            if coll == "allgather":
                buf = np.zeros((n, sched.num_blocks, 2))
                contrib = rng.normal(size=(n, 2))
                for r in range(n):
                    buf[r, r] = contrib[r]
                out = SimTransport(n).run(sched, buf)
                _check(np.allclose(out, np.broadcast_to(contrib, (n, n, 2))),
                       f"allgather {name}: wrong result on the SimTransport")
                _kernel_allgather(sched, topo, buf, device)
                kernel_runs.append(name)
    say("playground OK (allgather outputs verified vs numpy)")
    print(f"transport kernel on {device}: {len(kernel_runs)} allgather "
          f"schedules, each bitwise the SimTransport", file=sys.stderr)
    return {"lines": lines, "kernel_allgathers": kernel_runs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nranks", type=int, default=64)
    ap.add_argument("--ranks-per-pod", type=int, default=16)
    ap.add_argument("--bytes", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda",
                    help="where the transport kernel runs (default cuda; "
                         "cpu runs its plain version)")
    args = ap.parse_args(argv)
    return run(args.nranks, args.ranks_per_pod, args.bytes,
               local_device(args.device))


if __name__ == "__main__":
    main()
