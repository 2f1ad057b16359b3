"""Split the transport kernel's time into its copies and its rounds, on
one NVIDIA GPU.

    python3 transport_split.py [TREE ...]

For each TREE (a checkout of this repository; by default the one that
holds this script) and each of ``chip_smoke.py``'s three main-path
transport cases, prints one JSON line: the collective as the main path
calls it, ``KernelTransport.run_global`` (``ms``); the wrapper
``KernelExec.run`` (``run_ms``); the kernel's C entry called directly
(``launch_ms``) and the same launch with its rounds skipped, so that
only the stage-in and the drain run (``copies_ms``); their difference
(``rounds_ms``); ``g.clone()`` of the buffer (``copy_floor_ms``) and,
where the tree's tables give it, the design floor (live rows read once,
every row written once, at 3.35 TB/s).  ``ms`` against ``launch_ms``
is what the host adds per call where it cannot stay ahead.  Each tree
runs in a process of its own, in the order given, so that

    python3 transport_split.py build/parent . . build/parent

compares a parent commit (unpacked with ``git archive``) with this one
on one card, in turns.  Times are CUDA events around 20 back-to-back
calls, the median of 5 batches (``chip_smoke.time_ms``).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def measure(tree: Path) -> None:
    import torch
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import cuda
    from repro_torch.core import kernel_lowering as kl
    from repro_torch.core.algorithms import REGISTRY
    from repro_torch.core.transport import KernelTransport

    dev = torch.device("cuda")
    lib = cuda.library()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for label, tspec, coll, algo, slot, dtname in cs.TRANSPORT_CASES:
        topo = cs._topology(tspec)
        n = topo.nranks
        dtype = getattr(torch, dtname)
        if coll == "allreduce":
            slot = (25 * cs.MIB // 4 // n,)
        sched = REGISTRY[coll][algo](topo)
        gbuf = torch.zeros((n, sched.num_slots) + slot, device=dev,
                           dtype=dtype)
        gbuf[:, :n] = torch.randn((n, n) + slot, generator=gen, device=dev,
                                  dtype=dtype)
        kex = kl.get_kernel_exec(sched, topo=topo)
        out = torch.empty_like(gbuf)
        ns, L = n * sched.num_slots, math.prod(slot)
        elem, code = gbuf.element_size(), cuda.dtype_code(dtype)
        stream = torch.cuda.current_stream().cuda_stream
        floor_ms = None
        if hasattr(kex, "tables"):          # the TMA kernel
            t = kex.tables
            tab = kex.device_table(dev)
            # (tile, buffers), or (body, tile, buffers) since the
            # global body
            tile, nbuf = kl.pick_tile(ns, t["stage_rows"], elem, L,
                                      sched.name, len(t["tab"]))[-2:]
            floor_ms = ((t["nlive"] + ns) * L * elem / cs.HBM_BYTES_PER_S
                        * 1e3)

            def launch(rounds):
                return lib.repro_schedule_exec(
                    code, gbuf.data_ptr(), out.data_ptr(), tab.data_ptr(),
                    tab.numel(), len(t["loads"]), len(t["stores"]),
                    t["load_classes"], t["store_classes"], rounds, ns, L, 1,
                    tile, nbuf, t["stage_rows"], t["nlive"], None, stream)
        else:                               # the one-CTA-per-tile kernel
            sr = kex._host["stage_rows"]
            tile = kl.pick_tile(ns, sr, elem, L, sched.name)
            tabs = kex.device_tables(dev)

            def ptr(x):
                return None if x is None or x.numel() == 0 else x.data_ptr()

            def launch(rounds):
                return lib.repro_schedule_exec(
                    code, gbuf.data_ptr(), out.data_ptr(), ptr(tabs["pre"]),
                    ptr(tabs["post"]), ptr(tabs["meta"]), ptr(tabs["esrc"]),
                    ptr(tabs["edst"]), ptr(tabs["g"]), ptr(tabs["t"]),
                    rounds, n, sched.num_slots, L, 1, tile, sr, kl.THREADS,
                    stream)

        rounds = len(kex.ex._rounds)
        transport = KernelTransport(n, topo=topo)
        ms = cs.time_ms(torch, transport.run_global, sched, gbuf)
        run_ms = cs.time_ms(torch, kex.run, gbuf)
        launch_ms = cs.time_ms(torch, lambda: cuda.check(launch(rounds), ""))
        copies_ms = cs.time_ms(torch, lambda: cuda.check(launch(0), ""))
        print(json.dumps({
            "tree": str(tree), "case": label, "ms": ms, "run_ms": run_ms,
            "launch_ms": launch_ms, "copies_ms": copies_ms,
            "rounds_ms": launch_ms - copies_ms,
            "copy_floor_ms": cs.time_ms(torch, lambda g: g.clone(), gbuf),
            "floor_ms": floor_ms, "tile": tile}), flush=True)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        measure(Path(argv[1]).resolve())
        return 0
    import torch
    if not torch.cuda.is_available():
        print("transport_split: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    for tree in argv or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--one", tree],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
