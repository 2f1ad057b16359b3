"""Readings that set a cell's limits, on the card at the cell's own size:

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --control
    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --fault half_batch [--seconds 1]
    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 1]

``--control``: the plain reference put in the program's place and
computed one precision below the configuration's (fp8 products for
bf16), judged against the float32 reference by the cell's own numbers.
``--fault``: a whole run of the cell with the fault of ``faults.py``
planted in the program.  Neither: whole runs of the cell as it is (the
program's readings), several seeds in one process.  One JSON line a
seed; not part of the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def control_train(wl, cfg, seed, device) -> dict:
    import torch
    from perfbench import layout, weights
    from perfbench.cells.train import _to_device
    from perfbench.reference import check, common, llama
    common.exact_f32()
    traffic = harness.load_file(harness.BENCH / "traffic"
                                / f"{wl['kind']}.py")
    world = wl["chips"]
    # the global batch of the cell's ranks, on one card
    params = dict(wl["params"], batch=wl["params"]["batch"] * world)
    stream = traffic.Stream(params, seed, cfg["vocab_size"])
    batches = [_to_device(stream.next(), device)
               for _ in range(wl["check_steps"])]
    readings = {}
    for precision in ("f32", "fp8"):
        drawn = weights.make(cfg, seed, device)
        store = {k: v.dtype for k, v in drawn.items()}
        P0 = {k: drawn.pop(k).float() for k in list(drawn)}
        readings[precision] = llama.train_steps(
            P0, layout.dims(cfg), batches, wl["options"], b1=wl["adam_b1"],
            precision=precision, store=store)
        del P0
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return check.train_numbers(readings["fp8"], readings["f32"])


def control_prefill(wl, cfg, seed, device) -> dict:
    import numpy as np
    import torch
    from perfbench.cells import prefill as cell
    from perfbench.reference import check, common
    common.exact_f32()
    traffic = harness.load_file(harness.BENCH / "traffic"
                                / f"{wl['kind']}.py")
    stream = traffic.Stream(wl["params"], seed, cfg["vocab_size"])
    prompts = [stream.next() for _ in range(wl["params"]["grid"])]
    picked = cell.sample([p.size for p in prompts], seed,
                         wl["check_requests"])
    xs = [torch.from_numpy(prompts[i]).to(device) for i in picked]
    low = []
    cell.reference_prefill(cfg, seed, device, xs,
                           lambda j, lg: low.append(torch.argmax(lg, -1)),
                           precision="fp8")
    judged = []
    cell.reference_prefill(
        cfg, seed, device, xs,
        lambda j, lg: judged.append(check.judge(lg, low[j])))
    return {**check.prefill_numbers(judged),
            "lengths": [int(prompts[i].size) for i in picked],
            "mean_length": float(np.mean([p.size for p in prompts]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=1.0)
    a = ap.parse_args(argv)
    harness.cache_env()
    harness.program_path()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    wl = harness.workload(a.workload)
    cfg = harness.config(wl["config"])
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        if a.control:
            fn = control_train if wl["loop"] == "train" else control_prefill
            out = fn(wl, cfg, seed, dev)
        else:
            out = _runs(a, wl, seed)
        out.update(seed=seed, what=("control" if a.control else
                                    a.fault or "program"),
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


def _runs(a, wl, seed) -> dict:
    """A whole run of the cell (its own ranks), the fault planted."""
    import torch
    from perfbench import faults
    args = argparse.Namespace(workload=a.workload, seed=seed,
                              seconds=a.seconds, trace=0)
    patch = faults.planted(a.fault) if a.fault else None
    if wl["chips"] == 1:
        with faults.undone():
            out = harness.run_rank(args, patch=patch)
        torch.cuda.empty_cache()
        return {k: out[k] for k in ("correct", "checks", "notes")
                if k in out}
    import multiprocessing as mp
    q = mp.get_context("spawn").Queue()
    harness.spawn_ranks(_rank, wl["chips"], args, patch, q)
    return q.get(timeout=60)


def _rank(rank, world, rendezvous, args, patch, q):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from perfbench import harness as h
    h.cache_env()
    h.program_path()
    out = h.run_rank(args, rank, world, rendezvous, patch=patch)
    if out is not None:
        q.put({k: out[k] for k in ("correct", "checks", "notes")
               if k in out})


if __name__ == "__main__":
    sys.exit(main())
