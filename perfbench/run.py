"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the cards of this machine (a
four-card cell starts its four ranks itself, over NCCL) and prints one
JSON line of results as the last line of standard output.  Exits
non-zero, printing no result, without CUDA, with fewer cards than the
cell asks for, without the program beside it, or when a JAX module was
loaded.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

T0 = time.perf_counter()


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _rank(rank, world, rendezvous, args, t0, build_s):
    """One rank's run; rank 0 prints the result.  Exits non-zero, printing
    no result, when it fails or a JAX module was loaded."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from perfbench import harness
    harness.cache_env()
    harness.program_path()
    out = harness.run_rank(args, rank, world, rendezvous, t0,
                           build_s=build_s)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        sys.exit(3)
    if out is not None:
        harness.print_result(out)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from perfbench import harness
    harness.cache_env()
    harness.program_path()
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    chips = harness.workload(args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        print(f"perfbench: the cell asks for {chips} cards, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 2
    from repro_torch import cuda
    cuda.build()
    build_s = cuda.BUILD_SECONDS       # None where the library was reused
    if chips == 1:
        _rank(0, 1, "", args, T0, build_s)
        return 0
    codes = harness.spawn_ranks(_rank, chips, args, T0, build_s,
                                timeout=args.seconds + 300.0)
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
