"""Time the rmsnorm, wkv6 and selective-scan kernels of one or more
trees, in turns, on one NVIDIA GPU.

    python3 kernel_turns.py [TREE ...]

For each TREE (a checkout of this repository; by default the one that
holds this script) prints one JSON line per case:

- the rmsnorm ops at ``chip_smoke.py``'s main-path cases (the fused
  reduce+rmsnorm on ``[8, 4096, 5120]`` and ``[8, 4096, 2304]`` bf16,
  rmsnorm on ``[4096, 5120]`` bf16): ``ms`` per call (CUDA events around
  20 back-to-back calls, median of 5 batches), ``device_ms`` (the
  kernel's device time from ``torch.profiler``) and ``host_us`` (wall
  time to enqueue 200 calls without a synchronize, over 200);
- the wkv6 op at rwkv6-3b's layer shape (r/k/v ``[1, 8192, 40, 64]``
  bf16, w = exp(-exp(normal)) f32, u f32, random from seed 0): ``ms``,
  the device time per call and per kernel (``split``); where the tree's
  ``wkv6_bthn`` takes a chunk length, also each of ``CHUNKS`` below and
  the whole T as one chunk (phase 3 alone: the serial chain), each
  checked against ``wkv6_plain`` at 2e-2 first;
- the selective-scan op at jamba-1.5-large's layer shape (xc/dt ``[1,
  8192, 16384]`` bf16, S 16, drawn by ``chip_smoke._scan_inputs`` from
  seed 0), checked against ``selective_scan_plain`` at 2e-2 first:
  ``ms`` (CUDA events, median of 5 batches of 20 calls) and the device
  time per call.

Each tree runs in a process of its own, in the order given, and builds
its own library, so that

    python3 kernel_turns.py build/parent . . build/parent

compares a parent commit (unpacked with ``git archive``) with this one
on one card, in turns.
"""
from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHUNKS = (64, 128, 256, 512)
WKV_SHAPE = (1, 8192, 40, 64)
SCAN_SHAPE = (1, 8192, 16384, 16)      # B, T, Di, S


def measure(tree: Path) -> None:
    import torch
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import cuda
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6.kernel import wkv6_bthn, wkv6_plain

    dev = torch.device("cuda")
    cuda.library()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = [(label, shape, gemma, True)
             for label, shape, gemma in cs.RMSNORM_REDUCE_CASES]
    cases += [(label, shape, gemma, False)
              for label, shape, gemma in cs.RMSNORM_CASES]
    for label, shape, gemma, fused in cases:
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        scale = ((0.0 if gemma else 1.0) + 0.1 * torch.randn(
            shape[-1], generator=gen, device=dev)).to(torch.bfloat16)
        op = rms_ops.rmsnorm_allreduce if fused else rms_ops.rmsnorm

        def call(a, s, op=op, gemma=gemma):
            return op(a, s, 1e-6, gemma)
        name = "rmsnorm_reduce" if fused else "rmsnorm"
        print(json.dumps({
            "tree": str(tree), "case": label,
            "ms": cs.time_ms(torch, call, x, scale),
            "device_ms": cs.device_ms(torch, name, call, x, scale),
            "host_us": cs.host_us(torch, call, x, scale)}), flush=True)
        del x

    B, T, H, N = WKV_SHAPE
    r, k, v = (torch.randn(WKV_SHAPE, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(WKV_SHAPE, generator=gen,
                                         device=dev)))
    u = torch.randn((H, N), generator=gen, device=dev)
    runs = [("op", wkv_ops.wkv6)]
    if "chunk" in inspect.signature(wkv6_bthn).parameters:
        want = wkv6_plain(r, k, v, w, u)
        for C in CHUNKS + (T,):
            def fn(*a, C=C):
                return wkv6_bthn(*a, chunk=C)
            got = fn(r, k, v, w, u)
            torch.cuda.synchronize()
            if not torch.allclose(got, want, atol=2e-2, rtol=2e-2):
                raise RuntimeError(f"wkv6 at chunk {C}: off the plain "
                                   f"version")
            runs.append((f"chunk {C}", fn))
    for what, fn in runs:
        split = {}
        dev_ms = cs.device_ms(torch, "wkv6", fn, r, k, v, w, u,
                              reps=cs.LONG_REPS, split=split)
        print(json.dumps({
            "tree": str(tree), "case": f"wkv6 {list(WKV_SHAPE)} {what}",
            "ms": cs.time_ms(torch, fn, r, k, v, w, u, reps=10),
            "device_ms": dev_ms, "split": split}), flush=True)
    del r, k, v, w, u
    scan(torch, tree, cs)


def scan(torch, tree: Path, cs) -> None:
    """The selective-scan op at jamba-1.5-large's layer shape."""
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B, T, Di, S = SCAN_SHAPE
    args = cs._scan_inputs(torch, gen, dev, B, T, Di, S, "bfloat16",
                           "bfloat16")
    want = scan_kernel.selective_scan_plain(*args)
    fn = scan_ops.selective_scan
    got = fn(*args)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, atol=2e-2, rtol=2e-2):
        raise RuntimeError("mamba_scan: off the plain version")
    print(json.dumps({
        "tree": str(tree), "case": f"mamba_scan {list(SCAN_SHAPE)} op",
        "ms": cs.time_ms(torch, fn, *args),
        "device_ms": cs.device_ms(torch, "mamba_scan", fn, *args)}),
        flush=True)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        measure(Path(argv[1]).resolve())
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
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
