"""Split the Hopper flash-attention body's time on one NVIDIA GPU: what
its k/v copies and its exps cost.

    python3 attention_split.py

Builds three libraries from ``src/repro_torch/csrc/flash_attention.cu``
into ``build/attention_split/`` (one nvcc each, in parallel): the source
as it is (``ms``); a copy whose producer stops copying k and v once the
stage ring is full, so that later tiles run on what the ring holds and
the products and the softmax keep their count (``no_copies_ms``); and a
copy whose ``ex2.approx`` is a move, so that the special-function units
take no exps (``no_exps_ms``).  Only the first computes attention; the
two cuts time the same loop with one kind of work taken out.  At each of
``chip_smoke.py``'s three main-path attention shapes (random bf16 inputs
from a seeded generator), prints one JSON line with the three times, the
bound and the k/v bytes the tiling reads.  Times are CUDA events around
20 back-to-back calls of the C entry, the median of 5 batches
(``chip_smoke.time_ms``).
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "attention_split"
CASES = [
    # (label, q shape, kv heads, window, softcap)
    ("gemma2-2b global layer", (1, 8192, 8, 256), 4, None, 50.0),
    ("gemma2-2b local layer", (1, 8192, 8, 256), 4, 4096, 50.0),
    ("jamba attention layer", (1, 8192, 64, 128), 8, None, None),
]


def _cut(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"attention_split: {old!r} is not in the source "
                           f"once; update the cut")
    return src.replace(old, new)


def no_copies(src: str) -> str:
    for t in ("k", "v"):
        src = _cut(
            src,
            f"mbar_arrive_tx(sm.{t}_full(s), Tl::KV_BYTES);\n"
            f"        for (int c = 0; c < CB; ++c)",
            f"mbar_arrive_tx(sm.{t}_full(s), it < NST ? Tl::KV_BYTES : 0);\n"
            f"        for (int c = 0; c < (it < NST ? CB : 0); ++c)")
    return src


def no_exps(src: str) -> str:
    return _cut(src, 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                "y = x;")


def build() -> dict:
    from repro_torch import cuda
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    base = (csrc / "flash_attention.cu").read_text()
    procs = {}
    for name, edit in (("as_is", lambda s: s), ("no_copies", no_copies),
                       ("no_exps", no_exps)):
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(csrc / "hopper.cuh", d / "hopper.cuh")
        (d / "flash_attention.cu").write_text(edit(base))
        so = d / "libflash.so"
        cmd = [cuda.nvcc(), *cuda.NVCC_FLAGS, "-shared", "-o", str(so),
               str(d / "flash_attention.cu"), "-ldl"]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).repro_flash_attention
        fn.argtypes = cuda._SIGNATURES["repro_flash_attention"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import cuda
    from repro_torch.kernels.attention.kernel import flash_attention_plain
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    libs = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for label, (B, S, H, D), K, window, cap in CASES:
        q = torch.randn((B, S, H, D), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((B, S, K, D), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        out = torch.empty_like(q)
        args = (1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], B, S, S,
                H, K, D, D ** -0.5, cap or 0.0, 1, int(window is not None),
                window or 0, 0, stream)
        times = {}
        for name, fn in libs.items():
            times[name] = cs.time_ms(
                torch, lambda fn=fn: cuda.check(fn(*args), name))
            if name == "as_is":
                cuda.check(fn(*args), name)
                tol = cs.ATTN_TOL["bfloat16"]
                err = cs._close(torch, out, flash_attention_plain(
                    q, k, v, causal=True, window=window, softcap=cap),
                    tol, tol, label)
        flops = 4 * D * H * B * cs._live_pairs(S, window)
        print(json.dumps({
            "case": label, "q": [B, S, H, D], "kv_heads": K,
            "window": window, "softcap": cap, "ms": times["as_is"],
            "no_copies_ms": times["no_copies"],
            "no_exps_ms": times["no_exps"],
            "bound_ms": flops / cs.BF16_TC_OPS_PER_S * 1e3,
            "kv_read_bytes": cs._kv_read_bytes(q, k, window, "wgmma"),
            "max_abs_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
