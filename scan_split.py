"""Split the selective-scan kernel's time on one NVIDIA GPU: what its
exps, its loads, its y and its per-tile reduction cost.

    python3 scan_split.py [W,C,KT,STAGES ...]

Builds cuts of ``src/repro_torch/csrc/mamba_scan.cu`` into
``build/scan_split/`` (one nvcc each, in parallel): the source as it is
(``ms``); a copy whose ``ex2.approx`` is a move, so that the special-
function units take no exps (``no_exps_ms``); a copy whose producer
stops loading once the ring is full, so that later tiles run on what the
ring holds (``no_loads_ms``); a copy that keeps one multiply, the exp
and the state's multiply-add per update and drops the B_t product and y
(``exps_only_ms``: the floor that the exps and the recurrence set); and
a copy whose epilogue never adds up or stores y (``no_reduce_ms``),
and more (``CUTS``; ``cuts=a,b+c`` picks some, ``+`` applying several
to one copy).  Only
the first computes the scan; the cuts time the same launch with one kind
of work taken out.  The first is also timed with xc and dt read by the
producer's plain loads in place of TMA boxes (``plain_loads_ms``, the
C entry's ``tma`` = 0), and checked.  At jamba-1.5-large's layer shape
(xc/dt ``[1, 8192, 16384]`` bf16, S 16, random inputs from a seeded
generator, drawn as ``chip_smoke.py`` draws them), prints one JSON line
per plan: the wrapper's ``scan_plan`` with the stages its library fits,
and each ``W,C,KT,STAGES`` given (of the tilings the library holds).
Times are CUDA events
around 20 back-to-back calls of the C entry, the median of 5 batches
(``chip_smoke.time_ms``).  First prints, for each kernel of the as-is
build, the SASS instructions an update in its step loop (``cuobjdump
-sass``: the loop that holds the most MUFU.EX2, over their count).
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "scan_split"
SHAPE = (1, 8192, 16384, 16)          # B, T, Di, S


def _cut(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"scan_split: {old!r} is not in the source "
                           f"once; update the cut")
    return src.replace(old, new)


def no_exps(src: str) -> str:
    return _cut(src, 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                "y = x;")


def no_loads(src: str) -> str:
    return no_bc(no_tma(src))


def exps_only(src: str) -> str:
    src = _cut(src, "h[j] = fmaf(e[u][j], h[j], dx * bt[j]);",
               "h[j] = fmaf(e[u][j], h[j], dx);")
    src = _cut(src, "yp[u] = h[0] * ct[0];", "yp[u] = h[0];")
    return _cut(src, "yp[u] = fmaf(h[j], ct[j], yp[u]);", "yp[u] = h[j];")


def no_reduce(src: str) -> str:
    return _cut(src, "if (tt < T) {", "if (tt < T && Di < 0) {")


def no_waits(src: str) -> str:
    src = _cut(src, "mbar_wait(full(s), k & 1);", "")
    return _cut(src, "if (k > 0) mbar_wait(empty(s), (k - 1) & 1);", "")


def no_steps(src: str) -> str:
    return _cut(src, "    fetch(0, dv0, xv0, e0);\n#pragma unroll 1\n"
                "    for (int n = 0; n < NG; n += 2) {",
                "    fetch(0, dv0, xv0, e0);\n#pragma unroll 1\n"
                "    for (int n = 0; n < 0; n += 2) {")


def no_tma(src: str) -> str:
    return _cut(src, "if (lane == 0 && tx_bytes) {",
                "if (lane == 0 && tx_bytes && i < stages) {")


def no_bc(src: str) -> str:
    src = _cut(src, "const bool ok = q < NV && t < T;",
               "const bool ok = q < NV && t < T && t0 < stages * KT;")
    return _cut(src, "const bool ok = e < KT * S && t < T;",
                "const bool ok = e < KT * S && t < T && t0 < stages * KT;")


def steps_only(src: str) -> str:
    return no_reduce(no_loads(src))


CUTS = {"as_is": lambda s: s, "no_exps": no_exps, "no_loads": no_loads,
        "exps_only": exps_only, "no_reduce": no_reduce,
        "no_waits": no_waits, "no_steps": no_steps,
        "no_tma": no_tma, "no_bc": no_bc,
        "steps_only": steps_only}


def combined(names: str):
    """The cut that applies each of ``a+b+...`` in turn."""
    def edit(src: str) -> str:
        for n in names.split("+"):
            src = CUTS[n](src)
        return src
    return edit


def build(names: list[str]) -> dict:
    from repro_torch import cuda
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    base = (csrc / "mamba_scan.cu").read_text()
    procs = {}
    for name in names:
        edit = combined(name)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(csrc / "hopper.cuh", d / "hopper.cuh")
        (d / "mamba_scan.cu").write_text(edit(base))
        so = d / "libscan.so"
        cmd = [cuda.nvcc(), *cuda.NVCC_FLAGS, "-shared", "-o", str(so),
               str(d / "mamba_scan.cu"), "-ldl"]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).repro_mamba_scan
        fn.argtypes = cuda._SIGNATURES["repro_mamba_scan"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def sass_per_update(so: Path) -> dict:
    """Kernel name -> SASS instructions an update in its step loop: the
    backward branch's loop that holds the most MUFU.EX2 (one an update),
    its instructions over that count."""
    import re
    from repro_torch import cuda
    dump = subprocess.run([str(Path(cuda.nvcc()).parent / "cuobjdump"),
                           "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for func in dump.split("Function : ")[1:]:
        name = func.split("\n", 1)[0].strip()
        ops = []                                  # (address, instruction)
        for line in func.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*?);", line)
            if m:
                ops.append((int(m.group(1), 16), m.group(2)))
        best = None
        for i, (addr, op) in enumerate(ops):
            m = re.search(r"BRA (?:`\()?(?:\.L_x_\d+)?\)?\s*0x([0-9a-f]+)",
                          op)
            if not m or int(m.group(1), 16) >= addr:
                continue
            body = [o for a, o in ops if int(m.group(1), 16) <= a <= addr]
            ex2 = sum("MUFU.EX2" in o for o in body)
            if ex2 and (best is None or ex2 > best[1]):
                best = (len(body), ex2)
        key = re.search(r"mamba_scan_kernelILi(\d+)ELi(\d+)ELi(\d+)"
                        r"ELi(\d+)E(\w+?)EEv", name)
        if best and key:
            label = "S,W,C,KT={},{},{},{} {}".format(*key.groups())
            out[label] = round(best[0] / best[1], 3)
    return out


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("scan_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import cuda
    from repro_torch.kernels.mamba_scan import kernel as K
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    names = list(CUTS)
    if argv and argv[0].startswith("cuts="):
        names = ["as_is"] + argv.pop(0)[5:].split(",")
    libs = build(names)
    print(json.dumps({"sass_per_update": sass_per_update(
        OUT / "as_is" / "libscan.so")}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B, T, Di, S = SHAPE
    if argv and argv[0].startswith("shape="):
        B, T, Di = (int(n) for n in argv.pop(0)[6:].split(","))
    xc, dt, Bc, Cc, A, D = cs._scan_inputs(torch, gen, dev, B, T, Di, S,
                                           "bfloat16", "bfloat16")
    y = torch.empty((B, T, Di), dtype=torch.float32, device=dev)
    want = K.selective_scan_plain(xc, dt, Bc, Cc, A, D)
    plan = K.scan_plan(B, Di, S)
    plans = [(plan, K.ring_fit(0, xc.dtype, dt.dtype, S, plan)[0])] + [
        (K.ScanPlan(*(int(v) for v in a.split(",")[:3])),
         int(a.split(",")[3])) for a in argv]
    stream = torch.cuda.current_stream().cuda_stream
    tma = int(K.tma_ok(xc)) | int(K.tma_ok(dt)) << 1
    for plan, stages in plans:
        def args(loads):
            return (1, 1, *(t.data_ptr() for t in (xc, dt, Bc, Cc, A, D)),
                    y.data_ptr(),
                    *(s for t in (xc, dt, Bc, Cc) for s in t.stride()[:2]),
                    B, T, Di, S, plan.warps, plan.groups, plan.steps,
                    stages, loads, stream)
        times, err = {}, {}
        runs = [(name, fn, tma) for name, fn in libs.items()]
        runs.append(("plain_loads", libs["as_is"], 0))
        for name, fn, loads in runs:
            a = args(loads)
            times[name] = cs.time_ms(
                torch, lambda fn=fn, a=a: cuda.check(fn(*a), name))
            if name in ("as_is", "plain_loads"):
                y.zero_()
                cuda.check(fn(*a), name)
                err[name] = cs._close(torch, y, want, 2e-2, 2e-2,
                                      f"scan_split {plan} {name}")
        print(json.dumps({
            "shape": [B, T, Di, S], "plan": dataclasses.astuple(plan),
            "stages": stages, "loads": "tma" if tma == 3 else tma,
            **{("ms" if k == "as_is" else f"{k}_ms"): v
               for k, v in times.items()},
            "max_abs_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
