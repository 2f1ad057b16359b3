"""Build and load the port's CUDA library.

The kernels under ``csrc/`` have a plain C interface.  Each source is
compiled with ``nvcc`` for ``sm_90a`` (all sources at once, one process
each), linked into one shared library under ``build/repro_torch/`` at
the repository root, and loaded with ``ctypes``.  The library's file
name carries a hash of the sources, the shared header
``csrc/hopper.cuh`` and the flags, so an edited source is rebuilt and
a stale library is never loaded.  Nothing here runs at import time:
the first kernel launch builds and loads.

Every kernel wrapper counts its launches in ``LAUNCHES`` (one per
kernel launch, never for the plain PyTorch version a CPU tensor takes).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"schedule_exec": 0, "rmsnorm": 0, "rmsnorm_reduce": 0,
            "flash_attention": 0, "flash_attention_gather": 0, "wkv6": 0,
            "mamba_scan": 0}

# flash-attention launches by the body that ran them (the Hopper wgmma
# body or a CUDA-core body), since the last reset_launches()
FLASH_BODIES = {"wgmma": 0, "cuda_cores": 0}

# transport-kernel launches by body: the shared-memory body, or for
# schedules too tall for shared memory the gather body (copy-only) or the
# global-memory body, since the last reset_launches()
TRANSPORT_BODIES = {"shared": 0, "global": 0, "gather": 0}

# rmsnorm launches (both entries) by body: rows in registers with 16-byte
# vectors, or the scalar body, since the last reset_launches()
RMSNORM_BODIES = {"vector": 0, "scalar": 0}

_LIB: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None     # wall time of this process's build

_vp, _i, _i64, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                     ctypes.c_float)
_SIGNATURES = {
    # dtype, in, out, tab, ntab, loads, stores, load/store box classes,
    # rounds, ns, L, chunks, tile, buffers, stage_rows, live rows, info,
    # stream
    "repro_schedule_exec": [_i, _vp, _vp, _vp] + [_i] * 7 + [_i64]
                           + [_i] * 5 + [_vp, _vp],
    # dtype, in, out, work, stage, tab, ntab, loads, stores, rounds, ns,
    # L, chunks, grid, stage_rows, info, stream
    "repro_schedule_exec_global": [_i] + [_vp] * 5 + [_i] * 5 + [_i64]
                                  + [_i] * 3 + [_vp, _vp],
    # in, out, gather table, sources, zero rows, ns, row bytes, info,
    # stream
    "repro_schedule_exec_gather": [_vp] * 3 + [_i] * 3 + [_i64]
                                  + [_vp, _vp],
    # dtype, scale dtype, parts, scale, out, P, R, d, eps, gemma, vectors
    # a thread (0: the scalar body), threads, stream
    "repro_rmsnorm_reduce": [_i, _i, _vp, _vp, _vp, _i, _i64, _i, _f, _i,
                             _i, _i, _vp],
    # dtype, scale dtype, x, scale, out, R, d, eps, gemma, vectors a
    # thread, threads, stream
    "repro_rmsnorm": [_i, _i, _vp, _vp, _vp, _i64, _i, _f, _i, _i, _i,
                      _vp],
    # dtype, q, k, v, out, q/k/v strides over (b, s, h), B, Sq, Sk, H, K,
    # D, scale, cap, causal, has_window, window, q_start, stream
    "repro_flash_attention": [_i] + [_vp] * 4 + [_i64] * 9 + [_i] * 6
                             + [_f, _f, _i, _i, _i, _i, _vp],
    # the same with q_rows after v
    "repro_flash_attention_gather": [_i] + [_vp] * 5 + [_i64] * 9
                                    + [_i] * 6 + [_f, _f, _i, _i, _i, _i,
                                                  _vp],
    # which body those run: dtype, q, k, v, out, strides, B, Sq, Sk, H,
    # K, D
    "repro_flash_attention_body": [_i] + [_vp] * 4 + [_i64] * 9 + [_i] * 6,
    # r/k/v dtype, w dtype, u dtype, r, k, v, w, u, y, chunk states,
    # decay products, r/k/v/w strides over (b, t, h), B, T, H, N, chunk,
    # stream
    "repro_wkv6": [_i] * 3 + [_vp] * 8 + [_i64] * 12 + [_i] * 5 + [_vp],
    # xc (and B/C) dtype, dt dtype, xc, dt, B, C, A, D, y, xc/dt/B/C
    # strides over (b, t), B, T, Di, S, W, C, KT, stages, tma, stream
    "repro_mamba_scan": [_i] * 2 + [_vp] * 7 + [_i64] * 8 + [_i] * 9
                        + [_vp],
    # xc dtype, dt dtype, S, W, C, KT, out: stages, out: CTAs per SM
    "repro_mamba_scan_fit": [_i] * 6 + [_vp, _vp],
}


def reset_launches() -> None:
    for counts in (LAUNCHES, FLASH_BODIES, RMSNORM_BODIES,
                   TRANSPORT_BODIES):
        for k in counts:
            counts[k] = 0


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default install, else ``nvcc`` on the PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build(*, verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link the library.
    Returns its path; a library already built from the same sources is
    reused.  ``verbose`` adds ptxas resource reports to the output."""
    global BUILD_SECONDS
    out = library_path()
    if out.exists():
        return out
    t0 = time.perf_counter()
    cc = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas=-v",) if verbose else ()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [cc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, p in procs:
            log, _ = p.communicate()
            if verbose and log:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
            if p.returncode:
                failed.append(f"{src.name} (exit {p.returncode}):\n{log}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        lib_tmp = Path(tmp) / out.name
        link = [cc, *ARCH_FLAGS, "-shared", "-o", str(lib_tmp),
                *(str(obj) for _, obj, _ in procs), "-ldl"]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        os.replace(lib_tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded CUDA library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def stream_handle(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device, for
    a launch: the one-call lookup where this torch has it, else the
    public ``current_stream`` (which builds a Stream object)."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream


def check(err: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{what}: cudaError_t {err} from the launch")


# torch dtype name -> the C entries' dtype code
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


@functools.lru_cache(maxsize=None)
def dtype_code(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"dtype {name} not supported by the CUDA kernels; "
                        f"expected one of {tuple(DTYPE_CODES)}")
    return DTYPE_CODES[name]
