"""Dry-run: every (arch x shape x mesh) cell's per-device step on the
``meta`` device, with nothing allocated, and what it costs a device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        --json out.json

For a cell it builds the port's own step for one device of the mesh
(its coordinates are the origin): the sharded fsdp train step
(``train.step.sharded_train_step``, the sequence split over ``model``)
or the explicit-DP step, the mesh decode step
(``serve.step.mesh_decode_step``, parameter blocks cut over ``model``
left where they are stored), or the prefill forward over sharded
parameters with the sequence split (``shard.SeqSplit``: each model rank
its S/n rows); the train state, the parameters, the cache and
the inputs are this device's blocks (``train.sharding``'s specs) as
``meta`` tensors, the batch its rows (``B / n_data``; a long-context
decode every row).  The mesh is a ``launch.mesh.MeshLayout``: its groups
have no process behind them, so every collective the step issues goes
through ``train.comm`` and is recorded, not run.  The kernels take
their plain versions (``use_kernel=False``): a CUDA kernel cannot run
on ``meta``.

The JSON has the reference dry-run's keys:
  * ``flops_per_device`` -- ``torch.utils.flop_counter.FlopCounterMode``
    over the step (forward, the remat recompute, backward);
  * ``hbm_bytes_per_device`` -- the sum of every op's input and output
    bytes (views excluded).  Eager PyTorch runs op by op, each a round
    trip to memory, so this is what the eager step moves; a fused
    compiler would move less;
  * ``collectives`` -- wire bytes a device by kind, ``count`` and
    ``total``: native collectives at the reference's per-device factors
    on the result bytes, ``mpix_*`` calls (explicit DP, the expert
    dispatch on a schedule algorithm) by their compiled schedule's own
    bytes (``train.comm``);
  * ``mem`` -- ``argument_bytes``: the device's parameters, optimizer
    state, cache and inputs (``param_bytes`` and ``opt_bytes`` beside
    it); ``temp_bytes``: the peak of live bytes the step allocated, its
    outputs and each gathered layer included, tracked by storage
    lifetime on ``meta``; ``output_bytes``: the step's outputs;
    ``peak_bytes`` = argument + temp;
  * ``n_devices``, ``mesh``, ``kind``, and ``compile_s``: the seconds the
    meta run took (the build of the step and the run; nothing is
    compiled).

No op of the 32 runnable cells depends on data on ``meta`` (the
capacity dispatch, the router bias and the MoE EP dispatch included;
every cell was run at smoke widths on a 2x2x2 layout), so no cell needs
``FakeTensorMode`` or an analytic part.  The plain recurrences of
rwkv6-3b and jamba run step by step, as the eager step does: their
train_4k and prefill_32k cells take 100-160 s a layer on ``meta`` (one
CPU core), so ``--all`` spends hours there.

The reference's HLO text parser (``hlo_analysis.py``, its trip-count
walk over XLA's compiled module) has no subject here: the counts come
from the eager step itself, so it is not ported.  Importing this module
sets nothing global.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, runnable
from repro_torch.launch import specs as SPECS
from repro_torch.launch.mesh import MeshLayout
from repro_torch.train import shard, sharding

_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")


def _tensors(x):
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


class _Meter(TorchDispatchMode):
    """Per op: input + output bytes; per new storage: its bytes while it
    lives (``weakref.finalize`` on the storage, which outlives every
    tensor and autograd record that holds it)."""

    def __init__(self, args):
        super().__init__()
        self.skip = {id(t.untyped_storage()): t.untyped_storage()
                     for t in _tensors(args)}
        self.seen: dict = {}
        self.live = self.peak = self.hbm = 0

    def _free(self, key):
        self.live -= self.seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.hbm += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        for t in _tensors(out):
            s = t.untyped_storage()
            key = id(s)
            if key in self.skip or key in self.seen:
                continue
            self.seen[key] = s.nbytes()
            self.live += s.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._free, key)
        return out


def layout_for(multi_pod: bool, mesh_shape=None) -> MeshLayout:
    shape = tuple(mesh_shape) if mesh_shape is not None else (
        (2, 16, 16) if multi_pod else (16, 16))
    axes = (("pod", "data", "model") if len(shape) == 3
            else ("data", "model"))
    return MeshLayout(shape, axes)


def _rows(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.shape[0] % n:
        raise ValueError(f"batch {t.shape[0]} does not divide over the "
                         f"{n} devices of the data axes")
    return torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                       dtype=t.dtype, device=t.device)


def build_cell(cfg, kind: str, ins: dict, mesh, *, train_overrides=None,
               long_context: bool = False):
    """(run, args, mem): ``run()`` runs the cell's per-device step once
    on ``meta``; ``args`` are its arguments; ``mem`` their bytes by
    part."""
    from repro_torch.models import model as M
    from repro_torch.serve.step import ServeOptions, mesh_decode_step
    from repro_torch.train.step import TrainOptions, sharded_train_step
    ov = dict(train_overrides or {})
    ov["use_kernel"] = False
    n_data = mesh.axis_size(sharding.data_axes(mesh))
    if kind == "train":
        opts = TrainOptions(**ov)
        state = SPECS.state_shapes(cfg, opts)
        step, sspec = sharded_train_step(cfg, mesh, opts, state,
                                         sharding.batch_specs(mesh))
        local = shard.cut_tree(state, sspec, mesh)
        batch = {k: _rows(v, n_data) for k, v in ins.items()}
        mem = {"param_bytes": _nbytes(local["params"]),
               "opt_bytes": _nbytes(local["opt"]) + _nbytes(
                   local.get("ef_residual", {})) + _nbytes(local["step"]),
               "input_bytes": _nbytes(batch)}
        return (lambda: step(local, batch)), (local, batch), mem
    params = M.Model(cfg, device="meta").state_dict()
    if kind == "prefill":
        pspec = sharding.param_specs(params, cfg, mesh)
        plans = shard.plans_for(pspec, mesh)
        split = shard.seq_split(mesh)
        blocks = shard.cut_tree(params, pspec, mesh)
        batch = {k: _rows(v, n_data) for k, v in ins.items()}

        @torch.no_grad()
        def run():
            kw = {k: v for k, v in batch.items() if k != "tokens"}
            return M.forward(shard.sharded_model(cfg, blocks, plans), cfg,
                             batch["tokens"], split=split, **kw)
        mem = {"param_bytes": _nbytes(blocks), "opt_bytes": 0,
               "input_bytes": _nbytes(batch)}
        return run, (blocks, batch), mem
    assert kind == "decode"
    step, (pspec, cspec) = mesh_decode_step(
        cfg, mesh, ServeOptions(long_context=long_context), params,
        ins["cache"])
    blocks = shard.cut_tree(params, pspec, mesh)
    cache = shard.cut_tree(ins["cache"], cspec, mesh)
    rows = (lambda t: t) if long_context else (lambda t: _rows(t, n_data))
    tokens = rows(ins["tokens"])
    cross = rows(ins["cross_src"]) if "cross_src" in ins else None
    mem = {"param_bytes": _nbytes(blocks), "opt_bytes": 0,
           "input_bytes": _nbytes(cache) + _nbytes(tokens)
           + _nbytes(cross)}
    return ((lambda: step(blocks, cache, tokens, cross)),
            (blocks, cache, tokens, cross), mem)


def collectives(log) -> dict:
    """Wire bytes by kind (``mpix-`` calls folded into their kind),
    ``count`` and ``total``, from a ``train.comm`` record."""
    out = {k: 0.0 for k in _KINDS}
    for kind, _, _, wire, *_ in log:
        out[kind.removeprefix("mpix-")] += wire
    out["count"] = len(log)
    out["total"] = sum(out[k] for k in _KINDS)
    return out


def analyse_cell(cfg, kind: str, ins: dict, mesh, *, train_overrides=None,
                 long_context: bool = False) -> dict:
    """One cell's per-device numbers (the result's keys, less the
    names); ``mesh`` a ``MeshLayout``."""
    t0 = time.perf_counter()
    run, args, mem = build_cell(cfg, kind, ins, mesh,
                                train_overrides=train_overrides,
                                long_context=long_context)
    del mesh.log[:]
    flops = FlopCounterMode(display=False)
    meter = _Meter(args)
    with flops, meter:
        out = run()
        out_bytes = _nbytes(out)
        del out
    seconds = time.perf_counter() - t0
    arg = mem["param_bytes"] + mem["opt_bytes"] + mem["input_bytes"]
    return {
        "kind": kind,
        "compile_s": round(seconds, 3),
        "flops_per_device": float(flops.get_total_flops()),
        "hbm_bytes_per_device": float(meter.hbm),
        "collectives": collectives(mesh.log),
        "mem": {"argument_bytes": arg, "output_bytes": out_bytes,
                "temp_bytes": meter.peak, "peak_bytes": arg + meter.peak,
                "param_bytes": mem["param_bytes"],
                "opt_bytes": mem["opt_bytes"]},
        "n_devices": math.prod(mesh.shape.values()),
        "mesh": "x".join(str(s) for s in mesh.shape.values()),
    }


def analyse(arch: str, shape_name: str, *, multi_pod: bool,
            train_overrides=None, mesh_shape=None, verbose=True,
            cfg=None) -> dict:
    """The cell (``arch`` x ``shape_name``) on the 16x16 mesh, or the
    2x16x16 one with ``multi_pod``, or on ``mesh_shape``; ``cfg``
    overrides the arch's config (a cut of it)."""
    cfg = cfg or get_config(arch)
    kind, ins = SPECS.input_specs(arch, shape_name, cfg)
    mesh = layout_for(multi_pod, mesh_shape)
    res = {"arch": arch, "shape": shape_name,
           **analyse_cell(cfg, kind, ins, mesh,
                          train_overrides=train_overrides,
                          long_context=shape_name.startswith("long"))}
    if verbose:
        coll, mem = res["collectives"], res["mem"]
        print(f"[{arch} x {shape_name} x {res['mesh']}] kind={kind} "
              f"meta run={res['compile_s']}s")
        print(f"  flops/dev={res['flops_per_device']:.3e}  "
              f"hbm bytes/dev={res['hbm_bytes_per_device']:.3e}")
        print(f"  args={mem['argument_bytes'] / 2**30:.2f}GiB  "
              f"temp={mem['temp_bytes'] / 2**30:.2f}GiB  "
              f"out={mem['output_bytes'] / 2**30:.2f}GiB")
        print(f"  collective wire bytes/dev={coll['total']:.3e} "
              f"({coll['count']:.0f} ops: "
              + ", ".join(f"{k}={v:.2e}" for k, v in coll.items()
                          if k not in ('count', 'total') and v) + ")")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells", default=None,
                    help="comma list of arch:shape pairs")
    ap.add_argument("--json", default=None)
    ap.add_argument("--dp-mode", default="fsdp")
    ap.add_argument("--moe-mode", default="mpix_ep")
    ap.add_argument("--ep-alltoall", default="xla")
    ap.add_argument("--remat", default="true")
    ap.add_argument("--ep-capacity", type=float, default=1.25)
    args = ap.parse_args(argv)

    overrides = {"dp_mode": args.dp_mode, "moe_mode": args.moe_mode,
                 "ep_alltoall": args.ep_alltoall,
                 "remat": args.remat.lower() == "true",
                 "ep_capacity": args.ep_capacity}
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.cells:
        cells = [tuple(c.split(":")) for c in args.cells.split(",")]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape, --cells or --all")
        cells = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results, failures = [], []
    for a, s in cells:
        if not runnable(a, s):
            print(f"[{a} x {s}] SKIP (documented: sub-quadratic only)")
            results.append({"arch": a, "shape": s, "skip": True})
            continue
        for mp in meshes:
            try:
                results.append(analyse(a, s, multi_pod=mp,
                                       train_overrides=overrides))
            except Exception as e:  # noqa: BLE001 — report and continue
                print(f"[{a} x {s} x {'multi' if mp else 'single'}] "
                      f"FAILED: {type(e).__name__}: {e}")
                failures.append((a, s, mp, str(e)[:500]))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"results": results, "failures": failures}, f,
                      indent=1)
    print(f"\n{len(results)} cells analysed, {len(failures)} failures")
    if failures:
        for f_ in failures:
            print("  FAIL:", f_[0], f_[1], "multi" if f_[2] else "single")
        sys.exit(1)


if __name__ == "__main__":
    main()
