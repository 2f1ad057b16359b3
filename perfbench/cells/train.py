"""The training cell: a closed loop of the port's train step
(``repro_torch.train.step.make_train_step``) on the batches of
``traffic/<kind>.py``, one process a card.

Set-up draws the weights on the device from the seed, builds the step
and its AdamW state once, and drives that same object through the
cell's first ``check_steps`` steps with the window's own call and feed;
those steps warm every shape and give the program's readings.  The
window then runs whole steps until ``--seconds`` have passed and waits
for the device (``harness.Ctx.measure``).  After it, with the program's state freed, the plain
reference (``reference/llama.py``) runs the same first steps from the
same weights and batches in float32, storing each weight between steps
in the type the configuration keeps it in (bf16, as the port does), and
the numbers of
``reference/check.train_numbers`` are held to the cell's limits.
"""
from __future__ import annotations

import gc
import time

import torch

from perfbench import harness, layout, program, weights
from perfbench.reference import check, common, llama


def _to_device(batch: dict, device) -> dict:
    """Host rows to the device through pinned memory, without waiting."""
    if device.type != "cuda":
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


def run(ctx) -> None:
    from repro_torch.core import api as mpix_api
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import TrainOptions, make_train_step

    wl, cfg, dev, seed = ctx.wl, ctx.cfg, ctx.device, ctx.args.seed
    traffic = harness.load_file(harness.BENCH / "traffic"
                                / f"{wl['kind']}.py")
    mcfg = program.port_config(cfg)
    mesh = None
    if ctx.world > 1:
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(dev)
    if "select_policy" in wl:
        mpix_api.set_default_policy(wl["select_policy"])
    step_fn = make_train_step(mcfg, mesh, TrainOptions(**wl["options"]))
    params = weights.make(cfg, seed, dev)
    program.check_layout(mcfg, params)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    del params
    stream = traffic.Stream(wl["params"], seed, cfg["vocab_size"],
                            rank=ctx.rank, world=ctx.world)

    # the first steps: warm-up, and the program's readings
    b1 = wl["adam_b1"]
    first, prog = [], {"losses": []}
    for i in range(wl["check_steps"]):
        host = stream.next()
        first.append(host)
        state, m = step_fn(state, _to_device(host, dev))
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["grad_norm"] = float(m["grad_norm"])
            prog["grad_norms"] = {k: float(v.norm()) / (1 - b1)
                                  for k, v in state["opt"]["mu"].items()}
    p0 = weights.make(cfg, seed, dev)
    prog["change_norms"] = {
        k: float((state["params"][k].float() - p0[k].float()).norm())
        for k in p0}
    del p0

    live = {"state": state}
    del state

    def one_step():
        with ctx.span("batch"):
            batch = _to_device(stream.next(), dev)
        with ctx.span("step"):
            live["state"], _ = step_fn(live["state"], batch)

    steps, traced = ctx.measure(one_step)
    r = ctx.run
    B, S = wl["params"]["batch"], wl["params"]["seq"]
    r.steps = r.attempted = steps
    r.traced_steps = traced
    r.tokens = steps * B * S * ctx.world
    r.traced_tokens = traced * B * S * ctx.world

    # the check, with the program's state freed
    del live, step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    common.exact_f32()
    drawn = weights.make(cfg, seed, dev)
    store = {k: v.dtype for k, v in drawn.items()}
    P0 = {k: drawn.pop(k).float() for k in list(drawn)}
    group = None
    if ctx.world > 1:
        import torch.distributed as dist
        group = dist.group.WORLD
    ref = llama.train_steps(P0, layout.dims(cfg),
                            [_to_device(b, dev) for b in first],
                            wl["options"], b1=b1, group=group, store=store)
    nums = check.train_numbers(prog, ref)
    for k, lim in wl["limits"].items():
        r.checks[k] = (nums.pop(k), lim)
    r.notes = {"losses": prog["losses"], "ref_losses": ref["losses"],
               **nums, "reference_s": time.perf_counter() - t_ref}
