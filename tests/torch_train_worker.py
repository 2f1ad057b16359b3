"""One rank of the port's distributed training test
(tests/test_torch_train_dist.py).

Spawned by ``torch.multiprocessing.spawn``: joins an 8-rank gloo group
through a ``file://`` rendezvous, builds the (2, 4) ``("data",
"model")`` and (2, 2, 2) ``("pod", "data", "model")`` meshes, and runs
on its own rows: the expert-parallel MoE dispatch for each alltoall
algorithm, the serving prefill with the EP dispatch, the train step in
explicit mode (each algorithm, both transports, buckets, the overlapped
and the compressed sync, the EP dispatch) and in fsdp mode; saves what
each returned for the parent to compare.  Imports torch and the port
only.
"""
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.serve.step import ServeOptions, make_prefill_step
from repro_torch.train.moe_dispatch import EPOptions, make_moe_dispatch
from repro_torch.train.step import TrainOptions, make_train_step

MESHES = {"flat": ((2, 4), ("data", "model")),
          "pods": ((2, 2, 2), ("pod", "data", "model"))}
EP_ALGOS = ("xla", "pairwise", "hierarchical")
# (mesh, algorithm) of the explicit-DP step against the one-device step
DP_CASES = (("flat", "xla"), ("flat", "ring_rs_ag"), ("flat", "hierarchical"),
            ("pods", "xla"), ("pods", "hierarchical"))
STEP_KW = dict(remat=False, peak_lr=1e-3, warmup_steps=1, total_steps=100)


def run(rank: int, n: int, init: str, inputs: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    try:
        results = _drive(inputs)
    finally:
        dist.destroy_process_group()
    torch.save(results, f"{out_dir}/rank{rank}.pt")


def _rows(mesh, t):
    """This rank's rows of a global batch (sharded over the data axes)."""
    d = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    k = t.shape[0] // mesh.axis_size(d)
    i = mesh.axis_index(d)
    return t[i * k:(i + 1) * k]


def _step_out(new, m):
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": new["params"]}


def _drive(inputs: dict) -> dict:
    meshes = {k: Mesh(*v) for k, v in MESHES.items()}
    out = {"coords": {k: m.coords for k, m in meshes.items()}}

    # 1. EP dispatch on each mesh and algorithm; the serve prefill
    cfg = configs.get_smoke("moonshot-v1-16b-a3b")
    p = moe.MoE(cfg.moe, cfg.d_model, device="meta")
    p.load_state_dict(inputs["moe"], assign=True)
    x = inputs["x"]
    for mk, mesh in meshes.items():
        for algo in EP_ALGOS:
            for tr in (("dist", "kernel") if algo == "pairwise"
                       else ("dist",)):
                disp = make_moe_dispatch(mesh, EPOptions(
                    alltoall=algo, capacity_factor=float(cfg.moe.n_experts),
                    transport=tr), cfg.mlp_act)
                with torch.no_grad():
                    out[("ep", mk, algo, tr)] = disp(p, cfg.moe,
                                                     _rows(mesh, x))
    disp = make_moe_dispatch(meshes["flat"], EPOptions(
        alltoall="pairwise", capacity_factor=float(cfg.moe.n_experts),
        overlap_chunks=2), cfg.mlp_act)
    with torch.no_grad():
        out[("ep_overlap",)] = disp(p, cfg.moe, _rows(meshes["flat"], x))
    model = M.from_state(cfg, inputs["moe_model"])
    toks = _rows(meshes["flat"], inputs["serve_tokens"])
    for tag, sopts in (
            ("default", ServeOptions()),
            ("ep_overlap", ServeOptions(ep_options=EPOptions(
                alltoall="pairwise",
                capacity_factor=float(cfg.moe.n_experts),
                overlap_chunks=2)))):
        out[("serve", tag)] = make_prefill_step(cfg, sopts, meshes["flat"])(
            model, toks)

    # 2-4. train steps from one state
    cfg = configs.get_smoke("smollm-360m")
    state, batch = inputs["state"], inputs["batch"]
    for mk, algo in DP_CASES:
        mesh = meshes[mk]
        b = {k: _rows(mesh, v) for k, v in batch.items()}
        for tr in ("dist", "kernel"):
            opts = TrainOptions(dp_mode="explicit", dp_algorithm=algo,
                                dp_transport=tr, **STEP_KW)
            new, m = make_train_step(cfg, mesh, opts)(state, b)
            out[("dp", mk, algo, tr)] = _step_out(new, m)
    flat, pods = meshes["flat"], meshes["pods"]
    bflat = {k: _rows(flat, v) for k, v in batch.items()}
    for tag, kw in (("buckets", dict(dp_algorithm="ring_rs_ag",
                                     grad_buckets=4)),
                    ("overlap", dict(dp_algorithm="ring_rs_ag",
                                     overlap_grad_chunks=2)),
                    ("overlap_base", dict(dp_algorithm="ring_rs_ag"))):
        new, m = make_train_step(cfg, flat, TrainOptions(
            dp_mode="explicit", **kw, **STEP_KW))(state, bflat)
        out[(tag,)] = _step_out(new, m)
    opts = TrainOptions(dp_mode="explicit", compress_dcn=True, **STEP_KW)
    st_c = dict(state, ef_residual={k: torch.zeros(v.shape)
                                    for k, v in state["params"].items()})
    new, m = make_train_step(cfg, pods, opts)(
        st_c, {k: _rows(pods, v) for k, v in batch.items()})
    out[("compressed",)] = dict(_step_out(new, m),
                                residual=new["ef_residual"])
    new, m = make_train_step(cfg, flat, TrainOptions(
        dp_mode="fsdp", **STEP_KW))(state, bflat)
    out[("fsdp",)] = _step_out(new, m)

    # the EP dispatch inside the explicit step (moonshot, f32, no drops)
    mcfg = configs.get_smoke("moonshot-v1-16b-a3b")
    mb = inputs["moe_batch"]
    opts = TrainOptions(dp_mode="explicit", moe_mode="mpix_ep",
                        ep_alltoall="pairwise",
                        ep_capacity=float(mcfg.moe.n_experts), **STEP_KW)
    new, m = make_train_step(mcfg, flat, opts)(
        inputs["moe_state"], {k: _rows(flat, v) for k, v in mb.items()})
    out[("ep_step",)] = _step_out(new, m)
    return out


def run_launcher(rank: int, n: int, port: int, argv: list,
                 out_dir: str) -> None:
    """One rank of the training launcher under a torchrun-like
    environment (``--mesh local`` joins its group)."""
    import os
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    from repro_torch.launch import train
    run = train.main(argv)
    torch.save({"losses": run.losses, "start": run.start_step},
               f"{out_dir}/launcher{rank}.pt")
