"""One rank of the port's sharded-storage test
(tests/test_torch_sharded_step.py).

Spawned by ``torch.multiprocessing.spawn``: joins a gloo group of 4
ranks (mesh (4, 1) over ``("data", "model")``) or 8 ranks (mesh (2, 2,
2) over ``("pod", "data", "model")``) through a ``file://`` rendezvous;
for each case runs two steps of the replicated fsdp step
(``make_train_step``) and two of the sharded one
(``sharded_train_step``) on its own rows, and saves the losses, the
gathered parameters and moments, its stored bytes and the collectives
the first sharded step issued (``train.comm.recording``).  Imports torch
and the port only.
"""
import dataclasses

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import AttnConfig
from repro_torch.train import comm, shard, sharding
from repro_torch.train.step import (TrainOptions, init_train_state,
                                    make_train_step, sharded_train_step)

MESHES = {4: ((4, 1), ("data", "model")),
          8: ((2, 2, 2), ("pod", "data", "model"))}
STEP_KW = dict(remat=True, peak_lr=1e-3, warmup_steps=1, total_steps=100)
B, S = 8, 16


def dense_cfg():
    """Wide enough that the rules cut: embed [512, 256], wq [256, 256]."""
    return dataclasses.replace(
        configs.get_smoke("smollm-360m"), name="sharded-dense",
        d_model=256, vocab_size=512, d_ff=512, n_periods=2,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=64))


def moe_cfg():
    """Expert stacks [8, 256, 64]: cut over the EP axes and data."""
    base = configs.get_smoke("moonshot-v1-16b-a3b")
    return dataclasses.replace(
        base, name="sharded-moe", d_model=256, vocab_size=512, d_ff=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=64,
                        rope_theta=50000.0),
        moe=dataclasses.replace(base.moe, n_experts=8, top_k=2,
                                d_expert=64, n_shared=1))


CASES = {"dense": (dense_cfg, "dropless"),
         "moe_dropless": (moe_cfg, "dropless"),
         "moe_ep": (moe_cfg, "mpix_ep")}


def batch(cfg, seed):
    g = torch.Generator()
    g.manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                        dtype=torch.int32)
    labels = tok[:, 1:].clone()
    labels[:, :2] = -1                      # some masked labels
    return {"tokens": tok[:, :-1].contiguous(), "labels": labels}


def rows(mesh, t):
    d = sharding.data_axes(mesh)
    k = t.shape[0] // mesh.axis_size(d)
    i = mesh.axis_index(d)
    return t[i * k:(i + 1) * k]


def run(rank: int, n: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    try:
        results = drive(Mesh(*MESHES[n]))
    finally:
        dist.destroy_process_group()
    torch.save(results, f"{out_dir}/rank{rank}.pt")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree.values())


def _stored(state) -> dict:
    return {"params": _nbytes(state["params"]),
            "mu": _nbytes(state["opt"]["mu"]),
            "nu": _nbytes(state["opt"]["nu"])}


def drive(mesh) -> dict:
    out = {"coords": mesh.coords}
    for name, (make, moe_mode) in CASES.items():
        cfg = make()
        opts = TrainOptions(dp_mode="fsdp", moe_mode=moe_mode,
                            ep_capacity=2.0, **STEP_KW)
        g = torch.Generator()
        g.manual_seed(0)
        full = init_train_state(g, cfg, opts)
        batches = [{k: rows(mesh, v) for k, v in batch(cfg, s).items()}
                   for s in (1, 2)]
        ref_step = make_train_step(cfg, mesh, opts)
        st, ref, ref_norm = full, [], []
        for b in batches:
            st, m = ref_step(st, b)
            ref.append(float(m["loss"]))
            ref_norm.append(float(m["grad_norm"]))
        step, sspec = sharded_train_step(cfg, mesh, opts, full,
                                         sharding.batch_specs(mesh))
        sh = shard.cut_tree(full, sspec, mesh)
        stored = _stored(sh)
        losses, norms = [], []
        for i, b in enumerate(batches):
            if i == 0:
                with comm.recording() as log:
                    sh, m = step(sh, b)
            else:
                sh, m = step(sh, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        after = _stored(sh)
        back = shard.gather_tree(sh, sspec, mesh)
        out[name] = {"ref_loss": ref, "ref_norm": ref_norm,
                     "ref_params": st["params"],
                     "ref_mu": st["opt"]["mu"], "ref_nu": st["opt"]["nu"],
                     "loss": losses,
                     "grad_norm": norms, "params": back["params"],
                     "mu": back["opt"]["mu"], "nu": back["opt"]["nu"],
                     "stored": stored, "stored_after": after,
                     "log": log}
    return out
