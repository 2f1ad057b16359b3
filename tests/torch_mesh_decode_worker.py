"""One rank of the port's mesh-decode test (tests/test_torch_mesh_decode.py).

Spawned by ``torch.multiprocessing.spawn``: joins a gloo group of 4
ranks (mesh (2, 2) over ``("data", "model")``) or 8 (mesh (2, 2, 2)
over ``("pod", "data", "model")``) through a ``file://`` rendezvous;
for each config and layout (normal, ``long_context``) decodes six steps
through ``mesh_decode_step`` on its share of the f32 weights and cache,
and saves its logits, its stored cache and parameter bytes and the
collectives each step issued.  On 4 ranks it also runs the serving
launcher with ``--mesh local`` and ``--mesh single``.  Imports torch and
the port only.
"""
import dataclasses

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.models.config import AttnConfig, BlockSpec
from repro_torch.serve.step import (ServeOptions, init_serve_cache,
                                    mesh_decode_step)
from repro_torch.train import comm, shard, sharding

MESHES = {4: ((2, 2), ("data", "model")),
          8: ((2, 2, 2), ("pod", "data", "model"))}
STEPS, MAX_LEN = 6, 16
LAUNCH_ARGV = ["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
               "--batch", "4", "--prompt-len", "4", "--gen", "3"]


def _mlp_only(cfg):
    """The config with every MoE feed-forward an MLP (each rank's rows
    then decode as a batch of their own: see the test's one-device
    yardstick)."""
    def fix(specs):
        return tuple(dataclasses.replace(s, ff="mlp") if s.ff == "moe"
                     else s for s in specs)
    return dataclasses.replace(cfg, prefix=fix(cfg.prefix),
                               period=fix(cfg.period),
                               suffix=fix(cfg.suffix), moe=None)


def gemma_cfg():
    """Window 4 (it masks within six steps), softcaps, and wide enough
    that the parameter rules cut (embed [512, 256], wq [256, 256])."""
    base = configs.get_smoke("gemma2-2b")
    return dataclasses.replace(
        base, name="mesh-gemma2", d_model=256, vocab_size=512, d_ff=256,
        period=(BlockSpec("attn", "mlp", window=4),
                BlockSpec("attn", "mlp", window=None)),
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=64,
                        rope_theta=10000.0, softcap=50.0))


CASES = {
    "gemma2": gemma_cfg,
    "mla": lambda: _mlp_only(configs.get_smoke("deepseek-v3-671b")),
    "rwkv": lambda: configs.get_smoke("rwkv6-3b"),
    "jamba": lambda: _mlp_only(configs.get_smoke("jamba-1.5-large-398b")),
    # MoE layers: decode's capacity dispatch runs on the data group's
    # gathered rows (capacity 2 of 8 experts at 4 rows: pairs can drop)
    "mla_moe": lambda: configs.get_smoke("deepseek-v3-671b"),
}


def params_f32(cfg) -> dict:
    g = torch.Generator()
    g.manual_seed(0)
    return {k: v.float() for k, v in
            M.init_params(cfg, generator=g).state_dict().items()}


def tokens(cfg, B: int) -> torch.Tensor:
    g = torch.Generator()
    g.manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (B, STEPS), generator=g,
                         dtype=torch.int32)


def batch_for(long_context: bool) -> int:
    return 1 if long_context else 4


def run(rank: int, n: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    try:
        results = drive(Mesh(*MESHES[n]))
        if n == 4:
            results["launch"] = launch_serve.main(LAUNCH_ARGV
                                                  + ["--mesh", "local"])
            try:
                launch_serve.main(LAUNCH_ARGV + ["--mesh", "single"])
                results["refusal"] = None
            except SystemExit as e:
                results["refusal"] = str(e)
    finally:
        dist.destroy_process_group()
    torch.save(results, f"{out_dir}/rank{rank}.pt")


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in sharding.flat_names(tree).values()
               if isinstance(t, torch.Tensor))


def drive(mesh) -> dict:
    out = {"coords": mesh.coords}
    d_axes = sharding.data_axes(mesh)
    for name, make in CASES.items():
        cfg = make()
        params = params_f32(cfg)
        for long in (False, True):
            B = batch_for(long)
            full = init_serve_cache(cfg, B, MAX_LEN, device="meta",
                                    dtype=torch.float32)
            step, (pspec, cspec) = mesh_decode_step(
                cfg, mesh, ServeOptions(long_context=long), params, full)
            blocks = shard.cut_tree(params, pspec, mesh)
            cache = shard.zeros_tree(full, cspec, mesh, device="cpu")
            toks = tokens(cfg, B)
            if not long:
                rows = B // mesh.axis_size(d_axes)
                r0 = mesh.axis_index(d_axes) * rows
                toks = toks[r0:r0 + rows]
            stored = _bytes(cache)
            logits, logs = [], []
            for i in range(STEPS):
                with comm.recording() as log:
                    _, cache, last = step(blocks, cache, toks[:, i:i + 1])
                logits.append(last)
                logs.append(log)
            out[(name, long)] = {
                "logits": torch.stack(logits, 1), "stored": stored,
                "stored_after": _bytes(cache),
                "param_bytes": _bytes(blocks), "logs": logs}
    return out
