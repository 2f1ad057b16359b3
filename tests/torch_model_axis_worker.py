"""One rank of the port's model-axis test (tests/test_torch_model_axis.py).

Spawned by ``torch.multiprocessing.start_processes``: joins a gloo group
of 4 ranks (mesh (1, 4) over ``("data", "model")``) or 8 ranks (mesh
(2, 2, 2) over ``("pod", "data", "model")``) through a ``file://``
rendezvous.  For each case it runs two steps of the sequence-split
sharded step (``sharded_train_step``: each model rank its S/n rows),
recording every attention core's query and key rows and the first
step's collectives, and, for the MoE case at a capacity that drops
pairs, two steps of the unsplit sharded step on the same mesh beside
the split one; decodes through ``mesh_decode_step`` (parameter
blocks cut over ``model`` stay where they are stored) on its share of
the f32 weights; and, on 4 ranks, decodes once more through a view in
which every parameter whose last dim (an expert stack's or the
embedding's first) divides the model axis is a ``Resident`` block,
beside the plain decode of the same rows.  ``run_forwards`` (tests/
test_torch_model_axis_jax.py) runs the split forward of each arch's
smoke model on 4 ranks, on the weights the parent converts from the JAX
package's (it waits for their file), and saves its rows' logits.
Imports torch and the port only.
"""
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention, mla, moe
from repro_torch.models import model as M
from repro_torch.models.config import AttnConfig, BlockSpec, MLAConfig
from repro_torch.serve.step import (ServeOptions, _rows_dispatch,
                                    init_serve_cache, make_decode_step,
                                    mesh_decode_step)
from repro_torch.train import comm, shard, sharding
from repro_torch.train.step import (TrainOptions, init_train_state,
                                    sharded_train_step)

MESHES = {4: ((1, 4), ("data", "model")),
          8: ((2, 2, 2), ("pod", "data", "model"))}
STEP_KW = dict(remat=True, peak_lr=1e-3, warmup_steps=1, total_steps=100)
B, S = 8, 16                     # train batch: S / n rows a model rank
DEC_B, DEC_STEPS, DEC_LEN = 4, 3, 16
FWD_B = 2                        # the forward held against the JAX package
# the launchers on a local mesh with a model axis (the test runs each
# once in one process beside them)
TRAIN_ARGV = ["--arch", "smollm-360m", "--smoke", "--device", "cpu",
              "--batch", "8", "--seq", "32", "--steps", "3",
              "--log-every", "100"]
SERVE_ARGV = ["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
              "--batch", "4", "--prompt-len", "4", "--gen", "3"]
ARCHS = ("gemma2-2b", "deepseek-v3-671b", "rwkv6-3b",
         "jamba-1.5-large-398b", "whisper-small", "qwen2-vl-7b")


def _mlp_only(cfg):
    def fix(specs):
        return tuple(dataclasses.replace(s, ff="mlp") if s.ff == "moe"
                     else s for s in specs)
    return dataclasses.replace(cfg, prefix=fix(cfg.prefix),
                               period=fix(cfg.period),
                               suffix=fix(cfg.suffix), moe=None)


def gemma_cfg():
    """GQA, window 4 (it crosses the rank boundaries), attention and
    final softcaps; wide enough that the rules cut over ``model``."""
    base = configs.get_smoke("gemma2-2b")
    return dataclasses.replace(
        base, name="axis-gemma2", d_model=256, vocab_size=512, d_ff=256,
        period=(BlockSpec("attn", "mlp", window=4),
                BlockSpec("attn", "mlp", window=None)),
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=64,
                        rope_theta=10000.0, softcap=50.0))


def mla_moe_cfg():
    """deepseek-v3's MLA with MoE layers: expert stacks [8, 256, 48] cut
    over the EP axes (no other parameter has their bytes)."""
    base = configs.get_smoke("deepseek-v3-671b")
    return dataclasses.replace(
        base, name="axis-mla-moe", d_model=256, vocab_size=512, d_ff=256,
        mla=MLAConfig(q_lora_rank=128, kv_lora_rank=64,
                      qk_nope_head_dim=32, qk_rope_head_dim=16,
                      v_head_dim=32, n_heads=4),
        moe=dataclasses.replace(base.moe, n_experts=8, top_k=2,
                                d_expert=48, n_shared=1))


def rwkv_cfg():
    """4 heads of 64: the decode state ``s`` holds whole heads a rank."""
    base = configs.get_smoke("rwkv6-3b")
    return dataclasses.replace(
        base, name="axis-rwkv", d_model=256, vocab_size=512, d_ff=512,
        rwkv=dataclasses.replace(base.rwkv, head_dim=64, decay_lora=16))


def jamba_cfg():
    base = _mlp_only(configs.get_smoke("jamba-1.5-large-398b"))
    return dataclasses.replace(
        base, name="axis-jamba", d_model=128, vocab_size=512, d_ff=256,
        attn=dataclasses.replace(base.attn, n_heads=4, n_kv_heads=2,
                                 head_dim=32))


def whisper_cfg():
    """30 encoder frames: they divide a model axis of 2, not one of 4."""
    base = configs.get_smoke("whisper-small")
    return dataclasses.replace(
        base, name="axis-whisper", d_model=128, vocab_size=512, d_ff=256,
        attn=dataclasses.replace(base.attn, n_heads=4, n_kv_heads=4,
                                 head_dim=32),
        encoder=dataclasses.replace(base.encoder, d_model=128, n_heads=4,
                                    d_ff=256, n_frames=30))


def qwen_cfg():
    """M-RoPE and an 8-row vision prefix."""
    base = configs.get_smoke("qwen2-vl-7b")
    return dataclasses.replace(
        base, name="axis-qwen2-vl", d_model=256, vocab_size=512, d_ff=256,
        attn=dataclasses.replace(base.attn, n_heads=4, n_kv_heads=2,
                                 head_dim=64, mrope_sections=(8, 12, 12)))


# name -> (config, moe_mode, ep_capacity): the MoE case's capacity
# (E / k = 4) drops no pair, so its capacity dispatch is the dense one
CASES = {"gemma2": (gemma_cfg, "dropless", 1.25),
         "mla_moe": (mla_moe_cfg, "mpix_ep", 4.0),
         "rwkv": (rwkv_cfg, "dropless", 1.25),
         "jamba": (jamba_cfg, "dropless", 1.25),
         "whisper": (whisper_cfg, "dropless", 1.25),
         "qwen2_vl": (qwen_cfg, "dropless", 1.25)}


def opts_for(name, **kw):
    _, moe_mode, cap = CASES[name]
    kw = dict(dict(moe_mode=moe_mode, ep_capacity=cap), **kw)
    return TrainOptions(dp_mode="fsdp", **STEP_KW, **kw)


def extras(cfg, b, seed):
    """An encoder-decoder's frames, a VLM's vision prefix."""
    g = torch.Generator()
    g.manual_seed(seed + 100)
    kw = {}
    if cfg.encoder is not None:
        kw["encoder_frames"] = torch.randn(
            (b, cfg.encoder.n_frames, cfg.encoder.d_model),
            generator=g).to(torch.bfloat16)
    if cfg.vision_prefix:
        kw["vision_embeds"] = torch.randn(
            (b, cfg.vision_prefix, cfg.d_model), generator=g).to(
            torch.bfloat16)
    return kw


def train_state(cfg, opts) -> dict:
    """The seeded train state with f32 weights (see the test's
    docstring)."""
    g = torch.Generator()
    g.manual_seed(0)
    st = init_train_state(g, cfg, opts)
    st["params"] = {k: v.float() for k, v in st["params"].items()}
    return st


TRAIN_ROWS = {"mla_moe": 4}      # the MoE case's batch
# the MoE case at a capacity that binds, on 2 rows a data rank: a model
# rank's token slice is half a row on (1, 4) and a whole row on
# (2, 2, 2), neither its sequence block
DROP_CAPACITY, DROP_ROWS = 1.0, 2


def batch(name, cfg, seed, b=None):
    g = torch.Generator()
    g.manual_seed(seed)
    b = b or TRAIN_ROWS.get(name, B)
    tok = torch.randint(0, cfg.vocab_size, (b, S + 1), generator=g,
                        dtype=torch.int32)
    labels = tok[:, 1:].clone()
    labels[:, :2] = -1                      # some masked labels
    return {"tokens": tok[:, :-1].contiguous(), "labels": labels,
            **{k: v.float() for k, v in extras(cfg, b, seed).items()}}


def rows_of(mesh, t):
    d = sharding.data_axes(mesh)
    k = t.shape[0] // mesh.axis_size(d)
    i = mesh.axis_index(d)
    return t[i * k:(i + 1) * k]


def params_f32(cfg) -> dict:
    g = torch.Generator()
    g.manual_seed(0)
    return {k: v.float() for k, v in
            M.init_params(cfg, generator=g).state_dict().items()}


def dec_tokens(cfg) -> torch.Tensor:
    g = torch.Generator()
    g.manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (DEC_B, DEC_STEPS), generator=g,
                         dtype=torch.int32)


class _Calls:
    """Records (query rows, key rows) of every attention core call."""

    def __init__(self):
        self.calls = []
        self.saved = (attention.core_attention, mla._attend)

    def __enter__(self):
        core, attend = self.saved

        def core_(q, k, v, mask, **kw):
            self.calls.append((q.shape[1], k.shape[1]))
            return core(q, k, v, mask, **kw)

        def attend_(p, cfg, q_nope, q_rope, ckv, k_rope, mask, kv=None):
            self.calls.append((q_nope.shape[1], ckv.shape[1]))
            return attend(p, cfg, q_nope, q_rope, ckv, k_rope, mask, kv=kv)
        attention.core_attention, mla._attend = core_, attend_
        return self

    def __exit__(self, *exc):
        attention.core_attention, mla._attend = self.saved


def run(rank: int, n: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    try:
        results = drive(Mesh(*MESHES[n]))
        if n == 4:
            from repro_torch.launch import serve as launch_serve
            from repro_torch.launch import train as launch_train
            results["launch_train"] = launch_train.main(
                TRAIN_ARGV + ["--model-axis", "2"]).losses
            results["launch_serve"] = launch_serve.main(
                SERVE_ARGV + ["--mesh", "local", "--model-axis", "4"])
    finally:
        dist.destroy_process_group()
    torch.save(results, f"{out_dir}/rank{rank}.pt")


def run_forwards(rank: int, n: int, init: str, out_dir: str,
                 arch_params: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    try:
        deadline = time.monotonic() + 600
        while not os.path.exists(arch_params + ".done"):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {arch_params}")
            time.sleep(0.1)
        mesh = Mesh(*MESHES[n])
        results = {"coords": mesh.coords,
                   "logits": jax_forwards(mesh, arch_params)}
    finally:
        dist.destroy_process_group()
    torch.save(results, f"{out_dir}/rank{rank}.pt")


def train(mesh, name, rows=None, **kw) -> dict:
    cfg = CASES[name][0]()
    opts = opts_for(name, **kw)
    full = train_state(cfg, opts)
    step, sspec = sharded_train_step(cfg, mesh, opts, full,
                                     sharding.batch_specs(mesh))
    sh = shard.cut_tree(full, sspec, mesh)
    losses, norms = [], []
    with _Calls() as calls:
        for i, seed in enumerate((1, 2)):
            b = {k: rows_of(mesh, v) for k, v in batch(name, cfg, seed,
                                                        rows).items()}
            if i == 0:
                with comm.recording() as log:
                    sh, m = step(sh, b)
            else:
                sh, m = step(sh, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    back = shard.gather_tree(sh, sspec, mesh)
    return {"loss": losses, "grad_norm": norms, "params": back["params"],
            "mu": back["opt"]["mu"], "calls": calls.calls, "log": log}


def train_drops(mesh) -> dict:
    """The MoE case at ``DROP_CAPACITY`` on ``DROP_ROWS`` rows a data
    rank: the split step (True) and the unsplit step on the same mesh
    (False: ``shard.seq_split`` gives no split, so every model rank runs
    the data rank's whole rows and cuts its token slice from them)."""
    kw = dict(rows=DROP_ROWS * mesh.axis_size(sharding.data_axes(mesh)),
              ep_capacity=DROP_CAPACITY)
    with _Drops() as drops:
        out = {True: train(mesh, "mla_moe", **kw)}
    out[True]["dropped"] = drops.pairs
    saved = shard.seq_split
    shard.seq_split = lambda mesh: None
    try:
        with _Drops() as drops:
            out[False] = train(mesh, "mla_moe", **kw)
        out[False]["dropped"] = drops.pairs
    finally:
        shard.seq_split = saved
    return out


class _Drops:
    """Counts the (token, expert) pairs the capacity dispatch drops: per
    routing of T tokens, each expert's pairs past its capacity."""

    def __init__(self):
        self.pairs = 0
        self.saved = moe.route

    def __enter__(self):
        def route(p, cfg, x):
            w, idx, aux = self.saved(p, cfg, x)
            cap = max(1, int(idx.shape[0] * cfg.top_k / cfg.n_experts
                             * DROP_CAPACITY))
            n = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
            self.pairs += int(torch.clamp(n - cap, min=0).sum())
            return w, idx, aux
        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self.saved


def _cross(cfg, model, b0, b):
    if cfg.encoder is None:
        return None
    frames = extras(cfg, DEC_B, 7)["encoder_frames"].float()
    return M.encode(model, cfg, frames)[b0:b0 + b]


def decode(mesh, name) -> dict:
    cfg = CASES[name][0]()
    params = params_f32(cfg)
    full = init_serve_cache(cfg, DEC_B, DEC_LEN, device="meta",
                            dtype=torch.float32)
    step, (pspec, cspec) = mesh_decode_step(cfg, mesh, ServeOptions(),
                                            params, full)
    blocks = shard.cut_tree(params, pspec, mesh)
    cache = shard.zeros_tree(full, cspec, mesh, device="cpu")
    d_axes = sharding.data_axes(mesh)
    nb = DEC_B // mesh.axis_size(d_axes)
    r0 = mesh.axis_index(d_axes) * nb
    toks = dec_tokens(cfg)[r0:r0 + nb]
    cross = _cross(cfg, M.from_state(cfg, params), r0, nb)
    logits, logs = [], []
    for i in range(DEC_STEPS):
        with comm.recording() as log:
            _, cache, last = step(blocks, cache, toks[:, i:i + 1], cross)
        logits.append(last)
        logs.append(log)
    return {"logits": torch.stack(logits, 1), "logs": logs}


def resident_view(cfg, params: dict, mesh):
    """Every parameter a ``Resident`` block over ``model`` where its cut
    dim divides the axis (an expert stack and the embedding on their
    first dim, the rest on their last), whatever the size rules say."""
    group = mesh.group("model")
    n, r = mesh.shape["model"], mesh.coords["model"]
    out = {}
    for k, t in params.items():
        stack = ".moe.w_" in k and ".shared." not in k
        dim = 0 if stack or k == "embed" else t.ndim - 1
        if t.ndim < 2 or t.shape[dim] % n:
            out[k] = t
            continue
        blk = t.shape[dim] // n
        out[k] = shard.Resident(t.narrow(dim, r * blk, blk).clone(), dim,
                                t.shape, group)
    n_res = sum(isinstance(v, shard.Resident) for v in out.values())
    return shard._ns(shard._tree(out)), n_res


def resident_decode(mesh, name) -> dict:
    """The all-resident view's decode and the plain decode of the same
    rows (every rank decodes the whole batch)."""
    cfg = CASES[name][0]()
    params = params_f32(cfg)
    model = M.from_state(cfg, params)
    view, n_res = resident_view(cfg, params, mesh)
    dispatch = _rows_dispatch(cfg, mesh, ()) if cfg.moe else None
    toks = dec_tokens(cfg)
    cross = _cross(cfg, model, 0, DEC_B)
    plain = make_decode_step(cfg, ServeOptions())
    c_view = init_serve_cache(cfg, DEC_B, DEC_LEN, dtype=torch.float32)
    c_plain = init_serve_cache(cfg, DEC_B, DEC_LEN, dtype=torch.float32)
    got, want = [], []
    with torch.no_grad():
        for i in range(DEC_STEPS):
            lg, c_view = M.decode_step(view, cfg, c_view, toks[:, i:i + 1],
                                       cross_src=cross,
                                       moe_dispatch=dispatch)
            got.append(lg[:, -1])
            _, c_plain, last = plain(model, c_plain, toks[:, i:i + 1],
                                     cross)
            want.append(last)
    return {"got": torch.stack(got, 1), "want": torch.stack(want, 1),
            "n_resident": n_res}


def jax_forwards(mesh, path: str) -> dict:
    """This rank's rows of the split forward of each arch's smoke model
    on the parent's converted JAX weights (f32)."""
    data = torch.load(path, weights_only=False)
    split = shard.seq_split(mesh)
    out = {}
    for arch in ARCHS:
        cfg = configs.get_smoke(arch)
        d = data[arch]
        with torch.no_grad():
            model = M.from_state(cfg, d["params"])
            out[arch] = M.forward(model, cfg, d["tokens"], split=split,
                                  **d["kw"])
    return out


def drive(mesh) -> dict:
    """Every case; the all-resident view on the 4-rank mesh only (a
    model axis of 4 cuts more than one of 2)."""
    out = {"coords": mesh.coords, "drops": train_drops(mesh)}
    for name in CASES:
        out[name] = {"train": train(mesh, name), "decode": decode(mesh, name)}
        if mesh.shape["model"] == 4:
            out[name]["resident"] = resident_decode(mesh, name)
    return out
