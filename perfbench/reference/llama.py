"""A llama-architecture decoder (smollm-360m) and its AdamW training
steps, in plain float32 PyTorch.

Embedding, then per layer: RMSNorm, grouped-query attention with rotary
positions (the rotate-half form, frequencies theta^(-2i/D)), causal
softmax over every earlier position, output projection, residual;
RMSNorm, SwiGLU MLP, residual.  A final RMSNorm and the head, the
embedding's transpose when tied.  The loss is the mean next-token
cross-entropy.  Weights are named as the benchmark hands them out
(``layers.{i}.attn.wq`` [d, H D], applied as ``x @ w``).
"""
from __future__ import annotations

import torch

from perfbench.reference.common import (PRODUCTS, STORES, adamw,
                                        cosine_lr, rmsnorm, silu)


def _rope(x, theta):
    """x [B, S, h, D] rotated by its positions 0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                          device=x.device) / D))
    ang = (torch.arange(S, dtype=torch.float64, device=x.device)[:, None]
           * freqs).float()
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v):
    """Causal grouped-query attention, q [B, S, H, D], k/v [B, S, K, D]
    (query head h reads key head h // (H / K)) -> [B, S, H, D]."""
    H, K, S, D = q.shape[2], k.shape[2], q.shape[1], q.shape[3]
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    live = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~live, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def logits(P: dict, z: dict, tokens, precision="f32"):
    """tokens [B, S] -> logits [B, S, V] (float32).  ``precision`` "fp8"
    is the control: products of fp8 operands, and every activation kept
    in fp8 where the program keeps it in its working type."""
    mm, st = PRODUCTS[precision], STORES[precision]
    B, S = tokens.shape
    H, K, D = z["H"], z["K"], z["D"]
    x = st(P["embed"][tokens])
    for i in range(z["L"]):
        p = f"layers.{i}."
        h = st(rmsnorm(x, P[p + "norm_mixer"], z["eps"]))
        q = st(_rope(mm(h, P[p + "attn.wq"]).view(B, S, H, D),
                     z["rope_theta"]))
        k = st(_rope(mm(h, P[p + "attn.wk"]).view(B, S, K, D),
                     z["rope_theta"]))
        v = st(mm(h, P[p + "attn.wv"]).view(B, S, K, D))
        a = st(attention(q, k, v).reshape(B, S, H * D))
        x = st(x + st(mm(a, P[p + "attn.wo"])))
        h = st(rmsnorm(x, P[p + "norm_ff"], z["eps"]))
        g = st(silu(st(mm(h, P[p + "mlp.w_gate"]))) * st(mm(h, P[p + "mlp.w_up"])))
        x = st(x + st(mm(g, P[p + "mlp.w_down"])))
    x = st(rmsnorm(x, P["final_norm"], z["eps"]))
    head = P["embed"].t() if z["tied"] else P["lm_head"]
    return st(mm(x, head))


def loss_sum(P, z, tokens, labels, precision="f32"):
    """(sum of the next-token cross-entropies, count of live labels)."""
    lg = logits(P, z, tokens, precision)
    live = labels >= 0
    nll = torch.nn.functional.cross_entropy(
        lg.reshape(-1, lg.shape[-1]), labels.clamp(min=0).reshape(-1),
        reduction="none") * live.reshape(-1)
    return nll.sum(), live.sum()


def train_steps(P0: dict, z: dict, batches, opts: dict, *, b1=0.9,
                precision="f32", group=None, store=None) -> dict:
    """AdamW steps from the weights ``P0`` (float32, modified in place)
    over ``batches`` (each ``tokens`` / ``labels`` [B, S] on the
    device), one row a forward and backward pass, the gradient of the
    mean loss over every live label of the step.  With ``group`` (a process group) each rank passes its own rows and the
    sums of losses, counts and gradients are taken over the group.
    ``store`` (a dict leaf name -> dtype) rounds each leaf to the type
    the configuration keeps it in after every update.

    Returns the readings the check compares: ``losses`` (each step's
    mean loss), ``grad_norm`` (the first step's global gradient norm
    before the clip), ``grad_norms`` (per leaf, of the first step's gradient
    as the optimizer takes it, after the global-norm clip),
    ``raw_grad_norms`` (the same before the clip) and ``change_norms``
    (per leaf, the norm of the weights' change over all the steps)."""
    start = {k: v.detach().clone() for k, v in P0.items()}
    P = {k: v.detach().requires_grad_(True) for k, v in P0.items()}
    mu = {k: torch.zeros_like(v) for k, v in P.items()}
    nu = {k: torch.zeros_like(v) for k, v in P.items()}
    out = {"losses": []}
    for step, batch in enumerate(batches):
        grads = {k: torch.zeros_like(v) for k, v in P.items()}
        tot = torch.zeros((), dtype=torch.float64, device=batch["tokens"].device)
        cnt = torch.zeros((), dtype=torch.float64, device=tot.device)
        for r in range(batch["tokens"].shape[0]):
            s, c = loss_sum(P, z, batch["tokens"][r:r + 1],
                            batch["labels"][r:r + 1], precision)
            gs = torch.autograd.grad(s, list(P.values()))
            for k, g in zip(P, gs):
                grads[k] += g
            tot += s.detach().double()
            cnt += c.double()
        if group is not None:
            import torch.distributed as dist
            for t in (tot, cnt, *grads.values()):
                dist.all_reduce(t, group=group)
        denom = cnt.clamp(min=1).float()
        for g in grads.values():
            g.div_(denom)
        out["losses"].append(float(tot / cnt.clamp(min=1)))
        gnorm = torch.sqrt(sum(torch.sum(g.double() ** 2)
                               for g in grads.values()))
        scale = min(1.0, opts["max_grad_norm"] / (float(gnorm) + 1e-9))
        if step == 0:
            out["grad_norm"] = float(gnorm)
            out["raw_grad_norms"] = {k: float(g.norm()) for k, g in
                                     grads.items()}
            out["grad_norms"] = {k: v * scale for k, v in
                                 out["raw_grad_norms"].items()}
        for g in grads.values():
            g.mul_(scale)
        lr = cosine_lr(step, peak_lr=opts["peak_lr"],
                       warmup_steps=opts["warmup_steps"],
                       total_steps=opts["total_steps"])
        for k in P:
            adamw({k: P[k]}, grads, mu, nu, step + 1, lr=lr, b1=b1,
                  weight_decay=opts["weight_decay"],
                  store=None if store is None else store[k])
    out["change_norms"] = {k: float((P[k].detach() - start[k]).norm())
                           for k in P}
    return out
