"""A Jamba decoder's prompt processing (prefill), in plain float32
PyTorch, layer by layer.

Per layer: RMSNorm, then the mixer -- Mamba-1 (in-projection to x and
z, a causal depthwise convolution with bias and SiLU, the x-projection
to dt, B and C each RMS-normed, dt = softplus(dt W_dt + dt_bias), the
selective recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t =
C_t . h_t + D x_t, y gated by SiLU(z), out-projection) or grouped-query
causal attention without positions -- and a residual; RMSNorm, the
feed-forward (a SwiGLU MLP, or the MoE: softmax router over all
experts, the top-k experts' SwiGLU outputs weighted by their router
probabilities, left unnormalised as transformers' JambaSparseMoeBlock
does), residual.  A final RMSNorm and the untied head.

The recurrence runs in float64 in chunks: within a chunk, with a_t the
running sum of dt A, h_t = exp(a_t) (h_in + sum_{s<=t} exp(-a_s) u_s),
which is the step-by-step recurrence in exact arithmetic; a chunk whose
decay would overflow float64 is halved.
"""
from __future__ import annotations

import torch

from perfbench.reference.common import PRODUCTS, STORES, rmsnorm, silu

SCAN_CHUNK = 64
ATTN_ROWS = 1024


def _scan_chunk(x, dt, Bm, Cm, A, h0):
    """Rows of one chunk: x, dt [l, Di]; Bm, Cm [l, S]; A [Di, S]; h0
    [Di, S] (float64) -> (y [l, Di] float64 without D x, h at its end)."""
    a = torch.cumsum(dt.double()[:, :, None] * A.double()[None], 0)
    if float((-a[-1]).max()) > 600 and x.shape[0] > 1:
        m = x.shape[0] // 2
        y1, h = _scan_chunk(x[:m], dt[:m], Bm[:m], Cm[:m], A, h0)
        y2, h = _scan_chunk(x[m:], dt[m:], Bm[m:], Cm[m:], A, h)
        return torch.cat([y1, y2]), h
    u = (dt.double() * x.double())[:, :, None] * Bm.double()[:, None, :]
    hs = torch.exp(a) * (h0[None] + torch.cumsum(torch.exp(-a) * u, 0))
    return torch.einsum("tdn,tn->td", hs, Cm.double()), hs[-1]


def selective_scan(x, dt, Bm, Cm, A, Dv):
    """One sequence: x, dt [T, Di]; Bm, Cm [T, S]; A [Di, S]; Dv [Di] ->
    y [T, Di] (float32)."""
    h = torch.zeros(A.shape, dtype=torch.float64, device=x.device)
    ys = []
    for t0 in range(0, x.shape[0], SCAN_CHUNK):
        sl = slice(t0, t0 + SCAN_CHUNK)
        y, h = _scan_chunk(x[sl], dt[sl], Bm[sl], Cm[sl], A, h)
        ys.append(y)
    return (torch.cat(ys) + Dv.double() * x.double()).float()


def mamba(P, p, z, h, mm, st):
    """h [T, d] (normed) -> the mixer's output [T, d]."""
    Di, S, R, K = z["Di"], z["S"], z["R"], z["conv"]
    xz = st(mm(h, P[p + "w_in"]))
    x, gate = xz[:, :Di], xz[:, Di:]
    T = x.shape[0]
    xp = torch.cat([x.new_zeros(K - 1, Di), x])
    w = P[p + "conv_w"]
    x = st(silu(sum(xp[i: i + T] * w[i] for i in range(K)) + P[p + "conv_b"]))
    proj = st(mm(x, P[p + "w_x"]))
    dt = rmsnorm(proj[:, :R], P[p + "dt_norm"], z["eps"])
    Bm = rmsnorm(proj[:, R: R + S], P[p + "b_norm"], z["eps"])
    Cm = rmsnorm(proj[:, R + S:], P[p + "c_norm"], z["eps"])
    dt = torch.logaddexp(mm(dt, P[p + "w_dt"]) + P[p + "dt_bias"],
                         torch.zeros((), device=h.device))
    y = selective_scan(x, dt, Bm, Cm, -torch.exp(P[p + "A_log"]), P[p + "D"])
    return st(mm(st(y * silu(gate)), P[p + "w_out"]))


def attention(P, p, z, h, mm, st):
    """Causal grouped-query attention without positions, queries in
    blocks of ATTN_ROWS rows."""
    T, H, K, D = h.shape[0], z["H"], z["K"], z["D"]
    q = st(mm(h, P[p + "wq"])).view(T, H, D)
    k = st(mm(h, P[p + "wk"])).view(T, K, D).repeat_interleave(H // K, dim=1)
    v = st(mm(h, P[p + "wv"])).view(T, K, D).repeat_interleave(H // K, dim=1)
    out = torch.empty_like(q)
    kpos = torch.arange(T, device=h.device)
    for r0 in range(0, T, ATTN_ROWS):
        qs = q[r0: r0 + ATTN_ROWS]
        s = torch.einsum("qhd,khd->hqk", qs, k) * D ** -0.5
        qpos = kpos[r0: r0 + qs.shape[0]]
        s = s.masked_fill(kpos[None, None] > qpos[None, :, None],
                          float("-inf"))
        out[r0: r0 + qs.shape[0]] = torch.einsum(
            "hqk,khd->qhd", torch.softmax(s, -1), v)
    return st(mm(st(out.reshape(T, H * D)), P[p + "wo"]))


def mlp(h, wg, wu, wd, mm, st):
    return st(mm(st(silu(st(mm(h, wg))) * st(mm(h, wu))), wd))


def moe(P, p, z, h, mm, st):
    probs = torch.softmax(mm(h, P[p + "router"]), -1)
    w, idx = torch.topk(probs, z["top_k"], -1)
    out = torch.zeros_like(h)
    for e in range(z["E"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            y = mlp(h[rows], P[p + "w_gate"][e], P[p + "w_up"][e],
                    P[p + "w_down"][e], mm, st)
            out.index_add_(0, rows, y * w[rows, slot, None])
    return st(out)


def prefill(load_group, z, kinds, prompts, judge, precision="f32"):
    """The logits of every position of every prompt.

    ``load_group(name)`` gives the float32 weights of group ``top`` or
    ``layers.{i}``; ``kinds`` the (mixer, ff) of each layer; ``prompts``
    token ids [T] on the device.  The prompts go through the layers
    together, one layer's weights at a time; then ``judge(i, logits)``
    takes each prompt's logits [T, V] in turn.  ``precision`` "fp8" is
    the control: products of fp8 operands, and every activation kept in
    fp8 where the program keeps it in its working type."""
    mm, st = PRODUCTS[precision], STORES[precision]
    top = load_group("top")
    xs = [st(top["embed"][t].float()) for t in prompts]
    for i, (mixer, ff) in enumerate(kinds):
        P, p = load_group(f"layers.{i}"), f"layers.{i}."
        for j, x in enumerate(xs):
            h = st(rmsnorm(x, P[p + "norm_mixer"], z["eps"]))
            x = st(x + (mamba(P, p + "mamba.", z, h, mm, st)
                        if mixer == "mamba"
                        else attention(P, p + "attn.", z, h, mm, st)))
            h = st(rmsnorm(x, P[p + "norm_ff"], z["eps"]))
            x = st(x + (moe(P, p + "moe.", z, h, mm, st) if ff == "moe" else
                        mlp(h, P[p + "mlp.w_gate"], P[p + "mlp.w_up"],
                            P[p + "mlp.w_down"], mm, st)))
            xs[j] = x
        del P
    head = top["embed"].t() if z["tied"] else top["lm_head"]
    for j, x in enumerate(xs):
        judge(j, st(mm(st(rmsnorm(x, top["final_norm"], z["eps"])), head)))
