"""Expert-parallel MoE dispatch through the MPIX layer (paper §2.1+§2.2).

Experts are sharded over the EP axes (``("pod", "model")`` when the
expert count divides, else ``("model",)``); tokens travel to their
experts through ``mpix_alltoall`` with a *selectable algorithm*: on a
mesh with pods the ``hierarchical`` algorithm aggregates everything
headed to a remote pod inside the source pod first, the paper's
locality-aware optimization applied to MoE traffic.

Layout, on every rank of the mesh (each rank calls with its own tensors):
  x        [B_local, S, d]  this rank's batch rows (sharded over the
                            data axes, the same on every model rank);
                            each model rank takes its 1/M token slice.
                            Under a sequence split (``split``) x is the
                            rank's block of the sequence: one uneven
                            all-to-all over ``model``
                            (``comm.seq_to_tokens``) turns it into the
                            same token slice as without the split, on
                            every mesh (so the capacity and the drops
                            are the unsplit step's), and one turns the
                            output back.
  experts  [E, d, f] (the layer holds every expert: this rank's E_loc
           are cut from it) or [E_loc, d, f] (the layer holds its own:
           ``MoEConfig.held``, or the sharded step's block, which stays
           where it is stored over the EP axes).
  router   [d, E]           the same on every rank.

Dispatch is capacity-based (static shapes; overflow drops): per-source
capacity C = int(T_slice * k / E * factor), at least 1.

The dispatch is differentiable.  The alltoall's gradient is the
alltoall of the gradient (it is its own transpose); the model axis's
token slice and the allgather that rebuilds the full token set are each
other's transposes; the router and the full expert stacks, used by a
rank for its own tokens or experts only, get their gradients summed
over the ranks that share them, so that a data-parallel sum over the
data axes on top gives every rank the gradient of the one-device step.
An expert block held over the EP axes already has the gradient of every
token the alltoall brought to it; the sharded step sums it over the
data axes the EP axes do not name.  Under the split the router's and
the shared experts' gradients are partial sums over the rank's rows,
which the sharded step sums over ``model``.
The collectives go through ``train.comm``.
"""
from __future__ import annotations

import dataclasses
import types

import torch

from repro_torch.core import api as mpix
from repro_torch.models import mlp, moe
from repro_torch.models.config import MoEConfig
from repro_torch.train import comm


@dataclasses.dataclass(frozen=True)
class EPOptions:
    alltoall: str = "xla"           # mpix algorithm for dispatch/return
    allgather: str = "xla"          # rebuild of the token slice
    capacity_factor: float = 1.25
    policy: str | None = None       # selection policy for "auto" algos
                                    # (None = the process default;
                                    # "tuned" reads the tuner's table)
    overlap_chunks: int | None = None
    # pipelined dispatch (partitioned communication): the dispatch
    # alltoall runs in capacity chunks, each chunk's expert MLP following
    # its own transfer.  None = off (monolithic), 0 = auto (the tuner
    # prices the pipeline against the expert FLOPs per chunk), >= 2 = a
    # chunk count (clamped to the largest divisor of the capacity C).
    # Bit-exact either way.
    transport: str = "dist"
    # substrate of the schedule-backed collectives: "dist" (one exchange
    # per compiled round), "kernel" (the whole schedule as one launch of
    # the transport kernel) or "auto" (the tuner's per-size choice).
    # Ignored by "xla" algorithms.
    resilience: object = None
    # the API's recovery ladder on the dispatch collectives (None/False
    # off; True/"canary"/"full"/dict/ResilienceOptions arm it).


def ep_axes_for(cfg_moe: MoEConfig, mesh) -> tuple[str, ...]:
    names = mesh.axis_names
    if "pod" in names:
        n = mesh.shape["pod"] * mesh.shape["model"]
        if cfg_moe.n_experts % n == 0:
            return ("pod", "model")
    return ("model",)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, kw):
        ctx.group, ctx.kw = group, kw
        return comm.mpix("alltoall", x.contiguous(), group, **kw)

    @staticmethod
    def backward(ctx, g):
        return comm.mpix("alltoall", g.contiguous(), ctx.group,
                         **ctx.kw), None, None


class _AllGather(torch.autograd.Function):
    """Allgather of the token slices; the result is used alike by every
    rank of the group, so a slice's gradient is its own rows'."""

    @staticmethod
    def forward(ctx, x, group, kw):
        ctx.rank, ctx.rows = comm.rank(group), x.shape[0]
        return comm.mpix("allgather", x.contiguous(), group, **kw)

    @staticmethod
    def backward(ctx, g):
        r0 = ctx.rank * ctx.rows
        return g[r0: r0 + ctx.rows], None, None


class _SliceRows(torch.autograd.Function):
    """Rows [r0, r0 + rows) of a tensor every rank of ``group`` holds
    alike; the full gradient gathers every rank's slice gradient."""

    @staticmethod
    def forward(ctx, x, r0, rows, group):
        ctx.group = group
        return x[r0: r0 + rows]

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g.contiguous(), ctx.group), None, None, None


class _SumGrad(torch.autograd.Function):
    """The identity; the gradient is summed over ``group`` (divided by
    ``div``) — for a tensor every rank holds alike but uses for its own
    share of the work."""

    @staticmethod
    def forward(ctx, x, group, div):
        ctx.group, ctx.div = group, div
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = comm.all_reduce(g.contiguous(), ctx.group)
        if ctx.div != 1:
            g = g / ctx.div
        return g, None, None


def _uses_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def make_moe_dispatch(mesh, opts: EPOptions, act: str = "silu"):
    """Returns a callable (p, cfg, x) -> y pluggable into
    ``model.forward(moe_dispatch=...)``: the routed experts through the
    expert-parallel exchange, plus the shared experts on the full x.
    ``mesh`` is a ``launch.mesh.Mesh`` with a ``"model"`` axis; every
    rank of it must call the dispatch for every MoE layer."""

    def dispatch(p, cfg: MoEConfig, x, split=None):
        B, S, d = x.shape
        kw = dict(mesh=mesh, opts=opts, act=act)
        rp = {k: getattr(p, k) for k in ("router", "router_bias")
              if hasattr(p, k)}
        mgroup, Mn = mesh.group("model"), mesh.shape["model"]
        if split is not None:
            # the rank's sequence block -> the unsplit step's token slice
            # and back; the router's gradient is summed over model by
            # the sharded step
            xs = comm.seq_to_tokens(x, split.group)
            out = comm.tokens_to_seq(_dispatch(p, cfg, xs, rp, **kw),
                                     split.group, B)
        elif Mn == 1:
            out = _dispatch(p, cfg, x.reshape(B * S, d), rp,
                            **kw).reshape(B, S, d)
        else:
            if B * S % Mn:
                raise ValueError(f"{B * S} tokens do not split over the "
                                 f"model axis of {Mn}")
            T, m = B * S // Mn, mesh.coords["model"]
            xt = x.reshape(B * S, d)
            if _uses_grad(x, *rp.values()):
                xs = _SliceRows.apply(xt, m * T, T, mgroup)
                rp = {k: _SumGrad.apply(v, mgroup, 1) for k, v in rp.items()}
            else:
                xs = xt[m * T: (m + 1) * T]
            # rebuild the full token set across the model axis
            gkw = dict(algorithm=opts.allgather, policy=opts.policy,
                       transport=opts.transport, resilience=opts.resilience,
                       topo=mesh.topology("model"))
            out = _AllGather.apply(_dispatch(p, cfg, xs, rp, **kw), mgroup,
                                   gkw).reshape(B, S, d)
        if cfg.n_shared:
            out = out + mlp.forward(p.shared, x, act)
        return out

    return dispatch


def _overlap_chunks(opts: EPOptions, *, cfg: MoEConfig, topo, E_loc: int,
                    N_ep: int, C: int, d: int, f: int,
                    itemsize: int) -> int:
    """``EPOptions.overlap_chunks`` as an effective chunk count (a divisor
    of the capacity C; < 2 means the monolithic path)."""
    ov = opts.overlap_chunks
    if ov is None:
        return 1
    if ov < 0:
        raise ValueError(
            f"EPOptions.overlap_chunks must be None (off), 0 (auto) or "
            f">= 1, got {ov}")
    if ov == 0:
        from repro_torch.core import tuner
        from repro_torch.core.topology import PEAK_FLOPS_BF16
        # 3 products x 2*rows*d*f flops over the full dispatch
        compute_s = 6.0 * E_loc * (N_ep * C) * d * f / PEAK_FLOPS_BF16
        ov = tuner.select_overlap_chunks(
            topo, cfg.n_experts * C * d * itemsize, compute_s,
            policy=opts.policy or mpix.get_default_policy())
    ov = min(ov, C)
    while ov > 1 and C % ov:
        ov -= 1
    return ov


def _experts(h, w_gate, w_up, w_down, act):
    """h [E_loc, rows, d] through each local expert's gated MLP."""
    a = mlp.ACT[act](torch.matmul(h, w_gate)) * torch.matmul(h, w_up)
    return torch.matmul(a, w_down)


def _local_experts(p, cfg: MoEConfig, mesh, ep, E_loc: int, grad: bool):
    """This rank's expert stacks [E_loc, ...]: the layer's own when it
    holds only them (``MoEConfig.held``, or the sharded step's block),
    else cut from the layer's full stacks (a replicated step)."""
    ws = (p.w_gate, p.w_up, p.w_down)
    held = ws[0].shape[0]
    if held == E_loc and held != cfg.n_experts:
        return ws
    if held != cfg.n_experts:
        raise ValueError(f"the layer holds {held} experts; expert "
                         f"parallelism over {mesh.axis_size(ep)} ranks "
                         f"needs all {cfg.n_experts} or {E_loc}")
    e0 = mesh.axis_index(ep) * E_loc
    if grad:
        # the full stacks are the same on the EP group's ranks, and the
        # pod axis (when it is an EP axis) is summed again by the
        # data-parallel sync
        div = mesh.shape["pod"] if "pod" in ep else 1
        ws = tuple(_SumGrad.apply(w, mesh.group(ep), div) for w in ws)
    return tuple(w[e0: e0 + E_loc] for w in ws)


def _dispatch(p, cfg: MoEConfig, xs, rp: dict, *, mesh, opts: EPOptions,
              act):
    """The routed experts on this rank's token slice xs [T, d], routed
    by ``rp`` (the router's tensors)."""
    T, d = xs.shape
    ep = ep_axes_for(cfg, mesh)
    ep_group, ep_topo = mesh.group(ep), mesh.topology(ep)
    N_ep = mesh.axis_size(ep)
    E, K = cfg.n_experts, cfg.top_k
    if E % N_ep:
        raise ValueError(f"{E} experts do not shard over {N_ep} ranks")
    E_loc = E // N_ep
    grad = _uses_grad(xs, *rp.values())
    kw = dict(algorithm=opts.alltoall, policy=opts.policy,
              transport=opts.transport, resilience=opts.resilience,
              topo=ep_topo)

    w, idx, _ = moe.route(types.SimpleNamespace(**rp), cfg, xs)   # [T, k]
    C = max(1, int(T * K / E * opts.capacity_factor))

    # bucket (token, slot) pairs into per-expert capacity slots
    flat_e = idx.reshape(-1)                                  # [T*K]
    onehot = torch.nn.functional.one_hot(flat_e, E)
    pos = torch.gather(torch.cumsum(onehot, 0) - 1, 1,
                       flat_e[:, None])[:, 0]
    keep = pos < C
    dest = torch.where(keep, flat_e * C + pos, E * C)
    buckets = xs.new_zeros((E * C + 1, d))
    buckets = buckets.index_put((dest,), torch.repeat_interleave(xs, K, 0))
    send = buckets[: E * C]                                   # [E*C, d]

    w_gate, w_up, w_down = _local_experts(p, cfg, mesh, ep, E_loc, grad)
    k_ov = _overlap_chunks(opts, cfg=cfg, topo=ep_topo, E_loc=E_loc,
                           N_ep=N_ep, C=C, d=d, f=w_gate.shape[2],
                           itemsize=xs.element_size())
    if k_ov >= 2:
        # capacity-major within each destination block: a row chunk is
        # capacity slice i of every local expert; each chunk's alltoall
        # feeds its expert products (per-row MLPs: exact, not close)
        Cc = C // k_ov
        x_cm = (send.reshape(N_ep, E_loc, C, d).transpose(1, 2)
                .reshape(N_ep, C, E_loc, d))
        parts = []
        for i in range(k_ov):
            chunk = x_cm[:, i * Cc:(i + 1) * Cc].reshape(-1, d)
            y_c = _AllToAll.apply(chunk, ep_group, kw)
            tok_c = (y_c.reshape(N_ep, Cc, E_loc, d).permute(2, 0, 1, 3)
                     .reshape(E_loc, N_ep * Cc, d))
            ye_c = _experts(tok_c, w_gate, w_up, w_down, act)
            parts.append(ye_c.reshape(E_loc, N_ep, Cc, d))
        ye4 = torch.cat(parts, dim=2)                    # [E_loc, N, C, d]
    else:
        recv = _AllToAll.apply(send, ep_group, kw)
        tok = (recv.reshape(N_ep, E_loc, C, d).transpose(0, 1)
               .reshape(E_loc, N_ep * C, d))
        ye4 = _experts(tok, w_gate, w_up, w_down, act).reshape(
            E_loc, N_ep, C, d)

    back = ye4.transpose(0, 1).reshape(N_ep * E_loc * C, d)
    ret = _AllToAll.apply(back.to(xs.dtype), ep_group, kw)
    gathered = torch.cat([ret, ret.new_zeros((1, d))])[dest]
    return torch.einsum("tkd,tk->td", gathered.reshape(T, K, d), w)
