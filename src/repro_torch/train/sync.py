"""Explicit DP gradient synchronization through the MPIX layer.

The ``fsdp`` train mode reduces gradients with the native collective
(``dist.all_reduce``).  This module is the paper-faithful *explicit*
path: parameters replicated over the data axes, the gradient allreduce
issued through ``mpix_*`` with a publicly selectable algorithm
(``xla`` — the native collective — ``ring_rs_ag``,
``recursive_halving_doubling``, ``hierarchical``, ...) on a selectable
transport (``dist``: one exchange per round; ``kernel``: the whole
schedule as one launch of the transport kernel; ``auto``), plus two
distributed-optimization extensions:

  * bucketing (``buckets > 1``): the flattened gradient is cut into
    independent buckets, one collective each;
  * compression (``dp_allreduce_compressed``): hierarchical sync where
    the intra-pod sum runs in f32 and only the inter-pod hop is
    int8-quantized with error feedback.

Gradients are dicts (parameter name -> tensor).  Each is widened to
f32 and concatenated in the dict's order before the collective, and cut
back to each leaf's dtype after the division, as the reference does.
Every rank of the group calls with its own gradients; ``topo`` is the
group's topology (default: one pod of the group's size).  The
collectives go through ``train.comm``.
"""
from __future__ import annotations

import torch

from repro_torch.optim.compress import compress_int8, decompress_int8
from repro_torch.train import comm


def _flatten(grads: dict):
    flat = torch.cat([g.reshape(-1).float() for g in grads.values()])
    meta = [(k, tuple(g.shape), g.dtype, g.numel())
            for k, g in grads.items()]
    return flat, meta


def _unflatten(flat, meta) -> dict:
    out, off = {}, 0
    for k, shape, dtype, size in meta:
        out[k] = flat[off: off + size].reshape(shape).to(dtype)
        off += size
    return out


def _pad(flat, total: int):
    if total > flat.numel():
        flat = torch.cat([flat, flat.new_zeros(total - flat.numel())])
    return flat


def dp_allreduce(grads: dict, group, *, algorithm="xla", buckets=1,
                 denom=None, transport="dist", resilience=None,
                 topo=None) -> dict:
    """Sum-allreduce ``grads`` over ``group``, divided by ``denom`` (a
    scalar, e.g. the group's summed live-token count, so that per-rank
    sum-losses combine into the exact global mean; default the group
    size).  ``transport`` picks the substrate of schedule-backed
    algorithms (ignored by "xla"); ``resilience`` arms the API's
    recovery ladder on each bucket's collective."""
    if denom is None:
        denom = comm.size(group)
    flat, meta = _flatten(grads)
    total = flat.numel()
    nb = max(1, buckets)
    per = -(-total // nb)
    parts = _pad(flat, per * nb).reshape(nb, per)
    done = [comm.mpix("allreduce", parts[i], group, algorithm=algorithm,
                      transport=transport, resilience=resilience,
                      topo=topo)
            for i in range(nb)]
    return _unflatten(torch.cat(done)[:total] / denom, meta)


# dp_algorithm (allreduce registry) -> its (reduce_scatter, allgather)
# halves, so the overlap path accepts the same names as dp_allreduce
_RS_AG = {
    "ring_rs_ag": ("ring", "ring"),
    "recursive_halving_doubling": ("recursive_halving",
                                   "recursive_doubling"),
}


def dp_allreduce_overlap(grads: dict, group, *, algorithm="xla", chunks=2,
                         denom=None, max_norm=None, transport="dist",
                         resilience=None, topo=None):
    """Pipelined DP sync fused with gradient clipping: reduce-scatter
    chunks, norm and clip on this rank's shards, allgather chunks.

    Returns ``(grads, gnorm)``: the same averaging as ``dp_allreduce``
    and the clip rule of ``optim.clip_by_global_norm`` (scale = min(1,
    max_norm / (gnorm + 1e-9))), the global norm summed from the
    shards' square norms (the shards partition the reduced vector, so
    the sum is exact: one scalar crosses the wire).  ``max_norm=None``
    clips nothing (gnorm still returned)."""
    if chunks < 1:
        raise ValueError(
            f"dp_allreduce_overlap: chunks must be >= 1, got {chunks}")
    n = comm.size(group)
    if denom is None:
        denom = n
    flat, meta = _flatten(grads)
    total = flat.numel()
    # each chunk pads to a multiple of n so the scatter dim divides
    per = -(-(-(-total // chunks)) // n) * n
    parts = _pad(flat, per * chunks).reshape(chunks, per)
    rs_alg, ag_alg = _RS_AG.get(algorithm, (algorithm, algorithm))
    shards = []
    gsq = torch.zeros((), dtype=torch.float32, device=flat.device)
    for i in range(chunks):
        sh = comm.mpix("reduce_scatter", parts[i], group,
                       algorithm=rs_alg, transport=transport,
                       resilience=resilience, topo=topo) / denom
        gsq = gsq + torch.sum(torch.square(sh))
        shards.append(sh)
    gsq = comm.all_reduce(gsq, group)
    gnorm = torch.sqrt(gsq)
    if max_norm is not None:
        scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
        shards = [sh * scale for sh in shards]
    outs = [comm.mpix("allgather", sh, group, algorithm=ag_alg,
                      transport=transport, resilience=resilience,
                      topo=topo)
            for sh in shards]
    return _unflatten(torch.cat(outs)[:total], meta), gnorm


def dp_allreduce_compressed(grads: dict, residual: dict | None, *,
                            data_group, pod_group, intra_algorithm="xla",
                            denom=None, resilience=None, data_topo=None):
    """Hierarchical DP sync with int8 + error feedback on the inter-pod
    hop.  Steps:
      1. intra-pod sum over ``data_group`` (full precision),
      2. int8-quantize (grad + EF residual), pass it round the pods of
         ``pod_group`` (a ring of Q - 1 shifts), dequantize-accumulate,
      3. new residual = what quantization lost this step,
      4. divide by ``denom`` (the global live-token count; default the
         rank count of both groups).
    Returns (synced grads, new residual)."""
    Q = comm.size(pod_group)
    if denom is None:
        denom = Q * comm.size(data_group)
    flat, meta = _flatten(grads)
    flat = comm.mpix("allreduce", flat, data_group,
                     algorithm=intra_algorithm, resilience=resilience,
                     topo=data_topo)
    res_flat = (torch.zeros_like(flat) if residual is None
                else _flatten(residual)[0])
    x = flat + res_flat
    q, s = compress_int8(x)
    sent = decompress_int8(q, s, x.shape, torch.float32)
    new_res = x - sent
    acc, qc, sc = sent, q, s
    for _ in range(Q - 1):
        qc = comm.ring_shift(qc, pod_group)
        sc = comm.ring_shift(sc, pod_group)
        acc = acc + decompress_int8(qc, sc, x.shape, torch.float32)
    return _unflatten(acc / denom, meta), _unflatten(new_res, meta)
