"""Sharding rules: FSDP + TP (+ EP) over the production meshes.

Axis convention (``launch.mesh``):
    single pod : ("data", "model")              = (16, 16)
    multi-pod  : ("pod", "data", "model")       = (2, 16, 16)

Rules (MaxText-style, by parameter role):
  * embedding [V, d]        -> (model, fsdp)       vocab-sharded
  * attn/mlp weights [.., a, b] -> contracting dim over fsdp, output dim
    over model, stacked period dim replicated
  * MoE experts [.., E, a, b]  -> E over model (expert parallelism),
    a over data
  * norms / biases / small vectors -> replicated
  * optimizer moments inherit their parameter's spec

``fsdp`` = ("pod", "data") on the multi-pod mesh, ("data",) on one pod.
Dims that don't divide fall back to replication (whisper's odd 51865
vocab).

The functions are pure: they read names, shapes, the config and a
*mesh-like* object (anything with a ``shape`` mapping of axis name to
size and ``axis_names``: a ``launch.mesh.Mesh``, or a stand-in for the
256- and 512-rank production meshes), and need no process group.

A spec is a tuple with one entry per dim: ``None`` (replicated), an axis
name, or a tuple of axis names (the dim cut over their row-major
product).  Parameters are keyed by ``Model.state_dict()`` names; caches
keep the port's ``{"layers": [...]}`` layout.

The port holds one tensor per layer where the reference stacks the
homogeneous middle of the stack on a leading ``n_periods`` axis.  The
rules decide on the *stacked* shape (its size cut, its rank), so a
periodic layer's spec is the rule applied to ``(n_periods,) + shape``
with the leading (never cut) entry dropped: rwkv6-3b's ``cmix.mu``
[2, 2560] is cut over ``model`` as the stacked [32, 2, 2560] is, though
the per-layer tensor alone is under the size cut.  Expert stacks are
recognised by the config's full ``n_experts``.
"""
from __future__ import annotations

import math
import re

_LAYER_RE = re.compile(r"^layers\.(\d+)\.")
_SMALL = 1 << 16


def _leaf_name(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def data_axes(mesh) -> tuple[str, ...]:
    """Axes carrying the global batch (pod + data when present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _axis_size(mesh, axes) -> int:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(mesh.shape[a] for a in axes)


def _divisible(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def entry_axes(entry) -> tuple[str, ...]:
    """The axes of one spec entry, as a tuple (``()`` when replicated)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple[str, ...]:
    """Every axis a spec cuts over, in entry order."""
    return tuple(a for e in spec for a in entry_axes(e))


def periodic(name: str, cfg) -> bool:
    """Whether ``name`` is a parameter of a layer the reference stacks
    on its ``periods`` axis."""
    m = _LAYER_RE.match(name)
    if m is None or not cfg.n_periods:
        return False
    i, n_pre = int(m.group(1)), len(cfg.prefix)
    return n_pre <= i < n_pre + len(cfg.period) * cfg.n_periods


def _rule(name: str, shape: tuple, lead: int, cfg, mesh) -> list:
    """The reference's rule on a (possibly stacked) shape."""
    nd = len(shape)
    spec = [None] * nd
    if nd <= 1 or math.prod(shape) < _SMALL:
        return spec
    fsdp = data_axes(mesh)
    fsdp_n = _axis_size(mesh, fsdp)
    model_n = mesh.shape["model"]
    leaf = _leaf_name(name)
    if leaf in ("embed", "lm_head"):
        vdim, ddim = (0, 1) if leaf == "embed" else (1, 0)
        if _divisible(shape[vdim], model_n):
            spec[vdim] = "model"
        if _divisible(shape[ddim], fsdp_n):
            spec[ddim] = fsdp
        return spec
    if nd - lead < 2:
        return spec
    if cfg.moe is not None and nd - lead == 3 \
            and shape[lead] == cfg.moe.n_experts:
        ep = ("pod", "model") if "pod" in mesh.axis_names else ("model",)
        if not _divisible(shape[lead], _axis_size(mesh, ep)):
            ep = ("model",)
        if _divisible(shape[lead], _axis_size(mesh, ep)):
            spec[lead] = ep if len(ep) > 1 else "model"
        data_only = tuple(a for a in mesh.axis_names if a == "data")
        if _divisible(shape[lead + 1], _axis_size(mesh, data_only)):
            spec[lead + 1] = "data"
        return spec
    a_dim, b_dim = nd - 2, nd - 1
    if _divisible(shape[b_dim], model_n):
        spec[b_dim] = "model"
    if _divisible(shape[a_dim], fsdp_n):
        spec[a_dim] = fsdp
    return spec


def param_spec(name: str, shape, cfg, mesh) -> tuple:
    """The spec of one parameter (``Model.state_dict()`` name, its
    per-layer shape)."""
    shape = tuple(int(s) for s in shape)
    if periodic(name, cfg):
        return tuple(_rule(name, (cfg.n_periods,) + shape, 1, cfg,
                           mesh)[1:])
    return tuple(_rule(name, shape, 0, cfg, mesh))


def param_specs(params: dict, cfg, mesh) -> dict:
    """``{name: spec}`` for a dict of tensors (or anything with a
    ``shape``) keyed by ``Model.state_dict()`` names."""
    return {k: param_spec(k, v.shape, cfg, mesh) for k, v in params.items()}


def batch_specs(mesh) -> tuple:
    """Token batches: rows over (pod, data); the other dims replicated
    (the entry of the leading dim only)."""
    return (data_axes(mesh),)


def _cache_rule(leaf: str, shape: tuple, mesh, long_context: bool) -> tuple:
    nd = len(shape)
    spec = [None] * nd
    if nd == 0:
        return ()
    d_axes = data_axes(mesh)
    all_axes = tuple(mesh.axis_names)
    model_n = mesh.shape["model"]
    if leaf in ("k", "v"):                  # [B, S, K, D]
        if long_context:
            spec[1] = (all_axes if _divisible(shape[1],
                                              _axis_size(mesh, all_axes))
                       else d_axes)
        else:
            spec[0] = d_axes
            if _divisible(shape[1], model_n):
                spec[1] = "model"
    elif leaf in ("ckv", "kr"):             # MLA latents [B, S, ...]
        if long_context:
            spec[1] = d_axes
        else:
            spec[0] = d_axes
            if _divisible(shape[1], model_n):
                spec[1] = "model"
    elif leaf in ("s", "h"):                # [B, H, N, N] / [B, Di, S]
        if _divisible(shape[1], model_n):
            spec[1] = "model"
        if not long_context:
            spec[0] = d_axes
    elif leaf == "conv":                    # [B, K-1, Di]
        if _divisible(shape[2], model_n):
            spec[2] = "model"
        if not long_context:
            spec[0] = d_axes
    elif leaf in ("x_tm", "x_cm"):          # [B, d]
        if not long_context:
            spec[0] = d_axes
    return tuple(spec)


def cache_specs(cache: dict, cfg, mesh, *, long_context: bool) -> dict:
    """The cache tree's specs, in its own layout (``None`` for the host
    ints such as ``len``).  KV caches: batch over the data axes and
    sequence over model; long-context (batch 1) cuts the sequence over
    every axis (the data axes when it does not divide; the MLA latents
    over the data axes).  Recurrent states cut their head / channel dim
    over model."""
    def walk(node, leaf):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, leaf) for v in node]
        if not hasattr(node, "shape"):
            return None
        return _cache_rule(leaf, tuple(node.shape), mesh, long_context)
    return walk(cache, None)


def flat_names(tree, prefix: str = "") -> dict:
    """``{dotted name: leaf}`` of a nested dict / list tree (list items
    by index), e.g. ``layers.3.attn.k`` of a cache."""
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):       # a spec tuple is a leaf
            out.update(flat_names(v, key + "."))
        else:
            out[key] = v
    return out


def shard_shape(shape, spec, mesh) -> tuple:
    """The block of ``shape`` one rank holds under ``spec``."""
    out = []
    for d, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = _axis_size(mesh, entry_axes(e))
        if d % n:
            raise ValueError(f"dim {d} does not divide over {e} ({n})")
        out.append(d // n)
    return tuple(out)


def shard_bytes(shape, dtype_size: int, spec, mesh) -> int:
    """Bytes of one rank's block of a tensor of ``shape``."""
    return math.prod(shard_shape(shape, spec, mesh)) * dtype_size
