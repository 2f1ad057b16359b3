"""Carry state from the reference package into the port as plain arrays.

A schedule crosses as a dict of numpy arrays and ints (see
``schedule_to_numpy``), so a schedule built elsewhere — by the reference
package's tuner or serve engine, say — runs here unchanged and keeps
its fingerprint.  Tensors cross as numpy arrays; a bfloat16 array (an
extension dtype numpy itself lacks) is read through its raw 16-bit
pattern, so no bfloat16 package is needed here.  Model weights cross
the same way: ``params_from_jax`` maps the reference's ``init_params``
tree onto the port's per-layer parameter names.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.schedule import CommRound, CommSchedule, ComputeEvent

_ROUND_KEYS = ("perm", "gather_idx", "scatter_idx", "reduce", "payload")
_EVENT_KEYS = ("name", "seconds", "after_round", "splittable", "parts")


def _arr(a):
    return None if a is None else np.asarray(a)


def schedule_to_numpy(schedule) -> dict:
    """A schedule's execution state as plain numpy arrays and ints.
    Reads attributes only, so it takes the reference's ``CommSchedule``
    as well as the port's."""
    return {
        "nranks": int(schedule.nranks),
        "num_slots": int(schedule.num_slots),
        "name": str(schedule.name),
        "rounds": [{
            "perm": np.asarray(r.perm, np.int64).reshape(-1, 2),
            "gather_idx": np.asarray(r.gather_idx),
            "scatter_idx": np.asarray(r.scatter_idx),
            "reduce": bool(r.reduce),
            "payload": _arr(r.payload),
        } for r in schedule.rounds],
        "slot_bytes": _arr(schedule.slot_bytes),
        "local_pre": _arr(schedule.local_pre),
        "local_post": _arr(schedule.local_post),
        "out_slots": schedule.out_slots,
        "out_offsets": _arr(schedule.out_offsets),
        "compute_events": [{k: getattr(ev, k) for k in _EVENT_KEYS}
                           for ev in schedule.compute_events],
    }


def schedule_from_numpy(d: dict) -> CommSchedule:
    """The port's ``CommSchedule`` for the arrays of ``schedule_to_numpy``
    (table dtypes kept, so ``fingerprint()`` is unchanged)."""
    rounds = []
    for r in d["rounds"]:
        missing = [k for k in _ROUND_KEYS if k not in r]
        if missing:
            raise ValueError(f"schedule round lacks {missing}")
        perm = np.asarray(r["perm"]).reshape(-1, 2)
        rounds.append(CommRound(
            perm=tuple((int(s), int(t)) for s, t in perm),
            gather_idx=np.asarray(r["gather_idx"]),
            scatter_idx=np.asarray(r["scatter_idx"]),
            reduce=bool(r["reduce"]), payload=_arr(r["payload"])))
    out_slots = d.get("out_slots")
    return CommSchedule(
        nranks=int(d["nranks"]), num_slots=int(d["num_slots"]),
        rounds=tuple(rounds), name=str(d.get("name", "schedule")),
        slot_bytes=_arr(d.get("slot_bytes")),
        local_pre=_arr(d.get("local_pre")),
        local_post=_arr(d.get("local_post")),
        out_slots=None if out_slots is None else int(out_slots),
        out_offsets=_arr(d.get("out_offsets")),
        compute_events=tuple(ComputeEvent(**ev)
                             for ev in d.get("compute_events", ())))


def tensor_from_numpy(a, *, device=None) -> torch.Tensor:
    """A torch tensor with the array's values and dtype; bfloat16 arrays
    are taken bit for bit."""
    a = np.array(a)                      # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t if device is None else t.to(device)


def scale_from_numpy(a, *, device=None) -> torch.Tensor:
    """An rmsnorm scale vector [d] from the reference's array."""
    t = tensor_from_numpy(a, device=device)
    if t.ndim != 1:
        raise ValueError(f"rmsnorm scale must be 1-D, got {tuple(t.shape)}")
    return t


_EXPERT_STACKS = ("w_gate", "w_up", "w_down")   # [E, ...] under "moe"

_TOP = ("embed", "final_norm", "lm_head", "prefix", "periods", "suffix",
        "encoder")


def _walk(tree: dict, path: tuple, prefix: str, index, out: dict) -> None:
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _walk(leaf, path + (name,), f"{prefix}{name}.", index, out)
        else:
            out[f"{prefix}{name}"] = (path + (name,), index)


def _n_periods(periods: dict) -> int:
    first = next(iter(periods.values()))
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return int(first.shape[0])


def _layer_names(tree: dict, out: dict) -> None:
    """The per-layer part of the map: ``prefix[i]``, each period's
    ``b{j}`` and ``suffix[i]`` onto ``layers.{n}``, in stack order."""
    layer = 0
    for i, block in enumerate(tree.get("prefix", [])):
        _walk(block, ("prefix", i), f"layers.{layer}.", None, out)
        layer += 1
    periods = tree.get("periods", {})
    names = sorted(periods, key=lambda b: int(b[1:]))
    if names:
        for p in range(_n_periods(periods)):
            for name in names:
                _walk(periods[name], ("periods", name), f"layers.{layer}.",
                      p, out)
                layer += 1
    for i, block in enumerate(tree.get("suffix", [])):
        _walk(block, ("suffix", i), f"layers.{layer}.", None, out)
        layer += 1


def param_names_from_jax(tree: dict) -> dict:
    """The name map from the reference's ``init_params`` tree (any
    leaves with a ``shape``) to the port's ``Model.state_dict()``:
    ``{port name: (reference path, period index or None)}``, the path a
    tuple of dict keys and list indices.

    ``prefix[i]`` becomes ``layers.{i}``; the stacked ``periods/b{j}``
    arrays are cut along their leading ``n_periods`` axis into layers
    ``len(prefix) + p * len(period) + j`` (period index ``p``);
    ``suffix`` follows; ``encoder/layers[i]`` becomes
    ``encoder.layers.{i}``.  Inside a block the names carry over as they
    are (``mla.*``, ``moe.router_bias``, ``moe.shared.*``, ``norm_cross``,
    ``cross.*``, ...)."""
    unknown = sorted(set(tree) - set(_TOP))
    if unknown:
        raise ValueError(f"params_from_jax: no port for {unknown}")
    out: dict = {}
    for name in ("embed", "final_norm", "lm_head"):
        if name in tree:
            out[name] = ((name,), None)
    _layer_names(tree, out)
    if "encoder" in tree:
        for i, block in enumerate(tree["encoder"]["layers"]):
            _walk(block, ("encoder", "layers", i), f"encoder.layers.{i}.",
                  None, out)
        out["encoder.final_norm"] = (("encoder", "final_norm"), None)
    return out


def cache_names_from_jax(tree: dict) -> dict:
    """The same map for the reference's ``init_cache`` tree onto the
    port's cache (``{"layers": [...]}``, dotted as
    ``layers.{n}.attn.k``); the host ``len`` counters included."""
    out: dict = {}
    _layer_names(tree, out)
    return out


def at_path(tree, path: tuple):
    """The leaf of ``tree`` at a map path."""
    for k in path:
        tree = tree[k]
    return tree


def params_from_jax(tree: dict, *, held: tuple[int, int] | None = None
                    ) -> dict:
    """The port's model state (names as in ``Model.state_dict()``) for
    the reference's ``init_params`` tree with numpy leaves, through
    ``param_names_from_jax``.  Values and dtypes are kept (bfloat16 bit
    for bit).  With ``held = (lo, hi)`` every MoE layer keeps only
    experts [lo, hi) of its stacked ``w_gate`` / ``w_up`` / ``w_down``
    (the router, its bias and the shared experts stay whole), the state
    of a model whose ``MoEConfig.held`` is that range."""
    state: dict = {}
    for name, (path, index) in param_names_from_jax(tree).items():
        a = np.asarray(at_path(tree, path))
        if index is not None:
            a = a[index]
        if (held is not None and path[-1] in _EXPERT_STACKS
                and len(path) > 1 and path[-2] == "moe"):
            a = a[held[0]:held[1]]
        state[name] = tensor_from_numpy(a)
    return state


def train_state_from_jax(state: dict, *,
                         held: tuple[int, int] | None = None) -> dict:
    """The port's train state (``train.step.init_train_state``'s layout)
    for the reference's ``init_train_state`` tree with numpy leaves:
    ``params``, the AdamW moments ``opt.mu`` / ``opt.nu`` and, with
    error feedback, ``ef_residual``, each through ``params_from_jax``
    (so each is a dict keyed by the port's parameter names); the
    counters ``opt.count`` and ``step`` as int32 scalars."""
    out = {"params": params_from_jax(state["params"], held=held),
           "opt": {"mu": params_from_jax(state["opt"]["mu"], held=held),
                   "nu": params_from_jax(state["opt"]["nu"], held=held),
                   "count": tensor_from_numpy(
                       np.asarray(state["opt"]["count"], np.int32))},
           "step": tensor_from_numpy(np.asarray(state["step"], np.int32))}
    if state.get("ef_residual") is not None:
        out["ef_residual"] = params_from_jax(state["ef_residual"],
                                             held=held)
    return out
