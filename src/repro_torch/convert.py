"""Carry state from the reference package into the port as plain arrays.

A schedule crosses as a dict of numpy arrays and ints (see
``schedule_to_numpy``), so a schedule built elsewhere — by the reference
package's tuner or serve engine, say — runs here unchanged and keeps
its fingerprint.  Tensors cross as numpy arrays; a bfloat16 array (an
extension dtype numpy itself lacks) is read through its raw 16-bit
pattern, so no bfloat16 package is needed here.
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
