"""Meshes of ranks over ``torch.distributed``: named axes, their process
groups, and the collective topology of any subset of axes.

A ``Mesh`` wraps a ``DeviceMesh`` (``init_device_mesh``) with the
reference's axis names (``("data", "model")``, ``("pod", "data",
"model")``); every rank of the default group is one mesh position, in
row-major order.  ``group(axes)`` is the process group of the ranks
that share this rank's coordinates on every other axis: the
``DeviceMesh``'s own group for one axis, the default group for all of
them, and for several axes (``("pod", "data")``) groups built once
with ``dist.new_group``, which every rank of the mesh must reach in
the same order (the train step asks for its groups when it is built).
Group ranks run row-major over the named axes, so a group rank is the
rank of a collective schedule on ``topology(axes)``.

A ``MeshLayout`` is the same shape without ranks (a stand-in for the
production meshes): the sharding rules and the dry-run read it, and its
groups record the collectives issued on them (``train.comm``).

Importing this module touches no process group; the functions do.
"""
from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist

from repro_torch.core.topology import (DCN_LINK, ICI_LINK, TopoLevel,
                                       Topology)


class MeshLayout:
    """The shape of a mesh without its process groups: ``shape`` ranks
    over ``axis_names``, this rank at ``coords`` (the origin by default).
    The sharding rules, the sharded steps' block arithmetic and the
    dry-run read only this, so a layout stands in for the 256- and
    512-rank production meshes; ``group(axes)`` gives a
    ``train.comm.AxesGroup``, a group with no process behind it whose
    collectives are recorded (``train.comm``)."""

    def __init__(self, shape, axis_names, *, coords=None, log=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.coords = dict(coords) if coords is not None else {
            a: 0 for a in self.axis_names}
        self.rank = 0
        for a in self.axis_names:
            self.rank = self.rank * self.shape[a] + self.coords[a]
        self.log = log if log is not None else []
        self._groups: dict = {}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} must keep the mesh's order "
                             f"{self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        from repro_torch.train.comm import AxesGroup
        axes = self._axes(axes)
        # the record names a group by its axes of more than one rank
        return AxesGroup(tuple(a for a in axes if self.shape[a] > 1),
                         self.axis_size(axes), self.axis_index(axes),
                         self.log)

    def topology(self, axes) -> Topology:
        """The topology of ``axes``' flat rank space (row-major): when
        the first of several axes is ``"pod"`` it is the inter-pod
        (DCN) level and the rest are intra-pod; otherwise one pod.  One
        intra-pod axis gives the two-parameter form, several keep one
        ICI level each."""
        axes = self._axes(axes)
        sizes = [self.shape[a] for a in axes]
        n = math.prod(sizes)
        has_pod = axes[0] == "pod" and len(axes) > 1
        intra = list(zip(axes, sizes))[1:] if has_pod else list(
            zip(axes, sizes))
        if len(intra) <= 1:
            return Topology(nranks=n, ranks_per_pod=n // sizes[0]
                            if has_pod else n)
        levels = []
        if has_pod:
            levels.append(TopoLevel("dcn", sizes[0], DCN_LINK, dcn=True))
        levels += [TopoLevel(nm, sz, ICI_LINK) for nm, sz in intra]
        return Topology.from_levels(levels)


class Mesh(MeshLayout):
    """``shape`` ranks over ``axis_names``, on ``device_type`` ("cuda":
    one card a rank, NCCL; "cpu": gloo)."""

    def __init__(self, shape, axis_names, *, device_type: str = "cpu"):
        from torch.distributed.device_mesh import init_device_mesh
        names = tuple(axis_names)
        n = math.prod(int(s) for s in shape)
        world = dist.get_world_size()
        if world != n:
            raise ValueError(f"a mesh of {dict(zip(names, shape))} needs "
                             f"{n} ranks, the process group has {world}")
        self.device_type = device_type
        self.device_mesh = init_device_mesh(
            device_type, tuple(int(s) for s in shape),
            mesh_dim_names=names)
        coord = self.device_mesh.get_coordinate()
        super().__init__(shape, names,
                         coords=dict(zip(names, (int(c) for c in coord))))
        assert self.rank == dist.get_rank()

    def group(self, axes):
        """The process group over ``axes`` that holds this rank."""
        axes = self._axes(axes)
        if axes in self._groups:
            return self._groups[axes]
        if len(axes) == 1:
            g = self.device_mesh.get_group(axes[0])
        elif axes == self.axis_names:
            g = dist.group.WORLD
        else:
            g = self._new_groups(axes)
        from repro_torch.train.comm import name_group
        name_group(g, tuple(a for a in axes if self.shape[a] > 1))
        self._groups[axes] = g
        return g

    def _new_groups(self, axes):
        rest = [a for a in self.axis_names if a not in axes]
        strides, s = {}, 1
        for a in reversed(self.axis_names):
            strides[a] = s
            s *= self.shape[a]
        mine = None
        for other in _product([self.shape[a] for a in rest]):
            base = sum(c * strides[a] for a, c in zip(rest, other))
            ranks = [base + sum(c * strides[a] for a, c in zip(axes, cs))
                     for cs in _product([self.shape[a] for a in axes])]
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine


def _product(sizes):
    """Row-major coordinates of a box of ``sizes``."""
    out = [()]
    for s in sizes:
        out = [c + (i,) for c in out for i in range(s)]
    return out


def free_port() -> int:
    """A free TCP port on localhost (a process group's rendezvous)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def under_torchrun() -> bool:
    """True in ``torchrun``'s environment (RANK and WORLD_SIZE set)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def ensure_process_group(device: torch.device) -> bool:
    """Join ``torchrun``'s group (its environment: RANK, WORLD_SIZE,
    MASTER_ADDR/PORT) or, without one, a group of this process alone on
    a free localhost port; NCCL for a card, gloo for the CPU.  Returns
    True when this call created the group (the caller ends it)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if under_torchrun():
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{free_port()}",
            rank=0, world_size=1)
    return True


def local_device(name: str) -> torch.device:
    """The device ``name`` for this rank: a bare ``cuda`` is the card of
    ``LOCAL_RANK`` (one card a rank under ``torchrun``) and becomes the
    current device.  Without a card a ``cuda`` name stops the program
    with an error; it never falls back to the CPU (``cpu`` runs every
    kernel's plain version)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(
                f"--device {name}: no CUDA device is available; pass "
                f"--device cpu to run the plain versions on the CPU")
        if device.index is None:         # one card a rank
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return device


def make_local_mesh(device: torch.device, model: int = 1) -> Mesh:
    """The group's ranks as ``(n / model, model)`` over ``("data",
    "model")`` (``model`` 1: every rank on the data axis)."""
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"group's {n} ranks")
    return Mesh((n // model, model), ("data", "model"),
                device_type=device.type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device_type=device_type)


def make_host_mesh(shape=(2, 4), axes=("data", "model")) -> Mesh:
    """A small mesh of gloo ranks on the CPU (tests, examples)."""
    return Mesh(shape, axes, device_type="cpu")
