"""Topology model for the MPIX layer (PyTorch port).

MPI Advance's locality-aware algorithms distinguish intra-node from
inter-node links.  The model names two link classes:

  * ICI  — intra-pod links (the fast level: NVLink inside one host)
  * DCN  — inter-pod links (the slow level: the network between hosts)

``Topology`` maps a flat rank id (position along one mesh axis, or the
flattened product of several axes) to coordinates along an ordered
multi-level hierarchy of axes (outermost first, row-major — e.g. a DCN
level above two intra-pod torus axes), classifies each (src, dst) pair
by the outermost level where the coordinates differ, and carries the
alpha-beta (postal) link model per level used by the selector, the
tuner, and the path benchmarks.

Back-compat: the historical two-parameter form ``Topology(nranks,
ranks_per_pod)`` still works and canonicalizes to a 1-level (single
pod, all ICI) or 2-level (DCN over ICI) hierarchy; richer geometries
come from ``Topology.from_levels`` / ``torus_topology`` and round-trip
through ``fingerprint()`` / ``Topology.from_fingerprint``.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Sequence

# Default alpha-beta link-model constants.  They are the reference
# package's defaults, kept unchanged only because ``Topology.fingerprint``
# and the compiled executors must agree with it (a level whose link
# model differs from these emits an ``lm[...]`` section).  They are not
# measurements of any NVIDIA link; measured H100 link models come from
# the link probe in a later slice.
PEAK_FLOPS_BF16 = 197e12        # per chip
HBM_BW = 819e9                  # bytes/s per chip
ICI_BW = 50e9                   # bytes/s per link
DCN_BW = 25e9                   # bytes/s per pod-pair (effective)
ICI_LATENCY = 1e-6              # alpha, seconds per message
DCN_LATENCY = 10e-6


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """alpha-beta postal model for one link class."""

    alpha: float  # latency per message (s)
    beta: float   # seconds per byte (1 / bandwidth)

    def __post_init__(self):
        # Probe fits feed straight into here: a NaN/inf/negative
        # coefficient would silently poison every modeled time and the
        # tuned-table fingerprints derived from it, so reject at the
        # source instead.
        for field in ("alpha", "beta"):
            v = getattr(self, field)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise ValueError(f"LinkModel.{field} must be a real "
                                 f"number, got {v!r}")
            if not math.isfinite(v) or v < 0:
                raise ValueError(f"LinkModel.{field} must be finite and "
                                 f">= 0, got {v!r}")
            object.__setattr__(self, field, float(v))

    def time(self, nbytes: float, nmsgs: int = 1) -> float:
        return nmsgs * self.alpha + nbytes * self.beta


ICI_LINK = LinkModel(alpha=ICI_LATENCY, beta=1.0 / ICI_BW)
DCN_LINK = LinkModel(alpha=DCN_LATENCY, beta=1.0 / DCN_BW)


@dataclasses.dataclass(frozen=True)
class TopoLevel:
    """One axis of the rank hierarchy (outermost-first, row-major).

    ``dcn=True`` marks an inter-pod level: ranks that differ in any DCN
    coordinate are in different pods.  DCN levels must form an outermost
    prefix of the hierarchy (pods contain torus axes, never vice versa).
    """

    name: str
    size: int
    link: LinkModel = ICI_LINK
    dcn: bool = False

    def __post_init__(self):
        if self.size <= 0:
            raise ValueError(f"level {self.name!r} size must be positive")
        # no "-" (the fingerprint name/size separator), ".", ":" or "]"
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", self.name):
            raise ValueError(f"invalid level name {self.name!r}")


def _inferred_level(name: str, size: int) -> TopoLevel:
    """The level a bare ``name-size`` axis spec decodes to: the ``dcn``
    name prefix selects the DCN class, everything else ICI."""
    dcn = name.startswith("dcn")
    return TopoLevel(name, size, DCN_LINK if dcn else ICI_LINK, dcn)


def _default_levels(nranks: int, ranks_per_pod: int) -> tuple[TopoLevel, ...]:
    """Canonical hierarchy for the historical (nranks, ranks_per_pod)."""
    if ranks_per_pod == nranks:
        return (TopoLevel("ici", nranks, ICI_LINK),)
    return (TopoLevel("dcn", nranks // ranks_per_pod, DCN_LINK, dcn=True),
            TopoLevel("ici", ranks_per_pod, ICI_LINK))


@dataclasses.dataclass(frozen=True)
class Topology:
    """Locality structure of ``nranks`` ranks over an ordered hierarchy.

    ``Topology(nranks, ranks_per_pod)`` — historical 2-parameter form;
    ``ranks_per_pod == nranks`` -> single-pod (all links ICI).
    ``Topology.from_levels(...)``   — explicit multi-level geometry.
    """

    nranks: int
    ranks_per_pod: int
    levels: tuple[TopoLevel, ...] = ()

    def __post_init__(self):
        if self.nranks <= 0:
            raise ValueError("nranks must be positive")
        if self.ranks_per_pod <= 0 or self.nranks % self.ranks_per_pod:
            raise ValueError(
                f"nranks={self.nranks} not divisible by "
                f"ranks_per_pod={self.ranks_per_pod}")
        if not self.levels:
            object.__setattr__(
                self, "levels",
                _default_levels(self.nranks, self.ranks_per_pod))
        levels = tuple(self.levels)
        object.__setattr__(self, "levels", levels)
        if math.prod(lv.size for lv in levels) != self.nranks:
            raise ValueError(
                f"level sizes {[lv.size for lv in levels]} do not "
                f"multiply to nranks={self.nranks}")
        seen_local = False
        intra = 1
        for lv in levels:
            if lv.dcn and seen_local:
                raise ValueError(
                    "DCN levels must form an outermost prefix of the "
                    f"hierarchy, got {[(l.name, l.dcn) for l in levels]}")
            seen_local = seen_local or not lv.dcn
            if not lv.dcn:
                intra *= lv.size
        if intra != self.ranks_per_pod:
            raise ValueError(
                f"intra-pod level sizes multiply to {intra}, but "
                f"ranks_per_pod={self.ranks_per_pod}")

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_levels(cls, levels: Sequence[TopoLevel | tuple]) -> "Topology":
        """Build from an outermost-first axis list.

        Entries are ``TopoLevel``s or ``(name, size)`` tuples; tuple
        entries named ``"dcn"`` (or prefixed ``"dcn"``) become DCN
        levels with the DCN link model, everything else ICI.
        """
        lvls = []
        for lv in levels:
            if not isinstance(lv, TopoLevel):
                name, size = lv
                dcn = str(name).startswith("dcn")
                lvls.append(TopoLevel(str(name), int(size),
                                      DCN_LINK if dcn else ICI_LINK, dcn))
            else:
                lvls.append(lv)
        n = math.prod(lv.size for lv in lvls)
        rpp = math.prod(lv.size for lv in lvls if not lv.dcn)
        return cls(nranks=n, ranks_per_pod=rpp, levels=tuple(lvls))

    # -- coordinates ------------------------------------------------------
    @property
    def npods(self) -> int:
        return self.nranks // self.ranks_per_pod

    def pod(self, rank: int) -> int:
        return rank // self.ranks_per_pod

    def local(self, rank: int) -> int:
        return rank % self.ranks_per_pod

    def rank(self, pod: int, local: int) -> int:
        return pod * self.ranks_per_pod + local

    def pod_ranks(self, pod: int) -> range:
        base = pod * self.ranks_per_pod
        return range(base, base + self.ranks_per_pod)

    def coords(self, rank: int) -> tuple[int, ...]:
        """Mixed-radix decode of ``rank`` along levels (outermost first)."""
        out = []
        for lv in reversed(self.levels):
            out.append(rank % lv.size)
            rank //= lv.size
        return tuple(reversed(out))

    def rank_of(self, coords: Sequence[int]) -> int:
        r = 0
        for lv, c in zip(self.levels, coords):
            r = r * lv.size + c
        return r

    # -- identity ----------------------------------------------------------
    def fingerprint(self, device_kind: str = "model") -> str:
        """Substrate identity key for persisted tuning tables.

        ``device_kind`` names the physical substrate the timings were
        taken on (e.g. ``"cpu"``, ``"NVIDIA_H100_80GB_HBM3"``); the
        reserved kind ``"model"`` marks alpha-beta-model-derived tables.
        Canonical
        1/2-level topologies keep the historical ``kind:nN:rppR`` form;
        richer hierarchies append the per-axis geometry, e.g.
        ``model:n32:rpp16:lv[dcn-2.torus_y-4.torus_x-4]``.

        Levels whose link model or DCN flag cannot be re-inferred from
        the axis name (a custom alpha-beta model, or a dcn flag that
        disagrees with the ``dcn`` name prefix) additionally emit a
        ``lm[i=alpha/beta/dcn;...]`` section so the fingerprint stays a
        loss-free geometry encoding (``from_fingerprint`` round-trips).
        """
        kind = str(device_kind).strip().replace(" ", "_").replace(":", "_")
        base = f"{kind}:n{self.nranks}:rpp{self.ranks_per_pod}"
        if self.levels == _default_levels(self.nranks, self.ranks_per_pod):
            return base
        axes = ".".join(f"{lv.name}-{lv.size}" for lv in self.levels)
        out = f"{base}:lv[{axes}]"
        custom = []
        for i, lv in enumerate(self.levels):
            if lv != _inferred_level(lv.name, lv.size):
                custom.append(f"{i}={lv.link.alpha!r}/{lv.link.beta!r}/"
                              f"{int(lv.dcn)}")
        if custom:
            out += f":lm[{';'.join(custom)}]"
        return out

    @classmethod
    def from_fingerprint(cls, fingerprint: str) -> "Topology":
        """Recover the geometry a ``fingerprint()`` string encodes.

        Link models and DCN flags are restored from the level class
        (``dcn`` name prefix vs ICI) unless the fingerprint carries an
        explicit ``lm[...]`` override section (non-default link models).
        """
        m = re.fullmatch(
            r"[^:]+:n(\d+):rpp(\d+)"
            r"(?::lv\[([^\]]+)\])?(?::lm\[([^\]]+)\])?", fingerprint)
        if not m:
            raise ValueError(f"unparseable topology fingerprint "
                             f"{fingerprint!r}")
        n, rpp, axes, lm = (int(m.group(1)), int(m.group(2)),
                            m.group(3), m.group(4))
        if axes is None:
            if lm is not None:
                raise ValueError(f"lm section without lv section in "
                                 f"{fingerprint!r}")
            return cls(nranks=n, ranks_per_pod=rpp)
        overrides = {}
        for part in (lm.split(";") if lm else ()):
            om = re.fullmatch(r"(\d+)=([^/]+)/([^/]+)/([01])", part)
            if not om:
                raise ValueError(f"bad link spec {part!r} in "
                                 f"{fingerprint!r}")
            overrides[int(om.group(1))] = (
                LinkModel(alpha=float(om.group(2)),
                          beta=float(om.group(3))),
                bool(int(om.group(4))))
        levels = []
        for i, part in enumerate(axes.split(".")):
            am = re.fullmatch(r"([A-Za-z_][A-Za-z0-9_]*)-(\d+)", part)
            if not am:
                raise ValueError(f"bad axis spec {part!r} in {fingerprint!r}")
            name, size = am.group(1), int(am.group(2))
            if i in overrides:
                link, dcn = overrides.pop(i)
                levels.append(TopoLevel(name, size, link, dcn))
            else:
                levels.append(_inferred_level(name, size))
        if overrides:
            raise ValueError(
                f"lm indices {sorted(overrides)} out of range for "
                f"{len(levels)} levels in {fingerprint!r}")
        return cls(nranks=n, ranks_per_pod=rpp, levels=tuple(levels))

    # -- link classification ----------------------------------------------
    def link_level(self, src: int, dst: int) -> int:
        """Index of the outermost level where src and dst differ
        (innermost level if equal — an on-chip/self link)."""
        cs, cd = self.coords(src), self.coords(dst)
        for i, (a, b) in enumerate(zip(cs, cd)):
            if a != b:
                return i
        return len(self.levels) - 1

    def is_local(self, src: int, dst: int) -> bool:
        """True when (src, dst) stay inside one pod (no DCN crossing)."""
        return self.pod(src) == self.pod(dst)

    def link(self, src: int, dst: int) -> LinkModel:
        return self.levels[self.link_level(src, dst)].link

    # -- cost model ---------------------------------------------------------
    def round_time(self, edges: Sequence[tuple[int, int]],
                   nbytes) -> float:
        """Model one schedule round: all edges fire concurrently; the round
        costs the max over links, with per-link serialization of multiple
        messages sharing the same (src, level) injection port.

        ``nbytes`` is a scalar (same payload on every edge) or a
        per-edge sequence aligned with ``edges``.  Self-edges are
        on-chip copies and cost nothing.
        """
        edges = list(edges)
        if not edges:
            return 0.0
        per_edge = ([float(b) for b in nbytes]
                    if hasattr(nbytes, "__len__")
                    else [float(nbytes)] * len(edges))
        # messages per (src, level) serialize on the src's injection port
        per_port: dict[tuple[int, int], tuple[int, float]] = {}
        for (s, d), b in zip(edges, per_edge):
            if s == d:
                continue
            key = (s, self.link_level(s, d))
            n, tot = per_port.get(key, (0, 0.0))
            per_port[key] = (n + 1, tot + b)
        worst = 0.0
        for (s, lvl), (n, tot) in per_port.items():
            worst = max(worst, self.levels[lvl].link.time(tot, nmsgs=n))
        return worst


def flat_topology(nranks: int) -> Topology:
    return Topology(nranks=nranks, ranks_per_pod=nranks)


def torus_topology(npods: int, *axis_sizes: int,
                   axis_names: Sequence[str] | None = None) -> Topology:
    """Multi-level helper: ``npods`` pods over DCN, each an N-D torus of
    ``axis_sizes`` (outermost first) over ICI, e.g.
    ``torus_topology(2, 4, 4)`` = 2 pods of a 4x4 torus (32 ranks)."""
    names = (list(axis_names) if axis_names is not None
             else [f"torus_{'xyzw'[len(axis_sizes) - 1 - i]}"
                   for i in range(len(axis_sizes))])
    if len(names) != len(axis_sizes):
        raise ValueError("axis_names must match axis_sizes")
    levels: list[TopoLevel] = []
    if npods > 1:
        levels.append(TopoLevel("dcn", npods, DCN_LINK, dcn=True))
    levels += [TopoLevel(nm, sz, ICI_LINK)
               for nm, sz in zip(names, axis_sizes)]
    return Topology.from_levels(levels)
