"""Accelerator architecture model and parameterized design spaces.

An architecture is an ordered list of memory levels (outermost backing store
first), optional spatial fanouts *below* a level (e.g. a PE array between the
global buffer and per-PE buffers), and compute parameters.

Units: capacities in words (elements), energies in pJ per word access (or per
MAC), bandwidths in words/s, frequency in Hz.  Latency comes out in seconds,
energy in pJ; EDP in pJ*s.

Beyond the fixed :class:`Arch` value, this module provides the architecture
*design-space* layer used by ``repro.dse``:

  * canonical serialization (:func:`arch_to_dict` / :func:`arch_from_dict`)
    and structural content keys (:func:`arch_key`) so architectures can be
    hashed, cached and deduped the way einsums already are (name ignored,
    numerics canonicalized);
  * a crude area proxy (:func:`arch_area_mm2`: on-chip words + MACs -> mm²)
    for budget filtering during sweeps;
  * :class:`ArchTemplate` — an anchor architecture plus Accelergy-style
    capacity scaling (access energy ∝ ``(cap/cap0)**energy_exp``, bandwidth
    ∝ ``(cap/cap0)**bandwidth_exp``) that instantiates concrete ``Arch``
    values from per-axis overrides (level capacities, fanout dims, level
    removal);
  * :class:`ArchAxis` / :class:`ArchSpace` — named swept axes over a
    template, with PE- and area-budget filters and arch-key dedup, yielding
    :class:`ArchPoint` candidates for the explorer.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple, Union


@dataclass(frozen=True)
class MemLevel:
    name: str
    capacity: float  # words; inf for DRAM
    read_energy: float  # pJ / word
    write_energy: float  # pJ / word
    bandwidth: float  # words / s (combined rd+wr unless split)
    read_bandwidth: Optional[float] = None
    write_bandwidth: Optional[float] = None
    # Restrict which tensors may have a storage node here (None = all).
    # Entries are tensor names; hardware like a weight-register file uses this.
    allowed_tensors: Optional[Tuple[str, ...]] = None
    # If True, every tensor in allowed set MUST have a node here (backing
    # stores + mandatory register files).
    mandatory: bool = False
    # If True (with mandatory), only the canonical storage-node order is
    # generated for this level — a user dataplacement constraint (paper §V-A)
    # used to pin hardware-dedicated buffers.
    fixed_order: bool = False


@dataclass(frozen=True)
class SpatialFanout:
    """A spatial array boundary below memory level ``above_level``.

    Each dim has a size, and an optional constraint on what may be mapped:
      * ``multicast_tensor``: instances along this dim receive the same data
        of this tensor (loops over vars *irrelevant* to it go here); parent
        reads of that tensor are not multiplied by this dim.
      * ``reduce_tensor``: partial outputs along this dim are reduced
        in-network (contraction vars go here); parent writes of the output
        are not multiplied by this dim.
    If both are None the dim is unconstrained (any var; no discounts).
    """

    above_level: int  # index into Arch.levels; fanout sits below this level
    dims: Tuple[int, ...]
    multicast_tensor: Tuple[Optional[str], ...] = ()
    reduce_tensor: Tuple[Optional[str], ...] = ()

    def __post_init__(self):
        n = len(self.dims)
        if not self.multicast_tensor:
            object.__setattr__(self, "multicast_tensor", (None,) * n)
        if not self.reduce_tensor:
            object.__setattr__(self, "reduce_tensor", (None,) * n)
        if any(d < 1 for d in self.dims):
            raise ValueError(f"fanout dims must be >= 1, got {self.dims}")
        if len(self.multicast_tensor) != n or len(self.reduce_tensor) != n:
            raise ValueError(
                f"multicast/reduce tensor tuples must match dims length {n}: "
                f"got {len(self.multicast_tensor)}/{len(self.reduce_tensor)}")

    @property
    def total(self) -> int:
        out = 1
        for d in self.dims:
            out *= d
        return out


@dataclass(frozen=True)
class Arch:
    name: str
    levels: Tuple[MemLevel, ...]  # [0] = outermost backing store (DRAM)
    fanouts: Tuple[SpatialFanout, ...] = ()
    mac_energy: float = 1.0  # pJ / MAC
    frequency: float = 1e9  # Hz; compute latency = macs/units/frequency

    def __post_init__(self):
        assert self.levels, "need at least one memory level"
        assert self.levels[0].capacity == float("inf") or self.levels[0].capacity > 0
        seen = set()
        for f in self.fanouts:
            if not 0 <= f.above_level < len(self.levels):
                raise ValueError(
                    f"fanout above_level {f.above_level} out of range for "
                    f"{len(self.levels)} memory levels")
            if f.above_level in seen:
                raise ValueError(
                    f"duplicate fanout below level {f.above_level} "
                    f"({self.levels[f.above_level].name}): fanout_below "
                    f"would silently ignore all but the first")
            seen.add(f.above_level)

    @property
    def total_compute_units(self) -> int:
        out = 1
        for f in self.fanouts:
            out *= f.total
        return out

    def fanout_below(self, level_idx: int) -> Optional[SpatialFanout]:
        for f in self.fanouts:
            if f.above_level == level_idx:
                return f
        return None

    def level_index(self, name: str) -> int:
        for i, l in enumerate(self.levels):
            if l.name == name:
                return i
        raise KeyError(name)


# --------------------------------------------------------------------------
# Canonical serialization + content keys
# --------------------------------------------------------------------------


def _num(x):
    """Canonicalize a numeric field for serialization.

    Integral floats become ints so that ``==``-equal architectures (Python
    compares ``2.0 == 2``) serialize identically and share one
    :func:`arch_key`; ``inf`` becomes the string ``"inf"`` (strict-JSON
    safe).  Non-integral floats keep JSON's shortest-repr encoding, which
    round-trips bit-exactly.
    """
    if x is None:
        return None
    if x == float("inf"):
        return "inf"
    if isinstance(x, float) and x.is_integer():
        return int(x)
    return x


def _denum(x):
    return float("inf") if x == "inf" else x


def arch_to_dict(arch: Arch) -> dict:
    """Complete, JSON-safe description of ``arch`` (exact round-trip via
    :func:`arch_from_dict`)."""
    return {
        "name": arch.name,
        "levels": [
            {
                "name": l.name,
                "capacity": _num(l.capacity),
                "read_energy": _num(l.read_energy),
                "write_energy": _num(l.write_energy),
                "bandwidth": _num(l.bandwidth),
                "read_bandwidth": _num(l.read_bandwidth),
                "write_bandwidth": _num(l.write_bandwidth),
                "allowed_tensors": (None if l.allowed_tensors is None
                                    else list(l.allowed_tensors)),
                "mandatory": bool(l.mandatory),
                "fixed_order": bool(l.fixed_order),
            }
            for l in arch.levels
        ],
        "fanouts": [
            {
                "above_level": f.above_level,
                "dims": list(f.dims),
                "multicast_tensor": list(f.multicast_tensor),
                "reduce_tensor": list(f.reduce_tensor),
            }
            for f in arch.fanouts
        ],
        "mac_energy": _num(arch.mac_energy),
        "frequency": _num(arch.frequency),
    }


def arch_from_dict(d: dict) -> Arch:
    """Inverse of :func:`arch_to_dict`; tolerant of key order."""
    levels = tuple(
        MemLevel(
            name=l["name"],
            capacity=_denum(l["capacity"]),
            read_energy=_denum(l["read_energy"]),
            write_energy=_denum(l["write_energy"]),
            bandwidth=_denum(l["bandwidth"]),
            read_bandwidth=_denum(l.get("read_bandwidth")),
            write_bandwidth=_denum(l.get("write_bandwidth")),
            allowed_tensors=(None if l.get("allowed_tensors") is None
                             else tuple(l["allowed_tensors"])),
            mandatory=bool(l.get("mandatory", False)),
            fixed_order=bool(l.get("fixed_order", False)),
        )
        for l in d["levels"]
    )
    fanouts = tuple(
        SpatialFanout(
            above_level=int(f["above_level"]),
            dims=tuple(int(x) for x in f["dims"]),
            multicast_tensor=tuple(f["multicast_tensor"]),
            reduce_tensor=tuple(f["reduce_tensor"]),
        )
        for f in d.get("fanouts", ())
    )
    return Arch(name=d["name"], levels=levels, fanouts=fanouts,
                mac_energy=_denum(d["mac_energy"]),
                frequency=_denum(d["frequency"]))


def arch_key(arch: Arch) -> str:
    """Structural content hash of ``arch`` — the einsum-key analogue.

    ``name`` is ignored (two sweep points that differ only cosmetically are
    the same hardware); everything the cost model reads — level capacities,
    energies, bandwidths, tensor constraints, fanout wiring, compute
    parameters — enters the hash through the canonical serialization, so
    any swept axis changes the key.  Stable under field reordering (keys
    are sorted) and int-vs-float spellings of the same value.
    """
    d = arch_to_dict(arch)
    del d["name"]
    payload = json.dumps(d, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


# --------------------------------------------------------------------------
# Area proxy
# --------------------------------------------------------------------------

# Crude technology anchors for the area proxy — arbitrary but fixed, so
# areas are comparable *within* a sweep (that is all budget filtering and
# Pareto frontiers need).  Off-chip backing stores (infinite capacity) are
# excluded.
AREA_PER_WORD_MM2 = 2.5e-7  # on-chip SRAM, per word (~0.25 mm² / Mi word)
AREA_PER_MAC_MM2 = 3.0e-4  # one MAC unit incl. local wiring


def level_instances(arch: Arch, level_idx: int) -> int:
    """Physical copies of level ``level_idx`` (product of fanouts above)."""
    inst = 1
    for f in arch.fanouts:
        if f.above_level < level_idx:
            inst *= f.total
    return inst


def arch_area_mm2(arch: Arch,
                  area_per_word: float = AREA_PER_WORD_MM2,
                  area_per_mac: float = AREA_PER_MAC_MM2) -> float:
    """Words + MACs -> mm² proxy for design-space budget filtering."""
    words = 0.0
    for i, l in enumerate(arch.levels):
        if l.capacity == float("inf"):
            continue  # off-chip backing store
        words += level_instances(arch, i) * l.capacity
    return words * area_per_word + arch.total_compute_units * area_per_mac


# --------------------------------------------------------------------------
# Parameterized design spaces
# --------------------------------------------------------------------------

AxisTarget = Union[str, int]
AxisKey = Tuple[str, AxisTarget]

_AXIS_KINDS = ("capacity", "fanout", "level")


def _axis_key(key) -> AxisKey:
    """Normalize an override key: ``("capacity", "GLB")`` or ``"fanout:0"``."""
    if isinstance(key, str):
        kind, _, target = key.partition(":")
    else:
        kind, target = key
    if kind not in _AXIS_KINDS:
        raise ValueError(f"unknown arch axis kind {kind!r} "
                         f"(expected one of {_AXIS_KINDS})")
    if kind == "fanout":
        target = int(target)
    return (kind, target)


def _fmt_value(kind: str, value) -> str:
    if kind == "fanout":
        return "x".join(str(d) for d in value)
    if kind == "level":
        return "on" if value else "off"
    return str(_num(value))


@dataclass(frozen=True)
class ArchAxis:
    """One swept dimension of an :class:`ArchSpace`.

    ``kind``:
      * ``"capacity"`` — ``target`` is a level name, ``values`` capacities
        in words; access energy and bandwidth are re-derived from the
        template's anchor point.
      * ``"fanout"`` — ``target`` is an index into ``Arch.fanouts``,
        ``values`` are dims tuples (same rank as the template's: only sizes
        are swept, the multicast/reduce wiring is structural).
      * ``"level"`` — ``target`` is a level name, ``values`` drawn from
        ``(True, False)``: the template's level is kept or removed
        (insertion is expressed by putting the optional level in the
        template and sweeping it off).
    """

    kind: str
    target: AxisTarget
    values: Tuple = ()

    def __post_init__(self):
        kind, target = _axis_key((self.kind, self.target))
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "target", target)
        if not self.values:
            raise ValueError(f"axis {self.label} has no values")
        if self.kind == "fanout":
            object.__setattr__(
                self, "values",
                tuple(tuple(int(d) for d in v) for v in self.values))
        else:
            object.__setattr__(self, "values", tuple(self.values))

    @property
    def label(self) -> str:
        return f"{self.kind}:{self.target}"


@dataclass(frozen=True)
class ArchTemplate:
    """An anchor :class:`Arch` plus the derivation rules that turn axis
    overrides into concrete architectures.

    Capacity scaling is Accelergy-style: per-word access energy grows with
    the square root of capacity (``e = e0 * (cap/cap0)**energy_exp``, more
    banks/longer wires), and bandwidth follows its own exponent from the
    same anchor.  ``instantiate()`` with no overrides — or with overrides
    equal to the anchor values — returns the base architecture bit-identical
    (ratio-1 scaling is skipped), which is how the fixed presets are
    re-expressed through templates.
    """

    base: Arch
    energy_exp: float = 0.5
    bandwidth_exp: float = 0.5

    def _scale_level(self, lvl: MemLevel, new_cap) -> MemLevel:
        if new_cap is None or new_cap == lvl.capacity:
            return lvl
        if lvl.capacity == float("inf"):
            raise ValueError(
                f"cannot sweep the capacity of backing store {lvl.name!r}")
        ratio = new_cap / lvl.capacity
        es = ratio ** self.energy_exp
        bs = ratio ** self.bandwidth_exp
        return dataclasses.replace(
            lvl,
            capacity=new_cap,
            read_energy=lvl.read_energy * es,
            write_energy=lvl.write_energy * es,
            bandwidth=lvl.bandwidth * bs,
            read_bandwidth=(None if lvl.read_bandwidth is None
                            else lvl.read_bandwidth * bs),
            write_bandwidth=(None if lvl.write_bandwidth is None
                             else lvl.write_bandwidth * bs),
        )

    def instantiate(self, overrides=None) -> Arch:
        """Build a concrete ``Arch`` from per-axis overrides.

        ``overrides`` maps axis keys (``("capacity", "GLB")``, ``"fanout:0"``,
        ``("level", "LB")``) to values.  Raises ``ValueError`` for unknown
        targets and structurally impossible points (removing the backing
        store, a removal that leaves two fanouts below one level, fanout
        rank changes) — :meth:`ArchSpace.materialize` counts and skips
        those.  Capacity overrides for a level removed by the same point
        are ignored.
        """
        base = self.base
        ov: Dict[AxisKey, object] = {}
        for k, v in (overrides or {}).items():
            ov[_axis_key(k)] = v

        level_names = [l.name for l in base.levels]
        for kind, target in ov:
            if kind in ("capacity", "level") and target not in level_names:
                raise KeyError(f"no level named {target!r} in {base.name}")
            if kind == "fanout" and not 0 <= target < len(base.fanouts):
                raise KeyError(f"no fanout {target} in {base.name}")

        removed = {t for (k, t), v in ov.items() if k == "level" and not v}
        if base.levels[0].name in removed:
            raise ValueError(
                f"cannot remove backing store {base.levels[0].name!r}")

        kept: List[Tuple[int, MemLevel]] = []
        for i, lvl in enumerate(base.levels):
            if lvl.name in removed:
                continue
            kept.append((i, self._scale_level(lvl,
                                              ov.get(("capacity", lvl.name)))))
        kept_orig = [i for i, _ in kept]

        fanouts = []
        for fi, f in enumerate(base.fanouts):
            dims = ov.get(("fanout", fi))
            if dims is not None:
                if len(dims) != len(f.dims):
                    raise ValueError(
                        f"fanout {fi} of {base.name} has {len(f.dims)} dims; "
                        f"axis value {dims} changes the rank")
                dims = tuple(int(d) for d in dims)
            else:
                dims = f.dims
            # reattach below the nearest surviving level at or above
            anchors = [j for j, oi in enumerate(kept_orig)
                       if oi <= f.above_level]
            if not anchors:
                raise ValueError(f"fanout {fi} has no surviving level above")
            fanouts.append(SpatialFanout(
                above_level=anchors[-1], dims=dims,
                multicast_tensor=f.multicast_tensor,
                reduce_tensor=f.reduce_tensor))

        name = base.name
        effective = {(k, t): v for (k, t), v in ov.items()
                     if not (k == "capacity" and t in removed)}
        if effective:
            parts = [f"{k}:{t}={_fmt_value(k, v)}"
                     for (k, t), v in sorted(effective.items(),
                                             key=lambda kv: str(kv[0]))]
            name = f"{base.name}@{','.join(parts)}"
        return Arch(name=name, levels=tuple(l for _, l in kept),
                    fanouts=tuple(fanouts), mac_energy=base.mac_energy,
                    frequency=base.frequency)


@dataclass(frozen=True)
class ArchPoint:
    """One enumerated candidate of an :class:`ArchSpace`."""

    coords: Tuple[Tuple[str, object], ...]  # (axis label, value), axis order
    arch: Arch
    area_mm2: float
    key: str  # arch_key(arch): content identity for dedup + caching

    @property
    def coords_str(self) -> str:
        return ",".join(f"{k.split(':', 1)[1]}={_fmt_value(k.split(':')[0], v)}"
                        for k, v in self.coords)


@dataclass(frozen=True)
class ArchSpace:
    """A named cartesian design space over an :class:`ArchTemplate`.

    ``materialize()`` enumerates the cross-product of axis values in a
    deterministic order, instantiates each point, and filters: structurally
    invalid combinations, points whose fanout exceeds ``pe_budget`` (total
    compute units), points whose :func:`arch_area_mm2` exceeds
    ``area_budget_mm2``, and content duplicates (two coordinate tuples that
    derive the same hardware share one :func:`arch_key` and are searched
    once).
    """

    name: str
    template: ArchTemplate
    axes: Tuple[ArchAxis, ...]
    pe_budget: Optional[int] = None
    area_budget_mm2: Optional[float] = None

    def __post_init__(self):
        # axis targets are the same for every combo — validate once here so
        # a typo fails loudly instead of yielding an all-invalid empty sweep
        base = self.template.base
        level_names = {l.name for l in base.levels}
        seen = set()
        for ax in self.axes:
            if ax.kind in ("capacity", "level") and ax.target not in level_names:
                raise KeyError(
                    f"space {self.name!r}: axis {ax.label} targets no level "
                    f"of {base.name} (levels: {sorted(level_names)})")
            if ax.kind == "fanout" and not 0 <= ax.target < len(base.fanouts):
                raise KeyError(
                    f"space {self.name!r}: axis {ax.label} targets no "
                    f"fanout of {base.name} ({len(base.fanouts)} fanouts)")
            if (ax.kind, ax.target) in seen:
                raise ValueError(
                    f"space {self.name!r}: duplicate axis {ax.label}")
            seen.add((ax.kind, ax.target))

    @property
    def size(self) -> int:
        out = 1
        for ax in self.axes:
            out *= len(ax.values)
        return out

    def points(self) -> Iterator[ArchPoint]:
        pts, _ = self.materialize()
        return iter(pts)

    def materialize(self, max_points: Optional[int] = None
                    ) -> Tuple[List[ArchPoint], Dict[str, int]]:
        """Enumerate the space: (points, filter counters).

        Counters: ``n_combos`` (cross-product combos actually scanned — the
        full ``size`` unless ``max_points`` stopped enumeration early, so
        combos always reconcile as points + invalid + over-budget +
        duplicates), ``n_invalid`` (structurally impossible),
        ``n_over_pe_budget``, ``n_over_area_budget``, ``n_duplicates``
        (arch-key dedup).  ``max_points`` truncates *after* filtering
        (deterministic prefix, used by CI smoke subspaces).
        """
        counters = {"n_combos": 0, "n_invalid": 0,
                    "n_over_pe_budget": 0, "n_over_area_budget": 0,
                    "n_duplicates": 0}
        points: List[ArchPoint] = []
        seen: Dict[str, int] = {}
        for combo in itertools.product(*(ax.values for ax in self.axes)):
            counters["n_combos"] += 1
            overrides = {(ax.kind, ax.target): v
                         for ax, v in zip(self.axes, combo)}
            try:
                arch = self.template.instantiate(overrides)
            except (ValueError, KeyError):
                counters["n_invalid"] += 1
                continue
            if (self.pe_budget is not None
                    and arch.total_compute_units > self.pe_budget):
                counters["n_over_pe_budget"] += 1
                continue
            area = arch_area_mm2(arch)
            if (self.area_budget_mm2 is not None
                    and area > self.area_budget_mm2):
                counters["n_over_area_budget"] += 1
                continue
            key = arch_key(arch)
            if key in seen:
                counters["n_duplicates"] += 1
                continue
            seen[key] = len(points)
            points.append(ArchPoint(
                coords=tuple((ax.label, v)
                             for ax, v in zip(self.axes, combo)),
                arch=arch, area_mm2=area, key=key))
            if max_points is not None and len(points) >= max_points:
                break
        return points, counters
