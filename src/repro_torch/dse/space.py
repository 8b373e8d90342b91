"""Named example design spaces and workload resolution for the DSE CLI.

Spaces are built over the preset templates in ``repro_torch.core.presets``; each
sweeps the design-space axes — per-level buffer capacities, fanout
dims under a total-PE budget, optional level removal — and every axis value
is an anchor-scaled derivation, so the preset point itself is always a
member of its space (bit-identical to the hand-written preset).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.core.arch import ArchAxis, ArchSpace
from repro_torch.core.einsum import Einsum
from repro_torch.core.presets import (gpt3_einsums, nvdla_template,
                                small_matmul_suite, tpu_v4i_template)

KiW = 2 ** 10  # Ki words
MiW = 2 ** 20  # Mi words


def edge_space() -> ArchSpace:
    """NVDLA-like edge sweep: buffer capacity x MAC-array shape under a
    fixed PE budget.  16 points (4 x 4), all within budget."""
    return ArchSpace(
        name="edge",
        template=nvdla_template(tensors=("A", "B", "Z")),
        axes=(
            ArchAxis("capacity", "BUF",
                     (8 * KiW, 32 * KiW, 128 * KiW, 512 * KiW)),
            ArchAxis("fanout", 0,
                     ((8, 48), (16, 96), (32, 192), (64, 384))),
        ),
        pe_budget=64 * 384,
    )


def edge_small_space() -> ArchSpace:
    """CI-scale edge sweep: 4 capacities x 3 array shapes with the largest
    array filtered by the PE budget -> 8 candidate points."""
    return ArchSpace(
        name="edge-small",
        template=nvdla_template(tensors=("A", "B", "Z")),
        axes=(
            ArchAxis("capacity", "BUF",
                     (8 * KiW, 32 * KiW, 128 * KiW, 512 * KiW)),
            ArchAxis("fanout", 0, ((16, 96), (32, 192), (64, 384))),
        ),
        pe_budget=32 * 192,  # (64, 384) points are over budget
    )


def datacenter_space() -> ArchSpace:
    """TPU-v4i-like sweep: GLB/LB capacities x PE count, with the per-MAC
    weight-register level optionally removed (level axis: weights then
    stream from the GLB) and an area budget.

    The LB level cannot be the removal axis here: dropping it would land
    the MAC-array fanout on the GLB next to the PE fanout, which
    ``Arch.__post_init__`` rejects — every such point would be invalid.
    """
    return ArchSpace(
        name="datacenter",
        template=tpu_v4i_template(tensors=("A", "B", "Z")),
        axes=(
            ArchAxis("capacity", "GLB", (16 * MiW, 64 * MiW)),
            ArchAxis("capacity", "LB", (1 * MiW, 2 * MiW)),
            ArchAxis("fanout", 0, ((2,), (4,), (8,))),
            ArchAxis("level", "REG", (True, False)),
        ),
        pe_budget=8 * 128 * 128,
        area_budget_mm2=2500.0,
    )


SPACES: Dict[str, Callable[[], ArchSpace]] = {
    "edge": edge_space,
    "edge-small": edge_small_space,
    "datacenter": datacenter_space,
}


def get_space(name: str) -> ArchSpace:
    try:
        return SPACES[name]()
    except KeyError:
        raise KeyError(
            f"unknown space {name!r} (known: {', '.join(sorted(SPACES))})")


def resolve_workload(spec: str, paper_scale: bool = False
                     ) -> List[Einsum]:
    """Resolve a comma-separated einsum list for the CLI.

    Names come from ``small_matmul_suite()`` (CI-scale, the default) or —
    with ``paper_scale`` — from ``gpt3_einsums()`` + the small suite as
    fallback.
    """
    suites: List[Dict[str, Einsum]] = [small_matmul_suite()]
    if paper_scale:
        suites.insert(0, gpt3_einsums())
    out: List[Einsum] = []
    for name in (n.strip() for n in spec.split(",") if n.strip()):
        for suite in suites:
            if name in suite:
                out.append(suite[name])
                break
        else:
            known = sorted({n for s in suites for n in s})
            raise KeyError(f"unknown workload einsum {name!r} "
                           f"(known: {', '.join(known)})")
    if not out:
        raise ValueError("empty workload spec")
    return out
