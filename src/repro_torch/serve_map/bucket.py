"""Shape bucketing: collapse decode-shape diversity onto few cache keys.

Real serving traffic produces a long tail of (batch, seqlen) pairs — every
decode step grows the KV length by one — but mappings are robust to modest
shape padding, so the service searches (and caches) one mapping per
*bucket* and serves it for every shape inside the bucket.

The policy is deliberately simple and einsum-agnostic: every rank extent is
rounded **up** to the nearest geometric boundary ``min_bucket * growth^i``
(defaults: powers of two).  Model-structural dims (d_model, d_head, d_ff)
are powers of two in practice and pass through unchanged; the traffic dims
(tokens, kv_len, head batch) are the ones that collapse.  A request for
kv_len 3000 is served the mapping searched for kv_len 4096.

**Correctness contract** (enforced by :func:`validate_bucketed`, called by
the service before every bucketed answer): the bucket einsum must dominate
the exact einsum dim-for-dim (so executing the request padded to the
bucket is always possible — the standard pad-to-boundary serving
contract), must be structurally identical apart from extents, and the
served mapping must pass ``validate_structure`` against the bucket einsum
rebuilt *fresh from the exact request* — a stale or corrupt cache entry
can never be served.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

from ..core.arch import Arch
from ..core.einsum import Einsum
from ..core.looptree import Mapping, validate_structure

__all__ = ["ShapeBucketer", "validate_bucketed"]


@dataclass(frozen=True)
class ShapeBucketer:
    """Rounds every rank extent up to ``min_bucket * growth^i`` boundaries.

    ``growth=2.0, min_bucket=1`` (the default) buckets onto powers of two.
    A larger ``min_bucket`` trades more padding on tiny dims for fewer
    buckets; ``growth`` closer to 1 trades more buckets for less padding.
    Values at a boundary are unchanged, so exact-shape traffic with
    power-of-two dims never pays any padding.
    """

    min_bucket: int = 1
    growth: float = 2.0

    def __post_init__(self):
        if self.min_bucket < 1:
            raise ValueError(f"min_bucket must be >= 1, got {self.min_bucket}")
        if self.growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {self.growth}")

    def bucket_value(self, x: int) -> int:
        """Smallest boundary >= x (boundaries: min_bucket * growth^i)."""
        if x <= self.min_bucket:
            return self.min_bucket
        b = float(self.min_bucket)
        while b < x:
            b = math.ceil(b * self.growth)
        return int(b)

    def bucket_einsum(self, einsum: Einsum) -> Tuple[Einsum, bool]:
        """The bucket einsum for ``einsum`` and whether any dim moved.

        The returned einsum keeps the tensor structure verbatim and only
        rounds ``rank_shapes``; its name gains a ``~b`` suffix so traces
        and reports show which answers were served padded (names never
        enter cache keys — those are structural).
        """
        shapes = {v: self.bucket_value(s)
                  for v, s in einsum.rank_shapes.items()}
        if shapes == dict(einsum.rank_shapes):
            return einsum, False
        return Einsum(name=f"{einsum.name}~b", tensors=einsum.tensors,
                      rank_shapes=shapes), True


def validate_bucketed(exact: Einsum, bucket: Einsum, arch: Arch,
                      mapping: Mapping) -> None:
    """Assert the service's bucketed-answer contract (see module doc).

    Raises ``AssertionError`` when the bucket does not dominate the exact
    shape, the tensor structures diverge, or the mapping is not a valid
    mapping of the bucket einsum on ``arch``.
    """
    assert tuple(t.name for t in bucket.tensors) == \
        tuple(t.name for t in exact.tensors), (
            f"bucket/exact tensor mismatch: {bucket.name} vs {exact.name}")
    for tb, te in zip(bucket.tensors, exact.tensors):
        assert tb.dims == te.dims, (
            f"bucket/exact dim structure mismatch on {tb.name}")
    for v, s in exact.rank_shapes.items():
        bs = bucket.rank_shapes.get(v)
        assert bs is not None and bs >= s, (
            f"bucket does not cover exact shape: {v}={s} vs bucket {bs}")
    validate_structure(bucket, arch, mapping)
