"""Integer factorization helpers shared by the mapper and tile-shape layers.

``prime_factorization`` is the single source of truth for prime
decompositions (``mapper`` re-exports it as ``_prime_factorization`` for
backwards compatibility).  ``divisors`` generates the sorted divisor list by
expanding the prime-power lattice instead of trial-dividing every integer up
to ``n`` — a shape like 32768 has 16 divisors but would otherwise cost a
32k-iteration Python loop per cache miss.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np


@lru_cache(maxsize=None)
def prime_factorization(n: int) -> Tuple[Tuple[int, int], ...]:
    """((prime, multiplicity), ...) in ascending prime order."""
    out = []
    d = 2
    while d * d <= n:
        e = 0
        while n % d == 0:
            n //= d
            e += 1
        if e:
            out.append((d, e))
        d += 1
    if n > 1:
        out.append((n, 1))
    return tuple(out)


@lru_cache(maxsize=None)
def divisors(n: int) -> np.ndarray:
    """All divisors of ``n`` as a sorted int64 array."""
    out = [1]
    for p, e in prime_factorization(n):
        pk = 1
        powers = []
        for _ in range(e):
            pk *= p
            powers.append(pk)
        out += [d * pw for d in out for pw in powers]
    arr = np.array(sorted(out), dtype=np.int64)
    arr.setflags(write=False)
    return arr
