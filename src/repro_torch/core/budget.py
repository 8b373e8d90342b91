"""Anytime-search budgets: wall-clock deadlines and expanded-node caps.

The resilience layer's contract is *graceful degradation with a proof*: a
search that runs out of budget stops at step granularity, returns the best
complete mapping found so far (each unit's beam-dive incumbent is always
available), and reports a **sound objective lower bound** for the subtrees
it did not finish (see ``tileshape.explore``), so the driver can certify an
optimality gap (``MapperStats.gap_bound``) instead of silently returning a
heuristic answer.

Three objects share one duck-typed meter interface (``charge(n)``,
``expired()``, ``remaining_nodes()``, ``deadline_epoch``):

  * :class:`SearchBudget` — the immutable, picklable *spec* callers pass to
    ``tcm_map``/``map_network``/``explore_space`` (``budget=``).  The clock
    starts when the driver calls :meth:`SearchBudget.start`.
  * :class:`BudgetMeter` — the driver-side running meter.  One meter can be
    threaded through *many* searches (netmap threads one across every layer
    of a model), so the deadline and node cap are global to the run, not
    per-search.
  * :class:`SharedBudgetMeter` — the worker-side view used by
    ``ProcessPoolEngine``: three ``multiprocessing.Value`` slots (absolute
    deadline epoch, remaining-node cap, consumed-node counter) installed by
    the pool initializer; the engine folds the consumed count back into the
    driver meter after each batch.

With ``budget=None`` (the default everywhere) no meter exists and every
search executes its historical instruction stream — results and stats are
bit-identical (enforced by ``tests/test_budget.py`` and the
``check_perf.py`` overhead gate).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Union

_INF = float("inf")


@dataclass(frozen=True)
class SearchBudget:
    """Immutable anytime-search budget spec (picklable, reusable).

    ``deadline_s`` — wall-clock seconds measured from :meth:`start`;
    ``max_expanded`` — cap on branch-and-bound expansions (the same count
    as ``MapperStats.n_expanded``), checked at step granularity, so a run
    may exceed the cap by at most one step's expansion.  Either may be
    ``None`` (unbounded on that axis); both ``None`` is a valid no-op
    budget.
    """

    deadline_s: Optional[float] = None
    max_expanded: Optional[int] = None

    def start(self) -> "BudgetMeter":
        """Start the clock: bind the relative deadline to an absolute
        wall-clock epoch and return a fresh running meter."""
        return BudgetMeter(self)


class BudgetMeter:
    """Driver-side running meter for one :class:`SearchBudget`.

    Deliberately *not* picklable across the pool boundary as-is — the
    process engine mirrors it into :class:`SharedBudgetMeter` slots and
    folds consumed nodes back after each batch, so serial and pooled
    searches draw down one global budget identically.
    """

    __slots__ = ("spec", "deadline_epoch", "cap", "used")

    def __init__(self, spec: SearchBudget):
        self.spec = spec
        self.deadline_epoch: Optional[float] = (
            time.time() + spec.deadline_s
            if spec.deadline_s is not None else None)
        self.cap: Optional[int] = (
            int(spec.max_expanded) if spec.max_expanded is not None else None)
        self.used = 0

    def charge(self, n: int) -> None:
        self.used += int(n)

    def expired(self) -> bool:
        if self.cap is not None and self.used >= self.cap:
            return True
        return (self.deadline_epoch is not None
                and time.time() >= self.deadline_epoch)

    def remaining_nodes(self) -> Optional[int]:
        return None if self.cap is None else max(0, self.cap - self.used)


class SharedBudgetMeter:
    """Worker-side meter over the pool's shared slots.

    ``deadline``/``cap``/``nodes`` are ``multiprocessing.Value`` handles
    (``'d'``/``'q'``/``'q'``) installed by the pool initializer; a deadline
    of ``inf`` with a negative cap means "no budget active".  Reads go
    straight at ``.value`` (same aligned-8-byte-load argument as the shared
    incumbent, see ``search._WORKER_INCUMBENT``); the consumed-node counter
    is incremented under its lock so concurrent workers never lose counts.
    """

    __slots__ = ("deadline", "cap", "nodes")

    def __init__(self, deadline, cap, nodes):
        self.deadline = deadline
        self.cap = cap
        self.nodes = nodes

    @property
    def deadline_epoch(self) -> Optional[float]:
        d = self.deadline.value
        return None if d == _INF else d

    def charge(self, n: int) -> None:
        with self.nodes.get_lock():
            self.nodes.value += int(n)

    def expired(self) -> bool:
        cap = self.cap.value
        if cap >= 0 and self.nodes.value >= cap:
            return True
        d = self.deadline.value
        return d != _INF and time.time() >= d

    def remaining_nodes(self) -> Optional[int]:
        cap = self.cap.value
        return None if cap < 0 else max(0, int(cap - self.nodes.value))


AnyMeter = Union[BudgetMeter, SharedBudgetMeter]


def ensure_meter(budget: Union[SearchBudget, AnyMeter, None]
                 ) -> Optional[AnyMeter]:
    """Normalize a ``budget=`` argument: ``None`` passes through, a spec
    starts its clock *now*, a live meter (driver- or worker-side) is used
    as-is — this is what lets one meter span many searches."""
    if budget is None:
        return None
    if isinstance(budget, SearchBudget):
        return budget.start()
    return budget
