"""Structured search telemetry: the tracer the mapper's drivers take."""
from .tracer import (CAT_CACHE, CAT_DRIVER, CAT_DSE, CAT_FUSION,
                     CAT_INCUMBENT, CAT_PHASE, CAT_SERVICE, CAT_STEP,
                     CAT_UNIT, NULL_TRACER, Event, NullTracer, Tracer,
                     active)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Event", "active",
    "CAT_DRIVER", "CAT_PHASE", "CAT_UNIT", "CAT_STEP", "CAT_INCUMBENT",
    "CAT_CACHE", "CAT_FUSION", "CAT_DSE", "CAT_SERVICE",
]
