"""``repro_torch.obs`` — structured search telemetry for the mapper stack.

Spans + typed counter/instant events threaded through ``tcm_map`` /
``tcm_map_group``, the search engines (worker-side buffers merged in unit
order), the tile-shape steppers (per-step expansion samples with
per-criterion prune attribution), ``repro_torch.netmap`` (cache + fusion
decisions) and ``repro_torch.dse`` (per-point spans, roofline prunes).

Entry points:

  * :class:`Tracer` / :class:`NullTracer` — the event buffer and its
    zero-overhead stand-in; pass ``tracer=`` to any driver API, or
    ``--trace PATH`` to the ``netmap`` / ``dse`` / ``gap`` / benchmark CLIs.
  * ``export`` — JSONL event log + Chrome-trace/Perfetto JSON.
  * ``profile`` — the human report (phase breakdown, top-k expensive units,
    incumbent timeline, pool worker utilization).
  * ``python -m repro_torch.obs report TRACE`` /
    ``... chrome TRACE -o OUT.json``.

Tracing is off by default and the disabled path is contractually free:
optima and ``MapperStats`` are bit-identical with and without a tracer
(``tests/test_obs.py``).
"""
from .export import (from_chrome, read_jsonl, read_trace, to_chrome,
                     write_chrome, write_jsonl)
from .report import ProfileReport, PruneAttribution, profile
from .tracer import (CAT_CACHE, CAT_DRIVER, CAT_DSE, CAT_FUSION,
                     CAT_INCUMBENT, CAT_PHASE, CAT_SERVICE, CAT_STEP,
                     CAT_UNIT, NULL_TRACER, Event, NullTracer, Tracer,
                     active)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Event", "active",
    "CAT_DRIVER", "CAT_PHASE", "CAT_UNIT", "CAT_STEP", "CAT_INCUMBENT",
    "CAT_CACHE", "CAT_FUSION", "CAT_DSE", "CAT_SERVICE",
    "write_jsonl", "read_jsonl", "write_chrome", "to_chrome", "from_chrome",
    "read_trace", "profile", "ProfileReport", "PruneAttribution",
]
