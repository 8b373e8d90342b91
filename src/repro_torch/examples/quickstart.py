"""Quickstart: find the optimal mapping of a GPT-3-style einsum with TCM.

  PYTHONPATH=src python -m repro_torch.examples.quickstart            # ~1 min
  PYTHONPATH=src python -m repro_torch.examples.quickstart --paper    # 6.7B QK
  PYTHONPATH=src python -m repro_torch.examples.quickstart --workers 4
"""
import argparse
import time

from repro_torch.configs import get_config
from repro_torch.core import render, tcm_map
from repro_torch.core.baselines import loma_like, timeloop_like
from repro_torch.core.presets import gpt3_einsums, small_matmul_suite, tpu_v4i_like
from repro_torch.netmap import MappingCache, map_network


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--paper", action="store_true",
                    help="full GPT-3 6.7B shapes (minutes)")
    ap.add_argument("--workers", type=int, default=None,
                    help="search-engine worker processes (default: serial)")
    args = ap.parse_args()
    # the attention-score einsum of one GPT-3 decoder layer
    einsum = (gpt3_einsums() if args.paper else small_matmul_suite())["QK"]
    arch = tpu_v4i_like()

    t0 = time.time()
    best, stats = tcm_map(einsum, arch, objective="edp", workers=args.workers)
    dt = time.time() - t0

    print(f"searched {stats.log10_total:.0f} orders of magnitude of mappings"
          f" -> evaluated 10^{stats.log10_evaluated:.1f} in {dt:.1f}s")
    print(f"optimal EDP = {best.edp:.4g} (energy {best.energy:.4g} pJ, "
          f"latency {best.latency:.4g} s)\n")
    print("Optimal LoopTree:")
    print(render(best.mapping))

    # compare against a random-sampling baseline with the same eval budget
    rnd = timeloop_like(einsum, arch, budget_evals=2000, seed=0)
    loma = loma_like(einsum, arch, budget_evals=2000, seed=0)
    print(f"\nrandom-sampling baseline: {rnd.objective('edp') / best.edp:.2f}x"
          f" optimal;  LOMA-like: {loma.objective('edp') / best.edp:.2f}x")

    # whole-model mapping: every layer of a real config in one call, with
    # repeated shapes deduplicated, fusable cascades (QK->AV, gated FFN)
    # jointly mapped with their intermediates pinned on-chip, and results
    # persisted in .tcm_cache/ (re-running this script serves the mappings
    # from disk in milliseconds)
    report = map_network(get_config("qwen1_5_0_5b"), arch, mode="decode",
                         batch=2, seq=128, cache=MappingCache(),
                         workers=args.workers)
    print(f"\nwhole-model mapping ({report.config}): "
          f"{len(report.rows)} layer ops -> {len(report.unique)} searches "
          f"+ {len(report.fused)} fused groups, "
          f"network EDP {report.total_edp:.4g} pJ*s "
          f"(cache hit rate {report.cache_hit_rate:.0%})")
    for f in report.fused:
        if f.edp_delta is not None:
            print(f"  fused {f.ops}: group EDP {f.fused_edp:.4g} vs "
                  f"{f.unfused_edp:.4g} independent "
                  f"({'adopted' if f.adopted else 'fell back'}, "
                  f"saving {100 * f.edp_delta / f.unfused_edp:.0f}%)")


if __name__ == "__main__":
    main()
