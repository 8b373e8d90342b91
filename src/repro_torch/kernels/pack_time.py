"""Time ``criteria.pack`` on the host's CPU: every ``CriteriaKernel`` that the
fused QK -> AV search meets on the TPU-v4i preset (``tests/test_fusion.py``'s
pair), each packed for the CPU, in a few rounds; prints the median, the 10th
and 90th percentiles and the mean of each round in us.

    PYTHONPATH=src python src/repro_torch/kernels/pack_time.py [--rounds 3]

The imports are absolute, so the same file times another checkout's
``pack`` when that checkout's ``src`` is on ``PYTHONPATH`` instead.
"""
import argparse
import statistics
import time

from repro_torch.core import symbolic
from repro_torch.core.einsum import batched_matmul
from repro_torch.core.fusion import FusedWorkload, GroupEdge
from repro_torch.core.mapper import tcm_map_group
from repro_torch.core.presets import tpu_v4i_like
from repro_torch.kernels import criteria


def fused_pair_kernels() -> list:
    """The kernels the fused QK -> AV search calls, each once."""
    seen = {}
    call = symbolic.CriteriaKernel.__call__

    def record(self, cols):
        seen[id(self)] = self
        return call(self, cols)

    pair = FusedWorkload("qk+av", (batched_matmul("qk", 8, 4, 32, 64),
                                   batched_matmul("av", 8, 4, 64, 32)),
                         (GroupEdge(0, 1, "Z", "A"),))
    symbolic.CriteriaKernel.__call__ = record
    try:
        tcm_map_group(pair, tpu_v4i_like())
    finally:
        symbolic.CriteriaKernel.__call__ = call
    return list(seen.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="time criteria.pack on the CPU")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    kernels = fused_pair_kernels()
    for _ in range(args.rounds):
        us = []
        for kernel in kernels:
            t0 = time.perf_counter()
            criteria.pack(kernel, "cpu")
            us.append((time.perf_counter() - t0) * 1e6)
        dec = statistics.quantiles(us, n=10)
        print(f"pack over {len(us)} kernels: median "
              f"{statistics.median(us):.1f} us, p10 {dec[0]:.1f}, p90 "
              f"{dec[-1]:.1f}, mean {statistics.fmean(us):.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
