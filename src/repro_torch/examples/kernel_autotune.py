"""TCM as a CUDA-kernel autotuner: the paper's mapper picks the shared-memory
tiling of the Hopper matmul kernel, and we validate the kernel against the
oracle (on the card; ``--device cpu`` runs the kernel's plain version).

  PYTHONPATH=src python -m repro_torch.examples.kernel_autotune [--device cpu]

Twin of the reference's ``examples/kernel_autotune.py``.  The tiles come
from the port's ``core.autotile.tcm_matmul_tiles``, which maps onto one
H100 SM (bf16: the ``wgmma`` kernel's register-file accumulator and its
shared-memory ring; f32: the SIMT kernel's one shared-memory level), so
they differ from the reference's TPU tiles by design.  In place of the
VMEM working set it reports the ring's shared-memory footprint and
whether the kernel takes the tile (``kernel_takes``).  The reference's
``--workers`` is not taken: the port's tile search has no worker pool.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.autotile import (kernel_takes, ring_stages,
                                       smem_footprint, tcm_matmul_tiles)
from repro_torch.kernels.matmul import matmul_cuda
from repro_torch.kernels.ops import tcm_matmul
from repro_torch.kernels.ref import matmul_ref
from repro_torch.measure import resolve_device

F32_TOL = 1e-3  # the reference's (tests/test_kernels.py)


def held(out: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max |out - ref|, whether every element is within tolerance): f32
    within 1e-3, bf16 within one rounding step, 2^-7 |ref| + 4e-3."""
    bf16 = out.dtype == torch.bfloat16
    out, ref = out.float().cpu(), ref.float().cpu()
    err = (out - ref).abs()
    lim = 2 ** -7 * ref.abs() + 4e-3 if bf16 else F32_TOL
    return float(err.max()), bool((err <= lim).all())


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.kernel_autotune")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda: the CUDA kernel; "
                        "cpu: its plain version)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    for (M, K, N) in [(1024, 1024, 1024), (4096, 768, 3072)]:
        t0 = time.time()
        bm, bk, bn = tcm_matmul_tiles(M, K, N)
        dt = time.time() - t0
        print(f"matmul {M}x{K}x{N}: TCM tiles (bm,bk,bn)=({bm},{bk},{bn})"
              f"  [searched in {dt:.2f}s]")
        print(f"  SMEM ring {smem_footprint(bm, bk, bn, 2) / 2**10:.0f} KiB "
              f"({ring_stages(bm, bk, bn)} stages); kernel takes it: "
              f"{kernel_takes(bm, bk, bn, K, 2)}")

    # validate a small instance end to end, on both routes of the kernel
    M, K, N = 512, 384, 640
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32))
    launches = matmul_cuda.launches
    errs, ok = {}, True
    for dtype in (torch.bfloat16, torch.float32):
        ad, bd = a.to(dev, dtype), b.to(dev, dtype)
        tiles = tcm_matmul_tiles(M, K, N, word_bytes=ad.element_size())
        errs[dtype], good = held(tcm_matmul(ad, bd), matmul_ref(ad, bd))
        ok = ok and good
        print(f"{str(dtype)[6:]} {M}x{K}x{N} at TCM tile {tiles}: "
              f"max |err| = {errs[dtype]:.2e} ({'held' if good else 'FAIL'})")
    print(f"kernel launches: {matmul_cuda.launches - launches} on {dev}")
    print(f"kernel vs oracle max |err| = {errs[torch.float32]:.2e}  "
          f"({'OK' if ok else 'FAIL'})")
    return ok

if __name__ == "__main__":
    main()
