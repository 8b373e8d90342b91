"""Paper workloads and architectures (paper §VI-A).

Workloads: GPT-3 6.7B decoder-layer Einsums (Q, K, V, Z, QK, AV, FFA, FFB)
with batch 64 x 1024 tokens (65,536 total), and MobileNetV3 pointwise /
depthwise convolutions.  Architectures: a TPU-v4i-like datacenter accelerator
and an NVDLA-like edge accelerator, plus a TPU-v5e-like single-chip config
used by the Pallas autotuner (kernels/) and the sharding planner.

Energy/bandwidth constants are Accelergy-style public numbers (pJ/word,
words/s); absolute values differ from the authors' internal calibration but
all mapper comparisons are relative under the same model (see DESIGN.md).
"""
from __future__ import annotations

from typing import Dict, List

from .arch import Arch, ArchTemplate, MemLevel, SpatialFanout
from .einsum import Einsum, TensorSpec, batched_matmul, conv1d, depthwise_conv1d, matmul

# ---------------------------------------------------------------------------
# GPT-3 6.7B: d_model=4096, heads=32, d_head=128, d_ff=16384.
# Prefill batch 64 x 1024 tokens -> M = 65536 flattened tokens.
# ---------------------------------------------------------------------------

GPT3_D_MODEL = 4096
GPT3_HEADS = 32
GPT3_D_HEAD = 128
GPT3_D_FF = 16384
GPT3_TOKENS = 65536
GPT3_SEQ = 1024
GPT3_BH = 64 * GPT3_HEADS  # batch x heads for attention einsums


def gpt3_einsums(tokens: int = GPT3_TOKENS) -> Dict[str, Einsum]:
    """The eight Einsums of one GPT-3 decoder layer (paper labels)."""
    out: Dict[str, Einsum] = {}
    for name in ("Q", "K", "V"):
        out[name] = matmul(name, tokens, GPT3_D_MODEL, GPT3_D_MODEL)
    out["Z"] = matmul("Z", tokens, GPT3_D_MODEL, GPT3_D_MODEL)
    # attention: per (batch*head): QK_{m,n} = Q_{m,e} K_{n,e}
    out["QK"] = batched_matmul("QK", GPT3_BH, GPT3_SEQ, GPT3_D_HEAD, GPT3_SEQ)
    out["AV"] = batched_matmul("AV", GPT3_BH, GPT3_SEQ, GPT3_SEQ, GPT3_D_HEAD)
    out["FFA"] = matmul("FFA", tokens, GPT3_D_MODEL, GPT3_D_FF)
    out["FFB"] = matmul("FFB", tokens, GPT3_D_FF, GPT3_D_MODEL)
    return out


def mobilenetv3_einsums(batch: int = 64) -> Dict[str, Einsum]:
    """Representative MobileNetV3 pointwise (P) / depthwise (D) convs.

    Spatial dims are flattened to 1-D (P = H*W) — the mapper treats multi-dim
    sliding windows per-axis; one affine axis captures the halo/line-buffer
    behaviour the paper exercises.
    """
    out: Dict[str, Einsum] = {}
    # (P, C, Kc) from MobileNetV3-Large stages; D convs are 3x3 -> R=9 flat
    out["P0"] = conv1d("P0", P=56 * 56, R=1, C=16, Kc=64, Nb=batch)
    out["P1"] = conv1d("P1", P=28 * 28, R=1, C=72, Kc=24, Nb=batch)
    out["P2"] = conv1d("P2", P=14 * 14, R=1, C=120, Kc=40, Nb=batch)
    out["D0"] = depthwise_conv1d("D0", P=56 * 56, R=9, C=16, Nb=batch)
    out["D1"] = depthwise_conv1d("D1", P=28 * 28, R=9, C=72, Nb=batch)
    out["D2"] = depthwise_conv1d("D2", P=14 * 14, R=9, C=120, Nb=batch)
    return out


# ---------------------------------------------------------------------------
# TPU-v4i-like (paper §VI-A2): a 64 Mi-word GLB (= 128 MB at 2 B/word) + 4
# PEs, each with a 2 Mi-word LB (= 4 MB at 2 B/word) and a 128x128 MAC array
# with per-MAC weight registers.  The array multicasts inputs on one dim and
# reduces outputs on the other.
# Units: capacities in words (bf16, 2 B/word), energies pJ/word, bandwidths
# words/s.
#
# Every preset is expressed as an ArchTemplate instance: the *_template()
# accessor exposes the anchor for design-space sweeps (repro.dse), and the
# historical *_like() constructors are its no-override instantiation —
# bit-identical to the hand-written Arch values they replace (ratio-1
# capacity scaling is skipped, see ArchTemplate._scale_level).
# ---------------------------------------------------------------------------

def tpu_v4i_template(tensors=("A", "B", "Z")) -> ArchTemplate:
    A, B, Z = tensors
    return ArchTemplate(base=Arch(
        name="tpu-v4i-like",
        levels=(
            MemLevel("DRAM", float("inf"), 62.5, 62.5, 153e9),      # HBM
            # 64 Mi words = 128 MB at 2 B/word
            MemLevel("GLB", 64 * 2 ** 20, 6.0, 6.0, 400e9),
            # The per-PE local buffer is dedicated to input activations and
            # partial sums (weights stream to the weight-stationary array's
            # registers) — a user dataplacement constraint that pins this
            # level, matching the paper's |DP| = 16 for GPT-3 QK on the
            # TPU-like architecture.  2 Mi words = 4 MB at 2 B/word.
            MemLevel("LB", 2 * 2 ** 20, 1.5, 1.5, 800e9,
                     allowed_tensors=(A, Z), mandatory=True,
                     fixed_order=True),
            MemLevel("REG", 128 * 128, 0.15, 0.15, 940e12,
                     allowed_tensors=(B,), mandatory=True,
                     fixed_order=True),                              # weights
        ),
        fanouts=(
            # 4 PEs below the GLB: unconstrained dims
            SpatialFanout(above_level=1, dims=(4,)),
            # 128x128 MAC array below the LB: multicast inputs along one dim,
            # reduce outputs along the other
            SpatialFanout(above_level=2, dims=(128, 128),
                          multicast_tensor=(A, None),
                          reduce_tensor=(None, Z)),
        ),
        mac_energy=0.56,
        frequency=940e6,
    ))


def tpu_v4i_like(tensors=("A", "B", "Z")) -> Arch:
    return tpu_v4i_template(tensors).instantiate()


def nvdla_template(tensors=("A", "W", "Z")) -> ArchTemplate:
    """NVDLA-like edge accelerator anchor: a 32 Ki-word buffer (= 64 kB at
    2 B/word) + 32x192 MAC array that reuses (multicasts) inputs along the
    32 dim and reduces outputs along the 192 dim."""
    A, W, Z = tensors
    return ArchTemplate(base=Arch(
        name="nvdla-like",
        levels=(
            MemLevel("DRAM", float("inf"), 200.0, 200.0, 12.5e9),
            # 32 Ki words = 64 kB at 2 B/word
            MemLevel("BUF", 32 * 2 ** 10, 1.2, 1.2, 256e9),
        ),
        fanouts=(
            SpatialFanout(above_level=1, dims=(32, 192),
                          multicast_tensor=(A, None),
                          reduce_tensor=(None, Z)),
        ),
        mac_energy=0.3,
        frequency=1e9,
    ))


def nvdla_like(tensors=("A", "W", "Z")) -> Arch:
    return nvdla_template(tensors).instantiate()


def tpu_v5e_template(tensors=("A", "B", "Z")) -> ArchTemplate:
    """Single TPU-v5e-chip-like hierarchy for kernel autotiling:
    HBM -> VMEM (16 Mi words = 32 MB at 2 B/word) -> MXU (128x128).
    Used by kernels/ to pick BlockSpec tile shapes."""
    A, B, Z = tensors
    return ArchTemplate(base=Arch(
        name="tpu-v5e-like",
        levels=(
            MemLevel("HBM", float("inf"), 40.0, 40.0, 410e9),  # words/s (2B)
            MemLevel("VMEM", 16 * 2 ** 20, 1.0, 1.0, 5e12),
        ),
        fanouts=(
            SpatialFanout(above_level=1, dims=(128, 128),
                          multicast_tensor=(A, None),
                          reduce_tensor=(None, Z)),
        ),
        mac_energy=0.2,
        frequency=940e6,
    ))


def tpu_v5e_like(tensors=("A", "B", "Z")) -> Arch:
    return tpu_v5e_template(tensors).instantiate()


def small_matmul_suite() -> Dict[str, Einsum]:
    """CI-scale stand-ins for the paper workloads (same structure, smaller
    shapes) so the benchmark harness runs in seconds on one CPU core."""
    return {
        "Q": matmul("Q", 1024, 256, 256),
        "QK": batched_matmul("QK", 64, 256, 64, 256),
        "FFA": matmul("FFA", 1024, 256, 1024),
        "P0": conv1d("P0", P=784, R=1, C=16, Kc=64, Nb=4),
        "D0": depthwise_conv1d("D0", P=784, R=9, C=16, Nb=4),
    }
