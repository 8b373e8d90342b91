"""Roofline analysis over the dry-run results, on one NVIDIA H100.

Port of ``repro.launch.roofline``: the config arithmetic (``n_params``,
``model_flops``, ``analytic_hbm_bytes``) and ``analyze_cell`` are the
reference's unchanged, so either package's ``roofline`` reads either
package's dry-run JSON.  The hardware constants are the card's, the ones
``chip_smoke.py``'s bounds use; the reference's TPU v5e constants (197
TFLOP/s, 819 GB/s, ~50 GB/s ICI) are not carried over.

Hardware constants (NVIDIA H100 SXM data sheet, dense, 700 W):
  peak bf16  = 989 TFLOP/s
  HBM bw     = 3.35 TB/s
  NVLink     = 450 GB/s per direction (NVLink 4, 18 links)

Terms (per device):
  compute_s    = FLOPs_per_device / 989e12
  memory_s     = analytic HBM bytes_per_device / 3.35e12
  collective_s = collective_bytes_per_device / 450e9   (0 on one device;
                 the port's pod and multipod cells count each collective's
                 operand bytes on rank 0, ``launch.dryrun``)

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) for train cells; for
prefill 2*N*D + attention; decode per-token.  The ratio MODEL_FLOPS /
(traced FLOPs * devices) exposes remat/causal-waste/padding overheads.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline \
      [--dir experiments/dryrun] [--emit-md experiments/roofline.md]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..configs import ALIASES, SHAPES, get_config

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9


def n_params(cfg) -> float:
    """Total (and active) parameter count estimate from the config."""
    d = cfg.d_model
    if cfg.family == "ssm":
        d_in = cfg.ssm_heads * cfg.ssm_head_dim
        per_layer = d * (2 * d_in + 2 * cfg.ssm_state + cfg.ssm_heads) \
            + d_in * d
        total = cfg.n_layers * per_layer + cfg.vocab * d
        return total, total
    attn = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
    mlp = 3 * d * cfg.d_ff
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    if cfg.n_experts:
        total = cfg.n_layers * (attn + cfg.n_experts * mlp
                                + d * cfg.n_experts) + emb
        active = cfg.n_layers * (attn + cfg.top_k * mlp) + emb
        return total, active
    if cfg.family == "hybrid":
        W = cfg.rglru_dim or d
        rec = 2 * d * W + 2 * W * W
        pat = cfg.block_pattern or ("rglru", "rglru", "wattn")
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if pat[i % len(pat)] == "wattn")
        total = n_attn * (attn + mlp) + (cfg.n_layers - n_attn) * (rec + mlp) \
            + emb
        return total, total
    layers = cfg.enc_layers + cfg.dec_layers if cfg.is_encdec else cfg.n_layers
    xattn = attn if cfg.is_encdec else 0
    total = layers * (attn + mlp) + cfg.dec_layers * xattn + emb
    return total, total


def _attn_layers_and_extent(cfg, S):
    """(#attention layers, effective attended length per query)."""
    if not cfg.n_heads:
        return 0, 0
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rglru", "rglru", "wattn")
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if pat[i % len(pat)] == "wattn")
        return n_attn, min(cfg.window or S, S)
    L = cfg.enc_layers + 2 * cfg.dec_layers if cfg.is_encdec else cfg.n_layers
    return L, S


def model_flops(cfg, cell) -> float:
    """Useful-math FLOPs for the whole cell (global, forward[+backward])."""
    total, active = n_params(cfg)
    B, S = cell.global_batch, cell.seq_len
    tokens = B * S
    n_attn, extent = _attn_layers_and_extent(cfg, S)
    if cell.kind == "train":
        base = 6.0 * active * tokens
        # attention quadratic (causal => /2 within the window extent)
        base += 12.0 * n_attn * cfg.q_dim * extent * tokens / 2
        return base
    if cell.kind == "prefill":
        base = 2.0 * active * tokens
        base += 4.0 * n_attn * cfg.q_dim * extent * tokens / 2
        return base
    # decode: one token per sequence; enc-dec runs the decoder only
    if cfg.is_encdec:
        dec_total = active * cfg.dec_layers / max(
            cfg.enc_layers + cfg.dec_layers, 1)
        base = 2.0 * dec_total * B
        base += 4.0 * 2 * cfg.dec_layers * cfg.q_dim * S * B  # self + cross
        return base
    base = 2.0 * active * B
    base += 4.0 * n_attn * cfg.q_dim * extent * B
    return base


def analytic_hbm_bytes(cfg, cell, microbatches: int = 1) -> float:
    """First-principles per-step GLOBAL HBM traffic (bytes).

    The HLO parser's byte count is an upper bound that charges every
    materialized buffer — including flash-attention score blocks that are
    VMEM-resident on the TPU target (our Pallas kernel IS that tiling), so
    we model HBM traffic analytically: parameter IO, optimizer state,
    activation checkpoints (scan carries), logits, and KV-cache traffic.
    """
    total, active = n_params(cfg)
    B, S = cell.global_batch, cell.seq_len
    tokens = B * S
    d = cfg.d_model
    L = cfg.n_layers
    pbytes = 4 if cell.kind == "train" else 2  # f32 train, bf16 serve
    P = total * pbytes
    act_unit = tokens * d * 2  # one residual-stream tensor, bf16
    if cell.kind == "train":
        param_io = 3 * P  # fwd read + bwd-recompute read + grad write
        opt_io = 4 * total * 4  # adam m,v read+write (f32)
        carries = 2 * L * act_unit  # per-layer checkpoint write + read
        block_io = 6 * L * act_unit / max(microbatches, 1) * microbatches
        logits = 2 * tokens * cfg.vocab * 4
        return param_io + opt_io + carries + block_io + logits
    if cell.kind == "prefill":
        kv = 2 * L * tokens * cfg.kv_dim * 2 if cfg.n_heads else \
            L * B * (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state) * 4
        return P + 4 * L * act_unit + kv + B * cfg.vocab * 4
    # decode: every param read once per token step + full KV/state read
    if cfg.n_heads:
        win = cfg.window if cfg.family == "hybrid" else 0
        pat = cfg.block_pattern or ()
        if cfg.family == "hybrid" and pat:
            n_attn = sum(1 for i in range(L) if pat[i % len(pat)] == "wattn")
            kv_len = min(win or S, S)
            kv = 2 * n_attn * B * kv_len * cfg.kv_dim * 2
            kv += (L - n_attn) * B * (cfg.rglru_dim or d) * 4 * 2
        else:
            kv = 2 * L * B * S * cfg.kv_dim * 2
            if cfg.is_encdec:
                kv *= 2  # self + cross caches
    else:
        kv = L * B * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4 * 2
    return P + kv + B * cfg.vocab * 4


def analyze_cell(path: Path) -> dict:
    d = json.loads(path.read_text())
    if "error" in d:
        return {"arch": d["arch"], "shape": d["shape"], "mesh": d["mesh"],
                "error": d["error"][:120]}
    cfg = get_config(d["arch"])
    cell = SHAPES[d["shape"]]
    n_dev = d["n_devices"]
    f_dev = d["hlo"]["per_device_flops"]
    b_dev_upper = d["hlo"]["per_device_bytes"]
    c_dev = d["hlo"]["total_collective_bytes"]
    compute_s = f_dev / PEAK_FLOPS
    b_dev = analytic_hbm_bytes(cfg, cell,
                               d.get("microbatches", 1)) / n_dev
    memory_s = b_dev / HBM_BW
    memory_s_upper = b_dev_upper / HBM_BW
    coll_s = c_dev / NVLINK_BW
    dom = max((compute_s, "compute"), (memory_s, "memory"),
              (coll_s, "collective"))[1]
    mf = model_flops(cfg, cell)
    ratio = mf / max(f_dev * n_dev, 1.0)
    peak_gb = d["memory_per_device"]["peak_live_bytes"] / 2 ** 30
    return {
        "arch": d["arch"], "shape": d["shape"], "mesh": d["mesh"],
        "n_devices": n_dev,
        "compute_s": compute_s, "memory_s": memory_s,
        "memory_s_hlo_upper": memory_s_upper,
        "collective_s": coll_s, "dominant": dom,
        "model_flops": mf, "hlo_flops_global": f_dev * n_dev,
        "useful_ratio": ratio,
        "roofline_fraction": compute_s / max(compute_s, memory_s, coll_s),
        "peak_hbm_gb": peak_gb,
        "microbatches": d.get("microbatches", 1),
        "collectives": d["hlo"]["collective_bytes"],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--emit-md", default="experiments/roofline.md")
    args = ap.parse_args()

    rows = []
    for p in sorted(Path(args.dir).glob("*.json")):
        rows.append(analyze_cell(p))

    md = ["| arch | shape | mesh | compute_s | memory_s | collective_s | "
          "dominant | useful-FLOP ratio | peak HBM (GiB) |",
          "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if "error" in r:
            md.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                      f"ERROR: {r['error']} | | | | | |")
            continue
        md.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.3g} | {r['memory_s']:.3g} "
            f"| {r['collective_s']:.3g} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['peak_hbm_gb']:.1f} |")
    out = "\n".join(md)
    Path(args.emit_md).parent.mkdir(parents=True, exist_ok=True)
    Path(args.emit_md).write_text(out + "\n")
    print(out)
    with open(Path(args.emit_md).with_suffix(".json"), "w") as f:
        json.dump(rows, f, indent=2, default=str)


if __name__ == "__main__":
    main()
