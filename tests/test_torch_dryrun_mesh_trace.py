"""The dry-run as rank 0 of a fake group, on the CPU: the 1x1 mesh against
one device, the collective bytes of ``dp`` against the gradient's, the
depths a serve cell is traced at over a mesh, and the CLI's ``--mesh pod``
cell read by the roofline.
"""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import Mesh, fake_group, make_production_mesh
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parents[1]
SMOKE = {"dense": "qwen1.5-0.5b", "moe": "phi3.5-moe-42b-a6.6b",
         "ssm": "mamba2-130m"}
CELLS = {"train": dryrun.Cell("train", 4, 16),
         "decode": dryrun.Cell("decode", 4, 17, 24)}


def _smoke(model: str, kind: str):
    cfg = get_config(SMOKE[model], smoke=True)
    return cfg if kind == "train" else cfg.scaled(param_dtype="bfloat16")


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("model", list(SMOKE))
def test_one_by_one_mesh_traces_as_one_device(model, kind):
    """On a 1x1 mesh under a fake group of one rank, every placement is
    ``Replicate``: the FLOPs and the arguments' bytes are the one-device
    trace's, and nothing is moved."""
    cfg, cell = _smoke(model, kind), CELLS[kind]
    one = dryrun.trace_step(cfg, cell, "cpu")
    mesh = dryrun.trace_step(cfg, cell, "cpu",
                             mesh=Mesh(("data", "model"), (1, 1)),
                             mode="tp")
    assert mesh["hlo"]["per_device_flops"] == \
        one["hlo"]["per_device_flops"] > 0
    assert mesh["memory_per_device"]["argument_bytes"] == \
        one["memory_per_device"]["argument_bytes"]
    assert mesh["hlo"]["collective_bytes"] == {}
    assert mesh["hlo"]["total_collective_bytes"] == 0


@pytest.mark.parametrize("n", [2, 4])
def test_dp_all_reduces_the_f32_gradient_and_the_loss(n):
    """``dp`` on (n, 1): every parameter is whole on every rank, so the
    step's only collective is the all-reduce of each f32 gradient and of
    the loss's two sums (its tokens' losses and their count)."""
    cfg = _smoke("dense", "train")
    got = dryrun.trace_step(cfg, dryrun.Cell("train", 2 * n, 16), "cpu",
                            mesh=Mesh(("data", "model"), (n, 1)), mode="dp")
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    grad_bytes = sum(4 * t.numel() for t in lm.tree_leaves(params))
    assert got["hlo"]["collective_bytes"] == {
        "all-reduce": float(grad_bytes + 2 * 4)}


def test_dp_rank_holds_the_logits_of_its_rows_only():
    """``dp`` splits the rows over 'model' too, where the inputs come
    split over ('pod', 'data') only: the labels follow the logits' rows,
    and the gold logits are gathered on each rank's rows.  (At the DTensor
    level the gather's backward made zeros of the whole batch's logits on
    every rank: 727 GB a device at qwen1.5-0.5b's train_4k on the pod
    mesh.)  Each rank's temporaries on (4, 4) stay within 1% of one
    device's for one row."""
    cfg = get_config("qwen1.5-0.5b", smoke=True).scaled(vocab=32768,
                                                         n_layers=1)
    one = dryrun.trace_step(cfg, dryrun.Cell("train", 1, 256), "cpu")
    mesh = dryrun.trace_step(cfg, dryrun.Cell("train", 16, 256), "cpu",
                             mesh=Mesh(("data", "model"), (4, 4)),
                             mode="dp")
    want = one["memory_per_device"]["temp_bytes"]
    assert mesh["memory_per_device"]["temp_bytes"] <= 1.01 * want


def test_moe_experts_run_with_their_embed_split_over_data():
    """``tp_fsdp`` on (4, 1) keeps the smoke MoE's 2 layers whole and
    splits 'embed' over 'data' instead (the reference's dry-run layout,
    ``strict`` off): each rank computes its experts with their 'embed' dim
    gathered (an all-gather of the expert weights) and their gradient
    comes back whole, cut to its shard without a sum."""
    cfg = get_config("phi3.5-moe-42b-a6.6b", smoke=True)
    got = dryrun.trace_step(cfg, CELLS["train"], "cpu",
                            mesh=Mesh(("data", "model"), (4, 1)),
                            mode="tp_fsdp")
    assert got["hlo"]["per_device_flops"] > 0
    assert got["hlo"]["collective_bytes"]["all-gather"] > 0
    assert "broadcast" not in got["hlo"]["collective_bytes"]  # layers whole


@pytest.mark.parametrize("arch,mesh,mode,depths", [
    ("qwen1.5-0.5b", None, "tp", (2, 3)),
    ("qwen1.5-0.5b", "pod", "tp_fsdp", (2, 3)),  # 24 over data 16: whole
    ("qwen1.5-0.5b", "multipod", "tp_fsdp", (2, 4)),  # 24 over 'pod' only
    ("qwen1.5-0.5b", "pod", "dp", (2, 3)),
    ("minitron-8b", "pod", "tp_fsdp", None),  # 32 over 16: no two below
    ("minitron-8b", "multipod", "tp_fsdp", None),
    ("yi-34b", "pod", "tp_fsdp", (2, 3)),  # 60 over 16: whole
    ("yi-34b", "multipod", "tp_fsdp", (2, 4)),  # 60 over 'pod'
    ("mamba2-130m", "pod", "tp_fsdp", (2, 3)),
    ("phi3.5-moe-42b-a6.6b", "pod", "tp_ep", (2, 3)),
    ("phi3.5-moe-42b-a6.6b", "multipod", "tp_fsdp", None),  # 32 over 32
])
def test_fit_depths_keep_the_full_depths_layout(arch, mesh, mode, depths):
    cfg = get_config(arch)
    m = None if mesh is None else make_production_mesh(
        multi_pod=mesh == "multipod")
    assert dryrun.fit_depths(cfg, m, mode) == depths


@pytest.mark.parametrize("shape,layers", [((2, 1), 8), ((4, 1), 12)])
def test_depth_extrapolation_over_a_mesh_equals_a_full_trace(shape, layers):
    """Layers split 2 and 4 ways (``tp_fsdp``): the serve cells traced at
    two depths of the same layout and extrapolated give every count of
    the full-depth trace."""
    cfg = _smoke("dense", "decode").scaled(n_layers=layers)
    mesh = Mesh(("data", "model"), shape)
    n = shape[0]
    for cell in (dryrun.Cell("prefill", 4, 16, 24), CELLS["decode"]):
        fit = dryrun.trace_cell(cfg, cell, "cpu", mesh=mesh, mode="tp_fsdp")
        full = dryrun.trace_step(cfg, cell, "cpu", mesh=mesh,
                                 mode="tp_fsdp")
        assert fit["traced_layers"] == [n, 2 * n]
        assert fit["memory_per_device"] == full["memory_per_device"]
        assert fit["cost_analysis"] == full["cost_analysis"]
        for k in ("per_device_flops", "per_device_bytes", "collective_bytes",
                  "total_collective_bytes", "ops"):
            assert fit["hlo"][k] == full["hlo"][k], k


def _reference_run_cell_keys() -> set:
    """The keys the reference's ``run_cell`` writes, from its source."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_cell")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) and isinstance(
                node.value, ast.Name) and node.value.id == "result" and \
                isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
        if isinstance(node, ast.Assign) and any(
                isinstance(t, (ast.Name, ast.Subscript)) and (
                    getattr(t, "id", None) == "result" or getattr(
                        getattr(t, "value", None), "id", None) == "result")
                for t in node.targets) and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys
                     if isinstance(k, ast.Constant)}
    return keys


def test_dryrun_cli_writes_a_pod_cell(tmp_path):
    """``--mesh pod``: rank 0 of the 16x16 mesh in the reference's serve
    mode for the arch (its ``dp`` falls back to ``tp_fsdp``), in the
    reference's file and keys (``ops``/``trace_s`` in place of
    ``hlo_chars``/``parse_s``), read by the roofline with its collective
    term."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", "mamba2-130m", "--shape", "decode_32k",
           "--mesh", "pod", "--device", "cpu", "--out", str(tmp_path)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-1500:]
    out = list(tmp_path.glob("*.json"))
    assert [p.name for p in out] == ["mamba2-130m__decode_32k__pod.json"]
    d = json.loads(out[0].read_text())
    assert "error" not in d, d.get("error")
    keys = set(d) | set(d["memory_per_device"]) | set(d["hlo"]) | set(
        d["cost_analysis"])
    assert _reference_run_cell_keys() - keys == {"hlo_chars", "parse_s"}
    assert (d["mesh"], d["n_devices"], d["mode"]) == ("pod_16x16", 256,
                                                      "tp_fsdp")
    assert d["traced_layers"] == [2, 3]
    assert d["hlo"]["total_collective_bytes"] == sum(
        d["hlo"]["collective_bytes"].values()) > 0
    row = roofline.analyze_cell(out[0])
    assert row["n_devices"] == 256 and row["mesh"] == "pod_16x16"
    assert row["collective_s"] > 0 and row["compute_s"] > 0


def test_fake_group_refuses_a_live_group():
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="a process group is up"):
            with fake_group(Mesh(("data", "model"), (2, 1))):
                pass
    finally:
        dist.destroy_process_group()
    with fake_group(Mesh(("pod", "data", "model"), (2, 16, 16))):
        assert dist.get_world_size() == 512 and dist.get_rank() == 0
    assert not dist.is_initialized()
