"""The port's dry-run and roofline against the reference, on the CPU.

``launch.roofline``'s arithmetic is the reference's, bit for bit, and its
``analyze_cell`` differs only by the H100's constants; ``launch.dryrun``
runs the reference's cells on one device (the CLI twin of
``tests/test_dryrun_cli.py``), its fake trace equals the same step on real
tensors, and the depth extrapolation equals a full-depth trace.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` for 512 host
devices when imported, so its constants and ``input_specs`` are read from
its source here rather than imported.
"""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import roofline as ref_roof
from repro_torch.configs import ARCHS, SHAPES, cells_for, get_config
from repro_torch.launch import dryrun, roofline

ROOT = Path(__file__).resolve().parents[1]


def _reference_dryrun_names():
    """``VLM_PATCHES``, ``MODE_OVERRIDES``, ``DEFAULT_MICROBATCHES`` and
    ``input_specs`` of the reference's dry-run, from its source."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    keep = {"VLM_PATCHES", "MODE_OVERRIDES", "DEFAULT_MICROBATCHES",
            "input_specs"}
    nodes = [n for n in tree.body
             if (isinstance(n, ast.FunctionDef) and n.name in keep)
             or (isinstance(n, ast.Assign)
                 and {getattr(t, "id", None) for t in n.targets} & keep)]
    ns = {"jax": jax, "jnp": jnp, "ModelConfig": object}
    exec(compile(ast.Module(nodes, []), "dryrun.py", "exec"), ns)
    return ns


REF = _reference_dryrun_names()


# --------------------------------------------------------------------------
# roofline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_arithmetic_equals_reference(arch):
    cfg = get_config(arch)
    ref_cfg = ref_roof.get_config(arch)
    assert roofline.n_params(cfg) == ref_roof.n_params(ref_cfg)
    for shape in cells_for(cfg):
        cell = SHAPES[shape]
        ref_cell = ref_roof.SHAPES[shape]
        assert roofline._attn_layers_and_extent(cfg, cell.seq_len) == \
            ref_roof._attn_layers_and_extent(ref_cfg, cell.seq_len)
        assert roofline.model_flops(cfg, cell) == \
            ref_roof.model_flops(ref_cfg, ref_cell)
        for mb in (1, 2, 4):
            assert roofline.analytic_hbm_bytes(cfg, cell, mb) == \
                ref_roof.analytic_hbm_bytes(ref_cfg, ref_cell, mb)


def _reference_format_json(tmp_path, **over):
    d = {"arch": "yi-34b", "shape": "train_4k", "mesh": "pod_16x16",
         "n_devices": 256, "microbatches": 4,
         "memory_per_device": {"peak_live_bytes": 12 * 2 ** 30},
         "hlo": {"per_device_flops": 3.1e15, "per_device_bytes": 9.5e12,
                 "collective_bytes": {"all-gather": 4.0e10},
                 "total_collective_bytes": 4.0e10}}
    d.update(over)
    path = tmp_path / "cell.json"
    path.write_text(json.dumps(d))
    return path


def test_analyze_cell_differs_only_by_the_h100_constants(tmp_path):
    path = _reference_format_json(tmp_path)
    got, want = roofline.analyze_cell(path), ref_roof.analyze_cell(path)
    assert got["compute_s"] == pytest.approx(
        want["compute_s"] * 197e12 / 989e12, rel=1e-14)
    assert got["memory_s"] == pytest.approx(
        want["memory_s"] * 819e9 / 3.35e12, rel=1e-14)
    assert got["memory_s_hlo_upper"] == pytest.approx(
        want["memory_s_hlo_upper"] * 819e9 / 3.35e12, rel=1e-14)
    assert got["collective_s"] == pytest.approx(
        want["collective_s"] * 50e9 / 450e9, rel=1e-14)
    terms = {"compute": got["compute_s"], "memory": got["memory_s"],
             "collective": got["collective_s"]}
    assert got["dominant"] == max(terms, key=terms.get)
    same = {k for k in want if k not in (
        "compute_s", "memory_s", "memory_s_hlo_upper", "collective_s",
        "dominant", "roofline_fraction")}
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    err = _reference_format_json(tmp_path, error="boom " * 40)
    assert roofline.analyze_cell(err) == ref_roof.analyze_cell(err)


def test_roofline_cli_reads_a_dryrun_dir(tmp_path, monkeypatch):
    d = tmp_path / "dryrun"
    d.mkdir()
    _reference_format_json(d)
    md = tmp_path / "roofline.md"
    monkeypatch.setattr(sys, "argv", ["roofline", "--dir", str(d),
                                      "--emit-md", str(md)])
    roofline.main()
    assert "| yi-34b | train_4k | pod_16x16 |" in md.read_text()
    assert len(json.loads(md.with_suffix(".json").read_text())) == 1


# --------------------------------------------------------------------------
# dry-run
# --------------------------------------------------------------------------

def test_dryrun_tables_equal_reference():
    assert dryrun.VLM_PATCHES == REF["VLM_PATCHES"]
    assert dryrun.MODE_OVERRIDES == REF["MODE_OVERRIDES"]
    assert dryrun.DEFAULT_MICROBATCHES == REF["DEFAULT_MICROBATCHES"]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    """The reference's input shapes for every cell; token ids are int64
    where the reference's are int32."""
    cfg = get_config(arch)
    for shape in SHAPES:
        got = dryrun.input_specs(cfg, SHAPES[shape])
        want = REF["input_specs"](cfg, SHAPES[shape])
        assert list(got) == list(want)
        for k, spec in got.items():
            assert spec.shape == want[k].shape
            assert (spec.dtype, want[k].dtype) in (
                (torch.int64, jnp.int32), (torch.float32, jnp.float32))


def test_dryrun_cell_traces(tmp_path):
    """Twin of ``tests/test_dryrun_cli.py``: one real cell through the CLI,
    on the one-device mesh.  One device moves no collective bytes, where
    the reference's 256 devices must move some."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", "mamba2-130m", "--shape", "decode_32k",
           "--mesh", "one", "--device", "cpu", "--out", str(tmp_path)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-1500:]
    out = list(tmp_path.glob("*.json"))
    assert [p.name for p in out] == ["mamba2-130m__decode_32k__one.json"]
    d = json.loads(out[0].read_text())
    assert "error" not in d, d.get("error")
    assert d["n_devices"] == 1
    assert d["mode"] == "tp_fsdp"  # MODE_OVERRIDES' dp is train-only
    assert d["memory_per_device"]["peak_live_bytes"] < 80 * 2 ** 30
    assert d["hlo"]["per_device_flops"] > 0
    assert d["hlo"]["total_collective_bytes"] == 0
    assert d["traced_layers"] == [2, 3]
    row = roofline.analyze_cell(out[0])
    assert row["collective_s"] == 0 and row["compute_s"] > 0


def test_dryrun_cli_needs_a_card_unless_asked_for_the_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.main(["--arch", "mamba2-130m", "--device", "cuda"])


def test_dryrun_records_a_failing_cell(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise ValueError("cannot trace")
    monkeypatch.setattr(dryrun, "run_cell", boom)
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k",
                 "--device", "cpu", "--out", str(tmp_path)])
    d = json.loads((tmp_path / "qwen1.5-0.5b__train_4k__one.json")
                   .read_text())
    assert d["error"] == "cannot trace" and d["mesh"] == "one"
    assert "cannot trace" in roofline.analyze_cell(
        tmp_path / "qwen1.5-0.5b__train_4k__one.json")["error"]


STEPS = [dryrun.Cell("train", 2, 64), dryrun.Cell("prefill", 2, 64, 80),
         dryrun.Cell("decode", 2, 65, 80)]


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "mamba2_130m",
                                  "phi3_5_moe_42b", "recurrentgemma_2b",
                                  "seamless_m4t_medium"])
def test_fake_trace_equals_the_real_run(arch):
    """A smoke config's train step (remat, AdamW), prefill and decode
    step: the fake trace and the same step on real CPU tensors give equal
    FLOPs (and equal to ``FlopCounterMode`` over the real run) and equal
    tracked memory."""
    cfg = get_config(arch, smoke=True).scaled(remat=True)
    for cell in STEPS:
        c = cfg if cell.kind == "train" else cfg.scaled(
            param_dtype="bfloat16")
        fake = dryrun.trace_step(c, cell, "cpu")
        step, args = dryrun.make_inputs(c, cell, torch.device("cpu"))
        mt = MemTracker()
        mt.track_external(*dryrun._tensors(args))
        with mt, FlopCounterMode(display=False) as fc:
            real = dryrun.count(step, args)
        assert fake["hlo"]["per_device_flops"] == \
            real["hlo"]["per_device_flops"] == fc.get_total_flops() > 0
        assert fake["memory_per_device"] == real["memory_per_device"]
        assert real["memory_per_device"]["peak_live_bytes"] == max(
            d["Total"] for d in mt.get_tracker_snapshot("peak").values())
        mem = fake["memory_per_device"]
        assert mem["peak_live_bytes"] == mem["argument_bytes"] + \
            mem["temp_bytes"]


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "mamba2_130m",
                                  "phi3_5_moe_42b"])
def test_depth_extrapolation_equals_a_full_trace(arch):
    """Serve cells of a one-kind stack are traced at 2 and 3 layers and
    extrapolated; at 5 layers every count equals the full trace's."""
    S = 64
    cfg = get_config(arch, smoke=True).scaled(n_layers=5,
                                              param_dtype="bfloat16")
    for cell in (dryrun.Cell("prefill", 2, S),
                 dryrun.Cell("decode", 2, S + 1, S + 16)):
        fit = dryrun.trace_cell(cfg, cell, "cpu")
        full = dryrun.trace_step(cfg, cell, "cpu")
        assert fit["traced_layers"] == [2, 3]
        assert fit["memory_per_device"] == full["memory_per_device"]
        assert fit["cost_analysis"] == full["cost_analysis"]
        for k in ("per_device_flops", "per_device_bytes", "ops"):
            assert fit["hlo"][k] == full["hlo"][k]


def test_train_and_mixed_stacks_trace_at_full_depth():
    cell = dryrun.Cell("train", 2, 64)
    cfg = get_config("qwen1_5_0_5b", smoke=True).scaled(n_layers=4)
    assert dryrun.trace_cell(cfg, cell, "cpu")["traced_layers"] == [4]
    cfg = get_config("recurrentgemma_2b", smoke=True)
    assert dryrun.trace_cell(cfg, dryrun.Cell("prefill", 2, 64), "cpu")[
        "traced_layers"] == [cfg.n_layers]
