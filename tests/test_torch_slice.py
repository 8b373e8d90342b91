"""The whole slice on the CPU at smoke size, against the reference path,
plus the port's package rules (no JAX, no ``repro`` import; CUDA or
nothing unless the CPU is asked for)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import attention_ref as ref_attention
from repro_torch.configs import get_config
from repro_torch.measure import main_path_rows, run_model
from repro_torch.serve_map import MappingService
from repro_torch.serve_map.measure import (measure_flash_attention,
                                           measure_matmul)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SEQ = 128  # the Pallas reference kernel needs Sq, Sk divisible by 128


def _j(t: torch.Tensor):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("mode,batch", [("prefill", 1), ("decode", 8)])
def test_slice_matches_reference_path(mode, batch):
    """Every planned matmul shape of the smoke qwen config through the
    port's ops equals the reference's TCM-tiled Pallas matmul (interpret
    mode); the attention equals the Pallas kernel at prefill and the
    oracle at decode (the Pallas kernel cannot take Sq = 1)."""
    cfg = get_config("qwen1_5_0_5b", smoke=True)
    calls, attn = run_model(cfg, mode, batch, SEQ, dtype=torch.float32,
                            device="cpu", seed=7)
    assert {op for c in calls for op in c.ops} >= {"head.lm_head",
                                                   "L0.q_proj", "L1.ffn_down"}
    for c in calls:
        want = ref_ops.tcm_matmul(*(_j(x) for x in c.inputs), interpret=True)
        np.testing.assert_allclose(c.out.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=str(c.ops))
    q, k, v = (_j(x) for x in attn.inputs)
    if mode == "prefill":
        want = ref_ops.flash_attention_op(q, k, v, causal=True,
                                          interpret=True)
    else:
        want = ref_attention(q, k, v, causal=False)
    np.testing.assert_allclose(attn.out.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_measure_rows_on_cpu(tmp_path):
    with MappingService(cache_root=tmp_path, background_warm=False) as svc:
        mm = measure_matmul(svc, 128, 64, 192, dtype=torch.float32,
                            repeats=1, device="cpu")
        fa = measure_flash_attention(svc, 1, 2, 8, 64, 32, repeats=1,
                                     device="cpu")
    keys = {"kernel", "shape", "tiles", "default_tiles", "map_source",
            "map_latency_ms", "gap_bound", "measured_s", "default_s",
            "speedup_vs_default", "modeled_s", "measured_vs_modeled",
            "device"}
    assert set(mm) == set(fa) == keys
    assert mm["device"] == fa["device"] == "cpu"


def test_main_path_rows_time_the_driven_calls():
    """The rows of a driven main path are ``measure``'s own rows, one per
    call in order, on each call's tiles and modeled latency."""
    calls, attn = run_model(get_config("qwen1_5_0_5b", smoke=True), "decode",
                            8, SEQ, dtype=torch.float32, device="cpu")
    rows = main_path_rows(calls, attn, repeats=1)
    assert [r["kernel"] for r in rows] == (["matmul"] * len(calls)
                                           + ["flash_attention"])
    for c, r in zip(calls + [attn], rows):
        assert tuple(r["tiles"]) == tuple(c.tiles)
        assert r["modeled_s"] == c.modeled_s
        assert r["map_latency_ms"] == c.t_map * 1e3 >= 0
        assert r["measured_s"] > 0 and r["default_s"] > 0
    assert [tuple(r["shape"]) for r in rows[:-1]] == [c.shape for c in calls]


def test_measure_needs_cuda_unless_cpu_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    with MappingService(cache_root=tmp_path, background_warm=False) as svc:
        with pytest.raises(RuntimeError, match="CUDA"):
            measure_matmul(svc, 64, 64, 64)
        with pytest.raises(RuntimeError, match="CUDA"):
            measure_flash_attention(svc)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_model(get_config("qwen1_5_0_5b", smoke=True))


def test_port_imports_with_jax_and_repro_blocked():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    assert {"repro_torch.distributed.sharding", "repro_torch.models.layers",
            "repro_torch.models.ssm", "repro_torch.models.rglru",
            "repro_torch.models.lm", "repro_torch.models.weights",
            "repro_torch.serving.engine",
            "repro_torch.launch.serve", "repro_torch.data.pipeline",
            "repro_torch.optim.adamw", "repro_torch.training.step",
            "repro_torch.checkpoint.manager",
            "repro_torch.launch.train", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
            "repro_torch.distributed.compression",
            "repro_torch.examples.kernel_autotune",
            "repro_torch.examples.train_e2e",
            "repro_torch.examples.quickstart"} <= set(mods)
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_repro_import_in_port():
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 20
    scanned = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {"examples/__init__.py", "examples/kernel_autotune.py",
            "examples/train_e2e.py", "examples/quickstart.py",
            "distributed/sharding.py", "distributed/compression.py",
            "launch/mesh.py", "launch/dryrun.py",
            "launch/roofline.py"} <= scanned
    assert bad == []


# reference modules with no counterpart in the port, and why
NO_COUNTERPART = {
    # torch emits no HLO; the port's dry-run counts ops at dispatch
    # (launch/dryrun.py says so)
    "launch/hlo_parse.py",
}


def test_every_reference_module_has_a_port_counterpart():
    ref = ROOT / "src" / "repro"
    missing = sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py")
                     if not (PORT / p.relative_to(ref)).exists())
    assert missing == sorted(NO_COUNTERPART)
    assert "hlo_parse" in (PORT / "launch" / "dryrun.py").read_text()
