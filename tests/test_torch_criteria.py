"""The mapper's criteria route (``TCM_JIT``, ``set_jit``) on the CPU.

``repro_torch.kernels.criteria.criteria_plain`` is held bit for bit against
numpy's packed evaluation (``CriteriaKernel.__call__``) on kernels that
real searches meet, and within 1e-10 of each criterion's largest |term|
against the reference's own route (a ``jax.jit`` in f64, whose sum may
reorder terms).  The port's search with ``set_jit(True, device="cpu")``
equals the search with the switch off, bit for bit; the reference's search
with its jit on reaches the same optimum.  With ``TCM_JIT=1`` and no card
the route raises before numpy runs; with the switch off the mapper loads no
torch.  The kernel against this plain version is in
``tests/test_torch_kernels_cuda.py`` (on the card).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core import fusion as ref_fusion
from repro.core import mapper as ref_mapper
from repro.core import symbolic as ref_symbolic
from repro.core.arch import Arch, MemLevel
from repro.core.presets import tpu_v4i_like
from repro_torch.core import fusion as port_fusion
from repro_torch.core import mapper as port_mapper
from repro_torch.core import presets as port_presets
from repro_torch.core import symbolic
from repro_torch.core.search import clear_search_caches
from repro_torch.kernels import criteria as C

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
# the reference's jit against the plain version: f64 sums of the same
# terms in another order differ by a few ulps of the largest term
JAX_RTOL = 1e-10
# the reference's search with its jit on against numpy's (its pruning may
# decide on last-bit differences; the optimum's value may not move)
SEARCH_RTOL = 1e-9


def _toy_arch():
    """Two levels (as ``tests/test_bruteforce.py``'s toy arch): a search of
    ~80 kernel calls, which the reference's jit compiles one by one."""
    return Arch("a", (MemLevel("DRAM", float("inf"), 100, 100, 1e8),
                      MemLevel("GLB", 16, 1, 1, 1e9)), mac_energy=0.5)


def _attention_pair(core, fusion):
    """``tests/test_fusion.py``'s QK -> AV pair in either package."""
    qk = core.batched_matmul("qk", 8, 4, 32, 64)
    av = core.batched_matmul("av", 8, 4, 64, 32)
    return fusion.FusedWorkload("qk+av", (qk, av),
                                (fusion.GroupEdge(0, 1, "Z", "A"),))


def _record(search):
    """Every (reference kernel, columns) pair that ``search`` meets."""
    seen = []
    orig = ref_symbolic.CriteriaKernel.__call__

    def rec(self, cols):
        seen.append((self, cols.copy()))
        return orig(self, cols)

    ref_symbolic.CriteriaKernel.__call__ = rec
    try:
        search()
    finally:
        ref_symbolic.CriteriaKernel.__call__ = orig
    return seen


# hand-made criteria: exponents 2-5 and -1, an empty criterion, a
# constant term, a negative coefficient
CRITS = [((2.0, (("a", 1),)), (3.0, (("b", 2),))),
         (),
         ((1.5, ()), (0.5, (("a", 3), ("b", 1)))),
         ((1.0, (("c", 4),)), (-2.0, (("a", 5), ("c", 1))),
          (0.25, (("a", 1), ("b", 1), ("c", 2)))),
         ((1.0, (("b", -1),)), (4.0, (("a", 2), ("c", -1))))]
INDEX = {"a": 0, "b": 1, "c": 2}


def _synthetic():
    """``CRITS`` over integer columns of 1..1000 (every power exact) at
    n = 0, 1, 7 and 300."""
    kernel = ref_symbolic.CriteriaKernel(CRITS, INDEX)
    rng = np.random.default_rng(0)
    return [(kernel, rng.integers(1, 1001, size=(n, 4)).astype(np.float64))
            for n in (0, 1, 7, 300)]


@pytest.fixture(scope="module")
def recorded():
    arch = tpu_v4i_like()
    return {
        "fused_qk_av": _record(lambda: ref_mapper.tcm_map_group(
            _attention_pair(R, ref_fusion), arch)),
        "matmul_tpu_v4i": _record(
            lambda: R.tcm_map(R.matmul("mm", 64, 64, 64), arch)),
        "synthetic": _synthetic()}


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float64).view(np.uint64)


@pytest.mark.parametrize("source", ["fused_qk_av", "matmul_tpu_v4i",
                                    "synthetic"])
def test_plain_is_numpy_bit_for_bit(recorded, source):
    pairs = recorded[source]
    assert pairs
    for kernel, cols in pairs:
        want = kernel(cols)
        got = C.criteria_plain(C.pack(kernel, "cpu"), torch.from_numpy(cols))
        assert got.shape == want.shape
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_recorded_kernels_cover_the_cases(recorded):
    pairs = [p for ps in recorded.values() for p in ps]
    exps = {e for k, _ in pairs for _, e in k._factors}
    assert {1, 2, 3, 4, 5, -1} <= exps
    # the fused pair's own kernels reach exponents 2-5
    assert {2, 3, 4, 5} <= {e for k, _ in recorded["fused_qk_av"]
                            for _, e in k._factors}
    assert any(nt == 0 for k, _ in pairs for nt, _, _ in k._acc_groups)
    assert any(len(k._factors) in k._fid0 for k, _ in pairs)  # constant
    assert {0, 1} <= {cols.shape[0] for _, cols in pairs}


def _largest_term(kernel, cols):
    """|term| at its largest over each criterion's terms, per row."""
    F = kernel._factor_table(cols)
    T = kernel._coeff_flat[:, None] * F[kernel._fid0]
    for cut, fids in kernel._slots:
        T[cut:] *= F[fids]
    out = np.zeros((cols.shape[0], kernel.n_crits))
    for nt, js, idx in kernel._acc_groups:
        if nt:
            out[:, js] = np.abs(T[idx]).max(axis=1).T
    return out


def test_plain_matches_the_reference_jax_route(recorded):
    toy = _record(lambda: R.tcm_map(R.matmul("mm", 4, 8, 2), _toy_arch()))
    high = [p for p in recorded["fused_qk_av"]
            if max(e for _, e in p[0]._factors) >= 2][:8]
    pairs = recorded["synthetic"] + toy + high
    assert len(pairs) > 80
    was_on, x64 = ref_symbolic._JIT_ENABLED, jax.config.jax_enable_x64
    try:
        ref_symbolic.set_jit(True)
        for kernel, cols in pairs:
            want = kernel(cols)  # the reference's jax.jit route
            assert kernel._jit_call not in (None, False)
            got = C.criteria_plain(C.pack(kernel, "cpu"),
                                   torch.from_numpy(cols)).numpy()
            assert got.shape == want.shape
            tol = JAX_RTOL * _largest_term(kernel, cols)
            assert (np.abs(got - want) <= tol).all()
    finally:
        ref_symbolic.set_jit(was_on)
        jax.config.update("jax_enable_x64", x64)


def _stats(stats):
    return {k: v for k, v in dataclasses.asdict(stats).items()
            if not k.startswith("t_")}


SEARCHES = {
    "tcm_map": lambda: P.tcm_map(P.matmul("mm", 64, 64, 64),
                                 port_presets.tpu_v4i_like()),
    "tcm_map_group": lambda: port_mapper.tcm_map_group(
        _attention_pair(P, port_fusion), port_presets.tpu_v4i_like()),
}


@pytest.mark.parametrize("search", list(SEARCHES))
def test_search_with_the_route_on_the_cpu_is_bit_identical(search,
                                                           monkeypatch):
    calls = []
    evaluate = C.evaluate
    monkeypatch.setattr(C, "evaluate",
                        lambda c, cols: calls.append(c) or evaluate(c, cols))
    clear_search_caches()
    off, off_stats = SEARCHES[search]()
    assert not calls
    clear_search_caches()
    try:
        symbolic.set_jit(True, device="cpu")
        on, on_stats = SEARCHES[search]()
    finally:
        symbolic.set_jit(False)
        clear_search_caches()
    assert calls and all(c.device.type == "cpu" for c in calls)
    assert (on.energy, on.latency, on.edp) == (off.energy, off.latency,
                                               off.edp)
    assert on.mapping == off.mapping and repr(on.mapping) == repr(off.mapping)
    assert on_stats.n_expanded == off_stats.n_expanded
    assert _stats(on_stats) == _stats(off_stats)


def test_reference_search_with_its_jit_reaches_the_same_optimum():
    ein, arch = R.matmul("mm", 4, 8, 2), _toy_arch()
    off, _ = R.tcm_map(ein, arch)
    was_on, x64 = ref_symbolic._JIT_ENABLED, jax.config.jax_enable_x64
    try:
        ref_symbolic.set_jit(True)
        on, _ = R.tcm_map(ein, arch)
    finally:
        ref_symbolic.set_jit(was_on)
        jax.config.update("jax_enable_x64", x64)
    port, _ = P.tcm_map(P.einsum_from_dict(R.einsum_to_dict(ein)),
                        P.arch_from_dict(R.arch_to_dict(arch)))
    for got in (on, port):
        for key in ("energy", "latency", "edp"):
            assert abs(getattr(got, key) - getattr(off, key)) <= \
                SEARCH_RTOL * abs(getattr(off, key))


def _run(code, **env):
    env = {k: v for k, v in os.environ.items() if k != "TCM_JIT"} | env
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=dict(env, PYTHONPATH=str(SRC)),
                          timeout=120)


def test_tcm_jit_without_a_card_raises_before_numpy_runs():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    code = (
        "from repro_torch.core import symbolic, tcm_map, matmul\n"
        "from repro_torch.core.presets import tpu_v4i_like\n"
        "assert symbolic._JIT_ENABLED and symbolic._JIT_DEVICE == 'cuda'\n"
        "def numpy_ran(self, cols):\n"
        "    raise AssertionError('numpy ran')\n"
        "symbolic.CriteriaKernel._factor_table = numpy_ran\n"
        "tcm_map(matmul('mm', 8, 16, 4), tpu_v4i_like())\n")
    res = _run(code, TCM_JIT="1")
    assert res.returncode != 0
    assert "RuntimeError" in res.stderr and "CUDA card" in res.stderr
    assert "numpy ran" not in res.stderr


def test_set_jit_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    kernel, cols = _synthetic()[2]
    port = symbolic.CriteriaKernel(CRITS, INDEX)
    try:
        symbolic.set_jit(True)
        with pytest.raises(RuntimeError, match="CUDA card"):
            port(cols)
    finally:
        symbolic.set_jit(False)
    np.testing.assert_array_equal(_bits(port(cols)), _bits(kernel(cols)))


def test_switch_off_the_mapper_loads_no_torch():
    code = ("import sys\n"
            "from repro_torch.core import symbolic, tcm_map, matmul\n"
            "from repro_torch.core.presets import tpu_v4i_like\n"
            "assert not symbolic._JIT_ENABLED\n"
            "r, _ = tcm_map(matmul('mm', 8, 16, 4), tpu_v4i_like())\n"
            "print(r.edp, 'torch' in sys.modules)\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "False"


def _outside_route(text):
    """The file without its import lines, the switch (from its comment to
    ``class CriteriaKernel``) and ``_call_jit``'s body."""
    lines = text.splitlines()
    a = next(i for i, ln in enumerate(lines) if ln.startswith("# Optional"))
    b = lines.index("class CriteriaKernel:")
    c = lines.index("    def _call_jit(self, cols: np.ndarray):")
    d = next(i for i in range(c, len(lines)) if lines[i].startswith("# ---"))
    kept = lines[:a] + lines[b:c + 1] + lines[d:]
    return [ln for ln in kept
            if not ln.lstrip().startswith(("import ", "from "))]


def test_symbolic_differs_from_reference_only_by_the_route():
    port = (SRC / "repro_torch" / "core" / "symbolic.py").read_text()
    ref = (SRC / "repro" / "core" / "symbolic.py").read_text()
    assert _outside_route(port.replace("repro_torch", "repro")) == \
        _outside_route(ref)
    # the switch reads the reference's variable the reference's way
    line = '_JIT_ENABLED = os.environ.get("TCM_JIT", "0") not in ("", "0")'
    assert line in port.splitlines() and line in ref.splitlines()
    assert "def set_jit(enabled: bool, device: str = \"cuda\")" in port
    assert "from ..kernels import criteria" in port
