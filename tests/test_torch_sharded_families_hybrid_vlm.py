"""The hybrid (recurrentgemma-2b) and vlm (llava-next-34b) families over a
mesh against the JAX reference on 2 and 4 host devices: ``tp_fsdp``, their
reference mode, on the five meshes, and ``tp``, ``dp`` and ``tp_ep`` on
(2, 2).  The runners and the checks are ``tests/sharded_families.py``'s
(its docstring has the configs and tolerances).  Besides, the hybrid's
one-layer stacks as the reference lays them out, a remat'd ``tp_fsdp``
step that holds one gathered layer of each stacked leaf of its
(rglru, rglru, wattn) group at a time, and the vlm under the launchers."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import sharded_families as sf

HERE = Path(__file__).resolve()
MODELS = ("hybrid", "vlm")
CASES = sf.cases(MODELS)
IDS = sf.ids(CASES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sf.run_all(HERE, tmp_path_factory.mktemp("families_hv"), MODELS)


@pytest.fixture(scope="module")
def one_device(runs):
    return sf.one_device(runs, MODELS)


@pytest.mark.parametrize("shape,model,mode", CASES, ids=IDS)
def test_train_steps_match_reference_on_the_same_mesh(runs, shape, model,
                                                      mode):
    sf.check_train(runs, shape, model, mode)


@pytest.mark.parametrize("shape,model,mode", CASES, ids=IDS)
def test_greedy_serve_matches_reference_on_the_same_mesh(runs, shape, model,
                                                         mode):
    """Tokens equal and last logits within 1e-4, with the hybrid's ring
    (window 8 under a prompt of 16) and recurrent states carried across
    the decode steps."""
    sf.check_serve(runs, shape, model, mode)


@pytest.mark.parametrize("shape,model,mode", CASES, ids=IDS)
def test_every_rank_holds_the_reference_shard_shapes(runs, shape, model,
                                                     mode):
    sf.check_shapes(runs, shape, model, mode)


@pytest.mark.parametrize("shape,model,mode", CASES, ids=IDS)
def test_sharded_port_equals_one_device_port(runs, one_device, shape, model,
                                             mode):
    sf.check_one_device(runs, one_device, shape, model, mode)


@pytest.mark.parametrize("world,key", sf.restore_keys(MODELS))
def test_checkpoints_restore_bitwise_across_modes_and_meshes(runs, world,
                                                             key):
    sf.check_restore(runs, world, key)


@pytest.mark.parametrize("model", MODELS)
def test_reference_restores_the_port_checkpoint(runs, model):
    sf.check_reference_reads(runs, model)


@pytest.mark.parametrize("world", [2, 4])
def test_no_product_flattens_a_split_sequence(runs, world):
    sf.check_not_strided(runs, world)


def test_hybrid_ring_wraps_in_the_served_cache(runs):
    """The wattn layers' cache is a ring of ``window`` slots, shorter than
    the prompt, on every mesh (its kv sequence split over 'model', its one
    kv head not)."""
    cfg = sf.cfg_of("hybrid")
    assert cfg.window < sf.PROMPT
    for shape, model, mode in CASES:
        if model != "hybrid":
            continue
        got = json.loads((runs / f"port_{sf.tag(shape, model, mode)}"
                          "_shapes_r0.json").read_text())["cache"]
        ring = got["g0.k2.attn.k"]
        assert ring[1] * shape[1] == cfg.window, (shape, mode, ring)


def test_hybrid_holds_one_gathered_layer_per_stack(runs, one_device):
    """A remat'd ``tp_fsdp`` step on (4, 1), each rank holding one layer of
    the 4-layer group stack (two layer kinds in one stack), never keeps two
    gathered layers of one stacked leaf alive; the one-layer stacks are
    indexed, not gathered.  The step equals the one-device one."""
    for r in range(4):
        rep = sf.report(runs, 4, r)["held"]
        assert rep["stacks"] == rep["group_leaves"] > 0, r
        assert rep["peak"] == [1] * rep["stacks"], r
        assert rep["kinds"] == [0, 1, 2], r
        np.testing.assert_allclose(rep["loss"],
                                   one_device["hybrid"]["remat_loss"],
                                   rtol=sf.TOL)
        np.testing.assert_allclose(rep["grad_norm"],
                                   one_device["hybrid"]["remat_grad_norm"],
                                   rtol=sf.TOL)


def test_reference_keeps_a_one_layer_stack_whole(runs):
    """The reference's hybrid in ``tp_fsdp`` on (2, 1): as ``launch.train``
    runs it (no ``params_abs``) a one-layer stack cannot split over data 2
    and the step is refused; as its dry-run compiles it (``like=
    params_abs``) the stack keeps its layer whole, 'embed' takes 'data',
    and the step runs.  The port lays such a stack out the second way."""
    rep = json.loads((runs / "ref_stacks.json").read_text())
    assert rep["launch_train"]["failed"]
    assert "divisible" in rep["launch_train"]["error"]
    assert not rep["params_abs"]["failed"]
    assert np.isfinite(rep["params_abs"]["loss"])
    tail = rep["params_abs"]["tail"]
    assert tail and all(s.startswith("(None,") for s in tail)
    assert any("'data'" in s for s in tail)


@pytest.mark.parametrize("layers,shape,stack", [
    (14, (2, 1), None), (14, (4, 1), None), (26, (2, 1), None),
    (26, (4, 1), None), (4, (2, 1), None), (26, (1, 4), None),
    (15, (2, 1), "rglru/rglru/wattn stack of 5 layers"),
    (9, (4, 1), "rglru/rglru/wattn stack of 3 layers")])
def test_tp_fsdp_judges_each_stack_of_the_hybrid(layers, shape, stack):
    """``check_sharded`` judges each stack of ``_stack_groups``, not the
    layer count: recurrentgemma-2b's 26 layers are 8 groups and two
    one-layer stacks, which run on data 2 and 4 (the one-layer stacks
    whole), and 4 layers are two one-layer stacks; 15 layers (5 groups)
    over data 2 and 9 (3 groups) over data 4 are refused, naming the
    stack and both numbers."""
    from repro_torch.distributed.sharding import check_sharded
    from repro_torch.launch.mesh import Mesh

    cfg = sf.cfg_of("hybrid", n_layers=layers)
    mesh = Mesh(("data", "model"), shape)
    if stack is None:
        check_sharded(cfg, "tp_fsdp", mesh)
        return
    with pytest.raises(ValueError, match=rf"extent {shape[0]}, which does "
                       rf"not divide .*{stack}"):
        check_sharded(cfg, "tp_fsdp", mesh)
    check_sharded(cfg, "tp", mesh)  # only tp_fsdp splits the stacks


def test_unevenly_split_heads_train_and_serve_as_on_one_device(tmp_path):
    """recurrentgemma-2b's 10 heads and 1 kv head over 'model' 4 in
    ``tp``: the heads' columns are gathered before the head reshape, and
    after the attention the merged heads' gradient comes back whole
    (``sharding.pinned``; without it the backward's reshape of an uneven
    split fails).  3 steps and the greedy serve against the one-device
    port, no strided shard."""
    import time

    import torch.multiprocessing as tmp

    ctx = tmp.start_processes(sf.heads_rank, args=(4, str(tmp_path)),
                              nprocs=4, join=False, start_method="spawn")
    sf._join(ctx, time.monotonic() + sf.DEADLINE_S)
    rep = json.loads((tmp_path / "heads.json").read_text())
    got, want = rep["mesh"], rep["one"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=sf.TOL)
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_allclose(a, b, rtol=sf.TOL, atol=sf.TOL)
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=sf.TOL,
                               atol=sf.TOL)
    assert rep["strided"] == []


def test_batch_of_one_serves_as_on_one_device(tmp_path):
    """One prompt over (2, 2) in ``tp_fsdp``: the batch leaves 'data' free,
    so the tied head and the embedding keep their 'embed' split over
    'data' (the product's partial sums reduced), the RG-LRU runs on each
    rank's channels and its ring's window through the prefill; served and
    trained as the reference on the same mesh and as one device."""
    sf.check_layout(HERE, tmp_path, "hybrid", (2, 2), "tp_fsdp", 1)


def test_heads_split_by_kv_group_as_on_one_device(tmp_path):
    """6 q heads and 2 kv heads over (1, 4) in ``tp_fsdp``: neither count
    divides 'model', so each kv head goes to 2 ranks with its 3 q heads
    (yi-34b's 56 and 8 over 16) and the heads' shares are summed; served
    and trained as the reference on the same mesh and as one device."""
    sf.check_layout(HERE, tmp_path, "vlm", (1, 4), "tp_fsdp", sf.BATCH,
                    n_heads=6, n_kv_heads=2)


def test_launchers_run_the_vlm_under_torch_distributed_run(tmp_path):
    sf.check_launchers(tmp_path, "llava-next-34b", "tp_fsdp", 1, "tp", 2)


if __name__ == "__main__":
    sf.main(sys.argv)
