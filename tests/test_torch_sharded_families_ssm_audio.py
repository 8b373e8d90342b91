"""The ssm (mamba2-130m) and audio (seamless-m4t-medium) families over a
mesh against the JAX reference on 2 and 4 host devices: ``dp`` and
``tp_fsdp``, their reference modes (the dry-run trains them in ``dp`` and
serves them in ``tp_fsdp``), on the five meshes, ``tp`` and ``tp_ep`` on
(2, 2), and the audio in ``tp_ep`` on (1, 2), where its MLP is not split
but its sequence is.  The runners and the checks are
``tests/sharded_families.py``'s (its docstring has the configs and
tolerances).  Besides, the SSD decode
state split as the reference's stacked cache rule splits it, the audio's
2-layer stacks refused over data 4 in ``tp_fsdp``, and the ssm under the
launchers."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

import sharded_families as sf

HERE = Path(__file__).resolve()
MODELS = ("ssm", "audio")
CASES = sf.cases(MODELS)
IDS = sf.ids(CASES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sf.run_all(HERE, tmp_path_factory.mktemp("families_sa"), MODELS)


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
    """Tokens equal and last logits within 1e-4, with the SSD states and
    the audio's cross-attention cache carried across the decode steps."""
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


def test_ssd_state_splits_its_state_dim_over_model(runs):
    """The SSD decode state h (B, H, N, P) has an attention buffer's rank:
    the cache rule splits N over 'model' (the reference's stacked rule
    takes the same dim), and the batch over 'data'."""
    cfg = sf.cfg_of("ssm")
    for shape, model, mode in CASES:
        if model != "ssm":
            continue
        got = json.loads((runs / f"port_{sf.tag(shape, model, mode)}"
                          "_shapes_r0.json").read_text())["cache"]
        assert got["g0.k0.ssm.h"] == [
            sf.BATCH // shape[0], cfg.ssm_heads, cfg.ssm_state // shape[1],
            cfg.ssm_head_dim], (shape, mode)


@pytest.mark.parametrize("shape,stack", [
    ((2, 1), None), ((2, 2), None), ((1, 4), None),
    ((4, 1), "enc stack of 2 layers")])
def test_tp_fsdp_judges_each_stack_of_the_audio(shape, stack):
    """The audio's encoder and decoder are stacks of their own: 2 + 2
    layers split over data 2, and data 4 is refused for the encoder's 2
    (the reference's jit'd step refuses such a stack, as
    ``test_torch_sharded_modes.py`` holds)."""
    from repro_torch.distributed.sharding import check_sharded
    from repro_torch.launch.mesh import Mesh

    cfg = sf.cfg_of("audio")
    mesh = Mesh(("data", "model"), shape)
    if stack is None:
        check_sharded(cfg, "tp_fsdp", mesh)
        return
    with pytest.raises(ValueError, match=rf"extent {shape[0]}, which does "
                       rf"not divide .*{stack}"):
        check_sharded(cfg, "tp_fsdp", mesh)
    check_sharded(cfg, "dp", mesh)
    check_sharded(cfg.scaled(enc_layers=4, dec_layers=4, n_layers=8),
                  "tp_fsdp", mesh)


def test_batch_of_one_serves_as_on_one_device(tmp_path):
    """One prompt over (2, 2) in ``tp_fsdp``: the batch leaves 'data' free,
    so the tied head and the embedding keep their 'embed' split over
    'data' (the product's partial sums reduced) and the SSD runs on each
    rank's channels of ``d_inner``; the prefill's and two decode steps'
    last logits, and a train step, equal the reference's on the same mesh
    and one device's."""
    sf.check_layout(HERE, tmp_path, "ssm", (2, 2), "tp_fsdp", 1)


def test_unsplit_vocabulary_runs_as_on_one_device(tmp_path):
    """A vocabulary of 511 over (2, 2) in ``tp_fsdp``: 'model' does not
    divide it, so the table stays whole along it and split along 'embed'
    over 'data', and the head's rows take 'model' while each rank
    contracts its slice of 'embed'; served and trained as the reference on
    the same mesh and as one device."""
    sf.check_layout(HERE, tmp_path, "ssm", (2, 2), "tp_fsdp", sf.BATCH,
                    vocab=511)


def test_launchers_run_the_ssm_under_torch_distributed_run(tmp_path):
    sf.check_launchers(tmp_path, "mamba2-130m", "dp", 2, "tp_fsdp", 1)


if __name__ == "__main__":
    sf.main(sys.argv)
