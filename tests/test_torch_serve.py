"""The port's serving path (``repro_torch.serving.engine``,
``repro_torch.launch.serve``) against the reference's serve CLI
(``repro.launch.serve``) on the smoke qwen config, on the CPU."""
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.weights import cast_for_compute, params_from_numpy
from repro_torch.serving import engine

ARGS = ["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "2",
        "--prompt-len", "16", "--gen", "4"]


def test_greedy_tokens_equal_reference_serve():
    """JAX's ``PRNGKey(0)`` weights carried across, the CLI's own
    prompts: the port's greedy tokens are the reference CLI's (bf16,
    argmax taking the first of equal logits on both sides)."""
    want = jserve.main(ARGS)
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    params_j, _ = jlm.init(jget_config("qwen1.5-0.5b", smoke=True),
                           jax.random.PRNGKey(0))
    params = cast_for_compute(cfg, params_from_numpy(
        cfg, jax.tree.map(np.asarray, params_j), "cpu"))
    got, stats = serve.generate(cfg, params, serve.make_batch(cfg, 2, 16,
                                                              "cpu"), 4)
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got, want)
    assert stats["decode_steps"] == 3 and stats["device"] == "cpu"
    assert stats["peak_bytes"] is None


_COUNTS = re.compile(r"map-service: (\d+) shape queries over \d+ decode "
                     r"steps -> (\d+) searches \((\d+) exact \+ (\d+) "
                     r"bucket hits")


def test_map_service_summary_counts_equal_reference(tmp_path, monkeypatch,
                                                    capsys):
    """Requests, searches, exact and bucket hits of ``--map-service`` equal
    the reference's.  Each runs in a fresh directory (the service caches
    under ``.tcm_cache`` in the working directory), with a deadline no
    search reaches: a search cut by its deadline is re-run in the
    background, and then the counts depend on timing."""
    args = ARGS + ["--map-service", "--map-deadline-ms", "600000"]
    counts = []
    for name, run in (("ref", lambda: jserve.main(args)),
                      ("port", lambda: serve.main(
                          args + ["--device", "cpu", "--json",
                                  str(tmp_path / "port.json")]))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        run()
        m = _COUNTS.search(capsys.readouterr().out)
        assert m, name
        counts.append(tuple(map(int, m.groups())))
    assert counts[0] == counts[1]
    assert counts[0][0] == 6 * 4  # six unique einsums a decode step
    rep = json.loads((tmp_path / "port.json").read_text())
    assert (rep["map_service"]["requests"], rep["map_service"]["searches"],
            rep["map_service"]["exact_hits"],
            rep["map_service"]["bucket_hits"]) == counts[1]
    assert rep["device"] == "cpu" and rep["decode_steps"] == 3


def test_cli_needs_a_card_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(ARGS)


@pytest.mark.parametrize("extra,match", [
    (["--model-parallel", "2"], "one device"),
    (["--profile"], "needs --device cuda")])
def test_cli_refuses(extra, match):
    with pytest.raises(ValueError, match=match):
        serve.main(ARGS + extra + ["--device", "cpu"])


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b",
                                  "llava-next-34b", "seamless-m4t-medium"])
def test_cli_serves_every_family_on_cpu(arch, capsys):
    """The CLI end to end on the CPU: ring caches (window 64 <= prompt),
    recurrent states, vlm embeddings and audio frames."""
    gen = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prompt-len", "64", "--gen", "3", "--device", "cpu"])
    assert gen.shape == (2, 3)
    cfg = get_config(arch, smoke=True)
    assert ((gen >= 0) & (gen < cfg.vocab)).all()
    assert "device: cpu" in capsys.readouterr().out


def test_serve_steps_update_the_cache_in_place():
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    params = cast_for_compute(cfg, lm.init(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    prefill_step, decode_step = engine.make_serve_steps(cfg)
    cache = lm.init_cache(cfg, 2, 20, "cpu")
    k0 = cache["groups"][0][0][0]["attn"]["k"]
    last, cache = prefill_step(params, serve.make_batch(cfg, 2, 16, "cpu"),
                               cache)
    assert cache["groups"][0][0][0]["attn"]["k"] is k0
    assert k0[:, :16].abs().sum() > 0 and k0[:, 16:].abs().sum() == 0
    logits, cache = decode_step(params, last.argmax(-1)[:, None], cache)
    assert cache["pos"] == 17
    assert cache["groups"][0][0][0]["attn"]["idx"] == 17
    assert k0[:, 16].abs().sum() > 0 and logits.shape == (2, cfg.vocab)
