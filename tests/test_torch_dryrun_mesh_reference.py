"""Rank 0 of a model-split mesh held against the reference's compile of the
same cell, at the bounds of the dry-run sweep (``dryrun_sweep_compare``):
the port's dot FLOPs within 0.8-1.25x of the reference's and its
peak-live bytes at most 2.0x.

The smoke ssm, hybrid and moe configs (bf16 parameters, as the dry-run
serves) on 4 ranks, (1, 4) and (2, 2), in the reference's modes for
them: ``tp_fsdp`` for the ssm's and the hybrid's serve cells, ``tp_ep``
for the moe; and on (1, 4) in ``tp_fsdp``, heads that cannot go 1:1 to
'model': the hybrid's decode, prefill and train step with 6 q heads and
1 kv head, and a prefill and a train step of the dense yi-34b with 6 q
and 2 kv heads (a kv head to 2 ranks), the prefills also counted as the
reference counts (``dryrun.as_reference``); on (2, 2) in ``tp_fsdp``
the hybrid's decode of one row, whose RG-LRU gates form the share of
their outputs the reference's do; and on (4, 1) in ``tp_fsdp`` the
smoke dense qwen1.5-0.5b's prefill and decode, whose weights split
'embed' over 'data' as the batch is: there the port's rank 0 also
reduces nothing that the reference's compile does not (its collective
bytes by kind).
The port's rank 0 is traced over a fake group of 4
(``launch.dryrun.trace_step``); the reference's step is jit'd as its
dry-run compiles it (a train step: loss, gradients and AdamW), on 4 host
devices in a subprocess (its ``launch/dryrun.py`` forces 512 on
import), and counted by ``repro.launch.hlo_parse.summarize`` and XLA's
memory analysis.  Where a rank ran the whole recurrent block, or every
q head of the attention, or every row of a q chunk, or every key of a
decode step, or the whole batch's MoE routing, or the whole weight
gradient of ``wo``, these cells fell outside the bounds; where a rank
summed the partial products of every row of a split 'embed', it
reduce-scattered what the reference never reduces.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh

sys.path.insert(0, str(Path(__file__).parent))
from dryrun_sweep_compare import FLOPS_BOUNDS, PEAK_BOUND  # noqa: E402

ARCH = {"ssm": "mamba2-130m", "hybrid": "recurrentgemma-2b",
        "moe": "phi3.5-moe-42b-a6.6b", "dense": "yi-34b",
        "qwen": "qwen1.5-0.5b"}
# where the heads cannot go 1:1 to 'model' (4): the hybrid's 6 q heads and
# 1 kv head (its 10 and 1 over 16), the dense model's 6 and 2 (yi-34b's
# 56 and 8: a kv head to 2 ranks, ``sharding.kv_group``)
UNSPLIT = {"n_heads": 6, "n_kv_heads": 1}
GROUPED = {"n_heads": 6, "n_kv_heads": 2}
C19 = ("hybrid", "decode", 1, 64, (2, 2), "tp_fsdp", {"rglru_dim": 512})
# (model, kind, batch, sequence or cache length, mesh (data, model), mode,
# overrides of the smoke config)
CASES = [("ssm", "decode", 2, 64, (1, 4), "tp_fsdp", {}),
         ("ssm", "decode", 4, 64, (2, 2), "tp_fsdp", {}),
         ("hybrid", "prefill", 2, 256, (1, 4), "tp_fsdp", {}),
         ("hybrid", "prefill", 4, 256, (2, 2), "tp_fsdp", {}),
         ("moe", "prefill", 2, 256, (1, 4), "tp_ep", {}),
         # a decode step reads its slots of the ring, a train step's
         # ranks take their rows of every q chunk (``layers._attend``)
         ("hybrid", "decode", 2, 1024, (1, 4), "tp_fsdp",
          dict(UNSPLIT, window=1024)),
         ("hybrid", "train", 2, 256, (1, 4), "tp_fsdp", UNSPLIT),
         ("dense", "train", 2, 512, (1, 4), "tp_fsdp", GROUPED),
         # and a prefill's ranks their rows of every q chunk, gathered
         ("hybrid", "prefill", 2, 256, (1, 4), "tp_fsdp", UNSPLIT),
         ("dense", "prefill", 2, 512, (1, 4), "tp_fsdp", GROUPED),
         # 'embed' over 'data' as the batch is, 'model' of extent 1: each
         # rank forms its own rows with every weight's 'embed' gathered
         # (``sharding.whole_along``, ``lm._rows_beside``)
         ("qwen", "prefill", 8, 64, (4, 1), "tp_fsdp", {}),
         ("qwen", "decode", 8, 72, (4, 1), "tp_fsdp", {}),
         # a batch of one leaves 'data' idle: the RG-LRU gates' outputs
         # split over it, as the reference's are (C19; its channels
         # widened to 512 so that the gates' products have a shape of
         # their own, ``rglru._gate_weight``)
         C19]
# the collectives that sum partial products
SUMS = ("all-reduce", "reduce-scatter")
SRC = Path(__file__).resolve().parents[1] / "src"


def _reference(cases) -> dict:
    """Each case's (dot FLOPs, argument + temp bytes, collective bytes by
    kind) on the first device of the reference's compile; run in a
    process of its own."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config as ref_config
    from repro.distributed.sharding import (activation_sharding_ctx,
                                             shardings_for)
    from repro.launch.hlo_parse import summarize
    from repro.models import lm
    from repro.serving.engine import batch_shardings, cache_shardings
    from repro.training.step import _abstract_init

    out = {}
    for model, kind, B, S, shape, mode, over in cases:
        cfg = _config(ref_config, model, kind, over)
        params_abs, specs = _abstract_init(cfg, jax.random.PRNGKey(0))
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(shape),
                                 ("data", "model"))
        psh = shardings_for(specs, mesh, mode, like=params_abs)
        if kind == "train":
            compiled = _reference_train(cfg, specs, params_abs, psh, mesh,
                                        mode, B, S)
            out[repr((model, kind, B, S, shape, mode, over))] = _counts(
                compiled, summarize)
            continue
        cache = jax.eval_shape(lambda: lm.init_cache(cfg, B, S))
        csh = cache_shardings(cfg, cache, mesh)
        if kind == "prefill":
            args = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
            ash = batch_shardings(mesh, args)
            step = lm.prefill
        else:
            args = jax.ShapeDtypeStruct((B, 1), jnp.int32)
            ash = batch_shardings(mesh, {"t": args})["t"]
            step = lm.decode_step
        with mesh, activation_sharding_ctx(mesh, mode):
            compiled = jax.jit(
                lambda p, a, c: step(cfg, p, a, c),
                in_shardings=(psh, ash, csh), out_shardings=(None, csh),
            ).lower(params_abs, args, cache).compile()
        out[repr((model, kind, B, S, shape, mode, over))] = _counts(
            compiled, summarize)
    return out


def _counts(compiled, summarize) -> tuple:
    from dryrun_sweep_compare import hlo_dots

    mem = compiled.memory_analysis()
    text = compiled.as_text()
    hlo = summarize(text)
    return (hlo.flops, mem.argument_size_in_bytes + mem.temp_size_in_bytes,
            hlo.collective_bytes, hlo_dots(text))


def _config(get, model: str, kind: str, over: dict):
    """The smoke config of ``model`` by either package's ``get_config``,
    with ``over``; bf16 parameters where it serves, as the dry-run
    serves."""
    cfg = get(ARCH[model], smoke=True).scaled(**over)
    return cfg if kind == "train" else cfg.scaled(param_dtype="bfloat16")


def _reference_train(cfg, specs, params_abs, psh, mesh, mode: str, B: int,
                     S: int):
    """The reference's train step (loss, gradients, AdamW) compiled as its
    dry-run compiles a train cell of one microbatch: parameters,
    optimizer state and batch by its layouts, the gradients pinned to
    the parameters'."""
    import jax
    import jax.numpy as jnp
    from repro.distributed.sharding import (activation_sharding_ctx,
                                             shardings_for)
    from repro.models import lm
    from repro.optim.adamw import (OptConfig, apply_updates, init_opt_state,
                                   opt_state_specs)
    from repro.serving.engine import batch_shardings

    oc = OptConfig()
    opt_abs = jax.eval_shape(lambda p: init_opt_state(oc, p), params_abs)
    osh = shardings_for(opt_state_specs(oc, specs), mesh, mode, like=opt_abs)
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    bsh = batch_shardings(mesh, batch)

    def step(params, opt, b):
        loss, grads = jax.value_and_grad(
            lambda p: lm.loss_fn(cfg, p, b)[0])(params)
        grads = jax.tree.map(jax.lax.with_sharding_constraint, grads, psh)
        new_p, new_o, gn = apply_updates(oc, params, grads, opt)
        return new_p, new_o, {"loss": loss, "grad_norm": gn}

    with mesh, activation_sharding_ctx(mesh, mode):
        return jax.jit(step, in_shardings=(psh, osh, bsh),
                       out_shardings=(psh, osh, None)).lower(
            params_abs, opt_abs, batch).compile()


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, __file__, json.dumps(CASES)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _port(model, kind, B, S, shape, mode, over=None, by_op=False) -> dict:
    cfg = _config(get_config, model, kind, over or {})
    return dryrun.trace_step(cfg, dryrun.Cell(kind, B, S), "cpu",
                             mesh=Mesh(("data", "model"), shape), mode=mode,
                             by_op=by_op)


def _of(reference, case):
    return reference[repr(tuple(tuple(x) if isinstance(x, list) else x
                                for x in case))]


@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(map(str, c[:2] + c[4:5])) + f"-{c[5]}"
                              for c in CASES])
def test_rank0_is_held_against_the_reference_compile(reference, case):
    ref_flops, ref_peak = _of(reference, case)[:2]
    res = _port(*case)
    flops = res["hlo"]["per_device_flops"] / ref_flops
    peak = res["memory_per_device"]["peak_live_bytes"] / ref_peak
    assert FLOPS_BOUNDS[0] <= flops <= FLOPS_BOUNDS[1], (flops, peak)
    assert peak <= PEAK_BOUND, (flops, peak)


PREFILLS = [c for c in CASES if c[1] == "prefill" and c[6]]


@pytest.mark.parametrize("case", PREFILLS, ids=[c[0] for c in PREFILLS])
def test_prefill_rank0_counted_as_the_reference_counts_is_held(reference,
                                                               case):
    """C22: where the heads cannot go 1:1 to 'model', a prefill's ranks
    split the rows of every q chunk as the reference's do.  Counted as the
    reference counts (``dryrun.as_reference``: the attention's masked kv
    blocks and every position's logits), rank 0's FLOPs are the
    reference's: 1.455x (the hybrid) and 1.500x (the kv group) when each
    rank ran every row."""
    with dryrun.as_reference():
        res = _port(*case)
    flops = res["hlo"]["per_device_flops"] / _of(reference, case)[0]
    assert FLOPS_BOUNDS[0] <= flops <= FLOPS_BOUNDS[1], flops


FSDP_ROWS = [c for c in CASES if c[0] == "qwen"]


@pytest.mark.parametrize("case", FSDP_ROWS,
                         ids=[f"{c[1]}-{c[4][0]}x{c[4][1]}-{c[5]}"
                              for c in FSDP_ROWS])
def test_rank0_sums_no_partial_products_the_reference_does_not(reference,
                                                                case):
    """Over (4, 1) in ``tp_fsdp`` the reference's compile all-gathers
    every weight's 'embed', the head's too, and each rank forms its own
    rows with the whole d: it reduces nothing.  So the port's rank 0
    reduce-scatters or all-reduces nothing either, where it once summed
    the partial products of every row of the MLP's and the head's split
    'embed' (the head, 8 x 512 f32, in every serve step)."""
    ref = _of(reference, case)[2]
    coll = _port(*case)["hlo"]["collective_bytes"]
    for kind in SUMS:
        if not ref.get(kind):
            assert not coll.get(kind), (kind, coll, ref)


def _outputs(dots, k: int) -> int:
    """The most output elements of one product contracting ``k``, over
    ``dots``: (FLOPs, description) of ``hlo_dots`` ("... [out] <- [lhs]
    k=K") or ``by_op``'s FLOPs keys ("aten.mm MxK KxN")."""
    most = 0
    for _, key in dots:
        if "<-" in key:
            out, kk = key.split("[")[1].split("]")[0], key.split("k=")[-1]
            n = math.prod(int(x) for x in out.split("x") if x)
        elif key.startswith("aten.mm "):
            (m, kk), (_, n) = (x.split("x") for x in key.split()[1:3])
            n = int(m) * int(n)
        else:
            continue
        if int(kk) == k:
            most = max(most, n)
    return most


def test_rank0_gates_form_the_share_of_outputs_the_reference_does(
        reference):
    """C19: a batch of one over (2, 2) in ``tp_fsdp`` leaves 'data' idle,
    and the reference's compile splits the RG-LRU gates' outputs over it:
    each device contracts its 256 of the 512 channels into 256 outputs.
    So rank 0's products contracting its channels form at most as many
    outputs as the reference's, where it once formed all 512 of each
    gate (``mm 1x256 256x512``)."""
    k = C19[6]["rglru_dim"] // C19[4][1]
    ref = _outputs(_of(reference, C19)[3], k)
    res = _port(*C19, by_op=True)
    got = _outputs([(f, key) for key, f in res["by_op"]["flops"].items()],
                   k)
    assert 0 < got <= ref, (got, ref)


def test_moe_rank_routes_its_rows_only():
    """Over (2, 2) in ``tp_ep`` a rank keeps its own rows of the batch: no
    tensor live at its peak holds the batch's tokens, (B, S, d) or (T, d),
    or its (token, k) pairs' rows, (T * K, d), as when every rank routed
    the gathered batch.  (The smoke cells on (2, 2) stay within the
    sweep's bounds either way, the peak 1.40x the reference's before and
    0.93x after, so this is held by shape.)"""
    B, S = 512, 64
    cfg = get_config(ARCH["moe"], smoke=True)
    d, T = cfg.d_model, B * S
    res = _port("moe", "prefill", B, S, (2, 2), "tp_ep", by_op=True)
    whole = {f"{B}x{S}x{d}", f"{T}x{d}", f"{T * cfg.top_k}x{d}"}
    held = [key for key in res["by_op"]["peak_live"]
            if whole & set(key.split("->")[-1].split())]
    assert not held, held


if __name__ == "__main__":
    print(json.dumps(_reference([tuple(tuple(x) if isinstance(x, list)
                                       else x for x in c)
                                 for c in json.loads(sys.argv[1])])))
