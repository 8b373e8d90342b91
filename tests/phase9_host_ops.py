"""The host work of ``chip_smoke.py`` phase 9's runs, counted on the CPU:
each family's smoke config (f32) on a 1x1 gloo mesh in phase 9's modes,
the aten ops one train step, prefill and decode step dispatch (at the
DTensor level and on the local tensors) and the median wall of ``REPS``
calls (host time at smoke width, not a device time).  Not collected by
pytest.  To compare two trees, run it once with each tree's ``src`` on
``PYTHONPATH``::

    PYTHONPATH=src python tests/phase9_host_ops.py OUT.json [REPS]
"""
import datetime
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

torch.set_num_threads(1)


class Count(TorchDispatchMode):
    """Ops dispatched: a DTensor op is counted and declined, so DTensor
    runs it and its local ops come back here to be counted."""

    def __init__(self):
        super().__init__()
        self.dt = self.local = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            self.dt += 1
            return NotImplemented
        self.local += 1
        return func(*args, **(kwargs or {}))


RUNS = [("qwen1.5-0.5b", "train", "dp"), ("qwen1.5-0.5b", "train", "tp"),
        ("qwen1.5-0.5b", "train", "tp_fsdp"),
        ("qwen1.5-0.5b", "serve", "tp"), ("qwen1.5-0.5b", "serve", "tp_fsdp"),
        ("phi3.5-moe-42b-a6.6b", "train", "tp_ep"),
        ("phi3.5-moe-42b-a6.6b", "serve", "tp_ep"),
        ("phi3.5-moe-42b-a6.6b", "train", "tp_fsdp"),
        ("phi3.5-moe-42b-a6.6b", "serve", "tp_fsdp"),
        ("mamba2-130m", "train", "dp"), ("mamba2-130m", "serve", "tp_fsdp"),
        ("seamless-m4t-medium", "train", "dp"),
        ("seamless-m4t-medium", "serve", "tp_fsdp"),
        ("recurrentgemma-2b", "train", "tp_fsdp"),
        ("recurrentgemma-2b", "serve", "tp_fsdp"),
        ("llava-next-34b", "train", "tp_fsdp"),
        ("llava-next-34b", "serve", "tp_fsdp")]


def main():
    out = os.path.abspath(sys.argv[1])
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 15
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import (OptConfig, init_opt_state,
                                         opt_state_specs)
    from repro_torch.serving.engine import make_serve_steps, place_cache
    from repro_torch.training.step import make_train_step

    dist.init_process_group("gloo", init_method=f"file://{out}.store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    mesh = device_mesh(Mesh(("data", "model"), (1, 1)), "cpu")
    res = {}
    for arch, kind, mode in RUNS:
        cfg = get_config(arch, smoke=True).scaled(dtype="float32")
        oc = OptConfig(lr=1e-3, warmup=2, decay_steps=50)
        host = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        specs = lm.param_specs(cfg)
        params = distribute(lm.tree_map(torch.clone, host), specs, mesh, mode)
        if kind == "train":
            opt = distribute(init_opt_state(oc, host),
                             opt_state_specs(oc, specs), mesh, mode)
            step = make_train_step(cfg, oc, mesh=mesh, mode=mode)
            data = pipeline.SyntheticTokens(pipeline.DataConfig(
                global_batch=4, seq_len=32, vocab=cfg.vocab,
                frontend=cfg.frontend, frontend_dim=cfg.frontend_dim,
                frontend_len=8))
            batch = next(data)

            def call():
                return step(params, opt, batch)
            calls = {"step": call}
        else:
            rng = np.random.default_rng(0)
            b = {"tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab, (4, 16)))}
            if cfg.family == "vlm":
                b["embeds"] = torch.from_numpy(rng.normal(
                    size=(4, 8, cfg.frontend_dim)).astype(np.float32))
            if cfg.family == "audio":
                b["enc_frames"] = torch.from_numpy(rng.normal(
                    size=(4, 16, cfg.frontend_dim)).astype(np.float32))
            prefill, decode = make_serve_steps(cfg, mesh, mode)
            L = 16 + 8 + 8

            def fresh():
                return place_cache(cfg, lm.init_cache(cfg, 4, L, "cpu"), mesh)
            last, cache0 = prefill(params, b, fresh())
            tok = torch.argmax(last, -1)[:, None]
            calls = {"prefill": lambda: prefill(params, b, fresh()),
                     "decode": lambda: decode(params, tok, cache0)}
        for name, fn in calls.items():
            fn()
            c = Count()
            with c:
                fn()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            key = f"{arch} {kind} {mode} {name}"
            res[key] = {
                "dtensor_ops": c.dt, "local_ops": c.local,
                "ms": sorted(ts)[len(ts) // 2] * 1e3}
            print(f"{arch} {kind} {mode} {name}: {c.dt} DTensor ops, "
                  f"{c.local} local ops, {res[key]['ms']:.2f} ms",
                  flush=True)
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
