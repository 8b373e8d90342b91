"""Deterministic fault injection for the resilience layer.

A :class:`FaultPlan` scripts failures by *work-unit index* — worker
crashes (hard ``os._exit``, the ``BrokenExecutor`` path), deterministic
Python exceptions, ``KeyboardInterrupt`` (the SIGINT path) and slow units
— and is delivered to every process through a JSON file named by the
``TCM_FAULT_PLAN`` environment variable (``search._fault_hook`` loads it
lazily in the driver; the pool initializer captures the variable at
pool-creation time so forkserver/spawn workers see plans installed after
import).

Determinism across retries comes from **marker files**: each scripted
firing claims one ``O_CREAT|O_EXCL`` marker in ``state_dir`` before
firing, so "crash twice, then succeed" means exactly that no matter how
many processes attempt the unit.  Worker crashes never fire in the driver
process (``driver_pid`` guard) — a plan can kill arbitrarily many workers
without taking down the search it is testing.

Also here: :func:`tear_last_line`, the torn-append simulator for the cache
robustness tests, and a ``python -m repro_torch.testing.faults`` CI smoke entry
that proves value-identical optima under injected faults.
"""
from __future__ import annotations

import errno
import json
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Union

SCHEMA = 1


@dataclass
class FaultPlan:
    """Scripted failures keyed by work-unit index."""

    state_dir: str  # marker-file directory (shared by all processes)
    driver_pid: int  # crashes never fire in this process
    crash: Dict[int, int] = field(default_factory=dict)  # index -> n times
    exc: Dict[int, int] = field(default_factory=dict)  # index -> n times
    interrupt: Dict[int, int] = field(default_factory=dict)  # KeyboardInterrupt
    slow: Dict[int, float] = field(default_factory=dict)  # index -> seconds

    def _claim(self, kind: str, index: int, times: int) -> bool:
        """Atomically claim one of ``times`` firing slots; False once all
        are used (the fault has fired its scripted number of times)."""
        os.makedirs(self.state_dir, exist_ok=True)
        for i in range(times):
            marker = os.path.join(self.state_dir, f"{kind}_{index}_{i}")
            try:
                os.close(os.open(marker, os.O_CREAT | os.O_EXCL))
                return True
            except OSError as e:
                if e.errno != errno.EEXIST:
                    raise
        return False

    def fire(self, index: int) -> None:
        """Called by ``search.run_work_unit`` at the top of every unit."""
        s = self.slow.get(index)
        if s:
            time.sleep(s)
        n = self.interrupt.get(index)
        if n and self._claim("int", index, n):
            raise KeyboardInterrupt(f"injected interrupt at unit {index}")
        n = self.exc.get(index)
        if n and self._claim("exc", index, n):
            raise RuntimeError(f"injected fault at unit {index}")
        n = self.crash.get(index)
        if n and os.getpid() != self.driver_pid and self._claim(
                "crash", index, n):
            os._exit(3)  # hard kill: the BrokenExecutor path, no cleanup


def write_plan(path: Union[str, Path], state_dir: Union[str, Path],
               crash: Optional[Dict[int, int]] = None,
               exc: Optional[Dict[int, int]] = None,
               interrupt: Optional[Dict[int, int]] = None,
               slow: Optional[Dict[int, float]] = None,
               driver_pid: Optional[int] = None) -> str:
    """Serialize a plan; ``driver_pid`` defaults to the calling process."""
    rec = {
        "schema": SCHEMA,
        "state_dir": str(state_dir),
        "driver_pid": int(driver_pid if driver_pid is not None
                          else os.getpid()),
        "crash": {str(k): int(v) for k, v in (crash or {}).items()},
        "exc": {str(k): int(v) for k, v in (exc or {}).items()},
        "interrupt": {str(k): int(v)
                      for k, v in (interrupt or {}).items()},
        "slow": {str(k): float(v) for k, v in (slow or {}).items()},
    }
    path = Path(path)
    os.makedirs(path.parent, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(rec, indent=2) + "\n", encoding="utf-8")
    os.replace(tmp, path)
    return str(path)


def load_plan(path: Union[str, Path]) -> FaultPlan:
    with open(path, "r", encoding="utf-8") as f:
        rec = json.load(f)
    return FaultPlan(
        state_dir=rec["state_dir"],
        driver_pid=int(rec["driver_pid"]),
        crash={int(k): int(v) for k, v in rec.get("crash", {}).items()},
        exc={int(k): int(v) for k, v in rec.get("exc", {}).items()},
        interrupt={int(k): int(v)
                   for k, v in rec.get("interrupt", {}).items()},
        slow={int(k): float(v) for k, v in rec.get("slow", {}).items()},
    )


@contextmanager
def installed(plan_path: Union[str, Path]):
    """Point ``TCM_FAULT_PLAN`` at a written plan for the enclosed block,
    resetting the in-process lazy hook on entry and exit (pools created
    inside the block deliver the plan to their workers via initializer)."""
    from repro_torch.core import search
    prev = os.environ.get("TCM_FAULT_PLAN")
    os.environ["TCM_FAULT_PLAN"] = str(plan_path)
    search.reset_fault_plan()
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("TCM_FAULT_PLAN", None)
        else:
            os.environ["TCM_FAULT_PLAN"] = prev
        search.reset_fault_plan()


def tear_last_line(path: Union[str, Path], keep_bytes: int = 7) -> None:
    """Simulate a torn append: truncate the file mid-way through its final
    line (the crash-while-writing case the cache loader must survive)."""
    path = Path(path)
    data = path.read_bytes()
    body = data.rstrip(b"\n")
    cut = body.rfind(b"\n") + 1  # start of the final line
    end = min(cut + keep_bytes, len(body))
    with open(path, "wb") as f:
        f.write(data[:end])
        f.flush()
        os.fsync(f.fileno())


# --------------------------------------------------------------------------
# CI smoke: value-identical optima under injected faults
# --------------------------------------------------------------------------


def _ci_main() -> int:
    """Fault-injection smoke (wired into CI): the QK search under scripted
    worker crashes plus a netmap smoke over a torn cache line must return
    value-identical optima with nonzero retry counters, and a scripted
    poison unit must produce a quarantine repro."""
    import shutil
    import tempfile

    from repro_torch.core.mapper import tcm_map
    from repro_torch.core.presets import small_matmul_suite, tpu_v4i_like
    from repro_torch.core.search import ProcessPoolEngine
    from repro_torch.netmap.cache import MappingCache

    einsum, arch = small_matmul_suite()["QK"], tpu_v4i_like()
    work = tempfile.mkdtemp(prefix="tcm_fault_smoke_")
    failures = []
    try:
        # -- reference run: no faults ------------------------------------
        ref, _ = tcm_map(einsum, arch, workers=2)
        assert ref is not None

        # -- QK under scripted worker crashes ----------------------------
        plan = write_plan(os.path.join(work, "plan.json"),
                          os.path.join(work, "state"),
                          crash={0: 1, 3: 1})
        with installed(plan):
            eng = ProcessPoolEngine(workers=2)
            try:
                got, stats = tcm_map(einsum, arch, engine=eng)
            finally:
                fault_stats = dict(eng.fault_stats)
                eng.close()
        if got is None or (got.energy, got.latency, got.edp) != (
                ref.energy, ref.latency, ref.edp):
            failures.append(f"crash run optimum mismatch: {got} vs {ref}")
        if fault_stats["retries"] == 0 and fault_stats["serial_fallbacks"] == 0:
            failures.append(f"no recovery recorded: {fault_stats}")
        print(f"[fault-smoke] crash run ok: edp={got.edp:g} "
              f"fault_stats={fault_stats} "
              f"n_retried_units={stats.n_retried_units}")

        # -- poison unit -> quarantine repro ------------------------------
        qdir = os.path.join(work, "quarantine")
        plan = write_plan(os.path.join(work, "plan2.json"),
                          os.path.join(work, "state2"),
                          exc={1: 999})
        with installed(plan):
            eng = ProcessPoolEngine(workers=2, quarantine_dir=qdir)
            try:
                got2, stats2 = tcm_map(einsum, arch, engine=eng)
            finally:
                q = eng.fault_stats["quarantined"]
                eng.close()
        if q == 0 or not os.listdir(qdir):
            failures.append("poison unit produced no quarantine repro")
        if got2 is None or (got2.energy, got2.latency, got2.edp) != (
                ref.energy, ref.latency, ref.edp):
            # unit 1 is one skeleton of many; the optimum must survive
            failures.append("quarantine run lost the optimum")
        print(f"[fault-smoke] quarantine run ok: "
              f"quarantined={q} repros={os.listdir(qdir)} "
              f"gap_bound={stats2.gap_bound}")

        # -- torn cache line ----------------------------------------------
        cache_root = os.path.join(work, "cache")
        cache = MappingCache(root=cache_root)
        cache.put(einsum, arch, "edp", ref)
        cache.put(einsum, arch, "energy", ref)
        tear_last_line(cache.path)
        reloaded = MappingCache(root=cache_root)
        hit = reloaded.get(einsum, arch, "edp")
        if hit is None or hit.result.edp != ref.edp:
            failures.append("torn cache line destroyed the surviving entry")
        if reloaded.n_quarantined == 0:
            failures.append("torn line not counted as quarantined")
        print(f"[fault-smoke] torn cache ok: n_quarantined="
              f"{reloaded.n_quarantined} len={len(reloaded)}")

        # -- netmap smoke under crashes + a torn persistent cache ---------
        from repro_torch.configs import get_config
        from repro_torch.netmap.planner import map_network

        cfg = get_config("qwen1_5_0_5b", smoke=True)
        net_root = os.path.join(work, "netcache")
        net_ref = map_network(cfg, arch, mode="decode", batch=1, seq=128,
                              cache=MappingCache(root=net_root))
        tear_last_line(MappingCache(root=net_root).path)
        plan = write_plan(os.path.join(work, "plan3.json"),
                          os.path.join(work, "state3"),
                          crash={0: 1})
        with installed(plan):
            eng = ProcessPoolEngine(workers=2)
            try:
                net_got = map_network(cfg, arch, mode="decode", batch=1,
                                      seq=128,
                                      cache=MappingCache(root=net_root),
                                      engine=eng)
            finally:
                net_faults = dict(eng.fault_stats)
                eng.close()
        if (net_got.total_energy, net_got.total_latency) != (
                net_ref.total_energy, net_ref.total_latency):
            failures.append(
                f"netmap totals drifted under faults: "
                f"{net_got.total_edp} vs {net_ref.total_edp}")
        if net_faults["retries"] + net_faults["serial_fallbacks"] == 0:
            failures.append(f"netmap run recorded no recovery: {net_faults}")
        print(f"[fault-smoke] netmap ok: edp={net_got.total_edp:g} "
              f"fault_stats={net_faults}")
    finally:
        # keep quarantine repros for artifact upload; everything else goes
        keep = os.environ.get("TCM_FAULT_SMOKE_KEEP")
        if keep:
            shutil.copytree(os.path.join(work, "quarantine"), keep,
                            dirs_exist_ok=True)
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        for f in failures:
            print(f"[fault-smoke] FAIL: {f}")
        return 1
    print("[fault-smoke] all checks passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(_ci_main())
