"""Deterministic synthetic token pipeline (numpy only).

A copy of ``repro.data.pipeline``: the same classes and arithmetic, so the
token streams are bit-identical to the reference's.

Production-shaped: per-host sharding, stateful + checkpointable iterator
(restoring ``state()`` resumes the exact stream), modality-frontend stubs
for the vlm/audio families.  Token streams are a counter-based hash so any
(step, host) pair regenerates identically — no filesystem dependency, which
is what you want for a dry-run framework; swapping in a real corpus only
requires replacing ``_tokens_for_step``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    frontend: str = "none"  # none | patch | frames
    frontend_dim: int = 0
    frontend_len: int = 576


class SyntheticTokens:
    """Deterministic, shardable, checkpointable token stream."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def _rng(self, step: int) -> np.random.Generator:
        seed = (self.cfg.seed * 1_000_003 + step) * 65_537 + self.cfg.host_id
        return np.random.default_rng(seed & 0x7FFFFFFF)

    def _tokens_for_step(self, step: int) -> np.ndarray:
        rng = self._rng(step)
        return rng.integers(0, self.cfg.vocab,
                            (self.local_batch, self.cfg.seq_len + 1),
                            dtype=np.int32)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        toks = self._tokens_for_step(self.step)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.frontend == "patch":
            rng = self._rng(self.step + (1 << 30))
            batch["embeds"] = rng.normal(size=(
                self.local_batch, self.cfg.frontend_len,
                self.cfg.frontend_dim)).astype(np.float32)
        elif self.cfg.frontend == "frames":
            rng = self._rng(self.step + (1 << 30))
            batch["enc_frames"] = rng.normal(size=(
                self.local_batch, self.cfg.seq_len,
                self.cfg.frontend_dim)).astype(np.float32)
        self.step += 1
        return batch

    def state(self) -> Dict:
        return {"step": self.step, "seed": self.cfg.seed,
                "host_id": self.cfg.host_id}

    def restore(self, state: Dict) -> None:
        assert state["seed"] == self.cfg.seed, "seed mismatch on restore"
        self.step = int(state["step"])
