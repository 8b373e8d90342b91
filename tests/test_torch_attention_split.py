"""Attention whose heads cannot go one to one to the ranks of 'model': the
ranks split its work instead (``models.layers._attend``), and the values
stay the reference's on the same mesh and one device's.

recurrentgemma-2b's smoke config (f32, 5 layers: one (rglru, rglru,
wattn) group and two one-layer rglru stacks) with 6 q heads and 1 kv
head over (data, model) (1, 4) in ``tp_fsdp``, as its 10 q heads go over
16: a train step splits the rows of every q chunk over 'model'
(``_own_rows``), and a decode step splits the cache's slots
(``_split_keys``).  Served from a prompt of one token, so the first
decode steps see a cache whose slots on some ranks are all masked, and
for 10 steps; with ``window`` 8 the cache is the ring and the steps wrap
it, with ``window`` 32 it is the whole cache of 20 slots.  Runners and
tolerances are ``tests/sharded_families.py``'s (``check_layout``: 4 gloo
ranks against the reference on 4 host devices and against one device,
at ``TOL``), and rank 0's attention must run a quarter of one device's
(row, head, key) triples.

Run alone: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_attention_split.py``; this file is the reference's
subprocess too (``python tests/test_torch_attention_split.py
reference-layout ...``).
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent))
import sharded_families as sf  # noqa: E402

HEADS = {"n_layers": 5, "n_heads": 6, "n_kv_heads": 1}
SERVE = (1, 10)  # a prompt of one token, then 10 decode steps


@pytest.mark.parametrize("window", [8, 32], ids=["ring", "whole-cache"])
def test_unsplit_heads_split_rows_and_keys_as_on_one_device(tmp_path,
                                                            window):
    sf.check_layout(HERE, tmp_path, "hybrid", (1, 4), "tp_fsdp", sf.BATCH,
                    serve=SERVE, split=4, window=window, **HEADS)


if __name__ == "__main__":
    sf.main(sys.argv)
