"""``tp_fsdp`` keeps each row's sums on one rank, as the reference's FSDP
does: where the batch is split over 'data' and so is the weights' 'embed'
(a stack the data extent does not divide, or a weight outside the stacks
such as the head), each rank gathers the 'embed' and forms its own rows
with the whole d (``sharding.whole_along``, ``lm._rows_beside``), where it
once summed every row's partial products across ranks.

The smoke dense model (qwen1.5-0.5b: 2 layers, 'embed' over 'data' and a
'model' of extent 1) over (data, model) (4, 1), laid out as the
reference's dry-run lays it out (``strict`` off: its launchers refuse a
2-layer stack over data 4):

  * in bf16, served from the same weights in ``tp_fsdp`` and in ``tp``
    (whose weights are whole on every rank): every rank forms its rows
    alike in both, so the first logits are equal bit for bit and every
    greedy token is equal;
  * in f32, served and trained one step against the reference on the
    same mesh and against one device at ``TOL`` (``sf.check_layout``).

Run alone: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_fsdp_rows.py``; this file is the reference's subprocess
too (``python tests/test_torch_fsdp_rows.py reference-layout ...``).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent))
import sharded_families as sf  # noqa: E402

SHAPE = (4, 1)
SERVE = (sf.PROMPT, 8)  # a prompt of 16 tokens, then 8 greedy steps


def test_bf16_rows_summed_on_one_rank_serve_as_tp(tmp_path):
    got = sf.serve_modes(tmp_path, "dense", SHAPE, ("tp_fsdp", "tp"),
                         sf.BATCH, serve=SERVE, dtype="bfloat16")
    fsdp, tp = got["tp_fsdp"], got["tp"]
    np.testing.assert_array_equal(fsdp[0], tp[0])
    np.testing.assert_array_equal(fsdp.argmax(-1), tp.argmax(-1))


def test_f32_serve_and_step_as_the_reference_on_the_same_mesh(tmp_path):
    sf.check_layout(HERE, tmp_path, "dense", SHAPE, "tp_fsdp", sf.BATCH,
                    strict=False)


if __name__ == "__main__":
    sf.main(sys.argv)
