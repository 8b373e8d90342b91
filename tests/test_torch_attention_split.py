"""Attention whose heads cannot go one to one to the ranks of 'model': the
ranks split its work instead (``models.layers._attend``), and the values
stay the reference's on the same mesh and one device's.

recurrentgemma-2b's smoke config (f32, 5 layers: one (rglru, rglru,
wattn) group and two one-layer rglru stacks) with 6 q heads and 1 kv
head over (data, model) (1, 4) in ``tp_fsdp``, as its 10 q heads go over
16: a train step and a prefill split the rows of every q chunk over
'model' (``_own_rows``; the prefill gathers each rank's rows in order,
``_rows_gathered``), and a decode step splits the cache's slots
(``_split_keys``).  Served from a prompt of one token (a prefill that is
a decode step), so the first decode steps see a cache whose slots on
some ranks are all masked, and for 10 steps; or from a prompt of 16
tokens, which 'model' divides, or of 13, whose rows are padded to 16 (a
rank runs 4 of them), then a few decode steps.  With ``window`` 8 the
cache is the ring (the windowed prefill writes each rank's slots) and
the steps wrap it; with ``window`` 32 it is the whole cache of 20 slots
(the prefill attends over it at ``q_offset`` 0, ``kv_valid`` its
length).  The kv-group case has 6 q and 2 kv heads: each kv head goes to
2 ranks, which split its rows.  Runners and tolerances are
``tests/sharded_families.py``'s (``check_layout``: 4 gloo ranks against
the reference on 4 host devices and against one device, at ``TOL``),
and rank 0's attention must run its share of one device's (row, head,
key) triples in each step: a quarter, the prefill's rows rounded up to
whole shares of a chunk (``sf.row_share``).

The row split's padding over several q chunks, with and without a
gradient, is held on plain tensors too: the shares of ``_own_rows``
summed over the ranks are ``flash_attention``'s output and gradients.

Run alone: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_attention_split.py``; this file is the reference's
subprocess too (``python tests/test_torch_attention_split.py
reference-layout ...``).
"""
from __future__ import annotations

import sys
from fractions import Fraction
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent))
import sharded_families as sf  # noqa: E402

HEADS = {"n_layers": 5, "n_heads": 6, "n_kv_heads": 1}
KV_GROUP = {"n_layers": 5, "n_heads": 6, "n_kv_heads": 2}
SERVE = (1, 10)  # a prompt of one token, then 10 decode steps
QUARTER = Fraction(1, 4)
# (window, (prompt, decode steps), rank 0's share of each step's triples)
CASES = {
    "ring": (8, SERVE, 4),
    "whole-cache": (32, SERVE, 4),
    "ring-prefill-16": (8, (16, 2), 4),
    "whole-cache-prefill-13": (32, (13, 4), {
        "prefill": sf.row_share(13, 4), "decode": QUARTER,
        "train": QUARTER}),
}


@pytest.mark.parametrize("window,serve,split", list(CASES.values()),
                         ids=list(CASES))
def test_unsplit_heads_split_rows_and_keys_as_on_one_device(
        tmp_path, window, serve, split):
    sf.check_layout(HERE, tmp_path, "hybrid", (1, 4), "tp_fsdp", sf.BATCH,
                    serve=serve, split=split, window=window, **HEADS)


def test_kv_group_prefill_splits_rows_as_on_one_device(tmp_path):
    """6 q and 2 kv heads over (1, 4): rank 0 runs its kv head's 3 q heads
    on its half of the rows of a 13-token prefill (7 of 13, padded) and of
    a train step, and the whole group halved in a decode step."""
    sf.check_layout(HERE, tmp_path, "hybrid", (1, 4), "tp_fsdp", sf.BATCH,
                    serve=(13, 2), window=8, split={
                        "prefill": sf.row_share(13, 2) / 2,
                        "decode": Fraction(1, 2), "train": QUARTER},
                    **KV_GROUP)


@pytest.mark.parametrize("Sq,q_chunk,parts", [(21, 8, 3), (40, 16, 4)],
                         ids=["ragged-shares", "ragged-last-chunk"])
def test_row_shares_sum_to_the_attention(Sq, q_chunk, parts):
    """``_own_rows``'s shares over ``parts`` ranks, each chunk's rows and
    the last chunk padded, sum to ``flash_attention``'s output, and their
    gradients of q, k and v to its gradients."""
    from repro_torch.models import layers

    g = torch.Generator().manual_seed(0)
    B, Hq, Hkv, Dh, Sk = 2, 4, 2, 8, Sq
    q, k, v = (torch.randn(B, S, H, Dh, generator=g).requires_grad_()
               for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
    dout = torch.randn(B, Sq, Hq, Dh, generator=g)
    kw = dict(causal=True, window=7, q_chunk=q_chunk, kv_chunk=8)
    want = layers.flash_attention(q, k, v, **kw)
    want_g = torch.autograd.grad(want, (q, k, v), dout)
    got = sum(layers._own_rows(q, k, v, part=p, parts=parts, **kw)
              for p in range(parts))
    got_g = torch.autograd.grad(got, (q, k, v), dout)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    sf.main(sys.argv)
