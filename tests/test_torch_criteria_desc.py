"""The criteria kernel's description and tile plan on the CPU.

``repro_torch.kernels.criteria.pack`` builds, with numpy, the bytes that
``csrc/criteria.cu`` stages into shared memory.  Here those bytes are held
against a description built straightforwardly, term by term, from the
criteria list each reference ``CriteriaKernel`` was made from, on the
kernels that the fused QK -> AV search and a 64^3 matmul search meet on
the TPU-v4i preset and on hand-made ones; every section is 16-byte aligned;
the host's tile plan fits the card's shared memory or raises; and the plain
version, which decodes the same bytes, equals numpy bit for bit at an odd
column count.  The kernel against the plain version is in
``tests/test_torch_kernels_cuda.py`` (on the card).
"""
import itertools
import pathlib
import re

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import fusion as ref_fusion
from repro.core import mapper as ref_mapper
from repro.core import search as ref_search
from repro.core import symbolic as ref_symbolic
from repro.core.presets import tpu_v4i_like
from repro_torch.kernels import criteria as C

# hand-made criteria: exponents 2-5 and -1, an empty criterion, a
# constant term, a negative coefficient, columns read out of order
CRITS = [((2.0, (("a", 1),)), (3.0, (("b", 2),))),
         (),
         ((1.5, ()), (0.5, (("a", 3), ("b", 1)))),
         ((1.0, (("c", 4),)), (-2.0, (("a", 5), ("c", 1))),
          (0.25, (("a", 1), ("b", 1), ("c", 2)))),
         ((1.0, (("b", -1),)), (4.0, (("a", 2), ("c", -1)))),
         ((7.0, (("e", 1), ("a", 2))),)]
INDEX = {"a": 0, "b": 1, "c": 2, "d": 3, "e": 4}  # 5 columns: an odd width


def _attention_pair():
    """``tests/test_fusion.py``'s QK -> AV pair."""
    qk = R.batched_matmul("qk", 8, 4, 32, 64)
    av = R.batched_matmul("av", 8, 4, 64, 32)
    return ref_fusion.FusedWorkload("qk+av", (qk, av),
                                    (ref_fusion.GroupEdge(0, 1, "Z", "A"),))


def _made_by(search):
    """(kernel, criteria list, index) of every reference kernel that
    ``search`` makes and calls, the search's caches cleared first."""
    made, called = {}, {}
    init, call = (ref_symbolic.CriteriaKernel.__init__,
                  ref_symbolic.CriteriaKernel.__call__)

    def rec_init(self, crits, index):
        made[id(self)] = (self, crits, index)
        init(self, crits, index)

    def rec_call(self, cols):
        called[id(self)] = self
        return call(self, cols)

    ref_search.clear_search_caches()
    ref_symbolic.CriteriaKernel.__init__ = rec_init
    ref_symbolic.CriteriaKernel.__call__ = rec_call
    try:
        search()
    finally:
        ref_symbolic.CriteriaKernel.__init__ = init
        ref_symbolic.CriteriaKernel.__call__ = call
        ref_search.clear_search_caches()
    assert called and called.keys() <= made.keys()
    return [made[k] for k in called]


@pytest.fixture(scope="module")
def kernels():
    arch = tpu_v4i_like()
    return {
        "fused_qk_av": _made_by(lambda: ref_mapper.tcm_map_group(
            _attention_pair(), arch)),
        "matmul_tpu_v4i": _made_by(
            lambda: R.tcm_map(R.matmul("mm", 64, 64, 64), arch)),
        "hand_made": [(ref_symbolic.CriteriaKernel(CRITS, INDEX), CRITS,
                       INDEX)]}


SOURCES = ["fused_qk_av", "matmul_tpu_v4i", "hand_made"]


def _section(values, dtype) -> bytes:
    raw = np.asarray(values, dtype=dtype).tobytes()
    return raw + bytes(-len(raw) % 16)


def straightforward(crits, index) -> bytes:
    """The description term by term from a criteria list: factors in the
    order first met, terms sorted stably by factor count, each slot's cut
    and factor ids, each criterion's sorted term rows in its order."""
    factor_id, factors, terms, crit_terms = {}, [], [], []
    for crit in crits:
        crit_terms.append([])
        for coeff, powers in crit:
            fids = []
            for s, e in powers:
                if (index[s], e) not in factor_id:
                    factor_id[(index[s], e)] = len(factors)
                    factors.append((index[s], e))
                fids.append(factor_id[(index[s], e)])
            crit_terms[-1].append(len(terms))
            terms.append((coeff, fids))
    perm = sorted(range(len(terms)), key=lambda t: len(terms[t][1]))
    row_of = {t: r for r, t in enumerate(perm)}
    rows = [terms[t] for t in perm]
    slots = []
    for q in range(1, max((len(f) for _, f in rows), default=0)):
        cut = next(r for r, (_, f) in enumerate(rows) if len(f) > q)
        slots.append((cut, [f[q] for _, f in rows[cut:]]))
    offs = list(itertools.accumulate(
        [len(f) for _, f in slots], initial=0))[:-1]
    sections = [
        _section([v for fac in factors for v in fac], np.int32),
        _section([v for (cut, _), off in zip(slots, offs)
                  for v in (cut, off)], np.int32),
        _section([coeff for coeff, _ in rows], np.float64),
        _section([f[0] if f else len(factors) for _, f in rows], np.int32),
        _section([v for _, fids in slots for v in fids], np.int32),
        _section([0] + list(itertools.accumulate(map(len, crit_terms))),
                 np.int32),
        _section([row_of[t] for ts in crit_terms for t in ts], np.int32)]
    at = list(itertools.accumulate(map(len, sections), initial=64))
    head = [at[-1], len(factors), len(terms), len(crits),
            1 + max((c for c, _ in factors), default=-1), len(slots)]
    head = _section(head + at[:-1], np.int32)
    return head + bytes(64 - len(head)) + b"".join(sections)


@pytest.mark.parametrize("source", SOURCES)
def test_pack_is_the_straightforward_description(kernels, source):
    assert kernels[source]
    for kernel, crits, index in kernels[source]:
        c = C.pack(kernel, "cpu")
        assert c.desc.tobytes() == straightforward(crits, index)
        assert (c.n_crits, c.n_terms) == (len(crits), sum(map(len, crits)))


@pytest.mark.parametrize("source", SOURCES)
def test_sections_are_16_byte_aligned(kernels, source):
    for kernel, _, _ in kernels[source]:
        desc = C.pack(kernel, "cpu").desc
        d = C.decode(desc)
        assert d["bytes"] == desc.nbytes and desc.nbytes % 16 == 0
        offsets = [desc[:64].view(np.int32)[C.HEADER.index(name)]
                   for name in C.HEADER[6:]]
        assert offsets[0] == C.HEADER_BYTES
        assert all(at % 16 == 0 for at in offsets)
        assert offsets == sorted(offsets) and offsets[-1] <= desc.nbytes
        # the sections end where the next begins, padded to 16 bytes
        ends = [a + d[name].nbytes
                for a, name in zip(offsets, C.HEADER[6:])]
        assert all(0 <= b - e < 16 for e, b in zip(
            ends, offsets[1:] + [desc.nbytes]))


@pytest.mark.parametrize("source", SOURCES)
def test_tile_plan_fits_the_card(kernels, source):
    for kernel, _, _ in kernels[source]:
        c = C.pack(kernel, "cpu")
        items = max(c.n_factors + 1, c.n_terms, c.n_crits)
        for n_syms in (c.n_cols, c.n_cols + 1, 39):
            for n in (1, 3, 89, 528, 529, 1024, 15298, 20000, 70001):
                rows, threads, smem = C.tile_plan(c, n, n_syms)
                assert smem == C.smem_bytes(c, rows, n_syms) <= C.SMEM_MAX
                assert rows & (rows - 1) == 0 and rows < 2 * n
                assert threads % 32 == 0
                assert threads == min(C.MAX_THREADS,
                                      max(32, -(-items * rows // 32) * 32))
                blocks = -(-n // rows)
                if n <= C.SMS * C.BLOCKS_PER_SM:
                    assert rows == min(C.MIN_ROWS, 1 << (n - 1).bit_length())
                else:  # enough blocks for every SM, a few each
                    assert C.SMS <= blocks <= 2 * C.SMS * C.BLOCKS_PER_SM


def test_largest_description_met_and_its_plan(kernels):
    descs = [C.pack(k, "cpu") for src in ("fused_qk_av", "matmul_tpu_v4i")
             for k, _, _ in kernels[src]]
    c = max(descs, key=lambda c: c.desc.nbytes)
    assert c.desc.nbytes < 8192  # a few KB against 227 KB
    rows, _, smem = C.tile_plan(c, 20000, c.n_cols)
    assert rows < 64 and smem < 64 * 1024


def test_a_description_past_shared_memory_raises():
    many = [((1.0, (("a", 1),)),)] * 12000  # ~240 KB of description
    kernel = ref_symbolic.CriteriaKernel(many, {"a": 0})
    with pytest.raises(ValueError, match=r"shared memory.*232448 B"):
        C.pack(kernel, "cpu")
    c = C.pack(ref_symbolic.CriteriaKernel(CRITS, INDEX), "cpu")
    C.tile_plan(c, 1, 20000)
    with pytest.raises(ValueError, match=r"one row of 40000 columns"):
        C.tile_plan(c, 1, 40000)


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float64).view(np.uint64)


@pytest.mark.parametrize("n", [0, 1, 7, 300])
def test_plain_is_numpy_at_an_odd_width(n):
    kernel = ref_symbolic.CriteriaKernel(CRITS, INDEX)
    cols = np.random.default_rng(n).integers(
        1, 1001, size=(n, len(INDEX))).astype(np.float64)
    c = C.pack(kernel, "cpu")
    got = C.criteria_plain(c, torch.from_numpy(cols)).numpy()
    assert got.shape == (n, len(CRITS))
    np.testing.assert_array_equal(_bits(got), _bits(kernel(cols)))
    np.testing.assert_array_equal(_bits(C.evaluate(c, cols)),
                                  _bits(kernel(cols)))


def test_plain_reads_the_description_bytes():
    kernel = ref_symbolic.CriteriaKernel(CRITS, INDEX)
    cols = np.arange(1.0, 16.0).reshape(3, 5)
    c = C.pack(kernel, "cpu")
    d = C.decode(c.desc)
    d["coeff"][:] *= 2.0  # a view of the bytes: every term doubles
    got = C.criteria_plain(c, torch.from_numpy(cols)).numpy()
    np.testing.assert_array_equal(got, 2.0 * kernel(cols))


def test_the_kernel_reads_the_header_in_this_order():
    src = (pathlib.Path(C.__file__).parent / "csrc" / "criteria.cu"
           ).read_text()
    body = re.search(r"enum Header \{(.*?)\};", src, re.S).group(1)
    names = [re.sub(r"(?<!^)(?=[A-Z])", "_", k).lower()
             for k in re.findall(r"k(\w+)", body)]
    assert names == [h.removeprefix("n_") for h in C.HEADER]
    assert 4 * len(C.HEADER) <= C.HEADER_BYTES
