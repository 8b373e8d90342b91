"""The mapper's criteria evaluation on the card: the hand-written CUDA kernel
and its plain PyTorch version.

Replaces the reference's ``TCM_JIT`` route, a ``jax.jit`` of the packed
evaluation of a ``CriteriaKernel`` (``CriteriaKernel._call_jit`` in
``repro/core/symbolic.py``), not a Pallas kernel.  ``pack`` turns a
``core.symbolic.CriteriaKernel`` into its description, the bytes the
kernel stages into shared memory (``describe``; nothing goes to the card
yet); ``criteria_cuda`` launches ``csrc/criteria.cu`` on columns on the
card; ``criteria_plain`` decodes the same bytes (``decode``) and computes
in the kernel's order with torch ops over all rows at once, and serves the
CPU and the on-card comparison; ``evaluate`` is what the search calls:
numpy columns in, numpy criteria out, through one pinned round trip on the
card (``tcm_criteria_eval``: one copy in, the launch, one copy out, one
synchronisation), its buffers owned by the calling thread.  Both versions
equal numpy bit for bit wherever each factor's exact power is
representable in f64 (numpy takes a power of 3 or more from libm's
``pow``, these two from repeated products).  A CUDA description launches
the kernel or raises: there is no fallback to numpy.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from . import build

# The description: a header of int32 words (csrc/criteria.cu's ``Header``),
# then its sections, each at a 16-byte aligned offset, the whole padded to
# a multiple of 16 bytes.  It keeps numpy's packing: factor f is
# fac[2f] ** fac[2f + 1] (column, exponent), and the id n_factors is the
# constant 1.0 of a term with no factor; term rows are sorted (stably) by
# factor count, row t is coeff[t] * F[fid0[t]], then times
# F[slot_fac[slot[2q + 1] + t - slot[2q]]] for each slot q whose cut
# slot[2q] <= t; criterion j sums rows crit_term[crit_ptr[j]:
# crit_ptr[j + 1]] in order.
HEADER = ("bytes", "n_factors", "n_terms", "n_crits", "n_cols", "n_slots",
          "fac", "slot", "coeff", "fid0", "slot_fac", "crit_ptr",
          "crit_term")
HEADER_BYTES = 64
# The tile plan: a block's shared memory on sm_90, the H100's SMs, the
# blocks a large call aims at per SM, the rows a block takes at least, and
# the most threads a block has (csrc/criteria.cu's kMaxThreads)
SMEM_MAX = 232448
SMS = 132
BLOCKS_PER_SM = 4
MIN_ROWS = 4
MAX_THREADS = 256


@dataclass(eq=False)
class Criteria:
    """A ``CriteriaKernel``'s description, for one device.

    ``desc`` holds the bytes (see ``HEADER``); the device copy that
    ``criteria_cuda`` reads and the plain version's index tensors are made
    on first use and kept in ``made``.
    """

    asked: str  # the device as the caller named it
    device: torch.device
    n_crits: int
    n_cols: int  # columns the factors read
    n_factors: int
    n_terms: int
    ops_per_row: int  # f64 operations numpy's evaluation does for one row
    desc: np.ndarray  # uint8
    made: Dict[object, object] = field(default_factory=dict)


def _needs_card(device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the criteria route (TCM_JIT) runs on a CUDA card (an H100) and "
            "torch finds none here; unset TCM_JIT, or call "
            "set_jit(True, device='cpu') for its plain version")


def _align(nbytes: int) -> int:
    return (nbytes + 15) & ~15


def _words(n: int) -> int:
    """``n`` int32 words padded to a multiple of 16 bytes."""
    return (n + 3) // 4 * 4


def describe(kernel) -> tuple:
    """The description of ``kernel`` (a ``core.symbolic.CriteriaKernel``),
    built with numpy from its packed attributes: (its bytes, (factors,
    terms, criteria, columns read, f64 operations numpy's evaluation does
    for one row))."""
    factors, slots, acc = kernel._factors, kernel._slots, kernel._acc_groups
    nf, nt, nc = len(factors), len(kernel._coeff_flat), kernel.n_crits
    cuts = [int(cut) for cut, _ in slots]
    offs = list(itertools.accumulate((nt - cut for cut in cuts), initial=0))
    sizes = (("fac", 2 * nf), ("slot", 2 * len(cuts)), ("coeff", 2 * nt),
             ("fid0", nt), ("slot_fac", offs.pop()), ("crit_ptr", nc + 1),
             ("crit_term", nt))
    at, end = {}, HEADER_BYTES // 4
    for name, n in sizes:
        at[name], end = end, end + _words(n)
    desc = np.zeros(4 * end, dtype=np.uint8)
    w = desc.view(np.int32)
    # the header and the sections of Python ints, in one assignment
    n_cols = max(factors)[0] + 1 if nf else 0
    head = [4 * end, nf, nt, nc, n_cols, len(cuts)]
    head += [4 * at[name] for name, _ in sizes]
    lead = (head + [0] * (at["fac"] - len(head))
            + list(itertools.chain.from_iterable(factors))
            + [0] * (at["slot"] - at["fac"] - 2 * nf)
            + list(itertools.chain.from_iterable(zip(cuts, offs))))
    w[:len(lead)] = lead
    desc.view(np.float64)[at["coeff"] // 2:][:nt] = kernel._coeff_flat
    w[at["fid0"]:][:nt] = kernel._fid0
    if slots:
        np.concatenate([f for _, f in slots],
                       out=w[at["slot_fac"]:][:sizes[4][1]])
    if nt:  # criterion by criterion, each one's term rows in order
        full = [(k, js, idx) for k, js, idx in acc if k]
        owner = np.concatenate([js for _, js, _ in full]).repeat(
            [k for k, js, _ in full for _ in range(len(js))])
        flat = np.concatenate([idx.ravel() for _, _, idx in full])
        w[at["crit_term"]:][:nt] = flat[np.argsort(owner, kind="stable")]
        np.cumsum(np.bincount(owner, minlength=nc),
                  out=w[at["crit_ptr"] + 1:][:nc])
    ops = (sum(len(rows) * (max(abs(e) - 1, 0) + (e < 0))
               for e, rows, _ in kernel._factor_groups)
           + nt + sizes[4][1]
           + sum((k - 1) * len(js) for k, js, _ in acc if k))
    return desc, (nf, nt, nc, n_cols, int(ops))


def decode(desc: np.ndarray) -> Dict[str, object]:
    """The header's words and each section as a numpy view of ``desc``."""
    w = desc.view(np.int32)
    head = dict(zip(HEADER, w[:len(HEADER)].tolist()))
    nf, nt, nc, ns = (head[k] for k in ("n_factors", "n_terms", "n_crits",
                                        "n_slots"))
    for name, n in (("fac", 2 * nf), ("slot", 2 * ns), ("coeff", 2 * nt),
                    ("fid0", nt), ("crit_ptr", nc + 1), ("crit_term", nt)):
        head[name] = w[head[name] // 4:][:n]
    head["fac"], head["slot"] = (head[k].reshape(-1, 2)
                                 for k in ("fac", "slot"))
    head["coeff"] = head["coeff"].view(np.float64)
    head["slot_fac"] = w[head["slot_fac"] // 4:][:int(
        (nt - head["slot"][:, 0]).sum())]
    return head


def pack(kernel, device="cuda") -> Criteria:
    """The description of ``kernel`` for ``device``; raises if it does not
    fit a block's shared memory with one row of its columns."""
    asked, device = str(device), torch.device(device)
    _needs_card(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    desc, (nf, nt, nc, n_cols, ops) = describe(kernel)
    c = Criteria(asked=asked, device=device, n_crits=nc, n_cols=n_cols,
                 n_factors=nf, n_terms=nt, ops_per_row=ops, desc=desc)
    tile_plan(c, 1, n_cols)
    return c


def smem_bytes(c: Criteria, rows: int, n_syms: int) -> int:
    """A block's shared memory for ``rows`` rows of ``n_syms`` columns (as
    csrc/criteria.cu carves it): the mbarrier, the description, the staged
    rows (8 bytes more, to keep a tile's 16-byte span aligned), F, T and
    the criteria, and each term's factor count."""
    return (16 + c.desc.nbytes + _align(8 * rows * n_syms + 8)
            + 8 * rows * (c.n_factors + 1 + c.n_terms + c.n_crits)
            + 4 * c.n_terms)


def _pow2_floor(x: int) -> int:
    return 1 << (x.bit_length() - 1)


def _most_rows(c: Criteria, n_syms: int) -> int:
    """The most rows (a power of two) whose tile fits a block, for rows of
    ``n_syms`` columns (kept per width); raises when not even one does."""
    key = ("most", n_syms)
    if key not in c.made:
        per_row = 8 * (n_syms + c.n_factors + 1 + c.n_terms + c.n_crits)
        most = (SMEM_MAX - 32 - c.desc.nbytes - 4 * c.n_terms) // per_row
        if smem_bytes(c, most + 1, n_syms) <= SMEM_MAX:
            most += 1
        if most < 1:
            raise ValueError(
                f"the criteria description ({c.desc.nbytes} B, {c.n_terms} "
                f"terms, {c.n_factors} factors) and one row of {n_syms} "
                f"columns need {smem_bytes(c, 1, n_syms)} B of shared "
                f"memory, more than the {SMEM_MAX} B a block has on the card")
        c.made[key] = _pow2_floor(most)
    return c.made[key]


def tile_plan(c: Criteria, n: int, n_syms: int) -> Tuple[int, int, int]:
    """(R, threads, shared-memory bytes) of a block for a call of ``n`` rows
    of ``n_syms`` columns.  R is a power of two (the kernel indexes a row
    with a shift and a mask): the largest one within ``n`` over
    ``BLOCKS_PER_SM`` blocks per SM, at least ``MIN_ROWS``, at most what
    ``n`` needs and what fits; a block has a thread for each item (factor,
    term or criterion) of each of its rows, in whole warps, up to
    ``MAX_THREADS``.  Raises when not even one row fits."""
    rows = max(_pow2_floor(-(-n // (SMS * BLOCKS_PER_SM))), MIN_ROWS)
    rows = min(rows, 1 << (n - 1).bit_length(), _most_rows(c, n_syms))
    items = max(c.n_factors + 1, c.n_terms, c.n_crits) * rows
    threads = min(MAX_THREADS, max(32, -(-items // 32) * 32))
    return rows, threads, smem_bytes(c, rows, n_syms)


def _plain_layout(c: Criteria, device: torch.device) -> tuple:
    """The description decoded into tensors on ``device`` (made on first
    use): factors grouped by exponent, the coefficients and first factors,
    per slot its cut and factor ids, per term position the criteria that
    have one there and its term rows."""
    key = ("plain", device)
    if key not in c.made:
        d = decode(c.desc)

        def on(x, dtype=torch.int64):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        col, exp = d["fac"].T
        groups = tuple((int(e), on(np.flatnonzero(exp == e)),
                        on(col[exp == e])) for e in np.unique(exp))
        fac = d["slot_fac"]
        slots = tuple((int(cut), on(fac[off:off + c.n_terms - cut]))
                      for cut, off in d["slot"])
        ptr, term = d["crit_ptr"].astype(np.int64), d["crit_term"]
        lens = np.diff(ptr)
        sums = tuple((on(j), on(term[ptr[j] + q])) for q in range(
            lens.max(initial=0)) for j in [np.flatnonzero(lens > q)])
        c.made[key] = (groups, on(d["coeff"], torch.float64), on(d["fid0"]),
                       slots, sums)
    return c.made[key]


def _check(c: Criteria, cols: torch.Tensor) -> None:
    if cols.ndim != 2 or cols.dtype != torch.float64:
        raise TypeError(f"criteria take (n, n_cols) f64 columns, got "
                        f"{tuple(cols.shape)} {cols.dtype}")
    if cols.shape[1] < c.n_cols:
        raise ValueError(f"the criteria read {c.n_cols} columns, got "
                         f"{cols.shape[1]}")
    if cols.device != c.device:
        raise ValueError(f"columns on {cols.device}, description on "
                         f"{c.device}")


def power(x: torch.Tensor, e: int) -> torch.Tensor:
    """``x ** e`` as the kernel computes it: the column itself for 1,
    ``x * x`` for 2 (numpy's square), repeated products above, one over
    the power for a negative ``e`` (numpy's reciprocal for -1)."""
    if e == 1:
        return x
    p = x
    for _ in range(abs(e) - 1):
        p = p * x
    return 1.0 / p if e < 0 else p


def criteria_plain(c: Criteria, cols: torch.Tensor) -> torch.Tensor:
    """cols (n, n_cols) f64 -> (n, n_crits) f64: the description's
    evaluation in the kernel's order per scalar, in torch ops over all rows
    at once (each factor once, each term's product left to right from its
    coefficient, each criterion's terms summed in order): numpy's packed
    evaluation (``CriteriaKernel.__call__``) read from the bytes the
    kernel reads."""
    _check(c, cols)
    n = cols.shape[0]
    if c.n_crits == 0:
        return cols.new_empty((n, 0))
    groups, coeff, fid0, slots, sums = _plain_layout(c, cols.device)
    F = cols.new_empty((c.n_factors + 1, n))
    for e, fids, cis in groups:
        F[fids] = power(cols.T[cis], e)
    F[c.n_factors] = 1.0
    T = coeff[:, None] * F[fid0]
    for cut, fids in slots:
        T[cut:] *= F[fids]
    outT = cols.new_zeros((c.n_crits, n))
    for q, (js, terms) in enumerate(sums):
        outT[js] = T[terms] if q == 0 else outT[js] + T[terms]
    return outT.T


def _lib():
    try:
        return build.lib()
    except RuntimeError as e:
        raise RuntimeError(f"the criteria kernel for the CUDA card did not "
                           f"build: {e}") from e


def _device_desc(c: Criteria) -> torch.Tensor:
    """The description on the card, uploaded on first use."""
    if "desc" not in c.made:
        c.made["desc"] = torch.from_numpy(c.desc).to(c.device)
    return c.made["desc"]


def criteria_cuda(c: Criteria, cols: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/criteria.cu`` on contiguous CUDA columns; raises on
    anything else.  n = 0 or no criteria launches nothing."""
    _check(c, cols)
    if not cols.is_cuda:
        raise ValueError("criteria_cuda takes columns on a CUDA device")
    if not cols.is_contiguous():
        raise ValueError("criteria_cuda takes contiguous row-major columns")
    n, n_syms = cols.shape
    out = torch.empty((n, c.n_crits), dtype=torch.float64, device=c.device)
    if out.numel() == 0:
        return out
    rows, threads, _ = tile_plan(c, n, n_syms)
    lib = _lib()
    desc = _device_desc(c)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.tcm_criteria_launch(
            desc.data_ptr(), desc.numel(), c.n_factors, c.n_terms,
            c.n_crits, cols.data_ptr(), n, n_syms, rows.bit_length() - 1,
            threads, out.data_ptr(), stream)
    build.check(code, "criteria kernel on the CUDA card")
    criteria_cuda.launches += 1
    return out


criteria_cuda.launches = 0


class _Staging:
    """One thread's buffers on one card: pinned host memory for the
    description and columns going in and the criteria coming out, and
    their device twins, grown geometrically."""

    def __init__(self, device: torch.device):
        self.device, self.n_in, self.n_out = device, 0, 0
        self.desc_of = None  # the Criteria whose bytes lead ``host_in``

    def reserve(self, n_in: int, n_out: int) -> None:
        if n_in <= self.n_in and n_out <= self.n_out:
            return
        if n_in > self.n_in:
            self.n_in = max(n_in, 2 * self.n_in, 1 << 16)
            self.host_in = torch.empty(self.n_in, dtype=torch.uint8,
                                       pin_memory=True)
            self.dev_in = torch.empty(self.n_in, dtype=torch.uint8,
                                      device=self.device)
            self.host_in_np = self.host_in.numpy()
            self.host_in_f64 = self.host_in_np.view(np.float64)
            self.desc_of = None
        if n_out > self.n_out:
            self.n_out = max(n_out, 2 * self.n_out, 1 << 16)
            self.host_out = torch.empty(self.n_out, dtype=torch.uint8,
                                        pin_memory=True)
            self.dev_out = torch.empty(self.n_out, dtype=torch.uint8,
                                       device=self.device)
            self.host_out_f64 = self.host_out.numpy().view(np.float64)
        self.ptrs = (self.host_in.data_ptr(), self.dev_in.data_ptr(),
                     self.dev_out.data_ptr(), self.host_out.data_ptr())


_local = threading.local()


def staging(device: torch.device) -> _Staging:
    """The calling thread's buffers on ``device``."""
    bufs = _local.__dict__.setdefault("bufs", {})
    if device not in bufs:
        bufs[device] = _Staging(device)
    return bufs[device]


def _round_trip(c: Criteria, cols: np.ndarray) -> np.ndarray:
    if cols.ndim != 2 or cols.shape[1] < c.n_cols:
        raise ValueError(f"the criteria read {c.n_cols} columns, got shape "
                         f"{cols.shape}")
    n, n_syms = cols.shape
    if n == 0 or c.n_crits == 0:
        return np.empty((n, c.n_crits))
    rows, threads, _ = tile_plan(c, n, n_syms)
    lib = _lib()
    st = staging(c.device)
    d = c.desc.nbytes
    n_in, n_out = d + 8 * n * n_syms, 8 * n * c.n_crits
    st.reserve(n_in, n_out)
    if st.desc_of is not c:
        st.host_in_np[:d] = c.desc
        st.desc_of = c
    np.copyto(st.host_in_f64[d // 8:n_in // 8].reshape(n, n_syms), cols)
    host_in, dev_in, dev_out, host_out = st.ptrs
    # the raw handle of the caller's current stream (torch.cuda.
    # current_stream builds a Stream object: ~3.5 us a call on the H100's
    # host, a tenth of the call)
    code = lib.tcm_criteria_eval(
        c.device.index, host_in, dev_in, n_in, d, c.n_factors, c.n_terms,
        c.n_crits, n, n_syms, rows.bit_length() - 1, threads, dev_out,
        host_out, torch._C._cuda_getCurrentRawStream(c.device.index))
    build.check(code, "criteria kernel on the CUDA card")
    criteria_cuda.launches += 1
    return st.host_out_f64[:n_out // 8].reshape(n, c.n_crits).copy()


def evaluate(c: Criteria, cols: np.ndarray) -> np.ndarray:
    """The search's call: numpy f64 columns (n, n_cols) in, the criteria
    (n, n_crits) back as numpy; the plain version on the CPU, the kernel's
    pinned round trip on a CUDA device."""
    if cols.dtype != np.float64:
        raise TypeError(f"criteria take f64 columns, got {cols.dtype}")
    if c.device.type == "cpu":
        return criteria_plain(
            c, torch.from_numpy(np.ascontiguousarray(cols))).numpy()
    return _round_trip(c, cols)
