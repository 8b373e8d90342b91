"""The mapper's criteria evaluation on the card: the hand-written CUDA kernel
and its plain PyTorch version.

Replaces the reference's ``TCM_JIT`` route, a ``jax.jit`` of the packed
evaluation of a ``CriteriaKernel`` (``CriteriaKernel._call_jit`` in
``repro/core/symbolic.py``), not a Pallas kernel.  ``pack`` turns a
``core.symbolic.CriteriaKernel`` into its description on one device, once
per kernel; ``criteria_cuda`` launches ``csrc/criteria.cu`` on it;
``criteria_plain`` repeats numpy's packed evaluation
(``CriteriaKernel.__call__``) step by step in torch f64 ops, on numpy's
packing (moved to the device on its first call), and serves the CPU and
the on-card comparison; ``evaluate`` is what the search calls:
numpy columns in, numpy criteria out.  Both versions equal numpy bit for
bit wherever each factor's exact power is representable in f64 (numpy
takes a power of 3 or more from libm's ``pow``, these two from repeated
products).  A CUDA description launches the kernel or raises: there is no
fallback to numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import build


@dataclass(eq=False)
class Criteria:
    """A ``CriteriaKernel``'s packed description on one device.

    The kernel's, in CSR, in one buffer ``desc`` uploaded once: per term row
    its coefficient (f64, first) and factor ids, per criterion its term rows
    in order, per factor its column and exponent (the last factor is the
    constant 1.0, column -1), each int32 array at its byte offset in
    ``offsets``.  numpy's packing (``host``: factor groups, coefficients,
    first factor ids, slots, accumulation groups) goes to the device only
    when the plain version first runs (``_plain_layout``).
    """

    asked: str  # the device as the caller named it
    device: torch.device
    n_crits: int
    n_cols: int  # columns the factors read
    factors: Tuple[Tuple[int, int], ...]
    ops_per_row: int  # f64 operations numpy's evaluation does for one row
    desc: torch.Tensor  # uint8
    offsets: Dict[str, int]
    host: tuple
    plain: Optional[tuple] = None


_DESC = ("coeff", "fac_col", "fac_exp", "term_ptr", "term_fac", "crit_ptr",
         "crit_term")


def _needs_card(device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the criteria route (TCM_JIT) runs on a CUDA card (an H100) and "
            "torch finds none here; unset TCM_JIT, or call "
            "set_jit(True, device='cpu') for its plain version")


def pack(kernel, device="cuda") -> Criteria:
    """The description of ``kernel`` (a ``core.symbolic.CriteriaKernel``,
    read through its packed attributes) on ``device``: one copy to it."""
    asked, device = str(device), torch.device(device)
    _needs_card(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    factors = tuple((int(c), int(e)) for c, e in kernel._factors)
    terms = [[int(f)] for f in kernel._fid0]  # per sorted term row
    for cut, fids in kernel._slots:
        for row, f in zip(range(cut, len(terms)), fids):
            terms[row].append(int(f))
    crits = [[] for _ in range(kernel.n_crits)]
    for nt, js, idx in kernel._acc_groups:
        for j, rows in zip(js, idx if nt else ()):
            crits[int(j)] = [int(r) for r in rows]
    ops = (sum(abs(e) - 1 + (e < 0) for _, e in factors)
           + sum(map(len, terms)) + sum(max(len(c) - 1, 0) for c in crits))

    def flat(lists):
        return [v for x in lists for v in x]

    parts = [np.asarray(kernel._coeff_flat, dtype=np.float64)] + [
        np.asarray(x, dtype=np.int32) for x in (
            [c for c, _ in factors] + [-1], [e for _, e in factors] + [0],
            np.cumsum([0] + [len(t) for t in terms]), flat(terms),
            np.cumsum([0] + [len(c) for c in crits]), flat(crits))]
    offsets = np.cumsum([0] + [p.nbytes for p in parts])
    desc = torch.from_numpy(np.concatenate(
        [p.view(np.uint8) for p in parts])).to(device)
    return Criteria(
        asked=asked, device=device, n_crits=int(kernel.n_crits),
        n_cols=1 + max((c for c, _ in factors), default=-1),
        factors=factors, ops_per_row=int(ops), desc=desc,
        offsets=dict(zip(_DESC, map(int, offsets))),
        host=(kernel._factor_groups, kernel._coeff_flat, kernel._fid0,
              kernel._slots, kernel._acc_groups))


def _plain_layout(c: Criteria) -> tuple:
    """numpy's packing on the description's device, made on first use."""
    if c.plain is None:
        groups, coeff, fid0, slots, acc = c.host

        def ints(xs):
            return torch.as_tensor(np.asarray(xs), dtype=torch.int64,
                                   device=c.device)

        c.plain = (
            tuple((int(e), ints(rows), ints(cis)) for e, rows, cis in groups),
            torch.as_tensor(np.asarray(coeff, dtype=np.float64),
                            device=c.device),
            ints(fid0), tuple((int(cut), ints(f)) for cut, f in slots),
            tuple((int(nt), ints(js), ints(idx) if nt else None)
                  for nt, js, idx in acc))
    return c.plain


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
    """cols (n, n_cols) f64 -> (n, n_crits) f64, numpy's packed evaluation
    (``CriteriaKernel.__call__``) in torch ops, step for step."""
    _check(c, cols)
    n = cols.shape[0]
    if c.n_crits == 0:
        return cols.new_empty((n, 0))
    groups, coeff, fid0, slots, acc_groups = _plain_layout(c)
    nf = len(c.factors)
    F = cols.new_empty((nf + 1, n))
    for e, rows, cis in groups:
        F[rows] = power(cols.T[cis], e)
    F[nf] = 1.0
    T = coeff[:, None] * F[fid0]
    for cut, fids in slots:
        T[cut:] *= F[fids]
    outT = cols.new_empty((c.n_crits, n))
    for nt, js, idx in acc_groups:
        if nt == 0:
            outT[js] = 0.0
            continue
        acc = T[idx[:, 0]]  # advanced indexing copies
        for t in range(1, nt):
            acc += T[idx[:, t]]
        outT[js] = acc
    return outT.T


def _lib():
    try:
        return build.lib()
    except RuntimeError as e:
        raise RuntimeError(f"the criteria kernel for the CUDA card did not "
                           f"build: {e}") from e


def criteria_cuda(c: Criteria, cols: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/criteria.cu`` on contiguous CUDA columns; raises on
    anything else.  n = 0 or no criteria launches nothing."""
    _check(c, cols)
    if not cols.is_cuda:
        raise ValueError("criteria_cuda takes columns on a CUDA device")
    if not cols.is_contiguous():
        raise ValueError("criteria_cuda takes contiguous row-major columns")
    n = cols.shape[0]
    out = torch.empty((n, c.n_crits), dtype=torch.float64, device=c.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    at = {k: c.desc.data_ptr() + off for k, off in c.offsets.items()}
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.tcm_criteria_launch(
            cols.data_ptr(), n, cols.shape[1], at["fac_col"], at["fac_exp"],
            at["coeff"], at["term_ptr"], at["term_fac"], at["crit_ptr"],
            at["crit_term"], c.n_crits, out.data_ptr(), stream)
    build.check(code, "criteria kernel on the CUDA card")
    criteria_cuda.launches += 1
    return out


criteria_cuda.launches = 0


def evaluate(c: Criteria, cols: np.ndarray) -> np.ndarray:
    """The search's call: numpy f64 columns (n, n_cols) to the description's
    device, the criteria (n, n_crits) back as numpy; the plain version on
    the CPU, the kernel on a CUDA device."""
    if cols.dtype != np.float64:
        raise TypeError(f"criteria take f64 columns, got {cols.dtype}")
    x = torch.from_numpy(np.ascontiguousarray(cols)).to(c.device)
    fn = criteria_plain if x.device.type == "cpu" else criteria_cuda
    return fn(c, x).cpu().numpy()

