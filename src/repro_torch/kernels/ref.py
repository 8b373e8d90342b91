"""Plain PyTorch oracles for the kernels (counterparts of repro.kernels.ref).

Both compute in f32 and cast back to the input dtype.  On the card they run
with ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default,
set here explicitly), so an f32 product is a full-precision one.
"""
from __future__ import annotations

import math

import torch


def _no_tf32(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _no_tf32(a)
    return (a.float() @ b.float()).to(a.dtype)


def attention_ref(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q: (B,Sq,Hq,Dh); k/v: (B,Sk,Hkv,Dh)."""
    _no_tf32(q)
    B, Sq, Hq, Dh = q.shape
    _, Sk, Hkv, _ = k.shape
    rep = Hq // Hkv
    kk = k.repeat_interleave(rep, dim=2).float()
    vv = v.repeat_interleave(rep, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk)
    s = s / math.sqrt(Dh)
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask[None, None], s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    return out.to(q.dtype)
