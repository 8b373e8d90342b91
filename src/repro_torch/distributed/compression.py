"""int8 gradient compression with error feedback, on torch tensors.

Port of ``repro.distributed.compression``.  Gradients are blockwise
quantized to int8 with a per-block f32 scale before the all-reduce (4x
wire-format reduction), dequantized after, and the quantization residual is
fed back into the next step's gradient (error feedback keeps SGD
convergence unbiased in the long run).

Usage (composes with any optimizer):

    carry = init_error_feedback(grads_like)
    grads_c, carry = compress_decompress(grads, carry)   # inside train_step

The quantize -> all-reduce -> dequantize collective form is
``quantized_psum``, over a ``torch.distributed`` process group.  It keeps
the reference's formula as written: the summed codes and the summed scales
are each divided by the group's size, so at world size n it returns about
the participants' mean, not their sum (the two agree at n = 1).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.lm import tree_leaves, tree_map, tree_unflatten

BLOCK = 256


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes (blocks, BLOCK) and f32 scales (blocks, 1) of ``x``
    flattened and zero-padded to whole blocks.  The scale is a block's
    max |x| / 127, at least 1e-12; ``torch.round`` rounds half to even, as
    ``jnp.round`` does.  Every division is IEEE division by a tensor, so
    codes and scales are JAX's bit for bit on either device."""
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds differently from JAX's division
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / \
        torch.full((), 127.0, device=x.device)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def init_error_feedback(grads_like):
    """Zero f32 residuals beside every leaf of ``grads_like``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compress_decompress(grads, error_carry):
    """Simulate the int8 wire format (with error feedback) for each leaf.

    Returns (dequantized grads, new error carry), each in ``grads``'
    structure.  On the wire this is the exact tensor the all-reduce would
    move; composing with the sum is linear, so quantize -> reduce ->
    dequantize == reduce(quantize -> dequantize) up to the per-participant
    scales (see ``quantized_psum``).
    """
    deq, new_e = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(error_carry)):
        x = g.float() + e
        q, s = _quant(x)
        d = _dequant(q, s, g.shape)
        deq.append(d.to(g.dtype))
        new_e.append(x - d)
    return tree_unflatten(grads, deq), tree_unflatten(error_carry, new_e)


def quantized_psum(x: torch.Tensor, group) -> torch.Tensor:
    """int8-wire all-reduce over ``group`` (a ``torch.distributed``
    process group): each participant quantizes, the int32-accumulated sum
    of the codes is dequantized by the summed scales, each divided by the
    group's size as the reference divides them.  Raises RuntimeError
    without an initialised process group."""
    if not dist.is_initialized():
        raise RuntimeError("quantized_psum needs an initialised "
                           "torch.distributed process group")
    q, s = _quant(x)
    qsum = q.to(torch.int32)
    ssum = s.clone()
    dist.all_reduce(qsum, group=group)
    dist.all_reduce(ssum, group=group)
    n = torch.full((), float(dist.get_world_size(group)), device=x.device)
    return _dequant(qsum.float() / n * 1.0, ssum / n, x.shape)
