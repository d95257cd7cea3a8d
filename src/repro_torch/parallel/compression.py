"""Gradient compression: value-level lossy int8 quantization of gradients
(after ``repro.parallel.compression``, ``compress_tree`` and its helpers).

``compress_tree`` models the accuracy effect of an int8 all-reduce with one
f32 scale per block of 256 values.  ``compressed_psum`` is the collective
that moves it on the wire: quantize -> all-reduce int32 -> dequantize, over
one dim of a DeviceMesh (NCCL on the card, gloo on the CPU).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

BLOCK = 256


def _quant_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization of the flattened tensor."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % BLOCK))
    blocks = flat.reshape(-1, BLOCK).to(torch.float32)
    scale = torch.clamp(torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    out = (q.to(torch.float32) * scale).reshape(-1)
    return out[:math.prod(shape)].reshape(shape).to(dtype)


def compress_tree(grads: dict, method: str | None = "int8") -> dict:
    """Quantize-dequantize every gradient leaf of at least BLOCK values."""
    if method in (None, "none"):
        return grads
    if method != "int8":
        raise ValueError(f"unknown compression {method!r}")

    def qdq(g: torch.Tensor) -> torch.Tensor:
        if g.numel() < BLOCK:  # tiny tensors (norms, biases): not worth it
            return g
        q, s = _quant_int8(g)
        return _dequant_int8(q, s, g.shape, g.dtype)

    return {k: qdq(g) for k, g in grads.items()}


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """All-reduce ``x`` (the same shape on every rank of the ``axis`` group)
    moving int8 payloads (as int32 sums) and f32 block scales: each rank's
    payload quantized with its own scales, the payloads summed exactly, and
    dequantized by the mean of the ranks' scales, as the reference does."""
    group = mesh.get_group(axis)
    q, s = _quant_int8(x)
    # int32 accumulation of int8 payloads: exact for <= 2^23 ranks
    q32 = q.to(torch.int32)
    dist.all_reduce(q32, group=group)
    s_sum = s.clone()
    dist.all_reduce(s_sum, group=group)
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32, device=s.device)
    deq = q32.to(torch.float32) * (s_sum / n)
    return deq.reshape(-1)[:x.numel()].reshape(x.shape).to(x.dtype)
