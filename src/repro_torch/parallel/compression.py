"""Gradient compression: value-level lossy int8 quantization of gradients
(after ``repro.parallel.compression``, ``compress_tree`` and its helpers).

``compress_tree`` models the accuracy effect of an int8 all-reduce with one
f32 scale per block of 256 values.  The collective that moves int8 on the
wire (the reference's ``compressed_psum``) is not ported yet.
"""
from __future__ import annotations

import math

import torch

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
