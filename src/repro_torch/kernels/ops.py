"""Compute ops used by the model, following ``repro.kernels.ops``.

``flash_attention`` with Sq == Sk and q_offset == 0 always goes to the
kernel wrappers (which take the plain versions only for CPU tensors): when
grad is enabled and q, k or v requires grad, through ``FlashAttention``
(forward with the LSE, backward kernel); otherwise (serving, under
``inference_mode``) through the forward alone, which writes no LSE.  Other
shapes run the plain version on the CPU and are not yet ported on CUDA.
``decode_attention`` stays plain PyTorch, as the reference leaves it in jnp.
``wkv6`` and ``rglru`` always go to their kernel wrappers, with or without
a state; ``wkv6`` like ``flash_attention``: when grad is enabled and an
input requires grad, through ``WKV6`` (the forward kernel, and the backward
kernel in the backward pass), otherwise (serving) through the forward
wrapper alone.  ``causal_conv1d`` is plain PyTorch, as the reference
computes it in jnp outside any kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as kg
from repro_torch.kernels import wkv6 as k6


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    chunk: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    if q.shape[1] == k.shape[1] and q_offset == 0:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return fa.FlashAttention.apply(q, k, v, causal, window, chunk, softcap)
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  chunk=chunk, softcap=softcap)
    if q.device.type != "cpu":
        raise NotImplementedError(
            "flash_attention with Sq != Sk or q_offset != 0 is not ported to CUDA")
    return ref.attention_ref(q, k, v, causal=causal, window=window, chunk=chunk,
                             softcap=softcap, q_offset=q_offset)


def decode_attention(
    q: torch.Tensor,         # (B, 1, H, D)
    k_cache: torch.Tensor,   # (B, L, KV, D)
    v_cache: torch.Tensor,
    slot_pos: torch.Tensor,  # (B, L)
    pos: torch.Tensor,       # (B,)
    *,
    window: int = 0,
    chunk: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    return ref.decode_attention_ref(q, k_cache, v_cache, slot_pos, pos,
                                    window=window, chunk=chunk, softcap=softcap)


def wkv6(
    r: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # per-step decay in (0, 1)
    u: torch.Tensor,  # (H, D)
    state: Optional[torch.Tensor] = None,  # (B, H, D, D) f32, updated in place
) -> tuple[torch.Tensor, torch.Tensor]:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, state)):
        return k6.WKV6.apply(r, k, v, w, u, state)
    return k6.wkv6(r, k, v, w, u, state)


def rglru(
    x: torch.Tensor,      # (B, S, W) gated input
    log_a: torch.Tensor,  # (B, S, W) log recurrence coefficient (<= 0)
    h0: Optional[torch.Tensor] = None,  # (B, W) f32, updated in place
) -> tuple[torch.Tensor, torch.Tensor]:
    return kg.rglru(x, log_a, h0)


def causal_conv1d(
    x: torch.Tensor,  # (B, S, W)
    w: torch.Tensor,  # (K, W) depthwise taps, w[-1] multiplies x_t
    state: Optional[torch.Tensor] = None,  # (B, K-1, W) trailing context
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv in x's dtype, summed tap by tap in the
    reference's order.  Returns (out, the last K-1 inputs in x's dtype)."""
    B, S, W = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, W), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+K-1, W)
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + S] * w[i]
    return out, xp[:, S:]
