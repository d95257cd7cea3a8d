"""Dense transformer building blocks: norms, RoPE, attention, FFN (after
``repro.models.layers``).

Functions take plain tensors; parameters come in as dicts shaped as
``attention_defs`` / ``ffn_defs`` name them.  Projections are written as
matmuls over flattened head dims so q / k / v come out contiguous in the
(B, S, H, D) layout the attention kernel reads.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef


# ---------------------------------------------------------------------------
# Norms / RoPE
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (S,). Split-halves rotation."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions.float()[..., None] * freqs  # (S, half)
    cos = torch.cos(ang)[..., None, :]  # (S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def attention_defs(cfg: ArchConfig) -> dict:
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    defs = {
        "wq": ParamDef((d, H, Dh)),
        "wk": ParamDef((d, KV, Dh)),
        "wv": ParamDef((d, KV, Dh)),
        "wo": ParamDef((H, Dh, d)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((Dh,), init="ones")
        defs["k_norm"] = ParamDef((Dh,), init="ones")
    return defs


def _heads_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul; the result is contiguous."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _out_proj(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = w.shape
    return o.reshape(*o.shape[:-2], h * k) @ w.to(o.dtype).reshape(h * k, d)


def _project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: Optional[torch.Tensor]):
    q = _heads_proj(x, p["wq"])
    k = _heads_proj(x, p["wk"])
    v = _heads_proj(x, p["wv"])
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _window(cfg: ArchConfig, kind: str) -> int:
    """The sliding window of a ``kind`` layer (0 = unbounded); "chunked"
    layers are not ported and raise."""
    if kind not in ("global", "local"):
        raise NotImplementedError(f"{kind!r} attention layers are not ported yet")
    return cfg.window if kind == "local" else 0


def self_attention(
    p: dict,
    x: torch.Tensor,  # (B, S, d) pre-normed input
    cfg: ArchConfig,
    kind: str,
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Returns (attn output, (k, v)) — k/v reused for prefill cache writes."""
    window = _window(cfg, kind)
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = ops.flash_attention(q, k, v, causal=causal, window=window,
                            softcap=cfg.attn_logit_softcap)
    return _out_proj(o, p["wo"]), (k, v)


def decode_self_attention(
    p: dict,
    x: torch.Tensor,  # (B, 1, d)
    cfg: ArchConfig,
    kind: str,
    k_cache: torch.Tensor,  # (B, L, KV, Dh)
    v_cache: torch.Tensor,
    pos: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention; returns (out, k_cache, v_cache).

    Unlike the reference, the caches are updated in place (the new key and
    value go to ring slot ``pos % L``), which saves a copy of each cache per
    layer and step.  Like the reference, a local layer takes slot ``i`` to
    hold position ``pos - ((pos - i) % L)``; that is true of a prefill cache
    only when the prompt length is a multiple of L (the prefill keeps the
    last L keys in linear order), and the port keeps the reference's
    semantics.
    """
    window = _window(cfg, kind)
    B = x.shape[0]
    L = k_cache.shape[1]
    positions = torch.tensor([pos], device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    slot = pos % L  # ring slot (== pos for a full-length global cache)
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    # absolute position the reference assigns to each slot of the ring
    idx = torch.arange(L, device=x.device)
    if kind == "global":
        slot_pos = torch.where(idx <= pos, idx, torch.full_like(idx, -1))
    else:
        cand = pos - torch.remainder(pos - idx, L)
        slot_pos = torch.where(cand >= 0, cand, torch.full_like(cand, -1))
    slot_pos = slot_pos[None].expand(B, L)
    o = ops.decode_attention(
        q, k_cache, v_cache, slot_pos,
        torch.full((B,), pos, dtype=torch.long, device=x.device),
        window=window, softcap=cfg.attn_logit_softcap)
    return _out_proj(o, p["wo"]), k_cache, v_cache


# ---------------------------------------------------------------------------
# Dense FFN (SwiGLU or classic MLP)
# ---------------------------------------------------------------------------
def ffn_defs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    defs = {
        "w_up": ParamDef((d, f)),
        "w_down": ParamDef((f, d)),
    }
    if cfg.ffn_gated:
        defs["w_gate"] = ParamDef((d, f))
    return defs


def ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    u = x @ p["w_up"].to(dt)
    if "w_gate" in p:  # SwiGLU
        h = F.silu(x @ p["w_gate"].to(dt)) * u
    else:  # classic MLP; jax.nn.gelu defaults to the tanh form
        h = F.gelu(u, approximate="tanh")
    return h @ p["w_down"].to(dt)
