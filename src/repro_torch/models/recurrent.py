"""Recurrent blocks (after ``repro.models.recurrent``): RWKV-6 (Finch) and
the RG-LRU block of RecurrentGemma.

Each block runs the full sequence (prefill, S tokens) and decode (S = 1)
with the same code, against a recurrent state

    rwkv:  {"S": (B, H, Dk, Dv) f32 WKV matrix, "ts1": (B, d) f32, "ts2": (B, d) f32}
    rglru: {"h": (B, W) f32, "conv": (B, K-1, W) f32 conv context}

Unlike the reference, which returns a new state, a block updates the state
it is given in place and returns it, which saves a copy of every layer's
state per decode step; without a state it starts from zeros.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ffn, ffn_defs, rms_norm
from repro_torch.models.params import ParamDef


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: the previous token's value at each position."""
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def rwkv_heads(cfg: ArchConfig) -> tuple[int, int]:
    if cfg.rwkv is None:
        raise ValueError(f"{cfg.name} has no RWKV spec")
    dh = cfg.rwkv.head_dim
    if cfg.d_model % dh:
        raise ValueError(f"{cfg.name}: d_model {cfg.d_model} is not a multiple of {dh}")
    return cfg.d_model // dh, dh


def _decay_init(shape: tuple[int, ...], dtype: torch.dtype,
                generator: torch.Generator) -> torch.Tensor:
    # w0 so that exp(-exp(w0)) spans slow..fast decay across channels
    lin = torch.linspace(-6.0, -0.5, shape[-1], device=generator.device)
    return lin.expand(shape).to(dtype).contiguous()


def rwkv_defs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    r = cfg.rwkv.ddlerp_rank
    dr = cfg.rwkv.decay_rank
    H, Dh = rwkv_heads(cfg)
    return {
        "ln1": ParamDef((d,), init="ones"),
        "tm_mu_x": ParamDef((d,), init="zeros"),
        "tm_lora_A": ParamDef((d, 5 * r), init_scale=0.1),
        "tm_lora_B": ParamDef((5, r, d), init="zeros"),
        "tm_mu": ParamDef((5, d), init="zeros"),
        "wr": ParamDef((d, d)),
        "wk": ParamDef((d, d)),
        "wv": ParamDef((d, d)),
        "wg": ParamDef((d, d)),
        "w0": ParamDef((d,), init="custom", init_fn=_decay_init),
        "wd_A": ParamDef((d, dr), init_scale=0.1),
        "wd_B": ParamDef((dr, d), init="zeros"),
        "u": ParamDef((H, Dh), init_scale=0.5),
        "ln_x": ParamDef((d,), init="ones"),
        "wo": ParamDef((d, d)),
        "ln2": ParamDef((d,), init="ones"),
        "cm_mu_k": ParamDef((d,), init="zeros"),
        "cm_mu_r": ParamDef((d,), init="zeros"),
        "cm_wk": ParamDef((d, f)),
        "cm_wv": ParamDef((f, d)),
        "cm_wr": ParamDef((d, d)),
    }


def rwkv_init_state(cfg: ArchConfig, batch: int, device: torch.device | str = "cpu",
                    stack: Optional[int] = None) -> dict:
    """Zero state; with ``stack``, one per layer on a leading axis."""
    H, Dh = rwkv_heads(cfg)
    d = cfg.d_model
    lead = (batch,) if stack is None else (stack, batch)
    return {
        "S": torch.zeros(lead + (H, Dh, Dh), dtype=torch.float32, device=device),
        "ts1": torch.zeros(lead + (d,), dtype=torch.float32, device=device),
        "ts2": torch.zeros(lead + (d,), dtype=torch.float32, device=device),
    }


def rwkv_block(p: dict, x: torch.Tensor, cfg: ArchConfig,
               state: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (x, state); ``state`` is updated in place."""
    B, S, d = x.shape
    H, Dh = rwkv_heads(cfg)
    dt = x.dtype
    st = state if state is not None else rwkv_init_state(cfg, B, x.device)

    # ---- time mix -----------------------------------------------------
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    dx = _shift(xn, st["ts1"]) - xn
    xxx = xn + dx * p["tm_mu_x"].to(dt)
    rank = cfg.rwkv.ddlerp_rank
    s = torch.tanh(xxx @ p["tm_lora_A"].to(dt)).reshape(B, S, 5, rank)
    mix = p["tm_mu"].float() + torch.einsum(
        "bsir,ird->bsid", s.float(), p["tm_lora_B"].float())
    xs = xn[:, :, None] + dx[:, :, None] * mix.to(dt)  # (B, S, 5, d)
    xr, xw, xk, xv, xg = xs.unbind(2)

    r = (xr @ p["wr"].to(dt)).view(B, S, H, Dh)
    k = (xk @ p["wk"].to(dt)).view(B, S, H, Dh)
    v = (xv @ p["wv"].to(dt)).view(B, S, H, Dh)
    g = F.silu(xg @ p["wg"].to(dt))
    w_log = p["w0"].float() + (xw.float() @ p["wd_A"].float()) @ p["wd_B"].float()
    w = torch.exp(-torch.exp(w_log)).view(B, S, H, Dh)  # decay in (0, 1)

    # the decay is cast to the compute dtype, as the reference does
    out, _ = ops.wkv6(r, k, v, w.to(dt), p["u"], st["S"])

    # per-head group norm (population variance)
    of = out.float()
    mean = of.mean(-1, keepdim=True)
    var = of.var(-1, keepdim=True, unbiased=False)
    of = (of - mean) * torch.rsqrt(var + 64e-5)
    out = (of.reshape(B, S, d) * p["ln_x"].float()).to(dt)
    out = out * g
    x = x + out @ p["wo"].to(dt)

    # ---- channel mix ----------------------------------------------------
    xn2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    dx2 = _shift(xn2, st["ts2"]) - xn2
    xk2 = xn2 + dx2 * p["cm_mu_k"].to(dt)
    xr2 = xn2 + dx2 * p["cm_mu_r"].to(dt)
    gate = torch.sigmoid(xr2 @ p["cm_wr"].to(dt))
    hk = torch.square(F.relu(xk2 @ p["cm_wk"].to(dt)))
    x = x + gate * (hk @ p["cm_wv"].to(dt))

    st["ts1"].copy_(xn[:, -1])
    st["ts2"].copy_(xn2[:, -1])
    return x, st


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma)
# ---------------------------------------------------------------------------
def _lam_init(shape: tuple[int, ...], dtype: torch.dtype,
              generator: torch.Generator) -> torch.Tensor:
    # a ~ U(0.9, 0.999), lam = softplus^-1(-log(a) / 8), so that
    # exp(-8 softplus(lam)) = a: the recurrence's decay at a gate of 1
    a = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device) * (0.999 - 0.9) + 0.9
    sp = -torch.log(a) / 8.0
    return torch.log(torch.expm1(sp)).to(dtype)


def rglru_defs(cfg: ArchConfig) -> dict:
    if cfg.rglru is None:
        raise ValueError(f"{cfg.name} has no RG-LRU spec")
    d = cfg.d_model
    W, nh, Kc = cfg.rglru.lru_width, cfg.rglru.n_heads, cfg.rglru.conv_width
    wh = W // nh
    return {
        "ln1": ParamDef((d,), init="ones"),
        "w_y": ParamDef((d, W)),
        "w_x": ParamDef((d, W)),
        "conv_w": ParamDef((Kc, W), init_scale=0.5),
        "gate_a_w": ParamDef((nh, wh, wh), init_scale=0.5),
        "gate_a_b": ParamDef((nh, wh), init="zeros"),
        "gate_i_w": ParamDef((nh, wh, wh), init_scale=0.5),
        "gate_i_b": ParamDef((nh, wh), init="zeros"),
        "lam": ParamDef((W,), init="custom", init_fn=_lam_init),
        "w_out": ParamDef((W, d)),
        "ln2": ParamDef((d,), init="ones"),
        "ffn": ffn_defs(cfg),
    }


def rglru_init_state(cfg: ArchConfig, batch: int, device: torch.device | str = "cpu",
                     stack: Optional[int] = None) -> dict:
    """Zero state; with ``stack``, one per layer on a leading axis."""
    W, Kc = cfg.rglru.lru_width, cfg.rglru.conv_width
    lead = (batch,) if stack is None else (stack, batch)
    return {
        "h": torch.zeros(lead + (W,), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (Kc - 1, W), dtype=torch.float32, device=device),
    }


def _head_gate(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sigmoid(einsum("bshw,hwu->bshu", xh, w) + b), contiguous (B, S, nh, wh)."""
    g = torch.einsum("bshw,hwu->bshu", xh, w.to(xh.dtype)).contiguous()
    return torch.sigmoid(g + b.to(xh.dtype))


def rglru_block(p: dict, x: torch.Tensor, cfg: ArchConfig,
                state: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (x, state); ``state`` is updated in place."""
    B, S, d = x.shape
    W, nh = cfg.rglru.lru_width, cfg.rglru.n_heads
    wh = W // nh
    dt = x.dtype
    st = state if state is not None else rglru_init_state(cfg, B, x.device)

    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    y = F.gelu(xn @ p["w_y"].to(dt), approximate="tanh")  # jax.nn.gelu's form
    xb = xn @ p["w_x"].to(dt)
    xc, conv_new = ops.causal_conv1d(xb, p["conv_w"].to(dt), st["conv"])

    xh = xc.view(B, S, nh, wh)
    rg = _head_gate(xh, p["gate_a_w"], p["gate_a_b"])
    ig = _head_gate(xh, p["gate_i_w"], p["gate_i_b"])
    sp_lam = F.softplus(p["lam"].float()).view(nh, wh)
    log_a = (-8.0 * sp_lam * rg.float()).view(B, S, W)
    gated = (ig * xh).view(B, S, W)
    h, _ = ops.rglru(gated, log_a, st["h"])

    x = x + (h * y) @ p["w_out"].to(dt)
    x = x + ffn(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))
    st["conv"].copy_(conv_new)  # x's dtype, kept as f32 as the reference does
    return x, st
