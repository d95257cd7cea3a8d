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
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ffn, ffn_defs, rms_norm
from repro_torch.models.params import ParamDef
from repro_torch.parallel.axes import constrain, constrain_view, distribute_as


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
        "ln1": ParamDef((d,), ("embed",), init="ones"),
        "tm_mu_x": ParamDef((d,), ("embed",), init="zeros"),
        "tm_lora_A": ParamDef((d, 5 * r), ("embed", "rank"), init_scale=0.1),
        "tm_lora_B": ParamDef((5, r, d), (None, "rank", "embed"), init="zeros"),
        "tm_mu": ParamDef((5, d), (None, "embed"), init="zeros"),
        "wr": ParamDef((d, d), ("embed", "qkv_dim")),
        "wk": ParamDef((d, d), ("embed", "qkv_dim")),
        "wv": ParamDef((d, d), ("embed", "qkv_dim")),
        "wg": ParamDef((d, d), ("embed", "qkv_dim")),
        "w0": ParamDef((d,), ("embed",), init="custom", init_fn=_decay_init),
        "wd_A": ParamDef((d, dr), ("embed", "rank"), init_scale=0.1),
        "wd_B": ParamDef((dr, d), ("rank", "embed"), init="zeros"),
        "u": ParamDef((H, Dh), ("q_heads", "head_dim"), init_scale=0.5),
        "ln_x": ParamDef((d,), ("embed",), init="ones"),
        "wo": ParamDef((d, d), ("qkv_dim", "embed")),
        "ln2": ParamDef((d,), ("embed",), init="ones"),
        "cm_mu_k": ParamDef((d,), ("embed",), init="zeros"),
        "cm_mu_r": ParamDef((d,), ("embed",), init="zeros"),
        "cm_wk": ParamDef((d, f), ("embed", "ff")),
        "cm_wv": ParamDef((f, d), ("ff", "embed")),
        "cm_wr": ParamDef((d, d), ("embed", "qkv_dim")),
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


def rwkv_state_axes(cfg: ArchConfig) -> dict:
    """A decode cache's RWKV-6 state axes (the reference's)."""
    return {"S": ("cache_batch", "act_heads", None, None), "ts1": ("cache_batch", None),
            "ts2": ("cache_batch", None)}


def rglru_state_axes(cfg: ArchConfig) -> dict:
    """A decode cache's RG-LRU state axes (the reference's)."""
    return {"h": ("cache_batch", "act_lru"), "conv": ("cache_batch", None, "act_lru")}


# a block's own zero state's logical axes on a mesh: batch and heads (or
# channels) as the inputs of the kernels that update them
RWKV_STATE_AXES = {"S": ("act_batch", "act_heads", None, None), "ts1": ("act_batch", None),
                   "ts2": ("act_batch", None)}
RGLRU_STATE_AXES = {"h": ("act_batch", "act_lru"), "conv": ("act_batch", None, "act_lru")}


def _zero_state(init: dict, axes: dict, x: torch.Tensor) -> dict:
    """A block's own zero state; beside a DTensor ``x``, placed as ``axes``
    say."""
    if not isinstance(x, DTensor):
        return init
    return {name: distribute_as(t, *axes[name]) for name, t in init.items()}


def rwkv_block(p: dict, x: torch.Tensor, cfg: ArchConfig,
               state: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (x, state); ``state`` is updated in place."""
    B, S, d = x.shape
    H, Dh = rwkv_heads(cfg)
    dt = x.dtype
    st = (state if state is not None
          else _zero_state(rwkv_init_state(cfg, B, x.device), RWKV_STATE_AXES, x))

    # ---- time mix -----------------------------------------------------
    # the sequence gathered (a sequence-parallel stream cannot be shifted
    # or flattened into matmul rows by DTensor)
    xn = constrain(rms_norm(x, p["ln1"], cfg.norm_eps), "act_batch", "act_seq", None)
    dx = _shift(xn, st["ts1"]) - xn
    xxx = xn + dx * p["tm_mu_x"].to(dt)
    rank = cfg.rwkv.ddlerp_rank
    # on a mesh the low-rank activations stay unsharded, as their weights'
    # "rank" axis is: DTensor cannot split a sharded 5 * rank into (5, rank)
    s = constrain(torch.tanh(xxx @ p["tm_lora_A"].to(dt)), "act_batch", "act_seq", None)
    s = constrain(s.reshape(B, S, 5, rank), "act_batch", "act_seq", None, None)
    mix = p["tm_mu"].float() + torch.einsum(
        "bsir,ird->bsid", s.float(), p["tm_lora_B"].float())
    xs = xn[:, :, None] + dx[:, :, None] * mix.to(dt)  # (B, S, 5, d)
    # (DTensor cannot unbind a sharded dim)
    xr, xw, xk, xv, xg = constrain(xs, "act_batch", "act_seq", None, None).unbind(2)

    heads = ((B, S, H, Dh), "act_batch", "act_seq", "act_heads", None)
    r = constrain_view(xr @ p["wr"].to(dt), *heads)
    k = constrain_view(xk @ p["wk"].to(dt), *heads)
    v = constrain_view(xv @ p["wv"].to(dt), *heads)
    g = F.silu(xg @ p["wg"].to(dt))
    w_log = p["w0"].float() + (xw.float() @ p["wd_A"].float()) @ p["wd_B"].float()
    w = constrain_view(torch.exp(-torch.exp(w_log)), *heads)  # decay in (0, 1)
    # the decay is cast to the compute dtype, as the reference does
    out, _ = ops.wkv6(r, k, v, w.to(dt), p["u"], st["S"])

    # per-head group norm (population variance)
    of = out.float()
    mean = of.mean(-1, keepdim=True)
    var = of.var(-1, keepdim=True, unbiased=False)
    of = (of - mean) * torch.rsqrt(var + 64e-5)
    out = (constrain_view(of, (B, S, d), *heads[1:]) * p["ln_x"].float()).to(dt)
    out = out * g
    x = constrain(x + out @ p["wo"].to(dt), "act_batch", "act_seq", None)

    # ---- channel mix ----------------------------------------------------
    xn2 = constrain(rms_norm(x, p["ln2"], cfg.norm_eps), "act_batch", "act_seq", None)
    dx2 = _shift(xn2, st["ts2"]) - xn2
    xk2 = xn2 + dx2 * p["cm_mu_k"].to(dt)
    xr2 = xn2 + dx2 * p["cm_mu_r"].to(dt)
    gate = torch.sigmoid(xr2 @ p["cm_wr"].to(dt))
    hk = constrain(torch.square(F.relu(xk2 @ p["cm_wk"].to(dt))), "act_batch", "act_seq", "act_ff")
    x = constrain(x + gate * (hk @ p["cm_wv"].to(dt)), "act_batch", "act_seq", None)

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
        "ln1": ParamDef((d,), ("embed",), init="ones"),
        "w_y": ParamDef((d, W), ("embed", "lru")),
        "w_x": ParamDef((d, W), ("embed", "lru")),
        "conv_w": ParamDef((Kc, W), ("conv", "lru"), init_scale=0.5),
        "gate_a_w": ParamDef((nh, wh, wh), ("lru_heads", None, None), init_scale=0.5),
        "gate_a_b": ParamDef((nh, wh), ("lru_heads", None), init="zeros"),
        "gate_i_w": ParamDef((nh, wh, wh), ("lru_heads", None, None), init_scale=0.5),
        "gate_i_b": ParamDef((nh, wh), ("lru_heads", None), init="zeros"),
        "lam": ParamDef((W,), ("lru",), init="custom", init_fn=_lam_init),
        "w_out": ParamDef((W, d), ("lru", "embed")),
        "ln2": ParamDef((d,), ("embed",), init="ones"),
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
    st = (state if state is not None
          else _zero_state(rglru_init_state(cfg, B, x.device), RGLRU_STATE_AXES, x))

    xn = constrain(rms_norm(x, p["ln1"], cfg.norm_eps), "act_batch", "act_seq", None)
    y = F.gelu(xn @ p["w_y"].to(dt), approximate="tanh")  # jax.nn.gelu's form
    xb = constrain(xn @ p["w_x"].to(dt), "act_batch", "act_seq", "act_lru")
    xc, conv_new = ops.causal_conv1d(xb, p["conv_w"].to(dt), st["conv"])

    xh = xc.view(B, S, nh, wh)
    rg = _head_gate(xh, p["gate_a_w"], p["gate_a_b"])
    ig = _head_gate(xh, p["gate_i_w"], p["gate_i_b"])
    sp_lam = F.softplus(p["lam"].float()).view(nh, wh)
    log_a = (-8.0 * sp_lam * rg.float()).view(B, S, W)
    gated = (ig * xh).view(B, S, W)
    h, _ = ops.rglru(gated, log_a, st["h"])
    h = constrain(h, "act_batch", "act_seq", "act_lru")

    x = constrain(x + (h * y) @ p["w_out"].to(dt), "act_batch", "act_seq", None)
    x = constrain(x + ffn(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps)),
                  "act_batch", "act_seq", None)
    st["conv"].copy_(conv_new)  # x's dtype, kept as f32 as the reference does
    return x, st
