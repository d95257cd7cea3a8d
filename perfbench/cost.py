"""The yardstick's arithmetic: the H100's peaks, the flash kernels' work in
closed form, and the model FLOPs of a training step.

The peaks and the flash closed forms are frozen copies of the port's
``launch/hw.py`` and ``kernels/cost.py`` (as of the benchmark's first
version): later changes to the port's copies do not move the benchmark.
"""
from __future__ import annotations

import math

import numpy as np

from perfbench import weights

# one NVIDIA H100 SXM5, data sheet: dense bf16 on the tensor cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12


def bound_ms(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time for ``flops`` at ``dtype``'s peak and ``nbytes`` of
    device memory moved."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BW) * 1e3


def attended_pairs(Sq: int, Sk: int, *, causal: bool, window: int = 0, chunk: int = 0,
                   q_offset: int = 0) -> int:
    """The (query, key) pairs the mask keeps: query row i sits at position
    p = q_offset + i and attends the keys k in [0, Sk) with k <= p
    (causal), p - k < window (window > 0) and k // chunk == p // chunk
    (chunk > 0)."""
    p = q_offset + np.arange(Sq, dtype=np.int64)
    lo = np.zeros_like(p)
    hi = np.full_like(p, Sk - 1)
    if causal:
        hi = np.minimum(hi, p)
    if window:
        lo = np.maximum(lo, p - window + 1)
    if chunk:
        start = p // chunk * chunk
        lo = np.maximum(lo, start)
        hi = np.minimum(hi, start + chunk - 1)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_fwd(B: int, Sq: int, Sk: int, H: int, KV: int, D: int, itemsize: int, *,
              causal: bool, window: int = 0, with_lse: bool = False) -> tuple[float, float]:
    """Two products (QK^T and PV) of 2 operations per head dim for every
    kept pair; q, k, v read once, o (and the f32 LSE) written once."""
    pairs = attended_pairs(Sq, Sk, causal=causal, window=window)
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KV * D) * itemsize
    return 4.0 * B * H * D * pairs, float(nbytes + (B * H * Sq * 4 if with_lse else 0))


def flash_bwd(B: int, Sq: int, Sk: int, H: int, KV: int, D: int, itemsize: int, *,
              causal: bool, window: int = 0) -> tuple[float, float]:
    """Five products (S, dP, dV, dQ, dK) for every kept pair; q, k, v, o,
    dO and the LSE read once, dq, dk, dv written once."""
    pairs = attended_pairs(Sq, Sk, causal=causal, window=window)
    nbytes = (4 * B * Sq * H * D + 4 * B * Sk * KV * D) * itemsize + B * H * Sq * 4
    return 10.0 * B * H * D * pairs, float(nbytes)


def _window(cfg: dict) -> int:
    return cfg["window"] if cfg["layer_kind"] == "local" else 0


def flash_bound_ms(cfg: dict, batch: int, seq: int) -> float:
    """The least time of one bf16 flash forward (with its LSE) and one
    backward over a (batch, seq) microbatch, for one layer."""
    shape = (batch, seq, seq, cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"], 2)
    fwd = bound_ms(*flash_fwd(*shape, causal=True, window=_window(cfg), with_lse=True))
    return fwd + bound_ms(*flash_bwd(*shape, causal=True, window=_window(cfg)))


def param_count(cfg: dict) -> int:
    return sum(math.prod(leaf.shape) for leaf in weights.leaves(cfg))


def active_param_count(cfg: dict) -> int:
    """Parameters a token runs through, less the embedding's gather: every
    leaf but the embedding, the routed experts' at top_k of n_experts."""
    n = 0
    for leaf in weights.leaves(cfg):
        size = math.prod(leaf.shape)
        if leaf.name == "embed":
            continue
        if "/moe/w_" in leaf.name:
            size = size * cfg["moe"]["top_k"] // cfg["moe"]["n_experts"]
        n += size
    return n


def attention_flops(cfg: dict, batch: int, seq: int) -> float:
    """One layer's attention products without recompute: QK^T and PV
    forward (4 operations per head dim and kept pair), dP, dS's dQ, dK and
    dV backward (8)."""
    pairs = attended_pairs(seq, seq, causal=True, window=_window(cfg))
    return 12.0 * batch * cfg["n_heads"] * cfg["d_head"] * pairs


def model_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over (batch, seq) tokens: 6 per
    active parameter and token, plus attention a layer; no recompute."""
    return (6.0 * active_param_count(cfg) * batch * seq
            + cfg["n_layers"] * attention_flops(cfg, batch, seq))


# AdamW's least device-memory traffic a parameter: p, g, m, v read and p,
# m, v written, 4 bytes each
ADAMW_BYTES_PER_PARAM = 28
