"""The work of each Hopper kernel in closed form: the FLOPs it must do and
the device-memory bytes it must move (each input read once, each output
written once), at any shape.

``chip_smoke.py`` turns these into each kernel's bound; the dry run
(``launch.dryrun``) adds them to a traced step's count, since a kernel
launched through ctypes is no aten op that a dispatch mode could see.
Attention counts the (query, key) pairs its mask keeps, row by row from
each row's key interval, so no Sq x Sk mask is built at 32k or 524k.

``fake`` is the running total of the wrappers' fake route: a wrapper
given a ``FakeTensor`` (a traced step) returns empty outputs of the
kernel's shapes and adds the kernel's work here.  A real call never adds.
"""
from __future__ import annotations

import numpy as np

fake = {"flops": 0.0, "bytes": 0.0, "calls": {}}


def reset() -> None:
    fake["flops"], fake["bytes"] = 0.0, 0.0
    fake["calls"] = {}


def record(name: str, work: tuple[float, float]) -> None:
    """Add one fake-route call of kernel ``name`` doing ``work`` (flops,
    bytes)."""
    fake["flops"] += work[0]
    fake["bytes"] += work[1]
    fake["calls"][name] = fake["calls"].get(name, 0) + 1


def attended_pairs(Sq: int, Sk: int, *, causal: bool, window: int = 0, chunk: int = 0,
                   q_offset: int = 0) -> int:
    """The (query, key) pairs the mask keeps: query row i sits at position
    p = q_offset + i and attends the keys k in [0, Sk) with k <= p
    (causal), p - k < window (window > 0) and k // chunk == p // chunk
    (chunk > 0): one interval [lo, hi] a row."""
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
              causal: bool, window: int = 0, chunk: int = 0, q_offset: int = 0,
              with_lse: bool = False) -> tuple[float, float]:
    """Two products (QK^T and PV) of 2 operations per head dim for every
    kept pair; q, k, v read once, o (and the f32 LSE) written once."""
    pairs = attended_pairs(Sq, Sk, causal=causal, window=window, chunk=chunk, q_offset=q_offset)
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KV * D) * itemsize
    return 4.0 * B * H * D * pairs, float(nbytes + (B * H * Sq * 4 if with_lse else 0))


def flash_bwd(B: int, Sq: int, Sk: int, H: int, KV: int, D: int, itemsize: int, *,
              causal: bool, window: int = 0, chunk: int = 0,
              q_offset: int = 0) -> tuple[float, float]:
    """Five products (S, dP, dV, dQ, dK) for every kept pair; q, k, v, o,
    dO and the LSE read once, dq, dk, dv written once."""
    pairs = attended_pairs(Sq, Sk, causal=causal, window=window, chunk=chunk, q_offset=q_offset)
    nbytes = (4 * B * Sq * H * D + 4 * B * Sk * KV * D) * itemsize + B * H * Sq * 4
    return 10.0 * B * H * D * pairs, float(nbytes)


def wkv6_fwd(B: int, S: int, H: int, D: int, itemsize: int) -> tuple[float, float]:
    """5 operations per (b, t, h, i, j): out_j = sum_i r_i S_ij (2) plus the
    u term (O(D) a step), and S_ij <- w_i S_ij + k_i v_j (3); r, k, v, w
    read, the output written, u read, the f32 state read and written."""
    nbytes = 5 * B * S * H * D * itemsize + H * D * itemsize + 2 * B * H * D * D * 4
    return 5.0 * B * S * H * D * D, float(nbytes)


def wkv6_bwd(B: int, S: int, H: int, D: int, itemsize: int, *,
             with_state: bool = False) -> tuple[float, float]:
    """14 operations per (b, t, h, i, j): the state chain and its
    cotangent's (3 each), the sums for dr, dk, dv and dw (2 each); r, k,
    v, w and dO read, dr, dk, dv, dw written, u read and du written (f32),
    and with a state S_0 and the final state's cotangent read and S_0's
    written (f32)."""
    nbytes = (9 * B * S * H * D * itemsize + H * D * (itemsize + 4)
              + (3 * B * H * D * D * 4 if with_state else 0))
    return 14.0 * B * S * H * D * D, float(nbytes)


def rglru_fwd(B: int, S: int, W: int, x_itemsize: int, la_itemsize: int) -> tuple[float, float]:
    """9 f32 operations an element (exp(l), 2l, exp(2l), 1 - e, the max,
    the sqrt, its product with x, the scan's multiply and add); x and log_a
    read, h written in x's dtype, h0 read and the final h written (f32)."""
    n = B * S * W
    return 9.0 * n, float(n * (2 * x_itemsize + la_itemsize) + 2 * B * W * 4)


def rglru_bwd(B: int, S: int, W: int, x_itemsize: int, la_itemsize: int) -> tuple[float, float]:
    """~30 f32 operations an element (the coefficients and their
    derivatives, h rebuilt, the carry, dx and dlog_a); x, log_a and dO
    read, dx and dlog_a written, h0 and the final state's cotangent read
    and dh0 written (f32)."""
    n = B * S * W
    return 30.0 * n, float(n * (3 * x_itemsize + 2 * la_itemsize) + 3 * B * W * 4)
