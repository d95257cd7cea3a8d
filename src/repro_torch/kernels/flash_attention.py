"""Wrappers around the Hopper flash-attention kernels: the forward
(``csrc/flash_attention.cu``), the port of the Pallas kernel in
``repro/kernels/flash_attention.py``, and the backward
(``csrc/flash_attention_bwd.cu``), the port of ``repro.kernels.ops._flash``'s
VJP.  ``FlashAttention`` joins them as a ``torch.autograd.Function``: its
forward also writes the row log-sum-exp, which its backward reads.

Every wrapper takes ``q_offset``: query row i sits at position q_offset + i
(keys at 0 .. Sk - 1), which is how a context-parallel rank runs its S / n
query rows against all S keys (``ops._maybe_context_parallel``).  The
persistent grids' "heaviest tiles first" order stays right at any offset:
under a causal mask a q tile's keys, min(Sk, q_offset + row + 1), still grow
with its rows, and a key tile's q rows still shrink with its keys.

On CPU tensors each wrapper returns its plain version (``ref.attention_ref``,
``ref.attention_lse_ref``, ``ref.flash_bwd_ref``).  On CUDA tensors it
launches the kernel or raises; nothing falls back.  A ``FakeTensor`` (a
step traced by ``launch.dryrun``, on any device) takes the fake route:
empty outputs of the kernel's shapes, and the kernel's work added to
``cost.fake``; a real tensor never does.

The forward's design follows the dtype (``DESIGNS``): bf16 runs on the
tensor cores (wgmma, tiles loaded by TMA), f32 keeps a CUDA-core kernel so
that its products stay true f32 (tensor cores take f32 only as TF32).  TMA
needs q / k / v to start on a 16-byte boundary with every stride a multiple
of 16 bytes (``aligned_for_tma``); a bf16 CUDA view that is not raises.  The
backward's design follows the dtype too (``BWD_DESIGNS``): bf16 on the
tensor cores (wgmma, tiles loaded by TMA; tensors on 16-byte boundaries),
f32 on CUDA cores, at every head dim the forward takes.  ``bwd_items`` and
``persistent_rounds`` mirror the order in which the bf16 backward's
persistent grid takes its items, ``bwd_split`` the head groups its dK / dV
items sum over at D 256.
"""
from __future__ import annotations

import math

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build
from repro_torch.kernels import cost
from repro_torch.kernels import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
DESIGNS = {torch.bfloat16: "wgmma+tma", torch.float32: "cuda-core f32"}

# Tile classes of a (q tile, kv tile) pair; csrc/flash_attention.cu's
# tile_class mirrors this function line for line.
SKIP, FULL, PARTIAL = 0, 1, 2
_BIG = 1 << 30

# kernel launches since the last reset; the CPU path does not count
launches = 0      # forward without the LSE (serving)
mask_launches: dict = {}  # those forward launches by mask, (causal, window, chunk)
cross_launches = 0  # those forward launches at Sq != Sk (cross-attention)
# launches at q_offset != 0 (a context-parallel rank's), by wrapper
offset_launches = {"fwd": 0, "fwd_lse": 0, "bwd": 0}
lse_launches = 0  # forward that also writes the LSE (training)
bwd_launches = 0  # backward
# the LSE forward's and the backward's launches by ("fwd_lse" or "bwd",
# causal, window, chunk, Sq != Sk)
train_mask_launches: dict = {}
BWD_DESIGNS = {torch.bfloat16: "wgmma+tma", torch.float32: "cuda-core f32"}
# the bf16 backward's tiles: a consumer warpgroup owns 64 rows, a block two
# up to D 128 (one at D 256); a dK / dV item is 128 keys stepping over 64 q
# rows, a dQ item 128 q rows stepping over 64 keys (64 and 64 at D 256)
BWD_ROWS = 64
BWD_ITEM = 2 * BWD_ROWS
# at D 256 a dK / dV item takes half of D, and the heads of a group are
# split into the fewest groups (a divisor of G) that give at least
# BWD_SPLIT_ITEMS items, about four for each of the card's 132 SMs: under
# MQA and a causal mask 64-key items alone are too few and too uneven
BWD_SPLIT_ITEMS = 512


def bwd_item_rows(D: int) -> int:
    """Keys of a dK / dV item and q rows of a dQ item of the bf16 backward."""
    return BWD_ITEM if D <= 128 else BWD_ROWS


def bwd_split(D: int, B: int, Sk: int, H: int, KV: int) -> int:
    """The head groups that a bf16 dK / dV item sums over: 1 up to D 128;
    at D 256 the fewest that give BWD_SPLIT_ITEMS items (their f32 partial
    sums are added in a fixed order by a second kernel)."""
    if D <= 128:
        return 1
    G = H // KV
    base = -(-Sk // BWD_ROWS) * KV * B * 2  # 64-key tiles x halves of D
    for n in range(1, G + 1):
        if G % n == 0 and base * n >= BWD_SPLIT_ITEMS:
            return n
    return G


def tile_class(q_start: int, block_q: int, k_start: int, block_k: int, Sq: int, Sk: int,
               *, causal: bool, window: int, chunk: int, q_offset: int = 0) -> int:
    """SKIP if no (q, k) pair of the tile attends, FULL if every pair does
    and every key is real (the kernel needs no mask there), else PARTIAL.
    q rows past Sq are ignored (their output is not written); keys past Sk
    never attend; q row i sits at position q_offset + i."""
    qa, qb = q_offset + q_start, q_offset + min(q_start + block_q, Sq) - 1
    ka, kb = k_start, min(k_start + block_k, Sk) - 1
    if qa > qb or ka > kb:
        return SKIP
    d_lo = 0 if causal else -_BIG  # q - k must lie in [d_lo, d_hi]
    d_hi = window - 1 if window > 0 else _BIG
    # some pair attends: within one chunk that both ranges touch, the
    # differences q - k cover [a - hi, b - lo] and must meet [d_lo, d_hi]
    c_first = max(qa, ka) // chunk if chunk > 0 else 0
    c_last = min(qb, kb) // chunk if chunk > 0 else 0
    any_ = False
    c = c_first
    while c <= c_last and not any_:
        a = max(qa, c * chunk) if chunk > 0 else qa
        b = min(qb, c * chunk + chunk - 1) if chunk > 0 else qb
        lo = max(ka, c * chunk) if chunk > 0 else ka
        hi = min(kb, c * chunk + chunk - 1) if chunk > 0 else kb
        any_ = max(a - hi, d_lo) <= min(b - lo, d_hi)
        c += 1
    if not any_:
        return SKIP
    all_ = (k_start + block_k <= Sk and qa - kb >= d_lo and qb - ka <= d_hi
            and (chunk <= 0 or (qa // chunk == qb // chunk and ka // chunk == kb // chunk
                                and qa // chunk == ka // chunk)))
    return FULL if all_ else PARTIAL


def bwd_items(kind: str, B: int, Sq: int, Sk: int, H: int, KV: int, *,
              causal: bool, D: int = 128) -> list[tuple[int, ...]]:
    """The bf16 backward's items in the order its persistent grid hands them
    out (``item`` in ``dkdv_kernel`` and ``dq_kernel``), tiles of
    ``bwd_item_rows(D)``: for ``"dkdv"`` (first key, kv head, batch) up to D
    128 and (first key, kv head, batch, half of D, head group) at D 256,
    first key tiles first (under a causal mask they see the most q rows);
    for ``"dq"`` (first q row, head, batch), the last q tiles first under a
    causal mask."""
    rows = bwd_item_rows(D)
    if kind == "dkdv":
        n_tiles, heads = -(-Sk // rows), KV
        parts, split = (1, 1) if D <= 128 else (2, bwd_split(D, B, Sk, H, KV))
    elif kind == "dq":
        n_tiles, heads, parts, split = -(-Sq // rows), H, 1, 1
    else:
        raise ValueError(f"kind must be 'dkdv' or 'dq', not {kind!r}")
    per_tile = heads * B * parts * split
    items = []
    for i in range(n_tiles * per_tile):
        tile, r = divmod(i, per_tile)
        if kind == "dq" and causal:
            tile = n_tiles - 1 - tile
        it = (tile * rows, r % heads, r // heads % B)
        if kind == "dkdv" and D > 128:
            it += (r // (heads * B) % parts, r // (heads * B * parts))
        items.append(it)
    return items


def persistent_rounds(n_items: int, n_blocks: int) -> list[list[int]]:
    """The items each block of a persistent grid of ``n_blocks`` takes
    (``round_item`` in the flash kernels): round r hands items r * n_blocks
    onwards to the blocks, in reverse block order on odd rounds."""
    rounds = []
    for blk in range(n_blocks):
        mine, r = [], 0
        while True:
            it = r * n_blocks + (n_blocks - 1 - blk if r & 1 else blk)
            if it >= n_items:
                break
            mine.append(it)
            r += 1
        rounds.append(mine)
    return rounds


def aligned_for_tma(t: torch.Tensor) -> bool:
    """True if ``t`` starts on a 16-byte boundary and its strides other than
    the last are multiples of 16 bytes, as a TMA descriptor needs."""
    size = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(st * size % 16 == 0 for st in t.stride()[:-1]))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           window: int, chunk: int, softcap: float, q_offset: int = 0) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise ValueError(f"q, k, v must share one dtype of {list(DTYPES)}; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported (kernel takes {HEAD_DIMS})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous in the head dim")
    if window < 0 or chunk < 0 or softcap < 0 or q_offset < 0:
        raise ValueError("window, chunk, softcap and q_offset must be >= 0")


def _check_tma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The bf16 forward's TMA rule, for real CUDA tensors."""
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not aligned_for_tma(t):
                raise ValueError(
                    f"{name} must start on a 16-byte boundary with strides that are multiples "
                    f"of 16 bytes for the tensor-core kernel (data_ptr % 16 = "
                    f"{t.data_ptr() % 16}, strides {tuple(t.stride())} elements of "
                    f"{t.element_size()} bytes)")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
             window: int, chunk: int, softcap: float, q_offset: int, with_lse: bool):
    """Launch the forward kernel on CUDA tensors: (o, lse (B, H, Sq) f32 or
    None)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_tma(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if o.numel() == 0 or Sk == 0:
        if lse is not None:
            lse.fill_(ref.NEG_INF)
        return o.zero_(), lse
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            DTYPES[q.dtype], B, Sq, Sk, H, KV, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            int(causal), int(window), int(chunk), int(q_offset), float(softcap),
            1.0 / math.sqrt(D), stream)
    _build.check(lib, err, "flash_attention_fwd launch")
    return o, lse


def _fake_fwd(q: torch.Tensor, k: torch.Tensor, *, causal: bool, window: int, chunk: int,
              q_offset: int, with_lse: bool):
    """The fake route: a traced call's outputs, (o, lse (B, H, Sq) f32 or
    None), empty, and its work added to ``cost.fake``."""
    B, Sq, H, D = q.shape
    cost.record("flash_attention_fwd_lse" if with_lse else "flash_attention_fwd", cost.flash_fwd(
        B, Sq, k.shape[1], H, k.shape[2], D, q.element_size(), causal=causal, window=window,
        chunk=chunk, q_offset=q_offset, with_lse=with_lse))
    lse = q.new_empty((B, H, Sq), dtype=torch.float32) if with_lse else None
    return q.new_empty((B, Sq, H, D)), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D), k / v (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype.
    Query positions start at q_offset, key positions at 0."""
    global launches, cross_launches
    _check(q, k, v, window=window, chunk=chunk, softcap=softcap, q_offset=q_offset)
    if isinstance(q, FakeTensor):
        return _fake_fwd(q, k, causal=causal, window=window, chunk=chunk,
                         q_offset=q_offset, with_lse=False)[0]
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 chunk=chunk, softcap=softcap, q_offset=q_offset)
    o, _ = _forward(q, k, v, causal=causal, window=window, chunk=chunk,
                    softcap=softcap, q_offset=q_offset, with_lse=False)
    launches += 1
    offset_launches["fwd"] += q_offset != 0
    mask = (bool(causal), window, chunk)
    mask_launches[mask] = mask_launches.get(mask, 0) + 1
    cross_launches += q.shape[1] != k.shape[1]
    return o


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0, chunk: int = 0,
                        softcap: float = 0.0, q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention``'s output and the row log-sum-exp (B, H, Sq) f32,
    head h = kv * G + g, that ``flash_attention_bwd`` reads."""
    global lse_launches
    _check(q, k, v, window=window, chunk=chunk, softcap=softcap, q_offset=q_offset)
    if isinstance(q, FakeTensor):
        return _fake_fwd(q, k, causal=causal, window=window, chunk=chunk,
                         q_offset=q_offset, with_lse=True)
    if q.device.type == "cpu":
        return ref.attention_lse_ref(q, k, v, causal=causal, window=window,
                                     chunk=chunk, softcap=softcap, q_offset=q_offset)
    o, lse = _forward(q, k, v, causal=causal, window=window, chunk=chunk,
                      softcap=softcap, q_offset=q_offset, with_lse=True)
    lse_launches += 1
    offset_launches["fwd_lse"] += q_offset != 0
    _count_train("fwd_lse", q, k, causal, window, chunk)
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, chunk: int = 0, softcap: float = 0.0,
                        q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` for the output gradient ``do``,
    from the forward's output ``o`` and row log-sum-exp ``lse``; each in its
    input's dtype."""
    global bwd_launches
    _check(q, k, v, window=window, chunk=chunk, softcap=softcap, q_offset=q_offset)
    B, Sq, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do {tuple(do.shape)} {do.dtype} "
                         f"must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {H}, {Sq}) float32, got {tuple(lse.shape)} {lse.dtype}")
    if any(t.device != q.device for t in (o, lse, do)):
        raise ValueError("o, lse and do must lie on q's device")
    if isinstance(q, FakeTensor):
        cost.record("flash_attention_bwd", cost.flash_bwd(
            B, Sq, k.shape[1], H, k.shape[2], D, q.element_size(), causal=causal,
            window=window, chunk=chunk, q_offset=q_offset))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type == "cpu":
        return ref.flash_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window,
                                 chunk=chunk, softcap=softcap, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    Sk, KV = k.shape[1], k.shape[2]
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary for the tensor-core "
                                 f"backward (data_ptr % 16 = {t.data_ptr() % 16})")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or Sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # delta, then (bf16) lse log2(e), each (B, H, Sq rounded up to 4) for TMA
    delta = torch.empty(2 * B * H * (-(-Sq // 4) * 4), dtype=torch.float32, device=q.device)
    # bf16 at D 256: the head groups' f32 partial sums of dK and dV
    n_split = bwd_split(D, B, Sk, H, KV) if q.dtype == torch.bfloat16 else 1
    part = (torch.empty((2, n_split) + tuple(k.shape), dtype=torch.float32, device=q.device)
            if n_split > 1 else None)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), n_split,
            DTYPES[q.dtype], B, Sq, Sk, H, KV, D,
            int(causal), int(window), int(chunk), int(q_offset), float(softcap),
            1.0 / math.sqrt(D), stream)
    _build.check(lib, err, "flash_attention_bwd launch")
    bwd_launches += 1
    offset_launches["bwd"] += q_offset != 0
    _count_train("bwd", q, k, causal, window, chunk)
    return dq, dk, dv


def _count_train(wrapper: str, q, k, causal, window, chunk) -> None:
    key = (wrapper, bool(causal), window, chunk, q.shape[1] != k.shape[1])
    train_mask_launches[key] = train_mask_launches.get(key, 0) + 1


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel with the LSE, and
    the backward kernel (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, chunk: int, softcap: float,
                q_offset: int):
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window, chunk=chunk,
                                     softcap=softcap, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(causal=causal, window=window, chunk=chunk, softcap=softcap,
                        q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.mask)
        return dq, dk, dv, None, None, None, None, None
