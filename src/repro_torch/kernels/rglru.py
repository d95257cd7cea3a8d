"""Wrappers around the Hopper RG-LRU kernels: the forward
(``csrc/rglru.cu``), the port of the Pallas kernel in
``repro/kernels/rglru_scan.py``, and the backward, the port of ``jax.grad``
of ``repro.kernels.ref.rglru_ref`` (the Pallas kernel has no backward; the
reference trains through its associative scan).  ``RGLRU`` joins them as a
``torch.autograd.Function``.

The backward has two designs (``BWD_DESIGNS`` routes by dtype;
``rglru_bwd(..., kernel=)`` overrides it, to compare them):
``csrc/rglru_bwd_tiled.cu`` tiles time as well as width, so that each
step's independent work runs on many warps and one warp a block walks only
the two serial chains (``bwd_grid`` mirrors its blocks, strips and tiles;
``rglru_bwd_tiled`` is its order in plain PyTorch, for the tests), and
``csrc/rglru_bwd.cu`` gives one thread a channel.  Both give the plain
version's bits.

On CPU tensors each wrapper returns its plain version (``ref.rglru_ref``,
``ref.rglru_bwd_ref``).  On CUDA tensors it launches the kernel or raises;
nothing falls back.  A ``FakeTensor`` takes the fake route, as in
``flash_attention``.  A given ``h0`` is updated in place, so prefill writes
each layer's final state straight into its cache slice and decode (S = 1)
updates that slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build
from repro_torch.kernels import cost
from repro_torch.kernels import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward keeps h every CHUNK steps (csrc/rglru_bwd.cu's C), or every
# TILED_CHUNK steps (csrc/rglru_bwd_tiled.cu's C)
CHUNK, TILED_CHUNK = 16, 8
# csrc/rglru_bwd_tiled.cu's blocks: STRIP adjacent channels of one batch row,
# a chain warp and GROUPS groups of GROUP_WARPS warps, each warp one chunk of
# a tile, so a tile is TILE steps and the groups take the tiles in turns
STRIP, GROUPS, GROUP_WARPS = 32, 5, 3
TILE = GROUP_WARPS * TILED_CHUNK
# the backward's designs, by dtype: the tiled kernel in both
BWD_TILED, BWD_CHANNEL = "tiled many-warp", "one thread a channel"
BWD_ENTRY = {BWD_TILED: "rglru_bwd_tiled", BWD_CHANNEL: "rglru_bwd"}
BWD_DESIGNS = {torch.bfloat16: BWD_TILED, torch.float32: BWD_TILED}
# the tiled kernel's passes (``phases``): both for the VJP; one of them, or
# either without the chain warp's walks, only to time it by phase
FORWARD, REVERSE, NO_CHAIN = 1, 2, 4

# kernel launches since the last reset; the CPU path does not count
launches = 0      # forward
bwd_launches = 0  # backward
bwd_kernel_launches = {BWD_TILED: 0, BWD_CHANNEL: 0}  # the same, by design


def _check(x: torch.Tensor, log_a: torch.Tensor, h0: Optional[torch.Tensor]) -> None:
    if x.dim() != 3 or x.shape != log_a.shape:
        raise ValueError(f"x and log_a must be one (B, S, W) shape; got "
                         f"{tuple(x.shape)}, {tuple(log_a.shape)}")
    if x.device != log_a.device:
        raise ValueError(f"x on {x.device}, log_a on {log_a.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be one of {list(DTYPES)}; got {x.dtype}")
    if log_a.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"log_a must be float32 or x's dtype; got {log_a.dtype}")
    if x.stride(-1) != 1 or log_a.stride(-1) != 1:
        raise ValueError("x and log_a must be contiguous in the width")
    if h0 is None:
        return
    B, _, W = x.shape
    if tuple(h0.shape) != (B, W) or h0.dtype != torch.float32:
        raise ValueError(f"h0 must be f32 {(B, W)}; got {h0.dtype} {tuple(h0.shape)}")
    if h0.device != x.device:
        raise ValueError(f"h0 on {h0.device}, x on {x.device}")
    if not h0.is_contiguous():
        raise ValueError("h0 must be contiguous")


def rglru(x: torch.Tensor, log_a: torch.Tensor, h0: Optional[torch.Tensor] = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, W), log_a (B, S, W) f32 or x's dtype, h0 (B, W) f32 or None
    (zeros) -> (h (B, S, W) in x's dtype, final h (B, W) f32).

    A given ``h0`` is updated in place and returned (the reference returns
    a new one); without one a new final state is returned."""
    global launches
    _check(x, log_a, h0)
    B, S, W = x.shape
    if isinstance(x, FakeTensor):
        cost.record("rglru_fwd", cost.rglru_fwd(B, S, W, x.element_size(), log_a.element_size()))
        return x.new_empty((B, S, W)), (
            x.new_empty((B, W), dtype=torch.float32) if h0 is None else h0)
    if x.device.type == "cpu":
        out, h = ref.rglru_ref(x, log_a, h0)
        return out, (h if h0 is None else h0.copy_(h))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    o = torch.empty((B, S, W), dtype=x.dtype, device=x.device)
    if o.numel() == 0:
        return o, (torch.zeros((B, W), dtype=torch.float32, device=x.device)
                   if h0 is None else h0)
    h_out = h0 if h0 is not None else torch.empty((B, W), dtype=torch.float32,
                                                  device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rglru_fwd(
            x.data_ptr(), log_a.data_ptr(), None if h0 is None else h0.data_ptr(),
            o.data_ptr(), h_out.data_ptr(), DTYPES[x.dtype], DTYPES[log_a.dtype],
            B, S, W, x.stride(0), x.stride(1), log_a.stride(0), log_a.stride(1), stream)
    _build.check(lib, err, "rglru_fwd launch")
    launches += 1
    return o, h_out


def rglru_bwd(x: torch.Tensor, log_a: torch.Tensor, h0: Optional[torch.Tensor],
              do: torch.Tensor, dh: Optional[torch.Tensor] = None, *,
              kernel: Optional[str] = None, phases: int = FORWARD | REVERSE
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The VJP of ``rglru`` at (x, log_a, h0) for the output cotangent ``do``
    (x's dtype and shape) and the final state's ``dh`` (B, W) f32 or None
    (zeros).  ``h0`` is the initial state as it was before the forward
    updated it (f32 or None for zeros).  Returns (dx in x's dtype, dlog_a in
    log_a's dtype, dh0 (B, W) f32).  ``kernel`` (BWD_TILED or BWD_CHANNEL)
    overrides ``BWD_DESIGNS`` on the card, to compare the two.  ``phases``
    other than both passes runs part of the tiled kernel, to time it by
    phase; its outputs are then not the VJP."""
    global bwd_launches
    _check(x, log_a, h0)
    kernel = kernel or BWD_DESIGNS[x.dtype]
    if kernel not in BWD_ENTRY:
        raise ValueError(f"unknown backward kernel {kernel!r}; one of {list(BWD_ENTRY)}")
    if phases != FORWARD | REVERSE and (kernel != BWD_TILED or not 1 <= phases <= 7):
        raise ValueError(f"phases {phases} needs the tiled kernel and a value in 1..7")
    if tuple(do.shape) != tuple(x.shape) or do.dtype != x.dtype or do.device != x.device:
        raise ValueError(f"do must be {x.dtype} {tuple(x.shape)} on {x.device}; got "
                         f"{do.dtype} {tuple(do.shape)} on {do.device}")
    B, S, W = x.shape
    if dh is not None and (tuple(dh.shape) != (B, W) or dh.dtype != torch.float32
                           or dh.device != x.device or not dh.is_contiguous()):
        raise ValueError(f"dh must be f32 contiguous {(B, W)} on {x.device}; got "
                         f"{dh.dtype} {tuple(dh.shape)} on {dh.device}")
    if isinstance(x, FakeTensor):
        cost.record("rglru_bwd", cost.rglru_bwd(B, S, W, x.element_size(), log_a.element_size()))
        return torch.empty_like(x), torch.empty_like(log_a), x.new_empty((B, W), dtype=torch.float32)
    if x.device.type == "cpu":
        return ref.rglru_bwd_ref(x, log_a, h0, do, dh)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x, log_a, do = (t.contiguous() for t in (x, log_a, do))
    dx, dla = torch.empty_like(x), torch.empty_like(log_a)
    dh0 = torch.empty((B, W), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, dla, (dh0.zero_() if dh is None else dh0.copy_(dh))
    # scratch: h before every chunk of steps of each channel, f32
    chunk = TILED_CHUNK if kernel == BWD_TILED else CHUNK
    ck = torch.empty((B, -(-S // chunk), W), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = [x.data_ptr(), log_a.data_ptr(), None if h0 is None else h0.data_ptr(),
                do.data_ptr(), None if dh is None else dh.data_ptr(), dx.data_ptr(),
                dla.data_ptr(), dh0.data_ptr(), ck.data_ptr(), DTYPES[x.dtype],
                DTYPES[log_a.dtype], B, S, W]
        if kernel == BWD_TILED:
            args.append(phases)
        err = getattr(lib, BWD_ENTRY[kernel])(*args, stream)
    _build.check(lib, err, f"{BWD_ENTRY[kernel]} launch")
    bwd_launches += 1
    bwd_kernel_launches[kernel] += 1
    return dx, dla, dh0


@dataclasses.dataclass(frozen=True)
class BwdGrid:
    """csrc/rglru_bwd_tiled.cu's launch for one (B, S, W): a grid of
    ``blocks`` = (strips of STRIP channels, B) blocks of ``warps_per_block``
    warps, each walking ``n_tiles`` tiles of ``tile`` steps."""
    B: int
    S: int
    W: int
    blocks: tuple[int, int]
    warps_per_block: int
    tile: int
    n_tiles: int

    @property
    def warps(self) -> int:
        return self.blocks[0] * self.blocks[1] * self.warps_per_block

    def owners(self) -> np.ndarray:
        """How many threads of the groups write each (b, t, w) of dx and
        dlog_a, by the kernel's own loops: block (strip, b), group g, tiles
        j = g, g + GROUPS, ... from the last, warp q its chunk of each,
        lane its channel; steps past S and channels past W are masked."""
        count = np.zeros((self.B, self.S, self.W), dtype=np.int32)
        for b in range(self.blocks[1]):
            for strip in range(self.blocks[0]):
                w0 = strip * STRIP
                for g in range(GROUPS):
                    for j in range(g, self.n_tiles, GROUPS):
                        k = self.n_tiles - 1 - j
                        for q in range(GROUP_WARPS):
                            t0 = k * self.tile + q * TILED_CHUNK
                            count[b, t0:min(t0 + TILED_CHUNK, self.S),
                                  w0:min(w0 + STRIP, self.W)] += 1
        return count


def bwd_grid(B: int, S: int, W: int) -> BwdGrid:
    """The tiled backward kernel's blocks, strips and tiles at (B, S, W)."""
    return BwdGrid(B, S, W, (-(-W // STRIP), B), 1 + GROUPS * GROUP_WARPS, TILE, -(-S // TILE))


def rglru_bwd_tiled(x: torch.Tensor, log_a: torch.Tensor, h0: Optional[torch.Tensor],
                    do: torch.Tensor, dh: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``rglru_bwd``'s tiled kernel in plain PyTorch, in its order: inputs
    padded to whole tiles with zeros (its masked loads); the groups' prep
    (a = exp(l), b = s x); the chain of h with a checkpoint before every
    TILED_CHUNK steps; per chunk, a, e, s and h_{t-1} rebuilt from its checkpoint;
    the carry chain from the last step; the epilogue (the clamp's share
    from e, dx, dlog_a).  Every operation is one f32 rounding, as in the
    kernel and in ``ref.rglru_bwd_ref``, whose bits it gives."""
    B, S, W = x.shape
    grid = bwd_grid(B, S, W)
    C = TILED_CHUNK
    n_ck, n_chunks = -(-S // C), grid.n_tiles * GROUP_WARPS
    pad = grid.n_tiles * grid.tile - S
    xf, laf, dof = (F.pad(t.float(), (0, 0, 0, pad)) for t in (x, log_a, do))
    zeros = torch.zeros((B, W), dtype=torch.float32, device=x.device)
    # the forward pass: the groups' prep, then the chain warp's walk
    a = torch.exp(laf)
    bt = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * laf), min=1e-12)) * xf
    h = zeros if h0 is None else h0.float()
    ck = torch.zeros((B, n_chunks, W), dtype=torch.float32, device=x.device)
    for t in range(S):
        if t % C == 0:
            ck[:, t // C] = h
        h = a[:, t] * h + bt[:, t]
    # (i) each chunk from its checkpoint (chunks past S start at 0)
    e = torch.exp(2.0 * laf)
    s = torch.sqrt(torch.clamp(1.0 - e, min=1e-12))
    ac, sc, xc = (t.view(B, n_chunks, C, W) for t in (a, s, xf))
    hp = torch.empty((B, n_chunks, C, W), dtype=torch.float32, device=x.device)
    hh = torch.where(torch.arange(n_chunks, device=x.device).view(1, -1, 1) < n_ck, ck, 0.0)
    for i in range(C):
        hp[:, :, i] = hh
        hh = ac[:, :, i] * hh + sc[:, :, i] * xc[:, :, i]
    hp = hp.view(B, -1, W)
    # (ii) the chain warp's carry, from the last step
    carry = zeros if dh is None else dh.float()
    g = torch.zeros_like(dof)
    for t in range(S - 1, -1, -1):
        g[:, t] = carry + dof[:, t]
        carry = g[:, t] * a[:, t]
    # (iii) the epilogue
    u = 1.0 - e
    m = torch.clamp(u, min=1e-12)
    share = torch.where(u == m, torch.where(m == 1e-12, 0.5, 1.0), 0.0)
    dx = g * s
    dl = (g * hp) * a + 2.0 * (-((g * xf) * (0.5 / s) * share) * e)
    return dx[:, :S].to(x.dtype), dl[:, :S].to(log_a.dtype), carry


class RGLRU(torch.autograd.Function):
    """Differentiable RG-LRU: ``rglru`` forward (a given state is updated in
    place, as serving does, and marked dirty) and ``rglru_bwd`` backward.
    The forward keeps a copy of the initial state, which the backward reads
    after the in-place update has overwritten it."""

    @staticmethod
    def forward(ctx, x, log_a, h0):
        h_init = None if h0 is None else h0.clone()
        out, h = rglru(x, log_a, h0)
        if h0 is not None:
            ctx.mark_dirty(h0)
        ctx.save_for_backward(x, log_a, h_init)
        return out, h

    @staticmethod
    def backward(ctx, do, dh):
        x, log_a, h_init = ctx.saved_tensors
        dx, dla, dh0 = rglru_bwd(x, log_a, h_init, do, dh.contiguous())
        return dx, dla, (None if h_init is None else dh0)
